"""The (data, rays) mesh of ``papr_tpu_torch.parallel`` on four gloo ranks on
the CPU (data = 2, rays = 2, ``tests/_mesh_rank.py``), against the JAX
package on ``make_mesh(2, 2)`` of the conftest's virtual CPU devices and
against the port on one rank, on the same converted weights and inputs:

* the ray-sharded attention of the training step (``_attend_spmd``, the
  config of ``tests/test_multichip.py``'s kernel-path parity: streamrec +
  cull, fp32, with the narrow embedders of ``test_torch_train_step.py``):
  the selection equal; fused <= 1e-5 and attention <= 1e-6 abs
  against one rank, as the JAX package holds its shard_map against its
  local trace; fused and attention atol 2e-5 against JAX; the gradient of
  every parameter rtol 3e-4 with atol 1e-6 x its max against both (the
  port-against-JAX bounds of ``tests/test_torch_train_step.py``);
* the LPIPS training step (MSE + 1e-2 LPIPS on JAX-drawn random VGG
  weights): the loss rtol 1e-5 against the JAX mesh step's and one rank's,
  the gradients as above and the whole batch's pred atol 1e-6 against one
  rank's, and the parameters after a full step bit-equal on every rank;
* a step with embedder dropout: the masks are one rank's, so the loss rtol
  1e-5 and the gradients as above against one rank;
* the tile-sharded renders: 19 x 22 at 8 x 10 tiles (9 tiles over 4 ranks,
  wrapped) and a 20 x 28 serving frame (one tile wrapped onto every rank),
  bit-equal to one rank's and within the render tests' bounds of JAX's mesh
  render (rgb, bkg_attn, depth rtol / atol 1e-4; the frame within 1/255).

Each rank runs with one thread and its own time limit; a rank that fails or
runs out of time fails every test here.
"""

import os
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch

from papr_tpu.config import load_config as jax_load
from papr_tpu.model import papr as jpapr
from papr_tpu.model.lpips_jax import random_lpips_params
from papr_tpu.nn.mlp import policy_from_config as jax_policy
from papr_tpu.parallel.mesh import make_mesh, make_plan
from papr_tpu.train import step as jstep
from papr_tpu.train.losses import get_loss as jget_loss
from papr_tpu_torch.config import load_config
from papr_tpu_torch.convert import from_jax_lpips_params, from_jax_params
from papr_tpu_torch.model import papr as tpapr
from papr_tpu_torch.nn.mlp import policy_from_config
from papr_tpu_torch.train import step as tstep
from papr_tpu_torch.train.losses import get_loss
from papr_tpu_torch.train.optim import build_group_specs, tree_leaves, tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
MESH = (2, 2)
RANK_TIMEOUT = 300

# The embedders of test_torch_train_step.py: at the default 256-wide stacks
# a few of the value walk's relu inputs lie within rounding of 0 and flip
# between the two packages (one rank's gradients then differ from JAX's by
# up to 1e-2 of their scale), where the mesh itself moves no ray's
# arithmetic.
NARROW = {"d_model": 32, "embed": {
    "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
    "key": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
    "query": {"d_ff": 24, "d_ff_out": 24, "n_ff_layer": 2},
    "value": {"d_ff": 16, "d_ff_out": 8, "n_ff_layer": 3}}}
ATTN = {"use_amp": False, "max_num_pts": 256,
        "geoms": {"points": {"init_num": 200, "select_k": 8},
                  "point_feats": {"dim": 8}},
        "models": {"attn": NARROW},
        "dataset": {"batch_size": 2, "patches": {"height": 16, "width": 16}},
        "tpu": {"fused_attn": "streamrec", "topk_impl": "cull",
                "mesh": {"data": 2, "rays": 2}}}
STEP = {"use_amp": False, "max_num_pts": 128, "seed": 0,
        "geoms": {"points": {"init_num": 100, "select_k": 4}},
        "dataset": {"batch_size": 2, "patches": {"height": 16, "width": 16}},
        "training": {"losses": {"mse": 1.0, "lpips": 0.01,
                                "lpips_alex": 0.0}},
        "tpu": {"mesh": {"data": 2, "rays": 2}}}
DROP = {**STEP, "training": {"losses": {"mse": 1.0, "lpips": 0.0,
                                        "lpips_alex": 0.0}},
        "models": {"attn": {"embed": {n: {"dropout_ff": 0.2} for n in
                                      ("key", "query", "value")}}}}


def _rays(seed, n, h, w):
    rng = np.random.default_rng(seed)
    rayo = rng.normal(size=(n, 3)).astype(np.float32) * 3.0
    rayd = rng.normal(size=(n, h, w, 3)).astype(np.float32)
    rayd /= np.linalg.norm(rayd, axis=-1, keepdims=True)
    return rayo, rayd


def _model(over, seed):
    """A JAX model with seeded influence scores (non-trivial attention) and
    the port's copy of it."""
    jcfg = jax_load(overrides=over)
    params, state = jpapr.create_model(jcfg, jax.random.PRNGKey(0))
    params = dict(params)
    rng = np.random.default_rng(seed)
    params["points_influ_scores"] = jnp.asarray(
        rng.normal(size=params["points_influ_scores"].shape).astype(
            np.float32))
    tp, ts = from_jax_params(jax.tree.map(np.asarray, params),
                             jax.tree.map(np.asarray, state),
                             load_config(overrides=over), device="cpu")
    return jcfg, params, state, tp, ts


def _wait(procs, logs):
    """Wait for every rank; on a failure or the time limit kill the rest."""
    deadline = time.monotonic() + RANK_TIMEOUT
    while True:
        rcs = [p.poll() for p in procs]
        bad = [r for r, rc in enumerate(rcs) if rc not in (None, 0)]
        late = time.monotonic() > deadline
        if bad or late or all(rc == 0 for rc in rcs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if bad or late:
        r = bad[0] if bad else 0
        with open(logs[r]) as f:
            tail = f.read()[-4000:]
        pytest.fail(f"rank {r} {'failed' if bad else 'timed out'}:\n{tail}")


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    jcfg, params, state, tp, ts = _model(ATTN, 1)
    scfg, sparams, sstate, sp, ss = _model(STEP, 2)
    lp = random_lpips_params(jax.random.PRNGKey(1))
    lp_t = from_jax_lpips_params(jax.tree.map(np.asarray, lp), device="cpu")
    rayo, rayd = _rays(0, 2, 16, 16)
    target = np.random.default_rng(5).random((2, 16, 16, 3), np.float32)
    c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.3, -0.2, 3.0]
    r_rayo, r_rayd = _rays(3, 1, 19, 22)
    t = torch.as_tensor
    batch = {"rayo": t(rayo), "rayd": t(rayd), "target": t(target),
             "c2w": t(c2w)}
    inputs = {
        "attention": {"case": "attention", "over": ATTN, "mesh": MESH,
                      "params": tp, "state": ts, "rayo": t(rayo),
                      "rayd": t(rayd)},
        "lpips": {"case": "step", "over": STEP, "mesh": MESH, "params": sp,
                  "state": ss, "lpips": lp_t, **batch},
        "dropout": {"case": "step", "over": DROP, "mesh": MESH, "params": sp,
                    "state": ss, **batch},
        "render": {"case": "render", "over": ATTN, "params": tp, "state": ts,
                   "rayo": r_rayo, "rayd": r_rayd, "tiles": (8, 10),
                   "c2w": pose, "frame": (25.0, 25.0, 20, 28)},
    }
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    env = dict(os.environ, PAPR_PLATFORM="cpu", OMP_NUM_THREADS="1")
    logs = [os.path.join(tmp, f"rank{r}.log") for r in range(WORLD)]
    procs = []
    for r in range(WORLD):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests", "_mesh_rank.py"),
                 tmp, str(r), str(WORLD)], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))

    # Meanwhile: JAX on its (2, 2) mesh, and the port on one rank.
    ref = {"jax": {}, "port": {}}
    policy = jax_policy(jcfg)
    mesh = make_mesh(*MESH)

    def jloss(p, s):
        f, a, _, _ = jpapr._attend_spmd(p, s, jcfg, jnp.asarray(rayo),
                                        jnp.asarray(rayd), policy, False, mesh)
        return jnp.sum(f ** 2) + jnp.sum(a[..., -1] ** 2)

    with warnings.catch_warnings(), jax.set_mesh(mesh):
        warnings.simplefilter("ignore")
        f, a, _, idx = jax.jit(lambda p, s: jpapr._attend_spmd(
            p, s, jcfg, jnp.asarray(rayo), jnp.asarray(rayd), policy, False,
            mesh))(params, state)
        g = jax.jit(jax.grad(jloss))(params, state)
    ref["jax"]["attention"] = (np.asarray(f), np.asarray(a), np.asarray(idx),
                               [np.asarray(x) for x in jax.tree.leaves(g)])

    live = tree_map(lambda x: x.clone().requires_grad_(True), tp)
    tf, ta, tidx = tpapr._attend(live, ts, load_config(overrides=ATTN),
                                 t(rayo), t(rayd), policy_from_config(
                                     load_config(overrides=ATTN)),
                                 exact_select=False)
    leaves = tree_leaves(live)
    tg = torch.autograd.grad((tf ** 2).sum() + (ta[..., -1] ** 2).sum(),
                             leaves, allow_unused=True)
    ref["port"]["attention"] = (
        tf.detach(), ta.detach(), tidx,
        [torch.zeros_like(x) if y is None else y for y, x in zip(tg, leaves)])

    jloss_fn = jget_loss(scfg.training.losses, lpips_params=lp,
                         policy=jax_policy(scfg))
    jstep_m, _ = jstep.make_train_step(scfg, loss_fn=jloss_fn,
                                       sharding=make_plan(mesh), donate=False)
    _, _, loss_m, _ = jstep_m(sparams, jstep.make_opt_state(scfg, sparams),
                              sstate, rayo, rayd, target, c2w, 0)
    ref["jax"]["lpips"] = float(loss_m)
    for name, over, lpt in (("lpips", STEP, lp_t), ("dropout", DROP, None)):
        cfg = load_config(overrides=over)
        loss, pred, grads = tstep.loss_and_grads(
            sp, ss, cfg, t(rayo), t(rayd), t(target), c2w,
            get_loss(cfg.training.losses, lpips_params=lpt,
                     policy=policy_from_config(cfg)),
            build_group_specs(cfg), policy_from_config(cfg),
            dropout_rng=tstep.dropout_generator(cfg, 0, "cpu"))
        ref["port"][name] = (loss, pred, grads)
    ref["port"]["params0"] = sp

    rcfg_j = jax_load(overrides=ATTN)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref["jax"]["render"] = jstep.render_full_image(
            params, state, rcfg_j, r_rayo, r_rayd, 8, 10, with_depth=True)
        ref["jax"]["frame"] = jstep.render_frame(params, state, rcfg_j, pose,
                                                 25.0, 25.0, 20, 28)
    # One process, fewer ranks than the mesh names: one rank renders, with
    # the ranks' one thread (the UNet's CPU convolutions sum in an order
    # that depends on the thread count).
    rcfg = load_config(overrides=ATTN)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref["port"]["render"] = tstep.render_full_image(
            tp, ts, rcfg, r_rayo, r_rayd, 8, 10, with_depth=True)
        ref["port"]["frame"] = tstep.render_frame(tp, ts, rcfg, pose, 25.0,
                                                  25.0, 20, 28)
    finally:
        torch.set_num_threads(threads)

    _wait(procs, logs)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return ref, ranks


def _grads_close(got, want, label):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (label, i)
        np.testing.assert_allclose(
            a, b, rtol=3e-4, atol=1e-6 * max(float(np.abs(b).max()), 1e-30),
            err_msg=f"{label} leaf {i}")


def _global(ranks, case, key):
    """The whole batch from the ranks' blocks: each data group's gathered
    patch (its rays index 0 rank), or, for a block-shaped output, every
    rank's block in mesh order."""
    data, rays = MESH
    parts = [r[case][key] for r in ranks]
    if key == "idx":
        rows = [torch.cat(parts[d * rays:(d + 1) * rays], dim=1)
                for d in range(data)]
        return torch.cat(rows, dim=0)
    return torch.cat([parts[d * rays] for d in range(data)], dim=0)


def test_sharded_attention_matches_jax_mesh_and_one_rank(spmd):
    ref, ranks = spmd
    jf, ja, jidx, jg = ref["jax"]["attention"]
    tf, ta, tidx, tg = ref["port"]["attention"]
    f = _global(ranks, "attention", "fused")
    a = _global(ranks, "attention", "attn")
    idx = _global(ranks, "attention", "idx")
    np.testing.assert_array_equal(idx.numpy(), tidx.numpy())
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert float((f - tf).abs().max()) <= 1e-5
    assert float((a - ta).abs().max()) <= 1e-6
    np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=2e-5)
    np.testing.assert_allclose(a.numpy(), ja, rtol=0, atol=2e-5)
    assert np.ptp(a.numpy()[..., -1]) > 0.05       # not a trivial attention
    for r in ranks:
        _grads_close(r["attention"]["grads"], tg, "one rank")
        _grads_close(r["attention"]["grads"], jg, "JAX mesh")


def test_sharded_lpips_step_matches_jax_mesh_and_one_rank(spmd):
    ref, ranks = spmd
    loss, pred, grads = ref["port"]["lpips"]
    for r in ranks:
        got = r["lpips"]
        np.testing.assert_allclose(float(got["loss"]), float(loss), rtol=1e-5)
        np.testing.assert_allclose(float(got["loss"]), ref["jax"]["lpips"],
                                   rtol=1e-5)
        np.testing.assert_allclose(float(got["loss_step"]), float(loss),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["pred"].numpy(), pred.numpy(), rtol=0,
                                   atol=1e-6)
        for key in grads:
            _grads_close(tree_leaves(got["grads"][key]),
                         tree_leaves(grads[key]), key)


def test_parameters_equal_on_every_rank_after_the_step(spmd):
    ref, ranks = spmd
    first = tree_leaves(ranks[0]["lpips"]["params"])
    for r in ranks[1:]:
        for a, b in zip(tree_leaves(r["lpips"]["params"]), first):
            assert torch.equal(a, b)
    start = tree_leaves(ref["port"]["params0"])
    assert any(not torch.equal(a, b) for a, b in zip(first, start))


def test_sharded_dropout_step_draws_one_ranks_masks(spmd):
    ref, ranks = spmd
    loss, _, grads = ref["port"]["dropout"]
    no_drop = ref["port"]["lpips"][0]
    assert abs(float(loss) - float(no_drop)) > 1e-6   # dropout is on
    for r in ranks:
        np.testing.assert_allclose(float(r["dropout"]["loss"]), float(loss),
                                   rtol=1e-5)
        for key in grads:
            _grads_close(tree_leaves(r["dropout"]["grads"][key]),
                         tree_leaves(grads[key]), key)


def test_sharded_render_is_one_ranks_and_matches_jax_mesh(spmd):
    ref, ranks = spmd
    one, jax_m = ref["port"]["render"], ref["jax"]["render"]
    for r in ranks:
        got = r["render"]
        for k in ("fused", "attn", "selected", "rgb", "foreground",
                  "bkg_attn", "depth"):
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
        np.testing.assert_array_equal(got["frame"], ref["port"]["frame"])
    got = ranks[0]["render"]
    assert got["rgb"].shape == (1, 19, 22, 3)
    for k in ("rgb", "bkg_attn", "depth"):
        np.testing.assert_allclose(got[k], jax_m[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    frame = ranks[0]["render"]["frame"]
    assert frame.shape == (20, 28, 3) and frame.dtype == np.uint8
    jframe = ref["jax"]["frame"].astype(int)
    assert np.abs(frame.astype(int) - jframe).max() <= 1
