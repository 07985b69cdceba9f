"""The run-to-run spread of one fp32 training step's gradients on the card.

    python tools/torch_grad_spread.py [--mode query_fold] [--reps 4] [--seed 0]
    python tools/torch_grad_spread.py [--mode query_fold] --seeds 40

The model and view of ``tests/test_torch_kernels_cuda.py``'s fp32 step
tests (``use_amp: false``, 2,000 points, k = 8, a 32x32 view, the loss
``out.square().mean()``; the influence scores drawn after
``torch.manual_seed(--seed)``). The step's gradients are taken ``reps``
times on the same parameters through the mode's kernels and through the
plain fp32 path (``fused_attn: false``), each with PyTorch's default
algorithms and with ``torch.use_deterministic_algorithms``, and once more
after the allocator's free blocks were filled with garbage (random values
of 1e3, then NaN). Per gradient group it prints the largest relative
Frobenius distance between two runs of one path, between the paths' first
runs, and between a path's run on filled memory and its first run. A group
whose runs of one path differ as much as the paths do is set by that
path's nondeterministic steps; one that moves on filled memory reads
memory that nothing wrote.

With ``--seeds N`` it draws the influence scores from a ``torch.Generator``
seeded 0 .. N-1 instead and, per seed, compares the two paths' gradients
once with the whole loss and once with the loss held to the rays whose
walks' relu inputs all stay ``--margin`` x rms from 0 (``model.papr
.ray_margin``: the smallest ``walk_relu_margin`` over the query walk and the
ray's K tokens of the key and value walks, on the inputs the kernels were
given). A gradient
whose tail goes with the rays left out comes from a hidden relu that the
two fp32 forwards round to opposite sides of 0.
"""

import argparse
import os
import sys

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from papr_tpu_torch.config import load_config  # noqa: E402
from papr_tpu_torch.model.papr import (create_model, forward,  # noqa: E402
                                       ray_margin)
from papr_tpu_torch.nn.mlp import policy_from_config  # noqa: E402
from papr_tpu_torch.ops.geometry import get_rays_np  # noqa: E402
from papr_tpu_torch.train.optim import tree_leaves, tree_map  # noqa: E402

MODES = {"auto": {}, "stream": {"fused_attn": "stream"},
         "true": {"fused_attn": True}, "score": {"fused_attn": "score"},
         "query_fold": {"fused_attn": "streamrec", "query_fold": True}}


def leaf_names(tree, path="") -> list:
    """Names of ``tree_leaves(tree)``'s leaves, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{path}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{path}[{i}]")]
    return [path]


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def sweep(opt, dev, cfg, cfg_p, params, state, rayo, rayd, names) -> None:
    """``--seeds``: per seed, the two paths against each other with the
    whole loss and with the loss held to the rays of margin >= --margin."""
    print(f"mode {opt.mode}: kernels against plain per seed, whole loss | "
          f"loss held to rays of relu margin >= {opt.margin}")

    def grads_of(c, keep):
        live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
                for k, v in params.items()}
        out = forward(live, state, c, rayo, rayd,
                      policy=policy_from_config(c))
        leaves = tree_leaves(live["attn"]) + [live["points"],
                                              live["points_influ_scores"],
                                              live["pc_feats"]]
        w = out.square() * keep.reshape(*out.shape[:-1], 1)
        return torch.autograd.grad(w.mean(), leaves)

    pi = names.index("points")
    for seed in range(opt.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params["points_influ_scores"].normal_(generator=gen)
        margin = ray_margin(params, state, cfg, rayo, rayd)
        held = (margin >= opt.margin).float()
        line = []
        for keep in (torch.ones_like(held), held):
            g, w = grads_of(cfg, keep), grads_of(cfg_p, keep)
            rels = [rel(a, b) for a, b in zip(g, w)]
            worst = max(range(len(rels)), key=rels.__getitem__)
            line.append(f"points {rels[pi]:.3e}, worst {names[worst]} "
                        f"{rels[worst]:.3e}")
        print(f"seed {seed}: {line[0]} | {line[1]} ({int(held.sum())} of "
              f"{held.numel()} rays held; least margin "
              f"{float(margin.min()):.2e})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="query_fold", choices=sorted(MODES))
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seeds", type=int, default=0)
    ap.add_argument("--margin", type=float, default=1e-5)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.manual_seed(opt.seed)

    def model(**tpu):
        return load_config(overrides={
            "use_amp": False, "max_num_pts": 2048,
            "geoms": {"points": {"init_num": 2000, "select_k": 8}},
            "tpu": {"topk_impl": "cull", **tpu}})

    cfg = model(**MODES[opt.mode])
    cfg_p = model(fused_attn=False)
    params, state = create_model(cfg, seed=0, device=dev)
    params["points_influ_scores"].normal_()
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 35.0
    rayo, rayd = get_rays_np(32, 32, 30.0, 30.0, c2w[None])
    rayo = torch.as_tensor(rayo, device=dev)
    rayd = torch.as_tensor(rayd, device=dev)
    names = leaf_names(params["attn"], "attn") + [
        "points", "points_influ_scores", "pc_feats"]
    if opt.seeds:
        sweep(opt, dev, cfg, cfg_p, params, state, rayo, rayd, names)
        return

    def grads_of(c):
        live = {k: tree_map(lambda t: t.detach().requires_grad_(True), v)
                for k, v in params.items()}
        out = forward(live, state, c, rayo, rayd,
                      policy=policy_from_config(c))
        leaves = tree_leaves(live["attn"]) + [live["points"],
                                              live["points_influ_scores"],
                                              live["pc_feats"]]
        g = torch.autograd.grad(out.square().mean(), leaves)
        torch.cuda.synchronize()
        return out.detach(), [t.detach().clone() for t in g]

    def fill_free_memory(value):
        """Fill the caching allocator's free blocks (and more): small
        blocks in the 2 MiB segments of its small pool, then one large
        block, each freed again with the garbage in it."""
        torch.cuda.synchronize()
        held = [torch.empty(2 ** 17, device=dev) for _ in range(512)]
        held.append(torch.empty(2 ** 30, device=dev))
        for t in held:
            if value is None:
                t.normal_(0.0, 1e3)
            else:
                t.fill_(value)
        torch.cuda.synchronize()
        del held

    runs = {}
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        for path, c in (("kernels", cfg), ("plain", cfg_p)):
            runs[(path, det)] = [grads_of(c) for _ in range(opt.reps)]
    torch.use_deterministic_algorithms(False)
    filled = {}
    for path, c in (("kernels", cfg), ("plain", cfg_p)):
        for value in (None, float("nan")):
            fill_free_memory(value)
            filled[(path, value is None)] = grads_of(c)

    def spread(rs, i):
        return max(rel(r[1][i], rs[0][1][i]) for r in rs[1:])

    kd, pd = runs[("kernels", False)], runs[("plain", False)]
    print(f"mode {opt.mode}, seed {opt.seed}, {opt.reps} runs a path; out: "
          f"kernels against plain {rel(kd[0][0], pd[0][0]):.3e}, kernels "
          f"run to run {max(rel(r[0], kd[0][0]) for r in kd[1:]):.3e}, "
          f"plain run to run {max(rel(r[0], pd[0][0]) for r in pd[1:]):.3e}")
    print("group: kernels vs plain | run to run: kernels, plain, kernels "
          "deterministic, plain deterministic | on filled memory (random, "
          "NaN): kernels, plain")
    k0, p0 = kd[0][1], pd[0][1]
    for i, n in enumerate(names):
        print(f"{n}: {rel(k0[i], p0[i]):.3e} | {spread(kd, i):.3e}, "
              f"{spread(pd, i):.3e}, "
              f"{spread(runs[('kernels', True)], i):.3e}, "
              f"{spread(runs[('plain', True)], i):.3e} | "
              + ", ".join(f"{rel(filled[(p, r)][1][i], g[i]):.3e}"
                          for p, g in (("kernels", k0), ("plain", p0))
                          for r in (True, False)), flush=True)


if __name__ == "__main__":
    main()
