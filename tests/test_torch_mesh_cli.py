"""The port's command-line entry points on a (data, rays) mesh of two gloo
ranks on the CPU, launched as PyTorch launches them (``torchrun --standalone
--nproc_per_node=2``), on the tiny procedural scene of
``tests/test_multichip.py`` (24 x 24, 16 x 16 patches):

* ``cli.train`` on (data = 2, rays = 1) with a batch of 2 and prune / grow
  off ends within rel 1e-4 of one rank in train and eval loss (the bound of
  ``test_multichip.py``: the mesh is a layout, not a change of result);
* ``cli.train`` on (data = 1, rays = 2) with prune and grow events finishes;
  ``cli.test`` under two ranks on its checkpoint reports one rank's metrics;
* ``cli.exposure`` under two ranks picks one rank's codes;
* in one process a mesh config raises JAX's divisibility error.

Only rank 0 prints, and no other rank writes under the run's directory
(``tools/torch_rank_audit.py`` refuses it). Each launch has its own time limit.
"""

import os
import re
import subprocess
import sys

import pytest
import yaml

from papr_tpu_torch.dataset.synth import make_demo_scene
from test_torch_cli import _write_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIT = os.path.join(REPO, "tools", "torch_rank_audit.py")
EVAL = re.compile(r"Eval step: (\d+) train_loss: ([\d.eE+-]+) "
                  r"eval_loss: ([\d.eE+-]+) eval_psnr: ([\d.eE+-]+)")
TEST = re.compile(r"Avg test loss: ([\d.eE+-]+), test PSNR: ([\d.eE+-]+)")


def _env():
    return dict(os.environ, PAPR_PLATFORM="cpu", OMP_NUM_THREADS="1")


def _start(module, args, root, ranks=2):
    """``module`` under torchrun with ``ranks`` ranks (1: a plain process),
    started -> (command, process)."""
    if ranks == 1:
        cmd = [sys.executable, "-m", module] + args
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={ranks}", AUDIT,
               str(root / "experiments"), module] + args
    return cmd, subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)


def _finish(started, ok=True):
    """Wait for a started launch (killed at its time limit) -> (rc, stdout,
    stderr)."""
    cmd, p = started
    try:
        out, err = p.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        pytest.fail(f"{cmd} timed out\nSTDERR:{err[-3000:]}")
    if ok:
        assert p.returncode == 0, (f"{cmd}\nSTDOUT:{out[-3000:]}"
                                   f"\nSTDERR:{err[-3000:]}")
    return p.returncode, out, err


def _last_eval(out):
    m = EVAL.findall(out)
    assert m, out[-2000:]
    step, train_loss, eval_loss, _ = m[-1]
    return int(step), float(train_loss), float(eval_loss)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return make_demo_scene(str(tmp_path_factory.mktemp("scene") / "s"),
                           n_train=4, n_test=1, H=24, W=24)


@pytest.fixture(scope="module")
def prune_grow(scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("pg")
    opt = _write_cfg(root, scene, tpu={"ray_chunk": 512, "topk_impl": "cull",
                                       "fused_attn": "streamrec",
                                       "mesh": {"data": 1, "rays": 2}})
    return root, opt, _finish(_start("papr_tpu_torch.cli.train",
                                     ["--opt", opt], root))[1]


def test_two_ranks_train_as_one(scene, tmp_path_factory):
    common = {"dataset": {"coord_scale": 1.0, "type": "synthetic",
                          "path": scene, "batch_size": 2,
                          "patches": {"height": 16, "width": 16}},
              "training": {"steps": 8, "prune_steps": 0, "add_steps": 0,
                           "losses": {"mse": 1.0, "lpips": 0.0,
                                      "lpips_alex": 0.0}}}
    runs = {}
    for ranks, mesh in ((1, {"data": 1, "rays": 1}),
                        (2, {"data": 2, "rays": 1})):
        root = tmp_path_factory.mktemp(f"ranks{ranks}")
        opt = _write_cfg(root, scene, **common,
                         tpu={"ray_chunk": 512, "topk_impl": "cull",
                              "fused_attn": "streamrec", "mesh": mesh})
        runs[ranks] = _start("papr_tpu_torch.cli.train", ["--opt", opt],
                             root, ranks)
    out = {ranks: _finish(run)[1] for ranks, run in runs.items()}
    assert "Multi-chip: mesh=(data=2, rays=1) over 2 devices" in out[2]
    assert "Process group: gloo over 2 ranks" in out[2]
    assert out[2].count("Training finished!") == 1      # rank 0 prints
    s1, tl1, el1 = _last_eval(out[1])
    s2, tl2, el2 = _last_eval(out[2])
    assert s1 == s2 == 8
    assert tl2 == pytest.approx(tl1, rel=1e-4, abs=1e-6)
    assert el2 == pytest.approx(el1, rel=1e-4, abs=1e-6)


def test_two_ranks_prune_grow_and_finish(prune_grow):
    root, _, out = prune_grow
    assert "Multi-chip: mesh=(data=1, rays=2) over 2 devices" in out
    assert "Pruned" in out and "Added 5 points" in out
    assert out.count("Training finished!") == 1
    _, tl, el = _last_eval(out)
    assert tl == tl and el == el                          # finite, parsed
    log_dir = root / "experiments" / "smoke"
    for name in ("checkpoint.npz", "histories.json", "train.log"):
        assert (log_dir / name).exists(), name


def test_test_cli_under_two_ranks_reports_one_ranks_metrics(prune_grow,
                                                            tmp_path):
    root, opt, _ = prune_grow
    with open(opt) as f:
        cfg = yaml.safe_load(f)
    # One rank reads the same checkpoint and writes elsewhere.
    cfg["test"]["load_path"] = str(root / "experiments" / "smoke")
    opt1 = _write_cfg(tmp_path, cfg["dataset"]["path"],
                      **{k: cfg[k] for k in ("test", "tpu")})
    one = _start("papr_tpu_torch.cli.test", ["--opt", opt1], tmp_path, 1)
    two = _finish(_start("papr_tpu_torch.cli.test", ["--opt", opt], root))[1]
    one = _finish(one)[1]
    assert TEST.findall(two) == TEST.findall(one) != []
    assert two.count("Avg test loss") == 1                # rank 0 prints
    assert os.listdir(root / "experiments" / "smoke" / "test" / "images")


def test_exposure_cli_under_two_ranks_finetunes_as_one(tmp_path):
    """``cli.exposure`` (3 steps, resamples at 0 and 2, an eval) on (data =
    1, rays = 2): the step is not sharded, the resample and eval renders
    are; the codes and losses are one rank's."""
    import numpy as np
    from papr_tpu_torch.config import load_config
    from papr_tpu_torch.model.papr import create_model
    from papr_tpu_torch.train.checkpoint import save_checkpoint
    from papr_tpu_torch.train.optim import build_group_specs, init_opt_state
    from test_torch_exposure_cli import EXPOSURE

    scene = make_demo_scene(str(tmp_path / "scene"), n_train=2, n_test=1,
                            H=24, W=24, exposure_jitter=0.3)
    base = _write_cfg(tmp_path, scene)
    cfg = load_config(base)
    params, state = create_model(cfg, seed=int(cfg.seed), device="cpu")
    pre = str(tmp_path / "pretrained")
    save_checkpoint(pre, 0, params,
                    init_opt_state(params, build_group_specs(cfg)), state)
    runs = {}
    for ranks in (1, 2):
        root = tmp_path / f"ranks{ranks}"
        root.mkdir()
        opt = _write_cfg(
            root, scene, index="smoke_exp", load_path=pre,
            exposure_control=EXPOSURE,
            models={"attn": yaml.safe_load(open(base))["models"]["attn"],
                    "renderer": {"generator": {"small_unet": {
                        "affine_layer": 0}}}},
            training={"steps": 3, "prune_steps": 0, "add_steps": 0,
                      "losses": {"mse": 1.0, "lpips": 0.0,
                                 "lpips_alex": 0.0}},
            eval={"dataset": {"name": "testset", "path": scene}, "step": 3,
                  "img_idx": 0, "max_height": 8, "max_width": 8,
                  "save_fig": False},
            tpu={"ray_chunk": 512, "topk_impl": "cull",
                 "fused_attn": "streamrec", "mesh": {"data": 1, "rays": 2}})
        runs[ranks] = (root, _start("papr_tpu_torch.cli.exposure",
                                    ["--opt", opt], root, ranks))
    out, codes = {}, {}
    for ranks, (root, run) in runs.items():
        out[ranks] = _finish(run)[1]
        with np.load(root / "experiments" / "smoke_exp" /
                     "checkpoint.npz") as ck:
            codes[ranks] = ck["extras//train_shading_codes"]
    assert out[2].count("Resampled 2 codes") == 2
    assert _last_eval(out[2]) == _last_eval(out[1])
    np.testing.assert_array_equal(codes[2], codes[1])


def test_a_mesh_in_one_process_raises_the_divisibility_error(scene,
                                                             tmp_path):
    opt = _write_cfg(tmp_path, scene,  # batch_size defaults to 1: not % 2
                     tpu={"mesh": {"data": 2, "rays": 1}})
    rc, _, err = _finish(_start("papr_tpu_torch.cli.train", ["--opt", opt],
                                tmp_path, 1), ok=False)
    assert rc != 0
    assert "dataset.batch_size=1 must be divisible by tpu.mesh.data=2" in err
