"""The port's command-line entry points as subprocesses on a tiny procedural
scene (``PAPR_PLATFORM=cpu``): train, resume, test; then the refusal without
a card, and the exposure-control test modes from a model.pth."""

import os
import subprocess
import sys

import pytest
import yaml

from papr_tpu_torch.dataset.synth import make_demo_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_cfg(root, scene, **extra):
    cfg = {
        "index": "smoke", "save_dir": str(root / "experiments"),
        "seed": 1, "use_amp": False, "max_num_pts": 120,
        "dataset": {"coord_scale": 1.0, "type": "synthetic", "path": scene,
                    "patches": {"height": 16, "width": 16}},
        "geoms": {"points": {"select_k": 4, "init_num": 100,
                             "init_scale": [0.8, 0.8, 0.8]},
                  "point_feats": {"dim": 8}},
        "models": {"attn": {"d_model": 16, "embed": {
            "k_L": [2, 2, 2], "q_L": [2], "v_L": [2, 2],
            "key": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "query": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2},
            "value": {"d_ff": 16, "d_ff_out": 16, "n_ff_layer": 2}}}},
        "training": {
            "steps": 8, "prune_steps": 4, "prune_start": 4, "prune_stop": 8,
            "add_steps": 6, "add_start": 6, "add_stop": 8, "add_num": 5,
            "losses": {"mse": 1.0, "lpips": 0.0, "lpips_alex": 0.0}},
        "eval": {"dataset": {"name": "testset", "path": scene}, "step": 8,
                 "img_idx": 0, "max_height": 16, "max_width": 16,
                 "save_fig": True},
        "test": {"max_height": 16, "max_width": 16, "save_fig": True,
                 "datasets": [{"name": "testset", "path": scene}]},
        "tpu": {"ray_chunk": 512, "topk_impl": "pallas", "fused_attn": True},
    }
    cfg.update(extra)
    path = root / "smoke.yml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _run(module, args, platform="cpu", ok=True):
    env = dict(os.environ)
    env.pop("PAPR_PLATFORM", None)
    if platform:
        env["PAPR_PLATFORM"] = platform
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    if ok:
        assert r.returncode == 0, (f"{module} {args}\nSTDOUT:{r.stdout[-3000:]}"
                                   f"\nSTDERR:{r.stderr[-3000:]}")
    return r


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    scene = make_demo_scene(str(root / "scene"), n_train=4, n_test=2, H=32,
                            W=32)
    opt = _write_cfg(root, scene)
    out = _run("papr_tpu_torch.cli.train", ["--opt", opt]).stdout
    return root, opt, out


def test_train_cli(trained):
    root, _, out = trained
    assert "Training finished!" in out
    assert "Pruned" in out and "Added 5 points" in out
    assert "Eval step: 8" in out
    log_dir = root / "experiments" / "smoke"
    for name in ("checkpoint.npz", "histories.json", "train.log",
                 "train_error.log", "smoke.yml", "code.zip", "train.py"):
        assert (log_dir / name).exists(), name
    assert "Training finished!" in (log_dir / "train.log").read_text()
    assert list((log_dir / "train_main_plots").glob("*.png"))
    assert (log_dir / "test" / "point_clouds" / "init_pcd.png").exists()


def test_resume_cli(trained):
    _, opt, _ = trained
    out = _run("papr_tpu_torch.cli.train", ["--opt", opt, "--resume", "1"]).stdout
    assert "!!!!! Resume from step 8" in out
    assert "Training finished!" in out


def test_test_cli(trained):
    root, opt, _ = trained
    out = _run("papr_tpu_torch.cli.test", ["--opt", opt]).stdout
    assert "!!!!! Loaded model from" in out and "at step 8" in out
    assert out.count("Test frame:") == 2
    assert "Avg test loss:" in out and "test PSNR:" in out
    assert "test LPIPS Alex: nan" in out and "LPIPS-VGG metric will be nan" in out
    images = root / "experiments" / "smoke" / "test" / "images"
    for kind in ("predrgb", "depth", "fgrgb", "bkgmask"):
        assert len(list(images.glob(f"*-{kind}.png"))) == 2, kind
    assert (root / "experiments" / "smoke" / "test.log").exists()


def test_cli_refusals(trained):
    """No card and no PAPR_PLATFORM: an error, not a quiet CPU run (where a
    card exists this run trains on it). The exposure modes run, on the
    trained model exported as a reference model.pth (its mapping MLP fresh
    at the import)."""
    import torch

    from papr_tpu_torch.config import load_config
    from papr_tpu_torch.model.papr import create_model
    from papr_tpu_torch.train import checkpoint as ck
    root, opt, _ = trained
    r = _run("papr_tpu_torch.cli.train", ["--opt", opt, "--resume", "1"],
             platform=None, ok=False)
    if torch.cuda.is_available():
        assert r.returncode == 0
    else:
        assert r.returncode != 0
        assert "PAPR_PLATFORM=cpu" in r.stderr
        assert "Training finished!" not in r.stdout
    cfg = load_config(opt)
    params, state = create_model(cfg, seed=0, device="cpu")
    _, tree = ck.load_checkpoint(str(root / "experiments" / "smoke"))
    pth = str(root / "smoke_model.pth")
    ck.export_torch(pth, ck.restore_into(params, tree["params"]),
                    ck.restore_into(state, tree["state"]), cfg, step=8)
    with open(opt) as f:
        exp = yaml.safe_load(f)
    exp.update(index="smoke_exp_test", exposure_control={
        "use": True, "shading_code_dim": 8,
        "mapping_mlp": {"num_layers": 2, "dim": 16, "out_dim": 32}})
    exp["models"]["renderer"] = {"generator": {"small_unet": {
        "affine_layer": 0}}}
    exp["test"]["load_path"] = pth
    exp_opt = str(root / "smoke_exp_test.yml")
    with open(exp_opt, "w") as f:
        yaml.safe_dump(exp, f)
    for flags, frames in ((["--exp"], 2), (["--exp", "--intrp"], 10)):
        out = _run("papr_tpu_torch.cli.test", ["--opt", exp_opt] + flags).stdout
        assert f"Loaded model from {pth} at step 8" in out
        assert out.count("Test frame:") == frames and "Avg test loss" in out
