"""The port's exposure-control entry points as subprocesses on a tiny
procedural scene (``PAPR_PLATFORM=cpu``), in the pattern of
``tests/test_cli_end2end.py``'s exposure tests: ``cli.exposure`` from a
pretrained ``checkpoint.npz`` (no mapping MLP in it), its resume, then
``cli.test --exp`` / ``--random`` / ``--intrp`` on the finetuned
checkpoint."""

import os

import numpy as np
import pytest
import yaml

from papr_tpu_torch.dataset.synth import make_demo_scene

from test_torch_cli import _run, _write_cfg

EXPOSURE = {"use": True, "shading_code_dim": 8,
            "shading_code_num_samples": 3, "shading_code_resample_iter": 2,
            "shading_code_resample_size": 16,
            "mapping_mlp": {"num_layers": 2, "dim": 16, "out_dim": 32}}


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """A pretrained checkpoint.npz of the config without exposure control
    (seeded, no training), then 3 finetune steps from it: resamples at steps
    0 and 2, an eval and a checkpoint at step 3."""
    from papr_tpu_torch.config import load_config
    from papr_tpu_torch.model.papr import create_model
    from papr_tpu_torch.train.checkpoint import save_checkpoint
    from papr_tpu_torch.train.optim import build_group_specs, init_opt_state

    root = tmp_path_factory.mktemp("exp_cli")
    scene = make_demo_scene(str(root / "scene"), n_train=2, n_test=1, H=24,
                            W=24, exposure_jitter=0.3)
    base = _write_cfg(root, scene)
    pre_dir = str(root / "pretrained")
    cfg = load_config(base)
    params, state = create_model(cfg, seed=int(cfg.seed), device="cpu")
    save_checkpoint(pre_dir, 0, params,
                    init_opt_state(params, build_group_specs(cfg)), state)
    opt = _write_cfg(
        root, scene, index="smoke_exp", load_path=pre_dir,
        exposure_control=EXPOSURE,
        models={"attn": yaml.safe_load(open(base))["models"]["attn"],
                "renderer": {"generator": {"small_unet": {
                    "affine_layer": 0}}}},
        training={"steps": 3, "prune_steps": 0, "add_steps": 0,
                  "losses": {"mse": 1.0, "lpips": 0.0, "lpips_alex": 0.0}},
        eval={"dataset": {"name": "testset", "path": scene}, "step": 3,
              "img_idx": 0, "max_height": 16, "max_width": 16,
              "save_fig": False})
    out = _run("papr_tpu_torch.cli.exposure", ["--opt", opt]).stdout
    return root, opt, out


def test_exposure_finetune_cli(finetuned):
    root, _, out = finetuned
    assert "Loaded pretrained model from" in out
    assert out.count("Resampling shading codes") == 2
    assert "Resampled 2 codes" in out
    assert "Eval step: 3" in out and "Training finished!" in out
    log_dir = root / "experiments" / "smoke_exp"
    for name in ("checkpoint.npz", "histories.json", "train.log",
                 "exposure.py", "code.zip"):
        assert (log_dir / name).exists(), name
    with np.load(log_dir / "checkpoint.npz") as ck:
        train = ck["extras//train_shading_codes"]
        assert train.shape == (2, 8)
        assert ck["extras//eval_shading_codes"].shape == (1, 8)
        assert "params//mapping_mlp//layers//#0//w" in ck.files
    assert np.isfinite(train).all()


def test_exposure_resume_restores_codes(finetuned):
    root, opt, _ = finetuned
    log_dir = root / "experiments" / "smoke_exp"
    with np.load(log_dir / "checkpoint.npz") as ck:
        before = {k: ck[k] for k in ck.files if k.startswith("extras//")}
    with open(opt) as f:
        cfg = yaml.safe_load(f)
    cfg["training"]["steps"] = 4          # one more step, no resample
    with open(opt, "w") as f:
        yaml.safe_dump(cfg, f)
    out = _run("papr_tpu_torch.cli.exposure",
               ["--opt", opt, "--resume", "1"]).stdout
    assert "!!!!! Resume from step 3" in out
    assert "Resampling shading codes" not in out
    assert "!!!!! train_shading_codes: (2, 8)" in out
    assert "Training finished!" in out
    with np.load(log_dir / "checkpoint.npz") as ck:
        assert int(ck["__step__"]) == 4
        for k, v in before.items():
            np.testing.assert_array_equal(ck[k], v)


@pytest.mark.parametrize("flags,dir_name,frames", [
    ([], "exposure_control_test", 1),
    (["--random", "--view", "0", "--num_samples", "2", "--scale", "2.0"],
     "exposure_control_random_scale2.0", 2),
    (["--intrp", "--view", "0", "--num_samples", "2", "--num_intrp", "2"],
     "exposure_control_intrp_scale1.0", 2)],
    ids=["exp", "random", "intrp"])
def test_exposure_test_modes_cli(finetuned, flags, dir_name, frames):
    root, opt, _ = finetuned
    out = _run("papr_tpu_torch.cli.test", ["--opt", opt, "--exp"] + flags).stdout
    assert "Using eval_shading_codes: (1, 8)" in out
    assert out.count("Test frame:") == frames
    assert "Avg test loss" in out
    images = root / "experiments" / "smoke_exp" / "test" / dir_name
    assert len(list(images.glob("*-predrgb.png"))) == frames, \
        os.listdir(images.parent)
