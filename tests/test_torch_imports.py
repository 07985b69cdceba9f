"""The port imports torch, never jax."""

import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("jax")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ["papr_tpu_torch", "papr_tpu_torch.config", "papr_tpu_torch.convert",
           "papr_tpu_torch.kernels.build", "papr_tpu_torch.model.attention",
           "papr_tpu_torch.model.papr", "papr_tpu_torch.nn.activations",
           "papr_tpu_torch.nn.init", "papr_tpu_torch.nn.mlp",
           "papr_tpu_torch.nn.norm", "papr_tpu_torch.nn.posenc",
           "papr_tpu_torch.nn.unet", "papr_tpu_torch.ops.fused_mlp",
           "papr_tpu_torch.ops.geometry", "papr_tpu_torch.ops.stream_attn",
           "papr_tpu_torch.ops.stream_feat",
           "papr_tpu_torch.ops.tile_cull", "papr_tpu_torch.ops.topk",
           "papr_tpu_torch.train.step", "papr_tpu_torch.device",
           "papr_tpu_torch.ops.pallas_topk", "papr_tpu_torch.ops.fused_attn",
           "papr_tpu_torch.dataset", "papr_tpu_torch.dataset.dataset",
           "papr_tpu_torch.dataset.loaders", "papr_tpu_torch.dataset.synth",
           "papr_tpu_torch.utils", "papr_tpu_torch.utils.logging",
           "papr_tpu_torch.utils.metrics", "papr_tpu_torch.utils.plots",
           "papr_tpu_torch.utils.video", "papr_tpu_torch.train.checkpoint",
           "papr_tpu_torch.train.loop", "papr_tpu_torch.train.losses",
           "papr_tpu_torch.train.optim", "papr_tpu_torch.train.points_host",
           "papr_tpu_torch.model.lpips", "papr_tpu_torch.cli.train",
           "papr_tpu_torch.cli.test", "papr_tpu_torch.model.torch_convert",
           "papr_tpu_torch.train.exposure", "papr_tpu_torch.cli.exposure",
           "papr_tpu_torch.parallel", "papr_tpu_torch.parallel.mesh",
           "papr_tpu_torch.parallel.collectives"]
# Imported only inside the functions that need them.
LAZY = ("matplotlib", "PIL", "imageio", "triton")


def test_port_leaves_jax_out_of_sys_modules():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'papr_tpu'))\n"
            f"bad += sorted(m for m in sys.modules if m.split('.')[0] in {LAZY!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_in_port_sources():
    tools = os.path.join(ROOT, "tools")
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(tools, n) for n in sorted(os.listdir(tools))
        if n.startswith("torch_") and n.endswith(".py")] + [
        os.path.join(d, n) for d, _, files in
        os.walk(os.path.join(ROOT, "papr_tpu_torch"))
        for n in files if n.endswith(".py")]
    for name in paths:
        with open(name) as f:
            text = f.read()
        assert not re.search(
            r"^\s*(from|import)\s+(jax|jaxlib|papr_tpu)\b", text, re.M), name
