"""The port's command-line entry points under the stream attention modes
(``tpu.fused_attn: stream``; ``streamrec`` with ``tpu.query_fold: true``), as
subprocesses on a tiny procedural scene (``PAPR_PLATFORM=cpu``): train with a
prune + grow event and a checkpoint, then the test render from it."""

import pytest

from papr_tpu_torch.dataset.synth import make_demo_scene
from test_torch_cli import _run, _write_cfg


@pytest.mark.parametrize("tpu", [{"fused_attn": "stream"},
                                 {"fused_attn": "streamrec",
                                  "query_fold": True}],
                         ids=["stream", "query_fold"])
def test_train_and_test_cli_under_stream_modes(tmp_path, tpu):
    scene = make_demo_scene(str(tmp_path / "scene"), n_train=2, n_test=1,
                            H=32, W=32)
    opt = _write_cfg(tmp_path, scene,
                     tpu={"ray_chunk": 512, "topk_impl": "cull", **tpu})
    out = _run("papr_tpu_torch.cli.train", ["--opt", opt]).stdout
    assert "Training finished!" in out
    assert "Pruned" in out and "Added 5 points" in out
    assert (tmp_path / "experiments" / "smoke" / "checkpoint.npz").exists()
    out = _run("papr_tpu_torch.cli.test", ["--opt", opt]).stdout
    assert "at step 8" in out and out.count("Test frame:") == 1
    assert "test PSNR:" in out and "nan" not in out.split("test PSNR:")[1][:12]
