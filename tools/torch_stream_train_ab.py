"""Does the bf16 stream backwards' distance to their plain versions move
training? The synth sphere (``papr_tpu_torch/dataset/synth.py``) trained on
the card from one seed twice, with the same data, init and schedule: once
through ``tpu.fused_attn: streamrec`` (the key / value stream kernels,
their bf16 backwards on wgmma) and once through ``fused_attn: false`` (the
plain PyTorch path, autograd through the same bf16 compute). Prints both
runs' train loss and eval PSNR at every eval step, then one JSON line.

    python tools/torch_stream_train_ab.py [--steps 300] [--every 50]
        [--side 400] [--views 8]

The configuration is ``chip_smoke.cli_config``'s (``configs/default.yml``
with the sphere's point init: 30,000 padded points, k = 20, 160x160
patches, bf16, MSE + 1e-2 LPIPS on the seeded random VGG16), with the
prune / grow events moved past the run and ``topk_impl: cull``.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run(scene: str, save_dir: str, steps: int, every: int, mode) -> dict:
    import torch
    import chip_smoke as cs
    from papr_tpu_torch.config import Config, make_eval_config, merge_config
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.train.loop import train_and_eval

    cfg = cs.cli_config(scene, save_dir, steps, topk_impl="cull",
                        fused_attn=mode)
    late = steps + 10
    cfg = Config(merge_config(dict(cfg), {
        "index": f"ab_{mode}", "eval": {"step": every},
        "training": {k: late for k in ("prune_start", "prune_stop",
                                       "add_start", "add_stop")}}))
    before = (sa.key_stream_bwd.launches, sa.value_stream_bwd.launches)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, _, hist = train_and_eval(cfg, make_eval_config(cfg))
    torch.cuda.synchronize()
    return {"mode": str(mode), "seconds": time.perf_counter() - t0,
            "steps": hist["steps"], "train_loss": hist["train_losses"],
            "eval_psnr": hist["eval_psnrs"],
            "stream_bwd_launches": [sa.key_stream_bwd.launches - before[0],
                                    sa.value_stream_bwd.launches - before[1]]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--side", type=int, default=400)
    ap.add_argument("--views", type=int, default=8)
    opt = ap.parse_args()
    import torch
    from papr_tpu_torch.dataset.synth import make_demo_scene
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    root = tempfile.mkdtemp(prefix="stream_train_ab_")
    scene = make_demo_scene(os.path.join(root, "scene"), n_train=opt.views,
                            n_test=2, H=opt.side, W=opt.side)
    runs = [run(scene, os.path.join(root, "exp"), opt.steps, opt.every, m)
            for m in ("streamrec", False)]
    print(card)
    print("step | streamrec loss, PSNR | plain (fused_attn: false) loss, PSNR")
    for i, step in enumerate(runs[0]["steps"]):
        a, b = runs[0], runs[1]
        print(f"{step} | {a['train_loss'][i]:.6f}, {a['eval_psnr'][i]:.3f} | "
              f"{b['train_loss'][i]:.6f}, {b['eval_psnr'][i]:.3f}")
    print(json.dumps({"card": card, "runs": runs}))
    if runs[0]["stream_bwd_launches"] != [opt.steps, opt.steps] or \
            runs[1]["stream_bwd_launches"] != [0, 0]:
        raise SystemExit("the runs did not take the paths they name: "
                         f"{[r['stream_bwd_launches'] for r in runs]}")


if __name__ == "__main__":
    main()
