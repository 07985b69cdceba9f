"""chip_smoke's phase 8 alone (the fp32 walks on Caterpillar's model: the
fp32 kernels against their plain versions, the first step against the plain
fp32 path, 1 + 10 timed steps with their profile, a dropout step, the
serving and tiled frames) on one source tree, in its own process, then the
CUDA caching allocator's counters; for a parent / change / change / parent
comparison of the fp32 step on one card:

    python tools/torch_phase8.py [<tree>] [--mode NAME ...]   # card, nvcc

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/`` (for
the parent, ``git archive`` of it unpacked into a git-ignored directory);
its kernels are built from its own sources. With ``--mode``, phase 8's runs
of those attention modes under fp32 follow (``chip_smoke.drive_fp32_modes``
on the tree's ``F32_MODES`` of those names, e.g. ``stream``: a step against
the plain fp32 step, 1 + 5 timed steps with their profile, a serving and a
tiled frame against ``auto``'s). A failed comparison prints ``FAILS:`` and
the phase goes on.

    python tools/torch_phase8.py [<tree>] --modes-only --mode NAME ...

With ``--modes-only`` the named modes' runs alone: the plain fp32 step
they are held against is computed here (as phase 8 computes it, on the
same seeded model, view and patch) instead of running phase 8 first.

    python tools/torch_phase8.py [<tree>] --bf16-frames [--mode NAME ...]

With ``--bf16-frames`` the bf16 frames of chip_smoke's phase-6 modes instead
(the tree's ``STREAM_MODES``: ``stream``, ``streamrec + query_fold`` and
``streamrec``, or those named): on the flagship model, per mode, an 800x800
serving frame (one tile) and the frame at the config's 100x100 test tiles,
each timed on the host clock after a warm-up (three readings), then one
profiled serving frame: its device time by kernel name and idle share.
The measuring code is this tool's, so a parent / change / change / parent
run reads both trees alike.
"""

import os
import sys


def bf16_frames(cs, modes, n: int = 3) -> None:
    """The bf16 serving and tiled frames of the phase-6 modes (above)."""
    import time

    import torch
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_frames, render_full_image

    dev = torch.device("cuda", 0)
    c2w = cs.orbit(0.0)
    fr_o, fr_d = get_rays_np(cs.H, cs.W, cs.FOCAL, cs.FOCAL, c2w[None])
    for mode, (tpu, _, _) in cs.STREAM_MODES.items():
        if modes and mode not in modes:
            continue
        cfg = cs.flagship_cfg(**tpu)
        params, state = cs.build_model(cfg, dev)
        th, tw = int(cfg.test.max_height), int(cfg.test.max_width)
        frames = {
            "serving": lambda: next(render_frames(
                params, state, cfg, [c2w], cs.FOCAL, cs.FOCAL, cs.H, cs.W,
                cs.H, cs.W)),
            f"tiled {th}x{tw}": lambda: render_full_image(
                params, state, cfg, fr_o, fr_d, th, tw, rgb_only=True,
                rgb_uint8=True)["rgb"][0]}
        with torch.no_grad():
            for what, fn in frames.items():
                fn()
                torch.cuda.synchronize()
                ms = []
                for _ in range(n):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                print(f"bf16 frame ({mode}, {what}): "
                      + ", ".join(f"{m:.1f}" for m in ms) + " ms", flush=True)
            wall, idle, spans = cs.device_profile(frames["serving"])
        by = {}
        for s0, e0, name in spans:
            name = name.split("(")[0].split("<")[0].replace("void ", "")
            by[name] = by.get(name, 0.0) + (e0 - s0) / 1e3
        print(f"bf16 frame ({mode}, serving, profiled): {wall:.1f} ms, idle "
              f"share {idle:.4f}; device ms by kernel: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(
                  by.items(), key=lambda x: -x[1])[:8]), flush=True)
        del params, state
        torch.cuda.empty_cache()


def plain_ref(cs, dev):
    """Phase 8's reference for its modes: the plain fp32 path's loss and
    per-group gradients, one step on Caterpillar's seeded model at the
    cropped patch of ``cs.sphere_view`` (``drive_fp32_path``'s ``ref``)."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import loss_and_grads

    cfg = cs.caterpillar_cfg()
    policy = policy_from_config(cfg)
    patch = int(cfg.dataset.patches.height)
    params, state = cs.build_model(cfg, dev)
    c2w, rayo, rayd, target = cs.sphere_view(cfg, dev)
    lp, _, gp = loss_and_grads(
        params, state, cs.caterpillar_cfg(fused_attn=False), rayo,
        cs.crop(rayd, patch), cs.crop(target, patch), c2w,
        build_loss(cfg, policy, device=dev), build_group_specs(cfg), policy)
    return float(lp), {key: torch.cat([t.float().reshape(-1)
                                       for t in tree_leaves(v)])
                       for key, v in gp.items()}


def main() -> None:
    args = sys.argv[1:]
    modes = [args[i + 1] for i, a in enumerate(args[:-1]) if a == "--mode"]
    bf16 = "--bf16-frames" in args
    only = "--modes-only" in args
    args = [a for a in args if a not in ("--bf16-frames", "--modes-only")]
    trees = [a for i, a in enumerate(args)
             if a != "--mode" and (i == 0 or args[i - 1] != "--mode")]
    tree = os.path.abspath(trees[0] if trees else os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from papr_tpu_torch.kernels import build

    cs.fail = lambda m: print("FAILS:", m, flush=True)
    build.load()
    print(f"== tree {tree}", flush=True)
    if bf16:
        bf16_frames(cs, modes)
        return
    dev = torch.device("cuda", 0)
    ref = plain_ref(cs, dev) if only else cs.drive_fp32_path(dev)["ref"]
    if modes:
        cs.F32_MODES = tuple(m for m in cs.F32_MODES if m[0] in modes)
        cs.drive_fp32_modes(dev, ref)
    st = torch.cuda.memory_stats()
    print("allocator: retries", st["num_alloc_retries"], "device allocs",
          st["num_device_alloc"], "device frees", st["num_device_free"],
          flush=True)


if __name__ == "__main__":
    main()
