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
"""

import os
import sys


def main() -> None:
    args = sys.argv[1:]
    modes = [args[i + 1] for i, a in enumerate(args[:-1]) if a == "--mode"]
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
    f32 = cs.drive_fp32_path(torch.device("cuda", 0))
    if modes:
        cs.F32_MODES = tuple(m for m in cs.F32_MODES if m[0] in modes)
        cs.drive_fp32_modes(torch.device("cuda", 0), f32["ref"])
    st = torch.cuda.memory_stats()
    print("allocator: retries", st["num_alloc_retries"], "device allocs",
          st["num_device_alloc"], "device frees", st["num_device_free"],
          flush=True)


if __name__ == "__main__":
    main()
