"""chip_smoke's phase 8 alone (the fp32 walks on Caterpillar's model: the
fp32 kernels against their plain versions, the first step against the plain
fp32 path, 1 + 10 timed steps with their profile, a dropout step, the
serving and tiled frames) on one source tree, in its own process, then the
CUDA caching allocator's counters; for a parent / change / change / parent
comparison of the fp32 step on one card:

    python tools/torch_phase8.py [<tree>]      # needs a card and nvcc

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/`` (for
the parent, ``git archive`` of it unpacked into a git-ignored directory);
its kernels are built from its own sources. A failed comparison prints
``FAILS:`` and the phase goes on.
"""

import os
import sys


def main() -> None:
    tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from papr_tpu_torch.kernels import build

    cs.fail = lambda m: print("FAILS:", m, flush=True)
    build.load()
    print(f"== tree {tree}", flush=True)
    cs.drive_fp32_path(torch.device("cuda", 0))
    st = torch.cuda.memory_stats()
    print("allocator: retries", st["num_alloc_retries"], "device allocs",
          st["num_device_alloc"], "device frees", st["num_device_free"],
          flush=True)


if __name__ == "__main__":
    main()
