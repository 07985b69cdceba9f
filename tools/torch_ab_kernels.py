"""Phase 2's and phase 8's kernel comparisons of one source tree, in its own
process, for a parent / change / change / parent run on one card:

    python tools/torch_ab_kernels.py <tree>      # needs a card and nvcc

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/`` (for
the parent, ``git archive`` of it unpacked into a git-ignored directory);
its kernels are built from its own sources. Prints chip_smoke's phase 2
lines (the flagship's kernels) and phase 8 lines (Caterpillar's fp32
kernels); a comparison that fails prints ``FAILS:`` and the run goes on.
"""

import os
import sys


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from papr_tpu_torch.kernels import build

    cs.fail = lambda m: print("FAILS:", m, flush=True)
    build.load()
    dev = torch.device("cuda", 0)
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    cs.compare_kernels(params, state, cfg, dev)
    cs.compare_train_kernels(params, state, cfg, dev)
    cs.compare_cli_kernels(params, state, cfg, dev)
    cs.compare_int8_kernels(params, state, cfg, dev)
    del params, state
    torch.cuda.empty_cache()
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180)


if __name__ == "__main__":
    main()
