"""chip_smoke's phase 10 alone (the (data, rays) mesh on one card: the
one-rank references, two ranks sharing the card over gloo for the flagship
step on data = 1, rays = 2, Caterpillar's fp32 step on data = 2, rays = 1
and the sharded frames, ``cli.train`` / ``cli.test`` under ``torchrun`` on
two ranks against one, the collectives under NCCL at world size 1) on one
source tree, in its own process:

    python tools/torch_phase10.py [<tree>]     # needs a card and nvcc

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/``; its
kernels are built from its own sources. A failed comparison prints
``FAILS:`` and the phase goes on where it can; the exit code is 1 if any
failed.
"""

import os
import subprocess
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

    fails = []
    cs.fail = lambda m: (fails.append(m), print("FAILS:", m, flush=True))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    build.load()
    print(f"== tree {tree}; {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    cs.drive_mesh_path(torch.device("cuda", 0), card)
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
