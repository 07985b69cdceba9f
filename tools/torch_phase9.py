"""chip_smoke's phase 9 alone (exposure control and the model.pth format on
``configs/t2_sphere_exposure.yml`` and
``configs/t2/Caterpillar_exposure_control.yml``: the first step and the
candidate scores against the plain fp32 path, one resample and one step
with exact launches and times, ``cli.exposure`` and ``cli.test --exp`` in
process, the model.pth round trip) on one source tree, in its own process:

    python tools/torch_phase9.py [<tree>]      # needs a card and nvcc

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/``; its
kernels are built from its own sources. A failed comparison prints
``FAILS:`` and the phase goes on; the exit code is 1 if any failed.
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
    print(f"== tree {tree}; {card}", flush=True)
    cs.drive_exposure_path(torch.device("cuda", 0), card)
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
