"""Training CLI: python -m papr_tpu_torch.cli.train --opt configs/nerfsyn/chair.yml [--resume 1]

The flags, config files, log files and output layout (under
<save_dir>/<index>) of the repository's ``train.py``. Runs on the GPU;
``PAPR_PLATFORM=cpu`` asks for the CPU (e.g. for CI). A config whose
``tpu.mesh`` names N > 1 devices runs as N ranks (``parallel/mesh.py``):

    torchrun --standalone --nproc_per_node=N -m papr_tpu_torch.cli.train --opt <yml>

Rank 0 alone writes the logs, plots and checkpoints.
"""

import argparse
import os
import shutil
import sys

from ..config import load_config, make_eval_config
from ..parallel.mesh import init_ranks, process_rank
from ..train.loop import train_and_eval
from ..utils.logging import Logger, setup_seed, snapshot_code


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="PAPR (PyTorch / CUDA)")
    parser.add_argument("--opt", type=str, default="", help="Option file path")
    parser.add_argument("--resume", type=int, default=0, help="Resume training")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.opt)
    eval_cfg = make_eval_config(cfg)

    init_ranks()
    if process_rank() == 0:
        log_dir = os.path.join(cfg.save_dir, cfg.index)
        os.makedirs(log_dir, exist_ok=True)
        sys.stdout = Logger(os.path.join(log_dir, "train.log"), sys.stdout)
        sys.stderr = Logger(os.path.join(log_dir, "train_error.log"),
                            sys.stderr)
        shutil.copyfile(__file__,
                        os.path.join(log_dir, os.path.basename(__file__)))
        if args.opt:
            shutil.copyfile(args.opt,
                            os.path.join(log_dir, os.path.basename(args.opt)))
        snapshot_code(".", os.path.join(log_dir, "code.zip"))

    setup_seed(cfg.seed)
    return train_and_eval(cfg, eval_cfg, resume=args.resume)


if __name__ == "__main__":
    main()
