"""Run logging utilities: stdout tee, seeding, code snapshot
(``papr_tpu/utils/logging.py``; the port keeps its own copy).

Behavioral spec: reference utils.py:42-77 (Logger tee + setup_seed) and
utils.py:49-62 (source zip snapshot into the run dir).
"""

from __future__ import annotations

import os
import random
import sys
import zipfile
from datetime import datetime

import numpy as np
import torch


class Logger:
    """Tee a stream to a logfile (reference utils.py:65-77)."""

    def __init__(self, filename: str = "default.log", stream=None):
        self.terminal = stream or sys.stdout
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        self.log = open(filename, "a")
        ct = datetime.now()
        self.log.write("*" * 50 + "\n" + str(ct) + "\n" + "*" * 50 + "\n")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def setup_seed(seed: int):
    """Seed the host RNGs and torch's global generators (model weights are
    drawn from an explicit ``torch.Generator``)."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def snapshot_code(src_dir: str, dst_path: str):
    """Zip every .py under src_dir (skipping experiment outputs)."""
    py_files = []
    for root, _dirs, files in os.walk(src_dir):
        if "experiment" in root or "/." in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith(".py"):
                py_files.append(os.path.join(root, f))
    with zipfile.ZipFile(dst_path, "w") as zf:
        for f in py_files:
            zf.write(f, os.path.relpath(f, src_dir))
