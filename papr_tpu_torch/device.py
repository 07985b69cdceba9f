"""Where the port's entry points run.

The rule of the package: an entry point runs on the card unless the caller
asks for the CPU. ``resolve_device(None)`` is the card and raises when there
is none; it never carries on quietly on the CPU. The command-line entry
points and ``train_and_eval`` read ``PAPR_PLATFORM`` (the variable the JAX
CLIs honour): ``PAPR_PLATFORM=cpu`` asks for the CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``torch.device("cuda")`` (raises without a card); anything
    else -> ``torch.device(device)``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "papr_tpu_torch runs on the GPU by default and "
            "torch.cuda.is_available() is false; pass device='cpu' (or set "
            "PAPR_PLATFORM=cpu for the command-line entry points) to ask "
            "for the CPU")
    return torch.device("cuda")


def platform_device() -> torch.device:
    """The device ``PAPR_PLATFORM`` asks for: unset, ``gpu`` or ``cuda`` ->
    the card (raises without one); ``cpu`` -> the CPU."""
    want = os.environ.get("PAPR_PLATFORM", "").strip().lower()
    if want in ("", "gpu", "cuda"):
        return resolve_device(None)
    if want == "cpu":
        return torch.device("cpu")
    raise ValueError(f"PAPR_PLATFORM={want!r}: want cpu, gpu or cuda")
