"""Learning-rate schedules as pure functions of the global step
(``papr_tpu/train/schedules.py``).

A linear warmup (start factor 1e-16) chained with one of {none, linear,
cosine, cosine-hlfperiod, exp, stop} (reference models/utils.py:260-322).
Each schedule is ``f(step) -> lr``, evaluated on the host in float32 like the
JAX package's fp32 arithmetic, so an optimizer rebuild after prune/grow
needs no scheduler fast-forward: the step is passed in.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def make_schedule(sched_cfg, max_steps: int, lr_factor: float = 1.0):
    """Returns f(step) -> lr (float). ``sched_cfg`` is e.g.
    ``training.lr.attn`` with fields type / base_lr / warmup / gamma."""
    base = _F(float(sched_cfg.base_lr) * float(lr_factor))
    kind = sched_cfg.type
    warmup = int(sched_cfg.get("warmup", 0))
    if kind == "none":
        return lambda step: float(base)

    start_factor = _F(1e-16 if warmup > 0 else 1.0)

    def warmup_factor(t):
        if warmup <= 0:
            return _F(1.0)
        frac = _F(min(t, _F(warmup)) / _F(warmup))
        return _F(start_factor + (_F(1.0) - start_factor) * frac)

    if kind in ("linear", "cosine", "cosine-hlfperiod"):
        T = _F(max(max_steps - warmup, 1) * (2 if kind == "cosine-hlfperiod"
                                             else 1))
        if kind == "linear":
            decay = lambda u: _F(_F(1.0) - _F(min(u, T) / T))
        else:
            decay = lambda u: _F((_F(1.0) + np.cos(_F(np.pi) * u / T)) / _F(2.0))
    elif kind == "exp":
        gamma = _F(float(sched_cfg.gamma))
        decay = lambda u: _F(gamma ** u)
    elif kind == "stop":
        # StepLR(step_size=1, gamma=0): full lr for the first post-warmup
        # step, zero afterwards.
        decay = lambda u: _F(1.0 if u < 1 else 0.0)
    else:
        raise NotImplementedError(kind)

    def fn(step):
        t = _F(step)
        u = _F(max(t - _F(warmup), _F(0.0)))
        factor = warmup_factor(t) if t < warmup else decay(u)
        return float(_F(base * factor))

    return fn
