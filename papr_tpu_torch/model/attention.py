"""Proximity attention: geometric k/q/v embedders + score head
(``papr_tpu/model/attention.py``).

Each ray attends over its k selected points; keys/values are
positional-encoded point-ray geometry pushed through FFN embedders, the
query embeds the ray direction, and scores are single-head scaled-dot
attention with a ReLU score activation. Embedder matmuls run in the policy
compute dtype; the score dot-product and everything after it run in fp32.
"""

from __future__ import annotations

import math

import torch

from ..nn.activations import build_activation
from ..nn.mlp import (F32, Policy, feedforward_apply, feedforward_init,
                      linear_apply, linear_init)
from ..nn.posenc import posenc

K_DIM_MAP = {1: [3, 3, 3]}
Q_DIM_MAP = {1: [3]}
V_DIM_MAP = {1: [3, 3]}


def _embed_in_dim(dims, Ls, embed_type: int, extra: int) -> int:
    if embed_type == 1:
        return sum(d + d * 2 * Ls[i] for i, d in enumerate(dims)) + extra
    if embed_type == 2:
        return sum(d * 2 * Ls[i] for i, d in enumerate(dims)) + extra
    raise ValueError(f"Unknown embedding type: {embed_type}")


def attention_init(gen: torch.Generator, attn_cfg, k_extra_dim: int = 0,
                   q_extra_dim: int = 0, v_extra_dim: int = 0,
                   device=None) -> dict:
    e = attn_cfg.embed
    d_k = _embed_in_dim(K_DIM_MAP[attn_cfg.k_type], e.k_L, e.embed_type,
                        k_extra_dim)
    d_q = _embed_in_dim(Q_DIM_MAP[attn_cfg.q_type], e.q_L, e.embed_type,
                        q_extra_dim)
    d_v = _embed_in_dim(V_DIM_MAP[attn_cfg.v_type], e.v_L, e.embed_type,
                        v_extra_dim)
    return {
        "embed_k": feedforward_init(gen, d_k, e.key.d_ff_out, e.key, device),
        "embed_q": feedforward_init(gen, d_q, e.query.d_ff_out, e.query,
                                    device),
        "embed_v": feedforward_init(gen, d_v, e.value.d_ff_out, e.value,
                                    device),
        # Score projections: xavier weights + default bias.
        "w_k": linear_init(gen, e.key.d_ff_out, attn_cfg.d_model,
                           device=device),
        "w_q": linear_init(gen, e.query.d_ff_out, attn_cfg.d_model,
                           device=device),
    }


def _encode(features, Ls, embed_type: int, pe_factor: float, pe_mult: float,
            extras):
    parts = [posenc(f, Ls[i], pe_factor, without_self=(embed_type == 2),
                    mult_factor=pe_mult) for i, f in enumerate(features)]
    if extras:
        parts = parts + list(extras)
    return torch.cat(parts, dim=-1)


def embed_kqv(params: dict, attn_cfg, k_features, q_features, v_features,
              k_extra=None, q_extra=None, v_extra=None, eps: float = 1e-6,
              policy: Policy = F32, fused: bool = False,
              skip_k: bool = False, skip_v: bool = False,
              skip_q: bool = False,
              dropout_rng: torch.Generator | None = None):
    """Run the three geometric embedders -> (embed_k, embed_q, embed_v).
    Inputs are lists of geometric features (..., K, d_i) (query:
    (..., d_i)). With ``fused`` every embedder runs posenc + LN + dense
    stack + LN in one dispatch with its kernel backward
    (``ops/fused_mlp.py``; the plain version for CPU tensors): the caller
    asks for it only where ``feedforward_fusible`` holds for all three
    stacks. ``skip_k`` / ``skip_v`` / ``skip_q`` return that embedding as
    None: the stream kernels embed those tokens themselves
    (``ops/stream_attn.py``, ``ops/stream_feat.py``; ``skip_q`` is the
    query-folded key stream). ``dropout_rng`` (training) turns on each
    embedder's dropout (rate ``embed.*.dropout_ff``); the three draw from it
    in turn, key, query, value (the JAX package splits its key in three),
    on the plain path."""
    e = attn_cfg.embed

    def run(ff_params, feats, Ls, extra, ff_cfg):
        if fused and dropout_rng is None:
            from ..ops.fused_mlp import fused_embedder_apply
            return fused_embedder_apply(ff_params, feats, extra, Ls, e,
                                        ff_cfg, policy)
        x = _encode(feats, Ls, e.embed_type, e.pe_factor, e.pe_mult_factor,
                    extra)
        return feedforward_apply(ff_params, policy.cast(x), ff_cfg,
                                 ff_cfg.d_ff_out, eps, policy, dropout_rng)

    return (None if skip_k else
            run(params["embed_k"], k_features, e.k_L, k_extra, e.key),
            None if skip_q else
            run(params["embed_q"], q_features, e.q_L, q_extra, e.query),
            None if skip_v else
            run(params["embed_v"], v_features, e.v_L, v_extra, e.value))


def attention_scores(qq: torch.Tensor, kk: torch.Tensor,
                     kernel_type: str = "scaled-dot") -> torch.Tensor:
    """Score kernel menu (reference models/attn.py:45-88). qq (..., 1, d)
    broadcastable against kk (..., K, d) -> (..., K) fp32 scores."""
    d = qq.shape[-1]
    neg = kernel_type.startswith("-")
    base = kernel_type[1:] if neg else kernel_type
    if base in ("scaled-dot", "dot"):
        s = (qq * kk).sum(-1)
        if base == "scaled-dot":
            s = s / math.sqrt(d)
    elif base == "l1-dist":
        s = torch.abs(qq - kk).sum(-1)
    elif base in ("l2-dist", "scaled-l2-dist"):
        s = torch.sqrt(torch.square(qq - kk).sum(-1))
        if base == "scaled-l2-dist":
            s = s / math.sqrt(d)
    elif base == "cosine" and not neg:
        s = (qq * kk).sum(-1) / (torch.linalg.norm(qq, dim=-1)
                                 * torch.linalg.norm(kk, dim=-1))
    else:
        raise ValueError(f"Unknown kernel type: {kernel_type}")
    return -s if neg else s


def score_fusible(attn_cfg) -> bool:
    """True when the attention tail is what the eval kernel computes."""
    return (attn_cfg.score_act in ("relu", "none")
            and attn_cfg.get("kernel_type", "scaled-dot") == "scaled-dot")


def score_tail(params: dict, attn_cfg, ek, eq, policy: Policy = F32):
    """w_k / w_q projections, the score kernel and ``score_act`` (fp32)."""
    kk = linear_apply(params["w_k"], ek, policy).float()
    qq = linear_apply(params["w_q"], eq, policy).float()
    scores = attention_scores(qq, kk, attn_cfg.get("kernel_type",
                                                   "scaled-dot"))
    return build_activation(attn_cfg.score_act)(scores)
