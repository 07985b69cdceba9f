#!/usr/bin/env python3
"""Drive the PyTorch port's render path and training step on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

0. Require CUDA; print the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``papr_tpu_torch/csrc`` (nvcc, sm_90a, one
   process per source, all at once).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (the flagship model: 30k-point cube init, k = 20,
   bf16; the orbit pose of ``bench.py`` with focal 700 at 800x800):
   cull selection on the full frame, the query embedder on its 640,000
   rays, the eval attention on a 160x160 ray block; then, on a 160x160
   training patch cropped at a seeded offset from the same frame, the
   training selection (exact 'approx' prefilter, one 2048-wide chunk), the
   query embedder backward and the key / value streams forward and
   backward (every output and gradient, d_rec per routing lane group).
   Print errors and times.
3. Render 1 + 3 orbit frames at 800x800 through ``render_frames`` (one
   full-frame tile) and one frame through ``render_full_image`` with the
   config's 100x100 test tiles; check the frames, that every kernel of the
   path launched and that no plain version ran; profile 3 more frames for
   the device-time split by stage; then hold a small frame of the kernel
   path against the plain fp32 path on the card.
4. Train on the patch with ``make_train_step`` (MSE + 1e-2 LPIPS on the
   seeded random VGG16 backbone): 1 warm-up and 5 timed steps (ms/step,
   rays/s, peak memory); check the loss and gradients are finite, every
   trained group moved, every training kernel launched on each step and no
   plain version ran; profile one step by stage; prune + grow and one more
   step on a fresh optimizer state; then one 32x32 step of the kernel path
   against the plain fp32 path (loss and per-group gradients).
5. Print the kernels' JSON line, then the result line.

Imports nothing of JAX. Weights are random, from fixed seeds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Tolerances (bf16 compute on both sides; the plain versions round at the
# same points, so differences come from summation order inside the MMAs).
K1_MIN_EQUAL = 0.999      # share of rays whose index sets equal the plain's
K2_REL = 1e-2             # relative Frobenius error of the embedder output
K3_REL = 1e-2             # relative Frobenius error of fused
K3_ATTN_ABS = 5e-3        # max abs error of attn
TILED_MIN_CLOSE = 0.999   # share of pixels within 2/255, tiled vs full tile
REF_REL = 3e-2            # small frame: bf16 kernel path vs fp32 plain path
# Training kernels. Forward: relative Frobenius error of each output;
# backward: of every gradient, d_rec per lane group (both sides round
# activations and dz to bf16; the plain version also rounds dW to bf16 and
# sums in another order; a hidden relu whose input the two forwards round
# to opposite signs switches one token's path in one of them only). The
# plain key stream is given the kernel forward's score relu pattern, so
# both differentiate the same function. The sound kernels read up to 3.2e-2
# here (value d_rec, key walk biases); planted faults read 5.4e-2 (the
# LayerNorm backward's variance term dropped, key walk) and above (PERF.md,
# Findings).
K1_TRAIN_MIN_EQUAL = 0.999
FWD_REL = 1e-2
SS_REL = 3e-2          # masked scores keep ~6 % of the dots: ~5x raw's error
RELU_MIN_AGREE = 0.99  # share of alive scores whose relu the forwards agree on
BWD_REL = 4e-2
# One 32x32 training step, bf16 kernel path vs fp32 plain path: loss and
# per-group gradients (relative Frobenius error).
TRAIN_REF_LOSS_REL = 2e-2
TRAIN_REF_GRAD_REL = 1e-1

H = W = 800
FOCAL = 700.0
BLOCK = 160               # eval-attention comparison block (160x160 rays)
PATCH = 160               # training patch edge (configs/default.yml patches)
TRAIN_STEPS = 5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def orbit(theta: float, radius: float = 35.0) -> np.ndarray:
    """Camera on a y-axis orbit looking inward (bench.py:116-126)."""
    c, s = np.cos(theta), np.sin(theta)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                   np.float32)
    base = np.eye(4, dtype=np.float32)
    base[:3, 3] = [0, 0, radius]
    return rot @ base


def flagship_cfg(points: int = 30000, k: int = 20, amp: bool = True, **tpu):
    """The configs/default.yml model as bench.py:112 builds it."""
    from papr_tpu_torch.config import load_config
    return load_config(overrides={
        "use_amp": amp, "max_num_pts": points,
        "geoms": {"points": {"init_num": points, "select_k": k}},
        "tpu": {"ray_chunk": 4096, **tpu}})


def build_model(cfg, device):
    """create_model with seeded random influence scores, so the attention
    scores (relu(q.k) x influence) are not all zero as at a fresh init."""
    import torch
    from papr_tpu_torch.model.papr import create_model
    params, state = create_model(cfg, seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    params["points_influ_scores"] = torch.randn(
        params["points_influ_scores"].shape, generator=g).to(device)
    return params, state


def cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn`` over n runs after one warm-up, by CUDA
    events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def query_walk(params, cfg):
    """The query embedder of ``params`` as a kernel walk (ray directions)."""
    from papr_tpu_torch.ops.fused_mlp import posenc_plan, walk_from_params
    e = cfg.models.attn.embed
    _, qcols = posenc_plan((3,), tuple(int(l) for l in e.q_L),
                           int(e.embed_type), float(e.pe_factor),
                           float(e.pe_mult_factor), 0)
    return walk_from_params(params["attn"]["embed_q"], e.query, qcols)


def rel_fro(a, b) -> float:
    a, b = a.float(), b.float()
    return float(((a - b).norm() / b.norm().clamp_min(1e-30)).item())


# ------------------------------------------------------------------ phases --

def compare_kernels(params, state, cfg, device, n_time: int = 5) -> list:
    """Phase 2: each kernel against its plain version on the same inputs."""
    import torch
    from papr_tpu_torch.model.papr import _point_record, model_meta
    from papr_tpu_torch.nn.mlp import linear_apply, policy_from_config
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import tile_cull as tc
    from papr_tpu_torch.ops.fused_mlp import walk_from_params
    from papr_tpu_torch.ops.geometry import get_rays, normalize_vector
    from papr_tpu_torch.ops.topk import VAL_MASK

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    meta = model_meta(cfg)
    k = meta.select_k
    e = cfg.models.attn.embed
    pcf = cfg.geoms.point_feats
    eps = float(cfg.eps)
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    rayo, rayd = get_rays(H, W, c2w, focal)
    points, alive = params["points"], state["alive"]
    results = []

    # K1: cull selection, full frame.
    M = int(cfg.get_path("tpu.cull_candidates", 2048))
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        points, alive, rayo[0], rayd, M=M, block=16, eps=eps,
        prefilter="packsort", early_exit=True)
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    torch.cuda.synchronize()
    # Packed distance of each selected index, recomputed with the kernel's
    # formula, so differing rays can be shown to be near-ties.
    v = points.float() - rayo[0]
    vv = (v * v).sum(-1) + torch.where(alive, 0.0, float("inf"))

    def packed_vals(sel):
        g = sel.long().clamp_max(points.shape[0] - 1)
        pv = v[g]                                        # (T, TR, k, 3)
        d = tiles[:, :, None, :]
        t = (d[..., 0] * pv[..., 0] + d[..., 1] * pv[..., 1]
             + d[..., 2] * pv[..., 2])
        dist = torch.clamp_min(vv[g] - t * t * f[..., None], 0.0)
        return dist, dist.view(torch.int32) & VAL_MASK

    set_eq = (torch.sort(got, -1).values == torch.sort(want, -1).values).all(-1)
    frac_eq = float(set_eq.float().mean().item())
    d_got, q_got = packed_vals(got)
    d_want, q_want = packed_vals(want)
    ties_ok = bool((torch.sort(q_got, -1).values
                    == torch.sort(q_want, -1).values).all().item())
    k1_err = float((torch.sort(d_got, -1).values
                    - torch.sort(d_want, -1).values).abs().max().item())
    ms = cuda_ms(lambda: tc.cull_select(tiles, f, recs, k, chunk, ee), n_time)
    plain_ms = cuda_ms(
        lambda: tc.cull_select_plain(tiles, f, recs, k, chunk, ee), 2)
    print(f"phase 2 K1 cull_select: tiles={tuple(tiles.shape)} M={recs.shape[-1]} "
          f"k={k} chunk={chunk} early_exit={ee}: equal sets {frac_eq:.6f} "
          f"(need >= {K1_MIN_EQUAL}), other rays near-ties only: {ties_ok}, "
          f"max |dist diff| {k1_err:.3g}; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms", flush=True)
    if frac_eq < K1_MIN_EQUAL or not ties_ok:
        fail("K1 cull selection disagrees with its plain version")
    results.append({"name": "cull_select", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/cull_topk.cu",
                    "replaces": "papr_tpu/ops/tile_cull.py:110",
                    "max_abs_err": k1_err, "ms": ms, "plain_ms": plain_ms})

    # K2: query embedder on the frame's 640,000 rays.
    x = rayd.reshape(-1, 3).contiguous()
    qwalk = query_walk(params, cfg)
    got = fm.fused_mlp(x, qwalk, cdt)
    want = fm.fused_mlp_plain(x, qwalk, cdt)
    err = rel_fro(got, want)
    k2_abs = float((got.float() - want.float()).abs().max().item())
    ms = cuda_ms(lambda: fm.fused_mlp(x, qwalk, cdt), n_time)
    plain_ms = cuda_ms(lambda: fm.fused_mlp_plain(x, qwalk, cdt), 2)
    print(f"phase 2 K2 fused_mlp (query embedder): x={tuple(x.shape)} -> "
          f"{tuple(got.shape)} {got.dtype}: rel Frobenius {err:.3e} "
          f"(need <= {K2_REL}), max abs {k2_abs:.3e}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms", flush=True)
    if not (err <= K2_REL):
        fail("K2 fused embedder disagrees with its plain version")
    results.append({"name": "fused_mlp", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/fused_mlp.cu",
                    "replaces": "papr_tpu/ops/fused_mlp.py:417",
                    "max_abs_err": k2_abs, "ms": ms, "plain_ms": plain_ms})

    # K3: eval attention on the central 160x160 ray block.
    r0 = (H - BLOCK) // 2
    blk = rayd[r0:r0 + BLOCK, r0:r0 + BLOCK].contiguous()
    T = BLOCK * BLOCK
    idx = tc.select_topk_culled(points, alive, rayo[0], blk, k, M=M,
                                block=16, eps=eps, prefilter="packsort")
    record = _point_record(params, alive, meta, pcf)
    rayd_flat = blk.reshape(T, 3)
    rayo_flat = rayo.expand(T, 3).contiguous()
    rays = normalize_vector(rayd_flat, eps=eps)
    eq = fm.fused_mlp(rayd_flat.contiguous(), qwalk, cdt)
    qq = linear_apply(params["attn"]["w_q"], eq, policy).float()

    def plan(has_pos, Ls, use):
        extra = int(pcf.dim) if (meta.use_pc_feats and use) else 0
        return sa.rec_pe_plan(has_pos, tuple(int(l) for l in Ls),
                              int(e.embed_type), float(e.pe_factor),
                              float(e.pe_mult_factor), extra)

    kwalk = walk_from_params(params["attn"]["embed_k"], e.key,
                             plan(True, e.k_L, pcf.use_ink))
    vwalk = walk_from_params(params["attn"]["embed_v"], e.value,
                             plan(False, e.v_L, pcf.use_inv))
    args = (record, idx, rayo_flat, rays, qq, kwalk,
            params["attn"]["w_k"]["w"], params["attn"]["w_k"]["bias"], vwalk,
            cfg.models.attn.score_act, float(cfg.geoms.background.constant),
            bool(cfg.models.normalize_topk_attn), eps, cdt)
    f_got, a_got = sa.attend_eval_idx(*args)
    f_want, a_want = sa.attend_eval_plain(*args)
    err = rel_fro(f_got, f_want)
    f_abs = float((f_got - f_want).abs().max().item())
    a_abs = float((a_got - a_want).abs().max().item())
    finite = bool(torch.isfinite(f_got).all() and torch.isfinite(a_got).all())
    ms = cuda_ms(lambda: sa.attend_eval_idx(*args), n_time)
    plain_ms = cuda_ms(lambda: sa.attend_eval_plain(*args), 2)
    gflop = 2.0 * T * k * sum(
        int(w.shape[0]) * int(w.shape[1])
        for w in kwalk.ws + vwalk.ws + (params["attn"]["w_k"]["w"],)) / 1e9
    print(f"phase 2 K3 attend_eval: T={T} K={k}: fused rel Frobenius "
          f"{err:.3e} (need <= {K3_REL}), max abs {f_abs:.3e}; attn max abs "
          f"{a_abs:.3e} (need <= {K3_ATTN_ABS}); finite {finite}; kernel "
          f"{ms:.3f} ms ({gflop / ms:.1f} TFLOP/s of walk matmuls), plain "
          f"{plain_ms:.3f} ms", flush=True)
    if not (err <= K3_REL and a_abs <= K3_ATTN_ABS and finite):
        fail("K3 eval attention disagrees with its plain version")
    results.append({"name": "attend_stream_eval", "route": "cuda",
                    "source": "papr_tpu_torch/csrc/attend_eval.cu",
                    "replaces": "papr_tpu/ops/stream_attn.py:1856",
                    "max_abs_err": f_abs, "ms": ms, "plain_ms": plain_ms})
    return results


def training_patch(device, seed: int = 0):
    """A 160x160 crop, at a seeded offset, of the orbit camera's 800x800
    rays (focal 700): coherent pixel tiles, as a training patch is.
    Returns rays_o (1, 3), rays_d (1, 160, 160, 3) on the card."""
    import torch
    from papr_tpu_torch.ops.geometry import get_rays
    rng = np.random.default_rng(seed)
    y0, x0 = (int(v) for v in rng.integers(0, H - PATCH, 2))
    c2w = torch.as_tensor(orbit(0.0), device=device)
    focal = torch.tensor([FOCAL, FOCAL], device=device)
    rayo, rayd = get_rays(H, W, c2w, focal)
    return rayo, rayd[y0:y0 + PATCH, x0:x0 + PATCH][None].contiguous()


def _rels(got, want) -> list:
    """Relative Frobenius error of each output; where the plain output is
    all zero, 0 if the kernel's is too, else inf."""
    return [rel_fro(g, w) if float(w.abs().max()) > 0
            else (0.0 if float(g.abs().max()) == 0 else float("inf"))
            for g, w in zip(got, want)]


def _max_abs(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def walk_labels(walk) -> list:
    """Names of a walk's gradients, in walk_tensors order."""
    n = len(walk.ws)
    return ([f"W{i}" for i in range(n)] + [f"b{i}" for i in range(n)]
            + [f"{ln}.{p}" for ln in ("ln_in", "ln_out")
               if getattr(walk, ln) is not None for p in "ab"])


def rec_lanes(grads) -> list:
    """d_rec (first of ``grads``) split by routing rule: the geometry
    gradient (lanes 0:3), d_influence (lane 3), the rest (alive lane and
    point features)."""
    d = grads[0]
    return [d[..., :3], d[..., 3], d[..., 4:]] + list(grads[1:])


REC_LABELS = ["d_rec[0:3]", "d_rec[3]", "d_rec[4:]"]


def compare_train_kernels(params, state, cfg, device, n_time: int = 3) -> dict:
    """Phase 2, training shapes: the selection at its training shape and
    the five training kernel bodies against their plain versions on the
    160x160 patch (T = 25,600 rays, K = 20). Every case runs and prints
    before the phase fails on any of them."""
    import torch
    from papr_tpu_torch.model.papr import _kernel_inputs, model_meta
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import tile_cull as tc

    policy = policy_from_config(cfg)
    cdt = policy.compute_dtype
    meta = model_meta(cfg)
    k = meta.select_k
    eps = float(cfg.eps)
    score_act = cfg.models.attn.score_act
    bkg = float(cfg.geoms.background.constant)
    normalize = bool(cfg.models.normalize_topk_attn)
    points, alive = params["points"], state["alive"]
    rayo, rayd = training_patch(device)
    T = PATCH * PATCH
    gen = torch.Generator(device=device).manual_seed(3)
    out, failed = {}, []

    # K1 at the training shape: approx (exact top-k) prefilter, no early
    # exit, one 2048-wide chunk.
    tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
        points, alive, rayo[0], rayd[0], M=2048, block=16, eps=eps,
        prefilter="approx", early_exit=True)
    got = tc.cull_select(tiles, f, recs, k, chunk, ee)
    want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
    frac = float((torch.sort(got, -1).values == torch.sort(want, -1).values)
                 .all(-1).float().mean().item())
    ms = cuda_ms(lambda: tc.cull_select(tiles, f, recs, k, chunk, ee), n_time)
    plain_ms = cuda_ms(
        lambda: tc.cull_select_plain(tiles, f, recs, k, chunk, ee), 1)
    print(f"phase 2 K1 cull_select (training): tiles={tuple(tiles.shape)} "
          f"M={recs.shape[-1]} chunk={chunk} early_exit={ee}: equal sets "
          f"{frac:.6f} (need >= {K1_TRAIN_MIN_EQUAL}); kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms", flush=True)
    if chunk != 2048 or ee or frac < K1_TRAIN_MIN_EQUAL:
        failed.append("cull_select (training shape)")
    out["cull_select"] = {"equal_sets_train": frac, "ms_train": ms,
                          "plain_ms_train": plain_ms}

    idx = tc.select_topk_culled(points, alive, rayo[0], rayd[0], k, M=2048,
                                block=16, eps=eps, prefilter="approx")
    record, rayo_f, rays, qq, kwalk, vwalk = _kernel_inputs(
        params, cfg, meta, rayo, rayd, alive, eps, policy)
    qq = qq.detach()
    rec = record[idx.T.long()].contiguous()               # (K, T, 128)
    wk = params["attn"]["w_k"]["w"]
    bk = params["attn"]["w_k"]["bias"]
    x = rayd.reshape(T, 3).contiguous()
    qwalk = query_walk(params, cfg)
    randn = lambda *shape: torch.randn(*shape, generator=gen, device=device)

    def record_case(name, source, replaces, fn, plain, tol, labels):
        """Kernel against its plain version (the same bf16 compute): every
        output's relative Frobenius error held to ``tol``."""
        g = fn()
        w = plain()
        torch.cuda.synchronize()
        rels = _rels(g, w)
        finite = all(bool(torch.isfinite(t).all()) for t in g)
        ms = cuda_ms(fn, n_time)
        p_ms = cuda_ms(plain, 1)
        worst = max(rels)
        print(f"phase 2 {name}: T={T} K={k}: rel Frobenius "
              + ", ".join(f"{l} {r:.2e}" for l, r in zip(labels, rels))
              + f" (max {worst:.3e}, need <= {tol}); finite {finite}; "
              f"kernel {ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
        if not (finite and worst <= tol and len(rels) == len(labels)):
            failed.append(name)
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": _max_abs(g, w),
                     "max_rel_err": worst, "ms": ms, "plain_ms": p_ms}
        return g

    dy = randn(T, int(qwalk.ws[-1].shape[1]))
    record_case(
        "fused_mlp_bwd", "papr_tpu_torch/csrc/fused_mlp_bwd.cu",
        "papr_tpu/ops/fused_mlp.py:424",
        lambda: (lambda r: [r[0]] + r[1])(fm.fused_mlp_bwd(x, dy, qwalk, cdt)),
        lambda: (lambda r: [r[0]] + r[1])(
            fm.fused_mlp_bwd_plain(x, dy, qwalk, cdt)),
        BWD_REL, ["dx"] + walk_labels(qwalk))
    kargs = (rec, rayo_f, rays, qq, kwalk, wk, bk)
    kopts = (score_act, bkg, eps, cdt)
    attn, raw = record_case(
        "key_stream_fwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:798",
        lambda: list(sa.key_stream_fwd(*kargs, *kopts))[:2],
        lambda: list(sa.key_stream_plain(*kargs, *kopts))[:2], FWD_REL,
        ["attn", "raw"])
    # The saved scores: exactly act(raw) x influence of the kernel's own
    # raw, and against the plain version's on the alive scores whose relu
    # both forwards agree on (the rest differ by a switched-off score).
    ss = sa.key_stream_fwd(*kargs, *kopts)[2]
    _, raw_p, ss_p = sa.key_stream_plain(*kargs, *kopts)
    live = rec[..., 4].T > 0.5
    sact = torch.clamp_min(raw, 0.0) if score_act == "relu" else raw
    exact = torch.equal(ss, torch.where(live, sact * rec[..., 3].T,
                                        sa.NEG_BIG))
    same = (raw > 0) == (raw_p > 0) if score_act == "relu" else live
    agree = float(same[live].float().mean())
    ss_rel = rel_fro(ss[live & same], ss_p[live & same])
    print(f"phase 2 key_stream_fwd saved scores: ss == act(raw) x influence "
          f"{exact}; alive scores whose relu pattern agrees {agree:.6f} "
          f"(need >= {RELU_MIN_AGREE}); ss on those rel Frobenius "
          f"{ss_rel:.3e} (need <= {SS_REL})", flush=True)
    if not (exact and agree >= RELU_MIN_AGREE and ss_rel <= SS_REL):
        failed.append("key_stream_fwd saved scores")
    # The plain backward differentiates the kernel forward's relu pattern.
    relu_on = raw > 0
    dattn = randn(T, k + 1)
    record_case(
        "key_stream_bwd", "papr_tpu_torch/csrc/key_stream.cu",
        "papr_tpu/ops/stream_attn.py:835",
        lambda: rec_lanes(sa.key_stream_bwd(*kargs, raw, ss, dattn, *kopts)),
        lambda: rec_lanes(sa.key_stream_bwd_plain(*kargs, dattn, *kopts,
                                                  relu_on=relu_on)),
        BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "dqq", "dW_k", "db_k"]
        + walk_labels(kwalk))
    vargs = (rec, rayo_f, rays, attn, vwalk)
    vopts = (normalize, eps, cdt)
    record_case(
        "value_stream_fwd", "papr_tpu_torch/csrc/value_stream.cu",
        "papr_tpu/ops/stream_attn.py:1601",
        lambda: [sa.value_stream_fwd(*vargs, *vopts)],
        lambda: [sa.value_stream_plain(*vargs, *vopts)], FWD_REL, ["fused"])
    dfused = randn(T, int(vwalk.ws[-1].shape[1]))
    record_case(
        "value_stream_bwd", "papr_tpu_torch/csrc/value_stream.cu",
        "papr_tpu/ops/stream_attn.py:1634",
        lambda: rec_lanes(sa.value_stream_bwd(*vargs, dfused, *vopts)),
        lambda: rec_lanes(sa.value_stream_bwd_plain(*vargs, dfused, *vopts)),
        BWD_REL, REC_LABELS + ["d_rayo", "d_rays", "d_attn"]
        + walk_labels(vwalk))
    del rec, record
    torch.cuda.empty_cache()
    if failed:
        fail(f"training kernels disagree with their plain versions: {failed}")
    return out


def counters(training: bool = False):
    """The launch counters of one path's kernels and the call counters of
    every plain version."""
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import tile_cull as tc
    kernels = {"cull_select": tc.cull_select, "fused_mlp": fm.fused_mlp}
    if training:
        kernels.update({"fused_mlp_bwd": fm.fused_mlp_bwd,
                        "key_stream_fwd": sa.key_stream_fwd,
                        "key_stream_bwd": sa.key_stream_bwd,
                        "value_stream_fwd": sa.value_stream_fwd,
                        "value_stream_bwd": sa.value_stream_bwd})
    else:
        kernels["attend_stream_eval"] = sa.attend_eval_idx
    plains = {"cull_select": tc.cull_select_plain,
              "fused_mlp": fm.fused_mlp_plain,
              "fused_mlp_bwd": fm.fused_mlp_bwd_plain,
              "attend_stream_eval": sa.attend_eval_plain,
              "key_stream_fwd": sa.key_stream_plain,
              "key_stream_bwd": sa.key_stream_bwd_plain,
              "value_stream_fwd": sa.value_stream_plain,
              "value_stream_bwd": sa.value_stream_bwd_plain}
    return kernels, plains


def reset_counters(kernels, plains) -> None:
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains.values():
        fn.calls = 0


def drive_main_path(params, state, cfg, device) -> dict:
    """Phase 3: the serving path, counters reset just before it."""
    import torch
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_frames, render_full_image

    kernels, plains = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels, plains)

    poses = [orbit(2 * np.pi * i / 3) for i in range(3)]
    t0 = time.perf_counter()
    warm = list(render_frames(params, state, cfg, [orbit(0.3)], FOCAL, FOCAL,
                              H, W, H, W))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = list(render_frames(params, state, cfg, poses, FOCAL, FOCAL, H, W,
                                H, W))
    frame_ms = (time.perf_counter() - t0) / len(poses) * 1e3
    th, tw = int(cfg.test.max_height), int(cfg.test.max_width)
    rayo, rayd = get_rays_np(H, W, FOCAL, FOCAL, poses[0][None])
    t0 = time.perf_counter()
    tiled = render_full_image(params, state, cfg, rayo, rayd, th, tw,
                              rgb_only=True, rgb_uint8=True)["rgb"][0]
    tiled_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {n: fn.launches for n, fn in kernels.items()}
    plain_calls = {n: fn.calls for n, fn in plains.items()}

    for i, fr in enumerate(warm + frames + [tiled]):
        if fr.shape != (H, W, 3) or fr.dtype != np.uint8:
            fail(f"frame {i}: {fr.shape} {fr.dtype}, want ({H}, {W}, 3) uint8")
        if int(fr.max()) == int(fr.min()):
            fail(f"frame {i} is constant ({int(fr.max())})")
    diff = np.abs(tiled.astype(np.int16) - frames[0].astype(np.int16))
    close = float((diff.max(-1) <= 2).mean())
    print(f"phase 3 render_frames {H}x{W} (one full-frame tile): first frame "
          f"{first_s:.2f} s, then {frame_ms:.1f} ms/frame over {len(poses)} "
          f"frames; render_full_image {th}x{tw} tiles: {tiled_ms:.1f} ms; "
          f"tiled vs full-tile pixels within 2/255: {close:.6f} (need >= "
          f"{TILED_MIN_CLOSE}), max diff {int(diff.max())}; peak device "
          f"memory {peak_gb:.2f} GiB", flush=True)
    print(f"phase 3 launches {launches}; plain-version calls {plain_calls}",
          flush=True)
    if close < TILED_MIN_CLOSE:
        fail("tiled render disagrees with the full-tile render")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran on the card's path: {plain_calls}")
    return {"launches": launches, "frame_ms": frame_ms,
            "tiled_ms": tiled_ms, "peak_gb": peak_gb}


def profile_frames(params, state, cfg, n: int = 3) -> None:
    """Device-time split of n serving frames (torch.profiler, CUPTI kernel
    times): each stage's ms per frame and share, and the device's idle share
    of the window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from papr_tpu_torch.train.step import render_frame

    stages = (("K3 attend_eval", "attend_eval"), ("K2 fused_mlp", "fused_mlp"),
              ("K1 cull", "cull_topk"), ("sort", "Sort"),
              ("conv (cuDNN)", "fprop"), ("gemm", "gemm"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            render_frame(params, state, cfg, orbit(2 * np.pi * i / n), FOCAL,
                         FOCAL, H, W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA})
    if not spans:
        print("phase 3 profile: not measured (the profiler saw no device "
              "events)", flush=True)
        return
    by, busy, end = {}, 0.0, spans[0][0]
    for s, e, name in spans:
        stage = next((k for k, pat in stages if pat in name), "other")
        by[stage] = by.get(stage, 0.0) + (e - s)
        busy += max(e - max(s, end), 0.0)
        end = max(end, e)
    idle = 1.0 - busy / (end - spans[0][0])
    total = sum(by.values())
    split = ", ".join(f"{k} {v / n / 1e3:.3f} ms ({100 * v / total:.1f} %)"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    print(f"phase 3 profile: {n} frames, {wall_ms:.1f} ms/frame under the "
          f"profiler; device idle share {idle:.4f}; per frame: {split}",
          flush=True)


def reference_check(device, side: int = 64) -> float:
    """A small frame through the kernel path (bf16) against the plain
    unfused fp32 path (tpu.fused_attn: false, use_amp: false) on the card,
    on the same weights: relative Frobenius error of the fused features
    (the attention output) and of the fp32 RGB."""
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_full_image

    cfg_k = flagship_cfg()
    cfg_ref = flagship_cfg(amp=False, fused_attn=False)
    params, state = build_model(cfg_k, device)
    focal = FOCAL * side / 800
    rayo, rayd = get_rays_np(side, side, focal, focal, orbit(0.7)[None])
    got = render_full_image(params, state, cfg_k, rayo, rayd, side, side,
                            with_extras=True)
    want = render_full_image(params, state, cfg_ref, rayo, rayd, side, side,
                             with_extras=True)
    rel = lambda a, b: float(np.linalg.norm(a - b)
                             / max(np.linalg.norm(b), 1e-30))
    err_f = rel(got["fused"], want["fused"])
    err_rgb = rel(got["rgb"], want["rgb"])
    ok = (np.isfinite(got["rgb"]).all() and np.isfinite(got["fused"]).all()
          and got["rgb"].shape == (1, side, side, 3))
    print(f"phase 3 reference: {side}x{side} frame, bf16 kernel path vs fp32 "
          f"plain path: fused features rel Frobenius {err_f:.3e}, rgb "
          f"{err_rgb:.3e} (need <= {REF_REL}); finite and shaped: {bool(ok)}",
          flush=True)
    if not (ok and err_f <= REF_REL and err_rgb <= REF_REL):
        fail("kernel path disagrees with the plain fp32 path")
    return err_f


def _snapshot(params, specs):
    from papr_tpu_torch.train.optim import tree_leaves
    return {k: [t.detach().clone() for t in tree_leaves(params[k])]
            for k in specs if k in params}


def drive_training(params, state, cfg, device) -> dict:
    """Phase 4: the training path on the 160x160 patch, counters reset just
    before the timed steps and read just after."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import (apply_updates, build_group_specs,
                                            tree_leaves)
    from papr_tpu_torch.train.points_host import add_points, prune_points
    from papr_tpu_torch.train.step import (loss_and_grads, make_opt_state,
                                           make_train_step)

    policy = policy_from_config(cfg)
    specs = build_group_specs(cfg)
    rayo, rayd = training_patch(device)
    gen = torch.Generator(device=device).manual_seed(4)
    target = torch.rand(1, PATCH, PATCH, 3, generator=gen, device=device)
    c2w = orbit(0.0)
    loss_fn = build_loss(cfg, policy, device=device)
    step_fn = make_train_step(cfg, loss_fn)
    opt = make_opt_state(cfg, params)

    # Warm-up step, spelled out to check the gradients themselves.
    t0 = time.perf_counter()
    loss, _, grads = loss_and_grads(params, state, cfg, rayo, rayd, target,
                                    c2w, loss_fn, specs, policy)
    apply_updates(params, grads, opt, specs, 1000)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    bad = [k for k in grads
           if not all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads[k]))]
    zero = [k for k in grads
            if max(float(g.abs().max()) for g in tree_leaves(grads[k])) == 0.0]
    if not bool(torch.isfinite(loss)) or bad or zero:
        fail(f"warm-up step: loss {float(loss)}, non-finite gradients {bad}, "
             f"all-zero gradients {zero}")
    del grads

    kernels, plains = counters(training=True)
    before = _snapshot(params, specs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels, plains)
    losses = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd,
                                          target, c2w, 1001 + i)
        losses.append(loss)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = {n: fn.launches for n, fn in kernels.items()}
    plain_calls = {n: fn.calls for n, fn in plains.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(l) for l in losses]
    moved = {k: any(not torch.equal(a, b) for a, b in
                    zip(before[k], tree_leaves(params[k]))) for k in before}
    rays_s = PATCH * PATCH / (step_ms / 1e3)
    print(f"phase 4 train {PATCH}x{PATCH} patch (T={PATCH * PATCH} rays, "
          f"k={cfg.geoms.points.select_k}): warm-up step {warm_s:.2f} s, then "
          f"{step_ms:.1f} ms/step over {TRAIN_STEPS} steps = {rays_s:.0f} "
          f"rays/s; peak device memory {peak_gb:.2f} GiB; losses "
          + ", ".join(f"{l:.6f}" for l in losses), flush=True)
    print(f"phase 4 launches {launches}; plain-version calls {plain_calls}; "
          f"groups moved {moved}", flush=True)
    if not all(np.isfinite(losses)) or pred.shape != (1, PATCH, PATCH, 3):
        fail(f"training step output: losses {losses}, pred {tuple(pred.shape)}")
    if not all(moved.values()):
        fail(f"a trained group did not change: {moved}")
    if any(v != TRAIN_STEPS for v in launches.values()):
        fail(f"a training kernel did not launch once per step: {launches}")
    if max(plain_calls.values()) != 0:
        fail(f"a plain version ran on the training path: {plain_calls}")

    profile_train_step(step_fn, params, opt, state, cfg, rayo, rayd, target,
                       c2w, loss_fn, policy)

    # Prune + grow, fresh optimizer state, one more step.
    params, state, n_pr = prune_points(params, state, 0.0)
    params, state, n_add = add_points(params, state, cfg,
                                      int(cfg.training.add_num),
                                      np.random.default_rng(0))
    opt = make_opt_state(cfg, params)
    reset_counters(kernels, plains)
    params, opt, loss, pred = step_fn(params, opt, state, rayo, rayd, target,
                                      c2w, 2000)
    torch.cuda.synchronize()
    launched = {n: fn.launches for n, fn in kernels.items()}
    n_alive = int(state["alive"].sum())
    print(f"phase 4 prune {n_pr} + grow {n_add} points ({n_alive} alive), "
          f"fresh optimizer state: step loss {float(loss):.6f}; launches "
          f"{launched}", flush=True)
    if not (np.isfinite(float(loss)) and n_pr > 0 and n_add > 0
            and min(launched.values()) == 1
            and all(st["t"] == 1 for st in opt.values())):
        fail("the step after prune / grow failed")
    return {"launches": launches, "step_ms": step_ms, "rays_s": rays_s,
            "peak_gb": peak_gb}


def device_profile(fn):
    """One call of fn under torch.profiler (CUPTI kernel times): returns
    (host wall ms, device idle share of the window, kernel spans as
    (start, end, name)); no spans when the profiler saw no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted({(e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events() if e.device_type == DeviceType.CUDA})
    if not spans:
        return wall_ms, float("nan"), spans
    busy, end = 0.0, spans[0][0]
    for s0, e0, _ in spans:
        busy += max(e0 - max(s0, end), 0.0)
        end = max(end, e0)
    return wall_ms, 1.0 - busy / (end - spans[0][0]), spans


def profile_train_step(step_fn, params, opt, state, cfg, rayo, rayd, target,
                       c2w, loss_fn, policy) -> None:
    """Device-time split of one training step by stage (kernel names), the
    device's idle share, and the UNet, LPIPS and optimizer stages run alone
    (their convolution and elementwise kernels carry no stage in their
    names): device kernel time and host wall each."""
    import torch
    from papr_tpu_torch.model.papr import render_foreground
    from papr_tpu_torch.train.optim import (apply_updates, build_group_specs,
                                            init_opt_state, tree_map)

    stages = (("selection (cull kernel)", "cull_topk"),
              ("query embedder fwd", "fused_mlp_fwd_kernel"),
              ("query embedder bwd", "fused_mlp_bwd_kernel"),
              ("key stream fwd", "key_fwd_kernel"),
              ("key stream bwd", "key_bwd_kernel"),
              ("value stream fwd", "value_fwd_kernel"),
              ("value stream bwd", "value_bwd_kernel"),
              ("dW reduction (wgrad)", "wgrad_kernel"),
              ("dW reduction (wgrad)", "colsum_kernel"),
              ("selection (prefilter sort / top-k)", "ort"),
              ("selection (prefilter sort / top-k)", "topk"),
              ("convolutions (UNet + LPIPS)", "conv"),
              ("convolutions (UNet + LPIPS)", "xmma"),
              ("convolutions (UNet + LPIPS)", "cudnn"),
              ("gemm", "gemm"))
    wall_ms, idle, spans = device_profile(
        lambda: step_fn(params, opt, state, rayo, rayd, target, c2w, 1500))
    if not spans:
        print("phase 4 profile: not measured (the profiler saw no device "
              "events)", flush=True)
        return
    by = {}
    for s0, e0, name in spans:
        stage = next((k for k, pat in stages if pat in name),
                     "other (gather / scatter, elementwise, UNet / LPIPS "
                     "non-conv, optimizer)")
        by[stage] = by.get(stage, 0.0) + (e0 - s0)
    total = sum(by.values())
    split = ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / total:.1f} %)"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    print(f"phase 4 profile: one step, {wall_ms:.1f} ms under the profiler; "
          f"device idle share {idle:.4f}; kernel time {total / 1e3:.3f} ms: "
          f"{split}", flush=True)

    feats = torch.randn(1, PATCH, PATCH,
                        int(cfg.models.attn.embed.value.d_ff_out),
                        device=rayd.device, requires_grad=True)
    pred = torch.rand(1, PATCH, PATCH, 3, device=rayd.device)
    rp = tree_map(lambda t: t.detach().requires_grad_(True),
                  params["renderer"])

    def unet():
        render_foreground({"renderer": rp}, cfg, feats,
                          policy=policy).sum().backward()

    def lpips():
        loss_fn(pred.detach().requires_grad_(True), target).backward()

    specs = build_group_specs(cfg)
    grads = tree_map(torch.ones_like, {k: params[k] for k in specs
                                       if k in params})
    scratch = {k: tree_map(torch.clone, params[k]) for k in grads}
    st = init_opt_state(scratch, specs)
    adam = lambda: apply_updates(scratch, grads, st, specs, 1000)
    parts = []
    for name, fn in (("UNet fwd + bwd", unet), ("MSE + LPIPS fwd + bwd", lpips),
                     ("Adam update", adam)):
        fn()
        w_ms, _, sp = device_profile(fn)
        dev_ms = sum(e0 - s0 for s0, e0, _ in sp) / 1e3
        parts.append(f"{name} {dev_ms:.3f} ms device ({w_ms:.3f} ms host)")
    print("phase 4 stages alone: " + ", ".join(parts), flush=True)


def train_reference_check(device, side: int = 32) -> None:
    """One training step's loss and gradients at a 32x32 patch, flagship
    widths: the bf16 kernel path against the plain fp32 path
    (tpu.fused_attn: false, use_amp: false) on the same weights."""
    import torch
    from papr_tpu_torch.nn.mlp import policy_from_config
    from papr_tpu_torch.train.losses import build_loss
    from papr_tpu_torch.train.optim import build_group_specs, tree_leaves
    from papr_tpu_torch.train.step import loss_and_grads

    rayo, rayd = training_patch(device, seed=1)
    rayd = rayd[:, :side, :side].contiguous()
    gen = torch.Generator(device=device).manual_seed(5)
    target = torch.rand(1, side, side, 3, generator=gen, device=device)
    res = {}
    for name, cfg in (("kernel", flagship_cfg()),
                      ("plain", flagship_cfg(amp=False, fused_attn=False))):
        params, state = build_model(cfg, device)
        policy = policy_from_config(cfg)
        loss, _, grads = loss_and_grads(
            params, state, cfg, rayo, rayd, target, orbit(0.0),
            build_loss(cfg, policy, device=device), build_group_specs(cfg),
            policy)
        res[name] = (float(loss), {k: torch.cat([g.float().reshape(-1) for g
                                                 in tree_leaves(v)])
                                   for k, v in grads.items()})
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    loss_rel = abs(lk - lp) / max(abs(lp), 1e-30)
    errs = {k: rel_fro(gk[k], gp[k]) for k in gp}
    finite = np.isfinite(lk) and all(bool(torch.isfinite(g).all())
                                     for g in gk.values())
    print(f"phase 4 reference: {side}x{side} patch, one step, bf16 kernel path "
          f"vs fp32 plain path: loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.3e}, "
          f"need <= {TRAIN_REF_LOSS_REL}); gradient rel Frobenius "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (need <= {TRAIN_REF_GRAD_REL}); finite {finite}", flush=True)
    if not (finite and loss_rel <= TRAIN_REF_LOSS_REL
            and max(errs.values()) <= TRAIN_REF_GRAD_REL):
        fail("the training step's kernel path disagrees with the plain path")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "GPU only", file=sys.stderr)
        raise SystemExit(1)
    from papr_tpu_torch.kernels import build   # fails outside the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 0 card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.load()
    with open(build.library_path()[:-3] + ".log") as f:
        ptxas = [l.strip() for l in f if "registers" in l or "spill" in l]
    print(f"phase 1 kernels built and loaded in {time.perf_counter() - t0:.1f}"
          f" s ({build.library_path()})", flush=True)
    for line in ptxas:
        print(f"phase 1 ptxas: {line}", flush=True)

    cfg = flagship_cfg()
    params, state = build_model(cfg, device)
    results = compare_kernels(params, state, cfg, device)
    train_results = compare_train_kernels(params, state, cfg, device)
    results[0].update(train_results.pop("cull_select"))
    results += list(train_results.values())
    run = drive_main_path(params, state, cfg, device)
    profile_frames(params, state, cfg)
    reference_check(device)
    train = drive_training(params, state, cfg, device)
    train_reference_check(device)

    for r in results:
        r["launches"] = (run["launches"].get(r["name"], 0)
                         + train["launches"].get(r["name"], 0))
    print(json.dumps({"kernels": results}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
