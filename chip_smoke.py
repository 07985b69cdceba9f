#!/usr/bin/env python3
"""Drive the PyTorch port's render path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

0. Require CUDA; print the card's name and power limit (nvidia-smi).
1. Build the CUDA kernels from ``papr_tpu_torch/csrc`` (nvcc, sm_90a).
2. Hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes (the flagship model: 30k-point cube init, k = 20,
   bf16; the orbit pose of ``bench.py`` with focal 700 at 800x800):
   cull selection on the full frame, the query embedder on its 640,000
   rays, the eval attention on a 160x160 ray block. Print errors and times.
3. Render 1 + 3 orbit frames at 800x800 through ``render_frames`` (one
   full-frame tile) and one frame through ``render_full_image`` with the
   config's 100x100 test tiles; check the frames, that every kernel of the
   path launched and that no plain version ran; profile 3 more frames for
   the device-time split by stage; then hold a small frame of the kernel
   path against the plain fp32 path on the card.
4. Print the kernels' JSON line, then the result line.

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

H = W = 800
FOCAL = 700.0
BLOCK = 160               # eval-attention comparison block (160x160 rays)


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
    from papr_tpu_torch.ops.fused_mlp import posenc_plan, walk_from_params
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
    _, qcols = posenc_plan((3,), tuple(int(l) for l in e.q_L),
                           int(e.embed_type), float(e.pe_factor),
                           float(e.pe_mult_factor), 0)
    qwalk = walk_from_params(params["attn"]["embed_q"], e.query, qcols)
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


def counters():
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import tile_cull as tc
    kernels = {"cull_select": tc.cull_select, "fused_mlp": fm.fused_mlp,
               "attend_stream_eval": sa.attend_eval_idx}
    plains = {"cull_select": tc.cull_select_plain,
              "fused_mlp": fm.fused_mlp_plain,
              "attend_stream_eval": sa.attend_eval_plain}
    return kernels, plains


def drive_main_path(params, state, cfg, device) -> dict:
    """Phase 3: the serving path, counters reset just before it."""
    import torch
    from papr_tpu_torch.ops.geometry import get_rays_np
    from papr_tpu_torch.train.step import render_frames, render_full_image

    kernels, plains = counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains.values():
        fn.calls = 0

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
    run = drive_main_path(params, state, cfg, device)
    profile_frames(params, state, cfg)
    reference_check(device)

    for r in results:
        r["launches"] = run["launches"][r["name"]]
    print(json.dumps({"kernels": results}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
