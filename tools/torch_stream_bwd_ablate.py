"""Where the stream backwards spend their time: the key and value stream
backwards (``csrc/key_stream.cu`` / ``csrc/value_stream.cu``,
``papr_key_stream_bwd`` / ``papr_value_stream_bwd``) timed whole and with
one part taken out at a time, and the whole wrapper call split into the
kernel alone, the dW reduction (``wgrad`` + ``colsum``), the other device
kernels (packs, zero fills, the combine kernel) and the host, on phase 2's
shapes (T = 25,600 rays, K = 20, 30,000 points, the flagship's walks with
random weights). With ``--f32`` the fp32 backwards (``use_amp: false``,
``papr_key_stream_f32_bwd`` / ``papr_value_stream_f32_bwd``) at phase 8's
shapes: Caterpillar's 180 x 180 patch (T = 32,400, K = 20, 5,000 points)
and Caterpillar's walks (key posenc orders 4, 4, 4; value 4, 4 and 64 point
features) with random weights.

    python tools/torch_stream_bwd_ablate.py [--f32] [--tree DIR] [--split-only]
    python tools/torch_stream_bwd_ablate.py --fold [--f32] [--tree DIR]

With ``--fold`` the folded key stream's backward (``tpu.query_fold``,
``csrc/key_stream_q.cu``: ``papr_key_stream_q_bwd``, with ``--f32``
``papr_key_stream_q_f32_bwd``) at the same shapes with the query walk
(posenc of the raw ray direction, 5 x 256 with LayerNorms, ``w_q``), timed
whole and split only: the kernels alone (the WMMA ``keyq_bwd_kernel`` of an
earlier tree, or the key's ``key_bwd_wgmma_f32_kernel`` and the query's
``query_head_bwd_wgmma_f32_kernel``), the dW reduction, the other device
kernels and the host; no variants.

``--tree`` takes the sources and the package from another checkout (for
example an unpacked parent commit); the variants follow that tree's design
(bf16: ``WGMMA`` where ``csrc/walk_wgmma_bwd.cuh`` exists, else ``WMMA``;
fp32: ``WGMMA_F32`` where that header has the fp32 form (``StreamBwdWgT``), else
``WMMA_F32``, the WMMA kernels of ``walk_bwd.cuh``). Each
variant is a copy of the CUDA sources with lines replaced, built alone
(``key_stream.cu``, ``value_stream.cu``, ``wgrad.cu``) and loaded in place of
the library; the wrapper and its inputs are the same for all. A variant
computes the wrong function (its error against the sound build is printed):
it is a timing probe, not a kernel. Prints one line a variant: the kernel
alone (its ``torch.profiler`` span, 3 calls after a warm-up), the whole
call (CUDA events), the error, and ptxas's spill lines.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The parent's WMMA design (walk_bwd.cuh / walk.cuh / stream_common.cuh on
# 512-thread blocks of 64 rays).
_REC = "    dense_layer(s.A[cur], s.C, last ? nullptr : s.A[cur ^ 1], s.W, d.w[l],"
_HEAD_F = "  dense_layer(S.A[0], C, nullptr, S.W, wkf, nullptr, pdn, dm_pad, 0);"
_REV = "    dense_layer(s.A[0], s.C, nullptr, s.W, b.wt[l], nullptr, po, d.pd[l], 0);"
_HEAD_B = "  dense_layer(S.A[1], C, nullptr, S.W, wkb, nullptr, dm_pad, pdn, 0);"
_COLSUM = ("                                           float* part) {\n"
           "  for (int c = threadIdx.x; c < pd; c += kThreads) {")
_LNB = ("                                       float* part_a, float* part_b) {\n"
        "  for (int c = threadIdx.x; c < n_true; c += kThreads) {")
_STASH = ("  constexpr int kV = 16 / sizeof(T);\n"
          "  const int vpr = pd / kV;\n"
          "  for (int v = threadIdx.x; v < kRows * vpr; v += kThreads) {")
_SAVE = ("__device__ __forceinline__ void save_c(const float* C, float* dst, int pd) {\n"
         "  for (int i = threadIdx.x; i < kRows * pd; i += kThreads) {")
_SUMS = ("                                               int nsrc, Sink sink) {\n"
         "  for (int i = threadIdx.x; i < kRows * nsrc; i += kThreads) {")
_GEOM = ("                                             float* dsel, float* drays) {\n"
         "  float v[3];")
_BODY = lambda old, guard: old.replace("{\n", "{\n" + guard + "\n", 1)
WMMA = [
    ("whole kernel", []),
    ("no recompute products (walk + w_k)",
     [("walk_bwd.cuh", _REC, "    if (l < 0)" + _REC[3:]),
      ("stream_common.cuh", _HEAD_F, "  if (pdn < 0)" + _HEAD_F[1:])]),
    ("no reverse-walk products (dX + w_k^T)",
     [("walk_bwd.cuh", _REV, "    if (l < 0)" + _REV[3:]),
      ("stream_common.cuh", _HEAD_B, "  if (pdn < 0)" + _HEAD_B[1:])]),
    ("no weight staging waits",
     [("walk.cuh", "      cp_async_wait<1>();\n    } else {\n"
       "      cp_async_wait<0>();\n", "    } else {\n")]),
    ("no colsum_add / ln_bwd",
     [("walk_bwd.cuh", _COLSUM, _BODY(_COLSUM, "  if (pd > 0) return;")),
      ("walk_bwd.cuh", _LNB, _BODY(_LNB, "  if (pd > 0) return;"))]),
    ("no stash / scratch writes",
     [("walk_bwd.cuh", _STASH, _BODY(_STASH, "  if (pd > 0) return;")),
      ("walk_bwd.cuh", _SAVE, _BODY(_SAVE, "  if (pd > 0) return;")),
      ("walk_bwd.cuh", "      store8(b.dz[l] + (x.row0 + r) * po + c8, h);\n",
       ""),
      ("stream_common.cuh",
       "    kb.dz[n][(ctx.row0 + r) * dm_pad + c] = h;\n", "")]),
    ("no relu-mask read-back",
     [("walk_bwd.cuh",
       "      if (act == 1 && hnext) load8(hnext + (x.row0 + r) * po + c8, hn);",
       "      if (act == 1 && hnext)\n"
       "        for (int e = 0; e < 8; ++e) hn[e] = 1.f;")]),
    ("no pe_bwd_deriv sincosf",
     [("walk_bwd.cuh", "      sincosf(src_val(r, src) * freq, &sv, &cv);",
       "      sv = src_val(r, src) * freq;\n      cv = sv;")]),
    ("no pe_source_sums / geometry backward",
     [("walk_bwd.cuh", _SUMS, _BODY(_SUMS, "  if (nsrc > 0) return;")),
      ("walk_bwd.cuh", _GEOM,
       _BODY(_GEOM, "  for (int j = 0; j < 3; ++j) dsel[j] = drays[j] = 0.f;\n"
             "  if (eps > -1.f) return;"))]),
]
# The fp32 backwards on the same WMMA walk (walk_bwd.cuh with float
# operands, 3xTF32 m16n16k8): the parts the fp32 redesign has to move.
_NO_REC = [("walk_bwd.cuh", _REC, "    if (l < 0)" + _REC[3:]),
           ("stream_common.cuh", _HEAD_F, "  if (pdn < 0)" + _HEAD_F[1:])]
_NO_REV = [("walk_bwd.cuh", _REV, "    if (l < 0)" + _REV[3:]),
           ("stream_common.cuh", _HEAD_B, "  if (pdn < 0)" + _HEAD_B[1:])]
WMMA_F32 = [
    ("fp32 WMMA: whole kernel", []),
    ("fp32 WMMA: no products", _NO_REC + _NO_REV),
    ("fp32 WMMA: no weight staging waits", WMMA[3][1]),
    ("fp32 WMMA: no stash / scratch stores", WMMA[5][1]),
    ("fp32 WMMA: no LayerNorm backwards",
     [("walk_bwd.cuh", _LNB, _BODY(_LNB, "  if (pd > 0) return;"))]),
    ("fp32 WMMA: no column sums",
     [("walk_bwd.cuh", _COLSUM, _BODY(_COLSUM, "  if (pd > 0) return;"))]),
    ("fp32 WMMA: no posenc / geometry backward",
     WMMA[7][1] + WMMA[8][1]),
]
# This PR's wgmma design (walk_wgmma_bwd.cuh on walk_wgmma.cuh's layers).
_MMA = "      wgmma_rs_bf16_n128(acc, A[4 * kb], A[4 * kb + 1], A[4 * kb + 2],"
_WAIT = "    if (real) mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);"
_REFILL = "    if (j + ring.stages < ring.total) wg_issue(ring, j + ring.stages);"
_SW = ("                                        int pd, int c0) {\n"
       "  const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;")
_SR = ("                                           int pd, int row0) {\n"
       "  const int lane = threadIdx.x & 31, upr = pd / 8;")
_CS = ("__device__ __forceinline__ void colsum_pass(Val val, float* dst, int ncol) {\n"
       "  const int lane = threadIdx.x & 31, q = lane & 3;")
_LB = ("                                           float* part_b) {\n"
       "  const int t = threadIdx.x & 127, q = t & 3;")
_ROWS = ("  for (int r = row0; r < row0 + 16; ++r) {\n"
         "    float* row = E + r * ld;\n    const float* x = enc_s")
WGMMA = [
    ("wgmma: whole kernel", []),
    ("wgmma: no products", [("walk_wgmma.cuh", _MMA,
                             "      if (kb < 0) " + _MMA[6:])]),
    ("wgmma: no waits for weights", [("walk_wgmma.cuh", _WAIT, ""),
                                     ("walk_wgmma.cuh", _REFILL, "")]),
    ("wgmma: no products, no waits",
     [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:]),
      ("walk_wgmma.cuh", _WAIT, ""), ("walk_wgmma.cuh", _REFILL, "")]),
    ("wgmma: no stash writes",
     [("walk_wgmma_bwd.cuh", _SW, _BODY(_SW, "  if (pd > 0) return;")),
      ("walk_wgmma_bwd.cuh", _SR, _BODY(_SR, "  if (pd > 0) return;"))]),
    ("wgmma: no column sums",
     [("walk_wgmma_bwd.cuh", _CS, _BODY(_CS, "  if (ncol > -1000) return;"))]),
    ("wgmma: no output LayerNorm backward",
     [("walk_wgmma_bwd.cuh", _LB, _BODY(_LB, "  if (n_true > 0) return;"))]),
    ("wgmma: no posenc sin / cos",
     [("walk.cuh", "  sincosf(x * freq, &s, &c);", "  s = x * freq;\n  c = s;")]),
    ("wgmma: no per-warp tail (input LayerNorm bwd, posenc derivative, "
     "source sums)",
     [("walk_wgmma_bwd.cuh", _ROWS,
       "  for (int r = row0; r < row0 + 16 && d.n < 0; ++r) {\n"
       "    float* row = E + r * ld;\n    const float* x = enc_s")]),
]
# The fp32 backwards on wgmma (the same walk in walk_wgmma.cuh's fp32
# operand form: 3xTF32 m64n64k8, the layer inputs fp32 in shared memory).
_F32_MMA = ("          const int kk = 2 * (sub * kF32Sub + s);     // 32 bytes "
            "a k8 step\n")
_F32_NO_MMA = [("walk_wgmma.cuh", _F32_MMA,
                _F32_MMA + "          if (kk >= 0) continue;\n")]
_F32_NO_WAIT = [("walk_wgmma.cuh", "          mbar_wait(&ring.full[st], "
                 "(ring.i / ring.stages) & 1);\n", ""),
                ("walk_wgmma.cuh", _REFILL, "")]
_SF = ("                                               int row0) {\n"
       "  const int lane = threadIdx.x & 31, upr = pd / 4;")
WGMMA_F32 = [
    ("fp32 wgmma: whole kernel", []),
    ("fp32 wgmma: no products", _F32_NO_MMA),
    ("fp32 wgmma: no waits for weights", _F32_NO_WAIT),
    ("fp32 wgmma: no products, no waits", _F32_NO_MMA + _F32_NO_WAIT),
    ("fp32 wgmma: no stash stores",
     [("walk_wgmma_bwd.cuh", _SF, _BODY(_SF, "  if (pd > 0) return;"))]),
    ("fp32 wgmma: no column sums",
     [("walk_wgmma_bwd.cuh", _CS, _BODY(_CS, "  if (ncol > -1000) return;"))]),
    ("fp32 wgmma: no output LayerNorm backward",
     [("walk_wgmma_bwd.cuh", _LB, _BODY(_LB, "  if (n_true > 0) return;"))]),
    ("fp32 wgmma: no posenc / geometry backward (the per-warp tail)",
     [("walk_wgmma_bwd.cuh", _ROWS,
       "  for (int r = row0; r < row0 + 16 && d.n < 0; ++r) {\n"
       "    float* row = E + r * ld;\n    const float* x = enc_s")]),
]


def _walk(rng, cols, n, d_ff, d_out, norm, dev):
    import math
    import torch
    from papr_tpu_torch.ops.fused_mlp import Walk
    dims = [len(cols)] + [d_ff] * (n - 1) + [d_out]
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)
    ws = tuple(t(rng.normal(size=(dims[i], dims[i + 1])) / math.sqrt(dims[i]))
               for i in range(n))
    bs = tuple(t(rng.normal(size=dims[i + 1]) * 0.1) for i in range(n))
    ln = (t(1 + 0.2 * rng.normal(size=dims[0])),
          t(0.1 * rng.normal(size=dims[0])))
    lo = (t(1 + 0.2 * rng.normal(size=d_out)), t(0.1 * rng.normal(size=d_out)))
    return Walk(ws, bs, ln if norm else None, lo if norm else None, "relu",
                "none", tuple(cols))


def inputs(dev, f32=False, seed=2):
    """The two backwards' arguments: (key args, value args), each ending in
    the compute options; bf16 on phase 2's shapes and the flagship's walks,
    fp32 (``f32``) on phase 8's and Caterpillar's walks."""
    import torch
    from papr_tpu_torch.ops import stream_attn as sa
    T, P, L = (32_400, 5_000, 4) if f32 else (25_600, 30_000, 6)
    K, dm = 20, 256
    rng = np.random.default_rng(seed)
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    idx = torch.as_tensor(rng.integers(0, P, size=(K, T)), device=dev)
    rec = t(record)[idx].contiguous()                     # (K, T, 128)
    rays = rng.normal(size=(T, 3))
    rayo = t(np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3)))
    rays = t(rays / np.linalg.norm(rays, axis=-1, keepdims=True))
    qq = t(rng.normal(size=(T, dm)))
    kwalk = _walk(rng, sa.rec_pe_plan(True, (L, L, L), 1, 2.0, 1.0, 0), 5,
                  256, 256, True, dev)
    wk, bk = t(rng.normal(size=(dm, 256)) / 16), t(rng.normal(size=dm) * 0.1)
    vwalk = _walk(rng, sa.rec_pe_plan(False, (L, L), 1, 2.0, 1.0, 64), 8, 256,
                  32, False, dev)
    cdt = torch.float32 if f32 else torch.bfloat16
    attn, raw, ss = sa.key_stream_fwd(rec, rayo, rays, qq, kwalk, wk, bk,
                                      "relu", 5.0, 1e-6, cdt)
    dattn = t(rng.normal(size=(T, K + 1)))
    dfused = t(rng.normal(size=(T, 32)))
    key = (rec, rayo, rays, qq, kwalk, wk, bk, raw, ss, dattn, "relu", 5.0,
           1e-6, cdt)
    value = (rec, rayo, rays, attn, vwalk, dfused, True, 1e-6, cdt)
    return key, value


def fold_inputs(dev, f32=False, seed=2):
    """The folded key stream's arguments at ``inputs``' shapes: (rec, rayo,
    rays, rayd, the key walk, w_k, b_k, the query walk (posenc of the raw
    ray direction, orders 4 fp32 / 6 bf16, 5 x 256 with LayerNorms), w_q,
    b_q), the compute options, the forward's (qq, raw, ss) and a dattn."""
    import torch
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    key, _ = inputs(dev, f32, seed)
    rec, rayo, rays, _, kwalk, wk, bk = key[:7]
    T, L = rec.shape[1], 4 if f32 else 6
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rayd = rays * t(rng.uniform(0.5, 2.0, size=(T, 1)))
    qwalk = _walk(rng, posenc_plan((3,), (L,), 1, 2.0, 1.0, 0)[1], 5, 256,
                  256, True, dev)
    wq, bq = t(rng.normal(size=(256, 256)) / 16), t(rng.normal(size=256) * 0.1)
    args = (rec, rayo, rays, rayd, kwalk, wk, bk, qwalk, wq, bq)
    opts = ("relu", 5.0, 1e-6, torch.float32 if f32 else torch.bfloat16)
    _, raw, ss, qq = sa.key_stream_q_fwd(*args, *opts)
    return args, opts, (qq, raw, ss), key[9]


def _split(fn, name, n: int = 3):
    """(kernel alone: the kernels whose name holds name, or one of a tuple
    of names; wgrad + colsum; other device kernels) ms per call from the
    profiler, and the whole call's ms from CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = red = other = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        pats = (name,) if isinstance(name, str) else name
        if any(p in e.name for p in pats) and "combine" not in e.name:
            kern += us
        elif "wgrad" in e.name or "colsum" in e.name:
            red += us
        else:
            other += us
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return kern / n / 1e3, red / n / 1e3, other / n / 1e3, \
        a.elapsed_time(b) / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--split-only", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--fold", action="store_true")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import stream_attn as sa

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    form = "fp32" if opt.f32 else "bf16"
    if opt.fold:
        args, opts, saved, dattn = fold_inputs(dev, opt.f32)
        fn = lambda: sa.key_stream_q_bwd(*args, *saved, dattn, *opts)
        for _ in range(2):
            k_ms, r_ms, o_ms, whole = _split(
                fn, ("keyq_bwd", "key_bwd_wgmma", "query_head_bwd"))
            print(f"{form} folded key stream backward, whole call "
                  f"{whole:.3f} ms: kernels alone {k_ms:.3f}, wgrad + colsum "
                  f"{r_ms:.3f}, other device kernels {o_ms:.3f}, host / gaps "
                  f"{whole - k_ms - r_ms - o_ms:.3f}", flush=True)
        return
    key, value = inputs(dev, opt.f32)
    cases = (("key", "key_bwd", lambda: sa.key_stream_bwd(*key)),
             ("value", "value_bwd", lambda: sa.value_stream_bwd(*value)))
    sound = {}
    for what, pat, fn in cases:
        sound[what] = [g.clone() for g in fn()]
        k_ms, r_ms, o_ms, whole = _split(fn, pat)
        print(f"{form} {what} stream backward, whole call {whole:.3f} ms: kernel "
              f"alone {k_ms:.3f}, wgrad + colsum {r_ms:.3f}, other device "
              f"kernels {o_ms:.3f}, host / gaps "
              f"{whole - k_ms - r_ms - o_ms:.3f}", flush=True)
    if opt.split_only:
        return
    csrc = os.path.join(tree, "papr_tpu_torch", "csrc")
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="stream_bwd_ablate_")
    wg_obj = os.path.join(root, "wgrad.o")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", wg_obj,
                    os.path.join(csrc, "wgrad.cu")], check=True,
                   capture_output=True)
    # The tree's design: the wgmma backwards where their header has them.
    hdr = os.path.join(csrc, "walk_wgmma_bwd.cuh")
    hdr = open(hdr).read() if os.path.exists(hdr) else ""
    if opt.f32:
        variants = WGMMA_F32 if "StreamBwdWgT" in hdr else WMMA_F32
    else:
        variants = WGMMA if hdr else WMMA
    procs, runs = {}, []
    for i, (name, subs) in enumerate(variants):
        src = os.path.join(root, str(i))
        shutil.copytree(csrc, src)
        missing = False
        for f, old, new in subs:
            p = os.path.join(src, f)
            s = open(p).read()
            if old not in s:
                missing = True
                break
            open(p, "w").write(s.replace(old, new))
        if missing:
            print(f"{name}: skipped (its lines are not in this tree's "
                  f"sources)", flush=True)
            continue
        runs.append((i, name))
        for cu in ("key_stream", "value_stream"):
            procs[(i, cu)] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-c", "-o",
                 os.path.join(root, f"{i}.{cu}.o"),
                 os.path.join(src, cu + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for i, name in runs:
        if any(procs[(i, cu)].returncode for cu in ("key_stream",
                                                    "value_stream")):
            print(f"{name}: build failed\n"
                  + "\n".join(logs[(i, cu)][-3000:] for cu in
                              ("key_stream", "value_stream")))
            continue
        so = os.path.join(root, f"{i}.so")
        subprocess.run([nvcc, "-shared", "-o", so, wg_obj,
                        os.path.join(root, f"{i}.key_stream.o"),
                        os.path.join(root, f"{i}.value_stream.o")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fname in ("papr_key_stream_bwd", "papr_value_stream_bwd",
                      "papr_key_stream_f32_bwd", "papr_value_stream_f32_bwd",
                      "papr_wgrad", "papr_wgrad_f32", "papr_colsum"):
            getattr(lib, fname).argtypes = build.SIGNATURES[fname]
            getattr(lib, fname).restype = ctypes.c_int
        build._lib = lib           # the wrappers load this build
        parts = []
        for what, pat, fn in cases:
            got = fn()
            err = max(float((g - w).norm() / max(float(w.norm()), 1e-30))
                      for g, w in zip(got, sound[what]))
            k_ms, _, _, whole = _split(fn, pat)
            parts.append(f"{what} kernel {k_ms:.3f} ms (call {whole:.3f}), "
                         f"max rel {err:.1e}")
        spills = [l.strip() for cu in ("key_stream", "value_stream")
                  for l in logs[(i, cu)].splitlines()
                  if "spill" in l and " 0 bytes spill" not in l]
        print(f"{name}: " + "; ".join(parts)
              + (f"; ptxas: {' | '.join(spills)}" if spills else ""),
              flush=True)
    build._lib = None
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
