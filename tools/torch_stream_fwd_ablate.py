"""Where the stream forwards spend their time: the key and value stream
forwards (``csrc/key_stream.cu`` / ``csrc/value_stream.cu``,
``papr_key_stream_fwd`` / ``papr_value_stream_fwd``) timed whole, on both
grids where the tree has the persistent one, and with one part taken out at
a time, on phase 2's shapes (T = 25,600 rays, K = 20, 30,000 points, the
flagship's walks with random weights; the inputs of
``tools/torch_stream_bwd_ablate.py``). With ``--f32`` the fp32 forwards
(``use_amp: false``, ``papr_key_stream_f32_fwd`` /
``papr_value_stream_f32_fwd``) at phase 8's shapes: Caterpillar's 180 x 180
patch (T = 32,400, K = 20, 5,000 points) and Caterpillar's walks with
random weights. With ``--feat`` the feature streams of ``fused_attn:
stream`` instead (``ops/stream_feat.py``: ``csrc/key_stream_feat.cu`` /
``csrc/value_stream_feat.cu``), on raw features at the same shapes (xk (K,
T, 9), xv (K, T, 70), influence, alive, the same walks on ``posenc_plan``'s
columns): their forwards, and, timed whole only, their backwards.

    python tools/torch_stream_fwd_ablate.py [--f32] [--feat] [--tree DIR]
                                            [--split-only]
    python tools/torch_stream_fwd_ablate.py --fold [--f32] [--tree DIR]
    python tools/torch_stream_fwd_ablate.py --scores [--tree DIR]

With ``--scores`` the fp32 fused scores' forward (``tpu.fused_attn: true |
score`` with ``use_amp: false``, ``csrc/fused_attn.cu``:
``papr_fused_scores_f32_fwd``) at phase 8's shapes (embedk (20, 32,400,
256), embedq (32,400, 256), d_model 256, random fp32 values, alive 80 %),
called as the model calls it (no raw dots), timed whole and split only:
the kernels alone (the WMMA ``fused_scores_fwd_kernel`` of an earlier tree,
or the query head ``fused_scores_query_wgmma_f32_kernel``, the key head
``fused_scores_fwd_wgmma_f32_kernel`` and the softmax kernel), each
kernel's span; no variants.

With ``--fold`` the folded key stream's forward (``tpu.query_fold``,
``csrc/key_stream_q.cu``: ``papr_key_stream_q_fwd``, with ``--f32``
``papr_key_stream_q_f32_fwd``) on ``torch_stream_bwd_ablate.fold_inputs``
(the record forwards' shapes and the query walk), timed whole and split
only: the kernels alone (the WMMA ``keyq_fwd_kernel`` of an earlier tree,
or the query's ``query_head_fwd_wgmma_kernel`` /
``query_head_fwd_wgmma_f32_kernel``, the key's ``key_fwd_wgmma_kernel`` /
``key_fwd_wgmma_f32_kernel`` and the softmax kernel), each kernel's span;
no variants. ``--feat`` without ``--f32`` times the bf16 feature forwards
whole and split (the value's on wgmma, ``value_feat_fwd_wgmma_kernel``, or
the WMMA ``valuef_fwd_kernel`` of an earlier tree; the key's WMMA
``keyf_fwd_kernel``); no variants.

``--tree`` takes the sources and the package from another checkout (for
example an unpacked parent commit); the variants follow that tree's design
(bf16: the wgmma forwards' parts; fp32: ``WGMMA_F32`` where
``key_stream.cu`` has ``key_fwd_wgmma_f32_kernel``, else ``WMMA_F32``, the
WMMA kernels of ``walk.cuh``, whose key takes its softmax inside the
kernel; with ``--feat --f32`` the ``WGMMA_F32`` variants and
``FEAT_F32``'s where ``key_stream_feat.cu`` has
``key_feat_fwd_wgmma_f32_kernel``, else none: the WMMA feature forwards
are timed whole). Each variant is a copy of the CUDA sources with lines
replaced (every occurrence), built alone (``key_stream.cu``,
``value_stream.cu``, ``wgrad.cu``; with ``--feat`` ``key_stream_feat.cu``,
``value_stream_feat.cu`` and the sound ``key_stream.cu`` and ``wgrad.cu``)
and loaded in place of the library; the wrapper and its inputs are the
same for all. A variant computes the wrong function (its
error against the sound build is printed): it is a timing probe, not a
kernel. Prints one line a variant: the kernel alone (its
``torch.profiler`` span: the walk kernel and, for the key on wgmma, the
softmax kernel after it; 3 calls after a warm-up), the whole call (CUDA
events), the error, and ptxas's spill lines; the sound build's whole call
is split into each device kernel's span and the host.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from torch_stream_bwd_ablate import (_BODY, _F32_NO_MMA,  # noqa: E402
                                     _F32_NO_WAIT, _MMA, _REFILL, _WAIT,
                                     WMMA, _walk, fold_inputs, inputs)

_SCORE = ("          if (c < dm)\n"
          "            s[h] += qrow[c] * linear_bf16(acc[4 * j + 2 * h + e], "
          "bks[c]);\n")
_LN = ("                                              const float* b) {\n"
       "  const int t = threadIdx.x & 127, q = t & 3;")
_ENC = ("    for (int r = row0; r < row0 + 16; ++r) {\n"
        "      float v = 0.f;\n      if (live) {")
_FUSE = ("        for (int c = lane; c < cout; c += 32)\n"
         "          atomicAdd(&p.fused[(size_t)t * cout + c], accv[r * cout + c]);\n")
VARIANTS = [
    ("whole kernel", []),
    ("no products", [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:])]),
    ("no waits for weights", [("walk_wgmma.cuh", _WAIT, ""),
                              ("walk_wgmma.cuh", _REFILL, "")]),
    ("no products, no waits",
     [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:]),
      ("walk_wgmma.cuh", _WAIT, ""), ("walk_wgmma.cuh", _REFILL, "")]),
    ("no posenc sin / cos",
     [("walk.cuh", "  sincosf(x * freq, &s, &c);", "  s = x * freq;\n  c = s;")]),
    ("no posenc (the encoding rows left as they are)",
     [("walk_wgmma.cuh", _ENC,
       "    for (int r = row0; r < row0 + 16 && pd0 < 0; ++r) {\n"
       "      float v = 0.f;\n      if (live) {")]),
    ("no output LayerNorm (key)",
     [("walk_wgmma.cuh", _LN, _BODY(_LN, "  if (n_true > 0) return;"))]),
    ("no score dot (key)", [("walk_wgmma.cuh", _SCORE, "")]),
    ("no fused write-out (value)", [("walk_wgmma.cuh", _FUSE, "")]),
]


# The fp32 forwards on walk.cuh's WMMA walk (3xTF32 m16n16k8, one block of
# 512 threads a 64-ray tile, the key's softmax inside the kernel).
_W_MMA = ("    if (has0) {\n      // A full chunk unrolls at compile time, so "
          "the scheduler")
_SOFTMAX = "                                             float* __restrict__ ss_out) {\n"
_FUSE_STEP = ("                                          int cout, int t0, "
              "int T) {\n")
_SINCOS = [("walk.cuh", "  sincosf(x * freq, &s, &c);",
            "  s = x * freq;\n  c = s;")]
_W_NO_MMA = [("walk.cuh", _W_MMA, _W_MMA.replace("(has0)",
                                                 "(has0 && pd_in < 0)"))]
WMMA_F32 = [
    ("fp32 WMMA: whole kernel", []),
    ("fp32 WMMA: no products", _W_NO_MMA),
    ("fp32 WMMA: no weight staging waits", WMMA[3][1]),
    ("fp32 WMMA: no products, no waits", _W_NO_MMA + WMMA[3][1]),
    ("fp32 WMMA: no softmax (key)",
     [("stream_common.cuh", _SOFTMAX, _SOFTMAX + "  if (K > -1) return;\n")]),
    ("fp32 WMMA: no posenc sin / cos", _SINCOS),
    ("fp32 WMMA: no fuse step (value)",
     [("stream_common.cuh", _FUSE_STEP,
       _FUSE_STEP + "  if (cout > -1) return;\n")]),
]
# The fp32 forwards on wgmma (walk_wgmma.cuh's fp32 operand form, the walk
# of the fp32 K3).
_F32_SCORE = ("        if (c < dm)\n"
              "          s[h] += qrow[c] * linear_c<float>(acc[4 * j + 2 * h + e], "
              "bks[c]);\n")
_F32_FUSE = ("              if (c1 < cout) arow[c1] += a * "
             "act_round<Op>(acc[i]);\n")
WGMMA_F32 = [
    ("fp32 wgmma: whole kernel", []),
    ("fp32 wgmma: no products", _F32_NO_MMA),
    ("fp32 wgmma: no waits for weights", _F32_NO_WAIT),
    ("fp32 wgmma: no products, no waits", _F32_NO_MMA + _F32_NO_WAIT),
    ("fp32 wgmma: no posenc sin / cos", _SINCOS),
    ("fp32 wgmma: no output LayerNorm (key)",
     [("walk_wgmma.cuh", _LN, _BODY(_LN, "  if (n_true > 0) return;"))]),
    ("fp32 wgmma: no score dot (key)", [("walk_wgmma.cuh", _F32_SCORE, "")]),
    ("fp32 wgmma: no fuse accumulation (value)",
     [("walk_wgmma.cuh", _F32_FUSE, "")]),
    ("fp32 wgmma: no fused write-out (value)",
     [("walk_wgmma.cuh", _FUSE, "")]),
]


# The fp32 feature forwards on wgmma: the same function with the raw
# feature rows as its posenc sources (walk_wgmma.cuh FeatSrc).
_FEAT_LOAD = "    return t < T ? xk[(size_t)t * d_raw + src] : 0.f;"
FEAT_F32 = [
    ("fp32 wgmma (features): no feature loads (every source 0)",
     [("walk_wgmma.cuh", _FEAT_LOAD, "    return 0.f * (float)(t + src);")]),
]


def feat_inputs(dev, f32=False, seed=2):
    """The feature streams' arguments at the record streams' shapes
    (``inputs``): xk (K, T, 9) and xv (K, T, 6 + 64) raw features, (T, K)
    influence and alive (80 %), qq, the walks on ``posenc_plan``'s columns
    (orders 4 fp32, 6 bf16) with random weights -> (key args, value args,
    the key forward's raw dots, dattn, dfused); each args tuple ends in the
    compute options."""
    import torch
    from papr_tpu_torch.ops import stream_feat as sf
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    T, L = (32_400, 4) if f32 else (25_600, 6)
    K, dm = 20, 256
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    xk, xv = t(rng.normal(size=(K, T, 9))), t(rng.normal(size=(K, T, 70)))
    influ, alive = t(rng.normal(size=(T, K))), t(rng.random((T, K)) > 0.2)
    qq = t(rng.normal(size=(T, dm)))
    kwalk = _walk(rng, posenc_plan((3, 3, 3), (L, L, L), 1, 2.0, 1.0, 0)[1],
                  5, 256, 256, True, dev)
    vwalk = _walk(rng, posenc_plan((3, 3), (L, L), 1, 2.0, 1.0, 64)[1], 8,
                  256, 32, False, dev)
    wk, bk = t(rng.normal(size=(dm, 256)) / 16), t(rng.normal(size=dm) * 0.1)
    cdt = torch.float32 if f32 else torch.bfloat16
    key = (xk, qq, kwalk, wk, bk, influ, alive, "relu", 5.0, cdt)
    attn, raw = sf.key_stream_feat_fwd(*key)
    value = (xv, attn, vwalk, True, cdt)
    return (key, value, raw, t(rng.normal(size=(T, K + 1))),
            t(rng.normal(size=(T, 32))))


def _spans(fn, n: int = 3) -> dict:
    """Each device kernel's ms per call (its torch.profiler span), by name
    without its arguments."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            name = (e.name.replace("(anonymous namespace)::", "")
                    .split("(")[0].split("<")[0].replace("void ", ""))
            out[name] = out.get(name, 0.0) + us / n / 1e3
    return out


def _timed(fn, pats, n: int = 3):
    """(kernel alone: the spans whose name holds one of pats, the other
    device kernels, the whole call from CUDA events) ms per call, and every
    span by name."""
    import torch
    spans = _spans(fn, n)
    k_ms = sum(ms for name, ms in spans.items()
               if any(p in name for p in pats))
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return k_ms, sum(spans.values()) - k_ms, a.elapsed_time(b) / n, spans


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--split-only", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--feat", action="store_true")
    ap.add_argument("--fold", action="store_true")
    ap.add_argument("--scores", action="store_true")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    csrc = os.path.join(tree, "papr_tpu_torch", "csrc")
    src = lambda f: open(os.path.join(csrc, f)).read()
    # The tree's design: the fp32 forwards on wgmma where key_stream.cu has
    # their kernel (the feature forwards: key_stream_feat.cu); the bf16 ones
    # where walk_wgmma.cuh exists.
    if opt.scores:
        from papr_tpu_torch.ops import fused_attn as fa
        T, K, D = 32_400, 20, 256
        rng = np.random.default_rng(5)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                      device=dev)
        sargs = (t(rng.normal(size=(K, T, D))), t(rng.normal(size=(T, D))),
                 t(rng.normal(size=(D, D)) / 16), t(rng.normal(size=D)),
                 t(rng.normal(size=(D, D)) / 16), t(rng.normal(size=D)),
                 t(rng.normal(size=(T, K))), t(rng.random((T, K)) > 0.2))
        cases = (("fused scores", ("fused_scores", "key_fwd_softmax"),
                  lambda: [fa.fused_scores_fwd(*sargs, "relu", 5.0,
                                               torch.float32)]),)
        wg, backwards = False, ()
        opt.f32 = True
    elif opt.fold:
        args, opts, _, _ = fold_inputs(dev, opt.f32)
        cases = (("key (query folded)", ("keyq_fwd", "query_head_fwd",
                                         "key_fwd"),
                  lambda: sa.key_stream_q_fwd(*args, *opts)),)
        T, wg, backwards = args[0].shape[1], False, ()
    elif opt.feat:
        key, value, raw, dattn, dfused = feat_inputs(dev, opt.f32)
        T = key[0].shape[1]
        wg = opt.f32 and "key_feat_fwd_wgmma_f32_kernel" in src(
            "key_stream_feat.cu")
        # (name, kernel-name patterns, the call); the backwards whole only.
        cases = (("key (features)", ("key_feat_fwd", "key_fwd_softmax",
                                     "keyf_fwd"),
                  lambda: sf.key_stream_feat_fwd(*key)),
                 ("value (features)", ("value_feat_fwd", "valuef_fwd"),
                  lambda: [sf.value_stream_feat_fwd(*value)]))
        backwards = (("key (features)", ("keyf_bwd",),
                      lambda: sf.key_stream_feat_bwd(*key[:7], raw, dattn,
                                                     *key[7:])),
                     ("value (features)", ("valuef_bwd",),
                      lambda: sf.value_stream_feat_bwd(*value[:3], dfused,
                                                       *value[3:])))
    else:
        key, value = inputs(dev, opt.f32)
        key, value = key[:7] + key[10:], value[:5] + value[6:]
        T = key[0].shape[1]
        wg = not opt.f32 or "key_fwd_wgmma_f32_kernel" in src("key_stream.cu")
        cases = (("key", ("key_fwd",), lambda: sa.key_stream_fwd(*key)),
                 ("value", ("value_fwd",),
                  lambda: [sa.value_stream_fwd(*value)]))
        backwards = ()
    form = "fp32 " if opt.f32 else ""
    # The grid rule: fused_mlp's, or stream_attn's on an older tree.
    rule = next((m for m in (fm, sa) if hasattr(m, "wgmma_grid")), None)
    grids = [("", None)]
    if rule is not None and wg:
        tiles = -(-T // 128)
        grids = [(f" (grid {rule.wgmma_grid(T)}: persistent)", None),
                 (f" (grid {tiles}: one block a tile)", tiles)]
    sound = {}

    def show(what, label, pats, fn):
        k_ms, o_ms, whole, spans = _timed(fn, pats)
        listed = ", ".join(f"{n} {ms:.3f}" for n, ms in
                           sorted(spans.items(), key=lambda x: -x[1])
                           if ms >= 0.01)
        print(f"{form}{what} stream{label}, whole call {whole:.3f} ms: kernel "
              f"alone {k_ms:.3f}, other device kernels {o_ms:.3f}, host / "
              f"gaps {whole - k_ms - o_ms:.3f} (spans: {listed})", flush=True)

    for label, grid in grids:
        real = getattr(rule, "wgmma_grid", None)
        if grid is not None:
            rule.wgmma_grid = lambda T: grid
        for what, pats, fn in cases:
            sound.setdefault(what, [g.clone() for g in fn()])
            show(what, f" forward{label}", pats, fn)
        if real is not None:
            rule.wgmma_grid = real
    for what, pats, fn in backwards:
        show(what, " backward", pats, fn)
    if opt.fold or opt.scores:
        for what, pats, fn in cases:
            show(what, " forward, again", pats, fn)
        return
    if opt.split_only or not os.path.exists(os.path.join(csrc,
                                                         "walk_wgmma.cuh")):
        return
    if opt.feat:
        variants = WGMMA_F32 + FEAT_F32 if wg else []
        units = ("key_stream_feat", "value_stream_feat")
        fixed = ("wgrad", "key_stream")    # built once, from the tree
    else:
        variants = (WGMMA_F32 if wg else WMMA_F32) if opt.f32 else VARIANTS
        units = ("key_stream", "value_stream")
        fixed = ("wgrad",)
    if not variants:
        print("no variants: the variants are the fp32 feature forwards' "
              "on wgmma", flush=True)
        return
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="stream_fwd_ablate_")
    objs = [os.path.join(root, f"{cu}.o") for cu in fixed]
    for cu, o in zip(fixed, objs):
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", o,
                        os.path.join(csrc, cu + ".cu")], check=True,
                       capture_output=True)
    procs, runs = {}, []
    for i, (name, subs) in enumerate(variants):
        vsrc = os.path.join(root, str(i))
        shutil.copytree(csrc, vsrc)
        missing = False
        for f, old, new in subs:
            p = os.path.join(vsrc, f)
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
        for cu in units:
            procs[(i, cu)] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-c", "-o",
                 os.path.join(root, f"{i}.{cu}.o"),
                 os.path.join(vsrc, cu + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for i, name in runs:
        if any(procs[(i, cu)].returncode for cu in units):
            print(f"{name}: build failed\n"
                  + "\n".join(logs[(i, cu)][-3000:] for cu in units))
            continue
        so = os.path.join(root, f"{i}.so")
        subprocess.run([nvcc, "-shared", "-o", so, *objs]
                       + [os.path.join(root, f"{i}.{cu}.o") for cu in units],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fname in build.SIGNATURES:
            fn = getattr(lib, fname, None)
            if fn is not None:
                fn.argtypes = build.SIGNATURES[fname]
                fn.restype = ctypes.c_int
        build._lib = lib           # the wrappers load this build
        parts = []
        for what, pats, fn in cases:
            got = fn()
            err = max(float((g - w).norm() / max(float(w.norm()), 1e-30))
                      for g, w in zip(got, sound[what]))
            k_ms, _, whole, _ = _timed(fn, pats)
            parts.append(f"{what} kernel {k_ms:.3f} ms (call {whole:.3f}), "
                         f"max rel {err:.1e}")
        spills = [l.strip() for cu in units
                  for l in logs[(i, cu)].splitlines()
                  if "spill" in l and " 0 bytes spill" not in l]
        print(f"{name}: " + "; ".join(parts)
              + (f"; ptxas: {' | '.join(spills)}" if spills else ""),
              flush=True)
    build._lib = None
    shutil.rmtree(root, ignore_errors=True)

if __name__ == "__main__":
    main()
