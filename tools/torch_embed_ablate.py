"""Where the fused embedder's kernels spend their time: the forward K2
(``csrc/fused_mlp.cu``, ``papr_fused_mlp_fwd``) and the backward row 3
(``csrc/fused_mlp_bwd.cu``, ``papr_fused_mlp_bwd``, then ``wgrad`` per layer
and ``colsum``), bf16, on the main path's shapes with the flagship's widths
and random weights: the query stack on an 800x800 frame's 640,000 rays
(forward) and a 160x160 patch's 25,600 rays (backward), and, under
``tpu.fused_attn: true``, the key and value stacks on 512,000 tokens. With
``--f32`` the fp32 kernels (``use_amp: false``, ``papr_fused_mlp_f32_fwd`` /
``papr_fused_mlp_f32_bwd``, then ``wgrad_f32``) at phase 8's shapes and
Caterpillar's widths (``configs/t2/Caterpillar.yml``: q_L [4], k_L [4, 4,
4], v_L [4, 4]): the query stack on 640,000 rays forward and a 180x180
patch's 32,400 backward, the key and value stacks on 648,000 tokens.

    python tools/torch_embed_ablate.py [--f32] [--tree DIR] [--split-only]

Each call is split into the kernel alone (its ``torch.profiler`` span), the
dW reduction (``wgrad`` + ``colsum``), the other device kernels (packs,
zero fills) and host time / gaps (the whole call by CUDA events less the
three); the backward's host-side preparation (packs, plan rows, buffers)
is also timed alone. ``--tree`` takes the sources and the package from
another checkout (for example an unpacked parent commit); the variants
follow that tree's design (``WGMMA`` where ``fused_mlp.cu`` has the wgmma
entry point, else the ``WMMA`` walk of ``walk.cuh`` / ``walk_bwd.cuh``;
with ``--f32``, ``WGMMA_F32`` where it has ``fused_mlp_fwd_wgmma_f32_kernel``,
else ``WMMA``).
Each variant is a copy of the CUDA sources with lines replaced (one part
taken out: the products, the weight staging, the posenc, the LayerNorms,
the stash stores), built alone (``fused_mlp.cu``, ``fused_mlp_bwd.cu``,
``wgrad.cu``) and loaded in place of the library; a variant computes the
wrong function (its error against the sound build is printed): it is a
timing probe, not a kernel. Prints one line a variant: the query stack's
forward and backward kernel alone and whole call, the error and ptxas's
spill lines.
"""

import argparse
import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from torch_stream_bwd_ablate import (_BODY, _F32_NO_MMA,  # noqa: E402
                                     _F32_NO_WAIT, _LB, _LNB, _MMA, _REFILL,
                                     _SAVE, _SF, _SR, _STASH, _SW, _WAIT,
                                     _split)

_SINCOS = [("walk.cuh", "  sincosf(x * freq, &s, &c);",
            "  s = x * freq;\n  c = s;")]
# The WMMA walk (walk.cuh dense_layer, layernorm_rows; walk_bwd.cuh).
WMMA = [
    ("whole kernel", []),
    ("no products",
     [("walk.cuh", "    if (has0) {\n      // A full chunk unrolls",
       "    if (has0 && pd_in < 0) {\n      // A full chunk unrolls")]),
    ("no weight staging",
     [("walk.cuh",
       "  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {\n"
       "    const int r = vshift",
       "  for (int v = threadIdx.x; v < rows * vpr && pd_out < 0; "
       "v += kThreads) {\n    const int r = vshift")]),
    ("no posenc sin / cos",
     _SINCOS + [("walk_bwd.cuh",
                 "      sincosf(src_val(r, src) * freq, &sv, &cv);",
                 "      sv = src_val(r, src) * freq;\n      cv = sv;")]),
    ("no LayerNorms",
     [("walk.cuh",
       "  for (int r = warp; r < kRows; r += kWarps) {\n"
       "    float* row = C + r * kCLd;\n    float s = 0.f;",
       "  for (int r = warp; r < kRows && n_true < 0; r += kWarps) {\n"
       "    float* row = C + r * kCLd;\n    float s = 0.f;"),
      ("walk_bwd.cuh", _LNB, _BODY(_LNB, "  if (pd > 0) return;"))]),
    ("no stash / scratch stores",
     [("walk_bwd.cuh", _STASH, _BODY(_STASH, "  if (pd > 0) return;")),
      ("walk_bwd.cuh", _SAVE, _BODY(_SAVE, "  if (pd > 0) return;")),
      ("walk_bwd.cuh", "      store8(b.dz[l] + (x.row0 + r) * po + c8, h);\n",
       "")]),
]
# The wgmma walk (walk_wgmma.cuh / walk_wgmma_bwd.cuh).
_LNF = ("                                              const float* b) {\n"
        "  const int t = threadIdx.x & 127, q = t & 3;")
_LNST = ("                                                 float (&rr)[2]) {\n"
         "  const int t = threadIdx.x & 127, q = t & 3;")
_OUT = (" " * 46 + "int rbase, int R, int d_out) {\n"
        "  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, "
        "q = lane & 3;")
WGMMA = [
    ("whole kernel", []),
    ("no products", [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:])]),
    ("no waits for weights", [("walk_wgmma.cuh", _WAIT, ""),
                              ("walk_wgmma.cuh", _REFILL, "")]),
    ("no products, no waits",
     [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:]),
      ("walk_wgmma.cuh", _WAIT, ""), ("walk_wgmma.cuh", _REFILL, "")]),
    ("no posenc sin / cos", _SINCOS),
    ("no output LayerNorm (forward, recompute, backward)",
     [("walk_wgmma.cuh", _LNF, _BODY(_LNF, "  if (n_true > 0) return;")),
      ("walk_wgmma_bwd.cuh", _LNST, _BODY(_LNST, "  if (n_true > 0) return;")),
      ("walk_wgmma_bwd.cuh", _LB, _BODY(_LB, "  if (n_true > 0) return;"))]),
    ("no stash stores",
     [("walk_wgmma_bwd.cuh", _SW, _BODY(_SW, "  if (pd > 0) return;")),
      ("walk_wgmma_bwd.cuh", _SR, _BODY(_SR, "  if (pd > 0) return;"))]),
    ("no output rows written (forward)",
     [("walk_wgmma.cuh", _OUT, _BODY(_OUT, "  if (d_out > 0) return;"))]),
]

_OUT_F32 = (" " * 46 + "int rbase, int R, int d_out) {\n"
            "  const int lane = threadIdx.x & 31, row0 = A.row0;")
# The fp32 embedder on wgmma (walk_wgmma.cuh's fp32 operand form: 3xTF32
# m64n64k8, the layer inputs fp32 in shared memory).
WGMMA_F32 = [
    ("fp32 wgmma: whole kernel", []),
    ("fp32 wgmma: no products", _F32_NO_MMA),
    ("fp32 wgmma: no waits for weights", _F32_NO_WAIT),
    ("fp32 wgmma: no products, no waits", _F32_NO_MMA + _F32_NO_WAIT),
    ("fp32 wgmma: no posenc sin / cos", _SINCOS),
    ("fp32 wgmma: no output LayerNorm (forward, recompute, backward)",
     WGMMA[5][1]),
    ("fp32 wgmma: no stash stores",
     [("walk_wgmma_bwd.cuh", _SF, _BODY(_SF, "  if (pd > 0) return;"))]),
    ("fp32 wgmma: no output rows written (forward)",
     [("walk_wgmma.cuh", _OUT_F32, _BODY(_OUT_F32, "  if (d_out > 0) return;"))]),
]


def _walk(rng, cols, n, d_ff, d_out, norm, dev):
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


def stacks(dev, seed=4, f32=False):
    """{name: (walk, x forward, x backward, dy)}: the query stack (ray
    directions; 640,000 rays forward, 25,600 backward) and the key and
    value stacks of ``fused_attn: true`` (512,000 tokens both ways; the
    value's 64 point-feature columns pass through), the flagship's widths
    (``configs/default.yml``: q_L [6], k_L [6, 6, 6], v_L [6, 6], 5 x 256
    with LayerNorms; the value 8 layers to 32 without). ``f32``: phase 8's
    shapes and Caterpillar's orders (posenc order 4; 32,400 rays backward,
    648,000 tokens a stack)."""
    import torch
    from papr_tpu_torch.ops.fused_mlp import posenc_plan
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)

    def dirs(n):
        d = rng.normal(size=(n, 3))
        return t(d / np.linalg.norm(d, axis=-1, keepdims=True))

    out = {}
    L, rb, nt = (4, 32_400, 648_000) if f32 else (6, 25_600, 512_000)
    q = _walk(rng, posenc_plan((3,), (L,), 1, 2.0, 1.0, 0)[1], 5, 256, 256,
              True, dev)
    out["query"] = (q, dirs(640_000), dirs(rb), t(rng.normal(size=(rb, 256))))
    k = _walk(rng, posenc_plan((3, 3, 3), (L, L, L), 1, 2.0, 1.0, 0)[1], 5,
              256, 256, True, dev)
    xk = t(rng.normal(size=(nt, 9)))
    out["key"] = (k, xk, xk, t(rng.normal(size=(nt, 256))))
    v = _walk(rng, posenc_plan((3, 3), (L, L), 1, 2.0, 1.0, 64)[1], 8, 256,
              32, False, dev)
    xv = t(rng.normal(size=(nt, 70)))
    out["value"] = (v, xv, xv, t(rng.normal(size=(nt, 32))))
    return out


def prep_ms(fm, walk, x, cdt, n=20) -> float:
    """Host clock per call of the backward wrapper's preparation alone
    (packs, plan rows, buffers), synchronized: ``embed_bwd_prep`` where the
    tree's wrapper has it for this compute dtype, else the WMMA walk's
    packs and buffers."""
    import inspect
    import torch
    dev = x.device
    R = x.shape[0]
    prep = getattr(fm, "embed_bwd_prep", None)
    if prep is not None and (cdt == torch.bfloat16
                             or "cdt" in inspect.signature(prep).parameters):
        extra = {} if cdt == torch.bfloat16 else {"cdt": cdt}
        fn = lambda: prep(walk, R, x.shape[1], dev, **extra)
    else:
        def fn():
            meta, w, b, ln, plan, pd = fm.pack_walk(walk, len(walk.cols), dev,
                                                    cdt)
            fm.pack_walk_t(walk, pd, dev, cdt)
            fm.source_segments(walk.cols, x.shape[1], dev)
            nblk = -(-R // 64)
            fm.BwdBuffers(pd, nblk * 64, nblk, dev, cdt=cdt)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--split-only", action="store_true")
    ap.add_argument("--f32", action="store_true")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_mlp as fm

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    cdt = torch.float32 if opt.f32 else torch.bfloat16
    st = stacks(dev, f32=opt.f32)
    form = "fp32 " if opt.f32 else ""
    cases = {}
    for name, (walk, xf, xb, dy) in st.items():
        cases[(name, "fwd")] = (lambda w=walk, x=xf: [fm.fused_mlp(x, w, cdt)])
        cases[(name, "bwd")] = (
            lambda w=walk, x=xb, g=dy: (lambda r: [r[0]] + r[1])(
                fm.fused_mlp_bwd(x, g, w, cdt)))
    sound = {}
    for (name, way), fn in cases.items():
        sound[(name, way)] = [g.clone() for g in fn()]
        k_ms, r_ms, o_ms, whole = _split(fn, f"fused_mlp_{way}")
        rows = st[name][1 if way == "fwd" else 2].shape[0]
        line = (f"{form}{name} stack {way} ({rows} rows), whole call {whole:.3f} "
                f"ms: kernel alone {k_ms:.3f}, wgrad + colsum {r_ms:.3f}, "
                f"other device kernels {o_ms:.3f}, host / gaps "
                f"{whole - k_ms - r_ms - o_ms:.3f}")
        if way == "bwd":
            line += (f"; the wrapper's preparation alone (host clock) "
                     f"{prep_ms(fm, st[name][0], st[name][2], cdt):.3f}")
        print(line, flush=True)
    if opt.split_only:
        return
    csrc = os.path.join(tree, "papr_tpu_torch", "csrc")
    src_fwd = open(os.path.join(csrc, "fused_mlp.cu")).read()
    if opt.f32:
        variants = (WGMMA_F32 if "fused_mlp_fwd_wgmma_f32_kernel" in src_fwd
                    else WMMA)
    else:
        variants = WGMMA if "fused_mlp_fwd_wgmma_kernel" in src_fwd else WMMA
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="embed_ablate_")
    wg_obj = os.path.join(root, "wgrad.o")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", wg_obj,
                    os.path.join(csrc, "wgrad.cu")], check=True,
                   capture_output=True)
    cus = ("fused_mlp", "fused_mlp_bwd")
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
        for cu in cus:
            procs[(i, cu)] = subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-c", "-o",
                 os.path.join(root, f"{i}.{cu}.o"),
                 os.path.join(src, cu + ".cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for i, name in runs:
        if any(procs[(i, cu)].returncode for cu in cus):
            print(f"{name}: build failed\n"
                  + "\n".join(logs[(i, cu)][-3000:] for cu in cus))
            continue
        so = os.path.join(root, f"{i}.so")
        subprocess.run([nvcc, "-shared", "-o", so, wg_obj,
                        *(os.path.join(root, f"{i}.{cu}.o") for cu in cus)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        for fname, args in build.SIGNATURES.items():
            if hasattr(lib, fname):
                getattr(lib, fname).argtypes = args
                getattr(lib, fname).restype = ctypes.c_int
        build._lib = lib           # the wrappers load this build
        parts = []
        for key in (("query", "fwd"), ("query", "bwd")):
            got = cases[key]()
            err = max(float((g.float() - w.float()).norm()
                            / max(float(w.float().norm()), 1e-30))
                      for g, w in zip(got, sound[key]))
            k_ms, _, _, whole = _split(cases[key], f"fused_mlp_{key[1]}")
            parts.append(f"{form}{key[1]} kernel {k_ms:.3f} ms (call {whole:.3f}), "
                         f"max rel {err:.1e}")
        spills = [l.strip() for cu in cus for l in logs[(i, cu)].splitlines()
                  if "spill" in l and " 0 bytes spill" not in l]
        print(f"{name}: " + "; ".join(parts)
              + (f"; ptxas: {' | '.join(spills)}" if spills else ""),
              flush=True)
    build._lib = None
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
