"""Which part of the one-shot eval attention holds its time: the kernel
(``csrc/attend_eval.cu``) timed whole and with one part taken out at a time,
on phase 2's shapes (25,600 rays, K = 20, 30,000 points, the flagship's walks
with random weights); with ``--f32`` the fp32 kernel (``use_amp: false``,
``papr_attend_eval_f32``) at phase 8's 32,400 rays, and whole at an 800x800
frame's 640,000 rays; with ``--int8`` the int8 kernel (``tpu.int8_eval``,
``papr_attend_eval_i8``; with ``--f32`` ``papr_attend_eval_i8_f32`` at
32,400 rays) on a quantization calibrated once on its inputs (a frame's, as
the tiled render passes it), and whole at 640,000 rays.

    python tools/torch_k3_ablate.py [--f32]          # needs a card and nvcc
    python tools/torch_k3_ablate.py --int8 [--f32]
    python tools/torch_k3_ablate.py --int8 --ab TREE

Each variant is a copy of the CUDA sources with one line replaced, built
alone (``attend_eval.cu``) and loaded in place of the library; the wrapper
and its inputs are the same for all. A variant computes the wrong function
(its error against the plain version is printed): it is a timing probe, not
a kernel. Prints one line a variant: ms per launch (CUDA events, 5 launches
after a warm-up), the error, ptxas's spill and wgmma lines. A tree whose
int8 kernel is not on wgmma (``walk.cuh``'s WMMA walk) times it whole only.

``--ab TREE`` (for a parent / change / change / parent run on one card)
times instead, on TREE's own sources and library (for the parent, ``git
archive`` of it unpacked into a git-ignored directory): both int8 kernels
whole (call, and alone: its profiler span) beside the bf16 / fp32 kernel on
the same inputs, at the patch and at 640,000 rays; then the ``int8_eval``
serving frames (the flagship's bf16 model, 800x800 orbit poses, beside its
bf16 frames; Caterpillar's fp32 model on phase 8's view, beside its fp32
frame) with the int8 frame's profiler split, and their 100x100-tiled
frames, host clock.
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
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --ab TREE: TREE's package, chip_smoke and library in place of this tree's.
TREE = (os.path.abspath(sys.argv[sys.argv.index("--ab") + 1])
        if "--ab" in sys.argv[:-1] else REPO)
sys.path.insert(0, TREE)
os.chdir(TREE)

from papr_tpu_torch.kernels import build  # noqa: E402
from papr_tpu_torch.ops import stream_attn as sa  # noqa: E402
from papr_tpu_torch.ops.fused_mlp import Walk  # noqa: E402

_ENC = ("  const int lane = threadIdx.x & 31, pd0 = d.pd[0];\n"
        "  for (int c = lane; c < pd0; c += 32) {")
_NO_ENC = ("  const int lane = threadIdx.x & 31, pd0 = d.pd[0];\n"
           "  if (pd0 > 0) return;\n"
           "  for (int c = lane; c < pd0; c += 32) {")
_MMA = "      wgmma_rs_bf16_n128(acc, A[4 * kb], A[4 * kb + 1], A[4 * kb + 2],"
_WAIT = "    if (real) mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);"
_REFILL = "    if (j + ring.stages < ring.total) wg_issue(ring, j + ring.stages);"
# (name, [(file, line, replacement)]): what each variant takes out.
VARIANTS = [
    ("whole kernel", []),
    ("no posenc sin / cos", [("walk.cuh", "  sincosf(x * freq, &s, &c);",
                              "  s = x * freq;\n  c = s;")]),
    ("no posenc at all", [("attend_eval.cu", _ENC, _NO_ENC)]),
    ("no score (q . k)", [("attend_eval.cu", "                if (c < p.dm)\n",
                           "                if (c < p.dm && k < 0)\n")]),
    ("no bias / activation", [("walk_wgmma.cuh",
                               "  const bool full = pd >= kPassN;",
                               "  if (pd > -1) return;\n"
                               "  const bool full = pd >= kPassN;")]),
    ("no waits for weights", [("walk_wgmma.cuh", _WAIT, ""),
                              ("walk_wgmma.cuh", _REFILL, "")]),
    ("no wgmma, no waits", [("walk_wgmma.cuh", _MMA, "      if (kb < 0) " + _MMA[6:]),
                            ("walk_wgmma.cuh", _WAIT, ""),
                            ("walk_wgmma.cuh", _REFILL, "")]),
]

# The earlier fp32 kernel: the tile function on walk.cuh's WMMA walk
# (3xTF32 m16n16k8, weights staged by cp.async).
_RS_ENC = ("  const int pd0 = d.pd[0];\n"
           "  for (int c = lane; c < pd0; c += 32) {\n"
           "    const bool live = c < d.d_enc;\n"
           "    const int src = live ? (int)d.plan[c] : 0;")
F32_WMMA_VARIANTS = [
    ("whole kernel", []),
    ("no products", [("walk.cuh",
                      "    mma_3xtf32(c, a.hi, a.lo, b.hi, b.lo);\n", "")]),
    ("no weight staging", [("walk.cuh",
                            "    cp_async16(dst + r * kWLd + c, W + "
                            "(size_t)(k0 + r) * pd_out + c);\n", "")]),
    ("no LayerNorms", [("walk.cuh", "  if (d.has_li) layernorm_rows(s.C, "
                        "s.A[0], true, d.d_enc, pd0, d.ln, d.ln + pd0);",
                        "  if (d.has_li && d.n < 0) layernorm_rows(s.C, "
                        "s.A[0], true, d.d_enc, pd0, d.ln, d.ln + pd0);"),
                       ("walk.cuh", "  if (d.has_lo) {\n    const float* lo "
                        "= d.ln + 2 * pd0;\n    layernorm_rows(s.C, s.A[0], "
                        "out_bf16,",
                        "  if (d.has_lo && d.n < 0) {\n    const float* lo "
                        "= d.ln + 2 * pd0;\n    layernorm_rows(s.C, s.A[0], "
                        "out_bf16,")]),
    ("no posenc", [("rec_stream.cuh", _RS_ENC,
                    _RS_ENC.replace("  for (int c", "  if (pd0 > 0) return;\n"
                                    "  for (int c"))]),
]

# The fp32 kernel on wgmma (walk_wgmma.cuh's fp32 form, 3xTF32 m64n64k8).
_F32_MMA = ("          const int kk = 2 * (sub * kF32Sub + s);     // 32 bytes "
            "a k8 step\n")
_F32_WAIT = "          mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);\n"
_F32_LN = "  if (ln_a) acc_layernorm(acc, nullptr, n_true, ln_a, ln_b);\n"
F32_VARIANTS = [
    ("whole kernel", []),
    ("no products", [("walk_wgmma.cuh", _F32_MMA,
                      _F32_MMA + "          if (kk >= 0) continue;\n")]),
    ("no waits for weights", [("walk_wgmma.cuh", _F32_WAIT, ""),
                              ("walk_wgmma.cuh", _REFILL, "")]),
    ("no products, no waits", [("walk_wgmma.cuh", _F32_MMA,
                                _F32_MMA
                                + "          if (kk >= 0) continue;\n"),
                               ("walk_wgmma.cuh", _F32_WAIT, ""),
                               ("walk_wgmma.cuh", _REFILL, "")]),
    ("no LayerNorms", [("walk_wgmma.cuh", _F32_LN, ""),
                       ("walk_wgmma.cuh", "    if (d.has_li) {",
                        "    if (d.has_li && d.n < 0) {")]),
    ("no posenc", [("walk_wgmma.cuh", _ENC,
                    _ENC.replace("  for (int c", "  if (pd0 > 0) return;\n"
                                 "  for (int c"))]),
    ("(a design choice) a fresh accumulator per 16-deep half chunk",
     [("walk_wgmma.cuh", "constexpr int kF32Sub = 4;",
       "constexpr int kF32Sub = 2;")]),
]


# The int8 kernel on wgmma (walk_wgmma.cuh's int8 form, s8 m64n128k32).
_Q8_MMA = ("      wgmma_rs_s8_n128(acc, A[4 * kb], A[4 * kb + 1], "
           "A[4 * kb + 2],")
_Q8_QUANT = ("          v[h][2 * x] = quantize_value(z.x, iv.x);\n"
             "          v[h][2 * x + 1] = quantize_value(z.y, iv.y);\n")
_Q8_DEQ = ("  float z0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h], s.x), "
           "b.x);\n"
           "  float z1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], "
           "s.y), b.y);\n")
Q8_VARIANTS = [
    ("whole kernel", []),
    ("no s8 products", [("walk_wgmma.cuh", _Q8_MMA,
                         "      if (kb < 0) " + _Q8_MMA[6:])]),
    ("no waits for weights", [("walk_wgmma.cuh", _WAIT, ""),
                              ("walk_wgmma.cuh", _F32_WAIT, ""),
                              ("walk_wgmma.cuh", _REFILL, "")]),
    ("no quantization (fragment bytes from the fp32 bits)",
     [("walk_wgmma.cuh", _Q8_QUANT,
       "          v[h][2 * x] = __float_as_int(z.x);\n"
       "          v[h][2 * x + 1] = __float_as_int(z.y);\n")]),
    ("no dequantization (z = acc)",
     [("walk_wgmma.cuh", _Q8_DEQ,
       "  float z0 = (float)acc[4 * j + 2 * h];\n"
       "  float z1 = (float)acc[4 * j + 2 * h + 1];\n")]),
    ("no LayerNorms", [("walk_wgmma.cuh", "    if (d.has_li) {",
                        "    if (d.has_li && d.n < 0) {"),
                       ("walk_wgmma.cuh", "  if (ln_a) acc_layernorm(f, ",
                        "  if (ln_a && n_true < 0) acc_layernorm(f, ")]),
    ("no posenc", [("walk_wgmma.cuh", _ENC,
                    _ENC.replace("  for (int c", "  if (pd0 > 0) return;\n"
                                 "  for (int c"))]),
]


def _walk(rng, cols, n, d_ff, d_out, norm, dev):
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


def inputs(dev, T=25_600, K=20, P=30_000, dm=256, seed=2,
           cdt=torch.bfloat16):
    rng = np.random.default_rng(seed)
    record = np.zeros((P, 128), np.float32)
    record[:, :3] = rng.normal(size=(P, 3))
    record[:, 3] = rng.normal(size=P)
    record[:, 4] = rng.random(P) > 0.2
    record[:, 5:69] = rng.normal(size=(P, 64))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                  device=dev)
    rays = rng.normal(size=(T, 3))
    return (t(record),
            torch.as_tensor(rng.integers(0, P, size=(T, K)).astype(np.int32),
                            device=dev),
            t(np.broadcast_to(rng.normal(size=(1, 3)) * 3, (T, 3))),
            t(rays / np.linalg.norm(rays, axis=-1, keepdims=True)),
            t(rng.normal(size=(T, dm))),
            _walk(rng, sa.rec_pe_plan(True, (6, 6, 6), 1, 2.0, 1.0, 0), 5, 256,
                  256, True, dev),
            t(rng.normal(size=(dm, 256)) / 16), t(rng.normal(size=dm) * 0.1),
            _walk(rng, sa.rec_pe_plan(False, (6, 6), 1, 2.0, 1.0, 64), 8, 256,
                  32, False, dev),
            "relu", 5.0, True, 1e-6, cdt)


def _time(fn, n: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def _calibrated(args):
    """A frame's quantization of the inputs (as the tiled render passes
    one): its packs are made on the first call and kept."""
    from papr_tpu_torch.ops.fused_mlp import FrameQuant
    record, idx, rayo, rays, _, kw, _, _, vw = args[:9]
    return FrameQuant(sa._calibrate_idx(record, idx, rayo, rays, (kw, vw),
                                        args[12], args[13]))


def ab(tree: str) -> None:
    """``--ab``: TREE's int8 kernels whole and its int8_eval frames."""
    import chip_smoke as cs
    from papr_tpu_torch.train.step import render_frames, render_full_image
    from papr_tpu_torch.ops.geometry import get_rays_np

    dev = torch.device("cuda", 0)
    build.load()
    print(f"== tree {tree}; {torch.cuda.get_device_name(0)}", flush=True)
    for f32 in (False, True):
        cdt = torch.float32 if f32 else torch.bfloat16
        tag = "4qf" if f32 else "4q"
        for T in ((32_400 if f32 else 25_600), 640_000):
            args = inputs(dev, T=T, cdt=cdt)
            qp = _calibrated(args)
            call = lambda: sa.attend_eval_idx(*args, True, qp)
            twin = lambda: sa.attend_eval_idx(*args)
            got, _ = call()
            line = f"row {tag} T={T} K={args[1].shape[1]}:"
            if T < 100_000:
                want, _ = sa.attend_eval_plain(*args, True, qp)
                line += (" fused rel "
                         f"{float((got - want).norm() / want.norm()):.3e};")
                del want
            n = 5 if T < 100_000 else 3
            ms, t_ms = _time(call, n), _time(twin, n)
            alone = cs.kernel_span_ms(call, "attend_eval_i8", n)
            t_alone = cs.kernel_span_ms(twin, "attend_eval_wgmma_kernel", n)
            print(f"{line} int8 call {ms:.3f} ms, alone {alone:.3f} ms; the "
                  f"{'fp32' if f32 else 'bf16'} kernel on the same inputs "
                  f"call {t_ms:.3f} ms, alone {t_alone:.3f} ms", flush=True)
            del args, qp, got
            torch.cuda.empty_cache()
    if "--frames" not in sys.argv:
        return
    H = W = cs.H
    for f32 in (False, True):
        cfg8 = (cs.caterpillar_cfg(int8_eval=True) if f32
                else cs.flagship_cfg(int8_eval=True))
        cfg = cs.caterpillar_cfg() if f32 else cs.flagship_cfg()
        params, state = cs.build_model(cfg8, dev)
        poses = ([cs.sphere_view(cfg, dev)[0]] * 3 if f32 else
                 [cs.orbit(2 * np.pi * i / 3) for i in range(3)])
        serve = lambda c: list(render_frames(params, state, c, poses,
                                             cs.FOCAL, cs.FOCAL, H, W, H, W))
        out = {}
        with torch.no_grad():
            for name, c in (("int8_eval", cfg8), ("twin", cfg),
                            ("int8_eval", cfg8), ("twin", cfg)):
                serve(c)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                serve(c)
                torch.cuda.synchronize()
                out.setdefault(name, []).append(
                    (time.perf_counter() - t0) / len(poses) * 1e3)
            wall, idle, spans = cs.device_profile(lambda: serve(cfg8))
            split, kern = cs.stage_split(spans, cs.FRAME_STAGES, len(poses))
            c2w = np.asarray(poses[0].cpu() if torch.is_tensor(poses[0])
                             else poses[0])
            rayo, rayd = get_rays_np(H, W, cs.FOCAL, cs.FOCAL, c2w[None])
            tiled = []
            for c in (cfg8, cfg8, cfg8):
                t0 = time.perf_counter()
                render_full_image(params, state, c, rayo, rayd, 100, 100,
                                  rgb_only=True, rgb_uint8=True)
                torch.cuda.synchronize()
                tiled.append((time.perf_counter() - t0) * 1e3)
        kind = "fp32 (Caterpillar)" if f32 else "bf16 (flagship)"
        print(f"int8_eval frames {H}x{W}, {kind}: serving "
              + " / ".join(f"{m:.1f}" for m in out["int8_eval"])
              + " ms/frame, the " + ("fp32" if f32 else "bf16") + " frame "
              + " / ".join(f"{m:.1f}" for m in out["twin"])
              + f" ms/frame; tiled at 100x100 (after a warm-up) "
              + " / ".join(f"{m:.1f}" for m in tiled[1:]) + " ms; the int8 "
              f"frame profiled: {wall / len(poses):.1f} ms/frame, idle "
              f"{idle:.4f}, kernels {kern:.3f} ms/frame: {split}",
              flush=True)
        del params, state
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--f32", action="store_true",
                    help="the fp32 kernel (papr_attend_eval_f32)")
    ap.add_argument("--int8", action="store_true",
                    help="the int8 kernel (papr_attend_eval_i8, with --f32 "
                         "papr_attend_eval_i8_f32)")
    ap.add_argument("--ab", metavar="TREE",
                    help="with --int8: TREE's int8 kernels whole")
    ap.add_argument("--frames", action="store_true",
                    help="with --ab: the int8_eval frames too")
    opts = ap.parse_args()
    f32, int8 = opts.f32, opts.int8
    if opts.ab:
        ab(TREE)
        return
    dev = torch.device("cuda", 0)
    walk = open(os.path.join(build.CSRC, "walk_wgmma.cuh")).read()
    # The fp32 kernel on wgmma where the tree has it, else the earlier one;
    # the int8 kernel's variants only on wgmma.
    on_wgmma = "wg_gemm_f32" in walk
    if int8:
        variants = Q8_VARIANTS if "wg_gemm_q8" in walk else Q8_VARIANTS[:1]
        entry = "papr_attend_eval_i8_f32" if f32 else "papr_attend_eval_i8"
        kern = "attend_eval_i8" + ("_wgmma_kernelIf" if f32
                                   else "_wgmma_kernelI13")
    else:
        variants = ((F32_VARIANTS if on_wgmma else F32_WMMA_VARIANTS) if f32
                    else VARIANTS)
        entry = "papr_attend_eval_f32" if f32 else "papr_attend_eval"
        kern = ("attend_eval_wgmma_kernelIf" if f32 and on_wgmma
                else "attend_eval_kernelIf" if f32 else "attend_eval_wgmma")
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="k3_ablate_")
    procs = {}
    for i, (name, subs) in enumerate(variants):
        src = os.path.join(root, str(i))
        shutil.copytree(build.CSRC, src)
        for f, old, new in subs:
            p = os.path.join(src, f)
            s = open(p).read()
            if old not in s:
                raise SystemExit(f"{name}: the line to replace is no longer in "
                                 f"{f}; bring VARIANTS up to date")
            open(p, "w").write(s.replace(old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-shared", "-o", src + ".so",
             os.path.join(src, "attend_eval.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {n: p.communicate()[0] for n, p in procs.items()}
    T = 32_400 if f32 else 25_600
    args = inputs(dev, T=T, cdt=torch.float32 if f32 else torch.bfloat16)
    extra = (True, _calibrated(args)) if int8 else ()
    want, _ = sa.attend_eval_plain(*args, *extra)
    print(f"{torch.cuda.get_device_name(0)}; T={args[1].shape[0]} "
          f"K={args[1].shape[1]}", flush=True)
    for i, (name, _) in enumerate(variants):
        if procs[name].returncode:
            print(f"{name}: build failed\n{logs[name][-3000:]}")
            continue
        lib = ctypes.CDLL(os.path.join(root, f"{i}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        build._lib = lib           # the wrapper loads this build
        got, _ = sa.attend_eval_idx(*args, *extra)
        err = float((got - want).norm() / want.norm())
        ms = _time(lambda: sa.attend_eval_idx(*args, *extra))
        lines = logs[name].splitlines()
        at = next((j for j, l in enumerate(lines)
                   if "Compiling entry function" in l and kern in l), 0)
        ptxas = [l.strip() for l in lines if "C75" in l]
        ptxas += [l.strip() for l in lines[at:at + 4]
                  if "spill" in l or "registers" in l]
        print(f"{name}: {ms:.3f} ms, fused rel "
              f"{err:.2e}; ptxas: {' | '.join(ptxas)}", flush=True)
        if (f32 or int8) and i == 0:
            del got
            big = inputs(dev, T=640_000,
                         cdt=torch.float32 if f32 else torch.bfloat16)
            extra_b = (True, _calibrated(big)) if int8 else ()
            print(f"whole kernel at T=640000 (an 800x800 frame): "
                  f"{_time(lambda: sa.attend_eval_idx(*big, *extra_b), 3):.3f}"
                  " ms", flush=True)
            del big, extra_b
            torch.cuda.empty_cache()
    build._lib = None
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
