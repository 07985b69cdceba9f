"""Where the culled top-k's stage 3 (K1, ``csrc/cull_topk.cu``) spends its
time, at the serving shape (the 800x800 orbit frame: 2500 tiles of 256
rays, M = 2048 candidates, chunk 512, early exit, k = 20) and at the
training shape (the 160x160 patch: 100 tiles, one 2048 chunk, no exit).

    python tools/torch_k1_ablate.py [--tree DIR] [--variants]
                                                     # needs a card and nvcc

Prints, on the flagship model (30,000 points, random weights):
  - the kernel alone at both shapes (CUDA events, 20 launches after a
    warm-up), and with ``--tree DIR`` the kernel of another checkout's
    ``cull_topk.cu`` on the same inputs (its C interface is this one's);
  - the candidates each tile scans before the early exit, as a histogram,
    with the exit tested after every chunk (the one-thread-a-ray kernel,
    the JAX kernel's granularity) and after every 64 (this kernel), computed
    from the data (``chip_smoke.cull_scanned``), and with ``--tree`` for
    that tree's one-thread-a-ray kernel (the design this one replaced, whose
    lines the counter patch matches) read from a copy of its sources with a
    debug counter (the shipped kernel has none); the
    bound recomputed from them (``chip_smoke.cull_bound``): the larger of
    the bytes of the candidate records read (five 4-byte rows a candidate,
    once a tile) with the rays, their scale and the output over 3.35 TB/s,
    and 9 fp32 operations a (ray, candidate) pair scanned over 67 TFLOP/s;
  - with ``--variants``, this kernel with one design choice changed at a
    time (a copy of ``cull_topk.cu`` with one line replaced, built alone;
    each still computes the same output, which is checked), at both shapes
    for k = 20 and 30;
  - the device time of the whole selection on the serving frame
    (``select_topk_culled``) by the operator that launched each kernel:
    stage 1 in torch, the sort, stage 2's gather of the (T, 8, M) records,
    K1.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from papr_tpu_torch.kernels import build  # noqa: E402
from papr_tpu_torch.ops import tile_cull as tc  # noqa: E402

# The debug counter: chunks scanned per tile, in a copy of --tree's
# one-thread-a-ray kernel (one thread a ray, an exit test after every chunk).
COUNT_PATCH = [
    ("namespace {\n", "namespace {\n__device__ int g_scanned[1 << 16];\n"),
    ("  const int n_chunks = M / chunk;\n",
     "  const int n_chunks = M / chunk;\n"
     "  if (r == 0) g_scanned[t] = n_chunks;\n"),
    ("      if (s_kth < lb_next) break;",
     "      if (s_kth < lb_next) {\n"
     "        if (r == 0) g_scanned[t] = c + 1;\n"
     "        break;\n      }"),
]
# One design choice of this kernel changed at a time.
_PEND = "        if (p < kth) pend[(n++) * blockDim.x + tid] = p;"
VARIANTS = [
    ("as built", []),
    ("exit tested every 128", [("constexpr int kStage = 64;",
                                "constexpr int kStage = 128;")]),
    ("no sorted head", [("  if (kSub >= kHead * S && M >= kHead * S) {",
                         "  if (kSub < 0) {")]),
    ("batches of 16 at every thread count", [("{ return 16 * S; }",
                                              "{ return 16; }")]),
    ("batches of 32 at every thread count", [("{ return 16 * S; }",
                                              "{ return 32; }")]),
    ("no batches (each insertion at once)",
     [(_PEND, "        if (p < kth) {\n          insert(best, p);\n"
              "          kth = kth_of(best, k);\n        }")]),
    ("one thread a ray everywhere", [("constexpr int kS = KMAX <= 32 ? 2 : 1;",
                                      "constexpr int kS = 1;")]),
    ("two threads a ray with the exit too",
     [("  if (!early_exit && kS == 2)", "  if (kS == 2)")]),
]
COUNT_READ = """
extern "C" int papr_cull_scanned(int* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_scanned, sizeof(int) * n);
}
"""


def build_one(src_dir: str, out: str, patch=None, extra: str = "") -> str:
    """cull_topk.cu of src_dir, patched, built alone into out (.so)."""
    d = tempfile.mkdtemp(prefix="k1_")
    shutil.copytree(src_dir, os.path.join(d, "csrc"))
    p = os.path.join(d, "csrc", "cull_topk.cu")
    s = open(p).read()
    for old, new in patch or ():
        if old not in s:
            raise SystemExit(f"the line to patch is no longer in {p}: "
                             f"{old!r}; bring COUNT_PATCH up to date")
        s = s.replace(old, new, 1)
    open(p, "w").write(s + extra)
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        out, p], capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {p}:\n{r.stdout[-3000:]}"
                         f"{r.stderr[-3000:]}")
    return r.stdout + r.stderr


def use(lib_path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(lib_path)
    lib.papr_cull_topk.argtypes = build.SIGNATURES["papr_cull_topk"]
    lib.papr_cull_topk.restype = ctypes.c_int
    build._lib = lib               # the wrapper launches this build
    return lib


def shapes(dev):
    """(name, (tiles, f, recs, chunk, early_exit)) at both shapes, and the
    serving frame's selection as a call."""
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    from papr_tpu_torch.model.papr import model_meta
    from papr_tpu_torch.ops.geometry import get_rays
    k = model_meta(cfg).select_k
    eps = float(cfg.eps)
    pts, alive = params["points"], state["alive"]
    c2w = torch.as_tensor(cs.orbit(0.0), device=dev)
    focal = torch.tensor([cs.FOCAL, cs.FOCAL], device=dev)
    rayo, rayd = get_rays(cs.H, cs.W, c2w, focal)
    serve = tc.cull_inputs(pts, alive, rayo[0], rayd, M=2048, block=16,
                           eps=eps, prefilter="packsort", early_exit=True)
    po, pd = cs.training_patch(dev)
    train = tc.cull_inputs(pts, alive, po[0], pd[0], M=2048, block=16,
                           eps=eps, prefilter="approx", early_exit=True)
    select = lambda: tc.select_topk_culled(pts, alive, rayo[0], rayd, k,
                                           M=2048, block=16, eps=eps,
                                           prefilter="packsort")
    return k, (("serving", serve[:5]), ("training", train[:5])), select


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", help="another checkout whose K1 to time too")
    ap.add_argument("--variants", action="store_true",
                    help="this kernel with one design choice changed")
    a = ap.parse_args()
    dev = torch.device("cuda", 0)
    k, cases, select = shapes(dev)
    root = tempfile.mkdtemp(prefix="k1_ablate_")
    print(f"{torch.cuda.get_device_name(0)}; k={k}", flush=True)

    builds = [("this tree", build.CSRC)]
    if a.tree:
        builds.append((a.tree, os.path.join(a.tree, "papr_tpu_torch", "csrc")))
    for i, (label, src) in enumerate(builds):
        use_path = os.path.join(root, f"{i}.so")
        build_one(src, use_path)
        use(use_path)
        for name, (tiles, f, recs, chunk, ee) in cases:
            got = tc.cull_select(tiles, f, recs, k, chunk, ee)
            want = tc.cull_select_plain(tiles, f, recs, k, chunk, ee)
            same = bool(torch.equal(got, want))
            ms = cs.cuda_ms(lambda: tc.cull_select(tiles, f, recs, k, chunk,
                                                   ee), 20)
            print(f"K1 {label}, {name}: tiles={tuple(tiles.shape)} "
                  f"M={recs.shape[-1]} chunk={chunk} early_exit={ee}: "
                  f"{ms:.4f} ms; output equal to the plain version {same}",
                  flush=True)

    if a.variants:
        for i, (label, patch) in enumerate(VARIANTS):
            path = os.path.join(root, f"v{i}.so")
            build_one(build.CSRC, path, patch)
            use(path)
            out = []
            for name, (tiles, f, recs, chunk, ee) in cases:
                for kk in (k, 30):
                    same = bool(torch.equal(
                        tc.cull_select(tiles, f, recs, kk, chunk, ee),
                        tc.cull_select_plain(tiles, f, recs, kk, chunk, ee)))
                    ms = cs.cuda_ms(lambda: tc.cull_select(
                        tiles, f, recs, kk, chunk, ee), 20)
                    out.append(f"{name} k={kk} {ms:.4f} ms (equal {same})")
            print(f"variant {label}: " + "; ".join(out), flush=True)

    # Candidates scanned per tile, from the data.
    for name, (tiles, f, recs, chunk, ee) in cases:
        M = recs.shape[-1]
        for step in (chunk, cs.K1_STAGE):
            sc = cs.cull_scanned(tiles, f, recs, k, step, ee)
            b = cs.cull_bound(tiles, f, recs, k, sc)
            print(f"candidates a tile scans, {name}, exit tested every "
                  f"{step}: {cs.cull_histogram(sc, step, M)} tiles at {step}, "
                  f"{2 * step}, ..; mean {sum(sc) / len(sc):.1f}; bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    # Chunks scanned per tile by --tree's one-thread-a-ray kernel, with a
    # debug counter.
    if a.tree:
        cpath = os.path.join(root, "count.so")
        build_one(os.path.join(a.tree, "papr_tpu_torch", "csrc"), cpath,
                  COUNT_PATCH, COUNT_READ)
        lib = use(cpath)
        lib.papr_cull_scanned.argtypes = [ctypes.c_void_p, ctypes.c_int]
        for name, (tiles, f, recs, chunk, ee) in cases:
            tc.cull_select(tiles, f, recs, k, chunk, ee)
            torch.cuda.synchronize()
            T = tiles.shape[0]
            buf = (ctypes.c_int * T)()
            build.check(lib.papr_cull_scanned(buf, T), "papr_cull_scanned")
            scanned = list(buf)
            n_ch = recs.shape[-1] // chunk
            hist = [scanned.count(c) for c in range(1, n_ch + 1)]
            b = cs.cull_bound(tiles, f, recs, k, [c * chunk for c in scanned])
            print(f"chunks scanned a tile by the earlier kernel, {name} "
                  f"(1..{n_ch} of {chunk}): {hist}; mean "
                  f"{sum(scanned) / T:.3f}; bound from them {b['bound_ms']:.4f} ms ({b['bound_by']})",
                  flush=True)
    build._lib = None

    # The serving frame's selection by launching operator.
    select()
    print("selection, serving frame, device time by operator: "
          + cs.kernels_by_op(select, "", 16), flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
