"""Where the bf16 stream forwards spend their time: the key and value stream
forwards (``csrc/key_stream.cu`` / ``csrc/value_stream.cu``,
``papr_key_stream_fwd`` / ``papr_value_stream_fwd``) timed whole, on both
grids where the tree has the persistent one, and with one part taken out at
a time, on phase 2's shapes (T = 25,600 rays, K = 20, 30,000 points, the
flagship's walks with random weights; the inputs of
``tools/torch_stream_bwd_ablate.py``).

    python tools/torch_stream_fwd_ablate.py [--tree DIR] [--split-only]

``--tree`` takes the sources and the package from another checkout (for
example an unpacked parent commit, whose bf16 forwards are the WMMA
kernels: only their whole-call and kernel-alone times are read). Each
variant is a copy of the CUDA sources with lines replaced, built alone
(``key_stream.cu``, ``value_stream.cu``, ``wgrad.cu``) and loaded in place
of the library; the wrapper and its inputs are the same for all. A variant
computes the wrong function (its error against the sound build is printed):
it is a timing probe, not a kernel. Prints one line a variant: the kernel
alone (its ``torch.profiler`` span: the wgmma kernel and, for the key, the
softmax kernel after it; 3 calls after a warm-up), the whole call (CUDA
events), the error, and ptxas's spill lines.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from torch_stream_bwd_ablate import (_BODY, _MMA, _REFILL, _WAIT,  # noqa: E402
                                     _split, inputs)

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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--split-only", action="store_true")
    opt = ap.parse_args()
    tree = os.path.abspath(opt.tree)
    sys.path.insert(0, tree)
    import torch
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; tree {tree}", flush=True)
    key, value = inputs(dev)
    key, value = key[:7] + key[10:], value[:5] + value[6:]
    T = key[0].shape[1]
    cases = (("key", "key_fwd", lambda: sa.key_stream_fwd(*key)),
             ("value", "value_fwd", lambda: [sa.value_stream_fwd(*value)]))
    # The grid rule: fused_mlp's, or stream_attn's on an older tree.
    rule = next((m for m in (fm, sa) if hasattr(m, "wgmma_grid")), None)
    grids = [("", None)]
    if rule is not None:
        tiles = -(-T // 128)
        grids = [(f" (grid {rule.wgmma_grid(T)}: persistent)", None),
                 (f" (grid {tiles}: one block a tile)", tiles)]
    sound = {}
    for label, grid in grids:
        real = getattr(rule, "wgmma_grid", None)
        if grid is not None:
            rule.wgmma_grid = lambda T: grid
        for what, pat, fn in cases:
            sound.setdefault(what, [g.clone() for g in fn()])
            k_ms, _, o_ms, whole = _split(fn, pat)
            print(f"{what} stream forward{label}, whole call {whole:.3f} ms: "
                  f"kernel alone {k_ms:.3f}, other device kernels "
                  f"{o_ms:.3f}, host / gaps {whole - k_ms - o_ms:.3f}",
                  flush=True)
        if real is not None:
            rule.wgmma_grid = real
    csrc = os.path.join(tree, "papr_tpu_torch", "csrc")
    if opt.split_only or not os.path.exists(os.path.join(csrc,
                                                         "walk_wgmma.cuh")):
        return
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="stream_fwd_ablate_")
    wg_obj = os.path.join(root, "wgrad.o")
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-c", "-o", wg_obj,
                    os.path.join(csrc, "wgrad.cu")], check=True,
                   capture_output=True)
    procs, runs = {}, []
    for i, (name, subs) in enumerate(VARIANTS):
        src = os.path.join(root, str(i))
        shutil.copytree(csrc, src)
        missing = False
        for f, old, new in subs:
            p = os.path.join(src, f)
            s = open(p).read()
            if s.count(old) != 1:
                missing = True
                break
            open(p, "w").write(s.replace(old, new))
        if missing:
            print(f"{name}: skipped (its lines are not in this tree's "
                  f"sources once)", flush=True)
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
        for fname in ("papr_key_stream_fwd", "papr_value_stream_fwd"):
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
