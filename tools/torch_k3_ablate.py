"""Which part of the bf16 one-shot eval attention holds its time: the kernel
(``csrc/attend_eval.cu attend_eval_wgmma_kernel``) timed whole and with one
part taken out at a time, on phase 2's shapes (25,600 rays, K = 20, 30,000
points, the flagship's walks with random weights).

    python tools/torch_k3_ablate.py          # needs a card and nvcc

Each variant is a copy of the CUDA sources with one line replaced, built
alone (``attend_eval.cu``) and loaded in place of the library; the wrapper
and its inputs are the same for all. A variant computes the wrong function
(its error against the plain version is printed): it is a timing probe, not
a kernel. Prints one line a variant: ms per launch (CUDA events, 5 launches
after a warm-up), the error, ptxas's spill and wgmma lines.
"""

import ctypes
import math
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

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


def inputs(dev, T=25_600, K=20, P=30_000, dm=256, seed=2):
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
            "relu", 5.0, True, 1e-6, torch.bfloat16)


def main() -> None:
    dev = torch.device("cuda", 0)
    nvcc = build._nvcc()
    root = tempfile.mkdtemp(prefix="k3_ablate_")
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS):
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
    args = inputs(dev)
    want, _ = sa.attend_eval_plain(*args)
    print(f"{torch.cuda.get_device_name(0)}; T={args[1].shape[0]} "
          f"K={args[1].shape[1]}", flush=True)
    for i, (name, _) in enumerate(VARIANTS):
        if procs[name].returncode:
            print(f"{name}: build failed\n{logs[name][-3000:]}")
            continue
        lib = ctypes.CDLL(os.path.join(root, f"{i}.so"))
        lib.papr_attend_eval.argtypes = build.SIGNATURES["papr_attend_eval"]
        lib.papr_attend_eval.restype = ctypes.c_int
        build._lib = lib           # the wrapper loads this build
        got, _ = sa.attend_eval_idx(*args)
        err = float((got - want).norm() / want.norm())
        for _ in range(2):
            sa.attend_eval_idx(*args)
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(5):
            sa.attend_eval_idx(*args)
        b.record()
        torch.cuda.synchronize()
        lines = logs[name].splitlines()
        at = next(j for j, l in enumerate(lines)
                  if "Compiling entry function '_Z24attend_eval_wgmma" in l)
        ptxas = [l.strip() for l in lines if "C75" in l]
        ptxas += [l.strip() for l in lines[at:at + 4] if "spill" in l]
        print(f"{name}: {a.elapsed_time(b) / 5:.3f} ms, fused rel "
              f"{err:.2e}; ptxas: {' | '.join(ptxas)}", flush=True)
    build._lib = None
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
