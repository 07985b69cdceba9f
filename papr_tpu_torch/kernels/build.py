"""Build the CUDA kernels under ``papr_tpu_torch/csrc`` and load them.

The sources have a plain C interface; ``nvcc`` compiles each ``.cu`` for
``sm_90a`` (Hopper) into an object, all sources at once in parallel, and
links the objects into one shared library on first use, in
``papr_tpu_torch/_build/`` (git-ignored), named by a hash of the sources and
flags so an edit rebuilds. The library is loaded with ``ctypes``; pointers
and the CUDA stream travel as ``c_void_p``. Nothing is built at import time.

    python -m papr_tpu_torch.kernels.build      # build, print ptxas stats
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the exported launchers (each returns a cudaError_t, or a
# negative code for an argument the kernel does not take).
SIGNATURES = {
    "papr_cull_topk": [P, P, P, I, I, I, I, I, I, P, P],
    "papr_fused_mlp_fwd": [P, I, I, P, P, P, P, P, P, P],
    "papr_attend_eval_f32": [P, I, P, I, I, P, P, P, I, F, P, P, P, P, P, P,
                             P, I, P, P, P, P, P, I, F, I, F, P, P, P],
    "papr_fused_mlp_bwd": [P, I, I, P, P, P, P, P, P, P, P, P, P, P, P, I, P,
                           P],
    "papr_wgrad": [P, P, I, I, I, I, P, P, P],
    "papr_colsum": [P, I, I, P, P],
    "papr_key_stream_fwd": [P, I, I, I, P, P, P, I, F, P, P, P, P, P, P, P, I,
                            I, F, F, P, P, P, P],
    "papr_key_stream_bwd": [P, I, I, I, P, P, P, I, F, P, P, P,   # ..dattn
                            P, P, P, P, P, P, I, I, F, F,  # ..eps
                            P, P, P, I, P, P, P, P, P, I, P, P],
    "papr_value_stream_fwd": [P, I, I, I, P, P, P, P, P, P, P, P, I, F, P, P],
    "papr_value_stream_bwd": [P, I, I, I, P, P, P, P, P, P, P, P, P, I, F,
                              P, P, P, I, P, P, P, P, P, I, P, P],
    "papr_key_stream_q_fwd": [P, I, I, I, P, P, P, I, F] + [P] * 14    # ..bq
                             + [I, I, F, F] + [P] * 5,
    "papr_key_stream_q_bwd": [P, I, I, I, P, P, P, P, I, F, P, P, P]  # ..dattn
                             + [P] * 16 + [I, I, F, F]                # ..eps
                             + [P] * 4 + [P, I, P] + [P] * 5          # ..dqq
                             + [P, I, P, P, I, P, P],
    "papr_key_stream_feat_fwd": [P, I, I, I, P, I, F, P, P] + [P] * 7
                                + [I, I, F] + [P] * 3,
    "papr_key_stream_feat_bwd": [P, I, I, I, P, I, F, P, P, P, P] + [P] * 9
                                + [I, I, F] + [P] * 7 + [I, P, P],
    "papr_value_stream_feat_fwd": [P, I, I, I, P] + [P] * 5 + [I, P, P],
    "papr_value_stream_feat_bwd": [P, I, I, I, P, P] + [P] * 6 + [I]
                                  + [P] * 6 + [I, P, P],
    "papr_topk_stream": [P, P, P, P, I, I, I, I, P, P],
    "papr_int8_walk_bench": [I, P, I, F] + [P] * 10,
    "papr_fused_scores_fwd": [P] * 8 + [I] * 8 + [F, F, I, P, P, P],
    "papr_fused_scores_bwd": [P] * 8 + [I] * 8 + [F, F, I] + [P] * 10,
}

# The fp32 forms take their bf16 twin's arguments (pointers to fp32 weights,
# stashes and outputs where the bf16 form has bf16 ones); the fused scores'
# fp32 forms add the (T, pdm) fp32 qq buffer before the stream.
for _name in ("papr_fused_mlp_fwd", "papr_fused_mlp_bwd",
              "papr_key_stream_fwd", "papr_key_stream_bwd",
              "papr_value_stream_fwd", "papr_value_stream_bwd",
              "papr_key_stream_feat_fwd", "papr_key_stream_feat_bwd",
              "papr_value_stream_feat_fwd", "papr_value_stream_feat_bwd",
              "papr_fused_scores_fwd", "papr_fused_scores_bwd"):
    _stem, _dir = _name.rsplit("_", 1)
    SIGNATURES[f"{_stem}_f32_{_dir}"] = SIGNATURES[_name]
for _dir in ("fwd", "bwd"):
    _sig = SIGNATURES[f"papr_fused_scores_f32_{_dir}"]
    SIGNATURES[f"papr_fused_scores_f32_{_dir}"] = _sig[:-1] + [P, P]
# The one-shot eval attention (bf16 and fp32, both on wgmma) takes the int8
# tile function's arguments, then its packed weights and their size in
# bytes.
_ATTEND = SIGNATURES["papr_attend_eval_f32"]
SIGNATURES["papr_attend_eval"] = _ATTEND[:-1] + [P, I, P]
SIGNATURES["papr_attend_eval_f32"] = _ATTEND[:-1] + [P, I, P]
SIGNATURES["papr_wgrad_f32"] = SIGNATURES["papr_wgrad"]
# The int8 stream forwards' stem: the stream forwards' arguments before
# their wgmma tail.
_I8_STEM = {_name: SIGNATURES[_name][:-1] for _name in
            ("papr_key_stream_fwd", "papr_value_stream_fwd")}
# The stream forwards and the embedder (bf16 and fp32, all on wgmma) take
# the WMMA forms' arguments, then their packed weights, its size in bytes
# and the grid; the stream backwards (bf16 and fp32, both on wgmma, their
# weights read only from the packed image) the same, then three device
# buffers (per-ray sums of split tiles; the value's datt rows).
for _name in ("papr_key_stream_fwd", "papr_value_stream_fwd",
              "papr_key_stream_f32_fwd", "papr_value_stream_f32_fwd",
              "papr_fused_mlp_fwd", "papr_fused_mlp_bwd",
              "papr_fused_mlp_f32_fwd", "papr_fused_mlp_f32_bwd"):
    SIGNATURES[_name] = SIGNATURES[_name][:-1] + [P, ctypes.c_longlong, I, P]
for _name in ("papr_key_stream_bwd", "papr_value_stream_bwd",
              "papr_key_stream_f32_bwd", "papr_value_stream_f32_bwd"):
    SIGNATURES[_name] = SIGNATURES[_name][:-1] + [P, ctypes.c_longlong, I, P,
                                                  P, P, P]
# The fp32 folded key stream (on wgmma). Forward: the bf16 form's arguments
# without w_k and w_q (the images hold them), then the key's packed weights
# and their size in bytes, the query's and theirs, the grid and the stream.
# Backward: the query's half alone (papr_key_stream_f32_bwd runs the key's
# first): rayd, T, d_model, the query walk, dm_pad, its stash, the posenc
# segments, dqq, d_rayd, the partial rows and scratch, the packed weights,
# their size in bytes, the grid and the stream.
_LL = ctypes.c_longlong
SIGNATURES["papr_key_stream_q_f32_fwd"] = (
    [P, I, I, I, P, P, P, I, F] + [P] * 12 + [I, I, F, F] + [P] * 4
    + [P, _LL, P, _LL, I, P])
SIGNATURES["papr_key_stream_q_f32_bwd"] = (
    [P, I, I] + [P] * 5 + [I] + [P] * 6 + [I, P, P, _LL, I, P])
# The fp32 feature stream forwards (on wgmma) take the bf16 forms'
# arguments before the stream, then (key) the (T, K) masked scores, the
# packed weights, their size in bytes, the grid and the stream.
SIGNATURES["papr_key_stream_feat_f32_fwd"] = (
    SIGNATURES["papr_key_stream_feat_fwd"][:-1] + [P, P, ctypes.c_longlong,
                                                   I, P])
SIGNATURES["papr_value_stream_feat_f32_fwd"] = (
    SIGNATURES["papr_value_stream_feat_fwd"][:-1] + [P, ctypes.c_longlong, I,
                                                     P])

# The int8 stream forwards take the wgmma forms' arguments before their
# wgmma tail, then the walk's int8 weights, inverse-scale rows and dequant
# rows, then the stream; the ``_i8_f32`` forms (the fp32 epilogue) the same.
# The int8 eval attention (on wgmma, both epilogues) takes the eval
# attention's arguments before its packed weights, then the key's and the
# value's inverse-scale and dequant rows, then its packed weights (the int8
# image), their size in bytes and the stream.
for _name in ("papr_key_stream", "papr_value_stream"):
    for _i8 in ("_i8", "_i8_f32"):
        SIGNATURES[_name + _i8 + "_fwd"] = _I8_STEM[_name + "_fwd"] + [P] * 4
for _i8 in ("_i8", "_i8_f32"):
    SIGNATURES["papr_attend_eval" + _i8] = _ATTEND[:-1] + [P] * 4 + [P, I, P]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from papr_tpu_torch/csrc on first use")
    return found


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libpapr_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if this source set has not been built yet;
    returns its path. The compiler's ptxas report lands beside it."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(cu)}.o" for cu in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, cu] for cu, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-shared", "-o", f"{tmp}.so", *objs]
    res = (subprocess.run(link, capture_output=True, text=True)
           if all(p.returncode == 0 for p in procs) else None)
    with open(out[:-3] + ".log", "w") as f:
        for c, log in zip(cmds, logs):
            f.write(" ".join(c) + "\n" + log)
        if res is not None:
            f.write(" ".join(link) + "\n" + res.stdout + res.stderr)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [(c[-1], log) for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{src}:\n{log[-4000:]}" for src, log in failed))
    if res.returncode != 0:
        raise RuntimeError(f"link failed:\n{res.stderr[-4000:]}")
    os.replace(f"{tmp}.so", out)
    return out


def load() -> ctypes.CDLL:
    """Build on first use and load the library (once per process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, args in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported an error (it returns cudaGetLastError()
    right after the launch, so a refused launch surfaces here)."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")


if __name__ == "__main__":
    path = build()
    print(path)
    with open(path[:-3] + ".log") as f:
        sys.stdout.write(f.read())
