"""Plant faults, one at a time, in a copy of the CUDA sources and read what
the kernel-against-plain comparisons make of each.

    python tools/torch_plant_faults.py [word ...]     # needs a card and nvcc

With words, only the sound case and the cases whose name holds one of them.

For the sound sources and for each fault: the package, ``chip_smoke.py``, the
configs and the tests are copied into a temporary directory, one line of
a CUDA source under ``csrc/`` is replaced there, the
kernels are rebuilt, and ``chip_smoke.compare_cli_kernels`` (the flagship
patch) and the small-shape ``cuda`` tests of those kernels run on the copy.
The readings are how the comparisons' bounds were set between the sound
kernels and the weakest fault caught (PERF.md, Findings). The repository's
own sources are never touched.
"""

import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, the line to replace, its replacement); the first case is the sound
# sources. Cases named "topk" patch topk_stream.cu, "embedder bwd"
# fused_mlp_bwd.cu, "encoding" walk.cuh, the others fused_attn.cu.
MUTS = [
    ("sound", None, None),
    ("bwd: relu mask dropped",
     "        if (a.relu && !(sact > 0.f)) d_sact = 0.f;\n", ""),
    ("bwd: score scale off by 10 %",
     "        row[k] = d_sact * a.rsqrt_dm;",
     "        row[k] = d_sact * a.rsqrt_dm * 1.1f;"),
    ("bwd: background term of the softmax dropped",
     "      float inner = (eb / z) * dat[a.K];", "      float inner = 0.f;"),
    ("bwd: dqq misses the last k",
     "          dqq[i][j] += dr * kk;",
     "          if (k + 1 < a.K) dqq[i][j] += dr * kk;"),
    ("bwd: db_k from the rounded dkk (a rounding point)",
     "          dbk[j] += dkk;", "          dbk[j] += bf16_round(dkk);"),
    ("fwd+bwd: projection not rounded before the bias (a rounding point)",
     "  return bf16_round(bf16_round(acc) + bf16_round(bias));",
     "  return bf16_round(acc + bf16_round(bias));"),
    ("fwd+bwd: score scale off by 1 %",
     "      if (lane == 0) sS[r * kSLd + k] = acc * a.rsqrt_dm;",
     "      if (lane == 0) sS[r * kSLd + k] = acc * a.rsqrt_dm * 1.01f;"),
    ("fwd+bwd: bias b_k left out",
     "               linear_out(s.C[r * kCLd + c], a.bk[c]);",
     "               linear_out(s.C[r * kCLd + c], 0.f);"),
    ("embedder bwd: dx of raw columns 6 and up scaled by 1.05",
     "    if (row < R) dx[(size_t)row * d_raw + src] = v;",
     "    if (row < R) dx[(size_t)row * d_raw + src] = src >= 6 ? v * 1.05f : v;"),
    ("embedder bwd: dx of raw columns 6 and up scaled by 1.01",
     "    if (row < R) dx[(size_t)row * d_raw + src] = v;",
     "    if (row < R) dx[(size_t)row * d_raw + src] = src >= 6 ? v * 1.01f : v;"),
    ("encoding: un-encoded (pass-through) columns scaled by 1.01, fwd + bwd",
     "  if (kind == 0) return x;", "  if (kind == 0) return x * 1.01f;"),
    ("topk: one point of the first chunk skipped",
     "    for (int j = 0; j < n; ++j) {\n      const float tt",
     "    for (int j = 0; j < n - (base == 0); ++j) {\n      const float tt"),
    ("topk: distance formed with a fused multiply-add",
     "          fmaxf(__fsub_rn(svv[j], __fmul_rn(__fmul_rn(tt, tt), f)), 0.f);",
     "          fmaxf(fmaf(-__fmul_rn(tt, tt), f, svv[j]), 0.f);"),
]
RUN = r'''
import sys
sys.path.insert(0, ".")
import chip_smoke as cs, torch
cs.fail = lambda m: print("FAILS:", m)
dev = torch.device("cuda", 0)
cfg = cs.flagship_cfg()
params, state = cs.build_model(cfg, dev)
cs.compare_cli_kernels(params, state, cfg, dev, n_time=1)
'''


def main() -> None:
    words = sys.argv[1:]
    for name, old, new in MUTS:
        if old is None or not words or any(w in name for w in words):
            run_case(name, old, new)


def run_case(name, old, new) -> None:
    root = tempfile.mkdtemp(prefix="mut_")
    skip = shutil.ignore_patterns("_build", "__pycache__")
    for d in ("papr_tpu_torch", "configs", "tests"):
        shutil.copytree(os.path.join(REPO, d), os.path.join(root, d),
                        ignore=skip)
    for f in ("chip_smoke.py", "pytest.ini"):
        shutil.copy(os.path.join(REPO, f), root)
    if old is not None:
        src = next((f for word, f in (("topk", "topk_stream.cu"),
                                      ("embedder bwd", "fused_mlp_bwd.cu"),
                                      ("encoding", "walk.cuh"))
                    if word in name), "fused_attn.cu")
        p = os.path.join(root, "papr_tpu_torch", "csrc", src)
        s = open(p).read()
        if old not in s:
            raise SystemExit(f"{name}: the line to replace is no longer in "
                             f"{src}; bring MUTS up to date")
        open(p, "w").write(s.replace(old, new))
    print(f"===== {name}", flush=True)
    r = subprocess.run([sys.executable, "-c", RUN], cwd=root,
                       capture_output=True, text=True)
    for line in r.stdout.splitlines():
        if line.startswith(("phase 2 topk", "phase 2 fused_scores",
                            "phase 2 fused_mlp", "FAILS")):
            print("  " + line[:1300], flush=True)
    if r.returncode:
        print("  rc", r.returncode, r.stderr[-1500:], flush=True)
    t = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py", "-k",
         "fused_scores or topk_stream or key_value_stacks", "--tb=line"],
        cwd=root, capture_output=True, text=True)
    for line in t.stdout.splitlines():
        if "Error" in line:
            print("  cuda tests: " + line[:400], flush=True)
    print(f"  cuda tests: exit code {t.returncode}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
