"""Plant faults, one at a time, in a copy of the CUDA sources and read what
the kernel-against-plain comparisons make of each.

    python tools/torch_plant_faults.py [word ...]     # needs a card and nvcc

With words, only the cases whose name holds one of them, and the sound
sources for the comparisons those cases need.

For the sound sources and for each fault: the package, ``chip_smoke.py``, the
configs and the tests are copied into a temporary directory, one line of
a CUDA source under ``csrc/`` is replaced there, the
kernels are rebuilt, and the phase-2 comparison that holds the kernel
(``chip_smoke.compare_cli_kernels``; for the cases named "stream",
``chip_smoke.compare_train_kernels``; for those named "int8",
``chip_smoke.compare_int8_kernels``; the flagship patch; for those named
"fp32", ``chip_smoke.compare_f32_kernels`` on Caterpillar's model and patch
(for "fp32 fwd wgmma" and "fp32 bwd wgmma", its comparisons up to the fp32
stream rows only: that run stops before phase 8's closing "FAILS" line, so
a comparison that fails shows as a reading above its "need <=" bound); for
those named "wgmma", ``chip_smoke.compare_wgmma_kernels``: K3 on the
eval block, ``wgrad`` / ``wgrad_f32`` at phase 2's / phase 8's shapes; for
those named "embed wgmma", ``chip_smoke.compare_embed_kernels``: the bf16
embedder forward and backward on wgmma, and with them the other
comparisons whose kernels run the planted line, on the same build; for
"fp32 embed wgmma", ``chip_smoke.compare_f32_kernels`` up to the fp32
embedder's rows 2f / 3f on the query stack; for "int8 K3 wgmma",
``chip_smoke.compare_int8_kernels`` up to the int8 K3 (row 4q); for "bf16
keyf wgmma", ``chip_smoke.compare_train_kernels``, read for row 8's bf16
forward on its dead slots; for "fp32 scores wgmma",
``chip_smoke.compare_f32_kernels`` up to row 10f's forward, its dead slots
and its narrow case after NaN-filled shared memory)
and the small-shape ``cuda`` tests of those kernels run on the copy.
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
# (name, the line to replace, its replacement); the first cases are the sound
# sources. Cases named "topk" patch topk_stream.cu, "embedder bwd"
# embed_wgmma.cuh, "encoding" walk.cuh, "stream feat key" key_stream_feat.cu,
# "stream feat value" value_stream_feat.cu, "stream q" key_stream_q.cu (the
# bf16 folded key stream's WMMA backward), "bf16 keyq wgmma head"
# embed_wgmma.cuh (row 7's bf16 query head), "bf16 keyq wgmma walk" and
# "bf16 feat fwd wgmma" walk_wgmma.cuh,
# "stream shared" or "linear_bf16" stream_common.cuh, "int8 walk" walk.cuh,
# "int8 bench" int8_walk_bench.cu, "int8 value" value_stream.cu, "int8
# attend" attend_eval.cu, "int8 K3 wgmma pack" ops/fused_mlp.py (the int8
# image's permutation), "int8 K3 wgmma walk" walk_wgmma.cuh, "int8 K3 wgmma
# quantize" walk.cuh, "int8 K3 wgmma attend" attend_eval.cu, "fp32 walk"
# walk.cuh, "fp32 stash" walk_bwd.cuh,
# "wgmma wgrad" wgrad.cu, "wgmma walk" (with "fp32 wgmma walk", the fp32
# form), "bwd wgmma walk" and "fwd wgmma"
# (the bf16 stream forwards, on K3's walk) walk_wgmma.cuh, "bwd wgmma"
# walk_wgmma_bwd.cuh (the bf16 stream backwards; "fp32 bwd wgmma" the fp32
# ones), "wgmma attend"
# attend_eval.cu, "embed wgmma bwd" walk_wgmma_bwd.cuh, "embed wgmma"
# walk_wgmma.cuh, "fp32 embed wgmma fwd" / "bwd" embed_wgmma.cuh, "fp32
# embed wgmma walk" walk_wgmma.cuh, "fp32 embed wgmma stash" and "fp32
# embed wgmma rev" walk_wgmma_bwd.cuh, "fp32 keyq wgmma combine"
# key_stream.cu, "fp32 keyq wgmma walk" walk_wgmma.cuh, the other "fp32
# keyq wgmma" embed_wgmma.cuh (row 7f: the query head and the embedder's
# sink), "bf16 keyf wgmma" and "fp32 scores wgmma walk" walk_wgmma.cuh (row
# 8's token mask, the w_k heads' biases), the others fused_attn.cu (row
# 10f's staging, query head and mask among them). A fourth element names every
# comparison (TARGETS) that reads the case's build, where the planted line
# runs in more than one kernel; the sound sources run once, read by every
# comparison the picked cases need.
# The fp32 wgmma walk's three products of a k8 step (walk_wgmma.cuh).
_F32_WG_PRODUCTS = (
    "          wgmma_rs_tf32_n64(f, al[s][0], al[s][1], al[s][2], al[s][3],\n"
    "                            dh + kk, s > 0);\n"
    "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
    "                            dl + kk, 1);\n"
    "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
    "                            dh + kk, 1);\n")
# Their join into the layer's accumulator after each 32-deep chunk.
_F32_WG_JOIN = (
    "        }\n"
    "        wgmma_commit();\n"
    "        wgmma_wait<0>();\n"
    "        reg_fence(f);\n"
    "#pragma unroll\n"
    "        for (int i = 0; i < kF32PassN / 2; ++i)\n"
    "          acc[32 * p + i] = __fadd_rn(acc[32 * p + i], f[i]);\n")
# The fp32 reverse walk's header and product (walk_wgmma_bwd.cuh wgb_rev),
# and wg_gemm_f32 (walk_wgmma.cuh) with its products accumulated in the
# tensor cores' own accumulator across the whole K, renamed: a fault only in
# the fp32 backwards' reverse products (dz_l W_l^T).
_F32_REV = (
    "// The fp32 form's reverse walk from the gradient of the walk's output (in\n"
    "// acc): the last layer's epilogue, then per layer l the product dz_l W_l^T\n"
    "// (rev: the W_l^T layers from l = n - 1 down) and layer l - 1's epilogue;\n"
    "// layer 0's product, the encoding's gradient, goes to the warp's rows of E.\n"
    "__device__ __forceinline__ void wgb_rev(float (&acc)[kOutRegs], WgRowsA& A,\n"
    "                                        WgRing& rg, const unsigned char*,\n"
    "                                        const WalkDesc& d, const WgLayer* rev,\n"
    "                                        float* const* dz, const int* b_off,\n"
    "                                        float* prow, size_t srow0,\n"
    "                                        const uint32_t* masks, float*, bool,\n"
    "                                        float*, int) {\n"
    "  const int n = d.n;\n"
    "  rev_epilogue(acc, A, d.last_act == 1 ? masks + (n - 1) * 512 : nullptr,\n"
    "               d.pd[n], prow + b_off[n - 1], dz[n - 1], srow0);\n"
    "  for (int l = n - 1; l >= 0; --l) {\n"
    "    wg_gemm_f32(acc, A.E, A.row0, rg, rev[n - 1 - l]);\n")


def _f32_gemm_own_acc(name: str) -> str:
    """wg_gemm_f32's text (walk_wgmma.cuh) as ``name``, its products
    accumulated in the tensor cores' own accumulator across the whole K."""
    src = open(os.path.join(REPO, "papr_tpu_torch", "csrc",
                            "walk_wgmma.cuh")).read()
    head = "__device__ __forceinline__ void wg_gemm_f32("
    body = src[src.index(head):src.index("\n}\n", src.index(head)) + 3]
    for old, new in ((_F32_WG_PRODUCTS, _F32_WG_PRODUCTS.replace(
            "dh + kk, s > 0);", "dh + kk, s > 0 || sub > 0 || c > 0);")),
                     (_F32_WG_JOIN, _F32_WG_JOIN.replace(
                         "__fadd_rn(acc[32 * p + i], f[i])", "f[i]"))):
        assert body.count(old) == 1, "bring _F32_WG_* up to date"
        body = body.replace(old, new)
    return body.replace("void wg_gemm_f32(", f"void {name}(") + "\n"


# The fp32 stream forwards' value fuse (walk_wgmma.cuh stream_fwd_wg).
_F32_FWD_FUSE = ("              if (c1 < cout) arow[c1] += a * "
                 "act_round<Op>(acc[i]);")
# The bf16 query head's two stores (embed_wgmma.cuh wg_head_rows, bf16).
_HEAD_V0 = "        const float v0 = linear_bf16(acc[4 * j + 2 * h], hb[c]);\n"
_HEAD_V1 = ("        if (pairs) {\n"
            "          const float v1 = linear_bf16(acc[4 * j + 2 * h + 1], "
            "hb[c + 1]);\n")


MUTS = [
    ("embed wgmma: the second weight chunk read from the first one's stage "
     "(a stale stage)",
     "        real ? ring.base + st * kWStageBytes : zero, 16, 1024);",
     "        real ? ring.base + (ring.i == 1 ? 0 : st) * kWStageBytes : zero, "
     "16, 1024);", ("embed", "stream_fwd", "stream_bwd")),
    ("embed wgmma: the output LayerNorm with the biased variance (the "
     "forward walk's: K2, K3, the stream forwards)",
     "    const float var = quad_sum(v) / (float)(n_true > 1 ? n_true - 1 : "
     "1);",
     "    const float var = quad_sum(v) / (float)n_true;",
     ("embed", "stream_fwd", "compare_wgmma_kernels")),
    ("embed wgmma: activations rounded to bf16 before the bias (a rounding "
     "point; every wgmma forward walk and recompute)",
     "      float v0 = acc[4 * j + 2 * h] + b.x;",
     "      float v0 = bf16_round(acc[4 * j + 2 * h]) + b.x;",
     ("embed", "stream_fwd", "stream_bwd", "compare_wgmma_kernels")),
    ("embed wgmma bwd: db summed from the bf16-rounded dz instead of the "
     "fp32 dz (a rounding point)",
     "  colsum_pass([&](int i) { return acc[i]; }, part_db + c0, width - c0);",
     "  colsum_pass([&](int i) { return bf16_round(acc[i]); }, part_db + c0, "
     "width - c0);", ("embed", "stream_bwd")),
    ("embed wgmma: posenc with sin and cos swapped (the forward walk's "
     "encoding)",
     "        v = encode_value(x, freq, kind);",
     "        v = encode_value(x, freq, kind == 1 ? 2 : kind == 2 ? 1 : kind);",
     ("embed", "stream_fwd")),
    ("embed wgmma bwd: the posenc derivative with sin and cos swapped",
     "      xp[m] = kind == 1 ? x[c + 1] : kind == 2 ? x[c - 1] : 1.f;",
     "      xp[m] = kind == 1 ? x[c] : kind == 2 ? x[c] : 1.f;",
     ("embed", "stream_bwd")),
    ("fwd wgmma: value rows not rounded to bf16 before the fuse (a rounding "
     "point)",
     "              if (c1 < cout) arow[c1] += a * act_round<Op>(acc[i]);",
     "              if (c1 < cout) arow[c1] += a * acc[i];"),
    ("fwd wgmma: the second weight chunk read from the first one's stage "
     "(a stale stage)",
     "        real ? ring.base + st * kWStageBytes : zero, 16, 1024);",
     "        real ? ring.base + (ring.i == 1 ? 0 : st) * kWStageBytes : zero, "
     "16, 1024);"),
    ("fwd wgmma: the activation of the wrong layer (layer 0 takes the last "
     "layer's: no relu)",
     "    wg_dense(acc, A, rg, zero, E, w.layers[l], w.bias + (d.b[l] - d.b[0]),\n"
     "             d.act, nullptr, nullptr, 0);",
     "    wg_dense(acc, A, rg, zero, E, w.layers[l], w.bias + (d.b[l] - d.b[0]),\n"
     "             l == 0 ? d.last_act : d.act, nullptr, nullptr, 0);"),
    ("fwd wgmma: the output LayerNorm without its first pass (statistics and "
     "scaling of columns 128.. only)",
     "    acc_layernorm(acc, park, n_true, ln_a, ln_b);",
     "    acc_layernorm(acc, nullptr, n_true, ln_a, ln_b);"),
    ("fwd wgmma: score scale off by 1 %",
     "  for (int h = 0; h < 2; ++h) col[h] = quad_sum(s[h]) / sqrt_dm;",
     "  for (int h = 0; h < 2; ++h) col[h] = quad_sum(s[h]) / sqrt_dm * 1.01f;"),
    ("fwd wgmma: posenc with sin and cos swapped",
     "        v = encode_value(x, freq, kind);",
     "        v = encode_value(x, freq, kind == 1 ? 2 : kind == 2 ? 1 : kind);"),
    ("fwd wgmma: y_k truncated to bf16 (toward zero) before w_k instead of "
     "rounded, its first 128 columns (a rounding point; wgmma takes no "
     "unrounded operand)",
     "      A[i] = pack_bf16(park[(2 * i) * 128 + t], park[(2 * i + 1) * 128 + t]);",
     "      A[i] = (__float_as_uint(park[(2 * i) * 128 + t]) >> 16) |\n"
     "             (__float_as_uint(park[(2 * i + 1) * 128 + t]) & 0xffff0000u);"),
    ("bwd wgmma: dz truncated to bf16 (toward zero) before the dX product "
     "and the stash (a rounding point)",
     "  round_pass(acc, w);\n  stash_w(w, dz, srow0, width, c0);",
     "  for (int i = 0; i < 32; ++i)\n"
     "    w[i] = (__float_as_uint(acc[2 * i]) >> 16) |\n"
     "           (__float_as_uint(acc[2 * i + 1]) & 0xffff0000u);\n"
     "  stash_w(w, dz, srow0, width, c0);"),
    ("bwd wgmma: db summed from the bf16-rounded dz instead of the fp32 "
     "gradient (a rounding point)",
     "  colsum_pass([&](int i) { return acc[i]; }, part_db + c0, width - c0);",
     "  colsum_pass([&](int i) { return bf16_round(acc[i]); }, part_db + c0, "
     "width - c0);"),
    ("bwd wgmma: the relu mask of the layer above (off by one layer)",
     "        l > 0 && d.act == 1 ? masks + (l - 1) * 512 : nullptr;",
     "        l > 0 && d.act == 1 ? masks + l * 512 : nullptr;"),
    ("bwd wgmma: one pass of the output LayerNorm's db column sums dropped",
     "    colsum_pass([&](int i) { return acc[o + i]; }, part_b + co, n_true "
     "- co);",
     ""),
    ("bwd wgmma walk: the second weight chunk read from the first one's "
     "stage (a stale stage, W and W^T alike)",
     "        real ? ring.base + st * kWStageBytes : zero, 16, 1024);",
     "        real ? ring.base + (ring.i == 1 ? 0 : st) * kWStageBytes : zero, "
     "16, 1024);"),
    ("bwd wgmma: the posenc derivative with sin and cos swapped",
     "      xp[m] = kind == 1 ? x[c + 1] : kind == 2 ? x[c - 1] : 1.f;",
     "      xp[m] = kind == 1 ? x[c] : kind == 2 ? x[c] : 1.f;"),
    ("wgmma wgrad: one split's partial dropped from the sum",
     "  for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + c];",
     "  for (int r = 0; r < rows - (rows > 1); ++r) s += part[(size_t)r * cols "
     "+ c];"),
    ("wgmma wgrad: the second token range off by one tile",
     "        const int n = n0 + s * kKB16;",
     "        const int n = n0 + s * kKB16 + (blockIdx.y == 1 ? kKB16 : 0);"),
    ("wgmma wgrad fp32: the tensor cores' own accumulator (no fresh "
     "accumulator per stage, no round-to-nearest adds)",
     "        wgmma_ss_tf32<BN>(acc, dal, dbh, j > 0);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbl, 1);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbh, 1);\n"
     "      }\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"
     "      reg_fence(acc);\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], "
     "acc[i]);",
     "        wgmma_ss_tf32<BN>(acc, dal, dbh, 1);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbl, 1);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbh, 1);\n"
     "      }\n"
     "      wgmma_commit();\n"
     "      wgmma_wait<0>();\n"
     "      reg_fence(acc);\n"
     "#pragma unroll\n"
     "      for (int i = 0; i < BN / 2; ++i) sum[i] = acc[i];"),
    ("wgmma wgrad fp32: single-pass TF32 (the lo terms dropped)",
     "        wgmma_ss_tf32<BN>(acc, dal, dbh, j > 0);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbl, 1);\n"
     "        wgmma_ss_tf32<BN>(acc, dah, dbh, 1);\n",
     "        wgmma_ss_tf32<BN>(acc, dah, dbh, j > 0);\n"),
    ("wgmma walk: the second weight chunk read from the first one's stage "
     "(a stale stage)",
     "        real ? ring.base + st * kWStageBytes : zero, 16, 1024);",
     "        real ? ring.base + (ring.i == 1 ? 0 : st) * kWStageBytes : zero, "
     "16, 1024);"),
    ("wgmma walk: LayerNorm with the biased variance (the output "
     "LayerNorm)",
     "    const float var = quad_sum(v) / (float)(n_true > 1 ? n_true - 1 : "
     "1);",
     "    const float var = quad_sum(v) / (float)n_true;"),
    ("wgmma walk: activations rounded to bf16 before the bias (a rounding "
     "point)",
     "      float v0 = acc[4 * j + 2 * h] + b.x;",
     "      float v0 = bf16_round(acc[4 * j + 2 * h]) + b.x;"),
    ("wgmma attend: one k step's value row left out of the fuse",
     "              arow[c1] = arow[c1] * scale + e * act_round<Op>(acc[i]);",
     "              arow[c1] = arow[c1] * scale + (k == 1 ? 0.f : e) * "
     "act_round<Op>(acc[i]);"),
    ("wgmma attend: value rows not rounded to bf16 before the fuse (a "
     "rounding point)",
     "              arow[c1] = arow[c1] * scale + e * act_round<Op>(acc[i]);",
     "              arow[c1] = arow[c1] * scale + e * acc[i];"),
    ("fp32 wgmma walk: single-pass TF32 (the lo terms dropped; the fp32 "
     "one-shot eval attention and the fp32 stream backwards)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, s > 0);\n",
     ("compare_f32_kernels",)),
    ("fp32 wgmma walk: the lo.hi term dropped (one cross term; the fp32 "
     "one-shot eval attention and the fp32 stream backwards)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dl + kk, s > 0);\n"
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, 1);\n",
     ("compare_f32_kernels",)),
    ("fp32 wgmma walk: the tensor cores' own accumulator across the whole "
     "K (no fresh accumulator per 32-deep chunk joined by round-to-nearest "
     "adds; the fp32 one-shot eval attention and the fp32 stream backwards)",
     _F32_WG_PRODUCTS + _F32_WG_JOIN,
     _F32_WG_PRODUCTS.replace("dh + kk, s > 0);",
                              "dh + kk, s > 0 || sub > 0 || c > 0);")
     + _F32_WG_JOIN.replace("__fadd_rn(acc[32 * p + i], f[i])", "f[i]"),
     ("compare_f32_kernels",)),
    ("fp32 bwd wgmma: the layer inputs and dz stashed in bf16 (the fp32 "
     "stream backwards' stash)",
     "      *reinterpret_cast<float4*>(dst + (srow0 + r) * pd + 4 * u) =\n"
     "          *reinterpret_cast<const float4*>(E + r * kF32Ld + 4 * u);",
     "      {\n"
     "        float4 v = *reinterpret_cast<const float4*>(E + r * kF32Ld + "
     "4 * u);\n"
     "        v.x = bf16_round(v.x);\n        v.y = bf16_round(v.y);\n"
     "        v.z = bf16_round(v.z);\n        v.w = bf16_round(v.w);\n"
     "        *reinterpret_cast<float4*>(dst + (srow0 + r) * pd + 4 * u) = "
     "v;\n      }",
     ("f32_stream_bwd",)),
    ("fp32 bwd wgmma: db summed from the bf16-rounded dz (the fp32 stream "
     "backwards)",
     "  colsum_layer([&](int i) { return acc[i]; }, part_db, width);",
     "  colsum_layer([&](int i) { return bf16_round(acc[i]); }, part_db, "
     "width);",
     ("f32_stream_bwd",)),
    ("fp32 bwd wgmma: the reverse walk's products (dz_l W_l^T) in the tensor "
     "cores' own accumulator across the whole K (only there)",
     _F32_REV,
     _f32_gemm_own_acc("wg_gemm_f32_rev") + _F32_REV.replace(
         "    wg_gemm_f32(acc,", "    wg_gemm_f32_rev(acc,"),
     ("f32_stream_bwd",)),
    ("fp32 fwd wgmma: single-pass TF32 (the lo terms dropped; the fp32 "
     "stream forwards and the fp32 K3)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, s > 0);\n",
     ("f32_stream_fwd",)),
    ("fp32 fwd wgmma: the lo.hi term dropped (one cross term; the fp32 "
     "stream forwards and the fp32 K3)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dl + kk, s > 0);\n"
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, 1);\n",
     ("f32_stream_fwd",)),
    ("fp32 fwd wgmma: the value rows rounded to bf16 before the fuse (a "
     "rounding point)",
     _F32_FWD_FUSE, _F32_FWD_FUSE.replace("act_round<Op>(acc[i])",
                                          "bf16_round(acc[i])"),
     ("f32_stream_fwd",)),
    ("fp32 fwd wgmma: y_k rounded to bf16 before the w_k product (a rounding "
     "point; the fp32 K3's score too)",
     "  const int q = threadIdx.x & 3;\n"
     "  wg_gemm_f32(acc, A.E, A.row0, rg, L);\n",
     "  const int q = threadIdx.x & 3;\n"
     "  for (int r = A.row0; r < A.row0 + 16; ++r)\n"
     "    for (int c = threadIdx.x & 31; c < L.pd_in; c += 32)\n"
     "      A.E[r * kF32Ld + c] = bf16_round(A.E[r * kF32Ld + c]);\n"
     "  __syncwarp();\n"
     "  wg_gemm_f32(acc, A.E, A.row0, rg, L);\n",
     ("f32_stream_fwd",)),
    ("fp32 fwd wgmma: E left stale at the start (NaN where it is zeroed)",
     "      sm.tiles[i] = 0.f;",
     "      sm.tiles[i] = __int_as_float(0x7fc00000);",
     ("f32_stream_fwd",)),
    ("fp32 fwd wgmma: E not zeroed at the start (whatever the block's shared "
     "memory held)",
     "    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "",
     ("f32_stream_fwd",)),
    ("fp32 feat fwd wgmma: FeatSrc reads slot k - 1's feature rows",
     "    return FeatSrc{p.x + (size_t)k * p.T * p.d_raw, p.d_raw, p.T, rbase};",
     "    return FeatSrc{p.x + (size_t)(k > 0 ? k - 1 : 0) * p.T * p.d_raw, "
     "p.d_raw, p.T, rbase};", ("f32_feat_fwd",)),
    ("fp32 feat fwd wgmma: influence from slot k + 1",
     "    return make_float2(p.influ[i], p.alive[i]);",
     "    return make_float2(p.influ[(size_t)t * p.K + (k + 1) % p.K], "
     "p.alive[i]);", ("f32_feat_fwd",)),
    ("fp32 feat fwd wgmma: alive ignored",
     "    return make_float2(p.influ[i], p.alive[i]);",
     "    return make_float2(p.influ[i], 1.f);", ("f32_feat_fwd",)),
    ("fp32 feat fwd wgmma: the tensor cores' own accumulator across the "
     "whole K (every fp32 wgmma product; read on the feature forwards)",
     _F32_WG_PRODUCTS + _F32_WG_JOIN,
     _F32_WG_PRODUCTS.replace("dh + kk, s > 0);",
                              "dh + kk, s > 0 || sub > 0 || c > 0);")
     + _F32_WG_JOIN.replace("__fadd_rn(acc[32 * p + i], f[i])", "f[i]"),
     ("f32_feat_fwd",)),
    ("fp32 feat fwd wgmma: the value rows rounded to bf16 before the fuse "
     "(a rounding point; the record value forward's too)",
     _F32_FWD_FUSE, _F32_FWD_FUSE.replace("act_round<Op>(acc[i])",
                                          "bf16_round(acc[i])"),
     ("f32_feat_fwd",)),
    ("fp32 feat fwd wgmma: E not zeroed at the start (whatever the block's "
     "shared memory held: NaN, in the cuda cases that fill it first)",
     "    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "", ("f32_feat_fwd",)),
    ("fp32 embed wgmma walk: single-pass TF32 (the lo terms dropped, in "
     "every fp32 wgmma product)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, s > 0);\n",
     ("f32_embed",)),
    ("fp32 embed wgmma walk: the lo.hi term dropped (one cross term)",
     _F32_WG_PRODUCTS,
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dl + kk, s > 0);\n"
     "          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],\n"
     "                            dh + kk, 1);\n",
     ("f32_embed",)),
    ("fp32 embed wgmma walk: the tensor cores' own accumulator across the "
     "whole K (forward and reverse products)",
     _F32_WG_PRODUCTS + _F32_WG_JOIN,
     _F32_WG_PRODUCTS.replace("dh + kk, s > 0);",
                              "dh + kk, s > 0 || sub > 0 || c > 0);")
     + _F32_WG_JOIN.replace("__fadd_rn(acc[32 * p + i], f[i])", "f[i]"),
     ("f32_embed",)),
    ("fp32 embed wgmma rev: the reverse walk's products (dz_l W_l^T) in the "
     "tensor cores' own accumulator across the whole K (only there)",
     _F32_REV,
     _f32_gemm_own_acc("wg_gemm_f32_rev") + _F32_REV.replace(
         "    wg_gemm_f32(acc,", "    wg_gemm_f32_rev(acc,"),
     ("f32_embed",)),
    ("fp32 embed wgmma stash: the layer inputs and dz stashed in bf16",
     "      *reinterpret_cast<float4*>(dst + (srow0 + r) * pd + 4 * u) =\n"
     "          *reinterpret_cast<const float4*>(E + r * kF32Ld + 4 * u);",
     "      {\n"
     "        float4 v = *reinterpret_cast<const float4*>(E + r * kF32Ld + "
     "4 * u);\n"
     "        v.x = bf16_round(v.x);\n        v.y = bf16_round(v.y);\n"
     "        v.z = bf16_round(v.z);\n        v.w = bf16_round(v.w);\n"
     "        *reinterpret_cast<float4*>(dst + (srow0 + r) * pd + 4 * u) = "
     "v;\n      }",
     ("f32_embed",)),
    ("fp32 embed wgmma fwd: E left stale at the start (NaN where it is "
     "zeroed)",
     "i < 2 * p.e_floats; i += kWgThreads)\n      sm.tiles[i] = 0.f;",
     "i < 2 * p.e_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = __int_as_float(0x7fc00000);",
     ("f32_embed",)),
    ("fp32 embed wgmma bwd: E left stale at the start (NaN where it is "
     "zeroed)",
     "i < 2 * p.wg_floats; i += kWgThreads)\n      sm.tiles[i] = 0.f;",
     "i < 2 * p.wg_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = __int_as_float(0x7fc00000);",
     ("f32_embed",)),
    ("fp32 embed wgmma fwd: E not zeroed at the start (whatever the block's "
     "shared memory held)",
     "    for (int i = threadIdx.x; i < 2 * p.e_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "", ("f32_embed",)),
    ("fp32 embed wgmma bwd: E not zeroed at the start (whatever the block's "
     "shared memory held)",
     "    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "", ("f32_embed",)),
    ("fp32 keyq wgmma head: the head's bias b_q dropped (qq = eq w_q)",
     "  acc_bias_act(acc, hb, L.pd_out, 0);\n", "", ("f32_fold",)),
    ("fp32 keyq wgmma head: w_q's rows off by one (the head's input "
     "column c meets row c + 1)",
     "  wg_gemm_f32(acc, A.E, A.row0, rg, L);\n  acc_bias_act(acc, hb, "
     "L.pd_out, 0);\n",
     "  for (int r = A.row0; r < A.row0 + 16; ++r) {\n"
     "    float v[8];\n"
     "    for (int m = 0; m < 8; ++m) {\n"
     "      const int c = (threadIdx.x & 31) + 32 * m;\n"
     "      v[m] = c >= 1 && c < L.pd_in ? A.E[r * kF32Ld + c - 1] : 0.f;\n"
     "    }\n"
     "    __syncwarp();\n"
     "    for (int m = 0; m < 8; ++m) {\n"
     "      const int c = (threadIdx.x & 31) + 32 * m;\n"
     "      if (c < L.pd_in) A.E[r * kF32Ld + c] = v[m];\n"
     "    }\n"
     "    __syncwarp();\n"
     "  }\n"
     "  wg_gemm_f32(acc, A.E, A.row0, rg, L);\n  acc_bias_act(acc, hb, "
     "L.pd_out, 0);\n", ("f32_fold",)),
    ("fp32 keyq wgmma combine: a split tile's second part of dqq dropped "
     "(the key's combine kernel; row 5f's too)",
     "    dqq[i] += dqq_aux[i];\n", "", ("f32_fold",)),
    ("fp32 keyq wgmma rayd: d_rayd summed into the wrong source column "
     "(the embedder backward's sink; row 3f's too)",
     "                 if (row < R) p.dx[(size_t)row * d_raw + src] = v;",
     "                 if (row < R) p.dx[(size_t)row * d_raw + (src + 1) % "
     "d_raw] = v;", ("f32_fold",)),
    ("fp32 keyq wgmma head fwd: E not zeroed at the start (whatever the "
     "block's shared memory held: NaN, in the cuda cases that fill it "
     "first; row 2f's too)",
     "    for (int i = threadIdx.x; i < 2 * p.e_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "", ("f32_fold",)),
    ("fp32 keyq wgmma head bwd: E not zeroed at the start (whatever the "
     "block's shared memory held: NaN, in the cuda cases that fill it "
     "just before the query head's backward; row 3f's too)",
     "    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)\n"
     "      sm.tiles[i] = 0.f;\n", "", ("f32_fold",)),
    ("fp32 keyq wgmma walk: alive ignored (RecTok; rows 4f's token mask is "
     "its own, row 5f's is this)",
     "    return make_float2(gr[9], gr[10]);", "    return make_float2(gr[9], "
     "1.f);", ("f32_fold",)),
    # The bf16 rows 7 / 9 forwards on wgmma: read by phase 2's rows 7 / 9
    # lines and their bf16 wgmma cuda cases (and row 7's WMMA-era case).
    ("bf16 keyq wgmma head: the bias added in fp32, unrounded (qq = "
     "bf16(eq w_q) + b_q, where JAX's bf16 _linear adds the bf16 bias in bf16)",
     _HEAD_V0 + _HEAD_V1,
     _HEAD_V0.replace("linear_bf16(acc[4 * j + 2 * h], hb[c])",
                      "bf16_round(acc[4 * j + 2 * h]) + hb[c]")
     + _HEAD_V1.replace("linear_bf16(acc[4 * j + 2 * h + 1], hb[c + 1])",
                        "bf16_round(acc[4 * j + 2 * h + 1]) + hb[c + 1]"),
     ("bf16_fold",)),
    ("bf16 keyq wgmma head: the second pass's columns never written (qq's "
     "columns 128.. left as allocated; d_model 256)",
     "      if (row >= R) continue;\n      float* yrow",
     "      if (row >= R || pass > 0) continue;\n      float* yrow",
     ("bf16_fold",)),
    ("bf16 keyq wgmma walk: alive ignored (RecTok: row 5's mask, which row "
     "7 runs)",
     "    return make_float2(gr[9], gr[10]);", "    return make_float2(gr[9], "
     "1.f);", ("bf16_fold",)),
    ("bf16 feat fwd wgmma: value rows left unrounded before the fuse (row "
     "6's too)",
     "              if (c1 < cout) arow[c1] += a * act_round<Op>(acc[i]);",
     "              if (c1 < cout) arow[c1] += a * acc[i];",
     ("bf16_feat_fwd",)),
    ("fp32 walk: single-pass TF32 (the lo terms dropped)",
     "  nvcuda::wmma::mma_sync(t, a_lo, b_hi, t);\n"
     "  nvcuda::wmma::mma_sync(t, a_hi, b_lo, t);\n", ""),
    ("fp32 walk: only one of the two cross terms",
     "  nvcuda::wmma::mma_sync(t, a_hi, b_lo, t);\n", ""),
    ("fp32 walk: every product accumulated in the tensor cores' own "
     "accumulator (no round-to-nearest add per step)",
     "  Acc t;\n"
     "  nvcuda::wmma::fill_fragment(t, 0.f);\n"
     "  nvcuda::wmma::mma_sync(t, a_lo, b_hi, t);\n"
     "  nvcuda::wmma::mma_sync(t, a_hi, b_lo, t);\n"
     "  nvcuda::wmma::mma_sync(t, a_hi, b_hi, t);\n"
     "#pragma unroll\n"
     "  for (int i = 0; i < t.num_elements; ++i) c.x[i] = __fadd_rn(c.x[i], "
     "t.x[i]);",
     "  nvcuda::wmma::mma_sync(c, a_lo, b_hi, c);\n"
     "  nvcuda::wmma::mma_sync(c, a_hi, b_lo, c);\n"
     "  nvcuda::wmma::mma_sync(c, a_hi, b_hi, c);"),
    ("fp32 walk: bf16 rounding left between layers (a rounding point)",
     "        store8(p, v);              // fp32: the next layer reads C "
     "unrounded",
     "        if (A_out) for (int e = 0; e < 8; ++e) v[e] = bf16_round(v[e]);\n"
     "        store8(p, v);"),
    ("fp32 stash: the backward stashes the layer inputs in bf16",
     "    uint4 u = *reinterpret_cast<const uint4*>(A + r * kALd + c);",
     "    uint4 u = *reinterpret_cast<const uint4*>(A + r * kALd + c);\n"
     "    if constexpr (kF32<T>) {\n"
     "      float* f = reinterpret_cast<float*>(&u);\n"
     "      for (int e = 0; e < 4; ++e) f[e] = bf16_round(f[e]);\n"
     "    }"),
    ("fp32 scores: the embeddings rounded to TF32 as they load (one operand "
     "of a single TF32 pass)",
     "    *reinterpret_cast<uint4*>(A + r * kALd + c0) = val;",
     "    if constexpr (kF32<Op>) {\n"
     "      float* f = reinterpret_cast<float*>(&val);\n"
     "      for (int e = 0; e < 4; ++e)\n"
     "        f[e] = nvcuda::wmma::__float_to_tf32(f[e]);\n"
     "    }\n"
     "    *reinterpret_cast<uint4*>(A + r * kALd + c0) = val;"),
    ("fp32 scores: qq rounded to bf16",
     "        if (t < a.T) a.qq[(size_t)t * a.pdm + c] = q;",
     "        if (t < a.T) a.qq[(size_t)t * a.pdm + c] = bf16_round(q);"),
    ("fp32 scores bwd: the dkk stash rounded to bf16",
     "            b.dkk_stash[((size_t)k * a.T + t) * a.pdm + c] = h;",
     "            b.dkk_stash[((size_t)k * a.T + t) * a.pdm + c] = "
     "bf16_round(h);"),
    ("fp32 keyq wgmma head: qq rounded to bf16",
     "  acc_bias_act(acc, hb, L.pd_out, 0);\n",
     "  acc_bias_act(acc, hb, L.pd_out, 0);\n"
     "  for (int i = 0; i < kOutRegs; ++i) acc[i] = bf16_round(acc[i]);\n",
     ("f32_fold",)),
    ("fp32 epilogue of int8 value: its value rows rounded to bf16",
     "    fuse_step<Op>(C, acc, attn, den, k, K, cout, t0, T);",
     "    if (vq) fuse_step<__nv_bfloat16>(C, acc, attn, den, k, K, cout, t0, "
     "T);\n"
     "    else fuse_step<Op>(C, acc, attn, den, k, K, cout, t0, T);"),
    ("fp32 epilogue of int8 attend: its value rows rounded to bf16",
     "              arow[c1] = arow[c1] * scale + e * act_round<Op>(acc[i]);",
     "              arow[c1] = arow[c1] * scale + e * (kQ8 ? bf16_round(acc[i])"
     " : act_round<Op>(acc[i]));", ("int8_k3",)),
    # The int8 K3 on wgmma (rows 4q / 4qf): read by phase 2's int8 K3 lines
    # and the int8 K3's cuda cases (both epilogues, NaN-filled shared memory).
    ("int8 K3 wgmma pack: each 32-deep group's permutation shifted by one "
     "column (K position 4 q + i holds the column of 4 q + i + 1, within "
     "its four)",
     "    return 16 * (x // 16) + 2 * (x % 16 // 4) + (0, 1, 8, 9)[x % 4]",
     "    return 16 * (x // 16) + 2 * (x % 16 // 4) + (1, 8, 9, 0)[x % 4]",
     ("int8_k3",)),
    ("int8 K3 wgmma walk: the inv row of the wrong layer (each layer's "
     "output quantized with its own input's scales)",
     "                w.inv + inv_off);",
     "                w.inv + inv_off - d.pd[l]);", ("int8_k3",)),
    ("int8 K3 wgmma walk: dq dropped",
     "  float z0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h], s.x), b.x);\n"
     "  float z1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], s.y), "
     "b.y);",
     "  float z0 = __fadd_rn((float)acc[4 * j + 2 * h], b.x);\n"
     "  float z1 = __fadd_rn((float)acc[4 * j + 2 * h + 1], b.y);",
     ("int8_k3",)),
    ("int8 K3 wgmma quantize: the clip at +-128 (walk.cuh quantize_value, "
     "which rows 5q / 6q share; 128 wraps to -128)",
     "  const float t = fminf(fmaxf(__fmul_rn(h, inv), -127.f), 127.f);",
     "  const float t = fminf(fmaxf(__fmul_rn(h, inv), -128.f), 128.f);",
     ("int8_k3",)),
    ("int8 K3 wgmma attend: E not zeroed (the fp32 epilogue's tiles left as "
     "the shared memory holds them)",
     "  if constexpr (f32) {\n    // Every E column",
     "  if constexpr (f32 && !kQ8) {\n    // Every E column", ("int8_k3",)),
    ("int8 K3 wgmma attend: the value rows left unrounded in 4q (a rounding "
     "point)",
     "              arow[c1] = arow[c1] * scale + e * act_round<Op>(acc[i]);",
     "              arow[c1] = arow[c1] * scale + e * (kQ8 ? acc[i] : "
     "act_round<Op>(acc[i]));", ("int8_k3",)),
    ("int8 walk: truncation instead of round-to-nearest",
     "  return (q8)__float2int_rn(t);", "  return (q8)__float2int_rz(t);"),
    ("int8 walk: clamp at 128 (wraps to -128)",
     "  const float t = fminf(fmaxf(__fmul_rn(h, inv), -127.f), 127.f);",
     "  const float t = fminf(fmaxf(__fmul_rn(h, inv), -128.f), 128.f);"),
    ("int8 walk: dq of the layer before",
     "    const float* dq = q.dq[l];",
     "    const float* dq = q.dq[l > 0 && d.pd[l] == d.pd[l + 1] ? l - 1 : l];"),
    ("int8 walk: the next layer quantizes the bf16-rounded activation (a "
     "rounding point)",
     "    for (int e = 0; e < 8; ++e) q[e] = quantize_value(v[e], "
     "inv_next[col + e]);",
     "    for (int e = 0; e < 8; ++e) q[e] = quantize_value(bf16_round(v[e]), "
     "inv_next[col + e]);"),
    ("int8 walk: bias added before the dequantization",
     "    v[e] = __fadd_rn(__fmul_rn((float)a[e], dq[col + e]), "
     "bias[col + e]);",
     "    v[e] = __fmul_rn(__fadd_rn((float)a[e], bias[col + e]), "
     "dq[col + e]);"),
    ("int8 bench: the dynamic scale divides the amax by 128",
     "      if (lane == 0) sx[r] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);",
     "      if (lane == 0) sx[r] = __fdiv_rn(fmaxf(m, 1e-12f), 128.f);"),
    ("stream feat key bwd: d_influ without the score relu",
     "        ds[i] * (score_relu ? fmaxf(rw, 0.f) : rw);",
     "        ds[i] * rw;"),
    ("stream feat key bwd: d_influ scaled by 1.05",
     "        ds[i] * (score_relu ? fmaxf(rw, 0.f) : rw);",
     "        ds[i] * (score_relu ? fmaxf(rw, 0.f) : rw) * 1.05f;"),
    ("stream feat key bwd: position columns of dxk zeroed (a detach inside "
     "the kernel)",
     "      if (t < T) dxk[(size_t)t * d_raw + src] = v;",
     "      if (t < T) dxk[(size_t)t * d_raw + src] = src < 3 ? 0.f : v;"),
    # Row 8's bf16 forward on wgmma (FeatTok's token mask, the bf16 w_k
    # head's bias: read by phase 2's row 8 line with its dead slots and the
    # bf16 key's wgmma cuda cases); row 10f's forward on wgmma (its staging,
    # query head and mask in fused_attn.cu; the fp32 w_k head's bias in
    # walk_wgmma.cuh: read by phase 8 up to row 10f, its dead slots and its
    # narrow case after NaN-filled shared memory, and row 10f's cuda cases).
    ("bf16 keyf wgmma: alive ignored (FeatTok; row 8f's token mask too)",
     "    return make_float2(p.influ[i], p.alive[i]);",
     "    return make_float2(p.influ[i], 1.f);", ("bf16_keyf_fwd",)),
    ("bf16 keyf wgmma: b_k not added (the bf16 w_k head, wg_score; rows 5, "
     "7 and K3's too)",
     "            s[h] += qrow[c] * linear_bf16(acc[4 * j + 2 * h + e], "
     "bks[c]);",
     "            s[h] += qrow[c] * linear_bf16(acc[4 * j + 2 * h + e], 0.f);",
     ("bf16_keyf_fwd",)),
    ("fp32 scores wgmma: alive ignored",
     "                                 p.alive[i] > 0.5f);",
     "                                 true);", ("f32_scores_fwd",)),
    ("fp32 scores wgmma: b_q not added (the query head's bias)",
     "      acc_bias_act(acc, p.bias, p.pdm, 0);\n", "", ("f32_scores_fwd",)),
    ("fp32 scores wgmma walk: b_k not added (the fp32 w_k head, wg_score; "
     "rows 4f, 5f, 7f and 8f's too)",
     "          s[h] += qrow[c] * linear_c<float>(acc[4 * j + 2 * h + e], "
     "bks[c]);",
     "          s[h] += qrow[c] * linear_c<float>(acc[4 * j + 2 * h + e], "
     "0.f);", ("f32_scores_fwd",)),
    ("fp32 scores wgmma: the query head's columns 128.. dropped (its second "
     "128 columns never reach qq)",
     "      acc_bias_act(acc, p.bias, p.pdm, 0);",
     "      acc_bias_act(acc, p.bias, p.pdm > 128 ? 128 : p.pdm, 0);",
     ("f32_scores_fwd",)),
    ("fp32 scores wgmma: E not zeroed (the staged rows past T and past the "
     "width left as shared memory held them: NaN after the fill)",
     "      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, "
     "0.f, 0.f);\n", "", ("f32_scores_fwd",)),
    ("stream feat key fwd + bwd: alive mask ignored",
     "      ss[r * K + k] = masked_score(col, score_relu, influ[i], "
     "alive[i] > 0.5f);",
     "      ss[r * K + k] = masked_score(col, score_relu, influ[i], true);"),
    ("stream q bwd: the query backward takes 1.05 dqq",
     "    const float g = t < T && c < dm ? dqq[(size_t)t * dm + c] : 0.f;",
     "    const float g = t < T && c < dm ? 1.05f * dqq[(size_t)t * dm + c] "
     ": 0.f;"),
    ("stream shared bwd: dqq keeps the last slot only (the query backward "
     "sees one k, not their sum)",
     "      dqq[(size_t)t * dm + c] += draw[r] * kk;",
     "      dqq[(size_t)t * dm + c] = draw[r] * kk;"),
    ("stream shared fwd: score scale off by 1 %",
     "    if (lane == 0) sink(r, t, s / sqrt_dm);",
     "    if (lane == 0) sink(r, t, s / sqrt_dm * 1.01f);"),
    ("stream shared fwd: value rows not rounded to bf16 before the fuse (a "
     "rounding point)",
     "      acc[r * cout + c] += w * act_round<Op>(C[r * kCLd + c]);",
     "      acc[r * cout + c] += w * C[r * kCLd + c];"),
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
    ("fwd+bwd: projection not rounded before the bias (a rounding point; "
     "linear_bf16, which the streams share)",
     "  return bf16_round(bf16_round(acc) + bf16_round(bias));",
     "  return bf16_round(acc + bf16_round(bias));"),
    ("fwd+bwd: score scale off by 1 %",
     "      if (lane == 0) sS[r * kSLd + k] = acc * a.rsqrt_dm;",
     "      if (lane == 0) sS[r * kSLd + k] = acc * a.rsqrt_dm * 1.01f;"),
    ("fwd+bwd: bias b_k left out",
     "        acc += qq_at(s, a, t0, r, c) * linear_c<Op>(s.C[r * kCLd + c], "
     "a.bk[c]);",
     "        acc += qq_at(s, a, t0, r, c) * linear_c<Op>(s.C[r * kCLd + c], "
     "0.f);"),
    ("embedder bwd: dx of raw columns 6 and up scaled by 1.05",
     "                 if (row < R) p.dx[(size_t)row * d_raw + src] = v;",
     "                 if (row < R) p.dx[(size_t)row * d_raw + src] = "
     "src >= 6 ? v * 1.05f : v;", ("embed",)),
    ("embedder bwd: dx of raw columns 6 and up scaled by 1.01",
     "                 if (row < R) p.dx[(size_t)row * d_raw + src] = v;",
     "                 if (row < R) p.dx[(size_t)row * d_raw + src] = "
     "src >= 6 ? v * 1.01f : v;", ("embed",)),
    ("encoding: un-encoded (pass-through) columns scaled by 1.01, fwd + bwd",
     "  if (kind == 0) return x;", "  if (kind == 0) return x * 1.01f;",
     ("embed",)),
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
if sys.argv[1] in ("compare_f32_kernels", "compare_f32_streams"):
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    if sys.argv[1] == "compare_f32_streams":
        # Phase 8's comparisons up to the fp32 stream rows (5f / 6f): the
        # run stops where row 7f's would start.
        from papr_tpu_torch.ops import stream_attn as sa

        class Stop(Exception):
            pass

        def stop(*a, **k):
            raise Stop
        sa.key_stream_q_f32_fwd = stop
        try:
            cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                                   n_time=1)
        except Stop:
            pass
    else:
        cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                               n_time=1)
elif sys.argv[1] == "compare_f32_embed":
    # Phase 8's comparisons of the fp32 embedder on the query stack (rows
    # 2f / 3f): the run stops where row 4f's would start.
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    from papr_tpu_torch.ops import stream_attn as sa

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    sa.attend_eval_f32 = stop
    try:
        cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                               n_time=1)
    except Stop:
        pass
elif sys.argv[1] == "compare_f32_feat":
    # Phase 8's comparisons up to rows 8f / 9f fwd and the one-hot check:
    # the run stops where row 9f bwd's would start.
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    from papr_tpu_torch.ops import stream_feat as sf

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    sf.value_stream_feat_bwd = stop
    try:
        cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                               n_time=1)
    except Stop:
        pass
elif sys.argv[1] == "compare_f32_scores":
    # Phase 8's comparisons up to row 10f's forward (its dead slots and its
    # narrow case after NaN-filled shared memory): the run stops where row
    # 10f's backward would start.
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    from papr_tpu_torch.ops import fused_attn as fa

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    fa.fused_scores_f32_bwd = stop
    try:
        cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                               n_time=1)
    except Stop:
        pass
elif sys.argv[1] == "compare_f32_fold":
    # Phase 8's comparisons up to row 7f (and its check against row 5f):
    # the run stops where rows 4qf-6qf's would start.
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    from papr_tpu_torch.ops import stream_attn as sa

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    sa.calibrate_walk = stop
    try:
        cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180,
                               n_time=1)
    except Stop:
        pass
elif sys.argv[1] == "compare_int8_k3":
    # Phase 2's int8 comparisons up to the int8 K3 (row 4q, on the
    # eval block, self-calibrated and on a frame's quantization): the run
    # stops where the int8 stream forwards' would start.
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    from papr_tpu_torch.ops import stream_attn as sa

    class Stop(Exception):
        pass

    def stop(*a, **k):
        raise Stop
    sa.key_stream_fwd = stop
    try:
        cs.compare_int8_kernels(params, state, cfg, dev, n_time=1)
    except Stop:
        pass
elif sys.argv[1] == "compare_wgmma_kernels":
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    cs.compare_wgmma_kernels(params, state, cfg, dev)
else:
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    getattr(cs, sys.argv[1])(params, state, cfg, dev, n_time=1)
'''
# Per comparison: the lines of its output to show, the ``cuda`` tests to run.
TARGETS = {
    "compare_cli_kernels": (
        ("phase 2 topk", "phase 2 fused_scores", "phase 2 fused_mlp"),
        "fused_scores or topk_stream or key_value_stacks"),
    "compare_train_kernels": (
        ("phase 2 key_stream_q", "phase 2 key_stream_feat",
         "phase 2 value_stream_feat", "phase 2 key_stream_bwd",
         "phase 2 value_stream_fwd"),
        "key_stream or value_stream"),
    "compare_int8_kernels": (
        ("phase 2 attend_eval_i8", "phase 2 key_stream_i8",
         "phase 2 value_stream_i8", "phase 2 int8_walk_bench"),
        "i8 or int8"),
    "compare_f32_kernels": (("phase 8",), "f32 or fp32"),
    "compare_wgmma_kernels": (("phase 2 K3", "phase 2 wgrad",
                               "phase 8 wgrad_f32"),
                              "attend_eval_kernel or wgrad or hgmma"),
    # compare_f32_kernels up to rows 5f / 6f (compare_f32_streams), read for
    # the two fp32 stream backwards only.
    "f32_stream_bwd": (("phase 8 key_stream_f32_bwd",
                        "phase 8 value_stream_f32_bwd"), "f32_bwd_wgmma"),
    # The same run, read for the two fp32 stream forwards (at phase 8's and
    # configs/demo.yml's widths, and against the fp32 K3).
    "f32_stream_fwd": (("phase 8 key_stream_f32_fwd",
                        "phase 8 value_stream_f32_fwd",
                        "phase 8 fp32 stream forwards"), "f32_fwd_wgmma"),
    # compare_train_kernels, read for the two bf16 stream backwards only.
    "stream_bwd": (("phase 2 key_stream_bwd", "phase 2 value_stream_bwd"),
                   "stream_bwd_wgmma"),
    # compare_train_kernels, read for the two bf16 stream forwards (and the
    # folded key stream held against the key forward).
    "stream_fwd": (("phase 2 key_stream_fwd", "phase 2 value_stream_fwd",
                    "phase 2 key_stream_q_fwd on"), "stream_fwd_wgmma"),
    "embed": (("phase 2 K2", "phase 2 fused_mlp"),
              "fused_mlp_wgmma or fused_mlp_bwd_wgmma"),
    # compare_f32_kernels up to rows 8f / 9f fwd and the one-hot check
    # (compare_f32_feat), and the fp32 feature streams' cuda cases (the
    # WMMA-era ones at F32_REL too, and the NaN-filled shared memory).
    "f32_feat_fwd": (("phase 8 key_stream_feat_f32_fwd",
                      "phase 8 value_stream_feat_f32_fwd"), "feat_f32"),
    # compare_f32_kernels up to rows 2f / 3f (compare_f32_embed), and the
    # fp32 embedder's cuda cases (the query, key and value stacks, small
    # grids, an overhang tile).
    "f32_embed": (("phase 8 fused_mlp_f32", "phase 8 fused_mlp_bwd_f32"),
                  "fused_mlp_f32"),
    # compare_f32_kernels up to row 7f (compare_f32_fold: its forward and
    # backward against the plain fp32 versions and against row 5f on its
    # own qq), and row 7f's wgmma cuda cases (dead points, split grids, a
    # 15-column query encoding, NaN-filled shared memory).
    "f32_fold": (("phase 8 key_stream_q_f32",), "key_stream_q_f32_wgmma"),
    # compare_int8_kernels up to the int8 K3 (compare_int8_k3), and the int8
    # K3's cuda cases: both epilogues against their plain versions, the
    # NaN-filled shared memory, the kernel the profiler names.
    "int8_k3": (("phase 2 attend_eval_i8",),
                "attend_eval_i8 or int8_walks_with_fp32"),
    # compare_train_kernels, read for the bf16 rows 7 / 9 forwards on wgmma
    # (row 7 against the plain version and bit for bit against row 5 on its
    # qq), and their cuda cases (dead points, split grids, d_model 40 / 256,
    # NaN-filled shared memory).
    "bf16_fold": (("phase 2 key_stream_q_fwd",),
                  "key_stream_q_fwd_wgmma or bf16_rows_7_9 or "
                  "key_stream_q_kernels"),
    "bf16_feat_fwd": (("phase 2 value_stream_feat_fwd",),
                      "value_stream_feat_fwd_wgmma or bf16_rows_7_9 or "
                      "value_stream_feat_kernels"),
    # compare_train_kernels, read for row 8's bf16 forward on wgmma (on its
    # dead slots), and its cuda cases (dead points, split grids, K 1 / 20 /
    # 64, NaN-filled shared memory).
    "bf16_keyf_fwd": (("phase 2 key_stream_feat_fwd", "phase 2 dead slots"),
                      "key_stream_feat_fwd_wgmma or rows_8_10f or "
                      "key_stream_feat_kernels"),
    # compare_f32_kernels up to row 10f's forward (compare_f32_scores), and
    # its cuda cases (widths below 256, split grids, K 1 / 20 / 64, NaN-filled
    # shared memory).
    "f32_scores_fwd": (("phase 8 fused_scores_f32_fwd", "phase 8 dead slots"),
                       "fused_scores_f32_fwd_wgmma or rows_8_10f or "
                       "fused_scores_f32_kernels"),
}
# The comparison function each target runs, and the cuda test lines shown.
FN = {"f32_stream_bwd": "compare_f32_streams",
      "f32_stream_fwd": "compare_f32_streams",
      "stream_bwd": "compare_train_kernels",
      "stream_fwd": "compare_train_kernels",
      "embed": "compare_embed_kernels",
      "f32_embed": "compare_f32_embed",
      "f32_feat_fwd": "compare_f32_feat",
      "f32_fold": "compare_f32_fold",
      "int8_k3": "compare_int8_k3",
      "bf16_fold": "compare_train_kernels",
      "bf16_feat_fwd": "compare_train_kernels",
      "bf16_keyf_fwd": "compare_train_kernels",
      "f32_scores_fwd": "compare_f32_scores"}
TEST_LINES = {"compare_int8_kernels": ("attend_eval_i8", "key_stream_i8",
                                       "value_stream_i8", "int8_walk_bench"),
              "compare_f32_kernels": ("f32", "key_stream_f32_bwd wgmma",
                                      "value_stream_f32_bwd wgmma"),
              "f32_stream_bwd": ("key_stream_f32_bwd wgmma",
                                 "value_stream_f32_bwd wgmma"),
              "f32_stream_fwd": ("key_stream_f32_fwd wgmma",
                                 "value_stream_f32_fwd wgmma",
                                 "fp32 stream forwards"),
              "compare_train_kernels": ("key_stream_q T",),
              "compare_wgmma_kernels": ("attend_eval T", "wgrad"),
              "stream_bwd": ("key_stream_bwd T", "value_stream_bwd T"),
              "stream_fwd": ("key_stream_fwd wgmma", "value_stream_fwd wgmma"),
              "embed": ("fused_mlp wgmma", "fused_mlp_bwd wgmma"),
              "f32_embed": ("fused_mlp_f32",),
              "f32_feat_fwd": ("key_stream_feat_f32_fwd",
                               "value_stream_feat_f32_fwd"),
              "f32_fold": ("key_stream_q_f32",),
              "int8_k3": ("attend_eval_i8", "key_stream_i8_f32",
                          "value_stream_i8_f32"),
              "bf16_fold": ("key_stream_q_fwd wgmma", "papr_key_stream_q"),
              "bf16_feat_fwd": ("value_stream_feat_fwd wgmma",
                                "papr_value_stream_feat"),
              "bf16_keyf_fwd": ("key_stream_feat_fwd wgmma",
                                "papr_key_stream_feat"),
              "f32_scores_fwd": ("fused_scores_f32_fwd", "fused_scores_f32",
                                 "papr_fused_scores")}


def target_of(name: str) -> str:
    head = name.split(":")[0]
    return ("embed" if head.startswith("embed wgmma")
            else "stream_fwd" if head.startswith("fwd wgmma")
            else "stream_bwd" if head.startswith("bwd wgmma")
            else "compare_wgmma_kernels" if "wgmma" in head
            else "compare_f32_kernels" if "fp32" in head
            else "compare_int8_kernels" if "int8" in head
            else "compare_train_kernels" if "stream" in head
            else "compare_cli_kernels")


def targets_of(m) -> tuple:
    return m[3] if len(m) > 3 else (target_of(m[0]),)


def main() -> None:
    words = sys.argv[1:]
    picked = [m for m in MUTS if not words or any(w in m[0] for w in words)]
    needed = []
    for m in picked:
        needed += [t for t in targets_of(m) if t not in needed]
    run_case("sound", None, None, tuple(needed))
    for m in picked:
        run_case(*m[:3], targets_of(m))


def source_of(name: str) -> str:
    return next((f for word, f in (("bf16 keyf wgmma", "walk_wgmma.cuh"),
                                   ("fp32 scores wgmma walk",
                                    "walk_wgmma.cuh"),
                                   ("fp32 scores wgmma", "fused_attn.cu"),
                                   ("bf16 keyq wgmma head",
                                    "embed_wgmma.cuh"),
                                   ("bf16 keyq wgmma walk", "walk_wgmma.cuh"),
                                   ("bf16 feat fwd wgmma", "walk_wgmma.cuh"),
                                   ("int8 K3 wgmma pack",
                                    "ops/fused_mlp.py"),
                                   ("int8 K3 wgmma walk", "walk_wgmma.cuh"),
                                   ("int8 K3 wgmma quantize", "walk.cuh"),
                                   ("int8 K3 wgmma attend", "attend_eval.cu"),
                                   ("fp32 keyq wgmma combine",
                                    "key_stream.cu"),
                                   ("fp32 keyq wgmma walk", "walk_wgmma.cuh"),
                                   ("fp32 keyq wgmma", "embed_wgmma.cuh"),
                                   ("fp32 embed wgmma fwd",
                                    "embed_wgmma.cuh"),
                                   ("fp32 embed wgmma bwd",
                                    "embed_wgmma.cuh"),
                                   ("fp32 embed wgmma walk",
                                    "walk_wgmma.cuh"),
                                   ("fp32 embed wgmma stash",
                                    "walk_wgmma_bwd.cuh"),
                                   ("fp32 embed wgmma rev",
                                    "walk_wgmma_bwd.cuh"),
                                   ("embed wgmma bwd", "walk_wgmma_bwd.cuh"),
                                   ("embed wgmma", "walk_wgmma.cuh"),
                                   ("fwd wgmma", "walk_wgmma.cuh"),
                                   ("bwd wgmma walk", "walk_wgmma.cuh"),
                                   ("bwd wgmma", "walk_wgmma_bwd.cuh"),
                                   ("wgmma wgrad", "wgrad.cu"),
                                   ("wgmma walk", "walk_wgmma.cuh"),
                                   ("wgmma attend", "attend_eval.cu"),
                                   ("topk", "topk_stream.cu"),
                                   ("embedder bwd", "embed_wgmma.cuh"),
                                   ("encoding", "walk.cuh"),
                                   ("stream feat key", "key_stream_feat.cu"),
                                   ("stream feat value",
                                    "value_stream_feat.cu"),
                                   ("stream q walk", "key_stream.cuh"),
                                   ("stream q", "key_stream_q.cu"),
                                   ("stream shared", "stream_common.cuh"),
                                   ("linear_bf16", "stream_common.cuh"),
                                   ("int8 walk", "walk.cuh"),
                                   ("int8 bench", "int8_walk_bench.cu"),
                                   ("int8 value", "value_stream.cu"),
                                   ("int8 attend", "attend_eval.cu"),
                                   ("fp32 walk", "walk.cuh"),
                                   ("fp32 stash", "walk_bwd.cuh"))
                 if word in name), "fused_attn.cu")


def run_case(name, old, new, targets) -> None:
    root = tempfile.mkdtemp(prefix="mut_")
    skip = shutil.ignore_patterns("_build", "__pycache__")
    for d in ("papr_tpu_torch", "configs", "tests", "tools"):
        shutil.copytree(os.path.join(REPO, d), os.path.join(root, d),
                        ignore=skip)
    for f in ("chip_smoke.py", "pytest.ini"):
        shutil.copy(os.path.join(REPO, f), root)
    if old is not None:
        src = source_of(name)
        p = os.path.join(root, "papr_tpu_torch",
                         *(src.split("/") if "/" in src else ("csrc", src)))
        s = open(p).read()
        if old not in s:
            raise SystemExit(f"{name}: the line to replace is no longer in "
                             f"{src}; bring MUTS up to date")
        open(p, "w").write(s.replace(old, new))
    print(f"===== {name}", flush=True)
    # Each comparison function once, showing the lines of every target that
    # reads it; one pytest run over every target's tests.
    fns = {}
    for t in targets:
        fns.setdefault(FN.get(t, t), []).extend(TARGETS[t][0])
    for fn, shown in fns.items():
        r = subprocess.run([sys.executable, "-c", RUN, fn], cwd=root,
                           capture_output=True, text=True)
        for line in r.stdout.splitlines():
            if line.startswith(tuple(shown) + ("FAILS",)):
                print("  " + line[:1600], flush=True)
        if r.returncode:
            print("  rc", r.returncode, r.stderr[-1500:], flush=True)
    tests = " or ".join(f"({TARGETS[t][1]})" for t in targets)
    lines = tuple(l for t in targets for l in TEST_LINES.get(t, ()))
    t = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-s", "-p", "no:cacheprovider", "tests/test_torch_kernels_cuda.py",
         "-k", tests, "--tb=line"],
        cwd=root, capture_output=True, text=True)
    for line in t.stdout.splitlines():
        line = line.lstrip(".FEs")        # -s: pytest's progress marks
        if "Error" in line or ": assert " in line or (
                lines and line.startswith(lines)):
            print("  cuda tests: " + line[:400], flush=True)
    print(f"  cuda tests: exit code {t.returncode}", flush=True)
    shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
