"""Write ``papr_tpu_torch/csrc/wgmma.cuh``: the Hopper ``wgmma`` inline-PTX
wrappers the hand-written kernels use (one function per instruction shape,
every accumulator register spelled out, as PTX wants).

    python tools/torch_gen_wgmma.py

Shapes: bf16 with both operands from shared memory and the transpose bits
as immediates (``csrc/wgrad.cu``: MN-major H and DZ tiles), bf16 with A
from registers (``csrc/attend_eval.cu``: activations kept in registers,
K-major weights), tf32 with both operands from shared memory (K-major,
``csrc/wgrad.cu``'s fp32 form), tf32 with A from registers (the fp32 form of
``csrc/walk_wgmma.cuh``'s walk: fp32 activations split into hi / lo
fragments, K-major weights), s8 x s8 -> s32 with A from registers (the int8
form of that walk: ``csrc/attend_eval.cu``'s int8 kernels, K-major int8
weights).
"""

import os

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "papr_tpu_torch", "csrc", "wgmma.cuh")
# The widths each kernel issues: wgrad's bf16 tiles 64 / 128 / 256 and fp32
# tiles 64 / 128; the eval attention's 128-wide passes (bf16 and int8); the
# fp32 walk's 64-wide passes.
SS_BF16_NS = (64, 128, 256)
RS_BF16_NS = (128,)
SS_TF32_NS = (64, 128)
RS_TF32_NS = (64,)
RS_S8_NS = (128,)


def regs(first, n):
    return ", ".join(f"%{first + i}" for i in range(n))


def dlist(n, c="f"):
    return ", ".join(f'"+{c}"(d[{i}])' for i in range(n))


def ss_bf16(n):
    nd = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss_bf16<{n}>(float (&d)[{nd}],
    uint64_t a, uint64_t b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(0, nd)}}}, %{nd}, %{nd + 1}, p, 1, 1, 1, 1;\\n}}\\n"
      : {dlist(nd)}
      : "l"(a), "l"(b), "r"(scale_d));
}}
"""


def rs_bf16(n):
    nd = n // 2
    return f"""template <int M>
__device__ __forceinline__ void wgmma_rs_bf16_n{n}(float (&d)[M],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t b,
    int scale_d) {{
  static_assert(M >= {nd}, "accumulator too small");
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
      "{{{regs(0, nd)}}}, {{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, "
      "%{nd + 4}, p, 1, 1, 0;\\n}}\\n"
      : {dlist(nd)}
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}}
"""


def rs_tf32(n):
    nd = n // 2
    return f"""template <int M>
__device__ __forceinline__ void wgmma_rs_tf32_n{n}(float (&d)[M],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t b,
    int scale_d) {{
  static_assert(M >= {nd}, "accumulator too small");
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs(0, nd)}}}, {{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, "
      "%{nd + 4}, p, 1, 1;\\n}}\\n"
      : {dlist(nd)}
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}}
"""


def rs_s8(n):
    nd = n // 2
    return f"""template <int M>
__device__ __forceinline__ void wgmma_rs_s8_n{n}(int (&d)[M],
    uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint64_t b,
    int scale_d) {{
  static_assert(M >= {nd}, "accumulator too small");
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8 "
      "{{{regs(0, nd)}}}, {{%{nd}, %{nd + 1}, %{nd + 2}, %{nd + 3}}}, "
      "%{nd + 4}, p;\\n}}\\n"
      : {dlist(nd, "r")}
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}}
"""


def ss_tf32(n):
    nd = n // 2
    return f"""template <>
__device__ __forceinline__ void wgmma_ss_tf32<{n}>(float (&d)[{nd}],
    uint64_t a, uint64_t b, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{nd + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{n}k8.f32.tf32.tf32 "
      "{{{regs(0, nd)}}}, %{nd}, %{nd + 1}, p, 1, 1;\\n}}\\n"
      : {dlist(nd)}
      : "l"(a), "l"(b), "r"(scale_d));
}}
"""


HEAD = """// Generated by tools/torch_gen_wgmma.py; do not edit by hand.
//
// Hopper warpgroup MMA (wgmma) wrappers: D (64 x N fp32, N / 2 registers a
// thread) += A (64 x K) * B (K x N), issued by the four warps of a
// warpgroup together and completed asynchronously (wgmma_commit /
// wgmma_wait). scale_d = 0 overwrites D instead of adding to it.
//   wgmma_ss_bf16<N>: A and B from shared memory through descriptors, both
//     MN-major (the transpose bits set), k = 16.
//   wgmma_rs_bf16_n<N>: A from registers (four bf16x2 a thread, the
//     mma.m16n8k16 A layout per warp), B K-major from shared memory, k = 16;
//     D is the first N / 2 registers of an accumulator array of any size M.
//   wgmma_ss_tf32<N>: A and B K-major from shared memory, k = 8.
//   wgmma_rs_tf32_n<N>: A from registers (four tf32 a thread, the
//     mma.m16n8k8 tf32 A layout per warp: rows g, g + 8, columns q, q + 4),
//     B K-major from shared memory, k = 8; D as wgmma_rs_bf16_n<N>.
//   wgmma_rs_s8_n<N>: s8 x s8 -> s32, A from registers (four registers of
//     four s8 a thread, the mma.m16n8k32 s8 A layout per warp: rows g,
//     g + 8, columns 4 q .. 4 q + 3 and 16 + 4 q .. 16 + 4 q + 3), B K-major
//     from shared memory (8-bit operands take no transpose), k = 32; D the
//     first N / 2 int registers of an accumulator array of any size M, laid
//     out as the fp32 accumulators.

#pragma once

#include <stdint.h>

namespace papr {

template <int N>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d);

"""


def main():
    body = [HEAD]
    body += [ss_bf16(n) for n in SS_BF16_NS]
    body += [rs_bf16(n) for n in RS_BF16_NS]
    body += [ss_tf32(n) for n in SS_TF32_NS]
    body += [rs_tf32(n) for n in RS_TF32_NS]
    body += [rs_s8(n) for n in RS_S8_NS]
    body.append("}  // namespace papr\n")
    with open(OUT, "w") as f:
        f.write("\n".join(body))


if __name__ == "__main__":
    main()
