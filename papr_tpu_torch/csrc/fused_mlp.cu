// Fused embedder forward: posenc -> [LayerNorm] -> dense stack ->
// [LayerNorm] in one kernel, activations kept on chip.
//
// Replaces papr_tpu/ops/fused_mlp.py::fused_mlp (forward pallas_call at
// :551, kernel body _fwd_kernel :417). On the render path it is the query
// embedder: x (R, 3) fp32 ray directions -> (R, 256) bf16, 39 -> 256 x 5.
//
// What bounds it on the H100: 2 * R * (48*256 + 4*256*256) FLOP against
// 12 B read + 512 B written per row — compute bound on the tensor cores
// (~88 FLOP/B), with the posenc's precise sin/cos a minor second term.
// What the design does about it: one block of 512 threads per 64-row tile;
// the encoded tile and every intermediate activation stay in shared memory
// (bf16 operands, fp32 accumulators, WMMA tensor-core MMAs), so device memory
// sees only the raw input and the final output. Each layer's weights are
// staged into shared memory once per tile (cp.async, double-buffered) and
// shared by the 16 warps. The TPU kernel's 0/1 selection matmul for the
// posenc becomes a direct per-column gather driven by a small column plan.
// Not yet: wgmma / TMA, or more than one block per SM.
//
// fused_mlp_f32 is the same kernel on the fp32 walk (use_amp: false;
// fused_mlp.py _cdt = float32): fp32 operands and activations, 3xTF32
// products (walk.cuh), an fp32 output. Three tensor-core products per
// fp32-accurate one: bound by operations at a third of the TF32 rate.

#include "walk.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, int R, int d_raw,
                     WalkDescT<Op> d, Op* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> s = walk_smem<Op>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;

  encode_raw(s.C, d, x, r0, R, d_raw);
  __syncthreads();
  run_walk(s, d);

  const int dout = d.d_out;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    if (row >= R) continue;
    for (int c = lane; c < dout; c += 32)
      y[(size_t)row * dout + c] = to_act<Op>(s.C[r * kCLd + c]);
  }
}

template <class Op>
static int launch_fused_mlp_fwd(const float* x, int R, int d_raw,
                                const int* meta, const void* w_all,
                                const void* b_all, const void* ln,
                                const void* plan, void* y, void* stream) {
  WalkDescT<Op> d;
  int err = fill_walk(&d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  if (R <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWalkSmem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (R + kRows - 1) / kRows;
  fused_mlp_fwd_kernel<Op><<<grid, kThreads, kWalkSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, R, d_raw, d, static_cast<Op*>(y));
  return (int)cudaGetLastError();
}

extern "C" int papr_fused_mlp_fwd(const float* x, int R, int d_raw,
                                  const int* meta, const void* w_all,
                                  const void* b_all, const void* ln,
                                  const void* plan, void* y, void* stream) {
  return launch_fused_mlp_fwd<__nv_bfloat16>(x, R, d_raw, meta, w_all, b_all,
                                             ln, plan, y, stream);
}

extern "C" int papr_fused_mlp_f32_fwd(const float* x, int R, int d_raw,
                                      const int* meta, const void* w_all,
                                      const void* b_all, const void* ln,
                                      const void* plan, void* y,
                                      void* stream) {
  return launch_fused_mlp_fwd<float>(x, R, d_raw, meta, w_all, b_all, ln,
                                     plan, y, stream);
}
