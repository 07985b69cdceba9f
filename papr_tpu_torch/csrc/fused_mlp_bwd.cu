// Fused embedder backward: recompute posenc -> [LayerNorm] -> dense stack ->
// [LayerNorm] on a tile, then the reverse walk to dx, with the parameter
// gradients reduced afterwards (wgrad.cu).
//
// Replaces papr_tpu/ops/fused_mlp.py::_fused_bwd_inner (pallas_call at :598,
// kernel body _bwd_kernel :424). On the training path it is the query
// embedder's backward: x (R, 3) fp32 ray directions and dy (R, 256) ->
// dx (R, 3), dW / db per layer, dLN in / out.
//
// What bounds it on the H100: the recompute and the dX products, ~2x the
// forward's tensor-core work per row, plus the stash traffic (the layer
// inputs and bf16 output gradients, ~4.5 KB a row written once and read
// once by wgrad.cu). What the design does about it: one block of 512
// threads per 64-row tile keeps every activation and gradient of the tile in
// shared memory (walk_bwd.cuh); the weights of the forward and the
// transposed weights of the reverse walk are staged per layer as in the
// forward kernel. The TPU kernel's grid-resident dW / db / dLN accumulators
// become the stash + split-K reduction and per-block partial rows.
//
// fused_mlp_f32_bwd is the same kernel on the fp32 walk (use_amp: false):
// 3xTF32 products, fp32 stash (twice the bytes) reduced by wgrad.cu's fp32
// form.

#include "walk_bwd.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bwd_kernel(const float* __restrict__ x, int R, int d_raw,
                     const float* __restrict__ dy, WalkDescT<Op> d,
                     WalkBwdT<Op> b, const int* __restrict__ seg,
                     float* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> s = walk_smem<Op>(smem);
  float* st = reinterpret_cast<float*>(s.extra);            // 4 x kRows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;
  const int pdn = d.pd[d.n];

  encode_raw(s.C, d, x, r0, R, d_raw);
  __syncthreads();
  const TileCtx ctx = tile_ctx(d, b, (size_t)r0, st);
  walk_fwd_stash(s, d, b, ctx, false);

  // Upstream gradient; overhang rows and pad lanes are zero.
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    for (int c = lane; c < pdn; c += 32)
      s.C[r * kCLd + c] = row < R && c < d.d_out
          ? dy[(size_t)row * d.d_out + c] : 0.f;
  }
  __syncthreads();
  walk_bwd(s, d, b, ctx);

  pe_bwd_deriv(s.C, d, [&](int r, int src) {
    const int row = r0 + r;
    return row < R ? x[(size_t)row * d_raw + src] : 0.f;
  });
  __syncthreads();
  pe_source_sums(s.C, seg, d_raw, [&](int r, int src, float v) {
    const int row = r0 + r;
    if (row < R) dx[(size_t)row * d_raw + src] = v;
  });
}

template <class Op>
static int launch_fused_mlp_bwd(const float* x, int R, int d_raw,
                                const float* dy, const int* meta,
                                const void* w_all, const void* b_all,
                                const void* ln, const void* plan,
                                const void* wt_all, void* stash,
                                const long long* stash_off, const int* seg,
                                float* dx, float* part, int part_w,
                                float* scratch, void* stream) {
  WalkDescT<Op> d;
  int err = fill_walk(&d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  WalkBwdT<Op> b;
  err = fill_walk_bwd(&b, d, meta, wt_all, stash, stash_off, d.n, part,
                      part_w, scratch);
  if (err) return err;
  if (R <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * 4 * kRows;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (R + kRows - 1) / kRows;
  fused_mlp_bwd_kernel<Op><<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, R, d_raw, dy, d, b, seg, dx);
  return (int)cudaGetLastError();
}

#define FUSED_MLP_BWD_PARAMS                                                 \
    const float* x, int R, int d_raw, const float* dy, const int* meta,      \
    const void* w_all, const void* b_all, const void* ln, const void* plan,  \
    const void* wt_all, void* stash, const long long* stash_off,             \
    const int* seg, float* dx, float* part, int part_w, float* scratch,      \
    void* stream
#define FUSED_MLP_BWD_ARGS                                                   \
    x, R, d_raw, dy, meta, w_all, b_all, ln, plan, wt_all, stash, stash_off, \
    seg, dx, part, part_w, scratch, stream

extern "C" int papr_fused_mlp_bwd(FUSED_MLP_BWD_PARAMS) {
  return launch_fused_mlp_bwd<__nv_bfloat16>(FUSED_MLP_BWD_ARGS);
}

extern "C" int papr_fused_mlp_f32_bwd(FUSED_MLP_BWD_PARAMS) {
  return launch_fused_mlp_bwd<float>(FUSED_MLP_BWD_ARGS);
}
