// Streamed value fuse from RAW FEATURE tensors, forward and backward
// (tpu.fused_attn: stream).
//
// Forward replaces papr_tpu/ops/stream_attn.py::value_stream_fuse
// (pallas_call at :555, kernel body _vs_fwd_kernel :406): per (ray, k) the
// value posenc of xv[k, t] (6 -> 78, plus 64 pass-through point features) ->
// 8-layer walk to 32 -> rounded to the compute type -> weighted by the renormalized
// foreground attention and summed over k: fused (T, C) fp32.
//
// Backward replaces _vs_bwd (pallas_call at :605, kernel body _vs_bwd_kernel
// :433): per k a recompute of the walk; dattn from the value rows and the
// renormalization (after the k loop, when every column of the ray is in the
// block; the background column stays 0); the walk's gradients; the posenc
// backward summed per raw source into dxv (K, T, d_raw). All-dead rays
// (foreground mass exactly 0) divide by 1: zero gradient into the walk.
//
// What bounds it on the H100: the walk, as value_stream.cu (compute bound);
// xv adds 280 B a token to read and dxv as much to write. Both backwards
// run on the WMMA walk (walk.cuh / walk_bwd.cuh): one block of 512 threads
// per 64-ray tile, k inside the block, every activation in shared memory, dW
// through the stash and wgrad.cu.
//
// value_stream_feat_f32_bwd is the same backward on the fp32 walk (use_amp:
// false; _vs_bwd_kernel with cdt = float32): the walk in fp32 (walk.cuh's
// 3xTF32 products), fp32 stashes and dW through wgrad_f32; the same shared
// memory.
//
// The forward, both forms (value_stream_feat_fwd in bf16,
// value_stream_feat_f32_fwd in fp32; _vs_fwd_kernel with cdt = bfloat16 /
// float32), runs on wgmma: value_feat_fwd_wgmma_kernel /
// value_feat_fwd_wgmma_f32_kernel are walk_wgmma.cuh's stream_fwd_wg, the
// record value forward's function (value_stream.cu value_fwd_wgmma_kernel /
// value_fwd_wgmma_f32_kernel), with the token source FeatTok: per k step a
// warpgroup encodes its 64 rays' rows of xv[k] (scalar loads by the column
// plan: 6 posenc sources, then the point features passed through), the
// walk runs on the TMA-fed weight ring (ops/stream_attn.py fwd_wgmma_pack /
// fwd_wgmma_pack_f32): bf16, m64n128k16 products with the activations in
// registers between layers; fp32, 3xTF32 m64n64k8 products. Its value rows
// (rounded to bf16 in the bf16 form, as fuse_step<bf16> rounds them; fp32
// unrounded) are weighted by the renormalized foreground attention into
// per-ray sums in shared memory; 128 rays a block on a persistent grid over
// (tile, k) units, each block adding its rays' sums into the zeroed output
// with atomicAdd. Against the WMMA kernels no rounding point moved in the
// walk (bf16: products summed in another order; fp32: the partial products
// join the fp32 sum once per 32-deep chunk instead of once per 8-deep
// step); a ray split between two blocks sums its K terms in two parts,
// added once (at most two addends on 0: order-free), where the WMMA kernels
// sum all K in order. Bound by operations (fp32: three tensor-core products
// per fp32-accurate one); xv adds 280 B a token.

#include "walk_wgmma.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
valuef_bwd_kernel(const float* __restrict__ x, int d_raw, int T, int Tp,
                  int K, const float* __restrict__ attn,
                  const float* __restrict__ dfused, WalkDescT<Op> vd,
                  WalkBwdT<Op> vb,
                  int normalize, const int* __restrict__ seg,
                  float* __restrict__ dx, float* __restrict__ dattn) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  float* C = S.C;
  float* st = reinterpret_cast<float*>(S.extra);             // 4 x kRows
  float* den = st + 4 * kRows;                               // kRows
  float* datt = den + kRows;                                 // kRows x K
  const int t0 = blockIdx.x * kRows;
  const int cout = vd.d_out, pdn = vd.pd[vd.n];

  // Safe denominator (_vs_bwd_kernel :459-460): 1 for all-dead rays.
  fg_mass_rows(attn, K, t0, T, normalize, den);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float* xk = x + (size_t)k * T * d_raw;
    encode_raw(C, vd, xk, t0, T, d_raw);
    __syncthreads();
    const TileCtx ctx = tile_ctx(vd, vb, (size_t)k * Tp + t0, st);
    walk_fwd_stash(S, vd, vb, ctx, false);       // y fp32 in C
    fuse_step_bwd<Op>(C, datt, attn, den, dfused, k, K, cout, pdn, t0, T);
    walk_bwd(S, vd, vb, ctx);

    pe_bwd_deriv(C, vd, [&](int r, int src) {
      const int t = t0 + r;
      return t < T ? xk[(size_t)t * d_raw + src] : 0.f;
    });
    __syncthreads();
    float* dxk = dx + (size_t)k * T * d_raw;
    pe_source_sums(C, seg, d_raw, [&](int r, int src, float v) {
      const int t = t0 + r;
      if (t < T) dxk[(size_t)t * d_raw + src] = v;
    });
    __syncthreads();
  }
  renorm_bwd_rows(datt, attn, den, normalize, K, t0, T, dattn);
}

#define VALUEF_FWD_PARAMS                                                    \
    const float* x, int d_raw, int T, int K, const float* attn,              \
    const int* vmeta, const void* vw, const void* vb, const void* vln,       \
    const void* vplan, int normalize, void* fused, const void* wpack,        \
    long long wbytes, int grid, void* stream
#define VALUEF_FWD_ARGS                                                      \
    x, d_raw, T, K, attn, vmeta, vw, vb, vln, vplan, normalize, fused,       \
    wpack, wbytes, grid, stream
#define VALUEF_BWD_PARAMS                                                    \
    const float* x, int d_raw, int T, int K, const float* attn,              \
    const float* dfused, const int* vmeta, const void* vw, const void* vb,   \
    const void* vln, const void* vplan, const void* vwt, int normalize,      \
    void* stash, const long long* stash_off, const int* seg, float* dx,      \
    float* dattn, float* part, int part_w, float* scratch, void* stream

template <class Op>
static int launch_valuef_bwd(VALUEF_BWD_PARAMS) {
  WalkDescT<Op> vd;
  int err = fill_walk(&vd, vmeta, vw, vb, vln, vplan);
  if (err) return err;
  WalkBwdT<Op> wb;
  err = fill_walk_bwd(&wb, vd, vmeta, vwt, stash, stash_off, vd.n, part,
                      part_w, scratch);
  if (err) return err;
  if (K <= 0 || K > 64) return -202;
  if (d_raw <= 0 || d_raw > kMaxWidth) return -205;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows * (4 + 1 + K);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      valuef_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  valuef_bwd_kernel<Op><<<Tp / kRows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, d_raw, T, Tp, K, attn, dfused, vd, wb, normalize, seg, dx, dattn);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kWgThreads, 1)
value_feat_fwd_wgmma_kernel(const __grid_constant__ StreamFwdWg p) {
  stream_fwd_wg<false, __nv_bfloat16, FeatTok>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
value_feat_fwd_wgmma_f32_kernel(
    const __grid_constant__ StreamFwdWgT<float> p) {
  stream_fwd_wg<false, float, FeatTok>(p);
}

#define VALUEF_BWD_ARGS                                                      \
    x, d_raw, T, K, attn, dfused, vmeta, vw, vb, vln, vplan, vwt,            \
    normalize, stash, stash_off, seg, dx, dattn, part, part_w, scratch,      \
    stream

// The forward on wgmma in the operand form Op: the features (K, T, d_raw),
// attn, the walk, fused zeroed by the caller (each block adds its rays'
// sums), then the packed weights of the walk's layers (ops/stream_attn.py
// fwd_wgmma_pack / fwd_wgmma_pack_f32), their size in bytes and the grid
// (1 .. the number of 128-ray tiles).
template <class Op>
static int launch_valuef_fwd_wg(VALUEF_FWD_PARAMS) {
  if (d_raw <= 0 || d_raw > kMaxWidth) return -205;
  StreamFwdWgT<Op> p{};
  p.x = x;
  p.d_raw = d_raw;
  p.attn = attn;
  p.normalize = normalize;
  p.fused = static_cast<float*>(fused);
  void (*kernel)(StreamFwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = value_feat_fwd_wgmma_f32_kernel;
  else kernel = value_feat_fwd_wgmma_kernel;
  return launch_stream_fwd_wg<false>(p, kernel, T, K, vmeta, vw, vb, vln,
                                     vplan, wpack, wbytes, grid,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int papr_value_stream_feat_fwd(VALUEF_FWD_PARAMS) {
  return launch_valuef_fwd_wg<__nv_bfloat16>(VALUEF_FWD_ARGS);
}

extern "C" int papr_value_stream_feat_f32_fwd(VALUEF_FWD_PARAMS) {
  return launch_valuef_fwd_wg<float>(VALUEF_FWD_ARGS);
}

extern "C" int papr_value_stream_feat_bwd(VALUEF_BWD_PARAMS) {
  return launch_valuef_bwd<__nv_bfloat16>(VALUEF_BWD_ARGS);
}

extern "C" int papr_value_stream_feat_f32_bwd(VALUEF_BWD_PARAMS) {
  return launch_valuef_bwd<float>(VALUEF_BWD_ARGS);
}
