// Streamed value fuse of the training path, forward and backward.
//
// Forward replaces papr_tpu/ops/stream_attn.py::value_stream_fuse_rec
// (pallas_call at :1756, kernel body _vsr_fwd_kernel :1601): per (ray, k)
// the point-ray geometry -> value posenc (78) + point features (64) ->
// 8-layer walk to 32 -> rounded to bf16 -> weighted by the renormalized
// foreground attention and summed over k: fused (T, C) fp32.
//
// Backward replaces _vsr_bwd (pallas_call at :1809, kernel body
// _vsr_bwd_kernel :1634): per k a recompute of the walk; dattn from the
// value rows and the renormalization (at the end of the k loop, when every
// column of the ray is in the block); the walk's gradients; the posenc and
// geometry backward to d_rec (K, T, rec_w) — geometry gradient in lanes
// 0:3, point-feature gradient in lanes 5.. — and d_rayo / d_rays.
// All-dead rays (foreground mass exactly 0) divide by 1: zero gradient into
// the walk, as in the TPU kernel.
//
// What bounds it on the H100: the walk, ~1.2 MFLOP of bf16 tensor-core work
// per token forward and ~3x that backward; compute bound. bf16 and fp32,
// the training path's forms, run on wgmma + TMA with 128-ray tiles on a
// persistent grid over (tile, k) units: the forward (value_fwd_wgmma_kernel,
// papr_value_stream_fwd; value_fwd_wgmma_f32_kernel,
// papr_value_stream_f32_fwd) on walk_wgmma.cuh's forward walk, the code of
// the one-shot eval attention (attend_eval.cu), each block's per-ray sums
// added into the zeroed output; the backward (value_bwd_wgmma_kernel,
// papr_value_stream_bwd; value_bwd_wgmma_f32_kernel,
// papr_value_stream_f32_bwd) on walk_wgmma_bwd.cuh. Each fp32 kernel is its
// bf16 twin's function in walk_wgmma.cuh's fp32 operand form. The int8
// forwards keep key_stream.cu's WMMA design: one block of 512 threads per
// 64-ray tile, k inside the block, every activation in shared memory. dW
// goes through the stash and wgrad.cu.
//
// value_stream_i8_fwd is the forward with int8=True (tpu.int8_train,
// stream_attn.py:1742-1746): the walk's dense stack runs walk.cuh's int8
// walk on a quantization the wrapper calibrated on this call's record. The
// backward takes no flag: it recomputes the walk in bf16 (straight-through;
// the fp32 backward after value_stream_i8_f32_fwd).
//
// value_stream_f32_fwd (use_amp: false): fp32 walk (3xTF32 products,
// wgmma), value rows not rounded before the fuse; value_stream_f32_bwd the
// same rounding points, an fp32 stash for the fp32 dW.
// value_stream_i8_f32_fwd is the int8 forward beside fp32 compute: the int8
// walk, its fp32 rows fused unrounded; its backward is value_stream_f32_bwd.

#include "rec_stream.cuh"
#include "stream_common.cuh"
#include "walk_wgmma_bwd.cuh"

using namespace papr;

// The int8 forward on one tile of kRows rays, Op the epilogue's operand
// type (bf16, or fp32 beside the int8 walk).
template <class Op>
__device__ __forceinline__ void value_fwd_tile(
    unsigned char* smem, const float* __restrict__ rec, int rec_w, int T,
    int K, const float* __restrict__ rayo, const float* __restrict__ rays,
    const float* __restrict__ attn, const WalkDescT<Op>& vd,
    const WalkQuant& vq, int normalize, float eps,
    float* __restrict__ fused) {
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  float* C = S.C;                  // walk_smem_q<Op>'s C too
  float* geo = reinterpret_cast<float*>(S.extra);            // kRows x kGeo
  float* den = geo + kRows * kGeo;                           // kRows
  const int cout = vd.d_out;
  float* acc = den + kRows;                                  // kRows x cout
  int* gidx = reinterpret_cast<int*>(acc + kRows * cout);    // kRows
  const int t0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kRows * cout; i += kThreads) acc[i] = 0.f;
  fg_mass_rows(attn, K, t0, T, normalize, den);

  for (int k = 0; k < K; ++k) {
    geometry_rows(geo, gidx, rec, rec_w, T, k, t0, rayo, rays, eps);
    __syncthreads();
    encode_rec(C, vd, geo, gidx, rec, rec_w);
    __syncthreads();
    run_walk_q(walk_smem_q<Op>(smem), vd, vq);
    fuse_step<Op>(C, acc, attn, den, k, K, cout, t0, T);
    __syncthreads();
  }
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    for (int c = lane; c < cout; c += 32)
      fused[(size_t)t * cout + c] = acc[r * cout + c];
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
value_i8_fwd_kernel(const float* __restrict__ rec, int rec_w, int T, int K,
                    const float* __restrict__ rayo,
                    const float* __restrict__ rays,
                    const float* __restrict__ attn, WalkDescT<Op> vd,
                    WalkQuant vq,
                    int normalize, float eps, float* __restrict__ fused) {
  extern __shared__ __align__(128) unsigned char smem[];
  value_fwd_tile(smem, rec, rec_w, T, K, rayo, rays, attn, vd, vq, normalize,
                 eps, fused);
}

#define VALUE_FWD_PARAMS                                                     \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* attn, const int* vmeta, const void* vw,  \
    const void* vb, const void* vln, const void* vplan, int normalize,       \
    float eps, void* fused
#define VALUE_FWD_ARGS                                                       \
    rec, rec_w, T, K, rayo, rays, attn, vmeta, vw, vb, vln, vplan,           \
    normalize, eps, fused

// Launcher of the int8 forwards on walk.cuh (value_fwd_tile), Op the
// epilogue's operand type.
template <class Op>
static int launch_value_i8_fwd(VALUE_FWD_PARAMS, const void* vwq,
                               const void* vinv, const void* vdq,
                               void* stream) {
  WalkDescT<Op> vd;
  int err = fill_walk(&vd, vmeta, vw, vb, vln, vplan);
  if (err) return err;
  WalkQuant vq;
  err = fill_walk_quant(&vq, vd, vmeta, vwq, vinv, vdq);
  if (err) return err;
  if (K <= 0 || K > 64) return -202;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows *
      (kGeo + 1 + vd.d_out) + sizeof(int) * kRows;
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      value_i8_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (T + kRows - 1) / kRows;
  value_i8_fwd_kernel<Op><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, K, rayo, rays, attn, vd, vq, normalize, eps,
      static_cast<float*>(fused));
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kWgThreads, 1)
value_fwd_wgmma_kernel(const __grid_constant__ StreamFwdWg p) {
  stream_fwd_wg<false>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
value_fwd_wgmma_f32_kernel(const __grid_constant__ StreamFwdWgT<float> p) {
  stream_fwd_wg<false, float>(p);
}

// The forward on wgmma, Op the operand form: the int8 forms' arguments,
// fused zeroed by the caller (each block adds its rays' sums), then the
// packed weights of the walk's layers (ops/stream_attn.py value_stream_fwd:
// bf16 pack_walk_wgmma's image, fp32 pack_walk_wgmma_f32's) and their size
// in bytes, and the grid (1 .. the number of 128-ray tiles).
template <class Op>
static int launch_value_fwd_wg(VALUE_FWD_PARAMS, const void* wpack,
                               long long wbytes, int grid, void* stream) {
  StreamFwdWgT<Op> p{};
  p.rec = rec;
  p.rec_w = rec_w;
  p.rayo = rayo;
  p.rays = rays;
  p.eps = eps;
  p.attn = attn;
  p.normalize = normalize;
  p.fused = static_cast<float*>(fused);
  void (*kernel)(StreamFwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = value_fwd_wgmma_f32_kernel;
  else kernel = value_fwd_wgmma_kernel;
  return launch_stream_fwd_wg<false>(p, kernel, T, K, vmeta, vw, vb, vln,
                                     vplan, wpack, wbytes, grid,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int papr_value_stream_fwd(VALUE_FWD_PARAMS, const void* wpack,
                                     long long wbytes, int grid,
                                     void* stream) {
  return launch_value_fwd_wg<__nv_bfloat16>(VALUE_FWD_ARGS, wpack, wbytes,
                                            grid, stream);
}

extern "C" int papr_value_stream_f32_fwd(VALUE_FWD_PARAMS, const void* wpack,
                                         long long wbytes, int grid,
                                         void* stream) {
  return launch_value_fwd_wg<float>(VALUE_FWD_ARGS, wpack, wbytes, grid,
                                    stream);
}

extern "C" int papr_value_stream_i8_fwd(VALUE_FWD_PARAMS, const void* vwq,
                                        const void* vinv, const void* vdq,
                                        void* stream) {
  return launch_value_i8_fwd<__nv_bfloat16>(VALUE_FWD_ARGS, vwq, vinv, vdq,
                                            stream);
}

extern "C" int papr_value_stream_i8_f32_fwd(VALUE_FWD_PARAMS,
                                            const void* vwq,
                                            const void* vinv,
                                            const void* vdq, void* stream) {
  return launch_value_i8_fwd<float>(VALUE_FWD_ARGS, vwq, vinv, vdq, stream);
}

#define VALUE_BWD_PARAMS_NS                                                  \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* attn, const float* dfused,               \
    const int* vmeta, const void* vw, const void* vb, const void* vln,       \
    const void* vplan, int normalize, float eps, void* stash,                \
    const long long* stash_off, const int* seg, int nsrc, float* drec,       \
    float* drayo, float* drays, float* dattn, float* part, int part_w,       \
    float* scratch
__global__ void __launch_bounds__(kWgThreads, 1)
value_bwd_wgmma_kernel(const __grid_constant__ StreamBwdWg p) {
  stream_bwd_wg<false>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
value_bwd_wgmma_f32_kernel(const __grid_constant__ StreamBwdWgT<float> p) {
  stream_bwd_wg<false, float>(p);
}

// After value_bwd_wgmma_kernel, a warp per ray: the split tiles' second
// parts of d_rayo / d_rays (zero elsewhere) added to the first parts', and
// the renormalization backward (_vsr_bwd_kernel :1681-1690) of the ray's
// datt row, with the safe denominator (1 for all-dead rays).
__global__ void value_bwd_combine_kernel(const float* __restrict__ datt,
                                         const float* __restrict__ attn,
                                         int normalize, int T, int K,
                                         float* __restrict__ dattn,
                                         float* drayo, const float* drayo_aux,
                                         float* drays,
                                         const float* drays_aux) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * blockDim.x >> 5;
  for (int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < T;
       t += nw) {
    if (lane < 3) {
      drayo[(size_t)t * 3 + lane] += drayo_aux[(size_t)t * 3 + lane];
      drays[(size_t)t * 3 + lane] += drays_aux[(size_t)t * 3 + lane];
    }
    const float* arow = attn + (size_t)t * (K + 1);
    const float* drow = datt + (size_t)t * K;
    float sfg = 0.f;
    for (int k = lane; k < K; k += 32) sfg += arow[k];
    sfg = warp_sum(sfg);
    const float den = normalize && sfg > 0.f ? sfg : 1.f;
    float inner = 0.f;
    if (normalize) {
      for (int k = lane; k < K; k += 32) inner += drow[k] * arow[k];
      inner = warp_sum(inner) / den;
    }
    float* out = dattn + (size_t)t * (K + 1);
    for (int k = lane; k < K; k += 32)
      out[k] = normalize ? (drow[k] - inner) / den : drow[k];
    if (lane == 0) out[K] = 0.f;
  }
}

// The backward on wgmma, Op the operand form: the walk (its weights only
// through the packed image), the stash and partial rows (part has 8 rows
// and scratch 2 StreamBwdWgT::scr_wg floats a block), then the packed
// weights (forward layers, then W_l^T for l = n-1 .. 0; ops/stream_attn.py
// value_stream_bwd: bf16 pack_walk_wgmma's image, fp32
// pack_walk_wgmma_f32's) and their size in bytes, the grid (1 .. the number
// of 128-ray tiles), a (T, K) datt buffer and the zeroed aux buffers of
// d_rayo, d_rays.
template <class Op>
static int launch_value_bwd_wg(VALUE_BWD_PARAMS_NS, const void* wpack,
                               long long wbytes, int grid, float* datt,
                               float* drayo_aux, float* drays_aux,
                               void* stream) {
  StreamBwdWgT<Op> p{};
  size_t smem = 0;
  if (K <= 0 || K > 64) return -202;
  int err = fill_stream_bwd_wg(&p, vmeta, vw, vb, vln, vplan, 0, wpack,
                               wbytes, stash, stash_off, part, part_w,
                               scratch, K, &smem);
  if (err) return err;
  if (nsrc > 32 * kSrcPerLane) return -208;
  if (T <= 0) return 0;
  p.rec = rec;
  p.rec_w = rec_w;
  p.T = T;
  p.Tp = (T + kWgTile - 1) / kWgTile * kWgTile;
  p.rayo = rayo;
  p.rays = rays;
  p.eps = eps;
  p.seg = seg;
  p.nsrc = nsrc;
  p.drec = drec;
  p.drayo = drayo;
  p.drays = drays;
  p.attn = attn;
  p.dfused = dfused;
  p.normalize = normalize;
  p.datt = datt;
  if (grid < 1 || grid > p.Tp / kWgTile) return -209;
  p.n_units = p.Tp / kWgTile * K;
  p.grid = grid;
  p.drayo_aux = drayo_aux;
  p.drays_aux = drays_aux;
  void (*kernel)(StreamBwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = value_bwd_wgmma_f32_kernel;
  else kernel = value_bwd_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  value_bwd_combine_kernel<<<(T + 7) / 8, 256, 0, st>>>(
      datt, attn, normalize, T, K, dattn, drayo, drayo_aux, drays,
      drays_aux);
  return (int)cudaGetLastError();
}

#define VALUE_BWD_WG_PARAMS                                                  \
    VALUE_BWD_PARAMS_NS, const void* wpack, long long wbytes, int grid,     \
    float* datt, float* drayo_aux, float* drays_aux, void* stream
#define VALUE_BWD_WG_ARGS                                                    \
    rec, rec_w, T, K, rayo, rays, attn, dfused, vmeta, vw, vb, vln, vplan,   \
    normalize, eps, stash, stash_off, seg, nsrc, drec, drayo, drays, dattn,  \
    part, part_w, scratch, wpack, wbytes, grid, datt, drayo_aux, drays_aux,  \
    stream

extern "C" int papr_value_stream_bwd(VALUE_BWD_WG_PARAMS) {
  return launch_value_bwd_wg<__nv_bfloat16>(VALUE_BWD_WG_ARGS);
}

extern "C" int papr_value_stream_f32_bwd(VALUE_BWD_WG_PARAMS) {
  return launch_value_bwd_wg<float>(VALUE_BWD_WG_ARGS);
}
