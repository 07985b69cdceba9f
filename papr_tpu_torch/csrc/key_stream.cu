// Streamed key attention of the training path, forward and backward.
//
// Forward replaces papr_tpu/ops/stream_attn.py::key_stream_scores_rec
// (pallas_call at :1029, kernel body _ksr_fwd_kernel :798): per (ray, k)
// the point-ray geometry -> key posenc (117) -> LN -> 5 x 256 -> LN -> w_k
// -> scaled dot with qq -> score_act x influence, alive-masked; then the
// background-token softmax. Outputs attn (T, K+1) and, for the backward,
// the raw dots and masked scores (T, K).
//
// Backward replaces _ksr_bwd (pallas_call at :1100, kernel body
// _ksr_bwd_kernel :835): the softmax backward from the saved masked scores
// (alive read as ss > NEG_BIG / 2), then per k a recompute of the walk and
// the reverse chain: dqq, dW_k / db_k, the walk's gradients, the posenc and
// geometry backward to d_rec (K, T, rec_w) with the position FEATURE
// gradient dropped (the reference detaches it), the geometry gradient in
// lanes 0:3 and d_influence in lane 3, and d_rayo / d_rays.
//
// What bounds it on the H100: the walks, ~1.4 MFLOP of bf16 tensor-core
// work per (ray, k) token forward and ~3x that backward (recompute, dX,
// and dW in wgrad.cu); compute bound. The record is read pre-gathered
// k-major, (K, T, rec_w), the JAX kernels' layout; d_rec is a plain
// (K, T, rec_w) output that autograd scatter-adds into the (P, rec_w)
// record.
//
// bf16 and fp32, the training path's forms, run on wgmma + TMA with 128-ray
// tiles on a persistent grid over (tile, k) units (one block an SM) and the
// weights in a TMA-fed ring: the forward (key_fwd_wgmma_kernel,
// papr_key_stream_fwd; key_fwd_wgmma_f32_kernel, papr_key_stream_f32_fwd)
// on walk_wgmma.cuh's forward walk, the code of the one-shot eval attention
// (attend_eval.cu), followed by a small kernel for the softmax; the
// backward (key_bwd_wgmma_kernel, papr_key_stream_bwd;
// key_bwd_wgmma_f32_kernel, papr_key_stream_f32_bwd) on walk_wgmma_bwd.cuh.
// Each fp32 kernel is its bf16 twin's function in walk_wgmma.cuh's fp32
// operand form (3xTF32 m64n64k8, the layer inputs fp32 in shared memory,
// fp32 stash); the bf16 form keeps the activations in registers between
// layers.
//
// The int8 forwards keep walk.cuh's WMMA walk, as attend_eval.cu's int8
// form does: one block of 512 threads per 64-ray tile loops over k inside
// the block (the TPU grid's sequential k axis, which carried the scores
// and the dqq / d_rayo / d_rays sums in resident output blocks; here the
// block owns its rays' rows, so they accumulate without atomics), and
// every activation stays in shared memory.
//
// key_stream_i8_fwd is the forward with int8=True (tpu.int8_train,
// stream_attn.py:1013-1017): the walk's dense stack runs walk.cuh's int8
// walk on a quantization the wrapper calibrated on this call's record; the
// raw dots and masked scores it saves are the int8 forward's. The backward
// takes no flag: it recomputes the walk in bf16 (straight-through; the
// fp32 backward after key_stream_i8_f32_fwd).
//
// key_stream_f32_fwd (use_amp: false): fp32 walk, w_k product and bias
// (3xTF32 products, wgmma, above); key_stream_f32_bwd stashes fp32 for the
// fp32 dW (wgrad.cu).
// key_stream_i8_f32_fwd is the int8 forward beside fp32 compute: the int8
// walk, then the fp32 w_k product and bias on the unrounded y_k; its
// backward is key_stream_f32_bwd on the raw dots and scores it saved.

#include "key_stream.cuh"
#include "walk_wgmma_bwd.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
key_i8_fwd_kernel(const float* __restrict__ rec, int rec_w, int T, int K,
                  const float* __restrict__ rayo,
                  const float* __restrict__ rays,
                  const float* __restrict__ qq, int dm, float sqrt_dm,
                  WalkDescT<Op> kd, WalkQuant kq,
                  const Op* __restrict__ wk,
                  const float* __restrict__ bk, int dm_pad, int score_relu,
                  float bkg, float eps, float* __restrict__ attn,
                  float* __restrict__ raw, float* __restrict__ ss_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  key_rec_fwd_tile(walk_smem<Op>(smem), rec, rec_w, T, K, rayo, rays, qq, dm,
                   sqrt_dm, kd, wk, bk, dm_pad, score_relu, bkg, eps, attn,
                   raw, ss_out, &kq);
}

// Launcher of the int8 forwards on walk.cuh (key_rec_fwd_tile), Op the
// epilogue's operand type (bf16, or fp32 beside the int8 walk).
template <class Op>
static int launch_key_i8_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    const void* kwq, const void* kinv, const void* kdq, void* stream) {
  WalkDescT<Op> kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  WalkQuant kq;
  err = fill_walk_quant(&kq, kd, kmeta, kwq, kinv, kdq);
  if (err) return err;
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  if (T <= 0) return 0;
  const size_t smem = key_rec_fwd_smem(K);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      key_i8_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (T + kRows - 1) / kRows;
  key_i8_fwd_kernel<Op><<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kd, kq,
      static_cast<const Op*>(wk), static_cast<const float*>(bk), dm_pad,
      score_relu, bkg, eps, static_cast<float*>(attn),
      static_cast<float*>(raw), static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_fwd_wgmma_kernel(const __grid_constant__ StreamFwdWg p) {
  stream_fwd_wg<true>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_fwd_wgmma_f32_kernel(const __grid_constant__ StreamFwdWgT<float> p) {
  stream_fwd_wg<true, float>(p);
}

// The forward on wgmma, Op the operand form: the int8 forms' arguments (wk
// unread: the packed image replaces it), then the packed weights (the
// walk's layers, then w_k; ops/stream_attn.py key_stream_fwd: bf16
// pack_walk_wgmma's image, fp32 pack_walk_wgmma_f32's) and their size in
// bytes, and the grid (1 .. the number of 128-ray tiles); the softmax
// kernel after it (walk_wgmma.cuh launch_key_fwd_wg).
template <class Op>
static int launch_key_rec_fwd_wg(KEY_FWD_PARAMS, const void* wpack,
                                 long long wbytes, int grid, void* stream) {
  (void)wk;
  StreamFwdWgT<Op> p{};
  p.rec = rec;
  p.rec_w = rec_w;
  p.rayo = rayo;
  p.rays = rays;
  p.eps = eps;
  void (*kernel)(StreamFwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = key_fwd_wgmma_f32_kernel;
  else kernel = key_fwd_wgmma_kernel;
  return launch_key_fwd_wg(p, kernel, T, K, kmeta, kw, kb, kln, kplan, qq,
                           dm, sqrt_dm, bk, dm_pad, score_relu, bkg, attn,
                           raw, ss, wpack, wbytes, grid, stream);
}

extern "C" int papr_key_stream_fwd(KEY_FWD_PARAMS, const void* wpack,
                                   long long wbytes, int grid,
                                   void* stream) {
  return launch_key_rec_fwd_wg<__nv_bfloat16>(KEY_FWD_ARGS, wpack, wbytes,
                                              grid, stream);
}

extern "C" int papr_key_stream_f32_fwd(KEY_FWD_PARAMS, const void* wpack,
                                       long long wbytes, int grid,
                                       void* stream) {
  return launch_key_rec_fwd_wg<float>(KEY_FWD_ARGS, wpack, wbytes, grid,
                                      stream);
}

extern "C" int papr_key_stream_i8_fwd(KEY_FWD_PARAMS, const void* kwq,
                                      const void* kinv, const void* kdq,
                                      void* stream) {
  return launch_key_i8_fwd<__nv_bfloat16>(KEY_FWD_ARGS, kwq, kinv, kdq,
                                          stream);
}

extern "C" int papr_key_stream_i8_f32_fwd(KEY_FWD_PARAMS, const void* kwq,
                                          const void* kinv, const void* kdq,
                                          void* stream) {
  return launch_key_i8_fwd<float>(KEY_FWD_ARGS, kwq, kinv, kdq, stream);
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_bwd_wgmma_kernel(const __grid_constant__ StreamBwdWg p) {
  stream_bwd_wg<true>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_bwd_wgmma_f32_kernel(const __grid_constant__ StreamBwdWgT<float> p) {
  stream_bwd_wg<true, float>(p);
}

// The per-ray sums of the split tiles' second parts (zero elsewhere) added
// to the first parts', after key_bwd_wgmma_kernel.
__global__ void key_bwd_combine_kernel(float* dqq, const float* dqq_aux,
                                       int n_qq, float* drayo,
                                       const float* drayo_aux, float* drays,
                                       const float* drays_aux, int n_ray) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_qq; i += stride)
    dqq[i] += dqq_aux[i];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_ray; i += stride) {
    drayo[i] += drayo_aux[i];
    drays[i] += drays_aux[i];
  }
}

// The backward on wgmma, Op the operand form: the walk (its weights only
// through the packed image) and score head, the stash and partial rows
// (part has 8 rows and scratch 2 StreamBwdWgT::scr_wg floats a block), then
// the packed weights (forward layers, w_k, w_k^T, W_l^T for l = n-1 .. 0;
// ops/stream_attn.py key_stream_bwd: bf16 pack_walk_wgmma's image, fp32
// pack_walk_wgmma_f32's) and their size in bytes, the grid
// (1 .. the number of 128-ray tiles) and the zeroed aux buffers of dqq,
// d_rayo, d_rays.
template <class Op>
static int launch_key_bwd_wg(KEY_BWD_PARAMS_NS, const void* wpack,
                             long long wbytes, int grid, float* dqq_aux,
                             float* drayo_aux, float* drays_aux,
                             void* stream) {
  StreamBwdWgT<Op> p{};
  size_t smem = 0;
  int err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  err = fill_stream_bwd_wg(&p, kmeta, kw, kb, kln, kplan, dm_pad, wpack,
                           wbytes, stash, stash_off, part, part_w, scratch,
                           K, &smem);
  if (err) return err;
  p.dbk_off = p.bias_len + 2 * p.d.pd[0] + 2 * p.d.pd[p.d.n];
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
  p.qq = qq;
  p.dm = dm;
  p.sqrt_dm = sqrt_dm;
  p.raw = raw;
  p.ss = ss;
  p.dattn = dattn;
  p.bk = static_cast<const float*>(bk);
  p.dm_pad = dm_pad;
  p.score_relu = score_relu;
  p.bkg = bkg;
  p.dqq = dqq;
  if (grid < 1 || grid > p.Tp / kWgTile) return -209;
  p.n_units = p.Tp / kWgTile * K;
  p.grid = grid;
  p.dqq_aux = dqq_aux;
  p.drayo_aux = drayo_aux;
  p.drays_aux = drays_aux;
  void (*kernel)(StreamBwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = key_bwd_wgmma_f32_kernel;
  else kernel = key_bwd_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  key_bwd_combine_kernel<<<256, 256, 0, st>>>(dqq, dqq_aux, T * dm, drayo,
                                               drayo_aux, drays, drays_aux,
                                               T * 3);
  return (int)cudaGetLastError();
}

extern "C" int papr_key_stream_bwd(KEY_BWD_WG_PARAMS) {
  return launch_key_bwd_wg<__nv_bfloat16>(KEY_BWD_WG_ARGS);
}

extern "C" int papr_key_stream_f32_bwd(KEY_BWD_WG_PARAMS) {
  return launch_key_bwd_wg<float>(KEY_BWD_WG_ARGS);
}
