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
// and dW in wgrad.cu); compute bound. What the design does about it: as in
// attend_eval.cu, one block of 512 threads per 64-ray tile loops over k
// inside the block (the TPU grid's sequential k axis, which carried the
// scores and the dqq / d_rayo / d_rays sums in resident output blocks; here
// the block owns its rays' rows, so they accumulate without atomics), and
// every activation stays in shared memory. The record is read pre-gathered
// k-major, (K, T, rec_w), the JAX kernels' layout; d_rec is a plain
// (K, T, rec_w) output that autograd scatter-adds into the (P, rec_w) record.
//
// key_stream_i8_fwd is the forward with int8=True (tpu.int8_train,
// stream_attn.py:1013-1017): the walk's dense stack runs walk.cuh's int8
// walk on a quantization the wrapper calibrated on this call's record; the
// raw dots and masked scores it saves are the int8 forward's. The backward
// above takes no flag: it recomputes the walk in bf16 (straight-through; the
// fp32 backward after key_stream_i8_f32_fwd).
//
// key_stream_f32_fwd / key_stream_f32_bwd are the same two kernels on the
// fp32 walk (use_amp: false): fp32 walk, w_k product and bias (walk.cuh's
// 3xTF32 products), fp32 stash and dW. Shared memory is the bf16 kernels'
// byte for byte (walk.cuh), so key_rec_*_smem hold for both.
// key_stream_i8_f32_fwd is the int8 forward beside fp32 compute: the int8
// walk, then the fp32 w_k product and bias on the unrounded y_k; its
// backward is key_stream_f32_bwd on the raw dots and scores it saved.

#include "key_stream.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
key_fwd_kernel(const float* __restrict__ rec, int rec_w, int T, int K,
               const float* __restrict__ rayo, const float* __restrict__ rays,
               const float* __restrict__ qq, int dm, float sqrt_dm,
               WalkDescT<Op> kd, const Op* __restrict__ wk,
               const float* __restrict__ bk, int dm_pad, int score_relu,
               float bkg, float eps, float* __restrict__ attn,
               float* __restrict__ raw, float* __restrict__ ss_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  key_rec_fwd_tile(walk_smem<Op>(smem), rec, rec_w, T, K, rayo, rays, qq, dm,
                   sqrt_dm, kd, wk, bk, dm_pad, score_relu, bkg, eps, attn,
                   raw, ss_out);
}

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

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
key_bwd_kernel(const float* __restrict__ rec, int rec_w, int T, int Tp, int K,
               const float* __restrict__ rayo, const float* __restrict__ rays,
               const float* __restrict__ qq, int dm, float sqrt_dm,
               const float* __restrict__ raw, const float* __restrict__ ss,
               const float* __restrict__ dattn, WalkDescT<Op> kd,
               WalkBwdT<Op> kb, const Op* __restrict__ wkf,
               const Op* __restrict__ wkb,
               const float* __restrict__ bk, int dm_pad, int dbk_off,
               int score_relu, float bkg, float eps,
               const int* __restrict__ seg, int nsrc, float* drec,
               float* drayo, float* drays, float* dqq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  key_rec_bwd_tile(S, rec, rec_w, T, Tp, K, rayo, rays, qq, dm, sqrt_dm, raw,
                   ss, dattn, kd, kb, wkf, wkb, bk, dm_pad, dbk_off,
                   score_relu, bkg, eps, seg, nsrc, drec, drayo, drays, dqq,
                   reinterpret_cast<float*>(S.extra));
}

// Shared launcher of the forwards: Op the walk's operand type; with int8
// the three quantization buffers are read and the int8 kernel launched.
template <class Op>
static int launch_key_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    bool int8, const void* kwq, const void* kinv, const void* kdq,
    void* stream) {
  WalkDescT<Op> kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  WalkQuant kq;
  if (int8) {
    err = fill_walk_quant(&kq, kd, kmeta, kwq, kinv, kdq);
    if (err) return err;
  }
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  if (T <= 0) return 0;
  const size_t smem = key_rec_fwd_smem(K);
  if (smem > 232448) return -203;
  cudaError_t e = int8
      ? cudaFuncSetAttribute(key_i8_fwd_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem)
      : cudaFuncSetAttribute(key_fwd_kernel<Op>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (T + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Op* wkp = static_cast<const Op*>(wk);
  const float* bkp = static_cast<const float*>(bk);
  if (int8) {
    key_i8_fwd_kernel<Op><<<grid, kThreads, smem, st>>>(
        rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kd, kq, wkp, bkp,
        dm_pad, score_relu, bkg, eps, static_cast<float*>(attn),
        static_cast<float*>(raw), static_cast<float*>(ss));
    return (int)cudaGetLastError();
  }
  key_fwd_kernel<Op><<<grid, kThreads, smem, st>>>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kd, wkp, bkp, dm_pad,
      score_relu, bkg, eps, static_cast<float*>(attn),
      static_cast<float*>(raw), static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

extern "C" int papr_key_stream_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    void* stream) {
  return launch_key_fwd<__nv_bfloat16>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb, kln,
      kplan, wk, bk, dm_pad, score_relu, bkg, eps, attn, raw, ss, false,
      nullptr, nullptr, nullptr, stream);
}

extern "C" int papr_key_stream_f32_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    void* stream) {
  return launch_key_fwd<float>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb, kln,
      kplan, wk, bk, dm_pad, score_relu, bkg, eps, attn, raw, ss, false,
      nullptr, nullptr, nullptr, stream);
}

extern "C" int papr_key_stream_i8_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    const void* kwq, const void* kinv, const void* kdq, void* stream) {
  return launch_key_fwd<__nv_bfloat16>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb, kln,
      kplan, wk, bk, dm_pad, score_relu, bkg, eps, attn, raw, ss, true, kwq,
      kinv, kdq, stream);
}

extern "C" int papr_key_stream_i8_f32_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    const void* kwq, const void* kinv, const void* kdq, void* stream) {
  return launch_key_fwd<float>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb, kln,
      kplan, wk, bk, dm_pad, score_relu, bkg, eps, attn, raw, ss, true, kwq,
      kinv, kdq, stream);
}

// Launcher of the backward, Op the walk's operand type.
template <class Op>
static int launch_key_bwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const float* raw, const float* ss, const float* dattn, const int* kmeta,
    const void* kw, const void* kb, const void* kln, const void* kplan,
    const void* kwt, const void* wkf, const void* wkb, const void* bk,
    int dm_pad, int score_relu, float bkg, float eps, void* stash,
    const long long* stash_off, const int* seg, int nsrc, float* drec,
    float* drayo, float* drays, float* dqq, float* part, int part_w,
    float* scratch, void* stream) {
  WalkDescT<Op> kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  WalkBwdT<Op> wb;
  err = fill_walk_bwd(&wb, kd, kmeta, kwt, stash, stash_off, kd.n + 1, part,
                      part_w, scratch);
  if (err) return err;
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  const int dbk_off = wb.bias_len + 2 * kd.pd[0] + 2 * kd.pd[kd.n];
  if (part_w < dbk_off + dm_pad) return -204;
  if (T <= 0) return 0;
  const size_t smem = key_rec_bwd_smem(K);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      key_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  key_bwd_kernel<Op><<<Tp / kRows, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, Tp, K, rayo, rays, qq, dm, sqrt_dm, raw, ss, dattn, kd,
      wb, static_cast<const Op*>(wkf), static_cast<const Op*>(wkb),
      static_cast<const float*>(bk), dm_pad, dbk_off, score_relu, bkg, eps,
      seg, nsrc, drec, drayo, drays, dqq);
  return (int)cudaGetLastError();
}

#define KEY_BWD_PARAMS                                                       \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* qq, int dm, float sqrt_dm,               \
    const float* raw, const float* ss, const float* dattn, const int* kmeta, \
    const void* kw, const void* kb, const void* kln, const void* kplan,      \
    const void* kwt, const void* wkf, const void* wkb, const void* bk,       \
    int dm_pad, int score_relu, float bkg, float eps, void* stash,           \
    const long long* stash_off, const int* seg, int nsrc, float* drec,       \
    float* drayo, float* drays, float* dqq, float* part, int part_w,         \
    float* scratch, void* stream
#define KEY_BWD_ARGS                                                         \
    rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, raw, ss, dattn, kmeta,    \
    kw, kb, kln, kplan, kwt, wkf, wkb, bk, dm_pad, score_relu, bkg, eps,     \
    stash, stash_off, seg, nsrc, drec, drayo, drays, dqq, part, part_w,      \
    scratch, stream

extern "C" int papr_key_stream_bwd(KEY_BWD_PARAMS) {
  return launch_key_bwd<__nv_bfloat16>(KEY_BWD_ARGS);
}

extern "C" int papr_key_stream_f32_bwd(KEY_BWD_PARAMS) {
  return launch_key_bwd<float>(KEY_BWD_ARGS);
}
