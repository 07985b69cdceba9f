// Streamed key attention with the query chain folded in, forward and
// backward (tpu.query_fold with the record-native streams).
//
// Forward replaces papr_tpu/ops/stream_attn.py::key_stream_scores_recq
// (pallas_call at :1440, kernel body _ksrq_fwd_kernel :1201): per ray tile
// first the query walk on the RAW ray direction (posenc 39 -> LN -> 5 x 256
// -> LN) and qq = linear(eq, w_q) with the linear layer's own bf16 epilogue,
// written out as the fp32 (T, dm) residual; then the record-native key loop
// of key_stream.cu against that qq. Outputs attn (T, K+1), raw, ss (T, K)
// and qq (T, dm).
//
// Backward replaces _ksrq_bwd (pallas_call at :1547, kernel body
// _ksrq_bwd_kernel :1243): the key loop's backward (key_stream.cuh) sums dqq
// over k into the block's own rows; then, ONCE per tile, the query backward:
// recompute the query walk, dW_q / db_q from the bf16 dqq stash and the fp32
// column sums, dX through w_q^T and the reverse walk, the posenc backward to
// d_rayd (T, 3).
//
// What bounds it on the H100: the key walks, as key_stream.cu; the query
// chain adds one walk per K key walks (5 % at K = 20). What the design does
// about it: the fold removes the query embedder's two launches and the w_q
// matmuls of a step, not work. Shared memory is full with one walk's buffers
// (two activation tiles, the accumulator, the staged weights), so the query
// and key walks take turns in them, one staged layer at a time, and qq / dqq
// live in the (T, dm) device buffers the kernel writes anyway: a block reads
// back only rows it wrote itself (L2-resident, 64 KB a tile), after a
// barrier, through ordinary loads. The query stashes are T rows, not K * T:
// the query walk has WalkBwd buffers of its own.
//
// key_stream_q_f32_fwd / key_stream_q_f32_bwd are the same two kernels on the
// fp32 walks (use_amp: false; _ksrq_*_kernel with cdt = float32): the query
// walk, w_q and its bias in fp32 (linear_c<float>: qq is never rounded), the
// key walk and w_k as key_stream_f32_*, fp32 stashes (dqq included) and dW
// through wgrad_f32. Shared memory is the bf16 kernels' byte for byte
// (walk.cuh): the fp32 activations live in C, and qq / dqq stay in the
// (T, dm) fp32 device buffers.

#include "key_stream.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
keyq_fwd_kernel(const float* __restrict__ rec, int rec_w, int T, int K,
                const float* __restrict__ rayo, const float* __restrict__ rays,
                const float* __restrict__ rayd, int dm, float sqrt_dm,
                WalkDescT<Op> kd, const Op* __restrict__ wk,
                const float* __restrict__ bk, WalkDescT<Op> qd,
                const Op* __restrict__ wq,
                const float* __restrict__ bq, int dm_pad, int score_relu,
                float bkg, float eps, float* __restrict__ attn,
                float* __restrict__ raw, float* __restrict__ ss_out,
                float* qq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  const int t0 = blockIdx.x * kRows;

  // The query chain, once per tile (_ksrq_fwd_kernel :1211-1215).
  encode_raw(S.C, qd, rayd, t0, T, 3);
  __syncthreads();
  run_walk(S, qd, true);              // eq: bf16 in A[0], or fp32 in C
  dense_layer(S.A[0], S.C, nullptr, S.W, wq, nullptr, qd.pd[qd.n], dm_pad, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * dm; i += kThreads) {
    const int r = i / dm, c = i - r * dm, t = t0 + r;
    if (t < T) qq[(size_t)t * dm + c] = linear_c<Op>(S.C[r * kCLd + c], bq[c]);
  }
  __syncthreads();

  key_rec_fwd_tile(S, rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kd, wk,
                   bk, dm_pad, score_relu, bkg, eps, attn, raw, ss_out);
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
keyq_bwd_kernel(const float* __restrict__ rec, int rec_w, int T, int Tp, int K,
                const float* __restrict__ rayo, const float* __restrict__ rays,
                const float* __restrict__ rayd, const float* __restrict__ qq,
                int dm, float sqrt_dm, const float* __restrict__ raw,
                const float* __restrict__ ss, const float* __restrict__ dattn,
                WalkDescT<Op> kd, WalkBwdT<Op> kb,
                const Op* __restrict__ wkf, const Op* __restrict__ wkb,
                const float* __restrict__ bk, WalkDescT<Op> qd,
                WalkBwdT<Op> qb, const Op* __restrict__ wqb, int dm_pad,
                int dbk_off,
                int dbq_off, int score_relu, float bkg, float eps,
                const int* __restrict__ seg, int nsrc,
                const int* __restrict__ qseg, float* drec, float* drayo,
                float* drays, float* __restrict__ drayd, float* dqq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  float* C = S.C;
  float* st = reinterpret_cast<float*>(S.extra);             // 4 x kRows
  const int t0 = blockIdx.x * kRows;

  key_rec_bwd_tile(S, rec, rec_w, T, Tp, K, rayo, rays, qq, dm, sqrt_dm, raw,
                   ss, dattn, kd, kb, wkf, wkb, bk, dm_pad, dbk_off,
                   score_relu, bkg, eps, seg, nsrc, drec, drayo, drays, dqq,
                   st);

  // The query backward, once per tile, from the dqq summed over k
  // (_ksrq_bwd_kernel :1339-1359).
  const int m = qd.n, pdm = qd.pd[m];
  encode_raw(C, qd, rayd, t0, T, 3);
  __syncthreads();
  const TileCtx ctx = tile_ctx(qd, qb, (size_t)t0, st);
  walk_fwd_stash(S, qd, qb, ctx, true);          // eq_c in A[0]
  stash_tile(S.A[0], qb.hs[m], ctx.row0, pdm);
  __syncthreads();                // fp32: A[0] is C, overwritten below
  for (int i = threadIdx.x; i < kRows * dm_pad; i += kThreads) {
    const int r = i / dm_pad, c = i - r * dm_pad, t = t0 + r;
    const float g = t < T && c < dm ? dqq[(size_t)t * dm + c] : 0.f;
    C[r * kCLd + c] = g;
    const Op h = to_act<Op>(g);
    S.A[1][r * kALd + c] = h;
    qb.dz[m][(ctx.row0 + r) * dm_pad + c] = h;
  }
  __syncthreads();
  colsum_add(C, dm_pad, ctx.part + dbq_off);
  dense_layer(S.A[1], C, nullptr, S.W, wqb, nullptr, dm_pad, pdm, 0);
  __syncthreads();
  walk_bwd(S, qd, qb, ctx);
  pe_bwd_deriv(C, qd, [&](int r, int src) {
    const int t = t0 + r;
    return t < T ? rayd[(size_t)t * 3 + src] : 0.f;
  });
  __syncthreads();
  pe_source_sums(C, qseg, 3, [&](int r, int src, float v) {
    const int t = t0 + r;
    if (t < T) drayd[(size_t)t * 3 + src] = v;
  });
}

#define KEYQ_FWD_PARAMS                                                      \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* rayd, int dm, float sqrt_dm,             \
    const int* kmeta, const void* kw, const void* kb, const void* kln,       \
    const void* kplan, const void* wk, const void* bk, const int* qmeta,     \
    const void* qw, const void* qb, const void* qln, const void* qplan,      \
    const void* wq, const void* bq, int dm_pad, int score_relu, float bkg,   \
    float eps, void* attn, void* raw, void* ss, void* qq, void* stream
#define KEYQ_FWD_ARGS                                                        \
    rec, rec_w, T, K, rayo, rays, rayd, dm, sqrt_dm, kmeta, kw, kb, kln,     \
    kplan, wk, bk, qmeta, qw, qb, qln, qplan, wq, bq, dm_pad, score_relu,    \
    bkg, eps, attn, raw, ss, qq, stream
#define KEYQ_BWD_PARAMS                                                      \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* rayd, const float* qq, int dm,           \
    float sqrt_dm, const float* raw, const float* ss, const float* dattn,    \
    const int* kmeta, const void* kw, const void* kb, const void* kln,       \
    const void* kplan, const void* kwt, const void* wkf, const void* wkb,    \
    const void* bk, const int* qmeta, const void* qw, const void* qb,        \
    const void* qln, const void* qplan, const void* qwt, const void* wqb,    \
    int dm_pad, int score_relu, float bkg, float eps, void* kstash,          \
    const long long* kstash_off, void* qstash, const long long* qstash_off,  \
    const int* seg, int nsrc, const int* qseg, float* drec, float* drayo,    \
    float* drays, float* drayd, float* dqq, float* kpart, int kpart_w,       \
    float* kscratch, float* qpart, int qpart_w, float* qscratch,             \
    void* stream
#define KEYQ_BWD_ARGS                                                        \
    rec, rec_w, T, K, rayo, rays, rayd, qq, dm, sqrt_dm, raw, ss, dattn,     \
    kmeta, kw, kb, kln, kplan, kwt, wkf, wkb, bk, qmeta, qw, qb, qln, qplan, \
    qwt, wqb, dm_pad, score_relu, bkg, eps, kstash, kstash_off, qstash,      \
    qstash_off, seg, nsrc, qseg, drec, drayo, drays, drayd, dqq, kpart,      \
    kpart_w, kscratch, qpart, qpart_w, qscratch, stream

template <class Op>
static int launch_keyq_fwd(KEYQ_FWD_PARAMS) {
  WalkDescT<Op> kd, qd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  err = fill_walk(&qd, qmeta, qw, qb, qln, qplan);
  if (err) return err;
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  if (T <= 0) return 0;
  const size_t smem = key_rec_fwd_smem(K);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      keyq_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  keyq_fwd_kernel<Op><<<(T + kRows - 1) / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, K, rayo, rays, rayd, dm, sqrt_dm, kd,
      static_cast<const Op*>(wk), static_cast<const float*>(bk),
      qd, static_cast<const Op*>(wq),
      static_cast<const float*>(bq), dm_pad, score_relu, bkg, eps,
      static_cast<float*>(attn), static_cast<float*>(raw),
      static_cast<float*>(ss), static_cast<float*>(qq));
  return (int)cudaGetLastError();
}

template <class Op>
static int launch_keyq_bwd(KEYQ_BWD_PARAMS) {
  WalkDescT<Op> kd, qd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  err = fill_walk(&qd, qmeta, qw, qb, qln, qplan);
  if (err) return err;
  WalkBwdT<Op> kwb, qwb;
  err = fill_walk_bwd(&kwb, kd, kmeta, kwt, kstash, kstash_off, kd.n + 1,
                      kpart, kpart_w, kscratch);
  if (err) return err;
  err = fill_walk_bwd(&qwb, qd, qmeta, qwt, qstash, qstash_off, qd.n + 1,
                      qpart, qpart_w, qscratch);
  if (err) return err;
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  const int dbk_off = kwb.bias_len + 2 * kd.pd[0] + 2 * kd.pd[kd.n];
  const int dbq_off = qwb.bias_len + 2 * qd.pd[0] + 2 * qd.pd[qd.n];
  if (kpart_w < dbk_off + dm_pad || qpart_w < dbq_off + dm_pad) return -204;
  if (T <= 0) return 0;
  const size_t smem = key_rec_bwd_smem(K);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      keyq_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  keyq_bwd_kernel<Op><<<Tp / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, Tp, K, rayo, rays, rayd, qq, dm, sqrt_dm, raw, ss, dattn,
      kd, kwb, static_cast<const Op*>(wkf),
      static_cast<const Op*>(wkb), static_cast<const float*>(bk),
      qd, qwb, static_cast<const Op*>(wqb), dm_pad, dbk_off,
      dbq_off, score_relu, bkg, eps, seg, nsrc, qseg, drec, drayo, drays,
      drayd, dqq);
  return (int)cudaGetLastError();
}

extern "C" int papr_key_stream_q_fwd(KEYQ_FWD_PARAMS) {
  return launch_keyq_fwd<__nv_bfloat16>(KEYQ_FWD_ARGS);
}

extern "C" int papr_key_stream_q_f32_fwd(KEYQ_FWD_PARAMS) {
  return launch_keyq_fwd<float>(KEYQ_FWD_ARGS);
}

extern "C" int papr_key_stream_q_bwd(KEYQ_BWD_PARAMS) {
  return launch_keyq_bwd<__nv_bfloat16>(KEYQ_BWD_ARGS);
}

extern "C" int papr_key_stream_q_f32_bwd(KEYQ_BWD_PARAMS) {
  return launch_keyq_bwd<float>(KEYQ_BWD_ARGS);
}
