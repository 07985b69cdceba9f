// Streamed key attention with the query chain folded in, forward and
// backward (tpu.query_fold with the record-native streams).
//
// Forward replaces papr_tpu/ops/stream_attn.py::key_stream_scores_recq
// (pallas_call at :1440, kernel body _ksrq_fwd_kernel :1201): the query
// walk on the RAW ray direction (posenc 39 -> LN -> 5 x 256 -> LN) and qq =
// linear(eq, w_q), written out as the fp32 (T, dm) residual; then the
// record-native key loop against that qq. Outputs attn (T, K+1), raw, ss
// (T, K) and qq (T, dm).
//
// Backward replaces _ksrq_bwd (pallas_call at :1547, kernel body
// _ksrq_bwd_kernel :1243): the key loop's backward sums dqq over k; then,
// once per ray, the query backward: dW_q / db_q from the stashed eq and
// dqq, dX through w_q^T and the reverse walk, the posenc backward to d_rayd
// (T, 3).
//
// What bounds it on the H100: the key walks, as key_stream.cu; the query
// chain adds one walk per K key walks (5 % at K = 20). The fold removes the
// query embedder's launches and the w_q matmuls of a step, not work.
//
// Forward, both forms (key_stream_q_fwd in bf16, key_stream_q_f32_fwd in
// fp32, use_amp: false; _ksrq_fwd_kernel with cdt = bfloat16 / float32): one
// entry point launches two kernels in turn on one stream. First the query
// chain on the embedder's wgmma walk with w_q as its head (embed_wgmma.cuh
// embed_fwd_wg<Op, true>: query_head_fwd_wgmma_kernel in bf16, activations
// in registers, the head's product in passes of 128 columns, each value
// rounded as JAX's bf16 _linear, linear_bf16; query_head_fwd_wgmma_f32_kernel
// in fp32, 3xTF32 m64n64k8 products, b_q added in fp32, qq never rounded;
// 128-ray tiles of a persistent grid), which writes qq (T, dm) fp32. Then
// the record-native key forward on that qq through key_stream.cu's own entry
// point (papr_key_stream_fwd / papr_key_stream_f32_fwd:
// key_fwd_wgmma_kernel / key_fwd_wgmma_f32_kernel, then
// key_fwd_softmax_kernel), so attn / raw / ss are bit-equal to
// key_stream_fwd's / key_stream_f32_fwd's on the same qq. Against the WMMA
// kernel it replaces (one 64-ray block of 512 threads, the query and key
// walks taking turns in shared memory) no rounding point moved: qq's values
// move only in the summation order of the w_q product.
//
// Backward, fp32 (key_stream_q_f32_bwd): two entry points called in turn by
// the wrapper (ops/stream_attn.py): key_stream.cu's papr_key_stream_f32_bwd
// (key_bwd_wgmma_f32_kernel and its combine kernel: d_rec, d_rayo, d_rays
// and dqq summed over k, bit-equal to key_stream_f32_bwd's), then
// papr_key_stream_q_f32_bwd, the query backward on the embedder's backward
// with the head (embed_bwd_wg<float, true>, query_head_bwd_wgmma_f32_kernel):
// the recomputed eq stashed for dW_q, dqq's column sums for db_q and dqq
// stashed, dqq w_q (the image's w_q^T layer) into the reverse walk, the
// posenc backward summed per raw column into d_rayd. dW of both walks and
// of w_k / w_q: wgrad_f32 on the stashes, after each launch.
// The images are the wrapper's: the query walk then w_q (forward), the
// query walk, w_q^T, W_l^T for l = n-1 .. 0 (backward); the key's as
// key_stream.cu's. The rounding points are JAX's _ksrq_*_kernel's: in fp32
// nothing is rounded.
//
// Backward, bf16 (key_stream_q_bwd): one kernel on walk.cuh's WMMA layers,
// one block of 512 threads a 64-ray tile: the key loop of key_stream.cuh
// (dqq summed over k in the (T, dm) device buffer the kernel writes
// anyway: a block reads back only rows it wrote itself, L2-resident, 64 KB
// a tile, after a barrier, through ordinary loads), then the query backward
// once per tile. Shared memory is full with one walk's buffers (two
// activation tiles, the accumulator, the staged weights), so the query and
// key walks take turns in them, one staged layer at a time. The query
// stashes are T rows, not K * T: the query walk has WalkBwd buffers of its
// own.

#include "embed_wgmma.cuh"
#include "key_stream.cuh"

using namespace papr;

// ------------------------------------------- bf16 backward: on WMMA walks ----

__global__ void __launch_bounds__(kThreads, 1)
keyq_bwd_kernel(const float* __restrict__ rec, int rec_w, int T, int Tp, int K,
                const float* __restrict__ rayo, const float* __restrict__ rays,
                const float* __restrict__ rayd, const float* __restrict__ qq,
                int dm, float sqrt_dm, const float* __restrict__ raw,
                const float* __restrict__ ss, const float* __restrict__ dattn,
                WalkDesc kd, WalkBwd kb,
                const __nv_bfloat16* __restrict__ wkf,
                const __nv_bfloat16* __restrict__ wkb,
                const float* __restrict__ bk, WalkDesc qd, WalkBwd qb,
                const __nv_bfloat16* __restrict__ wqb, int dm_pad,
                int dbk_off, int dbq_off, int score_relu, float bkg,
                float eps, const int* __restrict__ seg, int nsrc,
                const int* __restrict__ qseg, float* drec, float* drayo,
                float* drays, float* __restrict__ drayd, float* dqq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem S = walk_smem(smem);
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
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * dm_pad; i += kThreads) {
    const int r = i / dm_pad, c = i - r * dm_pad, t = t0 + r;
    const float g = t < T && c < dm ? dqq[(size_t)t * dm + c] : 0.f;
    C[r * kCLd + c] = g;
    const __nv_bfloat16 h = __float2bfloat16_rn(g);
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

extern "C" int papr_key_stream_q_bwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* rayd, const float* qq, int dm,
    float sqrt_dm, const float* raw, const float* ss, const float* dattn,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* kwt, const void* wkf, const void* wkb,
    const void* bk, const int* qmeta, const void* qw, const void* qb,
    const void* qln, const void* qplan, const void* qwt, const void* wqb,
    int dm_pad, int score_relu, float bkg, float eps, void* kstash,
    const long long* kstash_off, void* qstash, const long long* qstash_off,
    const int* seg, int nsrc, const int* qseg, float* drec, float* drayo,
    float* drays, float* drayd, float* dqq, float* kpart, int kpart_w,
    float* kscratch, float* qpart, int qpart_w, float* qscratch,
    void* stream) {
  WalkDesc kd, qd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  err = fill_walk(&qd, qmeta, qw, qb, qln, qplan);
  if (err) return err;
  WalkBwd kwb, qwb;
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
      keyq_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  keyq_bwd_kernel<<<Tp / kRows, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, Tp, K, rayo, rays, rayd, qq, dm, sqrt_dm, raw, ss, dattn,
      kd, kwb, static_cast<const __nv_bfloat16*>(wkf),
      static_cast<const __nv_bfloat16*>(wkb), static_cast<const float*>(bk),
      qd, qwb, static_cast<const __nv_bfloat16*>(wqb), dm_pad, dbk_off,
      dbq_off, score_relu, bkg, eps, seg, nsrc, qseg, drec, drayo, drays,
      drayd, dqq);
  return (int)cudaGetLastError();
}

// ------------------------------------------ on wgmma + TMA: both forms ----

__global__ void __launch_bounds__(kWgThreads, 1)
query_head_fwd_wgmma_kernel(const __grid_constant__ EmbedFwdWg p) {
  embed_fwd_wg<__nv_bfloat16, true>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
query_head_fwd_wgmma_f32_kernel(const __grid_constant__ EmbedFwdWgT<float> p) {
  embed_fwd_wg<float, true>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
query_head_bwd_wgmma_f32_kernel(const __grid_constant__ EmbedBwdWgT<float> p) {
  embed_bwd_wg<float, true>(p);
}

// The forward's arguments: the key's as papr_key_stream_fwd takes them
// without w_k (qq its output here), the raw ray directions rayd, the query
// walk and b_q, then the key's image kpack / kbytes (the key walk, then w_k;
// ops/stream_attn.py fwd_wgmma_pack / fwd_wgmma_pack_f32), the query's
// qpack / qbytes (the query walk, then w_q), and the grid (1 .. the number
// of 128-ray tiles; both launches take it).
#define KEYQ_FWD_PARAMS                                                      \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* rayd, int dm, float sqrt_dm,             \
    const int* kmeta, const void* kw, const void* kb, const void* kln,       \
    const void* kplan, const void* bk, const int* qmeta, const void* qw,     \
    const void* qb, const void* qln, const void* qplan, const void* bq,      \
    int dm_pad, int score_relu, float bkg, float eps, void* attn, void* raw, \
    void* ss, void* qq, const void* kpack, long long kbytes,                 \
    const void* qpack, long long qbytes, int grid, void* stream
#define KEYQ_FWD_ARGS                                                        \
    rec, rec_w, T, K, rayo, rays, rayd, dm, sqrt_dm, kmeta, kw, kb, kln,     \
    kplan, bk, qmeta, qw, qb, qln, qplan, bq, dm_pad, score_relu, bkg, eps,  \
    attn, raw, ss, qq, kpack, kbytes, qpack, qbytes, grid, stream

// The forward in the operand form Op: the query head's kernel, then the key
// forward's entry point of that form.
template <class Op>
static int launch_keyq_fwd(KEYQ_FWD_PARAMS) {
  int err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  EmbedFwdWgT<Op> p{};
  size_t smem = 0;
  err = fill_embed_fwd_wg(&p, qmeta, qw, qb, qln, qplan, dm_pad, qpack,
                          qbytes, &smem);
  if (err) return err;
  if (T <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(qq) % 16) return -210;
  p.x = rayd;
  p.d_raw = 3;
  p.hb = static_cast<const float*>(bq);
  p.hy = static_cast<float*>(qq);
  p.d_head = dm;
  void (*kernel)(EmbedFwdWgT<Op>);
  int (*key_fwd)(KEY_FWD_PARAMS, const void*, long long, int, void*);
  if constexpr (kF32<Op>) {
    kernel = query_head_fwd_wgmma_f32_kernel;
    key_fwd = papr_key_stream_f32_fwd;
  } else {
    kernel = query_head_fwd_wgmma_kernel;
    key_fwd = papr_key_stream_fwd;
  }
  err = launch_embed_fwd_wg(p, kernel, T, grid, smem,
                            static_cast<cudaStream_t>(stream));
  if (err) return err;
  return key_fwd(rec, rec_w, T, K, rayo, rays, static_cast<const float*>(qq),
                 dm, sqrt_dm, kmeta, kw, kb, kln, kplan, nullptr, bk, dm_pad,
                 score_relu, bkg, eps, attn, raw, ss, kpack, kbytes, grid,
                 stream);
}

extern "C" int papr_key_stream_q_fwd(KEYQ_FWD_PARAMS) {
  return launch_keyq_fwd<__nv_bfloat16>(KEYQ_FWD_ARGS);
}

extern "C" int papr_key_stream_q_f32_fwd(KEYQ_FWD_PARAMS) {
  return launch_keyq_fwd<float>(KEYQ_FWD_ARGS);
}

// The fp32 query backward, after papr_key_stream_f32_bwd has summed dqq
// (T, dm) over k: the raw ray directions rayd, the query walk, the stash
// (fp32 over T rows with w_q, ops/fused_mlp.py bwd_wgmma_buffers) and the
// posenc segments of rayd's three sources, dqq, d_rayd (T, 3), the partial
// rows and scratch, the image (the query walk, w_q^T, W_l^T for
// l = n-1 .. 0) and its bytes, and the grid.
extern "C" int papr_key_stream_q_f32_bwd(
    const float* rayd, int T, int dm, const int* qmeta, const void* qw,
    const void* qb, const void* qln, const void* qplan, int dm_pad,
    void* qstash, const long long* qstash_off, const int* qseg,
    const float* dqq, float* drayd, float* qpart, int qpart_w,
    float* qscratch, const void* qpack, long long qbytes, int grid,
    void* stream) {
  int err = check_score_head(dm, dm_pad, 1);
  if (err) return err;
  EmbedBwdWgT<float> p{};
  size_t smem = 0;
  err = fill_embed_bwd_wg(&p, qmeta, qw, qb, qln, qplan, 3, dm_pad, qpack,
                          qbytes, qstash, qstash_off, qpart, qpart_w,
                          qscratch, &smem);
  if (err) return err;
  if (T <= 0) return 0;
  p.x = rayd;
  p.dy = dqq;
  p.d_head = dm;
  p.seg = qseg;
  p.dx = drayd;
  return launch_embed_bwd_wg(p, query_head_bwd_wgmma_f32_kernel, T, grid,
                             smem, static_cast<cudaStream_t>(stream));
}
