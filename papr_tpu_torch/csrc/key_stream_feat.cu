// Streamed key attention from RAW FEATURE tensors, forward and backward
// (tpu.fused_attn: stream).
//
// Forward replaces papr_tpu/ops/stream_attn.py::key_stream_scores
// (pallas_call at :303, kernel body _ks_fwd_kernel :133): per (ray, k) the
// key posenc of xk[k, t] (9 -> 117, plus pass-through extras) -> LN -> 5 x
// 256 -> LN -> w_k -> scaled dot with qq -> score_act x influence,
// alive-masked (influence and alive are (T, K) arrays); then the
// background-token softmax. Outputs attn (T, K+1) and the raw dots (T, K).
//
// Backward replaces _ks_bwd (pallas_call at :361, kernel body _ks_bwd_kernel
// :159): the softmax recomputed from raw, influence and alive and its
// backward; d_influence = ds x score_act(raw), an output of its own; then per
// k a recompute of the walk and the reverse chain: dqq, dW_k / db_k, the
// walk's gradients, and the posenc backward summed per raw source into dxk
// (K, T, d_raw). All of dxk is returned: the caller detaches the position
// columns before they enter xk, so autograd drops them there.
//
// What bounds it on the H100: the walks, as key_stream.cu (compute bound);
// xk adds 36 B a token to read and dxk as much to write. Both backwards are
// the WMMA design of PRs 1-7 (walk.cuh / walk_bwd.cuh): one block of 512
// threads per 64-ray tile, k inside the block, every activation in shared
// memory, ds / dqq owned by the block (no atomics), dW through the stash
// and wgrad.cu; the encode stage reads x[k, t, src] by the column plan, as
// the embedder kernel does. key_stream_feat_f32_bwd is the same backward on
// the fp32 walk (use_amp: false; _ks_bwd_kernel with cdt = float32): the
// walk, the w_k product and its bias in fp32 (walk.cuh's 3xTF32 products;
// y_k is never rounded), fp32 stashes and dW through wgrad_f32; the same
// shared memory.
//
// The forward, both forms (key_stream_feat_fwd in bf16,
// key_stream_feat_f32_fwd in fp32; _ks_fwd_kernel with cdt = bfloat16 /
// float32), runs on wgmma: key_feat_fwd_wgmma_kernel /
// key_feat_fwd_wgmma_f32_kernel are walk_wgmma.cuh's stream_fwd_wg, the
// record key forwards' function (key_stream.cu key_fwd_wgmma_kernel /
// key_fwd_wgmma_f32_kernel), with the token source FeatTok: per k step a
// warpgroup encodes its 64 rays' rows of xk[k] (scalar loads by the column
// plan) into shared memory, and the walk and the w_k product run on the
// TMA-fed weight ring (ops/stream_attn.py fwd_wgmma_pack /
// fwd_wgmma_pack_f32): bf16, m64n128k16 products with the activations in
// registers between layers, rounded to bf16 where walk.cuh rounds them and
// y_k rounded before w_k, whose bias is added as linear_bf16 adds it;
// fp32, 3xTF32 m64n64k8 products with fp32 activations. 128 rays a block on
// a persistent grid over (tile, k) units; the raw dot and the masked score
// (influence and alive from the (T, K) arrays) go to raw / ss, and
// key_fwd_softmax_kernel takes the softmax after it. Against the WMMA
// kernels no rounding point moved: the products are summed in another
// order (bf16: 16-deep wgmma steps in one accumulator per 128-column pass,
// where WMMA summed 16-deep fragments in its own order; fp32: the partial
// products join the fp32 sum once per 32-deep chunk instead of once per
// 8-deep step), which can flip a bf16 rounding of an activation; the masked
// scores pass through ss in device memory (fp32, unchanged) to a softmax
// kernel of their own. Bound by operations (fp32: three tensor-core
// products per fp32-accurate one); xk adds 36 B a token.

#include "walk_wgmma.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
keyf_bwd_kernel(const float* __restrict__ x, int d_raw, int T, int Tp, int K,
                const float* __restrict__ qq, int dm, float sqrt_dm,
                const float* __restrict__ influ,
                const float* __restrict__ alive,
                const float* __restrict__ raw,
                const float* __restrict__ dattn, WalkDescT<Op> kd,
                WalkBwdT<Op> kb, const Op* __restrict__ wkf,
                const Op* __restrict__ wkb,
                const float* __restrict__ bk, int dm_pad, int dbk_off,
                int score_relu, float bkg, const int* __restrict__ seg,
                float* __restrict__ dx, float* dqq,
                float* __restrict__ dinflu) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> S = walk_smem<Op>(smem);
  float* C = S.C;
  float* st = reinterpret_cast<float*>(S.extra);             // 4 x kRows
  float* ds = st + 4 * kRows;                                // kRows x K
  float* draw = ds + kRows * K;                              // kRows
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

  // Softmax backward, the masked scores recomputed from the saved raw dots
  // (_ks_bwd_kernel :183-191), and d_influence for every slot at once (:195).
  softmax_bwd_rows(ds, K, bkg, t0, T, dattn, [&](int t, int k) {
    const size_t i = (size_t)t * K + k;
    return masked_score(raw[i], score_relu, influ[i], alive[i] > 0.5f);
  });
  __syncthreads();
  for (int i = tid; i < kRows * K; i += kThreads) {
    const int r = i / K, t = t0 + r;
    if (t >= T) continue;
    const float rw = raw[(size_t)t * K + (i - r * K)];
    dinflu[(size_t)t * K + (i - r * K)] =
        ds[i] * (score_relu ? fmaxf(rw, 0.f) : rw);
  }

  for (int k = 0; k < K; ++k) {
    const float* xk = x + (size_t)k * T * d_raw;
    if (tid < kRows) {
      const int t = t0 + tid;
      draw[tid] = t < T
          ? draw_of(ds[tid * K + k], raw[(size_t)t * K + k],
                    influ[(size_t)t * K + k], score_relu, sqrt_dm)
          : 0.f;
    }
    encode_raw(C, kd, xk, t0, T, d_raw);
    __syncthreads();
    const TileCtx ctx = tile_ctx(kd, kb, (size_t)k * Tp + t0, st);
    walk_fwd_stash(S, kd, kb, ctx, true);        // y_c in A[0]
    key_head_bwd(S, kd, kb, ctx, wkf, wkb, bk, dm, dm_pad, dbk_off, qq, dqq,
                 draw, t0, T);
    walk_bwd(S, kd, kb, ctx);

    pe_bwd_deriv(C, kd, [&](int r, int src) {
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
}

#define KEYF_FWD_PARAMS_NS                                                   \
    const float* x, int d_raw, int T, int K, const float* qq, int dm,        \
    float sqrt_dm, const float* influ, const float* alive, const int* kmeta, \
    const void* kw, const void* kb, const void* kln, const void* kplan,      \
    const void* wk, const void* bk, int dm_pad, int score_relu, float bkg,   \
    void* attn, void* raw
#define KEYF_BWD_PARAMS                                                      \
    const float* x, int d_raw, int T, int K, const float* qq, int dm,        \
    float sqrt_dm, const float* influ, const float* alive, const float* raw, \
    const float* dattn, const int* kmeta, const void* kw, const void* kb,    \
    const void* kln, const void* kplan, const void* kwt, const void* wkf,    \
    const void* wkb, const void* bk, int dm_pad, int score_relu, float bkg,  \
    void* stash, const long long* stash_off, const int* seg, float* dx,      \
    float* dqq, float* dinflu, float* part, int part_w, float* scratch,      \
    void* stream

template <class Op>
static int launch_keyf_bwd(KEYF_BWD_PARAMS) {
  WalkDescT<Op> kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  WalkBwdT<Op> wb;
  err = fill_walk_bwd(&wb, kd, kmeta, kwt, stash, stash_off, kd.n + 1, part,
                      part_w, scratch);
  if (err) return err;
  err = check_score_head(dm, dm_pad, K);
  if (err) return err;
  if (d_raw <= 0 || d_raw > kMaxWidth) return -205;
  const int dbk_off = wb.bias_len + 2 * kd.pd[0] + 2 * kd.pd[kd.n];
  if (part_w < dbk_off + dm_pad) return -204;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows * (4 + K + 1);
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      keyf_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  keyf_bwd_kernel<Op><<<Tp / kRows, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, d_raw, T, Tp, K, qq, dm, sqrt_dm, influ, alive, raw, dattn, kd, wb,
      static_cast<const Op*>(wkf),
      static_cast<const Op*>(wkb), static_cast<const float*>(bk),
      dm_pad, dbk_off, score_relu, bkg, seg, dx, dqq, dinflu);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_feat_fwd_wgmma_kernel(const __grid_constant__ StreamFwdWg p) {
  stream_fwd_wg<true, __nv_bfloat16, FeatTok>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
key_feat_fwd_wgmma_f32_kernel(const __grid_constant__ StreamFwdWgT<float> p) {
  stream_fwd_wg<true, float, FeatTok>(p);
}

#define KEYF_FWD_PARAMS                                                      \
    KEYF_FWD_PARAMS_NS, void* ss, const void* wpack, long long wbytes,       \
    int grid, void* stream
#define KEYF_FWD_ARGS                                                        \
    x, d_raw, T, K, qq, dm, sqrt_dm, influ, alive, kmeta, kw, kb, kln,       \
    kplan, wk, bk, dm_pad, score_relu, bkg, attn, raw, ss, wpack, wbytes,    \
    grid, stream
#define KEYF_BWD_ARGS                                                        \
    x, d_raw, T, K, qq, dm, sqrt_dm, influ, alive, raw, dattn, kmeta, kw,    \
    kb, kln, kplan, kwt, wkf, wkb, bk, dm_pad, score_relu, bkg, stash,       \
    stash_off, seg, dx, dqq, dinflu, part, part_w, scratch, stream

// The forward on wgmma in the operand form Op: the WMMA-era argument list
// before its stream (wk unread: the packed image replaces it), the (T, K)
// masked scores ss, then the packed weights (the walk's layers, then w_k;
// ops/stream_attn.py fwd_wgmma_pack / fwd_wgmma_pack_f32), their size in
// bytes and the grid (1 .. the number of 128-ray tiles); the softmax kernel
// after it (walk_wgmma.cuh launch_key_fwd_wg). The block's shared memory
// (fill_stream_fwd_wg's layout: in the bf16 form the zero chunk, the staged
// parameter rows and b_k, the encoding rows; at least two ring stages) is
// checked there before the launch (-203 if it does not fit).
template <class Op>
static int launch_keyf_fwd_wg(KEYF_FWD_PARAMS) {
  (void)wk;
  if (d_raw <= 0 || d_raw > kMaxWidth) return -205;
  StreamFwdWgT<Op> p{};
  p.x = x;
  p.d_raw = d_raw;
  p.influ = influ;
  p.alive = alive;
  void (*kernel)(StreamFwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = key_feat_fwd_wgmma_f32_kernel;
  else kernel = key_feat_fwd_wgmma_kernel;
  return launch_key_fwd_wg(p, kernel, T, K, kmeta, kw, kb, kln, kplan, qq,
                           dm, sqrt_dm, bk, dm_pad, score_relu, bkg, attn,
                           raw, ss, wpack, wbytes, grid, stream);
}

extern "C" int papr_key_stream_feat_fwd(KEYF_FWD_PARAMS) {
  return launch_keyf_fwd_wg<__nv_bfloat16>(KEYF_FWD_ARGS);
}

extern "C" int papr_key_stream_feat_f32_fwd(KEYF_FWD_PARAMS) {
  return launch_keyf_fwd_wg<float>(KEYF_FWD_ARGS);
}

extern "C" int papr_key_stream_feat_bwd(KEYF_BWD_PARAMS) {
  return launch_keyf_bwd<__nv_bfloat16>(KEYF_BWD_ARGS);
}

extern "C" int papr_key_stream_feat_f32_bwd(KEYF_BWD_PARAMS) {
  return launch_keyf_bwd<float>(KEYF_BWD_ARGS);
}
