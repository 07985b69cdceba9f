// The record-native key stream on one tile of kRows rays (walk.cuh's WMMA
// walk): the forward k loop with its softmax, and the backward k loop from
// the softmax backward to d_rec / d_rayo / d_rays / dqq. The forward is
// shared by key_stream.cu's int8 forwards (the query projected outside the
// kernel) and key_stream_q.cu's bf16 form (the query chain inside it),
// which differ only in where qq comes from; the backward is key_stream_q.cu's
// bf16 form (key_stream.cu's bf16 and fp32 forwards and backwards run
// walk_wgmma.cuh / walk_wgmma_bwd.cuh, and so does the fp32 folded key
// stream, through key_stream.cu's entry points declared at the end).

#pragma once

#include "rec_stream.cuh"
#include "stream_common.cuh"

namespace papr {

// Shared memory after the walk's buffers (floats, then kRows ints).
inline size_t key_rec_fwd_smem(int K) {
  return kWalkSmem + sizeof(float) * kRows * (kGeo + K) + sizeof(int) * kRows;
}
inline size_t key_rec_bwd_smem(int K) {
  return kWalkSmem + sizeof(float) * kRows * (kGeo + K + 4 + 2 + kNGeoSrc) +
      sizeof(int) * kRows;
}

// Per (ray, k): geometry -> key posenc -> walk -> w_k -> scaled dot with qq
// -> score_act x influence, alive-masked; then the background-token softmax.
// Writes attn (T, K+1), the raw dots and the masked scores (T, K). With kq
// the walk's dense stack runs in int8 (walk.cuh run_walk_q), followed by the
// w_k product in Op (bf16 on y_k rounded, fp32 on y_k as it is).
template <class Op>
__device__ __forceinline__ void key_rec_fwd_tile(
    const WalkSmemT<Op>& S, const float* __restrict__ rec, int rec_w, int T,
    int K, const float* __restrict__ rayo, const float* __restrict__ rays,
    const float* qq, int dm, float sqrt_dm, const WalkDescT<Op>& kd,
    const Op* __restrict__ wk, const float* __restrict__ bk,
    int dm_pad, int score_relu, float bkg, float eps,
    float* __restrict__ attn, float* __restrict__ raw,
    float* __restrict__ ss_out, const WalkQuant* kq = nullptr) {
  float* C = S.C;
  float* geo = reinterpret_cast<float*>(S.extra);            // kRows x kGeo
  float* ss = geo + kRows * kGeo;                            // kRows x K
  int* gidx = reinterpret_cast<int*>(ss + kRows * K);        // kRows
  const int t0 = blockIdx.x * kRows;

  for (int k = 0; k < K; ++k) {
    geometry_rows(geo, gidx, rec, rec_w, T, k, t0, rayo, rays, eps);
    __syncthreads();
    encode_rec(C, kd, geo, gidx, rec, rec_w);
    __syncthreads();
    // y_k as the w_k product's operand: rounded to bf16 in A[0], or fp32 in
    // C (the fp32 walk's A[0]); the int8 walk's buffers share the base.
    if (kq) run_walk_q(walk_smem_q<Op>(S.extra - kWalkSmem), kd, *kq,
                       !kF32<Op>);
    else run_walk(S, kd, true);
    dense_layer(S.A[0], C, nullptr, S.W, wk, nullptr, kd.pd[kd.n], dm_pad, 0);
    __syncthreads();
    score_column<Op>(C, qq, bk, dm, sqrt_dm, t0, T,
                     [&](int r, int t, float col) {
      raw[(size_t)t * K + k] = col;
      const float* gr = geo + r * kGeo;
      ss[r * K + k] = masked_score(col, score_relu, gr[9], gr[10] > 0.5f);
    });
    __syncthreads();
  }
  softmax_rows(ss, K, bkg, t0, T, attn, ss_out);
}

// The softmax backward from the saved masked scores, then per k a recompute
// of the walk and the reverse chain: dqq += (into the block's own rows of
// dqq, which the caller zeroed), dW_k / db_k, the walk's gradients, the
// posenc and geometry backward to d_rec (K, T, rec_w) with the position
// FEATURE gradient dropped (the reference detaches it), the geometry gradient
// in lanes 0:3 and d_influence in lane 3, and d_rayo / d_rays. `st` (4 x
// kRows floats of shared memory, the LayerNorm statistics) is free again on
// return; ends on a barrier.
template <class Op>
__device__ __forceinline__ void key_rec_bwd_tile(
    const WalkSmemT<Op>& S, const float* __restrict__ rec, int rec_w, int T,
    int Tp, int K, const float* __restrict__ rayo,
    const float* __restrict__ rays, const float* qq, int dm, float sqrt_dm,
    const float* __restrict__ raw, const float* __restrict__ ss,
    const float* __restrict__ dattn, const WalkDescT<Op>& kd,
    const WalkBwdT<Op>& kb, const Op* __restrict__ wkf,
    const Op* __restrict__ wkb, const float* __restrict__ bk,
    int dm_pad, int dbk_off, int score_relu, float bkg, float eps,
    const int* __restrict__ seg, int nsrc, float* drec, float* drayo,
    float* drays, float* dqq, float* st) {
  float* C = S.C;
  float* geo = st + 4 * kRows;                               // kRows x kGeo
  float* ds = geo + kRows * kGeo;                            // kRows x K
  float* draw = ds + kRows * K;                              // kRows
  float* dinf = draw + kRows;                                // kRows
  float* dgeo = dinf + kRows;                                // kRows x 9
  int* gidx = reinterpret_cast<int*>(dgeo + kRows * kNGeoSrc);
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

  softmax_bwd_rows(ds, K, bkg, t0, T, dattn,
                   [&](int t, int k) { return ss[(size_t)t * K + k]; });
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    geometry_rows(geo, gidx, rec, rec_w, T, k, t0, rayo, rays, eps);
    __syncthreads();
    if (tid < kRows) {
      const int t = t0 + tid;
      const float rw = t < T ? raw[(size_t)t * K + k] : 0.f;
      const float d = ds[tid * K + k];
      dinf[tid] = d * (score_relu ? fmaxf(rw, 0.f) : rw);
      draw[tid] = draw_of(d, rw, geo[tid * kGeo + 9], score_relu, sqrt_dm);
    }
    encode_rec(C, kd, geo, gidx, rec, rec_w);
    __syncthreads();
    const TileCtx ctx = tile_ctx(kd, kb, (size_t)k * Tp + t0, st);
    walk_fwd_stash(S, kd, kb, ctx, true);        // y_c in A[0]
    key_head_bwd(S, kd, kb, ctx, wkf, wkb, bk, dm, dm_pad, dbk_off, qq, dqq,
                 draw, t0, T);
    walk_bwd(S, kd, kb, ctx);

    pe_bwd_deriv(C, kd, [&](int r, int src) {
      return src < kNGeoSrc ? geo[r * kGeo + src]
          : rec[(size_t)gidx[r] * rec_w + 5 + (src - kNGeoSrc)];
    });
    __syncthreads();
    pe_source_sums(C, seg, nsrc, [&](int r, int src, float v) {
      if (src < kNGeoSrc) dgeo[r * kNGeoSrc + src] = v;
      else if (t0 + r < T) drec[(size_t)gidx[r] * rec_w + 5 + (src - kNGeoSrc)] = v;
    });
    __syncthreads();
    if (tid < kRows && t0 + tid < T) {
      const int t = t0 + tid;
      float o[3], dr[3], dsel[3], dry[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = rayo[(size_t)t * 3 + j];
        dr[j] = rays[(size_t)t * 3 + j];
      }
      float* prow = drec + (size_t)gidx[tid] * rec_w;
      // Sources 0..2 (the position feature) are dropped: detached.
      geom_bwd_row(rec + (size_t)gidx[tid] * rec_w, o, dr,
                   dgeo + tid * kNGeoSrc + 3, dgeo + tid * kNGeoSrc + 6, eps,
                   dsel, dry);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        prow[j] = dsel[j];
        drayo[(size_t)t * 3 + j] -= dsel[j];
        drays[(size_t)t * 3 + j] += dry[j];
      }
      prow[3] = dinf[tid];
    }
    __syncthreads();
  }
}

}  // namespace papr

// The record-native key stream's C entry points (key_stream.cu): the int8
// and wgmma forwards' arguments, the backward's; the wgmma forwards (both
// forms) are what the folded key stream (key_stream_q.cu) runs after its
// query chain, and the fp32 backward what its fp32 form runs before its
// query's backward.
#define KEY_FWD_PARAMS                                                       \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* qq, int dm, float sqrt_dm,               \
    const int* kmeta, const void* kw, const void* kb, const void* kln,       \
    const void* kplan, const void* wk, const void* bk, int dm_pad,           \
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss
#define KEY_FWD_ARGS                                                         \
    rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb, kln,       \
    kplan, wk, bk, dm_pad, score_relu, bkg, eps, attn, raw, ss

#define KEY_BWD_PARAMS_NS                                                    \
    const float* rec, int rec_w, int T, int K, const float* rayo,            \
    const float* rays, const float* qq, int dm, float sqrt_dm,               \
    const float* raw, const float* ss, const float* dattn, const int* kmeta, \
    const void* kw, const void* kb, const void* kln, const void* kplan,      \
    const void* bk, int dm_pad, int score_relu, float bkg, float eps,        \
    void* stash, const long long* stash_off, const int* seg, int nsrc,       \
    float* drec, float* drayo, float* drays, float* dqq, float* part,        \
    int part_w, float* scratch
#define KEY_BWD_WG_PARAMS                                                    \
    KEY_BWD_PARAMS_NS, const void* wpack, long long wbytes, int grid,       \
    float* dqq_aux, float* drayo_aux, float* drays_aux, void* stream
#define KEY_BWD_WG_ARGS                                                      \
    rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, raw, ss, dattn, kmeta,    \
    kw, kb, kln, kplan, bk, dm_pad, score_relu, bkg, eps, stash, stash_off,  \
    seg, nsrc, drec, drayo, drays, dqq, part, part_w, scratch, wpack,        \
    wbytes, grid, dqq_aux, drayo_aux, drays_aux, stream

extern "C" int papr_key_stream_fwd(KEY_FWD_PARAMS, const void* wpack,
                                   long long wbytes, int grid, void* stream);
extern "C" int papr_key_stream_f32_fwd(KEY_FWD_PARAMS, const void* wpack,
                                       long long wbytes, int grid,
                                       void* stream);
extern "C" int papr_key_stream_f32_bwd(KEY_BWD_WG_PARAMS);
