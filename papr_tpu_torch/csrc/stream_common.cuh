// Steps shared by the training stream kernels: the record-native ones
// (key_stream.cu, key_stream_q.cu, value_stream.cu) and the ones that read
// raw feature tensors (key_stream_feat.cu, value_stream_feat.cu).
//
// Key side: the score column of one slot k (the w_k projection dotted with
// the ray's query), the background-token softmax over the K masked scores and
// its backward, and the backward of the score head (dqq, dkk, dW_k / db_k,
// the gradient of the walk output). Value side: the foreground mass, the
// fuse step of one slot, its backward, and the renormalization backward.
// Every function works on the block's kRows rays t0 .. t0 + kRows - 1 of T;
// per-ray rows of shared memory belong to the warp r % kWarps.

#pragma once

#include "walk_bwd.cuh"

namespace papr {

// Host side: what the key kernels take for the score head and K (negative
// codes as the launchers return them).
inline int check_score_head(int dm, int dm_pad, int K) {
  if (dm_pad <= 0 || dm_pad > kMaxWidth || dm_pad % 16 != 0 || dm > dm_pad)
    return -201;
  if (K <= 0 || K > 64) return -202;
  return 0;
}

// nn/mlp.py linear_apply in bf16: the product rounded to bf16, the bias added
// in bf16, promoted to fp32 (fused_attn.py _linear).
__device__ __forceinline__ float linear_bf16(float acc, float bias) {
  return bf16_round(bf16_round(acc) + bf16_round(bias));
}

// linear_apply in the walk's compute type: bf16 as above, or fp32 (the
// product plus the bias, one rounding).
template <class Op>
__device__ __forceinline__ float linear_c(float acc, float bias) {
  if constexpr (kF32<Op>) return acc + bias;
  else return linear_bf16(acc, bias);
}

// score_act x influence of one dot, NEG_BIG for a dead point.
__device__ __forceinline__ float masked_score(float col, int score_relu,
                                              float influ, bool alive) {
  const float sact = score_relu ? fmaxf(col, 0.f) : col;
  return alive ? sact * influ : kNegBig;
}

// The scaled dots of one slot: C holds y_c @ w_k (bias not yet added) for
// the block's rows; sink(r, t, q_t . kk_t / sqrt_dm) runs on lane 0 of the
// row's warp for every ray t < T. qq may have been written by this block
// earlier in the same kernel, so it is not read through the read-only path.
// Op: the walk's operand type (the projection's rounding).
template <class Op = __nv_bfloat16, class Sink>
__device__ __forceinline__ void score_column(const float* C, const float* qq,
                                             const float* __restrict__ bk,
                                             int dm, float sqrt_dm, int t0,
                                             int T, Sink sink) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    const float* qrow = qq + (size_t)t * dm;
    float s = 0.f;
    for (int c = lane; c < dm; c += 32)
      s += qrow[c] * linear_c<Op>(C[r * kCLd + c], bk[c]);
    s = warp_sum(s);
    if (lane == 0) sink(r, t, s / sqrt_dm);
  }
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// Background-token softmax (stream_attn.py _softmax_s) of the block's masked
// scores ss (kRows x K, shared) -> attn (T, K+1), background last; with
// ss_out the masked scores are saved too (T, K).
__device__ __forceinline__ void softmax_rows(const float* ss, int K,
                                             float bkg, int t0, int T,
                                             float* __restrict__ attn,
                                             float* __restrict__ ss_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    float m = bkg;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, ss[r * K + k]);
    m = warp_max(m);
    float z = 0.f;
    for (int k = lane; k < K; k += 32) z += expf(ss[r * K + k] - m);
    const float eb = expf(bkg - m);
    z = warp_sum(z) + eb;
    float* arow = attn + (size_t)t * (K + 1);
    for (int k = lane; k < K; k += 32) {
      arow[k] = expf(ss[r * K + k] - m) / z;
      if (ss_out) ss_out[(size_t)t * K + k] = ss[r * K + k];
    }
    if (lane == 0) arow[K] = eb / z;
  }
}

// Softmax backward: score(t, k) gives the masked score of ray t, slot k
// (saved, or recomputed from the raw dot); ds (kRows x K, shared) receives
// d loss / d masked score, 0 for dead points (score <= NEG_BIG / 2) and
// overhang rows. Each lane writes and re-reads its own columns only.
template <class Score>
__device__ __forceinline__ void softmax_bwd_rows(float* ds, int K, float bkg,
                                                 int t0, int T,
                                                 const float* __restrict__ dattn,
                                                 Score score) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) {
      for (int k = lane; k < K; k += 32) ds[r * K + k] = 0.f;
      continue;
    }
    const float* drow = dattn + (size_t)t * (K + 1);
    float m = bkg;
    for (int k = lane; k < K; k += 32) {
      const float s = score(t, k);
      ds[r * K + k] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float z = 0.f, in = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(ds[r * K + k] - m);
      z += e;
      in += e * drow[k];
    }
    const float eb = expf(bkg - m);
    z = warp_sum(z) + eb;
    const float inner = (warp_sum(in) + eb * drow[K]) / z;
    for (int k = lane; k < K; k += 32) {
      const float s = ds[r * K + k];
      const float fg = expf(s - m) / z;
      ds[r * K + k] = s > 0.5f * kNegBig ? fg * (drow[k] - inner) : 0.f;
    }
  }
}

// d raw of one dot from d masked score: through influence, the score relu
// (on where the saved raw dot is positive) and the 1 / sqrt_dm scale.
__device__ __forceinline__ float draw_of(float ds, float raw, float influ,
                                         int score_relu, float sqrt_dm) {
  const float mask = score_relu ? (raw > 0.f ? 1.f : 0.f) : 1.f;
  return ds * influ * mask / sqrt_dm;
}

// Backward of the score head of one slot. On entry A[0] holds y_c (the walk
// output as the product's operand) and draw[r] the gradient of each row's
// raw dot. Stashes y_c as the head layer's input; recomputes
// kk = linear(y_c); dqq += draw kk; dkk = draw qq goes fp32 into C (its
// column sums are db_k), rounded to Op into A[1] and the stash (dW_k by
// wgrad.cu); leaves the gradient of the walk output, dkk_c @ w_k^T, in C
// and ends on a barrier. The block owns its rays' rows of dqq, so the sum
// over k needs no atomics.
template <class Op>
__device__ __forceinline__ void key_head_bwd(
    const WalkSmemT<Op>& S, const WalkDescT<Op>& kd, const WalkBwdT<Op>& kb,
    const TileCtx& ctx, const Op* __restrict__ wkf,
    const Op* __restrict__ wkb, const float* __restrict__ bk,
    int dm, int dm_pad, int dbk_off, const float* qq, float* dqq,
    const float* draw, int t0, int T) {
  const int n = kd.n, pdn = kd.pd[n];
  float* C = S.C;
  stash_tile(S.A[0], kb.hs[n], ctx.row0, pdn);
  dense_layer(S.A[0], C, nullptr, S.W, wkf, nullptr, pdn, dm_pad, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * dm_pad; i += kThreads) {
    const int r = i / dm_pad, c = i - r * dm_pad, t = t0 + r;
    float dk = 0.f;
    if (t < T && c < dm) {
      const float kk = linear_c<Op>(C[r * kCLd + c], bk[c]);
      dqq[(size_t)t * dm + c] += draw[r] * kk;
      dk = draw[r] * qq[(size_t)t * dm + c];
    }
    C[r * kCLd + c] = dk;
    const Op h = to_act<Op>(dk);
    S.A[1][r * kALd + c] = h;
    kb.dz[n][(ctx.row0 + r) * dm_pad + c] = h;
  }
  __syncthreads();
  colsum_add(C, dm_pad, ctx.part + dbk_off);
  dense_layer(S.A[1], C, nullptr, S.W, wkb, nullptr, dm_pad, pdn, 0);
  __syncthreads();
}

// den[r] = the ray's foreground attention mass when `normalize` holds, 1
// where that mass is exactly 0 (an all-dead ray, an overhang row) and 1
// everywhere without `normalize`.
__device__ __forceinline__ void fg_mass_rows(const float* __restrict__ attn,
                                             int K, int t0, int T,
                                             int normalize, float* den) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    float sfg = 0.f;
    if (t < T)
      for (int k = lane; k < K; k += 32) sfg += attn[(size_t)t * (K + 1) + k];
    sfg = warp_sum(sfg);
    if (lane == 0) den[r] = normalize && sfg > 0.f ? sfg : 1.f;
  }
}

// acc += (attn_k / den) * y_k, with the walk output y_k (fp32 in C) rounded
// to Op and back as the materialized value embeddings are.
template <class Op = __nv_bfloat16>
__device__ __forceinline__ void fuse_step(const float* C, float* acc,
                                          const float* __restrict__ attn,
                                          const float* den, int k, int K,
                                          int cout, int t0, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    const float w = attn[(size_t)t * (K + 1) + k] / den[r];
    for (int c = lane; c < cout; c += 32)
      acc[r * cout + c] += w * act_round<Op>(C[r * kCLd + c]);
  }
}

// Backward of the fuse step of one slot: datt[r][k] = y_c . dfused (y fp32 in
// C on entry, rounded to Op), then C becomes the gradient of the walk output,
// (attn_k / den) dfused, zero on overhang rows and pad lanes; ends on a
// barrier.
template <class Op = __nv_bfloat16>
__device__ __forceinline__ void fuse_step_bwd(float* C, float* datt,
                                              const float* __restrict__ attn,
                                              const float* den,
                                              const float* __restrict__ dfused,
                                              int k, int K, int cout, int pdn,
                                              int t0, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    float s = 0.f;
    if (t < T)
      for (int c = lane; c < cout; c += 32)
        s += act_round<Op>(C[r * kCLd + c]) * dfused[(size_t)t * cout + c];
    s = warp_sum(s);
    if (lane == 0) datt[r * K + k] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * pdn; i += kThreads) {
    const int r = i / pdn, c = i - r * pdn, t = t0 + r;
    float g = 0.f;
    if (t < T && c < cout)
      g = attn[(size_t)t * (K + 1) + k] / den[r] * dfused[(size_t)t * cout + c];
    C[r * kCLd + c] = g;
  }
  __syncthreads();
}

// Renormalization backward over the full row, when every slot's datt is in
// the block: dattn_k = (datt_k - sum_j datt_j attn_j / den) / den, or datt
// itself without `normalize`; the background column gets 0.
__device__ __forceinline__ void renorm_bwd_rows(const float* datt,
                                                const float* __restrict__ attn,
                                                const float* den,
                                                int normalize, int K, int t0,
                                                int T,
                                                float* __restrict__ dattn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    const float* arow = attn + (size_t)t * (K + 1);
    float* drow = dattn + (size_t)t * (K + 1);
    float inner = 0.f;
    if (normalize) {
      for (int k = lane; k < K; k += 32) inner += datt[r * K + k] * arow[k];
      inner = warp_sum(inner) / den[r];
    }
    for (int k = lane; k < K; k += 32)
      drow[k] = normalize ? (datt[r * K + k] - inner) / den[r] : datt[r * K + k];
    if (lane == 0) drow[K] = 0.f;
  }
}

}  // namespace papr
