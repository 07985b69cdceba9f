// Fused attention scores: w_k / w_q projections, scaled dot, score
// activation x influence, alive mask and the background-token softmax,
// forward and backward, on key embeddings laid out k-major.
//
// Replaces papr_tpu/ops/fused_attn.py::fused_scores: forward pallas_call at
// :254 (body _fwd_kernel :116), backward pallas_call at :298 (body
// _bwd_kernel :125). Shapes at the flagship training patch: embedk
// (20, 25600, 256) and embedq (25600, 256) bf16, w_k / w_q (256, 256),
// influ / alive (25600, 20) -> attn (25600, 21) fp32; the backward returns
// d_embedk, d_embedq, d_influ and fp32 dW_k, db_k, dW_q, db_q.
//
// Numerics are the TPU kernel's (_linear :77): a projection accumulates in
// fp32, is ROUNDED to bf16, gets its bias added in bf16, and is promoted to
// fp32; dots, scores and softmax are fp32. In the backward dkk = d_raw * qq
// and dqq = sum_k d_raw * kk are rounded to bf16 for d_ek = dkk w_k,
// d_eq = dqq w_q and the weight gradients, and stay fp32 for the bias
// gradients.
//
// What bounds it on the H100: 2 * T * (K + 1) * 256 * 256 FLOP against
// 512 B read per (ray, k) token: ~256 FLOP/B, about at the card's ridge, so
// the forward is bound by reading embedk once; the backward also writes
// d_embedk and the dkk stash. What the design does about it: one 512-thread
// block per 64-ray tile loops over k inside (the TPU grid's ray tile with
// its unrolled k loop); qq stays in shared memory as bf16 (exact: it was
// just rounded there) for all K dots; each projection runs through the
// walks' WMMA dense layer (walk.cuh) with the weights staged once per layer
// per tile. The backward recomputes the forward, keeps dqq (64 x 256 fp32)
// in registers (32 per thread) across the k loop, and writes dkk / dqq as a
// bf16 stash for the split-K dW reduction in wgrad.cu (dW_k sums over
// K * T tokens, and a 256 x 256 fp32 partial does not fit in an SM); embedk
// and embedq themselves are the other operand, so nothing else is stashed.
// The bias gradients go to one partial-sum row per block, summed in a fixed
// order by colsum (no float atomics anywhere).

#include "walk.cuh"

using namespace papr;

namespace {

constexpr int kMaxK = 64;
constexpr int kSLd = kMaxK + 1;          // one thread per row walks its row
constexpr float kNegBig = -1e30f;
constexpr int kRowsPerWarp = kRows / kWarps;      // 4
constexpr int kColsPerLane = kMaxWidth / 32;      // 8
constexpr size_t kScoreSmem = kWalkSmem + sizeof(float) * kRows * kSLd;

struct ScoreArgs {
  const __nv_bfloat16* ek;    // (K, T, Dk) k-major
  const __nv_bfloat16* eq;    // (T, Dq)
  const float* influ;         // (T, K)
  const float* alive;         // (T, K) {0, 1}
  const __nv_bfloat16* wkT;   // (pdk, pdm) input-major, zero padded
  const __nv_bfloat16* wqT;   // (pdq, pdm)
  const float* bk;            // (pdm) zero padded
  const float* bq;            // (pdm)
  int T, K, Dk, Dq, dm, pdk, pdq, pdm;
  float rsqrt_dm, bkg;
  int relu;
};

// Rows [t0, t0 + kRows) of a row-major (T, D) bf16 matrix into A, pd lanes
// per row, zero past T and past D.
__device__ __forceinline__ void load_rows(__nv_bfloat16* A,
                                          const __nv_bfloat16* __restrict__ src,
                                          int T, int D, int pd, int t0) {
  const int vpr = pd >> 3;
  const bool vec = (D & 7) == 0;
  for (int v = threadIdx.x; v < kRows * vpr; v += kThreads) {
    const int r = v / vpr, c8 = (v - r * vpr) << 3;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T && c8 < D) {
      const __nv_bfloat16* p = src + (size_t)t * D + c8;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = c8 + e < D ? p[e] : __float2bfloat16_rn(0.f);
        val = *reinterpret_cast<const uint4*>(h);
      }
    }
    *reinterpret_cast<uint4*>(A + r * kALd + c8) = val;
  }
}

// _linear's epilogue on an fp32 accumulator: round, add the bias in bf16.
__device__ __forceinline__ float linear_out(float acc, float bias) {
  return bf16_round(bf16_round(acc) + bf16_round(bias));
}

// The shared forward head: qq into A[1] (bf16), the raw scaled dots of every
// k into sS[r * kSLd + k]. Ends on a barrier.
__device__ __forceinline__ void score_dots(const WalkSmem& s,
                                           const ScoreArgs& a, int t0,
                                           float* sS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows(s.A[0], a.eq, a.T, a.Dq, a.pdq, t0);
  dense_layer(s.A[0], s.C, nullptr, s.W, a.wqT, nullptr, a.pdq, a.pdm, 0);
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    for (int c = lane; c < a.pdm; c += 32)
      s.A[1][r * kALd + c] =
          __float2bfloat16_rn(linear_out(s.C[r * kCLd + c], a.bq[c]));
  }
  __syncthreads();
  for (int k = 0; k < a.K; ++k) {
    load_rows(s.A[0], a.ek + (size_t)k * a.T * a.Dk, a.T, a.Dk, a.pdk, t0);
    dense_layer(s.A[0], s.C, nullptr, s.W, a.wkT, nullptr, a.pdk, a.pdm, 0);
    __syncthreads();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      float acc = 0.f;
      for (int c = lane; c < a.pdm; c += 32)
        acc += __bfloat162float(s.A[1][r * kALd + c]) *
               linear_out(s.C[r * kCLd + c], a.bk[c]);
      acc = warp_sum(acc);
      if (lane == 0) sS[r * kSLd + k] = acc * a.rsqrt_dm;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float score_of(float raw, float influ, float alive,
                                          int relu) {
  const float sact = relu ? fmaxf(raw, 0.f) : raw;
  return alive > 0.5f ? sact * influ : kNegBig;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_scores_fwd_kernel(ScoreArgs a, float* __restrict__ attn,
                        float* __restrict__ raw_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem s = walk_smem(smem);
  float* sS = reinterpret_cast<float*>(s.extra);
  const int t0 = blockIdx.x * kRows;
  score_dots(s, a, t0, sS);

  const int r = threadIdx.x, t = t0 + r;
  if (r >= kRows || t >= a.T) return;
  const float* row = sS + r * kSLd;
  const float* inf = a.influ + (size_t)t * a.K;
  const float* alv = a.alive + (size_t)t * a.K;
  float m = a.bkg;
  for (int k = 0; k < a.K; ++k)
    m = fmaxf(m, score_of(row[k], inf[k], alv[k], a.relu));
  const float eb = expf(a.bkg - m);
  float z = eb;
  for (int k = 0; k < a.K; ++k)
    z += expf(score_of(row[k], inf[k], alv[k], a.relu) - m);
  float* o = attn + (size_t)t * (a.K + 1);
  for (int k = 0; k < a.K; ++k) {
    o[k] = expf(score_of(row[k], inf[k], alv[k], a.relu) - m) / z;
    if (raw_out) raw_out[(size_t)t * a.K + k] = row[k];
  }
  o[a.K] = eb / z;
}

struct ScoreBwdArgs {
  const float* dattn;          // (T, K + 1)
  const __nv_bfloat16* wkB;    // (pdm, pdk): w_k itself, input-major for dkk w_k
  const __nv_bfloat16* wqB;    // (pdm, pdq)
  __nv_bfloat16* dek;          // (K, T, Dk)
  __nv_bfloat16* deq;          // (T, Dq)
  float* dinflu;               // (T, K)
  __nv_bfloat16* dkk_stash;    // (K * T, pdm)
  __nv_bfloat16* dqq_stash;    // (T, pdm)
  float* part;                 // (blocks, 2 * pdm): db_k, db_q partial rows
};

// Sum the per-warp rows C[w][0:pdm] over the kWarps warps into out[0:pdm].
__device__ __forceinline__ void reduce_warp_rows(const float* C, int pdm,
                                                 float* out) {
  for (int c = threadIdx.x; c < pdm; c += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += C[w * kCLd + c];
    out[c] = sum;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_scores_bwd_kernel(ScoreArgs a, ScoreBwdArgs b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem s = walk_smem(smem);
  float* sS = reinterpret_cast<float*>(s.extra);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kRows;
  score_dots(s, a, t0, sS);

  // Softmax backward with the constant background token, one thread per
  // ray: raw -> d_raw in place; d_influ = ds * sact.
  if (threadIdx.x < kRows) {
    const int r = threadIdx.x, t = t0 + r;
    float* row = sS + r * kSLd;
    if (t >= a.T) {
      for (int k = 0; k < a.K; ++k) row[k] = 0.f;
    } else {
      const float* inf = a.influ + (size_t)t * a.K;
      const float* alv = a.alive + (size_t)t * a.K;
      const float* dat = b.dattn + (size_t)t * (a.K + 1);
      float m = a.bkg;
      for (int k = 0; k < a.K; ++k)
        m = fmaxf(m, score_of(row[k], inf[k], alv[k], a.relu));
      const float eb = expf(a.bkg - m);
      float z = eb;
      for (int k = 0; k < a.K; ++k)
        z += expf(score_of(row[k], inf[k], alv[k], a.relu) - m);
      float inner = (eb / z) * dat[a.K];
      for (int k = 0; k < a.K; ++k)
        inner += (expf(score_of(row[k], inf[k], alv[k], a.relu) - m) / z) *
                 dat[k];
      for (int k = 0; k < a.K; ++k) {
        const float raw = row[k];
        const float sact = a.relu ? fmaxf(raw, 0.f) : raw;
        const bool on = alv[k] > 0.5f;
        const float p = expf((on ? sact * inf[k] : kNegBig) - m) / z;
        const float ds = on ? p * (dat[k] - inner) : 0.f;
        b.dinflu[(size_t)t * a.K + k] = ds * sact;
        float d_sact = ds * inf[k];
        if (a.relu && !(sact > 0.f)) d_sact = 0.f;
        row[k] = d_sact * a.rsqrt_dm;
      }
    }
  }
  __syncthreads();

  float dqq[kRowsPerWarp][kColsPerLane];
  float dbk[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    dbk[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) dqq[i][j] = 0.f;
  }

  for (int k = 0; k < a.K; ++k) {
    load_rows(s.A[0], a.ek + (size_t)k * a.T * a.Dk, a.T, a.Dk, a.pdk, t0);
    dense_layer(s.A[0], s.C, nullptr, s.W, a.wkT, nullptr, a.pdk, a.pdm, 0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps, t = t0 + r;
      const float dr = sS[r * kSLd + k];
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < a.pdm) {
          const float kk = linear_out(s.C[r * kCLd + c], a.bk[c]);
          const float dkk = dr * __bfloat162float(s.A[1][r * kALd + c]);
          dqq[i][j] += dr * kk;
          dbk[j] += dkk;
          const __nv_bfloat16 h = __float2bfloat16_rn(dkk);
          s.A[0][r * kALd + c] = h;
          if (t < a.T)
            b.dkk_stash[((size_t)k * a.T + t) * a.pdm + c] = h;
        }
      }
    }
    __syncthreads();
    dense_layer(s.A[0], s.C, nullptr, s.W, b.wkB, nullptr, a.pdm, a.pdk, 0);
    __syncthreads();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps, t = t0 + r;
      if (t >= a.T) continue;
      __nv_bfloat16* o = b.dek + ((size_t)k * a.T + t) * a.Dk;
      for (int c = lane; c < a.Dk; c += 32)
        o[c] = __float2bfloat16_rn(s.C[r * kCLd + c]);
    }
    __syncthreads();
  }

  float* part = b.part + (size_t)blockIdx.x * 2 * a.pdm;
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < a.pdm) s.C[warp * kCLd + c] = dbk[j];
  }
  __syncthreads();
  reduce_warp_rows(s.C, a.pdm, part);
  __syncthreads();

  // dqq: rounded once for d_eq and dW_q, unrounded for db_q.
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    float dbq = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps, t = t0 + r;
      if (c < a.pdm) {
        const __nv_bfloat16 h = __float2bfloat16_rn(dqq[i][j]);
        s.A[0][r * kALd + c] = h;
        if (t < a.T) b.dqq_stash[(size_t)t * a.pdm + c] = h;
        dbq += dqq[i][j];
      }
    }
    if (c < a.pdm) s.C[warp * kCLd + c] = dbq;
  }
  __syncthreads();
  reduce_warp_rows(s.C, a.pdm, part + a.pdm);
  __syncthreads();
  dense_layer(s.A[0], s.C, nullptr, s.W, b.wqB, nullptr, a.pdm, a.pdq, 0);
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps, t = t0 + r;
    if (t >= a.T) continue;
    __nv_bfloat16* o = b.deq + (size_t)t * a.Dq;
    for (int c = lane; c < a.Dq; c += 32)
      o[c] = __float2bfloat16_rn(s.C[r * kCLd + c]);
  }
}

int fill_args(ScoreArgs* a, const void* ek, const void* eq, const float* influ,
              const float* alive, const void* wkT, const void* wqT,
              const float* bk, const float* bq, int T, int K, int Dk, int Dq,
              int dm, int pdk, int pdq, int pdm, float sqrt_dm, float bkg,
              int relu) {
  if (K < 1 || K > kMaxK) return -601;
  const int pds[3] = {pdk, pdq, pdm};
  for (int i = 0; i < 3; ++i)
    if (pds[i] <= 0 || pds[i] > kMaxWidth || pds[i] % 16 != 0) return -602;
  if (Dk > pdk || Dq > pdq || dm > pdm || Dk < 1 || Dq < 1 || dm < 1)
    return -603;
  a->ek = static_cast<const __nv_bfloat16*>(ek);
  a->eq = static_cast<const __nv_bfloat16*>(eq);
  a->influ = influ;
  a->alive = alive;
  a->wkT = static_cast<const __nv_bfloat16*>(wkT);
  a->wqT = static_cast<const __nv_bfloat16*>(wqT);
  a->bk = bk;
  a->bq = bq;
  a->T = T; a->K = K; a->Dk = Dk; a->Dq = Dq; a->dm = dm;
  a->pdk = pdk; a->pdq = pdq; a->pdm = pdm;
  a->rsqrt_dm = 1.0f / sqrt_dm;
  a->bkg = bkg;
  a->relu = relu;
  return 0;
}

}  // namespace

// attn (T, K + 1) fp32; raw_out (T, K) fp32 or null.
extern "C" int papr_fused_scores_fwd(
    const void* ek, const void* eq, const float* influ, const float* alive,
    const void* wkT, const void* wqT, const float* bk, const float* bq, int T,
    int K, int Dk, int Dq, int dm, int pdk, int pdq, int pdm, float sqrt_dm,
    float bkg, int relu, float* attn, float* raw_out, void* stream) {
  ScoreArgs a;
  int err = fill_args(&a, ek, eq, influ, alive, wkT, wqT, bk, bq, T, K, Dk, Dq,
                      dm, pdk, pdq, pdm, sqrt_dm, bkg, relu);
  if (err) return err;
  if (T <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_scores_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kScoreSmem);
  if (e != cudaSuccess) return (int)e;
  fused_scores_fwd_kernel<<<(T + kRows - 1) / kRows, kThreads, kScoreSmem,
                            static_cast<cudaStream_t>(stream)>>>(a, attn,
                                                                 raw_out);
  return (int)cudaGetLastError();
}

// part is (ceil(T / 64), 2 * pdm) fp32; the stashes are bf16 (K * T, pdm)
// and (T, pdm); dek / deq are bf16 in the inputs' layouts.
extern "C" int papr_fused_scores_bwd(
    const void* ek, const void* eq, const float* influ, const float* alive,
    const void* wkT, const void* wqT, const float* bk, const float* bq, int T,
    int K, int Dk, int Dq, int dm, int pdk, int pdq, int pdm, float sqrt_dm,
    float bkg, int relu, const float* dattn, const void* wkB, const void* wqB,
    void* dek, void* deq, float* dinflu, void* dkk_stash, void* dqq_stash,
    float* part, void* stream) {
  ScoreArgs a;
  int err = fill_args(&a, ek, eq, influ, alive, wkT, wqT, bk, bq, T, K, Dk, Dq,
                      dm, pdk, pdq, pdm, sqrt_dm, bkg, relu);
  if (err) return err;
  if (T <= 0) return 0;
  ScoreBwdArgs b;
  b.dattn = dattn;
  b.wkB = static_cast<const __nv_bfloat16*>(wkB);
  b.wqB = static_cast<const __nv_bfloat16*>(wqB);
  b.dek = static_cast<__nv_bfloat16*>(dek);
  b.deq = static_cast<__nv_bfloat16*>(deq);
  b.dinflu = dinflu;
  b.dkk_stash = static_cast<__nv_bfloat16*>(dkk_stash);
  b.dqq_stash = static_cast<__nv_bfloat16*>(dqq_stash);
  b.part = part;
  cudaError_t e = cudaFuncSetAttribute(
      fused_scores_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kScoreSmem);
  if (e != cudaSuccess) return (int)e;
  fused_scores_bwd_kernel<<<(T + kRows - 1) / kRows, kThreads, kScoreSmem,
                            static_cast<cudaStream_t>(stream)>>>(a, b);
  return (int)cudaGetLastError();
}
