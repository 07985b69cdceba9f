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
//
// fused_scores_f32_bwd is the same backward kernel in fp32 (use_amp: false;
// _bwd_kernel with an fp32 compute type): embeddings, weights and products
// in fp32 (walk.cuh's 3xTF32 products), the bias added to the unrounded
// product, the dkk / dqq stashes and d_embedk / d_embedq fp32 (dW through
// wgrad_f32). qq is not rounded, so it cannot sit in a bf16 tile: the fp32
// walk's shared memory holds its operand in C itself, so qq goes to a (T,
// pdm) fp32 device buffer that the block reads back (its own rows,
// L2-resident) for every k; the shared memory is the bf16 kernels'.
//
// fused_scores_f32_fwd (_fwd_kernel with an fp32 compute type) runs on
// wgmma, on walk_wgmma.cuh's fp32 operand form with no walk: three launches.
// fused_scores_query_wgmma_f32_kernel stages each 128-ray tile's eq rows
// (fp32, 16-byte cp.async copies; zero past T and past Dq up to the 32-deep
// chunk) into shared memory and runs the w_q head as 3xTF32 m64n64k8
// products on the TMA-fed weight ring, b_q added to the unrounded product,
// qq's rows written to the (T, pdm) buffer. fused_scores_fwd_wgmma_f32_kernel
// runs the persistent grid over (tile, k) units in tile-major order: it
// stages ek[k]'s rows of the tile the same way and runs wg_score, the w_k
// head of the stream forwards (b_k added in fp32, the dot with qq's row read
// back from L2, / sqrt(dm)), writing the raw dot and the masked score to (T,
// K) rows; key_fwd_softmax_kernel takes the background-token softmax after
// it. The image holds w_q then w_k (ops/fused_attn.py fwd_wgmma_image, the
// 16 KB hi / lo stages of ops/fused_mlp.py pack_walk_wgmma_f32); each head
// streams its stages once per unit from L2 (512 KB at 256 x 256: they do
// not fit in shared memory beside the two warpgroups' 64-row tiles). No
// rounding point moved against the WMMA kernel: the 256-deep sums join the
// fp32 accumulator once per 32-deep chunk instead of once per 8-deep step,
// the scale divides by sqrt(dm) where the WMMA kernel multiplied by its
// reciprocal, and the softmax sums its terms across a warp's lanes. Bound
// by operations (three tensor-core products per fp32-accurate one); embedk
// is read once (663 MB at 32,400 rays, K = 20, 256 wide).

#include "walk_wgmma.cuh"

using namespace papr;

namespace {

constexpr int kMaxK = 64;
constexpr int kSLd = kMaxK + 1;          // one thread per row walks its row
constexpr float kNegBig = -1e30f;
constexpr int kRowsPerWarp = kRows / kWarps;      // 4
constexpr int kColsPerLane = kMaxWidth / 32;      // 8
constexpr size_t kScoreSmem = kWalkSmem + sizeof(float) * kRows * kSLd;

// Op: the operand type of embeddings and weights (bf16, or fp32).
template <class Op>
struct ScoreArgs {
  const Op* ek;               // (K, T, Dk) k-major
  const Op* eq;               // (T, Dq)
  const float* influ;         // (T, K)
  const float* alive;         // (T, K) {0, 1}
  const Op* wkT;              // (pdk, pdm) input-major, zero padded
  const Op* wqT;              // (pdq, pdm)
  const float* bk;            // (pdm) zero padded
  const float* bq;            // (pdm)
  float* qq;                  // fp32: (T, pdm) rows of qq (bf16: null)
  int T, K, Dk, Dq, dm, pdk, pdq, pdm;
  float rsqrt_dm, bkg;
  int relu;
};

// Rows [t0, t0 + kRows) of a row-major (T, D) matrix of Op into A, pd
// lanes per row, zero past T and past D; 16 B (8 bf16, 4 fp32) a vector.
template <class Op>
__device__ __forceinline__ void load_rows(Op* A, const Op* __restrict__ src,
                                          int T, int D, int pd, int t0) {
  constexpr int kV = 16 / sizeof(Op);
  const int vpr = pd / kV;
  const bool vec = D % kV == 0;
  for (int v = threadIdx.x; v < kRows * vpr; v += kThreads) {
    const int r = v / vpr, c0 = (v - r * vpr) * kV;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T && c0 < D) {
      const Op* p = src + (size_t)t * D + c0;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) Op h[kV];
#pragma unroll
        for (int e = 0; e < kV; ++e) h[e] = c0 + e < D ? p[e] : to_act<Op>(0.f);
        val = *reinterpret_cast<const uint4*>(h);
      }
    }
    *reinterpret_cast<uint4*>(A + r * kALd + c0) = val;
  }
}

// qq of the block's row r, column c: bf16 in A[1] (exact: it was rounded
// there), or fp32 from the device rows the block wrote (0 past T).
template <class Op>
__device__ __forceinline__ float qq_at(const WalkSmemT<Op>& s,
                                       const ScoreArgs<Op>& a, int t0, int r,
                                       int c) {
  if constexpr (kF32<Op>) {
    const int t = t0 + r;
    return t < a.T ? a.qq[(size_t)t * a.pdm + c] : 0.f;
  } else {
    return __bfloat162float(s.A[1][r * kALd + c]);
  }
}

// The shared forward head: qq (linear_apply in Op: _linear :77) into A[1]
// or the device rows, the raw scaled dots of every k into sS[r * kSLd + k].
// Ends on a barrier.
template <class Op>
__device__ __forceinline__ void score_dots(const WalkSmemT<Op>& s,
                                           const ScoreArgs<Op>& a, int t0,
                                           float* sS) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_rows(s.A[0], a.eq, a.T, a.Dq, a.pdq, t0);
  dense_layer(s.A[0], s.C, nullptr, s.W, a.wqT, nullptr, a.pdq, a.pdm, 0);
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps, t = t0 + r;
    for (int c = lane; c < a.pdm; c += 32) {
      const float q = linear_c<Op>(s.C[r * kCLd + c], a.bq[c]);
      if constexpr (kF32<Op>) {
        if (t < a.T) a.qq[(size_t)t * a.pdm + c] = q;
      } else {
        s.A[1][r * kALd + c] = __float2bfloat16_rn(q);
      }
    }
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
        acc += qq_at(s, a, t0, r, c) * linear_c<Op>(s.C[r * kCLd + c], a.bk[c]);
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

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
fused_scores_fwd_kernel(ScoreArgs<Op> a, float* __restrict__ attn,
                        float* __restrict__ raw_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> s = walk_smem<Op>(smem);
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

template <class Op>
struct ScoreBwdArgs {
  const float* dattn;          // (T, K + 1)
  const Op* wkB;               // (pdm, pdk): w_k itself, input-major for dkk w_k
  const Op* wqB;               // (pdm, pdq)
  Op* dek;                     // (K, T, Dk)
  Op* deq;                     // (T, Dq)
  float* dinflu;               // (T, K)
  Op* dkk_stash;               // (K * T, pdm)
  Op* dqq_stash;               // (T, pdm)
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

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
fused_scores_bwd_kernel(ScoreArgs<Op> a, ScoreBwdArgs<Op> b) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> s = walk_smem<Op>(smem);
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
          const float kk = linear_c<Op>(s.C[r * kCLd + c], a.bk[c]);
          const float dkk = dr * qq_at(s, a, t0, r, c);
          dqq[i][j] += dr * kk;
          dbk[j] += dkk;
          // The dX product's operand (fp32: C's own element, just read by
          // this thread) and the dW_k stash, in Op.
          const Op h = to_act<Op>(dkk);
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
      Op* o = b.dek + ((size_t)k * a.T + t) * a.Dk;
      for (int c = lane; c < a.Dk; c += 32) o[c] = to_act<Op>(s.C[r * kCLd + c]);
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

  // dqq: in Op for d_eq and dW_q (into A[0], which is C under fp32), fp32
  // for db_q, whose per-warp rows go to the free weight buffer.
  float* red = reinterpret_cast<float*>(s.W);
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    const int c = lane + 32 * j;
    float dbq = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps, t = t0 + r;
      if (c < a.pdm) {
        const Op h = to_act<Op>(dqq[i][j]);
        s.A[0][r * kALd + c] = h;
        if (t < a.T) b.dqq_stash[(size_t)t * a.pdm + c] = h;
        dbq += dqq[i][j];
      }
    }
    if (c < a.pdm) red[warp * kCLd + c] = dbq;
  }
  __syncthreads();
  reduce_warp_rows(red, a.pdm, part + a.pdm);
  __syncthreads();
  dense_layer(s.A[0], s.C, nullptr, s.W, b.wqB, nullptr, a.pdm, a.pdq, 0);
  __syncthreads();
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps, t = t0 + r;
    if (t >= a.T) continue;
    Op* o = b.deq + (size_t)t * a.Dq;
    for (int c = lane; c < a.Dq; c += 32) o[c] = to_act<Op>(s.C[r * kCLd + c]);
  }
}

template <class Op>
int fill_args(ScoreArgs<Op>* a, const void* ek, const void* eq,
              const float* influ, const float* alive, const void* wkT,
              const void* wqT, const float* bk, const float* bq, int T, int K,
              int Dk, int Dq, int dm, int pdk, int pdq, int pdm, float sqrt_dm,
              float bkg, int relu, void* qq) {
  if (K < 1 || K > kMaxK) return -601;
  const int pds[3] = {pdk, pdq, pdm};
  for (int i = 0; i < 3; ++i)
    if (pds[i] <= 0 || pds[i] > kMaxWidth || pds[i] % 16 != 0) return -602;
  if (Dk > pdk || Dq > pdq || dm > pdm || Dk < 1 || Dq < 1 || dm < 1)
    return -603;
  if (kF32<Op> && !qq) return -604;
  a->ek = static_cast<const Op*>(ek);
  a->eq = static_cast<const Op*>(eq);
  a->influ = influ;
  a->alive = alive;
  a->wkT = static_cast<const Op*>(wkT);
  a->wqT = static_cast<const Op*>(wqT);
  a->bk = bk;
  a->bq = bq;
  a->qq = static_cast<float*>(qq);
  a->T = T; a->K = K; a->Dk = Dk; a->Dq = Dq; a->dm = dm;
  a->pdk = pdk; a->pdq = pdq; a->pdm = pdm;
  a->rsqrt_dm = 1.0f / sqrt_dm;
  a->bkg = bkg;
  a->relu = relu;
  return 0;
}

// ------------------------------------- the fp32 forward on wgmma ----
//
// fused_scores_query_wgmma_f32_kernel (kQuery) and
// fused_scores_fwd_wgmma_f32_kernel: one head of walk_wgmma.cuh's fp32
// operand form on rows read from memory, no walk. Per unit a warpgroup
// stages its 64 rows of the fp32 input (eq, or ek[k]) into its rows of E by
// 16-byte asynchronous copies (cp.async; scalar loads where the row width
// is not a multiple of 4), zero past the last row and past the width up to
// the products' 32-deep chunks, then runs the head as 3xTF32 m64n64k8
// products on the TMA-fed weight ring (wg_gemm_f32). The query head adds b_q
// to the unrounded product and writes qq's rows (T, pdm) through E
// (wg_store_rows); the key head is wg_score against w_k with b_k added in
// fp32, its dot with qq's row (read back from L2), the raw dot and the
// masked score (influence, alive from the (T, K) arrays) to raw / ss, and
// key_fwd_softmax_kernel takes the softmax after it. The grid is
// persistent: the query kernel's units are 128-row tiles, the key's (tile,
// k) pairs in tile-major order, each block an even contiguous share, so a
// block walks k under one tile and qq's rows stay in L2.

struct ScoreFwdWg {
  const float* x;                  // query: eq (T, D); key: ek (K, T, D)
  int D, T, K;
  WgLayer L;                       // w_q or w_k in the image
  WgChunk chunks[(kMaxWidth / kF32ChunkK) * (kMaxWidth / kF32PassN)];
  int n_chunks, stages;
  const unsigned char* w;          // the packed weights (both heads)
  int n_units, grid;
  const float* bias;               // b_q or b_k (pdm, zero padded)
  float* qq;                       // (T, pdm): the query's output, the key's
  int pdm;                         // input
  // the key
  const float* influ;              // (T, K)
  const float* alive;              // (T, K)
  float sqrt_dm;
  int score_relu;
  float* raw;                      // (T, K) or null
  float* ss;                       // (T, K)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// The warp's 16 rows rbase + row0 + r of x (R rows of D fp32) into its rows
// of E (kF32Ld floats a row), columns [0, cols): 0 past R and past D.
__device__ __forceinline__ void stage_rows_f32(float* E, int row0,
                                               const float* __restrict__ x,
                                               int R, int D, int cols,
                                               int rbase) {
  const int lane = threadIdx.x & 31, v4 = cols / 4;
  __syncwarp();                    // the warp's last reads of E are done
  if ((D & 3) == 0) {
    for (int u = lane; u < 16 * v4; u += 32) {
      const int r = u / v4, c = 4 * (u - r * v4), t = rbase + row0 + r;
      float* dst = E + (row0 + r) * kF32Ld + c;
      if (t < R && c < D) cp_async16(dst, x + (size_t)t * D + c);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int u = lane; u < 16 * cols; u += 32) {
      const int r = u / cols, c = u - r * cols, t = rbase + row0 + r;
      E[(row0 + r) * kF32Ld + c] =
          t < R && c < D ? x[(size_t)t * D + c] : 0.f;
    }
  }
  __syncwarp();
}

template <bool kQuery>
__device__ __forceinline__ void score_fwd_wg(const ScoreFwdWg& p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kE = kWgRows * kF32Ld;
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * kE, 0, false);
  {
    const float* const src[1] = {nullptr};
    const int cnt[1] = {0};
    wg_prologue(sm, p.stages, src, cnt);
  }
  const int u_begin = (int)((long long)p.n_units * blockIdx.x / p.grid);
  const int u_end = (int)((long long)p.n_units * (blockIdx.x + 1) / p.grid);
  WgRing rg{sm.ring, sm.full, sm.released, p.stages, 0, p.n_chunks,
            p.n_chunks * (u_end - u_begin), p.chunks, p.w};
  wg_ring_start(rg);

  const int tid = threadIdx.x, wg = tid >> 7, t_in = tid & 127;
  const int w = t_in >> 5, lane = t_in & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * w, T = p.T, K = p.K;
  const int rl[2] = {row0 + g, row0 + g + 8};
  const int cols = (p.L.pd_in + kF32ChunkK - 1) / kF32ChunkK * kF32ChunkK;
  float* E = sm.tiles + wg * kE;
  WgRowsA A{E, row0};
  float acc[kOutRegs];

  for (int u = u_begin; u < u_end; ++u) {
    if constexpr (kQuery) {
      const int rbase = u * kWgTile + wg * kWgRows;
      stage_rows_f32(E, row0, p.x, T, p.D, cols, rbase);
      wg_gemm_f32(acc, E, row0, rg, p.L);
      acc_bias_act(acc, p.bias, p.pdm, 0);
      wg_store_rows(acc, A, E, false, p.qq, rbase, T, p.pdm);
    } else {
      const int tile = u / K, k = u - tile * K;
      const int rbase = tile * kWgTile + wg * kWgRows;
      stage_rows_f32(E, row0, p.x + (size_t)k * T * p.D, T, p.D, cols,
                     rbase);
      float col[2];
      wg_score(acc, A, rg, nullptr, p.L, p.qq, p.pdm, p.bias, p.sqrt_dm, T,
               rbase, rl, col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = rbase + rl[h];
        if (q == 0 && t < T) {
          const size_t i = (size_t)t * K + k;
          if (p.raw) p.raw[i] = col[h];
          p.ss[i] = masked_score(col[h], p.score_relu, p.influ[i],
                                 p.alive[i] > 0.5f);
        }
      }
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(kWgThreads, 1)
fused_scores_query_wgmma_f32_kernel(const __grid_constant__ ScoreFwdWg p) {
  score_fwd_wg<true>(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_scores_fwd_wgmma_f32_kernel(const __grid_constant__ ScoreFwdWg p) {
  score_fwd_wg<false>(p);
}

#define SCORE_HEAD_PARAMS                                                    \
    const void* ek, const void* eq, const float* influ, const float* alive,  \
    const void* wkT, const void* wqT, const float* bk, const float* bq,      \
    int T, int K, int Dk, int Dq, int dm, int pdk, int pdq, int pdm,         \
    float sqrt_dm, float bkg, int relu
#define SCORE_HEAD_ARGS                                                      \
    ek, eq, influ, alive, wkT, wqT, bk, bq, T, K, Dk, Dq, dm, pdk, pdq, pdm, \
    sqrt_dm, bkg, relu
#define SCORE_BWD_PARAMS                                                     \
    const float* dattn, const void* wkB, const void* wqB, void* dek,         \
    void* deq, float* dinflu, void* dkk_stash, void* dqq_stash, float* part
#define SCORE_BWD_ARGS                                                       \
    dattn, wkB, wqB, dek, deq, dinflu, dkk_stash, dqq_stash, part

// attn (T, K + 1) fp32; raw_out (T, K) fp32 or null (the bf16 kernel).
static int launch_fwd(SCORE_HEAD_PARAMS, float* attn, float* raw_out,
                      void* stream) {
  using Op = __nv_bfloat16;
  ScoreArgs<Op> a;
  int err = fill_args(&a, SCORE_HEAD_ARGS, nullptr);
  if (err) return err;
  if (T <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_scores_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kScoreSmem);
  if (e != cudaSuccess) return (int)e;
  fused_scores_fwd_kernel<Op><<<(T + kRows - 1) / kRows, kThreads, kScoreSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      a, attn, raw_out);
  return (int)cudaGetLastError();
}

// The fp32 forward on wgmma: one head of the image (its layer li of the
// table over (pdq -> pdm), (pdk -> pdm)) on rows x of width D, its units
// over grid blocks.
static int launch_score_wg(ScoreFwdWg p, void (*kernel)(ScoreFwdWg),
                           const WgLayer* layers, int li, const float* x,
                           int D, int n_units, int grid, cudaStream_t st) {
  p.x = x;
  p.D = D;
  p.L = layers[li];
  const long long bytes = (long long)((p.L.pd_in + kF32ChunkK - 1) /
                                      kF32ChunkK) *
                          (p.L.ni / kF32PassN) * kWStageBytes;
  p.n_chunks = wg_chunks_f32(p.chunks, bytes, p.L.off);
  p.n_units = n_units;
  p.grid = grid;
  size_t smem = 0;
  const int err = wg_ring_fit(
      wg_smem_rest(2 * kWgRows * kF32Ld, 0, false), &p.stages, &smem);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// qq: the (T, pdm) fp32 rows the query head writes and the key head reads;
// ss: the (T, K) masked scores; wpack: w_q then w_k as the fp32 image
// (ops/stream_attn.py fwd_wgmma_pack_f32's layout), wbytes its size; grid: 1
// .. the number of 128-ray tiles. Three launches: the query head, the key
// head, the softmax.
static int launch_fwd_wg(SCORE_HEAD_PARAMS, float* attn, float* raw_out,
                         void* qq, void* ss, const void* wpack,
                         long long wbytes, int grid, void* stream) {
  ScoreArgs<float> a;
  int err = fill_args(&a, SCORE_HEAD_ARGS, qq);
  if (err) return err;
  if (!ss) return -604;
  WgLayer layers[2];
  const int dims[2][2] = {{pdq, pdm}, {pdk, pdm}};
  if (wg_plan_f32(layers, dims, 2) != wbytes || !wpack ||
      reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  if (T <= 0) return 0;
  const int tiles = (T + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > tiles) return -209;
  ScoreFwdWg p{};
  p.T = T;
  p.K = K;
  p.w = static_cast<const unsigned char*>(wpack);
  p.qq = static_cast<float*>(qq);
  p.pdm = pdm;
  p.influ = influ;
  p.alive = alive;
  p.sqrt_dm = sqrt_dm;
  p.score_relu = relu;
  p.raw = raw_out;
  p.ss = static_cast<float*>(ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.bias = bq;
  err = launch_score_wg(p, fused_scores_query_wgmma_f32_kernel, layers, 0,
                        static_cast<const float*>(eq), Dq, tiles, grid, st);
  if (err) return err;
  p.bias = bk;
  err = launch_score_wg(p, fused_scores_fwd_wgmma_f32_kernel, layers, 1,
                        static_cast<const float*>(ek), Dk, tiles * K, grid,
                        st);
  if (err) return err;
  key_fwd_softmax_kernel<0><<<(T + 7) / 8, 256, 0, st>>>(p.ss, T, K, bkg,
                                                          attn);
  return (int)cudaGetLastError();
}

// part is (ceil(T / 64), 2 * pdm) fp32; the stashes are Op (K * T, pdm) and
// (T, pdm); dek / deq are Op in the inputs' layouts.
template <class Op>
static int launch_bwd(SCORE_HEAD_PARAMS, SCORE_BWD_PARAMS, void* qq,
                      void* stream) {
  ScoreArgs<Op> a;
  int err = fill_args(&a, SCORE_HEAD_ARGS, qq);
  if (err) return err;
  if (T <= 0) return 0;
  ScoreBwdArgs<Op> b;
  b.dattn = dattn;
  b.wkB = static_cast<const Op*>(wkB);
  b.wqB = static_cast<const Op*>(wqB);
  b.dek = static_cast<Op*>(dek);
  b.deq = static_cast<Op*>(deq);
  b.dinflu = dinflu;
  b.dkk_stash = static_cast<Op*>(dkk_stash);
  b.dqq_stash = static_cast<Op*>(dqq_stash);
  b.part = part;
  cudaError_t e = cudaFuncSetAttribute(
      fused_scores_bwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kScoreSmem);
  if (e != cudaSuccess) return (int)e;
  fused_scores_bwd_kernel<Op><<<(T + kRows - 1) / kRows, kThreads, kScoreSmem,
                                static_cast<cudaStream_t>(stream)>>>(a, b);
  return (int)cudaGetLastError();
}

extern "C" int papr_fused_scores_fwd(SCORE_HEAD_PARAMS, float* attn,
                                     float* raw_out, void* stream) {
  return launch_fwd(SCORE_HEAD_ARGS, attn, raw_out, stream);
}

// The fp32 forward on wgmma: the bf16 form's arguments before its stream
// (wkT / wqT unread: the packed image replaces them), the (T, pdm) qq
// buffer, the (T, K) masked scores, the packed weights (w_q, then w_k),
// their size in bytes, the grid.
extern "C" int papr_fused_scores_f32_fwd(SCORE_HEAD_PARAMS, float* attn,
                                         float* raw_out, void* qq, void* ss,
                                         const void* wpack, long long wbytes,
                                         int grid, void* stream) {
  return launch_fwd_wg(SCORE_HEAD_ARGS, attn, raw_out, qq, ss, wpack, wbytes,
                       grid, stream);
}

extern "C" int papr_fused_scores_bwd(SCORE_HEAD_PARAMS, SCORE_BWD_PARAMS,
                                     void* stream) {
  return launch_bwd<__nv_bfloat16>(SCORE_HEAD_ARGS, SCORE_BWD_ARGS, nullptr,
                                   stream);
}

extern "C" int papr_fused_scores_f32_bwd(SCORE_HEAD_PARAMS, SCORE_BWD_PARAMS,
                                         void* qq, void* stream) {
  return launch_bwd<float>(SCORE_HEAD_ARGS, SCORE_BWD_ARGS, qq, stream);
}
