// The record-native stream backwards on wgmma (Hopper): the walk's forward
// recompute and its reverse walk for key_stream.cu (bf16:
// papr_key_stream_bwd, key_bwd_wgmma_kernel; fp32: papr_key_stream_f32_bwd,
// key_bwd_wgmma_f32_kernel) and value_stream.cu (papr_value_stream_bwd,
// value_bwd_wgmma_kernel; papr_value_stream_f32_bwd,
// value_bwd_wgmma_f32_kernel), one function (stream_bwd_wg) in the two
// operand forms of walk_wgmma.cuh; the embedder backward (embed_wgmma.cuh
// embed_bwd_wg: fused_mlp_bwd.cu fused_mlp_bwd_wgmma_kernel,
// fused_mlp_bwd_wgmma_f32_kernel, and with w_q as a head the fp32 folded key
// stream's query backward, key_stream_q.cu query_head_bwd_wgmma_f32_kernel)
// runs the same pieces (wgb_encode, wgb_fwd, wgb_rev, wgb_in_bwd) on raw
// feature rows. The other walk backwards keep walk_bwd.cuh's WMMA layers.
//
// The function is walk_bwd.cuh's, with its rounding points: each layer's
// input hs[i] rounded to bf16 (and stashed), dz = g * act'(.) rounded to
// bf16 before both the dW and the dX product, fp32 accumulators, column
// sums (db, LayerNorm da / db) of the fp32 gradients, every gradient fp32;
// the position FEATURE gradient dropped; all-dead rays divide by 1.
//
// Layout (walk_wgmma.cuh's): a block is two warpgroups of 64 rays each (128
// rays a tile, 256 threads); a warpgroup loops over k for its rays, and
// both read one TMA-fed ring of 64-row weight chunks: per k step the forward
// layers, then (key) w_k and w_k^T, then the reverse walk's W_l^T from
// l = n - 1 down to 0, all packed on the host into wgmma's K-major
// swizzled image (ops/fused_mlp.py pack_walk_wgmma). Activations stay in
// registers as wgmma A fragments between layers, in both directions:
//   * forward: a layer's m64n128 accumulator gets bias and activation,
//     its relu pattern goes to a bit mask in shared memory (4 words a thread
//     per 256-wide layer: no read-back of the stash), and it is rounded to
//     bf16 into the A fragments of the next product; each layer input is
//     stored from the fragments to the device-memory stash (wgrad.cu forms
//     dW afterwards, as before);
//   * reverse: dX_l = dz_l W_l^T takes dz_l as register A and W_l^T from
//     the ring; the epilogue of each pass is layer l - 1's: the relu mask,
//     the column sums of the fp32 gradient into db, the rounding to bf16
//     into the next product's A fragments and the dz stash;
//   * LayerNorm backward on the accumulator (row reductions over the four
//     threads of a quad); the output LayerNorm's fp32 input goes to a
//     per-warpgroup device scratch slice in the accumulator's own layout.
// The grid is persistent: at most one block an SM, each taking an even,
// contiguous share of the (tile, k) units in tile-major order (200 tiles of
// a 25,600-ray patch would leave a second wave of 68 blocks on 132 SMs); a
// tile split between two blocks has the per-ray sums of its second part
// (dqq, d_rayo, d_rays) in aux buffers that a small combine kernel adds,
// and the value walk's renormalization backward runs there too, on datt
// rows the main kernel writes to device memory.
// Column sums are reduced over the warp's 16 rows by a reduce-scatter of
// shuffles (28 a pass) and added, in a fixed order and without atomics, to
// the warp's own partial row (8 rows a block; colsum in wgrad.cu sums the
// rows). The input LayerNorm's backward, the posenc derivative (the saved
// encoding's sin / cos partner, JAX's _pe_freq_bwd, instead of a fresh
// sincosf), the per-source sums and the geometry backward run per warp on
// its 16 rows of shared memory, lanes over columns. The key's softmax
// backward keeps three numbers a ray (max, sum, inner product) and forms
// each (ray, k)'s score gradient when its k comes, so shared memory does not
// grow with K; a relu mask slot a relu layer.
//
// The fp32 form (use_amp: false; walk_wgmma.cuh's fp32 operand form) is the
// function of walk_bwd.cuh with T = float: nothing rounded, the stash fp32.
// A 256-wide fp32 activation does not fit in registers beside an
// accumulator, so both directions keep a layer's input in the warpgroup's
// rows of shared memory E (kF32Ld floats a row, each warp its own 16 rows)
// and only its output in registers: a whole layer's 128-register
// accumulator, four m64n64k8 3xTF32 passes (wg_gemm_f32: the A fragments
// loaded from E and split hi / lo, a fresh accumulator per 32-deep chunk
// joined by round-to-nearest adds), W (forward) and W_l^T (reverse) through
// the same TMA ring as 16 KB hi / lo stages of ops/fused_mlp.py
// pack_walk_wgmma_f32's image. Each epilogue runs on the accumulator as the
// bf16 form's does on a pass (bias and relu mask; column sums; the output
// LayerNorm and its backward as quad reductions), then writes the rows
// back to E (the next product's operand), from where each warp copies them
// to the stash, 16 bytes a lane (coalesced); no zero chunk (the fp32
// products skip the passes past a layer's width). Shared memory (two
// warpgroups): E 2 x 66 KB, the relu masks 2 KB a relu layer, the geometry
// and per-ray rows, at least two 16 KB ring stages (three at Caterpillar's
// and the flagship's walks).

#pragma once

#include "rec_stream.cuh"
#include "stream_common.cuh"
#include "walk_wgmma.cuh"

namespace papr {

constexpr int kBwdMaxStages = 8;         // weight ring depth at most
constexpr int kBwdPartRows = 8;          // partial rows a block: one a warp
constexpr int kZsFloats = 2 * kAccRegs * 128;   // one warpgroup's z slice
constexpr int kSrcPerLane = 3;           // posenc sources <= 96

// The kernel's parameters, Op the operand form's type (bf16, or fp32).
template <class Op>
struct StreamBwdWgT {
  const float* rec;                      // (K, T, rec_w) k-major
  int rec_w, T, Tp, K;                   // Tp: T padded to kWgTile
  const float* rayo;
  const float* rays;
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  float eps;
  WgLayer layers[kWgMaxLayers];          // the per-k product sequence
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // its stream
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  Op* hs[kMaxLayers + 1];                // stash (N, width) per layer
  Op* dz[kMaxLayers + 1];
  int n_mask;                            // relu mask slots (4 x 128 words)
  int b_off[kMaxLayers];
  int bias_len;
  float* part;                           // (blocks * 8, part_w)
  int part_w;
  float* scratch;                        // scr_wg floats per warpgroup
  int scr_wg;
  const int* seg;
  int nsrc;
  float* drec;
  float* drayo;
  float* drays;
  int ld, e_floats, wg_floats;           // shared memory layout (floats)
  int n_prm;                             // LayerNorms, plan, b_k (floats)
  // key
  const float* qq;
  int dm;
  float sqrt_dm;
  const float* raw;
  const float* ss;
  const float* dattn;
  const float* bk;
  int dm_pad, dbk_off, score_relu;
  float bkg;
  float* dqq;
  // value
  const float* attn;
  const float* dfused;
  int normalize;
  float* datt;                           // (T, K): d attn_k before renorm
  // The persistent grid: n_units = tiles * K (tile, k) units over grid
  // blocks; the second part of a split tile writes these instead of dqq /
  // drayo / drays.
  int n_units, grid;
  float* dqq_aux;
  float* drayo_aux;
  float* drays_aux;
};
using StreamBwdWg = StreamBwdWgT<__nv_bfloat16>;

// Host side: the walk, its product sequence (forward layers, then the head
// pair w_k (pd[n] -> head_pd) and w_k^T when head_pd > 0, then W_l^T for
// l = n - 1 .. 0) in the form's image (wg_plan / wg_plan_f32), the stash,
// the partial rows and the shared-memory layout. Returns 0 or a negative
// code; *smem gets the block's bytes.
template <class Op>
inline int fill_stream_bwd_wg(StreamBwdWgT<Op>* p, const int* meta,
                              const void* w, const void* b, const void* ln,
                              const void* plan, int head_pd,
                              const void* wpack, long long wbytes, void* stash,
                              const long long* stash_off, float* part,
                              int part_w, float* scratch, int K,
                              size_t* smem) {
  int err = fill_walk(&p->d, meta, w, b, ln, plan);
  if (err) return err;
  const WalkDesc& d = p->d;
  const int n = d.n;
  if (2 * n + 2 > kWgMaxLayers) return -206;
  if (!head_pd && d.pd[n] > kPassN) return -207;   // value rows: one pass
  int dims[kWgMaxLayers][2], m = 0;
  for (int i = 0; i < n; ++i, ++m) {
    dims[m][0] = d.pd[i];
    dims[m][1] = d.pd[i + 1];
  }
  if (head_pd) {
    dims[m][0] = d.pd[n];
    dims[m++][1] = head_pd;
    dims[m][0] = head_pd;
    dims[m++][1] = d.pd[n];
  }
  for (int l = n - 1; l >= 0; --l, ++m) {
    dims[m][0] = d.pd[l + 1];
    dims[m][1] = d.pd[l];
  }
  constexpr bool f32 = kF32<Op>;
  const long long need = f32 ? wg_plan_f32(p->layers, dims, m)
                             : wg_plan(p->layers, dims, m);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p->n_chunks = f32 ? wg_chunks_f32(p->chunks, need)
                    : wg_chunks(p->chunks, p->layers, m);
  p->w = static_cast<const unsigned char*>(wpack);
  const int n_stash = n + (head_pd ? 1 : 0);
  for (int i = 0; i < n_stash; ++i) {
    if (stash_off[i] % 8 != 0 || stash_off[n_stash + i] % 8 != 0) return -112;
    p->hs[i] = static_cast<Op*>(stash) + stash_off[i];
    p->dz[i] = static_cast<Op*>(stash) + stash_off[n_stash + i];
  }
  const int* b_off = meta + 7 + (n + 1) + n;
  for (int i = 0; i < n; ++i) p->b_off[i] = b_off[i];
  p->bias_len = b_off[n - 1] + d.pd[n];
  if (part_w < p->bias_len + 2 * d.pd[0] + 2 * d.pd[n] + head_pd) return -113;
  p->part = part;
  p->part_w = part_w;
  p->scratch = scratch;
  p->scr_wg = kWgRows * d.pd[0] + (d.has_lo ? kZsFloats : 0);
  if constexpr (f32) {
    p->ld = kF32Ld;                          // E in the fp32 form's rows
    p->e_floats = kWgRows * kF32Ld;
  } else {
    p->ld = (d.pd[0] + 31) / 32 * 32 + 4;    // 16-byte rows, distinct banks
    p->e_floats = kWgRows * p->ld > kParkWords * 128 ? kWgRows * p->ld
                                                     : kParkWords * 128;
  }
  // A mask slot a relu layer (the last layer only with a relu last_act);
  // the key's softmax backward three numbers a ray.
  p->n_mask = d.last_act == 1 ? n : n - 1;
  p->wg_floats = kWgRows * kGeo + p->e_floats + p->n_mask * 4 * 128 +
                 kWgRows * (2 + kNGeoSrc + (head_pd ? 3 : 0) + 2);
  p->wg_floats = (p->wg_floats + 3) & ~3;   // E 16-byte aligned in both
  p->n_prm = 5 * d.pd[0] + 2 * d.pd[n] + head_pd;
  p->n_prm += p->n_prm & 1;
  // The fp32 form has no zero chunk.
  const size_t rest = 1024 + (f32 ? 0 : kWStageBytes) + sizeof(float) *
      (2 * (size_t)p->wg_floats + p->n_prm) +
      kBwdMaxStages * (sizeof(uint64_t) + sizeof(int));
  if (rest + 2 * (size_t)kWStageBytes > 232448) return -203;
  p->stages = (int)((232448 - rest) / kWStageBytes);
  if (p->stages > kBwdMaxStages) p->stages = kBwdMaxStages;
  *smem = rest + (size_t)p->stages * kWStageBytes;
  p->K = K;
  return 0;
}

// The warp's 16 rows of the walk's posenc into E (fp32, ld floats a row),
// lanes over columns; pad lanes 0. src_val(r, src): row r's source value
// (walk_wgmma.cuh RecSrc, or the embedder's raw feature row); plan: the
// posenc plan (shared memory). A column's 16 sources are loaded together
// (the reads overlap) and parked in E, then encoded in place row by row (one
// copy of the sin / cos code).
template <class Src>
__device__ __forceinline__ void wgb_encode(float* E, int ld, const WalkDesc& d,
                                           const float* plan, int row0,
                                           const Src& src_val) {
  const int lane = threadIdx.x & 31, pd0 = d.pd[0];
  for (int c = lane; c < pd0; c += 32) {
    const bool live = c < d.d_enc;
    const int src = live ? (int)plan[c] : 0;
    const float freq = live ? plan[pd0 + c] : 0.f;
    const int kind = live ? (int)plan[2 * pd0 + c] : 0;
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = live ? src_val(row0 + i, src) : 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) E[(row0 + i) * ld + c] = x[i];
#pragma unroll 1
    for (int i = 0; i < 16; ++i) {
      float& v = E[(row0 + i) * ld + c];
      v = live ? encode_value(v, freq, kind) : 0.f;
    }
  }
}

// The warp's 16 encoded rows through the input LayerNorm (ln: the walk's
// LayerNorm table; statistics to st[r] / st[kWgRows + r]) or as they are,
// in place: the bf16 form (Op) rounds them, row r's bf16 values at the
// start of its fp32 row; the fp32 form keeps them fp32.
template <class Op>
__device__ __forceinline__ void wgb_rows_in_st(float* E, int ld,
                                               const WalkDesc& d,
                                               const float* ln, float* st,
                                               int row0) {
  const int lane = threadIdx.x & 31, pd0 = d.pd[0], n = d.d_enc;
  for (int r = row0; r < row0 + 16; ++r) {
    float* row = E + r * ld;
    float v[kMaxWidth / 32];
#pragma unroll
    for (int m = 0; m < kMaxWidth / 32; ++m) {
      const int c = lane + 32 * m;
      v[m] = c < pd0 ? row[c] : 0.f;
    }
    if (d.has_li) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxWidth / 32; ++m)
        if (lane + 32 * m < n) s += v[m];
      const float mu = warp_sum(s) / (float)n;
      float q = 0.f;
#pragma unroll
      for (int m = 0; m < kMaxWidth / 32; ++m)
        if (lane + 32 * m < n) {
          const float dv = v[m] - mu;
          q += dv * dv;
        }
      const float var = warp_sum(q) / (float)(n > 1 ? n - 1 : 1);
      const float rr = 1.f / (sqrtf(var) + kLnEps);
      if (lane == 0) {
        st[r] = mu;
        st[kWgRows + r] = rr;
      }
#pragma unroll
      for (int m = 0; m < kMaxWidth / 32; ++m) {
        const int c = lane + 32 * m;
        v[m] = c < n ? (v[m] - mu) * rr * ln[c] + ln[pd0 + c] : 0.f;
      }
    }
    __syncwarp();
    if constexpr (kF32<Op>) {
#pragma unroll
      for (int m = 0; m < kMaxWidth / 32; ++m) {
        const int c = lane + 32 * m;
        if (c < pd0) row[c] = v[m];
      }
    } else {
      __nv_bfloat16* rb = reinterpret_cast<__nv_bfloat16*>(row);
#pragma unroll
      for (int m = 0; m < kMaxWidth / 32; ++m) {
        const int c = lane + 32 * m;
        if (c < pd0) rb[c] = __float2bfloat16_rn(v[m]);
      }
    }
  }
  __syncwarp();
}

// The warp's 16 bf16 rows (pd wide, at the start of each fp32 row of E) to
// stash rows srow0 + r, 16 bytes a lane.
__device__ __forceinline__ void stash_rows(const float* E, int ld,
                                           __nv_bfloat16* dst, size_t srow0,
                                           int pd, int row0) {
  const int lane = threadIdx.x & 31, upr = pd / 8;
  for (int r = row0; r < row0 + 16; ++r)
    for (int u = lane; u < upr; u += 32)
      *reinterpret_cast<uint4*>(dst + (srow0 + r) * pd + 8 * u) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const __nv_bfloat16*>(E + r * ld) + 8 * u);
}

// The fp32 form: the warp's 16 rows of E (pd wide, kF32Ld floats a row) to
// stash rows srow0 + r, 16 bytes a lane (a warp's store covers 512
// contiguous bytes of a row).
__device__ __forceinline__ void stash_rows_f32(const float* E, float* dst,
                                               size_t srow0, int pd,
                                               int row0) {
  const int lane = threadIdx.x & 31, upr = pd / 4;
  for (int r = row0; r < row0 + 16; ++r)
    for (int u = lane; u < upr; u += 32)
      *reinterpret_cast<float4*>(dst + (srow0 + r) * pd + 4 * u) =
          *reinterpret_cast<const float4*>(E + r * kF32Ld + 4 * u);
}

// One pass's 32 bf16x2 words (word i: row g + 8 (i & 1), columns
// c0 + 8 (i >> 1) + 2 q and + 1; the A fragment layout) to the stash rows of
// the warpgroup (srow0 + its row), columns < pd.
__device__ __forceinline__ void stash_w(const uint32_t (&w)[32],
                                        __nv_bfloat16* dst, size_t srow0,
                                        int pd, int c0) {
  const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
  const int r0 = 16 * (t >> 5) + g;
  uint32_t* row0 = reinterpret_cast<uint32_t*>(dst + (srow0 + r0) * pd);
  uint32_t* row1 = reinterpret_cast<uint32_t*>(dst + (srow0 + r0 + 8) * pd);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = c0 + 8 * (i >> 1) + 2 * q;
    if (c < pd) ((i & 1) ? row1 : row0)[c >> 1] = w[i];
  }
}

// The A fragments (pd columns) to the stash.
__device__ __forceinline__ void stash_a(const uint32_t (&A)[kARegs],
                                        __nv_bfloat16* dst, size_t srow0,
                                        int pd) {
  uint32_t w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = A[i];
  stash_w(w, dst, srow0, pd, 0);
  if (pd > kPassN) {
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = A[32 + i];
    stash_w(w, dst, srow0, pd, kPassN);
  }
}

// A pass's 128 columns rounded to bf16 (the stash's and the next product's
// values), then placed: to 0 in A[0..31], 1 in A[32..63], 2 in the
// thread's parking slots.
__device__ __forceinline__ void round_pass(const float (&acc)[kAccRegs],
                                           uint32_t (&w)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}
__device__ __forceinline__ void place_words(const uint32_t (&w)[32],
                                            uint32_t (&A)[kARegs],
                                            uint32_t* park_u, int to) {
  const int t = threadIdx.x & 127;
  if (to == 2) {
#pragma unroll
    for (int i = 0; i < 32; ++i) park_u[i * 128 + t] = w[i];
  } else if (to == 1) {
#pragma unroll
    for (int i = 0; i < 32; ++i) A[32 + i] = w[i];
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) A[i] = w[i];
  }
}

// A pass of layer L: acc = A @ W (acc cleared first, so its registers are
// free between a pass's epilogue and the next pass).
__device__ __forceinline__ void wgb_pass(float (&acc)[kAccRegs],
                                         uint32_t (&A)[kARegs], WgRing& ring,
                                         const WgLayer& L,
                                         const unsigned char* zero) {
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.f;
  wg_pass(acc, A, ring, L, zero);
}

// The relu pattern of a pass (acc > 0) as two words a thread: bit i of word
// 2 p + (i >> 5) for register i (the fp32 form's whole layer: its two
// halves as passes p, p + 1).
template <int N>
__device__ __forceinline__ void store_mask(const float (&acc)[N],
                                           uint32_t* mask, int p) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int hh = 0; hh < N / kAccRegs; ++hh) {
    uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      w0 |= (acc[kAccRegs * hh + i] > 0.f ? 1u : 0u) << i;
      w1 |= (acc[kAccRegs * hh + 32 + i] > 0.f ? 1u : 0u) << i;
    }
    mask[(2 * (p + hh)) * 128 + t] = w0;
    mask[(2 * (p + hh) + 1) * 128 + t] = w1;
  }
}

// Column sums over the warp's 16 rows of a pass's values val(i) (register i
// of the accumulator layout), added to dst[c] for the pass's columns
// c < ncol: the two rows of a thread, then a reduce-scatter over the eight
// row groups (xor 16, 8, 4), after which each thread holds four columns.
template <class Val>
__device__ __forceinline__ void colsum_pass(Val val, float* dst, int ncol) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
  const int off = (b2 ? 16 : 0) + (b1 ? 8 : 0) + (b0 ? 4 : 0);
  float old[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = off + ii, c = 8 * (i >> 1) + 2 * q + (i & 1);
    old[ii] = c < ncol ? dst[c] : 0.f;
  }
  float v[32];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) v[2 * j + e] = val(4 * j + e) + val(4 * j + 2 + e);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float keep = b2 ? v[16 + i] : v[i], send = b2 ? v[i] : v[16 + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = b1 ? v[8 + i] : v[i], send = b1 ? v[i] : v[8 + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b0 ? v[4 + i] : v[i], send = b0 ? v[i] : v[4 + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = off + ii, c = 8 * (i >> 1) + 2 * q + (i & 1);
    if (c < ncol) dst[c] = old[ii] + v[ii];
  }
}

// colsum_pass over a whole layer of the fp32 form (val(i), i < kOutRegs):
// its two halves, the second only where ncol reaches it.
template <class Val>
__device__ __forceinline__ void colsum_layer(Val val, float* dst, int ncol) {
  colsum_pass([&](int i) { return val(i); }, dst, ncol);
  if (ncol > kPassN)
    colsum_pass([&](int i) { return val(kAccRegs + i); }, dst + kPassN,
                ncol - kPassN);
}

// The reverse walk's epilogue on the fp32 gradient of layer l's output,
// pass p (columns 128 p ..) in acc: columns >= width and, with a mask, the
// relu's dead outputs become 0; the column sums go to db (part_db); the
// result, rounded to bf16, goes to the dz stash and where place_words puts
// it (to).
__device__ __forceinline__ void rev_epilogue(float (&acc)[kAccRegs],
                                             uint32_t (&A)[kARegs],
                                             uint32_t* park_u, int to,
                                             const uint32_t* mask, int p,
                                             int width, float* part_db,
                                             __nv_bfloat16* dz,
                                             size_t srow0) {
  const int t = threadIdx.x & 127, q = t & 3, c0 = kPassN * p;
  const uint32_t m0 = mask ? mask[(2 * p) * 128 + t] : ~0u;
  const uint32_t m1 = mask ? mask[(2 * p + 1) * 128 + t] : ~0u;
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) {
    const int c = c0 + 8 * (i >> 2) + 2 * q + (i & 1);
    const uint32_t bit = i < 32 ? (m0 >> i) & 1u : (m1 >> (i - 32)) & 1u;
    acc[i] = c < width && bit ? acc[i] : 0.f;
  }
  colsum_pass([&](int i) { return acc[i]; }, part_db + c0, width - c0);
  uint32_t w[32];
  round_pass(acc, w);
  stash_w(w, dz, srow0, width, c0);
  place_words(w, A, park_u, to);
}

// The walk's output LayerNorm (walk.cuh layernorm_rows) on the thread's two
// rows, as walk_wgmma.cuh acc_layernorm (N: a bf16 pass's registers, or the
// fp32 form's whole layer without park), keeping each row's mean and
// 1 / (std + eps) in mu / rr for the backward.
template <int N>
__device__ __forceinline__ void acc_layernorm_st(float (&acc)[N],
                                                 float* park, int n_true,
                                                 const float* a,
                                                 const float* b,
                                                 float (&mu)[2],
                                                 float (&rr)[2]) {
  const int t = threadIdx.x & 127, q = t & 3;
  const int c1 = park ? kPassN : 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park && c < n_true) s += park[i * 128 + t];
        if (c1 + c < n_true) s += acc[i];
      }
    const float m = quad_sum(s) / (float)n_true;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park && c < n_true) {
          const float dv = park[i * 128 + t] - m;
          v += dv * dv;
        }
        if (c1 + c < n_true) {
          const float dv = acc[i] - m;
          v += dv * dv;
        }
      }
    const float var = quad_sum(v) / (float)(n_true > 1 ? n_true - 1 : 1);
    const float r = 1.f / (sqrtf(var) + kLnEps);
    mu[h] = m;
    rr[h] = r;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park) {
          float& x = park[i * 128 + t];
          x = c < n_true ? (x - m) * r * a[c] + b[c] : 0.f;
        }
        float& x = acc[i];
        x = c1 + c < n_true ? (x - m) * r * a[c1 + c] + b[c1 + c] : 0.f;
      }
  }
}

// _ln_bwd (walk_bwd.cuh ln_bwd) on the accumulator: the gradient g of the
// LayerNorm's output in acc (columns 128.. with park holding columns 0..127
// as fp32 slices, or columns 0.. without park; N = kOutRegs: the fp32
// form's whole layer, without park) becomes the gradient of its input, in
// place; da = sum g (z - mu) r and db = sum g over the warp's rows go to
// part_a / part_b. z, the fp32 input, is read from the scratch slice zs
// (pass p's register i at (64 p + i) * 128 + t); where parked values are
// written back, 16 at a time after their z is loaded. a (the LayerNorm's
// gain) lies in shared memory.
template <int N>
__device__ __forceinline__ void acc_ln_bwd(float (&acc)[N], float* park,
                                           const float* zs,
                                           const float (&mu)[2],
                                           const float (&rr)[2], int n_true,
                                           const float* a, float* part_a,
                                           float* part_b) {
  const int t = threadIdx.x & 127, q = t & 3;
  const int c1 = park ? kPassN : 0, z1 = park ? kAccRegs : 0;
  auto hrow = [](int i) { return (i >> 1) & 1; };
  auto col = [&](int i) { return 8 * (i >> 2) + 2 * q + (i & 1); };
  auto zm = [&](int slot) { return zs[slot * 128 + t] - mu[hrow(slot)]; };
  float cs[2] = {0.f, 0.f};
  if (park) {
    colsum_pass([&](int i) { return park[i * 128 + t] * zm(i) * rr[hrow(i)]; },
                part_a, n_true);
    colsum_pass([&](int i) { return park[i * 128 + t]; }, part_b, n_true);
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i)
      if (col(i) < n_true) cs[hrow(i)] += park[i * 128 + t] * a[col(i)] * zm(i);
  }
#pragma unroll
  for (int hp = 0; hp < N / kAccRegs; ++hp) {
    const int o = kAccRegs * hp, co = c1 + kPassN * hp;
    if (co >= n_true) break;
    colsum_pass(
        [&](int i) { return acc[o + i] * zm(z1 + o + i) * rr[hrow(i)]; },
        part_a + co, n_true - co);
    colsum_pass([&](int i) { return acc[o + i]; }, part_b + co, n_true - co);
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (c1 + col(i) < n_true) cs[hrow(i)] += acc[i] * a[c1 + col(i)] * zm(z1 + i);
  float wr[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float c = quad_sum(cs[h]);
    const float sd = 1.f / rr[h] - kLnEps;       // recover std from r
    const float denom =
        (float)(n_true > 1 ? n_true - 1 : 1) * fmaxf(sd, 1e-30f);
    wr[h] = sd > 0.f ? -c * rr[h] * rr[h] / denom : 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int h = hrow(i);
    if (c1 + col(i) < n_true) {
      acc[i] = acc[i] * a[c1 + col(i)] * rr[h] + wr[h] * zm(z1 + i);
      sum[h] += acc[i];
    }
  }
  if (park) {
#pragma unroll
    for (int i0 = 0; i0 < kAccRegs; i0 += 16) {
      float z[16];
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) z[ii] = zm(i0 + ii);
#pragma unroll
      for (int ii = 0; ii < 16; ++ii) {
        const int i = i0 + ii, h = hrow(i);
        if (col(i) < n_true) {
          float& x = park[i * 128 + t];
          x = x * a[col(i)] * rr[h] + wr[h] * z[ii];
          sum[h] += x;
        }
      }
    }
  }
  float mean[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) mean[h] = quad_sum(sum[h]) / (float)n_true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (park) {
      float& x = park[i * 128 + t];
      x = col(i) < n_true ? x - mean[hrow(i)] : 0.f;
    }
    acc[i] = c1 + col(i) < n_true ? acc[i] - mean[hrow(i)] : 0.f;
  }
}

// The fp32 pass in acc (the fp32 form: the whole layer, p = 0) to the
// scratch slice (pass p).
template <int N>
__device__ __forceinline__ void save_slice(const float (&acc)[N], float* zs,
                                           int p) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < N; ++i) zs[(N * p + i) * 128 + t] = acc[i];
}

// The forward recompute of walk d on the warpgroup's rows from the A
// fragments of its bf16 input (which the caller stashes): each later layer's
// input to the stash hs[l] (rows srow0 ..), its relu pattern to masks (512
// words a layer), with an output LayerNorm the last layer's fp32 output to
// the scratch slice zs_s; the last layer's fp32 output is left in acc, a
// 256-wide one's first pass parked fp32 at park. Returns whether the last
// layer took two passes.
__device__ __forceinline__ bool wgb_fwd(float (&acc)[kAccRegs],
                                        uint32_t (&A)[kARegs], WgRing& rg,
                                        const unsigned char* zero,
                                        const WalkDesc& d,
                                        const WgLayer* layers,
                                        __nv_bfloat16* const* hs,
                                        size_t srow0, uint32_t* masks,
                                        float* park, float* zs_s) {
  const int n = d.n;
  uint32_t* park_u = reinterpret_cast<uint32_t*>(park);
  bool two = false;
  for (int l = 0; l < n; ++l) {
    const bool last = l + 1 == n;
    const WgLayer& Ly = layers[l];
    const int np = Ly.ni > kPassN ? 2 : 1;
    const int act = last ? d.last_act : d.act;
    uint32_t* mk = act == 1 ? masks + l * 512 : nullptr;
    if (l > 0) stash_a(A, hs[l], srow0, d.pd[l]);
    for (int pp = 0; pp < np; ++pp) {
      wgb_pass(acc, A, rg, Ly, zero);
      acc_bias_act(acc, d.b[l] + kPassN * pp,
                   pp + 1 < np ? kPassN : Ly.pd_out - kPassN * pp, act);
      if (mk) store_mask(acc, mk, pp);
      if (last) {
        if (d.has_lo) save_slice(acc, zs_s, pp);
        if (pp + 1 < np) park_f32(acc, park);
      } else if (pp + 1 < np) {
        park_bf16(acc, park_u);
      } else if (np == 2) {
        acc_to_a<32>(acc, A);
        unpark_bf16(park_u, A);
      } else {
        acc_to_a<0>(acc, A);
      }
    }
    two = np == 2;
  }
  return two;
}

// The reverse walk from the gradient of the walk's output (in acc; with
// two, its first 128 columns parked fp32 at park): the last layer's
// epilogue (its second pass first, from acc; then the first, from the
// parking slots), then per layer l the product dz_l W_l^T (rev: the W_l^T
// layers from l = n - 1 down) and layer l - 1's epilogue; layer 0's product
// is the encoding's gradient, fp32 into the warp's rows of E.
__device__ __forceinline__ void wgb_rev(float (&acc)[kAccRegs],
                                        uint32_t (&A)[kARegs], WgRing& rg,
                                        const unsigned char* zero,
                                        const WalkDesc& d, const WgLayer* rev,
                                        __nv_bfloat16* const* dz,
                                        const int* b_off, float* prow,
                                        size_t srow0, const uint32_t* masks,
                                        float* park, bool two, float* E,
                                        int ld) {
  const int n = d.n, pd0 = d.pd[0], pdn = d.pd[n];
  const int wg = threadIdx.x >> 7, t_in = threadIdx.x & 127;
  const int lane = t_in & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * (t_in >> 5);
  const int rl[2] = {row0 + g, row0 + g + 8};
  uint32_t* park_u = reinterpret_cast<uint32_t*>(park);
  const uint32_t* mz = d.last_act == 1 ? masks + (n - 1) * 512 : nullptr;
  for (int pp = two ? 1 : 0; pp >= 0; --pp) {
    if (pp == 0 && two)
#pragma unroll
      for (int i = 0; i < kAccRegs; ++i) acc[i] = park[i * 128 + t_in];
    rev_epilogue(acc, A, park_u, pp, mz, pp, pdn, prow + b_off[n - 1],
                 dz[n - 1], srow0);
  }
  for (int l = n - 1; l >= 0; --l) {
    const WgLayer& R = rev[n - 1 - l];
    const int np = R.ni > kPassN ? 2 : 1;
    const uint32_t* ml =
        l > 0 && d.act == 1 ? masks + (l - 1) * 512 : nullptr;
    // Before E's rows are written: no thread reads a parking slot any
    // more.
    if (l == 0) named_sync(2 + wg, 128);
    for (int pp = 0; pp < np; ++pp) {
      wgb_pass(acc, A, rg, R, zero);
      if (l > 0) {
        rev_epilogue(acc, A, park_u, np == 2 ? 2 - pp : 0, ml, pp, d.pd[l],
                     prow + b_off[l - 1], dz[l - 1], srow0);
      } else {
#pragma unroll
        for (int i = 0; i < kAccRegs; ++i) {
          const int c = kPassN * pp + 8 * (i >> 2) + 2 * q + (i & 1);
          if (c < pd0) E[rl[(i >> 1) & 1] * ld + c] = acc[i];
        }
      }
    }
    if (l > 0 && np == 2) unpark_bf16(park_u, A);
  }
}

// The fp32 form's forward recompute of walk d on the warp's rows of E (the
// layer-0 input there, stashed by the caller): each layer's whole output in
// acc, its relu pattern to masks (slot l, 512 words), each later layer's
// input back to E and from there to the stash hs[l]; with an output
// LayerNorm the last layer's output to the scratch slice zs_s. The last
// layer's output is left in acc; returns false (nothing parked).
__device__ __forceinline__ bool wgb_fwd(float (&acc)[kOutRegs], WgRowsA& A,
                                        WgRing& rg, const unsigned char*,
                                        const WalkDesc& d,
                                        const WgLayer* layers,
                                        float* const* hs, size_t srow0,
                                        uint32_t* masks, float*,
                                        float* zs_s) {
  const int n = d.n;
  for (int l = 0; l < n; ++l) {
    const bool last = l + 1 == n;
    const int act = last ? d.last_act : d.act;
    wg_gemm_f32(acc, A.E, A.row0, rg, layers[l]);
    acc_bias_act(acc, d.b[l], layers[l].pd_out, act);
    if (act == 1) store_mask(acc, masks + l * 512, 0);
    if (!last) {
      wg_rows_out(acc, A.E, A.row0);
      stash_rows_f32(A.E, hs[l + 1], srow0, d.pd[l + 1], A.row0);
    } else if (d.has_lo) {
      save_slice(acc, zs_s, 0);
    }
  }
  return false;
}

// The fp32 form's reverse-walk epilogue on the gradient of a layer's output
// (width columns, every column in acc): the relu's dead outputs (mask) and
// columns >= width become 0, the column sums go to db (part_db), the rows
// back to E (the next product's operand) and from there to the dz stash.
__device__ __forceinline__ void rev_epilogue(float (&acc)[kOutRegs],
                                             WgRowsA& A,
                                             const uint32_t* mask, int width,
                                             float* part_db, float* dz,
                                             size_t srow0) {
  const int t = threadIdx.x & 127, q = t & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const uint32_t m0 = mask ? mask[(2 * hh) * 128 + t] : ~0u;
    const uint32_t m1 = mask ? mask[(2 * hh + 1) * 128 + t] : ~0u;
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i) {
      const int c = kPassN * hh + 8 * (i >> 2) + 2 * q + (i & 1);
      const uint32_t bit = i < 32 ? (m0 >> i) & 1u : (m1 >> (i - 32)) & 1u;
      float& x = acc[kAccRegs * hh + i];
      x = c < width && bit ? x : 0.f;
    }
  }
  colsum_layer([&](int i) { return acc[i]; }, part_db, width);
  wg_rows_out(acc, A.E, A.row0);
  stash_rows_f32(A.E, dz, srow0, width, A.row0);
}

// The fp32 form's reverse walk from the gradient of the walk's output (in
// acc): the last layer's epilogue, then per layer l the product dz_l W_l^T
// (rev: the W_l^T layers from l = n - 1 down) and layer l - 1's epilogue;
// layer 0's product, the encoding's gradient, goes to the warp's rows of E.
__device__ __forceinline__ void wgb_rev(float (&acc)[kOutRegs], WgRowsA& A,
                                        WgRing& rg, const unsigned char*,
                                        const WalkDesc& d, const WgLayer* rev,
                                        float* const* dz, const int* b_off,
                                        float* prow, size_t srow0,
                                        const uint32_t* masks, float*, bool,
                                        float*, int) {
  const int n = d.n;
  rev_epilogue(acc, A, d.last_act == 1 ? masks + (n - 1) * 512 : nullptr,
               d.pd[n], prow + b_off[n - 1], dz[n - 1], srow0);
  for (int l = n - 1; l >= 0; --l) {
    wg_gemm_f32(acc, A.E, A.row0, rg, rev[n - 1 - l]);
    if (l > 0)
      rev_epilogue(acc, A, d.act == 1 ? masks + (l - 1) * 512 : nullptr,
                   d.pd[l], prow + b_off[l - 1], dz[l - 1], srow0);
    else
      wg_rows_out(acc, A.E, A.row0);
  }
}

// Per warp, on its 16 rows of E (the fp32 gradient of the encoding): the
// input LayerNorm's backward (statistics st: mean at st[r], 1 / (std + eps)
// at st[kWgRows + r]; its da / db added to prow[L ..], prow[L + pd0 ..]),
// the posenc derivative (the saved encoding enc_s's sin / cos partner,
// JAX's _pe_freq_bwd, instead of a fresh sincosf), then each of the lane's
// sources s < nsrc summed over its segment [seg0, seg1) and handed to
// sink(r, s, value).
template <class Sink>
__device__ __forceinline__ void wgb_in_bwd(float* E, int ld, const WalkDesc& d,
                                           const float* enc_s, const float* st,
                                           const float* lns, const float* plan,
                                           float* prow, int L, int row0,
                                           const int (&seg0)[kSrcPerLane],
                                           const int (&seg1)[kSrcPerLane],
                                           int nsrc, const Sink& sink) {
  const int lane = threadIdx.x & 31, pd0 = d.pd[0];
  float sa[kMaxWidth / 32], sb[kMaxWidth / 32];
#pragma unroll
  for (int m = 0; m < kMaxWidth / 32; ++m) sa[m] = sb[m] = 0.f;
  const int nt = d.d_enc;
  constexpr int kM = kMaxWidth / 32;
  for (int r = row0; r < row0 + 16; ++r) {
    float* row = E + r * ld;
    const float* x = enc_s + r * pd0;
    // The row's gradient, its saved encoding and each column's sin / cos
    // partner, loaded before anything is written.
    float gv[kM], xv[kM], xp[kM], fq[kM];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int c = lane + 32 * m;
      const int kind = c < nt ? (int)plan[2 * pd0 + c] : 0;
      gv[m] = c < pd0 ? row[c] : 0.f;
      xv[m] = c < nt ? x[c] : 0.f;
      xp[m] = kind == 1 ? x[c + 1] : kind == 2 ? x[c - 1] : 1.f;
      fq[m] = kind == 1 ? plan[pd0 + c] : kind == 2 ? -plan[pd0 + c] : 1.f;
    }
    if (d.has_li) {
      const float m0 = st[r], qv = st[kWgRows + r];
      float cs = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int c = lane + 32 * m;
        if (c < nt) cs += gv[m] * lns[c] * (xv[m] - m0);
      }
      cs = warp_sum(cs);
      const float sd = 1.f / qv - kLnEps;
      const float denom = (float)(nt > 1 ? nt - 1 : 1) * fmaxf(sd, 1e-30f);
      const float wr = sd > 0.f ? -cs * qv * qv / denom : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int c = lane + 32 * m;
        if (c < nt) {
          const float gg = gv[m], xm = xv[m] - m0;
          sa[m] += gg * xm * qv;
          sb[m] += gg;
          gv[m] = gg * lns[c] * qv + wr * xm;
          sum += gv[m];
        }
      }
      const float mean = warp_sum(sum) / (float)nt;
#pragma unroll
      for (int m = 0; m < kM; ++m)
        gv[m] = lane + 32 * m < nt ? gv[m] - mean : 0.f;
    }
    // _pe_freq_bwd: d sin / dx = freq cos, d cos / dx = -freq sin, from
    // the partner column of the saved encoding (sin, cos adjacent).
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int c = lane + 32 * m;
      if (c < pd0) row[c] = gv[m] * fq[m] * xp[m];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSrcPerLane; ++j) {
      const int s = lane + 32 * j;
      if (s >= nsrc) continue;
      float v = 0.f;
      for (int c = seg0[j]; c < seg1[j]; ++c) v += row[c];
      sink(r, s, v);
    }
    __syncwarp();
  }
  if (d.has_li)
#pragma unroll
    for (int m = 0; m < kMaxWidth / 32; ++m) {
      const int c = lane + 32 * m;
      if (c < nt) {
        prow[L + c] += sa[m];
        prow[L + pd0 + c] += sb[m];
      }
    }
}

// The backward of the record-native key stream (kKey: the score head,
// key_stream.cu) or value stream (the fuse step, value_stream.cu) on the
// block's share of the (tile, k) units, in either operand form (Op: bf16,
// or fp32); see the header.
template <bool kKey, class Op = __nv_bfloat16>
__device__ __forceinline__ void stream_bwd_wg(const StreamBwdWgT<Op>& p) {
  constexpr bool f32 = kF32<Op>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* zero = smem;                     // bf16: one zero chunk
  unsigned char* ring = smem + (f32 ? 0 : kWStageBytes);
  float* tiles = reinterpret_cast<float*>(ring + p.stages * kWStageBytes);
  // The walk's LayerNorm table, its posenc plan, then b_k (key).
  float* lns = tiles + 2 * p.wg_floats;
  float* plan = lns + 2 * p.d.pd[0] + 2 * p.d.pd[p.d.n];
  float* bks = plan + 3 * p.d.pd[0];
  uint64_t* full = reinterpret_cast<uint64_t*>(lns + p.n_prm);
  int* released = reinterpret_cast<int*>(full + p.stages);
  const int tid = threadIdx.x;
  {
    const int nln = 2 * p.d.pd[0] + 2 * p.d.pd[p.d.n], npl = 3 * p.d.pd[0];
    for (int i = tid; i < nln; i += kWgThreads) lns[i] = p.d.ln[i];
    for (int i = tid; i < npl; i += kWgThreads) plan[i] = p.d.plan[i];
    if (kKey)
      for (int i = tid; i < p.dm_pad; i += kWgThreads) bks[i] = p.bk[i];
  }
  if constexpr (f32) {
    // Every E column a product reads is finite from the start (columns
    // past a layer's input width meet zero weight rows).
    for (int i = tid; i < 2 * p.wg_floats; i += kWgThreads) tiles[i] = 0.f;
  } else {
    for (int i = tid; i < kWStageBytes / 16; i += kWgThreads)
      reinterpret_cast<uint4*>(zero)[i] = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  if (tid < p.stages) released[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // The block's share of the (tile, k) units, in tile-major order: a
  // contiguous range of at least K units, so a tile is split between at
  // most two blocks; the part without k = 0 writes the per-ray sums to the
  // aux buffers (added by the combine kernel).
  const long long n_units = p.n_units;
  const int u_begin = (int)(n_units * blockIdx.x / p.grid);
  const int u_end = (int)(n_units * (blockIdx.x + 1) / p.grid);
  WgRing rg{ring, full, released, p.stages, 0, p.n_chunks,
            p.n_chunks * (u_end - u_begin), p.chunks, p.w};
  if (tid == 0)
    for (int j = 0; j < p.stages && j < rg.total; ++j) wg_issue(rg, j);

  const WalkDesc& d = p.d;
  const int wg = tid >> 7, t_in = tid & 127, w = t_in >> 5, lane = t_in & 31;
  const int g = lane >> 2, q = lane & 3, row0 = 16 * w;
  const int n = d.n, pd0 = d.pd[0], pdn = d.pd[n], K = p.K, T = p.T;
  const int ld = p.ld, L = p.bias_len;
  const int rl[2] = {row0 + g, row0 + g + 8};
  float* geo = tiles + wg * p.wg_floats;          // kWgRows x kGeo
  float* E = geo + kWgRows * kGeo;                // rows / parking slices
  uint32_t* masks = reinterpret_cast<uint32_t*>(E + p.e_floats);
  float* st = reinterpret_cast<float*>(masks + p.n_mask * 4 * 128);  // mu, r in
  float* dgeo = st + 2 * kWgRows;                 // kWgRows x 9
  // key: the softmax backward's max, sum and inner product (rows of kWgRows)
  float* rowk = dgeo + kWgRows * kNGeoSrc;
  float* r1 = rowk + kWgRows * (kKey ? 3 : 0);    // draw / den
  float* r2 = r1 + kWgRows;                       // d influence (key)
  float* park = E;
  uint32_t* park_u = reinterpret_cast<uint32_t*>(E);
  float* prow =
      p.part + (size_t)(blockIdx.x * kBwdPartRows + 4 * wg + w) * p.part_w;
  float* enc_s = p.scratch + (size_t)(blockIdx.x * 2 + wg) * p.scr_wg;
  float* zs_s = enc_s + kWgRows * pd0;
  const float* lo_a = lns + 2 * pd0;
  const float* lo_b = lo_a + pdn;

  // The posenc segments of the lane's sources (for the per-source sums).
  int seg0[kSrcPerLane], seg1[kSrcPerLane];
#pragma unroll
  for (int j = 0; j < kSrcPerLane; ++j) {
    const int s = lane + 32 * j;
    seg0[j] = s < p.nsrc ? p.seg[s] : 0;
    seg1[j] = s < p.nsrc ? p.seg[p.nsrc + s] : 0;
  }
  // The form's registers: bf16, a pass's accumulator and the A fragments;
  // fp32, a whole layer's accumulator (A: the warp's rows of E).
  constexpr int kAcc = f32 ? kOutRegs : kAccRegs;
  std::conditional_t<f32, WgRowsA, uint32_t[kARegs]> A;
  float acc[kAcc];
  if constexpr (f32) {
    A = WgRowsA{E, row0};
  } else {
#pragma unroll
    for (int i = 0; i < kARegs; ++i) A[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float mo[2] = {0.f, 0.f}, ro[2] = {1.f, 1.f};

  for (int u = u_begin; u < u_end;) {
    const int tile = u / K, k0 = u - tile * K;
    const int k1 = k0 + (u_end - u < K - k0 ? u_end - u : K - k0);
    u += k1 - k0;
    const int rbase = tile * kWgTile + wg * kWgRows;
    float* dqq_o = k0 ? p.dqq_aux : p.dqq;
    float* drayo_o = k0 ? p.drayo_aux : p.drayo;
    float* drays_o = k0 ? p.drays_aux : p.drays;

    // Per ray: the softmax backward (key) or the safe denominator (value).
    for (int r = row0; r < row0 + 16; ++r) {
      const int t = rbase + r;
      if (kKey) {
        // The softmax backward's numbers of the ray; each (ray, k)'s ds is
        // formed from them when its k comes.
        float m = p.bkg, z = 1.f, inner = 0.f;
        if (t < T) {
          const float* drow = p.dattn + (size_t)t * (K + 1);
          const float* srow = p.ss + (size_t)t * K;
          for (int k = lane; k < K; k += 32) m = fmaxf(m, srow[k]);
          m = warp_max(m);
          float zs = 0.f, in = 0.f;
          for (int k = lane; k < K; k += 32) {
            const float e = expf(srow[k] - m);
            zs += e;
            in += e * drow[k];
          }
          const float eb = expf(p.bkg - m);
          z = warp_sum(zs) + eb;
          inner = (warp_sum(in) + eb * drow[K]) / z;
        }
        if (lane == 0) {
          rowk[r] = m;
          rowk[kWgRows + r] = z;
          rowk[2 * kWgRows + r] = inner;
        }
      } else {
        float sfg = 0.f;
        if (t < T)
          for (int k = lane; k < K; k += 32)
            sfg += p.attn[(size_t)t * (K + 1) + k];
        sfg = warp_sum(sfg);
        if (lane == 0) r1[r] = p.normalize && sfg > 0.f ? sfg : 1.f;
      }
    }
    __syncwarp();

    for (int k = k0; k < k1; ++k) {
      const size_t srow0 = (size_t)k * p.Tp + rbase;
      // --- geometry of the warp's rows (ops/geometry.py) ---
      if (lane < 16) {
        const int r = row0 + lane, t = rbase + r;
        const bool valid = t < T;
        const int gi = valid ? k * T + t : 0;
        const float* rw = p.rec + (size_t)gi * p.rec_w;
        float o[3], dr[3], v[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          o[j] = valid ? p.rayo[(size_t)t * 3 + j] : 0.f;
          dr[j] = valid ? p.rays[(size_t)t * 3 + j] : 0.f;
          v[j] = rw[j] - o[j];
        }
        const float t_al = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
        const float dd = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
        const float cc = t_al / (dd + p.eps);
        float* gr = geo + r * kGeo;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float proj = dr[j] * cc;
          gr[j] = rw[j];
          gr[3 + j] = proj;
          gr[6 + j] = v[j] - proj;
        }
        gr[9] = rw[3];
        gr[10] = rw[4];
        gr[11] = __int_as_float(gi);
        if (kKey) {
          const float raw = valid ? p.raw[(size_t)t * K + k] : 0.f;
          const float s = valid ? p.ss[(size_t)t * K + k] : kNegBig;
          const float ds =
              s > 0.5f * kNegBig
                  ? expf(s - rowk[r]) / rowk[kWgRows + r] *
                        (p.dattn[(size_t)t * (K + 1) + k] -
                         rowk[2 * kWgRows + r])
                  : 0.f;
          r2[r] = ds * (p.score_relu ? fmaxf(raw, 0.f) : raw);
          r1[r] = draw_of(ds, raw, rw[3], p.score_relu, p.sqrt_dm);
        }
      }
      __syncwarp();

      // --- the encoding: fp32 to the scratch, input LayerNorm, the layer-0
      // operand (bf16: rounded, the A fragments; fp32: E as it is) ---
      wgb_encode(E, ld, d, plan, row0, RecSrc{geo, p.rec, p.rec_w});
      __syncwarp();
      for (int r = row0; r < row0 + 16; ++r)
        for (int c = lane; c < pd0; c += 32) enc_s[r * pd0 + c] = E[r * ld + c];
      wgb_rows_in_st<Op>(E, ld, d, lns, st, row0);
      if constexpr (f32) {
        stash_rows_f32(E, p.hs[0], srow0, pd0, row0);
      } else {
        stash_rows(E, ld, p.hs[0], srow0, pd0, row0);
        smem_to_a(reinterpret_cast<const unsigned char*>(E + row0 * ld),
                  4 * ld, pd0, A);
        // Every warp has read its rows before any thread parks over them.
        named_sync(2 + wg, 128);
      }

      // --- forward recompute: stash, relu masks; the last layer's fp32
      // output in acc (and, for a 256-wide layer, its first pass parked) ---
      const bool two = wgb_fwd(acc, A, rg, zero, d, p.layers, p.hs, srow0,
                               masks, park, zs_s);
      if (d.has_lo)
        acc_layernorm_st(acc, two ? park : nullptr, d.d_out, lo_a, lo_b, mo, ro);

      if constexpr (kKey && f32) {
        // --- the score head as below, fp32: y and dkk through E to the
        // stash and the products, the bias added unrounded ---
        wg_rows_out(acc, E, row0);
        stash_rows_f32(E, p.hs[n], srow0, pdn, row0);
        wg_gemm_f32(acc, E, row0, rg, p.layers[n]);
#pragma unroll
        for (int i0 = 0; i0 < kAcc; i0 += 16) {
          float qv[16], dv[16];
#pragma unroll
          for (int ii = 0; ii < 16; ++ii) {
            const int i = i0 + ii, t = rbase + rl[(i >> 1) & 1];
            const int c = 8 * (i >> 2) + 2 * q + (i & 1);
            const bool in = t < T && c < p.dm;
            qv[ii] = in ? p.qq[(size_t)t * p.dm + c] : 0.f;
            dv[ii] = in ? dqq_o[(size_t)t * p.dm + c] : 0.f;
          }
#pragma unroll
          for (int ii = 0; ii < 16; ++ii) {
            const int i = i0 + ii, r = rl[(i >> 1) & 1], t = rbase + r;
            const int c = 8 * (i >> 2) + 2 * q + (i & 1);
            const bool in = t < T && c < p.dm;
            if (in)
              dqq_o[(size_t)t * p.dm + c] =
                  dv[ii] + r1[r] * linear_c<float>(acc[i], bks[c]);
            acc[i] = in ? r1[r] * qv[ii] : 0.f;
          }
        }
        colsum_layer([&](int i) { return acc[i]; }, prow + p.dbk_off,
                     p.dm_pad);
        wg_rows_out(acc, E, row0);
        stash_rows_f32(E, p.dz[n], srow0, p.dm_pad, row0);
        wg_gemm_f32(acc, E, row0, rg, p.layers[n + 1]);
      } else if constexpr (kKey) {
        // --- the score head: kk = y w_k + b_k, dqq += draw kk, dkk = draw
        // qq (db_k its column sums, dz of the head), then dkk w_k^T ---
        if (two) {
          acc_to_a<32>(acc, A);
#pragma unroll
          for (int i = 0; i < kAccRegs / 2; ++i)
            A[i] = pack_bf16(park[(2 * i) * 128 + t_in],
                             park[(2 * i + 1) * 128 + t_in]);
        } else {
          acc_to_a<0>(acc, A);
        }
        stash_a(A, p.hs[n], srow0, pdn);
        const WgLayer& H = p.layers[n];
        const int hpn = H.ni > kPassN ? 2 : 1;
        for (int hp = 0; hp < hpn; ++hp) {
          wgb_pass(acc, A, rg, H, zero);
          // 16 registers at a time: their qq and dqq are loaded before any
          // dqq is written back.
#pragma unroll
          for (int i0 = 0; i0 < kAccRegs; i0 += 16) {
            float qv[16], dv[16];
#pragma unroll
            for (int ii = 0; ii < 16; ++ii) {
              const int i = i0 + ii, t = rbase + rl[(i >> 1) & 1];
              const int c = kPassN * hp + 8 * (i >> 2) + 2 * q + (i & 1);
              const bool in = t < T && c < p.dm;
              qv[ii] = in ? p.qq[(size_t)t * p.dm + c] : 0.f;
              dv[ii] = in ? dqq_o[(size_t)t * p.dm + c] : 0.f;
            }
#pragma unroll
            for (int ii = 0; ii < 16; ++ii) {
              const int i = i0 + ii, r = rl[(i >> 1) & 1], t = rbase + r;
              const int c = kPassN * hp + 8 * (i >> 2) + 2 * q + (i & 1);
              const bool in = t < T && c < p.dm;
              if (in)
                dqq_o[(size_t)t * p.dm + c] =
                    dv[ii] + r1[r] * linear_bf16(acc[i], bks[c]);
              acc[i] = in ? r1[r] * qv[ii] : 0.f;
            }
          }
          colsum_pass([&](int i) { return acc[i]; },
                      prow + p.dbk_off + kPassN * hp, p.dm_pad - kPassN * hp);
          uint32_t w[32];
          round_pass(acc, w);
          stash_w(w, p.dz[n], srow0, p.dm_pad, kPassN * hp);
          place_words(w, A, park_u, hp + 1 < hpn ? 2 : hp);
        }
        if (hpn == 2) unpark_bf16(park_u, A);
        const WgLayer& HB = p.layers[n + 1];
        for (int bp = 0; bp < (two ? 2 : 1); ++bp) {
          wgb_pass(acc, A, rg, HB, zero);
          if (two && bp == 0) park_f32(acc, park);
        }
      } else {
        // --- the fuse step: datt_k = y . dfused (y rounded to bf16 in the
        // bf16 form), then the gradient of y, (attn_k / den) dfused ---
        const int cout = d.d_out;
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int h = (i >> 1) & 1, t = rbase + rl[h];
          const int c = 8 * (i >> 2) + 2 * q + (i & 1);
          float gv = 0.f;
          if (t < T && c < cout) {
            const float df = p.dfused[(size_t)t * cout + c];
            s[h] += act_round<Op>(acc[i]) * df;
            gv = p.attn[(size_t)t * (K + 1) + k] / r1[rl[h]] * df;
          }
          acc[i] = gv;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = quad_sum(s[h]);
          if (q == 0 && rbase + rl[h] < T)
            p.datt[(size_t)(rbase + rl[h]) * K + k] = v;
        }
      }
      if (d.has_lo)
        acc_ln_bwd(acc, two ? park : nullptr, zs_s, mo, ro, d.d_out, lo_a,
                   prow + L + 2 * pd0, prow + L + 2 * pd0 + pdn);

      // --- the reverse walk; layer 0's product is the encoding's gradient,
      // fp32 into the warp's rows of E ---
      wgb_rev(acc, A, rg, zero, d, p.layers + n + (kKey ? 2 : 0), p.dz,
              p.b_off, prow, srow0, masks, park, two, E, ld);
      __syncwarp();

      // --- per warp: input LayerNorm backward, posenc derivative, source
      // sums, geometry backward ---
      wgb_in_bwd(E, ld, d, enc_s, st, lns, plan, prow, L, row0, seg0, seg1,
                 p.nsrc, [&](int r, int src, float v) {
                   if (src < kNGeoSrc) {
                     dgeo[r * kNGeoSrc + src] = v;
                   } else if (rbase + r < T) {
                     const int gi = __float_as_int(geo[r * kGeo + 11]);
                     p.drec[(size_t)gi * p.rec_w + 5 + (src - kNGeoSrc)] = v;
                   }
                 });
      if (lane < 16 && rbase + row0 + lane < T) {
        const int r = row0 + lane, t = rbase + r;
        const int gi = __float_as_int(geo[r * kGeo + 11]);
        float o[3], dr[3], dsel[3], dry[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          o[j] = p.rayo[(size_t)t * 3 + j];
          dr[j] = p.rays[(size_t)t * 3 + j];
        }
        float* drow = p.drec + (size_t)gi * p.rec_w;
        // Sources 0..2 (the position feature) are dropped: detached.
        geom_bwd_row(p.rec + (size_t)gi * p.rec_w, o, dr,
                     dgeo + r * kNGeoSrc + 3, dgeo + r * kNGeoSrc + 6, p.eps,
                     dsel, dry);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          drow[j] = dsel[j];
          drayo_o[(size_t)t * 3 + j] -= dsel[j];
          drays_o[(size_t)t * 3 + j] += dry[j];
        }
        if (kKey) drow[3] = r2[r];
      }
      __syncwarp();
    }
  }
}

}  // namespace papr
