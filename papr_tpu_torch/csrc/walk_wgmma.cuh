// The walk on wgmma (Hopper), the bf16 forward walk of four kernels: the
// one-shot eval attention (attend_eval.cu attend_eval_wgmma_kernel), the
// record-native training stream forwards (key_stream.cu
// key_fwd_wgmma_kernel, value_stream.cu value_fwd_wgmma_kernel), which run
// the same code below from the geometry rows to the walks' outputs, and the
// fused embedder forward (fused_mlp.cu fused_mlp_fwd_wgmma_kernel), whose
// posenc sources are raw feature rows; the bf16 stream and embedder
// backwards build on its ring and layers (walk_wgmma_bwd.cuh). The fp32
// one-shot eval attention and the fp32 stream forwards
// (key_fwd_wgmma_f32_kernel, value_fwd_wgmma_f32_kernel: the same function
// as the bf16 ones) run the same walk in its fp32 operand form (below: fp32
// activations, 3xTF32 products), and so do the fp32 stream backwards
// (walk_wgmma_bwd.cuh), the fp32 embedder forward
// (fused_mlp_fwd_wgmma_f32_kernel, the bf16 embedder's function) and its
// backward (both in embed_wgmma.cuh), the fp32 folded key stream
// (key_stream_q.cu: the embedder's walk with w_q as a head,
// query_head_fwd_wgmma_f32_kernel / query_head_bwd_wgmma_f32_kernel, then
// key_stream.cu's fp32 kernels), and the fp32 feature stream forwards
// (key_stream_feat.cu key_feat_fwd_wgmma_f32_kernel, value_stream_feat.cu
// value_feat_fwd_wgmma_f32_kernel: the stream forwards' function with raw
// (K, T, d) feature rows as the posenc sources, FeatTok). The int8 one-shot
// eval attention (attend_eval_i8_wgmma_kernel, both epilogues) runs the same
// walk in its int8 operand form (below: s8 x s8 -> s32 products, the
// epilogue quantizing straight into the next product's fragments). The int8
// stream forwards (rows 5q / 6q, 5qf / 6qf), the int8 walk microbenchmark
// and the other walk kernels (the bf16 forms of key_stream_q.cu, the bf16
// forms and the backwards of key_stream_feat.cu / value_stream_feat.cu) keep
// walk.cuh's WMMA layers.
//
// A block is two warpgroups, each owning 64 token rows (256 threads, so
// ptxas may give a thread up to 255 registers). Within a warpgroup the
// activations stay in registers between layers: a layer's product
// accumulates in an m64n128 fp32 accumulator (wgmma, 64 registers a
// thread; a 256-wide layer takes two passes over the same A), its epilogue
// (bias, activation, LayerNorm as a row reduction over the four threads of
// a quad) runs on that accumulator, and the result is rounded to bf16
// straight into the A fragments of the next product (the accumulator's
// layout is the A operand's: FlashAttention-3's trick), which wgmma reads
// from registers. Between the two passes of a 256-wide layer the first
// half's output waits in a per-thread slice of shared memory (bf16, or fp32
// when a LayerNorm needs the whole row). Only the weights are staged: a ring
// of 64-row chunks, packed on the host into wgmma's K-major 128-byte-
// swizzled image (ops/fused_mlp.py pack_walk_wgmma), each landed by one TMA
// bulk copy on its slot's mbarrier. Both warpgroups read every chunk, so
// each staged byte serves 128 tokens; whichever warpgroup releases a slot
// second (a shared-memory counter) issues the copy of the chunk that goes
// there next, so no thread waits to produce.
//
// Accumulator layout (m64nN, thread t of a warpgroup, warp w = t / 32, lane
// l, g = l / 4, q = l % 4): acc[4 j + 2 h + e] holds row 16 w + g + 8 h,
// column 8 j + 2 q + e of the pass. A fragment kb (columns 16 kb .. +15):
// A[4 kb + i] = bf16x2 of acc[8 kb + 2 i], acc[8 kb + 2 i + 1], so a pass's
// 128 columns fill A[0..31] (or A[32..63] for the second pass).

#pragma once

#include "hopper.cuh"
#include "rec_stream.cuh"
#include "stream_common.cuh"

namespace papr {

constexpr int kWgRows = 64;                    // token rows per consumer
constexpr int kWgThreads = 256;                // two warpgroups
constexpr int kWgTile = 2 * kWgRows;           // token rows per block
constexpr int kWChunkRows = 64;                // weight rows (K) per chunk
constexpr int kPassN = 128;                    // product width of a pass
                                               // (wgmma_rs_bf16_n128)
constexpr int kWStageBytes = kPassN * 128;     // one pass's chunk, K-major
constexpr int kWgMaxLayers = 2 * kMaxLayers + 1;
constexpr int kWgMaxChunks = kWgMaxLayers * 2 * (kMaxWidth / 64);
constexpr int kAccRegs = kPassN / 2;           // m64n128: 64 a thread
constexpr int kARegs = kMaxWidth / 4;          // 16 fragments x 4
constexpr int kParkWords = 64;                 // per thread, between passes

// The packed width of a layer's chunks: the narrowest of 32 / 64 / 128 / 256
// that holds pd_out (zero beyond pd_out), so a narrow layer streams fewer
// bytes; its products are still 128 wide (or two passes of 128 at 256).
__host__ __device__ inline int wg_tile_n(int pd_out) {
  return pd_out <= 32 ? 32 : pd_out <= 64 ? 64 : pd_out <= 128 ? 128 : 256;
}

// One layer's packed weights: ceil(pd_in / 64) chunks of ni x 128 bytes at
// byte offset off (a 256-wide layer's second pass reads rows 128.. of each;
// an int8 layer's chunks are 128 deep).
struct WgLayer {
  int off, pd_in, pd_out, ni;
};

// Host side: the layer table of (pd_in, pd_out) pairs in the order the
// packed buffer holds them, chunks depth rows deep; returns the buffer's
// size in bytes.
inline long long wg_plan(WgLayer* l, const int (*dims)[2], int n,
                         int depth = kWChunkRows) {
  long long off = 0;
  for (int i = 0; i < n; ++i) {
    l[i].off = (int)off;
    l[i].pd_in = dims[i][0];
    l[i].pd_out = dims[i][1];
    l[i].ni = wg_tile_n(dims[i][1]);
    off += (long long)((dims[i][0] + depth - 1) / depth) * l[i].ni * 128;
  }
  return off;
}

// One staged chunk of the per-k stream: its byte offset in the packed
// weights and its size.
struct WgChunk {
  int off, bytes;
};

// The weight ring as one warpgroup sees it: slot s of `stages` at
// base + s * kWStageBytes; chunk i of the stream (per_k chunks a k step,
// total in all) sits in slot i % stages.
struct WgRing {
  unsigned char* base;
  uint64_t* full;                // one per slot: the chunk has landed
  int* released;                 // one per slot: warpgroups done with it
  int stages;
  int i;                         // chunks consumed so far
  int per_k, total;
  const WgChunk* table;          // the per-k stream
  const unsigned char* w;        // the packed weights
};

// Copy chunk j of the stream into its slot.
__device__ __forceinline__ void wg_issue(const WgRing& ring, int j) {
  const WgChunk c = ring.table[j % ring.per_k];
  const int st = j % ring.stages;
  mbar_expect_tx(&ring.full[st], c.bytes);
  bulk_load(ring.base + st * kWStageBytes, ring.w + c.off, c.bytes,
            &ring.full[st]);
}

// The calling warpgroup is done with chunk j (its products completed): the
// second warpgroup to say so refills the slot with chunk j + stages.
__device__ __forceinline__ void wg_release(const WgRing& ring, int j) {
  if ((threadIdx.x & 127) != 0) return;
  const int st = j % ring.stages;
  if (atomicAdd(&ring.released[st], 1) == 1) {
    ring.released[st] = 0;
    fence_async_smem();
    if (j + ring.stages < ring.total) wg_issue(ring, j + ring.stages);
  }
}

// acc[:, :128] = A[:, :64 nch] @ W for one pass: the pass's nch chunks in
// order from the ring, four m64n128k16 products each, one chunk's products
// in flight while the next is issued; each chunk goes back to the ring
// once its products are done. The code is the same for every layer (wgmma
// in a branch is serialized): always four chunks, those past nch read the
// zero block with zero A fragments, and a narrower layer's chunk leaves
// stale rows past its width in the stage, whose columns the epilogues never
// read.
__device__ __forceinline__ void wg_gemm(float (&acc)[kAccRegs],
                                        uint32_t (&A)[kARegs], WgRing& ring,
                                        int nch, const unsigned char* zero) {
  reg_fence(A);
  reg_fence(acc);
#pragma unroll
  for (int c = 0; c < kMaxWidth / kWChunkRows; ++c) {
    const bool real = c < nch;
    const int st = ring.i % ring.stages;
    if (real) mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);
    // One descriptor a chunk; k16 step kk starts 32 bytes further (the
    // address field counts 16-byte units).
    const uint64_t desc = sw128_desc(
        real ? ring.base + st * kWStageBytes : zero, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kb = 4 * c + kk;
      wgmma_rs_bf16_n128(acc, A[4 * kb], A[4 * kb + 1], A[4 * kb + 2],
                         A[4 * kb + 3], desc + 2 * kk, kb > 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      if (c - 1 < nch) wg_release(ring, ring.i - 1);
    }
    if (real) ++ring.i;
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(A);
  if (nch == kMaxWidth / kWChunkRows) wg_release(ring, ring.i - 1);
}

// One pass of layer l (columns 128 p .. of a 256-wide layer, or all).
__device__ __forceinline__ void wg_pass(float (&acc)[kAccRegs],
                                        uint32_t (&A)[kARegs], WgRing& ring,
                                        const WgLayer& l,
                                        const unsigned char* zero) {
  wg_gemm(acc, A, ring, (l.pd_in + kWChunkRows - 1) / kWChunkRows, zero);
}

// acc + bias, then the activation, on the pass's columns < pd (pd relative
// to the pass); columns >= pd become 0. N: the accumulator's registers (a
// bf16 pass's 64, or the fp32 form's whole 256-wide layer, 128).
template <int N>
__device__ __forceinline__ void acc_bias_act(float (&acc)[N],
                                             const float* bias, int pd,
                                             int act) {
  const int q = threadIdx.x & 3;
  const bool full = pd >= 2 * N;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = 8 * j + 2 * q;
    const bool in = full || c < pd;
    const float2 b = in ? *reinterpret_cast<const float2*>(bias + c)
                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h] + b.x;
      float v1 = acc[4 * j + 2 * h + 1] + b.y;
      if (act == 1) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      acc[4 * j + 2 * h] = in ? v0 : 0.f;
      acc[4 * j + 2 * h + 1] = in ? v1 : 0.f;
    }
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A pass's 128 columns rounded to bf16 into A[A0 .. A0 + 31].
template <int A0>
__device__ __forceinline__ void acc_to_a(const float (&acc)[kAccRegs],
                                         uint32_t (&A)[kARegs]) {
#pragma unroll
  for (int i = 0; i < kAccRegs / 2; ++i)
    A[A0 + i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// The per-thread parking slice (word i of thread t at park[i * 128 + t]:
// conflict-free) that holds a first pass between the two passes.
__device__ __forceinline__ void park_bf16(const float (&acc)[kAccRegs],
                                          uint32_t* park) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < kAccRegs / 2; ++i)
    park[i * 128 + t] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}
__device__ __forceinline__ void unpark_bf16(const uint32_t* park,
                                            uint32_t (&A)[kARegs]) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < kAccRegs / 2; ++i) A[i] = park[i * 128 + t];
}
__device__ __forceinline__ void park_f32(const float (&acc)[kAccRegs],
                                         float* park) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) park[i * 128 + t] = acc[i];
}

// The walk's LayerNorm (walk.cuh layernorm_rows) on the thread's two rows:
// fp32 statistics over the first n_true columns, unbiased std,
// 1 / (std + eps); columns >= n_true become 0. With park (bf16 form), the
// row's first 128 columns are the parked first pass (normalized in place
// there) and acc holds columns 128..; without, acc holds columns 0...
template <int N>
__device__ __forceinline__ void acc_layernorm(float (&acc)[N], float* park,
                                              int n_true, const float* a,
                                              const float* b) {
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
    const float mu = quad_sum(s) / (float)n_true;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park && c < n_true) {
          const float dv = park[i * 128 + t] - mu;
          v += dv * dv;
        }
        if (c1 + c < n_true) {
          const float dv = acc[i] - mu;
          v += dv * dv;
        }
      }
    const float var = quad_sum(v) / (float)(n_true > 1 ? n_true - 1 : 1);
    const float rr = 1.f / (sqrtf(var) + kLnEps);
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park) {
          float& x = park[i * 128 + t];
          x = c < n_true ? (x - mu) * rr * a[c] + b[c] : 0.f;
        }
        float& x = acc[i];
        x = c1 + c < n_true ? (x - mu) * rr * a[c1 + c] + b[c1 + c] : 0.f;
      }
  }
}

// A fragments of columns < pd from a warp's 16 rows of bf16 in shared memory
// (row r at rows + r * ld bytes); fragments past pd are zero.
__device__ __forceinline__ void smem_to_a(const unsigned char* rows, int ld,
                                          int pd, uint32_t (&A)[kARegs]) {
  const int l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const unsigned char* r0 = rows + g * ld + 4 * q;
  const unsigned char* r1 = r0 + 8 * ld;
#pragma unroll
  for (int kb = 0; kb < kARegs / 4; ++kb) {
    const bool in = 16 * kb < pd;
    A[4 * kb] = in ? *reinterpret_cast<const uint32_t*>(r0 + 32 * kb) : 0u;
    A[4 * kb + 1] = in ? *reinterpret_cast<const uint32_t*>(r1 + 32 * kb) : 0u;
    A[4 * kb + 2] =
        in ? *reinterpret_cast<const uint32_t*>(r0 + 32 * kb + 16) : 0u;
    A[4 * kb + 3] =
        in ? *reinterpret_cast<const uint32_t*>(r1 + 32 * kb + 16) : 0u;
  }
}

// Host side: the per-k chunk stream of layers [0, n) (chunks depth rows
// deep) in the order the warpgroups consume it (a 256-wide layer's second
// pass reads rows 128.. of each chunk); returns its length.
inline int wg_chunks(WgChunk* out, const WgLayer* layers, int n,
                     int depth = kWChunkRows) {
  int m = 0;
  for (int li = 0; li < n; ++li) {
    const WgLayer& l = layers[li];
    const int passes = l.ni > kPassN ? 2 : 1;
    const int bytes = (l.ni > kPassN ? kPassN : l.ni) * 128;
    const int nch = (l.pd_in + depth - 1) / depth;
    for (int p = 0; p < passes; ++p)
      for (int c = 0; c < nch; ++c, ++m)
        out[m] = {l.off + c * l.ni * 128 + p * kWStageBytes, bytes};
  }
  return m;
}

// ------------------------------------------- the bf16 forward kernels ----
//
// What K3 and the two stream forwards share; the embedder forward (K2,
// fused_mlp.cu) runs wg_walk on raw feature rows (its posenc sources a
// functor, RecSrc here) and writes its output with wg_store_rows. K3 and the
// streams differ only in where a token's record row comes from (K3:
// idx[t * K + k] of the (P, rp) record; the streams: k * T + t of the
// pre-gathered k-major (K, T, rp) record), a functor of the geometry, and in
// what they do with the walks' outputs.
// Per k step a warp owns 16 rays end to end: it writes their geometry and
// posenc to its rows of shared memory (lanes over columns, as encode_rec),
// takes the input LayerNorm there and rounds to bf16 in place, loads the A
// fragments, and from then on the layers, the output LayerNorm, the w_k
// product and the score run on the accumulator in registers; only warp
// barriers inside a warpgroup, and one per k step over the warpgroup (the
// parking slices overlap the encoding rows). The rounding points are the
// JAX kernels': activations bf16 between layers, fp32 bias, LayerNorm
// statistics in fp32 with the unbiased std, y_k rounded to bf16 before w_k,
// the value rows rounded before the fuse (by the caller).

constexpr int kMaxStages = 8;    // weight ring depth at most

// One walk as a kernel reads it: its descriptor (the kernel's parameters:
// the device offsets of its biases), its bias / LayerNorm / plan rows staged
// in shared memory, and its layers' entries in the kernel's layer table.
struct WgWalk {
  const WalkDesc* d;
  const float* bias;             // d->b[0] .. (every layer's, in order)
  const float* ln;               // d->ln
  const float* plan;             // d->plan
  const WgLayer* layers;         // d->n entries
  // The int8 form's rows (ops/fused_mlp.py pack_walk_q): each layer's
  // inverse input scales, back to back, and its dequantization scales at
  // its bias offsets.
  const float* inv;
  const float* dq;
};

// The block's shared memory: a zero chunk (the bf16 form's products past a
// layer's width read it; the fp32 form has none: zero null) and the weight
// ring (1024-byte aligned), tile_floats floats of per-warpgroup tiles,
// n_prm floats of parameter rows, then one mbarrier and one release counter
// a ring slot.
struct WgSmem {
  unsigned char* zero;
  unsigned char* ring;
  float* tiles;
  float* prm;
  uint64_t* full;
  int* released;
};

__device__ __forceinline__ WgSmem wg_smem(unsigned char* raw, int stages,
                                          int tile_floats, int n_prm,
                                          bool zero = true) {
  WgSmem s;
  unsigned char* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  s.zero = zero ? smem : nullptr;
  s.ring = smem + (zero ? kWStageBytes : 0);
  s.tiles = reinterpret_cast<float*>(s.ring + stages * kWStageBytes);
  s.prm = s.tiles + tile_floats;
  s.full = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(s.prm + n_prm) + 7) & ~uintptr_t(7));
  s.released = reinterpret_cast<int*>(s.full + stages);
  return s;
}

// Host side: the bytes of that layout besides the ring's slots.
inline size_t wg_smem_rest(int tile_floats, int n_prm, bool zero = true) {
  return 1024 + (zero ? kWStageBytes : 0) +
         sizeof(float) * ((size_t)tile_floats + n_prm) + 8 +
         kMaxStages * (sizeof(uint64_t) + sizeof(int));
}

// Host side: the ring depth that fills the H100's 232,448 bytes a block
// (at most kMaxStages) and the block's bytes; -203 if two slots do not fit.
inline int wg_ring_fit(size_t rest, int* stages, size_t* smem) {
  if (rest + 2 * (size_t)kWStageBytes > 232448) return -203;
  *stages = (int)((232448 - rest) / kWStageBytes);
  if (*stages > kMaxStages) *stages = kMaxStages;
  *smem = rest + (size_t)*stages * kWStageBytes;
  return 0;
}

// Host side: walk d's layers (pd[i] -> pd[i + 1]) appended to dims at *n.
inline void wg_walk_dims(int (*dims)[2], int* n, const WalkDesc& d) {
  for (int i = 0; i < d.n; ++i, ++*n) {
    dims[*n][0] = d.pd[i];
    dims[*n][1] = d.pd[i + 1];
  }
}

// Host side: the floats of walk d's staged rows (biases, LayerNorms, plan).
inline void wg_walk_rows(const WalkDesc& d, int* nb, int* nln, int* nplan) {
  int b = 0;
  for (int i = 1; i <= d.n; ++i) b += d.pd[i];
  *nb = b;
  *nln = 2 * d.pd[0] + 2 * d.pd[d.n];
  *nplan = 3 * d.pd[0];
}

// Host side: floats a row of the encoding tile (16-byte rows on distinct
// banks) and of the tile, which doubles as the parking slices.
inline int wg_ld(int pd0) { return (pd0 + 31) / 32 * 32 + 4; }
inline int wg_e_floats(int ld) {
  return kWgRows * ld > kParkWords * 128 ? kWgRows * ld : kParkWords * 128;
}

// The block's set-up: the n parameter arrays src[a] (cnt[a] floats each)
// copied into consecutive rows at s.prm, the zero chunk (if any), the
// ring's barriers and counters; ends on a barrier. Then wg_ring_start.
template <int N>
__device__ __forceinline__ void wg_prologue(const WgSmem& s, int stages,
                                            const float* const (&src)[N],
                                            const int (&cnt)[N]) {
  const int tid = threadIdx.x;
  float* dst = s.prm;
#pragma unroll
  for (int a = 0; a < N; ++a) {
    for (int i = tid; i < cnt[a]; i += kWgThreads) dst[i] = src[a][i];
    dst += cnt[a];
  }
  if (s.zero)
    for (int i = tid; i < kWStageBytes / 16; i += kWgThreads)
      reinterpret_cast<uint4*>(s.zero)[i] = make_uint4(0, 0, 0, 0);
  fence_async_smem();
  if (tid < stages) s.released[tid] = 0;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&s.full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// Thread 0 fills the ring's slots with the stream's first chunks.
__device__ __forceinline__ void wg_ring_start(const WgRing& rg) {
  if (threadIdx.x == 0)
    for (int j = 0; j < rg.stages && j < rg.total; ++j) wg_issue(rg, j);
}

// The geometry rows (ops/geometry.py point_ray_geometry) of the warp's 16
// rays rbase + row0 + r: sel, proj, perp, influence, alive, and the record
// row (int bits) of each ray's point, row_of(t) for a ray t < T (an overhang
// ray reads row 0 with a zero ray: finite values). Ends on a warp barrier.
template <class RowOf>
__device__ __forceinline__ void wg_geometry(float* geo,
                                            const float* __restrict__ record,
                                            int rec_w,
                                            const float* __restrict__ rayo,
                                            const float* __restrict__ rays,
                                            int T, int rbase, int row0,
                                            float eps, RowOf row_of) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) {
    const int r = row0 + lane, t = rbase + r;
    const bool valid = t < T;
    const int gi = valid ? row_of(t) : 0;
    const float* rec = record + (size_t)gi * rec_w;
    float o[3], dr[3], v[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[j] = valid ? rayo[(size_t)t * 3 + j] : 0.f;
      dr[j] = valid ? rays[(size_t)t * 3 + j] : 0.f;
      v[j] = rec[j] - o[j];
    }
    const float t_al = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
    const float dd = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
    const float cc = t_al / (dd + eps);
    float* gr = geo + r * kGeo;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float proj = dr[j] * cc;
      gr[j] = rec[j];
      gr[3 + j] = proj;
      gr[6 + j] = v[j] - proj;
    }
    gr[9] = rec[3];
    gr[10] = rec[4];
    gr[11] = __int_as_float(gi);
  }
  __syncwarp();
}

// The record walks' posenc sources (K3, the stream forwards and backwards):
// row r's geometry values (sources < kNGeoSrc), then its record row's point
// features.
struct RecSrc {
  const float* geo;
  const float* __restrict__ record;
  int rec_w;
  __device__ __forceinline__ float operator()(int r, int src) const {
    const float* gr = geo + r * kGeo;
    return src < kNGeoSrc
        ? gr[src]
        : record[(size_t)__float_as_int(gr[11]) * rec_w + 5 + (src - kNGeoSrc)];
  }
};

// The feature walks' posenc sources (the fp32 feature stream forwards): row
// r's column src of its token's raw feature row, x[k, rbase + r, :] of the
// k-major (K, T, d_raw) features (xk [pos, proj, perp], xv [proj, perp,
// point features?]: the plan's source ids are x's columns, as for K2's raw
// rows), read in place by scalar loads (rows of 9 or 70 floats are not
// 16-byte aligned); an overhang ray reads 0.
struct FeatSrc {
  const float* __restrict__ xk;        // x + k * T * d_raw
  int d_raw, T, rbase;
  __device__ __forceinline__ float operator()(int r, int src) const {
    const int t = rbase + r;
    return t < T ? xk[(size_t)t * d_raw + src] : 0.f;
  }
};

// The warp's 16 rows of one walk's posenc into E (fp32, ld floats a row),
// lanes over columns; pad lanes 0. src_val(r, src): row r's source value
// (RecSrc, FeatSrc, or the embedder's raw feature row).
template <class Src>
__device__ __forceinline__ void wg_encode(float* E, int ld, const WalkDesc& d,
                                          const float* plan, int row0,
                                          const Src& src_val) {
  const int lane = threadIdx.x & 31, pd0 = d.pd[0];
  for (int c = lane; c < pd0; c += 32) {
    const bool live = c < d.d_enc;
    const int src = live ? (int)plan[c] : 0;
    const float freq = live ? plan[pd0 + c] : 0.f;
    const int kind = live ? (int)plan[2 * pd0 + c] : 0;
    for (int r = row0; r < row0 + 16; ++r) {
      float v = 0.f;
      if (live) {
        const float x = src_val(r, src);
        v = encode_value(x, freq, kind);
      }
      E[r * ld + c] = v;
    }
  }
}

// The warp's 16 encoded rows through the input LayerNorm (or as they are)
// and, in the bf16 form (Op), rounded to bf16 in place: row r's bf16 values
// at the start of its fp32 row; the fp32 form keeps them fp32.
template <class Op>
__device__ __forceinline__ void wg_rows_in(float* E, int ld,
                                           const WalkDesc& d, const float* ln,
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

// The bf16 form's A fragments of the warp's encoded rows.
__device__ __forceinline__ void wg_load_a(const float* E, int ld,
                                          const WalkDesc& d, int row0,
                                          uint32_t (&A)[kARegs]) {
  smem_to_a(reinterpret_cast<const unsigned char*>(E + row0 * ld), 4 * ld,
            d.pd[0], A);
}

// One dense layer of a walk, A -> A: bias, activation, then (ln_a) the
// walk's output LayerNorm over n_true columns; a 256-wide layer in two
// passes, the first one's output parked meanwhile (bf16, or fp32 for the
// LayerNorm).
__device__ __forceinline__ void wg_dense(float (&acc)[kAccRegs],
                                         uint32_t (&A)[kARegs], WgRing& rg,
                                         const unsigned char* zero,
                                         float* park, const WgLayer& L,
                                         const float* bias, int act,
                                         const float* ln_a,
                                         const float* ln_b, int n_true) {
  if (L.ni <= kPassN) {
    wg_pass(acc, A, rg, L, zero);
    acc_bias_act(acc, bias, L.pd_out, act);
    if (ln_a) acc_layernorm(acc, nullptr, n_true, ln_a, ln_b);
    acc_to_a<0>(acc, A);
    return;
  }
  wg_pass(acc, A, rg, L, zero);
  acc_bias_act(acc, bias, kPassN, act);
  if (ln_a) park_f32(acc, park);
  else park_bf16(acc, reinterpret_cast<uint32_t*>(park));
  wg_pass(acc, A, rg, L, zero);
  acc_bias_act(acc, bias + kPassN, L.pd_out - kPassN, act);
  if (ln_a) {
    acc_layernorm(acc, park, n_true, ln_a, ln_b);
    acc_to_a<32>(acc, A);
    const int t = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < kAccRegs / 2; ++i)
      A[i] = pack_bf16(park[(2 * i) * 128 + t], park[(2 * i + 1) * 128 + t]);
  } else {
    acc_to_a<32>(acc, A);
    unpark_bf16(reinterpret_cast<const uint32_t*>(park), A);
  }
}

// ------------------------------------------------ the fp32 operand form --
//
// The same walk with fp32 activations and 3xTF32 products (use_amp: false;
// attend_eval.cu's fp32 kernel). A 256-wide fp32 activation is 128
// registers a thread, so a layer's input stays in the warpgroup's rows of
// shared memory (E, kF32Ld floats a row; each warp reads and writes only
// its own 16 rows) and only its output lives in registers: acc[4 j + 2 h +
// e] holds row 16 w + g + 8 h, column 8 j + 2 q + e of the whole layer (the
// bf16 pass layout over 256 columns). A layer runs as four 64-wide passes
// (m64n64k8), each over the input's 32-deep chunks; per chunk the thread
// loads its A fragments from E, splits each value into hi = tf32(x), lo =
// tf32(x - hi) (cvt.rna, as walk.cuh's split_tf32), and issues lo.hi,
// hi.lo, hi.hi for each k8 step into a fresh m64n64 accumulator, which
// joins acc by adds that round to nearest (the tensor cores' accumulator
// rounds toward zero; wgrad.cu's fp32 form joins each stage the same way).
// A (pass, chunk) of the weights is one 16 KB stage: 64 output rows of 32
// tf32 along K (K-major, 128-byte swizzle), hi then lo, in the order the
// walk consumes them (ops/fused_mlp.py pack_walk_wgmma_f32), so the ring's
// chunk table is every stage in turn (wg_chunks_f32). A tf32 A fragment
// holds columns q and q + 4 of each k8 group where the accumulator holds
// 2 q and 2 q + 1: the packer permutes each 8-row K group of the weights
// so that k = q reads input column 2 q and k = q + 4 reads 2 q + 1, so a
// thread reads its fragment as one float2 a row and writes its output the
// same way (no shuffles; kF32Ld = 8 mod 32 keeps both free of bank
// conflicts). Passes past a layer's width run no chunk (ptxas keeps the
// products asynchronous: each chunk's end waits for them). After the last
// product the epilogue (bias, activation, LayerNorm) runs on acc and,
// unless the caller reads the rows, they go back to E in place.

constexpr int kOutRegs = kMaxWidth / 2;        // a 256-wide layer, fp32
constexpr int kF32Ld = kMaxWidth + 8;          // floats a row of E
constexpr int kF32PassN = 64;                  // m64n64k8
constexpr int kF32ChunkK = 32;                 // K rows a stage (128 bytes)
constexpr int kF32Sub = 4;                     // k8 steps a fresh accumulator
static_assert(2 * kF32PassN * kF32ChunkK * 4 == kWStageBytes,
              "an fp32 stage is one pass's hi and lo chunk");

// The A operand of the fp32 form: the warp's rows row0 .. row0 + 15 of E.
struct WgRowsA {
  float* E;
  int row0;
};

// The operand type of a form, from its A operand.
template <class AOp>
struct WgForm {
  using Op = __nv_bfloat16;
};
template <>
struct WgForm<WgRowsA> {
  using Op = float;
};

// Host side: the fp32 image's layer table (dims as wg_plan); returns its
// size in bytes: per layer ceil(pd_out / 64) passes of ceil(pd_in / 32)
// stages.
inline long long wg_plan_f32(WgLayer* l, const int (*dims)[2], int n) {
  long long off = 0;
  for (int i = 0; i < n; ++i) {
    l[i].off = (int)off;
    l[i].pd_in = dims[i][0];
    l[i].pd_out = dims[i][1];
    l[i].ni = (dims[i][1] + kF32PassN - 1) / kF32PassN * kF32PassN;
    off += (long long)((dims[i][0] + kF32ChunkK - 1) / kF32ChunkK) *
           (l[i].ni / kF32PassN) * kWStageBytes;
  }
  return off;
}

// The longest per-k stream of the fp32 image: every layer 256 wide.
constexpr int kWgMaxChunksF32 =
    kWgMaxLayers * (kMaxWidth / kF32ChunkK) * (kMaxWidth / kF32PassN);
static_assert(kWgMaxChunksF32 >= kWgMaxChunks, "");

// Host side: the fp32 image's per-k chunk stream (bytes of it from byte off,
// from wg_plan_f32): every stage full, in the order the walk consumes them;
// returns its length.
inline int wg_chunks_f32(WgChunk* out, long long bytes, int off = 0) {
  const int m = (int)(bytes / kWStageBytes);
  for (int i = 0; i < m; ++i) out[i] = {off + i * kWStageBytes, kWStageBytes};
  return m;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// acc (every output column of layer L, before its bias) = the warp's rows
// of E x W, as above. Each stage goes back to the ring once its products
// are done.
__device__ __forceinline__ void wg_gemm_f32(float (&acc)[kOutRegs],
                                            const float* E, int row0,
                                            WgRing& ring, const WgLayer& L) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* r0 = E + (row0 + g) * kF32Ld + 2 * q;
  const float* r1 = r0 + 8 * kF32Ld;
  const int nch = (L.pd_in + kF32ChunkK - 1) / kF32ChunkK;
  const int np = L.ni / kF32PassN;
  float f[kF32PassN / 2];
#pragma unroll
  for (int i = 0; i < kF32PassN / 2; ++i) f[i] = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxWidth / kF32PassN; ++p) {
#pragma unroll
    for (int i = 0; i < kF32PassN / 2; ++i) acc[32 * p + i] = 0.f;
    for (int c = 0; c < (p < np ? nch : 0); ++c) {
      const int st = ring.i % ring.stages;
      const unsigned char* hi = ring.base + st * kWStageBytes;
      const uint64_t dh = sw128_desc(hi, 16, 1024);
      const uint64_t dl = sw128_desc(hi + kWStageBytes / 2, 16, 1024);
#pragma unroll
      for (int sub = 0; sub < kF32ChunkK / 8 / kF32Sub; ++sub) {
        // Rows g and g + 8, k8 steps sub * kF32Sub .. of chunk c.
        uint32_t ah[kF32Sub][4], al[kF32Sub][4];
#pragma unroll
        for (int s = 0; s < kF32Sub; ++s) {
          const int k = c * kF32ChunkK + 8 * (sub * kF32Sub + s);
          const float2 x0 = *reinterpret_cast<const float2*>(r0 + k);
          const float2 x1 = *reinterpret_cast<const float2*>(r1 + k);
          split_tf32(x0.x, ah[s][0], al[s][0]);
          split_tf32(x1.x, ah[s][1], al[s][1]);
          split_tf32(x0.y, ah[s][2], al[s][2]);
          split_tf32(x1.y, ah[s][3], al[s][3]);
        }
        if (sub == 0)
          mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);
        reg_fence(f);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kF32Sub; ++s) {
          const int kk = 2 * (sub * kF32Sub + s);     // 32 bytes a k8 step
          wgmma_rs_tf32_n64(f, al[s][0], al[s][1], al[s][2], al[s][3],
                            dh + kk, s > 0);
          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],
                            dl + kk, 1);
          wgmma_rs_tf32_n64(f, ah[s][0], ah[s][1], ah[s][2], ah[s][3],
                            dh + kk, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(f);
#pragma unroll
        for (int i = 0; i < kF32PassN / 2; ++i)
          acc[32 * p + i] = __fadd_rn(acc[32 * p + i], f[i]);
      }
      wg_release(ring, ring.i);
      ++ring.i;
    }
  }
}

// The fp32 form's rows of acc back into the warp's rows of E (the next
// product's A).
__device__ __forceinline__ void wg_rows_out(const float (&acc)[kOutRegs],
                                            float* E, int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* r0 = E + (row0 + g) * kF32Ld + 2 * q;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kOutRegs / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(r0 + 8 * h * kF32Ld + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  __syncwarp();
}

// The fp32 form needs no A fragments: the products read E.
__device__ __forceinline__ void wg_load_a(const float*, int, const WalkDesc&,
                                          int, WgRowsA&) {}

// One dense layer of the fp32 form, E -> E: products, bias, activation,
// then (ln_a) the output LayerNorm over n_true columns.
__device__ __forceinline__ void wg_dense(float (&acc)[kOutRegs], WgRowsA& A,
                                         WgRing& rg,
                                         const unsigned char*, float*,
                                         const WgLayer& L, const float* bias,
                                         int act, const float* ln_a,
                                         const float* ln_b, int n_true) {
  wg_gemm_f32(acc, A.E, A.row0, rg, L);
  acc_bias_act(acc, bias, L.pd_out, act);
  if (ln_a) acc_layernorm(acc, nullptr, n_true, ln_a, ln_b);
  wg_rows_out(acc, A.E, A.row0);
}

// The fp32 form's last layer whose rows the caller reads: all of them left
// in acc (returns false).
__device__ __forceinline__ bool wg_dense_rows(float (&acc)[kOutRegs],
                                              WgRowsA& A, WgRing& rg,
                                              const unsigned char*,
                                              float*, const WgLayer& L,
                                              const float* bias, int act,
                                              const float* ln_a,
                                              const float* ln_b, int n_true) {
  wg_gemm_f32(acc, A.E, A.row0, rg, L);
  acc_bias_act(acc, bias, L.pd_out, act);
  if (ln_a) acc_layernorm(acc, nullptr, n_true, ln_a, ln_b);
  return false;
}

// The last layer of a walk whose fp32 output the caller reads (the value
// rows, K2's rows): columns 0..127 left in acc, or, for a 256-wide layer
// (returns true), columns 128.. in acc and 0..127 parked fp32 at E; the
// output LayerNorm taken when ln_a is given.
__device__ __forceinline__ bool wg_dense_rows(float (&acc)[kAccRegs],
                                              uint32_t (&A)[kARegs],
                                              WgRing& rg,
                                              const unsigned char* zero,
                                              float* E, const WgLayer& L,
                                              const float* bias, int act,
                                              const float* ln_a,
                                              const float* ln_b, int n_true) {
  const bool two = L.ni > kPassN;
  wg_pass(acc, A, rg, L, zero);
  acc_bias_act(acc, bias, two ? kPassN : L.pd_out, act);
  if (two) {
    park_f32(acc, E);
    wg_pass(acc, A, rg, L, zero);
    acc_bias_act(acc, bias + kPassN, L.pd_out - kPassN, act);
  }
  if (ln_a) acc_layernorm(acc, two ? E : nullptr, n_true, ln_a, ln_b);
  return two;
}

// A walk over the warp's 16 rows (sources src_val): posenc into E, the
// input LayerNorm, the dense layers and the output LayerNorm, in either
// operand form: bf16 (acc a pass's 64 registers, A the register fragments)
// or fp32 (acc a whole layer's 128, A the warp's rows of E: WgRowsA, below).
// Without rows_f32 the output is left as the next product's A operand (y_k
// for the w_k product: bf16, rounded, in the A fragments; fp32 in E;
// returns false). With rows_f32 the last layer's fp32 output (LayerNorm'd
// if the walk has one) is left in acc for columns 0..127 (fp32: all of
// them), or, for a 256-wide last layer in the bf16 form (returns true),
// columns 128.. in acc and 0..127 parked fp32 at E (the value rows before
// their rounding).
template <int N, class AOp, class Src>
__device__ __forceinline__ bool wg_walk(float (&acc)[N], AOp& A, WgRing& rg,
                                        const unsigned char* zero, float* E,
                                        int ld, const WgWalk& w, int row0,
                                        bool rows_f32, const Src& src_val) {
  using Op = typename WgForm<AOp>::Op;
  const WalkDesc& d = *w.d;
  const int n = d.n;
  wg_encode(E, ld, d, w.plan, row0, src_val);
  __syncwarp();
  wg_rows_in<Op>(E, ld, d, w.ln, row0);
  wg_load_a(E, ld, d, row0, A);
  const float* lo = w.ln + 2 * d.pd[0];
  for (int l = 0; l + 1 < n; ++l)
    wg_dense(acc, A, rg, zero, E, w.layers[l], w.bias + (d.b[l] - d.b[0]),
             d.act, nullptr, nullptr, 0);
  const WgLayer& L = w.layers[n - 1];
  const float* bias = w.bias + (d.b[n - 1] - d.b[0]);
  if (!rows_f32) {
    wg_dense(acc, A, rg, zero, E, L, bias, d.last_act,
             d.has_lo ? lo : nullptr, lo + d.pd[n], d.d_out);
    return false;
  }
  return wg_dense_rows(acc, A, rg, zero, E, L, bias, d.last_act,
                       d.has_lo ? lo : nullptr, lo + d.pd[n], d.d_out);
}

// The walk's fp32 output as wg_walk leaves it with rows_f32 (columns 0..127
// in acc; with two, columns 0..127 parked fp32 at E and 128.. in acc),
// rounded to bf16 into the A fragments, then written to the warpgroup's rows
// rbase + r < R of y (d_out wide): each thread's words go to its rows of a
// staging tile over E (512 bytes a row, the 16-byte groups XOR-swizzled by
// row % 8, so a warp's stores hit 32 distinct banks), then each warp copies
// its 16 rows out, 16 bytes a lane where the row width allows (rows are
// contiguous in y). The caller's next warpgroup barrier guards E.
__device__ __forceinline__ void wg_store_rows(const float (&acc)[kAccRegs],
                                              uint32_t (&A)[kARegs], float* E,
                                              bool two,
                                              __nv_bfloat16* __restrict__ y,
                                              int rbase, int R, int d_out) {
  const int t = threadIdx.x & 127, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * (t >> 5);
  if (two) {
    acc_to_a<32>(acc, A);
#pragma unroll
    for (int i = 0; i < kAccRegs / 2; ++i)
      A[i] = pack_bf16(E[(2 * i) * 128 + t], E[(2 * i + 1) * 128 + t]);
  } else {
    acc_to_a<0>(acc, A);
  }
  // Every thread has read its parked pass before the staging tile covers it.
  named_sync(2 + (threadIdx.x >> 7), 128);
  unsigned char* stg = reinterpret_cast<unsigned char*>(E);
#pragma unroll
  for (int i = 0; i < kARegs; ++i) {
    if (i >= 32 && !two) break;
    // Word i: pass i / 32, row g + 8 (i % 2), 16-byte group 16 (i / 32) +
    // (i % 32) / 2, bytes 4 q ..
    const int r = row0 + g + 8 * (i & 1);
    const int grp = 16 * (i >> 5) + ((i & 31) >> 1);
    *reinterpret_cast<uint32_t*>(stg + r * 512 + ((grp ^ g) << 4) + 4 * q) =
        A[i];
  }
  __syncwarp();
  const int rows = R - (rbase + row0) < 16 ? R - (rbase + row0) : 16;
  if (d_out % 8 == 0) {
    const int upr = d_out / 8;
    for (int u = lane; u < rows * upr; u += 32) {
      const int rr = row0 + u / upr, c = u % upr;
      *reinterpret_cast<uint4*>(y + (size_t)(rbase + rr) * d_out + 8 * c) =
          *reinterpret_cast<const uint4*>(stg + rr * 512 +
                                          ((c ^ (rr & 7)) << 4));
    }
  } else {
    for (int u = lane; u < rows * d_out; u += 32) {
      const int rr = row0 + u / d_out, c = u % d_out;
      y[(size_t)(rbase + rr) * d_out + c] =
          *reinterpret_cast<const __nv_bfloat16*>(
              stg + rr * 512 + (((c >> 3) ^ (rr & 7)) << 4) + 2 * (c & 7));
    }
  }
}

// The fp32 form's output (every column in acc, as wg_walk leaves it with
// rows_f32) written to the warpgroup's rows rbase + r < R of y (d_out wide,
// fp32): the thread's values to the warp's rows of E (wg_rows_out), then
// each warp copies its 16 rows out, 16 bytes a lane where the row width
// allows (rows are contiguous in y; E's rows are 16-byte aligned).
__device__ __forceinline__ void wg_store_rows(const float (&acc)[kOutRegs],
                                              WgRowsA& A, float*, bool,
                                              float* __restrict__ y,
                                              int rbase, int R, int d_out) {
  const int lane = threadIdx.x & 31, row0 = A.row0;
  wg_rows_out(acc, A.E, row0);
  const float* E = A.E;
  const int rows = R - (rbase + row0) < 16 ? R - (rbase + row0) : 16;
  if (d_out % 4 == 0) {
    const int upr = d_out / 4;
    for (int u = lane; u < rows * upr; u += 32) {
      const int rr = row0 + u / upr, c = u % upr;
      *reinterpret_cast<float4*>(y + (size_t)(rbase + rr) * d_out + 4 * c) =
          *reinterpret_cast<const float4*>(E + rr * kF32Ld + 4 * c);
    }
  } else {
    for (int u = lane; u < rows * d_out; u += 32) {
      const int rr = row0 + u / d_out, c = u % d_out;
      y[(size_t)(rbase + rr) * d_out + c] = E[rr * kF32Ld + c];
    }
  }
}

// The w_k product of y_k (the A fragments) and the scaled dot with each of
// the thread's two rays' query: col[h] = q_t . linear_bf16(y_k w_k, b_k) /
// sqrt_dm for ray rbase + rl[h] (0 past T); bks: b_k in shared memory.
__device__ __forceinline__ void wg_score(float (&acc)[kAccRegs],
                                         uint32_t (&A)[kARegs], WgRing& rg,
                                         const unsigned char* zero,
                                         const WgLayer& L,
                                         const float* __restrict__ qq, int dm,
                                         const float* bks, float sqrt_dm,
                                         int T, int rbase,
                                         const int (&rl)[2],
                                         float (&col)[2]) {
  const int q = threadIdx.x & 3;
  float s[2] = {0.f, 0.f};
  for (int pass = 0; pass < (L.ni > kPassN ? 2 : 1); ++pass) {
    wg_pass(acc, A, rg, L, zero);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = rbase + rl[h];
      if (t >= T) continue;
      const float* qrow = qq + (size_t)t * dm;
#pragma unroll
      for (int j = 0; j < kAccRegs / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kPassN * pass + 8 * j + 2 * q + e;
          if (c < dm)
            s[h] += qrow[c] * linear_bf16(acc[4 * j + 2 * h + e], bks[c]);
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) col[h] = quad_sum(s[h]) / sqrt_dm;
}

// The fp32 form's w_k product of y_k (the warp's rows of E) and the scaled
// dot with each of the thread's two rays' query, as above with the bias
// added in fp32 (linear_c<float>).
__device__ __forceinline__ void wg_score(float (&acc)[kOutRegs], WgRowsA& A,
                                         WgRing& rg, const unsigned char*,
                                         const WgLayer& L,
                                         const float* __restrict__ qq, int dm,
                                         const float* bks, float sqrt_dm,
                                         int T, int rbase,
                                         const int (&rl)[2],
                                         float (&col)[2]) {
  const int q = threadIdx.x & 3;
  wg_gemm_f32(acc, A.E, A.row0, rg, L);
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = rbase + rl[h];
    if (t >= T) continue;
    const float* qrow = qq + (size_t)t * dm;
#pragma unroll
    for (int j = 0; j < kOutRegs / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        if (c < dm)
          s[h] += qrow[c] * linear_c<float>(acc[4 * j + 2 * h + e], bks[c]);
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) col[h] = quad_sum(s[h]) / sqrt_dm;
}

// ------------------------------------------------ the int8 operand form --
//
// The walk of the int8 one-shot eval attention (attend_eval.cu
// attend_eval_i8_wgmma_kernel, tpu.int8_eval): papr_tpu/ops/fused_mlp.py
// walk_body_fwd_q on wgmma. The posenc and the input LayerNorm run in fp32
// on the warp's rows of E, as the other forms; the first layer's input is
// quantized from there (q = clip(round(h * inv), +-127), walk.cuh
// quantize_value: round half to even, no contraction) into int8 A
// fragments; every product is wgmma m64n128k32 s8 x s8 -> s32 (A from
// registers, B K-major from the ring) into an int accumulator, whose
// epilogue runs in registers: z = acc * dq + b (a multiply, then an add),
// the activation, and, but after the last layer, the quantization with the
// next layer's inverse scales straight into the next product's A
// fragments. The last layer's fp32 output (and the output LayerNorm) is
// left as the epilogue's form takes it: bf16 (4q), the bf16 form's y_k A
// fragments or value rows; fp32 (4qf), the fp32 form's whole-layer
// accumulator (y_k then goes to E for the 3xTF32 w_k product).
//
// An s8 A fragment of a k32 block holds row g's and g + 8's K positions
// 4 q .. 4 q + 3 and 16 + 4 q .. 16 + 4 q + 3, where the accumulator holds
// columns 8 j + 2 q + {0, 1}; the packer (ops/fused_mlp.py
// pack_walk_wgmma_q) permutes each 32-deep K group of every layer's weight
// rows so that K position 4 q + i reads input column {2 q, 2 q + 1, 2 q + 8,
// 2 q + 9}[i] and 16 + 4 q + i column 16 + {...}[i]: a thread quantizes its
// own accumulator columns into its own fragments, with no shuffle. The
// integer sums do not depend on the order, so the products are the plain
// version's int32 sums exactly. An int8 weight row of 128 bytes is 128 K
// values, so a chunk is 128 deep (the 128-byte swizzle atom; the key's
// 117 -> 128-wide first layer pads nothing past its 16-aligned width, the
// value's 142 -> 144 pads 112 zero rows in its second chunk) and a 256-deep
// input is two chunks of four k32 steps; a 256-wide output is two passes of
// 128, the first pass's int8 output held in registers (A[32 ..]) while the
// second reads the input. The products always run two chunks: past a
// layer's width the fragments are zero, and an integer product with zero
// fragments adds nothing whatever the stage it reads holds, so the second
// chunk of a 128-deep layer reads its first chunk's slot again. Parameter
// rows (biases, dq, inv, LayerNorms, plan, b_k) are read in place.

constexpr int kQ8ChunkK = 128;                 // K rows of an int8 chunk
constexpr int kQ8Regs = kMaxWidth / 8;         // a 256-deep input: 8 k32 x 4
constexpr int kQ8ARegs = kQ8Regs + kQ8Regs / 2;  // + a first pass's output

// The int8 form's A operand beside the epilogue's form Op: int8 fragments
// in r[0 .. kQ8ARegs) (the layer input in r[0 .. kQ8Regs)); with bf16, the
// w_k product's bf16 fragments in r[0 .. kARegs) after the walk; with fp32,
// the warp's rows of E for the w_k product. ep() is the w_k product's
// operand in the epilogue's form.
template <class Op>
struct WgQ8A {
  uint32_t r[kARegs];
  __device__ __forceinline__ auto& ep() { return r; }
};
template <>
struct WgQ8A<float> {
  uint32_t r[kQ8ARegs];
  WgRowsA rows;
  __device__ __forceinline__ WgRowsA& ep() { return rows; }
};

// Host side: the layer table of an image that mixes forms, layer i in the
// form kind[i] (kWgQ8: ceil(pd_in / 128) chunks of wg_tile_n(pd_out) rows
// of 128 bytes; kWgBf16: wg_plan's; kWgF32: wg_plan_f32's stages), and the
// per-k chunk stream of those layers; the plan returns the image's size.
enum WgKind { kWgBf16 = 0, kWgQ8 = 1, kWgF32 = 2 };

inline long long wg_plan_mixed(WgLayer* l, const int (*dims)[2],
                               const int* kind, int n) {
  long long off = 0;
  for (int i = 0; i < n; ++i) {
    const long long bytes =
        kind[i] == kWgF32 ? wg_plan_f32(l + i, dims + i, 1)
                          : wg_plan(l + i, dims + i, 1,
                                    kind[i] == kWgQ8 ? kQ8ChunkK : kWChunkRows);
    l[i].off = (int)off;
    off += bytes;
  }
  return off;
}

inline int wg_chunks_mixed(WgChunk* out, const WgLayer* l, const int* kind,
                           int n) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    if (kind[i] == kWgF32) {
      WgLayer t;
      const int d[1][2] = {{l[i].pd_in, l[i].pd_out}};
      m += wg_chunks_f32(out + m, wg_plan_f32(&t, d, 1), l[i].off);
    } else {
      m += wg_chunks(out + m, l + i, 1,
                     kind[i] == kWgQ8 ? kQ8ChunkK : kWChunkRows);
    }
  }
  return m;
}

// Four int8 values (low bytes of a .. d) as one fragment register, a first.
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// acc = A[0 .. kQ8Regs) x W for one pass: its two 128-deep chunks in order
// from the ring, four m64n128k32 products each, one chunk's products in
// flight while the next is issued; each chunk goes back to the ring once
// its products are done. nch = 1: the second chunk's products read the
// slot just waited on again with zero fragments (no second wait), and that
// slot goes back once both chunks' products are done.
template <int R>
__device__ __forceinline__ void wg_gemm_q8(int (&acc)[kAccRegs],
                                           uint32_t (&A)[R], WgRing& ring,
                                           int nch) {
  static_assert(R >= kQ8Regs, "");
  reg_fence(A);
  reg_fence(acc);
#pragma unroll
  for (int c = 0; c < kMaxWidth / kQ8ChunkK; ++c) {
    const bool real = c < nch;
    const int st = (real ? ring.i : ring.i - 1) % ring.stages;
    if (real) mbar_wait(&ring.full[st], (ring.i / ring.stages) & 1);
    const uint64_t desc = sw128_desc(ring.base + st * kWStageBytes, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int kb = 4 * c + kk;
      wgmma_rs_s8_n128(acc, A[4 * kb], A[4 * kb + 1], A[4 * kb + 2],
                       A[4 * kb + 3], desc + 2 * kk, kb > 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      if (real) wg_release(ring, ring.i - 1);
    }
    if (real) ++ring.i;
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(A);
  wg_release(ring, ring.i - 1);
}

// The layer's z = acc * dq + b (a multiply, then an add) and activation of
// the pass's columns < pd (pd relative to the pass; others z = 0); pairs of
// columns c, c + 1 = 8 j + 2 q.
__device__ __forceinline__ float2 q8_dequant(const int (&acc)[kAccRegs],
                                             int j, int h, float2 s, float2 b,
                                             int act) {
  float z0 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h], s.x), b.x);
  float z1 = __fadd_rn(__fmul_rn((float)acc[4 * j + 2 * h + 1], s.y), b.y);
  if (act == 1) {
    z0 = fmaxf(z0, 0.f);
    z1 = fmaxf(z1, 0.f);
  }
  return make_float2(z0, z1);
}

// The pass's dequantized, activated columns quantized with the next layer's
// inverse scales (inv, relative to the pass) into the next product's
// fragments A[O + 4 kb + 2 m + h] (kb: the pass's k32 blocks; m: K
// positions 16 m ..; h: row g + 8 h), each of columns 32 kb + 16 m + 2 q +
// {0, 1, 8, 9} in its bytes 0..3 (the packer's permutation); columns >= pd
// quantize to 0.
template <int O, int R>
__device__ __forceinline__ void q8_to_a(const int (&acc)[kAccRegs],
                                        const float* __restrict__ dq,
                                        const float* __restrict__ bias,
                                        const float* __restrict__ inv, int pd,
                                        int act, uint32_t (&A)[R]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int kb = 0; kb < kPassN / 32; ++kb)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      int v[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int j = 4 * kb + 2 * m + x, c = 8 * j + 2 * q;
        const bool in = c < pd;
        const float2 s = in ? *reinterpret_cast<const float2*>(dq + c)
                            : make_float2(0.f, 0.f);
        const float2 b = in ? *reinterpret_cast<const float2*>(bias + c)
                            : make_float2(0.f, 0.f);
        const float2 iv = in ? *reinterpret_cast<const float2*>(inv + c)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 z = q8_dequant(acc, j, h, s, b, act);
          v[h][2 * x] = quantize_value(z.x, iv.x);
          v[h][2 * x + 1] = quantize_value(z.y, iv.y);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        A[O + 4 * kb + 2 * m + h] = pack_s8(v[h][0], v[h][1], v[h][2],
                                            v[h][3]);
    }
}

// The pass's dequantized, activated columns as fp32 into f[O + i] (the
// accumulator layout); columns >= pd are 0.
template <int O, int N>
__device__ __forceinline__ void q8_to_f32(const int (&acc)[kAccRegs],
                                          const float* __restrict__ dq,
                                          const float* __restrict__ bias,
                                          int pd, int act, float (&f)[N]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kAccRegs / 4; ++j) {
    const int c = 8 * j + 2 * q;
    const bool in = c < pd;
    const float2 s = in ? *reinterpret_cast<const float2*>(dq + c)
                        : make_float2(0.f, 0.f);
    const float2 b = in ? *reinterpret_cast<const float2*>(bias + c)
                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 z = q8_dequant(acc, j, h, s, b, act);
      f[O + 4 * j + 2 * h] = in ? z.x : 0.f;
      f[O + 4 * j + 2 * h + 1] = in ? z.y : 0.f;
    }
  }
}

// The first layer's fragments from the warp's fp32 rows of E (the encoding
// after the input LayerNorm, ld floats a row), quantized with the layer's
// inverse scales inv, in the layout q8_to_a writes; the 16-column halves
// of k32 blocks at or past pd are zero (pd is a multiple of 16).
template <int R>
__device__ __forceinline__ void q8_load_a(const float* E, int ld, int pd,
                                          const float* __restrict__ inv,
                                          int row0, uint32_t (&A)[R]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float* r0 = E + (row0 + g) * ld + 2 * q;
#pragma unroll
  for (int kb = 0; kb < kQ8Regs / 4; ++kb)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int c = 32 * kb + 16 * m;
      const bool in = c < pd;
      const float2 i0 = in ? *reinterpret_cast<const float2*>(inv + c + 2 * q)
                           : make_float2(0.f, 0.f);
      const float2 i1 = in ? *reinterpret_cast<const float2*>(inv + c + 8 +
                                                              2 * q)
                           : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0u;
        if (in) {
          const float* rh = r0 + 8 * h * ld + c;
          const float2 x0 = *reinterpret_cast<const float2*>(rh);
          const float2 x1 = *reinterpret_cast<const float2*>(rh + 8);
          v = pack_s8(quantize_value(x0.x, i0.x), quantize_value(x0.y, i0.y),
                      quantize_value(x1.x, i1.x), quantize_value(x1.y, i1.y));
        }
        A[4 * kb + 2 * m + h] = v;
      }
    }
}

// One int8 layer but the last, A -> A: its passes' products, then each
// pass's epilogue quantized for the next layer (inv: its inverse scales).
// A 256-wide layer's first pass goes to A[kQ8Regs ..] while the second
// product reads A[0 .. kQ8Regs); a narrower layer's output leaves the
// fragments past it zero.
template <int R>
__device__ __forceinline__ void wg_dense_q8(int (&acc)[kAccRegs],
                                            uint32_t (&A)[R], WgRing& rg,
                                            const WgLayer& L, const float* dq,
                                            const float* bias, int act,
                                            const float* inv) {
  static_assert(R >= kQ8ARegs, "");
  const int nch = (L.pd_in + kQ8ChunkK - 1) / kQ8ChunkK;
  wg_gemm_q8(acc, A, rg, nch);
  if (L.ni <= kPassN) {
    q8_to_a<0>(acc, dq, bias, inv, L.pd_out, act, A);
#pragma unroll
    for (int i = kQ8Regs / 2; i < kQ8Regs; ++i) A[i] = 0u;
    return;
  }
  q8_to_a<kQ8Regs>(acc, dq, bias, inv, kPassN, act, A);
  wg_gemm_q8(acc, A, rg, nch);
  q8_to_a<kQ8Regs / 2>(acc, dq + kPassN, bias + kPassN, inv + kPassN,
                       L.pd_out - kPassN, act, A);
#pragma unroll
  for (int i = 0; i < kQ8Regs / 2; ++i) A[i] = A[kQ8Regs + i];
}

// The last layer with the bf16 epilogue (the bf16 form's wg_dense with the
// output LayerNorm, or wg_dense_rows): its passes' fp32 output in f (a
// 256-wide layer's first pass parked fp32 at park meanwhile), the output
// LayerNorm when ln_a is given; with rows, left so (returns whether parked);
// else rounded to bf16 into the w_k product's fragments A[0 .. kARegs).
__device__ __forceinline__ bool wg_last_q8(float (&f)[kAccRegs],
                                           int (&acc)[kAccRegs],
                                           WgQ8A<__nv_bfloat16>& Aq,
                                           WgRing& rg, float* park,
                                           const WgLayer& L, const float* dq,
                                           const float* bias, int act,
                                           const float* ln_a,
                                           const float* ln_b, int n_true,
                                           bool rows) {
  uint32_t(&A)[kARegs] = Aq.r;
  const int nch = (L.pd_in + kQ8ChunkK - 1) / kQ8ChunkK;
  const bool two = L.ni > kPassN;
  wg_gemm_q8(acc, A, rg, nch);
  q8_to_f32<0>(acc, dq, bias, two ? kPassN : L.pd_out, act, f);
  if (two) {
    park_f32(f, park);
    wg_gemm_q8(acc, A, rg, nch);
    q8_to_f32<0>(acc, dq + kPassN, bias + kPassN, L.pd_out - kPassN, act, f);
  }
  if (ln_a) acc_layernorm(f, two ? park : nullptr, n_true, ln_a, ln_b);
  if (rows) return two;
  if (two) {
    acc_to_a<32>(f, A);
    const int t = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < kAccRegs / 2; ++i)
      A[i] = pack_bf16(park[(2 * i) * 128 + t], park[(2 * i + 1) * 128 + t]);
  } else {
    acc_to_a<0>(f, A);
#pragma unroll
    for (int i = kAccRegs / 2; i < kARegs; ++i) A[i] = 0u;
  }
  return false;
}

// The last layer with the fp32 epilogue: the whole layer's fp32 output in f
// (the fp32 form's layout), the output LayerNorm when ln_a is given; with
// rows, left so; else written to the warp's rows of E (the fp32 w_k
// product's A). Returns false (nothing parked).
__device__ __forceinline__ bool wg_last_q8(float (&f)[kOutRegs],
                                           int (&acc)[kAccRegs],
                                           WgQ8A<float>& A, WgRing& rg,
                                           float*, const WgLayer& L,
                                           const float* dq, const float* bias,
                                           int act, const float* ln_a,
                                           const float* ln_b, int n_true,
                                           bool rows) {
  const int nch = (L.pd_in + kQ8ChunkK - 1) / kQ8ChunkK;
  wg_gemm_q8(acc, A.r, rg, nch);
  q8_to_f32<0>(acc, dq, bias, L.ni > kPassN ? kPassN : L.pd_out, act, f);
  if (L.ni > kPassN) {
    wg_gemm_q8(acc, A.r, rg, nch);
    q8_to_f32<kAccRegs>(acc, dq + kPassN, bias + kPassN, L.pd_out - kPassN,
                        act, f);
  } else {
#pragma unroll
    for (int i = kAccRegs; i < kOutRegs; ++i) f[i] = 0.f;
  }
  if (ln_a) acc_layernorm(f, nullptr, n_true, ln_a, ln_b);
  if (!rows) wg_rows_out(f, A.rows.E, A.rows.row0);
  return false;
}

// The int8 walk over the warp's 16 rows, wg_walk's contract in the int8
// form (beside the epilogue's form Op: f its accumulator): posenc into E,
// the input LayerNorm in fp32, the first layer's fragments quantized from
// E, the int8 layers, the last layer's fp32 output as the epilogue's form
// leaves it (without rows_f32: y_k, bf16 fragments in A.r or fp32 rows of
// E; with rows_f32: f, and with the bf16 epilogue a 256-wide last layer's
// first pass parked fp32 at E, returning true).
template <class Op, int N, class Src>
__device__ __forceinline__ bool wg_walk(float (&f)[N], WgQ8A<Op>& A,
                                        WgRing& rg, const unsigned char*,
                                        float* E, int ld, const WgWalk& w,
                                        int row0, bool rows_f32,
                                        const Src& src_val) {
  const WalkDesc& d = *w.d;
  const int n = d.n;
  wg_encode(E, ld, d, w.plan, row0, src_val);
  __syncwarp();
  wg_rows_in<float>(E, ld, d, w.ln, row0);
  q8_load_a(E, ld, d.pd[0], w.inv, row0, A.r);
  int acc[kAccRegs];
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0;
  int inv_off = d.pd[0];
  for (int l = 0; l + 1 < n; ++l) {
    const int bo = (int)(d.b[l] - d.b[0]);
    wg_dense_q8(acc, A.r, rg, w.layers[l], w.dq + bo, w.bias + bo, d.act,
                w.inv + inv_off);
    inv_off += d.pd[l + 1];
  }
  const int bo = (int)(d.b[n - 1] - d.b[0]);
  const float* lo = w.ln + 2 * d.pd[0];
  return wg_last_q8(f, acc, A, rg, E, w.layers[n - 1], w.dq + bo,
                    w.bias + bo, d.last_act, d.has_lo ? lo : nullptr,
                    lo + d.pd[n], d.d_out, rows_f32);
}

// ---------------------------------------------- the stream forwards ----
//
// key_fwd_wgmma_kernel / key_fwd_wgmma_f32_kernel (key_stream.cu) and
// value_fwd_wgmma_kernel / value_fwd_wgmma_f32_kernel (value_stream.cu) on
// the walk above, in its bf16 or fp32 operand form (the forms of the bf16 and
// the fp32 K3): the record read pre-gathered k-major (K, T, rec_w), a
// token's row k * T + t. The fp32 feature streams (key_stream_feat.cu
// key_feat_fwd_wgmma_f32_kernel, value_stream_feat.cu
// value_feat_fwd_wgmma_f32_kernel) are the same function with another
// token source (the policy Tok): the raw feature row x[k, t, :] of a
// (K, T, d_raw) tensor built in torch as the posenc sources, influence and
// alive from (T, K) arrays, no geometry stage (its shared-memory rows stay
// in the layout, unused). The grid is persistent, as the backwards'
// (walk_wgmma_bwd.cuh): each block takes an even, contiguous share of the
// (tile, k) units in tile-major order, so with grid <= tiles a tile is split
// between at most two blocks; grid = tiles is one block a tile. The key
// forward writes each (ray, k)'s raw dot and masked score, and a small
// kernel after it takes the background-token softmax over a ray's K scores
// (a split ray's come from two blocks). The value forward adds each part's
// per-ray sum into the zeroed fused rows with atomicAdd: at most two addends
// on 0, so the result does not depend on their order (but a split ray's sum
// over k is rounded once at the split, where _vsr_fwd_kernel sums all K in
// order). The fp32 form reads its parameter rows (biases, LayerNorms, plan,
// b_k) in place and has no zero chunk: its shared memory holds the fp32
// activations.

template <class Op>
struct StreamFwdWgT {
  const float* rec;                      // (K, T, rec_w) k-major
  int rec_w, T, K;
  const float* rayo;
  const float* rays;
  WalkDesc d;
  float eps;
  WgLayer layers[kWgMaxLayers];          // the walk, then (key) w_k
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // one k step
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  int ld, e_floats, wg_floats;           // shared memory layout (floats)
  int nb, nln, nplan, n_prm;             // staged parameter rows (floats)
  int n_units, grid;                     // (tile, k) units over grid blocks
  // key
  const float* qq;
  int dm;
  float sqrt_dm;
  const float* bk;
  int dm_pad, score_relu;
  float* raw;                            // (T, K)
  float* ss;                             // (T, K)
  // value
  const float* attn;                     // (T, K + 1)
  int normalize;
  float* fused;                          // (T, d_out), zero on entry
  // the feature token source (FeatTok), in place of rec / rayo / rays
  const float* x;                        // (K, T, d_raw) k-major
  int d_raw;
  const float* influ;                    // (T, K)
  const float* alive;                    // (T, K)
};
using StreamFwdWg = StreamFwdWgT<__nv_bfloat16>;

// Host side: the walk, its layer table (with head_pd > 0, the key's w_k
// (pd[n] -> head_pd) after it) in the form's image (wg_plan / wg_plan_f32),
// the chunk stream and the shared-memory layout. Returns 0 or a negative
// code; *smem gets the block's bytes.
template <class Op>
inline int fill_stream_fwd_wg(StreamFwdWgT<Op>* p, const int* meta,
                              const void* w, const void* b, const void* ln,
                              const void* plan, int head_pd,
                              const void* wpack, long long wbytes,
                              size_t* smem) {
  constexpr bool f32 = kF32<Op>;
  int err = fill_walk(&p->d, meta, w, b, ln, plan);
  if (err) return err;
  const WalkDesc& d = p->d;
  int dims[kWgMaxLayers][2], m = 0;
  wg_walk_dims(dims, &m, d);
  if (head_pd) {
    dims[m][0] = d.pd[d.n];
    dims[m++][1] = head_pd;
  }
  const long long need = f32 ? wg_plan_f32(p->layers, dims, m)
                             : wg_plan(p->layers, dims, m);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p->n_chunks = f32 ? wg_chunks_f32(p->chunks, need)
                    : wg_chunks(p->chunks, p->layers, m);
  p->w = static_cast<const unsigned char*>(wpack);
  if constexpr (f32) {
    // Parameter rows read in place; E in the fp32 form's rows.
    p->nb = p->nln = p->nplan = p->n_prm = 0;
    p->ld = kF32Ld;
    p->e_floats = kWgRows * kF32Ld;
  } else {
    wg_walk_rows(d, &p->nb, &p->nln, &p->nplan);
    p->n_prm = p->nb + p->nln + p->nplan + head_pd;
    p->ld = wg_ld(d.pd[0]);
    p->e_floats = wg_e_floats(p->ld);
  }
  // value: the fused rows and the safe denominators of the warpgroup's rays
  p->wg_floats = kWgRows * kGeo + p->e_floats +
                 (head_pd ? 0 : kWgRows * (d.d_out + 1));
  return wg_ring_fit(wg_smem_rest(2 * p->wg_floats, p->n_prm, !f32),
                     &p->stages, smem);
}

// Where a stream forward's (t, k) tokens come from (stream_fwd_wg's source
// policy): stage(p, geo, rbase, row0, k) prepares the warp's 16 rays of step
// k (ends on a warp barrier), src(p, geo, rbase, k) is the walk's posenc
// sources, mask(p, geo, r, t, k) the (influence, alive) pair of ray t = rbase
// + r. RecTok: the record (K3's geometry rows, the record's point features,
// record lanes 3-4 through geo[9] / geo[10]).
struct RecTok {
  template <class P>
  static __device__ __forceinline__ void stage(const P& p, float* geo,
                                               int rbase, int row0, int k) {
    const int T = p.T;
    wg_geometry(geo, p.rec, p.rec_w, p.rayo, p.rays, T, rbase, row0, p.eps,
                [&](int t) { return k * T + t; });
  }
  template <class P>
  static __device__ __forceinline__ RecSrc src(const P& p, const float* geo,
                                               int, int) {
    return RecSrc{geo, p.rec, p.rec_w};
  }
  template <class P>
  static __device__ __forceinline__ float2 mask(const P&, const float* geo,
                                                int r, int, int) {
    const float* gr = geo + r * kGeo;
    return make_float2(gr[9], gr[10]);
  }
};

// FeatTok: the raw feature rows (FeatSrc), influence and alive from the
// (T, K) arrays; nothing to stage.
struct FeatTok {
  template <class P>
  static __device__ __forceinline__ void stage(const P&, float*, int, int,
                                               int) {}
  template <class P>
  static __device__ __forceinline__ FeatSrc src(const P& p, const float*,
                                                int rbase, int k) {
    return FeatSrc{p.x + (size_t)k * p.T * p.d_raw, p.d_raw, p.T, rbase};
  }
  template <class P>
  static __device__ __forceinline__ float2 mask(const P& p, const float*, int,
                                                int t, int k) {
    const size_t i = (size_t)t * p.K + k;
    return make_float2(p.influ[i], p.alive[i]);
  }
};

// The forward of a key stream (kKey: the score head) or value stream (the
// fuse) on the block's share of the (tile, k) units, in either operand form
// (Op: bf16, or fp32), its tokens from the source Tok (the record, or raw
// feature rows).
template <bool kKey, class Op = __nv_bfloat16, class Tok = RecTok>
__device__ __forceinline__ void stream_fwd_wg(const StreamFwdWgT<Op>& p) {
  constexpr bool f32 = kF32<Op>;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * p.wg_floats, p.n_prm,
                            !f32);
  if constexpr (f32) {
    // Every E column a product reads is finite from the start (columns
    // past a walk's input width meet zero weight rows).
    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)
      sm.tiles[i] = 0.f;
  }
  // Parameter rows (bf16 form): biases, LayerNorms, plan, then (key) b_k.
  float* bias = sm.prm;
  float* lns = bias + p.nb;
  float* plan = lns + p.nln;
  float* bks = plan + p.nplan;
  {
    const float* const src[4] = {p.d.b[0], p.d.ln, p.d.plan, p.bk};
    const int cnt[4] = {p.nb, p.nln, p.nplan, kKey && !f32 ? p.dm_pad : 0};
    wg_prologue(sm, p.stages, src, cnt);
  }
  const long long n_units = p.n_units;
  const int u_begin = (int)(n_units * blockIdx.x / p.grid);
  const int u_end = (int)(n_units * (blockIdx.x + 1) / p.grid);
  WgRing rg{sm.ring, sm.full, sm.released, p.stages, 0, p.n_chunks,
            p.n_chunks * (u_end - u_begin), p.chunks, p.w};
  wg_ring_start(rg);
  const WgWalk walk{&p.d, f32 ? p.d.b[0] : bias, f32 ? p.d.ln : lns,
                    f32 ? p.d.plan : plan, p.layers};
  const float* bkr = f32 ? p.bk : bks;

  const int tid = threadIdx.x, wg = tid >> 7, t_in = tid & 127;
  const int w = t_in >> 5, lane = t_in & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * w, ld = p.ld, T = p.T, K = p.K, cout = p.d.d_out;
  const int rl[2] = {row0 + g, row0 + g + 8};
  float* geo = sm.tiles + wg * p.wg_floats;       // kWgRows x kGeo
  float* E = geo + kWgRows * kGeo;                // rows / parking slices
  float* accv = E + p.e_floats;                   // value: kWgRows x cout
  float* den = accv + kWgRows * cout;             // value: kWgRows
  // The operand form's registers: bf16, a pass's accumulator and the A
  // fragments; fp32, a whole layer's accumulator (A: the rows of E).
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

  for (int u = u_begin; u < u_end;) {
    const int tile = u / K, k0 = u - tile * K;
    const int k1 = k0 + (u_end - u < K - k0 ? u_end - u : K - k0);
    u += k1 - k0;
    const int rbase = tile * kWgTile + wg * kWgRows;
    if (!kKey) {
      // Per ray of the warp: the safe denominator (_vsr_fwd_kernel: the
      // foreground mass under normalize, 1 where it is 0 or without
      // normalize) and the part's fused row zeroed.
      for (int r = row0; r < row0 + 16; ++r) {
        const int t = rbase + r;
        float sfg = 0.f;
        if (t < T)
          for (int k = lane; k < K; k += 32)
            sfg += p.attn[(size_t)t * (K + 1) + k];
        sfg = warp_sum(sfg);
        if (lane == 0) den[r] = p.normalize && sfg > 0.f ? sfg : 1.f;
      }
      for (int i = lane; i < 16 * cout; i += 32) accv[row0 * cout + i] = 0.f;
      __syncwarp();
    }
    for (int k = k0; k < k1; ++k) {
      // Every warp of the warpgroup is done with the parking slices (they
      // overlap the encoding rows) before any writes its encoding.
      named_sync(2 + wg, 128);
      Tok::stage(p, geo, rbase, row0, k);
      if (kKey) {
        // --- walk -> w_k -> the raw dot and the masked score ---
        wg_walk(acc, A, rg, sm.zero, E, ld, walk, row0, false,
                Tok::src(p, geo, rbase, k));
        float col[2];
        wg_score(acc, A, rg, sm.zero, p.layers[p.d.n], p.qq, p.dm, bkr,
                 p.sqrt_dm, T, rbase, rl, col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = rbase + rl[h];
          if (q == 0 && t < T) {
            const float2 ia = Tok::mask(p, geo, rl[h], t, k);
            p.raw[(size_t)t * K + k] = col[h];
            p.ss[(size_t)t * K + k] =
                masked_score(col[h], p.score_relu, ia.x, ia.y > 0.5f);
          }
        }
      } else {
        // --- walk -> value rows (rounded to bf16 in the bf16 form) ->
        // (attn_k / den) x rows ---
        const bool two = wg_walk(acc, A, rg, sm.zero, E, ld, walk, row0, true,
                                 Tok::src(p, geo, rbase, k));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = rbase + rl[h];
          const float a =
              t < T ? p.attn[(size_t)t * (K + 1) + k] / den[rl[h]] : 0.f;
          float* arow = accv + rl[h] * cout;
#pragma unroll
          for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int i = 4 * j + 2 * h + x, c = 8 * j + 2 * q + x;
              if (two && c < cout)
                arow[c] += a * act_round<Op>(E[i * 128 + t_in]);
              const int c1 = (two ? kPassN : 0) + c;
              if (c1 < cout) arow[c1] += a * act_round<Op>(acc[i]);
            }
        }
      }
    }
    if (!kKey) {
      // The part's sums of the warp's rays into fused (lanes over columns).
      __syncwarp();
      for (int r = row0; r < row0 + 16; ++r) {
        const int t = rbase + r;
        if (t >= T) break;
        for (int c = lane; c < cout; c += 32)
          atomicAdd(&p.fused[(size_t)t * cout + c], accv[r * cout + c]);
      }
    }
  }
}

// After a key stream forward on wgmma (key_stream.cu key_fwd_wgmma_kernel /
// key_fwd_wgmma_f32_kernel, key_stream_feat.cu
// key_feat_fwd_wgmma_f32_kernel), a warp per ray: the background-token
// softmax (stream_attn.py _softmax_s) of the ray's K masked scores -> attn
// (T, K+1), background last. A template so that each file that launches it
// instantiates its own copy.
template <int = 0>
__global__ void key_fwd_softmax_kernel(const float* __restrict__ ss, int T,
                                       int K, float bkg,
                                       float* __restrict__ attn) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * blockDim.x >> 5;
  for (int t = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; t < T;
       t += nw) {
    const float* srow = ss + (size_t)t * K;
    float m = bkg;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, srow[k]);
    m = warp_max(m);
    float z = 0.f;
    for (int k = lane; k < K; k += 32) z += expf(srow[k] - m);
    z = warp_sum(z);
    const float eb = expf(bkg - m);
    const float denom = z + eb;
    float* arow = attn + (size_t)t * (K + 1);
    for (int k = lane; k < K; k += 32) arow[k] = expf(srow[k] - m) / denom;
    if (lane == 0) arow[K] = eb / denom;
  }
}

// Host side of the stream forwards on wgmma, common to their entry points:
// p holds the token source's fields (RecTok: rec, rec_w, rayo, rays, eps;
// FeatTok: x, d_raw, influ, alive) and the head's (key: qq ... ss, set by
// launch_key_fwd_wg; value: attn, normalize and fused, zeroed by the
// caller). Checks K (and the key's score head), lays out the walk and its
// image (fill_stream_fwd_wg: the packed weights and their bytes) and
// launches kernel on grid blocks (1 .. the number of 128-ray tiles).
// Returns 0, a negative code, or the CUDA error.
template <bool kKey, class Op>
inline int launch_stream_fwd_wg(StreamFwdWgT<Op> p,
                                void (*kernel)(StreamFwdWgT<Op>), int T,
                                int K, const int* meta, const void* w,
                                const void* b, const void* ln,
                                const void* plan, const void* wpack,
                                long long wbytes, int grid,
                                cudaStream_t st) {
  int err = kKey ? check_score_head(p.dm, p.dm_pad, K)
                 : (K <= 0 || K > 64 ? -202 : 0);
  if (err) return err;
  size_t smem = 0;
  err = fill_stream_fwd_wg(&p, meta, w, b, ln, plan, kKey ? p.dm_pad : 0,
                           wpack, wbytes, &smem);
  if (err) return err;
  if (T <= 0) return 0;
  const int tiles = (T + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > tiles) return -209;
  p.T = T;
  p.K = K;
  p.n_units = tiles * K;
  p.grid = grid;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// The key's: the score head's arguments into p, the forward (its raw dots
// and masked scores into raw / ss, (T, K)), then key_fwd_softmax_kernel over
// ss into attn (T, K + 1).
template <class Op>
inline int launch_key_fwd_wg(StreamFwdWgT<Op> p,
                             void (*kernel)(StreamFwdWgT<Op>), int T, int K,
                             const int* kmeta, const void* kw,
                             const void* kb, const void* kln,
                             const void* kplan, const float* qq, int dm,
                             float sqrt_dm, const void* bk, int dm_pad,
                             int score_relu, float bkg, void* attn,
                             void* raw, void* ss, const void* wpack,
                             long long wbytes, int grid, void* stream) {
  p.qq = qq;
  p.dm = dm;
  p.sqrt_dm = sqrt_dm;
  p.bk = static_cast<const float*>(bk);
  p.dm_pad = dm_pad;
  p.score_relu = score_relu;
  p.raw = static_cast<float*>(raw);
  p.ss = static_cast<float*>(ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_stream_fwd_wg<true>(p, kernel, T, K, kmeta, kw, kb,
                                             kln, kplan, wpack, wbytes, grid,
                                             st);
  if (err || T <= 0) return err;
  key_fwd_softmax_kernel<0><<<(T + 7) / 8, 256, 0, st>>>(
      p.ss, T, K, bkg, static_cast<float*>(attn));
  return (int)cudaGetLastError();
}

}  // namespace papr
