// The walk on wgmma (Hopper): the layers of the bf16 one-shot eval attention
// (attend_eval.cu attend_eval_wgmma_kernel). The other walk kernels keep
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
#include "walk.cuh"

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
// byte offset off (a 256-wide layer's second pass reads rows 128.. of each).
struct WgLayer {
  int off, pd_in, pd_out, ni;
};

// Host side: the layer table of (pd_in, pd_out) pairs in the order the
// packed buffer holds them; returns the buffer's size in bytes.
inline long long wg_plan(WgLayer* l, const int (*dims)[2], int n) {
  long long off = 0;
  for (int i = 0; i < n; ++i) {
    l[i].off = (int)off;
    l[i].pd_in = dims[i][0];
    l[i].pd_out = dims[i][1];
    l[i].ni = wg_tile_n(dims[i][1]);
    off += (long long)((dims[i][0] + kWChunkRows - 1) / kWChunkRows) *
           l[i].ni * 128;
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
// to the pass); columns >= pd become 0.
__device__ __forceinline__ void acc_bias_act(float (&acc)[kAccRegs],
                                             const float* bias, int pd,
                                             int act) {
  const int q = threadIdx.x & 3;
  const bool full = pd >= kPassN;
#pragma unroll
  for (int j = 0; j < kAccRegs / 4; ++j) {
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
// 1 / (std + eps); columns >= n_true become 0. With park, the row's first
// 128 columns are the parked first pass (normalized in place there) and acc
// holds columns 128..; without, acc holds columns 0...
__device__ __forceinline__ void acc_layernorm(float (&acc)[kAccRegs],
                                              float* park, int n_true,
                                              const float* a,
                                              const float* b) {
  const int t = threadIdx.x & 127, q = t & 3;
  const int c1 = park ? kPassN : 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kAccRegs / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e, i = 4 * j + 2 * h + e;
        if (park && c < n_true) s += park[i * 128 + t];
        if (c1 + c < n_true) s += acc[i];
      }
    const float mu = quad_sum(s) / (float)n_true;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kAccRegs / 4; ++j)
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
    for (int j = 0; j < kAccRegs / 4; ++j)
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

// Host side: the per-k chunk stream of layers [0, n) in the order the
// warpgroups consume it (a 256-wide layer's second pass reads rows 128.. of
// each chunk); returns its length.
inline int wg_chunks(WgChunk* out, const WgLayer* layers, int n) {
  int m = 0;
  for (int li = 0; li < n; ++li) {
    const WgLayer& l = layers[li];
    const int passes = l.ni > kPassN ? 2 : 1;
    const int bytes = (l.ni > kPassN ? kPassN : l.ni) * 128;
    const int nch = (l.pd_in + kWChunkRows - 1) / kWChunkRows;
    for (int p = 0; p < passes; ++p)
      for (int c = 0; c < nch; ++c, ++m)
        out[m] = {l.off + c * l.ni * 128 + p * kWStageBytes, bytes};
  }
  return m;
}

}  // namespace papr
