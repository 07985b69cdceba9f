// Embedder "walk" building blocks on WMMA, shared by the int8 stream
// forwards (key_stream.cu / value_stream.cu with int8: rows 5q / 6q and
// their fp32 epilogue 5qf / 6qf), the bf16 folded stream kernels
// (key_stream_q.cu), the feature stream kernels but their fp32 forwards
// (key_stream_feat.cu, value_stream_feat.cu: the bf16 forwards and both
// backwards), the fused scores (fused_attn.cu) and the int8 walk
// microbenchmark; the embedder, K3 (the int8 K3 too: walk_wgmma.cuh's int8
// form, which reuses quantize_value below), the key / value streams, the
// fp32 folded key stream and the fp32 feature stream forwards run
// walk_wgmma.cuh.
//
// A walk is papr_tpu/ops/fused_mlp.py::walk_body_fwd: [LayerNorm] -> dense
// stack (bf16 operands, fp32 accumulate, fp32 bias, relu/none, activations
// rounded to bf16 between layers) -> [LayerNorm], on a tile of kRows tokens
// that never leaves the SM. The LayerNorm is the reference's: fp32
// statistics over the true width only, UNBIASED std, 1 / (std + eps).
//
// Shared memory of one block (walk_smem):
//   A[2] (kRows x kALd) bf16 : layer input / output activations (ping-pong)
//   C    (kRows x kCLd) fp32 : accumulators, fp32 stage values
//   W    2 x (kWChunk x kWLd) bf16 : the current layer's weight rows,
//        double-buffered 64-row chunks filled by cp.async
// followed by per-kernel extras. The dense layers run on the tensor cores
// through WMMA (m16n16k16 bf16 -> fp32). Each layer's weights are staged
// once per block and shared by all sixteen warps, so device memory / L2 see
// them once per 64-token tile; every activation stays on chip. Shared memory
// allows one block per SM, so the block itself carries 16 warps (four per
// scheduler) to hide the latency of the fragment loads and MMAs.
//
// The fp32 walk (use_amp: false; fused_mlp.py _cdt = float32) is the same
// code instantiated with T = float: fp32 operands, fp32 accumulation, fp32
// bias, activations left fp32 between layers. Each product is 3xTF32 on
// WMMA m16n16k8: every operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi accumulate in fp32 (the
// dropped lo*lo term is ~2^-22 relative), so the walk keeps fp32 accuracy
// on the tensor cores; a single TF32 pass would keep ~3 decimal digits. Its
// shared memory is the bf16 walk's 202,752 B laid out differently: the
// activations live IN PLACE in C (A[0] and A[1] alias C: a dense layer's
// epilogue runs after the last barrier of its chunk loop, when no warp reads
// its input any more), and the weights are staged as fp32 in the same
// double-buffered 64-row chunks over the 135,168 B that A[2] + W take in the
// bf16 layout.
//
// The int8 walk (run_walk_q) is papr_tpu/ops/fused_mlp.py::walk_body_fwd_q:
// [LayerNorm fp32] -> per layer the fp32 input quantized per column
// (q = clip(round(h * inv), +-127)), int8 x int8 -> int32 on the tensor
// cores, z = acc * dq + b and the activation in fp32 -> [LayerNorm fp32];
// nothing is rounded to bf16 between layers. It lives in the same buffers:
// the int8 activations ping-pong in A[0] / A[1] read as bytes (half a bf16
// tile each), the int8 weights are staged into W; C holds the fp32 stage
// values at both ends. Each layer's epilogue quantizes straight for the next
// layer (the fp32 value it holds is the h the reference quantizes), so only
// the first layer's input takes a separate quantize pass over C. Beside fp32
// compute (use_amp: false) the same walk runs with C moved to the front
// (walk_smem_q<float>) and leaves its fp32 output there, unrounded, for the
// fp32 products that follow.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace papr {

constexpr int kRows = 64;              // tokens per block tile (4 WMMA row blocks)
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWidth = 256;         // widest padded layer a walk takes
constexpr int kALd = kMaxWidth + 8;    // bf16 leading dim (bank-conflict pad)
constexpr int kCLd = kMaxWidth + 8;    // fp32 leading dim
constexpr int kWChunk = 64;            // weight rows per staged chunk
constexpr int kWLd = kMaxWidth + 8;    // staged weight leading dim
constexpr int kMaxLayers = 12;
constexpr float kLnEps = 1e-6f;        // fused_mlp.py hard-wires 1e-6
constexpr float kNegBig = -1e30f;      // papr.py NEG_BIG: score of a dead point
constexpr size_t kABytes = sizeof(__nv_bfloat16) * kRows * kALd;
constexpr size_t kCBytes = sizeof(float) * kRows * kCLd;
constexpr size_t kWBytes = sizeof(__nv_bfloat16) * 2 * kWChunk * kWLd;
constexpr size_t kWalkSmem = 2 * kABytes + kCBytes + kWBytes;
// The fp32 walk: C, then two fp32 weight chunks, in the same bytes.
static_assert(kALd == kCLd, "fp32 activations alias C");
static_assert(kCBytes + sizeof(float) * 2 * kWChunk * kWLd == kWalkSmem,
              "the fp32 walk fills the bf16 walk's shared memory");

// T (the operand type of a walk, __nv_bfloat16 or float) as a flag.
template <class T>
constexpr bool kF32 = std::is_same<T, float>::value;

// Keeps a template argument out of deduction (a nullptr argument, say).
template <class T>
struct NoDeduce { using type = T; };

// The int8 walk's layouts inside those buffers, in bytes. Activations:
// kRows rows of kQLd (68 words: the 8 rows x 4 words of one fragment load
// fall on distinct banks). Staged weights: OUTPUT-major, one row per output
// channel holding a kWChunk-deep slice of its input axis, so both MMA
// operands are contiguous along the reduction (kQWLd = 20 words: the same).
// WMMA wants int8 leading dimensions in multiples of 16.
typedef signed char q8;
constexpr int kQLd = kMaxWidth + 16;
constexpr int kQWLd = kWChunk + 16;
static_assert(kQLd % 16 == 0 && kQWLd % 16 == 0, "int8 WMMA leading dims");
static_assert((size_t)kRows * kQLd <= kABytes, "int8 tile fits a bf16 tile");
static_assert((size_t)2 * kMaxWidth * kQWLd <= kWBytes,
              "two int8 weight chunks fit the bf16 staging buffer");

// dense_layer's split of a (kRows x 256) output into 16x16 tiles: eight
// warp columns own two column tiles each (c and c + 8); kWarps / 8 warp rows
// split the kRows / 16 row blocks.
constexpr int kWarpRows = kWarps / 8;
constexpr int kRowBlocksPerWarp = kRows / 16 / kWarpRows;
static_assert(kWarps % 8 == 0 && kRows % (16 * kWarpRows) == 0,
              "dense_layer: whole row blocks per warp");

// One walk's parameters, passed to the kernel by value; T is the operand
// type of its weights (and of the activations it feeds the products).
template <class T>
struct WalkDescT {
  int n;                 // dense layers
  int d_enc;             // true encoded width (input LayerNorm statistics)
  int d_out;             // true output width (output LayerNorm statistics)
  int act, last_act;     // 0 = none, 1 = relu
  int has_li, has_lo;
  int pd[kMaxLayers + 1];                   // padded widths, multiples of 16
  const T* w[kMaxLayers];                   // (pd[i], pd[i+1]) input-major
  const float* b[kMaxLayers];               // (pd[i+1])
  const float* ln;       // li_a (pd[0]), li_b (pd[0]), lo_a (pd[n]), lo_b (pd[n])
  const float* plan;     // 3 rows of pd[0]: source index, frequency, kind
};
using WalkDesc = WalkDescT<__nv_bfloat16>;

// Host side: meta = [n, d_enc, d_out, act, last_act, has_li, has_lo,
// pd[0..n], w_off[0..n-1], b_off[0..n-1]] (offsets in elements).
// Returns 0, or a negative code for a walk the kernels do not take.
template <class T>
inline int fill_walk(WalkDescT<T>* d, const int* meta, const void* w_all,
                     const void* b_all, const void* ln, const void* plan) {
  d->n = meta[0];
  if (d->n < 1 || d->n > kMaxLayers) return -101;
  d->d_enc = meta[1];
  d->d_out = meta[2];
  d->act = meta[3];
  d->last_act = meta[4];
  d->has_li = meta[5];
  d->has_lo = meta[6];
  const int* pd = meta + 7;
  for (int i = 0; i <= d->n; ++i) {
    if (pd[i] <= 0 || pd[i] > kMaxWidth || pd[i] % 16 != 0) return -102;
    d->pd[i] = pd[i];
  }
  const int* w_off = pd + d->n + 1;
  const int* b_off = w_off + d->n;
  for (int i = 0; i < d->n; ++i) {
    if (w_off[i] % 16 != 0) return -103;
    d->w[i] = static_cast<const T*>(w_all) + w_off[i];
    d->b[i] = static_cast<const float*>(b_all) + b_off[i];
  }
  d->ln = static_cast<const float*>(ln);
  d->plan = static_cast<const float*>(plan);
  return 0;
}

// One walk's int8 form (ops/fused_mlp.py pack_walk_q), beside its WalkDesc.
struct WalkQuant {
  const q8* w[kMaxLayers];       // (pd[i+1], pd[i]) OUTPUT-major int8
  const float* inv[kMaxLayers];  // (pd[i]) 127 / amax per input column, 0 dead
  const float* dq[kMaxLayers];   // (pd[i+1]) per-output-channel dequant scale
};

// Host side: the three packed buffers against the walk's meta row. The int8
// weights sit at the bf16 weights' element offsets, the dequant rows at the
// bias offsets, the inverse-scale rows back to back.
template <class T>
inline int fill_walk_quant(WalkQuant* q, const WalkDescT<T>& d, const int* meta,
                           const void* wq_all, const void* inv_all,
                           const void* dq_all) {
  if (!wq_all || !inv_all || !dq_all) return -105;
  const int* w_off = meta + 7 + d.n + 1;
  const int* b_off = w_off + d.n;
  int inv_off = 0;
  for (int i = 0; i < d.n; ++i) {
    q->w[i] = static_cast<const q8*>(wq_all) + w_off[i];
    q->inv[i] = static_cast<const float*>(inv_all) + inv_off;
    q->dq[i] = static_cast<const float*>(dq_all) + b_off[i];
    inv_off += d.pd[i];
  }
  return 0;
}

template <class T>
struct WalkSmemT {
  T* A[2];                // layer inputs (fp32: both alias C)
  float* C;
  T* W;
  unsigned char* extra;   // first byte after the walk's buffers
};
using WalkSmem = WalkSmemT<__nv_bfloat16>;

template <class T = __nv_bfloat16>
__device__ __forceinline__ WalkSmemT<T> walk_smem(unsigned char* base) {
  WalkSmemT<T> s;
  if constexpr (kF32<T>) {
    s.C = reinterpret_cast<float*>(base);
    s.A[0] = s.A[1] = s.C;
    s.W = reinterpret_cast<float*>(base + kCBytes);
  } else {
    s.A[0] = reinterpret_cast<__nv_bfloat16*>(base);
    s.A[1] = reinterpret_cast<__nv_bfloat16*>(base + kABytes);
    s.C = reinterpret_cast<float*>(base + 2 * kABytes);
    s.W = reinterpret_cast<__nv_bfloat16*>(base + 2 * kABytes + kCBytes);
  }
  s.extra = base + kWalkSmem;
  return s;
}

// The int8 walk's buffers beside compute of operand type Op. bf16: the
// bf16 walk's. fp32 (an fp32 epilogue after run_walk_q): C first, where the
// fp32 walk keeps it, then the two int8 activation tiles and the int8 weight
// chunks in the bytes that the fp32 walk's staged weights take afterwards;
// the int8 walk's fp32 output is left in the C of walk_smem<float>.
template <class Op>
__device__ __forceinline__ WalkSmem walk_smem_q(unsigned char* base) {
  if constexpr (kF32<Op>) {
    WalkSmem s;
    s.C = reinterpret_cast<float*>(base);
    s.A[0] = reinterpret_cast<__nv_bfloat16*>(base + kCBytes);
    s.A[1] = reinterpret_cast<__nv_bfloat16*>(base + kCBytes + kABytes);
    s.W = reinterpret_cast<__nv_bfloat16*>(base + kCBytes + 2 * kABytes);
    s.extra = base + kWalkSmem;
    return s;
  } else {
    return walk_smem(base);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A value as the walk of operand type T holds it: rounded to bf16, or fp32
// as it is.
template <class T>
__device__ __forceinline__ float act_round(float x) {
  if constexpr (kF32<T>) return x;
  else return bf16_round(x);
}
template <class T>
__device__ __forceinline__ T to_act(float x) {
  if constexpr (kF32<T>) return x;
  else return __float2bfloat16_rn(x);
}

// Eight consecutive values (16 B of bf16, 32 B of fp32) to / from fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  __align__(16) __nv_bfloat16 h[8];
  *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
}
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(v + 4) = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  __align__(16) __nv_bfloat16 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = __float2bfloat16_rn(v[e]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(v);
  *reinterpret_cast<float4*>(p + 4) = *reinterpret_cast<const float4*>(v + 4);
}

// ------------------------------------------------------------ products ----
//
// One warp-level product step per operand type: fragments of A (16 x kStep,
// layout LA) and B (kStep x 16, row-major) from shared memory, accumulated
// into a 16 x 16 fp32 fragment. bf16: one m16n16k16 MMA. fp32: 3xTF32 on
// m16n16k8 (see the header): the split happens once per fragment load.
template <class T, class LA = nvcuda::wmma::row_major>
struct Mma;

template <class LA>
struct Mma<__nv_bfloat16, LA> {
  static constexpr int kStep = 16;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;
  struct A {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16,
                           __nv_bfloat16, LA> f;
  };
  struct B {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16,
                           __nv_bfloat16, nvcuda::wmma::row_major> f;
  };
  static __device__ __forceinline__ void load(A& a, const __nv_bfloat16* p,
                                              int ld) {
    nvcuda::wmma::load_matrix_sync(a.f, p, ld);
  }
  static __device__ __forceinline__ void load(B& b, const __nv_bfloat16* p,
                                              int ld) {
    nvcuda::wmma::load_matrix_sync(b.f, p, ld);
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
    nvcuda::wmma::mma_sync(c, a.f, b.f, c);
  }
};

// hi = tf32(x), lo = tf32(x - hi) for every element of a loaded fragment.
template <class F>
__device__ __forceinline__ void split_tf32(F& hi, F& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float x = hi.x[t];
    const float h = nvcuda::wmma::__float_to_tf32(x);
    hi.x[t] = h;
    lo.x[t] = nvcuda::wmma::__float_to_tf32(x - h);
  }
}

// c += a * b as 3xTF32: the two cross terms first (the small ones), then
// hi * hi. The tensor cores add into their accumulator rounding toward zero;
// over a reduction of thousands of steps (a walk's dX, wgrad's tokens) that
// bias adds up and, where a gradient sums many terms that cancel, reads as
// 1e-3 or more. So each step's three products accumulate into a fresh
// fragment, which joins c by fp32 adds that round to nearest.
template <class Acc, class FA, class FB>
__device__ __forceinline__ void mma_3xtf32(Acc& c, const FA& a_hi,
                                           const FA& a_lo, const FB& b_hi,
                                           const FB& b_lo) {
  Acc t;
  nvcuda::wmma::fill_fragment(t, 0.f);
  nvcuda::wmma::mma_sync(t, a_lo, b_hi, t);
  nvcuda::wmma::mma_sync(t, a_hi, b_lo, t);
  nvcuda::wmma::mma_sync(t, a_hi, b_hi, t);
#pragma unroll
  for (int i = 0; i < t.num_elements; ++i) c.x[i] = __fadd_rn(c.x[i], t.x[i]);
}

template <class LA>
struct Mma<float, LA> {
  static constexpr int kStep = 8;
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 8,
                                     float>;
  struct A {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 8,
                           nvcuda::wmma::precision::tf32, LA> hi, lo;
  };
  struct B {
    nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 8,
                           nvcuda::wmma::precision::tf32,
                           nvcuda::wmma::row_major> hi, lo;
  };
  static __device__ __forceinline__ void load(A& a, const float* p, int ld) {
    nvcuda::wmma::load_matrix_sync(a.hi, p, ld);
    split_tf32(a.hi, a.lo);
  }
  static __device__ __forceinline__ void load(B& b, const float* p, int ld) {
    nvcuda::wmma::load_matrix_sync(b.hi, p, ld);
    split_tf32(b.hi, b.lo);
  }
  static __device__ __forceinline__ void mma(Acc& c, const A& a, const B& b) {
    mma_3xtf32(c, a.hi, a.lo, b.hi, b.lo);
  }
};

// One posenc column (nn/posenc.py layout): the raw value itself, or
// sin / cos of value * frequency. Precise sinf/cosf: frequencies reach 2^5
// on coordinates scaled by 10, so the fast intrinsics would lose the phase.
// Neighbouring lanes hold sin and cos columns: one sincosf per lane keeps
// the warp on a single path instead of running sinf and cosf both.
__device__ __forceinline__ float encode_value(float x, float freq, int kind) {
  if (kind == 0) return x;
  float s, c;
  sincosf(x * freq, &s, &c);
  return kind == 1 ? s : c;
}

// Encoded columns of a walk from raw feature rows: x is (R, d_raw) row-major,
// the block's rows are r0 .. r0 + kRows - 1 (rows past R and pad lanes
// encode as 0). Each lane reads its columns' plan once and walks the rows.
template <class T>
__device__ __forceinline__ void encode_raw(float* C, const WalkDescT<T>& d,
                                           const float* __restrict__ x,
                                           int r0, int R, int d_raw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pd0 = d.pd[0];
  for (int c = lane; c < pd0; c += 32) {
    const bool live = c < d.d_enc;
    const int src = live ? (int)d.plan[c] : 0;
    const float freq = live ? d.plan[pd0 + c] : 0.f;
    const int kind = live ? (int)d.plan[2 * pd0 + c] : 0;
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + i * kWarps, row = r0 + r;
      C[r * kCLd + c] = live && row < R
          ? encode_value(x[(size_t)row * d_raw + src], freq, kind) : 0.f;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Row-wise LayerNorm of C's first n_true lanes (one warp per row), written
// in the walk's operand type into A (out_bf16; fp32: A is C) or back into
// C; pad lanes up to pd become 0. With mu_out / r_out the per-row mean and
// 1 / (std + eps) are kept for a backward pass.
template <class T>
__device__ __forceinline__ void layernorm_rows(float* C, T* A,
                                               bool out_bf16, int n_true,
                                               int pd, const float* a,
                                               const float* b,
                                               float* mu_out = nullptr,
                                               float* r_out = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = C + r * kCLd;
    float s = 0.f;
    for (int c = lane; c < n_true; c += 32) s += row[c];
    const float mu = warp_sum(s) / (float)n_true;
    float v = 0.f;
    for (int c = lane; c < n_true; c += 32) {
      const float dv = row[c] - mu;
      v += dv * dv;
    }
    const float var = warp_sum(v) / (float)(n_true > 1 ? n_true - 1 : 1);
    const float rr = 1.f / (sqrtf(var) + kLnEps);
    if (mu_out && lane == 0) {
      mu_out[r] = mu;
      r_out[r] = rr;
    }
    for (int c = lane; c < pd; c += 32) {
      const float y = c < n_true ? (row[c] - mu) * rr * a[c] + b[c] : 0.f;
      if (out_bf16) A[r * kALd + c] = to_act<T>(y);
      else row[c] = y;
    }
  }
}

// C's fp32 tile as the next product's operand in A: rounded to bf16; the
// fp32 walk's A is C itself, so nothing moves.
template <class T>
__device__ __forceinline__ void to_bf16(const float* C, T* A, int pd) {
  if constexpr (!kF32<T>) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < kRows; r += kWarps)
      for (int c = lane; c < pd; c += 32)
        A[r * kALd + c] = __float2bfloat16_rn(C[r * kCLd + c]);
  }
}

// Stage weight rows [k0, k0 + rows) of W (pd_out wide) into dst, 16 bytes
// per cp.async, as one commit group. vshift = log2(pd_out / (16 B of T))
// when that is a power of two (every width of the flagship), else -1.
template <class T>
__device__ __forceinline__ void load_w_chunk(T* dst, const T* W, int k0,
                                             int rows, int pd_out,
                                             int vshift) {
  constexpr int kV = 16 / sizeof(T);     // elements per 16-byte vector
  const int vpr = pd_out / kV;
  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {
    const int r = vshift >= 0 ? v >> vshift : v / vpr;
    const int c = (v - r * vpr) * kV;
    cp_async16(dst + r * kWLd + c, W + (size_t)(k0 + r) * pd_out + c);
  }
  cp_async_commit();
}

// One dense layer: C[:, :pd_out] = A_in[:, :pd_in] @ W (+ bias, act).
// W is staged chunk by chunk into shared memory and read by every warp.
// Warp w owns the 16-wide column tiles w % 8 and w % 8 + 8 for its
// kRowBlocksPerWarp 16-row blocks, so each reduction step (Mma<T>::kStep
// deep) loads kRowBlocksPerWarp A and 2 B fragments for
// 2 * kRowBlocksPerWarp products.
// Epilogue per warp, on its own tiles only: bias and activation, then either
// rounded to bf16 into A_out (the next layer's input) or kept fp32 in C. The
// fp32 walk reads and writes C in place (A_in, A_out alias C): the
// accumulators are stored only after the chunk loop's last barrier.
// A_out / C are complete for other warps only after the caller's barrier;
// the first barrier inside the next dense_layer serves for chained layers.
template <class T>
__device__ __forceinline__ void dense_layer(const T* A_in, float* C,
                                            typename NoDeduce<T>::type* A_out,
                                            T* wbuf, const T* __restrict__ W,
                                            const float* __restrict__ bias,
                                            int pd_in, int pd_out, int act) {
  using M = Mma<T>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp & 7;                             // column tiles wc, wc + 8
  const int rb0 = (warp >> 3) * kRowBlocksPerWarp;     // first row block
  const int nct = pd_out >> 4;
  const bool has0 = wc < nct, has1 = wc + 8 < nct;
  const int vpr = pd_out / (16 / (int)sizeof(T));
  const int vshift = (vpr & (vpr - 1)) == 0 ? __ffs(vpr) - 1 : -1;
  typename M::Acc acc[kRowBlocksPerWarp][2];
#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i) {
    nvcuda::wmma::fill_fragment(acc[i][0], 0.f);
    nvcuda::wmma::fill_fragment(acc[i][1], 0.f);
  }

  const int nchunks = (pd_in + kWChunk - 1) / kWChunk;
  load_w_chunk(wbuf, W, 0, min(kWChunk, pd_in), pd_out, vshift);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      const int k1 = (ch + 1) * kWChunk;
      load_w_chunk(wbuf + ((ch + 1) & 1) * kWChunk * kWLd, W, k1,
                   min(kWChunk, pd_in - k1), pd_out, vshift);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* wb = wbuf + (ch & 1) * kWChunk * kWLd;
    const int rows = min(kWChunk, pd_in - ch * kWChunk);
    // One reduction step: kRowBlocksPerWarp A and two B fragments.
    auto step = [&](int kk) {
      typename M::A fa[kRowBlocksPerWarp];
#pragma unroll
      for (int i = 0; i < kRowBlocksPerWarp; ++i)
        M::load(fa[i], A_in + (rb0 + i) * 16 * kALd + ch * kWChunk + kk, kALd);
      typename M::B fb;
      M::load(fb, wb + kk * kWLd + wc * 16, kWLd);
#pragma unroll
      for (int i = 0; i < kRowBlocksPerWarp; ++i) M::mma(acc[i][0], fa[i], fb);
      if (has1) {
        M::load(fb, wb + kk * kWLd + (wc + 8) * 16, kWLd);
#pragma unroll
        for (int i = 0; i < kRowBlocksPerWarp; ++i)
          M::mma(acc[i][1], fa[i], fb);
      }
    };
    if (has0) {
      // A full chunk unrolls at compile time, so the scheduler can issue a
      // step's fragment loads under the previous step's MMAs.
      if (rows == kWChunk) {
#pragma unroll
        for (int kk = 0; kk < kWChunk; kk += M::kStep) step(kk);
      } else {
        for (int kk = 0; kk < rows; kk += M::kStep) step(kk);
      }
    }
    __syncthreads();
  }
  if (!has0) return;

#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j == 0 || has1)
        nvcuda::wmma::store_matrix_sync(
            C + (rb0 + i) * 16 * kCLd + (wc + 8 * j) * 16, acc[i][j], kCLd,
            nvcuda::wmma::mem_row_major);
  __syncwarp();
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i) {
    const int r = (rb0 + i) * 16 + (lane >> 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !has1) continue;
      const int col = (wc + 8 * j) * 16 + c0;
      float* p = C + r * kCLd + col;
      float v[8];
      load8(p, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (bias) v[e] += bias[col + e];
        if (act == 1) v[e] = fmaxf(v[e], 0.f);
      }
      if constexpr (kF32<T>) {
        store8(p, v);              // fp32: the next layer reads C unrounded
      } else if (A_out) {
        store8(A_out + r * kALd + col, v);
      } else {
        store8(p, v);
      }
    }
  }
}

// Runs a walk on the encoded fp32 tile in C (pad lanes zero). The output
// (pd[n] lanes) is left fp32 in C, or, with out_bf16, as the next product's
// operand in A[0] (bf16: rounded there by the output LayerNorm; fp32: C
// itself); ends on a barrier.
template <class T>
__device__ __forceinline__ void run_walk(const WalkSmemT<T>& s,
                                         const WalkDescT<T>& d,
                                         bool out_bf16 = false) {
  const int pd0 = d.pd[0], pdn = d.pd[d.n];
  if (d.has_li) layernorm_rows(s.C, s.A[0], true, d.d_enc, pd0, d.ln, d.ln + pd0);
  else to_bf16(s.C, s.A[0], pd0);
  __syncthreads();
  int cur = 0;
  for (int l = 0; l < d.n; ++l) {
    const bool last = l + 1 == d.n;
    dense_layer(s.A[cur], s.C, last ? nullptr : s.A[cur ^ 1], s.W, d.w[l],
                d.b[l], d.pd[l], d.pd[l + 1], last ? d.last_act : d.act);
    cur ^= 1;
  }
  __syncthreads();
  if (d.has_lo) {
    const float* lo = d.ln + 2 * pd0;
    layernorm_rows(s.C, s.A[0], out_bf16, d.d_out, pdn, lo, lo + pdn);
    __syncthreads();
  } else if (out_bf16) {
    to_bf16(s.C, s.A[0], pdn);
    __syncthreads();
  }
}

// ------------------------------------------------------------ int8 walk ----

// clip(round(h * inv), +-127): round half to even (__float2int_rn, as
// jnp.round); the clamp runs in float first, so a NaN or a product beyond
// the int range clamps instead of wrapping. The product is a separate
// multiply (no contraction), as the plain version's.
__device__ __forceinline__ q8 quantize_value(float h, float inv) {
  const float t = fminf(fmaxf(__fmul_rn(h, inv), -127.f), 127.f);
  return (q8)__float2int_rn(t);
}

// Quantize the fp32 tile C[:, :pd] into the int8 tile Q, four columns a
// thread; qv(r, c, h) gives one value. Pad lanes of C are zero on entry.
template <class QV>
__device__ __forceinline__ void quantize_tile(const float* C, q8* Q, int pd,
                                              QV qv) {
  const int vpr = pd >> 2;
  for (int i = threadIdx.x; i < kRows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) << 2;
    const float4 h = *reinterpret_cast<const float4*>(C + r * kCLd + c);
    char4 q;
    q.x = qv(r, c, h.x);
    q.y = qv(r, c + 1, h.y);
    q.z = qv(r, c + 2, h.z);
    q.w = qv(r, c + 3, h.w);
    *reinterpret_cast<char4*>(Q + r * kQLd + c) = q;
  }
}

// Stage input slice [k0, k0 + depth) of every output channel's int8 weights
// (Wt is (pd_out, pd_in) output-major) into dst, 16 bytes per cp.async, as
// one commit group. depth is a multiple of 16.
__device__ __forceinline__ void load_wq_chunk(q8* dst, const q8* Wt, int k0,
                                              int depth, int pd_in,
                                              int pd_out) {
  const int vpr = depth >> 4;            // 16 int8 per 16-byte vector
  for (int v = threadIdx.x; v < pd_out * vpr; v += kThreads) {
    const int n = v / vpr;
    const int c16 = (v - n * vpr) << 4;
    cp_async16(dst + n * kQWLd + c16, Wt + (size_t)n * pd_in + k0 + c16);
  }
  cp_async_commit();
}

// One int8 dense layer: acc[:, :pd_out] = Q_in[:, :pd_in] @ W as int32, with
// the warp tiling and the chunked weight staging of dense_layer (WMMA
// m16n16k16, signed char A row-major x signed char B column-major -> int).
// The epilogue runs per warp on its own tiles: each lane gets 8 consecutive
// accumulators of one row as epi(r, col, acc, crow), crow pointing at their
// place in C (acc aliases it: read acc before writing crow). What the
// epilogue writes is complete for other warps only after the caller's
// barrier; the first barrier inside the next dense_layer_q serves for
// chained layers. Q_in is free for reuse once the epilogue runs (every
// warp's last MMA precedes the loop's final barrier).
template <class Epi>
__device__ __forceinline__ void dense_layer_q(const q8* Q_in, float* C,
                                              q8* wbuf,
                                              const q8* __restrict__ Wt,
                                              int pd_in, int pd_out, Epi epi) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wc = warp & 7;
  const int rb0 = (warp >> 3) * kRowBlocksPerWarp;
  const int nct = pd_out >> 4;
  const bool has0 = wc < nct, has1 = wc + 8 < nct;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[kRowBlocksPerWarp][2];
#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i) {
    wmma::fill_fragment(acc[i][0], 0);
    wmma::fill_fragment(acc[i][1], 0);
  }

  const int nchunks = (pd_in + kWChunk - 1) / kWChunk;
  load_wq_chunk(wbuf, Wt, 0, min(kWChunk, pd_in), pd_in, pd_out);
  for (int ch = 0; ch < nchunks; ++ch) {
    if (ch + 1 < nchunks) {
      const int k1 = (ch + 1) * kWChunk;
      load_wq_chunk(wbuf + ((ch + 1) & 1) * kMaxWidth * kQWLd, Wt, k1,
                    min(kWChunk, pd_in - k1), pd_in, pd_out);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const q8* wb = wbuf + (ch & 1) * kMaxWidth * kQWLd;
    const int depth = min(kWChunk, pd_in - ch * kWChunk);
    auto step = [&](int kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, q8, wmma::row_major> fa[kRowBlocksPerWarp];
#pragma unroll
      for (int i = 0; i < kRowBlocksPerWarp; ++i)
        wmma::load_matrix_sync(
            fa[i], Q_in + (rb0 + i) * 16 * kQLd + ch * kWChunk + kk, kQLd);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, q8, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, wb + wc * 16 * kQWLd + kk, kQWLd);
#pragma unroll
      for (int i = 0; i < kRowBlocksPerWarp; ++i)
        wmma::mma_sync(acc[i][0], fa[i], fb, acc[i][0]);
      if (has1) {
        wmma::load_matrix_sync(fb, wb + (wc + 8) * 16 * kQWLd + kk, kQWLd);
#pragma unroll
        for (int i = 0; i < kRowBlocksPerWarp; ++i)
          wmma::mma_sync(acc[i][1], fa[i], fb, acc[i][1]);
      }
    };
    if (has0) {
      if (depth == kWChunk) {
#pragma unroll
        for (int kk = 0; kk < kWChunk; kk += 16) step(kk);
      } else {
        for (int kk = 0; kk < depth; kk += 16) step(kk);
      }
    }
    __syncthreads();
  }
  if (!has0) return;

  int* Ci = reinterpret_cast<int*>(C);
#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j == 0 || has1)
        wmma::store_matrix_sync(Ci + (rb0 + i) * 16 * kCLd + (wc + 8 * j) * 16,
                                acc[i][j], kCLd, wmma::mem_row_major);
  __syncwarp();
  const int c0 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < kRowBlocksPerWarp; ++i) {
    const int r = (rb0 + i) * 16 + (lane >> 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && !has1) continue;
      const int col = (wc + 8 * j) * 16 + c0;
      int a[8];
      *reinterpret_cast<int4*>(a) =
          *reinterpret_cast<const int4*>(Ci + r * kCLd + col);
      *reinterpret_cast<int4*>(a + 4) =
          *reinterpret_cast<const int4*>(Ci + r * kCLd + col + 4);
      epi(r, col, a, C + r * kCLd + col);
    }
  }
}

// The walk's own epilogue: z = acc * dq + b (a multiply, then an add, as the
// plain version rounds them), the activation, then either quantized for the
// next layer (inv_next) into Q_out or kept fp32 in C.
__device__ __forceinline__ void walk_q_epilogue(int r, int col, const int* a,
                                                float* crow,
                                                const float* __restrict__ dq,
                                                const float* __restrict__ bias,
                                                int act,
                                                const float* __restrict__ inv_next,
                                                q8* Q_out) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = __fadd_rn(__fmul_rn((float)a[e], dq[col + e]), bias[col + e]);
    if (act == 1) v[e] = fmaxf(v[e], 0.f);
  }
  if (inv_next) {
    __align__(8) q8 q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) q[e] = quantize_value(v[e], inv_next[col + e]);
    *reinterpret_cast<uint2*>(Q_out + r * kQLd + col) =
        *reinterpret_cast<const uint2*>(q);
  } else {
    *reinterpret_cast<float4*>(crow) = *reinterpret_cast<const float4*>(v);
    *reinterpret_cast<float4*>(crow + 4) = *reinterpret_cast<const float4*>(v + 4);
  }
}

// Runs the int8 walk on the encoded fp32 tile in C (pad lanes zero); output
// as run_walk: fp32 in C, or, with out_bf16, rounded to bf16 into A[0]; ends
// on a barrier. T is the operand type of the walk's description, whose
// biases, LayerNorms and widths the int8 walk reads (its weights: q's).
template <class T>
__device__ __forceinline__ void run_walk_q(const WalkSmem& s,
                                           const WalkDescT<T>& d,
                                           const WalkQuant& q,
                                           bool out_bf16 = false) {
  const int pd0 = d.pd[0], pdn = d.pd[d.n];
  q8* Q[2] = {reinterpret_cast<q8*>(s.A[0]), reinterpret_cast<q8*>(s.A[1])};
  q8* wbuf = reinterpret_cast<q8*>(s.W);
  if (d.has_li) {
    layernorm_rows<__nv_bfloat16>(s.C, nullptr, false, d.d_enc, pd0, d.ln,
                                  d.ln + pd0);
    __syncthreads();
  }
  {
    const float* inv0 = q.inv[0];
    quantize_tile(s.C, Q[0], pd0, [&](int, int c, float h) {
      return quantize_value(h, inv0[c]);
    });
  }
  int cur = 0;
  for (int l = 0; l < d.n; ++l) {
    const bool last = l + 1 == d.n;
    const float* dq = q.dq[l];
    const float* bias = d.b[l];
    const float* inv_next = last ? nullptr : q.inv[l + 1];
    const int act = last ? d.last_act : d.act;
    q8* Q_out = Q[cur ^ 1];
    dense_layer_q(Q[cur], s.C, wbuf, q.w[l], d.pd[l], d.pd[l + 1],
                  [&](int r, int col, const int* a, float* crow) {
                    walk_q_epilogue(r, col, a, crow, dq, bias, act, inv_next,
                                    Q_out);
                  });
    cur ^= 1;
  }
  __syncthreads();
  if (d.has_lo) {
    const float* lo = d.ln + 2 * pd0;
    layernorm_rows(s.C, s.A[0], out_bf16, d.d_out, pdn, lo, lo + pdn);
    __syncthreads();
  } else if (out_bf16) {
    to_bf16(s.C, s.A[0], pdn);
    __syncthreads();
  }
}

}  // namespace papr
