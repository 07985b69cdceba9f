// Weight-gradient reduction of the walk backwards, and the column-sum
// reduction of their per-block partial sums.
//
// The TPU backward kernels (papr_tpu/ops/fused_mlp.py::_bwd_kernel :424,
// stream_attn.py::_ksr_bwd_kernel :835 and _vsr_bwd_kernel :1634) add each
// grid step's hs_i^T dz_i into an output block that stays resident across
// the sequential grid. CUDA blocks run in no order, so the walk backwards
// stash hs_i and dz_i (bf16, or fp32 for use_amp: false) in device memory
// and this kernel forms dW_i = sum_n hs_i[n]^T dz_i[n] over every token n
// afterwards.
//
// What bounds it on the H100: the stash read, (da + db) * 2 B a token for
// 2 * da * db FLOP (bf16: 128 FLOP/B at 256 x 256, under the card's ~295:
// bound by bytes); fp32 3xTF32: three TF32 products a token (bound by
// operations). What the design does about it: split-K over token ranges,
// one block per range and 128-row output tile, ~one block per SM. A
// producer warp streams the range's H and DZ tiles with TMA into a ring of
// shared-memory stages (mbarrier full / empty pairs); two consumer
// warpgroups each own 64 output rows and all of the tile's columns in
// registers (wgmma m64nN, N up to 256), so a token slice is read from L2 by
// at most ceil(da / 128) * ceil(db / N) blocks, once at 256 x 256 for H.
//  - bf16: H (N, da) is the MN-major A (a contiguous) and DZ the MN-major
//    B of a bf16 wgmma, straight from TMA's 128-byte-swizzled tiles.
//  - fp32: wgmma on tf32 takes K-major operands only, so the consumers
//    split each landed fp32 tile into hi = tf32(x), lo = tf32(x - hi)
//    while transposing it into K-major swizzled tiles, then run lo*hi,
//    hi*lo, hi*hi (walk.cuh's 3xTF32). Each 32-token stage accumulates into
//    a fresh accumulator that joins the fp32 sums by round-to-nearest adds
//    (the tensor cores' own accumulator rounds toward zero).
// The fp32 partial tiles of the ranges are summed by colsum_kernel in a fixed
// order, so two runs are bit-equal.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace papr;

constexpr int kThreadsW = 384;        // two consumer warpgroups + producer
constexpr int kTileA = 128;           // output rows per block
constexpr int kSwBytes = 1024;        // 128-byte swizzle atom

// bf16: 64-token stages of 128-byte rows (64 elements), four in flight.
constexpr int kKB16 = 64;
constexpr int kStages16 = 4;
constexpr int kBox16 = kKB16 * 64 * 2;          // one 64-wide box, bytes

// fp32: 32-token stages; the raw tiles as TMA lands them (row-major, no
// swizzle), then the K-major hi / lo tiles (32 tf32 = 128 B a row).
constexpr int kKB32 = 32;
constexpr int kStages32 = 3;

template <int BN>
__host__ __device__ constexpr int stage_bytes16() { return (2 + BN / 64) * kBox16; }
template <int BN>
__host__ __device__ constexpr int stage_bytes32() { return (2 * 64 + BN) * kKB32 * 4; }
template <int BN>
constexpr size_t smem16() {
  return kSwBytes + (size_t)kStages16 * stage_bytes16<BN>() + 64;
}
template <int BN>
constexpr size_t smem32() {
  return kSwBytes + (size_t)kStages32 * stage_bytes32<BN>()
         + 2 * (2 * 64 * 128)          // A hi / lo of each warpgroup
         + 2 * (2 * BN * 128)          // B hi / lo, double-buffered
         + 64;
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kSwBytes - (a & (kSwBytes - 1))) & (kSwBytes - 1));
}

// The consumer's output tile: rows a0 + 16 * warp + lane / 4 (+ 8), columns
// b0 + 8 j + 2 (lane % 4) (+ 1), the wgmma accumulator layout.
template <int NR>
__device__ __forceinline__ void store_tile(const float (&acc)[NR], int a0,
                                           int b0, int da, int db,
                                           float* __restrict__ out) {
  const int t = threadIdx.x & 127, w = t >> 5, l = t & 31;
  const int r = a0 + 16 * w + (l >> 2);
#pragma unroll
  for (int j = 0; j < NR / 4; ++j) {
    const int c = b0 + 8 * j + 2 * (l & 3);
    if (c >= db) continue;
    if (r < da)
      *reinterpret_cast<float2*>(out + (size_t)r * db + c) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < da)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * db + c) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// bf16: part[split] (da, db) = H[range]^T DZ[range] for the block's tile.
template <int BN>
__global__ void __launch_bounds__(kThreadsW, 1)
wgrad_bf16_kernel(const __grid_constant__ CUtensorMap hmap,
                  const __grid_constant__ CUtensorMap dmap, int N, int da,
                  int db, int n_per_split, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  constexpr int SB = stage_bytes16<BN>();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages16 * SB);
  uint64_t* empty = full + kStages16;

  const int tiles_b = (db + BN - 1) / BN;
  const int a0 = (blockIdx.x / tiles_b) * kTileA;
  const int b0 = (blockIdx.x % tiles_b) * BN;
  const int n0 = blockIdx.y * n_per_split;
  const int n1 = min(N, n0 + n_per_split);
  const int steps = n1 > n0 ? (n1 - n0 + kKB16 - 1) / kKB16 : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages16; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                                   // producer
    if (threadIdx.x == 256) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kStages16, round = s / kStages16;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* base = smem + st * SB;
        mbar_expect_tx(&full[st], SB);
        const int n = n0 + s * kKB16;
        tma_load_2d(base, &hmap, a0, n, &full[st]);
        tma_load_2d(base + kBox16, &hmap, a0 + 64, n, &full[st]);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_2d(base + (2 + j) * kBox16, &dmap, b0 + 64 * j, n,
                      &full[st]);
      }
    }
  } else {                                         // consumers
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages16;
      mbar_wait(&full[st], (s / kStages16) & 1);
      const unsigned char* base = smem + st * SB;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKB16 / 16; ++j) {
        // 16 tokens = 16 rows of 128 B: two swizzle atoms.
        const uint64_t dA = sw128_desc(base + wg * kBox16 + j * 2048,
                                       kBox16, kSwBytes);
        const uint64_t dB = sw128_desc(base + 2 * kBox16 + j * 2048,
                                       kBox16, kSwBytes);
        wgmma_ss_bf16<BN>(acc, dA, dB, 1);
      }
      wgmma_commit();
      reg_fence(acc);
      wgmma_wait<1>();
      // The previous stage's products are done: hand its slot back.
      if (s > 0 && (threadIdx.x & 127) == 0)
        mbar_arrive(&empty[(s - 1) % kStages16]);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    store_tile(acc, a0 + 64 * wg, b0, da, db,
               part + (size_t)blockIdx.y * da * db);
  }
}

// fp32 (3xTF32): the same tiling on 32-token stages. The consumers split and
// transpose each landed tile into K-major hi / lo tiles, then run the three
// products into a fresh accumulator per stage.
template <int BN>
__global__ void __launch_bounds__(kThreadsW, 1)
wgrad_f32_kernel(const __grid_constant__ CUtensorMap hmap,
                 const __grid_constant__ CUtensorMap dmap, int N, int da,
                 int db, int n_per_split, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  constexpr int SB = stage_bytes32<BN>();
  constexpr int kHBox = 64 * kKB32 * 4;           // one warpgroup's H tile
  unsigned char* conv = smem + kStages32 * SB;    // 1024-aligned (SB is)
  unsigned char* a_hi = conv;                     // [wg] 64 rows x 128 B
  unsigned char* a_lo = conv + 2 * 64 * 128;
  unsigned char* b_hi = conv + 4 * 64 * 128;      // [buf] BN rows x 128 B
  unsigned char* b_lo = b_hi + 2 * BN * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_lo + 2 * BN * 128);
  uint64_t* empty = full + kStages32;

  const int tiles_b = (db + BN - 1) / BN;
  const int a0 = (blockIdx.x / tiles_b) * kTileA;
  const int b0 = (blockIdx.x % tiles_b) * BN;
  const int n0 = blockIdx.y * n_per_split;
  const int n1 = min(N, n0 + n_per_split);
  const int steps = n1 > n0 ? (n1 - n0 + kKB32 - 1) / kKB32 : 0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages32; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                                   // producer
    if (threadIdx.x == 256) {
      for (int s = 0; s < steps; ++s) {
        const int st = s % kStages32, round = s / kStages32;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        unsigned char* base = smem + st * SB;
        mbar_expect_tx(&full[st], SB);
        const int n = n0 + s * kKB32;
        tma_load_2d(base, &hmap, a0, n, &full[st]);
        tma_load_2d(base + kHBox, &hmap, a0 + 64, n, &full[st]);
        tma_load_2d(base + 2 * kHBox, &dmap, b0, n, &full[st]);
      }
    }
  } else {                                         // consumers
    const int t = threadIdx.x;                     // 0..255
    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
    // Split four consecutive tokens of one row into hi / lo and write them
    // as one 16-byte chunk of K-major row `row` (128 B, swizzled).
    auto split4 = [](const float* src, int stride, unsigned char* hi,
                     unsigned char* lo, int row, int quad) {
      uint4 h, o;
      uint32_t* hp = &h.x;
      uint32_t* op = &o.x;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = src[i * stride];
        const uint32_t hb = to_tf32(x);
        hp[i] = hb;
        op[i] = to_tf32(x - __uint_as_float(hb));
      }
      const int off = row * 128 + ((quad ^ (row & 7)) << 4);
      *reinterpret_cast<uint4*>(hi + off) = h;
      *reinterpret_cast<uint4*>(lo + off) = o;
    };
    for (int s = 0; s < steps; ++s) {
      const int st = s % kStages32, buf = s & 1;
      mbar_wait(&full[st], (s / kStages32) & 1);
      const float* rh = reinterpret_cast<const float*>(smem + st * SB +
                                                       wg * kHBox);
      const float* rd = reinterpret_cast<const float*>(smem + st * SB +
                                                       2 * kHBox);
      unsigned char* ah = a_hi + wg * 64 * 128;
      unsigned char* al = a_lo + wg * 64 * 128;
      unsigned char* bh = b_hi + buf * BN * 128;
      unsigned char* bl = b_lo + buf * BN * 128;
      // This warpgroup's A (64 rows), and half of the shared B.
      for (int u = t & 127; u < 64 * 8; u += 128)
        split4(rh + (u >> 6) * 4 * 64 + (u & 63), 64, ah, al, u & 63,
               u >> 6);
      for (int u = t; u < BN * 8; u += 256)
        split4(rd + (u / BN) * 4 * BN + (u % BN), BN, bh, bl, u % BN,
               u / BN);
      fence_async_smem();
      named_sync(1, 256);
      if ((t & 127) == 0) mbar_arrive(&empty[st]);  // raw tiles consumed
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKB32 / 8; ++j) {
        const int off = j * 32;                    // 8 tf32 along K
        const uint64_t dah = sw128_desc(ah + off, 16, kSwBytes);
        const uint64_t dal = sw128_desc(al + off, 16, kSwBytes);
        const uint64_t dbh = sw128_desc(bh + off, 16, kSwBytes);
        const uint64_t dbl = sw128_desc(bl + off, 16, kSwBytes);
        wgmma_ss_tf32<BN>(acc, dal, dbh, j > 0);
        wgmma_ss_tf32<BN>(acc, dah, dbl, 1);
        wgmma_ss_tf32<BN>(acc, dah, dbh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    }
    store_tile(sum, a0 + 64 * wg, b0, da, db,
               part + (size_t)blockIdx.y * da * db);
  }
}

__global__ void colsum_kernel(const float* __restrict__ part, int rows,
                              int cols, float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[(size_t)r * cols + c];
  out[c] = s;
}

// cuTensorMapEncodeTiled through the runtime (no link against libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (rows, width) row-major matrix as boxes of (box_rows, box_w).
int make_map(CUtensorMap* map, const void* ptr, bool f32, int width, int rows,
             int box_w, int box_rows, bool swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return -403;
  const int esz = f32 ? 4 : 2;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 || (width * esz) % 16)
    return -404;
  const cuuint64_t dims[2] = {(cuuint64_t)width, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * esz};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -405;
}

template <class K>
int launch(K kernel, size_t smem, dim3 grid, cudaStream_t s,
           const CUtensorMap& hm, const CUtensorMap& dm, int N, int da,
           int db, int per, float* part) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreadsW, smem, s>>>(hm, dm, N, da, db, per, part);
  return (int)cudaGetLastError();
}

}  // namespace

// out[c] = sum_r part[r, c] for a (rows, cols) fp32 buffer.
extern "C" int papr_colsum(const float* part, int rows, int cols, float* out,
                           void* stream) {
  if (rows <= 0 || cols <= 0) return -401;
  colsum_kernel<<<(cols + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

// The output tile width of a launch: the narrowest of 64 / 128 / 256 (bf16)
// or 64 / 128 (fp32) that holds db, so a narrow layer runs narrow products
// (ops/fused_mlp.py wgrad_splits mirrors it).
static int tile_n(int db, bool f32) {
  if (db <= 64) return 64;
  return (f32 || db <= 128) ? 128 : 256;
}

static int launch_wgrad(bool f32, const void* H, const void* DZ, int N,
                        int da, int db, int splits, float* part, float* out,
                        void* stream) {
  if (N <= 0 || da <= 0 || db <= 0 || da % 8 || db % 8 || da > 256 ||
      db > 256 || splits <= 0)
    return -402;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BN = tile_n(db, f32);
  const int kb = f32 ? kKB32 : kKB16;
  const int per = ((N + splits - 1) / splits + kb - 1) / kb * kb;
  const dim3 grid(((da + kTileA - 1) / kTileA) * ((db + BN - 1) / BN),
                  splits);
  CUtensorMap hm, dm;
  int err = make_map(&hm, H, f32, da, N, 64, kb, !f32);
  if (!err) err = make_map(&dm, DZ, f32, db, N, f32 ? BN : 64, kb, !f32);
  if (err) return err;
  if (f32) {
    err = BN == 64
        ? launch(wgrad_f32_kernel<64>, smem32<64>(), grid, s, hm, dm, N, da,
                 db, per, part)
        : launch(wgrad_f32_kernel<128>, smem32<128>(), grid, s, hm, dm, N,
                 da, db, per, part);
  } else {
    err = BN == 64
        ? launch(wgrad_bf16_kernel<64>, smem16<64>(), grid, s, hm, dm, N, da,
                 db, per, part)
        : BN == 128
        ? launch(wgrad_bf16_kernel<128>, smem16<128>(), grid, s, hm, dm, N,
                 da, db, per, part)
        : launch(wgrad_bf16_kernel<256>, smem16<256>(), grid, s, hm, dm, N,
                 da, db, per, part);
  }
  if (err) return err;
  return papr_colsum(part, splits, da * db, out, stream);
}

// out (da, db) fp32 = H^T DZ for H (N, da), DZ (N, db) bf16 row-major, over
// `splits` token ranges summed through part (splits * da * db fp32).
extern "C" int papr_wgrad(const void* H, const void* DZ, int N, int da,
                          int db, int splits, float* part, float* out,
                          void* stream) {
  return launch_wgrad(false, H, DZ, N, da, db, splits, part, out, stream);
}

// The same for fp32 H, DZ (3xTF32 products).
extern "C" int papr_wgrad_f32(const void* H, const void* DZ, int N, int da,
                              int db, int splits, float* part, float* out,
                              void* stream) {
  return launch_wgrad(true, H, DZ, N, da, db, splits, part, out, stream);
}
