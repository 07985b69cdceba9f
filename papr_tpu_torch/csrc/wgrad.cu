// Weight-gradient reduction of the walk backwards, and the column-sum
// reduction of their per-block partial sums.
//
// The TPU backward kernels (papr_tpu/ops/fused_mlp.py::_bwd_kernel :424,
// stream_attn.py::_ksr_bwd_kernel :835 and _vsr_bwd_kernel :1634) add each
// grid step's hs_i^T dz_i into an output block that stays resident across
// the sequential grid. CUDA blocks run in no order, so the walk backwards
// stash hs_i and dz_i (bf16) in device memory and this kernel forms
// dW_i = sum_n hs_i[n]^T dz_i[n] over every token n afterwards.
//
// What bounds it on the H100: 2 * N * da * db FLOP against (da + db) * 2 B
// per token (~128 FLOP/B at 256 x 256) — tensor-core bound once the stash
// is read at most once from device memory. What the design does about it:
// split-K. Each block computes one 64 x 64 output tile over one contiguous
// range of tokens, staging 32-token slices of hs and dz in shared memory
// (cp.async, double-buffered) for four warps of WMMA bf16 MMAs with fp32
// accumulators; blockIdx.x walks the output tiles fastest, so the blocks
// that share a token range run together and read it from L2. The fp32
// partial tiles are summed by colsum_kernel (a fixed order: deterministic).
// Not yet: wgmma / TMA, larger tiles.
//
// The fp32 form (the stashes of the fp32 walk backwards, use_amp: false) is
// the same kernel on fp32 operands with walk.cuh's 3xTF32 products
// (m16n16k8, three MMAs per step); it stages 16-token slices, so its shared
// memory is the bf16 form's byte for byte.

#include "walk.cuh"

namespace {

using papr::cp_async16;
using papr::Mma;

constexpr int kT = 64;            // output tile edge
constexpr int kLdS = kT + 8;      // staged leading dim
constexpr int kLdC = kT + 4;      // epilogue fp32 leading dim
constexpr int kThreadsW = 128;
// Tokens per staged slice: 64 bytes of each staged column.
template <class Op>
constexpr int kK = 64 / sizeof(Op);

// Stage rows [n, n + kK) of a (N, width) matrix of Op, columns
// [c0, c0 + kT), zero outside [0, n_end) x [0, width).
template <class Op>
__device__ __forceinline__ void stage(Op (*dst)[kLdS], const Op* src,
                                      int width, int n, int n_end, int c0) {
  constexpr int kV = 16 / sizeof(Op);          // elements per 16 B
  for (int v = threadIdx.x; v < kK<Op> * (kT / kV); v += kThreadsW) {
    const int r = v / (kT / kV), c = (v % (kT / kV)) * kV;
    if (n + r < n_end && c0 + c < width)
      cp_async16(&dst[r][c], src + (size_t)(n + r) * width + c0 + c);
    else
      *reinterpret_cast<uint4*>(&dst[r][c]) = make_uint4(0, 0, 0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <class Op>
__global__ void __launch_bounds__(kThreadsW)
wgrad_kernel(const Op* __restrict__ H, const Op* __restrict__ DZ, int N,
             int da, int db, int n_per_split, float* __restrict__ part) {
  using namespace nvcuda;
  // A = hs^T: element (a, n) sits at Hs[n][a], a column-major tile.
  using M = Mma<Op, wmma::col_major>;
  constexpr int KK = kK<Op>;
  __shared__ __align__(128) Op Hs[2][KK][kLdS];
  __shared__ __align__(128) Op Ds[2][KK][kLdS];
  __shared__ __align__(128) float Cs[kT][kLdC];

  const int tiles_b = (db + kT - 1) / kT;
  const int a0 = (blockIdx.x / tiles_b) * kT, b0 = (blockIdx.x % tiles_b) * kT;
  const int n0 = blockIdx.y * n_per_split;
  const int n1 = min(N, n0 + n_per_split);
  const int warp = threadIdx.x >> 5;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;

  typename M::Acc acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int steps = n1 > n0 ? (n1 - n0 + KK - 1) / KK : 0;
  if (steps > 0) {
    stage(Hs[0], H, da, n0, n1, a0);
    stage(Ds[0], DZ, db, n0, n1, b0);
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      stage(Hs[buf ^ 1], H, da, n0 + (s + 1) * KK, n1, a0);
      stage(Ds[buf ^ 1], DZ, db, n0 + (s + 1) * KK, n1, b0);
      asm volatile("cp.async.wait_group 2;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KK; kk += M::kStep) {
      typename M::A fa[2];
      typename M::B fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) M::load(fa[i], &Hs[buf][kk][wr + 16 * i], kLdS);
#pragma unroll
      for (int j = 0; j < 2; ++j) M::load(fb[j], &Ds[buf][kk][wc + 16 * j], kLdS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) M::mma(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wr + 16 * i][wc + 16 * j], acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  float* out = part + (size_t)blockIdx.y * da * db;
  for (int i = threadIdx.x; i < kT * kT; i += kThreadsW) {
    const int r = i / kT, c = i % kT;
    if (a0 + r < da && b0 + c < db)
      out[(size_t)(a0 + r) * db + b0 + c] = Cs[r][c];
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

}  // namespace

// out[c] = sum_r part[r, c] for a (rows, cols) fp32 buffer.
extern "C" int papr_colsum(const float* part, int rows, int cols, float* out,
                           void* stream) {
  if (rows <= 0 || cols <= 0) return -401;
  colsum_kernel<<<(cols + 255) / 256, 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

template <class Op>
static int launch_wgrad(const void* H, const void* DZ, int N, int da, int db,
                        int splits, float* part, float* out, void* stream) {
  if (N <= 0 || da <= 0 || db <= 0 || da % 8 || db % 8 || splits <= 0)
    return -402;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = ((N + splits - 1) / splits + kK<Op> - 1) / kK<Op> * kK<Op>;
  const dim3 grid(((da + kT - 1) / kT) * ((db + kT - 1) / kT), splits);
  wgrad_kernel<Op><<<grid, kThreadsW, 0, s>>>(static_cast<const Op*>(H),
                                              static_cast<const Op*>(DZ), N,
                                              da, db, per, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return papr_colsum(part, splits, da * db, out, stream);
}

// out (da, db) fp32 = H^T DZ for H (N, da), DZ (N, db) bf16 row-major, over
// `splits` token ranges summed through part (splits * da * db fp32).
extern "C" int papr_wgrad(const void* H, const void* DZ, int N, int da,
                          int db, int splits, float* part, float* out,
                          void* stream) {
  return launch_wgrad<__nv_bfloat16>(H, DZ, N, da, db, splits, part, out,
                                     stream);
}

// The same for fp32 H, DZ (3xTF32 products).
extern "C" int papr_wgrad_f32(const void* H, const void* DZ, int N, int da,
                              int db, int splits, float* part, float* out,
                              void* stream) {
  return launch_wgrad<float>(H, DZ, N, da, db, splits, part, out, stream);
}
