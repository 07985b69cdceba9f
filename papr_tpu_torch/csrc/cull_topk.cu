// Tile-culled top-k selection, stage 3: exact distances over each pixel
// tile's candidate set, packed and reduced to the k best per ray.
//
// Replaces papr_tpu/ops/tile_cull.py::_cull_kernel (:110; pallas_call at
// :341 inside select_topk_culled). Per tile of TR rays (16 x 16 pixels) and
// M candidates: dist = max(|v|^2 - t^2 f, 0), t = d . v, packed as
// (bits & 0xFFFF8000) | global_index, and the k smallest distinct packed
// values per ray in ascending order (first k lanes of the TPU kernel's
// output, masked to the index bits).
//
// What bounds it on the H100: per candidate and ray ~6 FP32 ops plus the
// running-selection compare, all on-chip; the (T, 8, M) candidate records
// are read once per tile. Bound by issue rate, not by memory. What the
// design does about it: one block per tile and one thread per ray; each
// 512-wide candidate chunk is staged in shared memory (read by all rays as
// broadcasts), and each thread keeps its sorted k best in registers with an
// insertion that almost every candidate leaves at one compare — the TPU
// kernel's full-width min-extract passes (k rounds over the whole chunk per
// ray) disappear. The sound early exit of the TPU kernel stays: after a
// chunk, if the block-wide max of every ray's k-th packed value is strictly
// below the packed lower bound of the next chunk's first candidate, no later
// candidate can enter any ray's set. The arithmetic is written with
// round-to-nearest intrinsics (no FMA contraction) so the kernel is bit-equal
// to the plain PyTorch version of the same formula.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kValMask = (int)0xFFFF8000u;
constexpr int kIdxMask = 0x7FFF;
constexpr int kMaxI = 0x7FFFFFFF;

template <int KMAX>
__global__ void cull_topk_kernel(const float* __restrict__ tiles,
                                 const float* __restrict__ fscale,
                                 const float* __restrict__ recs, int TR,
                                 int M, int chunk, int k, int early_exit,
                                 int* __restrict__ out) {
  extern __shared__ __align__(16) float sh[];
  float* sv0 = sh;
  float* sv1 = sv0 + chunk;
  float* sv2 = sv1 + chunk;
  float* svv = sv2 + chunk;
  int* sgi = reinterpret_cast<int*>(svv + chunk);
  __shared__ int s_kth;

  const int t = blockIdx.x, r = threadIdx.x;
  const size_t ray = (size_t)t * TR + r;
  const float d0 = tiles[ray * 3 + 0];
  const float d1 = tiles[ray * 3 + 1];
  const float d2 = tiles[ray * 3 + 2];
  const float f = fscale[ray];
  const float* rec = recs + (size_t)t * 8 * M;

  int best[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) best[i] = kMaxI;

  const int n_chunks = M / chunk;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * chunk;
    __syncthreads();
    for (int j = r; j < chunk; j += TR) {
      sv0[j] = rec[0 * M + base + j];
      sv1[j] = rec[1 * M + base + j];
      sv2[j] = rec[2 * M + base + j];
      svv[j] = rec[3 * M + base + j];
      sgi[j] = (int)rec[4 * M + base + j];
    }
    __syncthreads();
    for (int j = 0; j < chunk; ++j) {
      const float tt = __fadd_rn(__fadd_rn(__fmul_rn(d0, sv0[j]),
                                           __fmul_rn(d1, sv1[j])),
                                 __fmul_rn(d2, sv2[j]));
      const float dist =
          fmaxf(__fsub_rn(svv[j], __fmul_rn(__fmul_rn(tt, tt), f)), 0.f);
      const int p = (__float_as_int(dist) & kValMask) | sgi[j];
      if (p < best[KMAX - 1]) {
        bool dup = false;
#pragma unroll
        for (int i = 0; i < KMAX; ++i) dup |= best[i] == p;
        if (!dup) {
#pragma unroll
          for (int i = KMAX - 1; i > 0; --i) {
            const int prev = best[i - 1];
            best[i] = prev > p ? prev : (best[i] > p ? p : best[i]);
          }
          best[0] = best[0] > p ? p : best[0];
        }
      }
    }
    if (early_exit && c + 1 < n_chunks) {
      int kth = kMaxI;
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i == k - 1) kth = best[i];
      __syncthreads();
      if (r == 0) s_kth = INT_MIN;
      __syncthreads();
      atomicMax(&s_kth, kth);
      __syncthreads();
      const int lb_next =
          __float_as_int(rec[5 * M + base + chunk]) & kValMask;
      if (s_kth < lb_next) break;      // uniform across the block
    }
  }
  int* o = out + ray * k;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i < k) o[i] = best[i] & kIdxMask;
}

template <int KMAX>
int launch(const float* tiles, const float* f, const float* recs, int T,
           int TR, int M, int chunk, int k, int early_exit, int* out,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * 5 * chunk;
  cudaError_t e = cudaFuncSetAttribute(
      cull_topk_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cull_topk_kernel<KMAX><<<T, TR, smem, stream>>>(tiles, f, recs, TR, M,
                                                  chunk, k, early_exit, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int papr_cull_topk(const float* tiles, const float* f,
                              const float* recs, int T, int TR, int M,
                              int chunk, int k, int early_exit, int* out,
                              void* stream) {
  if (TR <= 0 || TR > 1024 || chunk <= 0 || M % chunk != 0) return -301;
  if (T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch<8>(tiles, f, recs, T, TR, M, chunk, k, early_exit, out, s);
  if (k <= 16) return launch<16>(tiles, f, recs, T, TR, M, chunk, k, early_exit, out, s);
  if (k <= 20) return launch<20>(tiles, f, recs, T, TR, M, chunk, k, early_exit, out, s);
  if (k <= 32) return launch<32>(tiles, f, recs, T, TR, M, chunk, k, early_exit, out, s);
  if (k <= 64) return launch<64>(tiles, f, recs, T, TR, M, chunk, k, early_exit, out, s);
  return -302;
}
