// Streaming top-k selection: point-to-ray distance and a running k-best per
// ray over EVERY point, with no (rays, points) distance matrix.
//
// Replaces papr_tpu/ops/pallas_topk.py::_topk_kernel (:45; pallas_call at
// :152 inside pallas_select_topk). Per ray with direction d and scale
// f = (dd + 2 eps) / (dd + eps)^2, and per point with v = point - origin and
// vv = |v|^2 (+inf for dead and padded slots): t = d . v,
// dist = max(vv - t^2 f, 0), key = (bits(dist) & 0xFFFF8000) | index; the k
// smallest keys per ray, their index bits in ascending key order. Keys are
// unique (the index is), so no duplicate check is needed.
//
// The TPU body extracts chunk minima in rounds over a (256, 2048) tile and
// merges them with the running best, stopping early against the current
// k-th best: that is how a vector unit selects. Here one thread owns one ray
// and keeps its k best keys sorted in registers; almost every candidate is
// rejected by one compare against the k-th best, which is the same early out
// per candidate. Points are staged through shared memory in chunks and read
// by all rays of the block as broadcasts.
//
// What bounds it on the H100: ~9 FP32 operations per (ray, point) pair and a
// few bytes per ray and point of device traffic: bound by FP32 issue, not by
// memory. The arithmetic uses round-to-nearest intrinsics (no FMA
// contraction) so the kernel is bit-equal to the plain PyTorch version of
// the same formula.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kValMaskS = (int)0xFFFF8000u;
constexpr int kIdxMaskS = 0x7FFF;
constexpr int kMaxIS = 0x7FFFFFFF;
constexpr int kChunkS = 2048;          // points staged per round

template <int KMAX>
__global__ void topk_stream_kernel(const float* __restrict__ rays,
                                   const float* __restrict__ fscale,
                                   const float* __restrict__ vT,
                                   const float* __restrict__ v2, int R,
                                   int Ppad, int k, int* __restrict__ out) {
  __shared__ float sv0[kChunkS];
  __shared__ float sv1[kChunkS];
  __shared__ float sv2[kChunkS];
  __shared__ float svv[kChunkS];

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < R;
  const int rr = live ? ray : R - 1;           // overhang threads mirror a ray
  const float d0 = rays[(size_t)rr * 3 + 0];
  const float d1 = rays[(size_t)rr * 3 + 1];
  const float d2 = rays[(size_t)rr * 3 + 2];
  const float f = fscale[rr];

  int best[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) best[i] = kMaxIS;

  for (int base = 0; base < Ppad; base += kChunkS) {
    const int n = min(kChunkS, Ppad - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      sv0[j] = vT[0 * (size_t)Ppad + base + j];
      sv1[j] = vT[1 * (size_t)Ppad + base + j];
      sv2[j] = vT[2 * (size_t)Ppad + base + j];
      svv[j] = v2[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float tt = __fadd_rn(__fadd_rn(__fmul_rn(d0, sv0[j]),
                                           __fmul_rn(d1, sv1[j])),
                                 __fmul_rn(d2, sv2[j]));
      const float dist =
          fmaxf(__fsub_rn(svv[j], __fmul_rn(__fmul_rn(tt, tt), f)), 0.f);
      const int p = (__float_as_int(dist) & kValMaskS) | (base + j);
      if (p < best[KMAX - 1]) {
#pragma unroll
        for (int i = KMAX - 1; i > 0; --i) {
          const int prev = best[i - 1];
          best[i] = prev > p ? prev : (best[i] > p ? p : best[i]);
        }
        best[0] = best[0] > p ? p : best[0];
      }
    }
  }
  if (!live) return;
  int* o = out + (size_t)ray * k;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i < k) o[i] = best[i] & kIdxMaskS;
}

template <int KMAX>
int launch_stream(const float* rays, const float* f, const float* vT,
                  const float* v2, int R, int Ppad, int k, int threads,
                  int* out, cudaStream_t stream) {
  const int blocks = (R + threads - 1) / threads;
  topk_stream_kernel<KMAX><<<blocks, threads, 0, stream>>>(rays, f, vT, v2, R,
                                                           Ppad, k, out);
  return (int)cudaGetLastError();
}

}  // namespace

// rays (R, 3), f (R), vT (3, Ppad), v2 (Ppad) fp32 -> out (R, k) int32.
// KMAX > k leaves the tail of the sorted list unused: the first k entries are
// the k smallest either way.
extern "C" int papr_topk_stream(const float* rays, const float* f,
                                const float* vT, const float* v2, int R,
                                int Ppad, int k, int threads, int* out,
                                void* stream) {
  if (threads <= 0 || threads > 1024 || threads % 32 != 0) return -501;
  if (Ppad <= 0 || Ppad > 32768 || k <= 0) return -502;
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch_stream<8>(rays, f, vT, v2, R, Ppad, k, threads, out, s);
  if (k <= 16) return launch_stream<16>(rays, f, vT, v2, R, Ppad, k, threads, out, s);
  if (k <= 20) return launch_stream<20>(rays, f, vT, v2, R, Ppad, k, threads, out, s);
  if (k <= 32) return launch_stream<32>(rays, f, vT, v2, R, Ppad, k, threads, out, s);
  if (k <= 64) return launch_stream<64>(rays, f, vT, v2, R, Ppad, k, threads, out, s);
  return -503;
}
