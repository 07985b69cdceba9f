// The int8 walk microbenchmark: a stack of square dense layers on row tiles,
// in four variants.
//
// Replaces tools/int8_walk_microbench.py (pallas_call at :132; kernel bodies
// _bf16_kernel :33, _int8_kernel :45, _int8s_kernel :63, _int8raw_kernel
// :80): rows x `layers` layers of D x D with relu after every layer, the
// shape of the value walk (D = 256, 8 layers).
//   bf16    : bf16 operands, fp32 accumulate, activations rounded to bf16.
//   int8    : dynamic per-ROW activation scale (an amax reduction and a
//             division per layer), int8 weights with per-channel scales.
//   int8s   : static activation scale, no reduction: walk.cuh's run_walk_q
//             with a uniform inverse-scale row (the form the model uses).
//   int8raw : activations stay int8 between layers (relu, >> 8, clip): no
//             dequantization at all, the cheapest possible int8 chain.
//
// What bounds it on the H100: 2 x rows x layers x D^2 operations against
// rows x D x 8 bytes: compute bound, and in these kernels held by fragment
// loads and shared-memory traffic, not by the MMA rate. The design is the
// walk's: one 512-thread block per 64-row tile, activations in shared
// memory, weights staged by cp.async; the variants share dense_layer /
// dense_layer_q and differ only in the per-layer prologue and epilogue.

#include "walk.cuh"

using namespace papr;

namespace {

constexpr int kBf16 = 0, kDynamic = 1, kStatic = 2, kRaw = 3;

__device__ __forceinline__ float warp_amax(float m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// int8: per layer an amax per row, q = clip(round(h / sx)), and the
// dequantization by sx[row] * ws[col].
__device__ __forceinline__ void dynamic_layers(const WalkSmem& S,
                                               const WalkDesc& d,
                                               const WalkQuant& q, float* sx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  q8* Q = reinterpret_cast<q8*>(S.A[0]);
  q8* wbuf = reinterpret_cast<q8*>(S.W);
  for (int l = 0; l < d.n; ++l) {
    for (int r = warp; r < kRows; r += kWarps) {
      float m = 0.f;
      for (int c = lane; c < d.pd[l]; c += 32)
        m = fmaxf(m, fabsf(S.C[r * kCLd + c]));
      m = warp_amax(m);
      if (lane == 0) sx[r] = __fdiv_rn(fmaxf(m, 1e-12f), 127.f);
    }
    __syncthreads();
    quantize_tile(S.C, Q, d.pd[l], [&](int r, int, float h) {
      const float t = fminf(fmaxf(__fdiv_rn(h, sx[r]), -127.f), 127.f);
      return (q8)__float2int_rn(t);
    });
    const float* ws = q.dq[l];
    const float* bias = d.b[l];
    dense_layer_q(Q, S.C, wbuf, q.w[l], d.pd[l], d.pd[l + 1],
                  [&](int r, int col, const int* a, float* crow) {
                    float v[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                      const float s = __fmul_rn(sx[r], ws[col + e]);
                      v[e] = fmaxf(__fadd_rn(__fmul_rn((float)a[e], s),
                                             bias[col + e]), 0.f);
                    }
                    *reinterpret_cast<float4*>(crow) =
                        *reinterpret_cast<const float4*>(v);
                    *reinterpret_cast<float4*>(crow + 4) =
                        *reinterpret_cast<const float4*>(v + 4);
                  });
    __syncthreads();
  }
}

// int8raw: q = clip(x) truncated to int8, then per layer
// q = clip(max(acc >> 8, 0), 0, 127); the last layer's q is also left as
// fp32 in C.
__device__ __forceinline__ void raw_layers(const WalkSmem& S, const WalkDesc& d,
                                           const WalkQuant& q) {
  q8* Q[2] = {reinterpret_cast<q8*>(S.A[0]), reinterpret_cast<q8*>(S.A[1])};
  q8* wbuf = reinterpret_cast<q8*>(S.W);
  quantize_tile(S.C, Q[0], d.pd[0], [](int, int, float h) {
    return (q8)(int)fminf(fmaxf(h, -127.f), 127.f);
  });
  int cur = 0;
  for (int l = 0; l < d.n; ++l) {
    const bool last = l + 1 == d.n;
    q8* Q_out = Q[cur ^ 1];
    dense_layer_q(Q[cur], S.C, wbuf, q.w[l], d.pd[l], d.pd[l + 1],
                  [&](int r, int col, const int* a, float* crow) {
                    __align__(8) q8 o[8];
                    float v[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                      const int s = min(max(a[e] >> 8, 0), 127);
                      o[e] = (q8)s;
                      v[e] = (float)s;
                    }
                    *reinterpret_cast<uint2*>(Q_out + r * kQLd + col) =
                        *reinterpret_cast<const uint2*>(o);
                    if (last) {
                      *reinterpret_cast<float4*>(crow) =
                          *reinterpret_cast<const float4*>(v);
                      *reinterpret_cast<float4*>(crow + 4) =
                          *reinterpret_cast<const float4*>(v + 4);
                    }
                  });
    cur ^= 1;
  }
  __syncthreads();
}

template <int KIND>
__global__ void __launch_bounds__(kThreads, 1)
walk_bench_kernel(const float* __restrict__ x, int N, float carry, WalkDesc d,
                  WalkQuant q, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem S = walk_smem(smem);
  float* sx = reinterpret_cast<float*>(S.extra);              // kRows
  const int r0 = blockIdx.x * kRows;
  const int D = d.pd[0], Dn = d.pd[d.n];

  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i - r * D, row = r0 + r;
    S.C[r * kCLd + c] = row < N ? x[(size_t)row * D + c] + carry : 0.f;
  }
  __syncthreads();

  if (KIND == kBf16) run_walk(S, d, true);
  else if (KIND == kStatic) run_walk_q(S, d, q);
  else if (KIND == kDynamic) dynamic_layers(S, d, q, sx);
  else raw_layers(S, d, q);

  for (int i = threadIdx.x; i < kRows * Dn; i += kThreads) {
    const int r = i / Dn, c = i - r * Dn, row = r0 + r;
    if (row >= N) continue;
    out[(size_t)row * Dn + c] = KIND == kBf16
        ? __bfloat162float(S.A[0][r * kALd + c]) : S.C[r * kCLd + c];
  }
}

template <int KIND>
int launch(const float* x, int N, float carry, const WalkDesc& d,
           const WalkQuant& q, float* out, cudaStream_t st) {
  const size_t smem = kWalkSmem + sizeof(float) * kRows;
  cudaError_t e = cudaFuncSetAttribute(
      walk_bench_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  walk_bench_kernel<KIND><<<(N + kRows - 1) / kRows, kThreads, smem, st>>>(
      x, N, carry, d, q, out);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 bf16, 1 int8 (dynamic), 2 int8s (static), 3 int8raw. x (N, pd[0])
// fp32, out (N, pd[n]) fp32. The walk has relu on every layer and no
// LayerNorm. For kinds 1 and 3 `dq` holds the per-channel weight scales; for
// kind 2 `inv` / `dq` are run_walk_q's rows; kind 0 reads neither.
extern "C" int papr_int8_walk_bench(
    int kind, const float* x, int N, float carry, const int* meta,
    const void* w, const void* b, const void* ln, const void* plan,
    const void* wq, const void* inv, const void* dq, void* out,
    void* stream) {
  WalkDesc d;
  int err = fill_walk(&d, meta, w, b, ln, plan);
  if (err) return err;
  if (d.has_li || d.has_lo || d.act != 1 || d.last_act != 1) return -301;
  WalkQuant q = {};
  if (kind != kBf16) {
    err = fill_walk_quant(&q, d, meta, wq, inv, dq);
    if (err) return err;
  }
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (kind) {
    case kBf16: return launch<kBf16>(x, N, carry, d, q, o, st);
    case kDynamic: return launch<kDynamic>(x, N, carry, d, q, o, st);
    case kStatic: return launch<kStatic>(x, N, carry, d, q, o, st);
    case kRaw: return launch<kRaw>(x, N, carry, d, q, o, st);
  }
  return -302;
}
