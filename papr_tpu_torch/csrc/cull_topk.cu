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
// What bounds it on the H100: per candidate and ray ~9 FP32 operations and a
// compare against the ray's running k-th value, all on-chip; each tile reads
// its (8, M) candidate records once, and with the early exit of the sorted
// prefilters only a prefix of them (a few hundred of 2048 on a serving
// frame). Bound by issue rate and by the insertions into each ray's list,
// not by memory (PERF.md, Findings). What the design does: one block per
// tile (a tile of more than 256 rays in blocks of at most 256, each with its
// own exit test); each thread keeps its ray's sorted k best in registers;
// its first 32 candidates (which all enter: the list is not full) go in by
// one sorting network, the later ones through a compare against the ray's
// k-th value, those under it held back in shared memory and merged by the
// whole warp after every 16 (so one lane's insertion does not stall its warp
// once per candidate). The candidates come in stages of 64 a thread, as
// float4 (v, |v|^2) and the index, loaded into registers while the stage
// before is scanned and stored to shared memory after it (read by all rays
// as broadcasts; a block of fewer threads than a stage's candidates, a tile
// of under 64 rays, loads the rest straight into shared memory). The TPU
// kernel's sound early exit stays, tested after every stage instead of every
// 512-wide chunk (the output does not depend on where it is tested): once
// the block-wide max of every ray's k-th packed value is strictly below the
// packed lower bound of the next candidate, no later candidate can enter any
// ray's set. Where a tile scans all its candidates (the training shape: 100
// tiles, fewer than the card's 132 SMs), two threads share a ray, each
// scanning every other candidate, and their lists merge by shuffles at the
// end. The arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), so the kernel is bit-equal to the plain PyTorch version of
// the same formula.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kValMask = (int)0xFFFF8000u;
constexpr int kIdxMask = 0x7FFF;
constexpr int kMaxI = 0x7FFFFFFF;
constexpr int kStage = 64;       // candidates a thread scans between stages
constexpr int kHead = 32;        // a thread's first candidates, sorted at once
constexpr int kMaxRays = 256;    // rays a block (registers: k <= 64 a thread)

// p into the sorted list of distinct values (unless it is there already):
// the largest drops out.
template <int KMAX>
__device__ __forceinline__ void insert(int (&best)[KMAX], int p) {
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

// best[k - 1] (every index a compile-time constant: the list stays in
// registers).
template <int KMAX>
__device__ __forceinline__ int kth_of(const int (&best)[KMAX], int k) {
  int v = kMaxI;
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i == k - 1) v = best[i];
  return v;
}

// The packed distance of ray d (scale f) to a staged candidate v (v, |v|^2).
__device__ __forceinline__ int packed_dist(float d0, float d1, float d2,
                                           float f, const float4 v, int gi) {
  const float tt = __fadd_rn(__fadd_rn(__fmul_rn(d0, v.x), __fmul_rn(d1, v.y)),
                             __fmul_rn(d2, v.z));
  const float dist =
      fmaxf(__fsub_rn(v.w, __fmul_rn(__fmul_rn(tt, tt), f)), 0.f);
  return (__float_as_int(dist) & kValMask) | gi;
}

// Candidate j of a tile's records (rows of M) into v, gi.
__device__ __forceinline__ void load_cand(const float* __restrict__ rec,
                                          int M, int j, float4& v, int& gi) {
  v = make_float4(rec[j], rec[M + j], rec[2 * M + j], rec[3 * M + j]);
  gi = (int)rec[4 * M + j];
}

// The stage at base into sv, sg, all but slot tid (which comes through the
// loader's registers): nothing where the block has kSub threads or more, the
// rest of the stage straight from global memory where it has fewer (ray
// tiles of under 64 rays).
template <int kSub>
__device__ __forceinline__ void stage_rest(const float* __restrict__ rec,
                                           int M, int base, float4* sv,
                                           int* sg, int tid) {
  for (int j = tid + (int)blockDim.x; j < kSub; j += (int)blockDim.x) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    int g = 0;
    if (base + j < M) load_cand(rec, M, base + j, v, g);
    sv[j] = v;
    sg[j] = g;
  }
}

// A thread's candidates between its warp's merges (measured: 16 at one
// thread a ray, 32 at two).
__host__ __device__ constexpr int pend_of(int S) { return 16 * S; }

// v ascending, by a bitonic network (every index a compile-time constant).
template <int N>
__device__ __forceinline__ void sort_net(int (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int a = v[i], b = v[l];
          v[i] = (i & k) == 0 ? min(a, b) : max(a, b);
          v[l] = (i & k) == 0 ? max(a, b) : min(a, b);
        }
      }
}

// Block (t, y) takes rays y RB .. y RB + RB - 1 of tile t (S threads a
// ray); a ray past the tile's TR runs as its last ray and writes nothing.
template <int KMAX, int S>
__global__ void __launch_bounds__(kMaxRays * S)
cull_topk_kernel(const float* __restrict__ tiles,
                 const float* __restrict__ fscale,
                 const float* __restrict__ recs, int TR, int RB, int M, int k,
                 int early_exit, int* __restrict__ out) {
  constexpr int kSub = kStage * S;          // candidates a stage, all rays
  constexpr int kPend = pend_of(S);         // a thread's candidates a merge
  __shared__ float4 sv[2][kSub];            // v, |v|^2 (+inf if dead)
  __shared__ int sg[2][kSub];               // global index
  __shared__ int s_max[3];                  // the exit tests' block maxima
  extern __shared__ int pend[];             // [kPend][blockDim]

  const int t = blockIdx.x, tid = threadIdx.x;
  const int r = blockIdx.y * RB + tid / S, s = tid % S;
  const int lane = tid & 31;
  const int in_warp = min(32, (int)blockDim.x - (tid & ~31));
  const unsigned warp_mask =
      in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const size_t ray = (size_t)t * TR + min(r, TR - 1);
  const float d0 = tiles[ray * 3 + 0];
  const float d1 = tiles[ray * 3 + 1];
  const float d2 = tiles[ray * 3 + 2];
  const float f = fscale[ray];
  const float* rec = recs + (size_t)t * 8 * M;

  int best[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) best[i] = kMaxI;
  int kth = kMaxI;                          // best[k - 1]

  // The next stage's candidates go through registers (the loaders: tid <
  // kSub; stage_rest stages the rest where the block has fewer threads).
  float4 nv = make_float4(0.f, 0.f, 0.f, 0.f);
  int ng = 0;
  if (tid < kSub && tid < M) load_cand(rec, M, tid, nv, ng);
  if (tid < kSub) {
    sv[0][tid] = nv;
    sg[0][tid] = ng;
  }
  stage_rest<kSub>(rec, M, 0, sv[0], sg[0], tid);
  if (tid == 0) s_max[0] = s_max[1] = INT_MIN;
  __syncthreads();

  // A thread's first kHead candidates all enter its list, which is not full
  // yet: one sorting network instead of kHead insertions (one at a time
  // only where two of them are equal).
  int head = 0;                             // stage 0's candidates done
  if (kSub >= kHead * S && M >= kHead * S) {
    int v[kHead];
#pragma unroll
    for (int i = 0; i < kHead; ++i)
      v[i] = packed_dist(d0, d1, d2, f, sv[0][s + i * S], sg[0][s + i * S]);
    sort_net(v);
    bool dup = false;
#pragma unroll
    for (int i = 1; i < kHead; ++i) dup |= v[i] == v[i - 1];
    if (!dup) {
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        best[i] = i < kHead ? v[i % kHead] : kMaxI;
    } else {
#pragma unroll
      for (int i = 0; i < kHead; ++i) insert(best, v[i]);
    }
    kth = kth_of(best, k);
    head = kHead * S;
  }

  const int n_sub = (M + kSub - 1) / kSub;
  int test = 0;
  for (int c = 0; c < n_sub; ++c) {
    const int base = c * kSub;
    const int cnt = min(kSub, M - base);
    const bool more = c + 1 < n_sub;
    if (more && tid < kSub && base + kSub + tid < M)
      load_cand(rec, M, base + kSub + tid, nv, ng);
    const float4* bv = sv[c & 1];
    const int* bg = sg[c & 1];
    // Groups of kPend candidates: those under the ray's k-th value wait in
    // the thread's pending column, then the warp merges them together (a
    // lane's insertions no longer stall its warp once per candidate).
    for (int g0 = c == 0 ? head : 0; g0 < cnt; g0 += kPend * S) {
      const int j1 = min(cnt, g0 + kPend * S);      // uniform in a warp
      int n = 0;
      for (int j = g0 + s; j < j1; j += S) {
        const int p = packed_dist(d0, d1, d2, f, bv[j], bg[j]);
        if (p < kth) pend[(n++) * blockDim.x + tid] = p;
      }
      const int n_max = __reduce_max_sync(warp_mask, n);
      for (int i = 0; i < n_max; ++i) {
        const int p = i < n ? pend[i * blockDim.x + tid] : kMaxI;
        if (p < kth) insert(best, p);
      }
      kth = kth_of(best, k);
    }
    const bool test_now = early_exit && more;
    if (test_now) {
      const int wmax = __reduce_max_sync(warp_mask, kth);
      if (lane == 0) atomicMax(&s_max[test % 3], wmax);
    }
    if (more && tid < kSub) {
      sv[(c + 1) & 1][tid] = nv;
      sg[(c + 1) & 1][tid] = ng;
    }
    if (more)
      stage_rest<kSub>(rec, M, base + kSub, sv[(c + 1) & 1], sg[(c + 1) & 1],
                       tid);
    __syncthreads();
    if (test_now) {
      const int m = s_max[test % 3];
      // Slot test + 2 is next written after the next stage's barrier.
      if (tid == 0) s_max[(test + 2) % 3] = INT_MIN;
      ++test;
      const int lb_next = __float_as_int(rec[5 * M + base + kSub]) & kValMask;
      if (m < lb_next) break;       // uniform across the block
    }
  }

  // A ray's S lists into one: each thread inserts its partners' values.
#pragma unroll
  for (int m = 1; m < S; m <<= 1) {
    int other[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      other[i] = __shfl_xor_sync(warp_mask, best[i], m);
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (other[i] < best[KMAX - 1]) insert(best, other[i]);
  }
  if (s == 0 && r < TR) {
    int* o = out + ray * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < k) o[i] = best[i] & kIdxMask;
  }
}

// A tile of TR rays in ceil(TR / kMaxRays) blocks of RB rays (a multiple
// of 32 / S where S > 1, so that a ray's threads share a warp).
template <int KMAX, int S>
int launch(const float* tiles, const float* f, const float* recs, int T,
           int TR, int M, int k, int early_exit, int* out,
           cudaStream_t stream) {
  const int parts = (TR + kMaxRays - 1) / kMaxRays;
  int RB = (TR + parts - 1) / parts;
  if (S > 1) RB = (RB + 32 / S - 1) / (32 / S) * (32 / S);
  const int smem = (int)sizeof(int) * pend_of(S) * RB * S;
  cudaError_t e = cudaFuncSetAttribute(
      cull_topk_kernel<KMAX, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cull_topk_kernel<KMAX, S><<<dim3(T, parts), RB * S, smem, stream>>>(
      tiles, f, recs, TR, RB, M, k, early_exit, out);
  return (int)cudaGetLastError();
}

// Threads a ray: one with the early exit (a serving frame has thousands of
// tiles, and a ray's own list decides the exit soonest), else two where the
// merge's registers (two lists a thread) allow (four measured slower: the
// merge's second round and 64 registers a thread at 1024 threads).
template <int KMAX>
int launch_k(const float* tiles, const float* f, const float* recs, int T,
             int TR, int M, int k, int early_exit, int* out,
             cudaStream_t stream) {
  constexpr int kS = KMAX <= 32 ? 2 : 1;
  if (!early_exit && kS == 2)
    return launch<KMAX, kS>(tiles, f, recs, T, TR, M, k, early_exit, out,
                            stream);
  return launch<KMAX, 1>(tiles, f, recs, T, TR, M, k, early_exit, out,
                         stream);
}

}  // namespace

// chunk: the JAX kernel's candidate chunk (the early exit's granularity
// there); the output does not depend on it, so the kernel tests the exit
// after every stage instead.
extern "C" int papr_cull_topk(const float* tiles, const float* f,
                              const float* recs, int T, int TR, int M,
                              int chunk, int k, int early_exit, int* out,
                              void* stream) {
  if (TR <= 0 || TR > 1024 || chunk <= 0 || M % chunk != 0) return -301;
  if (T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8) return launch_k<8>(tiles, f, recs, T, TR, M, k, early_exit, out, s);
  if (k <= 16) return launch_k<16>(tiles, f, recs, T, TR, M, k, early_exit, out, s);
  if (k <= 20) return launch_k<20>(tiles, f, recs, T, TR, M, k, early_exit, out, s);
  if (k <= 32) return launch_k<32>(tiles, f, recs, T, TR, M, k, early_exit, out, s);
  if (k <= 64) return launch_k<64>(tiles, f, recs, T, TR, M, k, early_exit, out, s);
  return -302;
}
