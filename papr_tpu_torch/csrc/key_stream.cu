// Streamed key attention of the training path, forward and backward.
//
// Forward replaces papr_tpu/ops/stream_attn.py::key_stream_scores_rec
// (pallas_call at :1029, kernel body _ksr_fwd_kernel :798): per (ray, k)
// the point-ray geometry -> key posenc (117) -> LN -> 5 x 256 -> LN -> w_k
// -> scaled dot with qq -> score_act x influence, alive-masked; then the
// background-token softmax. Outputs attn (T, K+1) and, for the backward,
// the raw dots and masked scores (T, K).
//
// Backward replaces _ksr_bwd (pallas_call at :1100, kernel body
// _ksr_bwd_kernel :835): the softmax backward from the saved masked scores
// (alive read as ss > NEG_BIG / 2), then per k a recompute of the walk and
// the reverse chain: dqq, dW_k / db_k, the walk's gradients, the posenc and
// geometry backward to d_rec (K, T, rec_w) with the position FEATURE
// gradient dropped (the reference detaches it), the geometry gradient in
// lanes 0:3 and d_influence in lane 3, and d_rayo / d_rays.
//
// What bounds it on the H100: the walks, ~1.4 MFLOP of bf16 tensor-core
// work per (ray, k) token forward and ~3x that backward (recompute, dX,
// and dW in wgrad.cu); compute bound. What the design does about it: as in
// attend_eval.cu, one block of 512 threads per 64-ray tile loops over k
// inside the block (the TPU grid's sequential k axis, which carried the
// scores and the dqq / d_rayo / d_rays sums in resident output blocks; here
// the block owns its rays' rows, so they accumulate without atomics), and
// every activation stays in shared memory. The record is read pre-gathered
// k-major, (K, T, rec_w), the JAX kernels' layout; d_rec is a plain
// (K, T, rec_w) output that autograd scatter-adds into the (P, rec_w) record.

#include "rec_stream.cuh"
#include "walk_bwd.cuh"

using namespace papr;

namespace {

// nn/mlp.py linear_apply in bf16: matmul rounded to bf16, bias added in
// bf16, promoted to fp32 (fused_attn.py _linear).
__device__ __forceinline__ float kk_value(float acc, float bias) {
  return bf16_round(bf16_round(acc) + bf16_round(bias));
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
key_fwd_kernel(const float* __restrict__ rec, int rec_w, int T, int K,
               const float* __restrict__ rayo, const float* __restrict__ rays,
               const float* __restrict__ qq, int dm, float sqrt_dm,
               WalkDesc kd, const __nv_bfloat16* __restrict__ wk,
               const float* __restrict__ bk, int dm_pad, int score_relu,
               float bkg, float eps, float* __restrict__ attn,
               float* __restrict__ raw, float* __restrict__ ss_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem S = walk_smem(smem);
  float* C = S.C;
  float* geo = reinterpret_cast<float*>(S.extra);            // kRows x kGeo
  float* ss = geo + kRows * kGeo;                            // kRows x K
  int* gidx = reinterpret_cast<int*>(ss + kRows * K);        // kRows
  const int t0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int k = 0; k < K; ++k) {
    geometry_rows(geo, gidx, rec, rec_w, T, k, t0, rayo, rays, eps);
    __syncthreads();
    encode_rec(C, kd, geo, gidx, rec, rec_w);
    __syncthreads();
    run_walk(S, kd, true);                      // y_k rounded to bf16 in A[0]
    dense_layer(S.A[0], C, nullptr, S.W, wk, nullptr, kd.pd[kd.n], dm_pad, 0);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int t = t0 + r;
      float s = 0.f;
      if (t < T) {
        const float* qrow = qq + (size_t)t * dm;
        for (int c = lane; c < dm; c += 32)
          s += qrow[c] * kk_value(C[r * kCLd + c], bk[c]);
      }
      s = warp_sum(s);
      if (lane == 0 && t < T) {
        const float col = s / sqrt_dm;
        raw[(size_t)t * K + k] = col;
        const float sact = score_relu ? fmaxf(col, 0.f) : col;
        const float* gr = geo + r * kGeo;
        ss[r * K + k] = gr[10] > 0.5f ? sact * gr[9] : kNegBig;
      }
    }
    __syncthreads();
  }

  // Background-token softmax (stream_attn.py _softmax_s).
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    float m = bkg;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, ss[r * K + k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float z = 0.f;
    for (int k = lane; k < K; k += 32) z += expf(ss[r * K + k] - m);
    const float eb = expf(bkg - m);
    z = warp_sum(z) + eb;
    float* arow = attn + (size_t)t * (K + 1);
    for (int k = lane; k < K; k += 32) {
      arow[k] = expf(ss[r * K + k] - m) / z;
      ss_out[(size_t)t * K + k] = ss[r * K + k];
    }
    if (lane == 0) arow[K] = eb / z;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
key_bwd_kernel(const float* __restrict__ rec, int rec_w, int T, int Tp, int K,
               const float* __restrict__ rayo, const float* __restrict__ rays,
               const float* __restrict__ qq, int dm, float sqrt_dm,
               const float* __restrict__ raw, const float* __restrict__ ss,
               const float* __restrict__ dattn, WalkDesc kd, WalkBwd kb,
               const __nv_bfloat16* __restrict__ wkf,
               const __nv_bfloat16* __restrict__ wkb,
               const float* __restrict__ bk, int dm_pad, int dbk_off,
               int score_relu, float bkg, float eps,
               const int* __restrict__ seg, int nsrc, float* drec,
               float* drayo, float* drays, float* dqq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem S = walk_smem(smem);
  float* C = S.C;
  float* geo = reinterpret_cast<float*>(S.extra);            // kRows x kGeo
  float* ds = geo + kRows * kGeo;                            // kRows x K
  float* st = ds + kRows * K;                                // 4 x kRows
  float* draw = st + 4 * kRows;                              // kRows
  float* dinf = draw + kRows;                                // kRows
  float* dgeo = dinf + kRows;                                // kRows x 9
  int* gidx = reinterpret_cast<int*>(dgeo + kRows * kNGeoSrc);
  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = kd.n, pdn = kd.pd[n];

  // Softmax backward (_ksr_bwd_kernel :857-863).
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) {
      for (int k = lane; k < K; k += 32) ds[r * K + k] = 0.f;
      continue;
    }
    const float* srow = ss + (size_t)t * K;
    const float* drow = dattn + (size_t)t * (K + 1);
    float m = bkg;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, srow[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float z = 0.f, in = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float e = expf(srow[k] - m);
      z += e;
      in += e * drow[k];
    }
    const float eb = expf(bkg - m);
    z = warp_sum(z) + eb;
    const float inner = (warp_sum(in) + eb * drow[K]) / z;
    for (int k = lane; k < K; k += 32) {
      const float fg = expf(srow[k] - m) / z;
      ds[r * K + k] = srow[k] > 0.5f * kNegBig ? fg * (drow[k] - inner) : 0.f;
    }
  }
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    geometry_rows(geo, gidx, rec, rec_w, T, k, t0, rayo, rays, eps);
    __syncthreads();
    if (tid < kRows) {
      const int t = t0 + tid;
      const float rw = t < T ? raw[(size_t)t * K + k] : 0.f;
      const float sact = score_relu ? fmaxf(rw, 0.f) : rw;
      const float d = ds[tid * K + k];
      dinf[tid] = d * sact;
      const float mask = score_relu ? (sact > 0.f ? 1.f : 0.f) : 1.f;
      draw[tid] = d * geo[tid * kGeo + 9] * mask / sqrt_dm;
    }
    encode_rec(C, kd, geo, gidx, rec, rec_w);
    __syncthreads();
    const TileCtx ctx = tile_ctx(kd, kb, (size_t)k * Tp + t0, st);
    walk_fwd_stash(S, kd, kb, ctx, true);        // y_c in A[0]
    stash_tile(S.A[0], kb.hs[n], ctx.row0, pdn);
    dense_layer(S.A[0], C, nullptr, S.W, wkf, nullptr, pdn, dm_pad, 0);
    __syncthreads();

    // kk, dqq += d_raw kk, dkk = d_raw qq (fp32 in C, bf16 in A[1] + stash).
    for (int i = tid; i < kRows * dm_pad; i += kThreads) {
      const int r = i / dm_pad, c = i - r * dm_pad, t = t0 + r;
      float dk = 0.f;
      if (t < T && c < dm) {
        const float kk = kk_value(C[r * kCLd + c], bk[c]);
        dqq[(size_t)t * dm + c] += draw[r] * kk;
        dk = draw[r] * qq[(size_t)t * dm + c];
      }
      C[r * kCLd + c] = dk;
      const __nv_bfloat16 h = __float2bfloat16_rn(dk);
      S.A[1][r * kALd + c] = h;
      kb.dz[n][(ctx.row0 + r) * dm_pad + c] = h;
    }
    __syncthreads();
    colsum_add(C, dm_pad, ctx.part + dbk_off);
    dense_layer(S.A[1], C, nullptr, S.W, wkb, nullptr, dm_pad, pdn, 0);
    __syncthreads();
    walk_bwd(S, kd, kb, ctx);

    pe_bwd_deriv(C, kd, [&](int r, int src) {
      return src < kNGeoSrc ? geo[r * kGeo + src]
          : rec[(size_t)gidx[r] * rec_w + 5 + (src - kNGeoSrc)];
    });
    __syncthreads();
    pe_source_sums(C, seg, nsrc, [&](int r, int src, float v) {
      if (src < kNGeoSrc) dgeo[r * kNGeoSrc + src] = v;
      else if (t0 + r < T) drec[(size_t)gidx[r] * rec_w + 5 + (src - kNGeoSrc)] = v;
    });
    __syncthreads();
    if (tid < kRows && t0 + tid < T) {
      const int t = t0 + tid;
      float o[3], dr[3], dsel[3], dry[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = rayo[(size_t)t * 3 + j];
        dr[j] = rays[(size_t)t * 3 + j];
      }
      float* prow = drec + (size_t)gidx[tid] * rec_w;
      // Sources 0..2 (the position feature) are dropped: detached.
      geom_bwd_row(rec + (size_t)gidx[tid] * rec_w, o, dr,
                   dgeo + tid * kNGeoSrc + 3, dgeo + tid * kNGeoSrc + 6, eps,
                   dsel, dry);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        prow[j] = dsel[j];
        drayo[(size_t)t * 3 + j] -= dsel[j];
        drays[(size_t)t * 3 + j] += dry[j];
      }
      prow[3] = dinf[tid];
    }
    __syncthreads();
  }
}

extern "C" int papr_key_stream_fwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const int* kmeta, const void* kw, const void* kb, const void* kln,
    const void* kplan, const void* wk, const void* bk, int dm_pad,
    int score_relu, float bkg, float eps, void* attn, void* raw, void* ss,
    void* stream) {
  WalkDesc kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  if (dm_pad <= 0 || dm_pad > kMaxWidth || dm_pad % 16 != 0 || dm > dm_pad)
    return -201;
  if (K <= 0 || K > 64) return -202;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows * (kGeo + K) +
      sizeof(int) * kRows;
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      key_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  key_fwd_kernel<<<(T + kRows - 1) / kRows, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, K, rayo, rays, qq, dm, sqrt_dm, kd,
      static_cast<const __nv_bfloat16*>(wk), static_cast<const float*>(bk),
      dm_pad, score_relu, bkg, eps, static_cast<float*>(attn),
      static_cast<float*>(raw), static_cast<float*>(ss));
  return (int)cudaGetLastError();
}

extern "C" int papr_key_stream_bwd(
    const float* rec, int rec_w, int T, int K, const float* rayo,
    const float* rays, const float* qq, int dm, float sqrt_dm,
    const float* raw, const float* ss, const float* dattn, const int* kmeta,
    const void* kw, const void* kb, const void* kln, const void* kplan,
    const void* kwt, const void* wkf, const void* wkb, const void* bk,
    int dm_pad, int score_relu, float bkg, float eps, void* stash,
    const long long* stash_off, const int* seg, int nsrc, float* drec,
    float* drayo, float* drays, float* dqq, float* part, int part_w,
    float* scratch, void* stream) {
  WalkDesc kd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  WalkBwd wb;
  err = fill_walk_bwd(&wb, kd, kmeta, kwt, stash, stash_off, kd.n + 1, part,
                      part_w, scratch);
  if (err) return err;
  if (dm_pad <= 0 || dm_pad > kMaxWidth || dm_pad % 16 != 0 || dm > dm_pad)
    return -201;
  if (K <= 0 || K > 64) return -202;
  const int dbk_off = wb.bias_len + 2 * kd.pd[0] + 2 * kd.pd[kd.n];
  if (part_w < dbk_off + dm_pad) return -204;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows *
      (kGeo + K + 4 + 2 + kNGeoSrc) + sizeof(int) * kRows;
  if (smem > 232448) return -203;
  cudaError_t e = cudaFuncSetAttribute(
      key_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int Tp = (T + kRows - 1) / kRows * kRows;
  key_bwd_kernel<<<Tp / kRows, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      rec, rec_w, T, Tp, K, rayo, rays, qq, dm, sqrt_dm, raw, ss, dattn, kd,
      wb, static_cast<const __nv_bfloat16*>(wkf),
      static_cast<const __nv_bfloat16*>(wkb), static_cast<const float*>(bk),
      dm_pad, dbk_off, score_relu, bkg, eps, seg, nsrc, drec, drayo, drays,
      dqq);
  return (int)cudaGetLastError();
}
