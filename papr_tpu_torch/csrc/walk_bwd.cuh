// Backward of an embedder walk on WMMA, shared by the bf16 folded stream
// backward (key_stream_q.cu) and the feature stream backwards
// (key_stream_feat.cu, value_stream_feat.cu); the embedder, the key / value
// stream backwards and the fp32 folded key stream's run walk_wgmma_bwd.cuh.
//
// It is papr_tpu/ops/fused_mlp.py::walk_body_bwd (with _ln_bwd and
// _pe_freq_bwd) on one tile of kRows tokens, after a forward recompute that
// keeps what the reverse walk needs. Rounding points are the TPU kernel's:
// each layer's input hs[i] in the operand type T, dz = g * act'(.) rounded
// to T before both the dW and the dX product, fp32 accumulators, every
// gradient fp32. With T = float (the fp32 walk) nothing is rounded: the
// stash holds fp32 hs / dz (twice the bytes) and the products are 3xTF32.
//
// Where each piece goes:
//   * the walk's inputs hs[i] and dz[i] go to a device-memory stash, one
//     (N, pd) matrix of T per layer, row = the token's stash row;
//     dW_i = hs_i^T dz_i over all N tokens is formed afterwards by the
//     split-K reduction kernel of wgrad.cu (a 256 x 256 fp32 partial per
//     block would not fit in shared memory);
//   * the column sums (db, and the LayerNorm's da / db) accumulate in fp32
//     into this block's row of a partial-sum buffer (the block owns its row,
//     so no atomics); colsum in wgrad.cu reduces the rows afterwards;
//   * the fp32 encoding (LayerNorm-in input) and the last layer's fp32
//     output (LayerNorm-out input, relu mask) go to this block's slice of a
//     device-memory scratch (L2-resident), because shared memory holds only
//     the forward walk's buffers;
//   * the per-row LayerNorm statistics stay in shared memory.
// The reverse walk's dX = dz_c @ W^T runs through the forward's dense_layer
// on the transposed weights (packed input-major by the wrapper).

#pragma once

#include "walk.cuh"

namespace papr {

template <class T>
struct WalkBwdT {
  const T* wt[kMaxLayers];              // W_i^T, (pd[i+1], pd[i]) input-major
  T* hs[kMaxLayers + 1];                // stash of layer inputs, (N, width)
  T* dz[kMaxLayers + 1];                // stash of output grads (rounded to T)
  int b_off[kMaxLayers];                // db_i offset in a partial row
  int bias_len;                         // sum of pd[1..n]
  float* part;                          // (blocks, part_w) fp32 partial sums
  int part_w;
  float* scratch;                       // (blocks, kRows * (pd[0] + pd[n]))
};
using WalkBwd = WalkBwdT<__nv_bfloat16>;

// Partial row layout: [db_0 .. db_{n-1} | ln_in a, b (pd[0] each) |
// ln_out a, b (pd[n] each) | caller's extras]; the same layout as the
// wrapper's packed biases followed by its packed LayerNorm table.
template <class T>
inline int fill_walk_bwd(WalkBwdT<T>* b, const WalkDescT<T>& d,
                         const int* meta,
                         const void* wt_all, void* stash,
                         const long long* stash_off, int n_stash, float* part,
                         int part_w, float* scratch) {
  const int* pd = meta + 7;
  const int* w_off = pd + d.n + 1;
  const int* b_off = w_off + d.n;
  if (n_stash < d.n || n_stash > kMaxLayers + 1) return -111;
  for (int i = 0; i < d.n; ++i) {
    b->wt[i] = static_cast<const T*>(wt_all) + w_off[i];
    b->b_off[i] = b_off[i];
  }
  b->bias_len = b_off[d.n - 1] + pd[d.n];
  for (int i = 0; i < n_stash; ++i) {
    if (stash_off[i] % 8 != 0 || stash_off[n_stash + i] % 8 != 0) return -112;
    b->hs[i] = static_cast<T*>(stash) + stash_off[i];
    b->dz[i] = static_cast<T*>(stash) + stash_off[n_stash + i];
  }
  if (part_w < b->bias_len + 2 * pd[0] + 2 * pd[d.n]) return -113;
  b->part = part;
  b->part_w = part_w;
  b->scratch = scratch;
  return 0;
}

// Per-tile views: stash row of the tile's first token, this block's
// scratch and partial row, and the shared-memory LayerNorm statistics
// (mu_in, r_in, mu_out, r_out; kRows each).
struct TileCtx {
  size_t row0;
  float* xs;        // (kRows, pd[0]) fp32 encoding
  float* zs;        // (kRows, pd[n]) fp32 last-layer output (post-act)
  float* part;
  float* st;
};

template <class T>
__device__ __forceinline__ TileCtx tile_ctx(const WalkDescT<T>& d,
                                            const WalkBwdT<T>& b, size_t row0,
                                            float* st) {
  const int pd0 = d.pd[0], pdn = d.pd[d.n];
  float* base = b.scratch + (size_t)blockIdx.x * kRows * (pd0 + pdn);
  TileCtx c;
  c.row0 = row0;
  c.xs = base;
  c.zs = base + kRows * pd0;
  c.part = b.part + (size_t)blockIdx.x * b.part_w;
  c.st = st;
  return c;
}

// A (kRows x pd) tile of T -> stash rows [row0, row0 + kRows), 16 B a lane.
template <class T>
__device__ __forceinline__ void stash_tile(const T* A, T* dst, size_t row0,
                                           int pd) {
  constexpr int kV = 16 / sizeof(T);
  const int vpr = pd / kV;
  for (int v = threadIdx.x; v < kRows * vpr; v += kThreads) {
    const int r = v / vpr, c = (v - r * vpr) * kV;
    uint4 u = *reinterpret_cast<const uint4*>(A + r * kALd + c);
    *reinterpret_cast<uint4*>(dst + (row0 + r) * pd + c) = u;
  }
}

__device__ __forceinline__ void save_c(const float* C, float* dst, int pd) {
  for (int i = threadIdx.x; i < kRows * pd; i += kThreads) {
    const int r = i / pd, c = i - r * pd;
    dst[i] = C[r * kCLd + c];
  }
}

// Adds the column sums of C[:, :pd] over the tile's rows to part[0:pd].
__device__ __forceinline__ void colsum_add(const float* C, int pd,
                                           float* part) {
  for (int c = threadIdx.x; c < pd; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += C[r * kCLd + c];
    part[c] += s;
  }
}

// Forward walk on the encoded fp32 tile in C (complete, pad lanes 0), as
// run_walk, keeping what walk_bwd needs. Leaves the output in C (fp32) or,
// with out_bf16, as the next product's operand in A[0] (bf16: rounded; fp32:
// C itself); ends on a barrier.
template <class T>
__device__ __forceinline__ void walk_fwd_stash(const WalkSmemT<T>& s,
                                               const WalkDescT<T>& d,
                                               const WalkBwdT<T>& b,
                                               const TileCtx& x,
                                               bool out_bf16) {
  const int pd0 = d.pd[0], pdn = d.pd[d.n];
  if (d.has_li) {
    save_c(s.C, x.xs, pd0);
    layernorm_rows(s.C, s.A[0], true, d.d_enc, pd0, d.ln, d.ln + pd0, x.st,
                   x.st + kRows);
  } else {
    to_bf16(s.C, s.A[0], pd0);
  }
  __syncthreads();
  int cur = 0;
  for (int l = 0; l < d.n; ++l) {
    const bool last = l + 1 == d.n;
    stash_tile(s.A[cur], b.hs[l], x.row0, d.pd[l]);
    dense_layer(s.A[cur], s.C, last ? nullptr : s.A[cur ^ 1], s.W, d.w[l],
                d.b[l], d.pd[l], d.pd[l + 1], last ? d.last_act : d.act);
    __syncthreads();
    cur ^= 1;
  }
  save_c(s.C, x.zs, pdn);
  __syncthreads();
  if (d.has_lo) {
    const float* lo = d.ln + 2 * pd0;
    layernorm_rows(s.C, s.A[0], out_bf16, d.d_out, pdn, lo, lo + pdn,
                   x.st + 2 * kRows, x.st + 3 * kRows);
    __syncthreads();
  } else if (out_bf16) {
    to_bf16(s.C, s.A[0], pdn);
    __syncthreads();
  }
}

// _ln_bwd on the upstream gradient in C (first n_true lanes; pd lanes in
// all): adds da = sum_rows g * h and db = sum_rows g to the partial row and
// leaves dx in C (pad lanes 0). xsrc holds the LayerNorm's fp32 input.
__device__ __forceinline__ void ln_bwd(float* C, const float* xsrc,
                                       const float* mu, const float* rr,
                                       const float* a, int n_true, int pd,
                                       float* part_a, float* part_b) {
  for (int c = threadIdx.x; c < n_true; c += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const float g = C[r * kCLd + c];
      sa += g * ((xsrc[r * pd + c] - mu[r]) * rr[r]);
      sb += g;
    }
    part_a[c] += sa;
    part_b[c] += sb;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows; r += kWarps) {
    float* row = C + r * kCLd;
    const float* xr = xsrc + r * pd;
    const float m = mu[r], q = rr[r];
    float cs = 0.f;
    for (int c = lane; c < n_true; c += 32) cs += row[c] * a[c] * (xr[c] - m);
    cs = warp_sum(cs);
    const float sd = 1.f / q - kLnEps;         // recover std from r
    const float denom = (float)(n_true > 1 ? n_true - 1 : 1) * fmaxf(sd, 1e-30f);
    const float w = sd > 0.f ? -cs * q * q / denom : 0.f;
    float sum = 0.f;
    for (int c = lane; c < n_true; c += 32) {
      const float dd = row[c] * a[c] * q + w * (xr[c] - m);
      row[c] = dd;
      sum += dd;
    }
    const float mean = warp_sum(sum) / (float)n_true;
    for (int c = lane; c < pd; c += 32) row[c] = c < n_true ? row[c] - mean : 0.f;
  }
  __syncthreads();
}

// Reverse walk: C holds the gradient of the walk output (fp32, pd[n] lanes,
// pad lanes 0, complete). Leaves the gradient of the encoding in C (pd[0]
// lanes); parameter gradients go to the stash and the partial row.
template <class T>
__device__ __forceinline__ void walk_bwd(const WalkSmemT<T>& s,
                                         const WalkDescT<T>& d,
                                         const WalkBwdT<T>& b,
                                         const TileCtx& x) {
  const int n = d.n, pd0 = d.pd[0], pdn = d.pd[n];
  const int L = b.bias_len;
  if (d.has_lo)
    ln_bwd(s.C, x.zs, x.st + 2 * kRows, x.st + 3 * kRows, d.ln + 2 * pd0,
           d.d_out, pdn, x.part + L + 2 * pd0, x.part + L + 2 * pd0 + pdn);
  for (int l = n - 1; l >= 0; --l) {
    const int po = d.pd[l + 1];
    const int act = l == n - 1 ? d.last_act : d.act;
    const T* hnext = l == n - 1 ? nullptr : b.hs[l + 1];
    const int vpr = po >> 3;
    for (int v = threadIdx.x; v < kRows * vpr; v += kThreads) {
      const int r = v / vpr, c8 = (v - r * vpr) << 3;
      float* p = s.C + r * kCLd + c8;
      float hn[8];
      if (act == 1 && hnext) load8(hnext + (x.row0 + r) * po + c8, hn);
      float h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float g = p[e];
        if (act == 1) {
          const float a = hnext ? hn[e] : x.zs[r * pdn + c8 + e];
          if (!(a > 0.f)) g = 0.f;
        }
        p[e] = g;
        h[e] = g;
      }
      // The dX product's operand (fp32: A[0] is C, which holds it already)
      // and the dW stash, both rounded to T.
      if constexpr (!kF32<T>) store8(s.A[0] + r * kALd + c8, h);
      store8(b.dz[l] + (x.row0 + r) * po + c8, h);
    }
    __syncthreads();
    colsum_add(s.C, po, x.part + b.b_off[l]);
    dense_layer(s.A[0], s.C, nullptr, s.W, b.wt[l], nullptr, po, d.pd[l], 0);
    __syncthreads();
  }
  if (d.has_li)
    ln_bwd(s.C, x.xs, x.st, x.st + kRows, d.ln, d.d_enc, pd0, x.part + L,
           x.part + L + pd0);
}

// _pe_freq_bwd in place: C[r][c] *= d enc_c / d x_src(c) over the encoded
// columns (1 for raw columns, freq cos / -freq sin for sin / cos columns).
// src_val(r, src) returns the source value of row r.
template <class T, class SrcVal>
__device__ __forceinline__ void pe_bwd_deriv(float* C, const WalkDescT<T>& d,
                                             SrcVal src_val) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pd0 = d.pd[0];
  for (int c = lane; c < d.d_enc; c += 32) {
    const int kind = (int)d.plan[2 * pd0 + c];
    if (kind == 0) continue;
    const int src = (int)d.plan[c];
    const float freq = d.plan[pd0 + c];
    for (int r = warp; r < kRows; r += kWarps) {
      float sv, cv;
      sincosf(src_val(r, src) * freq, &sv, &cv);
      C[r * kCLd + c] *= kind == 1 ? cv * freq : -sv * freq;
    }
  }
}

// Per (row, source): the sum of C over the source's encoded columns
// [seg[s], seg[nsrc + s]) (contiguous in the posenc layout), handed to
// sink(r, s, value).
template <class Sink>
__device__ __forceinline__ void pe_source_sums(const float* C,
                                               const int* __restrict__ seg,
                                               int nsrc, Sink sink) {
  for (int i = threadIdx.x; i < kRows * nsrc; i += kThreads) {
    const int r = i / nsrc, sidx = i - r * nsrc;
    float v = 0.f;
    for (int c = seg[sidx]; c < seg[nsrc + sidx]; ++c) v += C[r * kCLd + c];
    sink(r, sidx, v);
  }
}

// ops/stream_attn.py _geom_bwd for one row: from d proj / d perp to
// d sel (= -d rayo) and d rays, recomputing the forward from the record
// row, the origin and the (normalized) direction.
__device__ __forceinline__ void geom_bwd_row(const float* prow,
                                             const float* o, const float* dr,
                                             const float* dproj,
                                             const float* dperp, float eps,
                                             float* dsel, float* drays) {
  float v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = prow[j] - o[j];
  const float t_al = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
  const float dd = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
  const float cc = t_al / (dd + eps);
  float dpe[3], dc = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dpe[j] = dproj[j] - dperp[j];
    dc += dpe[j] * dr[j];
  }
  const float dt = dc / (dd + eps);
  const float ddd = -dc * t_al / ((dd + eps) * (dd + eps));
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    dsel[j] = dperp[j] + dt * dr[j];
    drays[j] = dpe[j] * cc + dt * v[j] + 2.f * dr[j] * ddd;
  }
}

}  // namespace papr
