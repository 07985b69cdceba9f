// Point-record helpers shared by the attention kernels (attend_eval.cu,
// key_stream.cu, value_stream.cu): the per-row point-ray geometry and the
// posenc of one walk's sources.
//
// A point record row is [xyz, influence, alive, point features..., 0-pad]
// (papr.py _point_record). Geometry is ops/geometry.py point_ray_geometry:
// v = p - o, proj = d * (v . d) / (d . d + eps), perp = v - proj.

#pragma once

#include "walk.cuh"

namespace papr {

constexpr int kGeo = 12;              // sel(3) proj(3) perp(3) influ alive pad
constexpr int kNGeoSrc = 9;           // posenc sources 0..8: pos, proj, perp

// Encoded columns of one walk from the per-row geometry: sources 0..8 are
// [pos, proj, perp], source 9 + j is record lane 5 + j (point features).
// Each lane reads its columns' plan once and walks the rows.
template <class T>
__device__ __forceinline__ void encode_rec(float* C, const WalkDescT<T>& d,
                                           const float* geo, const int* gidx,
                                           const float* __restrict__ record,
                                           int rec_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pd0 = d.pd[0];
  for (int c = lane; c < pd0; c += 32) {
    const bool live = c < d.d_enc;
    const int src = live ? (int)d.plan[c] : 0;
    const float freq = live ? d.plan[pd0 + c] : 0.f;
    const int kind = live ? (int)d.plan[2 * pd0 + c] : 0;
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + i * kWarps;
      float v = 0.f;
      if (live) {
        const float x = src < kNGeoSrc
            ? geo[r * kGeo + src]
            : record[(size_t)gidx[r] * rec_w + 5 + (src - kNGeoSrc)];
        v = encode_value(x, freq, kind);
      }
      C[r * kCLd + c] = v;
    }
  }
}

// Geometry of the block's rows t0.. for slot k of the k-major (K, T, rec_w)
// record: gidx[r] = k * T + t. Overhang rows (t >= T) read record row 0
// with a zero ray (finite values; their gradients are zeroed by callers).
__device__ __forceinline__ void geometry_rows(float* geo, int* gidx,
                                              const float* __restrict__ rec,
                                              int rec_w, int T, int k, int t0,
                                              const float* __restrict__ rayo,
                                              const float* __restrict__ rays,
                                              float eps) {
  const int tid = threadIdx.x;
  if (tid >= kRows) return;
  const int t = t0 + tid;
  const bool valid = t < T;
  const int g = valid ? k * T + t : 0;
  const float* row = rec + (size_t)g * rec_w;
  float o[3], dr[3], v[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o[j] = valid ? rayo[(size_t)t * 3 + j] : 0.f;
    dr[j] = valid ? rays[(size_t)t * 3 + j] : 0.f;
    v[j] = row[j] - o[j];
  }
  const float t_al = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
  const float dd = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
  const float cc = t_al / (dd + eps);
  float* gr = geo + tid * kGeo;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float proj = dr[j] * cc;
    gr[j] = row[j];
    gr[3 + j] = proj;
    gr[6 + j] = v[j] - proj;
  }
  gr[9] = row[3];
  gr[10] = row[4];
  gidx[tid] = g;
}

}  // namespace papr
