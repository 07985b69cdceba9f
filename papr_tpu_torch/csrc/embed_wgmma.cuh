// The embedder walk on wgmma, forward and backward, for its two launchers:
// the fused embedder (fused_mlp.cu / fused_mlp_bwd.cu: posenc -> [LayerNorm]
// -> dense stack -> [LayerNorm], rows out) and the query chain of the folded
// key stream (key_stream_q.cu: the same walk on the raw ray directions, then
// a HEAD, the linear layer w_q / b_q, whose fp32 output qq is what the
// kernel writes). Each function takes the operand form (Op: bf16, or fp32,
// walk_wgmma.cuh) and kHead; a launcher instantiates its own __global__
// wrapper and hands it to launch_embed_{fwd,bwd}_wg.
//
// The head (kHead) runs on the walk's output where the walk leaves it for a
// next product (bf16: the A fragments, rounded; fp32: the warp's rows of
// E), through one more layer of the weight image (pd[n] -> head_pd). Its
// bias is added as the form's linear layer adds it (nn/mlp.py
// linear_apply): bf16, the product rounded to bf16 and the bias added in
// bf16 (linear_bf16, as wg_score's w_k); fp32, in fp32, unrounded. Its
// backward takes the head's output gradient dy (R, d_head) in place of the
// walk's: the walk's output is stashed as the head's input, dy's column
// sums go to the head's bias row and dy to the dz stash (dW_h = y^T dy,
// wgrad.cu), then dy W_h^T, the image's next layer (head_pd -> pd[n]), is
// the gradient of the walk's output, from where the embedder's backward
// goes on unchanged. Without the head the code is the embedder's as it was
// (the head's branches are compile-time). The head's backward
// (wgb_head_bwd) exists in the fp32 form only: the bf16 folded key stream's
// backward (row 7) runs on walk.cuh's WMMA kernel.

#pragma once

#include "walk_wgmma_bwd.cuh"

namespace papr {

// ------------------------------------------------------------ forward ----

template <class Op>
struct EmbedFwdWgT {
  const float* x;                        // (R, d_raw) raw features
  int R, d_raw;
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  WgLayer layers[kMaxLayers + 1];        // the walk, then (head) W_h
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // one tile's
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  int ld, e_floats;                      // shared memory layout (floats)
  int nb, nln, nplan, n_prm;             // staged parameter rows (floats)
  int tiles, grid;                       // 128-row tiles over grid blocks
  Op* y;                                 // (R, d_out), without the head
  // the head: its padded width, its bias (head_pd fp32), its output
  int head_pd, d_head;
  const float* hb;
  float* hy;                             // (R, d_head) fp32
};
using EmbedFwdWg = EmbedFwdWgT<__nv_bfloat16>;

// The fp32 head on the walk's output (wg_walk without rows_f32 leaves it in
// the warp's rows of E, the next product's operand), the bias added in
// fp32, its d_head columns written to the warpgroup's rows rbase + r < R of
// hy: every column in acc, written by wg_store_rows.
__device__ __forceinline__ void wg_head_rows(float (&acc)[kOutRegs],
                                             WgRowsA& A, WgRing& rg,
                                             const unsigned char*, float* E,
                                             const WgLayer& L,
                                             const float* hb, float* hy,
                                             int rbase, int R, int d_head) {
  wg_gemm_f32(acc, A.E, A.row0, rg, L);
  acc_bias_act(acc, hb, L.pd_out, 0);
  wg_store_rows(acc, A, E, false, hy, rbase, R, d_head);
}

// The bf16 head on the walk's output (wg_walk without rows_f32 leaves it,
// rounded to bf16, in the A fragments): the product in passes of kPassN
// columns over the same A (two for a head wider than 128, as wg_score's
// w_k), each value linear_bf16(product, bias), written as fp32 straight
// from the accumulator to the warpgroup's rows rbase + r < R of hy (d_head
// wide): a thread's two adjacent columns as one 8-byte store where d_head
// is even (hy 16-byte aligned), else one at a time.
__device__ __forceinline__ void wg_head_rows(float (&acc)[kAccRegs],
                                             uint32_t (&A)[kARegs],
                                             WgRing& rg,
                                             const unsigned char* zero,
                                             float*, const WgLayer& L,
                                             const float* __restrict__ hb,
                                             float* __restrict__ hy,
                                             int rbase, int R, int d_head) {
  const int t = threadIdx.x & 127, g = (t & 31) >> 2, q = t & 3;
  const int row0 = 16 * (t >> 5);
  const bool pairs = (d_head & 1) == 0;
  for (int pass = 0; pass < (L.ni > kPassN ? 2 : 1); ++pass) {
    wg_pass(acc, A, rg, L, zero);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + row0 + g + 8 * h;
      if (row >= R) continue;
      float* yrow = hy + (size_t)row * d_head;
#pragma unroll
      for (int j = 0; j < kAccRegs / 4; ++j) {
        const int c = kPassN * pass + 8 * j + 2 * q;
        if (c >= d_head) continue;
        const float v0 = linear_bf16(acc[4 * j + 2 * h], hb[c]);
        if (pairs) {
          const float v1 = linear_bf16(acc[4 * j + 2 * h + 1], hb[c + 1]);
          *reinterpret_cast<float2*>(yrow + c) = make_float2(v0, v1);
        } else {
          yrow[c] = v0;
          if (c + 1 < d_head)
            yrow[c + 1] = linear_bf16(acc[4 * j + 2 * h + 1], hb[c + 1]);
        }
      }
    }
  }
}

// The embedder forward on the block's share of the 128-row tiles, in either
// operand form (Op: bf16, or fp32), with or without the head.
template <class Op, bool kHead = false>
__device__ __forceinline__ void embed_fwd_wg(const EmbedFwdWgT<Op>& p) {
  constexpr bool f32 = kF32<Op>;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * p.e_floats, p.n_prm,
                            !f32);
  if constexpr (f32) {
    // Every E column a product reads is finite from the start (columns
    // past a walk's input width meet zero weight rows).
    for (int i = threadIdx.x; i < 2 * p.e_floats; i += kWgThreads)
      sm.tiles[i] = 0.f;
  }
  // Parameter rows (bf16 form): biases, LayerNorms, plan.
  float* bias = sm.prm;
  float* lns = bias + p.nb;
  float* plan = lns + p.nln;
  {
    const float* const src[3] = {p.d.b[0], p.d.ln, p.d.plan};
    const int cnt[3] = {p.nb, p.nln, p.nplan};
    wg_prologue(sm, p.stages, src, cnt);
  }
  const int t_begin = (int)((long long)p.tiles * blockIdx.x / p.grid);
  const int t_end = (int)((long long)p.tiles * (blockIdx.x + 1) / p.grid);
  WgRing rg{sm.ring, sm.full, sm.released, p.stages, 0, p.n_chunks,
            p.n_chunks * (t_end - t_begin), p.chunks, p.w};
  wg_ring_start(rg);
  const WgWalk walk{&p.d, f32 ? p.d.b[0] : bias, f32 ? p.d.ln : lns,
                    f32 ? p.d.plan : plan, p.layers};
  const int wg = threadIdx.x >> 7, row0 = 16 * ((threadIdx.x & 127) >> 5);
  float* E = sm.tiles + wg * p.e_floats;        // rows / parking / staging
  const float* __restrict__ x = p.x;
  const int R = p.R, d_raw = p.d_raw;
  // The operand form's registers: bf16, a pass's accumulator and the A
  // fragments; fp32, a whole layer's accumulator (A: the rows of E).
  constexpr int kAcc = f32 ? kOutRegs : kAccRegs;
  std::conditional_t<f32, WgRowsA, uint32_t[kARegs]> A;
  float acc[kAcc];
  if constexpr (f32) {
    A = WgRowsA{E, row0};
  } else {
#pragma unroll
    for (int i = 0; i < kARegs; ++i) A[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int rbase = tile * kWgTile + wg * kWgRows;
    const auto src = [&](int r, int s) {
      const int row = rbase + r;
      return row < R ? x[(size_t)row * d_raw + s] : 0.f;
    };
    // Every warp of the warpgroup is done with the staging rows (they
    // overlap the encoding rows) before any writes its encoding.
    named_sync(2 + wg, 128);
    if constexpr (kHead) {
      wg_walk(acc, A, rg, sm.zero, E, p.ld, walk, row0, false, src);
      wg_head_rows(acc, A, rg, sm.zero, E, p.layers[p.d.n], p.hb, p.hy,
                   rbase, R, p.d_head);
    } else {
      const bool two = wg_walk(acc, A, rg, sm.zero, E, p.ld, walk, row0,
                               true, src);
      wg_store_rows(acc, A, E, two, p.y, rbase, R, p.d.d_out);
    }
  }
}

// Host side: the walk, its layer table in the form's image (wg_plan /
// wg_plan_f32: the walk's layers in order, then with head_pd > 0 the head,
// pd[n] -> head_pd), the chunk stream and the shared-memory layout. Returns
// 0 or a negative code; *smem gets the block's bytes.
template <class Op>
inline int fill_embed_fwd_wg(EmbedFwdWgT<Op>* p, const int* meta,
                             const void* w_all, const void* b_all,
                             const void* ln, const void* plan, int head_pd,
                             const void* wpack, long long wbytes,
                             size_t* smem) {
  constexpr bool f32 = kF32<Op>;
  int err = fill_walk(&p->d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  int dims[kWgMaxLayers][2], n = 0;
  wg_walk_dims(dims, &n, p->d);
  if (head_pd) {
    if (head_pd % 16 != 0 || head_pd > kMaxWidth) return -201;
    dims[n][0] = p->d.pd[p->d.n];
    dims[n++][1] = head_pd;
  }
  const long long need = f32 ? wg_plan_f32(p->layers, dims, n)
                             : wg_plan(p->layers, dims, n);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p->n_chunks = f32 ? wg_chunks_f32(p->chunks, need)
                    : wg_chunks(p->chunks, p->layers, n);
  p->w = static_cast<const unsigned char*>(wpack);
  p->head_pd = head_pd;
  if constexpr (f32) {
    // Parameter rows read in place; E in the fp32 form's rows.
    p->nb = p->nln = p->nplan = p->n_prm = 0;
    p->ld = kF32Ld;
    p->e_floats = kWgRows * kF32Ld;
  } else {
    wg_walk_rows(p->d, &p->nb, &p->nln, &p->nplan);
    p->n_prm = p->nb + p->nln + p->nplan;
    p->ld = wg_ld(p->d.pd[0]);
    p->e_floats = wg_e_floats(p->ld);   // >= 64 rows x 512 bytes of staging
  }
  return wg_ring_fit(wg_smem_rest(2 * p->e_floats, p->n_prm, !f32),
                     &p->stages, smem);
}

// Host side: p (filled, its rows and outputs set) launched as kernel on grid
// blocks (1 .. the number of 128-row tiles of R).
template <class Op>
inline int launch_embed_fwd_wg(EmbedFwdWgT<Op> p,
                               void (*kernel)(EmbedFwdWgT<Op>), int R,
                               int grid, size_t smem, cudaStream_t st) {
  if (R <= 0) return 0;
  p.R = R;
  p.tiles = (R + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > p.tiles) return -209;
  p.grid = grid;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- backward ----

template <class Op>
struct EmbedBwdWgT {
  const float* x;                        // (R, d_raw) raw features
  int R, d_raw;
  const float* dy;                       // (R, d_out), or (head) (R, d_head)
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  WgLayer layers[kWgMaxLayers];          // forward layers, (head) W_h^T,
                                         // W_l^T l = n-1..0
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // one tile's
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  Op* hs[kMaxLayers + 1];                // stash (N, width) per layer input
  Op* dz[kMaxLayers + 1];                // and output gradient (head last)
  int b_off[kMaxLayers];
  int bias_len;
  float* part;                           // (grid * 8, part_w)
  int part_w;
  float* scratch;                        // scr_wg floats per warpgroup
  int scr_wg;
  const int* seg;                        // posenc segments of the d_raw sources
  float* dx;                             // (R, d_raw)
  int ld, e_floats, wg_floats;           // shared memory layout (floats)
  int n_mask;                            // relu mask slots (4 x 128 words)
  int nln, nplan, n_prm;                 // staged LayerNorms, plan (floats)
  int tiles, grid;                       // 128-row tiles over grid blocks
  // the head: its padded width, its output's true width, where its bias
  // gradient sits in a partial row
  int head_pd, d_head, dbh_off;
};
using EmbedBwdWg = EmbedBwdWgT<__nv_bfloat16>;

// The head's backward (see the header): the walk's output in acc
// (every column) through E to the stash hs; dy in the accumulator's layout,
// its column sums into part_db, through E to the dz stash and the product
// dy W_h^T (HT), whose output, the gradient of the walk's output, is left in
// acc.
__device__ __forceinline__ void wgb_head_bwd(float (&acc)[kOutRegs],
                                             WgRowsA& A, WgRing& rg,
                                             float* hs, float* dz,
                                             size_t srow0, int pdn,
                                             const WgLayer& HT,
                                             const float* __restrict__ dy,
                                             int rbase, int R, int d_head,
                                             float* part_db, int head_pd) {
  const int q = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
  const int rl[2] = {A.row0 + g, A.row0 + g + 8};
  wg_rows_out(acc, A.E, A.row0);
  stash_rows_f32(A.E, hs, srow0, pdn, A.row0);
#pragma unroll
  for (int i = 0; i < kOutRegs; ++i) {
    const int row = rbase + rl[(i >> 1) & 1];
    const int c = 8 * (i >> 2) + 2 * q + (i & 1);
    acc[i] = row < R && c < d_head ? dy[(size_t)row * d_head + c] : 0.f;
  }
  colsum_layer([&](int i) { return acc[i]; }, part_db, head_pd);
  wg_rows_out(acc, A.E, A.row0);
  stash_rows_f32(A.E, dz, srow0, head_pd, A.row0);
  wg_gemm_f32(acc, A.E, A.row0, rg, HT);
}

// The embedder backward on the block's share of the 128-row tiles, in
// either operand form (Op: bf16, or fp32), with or without the head; see
// fused_mlp_bwd.cu's header.
template <class Op, bool kHead = false>
__device__ __forceinline__ void embed_bwd_wg(const EmbedBwdWgT<Op>& p) {
  constexpr bool f32 = kF32<Op>;
  static_assert(f32 || !kHead, "the head's backward has its fp32 form only");
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * p.wg_floats, p.n_prm,
                            !f32);
  if constexpr (f32) {
    // Every E column a product reads is finite from the start (columns
    // past a layer's input width meet zero weight rows).
    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)
      sm.tiles[i] = 0.f;
  }
  float* lns = sm.prm;
  float* plan = lns + p.nln;
  {
    const float* const src[2] = {p.d.ln, p.d.plan};
    const int cnt[2] = {p.nln, p.nplan};
    wg_prologue(sm, p.stages, src, cnt);
  }
  const int t_begin = (int)((long long)p.tiles * blockIdx.x / p.grid);
  const int t_end = (int)((long long)p.tiles * (blockIdx.x + 1) / p.grid);
  WgRing rg{sm.ring, sm.full, sm.released, p.stages, 0, p.n_chunks,
            p.n_chunks * (t_end - t_begin), p.chunks, p.w};
  wg_ring_start(rg);

  const WalkDesc& d = p.d;
  const int tid = threadIdx.x, wg = tid >> 7, t_in = tid & 127;
  const int w = t_in >> 5, lane = t_in & 31, g = lane >> 2, q = lane & 3;
  const int row0 = 16 * w;
  const int n = d.n, pd0 = d.pd[0], pdn = d.pd[n], L = p.bias_len;
  const int ld = p.ld, R = p.R, d_raw = p.d_raw, d_out = d.d_out;
  const int rl[2] = {row0 + g, row0 + g + 8};
  float* E = sm.tiles + wg * p.wg_floats;         // rows / parking slices
  uint32_t* masks = reinterpret_cast<uint32_t*>(E + p.e_floats);
  float* st = reinterpret_cast<float*>(masks + p.n_mask * 4 * 128);  // mu, r in
  float* park = E;
  float* prow =
      p.part + (size_t)(blockIdx.x * kBwdPartRows + 4 * wg + w) * p.part_w;
  float* enc_s = p.scratch + (size_t)(blockIdx.x * 2 + wg) * p.scr_wg;
  float* zs_s = enc_s + kWgRows * pd0;
  const float* lo_a = lns + 2 * pd0;
  const float* lo_b = lo_a + pdn;
  const float* __restrict__ x = p.x;
  const float* __restrict__ dy = p.dy;

  // The posenc segments of the lane's sources (for the per-source sums).
  int seg0[kSrcPerLane], seg1[kSrcPerLane];
#pragma unroll
  for (int j = 0; j < kSrcPerLane; ++j) {
    const int s = lane + 32 * j;
    seg0[j] = s < d_raw ? p.seg[s] : 0;
    seg1[j] = s < d_raw ? p.seg[d_raw + s] : 0;
  }
  // The operand form's registers: bf16, a pass's accumulator and the A
  // fragments; fp32, a whole layer's accumulator (A: the warp's rows of E).
  constexpr int kAcc = f32 ? kOutRegs : kAccRegs;
  std::conditional_t<f32, WgRowsA, uint32_t[kARegs]> A;
  float acc[kAcc];
  if constexpr (f32) {
    A = WgRowsA{E, row0};
  } else {
#pragma unroll
    for (int i = 0; i < kARegs; ++i) A[i] = 0u;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float mo[2] = {0.f, 0.f}, ro[2] = {1.f, 1.f};

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int rbase = tile * kWgTile + wg * kWgRows;
    const size_t srow0 = (size_t)rbase;
    // --- the encoding: fp32 to the scratch, input LayerNorm, the layer-0
    // operand (bf16: rounded, the A fragments; fp32: E as it is) ---
    wgb_encode(E, ld, d, plan, row0, [&](int r, int src) {
      const int row = rbase + r;
      return row < R ? x[(size_t)row * d_raw + src] : 0.f;
    });
    __syncwarp();
    for (int r = row0; r < row0 + 16; ++r)
      for (int c = lane; c < pd0; c += 32) enc_s[r * pd0 + c] = E[r * ld + c];
    wgb_rows_in_st<Op>(E, ld, d, lns, st, row0);
    if constexpr (f32) {
      stash_rows_f32(E, p.hs[0], srow0, pd0, row0);
    } else {
      stash_rows(E, ld, p.hs[0], srow0, pd0, row0);
      smem_to_a(reinterpret_cast<const unsigned char*>(E + row0 * ld),
                4 * ld, pd0, A);
      // Every warp has read its rows before any thread parks over them.
      named_sync(2 + wg, 128);
    }

    // --- forward recompute; the output LayerNorm's statistics ---
    const bool two = wgb_fwd(acc, A, rg, sm.zero, d, p.layers, p.hs, srow0,
                             masks, park, zs_s);
    if (d.has_lo)
      acc_layernorm_st(acc, two ? park : nullptr, d_out, lo_a, lo_b, mo, ro);

    if constexpr (kHead) {
      // --- the head's backward: the gradient of the walk's output in the
      // accumulator's layout (with two, columns 0..127 parked) ---
      wgb_head_bwd(acc, A, rg, p.hs[n], p.dz[n], srow0, pdn, p.layers[n],
                   dy, rbase, R, p.d_head, prow + p.dbh_off, p.head_pd);
    } else {
      // --- dy in the accumulator's layout (with two, columns 0..127
      // parked); overhang rows and pad columns zero ---
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int row = rbase + rl[(i >> 1) & 1];
        const int c = 8 * (i >> 2) + 2 * q + (i & 1);
        const int c1 = (two ? kPassN : 0) + c;
        if (two)
          park[i * 128 + t_in] =
              row < R && c < d_out ? dy[(size_t)row * d_out + c] : 0.f;
        acc[i] = row < R && c1 < d_out ? dy[(size_t)row * d_out + c1] : 0.f;
      }
    }
    if (d.has_lo)
      acc_ln_bwd(acc, two ? park : nullptr, zs_s, mo, ro, d_out, lo_a,
                 prow + L + 2 * pd0, prow + L + 2 * pd0 + pdn);

    // --- the reverse walk; layer 0's product is the encoding's gradient,
    // fp32 into the warp's rows of E ---
    wgb_rev(acc, A, rg, sm.zero, d, p.layers + n + (kHead ? 1 : 0), p.dz,
            p.b_off, prow, srow0, masks, park, two, E, ld);
    __syncwarp();

    // --- per warp: input LayerNorm backward, posenc derivative, the
    // per-source sums into dx ---
    wgb_in_bwd(E, ld, d, enc_s, st, lns, plan, prow, L, row0, seg0, seg1,
               d_raw, [&](int r, int src, float v) {
                 const int row = rbase + r;
                 if (row < R) p.dx[(size_t)row * d_raw + src] = v;
               });
  }
}

// Host side: the walk, its product sequence (the forward layers, then with
// head_pd > 0 the head's W_h^T (head_pd -> pd[n]), then W_l^T for l = n - 1
// .. 0) in the form's image (wg_plan / wg_plan_f32), the stash (per layer
// input, then per output gradient, the head's last in each: stash_off has
// 2 (n + 1) entries with the head, 2 n without), the partial rows (the head's
// bias gradient at dbh_off, after the walk's columns) and the shared-memory
// layout. Returns 0 or a negative code; *smem gets the block's bytes.
template <class Op>
inline int fill_embed_bwd_wg(EmbedBwdWgT<Op>* p, const int* meta,
                             const void* w_all, const void* b_all,
                             const void* ln, const void* plan, int d_raw,
                             int head_pd, const void* wpack, long long wbytes,
                             void* stash, const long long* stash_off,
                             float* part, int part_w, float* scratch,
                             size_t* smem) {
  constexpr bool f32 = kF32<Op>;
  int err = fill_walk(&p->d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  const WalkDesc& d = p->d;
  const int n = d.n, head = head_pd ? 1 : 0;
  if (2 * n + head > kWgMaxLayers) return -206;
  if (d_raw > 32 * kSrcPerLane) return -208;
  if (head_pd && (head_pd % 16 != 0 || head_pd > kMaxWidth)) return -201;
  int dims[kWgMaxLayers][2], m = 0;
  wg_walk_dims(dims, &m, d);
  if (head_pd) {
    dims[m][0] = head_pd;
    dims[m++][1] = d.pd[n];
  }
  for (int l = n - 1; l >= 0; --l, ++m) {
    dims[m][0] = d.pd[l + 1];
    dims[m][1] = d.pd[l];
  }
  const long long need = f32 ? wg_plan_f32(p->layers, dims, m)
                             : wg_plan(p->layers, dims, m);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p->n_chunks = f32 ? wg_chunks_f32(p->chunks, need)
                    : wg_chunks(p->chunks, p->layers, m);
  p->w = static_cast<const unsigned char*>(wpack);
  const int n_stash = n + head;
  for (int i = 0; i < n_stash; ++i) {
    if (stash_off[i] % 8 != 0 || stash_off[n_stash + i] % 8 != 0) return -112;
    p->hs[i] = static_cast<Op*>(stash) + stash_off[i];
    p->dz[i] = static_cast<Op*>(stash) + stash_off[n_stash + i];
  }
  const int* b_off = meta + 7 + (n + 1) + n;
  for (int i = 0; i < n; ++i) p->b_off[i] = b_off[i];
  p->bias_len = b_off[n - 1] + d.pd[n];
  p->head_pd = head_pd;
  p->dbh_off = p->bias_len + 2 * d.pd[0] + 2 * d.pd[n];
  if (part_w < p->dbh_off + head_pd) return -113;
  p->part = part;
  p->part_w = part_w;
  p->scratch = scratch;
  p->scr_wg = kWgRows * d.pd[0] + (d.has_lo ? kZsFloats : 0);
  int nb;
  wg_walk_rows(d, &nb, &p->nln, &p->nplan);
  p->n_prm = p->nln + p->nplan;
  if constexpr (f32) {
    // E in the fp32 form's rows; a mask slot a relu layer (the last layer
    // only with a relu last_act).
    p->ld = kF32Ld;
    p->e_floats = kWgRows * kF32Ld;
    p->n_mask = d.last_act == 1 ? n : n - 1;
  } else {
    p->ld = wg_ld(d.pd[0]);
    p->e_floats = wg_e_floats(p->ld);
    p->n_mask = n;
  }
  p->wg_floats = p->e_floats + p->n_mask * 4 * 128 + 2 * kWgRows;
  p->d_raw = d_raw;
  return wg_ring_fit(wg_smem_rest(2 * p->wg_floats, p->n_prm, !f32),
                     &p->stages, smem);
}

// Host side: p (filled, its inputs and outputs set) launched as kernel on
// grid blocks (1 .. the number of 128-row tiles of R; a tile is never
// split, so every dx row has one writer).
template <class Op>
inline int launch_embed_bwd_wg(EmbedBwdWgT<Op> p,
                               void (*kernel)(EmbedBwdWgT<Op>), int R,
                               int grid, size_t smem, cudaStream_t st) {
  if (R <= 0) return 0;
  p.R = R;
  p.tiles = (R + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > p.tiles) return -209;
  p.grid = grid;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace papr
