// Fused embedder backward: recompute posenc -> [LayerNorm] -> dense stack ->
// [LayerNorm] on a tile, then the reverse walk to dx, with the parameter
// gradients reduced afterwards (wgrad.cu).
//
// Replaces papr_tpu/ops/fused_mlp.py::_fused_bwd_inner (pallas_call at :598,
// kernel body _bwd_kernel :424). On the training path it is the query
// embedder's backward: x (R, 3) fp32 ray directions and dy (R, 256) ->
// dx (R, 3), dW / db per layer, dLN in / out; under fused_attn: true|embed
// also the key and value stacks'.
//
// What bounds it on the H100: the recompute and the dX products, ~2x the
// forward's tensor-core work per row (the dW products are wgrad.cu's), plus
// the stash traffic (the layer inputs and bf16 output gradients, ~4.5 KB a
// row written once and read once by wgrad.cu).
//
// The bf16 kernel (papr_fused_mlp_bwd, fused_mlp_bwd_wgmma_kernel) runs the
// pieces of the bf16 stream backwards (walk_wgmma_bwd.cuh) on the raw
// feature rows: a block of two warpgroups takes 128-row tiles of a
// persistent grid (one block an SM, an even contiguous share of the tiles
// each; a tile is never split, so every dx row has one writer); per tile a
// warpgroup encodes its 64 rows (the fp32 encoding to a scratch slice for
// the posenc derivative and the input LayerNorm), recomputes the forward on
// wgmma with the activations in registers (the layer inputs to the stash,
// relu patterns as bit masks, the output LayerNorm's fp32 input to the
// scratch), takes dy into the accumulator, the output LayerNorm's backward
// on it, and the reverse walk on register-A wgmma with W^T through the same
// TMA-fed ring (dz rounded to bf16 for the dX product and the stash, db
// summed from the fp32 dz into a partial row a warp); then per warp the
// input LayerNorm's backward, the posenc derivative and the per-source sums
// into dx. The rounding points are JAX's (walk_body_bwd): each layer's input
// bf16, dz rounded to bf16 for both products, db from the fp32 dz, every
// gradient fp32.
//
// The fp32 kernel (papr_fused_mlp_f32_bwd, fused_mlp_bwd_wgmma_f32_kernel;
// use_amp: false) is the same function in walk_wgmma_bwd.cuh's fp32 operand
// form, the fp32 stream backwards' pieces: each layer's input fp32 in the
// warp's rows of shared memory E (kF32Ld floats a row), its output in a
// 128-register accumulator, 3xTF32 m64n64k8 products on W and W_l^T split
// into hi / lo at pack time, the rows stashed fp32 from E (16 bytes a lane)
// and reduced by wgrad.cu's fp32 form; no zero chunk, E zeroed once at the
// start. The rounding points are JAX's walk_body_bwd in fp32: nothing is
// rounded.

#include "walk_wgmma_bwd.cuh"

using namespace papr;

#define FUSED_MLP_BWD_PARAMS                                                 \
    const float* x, int R, int d_raw, const float* dy, const int* meta,      \
    const void* w_all, const void* b_all, const void* ln, const void* plan,  \
    const void* wt_all, void* stash, const long long* stash_off,             \
    const int* seg, float* dx, float* part, int part_w, float* scratch
#define FUSED_MLP_BWD_ARGS_NS                                                \
    x, R, d_raw, dy, meta, w_all, b_all, ln, plan, wt_all, stash, stash_off, \
    seg, dx, part, part_w, scratch

// --------------------------------- bf16 and fp32: on wgmma + TMA ----

template <class Op>
struct EmbedBwdWgT {
  const float* x;                        // (R, d_raw) raw features
  int R, d_raw;
  const float* dy;                       // (R, d_out) fp32
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  WgLayer layers[kWgMaxLayers];          // forward layers, W_l^T l = n-1..0
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // one tile's
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  Op* hs[kMaxLayers];                    // stash (N, width) per layer
  Op* dz[kMaxLayers];
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
};
using EmbedBwdWg = EmbedBwdWgT<__nv_bfloat16>;

// The embedder backward on the block's share of the 128-row tiles, in
// either operand form (Op: bf16, or fp32); see the header.
template <class Op>
__device__ __forceinline__ void embed_bwd_wg(const EmbedBwdWgT<Op>& p) {
  constexpr bool f32 = kF32<Op>;
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

    // --- dy in the accumulator's layout (with two, columns 0..127 parked);
    // overhang rows and pad columns zero ---
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
    if (d.has_lo)
      acc_ln_bwd(acc, two ? park : nullptr, zs_s, mo, ro, d_out, lo_a,
                 prow + L + 2 * pd0, prow + L + 2 * pd0 + pdn);

    // --- the reverse walk; layer 0's product is the encoding's gradient,
    // fp32 into the warp's rows of E ---
    wgb_rev(acc, A, rg, sm.zero, d, p.layers + n, p.dz, p.b_off, prow, srow0,
            masks, park, two, E, ld);
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

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_bwd_wgmma_kernel(const __grid_constant__ EmbedBwdWg p) {
  embed_bwd_wg(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_bwd_wgmma_f32_kernel(const __grid_constant__ EmbedBwdWgT<float> p) {
  embed_bwd_wg(p);
}

// Host side: the walk, its product sequence (the forward layers, then W_l^T
// for l = n - 1 .. 0) in the form's image (wg_plan / wg_plan_f32), the
// stash, the partial rows and the shared-memory layout, then the launch.
template <class Op>
static int launch_embed_bwd(FUSED_MLP_BWD_PARAMS, const void* wpack,
                            long long wbytes, int grid, void* stream) {
  constexpr bool f32 = kF32<Op>;
  (void)wt_all;
  EmbedBwdWgT<Op> p;
  int err = fill_walk(&p.d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  const WalkDesc& d = p.d;
  const int n = d.n;
  if (2 * n > kWgMaxLayers) return -206;
  if (d_raw > 32 * kSrcPerLane) return -208;
  int dims[kWgMaxLayers][2], m = 0;
  wg_walk_dims(dims, &m, d);
  for (int l = n - 1; l >= 0; --l, ++m) {
    dims[m][0] = d.pd[l + 1];
    dims[m][1] = d.pd[l];
  }
  const long long need = f32 ? wg_plan_f32(p.layers, dims, m)
                             : wg_plan(p.layers, dims, m);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p.n_chunks = f32 ? wg_chunks_f32(p.chunks, need)
                   : wg_chunks(p.chunks, p.layers, m);
  p.w = static_cast<const unsigned char*>(wpack);
  for (int i = 0; i < n; ++i) {
    if (stash_off[i] % 8 != 0 || stash_off[n + i] % 8 != 0) return -112;
    p.hs[i] = static_cast<Op*>(stash) + stash_off[i];
    p.dz[i] = static_cast<Op*>(stash) + stash_off[n + i];
  }
  const int* b_off = meta + 7 + (n + 1) + n;
  for (int i = 0; i < n; ++i) p.b_off[i] = b_off[i];
  p.bias_len = b_off[n - 1] + d.pd[n];
  if (part_w < p.bias_len + 2 * d.pd[0] + 2 * d.pd[n]) return -113;
  p.part = part;
  p.part_w = part_w;
  p.scratch = scratch;
  p.scr_wg = kWgRows * d.pd[0] + (d.has_lo ? kZsFloats : 0);
  int nb;
  wg_walk_rows(d, &nb, &p.nln, &p.nplan);
  p.n_prm = p.nln + p.nplan;
  if constexpr (f32) {
    // E in the fp32 form's rows; a mask slot a relu layer (the last layer
    // only with a relu last_act).
    p.ld = kF32Ld;
    p.e_floats = kWgRows * kF32Ld;
    p.n_mask = d.last_act == 1 ? n : n - 1;
  } else {
    p.ld = wg_ld(d.pd[0]);
    p.e_floats = wg_e_floats(p.ld);
    p.n_mask = n;
  }
  p.wg_floats = p.e_floats + p.n_mask * 4 * 128 + 2 * kWgRows;
  size_t smem = 0;
  err = wg_ring_fit(wg_smem_rest(2 * p.wg_floats, p.n_prm, !f32), &p.stages,
                    &smem);
  if (err) return err;
  if (R <= 0) return 0;
  p.tiles = (R + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > p.tiles) return -209;
  p.grid = grid;
  p.x = x;
  p.R = R;
  p.d_raw = d_raw;
  p.dy = dy;
  p.seg = seg;
  p.dx = dx;
  void (*kernel)(EmbedBwdWgT<Op>);
  if constexpr (f32) kernel = fused_mlp_bwd_wgmma_f32_kernel;
  else kernel = fused_mlp_bwd_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The backward on wgmma, bf16 (papr_fused_mlp_bwd) and fp32
// (papr_fused_mlp_f32_bwd): the walk's meta row and parameter rows (w_all /
// wt_all unread: the packed image replaces them), the stash in the form's
// type (rows of the 128-row tiles), part (8 rows a block), scratch (2 scr_wg
// floats a block, scr_wg = 64 pd[0] (+ 128 x 128 with an output
// LayerNorm)), then the packed weights (ops/fused_mlp.py pack_embed_wgmma:
// the forward layers, then W_l^T for l = n-1 .. 0; fp32: hi / lo stages)
// and their size in bytes, and the grid (1 .. the number of 128-row tiles).
extern "C" int papr_fused_mlp_bwd(FUSED_MLP_BWD_PARAMS, const void* wpack,
                                  long long wbytes, int grid, void* stream) {
  return launch_embed_bwd<__nv_bfloat16>(FUSED_MLP_BWD_ARGS_NS, wpack,
                                         wbytes, grid, stream);
}

extern "C" int papr_fused_mlp_f32_bwd(FUSED_MLP_BWD_PARAMS,
                                      const void* wpack, long long wbytes,
                                      int grid, void* stream) {
  return launch_embed_bwd<float>(FUSED_MLP_BWD_ARGS_NS, wpack, wbytes, grid,
                                 stream);
}
