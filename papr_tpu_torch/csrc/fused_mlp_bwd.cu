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

#include "embed_wgmma.cuh"

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
// (embed_wgmma.cuh: embed_bwd_wg, the walk without a head)

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_bwd_wgmma_kernel(const __grid_constant__ EmbedBwdWg p) {
  embed_bwd_wg(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_bwd_wgmma_f32_kernel(const __grid_constant__ EmbedBwdWgT<float> p) {
  embed_bwd_wg(p);
}

// Host side: the walk, its product sequence (the forward layers, then W_l^T
// for l = n - 1 .. 0), the stash, the partial rows and the shared-memory
// layout (fill_embed_bwd_wg), then the launch.
template <class Op>
static int launch_embed_bwd(FUSED_MLP_BWD_PARAMS, const void* wpack,
                            long long wbytes, int grid, void* stream) {
  (void)wt_all;
  EmbedBwdWgT<Op> p{};
  size_t smem = 0;
  int err = fill_embed_bwd_wg(&p, meta, w_all, b_all, ln, plan, d_raw, 0,
                              wpack, wbytes, stash, stash_off, part, part_w,
                              scratch, &smem);
  if (err) return err;
  p.x = x;
  p.dy = dy;
  p.seg = seg;
  p.dx = dx;
  void (*kernel)(EmbedBwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = fused_mlp_bwd_wgmma_f32_kernel;
  else kernel = fused_mlp_bwd_wgmma_kernel;
  return launch_embed_bwd_wg(p, kernel, R, grid, smem,
                             static_cast<cudaStream_t>(stream));
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
