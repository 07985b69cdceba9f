// Fused embedder forward: posenc -> [LayerNorm] -> dense stack ->
// [LayerNorm] in one kernel, activations kept on chip.
//
// Replaces papr_tpu/ops/fused_mlp.py::fused_mlp (forward pallas_call at
// :551, kernel body _fwd_kernel :417). On the render path it is the query
// embedder: x (R, 3) fp32 ray directions -> (R, 256) bf16, 39 -> 256 x 5;
// under fused_attn: true|embed also the key and value stacks (117 encoded
// columns -> 256 x 5; 142 -> 256 x 7 -> 32, no LayerNorm).
//
// What bounds it on the H100: 2 * R * (48*256 + 4*256*256) FLOP against
// 12 B read + 512 B written per row -- compute bound on the tensor cores
// (~88 FLOP/B), with the posenc's precise sin/cos a minor second term.
//
// The bf16 kernel (papr_fused_mlp_fwd, fused_mlp_fwd_wgmma_kernel) is
// walk_wgmma.cuh's forward walk, the code K3 and the bf16 stream forwards
// run: a block of two warpgroups takes 128-row tiles of a persistent grid
// (one block an SM, each an even contiguous share of the tiles); each
// warpgroup encodes its 64 rows from the raw feature rows (wg_encode with a
// row functor), takes the input LayerNorm and rounds to bf16 in shared
// memory, and from then on the layers run on wgmma with the activations in
// registers, the weights streamed by TMA through a ring both warpgroups
// read (each staged byte serves 128 rows). The last layer's fp32 output goes
// through the output LayerNorm on the accumulator and is rounded to bf16
// into the rows of y through a swizzled staging tile (wg_store_rows). The
// rounding points are the TPU kernel's: each layer's input bf16, bias and
// activation fp32, the last layer's fp32 z into the output LayerNorm, the
// output cast to bf16.
//
// The fp32 kernel (papr_fused_mlp_f32_fwd, fused_mlp_fwd_wgmma_f32_kernel;
// use_amp: false) is the same function in walk_wgmma.cuh's fp32 operand
// form, the walk of the fp32 K3 and the fp32 stream forwards: the layer
// input fp32 in the warp's rows of shared memory (E, kF32Ld floats a row),
// the output in a 128-register accumulator, 3xTF32 m64n64k8 products on
// weights split into hi / lo once, at pack time (ops/fused_mlp.py
// pack_embed_wgmma), streamed through the same ring; the parameter rows read
// in place, no zero chunk, E zeroed once at the start; the output rows fp32
// through the warp's rows of E (wg_rows_out) into y, 16 bytes a lane. The
// rounding points are JAX's fp32 walk_body_fwd: nothing is rounded to bf16.
// Three tensor-core products per fp32-accurate one: bound by operations at
// a third of the TF32 rate.

#include "embed_wgmma.cuh"

using namespace papr;

// --------------------------------- bf16 and fp32: on wgmma + TMA ----
// (embed_wgmma.cuh: embed_fwd_wg, the walk without a head)

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma_kernel(const __grid_constant__ EmbedFwdWg p) {
  embed_fwd_wg(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma_f32_kernel(const __grid_constant__ EmbedFwdWgT<float> p) {
  embed_fwd_wg(p);
}

// Host side: the walk, its layer table and shared-memory layout
// (fill_embed_fwd_wg), then the launch.
template <class Op>
static int launch_embed_fwd(const float* x, int R, int d_raw,
                            const int* meta, const void* w_all,
                            const void* b_all, const void* ln,
                            const void* plan, void* y, const void* wpack,
                            long long wbytes, int grid, void* stream) {
  EmbedFwdWgT<Op> p{};
  size_t smem = 0;
  int err = fill_embed_fwd_wg(&p, meta, w_all, b_all, ln, plan, 0, wpack,
                              wbytes, &smem);
  if (err) return err;
  if (R <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(y) % 16) return -210;
  p.x = x;
  p.d_raw = d_raw;
  p.y = static_cast<Op*>(y);
  void (*kernel)(EmbedFwdWgT<Op>);
  if constexpr (kF32<Op>) kernel = fused_mlp_fwd_wgmma_f32_kernel;
  else kernel = fused_mlp_fwd_wgmma_kernel;
  return launch_embed_fwd_wg(p, kernel, R, grid, smem,
                             static_cast<cudaStream_t>(stream));
}

// The forward on wgmma, bf16 (papr_fused_mlp_fwd) and fp32
// (papr_fused_mlp_f32_fwd): the walk's meta row and its bias / LayerNorm /
// plan rows (w_all unread: the packed image replaces it), y, then the packed
// weights (ops/fused_mlp.py pack_embed_wgmma, the walk's layers in order;
// fp32: hi / lo stages) and their size in bytes, and the grid (1 .. the
// number of 128-row tiles).
#define FUSED_MLP_FWD_PARAMS                                                 \
    const float* x, int R, int d_raw, const int* meta, const void* w_all,    \
    const void* b_all, const void* ln, const void* plan, void* y,            \
    const void* wpack, long long wbytes, int grid, void* stream
#define FUSED_MLP_FWD_ARGS                                                   \
    x, R, d_raw, meta, w_all, b_all, ln, plan, y, wpack, wbytes, grid, stream

extern "C" int papr_fused_mlp_fwd(FUSED_MLP_FWD_PARAMS) {
  return launch_embed_fwd<__nv_bfloat16>(FUSED_MLP_FWD_ARGS);
}

extern "C" int papr_fused_mlp_f32_fwd(FUSED_MLP_FWD_PARAMS) {
  return launch_embed_fwd<float>(FUSED_MLP_FWD_ARGS);
}
