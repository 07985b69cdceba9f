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

#include "walk_wgmma.cuh"

using namespace papr;

// --------------------------------- bf16 and fp32: on wgmma + TMA ----

template <class Op>
struct EmbedFwdWgT {
  const float* x;                        // (R, d_raw) raw features
  int R, d_raw;
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  WgLayer layers[kMaxLayers];
  WgChunk chunks[kF32<Op> ? kWgMaxChunksF32 : kWgMaxChunks];  // one tile's
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  int ld, e_floats;                      // shared memory layout (floats)
  int nb, nln, nplan, n_prm;             // staged parameter rows (floats)
  int tiles, grid;                       // 128-row tiles over grid blocks
  Op* y;                                 // (R, d_out)
};
using EmbedFwdWg = EmbedFwdWgT<__nv_bfloat16>;

// The embedder forward on the block's share of the 128-row tiles, in either
// operand form (Op: bf16, or fp32).
template <class Op>
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
    // Every warp of the warpgroup is done with the staging rows (they
    // overlap the encoding rows) before any writes its encoding.
    named_sync(2 + wg, 128);
    const bool two = wg_walk(
        acc, A, rg, sm.zero, E, p.ld, walk, row0, true,
        [&](int r, int src) {
          const int row = rbase + r;
          return row < R ? x[(size_t)row * d_raw + src] : 0.f;
        });
    wg_store_rows(acc, A, E, two, p.y, rbase, R, p.d.d_out);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma_kernel(const __grid_constant__ EmbedFwdWg p) {
  embed_fwd_wg(p);
}

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma_f32_kernel(const __grid_constant__ EmbedFwdWgT<float> p) {
  embed_fwd_wg(p);
}

// Host side: the walk, its layer table in the form's image (wg_plan /
// wg_plan_f32: the walk's layers in order), the chunk stream and the
// shared-memory layout, then the launch.
template <class Op>
static int launch_embed_fwd(const float* x, int R, int d_raw,
                            const int* meta, const void* w_all,
                            const void* b_all, const void* ln,
                            const void* plan, void* y, const void* wpack,
                            long long wbytes, int grid, void* stream) {
  constexpr bool f32 = kF32<Op>;
  EmbedFwdWgT<Op> p;
  int err = fill_walk(&p.d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  int dims[kWgMaxLayers][2], n = 0;
  wg_walk_dims(dims, &n, p.d);
  const long long need = f32 ? wg_plan_f32(p.layers, dims, n)
                             : wg_plan(p.layers, dims, n);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p.n_chunks = f32 ? wg_chunks_f32(p.chunks, need)
                   : wg_chunks(p.chunks, p.layers, n);
  p.w = static_cast<const unsigned char*>(wpack);
  if constexpr (f32) {
    // Parameter rows read in place; E in the fp32 form's rows.
    p.nb = p.nln = p.nplan = p.n_prm = 0;
    p.ld = kF32Ld;
    p.e_floats = kWgRows * kF32Ld;
  } else {
    wg_walk_rows(p.d, &p.nb, &p.nln, &p.nplan);
    p.n_prm = p.nb + p.nln + p.nplan;
    p.ld = wg_ld(p.d.pd[0]);
    p.e_floats = wg_e_floats(p.ld);   // >= 64 rows x 512 bytes of staging
  }
  size_t smem = 0;
  err = wg_ring_fit(wg_smem_rest(2 * p.e_floats, p.n_prm, !f32), &p.stages,
                    &smem);
  if (err) return err;
  if (R <= 0) return 0;
  p.tiles = (R + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > p.tiles) return -209;
  if (reinterpret_cast<uintptr_t>(y) % 16) return -210;
  p.grid = grid;
  p.x = x;
  p.R = R;
  p.d_raw = d_raw;
  p.y = static_cast<Op*>(y);
  void (*kernel)(EmbedFwdWgT<Op>);
  if constexpr (f32) kernel = fused_mlp_fwd_wgmma_f32_kernel;
  else kernel = fused_mlp_fwd_wgmma_kernel;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kWgThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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
