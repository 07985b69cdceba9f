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
// fused_mlp_f32 is the WMMA walk (walk.cuh) with fp32 operands
// (use_amp: false; fused_mlp.py _cdt = float32): fp32 activations, 3xTF32
// products, an fp32 output, one block of 512 threads per 64-row tile with
// the activations and each layer's weights (cp.async, double-buffered) in
// shared memory. Three tensor-core products per fp32-accurate one: bound by
// operations at a third of the TF32 rate.

#include "walk.cuh"
#include "walk_wgmma.cuh"

using namespace papr;

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_fwd_kernel(const float* __restrict__ x, int R, int d_raw,
                     WalkDescT<Op> d, Op* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmemT<Op> s = walk_smem<Op>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;

  encode_raw(s.C, d, x, r0, R, d_raw);
  __syncthreads();
  run_walk(s, d);

  const int dout = d.d_out;
  for (int r = warp; r < kRows; r += kWarps) {
    const int row = r0 + r;
    if (row >= R) continue;
    for (int c = lane; c < dout; c += 32)
      y[(size_t)row * dout + c] = to_act<Op>(s.C[r * kCLd + c]);
  }
}

template <class Op>
static int launch_fused_mlp_fwd(const float* x, int R, int d_raw,
                                const int* meta, const void* w_all,
                                const void* b_all, const void* ln,
                                const void* plan, void* y, void* stream) {
  WalkDescT<Op> d;
  int err = fill_walk(&d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  if (R <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWalkSmem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (R + kRows - 1) / kRows;
  fused_mlp_fwd_kernel<Op><<<grid, kThreads, kWalkSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, R, d_raw, d, static_cast<Op*>(y));
  return (int)cudaGetLastError();
}

extern "C" int papr_fused_mlp_f32_fwd(const float* x, int R, int d_raw,
                                      const int* meta, const void* w_all,
                                      const void* b_all, const void* ln,
                                      const void* plan, void* y,
                                      void* stream) {
  return launch_fused_mlp_fwd<float>(x, R, d_raw, meta, w_all, b_all, ln,
                                     plan, y, stream);
}

// ------------------------------------------- bf16: on wgmma + TMA ----

struct EmbedFwdWg {
  const float* x;                        // (R, d_raw) raw features
  int R, d_raw;
  WalkDesc d;                            // bias / LayerNorm / plan pointers
  WgLayer layers[kMaxLayers];
  WgChunk chunks[kWgMaxChunks];          // the chunk stream of one tile
  int n_chunks, stages;
  const unsigned char* w;                // the packed weights
  int ld, e_floats;                      // shared memory layout (floats)
  int nb, nln, nplan, n_prm;             // staged parameter rows (floats)
  int tiles, grid;                       // 128-row tiles over grid blocks
  __nv_bfloat16* y;                      // (R, d_out)
};

__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_fwd_wgmma_kernel(const __grid_constant__ EmbedFwdWg p) {
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * p.e_floats, p.n_prm);
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
  const WgWalk walk{&p.d, bias, lns, plan, p.layers};
  const int wg = threadIdx.x >> 7, row0 = 16 * ((threadIdx.x & 127) >> 5);
  float* E = sm.tiles + wg * p.e_floats;        // rows / parking / staging
  const float* __restrict__ x = p.x;
  const int R = p.R, d_raw = p.d_raw;
  uint32_t A[kARegs];
  float acc[kAccRegs];
#pragma unroll
  for (int i = 0; i < kARegs; ++i) A[i] = 0u;
#pragma unroll
  for (int i = 0; i < kAccRegs; ++i) acc[i] = 0.f;

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

// The bf16 forward on wgmma: the fp32 form's arguments (w_all unread: the
// packed image replaces it), then the packed weights (ops/fused_mlp.py
// pack_walk_wgmma, the walk's layers in order) and their size in bytes, and
// the grid (1 .. the number of 128-row tiles).
extern "C" int papr_fused_mlp_fwd(const float* x, int R, int d_raw,
                                  const int* meta, const void* w_all,
                                  const void* b_all, const void* ln,
                                  const void* plan, void* y,
                                  const void* wpack, long long wbytes,
                                  int grid, void* stream) {
  EmbedFwdWg p;
  int err = fill_walk(&p.d, meta, w_all, b_all, ln, plan);
  if (err) return err;
  int dims[kWgMaxLayers][2], n = 0;
  wg_walk_dims(dims, &n, p.d);
  if (wg_plan(p.layers, dims, n) != wbytes || !wpack ||
      reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  p.n_chunks = wg_chunks(p.chunks, p.layers, n);
  p.w = static_cast<const unsigned char*>(wpack);
  wg_walk_rows(p.d, &p.nb, &p.nln, &p.nplan);
  p.n_prm = p.nb + p.nln + p.nplan;
  p.ld = wg_ld(p.d.pd[0]);
  p.e_floats = wg_e_floats(p.ld);   // >= 64 rows x 512 bytes of staging
  size_t smem = 0;
  err = wg_ring_fit(wg_smem_rest(2 * p.e_floats, p.n_prm), &p.stages, &smem);
  if (err) return err;
  if (R <= 0) return 0;
  p.tiles = (R + kWgTile - 1) / kWgTile;
  if (grid < 1 || grid > p.tiles) return -209;
  p.grid = grid;
  p.x = x;
  p.R = R;
  p.d_raw = d_raw;
  p.y = static_cast<__nv_bfloat16*>(y);
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_fwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_fwd_wgmma_kernel<<<grid, kWgThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
