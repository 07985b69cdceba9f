// One-shot eval attention: point records -> (fused features, attention).
//
// Replaces papr_tpu/ops/stream_attn.py::attend_stream_eval (pallas_call at
// :2087, kernel body _ase_fwd_kernel :1856). Per (ray, k): point-ray
// geometry -> key posenc (117) -> LN -> 5 x 256 -> LN -> w_k ->
// relu(q.k / sqrt(d)) * influence, alive-masked; value posenc (78) + 64
// point features -> 8 layers -> 32; then a background-seeded online softmax
// and the renormalized fuse.
//
// What bounds it on the H100: the two walks, ~1.6 MFLOP of bf16 tensor-core
// work per (ray, k) token (~20 TFLOP per 800x800 frame at k = 20) against
// ~300 B of record read per token — compute bound. Every design here loops
// over k inside the block (the TPU grid's sequential k axis, which carried
// the running max and accumulator in VMEM scratch; blocks run in no order,
// so nothing carries between them), reads only the record rows, the ray
// data and qq, and writes only (T, C) + (T, K + 1). The kernels gather
// record rows by index from the (P, 128) record instead of a pre-gathered
// (K, T, 128) tensor (6.55 GB at one 800x800 tile).
//
// attend_eval_wgmma_kernel (below) runs the walks on wgmma, 128 rays a
// block, on walk_wgmma.cuh's forward walk, the code the bf16 stream
// forwards (key_stream.cu, value_stream.cu) run too: in bf16
// (papr_attend_eval) with the activations in registers, in fp32
// (papr_attend_eval_f32: use_amp: false, _ase_fwd_kernel with cdt =
// float32) with the activations in shared memory and 3xTF32 products; both
// walks, the w_k product and its bias in fp32 there, the value rows not
// rounded before the fuse.
//
// attend_eval_i8 is the same call with quant=True (tpu.int8_eval): both
// walks' dense stacks run walk.cuh's int8 walk (walk_body_fwd_q in
// papr_tpu/ops/fused_mlp.py:322) on a quantization the wrapper calibrated,
// on one tile function: one block of 512 threads per 64-ray tile, every
// activation in shared memory, each layer's weights staged by cp.async once
// per (tile, k) step and shared by the 16 warps; geometry, posenc,
// LayerNorms, the bf16 w_k product on y_k rounded to bf16, scores, the
// value rows rounded to bf16, softmax and fuse. int8 halves the bytes of
// every MMA operand; the WMMA instruction count per layer is the bf16 one.
// attend_eval_i8_f32 is the int8 kernel beside fp32 compute (int8_eval with
// use_amp: false): the int8 walks unchanged, then the fp32 epilogue (the
// 3xTF32 w_k product on the unrounded y_k, fp32 bias, value rows not
// rounded), as _ase_fwd_kernel runs it with cdt = float32.

#include "rec_stream.cuh"
#include "stream_common.cuh"
#include "walk_wgmma.cuh"

using namespace papr;

// One tile of kRows rays of the int8 kernels, Op the epilogue's operand
// type; kq / vq: the walks' int8 forms.
template <class Op>
__device__ __forceinline__ void attend_eval_tile(
    unsigned char* smem, const float* __restrict__ record, int rec_w,
    const int* __restrict__ idx, int T, int K, const float* __restrict__ rayo,
    const float* __restrict__ rays, const float* __restrict__ qq, int dm,
    float sqrt_dm, const WalkDescT<Op>& kd, const WalkQuant& kq,
    const Op* __restrict__ wk, const float* __restrict__ bk,
    int dm_pad, const WalkDescT<Op>& vd, const WalkQuant& vq, int score_relu,
    float bkg, int normalize, float eps, float* __restrict__ fused,
    float* __restrict__ attn) {
  const WalkSmemT<Op> S = walk_smem<Op>(smem);   // the epilogue's
  const WalkSmem Q = walk_smem_q<Op>(smem);      // the int8 walks' (same C)
  float* C = S.C;
  float* geo = reinterpret_cast<float*>(S.extra);            // kRows x kGeo
  float* m_run = geo + kRows * kGeo;                         // kRows
  float* ss = m_run + kRows;                                 // kRows x K
  const int cout = vd.d_out;
  float* acc = ss + kRows * K;                               // kRows x cout
  int* gidx = reinterpret_cast<int*>(acc + kRows * cout);    // kRows

  const int t0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int r = tid; r < kRows; r += kThreads) m_run[r] = bkg;
  for (int i = tid; i < kRows * cout; i += kThreads) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    // --- geometry (papr_tpu/ops/geometry.py point_ray_geometry) ---
    if (tid < kRows) {
      const int t = t0 + tid;
      const bool valid = t < T;
      const int g = valid ? idx[(size_t)t * K + k] : 0;
      const float* rec = record + (size_t)g * rec_w;
      float o[3], dr[3], v[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        o[j] = valid ? rayo[(size_t)t * 3 + j] : 0.f;
        dr[j] = valid ? rays[(size_t)t * 3 + j] : 0.f;
        v[j] = rec[j] - o[j];
      }
      const float t_al = v[0] * dr[0] + v[1] * dr[1] + v[2] * dr[2];
      const float dd = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2];
      const float cc = t_al / (dd + eps);
      float* gr = geo + tid * kGeo;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float proj = dr[j] * cc;
        gr[j] = rec[j];
        gr[3 + j] = proj;
        gr[6 + j] = v[j] - proj;
      }
      gr[9] = rec[3];
      gr[10] = rec[4];
      gidx[tid] = g;
    }
    __syncthreads();

    // --- key walk -> w_k -> score column ---
    encode_rec(C, kd, geo, gidx, record, rec_w);
    __syncthreads();
    // y_k as the w_k product's operand: rounded to bf16 in A[0], or fp32 in
    // C (the fp32 epilogue's A[0]).
    run_walk_q(Q, kd, kq, !kF32<Op>);
    dense_layer(S.A[0], C, nullptr, S.W, wk, nullptr, kd.pd[kd.n], dm_pad, 0);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int t = t0 + r;
      float s = 0.f;
      if (t < T) {
        const float* qrow = qq + (size_t)t * dm;
        for (int c = lane; c < dm; c += 32) {
          // nn/mlp.py linear_apply in the compute type (bf16: matmul
          // rounded to bf16, bias add in bf16), promoted to fp32.
          const float kk = linear_c<Op>(C[r * kCLd + c], bk[c]);
          s += qrow[c] * kk;
        }
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float col = s / sqrt_dm;
        const float sact = score_relu ? fmaxf(col, 0.f) : col;
        const float* gr = geo + r * kGeo;
        ss[r * K + k] = gr[10] > 0.5f ? sact * gr[9] : kNegBig;
      }
    }
    __syncthreads();

    // --- value walk -> online softmax-weighted accumulation ---
    encode_rec(C, vd, geo, gidx, record, rec_w);
    __syncthreads();
    run_walk_q(Q, vd, vq);
    for (int r = warp; r < kRows; r += kWarps) {
      const float s = ss[r * K + k];
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, s);
      const float scale = expf(m_old - m_new), e = expf(s - m_new);
      for (int c = lane; c < cout; c += 32) {
        const float yc = act_round<Op>(C[r * kCLd + c]);
        acc[r * cout + c] = acc[r * cout + c] * scale + e * yc;
      }
    }
    __syncthreads();
    if (tid < kRows) m_run[tid] = fmaxf(m_run[tid], ss[tid * K + k]);
    __syncthreads();
  }

  // --- background-token softmax, renormalized fuse ---
  for (int r = warp; r < kRows; r += kWarps) {
    const int t = t0 + r;
    if (t >= T) continue;
    const float m = m_run[r];
    float z = 0.f;
    for (int k = lane; k < K; k += 32) z += expf(ss[r * K + k] - m);
    z = warp_sum(z);
    const float eb = expf(bkg - m);
    const float denom = z + eb;
    float* arow = attn + (size_t)t * (K + 1);
    for (int k = lane; k < K; k += 32) arow[k] = expf(ss[r * K + k] - m) / denom;
    if (lane == 0) arow[K] = eb / denom;
    const float dn = normalize ? (z > 0.f ? z : 1.f) : denom;
    for (int c = lane; c < cout; c += 32)
      fused[(size_t)t * cout + c] = acc[r * cout + c] / dn;
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads, 1)
attend_eval_i8_kernel(const float* __restrict__ record, int rec_w,
                      const int* __restrict__ idx, int T, int K,
                      const float* __restrict__ rayo,
                      const float* __restrict__ rays,
                      const float* __restrict__ qq, int dm, float sqrt_dm,
                      WalkDescT<Op> kd, WalkQuant kq,
                      const Op* __restrict__ wk,
                      const float* __restrict__ bk, int dm_pad,
                      WalkDescT<Op> vd,
                      WalkQuant vq, int score_relu, float bkg, int normalize,
                      float eps, float* __restrict__ fused,
                      float* __restrict__ attn) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend_eval_tile(smem, record, rec_w, idx, T, K, rayo, rays, qq, dm,
                   sqrt_dm, kd, kq, wk, bk, dm_pad, vd, vq, score_relu, bkg,
                   normalize, eps, fused, attn);
}

// ------------------------------------------ bf16 and fp32: on wgmma + TMA --
//
// The bf16 kernel (papr_attend_eval) and the fp32 kernel
// (papr_attend_eval_f32) are the same function on walk_wgmma.cuh's forward
// walk, which the bf16 stream forwards (key_stream.cu, value_stream.cu) run
// too, in its two operand forms: a block of two warpgroups takes 128 rays;
// each warpgroup owns 64 of them and loops over k, and the two read every
// layer's packed weight chunks (key layers, w_k, value layers, once per k)
// from one TMA-fed ring. A token's record row is idx[t * K + k]. After the
// key walk and the score, the value walk's fp32 rows (rounded to bf16 in
// the bf16 form) go into a background-seeded online softmax. The fp32 form
// reads its parameter rows from global memory: its shared memory holds the
// fp32 activations (walk_wgmma.cuh, the fp32 operand form).

struct EvalWg {
  const float* record;
  int rec_w;
  const int* idx;
  int T, K;
  const float* rayo;
  const float* rays;
  const float* qq;
  int dm;
  float sqrt_dm;
  WalkDesc kd, vd;
  const float* bk;
  int dm_pad, score_relu;
  float bkg;
  int normalize;
  float eps;
  float* fused;
  float* attn;
  WgLayer layers[kWgMaxLayers];
  WgChunk chunks[kWgMaxChunksF32];  // the weight stream of one k step
  int n_chunks;
  const unsigned char* w;        // the packed weights of every layer
  int stages;                    // weight ring depth
  int ld;                        // floats a row of the encoding tile
  int wg_floats;                 // per-warpgroup tiles, floats
  int e_floats;                  // of which the encoding / parking tile
  int nb[2], nln[2], nplan[2];   // parameter rows staged (key, value)
  int n_prm;                     // all staged parameter floats
};

template <class Op>
__global__ void __launch_bounds__(kWgThreads, 1)
attend_eval_wgmma_kernel(const __grid_constant__ EvalWg p) {
  constexpr bool f32 = kF32<Op>;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw, p.stages, 2 * p.wg_floats, p.n_prm);
  if constexpr (f32) {
    // Every E column a product reads is finite from the start (columns
    // past a walk's input width meet zero weight rows).
    for (int i = threadIdx.x; i < 2 * p.wg_floats; i += kWgThreads)
      sm.tiles[i] = 0.f;
  }
  // Parameter rows: key biases, LayerNorms, plan, then b_k, then value.
  float* kbias = sm.prm;
  float* kln = kbias + p.nb[0];
  float* kplan = kln + p.nln[0];
  float* bks = kplan + p.nplan[0];
  float* vbias = bks + p.dm_pad;
  float* vln = vbias + p.nb[1];
  float* vplan = vln + p.nln[1];
  {
    const float* const src[7] = {p.kd.b[0], p.kd.ln, p.kd.plan, p.bk,
                                 p.vd.b[0], p.vd.ln, p.vd.plan};
    const int cnt[7] = {p.nb[0], p.nln[0], p.nplan[0], f32 ? 0 : p.dm_pad,
                        p.nb[1], p.nln[1], p.nplan[1]};
    wg_prologue(sm, p.stages, src, cnt);
  }
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n_key = p.kd.n;
  WgRing rg{sm.ring, sm.full, sm.released, p.stages, 0, p.n_chunks,
            p.n_chunks * p.K, p.chunks, p.w};
  wg_ring_start(rg);
  const WgWalk kw{&p.kd, f32 ? p.kd.b[0] : kbias, f32 ? p.kd.ln : kln,
                  f32 ? p.kd.plan : kplan, p.layers};
  const WgWalk vw{&p.vd, f32 ? p.vd.b[0] : vbias, f32 ? p.vd.ln : vln,
                  f32 ? p.vd.plan : vplan, p.layers + n_key + 1};
  const float* bkr = f32 ? p.bk : bks;
  {
    const int t_in = tid & 127, w = t_in >> 5, lane = t_in & 31;
    const int g = lane >> 2, q = lane & 3;
    const int row0 = 16 * w;                            // the warp's rows
    const int ld = p.ld;
    float* geo = sm.tiles + wg * p.wg_floats;           // kWgRows x kGeo
    float* E = geo + kWgRows * kGeo;                    // kWgRows x ld
    const int cout = p.vd.d_out;
    float* accv = E + p.e_floats;                       // kWgRows x cout
    const int rbase = blockIdx.x * kWgTile + wg * kWgRows;
    const int T = p.T, K = p.K;
    const int rl[2] = {row0 + g, row0 + g + 8};
    for (int i = lane; i < 16 * cout; i += 32) accv[row0 * cout + i] = 0.f;
    float m_run[2] = {p.bkg, p.bkg};
    float ss[2];
    float* park_f = E;                                  // between passes
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

    for (int k = 0; k < K; ++k) {
      // Every warp of the warpgroup is done with the parking slices (they
      // overlap the encoding rows) before any writes its encoding.
      named_sync(2 + wg, 128);
      wg_geometry(geo, p.record, p.rec_w, p.rayo, p.rays, T, rbase, row0,
                  p.eps, [&](int t) { return p.idx[(size_t)t * K + k]; });

      // --- key walk -> w_k -> score ---
      wg_walk(acc, A, rg, sm.zero, E, ld, kw, row0, false,
              RecSrc{geo, p.record, p.rec_w});
      float col[2];
      wg_score(acc, A, rg, sm.zero, p.layers[n_key], p.qq, p.dm, bkr,
               p.sqrt_dm, T, rbase, rl, col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = rbase + rl[h];
        const float* gr = geo + rl[h] * kGeo;
        ss[h] = masked_score(col[h], p.score_relu, gr[9], gr[10] > 0.5f);
        if (q == 0 && t < T) p.attn[(size_t)t * (K + 1) + k] = ss[h];
      }

      // --- value walk -> online softmax-weighted accumulation of its fp32
      // rows (rounded to bf16 in the bf16 form) as the fuse reads them ---
      const bool two = wg_walk(acc, A, rg, sm.zero, E, ld, vw, row0, true,
                               RecSrc{geo, p.record, p.rec_w});
      const int tt = tid & 127;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], ss[h]);
        const float scale = expf(m_run[h] - m_new);
        const float e = expf(ss[h] - m_new);
        float* arow = accv + rl[h] * cout;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = 4 * j + 2 * h + x, c = 8 * j + 2 * q + x;
            if (two && c < cout)
              arow[c] = arow[c] * scale +
                        e * act_round<Op>(park_f[i * 128 + tt]);
            const int c1 = (two ? kPassN : 0) + c;
            if (c1 < cout)
              arow[c1] = arow[c1] * scale + e * act_round<Op>(acc[i]);
          }
        m_run[h] = m_new;
      }
    }

    // --- background-token softmax, renormalized fuse (warp per row) ---
    if (q == 0) {
      geo[rl[0] * kGeo + 11] = m_run[0];
      geo[rl[1] * kGeo + 11] = m_run[1];
    }
    __syncwarp();
    for (int r = row0; r < row0 + 16; ++r) {
      const int t = rbase + r;
      if (t >= T) continue;
      const float m = geo[r * kGeo + 11];
      float* arow = p.attn + (size_t)t * (K + 1);
      float z = 0.f;
      for (int k = lane; k < K; k += 32) z += expf(arow[k] - m);
      z = warp_sum(z);
      const float eb = expf(p.bkg - m);
      const float denom = z + eb;
      for (int k = lane; k < K; k += 32) arow[k] = expf(arow[k] - m) / denom;
      if (lane == 0) arow[K] = eb / denom;
      const float dn = p.normalize ? (z > 0.f ? z : 1.f) : denom;
      for (int c = lane; c < cout; c += 32)
        p.fused[(size_t)t * cout + c] = accv[r * cout + c] / dn;
    }
  }
}

template <class Op>
static int launch_attend_eval_wgmma(
    const float* record, int rec_w, const int* idx, int T, int K,
    const float* rayo, const float* rays, const float* qq, int dm,
    float sqrt_dm, const int* kmeta, const void* kw, const void* kb,
    const void* kln, const void* kplan, const void* bk, int dm_pad,
    const int* vmeta, const void* vw, const void* vb, const void* vln,
    const void* vplan, int score_relu, float bkg, int normalize, float eps,
    void* fused, void* attn, const void* wpack, int wbytes, void* stream) {
  constexpr bool f32 = kF32<Op>;
  EvalWg p;
  int err = fill_walk(&p.kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  err = fill_walk(&p.vd, vmeta, vw, vb, vln, vplan);
  if (err) return err;
  if (dm_pad <= 0 || dm_pad > kMaxWidth || dm_pad % 16 != 0 || dm > dm_pad)
    return -201;
  if (K <= 0 || K > 128) return -202;
  if (T <= 0) return 0;
  int dims[kWgMaxLayers][2], n = 0;
  wg_walk_dims(dims, &n, p.kd);
  dims[n][0] = p.kd.pd[p.kd.n];
  dims[n++][1] = dm_pad;
  wg_walk_dims(dims, &n, p.vd);
  const long long need = f32 ? wg_plan_f32(p.layers, dims, n)
                              : wg_plan(p.layers, dims, n);
  if (need != wbytes || !wpack || reinterpret_cast<uintptr_t>(wpack) % 16)
    return -204;
  if constexpr (f32) {
    // Every stage full, in stream order; parameter rows read in place.
    p.n_chunks = wg_chunks_f32(p.chunks, need);
    for (int i = 0; i < 2; ++i) p.nb[i] = p.nln[i] = p.nplan[i] = 0;
    p.n_prm = 0;
    p.ld = kF32Ld;
    p.e_floats = kWgRows * kF32Ld;
  } else {
    p.n_chunks = wg_chunks(p.chunks, p.layers, n);
    wg_walk_rows(p.kd, &p.nb[0], &p.nln[0], &p.nplan[0]);
    wg_walk_rows(p.vd, &p.nb[1], &p.nln[1], &p.nplan[1]);
    p.n_prm = p.nb[0] + p.nln[0] + p.nplan[0] + dm_pad + p.nb[1] + p.nln[1] +
              p.nplan[1];
    const int pd0 = p.kd.pd[0] > p.vd.pd[0] ? p.kd.pd[0] : p.vd.pd[0];
    p.ld = wg_ld(pd0);
    p.e_floats = wg_e_floats(p.ld);
  }
  p.wg_floats = kWgRows * kGeo + p.e_floats + kWgRows * p.vd.d_out;
  size_t smem = 0;
  err = wg_ring_fit(wg_smem_rest(2 * p.wg_floats, p.n_prm), &p.stages, &smem);
  if (err) return err;
  p.record = record;
  p.rec_w = rec_w;
  p.idx = idx;
  p.T = T;
  p.K = K;
  p.rayo = rayo;
  p.rays = rays;
  p.qq = qq;
  p.dm = dm;
  p.sqrt_dm = sqrt_dm;
  p.bk = static_cast<const float*>(bk);
  p.dm_pad = dm_pad;
  p.score_relu = score_relu;
  p.bkg = bkg;
  p.normalize = normalize;
  p.eps = eps;
  p.fused = static_cast<float*>(fused);
  p.attn = static_cast<float*>(attn);
  p.w = static_cast<const unsigned char*>(wpack);
  cudaError_t e = cudaFuncSetAttribute(
      attend_eval_wgmma_kernel<Op>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  attend_eval_wgmma_kernel<Op><<<(T + kWgTile - 1) / kWgTile, kWgThreads,
                                 smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The int8 kernels' launcher, Op the epilogue's operand type (bf16 or fp32).
template <class Op>
static int launch_attend_eval_i8(
    const float* record, int rec_w, const int* idx, int T, int K,
    const float* rayo, const float* rays, const float* qq, int dm,
    float sqrt_dm, const int* kmeta, const void* kw, const void* kb,
    const void* kln, const void* kplan, const void* wk, const void* bk,
    int dm_pad, const int* vmeta, const void* vw, const void* vb,
    const void* vln, const void* vplan, int score_relu, float bkg,
    int normalize, float eps, void* fused, void* attn, const void* kwq,
    const void* kinv, const void* kdq, const void* vwq, const void* vinv,
    const void* vdq, void* stream) {
  WalkDescT<Op> kd, vd;
  int err = fill_walk(&kd, kmeta, kw, kb, kln, kplan);
  if (err) return err;
  err = fill_walk(&vd, vmeta, vw, vb, vln, vplan);
  if (err) return err;
  WalkQuant kq, vq;
  err = fill_walk_quant(&kq, kd, kmeta, kwq, kinv, kdq);
  if (err) return err;
  err = fill_walk_quant(&vq, vd, vmeta, vwq, vinv, vdq);
  if (err) return err;
  if (dm_pad <= 0 || dm_pad > kMaxWidth || dm_pad % 16 != 0 || dm > dm_pad)
    return -201;
  if (K <= 0 || K > 128) return -202;
  if (T <= 0) return 0;
  const size_t smem = kWalkSmem + sizeof(float) * kRows *
      (kGeo + 1 + K + vd.d_out) + sizeof(int) * kRows;
  if (smem > 232448) return -203;      // the H100's per-block maximum
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (T + kRows - 1) / kRows;
  const Op* wkp = static_cast<const Op*>(wk);
  const float* bkp = static_cast<const float*>(bk);
  cudaError_t e = cudaFuncSetAttribute(
      attend_eval_i8_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  attend_eval_i8_kernel<Op><<<grid, kThreads, smem, st>>>(
      record, rec_w, idx, T, K, rayo, rays, qq, dm, sqrt_dm, kd, kq, wkp, bkp,
      dm_pad, vd, vq, score_relu, bkg, normalize, eps,
      static_cast<float*>(fused), static_cast<float*>(attn));
  return (int)cudaGetLastError();
}

#define ATTEND_EVAL_PARAMS                                                   \
    const float* record, int rec_w, const int* idx, int T, int K,            \
    const float* rayo, const float* rays, const float* qq, int dm,           \
    float sqrt_dm, const int* kmeta, const void* kw, const void* kb,         \
    const void* kln, const void* kplan, const void* wk, const void* bk,      \
    int dm_pad, const int* vmeta, const void* vw, const void* vb,            \
    const void* vln, const void* vplan, int score_relu, float bkg,           \
    int normalize, float eps, void* fused, void* attn
#define ATTEND_EVAL_ARGS                                                     \
    record, rec_w, idx, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb,    \
    kln, kplan, wk, bk, dm_pad, vmeta, vw, vb, vln, vplan, score_relu, bkg,  \
    normalize, eps, fused, attn

// The kernels on wgmma: the tile function's arguments (w_k unread), then
// the packed weights of every layer (bf16: ops/fused_mlp.py
// pack_walk_wgmma; fp32: pack_walk_wgmma_f32) and their size in bytes.
#define ATTEND_EVAL_WGMMA_ARGS                                               \
    record, rec_w, idx, T, K, rayo, rays, qq, dm, sqrt_dm, kmeta, kw, kb,    \
    kln, kplan, bk, dm_pad, vmeta, vw, vb, vln, vplan, score_relu, bkg,      \
    normalize, eps, fused, attn, wpack, wbytes, stream
extern "C" int papr_attend_eval(ATTEND_EVAL_PARAMS, const void* wpack,
                                int wbytes, void* stream) {
  (void)wk;
  return launch_attend_eval_wgmma<__nv_bfloat16>(ATTEND_EVAL_WGMMA_ARGS);
}

extern "C" int papr_attend_eval_f32(ATTEND_EVAL_PARAMS, const void* wpack,
                                    int wbytes, void* stream) {
  (void)wk;
  return launch_attend_eval_wgmma<float>(ATTEND_EVAL_WGMMA_ARGS);
}

extern "C" int papr_attend_eval_i8(ATTEND_EVAL_PARAMS, const void* kwq,
                                   const void* kinv, const void* kdq,
                                   const void* vwq, const void* vinv,
                                   const void* vdq, void* stream) {
  return launch_attend_eval_i8<__nv_bfloat16>(ATTEND_EVAL_ARGS, kwq, kinv,
                                              kdq, vwq, vinv, vdq, stream);
}

extern "C" int papr_attend_eval_i8_f32(ATTEND_EVAL_PARAMS, const void* kwq,
                                       const void* kinv, const void* kdq,
                                       const void* vwq, const void* vinv,
                                       const void* vdq, void* stream) {
  return launch_attend_eval_i8<float>(ATTEND_EVAL_ARGS, kwq, kinv, kdq,
                                      vwq, vinv, vdq, stream);
}
