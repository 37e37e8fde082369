// Fused NICER decoder trunks, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_color` /
// `nicer_fused_geo` (hpslam_tpu/ops/fused_mlp.py): the forward
// `_fwd_kernel` (:278, launched by `_fused_fwd` :506) and the remat
// backward `_bwd_kernel` (:299, launched by `_fused_bwd` :548).
//
// Both kernels run a block per tile of TC_TM samples on the tile code of
// nicer_trunk_tc.cuh: every trunk product on the tensor cores at f32
// accuracy (3xTF32 mma.sync), the tile's activations and each layer's
// weights in shared memory.
//
// Forward (kernel #4): the Fourier embeds, the ReLU geometry trunk and,
// with colour, the Softplus(beta=100) colour trunk; writes occ (n,) and
// raw rgb (n, 3) (zero without colour) and nothing else: the Pallas
// forward keeps every activation in VMEM, and #5 recomputes the forward.
// Geometry-only stages ask for the geometry trunk's shared memory alone
// (~81 KB against ~210 KB with colour), so two blocks fit an SM.
//
// Backward (kernel #5): the forward recomputed (as the Pallas kernel
// does), the output cotangents, both trunk backwards, giving d(c_geo),
// d(c_col) and, with need_dp, the cotangent of the sample positions
// through the embeds:
//   dp = 2 pi (cos(proj_g) d_eg) Bg^T
//      + 2 pi (cos(proj_c) d_ec_sin - sin(proj_c) d_ec_cos) Bc^T.
// Then, with need_wgrads and colour, the colour core's weight gradients,
// summed over every sample in fixed ranges (no atomics), on the same
// tensor-core products; only the pre-activations and the rows the weight
// gradients read go to global memory.  The geometry core and both Fourier
// B matrices are frozen, as in the reference: no gradient is computed.
//
// Bound on the card: operations (about 0.2 MFLOP per sample forward and
// twice that backward, against ~0.3 kB of input per sample).
#include "nicer_trunk_tc.cuh"

struct TShape {
  int n, C, with_color, need_dp;
};

// Cs (TC_TM x C) from a sample-major (n, C) feature and, if Cg is given,
// the feature rows.
__device__ void tile_feat(const float* __restrict__ c, int C, float* Cs,
                          float* Cg, long m0, long M) {
  for (int e = threadIdx.x; e < TC_TM * C; e += blockDim.x) {
    const int r = e / C, ch = e % C;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M) {
      v = c[m * C + ch];
      if (Cg) Cg[(long)ch * M + m] = v;
    }
    Cs[r * (C + 4) + ch] = v;
  }
}

// Gs (TC_TM x 8, zero beyond nout) from a sample-major (n, nout) cotangent
// and, if Gg is given, the G rows.
__device__ void tile_cot(const float* __restrict__ g, int nout, float* Gs,
                         float* Gg, long m0, long M) {
  for (int e = threadIdx.x; e < TC_TM * 8; e += blockDim.x) {
    const int r = e / 8, c = e % 8;
    const long m = m0 + r;
    float v = 0.0f;
    if (c < nout && m < M) {
      v = g[m * nout + c];
      if (Gg) Gg[(long)c * M + m] = v;
    }
    Gs[r * TC_GLD + c] = v;
  }
}

// (n, C) rows of a sample-major output from Cs.
__device__ void tile_feat_out(const float* Cs, int C, float* out, long m0,
                              long M) {
  for (int e = threadIdx.x; e < TC_TM * C; e += blockDim.x) {
    const int r = e / C, ch = e % C;
    if (m0 + r < M) out[(m0 + r) * C + ch] = Cs ? Cs[r * (C + 4) + ch] : 0.0f;
  }
}

// Kernel #4: a tile of TC_TM samples per block, both trunk forwards; occ
// and rgb straight from the output tile, no scratch rows.
__global__ void __launch_bounds__(TC_THREADS, 2)
    tr_fwd_tiles(const float* __restrict__ p, const float* __restrict__ cg,
                 const float* __restrict__ cc, const float* __restrict__ Bg,
                 const float* __restrict__ Bc, Core gw, Core cw, TShape sh,
                 TcSmem sm, float* __restrict__ occ,
                 float* __restrict__ rgb) {
  extern __shared__ float4 tc_raw[];
  const TcTile T = tc_tile((float*)tc_raw, sm);
  const Rows none = {};
  const long M = sh.n;
  const long m0 = (long)blockIdx.x * TC_TM;
  const int C = sh.C;
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x)
    T.Ps[e] = m0 + e / 3 < M ? p[3 * m0 + e] : 0.0f;
  tile_feat(cg, C, T.Cs, nullptr, m0, M);
  __syncthreads();
  const int embp_g = round8(gw.emb);
  tile_embed(T.Ps, Bg, false, gw.emb, embp_g, T.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, none, 0, T, embp_g, m0, M, false, true);
  for (int r = threadIdx.x; r < TC_TM; r += blockDim.x)
    if (m0 + r < M) occ[m0 + r] = T.Gs[r * TC_GLD];
  if (sh.with_color) {
    // Cs, Es and Gs are rewritten only after the syncs that follow
    // (tc_trunk_fwd's layer staging), so the occ reads above are done
    tile_feat(cc, C, T.Cs, nullptr, m0, M);
    const int embp_c = round8(cw.emb);
    tile_embed(T.Ps, Bc, true, cw.emb, embp_c, T.Es, nullptr, m0, M);
    __syncthreads();
    tc_trunk_fwd(cw, none, 1, T, embp_c, m0, M, false, true);
  }
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x) {
    const int r = e / 3, c = e % 3;
    if (m0 + r < M)
      rgb[3 * (m0 + r) + c] = sh.with_color ? T.Gs[r * TC_GLD + c] : 0.0f;
  }
}

// Kernel #5: a tile of TC_TM samples per block.  Forward recomputed, both
// trunk backwards and the per-sample cotangents; with wgrads the colour
// trunk's rows for the weight gradients.
__global__ void __launch_bounds__(TC_THREADS)
    tr_bwd_tiles(const float* __restrict__ p, const float* __restrict__ cg,
                 const float* __restrict__ cc, const float* __restrict__ Bg,
                 const float* __restrict__ Bc, Core gw, Core cw, Rows rg,
                 Rows rc, TShape sh, TcSmem sm, int wgrads,
                 const float* __restrict__ g_occ,
                 const float* __restrict__ g_rgb, float* __restrict__ dp,
                 float* __restrict__ dcg, float* __restrict__ dcc) {
  extern __shared__ float4 tc_raw[];
  const TcTile T = tc_tile((float*)tc_raw, sm);
  const long M = sh.n;
  const long m0 = (long)blockIdx.x * TC_TM;
  const int C = sh.C;
  const bool need_dp = sh.need_dp != 0, wg = wgrads != 0;
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x)
    T.Ps[e] = m0 + e / 3 < M ? p[3 * m0 + e] : 0.0f;
  tile_feat(cg, C, T.Cs, nullptr, m0, M);
  __syncthreads();
  const int embp_g = round8(gw.emb);
  tile_embed(T.Ps, Bg, false, gw.emb, embp_g, T.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, rg, 0, T, embp_g, m0, M, false, false);
  tile_cot(g_occ, 1, T.Gs, nullptr, m0, M);
  tc_trunk_bwd(gw, rg, 0, T, embp_g, m0, M, need_dp, false);
  tile_feat_out(T.Cs, C, dcg, m0, M);
  float dpg[3] = {0.0f, 0.0f, 0.0f}, dpc[3] = {0.0f, 0.0f, 0.0f};
  if (need_dp && threadIdx.x < TC_TM)
    tile_embed_bwd(T.Ps, Bg, false, gw.emb, embp_g, T.Es, dpg);
  __syncthreads();
  if (sh.with_color) {
    const int embp_c = round8(cw.emb);
    tile_feat(cc, C, T.Cs, wg ? rc.Cf : nullptr, m0, M);
    tile_embed(T.Ps, Bc, true, cw.emb, embp_c, T.Es, wg ? rc.E : nullptr,
               m0, M);
    __syncthreads();
    tc_trunk_fwd(cw, rc, 1, T, embp_c, m0, M, wg, false);
    tile_cot(g_rgb, 3, T.Gs, wg ? rc.G : nullptr, m0, M);
    tc_trunk_bwd(cw, rc, 1, T, embp_c, m0, M, need_dp, wg);
    tile_feat_out(T.Cs, C, dcc, m0, M);
    if (need_dp && threadIdx.x < TC_TM)
      tile_embed_bwd(T.Ps, Bc, true, cw.emb, embp_c, T.Es, dpc);
  } else {
    tile_feat_out(nullptr, C, dcc, m0, M);
  }
  const long m = m0 + threadIdx.x;
  if (threadIdx.x < TC_TM && m < M)
    for (int d = 0; d < 3; ++d)
      dp[3 * m + d] = 6.2831855f * dpg[d] + 6.2831855f * dpc[d];
}

// Floats of scratch the entry point needs for n samples: none for the
// forward (kernel #4 keeps its activations on chip).
extern "C" long hp_trunks_scratch_floats(int n, int C, int emb_g, int hid_g,
                                         int emb_c, int hid_c, int nb,
                                         int with_color, int backward) {
  if (!backward) return 0;
  long rows = trunk_rows(emb_g, hid_g, C, nb, 1);
  if (with_color) rows += trunk_rows(emb_c, hid_c, C, nb, 3);
  return rows * (long)n;
}

// Dynamic shared memory (bytes) of one tile kernel.
static int trunks_smem(int C, int emb_g, int hid_g, int emb_c, int hid_c,
                       int with_color, TcSmem* sm) {
  *sm = tc_smem(round8(emb_g), hid_g, round8(emb_c), hid_c, C,
                with_color != 0);
  return sm->total * (int)sizeof(float);
}

// Blocks of kernel #4 (backward == 0) or #5 that fit one SM at these
// widths, from the CUDA occupancy calculator; negative: a CUDA error.
extern "C" int hp_trunks_blocks_per_sm(int C, int emb_g, int hid_g,
                                       int emb_c, int hid_c, int with_color,
                                       int backward) {
  TcSmem sm;
  const int smem = trunks_smem(C, emb_g, hid_g, emb_c, hid_c, with_color,
                               &sm);
  int blocks = 0, rc;
  if (backward) {
    rc = tc_smem_attr(tr_bwd_tiles, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tr_bwd_tiles, TC_THREADS, smem);
  } else {
    rc = tc_smem_attr(tr_fwd_tiles, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tr_fwd_tiles, TC_THREADS, smem);
  }
  return rc ? -rc : blocks;
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #4: occ (n,), rgb (n, 3).
//   backward == 1: kernel #5: from g_occ (n,), g_rgb (n, 3): dp (n, 3)
//     (zero unless need_dp), dcg (n, C), dcc (n, C) and, with colour and
//     need_wgrads, the colour-core weight grads into dcw (flatten_core
//     order, 4*nb+2 device pointers).
// p (n, 3), cg / cc (n, C); Bg (3, emb_g), Bc (3, emb_c / 2); gw / cw: host
// arrays of device pointers to the core tensors in flatten_core order.
// scratch holds hp_trunks_scratch_floats(...) floats; wpart holds wsplits
// times the colour core's element count (every weight and bias).  Both
// kernels need hid_g, hid_c and C to be multiples of 8.  Returns the
// first CUDA error.
extern "C" int hp_trunks(
    const float* p, const float* cg, const float* cc, const float* Bg,
    const float* Bc, const void* const* gw, const void* const* cw, int n,
    int C, int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    int with_color, int backward, int need_dp, int need_wgrads,
    const float* g_occ, const float* g_rgb, float* scratch, float* occ,
    float* rgb, float* dp, float* dcg, float* dcc, void* const* dcw,
    float* wpart, int wsplits, void* stream) {
  if (n <= 0) return 0;
  if (nb > HP_MAXB || nb < 1) return (int)cudaErrorInvalidValue;
  if (hid_g % 8 || hid_c % 8 || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = n;
  const unsigned grid = (unsigned)((M + TC_TM - 1) / TC_TM);
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore = with_color ? make_core(cw, nb, skip, emb_c, hid_c, C, 3)
                          : gcore;
  TShape sh;
  sh.n = n; sh.C = C; sh.with_color = with_color;
  sh.need_dp = backward && need_dp;
  TcSmem sm;
  const int smem = trunks_smem(C, emb_g, hid_g, emb_c, hid_c, with_color,
                               &sm);
  if (!backward) {
    const int rc0 = tc_smem_attr(tr_fwd_tiles, smem);
    if (rc0) return rc0;
    tr_fwd_tiles<<<grid, TC_THREADS, smem, st>>>(p, cg, cc, Bg, Bc, gcore,
                                                 ccore, sh, sm, occ, rgb);
    return (int)cudaGetLastError();
  }
  Rows rg = make_rows(scratch, M, emb_g, hid_g, C, nb, 1);
  Rows rc = rg;
  if (with_color)
    rc = make_rows(scratch + trunk_rows(emb_g, hid_g, C, nb, 1) * M, M,
                   emb_c, hid_c, C, nb, 3);
  const int rc1 = tc_smem_attr(tr_bwd_tiles, smem);
  if (rc1) return rc1;
  const int wg = with_color && need_wgrads;
  tr_bwd_tiles<<<grid, TC_THREADS, smem, st>>>(
      p, cg, cc, Bg, Bc, gcore, ccore, rg, rc, sh, sm, wg, g_occ, g_rgb, dp,
      dcg, dcc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!wg) return 0;
  return launch_core_wgrads_tc(ccore, rc, M, wpart, wsplits, dcw, st);
}
