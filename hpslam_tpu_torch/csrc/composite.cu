// Fused NICER trunks + occupancy compositor per ray, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_composite`
// (hpslam_tpu/ops/fused_mlp.py): the forward `_fwd_comp_kernel` (:379,
// launched by `_fused_comp_fwd` :702) and the fully fused backward
// `_bwd_comp_kernel` (:418, launched by `_fused_comp_bwd` :756).
//
// Forward (kernel #6), rays of S samples, sample rows ray-major:
//   1. a tile of TC_TM samples per block (cp_fwd_tiles): the Fourier
//      embeds, the ReLU geometry trunk -> occ logit and, with colour, the
//      Softplus(beta=100) colour trunk -> rgb, then a sigmoid when
//      sigmoid_rgb, on the tensor cores at f32 accuracy (3xTF32 mma.sync,
//      nicer_trunk_tc.cuh); the samples run tc_trunks_fwd_tile, as the
//      trunk forward #4 does.  occ and rgb are written per sample (the
//      residuals the backward reads); nothing else leaves the chip;
//   2. one thread per ray (cp_rays): the occupancy compositor of
//      `_comp_fwd` :227 (occ forced to -100 where pm = 0, alpha =
//      sigmoid(coef occ), transmittance prod (1 - alpha + 1e-10), wsum +
//      1e-10) -> depth, depth variance, colour.
// A ray's S samples may straddle two tiles, so the compositor keeps its
// own launch.
// Backward (kernel #7), from the per-ray cotangents dD, dV, dC, in four
// passes on the same tiles:
//   1. cp_fwd_tiles as the forward runs it -> occ, rgb per sample;
//   2. cp_rays with the cotangents: the compositor backward of `_comp_bwd`
//      :246 (the reverse suffix loop over S, d occ masked by pm) and the
//      sigmoid chain -> the per-sample trunk cotangents g_occ (n,) and
//      g_rgb (n, 3), two compact arrays in scratch;
//   3. a tile of TC_TM samples per block (cp_bwd_tiles): the trunk
//      backward tile of #5, tc_trunks_bwd_tile (the forward recomputed in
//      the tile, then both trunk backwards), without the position
//      cotangent -> d c_geo, d c_col;
//   4. with colour and need_wgrads, the colour core's weight gradients on
//      the tensor cores (launch_core_wgrads_tc), as #5's.
// The scratch is #5's (tc_bwd_rows) plus the two cotangent arrays.  No
// atomics: results repeat run to run.
//
// Blocks run in no order on the card, so the Pallas body (one grid step
// holds whole rays) is split where a ray needs all its samples (pass 2)
// and where a sample needs its ray's cotangent (pass 3).
//
// Bound on the card: operations (both trunks, ~0.2 MFLOP per sample
// forward and twice that backward, against ~0.3 kB of input per sample).
// The forward's tile holds both trunks' activations in shared memory;
// geometry-only stages ask for the geometry trunk's layout alone, so two
// blocks fit an SM.
#include "nicer_trunk_tc.cuh"

struct CShape {
  int n_r, S, C, with_color, sigmoid_rgb, backward;
  float coef;
};

// Pass 1 of kernel #6: a tile of TC_TM samples per block, both trunk
// forwards; occ and rgb straight from the output tile.
__global__ void __launch_bounds__(TC_THREADS, 2)
    cp_fwd_tiles(const float* __restrict__ p, const float* __restrict__ cg,
                 const float* __restrict__ cc, const float* __restrict__ Bg,
                 const float* __restrict__ Bc, Core gw, Core cw, CShape sh,
                 TcSmem sm, float* __restrict__ occ,
                 float* __restrict__ rgb) {
  extern __shared__ float4 tc_raw[];
  tc_trunks_fwd_tile(p, cg, cc, Bg, Bc, gw, cw, sh.C, sh.with_color != 0,
                     sh.sigmoid_rgb != 0, tc_tile((float*)tc_raw, sm),
                     (long)blockIdx.x * TC_TM, (long)sh.n_r * sh.S, occ,
                     rgb);
}

// Pass 2: one thread per ray.  Forward: depth, var, color.  Backward: the
// trunk output cotangents of the ray's samples, g_occ (n,), g_rgb (n, 3).
__global__ void cp_rays(const float* __restrict__ z,
                        const float* __restrict__ pmask,
                        const float* __restrict__ occ,
                        const float* __restrict__ rgb, CShape sh,
                        const float* __restrict__ dD,
                        const float* __restrict__ dV,
                        const float* __restrict__ dC,
                        float* __restrict__ depth, float* __restrict__ var,
                        float* __restrict__ color,
                        float* __restrict__ g_occ,
                        float* __restrict__ g_rgb) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= sh.n_r) return;
  const int S = sh.S;
  const float* zr = z + r * S;
  float a_s[HP_MAXS], t_s[HP_MAXS], w_s[HP_MAXS], rg_s[HP_MAXS][3];
  bool on[HP_MAXS];
  float t_run = 1.0f;
  for (int s = 0; s < S; ++s) {
    const long m = r * S + s;
    on[s] = pmask[r * S + s] > 0.5f;
    const float a = sigm(sh.coef * (on[s] ? occ[m] : -100.0f));
    a_s[s] = a;
    t_s[s] = t_run;
    w_s[s] = a * t_run;
    t_run = t_run * ((1.0f - a) + 1e-10f);
    for (int c = 0; c < 3; ++c) rg_s[s][c] = rgb[3 * m + c];
  }
  float wsum = 0.0f, dnum = 0.0f;
  for (int s = 0; s < S; ++s) wsum += w_s[s];
  wsum += 1e-10f;
  for (int s = 0; s < S; ++s) dnum += w_s[s] * zr[s];
  const float dep = dnum / wsum;
  float col[3];
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += w_s[s] * rg_s[s][c];
    col[c] = acc / wsum;
  }
  if (!sh.backward) {
    float v = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float dv = zr[s] - dep;
      v += (w_s[s] * dv) * dv;
    }
    depth[r] = dep;
    var[r] = v;
    for (int c = 0; c < 3; ++c) color[r * 3 + c] = col[c];
    return;
  }
  const float gd = dD[r], gv = dV[r];
  const float gc[3] = {dC[r * 3], dC[r * 3 + 1], dC[r * 3 + 2]};
  float swdv = 0.0f;
  for (int s = 0; s < S; ++s) swdv += w_s[s] * (zr[s] - dep);
  const float gd_eff = gd + gv * (-2.0f * swdv);
  float dw[HP_MAXS];
  for (int s = 0; s < S; ++s) {
    const float dv = zr[s] - dep;
    float dcol = 0.0f;
    for (int c = 0; c < 3; ++c) dcol += gc[c] * (rg_s[s][c] - col[c]);
    dw[s] = gd_eff * dv / wsum + dcol / wsum + gv * dv * dv;
  }
  // d alpha through w_s = alpha_s t_s, t_s = prod_{u<s} (1 - alpha_u +
  // 1e-10): the reference's reverse suffix loop
  float suffix = 0.0f;
  for (int s = S - 1; s >= 0; --s) {
    const long m = r * S + s;
    const float da = dw[s] * t_s[s] - suffix / ((1.0f - a_s[s]) + 1e-10f);
    suffix += dw[s] * w_s[s];
    const float docc = da * sh.coef * a_s[s] * (1.0f - a_s[s]);
    g_occ[m] = on[s] ? docc : 0.0f;
    if (!sh.with_color) continue;
    for (int c = 0; c < 3; ++c) {
      float g = gc[c] * (w_s[s] / wsum);
      if (sh.sigmoid_rgb) g = g * rg_s[s][c] * (1.0f - rg_s[s][c]);
      g_rgb[3 * m + c] = g;
    }
  }
}

// Pass 3 of kernel #7: a tile of TC_TM samples per block, #5's tile body
// without the position cotangent; with wgrads the colour trunk's rows for
// the weight gradients.
__global__ void __launch_bounds__(TC_THREADS)
    cp_bwd_tiles(const float* __restrict__ p, const float* __restrict__ cg,
                 const float* __restrict__ cc, const float* __restrict__ Bg,
                 const float* __restrict__ Bc, Core gw, Core cw, Rows rg,
                 Rows rc, CShape sh, TcSmem sm, int wgrads,
                 const float* __restrict__ g_occ,
                 const float* __restrict__ g_rgb, float* __restrict__ dcg,
                 float* __restrict__ dcc) {
  extern __shared__ float4 tc_raw[];
  tc_trunks_bwd_tile(p, cg, cc, Bg, Bc, gw, cw, rg, rc, sh.C,
                     sh.with_color != 0, false, wgrads != 0, g_occ, g_rgb,
                     tc_tile((float*)tc_raw, sm), (long)blockIdx.x * TC_TM,
                     (long)sh.n_r * sh.S, nullptr, dcg, dcc);
}

// Floats of scratch the entry point needs for n sample rows: none for the
// forward (kernel #6 keeps its activations on chip); for the backward #5's
// rows (tc_bwd_rows) and the cotangent arrays g_occ, g_rgb.
extern "C" long hp_composite_scratch_floats(int n, int C, int hid_g,
                                            int emb_c, int hid_c, int nb,
                                            int with_color, int backward,
                                            int need_wgrads) {
  if (!backward) return 0;
  return (tc_bwd_rows(emb_c, hid_g, hid_c, C, nb, with_color != 0,
                      with_color && need_wgrads) + 4) * (long)n;
}

// Blocks of the tile pass of kernel #6 (cp_fwd_tiles, backward == 0) or #7
// (cp_bwd_tiles) that fit one SM at these widths, from the CUDA occupancy
// calculator; negative: a CUDA error.
extern "C" int hp_composite_blocks_per_sm(int C, int emb_g, int hid_g,
                                          int emb_c, int hid_c,
                                          int with_color, int backward) {
  TcSmem sm;
  const int smem = tc_trunks_smem(C, emb_g, hid_g, emb_c, hid_c, with_color,
                                  &sm);
  int blocks = 0, rc;
  if (backward) {
    rc = tc_smem_attr(cp_bwd_tiles, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, cp_bwd_tiles, TC_THREADS, smem);
  } else {
    rc = tc_smem_attr(cp_fwd_tiles, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, cp_fwd_tiles, TC_THREADS, smem);
  }
  return rc ? -rc : blocks;
}

// C entry point (bound with ctypes).  n_r rays of S samples; p (n_r*S, 3),
// cg / cc (n_r*S, C) sample rows ray-major; z, pm (n_r, S); Bg (3, emb_g),
// Bc (3, emb_c / 2); gw / cw: host arrays of device pointers to the core
// tensors in flatten_core order.  occ (n_r*S,) and rgb (n_r*S, 3) are
// written in both modes.
//   backward == 0: kernel #6: depth, var (n_r,), color (n_r, 3).
//   backward == 1: kernel #7: from dD, dV (n_r,), dC (n_r, 3): dcg, dcc
//     (n_r*S, C) and, with colour and need_wgrads, the colour-core weight
//     grads into dcw (flatten_core order, 4*nb+2 device pointers).
// scratch holds hp_composite_scratch_floats(...) floats; wpart holds
// wsplits times the colour core's element count (every weight and bias).
// Both kernels need hid_g, hid_c and C to be multiples of 8.  Returns the
// first CUDA error.
extern "C" int hp_composite(
    const float* p, const float* cg, const float* cc, const float* z,
    const float* pmask, const float* Bg, const float* Bc,
    const void* const* gw, const void* const* cw, int n_r, int S, int C,
    int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    int with_color, float coef, int sigmoid_rgb, int backward,
    int need_wgrads, const float* dD, const float* dV, const float* dC,
    float* scratch, float* depth, float* var, float* color, float* occ,
    float* rgb, float* dcg, float* dcc, void* const* dcw, float* wpart,
    int wsplits, void* stream) {
  if (n_r <= 0) return 0;
  if (nb > HP_MAXB || nb < 1 || S > HP_MAXS || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)n_r * S;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore = with_color ? make_core(cw, nb, skip, emb_c, hid_c, C, 3)
                          : gcore;
  CShape sh;
  sh.n_r = n_r; sh.S = S; sh.C = C; sh.with_color = with_color;
  sh.sigmoid_rgb = sigmoid_rgb; sh.backward = backward; sh.coef = coef;
  const int TB = 128;
  const unsigned gr = (unsigned)((n_r + TB - 1) / TB);
  if (hid_g % 8 || hid_c % 8 || C % 8) return (int)cudaErrorInvalidValue;
  TcSmem sm;
  const int smem = tc_trunks_smem(C, emb_g, hid_g, emb_c, hid_c, with_color,
                                  &sm);
  const int rc0 = tc_smem_attr(cp_fwd_tiles, smem);
  if (rc0) return rc0;
  const unsigned tiles = (unsigned)((M + TC_TM - 1) / TC_TM);
  cp_fwd_tiles<<<tiles, TC_THREADS, smem, st>>>(p, cg, cc, Bg, Bc, gcore,
                                                ccore, sh, sm, occ, rgb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!backward) {
    cp_rays<<<gr, TB, 0, st>>>(z, pmask, occ, rgb, sh, dD, dV, dC, depth,
                               var, color, nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  const int wg = with_color && need_wgrads;
  Rows rg, rc;
  tc_bwd_layout(scratch, M, emb_c, hid_g, hid_c, C, nb, with_color != 0,
                wg != 0, &rg, &rc);
  float* g_occ = scratch + tc_bwd_rows(emb_c, hid_g, hid_c, C, nb,
                                       with_color != 0, wg != 0) * M;
  float* g_rgb = g_occ + M;
  cp_rays<<<gr, TB, 0, st>>>(z, pmask, occ, rgb, sh, dD, dV, dC, depth, var,
                             color, g_occ, g_rgb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rc1 = tc_smem_attr(cp_bwd_tiles, smem);
  if (rc1) return rc1;
  cp_bwd_tiles<<<tiles, TC_THREADS, smem, st>>>(
      p, cg, cc, Bg, Bc, gcore, ccore, rg, rc, sh, sm, wg, g_occ, g_rgb, dcg,
      dcc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!wg) return 0;
  return launch_core_wgrads_tc(ccore, rc, M, wpart, wsplits, dcw, st);
}
