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
// Backward (kernel #7), still on the scalar trunk code of nicer_trunk.cuh,
// one sample per thread: 1. (cp_samples) the forward recomputed, its
// trunk rows kept in scratch, as `_bwd_comp_kernel` recomputes them;
// 2. cp_rays with the per-ray cotangents dD, dV, dC: the compositor
// backward of `_comp_bwd` :246 (the reverse suffix loop over S, d occ
// masked by pm), the sigmoid chain, written over the trunk output rows;
// 3. (cp_bwd_samples) both trunk backwards -> d c_geo, d c_col; then, with
// colour and need_wgrads, the colour core's weight gradients by the
// fixed-order tiled passes of nicer_trunk.cuh.  No atomics: results repeat
// run to run.
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

// Pass 1 of kernel #7: one thread per sample, the trunk rows to scratch.
__global__ void cp_samples(const float* __restrict__ p,
                           const float* __restrict__ cg,
                           const float* __restrict__ cc,
                           const float* __restrict__ Bg,
                           const float* __restrict__ Bc, Core gw, Core cw,
                           Rows rg, Rows rc, CShape sh,
                           float* __restrict__ occ, float* __restrict__ rgb) {
  const long M = (long)sh.n_r * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int C = sh.C;
  const float pm[3] = {p[3 * m], p[3 * m + 1], p[3 * m + 2]};
  for (int ch = 0; ch < C; ++ch) rg.Cf[(long)ch * M + m] = cg[m * C + ch];
  embed_fwd(pm, Bg, false, rg, gw.emb, m, M);
  trunk_fwd(gw, rg, 0, m, M);
  occ[m] = rg.G[m];
  if (!sh.with_color) {
    for (int c = 0; c < 3; ++c) rgb[3 * m + c] = 0.0f;
    return;
  }
  for (int ch = 0; ch < C; ++ch) rc.Cf[(long)ch * M + m] = cc[m * C + ch];
  embed_fwd(pm, Bc, true, rc, cw.emb, m, M);
  trunk_fwd(cw, rc, 1, m, M);
  for (int c = 0; c < 3; ++c) {
    const float v = rc.G[(long)c * M + m];
    rgb[3 * m + c] = sh.sigmoid_rgb ? sigm(v) : v;
  }
}

// Pass 2: one thread per ray.  Forward: depth, var, color.  Backward: the
// trunk output cotangents of the ray's samples into the G rows.
__global__ void cp_rays(const float* __restrict__ z,
                        const float* __restrict__ pmask,
                        const float* __restrict__ occ,
                        const float* __restrict__ rgb, CShape sh,
                        const float* __restrict__ dD,
                        const float* __restrict__ dV,
                        const float* __restrict__ dC,
                        float* __restrict__ depth, float* __restrict__ var,
                        float* __restrict__ color, Rows rg, Rows rc) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= sh.n_r) return;
  const int S = sh.S;
  const long M = (long)sh.n_r * S;
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
    rg.G[m] = on[s] ? docc : 0.0f;
    if (!sh.with_color) continue;
    for (int c = 0; c < 3; ++c) {
      float g = gc[c] * (w_s[s] / wsum);
      if (sh.sigmoid_rgb) g = g * rg_s[s][c] * (1.0f - rg_s[s][c]);
      rc.G[(long)c * M + m] = g;
    }
  }
}

// Pass 3 (backward): one thread per sample, both trunk backwards.
__global__ void cp_bwd_samples(Core gw, Core cw, Rows rg, Rows rc,
                               CShape sh, float* __restrict__ dcg,
                               float* __restrict__ dcc) {
  const long M = (long)sh.n_r * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int C = sh.C;
  trunk_bwd(gw, rg, 0, m, M);
  for (int ch = 0; ch < C; ++ch) dcg[m * C + ch] = rg.DC[(long)ch * M + m];
  if (sh.with_color) {
    trunk_bwd(cw, rc, 1, m, M);
    for (int ch = 0; ch < C; ++ch)
      dcc[m * C + ch] = rc.DC[(long)ch * M + m];
  } else {
    for (int ch = 0; ch < C; ++ch) dcc[m * C + ch] = 0.0f;
  }
}

// Floats of scratch the entry point needs for n sample rows: none for the
// forward (kernel #6 keeps its activations on chip).
extern "C" long hp_composite_scratch_floats(int n, int C, int emb_g,
                                            int hid_g, int emb_c, int hid_c,
                                            int nb, int with_color,
                                            int backward) {
  if (!backward) return 0;
  long rows = trunk_rows(emb_g, hid_g, C, nb, 1);
  if (with_color) rows += trunk_rows(emb_c, hid_c, C, nb, 3);
  return rows * (long)n;
}

// Blocks of kernel #6's tile pass (cp_fwd_tiles) that fit one SM at these
// widths, from the CUDA occupancy calculator; negative: a CUDA error.
extern "C" int hp_composite_blocks_per_sm(int C, int emb_g, int hid_g,
                                          int emb_c, int hid_c,
                                          int with_color) {
  TcSmem sm;
  const int smem = tc_trunks_smem(C, emb_g, hid_g, emb_c, hid_c, with_color,
                                  &sm);
  int blocks = 0;
  int rc = tc_smem_attr(cp_fwd_tiles, smem);
  if (!rc)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, cp_fwd_tiles, TC_THREADS, smem);
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
// wsplits * (emb_c + hid_c) * hid_c floats.  The forward needs hid_g,
// hid_c and C to be multiples of 8.  Returns the first CUDA error.
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
  cudaError_t e;
  if (!backward) {
    if (hid_g % 8 || hid_c % 8 || C % 8) return (int)cudaErrorInvalidValue;
    TcSmem sm;
    const int smem = tc_trunks_smem(C, emb_g, hid_g, emb_c, hid_c,
                                    with_color, &sm);
    const int rc0 = tc_smem_attr(cp_fwd_tiles, smem);
    if (rc0) return rc0;
    cp_fwd_tiles<<<(unsigned)((M + TC_TM - 1) / TC_TM), TC_THREADS, smem,
                   st>>>(p, cg, cc, Bg, Bc, gcore, ccore, sh, sm, occ, rgb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const Rows none = {};
    cp_rays<<<gr, TB, 0, st>>>(z, pmask, occ, rgb, sh, dD, dV, dC, depth,
                               var, color, none, none);
    return (int)cudaGetLastError();
  }
  Rows rg = make_rows(scratch, M, emb_g, hid_g, C, nb, 1);
  Rows rc = rg;
  if (with_color)
    rc = make_rows(scratch + trunk_rows(emb_g, hid_g, C, nb, 1) * M, M,
                   emb_c, hid_c, C, nb, 3);
  const unsigned gs = (unsigned)((M + TB - 1) / TB);
  cp_samples<<<gs, TB, 0, st>>>(p, cg, cc, Bg, Bc, gcore, ccore, rg, rc, sh,
                                occ, rgb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cp_rays<<<gr, TB, 0, st>>>(z, pmask, occ, rgb, sh, dD, dV, dC, depth, var,
                             color, rg, rc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cp_bwd_samples<<<gs, TB, 0, st>>>(gcore, ccore, rg, rc, sh, dcg, dcc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!(with_color && need_wgrads)) return 0;
  return launch_core_wgrads(ccore, rc, M, wpart, wsplits, dcw, st);
}
