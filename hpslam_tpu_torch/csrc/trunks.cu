// Fused NICER decoder trunks, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_color` /
// `nicer_fused_geo` (hpslam_tpu/ops/fused_mlp.py): the forward
// `_fwd_kernel` (:278, launched by `_fused_fwd` :506) and the remat
// backward `_bwd_kernel` (:299, launched by `_fused_bwd` :548).
//
// Forward (kernel #4): one thread per sample computes the Fourier embeds,
// the ReLU geometry trunk and, with colour, the Softplus(beta=100) colour
// trunk, and writes occ (n,) and raw rgb (n, 3) (zero without colour).
//
// Backward (kernel #5): one thread per sample recomputes the forward (as
// the Pallas kernel does), takes the output cotangents and runs both trunk
// backwards, giving d(c_geo), d(c_col) and, with need_dp, the cotangent of
// the sample positions through the embeds:
//   dp = 2 pi (cos(proj_g) d_eg) Bg^T
//      + 2 pi (cos(proj_c) d_ec_sin - sin(proj_c) d_ec_cos) Bc^T.
// Then, with need_wgrads and colour, the colour core's weight gradients,
// summed over every sample by the deterministic tiled passes of
// nicer_trunk.cuh (no atomics).  The geometry core and both Fourier B
// matrices are frozen, as in the reference: no gradient is computed.
//
// Bound on the card: operations (about 0.2 MFLOP per sample forward and
// twice that backward, against ~0.3 kB of input per sample).  This first
// version runs the trunks as scalar f32 FMAs one sample per thread, far
// from the tensor-core rate; wgmma tiles with TMA-fed weights are later
// work.
#include "nicer_trunk.cuh"

struct TShape {
  int n, C, with_color, backward, need_dp;
};

// One thread per sample: forward, and with `backward` the trunk backwards
// and the per-sample cotangents.
__global__ void tr_samples(const float* __restrict__ p,
                           const float* __restrict__ cg,
                           const float* __restrict__ cc,
                           const float* __restrict__ Bg,
                           const float* __restrict__ Bc, Core gw, Core cw,
                           Rows rg, Rows rc, TShape sh,
                           const float* __restrict__ g_occ,
                           const float* __restrict__ g_rgb,
                           float* __restrict__ occ, float* __restrict__ rgb,
                           float* __restrict__ dp, float* __restrict__ dcg,
                           float* __restrict__ dcc) {
  const long M = sh.n;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int C = sh.C;
  const float pm[3] = {p[3 * m], p[3 * m + 1], p[3 * m + 2]};
  for (int ch = 0; ch < C; ++ch) rg.Cf[(long)ch * M + m] = cg[m * C + ch];
  embed_fwd(pm, Bg, false, rg, gw.emb, m, M);
  trunk_fwd(gw, rg, 0, m, M);
  if (sh.with_color) {
    for (int ch = 0; ch < C; ++ch) rc.Cf[(long)ch * M + m] = cc[m * C + ch];
    embed_fwd(pm, Bc, true, rc, cw.emb, m, M);
    trunk_fwd(cw, rc, 1, m, M);
  }
  if (!sh.backward) {
    occ[m] = rg.G[m];
    for (int c = 0; c < 3; ++c)
      rgb[3 * m + c] = sh.with_color ? rc.G[(long)c * M + m] : 0.0f;
    return;
  }
  const bool need_dp = sh.need_dp != 0;
  rg.G[m] = g_occ[m];
  trunk_bwd(gw, rg, 0, m, M, need_dp);
  for (int ch = 0; ch < C; ++ch) dcg[m * C + ch] = rg.DC[(long)ch * M + m];
  float dpg[3] = {0.0f, 0.0f, 0.0f}, dpc[3] = {0.0f, 0.0f, 0.0f};
  if (need_dp) embed_bwd(pm, Bg, false, rg, gw.emb, m, M, dpg);
  if (sh.with_color) {
    for (int c = 0; c < 3; ++c) rc.G[(long)c * M + m] = g_rgb[3 * m + c];
    trunk_bwd(cw, rc, 1, m, M, need_dp);
    for (int ch = 0; ch < C; ++ch)
      dcc[m * C + ch] = rc.DC[(long)ch * M + m];
    if (need_dp) embed_bwd(pm, Bc, true, rc, cw.emb, m, M, dpc);
  } else {
    for (int ch = 0; ch < C; ++ch) dcc[m * C + ch] = 0.0f;
  }
  for (int d = 0; d < 3; ++d)
    dp[3 * m + d] = 6.2831855f * dpg[d] + 6.2831855f * dpc[d];
}

// Floats of scratch the entry point needs for n samples.
extern "C" long hp_trunks_scratch_floats(int n, int C, int emb_g, int hid_g,
                                         int emb_c, int hid_c, int nb,
                                         int with_color, int need_dp) {
  long rows = trunk_rows(emb_g, hid_g, C, nb, 1, need_dp ? emb_g : 0);
  if (with_color)
    rows += trunk_rows(emb_c, hid_c, C, nb, 3, need_dp ? emb_c : 0);
  return rows * (long)n;
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #4: occ (n,), rgb (n, 3).
//   backward == 1: kernel #5: from g_occ (n,), g_rgb (n, 3): dp (n, 3)
//     (zero unless need_dp), dcg (n, C), dcc (n, C) and, with colour and
//     need_wgrads, the colour-core weight grads into dcw (flatten_core
//     order, 4*nb+2 device pointers).
// p (n, 3), cg / cc (n, C); Bg (3, emb_g), Bc (3, emb_c / 2); gw / cw: host
// arrays of device pointers to the core tensors in flatten_core order.
// scratch holds hp_trunks_scratch_floats(...) floats; wpart holds
// wsplits * (emb_c + hid_c) * hid_c floats.  Returns the first CUDA error.
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
  cudaStream_t st = (cudaStream_t)stream;
  const long M = n;
  const int de = backward && need_dp;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore = with_color ? make_core(cw, nb, skip, emb_c, hid_c, C, 3)
                          : gcore;
  Rows rg = make_rows(scratch, M, emb_g, hid_g, C, nb, 1, de ? emb_g : 0);
  Rows rc = rg;
  if (with_color)
    rc = make_rows(scratch + trunk_rows(emb_g, hid_g, C, nb, 1,
                                        de ? emb_g : 0) * M,
                   M, emb_c, hid_c, C, nb, 3, de ? emb_c : 0);
  TShape sh;
  sh.n = n; sh.C = C; sh.with_color = with_color; sh.backward = backward;
  sh.need_dp = de;
  const int TB = 128;
  tr_samples<<<(unsigned)((M + TB - 1) / TB), TB, 0, st>>>(
      p, cg, cc, Bg, Bc, gcore, ccore, rg, rc, sh, g_occ, g_rgb, occ, rgb,
      dp, dcg, dcc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!(backward && with_color && need_wgrads)) return 0;
  return launch_core_wgrads(ccore, rc, M, wpart, wsplits, dcw, st);
}
