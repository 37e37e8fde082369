// Whole-iteration mapping loss of the union path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_maploss`
// (hpslam_tpu/ops/fused_mlp.py): the forward `_maploss_fwd_kernel` (:1066,
// launched by `_maploss_fwd` :1274) and the combined forward-plus-
// cotangents `_maploss_bwd_kernel` (:1098, launched by `_maploss_bwd`
// :1308).  Every product the Pallas body computes is computed here: the
// union feature mix, both Fourier embeds, both NICER trunks (ReLU geometry
// trunk, Softplus(beta=100) colour trunk, skip concat, additive feature
// injection), the occupancy compositor with -100 forcing, the exposure
// affine, the masked L1 losses and, in the combined form, d(uf), d(aff)
// and the colour-core weight gradients.
//
// Layout.  A TPU grid step owned a block of rays with all weights in VMEM
// and carried the loss and weight-gradient sums from step to step.  Blocks
// on the card run in no order, so the work is split into passes:
//   1. one thread per (ray, sample): union mix, embeds, both trunk
//      forwards.  Every intermediate (embedding, pre-activations, block
//      outputs) is written to a scratch table of rows of length M = n*S
//      ("transposed": a warp's 32 samples touch 32 consecutive floats).
//   2. one thread per ray: compositor, affine, per-ray losses and, in the
//      combined form, the compositor backward (cotangents of occupancy,
//      raw colour and the affine rows).
//   3. one thread per sample: both trunk backwards over the saved rows,
//      giving d(c_geo), d(c_col) and the per-sample cotangents that the
//      weight gradients need.
//   4. one thread per output element: union-mix backward into d(uf).
//   5. weight gradients as products of saved rows, X^T dY summed over the
//      M samples: a tiled kernel over (in, out) tiles and fixed sample
//      ranges, then a pass that adds the ranges in a fixed order.
//   6. the two loss sums: one block adds the per-ray partials in a fixed
//      order.
// No atomics are used, so the result does not change from run to run.
// The sums are taken in another order than the Pallas kernel's and the
// plain PyTorch version's, which is what the stated tolerances cover.
//
// The embeds, trunks and weight-gradient passes are the shared device code
// of nicer_trunk.cuh (also used by trunks.cu and trackloss.cu).
//
// Bound on the card: operations.  At the mapping operating point the two
// trunks cost about 0.2 MFLOP per sample forward and twice that backward,
// against a few kB of input per sample.  This first version runs them as
// scalar f32 FMAs one sample per thread, far from the tensor-core rate;
// moving the trunks onto wgmma tiles with TMA-fed weights is later work.

#include "nicer_trunk.cuh"

struct Shape {
  int n, S, u, C, D, ufw, fstride;
  int with_color, sigmoid_rgb, use_affine;
  float coef, w_color;
};

// Pass 1: one thread per (ray, sample), m = ray*S + s.
__global__ void ml_fwd_samples(const float* __restrict__ row,
                               const float* __restrict__ uf,
                               const float* __restrict__ Bg,
                               const float* __restrict__ Bc, Core gw,
                               Core cw, Rows rg, Rows rc, Shape sh) {
  const long M = (long)sh.n * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long ray = m / sh.S;
  const int s = (int)(m % sh.S);
  const int S = sh.S, u = sh.u, C = sh.C;
  const float* rp = row + ray * sh.D;
  const int o_pts = S, o_pm = 4 * S + 7, o_wm = 5 * S + 7;
  const bool pm = rp[o_pm + s] > 0.5f;
  const float* wm = rp + o_wm + s * u;
  const float* ur = uf + ray * sh.ufw;
  for (int ch = 0; ch < C; ++ch) {
    float acc = 0.0f;
    for (int j = 0; j < u; ++j) acc = fmaf(wm[j], ur[j * sh.fstride + ch],
                                           acc);
    rg.Cf[(long)ch * M + m] = pm ? acc : 0.0f;
  }
  if (sh.with_color) {
    for (int ch = 0; ch < C; ++ch) {
      float acc = 0.0f;
      for (int j = 0; j < u; ++j)
        acc = fmaf(wm[j], ur[j * sh.fstride + C + ch], acc);
      rc.Cf[(long)ch * M + m] = pm ? acc : 0.0f;
    }
  }
  const float p[3] = {rp[o_pts + 3 * s], rp[o_pts + 3 * s + 1],
                      rp[o_pts + 3 * s + 2]};
  embed_fwd(p, Bg, false, rg, gw.emb, m, M);
  trunk_fwd(gw, rg, 0, m, M);
  if (sh.with_color) {
    embed_fwd(p, Bc, true, rc, cw.emb, m, M);
    trunk_fwd(cw, rc, 1, m, M);
  }
}

// Pass 2: one thread per ray.  Compositor, affine, per-ray losses; with
// `backward`, the compositor backward writes the trunk output cotangents
// over the G rows and the affine cotangents into daff.
__global__ void ml_rays(const float* __restrict__ row,
                        const float* __restrict__ okf,
                        const float* __restrict__ aff, Rows rg, Rows rc,
                        Shape sh, int backward, float* __restrict__ ray_loss,
                        float* __restrict__ daff) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= sh.n) return;
  const int S = sh.S;
  const long M = (long)sh.n * S;
  const float* rp = row + r * sh.D;
  const float d_gt = rp[4 * S + 3];
  float c_gt[3], rgb[HP_MAXS][3], a_s[HP_MAXS], t_s[HP_MAXS], w_s[HP_MAXS];
  bool pm[HP_MAXS];
  for (int c = 0; c < 3; ++c) c_gt[c] = rp[4 * S + 4 + c];
  float t_run = 1.0f;
  int nn = 0;
  for (int s = 0; s < S; ++s) {
    const long m = r * S + s;
    pm[s] = rp[4 * S + 7 + s] > 0.5f;
    nn += pm[s] ? 1 : 0;
    const float occ = pm[s] ? rg.G[m] : -100.0f;
    const float a = sigm(sh.coef * occ);
    a_s[s] = a;
    t_s[s] = t_run;
    w_s[s] = a * t_run;
    t_run = t_run * ((1.0f - a) + 1e-10f);
    for (int c = 0; c < 3; ++c) {
      float v = 0.0f;
      if (sh.with_color) {
        v = rc.G[(long)c * M + m];
        if (sh.sigmoid_rgb) v = sigm(v);
      }
      rgb[s][c] = v;
    }
  }
  float wsum = 0.0f;
  for (int s = 0; s < S; ++s) wsum += w_s[s];
  wsum += 1e-10f;
  float dnum = 0.0f;
  for (int s = 0; s < S; ++s) dnum += w_s[s] * rp[s];
  const float depth = dnum / wsum;
  float craw[3], color[3];
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += w_s[s] * rgb[s][c];
    craw[c] = acc / wsum;
  }
  const float* ar = aff + r * 12;
  const bool affine = sh.use_affine && sh.with_color;
  if (affine) {
    for (int d = 0; d < 3; ++d) {
      float lin = 0.0f;
      for (int c = 0; c < 3; ++c) lin += craw[c] * ar[3 * c + d];
      color[d] = sigm(lin + ar[9 + d]);
    }
  } else {
    for (int c = 0; c < 3; ++c) color[c] = craw[c];
  }
  const bool mask = (okf[r] > 0.5f) && (nn >= S / 2 + 1) && isfinite(depth);
  float gl = 0.0f, cl = 0.0f;
  if (mask) {
    gl = fabsf(d_gt - depth);
    if (sh.with_color)
      cl = fabsf(c_gt[0] - color[0]) + fabsf(c_gt[1] - color[1])
           + fabsf(c_gt[2] - color[2]);
  }
  ray_loss[2 * r] = gl;
  ray_loss[2 * r + 1] = cl;
  if (!backward) return;

  const float maskf = mask ? 1.0f : 0.0f;
  const float g_depth = -sgnf(d_gt - depth) * maskf;
  float g_craw[3] = {0.0f, 0.0f, 0.0f};
  float* da = daff + r * 12;
  for (int q = 0; q < 12; ++q) da[q] = 0.0f;
  if (sh.with_color) {
    float g_color[3];
    for (int c = 0; c < 3; ++c)
      g_color[c] = -sgnf(c_gt[c] - color[c]) * maskf * sh.w_color;
    if (affine) {
      float g_lin[3];
      for (int d = 0; d < 3; ++d)
        g_lin[d] = g_color[d] * color[d] * (1.0f - color[d]);
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int d = 0; d < 3; ++d) acc += g_lin[d] * ar[3 * c + d];
        g_craw[c] = acc;
      }
      for (int c = 0; c < 3; ++c)
        for (int d = 0; d < 3; ++d) da[3 * c + d] = g_lin[d] * craw[c];
      for (int d = 0; d < 3; ++d) da[9 + d] = g_lin[d];
    } else {
      for (int c = 0; c < 3; ++c) g_craw[c] = g_color[c];
    }
  }
  float dw[HP_MAXS];
  for (int s = 0; s < S; ++s) {
    float dcol = 0.0f;
    for (int c = 0; c < 3; ++c) dcol += g_craw[c] * (rgb[s][c] - craw[c]);
    dw[s] = (g_depth * (rp[s] - depth) + dcol) / wsum;
  }
  float suffix = 0.0f;
  for (int s = S - 1; s >= 0; --s) {
    const float das = dw[s] * t_s[s] - suffix / ((1.0f - a_s[s]) + 1e-10f);
    suffix += dw[s] * w_s[s];
    const long m = r * S + s;
    rg.G[m] = pm[s] ? das * sh.coef * a_s[s] * (1.0f - a_s[s]) : 0.0f;
    if (sh.with_color) {
      for (int c = 0; c < 3; ++c) {
        float g = g_craw[c] * (w_s[s] / wsum);
        if (sh.sigmoid_rgb) g = g * rgb[s][c] * (1.0f - rgb[s][c]);
        rc.G[(long)c * M + m] = g;
      }
    }
  }
}

// Pass 3: one thread per sample, both trunk backwards.
__global__ void ml_bwd_samples(Core gw, Core cw, Rows rg, Rows rc,
                               Shape sh) {
  const long M = (long)sh.n * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  trunk_bwd(gw, rg, 0, m, M, false);
  if (sh.with_color) trunk_bwd(cw, rc, 1, m, M, false);
}

// Pass 4: duf[ray, j*fstride + ch] = sum_s Wm[ray, s, j] * pm_s * dc_s[ch],
// one thread per output element.
__global__ void ml_union_bwd(const float* __restrict__ row, Rows rg, Rows rc,
                             Shape sh, float* __restrict__ duf) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long total = (long)sh.n * sh.ufw;
  if (e >= total) return;
  const long ray = e / sh.ufw;
  const int col = (int)(e % sh.ufw);
  const int j = col / sh.fstride;
  int ch = col % sh.fstride;
  const float* dcr = rg.DC;
  if (ch >= sh.C) {
    dcr = rc.DC;
    ch -= sh.C;
  }
  const int S = sh.S;
  const long M = (long)sh.n * S;
  const float* rp = row + ray * sh.D;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) {
    if (rp[4 * S + 7 + s] > 0.5f)
      acc = fmaf(rp[5 * S + 7 + s * sh.u + j], dcr[(long)ch * M + ray * S + s],
                 acc);
  }
  duf[e] = acc;
}

// Pass 6: losses[0..1] = sums of the per-ray partials, in a fixed order.
__global__ void loss_reduce(const float* __restrict__ ray_loss, long n,
                            float* __restrict__ losses) {
  __shared__ float sg[256], sc[256];
  float g = 0.0f, c = 0.0f;
  for (long r = threadIdx.x; r < n; r += blockDim.x) {
    g += ray_loss[2 * r];
    c += ray_loss[2 * r + 1];
  }
  sg[threadIdx.x] = g;
  sc[threadIdx.x] = c;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) {
      sg[threadIdx.x] += sg[threadIdx.x + off];
      sc[threadIdx.x] += sc[threadIdx.x + off];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    losses[0] = sg[0];
    losses[1] = sc[0];
  }
}

// Floats of scratch the entry point needs for n rays of S samples.
extern "C" long hp_maploss_scratch_floats(int n, int S, int C, int emb_g,
                                          int hid_g, int emb_c, int hid_c,
                                          int nb, int with_color) {
  const long M = (long)n * S;
  long rows = trunk_rows(emb_g, hid_g, C, nb, 1);
  if (with_color) rows += trunk_rows(emb_c, hid_c, C, nb, 3);
  return rows * M + 2L * n + 2L;
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #2, the forward: losses[0..1] only.
//   backward == 1: kernel #3, forward plus every cotangent: duf (n, ufw),
//     daff (n, 12) and, with need_wgrads, the colour-core weight grads into
//     dcw (flatten_core order, 4*nb+2 device pointers).
// gw / cw: host arrays of device pointers to the geometry / colour core
// tensors in flatten_core order.  scratch holds
// hp_maploss_scratch_floats(...) floats; wpart holds
// wsplits * (emb_c + hid_c) * hid_c floats.  Returns the first CUDA error.
extern "C" int hp_maploss(
    const float* row, int D, const float* uf, int ufw, const float* okf,
    const float* aff, const float* Bg, const float* Bc,
    const void* const* gw, const void* const* cw, int n, int S, int u, int C,
    int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    int with_color, float coef, int sigmoid_rgb, int use_affine,
    float w_color, int backward, int need_wgrads, float* scratch,
    float* losses, float* duf, float* daff, void* const* dcw, float* wpart,
    int wsplits, void* stream) {
  if (n <= 0) return 0;
  if (S > HP_MAXS || nb > HP_MAXB || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)n * S;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore;
  if (with_color) ccore = make_core(cw, nb, skip, emb_c, hid_c, C, 3);
  else ccore = gcore;
  Rows rg = make_rows(scratch, M, emb_g, hid_g, C, nb, 1);
  float* next = scratch + trunk_rows(emb_g, hid_g, C, nb, 1) * M;
  Rows rc = rg;
  if (with_color) {
    rc = make_rows(next, M, emb_c, hid_c, C, nb, 3);
    next += trunk_rows(emb_c, hid_c, C, nb, 3) * M;
  }
  float* ray_loss = next;
  Shape sh;
  sh.n = n; sh.S = S; sh.u = u; sh.C = C; sh.D = D; sh.ufw = ufw;
  sh.fstride = with_color ? 2 * C : C;
  sh.with_color = with_color; sh.sigmoid_rgb = sigmoid_rgb;
  sh.use_affine = use_affine; sh.coef = coef; sh.w_color = w_color;

  const int TB = 128;
  const unsigned gs = (unsigned)((M + TB - 1) / TB);
  ml_fwd_samples<<<gs, TB, 0, st>>>(row, uf, Bg, Bc, gcore, ccore, rg, rc,
                                    sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ml_rays<<<(unsigned)((n + TB - 1) / TB), TB, 0, st>>>(
      row, okf, aff, rg, rc, sh, backward, ray_loss, daff);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  loss_reduce<<<1, 256, 0, st>>>(ray_loss, n, losses);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!backward) return 0;

  ml_bwd_samples<<<gs, TB, 0, st>>>(gcore, ccore, rg, rc, sh);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long tot = (long)n * ufw;
  ml_union_bwd<<<(unsigned)((tot + 255) / 256), 256, 0, st>>>(row, rg, rc,
                                                              sh, duf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!(with_color && need_wgrads)) return 0;

  // colour-core weight grads, flatten_core order
  return launch_core_wgrads(ccore, rc, M, wpart, wsplits, dcw, st);
}
