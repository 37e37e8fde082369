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
// Weights are read from global memory (L2): the 128-wide colour core does
// not fit one block's shared memory whole, and every thread of a warp
// reads the same weight at the same time, so each weight read is one
// broadcast transaction.  The hidden widths are walked by loops that are
// not unrolled; only the 16-wide accumulator chunk is.
//
// Bound on the card: operations.  At the mapping operating point the two
// trunks cost about 0.2 MFLOP per sample forward and twice that backward,
// against a few kB of input per sample.  This first version runs them as
// scalar f32 FMAs one sample per thread, far from the tensor-core rate;
// moving the trunks onto wgmma tiles with TMA-fed weights is later work.
#include <cuda_runtime.h>
#include <math.h>

#define HP_MAXB 8    // most trunk blocks supported
#define HP_MAXS 16   // most samples per ray supported
#define HP_CH 16     // accumulator chunk (the only unrolled width)

struct Core {
  const float* W[HP_MAXB];
  const float* b[HP_MAXB];
  const float* F[HP_MAXB];
  const float* f[HP_MAXB];
  const float* Wout;
  const float* bout;
  int nb, skip, emb, hid, cdim, nout;
};

// Row offsets of one trunk's scratch block (each row holds M floats).
struct Rows {
  float* E;    // emb rows: Fourier embedding
  float* Cf;   // cdim rows: interpolated feature (pm-masked)
  float* A;    // nb*hid rows: pre-activations, then their cotangents
  float* H;    // nb*hid rows: block outputs
  float* DH;   // nb*hid rows: cotangents of the block outputs
  float* G;    // nout rows: trunk output, then its cotangent
  float* DC;   // cdim rows: cotangent of the feature
};

__host__ __device__ inline long trunk_rows(int emb, int hid, int cdim,
                                           int nb, int nout) {
  return (long)emb + cdim + 3L * nb * hid + nout + cdim;
}

__host__ __device__ inline Rows make_rows(float* base, long M, int emb,
                                          int hid, int cdim, int nb,
                                          int nout) {
  Rows r;
  r.E = base;
  r.Cf = r.E + (long)emb * M;
  r.A = r.Cf + (long)cdim * M;
  r.H = r.A + (long)nb * hid * M;
  r.DH = r.H + (long)nb * hid * M;
  r.G = r.DH + (long)nb * hid * M;
  r.DC = r.G + (long)nout * M;
  return r;
}

__device__ __forceinline__ float act_f(int code, float a) {
  if (code == 0) return fmaxf(a, 0.0f);
  const float bx = 100.0f * a;
  return bx > 20.0f ? a : log1pf(expf(fminf(bx, 20.0f))) / 100.0f;
}

__device__ __forceinline__ float dact_f(int code, float a) {
  if (code == 0) return a > 0.0f ? 1.0f : 0.0f;
  const float bx = 100.0f * a;
  return bx > 20.0f ? 1.0f : 1.0f / (1.0f + expf(-fminf(bx, 20.0f)));
}

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

// out[j] (+)= sum_t x(t) * W[t*nout + j] + bias[j] for j < nout, where x(t)
// is row t of segment 1 for t < n1 and row t-n1 of segment 2 otherwise.
__device__ void dense_fwd(const float* x1, int n1, const float* x2, int n2,
                          const float* W, const float* bias, int nout,
                          float* out, bool accumulate, long m, long M) {
  const int nin = n1 + n2;
  for (int j0 = 0; j0 < nout; j0 += HP_CH) {
    float acc[HP_CH];
#pragma unroll
    for (int q = 0; q < HP_CH; ++q) acc[q] = 0.0f;
    for (int t = 0; t < nin; ++t) {
      const float xv = t < n1 ? x1[(long)t * M + m]
                             : x2[(long)(t - n1) * M + m];
      const float* w = W + (long)t * nout + j0;
#pragma unroll
      for (int q = 0; q < HP_CH; ++q)
        if (j0 + q < nout) acc[q] = fmaf(xv, w[q], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < HP_CH; ++q) {
      if (j0 + q < nout) {
        float v = acc[q];
        if (bias) v += bias[j0 + q];
        float* o = out + (long)(j0 + q) * M + m;
        *o = accumulate ? *o + v : v;
      }
    }
  }
}

// out[t - t0] (+)= sum_j dy(j) * W[t*nout + j] for t in [t0, t1): the
// product with the transposed weight (input cotangents).
__device__ void dense_bwd(const float* dy, int nout, const float* W, int t0,
                          int t1, float* out, bool accumulate, long m,
                          long M) {
  for (int c0 = t0; c0 < t1; c0 += HP_CH) {
    float acc[HP_CH];
#pragma unroll
    for (int q = 0; q < HP_CH; ++q) acc[q] = 0.0f;
    for (int j = 0; j < nout; ++j) {
      const float yv = dy[(long)j * M + m];
#pragma unroll
      for (int q = 0; q < HP_CH; ++q)
        if (c0 + q < t1) acc[q] = fmaf(yv, W[(long)(c0 + q) * nout + j],
                                       acc[q]);
    }
#pragma unroll
    for (int q = 0; q < HP_CH; ++q) {
      if (c0 + q < t1) {
        float* o = out + (long)(c0 + q - t0) * M + m;
        *o = accumulate ? *o + acc[q] : acc[q];
      }
    }
  }
}

// Input segments of layer i (i == nb is the output layer).
__device__ __forceinline__ void layer_input(const Core& w, const Rows& r,
                                            long M, int i, const float** x1,
                                            int* n1, const float** x2,
                                            int* n2) {
  if (i == 0) {
    *x1 = r.E; *n1 = w.emb; *x2 = nullptr; *n2 = 0;
  } else if (i == w.skip + 1) {
    *x1 = r.E; *n1 = w.emb;
    *x2 = r.H + (long)(i - 1) * w.hid * M; *n2 = w.hid;
  } else {
    *x1 = r.H + (long)(i - 1) * w.hid * M; *n1 = w.hid;
    *x2 = nullptr; *n2 = 0;
  }
}

// Trunk forward for sample m; E and Cf rows are filled, the output goes to
// the G rows.
__device__ void trunk_fwd(const Core& w, const Rows& r, int code, long m,
                          long M) {
  for (int i = 0; i < w.nb; ++i) {
    const float *x1, *x2;
    int n1, n2;
    layer_input(w, r, M, i, &x1, &n1, &x2, &n2);
    float* Ai = r.A + (long)i * w.hid * M;
    float* Hi = r.H + (long)i * w.hid * M;
    dense_fwd(x1, n1, x2, n2, w.W[i], w.b[i], w.hid, Ai, false, m, M);
    // h_i = (act(a_i) + c F_i) + f_i, the reference's order of additions
    dense_fwd(r.Cf, w.cdim, nullptr, 0, w.F[i], nullptr, w.hid, Hi, false,
              m, M);
    for (int j = 0; j < w.hid; ++j)
      Hi[(long)j * M + m] = (act_f(code, Ai[(long)j * M + m])
                             + Hi[(long)j * M + m]) + w.f[i][j];
  }
  const float *x1, *x2;
  int n1, n2;
  layer_input(w, r, M, w.nb, &x1, &n1, &x2, &n2);
  dense_fwd(x1, n1, x2, n2, w.Wout, w.bout, w.nout, r.G, false, m, M);
}

// Trunk backward for sample m: G rows hold the output cotangent.  Leaves
// dL/dc in DC, dL/dh_i in DH and dL/da_i in place of the pre-activations.
__device__ void trunk_bwd(const Core& w, const Rows& r, int code, long m,
                          long M) {
  const int L = w.nb - 1;
  const int t0 = (w.skip == L) ? w.emb : 0;
  dense_bwd(r.G, w.nout, w.Wout, t0, t0 + w.hid, r.DH + (long)L * w.hid * M,
            false, m, M);
  for (int c = 0; c < w.cdim; ++c) r.DC[(long)c * M + m] = 0.0f;
  for (int i = L; i >= 0; --i) {
    float* Ai = r.A + (long)i * w.hid * M;
    const float* DHi = r.DH + (long)i * w.hid * M;
    dense_bwd(DHi, w.hid, w.F[i], 0, w.cdim, r.DC, true, m, M);
    for (int j = 0; j < w.hid; ++j) {
      const long o = (long)j * M + m;
      Ai[o] = DHi[o] * dact_f(code, Ai[o]);
    }
    if (i > 0) {
      const int s0 = (i == w.skip + 1) ? w.emb : 0;
      dense_bwd(Ai, w.hid, w.W[i], s0, s0 + w.hid,
                r.DH + (long)(i - 1) * w.hid * M, false, m, M);
    }
  }
}

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
  // Fourier embeds; proj = (2 pi p) . B[:, k] in the plain version's exact
  // operation order (no FMA contraction), since proj reaches 1e3 radians
  const float tp0 = rp[o_pts + 3 * s] * 6.2831855f;
  const float tp1 = rp[o_pts + 3 * s + 1] * 6.2831855f;
  const float tp2 = rp[o_pts + 3 * s + 2] * 6.2831855f;
  for (int k = 0; k < gw.emb; ++k) {
    const float pr = __fadd_rn(__fadd_rn(__fmul_rn(tp0, Bg[k]),
                                         __fmul_rn(tp1, Bg[gw.emb + k])),
                               __fmul_rn(tp2, Bg[2 * gw.emb + k]));
    rg.E[(long)k * M + m] = sinf(pr);
  }
  trunk_fwd(gw, rg, 0, m, M);
  if (sh.with_color) {
    const int ec = cw.emb / 2;
    for (int k = 0; k < ec; ++k) {
      const float pr = __fadd_rn(__fadd_rn(__fmul_rn(tp0, Bc[k]),
                                           __fmul_rn(tp1, Bc[ec + k])),
                                 __fmul_rn(tp2, Bc[2 * ec + k]));
      rc.E[(long)k * M + m] = sinf(pr);
      rc.E[(long)(ec + k) * M + m] = cosf(pr);
    }
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
  trunk_bwd(gw, rg, 0, m, M);
  if (sh.with_color) trunk_bwd(cw, rc, 1, m, M);
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

// Pass 5a: part[split][t][j] = sum over the split's samples of
// X(t)[m] * Y(j)[m].  X(t) is row t of segment 1 (t < n1) or row t-n1 of
// segment 2; x1 == nullptr stands for a single row of ones (bias grads).
#define WG_T 32
#define WG_J 32
#define WG_M 32
__global__ void wgrad_partial(const float* __restrict__ x1, int n1,
                              const float* __restrict__ x2, int n2,
                              const float* __restrict__ Y, int nj, long M,
                              int m_per_split, float* __restrict__ part) {
  __shared__ float xs[WG_T][WG_M + 1];
  __shared__ float ys[WG_J][WG_M + 1];
  const int nt = x1 ? n1 + n2 : 1;
  const int t0 = blockIdx.x * WG_T, j0 = blockIdx.y * WG_J;
  const long mb = (long)blockIdx.z * m_per_split;
  long me = mb + m_per_split;
  if (me > M) me = M;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
  for (long mm = mb; mm < me; mm += WG_M) {
    for (int e = threadIdx.x; e < WG_T * WG_M; e += blockDim.x) {
      const int rr = e / WG_M, cc = e % WG_M;
      const int t = t0 + rr;
      const long mi = mm + cc;
      float v = 0.0f;
      if (t < nt && mi < me) {
        if (!x1) v = 1.0f;
        else v = t < n1 ? x1[(long)t * M + mi] : x2[(long)(t - n1) * M + mi];
      }
      xs[rr][cc] = v;
      const int j = j0 + rr;
      ys[rr][cc] = (j < nj && mi < me) ? Y[(long)j * M + mi] : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < WG_M; ++c) {
      const float xa = xs[ty * 2][c], xb = xs[ty * 2 + 1][c];
      const float ya = ys[tx * 2][c], yb = ys[tx * 2 + 1][c];
      acc[0][0] = fmaf(xa, ya, acc[0][0]);
      acc[0][1] = fmaf(xa, yb, acc[0][1]);
      acc[1][0] = fmaf(xb, ya, acc[1][0]);
      acc[1][1] = fmaf(xb, yb, acc[1][1]);
    }
    __syncthreads();
  }
  for (int a = 0; a < 2; ++a) {
    for (int b = 0; b < 2; ++b) {
      const int t = t0 + ty * 2 + a, j = j0 + tx * 2 + b;
      if (t < nt && j < nj)
        part[((long)blockIdx.z * nt + t) * nj + j] = acc[a][b];
    }
  }
}

// Pass 5b: out[i] = sum over splits of part[split][i], in split order.
__global__ void wgrad_reduce(const float* __restrict__ part, int splits,
                             long count, float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp) acc += part[(long)sp * count + i];
  out[i] = acc;
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

static Core make_core(const void* const* p, int nb, int skip, int emb,
                      int hid, int cdim, int nout) {
  Core c;
  for (int i = 0; i < HP_MAXB; ++i) {
    c.W[i] = c.b[i] = c.F[i] = c.f[i] = nullptr;
  }
  for (int i = 0; i < nb; ++i) {
    c.W[i] = (const float*)p[2 * i];
    c.b[i] = (const float*)p[2 * i + 1];
    c.F[i] = (const float*)p[2 * nb + 2 * i];
    c.f[i] = (const float*)p[2 * nb + 2 * i + 1];
  }
  c.Wout = (const float*)p[4 * nb];
  c.bout = (const float*)p[4 * nb + 1];
  c.nb = nb;
  c.skip = skip;
  c.emb = emb;
  c.hid = hid;
  c.cdim = cdim;
  c.nout = nout;
  return c;
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

// Launch one weight-gradient product: out (nt x nj) = X^T Y over M samples.
static int launch_wgrad(const float* x1, int n1, const float* x2, int n2,
                        const float* Y, int nj, long M, float* part,
                        int splits, float* out, cudaStream_t st) {
  const int nt = x1 ? n1 + n2 : 1;
  const int m_per_split = (int)((M + splits - 1) / splits);
  dim3 grid((nt + WG_T - 1) / WG_T, (nj + WG_J - 1) / WG_J, splits);
  wgrad_partial<<<grid, 256, 0, st>>>(x1, n1, x2, n2, Y, nj, M, m_per_split,
                                      part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long count = (long)nt * nj;
  wgrad_reduce<<<(unsigned)((count + 255) / 256), 256, 0, st>>>(part, splits,
                                                                count, out);
  return (int)cudaGetLastError();
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

  // colour-core weight grads, flatten_core order:
  // [W_i, b_i]*nb, [F_i, f_i]*nb, Wout, bout
  const int hid = hid_c, emb = emb_c;
  for (int i = 0; i < nb; ++i) {
    const float *x1, *x2;
    int n1, n2;
    if (i == 0) {
      x1 = rc.E; n1 = emb; x2 = nullptr; n2 = 0;
    } else if (i == skip + 1) {
      x1 = rc.E; n1 = emb; x2 = rc.H + (long)(i - 1) * hid * M; n2 = hid;
    } else {
      x1 = rc.H + (long)(i - 1) * hid * M; n1 = hid; x2 = nullptr; n2 = 0;
    }
    const float* DA = rc.A + (long)i * hid * M;
    const float* DH = rc.DH + (long)i * hid * M;
    int rc_ = launch_wgrad(x1, n1, x2, n2, DA, hid, M, wpart, wsplits,
                           (float*)dcw[2 * i], st);
    if (rc_) return rc_;
    rc_ = launch_wgrad(nullptr, 1, nullptr, 0, DA, hid, M, wpart, wsplits,
                       (float*)dcw[2 * i + 1], st);
    if (rc_) return rc_;
    rc_ = launch_wgrad(rc.Cf, C, nullptr, 0, DH, hid, M, wpart, wsplits,
                       (float*)dcw[2 * nb + 2 * i], st);
    if (rc_) return rc_;
    rc_ = launch_wgrad(nullptr, 1, nullptr, 0, DH, hid, M, wpart, wsplits,
                       (float*)dcw[2 * nb + 2 * i + 1], st);
    if (rc_) return rc_;
  }
  const float *x1, *x2;
  int n1, n2;
  if (skip == nb - 1) {
    x1 = rc.E; n1 = emb; x2 = rc.H + (long)(nb - 1) * hid * M; n2 = hid;
  } else {
    x1 = rc.H + (long)(nb - 1) * hid * M; n1 = hid; x2 = nullptr; n2 = 0;
  }
  int rc_ = launch_wgrad(x1, n1, x2, n2, rc.G, 3, M, wpart, wsplits,
                         (float*)dcw[4 * nb], st);
  if (rc_) return rc_;
  return launch_wgrad(nullptr, 1, nullptr, 0, rc.G, 3, M, wpart, wsplits,
                      (float*)dcw[4 * nb + 1], st);
}
