// Whole-iteration mapping loss of the union path, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_maploss`
// (hpslam_tpu/ops/fused_mlp.py): the forward `_maploss_fwd_kernel` (:1066,
// launched by `_maploss_fwd` :1274), kernel #2, and the combined forward-
// plus-cotangents `_maploss_bwd_kernel` (:1098, launched by `_maploss_bwd`
// :1308), kernel #3.  Every product the Pallas body computes is computed
// here: the union feature mix, both Fourier embeds, both NICER trunks (ReLU
// geometry trunk, Softplus(beta=100) colour trunk, skip concat, additive
// feature injection), the occupancy compositor with -100 forcing, the
// exposure affine, the masked L1 losses and, in the combined form, d(uf),
// d(aff) and the colour-core weight gradients.
//
// Layout.  A TPU grid step owned a block of rays with all weights in VMEM
// and carried the loss and weight-gradient sums from step to step.  Blocks
// on the card run in no order, so the work is split into passes:
//   1. a tile of samples per block (ml_fwd_tiles): union mix, embeds, both
//      trunk forwards on the tensor-core tiles of nicer_trunk_tc.cuh; the
//      trunk outputs go to a scratch table of rows of length M = n*S
//      ("transposed": row t holds component t of every sample), and for
//      kernel #3 also what its backward reads back (ml_layout).
//   2. one thread per ray: compositor, affine, per-ray losses and, in the
//      combined form, the compositor backward (cotangents of occupancy,
//      raw colour and the affine rows).
//   3. (kernel #3) a tile of samples per block: both trunk backwards on
//      tensor cores, giving d(c_geo), d(c_col) and the per-sample
//      cotangents that the weight gradients need (ml_bwd_tiles).
//   4. (kernel #3) one thread per output element: union-mix backward into
//      d(uf).
//   5. (kernel #3) the colour core's weight gradients, X^T dY over the M
//      samples on tensor cores in fixed sample ranges, then a pass that
//      adds the ranges in a fixed order (launch_core_wgrads_tc).
//   6. the two loss sums: one block adds the per-ray partials in a fixed
//      order.
// Kernel #2 is passes 1, 2 and 6 with nothing kept but the four output
// rows, as the tracker-loss forward (#8) is #9's pass 1 plus its per-ray
// pass.  No atomics are used, so the result does not change from run to
// run.  The sums are taken in another order than the Pallas kernel's and
// the plain PyTorch version's, which is what the stated tolerances cover.
//
// Bound on the card: operations.  At the mapping operating point the two
// trunks cost about 0.2 MFLOP per sample forward and twice that backward,
// against a few kB of input per sample.  Both kernels run every trunk and
// weight-gradient product on the tensor cores at f32 accuracy (3xTF32
// mma.sync, nicer_trunk_tc.cuh), with each tile's activations and each
// layer's weights in shared memory.

#include "nicer_trunk_tc.cuh"

struct Shape {
  int n, S, u, C, D, ufw, fstride;
  int with_color, sigmoid_rgb, use_affine;
  float coef, w_color;
};

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

// Union mix of one trunk's channels (offset ch0 in each union slot) for
// the tile: Cs (TC_TM x C) and, if Cg is given, the feature rows.
__device__ void tile_mix(const float* __restrict__ row,
                         const float* __restrict__ uf, const Shape& sh,
                         int ch0, float* Cs, float* Cg, long m0, long M) {
  const int S = sh.S, u = sh.u, C = sh.C;
  for (int e = threadIdx.x; e < TC_TM * C; e += blockDim.x) {
    const int ch = e / TC_TM, r = e % TC_TM;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M) {
      const long ray = m / S;
      const int s = (int)(m % S);
      const float* rp = row + ray * sh.D;
      const float* wm = rp + 5 * S + 7 + s * u;
      const float* ur = uf + ray * sh.ufw;
      float acc = 0.0f;
      for (int j = 0; j < u; ++j)
        acc = fmaf(wm[j], ur[j * sh.fstride + ch0 + ch], acc);
      v = rp[4 * S + 7 + s] > 0.5f ? acc : 0.0f;
      if (Cg) Cg[(long)ch * M + m] = v;
    }
    Cs[r * (C + 4) + ch] = v;
  }
}

// Pass 1 of both kernels: a tile of TC_TM samples per block, m = ray*S + s.
// Both trunk forwards on tensor cores; the outputs go to the G rows, the
// pre-activations to the A rows where they are given (kernel #3), and with
// wgrads the colour trunk's layer inputs to its rows too.
__global__ void __launch_bounds__(TC_THREADS)
    ml_fwd_tiles(const float* __restrict__ row, const float* __restrict__ uf,
                 const float* __restrict__ Bg, const float* __restrict__ Bc,
                 Core gw, Core cw, Rows rg, Rows rc, Shape sh, TcSmem sm,
                 int wgrads) {
  extern __shared__ float4 tc_raw[];
  const TcTile T = tc_tile((float*)tc_raw, sm);
  const long M = (long)sh.n * sh.S;
  const long m0 = (long)blockIdx.x * TC_TM;
  const int S = sh.S;
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x) {
    const long m = m0 + e / 3;
    T.Ps[e] = m < M ? row[(m / S) * sh.D + S + 3 * (m % S) + e % 3] : 0.0f;
  }
  tile_mix(row, uf, sh, 0, T.Cs, nullptr, m0, M);
  __syncthreads();
  const int embp_g = round8(gw.emb);
  tile_embed(T.Ps, Bg, false, gw.emb, embp_g, T.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, rg, 0, T, embp_g, m0, M, false, true);
  if (!sh.with_color) return;
  __syncthreads();
  const int embp_c = round8(cw.emb);
  tile_mix(row, uf, sh, sh.C, T.Cs, wgrads ? rc.Cf : nullptr, m0, M);
  tile_embed(T.Ps, Bc, true, cw.emb, embp_c, T.Es, wgrads ? rc.E : nullptr,
             m0, M);
  __syncthreads();
  tc_trunk_fwd(cw, rc, 1, T, embp_c, m0, M, wgrads != 0, true);
}

// Pass 3 of kernel #3: both trunk backwards on a tile, from the output
// cotangents pass 2 left in the G rows; d(c) to the DC rows.
__global__ void __launch_bounds__(TC_THREADS)
    ml_bwd_tiles(Core gw, Core cw, Rows rg, Rows rc, Shape sh, TcSmem sm,
                 int wgrads) {
  extern __shared__ float4 tc_raw[];
  const TcTile T = tc_tile((float*)tc_raw, sm);
  const long M = (long)sh.n * sh.S;
  const long m0 = (long)blockIdx.x * TC_TM;
  tile_rows_to_g(rg.G, 1, T.Gs, m0, M);
  tc_trunk_bwd(gw, rg, 0, T, round8(gw.emb), m0, M, false, false);
  tile_to_rows(T.Cs, sh.C + 4, sh.C, rg.DC, m0, M);
  if (!sh.with_color) return;
  __syncthreads();
  tile_rows_to_g(rc.G, 3, T.Gs, m0, M);
  tc_trunk_bwd(cw, rc, 1, T, round8(cw.emb), m0, M, false, wgrads != 0);
  tile_to_rows(T.Cs, sh.C + 4, sh.C, rc.DC, m0, M);
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

// The scratch table: rows of M floats for what a later pass reads back.
// Both kernels: the trunk outputs (G: 1 geometry row, 3 colour rows), which
// pass 2 reads and, for kernel #3, overwrites with their cotangents.
// Kernel #3 also: both trunks' pre-activations (A, read by tc_trunk_bwd),
// the feature cotangents (DC, read by pass 4) and, with the weight
// gradients (wg), the colour trunk's embedding, feature, block outputs and
// dL/dh (E, Cf, H, DH).  Nothing else is written.  Returns the number of
// rows; with base, also the two trunks' Rows over it (unused rows null).
static long ml_layout(float* base, long M, int C, int hid_g, int emb_c,
                      int hid_c, int nb, bool colour, bool backward,
                      bool wg, Rows* rg, Rows* rc) {
  long rows = 0;
  auto take = [&](long k) {
    float* p = base ? base + rows * M : nullptr;
    rows += k;
    return p;
  };
  Rows g = {}, c = {};
  g.G = take(1);
  if (colour) c.G = take(3);
  if (backward) {
    g.A = take((long)nb * hid_g);
    g.DC = take(C);
    if (colour) {
      c.A = take((long)nb * hid_c);
      c.DC = take(C);
      if (wg) {
        c.E = take(emb_c);
        c.Cf = take(C);
        c.H = take((long)nb * hid_c);
        c.DH = take((long)nb * hid_c);
      }
    }
  }
  if (rg) *rg = g;
  if (rc) *rc = c;
  return rows;
}

// Floats of scratch the entry point needs for n rays of S samples: the
// rows of ml_layout, then the per-ray loss partials (2 per ray) and two
// spare floats.
extern "C" long hp_maploss_scratch_floats(int n, int S, int C, int hid_g,
                                          int emb_c, int hid_c, int nb,
                                          int with_color, int backward,
                                          int need_wgrads) {
  const long M = (long)n * S;
  const long rows = ml_layout(nullptr, M, C, hid_g, emb_c, hid_c, nb,
                              with_color, backward,
                              with_color && need_wgrads, nullptr, nullptr);
  return rows * M + 2L * n + 2L;
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #2, the forward: losses[0..1] only.
//   backward == 1: kernel #3, forward plus every cotangent: duf (n, ufw),
//     daff (n, 12) and, with need_wgrads, the colour-core weight grads into
//     dcw (flatten_core order, 4*nb+2 device pointers).
// gw / cw: host arrays of device pointers to the geometry / colour core
// tensors in flatten_core order.  scratch holds
// hp_maploss_scratch_floats(...) floats; wpart holds wsplits times the
// colour core's element count (every weight and bias).  Both kernels need
// hid_g, hid_c and C to be multiples of 8.  Returns the first CUDA error.
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
  if (hid_g % 8 || hid_c % 8 || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)n * S;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore;
  if (with_color) ccore = make_core(cw, nb, skip, emb_c, hid_c, C, 3);
  else ccore = gcore;
  const int wg = backward && with_color && need_wgrads;
  Rows rg, rc;
  float* ray_loss = scratch + ml_layout(scratch, M, C, hid_g, emb_c, hid_c,
                                        nb, with_color, backward, wg, &rg,
                                        &rc) * M;
  Shape sh;
  sh.n = n; sh.S = S; sh.u = u; sh.C = C; sh.D = D; sh.ufw = ufw;
  sh.fstride = with_color ? 2 * C : C;
  sh.with_color = with_color; sh.sigmoid_rgb = sigmoid_rgb;
  sh.use_affine = use_affine; sh.coef = coef; sh.w_color = w_color;

  const int TB = 128;
  const unsigned gt = (unsigned)((M + TC_TM - 1) / TC_TM);
  const TcSmem sm = tc_smem(round8(emb_g), hid_g, round8(emb_c), hid_c, C,
                            with_color != 0);
  const int smem = sm.total * (int)sizeof(float);
  int rc1 = tc_smem_attr(ml_fwd_tiles, smem);
  if (!rc1 && backward) rc1 = tc_smem_attr(ml_bwd_tiles, smem);
  if (rc1) return rc1;
  ml_fwd_tiles<<<gt, TC_THREADS, smem, st>>>(row, uf, Bg, Bc, gcore, ccore,
                                             rg, rc, sh, sm, wg);
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

  ml_bwd_tiles<<<gt, TC_THREADS, smem, st>>>(gcore, ccore, rg, rc, sh, sm,
                                             wg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long tot = (long)n * ufw;
  ml_union_bwd<<<(unsigned)((tot + 255) / 256), 256, 0, st>>>(row, rg, rc,
                                                              sh, duf);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!wg) return 0;

  // colour-core weight grads, flatten_core order
  return launch_core_wgrads_tc(ccore, rc, M, wpart, wsplits, dcw, st);
}
