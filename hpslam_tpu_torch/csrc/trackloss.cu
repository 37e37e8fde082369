// Fused tracker render, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pair of `nicer_fused_trackloss`
// (hpslam_tpu/ops/fused_mlp.py): the forward `_trackloss_fwd_kernel`
// (:1565, launched by `_trackloss_fwd` :1761) and the backward
// `_trackloss_bwd_kernel` (:1581, launched by `_trackloss_bwd_call` :1794).
// Per ray: S sample points o + z_s d, each interpolating its K cached
// neighbours' [geo | col] features with weights computed here from the
// current point (wmode 0: 1 / (d^2 + 1e-10), 1: exp(-20 d), inside r^2,
// normalised by max(sum, 1e-12)), both NICER trunks, the per-sample
// exposure affine + sigmoid (or the plain sigmoid) and the occupancy
// compositor -> depth, depth variance, colour.  The backward recomputes
// the forward (as the Pallas kernel does) and returns d(rays) (n, 6) and
// d(aff) (n, 12) for the depth and colour cotangents (the variance carries
// no gradient).
//
// Passes (blocks run in no order on the card, so the Pallas body is split
// where a ray needs all its samples or a sample needs its ray):
//   1. one thread per (ray, sample): point, weights, feature mix, embeds,
//      both trunk forwards into scratch rows (nicer_trunk.cuh).
//   2. one thread per ray: colour tail, compositor -> depth, var, colour;
//      backward: the compositor backward (dw, the suffix sum, d occ masked
//      by `has`, d rgb), the tail backward (d raw, d aff summed over the S
//      samples), written over the trunk output rows.
//   3. backward, one thread per sample: both trunk backwards including the
//      embedding cotangent, then d(point) = embedding route + weight route
//      (the quotient rule through w / max(sum w, 1e-12), masked by
//      d^2 <= r^2).
//   4. backward, one thread per ray: d(o) = sum_s d(point_s),
//      d(d) = sum_s z_s d(point_s), in sample order.
// `has` (enough neighbours inside the radius) comes from the frozen search
// distances in the cache row; the in-kernel d^2 <= r^2 mask from the
// current points.  Both are needed, as in the reference.
//
// Bound on the card: operations (both trunks, ~0.2 MFLOP per sample
// forward, twice that backward, against ~2 kB of cached neighbour
// features and positions per sample).  Scalar f32 FMAs one sample per
// thread, as maploss.cu.
#include "nicer_trunk.cuh"

#define HP_MAXK 16   // most neighbours per sample supported

struct TLShape {
  int n, S, K, C, Dr;
  int wmode, use_affine, sigmoid_plain, backward;
  float coef;
};

// Cache row offsets: [z S | d_gt 1 | c_gt 3 | r2 1 | has S | nz 1 | cpos SK*3]
__device__ __forceinline__ int o_r2(int S) { return S + 4; }
__device__ __forceinline__ int o_has(int S) { return S + 5; }
__device__ __forceinline__ int o_cp(int S) { return 2 * S + 6; }

// The sample point and its unnormalised neighbour weights; returns
// max(sum w, 1e-12).
__device__ float point_weights(const float* __restrict__ rays,
                               const float* rp, const TLShape& sh, long ray,
                               int s, float pts[3], float w[HP_MAXK],
                               float dd[HP_MAXK]) {
  const float z = rp[s];
  const float* ro = rays + ray * 6;
  for (int d = 0; d < 3; ++d) pts[d] = ro[d] + z * ro[3 + d];
  const float r2 = rp[o_r2(sh.S)];
  float wsum = 0.0f;
  for (int j = 0; j < sh.K; ++j) {
    const float* cp = rp + o_cp(sh.S) + (s * sh.K + j) * 3;
    const float d0 = cp[0] - pts[0], d1 = cp[1] - pts[1],
                d2 = cp[2] - pts[2];
    const float q = d0 * d0 + d1 * d1 + d2 * d2;
    dd[j] = q;
    float wj = 0.0f;
    if (q <= r2)
      wj = sh.wmode == 0 ? 1.0f / (q + 1e-10f)
                         : expf(-20.0f * sqrtf(fmaxf(q, 1e-12f)));
    w[j] = wj;
    wsum += wj;
  }
  return fmaxf(wsum, 1e-12f);
}

// Pass 1: one thread per (ray, sample), m = ray*S + s.
__global__ void tl_fwd_samples(const float* __restrict__ rays,
                               const float* __restrict__ rowc,
                               const float* __restrict__ cfeat,
                               const float* __restrict__ Bg,
                               const float* __restrict__ Bc, Core gw,
                               Core cw, Rows rg, Rows rc, TLShape sh) {
  const long M = (long)sh.n * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long ray = m / sh.S;
  const int s = (int)(m % sh.S);
  const int C = sh.C;
  const float* rp = rowc + ray * sh.Dr;
  float pts[3], w[HP_MAXK], dd[HP_MAXK];
  const float wsafe = point_weights(rays, rp, sh, ray, s, pts, w, dd);
  const bool has = rp[o_has(sh.S) + s] > 0.5f;
  const float* f = cfeat + ray * ((long)sh.S * sh.K * 2 * C)
                   + (long)s * sh.K * 2 * C;
  for (int ch = 0; ch < C; ++ch) {
    float ag = 0.0f, ac = 0.0f;
    for (int j = 0; j < sh.K; ++j) {
      const float wn = w[j] / wsafe;
      ag += wn * f[j * 2 * C + ch];
      ac += wn * f[j * 2 * C + C + ch];
    }
    rg.Cf[(long)ch * M + m] = has ? ag : 0.0f;
    rc.Cf[(long)ch * M + m] = has ? ac : 0.0f;
  }
  embed_fwd(pts, Bg, false, rg, gw.emb, m, M);
  trunk_fwd(gw, rg, 0, m, M);
  embed_fwd(pts, Bc, true, rc, cw.emb, m, M);
  trunk_fwd(cw, rc, 1, m, M);
}

// Pass 2: one thread per ray.
__global__ void tl_rays(const float* __restrict__ rowc,
                        const float* __restrict__ aff, Rows rg, Rows rc,
                        TLShape sh, const float* __restrict__ g_depth,
                        const float* __restrict__ g_color,
                        float* __restrict__ depth, float* __restrict__ var,
                        float* __restrict__ color,
                        float* __restrict__ daff) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= sh.n) return;
  const int S = sh.S;
  const long M = (long)sh.n * S;
  const float* rp = rowc + r * sh.Dr;
  const float* ar = aff + r * 12;
  float raw[HP_MAXS][3], rgb[HP_MAXS][3], a_s[HP_MAXS], t_s[HP_MAXS],
      w_s[HP_MAXS];
  bool has[HP_MAXS];
  float t_run = 1.0f;
  for (int s = 0; s < S; ++s) {
    const long m = r * S + s;
    has[s] = rp[o_has(S) + s] > 0.5f;
    const float occ = has[s] ? rg.G[m] : -100.0f;
    const float a = sigm(sh.coef * occ);
    a_s[s] = a;
    t_s[s] = t_run;
    w_s[s] = a * t_run;
    t_run = t_run * ((1.0f - a) + 1e-10f);
    for (int c = 0; c < 3; ++c) raw[s][c] = rc.G[(long)c * M + m];
    for (int d = 0; d < 3; ++d) {
      if (sh.use_affine) {
        float lin = 0.0f;
        for (int c = 0; c < 3; ++c) lin += raw[s][c] * ar[3 * c + d];
        rgb[s][d] = sigm(lin + ar[9 + d]);
      } else {
        rgb[s][d] = sh.sigmoid_plain ? sigm(raw[s][d]) : raw[s][d];
      }
    }
  }
  float wsum = 0.0f;
  for (int s = 0; s < S; ++s) wsum += w_s[s];
  wsum += 1e-10f;
  float dnum = 0.0f;
  for (int s = 0; s < S; ++s) dnum += w_s[s] * rp[s];
  const float dep = dnum / wsum;
  float col[3];
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += w_s[s] * rgb[s][c];
    col[c] = acc / wsum;
  }
  if (!sh.backward) {
    float v = 0.0f;
    for (int s = 0; s < S; ++s) {
      const float dv = rp[s] - dep;
      v += w_s[s] * (dv * dv);
    }
    depth[r] = dep;
    var[r] = v;
    for (int c = 0; c < 3; ++c) color[r * 3 + c] = col[c];
    return;
  }
  const float gd = g_depth[r];
  const float gc[3] = {g_color[r * 3], g_color[r * 3 + 1],
                       g_color[r * 3 + 2]};
  float dw[HP_MAXS];
  for (int s = 0; s < S; ++s) {
    float dcol = 0.0f;
    for (int c = 0; c < 3; ++c) dcol += gc[c] * (rgb[s][c] - col[c]);
    dw[s] = (gd * (rp[s] - dep) + dcol) / wsum;
  }
  float da_acc[12];
  for (int q = 0; q < 12; ++q) da_acc[q] = 0.0f;
  float suffix = 0.0f;
  for (int s = S - 1; s >= 0; --s) {
    const float das = dw[s] * t_s[s] - suffix / ((1.0f - a_s[s]) + 1e-10f);
    suffix += dw[s] * w_s[s];
    const long m = r * S + s;
    rg.G[m] = has[s] ? das * sh.coef * a_s[s] * (1.0f - a_s[s]) : 0.0f;
    float g[3];
    for (int c = 0; c < 3; ++c) g[c] = gc[c] * (w_s[s] / wsum);
    float graw[3];
    if (sh.use_affine) {
      float gl[3];
      for (int d = 0; d < 3; ++d)
        gl[d] = g[d] * rgb[s][d] * (1.0f - rgb[s][d]);
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int d = 0; d < 3; ++d) acc += gl[d] * ar[3 * c + d];
        graw[c] = acc;
        for (int d = 0; d < 3; ++d) da_acc[3 * c + d] += gl[d] * raw[s][c];
      }
      for (int d = 0; d < 3; ++d) da_acc[9 + d] += gl[d];
    } else {
      for (int c = 0; c < 3; ++c)
        graw[c] = sh.sigmoid_plain ? g[c] * rgb[s][c] * (1.0f - rgb[s][c])
                                   : g[c];
    }
    for (int c = 0; c < 3; ++c) rc.G[(long)c * M + m] = graw[c];
  }
  for (int q = 0; q < 12; ++q) daff[r * 12 + q] = da_acc[q];
}

// Pass 3: one thread per sample, trunk backwards and d(point) into P.
__global__ void tl_bwd_samples(const float* __restrict__ rays,
                               const float* __restrict__ rowc,
                               const float* __restrict__ cfeat,
                               const float* __restrict__ Bg,
                               const float* __restrict__ Bc, Core gw,
                               Core cw, Rows rg, Rows rc, TLShape sh,
                               float* __restrict__ P) {
  const long M = (long)sh.n * sh.S;
  const long m = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long ray = m / sh.S;
  const int s = (int)(m % sh.S);
  const int C = sh.C;
  trunk_bwd(gw, rg, 0, m, M, true);
  trunk_bwd(cw, rc, 1, m, M, true);
  const float* rp = rowc + ray * sh.Dr;
  float pts[3], w[HP_MAXK], dd[HP_MAXK];
  const float wsafe = point_weights(rays, rp, sh, ray, s, pts, w, dd);
  float dpg[3] = {0.0f, 0.0f, 0.0f}, dpc[3] = {0.0f, 0.0f, 0.0f};
  embed_bwd(pts, Bg, false, rg, gw.emb, m, M, dpg);
  embed_bwd(pts, Bc, true, rc, cw.emb, m, M, dpc);
  float dpt[3];
  for (int d = 0; d < 3; ++d)
    dpt[d] = 6.2831855f * dpg[d] + 6.2831855f * dpc[d];
  // weight route: d wn_j = <dg, feat_g_j> + <dc, feat_c_j>
  if (rp[o_has(sh.S) + s] > 0.5f) {
    const float* f = cfeat + ray * ((long)sh.S * sh.K * 2 * C)
                     + (long)s * sh.K * 2 * C;
    float dwn[HP_MAXK];
    float inner = 0.0f;
    for (int j = 0; j < sh.K; ++j) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int ch = 0; ch < C; ++ch) {
        t1 += rg.DC[(long)ch * M + m] * f[j * 2 * C + ch];
        t2 += rc.DC[(long)ch * M + m] * f[j * 2 * C + C + ch];
      }
      dwn[j] = t1 + t2;
      inner += dwn[j] * w[j];
    }
    inner = inner / (wsafe * wsafe);
    const float r2 = rp[o_r2(sh.S)];
    for (int j = 0; j < sh.K; ++j) {
      if (!(dd[j] <= r2)) continue;
      const float dwj = dwn[j] / wsafe - inner;
      const float ddd = sh.wmode == 0
          ? -dwj * w[j] * w[j]
          : dwj * w[j] * (-10.0f / sqrtf(fmaxf(dd[j], 1e-12f)));
      const float* cp = rp + o_cp(sh.S) + (s * sh.K + j) * 3;
      for (int d = 0; d < 3; ++d) dpt[d] += ddd * 2.0f * (pts[d] - cp[d]);
    }
  }
  for (int d = 0; d < 3; ++d) P[(long)d * M + m] = dpt[d];
}

// Pass 4: one thread per ray, d(rays) = [sum_s dp_s | sum_s z_s dp_s].
__global__ void tl_drays(const float* __restrict__ rowc, TLShape sh,
                         const float* __restrict__ P,
                         float* __restrict__ drays) {
  const long r = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= sh.n) return;
  const long M = (long)sh.n * sh.S;
  const float* rp = rowc + r * sh.Dr;
  float dro[3] = {0.0f, 0.0f, 0.0f}, drd[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < sh.S; ++s) {
    const long m = r * sh.S + s;
    for (int d = 0; d < 3; ++d) {
      const float v = P[(long)d * M + m];
      dro[d] += v;
      drd[d] += rp[s] * v;
    }
  }
  for (int d = 0; d < 3; ++d) {
    drays[r * 6 + d] = dro[d];
    drays[r * 6 + 3 + d] = drd[d];
  }
}

// Floats of scratch the entry point needs for n rays of S samples.
extern "C" long hp_trackloss_scratch_floats(int n, int S, int C, int emb_g,
                                            int hid_g, int emb_c, int hid_c,
                                            int nb, int backward) {
  const long M = (long)n * S;
  long rows = trunk_rows(emb_g, hid_g, C, nb, 1, backward ? emb_g : 0)
              + trunk_rows(emb_c, hid_c, C, nb, 3, backward ? emb_c : 0);
  if (backward) rows += 3;
  return rows * M;
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #8: depth (n,), var (n,), color (n, 3).
//   backward == 1: kernel #9: from g_depth (n,), g_color (n, 3): drays
//     (n, 6), daff (n, 12).
// rays (n, 6) [o | d], rowc (n, Dr), cfeat (n, S*K*2C), aff (n, 12); Bg
// (3, emb_g), Bc (3, emb_c / 2); gw / cw: host arrays of device pointers
// to the core tensors in flatten_core order.  scratch holds
// hp_trackloss_scratch_floats(...) floats.  Returns the first CUDA error.
extern "C" int hp_trackloss(
    const float* rays, const float* rowc, int Dr, const float* cfeat,
    const float* aff, const float* Bg, const float* Bc,
    const void* const* gw, const void* const* cw, int n, int S, int K,
    int C, int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    float coef, int wmode, int use_affine, int sigmoid_plain, int backward,
    const float* g_depth, const float* g_color, float* scratch,
    float* depth, float* var, float* color, float* drays, float* daff,
    void* stream) {
  if (n <= 0) return 0;
  if (S > HP_MAXS || S < 1 || K > HP_MAXK || K < 1 || nb > HP_MAXB
      || nb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)n * S;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore = make_core(cw, nb, skip, emb_c, hid_c, C, 3);
  const int deg = backward ? emb_g : 0, dec = backward ? emb_c : 0;
  Rows rg = make_rows(scratch, M, emb_g, hid_g, C, nb, 1, deg);
  float* next = scratch + trunk_rows(emb_g, hid_g, C, nb, 1, deg) * M;
  Rows rc = make_rows(next, M, emb_c, hid_c, C, nb, 3, dec);
  float* P = next + trunk_rows(emb_c, hid_c, C, nb, 3, dec) * M;
  TLShape sh;
  sh.n = n; sh.S = S; sh.K = K; sh.C = C; sh.Dr = Dr;
  sh.wmode = wmode; sh.use_affine = use_affine;
  sh.sigmoid_plain = sigmoid_plain; sh.backward = backward; sh.coef = coef;
  const int TB = 128;
  const unsigned gs = (unsigned)((M + TB - 1) / TB);
  const unsigned gr = (unsigned)((n + TB - 1) / TB);
  tl_fwd_samples<<<gs, TB, 0, st>>>(rays, rowc, cfeat, Bg, Bc, gcore, ccore,
                                    rg, rc, sh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tl_rays<<<gr, TB, 0, st>>>(rowc, aff, rg, rc, sh, g_depth, g_color, depth,
                             var, color, daff);
  e = cudaGetLastError();
  if (e != cudaSuccess || !backward) return (int)e;
  tl_bwd_samples<<<gs, TB, 0, st>>>(rays, rowc, cfeat, Bg, Bc, gcore, ccore,
                                    rg, rc, sh, P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tl_drays<<<gr, TB, 0, st>>>(rowc, sh, P, drays);
  return (int)cudaGetLastError();
}
