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
//   1. a tile of TC_TM samples per block (tl_fwd_tiles), in both kernels:
//      the points, the neighbour weights, the feature mix, then both trunk
//      forwards on the tensor cores (3xTF32 mma.sync, nicer_trunk_tc.cuh).
//      The trunk outputs go to G rows; #9 keeps the pre-activations in A
//      rows too, for its backward, #8 nothing else.
//   2. one thread per ray (tl_rays): colour tail, compositor -> depth,
//      var, colour; backward: the compositor backward (dw, the suffix sum,
//      d occ masked by `has`, d rgb), the tail backward (d raw, d aff summed
//      over the S samples), written over the trunk output rows.
//   3. backward, a tile of TC_TM samples per block (tl_bwd_tiles): both
//      trunk backwards on the tensor cores including the embedding
//      cotangent, then d(point) = embedding route + weight route (the
//      quotient rule through w / max(sum w, 1e-12), masked by d^2 <= r^2).
//   4. backward, one thread per ray (tl_drays): d(o) = sum_s d(point_s),
//      d(d) = sum_s z_s d(point_s), in sample order.
// Kernel #8 is passes 1-2, #9 passes 1-4: #8's outputs and #9's forward
// recompute come from the same pass, so they are the same bits.
// The cached features are float32, or bfloat16 under model.mm_bf16 (the
// tracker's frozen bf16 gather table): the tile passes are instantiated
// for both, and each bf16 element is converted to float32 as it is loaded
// (exact), so everything after the load is the float32 variant's.
// A ray's S samples may straddle two tiles, so the per-ray work keeps its
// own launches, and each sample of a tile reads its own ray's cache row.
// `has` (enough neighbours inside the radius) comes from the frozen search
// distances in the cache row; the in-kernel d^2 <= r^2 mask from the
// current points.  Both are needed, as in the reference.  No atomics: every
// sum has a fixed order, so a result repeats bit for bit.
//
// Bound on the card: operations (both trunks, ~0.2 MFLOP per sample
// forward, twice that backward, against ~2 kB of cached neighbour
// features and positions per sample).  The tile passes hold both trunks'
// activations in shared memory and run their products on the tensor
// cores; the feature mix and the weight route, scalar f32, are spread over
// all the block's threads, the features read from device memory (~2 kB a
// sample, too large to stage).
#include <cuda_bf16.h>

#include "nicer_trunk_tc.cuh"

#define HP_MAXK 16   // most neighbours per sample supported

struct TLShape {
  int n, S, K, C, Dr;
  int wmode, use_affine, sigmoid_plain, backward;
  float coef;
};

// One cached feature element as float32 (bf16: exact).
__device__ __forceinline__ float feat_ld(const float* f) { return *f; }
__device__ __forceinline__ float feat_ld(const __nv_bfloat16* f) {
  return __bfloat162float(*f);
}

// Cache row offsets: [z S | d_gt 1 | c_gt 3 | r2 1 | has S | nz 1 | cpos SK*3]
__device__ __forceinline__ int o_r2(int S) { return S + 4; }
__device__ __forceinline__ int o_has(int S) { return S + 5; }
__device__ __forceinline__ int o_cp(int S) { return 2 * S + 6; }

// The sample point o + z_s d.
__device__ __forceinline__ void sample_point(const float* __restrict__ rays,
                                             const float* rp, long ray,
                                             int s, float pts[3]) {
  const float z = rp[s];
  const float* ro = rays + ray * 6;
  for (int d = 0; d < 3; ++d) pts[d] = ro[d] + z * ro[3 + d];
}

// The sample point and its unnormalised neighbour weights; returns
// max(sum w, 1e-12).
__device__ float point_weights(const float* __restrict__ rays,
                               const float* rp, const TLShape& sh, long ray,
                               int s, float pts[3], float w[HP_MAXK],
                               float dd[HP_MAXK]) {
  sample_point(rays, rp, ray, s, pts);
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

// Shared memory of the tile passes beyond the trunk layout
// sm: the colour feature, then its cotangent (Xs, TC_TM x (C+4)), so that
// both trunks' dL/dc are at hand for the weight route; and per-neighbour
// values of each sample (Wk, TC_TM x K: the normalised weights in pass 1,
// d wn in pass 3).  Kernel #8 runs pass 1 with this layout too: a forward
// that mixed the colour feature after the geometry trunk could do without
// Xs (9.2 KB), but the colour layout alone still fits one block per SM,
// and one pass keeps #8's outputs equal to #9's recompute bit for bit.
struct TLTile {
  TcTile geo, col;    // col: the same buffers with Cs = Xs
  float* Wk;
};

__device__ inline TLTile tl_tile(float* base, const TcSmem& sm, int C) {
  TLTile t;
  t.geo = tc_tile(base, sm);
  t.col = t.geo;
  t.col.Cs = base + sm.total;
  t.Wk = t.col.Cs + tc_round4(TC_TM * (C + 4));
  return t;
}

__host__ __device__ inline int tl_tile_floats(const TcSmem& sm, int C,
                                              int K) {
  return sm.total + tc_round4(TC_TM * (C + 4)) + tc_round4(TC_TM * K);
}

// The feature of the tile's samples r (geometry into Cg, colour into Cc):
// sum_j Wk[r][j] f_j, zero unless `has`; one (sample, channel) pair per
// thread and step, neighbours in order.
template <typename F>
__device__ void tile_mix(const float* __restrict__ rowc,
                         const F* __restrict__ cfeat, const TLShape& sh,
                         const float* Wk, float* Cg, float* Cc, long m0,
                         long M) {
  const int C = sh.C, K = sh.K, C2 = 2 * sh.C;
  for (int e = threadIdx.x; e < TC_TM * C2; e += blockDim.x) {
    const int r = e / C2, ch = e % C2;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M) {
      const long ray = m / sh.S;
      const int s = (int)(m % sh.S);
      const F* f = cfeat + m * ((long)K * C2) + ch;
      float acc = 0.0f;
      for (int j = 0; j < K; ++j) acc += Wk[r * K + j] * feat_ld(f + j * C2);
      v = rowc[ray * sh.Dr + o_has(sh.S) + s] > 0.5f ? acc : 0.0f;
    }
    if (ch < C) Cg[r * (C + 4) + ch] = v;
    else Cc[r * (C + 4) + ch - C] = v;
  }
}

// Pass 1 of kernels #8 and #9: a tile of TC_TM samples per block, m =
// ray*S + s.  The points, the normalised neighbour weights, the feature
// mix, then both trunk forwards on the tensor cores; the outputs to the G
// rows and, if the rows have them, the pre-activations to the A rows.
template <typename F>
__global__ void __launch_bounds__(TC_THREADS)
    tl_fwd_tiles(const float* __restrict__ rays,
                 const float* __restrict__ rowc,
                 const F* __restrict__ cfeat,
                 const float* __restrict__ Bg, const float* __restrict__ Bc,
                 Core gw, Core cw, Rows rg, Rows rc, TLShape sh, TcSmem sm) {
  extern __shared__ float4 tc_raw[];
  const TLTile T = tl_tile((float*)tc_raw, sm, sh.C);
  const long M = (long)sh.n * sh.S;
  const long m0 = (long)blockIdx.x * TC_TM;
  const int K = sh.K;
  for (int r = threadIdx.x; r < TC_TM; r += blockDim.x) {
    const long m = m0 + r;
    float pts[3] = {0.0f, 0.0f, 0.0f}, w[HP_MAXK], dd[HP_MAXK];
    float wsafe = 1.0f;
    if (m < M) {
      const long ray = m / sh.S;
      wsafe = point_weights(rays, rowc + ray * sh.Dr, sh, ray,
                            (int)(m % sh.S), pts, w, dd);
    }
    for (int d = 0; d < 3; ++d) T.geo.Ps[3 * r + d] = pts[d];
    for (int j = 0; j < K; ++j) T.Wk[r * K + j] = m < M ? w[j] / wsafe : 0.0f;
  }
  __syncthreads();
  tile_mix(rowc, cfeat, sh, T.Wk, T.geo.Cs, T.col.Cs, m0, M);
  const int embp_g = round8(gw.emb), embp_c = round8(cw.emb);
  tile_embed(T.geo.Ps, Bg, false, gw.emb, embp_g, T.geo.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, rg, 0, T.geo, embp_g, m0, M, false, true);
  __syncthreads();
  tile_embed(T.col.Ps, Bc, true, cw.emb, embp_c, T.col.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(cw, rc, 1, T.col, embp_c, m0, M, false, true);
}

// Pass 3 of kernel #9: a tile of TC_TM samples per block.  Both trunk
// backwards on the tensor cores from the output cotangents pass 2 left in
// the G rows (dL/dc of the geometry trunk in Cs, of the colour trunk in
// Xs), the embedding route of d(point), then the weight route; d(point) to
// the P rows.
template <typename F>
__global__ void __launch_bounds__(TC_THREADS)
    tl_bwd_tiles(const float* __restrict__ rays,
                 const float* __restrict__ rowc,
                 const F* __restrict__ cfeat,
                 const float* __restrict__ Bg, const float* __restrict__ Bc,
                 Core gw, Core cw, Rows rg, Rows rc, TLShape sh, TcSmem sm,
                 float* __restrict__ P) {
  extern __shared__ float4 tc_raw[];
  const TLTile T = tl_tile((float*)tc_raw, sm, sh.C);
  const long M = (long)sh.n * sh.S;
  const long m0 = (long)blockIdx.x * TC_TM;
  const int C = sh.C, K = sh.K, C2 = 2 * sh.C;
  for (int r = threadIdx.x; r < TC_TM; r += blockDim.x) {
    const long m = m0 + r;
    float pts[3] = {0.0f, 0.0f, 0.0f};
    if (m < M) {
      const long ray = m / sh.S;
      sample_point(rays, rowc + ray * sh.Dr, ray, (int)(m % sh.S), pts);
    }
    for (int d = 0; d < 3; ++d) T.geo.Ps[3 * r + d] = pts[d];
  }
  tile_rows_to_g(rg.G, 1, T.geo.Gs, m0, M);
  const int embp_g = round8(gw.emb), embp_c = round8(cw.emb);
  // (tc_trunk_bwd syncs before its first read of Ps or Gs)
  tc_trunk_bwd(gw, rg, 0, T.geo, embp_g, m0, M, true, false);
  float dpg[3] = {0.0f, 0.0f, 0.0f}, dpc[3] = {0.0f, 0.0f, 0.0f};
  if (threadIdx.x < TC_TM)
    tile_embed_bwd(T.geo.Ps, Bg, false, gw.emb, embp_g, T.geo.Es, dpg);
  __syncthreads();
  tile_rows_to_g(rc.G, 3, T.col.Gs, m0, M);
  tc_trunk_bwd(cw, rc, 1, T.col, embp_c, m0, M, true, false);
  if (threadIdx.x < TC_TM)
    tile_embed_bwd(T.col.Ps, Bc, true, cw.emb, embp_c, T.col.Es, dpc);
  // weight route: d wn_j = <dc_g, feat_g_j> + <dc_c, feat_c_j>, one
  // (sample, neighbour) pair per thread and step, channels in order
  for (int e = threadIdx.x; e < TC_TM * K; e += blockDim.x) {
    const int r = e / K, j = e % K;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M) {
      const F* f = cfeat + m * ((long)K * C2) + (long)j * C2;
      const float* dg = T.geo.Cs + r * (C + 4);
      const float* dc = T.col.Cs + r * (C + 4);
      float t1 = 0.0f, t2 = 0.0f;
      for (int ch = 0; ch < C; ++ch) {
        t1 += dg[ch] * feat_ld(f + ch);
        t2 += dc[ch] * feat_ld(f + C + ch);
      }
      v = t1 + t2;
    }
    T.Wk[e] = v;
  }
  __syncthreads();
  const int r = threadIdx.x;
  const long m = m0 + r;
  if (r >= TC_TM || m >= M) return;
  const long ray = m / sh.S;
  const int s = (int)(m % sh.S);
  const float* rp = rowc + ray * sh.Dr;
  float pts[3], w[HP_MAXK], dd[HP_MAXK];
  const float wsafe = point_weights(rays, rp, sh, ray, s, pts, w, dd);
  float dpt[3];
  for (int d = 0; d < 3; ++d)
    dpt[d] = 6.2831855f * dpg[d] + 6.2831855f * dpc[d];
  if (rp[o_has(sh.S) + s] > 0.5f) {
    const float* dwn = T.Wk + r * K;
    float inner = 0.0f;
    for (int j = 0; j < K; ++j) inner += dwn[j] * w[j];
    inner = inner / (wsafe * wsafe);
    const float r2 = rp[o_r2(sh.S)];
    for (int j = 0; j < K; ++j) {
      if (!(dd[j] <= r2)) continue;
      const float dwj = dwn[j] / wsafe - inner;
      const float ddd = sh.wmode == 0
          ? -dwj * w[j] * w[j]
          : dwj * w[j] * (-10.0f / sqrtf(fmaxf(dd[j], 1e-12f)));
      const float* cp = rp + o_cp(sh.S) + (s * K + j) * 3;
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

// Rows of one trunk in the tile passes: the output, then its cotangent
// (G); with keep_a (kernel #9) the pre-activations (A) before it.  Nothing
// else goes to device memory.
static Rows tile_rows(float* base, long M, int hid, int nb, bool keep_a) {
  Rows r = {};
  r.A = keep_a ? base : nullptr;
  r.G = keep_a ? base + (long)nb * hid * M : base;
  return r;
}

// Floats of scratch the entry point needs for n rays of S samples: both
// trunks' G rows (1 + 3); kernel #9 also their A rows and the 3 rows of
// d(point).
extern "C" long hp_trackloss_scratch_floats(int n, int S, int hid_g,
                                            int hid_c, int nb, int backward) {
  const long M = (long)n * S;
  if (backward) return ((long)nb * (hid_g + hid_c) + 1 + 3 + 3) * M;
  return 4 * M;
}

// Dynamic shared memory (bytes) of the tile passes.
static int trackloss_smem(int C, int K, int emb_g, int hid_g, int emb_c,
                          int hid_c, TcSmem* sm) {
  *sm = tc_smem(round8(emb_g), hid_g, round8(emb_c), hid_c, C, true);
  return tl_tile_floats(*sm, C, K) * (int)sizeof(float);
}

// Blocks of a tile pass (pass 1: #8 and #9, or 3) that fit one SM at these
// widths, from the CUDA occupancy calculator; negative: a CUDA error.
extern "C" int hp_trackloss_blocks_per_sm(int C, int K, int emb_g, int hid_g,
                                          int emb_c, int hid_c, int pass) {
  TcSmem sm;
  const int smem = trackloss_smem(C, K, emb_g, hid_g, emb_c, hid_c, &sm);
  int blocks = 0, rc;
  if (pass == 1) {
    rc = tc_smem_attr(tl_fwd_tiles<float>, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tl_fwd_tiles<float>, TC_THREADS, smem);
  } else {
    rc = tc_smem_attr(tl_bwd_tiles<float>, smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, tl_bwd_tiles<float>, TC_THREADS, smem);
  }
  return rc ? -rc : blocks;
}

// The launches of kernel #8 or #9 for features of type F (hp_trackloss).
template <typename F>
static int trackloss_run(
    const float* rays, const float* rowc, int Dr, const F* cfeat,
    const float* aff, const float* Bg, const float* Bc,
    const void* const* gw, const void* const* cw, int n, int S, int K,
    int C, int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    float coef, int wmode, int use_affine, int sigmoid_plain, int backward,
    const float* g_depth, const float* g_color, float* scratch,
    float* depth, float* var, float* color, float* drays, float* daff,
    void* stream) {
  if (S > HP_MAXS || S < 1 || K > HP_MAXK || K < 1 || nb > HP_MAXB
      || nb < 1)
    return (int)cudaErrorInvalidValue;
  if (hid_g % 8 || hid_c % 8 || C % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)n * S;
  Core gcore = make_core(gw, nb, skip, emb_g, hid_g, C, 1);
  Core ccore = make_core(cw, nb, skip, emb_c, hid_c, C, 3);
  TLShape sh;
  sh.n = n; sh.S = S; sh.K = K; sh.C = C; sh.Dr = Dr;
  sh.wmode = wmode; sh.use_affine = use_affine;
  sh.sigmoid_plain = sigmoid_plain; sh.backward = backward; sh.coef = coef;
  const int TB = 128;
  const unsigned gr = (unsigned)((n + TB - 1) / TB);
  Rows rg = tile_rows(scratch, M, hid_g, nb, backward);
  Rows rc = tile_rows(rg.G + M, M, hid_c, nb, backward);
  TcSmem sm;
  const int smem = trackloss_smem(C, K, emb_g, hid_g, emb_c, hid_c, &sm);
  int rc0 = tc_smem_attr(tl_fwd_tiles<F>, smem);
  if (!rc0 && backward) rc0 = tc_smem_attr(tl_bwd_tiles<F>, smem);
  if (rc0) return rc0;
  const unsigned gt = (unsigned)((M + TC_TM - 1) / TC_TM);
  tl_fwd_tiles<F><<<gt, TC_THREADS, smem, st>>>(rays, rowc, cfeat, Bg, Bc,
                                                gcore, ccore, rg, rc, sh, sm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tl_rays<<<gr, TB, 0, st>>>(rowc, aff, rg, rc, sh, g_depth, g_color, depth,
                             var, color, daff);
  e = cudaGetLastError();
  if (e != cudaSuccess || !backward) return (int)e;
  float* P = rc.G + 3 * M;
  tl_bwd_tiles<F><<<gt, TC_THREADS, smem, st>>>(rays, rowc, cfeat, Bg, Bc,
                                                gcore, ccore, rg, rc, sh, sm,
                                                P);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tl_drays<<<gr, TB, 0, st>>>(rowc, sh, P, drays);
  return (int)cudaGetLastError();
}

// C entry point (bound with ctypes).
//   backward == 0: kernel #8: depth (n,), var (n,), color (n, 3).
//   backward == 1: kernel #9: from g_depth (n,), g_color (n, 3): drays
//     (n, 6), daff (n, 12).
// Both need hid_g, hid_c and C to be multiples of 8.
// rays (n, 6) [o | d], rowc (n, Dr), cfeat (n, S*K*2C): float32, or
// bfloat16 with feat_bf16; aff (n, 12); Bg (3, emb_g), Bc (3, emb_c / 2);
// gw / cw: host arrays of device pointers to the core tensors in
// flatten_core order.  scratch holds hp_trackloss_scratch_floats(...)
// floats.  Returns the first CUDA error.
extern "C" int hp_trackloss(
    const float* rays, const float* rowc, int Dr, const void* cfeat,
    const float* aff, const float* Bg, const float* Bc,
    const void* const* gw, const void* const* cw, int n, int S, int K,
    int C, int emb_g, int hid_g, int emb_c, int hid_c, int nb, int skip,
    float coef, int wmode, int use_affine, int sigmoid_plain, int backward,
    int feat_bf16, const float* g_depth, const float* g_color,
    float* scratch, float* depth, float* var, float* color, float* drays,
    float* daff, void* stream) {
  if (n <= 0) return 0;
  if (feat_bf16)
    return trackloss_run(
        rays, rowc, Dr, (const __nv_bfloat16*)cfeat, aff, Bg, Bc, gw, cw, n,
        S, K, C, emb_g, hid_g, emb_c, hid_c, nb, skip, coef, wmode,
        use_affine, sigmoid_plain, backward, g_depth, g_color, scratch,
        depth, var, color, drays, daff, stream);
  return trackloss_run(
      rays, rowc, Dr, (const float*)cfeat, aff, Bg, Bc, gw, cw, n, S, K, C,
      emb_g, hid_g, emb_c, hid_c, nb, skip, coef, wmode, use_affine,
      sigmoid_plain, backward, g_depth, g_color, scratch, depth, var, color,
      drays, daff, stream);
}
