// NICER decoder trunks, one sample per thread, shared by the port's
// kernels that have not moved onto the tensor-core tiles of
// nicer_trunk_tc.cuh: the mapping-loss forward of maploss.cu (kernel #2),
// the composite pair of composite.cu (#6, #7) and the tracker-loss forward
// of trackloss.cu (#8).  The structs, activations and Fourier projection
// here are shared by the tile code too.
//
// Device code for the two trunks of hpslam_tpu/ops/fused_mlp.py
// (`_trunk_fwd_block` :140, `_trunk_bwd_block` :169, `_embed_geo` /
// `_embed_col` :203-217): the ReLU geometry trunk and the Softplus(beta=100)
// colour trunk, each n_blocks x [linear -> act -> + c F + f] with the
// embedding concatenated after block `skip`, then a linear output layer.
//
// Layout.  Every intermediate of a sample lives in a scratch table of rows
// of length M (the number of samples): row t of a quantity holds its t-th
// component for every sample, so a warp's 32 samples touch 32 consecutive
// floats.  Weights are read from global memory (L2): the 128-wide colour
// core does not fit one block's shared memory whole, and every thread of a
// warp reads the same weight at the same time, so each read is one
// broadcast transaction.  Hidden widths are walked by loops that are not
// unrolled; only the 16-wide accumulator chunk is.
//
// Weight gradients are products of saved rows, X^T dY summed over the M
// samples: a tiled pass over (in, out) tiles and fixed sample ranges, then
// a pass that adds the ranges in a fixed order.  No atomics, so results do
// not change from run to run.
#pragma once

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
  float* Cf;   // cdim rows: interpolated feature
  float* A;    // nb*hid rows: pre-activations, then their cotangents
  float* H;    // nb*hid rows: block outputs
  float* DH;   // nb*hid rows: cotangents of the block outputs
  float* G;    // nout rows: trunk output, then its cotangent
  float* DC;   // cdim rows: cotangent of the feature
};

// Rows of one trunk's block.
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

// proj_k = (2 pi p) . B[:, k] in the plain version's exact operation order
// (no FMA contraction), since proj reaches 1e3 radians.  B is (3, nk).
__device__ __forceinline__ float fourier_proj(const float tp[3],
                                              const float* B, int nk,
                                              int k) {
  return __fadd_rn(__fadd_rn(__fmul_rn(tp[0], B[k]),
                             __fmul_rn(tp[1], B[nk + k])),
                   __fmul_rn(tp[2], B[2 * nk + k]));
}

// Embedding rows of sample m at the point p: sin(proj) for the geometry
// trunk (B has emb columns), [sin(proj) | cos(proj)] for the colour trunk
// (B has emb/2 columns).
__device__ void embed_fwd(const float p[3], const float* B, bool with_cos,
                          const Rows& r, int emb, long m, long M) {
  const float tp[3] = {p[0] * 6.2831855f, p[1] * 6.2831855f,
                       p[2] * 6.2831855f};
  const int nk = with_cos ? emb / 2 : emb;
  for (int k = 0; k < nk; ++k) {
    const float pr = fourier_proj(tp, B, nk, k);
    r.E[(long)k * M + m] = sinf(pr);
    if (with_cos) r.E[(long)(nk + k) * M + m] = cosf(pr);
  }
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
__host__ __device__ inline void layer_input(const Core& w, const Rows& r,
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

// Core from a host array of device pointers in flatten_core order:
// [W_i, b_i]*nb, [F_i, f_i]*nb, Wout, bout.
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

// part[split][t][j] = sum over the split's samples of X(t)[m] * Y(j)[m].
// X(t) is row t of segment 1 (t < n1) or row t-n1 of segment 2;
// x1 == nullptr stands for a single row of ones (bias grads).
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

// out[i] = sum over splits of part[split][i], in split order.
__global__ void wgrad_reduce(const float* __restrict__ part, int splits,
                             long count, float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp) acc += part[(long)sp * count + i];
  out[i] = acc;
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

// Every weight gradient of one trunk after trunk_bwd (A rows hold dL/da,
// DH rows dL/dh, G rows the output cotangent), into dw (flatten_core
// order, 4*nb+2 device pointers).  part holds splits * (emb + hid) * hid
// floats.  Returns the first CUDA error.
static int launch_core_wgrads(const Core& w, const Rows& r, long M,
                              float* part, int splits, void* const* dw,
                              cudaStream_t st) {
  const int nb = w.nb;
  for (int i = 0; i <= nb; ++i) {
    const float *x1, *x2;
    int n1, n2;
    layer_input(w, r, M, i, &x1, &n1, &x2, &n2);
    if (i == nb) {
      int rc = launch_wgrad(x1, n1, x2, n2, r.G, w.nout, M, part, splits,
                            (float*)dw[4 * nb], st);
      if (rc) return rc;
      return launch_wgrad(nullptr, 1, nullptr, 0, r.G, w.nout, M, part,
                          splits, (float*)dw[4 * nb + 1], st);
    }
    const float* DA = r.A + (long)i * w.hid * M;
    const float* DH = r.DH + (long)i * w.hid * M;
    int rc = launch_wgrad(x1, n1, x2, n2, DA, w.hid, M, part, splits,
                          (float*)dw[2 * i], st);
    if (rc) return rc;
    rc = launch_wgrad(nullptr, 1, nullptr, 0, DA, w.hid, M, part, splits,
                      (float*)dw[2 * i + 1], st);
    if (rc) return rc;
    rc = launch_wgrad(r.Cf, w.cdim, nullptr, 0, DH, w.hid, M, part, splits,
                      (float*)dw[2 * nb + 2 * i], st);
    if (rc) return rc;
    rc = launch_wgrad(nullptr, 1, nullptr, 0, DH, w.hid, M, part, splits,
                      (float*)dw[2 * nb + 2 * i + 1], st);
    if (rc) return rc;
  }
  return 0;
}
