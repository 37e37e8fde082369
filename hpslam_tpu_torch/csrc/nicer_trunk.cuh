// NICER decoder trunks, one sample per thread: the trunk forward of the
// one kernel not yet on the tensor-core tiles of nicer_trunk_tc.cuh, the
// mapping-loss forward of maploss.cu (kernel #2).  The structs, the scratch
// row layout, the activations and the Fourier projection here are shared
// by the tile code too.
//
// Device code for the two trunks of hpslam_tpu/ops/fused_mlp.py
// (`_trunk_fwd_block` :140, `_embed_geo` / `_embed_col` :203-217): the
// ReLU geometry trunk and the Softplus(beta=100) colour trunk, each
// n_blocks x [linear -> act -> + c F + f] with the embedding concatenated
// after block `skip`, then a linear output layer.
//
// Layout.  Every intermediate of a sample lives in a scratch table of rows
// of length M (the number of samples): row t of a quantity holds its t-th
// component for every sample, so a warp's 32 samples touch 32 consecutive
// floats.  Weights are read from global memory (L2): the 128-wide colour
// core does not fit one block's shared memory whole, and every thread of a
// warp reads the same weight at the same time, so each read is one
// broadcast transaction.  Hidden widths are walked by loops that are not
// unrolled; only the 16-wide accumulator chunk is.
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
