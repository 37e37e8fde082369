// NICER decoder trunks: the structs, the scratch row layout, the
// activations and the Fourier projection that the tensor-core tiles of
// nicer_trunk_tc.cuh are built on.  All nine kernels run their trunks on
// those tiles; nothing here computes a trunk itself.
//
// Device code for the two trunks of hpslam_tpu/ops/fused_mlp.py
// (`_trunk_fwd_block` :142, `_embed_geo` / `_embed_col` :204-218): the
// ReLU geometry trunk and the Softplus(beta=100) colour trunk, each
// n_blocks x [linear -> act -> + c F + f] with the embedding concatenated
// after block `skip`, then a linear output layer.
//
// Layout.  An intermediate that a later pass reads back lives in a scratch
// table of rows of length M (the number of samples): row t of a quantity
// holds its t-th component for every sample, so a warp's 32 samples touch
// 32 consecutive floats.  Each kernel lays out only the rows it reads back
// (Rows, unused rows null).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define HP_MAXB 8    // most trunk blocks supported
#define HP_MAXS 16   // most samples per ray supported

struct Core {
  const float* W[HP_MAXB];
  const float* b[HP_MAXB];
  const float* F[HP_MAXB];
  const float* f[HP_MAXB];
  const float* Wout;
  const float* bout;
  int nb, skip, emb, hid, cdim, nout;
};

// One trunk's rows in a kernel's scratch table (each row holds M floats;
// null where the kernel keeps none).
struct Rows {
  float* E;    // emb rows: Fourier embedding
  float* Cf;   // cdim rows: interpolated feature
  float* A;    // nb*hid rows: pre-activations, then their cotangents
  float* H;    // nb*hid rows: block outputs
  float* DH;   // nb*hid rows: cotangents of the block outputs
  float* G;    // nout rows: trunk output, then its cotangent
  float* DC;   // cdim rows: cotangent of the feature
};

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
