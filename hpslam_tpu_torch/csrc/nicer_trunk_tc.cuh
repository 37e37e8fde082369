// NICER decoder trunks on Hopper's tensor cores, a tile of samples per
// block, shared by the mapping-loss backward of maploss.cu (kernel #3), the
// trunk pair of trunks.cu (kernels #4 and #5), the composite pair of
// composite.cu (kernels #6 and #7) and the tracker-loss pair of
// trackloss.cu (kernels #8 and #9).  #4 and #6 run one device function for
// their samples (tc_trunks_fwd_tile), #5 and #7 another
// (tc_trunks_bwd_tile), so that the pairs cannot drift apart.
//
// Device code for the two trunks of hpslam_tpu/ops/fused_mlp.py
// (`_trunk_fwd_block` :142, `_trunk_bwd_block` :170): the ReLU geometry
// trunk and the Softplus(beta=100) colour trunk, n_blocks x [linear -> act
// -> + c F + f] with the embedding concatenated after block `skip`, then a
// linear output layer; and the colour core's weight gradients.
//
// Design.
//   * A block of TC_THREADS threads owns a tile of TC_TM samples.  The
//     tile's activations (embedding, feature, block outputs, cotangents)
//     live in shared memory, row-major (sample, unit), rows padded so that
//     fragment loads hit 32 distinct banks.
//   * Each layer's W_i and F_i are staged in shared memory once per block
//     (cp.async, 16-byte chunks), the embedding's rows padded with zeros
//     to a multiple of 8 (the geometry embed 93 -> 96, its skip concat
//     125 -> 128).
//   * Products run as warp-level mma.sync.m16n8k8 in TF32 with f32
//     accumulation, at f32 accuracy by 3xTF32: each f32 operand x is split
//     in registers, as its fragment is loaded, into hi = tf32(x) and
//     lo = tf32(x - hi) (cvt.rna), and the product is taken as
//     lo.hi + hi.lo + hi.hi.  Warp w owns rows 16 (w % 4) .. +16 of the
//     tile and one half of the output columns (w / 4).
//   * Bias, activation and the feature injection are done on the
//     accumulators in the reference's order, (act(a) + c F) + f.
//   * The Fourier embeds stay scalar f32 in the plain version's operation
//     order (fourier_proj of nicer_trunk.cuh): proj reaches 1e3 rad.
//   * Only what a later pass reads goes to global memory, coalesced, in
//     the scratch rows of nicer_trunk.cuh (row t of a quantity holds its
//     t-th component for every sample): the pre-activations (read back
//     for the activation's derivative), the trunk output, and for the
//     weight gradients the layer inputs, dA_i, dH_i and the output
//     cotangent.  A forward that nothing reads back (kernels #4, #6)
//     stores no row at all; the trunk backwards (#5, #7) keep only those
//     rows (tc_bwd_rows).
//   * Weight gradients X^T dY over the M samples are one launch for every
//     weight of the core: 64 x 64 output tiles on the same 3xTF32 mma, the
//     samples split into fixed ranges that depend on the shape only, the
//     bias gradient (a column sum of dY) folded into the blocks of the
//     first row tile; a second launch adds the ranges in a fixed order.
//     No atomics anywhere, so a result repeats bit for bit.
#pragma once

#include <stdint.h>

#include "nicer_trunk.cuh"

#define TC_TM 64          // samples per tile
#define TC_THREADS 256    // 8 warps: 4 row groups x 2 column halves
#define TC_GLD 12         // row length of the output / cotangent tile

// ---------------------------------------------------------------------------
// 3xTF32 warp product

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += lo.hi + hi.lo + hi.hi
__device__ __forceinline__ void mma3(float d[4], const uint32_t ah[4],
                                     const uint32_t al[4],
                                     const uint32_t bh[2],
                                     const uint32_t bl[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The tensor cores add into their f32 accumulator without rounding to
// nearest, so the error grows with the number of mma into one accumulator.
// A trunk layer's output feeds the compositor, which amplifies it, so each
// k-step of 8 is summed in fresh registers (three mma) and added to the
// running sum in f32, rounded to nearest; the weight gradients do the same
// per staged chunk of WG_TK samples.

__device__ __forceinline__ void add_parts(float acc[8][4],
                                          const float sub[8][4]) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[q][i] += sub[q][i];
}

// Y(r, n) = sum_k X(r, k) B(k, n) for the tile's rows and n < N, each
// element handed to epi(r, n, value) by the thread that holds it.  X is two
// row-major segments in shared memory: k < k1 from X1 (row length ld1),
// else column k - k1 of X2 (ld2); k1 and K are multiples of 8.
// B(k, n) = Bs[k * ldb + n], or Bs[n * ldb + k] with TRANS.  Called by
// every thread of the block; warp-uniform control flow only.
template <bool TRANS, class Epi>
__device__ void tile_gemm(const float* X1, int ld1, int k1, const float* X2,
                          int ld2, int K, const float* Bs, int ldb, int N,
                          Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp & 3) * 16;
  const int half = (((N >> 3) + 1) >> 1) << 3;
  const int nb = (warp >> 2) ? half : 0, ne = (warp >> 2) ? N : half;
  for (int n0 = nb; n0 < ne; n0 += 64) {
    float acc[8][4], sub[8][4];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    for (int k = 0; k < K; k += 8) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        sub[q][0] = sub[q][1] = sub[q][2] = sub[q][3] = 0.0f;
      const float* X = k < k1 ? X1 + k : X2 + (k - k1);
      const int ld = k < k1 ? ld1 : ld2;
      uint32_t ah[4], al[4];
      split_tf32(X[(r0 + g) * ld + t], ah[0], al[0]);
      split_tf32(X[(r0 + g + 8) * ld + t], ah[1], al[1]);
      split_tf32(X[(r0 + g) * ld + t + 4], ah[2], al[2]);
      split_tf32(X[(r0 + g + 8) * ld + t + 4], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = n0 + 8 * q;
        if (n < ne) {
          float b0, b1;
          if (TRANS) {
            b0 = Bs[(n + g) * ldb + k + t];
            b1 = Bs[(n + g) * ldb + k + t + 4];
          } else {
            b0 = Bs[(k + t) * ldb + n + g];
            b1 = Bs[(k + t + 4) * ldb + n + g];
          }
          uint32_t bh[2], bl[2];
          split_tf32(b0, bh[0], bl[0]);
          split_tf32(b1, bh[1], bl[1]);
          mma3(sub[q], ah, al, bh, bl);
        }
      }
      add_parts(acc, sub);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = n0 + 8 * q + 2 * t;
      if (n0 + 8 * q < ne) {
        epi(r0 + g, c, acc[q][0]);
        epi(r0 + g, c + 1, acc[q][1]);
        epi(r0 + g + 8, c, acc[q][2]);
        epi(r0 + g + 8, c + 1, acc[q][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory layout of a tile kernel

// Offsets (in floats) of the tile buffers, sized for the widest trunk the
// kernel runs.  Row lengths: weights hid + 8, activations width + 4 (the
// bank-conflict-free strides for the fragment loads).
struct TcSmem {
  int ws, fs, es, cs, h0, h1, gs, ps, total;
};

__host__ __device__ inline int tc_round4(int x) { return (x + 3) & ~3; }

// The embedding's width padded to the mma depth.
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// Buffer sizes (floats) of one trunk: the largest layer's weight (the skip
// concat's, embedding rows padded), F, the embedding, one hidden state.
struct TcSizes {
  int ws, fs, es, h;
};

__host__ __device__ inline TcSizes tc_sizes(int embp, int hid, int C) {
  TcSizes z;
  z.ws = tc_round4((embp + hid) * (hid + 8));
  z.fs = tc_round4(C * (hid + 8));
  z.es = tc_round4(TC_TM * (embp + 4));
  z.h = tc_round4(TC_TM * (hid + 4));
  return z;
}

__host__ __device__ inline int tc_imax(int a, int b) { return a > b ? a : b; }

// The layout for the geometry trunk and, with colour, the colour trunk:
// each buffer as large as the larger trunk needs.
__host__ __device__ inline TcSmem tc_smem(int embp_g, int hid_g, int embp_c,
                                          int hid_c, int C, bool colour) {
  TcSizes z = tc_sizes(embp_g, hid_g, C);
  if (colour) {
    const TcSizes c = tc_sizes(embp_c, hid_c, C);
    z.ws = tc_imax(z.ws, c.ws);
    z.fs = tc_imax(z.fs, c.fs);
    z.es = tc_imax(z.es, c.es);
    z.h = tc_imax(z.h, c.h);
  }
  TcSmem s;
  s.ws = 0;
  s.fs = s.ws + z.ws;
  s.es = s.fs + z.fs;
  s.cs = s.es + z.es;
  s.h0 = s.cs + tc_round4(TC_TM * (C + 4));
  s.h1 = s.h0 + z.h;
  s.gs = s.h1 + z.h;
  s.ps = s.gs + TC_TM * TC_GLD;
  s.total = s.ps + TC_TM * 4;
  return s;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Stage one layer's weight (row-major, N columns) into Ws (row length
// ldw, Np >= N columns, zero beyond N).  With has_e the first emb rows are
// the embedding's, padded with zero rows to embp, then nh further rows;
// without, nh rows.  The caller waits (cp_async_wait_all) and syncs.
__device__ void stage_weight(float* Ws, int ldw, const float* W, int N,
                             int Np, bool has_e, int emb, int embp, int nh) {
  const int e_rows = has_e ? embp : 0;
  const int R = e_rows + nh;
  const bool vec = (N % 4 == 0) && ((((uintptr_t)W) & 15) == 0);
  const int cw = vec ? Np / 4 : Np;    // chunks per row
  for (int e = threadIdx.x; e < R * cw; e += blockDim.x) {
    const int r = e / cw, c = (e % cw) * (vec ? 4 : 1);
    int src = r;
    if (has_e) src = r < emb ? r : (r < embp ? -1 : emb + (r - embp));
    float* dst = Ws + r * ldw + c;
    if (vec && src >= 0 && c < N) {
      cp_async16(dst, W + (long)src * N + c);
    } else if (vec) {
      dst[0] = dst[1] = dst[2] = dst[3] = 0.0f;
    } else {
      *dst = (src >= 0 && c < N) ? W[(long)src * N + c] : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// Tile inputs

// Es = the Fourier embedding of the tile's samples at the points P (TC_TM x
// 3 in shared memory): sin(proj) (geometry, B has emb columns) or
// [sin(proj) | cos(proj)] (colour, emb/2 columns), zero beyond emb; and, if
// Eg is given, the rows of the global E table for samples < M.
__device__ void tile_embed(const float* P, const float* B, bool with_cos,
                           int emb, int embp, float* Es, float* Eg, long m0,
                           long M) {
  const int lde = embp + 4;
  const int nk = with_cos ? emb / 2 : emb;
  for (int e = threadIdx.x; e < TC_TM * embp; e += blockDim.x) {
    const int k = e / TC_TM, r = e % TC_TM;
    float v = 0.0f;
    if (k < emb) {
      const int kk = k < nk ? k : k - nk;
      const float tp[3] = {P[3 * r] * 6.2831855f, P[3 * r + 1] * 6.2831855f,
                           P[3 * r + 2] * 6.2831855f};
      const float pr = fourier_proj(tp, B, nk, kk);
      v = k < nk ? sinf(pr) : cosf(pr);
      if (Eg && m0 + r < M) Eg[(long)k * M + m0 + r] = v;
    }
    Es[r * lde + k] = v;
  }
}

// dp(r) += (dproj . B^T) for the tile's samples r (threads r < TC_TM), from
// the embedding cotangent DEs, with dproj = cos(proj) d_sin (- sin(proj)
// d_cos); the caller scales by 2 pi.
__device__ void tile_embed_bwd(const float* P, const float* B, bool with_cos,
                               int emb, int embp, const float* DEs,
                               float dp[3]) {
  const int r = threadIdx.x;
  const int lde = embp + 4;
  const int nk = with_cos ? emb / 2 : emb;
  const float tp[3] = {P[3 * r] * 6.2831855f, P[3 * r + 1] * 6.2831855f,
                       P[3 * r + 2] * 6.2831855f};
  for (int k = 0; k < nk; ++k) {
    const float pr = fourier_proj(tp, B, nk, k);
    float dpr = cosf(pr) * DEs[r * lde + k];
    if (with_cos) dpr -= sinf(pr) * DEs[r * lde + nk + k];
    dp[0] = fmaf(dpr, B[k], dp[0]);
    dp[1] = fmaf(dpr, B[nk + k], dp[1]);
    dp[2] = fmaf(dpr, B[2 * nk + k], dp[2]);
  }
}

// Copy a tile buffer (row length ld, n columns) to rows of a global table
// (row c at G + c * M), samples < M only; coalesced along the samples.
__device__ void tile_to_rows(const float* S, int ld, int n, float* G,
                             long m0, long M) {
  for (int e = threadIdx.x; e < TC_TM * n; e += blockDim.x) {
    const int c = e / TC_TM, r = e % TC_TM;
    if (m0 + r < M) G[(long)c * M + m0 + r] = S[r * ld + c];
  }
}

// Gs (TC_TM x 8, zero beyond nout) from nout rows of a table.
__device__ void tile_rows_to_g(const float* G, int nout, float* Gs, long m0,
                               long M) {
  for (int e = threadIdx.x; e < TC_TM * 8; e += blockDim.x) {
    const int c = e / TC_TM, r = e % TC_TM;
    Gs[r * TC_GLD + c] =
        (c < nout && m0 + r < M) ? G[(long)c * M + m0 + r] : 0.0f;
  }
}

// Cs (TC_TM x C) from a sample-major (n, C) feature and, if Cg is given,
// the feature rows.
__device__ void tile_feat(const float* __restrict__ c, int C, float* Cs,
                          float* Cg, long m0, long M) {
  for (int e = threadIdx.x; e < TC_TM * C; e += blockDim.x) {
    const int r = e / C, ch = e % C;
    const long m = m0 + r;
    float v = 0.0f;
    if (m < M) {
      v = c[m * C + ch];
      if (Cg) Cg[(long)ch * M + m] = v;
    }
    Cs[r * (C + 4) + ch] = v;
  }
}

// ---------------------------------------------------------------------------
// Trunk forward and backward on a tile

struct TcTile {
  float *Ws, *Fs, *Es, *Cs, *H[2], *Gs, *Ps;
};

__device__ inline TcTile tc_tile(float* base, const TcSmem& s) {
  TcTile t;
  t.Ws = base + s.ws;
  t.Fs = base + s.fs;
  t.Es = base + s.es;
  t.Cs = base + s.cs;
  t.H[0] = base + s.h0;
  t.H[1] = base + s.h1;
  t.Gs = base + s.gs;
  t.Ps = base + s.ps;
  return t;
}

// Stage W_i (or Wout for i == nb) and, for i < nb, F_i; waits and syncs.
__device__ void stage_layer(const Core& w, const TcTile& T, int i,
                            int embp) {
  const bool has_e = (i == 0) || (i == w.skip + 1);
  const int nh = (i == 0) ? 0 : w.hid;
  if (i < w.nb) {
    stage_weight(T.Ws, w.hid + 8, w.W[i], w.hid, w.hid, has_e, w.emb, embp,
                 nh);
    stage_weight(T.Fs, w.hid + 8, w.F[i], w.hid, w.hid, false, 0, 0,
                 w.cdim);
  } else {
    stage_weight(T.Ws, 8, w.Wout, w.nout, 8, has_e, w.emb, embp, w.hid);
  }
  cp_async_wait_all();
  __syncthreads();
}

// Forward of one trunk on the tile.  Es (embedding, zero-padded to embp)
// and Cs (feature) hold the tile's inputs.  Writes the pre-activations to
// the A rows (if rw.A); with save_h the block outputs to the H rows; with
// out the output to Gs and (if rw.G) to the G rows.  Returns the buffer
// index of the last hidden state.
__device__ int tc_trunk_fwd(const Core& w, const Rows& rw, int code,
                            const TcTile& T, int embp, long m0, long M,
                            bool save_h, bool out) {
  const int hid = w.hid, ldh = hid + 4, lde = embp + 4, ldc = w.cdim + 4;
  const int ldw = hid + 8;
  int cur = 0;
  for (int i = 0; i < w.nb; ++i) {
    stage_layer(w, T, i, embp);
    float* Ho = T.H[cur ^ 1];
    const float* bias = w.b[i];
    const float* fb = w.f[i];
    auto store_a = [&](int r, int c, float v) {
      Ho[r * ldh + c] = v + __ldg(bias + c);
    };
    if (i == 0)
      tile_gemm<false>(T.Es, lde, embp, T.Es, lde, embp, T.Ws, ldw, hid,
                       store_a);
    else if (i == w.skip + 1)
      tile_gemm<false>(T.Es, lde, embp, T.H[cur], ldh, embp + hid, T.Ws,
                       ldw, hid, store_a);
    else
      tile_gemm<false>(nullptr, 0, 0, T.H[cur], ldh, hid, T.Ws, ldw, hid,
                       store_a);
    __syncthreads();
    // pre-activations to the A rows; act(a) in place
    float* Ag = rw.A ? rw.A + (long)i * hid * M : nullptr;
    for (int e = threadIdx.x; e < TC_TM * hid; e += blockDim.x) {
      const int c = e / TC_TM, r = e % TC_TM;
      const float a = Ho[r * ldh + c];
      if (Ag && m0 + r < M) Ag[(long)c * M + m0 + r] = a;
      Ho[r * ldh + c] = act_f(code, a);
    }
    __syncthreads();
    // h = (act(a) + c F) + f
    tile_gemm<false>(nullptr, 0, 0, T.Cs, ldc, w.cdim, T.Fs, ldw, hid,
                     [&](int r, int c, float v) {
                       Ho[r * ldh + c] = (Ho[r * ldh + c] + v)
                                         + __ldg(fb + c);
                     });
    __syncthreads();
    if (save_h) tile_to_rows(Ho, ldh, hid, rw.H + (long)i * hid * M, m0, M);
    cur ^= 1;
  }
  if (!out) return cur;
  stage_layer(w, T, w.nb, embp);
  const float* bo = w.bout;
  const int nout = w.nout;
  auto store_g = [&](int r, int c, float v) {
    if (c < nout) T.Gs[r * TC_GLD + c] = v + __ldg(bo + c);
  };
  if (w.skip == w.nb - 1)
    tile_gemm<false>(T.Es, lde, embp, T.H[cur], ldh, embp + hid, T.Ws, 8, 8,
                     store_g);
  else
    tile_gemm<false>(nullptr, 0, 0, T.H[cur], ldh, hid, T.Ws, 8, 8, store_g);
  __syncthreads();
  if (rw.G) tile_to_rows(T.Gs, TC_GLD, nout, rw.G, m0, M);
  return cur;
}

// Backward of one trunk on the tile.  Gs holds the output cotangent (zero
// beyond nout), the A rows the pre-activations.  Leaves dL/dc in Cs and,
// with need_de, dL/de in Es (the skip concat's part first, then the first
// block's input: the reference's order).  With wgrads, dL/da_i replaces the
// pre-activations in the A rows and dL/dh_i goes to the DH rows.
__device__ void tc_trunk_bwd(const Core& w, const Rows& rw, int code,
                             const TcTile& T, int embp, long m0, long M,
                             bool need_de, bool wgrads) {
  const int hid = w.hid, ldh = hid + 4, lde = embp + 4, ldc = w.cdim + 4;
  const int ldw = hid + 8, L = w.nb - 1;
  for (int e = threadIdx.x; e < TC_TM * ldc; e += blockDim.x) T.Cs[e] = 0.0f;
  if (need_de)
    for (int e = threadIdx.x; e < TC_TM * lde; e += blockDim.x)
      T.Es[e] = 0.0f;
  stage_layer(w, T, w.nb, embp);      // Wout (and the syncs for the zeroing)
  int cur = 0;
  {
    float* D = T.H[cur];
    const int s0 = (w.skip == L) ? embp : 0;
    tile_gemm<true>(nullptr, 0, 0, T.Gs, TC_GLD, 8, T.Ws + s0 * 8, 8, hid,
                    [&](int r, int c, float v) { D[r * ldh + c] = v; });
    if (need_de && s0 > 0)
      tile_gemm<true>(nullptr, 0, 0, T.Gs, TC_GLD, 8, T.Ws, 8, embp,
                      [&](int r, int c, float v) {
                        T.Es[r * lde + c] += v;
                      });
    __syncthreads();
    if (wgrads) tile_to_rows(D, ldh, hid, rw.DH + (long)L * hid * M, m0, M);
  }
  for (int i = L; i >= 0; --i) {
    __syncthreads();                  // Ws, Fs free
    stage_layer(w, T, i, embp);
    float* D = T.H[cur];
    // dc += dh_i F_i^T
    tile_gemm<true>(nullptr, 0, 0, D, ldh, hid, T.Fs, ldw, w.cdim,
                    [&](int r, int c, float v) { T.Cs[r * ldc + c] += v; });
    __syncthreads();
    // da_i = dh_i act'(a_i)
    float* Ag = rw.A + (long)i * hid * M;
    for (int e = threadIdx.x; e < TC_TM * hid; e += blockDim.x) {
      const int c = e / TC_TM, r = e % TC_TM;
      const bool in = m0 + r < M;
      const float a = in ? Ag[(long)c * M + m0 + r] : 0.0f;
      const float da = in ? D[r * ldh + c] * dact_f(code, a) : 0.0f;
      D[r * ldh + c] = da;
      if (wgrads && in) Ag[(long)c * M + m0 + r] = da;
    }
    __syncthreads();
    const int s0 = (i == w.skip + 1) ? embp : 0;
    if (i > 0) {
      float* Dn = T.H[cur ^ 1];
      tile_gemm<true>(nullptr, 0, 0, D, ldh, hid, T.Ws + s0 * ldw, ldw, hid,
                      [&](int r, int c, float v) { Dn[r * ldh + c] = v; });
    }
    if (need_de && (i == 0 || s0 > 0))
      tile_gemm<true>(nullptr, 0, 0, D, ldh, hid, T.Ws, ldw, embp,
                      [&](int r, int c, float v) {
                        T.Es[r * lde + c] += v;
                      });
    __syncthreads();
    if (i > 0) {
      cur ^= 1;
      if (wgrads)
        tile_to_rows(T.H[cur], ldh, hid, rw.DH + (long)(i - 1) * hid * M, m0,
                     M);
    }
  }
  __syncthreads();
}

// Both trunk forwards on the tile of samples m0 .. m0 + TC_TM (kernels #4
// and #6): the Fourier embeds, the ReLU geometry trunk and, with colour,
// the Softplus(beta=100) colour trunk.  occ (M,) and rgb (M, 3) go straight
// from the output tile, no scratch rows: rgb is zero without colour, and
// sigmoid(rgb) with sigmoid_rgb.  p (M, 3), cg / cc (M, C) sample-major.
__device__ void tc_trunks_fwd_tile(
    const float* __restrict__ p, const float* __restrict__ cg,
    const float* __restrict__ cc, const float* __restrict__ Bg,
    const float* __restrict__ Bc, const Core& gw, const Core& cw, int C,
    bool with_color, bool sigmoid_rgb, const TcTile& T, long m0, long M,
    float* __restrict__ occ, float* __restrict__ rgb) {
  const Rows none = {};
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x)
    T.Ps[e] = m0 + e / 3 < M ? p[3 * m0 + e] : 0.0f;
  tile_feat(cg, C, T.Cs, nullptr, m0, M);
  __syncthreads();
  const int embp_g = round8(gw.emb);
  tile_embed(T.Ps, Bg, false, gw.emb, embp_g, T.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, none, 0, T, embp_g, m0, M, false, true);
  for (int r = threadIdx.x; r < TC_TM; r += blockDim.x)
    if (m0 + r < M) occ[m0 + r] = T.Gs[r * TC_GLD];
  if (with_color) {
    // Cs, Es and Gs are rewritten only after the syncs that follow
    // (tc_trunk_fwd's layer staging), so the occ reads above are done
    tile_feat(cc, C, T.Cs, nullptr, m0, M);
    const int embp_c = round8(cw.emb);
    tile_embed(T.Ps, Bc, true, cw.emb, embp_c, T.Es, nullptr, m0, M);
    __syncthreads();
    tc_trunk_fwd(cw, none, 1, T, embp_c, m0, M, false, true);
  }
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x) {
    const int r = e / 3, c = e % 3;
    if (m0 + r < M) {
      const float v = with_color ? T.Gs[r * TC_GLD + c] : 0.0f;
      rgb[3 * (m0 + r) + c] = with_color && sigmoid_rgb ? sigm(v) : v;
    }
  }
}

// Gs (TC_TM x 8, zero beyond nout) from a sample-major (n, nout) cotangent
// and, if Gg is given, the G rows.
__device__ void tile_cot(const float* __restrict__ g, int nout, float* Gs,
                         float* Gg, long m0, long M) {
  for (int e = threadIdx.x; e < TC_TM * 8; e += blockDim.x) {
    const int r = e / 8, c = e % 8;
    const long m = m0 + r;
    float v = 0.0f;
    if (c < nout && m < M) {
      v = g[m * nout + c];
      if (Gg) Gg[(long)c * M + m] = v;
    }
    Gs[r * TC_GLD + c] = v;
  }
}

// (n, C) rows of a sample-major output from Cs (zero if Cs is null).
__device__ void tile_feat_out(const float* Cs, int C, float* out, long m0,
                              long M) {
  for (int e = threadIdx.x; e < TC_TM * C; e += blockDim.x) {
    const int r = e / C, ch = e % C;
    if (m0 + r < M) out[(m0 + r) * C + ch] = Cs ? Cs[r * (C + 4) + ch] : 0.0f;
  }
}

// Both trunk backwards on the tile of samples m0 .. m0 + TC_TM (kernels #5
// and #7): the forward recomputed in the tile (the pre-activations to the A
// rows), the output cotangents g_occ (M,) and g_rgb (M, 3), then
// tc_trunk_bwd for each trunk -> dcg, dcc (M, C), dcc zero without colour;
// with need_dp the cotangent of the points p through the embeds into dp
// (M, 3), zero without; dp may be null when need_dp is false.  With wg the
// colour trunk's rows for the weight gradients (E, Cf, H, DH, G, and dL/da
// over the A rows).
__device__ void tc_trunks_bwd_tile(
    const float* __restrict__ p, const float* __restrict__ cg,
    const float* __restrict__ cc, const float* __restrict__ Bg,
    const float* __restrict__ Bc, const Core& gw, const Core& cw,
    const Rows& rg, const Rows& rc, int C, bool with_color, bool need_dp,
    bool wg, const float* __restrict__ g_occ,
    const float* __restrict__ g_rgb, const TcTile& T, long m0, long M,
    float* __restrict__ dp, float* __restrict__ dcg,
    float* __restrict__ dcc) {
  for (int e = threadIdx.x; e < TC_TM * 3; e += blockDim.x)
    T.Ps[e] = m0 + e / 3 < M ? p[3 * m0 + e] : 0.0f;
  tile_feat(cg, C, T.Cs, nullptr, m0, M);
  __syncthreads();
  const int embp_g = round8(gw.emb);
  tile_embed(T.Ps, Bg, false, gw.emb, embp_g, T.Es, nullptr, m0, M);
  __syncthreads();
  tc_trunk_fwd(gw, rg, 0, T, embp_g, m0, M, false, false);
  tile_cot(g_occ, 1, T.Gs, nullptr, m0, M);
  tc_trunk_bwd(gw, rg, 0, T, embp_g, m0, M, need_dp, false);
  tile_feat_out(T.Cs, C, dcg, m0, M);
  float dpg[3] = {0.0f, 0.0f, 0.0f}, dpc[3] = {0.0f, 0.0f, 0.0f};
  if (need_dp && threadIdx.x < TC_TM)
    tile_embed_bwd(T.Ps, Bg, false, gw.emb, embp_g, T.Es, dpg);
  __syncthreads();
  if (with_color) {
    const int embp_c = round8(cw.emb);
    tile_feat(cc, C, T.Cs, wg ? rc.Cf : nullptr, m0, M);
    tile_embed(T.Ps, Bc, true, cw.emb, embp_c, T.Es, wg ? rc.E : nullptr,
               m0, M);
    __syncthreads();
    tc_trunk_fwd(cw, rc, 1, T, embp_c, m0, M, wg, false);
    tile_cot(g_rgb, 3, T.Gs, wg ? rc.G : nullptr, m0, M);
    tc_trunk_bwd(cw, rc, 1, T, embp_c, m0, M, need_dp, wg);
    tile_feat_out(T.Cs, C, dcc, m0, M);
    if (need_dp && threadIdx.x < TC_TM)
      tile_embed_bwd(T.Ps, Bc, true, cw.emb, embp_c, T.Es, dpc);
  } else {
    tile_feat_out(nullptr, C, dcc, m0, M);
  }
  if (!dp) return;
  const long m = m0 + threadIdx.x;
  if (threadIdx.x < TC_TM && m < M)
    for (int d = 0; d < 3; ++d)
      dp[3 * m + d] = 6.2831855f * dpg[d] + 6.2831855f * dpc[d];
}

// Scratch of tc_trunks_bwd_tile: rows of M floats (row t of a quantity
// holds its t-th component for every sample) for what a later step reads
// back: both trunks' pre-activations (read by tc_trunk_bwd) and, with
// wgrads, the colour trunk's rows that its weight gradients read (the
// embedding, the feature, the block outputs, dL/dh and the output
// cotangent).  Nothing else of the Rows layout is written.
static long tc_bwd_rows(int emb_c, int hid_g, int hid_c, int C, int nb,
                        bool with_color, bool wgrads) {
  long rows = (long)nb * hid_g;
  if (with_color) {
    rows += (long)nb * hid_c;
    if (wgrads) rows += (long)emb_c + C + 2L * nb * hid_c + 3;
  }
  return rows;
}

// The two trunks' Rows over that scratch (unused rows null).
static void tc_bwd_layout(float* s, long M, int emb_c, int hid_g, int hid_c,
                          int C, int nb, bool with_color, bool wgrads,
                          Rows* rg, Rows* rc) {
  const Rows none = {};
  *rg = none;
  *rc = none;
  rg->A = s;
  s += (long)nb * hid_g * M;
  if (!with_color) return;
  rc->A = s;
  s += (long)nb * hid_c * M;
  if (!wgrads) return;
  rc->E = s;
  rc->Cf = rc->E + (long)emb_c * M;
  rc->H = rc->Cf + (long)C * M;
  rc->DH = rc->H + (long)nb * hid_c * M;
  rc->G = rc->DH + (long)nb * hid_c * M;
}

// Dynamic shared memory (bytes) of a tile kernel that runs the geometry
// trunk and, with colour, the colour trunk (#4-7): the layout in sm.
static int tc_trunks_smem(int C, int emb_g, int hid_g, int emb_c, int hid_c,
                          int with_color, TcSmem* sm) {
  *sm = tc_smem(round8(emb_g), hid_g, round8(emb_c), hid_c, C,
                with_color != 0);
  return sm->total * (int)sizeof(float);
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <class K>
static int tc_smem_attr(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// Weight gradients on tensor cores

#define WG_TT 64     // rows of X^T per block tile
#define WG_TJ 64     // columns of dY per block tile
#define WG_TK 32     // samples per staged chunk

// One product dW = X^T Y (nt x nj), db = 1^T Y over the M samples.  X(t) is
// row t of segment 1 (t < n1) or row t - n1 of segment 2.
struct WgProd {
  const float* x1;
  const float* x2;
  const float* y;
  float* dw;
  float* db;
  long off;          // offset of dw (then db) in one range's partials
  int n1, n2, nj, tiles_j, tile0;
};

struct WgTable {
  WgProd p[2 * HP_MAXB + 1];
  long total;        // floats of one range's partials
  int np;
};

__global__ void __launch_bounds__(128)
    wg_tc_partial(WgTable tb, long M, int m_per_split, float* part) {
  __shared__ float xs[WG_TT][WG_TK + 4];
  __shared__ float ys[WG_TJ][WG_TK + 4];
  __shared__ float bs[WG_TJ];
  int pi = 0;
  while (pi + 1 < tb.np && (int)blockIdx.x >= tb.p[pi + 1].tile0) ++pi;
  const WgProd P = tb.p[pi];
  const int nt = P.n1 + P.n2;
  const int local = blockIdx.x - P.tile0;
  const int tt = local / P.tiles_j, tj = local % P.tiles_j;
  const int t0 = tt * WG_TT, j0 = tj * WG_TJ;
  const long mb = (long)blockIdx.y * m_per_split;
  const long me = mb + m_per_split < M ? mb + m_per_split : M;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  float bsum = 0.0f, sub[8][4];
  for (long mm = mb; mm < me; mm += WG_TK) {
    for (int e = threadIdx.x; e < WG_TT * WG_TK; e += blockDim.x) {
      const int rr = e / WG_TK, cc = e % WG_TK;
      const long mi = mm + cc;
      const int tx = t0 + rr, jy = j0 + rr;
      float xv = 0.0f, yv = 0.0f;
      if (mi < me) {
        if (tx < nt)
          xv = tx < P.n1 ? P.x1[(long)tx * M + mi]
                         : P.x2[(long)(tx - P.n1) * M + mi];
        if (jy < P.nj) yv = P.y[(long)jy * M + mi];
      }
      xs[rr][cc] = xv;
      ys[rr][cc] = yv;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 8; ++q)
      sub[q][0] = sub[q][1] = sub[q][2] = sub[q][3] = 0.0f;
#pragma unroll
    for (int k = 0; k < WG_TK; k += 8) {
      uint32_t ah[4], al[4];
      const int r = warp * 16 + g;
      split_tf32(xs[r][k + t], ah[0], al[0]);
      split_tf32(xs[r + 8][k + t], ah[1], al[1]);
      split_tf32(xs[r][k + t + 4], ah[2], al[2]);
      split_tf32(xs[r + 8][k + t + 4], ah[3], al[3]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t bh[2], bl[2];
        split_tf32(ys[8 * q + g][k + t], bh[0], bl[0]);
        split_tf32(ys[8 * q + g][k + t + 4], bh[1], bl[1]);
        mma3(sub[q], ah, al, bh, bl);
      }
    }
    add_parts(acc, sub);
    // bias: thread (h, j) adds half h of the chunk's column j
    if (tt == 0) {
      const int j = threadIdx.x % WG_TJ, h = threadIdx.x / WG_TJ;
      for (int c = h * (WG_TK / 2); c < (h + 1) * (WG_TK / 2); ++c)
        bsum += ys[j][c];
    }
    __syncthreads();
  }
  float* out = part + (long)blockIdx.y * tb.total + P.off;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = j0 + 8 * q + 2 * t;
    const int ta = t0 + warp * 16 + g, tb8 = ta + 8;
    if (ta < nt && j < P.nj) out[(long)ta * P.nj + j] = acc[q][0];
    if (ta < nt && j + 1 < P.nj) out[(long)ta * P.nj + j + 1] = acc[q][1];
    if (tb8 < nt && j < P.nj) out[(long)tb8 * P.nj + j] = acc[q][2];
    if (tb8 < nt && j + 1 < P.nj) out[(long)tb8 * P.nj + j + 1] = acc[q][3];
  }
  if (tt == 0) {
    if (threadIdx.x >= WG_TJ) bs[threadIdx.x - WG_TJ] = bsum;
    __syncthreads();
    if (threadIdx.x < WG_TJ && j0 + (int)threadIdx.x < P.nj)
      out[(long)nt * P.nj + j0 + threadIdx.x] = bsum + bs[threadIdx.x];
  }
}

// Each weight and bias element = the sum of its ranges' partials, in range
// order.
__global__ void wg_tc_reduce(WgTable tb, int splits,
                             const float* __restrict__ part) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tb.total) return;
  int pi = 0;
  while (pi + 1 < tb.np && e >= tb.p[pi + 1].off) ++pi;
  const WgProd& P = tb.p[pi];
  float acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp) acc += part[(long)sp * tb.total + e];
  const long local = e - P.off;
  const long nw = (long)(P.n1 + P.n2) * P.nj;
  if (local < nw) P.dw[local] = acc;
  else P.db[local - nw] = acc;
}

// Every weight gradient of one trunk after tc_trunk_bwd with wgrads (A rows
// hold dL/da, DH rows dL/dh, G rows the output cotangent, E / Cf / H rows
// the forward's), into dw (flatten_core order, 4*nb+2 device pointers).
// part holds splits times the core's element count (every weight and
// bias).  Two launches.
static int launch_core_wgrads_tc(const Core& w, const Rows& r, long M,
                                 float* part, int splits, void* const* dw,
                                 cudaStream_t st) {
  WgTable tb;
  const int nb = w.nb;
  int np = 0, tiles = 0;
  long off = 0;
  // i < 0: the feature injection, whose input is the feature rows
  auto add = [&](int i, const float* y, int nj, float* d, float* db) {
    WgProd& P = tb.p[np++];
    const float *x1 = r.Cf, *x2 = nullptr;
    int n1 = w.cdim, n2 = 0;
    if (i >= 0) layer_input(w, r, M, i, &x1, &n1, &x2, &n2);
    P.x1 = x1; P.x2 = x2; P.n1 = n1; P.n2 = n2;
    P.y = y; P.nj = nj; P.dw = d; P.db = db; P.off = off;
    P.tiles_j = (nj + WG_TJ - 1) / WG_TJ;
    P.tile0 = tiles;
    tiles += ((n1 + n2 + WG_TT - 1) / WG_TT) * P.tiles_j;
    off += (long)(n1 + n2 + 1) * nj;
  };
  for (int i = 0; i < nb; ++i) {
    add(i, r.A + (long)i * w.hid * M, w.hid, (float*)dw[2 * i],
        (float*)dw[2 * i + 1]);
    add(-1, r.DH + (long)i * w.hid * M, w.hid, (float*)dw[2 * nb + 2 * i],
        (float*)dw[2 * nb + 2 * i + 1]);
  }
  add(nb, r.G, w.nout, (float*)dw[4 * nb], (float*)dw[4 * nb + 1]);
  tb.np = np;
  tb.total = off;
  const int m_per_split = (int)((M + splits - 1) / splits);
  wg_tc_partial<<<dim3(tiles, splits), 128, 0, st>>>(tb, M, m_per_split,
                                                     part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wg_tc_reduce<<<(unsigned)((off + 255) / 256), 256, 0, st>>>(tb, splits,
                                                              part);
  return (int)cudaGetLastError();
}
