// Exact ascending row top-k with first-occurrence ties, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_topk_rows_kernel` / `_pl_topk`
// (hpslam_tpu/ops/knn.py:235,281).  Semantics, pass for pass:
//   m = min(row); first = min{c : row[c] <= m}; emit (m, payload[first] or
//   (float)first); row[first] = BIG.
// The emitted values are copies of existing floats, so the result equals
// the plain PyTorch version (hpslam_tpu_torch/ops/knn.py topk_rows_plain)
// bit for bit.
//
// Design: one warp per row.  The row is staged once in shared memory (the
// k passes mutate it), each lane scans a strided slice keeping the first
// minimum it sees, and a butterfly shuffle reduction on (value, column)
// picks the global first minimum.  No block-wide barrier is used, so a
// warp whose row is out of range simply returns.
//
// Bound on the card: bytes.  Each row is read once (C floats, plus C payload
// floats) and k pairs are written; the k selection passes run in shared
// memory.  A faster version (several rows per warp in registers, a single
// pass keeping a sorted k-list per lane) is later work.
#include <cuda_runtime.h>
#include <math.h>

#define HP_TOPK_BIG 1e10f

__global__ void topk_rows_kernel(const float* __restrict__ x,
                                 const float* __restrict__ payload,
                                 int n, int C, int k,
                                 float* __restrict__ out_d,
                                 float* __restrict__ out_v) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * warps + w;
  if (row >= n) return;
  float* buf = smem + (long)w * C;
  const float* xr = x + row * (long)C;
  for (int c = lane; c < C; c += 32) buf[c] = xr[c];
  __syncwarp();
  for (int p = 0; p < k; ++p) {
    float bv = INFINITY;
    int bi = C;
    for (int c = lane; c < C; c += 32) {
      const float v = buf[c];
      if (v < bv || (v == bv && c < bi)) {
        bv = v;
        bi = c;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      out_d[row * k + p] = bv;
      float sel = 0.0f;
      if (bi < C) sel = payload ? payload[row * (long)C + bi] : (float)bi;
      out_v[row * k + p] = sel;
    }
    if (bi < C && (bi & 31) == lane) buf[bi] = HP_TOPK_BIG;
    __syncwarp();
  }
}

// C entry point (bound with ctypes).  payload may be null: the selected
// column indices are returned as float values instead.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int hp_topk_rows(const float* x, const float* payload, int n,
                            int C, int k, float* out_d, float* out_v,
                            void* stream) {
  if (n <= 0) return 0;
  const long row_bytes = (long)C * (long)sizeof(float);
  int warps = (int)((48L * 1024L) / row_bytes);
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const size_t smem = (size_t)warps * (size_t)row_bytes;
  if (smem > 48u * 1024u) {
    cudaError_t e = cudaFuncSetAttribute(
        topk_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + warps - 1) / warps;
  topk_rows_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      x, payload, n, C, k, out_d, out_v);
  return (int)cudaGetLastError();
}
