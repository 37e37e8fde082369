// Exact ascending row top-k with first-occurrence ties, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_topk_rows_kernel` / `_pl_topk`
// (hpslam_tpu/ops/knn.py:235,281).  Semantics, pass for pass:
//   m = min(row); first = min{c : row[c] <= m}; emit (m, payload[first] or
//   (float)first); row[first] = BIG.
// The emitted values are copies of existing floats, so the result equals
// the plain PyTorch version (hpslam_tpu_torch/ops/knn.py topk_rows_plain)
// bit for bit.  Rows hold no NaN (they are distances and scores).
//
// What the k passes pick.  A pick is overwritten with BIG, not removed, so
// a row with fewer than k entries below BIG picks a column again.  Let L be
// the row's entries below BIG in (value, column) order, and j = |L|:
//   * picks 1 .. min(j, k) are L's first entries;
//   * if 1 <= j < k, picks j+1 .. k are (BIG, c*), c* = min{c : row[c] <=
//     BIG}: the smallest of L's columns and of the columns exactly BIG;
//   * if j = 0, pick 1 is the row's first-occurrence minimum (m, c0) and
//     picks 2 .. k are (BIG, c0): m is BIG if the row holds BIG, and c0 is
//     then its first column exactly BIG.
//
// Bound on the card: bytes.  Each row is read once (C floats), the k
// chosen payload values are read, and k pairs are written.
//
// topk_rows_lists (k <= 32, every path): one streaming pass.
//   * A group of G lanes takes a row: G = 32, or 4, 8 or 16 for rows of at
//     most 128 columns, so that a warp holds several narrow rows and
//     width-limited shuffles keep its lanes busy.  Lane l reads 4-column
//     chunks l, l + G, ... in increasing order, with one 16-byte load each
//     where C % 4 == 0 and the row is aligned, column by column otherwise,
//     in batches of 16 entries (for K <= 2 the next batch's loads are in
//     flight while a batch is seen).  No shared memory: the occupancy is
//     set by registers.
//   * Each lane keeps in registers a sorted list of the K >= k smallest
//     (value, column) pairs below BIG that it has seen (K a power of two).
//     It inserts with a strict <, so an equal value keeps its first column
//     ahead; an entry not below the list's tail costs one compare.  Until
//     it meets its first entry <= BIG it also keeps the first-occurrence
//     minimum above BIG, which the rule above needs.
//   * The lanes of a warp insert at different times, and a warp executes
//     an insertion whenever one lane does, so for wide rows (G = 32, K >=
//     4) an entry enters a list only if it is not above T: before each
//     batch, T falls to the k-th smallest of the lanes' minima so far
//     (distinct entries, so a bound on the row's k-th smallest; a bitonic
//     sort across the warp).
//   * k rounds of a shuffle argmin on (value, column) over the lists'
//     heads; the winning lane pops its head.  Round p's pick goes
//     to lane p % G, which after the rounds reads the payload at the
//     chosen column and writes the pair, so the k payload reads are in
//     flight together.
// topk_rows_kpass (k > 32, which no path asks for; the function accepts any
// k <= C, as `_pl_topk` does): one warp per row, the row staged once in
// shared memory and rescanned k times, each time with a shuffle reduction
// on (value, column); the first minimum is overwritten with BIG.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define HP_TOPK_BIG 1e10f
#define TOPK_THREADS 128
#define TOPK_MAXK 32

// Insert (v, c) into the ascending list; the caller checked v < lv[K-1].
template <int K>
__device__ __forceinline__ void list_insert(float (&lv)[K], int (&lc)[K],
                                            float v, int c) {
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    const bool shift = v < lv[j - 1];
    const bool here = !shift && v < lv[j];
    lv[j] = shift ? lv[j - 1] : (here ? v : lv[j]);
    lc[j] = shift ? lc[j - 1] : (here ? c : lc[j]);
  }
  if (v < lv[0]) {
    lv[0] = v;
    lc[0] = c;
  }
}

// One entry of the lane's columns, seen in increasing column order.  It
// enters the list if it is below the list's tail and not above T, a bound
// on the row's k-th smallest value (BIG where none is known).  Until the
// lane meets its first entry <= BIG (cle), it keeps the first-occurrence
// minimum (mo, co) of its entries, all above BIG so far; that first entry
// <= BIG, if exactly BIG, is then the lane's minimum among entries >= BIG
// (mo and co matter only for a row with no entry below BIG).
template <int K>
__device__ __forceinline__ void see(float (&lv)[K], int (&lc)[K], int& cle,
                                    float& mo, int& co, float T, float v,
                                    int c) {
  if (v < lv[K - 1] && v <= T) list_insert<K>(lv, lc, v, c);
  if (cle == INT_MAX) {
    if (v <= HP_TOPK_BIG) {
      cle = c;
      mo = HP_TOPK_BIG;
      co = c;
    } else if (v < mo || (v == mo && c < co)) {
      mo = v;
      co = c;
    }
  }
}

// (v, c) <- the lexicographic minimum of (v, c) over the lane's group.
template <int G>
__device__ __forceinline__ void group_argmin(float& v, int& c) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off, G);
    const int oc = __shfl_xor_sync(0xffffffffu, c, off, G);
    if (ov < v || (ov == v && oc < c)) {
      v = ov;
      c = oc;
    }
  }
}

// The k-th smallest (1 <= k <= 32) of one value per lane of the warp: a
// bitonic sort across the lanes, then lane k-1's value.
__device__ __forceinline__ float warp_kth(float v, int k) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      v = low == up ? fminf(v, o) : fmaxf(v, o);
    }
  }
  return __shfl_sync(0xffffffffu, v, k - 1);
}

// Column of entry i of lane l's batch at base: the lane reads 4-column
// chunks base / 4 + l + u G, u = i / 4, in increasing order.
template <int G>
__device__ __forceinline__ int batch_col(int base, int lig, int i) {
  return base + 4 * lig + 4 * G * (i / 4) + (i & 3);
}

// The lane's batch of the row at column base into a: one 16-byte load per
// chunk with vec, else single-column loads; missing entries are +inf.
template <int G, int B>
__device__ __forceinline__ void load_batch(const float* __restrict__ xr,
                                           int C, int vec, int base, int lig,
                                           float (&a)[B]) {
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
#pragma unroll
    for (int u = 0; u < B / 4; ++u) {
      const int q = base / 4 + lig + u * G;
      const float4 f = q < C / 4 ? __ldg(x4 + q)
                                 : make_float4(INFINITY, INFINITY, INFINITY,
                                               INFINITY);
      a[4 * u] = f.x;
      a[4 * u + 1] = f.y;
      a[4 * u + 2] = f.z;
      a[4 * u + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int c = batch_col<G>(base, lig, i);
      a[i] = c < C ? __ldg(xr + c) : INFINITY;
    }
  }
}

template <int K, int G>
__global__ void __launch_bounds__(TOPK_THREADS)
    topk_rows_lists(const float* __restrict__ x,
                    const float* __restrict__ payload, int n, int C, int k,
                    int vec, float* __restrict__ out_d,
                    float* __restrict__ out_v) {
  // a warp-wide bound T: wide rows (one row a warp) with lists long enough
  // that an insertion costs more than the bound's upkeep
  constexpr bool BOUND = G == 32 && K >= 4;
  const int lig = threadIdx.x & (G - 1);
  const long row = ((long)blockIdx.x * TOPK_THREADS + threadIdx.x) / G;
  if (G == 32 && row >= n) return;     // the whole warp
  // rows past n in a shared warp still take part in the shuffles
  const bool live = row < n;
  float lv[K];
  int lc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    lv[j] = HP_TOPK_BIG;
    lc[j] = INT_MAX;
  }
  int cle = INT_MAX, co = INT_MAX;
  float mo = INFINITY, T = HP_TOPK_BIG;
  constexpr int B = 16;                // entries per lane per batch
  const float* xr = x + (live ? row : 0) * (long)C;
  float a[B];
  if (live) load_batch<G, B>(xr, C, vec, 0, lig, a);
  if (G < 32) {
    // C <= 128 <= B * G (group_lanes): one batch
    if (live) {
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int c = batch_col<G>(0, lig, i);
        if (c < C) see<K>(lv, lc, cle, mo, co, T, a[i], c);
      }
    }
  } else {
    // every row has C columns, so the batch count is the same for all
    // lanes.  Short lists (K <= 2) load the next batch while one is seen;
    // longer ones spend those registers on the list instead (48 registers
    // at K = 8: 10 blocks of 4 warps fit an SM, and 4096 rows run in one
    // wave).
    constexpr bool AHEAD = K <= 2;
    float nx[B];
    for (int base = 0; base < C; base += B * G) {
      if constexpr (AHEAD) {
        if (base + B * G < C)
          load_batch<G, B>(xr, C, vec, base + B * G, lig, nx);
      } else if (base > 0) {
        load_batch<G, B>(xr, C, vec, base, lig, a);
      }
      if (BOUND) {
        // each lane's smallest entry so far is a distinct entry of the
        // row, so the k-th smallest of them bounds the row's k-th smallest
        float m = lv[0];
#pragma unroll
        for (int i = 0; i < B; ++i) m = fminf(m, a[i]);
        T = fminf(T, warp_kth(m, k));
      }
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int c = batch_col<G>(base, lig, i);
        if (c < C) see<K>(lv, lc, cle, mo, co, T, a[i], c);
      }
      if constexpr (AHEAD) {
#pragma unroll
        for (int i = 0; i < B; ++i) a[i] = nx[i];
      }
    }
  }
  // the row's first column <= BIG and first-occurrence minimum >= BIG
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    cle = min(cle, __shfl_xor_sync(0xffffffffu, cle, off, G));
  group_argmin<G>(mo, co);
  constexpr int SLOTS = (K + G - 1) / G;
  float pv[SLOTS];
  int pc[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    pv[i] = 0.0f;
    pc[i] = INT_MAX;
  }
  int tail_c = cle;
#pragma unroll
  for (int p = 0; p < K; ++p) {
    if (p < k) {                       // k is the same for every lane
      float hv = lv[0];
      int hc = lc[0];
      group_argmin<G>(hv, hc);
      float ov;
      int oc;
      if (hv < HP_TOPK_BIG) {          // an entry below BIG: pop it
        ov = hv;
        oc = hc;
        if (lc[0] == hc) {
#pragma unroll
          for (int j = 0; j + 1 < K; ++j) {
            lv[j] = lv[j + 1];
            lc[j] = lc[j + 1];
          }
          lv[K - 1] = HP_TOPK_BIG;
          lc[K - 1] = INT_MAX;
        }
      } else if (p == 0) {             // no entry below BIG
        ov = mo;
        oc = co;
        tail_c = co;
      } else {                         // the BIG tail
        ov = HP_TOPK_BIG;
        oc = tail_c;
      }
      if (p % G == lig) {
        pv[p / G] = ov;
        pc[p / G] = oc;
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int p = lig + i * G;
    if (p < k) {
      const int oc = pc[i];
      float sel = 0.0f;
      if (oc < C) sel = payload ? __ldg(payload + row * (long)C + oc)
                                : (float)oc;
      out_d[row * k + p] = pv[i];
      out_v[row * k + p] = sel;
    }
  }
}

__global__ void topk_rows_kpass(const float* __restrict__ x,
                                const float* __restrict__ payload, int n,
                                int C, int k, float* __restrict__ out_d,
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

typedef void (*ListsKernel)(const float*, const float*, int, int, int, int,
                            float*, float*);

template <int G>
static ListsKernel lists_for(int K) {
  switch (K) {
    case 1: return topk_rows_lists<1, G>;
    case 2: return topk_rows_lists<2, G>;
    case 4: return topk_rows_lists<4, G>;
    case 8: return topk_rows_lists<8, G>;
    case 16: return topk_rows_lists<16, G>;
    default: return topk_rows_lists<32, G>;
  }
}

// The list length for k <= TOPK_MAXK: k rounded up to a power of two.
static int list_len(int k) {
  int K = 1;
  while (K < k) K <<= 1;
  return K;
}

// Lanes per row: 32, or for C <= 128 the power of two in [4, 16] nearest
// below C / 8 (about eight columns a lane).
static int group_lanes(int C) {
  return C > 128 ? 32 : (C >= 128 ? 16 : (C >= 64 ? 8 : 4));
}

static ListsKernel lists_kernel(int C, int k) {
  const int K = list_len(k);
  switch (group_lanes(C)) {
    case 4: return lists_for<4>(K);
    case 8: return lists_for<8>(K);
    case 16: return lists_for<16>(K);
    default: return lists_for<32>(K);
  }
}

// Warps per block and dynamic shared memory of topk_rows_kpass.
static int kpass_warps(int C, size_t* smem) {
  const long row_bytes = (long)C * (long)sizeof(float);
  int warps = (int)((48L * 1024L) / row_bytes);
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  *smem = (size_t)warps * (size_t)row_bytes;
  return warps;
}

static int kpass_attr(size_t smem) {
  if (smem <= 48u * 1024u) return 0;
  return (int)cudaFuncSetAttribute(
      topk_rows_kpass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
}

// Blocks of the kernel hp_topk_rows launches for (C, k) that fit one SM,
// from the CUDA occupancy calculator; negative: a CUDA error.
extern "C" int hp_topk_blocks_per_sm(int C, int k) {
  int blocks = 0, rc;
  if (k > TOPK_MAXK) {
    size_t smem;
    const int warps = kpass_warps(C, &smem);
    rc = kpass_attr(smem);
    if (!rc)
      rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, topk_rows_kpass, warps * 32, smem);
  } else {
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, lists_kernel(C, k), TOPK_THREADS, 0);
  }
  return rc ? -rc : blocks;
}

// C entry point (bound with ctypes).  payload may be null: the selected
// column indices are returned as float values instead.  1 <= k <= C.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int hp_topk_rows(const float* x, const float* payload, int n,
                            int C, int k, float* out_d, float* out_v,
                            void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > C) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k > TOPK_MAXK) {
    size_t smem;
    const int warps = kpass_warps(C, &smem);
    const int rc = kpass_attr(smem);
    if (rc) return rc;
    topk_rows_kpass<<<(n + warps - 1) / warps, warps * 32, smem, st>>>(
        x, payload, n, C, k, out_d, out_v);
    return (int)cudaGetLastError();
  }
  const int vec = C % 4 == 0 && (((uintptr_t)x) & 15) == 0;
  const long rows_per_block = TOPK_THREADS / group_lanes(C);
  const long blocks = (n + rows_per_block - 1) / rows_per_block;
  const ListsKernel kern = lists_kernel(C, k);
  kern<<<(unsigned)blocks, TOPK_THREADS, 0, st>>>(x, payload, n, C, k, vec,
                                                  out_d, out_v);
  return (int)cudaGetLastError();
}
