// NCE sampled-negative scoring, forward and backward, for Hopper (sm_90a):
// K8, the port's kernel for a piece of compute that the JAX package leaves
// to XLA.
//
// Replaces the negative scores of volta_tpu/losses.py:nce_2048, dense
// (:299-317) and chunked (_chunked_neg_scores, :144-176): there an einsum
// scores every query against every candidate row ([b*r, b*r] products) and
// take_along_axis keeps the N = 127 sampled ones:
//
//   out[q, n] = sum_d pred[q, d] * flat[idx[q, n], d]
//
// pred [Q, d] and flat [M, d] share a dtype (float32 or bfloat16); idx
// [Q, N] int32; out [Q, N] float32. In bf16 each score is rounded to bf16
// and back before it is stored, as JAX rounds its score tensor to the
// inputs' dtype before the gather. An index outside [0, M) stores NaN, as
// JAX's gather fills, and is skipped by the backward, which computes
//
//   dpred[q, :] = sum_n g'[q, n] * flat[idx[q, n], :]
//
// for the cotangent g [Q, N] (float32), written in pred's dtype, where g'
// is g rounded to bf16 in the bf16 case (JAX's vjp of the astype rounds
// the cotangent). flat is data and gets no gradient.
//
// Two bodies (ops/nce.py: nce_body routes each call).
//
// The gather body (float32, and bf16 where the rule keeps it): one warp a
// query, 8 warps a block. The forward walks the query's negatives four at
// a time (four independent 16-byte load streams in flight), each lane
// summing its 16-byte slices of the row in float64, the warp adding its
// lanes' sums by shuffles, the sum rounded once to float32: the exact
// score, correctly rounded. The backward walks the columns in tiles of 32
// lanes x 4 vectors, keeps the tile's float32 sums in registers and walks
// all N negatives for each tile, summing over n in order. Each warp reads
// its query's N rows from L2 with no sharing between warps: at b256 x r36,
// d 2048 that is 4.8 GB of L2 reads for 37.7 MB of distinct rows.
//
// The tensor-core body (bf16): the queries' sampled scores are a sampled
// dense-dense product, pred [Q, d] . flat^T restricted to (q, idx[q, n]).
// Only a design that shares operand tiles between queries can beat the
// library's all-pairs product, and only on the tensor cores. So:
//   1. the plan (three kernels, ops/nce.py: nce_plan_ref is its twin)
//      buckets the valid pairs by (query tile of 128, candidate tile of 64)
//      with a counting sort: per query tile, the pairs counted by
//      (candidate tile, segment of 32 queries) and summed in that order;
//      then for each pair of query tiles the candidate tiles either uses;
//      then a fill in which each query's pairs are sorted by (candidate,
//      n) with a warp's bitonic sort and placed at cursors in query order.
//      Everything is in a fixed order: the same idx gives the same plan.
//      A bucket holds its pairs in (query, candidate, n) order, so
//      repeated (q, candidate) pairs lie next to each other. The plan
//      lists the non-empty pair tiles of the forward and, for each pair of
//      query tiles, the candidate tiles that either one uses;
//   2. the forward runs matmul_wgmma.cuh's body (TMA into a ring of four
//      stages, two consumer warpgroups running wgmma m64n256k16 with bf16
//      inputs and float32 sums, clusters of two blocks multicasting the
//      candidate rows, a persistent grid) over the plan's non-empty 256 x
//      256 pair tiles of pred . flat^T, both operands K-major. Its epilogue
//      rounds the tile's sums to bf16 into shared memory (half the columns
//      at a time) and stores out[q, n] for the tile's buckets only: no
//      [Q, M] tensor reaches device memory. The producer warpgroup's idle
//      warps store NaN at the out-of-range indices meanwhile;
//   3. the backward is dpred = G . flat, G the sparse [Q, M] matrix of g'
//      with N nonzeros a row. A first kernel sums each run of repeated
//      (q, candidate) pairs in n order in float32, rounds it to bf16 and
//      packs it with its tile row and column. For each (query tile, 192
//      columns of d) the consumers walk the candidate tiles, accumulating
//      with wgmma m64n192k16 in float32, and store dpred in bf16; the
//      producer warpgroup keeps the ring full, a warp a stage: it has TMA
//      bring flat's 64 x 192 tile (multicast to the cluster) and the
//      bucket's packed weights, and builds G's 128 x 64 tile in shared
//      memory from them, in the layout TMA's 128-byte swizzle gives. No
//      scatter into device memory, no atomics on floats: two calls are
//      equal to the bit.
// The tensor cores sum the products in float32, as JAX's einsum does
// (preferred_element_type=float32) before its astype(bf16). Their sums are
// not those of a float32 FMA chain: the bf16 scores equal torch's bf16
// all-pairs product's to the bit (cuBLAS on the same tensor cores), and
// land on the other bf16 neighbour than the exact sum's about 5 times as
// often as torch's float32 product does (1.15e-3 of the scores at b256).
// The dense floor of this design at b256 is the all-pairs product, 348
// GFLOP, 0.352 ms at the 989 TFLOP/s bf16 peak; its bound on the
// function's own work is 0.0716 ms.

#include <limits.h>

#include "common.cuh"
#include "matmul_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // negatives in flight per warp (forward)
constexpr int kTileVecs = 4;  // 16-byte vectors per lane per tile (backward)

template <typename T>
__device__ __forceinline__ float round_like(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ double warp_sum_f64(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nce_scores_fwd_kernel(float* __restrict__ out, const T* __restrict__ pred,
                      const T* __restrict__ flat, const int* __restrict__ idx,
                      int Q, int N, int M, int d) {
  constexpr int W = Vec16<T>::N;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  const T* p = pred + static_cast<size_t>(q) * d;
  const int* ix = idx + static_cast<size_t>(q) * N;
  float* o = out + static_cast<size_t>(q) * N;
  for (int n0 = 0; n0 < N; n0 += kUnroll) {
    const T* rows[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = n0 + u < N ? __ldg(ix + n0 + u) : -1;
      ok[u] = r >= 0 && r < M;
      rows[u] = flat + static_cast<size_t>(ok[u] ? r : 0) * d;
    }
    double acc[kUnroll] = {};
    for (int c = lane * W; c < d; c += 32 * W) {
      float a[W];
      Vec16<T>::load(p + c, a);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float b[W];
        Vec16<T>::load(rows[u] + c, b);
#pragma unroll
        for (int e = 0; e < W; ++e)
          acc[u] = fma(static_cast<double>(a[e]), static_cast<double>(b[e]),
                       acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float s = static_cast<float>(warp_sum_f64(acc[u]));
      if (lane == 0 && n0 + u < N)
        o[n0 + u] = ok[u] ? round_like<T>(s) : nanf("");
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nce_scores_bwd_kernel(T* __restrict__ dpred, const float* __restrict__ g,
                      const T* __restrict__ flat, const int* __restrict__ idx,
                      int Q, int N, int M, int d) {
  constexpr int W = Vec16<T>::N;
  constexpr int kTile = 32 * W * kTileVecs;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;
  const int* ix = idx + static_cast<size_t>(q) * N;
  const float* gq = g + static_cast<size_t>(q) * N;
  T* out = dpred + static_cast<size_t>(q) * d;
  for (int c0 = 0; c0 < d; c0 += kTile) {
    float acc[kTileVecs][W] = {};
    for (int n = 0; n < N; ++n) {
      const int r = __ldg(ix + n);
      if (r < 0 || r >= M) continue;
      const float gn = round_like<T>(__ldg(gq + n));
      const T* row = flat + static_cast<size_t>(r) * d;
#pragma unroll
      for (int v = 0; v < kTileVecs; ++v) {
        const int c = c0 + (v * 32 + lane) * W;
        if (c < d) {
          float b[W];
          Vec16<T>::load(row + c, b);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[v][e] = fmaf(gn, b[e], acc[v][e]);
        }
      }
    }
#pragma unroll
    for (int v = 0; v < kTileVecs; ++v) {
      const int c = c0 + (v * 32 + lane) * W;
      if (c < d) Vec16<T>::store(out + c, acc[v]);
    }
  }
}

int blocks_for(int Q) { return (Q + kWarps - 1) / kWarps; }

}  // namespace

// out [Q, N] float32; pred [Q, d], flat [M, d] of dtype (0 = float32,
// 1 = bfloat16); idx [Q, N] int32. Returns the launch's cudaError_t.
extern "C" int volta_nce_scores_fwd(void* out, const void* pred,
                                    const void* flat, const void* idx, int Q,
                                    int N, int M, int d, int dtype, int device,
                                    void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Q <= 0 || N <= 0) return cudaSuccess;
  if (M <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    nce_scores_fwd_kernel<float><<<blocks_for(Q), kThreads, 0, s>>>(
        o, static_cast<const float*>(pred), static_cast<const float*>(flat),
        ix, Q, N, M, d);
  } else if (dtype == 1) {
    nce_scores_fwd_kernel<__nv_bfloat16><<<blocks_for(Q), kThreads, 0, s>>>(
        o, static_cast<const __nv_bfloat16*>(pred),
        static_cast<const __nv_bfloat16*>(flat), ix, Q, N, M, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// dpred [Q, d] of dtype; g [Q, N] float32; flat, idx as above.
extern "C" int volta_nce_scores_bwd(void* dpred, const void* g,
                                    const void* flat, const void* idx, int Q,
                                    int N, int M, int d, int dtype, int device,
                                    void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Q <= 0) return cudaSuccess;
  if (N < 0 || M <= 0 || d <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const float* gg = static_cast<const float*>(g);
  if (dtype == 0) {
    nce_scores_bwd_kernel<float><<<blocks_for(Q), kThreads, 0, s>>>(
        static_cast<float*>(dpred), gg, static_cast<const float*>(flat), ix,
        Q, N, M, d);
  } else if (dtype == 1) {
    nce_scores_bwd_kernel<__nv_bfloat16><<<blocks_for(Q), kThreads, 0, s>>>(
        static_cast<__nv_bfloat16*>(dpred), gg,
        static_cast<const __nv_bfloat16*>(flat), ix, Q, N, M, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core body (bf16).

namespace nce_tc {

using namespace wg;

constexpr int kTQ = 128;   // the plan's query tile: one block's rows
constexpr int kTC = 64;    // the plan's candidate tile: one backward k step
constexpr int kCols = 256; // the forward's candidate columns a tile
constexpr int kBwdCols = 192;  // the backward's columns of d a tile
constexpr int kSeg = 32;   // queries a segment of the plan's counts
constexpr int kSegs = kTQ / kSeg;
constexpr int kMaxN = 128;     // negatives a query (the fill's sort)
constexpr int kMaxCT = 512;    // candidate tiles (the plan's shared memory)
// the forward's staging of a tile's bf16 scores: two groups of 64 rows x
// 64 words (128 columns), a half of the columns at a time
constexpr int kStagingBytes = 2 * 64 * 64 * 4;
constexpr size_t kFwdSmem =
    kStages * kStageBytes + kStagingBytes + 2 * kStages * 8 + 1024;
constexpr size_t kBwdSmem = kSmemBytes + kStages * 8;  // + weight barriers

// Exclusive sum over the block's threads (a whole number of warps, at most
// 1024); *total gets the sum of all.
__device__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = lane < warps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    sh[lane] = y;
  }
  __syncthreads();
  const int below = w ? sh[w - 1] : 0;
  *total = sh[warps - 1];
  __syncthreads();
  return below + x - v;
}

// The sum of v over the block's threads.
__device__ int block_sum(int v, int* sh) {
  int total;
  block_scan(v, sh, &total);
  return total;
}

// Where query tile qt's pairs begin: the sum of the earlier tiles' counts.
__device__ int tile_base(const int* tile_total, int qt, int* sh) {
  int v = 0;
  for (int t = threadIdx.x; t < qt; t += blockDim.x) v += __ldg(tile_total + t);
  return block_sum(v, sh);
}

// Ascending bitonic sort of the warp's 128 keys, key e = 32 i + lane in
// v[i].
__device__ __forceinline__ void warp_sort128(int (&v)[4], int lane) {
#pragma unroll
  for (int k = 2; k <= 128; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int jr = j >> 5;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i & jr) continue;
          const int i2 = i | jr;
          const bool up = ((32 * i + lane) & k) == 0;
          const int a = v[i], b = v[i2];
          if ((a > b) == up) {
            v[i] = b;
            v[i2] = a;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int e = 32 * i + lane;
          const int o = __shfl_xor_sync(0xffffffffu, v[i], j);
          const bool up = (e & k) == 0, lower = (e & j) == 0;
          v[i] = lower == up ? min(v[i], o) : max(v[i], o);
        }
      }
    }
  }
}

// Plan 1, a block of 1024 a query tile: its valid pairs counted by
// (candidate tile, segment of 32 queries), then their exclusive sum in that
// order into starts[(qt CT + ct) kSegs + s], counted from the tile's first
// pair, and the tile's count into tile_total[qt].
__global__ void __launch_bounds__(1024)
plan_count_kernel(const int* __restrict__ idx, int* __restrict__ starts,
                  int* __restrict__ tile_total, int Q, int N, int M, int CT) {
  extern __shared__ int hist[];  // [CT][kSegs]
  __shared__ int sh[32];
  const int qt = blockIdx.x, q0 = qt * kTQ, slots = CT * kSegs;
  for (int c = threadIdx.x; c < slots; c += blockDim.x) hist[c] = 0;
  __syncthreads();
  const int e0 = q0 * N, e1 = min(q0 + kTQ, Q) * N;
  for (int e = e0 + threadIdx.x; e < e1; e += 4 * blockDim.x) {
    int m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ek = e + k * blockDim.x;
      m[k] = ek < e1 ? __ldg(idx + ek) : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (m[k] >= 0 && m[k] < M) {
        const int seg = ((e + k * blockDim.x) / N - q0) / kSeg;
        atomicAdd(&hist[m[k] / kTC * kSegs + seg], 1);
      }
  }
  __syncthreads();
  int run = 0;
  for (int c0 = 0; c0 < slots; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    int total;
    const int at = block_scan(c < slots ? hist[c] : 0, sh, &total);
    if (c < slots) starts[static_cast<size_t>(qt) * slots + c] = run + at;
    run += total;
  }
  if (threadIdx.x == 0) tile_total[qt] = run;
}

// Plan 2, a block a pair of query tiles qp: the candidate tiles that either
// tile uses, bwd_count[qp] of them in order, and
// bwd_list[(2 qp + r) CT + i] = (ct, start, end of query tile 2 qp + r's
// bucket, 0); used[qp CJ +
// cj] whether the forward's pair tile (qp, cj) holds a pair. Reads plan
// 1's tile-relative starts; the last block stores starts[T], the number of
// pairs.
__global__ void __launch_bounds__(1024)
plan_list_kernel(int* __restrict__ starts, const int* __restrict__ tile_total,
                 int* __restrict__ used, int* __restrict__ bwd_count,
                 int4* __restrict__ bwd_list, int QT, int CT, int QP, int CJ,
                 int T) {
  __shared__ int sh[32];
  const int qp = blockIdx.x;
  int base[3];
  base[0] = tile_base(tile_total, 2 * qp, sh);
  base[1] = base[0] + (2 * qp < QT ? __ldg(tile_total + 2 * qp) : 0);
  base[2] = base[1] + (2 * qp + 1 < QT ? __ldg(tile_total + 2 * qp + 1) : 0);
  if (qp == QP - 1 && threadIdx.x == 0) starts[T] = base[2];
  // query tile 2 qp + r's bucket range over candidate tiles [c, c1)
  auto range = [&](int r, int c, int c1, int& s, int& e) {
    const int qt = 2 * qp + r;
    s = e = 0;
    if (qt >= QT) return;
    const int* st = starts + static_cast<size_t>(qt) * CT * kSegs;
    s = base[r] + st[c * kSegs];
    e = c1 < CT ? base[r] + st[c1 * kSegs] : base[r + 1];
  };
  int run = 0;
  for (int c0 = 0; c0 < CT; c0 += blockDim.x) {
    const int ct = c0 + threadIdx.x;
    int s[2] = {0, 0}, e[2] = {0, 0};
    bool any = false;
    if (ct < CT) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        range(r, ct, ct + 1, s[r], e[r]);
        any |= s[r] < e[r];
      }
    }
    int total;
    const int at = run + block_scan(any, sh, &total);
    if (any) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        bwd_list[static_cast<size_t>(2 * qp + r) * CT + at] =
            make_int4(ct, s[r], e[r], 0);
    }
    run += total;
  }
  if (threadIdx.x == 0) bwd_count[qp] = run;
  for (int cj = threadIdx.x; cj < CJ; cj += blockDim.x) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int s, e;
      range(r, 4 * cj, min(4 * cj + 4, CT), s, e);
      any |= s < e;
    }
    used[qp * CJ + cj] = any;
  }
}

// Plan 3: each segment's pairs into their buckets; a block a segment (every
// segment of every query tile), 8 warps, a query a warp in 4 rounds (rounds
// and warps in query order). A warp sorts its query's pairs by (candidate,
// n); each candidate tile's run gets the positions after those of the
// earlier queries. Entry = (q N + n, row << 24 | candidate), row = q's row
// in its query tile. The block turns its segment's starts into positions in
// the whole list, and block 0 lists the forward's used pair tiles in order:
// units[0] their count, then u = qp CJ + cj.
__global__ void __launch_bounds__(256)
plan_fill_kernel(const int* __restrict__ idx, int* __restrict__ starts,
                 const int* __restrict__ tile_total,
                 const int* __restrict__ used, int* __restrict__ units,
                 int2* __restrict__ entries, int Q, int N, int M, int CT,
                 int QP, int CJ) {
  extern __shared__ int sm[];
  __shared__ int sh[32];
  int* cursor = sm;      // [CT]: the next free position of each bucket
  int* runs = sm + CT;   // [8][CT]: the round's run lengths, then positions
  int* keys = sm + 9 * CT;  // [8][128]: each warp's sorted keys
  const int seg = blockIdx.x, qt = seg / kSegs, s = seg % kSegs;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* mine = keys + w * kMaxN;
  // every round's indices in flight at once
  int v[kSeg / 8][4];
#pragma unroll
  for (int round = 0; round < kSeg / 8; ++round) {
    const int q = seg * kSeg + round * 8 + w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 32 * i + lane;
      const int m = q < Q && n < N ? __ldg(idx + q * N + n) : -1;
      v[round][i] = m >= 0 && m < M ? m * kMaxN + n : INT_MAX;
    }
  }
  const int base = tile_base(tile_total, qt, sh);
  for (int c = threadIdx.x; c < CT; c += blockDim.x) {
    int* slot = starts + (static_cast<size_t>(qt) * CT + c) * kSegs + s;
    cursor[c] = base + *slot;
    *slot = cursor[c];
  }
#pragma unroll
  for (int round = 0; round < kSeg / 8; ++round) {
    const int q = seg * kSeg + round * 8 + w;
    warp_sort128(v[round], lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) mine[32 * i + lane] = v[round][i];
    for (int c = threadIdx.x; c < 8 * CT; c += blockDim.x) runs[c] = 0;
    __syncthreads();
    // element e's rank in its candidate tile's run: e minus the run's
    // first element, found by binary search in the sorted keys
    int ct[4], rank[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 32 * i + lane, key = v[round][i];
      ct[i] = key == INT_MAX ? -1 : key / (kMaxN * kTC);
      int lo = 0, hi = e;
      const int first = ct[i] * kMaxN * kTC;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (mine[mid] < first) lo = mid + 1;
        else hi = mid;
      }
      rank[i] = e - lo;
      const bool last = ct[i] >= 0 &&
                        (e == kMaxN - 1 || mine[e + 1] >= first + kMaxN * kTC);
      if (last) runs[w * CT + ct[i]] = rank[i] + 1;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < CT; c += blockDim.x) {
      int at = cursor[c];
      for (int ww = 0; ww < 8; ++ww) {
        const int n = runs[ww * CT + c];
        runs[ww * CT + c] = at;
        at += n;
      }
      cursor[c] = at;
    }
    __syncthreads();
    const int row = q - qt * kTQ;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ct[i] >= 0)
        entries[runs[w * CT + ct[i]] + rank[i]] = make_int2(
            q * N + (v[round][i] & (kMaxN - 1)),
            (row << 24) | (v[round][i] / kMaxN));
    __syncthreads();
  }
  if (blockIdx.x == 0) {
    int run = 0;
    for (int u0 = 0; u0 < QP * CJ; u0 += blockDim.x) {
      const int u = u0 + threadIdx.x;
      const int flag = u < QP * CJ ? __ldg(used + u) : 0;
      int total;
      const int at = block_scan(flag, sh, &total);
      if (flag) units[1 + run + at] = u;
      run += total;
    }
    if (threadIdx.x == 0) units[0] = run;
  }
}

// d[64 x 192] += A[64 x 16] . B[16 x 192] (the backward's tile), A K-major,
// B MN-major, both from shared memory.
#define VOLTA_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
__device__ __forceinline__ void wgmma_192(float (&d)[96], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n}\n"
      : VOLTA_ACC8(0),
        VOLTA_ACC8(8),
        VOLTA_ACC8(16),
        VOLTA_ACC8(24),
        VOLTA_ACC8(32),
        VOLTA_ACC8(40),
        VOLTA_ACC8(48),
        VOLTA_ACC8(56),
        VOLTA_ACC8(64),
        VOLTA_ACC8(72),
        VOLTA_ACC8(80),
        VOLTA_ACC8(88)
      : "l"(da), "l"(db), "r"(1));
}
#undef VOLTA_ACC8

__device__ __forceinline__ void fence_acc96(float (&d)[96]) {
#pragma unroll
  for (int i = 0; i < 96; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void zero_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  fence_acc(d);
}

__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, full_count);
      mbar_init(empty + 8 * s, 2 * 2);  // each consumer group of both blocks
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
}

__device__ __forceinline__ void next_stage(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// Stay until both blocks' consumers have released every stage, so that no
// arrival from the peer comes after this block has exited.
__device__ __forceinline__ void drain(uint32_t empty, int stage,
                                      uint32_t phase) {
  for (int i = 0; i < kStages; ++i) {
    mbar_wait(empty + 8 * stage, phase ^ 1);
    next_stage(stage, phase);
  }
}

// The forward over the plan's pair tiles: cluster c takes units c, c +
// clusters, ...; unit t = qp CJ + cj is queries [256 qp, 256 qp + 256)
// (block rank r the 128 from 256 qp + 128 r) x candidates [256 cj, 256 cj +
// 256). Operands: map_p over pred [Q, d], map_f over flat [M, d], boxes of
// 64 x 128 rows, K-major.
__global__ void __launch_bounds__(wg::kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap map_p,
           const __grid_constant__ CUtensorMap map_f,
           const int* __restrict__ units, const int* __restrict__ starts,
           const int2* __restrict__ entries, const int* __restrict__ idx,
           float* __restrict__ out, int Q, int N, int M, int d, int QT,
           int CT, int CJ) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  uint32_t* staging = reinterpret_cast<uint32_t*>(smem + kStages * kStageBytes);
  const uint32_t full = base + kStages * kStageBytes + kStagingBytes;
  const uint32_t empty = full + kStages * 8;
  const int rank = cluster_rank();
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int nunits = __ldg(units);
  const int kblocks = (d + kBK - 1) / kBK;
  const int group = threadIdx.x / 128;
  init_barriers(full, empty, 1);

  if (group == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    if (threadIdx.x == 256) {
      // L2: keep flat, which every query pair reads again over the run;
      // stream pred, whose tile the same pair's units read together
      const uint64_t pol_p = l2_policy(false), pol_f = l2_policy(true);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = cluster; u < nunits; u += clusters) {
        const int t = __ldg(units + 1 + u), qp = t / CJ, cj = t % CJ;
        const int q0 = (2 * qp + rank) * kTQ, c0 = cj * kCols;
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kStageBytes);
          const uint32_t sa = base + stage * kStageBytes;
          tma_load(sa, &map_p, bar, kb * kBK, q0, pol_p);
          // this block's half of the 256 candidate rows, into both blocks
          tma_load_both(sa + kABytes + rank * (kBBytes / 2), &map_f, bar,
                        kb * kBK, c0 + 128 * rank, pol_f);
          next_stage(stage, phase);
        }
      }
      drain(empty, stage, phase);
    } else if (threadIdx.x >= 288) {
      // out-of-range indices score NaN, as JAX's gather fills
      const int n = Q * N, lanes = 96;
      for (int i = blockIdx.x * lanes + threadIdx.x - 288; i < n;
           i += gridDim.x * lanes) {
        const int m = __ldg(idx + i);
        if (m < 0 || m >= M) out[i] = __int_as_float(0x7fc00000);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    auto release = [&](int s) {
      if (t < 2) mbar_arrive_cluster(empty + 8 * s, t);
    };
    uint32_t* st = staging + group * 64 * 64;
    float d_acc[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = cluster; u < nunits; u += clusters) {
      const int tile = __ldg(units + 1 + u), qp = tile / CJ, cj = tile % CJ;
      // the entries of this block's buckets, the first half of the
      // columns' then the second's (each a run of whole buckets); the
      // thread's first entry of each loads under the products
      const int qt = 2 * qp + rank, c0 = cj * kCols;
      int range[3] = {0, 0, 0};
      if (qt < QT) {
#pragma unroll
        for (int h = 0; h < 3; ++h)
          range[h] = __ldg(starts + (static_cast<size_t>(qt) * CT +
                                     min(4 * cj + 2 * h, CT)) * kSegs);
      }
      int2 first[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        first[h] = range[h] + static_cast<int>(threadIdx.x) < range[h + 1]
                       ? __ldg(entries + range[h] + threadIdx.x)
                       : make_int2(0, 0);
      zero_acc(d_acc);
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kStageBytes;
        const uint32_t sb = sa + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_256<0, 0>(d_acc, desc(sa + group * kBox + kk * 32, 16, 1024),
                          desc(sb + kk * 32, 16, 1024));
        wgmma_commit();
        if (kb > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        next_stage(stage, phase);
      }
      wgmma_wait<0>();
      fence_acc(d_acc);
      release(prev);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the group's scores of columns [128 h, 128 h + 128), rounded to
        // bf16: row r's word c (columns 2c, 2c + 1) at r 64 + (c ^ 4 (r %
        // 8)), so that a warp's stores meet no bank twice
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = 16 * h + jj;
            const int r = 16 * (t / 32) + lane / 4 + 8 * hh;
            const __nv_bfloat162 p = __floats2bfloat162_rn(
                d_acc[4 * j + 2 * hh], d_acc[4 * j + 2 * hh + 1]);
            st[r * 64 + ((4 * jj + quad) ^ ((r & 7) << 2))] =
                *reinterpret_cast<const uint32_t*>(&p);
          }
        }
        named_sync(1, 256);
        auto store = [&](int2 en) {
          const int row = en.y >> 24;
          const int c = (en.y & 0xFFFFFF) - c0 - 128 * h, r = row & 63;
          const uint32_t word = staging[(row >> 6) * 64 * 64 + r * 64 +
                                        ((c >> 1) ^ ((r & 7) << 2))];
          out[en.x] = __uint_as_float((c & 1 ? word >> 16 : word & 0xFFFFu)
                                      << 16);
        };
        const int e0 = range[h] + static_cast<int>(threadIdx.x);
        if (e0 < range[h + 1]) store(first[h]);
        // the rest (a bucket of a query tile's own images holds thousands)
        // four loads in flight at a time
        for (int e = e0 + 256; e < range[h + 1]; e += 4 * 256) {
          int2 en[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            en[k] = e + 256 * k < range[h + 1] ? __ldg(entries + e + 256 * k)
                                               : make_int2(-1, 0);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (en[k].x >= 0) store(en[k]);
        }
        named_sync(1, 256);
      }
    }
  }
}

// The backward's first kernel: the packed weight of each entry of the plan,
// in the entries' order: 0 where the entry repeats the (q, candidate) of
// the one before it, else the run's sum of bf16(g) in n order (float32,
// rounded once to bf16) with its row and column in the candidate tile:
// row << 22 | column << 16 | bf16 bits (0 where the sum is +0).
__global__ void __launch_bounds__(256)
pack_kernel(const int2* __restrict__ entries, const int* __restrict__ total,
            const float* __restrict__ g, uint32_t* __restrict__ packed,
            int N) {
  const int E = __ldg(total);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int2 en = __ldg(entries + e);
  const int q = en.x / N;
  if (e > 0) {
    const int2 before = __ldg(entries + e - 1);
    if (before.y == en.y && before.x / N == q) {
      packed[e] = 0;
      return;
    }
  }
  float sum = 0.f;
  for (int f = e; f < E; ++f) {
    const int2 x = __ldg(entries + f);
    if (x.y != en.y || x.x / N != q) break;
    sum += __bfloat162float(__float2bfloat16(__ldg(g + x.x)));
  }
  const uint32_t bits = __bfloat16_as_ushort(__float2bfloat16(sum));
  const uint32_t row = static_cast<uint32_t>(en.y) >> 24;
  const uint32_t col = (en.y & 0xFFFFFF) & (kTC - 1);
  packed[e] = bits ? (row << 22) | (col << 16) | bits : 0u;
}

// Where a packed weight goes in G's tile (K-major, 128-byte swizzle: row
// r's 16-byte chunk c at chunk c ^ (r % 8)): its byte offset, or -1 for a
// weight of 0 (nothing to store).
__device__ __forceinline__ int weight_at(uint32_t w) {
  if (!w) return -1;
  const uint32_t r = w >> 22, c = (w >> 16) & 63;
  return static_cast<int>(r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                          (c & 7) * 2);
}

// A 1-D bulk copy of `bytes` (a multiple of 16) from global src (16-byte
// aligned) into shared memory at dst, counted on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The backward: dpred [Q, d] = G . flat over units u = qp DT + dt (cluster
// c takes c, c + clusters, ...): block rank r's 128 rows of the query pair
// qp times columns [192 dt, 192 dt + 192) of d, walking the pair's
// candidate tiles. map_f over flat [M, d], boxes of 64 columns x 64 rows.
// 192 columns a unit, not 256: at d 2048 that is 11 column tiles and 6
// units a cluster at b256 (36 query pairs on 66 clusters), where 256 would
// leave the last of 5 rounds a third full.
//
// A stage: G's 128 x 64 tile (16 KB), flat's 64 x 192 tile (24 KB) and
// the bucket's packed weights (up to kStageWords). The producer
// warpgroup's warp w owns stage w: at every fourth step its first lane has
// TMA bring flat's tile and, with a bulk copy on the stage's weight
// barrier, the bucket's weights; the warp clears G's tile, waits for the
// weights, stores them in the layout TMA's 128-byte swizzle gives, and
// fences the stores for the async proxy. The stage is full once the tile
// has landed and G is built. Each stage's own warp leaves the other three
// stages' builds running while it waits. Zeroing all 16 KB of G at every
// step made the b256 backward 0.74 ms against 0.45 without the zeroing (an
// H100, 700 W): each lane instead zeroes the few places it stored into
// the stage at its last use, and the warp zeroes the whole tile only
// after a bucket of more than kKept weights a lane. The builders read no
// global memory but for a bucket longer than the stage holds (one where
// every query of a tile draws the same few rows).
//
// a lane's stores into its stage that it clears itself at the stage's next
// use
constexpr int kKept = 4;
constexpr int kBatch = 8;  // loads in flight a lane for a long bucket
constexpr int kStageWords = (kStageBytes - kABytes - 3 * kBox) / 4;

__global__ void __launch_bounds__(wg::kThreads, 1)
bwd_kernel(const __grid_constant__ CUtensorMap map_f,
           const int* __restrict__ bwd_count,
           const int4* __restrict__ bwd_list,
           const uint32_t* __restrict__ packed,
           __nv_bfloat16* __restrict__ dpred, int Q, int d, int CT, int QP,
           int DT) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kStages * kStageBytes;
  const uint32_t empty = full + kStages * 8;
  const uint32_t wfull = empty + kStages * 8;  // the weights have landed
  const int rank = cluster_rank();
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;
  const int nunits = QP * DT;
  const int group = threadIdx.x / 128;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(wfull + 8 * s, 1);
  init_barriers(full, empty, 2);

  // where a bucket's weights lie: [lo, hi) of packed, copied from the
  // 16-byte boundary at or below lo; *fits whether the stage holds them
  auto span = [](int4 c, int& first, int& words, bool& fits) {
    first = c.y & ~3;
    words = ((c.z + 3) & ~3) - first;
    fits = words <= kStageWords;
  };
  // the bucket's weights into stage s's weight area, counted on its
  // weight barrier (an arrival alone where the area cannot hold them)
  auto fetch = [&](int s, int4 b) {
    int first, words;
    bool fits;
    span(b, first, words, fits);
    const uint32_t wbar = wfull + 8 * s;
    if (fits && words > 0) {
      mbar_expect_tx(wbar, 4 * words);
      bulk_load(base + s * kStageBytes + kABytes + 3 * kBox,
                packed + first, 4 * words, wbar);
    } else {
      mbar_arrive(wbar);
    }
  };
  if (group == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    // warp w owns stage w: it fills the stage at every fourth step
    const int w = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    const uint32_t bar = full + 8 * w;
    const uint32_t sb = base + w * kStageBytes + kABytes;
    uint8_t* a = smem + w * kStageBytes;
    const uint32_t* words_at =
        reinterpret_cast<const uint32_t*>(a + kABytes + 3 * kBox);
    const uint64_t pol_f = l2_policy(true);  // every query pair reads flat
    uint32_t phase = 0;
    // whether the stage's G tile needs zeroing whole, else where this lane
    // stored into it at the stage's last use
    bool whole = true;
    int at[kKept];
#pragma unroll
    for (int k = 0; k < kKept; ++k) at[k] = -1;
    int step = 0;  // steps of the earlier units
    for (int u = cluster; u < nunits; u += clusters) {
      const int qp = u / DT, d0 = (u % DT) * kBwdCols;
      const int nk = __ldg(bwd_count + qp);
      const int4* list = bwd_list + static_cast<size_t>(2 * qp + rank) * CT;
      for (int i = (w - step % kStages + kStages) % kStages; i < nk;
           i += kStages) {
        const int4 c = __ldg(list + i);
        mbar_wait(empty + 8 * w, phase ^ 1);
        if (lane == 0) {
          // three boxes of 64 columns: rank 0 loads two, rank 1 one
          mbar_expect_tx(bar, 3 * kBox);
          for (int j = 2 * rank; j < 2 + rank; ++j)
            tma_load_both(sb + j * kBox, &map_f, bar, d0 + 64 * j, c.x * kTC,
                          pol_f);
          fetch(w, c);
        }
        if (whole) {
#pragma unroll 4
          for (int v = lane; v < kABytes / 16; v += 32)
            reinterpret_cast<uint4*>(a)[v] = make_uint4(0, 0, 0, 0);
        } else {
#pragma unroll
          for (int k = 0; k < kKept; ++k)
            if (at[k] >= 0) *reinterpret_cast<uint16_t*>(a + at[k]) = 0;
        }
        __syncwarp();
        mbar_wait(wfull + 8 * w, phase);
        int first, words;
        bool fits;
        span(c, first, words, fits);
        auto put = [&](uint32_t x) {
          const int p = weight_at(x);
          if (p >= 0)
            *reinterpret_cast<uint16_t*>(a + p) = static_cast<uint16_t>(x);
          return p;
        };
        // the first kKept weights kept in mind; a path for each place the
        // weights lie, so that no global load is hoisted into the
        // shared-memory one
#pragma unroll
        for (int k = 0; k < kKept; ++k) at[k] = -1;
        // (loads first, then stores, kKept at a time: a store to shared
        // memory keeps the compiler from moving the next load above it)
        if (fits) {
          uint32_t x[kKept];
#pragma unroll
          for (int k = 0; k < kKept; ++k) {
            const int e = c.y + lane + 32 * k;
            x[k] = e < c.z ? words_at[e - first] : 0u;
          }
#pragma unroll
          for (int k = 0; k < kKept; ++k) at[k] = put(x[k]);
          for (int e = c.y + lane + 32 * kKept; e < c.z; e += 32 * kBatch) {
            uint32_t y[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              y[k] = e + 32 * k < c.z ? words_at[e + 32 * k - first] : 0u;
#pragma unroll
            for (int k = 0; k < kBatch; ++k) put(y[k]);
          }
        } else {
          for (int e = c.y + lane; e < c.z; e += 32 * kBatch) {
            uint32_t y[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
              y[k] = e + 32 * k < c.z ? __ldg(packed + e + 32 * k) : 0u;
#pragma unroll
            for (int k = 0; k < kBatch; ++k) put(y[k]);
          }
        }
        whole = !fits || c.z - c.y > 32 * kKept;
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(bar);
        phase ^= 1;
      }
      step += nk;
    }
    // stay until both blocks' consumers have released the stage, so that
    // no arrival from the peer comes after this block has exited
    mbar_wait(empty + 8 * w, phase ^ 1);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    const int row = 64 * group + 16 * (t / 32) + lane / 4;
    auto release = [&](int s) {
      if (t < 2) mbar_arrive_cluster(empty + 8 * s, t);
    };
    float d_acc[96];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = cluster; u < nunits; u += clusters) {
      const int qp = u / DT, d0 = (u % DT) * kBwdCols;
      const int nk = __ldg(bwd_count + qp);
#pragma unroll
      for (int i = 0; i < 96; ++i) d_acc[i] = 0.f;
      fence_acc96(d_acc);
      int prev = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kStageBytes;
        const uint32_t sb = sa + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_192(d_acc, desc(sa + group * kBox + kk * 32, 16, 1024),
                    desc(sb + kk * 2048, kBox, 1024));
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        next_stage(stage, phase);
      }
      // unconditional, or ptxas cannot see that every path to the
      // epilogue's reads of d_acc has waited, and serializes the products
      wgmma_wait<0>();
      fence_acc96(d_acc);
      if (nk > 0) release(prev);
      // bf16, the quad trading pairs so that each thread stores 8 columns
      // (16 bytes) of one n8 block, as matmul_wgmma.cuh's epilogue
      const int q0 = (2 * qp + rank) * kTQ;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = q0 + row + 8 * h;
#pragma unroll
        for (int jg = 0; jg < kBwdCols / 32; ++jg) {
          uint32_t v[4], s[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = 4 * jg + i;
            const __nv_bfloat162 p = __floats2bfloat162_rn(
                d_acc[4 * j + 2 * h], d_acc[4 * j + 2 * h + 1]);
            v[i] = *reinterpret_cast<const uint32_t*>(&p);
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t got =
                __shfl_xor_sync(0xffffffffu, pick(v, quad ^ r), r);
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (i == (quad ^ r)) s[i] = got;
          }
          const int n = d0 + 8 * (4 * jg + quad);
          if (m < Q && n < d)
            *reinterpret_cast<uint4*>(dpred + static_cast<size_t>(m) * d +
                                      n) = make_uint4(s[0], s[1], s[2], s[3]);
        }
      }
    }
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kern, size_t smem, int clusters,
                            cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, clusters, stream);
  cfg.dynamicSmemBytes = smem;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename Kernel>
cudaError_t fit_clusters(Kernel kern, size_t smem, int* clusters) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(&attr, 1, nullptr);
  cfg.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

struct Tiles {
  int QT, CT, QP, CJ, T;
  Tiles(int Q, int M)
      : QT((Q + kTQ - 1) / kTQ), CT((M + kTC - 1) / kTC),
        QP((QT + 1) / 2), CJ((CT + 3) / 4), T(QT * CT * kSegs) {}
};

}  // namespace nce_tc

// The tensor-core body's plan of idx [Q, N] int32 (N <= 128) over M
// candidates (at most 4096 candidate tiles), into entries [Q N] int2,
// starts [T + 1], units [1 + QP CJ], bwd_count [QP] and bwd_list [2 QP CT]
// int4 (ops/nce.py: plan_layout). Returns the launches' cudaError_t.
extern "C" int volta_nce_plan(const void* idx, void* entries, void* starts,
                              void* units, void* bwd_count, void* bwd_list,
                              void* scratch, int Q, int N, int M, int device,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Q <= 0 || N <= 0 || N > nce_tc::kMaxN || M <= 0) return cudaErrorInvalidValue;
  const nce_tc::Tiles t(Q, M);
  if (t.CT > nce_tc::kMaxCT) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(starts);
  int* tile_total = static_cast<int*>(scratch);  // [QT]
  int* used = tile_total + t.QT;                 // [QP CJ]
  const int* ix = static_cast<const int*>(idx);
  const size_t count_smem = sizeof(int) * t.CT * nce_tc::kSegs;
  e = allow_smem(nce_tc::plan_count_kernel, count_smem);
  if (e != cudaSuccess) return e;
  nce_tc::plan_count_kernel<<<t.QT, 1024, count_smem, s>>>(ix, st, tile_total, Q,
                                                        N, M, t.CT);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nce_tc::plan_list_kernel<<<t.QP, 1024, 0, s>>>(
      st, tile_total, used, static_cast<int*>(bwd_count),
      static_cast<int4*>(bwd_list), t.QT, t.CT, t.QP, t.CJ, t.T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t fill_smem = sizeof(int) * (9 * t.CT + 8 * nce_tc::kMaxN);
  e = allow_smem(nce_tc::plan_fill_kernel, fill_smem);
  if (e != cudaSuccess) return e;
  nce_tc::plan_fill_kernel<<<t.QT * nce_tc::kSegs, 256, fill_smem, s>>>(
      ix, st, tile_total, used, static_cast<int*>(units),
      static_cast<int2*>(entries), Q, N, M, t.CT, t.QP, t.CJ);
  return cudaGetLastError();
}

// How many clusters of two blocks both tensor-core kernels run at once:
// their persistent grids' size.
extern "C" int volta_nce_clusters(int device, int* clusters) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  int f = 0, b = 0;
  e = nce_tc::fit_clusters(nce_tc::fwd_kernel, nce_tc::kFwdSmem, &f);
  if (e == cudaSuccess) e = nce_tc::fit_clusters(nce_tc::bwd_kernel, nce_tc::kBwdSmem, &b);
  *clusters = f < b ? f : b;
  return e;
}

// The tensor-core forward: out [Q, N] float32 from pred [Q, d], flat
// [M, d] bf16 (16-byte aligned, d a multiple of 8), idx [Q, N] and its plan,
// on `clusters` clusters. Returns 0, a cudaError_t, or a negative code
// where a tensor map does not encode (as volta_wgrad_wgmma).
extern "C" int volta_nce_tc_fwd(void* out, const void* pred, const void* flat,
                                const void* idx, const void* entries,
                                const void* starts, const void* units,
                                int clusters, int Q, int N, int M, int d,
                                int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Q <= 0 || N <= 0) return cudaSuccess;
  const nce_tc::Tiles t(Q, M);
  CUtensorMap mp, mf;
  int rc = wg::make_map(&mp, pred, Q, d, 128);
  if (rc == 0) rc = wg::make_map(&mf, flat, M, d, 128);
  if (rc != 0) return rc;
  return nce_tc::launch_clusters(
      nce_tc::fwd_kernel, nce_tc::kFwdSmem, clusters, static_cast<cudaStream_t>(stream),
      mp, mf, static_cast<const int*>(units), static_cast<const int*>(starts),
      static_cast<const int2*>(entries), static_cast<const int*>(idx),
      static_cast<float*>(out), Q, N, M, d, t.QT, t.CT, t.CJ);
}

// The tensor-core backward: dpred [Q, d] bf16 from g [Q, N] float32, flat
// [M, d] bf16 and the plan; packed [Q N] uint32 is scratch. Returns as
// volta_nce_tc_fwd.
extern "C" int volta_nce_tc_bwd(void* dpred, const void* g, const void* flat,
                                const void* entries, const void* starts,
                                const void* bwd_count, const void* bwd_list,
                                void* packed, int clusters, int Q, int N,
                                int M, int d, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (Q <= 0) return cudaSuccess;
  const nce_tc::Tiles t(Q, M);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long pairs = static_cast<long long>(Q) * N;
  if (pairs > 0) {
    nce_tc::pack_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, s>>>(
        static_cast<const int2*>(entries),
        static_cast<const int*>(starts) + t.T, static_cast<const float*>(g),
        static_cast<uint32_t*>(packed), N);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  CUtensorMap mf;
  const int rc = wg::make_map(&mf, flat, M, d, 64);
  if (rc != 0) return rc;
  return nce_tc::launch_clusters(
      nce_tc::bwd_kernel, nce_tc::kBwdSmem, clusters, s, mf,
      static_cast<const int*>(bwd_count), static_cast<const int4*>(bwd_list),
      static_cast<const uint32_t*>(packed),
      static_cast<__nv_bfloat16*>(dpred), Q, d, t.CT, t.QP,
      (d + nce_tc::kBwdCols - 1) / nce_tc::kBwdCols);
}
