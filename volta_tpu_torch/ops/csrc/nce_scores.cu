// NCE sampled-negative scoring, forward and backward, for Hopper (sm_90a):
// K8, the port's kernel for a piece of compute that the JAX package leaves
// to XLA.
//
// Replaces the negative scores of volta_tpu/losses.py:nce_2048, dense
// (:299-317) and chunked (_chunked_neg_scores, :144-176): there an einsum
// scores every query against every candidate row ([b*r, b*r] products) and
// take_along_axis keeps the N = 127 sampled ones. This kernel computes only
// the sampled ones:
//
//   out[q, n] = sum_d pred[q, d] * flat[idx[q, n], d]
//
// pred [Q, d] and flat [M, d] share a dtype (float32 or bfloat16); idx
// [Q, N] int32; out [Q, N] float32. The products (exact in float64 for
// either dtype) are summed in float64 and the sum rounded once to
// float32: the exact score, correctly rounded, where JAX sums in float32
// in XLA's order. A float32 sum of 2048 terms in another order than the
// twin's would move a bf16 rounding for about 2.6 scores in 10^4 (this
// kernel's first build, summing in float32, against the twin's float32
// product on an H100); float64 FMAs run at half the float32 rate on
// Hopper and the loop waits on L2, not on them. In bf16 each score is then
// rounded to bf16 and back before it is stored, as JAX rounds its score
// tensor to the inputs' dtype before the gather. An index outside [0, M)
// stores NaN, as JAX's gather fills, and is skipped by the backward.
//
// The backward, for the cotangent g [Q, N] (float32):
//
//   dpred[q, :] = sum_n g'[q, n] * flat[idx[q, n], :]
//
// summed in float32 over n in order and written in pred's dtype, where g'
// is g rounded to bf16 in the bf16 case (JAX's vjp of the astype rounds
// the cotangent). flat is data and gets no gradient.
//
// Layout: one warp a query, 8 warps a block. The forward walks the query's
// negatives four at a time (four independent 16-byte load streams in
// flight), each lane summing its 16-byte slices of the row (8 bf16 or 4
// float32, neighbouring lanes on neighbouring addresses) and the warp
// adding its lanes' float64 sums by shuffles. The backward walks the
// columns in tiles of 32 lanes x 4 vectors, keeps the tile's float32 sums
// in registers and walks all N negatives for each tile. pred and flat rows
// must start on 16-byte boundaries (d a multiple of the vector width; the
// wrapper checks). The query's own pred slices come from L1, the gathered
// rows from L2: at b256 x r36, d 2048 bf16, flat is 37.7 MB and fits the
// 50 MB L2, while the gathered bytes (4.8 GB) are a hundred times that.

#include "common.cuh"

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
