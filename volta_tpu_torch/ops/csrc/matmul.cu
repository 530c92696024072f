// bf16 matrix products with float32 accumulation on the tensor cores, for
// Hopper (sm_90a): the two kernels of the tools' decision probes.
//
// Replaces two TPU kernels:
//   row 15  _wgrad_kernel (tools/wgrad_probe.py:36), launched by
//           make_pallas_wgrad (:50, pallas_call :55): the weight gradient
//           out[h, f] = sum_t g[t, h] * a[t, f] over the token axis, g
//           [n, h] and a [n, f] bf16, out float32. The TPU walks the token
//           axis as a sequential grid of bk-row blocks and adds each
//           block's product into one VMEM-resident float32 output (zeroed
//           at program 0).
//   row 16  _ffn1_kernel (tools/pallas_ffn_probe.py:46), launched by
//           make_pallas_matmul (:59, pallas_call :66): out[n, m] =
//           x[n, k] . w[k, m] + b[m], optionally tanh-gelu, accumulated and
//           finished in float32 (bias add, gelu with the probe's constants,
//           :38-43) and stored bf16.
//
// Two bodies; ops/matmul.py's matmul_body chooses.
//
// The Hopper body (matmul_wgmma.cuh) takes every operand set that TMA can
// read: bf16 rows of a multiple of 16 bytes from a 16-byte aligned base.
// TMA loads with the 128-byte swizzle fill a ring of 4 shared-memory
// stages, 64 deep; one producer thread issues them; two consumer
// warpgroups run wgmma m64n256k16, bf16 in and float32 accumulators in
// registers, reading the MN-major operands (both of row 15, w of row 16) in
// their storage layout through the transpose bit, so no thread transposes.
// Two blocks form a cluster on a 256 x 256 output tile and multicast the
// shared B, and a persistent grid of one block an SM walks the work plan
// that the wrapper makes: row 16's units are whole tiles, whose bias and
// gelu epilogue in registers overlaps the next tile's loads; row 15 cuts
// the token axis so that each cluster gets an equal share of (tile, k
// block) steps (stream-K), writes float32 partial tiles (25.2 MB at the
// probes' shapes, written once and read once) and sums them in slot order
// in a second kernel: no float atomics, a call equals itself to the bit.
//
// The mma.sync body (below) takes the rest: each block owns one 128 x 128
// tile and walks the whole reduction axis in steps of 32, staging both
// operands' [128, 32] slices in shared memory, reduction axis contiguous;
// operands whose reduction axis is not contiguous are transposed on the
// way in, element by element. Eight warps run mma.sync m16n8k16 on 64 x 32
// sub-tiles. Ragged edges are zero-filled on the way in and masked on the
// way out.
//
// Bound: operations. At the probes' shapes (n = 15360, h = 768, f = 3072;
// k = 768 or 3072) each product is 72.5 GFLOP, 0.0733 ms at the H100's
// 989 TFLOP/s dense bf16, against 0.038 ms for its bytes (row 15: 118 MB
// read, 9.4 MB written).

#include "common.cuh"
#include "matmul_wgmma.cuh"

namespace {

constexpr int kBM = 128;     // output tile rows
constexpr int kBN = 128;     // output tile columns
constexpr int kBK = 32;      // reduction depth per step
constexpr int kLds = kBK + 8;  // shared-memory row stride, bf16
constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // m16 tiles a warp
constexpr int kNT = kWarpN / 8;   // n8 tiles a warp

enum Mode { kWgrad = 0, kBias = 1, kBiasGelu = 2 };

// Stage rows [r0, r0 + 128) x reduction [k0, k0 + 32) of an R x K operand
// into s[128][kLds], reduction axis contiguous, zeros past R and K. With
// kKContig element (r, k) lies at p[r * ld + k], else at p[k * ld + r];
// vec says that ld and p allow 16-byte loads.
template <bool kKContig>
__device__ __forceinline__ void stage(const __nv_bfloat16* __restrict__ p,
                                      long long ld, int R, int K, int r0,
                                      int k0, bool vec,
                                      __nv_bfloat16* __restrict__ s) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int ch = threadIdx.x; ch < kBM * kBK / 8; ch += kThreads) {
    // the chunk's first element in the tile. Transposing, a warp takes
    // the 32 depths of 8 rows, so that its 2-byte stores fill one shared
    // row without bank conflicts; its 16-byte reads then touch 32 global
    // rows, the other halves of whose sectors the next warp reads.
    int r, c;
    if (kKContig) {
      r = ch / (kBK / 8);
      c = (ch % (kBK / 8)) * 8;
    } else {
      c = ch % kBK;
      r = (ch / kBK) * 8;
    }
    const int gr = r0 + r, gk = k0 + c;
    alignas(16) __nv_bfloat16 x[8];
    const bool full = kKContig ? (gr < R && gk + 8 <= K)
                               : (gk < K && gr + 8 <= R);
    if (vec && full) {
      const __nv_bfloat16* src = kKContig ? p + gr * ld + gk
                                          : p + static_cast<long long>(gk) * ld + gr;
      *reinterpret_cast<uint4*>(x) =
          __ldg(reinterpret_cast<const uint4*>(src));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int rr = kKContig ? gr : gr + e;
        const int kk = kKContig ? gk + e : gk;
        x[e] = (rr < R && kk < K)
                   ? p[kKContig ? rr * ld + kk
                                : static_cast<long long>(kk) * ld + rr]
                   : zero;
      }
    }
    if (kKContig) {
      *reinterpret_cast<uint4*>(s + r * kLds + c) =
          *reinterpret_cast<const uint4*>(x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) s[(r + e) * kLds + c] = x[e];
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

// out[M, N] = A[M, K] . B[K, N] (+ bias, + gelu). A(m, k) lies at
// a[m * lda + k] (kAKContig) or a[k * lda + m]; B(k, n) at b[k * ldb + n].
template <int kMode, bool kAKContig>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const __nv_bfloat16* __restrict__ a, long long lda,
              const __nv_bfloat16* __restrict__ b, long long ldb,
              const __nv_bfloat16* __restrict__ bias, void* __restrict__ out,
              int M, int N, int K, bool vec_a, bool vec_b) {
  __shared__ __align__(16) __nv_bfloat16 as[kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 bs[kBN * kLds];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the fragments' row group
  const int tig = lane & 3;   // the thread in the group
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;  // warp's rows in tile
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;  // warp's columns
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    stage<kAKContig>(a, lda, M, K, m0, k0, vec_a, as);
    stage<false>(b, ldb, N, K, n0, k0, vec_b, bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t fa[kMT][4], fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const __nv_bfloat16* r = as + (wm + i * 16 + gid) * kLds + kk + tig * 2;
        fa[i][0] = ld32(r);
        fa[i][1] = ld32(r + 8 * kLds);
        fa[i][2] = ld32(r + 8);
        fa[i][3] = ld32(r + 8 * kLds + 8);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat16* c = bs + (wn + j * 8 + gid) * kLds + kk + tig * 2;
        fb[j][0] = ld32(c);
        fb[j][1] = ld32(c + 8);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
    }
  }

  // epilogue: accumulator (i, j, e) is row gid (+8 for e >= 2), column
  // tig * 2 (+1 for odd e) of the warp's m16 x n8 tile (i, j)
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + i * 16 + gid + (e >= 2 ? 8 : 0);
        const int n = n0 + wn + j * 8 + tig * 2 + (e & 1);
        if (m >= M || n >= N) continue;
        const size_t o = static_cast<size_t>(m) * N + n;
        if constexpr (kMode == kWgrad) {
          static_cast<float*>(out)[o] = acc[i][j][e];
        } else {
          float y = acc[i][j][e] + __bfloat162float(bias[n]);
          if constexpr (kMode == kBiasGelu) y = gelu_tanh(y);
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
        }
      }
}

bool aligned16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
}

template <int kMode, bool kAKContig>
cudaError_t launch(const void* a, long long lda, const void* b, long long ldb,
                   const void* bias, void* out, int M, int N, int K,
                   int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<kMode, kAKContig>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(a), lda,
          static_cast<const __nv_bfloat16*>(b), ldb,
          static_cast<const __nv_bfloat16*>(bias), out, M, N, K,
          aligned16(a, lda), aligned16(b, ldb));
  return cudaGetLastError();
}

}  // namespace

// Row 15: out[h, f] (float32) = g[n, h]^T . a[n, f], g and a bf16
// row-major. Returns the launch's cudaError_t.
extern "C" int volta_wgrad(const void* g, const void* a, void* out, int n,
                           int h, int f, int device, void* stream) {
  return launch<kWgrad, false>(g, h, a, f, nullptr, out, h, f, n, device,
                               stream);
}

// Row 16: out[n, m] (bf16) = x[n, k] . w[k, m] + bias[m], tanh-gelu with
// act != 0; x, w, bias bf16 row-major.
extern "C" int volta_matmul_bias_act(const void* x, const void* w,
                                     const void* bias, void* out, int n,
                                     int k, int m, int act, int device,
                                     void* stream) {
  if (act)
    return launch<kBiasGelu, true>(x, k, w, m, bias, out, n, m, k, device,
                                   stream);
  return launch<kBias, true>(x, k, w, m, bias, out, n, m, k, device, stream);
}

// The Hopper body's persistent grid: how many clusters of two blocks the
// card runs at once, into *clusters. Returns a cudaError_t.
extern "C" int volta_matmul_clusters(int device, int* clusters) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return wg::max_clusters(clusters);
}

// Row 15 on the Hopper body (matmul_wgmma.cuh): the partial tiles of the
// work plan (units, cluster_first: `clusters` lists; tile_slots: each pair
// tile's first and end slot) into ws [2 slots, 128, 256] float32, then
// their sums in slot order into out [h, f]. g, a 16-byte aligned, h and f
// multiples of 8. Returns 0, a cudaError_t, or a negative code where a
// tensor map does not encode (-CUresult, or wg::kNoEncode without the
// driver's entry point).
extern "C" int volta_wgrad_wgmma(const void* g, const void* a, void* ws,
                                 void* out, const void* units,
                                 const void* cluster_first,
                                 const void* tile_slots, int clusters, int n,
                                 int h, int f, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  CUtensorMap ma, mb;
  int rc = wg::make_map(&ma, g, n, h, 64);
  if (rc == 0) rc = wg::make_map(&mb, a, n, f, 64);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  rc = wg::launch<wg::kPartial, 1>(
      ma, mb, static_cast<const int*>(units),
      static_cast<const int*>(cluster_first), clusters, nullptr, ws, h, f, s);
  if (rc != 0) return rc;
  const long long quads = static_cast<long long>(h) * (f / 4);
  wg::partial_sum_kernel<<<static_cast<unsigned>((quads + 255) / 256), 256,
                           0, s>>>(static_cast<const float*>(ws),
                                   static_cast<const int*>(tile_slots),
                                   static_cast<float*>(out), h, f);
  return cudaGetLastError();
}

// Row 16 on the Hopper body: out[n, m] (bf16) = x[n, k] . w[k, m] + bias,
// tanh-gelu with act != 0, over the work plan's whole pair tiles. x, w,
// bias 16-byte aligned, k and m multiples of 8. Returns as
// volta_wgrad_wgmma.
extern "C" int volta_matmul_bias_act_wgmma(const void* x, const void* w,
                                           const void* bias, void* out,
                                           const void* units,
                                           const void* cluster_first,
                                           int clusters, int n, int k, int m,
                                           int act, int device,
                                           void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  CUtensorMap mx, mw;
  int rc = wg::make_map(&mx, x, n, k, 128);
  if (rc == 0) rc = wg::make_map(&mw, w, k, m, 64);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* u = static_cast<const int*>(units);
  const int* bf = static_cast<const int*>(cluster_first);
  if (act)
    return wg::launch<wg::kBiasGelu, 0>(mx, mw, u, bf, clusters, bias, out,
                                        n, m, s);
  return wg::launch<wg::kBias, 0>(mx, mw, u, bf, clusters, bias, out, n, m,
                                  s);
}
