// The int8 dense layer for Hopper (sm_90a): K9, two kernels for a piece of
// compute that the JAX package leaves to XLA.
//
// Replaces volta_tpu/ops/int8_dense.py:quantize_kernel / int8_dense_apply
// (:44-74), which has no Pallas kernel: XLA composes the per-token abs-max,
// the divide, the round and an int8 dot_general with an int32 result, then
// the dequantizing epilogue. The port's --quantize int8 serving forward
// runs every Dense through these two kernels (ops/int8_dense.py):
//
// K9a, quantize: x [M, K] (float32 or bf16) -> xq [M, K] int8 and a [M]
//   float32. Dynamic: a = max|x| / 127 + 1e-12 over the row, as XLA
//   compiles JAX's jitted expression: the division by the constant becomes
//   a product with float32(1/127), fused with the addition into one FMA,
//   __fmaf_rn(m, 1/127, 1e-12) (ops/int8_dense.absmax_scale, its twin);
//   static: a is the one float32 the caller gives (on the card), written to
//   every row. xq = clip(rint(x / a), -127, 127), the division __fdiv_rn,
//   a true division as XLA's by a tensor; rintf rounds half to even, as
//   jnp.round. A row of zeros gives a = 1e-12 and xq = 0.
//   A warp a row, 8 rows a block: the warp takes the row's abs-max (16-byte
//   loads where the row allows them, else one element a lane a step), then
//   reads the row again (from L1 / L2) and writes its int8 values.
//   Bound: bytes, M K (2 or 4) read, M K + 4 M written.
//
// K9b, the product with its epilogue: xq [M, K] int8 . q [N, K] int8 (the
//   Dense weight's [out, in] layout, K-major, the B operand mma wants) ->
//   int32, then y = fma(float(acc), a[m] * scale[n], bias[n]), then float32
//   or bf16: __fmul_rn(a, scale), then one __fmaf_rn with the accumulator
//   (__int2float_rn) and the bias, as XLA compiles JAX's jitted
//   acc * (a * scale) + bias on the CPU; written out with the intrinsics so
//   that nvcc neither splits nor contracts them otherwise, and the result
//   equals the plain twin's to the bit (int32 sums are exact in any
//   order).
//   Each block owns a 128 x 128 tile of y and walks K in steps of 64 bytes:
//   both operands' [128, 64] slices staged in shared memory (16-byte loads
//   where K is a multiple of 16, else byte by byte; zeros past M, N and K,
//   so K = 5 runs as one zero-padded step); eight warps, 2 along M x 4
//   along N, each run mma.sync m16n8k32 s8.s8.s32 on a 64 x 32 sub-tile.
//   Any M, N, K. Bound: operations at the shapes of a dispatch (2 M N K
//   int8 operations over the card's 1,979 dense int8 TOPS), or the bytes of
//   y at small K. A simple right body: no cp.async pipeline, no TMA, no
//   wgmma; those come later.

#include "common.cuh"

namespace {

// ----------------------------------------------------------------- K9a
constexpr int kQThreads = 256;
constexpr int kQRows = kQThreads / 32;  // a warp a row

__device__ __forceinline__ int8_t quant(float x, float a) {
  const float r = rintf(__fdiv_rn(x, a));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(kQThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ a_static,
                int8_t* __restrict__ xq, float* __restrict__ a_out,
                long long M, int K, bool vec) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kQRows + (threadIdx.x >> 5);
  if (row >= M) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + row * K;
  int8_t* qr = xq + row * K;
  constexpr int W = Vec16<T>::N;
  float a;
  if (a_static != nullptr) {
    a = *a_static;
  } else {
    float m = 0.f;
    if (vec) {
      for (int c = lane; c < K / W; c += 32) {
        float v[W];
        Vec16<T>::load(xr + c * W, v);
#pragma unroll
        for (int e = 0; e < W; ++e) m = fmaxf(m, fabsf(v[e]));
      }
    } else {
      for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_float(xr[k])));
    }
    m = warp_max(m);
    a = __fmaf_rn(m, 0x1.020408p-7f, 0x1.197998p-40f);  // 1/127, 1e-12
  }
  if (lane == 0) a_out[row] = a;
  if (vec) {
    for (int c = lane; c < K / W; c += 32) {
      float v[W];
      Vec16<T>::load(xr + c * W, v);
      // W int8 values: 8 bytes (bf16) or 4 (float32), aligned as the row
      alignas(8) int8_t out[W];
#pragma unroll
      for (int e = 0; e < W; ++e) out[e] = quant(v[e], a);
      if constexpr (W == 8) {
        *reinterpret_cast<uint2*>(qr + c * W) =
            *reinterpret_cast<const uint2*>(out);
      } else {
        *reinterpret_cast<uint32_t*>(qr + c * W) =
            *reinterpret_cast<const uint32_t*>(out);
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) qr[k] = quant(to_float(xr[k]), a);
  }
}

// ----------------------------------------------------------------- K9b
constexpr int kBM = 128;        // output tile rows
constexpr int kBN = 128;        // output tile columns
constexpr int kBK = 64;         // reduction bytes a step: two k32 mma steps
constexpr int kLds = kBK + 16;  // shared row stride, bytes (conflict-free)
constexpr int kThreads = 256;   // 8 warps: 2 along rows x 4 along columns
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMT = kWarpM / 16;  // m16 tiles a warp
constexpr int kNT = kWarpN / 8;   // n8 tiles a warp

// d += a . b: one m16n8k32 product of int8 fragments, int32 accumulators
// (the PTX ISA's fragment layouts: A row-major, B column-major, i.e. the
// [N, K] rows of q).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage rows [r0, r0 + 128) x bytes [k0, k0 + 64) of an R x K int8 operand
// (row-major) into s[128][kLds], zeros past R and K.
__device__ __forceinline__ void stage(const int8_t* __restrict__ p, int R,
                                      int K, int r0, int k0, bool vec,
                                      int8_t* __restrict__ s) {
  for (int ch = threadIdx.x; ch < kBM * kBK / 16; ch += kThreads) {
    const int r = ch / (kBK / 16);
    const int c = (ch % (kBK / 16)) * 16;
    const int gr = r0 + r, gk = k0 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < R) {
      const int8_t* src = p + static_cast<long long>(gr) * K + gk;
      if (vec && gk + 16 <= K) {
        v = __ldg(reinterpret_cast<const uint4*>(src));
      } else if (gk < K) {
        int8_t* b = reinterpret_cast<int8_t*>(&v);
        const int n = min(16, K - gk);
        for (int e = 0; e < n; ++e) b[e] = src[e];
      }
    }
    *reinterpret_cast<uint4*>(s + r * kLds + c) = v;
  }
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float epilogue(int acc, float a, float scale,
                                          const float* bias, int n) {
  const float s = __fmul_rn(a, scale);
  return bias != nullptr ? __fmaf_rn(__int2float_rn(acc), s, bias[n])
                         : __fmul_rn(__int2float_rn(acc), s);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ a,
                   const int8_t* __restrict__ q,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ y, int M,
                   int N, int K, bool vec) {
  __shared__ __align__(16) int8_t as[kBM * kLds];
  __shared__ __align__(16) int8_t bs[kBN * kLds];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // the fragments' row group
  const int tig = lane & 3;   // the thread in the group
  const int wm = (warp / (kBN / kWarpN)) * kWarpM;
  const int wn = (warp % (kBN / kWarpN)) * kWarpN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's tiles are consumed
    stage(xq, M, K, m0, k0, vec, as);
    stage(q, N, K, n0, k0, vec, bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t fa[kMT][4], fb[kNT][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int8_t* r = as + (wm + i * 16 + gid) * kLds + kk + tig * 4;
        fa[i][0] = ld32(r);
        fa[i][1] = ld32(r + 8 * kLds);
        fa[i][2] = ld32(r + 16);
        fa[i][3] = ld32(r + 8 * kLds + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* c = bs + (wn + j * 8 + gid) * kLds + kk + tig * 4;
        fb[j][0] = ld32(c);
        fb[j][1] = ld32(c + 16);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_s8(acc[i][j], fa[i], fb[j]);
    }
  }

  // accumulator (i, j, e) is row gid (+8 for e >= 2), column tig * 2 (+1
  // for odd e) of the warp's m16 x n8 tile (i, j); pairs of columns are
  // stored together where N is even
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + gid + h * 8;
        const int n = n0 + wn + j * 8 + tig * 2;
        if (m >= M || n >= N) continue;
        const float am = a[m];
        const float y0 = epilogue(acc[i][j][2 * h], am, scale[n], bias, n);
        T* dst = y + static_cast<long long>(m) * N + n;
        if (n + 1 >= N) {
          dst[0] = from_float<T>(y0);
          continue;
        }
        const float y1 =
            epilogue(acc[i][j][2 * h + 1], am, scale[n + 1], bias, n + 1);
        if constexpr (sizeof(T) == 2) {
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(y0, y1);
            continue;
          }
        } else {
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
            continue;
          }
        }
        dst[0] = from_float<T>(y0);
        dst[1] = from_float<T>(y1);
      }
}

}  // namespace

// K9a. x: M x K of dtype (0 = float32, 1 = bfloat16), row-major; a_static:
// one float32 on the card or null (dynamic); xq: M x K int8; a: M float32.
// vec: rows allow 16-byte loads (K * itemsize % 16 == 0, x 16-byte
// aligned). Returns the launch's cudaError_t.
extern "C" int volta_int8_quantize(const void* x, const float* a_static,
                                   int8_t* xq, float* a, long long M, int K,
                                   int dtype, int vec, int device,
                                   void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (M <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  const long long blocks = (M + kQRows - 1) / kQRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    quantize_kernel<float><<<static_cast<unsigned>(blocks), kQThreads, 0, s>>>(
        static_cast<const float*>(x), a_static, xq, a, M, K, vec != 0);
  } else if (dtype == 1) {
    quantize_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kQThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), a_static, xq, a, M, K,
            vec != 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K9b. xq: M x K int8, a: M float32, q: N x K int8, scale: N float32,
// bias: N float32 or null; y: M x N of out_dtype (0 = float32, 1 =
// bfloat16). vec: K is a multiple of 16 (16-byte rows).
extern "C" int volta_int8_matmul(const int8_t* xq, const float* a,
                                 const int8_t* q, const float* scale,
                                 const float* bias, void* y, int M, int N,
                                 int K, int out_dtype, int vec, int device,
                                 void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535u || K <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    int8_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        xq, a, q, scale, bias, static_cast<float*>(y), M, N, K, vec != 0);
  } else if (out_dtype == 1) {
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        xq, a, q, scale, bias, static_cast<__nv_bfloat16*>(y), M, N, K,
        vec != 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
