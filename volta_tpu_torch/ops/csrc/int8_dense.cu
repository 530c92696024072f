// The int8 dense layer for Hopper (sm_90a): K9, the kernels of a piece of
// compute that the JAX package leaves to XLA.
//
// Replaces volta_tpu/ops/int8_dense.py:quantize_kernel / int8_dense_apply
// (:44-74), which has no Pallas kernel: XLA composes the per-token abs-max,
// the divide, the round and an int8 dot_general with an int32 result, then
// the dequantizing epilogue. The port's --quantize int8 serving forward
// runs every Dense through K9a and K9b (ops/int8_dense.py):
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
//   Dense weight's [out, in] layout: both operands K-major) -> int32, then
//   y = fma(float(acc), a[m] * scale[n], bias[n]), then float32 or bf16:
//   __fmul_rn(a, scale), then one __fmaf_rn with the accumulator
//   (__int2float_rn) and the bias, as XLA compiles JAX's jitted
//   acc * (a * scale) + bias on the CPU; written out with the intrinsics so
//   that nvcc neither splits nor contracts them otherwise, and the result
//   equals the plain twin's to the bit (int32 sums are exact in any
//   order). Bound: operations at the shapes of a dispatch (2 M N K int8
//   operations over the card's 1,979 dense int8 TOPS), or the bytes of y
//   at small K. Two bodies, the wrapper's rule (ops/int8_dense.int8_body)
//   naming the one that runs:
//
//   - the Hopper body (int8_wgmma_kernel), where TMA can read both operands
//     (contiguous, 16-byte aligned, K a multiple of 16): every Dense of a
//     retrieval dispatch but the K = 5 location embedding. matmul_wgmma.cuh's
//     design in int8: TMA loads 128-byte-deep k slices of both operands
//     into a ring of three 48 KB stages with the 128-byte swizzle, one
//     producer thread keeping the ring full across tiles; two consumer
//     warpgroups run wgmma.mma_async m64n256k32 s32.s8.s8 (int8 wgmma takes
//     K-major operands only, which xq and q are: nothing is transposed)
//     into 128 int32 accumulators a thread, a 128 x 256 tile a block. The
//     two blocks of a cluster take rows [0, 128) and [128, 256) of a
//     256 x 256 pair tile, each loading half of q's 256 rows and
//     multicasting it into both; q's loads are kept in L2 (every row band
//     reads it), xq's streamed. A persistent grid of as many clusters as
//     the card runs at once walks the pair tiles round robin, row-major
//     (cluster c: tiles c, c + clusters, ...). The epilogue's vectors (a,
//     scale, bias) load under the tile's products and go through shared
//     memory; a bf16 tile with N a multiple of 8 is written to shared
//     memory (64 KB a block) and copied to y by two store warps of the
//     producer warpgroup, 512 contiguous bytes a warp store, while the
//     consumers go on to the next tile's products; any other tile is
//     stored by the consumers, pairs or single values. TMA fills zeros past
//     M, N and K; the stores are masked. Any M, N.
//     What bounds it: at K 3072 the products run at the int8 peak between
//     tiles (0.57 us a 128 x 256 x 128 step); each tile adds its epilogue
//     (the tensor cores idle: int32 -> float, the FMA, bf16) and, with all
//     132 SMs busy, the 64 KB of y it writes competes with the operands'
//     L2 reads, so at K 768 a tile takes about twice its products' time.
//   - the mma.sync body (int8_matmul_kernel) for the rest: a block owns a
//     128 x 128 tile of y and walks K in steps of 64 bytes, both operands'
//     [128, 64] slices staged in shared memory (16-byte loads where K is a
//     multiple of 16, else byte by byte; zeros past M, N and K, so K = 5
//     runs as one zero-padded step); eight warps, 2 along M x 4 along N,
//     each run mma.sync m16n8k32 s8.s8.s32 on a 64 x 32 sub-tile. Any N,
//     K; M up to 65535 tiles.

#include "common.cuh"
#include "matmul_wgmma.cuh"

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

// y = fma(float(acc), a * scale, b), or float(acc) * (a * scale) without
// a bias
__device__ __forceinline__ float epilogue(int acc, float a, float scale,
                                          float b, bool has_bias) {
  const float s = __fmul_rn(a, scale);
  return has_bias ? __fmaf_rn(__int2float_rn(acc), s, b)
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
        const bool hb = bias != nullptr;
        const float y0 = epilogue(acc[i][j][2 * h], am, scale[n],
                                  hb ? bias[n] : 0.f, hb);
        T* dst = y + static_cast<long long>(m) * N + n;
        if (n + 1 >= N) {
          dst[0] = from_float<T>(y0);
          continue;
        }
        const float y1 = epilogue(acc[i][j][2 * h + 1], am, scale[n + 1],
                                  hb ? bias[n + 1] : 0.f, hb);
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

// ------------------------------------------------- K9b, the Hopper body
constexpr int kHM = 128;  // block tile rows: 64 for each consumer group
constexpr int kHN = 256;  // block tile columns: one m64n256k32 product
constexpr int kHK = 128;  // k bytes a stage: four k32 steps, one swizzled row
constexpr int kHStages = 3;
constexpr int kHA = kHM * kHK;  // 16 KB of xq a stage
constexpr int kHB = kHN * kHK;  // 32 KB of q a stage
constexpr int kHStage = kHA + kHB;
constexpr int kHThreads = 384;  // consumer groups 0-1, producer group 2
// blocks a cluster (wg::tma_load_both and wg::cluster_config's two): on
// consecutive 128-row tiles of one column tile, each loading half of the q
// rows and multicasting them into both. Clusters of four read a quarter
// less from L2 but fit only 30 at once, 120 SMs, on an H100 SXM: slower.
constexpr int kHCluster = 2;
static_assert(kHCluster == 2 && kHThreads == wg::kThreads,
              "the clusters and blocks of wg::cluster_config");
// a consumer group's bf16 output, [64, 256] as four TMA boxes of 64 x 64
// with the 128-byte swizzle
constexpr int kHOut = 64 * kHN * 2;
// a consumer group's epilogue vectors: scale and bias of the tile's 256
// columns, a of its 64 rows (zeros past N and M)
constexpr int kHVec = 2 * kHN + 64;
constexpr size_t kHSmem = kHStages * kHStage + 2 * kHOut + 2 * kHVec * 4 +
                          2 * kHStages * 8 + 1024;

// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define VOLTA_IACC8(i)                                                 \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x 256] = A[64 x 32] . B[256 x 32]^T (+ d where add), int8 from
// shared memory, both K-major (the only layout of the integer wgmma, which
// takes no transpose or operand scales: only the scale-d predicate)
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
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
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : VOLTA_IACC8(0), VOLTA_IACC8(8), VOLTA_IACC8(16), VOLTA_IACC8(24),
        VOLTA_IACC8(32), VOLTA_IACC8(40), VOLTA_IACC8(48), VOLTA_IACC8(56),
        VOLTA_IACC8(64), VOLTA_IACC8(72), VOLTA_IACC8(80), VOLTA_IACC8(88),
        VOLTA_IACC8(96), VOLTA_IACC8(104), VOLTA_IACC8(112), VOLTA_IACC8(120)
      : "l"(da), "l"(db), "r"(add));
}

#undef VOLTA_IACC8

// The epilogue of a staged tile (bf16, N a multiple of 8): the thread's
// rows r and r + 8 of its group's 64, columns 8 j + 2 quad (+ 1), as bf16
// pairs into out, the group's 64 x 256 tile in four blocks of 64 rows x 128
// bytes: column c of row r in block c / 64 at 16-byte chunk (c % 64 / 8) ^
// (r % 8), so that neither a warp's 4-byte writes nor a quarter warp's
// 16-byte reads of a row (copy_out) meet a bank twice.
__device__ __forceinline__ void stage_bf16(const int (&d)[128],
                                           const float* v, bool hb,
                                           uint8_t* out, int r, int quad) {
  const float am[2] = {v[2 * kHN + r], v[2 * kHN + r + 8]};
#pragma unroll
  for (int j = 0; j < kHN / 8; ++j) {
    const float2 sc = *reinterpret_cast<const float2*>(v + 8 * j + 2 * quad);
    const float2 bi =
        *reinterpret_cast<const float2*>(v + kHN + 8 * j + 2 * quad);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h;
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          epilogue(d[4 * j + 2 * h], am[h], sc.x, bi.x, hb),
          epilogue(d[4 * j + 2 * h + 1], am[h], sc.y, bi.y, hb));
      *reinterpret_cast<__nv_bfloat162*>(
          out + (j / 8) * (64 * 128) + rr * 128 +
          (((j % 8) ^ (rr % 8)) << 4) + 4 * quad) = p;
    }
  }
}

// A store warp's copy of its consumer group's staged tile to y: rows m0 +
// [0, 64), columns n0 + [0, 256), 16 bytes a lane, a row a step (512
// contiguous bytes a warp store); nothing past M or N.
__device__ __forceinline__ void copy_out(const uint8_t* out,
                                         __nv_bfloat16* __restrict__ y,
                                         int m0, int n0, int M, int N,
                                         int lane) {
  const int n = n0 + 8 * lane;
  if (n >= N) return;
  const uint8_t* src = out + (lane / 8) * (64 * 128);
  const int rows = min(64, M - m0);
#pragma unroll 4
  for (int rr = 0; rr < rows; ++rr)
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(m0 + rr) * N + n) =
        *reinterpret_cast<const uint4*>(src + rr * 128 +
                                        (((lane % 8) ^ (rr % 8)) << 4));
}

// The epilogue of any other tile, straight to y: pairs of columns where N
// is even, else single values; rows m and m + 8.
template <typename T>
__device__ __forceinline__ void store_pairs(const int (&d)[128],
                                            const float* v, bool hb,
                                            T* __restrict__ y, int r, int m,
                                            int n0, int M, int N, int quad) {
  const float am[2] = {v[2 * kHN + r], v[2 * kHN + r + 8]};
  const bool pairs = N % 2 == 0;
#pragma unroll
  for (int j = 0; j < kHN / 8; ++j) {
    const int c = 8 * j + 2 * quad, n = n0 + c;
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m + 8 * h >= M) continue;
      T* dst = y + static_cast<size_t>(m + 8 * h) * N + n;
      const float y0 = epilogue(d[4 * j + 2 * h], am[h], v[c], v[kHN + c], hb);
      if (n + 1 >= N) {
        dst[0] = from_float<T>(y0);
        continue;
      }
      const float y1 = epilogue(d[4 * j + 2 * h + 1], am[h], v[c + 1],
                                v[kHN + c + 1], hb);
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
}

// y = K9b(xq, q) over the pair tiles of a persistent grid of clusters of
// two blocks: cluster c takes pair tiles c, c + clusters, ..., row-major
// over [ceil(M / 256), ceil(N / 256)]; block rank r takes rows [128 r,
// 128 r + 128) of each and loads its own xq rows and half of the q rows,
// multicast into both. map_x over xq [M, K], map_q over q [N, K], boxes of
// 128 rows x 128 bytes. With staged (bf16, N a multiple of 8) each
// consumer group writes its 64 x 256 output to shared memory and goes on to
// its next tile's products while a store warp of the producer group copies
// it to y; else the consumers store y themselves.
template <typename T>
__global__ void __launch_bounds__(kHThreads, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_q,
                  const float* __restrict__ a,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int M,
                  int N, int K, bool staged) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = wg::smem_addr(smem);
  uint8_t* outs = smem + kHStages * kHStage;  // 1024-byte aligned
  float* vecs = reinterpret_cast<float*>(outs + 2 * kHOut);
  const uint32_t full = wg::smem_addr(vecs + 2 * kHVec);  // kHStages barriers
  const uint32_t empty = full + kHStages * 8;
  const int tiles_n = (N + kHN - 1) / kHN;
  const int tiles = (M + kHCluster * kHM - 1) / (kHCluster * kHM) * tiles_n;
  const int kblocks = (K + kHK - 1) / kHK;
  const int rank = wg::cluster_rank();
  const int cluster = blockIdx.x / kHCluster;
  const int clusters = gridDim.x / kHCluster;
  const int group = threadIdx.x / 128;  // warpgroup

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHStages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      // each consumer warpgroup of both blocks
      wg::mbar_init(empty + 8 * s, 2 * kHCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  wg::cluster_sync();  // both blocks' barriers exist before either is used

  auto next = [](int& stage, uint32_t& phase) {
    if (++stage == kHStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  if (group == 2) {
    // producer: one thread keeps the ring full across tiles, so the next
    // tile's loads run under this tile's epilogue
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      // L2: keep q, which every row band reads; stream xq, whose row band
      // the few tiles dealt to neighbouring clusters read together
      const uint64_t pol_x = wg::l2_policy(false);
      const uint64_t pol_q = wg::l2_policy(true);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = cluster; t < tiles; t += clusters) {
        const int m0 = (kHCluster * (t / tiles_n) + rank) * kHM;
        const int n0 = (t % tiles_n) * kHN;
        for (int kb = 0; kb < kblocks; ++kb) {
          // free in both blocks: the peer's half of q lands here too
          wg::mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          wg::mbar_expect_tx(bar, kHStage);
          const uint32_t sa = base + stage * kHStage;
          wg::tma_load(sa, &map_x, bar, kb * kHK, m0, pol_x);
          wg::tma_load_both(sa + kHA + rank * (kHB / kHCluster), &map_q,
                            bar, kb * kHK, n0 + kHN / kHCluster * rank,
                            pol_q);
          next(stage, phase);
        }
      }
      // stay until both blocks' consumers have released every stage, so
      // that no arrival from the peer comes after this block has exited
      for (int i = 0; i < kHStages; ++i) {
        wg::mbar_wait(empty + 8 * stage, phase ^ 1);
        next(stage, phase);
      }
    } else if (staged && threadIdx.x >= 288 && threadIdx.x < 352) {
      // store warps: warp 9 + g copies consumer group g's staged tiles.
      // Named barriers of 160 threads (the group and the warp): 3 + g,
      // the tile is staged; 5 + g, the staging is free again (once ahead)
      const int g = (threadIdx.x - 288) / 32, lane = threadIdx.x % 32;
      wg::named_arrive(5 + g, 160);
      for (int t = cluster; t < tiles; t += clusters) {
        wg::named_sync(3 + g, 160);
        copy_out(outs + g * kHOut, reinterpret_cast<__nv_bfloat16*>(y),
                 (kHCluster * (t / tiles_n) + rank) * kHM + 64 * g,
                 (t % tiles_n) * kHN, M, N, lane);
        if (t + clusters < tiles) wg::named_arrive(5 + g, 160);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    // the accumulator's rows and columns: d[4j + 2h + e] is row
    // r + 8h (r = 16 (t / 32) + lane / 4), column 8j + 2 quad + e of the
    // group's 64 x 256 product
    const int r = 16 * (t / 32) + lane / 4;
    // once its products are done, the warpgroup releases a stage in every
    // block of the cluster: its thread k signals block k
    auto release = [&](int s) {
      if (t < kHCluster) wg::mbar_arrive_cluster(empty + 8 * s, t);
    };
    const bool hb = bias != nullptr;
    uint8_t* out = outs + group * kHOut;
    float* v = vecs + group * kHVec;
    int d[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      const int m0 =
          (kHCluster * (tile / tiles_n) + rank) * kHM + 64 * group;
      const int n0 = (tile % tiles_n) * kHN;
      // the epilogue's vectors: thread t loads columns n0 + t and n0 + 128
      // + t, and row m0 + t; the loads run under the products
      float vec[5];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = n0 + 128 * i + t;
        vec[i] = n < N ? __ldg(scale + n) : 0.f;
        vec[2 + i] = hb && n < N ? __ldg(bias + n) : 0.f;
      }
      vec[4] = t < 64 && m0 + t < M ? __ldg(a + m0 + t) : 0.f;
      int prev = 0;
      for (int kb = 0; kb < kblocks; ++kb) {
        wg::mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kHStage;
        const uint32_t sb = sa + kHA;
        wg::wgmma_fence();
        // a k32 step is 32 bytes further inside the swizzled 128-byte rows;
        // 8 rows (1 KB) from one swizzle atom to the next. The tile's first
        // step overwrites d.
#pragma unroll
        for (int kk = 0; kk < kHK / 32; ++kk)
          wgmma_s8(d, wg::desc(sa + group * (kHA / 2) + kk * 32, 16, 1024),
                   wg::desc(sb + kk * 32, 16, 1024), kb > 0 || kk > 0);
        wg::wgmma_commit();
        if (kb > 0) {  // the previous stage's products are done
          wg::wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        next(stage, phase);
      }
      wg::wgmma_wait<0>();
      fence_acc(d);
      release(prev);

      // the group's previous tile is done with v (every thread) and with
      // out (its store warp) before either is rewritten
      if (staged)
        wg::named_sync(5 + group, 160);
      else
        wg::named_sync(1 + group, 128);
      v[t] = vec[0];
      v[128 + t] = vec[1];
      v[kHN + t] = vec[2];
      v[kHN + 128 + t] = vec[3];
      if (t < 64) v[2 * kHN + t] = vec[4];
      wg::named_sync(1 + group, 128);
      if constexpr (sizeof(T) == 2) {
        if (staged) {
          stage_bf16(d, v, hb, out, r, quad);
          wg::named_arrive(3 + group, 160);  // to the store warp
          continue;
        }
      }
      store_pairs<T>(d, v, hb, y, r, m0 + r, n0, M, N, quad);
    }
  }
}

template <typename T>
int launch_hopper(const CUtensorMap& mx, const CUtensorMap& mq,
                  const float* a, const float* scale, const float* bias,
                  void* y, int M, int N, int K, bool staged, int clusters,
                  cudaStream_t stream) {
  auto kern = int8_wgmma_kernel<T>;
  cudaError_t e = allow_smem(kern, kHSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wg::cluster_config(&attr, clusters, stream, kHSmem);
  e = cudaLaunchKernelEx(&cfg, kern, mx, mq, a, scale, bias,
                         static_cast<T*>(y), M, N, K, staged);
  return e != cudaSuccess ? e : cudaGetLastError();
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

// K9b on the Hopper body (int8_wgmma_kernel). xq: M x K int8, q: N x K
// int8, both contiguous and 16-byte aligned, K a multiple of 16; a, scale,
// bias, y, out_dtype as volta_int8_matmul; clusters: the persistent grid's
// clusters of two blocks (volta_int8_clusters), capped here at the pair
// tiles. Returns 0, a cudaError_t, or a negative code where a tensor map
// does not encode (-CUresult, or wg::kNoEncode without the driver's entry
// point).
extern "C" int volta_int8_matmul_wgmma(const int8_t* xq, const float* a,
                                       const int8_t* q, const float* scale,
                                       const float* bias, void* y, int M,
                                       int N, int K, int out_dtype,
                                       int clusters, int device,
                                       void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 16 != 0 || clusters < 1) return cudaErrorInvalidValue;
  CUtensorMap mx, mq;
  int rc = wg::make_map(&mx, xq, M, K, kHM, 1);
  if (rc == 0) rc = wg::make_map(&mq, q, N, K, kHN / kHCluster, 1);
  if (rc != 0) return rc;
  const long long tiles = (M + kHCluster * kHM - 1LL) / (kHCluster * kHM) *
                          ((N + kHN - 1) / kHN);
  const int grid = static_cast<int>(tiles < clusters ? tiles : clusters);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return launch_hopper<float>(mx, mq, a, scale, bias, y, M, N, K, false,
                                grid, s);
  if (out_dtype == 1)  // bf16 rows of 16-byte multiples go out staged
    return launch_hopper<__nv_bfloat16>(mx, mq, a, scale, bias, y, M, N, K,
                                        N % 8 == 0, grid, s);
  return cudaErrorInvalidValue;
}

// How many clusters of two blocks of the Hopper body the card runs at once,
// into *clusters: the persistent grid's size. Returns a cudaError_t.
extern "C" int volta_int8_clusters(int device, int* clusters) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  auto kern = int8_wgmma_kernel<__nv_bfloat16>;
  e = allow_smem(kern, kHSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      wg::cluster_config(&attr, 1, nullptr, kHSmem);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}
