// The Hopper body of rows 15 and 16 (matmul.cu): TMA loads into a ring of
// shared-memory stages, one producer thread, two consumer warpgroups
// running wgmma.mma_async m64n256k16 (bf16 in, float32 accumulators in
// registers), clusters of two blocks that share the B operand by TMA
// multicast, and a persistent grid that walks a work plan made by the
// wrapper (ops/matmul.py: wgmma_plan).
//
// The product is out[M, N] = A[M, K] . B[K, N] on 128 x 256 block tiles,
// 64 deep a stage. B is always stored [K, N] with N contiguous (row 15's a,
// row 16's w); A is stored [K, M] with M contiguous (row 15's g, kTransA)
// or [M, K] with K contiguous (row 16's x). TMA lands each operand in its
// storage layout with the 128-byte swizzle, in boxes of 64 contiguous
// elements (128 bytes) by 64 or 128 rows, and wgmma reads the MN-major ones
// with its transpose bit: nothing is transposed by threads.
//
// Shared-memory layouts, in the PTX ISA's canonical terms (16-bit types,
// 1024-byte swizzle atoms of 8 rows x 128 bytes):
//   MN-major (A with kTransA, and B): box j holds rows k (64 of them, 128
//     bytes each) of MN columns [64 j, 64 j + 64). Next 64 MN columns: the
//     leading byte offset (8 KB, the next box); next 8 k rows: the stride
//     byte offset (1 KB). A 16-deep k step starts 16 rows (2 KB) further.
//   K-major (A without kTransA): rows m, 128 bytes of k each; next 8 rows:
//     the stride byte offset (1 KB); a 16-deep k step starts 32 bytes
//     further inside the swizzled row.
//
// What bounds it. Alone, a block keeps the tensor cores near their rate
// (0.63 us a 128 x 256 x 64 step with 72 blocks on the card); with all 132
// busy, what the card's L2 serves sets the pace. So the two blocks of a
// cluster, on rows [0, 128) and [128, 256) of a 256 x 256 tile, load half
// of B each and multicast it into both, and the loads carry L2 eviction
// hints: the operand whose tiles read it again over the whole run is
// kept, the other streamed.
//
// Work units (tile, first k block, end k block, slot), a list for each
// cluster: row 16's units are whole tiles, dealt round robin, and its
// epilogue adds the bias, applies the gelu and stores bf16 while the
// producer already loads the next tile. Row 15's are equal shares of the
// (tile, k block) sequence (stream-K), each writing its float32 partial
// tile to the workspace slot it is given; a second kernel sums each tile's
// partials in slot order, so a call equals itself to the bit and no float
// atomic is used.

#pragma once

#include <cuda.h>

#include "common.cuh"

namespace wg {

constexpr int kBM = 128;   // output tile rows: 64 for each consumer group
constexpr int kBN = 256;   // output tile columns: one m64n256 product
constexpr int kBK = 64;    // k depth of a stage: 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kBox = 64 * 64 * 2;           // one 64 x 64 bf16 box, bytes
constexpr int kABytes = kBM * kBK * 2;      // 16 KB
constexpr int kBBytes = kBN * kBK * 2;      // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kThreads = 384;  // consumer groups 0-1, producer group 2
constexpr size_t kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

enum Mode { kPartial = 0, kBias = 1, kBiasGelu = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One arrival on this block's barrier.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Shared-memory writes of this thread's generic proxy made visible to the
// async proxy (wgmma's operand reads).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` over `count` threads of the block (whole warps).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrival at named barrier `id` of `count` threads without waiting for it;
// this thread's earlier memory accesses are performed for the threads that
// wait there.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One arrival on the barrier at the same offset in block `rank` of the
// cluster (this block's own or its peer's).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, int rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// An L2 eviction policy for TMA loads: keep the operand that other tiles
// read again later (evict_last), or let a streamed one go first.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}

// One 2-D TMA box into shared memory at dst, counted on bar, under the L2
// policy pol.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "l"(pol)
      : "memory");
}

// The same box into dst of both blocks of the cluster, each counting it on
// its own barrier at bar's offset.
__device__ __forceinline__ void tma_load_both(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c0, int c1,
                                              uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster.L2::cache_hint [%0], [%1, {%4, %5}], [%2], "
      "%3, %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(uint16_t(3)),
      "r"(c0), "r"(c1), "l"(pol)
      : "memory");
}

// wgmma's shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kN) : "memory");
}

// Keep the compiler from moving accumulator reads and writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define VOLTA_ACC8(i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] += A[64 x 16] . B[16 x 256], both from shared memory; A read
// MN-major with kTransA, K-major without; B MN-major with kTransB (rows 15
// and 16), K-major without (the NCE scores' candidate rows).
template <int kTransA, int kTransB = 1>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : VOLTA_ACC8(0), VOLTA_ACC8(8), VOLTA_ACC8(16), VOLTA_ACC8(24),
        VOLTA_ACC8(32), VOLTA_ACC8(40), VOLTA_ACC8(48), VOLTA_ACC8(56),
        VOLTA_ACC8(64), VOLTA_ACC8(72), VOLTA_ACC8(80), VOLTA_ACC8(88),
        VOLTA_ACC8(96), VOLTA_ACC8(104), VOLTA_ACC8(112), VOLTA_ACC8(120)
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

#undef VOLTA_ACC8

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// out = A . B (+ bias, + gelu) over this cluster's work units, int4s of
// (pair tile, first k block, end k block, partial slot): units
// [cluster_first[c], cluster_first[c + 1]) for cluster c. A pair tile is the
// 256 x 256 output of the cluster's two blocks: block rank r takes its
// 128-row tile 2 pm + r and loads its own A, and the two blocks load half
// of the shared B each, multicast into both. With kPartial, out is the
// float32 workspace [2 slots, 128, 256], rank r writing slot 2 s + r; else
// bf16 [M, N] with N a multiple of 8.
template <int kMode, int kTransA>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const int4* __restrict__ units,
             const int* __restrict__ cluster_first,
             const __nv_bfloat16* __restrict__ bias, void* __restrict__ out,
             int M, int N) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t full = base + kStages * kStageBytes;  // kStages barriers
  const uint32_t empty = full + kStages * 8;
  const int tiles_n = (N + kBN - 1) / kBN;
  const int rank = cluster_rank();
  const int cluster = blockIdx.x / 2;
  const int u0 = cluster_first[cluster], u1 = cluster_first[cluster + 1];
  const int group = threadIdx.x / 128;  // warpgroup

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      // each consumer warpgroup of both blocks
      mbar_init(empty + 8 * s, 2 * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers exist before either is used

  if (group == 2) {
    // producer: one thread keeps the ring full, across unit boundaries, so
    // the next unit's loads run under this unit's epilogue
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      // L2: keep the operand that tiles read again over the whole run,
      // stream the one that the tiles sharing it read at about the same
      // time: row 15 (kTransA) keeps g, whose row bands' tiles are spread
      // over the run, and streams a; row 16 keeps w and streams x, whose
      // row band's few tiles are dealt to neighbouring clusters
      const uint64_t pol_a = l2_policy(kTransA);
      const uint64_t pol_b = l2_policy(!kTransA);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = u0; u < u1; ++u) {
        const int4 w = units[u];
        const int m0 = (2 * (w.x / tiles_n) + rank) * kBM;
        const int n0 = (w.x % tiles_n) * kBN;
        for (int kb = w.y; kb < w.z; ++kb) {
          // free in both blocks: the peer's half of B lands here too
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kStageBytes);
          const uint32_t sa = base + stage * kStageBytes;
          const uint32_t sb = sa + kABytes;
          const int k0 = kb * kBK;
          if (kTransA) {
            tma_load(sa, &map_a, bar, m0, k0, pol_a);
            tma_load(sa + kBox, &map_a, bar, m0 + 64, k0, pol_a);
          } else {
            tma_load(sa, &map_a, bar, k0, m0, pol_a);
          }
#pragma unroll
          for (int j = 2 * rank; j < 2 * rank + 2; ++j)
            tma_load_both(sb + j * kBox, &map_b, bar, n0 + 64 * j, k0,
                          pol_b);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      // stay until both blocks' consumers have released every stage, so
      // that no arrival from the peer comes after this block has exited
      for (int i = 0; i < kStages; ++i) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    // the accumulator's rows and columns: d[4j + 2h + e] is row
    // 16 (t / 32) + lane / 4 + 8h, column 8j + 2 quad + e of the group's
    // 64 x 256 product
    const int row = 64 * group + 16 * (t / 32) + lane / 4;
    // once its products are done, the warpgroup releases a stage in both
    // blocks: its thread r signals block r
    auto release = [&](int s) {
      if (t < 2) mbar_arrive_cluster(empty + 8 * s, t);
    };
    float d[128];
    int stage = 0;
    uint32_t phase = 0;
    for (int u = u0; u < u1; ++u) {
      const int4 w = units[u];
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      fence_acc(d);
      int prev = 0;
      for (int kb = w.y; kb < w.z; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kStageBytes;
        const uint32_t sb = sa + kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              kTransA ? desc(sa + group * kBox + kk * 2048, kBox, 1024)
                      : desc(sa + group * kBox + kk * 32, 16, 1024);
          wgmma_256<kTransA>(d, da, desc(sb + kk * 2048, kBox, 1024));
        }
        wgmma_commit();
        if (kb > w.y) {  // the previous stage's products are done
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(d);
      release(prev);

      const int m0 = (2 * (w.x / tiles_n) + rank) * kBM;
      const int n0 = (w.x % tiles_n) * kBN;
      if constexpr (kMode == kPartial) {
        // the whole tile into its slot: no edge to mask
        float* p = static_cast<float*>(out) +
                   static_cast<size_t>(2 * w.w + rank) * kBM * kBN +
                   row * kBN + 2 * quad;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(p + h * 8 * kBN + 8 * j) =
                make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      } else {
        // bias, then gelu in float32 over all 128 values in place
        // (independent chains that the compiler interleaves), one rounding
        // to bf16; then the quad trades pairs so that each thread stores 8
        // columns (16 bytes) of one n8 block
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const int n = n0 + 8 * j + 2 * quad;
          float2 bv = make_float2(0.f, 0.f);
          if (n < N)
            bv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(bias + n));
          d[4 * j] += bv.x;
          d[4 * j + 1] += bv.y;
          d[4 * j + 2] += bv.x;
          d[4 * j + 3] += bv.y;
        }
        if constexpr (kMode == kBiasGelu) {
#pragma unroll
          for (int i = 0; i < 128; ++i) d[i] = gelu_tanh(d[i]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row + 8 * h;
#pragma unroll
          for (int jg = 0; jg < kBN / 32; ++jg) {
            uint32_t v[4], s[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * jg + i;
              const __nv_bfloat162 p =
                  __floats2bfloat162_rn(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
              v[i] = *reinterpret_cast<const uint32_t*>(&p);
            }
            // s[i] = thread i's pair of block 4 jg + quad
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const uint32_t got =
                  __shfl_xor_sync(0xffffffffu, pick(v, quad ^ r), r);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (i == (quad ^ r)) s[i] = got;
            }
            const int n = n0 + 8 * (4 * jg + quad);
            if (m < M && n < N)
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) +
                                        static_cast<size_t>(m) * N + n) =
                  make_uint4(s[0], s[1], s[2], s[3]);
          }
        }
      }
    }
  }
}

// Row 15's second kernel: out[m, n] = the sum of its tile's partials in
// slot order: pair tile p = (m / 256, n / 256) has slots s in
// [tile_slots[2p], tile_slots[2p + 1]), and its upper or lower 128 rows
// (block rank r) are in workspace slot 2 s + r. Four columns a thread; N a
// multiple of 4.
static __global__ void partial_sum_kernel(const float* __restrict__ ws,
                                   const int* __restrict__ tile_slots,
                                   float* __restrict__ out, int M, int N) {
  const int n4 = N / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(M) * n4) return;
  const int m = static_cast<int>(i / n4), n = static_cast<int>(i % n4) * 4;
  const int pair = (m / (2 * kBM)) * ((N + kBN - 1) / kBN) + n / kBN;
  const int s0 = tile_slots[2 * pair], s1 = tile_slots[2 * pair + 1];
  const float* p = ws + (m / kBM % 2) * kBM * kBN + (m % kBM) * kBN + n % kBN;
  float4 acc = __ldg(reinterpret_cast<const float4*>(
      p + static_cast<size_t>(2 * s0) * kBM * kBN));
  for (int s = s0 + 1; s < s1; ++s) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(
        p + static_cast<size_t>(2 * s) * kBM * kBN));
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n) = acc;
}

// cuTensorMapEncodeTiled, fetched from the driver at first use (the
// library links only the runtime).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Error codes of the host side beside cudaError_t's: a tensor map that
// does not encode returns -CUresult, a driver without the entry point
// kNoEncode.
constexpr int kNoEncode = -100000;

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                         12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The map of a row-major [rows, cols] matrix of bf16 (elem_bytes 2) or
// int8 (elem_bytes 1), read in boxes of box_rows rows x 128 bytes (64 bf16
// or 128 int8 values) with the 128-byte swizzle and zeros past the edges.
// Returns 0 or a negative error code.
inline int make_map(CUtensorMap* map, const void* p, int rows, int cols,
                    int box_rows, int elem_bytes = 2) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return kNoEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                             : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2,
                        const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// A launch of `clusters` clusters of two blocks of kThreads threads with
// smem bytes of dynamic shared memory each.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                         int clusters, cudaStream_t stream,
                                         size_t smem = kSmemBytes) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kMode, int kTransA>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const int* units,
           const int* cluster_first, int clusters, const void* bias, void* out,
           int M, int N, cudaStream_t stream) {
  auto kern = wgmma_kernel<kMode, kTransA>;
  cudaError_t e = allow_smem(kern, kSmemBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, clusters, stream);
  e = cudaLaunchKernelEx(&cfg, kern, ma, mb,
                         reinterpret_cast<const int4*>(units), cluster_first,
                         static_cast<const __nv_bfloat16*>(bias), out, M, N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How many clusters of two blocks the card runs at once: the persistent
// grid's size.
inline int max_clusters(int* clusters) {
  auto kern = wgmma_kernel<kBiasGelu, 0>;
  cudaError_t e = allow_smem(kern, kSmemBytes);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, 1, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

}  // namespace wg
