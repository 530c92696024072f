// Fused dropout + residual add + LayerNorm, forward and backward, for
// Hopper (sm_90a): the tail LN(dropout(o) + x) of every encoder sublayer in
// training.
//
// Replaces the TPU kernels of volta_tpu/ops/fused_residual.py behind
// dropout_residual_ln (:218):
//   forward  _fwd_kernel (:49), launched by _fwd_call (:113, pallas_call
//            :119): od = keep ? o * float32(1 / (1 - rate)) : 0 in float32,
//            s = od + x in float32, y = LN(s) with float32 statistics; it
//            writes y and od in o's dtype and the rows' mean and rstd;
//   backward _bwd_kernel (:72), launched by _bwd_call (:168, pallas_call
//            :176): s = od + x recomputed, ds the LayerNorm VJP, dx = ds,
//            do = ds * keep * float32(1 / (1 - rate)), and per-tile partial
//            dscale / dbias.
// o, x, y, od, g, do and dx are [n, d] in one dtype (bf16 or fp32),
// contiguous; scale and bias [d] float32; mean and rstd [n] float32.
//
// The mask. The TPU kernel draws it from the Mosaic PRNG and saves it as a
// third [n, d] tensor for the backward, because that PRNG cannot be
// replayed. Here keep(row, col) = hash_keep(row * d + col, seed, threshold)
// (common.cuh), the counter hash of the JAX package's hash_dropout over o's
// linear index with the site's uint32 seed, so the fused tail drops exactly
// the elements hash_dropout(o, seed, rate) drops. The backward replays the
// hash: no mask is saved, and the gradient of a kept element that was
// exactly 0 is not lost (the keep bit never comes from od != 0).
//
// Bound: bytes. At the b256 train shape (n = 15360, d = 768, bf16) the
// forward reads o and x and writes y and od, 94 MB (28 us at 3.35 TB/s);
// the backward reads g, od and x and writes do and dx, 118 MB (35 us). The
// hash's 32-bit integer instructions on the ALU pipe (chip_smoke.py counts
// them in the built keep-mask kernel's SASS: 9.9 an element) take 7 us at
// the card's 64 INT32 lanes an SM: under the bytes. The backward below
// takes 0.052 ms there, 0.68 of its floor, and the parent's row-a-warp
// body 0.090 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 6,
// chip_ab.py).
//
// The forward keeps rownorm.cuh's row a warp. The backward walks bands of
// rows (rowband.cuh), as the LayerNorm backward of layernorm.cu does:
// - one wave of 256-thread blocks, sized by the host from the SM count and
//   the occupancy API (volta_dropout_residual_ln_blocks_per_sm; band_blocks
//   in layernorm.py), each warp walking its band (band_range);
// - the next row's raw g, od and x vectors in flight (RawRow) while the
//   current row is reduced, od and x summed into s in float32 as the row
//   is taken up;
// - scale read once a block into shared memory in the lanes' slot order
//   (fill_slots);
// - the column sums of g * xhat and g in shared memory, one [2][kPer / 4]
//   [32] float4 region a warp in the lanes' slot order (conflict-free, no
//   synchronisation while the band runs): three raw rows in flight, a row
//   in use and two kPer-float accumulators do not fit the 128 registers
//   that let two blocks share an SM. At the end a tree over the block's 8
//   warps (block_column_sums) writes one [d] partial of each, and
//   band_sum_kernel (rowband.cuh), the second kernel of the same call, sums
//   the partials over blocks in 32 strands of block order. No atomics:
//   dscale and dbias are the same from run to run.
// Rows wider than kRegSlots slots (d > 1024) keep the accumulators in
// registers; they, and rows of more than 4 vectors a lane (float32 past d
// = 512), load, compute and store in turn, as layernorm.cu's wide rows do.

#include "rowband.cuh"

namespace {

template <typename T, int kPer>
__global__ void __launch_bounds__(kFwdWarps * 32)
dropout_residual_ln_fwd_kernel(const T* __restrict__ o,
                               const T* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ b,
                               T* __restrict__ y, T* __restrict__ od,
                               float* __restrict__ mean,
                               float* __restrict__ rstd, int n, int d,
                               float eps, int vec, RowDropout drop) {
  norm_fwd_row<T, kPer>(o, x, w, b, y, od, mean, rstd, n, d, eps,
                              vec != 0, drop);
}

// The backward's shape for dtype T and kPer slots a lane.
template <typename T, int kPer>
struct BwdPlan {
  static constexpr int N = Vec16<T>::N;
  // the column sums in shared memory (else in registers)
  static constexpr bool kSmemSums = kPer <= kRegSlots;
  // the next row's three raw rows in flight: up to 4 vectors a lane
  static constexpr bool kAhead = kSmemSums && kPer / N <= 4;
  // float4 slots a lane of a warp keeps of each sum in shared memory: all
  // of them, or one vector's at a time for the final tree
  static constexpr int Q = kSmemSums ? kPer / 4 : N / 4;
  // dynamic shared memory: [kBandWarps][2][Q][32] float4
  static constexpr size_t kSmem = sizeof(float4) * kBandWarps * 2 * Q * 32;
};

// The block's column sums from acc ([kBandWarps][2][Q][32] float4, the
// warps' sums of g * xhat then of g for the lanes' float4 slots q0 .. q0 +
// Q - 1): for each column a tree over the warps (tree_sum), written to
// part[which][blockIdx.x] ([2, gridDim.x, d]). The caller synchronises the
// block before and after.
template <typename T>
__device__ __forceinline__ void block_column_sums(const float4* acc, int Q,
                                                  int q0,
                                                  float* __restrict__ part,
                                                  int d) {
  for (int e = threadIdx.x; e < 2 * Q * 32; e += kBandThreads) {
    const int which = e / (Q * 32), q = (e / 32) % Q, lane = e % 32;
    float t[4][kBandWarps];
#pragma unroll
    for (int k = 0; k < kBandWarps; ++k) {
      const float4 v = acc[((k * 2 + which) * Q + q) * 32 + lane];
      t[0][k] = v.x;
      t[1][k] = v.y;
      t[2][k] = v.z;
      t[3][k] = v.w;
    }
    float* out = part + (static_cast<size_t>(which) * gridDim.x + blockIdx.x) *
                            static_cast<size_t>(d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = slot_elem<T>(4 * (q0 + q) + j, lane);
      const float sum = tree_sum(t[j]);
      if (col < d) out[col] = sum;
    }
  }
}

// The VJP of LN(dropout(o) + x) over the rows of the warp's band: s = od +
// x recomputed from the saved od, ds the LayerNorm VJP of s for the output
// cotangent g, dx = ds and do = ds * keep * scale with the keep bit
// replayed from the hash (never from od != 0: a kept element that was
// exactly 0 keeps its gradient); the block's partial column sums of
// g * xhat and g to part[0][blockIdx.x] and part[1][blockIdx.x].
template <typename T, int kPer>
__global__ void __launch_bounds__(kBandThreads, band_min_blocks<kPer>())
dropout_residual_ln_bwd_kernel(const T* __restrict__ g,
                               const T* __restrict__ od,
                               const T* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               T* __restrict__ d_o, T* __restrict__ dx,
                               float* __restrict__ part, int n, int d,
                               int vec_flag, RowDropout drop) {
  using P = BwdPlan<T, kPer>;
  constexpr int N = P::N, Q = P::Q;
  extern __shared__ float4 acc[];  // [kBandWarps][2][Q][32]
  __shared__ float4 wsm[kPer / 4][32];
  const bool vec = vec_flag != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int r0, r1;
  band_range(static_cast<long long>(blockIdx.x) * kBandWarps + warp,
             static_cast<long long>(gridDim.x) * kBandWarps, n, r0, r1);
  float4* sw = acc + warp * 2 * Q * 32 + lane;  // the lane's sums of g * xhat
  float4* sb = sw + Q * 32;                     // and of g, slot q at [32 q]
  float aw[P::kSmemSums ? 1 : kPer], ab[P::kSmemSums ? 1 : kPer];
  if constexpr (P::kSmemSums) {
#pragma unroll
    for (int q = 0; q < Q; ++q) sw[32 * q] = sb[32 * q] = float4{};
  } else {
#pragma unroll
    for (int s = 0; s < kPer; ++s) aw[s] = ab[s] = 0.f;
  }
  // the band's first row is on its way while the block stages scale
  RawRow<T, kPer> ng, nod, nx;
  float nmu = 0.f, nrs = 0.f;
  if (P::kAhead && r0 < r1) {
    const size_t base = static_cast<size_t>(r0) * d;
    ng.load(g + base, d, lane, vec);
    nod.load(od + base, d, lane, vec);
    nx.load(x + base, d, lane, vec);
    nmu = mean[r0];
    nrs = rstd[r0];
  }
  fill_slots<T, kPer>(wsm, w, d);
  __syncthreads();

  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    RawRow<T, kPer> cg;
    float sv[kPer];  // s = od + x in float32
    float mu, rs;
    if constexpr (P::kAhead) {
      cg = ng;
#pragma unroll
      for (int s = 0; s < kPer; ++s) sv[s] = nod.at(s) + nx.at(s);
      mu = nmu;
      rs = nrs;
      if (row + 1 < r1) {
        ng.load(g + base + d, d, lane, vec);
        nod.load(od + base + d, d, lane, vec);
        nx.load(x + base + d, d, lane, vec);
        nmu = mean[row + 1];
        nrs = rstd[row + 1];
      }
    } else {
      cg.load(g + base, d, lane, vec);
      load_row<T, kPer>(od + base, d, lane, vec, sv);
      load_row<T, kPer, true>(x + base, d, lane, vec, sv);
      mu = mean[row];
      rs = rstd[row];
    }
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 w4 = wsm[q][lane];  // 0 past d
      const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
      float a[4], b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = 4 * q + j;
        const float gf = cg.at(s);
        const float xh = (sv[s] - mu) * rs;
        a[j] = gf * xh;
        b[j] = gf;
        const float gs = gf * wq[j];
        m1 += gs;
        m2 += gs * xh;
      }
      if constexpr (P::kSmemSums) {
        const float4 pa = sw[32 * q], pb = sb[32 * q];
        sw[32 * q] = make_float4(pa.x + a[0], pa.y + a[1], pa.z + a[2],
                                 pa.w + a[3]);
        sb[32 * q] = make_float4(pb.x + b[0], pb.y + b[1], pb.z + b[2],
                                 pb.w + b[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          aw[4 * q + j] += a[j];
          ab[4 * q + j] += b[j];
        }
      }
    }
    m1 = warp_sum(m1) / static_cast<float>(d);
    m2 = warp_sum(m2) / static_cast<float>(d);
    // dx and do, one 16-byte vector of the row at a time
#pragma unroll
    for (int i = 0; i < kPer / N; ++i) {
      const int e0 = (i * 32 + lane) * N;
      float o[N];
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 w4 = wsm[i * N / 4 + q][lane];
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = i * N + 4 * q + j;
          const float xh = (sv[s] - mu) * rs;
          o[4 * q + j] = rs * (cg.at(s) * wq[j] - m1 - xh * m2);
        }
      }
      store_vec<T>(dx + base, e0, d, vec, o);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const bool keep =
            !drop.drop || hash_keep(static_cast<uint32_t>(base + e0 + j),
                                    drop.seed, drop.threshold);
        o[j] = keep ? o[j] * drop.scale : 0.f;
      }
      store_vec<T>(d_o + base, e0, d, vec, o);
    }
  }

  if constexpr (P::kSmemSums) {
    __syncthreads();
    block_column_sums<T>(acc, Q, 0, part, d);
  } else {
    // one 16-byte vector index of the row at a time: each warp's slots to
    // shared memory, then the tree over the warps
#pragma unroll
    for (int i = 0; i < kPer / N; ++i) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = i * N + 4 * q;
        sw[32 * q] = make_float4(aw[s], aw[s + 1], aw[s + 2], aw[s + 3]);
        sb[32 * q] = make_float4(ab[s], ab[s + 1], ab[s + 2], ab[s + 3]);
      }
      __syncthreads();
      block_column_sums<T>(acc, Q, i * Q, part, d);
      __syncthreads();
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* o, const void* x, const void* w,
                       const void* b, void* y, void* od, void* mean,
                       void* rstd, int n, int d, float eps, int vec,
                       RowDropout drop, cudaStream_t stream) {
  const unsigned grid = (static_cast<unsigned>(n) + kFwdWarps - 1) / kFwdWarps;
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      dropout_residual_ln_fwd_kernel<T, kPer>
          <<<grid, kFwdWarps * 32, 0, stream>>>(
              static_cast<const T*>(o), static_cast<const T*>(x),
              static_cast<const float*>(w), static_cast<const float*>(b),
              static_cast<T*>(y), static_cast<T*>(od),
              static_cast<float*>(mean), static_cast<float*>(rstd), n, d,
              eps, vec, drop);
      return cudaGetLastError())
}

// The backward's dynamic shared memory beside its static scale slots: the
// limit is raised for every instance, since the two together pass the 48
// KB default at d = 768.
template <typename T, int kPer, typename Kernel>
cudaError_t bwd_smem(Kernel kern, size_t* smem) {
  *smem = BwdPlan<T, kPer>::kSmem;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* od, const void* x,
                       const void* w, const void* mean, const void* rstd,
                       void* d_o, void* dx, void* ws, int n, int d, int vec,
                       int blocks, RowDropout drop, cudaStream_t stream) {
  float* part = static_cast<float*>(ws);
  float* out = part + 2 * static_cast<size_t>(blocks) * d;
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      auto kern = dropout_residual_ln_bwd_kernel<T, kPer>;
      size_t smem;
      cudaError_t e = bwd_smem<T, kPer>(kern, &smem);
      if (e != cudaSuccess) return e;
      kern<<<blocks, kBandThreads, smem, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(od),
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<T*>(d_o), static_cast<T*>(dx), part, n, d, vec, drop);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      return launch_band_sum(part, out, blocks, d, stream))
}

template <typename T>
cudaError_t bwd_blocks_per_sm(int d, int* out) {
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      auto kern = dropout_residual_ln_bwd_kernel<T, kPer>;
      size_t smem;
      const cudaError_t e = bwd_smem<T, kPer>(kern, &smem);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          out, kern, kBandThreads, smem))
}

}  // namespace

// drop: 0 keeps every element (rate 0; keep_scale must then be 1), else
// keep = hash < threshold; keep_scale = float32(1 / (1 - rate)). dtype:
// 0 = float32, 1 = bfloat16; vec as for volta_layer_norm_fwd. Returns the
// launch's cudaError_t.
extern "C" int volta_dropout_residual_ln_fwd(
    const void* o, const void* x, const void* w, const void* b, void* y,
    void* od, void* mean, void* rstd, int n, int d, float eps, uint32_t seed,
    uint32_t threshold, float keep_scale, int drop, int vec, int dtype,
    int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowDropout dr{seed, threshold, keep_scale, drop};
  if (dtype == 0)
    return launch_fwd<float>(o, x, w, b, y, od, mean, rstd, n, d, eps, vec,
                             dr, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(o, x, w, b, y, od, mean, rstd, n, d,
                                     eps, vec, dr, s);
  return cudaErrorInvalidValue;
}

// ws is float32 [2 * (blocks + 1) * d] (bwd_workspace in layernorm.py):
// the blocks' partials [2, blocks, d], then dscale [d] and dbias [d];
// blocks: the grid (band_blocks). Two launches.
extern "C" int volta_dropout_residual_ln_bwd(
    const void* g, const void* od, const void* x, const void* w,
    const void* mean, const void* rstd, void* d_o, void* dx, void* ws, int n,
    int d, uint32_t seed, uint32_t threshold, float keep_scale, int drop,
    int vec, int blocks, int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowDropout dr{seed, threshold, keep_scale, drop};
  if (dtype == 0)
    return launch_bwd<float>(g, od, x, w, mean, rstd, d_o, dx, ws, n, d, vec,
                             blocks, dr, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, od, x, w, mean, rstd, d_o, dx, ws, n,
                                     d, vec, blocks, dr, s);
  return cudaErrorInvalidValue;
}

// *out = the blocks of the backward band kernel an SM of `device` holds at
// once for width d in dtype.
extern "C" int volta_dropout_residual_ln_blocks_per_sm(int d, int dtype,
                                                       int device, int* out) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (dtype == 0) return bwd_blocks_per_sm<float>(d, out);
  if (dtype == 1) return bwd_blocks_per_sm<__nv_bfloat16>(d, out);
  return cudaErrorInvalidValue;
}
