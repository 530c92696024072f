// TF-style LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of volta_tpu/ops/layernorm.py behind
// fused_layer_norm (:139):
//   forward  _fwd_kernel (:27), launched by _fwd_call (:63, pallas_call
//            :67): y = (x - mean) * rstd * scale + bias with float32
//            statistics, plus the rows' mean and rstd;
//   backward _bwd_kernel (:40), launched by _bwd_call (:89, pallas_call
//            :95): dx from the saved mean and rstd, and per-tile partial
//            dscale / dbias that the caller sums.
// x, y, g and dx are [n, d] in bf16 or fp32, contiguous; scale and bias are
// [d] float32 (the port's parameters); mean and rstd are [n] float32. Any
// n, and d up to 4096. The TPU wrapper's n % 256 and d % 128 gates are
// Mosaic tiling limits and have no counterpart here.
//
// Bound: bytes. At the b256 train shape (n = 15360, d = 768, bf16) the
// forward moves 47 MB (14 us at 3.35 TB/s) and the backward 71 MB (21 us)
// for ~10 FLOPs per element; at the b1024 eval shape (n = 61440) four
// times that. What the design does about it (rowband.cuh): one wave of
// blocks sized to the card, each warp walking a band of rows with the
// next row's loads in flight while it reduces the current one, and scale
// and bias read once a warp into registers (the forward) or once a block
// into shared memory (the backward) instead of once a row. Each
// element of x, g, y and dx is read or written once, 16 bytes a lane.
//
// The backward's sums over rows. Each lane adds its columns' g * xhat and
// g over its band in registers; at the end the block's warps go through
// shared memory, 8 to a column, summed as a tree (tree_sum), and the block
// writes one [d] partial of each. A second kernel of the same call sums
// the partials over blocks (band_sum_kernel, rowband.cuh): strands of
// blocks k, k + 32, ... in block order, then a tree over the 32 strands.
// No atomics: dscale and dbias are the same from run to run. The host
// sizes the partials (band_blocks and bwd_workspace in layernorm.py) and
// passes the block count to the launch.

#include "rowband.cuh"

namespace {

// Plain LayerNorm forward over the rows of the warp's band.
template <typename T, int kPer>
__global__ void __launch_bounds__(kBandThreads, band_min_blocks<kPer>())
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int n, int d, float eps, int vec_flag) {
  constexpr bool kAhead = kPer <= kRegSlots;
  const bool vec = vec_flag != 0;
  const int lane = threadIdx.x & 31;
  int r0, r1;
  band_range(static_cast<long long>(blockIdx.x) * kBandWarps +
                 (threadIdx.x >> 5),
             static_cast<long long>(gridDim.x) * kBandWarps, n, r0, r1);
  if (r0 >= r1) return;
  LaneVec<T, kPer> wv, bv;
  wv.load(w, d, lane);
  bv.load(b, d, lane);
  RawRow<T, kPer> next;
  if constexpr (kAhead)
    next.load(x + static_cast<size_t>(r0) * d, d, lane, vec);
  for (int row = r0; row < r1; ++row) {
    const size_t base = static_cast<size_t>(row) * d;
    float v[kPer];
    if constexpr (kAhead) {
#pragma unroll
      for (int s = 0; s < kPer; ++s) v[s] = next.at(s);
      if (row + 1 < r1) next.load(x + base + d, d, lane, vec);
    } else {
      load_row<T, kPer>(x + base, d, lane, vec, v);
    }
    float mu, rs;
    row_stats<T, kPer>(v, d, lane, eps, mu, rs);
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int e = slot_elem<T>(s, lane);
      v[s] = e < d ? (v[s] - mu) * rs * wv(s, lane) + bv(s, lane) : 0.f;
    }
    store_row<T, kPer>(y + base, d, lane, vec, v);
    if (lane == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// The LayerNorm VJP over the rows of the warp's band:
//   gs = g * scale, dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
// and the block's partial column sums of g * xhat and g, written to
// part[0][blockIdx.x] and part[1][blockIdx.x] ([2, gridDim.x, d]). scale
// is read once a block into shared memory in the lanes' slot order
// (fill_slots): the column sums, both rows in flight and the slots leave
// no room for it in registers under the 128 that let two blocks share an
// SM.
template <typename T, int kPer>
__global__ void __launch_bounds__(kBandThreads, band_min_blocks<kPer>())
layer_norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ part, int n, int d, int vec_flag) {
  constexpr int N = Vec16<T>::N;
  constexpr bool kAhead = kPer <= kRegSlots;
  __shared__ __align__(16) float red[kBandWarps][2][32 * N];
  __shared__ float4 wsm[kPer / 4][32];
  const bool vec = vec_flag != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int r0, r1;
  band_range(static_cast<long long>(blockIdx.x) * kBandWarps + warp,
             static_cast<long long>(gridDim.x) * kBandWarps, n, r0, r1);
  float aw[kPer], ab[kPer];
#pragma unroll
  for (int s = 0; s < kPer; ++s) aw[s] = ab[s] = 0.f;
  // the band's first row is on its way while the block stages scale
  RawRow<T, kPer> ng, nx;
  float nmu = 0.f, nrs = 0.f;
  if (kAhead && r0 < r1) {
    const size_t base = static_cast<size_t>(r0) * d;
    ng.load(g + base, d, lane, vec);
    nx.load(x + base, d, lane, vec);
    nmu = mean[r0];
    nrs = rstd[r0];
  }
  fill_slots<T, kPer>(wsm, w, d);
  __syncthreads();

  if (r0 < r1) {
    for (int row = r0; row < r1; ++row) {
      const size_t base = static_cast<size_t>(row) * d;
      RawRow<T, kPer> cg, cx;
      float mu, rs;
      if constexpr (kAhead) {
        cg = ng;
        cx = nx;
        mu = nmu;
        rs = nrs;
        if (row + 1 < r1) {
          ng.load(g + base + d, d, lane, vec);
          nx.load(x + base + d, d, lane, vec);
          nmu = mean[row + 1];
          nrs = rstd[row + 1];
        }
      } else {
        cg.load(g + base, d, lane, vec);
        cx.load(x + base, d, lane, vec);
        mu = mean[row];
        rs = rstd[row];
      }
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const float4 w4 = wsm[q][lane];  // 0 past d
        const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * q + j;
          const float gf = cg.at(s);
          const float xh = (cx.at(s) - mu) * rs;
          aw[s] += gf * xh;
          ab[s] += gf;
          const float gs = gf * wq[j];
          m1 += gs;
          m2 += gs * xh;
        }
      }
      m1 = warp_sum(m1) / static_cast<float>(d);
      m2 = warp_sum(m2) / static_cast<float>(d);
      // dx, one 16-byte vector of the row at a time
#pragma unroll
      for (int i = 0; i < kPer / N; ++i) {
        float o[N];
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
          const float4 w4 = wsm[i * N / 4 + q][lane];
          const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = i * N + 4 * q + j;
            const float xh = (cx.at(s) - mu) * rs;
            o[4 * q + j] = rs * (cg.at(s) * wq[j] - m1 - xh * m2);
          }
        }
        store_vec<T>(dx + base, (i * 32 + lane) * N, d, vec, o);
      }
    }
  }

  // the block's column sums, one 16-byte vector index of the row at a time
  // (32 * N columns): each warp's slots to shared memory, then a tree over
  // the warps for each column
#pragma unroll
  for (int i = 0; i < kPer / N; ++i) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      *reinterpret_cast<float4*>(&red[warp][0][lane * N + j]) = make_float4(
          aw[i * N + j], aw[i * N + j + 1], aw[i * N + j + 2],
          aw[i * N + j + 3]);
      *reinterpret_cast<float4*>(&red[warp][1][lane * N + j]) = make_float4(
          ab[i * N + j], ab[i * N + j + 1], ab[i * N + j + 2],
          ab[i * N + j + 3]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 2 * 32 * N; c += kBandThreads) {
      const int which = c / (32 * N), p = c % (32 * N);
      const int col = i * 32 * N + p;
      float t[kBandWarps];
#pragma unroll
      for (int k = 0; k < kBandWarps; ++k) t[k] = red[k][which][p];
      const float sum = tree_sum(t);
      if (col < d)
        part[(static_cast<size_t>(which) * gridDim.x + blockIdx.x) * d +
             col] = sum;
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int n, int d, float eps,
                       int vec, int blocks, cudaStream_t stream) {
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      layer_norm_fwd_kernel<T, kPer><<<blocks, kBandThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<T*>(y),
          static_cast<float*>(mean), static_cast<float*>(rstd), n, d, eps,
          vec);
      return cudaGetLastError())
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* w,
                       const void* mean, const void* rstd, void* dx,
                       void* ws, int n, int d, int vec, int blocks,
                       cudaStream_t stream) {
  float* part = static_cast<float*>(ws);
  float* out = part + 2 * static_cast<size_t>(blocks) * d;
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      layer_norm_bwd_kernel<T, kPer><<<blocks, kBandThreads, 0, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(x),
          static_cast<const float*>(w), static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<T*>(dx), part, n, d,
          vec);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      return launch_band_sum(part, out, blocks, d, stream))
}

template <typename T>
cudaError_t blocks_per_sm(int d, int backward, int* out) {
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      return backward ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            out, layer_norm_bwd_kernel<T, kPer>,
                            kBandThreads, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            out, layer_norm_fwd_kernel<T, kPer>,
                            kBandThreads, 0))
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: 1 where d is a multiple of the
// 16-byte vector and every [n, d] pointer is 16-byte aligned; blocks: the
// grid (band_blocks). Returns the launch's cudaError_t.
extern "C" int volta_layer_norm_fwd(const void* x, const void* w,
                                    const void* b, void* y, void* mean,
                                    void* rstd, int n, int d, float eps,
                                    int vec, int blocks, int dtype,
                                    int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, w, b, y, mean, rstd, n, d, eps, vec, blocks,
                             s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, b, y, mean, rstd, n, d, eps, vec,
                                     blocks, s);
  return cudaErrorInvalidValue;
}

// ws is float32 [2 * (blocks + 1) * d] (bwd_workspace): the blocks'
// partials [2, blocks, d], then dscale [d] and dbias [d]. Two launches.
extern "C" int volta_layer_norm_bwd(const void* g, const void* x,
                                    const void* w, const void* mean,
                                    const void* rstd, void* dx, void* ws,
                                    int n, int d, int vec, int blocks,
                                    int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, x, w, mean, rstd, dx, ws, n, d, vec, blocks,
                             s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, w, mean, rstd, dx, ws, n, d, vec,
                                     blocks, s);
  return cudaErrorInvalidValue;
}

// *out = the blocks of the forward (backward = 0) or backward band kernel
// an SM of `device` holds at once for width d in dtype.
extern "C" int volta_layer_norm_blocks_per_sm(int d, int dtype, int backward,
                                              int device, int* out) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (dtype == 0) return blocks_per_sm<float>(d, backward, out);
  if (dtype == 1) return blocks_per_sm<__nv_bfloat16>(d, backward, out);
  return cudaErrorInvalidValue;
}
