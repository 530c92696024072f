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
// Bound: bytes. At the b256 serving shape (n = 15360, d = 768, bf16) the
// forward moves 47 MB (14 us at 3.35 TB/s) and the backward 71 MB (21 us)
// for ~10 FLOPs per element. The design (rownorm.cuh): one warp per row
// with the row in registers, so each element is read once and written
// once; the backward's cross-row sums go through per-block partials.

#include "rownorm.cuh"

namespace {

template <typename T, int kPer>
__global__ void __launch_bounds__(kFwdWarps * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean, float* __restrict__ rstd,
                      int n, int d, float eps, int vec) {
  norm_fwd_row<T, kPer, false>(nullptr, x, w, b, y, nullptr, mean, rstd, n,
                               d, eps, vec != 0, RowDropout{0u, 0u, 1.f, 0});
}

template <typename T, int kPer>
__global__ void __launch_bounds__(kBwdWarps * 32)
layer_norm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ dw_part, float* __restrict__ db_part,
                      int n, int d, int vec) {
  norm_bwd_rows<T, kPer, false>(g, nullptr, x, w, mean, rstd, nullptr, dx,
                                dw_part, db_part, n, d, vec != 0,
                                RowDropout{0u, 0u, 1.f, 0});
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* b, void* y,
                       void* mean, void* rstd, int n, int d, float eps,
                       int vec, cudaStream_t stream) {
  const unsigned grid = (static_cast<unsigned>(n) + kFwdWarps - 1) / kFwdWarps;
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      layer_norm_fwd_kernel<T, kPer><<<grid, kFwdWarps * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<T*>(y),
          static_cast<float*>(mean), static_cast<float*>(rstd), n, d, eps,
          vec);
      return cudaGetLastError())
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* x, const void* w,
                       const void* mean, const void* rstd, void* dx,
                       void* dw_part, void* db_part, int n, int d, int vec,
                       cudaStream_t stream) {
  const unsigned grid = (static_cast<unsigned>(n) + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      auto kern = layer_norm_bwd_kernel<T, kPer>;
      const cudaError_t e = allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      kern<<<grid, kBwdWarps * 32, smem, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(x),
          static_cast<const float*>(w), static_cast<const float*>(mean),
          static_cast<const float*>(rstd), static_cast<T*>(dx),
          static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d,
          vec);
      return cudaGetLastError())
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; vec: 1 where d is a multiple of the
// 16-byte vector and every [n, d] pointer is 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int volta_layer_norm_fwd(const void* x, const void* w,
                                    const void* b, void* y, void* mean,
                                    void* rstd, int n, int d, float eps,
                                    int vec, int dtype, int device,
                                    void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(x, w, b, y, mean, rstd, n, d, eps, vec, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, w, b, y, mean, rstd, n, d, eps, vec,
                                     s);
  return cudaErrorInvalidValue;
}

// dw_part and db_part are [ceil(n / 64), d] float32.
extern "C" int volta_layer_norm_bwd(const void* g, const void* x,
                                    const void* w, const void* mean,
                                    const void* rstd, void* dx, void* dw_part,
                                    void* db_part, int n, int d, int vec,
                                    int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, x, w, mean, rstd, dx, dw_part, db_part, n, d,
                             vec, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, x, w, mean, rstd, dx, dw_part,
                                     db_part, n, d, vec, s);
  return cudaErrorInvalidValue;
}
