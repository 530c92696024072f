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
// hash costs a few integer ops per element. Row layout and partial sums:
// rownorm.cuh.

#include "rownorm.cuh"

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

template <typename T, int kPer>
__global__ void __launch_bounds__(kBwdWarps * 32)
dropout_residual_ln_bwd_kernel(const T* __restrict__ g,
                               const T* __restrict__ od,
                               const T* __restrict__ x,
                               const float* __restrict__ w,
                               const float* __restrict__ mean,
                               const float* __restrict__ rstd,
                               T* __restrict__ d_o, T* __restrict__ dx,
                               float* __restrict__ dw_part,
                               float* __restrict__ db_part, int n, int d,
                               int vec, RowDropout drop) {
  norm_bwd_rows<T, kPer>(g, od, x, w, mean, rstd, d_o, dx, dw_part,
                               db_part, n, d, vec != 0, drop);
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

template <typename T>
cudaError_t launch_bwd(const void* g, const void* od, const void* x,
                       const void* w, const void* mean, const void* rstd,
                       void* d_o, void* dx, void* dw_part, void* db_part,
                       int n, int d, int vec, RowDropout drop,
                       cudaStream_t stream) {
  const unsigned grid = (static_cast<unsigned>(n) + kBwdRows - 1) / kBwdRows;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  VOLTA_SWITCH_PER_LANE(
      norm_per_lane<T>(d),
      auto kern = dropout_residual_ln_bwd_kernel<T, kPer>;
      const cudaError_t e = allow_smem(kern, smem);
      if (e != cudaSuccess) return e;
      kern<<<grid, kBwdWarps * 32, smem, stream>>>(
          static_cast<const T*>(g), static_cast<const T*>(od),
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const float*>(mean), static_cast<const float*>(rstd),
          static_cast<T*>(d_o), static_cast<T*>(dx),
          static_cast<float*>(dw_part), static_cast<float*>(db_part), n, d,
          vec, drop);
      return cudaGetLastError())
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

// dw_part and db_part are [ceil(n / 64), d] float32.
extern "C" int volta_dropout_residual_ln_bwd(
    const void* g, const void* od, const void* x, const void* w,
    const void* mean, const void* rstd, void* d_o, void* dx, void* dw_part,
    void* db_part, int n, int d, uint32_t seed, uint32_t threshold,
    float keep_scale, int drop, int vec, int dtype, int device,
    void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowDropout dr{seed, threshold, keep_scale, drop};
  if (dtype == 0)
    return launch_bwd<float>(g, od, x, w, mean, rstd, d_o, dx, dw_part,
                             db_part, n, d, vec, dr, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, od, x, w, mean, rstd, d_o, dx,
                                     dw_part, db_part, n, d, vec, dr, s);
  return cudaErrorInvalidValue;
}
