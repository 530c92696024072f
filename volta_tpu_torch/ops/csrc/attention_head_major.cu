// Joint attention on head-major [H, B, L, D] operands, with and without
// dropout on the probabilities, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the attn_natural_layout=false configuration
// (volta_tpu/ops/pallas_attention.py), four kernels, four entry points:
//   row 7  _attn_kernel (:852), launched by _pallas_forward (:970,
//          pallas_call :986): the no-dropout forward of eval and of
//          dropout-free training;
//   row 8  _attn_bwd_kernel (:907), launched by _attn_bwd_pallas (:917,
//          pallas_call :925), math _attn_bwd_math (:884-904): its backward,
//          with the bias gradient as per-head partials [H, B, Lk] float32
//          that the caller sums over heads (:941);
//   row 5  _attn_dropout_fwd_kernel (:100), launched by _dropout_fwd_core
//          (:240, pallas_call :247): the training forward with dropout on
//          the probabilities, which writes the 0/1 keep mask [H, B, Lq, Lk];
//   row 6  _attn_dropout_bwd_kernel (:169), launched by _dropout_bwd_core
//          (:278, pallas_call :283), math _dropout_bwd_math (:147-166): its
//          backward, which reads that mask back.
// q, g and out are [H, B, Lq, D], k and v [H, B, Lk, D], bf16 or fp32,
// contiguous (the layout the TPU path transposes into, _head_major :178);
// bias is [B, Lk] float32. The math is that of rows 1-4
// (attention_fwd.cu, attention_bwd.cu, attention_dropout.cu).
//
// The mask. keep(b, h, i, j) is the counter hash of rows 3-4 over the
// natural index n = ((b * H + h) * Lq + i) * Lk + j, stored as one byte at
// [h, b, i, j]: for one seed the head-major and the natural configurations
// drop the same probabilities. The TPU kernel writes its Mosaic PRNG draw as
// bf16 0/1 because that PRNG cannot be replayed; here the values are the
// same in half the bytes (11.1 MB at B = 256, L = 60, H = 12), and the
// backward reads them instead of replaying the hash, as the TPU's does.
//
// The blocks are those of rows 1-4 (attention_common.cuh) with the
// head-major addressing (HeadLayout<true>): a head's rows are D elements
// apart instead of H·D, so a block's K, V, q and g rows are one contiguous
// run each. They are bound like rows 1-4, by the instruction rate and
// latency of their CUDA-core loops, not by device memory: at B = 256,
// L = 60, H = 12, D = 64 in bf16 the forward's byte floor is 28 us and the
// backward's 49 us (the mask adds 3.3 us to each), and rows 7, 8, 5 and 6
// take 0.240, 0.506, 0.286 and 0.529 ms on an H100 (NVIDIA H100 80GB
// HBM3, 700 W, chip_smoke.py), a quarter less than rows 1, 2 and 4 on the
// natural layout with the same loops.

#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_head_major_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int Lq, int Lk, int H,
                                float scale, int lk_pad) {
  attention_fwd_block<T, D, false, true>(q, k, v, bias, out, Lq, Lk, H, scale,
                                         lk_pad, Dropout{0u, 0u, 0.f},
                                         nullptr);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_head_major_bwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                const T* __restrict__ g, T* __restrict__ dq,
                                T* __restrict__ dk, T* __restrict__ dv,
                                float* __restrict__ db_part, int Lq, int Lk,
                                int H, float scale) {
  attention_bwd_block<T, D, false, true>(q, k, v, bias, g, dq, dk, dv,
                                         db_part, Lq, Lk, H, scale,
                                         Dropout{0u, 0u, 0.f}, nullptr);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_head_major_fwd_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out,
                                        uint8_t* __restrict__ mask, int Lq,
                                        int Lk, int H, float scale,
                                        int lk_pad, Dropout drop) {
  attention_fwd_block<T, D, true, true>(q, k, v, bias, out, Lq, Lk, H, scale,
                                        lk_pad, drop, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_dropout_head_major_bwd_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        const T* __restrict__ g,
                                        const uint8_t* __restrict__ mask,
                                        T* __restrict__ dq,
                                        T* __restrict__ dk,
                                        T* __restrict__ dv, int Lq, int Lk,
                                        int H, float scale, Dropout drop) {
  attention_bwd_block<T, D, true, true>(q, k, v, bias, g, dq, dk, dv,
                                        nullptr, Lq, Lk, H, scale, drop,
                                        mask);
}

// The forwards: grid (B * H, query tiles of kRowsPerBlock), as rows 1 and 3.
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* mask, int B, int Lq,
                       int Lk, int H, float scale, const Dropout* drop,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>(Lk);
  const dim3 grid(static_cast<unsigned>(B) * H,
                  (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  const int lk_pad = (Lk + 3) & ~3;
  if (drop == nullptr) {
    auto kern = attention_head_major_fwd_kernel<T, D>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(out), Lq, Lk, H, scale, lk_pad);
  } else {
    auto kern = attention_dropout_head_major_fwd_kernel<T, D>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<T*>(out), static_cast<uint8_t*>(mask), Lq, Lk, H, scale,
        lk_pad, *drop);
  }
  return cudaGetLastError();
}

// The backwards: one block of kBwdWarps warps per (b, h), as rows 2 and 4.
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* g, const void* mask,
                       void* dq, void* dk, void* dv, void* db_part, int B,
                       int Lq, int Lk, int H, float scale, const Dropout* drop,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(Lq, Lk, D);
  const unsigned grid = static_cast<unsigned>(B) * H;
  if (drop == nullptr) {
    auto kern = attention_head_major_bwd_kernel<T, D>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kBwdWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<float*>(db_part), Lq, Lk, H, scale);
  } else {
    auto kern = attention_dropout_head_major_bwd_kernel<T, D>;
    const cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<grid, kBwdWarps * 32, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(bias),
        static_cast<const T*>(g), static_cast<const uint8_t*>(mask),
        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), Lq,
        Lk, H, scale, *drop);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* mask, int B,
                         int Lq, int Lk, int H, int D, float scale,
                         const Dropout* drop, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_fwd<T, kD>(q, k, v, bias, out, mask, B, Lq, Lk, H,
                                  scale, drop, stream))
}

template <typename T>
cudaError_t launch_bwd_d(const void* q, const void* k, const void* v,
                         const void* bias, const void* g, const void* mask,
                         void* dq, void* dk, void* dv, void* db_part, int B,
                         int Lq, int Lk, int H, int D, float scale,
                         const Dropout* drop, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_bwd<T, kD>(q, k, v, bias, g, mask, dq, dk, dv,
                                  db_part, B, Lq, Lk, H, scale, drop, stream))
}

cudaError_t fwd(const void* q, const void* k, const void* v,
                const void* bias, void* out, void* mask, int B, int Lq,
                int Lk, int H, int D, float scale, const Dropout* drop,
                int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_d<float>(q, k, v, bias, out, mask, B, Lq, Lk, H, D,
                               scale, drop, s);
  if (dtype == 1)
    return launch_fwd_d<__nv_bfloat16>(q, k, v, bias, out, mask, B, Lq, Lk,
                                       H, D, scale, drop, s);
  return cudaErrorInvalidValue;
}

cudaError_t bwd(const void* q, const void* k, const void* v,
                const void* bias, const void* g, const void* mask, void* dq,
                void* dk, void* dv, void* db_part, int B, int Lq, int Lk,
                int H, int D, float scale, const Dropout* drop, int dtype,
                int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_d<float>(q, k, v, bias, g, mask, dq, dk, dv, db_part,
                               B, Lq, Lk, H, D, scale, drop, s);
  if (dtype == 1)
    return launch_bwd_d<__nv_bfloat16>(q, k, v, bias, g, mask, dq, dk, dv,
                                       db_part, B, Lq, Lk, H, D, scale, drop,
                                       s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA device of the tensors
// and of the stream. Each returns the launch's cudaError_t.

// Row 7.
extern "C" int volta_attention_head_major_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int B, int Lq, int Lk, int H, int D, float scale, int dtype, int device,
    void* stream) {
  return fwd(q, k, v, bias, out, nullptr, B, Lq, Lk, H, D, scale, nullptr,
             dtype, device, stream);
}

// Row 8; db_part (float32 [H, B, Lk]) may be null.
extern "C" int volta_attention_head_major_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, void* db_part, int B,
    int Lq, int Lk, int H, int D, float scale, int dtype, int device,
    void* stream) {
  return bwd(q, k, v, bias, g, nullptr, dq, dk, dv, db_part, B, Lq, Lk, H, D,
             scale, nullptr, dtype, device, stream);
}

// Row 5; mask (uint8 [H, B, Lq, Lk]) receives the 0/1 keep mask;
// keep_scale = float32(1 / (1 - rate)).
extern "C" int volta_attention_dropout_head_major_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* mask, int B, int Lq, int Lk, int H, int D, float scale,
    uint32_t seed, uint32_t threshold, float keep_scale, int dtype,
    int device, void* stream) {
  const Dropout drop{seed, threshold, keep_scale};
  return fwd(q, k, v, bias, out, mask, B, Lq, Lk, H, D, scale, &drop, dtype,
             device, stream);
}

// Row 6; mask is row 5's.
extern "C" int volta_attention_dropout_head_major_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, const void* mask, void* dq, void* dk, void* dv, int B,
    int Lq, int Lk, int H, int D, float scale, float keep_scale, int dtype,
    int device, void* stream) {
  const Dropout drop{0u, 0u, keep_scale};
  return bwd(q, k, v, bias, g, mask, dq, dk, dv, nullptr, B, Lq, Lk, H, D,
             scale, &drop, dtype, device, stream);
}
