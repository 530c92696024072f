// Joint attention with dropout on the probabilities, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of the training path
// pallas_dropout_attention(natural=True) (volta_tpu/ops/pallas_attention.py
// :213-227, custom VJP _pallas_dropout_attention_nat :603-629):
//   forward  _attn_dropout_fwd_kernel_nat_bh (:510), launched by
//            _nat_fwd_core (:549, pallas_call :557);
//   backward _attn_dropout_bwd_kernel_nat_bh (:530), launched by
//            _nat_bwd_core (:575, pallas_call :580), math _dropout_bwd_math
//            (:147-166).
// Forward, per (b, h, i): P = softmax(q kᵀ * scale + bias) in float32,
// P * keep in float32 (keep = 1 / (1 - rate) or 0), rounded to v's dtype,
// out = (P * keep) v accumulated in float32. Backward: P recomputed,
// dv = (P * keep)ᵀ g, dP = (g vᵀ) * keep, dS = P * (dP - rowsum(dP * P)),
// dq = dS k * scale, dk = dSᵀ q * scale.
//
// The mask. The TPU kernel draws it from the Mosaic PRNG and saves it as a
// [B, H, Lq, Lk] bf16 tensor for the backward, because that PRNG cannot be
// replayed. Here keep(b, h, i, j) = fmix32(n * 0x9E3779B9 + seed) <
// threshold, n the element's linear index in [B, H, Lq, Lk] modulo 2^32, the
// counter hash of the JAX package's hash_dropout (models/layers.py:216-255)
// with a uint32 seed per call and threshold = int((1 - rate) * (2^32 - 1))
// computed by the caller in double precision. The backward replays the hash,
// so no mask is saved: at B = 256, L = 60, H = 12 that is 133 MB (uint8) or
// 265 MB (bf16) of device memory and traffic per layer that never exists.
// The forward writes the 0/1 mask it applied to mask_out only when asked
// (tests and chip_smoke.py compare it with the plain twin's).
//
// The forward runs row 1's body through its dropout flavour
// (attention_dropout_fwd_body): in bf16 the tensor-core body of
// attention_fwd_tc.cuh with kDropout, which draws each probability's keep
// bit once where it forms p and multiplies it in before the rounding; in
// float32 the CUDA-core attention_fwd_block with kDropout, whose
// tensor-core counterpart would compute in TF32. Its floor is row 1's, 28
// us at B = 256, L = 60, H = 12, D = 64 in bf16, plus 11.1 M hashes of
// about 10 integer operations each. In bf16 it takes 0.053 ms there, 0.53
// of that floor, where the CUDA-core body took 0.29 ms, bound by the issue
// of its loops (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 4).
//
// The backward runs row 2's body through its dropout flavour
// (attention_bwd_body with kDropout): in bf16 the tensor-core body of
// attention_bwd_tc.cuh, which replays each probability's keep bit once
// (about 10 integer operations, 0.11 G a call at the serving shape) and
// keeps it in shared memory for its second sweep; in float32 the
// CUDA-core attention_bwd_block, whose tensor-core counterpart would
// compute in TF32. It is bound by bytes: q, k, v and g read and dq, dk, dv
// written, 165 MB at B = 256, L = 60, H = 12, D = 64 in bf16, 49 us at
// 3.35 TB/s. In bf16 it takes 0.141 ms there, 0.35 of that floor (0.73 ms
// on the CUDA-core body; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py
// phase 4), 27 us more than row 2 on the same body (the suspects, not
// measured apart: the keep bits' draw and the spills it adds).

#include "attention_bwd_tc.cuh"

namespace {

// Row 3: attention_dropout_fwd_body, the keep bits drawn from the hash;
// mask (null unless asked for) receives them. bf16 runs the tensor-core
// body in this kernel, which asks for kFwdMinBlocks blocks an SM; float32
// runs the CUDA-core body in the next, which leaves its registers to the
// compiler (dropout_fwd_kernel picks).
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, (kFwdMinBlocks<T, D>))
attention_dropout_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int Lq, int Lk, int H,
                             float scale, Dropout drop,
                             uint8_t* __restrict__ mask) {
  attention_dropout_fwd_body<T, D, false>(q, k, v, bias, out, Lq, Lk, H,
                                          scale, drop, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_fwd_core_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const float* __restrict__ bias,
                                  T* __restrict__ out, int Lq, int Lk, int H,
                                  float scale, Dropout drop,
                                  uint8_t* __restrict__ mask) {
  attention_dropout_fwd_body<T, D, false>(q, k, v, bias, out, Lq, Lk, H,
                                          scale, drop, mask);
}

// Row 3's kernel for operands T (see kFwdMinBlocks).
template <typename T, int D>
constexpr auto dropout_fwd_kernel() {
  if constexpr (kTensorCore<T>)
    return attention_dropout_fwd_kernel<T, D>;
  else
    return attention_dropout_fwd_core_kernel<T, D>;
}

// Row 4: attention_bwd_body with kDropout (tensor cores for bf16, the
// CUDA-core body for float32), the keep bits replayed from the hash.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads<T>, (kBwdMinBlocks<T, D>))
attention_dropout_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ bias,
                             const T* __restrict__ g, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv,
                             float* __restrict__ db_part, int Lq, int Lk,
                             int H, float scale, Dropout drop) {
  attention_bwd_body<T, D, false, true>(q, k, v, bias, g, dq, dk, dv,
                                        db_part, Lq, Lk, H, scale, drop,
                                        nullptr);
}

template <typename T>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* mask, int B,
                         int Lq, int Lk, int H, int D, float scale,
                         Dropout drop, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_fwd_body<T, kD>(
             dropout_fwd_kernel<T, kD>(), q, k, v, bias, out, B, Lq, Lk, H,
             scale, stream, drop, static_cast<uint8_t*>(mask)))
}

template <typename T>
cudaError_t launch_bwd_d(const void* q, const void* k, const void* v,
                         const void* bias, const void* g, void* dq, void* dk,
                         void* dv, int B, int Lq, int Lk, int H, int D,
                         float scale, Dropout drop, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_bwd_body<T, kD, true>(
             attention_dropout_bwd_kernel<T, kD>, q, k, v, bias, g, dq, dk, dv,
             nullptr, B, Lq, Lk, H, scale, stream, drop))
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; mask (uint8 [B, H, Lq, Lk]) may be
// null; keep_scale = float32(1 / (1 - rate)). Returns the launch's
// cudaError_t.
extern "C" int volta_attention_dropout_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* mask, int B, int Lq, int Lk, int H, int D, float scale,
    uint32_t seed, uint32_t threshold, float keep_scale, int dtype,
    int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, keep_scale};
  if (dtype == 0)
    return launch_fwd_d<float>(q, k, v, bias, out, mask, B, Lq, Lk, H, D,
                               scale, drop, s);
  if (dtype == 1)
    return launch_fwd_d<__nv_bfloat16>(q, k, v, bias, out, mask, B, Lq, Lk,
                                       H, D, scale, drop, s);
  return cudaErrorInvalidValue;
}

extern "C" int volta_attention_dropout_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* g, void* dq, void* dk, void* dv, int B, int Lq, int Lk,
    int H, int D, float scale, uint32_t seed, uint32_t threshold,
    float keep_scale, int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Dropout drop{seed, threshold, keep_scale};
  if (dtype == 0)
    return launch_bwd_d<float>(q, k, v, bias, g, dq, dk, dv, B, Lq, Lk, H, D,
                               scale, drop, s);
  if (dtype == 1)
    return launch_bwd_d<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, B, Lq,
                                       Lk, H, D, scale, drop, s);
  return cudaErrorInvalidValue;
}
