// No-dropout joint attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _attn_kernel_nat_bh
// (volta_tpu/ops/pallas_attention.py:670), launched by _nat_eval_forward
// (:706, pallas_call at :712) behind pallas_fused_attention_nat (:732). It
// computes exactly what that kernel computes, per (batch b, head h, query i):
//   s_j = (q_i . k_j) in float32 * scale + bias[b, j]
//   p_j = exp(s_j - max s) / sum exp(s - max s)
//   p_j rounded to v's dtype, out_i = sum_j p_j v_j accumulated in float32,
//   stored in q's dtype.
// q is [B, Lq, H*D], k and v are [B, Lk, H*D], bf16 or fp32, contiguous;
// head h is columns h*D .. (h+1)*D (the natural projection layout, so no
// transposes around the call). bias is [B, Lk] float32.
//
// What bounds it on this card: bytes. At the serving shape (B = 256,
// L = 60, H = 12, D = 64) q, k, v read once and out written once are 94 MB,
// 28 us at 3.35 TB/s; the 2.8 GFLOP of Q Kᵀ and P V take 2.9 us at the
// tensor cores' bf16 rate.
//
// Two block bodies, chosen by dtype at compile time (attention_fwd_body):
// - bf16, the serving path: the tensor-core body (attention_fwd_tc.cuh).
//   One block per (b, h) pair and 64 query rows, so K and V are read once
//   per pair at L = 60; Q, K, V staged as bf16 by cp.async, Q Kᵀ and P V by
//   mma.sync with ldmatrix fragments, the exact softmax in registers, two
//   passes over 64-key tiles where Lk > 64. Shared memory does not grow
//   with Lk. It takes 0.038 ms at the serving shape (NVIDIA H100 80GB
//   HBM3, 700 W, chip_smoke.py phase 3), 0.74 of the byte floor's rate and
//   less than half of F.scaled_dot_product_attention's 0.083 ms. What holds
//   it from the floor: a block loads, computes and stores in turn, so only
//   the four blocks an SM holds overlap one another's loads; a persistent
//   block that streams (b, h) pairs through a ring of stages is the next
//   step (wgmma and TMA would not shorten so small a product).
// - float32: the CUDA-core body (attention_fwd_block in
//   attention_common.cuh), because the tensor cores would compute float32
//   in TF32: one block per (b, h) pair and 16 query rows, 4 warps of 4
//   rows; K staged through shared memory 32 keys at a time in float32,
//   scores kept in shared memory, V read coalesced for PV. It is bound by
//   the issue rate and latency of those loops (0.32 ms at the serving shape
//   in bf16 on an H100 80GB HBM3 at 700 W, 11x the byte floor, before bf16
//   moved to the tensor cores). Lk = 563 at D = 128 needs 61 KB of shared
//   memory, above the 48 KB default, which the launcher raises.

#include "attention_fwd_tc.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, (kFwdMinBlocks<T, D>))
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int Lq, int Lk, int H,
                     float scale) {
  attention_fwd_body<T, D, false>(q, k, v, bias, out, Lq, Lk, H, scale);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int Lq, int Lk,
                     int H, int D, float scale, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_fwd_body<T, kD>(attention_fwd_kernel<T, kD>, q, k, v,
                                       bias, out, B, Lq, Lk, H, scale,
                                       stream))
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; device: the CUDA device of the tensors
// and of the stream. Returns the launch's cudaError_t.
extern "C" int volta_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int B, int Lq,
                                   int Lk, int H, int D, float scale,
                                   int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, bias, out, B, Lq, Lk, H, D, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, bias, out, B, Lq, Lk, H, D,
                                   scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* volta_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
