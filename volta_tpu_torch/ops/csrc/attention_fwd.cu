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
// What bounds it on this card: at the serving shape (L = 60, D = 64) one
// (b, h) pair holds 60x60 scores and 2x60x64 K/V values, far too little to
// fill a tensor-core tile, and its 4*L*L*D flops are small beside its
// bytes. The floor is bytes: q, k, v read once and out written once, 94 MB
// at B = 256, 28 us at 3.35 TB/s. This CUDA-core design takes 0.32 ms there
// (NVIDIA H100 80GB HBM3, 700 W): it is bound by the issue and latency of
// its shared-memory and FMA loops, not by device memory.
//
// The block design (attention_fwd_block in attention_common.cuh, shared
// with the dropout forward): one block per (b, h) pair and 16 query rows,
// 4 warps of 4 rows; K staged through shared memory 32 keys at a time,
// scores kept in shared memory, V read coalesced for PV. Lk = 563 at
// D = 128 needs 61 KB of shared memory, above the 48 KB default, which the
// launcher raises. wgmma/TMA tiling is later work.

#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int Lq, int Lk, int H, float scale,
                     int lk_pad) {
  attention_fwd_block<T, D, false, false>(q, k, v, bias, out, Lq, Lk, H,
                                          scale, lk_pad, Dropout{0u, 0u, 0.f},
                                          nullptr);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int Lq, int Lk, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>(Lk);
  auto kern = attention_fwd_kernel<T, D>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(B) * H,
                  (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), Lq, Lk, H, scale, (Lk + 3) & ~3);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int Lq, int Lk,
                     int H, int D, float scale, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch<T, kD>(q, k, v, bias, out, B, Lq, Lk, H, scale, stream))
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
