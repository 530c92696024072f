// No-dropout joint attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel _attn_bwd_kernel_nat_bh
// (volta_tpu/ops/pallas_attention.py:683), launched by _nat_eval_bwd_rule
// (:742, pallas_call at :750), the backward of pallas_fused_attention_nat.
// It computes the _attn_bwd_math recipe (:884-904) per (b, h):
//   P = softmax(q kᵀ * scale + bias) in float32, recomputed (not rounded)
//   dv = Pᵀ g,  dP = g vᵀ,  dS = P * (dP - rowsum(dP * P))
//   dq = dS k * scale,  dk = dSᵀ q * scale,  db[b, j] = sum_{h, i} dS[i, j]
// every product accumulated in float32, dq/dk/dv stored in the operand
// dtype. The TPU kernel sums db over the heads of its batch tile; here each
// block writes its head's partial sums to db_part [B, H, Lk] and the
// wrapper sums over H (the head-major TPU path, _attn_bwd_pallas :941, sums
// its per-head partials the same way). db_part may be null: no bias in the
// repo needs a gradient, and the wrapper then skips it.
//
// What bounds it on this card: at B = 256, L = 60, H = 12, D = 64 in bf16 it
// must read q, k, v, g (94 MB) and write dq, dk, dv (71 MB), 49 us at
// 3.35 TB/s, against 5 * 2 * L * L * D flops per (b, h) (7.1 GFLOP), which
// the CUDA cores retire in ~0.1 ms at their 67 TFLOP/s float32 peak. The
// design keeps the [L, L] tiles in shared memory (attention_bwd_block in
// attention_common.cuh): one block of 8 warps per (b, h), S/P and dP/dS as
// two float32 tiles, q/g staged 32 rows and k/v 32 keys at a time for the
// two score products, then dq, dk, dv accumulated in registers with lanes
// splitting D. It is bound by the issue of its FMA and shared-memory loops,
// like the forward; tensor cores are later work.
//
// Shared memory: 2 x Lq x Lk floats of tiles (each length rounded up to 4)
// + 2 x 32 x D + 2 x 32 x (D + 1) floats of staging: Lq = Lk = 60 at D = 64
// takes 62 KB; the square limit is 144 at D = 128 and 164 at D = 16.

#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ db_part, int Lq, int Lk, int H,
                     float scale) {
  attention_bwd_block<T, D, false, false>(q, k, v, bias, g, dq, dk, dv,
                                          db_part, Lq, Lk, H, scale,
                                          Dropout{0u, 0u, 0.f}, nullptr);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, const void* g, void* dq, void* dk,
                   void* dv, void* db_part, int B, int Lq, int Lk, int H,
                   float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(Lq, Lk, D);
  auto kern = attention_bwd_kernel<T, D>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(B) * H, kBwdWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(db_part), Lq, Lk, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, const void* g, void* dq, void* dk,
                     void* dv, void* db_part, int B, int Lq, int Lk, int H,
                     int D, float scale, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch<T, kD>(q, k, v, bias, g, dq, dk, dv, db_part, B, Lq,
                              Lk, H, scale, stream))
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; db_part may be null. Returns the
// launch's cudaError_t.
extern "C" int volta_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* bias, const void* g, void* dq,
                                   void* dk, void* dv, void* db_part, int B,
                                   int Lq, int Lk, int H, int D, float scale,
                                   int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, bias, g, dq, dk, dv, db_part, B, Lq, Lk,
                           H, D, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, bias, g, dq, dk, dv, db_part, B,
                                   Lq, Lk, H, D, scale, s);
  return cudaErrorInvalidValue;
}
