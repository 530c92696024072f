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
// What bounds it on this card: bytes. At B = 256, L = 60, H = 12, D = 64
// in bf16 it must read q, k, v, g (94 MB) and write dq, dk, dv (71 MB),
// 49 us at 3.35 TB/s; its 10 * B * H * L * L * D operations (7.1 GFLOP)
// take 7 us at the tensor cores' bf16 rate.
//
// Two block bodies, chosen by dtype at compile time (attention_bwd_body in
// attention_bwd_tc.cuh):
// - bf16, the fine-tuning path: the tensor-core body (attention_bwd_tc.cuh).
//   One block of 4 warps per (b, h) pair; Q, G, K, V staged as bf16 by
//   cp.async; S and dP by mma.sync, the exact softmax, dq from dS in
//   registers, then Sᵀ and dPᵀ again with the keys as rows for dk and dv;
//   P and dS enter their products as bf16 hi + lo halves, so the float32
//   recipe holds. Shared memory grows with Lq alone (12 bytes a row), so
//   every length the CUDA-core body took still runs, and longer Lk too.
//   It takes 0.114 ms at the serving shape (NVIDIA H100 80GB HBM3, 700 W,
//   chip_smoke.py phase 4), 0.43 of the byte floor's rate, against 0.314 ms
//   for F.scaled_dot_product_attention's forward + backward, timed alike
//   (the head-major row 8 took 0.50 ms on the CUDA-core body, timed
//   alike). The card checks the split itself: the outputs' mean distance
//   from the recipe in float64 is the plain twin's, where one bf16
//   rounding of P and dS reads 1.57-1.59 times it (phase 4). What holds it
//   from the floor is not measured; the suspects: as in the forward, a
//   block loads, computes and stores in turn with only 3 blocks an SM to
//   overlap, and its stores are 4 bytes a lane straight from the
//   accumulators.
// - float32: the CUDA-core body (attention_bwd_block in
//   attention_common.cuh), because the tensor cores would compute float32
//   in TF32: one block of 8 warps per (b, h), S/P and dP/dS as two float32
//   [Lq, Lk] tiles in shared memory, q/g staged 32 rows and k/v 32 keys at
//   a time for the two score products, then dq, dk, dv accumulated in
//   registers with lanes splitting D. It is bound by the issue of its FMA
//   and shared-memory loops (0.50 ms for row 8 at the serving shape in bf16
//   before bf16 moved to the tensor cores). Shared memory: 2 x Lq x Lk
//   floats of tiles (each length rounded up to 4) + 2 x 32 x D + 2 x 32 x
//   (D + 1) floats of staging: Lq = Lk = 60 at D = 64 takes 62 KB; the square
//   limit is 144 at D = 128 and 164 at D = 16.

#include "attention_bwd_tc.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads<T>, (kBwdMinBlocks<T, D>))
attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     const T* __restrict__ g, T* __restrict__ dq,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ db_part, int Lq, int Lk, int H,
                     float scale) {
  attention_bwd_body<T, D, false, false>(q, k, v, bias, g, dq, dk, dv,
                                         db_part, Lq, Lk, H, scale,
                                         Dropout{0u, 0u, 0.f}, nullptr);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, const void* g, void* dq, void* dk,
                     void* dv, void* db_part, int B, int Lq, int Lk, int H,
                     int D, float scale, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_bwd_body<T, kD, false>(attention_bwd_kernel<T, kD>, q,
                                              k, v, bias, g, dq, dk, dv,
                                              db_part, B, Lq, Lk, H, scale,
                                              stream))
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
