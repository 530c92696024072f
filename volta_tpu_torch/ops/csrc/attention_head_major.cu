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
//          backward, which reads that mask back;
//   row 9  _attn_dropout_fwd_hm_kernel (:125), launched by
//          _dropout_hm_fwd_impl (:809, pallas_call :818) behind
//          pallas_dropout_attention_hm (:779, fuse_hidden_dropout): row 5
//          plus the keep masks of the two hidden dropouts that follow, this
//          sublayer's tail and the next feed-forward's. Its backward is row
//          6 (_dropout_hm_bwd_rule :841 calls _dropout_bwd_rule).
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
// The blocks are those of rows 1-4 with the head-major addressing
// (HeadLayout<true>): a head's rows are D elements apart instead of H·D, so
// a block's K, V, q and g rows are one contiguous run each. Row 7 runs row
// 1's body (attention_fwd_body) and row 8 row 2's (attention_bwd_body): in
// bf16 the tensor-core bodies of attention_fwd_tc.cuh and
// attention_bwd_tc.cuh, which compute rows 1's and 2's bits, in float32
// the CUDA-core bodies. At B = 256, L = 60, H = 12, D = 64 in bf16 the
// forward's byte floor is 28 us and the backward's 49 us; row 7 takes
// 0.040 ms, as row 1 takes 0.038 (0.240 ms on the CUDA-core body), and row
// 8 takes 0.117 ms, as row 2 takes 0.114 (0.501 ms on the CUDA-core body).
// Row 6 runs row 4's body (attention_bwd_body with kDropout: tensor cores
// for bf16, CUDA cores for float32), its keep bits read once from the
// forward's mask bytes in the first sweep, so it computes row 4's bits; at
// the serving shape in bf16 its floor is 53 us (176 MB with the mask) and
// it takes 0.149 ms, as row 4 takes 0.141 (0.526 ms on the CUDA-core
// body). Row 9 runs row 3's body (attention_dropout_fwd_body: the
// tensor-core body's kDropout flavour for bf16, the CUDA-core body with
// kDropout for float32), which draws the keep bits from the natural index's
// hash and writes them as the [H, B, Lq, Lk] bytes row 6 reads: in bf16
// it computes row 3's bits on the same operands, and with the masks it
// writes (35 MB, its floor 38 us at the serving shape) it takes 0.077 ms
// (0.30 ms on the CUDA-core body; chip_smoke.py phase 7). Row 5 runs the
// same body without the hidden masks: in bf16 its output and mask equal
// row 9's to the bit on the same operands and seed, and its output equals
// row 3's after the layout copy; in float32 it is the CUDA-core body with
// kDropout it always ran. Its floor is row 3's plus the 11.1 MB mask, 31
// us at the serving shape; in bf16 it takes 0.061 ms there, where the
// CUDA-core body, bound by the instruction rate of its loops, took 0.287
// (all NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 5 and
// chip_ab.py).

// Row 9's hidden masks. The TPU kernel draws them from its PRNG as
// [H, B, Lq, D] bf16 and transposes them to the [B, Lq, H·D] layout of the
// out-dense output afterwards (pallas_attention.py:796). Here element
// (b, i, h·D + j) of mask m is hash_dropout's keep bit for the seed of that
// mask's tail over the natural linear index (b·Lq + i)·H·D + h·D + j, so the
// tails drop what hash_dropout would drop with the seeds they would draw,
// and it is written in place, as one byte: each (b, h) block of the
// forward writes the D contiguous bytes of each mask of the query rows of
// its body's tile (64 rows in bf16, 16 in float32), four bytes a store,
// before the attention body; no transpose follows. The
// masks add 2·B·Lq·H·D bytes to row 5's writes (23.6 MB at B = 256,
// L = 60, H = 12, D = 64: 7 us at 3.35 TB/s).

#include "attention_bwd_tc.cuh"

namespace {

// Row 7: the body of row 1 (attention_fwd_body: tensor cores for bf16, the
// CUDA-core body for float32) with the head-major addressing.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, (kFwdMinBlocks<T, D>))
attention_head_major_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                T* __restrict__ out, int Lq, int Lk, int H,
                                float scale) {
  attention_fwd_body<T, D, true>(q, k, v, bias, out, Lq, Lk, H, scale);
}

// Row 8: the body of row 2 (attention_bwd_body: tensor cores for bf16, the
// CUDA-core body for float32) with the head-major addressing.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads<T>, (kBwdMinBlocks<T, D>))
attention_head_major_bwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ bias,
                                const T* __restrict__ g, T* __restrict__ dq,
                                T* __restrict__ dk, T* __restrict__ dv,
                                float* __restrict__ db_part, int Lq, int Lk,
                                int H, float scale) {
  attention_bwd_body<T, D, true, false>(q, k, v, bias, g, dq, dk, dv,
                                        db_part, Lq, Lk, H, scale,
                                        Dropout{0u, 0u, 0.f}, nullptr);
}

// Row 5: row 3's body (attention_dropout_fwd_body) with the head-major
// addressing, writing the keep mask. bf16 runs the tensor-core body in this
// kernel, which asks for kFwdMinBlocks blocks an SM; float32 runs the
// CUDA-core body in the next, which leaves its registers to the compiler
// (dropout_head_major_fwd_kernel picks), as row 3's and row 9's kernels.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, (kFwdMinBlocks<T, D>))
attention_dropout_head_major_fwd_kernel(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const float* __restrict__ bias,
                                        T* __restrict__ out, int Lq, int Lk,
                                        int H, float scale, Dropout drop,
                                        uint8_t* __restrict__ mask) {
  attention_dropout_fwd_body<T, D, true>(q, k, v, bias, out, Lq, Lk, H,
                                         scale, drop, mask);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_head_major_fwd_core_kernel(const T* __restrict__ q,
                                             const T* __restrict__ k,
                                             const T* __restrict__ v,
                                             const float* __restrict__ bias,
                                             T* __restrict__ out, int Lq,
                                             int Lk, int H, float scale,
                                             Dropout drop,
                                             uint8_t* __restrict__ mask) {
  attention_dropout_fwd_body<T, D, true>(q, k, v, bias, out, Lq, Lk, H,
                                         scale, drop, mask);
}

// Row 5's kernel for operands T.
template <typename T, int D>
constexpr auto dropout_head_major_fwd_kernel() {
  if constexpr (kTensorCore<T>)
    return attention_dropout_head_major_fwd_kernel<T, D>;
  else
    return attention_dropout_head_major_fwd_core_kernel<T, D>;
}

// The two hidden dropouts' seeds and their keep threshold (row 9).
struct HiddenDropout {
  uint32_t seed0, seed1;
  uint32_t threshold;
};

// Row 9's hidden masks for block (b·H + h, tile) of the body it runs
// beside: that body's query rows i0 .. i0 + rows of [B, Lq, H·D] at
// columns h·D .. h·D + D, four bytes (one uint32 of 0/1 bytes) a thread a
// store.
template <int D>
__device__ __forceinline__ void hidden_masks_block(
    uint8_t* __restrict__ hm0, uint8_t* __restrict__ hm1, int i0, int rows,
    int Lq, int H, const HiddenDropout& hd) {
  constexpr int kWords = D / 4;  // uint32 words of a row's D bytes
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  for (int idx = threadIdx.x; idx < rows * kWords; idx += kWarps * 32) {
    const int i = i0 + idx / kWords;
    const size_t off =
        ((static_cast<size_t>(b) * Lq + i) * H + h) * D + (idx % kWords) * 4;
    const uint32_t n = static_cast<uint32_t>(off);  // the hash's index
    uint32_t w0 = 0, w1 = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w0 |= static_cast<uint32_t>(hash_keep(n + e, hd.seed0, hd.threshold))
            << (8 * e);
      w1 |= static_cast<uint32_t>(hash_keep(n + e, hd.seed1, hd.threshold))
            << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(hm0 + off) = w0;
    *reinterpret_cast<uint32_t*>(hm1 + off) = w1;
  }
}

// Row 9: the hidden masks of the body's query tile, then row 3's body
// (attention_dropout_fwd_body) with the head-major addressing, writing the
// probability mask.
template <typename T, int D>
__device__ __forceinline__ void hidden_masks_fwd_block(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Lq, int Lk,
    int H, float scale, Dropout drop, uint8_t* __restrict__ mask,
    uint8_t* __restrict__ hm0, uint8_t* __restrict__ hm1,
    const HiddenDropout& hidden) {
  const int i0 = blockIdx.y * kFwdRows<T>;
  hidden_masks_block<D>(hm0, hm1, i0, min(kFwdRows<T>, Lq - i0), Lq, H,
                        hidden);
  attention_dropout_fwd_body<T, D, true>(q, k, v, bias, out, Lq, Lk, H,
                                         scale, drop, mask);
}

// Row 9 in bf16 (the tensor-core body, kFwdMinBlocks blocks an SM asked
// for) and in float32 (the CUDA-core body, its registers left to the
// compiler), as row 3's kernels.
template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32, (kFwdMinBlocks<T, D>))
attention_dropout_hidden_masks_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Lq, int Lk,
    int H, float scale, Dropout drop, uint8_t* __restrict__ mask,
    uint8_t* __restrict__ hm0, uint8_t* __restrict__ hm1,
    HiddenDropout hidden) {
  hidden_masks_fwd_block<T, D>(q, k, v, bias, out, Lq, Lk, H, scale, drop,
                               mask, hm0, hm1, hidden);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_dropout_hidden_masks_fwd_core_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Lq, int Lk,
    int H, float scale, Dropout drop, uint8_t* __restrict__ mask,
    uint8_t* __restrict__ hm0, uint8_t* __restrict__ hm1,
    HiddenDropout hidden) {
  hidden_masks_fwd_block<T, D>(q, k, v, bias, out, Lq, Lk, H, scale, drop,
                               mask, hm0, hm1, hidden);
}

// Row 9's kernel for operands T.
template <typename T, int D>
constexpr auto hidden_masks_fwd_kernel() {
  if constexpr (kTensorCore<T>)
    return attention_dropout_hidden_masks_fwd_kernel<T, D>;
  else
    return attention_dropout_hidden_masks_fwd_core_kernel<T, D>;
}

// Row 6: the body of row 4 (attention_bwd_body with kDropout: tensor cores
// for bf16, the CUDA-core body for float32) with the head-major addressing,
// the keep bits read from the forward's mask.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads<T>, (kBwdMinBlocks<T, D>))
attention_dropout_head_major_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ db_part, int Lq, int Lk, int H, float scale,
    Dropout drop, const uint8_t* __restrict__ mask) {
  attention_bwd_body<T, D, true, true>(q, k, v, bias, g, dq, dk, dv, db_part,
                                       Lq, Lk, H, scale, drop, mask);
}

// The forwards: grid (B * H, query tiles), as rows 1 and 3, with the tile
// and shared memory of their bodies (launch_fwd_body): row 7 without
// dropout, row 5 with it (drop; mask receives the keep mask), row 9 with
// hidden too (hm[0] and hm[1] receive the hidden masks).
template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* mask, void* const* hm,
                       int B, int Lq, int Lk, int H, float scale,
                       const Dropout* drop, const HiddenDropout* hidden,
                       cudaStream_t stream) {
  if (hidden == nullptr && drop == nullptr)
    return launch_fwd_body<T, D>(attention_head_major_fwd_kernel<T, D>, q, k,
                                 v, bias, out, B, Lq, Lk, H, scale, stream);
  if (hidden != nullptr)
    return launch_fwd_body<T, D>(
        hidden_masks_fwd_kernel<T, D>(), q, k, v, bias, out, B, Lq, Lk, H,
        scale, stream, *drop, static_cast<uint8_t*>(mask),
        static_cast<uint8_t*>(hm[0]), static_cast<uint8_t*>(hm[1]), *hidden);
  return launch_fwd_body<T, D>(dropout_head_major_fwd_kernel<T, D>(), q, k, v,
                               bias, out, B, Lq, Lk, H, scale, stream, *drop,
                               static_cast<uint8_t*>(mask));
}

// The backwards: one block per (b, h) with the threads and shared memory
// of their body (launch_bwd_body), as rows 2 and 4.
template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* bias, const void* g, const void* mask,
                       void* dq, void* dk, void* dv, void* db_part, int B,
                       int Lq, int Lk, int H, float scale, const Dropout* drop,
                       cudaStream_t stream) {
  if (drop == nullptr)
    return launch_bwd_body<T, D, false>(
        attention_head_major_bwd_kernel<T, D>, q, k, v, bias, g, dq, dk, dv,
        db_part, B, Lq, Lk, H, scale, stream);
  return launch_bwd_body<T, D, true>(
      attention_dropout_head_major_bwd_kernel<T, D>, q, k, v, bias, g, dq, dk,
      dv, nullptr, B, Lq, Lk, H, scale, stream, *drop,
      static_cast<const uint8_t*>(mask));
}

template <typename T>
cudaError_t launch_fwd_d(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* mask,
                         void* const* hm, int B, int Lq, int Lk, int H, int D,
                         float scale, const Dropout* drop,
                         const HiddenDropout* hidden, cudaStream_t stream) {
  VOLTA_SWITCH_HEAD_DIM(
      D, return launch_fwd<T, kD>(q, k, v, bias, out, mask, hm, B, Lq, Lk, H,
                                  scale, drop, hidden, stream))
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
                const void* bias, void* out, void* mask, void* const* hm,
                int B, int Lq, int Lk, int H, int D, float scale,
                const Dropout* drop, const HiddenDropout* hidden, int dtype,
                int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd_d<float>(q, k, v, bias, out, mask, hm, B, Lq, Lk, H, D,
                               scale, drop, hidden, s);
  if (dtype == 1)
    return launch_fwd_d<__nv_bfloat16>(q, k, v, bias, out, mask, hm, B, Lq,
                                       Lk, H, D, scale, drop, hidden, s);
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
  return fwd(q, k, v, bias, out, nullptr, nullptr, B, Lq, Lk, H, D, scale,
             nullptr, nullptr, dtype, device, stream);
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
  return fwd(q, k, v, bias, out, mask, nullptr, B, Lq, Lk, H, D, scale, &drop,
             nullptr, dtype, device, stream);
}

// Row 9; as row 5, and hm0, hm1 (uint8 [B, Lq, H·D], 4-byte aligned)
// receive the hidden keep masks for hseed0 and hseed1 at hthreshold.
extern "C" int volta_attention_dropout_hidden_masks_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* mask, void* hm0, void* hm1, int B, int Lq, int Lk, int H, int D,
    float scale, uint32_t seed, uint32_t threshold, float keep_scale,
    uint32_t hseed0, uint32_t hseed1, uint32_t hthreshold, int dtype,
    int device, void* stream) {
  const Dropout drop{seed, threshold, keep_scale};
  const HiddenDropout hidden{hseed0, hseed1, hthreshold};
  void* const hm[2] = {hm0, hm1};
  return fwd(q, k, v, bias, out, mask, hm, B, Lq, Lk, H, D, scale, &drop,
             &hidden, dtype, device, stream);
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
