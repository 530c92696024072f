// The hidden-dropout keep mask, for Hopper (sm_90a).
//
// Replaces the TPU kernel _mask_kernel (volta_tpu/ops/dropout_mask.py:28),
// launched by pallas_keep_mask (:50, pallas_call :61), which writes a bf16
// 0/1 Bernoulli(1 - rate) keep mask [n, d] from the Mosaic PRNG for one
// sublayer tail; the apply (x / (1 - rate) where kept), the residual add and
// the LayerNorm stay outside it.
//
// The mask. The Mosaic PRNG cannot be replayed and has no counterpart here.
// Element i of the mask (its linear index modulo 2^32) is kept iff
// fmix32(i * 0x9E3779B9 + seed) < threshold (common.cuh), the counter hash
// of the JAX package's hash_dropout over the tail's linear index with the
// tail's uint32 seed: a tail that applies this mask drops exactly the
// elements hash_dropout(x, seed, rate) drops. It is stored as one byte, 0
// or 1, half the bytes of the TPU's bf16.
//
// Bound: bytes. The kernel reads nothing and writes n bytes: at the b256
// train shape (n = 15360 x 768) 11.8 MB, 3.5 us at 3.35 TB/s; the hash is
// a few integer operations per byte. Each thread writes 16 bytes at a time
// (one 16-byte store of 16 hashes), neighbouring threads on neighbouring
// addresses, over a grid-stride loop that fills the card.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks of 256 on each of 132 SMs

__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(uint8_t* __restrict__ mask, size_t n, uint32_t seed,
                 uint32_t threshold) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t nvec = n / 16;
  for (size_t v = first; v < nvec; v += stride) {
    const uint32_t base = static_cast<uint32_t>(v * 16);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        word |= static_cast<uint32_t>(
                    hash_keep(base + 4 * q + e, seed, threshold))
                << (8 * e);
      w[q] = word;
    }
    reinterpret_cast<uint4*>(mask)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  // the bytes past the last whole 16
  for (size_t i = nvec * 16 + first; i < n; i += stride)
    mask[i] = hash_keep(static_cast<uint32_t>(i), seed, threshold);
}

}  // namespace

// mask: n bytes, 16-byte aligned, receives 0/1; device: the CUDA device of
// the mask and of the stream. Returns the launch's cudaError_t.
extern "C" int volta_keep_mask(void* mask, long long n, uint32_t seed,
                               uint32_t threshold, int device,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0) return cudaSuccess;
  const long long blocks = (n / 16 + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(
      blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks));
  keep_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(mask), static_cast<size_t>(n), seed, threshold);
  return cudaGetLastError();
}
