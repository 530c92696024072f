// Counter-hash dropout in one pass, for Hopper (sm_90a): K10, the port's
// kernel for a piece of compute that the JAX package leaves to XLA.
//
// Replaces volta_tpu/models/layers.py:hash_dropout (:226-255), which has no
// Pallas kernel: keep = fmix32(n * 0x9E3779B9 + seed) < threshold over the
// element's linear index n (a uint32 iota, so n wraps modulo 2^32), then
// where(keep, x / (1 - rate), 0) with the weak-typed scalar 1 - rate
// rounded to x's dtype. On the TPU XLA fuses the draw into the epilogue
// around it and recomputes it in the backward. The port runs it at every
// training dropout site that no flag moves elsewhere: the 24 sublayer
// tails, the two embedding outputs and the pooled output of a step, and
// their backwards, which run this same kernel on the cotangent (the hash
// replayed, no mask saved): dx = where(keep, g / denom, 0).
//
// out[i] = hash_keep(i, seed, threshold) ? round(float(x[i]) / denom) : +0.
// The division is __fdiv_rn, IEEE single precision rounded to nearest, as
// XLA and torch divide on the CPU; never a reciprocal or __fdividef, and
// the build passes no --use_fast_math (ops/_build.py). bf16 rounds the
// float32 quotient to nearest even once, as JAX's bf16 division and
// torch's do. A dropped element writes +0 whatever x holds (NaN and Inf
// included), as where() does. denom is float(1 - rate) rounded to x's
// dtype by the caller (0.8984375 in bf16 at rate 0.1).
//
// Bound: bytes. It reads n elements and writes n: at a sublayer tail of
// the b256 train step ([15360, 768] bf16) 47.2 MB, 14.1 us at 3.35 TB/s;
// the hash is about 10 integer operations an element. It takes 0.0203 ms
// there (0.69 of that floor) and 0.0370 ms in float32 (floor 28.2 us),
// forward and backward alike, where the twin's twenty-odd int64 torch ops
// took 2.18 ms (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 7).
// Each thread moves
// 16 bytes a step (8 bf16 or 4 float32: one 16-byte load, one 16-byte
// store), neighbouring threads on neighbouring addresses, over a
// grid-stride loop whose grid the caller sizes from the SM count and the
// occupancy API (volta_hash_dropout_blocks_per_sm; ops/hash_dropout.py).
// The vector loop covers [head, head + nvec * W); the same threads then
// take the scalar head [0, head) before the first 16-byte boundary of x
// and the tail past the last whole vector. head comes from the caller:
// the elements before x's first 16-byte boundary where x and out lie at
// the same offset modulo 16 bytes, else all n (every element scalar).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float drop(float x, uint32_t i, uint32_t seed,
                                      uint32_t threshold, float denom) {
  return hash_keep(i, seed, threshold) ? __fdiv_rn(x, denom) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hash_dropout_kernel(T* __restrict__ out, const T* __restrict__ x, size_t n,
                    size_t head, uint32_t seed, uint32_t threshold,
                    float denom) {
  constexpr int W = Vec16<T>::N;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t first = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t nvec = (n - head) / W;
  for (size_t v = first; v < nvec; v += stride) {
    const size_t i0 = head + v * W;
    float a[W];
    Vec16<T>::load(x + i0, a);
#pragma unroll
    for (int e = 0; e < W; ++e)
      a[e] = drop(a[e], static_cast<uint32_t>(i0 + e), seed, threshold, denom);
    Vec16<T>::store(out + i0, a);
  }
  // the scalar elements: the head, then the tail past the last vector
  const size_t tail0 = head + nvec * W;
  const size_t scalars = head + (n - tail0);
  for (size_t r = first; r < scalars; r += stride) {
    const size_t i = r < head ? r : tail0 + (r - head);
    out[i] = from_float<T>(drop(to_float(x[i]), static_cast<uint32_t>(i),
                                seed, threshold, denom));
  }
}

template <typename T>
cudaError_t launch(void* out, const void* x, long long n, long long head,
                   uint32_t seed, uint32_t threshold, float denom, int blocks,
                   cudaStream_t stream) {
  hash_dropout_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(x), static_cast<size_t>(n),
      static_cast<size_t>(head), seed, threshold, denom);
  return cudaGetLastError();
}

}  // namespace

// out, x: n elements of dtype (0 = float32, 1 = bfloat16); head: the
// scalar elements before the vector loop (see above); blocks: the grid;
// device: the CUDA device of the tensors and of the stream. Returns the
// launch's cudaError_t.
extern "C" int volta_hash_dropout(void* out, const void* x, long long n,
                                  long long head, uint32_t seed,
                                  uint32_t threshold, float denom, int blocks,
                                  int dtype, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n <= 0) return cudaSuccess;
  if (head < 0 || head > n || blocks < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(out, x, n, head, seed, threshold, denom, blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, x, n, head, seed, threshold, denom,
                                 blocks, s);
  return cudaErrorInvalidValue;
}

// Blocks of the kernel for dtype that one SM of device holds at once.
extern "C" int volta_hash_dropout_blocks_per_sm(int dtype, int device,
                                                int* out) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (dtype == 0)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, hash_dropout_kernel<float>, kThreads, 0);
  if (dtype == 1)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, hash_dropout_kernel<__nv_bfloat16>, kThreads, 0);
  return cudaErrorInvalidValue;
}
