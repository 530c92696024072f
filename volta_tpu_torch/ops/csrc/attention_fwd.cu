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
// What the design does about it: one thread block owns one (b, h) pair and
// a tile of 16 query rows; each of its 4 warps carries 4 rows at once.
// Scores: K is staged through shared memory 32 keys at a time with
// coalesced 16-byte loads (row stride D + 1, so lane j reading key j's row
// hits its own bank); lane j then scores key j against the warp's 4 rows,
// each K value feeding 4 FMAs while the query rows are broadcast from
// shared memory. The rows' scores stay in shared memory for the softmax
// (no [B,H,Lq,Lk] tensor in device memory). PV: lanes split the head
// dimension, so V rows are read coalesced from global memory, each V value
// feeding the warp's 4 rows. Shared memory is 16 x D + 32 x (D + 1) + 16 x Lk
// floats: Lk = 563 at D = 128 needs 61 KB, above the 48 KB default, which
// the launcher raises. wgmma/TMA tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

// Mirrored in ops/attention_cuda.py (smem_bytes and the grid checks).
constexpr int kWarps = 4;         // warps per block
constexpr int kRowsPerWarp = 4;   // query rows each warp carries at once
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kKeyChunk = 32;     // keys staged per round, one per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// One 16-byte load of T, widened to float.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     T* __restrict__ out, int Lq, int Lk, int H, float scale,
                     int lk_pad) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kPerLane = D >= 32 ? D / 32 : 1;  // output columns per lane
  constexpr int kLanes = D / kPerLane;            // lanes that own columns
  constexpr int kVec = Vec16<T>::N;
  constexpr int kKs = D + 1;  // row stride of the staged K chunk

  extern __shared__ float smem[];
  float* qs = smem;                        // [kRowsPerBlock][D]
  float* ks = qs + kRowsPerBlock * D;      // [kKeyChunk][D + 1]
  float* ps = ks + kKeyChunk * kKs;        // [kRowsPerBlock][lk_pad]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i0 = blockIdx.y * kRowsPerBlock;
  const size_t hd = static_cast<size_t>(H) * D;
  const T* qb = q + (static_cast<size_t>(b) * Lq + i0) * hd + h * D;
  const T* kb = k + static_cast<size_t>(b) * Lk * hd + h * D;
  const T* vb = v + static_cast<size_t>(b) * Lk * hd + h * D;
  const float* bb = bias + static_cast<size_t>(b) * Lk;
  const int r0 = warp * kRowsPerWarp;  // this warp's first row in the tile

  // the tile's query rows in fp32; rows past Lq are zero and never stored
  for (int idx = tid * kVec; idx < kRowsPerBlock * D; idx += kThreads * kVec) {
    const int r = idx / D;
    float x[kVec];
    if (i0 + r < Lq) {
      Vec16<T>::load(qb + static_cast<size_t>(r) * hd + idx % D, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qs[idx + e] = x[e];
  }

  // scores, one chunk of keys at a time: lane j scores key c + j
  for (int c = 0; c < Lk; c += kKeyChunk) {
    const int nk = min(kKeyChunk, Lk - c);
    __syncthreads();  // the previous chunk is consumed, qs is written
    for (int idx = tid * kVec; idx < nk * D; idx += kThreads * kVec) {
      const int j = idx / D;
      const int d = idx % D;
      float x[kVec];
      Vec16<T>::load(kb + static_cast<size_t>(c + j) * hd + d, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) ks[j * kKs + d + e] = x[e];
    }
    __syncthreads();
    if (lane < nk) {
      float acc[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.f;
      const float* kr = ks + lane * kKs;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + (r0 + r) * D + d);
          acc[r] = fmaf(qv.x, k0, acc[r]);
          acc[r] = fmaf(qv.y, k1, acc[r]);
          acc[r] = fmaf(qv.z, k2, acc[r]);
          acc[r] = fmaf(qv.w, k3, acc[r]);
        }
      }
      const float bj = bb[c + lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        ps[(r0 + r) * lk_pad + c + lane] = acc[r] * scale + bj;
    }
  }
  __syncwarp();  // a warp's score rows are written by that warp alone

  // softmax of each of the warp's rows, probs rounded to v's dtype
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* pr = ps + (r0 + r) * lk_pad;
    float m = -INFINITY;
    for (int j = lane; j < Lk; j += 32) m = fmaxf(m, pr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pr[j] - m);
      pr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Lk; j += 32)
      pr[j] = to_float(from_float<T>(pr[j] / sum));
  }
  __syncwarp();

  // out = P . V: lane owns columns lane * kPerLane .., for the warp's rows
  if (lane < kLanes) {
    float acc[kRowsPerWarp][kPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[r][e] = 0.f;
    const T* vc = vb + lane * kPerLane;
    const float* pc = ps + r0 * lk_pad;
#pragma unroll 2
    for (int j = 0; j < Lk; ++j) {
      float x[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        x[e] = to_float(vc[static_cast<size_t>(j) * hd + e]);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = pc[r * lk_pad + j];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) acc[r][e] = fmaf(p, x[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      if (i0 + r0 + r >= Lq) break;
      T* orow = out + (static_cast<size_t>(b) * Lq + i0 + r0 + r) * hd +
                h * D + lane * kPerLane;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) orow[e] = from_float<T>(acc[r][e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int B, int Lq, int Lk, int H,
                   float scale, cudaStream_t stream) {
  const int lk_pad = (Lk + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(kRowsPerBlock) * (D + lk_pad) +
       static_cast<size_t>(kKeyChunk) * (D + 1)) * sizeof(float);
  auto kern = attention_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(B) * H,
                  (Lq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), Lq, Lk, H, scale, lk_pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v,
                     const void* bias, void* out, int B, int Lq, int Lk,
                     int H, int D, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, bias, out, B, Lq, Lk, H, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bias, out, B, Lq, Lk, H, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, B, Lq, Lk, H, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, B, Lq, Lk, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
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
