// The band layout of the port's redesigned row kernels (sm_90a): the
// LayerNorm forward and backward of layernorm.cu and the fused dropout +
// residual + LayerNorm backward of fused_residual.cu. It keeps rownorm.cuh's
// row layout (a warp owns a row, lane l holds the row's 16-byte vectors l,
// l + 32, ... as kPer float32 slots, slot_elem) and changes what a warp
// does over its life:
//
// - A grid that fills the card once. The host launches as many blocks as
//   the SMs hold at once (band_blocks in layernorm.py: the SM count times
//   the blocks an SM holds, from the occupancy API), and warp w of the
//   grid's W warps walks the band of rows [w * n / W, (w + 1) * n / W)
//   (band_range), so every warp gets floor(n / W) or ceil(n / W) rows and
//   there is no ragged second wave.
// - Vectors read once. A [d] float32 parameter vector is read once a warp
//   into the lane's slots (LaneVec) and kept in registers for every row of
//   the band where they fit (kPer <= kRegSlots); wider rows read it from
//   L1 at each use, as rownorm.cuh does.
// - The next row in flight. The next row's 16-byte vectors are loaded
//   into registers, unconverted (RawRow), before the current row's
//   reductions, so each warp has a row's loads in flight while it computes
//   (kPer <= kRegSlots; wider rows load, compute and store in turn).

#pragma once

#include "rownorm.cuh"

namespace {

// Slots a lane keeps parameter vectors and the next row in registers for:
// d <= 1024 in bf16 and fp32 (d = 768 is 24 slots).
constexpr int kRegSlots = 32;
// Threads of a band block; blocks of rows up to kRegSlots slots are held to
// 128 registers a thread, so that two fit on an SM.
constexpr int kBandThreads = 256;
constexpr int kBandWarps = kBandThreads / 32;

template <int kPer>
constexpr int band_min_blocks() {
  return kPer <= kRegSlots ? 2 : 1;
}

// Rows [r0, r1) of the grid's warp `warp` of `warps` for n rows.
__device__ __forceinline__ void band_range(long long warp, long long warps,
                                           int n, int& r0, int& r1) {
  r0 = static_cast<int>(warp * n / warps);
  r1 = static_cast<int>((warp + 1) * n / warps);
}

// The 32-bit words of a 16-byte vector of T: element j of the vector is
// half j % 2 of word j / 2 (bf16) or word j (fp32), little-endian as in
// memory.
template <typename T>
struct RawBits;
template <>
struct RawBits<float> {
  static constexpr int kPerWord = 1;
  // word k of the vector at p + e0, elements past d as 0
  __device__ __forceinline__ static uint32_t word(const float* p, int e0,
                                                  int k, int d) {
    return e0 + k < d ? __float_as_uint(p[e0 + k]) : 0u;
  }
  __device__ __forceinline__ static float get(uint32_t w, int) {
    return __uint_as_float(w);
  }
};
template <>
struct RawBits<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ __forceinline__ static uint32_t word(const __nv_bfloat16* p,
                                                  int e0, int k, int d) {
    const int e = e0 + 2 * k;
    const uint32_t lo = e < d ? __bfloat16_as_ushort(p[e]) : 0u;
    const uint32_t hi = e + 1 < d ? __bfloat16_as_ushort(p[e + 1]) : 0u;
    return lo | hi << 16;
  }
  // a bf16 is the top half of the float32 with the same value
  __device__ __forceinline__ static float get(uint32_t w, int half) {
    return __uint_as_float(half ? w & 0xFFFF0000u : w << 16);
  }
};

__device__ __forceinline__ uint32_t& word_of(uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}
__device__ __forceinline__ uint32_t word_of(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// A row's slots as the lane's 16-byte vectors, loaded but not converted.
// Slots past d hold zero bits (0 in both dtypes).
template <typename T, int kPer>
struct RawRow {
  static constexpr int N = Vec16<T>::N;
  uint4 r[kPer / N];

  __device__ __forceinline__ void load(const T* __restrict__ p, int d,
                                       int lane, bool vec) {
#pragma unroll
    for (int i = 0; i < kPer / N; ++i) {
      const int e0 = (i * 32 + lane) * N;
      if (vec && e0 < d) {
        r[i] = __ldg(reinterpret_cast<const uint4*>(p + e0));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          word_of(r[i], k) = RawBits<T>::word(p, e0, k, d);
      }
    }
  }

  // slot s = i * N + j as float32
  __device__ __forceinline__ float at(int s) const {
    constexpr int kW = RawBits<T>::kPerWord;
    const int i = s / N, j = s % N;
    return RawBits<T>::get(word_of(r[i], j / kW), j % kW);
  }
};

// A [d] float32 vector as the lane's slots: in registers (read once, with
// 16-byte loads where the pointer and d allow) up to kRegSlots slots,
// else read from L1 at each use.
template <typename T, int kPer, bool kRegs = (kPer <= kRegSlots)>
struct LaneVec {
  float v[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ p, int d,
                                       int lane) {
    constexpr int N = Vec16<T>::N;
    const bool vec4 =
        d % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
#pragma unroll
    for (int i = 0; i < kPer / N; ++i) {
      const int e0 = (i * 32 + lane) * N;
#pragma unroll
      for (int j = 0; j < N; j += 4) {
        if (vec4 && e0 + j < d) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(p + e0 + j));
          v[i * N + j] = t.x;
          v[i * N + j + 1] = t.y;
          v[i * N + j + 2] = t.z;
          v[i * N + j + 3] = t.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[i * N + j + k] = e0 + j + k < d ? __ldg(p + e0 + j + k) : 0.f;
        }
      }
    }
  }

  __device__ __forceinline__ float operator()(int s, int) const {
    return v[s];
  }
};

template <typename T, int kPer>
struct LaneVec<T, kPer, false> {
  const float* p;
  int d;

  __device__ __forceinline__ void load(const float* __restrict__ q, int dd,
                                       int) {
    p = q;
    d = dd;
  }

  __device__ __forceinline__ float operator()(int s, int lane) const {
    const int e = slot_elem<T>(s, lane);
    return e < d ? __ldg(p + e) : 0.f;
  }
};

// A [d] float32 vector into shared memory in the lanes' slot order, by the
// whole block: slots 4q .. 4q + 3 of lane l (slot_elem) as one float4 at
// v[q][l], 0 past d, so that a warp reads it 16 conflict-free bytes a lane.
// The caller synchronises the block before reading it.
template <typename T, int kPer>
__device__ __forceinline__ void fill_slots(float4 (&v)[kPer / 4][32],
                                           const float* __restrict__ p,
                                           int d) {
  for (int k = threadIdx.x; k < kPer / 4 * 32; k += blockDim.x) {
    const int q = k / 32, lane = k % 32;
    float t[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = slot_elem<T>(4 * q + j, lane);
      t[j] = e < d ? __ldg(p + e) : 0.f;
    }
    v[q][lane] = make_float4(t[0], t[1], t[2], t[3]);
  }
}

// The N = 16 / sizeof(T) values o of the row's vector at element e0 (d
// elements), rounded to T: one 16-byte store where vec allows, else one
// element at a time, skipping elements past d.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ p, int e0, int d,
                                          bool vec, const float* o) {
  constexpr int N = Vec16<T>::N;
  if (vec && e0 < d) {
    Vec16<T>::store(p + e0, o);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (e0 + j < d) p[e0 + j] = from_float<T>(o[j]);
  }
}

// Sum of t[0..K) as a tree: strides K/2, K/4, ..., 1 (K a power of 2).
template <int K>
__device__ __forceinline__ float tree_sum(float (&t)[K]) {
#pragma unroll
  for (int stride = K / 2; stride > 0; stride /= 2) {
#pragma unroll
    for (int i = 0; i < stride; ++i) t[i] += t[i + stride];
  }
  return t[0];
}

constexpr int kSumWarps = 32;

// The second kernel of a band backward's call: out[c] for the 2 * d
// columns c of the blocks' partials part [2, blocks, d] (out is [2, d]:
// dscale, then dbias). Warp k sums blocks k, k + 32, ... in order, then a
// tree over the 32 warps, so the sums are the same from run to run. A
// warp's loads are independent, so each thread has few round trips to
// memory.
__global__ void __launch_bounds__(kSumWarps * 32)
band_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                int blocks, int d) {
  __shared__ float t[kSumWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < 2 * d) {
    const float* p =
        part + static_cast<size_t>(c / d) * blocks * d + c % d;
#pragma unroll 8
    for (int k = warp; k < blocks; k += kSumWarps)
      s += p[static_cast<size_t>(k) * d];
  }
  t[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < 2 * d) {
    float v[kSumWarps];
#pragma unroll
    for (int k = 0; k < kSumWarps; ++k) v[k] = t[k][lane];
    out[c] = tree_sum(v);
  }
}

// Launches band_sum_kernel over the partials of a band backward's grid of
// `blocks` blocks.
inline cudaError_t launch_band_sum(const float* part, float* out, int blocks,
                                   int d, cudaStream_t stream) {
  band_sum_kernel<<<(2 * d + 31) / 32, kSumWarps * 32, 0, stream>>>(
      part, out, blocks, d);
  return cudaGetLastError();
}

}  // namespace
