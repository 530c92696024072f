// Device code of the port's row kernels (sm_90a): the row layout and
// helpers that every LayerNorm kernel uses (slot_elem, load_row,
// store_row, row_stats, norm_per_lane), and the body of the fused
// dropout + residual + LayerNorm forward (fused_residual.cu), which keeps
// one row per warp. The plain LayerNorm of layernorm.cu and the fused
// backward walk bands of rows instead (rowband.cuh).
//
// Numerics follow the TPU kernels (volta_tpu/ops/layernorm.py:27-54,
// volta_tpu/ops/fused_residual.py:40-91): rows of d elements normalised
// over their last axis with float32 statistics whatever the input dtype,
// two passes (mean, then the mean of the centred squares),
// rstd = rsqrt(var + eps), outputs stored in the input dtype. The backward
// is the LayerNorm VJP from the saved mean and rstd:
//   gs = g * scale, dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
//   dscale = sum over rows of g * xhat, dbias = sum over rows of g.
//
// Layout. One warp owns a row at a time. Lane l holds the row's 16-byte
// vectors l, l + 32, l + 64, ... in registers as float32 (kPer values a
// lane, kPer / N vectors of N = 16 / sizeof(T) elements), so a row is read
// once from device memory, 16 bytes a thread, neighbouring lanes on
// neighbouring addresses. kPer is a template constant chosen by the host
// from d (norm_per_lane), up to 128: widths up to 4096. Where d is not a
// multiple of N, or a pointer is not 16-byte aligned, the same layout is
// read and written one element at a time (vec = false).
//
// Bound: every kernel here moves a few bytes per element and does a few
// FLOPs per element, far below the ~20 FLOP/byte the card can feed from
// device memory in float32, so the floor is bytes (each input read once,
// each output written once).

#pragma once

#include "common.cuh"

namespace {

constexpr int kFwdWarps = 8;  // forward: one row per warp

// The dropout of the fused residual kernels: keep = hash_keep(index, seed,
// threshold) over o's linear index, kept values times scale (float32(1 /
// (1 - rate))); with drop == 0 every element is kept and scale is 1.
struct RowDropout {
  uint32_t seed;
  uint32_t threshold;
  float scale;
  int drop;
};

// element index, within its row, of slot s of lane `lane`
template <typename T>
__device__ __forceinline__ int slot_elem(int s, int lane) {
  constexpr int N = Vec16<T>::N;
  return ((s / N) * 32 + lane) * N + s % N;
}

// The lane's slots of row p (d elements) into v as float32 (kAdd: added
// to v); slots past the row read 0.
template <typename T, int kPer, bool kAdd = false>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int d,
                                         int lane, bool vec,
                                         float (&v)[kPer]) {
  constexpr int N = Vec16<T>::N;
#pragma unroll
  for (int i = 0; i < kPer / N; ++i) {
    const int e0 = (i * 32 + lane) * N;
    float t[N];
    if (vec && e0 < d) {  // d % N == 0, so the vector lies inside the row
      Vec16<T>::load(p + e0, t);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        t[j] = e0 + j < d ? to_float(p[e0 + j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (kAdd)
        v[i * N + j] += t[j];
      else
        v[i * N + j] = t[j];
    }
  }
}

// The lane's slots of v into row p, rounded to T; slots past d are skipped.
template <typename T, int kPer>
__device__ __forceinline__ void store_row(T* __restrict__ p, int d, int lane,
                                          bool vec, const float (&v)[kPer]) {
  constexpr int N = Vec16<T>::N;
#pragma unroll
  for (int i = 0; i < kPer / N; ++i) {
    const int e0 = (i * 32 + lane) * N;
    if (vec && e0 < d) {
      Vec16<T>::store(p + e0, &v[i * N]);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (e0 + j < d) p[e0 + j] = from_float<T>(v[i * N + j]);
    }
  }
}

// mean and rstd of a row held as the warp's slots (slots past d are 0)
template <typename T, int kPer>
__device__ __forceinline__ void row_stats(const float (&v)[kPer], int d,
                                          int lane, float eps, float& mean,
                                          float& rstd) {
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kPer; ++s) sum += v[s];
  mean = warp_sum(sum) / static_cast<float>(d);
  float sq = 0.f;
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const float c = v[s] - mean;
    if (slot_elem<T>(s, lane) < d) sq += c * c;
  }
  rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
}

// ---------------------------------------------------------------- forward
// One warp per row, kFwdWarps rows a block: od = dropout(o) in float32
// (keep ? o * scale : 0), s = od + x in float32, y = LN(s); od is written
// rounded to T, and the row's float32 mean and rstd.
template <typename T, int kPer>
__device__ __forceinline__ void norm_fwd_row(
    const T* __restrict__ o, const T* __restrict__ x,
    const float* __restrict__ w, const float* __restrict__ b,
    T* __restrict__ y, T* __restrict__ od, float* __restrict__ mean_out,
    float* __restrict__ rstd_out, int n, int d, float eps, bool vec,
    RowDropout drop) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const size_t base = static_cast<size_t>(row) * d;
  float v[kPer];
  load_row<T, kPer>(o + base, d, lane, vec, v);
  if (drop.drop) {
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const uint32_t idx = static_cast<uint32_t>(base + slot_elem<T>(s, lane));
      v[s] = hash_keep(idx, drop.seed, drop.threshold) ? v[s] * drop.scale
                                                        : 0.f;
    }
  }
  store_row<T, kPer>(od + base, d, lane, vec, v);
  load_row<T, kPer, true>(x + base, d, lane, vec, v);
  float mean, rstd;
  row_stats<T, kPer>(v, d, lane, eps, mean, rstd);
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int e = slot_elem<T>(s, lane);
    v[s] = e < d ? (v[s] - mean) * rstd * __ldg(w + e) + __ldg(b + e) : 0.f;
  }
  store_row<T, kPer>(y + base, d, lane, vec, v);
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// Slots a lane needs for width d in dtype T: d's 16-byte vectors spread
// over 32 lanes, times the vector width; 0 past the widest instance.
template <typename T>
inline int norm_per_lane(int d) {
  constexpr int N = Vec16<T>::N;
  static const int kInstances[] = {8, 16, 24, 32, 48, 64, 128};
  const int per = (d + 32 * N - 1) / (32 * N) * N;
  for (int k : kInstances)
    if (per <= k) return k;
  return 0;
}

}  // namespace

// The per-lane slot counts the kernels are instantiated for: runs the
// statement (a return) with the constant kPer set to PER, or returns
// cudaErrorInvalidValue.
#define VOLTA_SWITCH_PER_LANE(PER, ...)                  \
  switch (PER) {                                         \
    case 8: { constexpr int kPer = 8; __VA_ARGS__; }     \
    case 16: { constexpr int kPer = 16; __VA_ARGS__; }   \
    case 24: { constexpr int kPer = 24; __VA_ARGS__; }   \
    case 32: { constexpr int kPer = 32; __VA_ARGS__; }   \
    case 48: { constexpr int kPer = 48; __VA_ARGS__; }   \
    case 64: { constexpr int kPer = 64; __VA_ARGS__; }   \
    case 128: { constexpr int kPer = 128; __VA_ARGS__; } \
    default: return cudaErrorInvalidValue;               \
  }
