// Device code shared by the port's attention kernels (sm_90a).
//
// One forward block body (attention_fwd_block) serves the no-dropout
// forward (attention_fwd.cu) and the dropout forward (attention_dropout.cu);
// one backward block body (attention_bwd_block) serves the no-dropout
// backward (attention_bwd.cu) and the dropout backward
// (attention_dropout.cu). The dropout flavour is a template flag, so the
// no-dropout kernels compile without a trace of it.
//
// Numerics follow the TPU kernels of volta_tpu/ops/pallas_attention.py:
// scores in float32 from the operands, softmax in float32, the dropout keep
// scale applied in float32 before the probabilities are rounded to v's
// dtype (forward), every backward product accumulated in float32, outputs
// stored in the operand dtype.
//
// Dropout mask: keep(b, h, i, j) = fmix32(n * 0x9E3779B9 + seed) < threshold
// with n = ((b * H + h) * Lq + i) * Lk + j modulo 2^32, the counter hash of
// volta_tpu/models/layers.py:hash_dropout over the [B, H, Lq, Lk]
// probabilities. The TPU kernels draw the mask from the Mosaic PRNG and save
// it for the backward because that PRNG cannot be replayed
// (pallas_attention.py:91-97); the hash can, so the backward recomputes it
// and no mask tensor exists. The hash and the other helpers shared with the
// LayerNorm kernels are in common.cuh.

#pragma once

#include "common.cuh"

namespace {

// Mirrored in ops/attention_cuda.py (smem_bytes, bwd_smem_bytes).
constexpr int kWarps = 4;         // forward: warps per block
constexpr int kRowsPerWarp = 4;   // query (or key) rows a warp carries at once
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;  // forward query tile
constexpr int kKeyChunk = 32;     // keys staged per round, one per lane
constexpr int kBwdWarps = 8;      // backward: warps per block
constexpr int kBwdRows = kBwdWarps * kRowsPerWarp;  // query rows staged at once

// Rows [0, n) of one head's [rows, D] slice (row stride hd elements) into
// shared memory as float32 with row stride ld; rows [n, nrows) are zeroed.
// 16-byte loads, neighbouring threads on neighbouring addresses.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           size_t hd, int n, int nrows,
                                           float* dst, int ld, int tid) {
  constexpr int kVec = Vec16<T>::N;
  for (int idx = tid * kVec; idx < nrows * D; idx += kThreads * kVec) {
    const int r = idx / D;
    const int d = idx % D;
    float x[kVec];
    if (r < n) {
      Vec16<T>::load(src + static_cast<size_t>(r) * hd + d, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + d + e] = x[e];
  }
}

struct Dropout {
  uint32_t seed;       // per call
  uint32_t threshold;  // keep where the hash is below it
  float scale;         // float32(1 / (1 - rate)), the kept value's factor
};

// linear index of probability (b, h, i, j) in [B, H, Lq, Lk], modulo 2^32
__device__ __forceinline__ uint32_t prob_index(int b, int h, int i, int j,
                                               int H, int Lq, int Lk) {
  return ((static_cast<uint32_t>(b) * H + h) * Lq + i) * Lk + j;
}

// the dropout factor of one probability: drop.scale if kept, else 0
__device__ __forceinline__ float keep_factor(const Dropout& drop,
                                             uint32_t n) {
  return hash_keep(n, drop.seed, drop.threshold) ? drop.scale : 0.f;
}

// ---------------------------------------------------------------- forward
// One block owns one (b, h) pair and a tile of kRowsPerBlock query rows;
// each of its kWarps warps carries kRowsPerWarp rows at once. Scores: K is
// staged through shared memory kKeyChunk keys at a time (row stride D + 1,
// so lane j reading key j's row hits its own bank); lane j scores key j
// against the warp's rows, each K value feeding kRowsPerWarp FMAs while the
// query rows are broadcast from shared memory. The rows' scores stay in
// shared memory for the softmax (no [B,H,Lq,Lk] tensor in device memory).
// PV: lanes split the head dimension, so V rows are read coalesced from
// global memory, each V value feeding the warp's rows. Shared memory:
// kRowsPerBlock x D + kKeyChunk x (D + 1) + kRowsPerBlock x lk_pad floats.
// With kDropout the probabilities are multiplied by their keep factor in
// float32 before the rounding to T; mask_out, when not null, receives the
// 0/1 keep mask [B, H, Lq, Lk] the block applied.
template <typename T, int D, bool kDropout>
__device__ __forceinline__ void attention_fwd_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    T* __restrict__ out, int Lq, int Lk, int H, float scale, int lk_pad,
    Dropout drop, uint8_t* __restrict__ mask_out) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kPerLane = D >= 32 ? D / 32 : 1;  // output columns per lane
  constexpr int kLanes = D / kPerLane;            // lanes that own columns
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
  stage_rows<T, D, kThreads>(qb, hd, min(kRowsPerBlock, Lq - i0),
                             kRowsPerBlock, qs, D, tid);

  // scores, one chunk of keys at a time: lane j scores key c + j
  for (int c = 0; c < Lk; c += kKeyChunk) {
    const int nk = min(kKeyChunk, Lk - c);
    __syncthreads();  // the previous chunk is consumed, qs is written
    stage_rows<T, D, kThreads>(kb + static_cast<size_t>(c) * hd, hd, nk, nk,
                               ks, kKs, tid);
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
    const int i = i0 + r0 + r;
    for (int j = lane; j < Lk; j += 32) {
      float p = pr[j] / sum;
      if constexpr (kDropout) {
        const float f = keep_factor(drop, prob_index(b, h, i, j, H, Lq, Lk));
        p *= f;
        if (mask_out != nullptr && i < Lq)
          mask_out[((static_cast<size_t>(b) * H + h) * Lq + i) * Lk + j] =
              f != 0.f;
      }
      pr[j] = to_float(from_float<T>(p));
    }
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

template <int D>
size_t fwd_smem_bytes(int Lk) {
  const size_t lk_pad = (Lk + 3) & ~3;
  return (static_cast<size_t>(kRowsPerBlock) * (D + lk_pad) +
          static_cast<size_t>(kKeyChunk) * (D + 1)) * sizeof(float);
}

// --------------------------------------------------------------- backward
// One block owns one (b, h) pair and all of its Lq queries and Lk keys, so
// the sums over keys (dq) and over queries (dk, dv, db) stay inside it.
//
// Phase 1, kBwdRows query rows at a time: q and g rows are staged in shared
// memory, K and V kKeyChunk keys at a time; lane j computes q_i . k_j and
// g_i . v_j for the warp's rows (the forward's scheme, twice). The block
// keeps two [Lq, Lk] float32 tiles: S (scaled scores + bias), then P after
// the softmax, then P * keep; and dP = g vᵀ (* keep), then
// dS = P * (dP - rowsum(dP * P)).
// Phase 2: dq = dS . K * scale, lanes split D, each K row read coalesced
// from global memory (L2-resident) feeds the warp's 4 rows.
// Phase 3: dk = dSᵀ . Q * scale and dv = (P * keep)ᵀ . G, each warp owning
// 4 keys, the 4 columns of dS and P read as one float4 per query; with a
// db_part pointer, db_part[b, h, j] = sum_i dS[i, j] (its sum over heads is
// the bias gradient).
// Shared memory: 2 x lq4 x lk_pad + 2 x kBwdRows x D + 2 x kKeyChunk x (D+1)
// floats, lq4 and lk_pad the lengths rounded up to 4.
template <typename T, int D, bool kDropout>
__device__ __forceinline__ void attention_bwd_block(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ bias,
    const T* __restrict__ g, T* __restrict__ dq, T* __restrict__ dk,
    T* __restrict__ dv, float* __restrict__ db_part, int Lq, int Lk, int H,
    float scale, Dropout drop) {
  constexpr int kThreads = kBwdWarps * 32;
  constexpr int kPerLane = D >= 32 ? D / 32 : 1;
  constexpr int kLanes = D / kPerLane;
  constexpr int kKs = D + 1;
  const int lq4 = (Lq + 3) & ~3;
  const int lk_pad = (Lk + 3) & ~3;

  extern __shared__ float smem[];
  float* ps = smem;                    // [lq4][lk_pad]: S, P, then P * keep
  float* dps = ps + lq4 * lk_pad;      // [lq4][lk_pad]: dP, then dS
  float* qs = dps + lq4 * lk_pad;      // [kBwdRows][D]
  float* gs = qs + kBwdRows * D;       // [kBwdRows][D]
  float* ks = gs + kBwdRows * D;       // [kKeyChunk][D + 1]
  float* vs = ks + kKeyChunk * kKs;    // [kKeyChunk][D + 1]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const size_t hd = static_cast<size_t>(H) * D;
  const size_t qoff = static_cast<size_t>(b) * Lq * hd + h * D;
  const size_t koff = static_cast<size_t>(b) * Lk * hd + h * D;
  const T* qb = q + qoff;
  const T* gb = g + qoff;
  const T* kb = k + koff;
  const T* vb = v + koff;
  const float* bb = bias + static_cast<size_t>(b) * Lk;
  const int wr = warp * kRowsPerWarp;  // the warp's first row of a group

  // phase 1: S and dP, then the softmax and dS of each row
  for (int g0 = 0; g0 < Lq; g0 += kBwdRows) {
    const int nr = min(kBwdRows, Lq - g0);
    __syncthreads();  // every warp is done with the previous group
    stage_rows<T, D, kThreads>(qb + static_cast<size_t>(g0) * hd, hd, nr,
                               kBwdRows, qs, D, tid);
    stage_rows<T, D, kThreads>(gb + static_cast<size_t>(g0) * hd, hd, nr,
                               kBwdRows, gs, D, tid);
    for (int c = 0; c < Lk; c += kKeyChunk) {
      const int nk = min(kKeyChunk, Lk - c);
      __syncthreads();  // the previous chunk is consumed, qs/gs are written
      stage_rows<T, D, kThreads>(kb + static_cast<size_t>(c) * hd, hd, nk,
                                 nk, ks, kKs, tid);
      stage_rows<T, D, kThreads>(vb + static_cast<size_t>(c) * hd, hd, nk,
                                 nk, vs, kKs, tid);
      __syncthreads();
      if (lane < nk) {
        float sacc[kRowsPerWarp], pacc[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) sacc[r] = pacc[r] = 0.f;
        const float* kr = ks + lane * kKs;
        const float* vr = vs + lane * kKs;
#pragma unroll 2
        for (int d = 0; d < D; d += 4) {
          const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2],
                      k3 = kr[d + 3];
          const float v0 = vr[d], v1 = vr[d + 1], v2 = vr[d + 2],
                      v3 = vr[d + 3];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qs + (wr + r) * D + d);
            const float4 gv =
                *reinterpret_cast<const float4*>(gs + (wr + r) * D + d);
            sacc[r] = fmaf(qv.x, k0, sacc[r]);
            sacc[r] = fmaf(qv.y, k1, sacc[r]);
            sacc[r] = fmaf(qv.z, k2, sacc[r]);
            sacc[r] = fmaf(qv.w, k3, sacc[r]);
            pacc[r] = fmaf(gv.x, v0, pacc[r]);
            pacc[r] = fmaf(gv.y, v1, pacc[r]);
            pacc[r] = fmaf(gv.z, v2, pacc[r]);
            pacc[r] = fmaf(gv.w, v3, pacc[r]);
          }
        }
        const float bj = bb[c + lane];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int i = g0 + wr + r;
          if (i < Lq) {
            ps[i * lk_pad + c + lane] = sacc[r] * scale + bj;
            dps[i * lk_pad + c + lane] = pacc[r];
          }
        }
      }
    }
    __syncwarp();  // a warp's rows were written by that warp alone

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = g0 + wr + r;
      if (i >= Lq) break;
      float* pr = ps + i * lk_pad;
      float* dr = dps + i * lk_pad;
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
      float delta = 0.f;  // rowsum(dP * P), dP with its keep factor
      for (int j = lane; j < Lk; j += 32) {
        const float p = pr[j] / sum;
        float dp = dr[j];
        if constexpr (kDropout)
          dp *= keep_factor(drop, prob_index(b, h, i, j, H, Lq, Lk));
        pr[j] = p;
        dr[j] = dp;
        delta = fmaf(dp, p, delta);
      }
      delta = warp_sum(delta);
      for (int j = lane; j < Lk; j += 32) {
        const float p = pr[j];
        dr[j] = p * (dr[j] - delta);
        if constexpr (kDropout)
          pr[j] = p * keep_factor(drop, prob_index(b, h, i, j, H, Lq, Lk));
      }
    }
  }
  __syncthreads();  // every row's P and dS is in shared memory

  // phase 2: dq = dS . K * scale, 4 query rows per warp at a time
  for (int r0 = wr; r0 < Lq; r0 += kBwdWarps * kRowsPerWarp) {
    if (lane < kLanes) {
      float acc[kRowsPerWarp][kPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) acc[r][e] = 0.f;
      const T* kc = kb + lane * kPerLane;
      const float* dc = dps + r0 * lk_pad;  // rows past Lq are never stored
#pragma unroll 2
      for (int j = 0; j < Lk; ++j) {
        float x[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          x[e] = to_float(kc[static_cast<size_t>(j) * hd + e]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const float s = dc[r * lk_pad + j];
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) acc[r][e] = fmaf(s, x[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (r0 + r >= Lq) break;
        T* row = dq + qoff + static_cast<size_t>(r0 + r) * hd + lane * kPerLane;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          row[e] = from_float<T>(acc[r][e] * scale);
      }
    }
  }

  // phase 3: dk = dSᵀ . Q * scale, dv = (P * keep)ᵀ . G, 4 keys per warp
  for (int j0 = wr; j0 < Lk; j0 += kBwdWarps * kRowsPerWarp) {
    if (lane < kLanes) {
      float ak[kRowsPerWarp][kPerLane], av[kRowsPerWarp][kPerLane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) ak[r][e] = av[r][e] = 0.f;
      const T* qc = qb + lane * kPerLane;
      const T* gc = gb + lane * kPerLane;
#pragma unroll 2
      for (int i = 0; i < Lq; ++i) {
        float xq[kPerLane], xg[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          xq[e] = to_float(qc[static_cast<size_t>(i) * hd + e]);
          xg[e] = to_float(gc[static_cast<size_t>(i) * hd + e]);
        }
        // columns j0 .. j0 + 3 (lk_pad and j0 are multiples of 4)
        const float4 s4 =
            *reinterpret_cast<const float4*>(dps + i * lk_pad + j0);
        const float4 p4 =
            *reinterpret_cast<const float4*>(ps + i * lk_pad + j0);
        const float s[4] = {s4.x, s4.y, s4.z, s4.w};
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) {
            ak[r][e] = fmaf(s[r], xq[e], ak[r][e]);
            av[r][e] = fmaf(p[r], xg[e], av[r][e]);
          }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (j0 + r >= Lk) break;
        const size_t off = koff + static_cast<size_t>(j0 + r) * hd +
                           lane * kPerLane;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          dk[off + e] = from_float<T>(ak[r][e] * scale);
          dv[off + e] = from_float<T>(av[r][e]);
        }
      }
    }
    if (db_part != nullptr) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int j = j0 + r;
        if (j >= Lk) break;
        float acc = 0.f;
        for (int i = lane; i < Lq; i += 32) acc += dps[i * lk_pad + j];
        acc = warp_sum(acc);
        if (lane == 0)
          db_part[(static_cast<size_t>(b) * H + h) * Lk + j] = acc;
      }
    }
  }
}

inline size_t bwd_smem_bytes(int Lq, int Lk, int D) {
  const size_t lq4 = (Lq + 3) & ~3;
  const size_t lk_pad = (Lk + 3) & ~3;
  return (2 * lq4 * lk_pad + 2 * static_cast<size_t>(kBwdRows) * D +
          2 * static_cast<size_t>(kKeyChunk) * (D + 1)) * sizeof(float);
}

}  // namespace

// The head dimensions the kernels are instantiated for: runs the statement
// (a return) with the constant kD set to D, or returns cudaErrorInvalidValue.
#define VOLTA_SWITCH_HEAD_DIM(D, ...)                  \
  switch (D) {                                         \
    case 16: { constexpr int kD = 16; __VA_ARGS__; }   \
    case 32: { constexpr int kD = 32; __VA_ARGS__; }   \
    case 64: { constexpr int kD = 64; __VA_ARGS__; }   \
    case 128: { constexpr int kD = 128; __VA_ARGS__; } \
    default: return cudaErrorInvalidValue;             \
  }
