// The tensor-core forward body of the attention for bf16 operands
// (sm_90a): without dropout rows 1 (attention_fwd.cu) and 7
// (attention_head_major.cu), with kDropout rows 3 (attention_dropout.cu)
// and 9 (attention_head_major.cu). float32 operands keep the CUDA-core
// body (attention_fwd_block in attention_common.cuh): the tensor cores
// would compute them in TF32.
//
// It computes what _attn_kernel_nat_bh and _attn_kernel compute
// (volta_tpu/ops/pallas_attention.py:72-84, 676-679), per (b, h, query i):
//   s_j = (q_i . k_j) in float32 * scale + bias[b, j]
//   p_j = exp(s_j - max s) / sum exp(s - max s), in float32,
//   p_j rounded to bf16 after the division, out_i = sum_j p_j v_j
//   accumulated in float32 and stored bf16.
// bf16 products are exact in float32, so the mma's float32 sums are the
// TPU's float32 dot up to how the sum is taken: the tensor cores add in
// their own order and rounding, so a bf16 output may differ from the
// twin's (a chain of float32 FMAs, which the CUDA-core body matched to the
// bit) by a bf16 ulp, and 12 layers of them move the model's logits as any
// other summation order does (chip_smoke.py phases 9-11).
//
// Tiles. A block owns one (b, h) pair and kTcRows = 64 query rows, a warp
// one m16 tile of 16 rows, so at Lq <= 64 one block holds the whole pair
// and K and V are read from device memory once per pair. Q, K and V reach
// shared memory as bf16 by 16-byte cp.async, rows padded by 16 bytes so
// that ldmatrix finds each of its eight rows in other banks. Keys go in
// tiles of kTcKeys = 64; a tile's rows past Lk are zero-filled and its
// scores there are -inf, so they hold no share of the softmax (padded keys
// that exist keep the -10000 bias they are given).
//
// S = Q Kᵀ by mma.sync m16n8k16 (bf16 in, float32 accumulate): A from
// ldmatrix of the warp's Q rows, kept in registers for the whole block; B
// from ldmatrix of K rows, [Lk, D] row-major being the .col operand. The
// softmax is exact, not deferred: the row max and sum are taken in float32
// across the quad that holds a row (shuffles over 1 and 2) and over the key
// tiles, then p = exp(s - m) / sum and only then the rounding to bf16.
// With one key tile (Lk <= 64, the serving case) the scores stay in
// registers between the two steps. With more, two passes walk the key
// tiles: the first keeps the running max and sum (only the sum is rescaled
// when the max grows), the second computes the scores again by mma and
// forms p. Nothing of size Lk is held, so Lk is bounded by no shared
// memory. O = P V: the rounded p, packed as bf16 pairs, is the A operand
// as it lies in the accumulator's registers; V's B fragments come from
// ldmatrix.trans of the staged [keys, D] tile. The output goes through the
// warp's own Q rows in shared memory to 16-byte stores.
//
// With kDropout (attention_dropout_fwd_body) it computes the recipe of
// _attn_dropout_fwd_kernel_nat_bh (:510-523, row 3),
// _attn_dropout_fwd_kernel (:100-122, row 5) and
// _attn_dropout_fwd_hm_kernel (:125-141, row 9): the keep factor
// (float32(1 / (1 - rate)) or 0) multiplies p in float32 between the
// division and the rounding to bf16, as attention_fwd_block does, by
// __fmul_rn so that no contraction moves a bit. Each probability's keep
// bit is drawn once, where tc_pv forms its p: from the hash of its natural
// index (prob_index) in both layouts, so row 9 drops what row 3 drops and,
// on the same operands, computes row 3's bits. Pass 1 draws none. Only
// probabilities inside Lq and Lk are drawn; the others are 0 or never
// stored. mask_out, where not null (rows 5 and 9 always, row 3 when asked),
// receives the 0/1 bytes, [B, H, Lq, Lk] natural or [H, B, Lq, Lk]
// head-major: a pair's Lq·Lk bytes are one run, and each lane stores its
// two keys of a row straight from the accumulator layout, as one 2-byte
// store where Lk is even (every (i·Lk + j) is then even) and as two bytes
// where it is odd.

#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

// Mirrored in ops/attention_cuda.py (TC_ROWS_PER_BLOCK, tc_smem_bytes).
constexpr int kTcWarps = 4;             // warps a block, one m16 tile each
constexpr int kTcRows = kTcWarps * 16;  // query rows a block
constexpr int kTcKeys = 64;             // keys a tile
constexpr int kTcPad = 8;               // bf16 of padding a shared row

using bf16 = __nv_bfloat16;

// The body of operands of type T, forward (here) and no-dropout backward
// (attention_bwd_tc.cuh): the tensor cores for bf16.
template <typename T>
constexpr bool kTensorCore = std::is_same_v<T, bf16>;

// Blocks an SM that a kernel running attention_fwd_body asks the compiler
// to fit (its __launch_bounds__): 4 for the tensor-core body at D <= 64,
// which holds it to 128 registers a thread without spills and ran faster
// at the serving shape than without the cap; the compiler's choice
// elsewhere (at D = 128 the cap spills). The dropout flavour (rows 3 and 9)
// at 4 keeps 128 registers at D = 64, row 9 with 56 bytes of spills, and
// took 0.053 and 0.076 ms at the serving shape where at 3 (164 and 162
// registers, no spills) it took 0.062 and 0.082. Their float32 kernels,
// on the CUDA-core body, ask for no minimum (dropout_fwd_kernel,
// hidden_masks_fwd_kernel): asked for 1, the body took 106 and 110
// registers at D = 64 where it takes 40, and 0.57 and 0.58 ms where it
// takes 0.29 (ptxas' report; chip_ab.py, NVIDIA H100 80GB HBM3, 700 W).
template <typename T, int D>
constexpr int kFwdMinBlocks = kTensorCore<T> && D <= 64 ? 4 : 1;

// Query rows a block of the forward body of operands T.
template <typename T>
constexpr int kFwdRows = kTensorCore<T> ? kTcRows : kRowsPerBlock;

// Shared memory of one block: Q, K and V tiles of D + kTcPad bf16 a row,
// and a key tile's bias in float32.
template <int D>
constexpr size_t tc_smem_bytes() {
  return (static_cast<size_t>(kTcRows) + 2 * kTcKeys) * (D + kTcPad) *
             sizeof(bf16) +
         kTcKeys * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; 16 zero bytes
// where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, in register j, row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of matrix j (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // round to even
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Rows [0, n) of a [rows, D] bf16 slice (row stride rs elements) into
// nrows shared rows of D + kTcPad, by cp.async; rows [n, nrows) are zeros.
template <int D>
__device__ __forceinline__ void tc_stage(const bf16* __restrict__ src,
                                         size_t rs, int n, int nrows,
                                         bf16* dst, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int c = tid; c < nrows * kChunks; c += kTcWarps * 32) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * 8;
    const bool valid = r < n;
    cp_async16(dst + r * (D + kTcPad) + e,
               valid ? src + static_cast<size_t>(r) * rs + e : src, valid);
  }
}

// The bias of keys [j0, j0 + kTcKeys) (0 past Lk) into shared memory.
__device__ __forceinline__ void tc_stage_bias(const float* __restrict__ bb,
                                              int j0, int Lk, float* bs,
                                              int tid) {
  for (int j = tid; j < kTcKeys; j += kTcWarps * 32)
    bs[j] = j0 + j < Lk ? bb[j0 + j] : 0.f;
}

// The A fragments of the warp's 16 rows (from row r0) of a staged tile.
template <int D>
__device__ __forceinline__ void tc_rows_a(const bf16* tile, int r0, int lane,
                                          uint32_t (&af)[D / 16][4]) {
  constexpr int kLd = D + kTcPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(af[kk], tile + (r0 + (lane & 15)) * kLd + kk * 16 +
                            (lane >> 4) * 8);
}

// acc = A Bᵀ for the warp's 16 rows of A (its fragments af, D wide) and the
// kTcKeys rows of tile (shared, row-major, D + kTcPad a row): acc[n][e] is
// row g (+8 for e >= 2) against tile row 8 n + 2 t (+1 for odd e), with
// g = lane / 4 and t = lane % 4.
template <int D>
__device__ __forceinline__ void tc_abt(const uint32_t (&af)[D / 16][4],
                                       const bf16* tile, int lane,
                                       float (&acc)[kTcKeys / 8][4]) {
  constexpr int kLd = D + kTcPad;
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kTcKeys / 16; ++np) {
      // matrices: tile rows 16 np (+8 for the upper two) x d 16 kk (+8 odd)
      uint32_t bf[4];
      ldmatrix_x4(bf, tile + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      const uint32_t b0[2] = {bf[0], bf[1]};
      const uint32_t b1[2] = {bf[2], bf[3]};
      mma_bf16(acc[2 * np], af[kk], b0);
      mma_bf16(acc[2 * np + 1], af[kk], b1);
    }
  }
}

// One key tile's scores of the warp's 16 rows, laid out as tc_abt's acc:
// scale and bias applied in float32, -inf at keys >= nk.
template <int D>
__device__ __forceinline__ void tc_scores(const uint32_t (&qf)[D / 16][4],
                                          const bf16* ks, const float* bs,
                                          int nk, float scale, int lane,
                                          float (&s)[kTcKeys / 8][4]) {
  tc_abt<D>(qf, ks, lane, s);
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n) {
    const int j = n * 8 + 2 * t;
    const float2 bj = *reinterpret_cast<const float2*>(bs + j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int jj = j + (e & 1);
      s[n][e] = jj < nk ? s[n][e] * scale + ((e & 1) ? bj.y : bj.x)
                        : -INFINITY;
    }
  }
}

// e / l rounded to nearest, from r = 1 / l rounded to nearest: one product
// and one Newton correction. By Markstein's theorem this is the IEEE
// quotient wherever that is a normal float; it takes 3 instructions where
// a division takes a dozen and a branch, and the divisions were the
// largest cost of the softmax.
__device__ __forceinline__ float div_rn(float e, float l, float r) {
  const float q0 = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q0, l, e), r, q0);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One key tile of scores s of the rows g and g + 8 into the rows' running
// max m and sum l (only the sum is rescaled when the max grows; first: the
// tile is the row's first); s ends as exp(s - m).
__device__ __forceinline__ void tc_row_stats(float (&s)[kTcKeys / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             bool first) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = -INFINITY;
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n)
      mt = fmaxf(mt, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(mt));
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
      for (int x = 2 * r; x < 2 * r + 2; ++x) {
        s[n][x] = expf(s[n][x] - mn);
        sum += s[n][x];
      }
    sum = quad_sum(sum);
    l[r] = first ? sum : l[r] * expf(m[r] - mn) + sum;
    m[r] = mn;
  }
}

// The 0/1 keep bytes of a lane's keys j and j + 1 (j even) of its rows
// i_row[0] and i_row[1] (keep[x] as tc_abt's acc[n][x]) into mask, the
// pair's [Lq, Lk] bytes: a 2-byte store a row where Lk is even, else one a
// byte; nothing at rows past Lq or keys past Lk.
__device__ __forceinline__ void tc_put_mask(uint8_t* __restrict__ mask,
                                            const bool (&keep)[4],
                                            const int (&i_row)[2], int j,
                                            int Lq, int Lk) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (i_row[r] >= Lq || j >= Lk) continue;
    uint8_t* at = mask + static_cast<size_t>(i_row[r]) * Lk + j;
    if ((Lk & 1) == 0) {
      *reinterpret_cast<uint16_t*>(at) = static_cast<uint16_t>(
          keep[2 * r] | (keep[2 * r + 1] << 8));
    } else {
      at[0] = keep[2 * r];
      if (j + 1 < Lk) at[1] = keep[2 * r + 1];
    }
  }
}

// o += P V for one key tile: p = e / l, rounded to bf16, e[n][e'] laid out
// as tc_scores' s; i_row[r] is the query of row g + 8 r, j0 the tile's
// first key. With kDropout p is first multiplied by the keep factor of
// probability (i, j), its bit drawn here (0 outside Lq and Lk) and, where
// mask (the pair's [Lq, Lk] bytes) is not null, stored.
template <int D, bool kDropout>
__device__ __forceinline__ void tc_pv(const float (&e)[kTcKeys / 8][4],
                                      const float (&l)[2], const bf16* vs,
                                      int lane, const Dropout& drop, int b,
                                      int h, const int (&i_row)[2], int j0,
                                      int H, int Lq, int Lk,
                                      uint8_t* __restrict__ mask,
                                      float (&o)[D / 8][4]) {
  constexpr int kLd = D + kTcPad;
  const int t = lane & 3;
  const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk) {
    float p[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the lane's first key, and its keep bits (kDropout)
      [[maybe_unused]] const int j = j0 + kk * 16 + half * 8 + 2 * t;
      [[maybe_unused]] bool keep[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float pr = div_rn(e[2 * kk + half][x], l[x >> 1], r[x >> 1]);
        if constexpr (kDropout) {
          const int i = i_row[x >> 1], jj = j + (x & 1);
          keep[x] = i < Lq && jj < Lk &&
                    hash_keep(prob_index(b, h, i, jj, H, Lq, Lk), drop.seed,
                              drop.threshold);
          pr = __fmul_rn(pr, keep[x] ? drop.scale : 0.f);
        }
        p[half][x] = pr;
      }
      if constexpr (kDropout)
        if (mask != nullptr) tc_put_mask(mask, keep, i_row, j, Lq, Lk);
    }
    // the accumulator layout of key tiles 2 kk and 2 kk + 1 is the A layout
    // of keys 16 kk .. 16 kk + 15
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      // transposed matrices: keys 16 kk (+8 odd) x d 16 np (+8 upper two)
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                  (lane & 7)) * kLd +
                                np * 16 + (lane >> 4) * 8);
      const uint32_t b0[2] = {vf[0], vf[1]};
      const uint32_t b1[2] = {vf[2], vf[3]};
      mma_bf16(o[2 * np], a, b0);
      mma_bf16(o[2 * np + 1], a, b1);
    }
  }
}

// The block: grid (B * H, query tiles of kTcRows), kTcWarps * 32 threads,
// tc_smem_bytes<D>() of dynamic shared memory. With kDropout, mask_out
// (null unless asked for) receives the keep bytes, laid out by pair as the
// operands are (HeadLayout::pair).
template <int D, bool kHeadMajor, bool kDropout>
__device__ __forceinline__ void attention_fwd_tc_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ out, int Lq, int Lk, int H, float scale,
    Dropout drop, uint8_t* __restrict__ mask_out) {
  constexpr int kLd = D + kTcPad;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][kLd], then out
  bf16* ks = qs + kTcRows * kLd;                // [kTcKeys][kLd]
  bf16* vs = ks + kTcKeys * kLd;                // [kTcKeys][kLd]
  float* bs = reinterpret_cast<float*>(vs + kTcKeys * kLd);  // [kTcKeys]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i0 = blockIdx.y * kTcRows;
  const HeadLayout<kHeadMajor, D> lay{static_cast<int>(gridDim.x) / H, H};
  const size_t rs = lay.stride();
  const size_t qoff = lay.rows(b, h, Lq);
  const bf16* kb = k + lay.rows(b, h, Lk);
  const bf16* vb = v + lay.rows(b, h, Lk);
  const float* bb = bias + static_cast<size_t>(b) * Lk;
  const int r0 = warp * 16;             // the warp's rows in the tile
  const bool active = i0 + r0 < Lq;     // it has a query row to compute
  const int i_row[2] = {i0 + r0 + g, i0 + r0 + g + 8};
  const int ntiles = (Lk + kTcKeys - 1) / kTcKeys;
  uint8_t* const mask =
      mask_out == nullptr
          ? nullptr
          : mask_out + lay.pair(b, h) * Lq * static_cast<size_t>(Lk);

  tc_stage<D>(q + qoff + static_cast<size_t>(i0) * rs, rs,
              min(kTcRows, Lq - i0), kTcRows, qs, tid);
  tc_stage<D>(kb, rs, min(kTcKeys, Lk), kTcKeys, ks, tid);
  if (ntiles == 1) tc_stage<D>(vb, rs, Lk, kTcKeys, vs, tid);
  tc_stage_bias(bb, 0, Lk, bs, tid);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[D / 16][4];  // the warp's Q rows as A fragments
  if (active) tc_rows_a<D>(qs, r0, lane, qf);

  // pass 1: the rows' max and sum of exp over every key tile; s ends as
  // exp(s - m) of the last tile
  float s[kTcKeys / 8][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * kTcKeys;
    if (t > 0) {
      __syncthreads();  // every warp is done with the previous K tile
      tc_stage<D>(kb + static_cast<size_t>(j0) * rs, rs,
                  min(kTcKeys, Lk - j0), kTcKeys, ks, tid);
      tc_stage_bias(bb, j0, Lk, bs, tid);
      cp_async_wait_all();
      __syncthreads();
    }
    if (!active) continue;
    tc_scores<D>(qf, ks, bs, Lk - j0, scale, lane, s);
    tc_row_stats(s, m, l, t == 0);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  if (ntiles == 1) {
    if (active)
      tc_pv<D, kDropout>(s, l, vs, lane, drop, b, h, i_row, 0, H, Lq, Lk,
                         mask, o);
  } else {
    // pass 2: the scores again, p and P V, a K and V tile at a time
    for (int t = 0; t < ntiles; ++t) {
      const int j0 = t * kTcKeys;
      const int nk = min(kTcKeys, Lk - j0);
      __syncthreads();  // every warp is done with the previous tiles
      tc_stage<D>(kb + static_cast<size_t>(j0) * rs, rs, nk, kTcKeys, ks,
                  tid);
      tc_stage<D>(vb + static_cast<size_t>(j0) * rs, rs, nk, kTcKeys, vs,
                  tid);
      tc_stage_bias(bb, j0, Lk, bs, tid);
      cp_async_wait_all();
      __syncthreads();
      if (!active) continue;
      tc_scores<D>(qf, ks, bs, nk, scale, lane, s);
#pragma unroll
      for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[n][x] = expf(s[n][x] - m[x >> 1]);
      tc_pv<D, kDropout>(s, l, vs, lane, drop, b, h, i_row, j0, H, Lq, Lk,
                         mask, o);
    }
  }
  if (!active) return;

  // the output through the warp's own Q rows (their fragments are in
  // registers) to 16-byte stores of its rows below Lq
  const int t = lane & 3;
  bf16* os = qs + r0 * kLd;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * kLd + n * 8 + 2 * t) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * kLd + n * 8 + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * 8;
    if (i0 + r0 + r >= Lq) break;
    *reinterpret_cast<uint4*>(out + qoff +
                              static_cast<size_t>(i0 + r0 + r) * rs + e) =
        *reinterpret_cast<const uint4*>(os + r * kLd + e);
  }
}

// The no-dropout forward of rows 1 (natural) and 7 (head-major): the
// tensor-core body for bf16, the CUDA-core body for float32.
template <typename T, int D, bool kHeadMajor>
__device__ __forceinline__ void attention_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Lq, int Lk,
    int H, float scale) {
  const Dropout none{0u, 0u, 0.f};
  if constexpr (kTensorCore<T>)
    attention_fwd_tc_block<D, kHeadMajor, false>(q, k, v, bias, out, Lq, Lk,
                                                  H, scale, none, nullptr);
  else
    attention_fwd_block<T, D, false, kHeadMajor>(
        q, k, v, bias, out, Lq, Lk, H, scale, (Lk + 3) & ~3, none, nullptr);
}

// The dropout forward of rows 3 (natural) and 9 (head-major): the
// tensor-core body's kDropout flavour for bf16, the CUDA-core body with
// kDropout for float32; mask_out (null unless asked for) receives the 0/1
// keep mask, [B, H, Lq, Lk] or, head-major, [H, B, Lq, Lk].
template <typename T, int D, bool kHeadMajor>
__device__ __forceinline__ void attention_dropout_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int Lq, int Lk,
    int H, float scale, Dropout drop, uint8_t* __restrict__ mask_out) {
  if constexpr (kTensorCore<T>)
    attention_fwd_tc_block<D, kHeadMajor, true>(q, k, v, bias, out, Lq, Lk,
                                                 H, scale, drop, mask_out);
  else
    attention_fwd_block<T, D, true, kHeadMajor>(
        q, k, v, bias, out, Lq, Lk, H, scale, (Lk + 3) & ~3, drop, mask_out);
}

// Launch kern, a kernel that runs attention_fwd_body or
// attention_dropout_fwd_body <T, D, ...>, over (B * H, query tiles of
// kFwdRows<T>) with the body's shared memory; tail (the dropout kernels'
// Dropout, mask and hidden masks) follows the common arguments.
template <typename T, int D, typename Kernel, typename... Tail>
cudaError_t launch_fwd_body(Kernel kern, const void* q, const void* k,
                            const void* v, const void* bias, void* out, int B,
                            int Lq, int Lk, int H, float scale,
                            cudaStream_t stream, Tail... tail) {
  const size_t smem =
      kTensorCore<T> ? tc_smem_bytes<D>() : fwd_smem_bytes<D>(Lk);
  constexpr int rows = kFwdRows<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(B) * H, (Lq + rows - 1) / rows);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<T*>(out), Lq, Lk, H, scale, tail...);
  return cudaGetLastError();
}

static_assert(kTcWarps == kWarps, "both bodies launch kWarps * 32 threads");

}  // namespace
