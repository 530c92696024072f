// The tensor-core backward body of the attention for bf16 operands
// (sm_90a): without dropout rows 2 (attention_bwd.cu) and 8
// (attention_head_major.cu), with kDropout rows 4 (attention_dropout.cu)
// and 6 (attention_head_major.cu). float32 operands keep the CUDA-core
// body (attention_bwd_block in attention_common.cuh): the tensor cores
// would compute them in TF32.
//
// It computes the _attn_bwd_math recipe (volta_tpu/ops/pallas_attention.py:
// 884-904) that _attn_bwd_kernel_nat_bh (:683) and _attn_bwd_kernel (:907)
// run, per (b, h):
//   P = softmax(q kᵀ * scale + bias), recomputed in float32, not rounded
//   dv = Pᵀ g,  dP = g vᵀ,  dS = P * (dP - rowsum(dP * P))
//   dq = dS k * scale,  dk = dSᵀ q * scale,  db_part[b, h, j] = sum_i dS
// every product accumulated in float32, dq, dk, dv stored bf16.
//
// Products. S = Q Kᵀ and dP = G Vᵀ take bf16 operands, so mma.sync m16n8k16
// (bf16 in, float32 accumulate) forms them exactly up to the order of the
// sum. In dq, dk and dv one operand is P or dS, which the recipe keeps in
// float32: each is split into bf16 halves, hi = bf16(x) and lo = bf16(x -
// hi), and multiplied as hi B + lo B, within about 2^-17 of x B relative
// (a single rounding of P or dS to bf16, as flash-attention kernels do,
// would be another function, 2^-9 away). The split takes the products from
// 10 to 16 B·H·Lq·Lk·D operations; with the recomputation below, 20.
//
// Two sweeps, 4 warps a block, one block per (b, h) pair; nothing of size
// Lq x Lk is held (but the dropout flavour's keep bits, below), so shared
// memory grows only by 12 bytes a query row.
// - Sweep 1, a warp per 16 query rows of a 64-row tile (tc_stage of Q and
//   G): S by mma, the exact softmax of the forward body (quad max and sum,
//   p = e / l by div_rn), dP by mma, delta = rowsum(dP * P), dS, then
//   dq = dS K * scale from the accumulator layout as A fragments (hi and
//   lo) and K's B fragments by ldmatrix.trans; dq is stored from registers.
//   Each row's max, sum and delta go to shared memory. With one key tile
//   (Lk <= 64) S and dP stay in registers; with more, three passes over the
//   64-key tiles: the max and sum, then delta, then dS and dq.
// - Sweep 2, a warp per 16 keys of a 64-key tile: Sᵀ = K Qᵀ and dPᵀ = V Gᵀ
//   by mma with the keys as rows, Pᵀ from the rows' saved max and sum (the
//   same p as sweep 1's up to the mma's summation order), dSᵀ from the
//   saved delta; then dv = Pᵀ G and dk = dSᵀ Q * scale with Pᵀ and dSᵀ as A
//   fragments straight from the accumulators (hi and lo) and G's and Q's B
//   fragments by ldmatrix.trans, summed over the query tiles in registers;
//   db_part's column sums are a quad sum of the same dSᵀ rows, so no sum
//   crosses warps. With one query tile (Lq <= 64) sweep 2 finds Q and G
//   still staged, with one key tile K and V: at the serving shape each
//   operand is read from device memory once.
// Rows and keys past Lq and Lk are zero-filled in the tiles; their scores
// are -inf (keys) or their P and dS are 0 (sweep 2), and they are never
// stored. Padded keys that exist keep their -10000 bias.
//
// With kDropout it computes _dropout_bwd_math (:147-166), the recipe of
// _attn_dropout_bwd_kernel_nat_bh (:530, row 4) and _attn_dropout_bwd_kernel
// (:169, row 6): the keep factor (1 / (1 - rate) or 0) multiplies dP and
// P's share of dv in float32, each product rounded to float32 before it is
// used (never fused into the next subtraction), and not the P inside dS;
// P·keep and dS enter the products as hi + lo halves like P. Each
// probability's keep bit is drawn once, in sweep 1 (row 4 replays
// hash_dropout's hash, row 6 reads the byte its forward wrote), and kept
// in shared memory as a bit a (query, key) for pass 3 and sweep 2 (the
// words of tc_put_keep, Lq·Lk / 8 bytes, both lengths rounded up to a
// tile: 512 bytes at L = 60), so no probability is hashed twice and sweep
// 2 reads no mask byte Lk apart. One body and one set of bits: row 6
// equals row 4 to the bit on the same operands.

#pragma once

#include "attention_fwd_tc.cuh"

namespace {

static_assert(kTcRows == kTcKeys, "a query tile and a key tile are alike");

// Shared memory of one tensor-core backward block (mirrored in
// ops/attention_cuda.py, tc_bwd_smem_bytes and tc_dropout_bwd_smem_bytes):
// Q, G, K and V tiles of 64 rows of D + kTcPad bf16, a key tile's float32
// bias, and each query row's max, sum and delta in float32 (Lq rounded up
// to a tile); with kDropout also the keep bits, one a query row and key
// (both rounded up to a tile).
template <int D, bool kDropout>
size_t tc_bwd_smem_bytes(int Lq, int Lk) {
  const size_t lq_pad = static_cast<size_t>(Lq + kTcRows - 1) / kTcRows *
                        kTcRows;
  const size_t lk_pad = static_cast<size_t>(Lk + kTcKeys - 1) / kTcKeys *
                        kTcKeys;
  return 4 * static_cast<size_t>(kTcRows) * (D + kTcPad) * sizeof(bf16) +
         kTcKeys * sizeof(float) + 3 * lq_pad * sizeof(float) +
         (kDropout ? lq_pad * lk_pad / 8 : 0);
}

// x as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi), each packed.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);  // x - hi is exact in float32
}

// o += X T for X, 16 rows by kTcKeys in tc_abt's accumulator layout, taken
// as its hi + lo bf16 halves, and T the kTcKeys x D tile (shared,
// row-major), whose B fragments come from ldmatrix.trans.
template <int D>
__device__ __forceinline__ void tc_split_xt(const float (&x)[kTcKeys / 8][4],
                                            const bf16* tile, int lane,
                                            float (&o)[D / 8][4]) {
  constexpr int kLd = D + kTcPad;
#pragma unroll
  for (int kk = 0; kk < kTcKeys / 16; ++kk) {
    // the accumulator layout of columns 2 kk and 2 kk + 1 is the A layout
    // of k = 16 kk .. 16 kk + 15
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      // transposed matrices: rows 16 kk (+8 odd) x d 16 np (+8 upper two)
      uint32_t tf[4];
      ldmatrix_x4_trans(tf, tile + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * kLd +
                                np * 16 + (lane >> 4) * 8);
      const uint32_t b0[2] = {tf[0], tf[1]};
      const uint32_t b1[2] = {tf[2], tf[3]};
      mma_bf16(o[2 * np], hi, b0);
      mma_bf16(o[2 * np], lo, b0);
      mma_bf16(o[2 * np + 1], hi, b1);
      mma_bf16(o[2 * np + 1], lo, b1);
    }
  }
}

// o * f as bf16 into rows row0 + r (r < 16, row0 + r < n) of dst (row
// stride rs), straight from the accumulator layout, 4 bytes a store.
template <int D>
__device__ __forceinline__ void tc_store_rows(const float (&o)[D / 8][4],
                                              float f, bf16* dst, size_t rs,
                                              int row0, int n, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n) continue;
    bf16* row = dst + static_cast<size_t>(r) * rs + 2 * t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<uint32_t*>(row + n8 * 8) =
          pack_bf16(o[n8][2 * half] * f, o[n8][2 * half + 1] * f);
  }
}

// The keep bits (kDropout). Sweep 1 draws each probability's keep bit once
// (bwd_keep: row 4 replays the hash, row 6 reads the forward's mask byte)
// and leaves it in shared memory as words [key tile][2][lq_pad]: bit c of
// word (jt, w, i) is the bit of query i and key 64 jt + 32 w + c. Pass 3 of
// sweep 1 (Lk > 64) and sweep 2 read them back: no probability is hashed,
// or its mask byte read, twice, and sweep 2 reads no byte Lk apart.
//
// In registers a thread keeps the bits of its accumulator elements [n][x]
// (rows i_row[x / 2], keys j0 + 8 n + 2 t + x % 2) as kw[4]: bit
// 8 (n % 4) + x % 2 of kw[2 (x / 2) + n / 4], the word layout above
// shifted down by 2 t.
__device__ __forceinline__ uint32_t tc_keep_bit(const uint32_t (&kw)[4],
                                                int n, int x) {
  return (kw[(x >> 1) * 2 + (n >> 2)] >> ((n & 3) * 8 + (x & 1))) & 1u;
}

// kw for key tile j0 of the warp's rows i_row, 0 outside the lengths (the
// head-major mask is not read there).
template <bool kHeadMajor, int D>
__device__ __forceinline__ void tc_draw_keep(
    uint32_t (&kw)[4], const Dropout& drop, const uint8_t* __restrict__ mask,
    const HeadLayout<kHeadMajor, D>& lay, int b, int h,
    const int (&i_row)[2], int j0, int Lq, int Lk, int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c) kw[c] = 0u;
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = i_row[x >> 1];
      const int j = j0 + n * 8 + 2 * t + (x & 1);
      if (i < Lq && j < Lk && bwd_keep(drop, mask, lay, b, h, i, j, Lq, Lk))
        kw[(x >> 1) * 2 + (n >> 2)] |= 1u << ((n & 3) * 8 + (x & 1));
    }
}

// kw of the quad into the words of key tile jt: the quad's four threads
// hold disjoint bits of the same two rows; each stores one of the four
// words. Every lane of the warp calls it.
__device__ __forceinline__ void tc_put_keep(const uint32_t (&kw)[4],
                                            uint32_t* words, int lq_pad,
                                            int jt, const int (&i_row)[2],
                                            int t) {
  uint32_t w[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    w[c] = kw[c] << (2 * t);
    w[c] |= __shfl_xor_sync(0xffffffffu, w[c], 1);
    w[c] |= __shfl_xor_sync(0xffffffffu, w[c], 2);
  }
  const uint32_t mine = t == 0 ? w[0] : t == 1 ? w[1] : t == 2 ? w[2] : w[3];
  words[(jt * 2 + (t & 1)) * lq_pad + i_row[t >> 1]] = mine;
}

// kw of key tile jt back from the words.
__device__ __forceinline__ void tc_get_keep(uint32_t (&kw)[4],
                                            const uint32_t* words,
                                            int lq_pad, int jt,
                                            const int (&i_row)[2], int t) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    kw[c] = (words[(jt * 2 + (c & 1)) * lq_pad + i_row[c >> 1]] >> (2 * t)) &
            0x03030303u;
}

// Sweep 1 on one key tile of the warp's rows: e (the exp(s - m) of
// tc_row_stats) becomes p = e / l; with kDropout dp (G Vᵀ) takes its keep
// factor, scale where kw holds the bit, else 0, rounded to float32.
template <bool kDropout>
__device__ __forceinline__ void tc_probs(float (&e)[kTcKeys / 8][4],
                                         float (&dp)[kTcKeys / 8][4],
                                         const float (&l)[2],
                                         const uint32_t (&kw)[4],
                                         float scale) {
  const float r[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      e[n][x] = div_rn(e[n][x], l[x >> 1], r[x >> 1]);
      if constexpr (kDropout)  // rounded, as sweep 2's, never fused
        dp[n][x] = __fmul_rn(dp[n][x], tc_keep_bit(kw, n, x) ? scale : 0.f);
    }
}

// delta += rowsum(dp * p) of the thread's share of rows g and g + 8.
__device__ __forceinline__ void tc_delta(const float (&p)[kTcKeys / 8][4],
                                         const float (&dp)[kTcKeys / 8][4],
                                         float (&delta)[2]) {
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      delta[x >> 1] = fmaf(dp[n][x], p[n][x], delta[x >> 1]);
}

// dp becomes dS = p * (dp - delta).
__device__ __forceinline__ void tc_ds(const float (&p)[kTcKeys / 8][4],
                                      float (&dp)[kTcKeys / 8][4],
                                      const float (&delta)[2]) {
#pragma unroll
  for (int n = 0; n < kTcKeys / 8; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      dp[n][x] = p[n][x] * (dp[n][x] - delta[x >> 1]);
}

// The block: grid B * H, kTcWarps * 32 threads, tc_bwd_smem_bytes<D,
// kDropout>(Lq, Lk) of dynamic shared memory. db_part may be null; with
// kDropout drop (row 4) or mask_in (row 6) gives the keep bits.
template <int D, bool kHeadMajor, bool kDropout>
__device__ __forceinline__ void attention_bwd_tc_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    const bf16* __restrict__ g, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ db_part, int Lq, int Lk, int H,
    float scale, Dropout drop, const uint8_t* __restrict__ mask_in) {
  constexpr int kLd = D + kTcPad;
  constexpr int kN = kTcKeys / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcRows][kLd]
  bf16* gs = qs + kTcRows * kLd;                // [kTcRows][kLd]
  bf16* ks = gs + kTcRows * kLd;                // [kTcKeys][kLd]
  bf16* vs = ks + kTcKeys * kLd;                // [kTcKeys][kLd]
  float* bs = reinterpret_cast<float*>(vs + kTcKeys * kLd);  // [kTcKeys]
  const int lq_pad = (Lq + kTcRows - 1) / kTcRows * kTcRows;
  float* row_m = bs + kTcKeys;  // [lq_pad] each: the rows' max, sum, delta
  float* row_l = row_m + lq_pad;
  float* row_d = row_l + lq_pad;
  // [ktiles][2][lq_pad] with kDropout: the keep bits (tc_put_keep)
  uint32_t* keep_words = reinterpret_cast<uint32_t*>(row_d + lq_pad);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const HeadLayout<kHeadMajor, D> lay{static_cast<int>(gridDim.x) / H, H};
  const size_t rs = lay.stride();
  const size_t qoff = lay.rows(b, h, Lq);
  const size_t koff = lay.rows(b, h, Lk);
  const bf16* qb = q + qoff;
  const bf16* gb = g + qoff;
  const bf16* kb = k + koff;
  const bf16* vb = v + koff;
  const float* bb = bias + static_cast<size_t>(b) * Lk;
  const int r0 = warp * 16;  // the warp's rows (sweep 1) or keys (sweep 2)
  const int ktiles = (Lk + kTcKeys - 1) / kTcKeys;
  const int qtiles = lq_pad / kTcRows;

  // K and V tile j0 and its bias into shared memory (the caller waits)
  auto stage_kv = [&](int j0) {
    const int nk = min(kTcKeys, Lk - j0);
    tc_stage<D>(kb + static_cast<size_t>(j0) * rs, rs, nk, kTcKeys, ks, tid);
    tc_stage<D>(vb + static_cast<size_t>(j0) * rs, rs, nk, kTcKeys, vs, tid);
    tc_stage_bias(bb, j0, Lk, bs, tid);
  };
  auto stage_qg = [&](int i0) {
    const int nq = min(kTcRows, Lq - i0);
    tc_stage<D>(qb + static_cast<size_t>(i0) * rs, rs, nq, kTcRows, qs, tid);
    tc_stage<D>(gb + static_cast<size_t>(i0) * rs, rs, nq, kTcRows, gs, tid);
  };

  // ---- sweep 1: per query tile, P, delta, dS and dq; the rows' statistics
  for (int i0 = 0; i0 < Lq; i0 += kTcRows) {
    if (i0 > 0) __syncthreads();  // every warp is done with the tiles
    stage_qg(i0);
    if (ktiles == 1 && i0 == 0) stage_kv(0);
    cp_async_wait_all();
    __syncthreads();
    const bool active = i0 + r0 < Lq;
    const int i_row[2] = {i0 + r0 + gq, i0 + r0 + gq + 8};
    uint32_t qf[D / 16][4], gf[D / 16][4];
    if (active) {
      tc_rows_a<D>(qs, r0, lane, qf);
      tc_rows_a<D>(gs, r0, lane, gf);
    }
    float s[kN][4], dp[kN][4], o[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float delta[2] = {0.f, 0.f};
    if (ktiles == 1) {
      if (active) {
        tc_scores<D>(qf, ks, bs, Lk, scale, lane, s);
        tc_row_stats(s, m, l, true);
        tc_abt<D>(gf, vs, lane, dp);
        uint32_t kw[4] = {0u, 0u, 0u, 0u};
        if constexpr (kDropout) {
          tc_draw_keep(kw, drop, mask_in, lay, b, h, i_row, 0, Lq, Lk, t4);
          tc_put_keep(kw, keep_words, lq_pad, 0, i_row, t4);
        }
        tc_probs<kDropout>(s, dp, l, kw, drop.scale);
        tc_delta(s, dp, delta);
        delta[0] = quad_sum(delta[0]);
        delta[1] = quad_sum(delta[1]);
        tc_ds(s, dp, delta);
        tc_split_xt<D>(dp, ks, lane, o);
      }
    } else {
      // pass 1: the rows' max and sum over every key tile
      for (int j0 = 0; j0 < Lk; j0 += kTcKeys) {
        __syncthreads();  // every warp is done with the previous K tile
        tc_stage<D>(kb + static_cast<size_t>(j0) * rs, rs,
                    min(kTcKeys, Lk - j0), kTcKeys, ks, tid);
        tc_stage_bias(bb, j0, Lk, bs, tid);
        cp_async_wait_all();
        __syncthreads();
        if (!active) continue;
        tc_scores<D>(qf, ks, bs, Lk - j0, scale, lane, s);
        tc_row_stats(s, m, l, j0 == 0);
      }
      // pass 2: delta; pass 3: dS and dq, a K and V tile at a time
      for (int pass = 2; pass <= 3; ++pass) {
        for (int j0 = 0; j0 < Lk; j0 += kTcKeys) {
          __syncthreads();
          stage_kv(j0);
          cp_async_wait_all();
          __syncthreads();
          if (!active) continue;
          tc_scores<D>(qf, ks, bs, Lk - j0, scale, lane, s);
#pragma unroll
          for (int n = 0; n < kN; ++n)
#pragma unroll
            for (int x = 0; x < 4; ++x) s[n][x] = expf(s[n][x] - m[x >> 1]);
          tc_abt<D>(gf, vs, lane, dp);
          // pass 2 draws the tile's keep bits, pass 3 reads them back
          uint32_t kw[4] = {0u, 0u, 0u, 0u};
          if constexpr (kDropout) {
            if (pass == 2) {
              tc_draw_keep(kw, drop, mask_in, lay, b, h, i_row, j0, Lq, Lk,
                           t4);
              tc_put_keep(kw, keep_words, lq_pad, j0 / kTcKeys, i_row, t4);
            } else {
              tc_get_keep(kw, keep_words, lq_pad, j0 / kTcKeys, i_row, t4);
            }
          }
          tc_probs<kDropout>(s, dp, l, kw, drop.scale);
          if (pass == 2) {
            tc_delta(s, dp, delta);
          } else {
            tc_ds(s, dp, delta);
            tc_split_xt<D>(dp, ks, lane, o);
          }
        }
        if (pass == 2) {
          delta[0] = quad_sum(delta[0]);
          delta[1] = quad_sum(delta[1]);
        }
      }
    }
    if (active) {
      tc_store_rows<D>(o, scale, dq + qoff, rs, i0 + r0, Lq, lane);
      if (t4 == 0) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          row_m[i_row[half]] = m[half];
          row_l[i_row[half]] = l[half];
          row_d[i_row[half]] = delta[half];
        }
      }
    }
  }

  // ---- sweep 2: per key tile, Pᵀ and dSᵀ again, dv, dk and db_part
  for (int j0 = 0; j0 < Lk; j0 += kTcKeys) {
    __syncthreads();  // sweep 1's statistics are written, the tiles used
    if (ktiles > 1) stage_kv(j0);  // else K and V are sweep 1's tile
    cp_async_wait_all();
    __syncthreads();
    const bool active = j0 + r0 < Lk;
    const int j_row[2] = {j0 + r0 + gq, j0 + r0 + gq + 8};
    const float bj[2] = {bs[r0 + gq], bs[r0 + gq + 8]};
    // the words of the warp's 16 keys (all in one half of the tile) and
    // the place of key j_row[0]'s bit in them
    const uint32_t* kwords =
        keep_words + ((j0 / kTcKeys) * 2 + (r0 >> 5)) * lq_pad;
    const int kbit = (r0 & 31) + gq;
    float ak[D / 8][4], av[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) ak[n][x] = av[n][x] = 0.f;
    float db[2] = {0.f, 0.f};
    for (int i0 = 0; i0 < Lq; i0 += kTcRows) {
      if (qtiles > 1) {  // else Q and G are sweep 1's tile
        __syncthreads();
        stage_qg(i0);
        cp_async_wait_all();
        __syncthreads();
      }
      if (!active) continue;
      float st[kN][4], dpt[kN][4];  // rows: keys; columns: queries
      {
        uint32_t af[D / 16][4];
        tc_rows_a<D>(ks, r0, lane, af);
        tc_abt<D>(af, qs, lane, st);
        tc_rows_a<D>(vs, r0, lane, af);
        tc_abt<D>(af, gs, lane, dpt);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int c = i0 + n * 8 + 2 * t4;  // the query of columns x = 0, 2
        const float2 mc = *reinterpret_cast<const float2*>(row_m + c);
        const float2 lc = *reinterpret_cast<const float2*>(row_l + c);
        const float2 dc = *reinterpret_cast<const float2*>(row_d + c);
        uint2 kc = {0u, 0u};  // the keep words of queries c and c + 1
        if constexpr (kDropout)
          kc = *reinterpret_cast<const uint2*>(kwords + c);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = c + (x & 1);
          const int j = j_row[x >> 1];
          const float mi = (x & 1) ? mc.y : mc.x;
          const float li = (x & 1) ? lc.y : lc.x;
          const float di = (x & 1) ? dc.y : dc.x;
          const bool valid = i < Lq && j < Lk;
          const float e = expf(st[n][x] * scale + bj[x >> 1] - mi);
          const float p = div_rn(e, li, __frcp_rn(li));
          float dpv = dpt[n][x], pv = p;
          if constexpr (kDropout) {
            const uint32_t w = (x & 1) ? kc.y : kc.x;
            const float f = (w >> (kbit + 8 * (x >> 1))) & 1u ? drop.scale
                                                              : 0.f;
            // rounded before the subtraction below, as in sweep 1 and the
            // recipe: a contraction into an FMA would give another dS
            dpv = __fmul_rn(dpv, f);
            pv = __fmul_rn(pv, f);
          }
          const float ds = valid ? p * (dpv - di) : 0.f;
          st[n][x] = valid ? pv : 0.f;
          dpt[n][x] = ds;
          db[x >> 1] += ds;
        }
      }
      tc_split_xt<D>(st, gs, lane, av);
      tc_split_xt<D>(dpt, qs, lane, ak);
    }
    if (!active) continue;
    tc_store_rows<D>(ak, scale, dk + koff, rs, j0 + r0, Lk, lane);
    tc_store_rows<D>(av, 1.f, dv + koff, rs, j0 + r0, Lk, lane);
    if (db_part != nullptr) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float sum = quad_sum(db[half]);
        if (t4 == 0 && j_row[half] < Lk)
          db_part[lay.pair(b, h) * Lk + j_row[half]] = sum;
      }
    }
  }
}

// Blocks an SM that a kernel running attention_bwd_body asks the compiler
// to fit (its __launch_bounds__): 3 for the tensor-core body at D <= 64,
// which holds it to 168 registers a thread with up to 280 bytes of spills
// without dropout and up to 340 with it (chip_smoke.py's ptxas report)
// where the compiler alone fits fewer blocks; the compiler's choice
// elsewhere.
// The dropout flavour at 2 blocks (255 registers, no spills) ran rows 4
// and 6 slower at the serving shape on the H100.
template <typename T, int D>
constexpr int kBwdMinBlocks = kTensorCore<T> && D <= 64 ? 3 : 1;

// Threads of a block of attention_bwd_body.
template <typename T>
constexpr int kBwdThreads = kTensorCore<T> ? kTcWarps * 32 : kBwdWarps * 32;

// The backward of rows 2 (natural) and 8 (head-major) and, with kDropout,
// of rows 4 (natural, drop replays the hash) and 6 (head-major, mask is
// the forward's): the tensor-core body for bf16, the CUDA-core body for
// float32.
template <typename T, int D, bool kHeadMajor, bool kDropout>
__device__ __forceinline__ void attention_bwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ g,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
    float* __restrict__ db_part, int Lq, int Lk, int H, float scale,
    Dropout drop, const uint8_t* __restrict__ mask) {
  if constexpr (kTensorCore<T>)
    attention_bwd_tc_block<D, kHeadMajor, kDropout>(
        q, k, v, bias, g, dq, dk, dv, db_part, Lq, Lk, H, scale, drop, mask);
  else
    attention_bwd_block<T, D, kDropout, kHeadMajor>(
        q, k, v, bias, g, dq, dk, dv, db_part, Lq, Lk, H, scale, drop, mask);
}

// Launch kern, a kernel that runs attention_bwd_body<T, D, ..., kDropout>,
// over B * H blocks with the body's threads and shared memory; tail (the
// dropout kernels' Dropout and mask) follows the common arguments.
template <typename T, int D, bool kDropout, typename Kernel,
          typename... Tail>
cudaError_t launch_bwd_body(Kernel kern, const void* q, const void* k,
                            const void* v, const void* bias, const void* g,
                            void* dq, void* dk, void* dv, void* db_part,
                            int B, int Lq, int Lk, int H, float scale,
                            cudaStream_t stream, Tail... tail) {
  const size_t smem = kTensorCore<T> ? tc_bwd_smem_bytes<D, kDropout>(Lq, Lk)
                                     : bwd_smem_bytes(Lq, Lk, D);
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<static_cast<unsigned>(B) * H, kBwdThreads<T>, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(db_part), Lq, Lk, H, scale,
      tail...);
  return cudaGetLastError();
}

}  // namespace
