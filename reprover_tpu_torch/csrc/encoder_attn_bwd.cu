// T5 attention backward for Hopper (sm_90a): the gradients of the four
// attentions of encoder_attn.cu, selected by the same compile-time mode,
// route and head width (encoder_attn_common.cuh).
//
// Replaces the Pallas TPU kernels of the custom VJPs in
// reprover_tpu/ops/flash_attention.py:
//
//   dQ kernel   <- _bwd_dq_kernel (:607): ENCODER, and CAUSAL_SELF and
//                  SCALED_CAUSAL (its causal=True call at :1343);
//                  _cross_bwd_dq_kernel (:1721): CROSS. dQ, and for the two
//                  T5 self-attentions the relative-bias gradient. On the
//                  LONG route _bwd_dq_kernel_blockwise (:934), all modes.
//   dK/dV kernel <- _bwd_dkv_kernel (:715): ENCODER, and CAUSAL_SELF and
//                  SCALED_CAUSAL (:1384); _cross_bwd_dkv_kernel (:1757):
//                  CROSS. On the LONG route _bwd_dkv_kernel_blockwise
//                  (:1034), all modes.
//
// Both take the per-row log-sum-exp LSE [B, H, Lq] (written by
// encoder_attn.cu: by the FULL_ROW forward, or on the LONG route by the
// LONG_LSE sweep; the Pallas dQ kernels recompute it) and delta =
// rowsum(dO * O) [B, H, Lq] (plain torch), and rebuild each probability
// exactly as P = exp(S - LSE) with S = q k^T (+ rel_bias[bucket(k - q), h])
// over valid keys; masked keys, keys k > q in the causal modes and query rows
// past Lq give P = 0, and a row with no valid key (LSE = +inf) gives zero
// gradients. Then dP = dO v^T, dS = P * (dP - delta), and
//
//   dQ = dS K,   dK = dS^T Q,   dV = P^T dO,
//   d_rel[bucket, h] = sum of dS over the (q, k) whose k - q falls in it.
//
// What bounds it on the H100: about 5x the forward's 2*Lq*Lk*d products per
// (b, h) (S and dP recomputed in each kernel, then dQ, dK, dV) against
// O((Lq + Lk)*d) elements moved, so it is compute-bound; the plain version's
// cost is the several [B, H, Lq, Lk] fp32 tensors its autograd saves and
// reads back. Nothing of size Lq*Lk leaves the SM, and causal blocks skip
// the tiles that lie wholly above the diagonal. The bf16 body reaches about
// 40-45% of the tensor peak at D = 128 (PERF.md); two warpgroups sharing
// the streamed tiles, A operands kept in registers, a third stage and n128
// products for the register-A products each measured no faster, and the
// epilogue costs 6-17% of the time (its ablation).
//
// - dK/dV: one block per (64-key tile, head, batch row) loops over 64-query
//   tiles (causal modes: from its own diagonal tile on, the grid's first
//   key tiles, which see the most queries, first), recomputes S^T, P^T and
//   dS^T for the tile, and accumulates dV and dK in registers; each output
//   tile is written once, with no atomics. A key tile with no valid key
//   writes zeros and skips the loop.
// - dQ: one block per (64-query tile, head, batch row) loops over key tiles
//   (causal modes: up to its diagonal tile, the longest query tiles first)
//   and accumulates dQ the same way. The TPU kernel summed d_rel in SMEM
//   across its sequential grid; Hopper's blocks run in no order, so here
//   each block bins dS by clamp(k - q, -max_distance, max_distance) (the
//   index of the forward's bucket table) into 2*max_distance+1 shared fp32
//   bins, keeps the two saturated bins in registers, and atomically adds its
//   bins into a global [H, 2*max_distance+1] buffer. The caller folds the
//   bins into the buckets with the bucket table. A far tile pair
//   (encoder_attn_common.cuh; on the LONG route, and in the bf16 body on
//   both) takes its bias from one scalar and adds its dS straight to the
//   saturated bin's register, with no per-pair position test, as the JAX
//   kernel sums a far block's dS into its one bucket. The atomics make
//   d_rel's summation order, and so its last bits, vary from run to run;
//   dQ, dK and dV are deterministic. CROSS and SCALED_CAUSAL have no bias
//   and no bins.
//
// Two bodies, by input type, under one kernel name each:
//
//   bf16 (every main path): Hopper's tensor cores, the design of the
//   forward's bf16 body (encoder_attn.cu). One warpgroup (128 threads) per
//   block. The block's own tiles (Q and dO for dQ; K and V for dK/dV)
//   arrive once by TMA; the streamed pair (K and V, or Q and dO) comes
//   through a ring of two stages in shared memory, each stage completing on
//   its own mbarrier and refilled by one thread as soon as the warpgroup is
//   past it. Tiles are bf16 [64][64] boxes with the 128-byte swizzle (two
//   per tile at D = 128). Every product is wgmma m64n64k16 with fp32
//   accumulators:
//
//     dQ:    S = Q K^T and dP = dO V^T (A and B K-major from shared memory),
//            then dQ += dS K with dS (bf16) as A from registers and K read
//            MN-major from the same stage (as the forward's P V reads V);
//     dK/dV: S^T = K Q^T and dP^T = V dO^T computed directly (A and B
//            K-major), so P^T and dS^T land in registers already in A's
//            layout: dV += P^T dO and dK += dS^T Q, with dO and Q read
//            MN-major. No operand is transposed in memory.
//
//   The epilogue runs on the accumulator registers, out of place (a
//   product's accumulators that another instruction writes make the
//   assembler serialize every product): key mask, causal cut on the
//   diagonal tile only, the bias (a near pair's table entries, a far
//   pair's one scalar), P = exp2(log2(e) (S + bias) - log2(e) LSE) on the
//   special-function unit, dS = P (dP - delta) in fp32; d_rel is binned
//   from the fp32 dS, and P and dS are rounded to bf16 only as operands (the
//   Pallas kernels' .astype before their products). The dK/dV kernel reads
//   LSE and delta per column (query) from shared memory, staged a tile
//   ahead. A dQ tile whose 64 keys are all masked (right padding) skips its
//   products. At D = 128 the dK/dV warpgroup holds dK and dV (64 + 64
//   fp32 a thread) beside S^T and dP^T (32 + 32), and packs P^T and dS^T
//   pair by pair as it makes them, so that a thread stays within its 255
//   registers.
//
//   fp32 (the card checks hold it to 1e-4; TF32 tensor cores keep about
//   three decimal digits): 256 threads, fp32 tiles in padded shared memory,
//   a thread a 4 x 4 patch of the score tile and 4 x D/16 outputs, plain FMA
//   loops. At D = 128 (SCALED_CAUSAL) a thread accumulates 4 x 8 dQ values,
//   or 4 x 8 dK and 4 x 8 dV values; the score patches stay 4 x 4.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller zeroes the bin buffer), build the bf16 body's tensor maps (the
// operands' bases must be 16-byte aligned) and return cudaGetLastError().

#include <math.h>

#include "encoder_attn_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace encoder_attn;

// Shared memory of the fp32 bodies.
size_t dq_shared_bytes(int nrel, int d) {
  return sizeof(float) * (size_t)(4 * BQ * pad_of(d) + BQ * PPAD + 2 * nrel + 2 * BQ) +
         sizeof(int) * BK;
}

size_t dkv_shared_bytes(int nrel, int d) {
  return sizeof(float) * (size_t)(4 * BK * pad_of(d) + 2 * BK * PPAD + nrel + 2 * BQ) +
         sizeof(int) * BK;
}

// Shared memory of the bf16 bodies, from a 1024-byte boundary (the slack
// below): the block's two tiles, then the ring of two stages of two tiles,
// D / 64 boxes a tile; then the mbarriers (the block's tiles', then each
// stage's). dQ adds the key-mask bits of three key tiles (two 32-bit words
// each), the bias table and the bins; dK/dV two slots of 64 (log2(e) LSE,
// delta) pairs and the bias table: about 50 KiB at D = 64 (registers then
// allow three blocks per SM for dQ, two or three for dK/dV), 99 KiB at
// D = 128 (two).
constexpr int STAGES = 2;
constexpr int WG_TILES = 2 + 2 * STAGES;
size_t dq_wg_shared_bytes(int nrel, int d) {
  return 1024 + WG_TILES * (d / 64) * hopper::BOX_BYTES + (1 + STAGES) * sizeof(uint64_t) +
         6 * sizeof(uint32_t) + 2 * sizeof(float) * nrel;
}
size_t dkv_wg_shared_bytes(int nrel, int d) {
  return 1024 + WG_TILES * (d / 64) * hopper::BOX_BYTES + (1 + STAGES) * sizeof(uint64_t) +
         sizeof(float) * (4 * BQ + nrel);
}

template <typename T>
__host__ __device__ constexpr int bwd_threads() {
  return on_tensor_cores<T>() ? WG_THREADS : THREADS;
}

// ----------------------------------------------------------------- fp32 body

template <typename T, int MODE, int ROUTE, int D>
__device__ __forceinline__ void dq_fma(
    float* smem,
    const T* __restrict__ q,               // [B, Lq, H*D]
    const T* __restrict__ k,               // [B, Lk, H*D]
    const T* __restrict__ v,               // [B, Lk, H*D]
    const T* __restrict__ dout,            // [B, Lq, H*D]
    const int* __restrict__ mask,          // [B, Lk], nonzero = valid key
    const float* __restrict__ rel_bias,    // [num_buckets, H] (only ENCODER, CAUSAL_SELF)
    const int* __restrict__ bucket_table,  // [2*max_distance+1]
    const float* __restrict__ lse,         // [B, H, Lq]
    const float* __restrict__ delta,       // [B, H, Lq]
    T* __restrict__ dq,                    // [B, Lq, H*D]
    float* __restrict__ dbins,             // [H, 2*max_distance+1], accumulated (bias modes)
    int Lq, int kv_len, int H, int max_distance) {
  constexpr int PAD = pad_of(D);
  constexpr int NC = D / 16;  // dQ columns per thread
  constexpr bool kBias = has_bias(MODE);
  constexpr bool kCausal = is_causal(MODE);
  constexpr bool kLong = ROUTE == LONG;
  // Self-attention has as many keys as queries: saying so lets the
  // compiler share the two lengths and base offsets (one register less).
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kBias ? 2 * max_distance + 1 : 0;
  float* qs = smem;                  // [BQ][PAD]
  float* dos = qs + BQ * PAD;        // [BQ][PAD]
  float* ks = dos + BQ * PAD;        // [BK][PAD]
  float* vs = ks + BK * PAD;         // [BK][PAD]
  float* dss = vs + BK * PAD;        // [BQ][PPAD]
  float* bias = dss + BQ * PPAD;     // [nrel]
  float* bins = bias + nrel;         // [nrel]
  float* row_lse = bins + nrel;      // [BQ]
  float* row_delta = row_lse + BQ;   // [BQ]
  int* key_ok = reinterpret_cast<int*>(row_delta + BQ);  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // query rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // key columns tx + 16*j (j < 4), dQ columns tx + 16*j (j < NC)
  const long row_stride = (long)H * D;
  const long q_base = (long)b * Lq * row_stride + (long)h * D;
  const long k_base = (long)b * Lk * row_stride + (long)h * D;
  const long stat_base = ((long)b * H + h) * Lq;

  if constexpr (kBias) {
    load_bias(bias, rel_bias, bucket_table, nrel, H, h, tid);
    for (int r = tid; r < nrel; r += THREADS) bins[r] = 0.f;
  }
  load_tile_pair<D>(qs, dos, q, dout, q_base, row_stride, q0, Lq, tid);
  if (tid < BQ) {
    const int qi = q0 + tid;
    row_lse[tid] = qi < Lq ? lse[stat_base + qi] : INFINITY;
    row_delta[tid] = qi < Lq ? delta[stat_base + qi] : 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  // dS of pairs with k - q >= max_distance / <= -max_distance: their bins
  // saturate, so they are summed here and added once at the end.
  float sat_hi = 0.f, sat_lo = 0.f;

  const int k_end = kCausal ? min(Lk, q0 + BQ) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_pair<D>(ks, vs, k, v, k_base, row_stride, k0, Lk, tid);
    if (tid < BK) {
      const int kj = k0 + tid;
      key_ok[tid] = kj < Lk && mask[(long)b * Lk + kj] != 0;
    }
    __syncthreads();
    int side = NEAR;
    float far_bias = 0.f;
    if constexpr (kLong && kBias) {
      side = tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
      far_bias = bias[side == RIGHT_FAR ? 2 * max_distance : 0];
    }

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * PAD + c];
        dov[i] = dos[(ty * 4 + i) * PAD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * PAD + c];
        vv[j] = vs[(tx + 16 * j) * PAD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const int rel = k0 + kc - qi;
        float ds = 0.f;
        if (key_ok[kc] && qi < Lq && (!kCausal || rel <= 0)) {
          float sc = s[i][j];
          if constexpr (kBias)
            sc += (kLong && side != NEAR) ? far_bias
                                          : bias[clamp_rel(rel, max_distance) + max_distance];
          const float p = expf(sc - row_lse[r]);
          ds = p * (dp[i][j] - row_delta[r]);
          if constexpr (kBias) {
            if (kLong && side == RIGHT_FAR)
              sat_hi += ds;
            else if (kLong && side == LEFT_FAR)
              sat_lo += ds;
            else if (rel >= max_distance)
              sat_hi += ds;
            else if (rel <= -max_distance)
              sat_lo += ds;
            else
              atomicAdd(&bins[rel + max_distance], ds);
          }
        }
        dss[r * PPAD + kc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * PPAD + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = ks[kk * PAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < Lq) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
        dq[q_base + (long)qi * row_stride + tx + 16 * j] = from_float<T>(acc[i][j]);
    }
  }

  if constexpr (kBias) {
    // Saturated bins: a warp sum, then one shared atomic per warp.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sat_hi += __shfl_xor_sync(0xffffffffu, sat_hi, off);
      sat_lo += __shfl_xor_sync(0xffffffffu, sat_lo, off);
    }
    if ((tid & 31) == 0) {
      atomicAdd(&bins[2 * max_distance], sat_hi);
      atomicAdd(&bins[0], sat_lo);
    }
    __syncthreads();
    for (int r = tid; r < nrel; r += THREADS)
      if (bins[r] != 0.f) atomicAdd(&dbins[(long)h * nrel + r], bins[r]);
  }
}

template <typename T, int MODE, int ROUTE, int D>
__device__ __forceinline__ void dkv_fma(
    float* smem,
    const T* __restrict__ q,               // [B, Lq, H*D]
    const T* __restrict__ k,               // [B, Lk, H*D]
    const T* __restrict__ v,               // [B, Lk, H*D]
    const T* __restrict__ dout,            // [B, Lq, H*D]
    const int* __restrict__ mask,          // [B, Lk], nonzero = valid key
    const float* __restrict__ rel_bias,    // [num_buckets, H] (only ENCODER, CAUSAL_SELF)
    const int* __restrict__ bucket_table,  // [2*max_distance+1]
    const float* __restrict__ lse,         // [B, H, Lq]
    const float* __restrict__ delta,       // [B, H, Lq]
    T* __restrict__ dk,                    // [B, Lk, H*D]
    T* __restrict__ dv,                    // [B, Lk, H*D]
    int Lq, int kv_len, int H, int max_distance) {
  constexpr int PAD = pad_of(D);
  constexpr int NC = D / 16;  // dK and dV columns per thread
  constexpr bool kBias = has_bias(MODE);
  constexpr bool kCausal = is_causal(MODE);
  constexpr bool kLong = ROUTE == LONG;
  // Self-attention has as many keys as queries: saying so lets the
  // compiler share the two lengths and base offsets (one register less).
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kBias ? 2 * max_distance + 1 : 0;
  float* ks = smem;                  // [BK][PAD]
  float* vs = ks + BK * PAD;         // [BK][PAD]
  float* qs = vs + BK * PAD;         // [BQ][PAD]
  float* dos = qs + BQ * PAD;        // [BQ][PAD]
  float* pts = dos + BQ * PAD;       // P^T  [BK][PPAD] (columns are queries)
  float* dsts = pts + BK * PPAD;     // dS^T [BK][PPAD]
  float* bias = dsts + BK * PPAD;    // [nrel]
  float* col_lse = bias + nrel;      // [BQ]
  float* col_delta = col_lse + BQ;   // [BQ]
  int* key_ok = reinterpret_cast<int*>(col_delta + BQ);  // [BK]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // key rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // query columns tx + 16*j (j < 4), dK/dV columns tx + 16*j (j < NC)
  const long row_stride = (long)H * D;
  const long q_base = (long)b * Lq * row_stride + (long)h * D;
  const long k_base = (long)b * Lk * row_stride + (long)h * D;
  const long stat_base = ((long)b * H + h) * Lq;

  if constexpr (kBias) load_bias(bias, rel_bias, bucket_table, nrel, H, h, tid);
  load_tile_pair<D>(ks, vs, k, v, k_base, row_stride, k0, Lk, tid);
  int ok = 0;
  if (tid < BK) {
    const int kj = k0 + tid;
    ok = kj < Lk && mask[(long)b * Lk + kj] != 0;
    key_ok[tid] = ok;
  }
  const bool any_key = __syncthreads_or(ok) != 0;

  float acc_dk[4][NC], acc_dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // In the causal modes no query before k0 sees a key of this tile (BQ == BK).
  const int q_start = kCausal ? k0 : 0;
  for (int q0 = q_start; any_key && q0 < Lq; q0 += BQ) {
    __syncthreads();  // the previous tile is no longer read
    load_tile_pair<D>(qs, dos, q, dout, q_base, row_stride, q0, Lq, tid);
    if (tid < BQ) {
      const int qi = q0 + tid;
      col_lse[tid] = qi < Lq ? lse[stat_base + qi] : INFINITY;
      col_delta[tid] = qi < Lq ? delta[stat_base + qi] : 0.f;
    }
    __syncthreads();
    int side = NEAR;
    float far_bias = 0.f;
    if constexpr (kLong && kBias) {
      side = tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
      far_bias = bias[side == RIGHT_FAR ? 2 * max_distance : 0];
    }

    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * PAD + c];
        vv[i] = vs[(ty * 4 + i) * PAD + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * PAD + c];
        dov[j] = dos[(tx + 16 * j) * PAD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qi = q0 + qc;
        float p = 0.f, ds = 0.f;
        if (key_ok[r] && qi < Lq && (!kCausal || kj <= qi)) {
          float sc = st[i][j];
          if constexpr (kBias)
            sc += (kLong && side != NEAR) ? far_bias
                                          : bias[clamp_rel(kj - qi, max_distance) + max_distance];
          p = expf(sc - col_lse[qc]);
          ds = p * (dpt[i][j] - col_delta[qc]);
        }
        pts[r * PPAD + qc] = p;
        dsts[r * PPAD + qc] = ds;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pts[(ty * 4 + i) * PPAD + qq];
        dsv[i] = dsts[(ty * 4 + i) * PPAD + qq];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        dov[j] = dos[qq * PAD + tx + 16 * j];
        qv[j] = qs[qq * PAD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          acc_dv[i][j] = fmaf(pv[i], dov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    if (kj < Lk) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const long off = k_base + (long)kj * row_stride + tx + 16 * j;
        dk[off] = from_float<T>(acc_dk[i][j]);
        dv[off] = from_float<T>(acc_dv[i][j]);
      }
    }
  }
}

// ----------------------------------------------------------------- bf16 body

// One box coordinate set per 64 columns of a [64][D] tile of head h, rows
// from `row`, batch row b: its D / 64 boxes into dst, completing on bar.
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row, int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_3d(dst + c * hopper::BOX_BYTES, map, bar, h * D + c * 64, row, b);
}

// The products of one tile pair that both kernels share: x = A0 B0^T and
// y = A1 B1^T over the head width, all four operands K-major [64][D] tiles
// (descriptors of their first box), k16 slices along D (after a
// wgmma_fence; the caller commits).
template <int D>
__device__ __forceinline__ void issue_pair(float (&x)[32], float (&y)[32], uint64_t a0,
                                           uint64_t b0, uint64_t a1, uint64_t b1) {
  using namespace hopper;
  wgmma_64x64x16_ss_first(x, a0, b0);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_64x64x16_ss(x, desc_advance(a0, off), desc_advance(b0, off));
  }
  wgmma_64x64x16_ss_first(y, a1, b1);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_64x64x16_ss(y, desc_advance(a1, off), desc_advance(b1, off));
  }
}

// acc[c] += A B for each 64-column box c of an MN-major [64][D] tile B
// (descriptor of its first box; one 128-byte row per k), A from registers.
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 64][32], const uint32_t (&a)[4][4],
                                         uint64_t b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      wgmma_64x64x16_rs_tb(acc[c], a[kk], desc_advance(b, c * BOX_BYTES + kk * 16 * ROW_BYTES));
}

template <int D>
__device__ __forceinline__ void fence_acc(float (&acc)[D / 64][32]) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) hopper::fence_operands(acc[c]);
}

// Rows r0 and r0 + 8 (below `len`) of an accumulator tile into a bf16
// [B, len, H*D] tensor at row `row0` of batch row b, head h.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[D / 64][32], int b, int len, int H,
                                           int h, int row0, int r0, int c0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= len) continue;
    __nv_bfloat16* p = dst + ((long)b * len + row) * H * D + (long)h * D + c0;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        *reinterpret_cast<__nv_bfloat162*>(p + c * 64 + 8 * jj) =
            __floats2bfloat162_rn(acc[c][4 * jj + 2 * i], acc[c][4 * jj + 2 * i + 1]);
  }
}

template <int MODE, int D>
__device__ __forceinline__ void dq_wgmma(unsigned char* smem_raw, const CUtensorMap* tmap_q,
                                         const CUtensorMap* tmap_k, const CUtensorMap* tmap_v,
                                         const CUtensorMap* tmap_do,
                                         const int* __restrict__ mask,
                                         const float* __restrict__ rel_bias,
                                         const int* __restrict__ bucket_table,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         __nv_bfloat16* __restrict__ dq,
                                         float* __restrict__ dbins, int Lq, int kv_len, int H,
                                         int max_distance) {
  using namespace hopper;
  static_assert(D % 64 == 0, "a tile is D / 64 boxes of 64 columns");
  constexpr int TILE_BYTES = (D / 64) * BOX_BYTES;
  constexpr bool kBias = has_bias(MODE);
  constexpr bool kCausal = is_causal(MODE);
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kBias ? 2 * max_distance + 1 : 0;

  unsigned char* qs = align_1024(smem_raw);
  unsigned char* dos = qs + TILE_BYTES;
  unsigned char* ring = dos + TILE_BYTES;  // stage s: K at 2 s tiles, V after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 2 * STAGES * TILE_BYTES);  // Q+dO, stages
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(bars + 1 + STAGES);  // [3][2]
  float* bias = reinterpret_cast<float*>(key_bits + 6);                 // [nrel]
  float* bins = bias + nrel;                                            // [nrel]

  // The causal grid's last query tiles see the most keys: run them first.
  const int q0 = (kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // and its columns c0 + 8 j + {0, 1}
  const int k_end = kCausal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const long mask_base = (long)b * Lk;
  const long stat_base = ((long)b * H + h) * Lq;

  // Key tile i's K goes to stage i % STAGES with its V, completing on that
  // stage's barrier in phase (i / STAGES) % 2.
  auto load_kv = [&](int i) {
    uint64_t* bar = &bars[1 + i % STAGES];
    unsigned char* dst = ring + (i % STAGES) * 2 * TILE_BYTES;
    mbar_expect_tx(bar, 2 * TILE_BYTES);
    tma_tile<D>(dst, tmap_k, bar, h, i * BK, b);
    tma_tile<D>(dst + TILE_BYTES, tmap_v, bar, h, i * BK, b);
  };
  // Warps 0 and 1: whether key tid of tile i is valid; the bits go to slot
  // i % 3, two tiles ahead of their use.
  auto key_ok = [&](int i) {
    const int kj = i * BK + tid;
    return i < n_tiles && kj < Lk && mask[mask_base + kj] != 0;
  };
  auto store_key_bits = [&](int i, bool ok) {
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) key_bits[2 * (i % 3) + warp] = bits;
  };

  if (tid == 0) {
    prefetch_map(tmap_q);
    prefetch_map(tmap_k);
    prefetch_map(tmap_v);
    prefetch_map(tmap_do);
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(&bars[s], 1);
    fence_mbar_init();
  }
  if constexpr (kBias) {
    load_bias(bias, rel_bias, bucket_table, nrel, H, h, tid, WG_THREADS);
    for (int r = tid; r < nrel; r += WG_THREADS) bins[r] = 0.f;
  }
  if (tid < BK) {
    store_key_bits(0, key_ok(0));
    store_key_bits(1, key_ok(1));
  }
  // This thread's rows: log2(e) LSE (+inf past Lq: P = 0) and delta.
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    lse2[i] = qi < Lq ? lse[stat_base + qi] * LOG2E : INFINITY;
    dlt[i] = qi < Lq ? delta[stat_base + qi] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * TILE_BYTES);
    tma_tile<D>(qs, tmap_q, &bars[0], h, q0, b);
    tma_tile<D>(dos, tmap_do, &bars[0], h, q0, b);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_kv(i);
  }

  float acc[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[c][r] = 0.f;
  fence_acc<D>(acc);  // zeroed here, not inside the first product's window
  float s[32], dp[32];  // S and dP of the current key tile
  uint32_t da[4][4];    // its dS, bf16 pairs
  // dS of pairs with k - q >= max_distance / <= -max_distance: their bins
  // saturate, so they are summed here and added once at the end.
  float sat_hi = 0.f, sat_lo = 0.f;

  const uint64_t d_q = desc_sw128(qs, 16, GROUP_BYTES);
  const uint64_t d_do = desc_sw128(dos, 16, GROUP_BYTES);
  const uint64_t d_ring = desc_sw128(ring, 16, GROUP_BYTES);               // K-major
  const uint64_t d_ring_mn = desc_sw128(ring, GROUP_BYTES, GROUP_BYTES);   // MN-major

  mbar_wait(&bars[0], 0);
  __syncwarp();
  for (int j = 0; j < n_tiles; ++j) {
    const bool next_ok = tid < BK && key_ok(j + 2);
    const int k0 = j * BK;
    const uint32_t k_off = (j % STAGES) * 2 * TILE_BYTES, v_off = k_off + TILE_BYTES;
    const uint32_t w0 = key_bits[2 * (j % 3)], w1 = key_bits[2 * (j % 3) + 1];
    // Read through lane 0 so the compiler sees a warp-uniform branch: a
    // wgmma on a path it thinks divergent is serialized (ptxas C7520).
    const bool any_key = __shfl_sync(0xffffffffu, (w0 | w1) != 0u, 0);
    mbar_wait(&bars[1 + j % STAGES], (j / STAGES) % 2);
    __syncwarp();
    if (any_key) {
      wgmma_fence();
      issue_pair<D>(s, dp, d_q, desc_advance(d_ring, k_off), d_do, desc_advance(d_ring, v_off));
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);
      fence_operands(dp);

      // The epilogue, out of place: x = S + bias, then dS.
      float x[32], ds[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) x[r] = s[r];
      int side = NEAR;
      float tile_bias = 0.f;
      if constexpr (kBias) {
        side = tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
        tile_bias = add_tile_bias<false>(x, bias, side, q0, k0, r0, c0, max_distance);
      }
      // Only the diagonal tile holds keys past a causal row.
      const bool diag = kCausal && k0 + BK > q0;
      if (diag || (w0 & w1) != 0xffffffffu) {
        // This thread's valid-key bits: bit 8 j + e for column c0 + 8 j + e.
        const uint64_t kb = ((uint64_t)w1 << 32 | w0) >> c0;
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          bool ok = (kb >> (8 * (r / 4) + r % 2)) & 1;
          if (diag) ok = ok && k0 + 8 * (r / 4) + c0 + r % 2 <= q0 + r0 + 8 * ((r / 2) % 2);
          x[r] = ok ? x[r] : -INFINITY;
        }
      }
      // P = 2^(log2(e) (x + tile_bias) - log2(e) LSE): 0 at a masked
      // score and on a row past Lq or with no valid key.
      const float shift[2] = {fmaf(tile_bias, LOG2E, -lse2[0]), fmaf(tile_bias, LOG2E, -lse2[1])};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float p = ex2(fmaf(x[r], LOG2E, shift[(r / 2) % 2]));
        ds[r] = p * (dp[r] - dlt[(r / 2) % 2]);
      }
      if constexpr (kBias) {
        // Bins from the fp32 dS. A far pair: every k - q in one saturated bin.
        if (side != NEAR) {
          float t = 0.f;
#pragma unroll
          for (int r = 0; r < 32; ++r) t += ds[r];
          if (side == RIGHT_FAR)
            sat_hi += t;
          else
            sat_lo += t;
        } else {
          // Register 4 m + e (row r0, columns 8 m + c0 + e) and register
          // 4 (m + 1) + 2 + e (row r0 + 8, columns 8 (m + 1) + c0 + e) share
          // k - q = base + 8 m + e: 18 bins a thread instead of 32.
          const int base = k0 + c0 - q0 - r0;
#pragma unroll
          for (int m = -1; m < 8; ++m)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = (m >= 0 ? ds[4 * m + e] : 0.f) + (m < 7 ? ds[4 * (m + 1) + 2 + e] : 0.f);
              const int rel = base + 8 * m + e;
              if (rel >= max_distance)
                sat_hi += v;
              else if (rel <= -max_distance)
                sat_lo += v;
              else
                atomicAdd(&bins[rel + max_distance], v);
            }
        }
      }
      pack_a(da, ds);

      // dQ += dS K: dS (bf16) is A from registers, 16 keys per slice; K is
      // B, MN-major from the same stage. The accumulators and dS are final
      // before the fence: a register defined inside a product's window
      // serializes every product.
      fence_acc<D>(acc);
      fence_operands(da);
      wgmma_fence();
      issue_rs<D>(acc, da, desc_advance(d_ring_mn, k_off));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<D>(acc);
    }
    if (tid < BK) store_key_bits(j + 2, next_ok);
    // Every thread is past tile j's products: its stage takes tile j + STAGES.
    __syncthreads();
    if (tid == 0 && j + STAGES < n_tiles) load_kv(j + STAGES);
  }

  store_tile<D>(dq, acc, b, Lq, H, h, q0, r0, c0);
  if constexpr (kBias) {
    // Saturated bins: a warp sum, then one shared atomic per warp.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sat_hi += __shfl_xor_sync(0xffffffffu, sat_hi, off);
      sat_lo += __shfl_xor_sync(0xffffffffu, sat_lo, off);
    }
    if (lane == 0) {
      atomicAdd(&bins[2 * max_distance], sat_hi);
      atomicAdd(&bins[0], sat_lo);
    }
    __syncthreads();
    for (int r = tid; r < nrel; r += WG_THREADS)
      if (bins[r] != 0.f) atomicAdd(&dbins[(long)h * nrel + r], bins[r]);
  }
}

template <int MODE, int D>
__device__ __forceinline__ void dkv_wgmma(unsigned char* smem_raw, const CUtensorMap* tmap_q,
                                          const CUtensorMap* tmap_k, const CUtensorMap* tmap_v,
                                          const CUtensorMap* tmap_do,
                                          const int* __restrict__ mask,
                                          const float* __restrict__ rel_bias,
                                          const int* __restrict__ bucket_table,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          __nv_bfloat16* __restrict__ dk,
                                          __nv_bfloat16* __restrict__ dv, int Lq, int kv_len,
                                          int H, int max_distance) {
  using namespace hopper;
  static_assert(D % 64 == 0, "a tile is D / 64 boxes of 64 columns");
  constexpr int TILE_BYTES = (D / 64) * BOX_BYTES;
  constexpr bool kBias = has_bias(MODE);
  constexpr bool kCausal = is_causal(MODE);
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kBias ? 2 * max_distance + 1 : 0;

  unsigned char* ks = align_1024(smem_raw);
  unsigned char* vs = ks + TILE_BYTES;
  unsigned char* ring = vs + TILE_BYTES;  // stage s: Q at 2 s tiles, dO after it
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + 2 * STAGES * TILE_BYTES);  // K+V, stages
  float* stats = reinterpret_cast<float*>(bars + 1 + STAGES);  // [2 slots][log2(e) LSE, delta][BQ]
  float* bias = stats + 4 * BQ;                                // [nrel]

  // In the causal modes the first key tiles see the most queries; the grid
  // runs them first.
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's keys k0 + r0 and k0 + r0 + 8
  const int c0 = 2 * (lane % 4);        // and its query columns c0 + 8 j + {0, 1}
  const long stat_base = ((long)b * H + h) * Lq;
  // In the causal modes no query before k0 sees a key of this tile (BQ == BK).
  const int q_start = kCausal ? k0 : 0;

  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = k0 + r0 + 8 * i;
    row_ok[i] = kj < Lk && mask[(long)b * Lk + kj] != 0;
  }
  // Query tile i's statistics (threads 0-63, one query each) into slot i % 2.
  auto load_stats = [&](int i, float& l2, float& dl) {
    const int qi = q_start + i * BQ + tid;
    l2 = qi < Lq ? lse[stat_base + qi] * LOG2E : INFINITY;
    dl = qi < Lq ? delta[stat_base + qi] : 0.f;
  };
  auto store_stats = [&](int i, float l2, float dl) {
    stats[(i % 2) * 2 * BQ + tid] = l2;
    stats[(i % 2) * 2 * BQ + BQ + tid] = dl;
  };
  if (tid == 0) {
    prefetch_map(tmap_q);
    prefetch_map(tmap_k);
    prefetch_map(tmap_v);
    prefetch_map(tmap_do);
#pragma unroll
    for (int s = 0; s <= STAGES; ++s) mbar_init(&bars[s], 1);
    fence_mbar_init();
  }
  if constexpr (kBias) load_bias(bias, rel_bias, bucket_table, nrel, H, h, tid, WG_THREADS);
  if (tid < BQ) {
    float l2, dl;
    load_stats(0, l2, dl);
    store_stats(0, l2, dl);
  }
  // Warp-uniform through lane 0, as dq_wgmma's any_key (ptxas C7520).
  const bool any_key =
      __shfl_sync(0xffffffffu, __syncthreads_or(row_ok[0] || row_ok[1]) != 0, 0);
  const int n_tiles = any_key && Lq > q_start ? (Lq - q_start + BQ - 1) / BQ : 0;

  // Query tile i's Q goes to stage i % STAGES with its dO.
  auto load_qdo = [&](int i) {
    uint64_t* bar = &bars[1 + i % STAGES];
    unsigned char* dst = ring + (i % STAGES) * 2 * TILE_BYTES;
    mbar_expect_tx(bar, 2 * TILE_BYTES);
    tma_tile<D>(dst, tmap_q, bar, h, q_start + i * BQ, b);
    tma_tile<D>(dst + TILE_BYTES, tmap_do, bar, h, q_start + i * BQ, b);
  };
  if (tid == 0 && n_tiles > 0) {
    mbar_expect_tx(&bars[0], 2 * TILE_BYTES);
    tma_tile<D>(ks, tmap_k, &bars[0], h, k0, b);
    tma_tile<D>(vs, tmap_v, &bars[0], h, k0, b);
    for (int i = 0; i < STAGES && i < n_tiles; ++i) load_qdo(i);
  }

  float acc_k[D / 64][32], acc_v[D / 64][32];
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc_k[c][r] = acc_v[c][r] = 0.f;
  fence_acc<D>(acc_k);
  fence_acc<D>(acc_v);
  float st[32], dpt[32];      // S^T and dP^T of the current query tile
  uint32_t pa[4][4], da[4][4];  // its P^T and dS^T, bf16 pairs

  const uint64_t d_k = desc_sw128(ks, 16, GROUP_BYTES);
  const uint64_t d_v = desc_sw128(vs, 16, GROUP_BYTES);
  const uint64_t d_ring = desc_sw128(ring, 16, GROUP_BYTES);              // K-major
  const uint64_t d_ring_mn = desc_sw128(ring, GROUP_BYTES, GROUP_BYTES);  // MN-major

  if (n_tiles > 0) {
    mbar_wait(&bars[0], 0);
    __syncwarp();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_start + j * BQ;
    float next_l2 = 0.f, next_dl = 0.f;
    if (tid < BQ) load_stats(j + 1, next_l2, next_dl);
    const uint32_t q_off = (j % STAGES) * 2 * TILE_BYTES, do_off = q_off + TILE_BYTES;
    mbar_wait(&bars[1 + j % STAGES], (j / STAGES) % 2);
    __syncwarp();
    wgmma_fence();
    issue_pair<D>(st, dpt, d_k, desc_advance(d_ring, q_off), d_v, desc_advance(d_ring, do_off));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // The epilogue, out of place: rows are keys, columns queries.
    float x[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] = st[r];
    float tile_bias = 0.f;
    if constexpr (kBias) {
      const int side =
          tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
      tile_bias = add_tile_bias<true>(x, bias, side, q0, k0, r0, c0, max_distance);
    }
    // Only the diagonal tile (the first) holds queries before a causal key.
    const bool diag = kCausal && j == 0;
    if (diag || !row_ok[0] || !row_ok[1]) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        bool ok = row_ok[(r / 2) % 2];
        if (diag) ok = ok && r0 + 8 * ((r / 2) % 2) <= 8 * (r / 4) + c0 + r % 2;
        x[r] = ok ? x[r] : -INFINITY;
      }
    }
    const float* col_l2 = stats + (j % 2) * 2 * BQ;
    const float* col_dl = col_l2 + BQ;
    const float tb2 = tile_bias * LOG2E;
    // P^T and dS^T, each pair rounded to bf16 as soon as it is made.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * kk + 2 * t + e;
          const int col = 8 * (r / 4) + c0 + r % 2;
          p[e] = ex2(fmaf(x[r], LOG2E, tb2 - col_l2[col]));
          ds[e] = p[e] * (dpt[r] - col_dl[col]);
        }
        pa[kk][t] = pack_bf16(p[0], p[1]);
        da[kk][t] = pack_bf16(ds[0], ds[1]);
      }

    // dV += P^T dO and dK += dS^T Q: A from registers, 16 queries per
    // slice; dO and Q are B, MN-major from the stage.
    fence_acc<D>(acc_k);
    fence_acc<D>(acc_v);
    fence_operands(pa);
    fence_operands(da);
    wgmma_fence();
    issue_rs<D>(acc_v, pa, desc_advance(d_ring_mn, do_off));
    issue_rs<D>(acc_k, da, desc_advance(d_ring_mn, q_off));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<D>(acc_k);
    fence_acc<D>(acc_v);
    if (tid < BQ) store_stats(j + 1, next_l2, next_dl);
    // Every thread is past tile j's products: its stage takes tile j + STAGES.
    __syncthreads();
    if (tid == 0 && j + STAGES < n_tiles) load_qdo(j + STAGES);
  }

  store_tile<D>(dk, acc_k, b, Lk, H, h, k0, r0, c0);
  store_tile<D>(dv, acc_v, b, Lk, H, h, k0, r0, c0);
}

// One kernel name for each of the two backward kernels, both bodies (so
// profiled names parse alike across versions): bf16 runs the tensor-core
// body on one warpgroup, fp32 the FMA body on 256 threads; the tensor maps
// are the bf16 body's (unread by fp32), the pointers q, k, v, dout the fp32
// body's.
template <typename T, int MODE, int ROUTE, int D>
__global__ void __launch_bounds__(bwd_threads<T>()) attn_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tmap_q,   // bf16 q    [B, Lq, H*D]
    const __grid_constant__ CUtensorMap tmap_k,   // bf16 k    [B, Lk, H*D]
    const __grid_constant__ CUtensorMap tmap_v,   // bf16 v    [B, Lk, H*D]
    const __grid_constant__ CUtensorMap tmap_do,  // bf16 dout [B, Lq, H*D]
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ rel_bias,
    const int* __restrict__ bucket_table, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, float* __restrict__ dbins, int Lq,
    int kv_len, int H, int max_distance) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if constexpr (on_tensor_cores<T>())
    dq_wgmma<MODE, D>(bwd_smem, &tmap_q, &tmap_k, &tmap_v, &tmap_do, mask, rel_bias,
                      bucket_table, lse, delta, dq, dbins, Lq, kv_len, H, max_distance);
  else
    dq_fma<T, MODE, ROUTE, D>(reinterpret_cast<float*>(bwd_smem), q, k, v, dout, mask,
                              rel_bias, bucket_table, lse, delta, dq, dbins, Lq, kv_len, H,
                              max_distance);
}

template <typename T, int MODE, int ROUTE, int D>
__global__ void __launch_bounds__(bwd_threads<T>()) attn_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tmap_q, const __grid_constant__ CUtensorMap tmap_k,
    const __grid_constant__ CUtensorMap tmap_v, const __grid_constant__ CUtensorMap tmap_do,
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const int* __restrict__ mask, const float* __restrict__ rel_bias,
    const int* __restrict__ bucket_table, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Lq, int kv_len,
    int H, int max_distance) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if constexpr (on_tensor_cores<T>())
    dkv_wgmma<MODE, D>(bwd_smem, &tmap_q, &tmap_k, &tmap_v, &tmap_do, mask, rel_bias,
                       bucket_table, lse, delta, dk, dv, Lq, kv_len, H, max_distance);
  else
    dkv_fma<T, MODE, ROUTE, D>(reinterpret_cast<float*>(bwd_smem), q, k, v, dout, mask,
                               rel_bias, bucket_table, lse, delta, dk, dv, Lq, kv_len, H,
                               max_distance);
}

// The arguments of both backward entry points, in their C order.
struct BwdArgs {
  const void *q, *k, *v, *dout, *mask, *rel_bias, *bucket_table, *lse, *delta;
  void *out_a, *out_b;  // dq and dbins, or dk and dv
  int batch, q_len, kv_len, num_heads, head_dim, max_distance;
  cudaStream_t stream;
};

// The bf16 body's tensor maps of q, k, v and dout (cudaError_t on failure:
// a base that is not 16-byte aligned, or no cuTensorMapEncodeTiled).
int make_maps(CUtensorMap (&maps)[4], const BwdArgs& a, int d) {
  const int inner = a.num_heads * d;
  int err = hopper::make_tile_map(&maps[0], a.q, a.batch, a.q_len, inner);
  if (err == 0) err = hopper::make_tile_map(&maps[1], a.k, a.batch, a.kv_len, inner);
  if (err == 0) err = hopper::make_tile_map(&maps[2], a.v, a.batch, a.kv_len, inner);
  if (err == 0) err = hopper::make_tile_map(&maps[3], a.dout, a.batch, a.q_len, inner);
  return err;
}

template <typename T, int MODE, int ROUTE, int D>
int launch_dq(const BwdArgs& a) {
  constexpr bool kWg = on_tensor_cores<T>();
  const int nrel = bias_entries(MODE, a.max_distance);
  const size_t smem = kWg ? dq_wg_shared_bytes(nrel, D) : dq_shared_bytes(nrel, D);
  CUtensorMap maps[4] = {};
  if constexpr (kWg) {
    const int err = make_maps(maps, a, D);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, MODE, ROUTE, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.q_len + BQ - 1) / BQ, a.num_heads, a.batch);
  attn_bwd_dq_kernel<T, MODE, ROUTE, D><<<grid, bwd_threads<T>(), smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const int*>(a.mask), static_cast<const float*>(a.rel_bias),
      static_cast<const int*>(a.bucket_table), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out_a), static_cast<float*>(a.out_b),
      a.q_len, a.kv_len, a.num_heads, a.max_distance);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int ROUTE, int D>
int launch_dkv(const BwdArgs& a) {
  constexpr bool kWg = on_tensor_cores<T>();
  const int nrel = bias_entries(MODE, a.max_distance);
  const size_t smem = kWg ? dkv_wg_shared_bytes(nrel, D) : dkv_shared_bytes(nrel, D);
  CUtensorMap maps[4] = {};
  if constexpr (kWg) {
    const int err = make_maps(maps, a, D);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, MODE, ROUTE, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.kv_len + BK - 1) / BK, a.num_heads, a.batch);
  attn_bwd_dkv_kernel<T, MODE, ROUTE, D><<<grid, bwd_threads<T>(), smem, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const int*>(a.mask), static_cast<const float*>(a.rel_bias),
      static_cast<const int*>(a.bucket_table), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out_a), static_cast<T*>(a.out_b),
      a.q_len, a.kv_len, a.num_heads, a.max_distance);
  return (int)cudaGetLastError();
}

// Dispatch on mode and head width for one route and dtype; Launcher is
// DqLauncher or DkvLauncher.
template <template <typename, int, int, int> class Launcher, typename T, int ROUTE>
int dispatch_mode(const BwdArgs& a, int mode) {
  if (!takes_head_dim(mode, a.head_dim) || (is_causal(mode) && a.q_len != a.kv_len))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case ENCODER: return Launcher<T, ENCODER, ROUTE, 64>::run(a);
    case CAUSAL_SELF: return Launcher<T, CAUSAL_SELF, ROUTE, 64>::run(a);
    case CROSS: return Launcher<T, CROSS, ROUTE, 64>::run(a);
    case SCALED_CAUSAL:
      return a.head_dim == 128 ? Launcher<T, SCALED_CAUSAL, ROUTE, 128>::run(a)
                               : Launcher<T, SCALED_CAUSAL, ROUTE, 64>::run(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <typename, int, int, int> class Launcher>
int dispatch(const BwdArgs& a, int mode, int is_bf16, int route) {
  switch (route * 2 + (is_bf16 ? 1 : 0)) {
    case FULL_ROW * 2: return dispatch_mode<Launcher, float, FULL_ROW>(a, mode);
    case FULL_ROW * 2 + 1: return dispatch_mode<Launcher, __nv_bfloat16, FULL_ROW>(a, mode);
    case LONG * 2: return dispatch_mode<Launcher, float, LONG>(a, mode);
    case LONG * 2 + 1: return dispatch_mode<Launcher, __nv_bfloat16, LONG>(a, mode);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int MODE, int ROUTE, int D>
struct DqLauncher {
  static int run(const BwdArgs& a) { return launch_dq<T, MODE, ROUTE, D>(a); }
};
template <typename T, int MODE, int ROUTE, int D>
struct DkvLauncher {
  static int run(const BwdArgs& a) { return launch_dkv<T, MODE, ROUTE, D>(a); }
};

}  // namespace

extern "C" {

// q, dout, dq: [batch, q_len, num_heads * head_dim]; k, v: [batch, kv_len,
// num_heads * head_dim]; contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1). head_dim: 64, or 128 in mode 3. mask: int32 [batch, kv_len]. mode: 0
// encoder, 1 causal self-attention (q_len == kv_len), 2 cross-attention, 3
// scaled causal self-attention (q_len == kv_len). route: 0 full-row, 1
// long. rel_bias: fp32 [num_buckets, num_heads]; bucket_table: int32
// [2 * max_distance + 1]. lse, delta: fp32 [batch, num_heads, q_len].
// dbins: fp32 [num_heads, 2 * max_distance + 1], zeroed by the caller; the
// kernel adds dS summed by clamped relative position into it (rel_bias,
// bucket_table and dbins are unread in modes 2 and 3 and may be null). bf16
// q, k, v and dout must start on a 16-byte boundary (the tensor maps).
// Returns a cudaError_t value; 0 is success.
int t5_attn_backward_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* mask, const void* rel_bias, const void* bucket_table,
                        const void* lse, const void* delta, void* dq, void* dbins, int batch,
                        int q_len, int kv_len, int num_heads, int head_dim, int max_distance,
                        int mode, int is_bf16, int route, void* stream) {
  const BwdArgs a{q, k, v, dout, mask, rel_bias, bucket_table, lse, delta, dq, dbins,
                  batch, q_len, kv_len, num_heads, head_dim, max_distance,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<DqLauncher>(a, mode, is_bf16, route);
}

// As above; dk, dv: [batch, kv_len, num_heads * head_dim] in the input dtype.
int t5_attn_backward_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* mask, const void* rel_bias, const void* bucket_table,
                         const void* lse, const void* delta, void* dk, void* dv, int batch,
                         int q_len, int kv_len, int num_heads, int head_dim, int max_distance,
                         int mode, int is_bf16, int route, void* stream) {
  const BwdArgs a{q, k, v, dout, mask, rel_bias, bucket_table, lse, delta, dk, dv,
                  batch, q_len, kv_len, num_heads, head_dim, max_distance,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<DkvLauncher>(a, mode, is_bf16, route);
}

}  // extern "C"
