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
// reads back. Design: nothing of size Lq*Lk leaves the SM, arithmetic is fp32
// FMA loops over shared-memory tiles (tensor cores come in a later change),
// and causal blocks skip the tiles that lie wholly above the diagonal.
//
// - dK/dV: one block per (64-key tile, head, batch row) loops over 64-query
//   tiles (causal modes: from its own diagonal tile on), recomputes S^T,
//   P^T and dS^T for the tile (a far pair's bias from one scalar on the LONG
//   route), and accumulates dV and dK in registers; each output tile is
//   written once, with no atomics. A key tile with no valid key writes zeros
//   and skips the loop.
// - dQ: one block per (64-query tile, head, batch row) loops over key tiles
//   (causal modes: up to its diagonal tile) and accumulates dQ the same
//   way. The TPU kernel summed d_rel in SMEM across its sequential grid;
//   Hopper's blocks run in no order, so here each block bins dS by
//   clamp(k - q, -max_distance, max_distance) (the index of the forward's
//   bucket table) into 2*max_distance+1 shared fp32 bins, keeps the two
//   saturated bins in registers (every far pair lands there), and atomically
//   adds its bins into a global [H, 2*max_distance+1] buffer. The caller
//   folds the bins into the buckets with the bucket table. On the LONG
//   route a far tile pair (encoder_attn_common.cuh) takes its bias from one
//   scalar and adds its dS straight to the saturated bin's register, with
//   no per-pair position test, as the JAX kernel sums a far block's dS into
//   its one bucket. The atomics make
//   d_rel's summation order, and so its last bits, vary from run to run; dQ,
//   dK and dV are deterministic. CROSS and SCALED_CAUSAL have no bias and no
//   bins.
//
// At D = 128 (SCALED_CAUSAL) a thread accumulates 4 x 8 dQ values, or 4 x 8
// dK and 4 x 8 dV values; the score patches stay 4 x 4.
//
// The C entry points launch on the caller's stream, allocate nothing (the
// caller zeroes the bin buffer) and return cudaGetLastError().

#include <math.h>

#include "encoder_attn_common.cuh"

namespace {

using namespace encoder_attn;

size_t dq_shared_bytes(int nrel, int d) {
  return sizeof(float) * (size_t)(4 * BQ * pad_of(d) + BQ * PPAD + 2 * nrel + 2 * BQ) +
         sizeof(int) * BK;
}

size_t dkv_shared_bytes(int nrel, int d) {
  return sizeof(float) * (size_t)(4 * BK * pad_of(d) + 2 * BK * PPAD + nrel + 2 * BQ) +
         sizeof(int) * BK;
}

template <typename T, int MODE, int ROUTE, int D>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(
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
  extern __shared__ float smem[];
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
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(
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
  extern __shared__ float smem[];
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

// The arguments of both backward entry points, in their C order.
struct BwdArgs {
  const void *q, *k, *v, *dout, *mask, *rel_bias, *bucket_table, *lse, *delta;
  void *out_a, *out_b;  // dq and dbins, or dk and dv
  int batch, q_len, kv_len, num_heads, head_dim, max_distance;
  cudaStream_t stream;
};

template <typename T, int MODE, int ROUTE, int D>
int launch_dq(const BwdArgs& a) {
  const size_t smem = dq_shared_bytes(bias_entries(MODE, a.max_distance), D);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, MODE, ROUTE, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.q_len + BQ - 1) / BQ, a.num_heads, a.batch);
  attn_bwd_dq_kernel<T, MODE, ROUTE, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const int*>(a.mask),
      static_cast<const float*>(a.rel_bias), static_cast<const int*>(a.bucket_table),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out_a), static_cast<float*>(a.out_b), a.q_len, a.kv_len, a.num_heads,
      a.max_distance);
  return (int)cudaGetLastError();
}

template <typename T, int MODE, int ROUTE, int D>
int launch_dkv(const BwdArgs& a) {
  const size_t smem = dkv_shared_bytes(bias_entries(MODE, a.max_distance), D);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, MODE, ROUTE, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.kv_len + BK - 1) / BK, a.num_heads, a.batch);
  attn_bwd_dkv_kernel<T, MODE, ROUTE, D><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const int*>(a.mask),
      static_cast<const float*>(a.rel_bias), static_cast<const int*>(a.bucket_table),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out_a), static_cast<T*>(a.out_b), a.q_len, a.kv_len, a.num_heads,
      a.max_distance);
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
// bucket_table and dbins are unread in modes 2 and 3 and may be null).
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
