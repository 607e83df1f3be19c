// T5 attention forward for Hopper (sm_90a): encoder self-attention, causal
// decoder self-attention, decoder-encoder cross-attention and the
// LLaMA-family scaled causal self-attention from one source, selected by a
// compile-time mode, each on two routes (encoder_attn_common.cuh).
//
// Replaces the Pallas TPU kernels of reprover_tpu/ops/flash_attention.py:
//
//   ENCODER      _encoder_attn_kernel (:176), behind encoder_flash_attention;
//   CAUSAL_SELF  the same kernel with causal=True, behind
//                causal_flash_attention (:1553);
//   CROSS        _cross_attn_kernel (:1624), behind cross_flash_attention;
//   SCALED_CAUSAL the same kernel with causal=True and a zero bias table,
//                behind scaled_causal_flash_attention (:1589), at head
//                width 64 or 128;
//
// and on the LONG route _encoder_attn_kernel_blockwise (:274, all four
// modes: the JAX package runs cross there with a zero bias table), and on
// the LONG_LSE route _bwd_lse_kernel_blockwise (:864). A fifth template
// parameter compiles the ablation variants of the encoder's FULL_ROW kernel
// (benchmarks/flash_kernel_bisect.py:71 _kernel, kernel 14; below).
//
// Per batch row b and head h, on the flat [B, L, H*D] projection layout,
// with Lq queries and Lk keys (Lq == Lk for the self-attentions):
//
//   S = q_h k_h^T                       (unscaled: T5 has no 1/sqrt(d), and
//                                        SCALED_CAUSAL's q arrives scaled)
//   S += rel_bias[bucket(k - q), h]     (ENCODER, CAUSAL_SELF)
//   drop key columns whose mask is 0, and for the causal modes keys k > q
//   out_h = softmax(S) v_h              (exact, fp32; a row with no valid
//                                        key gives 0)
//
// FULL_ROW under training also writes each row's log-sum-exp, m + log(l)
// from the running max and sum it already holds (one store per row), so the
// backward (encoder_attn_bwd.cu) rebuilds P = exp(S - LSE) without a second
// sweep. LONG saves no LSE, as the JAX package's long-context forward does:
// LONG_LSE recomputes it in the backward with the same sweep minus V. A row
// with no valid key gets LSE = +inf, so every P of that row is 0.
//
// What bounds it on the H100: the score work is 4*Lq*Lk*d operations per
// (b, h) against 2*(Lq + Lk)*d elements moved, so from a few hundred keys on
// it is compute-bound; the memory a naive version spends on the
// [B, H, Lq, Lk] fp32 score tensor (805 MB at B=8, L=2048; 6.4 GB at B=4,
// L=8192) is what this kernel removes. Design: one block of 256 threads per
// (64-query tile, head, batch row) walks the keys in 64-key tiles with a
// running row max and row sum (online softmax), so nothing of size Lq*Lk
// leaves the SM. The Q, K, V and probability tiles sit in shared memory as
// fp32; each thread owns a 4x4 patch of the score tile and 4 x D/16 outputs
// and runs plain FMA loops (no tensor cores yet: right first, fast in a later
// change). A causal block stops at its own diagonal tile, so it does about
// half the square's work. The bias is read from a per-head table of
// 2*max_distance+1 values built once per block from a bucket table that the
// caller computes with the plain bucket function (bidirectional for the
// encoder, unidirectional for the decoder), so no float log runs here and
// no bucket can flip at an exact boundary; on the LONG routes a far tile
// pair adds one scalar instead (the table's saturated end). The row max is
// taken over valid keys only. LONG_LSE loads no V and keeps no probability
// tile, so its block needs half the shared memory.
//
// The ablation variants (ENCODER, FULL_ROW, D = 64 only; kernel 14), each
// dropping one piece of kernel 1's work so that its cost shows as the time
// it saves:
//
//   FULL        kernel 1 as it ships (the production instantiation itself);
//   NOBIAS      no bias: scores + key mask, softmax, PV;
//   SHAREDCMP   the bias add kept, its per-element table gather dropped:
//               every pair of a (query tile, key tile) adds one entry,
//               table[clamp(k0 - q0)] of the tiles' first positions, read
//               once per tile (the TPU harness hoists its per-head bucket
//               compares; this kernel has no compares, its counterpart is
//               the gather);
//   NOSOFTMAX   no softmax: P = (S + bias + mask) * 1e-4, with a masked key
//               adding NEG_INF = -1e10 as the TPU harness does; then PV;
//   MATMULONLY  P = (q k^T) * 1e-4, no bias, no mask; then PV.
//
// The variants are not the attention: they attribute its cost.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError() after the launch.

#include <math.h>

#include "encoder_attn_common.cuh"

namespace {

using namespace encoder_attn;

// The ablation variants of kernel 14 (header comment); FULL is kernel 1.
enum Variant : int { FULL = 0, NOBIAS = 1, SHAREDCMP = 2, NOSOFTMAX = 3, MATMULONLY = 4 };

constexpr float NEG_INF_BIAS = -1e10f;  // the TPU harness's additive mask
constexpr float NO_SOFTMAX_SCALE = 1e-4f;

size_t shared_bytes(int nrel, int route, int d) {
  // LONG_LSE keeps no V and no probability tile.
  const size_t pad = pad_of(d);
  const size_t tiles = route == LONG_LSE ? 2 * BQ * pad : 3 * BQ * pad + BQ * PPAD;
  return sizeof(float) * (tiles + nrel) + sizeof(int) * BK;
}

template <typename T, int MODE, int ROUTE, int D, int VARIANT>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(
    const T* __restrict__ q,               // [B, Lq, H*D]
    const T* __restrict__ k,               // [B, Lk, H*D]
    const T* __restrict__ v,               // [B, Lk, H*D] (unread by LONG_LSE)
    const int* __restrict__ mask,          // [B, Lk], nonzero = valid key
    const float* __restrict__ rel_bias,    // [num_buckets, H] (only ENCODER, CAUSAL_SELF)
    const int* __restrict__ bucket_table,  // [2*max_distance+1], by k - q + max_distance
    T* __restrict__ out,                   // [B, Lq, H*D] (null for LONG_LSE)
    float* __restrict__ lse,               // [B, H, Lq] or null (never null for LONG_LSE)
    int Lq, int kv_len, int H, int max_distance) {
  static_assert(D % 16 == 0, "a thread owns D / 16 output columns");
  static_assert(VARIANT == FULL || (MODE == ENCODER && ROUTE == FULL_ROW && D == 64),
                "the ablation variants are of kernel 1 only");
  constexpr int PAD = pad_of(D);
  constexpr int NC = D / 16;  // output columns per thread
  constexpr bool kTable = has_bias(MODE) && VARIANT != NOBIAS && VARIANT != MATMULONLY;
  constexpr bool kCausal = is_causal(MODE);
  constexpr bool kLong = ROUTE != FULL_ROW;
  constexpr bool kLseOnly = ROUTE == LONG_LSE;
  constexpr bool kSoftmax = VARIANT != NOSOFTMAX && VARIANT != MATMULONLY;
  // Self-attention has as many keys as queries: saying so lets the
  // compiler share the two lengths and base offsets (one register less).
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kTable ? 2 * max_distance + 1 : 0;
  extern __shared__ float smem[];
  float* qs = smem;                                // [BQ][PAD]
  float* ks = qs + BQ * PAD;                       // [BK][PAD]
  float* vs = ks + BK * PAD;                       // [BK][PAD] (not LONG_LSE)
  float* ps = vs + (kLseOnly ? 0 : BK * PAD);      // [BQ][PPAD] (not LONG_LSE)
  float* bias = ps + (kLseOnly ? 0 : BQ * PPAD);   // [nrel]
  int* key_ok = reinterpret_cast<int*>(bias + nrel);  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // score columns tx + 16*j (j < 4), output columns tx + 16*j (j < NC)
  const long row_stride = (long)H * D;
  const long q_base = (long)b * Lq * row_stride + (long)h * D;
  const long k_base = (long)b * Lk * row_stride + (long)h * D;

  if constexpr (kTable) load_bias(bias, rel_bias, bucket_table, nrel, H, h, tid);
  load_tile<D>(qs, q, q_base, row_stride, q0, Lq, tid);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // A causal tile of queries sees no key past its last row.
  const int k_end = kCausal ? min(Lk, q0 + BQ) : Lk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    if constexpr (kLseOnly)
      load_tile<D>(ks, k, k_base, row_stride, k0, Lk, tid);
    else
      load_tile_pair<D>(ks, vs, k, v, k_base, row_stride, k0, Lk, tid);
    if (tid < BK) {
      const int kj = k0 + tid;
      key_ok[tid] = kj < Lk && mask[(long)b * Lk + kj] != 0;
    }
    __syncthreads();
    // LONG: the tile pair's side, the same in every thread; a far pair's
    // bias is one entry at the table's saturated end. SHAREDCMP: one entry
    // for the whole tile pair.
    int side = NEAR;
    float far_bias = 0.f;
    if constexpr (kLong && kTable) {
      side = tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
      far_bias = bias[side == RIGHT_FAR ? 2 * max_distance : 0];
    }
    if constexpr (VARIANT == SHAREDCMP) far_bias = bias[clamp_rel(k0 - q0, max_distance) + max_distance];

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * PAD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * PAD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      if constexpr (!kSoftmax) {
        // NOSOFTMAX / MATMULONLY: P is the scaled score; no max, no sum.
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kc = tx + 16 * j;
          float x = s[i][j];
          if constexpr (VARIANT == NOSOFTMAX) {
            x += bias[clamp_rel(k0 + kc - qi, max_distance) + max_distance];
            if (!key_ok[kc]) x += NEG_INF_BIAS;
          }
          ps[(ty * 4 + i) * PPAD + kc] = x * NO_SOFTMAX_SCALE;
        }
        continue;
      }
      float tile_max = -INFINITY;
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        ok[j] = key_ok[kc] && (!kCausal || k0 + kc <= qi);
        if (ok[j]) {
          if constexpr (kTable) {
            if ((kLong && side != NEAR) || VARIANT == SHAREDCMP)
              s[i][j] += far_bias;
            else
              s[i][j] += bias[clamp_rel(k0 + kc - qi, max_distance) + max_distance];
          }
          tile_max = fmaxf(tile_max, s[i][j]);
        }
      }
      const float m_new = fmaxf(m[i], row_max(tile_max));
      // No valid key seen yet in this row: nothing to accumulate.
      const bool any = m_new != -INFINITY;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const float p = (any && ok[j]) ? expf(s[i][j] - m_new) : 0.f;
        if constexpr (!kLseOnly) ps[(ty * 4 + i) * PPAD + kc] = p;
        psum += p;
      }
      const float scale = any ? expf(m[i] - m_new) : 1.f;
      l[i] = l[i] * scale + row_sum(psum);
      m[i] = m_new;
      if constexpr (!kLseOnly) {
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] *= scale;
      }
    }
    if constexpr (!kLseOnly) {
      __syncthreads();

#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float pv[4], vv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PPAD + kk];
#pragma unroll
        for (int j = 0; j < NC; ++j) vv[j] = vs[kk * PAD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < Lq) {
      if constexpr (!kLseOnly) {
        const float inv = !kSoftmax ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 0.f);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          out[q_base + (long)qi * row_stride + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
      }
      // m and l are the same in the 16 threads of a row: one of them stores.
      if (kSoftmax && lse != nullptr && tx == 0)
        lse[((long)b * H + h) * Lq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

template <typename T, int MODE, int ROUTE, int D, int VARIANT = FULL>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* rel_bias,
           const void* bucket_table, void* out, void* lse, int batch, int q_len, int kv_len,
           int num_heads, int max_distance, cudaStream_t stream) {
  const size_t smem = shared_bytes(bias_entries(MODE, max_distance), ROUTE, D);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, MODE, ROUTE, D, VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q_len + BQ - 1) / BQ, num_heads, batch);
  attn_fwd_kernel<T, MODE, ROUTE, D, VARIANT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const float*>(rel_bias),
      static_cast<const int*>(bucket_table), static_cast<T*>(out), static_cast<float*>(lse),
      q_len, kv_len, num_heads, max_distance);
  return (int)cudaGetLastError();
}

template <typename T, int ROUTE>
int launch_mode(int mode, int head_dim, const void* q, const void* k, const void* v,
                const void* mask, const void* rel_bias, const void* bucket_table, void* out,
                void* lse, int batch, int q_len, int kv_len, int num_heads, int max_distance,
                cudaStream_t stream) {
  if (!takes_head_dim(mode, head_dim) || (is_causal(mode) && q_len != kv_len))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case ENCODER:
      return launch<T, ENCODER, ROUTE, 64>(q, k, v, mask, rel_bias, bucket_table, out, lse,
                                           batch, q_len, kv_len, num_heads, max_distance, stream);
    case CAUSAL_SELF:
      return launch<T, CAUSAL_SELF, ROUTE, 64>(q, k, v, mask, rel_bias, bucket_table, out, lse,
                                               batch, q_len, kv_len, num_heads, max_distance,
                                               stream);
    case CROSS:
      return launch<T, CROSS, ROUTE, 64>(q, k, v, mask, rel_bias, bucket_table, out, lse, batch,
                                         q_len, kv_len, num_heads, max_distance, stream);
    case SCALED_CAUSAL:
      if (head_dim == 128)
        return launch<T, SCALED_CAUSAL, ROUTE, 128>(q, k, v, mask, rel_bias, bucket_table, out,
                                                    lse, batch, q_len, kv_len, num_heads,
                                                    max_distance, stream);
      return launch<T, SCALED_CAUSAL, ROUTE, 64>(q, k, v, mask, rel_bias, bucket_table, out,
                                                 lse, batch, q_len, kv_len, num_heads,
                                                 max_distance, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_route(int route, int mode, int head_dim, const void* q, const void* k, const void* v,
                 const void* mask, const void* rel_bias, const void* bucket_table, void* out,
                 void* lse, int batch, int q_len, int kv_len, int num_heads, int max_distance,
                 cudaStream_t stream) {
  // The outputs each route writes: FULL_ROW out (and lse if asked), LONG out
  // alone, LONG_LSE lse alone.
  const bool outputs_ok = route == LONG_LSE ? out == nullptr && lse != nullptr
                                             : out != nullptr && (route == FULL_ROW || lse == nullptr);
  if (!outputs_ok) return (int)cudaErrorInvalidValue;
  switch (route) {
    case FULL_ROW:
      return launch_mode<T, FULL_ROW>(mode, head_dim, q, k, v, mask, rel_bias, bucket_table,
                                      out, lse, batch, q_len, kv_len, num_heads, max_distance,
                                      stream);
    case LONG:
      return launch_mode<T, LONG>(mode, head_dim, q, k, v, mask, rel_bias, bucket_table, out,
                                  lse, batch, q_len, kv_len, num_heads, max_distance, stream);
    case LONG_LSE:
      return launch_mode<T, LONG_LSE>(mode, head_dim, q, k, v, mask, rel_bias, bucket_table,
                                      out, lse, batch, q_len, kv_len, num_heads, max_distance,
                                      stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_variant(int variant, const void* q, const void* k, const void* v, const void* mask,
                   const void* rel_bias, const void* bucket_table, void* out, int batch,
                   int length, int num_heads, int max_distance, cudaStream_t stream) {
  switch (variant) {
#define BISECT_CASE(V)                                                                       \
  case V:                                                                                    \
    return launch<T, ENCODER, FULL_ROW, 64, V>(q, k, v, mask, rel_bias, bucket_table, out, \
                                               nullptr, batch, length, length, num_heads,   \
                                               max_distance, stream);
    BISECT_CASE(FULL)
    BISECT_CASE(NOBIAS)
    BISECT_CASE(SHAREDCMP)
    BISECT_CASE(NOSOFTMAX)
    BISECT_CASE(MATMULONLY)
#undef BISECT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, out: [batch, q_len, num_heads * head_dim]; k, v: [batch, kv_len,
// num_heads * head_dim]; contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1). head_dim: 64, or 128 in mode 3. mask: int32 [batch, kv_len]. mode: 0
// encoder, 1 causal self-attention (q_len == kv_len), 2 cross-attention, 3
// scaled causal self-attention (q_len == kv_len, q pre-scaled). rel_bias:
// fp32 [num_buckets, num_heads] and bucket_table: int32 [2 * max_distance +
// 1] (both unread in modes 2 and 3). lse: fp32 [batch, num_heads, q_len].
// route: 0 full-row (out, and lse unless null), 1 long (out; lse must be
// null), 2 the long route's LSE sweep (lse; out must be null, v is unread).
// Returns a cudaError_t value; 0 is success.
int t5_attn_forward(const void* q, const void* k, const void* v, const void* mask,
                    const void* rel_bias, const void* bucket_table, void* out, void* lse,
                    int batch, int q_len, int kv_len, int num_heads, int head_dim,
                    int max_distance, int mode, int is_bf16, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_route<__nv_bfloat16>(route, mode, head_dim, q, k, v, mask, rel_bias,
                                       bucket_table, out, lse, batch, q_len, kv_len, num_heads,
                                       max_distance, s);
  return launch_route<float>(route, mode, head_dim, q, k, v, mask, rel_bias, bucket_table, out,
                             lse, batch, q_len, kv_len, num_heads, max_distance, s);
}

// Kernel 14: one ablation variant of the encoder forward (0 full, 1
// nobias, 2 sharedcmp, 3 nosoftmax, 4 matmulonly; header comment) on the
// operands of t5_attn_forward's mode 0 at head width 64, full-row, no LSE.
int attn_bisect_forward(const void* q, const void* k, const void* v, const void* mask,
                        const void* rel_bias, const void* bucket_table, void* out, int batch,
                        int length, int num_heads, int max_distance, int variant, int is_bf16,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_variant<__nv_bfloat16>(variant, q, k, v, mask, rel_bias, bucket_table, out,
                                         batch, length, num_heads, max_distance, s);
  return launch_variant<float>(variant, q, k, v, mask, rel_bias, bucket_table, out, batch,
                               length, num_heads, max_distance, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
