// Tile geometry and helpers shared by the T5 attention kernels
// (encoder_attn.cu: forward; encoder_attn_bwd.cu: backward).
//
// Every kernel runs 256 threads as a 16 x 16 grid over a 64 x 64 tile; the
// thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx, tx+16, tx+32,
// tx+48, so the 16 threads of one row are one half-warp and row reductions
// are four xor-shuffles. Tiles sit in shared memory as fp32 with a padded
// row stride, so column reads hit 32 different banks.
//
// One source serves the three attentions of T5, chosen at compile time by a
// mode (a template parameter; the C entry points take it as an int):
//
//   ENCODER      bidirectional self-attention: the relative-position bias,
//                the encoder's key mask (kernels 1, 3, 4 of the JAX package);
//   CAUSAL_SELF  decoder self-attention: the relative-position bias from a
//                table built with unidirectional buckets, and key k > query q
//                masked (kernels 1c, 3c, 4c);
//   CROSS        decoder-encoder attention: no bias, the encoder's key mask,
//                query length T and key length S independent (kernels 8, 9,
//                10).
//
// The bias is always read as table[clamp(k - q, -max_distance,
// max_distance) + max_distance]: bidirectional and unidirectional buckets
// differ only in the table's contents, which the caller builds with the
// plain bucket function.
//
// Each kernel is also compiled once per route (a second template
// parameter):
//
//   FULL_ROW  the JAX package's full-row kernels (1, 3, 4 and their causal
//             and cross forms): the forward saves each row's LSE for the
//             backward;
//   LONG      its KV-blocked long-context kernels (2, 6, 7): the forward
//             saves no LSE, and a far tile pair (every |k - q| at or past
//             max_distance, one side of the diagonal) takes its bias from
//             one per-head scalar, the saturated bucket's, and reads no
//             table; the dQ kernel adds such a tile's dS straight to that
//             bucket's bin;
//   LONG_LSE  the forward's sweep with q k^T only, writing the LSE that the
//             LONG backward needs (kernel 5).
//
// Both routes walk the keys in the same 64-wide tiles; on this card the
// full-row kernels were already KV-blocked, so the long route differs in
// what it saves and in the far-tile scalar, not in its memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace encoder_attn {

constexpr int D = 64;          // head width
constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int PAD = D + 1;     // shared row stride of a [rows][D] tile
constexpr int PPAD = BK + 1;   // shared row stride of a [rows][BK] tile

enum Mode : int { ENCODER = 0, CAUSAL_SELF = 1, CROSS = 2 };

enum Route : int { FULL_ROW = 0, LONG = 1, LONG_LSE = 2 };

__host__ __device__ constexpr bool has_bias(int mode) { return mode != CROSS; }
__host__ __device__ constexpr bool is_causal(int mode) { return mode == CAUSAL_SELF; }

// Where a (query tile, key tile) pair lies, from the tiles' first and last
// positions clipped to the lengths (the last tile of a ragged length is
// short): NEAR reads the bias table; RIGHT_FAR has every k - q >=
// max_distance (bias table entry 2*max_distance), LEFT_FAR every k - q <=
// -max_distance (entry 0). The JAX package's _block_far_bias makes the same
// split; CAUSAL_SELF never reaches a RIGHT_FAR pair (all-future tiles are
// skipped).
enum TileSide : int { NEAR = 0, RIGHT_FAR = 1, LEFT_FAR = 2 };

__device__ __forceinline__ int tile_side(int q0, int q_last, int k0, int k_last,
                                         int max_distance) {
  if (k0 - q_last >= max_distance) return RIGHT_FAR;
  if (q0 - k_last >= max_distance) return LEFT_FAR;
  return NEAR;
}

// Entries of the per-head bias table a block keeps in shared memory.
inline int bias_entries(int mode, int max_distance) {
  return has_bias(mode) ? 2 * max_distance + 1 : 0;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Max and sum over the 16 threads that share a row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Load rows [r0, r0 + 64) of one head of a flat [*, L, H*D] tensor into a
// [64][PAD] fp32 tile; rows at or past L read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, long base,
                                          long row_stride, int r0, int L, int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    tile[r * PAD + c] = row < L ? to_float(src[base + (long)row * row_stride + c]) : 0.f;
  }
}

// The same rows of two tensors of one layout (K and V, or Q and dO) into two
// tiles, in one loop: each thread keeps two global loads in flight, where two
// load_tile calls keep one (measured: kernel 1 ran ~10% slower with two).
template <typename T>
__device__ __forceinline__ void load_tile_pair(float* tile_a, float* tile_b,
                                               const T* __restrict__ a, const T* __restrict__ b,
                                               long base, long row_stride, int r0, int L,
                                               int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    const bool in = row < L;
    const long off = base + (long)row * row_stride + c;
    tile_a[r * PAD + c] = in ? to_float(a[off]) : 0.f;
    tile_b[r * PAD + c] = in ? to_float(b[off]) : 0.f;
  }
}

// The per-head bias of every clamped relative position k - q:
// bias[r] = rel_bias[bucket_table[r], h] for r = rel + max_distance.
__device__ __forceinline__ void load_bias(float* bias, const float* __restrict__ rel_bias,
                                          const int* __restrict__ bucket_table, int nrel, int H,
                                          int h, int tid) {
  for (int r = tid; r < nrel; r += THREADS) bias[r] = rel_bias[bucket_table[r] * H + h];
}

__device__ __forceinline__ int clamp_rel(int rel, int max_distance) {
  return min(max(rel, -max_distance), max_distance);
}

}  // namespace encoder_attn
