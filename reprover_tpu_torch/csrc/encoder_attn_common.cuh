// Tile geometry and helpers shared by the T5 attention kernels
// (encoder_attn.cu: forward; encoder_attn_bwd.cu: backward).
//
// On fp32 inputs the kernels run 256 threads as a 16 x 16 grid over a
// 64 x 64 tile; the thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns
// tx, tx+16, tx+32, tx+48 of a score tile, and columns tx + 16*j (j < D/16)
// of a [64][D] output tile, so the 16 threads of one row are one half-warp
// and row reductions are four xor-shuffles. Their tiles sit in shared
// memory as fp32 with a padded row stride, so column reads hit 32 different
// banks, and the products are FMA loops.
//
// On bf16 inputs (every main path: serving and training run bf16
// products) the forward (encoder_attn.cu) and the backward
// (encoder_attn_bwd.cu) are Hopper designs instead: a warpgroup of 128
// threads per 64-row tile (the forward: two, splitting the keys, for the
// long route's cross-attention), bf16 tiles brought by TMA into
// 128-byte-swizzled shared memory, every product on the tensor cores
// (wgmma, hopper_mma.cuh), and the epilogue in the accumulator's layout,
// where the four threads of a quad share a row (add_tile_bias below).
//
// The head width D is a template parameter: 64 (T5, and every mode), or 128
// (SCALED_CAUSAL only: LLaMA-7B's 4096 / 32 heads). At D = 128 an fp32 tile
// is twice the shared memory (the fp32 forward's block 113 KiB, dQ's 146
// KiB, dK/dV's 162 KiB, one block per SM) and a thread owns twice the
// output columns; the bf16 forward's block takes 82 KiB, the bf16
// backward's 97 KiB.
//
// One source serves the three attentions of T5 and the LLaMA-family causal
// attention, chosen at compile time by a mode (a template parameter; the C
// entry points take it as an int):
//
//   ENCODER      bidirectional self-attention: the relative-position bias,
//                the encoder's key mask (kernels 1, 3, 4 of the JAX package);
//   CAUSAL_SELF  decoder self-attention: the relative-position bias from a
//                table built with unidirectional buckets, and key k > query q
//                masked (kernels 1c, 3c, 4c);
//   CROSS        decoder-encoder attention: no bias, the encoder's key mask,
//                query length T and key length S independent (kernels 8, 9,
//                10);
//   SCALED_CAUSAL the LLaMA-family teacher-forced self-attention of
//                scaled_causal_flash_attention: no bias, key k > query q
//                masked and the key padding mask (the 1/sqrt(d) scale is
//                folded into q by the caller), D = 64 or 128 (kernels 1s,
//                3s, 4s: the JAX package runs it through kernels 1, 3, 4
//                with a zero bias table).
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
// what it saves and in the far-tile scalar, not in its memory. (The bf16
// kernels take a far pair's scalar, and bin its dS, on the full-row route
// too: it is the value the table holds at every clamped position of such a
// pair.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace encoder_attn {

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 scores each
constexpr int WG_THREADS = 128;  // a warpgroup (the bf16 forward runs one or two)
constexpr int PPAD = BK + 1;   // shared row stride of a [rows][BK] tile

// Shared row stride of a [rows][D] tile.
__host__ __device__ constexpr int pad_of(int d) { return d + 1; }

enum Mode : int { ENCODER = 0, CAUSAL_SELF = 1, CROSS = 2, SCALED_CAUSAL = 3 };

enum Route : int { FULL_ROW = 0, LONG = 1, LONG_LSE = 2 };

__host__ __device__ constexpr bool has_bias(int mode) {
  return mode == ENCODER || mode == CAUSAL_SELF;
}
__host__ __device__ constexpr bool is_causal(int mode) {
  return mode == CAUSAL_SELF || mode == SCALED_CAUSAL;
}
// The head widths a mode is compiled for.
__host__ __device__ constexpr bool takes_head_dim(int mode, int d) {
  return d == 64 || (mode == SCALED_CAUSAL && d == 128);
}

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

__device__ __forceinline__ int clamp_rel(int rel, int max_distance) {
  return min(max(rel, -max_distance), max_distance);
}

// The bf16 bodies (forward and backward) run on the tensor cores; fp32 keeps
// the FMA loops.
template <typename T>
__host__ __device__ constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// k - q of register r of a thread's wgmma accumulator tile (hopper_mma.cuh:
// rows r0 + 8 ((r / 2) % 2), columns c0 + 8 (r / 4) + r % 2) less its base
// (below). kKeyRows: the rows are keys and the columns queries (the dK/dV
// kernel's S^T), else the rows are queries.
template <bool kKeyRows>
__host__ __device__ constexpr int rel_offset(int r) {
  return kKeyRows ? 8 * ((r / 2) % 2) - 8 * (r / 4) - r % 2
                  : 8 * (r / 4) + r % 2 - 8 * ((r / 2) % 2);
}

// The bias of one (query tile, key tile) pair, whose tile_side is `side`,
// on the 32 scores a thread holds in the accumulator layout: a near pair's
// per-element table entries are added to x here; a far pair has one value
// for all of them (the table's saturated end), which is returned for the
// caller to fold in (else 0).
template <bool kKeyRows>
__device__ __forceinline__ float add_tile_bias(float (&x)[32], const float* bias, int side,
                                               int q0, int k0, int r0, int c0,
                                               int max_distance) {
  if (side != NEAR) return bias[side == RIGHT_FAR ? 2 * max_distance : 0];
  const int base = kKeyRows ? k0 + r0 - q0 - c0 : k0 + c0 - q0 - r0;
  if (k0 - q0 + (BK - 1) <= max_distance && q0 - k0 + (BQ - 1) <= max_distance) {
    // Every k - q of the pair is inside the table: one base, offsets fixed
    // at compile time.
    const float* row = bias + max_distance + base;
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] += row[rel_offset<kKeyRows>(r)];
  } else {
#pragma unroll
    for (int r = 0; r < 32; ++r)
      x[r] += bias[clamp_rel(base + rel_offset<kKeyRows>(r), max_distance) + max_distance];
  }
  return 0.f;
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
// [64][D + 1] fp32 tile; rows at or past L read as 0.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, long base,
                                          long row_stride, int r0, int L, int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    tile[r * pad_of(D) + c] = row < L ? to_float(src[base + (long)row * row_stride + c]) : 0.f;
  }
}

// The same rows of two tensors of one layout (K and V, or Q and dO) into two
// tiles, in one loop: each thread keeps two global loads in flight, where two
// load_tile calls keep one (measured: kernel 1 ran ~10% slower with two).
template <int D, typename T>
__device__ __forceinline__ void load_tile_pair(float* tile_a, float* tile_b,
                                               const T* __restrict__ a, const T* __restrict__ b,
                                               long base, long row_stride, int r0, int L,
                                               int tid) {
  for (int idx = tid; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    const bool in = row < L;
    const long off = base + (long)row * row_stride + c;
    tile_a[r * pad_of(D) + c] = in ? to_float(a[off]) : 0.f;
    tile_b[r * pad_of(D) + c] = in ? to_float(b[off]) : 0.f;
  }
}

// The per-head bias of every clamped relative position k - q:
// bias[r] = rel_bias[bucket_table[r], h] for r = rel + max_distance, by the
// block's `nthreads` threads.
__device__ __forceinline__ void load_bias(float* bias, const float* __restrict__ rel_bias,
                                          const int* __restrict__ bucket_table, int nrel, int H,
                                          int h, int tid, int nthreads = THREADS) {
  for (int r = tid; r < nrel; r += nthreads) bias[r] = rel_bias[bucket_table[r] * H + h];
}

}  // namespace encoder_attn
