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
// L=8192) is what this kernel removes. One block per (64-query tile, head,
// batch row) walks the keys in 64-key tiles with a running row max and row
// sum (online softmax), so nothing of size Lq*Lk leaves the SM. A causal
// block stops at its own diagonal tile, so it does about half the square's
// work. The bias is
// read from a per-head table of 2*max_distance+1 values built once per
// block from a bucket table that the caller computes with the plain bucket
// function (bidirectional for the encoder, unidirectional for the decoder),
// so no float log runs here and no bucket can flip at an exact boundary; on
// the LONG routes a far tile pair adds one scalar instead (the table's
// saturated end). The row max is taken over valid keys only.
//
// Two bodies, by input type:
//
//   bf16 (every main path): Hopper's tensor cores. One warpgroup (128
//   threads) owns the 64-query tile; on the long route's cross-attention,
//   whose grid is a few query tiles per head with a hundred key tiles or
//   more each, two warpgroups split the key tiles (even and odd) and merge
//   their row max, row sum and O through shared memory at the end. Q
//   [64][D] arrives once by TMA; K and V [64][D] tiles stream through two
//   rings of two stages per warpgroup in shared memory (K alone on the LSE
//   sweep), each stage completing on its own mbarrier, one thread
//   refilling a stage as soon as its warpgroup is past the tile, so each
//   copy has a tile's compute to land. Tiles are
//   bf16 in 128-byte-swizzled [64][64] boxes (two per tile at D = 128).
//   S = Q K^T is wgmma m64n64k16 (A and B K-major from shared memory, fp32
//   accumulators); the epilogue (key mask, causal cut, bias gather,
//   far-tile scalar, online softmax in fp32, exp2 on the special-function
//   unit) runs on the accumulator registers, each thread on its two rows
//   and 16 columns, row max and sum over the quad that shares a row; P is
//   rounded to bf16 in registers (the Pallas kernels' p.astype(v.dtype)
//   before PV) and is A of O += P V, wgmma m64n64k16 per 64 output columns
//   with V MN-major from shared memory. The row sum l stays fp32, from the
//   unrounded p. A block holds 42 KiB of shared memory at D = 64 (five
//   blocks per SM) and 82 KiB at D = 128 (two), so the SM's other blocks
//   fill the tensor cores while one block runs its softmax (two
//   warpgroups per block everywhere cost residency); overlapping
//   the two inside a block (tile j's P V in flight during tile j + 1's
//   softmax) cost registers and residency at D = 64 and was not kept. A
//   tile pair inside the table's reach gathers the bias with offsets fixed
//   at compile time, a far pair folds its one scalar into the row max and
//   the exponent, and only the pairs across the table's end clamp per
//   element; a tile whose keys are all valid and not on a causal diagonal
//   skips the mask, and a row whose max did not move skips the rescale.
//   The causal grid runs its longest query tiles first, so the tail is
//   short.
//
//   fp32 (the retriever's bf16-vs-fp32 cosine check; the card checks hold
//   it to 1e-4): 256 threads, Q, K, V and P as fp32 in shared memory, each
//   thread a 4x4 patch of the score tile and 4 x D/16 outputs, plain FMA
//   loops. TF32 tensor cores keep about three decimal digits and could not
//   meet 1e-4, so fp32 keeps these loops.
//
// LONG_LSE loads no V and runs no second product.
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

#include <type_traits>

#include "encoder_attn_common.cuh"
#include "hopper_mma.cuh"

namespace {

using namespace encoder_attn;

// The ablation variants of kernel 14 (header comment); FULL is kernel 1.
enum Variant : int { FULL = 0, NOBIAS = 1, SHAREDCMP = 2, NOSOFTMAX = 3, MATMULONLY = 4 };

constexpr float NEG_INF_BIAS = -1e10f;  // the TPU harness's additive mask
constexpr float NO_SOFTMAX_SCALE = 1e-4f;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__host__ __device__ constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Shared memory of the fp32 body.
size_t shared_bytes(int nrel, int route, int d) {
  // LONG_LSE keeps no V and no probability tile.
  const size_t pad = pad_of(d);
  const size_t tiles = route == LONG_LSE ? 2 * BQ * pad : 3 * BQ * pad + BQ * PPAD;
  return sizeof(float) * (tiles + nrel) + sizeof(int) * BK;
}

// Warpgroups of a bf16 block. Cross-attention on the long route (at most
// 512 queries over more than 4096 keys) has a small grid, a few query
// tiles per head, each walking a hundred key tiles or more: two
// warpgroups split each tile's keys, one taking the even key tiles and one
// the odd, and merge at the end. Every other grid is large enough that one
// warpgroup per block keeps more of them resident.
__host__ __device__ constexpr int warpgroups(int mode, int route) {
  return mode == CROSS && route != FULL_ROW ? 2 : 1;
}
template <typename T, int MODE, int ROUTE>
__host__ __device__ constexpr int fwd_threads() {
  return on_tensor_cores<T>() ? warpgroups(MODE, ROUTE) * WG_THREADS : THREADS;
}

// Shared memory of the bf16 body, from a 1024-byte boundary (the slack
// below): the Q tile, then per warpgroup a ring of K tiles and a ring of V
// tiles (none on the LSE sweep), two stages each, D / 64 boxes per tile;
// then the mbarriers (Q, then each warpgroup's K and V stages), each
// warpgroup's key-mask bits of three key tiles (two 32-bit words each) and
// the bias table: 42 KiB at D = 64 (five blocks per SM), 82 KiB at D = 128
// (two), 74 KiB for the two warpgroups of the long cross-attention.
constexpr int STAGES = 2;  // stages per ring
__host__ __device__ constexpr int ring_tiles(int route) {
  return (route == LONG_LSE ? 1 : 2) * STAGES;  // per warpgroup
}
size_t wg_shared_bytes(int nrel, int mode, int route, int d) {
  const int wgs = warpgroups(mode, route), tiles = 1 + wgs * ring_tiles(route);
  return 1024 + tiles * (d / 64) * hopper::BOX_BYTES + tiles * sizeof(uint64_t) +
         wgs * 6 * sizeof(uint32_t) + sizeof(float) * nrel;
}

// ----------------------------------------------------------------- fp32 body

template <int MODE, int ROUTE, int D, int VARIANT>
__device__ __forceinline__ void fwd_fma(float* smem, const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const int* __restrict__ mask,
                                        const float* __restrict__ rel_bias,
                                        const int* __restrict__ bucket_table,
                                        float* __restrict__ out, float* __restrict__ lse,
                                        int Lq, int kv_len, int H, int max_distance) {
  static_assert(D % 16 == 0, "a thread owns D / 16 output columns");
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
          out[q_base + (long)qi * row_stride + tx + 16 * j] = acc[i][j] * inv;
      }
      // m and l are the same in the 16 threads of a row: one of them stores.
      if (kSoftmax && lse != nullptr && tx == 0)
        lse[((long)b * H + h) * Lq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// ----------------------------------------------------------------- bf16 body

// The bias of one (query tile, key tile) pair on the 32 scores a thread
// holds (rows r0 and r0 + 8 of the tile, columns c0 + 8 j + {0, 1}): a near
// pair's per-element table entries are added to x here; a far pair (and
// every SHAREDCMP pair) has one value for all of them, which is returned
// for the caller to fold into the row max and the exponent (else 0).
template <int VARIANT>
__device__ __forceinline__ float add_near_bias(float (&x)[32], const float* bias, int q0, int k0,
                                               int Lq, int Lk, int r0, int c0,
                                               int max_distance) {
  if constexpr (VARIANT == SHAREDCMP) return bias[clamp_rel(k0 - q0, max_distance) + max_distance];
  const int side = tile_side(q0, min(q0 + BQ, Lq) - 1, k0, min(k0 + BK, Lk) - 1, max_distance);
  // Every k - q of a far pair is at or past max_distance on one side: the
  // table's saturated end.
  if (side != NEAR) return bias[side == RIGHT_FAR ? 2 * max_distance : 0];
  if (k0 - q0 + (BK - 1) <= max_distance && q0 - k0 + (BQ - 1) <= max_distance) {
    // Every k - q of the pair is inside the table: one base, offsets fixed
    // at compile time.
    const float* row = bias + max_distance + (k0 - q0) + c0 - r0;
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] += row[8 * (r / 4) + (r % 2) - 8 * ((r / 2) % 2)];
  } else {
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int rel = k0 + 8 * (r / 4) + c0 + (r % 2) - (q0 + r0 + 8 * ((r / 2) % 2));
      x[r] += bias[clamp_rel(rel, max_distance) + max_distance];
    }
  }
  return 0.f;
}

// 2^x on the special-function unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int MODE, int ROUTE, int D, int VARIANT>
__device__ __forceinline__ void fwd_wgmma(unsigned char* smem_raw, const CUtensorMap* tmap_q,
                                          const CUtensorMap* tmap_k, const CUtensorMap* tmap_v,
                                          const int* __restrict__ mask,
                                          const float* __restrict__ rel_bias,
                                          const int* __restrict__ bucket_table,
                                          __nv_bfloat16* __restrict__ out,
                                          float* __restrict__ lse, int Lq, int kv_len, int H,
                                          int max_distance) {
  using namespace hopper;
  static_assert(D % 64 == 0, "a tile is D / 64 boxes of 64 columns");
  constexpr int BOXES = D / 64;
  constexpr int TILE_BYTES = BOXES * BOX_BYTES;
  constexpr int RING_TILES = ring_tiles(ROUTE);
  constexpr bool kTable = has_bias(MODE) && VARIANT != NOBIAS && VARIANT != MATMULONLY;
  constexpr bool kCausal = is_causal(MODE);
  constexpr bool kLseOnly = ROUTE == LONG_LSE;
  constexpr bool kSoftmax = VARIANT != NOSOFTMAX && VARIANT != MATMULONLY;
  const int Lk = MODE == CROSS ? kv_len : Lq;
  const int nrel = kTable ? 2 * max_distance + 1 : 0;

  // Warpgroup wg takes key tiles wg, wg + WGS, ...: its own rings,
  // barriers and softmax state; they merge at the end.
  constexpr int WGS = warpgroups(MODE, ROUTE);
  // The index read from lane 0 is warp-uniform to the compiler: a wgmma on
  // a path it thinks divergent is serialized (ptxas C7520).
  const int wg = WGS == 1 ? 0 : __shfl_sync(0xffffffffu, threadIdx.x / WG_THREADS, 0);
  const int tid = threadIdx.x % WG_THREADS;
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* k_ring = qs + (1 + wg * RING_TILES) * TILE_BYTES;
  unsigned char* v_ring = k_ring + STAGES * TILE_BYTES;  // not on the LSE sweep
  // Q's barrier, then per warpgroup its K stages' and its V stages'.
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(qs + (1 + WGS * RING_TILES) * TILE_BYTES);
  uint64_t* bars = q_bar + 1 + wg * RING_TILES;
  uint32_t* key_bits = reinterpret_cast<uint32_t*>(q_bar + 1 + WGS * RING_TILES) + 6 * wg;
  float* bias = reinterpret_cast<float*>(q_bar + 1 + WGS * RING_TILES) + 6 * WGS;  // [nrel]

  // The causal grid's last query tiles see the most keys: run them first.
  const int q0 = (kCausal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane % 4);        // and its columns c0 + 8 j + {0, 1}
  const int k_end = kCausal ? min(Lk, q0 + BQ) : Lk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int n_mine = (n_tiles - wg + WGS - 1) / WGS;  // this warpgroup's tiles
  const long mask_base = (long)b * Lk;

  // This warpgroup's i-th tile is key tile WGS i + wg; its K goes to K stage
  // i % STAGES and its V to V stage i % STAGES, and the parity of
  // i / STAGES is the phase their barriers complete (two rings, so that
  // P V waits only for V).
  auto load_tile = [&](const CUtensorMap* map, unsigned char* ring, uint64_t* ring_bars, int i) {
    uint64_t* bar = &ring_bars[i % STAGES];
    unsigned char* dst = ring + (i % STAGES) * TILE_BYTES;
    mbar_expect_tx(bar, TILE_BYTES);
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
      tma_load_3d(dst + c * BOX_BYTES, map, bar, h * D + c * 64, (WGS * i + wg) * BK, b);
  };
  auto load_k = [&](int i) { load_tile(tmap_k, k_ring, bars, i); };
  auto load_v = [&](int i) { load_tile(tmap_v, v_ring, bars + STAGES, i); };
  // Warps 0 and 1 of the warpgroup: whether key tid of its i-th tile is
  // valid; the bits go to slot i % 3 (one 32-bit word per warp), written
  // two tiles ahead of their use (the global load is issued a tile before
  // the ballot that needs it).
  auto key_ok = [&](int i) {
    const int kj = (WGS * i + wg) * BK + tid;
    return i < n_mine && kj < Lk && mask[mask_base + kj] != 0;
  };
  auto store_key_bits = [&](int i, bool ok) {
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) key_bits[2 * (i % 3) + warp] = bits;
  };
  // The warpgroup's own barrier (with two, named barrier 1 + wg).
  auto sync_wg = [&]() {
    if constexpr (WGS == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(WG_THREADS));
  };

  if (threadIdx.x == 0) {
    prefetch_map(tmap_q);
    prefetch_map(tmap_k);
    if constexpr (!kLseOnly) prefetch_map(tmap_v);
#pragma unroll
    for (int s = 0; s <= WGS * RING_TILES; ++s) mbar_init(&q_bar[s], 1);
    fence_mbar_init();
  }
  if constexpr (kTable) load_bias(bias, rel_bias, bucket_table, nrel, H, h, threadIdx.x, WGS * WG_THREADS);
  if (tid < BK) {
    store_key_bits(0, key_ok(0));
    store_key_bits(1, key_ok(1));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, BOXES * BOX_BYTES);
#pragma unroll
    for (int c = 0; c < BOXES; ++c)
      tma_load_3d(qs + c * BOX_BYTES, tmap_q, q_bar, h * D + c * 64, q0, b);
  }
  if (tid == 0) {
    for (int i = 0; i < STAGES && i < n_mine; ++i) {
      load_k(i);
      if constexpr (!kLseOnly) load_v(i);
    }
  }

  float o[BOXES][32];
#pragma unroll
  for (int c = 0; c < BOXES; ++c) {
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
    fence_operands(o[c]);  // zeroed here, not inside the first product's window
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sc[32];       // S of the current key tile
  uint32_t pa[4][4];  // its P, bf16 pairs

  // The shared-memory descriptors of the Q tile and of the first K and V
  // stages; a tile, box or k16 slice is a byte offset from them.
  const uint64_t dq = desc_sw128(qs, 16, GROUP_BYTES);
  const uint64_t dk = desc_sw128(k_ring, 16, GROUP_BYTES);
  const uint64_t dv = desc_sw128(v_ring, GROUP_BYTES, GROUP_BYTES);
  // S = Q K^T of this warpgroup's i-th tile into sc, k16 slices along the
  // head width (after a wgmma_fence; the caller commits).
  auto issue_scores = [&](int i) {
    mbar_wait(&bars[i % STAGES], (i / STAGES) % 2);
    __syncwarp();
    const uint32_t k_off = (i % STAGES) * TILE_BYTES;
    wgmma_64x64x16_ss_first(sc, dq, desc_advance(dk, k_off));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_64x64x16_ss(sc, desc_advance(dq, off), desc_advance(dk, k_off + off));
    }
  };
  // The epilogue of this warpgroup's i-th tile, from its scores sc: bias,
  // key mask, causal cut, and the online softmax; x then holds p
  // (NOSOFTMAX / MATMULONLY: the scaled score), m and l are updated, and
  // scale[row] is what the row's accumulators take before the tile's P V.
  auto softmax = [&](int i, float (&x)[32], float (&scale)[2]) {
    const int k0 = (WGS * i + wg) * BK;
    // sc is only read: a register of a product's accumulators that another
    // instruction writes makes the assembler serialize every product.
#pragma unroll
    for (int r = 0; r < 32; ++r) x[r] = sc[r];
    const uint32_t w0 = key_bits[2 * (i % 3)], w1 = key_bits[2 * (i % 3) + 1];
    // This thread's valid-key bits: bit 8 j + e for column c0 + 8 j + e.
    const uint64_t kb = ((uint64_t)w1 << 32 | w0) >> c0;
    const bool all_keys = (w0 & w1) == 0xffffffffu;
    float tile_bias = 0.f;
    if constexpr (kTable)
      tile_bias = add_near_bias<VARIANT>(x, bias, q0, k0, Lq, Lk, r0, c0, max_distance);
    scale[0] = scale[1] = 1.f;
    if constexpr (!kSoftmax) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float y = x[r] + tile_bias;
        if constexpr (VARIANT == NOSOFTMAX)
          if (!((kb >> (8 * (r / 4) + r % 2)) & 1)) y += NEG_INF_BIAS;
        x[r] = y * NO_SOFTMAX_SCALE;
      }
      return;
    }
    // Only the diagonal tile holds keys past a causal row.
    const bool diag = kCausal && k0 + BK > q0;
    if (diag || !all_keys) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        bool ok = (kb >> (8 * (r / 4) + r % 2)) & 1;
        if (diag) ok = ok && k0 + 8 * (r / 4) + c0 + r % 2 <= q0 + r0 + 8 * ((r / 2) % 2);
        x[r] = ok ? x[r] : -INFINITY;
      }
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int r = 0; r < 32; ++r) tmax[(r / 2) % 2] = fmaxf(tmax[(r / 2) % 2], x[r]);
    float shift[2];  // log2(e) (tile_bias - m): p = 2^(log2(e) x + shift)
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      // The quad of threads that shares a row.
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 1));
      tmax[row] = fmaxf(tmax[row], __shfl_xor_sync(0xffffffffu, tmax[row], 2));
      const float m_new = fmaxf(m[row], tmax[row] + tile_bias);
      // No valid key seen yet in this row: every p and the scale are 0.
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      scale[row] = ex2((m[row] - m_use) * LOG2E);
      shift[row] = (tile_bias - m_use) * LOG2E;
      m[row] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      x[r] = ex2(fmaf(x[r], LOG2E, shift[(r / 2) % 2]));
      psum[(r / 2) % 2] += x[r];
    }
    // l is this thread's share of the row sum until the end.
#pragma unroll
    for (int row = 0; row < 2; ++row) l[row] = l[row] * scale[row] + psum[row];
  };
  // P as the A operand of P V: the accumulator layout of a 16-key slice is
  // the A-register layout, rows r0 and r0 + 8.
  auto pack_p = [&](const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) pa[kk][t] = pack_bf16(x[8 * kk + 2 * t], x[8 * kk + 2 * t + 1]);
  };

  mbar_wait(q_bar, 0);
  __syncwarp();
  for (int j = 0; j < n_mine; ++j) {
    const bool next_ok = tid < BK && key_ok(j + 2);
    wgmma_fence();
    issue_scores(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(sc);
    float x[32], scale[2];
    softmax(j, x, scale);
    if constexpr (!kLseOnly) {
      // O += P V: P (bf16) is A from registers, 16 keys per slice; V is B,
      // MN-major, 16 rows of 128 bytes per slice. A row whose max did not
      // move keeps its accumulators as they are (its scale is exactly 1).
      if (kSoftmax && (scale[0] != 1.f || scale[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
#pragma unroll
          for (int r = 0; r < 32; ++r) o[c][r] *= scale[(r / 2) % 2];
      }
      pack_p(x);
      // The accumulators and P are final before the fence: a register
      // defined inside a product's window serializes every product.
#pragma unroll
      for (int c = 0; c < BOXES; ++c) fence_operands(o[c]);
      fence_operands(pa);
      wgmma_fence();
      mbar_wait(&bars[STAGES + j % STAGES], (j / STAGES) % 2);
      __syncwarp();
      const uint32_t v_off = (j % STAGES) * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          wgmma_64x64x16_rs_tb(o[c], pa[kk],
                               desc_advance(dv, v_off + c * BOX_BYTES + kk * 16 * ROW_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < BOXES; ++c) fence_operands(o[c]);
    }
    if (tid < BK) store_key_bits(j + 2, next_ok);
    // Every thread of the warpgroup is past its j-th tile's products: their
    // stages take its tile j + STAGES.
    sync_wg();
    if (tid == 0 && j + STAGES < n_mine) {
      load_k(j + STAGES);
      if constexpr (!kLseOnly) load_v(j + STAGES);
    }
  }

  if constexpr (kSoftmax) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
  if constexpr (WGS == 2) {
    // Warpgroup 1 hands its O, m and l to warpgroup 0 through its own
    // rings (idle now), register by register in the same layout, and
    // leaves.
    float* handoff = reinterpret_cast<float*>(qs + (1 + RING_TILES) * TILE_BYTES);
    constexpr int N_O = kLseOnly ? 0 : BOXES * 32;
    if (wg == 1) {
      if constexpr (!kLseOnly) {
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
#pragma unroll
          for (int r = 0; r < 32; ++r) handoff[(c * 32 + r) * WG_THREADS + tid] = o[c][r];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        handoff[(N_O + i) * WG_THREADS + tid] = m[i];
        handoff[(N_O + 2 + i) * WG_THREADS + tid] = l[i];
      }
    }
    __syncthreads();
    if (wg == 1) return;
    float a0[2] = {1.f, 1.f}, a1[2] = {1.f, 1.f};
    if constexpr (kSoftmax) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m1 = handoff[(N_O + i) * WG_THREADS + tid];
        const float l1 = handoff[(N_O + 2 + i) * WG_THREADS + tid];
        const float mt = fmaxf(m[i], m1);
        a0[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - mt) * LOG2E);
        a1[i] = m1 == -INFINITY ? 0.f : ex2((m1 - mt) * LOG2E);
        l[i] = l[i] * a0[i] + l1 * a1[i];
        m[i] = mt;
      }
    }
    if constexpr (!kLseOnly) {
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
#pragma unroll
        for (int r = 0; r < 32; ++r)
          o[c][r] = o[c][r] * a0[(r / 2) % 2] +
                    handoff[(c * 32 + r) * WG_THREADS + tid] * a1[(r / 2) % 2];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = q0 + r0 + 8 * i;
    if (qi >= Lq) continue;
    if constexpr (!kLseOnly) {
      const float inv = !kSoftmax ? 1.f : (l[i] > 0.f ? 1.f / l[i] : 0.f);
      __nv_bfloat16* dst = out + ((long)b * Lq + qi) * H * D + (long)h * D + c0;
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(dst + c * 64 + 8 * jj) = __floats2bfloat162_rn(
              o[c][4 * jj + 2 * i] * inv, o[c][4 * jj + 2 * i + 1] * inv);
    }
    // m and l are the same in the four threads of a row: one of them stores.
    if (kSoftmax && lse != nullptr && lane % 4 == 0)
      lse[((long)b * H + h) * Lq + qi] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

// One kernel name for both bodies (so profiled names parse alike across
// versions): bf16 runs the tensor-core body on one or two warpgroups, fp32
// the FMA body on 256 threads; the tensor maps are the bf16 body's (unread
// by fp32).
template <typename T, int MODE, int ROUTE, int D, int VARIANT>
__global__ void __launch_bounds__(fwd_threads<T, MODE, ROUTE>()) attn_fwd_kernel(
    const __grid_constant__ CUtensorMap tmap_q,  // bf16 q  [B, Lq, H*D]
    const __grid_constant__ CUtensorMap tmap_k,  // bf16 k  [B, Lk, H*D]
    const __grid_constant__ CUtensorMap tmap_v,  // bf16 v  [B, Lk, H*D] (not LONG_LSE)
    const T* __restrict__ q,               // [B, Lq, H*D]
    const T* __restrict__ k,               // [B, Lk, H*D]
    const T* __restrict__ v,               // [B, Lk, H*D] (unread by LONG_LSE)
    const int* __restrict__ mask,          // [B, Lk], nonzero = valid key
    const float* __restrict__ rel_bias,    // [num_buckets, H] (only ENCODER, CAUSAL_SELF)
    const int* __restrict__ bucket_table,  // [2*max_distance+1], by k - q + max_distance
    T* __restrict__ out,                   // [B, Lq, H*D] (null for LONG_LSE)
    float* __restrict__ lse,               // [B, H, Lq] or null (never null for LONG_LSE)
    int Lq, int kv_len, int H, int max_distance) {
  static_assert(VARIANT == FULL || (MODE == ENCODER && ROUTE == FULL_ROW && D == 64),
                "the ablation variants are of kernel 1 only");
  extern __shared__ __align__(16) unsigned char attn_smem[];
  if constexpr (on_tensor_cores<T>())
    fwd_wgmma<MODE, ROUTE, D, VARIANT>(attn_smem, &tmap_q, &tmap_k, &tmap_v, mask, rel_bias,
                                       bucket_table, out, lse, Lq, kv_len, H, max_distance);
  else
    fwd_fma<MODE, ROUTE, D, VARIANT>(reinterpret_cast<float*>(attn_smem), q, k, v, mask,
                                     rel_bias, bucket_table, out, lse, Lq, kv_len, H,
                                     max_distance);
}

template <typename T, int MODE, int ROUTE, int D, int VARIANT = FULL>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* rel_bias,
           const void* bucket_table, void* out, void* lse, int batch, int q_len, int kv_len,
           int num_heads, int max_distance, cudaStream_t stream) {
  constexpr bool kWg = on_tensor_cores<T>();
  const int nrel = bias_entries(MODE, max_distance);
  const size_t smem = kWg ? wg_shared_bytes(nrel, MODE, ROUTE, D) : shared_bytes(nrel, ROUTE, D);
  CUtensorMap maps[3] = {};
  if constexpr (kWg) {
    const int inner = num_heads * D;
    int err = hopper::make_tile_map(&maps[0], q, batch, q_len, inner);
    if (err == 0) err = hopper::make_tile_map(&maps[1], k, batch, kv_len, inner);
    if (err == 0 && ROUTE != LONG_LSE) err = hopper::make_tile_map(&maps[2], v, batch, kv_len, inner);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, MODE, ROUTE, D, VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((q_len + BQ - 1) / BQ, num_heads, batch);
  attn_fwd_kernel<T, MODE, ROUTE, D, VARIANT><<<grid, fwd_threads<T, MODE, ROUTE>(), smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(mask),
      static_cast<const float*>(rel_bias), static_cast<const int*>(bucket_table),
      static_cast<T*>(out), static_cast<float*>(lse), q_len, kv_len, num_heads, max_distance);
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
