// Weight-only quantized matrix products for Hopper (sm_90a): int8 (w8a16)
// and packed int4 (w4a16) weights against bf16 activations.
//
// Replaces the Pallas TPU kernels of reprover_tpu/ops/quant_matmul.py:
//
//   bits 8  _kernel (:28), behind quant_matmul (:59):
//           y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
//           q is converted exactly to bf16, the product accumulates in fp32
//           and the per-channel scale multiplies the fp32 result;
//   bits 4  _kernel4 (:136), behind quant4_matmul (:202):
//           y[M, N] = x[M, K] @ (unpack4(p[K/2, N]) * scale[K/group, N])
//           row 2i of the weight is the low nibble of packed row i, row 2i+1
//           the high one; each value is dequantized with its group's scale,
//           rounded to bf16, then multiplied and accumulated in fp32.
//
// The output is bf16 or fp32 (the vocabulary projection keeps fp32 logits).
//
// What bounds it on the H100. Decode (M <= 64 rows; LLaMA-7B serves M = 32)
// uses each weight byte at most 64 times, far below the ~295 operations per
// byte where the tensor cores become the limit: the weight stream is the
// bound (4096 x 11008 int8: 45 MB, 13.5 us at 3.35 TB/s; int4 22.5 MB and
// 1.4 MB of scales, 7 us). Admission waves (M = 2044) are compute-bound:
// 2 M K N operations at 989 TFLOP/s (4096 x 11008: 0.186 ms).
//
// Three bodies, chosen by the launcher from the plan it is given
// (ops/quant_matmul.py::quant_plan), each one launch per product:
//
//   decode     (body 1, quant_decode_kernel<BITS, NW>): M <= 64. The roles
//              swap: 64 output channels are wgmma's M and the activation
//              rows its N (NW = 32 or 64: M rounded up), so no tensor work
//              is padding. One warpgroup takes 128 channels (two m64
//              products) over a range of K. Packed weight tiles (128 bytes
//              of channels by 64 k, or by 32 packed rows) arrive by TMA,
//              with the x tile (K-major, B of the product) and, for int4,
//              the group scales, into a ring of three or four stages that one
//              thread refills. Each thread reads the weight bytes of its two
//              channels straight from shared memory into the A registers of
//              wgmma.m64nNWk16 (no bf16 copy of the weight passes through
//              shared memory): int4 pairs (k = 2i, 2i + 1) are one packed
//              byte, unpacked with a byte permute and a lop3 into two bf16
//              values 128 + (v ^ 8) and one bf16x2 subtract; int8 bytes go
//              through an fp32 magic number (2^23 + (v ^ 128)) and an fp32
//              subtract, exactly. K is split over blockIdx.z so that about
//              two blocks stream on every SM.
//   admission  (body 2, quant_admission_kernel<BITS>): M > 64. A 256 x 128
//              output tile per block of two warpgroups; x is A (TMA,
//              K-major, 128-byte swizzle), the weight is B, K-major bf16
//              in swizzled shared memory, written by both warpgroups from
//              the TMA'd int8/int4 tile (and the TMA'd int4 group scales)
//              while their wgmma.m64n128k16 products run on the previous
//              tile (B is double-buffered, the operands a four-stage ring).
//              Each weight tile is converted once per 256 rows of x.
//   simple     (body 0, quant_matmul_kernel<INT4>): the route for shapes a
//              tensor map cannot describe (a base not 16-byte aligned, an x
//              row or a weight row not a multiple of 16 bytes, an int4
//              group that is not a multiple of 16 or splits a 64-deep k
//              tile). One block of four warps per 64 x 64 output tile walks
//              K in 64-deep tiles staged through registers; the weight tile
//              is converted to bf16 on its way into shared memory and
//              multiplied with nvcuda::wmma.
//
// Rounding. The admission and simple bodies round exactly as the JAX
// kernels do (int4: fp32 nibble times fp32 scale, rounded to bf16). The
// decode body multiplies the exact bf16 nibble by the group scale rounded
// to bf16 (one bf16x2 multiply): its weight is bf16(v * bf16(scale)), not
// bf16(v * scale), at most one bf16 step away; the plain versions keep the
// JAX order, and tests/test_torch_quant_plan.py measures the difference.
//
// Split K (decode, and admission when its tiles are fewer than the SMs):
// every split writes its fp32 partial tile to an L2-resident workspace
// [splits, M, N]; an arrival counter per output tile (__threadfence, then
// atomicAdd) elects the last block of the tile, which sums the partials in
// split order (deterministic), applies the int8 scale, rounds, writes the
// output and resets the counter to zero, so the counters are zeroed once
// per device and stream and reused by every launch.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch; a plan it cannot run (a TMA
// body on an unaligned operand, missing workspace) is an error, never a
// silent change of body.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace nvcuda;

constexpr int KT = 64;  // k per tile, every body

// ------------------------------------------------------------ simple body

constexpr int BM = 64, BN = 64, BK = KT, THREADS = 128;
constexpr int APAD = BK + 8;  // row stride of the x tile in shared memory (bf16)
constexpr int BPAD = BN + 8;  // row stride of the weight tile (bf16)
constexpr int CPAD = BN + 4;  // row stride of the output tile (fp32)

struct Operands {
  const unsigned short* x;  // bf16 [M, K]
  const uint8_t* w;         // int8 [K, N], or packed uint8 [K/2, N]
  const float* scale;       // [N] (bits 8) or [K/group, N] (bits 4)
  void* out;                // [M, N] bf16 or fp32
  int M, N, K, group;
  bool x_vec, w_vec, out_f32;
};

union Vec16 {
  uint4 u;
  unsigned short h[8];
  int8_t b[16];
  uint8_t ub[16];
};

__device__ __forceinline__ unsigned short to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// x tile [BM, BK]: thread t owns row t/2, columns (t%2)*32 .. +32.
__device__ __forceinline__ void load_x(const Operands& op, int m0, int k0, uint4 (&a)[4]) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32, m = m0 + r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + c0 + 8 * j;
    if (op.x_vec && m < op.M && k + 8 <= op.K) {
      a[j] = __ldg(reinterpret_cast<const uint4*>(op.x + (size_t)m * op.K + k));
    } else {
      Vec16 v;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = (m < op.M && k + e < op.K) ? op.x[(size_t)m * op.K + k + e] : 0;
      a[j] = v.u;
    }
  }
}

__device__ __forceinline__ void store_x(unsigned short* as, const uint4 (&a)[4]) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) *reinterpret_cast<uint4*>(as + r * APAD + c0 + 8 * j) = a[j];
}

// int8 weight tile [BK, BN]: thread t owns row t/2, columns (t%2)*32 .. +32.
struct Tile8 {
  uint4 q[2];
};

__device__ __forceinline__ void load_w(const Operands& op, int n0, int k0, Tile8& t) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32, k = k0 + r;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + c0 + 16 * j;
    if (op.w_vec && k < op.K && n + 16 <= op.N) {
      t.q[j] = __ldg(reinterpret_cast<const uint4*>(op.w + (size_t)k * op.N + n));
    } else {
      Vec16 v;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v.ub[e] = (k < op.K && n + e < op.N) ? op.w[(size_t)k * op.N + n + e] : 0;
      t.q[j] = v.u;
    }
  }
}

__device__ __forceinline__ void store_w(unsigned short* bs, const Tile8& t) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    Vec16 in, lo, hi;
    in.u = t.q[j];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lo.h[e] = to_bf16((float)in.b[e]);
      hi.h[e] = to_bf16((float)in.b[8 + e]);
    }
    *reinterpret_cast<uint4*>(bs + r * BPAD + c0 + 16 * j) = lo.u;
    *reinterpret_cast<uint4*>(bs + r * BPAD + c0 + 16 * j + 8) = hi.u;
  }
}

// int4 weight tile [BK, BN] from packed rows [BK/2, BN]: thread t owns packed
// row t/4 (weight rows 2(t/4) and 2(t/4)+1), columns (t%4)*16 .. +16, and the
// 16 scales of its group row (group is even, so both rows share one).
struct Tile4 {
  uint4 p;
  float s[16];
};

__device__ __forceinline__ void load_w(const Operands& op, int n0, int k0, Tile4& t) {
  const int pr = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  const int k = k0 + 2 * pr, n = n0 + c0;
  const bool rows_ok = k < op.K;
  const float* srow = op.scale + (size_t)(rows_ok ? k / op.group : 0) * op.N;
  if (op.w_vec && rows_ok && n + 16 <= op.N) {
    t.p = __ldg(reinterpret_cast<const uint4*>(op.w + (size_t)(k / 2) * op.N + n));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(srow + n + 4 * j));
      t.s[4 * j] = f.x;
      t.s[4 * j + 1] = f.y;
      t.s[4 * j + 2] = f.z;
      t.s[4 * j + 3] = f.w;
    }
  } else {
    Vec16 v;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const bool ok = rows_ok && n + e < op.N;
      v.ub[e] = ok ? op.w[(size_t)(k / 2) * op.N + n + e] : 0;
      t.s[e] = ok ? srow[n + e] : 0.f;
    }
    t.p = v.u;
  }
}

__device__ __forceinline__ void store_w(unsigned short* bs, const Tile4& t) {
  const int pr = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  Vec16 in;
  in.u = t.p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    Vec16 even, odd;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int byte = in.ub[8 * half + e];
      const float s = t.s[8 * half + e];
      even.h[e] = to_bf16((float)(((byte & 15) ^ 8) - 8) * s);
      odd.h[e] = to_bf16((float)(((byte >> 4) ^ 8) - 8) * s);
    }
    *reinterpret_cast<uint4*>(bs + (2 * pr) * BPAD + c0 + 8 * half) = even.u;
    *reinterpret_cast<uint4*>(bs + (2 * pr + 1) * BPAD + c0 + 8 * half) = odd.u;
  }
}

template <bool INT4>
__global__ void __launch_bounds__(THREADS) quant_matmul_kernel(Operands op) {
  using Tile = typename std::conditional<INT4, Tile4, Tile8>::type;
  __shared__ __align__(128) unsigned short As[BM * APAD];
  __shared__ __align__(128) unsigned short Bs[BK * BPAD];
  __shared__ __align__(128) float Cs[BM * CPAD];
  const int warp = threadIdx.x >> 5, wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[4];
  Tile rb;
  if (op.K > 0) {
    load_x(op, m0, 0, ra);
    load_w(op, n0, 0, rb);
  }
  const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(As);
  const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(Bs);
  for (int k0 = 0; k0 < op.K; k0 += BK) {
    store_x(As, ra);
    store_w(Bs, rb);
    __syncthreads();
    if (k0 + BK < op.K) {  // the next tile's loads fly while this one multiplies
      load_x(op, m0, k0 + BK, ra);
      load_w(op, n0, k0 + BK, rb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * APAD + kk, APAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * BPAD + wn * 32 + j * 16, BPAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * CPAD + wn * 32 + j * 16, acc[i][j],
                              CPAD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m >= op.M || n >= op.N) continue;
    float y = Cs[r * CPAD + c];
    const size_t o = (size_t)m * op.N + n;
    if (!INT4) y *= op.scale[n];
    if (op.out_f32)
      static_cast<float*>(op.out)[o] = y;
    else
      static_cast<unsigned short*>(op.out)[o] = to_bf16(y);
  }
}

// ------------------------------------------------- shared by the TMA bodies

// The operands the TMA bodies read outside their tensor maps.
struct QArgs {
  const float* scale;  // int8: [N], applied to the fp32 sums (int4: unread)
  void* out;           // [M, N] bf16 or fp32
  float* ws;           // fp32 [splits, M, N] partial sums (splits > 1)
  unsigned* counters;  // one arrival counter per output tile, zero between launches
  int M, N, K, group, tiles_per_split, out_f32;
};

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  __nv_bfloat162 r;
  memcpy(&r, &v, 4);
  return r;
}

// One int8 value (byte b of `flipped`, whose sign bits are flipped, and sel
// = 0x7440 | b) as an exact fp32: the byte is the low byte of the fp32 2^23 +
// (v + 128), and one subtract leaves v.
__device__ __forceinline__ float int8_to_f32(uint32_t flipped, uint32_t sel) {
  return __uint_as_float(__byte_perm(flipped, 0x4B000000u, sel)) - 8388736.f;  // 2^23 + 128
}

// Two exact fp32 values as a bf16 pair (a in the low half): their upper
// halves, since an int8 value needs no more than bf16's 8 bits.
__device__ __forceinline__ uint32_t upper_halves(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// Four int8 values (the bytes of u) as two exact bf16 pairs: (b0, b1) and
// (b2, b3).
__device__ __forceinline__ void int8x4_to_bf16(uint32_t u, uint32_t& lo, uint32_t& hi) {
  u ^= 0x80808080u;
  lo = upper_halves(int8_to_f32(u, 0x7440), int8_to_f32(u, 0x7441));
  hi = upper_halves(int8_to_f32(u, 0x7442), int8_to_f32(u, 0x7443));
}

// A signed nibble (bits 0-3 of x) as an exact fp32: 2^23 + (v ^ 8), less
// 2^23 + 8.
__device__ __forceinline__ float nibble_to_f32(uint32_t x) {
  return __uint_as_float((x & 0xFu) ^ 0x4B000008u) - 8388616.f;
}

// Packed byte J of u as the exact bf16 pair (low nibble, high nibble): v =
// u >> 4 holds the high nibble where u holds the low one; the permute puts
// the two in the low bits of each half, the lop3 makes 128 + (n ^ 8) in
// bf16, and one bf16x2 subtract of 136 leaves n.
template <int J>
__device__ __forceinline__ __nv_bfloat162 nibble_pair(uint32_t u, uint32_t v) {
  constexpr uint32_t SEL = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  const uint32_t t = (__byte_perm(u, v, SEL) & 0x000F000Fu) ^ 0x43084308u;
  return __hsub2(as_bf162(t), as_bf162(0x43084308u));
}

// (y0, y1) of output row m, columns n and n + 1 (n even, both < N): times
// the int8 scale, rounded to the output type.
__device__ __forceinline__ void store_pair(const QArgs& p, bool scaled, int m, int n, float y0,
                                           float y1) {
  if (scaled) {
    y0 *= p.scale[n];
    y1 *= p.scale[n + 1];
  }
  const size_t o = (size_t)m * p.N + n;
  if (p.out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) =
        __floats2bfloat162_rn(y0, y1);
}

__device__ __forceinline__ void store_partial(const QArgs& p, int m, int n, float y0, float y1) {
  const size_t o = ((size_t)blockIdx.z * p.M + m) * p.N + n;
  *reinterpret_cast<float2*>(p.ws + o) = make_float2(y0, y1);
}

// After every thread of the block stored its partial sums: the last block of
// this output tile to arrive sums the splits' partials in split order over
// rows [m0, m0 + rows) and columns [n0, n0 + cols), scales (int8), rounds
// and writes the output, and resets the tile's counter.
__device__ void finish_split(const QArgs& p, bool scaled, int m0, int rows, int n0, int cols) {
  __shared__ unsigned last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(&p.counters[tile], 1u) == gridDim.z - 1;
    if (last) p.counters[tile] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int r_end = min(rows, p.M - m0), quads = min(cols, p.N - n0) / 4, total = r_end * quads;
  const size_t plane = (size_t)p.M * p.N;
  // Four positions (4 consecutive columns each) per thread at a time, each
  // summed over the splits in order; the loads of four splits fly together.
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    size_t o[4];
    float4 sum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = min(base + u * (int)blockDim.x, total - 1);
      o[u] = (size_t)(m0 + idx / quads) * p.N + n0 + 4 * (idx % quads);
      sum[u] = __ldcg(reinterpret_cast<const float4*>(p.ws + o[u]));
    }
#pragma unroll 4
    for (int z = 1; z < (int)gridDim.z; ++z)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(p.ws + z * plane + o[u]));
        sum[u].x += t.x;
        sum[u].y += t.y;
        sum[u].z += t.z;
        sum[u].w += t.w;
      }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * (int)blockDim.x;
      if (idx >= total) break;
      const int m = m0 + idx / quads, n = n0 + 4 * (idx % quads);
      store_pair(p, scaled, m, n, sum[u].x, sum[u].y);
      store_pair(p, scaled, m, n + 2, sum[u].z, sum[u].w);
    }
  }
}

// The first row of the group scales of k tile kt (group a multiple of 16:
// a tile holds max(1, 64 / group) rows of them).
__device__ __forceinline__ int scale_row(int kt, int group) { return kt * KT / group; }

// ------------------------------------------------------------- decode body

constexpr int DEC_TN = 128;  // output channels per block: two m64 products
constexpr int DEC_THREADS = 128;
constexpr int SCALE_ROWS_MAX = KT / 16;  // group scales per k tile at group 16

template <int BITS, int NW>
struct DecodeCfg {
  static constexpr int RAW = BITS == 8 ? KT * DEC_TN : KT / 2 * DEC_TN;  // weight bytes
  static constexpr int X = NW * KT * 2;                                  // bf16 x tile
  static constexpr int SC = BITS == 4 ? SCALE_ROWS_MAX * DEC_TN * 4 : 0;  // fp32 scales
  static constexpr int STAGE = RAW + X + SC;  // a multiple of 1024
  static constexpr int STAGES = 48 * 1024 / STAGE;  // 3 or 4: four blocks fit an SM
  static constexpr int SMEM = 1024 + STAGES * STAGE + STAGES * 8;
};

template <int NW>
__device__ __forceinline__ void wgmma_dec(float (&d)[NW / 2], const uint32_t (&a)[4],
                                          uint64_t desc_x) {
  if constexpr (NW == 32)
    hopper::wgmma_64x32x16_rs(d, a, desc_x);
  else
    hopper::wgmma_64x64x16_rs(d, a, desc_x);
}

// y^T[channels, rows] = W^T x^T over k tiles [kt0, kt0 + count) of 128
// channels from n0. acc[s][r] (product s: channels n0 + 64 s + ...) holds
// channel n0 + 64 s + 16 warp + 2 g + (r / 2) % 2 and x row 8 (r / 4) +
// 2 c + r % 2, with g = lane / 4 and c = lane % 4: the A rows r0 = 16 warp +
// g and r0 + 8 of a product are the adjacent channels 2 g and 2 g + 1 of
// its warp's 16, so one 16-bit word of a weight row holds both.
template <int BITS, int NW>
__global__ void __launch_bounds__(DEC_THREADS) quant_decode_kernel(
    const __grid_constant__ CUtensorMap tmap_x,  // bf16 x [M, K], boxes [NW, 64]
    const __grid_constant__ CUtensorMap tmap_w,  // uint8 [K or K/2, N], boxes [64 or 32, 128]
    const __grid_constant__ CUtensorMap tmap_s,  // fp32 scales [K/group, N] (int4)
    const QArgs p) {
  using C = DecodeCfg<BITS, NW>;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  unsigned char* ring = hopper::align_1024(dec_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
  const int n0 = blockIdx.x * DEC_TN;
  const int k_tiles = (p.K + KT - 1) / KT;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int count = min(k_tiles, kt0 + p.tiles_per_split) - kt0;
  const int scale_rows = p.group >= KT ? 1 : KT / p.group;
  const uint32_t stage_tx = C::RAW + C::X + (BITS == 4 ? scale_rows * DEC_TN * 4 : 0);

  auto load = [&](int i) {
    uint64_t* bar = &full[i % C::STAGES];
    unsigned char* dst = ring + (i % C::STAGES) * C::STAGE;
    const int kt = kt0 + i;
    hopper::mbar_expect_tx(bar, stage_tx);
    hopper::tma_load_2d(dst, &tmap_w, bar, n0, kt * (BITS == 8 ? KT : KT / 2));
    hopper::tma_load_2d(dst + C::RAW, &tmap_x, bar, kt * KT, 0);
    if constexpr (BITS == 4)
      hopper::tma_load_2d(dst + C::RAW + C::X, &tmap_s, bar, n0, scale_row(kt, p.group));
  };
  if (tid == 0) {
    hopper::prefetch_map(&tmap_x);
    hopper::prefetch_map(&tmap_w);
    if constexpr (BITS == 4) hopper::prefetch_map(&tmap_s);
    for (int s = 0; s < C::STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < C::STAGES && i < count; ++i) load(i);

  float acc[2][NW / 2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[s][r] = 0.f;
    hopper::fence_operands(acc[s]);  // zeroed here, not inside the first product's window
  }
  // The scale row of k16 slice kk inside a stage (int4).
  int srow[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) srow[kk] = p.group >= KT ? 0 : 16 * kk / p.group;
  const bool whole_group = p.group >= KT;

  // The 16-bit word of weight row `row` holding this thread's two channels
  // of product s: swizzle chunk 4 s + warp of the 128-byte row, byte 2 g.
  auto word = [&](const unsigned char* raw, int row, int s) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(raw + row * 128 +
                                              (((4 * s + warp) ^ (row & 7)) << 4) + 2 * g);
  };

  // k tile i's A operands (waited for) into `dst`: product s, k16 slice kk,
  // four bf16 pairs.
  auto convert = [&](int i, uint32_t (&dst)[2][4][4]) {
    const int st = i % C::STAGES;
    const unsigned char* raw = ring + st * C::STAGE;
    hopper::mbar_wait(&full[st], (i / C::STAGES) & 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      __nv_bfloat162 s0, s1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (BITS == 4) {
          // Packed rows 8 kk + c (k = 16 kk + 2 c, +1) and 8 kk + 4 + c.
          const uint32_t u = __byte_perm(word(raw, 8 * kk + c, s), word(raw, 8 * kk + 4 + c, s),
                                         0x5410);
          const uint32_t v = u >> 4;
          // The two channels' group scales, rounded to bf16 (one group row
          // per tile unless the group is shorter than the tile).
          if (kk == 0 || !whole_group) {
            const float2 sc = *reinterpret_cast<const float2*>(
                reinterpret_cast<const float*>(raw + C::RAW + C::X) + srow[kk] * DEC_TN +
                64 * s + 16 * warp + 2 * g);
            s0 = __float2bfloat162_rn(sc.x);
            s1 = __float2bfloat162_rn(sc.y);
          }
          dst[s][kk][0] = as_u32(__hmul2(nibble_pair<0>(u, v), s0));
          dst[s][kk][1] = as_u32(__hmul2(nibble_pair<1>(u, v), s1));
          dst[s][kk][2] = as_u32(__hmul2(nibble_pair<2>(u, v), s0));
          dst[s][kk][3] = as_u32(__hmul2(nibble_pair<3>(u, v), s1));
        } else {
          // Rows k = 16 kk + 2 c, +1 (pairs 0, 1) and + 8, + 9 (pairs 2, 3).
          const int k = 16 * kk + 2 * c;
          int8x4_to_bf16(__byte_perm(word(raw, k, s), word(raw, k + 1, s), 0x5140),
                         dst[s][kk][0], dst[s][kk][1]);
          int8x4_to_bf16(__byte_perm(word(raw, k + 8, s), word(raw, k + 9, s), 0x5140),
                         dst[s][kk][2], dst[s][kk][3]);
        }
      }
    }
  };
  // Tile i's products on `cur`, beside the conversion of tile i + 1 into
  // `nxt`: the two A buffers alternate, so no register a product reads is
  // defined inside its window (ptxas C7515 would serialize every product).
  auto step = [&](int i, uint32_t (&cur)[2][4][4], uint32_t (&nxt)[2][4][4]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      hopper::fence_operands(cur[s]);
      hopper::fence_operands(acc[s]);
    }
    hopper::wgmma_fence();
    const uint64_t dx =
        hopper::desc_sw128(ring + (i % C::STAGES) * C::STAGE + C::RAW, 16, hopper::GROUP_BYTES);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_dec<NW>(acc[s], cur[s][kk], hopper::desc_advance(dx, kk * 32));
    hopper::wgmma_commit();
    if (i + 1 < count) convert(i + 1, nxt);
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < 2; ++s) hopper::fence_operands(acc[s]);
    // Every thread is past tile i's products: its stage takes tile i + STAGES.
    __syncthreads();
    if (tid == 0 && i + C::STAGES < count) load(i + C::STAGES);
  };

  uint32_t a0[2][4][4], a1[2][4][4];
  convert(0, a0);
  for (int i = 0; i < count; i += 2) {
    step(i, a0, a1);
    if (i + 1 < count) step(i + 1, a1, a0);
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int n = n0 + 64 * s + 16 * warp + 2 * g;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * j + 2 * c + e;
        if (m >= p.M || n >= p.N) continue;
        if (split)
          store_partial(p, m, n, acc[s][4 * j + e], acc[s][4 * j + 2 + e]);
        else
          store_pair(p, BITS == 8, m, n, acc[s][4 * j + e], acc[s][4 * j + 2 + e]);
      }
  }
  if (split) finish_split(p, BITS == 8, 0, NW, n0, DEC_TN);
}

// ---------------------------------------------------------- admission body

constexpr int ADM_TM = 256, ADM_TN = 128;  // output tile; each warpgroup 128 rows
constexpr int ADM_THREADS = 256;
constexpr int ADM_STAGES = 4;
constexpr int ADM_A = ADM_TM * KT * 2;  // bf16 x tile, 256 rows of 128 bytes
constexpr int ADM_B = ADM_TN * KT * 2;  // bf16 weight tile, 128 rows (channels) of 128 bytes
constexpr int ADM_BUFS = 2;  // B buffers: tile i's products, tile i + 1 converted

template <int BITS>
struct AdmitCfg {
  static constexpr int RAW = BITS == 8 ? KT * ADM_TN : KT / 2 * ADM_TN;
  static constexpr int SC = BITS == 4 ? SCALE_ROWS_MAX * ADM_TN * 4 : 0;
  static constexpr int STAGE = ADM_A + RAW + SC;  // a multiple of 1024
  static constexpr int SMEM = 1024 + ADM_STAGES * STAGE + ADM_BUFS * ADM_B + ADM_STAGES * 8;
};

// A [256 rows x 128 channels] tile over k tiles [kt0, kt0 + count):
// warpgroup w runs two m64n128k16 products per k16 slice, rows 128 w .. +64
// and +64 .. +128, on one B tile, so each weight tile is converted once per
// 256 rows of x. Both warpgroups convert k tile i + 1 into the other B
// buffer while their products run on tile i; one barrier per tile. Thread
// t converts channels 4 q .. 4 q + 3 (q = t % 32) at k chunk t / 32 (8 k):
// it reads 4-byte words of the raw rows and writes one 16-byte chunk (8 k
// of one channel, K-major) per channel; the channel order is rotated by
// (q / 2) % 4 so that the eight lanes of a store phase hit eight distinct
// chunks of the swizzle.
template <int BITS>
__global__ void __launch_bounds__(ADM_THREADS, 1) quant_admission_kernel(
    const __grid_constant__ CUtensorMap tmap_x,  // bf16 x [M, K], boxes [256, 64]
    const __grid_constant__ CUtensorMap tmap_w,  // uint8 [K or K/2, N], boxes [64 or 32, 128]
    const __grid_constant__ CUtensorMap tmap_s,  // fp32 scales [K/group, N] (int4)
    const QArgs p) {
  using C = AdmitCfg<BITS>;
  extern __shared__ __align__(16) unsigned char adm_smem[];
  unsigned char* ring = hopper::align_1024(adm_smem);
  unsigned char* bsm = ring + ADM_STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(bsm + ADM_BUFS * ADM_B);

  const int tid = threadIdx.x;
  // The warpgroup index, read from lane 0 so that the compiler sees it
  // warp-uniform (a product on a path it thinks divergent is serialized,
  // ptxas C7520).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int t = tid % 128, warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int m0 = blockIdx.y * ADM_TM, n0 = blockIdx.x * ADM_TN;
  const int k_tiles = (p.K + KT - 1) / KT;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int count = min(k_tiles, kt0 + p.tiles_per_split) - kt0;
  const int scale_rows = p.group >= KT ? 1 : KT / p.group;
  const uint32_t stage_tx = ADM_A + C::RAW + (BITS == 4 ? scale_rows * ADM_TN * 4 : 0);

  auto load = [&](int i) {
    uint64_t* bar = &full[i % ADM_STAGES];
    unsigned char* dst = ring + (i % ADM_STAGES) * C::STAGE;
    const int kt = kt0 + i;
    hopper::mbar_expect_tx(bar, stage_tx);
    hopper::tma_load_2d(dst, &tmap_x, bar, kt * KT, m0);
    hopper::tma_load_2d(dst + ADM_A, &tmap_w, bar, n0, kt * (BITS == 8 ? KT : KT / 2));
    if constexpr (BITS == 4)
      hopper::tma_load_2d(dst + ADM_A + C::RAW, &tmap_s, bar, n0, scale_row(kt, p.group));
  };
  if (tid == 0) {
    hopper::prefetch_map(&tmap_x);
    hopper::prefetch_map(&tmap_w);
    if constexpr (BITS == 4) hopper::prefetch_map(&tmap_s);
    for (int s = 0; s < ADM_STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < ADM_STAGES && i < count; ++i) load(i);

  const int q = tid % 32, kc = tid / 32, rot = (q >> 1) & 3;
  // The scale row of this thread's k chunk (k = 8 kc .. 8 kc + 7) inside a
  // stage (int4).
  const int srow = p.group >= KT ? 0 : 8 * kc / p.group;

  // k tile i's raw weight (waited for) into B buffer i % 2, K-major bf16.
  auto convert = [&](int i) {
    const int st = i % ADM_STAGES;
    const unsigned char* raw = ring + st * C::STAGE + ADM_A;
    unsigned char* bt = bsm + (i % ADM_BUFS) * ADM_B;
    hopper::mbar_wait(&full[st], (i / ADM_STAGES) & 1);
    if constexpr (BITS == 8) {
      uint32_t u[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        u[r] = *reinterpret_cast<const uint32_t*>(raw + (8 * kc + r) * ADM_TN + 4 * q) ^
               0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (j + rot) & 3, n = 4 * q + b;
        const uint32_t sel = 0x7440u | b;
        float f[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) f[r] = int8_to_f32(u[r], sel);
        *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n & 7)) << 4)) =
            make_uint4(upper_halves(f[0], f[1]), upper_halves(f[2], f[3]),
                       upper_halves(f[4], f[5]), upper_halves(f[6], f[7]));
      }
    } else {
      // Packed rows 4 kc .. 4 kc + 3 hold k = 8 kc .. 8 kc + 7: byte r of a
      // channel is the pair (k = 8 kc + 2 r, + 1), one K-major bf16 pair.
      uint32_t u[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        u[r] = *reinterpret_cast<const uint32_t*>(raw + (4 * kc + r) * ADM_TN + 4 * q);
      const float* sc = reinterpret_cast<const float*>(raw + C::RAW) + srow * ADM_TN;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int b = (j + rot) & 3, n = 4 * q + b;
        const float s = sc[n];
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t byte = u[r] >> (8 * b);
          w[r] = hopper::pack_bf16(nibble_to_f32(byte) * s, nibble_to_f32(byte >> 4) * s);
        }
        *reinterpret_cast<uint4*>(bt + n * 128 + ((kc ^ (n & 7)) << 4)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    hopper::fence_proxy_async();  // the stores are read next by wgmma
  };

  float acc[2][64];  // rows 128 wg + 64 j + ...: the m64n128 accumulator layout
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[j][r] = 0.f;
    hopper::fence_operands(acc[j]);
  }

  convert(0);
  __syncthreads();
  for (int i = 0; i < count; ++i) {
    const int st = i % ADM_STAGES;
    unsigned char* stage = ring + st * C::STAGE;
    hopper::mbar_wait(&full[st], (i / ADM_STAGES) & 1);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 2; ++j) hopper::fence_operands(acc[j]);
    hopper::wgmma_fence();
    const uint64_t da = hopper::desc_sw128(stage + wg * (ADM_A / 2), 16, hopper::GROUP_BYTES);
    const uint64_t db =
        hopper::desc_sw128(bsm + (i % ADM_BUFS) * ADM_B, 16, hopper::GROUP_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hopper::wgmma_64x128x16_ss(acc[j], hopper::desc_advance(da, j * 64 * 128 + kk * 32),
                                   hopper::desc_advance(db, kk * 32));
    hopper::wgmma_commit();
    if (i + 1 < count) convert(i + 1);  // beside the products, into the other B buffer
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 2; ++j) hopper::fence_operands(acc[j]);
    // Both warpgroups are past tile i's products and tile i + 1's
    // conversion: stage i takes tile i + STAGES.
    __syncthreads();
    if (tid == 0 && i + ADM_STAGES < count) load(i + ADM_STAGES);
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 128 * wg + 64 * j + 16 * warp + g + 8 * h;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int n = n0 + 8 * jj + 2 * c;
        if (m >= p.M || n >= p.N) continue;
        if (split)
          store_partial(p, m, n, acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
        else
          store_pair(p, BITS == 8, m, n, acc[j][4 * jj + 2 * h], acc[j][4 * jj + 2 * h + 1]);
      }
    }
  if (split) finish_split(p, BITS == 8, m0, ADM_TM, n0, ADM_TN);
}

// ----------------------------------------------------------------- launch

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BITS, int NW>
int launch_decode(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ms,
                  const QArgs& p, int splits, cudaStream_t stream) {
  using C = DecodeCfg<BITS, NW>;
  const cudaError_t err = cudaFuncSetAttribute(
      quant_decode_kernel<BITS, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + DEC_TN - 1) / DEC_TN, 1, splits);
  quant_decode_kernel<BITS, NW><<<grid, DEC_THREADS, C::SMEM, stream>>>(mx, mw, ms, p);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_admission(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& ms,
                     const QArgs& p, int splits, cudaStream_t stream) {
  using C = AdmitCfg<BITS>;
  const cudaError_t err = cudaFuncSetAttribute(
      quant_admission_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + ADM_TN - 1) / ADM_TN, (p.M + ADM_TM - 1) / ADM_TM, splits);
  quant_admission_kernel<BITS><<<grid, ADM_THREADS, C::SMEM, stream>>>(mx, mw, ms, p);
  return (int)cudaGetLastError();
}

int launch_simple(int bits, const void* x, const void* w, const void* scale, void* out, int M,
                  int N, int K, int group, int out_f32, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  Operands op;
  op.x = static_cast<const unsigned short*>(x);
  op.w = static_cast<const uint8_t*>(w);
  op.scale = static_cast<const float*>(scale);
  op.out = out;
  op.M = M;
  op.N = N;
  op.K = K;
  op.group = group;
  op.x_vec = K % 8 == 0 && aligned16(x);
  op.w_vec = N % 16 == 0 && aligned16(w) && (bits == 8 || aligned16(scale));
  op.out_f32 = out_f32 != 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (bits == 8)
    quant_matmul_kernel<false><<<grid, THREADS, 0, stream>>>(op);
  else
    quant_matmul_kernel<true><<<grid, THREADS, 0, stream>>>(op);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bits 8: w is int8 [K, N], scale fp32 [N]; bits 4: w is uint8 [K/2, N] (two
// int4 values per byte along K, low nibble = even row), scale fp32
// [K/group, N], K and group even. x: bf16 [M, K]; out: [M, N], fp32 if
// out_f32 else bf16; all contiguous. The plan (ops/quant_matmul.py::
// quant_plan): body 0 simple, 1 decode (M <= tile_m, tile_m 32 or 64), 2
// admission; bodies 1 and 2 split K into `splits` ranges of
// `tiles_per_split` 64-deep tiles (the last may be shorter, none empty),
// and with splits > 1 need workspace (fp32 [splits, M, N], of
// `workspace_bytes`) and counters (one uint32 per output tile, all zero;
// left zero). `out_tiles`, the plan's count of output tiles, must equal the
// grid's, so a tile size changed on one side only is an error. Bodies 1 and 2 need
// x, w and scale 16-byte aligned, K % 8 == 0, N % 16 == 0 and (bits 4) a
// group that is a multiple of 16 and divides 64 or is a multiple of it (a
// k tile lies in one group or holds whole ones). Returns a cudaError_t
// value; 0 is success.
int quant_matmul_launch(int bits, const void* x, const void* w, const void* scale, void* out,
                        void* workspace, void* counters, int M, int N, int K, int group,
                        int body, int tile_m, int splits, int tiles_per_split, int out_tiles,
                        long long workspace_bytes, int out_f32, void* stream) {
  if ((bits != 8 && bits != 4) || M < 0 || N < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (bits == 4 && (K % 2 != 0 || group < 2 || group % 2 != 0 || K % group != 0))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The caller's plan (ops/quant_matmul.quant_plan) sized the counters and
  // the workspace: it must name the grid launched here.
  const int grid_tiles = body == 0   ? ((M + BM - 1) / BM) * ((N + BN - 1) / BN)
                         : body == 1 ? (N + DEC_TN - 1) / DEC_TN
                                     : ((M + ADM_TM - 1) / ADM_TM) * ((N + ADM_TN - 1) / ADM_TN);
  if (out_tiles != grid_tiles) return (int)cudaErrorInvalidValue;
  if (body == 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_simple(bits, x, w, scale, out, M, N, K, group, out_f32, s);
  }
  if (body != 1 && body != 2) return (int)cudaErrorInvalidValue;
  const int k_tiles = (K + KT - 1) / KT;
  if (K == 0 || tiles_per_split < 1 || splits != (k_tiles + tiles_per_split - 1) / tiles_per_split)
    return (int)cudaErrorInvalidValue;
  if (splits > 1 && (workspace == nullptr || counters == nullptr ||
                     workspace_bytes < 4LL * splits * M * N))
    return (int)cudaErrorInvalidValue;
  if (body == 1 && !((tile_m == 32 || tile_m == 64) && M <= tile_m))
    return (int)cudaErrorInvalidValue;
  if (body == 2 && (M + ADM_TM - 1) / ADM_TM > 65535) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(scale) || K % 8 != 0 || N % 16 != 0 ||
      (bits == 4 && (group % 16 != 0 || (KT % group != 0 && group % KT != 0))))
    return (int)cudaErrorMisalignedAddress;

  const bool decode = body == 1;
  const int tn = decode ? DEC_TN : ADM_TN;
  CUtensorMap mx = {}, mw = {}, ms = {};
  int err = hopper::make_map_2d(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, KT,
                                decode ? tile_m : ADM_TM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = hopper::make_map_2d(&mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, bits == 8 ? K : K / 2, N,
                              tn, bits == 8 ? KT : KT / 2,
                              decode ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == 0 && bits == 4)
    err = hopper::make_map_2d(&ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group, 4LL * N,
                              tn, group >= KT ? 1 : KT / group, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != 0) return err;

  QArgs p;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.counters = static_cast<unsigned*>(counters);
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.tiles_per_split = tiles_per_split;
  p.out_f32 = out_f32 != 0;
  if (decode) {
    if (bits == 8)
      return tile_m == 32 ? launch_decode<8, 32>(mx, mw, ms, p, splits, s)
                          : launch_decode<8, 64>(mx, mw, ms, p, splits, s);
    return tile_m == 32 ? launch_decode<4, 32>(mx, mw, ms, p, splits, s)
                        : launch_decode<4, 64>(mx, mw, ms, p, splits, s);
  }
  return bits == 8 ? launch_admission<8>(mx, mw, ms, p, splits, s)
                   : launch_admission<4>(mx, mw, ms, p, splits, s);
}

}  // extern "C"
