// Weight-only quantized matrix products for Hopper (sm_90a): int8 (w8a16)
// and packed int4 (w4a16) weights against bf16 activations.
//
// Replaces the Pallas TPU kernels of reprover_tpu/ops/quant_matmul.py:
//
//   bits 8  _kernel (:28), behind quant_matmul (:59):
//           y[M, N] = (x[M, K] @ q[K, N]) * scale[N]
//           q is converted to bf16 in the kernel, the product accumulates in
//           fp32 and the per-channel scale is applied after it;
//   bits 4  _kernel4 (:136), behind quant4_matmul (:202):
//           y[M, N] = x[M, K] @ (unpack4(p[K/2, N]) * scale[K/group, N])
//           row 2i of the weight is the low nibble of packed row i, row 2i+1
//           the high one; each value is dequantized in fp32 with its group's
//           scale, rounded to bf16, then multiplied and accumulated in fp32
//           (the scale varies along K, so it cannot wait for the product).
//
// The output is bf16 or fp32 (the vocabulary projection keeps fp32 logits).
//
// What bounds it on the H100: at its design point, decode with M = S*K = 32
// rows, each weight byte is used 32 times, far below the ~295 operations per
// byte where the tensor cores become the limit: the weight stream is the
// bound (4096 x 11008 int8: 45 MB, about 13.5 us at 3.35 TB/s; int4 22.5 MB
// of nibbles and 1.4 MB of scales, about 7 us). Admission waves (M up to
// 2048) are compute-bound (2 * M * K * N operations at 989 TFLOP/s bf16).
// Design: one block of four warps per 64 x 64 output tile walks K in 64-deep
// tiles. Each thread stages its share of the next x tile and weight tile in
// registers (16-byte loads) while the warps multiply the current one, so a
// weight tile's load overlaps the previous tile's product. The weight tile is
// converted to bf16 on its way into shared memory (int8 as is, int4 unpacked
// and scaled), and each warp runs bf16 tensor-core fragments (nvcuda::wmma,
// 16 x 16 x 16, fp32 accumulators) over its 32 x 32 quarter. When the output
// has too few tiles to fill the card (decode), K is split over blockIdx.z:
// each split writes fp32 partial sums and a second kernel adds them, applies
// the int8 scale and rounds. No TMA, wgmma or deeper pipeline yet: right
// first, fast in a later change.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 64, THREADS = 128;
constexpr int APAD = BK + 8;  // row stride of the x tile in shared memory (bf16)
constexpr int BPAD = BN + 8;  // row stride of the weight tile (bf16)
constexpr int CPAD = BN + 4;  // row stride of the output tile (fp32)

struct Operands {
  const unsigned short* x;  // bf16 [M, K]
  const uint8_t* w;         // int8 [K, N], or packed uint8 [K/2, N]
  const float* scale;       // [N] (bits 8) or [K/group, N] (bits 4)
  void* out;                // [M, N] bf16 or fp32, or fp32 partials [splits, M, N]
  int M, N, K, group, k_chunk;
  bool x_vec, w_vec, out_f32, partial;
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
__device__ __forceinline__ void load_x(const Operands& op, int m0, int k0, int k_end,
                                       uint4 (&a)[4]) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32, m = m0 + r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + c0 + 8 * j;
    if (op.x_vec && m < op.M && k + 8 <= k_end) {
      a[j] = __ldg(reinterpret_cast<const uint4*>(op.x + (size_t)m * op.K + k));
    } else {
      Vec16 v;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v.h[e] = (m < op.M && k + e < k_end) ? op.x[(size_t)m * op.K + k + e] : 0;
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

__device__ __forceinline__ void load_w(const Operands& op, int n0, int k0, int k_end,
                                       Tile8& t) {
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32, k = k0 + r;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + c0 + 16 * j;
    if (op.w_vec && k < k_end && n + 16 <= op.N) {
      t.q[j] = __ldg(reinterpret_cast<const uint4*>(op.w + (size_t)k * op.N + n));
    } else {
      Vec16 v;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v.ub[e] = (k < k_end && n + e < op.N) ? op.w[(size_t)k * op.N + n + e] : 0;
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

__device__ __forceinline__ void load_w(const Operands& op, int n0, int k0, int k_end,
                                       Tile4& t) {
  const int pr = threadIdx.x >> 2, c0 = (threadIdx.x & 3) * 16;
  const int k = k0 + 2 * pr, n = n0 + c0;
  const bool rows_ok = k < k_end;
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
  const int k_begin = blockIdx.z * op.k_chunk;
  const int k_end = min(op.K, k_begin + op.k_chunk);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[4];
  Tile rb;
  if (k_begin < k_end) {
    load_x(op, m0, k_begin, k_end, ra);
    load_w(op, n0, k_begin, k_end, rb);
  }
  const __nv_bfloat16* as = reinterpret_cast<const __nv_bfloat16*>(As);
  const __nv_bfloat16* bs = reinterpret_cast<const __nv_bfloat16*>(Bs);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    store_x(As, ra);
    store_w(Bs, rb);
    __syncthreads();
    if (k0 + BK < k_end) {  // the next tile's loads fly while this one multiplies
      load_x(op, m0, k0 + BK, k_end, ra);
      load_w(op, n0, k0 + BK, k_end, rb);
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
  const size_t plane = (size_t)op.M * op.N;
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN, m = m0 + r, n = n0 + c;
    if (m >= op.M || n >= op.N) continue;
    float y = Cs[r * CPAD + c];
    const size_t o = (size_t)m * op.N + n;
    if (op.partial) {
      static_cast<float*>(op.out)[blockIdx.z * plane + o] = y;
      continue;
    }
    if (!INT4) y *= op.scale[n];
    if (op.out_f32)
      static_cast<float*>(op.out)[o] = y;
    else
      static_cast<unsigned short*>(op.out)[o] = to_bf16(y);
  }
}

// out = sum of the split partials (times the int8 scale), rounded.
__global__ void splitk_reduce_kernel(const float* __restrict__ partials,
                                     const float* __restrict__ scale, void* __restrict__ out,
                                     int M, int N, int splits, bool per_channel_scale,
                                     bool out_f32) {
  const size_t plane = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float y = 0.f;
  for (int z = 0; z < splits; ++z) y += partials[z * plane + i];
  if (per_channel_scale) y *= scale[i % N];
  if (out_f32)
    static_cast<float*>(out)[i] = y;
  else
    static_cast<unsigned short*>(out)[i] = to_bf16(y);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// bits 8: w is int8 [K, N], scale fp32 [N]; bits 4: w is uint8 [K/2, N] (two
// int4 values per byte along K, low nibble = even row), scale fp32
// [K/group, N], K and group even. x: bf16 [M, K]; out: [M, N], fp32 if
// out_f32 else bf16; all contiguous. splits > 1 splits K over that many
// blocks per output tile (fewer if K has fewer 64-deep tiles), which then
// need workspace: fp32 [splits, M, N]. Returns a cudaError_t value; 0 is
// success.
int quant_matmul_launch(int bits, const void* x, const void* w, const void* scale, void* out,
                        void* workspace, int M, int N, int K, int group, int splits,
                        int out_f32, void* stream) {
  if ((bits != 8 && bits != 4) || splits < 1 || M < 0 || N < 0 || K < 0)
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (K % 2 != 0 || group < 2 || group % 2 != 0 || K % group != 0))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int k_tiles = (K + BK - 1) / BK;
  splits = splits < k_tiles ? splits : (k_tiles > 0 ? k_tiles : 1);
  const int k_chunk = ((k_tiles + splits - 1) / splits) * BK;
  splits = k_chunk > 0 ? (K + k_chunk - 1) / k_chunk : 1;
  if (splits < 1) splits = 1;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Operands op;
  op.x = static_cast<const unsigned short*>(x);
  op.w = static_cast<const uint8_t*>(w);
  op.scale = static_cast<const float*>(scale);
  op.out = splits > 1 ? workspace : out;
  op.M = M;
  op.N = N;
  op.K = K;
  op.group = group;
  op.k_chunk = k_chunk > 0 ? k_chunk : BK;
  op.x_vec = K % 8 == 0 && aligned16(x);
  op.w_vec = N % 16 == 0 && aligned16(w) && (bits == 8 || aligned16(scale));
  op.out_f32 = out_f32 != 0;
  op.partial = splits > 1;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (bits == 8)
    quant_matmul_kernel<false><<<grid, THREADS, 0, s>>>(op);
  else
    quant_matmul_kernel<true><<<grid, THREADS, 0, s>>>(op);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t plane = (size_t)M * N;
  const int threads = 256;
  splitk_reduce_kernel<<<(unsigned)((plane + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float*>(workspace), static_cast<const float*>(scale), out, M, N, splits,
      bits == 8, out_f32 != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
