// T5 encoder self-attention forward for Hopper (sm_90a).
//
// Replaces reprover_tpu/ops/flash_attention.py::_encoder_attn_kernel (the
// Pallas TPU kernel behind encoder_flash_attention). Per batch row b and
// head h, on the flat [B, L, H*64] projection layout:
//
//   S = q_h k_h^T                       (unscaled: T5 has no 1/sqrt(d))
//   S += rel_bias[bucket(k - q), h]     (bidirectional T5 buckets)
//   drop key columns whose mask is 0
//   out_h = softmax(S) v_h              (exact, fp32; a row with no valid
//                                        key gives 0)
//
// What bounds it on the H100: the score work is 4*L*L*d operations per
// (b, h) against 4*L*d elements moved, so at L >= 256 it is compute-bound;
// the memory a naive version spends on the [B, H, L, L] fp32 score tensor
// (805 MB at B=8, L=2048) is what this kernel removes. Design: one block of
// 256 threads per (64-query tile, head, batch row) walks the keys in 64-key
// tiles with a running row max and row sum (online softmax), so nothing of
// size L*L leaves the SM. The Q, K, V and probability tiles sit in shared
// memory as fp32; each thread owns a 4x4 patch of the score tile and of the
// output and runs plain FMA loops (no tensor cores yet: right first, fast in
// a later change). The bias is read from a per-head table of 2*max_distance+1
// values built once per block from a bucket table that the caller computes
// with the plain bucket function, so no float log runs here and no bucket can
// flip at an exact boundary. The row max is taken over valid keys only.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 64;          // head width
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads, 4 x 4 outputs each
constexpr int PAD = D + 1;     // shared row stride: no bank conflicts on column reads
constexpr int PPAD = BK + 1;   // probability tile row stride

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

// Max and sum over the 16 threads that share a query row (one half-warp).
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

size_t shared_bytes(int max_distance) {
  return sizeof(float) * (size_t)(3 * BQ * PAD + BQ * PPAD + 2 * max_distance + 1) +
         sizeof(int) * BK;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) encoder_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ mask,          // [B, L], nonzero = valid key
    const float* __restrict__ rel_bias,    // [num_buckets, H]
    const int* __restrict__ bucket_table,  // [2*max_distance+1], by k - q + max_distance
    T* __restrict__ out, int L, int H, int max_distance) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][PAD]
  float* ks = qs + BQ * PAD;         // [BK][PAD]
  float* vs = ks + BK * PAD;         // [BK][PAD]
  float* ps = vs + BK * PAD;         // [BQ][PPAD]
  float* bias = ps + BQ * PPAD;      // [2*max_distance+1]
  int* key_ok = reinterpret_cast<int*>(bias + 2 * max_distance + 1);  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // columns tx, tx+16, tx+32, tx+48
  const long row_stride = (long)H * D;
  const long base = (long)b * L * row_stride + (long)h * D;
  const int nrel = 2 * max_distance + 1;

  for (int r = tid; r < nrel; r += THREADS) bias[r] = rel_bias[bucket_table[r] * H + h];
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, qi = q0 + r;
    qs[r * PAD + c] = qi < L ? to_float(q[base + (long)qi * row_stride + c]) : 0.f;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D, kj = k0 + r;
      const bool in = kj < L;
      const long off = base + (long)kj * row_stride + c;
      ks[r * PAD + c] = in ? to_float(k[off]) : 0.f;
      vs[r * PAD + c] = in ? to_float(v[off]) : 0.f;
    }
    if (tid < BK) {
      const int kj = k0 + tid;
      key_ok[tid] = kj < L && mask[(long)b * L + kj] != 0;
    }
    __syncthreads();

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
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        if (key_ok[kc]) {
          const int rel = min(max(k0 + kc - qi, -max_distance), max_distance);
          s[i][j] += bias[rel + max_distance];
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
        const float p = (any && key_ok[kc]) ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * PPAD + kc] = p;
        psum += p;
      }
      const float scale = any ? expf(m[i] - m_new) : 1.f;
      l[i] = l[i] * scale + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= scale;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * PPAD + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[kk * PAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < L) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[base + (long)qi * row_stride + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, const void* rel_bias,
           const void* bucket_table, void* out, int batch, int length, int num_heads,
           int max_distance, cudaStream_t stream) {
  const size_t smem = shared_bytes(max_distance);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((length + BQ - 1) / BQ, num_heads, batch);
  encoder_attn_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<const float*>(rel_bias),
      static_cast<const int*>(bucket_table), static_cast<T*>(out), length, num_heads,
      max_distance);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [batch, length, num_heads * 64], contiguous, fp32 (is_bf16 = 0)
// or bf16 (is_bf16 = 1). mask: int32 [batch, length]. rel_bias: fp32
// [num_buckets, num_heads]. bucket_table: int32 [2 * max_distance + 1].
// Returns a cudaError_t value; 0 is success.
int encoder_attn_forward(const void* q, const void* k, const void* v, const void* mask,
                         const void* rel_bias, const void* bucket_table, void* out, int batch,
                         int length, int num_heads, int max_distance, int is_bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, mask, rel_bias, bucket_table, out, batch, length,
                                 num_heads, max_distance, s);
  return launch<float>(q, k, v, mask, rel_bias, bucket_table, out, batch, length, num_heads,
                       max_distance, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
