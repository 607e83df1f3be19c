// The T5 block's elementwise chains as two fused kernels, for Hopper (sm_90a):
//
//   add_rms_norm   h_new  = bf16(h + delta)                       (delta optional)
//                  normed = bf16(x * rsqrt(mean(x^2) + eps) * w),  x = fp32(h_new)
//   gated_gelu     out    = bf16(gelu_tanh(fp32 gate) * fp32 up)
//
// Replaces no Pallas kernel of reprover_tpu/: XLA fuses these chains on the
// TPU. Eagerly, reprover_tpu_torch/models/t5.py's rms_norm is a chain of
// fp32 kernels (cast up, square, mean, rsqrt, two multiplies, cast down) and
// gelu_new eight bf16 kernels and a ninth for "* up", each a pass over
// device memory: about 40 bytes an element for a norm and its residual add,
// 42 for the gated GELU. Both functions do a few operations an element, far
// below the ~295 operations a byte where the card's arithmetic would be the
// limit, so bytes bound them and the design moves each byte once: 8 bytes
// an element for the add and the norm (read h and delta, write h_new and
// normed), 6 for the gated GELU (read gate and up, write out).
//
// add_rms_norm: one warp a row (d_model 1472 is 184 vectors of 16 bytes),
// the row held in registers as packed bf16 between the two passes, so it is
// read once. Each lane loads its VPL vectors of h and delta before it uses
// any (12 loads of 16 bytes in flight a lane at byt5-small's width), adds in
// fp32 and rounds once to bf16, which is what PyTorch's bf16 add does, so
// h_new is bit-equal to "h + delta". The sum of squares is taken from the
// rounded h_new in fp32 and reduced over the warp by shuffles; the weight
// is read as float4s (it stays in the L1/L2). The same order of operations
// as the plain chain, x * rsqrt(...) then * w, with one rounding at the end.
//
// gated_gelu: one warp a row at a time, rows dealt to the warps of the grid
// in turn (grid-stride), 16-byte vectors of gate and up read from rows of
// any stride (the two halves of the fused wi product [N, 2 d_ff] are read in
// place), output contiguous. GELU's tanh form is computed in fp32 as
// x * sigmoid(2 y) = x / (1 + exp(-2 y)), y = sqrt(2/pi) (x + 0.044715 x^3):
// 0.5 (1 + tanh(y)) and sigmoid(2 y) are the same function, and this form has
// no cancellation where tanh(y) nears -1. __expf and __fdividef err by a few
// parts in a million, far below bf16's step of 2^-8; one rounding at the
// end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NORM_WARPS = 4;  // rows a block of add_rms_norm
constexpr int GELU_WARPS = 8;  // warps a block of gated_gelu

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// VPL: 16-byte vectors a lane holds (cols <= 256 * VPL).
template <int VPL>
__global__ void __launch_bounds__(NORM_WARPS * 32)
    add_rms_norm_kernel(const __nv_bfloat16* __restrict__ h, long long h_stride,
                        const __nv_bfloat16* __restrict__ delta, long long delta_stride,
                        const float* __restrict__ weight, __nv_bfloat16* __restrict__ h_out,
                        __nv_bfloat16* __restrict__ normed, long long rows, int cols,
                        float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * NORM_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = cols >> 3;
  const uint4* hp = reinterpret_cast<const uint4*>(h + row * h_stride);
  uint4 x[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    x[i] = v < nvec ? hp[v] : make_uint4(0u, 0u, 0u, 0u);
  }
  if (delta != nullptr) {
    const uint4* dp = reinterpret_cast<const uint4*>(delta + row * delta_stride);
    uint4* op = reinterpret_cast<uint4*>(h_out + row * (long long)cols);
    uint4 y[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      y[i] = v < nvec ? dp[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        float a[8], b[8];
        unpack8(x[i], a);
        unpack8(y[i], b);
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] += b[j];
        x[i] = pack8(a);
        op[v] = x[i];
      }
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float a[8];
    unpack8(x[i], a);  // vectors past the row are zero
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += a[j] * a[j];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)cols + eps);
  const float4* wp = reinterpret_cast<const float4*>(weight);
  uint4* np = reinterpret_cast<uint4*>(normed + row * (long long)cols);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      float a[8];
      unpack8(x[i], a);
      const float4 w0 = wp[2 * v], w1 = wp[2 * v + 1];
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = a[j] * r * w[j];
      np[v] = pack8(a);
    }
  }
}

template <int VPL>
cudaError_t launch_norm(const void* h, long long h_stride, const void* delta,
                        long long delta_stride, const void* weight, void* h_out, void* normed,
                        long long rows, int cols, float eps, cudaStream_t stream) {
  const long long blocks = (rows + NORM_WARPS - 1) / NORM_WARPS;
  add_rms_norm_kernel<VPL><<<(unsigned)blocks, NORM_WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(h), h_stride,
      static_cast<const __nv_bfloat16*>(delta), delta_stride, static_cast<const float*>(weight),
      static_cast<__nv_bfloat16*>(h_out), static_cast<__nv_bfloat16*>(normed), rows, cols, eps);
  return cudaGetLastError();
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float y = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  // exp(-2y) past e^80 (x below about -5.6) changes nothing in bf16 and
  // keeps __fdividef's divisor finite.
  return __fdividef(x, 1.f + __expf(fminf(-2.f * y, 80.f)));
}

__global__ void __launch_bounds__(GELU_WARPS * 32)
    gated_gelu_kernel(const __nv_bfloat16* __restrict__ gate, long long gate_stride,
                      const __nv_bfloat16* __restrict__ up, long long up_stride,
                      __nv_bfloat16* __restrict__ out, long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int nvec = cols >> 3;
  const long long warps = (long long)gridDim.x * GELU_WARPS;
  for (long long row = (long long)blockIdx.x * GELU_WARPS + (threadIdx.x >> 5); row < rows;
       row += warps) {
    const uint4* gp = reinterpret_cast<const uint4*>(gate + row * gate_stride);
    const uint4* upp = reinterpret_cast<const uint4*>(up + row * up_stride);
    uint4* op = reinterpret_cast<uint4*>(out + row * (long long)cols);
#pragma unroll 2
    for (int v = lane; v < nvec; v += 32) {
      float g[8], u[8];
      unpack8(gp[v], g);
      unpack8(upp[v], u);
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j] = gelu_tanh(g[j]) * u[j];
      op[v] = pack8(g);
    }
  }
}

}  // namespace

extern "C" {

// h, delta: bf16 rows of `cols` elements, row i at h + i * h_stride (and
// delta + i * delta_stride); delta may be null (the plain norm; h_out is
// then not written). weight: cols fp32. h_out, normed: contiguous
// [rows, cols] bf16. cols a multiple of 8 and at most 4096, strides
// multiples of 8, every pointer 16-byte aligned. Returns a cudaError_t
// value; 0 is success.
int fused_add_rms_norm(const void* h, long long h_stride, const void* delta,
                       long long delta_stride, const void* weight, void* h_out, void* normed,
                       long long rows, int cols, float eps, void* stream) {
  if (cols <= 0 || cols % 8 != 0 || cols > 4096 || h_stride % 8 != 0 || delta_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int need = (cols / 8 + 31) / 32;
#define NORM(V) launch_norm<V>(h, h_stride, delta, delta_stride, weight, h_out, normed, rows, \
                               cols, eps, s)
  if (need <= 1) return (int)NORM(1);
  if (need <= 2) return (int)NORM(2);
  if (need <= 4) return (int)NORM(4);
  if (need <= 6) return (int)NORM(6);
  if (need <= 8) return (int)NORM(8);
  if (need <= 12) return (int)NORM(12);
  return (int)NORM(16);
#undef NORM
}

// gate, up: bf16 rows of `cols` elements at strides gate_stride and
// up_stride; out: contiguous [rows, cols] bf16. cols and the strides
// multiples of 8, every pointer 16-byte aligned. Returns a cudaError_t
// value; 0 is success.
int fused_gated_gelu(const void* gate, long long gate_stride, const void* up,
                     long long up_stride, void* out, long long rows, int cols, void* stream) {
  if (cols <= 0 || cols % 8 != 0 || gate_stride % 8 != 0 || up_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  // SMs of the current device, read once a device.
  static int sms_of[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int& sms = sms_of[device & 63];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  // Enough warps to fill every SM eight blocks deep, no more than the rows.
  const long long blocks_needed = (rows + GELU_WARPS - 1) / GELU_WARPS;
  const long long cap = (long long)sms * 8;
  const unsigned blocks = (unsigned)(blocks_needed < cap ? blocks_needed : cap);
  gated_gelu_kernel<<<blocks, GELU_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gate), gate_stride,
      static_cast<const __nv_bfloat16*>(up), up_stride, static_cast<__nv_bfloat16*>(out), rows,
      cols);
  return (int)cudaGetLastError();
}

}  // extern "C"
