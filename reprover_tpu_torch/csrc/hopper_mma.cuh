// Hopper (sm_90a) building blocks of the attention kernels: mbarriers, TMA
// tile loads through a tensor map, and warpgroup matrix products (wgmma) on
// bf16 tiles held in 128-byte-swizzled shared memory.
//
// A tile here is a [64][64] bf16 box: 64 rows of 128 bytes, written by one
// TMA load with CU_TENSOR_MAP_SWIZZLE_128B, so the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8). The swizzle repeats every 8 rows (1024 bytes),
// so a tile starts at a 1024-byte boundary and a wgmma descriptor names it
// with the matching layout type (128B) and the 1024-byte stride between
// 8-row groups.
//
// Tensor maps are encoded on the host (make_tile_map) by
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library links against the runtime alone (no
// -lcuda); they reach the kernel as __grid_constant__ parameters.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BOX = 64;                  // rows and bf16 columns of a box
constexpr int BOX_BYTES = BOX * BOX * 2;  // 8 KiB
constexpr int ROW_BYTES = BOX * 2;        // 128: one swizzle row
constexpr int GROUP_BYTES = 8 * ROW_BYTES;  // one 8-row swizzle atom

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                        cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous bf16 [batch, len, inner] tensor with [1, 64,
// 64] boxes and the 128-byte swizzle. Rows at or past len read as zeros (a
// 2-D map over [batch * len, inner] would read the next batch row's). The
// base must be 16-byte aligned and inner a multiple of 8. Returns a
// cudaError_t value.
inline int make_tile_map(CUtensorMap* map, const void* base, int batch, int len, int inner) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || inner % 8 != 0)
    return (int)cudaErrorMisalignedAddress;
  const cuuint64_t rows = len > 0 ? len : 1;  // an empty key side is never loaded
  const cuuint64_t dims[3] = {(cuuint64_t)inner, rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, rows * inner * 2};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` of TMA transactions in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a copy that was never issued) traps after 2^24 polls, so a
// fault in the ring shows as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 3-D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma descriptor of 128-byte-swizzled shared memory at `p`: start
// address, leading and stride byte offsets (in 16-byte units), layout type 1
// (128B swizzle). K-major operands (rows of 64 k values) advance along k by
// moving `p` 32 bytes per 16 values inside the swizzle row; the stride
// offset is the 1024 bytes between 8-row groups. An MN-major operand (rows
// of 64 n values, one row per k) steps 8 k rows by the same 1024 bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// The descriptor of the memory `bytes` past the one `desc` names (a
// multiple of 16; the address field is 14 bits of 16-byte units, all of
// shared memory).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running (groups finish
// in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register after wgmma.wait_group so the compiler moves none of its
// reads (accumulators) or writes (A operands) across the wait.
__device__ __forceinline__ void fence_operand(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(d[i]);
}
template <int M, int N>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) fence_operand(a[i][j]);
}

#define HOPPER_D32_STR                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

#define HOPPER_D32_OUT(d)                                                                  \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),      \
      "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]),           \
      "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]),        \
      "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),        \
      "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]),        \
      "=f"(d[31])

// d[64 x 64] += A[64 x 16] B[16 x 64], A and B K-major in shared memory,
// fp32 accumulators in the wgmma layout: register r of thread t holds row
// 16 * (t / 32) + (t % 32) / 4 + 8 * ((r / 2) % 2), column 8 * (r / 4) +
// 2 * (t % 4) + r % 2.
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D32(d)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The same with d = A B (the first slice of a product): d is only written,
// so its registers are free until the product starts.
__device__ __forceinline__ void wgmma_64x64x16_ss_first(float (&d)[32], uint64_t desc_a,
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D32_OUT(d)
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (four bf16 pairs per
// thread, the accumulator layout of a 16-column slice: rows r and r + 8,
// columns 2 (t % 4) and 8 + 2 (t % 4)), B MN-major in shared memory
// (transposed: one 128-byte row per k).
__device__ __forceinline__ void wgmma_64x64x16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef HOPPER_D32
#undef HOPPER_D32_OUT
#undef HOPPER_D32_STR

// Two fp32 values as one bf16 pair (lo in the low half), round to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 64-column tile in the accumulator layout as the A operand of a product
// over those columns: the accumulator layout of a 16-column slice is the
// A-register layout, so slice kk is four bf16 pairs (rows r0 and r0 + 8).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 0; t < 4; ++t) a[kk][t] = pack_bf16(x[8 * kk + 2 * t], x[8 * kk + 2 * t + 1]);
}

// The first 1024-byte boundary at or after p, where a swizzled tile starts.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

}  // namespace hopper
