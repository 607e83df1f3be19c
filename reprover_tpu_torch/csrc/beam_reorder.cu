// Beam-cache reorder with the fresh-column append, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of reprover_tpu/ops/beam_reorder.py:
// _reorder_kernel (:42), behind reorder_append_gather (:62).
//
// For the two per-beam decoder caches [L, S, K, H, T, d] of one decode step
// (keys and values), with parent_eff[s, k] = frozen[s] ? k : parent[s, k]:
//
//   out[l, s, k, h, t, :] = col[l, s, parent_eff, h, 0, :]    if t == pos[s]
//                           cache[l, s, parent_eff, h, t, :]  otherwise
//
// for t < t_live, the step bucket's length. Columns from t_live on are not
// touched: the engine never reads them in this chunk. The caches may be the
// t_live prefix of buffers of t_full columns; every offset comes from the
// full buffer's layout. The output must be a different buffer (a
// permutation cannot be done in place): the engine keeps a second cache
// buffer and swaps the two every step.
//
// What bounds it on the H100: it moves bytes and computes nothing. Each
// live byte of both caches is read once and written once: at the LLaMA-7B
// engine shape [32, 4, 8, 32, 129, 128] bf16 that is 4.33 GB, about 1.29 ms
// at 3.35 TB/s. Design: one block per (layer, slot, new beam) and head. The
// block reads its parent index from global memory (the card has no scalar
// prefetch) and copies the parent's t_live x d rows with 16-byte vector loads
// and stores, taking row pos[s] from the fresh column instead, so the column
// needs no second pass and no ordering between threads. The copy is of raw
// bytes, so the result is bit-equal to the plain version in any dtype whose
// row of d elements is a multiple of 16 bytes.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) reorder_append_kernel(
    const uint4* __restrict__ k_src,  // [L, S, K, H, t_full, row_vecs]
    const uint4* __restrict__ v_src,
    const uint4* __restrict__ k_col,  // [L, S, K, H, row_vecs]
    const uint4* __restrict__ v_col,
    uint4* __restrict__ k_out,        // [L, S, K, H, t_full, row_vecs]
    uint4* __restrict__ v_out,
    const int* __restrict__ parent,   // [S, K]
    const int* __restrict__ frozen,   // [S], nonzero = frozen slot
    const int* __restrict__ pos,      // [S]
    int S, int K, int H, int t_full, int t_live, int row_vecs) {
  const int h = blockIdx.y;
  const long long lsk = blockIdx.x;  // (l * S + s) * K + k
  const int k = (int)(lsk % K);
  const long long ls = lsk / K;      // l * S + s
  const int s = (int)(ls % S);
  const int p = frozen[s] ? k : parent[s * K + k];
  const int at = pos[s];
  const long long src_head = (ls * K + p) * H + h;
  const long long dst_head = lsk * H + h;
  const long long head_vecs = (long long)t_full * row_vecs;
  const uint4* ks = k_src + src_head * head_vecs;
  const uint4* vs = v_src + src_head * head_vecs;
  const uint4* kc = k_col + src_head * row_vecs;
  const uint4* vc = v_col + src_head * row_vecs;
  uint4* ko = k_out + dst_head * head_vecs;
  uint4* vo = v_out + dst_head * head_vecs;
  const int n = t_live * row_vecs;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int t = i / row_vecs;
    uint4 a, b;
    if (t == at) {
      const int j = i - t * row_vecs;
      a = kc[j];
      b = vc[j];
    } else {
      a = ks[i];
      b = vs[i];
    }
    ko[i] = a;
    vo[i] = b;
  }
}

}  // namespace

extern "C" {

// k_src, v_src, k_out, v_out: [L, S, K, H, t_full, d] contiguous buffers, of
// which the first t_live columns are read and written; k_col, v_col:
// [L, S, K, H, 1, d] contiguous; row_bytes = d * element size, a multiple of
// 16, and every pointer 16-byte aligned. parent: int32 [S, K] in [0, K);
// frozen, pos: int32 [S]. Returns a cudaError_t value; 0 is success.
int beam_reorder_append(const void* k_src, const void* v_src, const void* k_col,
                        const void* v_col, void* k_out, void* v_out, const void* parent,
                        const void* frozen, const void* pos, int L, int S, int K, int H,
                        int t_full, int t_live, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0 || t_live > t_full || H > 65535) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)L * S * K;
  if (blocks == 0 || H == 0 || t_live <= 0) return 0;
  const dim3 grid((unsigned)blocks, H);
  reorder_append_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_src), static_cast<const uint4*>(v_src),
      static_cast<const uint4*>(k_col), static_cast<const uint4*>(v_col),
      static_cast<uint4*>(k_out), static_cast<uint4*>(v_out), static_cast<const int*>(parent),
      static_cast<const int*>(frozen), static_cast<const int*>(pos), S, K, H, t_full, t_live,
      row_bytes / 16);
  return (int)cudaGetLastError();
}

}  // extern "C"
