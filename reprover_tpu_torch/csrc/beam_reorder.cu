// Beam-cache reorder with the fresh-column append, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of reprover_tpu/ops/beam_reorder.py:
// _reorder_kernel (:42), behind reorder_append_gather (:62).
//
// For the two per-beam decoder caches [L, S, K, H, T, d] of one decode step
// (keys and values), with p = frozen[s] ? k : parent[s, k]:
//
//   out[l, s, k, h, t, :] = col[l, s, p, h, 0, :]    if t == pos[s]
//                           cache[l, s, p, h, t, :]  otherwise
//
// for t < t_live, the step bucket's length. Columns from t_live on are not
// touched: the engine never reads them in this chunk. The caches may be the
// t_live prefix of buffers of t_full columns; every offset comes from the
// full buffer's layout. The output must be a different buffer (a
// permutation cannot be done in place): the engine keeps a second cache
// buffer and swaps the two every step.
//
// What bounds it on the H100: it moves bytes and computes nothing. A call
// must write every new beam's t_live rows of both caches and read each
// distinct parent's once: at the LLaMA-7B engine shape [32, 4, 8, 32, 129,
// 128] bf16 up to 4.33 GB, about 1.1-1.3 ms at 3.35 TB/s; at a byt5-small
// step bucket of 64 columns, or a tensor-parallel shard, 50-100 MB, 14-30
// us, where launches, index conversions and short blocks weigh.
//
// Design, one launch a call. The kernel reads the engine's own index
// tensors (int64 or int32 parents and positions, bool frozen; one
// instantiation per index type), so the call converts nothing. The grid is
// persistent, about one wave of blocks. A head's t_live x d span of the
// parent is contiguous in the buffer; the work is one unit a span (or a
// chunk of one), and worker w of W takes units w, w + W, w + 2W, ... The
// units run new beam fastest, then slot, layer, chunk, head and cache, so
// workers that run side by side hold the K new beams of many slots at one
// head, and a parent that several of them continue is read from device
// memory once and from the L2 cache after (a slot-major order, each worker
// walking one beam's heads, lost 12-20% at the LLaMA-7B shapes for want of
// those hits).
// A worker steps by adding W's digits with carries, so it divides only at
// its start; it reads a slot's frozen flag and pos when the slot changes,
// and the beam's parent at every unit (the slot's parents share an L1
// line). Two ways to move a span, chosen inside the kernel by the row's
// width against the launch's vector_row_bytes:
//
//   bulk   (rows narrower than vector_row_bytes): one thread a block issues
//          Hopper bulk copies (cp.async.bulk, the TMA's linear mode) through
//          a ring of STAGES shared-memory stages of up to STAGE_BYTES: a
//          span is cut into row-aligned chunks; each chunk arrives as up to
//          three loads that write disjoint rows of its stage -- rows
//          [r0, pos) and (pos, r1) of the parent and the column at pos --
//          and completes on the stage's mbarrier, then leaves as one bulk
//          store. No two copies write the same bytes, so none waits for
//          another; a stage is reloaded once its store has read it
//          (cp.async.bulk.wait_group.read), so STAGES - 1 to STAGES loads
//          and the stores behind them are in flight a block, three blocks
//          an SM.
//   vector (rows of vector_row_bytes or wider): each warp moves a span of
//          both caches with 16-byte loads, VEC_UNROLL of each cache in
//          flight a thread; a vector is the column's when its index lies in
//          the column row's range (a subtraction and a compare, no
//          division).
//
// Why by row width: on the H100, forced in turns at the engine shapes, the
// vector branch took 2-6% less time than the bulk copies at all four
// LLaMA-7B shapes (256-byte rows, spans of 4-33 KB), while at byt5-small's
// (128-byte rows, spans of 8-64 KB) the two were within 1%, and the bulk
// copies 4% ahead at the tensor-parallel shard; span size does not
// separate them. The ring's depth, stage size and blocks an SM did not move
// the bulk branch at 256-byte rows; the cause is not established (PERF.md).
//
// The copy is of raw bytes, so both branches are bit-equal to the plain
// version in any dtype whose row of d elements is a multiple of 16 bytes.
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_mma.cuh"

namespace {

constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 16 * 1024;
constexpr int BULK_THREADS = 32;  // one warp; its first thread issues every copy
constexpr int VEC_THREADS = 256;
constexpr int VEC_UNROLL = 4;
constexpr int MAX_DEVICES = 64;

struct Args {
  const char* src[2];  // k, v caches: [L, S, K, H, t_full, row_bytes]
  const char* col[2];  // k, v columns: [L, S, K, H, row_bytes]
  char* out[2];        // [L, S, K, H, t_full, row_bytes]
  const void* parent;  // [S, K] Index
  const bool* frozen;  // [S]
  const void* pos;     // [S] Index
  int L, S, K, H, t_full, t_live, row_bytes, vector_row_bytes;
  int chunks;          // bulk: chunks a span
  int chunk_rows;      // bulk: rows a chunk (the last may have fewer)
};

// A work unit's place, digit by digit, fastest first: the new beam k, the
// slot s, the layer l, the chunk of the span, the head h and the cache c
// (the bulk branch moves the two caches as separate units; the vector
// branch both in one, so its c and chunk stay 0).
struct Place {
  int k, s, l, chunk, h, c;
};

__device__ __forceinline__ Place place_of(long long u, const Args& a, int chunks) {
  Place d;
  d.k = (int)(u % a.K);
  u /= a.K;
  d.s = (int)(u % a.S);
  u /= a.S;
  d.l = (int)(u % a.L);
  u /= a.L;
  d.chunk = (int)(u % chunks);
  u /= chunks;
  d.h = (int)(u % a.H);
  d.c = (int)(u / a.H);
  return d;
}

// A worker's walk over its units (see the note at the head of the file).
template <typename Index>
struct Walk {
  Place d;
  int p;    // beam k's effective parent
  int at;   // the slot's column row, -1 when pos lies outside [0, t_live)
  bool fz;  // the slot is frozen

  __device__ __forceinline__ void read(const Args& a, bool slot) {
    if (slot) {
      fz = a.frozen[d.s];
      const long long q = static_cast<const Index*>(a.pos)[d.s];
      at = q >= 0 && q < a.t_live ? (int)q : -1;
    }
    p = fz ? d.k : (int)static_cast<const Index*>(a.parent)[(long long)d.s * a.K + d.k];
  }
  __device__ __forceinline__ void start(const Args& a, long long u, int chunks) {
    d = place_of(u, a, chunks);
    read(a, true);
  }
  // Adds `by` (a place of W units) digit by digit with carries. The digits
  // below the cache stay in range, so the reads after the last unit are
  // in bounds too.
  __device__ __forceinline__ void step(const Args& a, const Place& by, int chunks) {
    const int s = d.s;
    int carry;
    d.k += by.k;
    carry = d.k >= a.K;
    if (carry) d.k -= a.K;
    d.s += by.s + carry;
    carry = d.s >= a.S;
    if (carry) d.s -= a.S;
    d.l += by.l + carry;
    carry = d.l >= a.L;
    if (carry) d.l -= a.L;
    d.chunk += by.chunk + carry;
    carry = d.chunk >= chunks;
    if (carry) d.chunk -= chunks;
    d.h += by.h + carry;
    carry = d.h >= a.H;
    if (carry) d.h -= a.H;
    d.c += by.c + carry;
    read(a, d.s != s);
  }
  // Byte offsets of head h's span in the caches (the parent's) and in the
  // outputs (the new beam's), and of the parent's column row.
  __device__ __forceinline__ long long beam_head(const Args& a, int beam) const {
    return (((long long)d.l * a.S + d.s) * a.K + beam) * a.H + d.h;
  }
  __device__ __forceinline__ long long src_span(const Args& a) const {
    return beam_head(a, p) * a.t_full * a.row_bytes;
  }
  __device__ __forceinline__ long long dst_span(const Args& a) const {
    return beam_head(a, d.k) * a.t_full * a.row_bytes;
  }
  __device__ __forceinline__ long long col_row(const Args& a) const {
    return beam_head(a, p) * a.row_bytes;
  }
};

__device__ __forceinline__ void bulk_load(void* smem, const char* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(hopper::smem_u32(smem)), "l"(src), "r"(bytes), "r"(hopper::smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, const void* smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(hopper::smem_u32(smem)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Bulk branch: this block's chunks.
template <typename Index>
__device__ void reorder_bulk(const Args& a, unsigned char* ring) {
  __shared__ uint64_t full[STAGES];
  __shared__ char* dst_of[STAGES];
  __shared__ uint32_t bytes_of[STAGES];
  if (threadIdx.x != 0) return;

  const long long units = 2LL * a.H * a.chunks * a.L * a.S * a.K;
  const long long n = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (n <= 0) return;
  for (int i = 0; i < STAGES; ++i) hopper::mbar_init(&full[i], 1);
  hopper::fence_mbar_init();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  Walk<Index> w;
  w.start(a, blockIdx.x, a.chunks);
  const Place by = place_of(gridDim.x, a, a.chunks);
  // Load the walk's current chunk into stage `st` and step the walk.
  auto load = [&](int st) {
    unsigned char* buf = ring + st * STAGE_BYTES;
    const int r0 = w.d.chunk * a.chunk_rows;
    const int r1 = min(r0 + a.chunk_rows, a.t_live);
    const uint32_t rb = (uint32_t)a.row_bytes;
    const uint32_t bytes = (uint32_t)(r1 - r0) * rb;
    const char* src = a.src[w.d.c] + w.src_span(a);
    hopper::mbar_expect_tx(&full[st], bytes);
    if (w.at >= r0 && w.at < r1) {
      const int at = w.at;
      if (at > r0) bulk_load(buf, src + (long long)r0 * rb, (uint32_t)(at - r0) * rb, &full[st]);
      bulk_load(buf + (at - r0) * rb, a.col[w.d.c] + w.col_row(a), rb, &full[st]);
      if (at + 1 < r1)
        bulk_load(buf + (at + 1 - r0) * rb, src + (long long)(at + 1) * rb,
                  (uint32_t)(r1 - at - 1) * rb, &full[st]);
    } else {
      bulk_load(buf, src + (long long)r0 * rb, bytes, &full[st]);
    }
    dst_of[st] = a.out[w.d.c] + w.dst_span(a) + (long long)r0 * rb;
    bytes_of[st] = bytes;
    w.step(a, by, a.chunks);
  };

  for (long long j = 0; j < n && j < STAGES; ++j) load((int)j);
  for (long long j = 0; j < n; ++j) {
    const int st = (int)(j % STAGES);
    hopper::mbar_wait(&full[st], (uint32_t)((j / STAGES) & 1));
    bulk_store(dst_of[st], ring + st * STAGE_BYTES, bytes_of[st]);
    // Refill the stage the previous chunk left, once its store has read it.
    if (j >= 1 && j - 1 + STAGES < n) {
      bulk_wait_read<1>();
      load((int)((j - 1) % STAGES));
    }
  }
  bulk_wait_all();
}

// Vector branch: this warp's spans, both caches at once.
template <typename Index>
__device__ void reorder_vector(const Args& a) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long warp = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long units = (long long)a.H * a.L * a.S * a.K;
  if (warp >= units) return;
  Walk<Index> w;
  w.start(a, warp, 1);
  const Place by = place_of(warps, a, 1);
  const int rv = a.row_bytes / 16;  // 16-byte vectors a row
  const int n = a.t_live * rv;
  for (long long u = warp; u < units; u += warps) {
    const long long src = w.src_span(a) / 16, dst = w.dst_span(a) / 16;
    const long long col = w.col_row(a) / 16;
    const uint4* ks = reinterpret_cast<const uint4*>(a.src[0]) + src;
    const uint4* vs = reinterpret_cast<const uint4*>(a.src[1]) + src;
    const uint4* kc = reinterpret_cast<const uint4*>(a.col[0]) + col;
    const uint4* vc = reinterpret_cast<const uint4*>(a.col[1]) + col;
    uint4* ko = reinterpret_cast<uint4*>(a.out[0]) + dst;
    uint4* vo = reinterpret_cast<uint4*>(a.out[1]) + dst;
    const int col_lo = w.at * rv;  // -rv when there is no column row
    for (int base = 0; base < n; base += 32 * VEC_UNROLL) {
      uint4 x[VEC_UNROLL], y[VEC_UNROLL];
#pragma unroll
      for (int j = 0; j < VEC_UNROLL; ++j) {
        const int i = base + lane + 32 * j;
        if (i < n) {
          const bool in_col = (unsigned)(i - col_lo) < (unsigned)rv;
          x[j] = __ldg(in_col ? kc + (i - col_lo) : ks + i);
          y[j] = __ldg(in_col ? vc + (i - col_lo) : vs + i);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC_UNROLL; ++j) {
        const int i = base + lane + 32 * j;
        if (i < n) {
          ko[i] = x[j];
          vo[i] = y[j];
        }
      }
    }
    w.step(a, by, 1);
  }
}

template <typename Index>
__global__ void __launch_bounds__(VEC_THREADS) reorder_append_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char ring[];
  if (a.row_bytes < a.vector_row_bytes)
    reorder_bulk<Index>(a, ring);
  else
    reorder_vector<Index>(a);
}

// Per device and instantiation: SMs, and blocks an SM holds of each branch.
struct Fit {
  int sms = 0, bulk = 0, vector = 0;
};

template <typename Index>
int fit(int device, Fit& out) {
  static Fit fits[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  Fit& f = fits[device];
  if (f.sms == 0) {
    auto* kernel = reorder_append_kernel<Index>;
    const int smem = STAGES * STAGE_BYTES;
    int sms = 0, bulk = 0, vector = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bulk, kernel, BULK_THREADS, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&vector, kernel, VEC_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    if (bulk < 1 || vector < 1) return (int)cudaErrorInvalidConfiguration;
    f.bulk = bulk;
    f.vector = vector;
    f.sms = sms;  // last: a concurrent caller sees a whole entry or none
  }
  out = f;
  return 0;
}

template <typename Index>
int launch(Args& a, cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  Fit f;
  const int rc = fit<Index>(device, f);
  if (rc != 0) return rc;
  const long long beams = (long long)a.L * a.S * a.K * a.H;  // spans of one cache
  if (a.row_bytes < a.vector_row_bytes) {
    const int max_rows = STAGE_BYTES / a.row_bytes;
    a.chunks = (a.t_live + max_rows - 1) / max_rows;
    a.chunk_rows = (a.t_live + a.chunks - 1) / a.chunks;
    const long long grid = std::min(2 * beams * a.chunks, (long long)f.sms * f.bulk);
    reorder_append_kernel<Index><<<(unsigned)grid, BULK_THREADS, STAGES * STAGE_BYTES, stream>>>(a);
  } else {
    a.chunks = a.chunk_rows = 1;
    const long long per_block = VEC_THREADS / 32;
    const long long grid = std::min((beams + per_block - 1) / per_block,
                                    (long long)f.sms * f.vector);
    reorder_append_kernel<Index><<<(unsigned)grid, VEC_THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k_src, v_src, k_out, v_out: [L, S, K, H, t_full, d] contiguous buffers, of
// which the first t_live columns are read and written; k_col, v_col:
// [L, S, K, H, 1, d] contiguous; row_bytes = d * element size, a multiple of
// 16 and at most STAGE_BYTES, and every pointer 16-byte aligned. parent:
// [S, K] in [0, K) and pos: [S], both contiguous of index_bytes (4: int32,
// 8: int64) each; frozen: contiguous bool [S]. Rows narrower than
// vector_row_bytes move by the bulk copies, others by the vector branch.
// Returns a cudaError_t value; 0 is success.
int beam_reorder_append(const void* k_src, const void* v_src, const void* k_col,
                        const void* v_col, void* k_out, void* v_out, const void* parent,
                        const void* frozen, const void* pos, int L, int S, int K, int H,
                        int t_full, int t_live, int row_bytes, int index_bytes,
                        int vector_row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > STAGE_BYTES || t_live > t_full ||
      (index_bytes != 4 && index_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || S <= 0 || K <= 0 || H <= 0 || t_live <= 0) return 0;
  Args a;
  a.src[0] = static_cast<const char*>(k_src);
  a.src[1] = static_cast<const char*>(v_src);
  a.col[0] = static_cast<const char*>(k_col);
  a.col[1] = static_cast<const char*>(v_col);
  a.out[0] = static_cast<char*>(k_out);
  a.out[1] = static_cast<char*>(v_out);
  a.parent = parent;
  a.frozen = static_cast<const bool*>(frozen);
  a.pos = pos;
  a.vector_row_bytes = vector_row_bytes;
  a.L = L;
  a.S = S;
  a.K = K;
  a.H = H;
  a.t_full = t_full;
  a.t_live = t_live;
  a.row_bytes = row_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return index_bytes == 8 ? launch<int64_t>(a, s) : launch<int32_t>(a, s);
}

}  // extern "C"
