// Binned row scatter-add for embedding-table gradients (K6), hand-written for
// Hopper (sm_90a).
//
// Replaces `scatter_add_rows` (rails_tpu/ops/pallas/scatter_add.py), the
// Pallas kernel behind the `gather_rows` custom VJP: the dense cotangent
// zeros((num_rows, D)).at[ids].add(rows), accumulated in f32 and written in
// the output dtype (f32 or bf16). Negative ids wrap once (+ num_rows); ids
// still out of range are dropped. Where the JAX function leaves the sort and
// the bounds to XLA, everything here happens on the card behind one entry
// point, with no host sync: every grid is sized from M, num_rows and the SM
// count.
//
// Bound: bytes. Each update row is read once and the whole (num_rows, D)
// table is written once: at ml-20m (27,008 ids into 26,745 x 256 f32) 55 MB,
// 0.0165 ms at 3.35 TB/s; at Amazon Books (3,904 ids into 695,763 x 64 f32)
// 179 MB, 0.0535 ms.
//
// Design (one memset and six kernels, launched back to back):
//   1. count: a thread per id wraps it, stores it (-1 when dropped) and adds
//      to its row's int32 count, one integer atomic per distinct id of a warp
//      (a padding id can own most of a batch; integer sums are exact in any
//      order);
//   2. scan: an exclusive scan of the counts gives each row's bounds, one
//      pass with decoupled look-back over 4,096-row tiles; rows of more than
//      kShort updates are listed as long rows (their count's slot now holds
//      the long row's number), each cut into pieces of kPiece updates;
//   3. rank: a block per 4,096-id chunk gives each update of a long row its
//      rank among its row's updates in the chunk, in index order, and each
//      (long row, chunk) its count: a warp takes 256 ids in rounds of 32,
//      ranks a round's lanes by __match_any_sync and carries each row's
//      count across rounds in per-warp shared counters, which then become
//      prefixes over the warps (1,024 long rows a pass);
//   4. chunk scan: a warp per long row scans its counts over the chunks;
//   5. place: a thread per update writes its index into its row's slots:
//      through an integer cursor for a short row (no fixed order yet), at
//      the row's start + the chunk's prefix + its rank for a long row (index
//      order);
//   6. sum: one block per piece of a long row sums its kPiece updates (16 per
//      warp, the warps' sums added in warp order) into an f32 partial, and the
//      last piece of a row to finish adds the row's partials in a fixed order
//      and writes the row; these blocks come first in the grid, so the long
//      rows start at once. Then each warp takes a tile of up to 32 short rows
//      (their bounds in one load), in groups of G lanes per row (G = 32 at
//      D = 256, 16 at D = 64): a group sorts its row's <= kShort indices in
//      shared memory, which fixes the order, sums the rows with 16-byte loads
//      (4 values a lane, kU rows in flight) and writes the row in the output
//      dtype, zeros for a row with no update.
// Work besides the sums: O(M) for count, rank and place (each id is read
// once), O(num_rows) for scan, and O(long rows x chunks) for the chunk
// counts, whose table the memset zeroes at its largest, max_long x chunks
// ints (max_long = M / 33, chunks = M / 4,096: 4 x M^2 / 135,168 bytes, 23 KB
// at ml-20m's 27,008 ids, 30 MB at 10^6).
// No floating-point atomics: every row sums its updates in increasing index
// order, grouped the same way on every call, so two calls give the same bits,
// and every element of the table is written exactly once.
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kShort = 32;          // updates a row group sorts and sums itself
constexpr int kPiece = 128;         // updates per piece of a long row (a block)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;
constexpr int kPlaceThreads = 512;
constexpr int kRankChunk = 4096;     // ids a rank block orders
constexpr int kRankWarps = kPlaceThreads / 32;
constexpr int kRankSpan = kRankChunk / kRankWarps;   // ids a warp orders, 32 a round
constexpr int kRankRows = 1024;      // long rows a rank pass counts (16 x 1,024 u16)
constexpr int kU = 4;               // update rows in flight per lane
constexpr int kV = 2;               // 4-value vectors per lane per pass
constexpr int kWarpsPerSm = 64;     // short-row warps per SM the tiles aim at
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 62;   // look-back flags
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

// The scratch of one call, laid out by the wrapper
// (`ops/scatter_add.py:scratch_layout`); status up to cnt is zeroed by one
// memset.
struct Scratch {
  unsigned long long* status;       // [scan tiles] look-back flag | value
  int* chunk_cnt;                   // [max_long, chunks] counts, then their prefixes
  int* counters;                    // [4] scan ticket, long rows, pieces
  int* done;                        // [max_long] pieces finished per long row
  int* cnt;                         // [num_rows] counts, then short-row cursors and
                                    //   each long row's number
  int* wid;                         // [M] wrapped ids, -1 where dropped
  int* start;                       // [num_rows + 1] row bounds
  int* slots;                       // [M] update indices by row
  int* rank;                        // [M] rank of a long row's update in its chunk
  int* long_row;                    // [max_long] table row of each long row
  int* piece_base;                  // [max_long] first piece of each long row
  int* piece_row;                   // [max_pieces] long row of each piece
  float* partial;                   // [max_pieces, D] f32 piece sums
};

template <typename Id>
__global__ void __launch_bounds__(kThreads)
count_kernel(const Id* __restrict__ ids, long long m, int num_rows, Scratch s) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int w = -1;
  if (i < m) {
    long long id = static_cast<long long>(ids[i]);
    if (id < 0) id += num_rows;
    if (id >= 0 && id < num_rows) w = static_cast<int>(id);
    s.wid[i] = w;
  }
  const unsigned peers = __match_any_sync(kFull, w);
  if (w >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(s.cnt + w, __popc(peers));
}

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// Inclusive scan over the block of one int per thread; s_warp holds the
// warps' inclusive totals afterwards (the block's total last).
template <int kBlockWarps>
__device__ __forceinline__ int block_incl_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v, lane);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlockWarps ? s_warp[lane] : 0;
    w = warp_incl_scan(w, lane);
    if (lane < kBlockWarps) s_warp[lane] = w;
  }
  __syncthreads();
  return incl + (warp ? s_warp[warp - 1] : 0);
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Called by one whole warp for tile i of a chain whose tiles 0..i-1 publish
// into status: publishes tile i's aggregate, looks back for the sum of the
// tiles before it, publishes its inclusive prefix and returns the sum. Tiles
// are handed out by a ticket, so every predecessor is already running.
__device__ int chain_prefix(unsigned long long* status, long long i, int aggregate, int lane) {
  if (i == 0) {
    if (lane == 0) store_status(status, kPrefix | static_cast<unsigned long long>(aggregate));
    return 0;
  }
  if (lane == 0) store_status(status + i, kAggregate | static_cast<unsigned long long>(aggregate));
  int exclusive = 0;
  for (long long pred = i - 1;; pred -= 32) {
    const long long t = pred - lane;
    unsigned long long st;
    do {
      st = t >= 0 ? load_status(status + t) : kPrefix;
    } while (__any_sync(kFull, (st & ~kValue) == 0));
    const unsigned prefix = __ballot_sync(kFull, (st & ~kValue) == kPrefix);
    const int last = prefix ? __ffs(prefix) - 1 : 31;   // lanes up to it count
    int add = lane <= last ? static_cast<int>(st & kValue) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) add += __shfl_xor_sync(kFull, add, off);
    exclusive += add;
    if (prefix) break;
  }
  if (lane == 0)
    store_status(status + i, kPrefix | static_cast<unsigned long long>(exclusive + aggregate));
  return exclusive;
}

// Exclusive scan of cnt[0, num_rows) into start[0, num_rows], 16 rows a
// thread; long rows are listed with their pieces, and each long row's number
// replaces its count.
__global__ void __launch_bounds__(kThreads)
scan_kernel(int num_rows, Scratch s) {
  __shared__ int s_tile, s_prefix;
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(s.counters + 0, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kScanTile +
                         static_cast<long long>(threadIdx.x) * kScanItems;
  int v[kScanItems];
  if (base + kScanItems <= num_rows) {
    const int4* src = reinterpret_cast<const int4*>(s.cnt + base);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 x = src[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) v[k] = base + k < num_rows ? s.cnt[base + k] : 0;
  }
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) sum += v[k];
  const int incl = block_incl_scan<kWarps>(sum, s_warp);
  if (warp == 0) {
    const int prefix = chain_prefix(s.status, tile, s_warp[kWarps - 1], lane);
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  int run = s_prefix + incl - sum;
  int excl[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    excl[k] = run;
    if (v[k] > kShort) {
      const int l = atomicAdd(s.counters + 1, 1);
      const int np = (v[k] + kPiece - 1) / kPiece;
      const int pb = atomicAdd(s.counters + 2, np);
      s.long_row[l] = static_cast<int>(base + k);
      s.piece_base[l] = pb;
      s.cnt[base + k] = l;
      for (int p = 0; p < np; ++p) s.piece_row[pb + p] = l;
    }
    run += v[k];
  }
  if (base + kScanItems <= num_rows + 1LL) {
    int4* dst = reinterpret_cast<int4*>(s.start + base);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q)
      dst[q] = make_int4(excl[4 * q], excl[4 * q + 1], excl[4 * q + 2], excl[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (base + k <= num_rows) s.start[base + k] = excl[k];
  }
}

// A block per chunk of kRankChunk ids, a warp per kRankSpan of them in
// rounds of 32: each update of a long row gets its rank among its row's
// updates in the chunk, in index order (lanes of a round by __match_any_sync,
// rounds and warps in order through per-warp counters), and each (long row,
// chunk) present its count. The counters hold kRankRows long rows; more take
// more passes over the ids kept in registers. A chunk with no update of a
// long row writes nothing (its counts stay zero).
__global__ void __launch_bounds__(kPlaceThreads)
rank_kernel(long long m, int chunks, Scratch s) {
  __shared__ unsigned short s_cnt[kRankWarps][kRankRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 = static_cast<long long>(blockIdx.x) * kRankChunk + warp * kRankSpan + lane;
  int lid[kRankSpan / 32];   // long row number of each round's id, -1 for none
  int any = 0;
#pragma unroll
  for (int r = 0; r < kRankSpan / 32; ++r) {
    const long long i = i0 + r * 32;
    lid[r] = -1;
    if (i < m) {
      const int w = s.wid[i];
      if (w >= 0 && s.start[w + 1] - s.start[w] > kShort) lid[r] = s.cnt[w];
    }
    any |= lid[r] >= 0;
  }
  if (!__syncthreads_or(any)) return;
  const int num_long = s.counters[1];
  const unsigned below = (1u << lane) - 1;
  for (int g0 = 0; g0 < num_long; g0 += kRankRows) {
    for (int k = threadIdx.x; k < kRankWarps * kRankRows / 2; k += kPlaceThreads)
      reinterpret_cast<unsigned*>(s_cnt)[k] = 0;
    __syncthreads();
    int local[kRankSpan / 32];
#pragma unroll
    for (int r = 0; r < kRankSpan / 32; ++r) {
      const int j = lid[r] - g0;
      const bool in = lid[r] >= g0 && j < kRankRows;
      const unsigned peers = __match_any_sync(kFull, in ? j : -1);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (in && lane == leader) {
        base = s_cnt[warp][j];
        s_cnt[warp][j] = static_cast<unsigned short>(base + __popc(peers));
      }
      local[r] = __shfl_sync(kFull, base, leader) + __popc(peers & below);
      __syncwarp();   // the leaders' counts before the next round reads them
    }
    __syncthreads();
    // Each row's counts over the warps become prefixes; their sum is the
    // chunk's count.
    for (int j = threadIdx.x; j < kRankRows && g0 + j < num_long; j += kPlaceThreads) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kRankWarps; ++w) {
        const int v = s_cnt[w][j];
        s_cnt[w][j] = static_cast<unsigned short>(run);
        run += v;
      }
      if (run) s.chunk_cnt[static_cast<long long>(g0 + j) * chunks + blockIdx.x] = run;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRankSpan / 32; ++r) {
      const int j = lid[r] - g0;
      if (lid[r] >= g0 && j < kRankRows) s.rank[i0 + r * 32] = s_cnt[warp][j] + local[r];
    }
    __syncthreads();   // s_cnt is cleared for the next rows
  }
}

// A warp per long row: its counts over the chunks become exclusive prefixes.
__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(int chunks, Scratch s) {
  const int lane = threadIdx.x & 31;
  const long long l = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (l >= s.counters[1]) return;
  int* c = s.chunk_cnt + l * chunks;
  int carry = 0;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int v = c0 + lane < chunks ? c[c0 + lane] : 0;
    const int incl = warp_incl_scan(v, lane);
    if (c0 + lane < chunks) c[c0 + lane] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
}

// A thread per update: its index into its row's slots, through the row's
// cursor for a short row, at its place in index order for a long row.
__global__ void __launch_bounds__(kPlaceThreads)
place_kernel(long long m, int chunks, Scratch s) {
  const long long i = static_cast<long long>(blockIdx.x) * kPlaceThreads + threadIdx.x;
  if (i >= m) return;
  const int w = s.wid[i];
  if (w < 0) return;
  const int lo = s.start[w];
  if (s.start[w + 1] - lo <= kShort) {
    s.slots[lo + atomicSub(s.cnt + w, 1) - 1] = static_cast<int>(i);
  } else {
    const long long l = s.cnt[w];
    s.slots[lo + s.chunk_cnt[l * chunks + i / kRankChunk] + s.rank[i]] = static_cast<int>(i);
  }
}

// VEC consecutive values of a row as floats, and back in the output dtype.
template <typename T, int VEC> struct Vec;
template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&a);
    x.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  }
};
template <typename T> struct Vec<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float* v) { v[0] = to_f<T>(p[0]); }
  static __device__ __forceinline__ void store(T* p, const float* v) { p[0] = from_f<T>(v[0]); }
};

// Sum of rows[idx[j]] for j in [0, n), in that order, over the columns
// c0 + (v * lanes + lane) * VEC, v < kV, into acc.
template <typename T, int VEC>
__device__ __forceinline__ void sum_entries(const T* __restrict__ rows, const int* idx, int n,
                                            int D, int c0, int lanes, int lane,
                                            float (&acc)[kV][VEC]) {
#pragma unroll
  for (int v = 0; v < kV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[v][e] = 0.f;
  int j = 0;
  for (; j + kU <= n; j += kU) {
    float val[kU][kV][VEC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const T* src = rows + static_cast<long long>(idx[j + u]) * D;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int c = c0 + (v * lanes + lane) * VEC;
        if (c < D) {
          Vec<T, VEC>::load(src + c, val[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) val[u][v][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int v = 0; v < kV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[v][e] += val[u][v][e];
  }
  for (; j < n; ++j) {
    const T* src = rows + static_cast<long long>(idx[j]) * D;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int c = c0 + (v * lanes + lane) * VEC;
      if (c < D) {
        float val[VEC];
        Vec<T, VEC>::load(src + c, val);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[v][e] += val[e];
      }
    }
  }
}

// One piece of a long row: its kPiece updates into partial[p]; the row's last
// piece to finish adds the row's partials in a fixed order and writes the row.
template <typename T, typename O, int VEC>
__device__ void sum_piece(const T* __restrict__ rows, O* __restrict__ out, int D, int p,
                          const Scratch& s) {
  constexpr int kPerWarp = kPiece / kWarps;
  constexpr int kCols = 32 * VEC * kV;
  __shared__ float s_red[kWarps][kCols];
  __shared__ float s_comb[kThreads * VEC];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = s.piece_row[p];
  const int t = s.long_row[l];
  const int row_lo = s.start[t], n = s.start[t + 1] - row_lo;
  const int np = (n + kPiece - 1) / kPiece;
  const int pb = s.piece_base[l];
  const int hi = min(row_lo + (p - pb + 1) * kPiece, row_lo + n);
  const int wlo = min(row_lo + (p - pb) * kPiece + warp * kPerWarp, hi);
  const int whi = min(wlo + kPerWarp, hi);
  for (int c0 = 0; c0 < D; c0 += kCols) {
    float acc[kV][VEC];
    sum_entries<T, VEC>(rows, s.slots + wlo, whi - wlo, D, c0, 32, lane, acc);
#pragma unroll
    for (int v = 0; v < kV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_red[warp][(v * 32 + lane) * VEC + e] = acc[v][e];
    __syncthreads();
    for (int c = threadIdx.x; c < kCols && c0 + c < D; c += kThreads) {
      float r = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) r += s_red[w][c];
      s.partial[static_cast<long long>(p) * D + c0 + c] = r;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(s.done + l, 1) == np - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Q groups of threads each add a fixed, contiguous range of the partials;
  // the groups' sums are then added in group order.
  const int cvs = (D + VEC - 1) / VEC;
  const int span = min(cvs, kThreads);
  const int groups = kThreads / span;
  const int q = threadIdx.x / span, cv = threadIdx.x % span;
  const int k0 = q * np / groups, k1 = (q + 1) * np / groups;
  O* dst = out + static_cast<long long>(t) * D;
  for (int cv0 = 0; cv0 < cvs; cv0 += span) {
    const int c = (cv0 + cv) * VEC;
    const bool active = q < groups && c < D;
    float r[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = 0.f;
    if (active) {
      const float* src = s.partial + static_cast<long long>(pb) * D + c;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const float* at = src + static_cast<long long>(k) * D;
        if constexpr (VEC == 4) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(at));
          r[0] += x.x; r[1] += x.y; r[2] += x.z; r[3] += x.w;
        } else {
          r[0] += __ldcg(at);
        }
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_comb[(q * span + cv) * VEC + e] = r[e];
    }
    __syncthreads();
    if (q == 0 && c < D) {
      for (int g = 1; g < groups; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) r[e] += s_comb[(g * span + cv) * VEC + e];
      Vec<O, VEC>::store(dst + c, r);
    }
    __syncthreads();
  }
}

// Blocks [0, max_pieces): a piece of a long row each (those past the pieces'
// count return). The blocks after them: warps of `tile` short rows, G lanes a
// row.
template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const T* __restrict__ rows, O* __restrict__ out, int num_rows, int D, int G, int tile,
           int max_pieces, Scratch s) {
  if (static_cast<int>(blockIdx.x) < max_pieces) {
    if (static_cast<int>(blockIdx.x) < s.counters[2])
      sum_piece<T, O, VEC>(rows, out, D, blockIdx.x, s);
    return;
  }
  __shared__ int s_keys[kWarps][2][32 / 4][kShort];   // unsorted, sorted; <= 8 rows a pass
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = 32 / G, g = lane / G, gl = lane % G;
  const long long r0 =
      (static_cast<long long>(blockIdx.x - max_pieces) * kWarps + warp) * tile;
  int lo_lane = 0, n_lane = 0;
  if (lane < tile && r0 + lane < num_rows) {
    lo_lane = s.start[r0 + lane];
    n_lane = s.start[r0 + lane + 1] - lo_lane;
  }
  int* keys = s_keys[warp][0][g];
  int* sorted = s_keys[warp][1][g];
  for (int pass = 0; pass < tile; pass += groups) {
    const int src = pass + g;
    const int lo = __shfl_sync(kFull, lo_lane, src), n = __shfl_sync(kFull, n_lane, src);
    const long long t = r0 + src;
    const bool mine = t < num_rows && n <= kShort;
    if (mine)
      for (int j = gl; j < n; j += G) keys[j] = s.slots[lo + j];
    __syncwarp();
    if (mine)
      for (int j = gl; j < n; j += G) {
        const int key = keys[j];
        int rank = 0;
        for (int k = 0; k < n; ++k) rank += keys[k] < key;
        sorted[rank] = key;
      }
    __syncwarp();
    if (mine) {
      O* dst = out + t * D;
      for (int c0 = 0; c0 < D; c0 += G * VEC * kV) {
        float acc[kV][VEC];
        sum_entries<T, VEC>(rows, sorted, n, D, c0, G, gl, acc);
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          const int c = c0 + (v * G + gl) * VEC;
          if (c < D) Vec<O, VEC>::store(dst + c, acc[v]);
        }
      }
    }
    __syncwarp();
  }
}

template <typename T, typename O>
cudaError_t launch_sum(int vec, const void* rows, void* out, int num_rows, int D, int G,
                       int tile, int max_pieces, const Scratch& s, cudaStream_t stream) {
  const long long rows_per_block = static_cast<long long>(kWarps) * tile;
  const long long blocks = max_pieces + (num_rows + rows_per_block - 1) / rows_per_block;
  const auto r = static_cast<const T*>(rows);
  const auto o = static_cast<O*>(out);
  if (vec == 4)
    sum_kernel<T, O, 4><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        r, o, num_rows, D, G, tile, max_pieces, s);
  else if (vec == 1)
    sum_kernel<T, O, 1><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        r, o, num_rows, D, G, tile, max_pieces, s);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails

// One call: ids (M,) int32 (id_dtype 0) or int64 (1); rows (M, D) f32 (dtype
// 0) or bf16 (1); out (num_rows, D) f32 (out_dtype 0) or bf16 (1), every
// element written. vec 4 reads and writes 4 values a lane (D % 4 == 0, rows
// aligned to 4 values) or 1; G lanes per short row (4 <= G <= 32, a power of
// two). The scratch pointers and sizes come from the wrapper's layout:
// zero_bytes from `status` are cleared first (status, chunk_cnt, counters,
// done, cnt); max_long >= M / (kShort + 1), max_pieces >= M / kPiece +
// max_long, chunks = ceil(M / 4,096).
extern "C" int rails_scatter_add_rows(
    int id_dtype, int dtype, int out_dtype, const void* ids, const void* rows, void* out,
    long long m, int num_rows, int D, int vec, int G, long long max_long, long long max_pieces,
    long long chunks, void* status, long long zero_bytes, void* chunk_cnt, void* counters,
    void* done, void* cnt, void* wid, void* start, void* slots, void* rank, void* long_row,
    void* piece_base, void* piece_row, void* partial, void* stream) {
  using namespace rails;
  auto st = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0 || D <= 0 || G < 4 || G > 32 || (G & (G - 1)) ||
      max_long < m / (kShort + 1) || max_pieces < m / kPiece + max_long ||
      chunks * kRankChunk < m || max_pieces > (1LL << 30))
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Scratch s{static_cast<unsigned long long*>(status), static_cast<int*>(chunk_cnt),
                  static_cast<int*>(counters), static_cast<int*>(done), static_cast<int*>(cnt),
                  static_cast<int*>(wid), static_cast<int*>(start), static_cast<int*>(slots),
                  static_cast<int*>(rank), static_cast<int*>(long_row),
                  static_cast<int*>(piece_base),
                  static_cast<int*>(piece_row), static_cast<float*>(partial)};
  cudaError_t err = cudaMemsetAsync(status, 0, static_cast<size_t>(zero_bytes), st);
  if (err != cudaSuccess) return err;
  if (m > 0) {
    const unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
    if (id_dtype == 0)
      count_kernel<int32_t><<<blocks, kThreads, 0, st>>>(static_cast<const int32_t*>(ids), m,
                                                          num_rows, s);
    else if (id_dtype == 1)
      count_kernel<int64_t><<<blocks, kThreads, 0, st>>>(static_cast<const int64_t*>(ids), m,
                                                          num_rows, s);
    else
      return cudaErrorInvalidValue;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_kernel<<<num_rows / kScanTile + 1, kThreads, 0, st>>>(num_rows, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (max_long > 0) {
    rank_kernel<<<static_cast<unsigned>(chunks), kPlaceThreads, 0, st>>>(
        m, static_cast<int>(chunks), s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    chunk_scan_kernel<<<static_cast<unsigned>((max_long + kWarps - 1) / kWarps), kThreads, 0,
                        st>>>(static_cast<int>(chunks), s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (m > 0) {
    place_kernel<<<static_cast<unsigned>((m + kPlaceThreads - 1) / kPlaceThreads),
                   kPlaceThreads, 0, st>>>(m, static_cast<int>(chunks), s);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // Short rows: tiles of up to 32 rows a warp, as many as keep about
  // kWarpsPerSm warps per SM busy.
  const int groups = 32 / G;
  const long long want = static_cast<long long>(num_rows) / (groups * kWarpsPerSm * sms);
  const int per_group = static_cast<int>(want < 1 ? 1 : want > 32 / groups ? 32 / groups : want);
  const int tile = groups * per_group;
  const int pieces = static_cast<int>(max_pieces);
  if (dtype == 0 && out_dtype == 0)
    return launch_sum<float, float>(vec, rows, out, num_rows, D, G, tile, pieces, s, st);
  if (dtype == 0 && out_dtype == 1)
    return launch_sum<float, __nv_bfloat16>(vec, rows, out, num_rows, D, G, tile, pieces, s, st);
  if (dtype == 1 && out_dtype == 0)
    return launch_sum<__nv_bfloat16, float>(vec, rows, out, num_rows, D, G, tile, pieces, s, st);
  if (dtype == 1 && out_dtype == 1)
    return launch_sum<__nv_bfloat16, __nv_bfloat16>(vec, rows, out, num_rows, D, G, tile, pieces,
                                                    s, st);
  return cudaErrorInvalidValue;
}
