// Binned row scatter-add for embedding-table gradients (K6), hand-written for
// Hopper (sm_90a).
//
// Replaces `scatter_add_rows` (rails_tpu/ops/pallas/scatter_add.py), the
// Pallas kernel behind the `gather_rows` custom VJP: the dense cotangent
// zeros((num_rows, D)).at[ids].add(rows), accumulated in f32. As in the JAX
// function, the sort and the bounds stay outside the kernel (torch's argsort
// and searchsorted, where the JAX package leaves them to XLA): `order` lists the
// update rows by table row, and rows [bounds[t], bounds[t + 1]) of that order
// belong to table row t. Ids that were out of range after the wrap sort past
// the last bound and are never read.
//
// Bound: bytes. Each update row is read once and the whole (num_rows, D) f32
// table is written once; at ml-20m (27,008 rows into 26,745 x 256) that is
// 55 MB, 0.0165 ms at 3.35 TB/s.
//
// Design: the run of a table row is cut into pieces of at most `piece` sorted
// entries: a padding id can own most of an ML-20M-shaped batch's 27,008 ids,
// a run that one warp summed serially in ~10 ms on an H100. One warp
// per piece sums its entries in sorted order, 256 columns per pass (8 per
// lane, neighbouring lanes on neighbouring columns) with kUnroll rows' loads
// in flight; a row of one piece (nearly all rows, empty ones included) is
// written straight to the table, and a second pass sums the pieces of the
// longer rows in order. No atomics: the sum order is fixed, so the result
// repeats bit for bit, and every table element is written exactly once.
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;      // columns per lane per pass
constexpr int kUnroll = 4;    // update rows in flight per warp

// Sum of rows[order[i]] for i in [lo, hi), in that order, into dst (D floats).
template <typename T>
__device__ void sum_rows(const T* __restrict__ rows, const int64_t* __restrict__ order,
                         int64_t lo, int64_t hi, int D, float* __restrict__ dst, int lane) {
  for (int c0 = 0; c0 < D; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int v = 0; v < kCols; ++v) acc[v] = 0.f;
    int64_t i = lo;
    for (; i + kUnroll <= hi; i += kUnroll) {
      float val[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const T* src = rows + order[i + u] * D;
#pragma unroll
        for (int v = 0; v < kCols; ++v) {
          const int c = c0 + v * 32 + lane;
          val[u][v] = c < D ? to_f<T>(src[c]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kCols; ++v) acc[v] += val[u][v];
    }
    for (; i < hi; ++i) {
      const T* src = rows + order[i] * D;
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const int c = c0 + v * 32 + lane;
        if (c < D) acc[v] += to_f<T>(src[c]);
      }
    }
#pragma unroll
    for (int v = 0; v < kCols; ++v) {
      const int c = c0 + v * 32 + lane;
      if (c < D) dst[c] = acc[v];
    }
  }
}

// Warp per piece p: its row t is the last with first[t] <= p.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_pieces_kernel(const T* __restrict__ rows, const int64_t* __restrict__ order,
                      const int64_t* __restrict__ bounds, const int64_t* __restrict__ first,
                      float* __restrict__ out, float* __restrict__ partial, int num_rows, int D,
                      int piece) {
  const int lane = threadIdx.x & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (p >= first[num_rows]) return;  // the grid covers max_pieces >= first[num_rows]
  int lo_t = 0, hi_t = num_rows - 1;
  while (lo_t < hi_t) {
    const int mid = (lo_t + hi_t + 1) / 2;
    if (first[mid] <= p) lo_t = mid; else hi_t = mid - 1;
  }
  const int t = lo_t;
  const int64_t k = p - first[t];
  const int64_t lo = bounds[t] + k * piece;
  const int64_t hi = min(lo + piece, bounds[t + 1]);
  const bool single = first[t + 1] - first[t] == 1;
  float* dst = single ? out + static_cast<int64_t>(t) * D : partial + p * D;
  sum_rows<T>(rows, order, lo, hi, D, dst, lane);
}

// Warp per table row of more than one piece: the pieces' sums, in order.
__global__ void __launch_bounds__(kThreads)
combine_pieces_kernel(const int64_t* __restrict__ first, const float* __restrict__ partial,
                      float* __restrict__ out, int num_rows, int D) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= num_rows) return;
  const int64_t p0 = first[t], p1 = first[t + 1];
  if (p1 - p0 == 1) return;
  for (int c = lane; c < D; c += 32) {
    float acc = 0.f;
    for (int64_t p = p0; p < p1; ++p) acc += partial[p * D + c];
    out[static_cast<int64_t>(t) * D + c] = acc;
  }
}

template <typename T>
cudaError_t launch(const void* rows, const int64_t* order, const int64_t* bounds,
                   const int64_t* first, float* out, float* partial, long long max_pieces,
                   int num_rows, int D, int piece, cudaStream_t stream) {
  if (num_rows == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((max_pieces + kWarps - 1) / kWarps);
  scatter_pieces_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(rows), order, bounds, first, out, partial, num_rows, D, piece);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_pieces_kernel<<<(num_rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      first, partial, out, num_rows, D);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails

// dtype: 0 = float32, 1 = bfloat16 rows. rows (M, D); order (M,) int64; bounds
// (num_rows + 1,) int64; first (num_rows + 1,) int64, the exclusive prefix sum
// of each row's piece count max(1, ceil(run / piece)), so first[num_rows] is
// the number of pieces, at most max_pieces = num_rows + M / piece (known on
// the host without reading `first` back); partial (max_pieces, D) f32
// scratch; out (num_rows, D) f32, every element written.
extern "C" int rails_scatter_add_rows(int dtype, const void* rows, const int64_t* order,
                                      const int64_t* bounds, const int64_t* first, float* out,
                                      float* partial, long long max_pieces, int num_rows, int D,
                                      int piece, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (piece < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return rails::launch<float>(rows, order, bounds, first, out, partial, max_pieces, num_rows,
                                D, piece, s);
  if (dtype == 1)
    return rails::launch<__nv_bfloat16>(rows, order, bounds, first, out, partial, max_pieces,
                                        num_rows, D, piece, s);
  return cudaErrorInvalidValue;
}
