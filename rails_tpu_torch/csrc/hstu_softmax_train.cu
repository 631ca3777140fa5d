// HSTU block training (K4), softmax_rel_bias: the attention-core backward,
// hand-written for Hopper (sm_90a).
//
// Replaces the `if softmax` branch of `_attn_bwd_kernel` in
// rails_tpu/ops/pallas/hstu_block_train.py (:290-349): ONE (n, n) map over the
// full h*dqk contraction shared by every value head, s = q k^T + bias,
// p = softmax(s / sqrt(dqk)) over every column, a = p * mask [* keep]
// rounded to the matmul type, attn = a v. Given d_attn (the LayerNorm
// backward of attn, from attn_row_bwd_kernel in hstu_train.cuh, as the
// pointwise entry runs it):
//   d_a = d_attn v^T, d_p = d_a [* keep] * mask,
//   d_s = p * (d_p - sum_j d_p p) / sqrt(dqk)   (dbias when the bias is on),
//   d_q = d_s k, d_k = d_s^T q, d_v = a^T d_attn (no 1/max_seq_len),
// with a, d_attn, v and d_s rounded to the matmul type before each product,
// as the JAX kernel casts them. The mask multiplies after normalisation, so
// d_s is nonzero at every (i, j), future and padded columns included, and so
// is d_k of a padded column: none of the pointwise kernel's shortcuts hold.
//
// At n = 211 and h*dqk = h*dv = 256 one user's k, v, q and d_attn in f32
// (216 KB each) fit no block, so the backward runs as two kernels, each over
// (user, 32 rows or columns), as K1's softmax attention kernel does:
//   rows: one block per (user, 32 query rows). It forms the (32, n) scores,
//     normalises each row over all n columns (p stays in shared memory) and
//     writes a = round(p * mask * keep) to a (B, n, n) scratch; then forms
//     d_a over the causal columns, d_s, writes d_s to dbias (B, n, n) f32,
//     and forms d_q.
//   cols: one block per (user, 32 key columns). It reads its columns of d_s
//     and a back from device memory (45 MB at B = 128, within L2's 50 MB)
//     and forms d_k (all rows) and d_v (rows i >= j). Every output element
//     has one writer and no atomics are used, so the result repeats bit for
//     bit.
// Each of the five products is a 32 x 256 register tile per block (`tile_fma`:
// 4 rows x 8 columns per thread) over 32-long chunks of the contraction staged
// in shared memory, so a thread reads 3 float4 per 32 FMAs; a lane per output
// column with broadcast rows would read one float per FMA and leave the FMA
// units waiting on shared memory.
// Without the bias the caller passes zero tables (s + 0 is s) and drops dbias.
// In bf16 the entry first recomputes attn from the bf16 y with K1's softmax
// kernel reading bf16 (as the JAX backward recomputes it).
// Bound: 3 n^2 h dqk + 2 n(n+1)/2 h dv FMAs per user (scores, d_q, d_k over
// every pair; d_a and d_v over the causal ones), 11.7 GFLOP per layer at
// B = 128, n = 211, h*d = 256: 0.17 ms at the 67 TFLOP/s f32 rate of the CUDA
// cores, against ~0.25 GB of traffic (y, d_o, attn, d_y, the d_s and a round
// trips; 0.08 ms): the FMA rate bounds it. A wgmma form is later work.
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "hstu_block.cuh"
#include "hstu_train.cuh"

namespace rails {
namespace {

// Register tiles: a block of 256 threads forms a 32 x 256 output tile, each
// warp 4 rows of it and each lane 8 columns (4 * lane + q and 128 + 4 * lane
// + q), summing over chunks of 32 along the contraction staged in shared
// memory. The A operand is read as one float4 per row quad (a broadcast), the
// B operand as two conflict-free float4 per lane: 3 shared-memory reads per
// 32 FMAs, where a lane per output column with its rows broadcast reads one
// per FMA.
constexpr int kTileRows = kSmRows;          // 32: 4 per warp
constexpr int kTileCols = 256;              // 8 per lane
constexpr int kKc = 32;                     // contraction chunk
constexpr int kLdA = kTileRows + 4;         // k-major A chunk, 16-byte rows
constexpr int kLdB = kTileCols + 8;         // k-major B chunk; the +8 spreads a
                                            // transposing fill over the banks
static_assert(kWarps * 4 == kTileRows, "4 tile rows per warp");

__device__ __forceinline__ int tile_col(int lane, int q) {
  return (q < 4 ? 0 : kTileCols / 2 - 4) + 4 * lane + q;
}

// acc[r][q] += sum_{k < kc} A(k, 4 * warp + r) * B[k * kLdB + tile_col(lane, q)],
// A k-major (A[k * lda + row], lda a multiple of 4) when AK, else row-major
// (A[row * lda + k]). The sum runs in k order.
template <bool AK>
__device__ __forceinline__ void tile_fma(const float* __restrict__ A, int lda,
                                         const float* __restrict__ B, int kc, int warp,
                                         int lane, float (&acc)[4][8]) {
#pragma unroll 2
  for (int k = 0; k < kc; ++k) {
    float a[4];
    if constexpr (AK) {
      const float4 v = *reinterpret_cast<const float4*>(A + k * lda + 4 * warp);
      a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = A[(4 * warp + r) * lda + k];
    }
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * kLdB + 4 * lane);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k * kLdB + kTileCols / 2 + 4 * lane);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = fmaf(a[r], b[q], acc[r][q]);
    }
  }
}

__device__ __forceinline__ void tile_zero(float (&acc)[4][8]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
  }
}

// B chunk = src^T: B[dd * kLdB + c] = src(c0 + c, d0 + dd) for c < 256 and
// dd < 32 (zero where c0 + c >= rows or d0 + dd >= width). Each warp fills 8
// source rows x 4 consecutive dims at a time: 16 bytes of each row from
// device memory, and 32 distinct banks in shared memory.
template <typename F>
__device__ __forceinline__ void fill_transposed(float* B, int c0, int rows, int d0, int width,
                                                int tid, F src) {
  for (int e = tid; e < kKc * kTileCols; e += kThreads) {
    const int g = e >> 5, l = e & 31;
    const int dd = 4 * (g & 7) + (l >> 3), c = 8 * (g >> 3) + (l & 7);
    B[dd * kLdB + c] = c0 + c < rows && d0 + dd < width ? src(c0 + c, d0 + dd) : 0.f;
  }
}

// B chunk = src rows: B[kk * kLdB + c] = src(k0 + kk, c0 + c) for kk < 32 and
// c < 256 (zero where k0 + kk >= rows or c0 + c >= width).
template <typename F>
__device__ __forceinline__ void fill_rows(float* B, int k0, int rows, int c0, int width, int tid,
                                          F src) {
  for (int e = tid; e < kKc * kTileCols; e += kThreads) {
    const int kk = e / kTileCols, c = e % kTileCols;
    B[kk * kLdB + c] = k0 + kk < rows && c0 + c < width ? src(k0 + kk, c0 + c) : 0.f;
  }
}

size_t rows_smem_bytes(int n) {
  const size_t floats = kKc * kLdA + kKc * kLdB + 2 * static_cast<size_t>(kSmRows) * n + n + 128;
  return floats * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
}

size_t cols_smem_bytes() { return (2 * kKc * kLdA + 2 * kKc * kLdB) * sizeof(float); }

// Query rows i0..i0+31 of user b: scores, p, a (to a_out), d_a, d_s (to
// ds_out) and d_q (into d_y). y is stored as T; d_attn is f32 (rounded here).
// rel_pos, ext and tsw are read always (zero tables without the bias: s + 0
// is s).
template <typename T, bool ADROP>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_rows_kernel(const T* __restrict__ y, const float* __restrict__ d_attn,
                        const float* __restrict__ colmask, const float* __restrict__ rel_pos,
                        const int* __restrict__ ext, const float* __restrict__ tsw,
                        float* __restrict__ d_y, float* __restrict__ ds_out,
                        float* __restrict__ a_out, int n, int H, int dqk, int dv,
                        float inv_sqrt_dqk, int max_bucket, Dropout adp) {
  extern __shared__ float smem[];
  const int hq = H * dqk, hv = H * dv, F = 2 * hv + 2 * hq;
  float* As = smem;                            // [kKc][kLdA] A chunk
  float* Bs = As + kKc * kLdA;                 // [kKc][kLdB] B chunk
  float* pm = Bs + kKc * kLdB;                 // [kSmRows][n] scores, p, then round_T(d_s)
  float* dm = pm + kSmRows * n;                // [kSmRows][n] d_a, then d_p
  float* cm = dm + kSmRows * n;                // [n]
  float* tw = cm + n;                          // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);  // [n + 1]

  const int b = blockIdx.y, i0 = blockIdx.x * kSmRows, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rows = min(kSmRows, n - i0);
  const int64_t row0 = static_cast<int64_t>(b) * n;
  const T* yb = y + row0 * F;
  const float* dab = d_attn + row0 * hv;
  const uint32_t aseed = ADROP ? attn_seed(adp.seed0, b, 0) : 0u;
  for (int j = tid; j < n; j += kThreads) cm[j] = colmask[row0 + j];
  for (int j = tid; j <= n; j += kThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
  for (int t = tid; t < 128; t += kThreads) tw[t] = tsw[t];
  float acc[4][8];

  // (i, j) tile of S = Xa Xb^T over `width` dims (columns j0.. of j < jn),
  // rows of Xa and Xb read by xa(i, d) and xb(j, d); each element goes
  // through `out(i, j, value)`.
  auto product = [&](int j0, int jn, int width, auto xa, auto xb, auto out) {
    tile_zero(acc);
    for (int d0 = 0; d0 < width; d0 += kKc) {
      __syncthreads();
      for (int e = tid; e < kKc * kTileRows; e += kThreads) {
        const int r = e / kKc, dd = e % kKc;
        As[dd * kLdA + r] = r < rows && d0 + dd < width ? xa(r, d0 + dd) : 0.f;
      }
      fill_transposed(Bs, j0, jn, d0, width, tid, xb);
      __syncthreads();
      tile_fma<true>(As, kLdA, Bs, kKc, warp, lane, acc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * warp + r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = j0 + tile_col(lane, q);
        if (i < rows && j < jn) out(i, j, acc[r][q]);
      }
    }
  };

  // Scores over every column, as the forward kernel computes them.
  for (int j0 = 0; j0 < n; j0 += kTileCols) {
    product(
        j0, n, hq,
        [&](int r, int d) { return to_f<T>(yb[static_cast<int64_t>(i0 + r) * F + 2 * hv + d]); },
        [&](int j, int d) { return to_f<T>(yb[static_cast<int64_t>(j) * F + 2 * hv + hq + d]); },
        [&](int i, int j, float s) {
          const int gi = i0 + i;
          s += rel_pos[static_cast<int64_t>(gi) * n + j] +
               tw[time_bucket(ex[gi + 1], ex[j], max_bucket)];
          pm[i * n + j] = s * inv_sqrt_dqk;
        });
  }
  __syncthreads();

  // p over every column; a = round_T(p * mask * keep), read back by the
  // column kernel.
  for (int i = warp; i < rows; i += kWarps) {
    float* prow = pm + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float ssum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      ssum += e;
    }
    ssum = warp_sum(ssum);
    const int gi = i0 + i;
    float* arow = a_out + (row0 + gi) * n;
    for (int j = lane; j < n; j += 32) {
      const float p = prow[j] / ssum;
      prow[j] = p;
      float a = p * (j <= gi ? cm[j] : 0.f);
      if constexpr (ADROP) {
        a *= keep_scale(static_cast<uint32_t>(gi * n + j), aseed, adp.thresh, adp.scale);
      }
      arow[j] = round_to<T>(a);
    }
  }

  // d_a = round_T(d_attn) . v over the columns j < i0 + rows (d_p is 0 past
  // the block's last row).
  const int jmax = i0 + rows;
  for (int j0 = 0; j0 < jmax; j0 += kTileCols) {
    product(
        j0, jmax, hv,
        [&](int r, int c) { return round_to<T>(dab[static_cast<int64_t>(i0 + r) * hv + c]); },
        [&](int j, int c) { return to_f<T>(yb[static_cast<int64_t>(j) * F + hv + c]); },
        [&](int i, int j, float da) { dm[i * n + j] = da; });
  }
  __syncthreads();

  // d_s = p * (d_p - sum_j d_p p) / sqrt(dqk) with d_p = d_a * keep * mask,
  // at every column; f32 to ds_out, rounded to T in place of p for d_q.
  for (int i = warp; i < rows; i += kWarps) {
    const int gi = i0 + i;
    float* prow = pm + i * n;
    float* drow = dm + i * n;
    float dot = 0.f;
    for (int j = lane; j < n; j += 32) {
      float dp = 0.f;
      if (j <= gi) {
        dp = drow[j];
        if constexpr (ADROP) {
          dp *= keep_scale(static_cast<uint32_t>(gi * n + j), aseed, adp.thresh, adp.scale);
        }
        dp *= cm[j];
      }
      drow[j] = dp;
      dot = fmaf(dp, prow[j], dot);
    }
    dot = warp_sum(dot);
    float* dsrow = ds_out + (row0 + gi) * n;
    for (int j = lane; j < n; j += 32) {
      const float ds = prow[j] * (drow[j] - dot) * inv_sqrt_dqk;
      dsrow[j] = ds;
      prow[j] = round_to<T>(ds);
    }
  }

  // d_q = round_T(d_s) . k over every column: A is round_T(d_s) row-major,
  // B the rows of k.
  for (int c0 = 0; c0 < hq; c0 += kTileCols) {
    tile_zero(acc);
    for (int j0 = 0; j0 < n; j0 += kKc) {
      __syncthreads();
      fill_rows(Bs, j0, n, c0, hq, tid, [&](int j, int c) {
        return to_f<T>(yb[static_cast<int64_t>(j) * F + 2 * hv + hq + c]);
      });
      __syncthreads();
      tile_fma<false>(pm + j0, n, Bs, min(kKc, n - j0), warp, lane, acc);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * warp + r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + tile_col(lane, q);
        if (i < rows && c < hq) d_y[(row0 + i0 + i) * F + 2 * hv + c] = acc[r][q];
      }
    }
  }
}

// Key columns j0..j0+31 of user b: d_k = round_T(d_s)^T q over every row and
// d_v = a^T round_T(d_attn) over the rows i >= j0 (a is 0 above the
// diagonal).
template <typename T>
__global__ void __launch_bounds__(kThreads)
softmax_bwd_cols_kernel(const T* __restrict__ y, const float* __restrict__ d_attn,
                        const float* __restrict__ ds_in, const float* __restrict__ a_in,
                        float* __restrict__ d_y, int n, int H, int dqk, int dv) {
  extern __shared__ float smem[];
  const int hq = H * dqk, hv = H * dv, F = 2 * hv + 2 * hq;
  float* dsc = smem;                           // [kKc][kLdA] round_T(d_s) rows of the chunk
  float* ac = dsc + kKc * kLdA;                // [kKc][kLdA] a rows of the chunk
  float* qc = ac + kKc * kLdA;                 // [kKc][kLdB] q rows
  float* dc = qc + kKc * kLdB;                 // [kKc][kLdB] round_T(d_attn) rows

  const int b = blockIdx.y, j0 = blockIdx.x * kSmCols, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int cols = min(kSmCols, n - j0);
  const int64_t row0 = static_cast<int64_t>(b) * n;
  const T* yb = y + row0 * F;
  const float* dab = d_attn + row0 * hv;
  const int hm = hq > hv ? hq : hv;
  float acck[4][8], accv[4][8];
  for (int c0 = 0; c0 < hm; c0 += kTileCols) {
    tile_zero(acck);
    tile_zero(accv);
    for (int i0 = 0; i0 < n; i0 += kKc) {
      const int rows = min(kKc, n - i0);
      const bool need_v = i0 + rows > j0;
      __syncthreads();
      for (int e = tid; e < kKc * kTileRows; e += kThreads) {
        const int ii = e / kTileRows, jj = e % kTileRows;
        const int64_t g = (row0 + i0 + ii) * n + j0 + jj;
        const bool in = ii < rows && jj < cols;
        dsc[ii * kLdA + jj] = in ? round_to<T>(ds_in[g]) : 0.f;
        ac[ii * kLdA + jj] = in ? a_in[g] : 0.f;
      }
      fill_rows(qc, i0, n, c0, hq, tid, [&](int i, int c) {
        return to_f<T>(yb[static_cast<int64_t>(i) * F + 2 * hv + c]);
      });
      if (need_v) {
        fill_rows(dc, i0, n, c0, hv, tid, [&](int i, int c) {
          return round_to<T>(dab[static_cast<int64_t>(i) * hv + c]);
        });
      }
      __syncthreads();
      tile_fma<true>(dsc, kLdA, qc, rows, warp, lane, acck);
      if (need_v) tile_fma<true>(ac, kLdA, dc, rows, warp, lane, accv);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int jj = 4 * warp + r;
      if (jj >= cols) continue;
      float* dyj = d_y + (row0 + j0 + jj) * F;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = c0 + tile_col(lane, q);
        if (c < hq) dyj[2 * hv + hq + c] = acck[r][q];
        if (c < hv) dyj[hv + c] = accv[r][q];
      }
    }
  }
}

template <typename T, bool ADROP>
cudaError_t launch_rows(const T* y, const float* d_attn, const float* colmask,
                        const float* rel_pos, const int* ext, const float* tsw, float* d_y,
                        float* ds, float* a, int B, int n, int H, int dqk, int dv,
                        float inv_sqrt_dqk, int max_bucket, Dropout adp, cudaStream_t s) {
  const size_t smem = rows_smem_bytes(n);
  cudaError_t err = allow_smem(softmax_bwd_rows_kernel<T, ADROP>, smem);
  if (err != cudaSuccess) return err;
  softmax_bwd_rows_kernel<T, ADROP><<<dim3((n + kSmRows - 1) / kSmRows, B), kThreads, smem, s>>>(
      y, d_attn, colmask, rel_pos, ext, tsw, d_y, ds, a, n, H, dqk, dv, inv_sqrt_dqk, max_bucket,
      adp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t softmax_bwd(const T* y, const T* d_o, float* attn, bool recompute,
                        const float* colmask, const float* rel_pos, const int* ext,
                        const float* tsw, float* d_attn, float* a, float* d_y, float* ds, int B,
                        int n, int H, int dqk, int dv, float inv_sqrt_dqk, float eps,
                        int max_bucket, TrainVariant v, Dropout adp, cudaStream_t s) {
  const int F = 2 * H * dv + 2 * H * dqk;
  const int64_t M = static_cast<int64_t>(B) * n;
  if (M == 0) return cudaSuccess;
  cudaError_t err;
  if (recompute &&
      (err = train_attn<T, T>(y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, 1.f,
                              inv_sqrt_dqk, max_bucket, v, adp, s)) != cudaSuccess) {
    return err;
  }
  if ((err = launch_row_bwd<T>(attn, d_o, y, F, d_y, d_attn, M, H * dv, eps, v.concat_ua != 0,
                               s)) != cudaSuccess) {
    return err;
  }
  err = adp.drop ? launch_rows<T, true>(y, d_attn, colmask, rel_pos, ext, tsw, d_y, ds, a, B, n,
                                        H, dqk, dv, inv_sqrt_dqk, max_bucket, adp, s)
                 : launch_rows<T, false>(y, d_attn, colmask, rel_pos, ext, tsw, d_y, ds, a, B, n,
                                         H, dqk, dv, inv_sqrt_dqk, max_bucket, adp, s);
  if (err != cudaSuccess) return err;
  const size_t smem = cols_smem_bytes();
  if ((err = allow_smem(softmax_bwd_cols_kernel<T>, smem)) != cudaSuccess) return err;
  softmax_bwd_cols_kernel<T><<<dim3((n + kSmCols - 1) / kSmCols, B), kThreads, smem, s>>>(
      y, d_attn, ds, a, d_y, n, H, dqk, dv);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails

// K4 attention-core backward, softmax_rel_bias. y (B, n, F) and d_o (B, n,
// H*dv, or 3*H*dv with concat_ua) stored in the dtype (0 = float32,
// 1 = bfloat16); attn (B, n, H*dv) f32, the forward's (float32) or recomputed
// here (bfloat16). rel_pos, ext and tsw build the bias in-kernel: zero tables
// without it (has_bias picks the recompute's instance, the forward's).
// Outputs: d_y (B, n, F) f32 and ds (B, n, n) f32, the dbias of the JAX
// kernel (the caller drops it without the bias). d_attn (B, n, H*dv) and a
// (B, n, n) f32 are scratch. adrop: the head-0 attention keep mask of seed0
// (athresh, ascale).
extern "C" int rails_hstu_softmax_train_bwd(int dtype, const void* y, const void* d_o,
                                            float* attn, const float* colmask,
                                            const float* rel_pos, const int* ext,
                                            const float* tsw, float* d_attn, float* a,
                                            float* d_y, float* ds, int B, int n, int H, int dqk,
                                            int dv, float inv_sqrt_dqk, float eps,
                                            int max_bucket, int concat_ua, int has_bias,
                                            int adrop, int seed0, unsigned athresh,
                                            float ascale, void* stream) {
  const rails::Dropout adp{adrop, n, seed0, athresh, ascale};
  const rails::TrainVariant v{0, 1, concat_ua, has_bias};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::softmax_bwd(static_cast<const __nv_bfloat16*>(y),
                              static_cast<const __nv_bfloat16*>(d_o), attn, true, colmask,
                              rel_pos, ext, tsw, d_attn, a, d_y, ds, B, n, H, dqk, dv,
                              inv_sqrt_dqk, eps, max_bucket, v, adp, s);
  }
  if (dtype == 0) {
    return rails::softmax_bwd(static_cast<const float*>(y), static_cast<const float*>(d_o), attn,
                              false, colmask, rel_pos, ext, tsw, d_attn, a, d_y, ds, B, n, H,
                              dqk, dv, inv_sqrt_dqk, eps, max_bucket, v, adp, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_hstu_softmax_train_bwd_smem_bytes(int n, int H, int dqk, int dv) {
  (void)H, (void)dqk, (void)dv;
  const size_t rows = rails::rows_smem_bytes(n);
  const size_t cols = rails::cols_smem_bytes();
  return rows > cols ? rows : cols;
}
