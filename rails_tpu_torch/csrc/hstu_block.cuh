// One HSTU block forward: the device code shared by the serving block (K1,
// hstu_block.cu) and the training block's forward (K4, hstu_block_train.cu).
//
// Replaces the body `_kernel` of rails_tpu/ops/pallas/hstu_block.py and
// `_fwd_kernel` of rails_tpu/ops/pallas/hstu_block_train.py, internal-bias
// mode: LayerNorm -> x @ uvqk -> SiLU -> per-head pointwise-SiLU attention with
// the relative-position + time-bucket bias built on the fly, causal x
// column-valid mask and 1/max_seq_len folded into v -> u * LayerNorm(attn)
// [x dropout keep mask] -> @ Wo + bo + x.
//
// The TPU kernel keeps a whole user's (n, F) projection in VMEM. At serving
// geometry (n=211, F=1024) that is 864 KB in f32, far over the 227 KB of shared
// memory a Hopper block can hold, so the block runs as three launches:
//   1. ln_gemm<kProj>: Y = silu(LN(x) @ uvqk), a tiled GEMM whose A-tile loader
//      normalises rows on the fly; Y (B*n, F) f32 goes to device memory.
//   2. hstu_attn: one block per (head, user). It stages that head's q, k and
//      v = v/max_seq_len (n x 32 each) in shared memory and runs the SiLU
//      attention one query row per warp: lanes over key columns for the scores,
//      then lanes over value columns for a @ v. No (B, n, n) tensor exists.
//   3. ln_gemm<kOut>: out = (u * LN(attn) [* keep]) @ Wo + bo + x. In training
//      the loader multiplies by the K3 keep mask (hash_dropout.cuh) of the
//      o_input stream; the serving call passes no dropout.
// Bound: at serving shapes the FLOPs (2*n*D*F + 4*h*n^2*dqk + 2*n*h*dv*D per
// user) dominate the bytes, so the kernels are bound by the FP32 FMA rate of
// the CUDA cores; the Y round trip adds ~0.9 GB of traffic per layer at B=512,
// n=211. Moving the projections onto wgmma and keeping Y on chip is later work.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
// f32(1/0.301), the constant of `_time_bucket` (hstu_block.py:81-93).
constexpr float kInvLogBase = static_cast<float>(1.0 / 0.301);

enum Mode { kProj = 0, kOut = 1 };

// The o_input dropout of the train forward. A zero-initialised Dropout (no
// drop) leaves the serving block exactly as it is.
struct Dropout {
  int drop;          // 1: multiply u * LN(attn) by the K3 keep mask
  int n_per_user;    // rows per batch row: the mask's user index is row / n
  int seed0;         // the layer's seed (int32)
  uint32_t thresh;   // min(int(rate * 2^31), 2^31 - 1)
  float scale;       // f32(1 / (1 - rate))
};

// Element (row, k) of the raw A operand: x (T) for kProj, attn (f32) for kOut.
template <typename T, int MODE>
__device__ __forceinline__ float load_a(const void* a, int ld, int64_t row, int k) {
  if constexpr (MODE == kProj) {
    return to_f<T>(static_cast<const T*>(a)[row * ld + k]);
  } else {
    return static_cast<const float*>(a)[row * ld + k];
  }
}

// C[M, N] = A'[M, K] @ W[K, N] with A' = LN(A) (kProj) or u * LN(A) (kOut),
// the latter times the keep mask when dropout is on, rounded to T as the JAX
// kernel casts it before the product.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const void* __restrict__ a, const float* __restrict__ u, int ldu,
               const T* __restrict__ w, const float* __restrict__ bias,
               const T* __restrict__ resid, void* __restrict__ out, int M, int N, int K,
               float eps, Dropout dp) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Ws[BK][BN + 4];
  __shared__ float mu[BM], rs[BM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;

  // LayerNorm statistics of the tile's rows: population variance, two passes.
  for (int r = warp; r < BM; r += kWarps) {
    const int64_t row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < M) {
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += load_a<T, MODE>(a, K, row, k);
      mean = warp_sum(s) / K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = load_a<T, MODE>(a, K, row, k) - mean;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / K + eps);
    }
    if (lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
  __syncthreads();

  const int ty = tid / (BN / TN), tx = tid % (BN / TN);
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, kk = e % BK, k = k0 + kk;
      const int64_t row = m0 + r;
      float v = 0.f;
      if (row < M && k < K) {
        v = (load_a<T, MODE>(a, K, row, k) - mu[r]) * rs[r];
        if constexpr (MODE == kOut) {
          v *= u[row * ldu + k];
          if (dp.drop) {
            const int user = static_cast<int>(row / dp.n_per_user);
            const int pos = static_cast<int>(row - static_cast<int64_t>(user) * dp.n_per_user);
            v *= keep_scale(static_cast<uint32_t>(pos * K + k), user_seed(dp.seed0, user),
                            dp.thresh, dp.scale);
          }
        }
        v = round_to<T>(v);
      }
      As[kk][r] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN, k = k0 + kk, col = n0 + c;
      Ws[kk][c] = (k < K && col < N) ? to_f<T>(w[static_cast<int64_t>(k) * N + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Ws[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + ty * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col >= N) continue;
      const int64_t o = row * N + col;
      if constexpr (MODE == kProj) {
        static_cast<float*>(out)[o] = silu(acc[i][j]);
      } else {
        static_cast<T*>(out)[o] = from_f<T>(acc[i][j] + bias[col] + to_f<T>(resid[o]));
      }
    }
  }
}

// trunc(log(max(|delta|, 1)) * (1/0.301)) clipped to [0, max_bucket]; int32
// arithmetic wraps as in the JAX kernel.
__device__ __forceinline__ int time_bucket(int nxt, int ts, int max_bucket) {
  const unsigned du = static_cast<unsigned>(nxt) - static_cast<unsigned>(ts);
  const int delta = static_cast<int>(du);
  int ad = delta < 0 ? static_cast<int>(0u - du) : delta;
  if (ad < 1) ad = 1;
  const int bk = static_cast<int>(logf(static_cast<float>(ad)) * kInvLogBase);
  return min(max(bk, 0), max_bucket);
}

size_t attn_smem_bytes(int n, int dqk, int dv) {
  const size_t ldk = static_cast<size_t>(n | 1);
  const size_t floats = dqk * ldk + static_cast<size_t>(n) * (dv + dqk + kWarps + 1) + 128;
  return floats * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
}

// T is the matmul type the products round to; Y the storage type of y: f32
// in the forward, bf16 where the bf16 train block's backward recomputes attn
// from the bf16-rounded projection, as the JAX backward does.
template <typename T, typename Y = float>
__global__ void __launch_bounds__(kThreads)
hstu_attn_kernel(const Y* __restrict__ y, const float* __restrict__ colmask,
                 const float* __restrict__ rel_pos, const int* __restrict__ ext,
                 const float* __restrict__ tsw, float* __restrict__ attn, int n, int H,
                 int dqk, int dv, float inv_n, int max_bucket) {
  extern __shared__ float smem[];
  const int ldk = n | 1;                       // odd row stride: no bank conflicts
  float* kt = smem;                            // [dqk][ldk]  k transposed
  float* vs = kt + dqk * ldk;                  // [n][dv]     v / max_seq_len
  float* qs = vs + n * dv;                     // [n][dqk]
  float* ab = qs + n * dqk;                    // [kWarps][n] one attention row per warp
  float* cm = ab + kWarps * n;                 // [n]         column validity
  float* tw = cm + n;                          // [128]       time-bucket weights
  int* ex = reinterpret_cast<int*>(tw + 128);  // [n + 1]     extended timestamps

  const int hd = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int F = 2 * H * dv + 2 * H * dqk;
  const int voff = H * dv + hd * dv;
  const int qoff = 2 * H * dv + hd * dqk;
  const int koff = 2 * H * dv + H * dqk + hd * dqk;
  const Y* yb = y + static_cast<int64_t>(b) * n * F;
  for (int e = tid; e < n * dqk; e += kThreads) {
    const int i = e / dqk, d = e % dqk;
    qs[e] = round_to<T>(to_f<Y>(yb[static_cast<int64_t>(i) * F + qoff + d]));
    kt[d * ldk + i] = round_to<T>(to_f<Y>(yb[static_cast<int64_t>(i) * F + koff + d]));
  }
  for (int e = tid; e < n * dv; e += kThreads) {
    const int i = e / dv, d = e % dv;
    vs[e] = round_to<T>(to_f<Y>(yb[static_cast<int64_t>(i) * F + voff + d]) * inv_n);
  }
  for (int j = tid; j < n; j += kThreads) cm[j] = colmask[static_cast<int64_t>(b) * n + j];
  for (int j = tid; j <= n; j += kThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
  for (int t = tid; t < 128; t += kThreads) tw[t] = tsw[t];
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  float* a_row = ab + warp * n;
  for (int i = warp; i < n; i += kWarps) {
    const float* qi = qs + i * dqk;
    const float* rp = rel_pos + static_cast<int64_t>(i) * n;
    const int nxt = ex[i + 1];
    for (int j = lane; j <= i; j += 32) {
      float s = 0.f;
      for (int d = 0; d < dqk; ++d) s = fmaf(qi[d], kt[d * ldk + j], s);
      s += rp[j] + tw[time_bucket(nxt, ex[j], max_bucket)];
      a_row[j] = round_to<T>(silu(s) * cm[j]);
    }
    __syncwarp();
    for (int d = lane; d < dv; d += 32) {
      float o = 0.f;
      for (int j = 0; j <= i; ++j) o = fmaf(a_row[j], vs[j * dv + d], o);
      attn[(static_cast<int64_t>(b) * n + i) * H * dv + hd * dv + d] = o;
    }
    __syncwarp();
  }
}

// The block's three launches; attn (B*n, H*dv) f32 is left in device memory,
// where the train block's backward reads it.
template <typename T>
cudaError_t launch(const void* x, const float* colmask, const void* uvqk, const void* o_kernel,
                   const float* o_bias, const float* rel_pos, const int* ext, const float* tsw,
                   float* y, float* attn, void* out, int B, int n, int D, int H, int dqk,
                   int dv, float inv_n, float eps, int max_bucket, Dropout dp,
                   cudaStream_t stream) {
  const int F = 2 * H * dv + 2 * H * dqk;
  const int M = B * n;
  cudaError_t err;
  ln_gemm_kernel<T, kProj><<<dim3((F + BN - 1) / BN, (M + BM - 1) / BM), kThreads, 0, stream>>>(
      x, nullptr, 0, static_cast<const T*>(uvqk), nullptr, nullptr, y, M, F, D, eps, Dropout{});
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = attn_smem_bytes(n, dqk, dv);
  if ((err = allow_smem(hstu_attn_kernel<T, float>, smem)) != cudaSuccess) return err;
  hstu_attn_kernel<T, float><<<dim3(H, B), kThreads, smem, stream>>>(
      y, colmask, rel_pos, ext, tsw, attn, n, H, dqk, dv, inv_n, max_bucket);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ln_gemm_kernel<T, kOut><<<dim3((D + BN - 1) / BN, (M + BM - 1) / BM), kThreads, 0, stream>>>(
      attn, y, F, static_cast<const T*>(o_kernel), o_bias, static_cast<const T*>(x), out, M, D,
      H * dv, eps, dp);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails
