// One HSTU block forward: the device code shared by the serving block (K1,
// hstu_block.cu), the training block's forward (K4, hstu_block_train.cu) and
// the encode cost probe (P1, encode_probe.cu).
//
// Replaces the body `_kernel` of rails_tpu/ops/pallas/hstu_block.py and
// `_fwd_kernel` of rails_tpu/ops/pallas/hstu_block_train.py: LayerNorm ->
// x @ uvqk -> SiLU (or none) -> attention -> o_input -> @ Wo + bo + x, where
// the attention is
//   - pointwise SiLU (rel_bias, hstu_rel_bias): per head, with the bias built
//     on the fly from the relative-position slab and the time-bucket table
//     (internal bias), read from a precomputed (B, n, n) tensor in x's type,
//     or absent; causal x column-valid mask and 1/max_seq_len folded into v;
//   - softmax (softmax_rel_bias): ONE (n, n) map over the full h*dqk
//     contraction shared by every value head, the bias added before the
//     1/sqrt(dqk) scale, the softmax over every column and the mask applied
//     after normalisation;
// and o_input is u * LayerNorm(attn) [x dropout keep mask], or, with
// concat_ua, [u, LN(attn), u * LN(attn)] against an o_kernel of 3*h*dv rows.
//
// The TPU kernel keeps a whole user's (n, F) projection in VMEM. At serving
// geometry (n=211, F=1024) that is 864 KB in f32, far over the 227 KB of shared
// memory a Hopper block can hold, so the block runs as three launches:
//   1. ln_gemm<kProj>: Y = act(LN(x) @ uvqk), a tiled GEMM whose A-tile loader
//      normalises rows on the fly; Y (B*n, F) f32 goes to device memory.
//   2. the attention, writing attn (B*n, h*dv) f32. Pointwise: hstu_attn, one
//      block per (head, user); it stages that head's q, k and v = v/max_seq_len
//      (n x 32 each) in shared memory and runs one query row per warp: lanes
//      over key columns for the scores, then lanes over value columns for
//      a @ v. Softmax: hstu_softmax_attn, one block per (user, 32 query rows),
//      because a whole user's k and v in f32 (n x h*dqk, n x h*dv: 216 KB each
//      at n=211, h*dqk=256) do not fit a block. It streams k in chunks of 32
//      rows for the (32, n) scores, which stay in shared memory; normalises
//      each row over all n columns, rounds a = e / S * mask to the matmul type
//      (the JAX kernel rounds the normalised, masked a before a @ v, so an
//      online rescaling would round elsewhere); then streams v in chunks for
//      a @ v over all h*dv columns. No (B, n, n) tensor exists.
//   3. ln_gemm<kOut>: out = o_input @ Wo + bo + x. Its A-loader builds o_input
//      from attn's LayerNorm statistics (computed once per row over the h*dv
//      columns) and u, for K = h*dv or, with concat_ua, K = 3*h*dv columns
//      [u | LN(a) | u*LN(a)]; the K3 keep mask of the train forward indexes
//      row position * K + column, whichever the layout. The serving call
//      passes no dropout.
// The probe-only switches (kProbeIdent, kProbeFromV, kBiasRelPos, a linear
// attention gate) are template arguments whose defaults leave K1's and K4's
// instances as they are; only encode_probe.cu instantiates them. So is the
// train block's attention dropout (ADROP: the weights times the per-head K3
// stream after the mask, before the rounding), which only K4 instantiates;
// K4's forward (`launch`) runs every train variant with K1's kernels.
// Bound: at serving shapes the FLOPs (2*n*D*F + 4*h*n^2*dqk + 2*n*h*dv*D per
// user; softmax 4*n^2*h*dqk, the map shared by the heads) dominate the bytes,
// so these kernels are bound by the FP32 FMA rate of the CUDA cores; the Y
// round trip adds ~0.9 GB of traffic per layer at B=512, n=211, and a
// precomputed bias 45 MB (bf16). They run K1's f32 instances, its bf16
// instances outside `tc_block` (ops/hstu_block.py: other widths, and the
// linear activation), K4's forward off its tensor-core routes and the bf16
// train backward's recompute of attn. K1's bf16 instances run on the tensor cores
// (hstu_block_tc.cuh: mma.sync GEMMs and attention, q, k and v stored in bf16,
// the bias built once for all heads), and so does K4's bf16 forward at those
// widths with the SiLU projection (hstu_block_tc.cuh's TRAIN instances;
// its pointwise backward is hstu_train_tc.cuh).
#pragma once

#include <cmath>
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

// Loader and epilogue switches of ln_gemm_kernel, OR-ed into its VAR argument.
constexpr int kGemmPlain = 0;
constexpr int kActNone = 1;     // kProj: Y = LN(x) @ uvqk, no SiLU (linear_activation="none")
constexpr int kConcatUA = 2;    // kOut: A' = [u | LN(a) | u*LN(a)], K = 3 * (h*dv)
constexpr int kProbeFromV = 4;  // kOut, probe only: a = round_T(v * a_scale), v read from Y
constexpr int kProbeIdent = 8;  // kProj, probe only: out = (LN(x) @ W)[:, :lda] + x, in x's
                                // type; all N columns computed, the rest dropped

// Where the attention's additive bias comes from.
enum Bias {
  kBiasInternal = 0,  // rel_pos[i, j] + tsw[bucket(ext[i+1] - ext[j])], built on the fly
  kBiasTensor = 1,    // a precomputed (B, n, n) bias in x's type (mask_in_bias or raw)
  kBiasNone = 2,      // no relative-attention bias
  kBiasRelPos = 3,    // probe only: rel_pos without the time term
};

// A dropout stream of the train forward: the o_input mask (K3 in the output
// GEMM's loader) or the attention-weight mask (in the attention kernels, under
// their ADROP switch). A zero-initialised Dropout (no drop) leaves the serving
// block exactly as it is.
struct Dropout {
  int drop;          // 1: multiply by the K3 keep mask
  int n_per_user;    // rows per batch row: the o_input mask's user index is row / n
  int seed0;         // the layer's seed (int32)
  uint32_t thresh;   // min(int(rate * 2^31), 2^31 - 1)
  float scale;       // f32(1 / (1 - rate))
};

// Element (row, k) of the raw A operand: x (T) for kProj, attn (f32) for kOut
// (with kProbeFromV, v of Y scaled and rounded as the probe's noattn mode).
template <typename T, int MODE, int VAR>
__device__ __forceinline__ float load_a(const void* a, int lda, int64_t row, int k,
                                        float a_scale) {
  if constexpr (MODE == kProj) {
    return to_f<T>(static_cast<const T*>(a)[row * lda + k]);
  } else if constexpr ((VAR & kProbeFromV) != 0) {
    return round_to<T>(static_cast<const float*>(a)[row * lda + k] * a_scale);
  } else {
    return static_cast<const float*>(a)[row * lda + k];
  }
}

// C[M, N] = A'[M, K] @ W[K, N] with A' = LN(A) (kProj) or the o_input built
// from LN(A) and u (kOut), the latter times the keep mask when dropout is on,
// rounded to T as the JAX kernel casts it before the product. A is (M, ka)
// with row stride lda; its LayerNorm statistics run over its ka columns. W
// has row stride ldw.
template <typename T, int MODE, int VAR = kGemmPlain>
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const void* __restrict__ a, int lda, int ka, const float* __restrict__ u,
               int ldu, const T* __restrict__ w, int ldw, const float* __restrict__ bias,
               const T* __restrict__ resid, void* __restrict__ out, int M, int N, int K,
               float eps, float a_scale, Dropout dp) {
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
      for (int k = lane; k < ka; k += 32) s += load_a<T, MODE, VAR>(a, lda, row, k, a_scale);
      mean = warp_sum(s) / ka;
      float v = 0.f;
      for (int k = lane; k < ka; k += 32) {
        const float d = load_a<T, MODE, VAR>(a, lda, row, k, a_scale) - mean;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / ka + eps);
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
        if constexpr (MODE == kOut && (VAR & kConcatUA) != 0) {
          // Column k of [u | LN(a) | u*LN(a)]: part k / ka, column k % ka.
          const int part = k / ka, c = k - part * ka;
          const float uc = u[row * ldu + c];
          if (part == 0) {
            v = uc;
          } else {
            const float an = (load_a<T, MODE, VAR>(a, lda, row, c, a_scale) - mu[r]) * rs[r];
            v = part == 1 ? an : uc * an;
          }
        } else {
          v = (load_a<T, MODE, VAR>(a, lda, row, k, a_scale) - mu[r]) * rs[r];
          if constexpr (MODE == kOut) v *= u[row * ldu + k];
        }
        if constexpr (MODE == kOut) {
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
      Ws[kk][c] = (k < K && col < N) ? to_f<T>(w[static_cast<int64_t>(k) * ldw + col]) : 0.f;
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
        if constexpr ((VAR & kProbeIdent) != 0) {
          if (col < lda) {  // out and resid are (M, lda)
            const int64_t oi = row * lda + col;
            static_cast<T*>(out)[oi] = from_f<T>(acc[i][j] + to_f<T>(resid[oi]));
          }
        } else if constexpr ((VAR & kActNone) != 0) {
          static_cast<float*>(out)[o] = acc[i][j];
        } else {
          static_cast<float*>(out)[o] = silu(acc[i][j]);
        }
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
// from the bf16-rounded projection, as the JAX backward does. BIAS picks the
// additive bias; ACT false is the probe's linear gate (a = qk). With a
// precomputed bias that folds the -30000 penalty in (mask_in_bias) SiLU is
// exactly 0 at every masked pair, so the causal loop bound and the column
// multiply below change nothing there. ADROP (the train block's attention
// dropout) multiplies each weight after the mask by the keep mask of the
// (user, head) stream `adp` (`_attn_dropout_mask`), before the rounding.
template <typename T, typename Y = float, int BIAS = kBiasInternal, bool ACT = true,
          bool ADROP = false>
__global__ void __launch_bounds__(kThreads)
hstu_attn_kernel(const Y* __restrict__ y, const float* __restrict__ colmask,
                 const float* __restrict__ rel_pos, const int* __restrict__ ext,
                 const float* __restrict__ tsw, float* __restrict__ attn, int n, int H,
                 int dqk, int dv, float inv_n, int max_bucket, const T* __restrict__ bias,
                 Dropout adp) {
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
  if constexpr (BIAS == kBiasInternal) {
    for (int j = tid; j <= n; j += kThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
    for (int t = tid; t < 128; t += kThreads) tw[t] = tsw[t];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t aseed = ADROP ? attn_seed(adp.seed0, b, hd) : 0u;
  float* a_row = ab + warp * n;
  for (int i = warp; i < n; i += kWarps) {
    const float* qi = qs + i * dqk;
    const float* rp = rel_pos + static_cast<int64_t>(i) * n;
    const int nxt = BIAS == kBiasInternal ? ex[i + 1] : 0;
    for (int j = lane; j <= i; j += 32) {
      float s = 0.f;
      for (int d = 0; d < dqk; ++d) s = fmaf(qi[d], kt[d * ldk + j], s);
      if constexpr (BIAS == kBiasInternal) {
        s += rp[j] + tw[time_bucket(nxt, ex[j], max_bucket)];
      } else if constexpr (BIAS == kBiasRelPos) {
        s += rp[j];
      } else if constexpr (BIAS == kBiasTensor) {
        s += to_f<T>(bias[(static_cast<int64_t>(b) * n + i) * n + j]);
      }
      float a = (ACT ? silu(s) : s) * cm[j];
      if constexpr (ADROP) {
        a *= keep_scale(static_cast<uint32_t>(i * n + j), aseed, adp.thresh, adp.scale);
      }
      a_row[j] = round_to<T>(a);
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

// The softmax attention: query rows per block and key/value rows per chunk.
constexpr int kSmRows = 32;
constexpr int kSmCols = 32;
constexpr int kSmRowsPerWarp = kSmRows / kWarps;

size_t softmax_smem_bytes(int n, int H, int dqk, int dv) {
  const size_t hq = static_cast<size_t>(H) * dqk, hv = static_cast<size_t>(H) * dv;
  const size_t chunk = hq * (kSmCols + 1) > hv * kSmCols ? hq * (kSmCols + 1) : hv * kSmCols;
  const size_t floats = kSmRows * hq + chunk + static_cast<size_t>(kSmRows) * n + n + 128;
  return floats * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
}

// softmax_rel_bias: attn[i] = sum_j round_T(softmax_j(((q_i . k_j) + bias_ij)
// * inv_sqrt_dqk) * mask_ij) * round_T(v_j) over the whole h*dqk contraction
// and all h*dv value columns (the Pallas body's `if softmax` branch). The
// denominator covers every column, masked and future ones included; the mask
// (causal x column-valid) multiplies after normalisation, so a @ v skips the
// columns past the block's last row, where every a is 0. Y is y's storage
// type (bf16 in the bf16 train backward's recompute); ADROP multiplies a after
// the mask by the keep mask of the user's head-0 attention stream.
template <typename T, int BIAS, typename Y = float, bool ADROP = false>
__global__ void __launch_bounds__(kThreads)
hstu_softmax_attn_kernel(const Y* __restrict__ y, const float* __restrict__ colmask,
                         const float* __restrict__ rel_pos, const int* __restrict__ ext,
                         const float* __restrict__ tsw, const T* __restrict__ bias,
                         float* __restrict__ attn, int n, int H, int dqk, int dv,
                         float inv_sqrt_dqk, int max_bucket, Dropout adp) {
  extern __shared__ float smem[];
  const int hq = H * dqk, hv = H * dv, F = 2 * hv + 2 * hq;
  constexpr int ldc = kSmCols + 1;             // odd stride of the transposed k chunk
  const int chunk = hq * ldc > hv * kSmCols ? hq * ldc : hv * kSmCols;
  float* qs = smem;                            // [kSmRows][hq]  q rows of the block
  float* kv = qs + kSmRows * hq;               // [hq][ldc] k chunk transposed, then [kSmCols][hv] v
  float* sc = kv + chunk;                      // [kSmRows][n]   scores, then a
  float* cm = sc + kSmRows * n;                // [n]
  float* tw = cm + n;                          // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);  // [n + 1]

  const int b = blockIdx.y, i0 = blockIdx.x * kSmRows, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rows = min(kSmRows, n - i0);
  const Y* yb = y + static_cast<int64_t>(b) * n * F;
  for (int e = tid; e < kSmRows * hq; e += kThreads) {
    const int r = e / hq, d = e % hq;
    qs[e] = r < rows ? round_to<T>(to_f<Y>(yb[static_cast<int64_t>(i0 + r) * F + 2 * hv + d]))
                     : 0.f;
  }
  for (int j = tid; j < n; j += kThreads) cm[j] = colmask[static_cast<int64_t>(b) * n + j];
  if constexpr (BIAS == kBiasInternal) {
    for (int j = tid; j <= n; j += kThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
    for (int t = tid; t < 128; t += kThreads) tw[t] = tsw[t];
  }

  // Scores: lanes over the chunk's key rows, each warp kSmRowsPerWarp query rows.
  for (int j0 = 0; j0 < n; j0 += kSmCols) {
    const int cols = min(kSmCols, n - j0);
    __syncthreads();
    for (int e = tid; e < cols * hq; e += kThreads) {
      const int c = e / hq, d = e % hq;
      kv[d * ldc + c] = round_to<T>(to_f<Y>(yb[static_cast<int64_t>(j0 + c) * F + 2 * hv + hq + d]));
    }
    __syncthreads();
    if (lane < cols) {
      float s[kSmRowsPerWarp] = {};
      for (int d = 0; d < hq; ++d) {
        const float kd = kv[d * ldc + lane];
#pragma unroll
        for (int r = 0; r < kSmRowsPerWarp; ++r) s[r] = fmaf(qs[(warp + r * kWarps) * hq + d], kd, s[r]);
      }
      const int j = j0 + lane;
#pragma unroll
      for (int r = 0; r < kSmRowsPerWarp; ++r) {
        const int i = warp + r * kWarps;
        if (i >= rows) break;
        const int gi = i0 + i;
        float v = s[r];
        if constexpr (BIAS == kBiasInternal) {
          v += rel_pos[static_cast<int64_t>(gi) * n + j] + tw[time_bucket(ex[gi + 1], ex[j], max_bucket)];
        } else if constexpr (BIAS == kBiasTensor) {
          v += to_f<T>(bias[(static_cast<int64_t>(b) * n + gi) * n + j]);
        }
        sc[i * n + j] = v * inv_sqrt_dqk;
      }
    }
  }
  __syncthreads();

  // Normalise each row over all n columns, then mask and round: a warp per row.
  for (int i = warp; i < rows; i += kWarps) {
    float* row = sc + i * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float ssum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      ssum += e;
    }
    ssum = warp_sum(ssum);
    const int gi = i0 + i;
    for (int j = lane; j < n; j += 32) {
      const float mask = j <= gi ? cm[j] : 0.f;
      float a = row[j] / ssum * mask;
      if constexpr (ADROP) {
        a *= keep_scale(static_cast<uint32_t>(gi * n + j), attn_seed(adp.seed0, b, 0),
                        adp.thresh, adp.scale);
      }
      row[j] = round_to<T>(a);
    }
  }

  // a @ v: thread c owns value column c of every row of the block.
  const int jmax = i0 + rows;
  for (int c0 = 0; c0 < hv; c0 += kThreads) {
    const int c = c0 + tid;
    float acc[kSmRows] = {};
    for (int j0 = 0; j0 < jmax; j0 += kSmCols) {
      const int cols = min(kSmCols, jmax - j0);
      __syncthreads();
      for (int e = tid; e < cols * hv; e += kThreads) {
        const int jj = e / hv, d = e % hv;
        kv[e] = round_to<T>(to_f<Y>(yb[static_cast<int64_t>(j0 + jj) * F + hv + d]));
      }
      __syncthreads();
      if (c < hv) {
        for (int jj = 0; jj < cols; ++jj) {
          const float vv = kv[jj * hv + c];
#pragma unroll
          for (int r = 0; r < kSmRows; ++r) acc[r] = fmaf(sc[r * n + j0 + jj], vv, acc[r]);
        }
      }
    }
    if (c < hv) {
      for (int r = 0; r < rows; ++r) attn[(static_cast<int64_t>(b) * n + i0 + r) * hv + c] = acc[r];
    }
  }
}

inline dim3 gemm_grid(int N, int M) { return dim3((N + BN - 1) / BN, (M + BM - 1) / BM); }

// Launch 1: y (M, F) f32 = act(LN(x) @ uvqk).
template <typename T, int VAR>
cudaError_t launch_proj(const void* x, const void* uvqk, float* y, int M, int F, int D,
                        float eps, cudaStream_t stream) {
  ln_gemm_kernel<T, kProj, VAR><<<gemm_grid(F, M), kThreads, 0, stream>>>(
      x, D, D, nullptr, 0, static_cast<const T*>(uvqk), F, nullptr, nullptr, y, M, F, D, eps,
      1.f, Dropout{});
  return cudaGetLastError();
}

// Launch 3: out (M, D) in T = o_input @ Wo + bo + x, o_input built from a
// (M, ka) with row stride lda and from u, the first ka columns of y.
template <typename T, int VAR>
cudaError_t launch_out(const float* a, int lda, int ka, float a_scale, const float* y, int F,
                       const void* o_kernel, const float* o_bias, const void* x, void* out,
                       int M, int D, float eps, Dropout dp, cudaStream_t stream) {
  const int K = (VAR & kConcatUA) != 0 ? 3 * ka : ka;
  ln_gemm_kernel<T, kOut, VAR><<<gemm_grid(D, M), kThreads, 0, stream>>>(
      a, lda, ka, y, F, static_cast<const T*>(o_kernel), D, o_bias, static_cast<const T*>(x),
      out, M, D, K, eps, a_scale, dp);
  return cudaGetLastError();
}

// Launch 2, pointwise SiLU attention (or the probe's linear gate), over y
// stored as Y, with the train block's attention dropout `adp` under ADROP.
template <typename T, int BIAS, bool ACT = true, typename Y = float, bool ADROP = false>
cudaError_t launch_attn(const Y* y, const float* colmask, const float* rel_pos,
                        const int* ext, const float* tsw, const void* bias, float* attn, int B,
                        int n, int H, int dqk, int dv, float inv_n, int max_bucket,
                        cudaStream_t stream, Dropout adp = Dropout{}) {
  const size_t smem = attn_smem_bytes(n, dqk, dv);
  cudaError_t err = allow_smem(hstu_attn_kernel<T, Y, BIAS, ACT, ADROP>, smem);
  if (err != cudaSuccess) return err;
  hstu_attn_kernel<T, Y, BIAS, ACT, ADROP><<<dim3(H, B), kThreads, smem, stream>>>(
      y, colmask, rel_pos, ext, tsw, attn, n, H, dqk, dv, inv_n, max_bucket,
      static_cast<const T*>(bias), adp);
  return cudaGetLastError();
}

// Launch 2, softmax attention; Y, ADROP and `adp` as in launch_attn.
template <typename T, int BIAS, typename Y = float, bool ADROP = false>
cudaError_t launch_softmax(const Y* y, const float* colmask, const float* rel_pos,
                           const int* ext, const float* tsw, const void* bias, float* attn,
                           int B, int n, int H, int dqk, int dv, float inv_sqrt_dqk,
                           int max_bucket, cudaStream_t stream, Dropout adp = Dropout{}) {
  const size_t smem = softmax_smem_bytes(n, H, dqk, dv);
  cudaError_t err = allow_smem(hstu_softmax_attn_kernel<T, BIAS, Y, ADROP>, smem);
  if (err != cudaSuccess) return err;
  hstu_softmax_attn_kernel<T, BIAS, Y, ADROP>
      <<<dim3((n + kSmRows - 1) / kSmRows, B), kThreads, smem, stream>>>(
          y, colmask, rel_pos, ext, tsw, static_cast<const T*>(bias), attn, n, H, dqk, dv,
          inv_sqrt_dqk, max_bucket, adp);
  return cudaGetLastError();
}

// A train block's variant: the flags of `make_fused_train_block`.
struct TrainVariant {
  int act_none;   // linear_activation="none": y = LN(x) @ uvqk, no SiLU
  int softmax;    // softmax_rel_bias: one map over h*dqk (hstu_softmax_attn_kernel)
  int concat_ua;  // o_input = [u, LN(a), u*LN(a)] against 3*h*dv rows of Wo
  int has_bias;   // the relative-attention bias, built in-kernel; else none
};

// The train block's attention over y stored as Y: launch 2 of the forward
// (Y = f32), and the bf16 backward's recompute of attn (Y = bf16, as the JAX
// backward recomputes it from the bf16 y); pointwise or softmax, the bias
// built in-kernel or none (the pointwise map is then SiLU(q.k) over the
// causal, valid pairs, which the JAX kernel's -30000 penalty makes exactly 0
// elsewhere, and the softmax map has a zero bias), with or without attention
// dropout.
template <typename T, typename Y, int BIAS, bool ADROP>
cudaError_t train_attn_instance(const Y* y, const float* colmask, const float* rel_pos,
                                const int* ext, const float* tsw, float* attn, int B, int n,
                                int H, int dqk, int dv, float inv_n, float inv_sqrt_dqk,
                                int max_bucket, bool softmax, Dropout adp, cudaStream_t s) {
  if (softmax) {
    return launch_softmax<T, BIAS, Y, ADROP>(y, colmask, rel_pos, ext, tsw, nullptr, attn, B, n,
                                             H, dqk, dv, inv_sqrt_dqk, max_bucket, s, adp);
  }
  return launch_attn<T, BIAS, true, Y, ADROP>(y, colmask, rel_pos, ext, tsw, nullptr, attn, B, n,
                                              H, dqk, dv, inv_n, max_bucket, s, adp);
}

// The train block's attention: the instance of the variant's bias and
// attention-dropout switches.
template <typename T, typename Y>
cudaError_t train_attn(const Y* y, const float* colmask, const float* rel_pos, const int* ext,
                       const float* tsw, float* attn, int B, int n, int H, int dqk, int dv,
                       float inv_n, float inv_sqrt_dqk, int max_bucket, TrainVariant v,
                       Dropout adp, cudaStream_t s) {
  const bool sm = v.softmax != 0;
  if (v.has_bias) {
    return adp.drop ? train_attn_instance<T, Y, kBiasInternal, true>(
                          y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n,
                          inv_sqrt_dqk, max_bucket, sm, adp, s)
                    : train_attn_instance<T, Y, kBiasInternal, false>(
                          y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n,
                          inv_sqrt_dqk, max_bucket, sm, adp, s);
  }
  return adp.drop ? train_attn_instance<T, Y, kBiasNone, true>(
                        y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n,
                        inv_sqrt_dqk, max_bucket, sm, adp, s)
                  : train_attn_instance<T, Y, kBiasNone, false>(
                        y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n,
                        inv_sqrt_dqk, max_bucket, sm, adp, s);
}

// K4's forward: the block's three launches for the variant `v`, with the
// o_input keep mask `dp` in the output GEMM's loader (over 3*h*dv columns
// under concat_ua) and the attention keep mask `adp` in the attention kernel.
// attn (B*n, H*dv) f32 is left in device memory, where the f32 backward reads
// it. The default variant (SiLU, internal bias, no attention dropout) runs the
// instances K4 ran before its variants were ported.
template <typename T>
cudaError_t launch(const void* x, const float* colmask, const void* uvqk, const void* o_kernel,
                   const float* o_bias, const float* rel_pos, const int* ext, const float* tsw,
                   float* y, float* attn, void* out, int B, int n, int D, int H, int dqk,
                   int dv, float inv_n, float inv_sqrt_dqk, float eps, int max_bucket,
                   TrainVariant v, Dropout dp, Dropout adp, cudaStream_t stream) {
  const int F = 2 * H * dv + 2 * H * dqk;
  const int M = B * n;
  cudaError_t err = v.act_none ? launch_proj<T, kActNone>(x, uvqk, y, M, F, D, eps, stream)
                               : launch_proj<T, kGemmPlain>(x, uvqk, y, M, F, D, eps, stream);
  if (err != cudaSuccess) return err;
  if ((err = train_attn<T, float>(y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n,
                                  inv_sqrt_dqk, max_bucket, v, adp, stream)) != cudaSuccess) {
    return err;
  }
  const int hv = H * dv;
  return v.concat_ua ? launch_out<T, kConcatUA>(attn, hv, hv, 1.f, y, F, o_kernel, o_bias, x,
                                                out, M, D, eps, dp, stream)
                     : launch_out<T, kGemmPlain>(attn, hv, hv, 1.f, y, F, o_kernel, o_bias, x,
                                                 out, M, D, eps, dp, stream);
}

}  // namespace
}  // namespace rails
