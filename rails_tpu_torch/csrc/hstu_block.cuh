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
//      normalises rows on the fly (their statistics from ln_stats, a pass
//      over x that writes them into attn's memory before the attention
//      needs it); Y (B*n, F) f32 goes to device memory.
//   2. the attention, writing attn (B*n, h*dv) f32. Pointwise: hstu_attn, one
//      block of 16 warps per (head, user) that stages the head's q, k and v =
//      v/max_seq_len for all n positions; each warp takes groups of 8 query
//      rows on its own, lanes over 32 keys at a time for the scores and over
//      value columns for a @ v. Heads whose staging passes a block's shared
//      memory, or dv > 64, run hstu_attn_chunked instead: one block per (64
//      query rows, head, user), 64-key chunks, 4 x 4 register tiles. Softmax:
//      hstu_softmax_attn, one block per (user, 32 query rows),
//      because a whole user's k and v in f32 (n x h*dqk, n x h*dv: 216 KB each
//      at n=211, h*dqk=256) do not fit a block. It streams k in chunks of 32
//      rows for the (32, n) scores, which stay in shared memory; normalises
//      each row over all n columns, rounds a = e / S * mask to the matmul type
//      (the JAX kernel rounds the normalised, masked a before a @ v, so an
//      online rescaling would round elsewhere); then streams v in chunks for
//      a @ v over all h*dv columns. No (B, n, n) tensor exists.
//   3. ln_gemm<kOut>: out = o_input @ Wo + bo + x. Its A-loader builds o_input
//      from attn's LayerNorm statistics (each block computes its rows' over
//      the h*dv columns) and u, for K = h*dv or, with concat_ua, K = 3*h*dv columns
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
// so these kernels are bound by the FP32 FMA rate of the CUDA cores (67
// TFLOP/s): every output is one thread's fmaf chain (k, d or j ascending
// from +0), an order the tensor cores' k-chunked products would change, and
// linear_activation=none carries any change of order into the ranking
// (ops/hstu_block.py:tc_block). So the kernels keep those sums bit for bit
// (chip_smoke.py's `[K1-hash]` lines and profile_k4_bits.py hold them to
// it) and feed the FMA units instead of the shared-memory pipe: the GEMM's
// 128 x 128 tiles give 8 x 8 outputs a thread from float4 loads (16 FMAs a
// load) with the next k-step in flight during this one; the attention's
// warps hold 8 rows x 1 key (the scores) or 8 rows x 1 value column (a @ v)
// a lane, 8 FMAs per 3 loads, and run without barriers once the head is
// staged. The Y round trip adds ~0.9 GB of traffic per layer at B=512,
// n=211 (~0.27 ms at 3.35 TB/s), and a precomputed bias 45 MB (bf16).
// They run K1's f32 instances off the 3xTF32 route (hstu_serve_tf32.cuh),
// its bf16 instances outside `tc_block` (ops/hstu_block.py: other widths, and
// the linear activation), K4's forward off its tensor-core routes, the
// projection and output GEMM of K4's f32 softmax forward, the bf16 train
// backward's recompute of attn on those instances, and P1's f32 modes. K1's
// bf16 instances run on the tensor cores
// (hstu_block_tc.cuh: mma.sync GEMMs and attention, q, k and v stored in bf16,
// the bias built once for all heads), and so does K4's bf16 forward at those
// widths with the SiLU projection (hstu_block_tc.cuh's TRAIN instances;
// its pointwise backward is hstu_train_tc.cuh).
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hash_dropout.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// ln_gemm_kernel's block tile: GM x GN outputs, GK-deep k-steps (the first
// design's depth, so the zero operands it fed past K are fed here too); GH is
// half a tile side (a thread's second row and column group starts there).
constexpr int GM = 128, GN = 128, GK = 16, GH = 64;
// A k-step's loads a thread makes in 8-deep slots of 4 A and 4 W elements.
constexpr int kSlots = GK / 8;
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

// Element (row, k) of the raw A operand, in two halves for loaders that
// fetch ahead: fetch_a reads x (T) for kProj or attn (f32) for kOut, and
// finish_a applies kProbeFromV's scale and rounding (v of Y, as the probe's
// noattn mode) where the element is used, so that its product meets the add
// or subtraction that follows in one expression.
template <typename T, int MODE>
__device__ __forceinline__ float fetch_a(const void* a, int lda, int64_t row, int k) {
  if constexpr (MODE == kProj) {
    return to_f<T>(static_cast<const T*>(a)[row * lda + k]);
  } else {
    return static_cast<const float*>(a)[row * lda + k];
  }
}
template <typename T, int MODE, int VAR>
__device__ __forceinline__ float finish_a(float raw, float a_scale) {
  if constexpr (MODE == kOut && (VAR & kProbeFromV) != 0) {
    return round_to<T>(raw * a_scale);
  } else {
    return raw;
  }
}

// Whether rows of stride ld from p hold 4 elements of E on a 4-element
// boundary (one vector load).
template <typename E>
__device__ __forceinline__ bool aligned4(const E* p, int ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % (4 * sizeof(E)) == 0;
}

// Four consecutive elements from p (4-element aligned) as floats, in one load.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// LayerNorm statistics of the A rows [m0, m0 + GM) into mu, rs: a warp per
// row, lane-strided partial sums over the row's ka columns combined by
// warp_sum, two passes, population variance (rows past M get 0 and 0). Each
// warp runs four rows at once and loads a lane's next eight elements of each
// before it adds them, so that the loads are in flight together; every row
// keeps its own sums in the order a lone warp would take them.
template <typename T, int MODE, int VAR>
__device__ __forceinline__ void tile_stats(const void* a, int lda, int ka, float a_scale,
                                           int64_t m0, int M, float eps, float* mu, float* rs) {
  constexpr int kRows = 4, kPer = 8;  // rows a warp at once; elements a lane of each per batch
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r0 = warp * kRows; r0 < GM; r0 += kWarps * kRows) {
    bool ok[kRows];
    float s[kRows], v[kRows], mean[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      ok[q] = m0 + r0 + q < M;
      s[q] = 0.f;
      v[q] = 0.f;
    }
    // Each batch loads a lane's next kPer elements of every row first, then
    // adds them in k order.
    for (int k0 = 0; k0 < ka; k0 += 32 * kPer) {
      float e[kRows][kPer];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          const int k = k0 + lane + 32 * t;
          e[q][t] = ok[q] && k < ka ? fetch_a<T, MODE>(a, lda, m0 + r0 + q, k) : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          if (ok[q] && k0 + lane + 32 * t < ka) s[q] += finish_a<T, MODE, VAR>(e[q][t], a_scale);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) mean[q] = warp_sum(s[q]) / ka;
    for (int k0 = 0; k0 < ka; k0 += 32 * kPer) {
      float e[kRows][kPer];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          const int k = k0 + lane + 32 * t;
          e[q][t] = ok[q] && k < ka ? fetch_a<T, MODE>(a, lda, m0 + r0 + q, k) : 0.f;
        }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
#pragma unroll
        for (int t = 0; t < kPer; ++t) {
          if (ok[q] && k0 + lane + 32 * t < ka) {
            const float d = finish_a<T, MODE, VAR>(e[q][t], a_scale) - mean[q];
            v[q] = fmaf(d, d, v[q]);
          }
        }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const float rstd = rsqrtf(warp_sum(v[q]) / ka + eps);
      if (lane == 0) {
        mu[r0 + q] = ok[q] ? mean[q] : 0.f;
        rs[r0 + q] = ok[q] ? rstd : 0.f;
      }
    }
  }
}

// C[M, N] = A'[M, K] @ W[K, N] with A' = LN(A) (kProj) or the o_input built
// from LN(A) and u (kOut), the latter times the keep mask when dropout is on,
// rounded to T as the JAX kernel casts it before the product. A is (M, ka)
// with row stride lda; its LayerNorm statistics run over its ka columns, read
// from `stats` where ln_stats_kernel computed them, else computed by the
// block. W has row stride ldw. Each output is one thread's fmaf chain over k
// = 0, 1, ..., K - 1 from +0 (no split-K); the tile only decides who loads
// what. A block owns GM x GN outputs, a thread 8 x 8 of them (rows ty*4 + i
// and GH + ty*4 + i, columns tx*4 + j and GH + tx*4 + j), read as float4
// from k-major tiles: 64 FMAs per four 16-byte shared loads. A' is built once per
// element (normalised, masked, rounded) as its tile is stored; the next
// k-step's operands are loaded from device memory into registers while the
// current one is multiplied, into the other of two shared buffers, so one
// barrier a k-step.
template <typename T, int MODE, int VAR = kGemmPlain>
__global__ void __launch_bounds__(kThreads, 2)
ln_gemm_kernel(const void* __restrict__ a, int lda, int ka, const float* __restrict__ u,
               int ldu, const T* __restrict__ w, int ldw, const float* __restrict__ bias,
               const T* __restrict__ resid, void* __restrict__ out, int M, int N, int K,
               float eps, float a_scale, Dropout dp, const float2* __restrict__ stats) {
  constexpr bool kUA = MODE == kOut && (VAR & kConcatUA) != 0;
  __shared__ __align__(16) float As[2][GK][GM + 4];  // A' k-major; +4: the two k halves' banks
  __shared__ __align__(16) float Ws[2][GK][GN];
  __shared__ float mu[GM], rs[GM];
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * GM;
  const int n0 = blockIdx.x * GN;
  if (stats != nullptr) {  // ln_stats_kernel's, the same sums
    for (int r = tid; r < GM; r += kThreads) {
      const float2 st = m0 + r < M ? stats[m0 + r] : make_float2(0.f, 0.f);
      mu[r] = st.x;
      rs[r] = st.y;
    }
  } else {
    tile_stats<T, MODE, VAR>(a, lda, ka, a_scale, m0, M, eps, mu, rs);
  }
  __syncthreads();

  // Loader roles, per 8-deep slot of a k-step: A' row ar, columns ak..ak+3;
  // W row wk, columns wc..wc+3. Four consecutive elements load as one vector
  // where the row strides and base addresses allow it and all four are in
  // range, else one by one.
  using TA = std::conditional_t<MODE == kProj, T, float>;
  const int ar = tid >> 1, ak = (tid & 1) * 4, wk = tid >> 5, wc = (tid & 31) * 4;
  const int64_t arow = m0 + ar;
  const bool row_ok = arow < M;
  const bool vec_a = row_ok && aligned4(static_cast<const TA*>(a), lda) &&
                     (MODE == kProj || aligned4(u, ldu)) && (!kUA || ka % 4 == 0);
  const bool vec_w = aligned4(w, ldw);
  // The o_input keep mask's stream and row position (a row's user is fixed).
  int drop_pos = 0;
  uint32_t drop_seed = 0;
  if (MODE == kOut && dp.drop && row_ok) {
    const int user = static_cast<int>(arow / dp.n_per_user);
    drop_pos = static_cast<int>(arow - static_cast<int64_t>(user) * dp.n_per_user);
    drop_seed = user_seed(dp.seed0, user);
  }
  float sa[kSlots][4], su[kSlots][4], sw[kSlots][4];  // a k-step's raw A, u and W elements
  auto fetch_slot = [&](int k0, float (&ra)[4], float (&ru)[4], float (&rw)[4]) {
    const int kb = k0 + ak;
    if (vec_a && kb + 4 <= K) {
      if constexpr (kUA) {
        // Columns kb.. of [u | LN(a) | u*LN(a)]: part kb / ka, columns kb % ka..
        const int part = (kb >= ka) + (kb >= 2 * ka), c = kb - part * ka;
        load4(u + arow * ldu + c, ru);
        if (part != 0) {
          load4(static_cast<const float*>(a) + arow * lda + c, ra);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) ra[j] = 0.f;
        }
      } else {
        load4(static_cast<const TA*>(a) + arow * lda + kb, ra);
        if constexpr (MODE == kOut) load4(u + arow * ldu + kb, ru);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = kb + j;
        ra[j] = 0.f;
        ru[j] = 0.f;
        if (row_ok && k < K) {
          if constexpr (kUA) {
            const int part = (k >= ka) + (k >= 2 * ka), c = k - part * ka;
            ru[j] = u[arow * ldu + c];
            if (part != 0) ra[j] = fetch_a<T, MODE>(a, lda, arow, c);
          } else {
            ra[j] = fetch_a<T, MODE>(a, lda, arow, k);
            if constexpr (MODE == kOut) ru[j] = u[arow * ldu + k];
          }
        }
      }
    }
    const int kw = k0 + wk;
    if (vec_w && kw < K && n0 + wc + 4 <= N) {
      load4(w + static_cast<int64_t>(kw) * ldw + n0 + wc, rw);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wc + j;
        rw[j] = (kw < K && col < N) ? to_f<T>(w[static_cast<int64_t>(kw) * ldw + col]) : 0.f;
      }
    }
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) fetch_slot(k0 + 8 * sl, sa[sl], su[sl], sw[sl]);
  };
  auto commit_slot = [&](int buf, int k0, int sl, const float (&ra)[4], const float (&ru)[4],
                         const float (&rw)[4]) {
    const int kb = k0 + 8 * sl + ak;
    const bool full = row_ok && kb + 4 <= K;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kb + j;
      float v = 0.f;
      if (full || (row_ok && k < K)) {
        if constexpr (kUA) {
          const int part = (k >= ka) + (k >= 2 * ka);
          if (part == 0) {
            v = ru[j];
          } else {
            const float an = (finish_a<T, MODE, VAR>(ra[j], a_scale) - mu[ar]) * rs[ar];
            v = part == 1 ? an : ru[j] * an;
          }
        } else {
          v = (finish_a<T, MODE, VAR>(ra[j], a_scale) - mu[ar]) * rs[ar];
          if constexpr (MODE == kOut) v *= ru[j];
        }
        if constexpr (MODE == kOut) {
          if (dp.drop) {
            v *= keep_scale(static_cast<uint32_t>(drop_pos * K + k), drop_seed, dp.thresh,
                            dp.scale);
          }
        }
        v = round_to<T>(v);
      }
      As[buf][8 * sl + ak + j][ar] = v;
    }
    *reinterpret_cast<float4*>(&Ws[buf][8 * sl + wk][wc]) =
        make_float4(rw[0], rw[1], rw[2], rw[3]);
  };
  auto commit = [&](int buf, int k0) {
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) commit_slot(buf, k0, sl, sa[sl], su[sl], sw[sl]);
  };

  // Thread (ty, tx) of the 16 x 16 grid; a warp holds 4 ty x 8 tx, so that
  // its A and W fragments are 4 and 8 distinct float4s (one wavefront each).
  const int ty = ((tid >> 6) << 2) | ((tid >> 3) & 3);
  const int tx = (((tid >> 5) & 1) << 3) | (tid & 7);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  fetch(0);
  commit(0, 0);
  __syncthreads();
  const int steps = (K + GK - 1) / GK;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < steps) fetch((t + 1) * GK);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][GH + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ws[cur][kk][GH + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < steps) commit(cur ^ 1, (t + 1) * GK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = m0 + (i < 4 ? ty * 4 + i : GH + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : GH + tx * 4 + j - 4);
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

// The LayerNorm statistics (mean, 1/std) of each row of x (M, D), by
// tile_stats, for the projection's column blocks to share: ln_gemm<kProj>
// would otherwise compute them again in each of its ceil(F / 128) blocks of
// a row tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_stats_kernel(const T* __restrict__ x, int D, int M, float eps, float2* __restrict__ stats) {
  __shared__ float mu[GM], rs[GM];
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * GM;
  tile_stats<T, kProj, kGemmPlain>(x, D, D, 1.f, m0, M, eps, mu, rs);
  __syncthreads();
  for (int r = threadIdx.x; r < GM; r += kThreads) {
    if (m0 + r < M) stats[m0 + r] = make_float2(mu[r], rs[r]);
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

// The largest dynamic shared memory a block may ask for on the card
// (ops/hstu_block.py:MAX_SMEM_BYTES).
constexpr size_t kBlockSmem = 232448;

// The pointwise attention's whole-head design: kAttnThreads threads a block,
// kAttnRows query rows a warp at a time against 32 keys a step.
constexpr int kAttnThreads = 512;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kAttnRows = 8;

// The row stride of hstu_attn_kernel's transposed q: n up to a whole row group.
__host__ __device__ inline int head_ldq(int n) {
  return (n + kAttnRows - 1) / kAttnRows * kAttnRows;
}

// hstu_attn_kernel's dynamic shared memory, or 0 where it has no instance
// (dv > 64): q transposed [dqk][ldq], each warp's step weights
// [32][kAttnRows], k transposed [dqk][n | 1], v [n][dv], the time-bucket
// weights and the row-group counter (tests/test_torch_port_k1_cuda_core.py
// mirrors the sum).
size_t head_attn_smem_bytes(int n, int dqk, int dv) {
  if (dv > 2 * 32) return 0;
  const size_t floats = static_cast<size_t>(dqk) * head_ldq(n) + kAttnWarps * 32 * kAttnRows +
                        static_cast<size_t>(dqk) * (n | 1) + static_cast<size_t>(n) * dv + 128 + 4;
  return floats * sizeof(float);
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
//
// The whole-head design: one block per (head, user) stages the head's q and
// k transposed (rounded to T) and v / max_seq_len (rounded) for all n
// positions, then its warps take groups of kAttnRows query rows, longest
// first, with no barrier between them. For a
// group a warp walks the keys up to its last row 32 at a time: lane j holds
// the 8 rows' scores s = fmaf over d = 0 ... dqk - 1 from +0 (q of the 8 rows
// by two broadcast float4 loads, k by one load: 8 FMAs per 3 loads), loads
// the pairs' bias operands together, then applies the bias, the gate, the
// column mask, the keep mask and the rounding to every pair, keeping the
// causal ones (the others are never used), and stores the step's weights.
// a @ v: lane d holds the 8 rows' outputs of value column d (and d + 32 when
// NC = 2) and runs fmaf over j = 0 ... i in order from +0; a key past a row
// is skipped, never fed as a zero weight.
template <typename T, typename Y = float, int BIAS = kBiasInternal, bool ACT = true,
          bool ADROP = false, int NC = 1>
__global__ void __launch_bounds__(kAttnThreads, NC == 1 ? 2 : 1)
hstu_attn_kernel(const Y* __restrict__ y, const float* __restrict__ colmask,
                 const float* __restrict__ rel_pos, const int* __restrict__ ext,
                 const float* __restrict__ tsw, float* __restrict__ attn, int n, int H,
                 int dqk, int dv, float inv_n, int max_bucket, const T* __restrict__ bias,
                 Dropout adp) {
  extern __shared__ __align__(16) float head_smem[];
  const int ldq = head_ldq(n), ldk = n | 1;
  float* qt = head_smem;                         // [dqk][ldq]  q transposed
  float* aw = qt + dqk * ldq;                    // [kAttnWarps][32][kAttnRows] step weights
  float* kt = aw + kAttnWarps * 32 * kAttnRows;  // [dqk][ldk]  k transposed
  float* vs = kt + dqk * ldk;                    // [n][dv]     v / max_seq_len
  float* tw = vs + n * dv;                       // [128]       time-bucket weights
  int& next_group = *reinterpret_cast<int*>(tw + 128);  // the next row group to take

  const int hd = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int F = 2 * H * dv + 2 * H * dqk;
  const int voff = H * dv + hd * dv;
  const int qoff = 2 * H * dv + hd * dqk;
  const int koff = 2 * H * dv + H * dqk + hd * dqk;
  const Y* yb = y + static_cast<int64_t>(b) * n * F;
#pragma unroll 4
  for (int i = warp; i < n; i += kAttnWarps) {
    const Y* src = yb + static_cast<int64_t>(i) * F;
    for (int d = lane; d < dqk; d += 32) {
      qt[d * ldq + i] = round_to<T>(to_f<Y>(src[qoff + d]));
      kt[d * ldk + i] = round_to<T>(to_f<Y>(src[koff + d]));
    }
    for (int d = lane; d < dv; d += 32) {
      vs[i * dv + d] = round_to<T>(to_f<Y>(src[voff + d]) * inv_n);
    }
  }
  for (int d = warp; d < dqk; d += kAttnWarps) {
    for (int i = n + lane; i < ldq; i += 32) qt[d * ldq + i] = 0.f;
  }
  if constexpr (BIAS == kBiasInternal) {
    for (int t = tid; t < 128; t += kAttnThreads) tw[t] = tsw[t];
  }
  if (tid == 0) next_group = 0;
  __syncthreads();

  const float* cm = colmask + static_cast<int64_t>(b) * n;
  const int* ex = ext + static_cast<int64_t>(b) * (n + 1);
  const uint32_t aseed = ADROP ? attn_seed(adp.seed0, b, hd) : 0u;
  float* wa = aw + warp * 32 * kAttnRows;
  int vcol[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) vcol[c] = min(lane + 32 * c, dv - 1);
  const int groups = (n + kAttnRows - 1) / kAttnRows;
  for (;;) {
    int g = 0;
    if (lane == 0) g = atomicAdd(&next_group, 1);
    g = __shfl_sync(0xffffffffu, g, 0);
    if (g >= groups) break;
    const int i0 = (groups - 1 - g) * kAttnRows;  // the longest groups first
    const int ilast = min(i0 + kAttnRows, n) - 1;
    int ic[kAttnRows], nxt[kAttnRows];
#pragma unroll
    for (int r = 0; r < kAttnRows; ++r) {
      ic[r] = min(i0 + r, n - 1);
      nxt[r] = BIAS == kBiasInternal ? ex[ic[r] + 1] : 0;
    }
    float o[kAttnRows][NC];
#pragma unroll
    for (int r = 0; r < kAttnRows; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) o[r][c] = 0.f;
    for (int j0 = 0; j0 <= ilast; j0 += 32) {
      const int j = j0 + lane, jc = min(j, n - 1);
      float s[kAttnRows];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) s[r] = 0.f;
      const float* qd = qt + i0;
      const float* kd = kt + jc;
#pragma unroll 4
      for (int d = 0; d < dqk; ++d, qd += ldq, kd += ldk) {
        const float4 q0 = *reinterpret_cast<const float4*>(qd);
        const float4 q1 = *reinterpret_cast<const float4*>(qd + 4);
        const float kv = *kd;
        s[0] = fmaf(q0.x, kv, s[0]);
        s[1] = fmaf(q0.y, kv, s[1]);
        s[2] = fmaf(q0.z, kv, s[2]);
        s[3] = fmaf(q0.w, kv, s[3]);
        s[4] = fmaf(q1.x, kv, s[4]);
        s[5] = fmaf(q1.y, kv, s[5]);
        s[6] = fmaf(q1.z, kv, s[6]);
        s[7] = fmaf(q1.w, kv, s[7]);
      }
      // The pairs' operands, loaded together (at clamped, valid addresses).
      const float cmj = cm[jc];
      const int exj = BIAS == kBiasInternal ? ex[jc] : 0;
      float bv[kAttnRows];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        if constexpr (BIAS == kBiasInternal || BIAS == kBiasRelPos) {
          bv[r] = rel_pos[static_cast<int64_t>(ic[r]) * n + jc];
        } else if constexpr (BIAS == kBiasTensor) {
          bv[r] = to_f<T>(bias[(static_cast<int64_t>(b) * n + ic[r]) * n + jc]);
        } else {
          bv[r] = 0.f;
        }
      }
      float w[kAttnRows];
#pragma unroll
      for (int r = 0; r < kAttnRows; ++r) {
        const int i = i0 + r;
        float sc = s[r];
        if constexpr (BIAS == kBiasInternal) {
          sc += bv[r] + tw[time_bucket(nxt[r], exj, max_bucket)];
        } else if constexpr (BIAS == kBiasRelPos || BIAS == kBiasTensor) {
          sc += bv[r];
        }
        float a = (ACT ? silu(sc) : sc) * cmj;
        if constexpr (ADROP) {
          a *= keep_scale(static_cast<uint32_t>(i * n + j), aseed, adp.thresh, adp.scale);
        }
        w[r] = i < n && j <= i ? round_to<T>(a) : 0.f;
      }
      *reinterpret_cast<float4*>(wa + lane * kAttnRows) = make_float4(w[0], w[1], w[2], w[3]);
      *reinterpret_cast<float4*>(wa + lane * kAttnRows + 4) = make_float4(w[4], w[5], w[6], w[7]);
      __syncwarp();

      // a @ v over the step's keys: those before the group's first row for
      // all 8 rows, then the diagonal ones for the rows they precede.
      const int every = max(0, min(32, i0 - j0)), upto = min(32, ilast + 1 - j0);
      for (int jj = 0; jj < every; ++jj) {
        const float4 a0 = *reinterpret_cast<const float4*>(wa + jj * kAttnRows);
        const float4 a1 = *reinterpret_cast<const float4*>(wa + jj * kAttnRows + 4);
        const float av[kAttnRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float* vrow = vs + (j0 + jj) * dv;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vrow[vcol[c]];
#pragma unroll
          for (int r = 0; r < kAttnRows; ++r) o[r][c] = fmaf(av[r], vv, o[r][c]);
        }
      }
      for (int jj = every; jj < upto; ++jj) {
        const float4 a0 = *reinterpret_cast<const float4*>(wa + jj * kAttnRows);
        const float4 a1 = *reinterpret_cast<const float4*>(wa + jj * kAttnRows + 4);
        const float av[kAttnRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float* vrow = vs + (j0 + jj) * dv;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float vv = vrow[vcol[c]];
#pragma unroll
          for (int r = 0; r < kAttnRows; ++r) {
            if (j0 + jj <= i0 + r) o[r][c] = fmaf(av[r], vv, o[r][c]);
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int r = 0; r < kAttnRows; ++r) {
      if (i0 + r > ilast) break;
      float* orow = attn + (static_cast<int64_t>(b) * n + i0 + r) * H * dv + hd * dv;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (lane + 32 * c < dv) orow[lane + 32 * c] = o[r][c];
      }
    }
  }
}

// The pointwise attention's chunked design: AT query rows a block, keys in
// chunks of AT, value columns in passes of kAttnCols.
constexpr int AT = 64;
constexpr int kAttnCols = 64;

// A shared-memory row stride of w floats: a multiple of 4 (float4 access),
// moved off a multiple of 16 so that rows 1 to 3 apart meet other banks. Past
// 256 words it is not moved: such heads stay within the memory the kernel's
// first design asked for (tests/test_torch_port_k1_cuda_core.py).
__host__ __device__ inline int attn_stride(int w) {
  const int r = (w + 3) & ~3;
  return r % 16 == 0 && r <= 256 ? r + 4 : r;
}

// hstu_attn_chunked_kernel's dynamic shared memory: q of the block's rows
// [m][ldq], one region [m][max(ldq, lda)] that holds the key chunk [m][ldq]
// and then the weights a^T [m][lda], the value chunk [m][min(dv, kAttnCols)]
// and the time-bucket weights, m = min(n, AT) rows each. It does not grow
// with n past AT rows, and at every (n, dqk, dv) the first design (whole
// heads staged, a row of weights a warp) took it is no larger
// (tests/test_torch_port_k1_cuda_core.py mirrors the sum).
size_t chunked_attn_smem_bytes(int n, int dqk, int dv) {
  const size_t m = n < AT ? n : AT;
  const size_t ldq = attn_stride(dqk), lda = attn_stride(static_cast<int>(m));
  const size_t dvp = dv < kAttnCols ? dv : kAttnCols;
  return (m * ldq + m * (ldq > lda ? ldq : lda) + m * dvp + 128) * sizeof(float);
}

// The pointwise attention's shared memory at (n, dqk, dv): the whole-head
// kernel's where it fits a block, else the chunked kernel's (launch_attn
// takes the same rule). The wrappers ask for it through
// rails_hstu_attn_smem_bytes before any launch.
size_t attn_smem_bytes(int n, int dqk, int dv) {
  const size_t head = head_attn_smem_bytes(n, dqk, dv);
  return head != 0 && head <= kBlockSmem ? head : chunked_attn_smem_bytes(n, dqk, dv);
}

// The chunked design (T, Y, BIAS, ACT and ADROP as for hstu_attn_kernel),
// for the heads whose whole-head staging passes a block's shared memory or
// whose dv passes 64: one block per (query tile of AT rows, head, user). It stages the tile's q
// (rounded to T) once, then walks the keys up to the tile's last row in
// chunks of AT: the chunk's k and v / max_seq_len (rounded), the (i, j)
// scores of the chunk in registers, 4 x 4 a thread, each an fmaf chain over
// d = 0 ... dqk - 1 from +0 (float4 shared loads, 16 FMAs per 8 words),
// then the bias, the gate, the column mask, the keep mask and the rounding of
// every causal pair, stored as a^T over the chunk's key rows. a @ v: a thread
// owns 4 rows x up to 4 value columns for the whole key walk and runs fmaf
// over j = 0 ... i in order from +0; a key past a row is skipped, never fed
// as a zero weight. Value columns past kAttnCols take further passes over the
// keys (scores recomputed, the same bits). Tiles wholly above the diagonal are
// never visited, and a thread's 4 x 4 score block above it is skipped.
template <typename T, typename Y = float, int BIAS = kBiasInternal, bool ACT = true,
          bool ADROP = false>
__global__ void __launch_bounds__(kThreads)
hstu_attn_chunked_kernel(const Y* __restrict__ y, const float* __restrict__ colmask,
                         const float* __restrict__ rel_pos, const int* __restrict__ ext,
                         const float* __restrict__ tsw, float* __restrict__ attn, int n, int H,
                         int dqk, int dv, float inv_n, int max_bucket,
                         const T* __restrict__ bias, Dropout adp) {
  extern __shared__ __align__(16) float attn_smem[];
  const int m = n < AT ? n : AT;
  const int ldq = attn_stride(dqk), lda = attn_stride(m);
  const int dvw = dv < kAttnCols ? dv : kAttnCols;
  float* qs = attn_smem;                          // [m][ldq]  q rows of the tile
  float* kr = qs + m * ldq;                       // [m][ldq]  key chunk, then a^T [m][lda]
  float* vs = kr + m * (ldq > lda ? ldq : lda);  // [m][dvw]  value chunk of the pass
  float* tw = vs + m * dvw;                       // [128]     time-bucket weights

  const int i0 = (gridDim.x - 1 - blockIdx.x) * AT;  // the longest tiles start first
  const int hd = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int rows = min(AT, n - i0), jmax = i0 + rows;
  const int F = 2 * H * dv + 2 * H * dqk;
  const int voff = H * dv + hd * dv;
  const int qoff = 2 * H * dv + hd * dqk;
  const int koff = 2 * H * dv + H * dqk + hd * dqk;
  const Y* yb = y + static_cast<int64_t>(b) * n * F;
  const float* cm = colmask + static_cast<int64_t>(b) * n;
  const int* ex = ext + static_cast<int64_t>(b) * (n + 1);
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < rows; i += kWarps) {
    const Y* src = yb + static_cast<int64_t>(i0 + i) * F + qoff;
    for (int d = lane; d < dqk; d += 32) qs[i * ldq + d] = round_to<T>(to_f<Y>(src[d]));
  }
  if constexpr (BIAS == kBiasInternal) {
    for (int t = tid; t < 128; t += kThreads) tw[t] = tsw[t];
  }
  const uint32_t aseed = ADROP ? attn_seed(adp.seed0, b, hd) : 0u;

  // Scores: thread (ti, tj) has rows 4ti.. and keys 4tj.. of the chunk.
  // a @ v: thread (g, cl) has rows 4g.. and value columns cl + 16c.
  const int ti = tid >> 4, tj = tid & 15;
  const int g = ti, cl = tj;
  const int ig = i0 + 4 * g;
  const float* qrow[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) qrow[r] = qs + min(4 * ti + r, rows - 1) * ldq;

  for (int c0 = 0; c0 < dv; c0 += kAttnCols) {
    const int cols_v = min(kAttnCols, dv - c0);
    float o[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
    for (int j0 = 0; j0 < jmax; j0 += AT) {
      const int keys = min(AT, jmax - j0);
      __syncthreads();  // the last chunk's a^T and v are read; q and tw are staged
#pragma unroll 2
      for (int j = warp; j < keys; j += kWarps) {
        const Y* src = yb + static_cast<int64_t>(j0 + j) * F;
        for (int d = lane; d < dqk; d += 32) kr[j * ldq + d] = round_to<T>(to_f<Y>(src[koff + d]));
        for (int c = lane; c < cols_v; c += 32) {
          vs[j * dvw + c] = round_to<T>(to_f<Y>(src[voff + c0 + c]) * inv_n);
        }
      }
      __syncthreads();

      // The 4 x 4 score block, when any of its pairs is causal and valid.
      const bool live = 4 * ti < rows && 4 * tj < keys && j0 + 4 * tj <= i0 + 4 * ti + 3;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
      if (live) {
        const float* krow[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) krow[c] = kr + min(4 * tj + c, keys - 1) * ldq;
        int d = 0;
        for (; d + 4 <= dqk; d += 4) {
          float4 qv[4], kv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) qv[r] = *reinterpret_cast<const float4*>(qrow[r] + d);
#pragma unroll
          for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(krow[c] + d);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              s[r][c] = fmaf(qv[r].x, kv[c].x, s[r][c]);
              s[r][c] = fmaf(qv[r].y, kv[c].y, s[r][c]);
              s[r][c] = fmaf(qv[r].z, kv[c].z, s[r][c]);
              s[r][c] = fmaf(qv[r].w, kv[c].w, s[r][c]);
            }
        }
        for (; d < dqk; ++d) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qrow[r][d], krow[c][d], s[r][c]);
        }
        // The pairs' operands, loaded together (at clamped, valid addresses)
        // so that their latencies overlap: column mask and timestamps of the
        // keys, the rows' next timestamps, and the bias of each pair.
        int ic[4], jc[4], nxt[4], exj[4];
        float cmj[4], bv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ic[r] = min(i0 + 4 * ti + r, n - 1);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          jc[c] = min(j0 + 4 * tj + c, n - 1);
          cmj[c] = cm[jc[c]];
          exj[c] = BIAS == kBiasInternal ? ex[jc[c]] : 0;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          nxt[r] = BIAS == kBiasInternal ? ex[ic[r] + 1] : 0;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if constexpr (BIAS == kBiasInternal || BIAS == kBiasRelPos) {
              bv[r][c] = rel_pos[static_cast<int64_t>(ic[r]) * n + jc[c]];
            } else if constexpr (BIAS == kBiasTensor) {
              bv[r][c] = to_f<T>(bias[(static_cast<int64_t>(b) * n + ic[r]) * n + jc[c]]);
            } else {
              bv[r][c] = 0.f;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + 4 * ti + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + 4 * tj + c;
            float a = 0.f;
            if (i < n && j <= i) {
              float sc = s[r][c];
              if constexpr (BIAS == kBiasInternal) {
                sc += bv[r][c] + tw[time_bucket(nxt[r], exj[c], max_bucket)];
              } else if constexpr (BIAS == kBiasRelPos || BIAS == kBiasTensor) {
                sc += bv[r][c];
              }
              a = (ACT ? silu(sc) : sc) * cmj[c];
              if constexpr (ADROP) {
                a *= keep_scale(static_cast<uint32_t>(i * n + j), aseed, adp.thresh, adp.scale);
              }
              a = round_to<T>(a);
            }
            s[r][c] = a;
          }
        }
      }
      __syncthreads();  // every thread is done with the key chunk
      if (live) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (4 * tj + c < keys) {
            *reinterpret_cast<float4*>(kr + (4 * tj + c) * lda + 4 * ti) =
                make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
          }
        }
      }
      __syncthreads();

      // a @ v over the chunk's keys: every key before the thread's first row
      // for all four rows, then the diagonal keys for the rows they precede.
      if (4 * g < rows) {
        const int all = min(keys, max(ig - j0, 0)), last = min(keys, ig + 4 - j0);
        int vc[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) vc[c] = min(cl + 16 * c, cols_v - 1);
        for (int jj = 0; jj < all; ++jj) {
          const float4 a4 = *reinterpret_cast<const float4*>(kr + jj * lda + 4 * g);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float* vrow = vs + jj * dvw;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (16 * c < cols_v) {
              const float vv = vrow[vc[c]];
#pragma unroll
              for (int r = 0; r < 4; ++r) o[r][c] = fmaf(av[r], vv, o[r][c]);
            }
          }
        }
        for (int jj = all; jj < last; ++jj) {
          const float4 a4 = *reinterpret_cast<const float4*>(kr + jj * lda + 4 * g);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
          const float* vrow = vs + jj * dvw;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (16 * c < cols_v) {
              const float vv = vrow[vc[c]];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                if (j0 + jj <= ig + r) o[r][c] = fmaf(av[r], vv, o[r][c]);
              }
            }
          }
        }
      }
    }
    if (4 * g < rows) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ig + r;
        if (i >= n) break;
        float* orow = attn + (static_cast<int64_t>(b) * n + i) * H * dv + hd * dv + c0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (cl + 16 * c < cols_v) orow[cl + 16 * c] = o[r][c];
        }
      }
    }
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

inline dim3 gemm_grid(int N, int M) { return dim3((N + GN - 1) / GN, (M + GM - 1) / GM); }

// The rows' LayerNorm statistics into `scratch` (2 * M floats) for the
// projection, or nullptr (the projection's blocks compute them) where there
// is no scratch.
template <typename T>
const float2* launch_ln_stats(const void* x, int M, int D, float eps, float* scratch,
                              cudaStream_t stream) {
  if (scratch == nullptr) return nullptr;
  auto* stats = reinterpret_cast<float2*>(scratch);
  ln_stats_kernel<T><<<(M + GM - 1) / GM, kThreads, 0, stream>>>(static_cast<const T*>(x), D, M,
                                                                  eps, stats);
  return stats;
}

// The scratch of the projection's statistics: attn (M, hv), which the
// attention writes only after the projection, where it holds 2 floats a row.
inline float* stats_scratch(float* attn, int hv) { return hv >= 2 ? attn : nullptr; }

// Launch 1: y (M, F) f32 = act(LN(x) @ uvqk), the statistics of x's rows
// computed once into `scratch` (2 * M floats; nullptr: by each GEMM block).
template <typename T, int VAR>
cudaError_t launch_proj(const void* x, const void* uvqk, float* y, int M, int F, int D,
                        float eps, float* scratch, cudaStream_t stream) {
  const float2* stats = launch_ln_stats<T>(x, M, D, eps, scratch, stream);
  ln_gemm_kernel<T, kProj, VAR><<<gemm_grid(F, M), kThreads, 0, stream>>>(
      x, D, D, nullptr, 0, static_cast<const T*>(uvqk), F, nullptr, nullptr, y, M, F, D, eps,
      1.f, Dropout{}, stats);
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
      out, M, D, K, eps, a_scale, dp, nullptr);
  return cudaGetLastError();
}

// The whole-head attention's launch, NC value columns a lane.
template <typename T, typename Y, int BIAS, bool ACT, bool ADROP, int NC>
cudaError_t launch_head_attn(const Y* y, const float* colmask, const float* rel_pos,
                             const int* ext, const float* tsw, const void* bias, float* attn,
                             int B, int n, int H, int dqk, int dv, float inv_n, int max_bucket,
                             size_t smem, cudaStream_t stream, Dropout adp) {
  cudaError_t err = allow_smem(hstu_attn_kernel<T, Y, BIAS, ACT, ADROP, NC>, smem);
  if (err != cudaSuccess) return err;
  hstu_attn_kernel<T, Y, BIAS, ACT, ADROP, NC><<<dim3(H, B), kAttnThreads, smem, stream>>>(
      y, colmask, rel_pos, ext, tsw, attn, n, H, dqk, dv, inv_n, max_bucket,
      static_cast<const T*>(bias), adp);
  return cudaGetLastError();
}

// Launch 2, pointwise SiLU attention (or the probe's linear gate), over y
// stored as Y, with the train block's attention dropout `adp` under ADROP:
// the whole-head kernel where it fits, else the chunked one.
template <typename T, int BIAS, bool ACT = true, typename Y = float, bool ADROP = false>
cudaError_t launch_attn(const Y* y, const float* colmask, const float* rel_pos,
                        const int* ext, const float* tsw, const void* bias, float* attn, int B,
                        int n, int H, int dqk, int dv, float inv_n, int max_bucket,
                        cudaStream_t stream, Dropout adp = Dropout{}) {
  const size_t head = head_attn_smem_bytes(n, dqk, dv);
  if (head != 0 && head <= kBlockSmem) {
    return dv > 32 ? launch_head_attn<T, Y, BIAS, ACT, ADROP, 2>(
                         y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H, dqk, dv, inv_n,
                         max_bucket, head, stream, adp)
                   : launch_head_attn<T, Y, BIAS, ACT, ADROP, 1>(
                         y, colmask, rel_pos, ext, tsw, bias, attn, B, n, H, dqk, dv, inv_n,
                         max_bucket, head, stream, adp);
  }
  const size_t smem = chunked_attn_smem_bytes(n, dqk, dv);
  cudaError_t err = allow_smem(hstu_attn_chunked_kernel<T, Y, BIAS, ACT, ADROP>, smem);
  if (err != cudaSuccess) return err;
  hstu_attn_chunked_kernel<T, Y, BIAS, ACT, ADROP>
      <<<dim3((n + AT - 1) / AT, H, B), kThreads, smem, stream>>>(
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
  float* scratch = stats_scratch(attn, H * dv);
  cudaError_t err =
      v.act_none ? launch_proj<T, kActNone>(x, uvqk, y, M, F, D, eps, scratch, stream)
                 : launch_proj<T, kGemmPlain>(x, uvqk, y, M, F, D, eps, scratch, stream);
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
