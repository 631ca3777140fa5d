// K4's f32 train block on the H100's tensor cores: every product of the
// forward and of the pointwise attention backward as 3xTF32 on mma.sync
// m16n8k8 with f32 accumulators.
//
// Replaces, for f32 operands, the forward `pallas_call` of
// rails_tpu/ops/pallas/hstu_block_train.py (:574, body `_fwd_kernel`
// :124-232) and the pointwise branch of its attention-core backward (:629,
// `_attn_bwd_kernel` :248-435), at the widths of the bf16 tensor-core kernels
// (hstu_block_tc.cuh `widths_ok`: D <= 272, dqk and dv <= 32, h <= 3 or an even
// h <= 8) with n <= 512, the SiLU projection and the pointwise attention
// (the rated preprocessor's D = 264 and the combined one's n = 422 among them); with
// or without the relative-attention bias, o_input dropout, attention dropout
// and concat_ua (runtime switches of these kernels). softmax,
// linear_activation="none", wider heads and longer sequences stay on the
// CUDA-core kernels of hstu_block.cuh / hstu_block_train.cu /
// hstu_softmax_train.cu, whose entry points refuse these instances.
//
// 3xTF32. Each f32 operand x is split once, where it is staged into shared
// memory, into hi (x with its 13 low mantissa bits cleared: TF32 by
// truncation) and lo = x - hi (exact), stored side by side as a float2, so
// the mma loops only load; the tensor core reads the top 19 bits of lo. A
// product is lo.hi + hi.lo + hi.hi in that order into the f32 accumulator:
// the dropped lo.lo term and the truncations leave each product within about
// 2^-19 of its f32 value (K5's f32 route splits the same way, mol_loss_tc.cuh).
// The attention weights a and d_s, computed in registers, are split there,
// straight from the score fragments into the A fragments of the next product
// (k slot t <-> column 2t, t + 4 <-> 2t + 1, and B's rows read in that order).
// Shared-memory rows are float2 with strides of 4 (mod 16) float2: the
// fragment reads of m16n8k8 (row g, column t: g * ld + t; or column g, row t)
// are free of bank conflicts for each half-warp. The reads of B in the
// permuted order (rows 2t, 2t + 1) are too for the forward's v (stride 2 mod
// 8); in the backward, k and q (and d_attn) are read both ways and take a
// two-way conflict on the permuted reads.
//
// Bound. At ml-20m-hstu-mol's block (B = 128, n = 211, D = 256, h = 8, dqk =
// dv = 32) the forward needs 20.6 GFLOP (projection 14.2, attention 2.9,
// output GEMM 3.5) and the backward's attention products 7.3 GFLOP: 0.125 ms
// and 0.044 ms at 3xTF32's 165 TFLOP/s (a third of the 495 TFLOP/s TF32
// rate of wgmma), against 0.31 and 0.11 ms at the CUDA cores' 67 TFLOP/s.
// mma.sync itself issues TF32 m16n8k8 at ~316 TFLOP/s on the H100
// (profile_k4_f32.py --mma-rate), so 3xTF32 on mma.sync tops out near 105.
// The backward also moves ~0.3 GB (y, d_o, attn, d_y, dbias): 0.09 ms at
// 3.35 TB/s, so its bytes set its bound.
//
// Forward, three launches:
//   (a) tc_tf32_proj_kernel: y = SiLU(LN(x) @ uvqk), (B*n, F) f32. A block
//       owns 64 rows of x: a warp a row takes the LayerNorm statistics once
//       and writes the row's LN(x) split into a tile that holds all D <= 272
//       columns (zeros from D to the next multiple of 32); the block then
//       walks the F output columns in 128-wide tiles,
//       uvqk's rows streaming raw by cp.async through a 3-deep ring, each B
//       fragment split in registers as it is read. 8 warps of 32 x 32
//       outputs, one block an SM (185 KB; 197 KB at D = 264).
//   (b) tc_tf32_attn_kernel: attn (B, n, h*dv) f32 per (user, 64 query
//       rows), 16 warps = 4 row warps (16 rows) x 4 key warps (32 keys of a
//       128-key block), heads in turn. The bias block rel_pos[i, j] +
//       tsw[time_bucket(ext[i+1] - ext[j])] of the 64 rows and every causal
//       key is built once in shared memory for all heads (logf, no fast
//       math), the causal x column mask folded in as a -1e30 penalty (SiLU
//       gives -0 there, the mask multiply's 0). Each (head, key block) step's
//       q, k and v rows land raw by cp.async during the step before and are
//       split between two barriers. s = q k^T + bias, a = s * sigma(s) (expf
//       and an IEEE reciprocal) * keep, attn += a (v / max_seq_len); the key
//       warps' partial sums are added in warp order. Key tiles above a warp's
//       last row, past n, and rows past n are skipped.
//   (c) tc_tf32_out_kernel: out = o_input @ Wo + bo + x. The A chunk of each
//       k step is built from attn and u carried in registers one step ahead,
//       as o_input = u * LN(attn) (or concat_ua's [u, LN(attn), u *
//       LN(attn)]) times the K3 keep mask from per-row statistics of attn
//       taken once per row (ln_gemm_kernel<kOut>'s), and split with Wo's raw
//       chunk into hi/lo tiles; two blocks an SM. (A resident A here, as in
//       (a), ran slower: building it cost more than the two column tiles
//       reuse it.)
// Backward (f32 keeps the forward's attn), three launches:
//   (a) attn_row_bwd_kernel (hstu_train.cuh): d_u, d_attn = LN-backward;
//       byte-bound row work, as on the CUDA-core route.
//   (b) tc_tf32_dq_kernel per (user, 64 query rows), heads in turn, as (b)
//       above: s and d_a = d_attn v^T, d_s = d_a * keep * silu'(s), d_q +=
//       d_s k. dbias = sum_h d_s_h is kept in each warp's registers over the
//       heads, added in head order, and written once in whole rows through
//       shared memory.
//   (c) tc_tf32_dkv_kernel per (user, 64 key rows), heads in turn, walking
//       the query blocks i >= j (heavy key tiles first): s^T = k q^T, d_a^T =
//       v d_attn^T, d_k += d_s^T q, d_v += a^T d_attn, times 1/max_seq_len.
// Every output element has one writer and no atomics are used, so two calls
// give the same bits. The attention keep mask regenerates the (user, head)
// K3 stream (`attn_seed`, idx = i * n + j) wherever a pair is used.
// One (user, 64-row) block holds the bias block, one head's hi/lo row and
// column tiles and their raw landing rows: 192-230 KB at n <= 256, so one
// block of 16 warps runs an SM; eight heads' tiles at once (over 300 KB) do
// not fit. Past n = 256 a block owns 32 rows (8 warps; the attention's and
// dq's key blocks, and so their sums, are those of the 64-row blocks; dkv's
// query blocks start at its 32 keys): 156-200 KB at n = 257-512.
#pragma once

#include <cstdint>

#include "hash_dropout.cuh"
#include "hstu_train_tc.cuh"
#include "tf32_mma.cuh"

namespace rails {
namespace {
namespace tf32 {

// ---- forward launches (a) and (c): the GEMMs -----------------------------

constexpr int kGemmThreads = 256;                 // 8 warps: 2 (rows) x 4 (columns)
constexpr int kGM = 64, kGN = 128, kGK = 32;
constexpr int kLdGA = kGK + 4, kLdGB = kGN + 4;   // float2 strides, 4 (mod 16)
constexpr int kARegs = kGM * kGK / kGemmThreads;  // A chunk values a thread carries

enum GemmMode { kModeProj = 0, kModeOut = 1 };   // gemm_epilogue's

struct GemmArgs {
  const float* a;       // proj: x (M, ka); out: attn (M, ka = h*dv)
  const float* u;       // out: y, whose first ka columns are u (row stride ldu)
  const float* w;       // (K, N): uvqk or o_kernel
  const float* bias;    // out: (N,)
  const float* resid;   // out: x (M, N)
  float* out;           // proj: y (M, N); out: (M, N)
  int M, K, N, ka, ldu, concat_ua;
  float eps;
  Dropout dp;           // out: the o_input keep mask
};

inline size_t gemm_smem_bytes() {
  return (kGM * kLdGA + kGK * kLdGB) * sizeof(float2) + 2 * kGK * kGN * sizeof(float) +
         2 * kGM * sizeof(float);
}

// Rows k0.. of W, columns n0.. into a raw (kGK x kGN) buffer; zeros past K, N.
__device__ __forceinline__ void load_w_raw(float* dst, const GemmArgs& p, int k0, int n0,
                                           int tid) {
  if ((p.N & 3) == 0) {
    for (int e = tid; e < kGK * (kGN / 4); e += kGemmThreads) {
      const int r = e / (kGN / 4), c = (e % (kGN / 4)) * 4, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      tc::cp_async16(dst + r * kGN + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  } else {
    for (int e = tid; e < kGK * kGN; e += kGemmThreads) {
      const int r = e / kGN, c = e % kGN, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      cp_async4(dst + r * kGN + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  }
}

// The raw A values of chunk k0 this thread carries: attn and u of o_input's
// column (part k / ka under concat_ua).
__device__ __forceinline__ void fetch_a(const GemmArgs& p, float (&ra)[kARegs],
                                        float (&ru)[kARegs], int64_t m0, int k0, int tid) {
#pragma unroll
  for (int q = 0; q < kARegs; ++q) {
    const int e = tid + q * kGemmThreads, r = e / kGK, k = k0 + e % kGK;
    const int64_t row = m0 + r;
    ra[q] = ru[q] = 0.f;
    if (row < p.M && k < p.K) {
      const int c = p.concat_ua ? k % p.ka : k;
      ra[q] = p.a[row * p.ka + c];
      ru[q] = p.u[row * p.ldu + c];
    }
  }
}

// Element (row, k) of o_input = u * LN(attn) (concat_ua: [u, LN(attn), u *
// LN(attn)]) times its keep mask from its raw values, as ln_gemm_kernel<kOut>
// builds it; 0 past M and K.
__device__ __forceinline__ float a_value(const GemmArgs& p, float ra, float ru, float mu, float rs,
                                         int64_t row, int k) {
  if (row >= p.M || k >= p.K) return 0.f;
  const float an = (ra - mu) * rs;
  float v;
  if (p.concat_ua) {
    const int part = k / p.ka;
    v = part == 0 ? ru : part == 1 ? an : ru * an;
  } else {
    v = an * ru;
  }
  if (p.dp.drop) {
    const int user = static_cast<int>(row / p.dp.n_per_user);
    const int pos = static_cast<int>(row - static_cast<int64_t>(user) * p.dp.n_per_user);
    v *= keep_scale(static_cast<uint32_t>(pos * p.K + k), user_seed(p.dp.seed0, user),
                    p.dp.thresh, p.dp.scale);
  }
  return v;
}

template <int MODE>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& p, const float (&acc)[2][4][4],
                                              int64_t m0, int n0, int wm, int wn, int g, int t) {
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        float v[2] = {acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= p.N) continue;
          if constexpr (MODE == kModeProj) {
            v[e] = silu(v[e]);
          } else {
            v[e] = v[e] + p.bias[col + e] + p.resid[row * p.N + col + e];
          }
        }
        if (pairs && col + 1 < p.N) {
          *reinterpret_cast<float2*>(p.out + row * p.N + col) = make_float2(v[0], v[1]);
        } else {
          if (col < p.N) p.out[row * p.N + col] = v[0];
          if (col + 1 < p.N) p.out[row * p.N + col + 1] = v[1];
        }
      }
    }
}

// Forward (c): the output GEMM, A built and split for every k step.
__global__ void __launch_bounds__(kGemmThreads, 2) tc_tf32_out_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  float2* As = reinterpret_cast<float2*>(tf32_smem);         // [kGM][kLdGA] hi/lo
  float2* Bs = As + kGM * kLdGA;                             // [kGK][kLdGB] hi/lo
  float* Braw = reinterpret_cast<float*>(Bs + kGK * kLdGB);  // 2 x [kGK][kGN] raw W
  float* mu = Braw + 2 * kGK * kGN;                          // [kGM]
  float* rs = mu + kGM;                                      // [kGM]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kGM;
  const int KT = (p.K + kGK - 1) / kGK, NT = (p.N + kGN - 1) / kGN, total = KT * NT;

  load_w_raw(Braw, p, 0, 0, tid);
  tc::cp_async_commit();
  // LayerNorm statistics of the block's rows over ka columns, once per row:
  // population variance, two passes (ln_gemm_kernel's).
  for (int r = warp; r < kGM; r += kGemmThreads / 32) {
    const int64_t row = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (row < p.M) {
      const float* ar = p.a + row * p.ka;
      float s = 0.f;
      for (int k = lane; k < p.ka; k += 32) s += ar[k];
      mean = warp_sum(s) / p.ka;
      float v = 0.f;
      for (int k = lane; k < p.ka; k += 32) {
        const float d = ar[k] - mean;
        v = fmaf(d, d, v);
      }
      rstd = rsqrtf(warp_sum(v) / p.ka + p.eps);
    }
    if (lane == 0) {
      mu[r] = mean;
      rs[r] = rstd;
    }
  }
  float ra[kARegs], ru[kARegs];
  fetch_a(p, ra, ru, m0, 0, tid);

  float acc[2][4][4];
  for (int it = 0; it < total; ++it) {
    const int kt = it % KT, n0 = (it / KT) * kGN, k0 = kt * kGK;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    const int nx = it + 1;
    // Braw[nx & 1] was last read by step it - 1's split, before its barrier.
    if (nx < total) load_w_raw(Braw + (nx & 1) * kGK * kGN, p, (nx % KT) * kGK, (nx / KT) * kGN, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();  // W chunk it landed; every warp is past step it - 1's products
#pragma unroll
    for (int q = 0; q < kARegs; ++q) {
      const int e = tid + q * kGemmThreads, r = e / kGK, c = e % kGK;
      As[r * kLdGA + c] = split(a_value(p, ra[q], ru[q], mu[r], rs[r], m0 + r, k0 + c));
    }
    const float* br = Braw + (it & 1) * kGK * kGN;
    for (int e = tid; e < kGK * kGN; e += kGemmThreads) {
      Bs[(e / kGN) * kLdGB + e % kGN] = split(br[e]);
    }
    if (nx < total) fetch_a(p, ra, ru, m0, (nx % KT) * kGK, tid);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      FragA a[2];
      FragB b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ld_a(a[mi], As + (wm * 32 + mi * 16) * kLdGA + ks * 8, kLdGA, g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) ld_b_kn(b[ni], Bs + ks * 8 * kLdGB + wn * 32 + ni * 8, kLdGB, g, t);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3<4>(acc[mi], a[mi], b);
    }
    if (kt == KT - 1) gemm_epilogue<kModeOut>(p, acc, m0, n0, wm, wn, g, t);
  }
}

// Forward (a): the projection. A block owns 64 rows of x; their LayerNorm'd
// values sit split in shared memory for every column tile (D <= 272 wide),
// and uvqk's rows stream raw through a kPStages-deep cp.async ring, each B
// fragment split in registers as it is read.
constexpr int kPStages = 3;
constexpr int kLdW = kGN + 8;   // raw W row stride, 8 (mod 32) floats: rows t, columns g

__host__ __device__ inline int proj_lda(int D) { return (D + kGK - 1) / kGK * kGK + 4; }

inline size_t proj_smem_bytes(int D) {
  return static_cast<size_t>(kGM) * proj_lda(D) * sizeof(float2) +
         static_cast<size_t>(kPStages) * kGK * kLdW * sizeof(float);
}

// LN(x) of the block's rows, once: statistics over the D columns
// (population variance, two passes), then every value split; zeros past D
// (to the chunk edge lda - 4 <= 32 Q) and past M. Q = 8 up to D = 256, 9 up
// to 288.
template <int Q>
__device__ __forceinline__ void proj_ln(const GemmArgs& p, float2* As, int lda, int64_t m0,
                                        int warp, int lane) {
  for (int r = warp; r < kGM; r += kGemmThreads / 32) {
    const int64_t row = m0 + r;
    float v[Q];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      v[q] = row < p.M && k < p.K ? p.a[row * p.K + k] : 0.f;
      s += v[q];
    }
    const float mean = warp_sum(s) / p.K;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < p.K) {
        const float d = v[q] - mean;
        var = fmaf(d, d, var);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / p.K + p.eps);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < lda - 4) {
        As[r * lda + k] = split(row < p.M && k < p.K ? (v[q] - mean) * rstd : 0.f);
      }
    }
  }
}

__device__ __forceinline__ void load_w_ring(float* dst, const GemmArgs& p, int k0, int n0, int tid) {
  if ((p.N & 3) == 0) {
    for (int e = tid; e < kGK * (kGN / 4); e += kGemmThreads) {
      const int r = e / (kGN / 4), c = (e % (kGN / 4)) * 4, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      tc::cp_async16(dst + r * kLdW + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  } else {
    for (int e = tid; e < kGK * kGN; e += kGemmThreads) {
      const int r = e / kGN, c = e % kGN, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      cp_async4(dst + r * kLdW + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  }
}

__global__ void __launch_bounds__(kGemmThreads, 1) tc_tf32_proj_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  const int lda = proj_lda(p.K), KT = (p.K + kGK - 1) / kGK;
  float2* As = reinterpret_cast<float2*>(tf32_smem);                  // [kGM][lda] LN(x) hi/lo
  float* ring = reinterpret_cast<float*>(As + kGM * lda);              // kPStages x [kGK][kLdW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kGM;
  const int NT = (p.N + kGN - 1) / kGN, total = KT * NT;

#pragma unroll
  for (int s = 0; s < kPStages - 1; ++s) {
    if (s < total) load_w_ring(ring + s * kGK * kLdW, p, (s % KT) * kGK, (s / KT) * kGN, tid);
    tc::cp_async_commit();
  }
  if (p.K > 256) {
    proj_ln<9>(p, As, lda, m0, warp, lane);
  } else {
    proj_ln<8>(p, As, lda, m0, warp, lane);
  }

  float acc[2][4][4];
  for (int it = 0; it < total; ++it) {
    const int kt = it % KT;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    tc::cp_async_wait<kPStages - 2>();
    __syncthreads();  // stage it landed (and LN(x) on the first step); stage it - 1 is read
    const int nx = it + kPStages - 1;
    if (nx < total) {
      load_w_ring(ring + (nx % kPStages) * kGK * kLdW, p, (nx % KT) * kGK, (nx / KT) * kGN, tid);
    }
    tc::cp_async_commit();
    const float* ws = ring + (it % kPStages) * kGK * kLdW + wn * 32;
#pragma unroll
    for (int ks = 0; ks < kGK / 8; ++ks) {
      FragA a[2];
      FragB b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ld_a(a[mi], As + (wm * 32 + mi * 16) * lda + kt * kGK + ks * 8, lda, g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        set_b(b[ni], 0, split(ws[(ks * 8 + t) * kLdW + ni * 8 + g]));
        set_b(b[ni], 1, split(ws[(ks * 8 + t + 4) * kLdW + ni * 8 + g]));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3<4>(acc[mi], a[mi], b);
    }
    if (kt == KT - 1) gemm_epilogue<kModeProj>(p, acc, m0, (it / KT) * kGN, wm, wn, g, t);
  }
}

// ---- the attention launches: forward (b), backward (b) and (c) -----------

// A block's layout follows from its rows TR and kColWarps: a warp takes 16
// rows by kTile columns. At 64 x 4 a block of 16 warps needs 192-230 KB of
// shared memory at n <= 256 (the bias block alone 59 KB), one block an SM.
// 32 x 2, 4 warps and two blocks an SM (98-112 KB each at n = 211), ran
// 15-23% slower on an H100 (`profile_k4_f32.py --variant two-ctas`): half
// the warps an SM, k and v staged twice as often, dq at 255 registers. Past
// n = 256 the bias rows of 64 queries do not fit beside the tiles (281 KB for
// dq at n = 422), so a block takes 32 rows there: 8 warps, 156-200 KB at n =
// 257-512, one block an SM.
constexpr int kTile = 32;                       // a column warp's keys (dkv: queries)
constexpr int kColWarps = 4;
constexpr int kBlockCols = kTile * kColWarps;   // columns staged at a time
constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }

// The constants of a block of TR rows (queries; dkv: keys).
template <int TR>
struct Blk {
  static constexpr int kRowWarps = TR / 16;
  // Warp w: row warp w & (kRowWarps - 1), column warp w >> kRowShift.
  static constexpr int kRowShift = log2i(kRowWarps);
  static constexpr int kThreads = 32 * kRowWarps * kColWarps;
  static constexpr int kMaxN = TR == 64 ? 256 : tc::kTf32MaxN;   // keys (queries) of a bias block
  static constexpr int kSlots = kMaxN / kBlockCols;   // column blocks of a row block at most
  // The reduction buffer [kColWarps][TR][<= DQP + DVP + 8] overlays the
  // column tiles [kBlockCols][ldq + ldv] float2.
  static_assert(TR <= 2 * kTile, "R must fit the column tiles");
  static_assert(kRowWarps * 16 == TR && (1 << kRowShift) == kRowWarps, "2^k row warps");
};

// The rows of an attention block at length n.
__host__ __device__ inline int block_rows(int n) { return n <= 256 ? 64 : 32; }

struct AttnArgs {
  const float* y;        // (B*n, F): [u | v | q | k]
  const float* d_attn;   // (B*n, h*dv)                                   dq, dkv
  float* attn;           // (B*n, h*dv) out                               forward
  float* d_y;            // (B*n, F): dq writes d_q, dkv d_v and d_k
  float* dbias;          // (B, n, n) or null                             dq
  const float* colmask;  // (B, n)
  const float* rel_pos;  // (n, n)   with the bias
  const int* ext;        // (B, n+1) with the bias
  const float* tsw;      // (128,)   with the bias
  int n, H, dqk, dv, F, has_bias, max_bucket;
  float inv_n;
  int adrop, seed0;
  uint32_t athresh;
  float ascale;
};

enum AttnKind { kFwd = 0, kDq = 1, kDkv = 2 };

// Shared memory: the bias block [TR][ldbc] f32, the row operands (TR
// rows) and the column operands (kBlockCols rows) as hi/lo tiles, the raw f32
// rows the next step's operands land in by cp.async, the tables. Offsets in
// bytes.
template <int DQP, int DVP, int TR>
struct AttnLayout {
  static constexpr int ldq = DQP + 4, ldv = DVP + 4, ldvp = DVP + 2;   // float2 strides
  static constexpr int cw = DQP + DVP;                                  // raw column-operand width
  int ldbc, rw;
  size_t rows, cols, row_raw, col_raw, tables, bytes;
  __host__ __device__ AttnLayout(int kind, int n) {
    const int np32 = (n + 31) / 32 * 32;
    ldbc = np32 + 8;   // 8 (mod 32) floats
    rw = kind == kFwd ? DQP : DQP + DVP;
    rows = static_cast<size_t>(TR) * ldbc * sizeof(float);
    const size_t row_w = kind == kFwd ? ldq : ldq + ldv;
    const size_t col_w = kind == kFwd ? ldq + ldvp : ldq + ldv;
    cols = rows + TR * row_w * sizeof(float2);
    row_raw = cols + kBlockCols * col_w * sizeof(float2);
    col_raw = row_raw + static_cast<size_t>(TR) * rw * sizeof(float);
    tables = col_raw + static_cast<size_t>(kBlockCols) * cw * sizeof(float);
    bytes = tables + (Blk<TR>::kMaxN + 128) * sizeof(float) + (Blk<TR>::kMaxN + 1) * sizeof(int);
  }
};

// cp.async of one user's rows r0 .. r0+R (src, stride ld_src), columns off ..
// off+w, into raw (stride ldr) as W columns: zeros past w and at or past
// lim, by NTHR threads. vec: 16-byte copies (ld_src, off and w multiples of 4).
template <int W, int NTHR>
__device__ __forceinline__ void copy_rows(float* raw, int ldr, const float* src, int ld_src,
                                          int off, int w, int r0, int R, int lim, bool vec,
                                          int tid) {
  if (vec) {
    for (int e = tid; e < R * (W / 4); e += NTHR) {
      const int r = e / (W / 4), c = e % (W / 4) * 4;
      const bool ok = r0 + r < lim && c < w;
      tc::cp_async16(raw + r * ldr + c,
                     ok ? src + static_cast<int64_t>(r0 + r) * ld_src + off + c : src, ok);
    }
  } else {
    for (int e = tid; e < R * W; e += NTHR) {
      const int r = e / W, c = e % W;
      const bool ok = r0 + r < lim && c < w;
      cp_async4(raw + r * ldr + c, ok ? src + static_cast<int64_t>(r0 + r) * ld_src + off + c : src,
                ok);
    }
  }
}

// R x W raw values (stride ldr) times scale, split into dst (stride ld), by
// NTHR threads.
template <int W, int NTHR>
__device__ __forceinline__ void split_rows(float2* dst, int ld, const float* raw, int ldr, int R,
                                           float scale, int tid) {
  for (int e = tid; e < R * W; e += NTHR) {
    const int r = e / W, c = e % W;
    dst[r * ld + c] = split(raw[r * ldr + c] * scale);
  }
}

// Column validity [MAXN] (zeros past n), and with the bias the time-bucket
// weights and the extended timestamps; NTHR threads.
template <int NTHR, int MAXN>
__device__ __forceinline__ void stage_attn_tables(const AttnArgs& p, int b, float* cm, float* tw,
                                                  int* ex, int tid) {
  for (int j = tid; j < MAXN; j += NTHR)
    cm[j] = j < p.n ? p.colmask[static_cast<int64_t>(b) * p.n + j] : 0.f;
  if (p.has_bias) {
    for (int j = tid; j <= p.n; j += NTHR)
      ex[j] = p.ext[static_cast<int64_t>(b) * (p.n + 1) + j];
    for (int k = tid; k < 128; k += NTHR) tw[k] = p.tsw[k];
  }
}

// The bias of (query i, key j) with the mask as the -1e30 penalty: rel_pos +
// the time bucket's weight (0 without the bias) for a causal, valid pair.
__device__ __forceinline__ float pair_bias(const AttnArgs& p, int i, int j, const float* cm,
                                           const float* tw, const int* ex) {
  if (i >= p.n || j > i || cm[j] == 0.f) return tc::kMaskPenalty;
  return p.has_bias ? p.rel_pos[static_cast<int64_t>(i) * p.n + j] +
                          tw[time_bucket(ex[i + 1], ex[j], p.max_bucket)]
                    : 0.f;
}

// The (query, key) pair's keep factor of head hd's attention stream.
__device__ __forceinline__ float pair_keep(const AttnArgs& p, int i, int j, uint32_t aseed) {
  if (!p.adrop || i >= p.n) return 1.f;
  return keep_scale(static_cast<uint32_t>(i * p.n + j), aseed, p.athresh, p.ascale);
}

// S (16 x 32) = A rows (16 x 8*KS, stride lda) @ B rows (32 x 8*KS, stride
// ldb)^T, both hi/lo in shared memory.
template <int KS>
__device__ __forceinline__ void rows_by_cols(float (&S)[4][4], const float2* A, int lda,
                                             const float2* Bm, int ldb, int g, int t) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[ni][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    FragA a;
    FragB b[4];
    ld_a(a, A + ks * 8, lda, g, t);
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) ld_b_nk(b[ni], Bm + ni * 8 * ldb + ks * 8, ldb, g, t);
    mma3<4>(S, a, b);
  }
}

// acc (16 x W) += P (16 x 32, C fragments) @ V (32 rows from Vs, stride ld,
// W columns), the 32 rows read in a_from_c's k order.
template <int W>
__device__ __forceinline__ void c_by_rows(float (&acc)[W / 8][4], const float (&P)[4][4],
                                          const float2* Vs, int ld, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    FragA a;
    FragB b[W / 8];
    a_from_c(a, P[ks]);
#pragma unroll
    for (int dn = 0; dn < W / 8; ++dn) ld_b_kn_pair(b[dn], Vs + ks * 8 * ld + dn * 8, ld, g, t);
    mma3<W / 8>(acc, a, b);
  }
}

template <int W>
__device__ __forceinline__ void zero(float (&acc)[W / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < W / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
}

// A warp's (16 x W) fragments into its column warp's slice of the reduction
// buffer R [kColWarps][TR][ldr] at column c0.
template <int W, int TR>
__device__ __forceinline__ void to_reduce(float* R, int ldr, int c0, const float (&acc)[W / 8][4],
                                          int wr, int wc, int g, int t) {
#pragma unroll
  for (int dn = 0; dn < W / 8; ++dn)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wr * 16 + g + half * 8;
      *reinterpret_cast<float2*>(R + (wc * TR + r) * ldr + c0 + dn * 8 + 2 * t) =
          make_float2(acc[dn][half * 2], acc[dn][half * 2 + 1]);
    }
}

// sum_w R[w][r][c] over the column warps in warp order.
template <int TR>
__device__ __forceinline__ float reduced(const float* R, int ldr, int r, int c) {
  float v = R[r * ldr + c];
#pragma unroll
  for (int w = 1; w < kColWarps; ++w) v += R[(w * TR + r) * ldr + c];
  return v;
}

// The bias block of TR rows i0 .. (queries; dkv: keys j0 ..) and ncols
// columns (keys 0 ..; dkv: queries j0 ..), by NTHR threads.
template <int TR, int NTHR>
__device__ __forceinline__ void build_bias(const AttnArgs& p, float* Bc, int ldbc, int r0,
                                           int ncols, bool keys_as_rows, const float* cm,
                                           const float* tw, const int* ex, int tid) {
  for (int e = tid; e < TR * ncols; e += NTHR) {
    const int r = e / ncols, c = e % ncols;
    if (keys_as_rows) {
      const int j = r0 + r;
      Bc[r * ldbc + c] = j < p.n ? pair_bias(p, r0 + c, j, cm, tw, ex) : tc::kMaskPenalty;
    } else {
      Bc[r * ldbc + c] = pair_bias(p, r0 + r, c, cm, tw, ex);
    }
  }
}

// The attention launches walk (head, column block) steps; each step's
// operands land raw by cp.async during the step before, and the step splits
// them into the hi/lo tiles between two barriers. A head's first step also
// takes its row operands.

// Forward (b): attn per (user, TR query rows); see the note at the top.
template <int DQP, int DVP, int TR>
__global__ void __launch_bounds__(Blk<TR>::kThreads, 1) tc_tf32_attn_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  using K = Blk<TR>;
  using L = AttnLayout<DQP, DVP, TR>;
  constexpr int NT = K::kThreads;
  const L lay(kFwd, p.n);
  float* Bc = reinterpret_cast<float*>(tf32_smem);                 // [TR][ldbc] bias block
  float2* Qr = reinterpret_cast<float2*>(tf32_smem + lay.rows);    // [TR][ldq]
  float2* Kc = reinterpret_cast<float2*>(tf32_smem + lay.cols);    // [kBlockCols][ldq]
  float2* Vc = Kc + kBlockCols * L::ldq;                           // [kBlockCols][ldvp]
  float* rraw = reinterpret_cast<float*>(tf32_smem + lay.row_raw); // [TR][DQP]
  float* craw = reinterpret_cast<float*>(tf32_smem + lay.col_raw); // [kBlockCols][DQP + DVP]
  float* cm = reinterpret_cast<float*>(tf32_smem + lay.tables);    // [K::kMaxN]
  float* tw = cm + K::kMaxN;                                       // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);                      // [K::kMaxN + 1]

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * TR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & (K::kRowWarps - 1), wc = warp >> K::kRowShift;
  const int hdv = p.H * p.dv, hq = p.H * p.dqk;
  const float* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const int jmax = min(i0 + TR, p.n), ncols = (jmax + 31) / 32 * 32;
  const int nblk = (jmax + kBlockCols - 1) / kBlockCols, steps = p.H * nblk;
  const bool vec = (p.dqk & 3) == 0 && (p.dv & 3) == 0;
  auto issue = [&](int hd, int blk) {
    if (blk == 0)
      copy_rows<DQP, NT>(rraw, DQP, yb, p.F, 2 * hdv + hd * p.dqk, p.dqk, i0, TR, p.n, vec, tid);
    copy_rows<DQP, NT>(craw, L::cw, yb, p.F, 2 * hdv + hq + hd * p.dqk, p.dqk, blk * kBlockCols,
                       kBlockCols, jmax, vec, tid);
    copy_rows<DVP, NT>(craw + DQP, L::cw, yb, p.F, hdv + hd * p.dv, p.dv, blk * kBlockCols,
                       kBlockCols, jmax, vec, tid);
    tc::cp_async_commit();
  };

  issue(0, 0);
  stage_attn_tables<NT, K::kMaxN>(p, b, cm, tw, ex, tid);
  __syncthreads();
  build_bias<TR, NT>(p, Bc, lay.ldbc, i0, ncols, false, cm, tw, ex, tid);
  float O[DVP / 8][4];
  for (int st = 0; st < steps; ++st) {
    const int hd = st / nblk, blk = st % nblk, kb = blk * kBlockCols;
    const uint32_t aseed = p.adrop ? attn_seed(p.seed0, b, hd) : 0u;
    tc::cp_async_wait<0>();
    __syncthreads();  // this step's raw rows landed; the last step's readers are done
    if (blk == 0) {
      split_rows<DQP, NT>(Qr, L::ldq, rraw, DQP, TR, 1.f, tid);
      zero<DVP>(O);
    }
    split_rows<DQP, NT>(Kc, L::ldq, craw, L::cw, kBlockCols, 1.f, tid);
    split_rows<DVP, NT>(Vc, L::ldvp, craw + DQP, L::cw, kBlockCols, p.inv_n, tid);
    __syncthreads();
    if (st + 1 < steps) issue((st + 1) / nblk, (st + 1) % nblk);
    const int j0 = kb + wc * kTile;
    if (j0 < jmax && j0 <= i0 + wr * 16 + 15 && i0 + wr * 16 < p.n) {
      float S[4][4];
      rows_by_cols<DQP / 8>(S, Qr + wr * 16 * L::ldq, L::ldq, Kc + wc * kTile * L::ldq, L::ldq,
                            g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr * 16 + g + (e >> 1) * 8, j = j0 + ni * 8 + 2 * t + (e & 1);
          const float s = S[ni][e] + Bc[r * lay.ldbc + j];
          float sig, deriv;
          tc::sigma_and_slope(s, sig, deriv);
          S[ni][e] = s * sig * pair_keep(p, i0 + r, j, aseed);
        }
      c_by_rows<DVP>(O, S, Vc + wc * kTile * L::ldvp, L::ldvp, g, t);
    }
    if (blk + 1 < nblk) continue;
    __syncthreads();  // every warp is past its products: the column tiles are free
    float* R = reinterpret_cast<float*>(tf32_smem + lay.cols);   // [kColWarps][TR][DVP + 4]
    constexpr int ldr = DVP + 4;
    to_reduce<DVP, TR>(R, ldr, 0, O, wr, wc, g, t);
    __syncthreads();
    for (int e = tid; e < TR * p.dv; e += NT) {
      const int r = e / p.dv, d = e % p.dv, i = i0 + r;
      if (i < p.n) {
        p.attn[(static_cast<int64_t>(b) * p.n + i) * hdv + hd * p.dv + d] =
            reduced<TR>(R, ldr, r, d);
      }
    }
  }
}

// Backward (b): d_q and dbias per (user, TR query rows); see the note at the top.
template <int DQP, int DVP, int TR>
__global__ void __launch_bounds__(Blk<TR>::kThreads, 1) tc_tf32_dq_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  using K = Blk<TR>;
  using L = AttnLayout<DQP, DVP, TR>;
  constexpr int NT = K::kThreads;
  const L lay(kDq, p.n);
  float* Bc = reinterpret_cast<float*>(tf32_smem);                 // [TR][ldbc]
  float2* Qr = reinterpret_cast<float2*>(tf32_smem + lay.rows);    // [TR][ldq]
  float2* Dr = Qr + TR * L::ldq;                                   // [TR][ldv] d_attn
  float2* Kc = reinterpret_cast<float2*>(tf32_smem + lay.cols);    // [kBlockCols][ldq]
  float2* Vc = Kc + kBlockCols * L::ldq;                           // [kBlockCols][ldv]
  float* rraw = reinterpret_cast<float*>(tf32_smem + lay.row_raw); // [TR][DQP + DVP]
  float* craw = reinterpret_cast<float*>(tf32_smem + lay.col_raw); // [kBlockCols][DQP + DVP]
  float* cm = reinterpret_cast<float*>(tf32_smem + lay.tables);
  float* tw = cm + K::kMaxN;
  int* ex = reinterpret_cast<int*>(tw + 128);

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * TR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & (K::kRowWarps - 1), wc = warp >> K::kRowShift;
  const int hdv = p.H * p.dv, hq = p.H * p.dqk;
  const float* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const float* db_attn = p.d_attn + static_cast<int64_t>(b) * p.n * hdv;
  const int jmax = min(i0 + TR, p.n), ncols = (jmax + 31) / 32 * 32;
  const int nblk = (jmax + kBlockCols - 1) / kBlockCols;
  const bool vec = (p.dqk & 3) == 0 && (p.dv & 3) == 0;
  auto issue = [&](int hd, int blk) {
    if (blk == 0) {
      copy_rows<DQP, NT>(rraw, L::cw, yb, p.F, 2 * hdv + hd * p.dqk, p.dqk, i0, TR, p.n, vec, tid);
      copy_rows<DVP, NT>(rraw + DQP, L::cw, db_attn, hdv, hd * p.dv, p.dv, i0, TR, p.n, vec, tid);
    }
    copy_rows<DQP, NT>(craw, L::cw, yb, p.F, 2 * hdv + hq + hd * p.dqk, p.dqk, blk * kBlockCols,
                       kBlockCols, jmax, vec, tid);
    copy_rows<DVP, NT>(craw + DQP, L::cw, yb, p.F, hdv + hd * p.dv, p.dv, blk * kBlockCols,
                       kBlockCols, jmax, vec, tid);
    tc::cp_async_commit();
  };

  issue(0, 0);
  stage_attn_tables<NT, K::kMaxN>(p, b, cm, tw, ex, tid);
  __syncthreads();
  build_bias<TR, NT>(p, Bc, lay.ldbc, i0, ncols, false, cm, tw, ex, tid);
  float db[K::kSlots][4][4];   // sum_h d_s over the warp's key tile of each column block
#pragma unroll
  for (int s = 0; s < K::kSlots; ++s)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[s][ni][e] = 0.f;
  for (int hd = 0; hd < p.H; ++hd) {
    const uint32_t aseed = p.adrop ? attn_seed(p.seed0, b, hd) : 0u;
    float dQ[DQP / 8][4];
    zero<DQP>(dQ);
#pragma unroll
    for (int s = 0; s < K::kSlots; ++s) {
      if (s >= nblk) break;
      tc::cp_async_wait<0>();
      __syncthreads();
      if (s == 0) {
        split_rows<DQP, NT>(Qr, L::ldq, rraw, L::cw, TR, 1.f, tid);
        split_rows<DVP, NT>(Dr, L::ldv, rraw + DQP, L::cw, TR, 1.f, tid);
      }
      split_rows<DQP, NT>(Kc, L::ldq, craw, L::cw, kBlockCols, 1.f, tid);
      split_rows<DVP, NT>(Vc, L::ldv, craw + DQP, L::cw, kBlockCols, p.inv_n, tid);
      __syncthreads();
      if (s + 1 < nblk) {
        issue(hd, s + 1);
      } else if (hd + 1 < p.H) {
        issue(hd + 1, 0);
      }
      const int j0 = s * kBlockCols + wc * kTile;
      if (j0 >= jmax || j0 > i0 + wr * 16 + 15 || i0 + wr * 16 >= p.n) continue;
      float S[4][4], dA[4][4];
      rows_by_cols<DQP / 8>(S, Qr + wr * 16 * L::ldq, L::ldq, Kc + wc * kTile * L::ldq, L::ldq,
                            g, t);
      rows_by_cols<DVP / 8>(dA, Dr + wr * 16 * L::ldv, L::ldv, Vc + wc * kTile * L::ldv, L::ldv,
                            g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr * 16 + g + (e >> 1) * 8, j = j0 + ni * 8 + 2 * t + (e & 1);
          const float sv = S[ni][e] + Bc[r * lay.ldbc + j];
          float sig, deriv;
          tc::sigma_and_slope(sv, sig, deriv);
          const float ds = dA[ni][e] * pair_keep(p, i0 + r, j, aseed) * deriv;
          db[s][ni][e] += ds;
          S[ni][e] = ds;
        }
      c_by_rows<DQP>(dQ, S, Kc + wc * kTile * L::ldq, L::ldq, g, t);
    }
    __syncthreads();
    float* R = reinterpret_cast<float*>(tf32_smem + lay.cols);   // [kColWarps][TR][DQP + 4]
    constexpr int ldr = DQP + 4;
    to_reduce<DQP, TR>(R, ldr, 0, dQ, wr, wc, g, t);
    __syncthreads();
    for (int e = tid; e < TR * p.dqk; e += NT) {
      const int r = e / p.dqk, d = e % p.dqk, i = i0 + r;
      if (i < p.n) {
        p.d_y[(static_cast<int64_t>(b) * p.n + i) * p.F + 2 * hdv + hd * p.dqk + d] =
            reduced<TR>(R, ldr, r, d);
      }
    }
  }
  if (p.dbias == nullptr) return;
  // dbias through the bias block (dead after the last head), then whole rows.
  __syncthreads();
#pragma unroll
  for (int s = 0; s < K::kSlots; ++s) {
    const int j0 = s * kBlockCols + wc * kTile;
    if (j0 >= ncols) continue;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr * 16 + g + half * 8;
        *reinterpret_cast<float2*>(Bc + r * lay.ldbc + j0 + ni * 8 + 2 * t) =
            make_float2(db[s][ni][half * 2], db[s][ni][half * 2 + 1]);
      }
  }
  __syncthreads();
  const int rows = min(TR, p.n - i0);
  for (int e = tid; e < rows * p.n; e += NT) {
    const int r = e / p.n, j = e % p.n;
    p.dbias[(static_cast<int64_t>(b) * p.n + i0 + r) * p.n + j] =
        j < ncols ? Bc[r * lay.ldbc + j] : 0.f;
  }
}

// Backward (c): d_k and d_v per (user, TR key rows); see the note at the top.
template <int DQP, int DVP, int TR>
__global__ void __launch_bounds__(Blk<TR>::kThreads, 1) tc_tf32_dkv_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char tf32_smem[];
  using K = Blk<TR>;
  using L = AttnLayout<DQP, DVP, TR>;
  constexpr int NT = K::kThreads;
  const L lay(kDkv, p.n);
  float* Bc = reinterpret_cast<float*>(tf32_smem);                 // [TR keys][ldbc queries]
  float2* Kr = reinterpret_cast<float2*>(tf32_smem + lay.rows);    // [TR][ldq]
  float2* Vr = Kr + TR * L::ldq;                                   // [TR][ldv]
  float2* Qc = reinterpret_cast<float2*>(tf32_smem + lay.cols);    // [kBlockCols][ldq]
  float2* Dc = Qc + kBlockCols * L::ldq;                           // [kBlockCols][ldv] d_attn
  float* rraw = reinterpret_cast<float*>(tf32_smem + lay.row_raw); // [TR][DQP + DVP]
  float* craw = reinterpret_cast<float*>(tf32_smem + lay.col_raw); // [kBlockCols][DQP + DVP]
  float* cm = reinterpret_cast<float*>(tf32_smem + lay.tables);
  float* tw = cm + K::kMaxN;
  int* ex = reinterpret_cast<int*>(tw + 128);

  const int b = blockIdx.x, j0 = blockIdx.y * TR;   // heavy key tiles (most queries) first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & (K::kRowWarps - 1), wc = warp >> K::kRowShift;
  const int hdv = p.H * p.dv, hq = p.H * p.dqk;
  const float* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const float* db_attn = p.d_attn + static_cast<int64_t>(b) * p.n * hdv;
  const int nq = p.n - j0, ncols = (nq + 31) / 32 * 32;   // queries j0 .. n-1
  const int nblk = (nq + kBlockCols - 1) / kBlockCols, steps = p.H * nblk;
  const bool vec = (p.dqk & 3) == 0 && (p.dv & 3) == 0;
  auto issue = [&](int hd, int blk) {
    if (blk == 0) {
      copy_rows<DQP, NT>(rraw, L::cw, yb, p.F, 2 * hdv + hq + hd * p.dqk, p.dqk, j0, TR, p.n, vec,
                         tid);
      copy_rows<DVP, NT>(rraw + DQP, L::cw, yb, p.F, hdv + hd * p.dv, p.dv, j0, TR, p.n, vec, tid);
    }
    const int qb = j0 + blk * kBlockCols;
    copy_rows<DQP, NT>(craw, L::cw, yb, p.F, 2 * hdv + hd * p.dqk, p.dqk, qb, kBlockCols, p.n, vec,
                       tid);
    copy_rows<DVP, NT>(craw + DQP, L::cw, db_attn, hdv, hd * p.dv, p.dv, qb, kBlockCols, p.n, vec,
                       tid);
    tc::cp_async_commit();
  };

  issue(0, 0);
  stage_attn_tables<NT, K::kMaxN>(p, b, cm, tw, ex, tid);
  __syncthreads();
  build_bias<TR, NT>(p, Bc, lay.ldbc, j0, ncols, true, cm, tw, ex, tid);
  float dK[DQP / 8][4], dV[DVP / 8][4];
  for (int st = 0; st < steps; ++st) {
    const int hd = st / nblk, blk = st % nblk, qb = j0 + blk * kBlockCols;
    const uint32_t aseed = p.adrop ? attn_seed(p.seed0, b, hd) : 0u;
    tc::cp_async_wait<0>();
    __syncthreads();
    if (blk == 0) {
      split_rows<DQP, NT>(Kr, L::ldq, rraw, L::cw, TR, 1.f, tid);
      split_rows<DVP, NT>(Vr, L::ldv, rraw + DQP, L::cw, TR, p.inv_n, tid);
      zero<DQP>(dK);
      zero<DVP>(dV);
    }
    split_rows<DQP, NT>(Qc, L::ldq, craw, L::cw, kBlockCols, 1.f, tid);
    split_rows<DVP, NT>(Dc, L::ldv, craw + DQP, L::cw, kBlockCols, 1.f, tid);
    __syncthreads();
    if (st + 1 < steps) issue((st + 1) / nblk, (st + 1) % nblk);
    const int q0 = qb + wc * kTile;
    // A query at or after the warp's keys, and a key before n.
    if (q0 < p.n && q0 + kTile - 1 >= j0 + wr * 16 && j0 + wr * 16 < p.n) {
      float S[4][4], dA[4][4];
      rows_by_cols<DQP / 8>(S, Kr + wr * 16 * L::ldq, L::ldq, Qc + wc * kTile * L::ldq, L::ldq,
                            g, t);
      rows_by_cols<DVP / 8>(dA, Vr + wr * 16 * L::ldv, L::ldv, Dc + wc * kTile * L::ldv, L::ldv,
                            g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr * 16 + g + (e >> 1) * 8, i = q0 + ni * 8 + 2 * t + (e & 1);
          const float sv = S[ni][e] + Bc[r * lay.ldbc + i - j0];
          float sig, deriv;
          tc::sigma_and_slope(sv, sig, deriv);
          const float keep = pair_keep(p, i, j0 + r, aseed);
          S[ni][e] = sv * sig * keep;
          dA[ni][e] = dA[ni][e] * keep * deriv;
        }
      c_by_rows<DQP>(dK, dA, Qc + wc * kTile * L::ldq, L::ldq, g, t);
      c_by_rows<DVP>(dV, S, Dc + wc * kTile * L::ldv, L::ldv, g, t);
    }
    if (blk + 1 < nblk) continue;
    __syncthreads();
    // [kColWarps][TR][DQP + DVP + 8]
    float* R = reinterpret_cast<float*>(tf32_smem + lay.cols);
    constexpr int ldr = DQP + DVP + 8;
    to_reduce<DQP, TR>(R, ldr, 0, dK, wr, wc, g, t);
    to_reduce<DVP, TR>(R, ldr, DQP + 4, dV, wr, wc, g, t);
    __syncthreads();
    const int koff = 2 * hdv + hq + hd * p.dqk, voff = hdv + hd * p.dv;
    for (int e = tid; e < TR * (p.dqk + p.dv); e += NT) {
      const int r = e / (p.dqk + p.dv), c = e % (p.dqk + p.dv), j = j0 + r;
      if (j >= p.n) continue;
      float* dyj = p.d_y + (static_cast<int64_t>(b) * p.n + j) * p.F;
      if (c < p.dqk) {
        dyj[koff + c] = reduced<TR>(R, ldr, r, c);
      } else {
        dyj[voff + c - p.dqk] = reduced<TR>(R, ldr, r, DQP + 4 + c - p.dqk) * p.inv_n;
      }
    }
  }
}

// ---- host launchers ----------------------------------------------------------

template <int DQP, int DVP, int TR>
cudaError_t launch_attn_rows(int kind, const AttnArgs& p, int B, cudaStream_t s) {
  const size_t smem = AttnLayout<DQP, DVP, TR>(kind, p.n).bytes;
  const dim3 grid(B, (p.n + TR - 1) / TR);
  constexpr int threads = Blk<TR>::kThreads;
  cudaError_t err;
  switch (kind) {
    case kFwd:
      if ((err = allow_smem(tc_tf32_attn_kernel<DQP, DVP, TR>, smem)) != cudaSuccess) return err;
      tc_tf32_attn_kernel<DQP, DVP, TR><<<grid, threads, smem, s>>>(p);
      break;
    case kDq:
      if ((err = allow_smem(tc_tf32_dq_kernel<DQP, DVP, TR>, smem)) != cudaSuccess) return err;
      tc_tf32_dq_kernel<DQP, DVP, TR><<<grid, threads, smem, s>>>(p);
      break;
    default:
      if ((err = allow_smem(tc_tf32_dkv_kernel<DQP, DVP, TR>, smem)) != cudaSuccess) return err;
      tc_tf32_dkv_kernel<DQP, DVP, TR><<<grid, threads, smem, s>>>(p);
  }
  return cudaGetLastError();
}

// 64-row blocks up to n = 256, 32-row ones past it (`block_rows`).
template <int DQP, int DVP>
cudaError_t launch_attn_kind(int kind, const AttnArgs& p, int B, cudaStream_t s) {
  return block_rows(p.n) == 64 ? launch_attn_rows<DQP, DVP, 64>(kind, p, B, s)
                               : launch_attn_rows<DQP, DVP, 32>(kind, p, B, s);
}

template <int DQP, int DVP>
size_t attn_layout_bytes(int kind, int n) {
  return block_rows(n) == 64 ? AttnLayout<DQP, DVP, 64>(kind, n).bytes
                             : AttnLayout<DQP, DVP, 32>(kind, n).bytes;
}

// One attention launch (forward, dq or dkv) at the instance of its padded widths.
cudaError_t launch_attn(int kind, const AttnArgs& p, int B, cudaStream_t s) {
  if (!tc::tf32_widths_ok(1, p.H, p.dqk, p.dv, p.n) || kind < kFwd || kind > kDkv)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const bool q16 = pad_w(p.dqk) == 16, v16 = pad_w(p.dv) == 16;
  if (q16) {
    return v16 ? launch_attn_kind<16, 16>(kind, p, B, s) : launch_attn_kind<16, 32>(kind, p, B, s);
  }
  return v16 ? launch_attn_kind<32, 16>(kind, p, B, s) : launch_attn_kind<32, 32>(kind, p, B, s);
}

size_t attn_smem_bytes(int kind, int n, int dqk, int dv) {
  const bool q16 = pad_w(dqk) == 16, v16 = pad_w(dv) == 16;
  if (q16) return v16 ? attn_layout_bytes<16, 16>(kind, n) : attn_layout_bytes<16, 32>(kind, n);
  return v16 ? attn_layout_bytes<32, 16>(kind, n) : attn_layout_bytes<32, 32>(kind, n);
}

cudaError_t launch_proj(const GemmArgs& p, cudaStream_t s) {
  if (p.M == 0) return cudaSuccess;
  const size_t smem = proj_smem_bytes(p.K);
  cudaError_t err = allow_smem(tc_tf32_proj_kernel, smem);
  if (err != cudaSuccess) return err;
  tc_tf32_proj_kernel<<<(p.M + kGM - 1) / kGM, kGemmThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_out(const GemmArgs& p, cudaStream_t s) {
  if (p.M == 0) return cudaSuccess;
  const size_t smem = gemm_smem_bytes();
  cudaError_t err = allow_smem(tc_tf32_out_kernel, smem);
  if (err != cudaSuccess) return err;
  tc_tf32_out_kernel<<<(p.M + kGM - 1) / kGM, kGemmThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace tf32
}  // namespace
}  // namespace rails
