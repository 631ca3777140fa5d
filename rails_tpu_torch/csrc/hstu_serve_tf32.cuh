// K1's f32 serving block on the H100's tensor cores: every product of the
// block as 3xTF32 on mma.sync m16n8k8 with f32 accumulators (the split and
// fragments of tf32_mma.cuh, which K4's f32 route shares).
//
// Replaces, for f32 operands, the body `_kernel` of
// rails_tpu/ops/pallas/hstu_block.py (:96-276) at the widths of the bf16
// tensor-core kernels (hstu_block_tc.cuh `widths_ok`: D <= 272, dqk and dv <=
// 32, h <= 3 or an even h <= 8) with n <= 512 and the SiLU projection (the
// softmax attention where its (64, n) scores fit a block: ops/hstu_block.py
// `tf32_block`), which takes the rated (D = 264) and combined (n = 422)
// preprocessors' blocks: the bias built in-kernel, read from an f32 (B, n, n)
// tensor (raw, or carrying mask_in_bias's -30000 penalty) or absent; the
// pointwise SiLU attention or the softmax one; u * LN(attn) or concat_ua's
// [u, LN(attn), u * LN(attn)].
// linear_activation="none", wider heads and longer sequences keep the
// CUDA-core kernels of hstu_block.cuh (ops/hstu_block.py `tf32_block`).
//
// Bound. At ml-20m-hstu-mol's serving block (B = 512, n = 211, D = 256, h =
// 8, dqk = dv = 32; M = B n = 108,032 rows) the block needs 82.5 GFLOP:
// the projection 56.6, the attention 11.7 (softmax: 35.0, its scores over
// every pair), the output GEMM 14.2. At 3xTF32's 165 TFLOP/s (a third of
// wgmma's 495 TF32) the projection takes 0.343 ms; the attention and the
// output GEMM are bound by their bytes (y's v, q, k in and attn out; u, attn,
// x in and out: ~0.44 GB each, 0.13 ms at 3.35 TB/s).
//
// Design, three launches as on the other routes, every operand staged raw
// f32 and split into hi/lo in registers as its fragment is read (an operand
// costs one 4-byte shared load a value, not an 8-byte hi/lo one, and no pass
// of its own):
//   1. serve_proj_kernel: y = SiLU(LN(x) @ uvqk), (M, F) f32, [u | v | q | k].
//      A block owns 128 rows: it takes their LayerNorm statistics
//      (population variance, two passes), keeps LN(x) resident in shared
//      memory (133 KB at D = 256, 146 KB at D = 264, zeros from D to the next
//      multiple of 32) and walks the F columns in 128-wide tiles,
//      uvqk's 32-deep chunks streaming through a 4-stage cp.async ring (70
//      KB): x is read once, uvqk once per 128 rows. 16 warps of 32 x 32
//      outputs, one block an SM. The SiLU by __expf and __fdividef.
//   2. serve_attn_kernel (pointwise) / serve_softmax_kernel: attn (B, n,
//      h*dv) f32 per (user, 64 query rows), the causal-heavy row blocks
//      first. Pointwise: the bias block of the 64 rows and every causal key
//      (rel_pos[i, j] + tsw[time_bucket(ext[i+1] - ext[j])], or the tensor's,
//      or 0; a masked pair holds the -1e30 penalty, whose SiLU is -0, the
//      mask multiply's 0) is built once for every head. 8 warps = 4 row tiles
//      x 2 heads: each warp owns its 16 rows of one head over every key (no
//      partial sums to reduce), its q fragments split once in registers; two
//      heads' k and v stream in 32-key chunks through a 2-stage cp.async
//      ring, one barrier a chunk, chunks whose keys are all invalid skipped.
//      s = q k^T + bias, a = SiLU(s) (`silu_fast`), a split from the score
//      fragments into the A fragments of a (v / max_seq_len). 99-107 KB at
//      n = 211-256: two blocks an SM; 155 KB at n = 422, one. Softmax (one
//      map over the whole h*dqk
//      contraction): the block stages its 64 q rows, streams every key's k
//      in 32-key chunks and keeps the (64, n) scores (q.k + bias) / sqrt(dqk)
//      in shared memory; each row is normalised over all n columns (expf and
//      an IEEE division) and masked after normalisation; a v then runs over
//      the causal key chunks with a valid key and every value column, v
//      unscaled, a read from the scores in a_from_c's pair order. 16 warps = 4
//      row tiles x 4 key (value-column) quarters; 193-201 KB at n = 211-256,
//      one block an SM; past n = 352 at h*dqk = 256 the scores no longer fit.
//   3. serve_out_kernel: out = o_input @ Wo + bo + x. A block owns 64 rows
//      (8 warps of 32 x 32 outputs) and walks the D columns in 128-wide
//      tiles; attn's, u's and Wo's chunks stream through a 3-stage ring, and
//      each landed chunk becomes o_input in place (u * LN(attn), or concat_ua's
//      [u, LN(attn), u * LN(attn)], from per-row statistics of attn taken
//      once) while the chunk before it is multiplied. 108 KB, two blocks an
//      SM.
// Why mma.sync and not wgmma: TF32 wgmma takes its B operand (and, from
// shared memory, A) only K-major, through descriptors, so both hi and lo of
// every operand would sit split in shared memory (8 bytes a value) and every
// 3xTF32 slice would read twice the bytes of a raw one; at a 64 x 128 tile
// the split hi/lo B stream alone would need ~5 TB/s from L2 at wgmma's rate.
// mma.sync takes register fragments, so the split happens in registers on
// raw f32 tiles, the design above. Its ceiling is mma.sync's TF32 rate (~316
// TFLOP/s, ~105 for 3xTF32; profile_k4_f32.py --mma-rate): 0.54 ms for the
// projection. What the stages reach and what holds them back is in PERF.md
// (`profile_k1_tf32.py` times each stage and variants of this header).
// Every output element has one writer, no atomics: two calls give the same
// bits. The products' order: k in 8-wide steps, each as lo.hi + hi.lo +
// hi.hi; the attention's keys in 32-key chunks in order.
#pragma once

#include <cstdint>

#include "hstu_block_tc.cuh"
#include "tf32_mma.cuh"

namespace rails {
namespace {
namespace k1tf32 {

using tf32::cp_async4;
using tf32::FragA;
using tf32::FragB;
using tf32::mma3;
using tf32::pad_w;
using tf32::set_a;
using tf32::set_b;
using tf32::split;

constexpr int kMaxN = tc::kTf32MaxN;
constexpr float kPenalty = tc::kMaskPenalty;


// ---- the GEMMs: projection and output --------------------------------------

// The projection's SiLU, y / (1 + e^-y) by __expf and __fdividef, within
// ~2e-6 relative of y sigma(y) for |y| <= 20 (as `silu_fast` below): with the
// accurate expf and an IEEE reciprocal the epilogue took 13% of the
// projection's time (profile_k1_tf32.py --variant accurate-silu-proj).
__device__ __forceinline__ float silu_proj(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

constexpr int kBN = 128, kBK = 32;
constexpr int kLdW = kBN + 8;                // raw W chunk row stride, 8 (mod 32)

struct GemmArgs {
  const float* a;       // proj: x (M, K); out: attn (M, hdv)
  const float* u;       // out: y (M, ldu), u its first hdv columns
  const float* w;       // (K, N): uvqk or o_kernel
  const float* bias;    // out: (N,)
  const float* resid;   // out: x (M, N)
  float* out;           // (M, N): y or the block's output
  int64_t M;
  int K, N, hdv, ldu, concat_ua;
  float eps;
};

// W's chunk (rows k0.., columns n0..) into a raw [kBK][kLdW] stage by NTHR
// threads; zeros past K and N.
template <int NTHR>
__device__ __forceinline__ void load_w(float* W, const GemmArgs& p, int k0, int n0, bool vec,
                                       int tid) {
  if (vec) {
    for (int e = tid; e < kBK * (kBN / 4); e += NTHR) {
      const int r = e / (kBN / 4), c = (e % (kBN / 4)) * 4, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      tc::cp_async16(W + r * kLdW + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  } else {
    for (int e = tid; e < kBK * kBN; e += NTHR) {
      const int r = e / kBN, c = e % kBN, k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      cp_async4(W + r * kLdW + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  }
}

// The population mean and 1/sqrt(var + eps) of a row of width <= 32 Q by one
// warp, two passes; 0 for a row past M.
template <int Q>
__device__ __forceinline__ float2 row_stats(const float* src, bool live, int width, float eps,
                                            int lane, float (&v)[Q]) {
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    v[q] = live && k < width ? src[k] : 0.f;
    sum += v[q];
  }
  if (!live) return make_float2(0.f, 0.f);
  const float mean = warp_sum(sum) / width;
  float var = 0.f;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = lane + 32 * q;
    if (k < width) {
      const float d = v[q] - mean;
      var = fmaf(d, d, var);
    }
  }
  return make_float2(mean, rsqrtf(warp_sum(var) / width + eps));
}

// Launch 1, see the note at the top: a block owns 128 rows, normalises them
// once into shared memory (all K <= 272 columns, 133-146 KB) and walks the F
// columns in 128-wide tiles, uvqk's chunks streaming raw through a 4-stage
// ring (70 KB): x is read once and uvqk once per 128 rows. 16 warps of 32 x
// 32 outputs, one block an SM.
constexpr int kRWarpsM = 4;                       // row warps (x 4 column warps)
constexpr int kRThreads = 32 * 4 * kRWarpsM;
constexpr int kRM = 128, kRWarpM = kRM / kRWarpsM, kRMI = kRWarpM / 16, kRStages = 4;

__host__ __device__ inline int proj_lda(int K) { return (K + kBK - 1) / kBK * kBK + 4; }

inline size_t proj_smem_bytes(int K) {
  return (static_cast<size_t>(kRM) * proj_lda(K) + kRStages * kBK * kLdW) * sizeof(float);
}

// LN(x) of the block's rows into As, once; zeros past K (to the chunk edge
// lda - 4 <= 32 Q) and past M. Q = 8 up to K = 256, 9 up to 288.
template <int Q>
__device__ __forceinline__ void proj_ln(const GemmArgs& p, float* As, int lda, int64_t m0,
                                        int warp, int lane) {
  for (int r = warp; r < kRM; r += kRThreads / 32) {
    const bool live = m0 + r < p.M;
    float v[Q];
    const float2 st = row_stats(p.a + (m0 + r) * p.K, live, p.K, p.eps, lane, v);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < lda - 4) As[r * lda + k] = live && k < p.K ? (v[q] - st.x) * st.y : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kRThreads, 1) serve_proj_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char serve_smem[];
  const int lda = proj_lda(p.K), KT = (p.K + kBK - 1) / kBK;
  float* As = reinterpret_cast<float*>(serve_smem);            // [kRM][lda] LN(x)
  float* ring = As + kRM * lda;                                  // kRStages x [kBK][kLdW]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp % kRWarpsM, wn = warp / kRWarpsM;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kRM;
  const int NT = (p.N + kBN - 1) / kBN, total = KT * NT;
  const bool vec_w = (p.N & 3) == 0;
  // uvqk's chunk of step s (column tile s / KT, k chunk s % KT) into its stage.
  auto load = [&](int s) {
    if (s < total)
      load_w<kRThreads>(ring + (s % kRStages) * kBK * kLdW, p, (s % KT) * kBK, (s / KT) * kBN,
                        vec_w, tid);
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kRStages - 1; ++s) load(s);
  if (p.K > 256) {
    proj_ln<9>(p, As, lda, m0, warp, lane);
  } else {
    proj_ln<8>(p, As, lda, m0, warp, lane);
  }

  float acc[kRMI][4][4];
  for (int it = 0; it < total; ++it) {
    const int kt = it % KT;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < kRMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    tc::cp_async_wait<kRStages - 2>();
    __syncthreads();  // stage it landed (and LN(x) on the first step); stage it - 1 is read
    load(it + kRStages - 1);
    const float* A = As + wm * kRWarpM * lda + kt * kBK;
    const float* W = ring + (it % kRStages) * kBK * kLdW + wn * 32;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      FragB b[4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        set_b(b[ni], 0, split(W[(ks * 8 + t) * kLdW + ni * 8 + g]));
        set_b(b[ni], 1, split(W[(ks * 8 + t + 4) * kLdW + ni * 8 + g]));
      }
      FragA a[kRMI];
#pragma unroll
      for (int mi = 0; mi < kRMI; ++mi) {
        const float* ar = A + (mi * 16 + g) * lda + ks * 8 + t;
        set_a(a[mi], 0, split(ar[0]));
        set_a(a[mi], 1, split(ar[8 * lda]));
        set_a(a[mi], 2, split(ar[4]));
        set_a(a[mi], 3, split(ar[8 * lda + 4]));
      }
#pragma unroll
      for (int mi = 0; mi < kRMI; ++mi) mma3<4>(acc[mi], a[mi], b);
    }
    if (kt == KT - 1) {
      const int n0 = (it / KT) * kBN;
      const bool pairs = (p.N & 1) == 0;
#pragma unroll
      for (int mi = 0; mi < kRMI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t row = m0 + wm * kRWarpM + mi * 16 + g + half * 8;
          if (row >= p.M) continue;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * t;
            const float v0 = silu_proj(acc[mi][ni][half * 2]);
            const float v1 = silu_proj(acc[mi][ni][half * 2 + 1]);
            if (pairs && col + 1 < p.N) {
              *reinterpret_cast<float2*>(p.out + row * p.N + col) = make_float2(v0, v1);
            } else {
              if (col < p.N) p.out[row * p.N + col] = v0;
              if (col + 1 < p.N) p.out[row * p.N + col + 1] = v1;
            }
          }
        }
    }
  }
}

// Launch 3, see the note at the top: a block owns 64 rows and walks the D
// columns in 128-wide tiles (8 warps of 32 x 32), attn's, u's and Wo's
// chunks streaming raw through a 3-stage ring (108 KB, two blocks an SM).
// Step it computes on stage it, builds o_input in place over attn's chunk of
// stage it + 1 (landed) and has stage it + 2 in flight.
constexpr int kOThreads = 256;
constexpr int kOM = 64, kOMI = 2, kLdA = kBK + 4, kOStages = 3;   // kLdA: 4 (mod 32)
constexpr int kOStage = 2 * kOM * kLdA + kBK * kLdW;             // attn, u, Wo chunks

inline size_t out_smem_bytes() {
  return (static_cast<size_t>(kOStages) * kOStage + 2 * kOM) * sizeof(float);
}

// attn's and u's chunk (o_input columns k0..: attn's and u's k % hdv) and
// Wo's into a stage; zeros past M and K.
__device__ __forceinline__ void load_out_stage(float* st, const GemmArgs& p, int64_t m0, int k0,
                                               int n0, bool vec_a, bool vec_w, int tid) {
  load_w<kOThreads>(st + 2 * kOM * kLdA, p, k0, n0, vec_w, tid);
  const int w = vec_a ? 4 : 1;
  for (int e = tid; e < kOM * (kBK / w); e += kOThreads) {
    const int r = e / (kBK / w), c = (e % (kBK / w)) * w, k = k0 + c;
    const int64_t row = m0 + r;
    const bool ok = row < p.M && k < p.K;
    const int src = k >= p.hdv ? k % p.hdv : k;
    const float* a = ok ? p.a + row * p.hdv + src : p.a;
    const float* u = ok ? p.u + row * p.ldu + src : p.u;
    if (vec_a) {
      tc::cp_async16(st + r * kLdA + c, a, ok);
      tc::cp_async16(st + (kOM + r) * kLdA + c, u, ok);
    } else {
      cp_async4(st + r * kLdA + c, a, ok);
      cp_async4(st + (kOM + r) * kLdA + c, u, ok);
    }
  }
}

// o_input's chunk (columns k0..) over attn's slot, each value once: u *
// LN(attn), or the part k / hdv of concat_ua's [u, LN(attn), u * LN(attn)].
// Rows past M read 0 with mu = rs = 0; columns past K meet Wo's zero rows.
__device__ __forceinline__ void build_oinput(float* st, const GemmArgs& p, const float* mu,
                                             const float* rs, int k0, int tid) {
  for (int e = tid; e < kOM * (kBK / 4); e += kOThreads) {
    const int r = e / (kBK / 4), c = (e % (kBK / 4)) * 4;
    float4* a = reinterpret_cast<float4*>(st + r * kLdA + c);
    const float4 u4 = *reinterpret_cast<const float4*>(st + (kOM + r) * kLdA + c);
    float v[4] = {a->x, a->y, a->z, a->w};
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + c + q;
      v[q] = (v[q] - mu[r]) * rs[r];
      v[q] = !p.concat_ua || k >= 2 * p.hdv ? u[q] * v[q] : k < p.hdv ? u[q] : v[q];
    }
    *a = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__global__ void __launch_bounds__(kOThreads, 2) serve_out_kernel(GemmArgs p) {
  extern __shared__ __align__(16) unsigned char serve_smem[];
  float* ring = reinterpret_cast<float*>(serve_smem);   // kOStages x kOStage
  float* mu = ring + kOStages * kOStage;                // [kOM]
  float* rs = mu + kOM;                                 // [kOM]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kOM;
  const int KT = (p.K + kBK - 1) / kBK, NT = (p.N + kBN - 1) / kBN, total = KT * NT;
  const bool vec_w = (p.N & 3) == 0, vec_a = (p.hdv & 3) == 0 && (p.ldu & 3) == 0;

#pragma unroll
  for (int s = 0; s < kOStages - 1; ++s) {
    if (s < total)
      load_out_stage(ring + s * kOStage, p, m0, (s % KT) * kBK, (s / KT) * kBN, vec_a, vec_w, tid);
    tc::cp_async_commit();
  }
  // LayerNorm statistics of attn's rows.
  for (int r = warp; r < kOM; r += kOThreads / 32) {
    float v[8];
    const float2 st = row_stats(p.a + (m0 + r) * p.hdv, m0 + r < p.M, p.hdv, p.eps, lane, v);
    if (lane == 0) {
      mu[r] = st.x;
      rs[r] = st.y;
    }
  }
  tc::cp_async_wait<kOStages - 2>();
  __syncthreads();   // stage 0 landed; the statistics are written
  build_oinput(ring, p, mu, rs, 0, tid);

  float acc[kOMI][4][4];
  for (int it = 0; it < total; ++it) {
    const int kt = it % KT;
    if (kt == 0) {
#pragma unroll
      for (int mi = 0; mi < kOMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
    tc::cp_async_wait<kOStages - 3>();
    __syncthreads();  // stage it built, stage it + 1 landed; stage it - 1 is read
    const int nx = it + kOStages - 1;
    if (nx < total) {
      load_out_stage(ring + (nx % kOStages) * kOStage, p, m0, (nx % KT) * kBK, (nx / KT) * kBN,
                     vec_a, vec_w, tid);
    }
    tc::cp_async_commit();
    if (it + 1 < total)
      build_oinput(ring + ((it + 1) % kOStages) * kOStage, p, mu, rs, ((it + 1) % KT) * kBK, tid);
    const float* A = ring + (it % kOStages) * kOStage + wm * 32 * kLdA;
    const float* W = ring + (it % kOStages) * kOStage + 2 * kOM * kLdA + wn * 32;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      FragB b[4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        set_b(b[ni], 0, split(W[(ks * 8 + t) * kLdW + ni * 8 + g]));
        set_b(b[ni], 1, split(W[(ks * 8 + t + 4) * kLdW + ni * 8 + g]));
      }
#pragma unroll
      for (int mi = 0; mi < kOMI; ++mi) {
        FragA a;
        const float* ar = A + (mi * 16 + g) * kLdA + ks * 8 + t;
        set_a(a, 0, split(ar[0]));
        set_a(a, 1, split(ar[8 * kLdA]));
        set_a(a, 2, split(ar[4]));
        set_a(a, 3, split(ar[8 * kLdA + 4]));
        mma3<4>(acc[mi], a, b);
      }
    }
    if (kt < KT - 1) continue;
    const int n0 = (it / KT) * kBN;
    const bool pairs = (p.N & 1) == 0;
#pragma unroll
    for (int mi = 0; mi < kOMI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = m0 + wm * 32 + mi * 16 + g + half * 8;
        if (row >= p.M) continue;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = n0 + wn * 32 + ni * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)   // (o_input @ Wo + bo) + x, as the plain version
            v[e] = col + e < p.N ? acc[mi][ni][half * 2 + e] + p.bias[col + e] +
                                       p.resid[row * p.N + col + e]
                                 : 0.f;
          if (pairs && col + 1 < p.N) {
            *reinterpret_cast<float2*>(p.out + row * p.N + col) = make_float2(v[0], v[1]);
          } else if (col < p.N) {
            p.out[row * p.N + col] = v[0];
            if (col + 1 < p.N) p.out[row * p.N + col + 1] = v[1];
          }
        }
      }
  }
}

// ---- the attention: pointwise and softmax ----------------------------------

// The attention weights' SiLU, s / (1 + e^-s) by __expf and __fdividef
// (hstu_block_tc.cuh's silu_bf16): within ~2e-6 relative of the IEEE value
// for |s| <= 20, 2 + 1.16 |s| ulp of e^-s and 2 ulp of the quotient, against
// a 2e-5 stage limit; the accurate expf and reciprocal tripled the
// attention's instructions. At the -1e30 penalty 1 + e^-s = inf and the
// result is -0, the mask multiply's 0.
__device__ __forceinline__ float silu_fast(float s) { return __fdividef(s, 1.0f + __expf(-s)); }

constexpr int kRows = 64;             // query rows of a block
constexpr int kKeys = 32;             // keys of a chunk
constexpr int kAttnThreads = 256;     // pointwise: 8 warps, 4 row tiles x 2 heads
constexpr int kChunks = kMaxN / kKeys;

struct AttnArgs {
  const float* y;        // (B*n, F): [u | v | q | k]
  const float* colmask;  // (B, n)
  const float* rel_pos;  // (n, n)    internal bias
  const int* ext;        // (B, n+1)  internal bias
  const float* tsw;      // (128,)    internal bias
  const float* bias;     // (B, n, n) tensor bias
  float* attn;           // (B*n, H*dv)
  int n, H, dqk, dv, F, bias_mode, max_bucket;
  float inv_n, inv_sqrt_dqk;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The tables after the attention's tiles: column validity [kMaxN] (zeros
// past n), time-bucket weights [128], extended timestamps [kMaxN + 1], and
// the ids of the key chunks with a valid key [kChunks + 1] (count first).
__host__ __device__ constexpr size_t tables_bytes() {
  return (kMaxN + 128) * sizeof(float) + (kMaxN + 1 + kChunks + 1) * sizeof(int);
}

// Pointwise: the bias block [kRows][ldbc], then two ring stages of two heads'
// k [kKeys][DQP + 4] and v [kKeys][DVP + 4] rows.
template <int DQP, int DVP>
struct PointLayout {
  static constexpr int ldk = DQP + 4, ldv = DVP + 4;
  static constexpr int head_floats = kKeys * (ldk + ldv);
  int ldbc;
  size_t ring, tables, bytes;
  __host__ __device__ explicit PointLayout(int n) {
    ldbc = round_up(n, 32) + 8;   // 8 (mod 32) floats
    ring = static_cast<size_t>(kRows) * ldbc * sizeof(float);
    tables = ring + 2 * 2 * head_floats * sizeof(float);
    bytes = tables + tables_bytes();
  }
};

// Softmax: the scores [kRows][lds], q rows [kRows][ldq], two ring stages of
// 32 keys' k (then v) rows.
struct SoftLayout {
  int hq8, hv8, ldq, ldv, lds, ring_w;
  size_t q, ring, tables, bytes;
  __host__ __device__ SoftLayout(int n, int H, int dqk, int dv) {
    hq8 = round_up(H * dqk, 8);
    hv8 = round_up(H * dv, 8);
    ldq = hq8 + 4;                 // 4 (mod 8)
    ldv = hv8 + 4;
    lds = round_up(n, 32) + 8;     // 8 (mod 32)
    ring_w = ldq > ldv ? ldq : ldv;
    q = static_cast<size_t>(kRows) * lds * sizeof(float);
    ring = q + static_cast<size_t>(kRows) * ldq * sizeof(float);
    tables = ring + static_cast<size_t>(2) * kKeys * ring_w * sizeof(float);
    bytes = tables + tables_bytes();
  }
};

// cp.async of one user's rows r0 .. r0+R of columns [off, off+w) (row
// stride ld_src) into raw (stride ldr) as W columns by NTHR threads: zeros
// past w and at or past lim. vec: 16-byte copies (ld_src, off, w and W
// multiples of 4).
template <int NTHR>
__device__ __forceinline__ void copy_rows(float* raw, int ldr, const float* src, int ld_src,
                                          int off, int w, int W, int r0, int R, int lim,
                                          bool vec, int tid) {
  if (vec) {
    const int w4 = W / 4;
    for (int e = tid; e < R * w4; e += NTHR) {
      const int r = e / w4, c = e % w4 * 4;
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

// Column validity (zeros past n), with the internal bias its tables, and the
// list of key chunks below `keys` with at least one valid key; NTHR threads.
template <int NTHR = kAttnThreads>
__device__ __forceinline__ void stage_tables(const AttnArgs& p, int b, int keys, float* cm,
                                             float* tw, int* ex, int* chunks, int tid) {
  for (int j = tid; j < kMaxN; j += NTHR)
    cm[j] = j < p.n ? p.colmask[static_cast<int64_t>(b) * p.n + j] : 0.f;
  if (p.bias_mode == kBiasInternal) {
    for (int j = tid; j <= p.n; j += NTHR) ex[j] = p.ext[static_cast<int64_t>(b) * (p.n + 1) + j];
    for (int k = tid; k < 128; k += NTHR) tw[k] = p.tsw[k];
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int c = 0; c * kKeys < keys; ++c) {
      if (__any_sync(0xffffffffu, cm[c * kKeys + tid] != 0.f)) {
        if (tid == 0) chunks[1 + count] = c;
        ++count;
      }
    }
    if (tid == 0) chunks[0] = count;
  }
}

// The bias of (query i, key j): the in-kernel one, the tensor's or 0.
__device__ __forceinline__ float bias_of(const AttnArgs& p, int b, int i, int j, const float* tw,
                                         const int* ex) {
  switch (p.bias_mode) {
    case kBiasInternal:
      return p.rel_pos[static_cast<int64_t>(i) * p.n + j] +
             tw[time_bucket(ex[i + 1], ex[j], p.max_bucket)];
    case kBiasTensor:
      return p.bias[(static_cast<int64_t>(b) * p.n + i) * p.n + j];
    default:
      return 0.f;
  }
}

// Pointwise: the 64 rows' attn per (user, 64 query rows); see the note at
// the top.
template <int DQP, int DVP>
__global__ void __launch_bounds__(kAttnThreads, 2) serve_attn_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char serve_smem[];
  using L = PointLayout<DQP, DVP>;
  const L lay(p.n);
  float* Bc = reinterpret_cast<float*>(serve_smem);                  // [kRows][ldbc]
  float* ring = reinterpret_cast<float*>(serve_smem + lay.ring);      // 2 x 2 heads x [k | v]
  float* cm = reinterpret_cast<float*>(serve_smem + lay.tables);      // [kMaxN]
  float* tw = cm + kMaxN;                                             // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);                         // [kMaxN + 1]
  int* chunks = ex + kMaxN + 1;                                       // [1 + kChunks]

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wh = warp >> 2;
  const int hdv = p.H * p.dv, hq = p.H * p.dqk;
  const float* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const int jmax = min(i0 + kRows, p.n);
  const bool vec = (p.dqk & 3) == 0 && (p.dv & 3) == 0 && (p.F & 3) == 0;

  stage_tables(p, b, jmax, cm, tw, ex, chunks, tid);
  __syncthreads();
  const int nvalid = chunks[0], npairs = (p.H + 1) / 2, steps = npairs * nvalid;
  auto issue = [&](int st) {
    const int pair = st / nvalid, j0 = chunks[1 + st % nvalid] * kKeys;
    float* buf = ring + (st & 1) * 2 * L::head_floats;
    for (int w = 0; w < 2; ++w) {
      const int hd = 2 * pair + w;
      if (hd >= p.H) break;
      float* Ks = buf + w * L::head_floats;
      copy_rows<kAttnThreads>(Ks, L::ldk, yb, p.F, 2 * hdv + hq + hd * p.dqk, p.dqk, DQP, j0,
                              kKeys, jmax, vec, tid);
      copy_rows<kAttnThreads>(Ks + kKeys * L::ldk, L::ldv, yb, p.F, hdv + hd * p.dv, p.dv, DVP,
                              j0, kKeys, jmax, vec, tid);
    }
    tc::cp_async_commit();
  };
  if (steps > 0) issue(0);
  // The bias block, the mask as the penalty: a causal pair with a valid key.
  const int ncols = round_up(jmax, kKeys);
  for (int e = tid; e < kRows * ncols; e += kAttnThreads) {
    const int r = e / ncols, j = e % ncols, i = i0 + r;
    Bc[r * lay.ldbc + j] =
        i < p.n && j <= i && cm[j] != 0.f ? bias_of(p, b, i, j, tw, ex) : kPenalty;
  }

  const int row0 = i0 + wr * 16;
  const bool rows_live = row0 < p.n;
  FragA qa[DQP / 8];
  float O[DVP / 8][4];
  for (int st = 0; st < steps; ++st) {
    const int pair = st / nvalid, slot = st % nvalid, hd = 2 * pair + wh;
    const int j0 = chunks[1 + slot] * kKeys;
    const bool live = rows_live && hd < p.H;
    if (slot == 0 && live) {
      // The warp's q rows of head hd, split once: A fragments of each k step.
#pragma unroll
      for (int ks = 0; ks < DQP / 8; ++ks)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int i = row0 + g + (s & 1) * 8, d = ks * 8 + t + (s >> 1) * 4;
          set_a(qa[ks], s, split(i < p.n && d < p.dqk
                                     ? yb[static_cast<int64_t>(i) * p.F + 2 * hdv + hd * p.dqk + d]
                                     : 0.f));
        }
#pragma unroll
      for (int dn = 0; dn < DVP / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) O[dn][e] = 0.f;
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // this step's rows landed (and the bias block); step st - 1 is read
    if (st + 1 < steps) issue(st + 1);
    if (live && j0 <= row0 + 15) {
      const float* Ks = ring + (st & 1) * 2 * L::head_floats + wh * L::head_floats;
      const float* Vs = Ks + kKeys * L::ldk;
      float S[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[ni][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DQP / 8; ++ks) {
        FragB kb[4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const float* kr = Ks + (ni * 8 + g) * L::ldk + ks * 8 + t;
          set_b(kb[ni], 0, split(kr[0]));
          set_b(kb[ni], 1, split(kr[4]));
        }
        mma3<4>(S, qa[ks], kb);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wr * 16 + g + half * 8, j = j0 + ni * 8 + 2 * t;
          const float2 bb = *reinterpret_cast<const float2*>(Bc + r * lay.ldbc + j);
          const float s0 = S[ni][half * 2] + bb.x, s1 = S[ni][half * 2 + 1] + bb.y;
          S[ni][half * 2] = silu_fast(s0);
          S[ni][half * 2 + 1] = silu_fast(s1);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        FragA pa;
        tf32::a_from_c(pa, S[kk]);
        FragB vb[DVP / 8];
#pragma unroll
        for (int dn = 0; dn < DVP / 8; ++dn) {
          const float* vr = Vs + (kk * 8 + 2 * t) * L::ldv + dn * 8 + g;
          set_b(vb[dn], 0, split(vr[0] * p.inv_n));
          set_b(vb[dn], 1, split(vr[L::ldv] * p.inv_n));
        }
        mma3<DVP / 8>(O, pa, vb);
      }
    }
    if (slot == nvalid - 1 && live) {
#pragma unroll
      for (int dn = 0; dn < DVP / 8; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row0 + g + (e >> 1) * 8, d = dn * 8 + 2 * t + (e & 1);
          if (i < p.n && d < p.dv)
            p.attn[(static_cast<int64_t>(b) * p.n + i) * hdv + hd * p.dv + d] = O[dn][e];
        }
    }
  }
  // No valid key: every a is 0.
  if (steps == 0) {
    for (int e = tid; e < kRows * hdv; e += kAttnThreads) {
      const int i = i0 + e / hdv;
      if (i < p.n) p.attn[(static_cast<int64_t>(b) * p.n + i) * hdv + e % hdv] = 0.f;
    }
  }
}

// The softmax block: 4 row warps x kSoftColWarps (the scores' key columns of
// a chunk; a v's value columns).
constexpr int kSoftColWarps = 4;
constexpr int kSoftThreads = 32 * 4 * kSoftColWarps;
constexpr int kSoftKeyTiles = kKeys / 8 / kSoftColWarps;   // n8 key tiles of a warp's scores
constexpr int kSoftTiles = 32 / kSoftColWarps;             // a v: n8 column tiles (h*dv <= 256)

// Softmax: attn per (user, 64 query rows); see the note at the top.
__global__ void __launch_bounds__(kSoftThreads, 1) serve_softmax_kernel(AttnArgs p) {
  extern __shared__ __align__(16) unsigned char serve_smem[];
  const SoftLayout lay(p.n, p.H, p.dqk, p.dv);
  float* Sf = reinterpret_cast<float*>(serve_smem);                   // [kRows][lds]
  float* Qs = reinterpret_cast<float*>(serve_smem + lay.q);           // [kRows][ldq]
  float* ring = reinterpret_cast<float*>(serve_smem + lay.ring);      // 2 x [kKeys][ring_w]
  float* cm = reinterpret_cast<float*>(serve_smem + lay.tables);
  float* tw = cm + kMaxN;
  int* ex = reinterpret_cast<int*>(tw + 128);
  int* chunks = ex + kMaxN + 1;

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp & 3, wc = warp >> 2;
  const int hdv = p.H * p.dv, hq = p.H * p.dqk, lds = lay.lds, ldq = lay.ldq, ldv = lay.ldv;
  const float* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const int jmax = min(i0 + kRows, p.n), nkc = (p.n + kKeys - 1) / kKeys;
  const bool vec = (hq & 3) == 0 && (hdv & 3) == 0 && (p.F & 3) == 0;
  auto issue_k = [&](int c) {
    copy_rows<kSoftThreads>(ring + (c & 1) * kKeys * lay.ring_w, ldq, yb, p.F, 2 * hdv + hq, hq,
                            lay.hq8, c * kKeys, kKeys, p.n, vec, tid);
    tc::cp_async_commit();
  };

  copy_rows<kSoftThreads>(Qs, ldq, yb, p.F, 2 * hdv, hq, lay.hq8, i0, kRows, p.n, vec, tid);
  tc::cp_async_commit();
  issue_k(0);
  stage_tables<kSoftThreads>(p, b, jmax, cm, tw, ex, chunks, tid);

  // Scores over every key: (q . k + bias) / sqrt(dqk), -inf past n. Warp
  // (wr, wc): rows wr*16.., the wc-th key tiles of each chunk.
  for (int c = 0; c < nkc; ++c) {
    tc::cp_async_wait<0>();
    __syncthreads();   // chunk c landed; chunk c - 1 is read
    if (c + 1 < nkc) issue_k(c + 1);
    const float* Ks = ring + (c & 1) * kKeys * lay.ring_w + wc * kSoftKeyTiles * 8 * ldq;
    float S[kSoftKeyTiles][4] = {};
    for (int ks = 0; ks < lay.hq8 / 8; ++ks) {
      FragA a;
      const float* qr = Qs + (wr * 16 + g) * ldq + ks * 8 + t;
      set_a(a, 0, split(qr[0]));
      set_a(a, 1, split(qr[8 * ldq]));
      set_a(a, 2, split(qr[4]));
      set_a(a, 3, split(qr[8 * ldq + 4]));
      FragB kb[kSoftKeyTiles];
#pragma unroll
      for (int ni = 0; ni < kSoftKeyTiles; ++ni) {
        const float* kr = Ks + (ni * 8 + g) * ldq + ks * 8 + t;
        set_b(kb[ni], 0, split(kr[0]));
        set_b(kb[ni], 1, split(kr[4]));
      }
      mma3<kSoftKeyTiles>(S, a, kb);
    }
#pragma unroll
    for (int ni = 0; ni < kSoftKeyTiles; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr * 16 + g + half * 8, i = i0 + r;
        const int j = c * kKeys + (wc * kSoftKeyTiles + ni) * 8 + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = j + e < p.n ? (S[ni][half * 2 + e] +
                                (i < p.n ? bias_of(p, b, i, j + e, tw, ex) : 0.f)) *
                                   p.inv_sqrt_dqk
                             : -INFINITY;
        }
        *reinterpret_cast<float2*>(Sf + r * lds + j) = make_float2(v[0], v[1]);
      }
  }
  __syncthreads();   // every score written; the ring is free
  const int nvalid = chunks[0];
  auto issue_v = [&](int slot) {
    copy_rows<kSoftThreads>(ring + (slot & 1) * kKeys * lay.ring_w, ldv, yb, p.F, hdv, hdv,
                            lay.hv8, chunks[1 + slot] * kKeys, kKeys, jmax, vec, tid);
    tc::cp_async_commit();
  };
  if (nvalid > 0) issue_v(0);

  // Each row normalised over all n columns, then masked: a warp a row.
  const int np32 = round_up(p.n, 32);
  for (int r = warp; r < kRows; r += kSoftThreads / 32) {
    const int i = i0 + r;
    float* srow = Sf + r * lds;
    if (i >= p.n) {
      for (int j = lane; j < np32; j += 32) srow[j] = 0.f;
      continue;
    }
    float m = -INFINITY;
    for (int j = lane; j < p.n; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    float ssum = 0.f;
    for (int j = lane; j < p.n; j += 32) {
      const float e = expf(srow[j] - m);
      srow[j] = e;
      ssum += e;
    }
    ssum = warp_sum(ssum);
    for (int j = lane; j < np32; j += 32)
      srow[j] = j < p.n ? srow[j] / ssum * (j <= i ? cm[j] : 0.f) : 0.f;
  }

  // a v over the causal chunks with a valid key; warp (wr, wc): rows
  // wr*16.., column tiles [wc*ntw, (wc+1)*ntw) of v.
  const int nt_all = lay.hv8 / 8, ntw = (nt_all + kSoftColWarps - 1) / kSoftColWarps;
  const int nt0 = wc * ntw;
  const int row0 = i0 + wr * 16;
  float O[kSoftTiles / 4][4][4];
#pragma unroll
  for (int q = 0; q < kSoftTiles / 4; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[q][j][e] = 0.f;
  for (int slot = 0; slot < nvalid; ++slot) {
    const int j0 = chunks[1 + slot] * kKeys;
    tc::cp_async_wait<0>();
    __syncthreads();   // chunk landed (and every a written); the last chunk is read
    if (slot + 1 < nvalid) issue_v(slot + 1);
    if (row0 >= p.n || j0 > row0 + 15) continue;
    const float* Vs = ring + (slot & 1) * kKeys * lay.ring_w;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // a's A fragment in a_from_c's k order: slot t <-> key 2t, t+4 <-> 2t+1.
      FragA pa;
      const float* ar = Sf + (wr * 16 + g) * lds + j0 + kk * 8 + 2 * t;
      const float2 a0 = *reinterpret_cast<const float2*>(ar);
      const float2 a1 = *reinterpret_cast<const float2*>(ar + 8 * lds);
      set_a(pa, 0, split(a0.x));
      set_a(pa, 1, split(a1.x));
      set_a(pa, 2, split(a0.y));
      set_a(pa, 3, split(a1.y));
      const float* vr = Vs + (kk * 8 + 2 * t) * ldv + g;
#pragma unroll
      for (int q = 0; q < kSoftTiles / 4; ++q) {
        if (q * 4 >= ntw) break;
        FragB vb[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = (nt0 + q * 4 + j) * 8;   // past hv8: reads the ring's padding, unused
          set_b(vb[j], 0, split(vr[col]));
          set_b(vb[j], 1, split(vr[ldv + col]));
        }
        mma3<4>(O[q], pa, vb);
      }
    }
  }
  if (row0 >= p.n) return;
#pragma unroll
  for (int q = 0; q < kSoftTiles / 4; ++q) {
    if (q * 4 >= ntw) break;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + (e >> 1) * 8, col = (nt0 + q * 4 + j) * 8 + 2 * t + (e & 1);
        if (i < p.n && (q * 4 + j) < ntw && col < hdv)
          p.attn[(static_cast<int64_t>(b) * p.n + i) * hdv + col] = O[q][j][e];
      }
  }
}

// ---- host launchers ----------------------------------------------------------

cudaError_t launch_proj(const GemmArgs& p, cudaStream_t s) {
  if (p.M == 0) return cudaSuccess;
  const size_t smem = proj_smem_bytes(p.K);
  cudaError_t err = allow_smem(serve_proj_kernel, smem);
  if (err != cudaSuccess) return err;
  serve_proj_kernel<<<static_cast<unsigned>((p.M + kRM - 1) / kRM), kRThreads, smem, s>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_out(const GemmArgs& p, cudaStream_t s) {
  if (p.M == 0) return cudaSuccess;
  const size_t smem = out_smem_bytes();
  cudaError_t err = allow_smem(serve_out_kernel, smem);
  if (err != cudaSuccess) return err;
  serve_out_kernel<<<static_cast<unsigned>((p.M + kOM - 1) / kOM), kOThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DQP, int DVP>
cudaError_t launch_point(const AttnArgs& p, int B, cudaStream_t s) {
  const size_t smem = PointLayout<DQP, DVP>(p.n).bytes;
  cudaError_t err = allow_smem(serve_attn_kernel<DQP, DVP>, smem);
  if (err != cudaSuccess) return err;
  serve_attn_kernel<DQP, DVP><<<dim3(B, (p.n + kRows - 1) / kRows), kAttnThreads, smem, s>>>(p);
  return cudaGetLastError();
}

size_t attn_smem_bytes(int softmax, int n, int H, int dqk, int dv) {
  if (softmax) return SoftLayout(n, H, dqk, dv).bytes;
  const bool q16 = pad_w(dqk) == 16, v16 = pad_w(dv) == 16;
  if (q16) return v16 ? PointLayout<16, 16>(n).bytes : PointLayout<16, 32>(n).bytes;
  return v16 ? PointLayout<32, 16>(n).bytes : PointLayout<32, 32>(n).bytes;
}

cudaError_t launch_attention(const AttnArgs& p, int B, int softmax, cudaStream_t s) {
  if (B == 0) return cudaSuccess;
  if (softmax) {
    const size_t smem = SoftLayout(p.n, p.H, p.dqk, p.dv).bytes;
    cudaError_t err = allow_smem(serve_softmax_kernel, smem);
    if (err != cudaSuccess) return err;
    serve_softmax_kernel<<<dim3(B, (p.n + kRows - 1) / kRows), kSoftThreads, smem, s>>>(p);
    return cudaGetLastError();
  }
  const bool q16 = pad_w(p.dqk) == 16, v16 = pad_w(p.dv) == 16;
  if (q16) return v16 ? launch_point<16, 16>(p, B, s) : launch_point<16, 32>(p, B, s);
  return v16 ? launch_point<32, 16>(p, B, s) : launch_point<32, 32>(p, B, s);
}

}  // namespace k1tf32
}  // namespace
}  // namespace rails
