// K4's bf16 attention-core backward on the H100's tensor cores: three
// mma.sync kernels for the pointwise (SiLU) attention of the fused HSTU train
// block, at the widths of K1's tensor-core kernels (hstu_block_tc.cuh).
//
// Replaces, for bf16 operands, the pointwise branch of `_attn_bwd_kernel`
// (rails_tpu/ops/pallas/hstu_block_train.py:248-435) with the attention
// recomputed from the bf16 y as the JAX backward does: per user, from y =
// [u | v | q | k] (n x F, bf16) and d(o_input) (bf16, keep mask applied),
// d_y = [d_u, d_v, d_q, d_k] (f32), dbias = sum_h d_s_h (n x n, f32) and attn
// (f32). The f32 instances at these widths run 3xTF32 (hstu_train_tf32.cuh);
// the bf16 ones at other widths, the f32 ones there and the softmax attention
// stay on hstu_block_train.cu and hstu_softmax_train.cu.
//
// Bound. At ml-20m-hstu-mol's train block (B = 128, n = 211, h = 8, dqk = dv
// = 32) the function needs 5 products of 2 x 32 FLOPs over the causal (user,
// head, i, j) pairs, 7.3 GFLOP (0.0074 ms at 989 TFLOP/s), and moves about
// 230 MB (y, d_o in; d_y, attn, dbias out), 0.069 ms at 3.35 TB/s: it is
// bound by its bytes. The CUDA-core kernel it replaces ran every product as
// scalar FMAs reading one shared-memory float each, in one 512-thread block
// per user (128 blocks at B = 128, 32 at the frontier's B = 32).
//
// Design. Three launches, each over (user, 64-row tile) blocks, B * ceil(n /
// 64) of them, of 4 row warps (16 rows each) x head warps (two heads a warp,
// one for odd h). Every product is mma.sync m16n8k16 bf16 with f32
// accumulators, fed by ldmatrix from tiles staged in shared memory: q, k and
// d_attn as stored, v as bf16(bf16(y) * 1/max_seq_len), JAX's twice-rounded
// v (hstu_block_train.py:279-282), heads padded to 16 or 32 columns. The bias
// tile rel_pos[i, j] + tsw[time_bucket(ext[i+1] - ext[j])] is built once per
// (query tile, key tile) for all heads, with the mask folded in as a -1e30
// penalty: sigmoid gives exactly 0 there, so a and d_s are (-)0 as under the
// JAX kernel's -30000. s = q k^T + bias, sigma(s) by expf and an IEEE
// reciprocal (`sigma_and_slope`, silu_grad's values bit for bit), a =
// bf16(silu(s) * keep) and d_s = (d_attn v^T) * keep *
// silu'(s), the rounding points of `attn_backward_reference`; only the order
// of the f32 sums differs from it. Tiles above the diagonal and key tiles
// whose columns are all padding are skipped.
//   (a) tc_bwd_rows_kernel: per (user, 64 query rows): attn = a v over the
//       causal key tiles, staged to shared memory in f32; then a warp a row
//       takes the LayerNorm statistics, d_u and d_gln from d_o and u, and
//       d_attn = LN-backward(attn, d_gln) (`_ln_bwd`, as attn_row_bwd_kernel
//       in hstu_train.cuh); writes d_u into d_y, d_attn in bf16 (the JAX
//       kernel's cast before its products) and attn in f32 (the glue's dWo
//       reads it).
//   (b) tc_bwd_dq_kernel: per (user, 64 query rows), heads in order: s and
//       d_a = d_attn v^T on mma.sync, d_s, d_q += bf16(d_s) k. dbias: each
//       warp sums its heads' d_s in registers in head order, the head warps'
//       sums are added in warp order through shared memory, and the tile is
//       written once, in whole rows.
//   (c) tc_bwd_dkv_kernel: per (user, 64 key rows), walking the query tiles
//       i >= j: s^T = k q^T and d_a^T = v d_attn^T recomputed, d_k +=
//       bf16(d_s)^T q and d_v += bf16(a)^T d_attn, times 1/max_seq_len at the
//       end. The heavy key tiles (most queries) are scheduled first.
// Every output element has one writer and no atomics are used, so two calls
// give the same bits. Attention dropout regenerates the (user, head) keep
// stream (`attn_seed`, idx = i * n + j) in each launch.
#pragma once

#include <cstdint>

#include "hash_dropout.cuh"
#include "hstu_block_tc.cuh"
#include "hstu_train.cuh"

namespace rails {
namespace {
namespace tc {

constexpr int kBwdHeadsPerWarp = 2;

// Head warps per backward block: two heads a warp for even h, one for odd.
inline int bwd_head_warps(int H) { return H % 2 == 0 ? H / 2 : H; }
inline int bwd_pad_dv(int dv) { return dv <= 16 ? 16 : 32; }

struct BwdArgs {
  const bf16* y;         // (B*n, F) [u | v | q | k]
  const bf16* d_o;       // (B*n, h*dv or 3*h*dv) d(o_input), keep mask applied   (a)
  const bf16* d_attn;    // (B*n, h*dv) bf16                                        (b, c)
  bf16* d_attn_out;      //                                                         (a)
  float* attn;           // (B*n, h*dv) f32                                         (a)
  float* d_y;            // (B*n, F) f32: (a) d_u, (b) d_q, (c) d_v and d_k
  float* dbias;          // (B, n, n) f32, or null without the bias                 (b)
  const float* colmask;  // (B, n)
  const float* rel_pos;  // (n, n)   with the bias
  const int* ext;        // (B, n+1) with the bias
  const float* tsw;      // (128,)   with the bias
  int n, H, dqk, dv, F, has_bias, concat_ua, max_bucket;
  float inv_n, eps;
  int adrop, seed0;
  uint32_t athresh;
  float ascale;
};

// Rows r0 .. r0+R of one user's rows `src` (row stride ld_src), per head the
// w columns at off + hd * w, into dst (row stride ld) with each head padded
// to wp columns; rows at or past n and the padding are zeros. scaled: v's
// bf16(value * scale).
__device__ __forceinline__ void stage_heads(bf16* dst, int ld, const bf16* src, int ld_src,
                                            int off, int H, int w, int wp, int r0, int R, int n,
                                            bool scaled, float scale, int tid, int nthr) {
  if ((w & 7) == 0 && (ld_src & 7) == 0 && (off & 7) == 0) {
    const int chunks = wp / 8;
    for (int e = tid; e < R * H * chunks; e += nthr) {
      const int r = e / (H * chunks), rest = e - r * (H * chunks);
      const int hd = rest / chunks, c = (rest - hd * chunks) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < n && c < w) {
        v = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * ld_src + off +
                                            hd * w + c);
        if (scaled) {
          __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 f = __bfloat1622float2(h2[q]);
            h2[q] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
          }
        }
      }
      *reinterpret_cast<uint4*>(dst + r * ld + hd * wp + c) = v;
    }
  } else {
    for (int e = tid; e < R * H * wp; e += nthr) {
      const int r = e / (H * wp), rest = e - r * (H * wp);
      const int hd = rest / wp, c = rest - hd * wp;
      float v = 0.f;
      if (r0 + r < n && c < w) {
        v = __bfloat162float(src[static_cast<int64_t>(r0 + r) * ld_src + off + hd * w + c]);
        if (scaled) v *= scale;
      }
      dst[r * ld + hd * wp + c] = __float2bfloat16_rn(v);
    }
  }
}

// Column validity (zeros past n up to np64) and the bias tables.
__device__ __forceinline__ void stage_bwd_tables(const BwdArgs& p, int b, int np64, float* cm,
                                                 float* tw, int* ex, int tid, int nthr) {
  for (int j = tid; j < np64; j += nthr)
    cm[j] = j < p.n ? p.colmask[static_cast<int64_t>(b) * p.n + j] : 0.f;
  if (p.has_bias) {
    for (int j = tid; j <= p.n; j += nthr) ex[j] = p.ext[static_cast<int64_t>(b) * (p.n + 1) + j];
    for (int k = tid; k < 128; k += nthr) tw[k] = p.tsw[k];
  }
}

// The bias of (query i, key j), the mask as a -1e30 penalty.
__device__ __forceinline__ float bwd_bias(const BwdArgs& p, int i, int j, const float* cm,
                                          const float* tw, const int* ex) {
  if (i >= p.n || j > i || cm[j] == 0.f) return kMaskPenalty;
  return p.has_bias ? p.rel_pos[static_cast<int64_t>(i) * p.n + j] +
                          tw[time_bucket(ex[i + 1], ex[j], p.max_bucket)]
                    : 0.f;
}

// S (16 x 32) = A rows (16 x 16*ksteps, row stride lda) @ B rows (32 x
// 16*ksteps, row stride ldb)^T, each from shared memory.
__device__ __forceinline__ void mma_rows_cols(float (&S)[4][4], const bf16* A, int lda,
                                              const bf16* Bm, int ldb, int ksteps, int lane) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[ni][e] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
    ldsm_x4(A + (lane & 15) * lda + ks * 16 + (lane >> 4) * 8, a);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t kb[4];
      ldsm_x4(Bm + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldb + ks * 16 +
                  ((lane >> 3) & 1) * 8,
              kb);
      mma_bf16(S[2 * np], a, kb[0], kb[1]);
      mma_bf16(S[2 * np + 1], a, kb[2], kb[3]);
    }
  }
}

template <int W>
__device__ __forceinline__ void zero_frag(float (&acc)[kBwdHeadsPerWarp][W / 8][4]) {
#pragma unroll
  for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh)
#pragma unroll
    for (int ni = 0; ni < W / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][ni][e] = 0.f;
}

// Accumulator fragments (16 rows from row0, per head w of the padded W
// columns) into d_y's columns off + hd * w, times scale, for rows < n.
template <int W>
__device__ __forceinline__ void store_frag(const BwdArgs& p,
                                           const float (&acc)[kBwdHeadsPerWarp][W / 8][4],
                                           int b, int row0, int off, int w, int hd0, int hw,
                                           float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh) {
    if (hh >= hw) break;
#pragma unroll
    for (int ni = 0; ni < W / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + (e >> 1) * 8, d = ni * 8 + 2 * t + (e & 1);
        if (i < p.n && d < w) {
          p.d_y[(static_cast<int64_t>(b) * p.n + i) * p.F + off + (hd0 + hh) * w + d] =
              acc[hh][ni][e] * scale;
        }
      }
  }
}

template <int DQP, int DVP>
struct BwdLayout {
  int H, ldq, ldv, np64;
  __device__ __host__ BwdLayout(int H_, int n) : H(H_), ldq(H_ * DQP + 8), ldv(H_ * DVP + 8),
                                                 np64((n + 63) / 64 * 64) {}
};

// Shared memory of each launch (stage 0: rows, 1: dq, 2: dkv).
template <int DQP, int DVP>
size_t bwd_smem_bytes(int stage, int n, int H, int dv) {
  const BwdLayout<DQP, DVP> L(H, n);
  const size_t tables = (L.np64 + 128) * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
  const size_t bias = kRows * kLdBias * sizeof(float);
  const size_t q64 = kRows * L.ldq * sizeof(bf16), q32 = kKeys * L.ldq * sizeof(bf16);
  const size_t v64 = kRows * L.ldv * sizeof(bf16), v32 = kKeys * L.ldv * sizeof(bf16);
  if (stage == 0) {
    const size_t main = q64 + q32 + v32 + bias + tables;
    const size_t rows = kRows * (static_cast<size_t>(H) * dv + 4) * sizeof(float);
    return main > rows ? main : rows;
  }
  if (stage == 1) return q64 + v64 + q32 + v32 + bias + bwd_head_warps(H) * bias + tables;
  return q64 + v64 + q32 + v32 + bias + tables;
}

// sigma(s) and silu'(s) with silu_grad's values, bit for bit, for fewer
// instructions: the correctly rounded reciprocal (__frcp_rn) is the IEEE
// quotient 1 / x, and a masked pair (s at the -1e30 penalty) gets sigma = 0
// and silu' = -0 without the exp, as silu_grad computes them there.
__device__ __forceinline__ void sigma_and_slope(float s, float& sig, float& deriv) {
  if (s < 0.5f * kMaskPenalty) {
    sig = 0.f;
    deriv = -0.f;
    return;
  }
  sig = __frcp_rn(1.f + expf(-s));
  deriv = sig * (1.f + s * (1.f - sig));
}

// The elementwise core of one (16 x 32) tile of one head, in place: the
// score fragments S become a = silu(s) * keep and the d_a fragments dA become
// d_s = d_a * keep * silu'(s), with s = S + bias (`sigma_and_slope`).
// Fragment (ni, e) is tile element (row r0 + g + (e >> 1) * 8,
// column ni * 8 + 2t + (e & 1)) of the bias tile `Bt` (row stride kLdBias);
// (row0, col0) are the (i, j) of tile element (0, 0), or with TRANSPOSED
// (key rows, query columns) its (j, i), for the keep index i * n + j.
template <bool TRANSPOSED>
__device__ __forceinline__ void silu_tile(const BwdArgs& p, float (&S)[4][4], float (&dA)[4][4],
                                          const float* Bt, int r0, int row0, int col0,
                                          uint32_t aseed, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + (e >> 1) * 8, c = ni * 8 + 2 * t + (e & 1);
      const float s = S[ni][e] + Bt[(r0 + r) * kLdBias + c];
      float sig, deriv;
      sigma_and_slope(s, sig, deriv);
      float keep = 1.f;
      if (p.adrop) {
        const int i = TRANSPOSED ? col0 + c : row0 + r, j = TRANSPOSED ? row0 + r : col0 + c;
        keep = keep_scale(static_cast<uint32_t>(i * p.n + j), aseed, p.athresh, p.ascale);
      }
      S[ni][e] = s * sig * keep;
      dA[ni][e] = dA[ni][e] * keep * deriv;
    }
}

// C fragments of a (16 x 32) tile as the A fragments of a product over its
// 32 columns, rounded to bf16 (score n-tiles 2ks, 2ks+1 = k step ks).
__device__ __forceinline__ void to_a_frag(const float (&C)[4][4], uint32_t (&P)[2][4]) {
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      P[ni >> 1][(ni & 1) * 2 + half] = pack_bf16(C[ni][half * 2], C[ni][half * 2 + 1]);
}

// (a) attn recomputed, LN backward, d_u, d_attn; see the note at the top.
template <int DQP, int DVP>
__global__ void __launch_bounds__(512) tc_bwd_rows_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const BwdLayout<DQP, DVP> L(p.H, p.n);
  const int H = p.H, hdv = H * p.dv, hq = H * p.dqk;
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);              // [kRows][ldq]
  bf16* Ks = Qs + kRows * L.ldq;                             // [kKeys][ldq]
  bf16* Vs = Ks + kKeys * L.ldq;                             // [kKeys][ldv]
  float* Bt = reinterpret_cast<float*>(Vs + kKeys * L.ldv);  // [kRows][kLdBias]
  float* cm = Bt + kRows * kLdBias;                          // [np64]
  float* tw = cm + L.np64;                                   // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);                // [n + 1]

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, hw = H / (nthr / 128);
  const int g = lane >> 2, t = lane & 3;
  const bf16* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;

  stage_heads(Qs, L.ldq, yb, p.F, 2 * hdv, H, p.dqk, DQP, i0, kRows, p.n, false, 1.f, tid, nthr);
  stage_bwd_tables(p, b, L.np64, cm, tw, ex, tid, nthr);
  __syncthreads();  // the tables, before any thread reads another's entries
  float O[kBwdHeadsPerWarp][DVP / 8][4];
  zero_frag<DVP>(O);
  const int jmax = min(i0 + kRows, p.n), wlast = i0 + wr * 16 + 15;
  for (int j0 = 0; j0 < jmax; j0 += kKeys) {
    // A barrier (the last tile's readers are done) that also skips a tile
    // of invalid keys: its a are all 0.
    if (!__syncthreads_or(tid < kKeys && cm[j0 + tid] != 0.f)) continue;
    stage_heads(Ks, L.ldq, yb, p.F, 2 * hdv + hq, H, p.dqk, DQP, j0, kKeys, p.n, false, 1.f, tid,
                nthr);
    stage_heads(Vs, L.ldv, yb, p.F, hdv, H, p.dv, DVP, j0, kKeys, p.n, true, p.inv_n, tid, nthr);
    for (int e = tid; e < kRows * kKeys; e += nthr) {
      const int r = e / kKeys, c = e % kKeys;
      Bt[r * kLdBias + c] = bwd_bias(p, i0 + r, j0 + c, cm, tw, ex);
    }
    __syncthreads();
    if (j0 > wlast) continue;
#pragma unroll
    for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
      const int hd = wc * hw + hh;
      float S[4][4], unused[4][4] = {};
      mma_rows_cols(S, Qs + wr * 16 * L.ldq + hd * DQP, L.ldq, Ks + hd * DQP, L.ldq, DQP / 16,
                    lane);
      silu_tile<false>(p, S, unused, Bt, wr * 16, i0 + wr * 16, j0,
                       p.adrop ? attn_seed(p.seed0, b, hd) : 0u, lane);
      uint32_t P[2][4];
      to_a_frag(S, P);
      av_head<DVP>(O[hh], P, Vs, L.ldv, hd, lane);
    }
  }

  // attn rows through shared memory (the tiles are dead after the barrier).
  __syncthreads();
  float* St = reinterpret_cast<float*>(tc_smem);
  const int lds = hdv + 4;
#pragma unroll
  for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh) {
    if (hh >= hw) break;
#pragma unroll
    for (int ni = 0; ni < DVP / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = ni * 8 + 2 * t + (e & 1);
        if (d < p.dv) St[(wr * 16 + g + (e >> 1) * 8) * lds + (wc * hw + hh) * p.dv + d] = O[hh][ni][e];
      }
  }
  __syncthreads();
  // A warp a row: gln = LN(attn), d_u, d_gln, d_attn = LN-backward(attn, d_gln).
  const int nwarps = nthr / 32, ldo = p.concat_ua ? 3 * hdv : hdv;
  for (int r = warp; r < kRows; r += nwarps) {
    const int i = i0 + r;
    if (i >= p.n) break;
    const int64_t row = static_cast<int64_t>(b) * p.n + i;
    const float* ar = St + r * lds;
    const bf16* go = p.d_o + row * ldo;
    const bf16* ur = p.y + row * p.F;
    float s = 0.f;
    for (int k = lane; k < hdv; k += 32) s += ar[k];
    const float mean = warp_sum(s) / hdv;
    float v = 0.f;
    for (int k = lane; k < hdv; k += 32) {
      const float d = ar[k] - mean;
      v = fmaf(d, d, v);
    }
    const float inv = rsqrtf(warp_sum(v) / hdv + p.eps);
    auto d_gln = [&](int k) {
      const float uk = __bfloat162float(ur[k]);
      return p.concat_ua ? __bfloat162float(go[hdv + k]) + __bfloat162float(go[2 * hdv + k]) * uk
                         : __bfloat162float(go[k]) * uk;
    };
    float sum_dn = 0.f, sum_dn_nh = 0.f;
    for (int k = lane; k < hdv; k += 32) {
      const float nh = (ar[k] - mean) * inv, dn = d_gln(k);
      p.d_y[row * p.F + k] = p.concat_ua ? __bfloat162float(go[k]) +
                                               __bfloat162float(go[2 * hdv + k]) * nh
                                         : __bfloat162float(go[k]) * nh;
      sum_dn += dn;
      sum_dn_nh = fmaf(dn, nh, sum_dn_nh);
    }
    const float mean_dn = warp_sum(sum_dn) / hdv, mean_dn_nh = warp_sum(sum_dn_nh) / hdv;
    for (int k = lane; k < hdv; k += 32) {
      const float nh = (ar[k] - mean) * inv;
      p.d_attn_out[row * hdv + k] = __float2bfloat16_rn(inv * (d_gln(k) - mean_dn - nh * mean_dn_nh));
      p.attn[row * hdv + k] = ar[k];
    }
  }
}

// (b) d_q and dbias; see the note at the top.
template <int DQP, int DVP>
__global__ void __launch_bounds__(512) tc_bwd_dq_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const BwdLayout<DQP, DVP> L(p.H, p.n);
  const int H = p.H, hdv = H * p.dv, hq = H * p.dqk;
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);              // [kRows][ldq] q rows
  bf16* Ds = Qs + kRows * L.ldq;                             // [kRows][ldv] d_attn rows
  bf16* Ks = Ds + kRows * L.ldv;                             // [kKeys][ldq]
  bf16* Vs = Ks + kKeys * L.ldq;                             // [kKeys][ldv]
  float* Bt = reinterpret_cast<float*>(Vs + kKeys * L.ldv);  // [kRows][kLdBias]
  float* Db = Bt + kRows * kLdBias;                          // [head warps][kRows][kLdBias]
  const int nwc = blockDim.x / 128;
  float* cm = Db + nwc * kRows * kLdBias;                    // [np64]
  float* tw = cm + L.np64;                                   // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);                // [n + 1]

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, hw = H / nwc;
  const int g = lane >> 2, t = lane & 3;
  const bf16* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const bf16* db_attn = p.d_attn + static_cast<int64_t>(b) * p.n * hdv;

  stage_heads(Qs, L.ldq, yb, p.F, 2 * hdv, H, p.dqk, DQP, i0, kRows, p.n, false, 1.f, tid, nthr);
  stage_heads(Ds, L.ldv, db_attn, hdv, 0, H, p.dv, DVP, i0, kRows, p.n, false, 1.f, tid, nthr);
  stage_bwd_tables(p, b, L.np64, cm, tw, ex, tid, nthr);
  __syncthreads();
  float dQ[kBwdHeadsPerWarp][DQP / 8][4];
  zero_frag<DQP>(dQ);
  const int rows = min(kRows, p.n - i0), wlast = i0 + wr * 16 + 15;
  for (int j0 = 0; j0 < p.n; j0 += kKeys) {
    const bool live = __syncthreads_or(tid < kKeys && cm[j0 + tid] != 0.f) && j0 < i0 + kRows;
    if (!live) {  // no causal, valid key: d_s is (-)0 over the tile
      if (p.dbias) {
        for (int e = tid; e < rows * kKeys; e += nthr) {
          const int r = e / kKeys, j = j0 + e % kKeys;
          if (j < p.n) p.dbias[(static_cast<int64_t>(b) * p.n + i0 + r) * p.n + j] = 0.f;
        }
      }
      continue;
    }
    stage_heads(Ks, L.ldq, yb, p.F, 2 * hdv + hq, H, p.dqk, DQP, j0, kKeys, p.n, false, 1.f, tid,
                nthr);
    stage_heads(Vs, L.ldv, yb, p.F, hdv, H, p.dv, DVP, j0, kKeys, p.n, true, p.inv_n, tid, nthr);
    for (int e = tid; e < kRows * kKeys; e += nthr) {
      const int r = e / kKeys, c = e % kKeys;
      Bt[r * kLdBias + c] = bwd_bias(p, i0 + r, j0 + c, cm, tw, ex);
    }
    __syncthreads();
    float db[4][4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[ni][e] = 0.f;
    if (j0 <= wlast) {
#pragma unroll
      for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh) {
        if (hh >= hw) break;
        const int hd = wc * hw + hh;
        float S[4][4], dA[4][4];
        mma_rows_cols(S, Qs + wr * 16 * L.ldq + hd * DQP, L.ldq, Ks + hd * DQP, L.ldq, DQP / 16,
                      lane);
        mma_rows_cols(dA, Ds + wr * 16 * L.ldv + hd * DVP, L.ldv, Vs + hd * DVP, L.ldv, DVP / 16,
                      lane);
        silu_tile<false>(p, S, dA, Bt, wr * 16, i0 + wr * 16, j0,
                         p.adrop ? attn_seed(p.seed0, b, hd) : 0u, lane);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) db[ni][e] += dA[ni][e];
        uint32_t P[2][4];
        to_a_frag(dA, P);
        av_head<DQP>(dQ[hh], P, Ks, L.ldq, hd, lane);
      }
    }
    if (p.dbias) {
      // This warp's heads' sum, then the head warps' sums in warp order.
      float* mine = Db + wc * kRows * kLdBias;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(mine + (wr * 16 + g + half * 8) * kLdBias + ni * 8 + 2 * t) =
              make_float2(db[ni][half * 2], db[ni][half * 2 + 1]);
        }
      __syncthreads();
      for (int e = tid; e < rows * kKeys; e += nthr) {
        const int r = e / kKeys, c = e % kKeys, j = j0 + c;
        if (j >= p.n) continue;
        float v = Db[r * kLdBias + c];
        for (int w = 1; w < nwc; ++w) v += Db[(w * kRows + r) * kLdBias + c];
        p.dbias[(static_cast<int64_t>(b) * p.n + i0 + r) * p.n + j] = v;
      }
    }
  }
  store_frag<DQP>(p, dQ, b, i0 + wr * 16, 2 * hdv, p.dqk, wc * hw, hw, 1.f, lane);
}

// (c) d_k and d_v; see the note at the top.
template <int DQP, int DVP>
__global__ void __launch_bounds__(512) tc_bwd_dkv_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const BwdLayout<DQP, DVP> L(p.H, p.n);
  const int H = p.H, hdv = H * p.dv, hq = H * p.dqk;
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);              // [kRows][ldq] key rows
  bf16* Vs = Ks + kRows * L.ldq;                             // [kRows][ldv]
  bf16* Qt = Vs + kRows * L.ldv;                             // [kKeys][ldq] a query tile
  bf16* Dt = Qt + kKeys * L.ldq;                             // [kKeys][ldv] its d_attn
  float* Bt = reinterpret_cast<float*>(Dt + kKeys * L.ldv);  // [kRows][kLdBias] (key, query)
  float* cm = Bt + kRows * kLdBias;                          // [np64]
  float* tw = cm + L.np64;                                   // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);                // [n + 1]

  const int b = blockIdx.x, j0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, hw = H / (nthr / 128);
  const bf16* yb = p.y + static_cast<int64_t>(b) * p.n * p.F;
  const bf16* db_attn = p.d_attn + static_cast<int64_t>(b) * p.n * hdv;

  stage_heads(Ks, L.ldq, yb, p.F, 2 * hdv + hq, H, p.dqk, DQP, j0, kRows, p.n, false, 1.f, tid,
              nthr);
  stage_heads(Vs, L.ldv, yb, p.F, hdv, H, p.dv, DVP, j0, kRows, p.n, true, p.inv_n, tid, nthr);
  stage_bwd_tables(p, b, L.np64, cm, tw, ex, tid, nthr);
  __syncthreads();  // the tables: the key block's test below reads other threads' entries
  float dK[kBwdHeadsPerWarp][DQP / 8][4], dV[kBwdHeadsPerWarp][DVP / 8][4];
  zero_frag<DQP>(dK);
  zero_frag<DVP>(dV);
  const int wfirst = j0 + wr * 16;
  // A block of invalid keys has d_k = d_v = 0 (silu'(-1e30) = 0, a = 0).
  if (__syncthreads_or(tid < kRows && cm[j0 + tid] != 0.f)) {
    for (int q0 = j0 / kKeys * kKeys; q0 < p.n; q0 += kKeys) {
      __syncthreads();  // the last tile's readers are done
      stage_heads(Qt, L.ldq, yb, p.F, 2 * hdv, H, p.dqk, DQP, q0, kKeys, p.n, false, 1.f, tid,
                  nthr);
      stage_heads(Dt, L.ldv, db_attn, hdv, 0, H, p.dv, DVP, q0, kKeys, p.n, false, 1.f, tid, nthr);
      for (int e = tid; e < kRows * kKeys; e += nthr) {
        const int r = e / kKeys, c = e % kKeys;
        Bt[r * kLdBias + c] = bwd_bias(p, q0 + c, j0 + r, cm, tw, ex);
      }
      __syncthreads();
      if (q0 + kKeys - 1 < wfirst) continue;  // every query of the tile before the warp's keys
#pragma unroll
      for (int hh = 0; hh < kBwdHeadsPerWarp; ++hh) {
        if (hh >= hw) break;
        const int hd = wc * hw + hh;
        float S[4][4], dA[4][4];
        mma_rows_cols(S, Ks + wr * 16 * L.ldq + hd * DQP, L.ldq, Qt + hd * DQP, L.ldq, DQP / 16,
                      lane);
        mma_rows_cols(dA, Vs + wr * 16 * L.ldv + hd * DVP, L.ldv, Dt + hd * DVP, L.ldv, DVP / 16,
                      lane);
        silu_tile<true>(p, S, dA, Bt, wr * 16, wfirst, q0,
                        p.adrop ? attn_seed(p.seed0, b, hd) : 0u, lane);
        uint32_t P[2][4];
        to_a_frag(dA, P);
        av_head<DQP>(dK[hh], P, Qt, L.ldq, hd, lane);
        to_a_frag(S, P);
        av_head<DVP>(dV[hh], P, Dt, L.ldv, hd, lane);
      }
    }
  }
  store_frag<DQP>(p, dK, b, wfirst, 2 * hdv + hq, p.dqk, wc * hw, hw, 1.f, lane);
  store_frag<DVP>(p, dV, b, wfirst, hdv, p.dv, wc * hw, hw, p.inv_n, lane);
}

template <int DQP, int DVP>
cudaError_t launch_tc_bwd_stage(int stage, const BwdArgs& p, int B, cudaStream_t s) {
  const size_t smem = bwd_smem_bytes<DQP, DVP>(stage, p.n, p.H, p.dv);
  const dim3 grid(B, (p.n + kRows - 1) / kRows);
  const int threads = 128 * bwd_head_warps(p.H);
  cudaError_t err;
  switch (stage) {
    case 0:
      if ((err = allow_smem(tc_bwd_rows_kernel<DQP, DVP>, smem)) != cudaSuccess) return err;
      tc_bwd_rows_kernel<DQP, DVP><<<grid, threads, smem, s>>>(p);
      break;
    case 1:
      if ((err = allow_smem(tc_bwd_dq_kernel<DQP, DVP>, smem)) != cudaSuccess) return err;
      tc_bwd_dq_kernel<DQP, DVP><<<grid, threads, smem, s>>>(p);
      break;
    default:
      if ((err = allow_smem(tc_bwd_dkv_kernel<DQP, DVP>, smem)) != cudaSuccess) return err;
      tc_bwd_dkv_kernel<DQP, DVP><<<grid, threads, smem, s>>>(p);
  }
  return cudaGetLastError();
}

// One backward launch (stage 0, 1 or 2) at the instance of its padded widths.
cudaError_t launch_tc_bwd(int stage, const BwdArgs& p, int B, cudaStream_t s) {
  if (!widths_ok(1, p.H, p.dqk, p.dv) || p.n < 1 || stage < 0 || stage > 2)
    return cudaErrorInvalidValue;
  const bool q16 = pad_dqk(p.dqk) == 16, v16 = bwd_pad_dv(p.dv) == 16;
  if (q16) {
    return v16 ? launch_tc_bwd_stage<16, 16>(stage, p, B, s)
               : launch_tc_bwd_stage<16, 32>(stage, p, B, s);
  }
  return v16 ? launch_tc_bwd_stage<32, 16>(stage, p, B, s)
             : launch_tc_bwd_stage<32, 32>(stage, p, B, s);
}

size_t tc_bwd_smem_bytes(int stage, int n, int H, int dqk, int dv) {
  const bool q16 = pad_dqk(dqk) == 16, v16 = bwd_pad_dv(dv) == 16;
  if (q16) {
    return v16 ? bwd_smem_bytes<16, 16>(stage, n, H, dv) : bwd_smem_bytes<16, 32>(stage, n, H, dv);
  }
  return v16 ? bwd_smem_bytes<32, 16>(stage, n, H, dv) : bwd_smem_bytes<32, 32>(stage, n, H, dv);
}

}  // namespace tc
}  // namespace
}  // namespace rails
