// The bf16 HSTU serving block on the H100's tensor cores: K1's bf16
// instances (hstu_block.cu), the bf16 modes of its cost probe P1
// (encode_probe.cu), and K4's bf16 train forward (hstu_block_train.cu: the
// projection and output GEMM as they are, the attention in its TRAIN
// instances, below).
//
// Replaces, for bf16 operands, the body `_kernel` of
// rails_tpu/ops/pallas/hstu_block.py (:96-276): LayerNorm -> x @ uvqk ->
// SiLU (or none) -> attention -> o_input -> @ Wo + bo + x, every variant:
// the bias built in-kernel, read from a (B, n, n) tensor, or absent; pointwise
// SiLU or softmax attention; u * LN(attn) or concat_ua's [u, LN(a), u*LN(a)].
// f32 operands stay on the CUDA-core kernels of hstu_block.cuh: their
// products cannot go to the bf16 tensor cores without changing results.
//
// Bound. At serving shapes (B=512, n=211, D=256, h=8, dqk=dv=32) one block
// needs 82.5 GFLOP (0.083 ms at 989 TFLOP/s) and moves about 0.83 GB
// (0.25 ms at 3.35 TB/s): it is bound by its bytes once the products run on
// the tensor cores. The design keeps those bytes few:
//   1. tc_proj_kernel: a block owns 128 rows of x. It takes their LayerNorm
//      statistics (population variance, two passes, 16-byte row loads),
//      writes round_bf16(LN(x)) into a shared A tile that holds all D <= 272
//      columns (zeros from D to the next multiple of 64, where the uvqk rows
//      are zeros too: 264 takes a 320-wide tile, 116 KB, one block an SM),
//      and walks the F output columns in 128-wide tiles, the uvqk
//      rows streamed in 64-deep stages through a 2-stage cp.async ring.
//      mma.sync m16n8k16 bf16, ldmatrix-fed, f32 accumulators. The epilogue
//      applies SiLU (or none) and stores u (the first h*dv columns) in f32,
//      and v, q, k as the bf16 values the JAX kernel rounds them to before
//      any use (hstu_block.py:167-176): bf16(y * 1/max_seq_len) for v under
//      pointwise attention (scaled before the one rounding), bf16(y)
//      otherwise: 2,560 bytes a row instead of 4,096. Each warp stages its
//      tile through the B stage it has just consumed, so rows leave in
//      16-byte lanes. v, q and k are laid out per head padded to dv_p in
//      {8, 16, 32} and dqk_p in {16, 32} columns, zeros in the padding, so the
//      attention reads 16-byte rows.
//   2. tc_attn_kernel (pointwise) / tc_softmax_kernel: a block owns one user's
//      64 query rows and every head (4 row warps x up to 2 head warps; the
//      causal-heavy row tiles are scheduled first). Pointwise: for each
//      32-key tile up to the diagonal it builds the bias tile rel_pos[i, j] +
//      tsw[time_bucket(ext[i+1] - ext[j])] once in shared memory, the mask
//      folded in as a penalty, and reuses it for every head; q k^T and a v run
//      on mma.sync, bias and SiLU are applied in registers, and a is rounded
//      to bf16 straight from the score fragment into the A fragment of a v. A
//      warp skips key tiles past its last row, the block tiles whose keys are
//      all invalid (their a are 0). Softmax: the (64, n) f32 scores over the
//      full h*dqk contraction stay in shared memory; each row is normalised
//      over all n columns, masked after normalisation, rounded, and a v runs
//      over all h*dv columns on mma.sync. The epilogue holds whole attn rows
//      in registers, takes their LayerNorm statistics across the head warps,
//      and writes o_input = bf16(u * LN(attn)) (or concat_ua's three parts)
//      through shared memory in whole rows. attn never reaches device memory.
//   3. tc_out_kernel: o_input @ Wo + bo + x, mma.sync with both operands in a
//      2-stage cp.async ring, the tile written in bf16 through shared memory.
// The rounding points are the JAX kernel's; the order of the f32 sums and
// the SiLU (silu_bf16 below) differ. time_bucket is hstu_block.cuh's (logf,
// no fast math).
//
// K4's train forward (`_fwd_kernel`, rails_tpu/ops/pallas/hstu_block_train.py
// :124-232) runs launches 1 and 3 unchanged and launch 2 in its TRAIN
// instance (`TrainAttnArgs`; hstu_block_train.cu launches it): a times the attention
// keep mask of its (user, head) K3 stream (head 0 under softmax; idx = i * n
// + j) before its rounding, o_input times its keep mask (the user's stream,
// idx = position * o_width + column) before its rounding, as `_fwd_kernel`
// multiplies before its casts, and attn written in f32 straight from the
// fragments (27.7 MB at B = 128, n = 211: the train forward's function
// returns it). At B = 128 the forward needs 20.6 GFLOP (0.021 ms at 989
// TFLOP/s), ~28 MB (0.008 ms) and ~51 M ex2 (0.012 ms at 16 MUFU results an
// SM a clock). The serving instances take `AttnArgs` and compile as before.
//
// Widths: D <= 272, dqk <= 32, dv <= 32, and h <= 4 or an even h <= 8 (a head
// warp holds at most 4 heads' (16, dv_p) attn fragments); `tc_route` in
// ops/hstu_block.py states the same rule. Other bf16 widths stay on the
// CUDA-core kernels, and so does K1's linear_activation="none" (`tc_block`:
// its served ranking follows the plain GEMMs' order of f32 sums, PERF.md);
// P1's noact mode runs these kernels without the SiLU.
#pragma once

#include <cstdint>
#include <type_traits>

#include "hash_dropout.cuh"
#include "hstu_block.cuh"
#include "mma_sync.cuh"

namespace rails {
namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;               // GEMM blocks: 8 warps as 4 (rows) x 2 (columns)
constexpr int GBM = 128, GBN = 128, GBK = 64, kStages = 2;
constexpr int GLDA = GBK + 8;               // row stride of a streamed A stage (bf16)
constexpr int GLDB = GBN + 8;               // row stride of a B stage (bf16)
constexpr int kRows = 64;                   // attention: query rows a block
constexpr int kKeys = 32;                   // attention: key rows a tile
constexpr int kHeadsPerWarp = 4;            // attention: heads a warp holds at most
constexpr int kLdBias = kKeys + 4;
constexpr float kMaskPenalty = -1e30f;      // the bias of a masked pair under SiLU

// SiLU for the bf16 path. Every output rounds to bf16 (8 significant bits)
// before it enters a product: q, k and v in the projection's epilogue, a
// before a @ v, u * LN(attn) before the output GEMM. __expf and __fdividef
// keep v / (1 + e^-v) within ~4e-6 relative for |v| <= 30 (2 + |1.17 v| and
// 2 ulp), so a rounded result moves only where the f32 value lies that close
// to a bf16 rounding boundary; the accurate expf and IEEE division were the
// attention's largest cost (PERF.md §6). Large negative v gives 1 + e^-v =
// inf and a result of -0, as the penalty of mask_in_bias needs.
__device__ __forceinline__ float silu_bf16(float v) { return __fdividef(v, 1.0f + __expf(-v)); }

inline int pad_dqk(int dqk) { return dqk <= 16 ? 16 : 32; }
inline int pad_dv(int dv) { return dv <= 8 ? 8 : dv <= 16 ? 16 : 32; }
// Head warps per attention block: two when the heads split evenly.
inline int head_warps(int H) { return H % 2 == 0 ? 2 : 1; }

// The widths the kernels take (ops/hstu_block.py:tc_route states the same).
// D <= 272 takes the rated preprocessor's 256 + 8.
constexpr int kMaxD = 272;
inline bool widths_ok(int D, int H, int dqk, int dv) {
  return D >= 1 && D <= kMaxD && dqk >= 1 && dqk <= 32 && dv >= 1 && dv <= 32 && H >= 1 &&
         H / head_warps(H) <= kHeadsPerWarp;
}
// The f32 routes on the tensor cores (hstu_serve_tf32.cuh, hstu_train_tf32.cuh)
// take the same widths at lengths n <= 512: the combined preprocessor's 2 x
// 211. K4's f32 attention holds a block's bias rows for every key, so it
// takes 32-row blocks past n = 256; K1's softmax keeps the (64, n) scores and
// fits only where ops/hstu_block.py:tf32_block says.
constexpr int kTf32MaxN = 512;
inline bool tf32_widths_ok(int D, int H, int dqk, int dv, int n) {
  return widths_ok(D, H, dqk, dv) && n >= 1 && n <= kTf32MaxN;
}

// ---- the shared GEMM pieces -----------------------------------------------

// acc (warp's 32 x 64 of the block's 128 x 128) += A[rows, a_col : a_col+GBK]
// @ B[0:GBK, :], A in shared memory with row stride lda, B one stage (GLDB).
__device__ __forceinline__ void mma_stage(const bf16* As, int lda, int a_col, const bf16* Bs,
                                          float (&acc)[2][8][4], int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < GBK / 16; ++kk) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldsm_x4(As + (wm * 32 + mi * 16 + (lane & 15)) * lda + a_col + kk * 16 + (lane >> 4) * 8,
              a[mi]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4_t(Bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * GLDB + wn * 64 + np * 16 +
                    (lane >> 4) * 8,
                b);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// The projection's column space: u (h*dv, as in uvqk), then v, q, k per head
// padded to dv_p / dqk_p. `real` maps a padded column to uvqk's (-1: padding).
struct ColMap {
  int hdv, H, dqk, dv, dqk_p, dv_p, Fv;
  __device__ __forceinline__ int real(int c) const {
    if (c >= Fv) return -1;
    if (c < hdv) return c;
    c -= hdv;
    if (c < H * dv_p) {
      const int hd = c / dv_p, d = c - hd * dv_p;
      return d < dv ? hdv + hd * dv + d : -1;
    }
    c -= H * dv_p;
    const int hq = H * dqk_p, part = c >= hq ? 1 : 0;
    c -= part * hq;
    const int hd = c / dqk_p, d = c - hd * dqk_p;
    return d < dqk ? 2 * hdv + part * H * dqk + hd * dqk + d : -1;
  }
};

struct ProjArgs {
  const bf16* x;     // (M, D)
  const bf16* w;     // uvqk (D, F)
  float* u;          // (M, h*dv) f32
  bf16* vqk;         // (M, Fv - h*dv): [v | q | k], heads padded
  bf16* out;         // the probe's ident mode: (M, D)
  const bf16* resid; // ident: x
  ColMap cm;
  int M, D, F;
  float eps, vscale;
  int act;           // 1: SiLU, 0: none
  int ident;         // probe: out = (LN(x) @ uvqk)[:, :D] + x, nothing else stored
};

// Rows k0.. of uvqk, padded columns n0.. into one B stage; zeros past D and
// in the padding. `vec`: no padding and F % 8 == 0, 16-byte cp.async.
__device__ __forceinline__ void load_w_stage(bf16* Bs, const ProjArgs& p, int k0, int n0, bool vec,
                                             int tid) {
  if (vec) {
    for (int e = tid; e < GBK * (GBN / 8); e += kThreads) {
      const int r = e / (GBN / 8), c = (e % (GBN / 8)) * 8;
      const int k = k0 + r, col = n0 + c;
      const bool ok = k < p.D && col < p.F;
      cp_async16(Bs + r * GLDB + c, ok ? p.w + static_cast<int64_t>(k) * p.F + col : p.w, ok);
    }
  } else {
    for (int e = tid; e < GBK * GBN; e += kThreads) {
      const int r = e / GBN, c = e % GBN, k = k0 + r;
      const int rc = p.cm.real(n0 + c);
      Bs[r * GLDB + c] = (k < p.D && rc >= 0) ? p.w[static_cast<int64_t>(k) * p.F + rc]
                                              : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ void proj_epilogue(const ProjArgs& p, const float (&acc)[2][8][4],
                                              int64_t m0, int n0, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int hdv = p.cm.hdv, ldv = p.cm.Fv - hdv, vend = p.cm.H * p.cm.dv_p;
  const bool pairs = (hdv & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + wn * 64 + ni * 8 + 2 * t;
        if (c >= p.cm.Fv) continue;
        float v[2] = {acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]};
        if (p.ident) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rc = p.cm.real(c + e);
            if (rc >= 0 && rc < p.D) {
              const int64_t o = row * p.D + rc;
              p.out[o] = __float2bfloat16_rn(v[e] + __bfloat162float(p.resid[o]));
            }
          }
          continue;
        }
        if (p.act) {
          v[0] = silu_bf16(v[0]);
          v[1] = silu_bf16(v[1]);
        }
        if (pairs) {  // c and c + 1 fall on the same side of every boundary
          if (c < hdv) {
            *reinterpret_cast<float2*>(p.u + row * hdv + c) = make_float2(v[0], v[1]);
          } else {
            const int cv = c - hdv;
            const float s = cv < vend ? p.vscale : 1.f;
            *reinterpret_cast<__nv_bfloat162*>(p.vqk + row * ldv + cv) =
                __floats2bfloat162_rn(v[0] * s, v[1] * s);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = c + e;
            if (cc >= p.cm.Fv) continue;
            if (cc < hdv) {
              p.u[row * hdv + cc] = v[e];
            } else {
              const int cv = cc - hdv;
              p.vqk[row * ldv + cv] = __float2bfloat16_rn(cv < vend ? v[e] * p.vscale : v[e]);
            }
          }
        }
      }
    }
  }
}

// round_bf16(LN(x)) of the block's rows into the A tile, zeros past D (to
// KA) and past M. D % 8 == 0: a lane's 8 columns in one 16-byte load, four
// rows a warp at a time.
__device__ __forceinline__ void ln_rows_vec(const ProjArgs& p, bf16* As, int lda, int KA,
                                            int64_t m0, int warp, int lane) {
  constexpr int kRowsAtOnce = 4;
  const int chunks = p.D / 8;
  for (int r0 = warp * kRowsAtOnce; r0 < GBM; r0 += kRowsAtOnce * (kThreads / 32)) {
    float v[kRowsAtOnce][8];
    bool live[kRowsAtOnce];
#pragma unroll
    for (int rr = 0; rr < kRowsAtOnce; ++rr) {
      const int64_t row = m0 + r0 + rr;
      live[rr] = row < p.M;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (live[rr] && lane < chunks) {
        raw = *reinterpret_cast<const uint4*>(p.x + row * p.D + lane * 8);
      }
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        v[rr][2 * q] = f.x;
        v[rr][2 * q + 1] = f.y;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRowsAtOnce; ++rr) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) s += v[rr][q];
      const float mean = warp_sum(s) / p.D;
      float var = 0.f;
      if (lane < chunks) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float d = v[rr][q] - mean;
          var = fmaf(d, d, var);
        }
      }
      const float rstd = rsqrtf(warp_sum(var) / p.D + p.eps);
      if (lane * 8 < KA) {
        uint4 out = make_uint4(0, 0, 0, 0);
        if (live[rr] && lane < chunks) {
          out.x = pack_bf16((v[rr][0] - mean) * rstd, (v[rr][1] - mean) * rstd);
          out.y = pack_bf16((v[rr][2] - mean) * rstd, (v[rr][3] - mean) * rstd);
          out.z = pack_bf16((v[rr][4] - mean) * rstd, (v[rr][5] - mean) * rstd);
          out.w = pack_bf16((v[rr][6] - mean) * rstd, (v[rr][7] - mean) * rstd);
        }
        *reinterpret_cast<uint4*>(As + (r0 + rr) * lda + lane * 8) = out;
      }
    }
  }
}

// As ln_rows_vec for any D <= 32 Q: lanes over single columns, Q of them a
// lane (8 up to D = 256; 10 past it, for A tiles KA = 320 wide), zeros from
// D to KA, which the statistics never read.
template <int Q>
__device__ __forceinline__ void ln_rows_scalar(const ProjArgs& p, bf16* As, int lda, int KA,
                                               int64_t m0, int warp, int lane) {
  for (int r = warp; r < GBM; r += kThreads / 32) {
    const int64_t row = m0 + r;
    bf16* dst = As + r * lda;
    if (row >= p.M) {
      for (int k = lane; k < KA; k += 32) dst[k] = __float2bfloat16_rn(0.f);
      continue;
    }
    const bf16* xr = p.x + row * p.D;
    float v[Q];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      v[q] = k < p.D ? __bfloat162float(xr[k]) : 0.f;
      s += v[q];
    }
    const float mean = warp_sum(s) / p.D;
    float var = 0.f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < p.D) {
        const float d = v[q] - mean;
        var = fmaf(d, d, var);
      }
    }
    const float rstd = rsqrtf(warp_sum(var) / p.D + p.eps);
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = lane + 32 * q;
      if (k < KA) dst[k] = __float2bfloat16_rn(k < p.D ? (v[q] - mean) * rstd : 0.f);
    }
  }
}

// A warp's slice of a free B stage, in floats: 8 rows of 64 f32 columns
// (stride 68) or of 64 bf16 columns (stride 72 bf16).
constexpr int kWarpStage = 8 * 68;
static_assert(GBK * GLDB * sizeof(bf16) >= (kThreads / 32) * kWarpStage * sizeof(float),
              "a B stage holds every warp's epilogue slice");

// The projection's epilogue for a warp whose 64 columns lie all in u or all
// in [v | q | k]: through the warp's slice `wbuf` of a B stage no load
// targets, 8 rows at a time, so that each row leaves in 16-byte lanes, 256
// (u, f32) or 128 (bf16) contiguous bytes; the ident probe's Y[:, :D] + x
// likewise from u's columns (those past D dropped). Returns false, storing
// nothing, for any other warp (a boundary inside the 64 columns).
__device__ __forceinline__ bool proj_epilogue_staged(const ProjArgs& p, const float (&acc)[2][8][4],
                                                     int64_t m0, int n0, int wm, int wn, int lane,
                                                     float* wbuf) {
  const int hdv = p.cm.hdv, ldv = p.cm.Fv - hdv, vend = p.cm.H * p.cm.dv_p;
  const int c0 = n0 + wn * 64;
  bool in_u = c0 + 64 <= hdv && (hdv & 3) == 0;
  const bool in_vqk = !p.ident && c0 >= hdv && c0 + 64 <= p.cm.Fv && (hdv & 7) == 0;
  if (p.ident) {
    if (c0 >= hdv && p.D <= hdv) return true;  // real columns >= h*dv >= D: dropped
    in_u = in_u && c0 + 64 <= p.D && (p.D & 3) == 0;
  }
  if (!(in_u || in_vqk)) return false;
  const int g = lane >> 2, t = lane & 3;
  bf16* hbuf = reinterpret_cast<bf16*>(wbuf);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row0 = m0 + wm * 32 + mi * 16 + half * 8;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
        if (p.act) {
          v0 = silu_bf16(v0);
          v1 = silu_bf16(v1);
        }
        const int c = ni * 8 + 2 * t;
        if (in_u) {
          *reinterpret_cast<float2*>(wbuf + g * 68 + c) = make_float2(v0, v1);
        } else {
          const float sc = c0 - hdv + c < vend ? p.vscale : 1.f;
          *reinterpret_cast<__nv_bfloat162*>(hbuf + g * 72 + c) =
              __floats2bfloat162_rn(v0 * sc, v1 * sc);
        }
      }
      __syncwarp();
      if (in_u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = lane + 32 * k, r = q >> 4, c4 = (q & 15) * 4;
          if (row0 + r >= p.M) continue;
          const float4 a = *reinterpret_cast<const float4*>(wbuf + r * 68 + c4);
          if (p.ident) {  // out = Y[:, :D] + x in bf16
            const int64_t o = (row0 + r) * p.D + c0 + c4;
            const uint2 xr = *reinterpret_cast<const uint2*>(p.resid + o);
            const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
            const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
            *reinterpret_cast<uint2*>(p.out + o) =
                make_uint2(pack_bf16(a.x + x0.x, a.y + x0.y), pack_bf16(a.z + x1.x, a.w + x1.y));
          } else {
            *reinterpret_cast<float4*>(p.u + (row0 + r) * hdv + c0 + c4) = a;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int q = lane + 32 * k, r = q >> 3, c8 = (q & 7) * 8;
          if (row0 + r < p.M) {
            *reinterpret_cast<uint4*>(p.vqk + (row0 + r) * ldv + c0 - hdv + c8) =
                *reinterpret_cast<const uint4*>(hbuf + r * 72 + c8);
          }
        }
      }
      __syncwarp();
    }
  }
  return true;
}

// Launch 1: LN(x) @ uvqk on the tensor cores, see the note at the top.
__global__ void __launch_bounds__(kThreads, 2) tc_proj_kernel(ProjArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int KA = (p.D + GBK - 1) / GBK * GBK, lda = KA + 8;
  bf16* As = reinterpret_cast<bf16*>(tc_smem);  // [GBM][lda] round_bf16(LN(x))
  bf16* Bs = As + GBM * lda;                     // kStages x [GBK][GLDB] uvqk rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * GBM;
  const int KT = KA / GBK, NT = (p.cm.Fv + GBN - 1) / GBN, total = KT * NT;
  const bool vec = p.cm.Fv == p.F && (p.F & 7) == 0;

  // The first uvqk stages stream in while the LayerNorm runs.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_w_stage(Bs + s * GBK * GLDB, p, (s % KT) * GBK, (s / KT) * GBN, vec, tid);
    cp_async_commit();
  }

  // LayerNorm of the block's rows: population variance, two passes.
  if (p.D > 256) {
    ln_rows_scalar<10>(p, As, lda, KA, m0, warp, lane);
  } else if ((p.D & 7) == 0) {
    ln_rows_vec(p, As, lda, KA, m0, warp, lane);
  } else {
    ln_rows_scalar<8>(p, As, lda, KA, m0, warp, lane);
  }

  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][8][4];
  for (int it = 0; it < total; ++it) {
    const int kt = it % KT;
    if (kt == 0) zero_acc(acc);
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = it + kStages - 1;
    if (nx < total) {
      load_w_stage(Bs + (nx % kStages) * GBK * GLDB, p, (nx % KT) * GBK, (nx / KT) * GBN, vec,
                   tid);
    }
    cp_async_commit();
    mma_stage(As, lda, kt * GBK, Bs + (it % kStages) * GBK * GLDB, acc, wm, wn, lane);
    if (kt == KT - 1) {
      __syncthreads();  // every warp is past this stage, and no load targets it
      float* wbuf = reinterpret_cast<float*>(Bs + (it % kStages) * GBK * GLDB) + warp * kWarpStage;
      if (!proj_epilogue_staged(p, acc, m0, (it / KT) * GBN, wm, wn, lane, wbuf)) {
        proj_epilogue(p, acc, m0, (it / KT) * GBN, wm, wn, lane);
      }
    }
  }
}

struct OutArgs {
  const bf16* a;      // o_input (M, K)
  const bf16* w;      // o_kernel (K, N)
  const float* bias;  // (N,)
  const bf16* x;      // (M, N) residual
  bf16* out;          // (M, N)
  int M, K, N;
};

__device__ __forceinline__ void load_out_stage(bf16* As, bf16* Bs, const OutArgs& p, int64_t m0,
                                               int n0, int k0, int tid) {
  if ((p.K & 7) == 0) {
    for (int e = tid; e < GBM * (GBK / 8); e += kThreads) {
      const int r = e / (GBK / 8), c = (e % (GBK / 8)) * 8;
      const int64_t row = m0 + r;
      const bool ok = row < p.M && k0 + c < p.K;
      cp_async16(As + r * GLDA + c, ok ? p.a + row * p.K + k0 + c : p.a, ok);
    }
  } else {
    for (int e = tid; e < GBM * GBK; e += kThreads) {
      const int r = e / GBK, c = e % GBK;
      const int64_t row = m0 + r;
      As[r * GLDA + c] =
          (row < p.M && k0 + c < p.K) ? p.a[row * p.K + k0 + c] : __float2bfloat16_rn(0.f);
    }
  }
  if ((p.N & 7) == 0) {
    for (int e = tid; e < GBK * (GBN / 8); e += kThreads) {
      const int r = e / (GBN / 8), c = (e % (GBN / 8)) * 8;
      const int k = k0 + r, col = n0 + c;
      const bool ok = k < p.K && col < p.N;
      cp_async16(Bs + r * GLDB + c, ok ? p.w + static_cast<int64_t>(k) * p.N + col : p.w, ok);
    }
  } else {
    for (int e = tid; e < GBK * GBN; e += kThreads) {
      const int r = e / GBN, c = e % GBN, k = k0 + r, col = n0 + c;
      Bs[r * GLDB + c] = (k < p.K && col < p.N) ? p.w[static_cast<int64_t>(k) * p.N + col]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// Launch 3: out = o_input @ Wo + bo + x in bf16.
__global__ void __launch_bounds__(kThreads, 2) tc_out_kernel(OutArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* As = reinterpret_cast<bf16*>(tc_smem);  // kStages x [GBM][GLDA]
  bf16* Bs = As + kStages * GBM * GLDA;          // kStages x [GBK][GLDB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * GBM;
  const int n0 = blockIdx.y * GBN;
  const int KT = (p.K + GBK - 1) / GBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_out_stage(As + s * GBM * GLDA, Bs + s * GBK * GLDB, p, m0, n0, s * GBK, tid);
    cp_async_commit();
  }
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][8][4];
  zero_acc(acc);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = kt + kStages - 1;
    if (nx < KT) {
      load_out_stage(As + (nx % kStages) * GBM * GLDA, Bs + (nx % kStages) * GBK * GLDB, p, m0,
                     n0, nx * GBK, tid);
    }
    cp_async_commit();
    mma_stage(As + (kt % kStages) * GBM * GLDA, GLDA, 0, Bs + (kt % kStages) * GBK * GLDB, acc,
              wm, wn, lane);
  }

  const int g = lane >> 2, t = lane & 3;
  if ((p.N & 7) == 0) {
    // Through shared memory (the stages are dead): rows leave in 16-byte
    // lanes, with x and bo read the same way.
    constexpr int kLdSt = GBN + 4;
    static_assert(GBM * kLdSt * sizeof(float) <=
                      kStages * (GBM * GLDA + GBK * GLDB) * sizeof(bf16),
                  "the stages hold the block's f32 output tile");
    float* St = reinterpret_cast<float*>(tc_smem);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + mi * 16 + g + half * 8, c = wn * 64 + ni * 8 + 2 * t;
          *reinterpret_cast<float2*>(St + r * kLdSt + c) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
        }
    __syncthreads();
    for (int e = tid; e < GBM * (GBN / 8); e += kThreads) {
      const int r = e / (GBN / 8), c = (e % (GBN / 8)) * 8;
      const int64_t row = m0 + r;
      const int col = n0 + c;
      if (row >= p.M || col >= p.N) continue;
      const float* a = St + r * kLdSt + c;
      const uint4 xr = *reinterpret_cast<const uint4*>(p.x + row * p.N + col);
      const __nv_bfloat162* xh = reinterpret_cast<const __nv_bfloat162*>(&xr);
      uint4 o;
      uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(xh[q]);
        ow[q] = pack_bf16(a[2 * q] + p.bias[col + 2 * q] + xf.x,
                          a[2 * q + 1] + p.bias[col + 2 * q + 1] + xf.y);
      }
      *reinterpret_cast<uint4*>(p.out + row * p.N + col) = o;
    }
    return;
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (row >= p.M) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + 2 * t;
        const float a0 = acc[mi][ni][half * 2], a1 = acc[mi][ni][half * 2 + 1];
        if (col < p.N) {
          const int64_t o = row * p.N + col;
          p.out[o] = __float2bfloat16_rn(a0 + p.bias[col] + __bfloat162float(p.x[o]));
        }
        if (col + 1 < p.N) {
          const int64_t o = row * p.N + col + 1;
          p.out[o] = __float2bfloat16_rn(a1 + p.bias[col + 1] + __bfloat162float(p.x[o]));
        }
      }
    }
  }
}

// ---- launch 2: the attention and o_input ----------------------------------

struct AttnArgs {
  const bf16* vqk;        // (B*n, ldv) [v | q | k], heads padded
  const float* u;         // (B*n, h*dv) f32
  const float* colmask;   // (B, n)
  const float* rel_pos;   // (n, n)          internal and rel-pos bias
  const int* ext;         // (B, n+1)        internal bias
  const float* tsw;       // (128,)          internal bias
  const bf16* bias;       // (B, n, n)       tensor bias
  bf16* oin;              // (B*n, h*dv or 3*h*dv)
  int n, H, dqk, dv, dqk_p, dv_p;
  int bias_mode;          // enum Bias of hstu_block.cuh
  int gate;               // 0: SiLU, 1: linear (the probe's linattn)
  int concat_ua;
  int noattn;             // probe: attn := v (already bf16(y / max_seq_len))
  int max_bucket;
  float eps, inv_sqrt_dqk;
};

// The train forward's (K4's) arguments, which only the TRAIN instances take:
// attn (B*n, h*dv) f32 out, and the K3 keep masks of the layer's seed, on
// o_input (odrop) and on the attention weights (adrop).
struct TrainAttnArgs : AttnArgs {
  float* attn;
  int seed0;
  int odrop;
  uint32_t othresh;
  float oscale;
  int adrop;
  uint32_t athresh;
  float ascale;
};

template <bool TRAIN>
using AttnArgsOf = std::conditional_t<TRAIN, TrainAttnArgs, AttnArgs>;

__device__ __forceinline__ float bias_at(const AttnArgs& p, int b, int i, int j, const int* ex,
                                         const float* tw) {
  switch (p.bias_mode) {
    case kBiasInternal:
      return p.rel_pos[static_cast<int64_t>(i) * p.n + j] +
             tw[time_bucket(ex[i + 1], ex[j], p.max_bucket)];
    case kBiasTensor:
      return __bfloat162float(p.bias[(static_cast<int64_t>(b) * p.n + i) * p.n + j]);
    case kBiasRelPos:
      return p.rel_pos[static_cast<int64_t>(i) * p.n + j];
    default:
      return 0.f;
  }
}

// Rows r0 .. r0+R of columns [off, off+width) of one user's vqk rows into dst
// (row stride ld); rows at or past n are zeros. width and off are multiples
// of 8 (the padded layout).
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* vb, int ldv, int off,
                                           int width, int r0, int R, int n, int tid, int nthr) {
  const int chunks = width / 8;
  for (int e = tid; e < R * chunks; e += nthr) {
    const int r = e / chunks, c = (e % chunks) * 8;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * ld + c, ok ? vb + static_cast<int64_t>(r0 + r) * ldv + off + c : vb, ok);
  }
}

// The block's small tables: column validity (zeros past n up to np32), and
// for the internal bias the time-bucket weights and extended timestamps.
__device__ __forceinline__ void stage_tables(const AttnArgs& p, int b, int np32, float* cm,
                                             float* tw, int* ex, int tid, int nthr) {
  for (int j = tid; j < np32; j += nthr)
    cm[j] = j < p.n ? p.colmask[static_cast<int64_t>(b) * p.n + j] : 0.f;
  if (p.bias_mode == kBiasInternal) {
    for (int j = tid; j <= p.n; j += nthr) ex[j] = p.ext[static_cast<int64_t>(b) * (p.n + 1) + j];
    for (int k = tid; k < 128; k += nthr) tw[k] = p.tsw[k];
  }
}

// o += a (16 x 32 keys, A fragments of two k16 steps) @ v (32 keys, head hd).
template <int DVP>
__device__ __forceinline__ void av_head(float (&o)[DVP / 8][4], const uint32_t (&a)[2][4],
                                        const bf16* Vs, int ldvs, int hd, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const bf16* vrow = Vs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldvs + hd * DVP;
    if constexpr (DVP == 8) {
      uint32_t b[2];
      ldsm_x2_t(vrow, b);
      mma_bf16(o[0], a[ks], b[0], b[1]);
    } else {
#pragma unroll
      for (int np = 0; np < DVP / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_t(vrow + np * 16 + (lane >> 4) * 8, b);
        mma_bf16(o[2 * np], a[ks], b[0], b[1]);
        mma_bf16(o[2 * np + 1], a[ks], b[2], b[3]);
      }
    }
  }
}

// 4 floats rounded to bf16 into 8 aligned bytes.
__device__ __forceinline__ void store_bf16x4(bf16* dst, float a, float b, float c, float d) {
  uint2 v;
  v.x = pack_bf16(a, b);
  v.y = pack_bf16(c, d);
  *reinterpret_cast<uint2*>(dst) = v;
}

// The train forward's o_input rows from the staged LN(attn) (row stride lds)
// and u: o_input = u * LN(attn), or concat_ua's [u, LN(attn), u * LN(attn)],
// times the o_input keep mask (idx = position * o_width + column, the user's
// seed) before the rounding (`_fwd_kernel`: o_in * mask, then the cast).
__device__ __forceinline__ void train_oinput_rows(const TrainAttnArgs& p, const float* stage, int lds,
                                                  int b, int i0, int rows, int ldo,
                                                  int64_t row0) {
  const int hdv = p.H * p.dv;
  const uint32_t oseed = user_seed(p.seed0, b);
  for (int e = threadIdx.x; e < rows * hdv; e += blockDim.x) {
    const int r = e / hdv, c = e - r * hdv;
    const float a = stage[r * lds + c], uu = p.u[(row0 + r) * hdv + c];
    const uint32_t idx = static_cast<uint32_t>((i0 + r) * ldo + c);
    auto keep = [&](int part) {
      return p.odrop ? keep_scale(idx + part * hdv, oseed, p.othresh, p.oscale) : 1.f;
    };
    bf16* o = p.oin + (row0 + r) * ldo + c;
    int part = 0;
    if (p.concat_ua) {
      o[0] = __float2bfloat16_rn(uu * keep(0));
      o[hdv] = __float2bfloat16_rn(a * keep(1));
      o += 2 * hdv;
      part = 2;
    }
    o[0] = __float2bfloat16_rn(uu * a * keep(part));
  }
}

// The attention epilogue: LayerNorm statistics of whole attn rows across the
// head warps, then o_input = bf16(u * LN(attn)) or concat_ua's
// [bf16(u), bf16(LN(attn)), bf16(u * LN(attn))]. `stage` is the block's
// dynamic shared memory, (kRows, h*dv + 4) floats, free once every warp is
// past its last product (the first barrier below).
template <int DVP, bool TRAIN>
__device__ __forceinline__ void oinput_epilogue(const AttnArgsOf<TRAIN>& p,
                                                const float (&O)[kHeadsPerWarp][DVP / 8][4],
                                                int b, int i0, int wr, int wc, int hw, int nwc,
                                                int lane, float (&red)[2][kRows][2],
                                                float* stage) {
  const int g = lane >> 2, t = lane & 3, hdv = p.H * p.dv;
  float mean[2], rstd[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
#pragma unroll
      for (int ni = 0; ni < DVP / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ni * 8 + 2 * t + (e & 1) >= p.dv) continue;
          const float v = O[hh][ni][e];
          if (pass == 0) {
            s[e >> 1] += v;
          } else {
            const float d = v - mean[e >> 1];
            s[e >> 1] = fmaf(d, d, s[e >> 1]);
          }
        }
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s[half] += __shfl_xor_sync(0xffffffffu, s[half], 1);
      s[half] += __shfl_xor_sync(0xffffffffu, s[half], 2);
      if (t == 0) red[pass][wr * 16 + g + half * 8][wc] = s[half];
    }
    __syncthreads();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float tot = 0.f;
      for (int w = 0; w < nwc; ++w) tot += red[pass][wr * 16 + g + half * 8][w];
      if (pass == 0) {
        mean[half] = tot / hdv;
      } else {
        rstd[half] = rsqrtf(tot / hdv + p.eps);
      }
    }
  }
  if constexpr (TRAIN) {  // attn itself, f32, straight from the fragments
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
#pragma unroll
      for (int ni = 0; ni < DVP / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + wr * 16 + g + (e >> 1) * 8, d = ni * 8 + 2 * t + (e & 1);
          if (i < p.n && d < p.dv) {
            p.attn[(static_cast<int64_t>(b) * p.n + i) * hdv + (wc * hw + hh) * p.dv + d] =
                O[hh][ni][e];
          }
        }
    }
  }
  // LN(attn) staged through shared memory (the block's tiles are dead), so
  // that u is read and o_input written in whole rows, 16 and 8 bytes a lane.
  const int lds = hdv + 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr * 16 + g + half * 8;
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
      const int hd = wc * hw + hh;
#pragma unroll
      for (int ni = 0; ni < DVP / 8; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = ni * 8 + 2 * t + e;
          if (d < p.dv) {
            stage[r * lds + hd * p.dv + d] = (O[hh][ni][half * 2 + e] - mean[half]) * rstd[half];
          }
        }
      }
    }
  }
  __syncthreads();
  const int rows = min(kRows, p.n - i0), ldo = p.concat_ua ? 3 * hdv : hdv;
  const int64_t row0 = static_cast<int64_t>(b) * p.n + i0;
  if constexpr (TRAIN) {
    train_oinput_rows(p, stage, lds, b, i0, rows, ldo, row0);
    return;
  }
  if ((hdv & 3) == 0) {
    const int q4 = hdv / 4;
    for (int e = threadIdx.x; e < rows * q4; e += blockDim.x) {
      const int r = e / q4, c = (e - r * q4) * 4;
      const float4 a = *reinterpret_cast<const float4*>(stage + r * lds + c);
      const float4 uu = *reinterpret_cast<const float4*>(p.u + (row0 + r) * hdv + c);
      bf16* o = p.oin + (row0 + r) * ldo + c;
      if (p.concat_ua) {
        store_bf16x4(o, uu.x, uu.y, uu.z, uu.w);
        store_bf16x4(o + hdv, a.x, a.y, a.z, a.w);
        o += 2 * hdv;
      }
      store_bf16x4(o, uu.x * a.x, uu.y * a.y, uu.z * a.z, uu.w * a.w);
    }
  } else {
    for (int e = threadIdx.x; e < rows * hdv; e += blockDim.x) {
      const int r = e / hdv, c = e - r * hdv;
      const float a = stage[r * lds + c], uu = p.u[(row0 + r) * hdv + c];
      bf16* o = p.oin + (row0 + r) * ldo + c;
      if (p.concat_ua) {
        o[0] = __float2bfloat16_rn(uu);
        o[hdv] = __float2bfloat16_rn(a);
        o += 2 * hdv;
      }
      o[0] = __float2bfloat16_rn(uu * a);
    }
  }
}

size_t attn_smem_bytes(int n, int H, int dqk, int dv, int softmax) {
  const size_t hq = static_cast<size_t>(H) * pad_dqk(dqk), hv = static_cast<size_t>(H) * pad_dv(dv);
  const size_t ldq = hq + 8, ldvs = hv + 8, np32 = (n + 31) / 32 * 32;
  const size_t tables = (np32 + 128) * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
  const size_t stage = kRows * (static_cast<size_t>(H) * dv + 4) * sizeof(float);
  size_t bytes;
  if (!softmax) {
    bytes = (kRows * ldq + kKeys * ldq + kKeys * ldvs) * sizeof(bf16) +
            kRows * kLdBias * sizeof(float) + tables;
  } else {
    const size_t lds = np32 + 4, lda = np32 + 8;
    bytes = kRows * lds * sizeof(float) +
            (kRows * (ldq > lda ? ldq : lda) + kKeys * (ldq > ldvs ? ldq : ldvs)) * sizeof(bf16) +
            tables;
  }
  return bytes > stage ? bytes : stage;
}

// Launch 2, pointwise SiLU attention (or the probe's linear gate / noattn).
// TRAIN (K4's forward): the attention keep mask times a before its rounding,
// o_input's keep mask, and attn written in f32.
template <int DVP, bool TRAIN = false>
__global__ void __launch_bounds__(kThreads, 2) tc_attn_kernel(AttnArgsOf<TRAIN> p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float red[2][kRows][2];
  const int H = p.H, hq = H * p.dqk_p, hvp = H * DVP;
  const int ldq = hq + 8, ldvs = hvp + 8, ldv = hvp + 2 * hq, np32 = (p.n + 31) / 32 * 32;
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);             // [kRows][ldq]
  bf16* Ks = Qs + kRows * ldq;                              // [kKeys][ldq]
  bf16* Vs = Ks + kKeys * ldq;                              // [kKeys][ldvs]
  float* Bt = reinterpret_cast<float*>(Vs + kKeys * ldvs);  // [kRows][kLdBias]
  float* cm = Bt + kRows * kLdBias;                         // [np32]
  float* tw = cm + np32;                                    // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);               // [n + 1]

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, nwc = nthr / 128, hw = H / nwc;
  const int g = lane >> 2, t = lane & 3;
  const bf16* vb = p.vqk + static_cast<int64_t>(b) * p.n * ldv;

  float O[kHeadsPerWarp][DVP / 8][4];
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh)
#pragma unroll
    for (int ni = 0; ni < DVP / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[hh][ni][e] = 0.f;

  if (p.noattn) {
    // attn := v, stored as bf16(y / max_seq_len) by the projection.
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
#pragma unroll
      for (int ni = 0; ni < DVP / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + wr * 16 + g + (e >> 1) * 8;
          if (i < p.n) {
            const int c = (wc * hw + hh) * DVP + ni * 8 + 2 * t + (e & 1);
            O[hh][ni][e] = __bfloat162float(vb[static_cast<int64_t>(i) * ldv + c]);
          }
        }
    }
  } else {
    stage_rows(Qs, ldq, vb, ldv, hvp, hq, i0, kRows, p.n, tid, nthr);
    cp_async_commit();
    stage_tables(p, b, np32, cm, tw, ex, tid, nthr);
    __syncthreads();
    const int jmax = min(i0 + kRows, p.n);
    const int wlast = i0 + wr * 16 + 15;  // the warp's last query row
    for (int j0 = 0; j0 < jmax; j0 += kKeys) {
      // A barrier (the previous tile's readers are done) that also skips a
      // tile whose key columns are all invalid: its a are all 0.
      if (!__syncthreads_or(tid < kKeys && cm[j0 + tid] != 0.f)) continue;
      stage_rows(Ks, ldq, vb, ldv, hvp + hq, hq, j0, kKeys, p.n, tid, nthr);
      stage_rows(Vs, ldvs, vb, ldv, 0, hvp, j0, kKeys, p.n, tid, nthr);
      cp_async_commit();
      // The bias tile, once for every head. Under SiLU a masked pair (j > i
      // or an invalid key; colmask holds 0 or 1) holds kMaskPenalty: SiLU of
      // it is exactly -0, the a the mask multiply gives. The linear gate
      // holds 0 there and multiplies by the mask.
      const float off = p.gate ? 0.f : kMaskPenalty;
      for (int e = tid; e < kRows * kKeys; e += nthr) {
        const int r = e / kKeys, c = e % kKeys, i = i0 + r, j = j0 + c;
        Bt[r * kLdBias + c] =
            (i < p.n && j <= i && cm[j] != 0.f) ? bias_at(p, b, i, j, ex, tw) : off;
      }
      cp_async_wait<0>();
      __syncthreads();
      if (j0 > wlast) continue;
#pragma unroll
      for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
        if (hh >= hw) break;
        const int hd = wc * hw + hh;
        float S[4][4] = {};
        for (int ks = 0; ks < p.dqk_p / 16; ++ks) {
          uint32_t a[4];
          ldsm_x4(Qs + (wr * 16 + (lane & 15)) * ldq + hd * p.dqk_p + ks * 16 + (lane >> 4) * 8, a);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t kb[4];
            ldsm_x4(Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldq + hd * p.dqk_p +
                        ks * 16 + ((lane >> 3) & 1) * 8,
                    kb);
            mma_bf16(S[2 * np], a, kb[0], kb[1]);
            mma_bf16(S[2 * np + 1], a, kb[2], kb[3]);
          }
        }
        // Bias and gate in registers (the mask is in the bias tile under
        // SiLU); a rounds to bf16 into the A fragments of a @ v (score
        // n-tiles 2ks, 2ks+1 = key step ks).
        uint32_t P[2][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wr * 16 + g + half * 8, c = ni * 8 + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(Bt + r * kLdBias + c);
            float a0 = S[ni][half * 2] + bb.x, a1 = S[ni][half * 2 + 1] + bb.y;
            if (p.gate) {  // the probe's linear gate: the mask multiplies
              const int i = i0 + r, j = j0 + c;
              a0 = j <= i ? a0 * cm[j] : 0.f;
              a1 = j + 1 <= i ? a1 * cm[j + 1] : 0.f;
            } else {
              a0 = silu_bf16(a0);
              a1 = silu_bf16(a1);
            }
            if constexpr (TRAIN) {  // `_fwd_kernel`: a_h * mask before the cast
              if (p.adrop) {
                const uint32_t idx = static_cast<uint32_t>((i0 + r) * p.n + j0 + c);
                const uint32_t aseed = attn_seed(p.seed0, b, hd);
                a0 *= keep_scale(idx, aseed, p.athresh, p.ascale);
                a1 *= keep_scale(idx + 1, aseed, p.athresh, p.ascale);
              }
            }
            P[ni >> 1][(ni & 1) * 2 + half] = pack_bf16(a0, a1);
          }
        }
        av_head<DVP>(O[hh], P, Vs, ldvs, hd, lane);
      }
    }
  }
  oinput_epilogue<DVP, TRAIN>(p, O, b, i0, wr, wc, hw, nwc, lane, red,
                              reinterpret_cast<float*>(tc_smem));
}

// Launch 2, softmax attention (softmax_rel_bias); TRAIN as tc_attn_kernel,
// the attention keep mask of head 0.
template <int DVP, bool TRAIN = false>
__global__ void __launch_bounds__(kThreads, 2) tc_softmax_kernel(AttnArgsOf<TRAIN> p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float red[2][kRows][2];
  const int H = p.H, hq = H * p.dqk_p, hvp = H * DVP;
  const int ldq = hq + 8, ldvs = hvp + 8, ldv = hvp + 2 * hq, np32 = (p.n + 31) / 32 * 32;
  const int lds = np32 + 4, lda = np32 + 8;
  float* Sf = reinterpret_cast<float*>(tc_smem);                    // [kRows][lds] scores
  bf16* Qs = reinterpret_cast<bf16*>(Sf + kRows * lds);              // [kRows][ldq], then
  bf16* As = Qs;                                                     //   a: [kRows][lda]
  bf16* KV = Qs + kRows * (ldq > lda ? ldq : lda);                   // k, then v tiles
  float* cm = reinterpret_cast<float*>(KV + kKeys * (ldq > ldvs ? ldq : ldvs));
  float* tw = cm + np32;
  int* ex = reinterpret_cast<int*>(tw + 128);

  const int b = blockIdx.x, i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int tid = threadIdx.x, nthr = blockDim.x, nwarps = nthr / 32, warp = tid >> 5;
  const int lane = tid & 31, wr = warp & 3, wc = warp >> 2, nwc = nthr / 128, hw = H / nwc;
  const int g = lane >> 2, t = lane & 3;
  const bf16* vb = p.vqk + static_cast<int64_t>(b) * p.n * ldv;

  stage_rows(Qs, ldq, vb, ldv, hvp, hq, i0, kRows, p.n, tid, nthr);
  cp_async_commit();
  stage_tables(p, b, np32, cm, tw, ex, tid, nthr);

  // Scores over every column: (q . k + bias) / sqrt(dqk); -inf past n.
  const int cols = kKeys / nwc;  // key columns a warp takes of each tile
  for (int j0 = 0; j0 < p.n; j0 += kKeys) {
    __syncthreads();
    stage_rows(KV, ldq, vb, ldv, hvp + hq, hq, j0, kKeys, p.n, tid, nthr);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float S[4][4] = {};
    for (int ks = 0; ks < hq / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(Qs + (wr * 16 + (lane & 15)) * ldq + ks * 16 + (lane >> 4) * 8, a);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (np * 16 >= cols) break;
        uint32_t kb[4];
        ldsm_x4(KV + (wc * cols + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldq + ks * 16 +
                    ((lane >> 3) & 1) * 8,
                kb);
        mma_bf16(S[2 * np], a, kb[0], kb[1]);
        mma_bf16(S[2 * np + 1], a, kb[2], kb[3]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      if (ni * 8 >= cols) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr * 16 + g + (e >> 1) * 8, i = i0 + r;
        const int j = j0 + wc * cols + ni * 8 + 2 * t + (e & 1);
        float v = -INFINITY;
        if (j < p.n) {
          v = (S[ni][e] + (i < p.n ? bias_at(p, b, i, j, ex, tw) : 0.f)) * p.inv_sqrt_dqk;
        }
        Sf[r * lds + j] = v;
      }
    }
  }
  __syncthreads();

  // Each row normalised over all n columns, masked after normalisation and
  // rounded: a warp a row. a overwrites q.
  for (int r = warp; r < kRows; r += nwarps) {
    const int i = i0 + r;
    bf16* arow = As + r * lda;
    if (i >= p.n) {
      for (int j = lane; j < np32; j += 32) arow[j] = __float2bfloat16_rn(0.f);
      continue;
    }
    float* srow = Sf + r * lds;
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
    for (int j = lane; j < np32; j += 32) {
      float a = j < p.n ? srow[j] / ssum * (j <= i ? cm[j] : 0.f) : 0.f;
      if constexpr (TRAIN) {
        if (p.adrop) {
          a *= keep_scale(static_cast<uint32_t>(i * p.n + j), attn_seed(p.seed0, b, 0),
                          p.athresh, p.ascale);
        }
      }
      arow[j] = __float2bfloat16_rn(a);
    }
  }

  // a @ v over the causal key tiles, every head.
  float O[kHeadsPerWarp][DVP / 8][4];
#pragma unroll
  for (int hh = 0; hh < kHeadsPerWarp; ++hh)
#pragma unroll
    for (int ni = 0; ni < DVP / 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[hh][ni][e] = 0.f;
  const int jmax = min(i0 + kRows, p.n);
  const int wlast = i0 + wr * 16 + 15;
  for (int j0 = 0; j0 < jmax; j0 += kKeys) {
    // As in tc_attn_kernel: a barrier that skips a tile of invalid keys.
    if (!__syncthreads_or(tid < kKeys && cm[j0 + tid] != 0.f)) continue;
    stage_rows(KV, ldvs, vb, ldv, 0, hvp, j0, kKeys, p.n, tid, nthr);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (j0 > wlast) continue;
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldsm_x4(As + (wr * 16 + (lane & 15)) * lda + j0 + ks * 16 + (lane >> 4) * 8, a[ks]);
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      if (hh >= hw) break;
      av_head<DVP>(O[hh], a, KV, ldvs, wc * hw + hh, lane);
    }
  }
  oinput_epilogue<DVP, TRAIN>(p, O, b, i0, wr, wc, hw, nwc, lane, red,
                              reinterpret_cast<float*>(tc_smem));
}

// ---- host launchers --------------------------------------------------------

inline ColMap col_map(int H, int dqk, int dv) {
  const int dqk_p = pad_dqk(dqk), dv_p = pad_dv(dv), hdv = H * dv;
  return ColMap{hdv, H, dqk, dv, dqk_p, dv_p, hdv + H * dv_p + 2 * H * dqk_p};
}

// Launch 1. vqk has Fv - h*dv columns (col_map); out/resid only for ident.
cudaError_t launch_tc_proj(const bf16* x, const bf16* w, float* u, bf16* vqk, bf16* out, int M,
                           int D, int H, int dqk, int dv, float eps, float vscale, int act,
                           int ident, cudaStream_t s) {
  if (!widths_ok(D, H, dqk, dv)) return cudaErrorInvalidValue;
  const ColMap cm = col_map(H, dqk, dv);
  const ProjArgs p{x, w, u, vqk, out, x, cm, M, D, 2 * H * dv + 2 * H * dqk, eps, vscale, act,
                   ident};
  const int KA = (D + GBK - 1) / GBK * GBK;
  const size_t smem = (static_cast<size_t>(GBM) * (KA + 8) + kStages * GBK * GLDB) * sizeof(bf16);
  cudaError_t err = allow_smem(tc_proj_kernel, smem);
  if (err != cudaSuccess) return err;
  tc_proj_kernel<<<(M + GBM - 1) / GBM, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int DVP, bool TRAIN>
cudaError_t launch_tc_attn_dv(const AttnArgsOf<TRAIN>& p, int B, int softmax, cudaStream_t s) {
  const size_t smem = attn_smem_bytes(p.n, p.H, p.dqk, p.dv, softmax);
  const dim3 grid(B, (p.n + kRows - 1) / kRows);
  const int threads = 128 * head_warps(p.H);
  cudaError_t err;
  if (softmax) {
    if ((err = allow_smem(tc_softmax_kernel<DVP, TRAIN>, smem)) != cudaSuccess) return err;
    tc_softmax_kernel<DVP, TRAIN><<<grid, threads, smem, s>>>(p);
  } else {
    if ((err = allow_smem(tc_attn_kernel<DVP, TRAIN>, smem)) != cudaSuccess) return err;
    tc_attn_kernel<DVP, TRAIN><<<grid, threads, smem, s>>>(p);
  }
  return cudaGetLastError();
}

template <bool TRAIN>
cudaError_t launch_tc_attn_instance(const AttnArgsOf<TRAIN>& p, int B, int softmax,
                                    cudaStream_t s) {
  switch (p.dv_p) {
    case 8:
      return launch_tc_attn_dv<8, TRAIN>(p, B, softmax, s);
    case 16:
      return launch_tc_attn_dv<16, TRAIN>(p, B, softmax, s);
    default:
      return launch_tc_attn_dv<32, TRAIN>(p, B, softmax, s);
  }
}

// Launch 2 over the projection's u and vqk; writes o_input (B*n, h*dv, or
// 3*h*dv with concat_ua).
cudaError_t launch_tc_attn(const bf16* vqk, const float* u, const float* colmask,
                           const float* rel_pos, const int* ext, const float* tsw,
                           const bf16* bias, bf16* oin, int B, int n, int H, int dqk, int dv,
                           float inv_sqrt_dqk, float eps, int max_bucket, int bias_mode, int gate,
                           int softmax, int concat_ua, int noattn, cudaStream_t s) {
  if (!widths_ok(1, H, dqk, dv) || n < 1 || (softmax && noattn)) return cudaErrorInvalidValue;
  const AttnArgs p{vqk,  u,       colmask,   rel_pos,     ext,    tsw,         bias,
                   oin,  n,       H,         dqk,         dv,     pad_dqk(dqk), pad_dv(dv),
                   bias_mode, gate, concat_ua, noattn, max_bucket, eps, inv_sqrt_dqk};
  return launch_tc_attn_instance<false>(p, B, softmax, s);
}

// Launch 3: out (M, N) = o_input (M, K) @ Wo (K, N) + bo + x, bf16.
cudaError_t launch_tc_out(const bf16* oin, const bf16* wo, const float* bo, const bf16* x,
                          bf16* out, int M, int K, int N, cudaStream_t s) {
  const OutArgs p{oin, wo, bo, x, out, M, K, N};
  const size_t smem =
      (static_cast<size_t>(kStages) * GBM * GLDA + kStages * GBK * GLDB) * sizeof(bf16);
  cudaError_t err = allow_smem(tc_out_kernel, smem);
  if (err != cudaSuccess) return err;
  tc_out_kernel<<<dim3((M + GBM - 1) / GBM, (N + GBN - 1) / GBN), kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace
}  // namespace rails
