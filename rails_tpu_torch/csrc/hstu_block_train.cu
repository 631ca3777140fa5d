// HSTU block training (K4), hand-written for Hopper (sm_90a): the forward
// with o_input and attention dropout, and the pointwise attention-core
// backward (the softmax one is hstu_softmax_train.cu).
//
// Replaces `make_fused_train_block` in rails_tpu/ops/pallas/hstu_block_train.py:
// the forward `pallas_call` (`_fwd_kernel`) and the attention-core backward
// `pallas_call` (`_attn_bwd_kernel`, pointwise-SiLU branch), for every variant
// of the block: SiLU or no activation, the relative-attention bias built
// in-kernel or none, u * LN(a) or the concat_ua o_input, attention dropout,
// any head dim. The glue of its custom VJP (projection recompute, dWo, dW,
// dx, the bias-table chain) stays in PyTorch, as the JAX package leaves it to
// XLA.
//
// Forward: K1's three launches (`launch` in hstu_block.cuh) with the K3 keep
// mask applied in the output GEMM's A-tile loader (over the 3*h*dv columns of
// the concat_ua o_input) and the attention keep mask in the attention kernel,
// instanced for f32 and bf16 operands (x, uvqk, o_kernel and the output in
// bf16; f32 accumulation, o_bias, rel_pos and the time table f32; the
// projection kept f32 in device memory, q, k, v and the attention weights
// rounded to bf16 where `_fwd_kernel` casts to the matmul dtype). It leaves
// attn (B*n, h*dv) f32 in device memory; the f32 backward keeps it instead of
// recomputing it.
//
// The bf16 backward takes y and d(o_input) in bf16, as `block_bwd` hands them
// to `_attn_bwd_kernel`, and first recomputes attn from that bf16 y with K1's
// attention kernel reading bf16 (the JAX backward recomputes it there: v is
// rounded twice, bf16(bf16(y) / max_seq_len), so it is not the forward's).
// Then the two kernels below round d_attn, v, the attention weights and d_s to
// bf16 before each product, as `_attn_bwd_kernel` casts to `mm`; d_y, attn and
// dbias stay f32.
//
// Backward. What it must produce per user (non-softmax branch): d_y = [d_u,
// d_v, d_q, d_k] (n x F f32), and dbias = sum_h d_s_h (n x n). The TPU kernel
// holds all 8 heads' (n, n) maps in VMEM; here nothing (n, n) is ever held:
//   (a) attn_row_bwd (hstu_train.cuh): one warp per (user, position) row.
//       gln = LN(attn), d_u and d_gln from d_o (of h*dv or, with concat_ua,
//       3*h*dv columns), d_attn = LN-backward(attn, d_gln) (`_ln_bwd`); d_u
//       goes into d_y, d_attn to a (B*n, h*dv) scratch.
//   (b) hstu_attn_bwd: one block per user, heads in turn. A head's q, k,
//       v/max_seq_len and d_attn (n x 32 each) are staged transposed, with an
//       odd row stride, in shared memory (4 x 32 x 211 x 4 B = 108 KB at
//       n = 211): lanes over positions read consecutive words and lanes over
//       the 32 head dims read words an odd stride apart, so both access
//       patterns are free of bank conflicts. Pass 1 walks query rows, a warp
//       per row, lanes over key columns j <= i: it recomputes s = q_i k_j +
//       bias (rel-pos + time bucket + the -30000 column penalty, built as K1
//       builds it), d_a = d_attn_i . v_j [* keep] and d_s = d_a * silu'(s),
//       adds d_s into the user's dbias row (head 0 writes it, zeroing j > i),
//       then
//       lanes over dims form d_q_i = sum_j d_s_ij k_j. Pass 2 walks key
//       columns, a warp per column, lanes over rows i >= j, recomputes s and
//       d_s and forms d_k_j = sum_i d_s_ij q_i and d_v_j = sum_i a_ij
//       d_attn_i. Attention dropout regenerates the head's keep mask
//       (`attn_seed`) at each (i, j) in both passes. Recomputing s and d_a in
//       pass 2 costs 2 of the kernel's 7 products; in exchange no atomics are
//       needed: every output element has one writer, and dbias sums the heads
//       in the JAX kernel's order, so the result is the same on every run.
//       Without the relative-attention bias the caller passes zero tables
//       and drops dbias: s = q_i k_j + (0 + 0) + penalty in pass 1 and
//       q_i k_j + 0 in pass 2, bit for bit the no-bias s, so one instance
//       serves both.
//       Head dims above 32 (the WIDE instances): the two passes stage only
//       what each reads (k and v, then q and d_attn; 216 KB at dqk = dv = 64,
//       n = 211, would not fit with the row buffers), the row's q and d_attn
//       (pass 1) or the column's k and v (pass 2) come from device memory 32
//       dims at a time into the same registers, and each chunk's partial s and
//       d_a wait in the warp's row buffers. Narrow heads take the WIDE
//       instances too where their four staged arrays would not fit a block
//       (n > 357 at dqk = dv = 32: the combined preprocessor's n = 422 needs
//       274,484 B that way, 166,196 B this way); the products are the same
//       values in the same order, so the result is the same bits.
// Bound: the function needs 5 products of 2 * 32 FLOPs over the causal
// (user, head, i, j) pairs, 7.3 GFLOP per layer at B = 128, n = 211 (0.11 ms
// at the 67 TFLOP/s f32 rate; this kernel does 7, s and d_a twice), against
// ~0.3 GB of traffic (y, d_o, attn, d_y, dbias), 0.09 ms at 3.35 TB/s: the
// FP32 FMA rate of the CUDA cores bounds it. One block per user is 128 blocks
// at B = 128, one wave on 132 SMs. The bf16 instances here run the same FMAs
// on the CUDA cores (products of bf16-rounded values, f32 sums) and read half
// the bytes of y and d_o: those outside K1's tensor-core widths (dqk or dv >
// 32, other head counts) and linear_activation="none". At those widths with
// the SiLU projection the bf16 block runs on the tensor cores instead: the
// forward through hstu_block_tc.cuh (rails_hstu_tc_train_attention between
// K1's projection and output GEMM), the pointwise backward through
// hstu_train_tc.cuh (rails_hstu_tc_train_bwd); the entry points below refuse
// those instances, and the f32 ones at those widths with n <= 512, the SiLU
// projection and the pointwise attention, which run 3xTF32 on the tensor
// cores (hstu_train_tf32.cu).
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "hstu_block.cuh"
#include "hstu_block_tc.cuh"
#include "hstu_train.cuh"
#include "hstu_train_tc.cuh"

namespace rails {
namespace {

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunk = 32;   // head dims held in registers at a time: one per lane

// Narrow heads (dqk, dv <= 32) stage q, k, v and d_attn once per head; wide
// ones stage the two operands each pass reads in two arrays.
size_t attn_bwd_bytes(int n, int dqk, int dv, bool wide) {
  const size_t ldk = static_cast<size_t>(n | 1);
  const size_t floats = (wide ? 1 : 2) * (static_cast<size_t>(dqk) + dv) * ldk +
                        static_cast<size_t>(kBwdWarps) * 2 * n + n + 128;
  return floats * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
}

// The WIDE instance: head dims above 32, or narrow heads whose four staged
// arrays would not fit a block at this length.
bool attn_bwd_wide(int n, int dqk, int dv) {
  return dqk > kChunk || dv > kChunk || attn_bwd_bytes(n, dqk, dv, false) > max_block_smem();
}

size_t attn_bwd_smem_bytes(int n, int dqk, int dv) {
  return attn_bwd_bytes(n, dqk, dv, attn_bwd_wide(n, dqk, dv));
}

// (b) One block per user; heads in turn. y is stored as T; v, d_attn, the
// attention weights and d_s round to T before each product. ADROP regenerates
// the head's attention keep mask; WIDE takes head dims above 32 in register
// chunks of 32.
template <typename T, bool ADROP, bool WIDE>
__global__ void __launch_bounds__(kBwdThreads)
hstu_attn_bwd_kernel(const T* __restrict__ y, const float* __restrict__ d_attn,
                     const float* __restrict__ colmask, const float* __restrict__ rel_pos,
                     const int* __restrict__ ext, const float* __restrict__ tsw,
                     float* __restrict__ d_y, float* __restrict__ dbias, int n, int H, int dqk,
                     int dv, float inv_n, int max_bucket, Dropout adp) {
  extern __shared__ float smem[];
  const int ldk = n | 1;
  // WIDE: kT/vT hold k and v/max_seq_len in pass 1, then qT/dT (the same
  // arrays) q and d_attn in pass 2.
  float* qT = smem;                                  // [dqk][ldk]
  float* kT = WIDE ? qT : qT + dqk * ldk;            // [dqk][ldk]
  float* vT = kT + dqk * ldk;                        // [dv][ldk]   v / max_seq_len
  float* dT = WIDE ? vT : vT + dv * ldk;             // [dv][ldk]   d_attn of the head
  float* wb = dT + dv * ldk;                         // [kBwdWarps][2n] per-warp row buffers
  float* cm = wb + kBwdWarps * 2 * n;                // [n]
  float* tw = cm + n;                                // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);        // [n + 1]

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hdv = H * dv;
  const int F = 2 * hdv + 2 * H * dqk;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  // One register chunk for narrow heads; partial sums of a wide head's
  // chunks wait in the row buffers (same FMA order as one long loop).
  const int dmax = WIDE ? max(dqk, dv) : kChunk;
  for (int j = tid; j < n; j += kBwdThreads) cm[j] = colmask[row0 + j];
  for (int j = tid; j <= n; j += kBwdThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
  for (int t = tid; t < 128; t += kBwdThreads) tw[t] = tsw[t];
  float* buf0 = wb + warp * 2 * n;
  float* buf1 = buf0 + n;

  for (int hd = 0; hd < H; ++hd) {
    const int voff = hdv + hd * dv;
    const int qoff = 2 * hdv + hd * dqk;
    const int koff = 2 * hdv + H * dqk + hd * dqk;
    const uint32_t aseed = ADROP ? attn_seed(adp.seed0, b, hd) : 0u;
    __syncthreads();   // the previous head's readers are done
    for (int e = tid; e < n * dqk; e += kBwdThreads) {
      const int i = e / dqk, d = e % dqk;
      const T* yr = y + (row0 + i) * F;
      if constexpr (!WIDE) qT[d * ldk + i] = to_f<T>(yr[qoff + d]);
      kT[d * ldk + i] = to_f<T>(yr[koff + d]);
    }
    for (int e = tid; e < n * dv; e += kBwdThreads) {
      const int i = e / dv, d = e % dv;
      vT[d * ldk + i] = round_to<T>(to_f<T>(y[(row0 + i) * F + voff + d]) * inv_n);
      if constexpr (!WIDE) dT[d * ldk + i] = round_to<T>(d_attn[(row0 + i) * hdv + hd * dv + d]);
    }
    __syncthreads();

    // Pass 1: query rows -> d_q and dbias.
    for (int i = warp; i < n; i += kBwdWarps) {
      const float* rp = rel_pos + static_cast<int64_t>(i) * n;
      float* db = dbias + (row0 + i) * n;
      const int nxt = ex[i + 1];
      for (int c0 = 0; c0 < dmax; c0 += kChunk) {
        const bool last = c0 + kChunk >= dmax;
        float qi[kChunk], di[kChunk];
#pragma unroll
        for (int d = 0; d < kChunk; ++d) {
          const int cd = c0 + d;
          if constexpr (WIDE) {
            qi[d] = cd < dqk ? to_f<T>(y[(row0 + i) * F + qoff + cd]) : 0.f;
            di[d] = cd < dv ? round_to<T>(d_attn[(row0 + i) * hdv + hd * dv + cd]) : 0.f;
          } else {
            qi[d] = cd < dqk ? qT[cd * ldk + i] : 0.f;
            di[d] = cd < dv ? dT[cd * ldk + i] : 0.f;
          }
        }
        for (int j = lane; j <= i; j += 32) {
          float s = c0 == 0 ? 0.f : buf0[j], da = c0 == 0 ? 0.f : buf1[j];
#pragma unroll
          for (int d = 0; d < kChunk; ++d) {
            if (c0 + d < dqk) s = fmaf(qi[d], kT[(c0 + d) * ldk + j], s);
            if (c0 + d < dv) da = fmaf(di[d], vT[(c0 + d) * ldk + j], da);
          }
          if (!last) {
            buf0[j] = s;
            buf1[j] = da;
            continue;
          }
          s += (rp[j] + tw[time_bucket(nxt, ex[j], max_bucket)]) + (cm[j] > 0.f ? 0.f : kPenalty);
          if constexpr (ADROP) {
            da *= keep_scale(static_cast<uint32_t>(i * n + j), aseed, adp.thresh, adp.scale);
          }
          float sig, deriv;
          silu_grad(s, sig, deriv);
          const float ds = da * deriv;
          buf0[j] = round_to<T>(ds);
          db[j] = hd == 0 ? ds : db[j] + ds;
        }
      }
      if (hd == 0) {
        for (int j = i + 1 + lane; j < n; j += 32) db[j] = 0.f;
      }
      __syncwarp();
      for (int d = lane; d < dqk; d += 32) {
        float acc = 0.f;
        for (int j = 0; j <= i; ++j) acc = fmaf(buf0[j], kT[d * ldk + j], acc);
        d_y[(row0 + i) * F + qoff + d] = acc;
      }
      __syncwarp();
    }

    if constexpr (WIDE) {
      __syncthreads();   // pass 1's readers of k and v are done
      for (int e = tid; e < n * dqk; e += kBwdThreads) {
        const int i = e / dqk, d = e % dqk;
        qT[d * ldk + i] = to_f<T>(y[(row0 + i) * F + qoff + d]);
      }
      for (int e = tid; e < n * dv; e += kBwdThreads) {
        const int i = e / dv, d = e % dv;
        dT[d * ldk + i] = round_to<T>(d_attn[(row0 + i) * hdv + hd * dv + d]);
      }
      __syncthreads();
    }

    // Pass 2: key columns -> d_k and d_v.
    for (int j = warp; j < n; j += kBwdWarps) {
      float* dyj = d_y + (row0 + j) * F;
      if (!(cm[j] > 0.f)) {   // a padded column: silu'(s - 30000) = 0 and a = 0
        for (int d = lane; d < dqk; d += 32) dyj[koff + d] = 0.f;
        for (int d = lane; d < dv; d += 32) dyj[voff + d] = 0.f;
        continue;
      }
      const int tsj = ex[j];
      for (int c0 = 0; c0 < dmax; c0 += kChunk) {
        const bool last = c0 + kChunk >= dmax;
        float kj[kChunk], vj[kChunk];
#pragma unroll
        for (int d = 0; d < kChunk; ++d) {
          const int cd = c0 + d;
          if constexpr (WIDE) {
            const T* yr = y + (row0 + j) * F;
            kj[d] = cd < dqk ? to_f<T>(yr[koff + cd]) : 0.f;
            vj[d] = cd < dv ? round_to<T>(to_f<T>(yr[voff + cd]) * inv_n) : 0.f;
          } else {
            kj[d] = cd < dqk ? kT[cd * ldk + j] : 0.f;
            vj[d] = cd < dv ? vT[cd * ldk + j] : 0.f;
          }
        }
        for (int i = j + lane; i < n; i += 32) {
          float s = c0 == 0 ? 0.f : buf0[i], da = c0 == 0 ? 0.f : buf1[i];
#pragma unroll
          for (int d = 0; d < kChunk; ++d) {
            if (c0 + d < dqk) s = fmaf(qT[(c0 + d) * ldk + i], kj[d], s);
            if (c0 + d < dv) da = fmaf(dT[(c0 + d) * ldk + i], vj[d], da);
          }
          if (!last) {
            buf0[i] = s;
            buf1[i] = da;
            continue;
          }
          s += rel_pos[static_cast<int64_t>(i) * n + j] + tw[time_bucket(ex[i + 1], tsj, max_bucket)];
          float sig, deriv;
          silu_grad(s, sig, deriv);
          float a = s * sig;
          if constexpr (ADROP) {
            const float keep =
                keep_scale(static_cast<uint32_t>(i * n + j), aseed, adp.thresh, adp.scale);
            da *= keep;
            a *= keep;
          }
          buf0[i] = round_to<T>(da * deriv);
          buf1[i] = round_to<T>(a);
        }
      }
      __syncwarp();
      for (int d = lane; d < dqk; d += 32) {
        float acc = 0.f;
        for (int i = j; i < n; ++i) acc = fmaf(buf0[i], qT[d * ldk + i], acc);
        dyj[koff + d] = acc;
      }
      for (int d = lane; d < dv; d += 32) {
        float acc = 0.f;
        for (int i = j; i < n; ++i) acc = fmaf(buf1[i], dT[d * ldk + i], acc);
        dyj[voff + d] = acc * inv_n;
      }
      __syncwarp();
    }
  }
}

namespace tc {

// K4's train forward, launch 2: the SiLU (or softmax) attention with the
// in-kernel bias or none, the two keep masks of seed0 (odrop on o_input,
// adrop on the attention weights, each a (thresh, scale) as K3 takes it),
// o_input written in bf16 and attn in f32.
cudaError_t launch_tc_train_attn(const bf16* vqk, const float* u, const float* colmask,
                                 const float* rel_pos, const int* ext, const float* tsw,
                                 bf16* oin, float* attn, int B, int n, int H, int dqk, int dv,
                                 float inv_sqrt_dqk, float eps, int max_bucket, int has_bias,
                                 int softmax, int concat_ua, int seed0, int odrop,
                                 uint32_t othresh, float oscale, int adrop, uint32_t athresh,
                                 float ascale, cudaStream_t s) {
  if (!widths_ok(1, H, dqk, dv) || n < 1 || attn == nullptr) return cudaErrorInvalidValue;
  TrainAttnArgs p;
  static_cast<AttnArgs&>(p) =
      AttnArgs{vqk,  u,       colmask,   rel_pos,     ext,    tsw,         nullptr,
               oin,  n,       H,         dqk,         dv,     pad_dqk(dqk), pad_dv(dv),
               has_bias ? kBiasInternal : kBiasNone, 0, concat_ua, 0, max_bucket, eps,
               inv_sqrt_dqk};
  p.attn = attn;
  p.seed0 = seed0;
  p.odrop = odrop;
  p.othresh = othresh;
  p.oscale = oscale;
  p.adrop = adrop;
  p.athresh = athresh;
  p.ascale = ascale;
  return launch_tc_attn_instance<true>(p, B, softmax, s);
}

}  // namespace tc

template <typename T, bool ADROP, bool WIDE>
cudaError_t launch_attn_bwd(const T* y, const float* d_attn, const float* colmask,
                            const float* rel_pos, const int* ext, const float* tsw, float* d_y,
                            float* dbias, int B, int n, int H, int dqk, int dv, float inv_n,
                            int max_bucket, Dropout adp, cudaStream_t s) {
  const size_t smem = attn_bwd_smem_bytes(n, dqk, dv);
  cudaError_t err = allow_smem(hstu_attn_bwd_kernel<T, ADROP, WIDE>, smem);
  if (err != cudaSuccess) return err;
  hstu_attn_bwd_kernel<T, ADROP, WIDE><<<B, kBwdThreads, smem, s>>>(
      y, d_attn, colmask, rel_pos, ext, tsw, d_y, dbias, n, H, dqk, dv, inv_n, max_bucket, adp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t train_bwd(const T* y, const T* d_o, float* attn, bool recompute,
                      const float* colmask, const float* rel_pos, const int* ext,
                      const float* tsw, float* d_attn_scratch, float* d_y, float* dbias, int B,
                      int n, int H, int dqk, int dv, float inv_n, float eps, int max_bucket,
                      TrainVariant v, Dropout adp, cudaStream_t s) {
  if (v.softmax) return cudaErrorInvalidValue;   // rails_hstu_softmax_train_bwd
  const int F = 2 * H * dv + 2 * H * dqk;
  const int64_t M = static_cast<int64_t>(B) * n;
  if (M == 0) return cudaSuccess;
  cudaError_t err;
  if (recompute &&
      (err = train_attn<T, T>(y, colmask, rel_pos, ext, tsw, attn, B, n, H, dqk, dv, inv_n, 1.f,
                              max_bucket, v, adp, s)) != cudaSuccess) {
    return err;
  }
  if ((err = launch_row_bwd<T>(attn, d_o, y, F, d_y, d_attn_scratch, M, H * dv, eps,
                               v.concat_ua != 0, s)) != cudaSuccess) {
    return err;
  }
  const bool wide = attn_bwd_wide(n, dqk, dv);
  if (adp.drop) {
    return wide ? launch_attn_bwd<T, true, true>(y, d_attn_scratch, colmask, rel_pos, ext, tsw,
                                                 d_y, dbias, B, n, H, dqk, dv, inv_n, max_bucket,
                                                 adp, s)
                : launch_attn_bwd<T, true, false>(y, d_attn_scratch, colmask, rel_pos, ext, tsw,
                                                  d_y, dbias, B, n, H, dqk, dv, inv_n, max_bucket,
                                                  adp, s);
  }
  return wide ? launch_attn_bwd<T, false, true>(y, d_attn_scratch, colmask, rel_pos, ext, tsw,
                                                d_y, dbias, B, n, H, dqk, dv, inv_n, max_bucket,
                                                adp, s)
              : launch_attn_bwd<T, false, false>(y, d_attn_scratch, colmask, rel_pos, ext, tsw,
                                                 d_y, dbias, B, n, H, dqk, dv, inv_n, max_bucket,
                                                 adp, s);
}

}  // namespace
}  // namespace rails

// K4 forward. dtype: 0 = float32, 1 = bfloat16 (x, uvqk, o_kernel and out
// share it); y (B*n, F) and attn (B*n, H*dv) f32 outputs the caller allocates
// (the f32 backward keeps attn). The variant: act_none, softmax, concat_ua
// (o_kernel (3*H*dv, D)), has_bias (0: rel_pos, ext and tsw may be null).
// drop = 0 and adrop = 0 run no dropout; otherwise o_input is multiplied by
// the keep mask of seed0 (thresh, scale as `keep_from_idx` computes them) and
// the attention weights by the per-head stream of the same seed (athresh,
// ascale).
extern "C" int rails_hstu_train_fwd(int dtype, const void* x, const float* colmask,
                                    const void* uvqk, const void* o_kernel, const float* o_bias,
                                    const float* rel_pos, const int* ext, const float* tsw,
                                    float* y, float* attn, void* out, int B, int n, int D, int H,
                                    int dqk, int dv, float inv_n, float inv_sqrt_dqk, float eps,
                                    int max_bucket, int act_none, int softmax, int concat_ua,
                                    int has_bias, int drop, int seed0, unsigned thresh,
                                    float scale, int adrop, unsigned athresh, float ascale,
                                    void* stream) {
  const rails::Dropout dp{drop, n, seed0, thresh, scale};
  const rails::Dropout adp{adrop, n, seed0, athresh, ascale};
  const rails::TrainVariant v{act_none, softmax, concat_ua, has_bias};
  auto s = static_cast<cudaStream_t>(stream);
  // The tensor-core route's instances (ops/hstu_block_train.py:tc_fwd_route)
  // run rails_hstu_tc_train_attention between K1's tensor-core stages.
  if (dtype == 1 && !act_none && rails::tc::widths_ok(D, H, dqk, dv)) return cudaErrorInvalidValue;
  // And the f32 ones (tf32_fwd_route) the 3xTF32 kernels of hstu_train_tf32.cu.
  if (dtype == 0 && !act_none && !softmax && rails::tc::tf32_widths_ok(D, H, dqk, dv, n))
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    return rails::launch<__nv_bfloat16>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw,
                                        y, attn, out, B, n, D, H, dqk, dv, inv_n, inv_sqrt_dqk,
                                        eps, max_bucket, v, dp, adp, s);
  }
  if (dtype == 0) {
    return rails::launch<float>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, y, attn,
                                out, B, n, D, H, dqk, dv, inv_n, inv_sqrt_dqk, eps, max_bucket,
                                v, dp, adp, s);
  }
  return cudaErrorInvalidValue;
}

// K4 attention-core backward, pointwise attention. y (B, n, F) = act(LN(x) @
// uvqk) and d_o (B, n, H*dv, or 3*H*dv with concat_ua) = d(o_input) with the
// keep mask applied, both stored in the dtype (0 = float32, 1 = bfloat16).
// attn (B, n, H*dv) f32: with float32 the forward's, read; with bfloat16
// recomputed from y and written first (has_bias picks the recompute's
// instance, the forward's). rel_pos, ext and tsw are always read: zero tables
// without the bias. Outputs: d_y (B, n, F) and dbias (B, n, n) f32 (scratch
// the caller drops without the bias); d_attn_scratch (B, n, H*dv) is scratch.
// adrop: the attention keep mask of seed0 (athresh, ascale).
extern "C" int rails_hstu_train_bwd(int dtype, const void* y, const void* d_o, float* attn,
                                    const float* colmask, const float* rel_pos, const int* ext,
                                    const float* tsw, float* d_attn_scratch, float* d_y,
                                    float* dbias, int B, int n, int H, int dqk, int dv,
                                    float inv_n, float eps, int max_bucket, int act_none,
                                    int concat_ua, int has_bias, int adrop, int seed0,
                                    unsigned athresh, float ascale, void* stream) {
  const rails::Dropout adp{adrop, n, seed0, athresh, ascale};
  const rails::TrainVariant v{act_none, 0, concat_ua, has_bias};
  auto s = static_cast<cudaStream_t>(stream);
  // The tensor-core route's instances (tc_bwd_route) run rails_hstu_tc_train_bwd.
  if (dtype == 1 && !act_none && rails::tc::widths_ok(1, H, dqk, dv)) return cudaErrorInvalidValue;
  // The f32 ones (tf32_bwd_route) run rails_hstu_tf32_bwd.
  if (dtype == 0 && !act_none && rails::tc::tf32_widths_ok(1, H, dqk, dv, n))
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    return rails::train_bwd(static_cast<const __nv_bfloat16*>(y),
                            static_cast<const __nv_bfloat16*>(d_o), attn, true, colmask, rel_pos,
                            ext, tsw, d_attn_scratch, d_y, dbias, B, n, H, dqk, dv, inv_n, eps,
                            max_bucket, v, adp, s);
  }
  if (dtype == 0) {
    return rails::train_bwd(static_cast<const float*>(y), static_cast<const float*>(d_o), attn,
                            false, colmask, rel_pos, ext, tsw, d_attn_scratch, d_y, dbias, B, n,
                            H, dqk, dv, inv_n, eps, max_bucket, v, adp, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_hstu_train_bwd_smem_bytes(int n, int dqk, int dv) {
  return rails::attn_bwd_smem_bytes(n, dqk, dv);
}

// K4's bf16 forward on the tensor cores, launch 2 (between K1's
// rails_hstu_tc_project and rails_hstu_tc_out): the attention over the
// projection's u and vqk with the in-kernel bias (has_bias) or none, the
// attention keep mask (adrop: athresh, ascale) times the weights before their
// rounding, o_input (B*n, H*dv or 3*H*dv) bf16 times its keep mask (odrop:
// othresh, oscale) before its rounding, both of the layer's seed0, and attn
// (B*n, H*dv) f32. Refused outside K1's tensor-core widths.
extern "C" int rails_hstu_tc_train_attention(const void* vqk, const float* u,
                                             const float* colmask, const float* rel_pos,
                                             const int* ext, const float* tsw, void* oin,
                                             float* attn, int B, int n, int H, int dqk, int dv,
                                             float inv_sqrt_dqk, float eps, int max_bucket,
                                             int has_bias, int softmax, int concat_ua, int seed0,
                                             int odrop, unsigned othresh, float oscale, int adrop,
                                             unsigned athresh, float ascale, void* stream) {
  using rails::tc::bf16;
  return rails::tc::launch_tc_train_attn(
      static_cast<const bf16*>(vqk), u, colmask, rel_pos, ext, tsw, static_cast<bf16*>(oin), attn,
      B, n, H, dqk, dv, inv_sqrt_dqk, eps, max_bucket, has_bias, softmax, concat_ua, seed0, odrop,
      othresh, oscale, adrop, athresh, ascale, static_cast<cudaStream_t>(stream));
}

// K4's bf16 pointwise attention-core backward on the tensor cores
// (hstu_train_tc.cuh), one launch a call: stage 0 reads y and d_o and writes
// d_u into d_y, d_attn_out (B*n, H*dv) bf16 and attn (B*n, H*dv) f32; stage 1
// reads y and d_attn and writes d_q into d_y and, unless null, dbias (B, n, n);
// stage 2 reads y and d_attn and writes d_v and d_k into d_y. y (B*n, F) and
// d_o are bf16 as `block_bwd` hands them over; rel_pos, ext and tsw only with
// has_bias; adrop: the attention keep mask of seed0. Refused outside K1's
// tensor-core widths.
extern "C" int rails_hstu_tc_train_bwd(int stage, const void* y, const void* d_o,
                                       const void* d_attn, void* d_attn_out, float* attn,
                                       float* d_y, float* dbias, const float* colmask,
                                       const float* rel_pos, const int* ext, const float* tsw,
                                       int B, int n, int H, int dqk, int dv, float inv_n,
                                       float eps, int max_bucket, int has_bias, int concat_ua,
                                       int adrop, int seed0, unsigned athresh, float ascale,
                                       void* stream) {
  using rails::tc::bf16;
  const rails::tc::BwdArgs p{static_cast<const bf16*>(y), static_cast<const bf16*>(d_o),
                             static_cast<const bf16*>(d_attn), static_cast<bf16*>(d_attn_out),
                             attn, d_y, dbias, colmask, rel_pos, ext, tsw, n, H, dqk, dv,
                             2 * H * dv + 2 * H * dqk, has_bias, concat_ua, max_bucket, inv_n, eps,
                             adrop, seed0, athresh, ascale};
  return rails::tc::launch_tc_bwd(stage, p, B, static_cast<cudaStream_t>(stream));
}

extern "C" size_t rails_hstu_tc_train_bwd_smem_bytes(int stage, int n, int H, int dqk, int dv) {
  return rails::tc::tc_bwd_smem_bytes(stage, n, H, dqk, dv);
}
