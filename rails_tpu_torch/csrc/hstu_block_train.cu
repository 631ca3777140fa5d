// HSTU block training (K4), hand-written for Hopper (sm_90a): the forward
// with o_input dropout, and the attention-core backward.
//
// Replaces `make_fused_train_block` in rails_tpu/ops/pallas/hstu_block_train.py:
// the forward `pallas_call` (`_fwd_kernel`) and the attention-core backward
// `pallas_call` (`_attn_bwd_kernel`, pointwise-SiLU branch). The glue of its
// custom VJP (projection recompute, dWo, dW, dx, the bias-table chain) stays
// in PyTorch, as the JAX package leaves it to XLA.
//
// Forward: K1's three launches (hstu_block.cuh) with the K3 keep mask applied
// in the output GEMM's A-tile loader, instanced for f32 and bf16 operands (x,
// uvqk, o_kernel and the output in bf16; f32 accumulation, o_bias, rel_pos and
// the time table f32; the projection kept f32 in device memory, q, k, v and
// the attention weights rounded to bf16 where `_fwd_kernel` casts to the
// matmul dtype). It leaves attn (B*n, h*dv) f32 in device memory; the f32
// backward keeps it instead of recomputing it.
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
//   (a) attn_row_bwd: one warp per (user, position) row. gln = LN(attn),
//       d_u = d_o * gln, d_gln = d_o * u, d_attn = LN-backward(attn, d_gln)
//       (`_ln_bwd`); d_u goes into d_y, d_attn to a (B*n, h*dv) scratch.
//   (b) hstu_attn_bwd: one block per user, heads in turn. A head's q, k,
//       v/max_seq_len and d_attn (n x 32 each) are staged transposed, with an
//       odd row stride, in shared memory (4 x 32 x 211 x 4 B = 108 KB at
//       n = 211): lanes over positions read consecutive words and lanes over
//       the 32 head dims read words an odd stride apart, so both access
//       patterns are free of bank conflicts. Pass 1 walks query rows, a warp
//       per row, lanes over key columns j <= i: it recomputes s = q_i k_j +
//       bias (rel-pos + time bucket + the -30000 column penalty, built as K1
//       builds it), d_a = d_attn_i . v_j and d_s = d_a * silu'(s), adds d_s
//       into the user's dbias row (head 0 writes it, zeroing j > i), then lanes
//       over dims form d_q_i = sum_j d_s_ij k_j. Pass 2 walks key columns, a
//       warp per column, lanes over rows i >= j, recomputes s and d_s and forms
//       d_k_j = sum_i d_s_ij q_i and d_v_j = sum_i a_ij d_attn_i. Recomputing s
//       and d_a in pass 2 costs 2 of the kernel's 7 products; in exchange no
//       atomics are needed: every output element has one writer, and dbias
//       sums the heads in the JAX kernel's order, so the result is the same
//       on every run.
// Bound: the function needs 5 products of 2 * 32 FLOPs over the causal
// (user, head, i, j) pairs, 7.3 GFLOP per layer at B = 128, n = 211 (0.11 ms
// at the 67 TFLOP/s f32 rate; this kernel does 7, s and d_a twice), against
// ~0.3 GB of traffic (y, d_o, attn, d_y, dbias), 0.09 ms at 3.35 TB/s: the
// FP32 FMA rate of the CUDA cores bounds it. One block per user is 128 blocks
// at B = 128, one wave on 132 SMs. The bf16 instances run the same FMAs on the
// CUDA cores (products of bf16-rounded values, f32 sums) and read half the
// bytes of y and d_o; their bound takes the bf16 tensor-core rate, which a
// wgmma form of the five products would need to approach (later work).
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "hstu_block.cuh"

namespace rails {
namespace {

constexpr int kBwdThreads = 512;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxHeadDim = 32;   // dqk, dv <= 32: one head dim per lane
constexpr float kPenalty = -30000.f;

size_t attn_bwd_smem_bytes(int n, int dqk, int dv) {
  const size_t ldk = static_cast<size_t>(n | 1);
  const size_t floats = (2 * static_cast<size_t>(dqk) + 2 * static_cast<size_t>(dv)) * ldk +
                        static_cast<size_t>(kBwdWarps) * 2 * n + n + 128;
  return floats * sizeof(float) + static_cast<size_t>(n + 1) * sizeof(int);
}

// (a) One warp per row of attn (M = B*n rows of width W = h*dv); d_o and y
// are stored as T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_row_bwd_kernel(const float* __restrict__ attn, const T* __restrict__ d_o,
                    const T* __restrict__ y, int F, float* __restrict__ d_y,
                    float* __restrict__ d_attn, int64_t M, int W, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= M) return;
  const float* a = attn + row * W;
  const T* g = d_o + row * W;
  const T* u = y + row * F;
  float s = 0.f;
  for (int k = lane; k < W; k += 32) s += a[k];
  const float mean = warp_sum(s) / W;
  float v = 0.f;
  for (int k = lane; k < W; k += 32) {
    const float d = a[k] - mean;
    v = fmaf(d, d, v);
  }
  const float inv = rsqrtf(warp_sum(v) / W + eps);
  float sum_dn = 0.f, sum_dn_nh = 0.f;
  for (int k = lane; k < W; k += 32) {
    const float nh = (a[k] - mean) * inv;
    const float gk = to_f<T>(g[k]);
    const float dn = gk * to_f<T>(u[k]);
    d_y[row * F + k] = gk * nh;
    sum_dn += dn;
    sum_dn_nh = fmaf(dn, nh, sum_dn_nh);
  }
  const float mean_dn = warp_sum(sum_dn) / W;
  const float mean_dn_nh = warp_sum(sum_dn_nh) / W;
  for (int k = lane; k < W; k += 32) {
    const float nh = (a[k] - mean) * inv;
    const float dn = to_f<T>(g[k]) * to_f<T>(u[k]);
    d_attn[row * W + k] = inv * (dn - mean_dn - nh * mean_dn_nh);
  }
}

// sigmoid(s) and d silu(s) / d s.
__device__ __forceinline__ void silu_grad(float s, float& sig, float& deriv) {
  sig = 1.f / (1.f + expf(-s));
  deriv = sig * (1.f + s * (1.f - sig));
}

// (b) One block per user; heads in turn. y is stored as T; v, d_attn, the
// attention weights and d_s round to T before each product.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
hstu_attn_bwd_kernel(const T* __restrict__ y, const float* __restrict__ d_attn,
                     const float* __restrict__ colmask, const float* __restrict__ rel_pos,
                     const int* __restrict__ ext, const float* __restrict__ tsw,
                     float* __restrict__ d_y, float* __restrict__ dbias, int n, int H, int dqk,
                     int dv, float inv_n, int max_bucket) {
  extern __shared__ float smem[];
  const int ldk = n | 1;
  float* qT = smem;                              // [dqk][ldk]
  float* kT = qT + dqk * ldk;                    // [dqk][ldk]
  float* vT = kT + dqk * ldk;                    // [dv][ldk]   v / max_seq_len
  float* dT = vT + dv * ldk;                     // [dv][ldk]   d_attn of the head
  float* wb = dT + dv * ldk;                     // [kBwdWarps][2n] per-warp row buffers
  float* cm = wb + kBwdWarps * 2 * n;            // [n]
  float* tw = cm + n;                            // [128]
  int* ex = reinterpret_cast<int*>(tw + 128);    // [n + 1]

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hdv = H * dv;
  const int F = 2 * hdv + 2 * H * dqk;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  for (int j = tid; j < n; j += kBwdThreads) cm[j] = colmask[row0 + j];
  for (int j = tid; j <= n; j += kBwdThreads) ex[j] = ext[static_cast<int64_t>(b) * (n + 1) + j];
  for (int t = tid; t < 128; t += kBwdThreads) tw[t] = tsw[t];
  float* buf0 = wb + warp * 2 * n;
  float* buf1 = buf0 + n;

  for (int hd = 0; hd < H; ++hd) {
    const int voff = hdv + hd * dv;
    const int qoff = 2 * hdv + hd * dqk;
    const int koff = 2 * hdv + H * dqk + hd * dqk;
    __syncthreads();   // the previous head's readers are done
    for (int e = tid; e < n * dqk; e += kBwdThreads) {
      const int i = e / dqk, d = e % dqk;
      const T* yr = y + (row0 + i) * F;
      qT[d * ldk + i] = to_f<T>(yr[qoff + d]);
      kT[d * ldk + i] = to_f<T>(yr[koff + d]);
    }
    for (int e = tid; e < n * dv; e += kBwdThreads) {
      const int i = e / dv, d = e % dv;
      vT[d * ldk + i] = round_to<T>(to_f<T>(y[(row0 + i) * F + voff + d]) * inv_n);
      dT[d * ldk + i] = round_to<T>(d_attn[(row0 + i) * hdv + hd * dv + d]);
    }
    __syncthreads();

    // Pass 1: query rows -> d_q and dbias.
    for (int i = warp; i < n; i += kBwdWarps) {
      float qi[kMaxHeadDim], di[kMaxHeadDim];
#pragma unroll
      for (int d = 0; d < kMaxHeadDim; ++d) {
        qi[d] = d < dqk ? qT[d * ldk + i] : 0.f;
        di[d] = d < dv ? dT[d * ldk + i] : 0.f;
      }
      const float* rp = rel_pos + static_cast<int64_t>(i) * n;
      float* db = dbias + (row0 + i) * n;
      const int nxt = ex[i + 1];
      for (int j = lane; j <= i; j += 32) {
        float s = 0.f, da = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxHeadDim; ++d) {
          if (d < dqk) s = fmaf(qi[d], kT[d * ldk + j], s);
          if (d < dv) da = fmaf(di[d], vT[d * ldk + j], da);
        }
        s += (rp[j] + tw[time_bucket(nxt, ex[j], max_bucket)]) + (cm[j] > 0.f ? 0.f : kPenalty);
        float sig, deriv;
        silu_grad(s, sig, deriv);
        const float ds = da * deriv;
        buf0[j] = round_to<T>(ds);
        db[j] = hd == 0 ? ds : db[j] + ds;
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

    // Pass 2: key columns -> d_k and d_v.
    for (int j = warp; j < n; j += kBwdWarps) {
      float* dyj = d_y + (row0 + j) * F;
      if (!(cm[j] > 0.f)) {   // a padded column: silu'(s - 30000) = 0 and a = 0
        for (int d = lane; d < dqk; d += 32) dyj[koff + d] = 0.f;
        for (int d = lane; d < dv; d += 32) dyj[voff + d] = 0.f;
        continue;
      }
      float kj[kMaxHeadDim], vj[kMaxHeadDim];
#pragma unroll
      for (int d = 0; d < kMaxHeadDim; ++d) {
        kj[d] = d < dqk ? kT[d * ldk + j] : 0.f;
        vj[d] = d < dv ? vT[d * ldk + j] : 0.f;
      }
      const int tsj = ex[j];
      for (int i = j + lane; i < n; i += 32) {
        float s = 0.f, da = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxHeadDim; ++d) {
          if (d < dqk) s = fmaf(qT[d * ldk + i], kj[d], s);
          if (d < dv) da = fmaf(dT[d * ldk + i], vj[d], da);
        }
        s += rel_pos[static_cast<int64_t>(i) * n + j] + tw[time_bucket(ex[i + 1], tsj, max_bucket)];
        float sig, deriv;
        silu_grad(s, sig, deriv);
        buf0[i] = round_to<T>(da * deriv);
        buf1[i] = round_to<T>(s * sig);
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

template <typename T>
cudaError_t train_bwd(const T* y, const T* d_o, float* attn, bool recompute,
                      const float* colmask, const float* rel_pos, const int* ext,
                      const float* tsw, float* d_attn_scratch, float* d_y, float* dbias, int B,
                      int n, int H, int dqk, int dv, float inv_n, float eps, int max_bucket,
                      cudaStream_t s) {
  if (dqk > kMaxHeadDim || dv > kMaxHeadDim) return cudaErrorInvalidValue;
  const int F = 2 * H * dv + 2 * H * dqk;
  const int64_t M = static_cast<int64_t>(B) * n;
  if (M == 0) return cudaSuccess;
  cudaError_t err;
  if (recompute) {
    const size_t smem = attn_smem_bytes(n, dqk, dv);
    if ((err = allow_smem(hstu_attn_kernel<T, T>, smem)) != cudaSuccess) return err;
    hstu_attn_kernel<T, T><<<dim3(H, B), kThreads, smem, s>>>(
        y, colmask, rel_pos, ext, tsw, attn, n, H, dqk, dv, inv_n, max_bucket, nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  attn_row_bwd_kernel<T><<<static_cast<unsigned>((M + kWarps - 1) / kWarps), kThreads, 0, s>>>(
      attn, d_o, y, F, d_y, d_attn_scratch, M, H * dv, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem = attn_bwd_smem_bytes(n, dqk, dv);
  if ((err = allow_smem(hstu_attn_bwd_kernel<T>, smem)) != cudaSuccess) return err;
  hstu_attn_bwd_kernel<T><<<B, kBwdThreads, smem, s>>>(
      y, d_attn_scratch, colmask, rel_pos, ext, tsw, d_y, dbias, n, H, dqk, dv, inv_n,
      max_bucket);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rails

// K4 forward. dtype: 0 = float32, 1 = bfloat16 (x, uvqk, o_kernel and out
// share it); y (B*n, F) and attn (B*n, H*dv) f32 outputs the caller allocates
// (the f32 backward keeps attn). drop = 0 runs K1's kernels exactly;
// otherwise u * LN(attn) is multiplied by the keep mask of seed0 (thresh,
// scale as `keep_from_idx` computes them).
extern "C" int rails_hstu_train_fwd(int dtype, const void* x, const float* colmask,
                                    const void* uvqk, const void* o_kernel, const float* o_bias,
                                    const float* rel_pos, const int* ext, const float* tsw,
                                    float* y, float* attn, void* out, int B, int n, int D, int H,
                                    int dqk, int dv, float inv_n, float eps, int max_bucket,
                                    int drop, int seed0, unsigned thresh, float scale,
                                    void* stream) {
  const rails::Dropout dp{drop, n, seed0, thresh, scale};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::launch<__nv_bfloat16>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw,
                                        y, attn, out, B, n, D, H, dqk, dv, inv_n, eps,
                                        max_bucket, dp, s);
  }
  if (dtype == 0) {
    return rails::launch<float>(x, colmask, uvqk, o_kernel, o_bias, rel_pos, ext, tsw, y, attn,
                                out, B, n, D, H, dqk, dv, inv_n, eps, max_bucket, dp, s);
  }
  return cudaErrorInvalidValue;
}

// K4 attention-core backward. y (B, n, F) = silu(LN(x) @ uvqk) and d_o
// (B, n, H*dv) = d(o_input) with the keep mask applied, both stored in the
// dtype (0 = float32, 1 = bfloat16). attn (B, n, H*dv) f32: with float32 the
// forward's, read; with bfloat16 recomputed from y and written first. Outputs:
// d_y (B, n, F) and dbias (B, n, n) f32; d_attn_scratch (B, n, H*dv) is
// scratch.
extern "C" int rails_hstu_train_bwd(int dtype, const void* y, const void* d_o, float* attn,
                                    const float* colmask, const float* rel_pos, const int* ext,
                                    const float* tsw, float* d_attn_scratch, float* d_y,
                                    float* dbias, int B, int n, int H, int dqk, int dv,
                                    float inv_n, float eps, int max_bucket, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return rails::train_bwd(static_cast<const __nv_bfloat16*>(y),
                            static_cast<const __nv_bfloat16*>(d_o), attn, true, colmask, rel_pos,
                            ext, tsw, d_attn_scratch, d_y, dbias, B, n, H, dqk, dv, inv_n, eps,
                            max_bucket, s);
  }
  if (dtype == 0) {
    return rails::train_bwd(static_cast<const float*>(y), static_cast<const float*>(d_o), attn,
                            false, colmask, rel_pos, ext, tsw, d_attn_scratch, d_y, dbias, B, n,
                            H, dqk, dv, inv_n, eps, max_bucket, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" size_t rails_hstu_train_bwd_smem_bytes(int n, int dqk, int dv) {
  return rails::attn_bwd_smem_bytes(n, dqk, dv);
}
