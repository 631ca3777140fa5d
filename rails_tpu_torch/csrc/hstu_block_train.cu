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
//   (b) hstu_attn_bwd_rows_kernel, then hstu_attn_bwd_cols_kernel: 256-thread
//       blocks over (user, 64-row tile) and (user, 64-column tile), two a
//       SM (ceil(n / 64) tiles a user: 512 blocks a launch at B = 128, n =
//       211; the rows with the most chunks start first). Every output
//       element has one writer and one fmaf chain in the order of the first
//       design (one block per user, a warp per row), so the bits are that
//       design's: only the schedule changed. Pass 1 (rows) walks the column
//       chunks of 64 up to the diagonal, pass 2 (columns) the row chunks from
//       the diagonal to n. In each chunk the block computes the
//       head-independent bias of its 64 x 64 pairs once (pass 1: (rel-pos +
//       time bucket) + the -30000 column penalty; pass 2: rel-pos + time
//       bucket, with no + 0 that would turn a -0 into +0), then takes the
//       heads in order. A head's operands arrive in rounds of 32 dims: q and
//       d_attn of the chunk's rows, k and v of its columns, copied
//       asynchronously (cp.async) one round ahead into a landing area, then
//       converted (v / max_seq_len and d_attn rounded to T) into row-major
//       tiles whose rows lie an odd number of quads apart. Each thread forms
//       s = q_i . k_j and d_a = d_attn_i . v_j for 4 rows x 4 columns from
//       float4 loads (8 FMAs a load), recomputes silu'(s) [and the keep mask
//       of `attn_seed`] and writes d_s (and, in pass 2, a) rounded into a 64
//       x 64 tile. Pass 1 sums d_s over the heads in registers (head 0's
//       value, then + d_s per head, the first design's adds), writes dbias
//       once a chunk (zeros right of the diagonal) and continues d_q_i =
//       sum_{j <= i} d_s_ij k_j (a thread 2 rows x 4 dims); pass 2 continues
//       d_k_j = sum_{i >= j} d_s_ij q_i on four warps and d_v_j = sum_i a_ij
//       d_attn_i on the other four (a thread 4 columns x 4 dims) and scales
//       d_v by 1 / max_seq_len after the last chunk. A partial sum waits in
//       d_y between chunks (the same thread reads it back), and a head wider
//       than a round continues its chains from round to round: both give the
//       bits of one uninterrupted chain. Causal and length predicates skip
//       terms; no zero operand is ever fed to a chain. Padded key columns
//       (silu'(s - 30000) = 0, a = 0) get zeros in pass 2 but enter pass 1's
//       d_q and dbias as the first design entered them. Shared memory does
//       not grow with n (at most 109 KB, from 32 dims), so every length the
//       first design took still fits. Recomputing s and d_a in pass 2 costs 2
//       of the kernels' 7 products; in exchange no atomics are needed and the
//       result is the same on every run. Without the relative-attention bias
//       the caller passes zero tables and drops dbias: s = q_i k_j + (0 + 0)
//       + penalty in pass 1 and q_i k_j + 0 in pass 2, bit for bit the
//       no-bias s, so one instance serves both.
// Bound: the function needs 5 products of 2 * 32 FLOPs over the causal
// (user, head, i, j) pairs, 7.3 GFLOP per layer at B = 128, n = 211 (0.11 ms
// at the 67 TFLOP/s f32 rate; these kernels do 7, s and d_a twice), against
// ~0.3 GB of traffic (y, d_o, attn, d_y, dbias), 0.09 ms at 3.35 TB/s: the
// FP32 FMA rate of the CUDA cores bounds it, and the bits keep it there
// (the tensor cores would sum in another order). Beside the FMAs each pair
// and head spends an exp and an IEEE divide in each pass, which the design
// cannot share. The bf16 instances here run the same FMAs on the CUDA cores
// (products of bf16-rounded values, f32 sums) and read half the bytes of y
// and d_o. Which instances reach it: linear_activation="none" in both
// dtypes, head widths off K1's tensor-core widths (dqk or dv > 32, other
// head counts), f32 past n = 512, each with or without attention dropout.
// At K1's widths with the SiLU projection the bf16 block runs on the tensor
// cores instead: the forward through hstu_block_tc.cuh
// (rails_hstu_tc_train_attention between K1's projection and output GEMM),
// the pointwise backward through hstu_train_tc.cuh (rails_hstu_tc_train_bwd);
// the entry points below refuse those instances, and the f32 ones at those
// widths with n <= 512, the SiLU projection and the pointwise attention,
// which run 3xTF32 on the tensor cores (hstu_train_tf32.cu).
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hash_dropout.cuh"
#include "hstu_block.cuh"
#include "hstu_block_tc.cuh"
#include "hstu_train.cuh"
#include "hstu_train_tc.cuh"

namespace rails {
namespace {

constexpr int kBwdThreads = 256;
constexpr int kBT = 64;          // a block's rows (pass 1) or columns (pass 2); the chunk of the other
constexpr int kDC = 32;          // head dims staged at a time (a round)
constexpr int kLdP = kBT + 4;    // row stride of the d_s and a tiles: 17 quads

// Row stride of a staged operand of `dims` head dims (kDC at most a round):
// whole quads, an odd count of them, so that eight consecutive rows read as
// float4 fall on distinct banks.
__host__ __device__ inline int bwd_ld(int dims) {
  return 4 * (((min(dims, kDC) + 3) / 4) | 1);
}

// q and k of the pair tile's rows and columns and d_attn and v of them, each
// twice (as it arrives and converted), the d_s and a tiles, and the
// time-bucket weights: independent of n.
size_t attn_bwd_smem_bytes(int /*n*/, int dqk, int dv) {
  const size_t floats =
      static_cast<size_t>(kBT) * (4 * bwd_ld(dqk) + 4 * bwd_ld(dv) + 2 * kLdP) + 128;
  return floats * sizeof(float);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// An asynchronous copy of `bytes` (16 or 8) from device to shared memory, of
// which the first `valid` are read and the rest filled with zeros.
__device__ __forceinline__ void bwd_cp_async(void* dst, const void* src, int bytes, int valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(valid)
                 : "memory");
  }
}

__device__ __forceinline__ void bwd_cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void bwd_cp_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Whether a staged operand's rows are copied four elements at a time: its
// start and row stride fall on whole quads.
template <typename E>
__device__ __forceinline__ bool quad_aligned(const E* src, int64_t lds) {
  return ((reinterpret_cast<uintptr_t>(src) | static_cast<uintptr_t>(lds * sizeof(E))) &
          (4 * sizeof(E) - 1)) == 0;
}

// Starts copying rows [0, rows) x elements [0, cnt) of src (row stride lds)
// into `raw` (row stride ld): as they are stored, four at a time where
// quad_aligned, else converted to float by plain loads. A thread takes the
// quads u = tid + m * kBwdThreads of the kBT x 8 (row, quad) grid, the ones it
// converts later (convert_rows).
template <typename E>
__device__ __forceinline__ void issue_rows(float* raw, int ld, const E* src, int64_t lds, int rows,
                                           int cnt) {
  const bool vec = quad_aligned(src, lds);
#pragma unroll
  for (int m = 0; m < kBT * (kDC / 4) / kBwdThreads; ++m) {
    const int u = threadIdx.x + m * kBwdThreads, r = u >> 3, c = 4 * (u & 7);
    if (r >= rows || c >= cnt) continue;
    const E* s = src + r * lds + c;
    if (vec) {
      bwd_cp_async(reinterpret_cast<E*>(raw) + r * ld + c, s, 4 * sizeof(E),
                   min(cnt - c, 4) * static_cast<int>(sizeof(E)));
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c + e < cnt ? to_f<E>(s[e]) : 0.f;
      *reinterpret_cast<float4*>(raw + r * ld + c) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// dst[r][0, cnt) = conv(the copied element) for the kBT rows r, zeros at rows
// >= rows and in the quad past cnt: the quads this thread copied.
template <typename E, typename Conv>
__device__ __forceinline__ void convert_rows(float* dst, const float* raw, int ld, const E* src,
                                             int64_t lds, int rows, int cnt, Conv conv) {
  const bool vec = quad_aligned(src, lds);
#pragma unroll
  for (int m = 0; m < kBT * (kDC / 4) / kBwdThreads; ++m) {
    const int u = threadIdx.x + m * kBwdThreads, r = u >> 3, c = 4 * (u & 7);
    if (c >= cnt) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) {
      if (!vec || sizeof(E) == 4) {
        const float4 x = ld4(raw + r * ld + c);
        v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
      } else {   // bf16: a value's bits are the high half of its float's
        const uint2 x = *reinterpret_cast<const uint2*>(reinterpret_cast<const E*>(raw) + r * ld + c);
        v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xffff0000u);
        v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xffff0000u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = c + e < cnt ? v[e] : 0.f;
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        make_float4(conv(v[0]), conv(v[1]), conv(v[2]), conv(v[3]));
  }
}

// acc[r][c] = sum over d < cnt of a[ar[r] + d] * b[(bc + c) * ld + d], each a
// fmaf chain in d order continuing from acc.
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, const int (&ar)[4],
                                         const float* b, int ld, int cnt) {
  const int full = cnt & ~3;
  for (int d = 0; d < full; d += 4) {
    float4 x[4], w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(a + ar[r] + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = ld4(b + c * ld + d);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(comp(x[r], k), comp(w[c], k), acc[r][c]);
      }
    }
  }
  for (int d = full; d < cnt; ++d) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[ar[r] + d], b[c * ld + d], acc[r][c]);
    }
  }
}

// The arguments of one launch.
template <typename T>
struct BwdParams {
  const T* y;
  const float* d_attn;
  const float* colmask;
  const float* rel_pos;
  const int* ext;
  const float* tsw;
  float* d_y;
  float* dbias;
  int n, H, dqk, dv;
  float inv_n;
  int max_bucket;
  Dropout adp;
};

// One block's shared memory.
struct BwdSmem {
  float* qs;   // [kBT][ldq] q of the pair tile's rows (query positions)
  float* ks;   // [kBT][ldq] k of its columns (key positions)
  float* as;   // [kBT][ldv] d_attn of its rows, rounded to T
  float* vs;   // [kBT][ldv] v / max_seq_len of its columns, rounded to T
  float* raw;  // the next round of the four as they arrive, in the same places
  float* dsm;  // [kBT][kLdP] d_s of its pairs, rounded to T
  float* am;   // [kBT][kLdP] pass 2: the attention weights of its pairs, rounded to T;
               // pass 1: the bias of its pairs
  float* tw;   // [128] the time-bucket weights
  int ldq, ldv;
};

enum : int { kQ = 1, kK = 2, kA = 4, kV = 8 };

// A round of staged operands: dims [d0, d0 + kDC) of head hd's q and d_attn
// for the rows [i0, i0 + kBT) and of its k and v for the columns [j0, j0 +
// kBT), of the arrays in `mask`.
struct Item {
  int hd, i0, j0, d0, mask;
};

// Calls fn(dst, raw, ld, src, row stride, rows, cnt, conversion) for each
// array of the item, in the order q, k, d_attn, v.
template <typename T, typename Fn>
__device__ __forceinline__ void for_arrays(const BwdParams<T>& p, const BwdSmem& sm, int b,
                                           const Item& it, Fn fn) {
  const int n = p.n, hdv = p.H * p.dv, F = 2 * hdv + 2 * p.H * p.dqk;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  const int rows_i = min(kBT, n - it.i0), rows_j = min(kBT, n - it.j0);
  const int cq = min(kDC, p.dqk - it.d0), cv = min(kDC, p.dv - it.d0);
  const int64_t off_q = kBT * sm.ldq, off_v = kBT * sm.ldv;
  const float inv_n = p.inv_n;
  auto same = [](float v) { return v; };
  auto round_a = [](float v) { return round_to<T>(v); };
  auto round_v = [inv_n](float v) { return round_to<T>(v * inv_n); };
  if (it.mask & kQ) {
    fn(sm.qs, sm.raw, sm.ldq, p.y + (row0 + it.i0) * F + 2 * hdv + it.hd * p.dqk + it.d0,
       static_cast<int64_t>(F), rows_i, cq, same);
  }
  if (it.mask & kK) {
    fn(sm.ks, sm.raw + off_q, sm.ldq,
       p.y + (row0 + it.j0) * F + 2 * hdv + p.H * p.dqk + it.hd * p.dqk + it.d0,
       static_cast<int64_t>(F), rows_j, cq, same);
  }
  if (it.mask & kA) {
    fn(sm.as, sm.raw + 2 * off_q, sm.ldv, p.d_attn + (row0 + it.i0) * hdv + it.hd * p.dv + it.d0,
       static_cast<int64_t>(hdv), rows_i, cv, round_a);
  }
  if (it.mask & kV) {
    fn(sm.vs, sm.raw + 2 * off_q + off_v, sm.ldv,
       p.y + (row0 + it.j0) * F + hdv + it.hd * p.dv + it.d0, static_cast<int64_t>(F), rows_j,
       cv, round_v);
  }
}

// The ring of one pass: a step (a head of a chunk) stages its operands in
// rounds, the products' rounds k < R over the operands they read, then the
// second product's rounds R .. K - 1 over dims [0, (K - R) * kDC) (its dims
// [(R - 1) * kDC, ..) are what the products' last round left): pass 1's k,
// pass 2's q and d_attn. The round in flight converts into the staged
// operands once their readers are done, and the next round's copies start at
// once, to land while the block computes.
template <bool PASS1, typename T>
struct Ring {
  const BwdParams<T>& p;
  const BwdSmem& sm;
  int b, tile, last_chunk, R, K;

  __device__ Ring(const BwdParams<T>& p_, const BwdSmem& sm_, int b_, int tile_, int last)
      : p(p_), sm(sm_), b(b_), tile(tile_), last_chunk(last) {
    R = (max(p.dqk, p.dv) + kDC - 1) / kDC;
    K = R + (PASS1 ? min(R - 1, (p.dqk + kDC - 1) / kDC) : R - 1);
  }

  __device__ Item item(int c, int hd, int k) const {
    Item it;
    it.hd = hd;
    it.i0 = (PASS1 ? tile : c) * kBT;
    it.j0 = (PASS1 ? c : tile) * kBT;
    it.d0 = (k < R ? k : k - R) * kDC;
    if (k < R) {
      it.mask = (it.d0 < p.dqk ? kQ | kK : 0) | (it.d0 < p.dv ? kA | kV : 0);
    } else {
      it.mask = PASS1 ? kK : (it.d0 < p.dqk ? kQ : 0) | (it.d0 < p.dv ? kA : 0);
    }
    return it;
  }

  __device__ void issue(int c, int hd, int k) const {
    for_arrays<T>(p, sm, b, item(c, hd, k),
                  [](float*, float* raw, int ld, const auto* src, int64_t lds, int rows, int cnt,
                     auto) { issue_rows(raw, ld, src, lds, rows, cnt); });
    bwd_cp_commit();
  }

  // Round k of step (c, hd): wait for it, convert it once the staged
  // operands' readers are done, start the next round.
  __device__ void stage(int c, int hd, int k) const {
    __syncthreads();
    bwd_cp_wait();
    for_arrays<T>(p, sm, b, item(c, hd, k),
                  [](float* dst, float* raw, int ld, const auto* src, int64_t lds, int rows,
                     int cnt, auto conv) { convert_rows(dst, raw, ld, src, lds, rows, cnt, conv); });
    __syncthreads();   // a thread's next copies may land on quads another one converted
    if (++k == K) {
      k = 0;
      if (++hd == p.H) {
        hd = 0;
        ++c;
      }
    }
    if (c <= last_chunk) issue(c, hd, k);
  }
};

// The bias of the thread's pairs (rows i0 + pr, columns j0 + pc0 + c),
// shared by every head: pass 1's (rel_pos + tsw[bucket]) + the column's
// penalty, pass 2's rel_pos + tsw[bucket] (no penalty term, whose + 0 would
// turn a -0 into +0), each as the per-pair code of the first design adds it.
template <bool PASS1, typename T>
__device__ __forceinline__ void pair_bias(const BwdParams<T>& p, const BwdSmem& sm, int b, int i0,
                                          int j0, const int (&pr)[4], int pc0,
                                          float (&bias)[4][4]) {
  const int n = p.n;
  const int* ex = p.ext + static_cast<int64_t>(b) * (n + 1);
  const float* cm = p.colmask + static_cast<int64_t>(b) * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + pr[r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + pc0 + c;
      bias[r][c] = 0.f;
      if (i < n && j < n) {
        const float rt = p.rel_pos[static_cast<int64_t>(i) * n + j] +
                         sm.tw[time_bucket(ex[i + 1], ex[j], p.max_bucket)];
        bias[r][c] = PASS1 ? rt + (cm[j] > 0.f ? 0.f : kPenalty) : rt;
      }
    }
  }
}

// s = q_i . k_j and da = d_attn_i . v_j over the head's dims for the
// thread's 4 x 4 pairs (rows pr, columns pc0 + c of the tile), round by
// round; `active` warps compute, every thread stages.
template <bool PASS1, typename T>
__device__ __forceinline__ void pair_products(const Ring<PASS1, T>& ring, int c, int hd,
                                              bool active, const int (&pr)[4], int pc0,
                                              float (&s)[4][4], float (&da)[4][4]) {
  const BwdParams<T>& p = ring.p;
  const BwdSmem& sm = ring.sm;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s[r][cc] = da[r][cc] = 0.f;
  }
  for (int k = 0; k < ring.R; ++k) {
    ring.stage(c, hd, k);
    if (!active) continue;
    const int d0 = k * kDC;
    if (d0 < p.dqk) {
      const int aq[4] = {pr[0] * sm.ldq, pr[1] * sm.ldq, pr[2] * sm.ldq, pr[3] * sm.ldq};
      tile_dot(s, sm.qs, aq, sm.ks + pc0 * sm.ldq, sm.ldq, min(kDC, p.dqk - d0));
    }
    if (d0 < p.dv) {
      const int av[4] = {pr[0] * sm.ldv, pr[1] * sm.ldv, pr[2] * sm.ldv, pr[3] * sm.ldv};
      tile_dot(da, sm.as, av, sm.vs + pc0 * sm.ldv, sm.ldv, min(kDC, p.dv - d0));
    }
  }
}

// Pass 1: the rows [i0, i0 + kBT) of user b -> d_q and dbias. Column chunks
// in order up to the diagonal; in each, the bias once, then every head in
// order: s and d_a, d_s (rounded into the tile), dbias summed in registers
// in head order, and d_q's partial sums over the chunk continued in d_y.
template <typename T, bool ADROP>
__device__ __forceinline__ void bwd_rows(const BwdParams<T>& p, const BwdSmem& sm, int b,
                                         int tile) {
  const int n = p.n, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hdv = p.H * p.dv, F = 2 * hdv + 2 * p.H * p.dqk;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  const int i0 = tile * kBT;
  // The pair tile: warps 2 (rows) x 4 (columns) of 32 x 16 pairs; a lane 4
  // rows eight apart by 4 adjacent columns.
  const int wr = warp & 1, wc = warp >> 1;
  const int pr[4] = {32 * wr + (lane & 7), 32 * wr + (lane & 7) + 8, 32 * wr + (lane & 7) + 16,
                     32 * wr + (lane & 7) + 24};
  const int pc0 = 16 * wc + 4 * (lane >> 3);
  const bool rows_live = i0 + 32 * wr < n;
  // d_q: a thread 2 rows 32 apart by 4 dims of the round.
  const int qr[2] = {tid >> 3, (tid >> 3) + 32}, qe0 = 4 * (tid & 7);
  const Ring<true, T> ring(p, sm, b, tile, tile);
  ring.issue(0, 0, 0);
  float dbacc[4][4];
  for (int c = 0; c <= tile; ++c) {
    const int j0 = c * kBT;
    const bool diag = c == tile;
    // A warp whose pairs all lie right of the diagonal or below the last row.
    const bool active = rows_live && !(diag && 16 * wc > 32 * wr + 31);
    {   // the chunk's bias waits in the tile: the thread reads back its own pairs
      float bias[4][4];
      pair_bias<true>(p, sm, b, i0, j0, pr, pc0, bias);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        *reinterpret_cast<float4*>(sm.am + pr[r] * kLdP + pc0) =
            make_float4(bias[r][0], bias[r][1], bias[r][2], bias[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) dbacc[r][cc] = 0.f;
    }
    for (int hd = 0; hd < p.H; ++hd) {
      const uint32_t aseed = ADROP ? attn_seed(p.adp.seed0, b, hd) : 0u;
      float s[4][4], da[4][4];
      pair_products<true, T>(ring, c, hd, active, pr, pc0, s, da);
      if (active) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + pr[r];
          const float4 bv = ld4(sm.am + pr[r] * kLdP + pc0);
          float o[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = j0 + pc0 + cc;
            const float sv = s[r][cc] + comp(bv, cc);
            float dav = da[r][cc];
            if constexpr (ADROP) {
              dav *= keep_scale(static_cast<uint32_t>(i * n + j), aseed, p.adp.thresh,
                                p.adp.scale);
            }
            float sig, deriv;
            silu_grad(sv, sig, deriv);
            const float ds = dav * deriv;
            o[cc] = round_to<T>(ds);
            // The first design's db[j] + ds, which the compiler did not fuse
            // with ds's product: the [K1-hash] lines tell the two apart.
            dbacc[r][cc] = hd == 0 ? ds : __fadd_rn(dbacc[r][cc], ds);
          }
          *reinterpret_cast<float4*>(sm.dsm + pr[r] * kLdP + pc0) = make_float4(o[0], o[1], o[2], o[3]);
        }
      }
      // d_q_i += sum over the chunk's j <= i of d_s_ij k_j, in j order: first
      // the round the products left staged, then the others.
      const int qoff = 2 * hdv + hd * p.dqk;
      for (int q = 0; q <= ring.K - ring.R; ++q) {
        const int e0 = (q == 0 ? ring.R - 1 : q - 1) * kDC;
        if (e0 >= p.dqk) continue;
        const int cnt = min(kDC, p.dqk - e0);
        const bool live = i0 + qr[0] < n && qe0 < cnt;
        // The partial sums of the chunk before, read back by the thread that wrote them.
        float acc[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + qr[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][e] = 0.f;
            if (live && c > 0 && i < n && qe0 + e < cnt)
              acc[r][e] = p.d_y[(row0 + i) * F + qoff + e0 + qe0 + e];
          }
        }
        if (q == 0) {
          __syncthreads();   // d_s is in the tile
        } else {
          ring.stage(c, hd, ring.R + q - 1);   // k's dims [e0, e0 + kDC)
        }
        if (!live) continue;
        // Off the diagonal every j of the chunk, without predicates; on it
        // j <= i, up to the thread's second row.
        auto sum = [&](auto on_diag) {
          constexpr bool kDiag = decltype(on_diag)::value;
          for (int jq = 0; jq < (kDiag ? (qr[1] & ~3) + 4 : kBT); jq += 4) {
            float4 x[2], w[4];
#pragma unroll
            for (int r = 0; r < 2; ++r) x[r] = ld4(sm.dsm + qr[r] * kLdP + jq);
#pragma unroll
            for (int k = 0; k < 4; ++k) w[k] = ld4(sm.ks + (jq + k) * sm.ldq + qe0);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                if (kDiag && jq + k > qr[r]) continue;
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(comp(x[r], k), comp(w[k], e), acc[r][e]);
              }
            }
          }
        };
        if (diag) {
          sum(std::true_type{});
        } else {
          sum(std::false_type{});
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + qr[r];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (i < n && qe0 + e < cnt) p.d_y[(row0 + i) * F + qoff + e0 + qe0 + e] = acc[r][e];
          }
        }
      }
    }
    // dbias of the chunk, once: the head sum at j <= i, zeros right of the diagonal.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + pr[r];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + pc0 + cc;
        if (i < n && j < n) p.dbias[(row0 + i) * n + j] = j <= i ? dbacc[r][cc] : 0.f;
      }
    }
  }
  // The columns past the diagonal chunk.
  const int rows = min(kBT, n - i0), c_lo = i0 + kBT, width = n - c_lo;
  for (int e = tid; width > 0 && e < rows * width; e += kBwdThreads) {
    const int r = e / width;
    p.dbias[(row0 + i0 + r) * n + c_lo + (e - r * width)] = 0.f;
  }
}

// Pass 2: the key columns [j0, j0 + kBT) of user b -> d_k and d_v. Row
// chunks in order from the diagonal; in each, the bias once, then every head
// in order: s and d_a, d_s and a (rounded into the tiles), and the partial
// sums of d_k_j = sum_i d_s_ij q_i and d_v_j = sum_i a_ij d_attn_i continued
// in d_y; d_v is scaled by 1 / max_seq_len after the last chunk. Padded
// columns (silu'(s - 30000) = 0 and a = 0) write zeros.
template <typename T, bool ADROP>
__device__ __forceinline__ void bwd_cols(const BwdParams<T>& p, const BwdSmem& sm, int b,
                                         int tile) {
  const int n = p.n, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hdv = p.H * p.dv, F = 2 * hdv + 2 * p.H * p.dqk;
  const int64_t row0 = static_cast<int64_t>(b) * n;
  const float* cm = p.colmask + row0;
  const int j0 = tile * kBT, chunks = (n + kBT - 1) / kBT;
  const int wr = warp & 1, wc = warp >> 1;
  const int pr[4] = {32 * wr + (lane & 7), 32 * wr + (lane & 7) + 8, 32 * wr + (lane & 7) + 16,
                     32 * wr + (lane & 7) + 24};
  const int pc0 = 16 * wc + 4 * (lane >> 3);
  bool live = false;   // a column of the lane's pairs that is < n and not padded
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) live |= j0 + pc0 + cc < n && cm[j0 + pc0 + cc] > 0.f;
  const bool cols_live = __any_sync(0xffffffffu, live);
  // d_k on warps 0-3, d_v on warps 4-7: a thread 4 adjacent columns by 4 dims
  // of the round.
  const bool g_v = warp >= 4;
  const int oc0 = 4 * ((tid & 127) >> 3), pe0 = 4 * (tid & 7);
  bool ok[4];
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) ok[cc] = j0 + oc0 + cc < n && cm[j0 + oc0 + cc] > 0.f;
  const bool out_live = __any_sync(0xffffffffu, ok[0] || ok[1] || ok[2] || ok[3]);
  const float* xs = g_v ? sm.am : sm.dsm;   // the weights of the sum: a or d_s
  const float* ws = g_v ? sm.as : sm.qs;    // its vectors: d_attn or q
  const int ldw = g_v ? sm.ldv : sm.ldq, dims = g_v ? p.dv : p.dqk;
  const Ring<false, T> ring(p, sm, b, tile, chunks - 1);
  ring.issue(tile, 0, 0);
  for (int c = tile; c < chunks; ++c) {
    const int i0 = c * kBT;
    const bool diag = c == tile, last = c == chunks - 1;
    const bool active = cols_live && i0 + 32 * wr < n && !(diag && 32 * wr + 31 < 16 * wc);
    float bias[4][4];
    pair_bias<false>(p, sm, b, i0, j0, pr, pc0, bias);
    for (int hd = 0; hd < p.H; ++hd) {
      const uint32_t aseed = ADROP ? attn_seed(p.adp.seed0, b, hd) : 0u;
      float s[4][4], da[4][4];
      pair_products<false, T>(ring, c, hd, active, pr, pc0, s, da);
      if (active) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + pr[r];
          float o[4], oa[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = j0 + pc0 + cc;
            const float sv = s[r][cc] + bias[r][cc];
            float dav = da[r][cc];
            float sig, deriv;
            silu_grad(sv, sig, deriv);
            float a = sv * sig;
            if constexpr (ADROP) {
              const float keep =
                  keep_scale(static_cast<uint32_t>(i * n + j), aseed, p.adp.thresh, p.adp.scale);
              dav *= keep;
              a *= keep;
            }
            o[cc] = round_to<T>(dav * deriv);
            oa[cc] = round_to<T>(a);
          }
          *reinterpret_cast<float4*>(sm.dsm + pr[r] * kLdP + pc0) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(sm.am + pr[r] * kLdP + pc0) =
              make_float4(oa[0], oa[1], oa[2], oa[3]);
        }
      }
      const int off = g_v ? hdv + hd * p.dv : 2 * hdv + p.H * p.dqk + hd * p.dqk;
      for (int q = 0; q <= ring.K - ring.R; ++q) {
        const int e0 = (q == 0 ? ring.R - 1 : q - 1) * kDC;
        const int cnt = min(kDC, dims - e0);
        // A warp whose columns are all padded writes its zeros after the last chunk.
        const bool work = pe0 < cnt && (out_live || last);
        // The partial sums of the chunk before, read back by the thread that wrote them.
        float acc[4][4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* dyj = p.d_y + (row0 + j0 + oc0 + cc) * F + off + e0 + pe0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[cc][e] = 0.f;
            if (work && !diag && out_live && j0 + oc0 + cc < n && pe0 + e < cnt) acc[cc][e] = dyj[e];
          }
        }
        if (q == 0) {
          __syncthreads();   // d_s and a are in the tiles
        } else {
          ring.stage(c, hd, ring.R + q - 1);   // q's and d_attn's dims [e0, e0 + kDC)
        }
        if (!work) continue;
        // Rows of the chunk below n; on the diagonal, i >= j from this warp's first column.
        const int ibeg = diag ? 16 * (warp & 3) : 0, iend = out_live ? min(kBT, n - i0) : 0;
        // Whole chunks of live columns without predicates.
        auto sum = [&](auto edge) {
          constexpr bool kEdge = decltype(edge)::value;
          for (int iq = kEdge ? ibeg : 0; iq < (kEdge ? iend : kBT); iq += 4) {
            float4 x[4], w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              x[k] = ld4(xs + (iq + k) * kLdP + oc0);
              w[k] = ld4(ws + (iq + k) * ldw + pe0);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                if (kEdge && (!ok[cc] || iq + k >= iend || (diag && iq + k < oc0 + cc))) continue;
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[cc][e] = fmaf(comp(x[k], cc), comp(w[k], e), acc[cc][e]);
              }
            }
          }
        };
        if (!diag && iend == kBT && ok[0] && ok[1] && ok[2] && ok[3]) {
          sum(std::false_type{});
        } else {
          sum(std::true_type{});
        }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          if (j0 + oc0 + cc >= n) continue;
          float* dyj = p.d_y + (row0 + j0 + oc0 + cc) * F + off + e0 + pe0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (pe0 + e < cnt) dyj[e] = g_v && last ? acc[cc][e] * p.inv_n : acc[cc][e];
          }
        }
      }
    }
  }
}

// One block's shared memory (attn_bwd_smem_bytes), with the time-bucket
// weights staged.
template <typename T>
__device__ __forceinline__ BwdSmem bwd_smem(const BwdParams<T>& p, float4* smem4) {
  BwdSmem sm;
  sm.ldq = bwd_ld(p.dqk);
  sm.ldv = bwd_ld(p.dv);
  sm.qs = reinterpret_cast<float*>(smem4);
  sm.ks = sm.qs + kBT * sm.ldq;
  sm.as = sm.ks + kBT * sm.ldq;
  sm.vs = sm.as + kBT * sm.ldv;
  sm.raw = sm.vs + kBT * sm.ldv;
  sm.dsm = sm.raw + 2 * kBT * (sm.ldq + sm.ldv);
  sm.am = sm.dsm + kBT * kLdP;
  sm.tw = sm.am + kBT * kLdP;
  for (int t = threadIdx.x; t < 128; t += kBwdThreads) sm.tw[t] = p.tsw[t];
  __syncthreads();
  return sm;
}

// (b) Two launches of (user, tile) blocks, the tiles with the most chunks
// first: pass 1 over 64 query rows, pass 2 over 64 key columns. y is stored
// as T; v, d_attn, the attention weights and d_s round to T before each
// product. ADROP regenerates each head's attention keep mask.
template <typename T, bool ADROP>
__global__ void __launch_bounds__(kBwdThreads, 2)
hstu_attn_bwd_rows_kernel(BwdParams<T> p) {
  extern __shared__ float4 smem4[];
  bwd_rows<T, ADROP>(p, bwd_smem(p, smem4), blockIdx.x, gridDim.y - 1 - blockIdx.y);
}

template <typename T, bool ADROP>
__global__ void __launch_bounds__(kBwdThreads, 2)
hstu_attn_bwd_cols_kernel(BwdParams<T> p) {
  extern __shared__ float4 smem4[];
  bwd_cols<T, ADROP>(p, bwd_smem(p, smem4), blockIdx.x, blockIdx.y);
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

template <typename T, bool ADROP>
cudaError_t launch_attn_bwd(const BwdParams<T>& p, int B, cudaStream_t s) {
  const size_t smem = attn_bwd_smem_bytes(p.n, p.dqk, p.dv);
  cudaError_t err;
  if ((err = allow_smem(hstu_attn_bwd_rows_kernel<T, ADROP>, smem)) != cudaSuccess ||
      (err = allow_smem(hstu_attn_bwd_cols_kernel<T, ADROP>, smem)) != cudaSuccess) {
    return err;
  }
  const dim3 grid(B, (p.n + kBT - 1) / kBT);
  hstu_attn_bwd_rows_kernel<T, ADROP><<<grid, kBwdThreads, smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  hstu_attn_bwd_cols_kernel<T, ADROP><<<grid, kBwdThreads, smem, s>>>(p);
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
  const BwdParams<T> p{y,  d_attn_scratch, colmask, rel_pos, ext,        tsw, d_y,
                       dbias, n, H, dqk, dv, inv_n, max_bucket, adp};
  return adp.drop ? launch_attn_bwd<T, true>(p, B, s) : launch_attn_bwd<T, false>(p, B, s);
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
