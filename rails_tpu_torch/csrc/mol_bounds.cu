// Score bounds of approximate MoL retrieval (K8, K9), hand-written for Hopper (sm_90a).
//
// K8 replaces the Pallas kernel `fused_mol_ub_t` (rails_tpu/ops/pallas/mol_scoring.py,
// body `_ub_kernel`):
//   ub[b, x] = max_{n, m} <q[b, n], item[x, m]> / T
// K9 replaces `fused_mol_group_block_max` (body `_group_block_max_kernel`):
//   gmax[b, l = n*P_X + m, t] = max_{x in tile t} <q[b, n], item[x, m]> / T
// over 256-item corpus tiles, rows in the port's n-major logit order. The MoL
// score is a softmax mixture of the logits, so both bound it from above
// (T > 0). Neither runs the gating chain: per (query, item) pair they do the
// P_Q * P_X * d_P FMAs of the component logits (4096 at 8x4x128, 2048 at
// 8x8x32) and a max.
// int8 tables (TableTraits<int8_t>, common.cuh): bf16 queries, and each raw
// dot product times its item's component scale cs[m, x] before the max and
// 1/T, as in JAX and as K2 scales its logits.
//
// Layout, as K2's (csrc/mol_scoring.cu): lanes own items, warps own queries.
// A block stages 32 items of the (P_X, d_P, X_padded) table in shared memory
// as f32, one padded row per item, and each warp walks 4 of the block's 32
// queries, staging one query at a time. A thread keeps its item's L logits in
// registers and reads the item and the query as float4s (the row pad of 4
// floats makes the item reads conflict-free). K8 writes the max over the L
// logits per (query, item); K9 walks its 256-item tile as 8 such sub-tiles,
// reduces each sub-tile's logits over the 32 lanes into one max per group (a
// butterfly that halves the values each lane holds: at L <= 32 lane
// l / (32 / L) ends up with group l, at L = 64 lane i with groups 2i and
// 2i + 1), and keeps the running max per (query, group).
// The logits are K2's: the same f32 values, summed over k in the same order
// with fmaf and scaled the same way, so K8's bound is exactly the max of K2's
// logits.
// Bound: at B = 32 a 1 KB bf16 item row meets 32 * 4096 FMAs, far above the
// card's bytes-to-operations line, so the kernels are bound by FP32 FMA issue
// on the CUDA cores; the tensor cores are unused (later work).
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace rails {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubX = 32;              // items staged at once, one per lane
constexpr int kTileCols = 256;         // K9's corpus tile
constexpr int kQueriesPerBlock = 32;
constexpr int kPerWarp = kQueriesPerBlock / kWarps;
constexpr int kPad = 4;                // floats after each staged item row

template <int PQ, int PX>
size_t smem_bytes(int dP) {
  return (static_cast<size_t>(kSubX) * (PX * dP + kPad) +
          static_cast<size_t>(kWarps) * PQ * dP) * sizeof(float);
}

// Items [x0, x0 + 32) of the (PX, dP, Xp) table into its[c][m * dP + k], f32.
template <typename T, int PX>
__device__ __forceinline__ void stage_items(const T* __restrict__ items, float* its, int x0,
                                            int Xp, int dP) {
  const int row = PX * dP + kPad;
  for (int e = threadIdx.x; e < PX * dP * kSubX; e += kThreads) {
    const int r = e / kSubX, c = e % kSubX;
    its[c * row + r] = to_f<T>(items[static_cast<int64_t>(r) * Xp + x0 + c]);
  }
}

template <typename T, int PQ>
__device__ __forceinline__ void stage_query(const T* __restrict__ q, float* qw, int b, int dP) {
  for (int e = threadIdx.x & 31; e < PQ * dP; e += 32) {
    qw[e] = to_f<T>(q[static_cast<int64_t>(b) * PQ * dP + e]);
  }
}

// The component scales cs[m, x] of an int8 table (1 otherwise).
template <typename S, int PX>
__device__ __forceinline__ void load_scales(const float* __restrict__ cs, int x, int Xp,
                                            float (&csv)[PX]) {
#pragma unroll
  for (int m = 0; m < PX; ++m) {
    csv[m] = TableTraits<S>::kQuant ? cs[static_cast<int64_t>(m) * Xp + x] : 1.f;
  }
}

template <typename S, int PQ, int PX>
__device__ __forceinline__ void scale_logits(const float (&csv)[PX], float (&lg)[PQ * PX]) {
  if constexpr (TableTraits<S>::kQuant) {
#pragma unroll
    for (int l = 0; l < PQ * PX; ++l) lg[l] *= csv[l % PX];
  }
}

// lg[n * PX + m] = sum_k qw[n * dP + k] * it[m * dP + k], in k order.
template <int PQ, int PX>
__device__ __forceinline__ void item_logits(const float* qw, const float* it, int dP,
                                            float (&lg)[PQ * PX]) {
#pragma unroll
  for (int l = 0; l < PQ * PX; ++l) lg[l] = 0.f;
  for (int k = 0; k < dP; k += 4) {
    float4 iv[PX];
#pragma unroll
    for (int m = 0; m < PX; ++m) iv[m] = *reinterpret_cast<const float4*>(it + m * dP + k);
#pragma unroll
    for (int n = 0; n < PQ; ++n) {
      const float4 qv = *reinterpret_cast<const float4*>(qw + n * dP + k);
#pragma unroll
      for (int m = 0; m < PX; ++m) {
        float& a = lg[n * PX + m];
        a = fmaf(qv.x, iv[m].x, a);
        a = fmaf(qv.y, iv[m].y, a);
        a = fmaf(qv.z, iv[m].z, a);
        a = fmaf(qv.w, iv[m].w, a);
      }
    }
  }
}

// Max over the warp's 32 lanes of each of the N values v[0..N), N a power of
// two <= 64: while a lane holds more than one value it keeps the half whose
// group bit matches its lane bit S, maxed with its partner's; then plain
// butterfly rounds. For N <= 32 lane i returns group i / (32 / N) in v[0];
// for N = 64 it returns groups 2i and 2i + 1 in v[0] and v[1].
template <int N, int S>
__device__ __forceinline__ void group_max(float* v, int lane) {
  if constexpr (S > 0) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = lane & S;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? v[i] : v[i + H];
        const float keep = upper ? v[i + H] : v[i];
        v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, S));
      }
      group_max<H, S / 2>(v, lane);
    } else {
      v[0] = fmaxf(v[0], __shfl_xor_sync(0xffffffffu, v[0], S));
      group_max<1, S / 2>(v, lane);
    }
  }
}

template <typename S, int PQ, int PX>
__global__ void __launch_bounds__(kThreads)
mol_ub_kernel(const typename TableTraits<S>::Round* __restrict__ q, const S* __restrict__ items,
              const float* __restrict__ cs, float* __restrict__ out, int B, int Xp, int dP,
              float inv_t) {
  using Q = typename TableTraits<S>::Round;
  constexpr int L = PQ * PX;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* its = reinterpret_cast<float*>(smem_raw);         // [kSubX][PX * dP + kPad]
  float* qs = its + kSubX * (PX * dP + kPad);              // [kWarps][PQ * dP]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x0 = blockIdx.x * kSubX;
  stage_items<S, PX>(items, its, x0, Xp, dP);
  float csv[PX];
  load_scales<S, PX>(cs, x0 + lane, Xp, csv);
  __syncthreads();
  float* qw = qs + warp * PQ * dP;
  const float* it = its + lane * (PX * dP + kPad);
  for (int qi = warp; qi < kQueriesPerBlock; qi += kWarps) {
    const int b = blockIdx.y * kQueriesPerBlock + qi;
    if (b >= B) break;  // warp-uniform
    stage_query<Q, PQ>(q, qw, b, dP);
    __syncwarp();
    float lg[L];
    item_logits<PQ, PX>(qw, it, dP, lg);
    scale_logits<S, PQ, PX>(csv, lg);
    float mx = lg[0];
#pragma unroll
    for (int l = 1; l < L; ++l) mx = fmaxf(mx, lg[l]);
    out[static_cast<int64_t>(b) * Xp + x0 + lane] = mx * inv_t;
    __syncwarp();
  }
}

template <typename S, int PQ, int PX>
__global__ void __launch_bounds__(kThreads)
mol_group_block_max_kernel(const typename TableTraits<S>::Round* __restrict__ q,
                           const S* __restrict__ items, const float* __restrict__ cs,
                           float* __restrict__ out, int B, int Xp, int dP, float inv_t) {
  using Q = typename TableTraits<S>::Round;
  constexpr int L = PQ * PX;
  static_assert(L <= 64 && (L & (L - 1)) == 0, "L must be a power of two <= 64");
  constexpr int kLanesPerGroup = L < 32 ? 32 / L : 1;   // lanes that end with one group
  constexpr int kVals = L > 32 ? L / 32 : 1;            // groups each lane ends with
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* its = reinterpret_cast<float*>(smem_raw);
  float* qs = its + kSubX * (PX * dP + kPad);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x, nb = Xp / kTileCols;
  float* qw = qs + warp * PQ * dP;
  const float* it = its + lane * (PX * dP + kPad);
  float gm[kPerWarp][kVals];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j)
#pragma unroll
    for (int v = 0; v < kVals; ++v) gm[j][v] = -INFINITY;
  for (int sub = 0; sub < kTileCols / kSubX; ++sub) {
    __syncthreads();  // every warp is done with the previous sub-tile
    const int x0 = tile * kTileCols + sub * kSubX;
    stage_items<S, PX>(items, its, x0, Xp, dP);
    float csv[PX];
    load_scales<S, PX>(cs, x0 + lane, Xp, csv);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int b = blockIdx.y * kQueriesPerBlock + warp + j * kWarps;
      if (b >= B) break;  // warp-uniform
      stage_query<Q, PQ>(q, qw, b, dP);
      __syncwarp();
      float lg[L];
      item_logits<PQ, PX>(qw, it, dP, lg);
      scale_logits<S, PQ, PX>(csv, lg);
      group_max<L, 16>(lg, lane);
#pragma unroll
      for (int v = 0; v < kVals; ++v) gm[j][v] = fmaxf(gm[j][v], lg[v]);
      __syncwarp();
    }
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int b = blockIdx.y * kQueriesPerBlock + warp + j * kWarps;
    if (b >= B) break;
    if (lane % kLanesPerGroup == 0) {
#pragma unroll
      for (int v = 0; v < kVals; ++v) {
        const int g = lane / kLanesPerGroup * kVals + v;
        out[(static_cast<int64_t>(b) * L + g) * nb + tile] = gm[j][v] * inv_t;
      }
    }
  }
}

// kind 0: K8 (grid over 32-item sub-tiles), 1: K9 (grid over 256-item tiles).
template <typename S, int PQ, int PX>
cudaError_t run(int kind, const void* q, const void* items, const float* cs, float* out, int B,
                int Xp, int dP, float inv_t, cudaStream_t stream) {
  if (Xp % kTileCols != 0 || dP % 4 != 0 || B <= 0) return cudaErrorInvalidValue;
  if (TableTraits<S>::kQuant && cs == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<PQ, PX>(dP);
  const int query_blocks = (B + kQueriesPerBlock - 1) / kQueriesPerBlock;
  const auto* qt = static_cast<const typename TableTraits<S>::Round*>(q);
  const S* it = static_cast<const S*>(items);
  if (kind == 0) {
    cudaError_t err = allow_smem(mol_ub_kernel<S, PQ, PX>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Xp / kSubX, query_blocks);
    mol_ub_kernel<S, PQ, PX><<<grid, kThreads, smem, stream>>>(qt, it, cs, out, B, Xp, dP,
                                                               inv_t);
  } else {
    cudaError_t err = allow_smem(mol_group_block_max_kernel<S, PQ, PX>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(Xp / kTileCols, query_blocks);
    mol_group_block_max_kernel<S, PQ, PX><<<grid, kThreads, smem, stream>>>(qt, it, cs, out, B,
                                                                            Xp, dP, inv_t);
  }
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(int kind, int pq, int px, const void* q, const void* items, const float* cs,
                     float* out, int B, int Xp, int dP, float inv_t, cudaStream_t s) {
  if (pq == 8 && px == 4) return run<S, 8, 4>(kind, q, items, cs, out, B, Xp, dP, inv_t, s);
  if (pq == 4 && px == 2) return run<S, 4, 2>(kind, q, items, cs, out, B, Xp, dP, inv_t, s);
  if (pq == 8 && px == 8) return run<S, 8, 8>(kind, q, items, cs, out, B, Xp, dP, inv_t, s);
  return cudaErrorInvalidValue;
}

int bounds(int kind, int dtype, int pq, int px, const void* q, const void* items,
           const float* cs, float* out, int B, int Xp, int dP, float inv_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    case 1: return dispatch<__nv_bfloat16>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    case 2: return dispatch<int8_t>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rails

// dtype: 0 = float32 (q and items f32), 1 = bfloat16 (both bf16), 2 = int8
// (items int8 with cs (PX, Xp) f32 scales, q bf16; cs may be null otherwise).
// q (B, PQ, dP); items (PX, dP, Xp) with Xp a multiple of 256; out (B, Xp) f32
// (K8) or (B, L, Xp / 256) f32 (K9), L = PQ * PX in n-major order; dP a
// multiple of 4.
extern "C" int rails_mol_ub(int dtype, int pq, int px, const void* q, const void* items,
                            const float* cs, float* out, int B, int Xp, int dP, float inv_t,
                            void* stream) {
  return rails::bounds(0, dtype, pq, px, q, items, cs, out, B, Xp, dP, inv_t, stream);
}

extern "C" int rails_mol_group_block_max(int dtype, int pq, int px, const void* q,
                                         const void* items, const float* cs, float* out, int B,
                                         int Xp, int dP, float inv_t, void* stream) {
  return rails::bounds(1, dtype, pq, px, q, items, cs, out, B, Xp, dP, inv_t, stream);
}

extern "C" size_t rails_mol_bounds_smem_bytes(int pq, int px, int dP) {
  if (pq == 8 && px == 4) return rails::smem_bytes<8, 4>(dP);
  if (pq == 4 && px == 2) return rails::smem_bytes<4, 2>(dP);
  if (pq == 8 && px == 8) return rails::smem_bytes<8, 8>(dP);
  return 0;
}
