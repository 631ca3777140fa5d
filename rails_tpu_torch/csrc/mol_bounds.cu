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
// Two routes, chosen by the wrapper (`bounds_tc_route` in ops/mol_scoring.py)
// and passed as `tc`; the library refuses a tc that disagrees:
//   - bf16 and int8 tables at P_Q = 8, P_X in {4, 8}, d_P a multiple of 16
//     with P_X * d_P <= 512 (ML-20M, ML-1M, Amazon Books): the tensor-core
//     kernel `mol_bounds_tc_kernel` below, whose logits are the routine of
//     mol_tc_logits.cuh that K2's tensor-core kernel runs (mol_scoring_tc.cuh).
//     Where K2 takes its tensor-core route too (H a multiple of 16 up to 256,
//     every registry config), K8 is the max of K2's logits and K9's max over
//     l is K8's per-tile max, bit for bit. Elsewhere (H alone keeping K2 on
//     the CUDA cores) K8 bounds K2's scores within the certificate's margin.
//     Work per pair: the P_Q * P_X * d_P products on mma.sync (bf16 operands,
//     f32 sums), their k16 partials added on the CUDA cores (L d_P / 16 FADDs)
//     and the maxima; no MLP. At B = 32 a 32-item block of the 8x4x128 table
//     (32 KB bf16) meets 2,048 mma.sync, so one CTA an SM holds both buffers
//     and streams the table while the previous block is scored.
//   - f32 tables and synthetic-small's 4x2x16 (and bf16 / int8 tables at
//     other widths): the CUDA-core kernels `mol_ub_kernel` and
//     `mol_group_block_max_kernel`, laid out as K2's CUDA-core kernel
//     (mol_scoring.cuh): lanes own items, warps own queries. A block stages
//     32 items of the (P_X, d_P, X_padded) table in shared memory as f32, one
//     padded row per item, and each warp walks 4 of the block's 32 queries,
//     staging one query at a time. A thread keeps its item's L logits in
//     registers and reads the item and the query as float4s (the row pad of 4
//     floats makes the item reads conflict-free). K8 writes the max over the
//     L logits per (query, item); K9 walks its 256-item tile as 8 such
//     sub-tiles, reduces each sub-tile's logits over the 32 lanes into one max
//     per group (a butterfly that halves the values each lane holds: at L <=
//     32 lane l / (32 / L) ends up with group l, at L = 64 lane i with groups
//     2i and 2i + 1), and keeps the running max per (query, group). Their
//     logits are the CUDA-core K2's: the same f32 values, summed over k in
//     the same order with fmaf and scaled the same way, so K8's bound is
//     exactly the max of those logits. At B = 32 a 1 KB bf16 item row meets
//     32 * 4096 FMAs, so they are bound by FP32 FMA issue.
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "common.cuh"
#include "mol_tc_logits.cuh"

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

namespace moltc {

constexpr int kWarpQ = kQB / (kWarps / 2);   // queries a warp scores per block
constexpr int kStages = 3;                   // item blocks staged at once
constexpr int kLdO = kTX + 4;                // row stride of K8's staged (query, item) block (f32)
// Queries a call of the logits routine takes: all of a warp's 8 at P_X = 4
// (each A fragment feeds 16 products), 4 at P_X = 8, where 8 would spill.
template <int PX>
constexpr int kNQ = PX == 4 ? kWarpQ : kWarpQ / 2;

// Shared memory of mol_bounds_tc_kernel, byte offsets (each a multiple of 16).
template <int PX>
struct BoundsLayout {
  static constexpr int L = kPQ * PX;
  int ldq;
  size_t items, q, cs, out, gmax, bytes;
  __host__ __device__ explicit BoundsLayout(int dP) : ldq(dP + 8) {
    size_t o = 0;
    items = o; o += kStages * static_cast<size_t>(PX) * dP * kLdX * 2;  // [kStages][PX*dP][kLdX]
    q = o;     o += static_cast<size_t>(kQB) * kPQ * ldq * 2;           // [kQB*8][dP + 8]
    cs = o;    o += kStages * static_cast<size_t>(PX) * kTX * 4;        // int8 scales [PX][32]
    out = o;   o += static_cast<size_t>(kQB) * kLdO * 4;                // K8: [kQB][kLdO]
    gmax = o;  o += 2 * static_cast<size_t>(kQB) * L * 4;               // K9: [2][kQB][L]
    bytes = o;
  }
};

// One step of a butterfly max over the lanes that differ in bit `bit` of the
// lane index: each lane keeps the half of its N values v[0, N) that its bit
// selects (the upper half when set), maxed with its partner's copy of that
// half, in v[0, N/2).
template <int N>
__device__ __forceinline__ void halve_max(float* v, int lane, int bit) {
  const bool upper = lane & bit;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send = upper ? v[i] : v[i + N / 2];
    const float keep = upper ? v[i + N / 2] : v[i];
    v[i] = fmaxf(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

// K8 (GROUPS false) and K9 (GROUPS true) on the tensor cores. A CTA (8
// warps) owns 32 queries, staged once, and walks whole 256-item tiles
// (blockIdx.y, + gridDim.y, ...), 8 item blocks of 32 each, through a ring of
// kStages buffers: bf16 blocks by cp.async two ahead; int8 codes through
// registers one block ahead and stored converted, their scales by cp.async.
// A warp scores 16 items x 8 queries with the shared logits routine, NQ
// queries a call, so each A fragment (ldmatrix.trans) feeds 2 NQ products.
// K8 takes each lane's max over the 2 P_X logits its fragment holds for an
// item (int8: each pair of n times cs[m, x] first), the quad's max over n,
// then 1/T, into a (32 queries x 32 items) block in shared memory that
// leaves as 16-byte stores. K9 takes each logit (int8: times cs[m, x]), the
// max over the fragment's rows g and g + 8, then per query a halving
// butterfly over lanes xor 16, 8, 4 that leaves lane (g, t) the maxima over
// the warp's 16 items of the values j = g * P_X/4 + k of the 2 P_X (m, n)
// its lane pair holds, kept in registers over the tile's 8 blocks; at the
// tile's end the two warps of each item half meet in shared memory, and the
// max of the two, times 1/T, goes out in the port's n-major order
// l = n * P_X + m.
// What bounds it (PERF.md §6): the mma.sync products. Without the
// table's loads the kernel takes ~90% of its time; without the k16 adds or
// the A reloads ~80% each; 16 warps or 2, 4 or 8 queries a call move it by
// 10%. The table's bytes (0.32 ms at 1M items) need wgmma's rate, whose k16
// sums need not round as mma.sync's do, which K8 = max of K2's logits needs.
template <typename S, int PX, bool GROUPS>
__global__ void __launch_bounds__(kThreads, 1)
mol_bounds_tc_kernel(const bf16* __restrict__ q, const S* __restrict__ items,
                     const float* __restrict__ cs, float* __restrict__ out, int B, int Xp,
                     int dP, float inv_t) {
  constexpr int L = kPQ * PX;
  constexpr int NQ = kNQ<PX>;
  constexpr int kBPasses = kWarpQ / NQ;
  constexpr int J = 2 * PX;           // values (m, n of the lane's pair) a lane holds a query
  constexpr int J8 = J / 8;           // of them, maxima a lane keeps after the butterfly
  constexpr bool kQuant = kInt8<S>;
  extern __shared__ __align__(16) unsigned char smem[];
  const BoundsLayout<PX> lay(dP);
  bf16* its = reinterpret_cast<bf16*>(smem + lay.items);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  float* css = reinterpret_cast<float*>(smem + lay.cs);
  float* os = reinterpret_cast<float*>(smem + lay.out);
  float* gs = reinterpret_cast<float*>(smem + lay.gmax);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQB;
  const int rows = PX * dP;
  const int nt = Xp / kTile;
  const int nblk = blockIdx.y < nt ? ((nt - 1 - blockIdx.y) / gridDim.y + 1) * kTileBlocks : 0;
  // The corpus column of the walker's i-th item block.
  auto x0_of = [&](int i) {
    return ((blockIdx.y + (i / kTileBlocks) * gridDim.y) * kTileBlocks + i % kTileBlocks) * kTX;
  };

  stage_queries(q, qs, lay.ldq, q0, B, dP);
  tc::cp_async_commit();
  auto stage = [&](int x0, int buf) {
    if constexpr (kQuant) {
      stage_scales_async(cs, css + buf * PX * kTX, PX, Xp, x0);
    } else {
      stage_rows_async(items, its + static_cast<size_t>(buf) * rows * kLdX, rows, Xp,
                                  x0);
    }
  };
  Int8Rows raw;
  auto load_codes = [&](int x0) {
    if constexpr (kQuant) raw.load(items, Xp, x0, rows, [](int r) { return r; });
  };
  auto store_codes = [&](int buf) {
    if constexpr (kQuant) raw.store(its + static_cast<size_t>(buf) * rows * kLdX, rows);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nblk) stage(x0_of(j), j);
    tc::cp_async_commit();
  }
  if (nblk > 0) {
    load_codes(x0_of(0));
    store_codes(0);
  }
  if (nblk > 1) load_codes(x0_of(1));

  const int ig = warp & 1, qg = warp >> 1;
  const int xl = ig * 16 + g;     // block-local items of lane rows g and g + 8
  float gk[kBPasses][NQ][J8];    // K9: the running maxima of the warp's queries
#pragma unroll
  for (int p = 0; p < kBPasses; ++p)
#pragma unroll
    for (int s = 0; s < NQ; ++s)
#pragma unroll
      for (int k = 0; k < J8; ++k) gk[p][s][k] = -INFINITY;

  for (int i = 0; i < nblk; ++i) {
    const int buf = i % kStages;
    const int x0 = x0_of(i);
    if (i + kStages - 1 < nblk) stage(x0_of(i + kStages - 1), (i + kStages - 1) % kStages);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();
    __syncthreads();
    const bf16* it = its + static_cast<size_t>(buf) * rows * kLdX + ig * 16;
    const float* csx = css + buf * PX * kTX + xl;
#pragma unroll
    for (int pass = 0; pass < kBPasses; ++pass) {
      const int qa = qg * kWarpQ + pass * NQ;   // CTA-local queries qa .. qa + NQ - 1
      if (q0 + qa >= B) break;                   // warp-uniform
      float lg[NQ][PX][4];
      tile_logits<PX, NQ>(it, qs + qa * kPQ * lay.ldq, lay.ldq, dP, lane, lg);
#pragma unroll
      for (int s = 0; s < NQ; ++s) {
        if constexpr (!GROUPS) {
          float v0 = -INFINITY, v1 = -INFINITY;
#pragma unroll
          for (int m = 0; m < PX; ++m) {
            float a0 = fmaxf(lg[s][m][0], lg[s][m][1]);
            float a1 = fmaxf(lg[s][m][2], lg[s][m][3]);
            if constexpr (kQuant) {
              a0 *= csx[m * kTX];
              a1 *= csx[m * kTX + 8];
            }
            v0 = fmaxf(v0, a0);
            v1 = fmaxf(v1, a1);
          }
          v0 = quad_max(v0) * inv_t;
          v1 = quad_max(v1) * inv_t;
          if (t < 2) os[(qa + s) * kLdO + xl + t * 8] = t == 0 ? v0 : v1;
        } else {
          float v[J];
#pragma unroll
          for (int m = 0; m < PX; ++m)
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              float a = lg[s][m][nn], b = lg[s][m][nn + 2];   // rows g, g + 8
              if constexpr (kQuant) {
                a *= csx[m * kTX];
                b *= csx[m * kTX + 8];
              }
              v[m * 2 + nn] = fmaxf(a, b);
            }
          halve_max<J>(v, lane, 16);
          halve_max<J / 2>(v, lane, 8);
          halve_max<J / 4>(v, lane, 4);
#pragma unroll
          for (int k = 0; k < J8; ++k) gk[pass][s][k] = fmaxf(gk[pass][s][k], v[k]);
        }
      }
    }
    if (i + 1 < nblk) store_codes((i + 1) % kStages);
    if (i + 2 < nblk) load_codes(x0_of(i + 2));
    const bool tile_end = i % kTileBlocks == kTileBlocks - 1;
    if constexpr (GROUPS) {
      if (tile_end) {
#pragma unroll
        for (int p = 0; p < kBPasses; ++p)
#pragma unroll
          for (int s = 0; s < NQ; ++s)
#pragma unroll
            for (int k = 0; k < J8; ++k) {
              const int j = g * J8 + k;
              const int m = j / 2, n = 2 * t + (j & 1);
              gs[(ig * kQB + qg * kWarpQ + p * NQ + s) * L + n * PX + m] = gk[p][s][k];
              gk[p][s][k] = -INFINITY;
            }
      }
    }
    __syncthreads();
    if constexpr (GROUPS) {
      if (tile_end) {
        const int tile = x0 / kTile;
        for (int e = tid; e < kQB * L; e += kThreads) {
          const int b = q0 + e / L;
          if (b < B) {
            out[(static_cast<int64_t>(b) * L + e % L) * nt + tile] =
                fmaxf(gs[e], gs[kQB * L + e]) * inv_t;
          }
        }
      }
    } else {
      for (int e = tid; e < kQB * kTX / 4; e += kThreads) {
        const int qi = e >> 3, c = e & 7;   // 32 queries x 8 float4
        const int b = q0 + qi;
        if (b < B) {
          *reinterpret_cast<float4*>(out + static_cast<int64_t>(b) * Xp + x0 + c * 4) =
              *reinterpret_cast<const float4*>(os + qi * kLdO + c * 4);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
}

template <typename S, int PX>
cudaError_t run_tc(int kind, const void* q, const void* items, const float* cs, float* out,
                   int B, int Xp, int dP, float inv_t, cudaStream_t stream) {
  if (!logits_ok(kPQ, PX, dP) || Xp % kTile != 0 || B <= 0) return cudaErrorInvalidValue;
  if (kInt8<S> && cs == nullptr) return cudaErrorInvalidValue;
  const size_t smem = BoundsLayout<PX>(dP).bytes;
  auto kernel = kind == 0 ? mol_bounds_tc_kernel<S, PX, false> : mol_bounds_tc_kernel<S, PX, true>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int nqb = (B + kQB - 1) / kQB;
  const int walkers = std::max(1, std::min(Xp / kTile, std::max(1, per_sm) * sm_count() / nqb));
  kernel<<<dim3(nqb, walkers), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const S*>(items), cs, out, B, Xp, dP, inv_t);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch_tc(int kind, int px, const void* q, const void* items, const float* cs,
                        float* out, int B, int Xp, int dP, float inv_t, cudaStream_t s) {
  if (px == 4) return run_tc<S, 4>(kind, q, items, cs, out, B, Xp, dP, inv_t, s);
  if (px == 8) return run_tc<S, 8>(kind, q, items, cs, out, B, Xp, dP, inv_t, s);
  return cudaErrorInvalidValue;
}

}  // namespace moltc

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

// The route bounds_tc_route (ops/mol_scoring.py) names: the tensor cores for
// bf16 and int8 tables at the logits routine's geometries.
bool bounds_tc(int dtype, int pq, int px, int dP) {
  return (dtype == 1 || dtype == 2) && moltc::logits_ok(pq, px, dP);
}

int bounds(int kind, int tc, int dtype, int pq, int px, const void* q, const void* items,
           const float* cs, float* out, int B, int Xp, int dP, float inv_t, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if ((tc != 0) != bounds_tc(dtype, pq, px, dP)) return cudaErrorInvalidValue;
  if (tc) {
    return dtype == 1
               ? moltc::dispatch_tc<__nv_bfloat16>(kind, px, q, items, cs, out, B, Xp, dP, inv_t, s)
               : moltc::dispatch_tc<int8_t>(kind, px, q, items, cs, out, B, Xp, dP, inv_t, s);
  }
  switch (dtype) {
    case 0: return dispatch<float>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    case 1: return dispatch<__nv_bfloat16>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    case 2: return dispatch<int8_t>(kind, pq, px, q, items, cs, out, B, Xp, dP, inv_t, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace rails

// tc: 1 for the tensor-core kernel (mol_bounds_tc_kernel), 0 for the CUDA-core
// ones: 1 exactly for bf16 and int8 tables at P_Q = 8, P_X 4 or 8, dP a
// multiple of 16 with P_X * dP <= 512 (ops/mol_scoring.py:bounds_tc_route),
// else cudaErrorInvalidValue.
// dtype: 0 = float32 (q and items f32), 1 = bfloat16 (both bf16), 2 = int8
// (items int8 with cs (PX, Xp) f32 scales, q bf16; cs may be null otherwise).
// q (B, PQ, dP); items (PX, dP, Xp) with Xp a multiple of 256; out (B, Xp) f32
// (K8) or (B, L, Xp / 256) f32 (K9), L = PQ * PX in n-major order; dP a
// multiple of 4.
extern "C" int rails_mol_ub(int tc, int dtype, int pq, int px, const void* q, const void* items,
                            const float* cs, float* out, int B, int Xp, int dP, float inv_t,
                            void* stream) {
  return rails::bounds(0, tc, dtype, pq, px, q, items, cs, out, B, Xp, dP, inv_t, stream);
}

extern "C" int rails_mol_group_block_max(int tc, int dtype, int pq, int px, const void* q,
                                         const void* items, const float* cs, float* out, int B,
                                         int Xp, int dP, float inv_t, void* stream) {
  return rails::bounds(1, tc, dtype, pq, px, q, items, cs, out, B, Xp, dP, inv_t, stream);
}

extern "C" size_t rails_mol_bounds_smem_bytes(int tc, int pq, int px, int dP) {
  if (tc) {
    if (!rails::moltc::logits_ok(pq, px, dP)) return 0;
    return px == 4 ? rails::moltc::BoundsLayout<4>(dP).bytes
                   : rails::moltc::BoundsLayout<8>(dP).bytes;
  }
  if (pq == 8 && px == 4) return rails::smem_bytes<8, 4>(dP);
  if (pq == 4 && px == 2) return rails::smem_bytes<4, 2>(dP);
  if (pq == 8 && px == 8) return rails::smem_bytes<8, 8>(dP);
  return 0;
}
