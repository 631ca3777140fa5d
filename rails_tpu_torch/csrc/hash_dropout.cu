// The o_input dropout mask of a batch (K3 launched on its own).
//
// Replaces `_dropout_mask_batch` (rails_tpu/ops/pallas/hstu_block_train.py),
// which the JAX backward evaluates in XLA from `keep_from_idx`: mask[b, i, c]
// keeps with the bits of idx = i * width + c under the seed seed0 + b * salt.
// The fused train block's backward multiplies d(o_input) and the recomputed
// o_input by it. Bound: one f32 write per element (B*n*width*4 bytes); the
// hash is a dozen integer operations, far below the memory time, so the
// kernel is a plain grid-stride loop with coalesced stores.
#include <cstdint>

#include "common.cuh"
#include "hash_dropout.cuh"

namespace rails {
namespace {

__global__ void hash_keep_mask_kernel(float* __restrict__ out, int64_t total, int per_user,
                                      int seed0, uint32_t thresh, float scale) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int user = static_cast<int>(e / per_user);
    const uint32_t idx = static_cast<uint32_t>(e - static_cast<int64_t>(user) * per_user);
    out[e] = keep_scale(idx, user_seed(seed0, user), thresh, scale);
  }
}

}  // namespace
}  // namespace rails

// out (B, n, width) f32.
extern "C" int rails_hash_keep_mask(float* out, int B, int n, int width, int seed0,
                                    unsigned thresh, float scale, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * n * width;
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  rails::hash_keep_mask_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, total, n * width, seed0, thresh, scale);
  return cudaGetLastError();
}
