// Counter-hash dropout keep mask (K3), the device function every kernel that
// drops calls.
//
// Replaces `keep_from_idx` (rails_tpu/ops/pallas/hash_dropout.py), which the
// TPU kernels evaluate inside their bodies: a murmur3-finalizer hash of a
// global flat index, so the backward regenerates the forward's mask with no
// mask tensor in memory. The JAX code does the arithmetic in int32 with
// two's-complement wrapping and logical right shifts; uint32_t arithmetic
// gives the same bits. The keep test is `(h & 0x7fffffff) >= thresh` with
// thresh = min(int(rate * 2^31), 2^31 - 1) computed on the host, exactly as
// `hash_dropout.py:35` does. K4's attention dropout draws the per-head stream
// of `attn_seed` inside its attention kernels, forward and backward. K5
// (mol_loss_train.cu) draws its two streams through `keep_scale` with
// seed + salt (QI_SALT, PI_SALT in hash_dropout.py).
#pragma once

#include <cstdint>

namespace rails {

// The o_input stream's per-user salt, -1498392781 as int32
// (`hstu_block_train.py:108`; its comment's 0xA6AC5333 is a typo).
constexpr uint32_t kUserSalt = 0xA6B05733u;

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 0x9E3779B1u + seed;  // salt 0
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h & 0x7FFFFFFFu;
}

// Seed of batch row `user`: seed0 + user * kUserSalt, wrapping.
__device__ __forceinline__ uint32_t user_seed(int seed0, int user) {
  return static_cast<uint32_t>(seed0) + static_cast<uint32_t>(user) * kUserSalt;
}

// The attention-weight stream's per-head salt, -1789569707 as int32
// (`_attn_dropout_mask`, hstu_block_train.py:113-121).
constexpr uint32_t kHeadSalt = 0x95555555u;

// Seed of the attention keep mask of (batch row `user`, head `head`):
// seed0 + user * kUserSalt + (head + 1) * kHeadSalt, wrapping; its flat index
// is i * n + j over the (n, n) map. The softmax map uses head 0.
__device__ __forceinline__ uint32_t attn_seed(int seed0, int user, int head) {
  return user_seed(seed0, user) + static_cast<uint32_t>(head + 1) * kHeadSalt;
}

// 0 or `scale` = f32(1 / (1 - rate)) for flat index idx = pos * width + col.
__device__ __forceinline__ float keep_scale(uint32_t idx, uint32_t seed, uint32_t thresh,
                                            float scale) {
  return hash_bits(idx, seed) >= thresh ? scale : 0.f;
}

}  // namespace rails
