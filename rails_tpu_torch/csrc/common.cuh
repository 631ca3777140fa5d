// Element-type helpers shared by the hand-written Hopper kernels.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16;
// the MoL scoring kernels also int8_t) and accumulates in float.
// `round_to<T>` reproduces the points where the JAX kernels cast an
// intermediate to the matmul dtype before a product (a no-op for float).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rails {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

// A corpus table's storage type S and the type its products round to. An
// int8 table holds symmetric codes with f32 scales per column: the JAX kernels
// dequantize its blocks to bf16, so the query is bf16 and the MLP rounds to
// bf16 as with a bf16 table (every int8 code is exact in bf16).
template <typename S> struct TableTraits {
  using Round = S;
  static constexpr bool kQuant = false;
};
template <> struct TableTraits<int8_t> {
  using Round = __nv_bfloat16;
  static constexpr bool kQuant = true;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// Exact SiLU through expf (the build does not use --use_fast_math).
__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// *addr = max(*addr, v) for non-NaN floats: a float's bits ordered as a signed
// int follow the float order among non-negative values (sign bit clear), and
// as an unsigned int they follow it reversed among negative ones (sign bit
// set, -0.0 included). Max is order-independent, so the result is exact.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// The current device's SM count, read once per device (0 on an error).
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int count[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return count[dev];
}

// The current device's opt-in dynamic shared memory of one block, read once
// per device (0 on an error).
inline size_t max_block_smem() {
  constexpr int kMaxDevices = 64;
  static int bytes[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (bytes[dev] == 0 &&
      cudaDeviceGetAttribute(&bytes[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  return static_cast<size_t>(bytes[dev]);
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rails
