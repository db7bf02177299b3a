// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace attn {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// the value a float takes once rounded to T (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Element strides of one [B, H, S, dh]-shaped operand. The fused layout
// [B, S, 3D] is {S*3D, dh, 3D} (q, k, v at column offsets 0, D, 2D) and
// its [B, S, D] output {S*D, dh, D}; a contiguous [B, H, S, dh] tensor is
// {H*S*dh, S*dh, dh}. Head h's row i starts at b*batch + h*head + i*row.
struct Strides {
  long long batch, head, row;
};
__device__ __forceinline__ size_t at(const Strides& s, int b, int h, int i) {
  return (size_t)b * s.batch + (size_t)h * s.head + (size_t)i * s.row;
}

// Rows staged in shared memory are padded by one 32-bit word, so lanes
// reading different rows at the same column hit different banks.
template <typename T, int DH>
struct Padded {
  static constexpr int kStride = DH + (int)(4 / sizeof(T));
};

// One dynamic-shared-memory kernel: raise its limit to `smem` bytes.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline cudaError_t smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace attn
