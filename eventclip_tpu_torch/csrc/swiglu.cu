// S1: EVA02's SwiGLU glue in one pass (ops/swiglu.py).
//
// Replaces no TPU kernel: the JAX package has no EVA02 tower. Between the
// fused W1/W2 product and W3, the MLP takes h12 [M, 2 Hs] bf16 (the gate in
// columns [0, H), the value in [Hs, Hs + H); Hs the stored width, a
// multiple of 8, H <= Hs the real one) to [M, Hs] bf16:
//
//   p = bf16_rn(silu(g) * v)                       each element, in f32
//   y = bf16_rn((p - mean) * rstd * w + b)         over the H real columns
//
// with silu(g) = g / (1 + expf(-g)) (F.silu's formula; expf and an IEEE
// division, no fast math), the mean and the biased variance of the rounded
// p over the H real columns in f32, rstd = rsqrtf(var + eps), and the f32
// weight and bias of `ffn_ln`. Columns [H, Hs) are written as 0; what the
// pad columns of h12 hold never enters a sum. The plain version rounds at
// the same points (ops/swiglu.py `swiglu_plain`); only the order of the f32
// sums differs.
//
// Bound by the memory: h12 read once and the result written once, 3 Hs x 2
// bytes a row; SiLU's expf and division (about 40 instructions an element
// in all) leave the issue slots little room, so the design keeps many warps
// resident to overlap one warp's arithmetic with the others' loads. A warp
// takes a row: 16-byte loads of both halves, S1_UNROLL vectors of each in
// flight a lane; p goes to the warp's slice of shared memory as bf16 (2 Hs
// bytes a row, each lane reading back only what it wrote, so no barrier)
// instead of registers, which held a whole row only at one or two blocks an
// SM; the mean and then the centred squares read it back and are summed by
// shuffles; the third pass writes 16-byte vectors. The weight and bias (H x
// 8 bytes) are read from L1 by every row. Only the vector holding column
// H - 1, and any past it, is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef S1_UNROLL
#define S1_UNROLL 2  // 16-byte vectors of each half a lane has in flight
#endif
#ifndef S1_MIN_BLOCKS
#define S1_MIN_BLOCKS 4  // resident blocks an SM the registers are cut to
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // rows a block holds at once

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// p of 8 columns from c0 on, packed bf16; adds them (rounded) to `sum`.
// kMasked: columns from H on are 0.
template <bool kMasked>
__device__ __forceinline__ uint4 glue8(uint4 g8, uint4 v8, int c0, int H,
                                       float& sum) {
  uint4 p8;
  const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g8);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v8);
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&p8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 g = __bfloat1622float2(g2[j]);
    const float2 x = __bfloat1622float2(v2[j]);
    float p0 = __fmul_rn(silu(g.x), x.x);
    float p1 = __fmul_rn(silu(g.y), x.y);
    if (kMasked) {
      p0 = c0 + 2 * j < H ? p0 : 0.0f;
      p1 = c0 + 2 * j + 1 < H ? p1 : 0.0f;
    }
    p2[j] = __floats2bfloat162_rn(p0, p1);
    const float2 r = __bfloat1622float2(p2[j]);
    sum += r.x + r.y;
  }
  return p8;
}

// The sum of (p - mean)^2 over 8 columns from c0 on (kMasked: below H).
template <bool kMasked>
__device__ __forceinline__ float centred8(uint4 p8, int c0, int H,
                                          float mean) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&p8);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 r = __bfloat1622float2(p2[j]);
    float d0 = r.x - mean, d1 = r.y - mean;
    if (kMasked) {
      d0 = c0 + 2 * j < H ? d0 : 0.0f;
      d1 = c0 + 2 * j + 1 < H ? d1 : 0.0f;
    }
    sq += d0 * d0 + d1 * d1;
  }
  return sq;
}

// The normalised 8 columns from c0 on, packed bf16 (kMasked: 0 from H on).
template <bool kMasked>
__device__ __forceinline__ uint4 norm8(uint4 p8, const float* __restrict__ w,
                                       const float* __restrict__ b, int c0,
                                       int H, float mean, float rstd) {
  float wv[8], bv[8];
  if (!kMasked) {
    const float4 w0 = __ldg(reinterpret_cast<const float4*>(w + c0));
    const float4 w1 = __ldg(reinterpret_cast<const float4*>(w + c0 + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + c0));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + c0 + 4));
    wv[0] = w0.x, wv[1] = w0.y, wv[2] = w0.z, wv[3] = w0.w;
    wv[4] = w1.x, wv[5] = w1.y, wv[6] = w1.z, wv[7] = w1.w;
    bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
    bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      wv[k] = c0 + k < H ? __ldg(w + c0 + k) : 0.0f;
      bv[k] = c0 + k < H ? __ldg(b + c0 + k) : 0.0f;
    }
  }
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&p8);
  uint4 y8;
  __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(&y8);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 r = __bfloat1622float2(p2[j]);
    float y0 = (r.x - mean) * rstd * wv[2 * j] + bv[2 * j];
    float y1 = (r.y - mean) * rstd * wv[2 * j + 1] + bv[2 * j + 1];
    if (kMasked) {
      y0 = c0 + 2 * j < H ? y0 : 0.0f;
      y1 = c0 + 2 * j + 1 < H ? y1 : 0.0f;
    }
    y2[j] = __floats2bfloat162_rn(y0, y1);
  }
  return y8;
}

template <int kUnroll>
__global__ void __launch_bounds__(kThreads, S1_MIN_BLOCKS)
    swiglu_ln_kernel(const __nv_bfloat16* __restrict__ h12,
                     const float* __restrict__ w, const float* __restrict__ b,
                     __nv_bfloat16* __restrict__ out, long long M, int H,
                     int Hs, float eps) {
  extern __shared__ uint4 smem[];  // p, Hs / 8 vectors a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = Hs >> 3;   // vectors a half
  const int full = H >> 3;  // vectors wholly inside the real columns
  uint4* prow = smem + warp * nv;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < M;
       row += (long long)gridDim.x * kWarps) {
    const uint4* gate = reinterpret_cast<const uint4*>(h12) + row * 2 * nv;
    const uint4* value = gate + nv;
    float sum = 0.0f;
    for (int v0 = lane; v0 < nv; v0 += 32 * kUnroll) {
      uint4 g8[kUnroll], v8[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < nv) {
          g8[u] = __ldcs(gate + v);
          v8[u] = __ldcs(value + v);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = v0 + 32 * u;
        if (v < full)
          prow[v] = glue8<false>(g8[u], v8[u], 8 * v, H, sum);
        else if (v < nv)
          prow[v] = glue8<true>(g8[u], v8[u], 8 * v, H, sum);
      }
    }
    const float mean = warp_sum(sum) / (float)H;
    float sq = 0.0f;
    for (int v = lane; v < nv; v += 32)
      sq += v < full ? centred8<false>(prow[v], 8 * v, H, mean)
                     : centred8<true>(prow[v], 8 * v, H, mean);
    const float rstd = rsqrtf(warp_sum(sq) / (float)H + eps);
    uint4* dst = reinterpret_cast<uint4*>(out) + row * nv;
    for (int v = lane; v < nv; v += 32)
      dst[v] = v < full ? norm8<false>(prow[v], w, b, 8 * v, H, mean, rstd)
                        : norm8<true>(prow[v], w, b, 8 * v, H, mean, rstd);
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// h12 [M, 2 Hs] bf16, out [M, Hs] bf16, weight and bias [H] f32, all
// contiguous from 16-byte-aligned bases; Hs a multiple of 8, H <= Hs, and
// 16 Hs bytes of shared memory a block (Hs up to 14,528 on Hopper).
int swiglu_ln(const void* h12, const void* w, const void* b, void* out,
              long long M, int H, int Hs, float eps, void* stream) {
  if (((uintptr_t)h12 | (uintptr_t)w | (uintptr_t)b | (uintptr_t)out) %
          16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (M < 0 || H <= 0 || Hs < H || Hs % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const size_t smem = (size_t)kWarps * Hs * 2;
  auto kernel = swiglu_ln_kernel<S1_UNROLL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (M + kWarps - 1) / kWarps;  // the kernel loops past
  kernel<<<(unsigned)(blocks < 0x7fffffffLL ? blocks : 0x7fffffffLL),
           kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h12, (const float*)w, (const float*)b,
      (__nv_bfloat16*)out, M, H, Hs, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
