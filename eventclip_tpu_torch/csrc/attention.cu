// Fused-qkv multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel eventclip_tpu/ops/attention.py::_qkv_attention_forward
// (kernel body _qkv_kernel). Input qkv [B, S, 3D] (q | k | v column blocks,
// head h at columns h*dh .. h*dh+dh of each block), optional additive f32
// mask [S, S]; output [B, S, D] with the same head columns. Per head, in the
// TPU kernel's order:
//   s = (q . k^T) in f32, then * scale (after the dot, not before), + mask;
//   p = exp(s - rowmax) / rowsum over the whole row (no online softmax);
//   p is rounded to the input dtype, then o = p @ v accumulated in f32 and
//   rounded to the output dtype.
// Heads are read straight out of their dh-wide columns: no [B, H, S, dh]
// relayout is ever written.
//
// Design (simple and right first): one block per (batch, head, tile of 64
// query rows). The block stages that head's K (rows padded by one 32-bit
// word so lanes reading different keys hit different banks) and V in shared
// memory. Each warp takes 4 query rows at a time, so every K or V element
// it loads from shared memory feeds 4 rows: lanes own keys for the scores
// (full f32 row kept in shared memory), then own output columns for p @ v.
// All arithmetic runs on the CUDA cores in f32.
//
// Bound on this card: bytes. A ViT-L/14 layer at B = 320 views,
// S = 257, 16 heads of dh 64 does 4*B*H*S^2*dh = 86.6 GFLOP and moves
// B*S*4D*2 bytes = 673 MB in bf16: 87.6 us at 989 TFLOP/s of bf16 tensor
// cores against 201 us at 3.35 TB/s, so the bytes bound the ideal kernel.
// This one runs its products on the CUDA cores (67 TFLOP/s of f32) and
// re-reads K and V once per query tile, so it sits far from either bound;
// wgmma tiles, TMA staging and an online softmax are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // query rows per block
constexpr int kRowsPerWarp = 4; // rows a warp carries at once

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

// K rows are padded by one 32-bit word: lane j reads row j, and the padding
// puts consecutive rows in consecutive banks
template <typename T, int DH>
struct Layout {
  static constexpr int kStride = DH + (int)(4 / sizeof(T));
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <typename T, int DH>
__host__ __device__ inline size_t smem_bytes(int S, int nwarps) {
  return align16((size_t)S * Layout<T, DH>::kStride * sizeof(T)) +
         align16((size_t)S * DH * sizeof(T)) +
         align16((size_t)nwarps * kRowsPerWarp * DH * sizeof(float)) +
         (size_t)nwarps * kRowsPerWarp * S * sizeof(float);
}

template <typename T, int DH>
__global__ void qkv_attention_kernel(const T* __restrict__ qkv,
                                     const float* __restrict__ mask,
                                     T* __restrict__ out, int S, int heads,
                                     int tiles, float scale) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = Layout<T, DH>::kStride;
  constexpr int NACC = (DH + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const int D = heads * DH;
  const size_t row_stride = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * S * row_stride;

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16((size_t)S * KS * sizeof(T)));
  float* qs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Vs) + align16((size_t)S * DH * sizeof(T)));
  float* ps = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(qs) +
      align16((size_t)nwarps * R * DH * sizeof(float)));
  float* q_w = qs + (size_t)warp * R * DH;  // this warp's R query rows
  float* p_w = ps + (size_t)warp * R * S;   // this warp's R score rows

  // stage this head's K and V (row by row, dh contiguous elements each)
  for (int idx = threadIdx.x; idx < S * DH; idx += blockDim.x) {
    const int s = idx / DH, d = idx % DH;
    const T* row = base + (size_t)s * row_stride + h * DH + d;
    Ks[s * KS + d] = row[D];
    Vs[s * DH + d] = row[2 * D];
  }
  __syncthreads();

  const int tile_start = tile * kTileRows;
  const int tile_end = min(tile_start + kTileRows, S);
  for (int i0 = tile_start + warp * R; i0 < tile_end; i0 += nwarps * R) {
    // this group's query rows, f32 (rows past the end read as zeros)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      for (int d = lane; d < DH; d += 32)
        q_w[r * DH + d] =
            i < S ? to_f32(base[(size_t)i * row_stride + h * DH + d]) : 0.f;
    }
    __syncwarp();

    // scores: lanes own keys
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
      const T* krow = Ks + j * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = to_f32(krow[d]);
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = fmaf(q_w[r * DH + d], kv, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // scale after the dot, as the TPU kernel does; _rn keeps the
        // multiply and the mask add two separately rounded operations
        float s = __fmul_rn(dot[r], scale);
        if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)min(i0 + r, S - 1) * S + j]);
        p_w[r * S + j] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
    // softmax over the whole row: exp(-inf - m) = 0 for masked keys, and
    // m is finite whenever the row has one finite score (the causal
    // diagonal), so no inf - inf arises
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = warp_max(mx[r]);
      float sum = 0.f;
      for (int j = lane; j < S; j += 32) {
        const float e = expf(p_w[r * S + j] - mx[r]);
        p_w[r * S + j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      // p rounded to the input dtype before p @ v
      for (int j = lane; j < S; j += 32)
        p_w[r * S + j] = to_f32(from_f32<T>(p_w[r * S + j] / sum));
    }
    __syncwarp();

    // o = p @ v: lanes own output columns
    float acc[R][NACC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[r][a] = 0.f;
    for (int j = 0; j < S; ++j) {
      float vv[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int d = lane + 32 * a;
        vv[a] = d < DH ? to_f32(Vs[j * DH + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = p_w[r * S + j];
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[r][a] = fmaf(p, vv[a], acc[r][a]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i >= S) break;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int d = lane + 32 * a;
        if (d < DH)
          out[((size_t)b * S + i) * D + h * DH + d] = from_f32<T>(acc[r][a]);
      }
    }
    __syncwarp();  // q_w / p_w are rewritten by the next group
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, const float* mask, void* out, int B, int S,
                   int heads, float scale, cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int nwarps = 8;
  while (nwarps > 1 && smem_bytes<T, DH>(S, nwarps) > (size_t)limit) nwarps /= 2;
  const size_t smem = smem_bytes<T, DH>(S, nwarps);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;  // K and V alone too big
  auto kernel = qkv_attention_kernel<T, DH>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)B * heads * tiles;
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, nwarps * 32, smem, stream>>>(
      (const T*)qkv, mask, (T*)out, S, heads, tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* qkv, const float* mask, void* out, int B,
                        int S, int heads, int dh, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(qkv, mask, out, B, S, heads, scale, s);
    case 32: return launch<T, 32>(qkv, mask, out, B, S, heads, scale, s);
    case 64: return launch<T, 64>(qkv, mask, out, B, S, heads, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. mask: f32 [S, S] or null.
int qkv_attention_fwd(const void* qkv, const void* mask, void* out, int B,
                      int S, int heads, int dh, int dtype, float scale,
                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(qkv, m, out, B, S, heads, dh, scale, s);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(qkv, m, out, B, S, heads, dh, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
