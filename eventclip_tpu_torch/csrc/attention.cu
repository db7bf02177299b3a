// Multi-head attention forward for Hopper (sm_90a), in any layout given by
// strides.
//
// Replaces two TPU kernels of eventclip_tpu/ops/attention.py:
//   K2 _qkv_attention_forward (kernel body _qkv_kernel): fused qkv [B, S, 3D]
//      (q | k | v column blocks, head h at columns h*dh .. h*dh+dh of each
//      block) -> [B, S, D] with the same head columns;
//   K4 _attention_forward (kernel body _attn_kernel): q, k, v [B, H, S, dh]
//      -> [B, H, S, dh].
// The launcher takes q, k, v and out pointers with the element strides of a
// row, a head and a batch (attn::Strides), so both layouts run this one
// kernel; heads are read straight out of their columns and no relayout is
// ever written. Optional additive f32 mask [S, S]. Per head, in the TPU
// kernels' order:
//   s = (q . k^T) in f32, then * scale (after the dot, not before), + mask;
//   p = exp(s - rowmax) / rowsum over the whole row (no online softmax);
//   p is rounded to the input dtype, then o = p @ v accumulated in f32 and
//   rounded to the output dtype.
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

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kTileRows = 64;   // query rows per block
constexpr int kRowsPerWarp = 4; // rows a warp carries at once

template <typename T, int DH>
__host__ __device__ inline size_t smem_bytes(int S, int nwarps) {
  return align16((size_t)S * Padded<T, DH>::kStride * sizeof(T)) +
         align16((size_t)S * DH * sizeof(T)) +
         align16((size_t)nwarps * kRowsPerWarp * DH * sizeof(float)) +
         (size_t)nwarps * kRowsPerWarp * S * sizeof(float);
}

template <typename T, int DH>
__global__ void attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const float* __restrict__ mask,
                                 T* __restrict__ out, Strides in, Strides os,
                                 int S, int heads, int tiles, float scale) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = Padded<T, DH>::kStride;
  constexpr int NACC = (DH + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);

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
    Ks[s * KS + d] = k[at(in, b, h, s) + d];
    Vs[s * DH + d] = v[at(in, b, h, s) + d];
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
        q_w[r * DH + d] = i < S ? to_f32(q[at(in, b, h, i) + d]) : 0.f;
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
        p_w[r * S + j] = round_to<T>(p_w[r * S + j] / sum);
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
        if (d < DH) out[at(os, b, h, i) + d] = from_f32<T>(acc[r][a]);
      }
    }
    __syncwarp();  // q_w / p_w are rewritten by the next group
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int S, int heads,
                   Strides in, Strides os, float scale, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int nwarps = 8;
  while (nwarps > 1 && smem_bytes<T, DH>(S, nwarps) > (size_t)limit) nwarps /= 2;
  const size_t smem = smem_bytes<T, DH>(S, nwarps);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;  // K and V alone too big
  auto kernel = attention_kernel<T, DH>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)B * heads * tiles;
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, nwarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, mask, (T*)out, in, os, S, heads,
      tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const float* mask, void* out, int B, int S, int heads,
                        int dh, Strides in, Strides os, float scale,
                        cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    case 32: return launch<T, 32>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. mask: f32 [S, S] or null. in_*: the
// strides of q, k and v; out_*: those of out (see attn::Strides).
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* mask, void* out, int B, int S, int heads, int dh,
                  long long in_batch, long long in_head, long long in_row,
                  long long out_batch, long long out_head, long long out_row,
                  int dtype, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  const Strides in{in_batch, in_head, in_row}, os{out_batch, out_head, out_row};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, m, out, B, S, heads, dh, in, os, scale, s);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, m, out, B, S, heads, dh, in, os,
                                     scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
