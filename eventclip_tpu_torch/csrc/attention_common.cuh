// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu):
// the f32 CUDA-core kernels' helpers, then the bf16 tensor-core kernels'.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace attn {

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

// ---------------------------------------------------------------------------
// cp.async, shared by the f32 and the bf16 kernels

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy global -> shared that lands asynchronously; with valid false
// nothing is read and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// the same for 4 bytes (row statistics, whose rows are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// f32 tiles of the CUDA-core kernels (attention_f32_kernel, dq_f32_kernel,
// dkdv_f32_kernel): rows of DH floats padded by 4, so the 16-byte loads of
// 4 (Q) or 8 (K) consecutive rows at one column fall in distinct banks, and
// every row stays 16-byte aligned for cp.async

template <int DH>
constexpr int kF32Stride = DH + 4;

// Start the copy of rows r0 .. r0+n-1 of one head's [S, DH] f32 operand
// into a padded tile (rows at or past S become zeros), 16 bytes at a time,
// or with `vec` false (rows not 16-byte aligned) 4 bytes at a time. The
// caller commits the group.
template <int DH>
__device__ __forceinline__ void load_f32_tile(float* dst, const float* src,
                                              const Strides& s, int b, int h,
                                              int r0, int n, int S,
                                              bool vec = true) {
  if (vec) {
    constexpr int P = DH / 4;  // 16-byte pieces a row
    for (int idx = threadIdx.x; idx < n * P; idx += blockDim.x) {
      const int r = idx / P, c = (idx % P) * 4, i = r0 + r;
      cp_async16(dst + r * kF32Stride<DH> + c,
                 src + at(s, b, h, min(i, S - 1)) + c, i < S);
    }
  } else {
    for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
      const int r = idx / DH, c = idx % DH, i = r0 + r;
      cp_async4(dst + r * kF32Stride<DH> + c,
                src + at(s, b, h, min(i, S - 1)) + c, i < S);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core helpers for the bf16 kernels: mma.sync m16n8k16 (bf16 in, f32
// accumulate), ldmatrix and cp.async, in inline PTX.
//
// The products are the TPU kernels' (bf16 x bf16 summed in f32, only the
// order of the f32 sums differs). The softmax is not bit for bit theirs:
// exp is __expf (ex2.approx; at most 2 + 1.173|x| f32 ulps off), and p is
// e * rcp(l) with a correctly rounded reciprocal (within 1.5 ulps of e / l),
// where the TPU and the plain versions take the exact exp and divide. Both
// sit more than 100x below half a bf16 ulp (2^-9) for the scores that give
// p above 2^-20, so they move p's rounding about as rarely as the order of
// the f32 sums does.
//
// Fragments of one warp (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A m16k16 (4 regs of 2 bf16): a0 (row g, cols 2t, 2t+1), a1 (row g+8,
//     same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8..9);
//   B k16n8 (2 regs): b0 (k 2t, 2t+1; col g), b1 (k 2t+8, 2t+9; col g);
//   C m16n8 f32 (4 floats): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g+8, same cols).
// Operands are staged in shared memory as [64, DH] tiles whose rows are
// padded to DH + 8 bf16 elements: every ldmatrix row stays 16-byte aligned,
// and the 8 rows an 8x8 matrix reads fall in 8 different 16-byte bank
// groups (a stride of 36, 20 or 12 words), so no load conflicts.

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;     // rows of one staged tile
constexpr int kTcThreads = 128;  // 4 warps a block, 16 rows each

template <int DH>
struct TcTile {
  static constexpr int kStride = DH + 8;                // padded row
  static constexpr int kElems = kTcRows * kStride;      // one tile
  static constexpr int kPieces = DH / 8;                // 16-byte pieces a row
};

// four 8x8 bf16 matrices; lanes 8m .. 8m+7 give the row addresses of
// matrix m, and register m of each lane receives its piece of matrix m
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b on the tensor cores: bf16 products summed in f32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C tiles of columns 16s .. 16s+7 (c0) and 16s+8 .. 16s+15 (c1), rounded
// to bf16, are the A fragment of the k-step s of the next product: a score
// tile becomes p or ds in registers and never goes to shared memory.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the row-max and row-sum of the 4 lanes that hold one C row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One 16 x 64 score tile into the running statistics of this lane's rows
// i_lo and i_lo + 8: the row max m, l = sum exp(s - m) and, given a dp
// tile, t = sum dp * exp(s - m), l and t rescaled as m grows (only their
// f32 rounding depends on it). Each lane keeps its quad's share of l and
// t; quad_sum gives the row's. A row with no finite score yet keeps m =
// -inf and adds exp(-inf) = 0.
__device__ __forceinline__ void row_stats(const float sc[8][4],
                                          const float (*dp)[4], float m[2],
                                          float l[2], float t[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) cm = fmaxf(cm, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(cm));
    const float base = mn == -INFINITY ? 0.f : mn;
    float sum = 0.f, tsum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float x = __expf(sc[n][e] - base);
        sum += x;
        if (dp != nullptr) tsum = fmaf(dp[n][e], x, tsum);
      }
    const float f = __expf(m[r] - base);
    l[r] = l[r] * f + sum;
    if (dp != nullptr) t[r] = t[r] * f + tsum;
    m[r] = mn;
  }
}

// s = fl(acc * scale) (+ mask[i, j]) for this lane's entries of a 16 x 64
// score tile (query rows i_lo and i_lo + 8, keys j0 + 8n + 2t (+1)): the
// scale after the dot and the mask add, each rounded, as the TPU kernels
// do; keys at or past S become -inf
__device__ __forceinline__ void scores(float sc[8][4], const float* mask,
                                       float scale, int i_lo, int j0, int S) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = min(i_lo + (e >> 1) * 8, S - 1), j = j0 + n * 8 + 2 * t + (e & 1);
      float s = __fmul_rn(sc[n][e], scale);
      if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)i * S + min(j, S - 1)]);
      sc[n][e] = j < S ? s : -INFINITY;
    }
}

// Start the copy of rows r0 .. r0+63 of one head's [S, DH] operand into a
// padded tile (rows at or past S become zeros, so a ragged tail gives finite
// products). The caller commits the group.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const Strides& s, int b, int h,
                                          int r0, int S) {
  constexpr int P = TcTile<DH>::kPieces;
#pragma unroll
  for (int idx = threadIdx.x; idx < kTcRows * P; idx += kTcThreads) {
    const int r = idx / P, c = (idx % P) * 8, i = r0 + r;
    cp_async16(dst + r * TcTile<DH>::kStride + c,
               src + at(s, b, h, min(i, S - 1)) + c, i < S);
  }
}

// acc[n] += a . rows^T: a is this warp's 16 rows (from row w0) of the
// staged tile `a_tile`, the 64 rows of `tile` are B's columns (n-blocks of
// 8 rows; k = the head dim). A is read one k-step at a time rather than held
// in registers across calls: the kernels are bound by registers, not by
// shared-memory loads. N-blocks at or past `valid` rows are skipped (they
// stay as they were).
template <int DH>
__device__ __forceinline__ void mma_abt(float acc[8][4], const bf16* a_tile,
                                        int w0, const bf16* tile, int valid) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, a_tile + (w0 + (lane & 15)) * TcTile<DH>::kStride +
                       kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
      if (n2 * 16 >= valid) break;
      uint32_t b[4];
      ldmatrix_x4(b, tile + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                TcTile<DH>::kStride +
                            kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * n2], a, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// acc[d] += a . tile for the tile's 64 rows as the k dimension (a holds 4
// k-steps of 16 rows) and its DH columns as n: the tile is B, read
// transposed. K-steps at or past `valid` rows are skipped.
template <int DH>
__device__ __forceinline__ void mma_ab(float acc[DH / 8][4],
                                       const uint32_t a[4][4],
                                       const bf16* tile, int valid) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk * 16 >= valid) break;
#pragma unroll
    for (int d2 = 0; d2 < DH / 16; ++d2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) *
                                      TcTile<DH>::kStride +
                               d2 * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * d2], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * d2 + 1], a[kk], b[2], b[3]);
    }
  }
}

// Round this warp's 16 x DH accumulator to bf16, stage it in the warp's
// rows of `tile` and write rows w0 .. w0+15 (those below S) with 16-byte
// stores.
template <int DH>
__device__ __forceinline__ void store_rows(const float acc[DH / 8][4],
                                           bf16* tile, bf16* dst,
                                           const Strides& s, int b, int h,
                                           int w0, int r0, int S) {
  constexpr int KS = TcTile<DH>::kStride, P = TcTile<DH>::kPieces;
  const int lane = threadIdx.x % 32;
  bf16* rows = tile + w0 * KS;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<uint32_t*>(rows + (lane >> 2) * KS + c) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(rows + ((lane >> 2) + 8) * KS + c) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
#pragma unroll
  for (int idx = lane; idx < 16 * P; idx += 32) {
    const int r = idx / P, c = (idx % P) * 8, i = r0 + w0 + r;
    if (i < S)
      *reinterpret_cast<uint4*>(dst + at(s, b, h, i) + c) =
          *reinterpret_cast<const uint4*>(rows + r * KS + c);
  }
}

// the 16-byte alignment the kernels' 16-byte copies need: every row start
// of every operand (elements of `esize` bytes; bf16 by default)
inline bool rows_aligned16(const void* p, const Strides& s, int esize = 2) {
  return ((uintptr_t)p % 16 == 0) && s.batch * esize % 16 == 0 &&
         s.head * esize % 16 == 0 && s.row * esize % 16 == 0;
}

}  // namespace attn
