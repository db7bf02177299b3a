// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu):
// the f32 CUDA-core kernels' helpers, then the bf16 wgmma kernels'.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <map>
#include <mutex>
#include <utility>

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

// One dynamic-shared-memory kernel: raise its limit to `smem` bytes (on
// the current device; a limit already raised that far is not set again,
// which saves a call into libcuda a launch)
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_pair(reinterpret_cast<const void*>(kernel), dev);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = done.find(key);
    if (it != done.end() && it->second >= smem) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    size_t& v = done[key];
    if (v < smem) v = smem;
  }
  return err;
}

// the current device's shared memory a block may opt in to (asked once a
// device: a launch's host time counts at small shapes)
inline cudaError_t smem_limit(int* limit) {
  static int known[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && known[dev] > 0) {
    *limit = known[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && dev < 64) known[dev] = *limit;
  return err;
}

// ---------------------------------------------------------------------------
// cp.async, for the f32 kernels

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
// bf16 kernels on Hopper's asynchronous machinery (attention_wgmma_kernel,
// dq_wgmma_kernel, dkdv_wgmma_kernel): TMA copies tracked by mbarriers,
// products on wgmma, and the softmax steps they share.
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
// Tiles. Every operand tile is 64 rows of one head, [64, DH] bf16, copied
// by TMA from a rank-4 tensor map (DH, S, heads, B) (ops/attention.py
// tma_map) with the swizzle of one row, 2 DH bytes (32, 64 or 128): rows
// past S come in as zeros. A tile is read by wgmma through a shared-memory
// descriptor in one of two ways:
//   K-major: the head dim is the product's k (q . k^T: A = the q rows, B =
//     the k rows); a k-step of 16 is 32 bytes further along the row;
//   MN-major: the rows are k and the head dim is n (p . v: B = the v rows,
//     which 16-bit wgmma transposes through its descriptor, so no copy of
//     v^T is made); a k-step is 16 rows further.
// Fragments of one warp of a warpgroup (lane = 4 g + t, the warp's 16 rows
// from 16 (warp % 4)), the layout of wgmma's f32 accumulator m64nN:
//   acc[n][0..1]: row g, columns 8n + 2t, 8n + 2t + 1; acc[n][2..3]: row
//     g + 8, the same columns;
// and of its register A operand m64k16 (4 regs of 2 bf16): a0 (row g, k 2t,
// 2t+1), a1 (row g+8), a2 (row g, k 2t+8, 2t+9), a3 (row g+8): so the
// accumulator's columns 16s .. 16s+15, rounded, are the A operand of k-step
// s of the next product (acc_to_a): p and ds never go to shared memory.

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;       // rows of one tile: wgmma's m, and a key step
constexpr int kWarpgroup = 128;

template <int DH>
struct Tile {
  static constexpr int kSwizzle = 2 * DH;           // bytes of a row
  static constexpr int kElems = kRows * DH;
  static constexpr int kBytes = kElems * 2;         // 2, 4 or 8 KB
};

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator's columns 16s .. 16s+7 (c0) and 16s+8 .. 16s+15 (c1),
// rounded to bf16, as the A operand of the k-step s of the next product
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// the row-max and row-sum of the 4 lanes that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the MUFU unit (ex2.approx). The kernels take exp(s - m) as
// 2^((s - m) log2 e), as __expf does: s - m is exact near the row max,
// where p is largest (a fused s log2 e - m log2 e rounds m log2 e, which
// raised the kernels' norm-relative error against the plain version at S
// = 4000 on the card)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 8-column blocks of a 64-column tile from column c0 that hold a
// column below S
__device__ __forceinline__ int live_blocks(int S, int c0) {
  return min(8, (S - c0 + 7) / 8);
}

// s = fl(acc * scale) (+ mask[i, j]) for this lane's entries of a 16 x 64
// score tile (rows i_lo and i_lo + 8, columns j0 + 8n + 2t (+1)): the
// scale after the dot and the mask add, each rounded, as the TPU kernels
// do. kTail (the ragged last tile): columns at or past S become -inf.
template <bool kMask, bool kTail>
__device__ __forceinline__ void scale_scores(float sc[8][4], const float* mask,
                                             float scale, int i_lo, int j0,
                                             int S) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + n * 8 + 2 * t + (e & 1);
      float s = __fmul_rn(sc[n][e], scale);
      if (kMask) {
        const int i = min(i_lo + (e >> 1) * 8, S - 1);
        s = __fadd_rn(s, mask[(size_t)i * S + min(j, S - 1)]);
      }
      sc[n][e] = !kTail || j < S ? s : -INFINITY;
    }
}

// One 16 x 64 score tile into the running statistics of this lane's rows
// g and g + 8: the row max m, l = sum exp(s - m) and, with kDp, t = sum dp
// * exp(s - m), l and t rescaled as m grows (only their f32 rounding
// depends on it). Each lane keeps its quad's share of l and t; quad_sum
// gives the row's. A row with no finite score yet keeps m = -inf and adds
// exp(-inf) = 0. kTail: column blocks from `nlive` on (past S, the same in
// the whole warp) are -inf, add 0 and are skipped.
template <bool kTail, bool kDp>
__device__ __forceinline__ void row_stats(const float sc[8][4],
                                          const float (*dp)[4], float m[2],
                                          float l[2], float t[2], int nlive) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float cm = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      if (!kTail || n < nlive) cm = fmaxf(cm, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
    const float mn = fmaxf(m[r], quad_max(cm));
    const float base = mn == -INFINITY ? 0.f : mn;
    float sum = 0.f, tsum = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        if (kTail && n >= nlive) continue;
        const float x = ex2((sc[n][e] - base) * kLog2e);
        sum += x;
        if (kDp) tsum = fmaf(dp[n][e], x, tsum);
      }
    const float f = ex2((m[r] - base) * kLog2e);
    l[r] = l[r] * f + sum;
    if (kDp) t[r] = t[r] * f + tsum;
    m[r] = mn;
  }
}

// -- mbarriers, TMA, named barriers ------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the TMA unit and other threads
// (followed by a __syncthreads)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's arrival, announcing `bytes` of TMA copies to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the barrier's phase of parity `parity` has completed; a wait
// of more than 2^34 cycles (about 10 s) traps, so a fault in the ring's
// accounting ends the kernel with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}
// the swizzled tiles need their 1024-byte-aligned base
__device__ __forceinline__ void check_smem_base(const void* smem) {
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023) != 0) __trap();
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3) into shared memory,
// its bytes counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}
// TMA store of one box from shared memory; rows past the map's S are not
// written
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, "
      "%5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, visible to the TMA unit
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// This thread's warp, as a value the compiler knows to be the same in the
// whole warp (a shuffle from lane 0): branches on it are not divergent, so
// the wgmma after them need no serialising warpgroup arrivals
__device__ __forceinline__ int warp_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
}
// the 128 threads of one warpgroup (named barrier `id`, 1 + the group)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), and the swizzle of the tile (1: 128 bytes,
// 2: 64, 3: 32)
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}
// K-major: k-step kk of rows (8-row groups 8 rows x 2 DH bytes apart)
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* tile, int kk) {
  constexpr uint32_t SW = Tile<DH>::kSwizzle;
  return smem_desc<SW>(smem_u32(tile) + 32 * kk, 16, 8 * SW);
}
// MN-major: k-step kk = rows 16 kk .. 16 kk + 15 as k, the head dim as n
// (the tile's n fits one swizzle atom; its 8-row groups are 8 x 2 DH bytes
// apart, which both offsets give)
template <int DH>
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* tile, int kk) {
  constexpr uint32_t SW = Tile<DH>::kSwizzle;
  return smem_desc<SW>(smem_u32(tile) + 16 * SW * kk, 8 * SW, 8 * SW);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an asynchronous wgmma reads or writes: the compiler may not
// move their reads and writes across this point (so none lands between a
// wgmma and the wait that completes it)
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// d (+)= A . B^T, m64n64k16, A and B K-major in shared memory; accumulate
// 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[8][4], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, m64nNk16 for N = the head dim: A in registers (a rounded
// accumulator), B MN-major in shared memory (transposed by the descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc = a . b^T for a 64-row A tile and a 64-row B tile, both K-major
// (scores q . k^T, dp = g . v^T, and the transposed s^T, dp^T): DH / 16
// k-steps, issued (the caller commits and waits)
template <int DH>
__device__ __forceinline__ void issue_abt(float (&acc)[8][4], const bf16* a,
                                          const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss64(acc, kmajor_desc<DH>(a, kk), kmajor_desc<DH>(b, kk), kk > 0);
}

// acc += frag . tile over the tile's 64 rows (4 k-steps of 16), the tile
// MN-major. A ragged last tile needs no shorter product: its rows past S
// are zeros (TMA) and so is frag there. (A product chosen by the rows left
// would put a branch inside the wgmma pipeline, and ptxas then serialises
// every wgmma of the kernel.)
template <int DH>
__device__ __forceinline__ void issue_ab(float (&acc)[DH / 8][4],
                                         const uint32_t (&frag)[4][4],
                                         const bf16* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(acc, frag[kk], mnmajor_desc<DH>(tile, kk));
}

// Round this warpgroup's 64 x DH accumulator to bf16 into a tile in the
// TMA map's swizzled layout (16-byte piece c of row r at piece c ^ the
// row's bits above 128 bytes, as the map's swizzle places them)
template <int DH>
__device__ __forceinline__ void stage_tile(const float (&acc)[DH / 8][4],
                                           bf16* tile) {
  constexpr uint32_t SW = Tile<DH>::kSwizzle;
  const int lane = threadIdx.x % 32, row = 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t at = (row + 8 * half) * SW + 16 * n + 4 * (lane % 4);
      const uint32_t sw = at ^ (((at >> 7) & (SW / 16 - 1)) << 4);
      *reinterpret_cast<uint32_t*>(base + sw) =
          pack_bf16(acc[n][2 * half], acc[n][2 * half + 1]);
    }
}

// -- tensor maps (host) ------------------------------------------------------

// One tensor map's geometry as ops/attention.py's tma_map / stats_map give
// it: dims (innermost first, elements), byte strides of dims 1..3, the box
// copied (elements), and the swizzle in bytes (0: none)
struct MapGeom {
  long long dims[4], strides[3], box[4], swizzle;
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Encode the map of one operand at `base`; out-of-bounds elements of a box
// read as zeros. The last 64 encodings are kept, keyed by base, geometry
// and type (the caching allocator hands a steady loop the same addresses),
// so a launch of a small shape does not pay libcuda's encoding again.
inline cudaError_t encode_map_uncached(CUtensorMap* map, const void* base,
                                       const MapGeom& g, bool bf16_data);
inline cudaError_t encode_map(CUtensorMap* map, const void* base,
                              const MapGeom& g, bool bf16_data) {
  struct Entry {
    const void* base;
    MapGeom g;
    bool bf16, used;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[64];
  uint64_t hash = (uint64_t)(uintptr_t)base * 0x9E3779B97F4A7C15ull;
  for (long long v : g.dims) hash = (hash ^ (uint64_t)v) * 0x100000001B3ull;
  for (long long v : g.strides) hash = (hash ^ (uint64_t)v) * 0x100000001B3ull;
  Entry& e = cache[(hash >> 32) % 64];
  {
    std::lock_guard<std::mutex> lock(mu);
    if (e.used && e.base == base && e.bf16 == bf16_data &&
        memcmp(&e.g, &g, sizeof(MapGeom)) == 0) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode_map_uncached(map, base, g, bf16_data);
  if (err == cudaSuccess) {
    std::lock_guard<std::mutex> lock(mu);
    e.base = base;
    e.g = g;
    e.bf16 = bf16_data;
    e.map = *map;
    e.used = true;
  }
  return err;
}

inline cudaError_t encode_map_uncached(CUtensorMap* map, const void* base,
                                       const MapGeom& g, bool bf16_data) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], step[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)g.dims[i];
    box[i] = (cuuint32_t)g.box[i];
  }
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)g.strides[i];
  const CUtensorMapSwizzle sw =
      g.swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : g.swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : g.swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, bf16_data ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        4, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The blocks a head's tiles are split over: 1 when the heads alone give
// `per_sm` blocks an SM, else enough that they do, at most one a group of
// `workers` tiles (a small batch, as a tensor-parallel or ZeRO-1 rank's,
// would leave most SMs idle with a block a head)
inline int head_splits(long long heads, int tiles, int workers, int per_sm) {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)per_sm * (dev < 64 ? sms[dev] : 132);
  long long splits = (want + heads - 1) / heads;
  const int most = (tiles + workers - 1) / workers;
  return (int)(splits < 1 ? 1 : splits > most ? most : splits);
}

// Shared memory for `slots` ring slots of `slot_bytes` of tiles (and
// `extra` bytes more each, kept apart), the consumer warpgroups' own tiles
// and the barriers (a full and an empty one a slot, up to 8 more). Layout:
// the slots' tiles, the own tiles, the extras, the barriers, so every tile
// starts on a 1024-byte boundary.
inline size_t ring_smem(int slots, size_t slot_bytes, size_t own_bytes,
                        size_t extra) {
  return (size_t)slots * (slot_bytes + extra) + own_bytes +
         8 * (2 * (size_t)slots + 8);
}

// The ring's slots: every 64-row chunk of the streamed operands when they
// fit in `limit` bytes of shared memory (resident: each chunk copied once
// a block), else as many as fit (streamed), at most `cap` when cap > 0;
// 0 if not even 2 fit
inline int ring_slots(int chunks, size_t slot_bytes, size_t own_bytes,
                      size_t extra, int limit, int cap) {
  int most = chunks;
  if (cap > 0 && cap < most) most = cap;
  while (most > 2 &&
         ring_smem(most, slot_bytes, own_bytes, extra) > (size_t)limit)
    --most;
  return ring_smem(most, slot_bytes, own_bytes, extra) <= (size_t)limit ? most
                                                                        : 0;
}

// the 16-byte alignment TMA needs: every row start of every operand
// (elements of `esize` bytes; bf16 by default); the f32 forward's 16-byte
// cp.async copies need the same
inline bool rows_aligned16(const void* p, const Strides& s, int esize = 2) {
  return ((uintptr_t)p % 16 == 0) && s.batch * esize % 16 == 0 &&
         s.head * esize % 16 == 0 && s.row * esize % 16 == 0;
}

}  // namespace attn
