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
// row, a head and a batch (attn::Strides), so both layouts run the same
// kernels; heads are read straight out of their columns and no relayout is
// ever written. Optional additive f32 mask [S, S]. Per head, in the TPU
// kernels' order:
//   s = (q . k^T) in f32, then * scale (after the dot, not before), + mask;
//   p = exp(s - rowmax) / rowsum over the whole row (no online softmax of
//       the output: p is normalised before it is rounded);
//   p is rounded to the input dtype, then o = p @ v accumulated in f32 and
//   rounded to the output dtype.
//
// Bound on this card: bytes. A ViT-L/14 layer at B = 320 views, S = 257,
// 16 heads of dh 64 does 4*B*H*S^2*dh = 86.6 GFLOP and moves B*S*4D*2 bytes
// = 673 MB in bf16: 87.6 us at 989 TFLOP/s of bf16 tensor cores against
// 201 us at 3.35 TB/s.
//
// Two kernels, chosen by dtype (never one for the other's input):
//
// bf16: attention_tc_kernel, on the tensor cores. The TPU kernel's products
// are bf16 x bf16 summed in f32, which is what mma.sync m16n8k16 computes,
// and it rounds p to bf16 before p @ v, which is what an A operand takes.
// One block per (batch, head, 64 query rows), 4 warps of 16 rows. The Q
// tile is copied once (cp.async) and stays in shared memory, read as A
// fragments by ldmatrix; K and V stream through a 2-stage cp.async ring of
// 64-key tiles (rows padded to dh + 8, 46 KB of shared memory at dh 64),
// so any S runs. Registers, not shared memory, bound how many warps share
// an SM, so the kernel holds no fragment it can reload. Pass 1 forms the
// scores with mma.sync and keeps each row's max and the sum of
// exp(s - max), rescaled as the max grows; pass 2 recomputes the scores,
// forms p = exp(s - max) / sum in f32 (as __expf times the sum's rounded
// reciprocal: the approximation attention_common.cuh bounds), rounds it to
// bf16 straight into A fragments (the accumulator-to-fragment register
// trick: p never goes to shared memory) and accumulates o += p . v with V
// read transposed by ldmatrix. Three products where two are the least; the kernel is bound by
// bytes, so the recompute is cheap. Keys past S in the ragged last tile
// are zeros in shared memory and -inf in the scores; whole 16-key steps
// past S are skipped.
// Time at [320, 257, 3072] bf16 (chip_smoke.py, H100 80GB HBM3, 700.00 W):
// 1.2369 ms, against 6.5578 ms for the CUDA-core kernel below when it also
// ran bf16, and 0.5657 ms for torch's scaled_dot_product_attention.
//
// f32 (the text tower, [101, 77, 2304] causal on the serving path):
// attention_f32_kernel, on the CUDA cores, kept to 1e-5 / a norm-relative
// 1e-6 of the plain version (tensor cores would mean TF32). Its bound at
// the text shape is both: 95.6 MB of qkv and out, 0.0285 ms at 3.35 TB/s,
// and 1.84 GFLOP, 0.0275 ms at 67 TFLOP/s of f32 FMAs. What held the
// earlier CUDA-core kernel back, and what this one does about it:
//   - shared-memory loads, not FMAs, set the pace (under one FMA per load):
//     each thread computes a 4 x 4 register micro-tile, of scores and then
//     of p . v, fed by 16-byte loads from padded, conflict-free rows: 8
//     loads for 64 FMAs (each LDS.128 feeds 8 FMAs);
//   - lanes owned keys, so 77 keys idled 19% of the lanes: a warp covers
//     16 rows x 32 keys, and a warp whose 32 keys are all past S skips;
//   - K and V were staged again for every 64-row tile, 4 bytes and an
//     integer divide at a time: a block takes all of a head's rows where
//     they fit (77 rows: one block of 80) and K and V stream once through
//     a 2-stage cp.async ring of 64-key tiles, 16 bytes a copy;
//   - the whole head had to fit in shared memory (S >= 436 was refused):
//     only a block's score rows stay, so S runs up to about 3,000 at dh 64
//     (16 rows of S scores beside the tiles).
// The softmax takes the whole row, as the plain version: p = expf(s - max)
// (not __expf), and o = (p . v) * rcp(sum) with a correctly rounded
// reciprocal, which moves only f32 roundings. The 16-byte copies need
// 16-byte-aligned rows; the towers' fused [B, S, 3D] tensors always have
// them (ops/attention.py checks). Times in PERF.md.

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: CUDA cores, register-blocked

constexpr int kF32Keys = 64;         // keys of one staged K or V tile
constexpr int kF32MaxRows = 96;      // query rows of a block, at most
constexpr int kF32RowStep = 16;      // query rows of one warp-row

// Variants for timing only (kernel_variants.py builds each with -D): the
// rows a block (0: f32_rows picks them), the blocks an SM that
// __launch_bounds__ asks for, and the unrolling of the inner loops.
#ifndef F32_ROWS
#define F32_ROWS 0
#endif
#ifndef F32_MIN_BLOCKS
#define F32_MIN_BLOCKS 2
#endif
#ifndef F32_UNROLL
#define F32_UNROLL 4
#endif
constexpr int kF32Unroll = F32_UNROLL;

// score rows: all keys of the row block (S rounded up to a warp's 32
// keys), padded by 8 words: the 4 x 8 scalar stores of a warp's
// (rows, keys) micro-tile hit 32 distinct banks
__host__ __device__ inline int f32_score_stride(int S) {
  return (S + 31) / 32 * 32 + 8;
}

template <int DH>
__host__ __device__ inline size_t f32_smem_bytes(int rows, int S) {
  return sizeof(float) * ((size_t)rows * kF32Stride<DH> +          // Q
                          2 * (size_t)kF32Keys * kF32Stride<DH> +  // K / V ring
                          (size_t)rows * f32_score_stride(S) +     // scores
                          rows);                                   // 1 / sums
}

// One block per (batch, head, `rows` query rows), rows a multiple of 16,
// 4 * rows threads. The Q rows are copied once; K, then V, stream through
// a 2-stage cp.async ring of 64-key tiles.
//   scores: warp-row wr (16 rows) x warp-col wc (32 keys of the tile); lane
//     (rg = lane / 8, kg = lane % 8) holds the 4 x 4 micro-tile of rows
//     wr*16 + rg + 4i and keys wc*32 + kg + 8u; per 4 columns of the head
//     dim it loads 4 float4 of Q and 4 of K (8 shared loads) for 64 FMAs.
//     s = fl(dot * scale) (+ mask) goes to the block's score rows.
//   softmax: 4 threads a row, over the whole row: p = expf(s - max) in
//     place, and 1 / sum correctly rounded.
//   o = p . v: thread t < rows * DH / 16 holds rows rg + (rows / 4) i and
//     columns 4 cg .. 4 cg + 3 (rg = t / (DH/4), cg = t % (DH/4)); per 4
//     keys it loads 4 float4 of p and 4 of V for 64 FMAs; o * (1 / sum)
//     is stored.
// At most 80 registers a thread (__launch_bounds__), so two blocks of 80
// rows (320 threads) share an SM, as their shared memory allows; the inner
// loops are unrolled 4 times. The rows a block, one block an SM (more
// registers) and loops not unrolled are timed against this by
// kernel_variants.py (PERF.md).
// Each dot sums its head dim in order and each output its keys in order.
template <int DH>
__global__ void __launch_bounds__(4 * kF32MaxRows, F32_MIN_BLOCKS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ mask, float* __restrict__ out,
                     Strides in, Strides os, int S, int heads, int tiles,
                     int rows, float scale) {
  constexpr int QS = kF32Stride<DH>;
  constexpr int TILE = kF32Keys * QS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int PS = f32_score_stride(S);
  float* Qs = reinterpret_cast<float*>(smem);
  float* ring = Qs + (size_t)rows * QS;  // 2 stages
  float* Ps = ring + 2 * TILE;
  float* Ls = Ps + (size_t)rows * PS;  // 1 / row sum

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const int r0 = tile * rows;
  const int chunks = (S + kF32Keys - 1) / kF32Keys;

  // scores: this lane's rows (block-local) and keys (tile-local)
  const int wr = warp / 2, wc = warp % 2;
  const int srow = wr * kF32RowStep + lane / 8;   // + 4i
  const int skey = wc * 32 + lane % 8;            // + 8u
  const bool srows_live = r0 + wr * kF32RowStep < S;
  // p . v: this thread's output micro-tile
  const int ntile = rows * DH / 16;
  const bool pv_live = (int)threadIdx.x < ntile;
  const int rg = threadIdx.x / (DH / 4), cg = threadIdx.x % (DH / 4);
  const int rq = rows / 4;  // row step of the micro-tile: rg + rq * i

  // step st < chunks: K tile st; then V tile st - chunks; stage st % 2
  auto issue = [&](int st) {
    const bool is_k = st < chunks;
    const int c = is_k ? st : st - chunks;
    load_f32_tile<DH>(ring + (st & 1) * TILE, is_k ? k : v, in, b, h,
                      c * kF32Keys, kF32Keys, S);
    cp_async_commit();
  };
  load_f32_tile<DH>(Qs, q, in, b, h, r0, rows, S);
  cp_async_commit();
  issue(0);

  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

  for (int st = 0; st < 2 * chunks; ++st) {
    if (st + 1 < 2 * chunks) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* T = ring + (st & 1) * TILE;
    if (st < chunks) {
      const int j0 = st * kF32Keys;
      if (srows_live && j0 + wc * 32 < S) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll (kF32Unroll)
        for (int d = 0; d < DH; d += 4) {
          float4 a[4], kb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(Qs + (srow + 4 * i) * QS + d);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            kb[u] = *reinterpret_cast<const float4*>(T + (skey + 8 * u) * QS + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][u] = fmaf(a[i].x, kb[u].x, acc[i][u]);
              acc[i][u] = fmaf(a[i].y, kb[u].y, acc[i][u]);
              acc[i][u] = fmaf(a[i].z, kb[u].z, acc[i][u]);
              acc[i][u] = fmaf(a[i].w, kb[u].w, acc[i][u]);
            }
        }
        // scale after the dot, as the TPU kernel does; _rn keeps the
        // multiply and the mask add two separately rounded operations
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = srow + 4 * i, qi = min(r0 + row, S - 1);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = j0 + skey + 8 * u;
            float s = __fmul_rn(acc[i][u], scale);
            if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)qi * S + min(j, S - 1)]);
            Ps[row * PS + j] = s;
          }
        }
      }
      if (st == chunks - 1) {
        __syncthreads();  // every score is in place
        // softmax over the whole row: exp(-inf - m) = 0 for masked keys,
        // and m is finite whenever the row has one finite score (the
        // causal diagonal), so no inf - inf arises; keys S .. S+3 rounded
        // to 4 read as p = 0 in p . v
        const int row = threadIdx.x / 4, part = threadIdx.x % 4;
        float* pr = Ps + row * PS;
        float m = -INFINITY;
        for (int j = part; j < S; j += 4) m = fmaxf(m, pr[j]);
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float sum = 0.f;
        for (int j = part; j < S; j += 4) {
          const float e = expf(pr[j] - m);
          pr[j] = e;
          sum += e;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) Ls[row] = __frcp_rn(sum);
        if (S % 4 != 0 && part >= S % 4) pr[S / 4 * 4 + part] = 0.f;
      }
    } else if (pv_live) {
      const int j0 = (st - chunks) * kF32Keys;
      const int n = min(kF32Keys, (S + 3) / 4 * 4 - j0);  // rows past S are zeros
#pragma unroll (kF32Unroll)
      for (int jj = 0; jj < n; jj += 4) {
        float4 p[4], vb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = *reinterpret_cast<const float4*>(Ps + (rg + rq * i) * PS + j0 + jj);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vb[u] = *reinterpret_cast<const float4*>(T + (jj + u) * QS + 4 * cg);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pu[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            o[i][0] = fmaf(pu[u], vb[u].x, o[i][0]);
            o[i][1] = fmaf(pu[u], vb[u].y, o[i][1]);
            o[i][2] = fmaf(pu[u], vb[u].z, o[i][2]);
            o[i][3] = fmaf(pu[u], vb[u].w, o[i][3]);
          }
        }
      }
    }
    __syncthreads();  // stage st % 2 is refilled by the next issue
  }
  if (pv_live) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = r0 + rg + rq * i;
      const float l = Ls[rg + rq * i];
      if (qi < S)
        *reinterpret_cast<float4*>(out + at(os, b, h, qi) + 4 * cg) =
            make_float4(o[i][0] * l, o[i][1] * l, o[i][2] * l, o[i][3] * l);
    }
  }
}

// The query rows of a block: a multiple of 16, at most 96, whose shared
// memory fits in half an SM (two blocks an SM) if that allows 32 rows,
// else in a whole block's limit; the head's rows are then split evenly
// over as few blocks as that allows (77 rows: one block of 80). A build
// with F32_ROWS > 0 takes that many instead (0 if they do not fit).
template <int DH>
int f32_rows(int S, int limit) {
  static_assert(F32_ROWS % kF32RowStep == 0 && F32_ROWS <= kF32MaxRows,
                "F32_ROWS: a multiple of 16 up to 96");
  if (F32_ROWS > 0)
    return f32_smem_bytes<DH>(F32_ROWS, S) <= (size_t)limit ? F32_ROWS : 0;
  const int half = (limit + 1024) / 2 - 1024;
  int most = 0;
  const int budgets[2] = {half, limit};
  for (int budget : budgets) {
    most = 0;
    for (int r = kF32MaxRows; r >= kF32RowStep && most == 0; r -= kF32RowStep)
      if (f32_smem_bytes<DH>(r, S) <= (size_t)budget) most = r;
    if (most >= 2 * kF32RowStep) break;
  }
  if (most == 0) return 0;
  const int blocks = (S + most - 1) / most;
  const int per = (S + blocks - 1) / blocks;
  return (per + kF32RowStep - 1) / kF32RowStep * kF32RowStep;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int S, int heads,
                   Strides in, Strides os, float scale, cudaStream_t stream) {
  if (!rows_aligned16(q, in, 4) || !rows_aligned16(k, in, 4) ||
      !rows_aligned16(v, in, 4) || !rows_aligned16(out, os, 4))
    return cudaErrorMisalignedAddress;
  if (B == 0 || S == 0) return cudaSuccess;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int rows = f32_rows<DH>(S, limit);
  if (rows == 0) return cudaErrorInvalidValue;  // 16 score rows too big
  const size_t smem = f32_smem_bytes<DH>(rows, S);
  auto kernel = attention_f32_kernel<DH>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + rows - 1) / rows;
  const long long blocks = (long long)B * heads * tiles;
  kernel<<<(unsigned)blocks, 4 * rows, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (float*)out, in,
      os, S, heads, tiles, rows, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores

template <int DH>
constexpr size_t tc_smem_bytes() {
  return 5 * TcTile<DH>::kElems * sizeof(bf16);  // Q, 2 x K, 2 x V
}

// At most 128 registers a thread, so 4 blocks (16 warps) share an SM: the
// kernel is bound by how many warps hide each other's latency, and on the
// card 4 blocks at 128 registers (a few bytes spilled) ran faster than 3 at
// 148 or 2 at 212.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 4)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ mask,
                    bf16* __restrict__ out, Strides in, Strides os, int S,
                    int heads, int tiles, float scale) {
  constexpr int TILE = TcTile<DH>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const int r0 = tile * kTcRows, w0 = warp * 16;
  const int i_lo = r0 + w0 + lane / 4;  // this lane's rows: i_lo, i_lo + 8
  const bool active = r0 + w0 < S;      // the warp has a row below S
  const int chunks = (S + kTcRows - 1) / kTcRows;

  // step st < chunks: pass 1 over K chunk st; then pass 2 over K and V
  // chunk st - chunks; each step's tiles go to stage st % 2
  auto issue = [&](int st) {
    const int c = st < chunks ? st : st - chunks;
    load_tile<DH>(Ks + (st & 1) * TILE, k, in, b, h, c * kTcRows, S);
    if (st >= chunks) load_tile<DH>(Vs + (st & 1) * TILE, v, in, b, h, c * kTcRows, S);
    cp_async_commit();
  };
  load_tile<DH>(Qs, q, in, b, h, r0, S);
  issue(0);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int st = 0; st < 2 * chunks; ++st) {
    if (st + 1 < 2 * chunks) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = st < chunks ? st : st - chunks, j0 = c * kTcRows;
    if (active) {
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      mma_abt<DH>(sc, Qs, w0, Ks + (st & 1) * TILE, S - j0);
      scores(sc, mask, scale, i_lo, j0, S);
      if (st < chunks) {
        // pass 1: the row max and sum of exp(s - max)
        row_stats(sc, nullptr, m, l, nullptr);
        if (st == chunks - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = __frcp_rn(quad_sum(l[r]));  // from here on, 1 / sum
            if (m[r] == -INFINITY) m[r] = 0.f;
          }
        }
      } else {
        // pass 2: p = exp(s - max) / sum, rounded to bf16 as A fragments
        uint32_t pf[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = __expf(sc[n][e] - m[e >> 1]) * l[e >> 1];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
        mma_ab<DH>(o, pf, Vs + (st & 1) * TILE, S - j0);
      }
    }
    __syncthreads();  // stage st % 2 is refilled by the next issue
  }
  if (active) store_rows<DH>(o, Qs, out, os, b, h, w0, r0, S);
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* mask, void* out, int B, int S, int heads,
                      Strides in, Strides os, float scale,
                      cudaStream_t stream) {
  if (!rows_aligned16(q, in) || !rows_aligned16(k, in) ||
      !rows_aligned16(v, in) || !rows_aligned16(out, os))
    return cudaErrorMisalignedAddress;
  const size_t smem = tc_smem_bytes<DH>();
  auto kernel = attention_tc_kernel<DH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTcRows - 1) / kTcRows;
  const long long blocks = (long long)B * heads * tiles;
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, in,
      os, S, heads, tiles, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(int dtype, const void* q, const void* k,
                        const void* v, const float* mask, void* out, int B,
                        int S, int heads, int dh, Strides in, Strides os,
                        float scale, cudaStream_t s) {
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch<16>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 32: return launch<32>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 64: return launch<64>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 16: return launch_tc<16>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 32: return launch_tc<32>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 64: return launch_tc<64>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel);
// both copy 16-byte pieces: every row start 16-byte aligned, else
// cudaErrorMisalignedAddress. mask: f32 [S, S] or null. in_*: the strides
// of q, k and v; out_*: those of out (see attn::Strides).
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* mask, void* out, int B, int S, int heads, int dh,
                  long long in_batch, long long in_head, long long in_row,
                  long long out_batch, long long out_head, long long out_row,
                  int dtype, float scale, void* stream) {
  const Strides in{in_batch, in_head, in_row}, os{out_batch, out_head, out_row};
  return (int)dispatch_dh(dtype, q, k, v, (const float*)mask, out, B, S, heads,
                          dh, in, os, scale, (cudaStream_t)stream);
}

}  // extern "C"
