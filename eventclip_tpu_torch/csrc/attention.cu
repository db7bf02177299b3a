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
// bf16: attention_wgmma_kernel, on Hopper's wgmma with TMA copies. The TPU
// kernel's products are bf16 x bf16 summed in f32, which is what wgmma
// computes, and it rounds p to bf16 before p @ v, which is what a register
// A operand takes. One block per (batch, head), two warpgroups (two blocks
// an SM). One thread copies the head's K and V by TMA (rank-4 tensor maps
// from ops/attention.py tma_map, swizzled by the row's 32 / 64 / 128
// bytes, rows past S read as zeros) in 64-row chunks into a ring of slots
// with mbarriers: when the ring holds every chunk (resident: up to S = 832
// at dh 64) each is copied once a block and both passes of every query
// tile read K from shared memory; otherwise the chunks stream through the
// ring. A warpgroup takes 64-row query tiles (Q by TMA); pass 1 forms s =
// q . k^T (wgmma m64n64k16, both operands K-major in shared memory) and
// each row's max and sum of exp(s - max); pass 2 forms s again, p = exp(s
// - max) * rcp(sum) rounded to bf16 straight from the accumulator into
// the A registers of o += p . v (V MN-major: wgmma transposes it through
// its descriptor); o is rounded once, staged in the swizzled Q tile and
// stored by TMA, which clips the rows past S. 3 products a (query tile,
// key chunk) on 64-row tiles (S = 257 pads to 320 both ways) and 2
// exponentials a score (the row is normalised before p is rounded, so the
// statistics pass cannot be folded into the second): the MUFU unit's
// exponentials and the warpgroups' issue, not bytes, hold it back.
// Time at [320, 257, 3072] bf16 (kernel_variants.py, NVIDIA H100 80GB
// HBM3, 700.00 W): 0.6347 ms, against 1.2198-1.2339 for the warp-level
// tensor-core kernel it replaced and 0.5542 ms for torch's scaled_dot_product_attention
// in the same run (PERF.md).
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
// bf16: wgmma and TMA

// Variants for timing only (kernel_variants.py builds each with -D): the
// consumer warpgroups a block, the query rows a warpgroup takes at once
// (64 or 128: one or two m64 products a step), and a cap on the ring's
// slots (0: as many as fit, so a head whose K and V fit is resident; a cap
// below its chunks streams them through that many slots).
#ifndef WGF_CONSUMERS
#define WGF_CONSUMERS 2
#endif
#ifndef WGF_ROWS
#define WGF_ROWS 64
#endif
#ifndef WGF_STAGES
#define WGF_STAGES 0
#endif
static_assert(WGF_ROWS == 64 || WGF_ROWS == 128, "WGF_ROWS: 64 or 128");
static_assert(WGF_CONSUMERS >= 1 && WGF_CONSUMERS <= 4,
              "WGF_CONSUMERS: 1 to 4 warpgroups");
constexpr int kConsumers = WGF_CONSUMERS;
constexpr int kMt = WGF_ROWS / kRows;  // m64 tiles of one warpgroup
// no producer warp: one thread of the first warpgroup issues the copies,
// so two blocks of two warpgroups share an SM at 128 registers a thread (a
// ninth warp cut them, with spills)
constexpr int kFwdThreads = kConsumers * kWarpgroup;
// two blocks an SM while the registers allow (a block's K and V at S =
// 257 take 80 KB of shared memory at dh 64)
constexpr int kFwdMinBlocks = kConsumers <= 2 && kMt == 1 ? 2 : 1;

// Pass 1 over one chunk of keys (K tile Kt): s = q . k^T for each m-tile,
// then fl(s * scale) + mask and each row's max m and sum l of exp(s - m).
// kTail: the ragged last chunk (keys past S are -inf).
template <int DH, bool kMask, bool kTail>
__device__ __forceinline__ void stats_step(const bf16* Qs, const bf16* Kt,
                                           float (&m)[kMt][2],
                                           float (&l)[kMt][2],
                                           const int (&i_lo)[kMt],
                                           const float* mask, float scale,
                                           int j0, int S) {
  constexpr int TILE = Tile<DH>::kElems;
  float sc[kMt][8][4];
  wgmma_fence();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) issue_abt<DH>(sc[mt], Qs + mt * TILE, Kt);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    fence_acc(sc[mt]);
    scale_scores<kMask, kTail>(sc[mt], mask, scale, i_lo[mt], j0, S);
    row_stats<kTail, false>(sc[mt], nullptr, m[mt], l[mt], nullptr,
                            live_blocks(S, j0));
  }
}

// Pass 2 over one chunk (K and V tiles at KV): s again, p = exp(s - m) *
// (1 / l) rounded to bf16 into the A registers of o += p . v (V
// MN-major). rl = 1 / l.
template <int DH, bool kMask, bool kTail>
__device__ __forceinline__ void out_step(const bf16* Qs, const bf16* KV,
                                         float (&o)[kMt][DH / 8][4],
                                         const float (&m)[kMt][2],
                                         const float (&rl)[kMt][2],
                                         const int (&i_lo)[kMt],
                                         const float* mask, float scale,
                                         int j0, int S) {
  constexpr int TILE = Tile<DH>::kElems;
  float sc[kMt][8][4];
  wgmma_fence();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) issue_abt<DH>(sc[mt], Qs + mt * TILE, KV);
  wgmma_commit();
  wgmma_wait<0>();
  uint32_t pf[kMt][4][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    fence_acc(sc[mt]);
    // keys past S have s = -inf, so p = 0; rows past S are never stored.
    // No branch here: ptxas merged the A registers of a branch's two sides
    // through local memory in the backward kernels.
    scale_scores<kMask, kTail>(sc[mt], mask, scale, i_lo[mt], j0, S);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[mt][n][e] = ex2((sc[mt][n][e] - m[mt][e >> 1]) * kLog2e) * rl[mt][e >> 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[mt][kk], sc[mt][2 * kk], sc[mt][2 * kk + 1]);
    fence_frag(pf[mt]);
    fence_acc(o[mt]);
  }
  wgmma_fence();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) issue_ab<DH>(o[mt], pf[mt], KV + TILE);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    fence_acc(o[mt]);
    fence_frag(pf[mt]);
  }
}

// One block per (batch, head) of kConsumers warpgroups. One thread (the
// first of warpgroup 0) copies the head's K and V in 64-row chunks by TMA
// into a ring of slots (a K and a V tile each), each slot's arrival
// counted on its full barrier. When the ring holds every chunk (resident)
// each is copied once, at the start, and read by every query tile of the
// head from shared memory; otherwise (streamed) the warpgroups walk the
// chunks in step, a round of kConsumers query tiles at a time, release
// each slot on its empty barrier, and the copying thread refills it with
// the step `slots` ahead once every warpgroup has. A warpgroup takes the
// query tiles wg, wg + kConsumers, ... (kMt x 64 rows each; its Q tile by
// TMA on its own barrier) and for each:
//   pass 1 (stats_step): s = q . k^T (wgmma, both K-major from shared
//     memory), then fl(s * scale) + mask, and each row's max and sum of
//     exp(s - max);
//   pass 2 (out_step): s again, p = exp(s - max) * rcp(sum) rounded to
//     bf16 straight from the accumulator into the A registers of o += p .
//     v (wgmma, V MN-major: transposed by its descriptor);
// o is rounded once to bf16 into the Q tile's shared memory and stored by
// TMA, which clips the rows past S. kMask: the additive [S, S] mask.
template <int DH, bool kMask>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mo,
                       const float* __restrict__ mask, int S, int heads,
                       int slots, float scale) {
  constexpr int TILE = Tile<DH>::kElems;
  constexpr unsigned kBytes = Tile<DH>::kBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* ring = reinterpret_cast<bf16*>(wg_smem);   // slots x (K, V)
  bf16* own = ring + (size_t)slots * 2 * TILE;  // kConsumers x kMt Q tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(own + kConsumers * kMt * TILE);
  uint64_t* empty = full + slots;
  uint64_t* qbar = empty + slots;  // one a warpgroup

  // no split of a head over blocks, as the backward kernels have for small
  // batches: its runtime tile mapping cost this kernel 7% at the serving
  // shape (kernel_variants.py compare), and two warpgroups a head already
  // fill the card at a tensor-parallel or ZeRO-1 rank's batch
  const int h = blockIdx.x % heads, b = blockIdx.x / heads;
  const int chunks = (S + kRows - 1) / kRows;
  const int tiles = (S + kMt * kRows - 1) / (kMt * kRows);
  const int rounds = (tiles + kConsumers - 1) / kConsumers;
  const bool resident = slots >= chunks;
  // streamed: each round, K chunks for pass 1, then K and V for pass 2
  const int steps = resident ? chunks : rounds * 2 * chunks;
  const int warp = warp_index(), lane = threadIdx.x % 32;
  const int wg = warp / 4, wt = threadIdx.x % kWarpgroup, w16 = 16 * (warp % 4);
  const bool copier = threadIdx.x == 0;

  check_smem_base(wg_smem);
  if (copier) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(&qbar[w], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the copy of ring step `step` into slot step % slots
  auto copy = [&](int step) {
    const int slot = step % slots, within = step % (2 * chunks);
    const int j = within % chunks;
    const bool with_v = resident || within >= chunks;
    bf16* kv = ring + (size_t)slot * 2 * TILE;
    mbar_expect_tx(&full[slot], (with_v ? 2 : 1) * kBytes);
    tma_load(kv, &mk, &full[slot], 0, j * kRows, h, b);
    if (with_v) tma_load(kv + TILE, &mv, &full[slot], 0, j * kRows, h, b);
  };
  if (copier)
    for (int step = 0; step < min(slots, steps); ++step) copy(step);

  bf16* Qs = own + (size_t)wg * kMt * TILE;
  int st = 0;  // ring steps taken (streamed)
  unsigned qphase = 0;
  // a streamed step done: release its slot; the copier refills it with
  // the step `slots` ahead once every warpgroup has released it (its whole
  // warp waits, so no wgmma follows a branch that splits a warp)
  auto release = [&](int slot) {
    mbar_arrive(&empty[slot]);
    if (warp == 0 && st + slots < steps) {
      mbar_wait(&empty[slot], (st / slots) & 1);
      if (copier) copy(st + slots);
    }
    ++st;
  };
  for (int r = 0; r < rounds; ++r) {
    const int t = r * kConsumers + wg;
    if (t >= tiles) {
      // no tile left for this warpgroup; a streamed ring still waits for
      // its release of every slot
      if (!resident)
        for (int step = 0; step < 2 * chunks; ++step) {
          mbar_wait(&full[st % slots], (st / slots) & 1);
          release(st % slots);
        }
      continue;
    }
    const int r0 = t * kMt * kRows;
    if (wt == 0) {
      mbar_expect_tx(&qbar[wg], kMt * kBytes);
      for (int mt = 0; mt < kMt; ++mt)
        tma_load(Qs + mt * TILE, &mq, &qbar[wg], 0, r0 + mt * kRows, h, b);
    }
    mbar_wait(&qbar[wg], qphase);
    qphase ^= 1;

    // m-tile mt: this lane's rows i_lo(mt) and i_lo(mt) + 8
    float m[kMt][2], l[kMt][2];
    int i_lo[kMt];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      i_lo[mt] = r0 + mt * kRows + w16 + lane / 4;
      m[mt][0] = m[mt][1] = -INFINITY;
      l[mt][0] = l[mt][1] = 0.f;
    }

    for (int j = 0; j < chunks; ++j) {  // pass 1
      const int slot = resident ? j : st % slots, j0 = j * kRows;
      mbar_wait(&full[slot], resident ? 0 : (st / slots) & 1);
      const bf16* Kt = ring + (size_t)slot * 2 * TILE;
      if (j0 + kRows <= S)
        stats_step<DH, kMask, false>(Qs, Kt, m, l, i_lo, mask, scale, j0, S);
      else
        stats_step<DH, kMask, true>(Qs, Kt, m, l, i_lo, mask, scale, j0, S);
      if (!resident) release(slot);
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[mt][e] = __frcp_rn(quad_sum(l[mt][e]));  // from here on, 1 / sum
        if (m[mt][e] == -INFINITY) m[mt][e] = 0.f;
      }

    float o[kMt][DH / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    for (int j = 0; j < chunks; ++j) {  // pass 2
      const int slot = resident ? j : st % slots, j0 = j * kRows;
      mbar_wait(&full[slot], resident ? 0 : (st / slots) & 1);
      const bf16* KV = ring + (size_t)slot * 2 * TILE;
      if (j0 + kRows <= S)
        out_step<DH, kMask, false>(Qs, KV, o, m, l, i_lo, mask, scale, j0, S);
      else
        out_step<DH, kMask, true>(Qs, KV, o, m, l, i_lo, mask, scale, j0, S);
      if (!resident) release(slot);
    }

    // o, rounded once, through the Q tiles' shared memory to a TMA store
    warpgroup_sync(1 + wg);  // no product of this warpgroup reads Q now
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) stage_tile<DH>(o[mt], Qs + mt * TILE);
    fence_async_smem();
    warpgroup_sync(1 + wg);
    if (wt == 0) {
      for (int mt = 0; mt < kMt; ++mt)
        tma_store(&mo, Qs + mt * TILE, 0, r0 + mt * kRows, h, b);
      bulk_commit();
      bulk_wait_read();  // before the next Q tile lands in the same place
    }
  }
  if (wt == 0) bulk_wait();
}

// The ring's slots and the block's shared memory for one head of S rows
template <int DH>
int fwd_plan(int S, int limit, size_t* smem) {
  const int chunks = (S + kRows - 1) / kRows;
  const size_t slot = 2 * (size_t)Tile<DH>::kBytes;
  const size_t own = (size_t)kConsumers * kMt * Tile<DH>::kBytes;
  const int slots = ring_slots(chunks, slot, own, 0, limit, WGF_STAGES);
  *smem = ring_smem(slots, slot, own, 0);
  return slots;
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const float* mask, void* out, int B, int S,
                         int heads, Strides in, Strides os, float scale,
                         cudaStream_t stream, const MapGeom* in_geom,
                         const MapGeom* out_geom) {
  if (!rows_aligned16(q, in) || !rows_aligned16(k, in) ||
      !rows_aligned16(v, in) || !rows_aligned16(out, os))
    return cudaErrorMisalignedAddress;
  if (B == 0 || S == 0) return cudaSuccess;
  if (in_geom == nullptr || out_geom == nullptr) return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  size_t smem = 0;
  const int slots = fwd_plan<DH>(S, limit, &smem);
  if (slots == 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if ((err = encode_map(&mq, q, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mk, k, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mv, v, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mo, out, *out_geom, true)) != cudaSuccess)
    return err;
  auto kernel = mask != nullptr ? attention_wgmma_kernel<DH, true>
                                : attention_wgmma_kernel<DH, false>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * heads), kFwdThreads, smem, stream>>>(
      mq, mk, mv, mo, mask, S, heads, slots, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(int dtype, const void* q, const void* k,
                        const void* v, const float* mask, void* out, int B,
                        int S, int heads, int dh, Strides in, Strides os,
                        float scale, cudaStream_t s, const MapGeom* ig,
                        const MapGeom* og) {
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch<16>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 32: return launch<32>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
      case 64: return launch<64>(q, k, v, mask, out, B, S, heads, in, os, scale, s);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 16: return launch_wgmma<16>(q, k, v, mask, out, B, S, heads, in, os, scale, s, ig, og);
      case 32: return launch_wgmma<32>(q, k, v, mask, out, B, S, heads, in, os, scale, s, ig, og);
      case 64: return launch_wgmma<64>(q, k, v, mask, out, B, S, heads, in, os, scale, s, ig, og);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (wgmma kernel, its
// tensor maps' geometry in in_geom / out_geom: attn::MapGeom, from
// ops/attention.py tma_map); both need every row start 16-byte aligned,
// else cudaErrorMisalignedAddress. mask: f32 [S, S] or null. in_*: the
// element strides of q, k and v; out_*: those of out (see attn::Strides).
int attention_fwd(const void* q, const void* k, const void* v,
                  const void* mask, void* out, int B, int S, int heads, int dh,
                  long long in_batch, long long in_head, long long in_row,
                  long long out_batch, long long out_head, long long out_row,
                  int dtype, float scale, void* stream, const void* in_geom,
                  const void* out_geom) {
  const Strides in{in_batch, in_head, in_row}, os{out_batch, out_head, out_row};
  return (int)dispatch_dh(dtype, q, k, v, (const float*)mask, out, B, S, heads,
                          dh, in, os, scale, (cudaStream_t)stream,
                          (const MapGeom*)in_geom, (const MapGeom*)out_geom);
}

// The bf16 forward's plan for one head of S rows on this card: out[0] the
// ring's slots (0: does not fit), out[1] the 64-row chunks of K and V
// (resident when out[0] >= out[1], else streamed), out[2] the block's bytes
// of shared memory.
int attention_fwd_plan(int S, int dh, int* out) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  size_t smem = 0;
  switch (dh) {
    case 16: out[0] = fwd_plan<16>(S, limit, &smem); break;
    case 32: out[0] = fwd_plan<32>(S, limit, &smem); break;
    case 64: out[0] = fwd_plan<64>(S, limit, &smem); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[1] = (S + kRows - 1) / kRows;
  out[2] = (int)smem;
  return 0;
}

}  // extern "C"
