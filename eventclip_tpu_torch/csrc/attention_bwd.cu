// Multi-head attention backward (recompute) for Hopper (sm_90a), in any
// layout given by strides.
//
// Replaces the TPU kernel eventclip_tpu/ops/attention.py::_bwd_kernel
// (launched by _bwd_pallas_call from _qkv_attention_bwd, fused [B, S, 3D],
// and from _attention_bwd, [B, H, S, dh]). The forward is not stored: p is
// recomputed from q and k. Per head, in the TPU kernel's order:
//   s  = (q . k^T) in f32, * scale after the dot, + mask;
//   p  = exp(s - rowmax) / rowsum, f32 (unrounded);
//   dv = round(p)^T . g          (p rounded to the input dtype, as pq is)
//   dp = g . v^T                 in f32
//   ds = p * (dp - rowsum(dp * p))   with the UNROUNDED p (not
//        FlashAttention's rowsum(g * o): the two agree only without the
//        rounding of p);
//   ds = round(ds * scale);  dq = ds . k,  dk = ds^T . q, f32 sums rounded
//   to the output dtype and written straight into the q/k/v gradients
//   (in the fused layout, the [B, S, 3D] gradient's column blocks).
// The mask's cotangent is not computed here (ops/attention.py does it in
// plain torch when the mask needs a gradient, as _mask_cotangent does).
//
// Bound on this card: bytes. A ViT-L/14 training layer at B = 256 views,
// S = 257, 16 heads of dh 64 needs the TPU kernel's 5 products,
// 10*B*H*S^2*dh = 173 GFLOP (0.175 ms at 989 TFLOP/s of bf16), against
// 943 MB of q, k, v, g in and dq, dk, dv out (0.28 ms at 3.35 TB/s).
//
// The TPU kernel holds q, k, v and g of a head in VMEM at once; here that
// is more than a block's shared memory at S = 577, and the grid has to
// spread over 132 SMs. So the work is split by output into two kernels,
// and no output is summed by atomics: every output element is written by
// one thread, and two runs give the same bits. The first kernel of each
// pair writes each query row's max, sum (the bf16 pair: its reciprocal)
// and rowsum(dp * p) (f32, [3, B*H*S]; the bf16 pair's rows padded to
// whole 64-row boxes) for the second. Two pairs, chosen by dtype (never one for the
// other's input):
//
// bf16: dq_wgmma_kernel and dkdv_wgmma_kernel (below), every product on
// Hopper's wgmma (bf16 in, f32 sums: the TPU kernel's products; its exp
// and divide become ex2.approx of (s - m) log2 e and a multiply by a
// rounded reciprocal, the approximation attention_common.cuh bounds). The
// TPU rounds p and ds to bf16 before the products that take them, which is
// what a register A operand is: a score accumulator becomes that operand
// without a trip through shared memory. Each block owns one (batch, head):
// a producer warp copies the operands the block reads whole by TMA into a
// ring of 64-row slots (resident when they fit: K and V for dq, Q, G and
// the statistics for dk/dv), one consumer warpgroup walks the head's own
// 64-row tiles (two blocks an SM). dq_wgmma_kernel does 5 products a
// (query tile, key chunk): s and dp in a statistics pass, then s, dp and
// ds . k; dkdv_wgmma_kernel 4, on transposed tiles (keys as rows: s^T =
// k . q^T, dp^T = v . g^T), so p^T and ds^T are A operands with no
// shuffle. 9 products where the bound counts 5, and 3 exponentials a
// score. The two kernels' p may differ in the last bits (their sums run in
// other orders); the tolerance against the plain version decides.
// Time at [256, 257, 3072] bf16 + g (kernel_variants.py, NVIDIA H100 80GB
// HBM3, 700.00 W): 1.3533 ms, against 3.2767-3.3114 for the warp-level
// tensor-core kernels it replaced and 1.3528 ms for the backward of torch's
// scaled_dot_product_attention in the same run (PERF.md).
//
// f32: dq_f32_kernel and dkdv_f32_kernel on the CUDA cores (tensor cores
// would mean TF32). They serve the f32 FT path (bf16=False: the visual
// tower's 24 layers at ViT-L/14, once a step each) and any tower trained in
// f32; the forward's f32 kernel is attention.cu's attention_f32_kernel.
// Bound on this card: operations, 10*B*H*S^2*dh at 67 TFLOP/s of f32 FMAs
// (0.41 ms at [8, 577, 3072], against 0.04 ms of bytes). The kernels do 9
// products where the bound counts 5 (dq 5: s and dp twice, ds . k; dk/dv 4).
// What bounds the kernels below the f32 rate, and what the design does:
//   - shared-memory loads: every product is a 4 x 4 register micro-tile fed
//     by 16-byte loads from rows padded by 4 words, 8 loads for 64 FMAs, as
//     in attention_f32_kernel;
//   - shared memory per block, hence blocks an SM: no S-long row is kept.
//     The dq kernel takes online row statistics in a first pass (m, l = sum
//     exp(s - m) and t = sum dp * exp(s - m), rescaled as m grows, as
//     dq_wgmma_kernel) and forms ds tile by tile in a second, so any S runs
//     at two blocks an SM;
//   - re-reading the streamed operands: a block takes up to 64 rows, so Q
//     and G (or K and V) stream through the ring once a pass per 64 rows;
//   - the ragged last tile: its score products skip whole 16-column groups
//     past S (at S = 77, 80 of 128 key columns are computed).
// Both kernels: one block per (batch, head, `rows` rows), 4 * rows
// threads, rows chosen by the launcher (bwd_rows). The block's own rows (Q
// and G, or K and V) are copied once; the other operands stream in 64-row
// tiles through a 3-stage cp.async ring, one tile a step (K then V, or Q
// with its rows' statistics then G), so a product of one step can still
// read the tile of the step before while the next one lands.
//   1. dq_f32_kernel: pass A, s = fl(q . k^T) * scale (+ mask) and dp = g .
//      v^T into m, l and t; then delta = t / l, and m, l, delta go to the
//      statistics scratch. Pass B recomputes s and dp, forms p = expf(s - m)
//      * rcp(l) and ds = fl(fl(p * fl(dp - delta)) * scale) into a [rows x
//      64] shared tile, and accumulates dq += ds . K_tile.
//   2. dkdv_f32_kernel, transposed (keys as rows): s^T = k . q^T and dp^T =
//      v . g^T with the same sums in the same order as kernel 1 (so p and ds
//      are the same bits), p and ds from the streamed statistics, then dv +=
//      p^T . G_tile and dk += ds^T . Q_tile through one shared tile.
// Every output element is written by one thread, from sums in a fixed
// order: no atomics, two runs give the same bits. The softmax uses expf and
// a correctly rounded reciprocal and divide; against the plain version only
// the order of f32 sums (and the online rescaling) moves roundings. Rows
// that are 16-byte aligned are copied 16 bytes at a time, others 4 bytes.
// Times in PERF.md.

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: CUDA cores, register-blocked

constexpr int kBwdTile = 64;      // rows of one streamed tile (keys or queries)
constexpr int kBwdRowStep = 8;    // rows of one warp in the score products
constexpr int kBwdMaxAuto = 64;   // rows of a block, at most, as bwd_rows picks
// p / ds tile rows: 64 columns padded by 16 words, so the scalar stores of a
// warp (two rows of 16 lanes) hit 32 distinct banks and rows stay 16-byte
// aligned for the float4 loads
constexpr int kBwdTStride = kBwdTile + 16;

// Variants for timing only (kernel_variants.py builds each with -D): the
// rows of a dq block and the keys of a dk/dv block (0: bwd_rows picks
// them), the blocks an SM that __launch_bounds__ asks for, and the
// unrolling of the inner loops.
#ifndef F32B_ROWS
#define F32B_ROWS 0
#endif
#ifndef F32B_KEYS
#define F32B_KEYS 0
#endif
#ifndef F32B_MIN_BLOCKS
#define F32B_MIN_BLOCKS 2
#endif
#ifndef F32B_UNROLL
#define F32B_UNROLL 4
#endif
constexpr int kBwdUnroll = F32B_UNROLL;
constexpr int kBwdMaxRows =
    F32B_ROWS > kBwdMaxAuto || F32B_KEYS > kBwdMaxAuto
        ? (F32B_ROWS > F32B_KEYS ? F32B_ROWS : F32B_KEYS)
        : kBwdMaxAuto;
static_assert(F32B_ROWS % kBwdRowStep == 0 && F32B_KEYS % kBwdRowStep == 0,
              "F32B_ROWS, F32B_KEYS: multiples of 8");

// Shared memory of a block of `rows` rows: its own rows of two operands, the
// 3-stage ring of streamed tiles, the p / ds tile and, for dk/dv, 3 stages
// of the streamed queries' m, l and delta
template <int DH>
__host__ __device__ inline size_t bwd_smem_bytes(int rows, bool stats) {
  return sizeof(float) * (2 * (size_t)rows * kF32Stride<DH> +
                          3 * (size_t)kBwdTile * kF32Stride<DH> +
                          (size_t)rows * kBwdTStride +
                          (stats ? 3 * 3 * kBwdTile : 0));
}

// max and sum over the 16 lanes of a half-warp (one row's 64 columns)
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][u] = the sum over d, in order, of A[arow + 2i][d] * T[tcol + 16u][d]
// (rows of two padded tiles) for u < NU, 0 for the others: per 4 columns of
// the head dim 4 float4 of A and 4 of T, 8 shared loads for 64 FMAs
template <int DH, int NU>
__device__ __forceinline__ void dot_tile(float acc[4][4], const float* A,
                                         int arow, const float* T,
                                         int tcol) {
  constexpr int QS = kF32Stride<DH>;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll (kBwdUnroll)
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (arow + 2 * i) * QS + d);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      b[u] = *reinterpret_cast<const float4*>(T + (tcol + 16 * u) * QS + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        acc[i][u] = fmaf(a[i].x, b[u].x, acc[i][u]);
        acc[i][u] = fmaf(a[i].y, b[u].y, acc[i][u]);
        acc[i][u] = fmaf(a[i].z, b[u].z, acc[i][u]);
        acc[i][u] = fmaf(a[i].w, b[u].w, acc[i][u]);
      }
  }
}

// dot_tile over the 16-column groups that hold one of the tile's `valid`
// live columns (a ragged last tile computes only those)
template <int DH>
__device__ __forceinline__ void dot_live(float acc[4][4], const float* A,
                                         int arow, const float* T, int tcol,
                                         int valid) {
  if (valid > 48) dot_tile<DH, 4>(acc, A, arow, T, tcol);
  else if (valid > 32) dot_tile<DH, 3>(acc, A, arow, T, tcol);
  else if (valid > 16) dot_tile<DH, 2>(acc, A, arow, T, tcol);
  else dot_tile<DH, 1>(acc, A, arow, T, tcol);
}

// out[i][c] += the sum over j < n, in order, of P[prow + rq i][j] *
// T[j][4 cg + c] (P the p / ds tile, T a padded tile; n a multiple of 4)
template <int DH>
__device__ __forceinline__ void acc_tile(float out[4][4], const float* P,
                                         int prow, int rq, const float* T,
                                         int cg, int n) {
  constexpr int QS = kF32Stride<DH>;
#pragma unroll (kBwdUnroll)
  for (int jj = 0; jj < n; jj += 4) {
    float4 p[4], t[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (prow + rq * i) * kBwdTStride + jj);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      t[u] = *reinterpret_cast<const float4*>(T + (jj + u) * QS + 4 * cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pu[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        out[i][0] = fmaf(pu[u], t[u].x, out[i][0]);
        out[i][1] = fmaf(pu[u], t[u].y, out[i][1]);
        out[i][2] = fmaf(pu[u], t[u].z, out[i][2]);
        out[i][3] = fmaf(pu[u], t[u].w, out[i][3]);
      }
    }
  }
}

// rows r0 + prow + rq i (those below S), columns 4 cg .. 4 cg + 3
template <int DH>
__device__ __forceinline__ void store_f32_rows(const float out[4][4],
                                               float* dst, const Strides& s,
                                               int b, int h, int r0, int prow,
                                               int rq, int cg, int S,
                                               bool vec) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + prow + rq * i;
    if (r >= S) continue;
    float* p = dst + at(s, b, h, r) + 4 * cg;
    if (vec) {
      *reinterpret_cast<float4*>(p) =
          make_float4(out[i][0], out[i][1], out[i][2], out[i][3]);
    } else {
      p[0] = out[i][0], p[1] = out[i][1], p[2] = out[i][2], p[3] = out[i][3];
    }
  }
}

// dq, one block per (batch, head, `rows` query rows), 4 * rows threads.
// Products: warp w holds rows 8w .. 8w+7 by all 64 keys of a tile; lane
// (lane / 16, lane % 16) the 4 x 4 micro-tile of rows 8w + lane / 16 + 2i
// and keys lane % 16 + 16u, so a row's keys lie in one half-warp.
// dq += ds . K: thread t < rows * DH / 16 holds rows t / (DH/4) + (rows/4) i
// and columns 4 (t % (DH/4)) .. + 3.
template <int DH>
__global__ void __launch_bounds__(4 * kBwdMaxRows, F32B_MIN_BLOCKS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ mask, float* __restrict__ dq,
              float* __restrict__ stats, Strides in, Strides gs, int S,
              int heads, int tiles, int rows, size_t bhs, float scale,
              bool vec) {
  constexpr int QS = kF32Stride<DH>;
  constexpr int TILE = kBwdTile * QS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + (size_t)rows * QS;
  float* ring = Gs + (size_t)rows * QS;  // 3 stages
  float* Ds = ring + 3 * TILE;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const size_t bh = (size_t)b * heads + h;
  const int r0 = tile * rows;
  const int chunks = (S + kBwdTile - 1) / kBwdTile;
  const int steps = 4 * chunks;  // pass A, then pass B; K, then V a chunk
  const int srow = warp * kBwdRowStep + lane / 16, scol = lane % 16;
  const bool live = r0 + warp * kBwdRowStep < S;  // the warp has a row below S
  const int rq = rows / 4;
  const bool out_live = (int)threadIdx.x < rows * DH / 16;
  const int prow = threadIdx.x / (DH / 4), cg = threadIdx.x % (DH / 4);

  // step st: chunk (st / 2) % chunks, K at even steps and V at odd ones,
  // into stage st % 3
  auto issue = [&](int st) {
    load_f32_tile<DH>(ring + (st % 3) * TILE, (st & 1) ? v : k, in, b, h,
                      (st / 2) % chunks * kBwdTile, kBwdTile, S, vec);
    cp_async_commit();
  };
  load_f32_tile<DH>(Qs, q, in, b, h, r0, rows, S, vec);
  load_f32_tile<DH>(Gs, g, gs, b, h, r0, rows, S, vec);
  cp_async_commit();
  issue(0);

  // this lane's rows: m; l (its half-warp share during pass A, 1 / l after);
  // t (its share, then delta); f, the rescale of l and t at this chunk
  float m[4], l[4], t[4], f[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY, l[i] = t[i] = 0.f;
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  }
  // this lane's entries of the shared tile (rows + 2i, keys + 16u): a K
  // step leaves exp(s - m) or p there for the V step, so no score tile is
  // held in registers across the V step's product
  float* E = Ds + srow * kBwdTStride + scol;

  for (int st = 0; st < steps; ++st) {
    cp_async_wait<0>();
    // step st's tile has landed, and stage (st + 1) % 3 (read up to step
    // st - 1) is free for the next copy
    __syncthreads();
    if (st + 1 < steps) issue(st + 1);
    const float* T = ring + (st % 3) * TILE;
    const int j0 = (st / 2) % chunks * kBwdTile;
    const bool pass_a = st < 2 * chunks;
    if ((st & 1) == 0) {
      if (!live) continue;
      // s = fl(q . k) * scale (+ mask), rounded apart as the TPU kernel
      // does; keys at or past S are -inf
      float sc[4][4];
      dot_live<DH>(sc, Qs, srow, T, scol, S - j0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = min(r0 + srow + 2 * i, S - 1);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + scol + 16 * u;
          float s = __fmul_rn(sc[i][u], scale);
          if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)qi * S + min(j, S - 1)]);
          sc[i][u] = j < S ? s : -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pass_a) {
          // online m and l = sum exp(s - m), rescaled as m grows; a row
          // with no finite score yet keeps m = -inf and adds exp(-inf) = 0
          const float cm = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
          const float mn = fmaxf(m[i], half_max(cm));
          const float base = mn == -INFINITY ? 0.f : mn;
          float sum = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float e = expf(sc[i][u] - base);
            sum += e;
            E[2 * i * kBwdTStride + 16 * u] = e;
          }
          f[i] = expf(m[i] - base);
          l[i] = l[i] * f[i] + sum;
          m[i] = mn;
        } else {  // pass B: p
#pragma unroll
          for (int u = 0; u < 4; ++u)
            E[2 * i * kBwdTStride + 16 * u] = expf(sc[i][u] - m[i]) * l[i];
        }
      }
      continue;
    }
    if (live) {
      float dp[4][4];
      dot_live<DH>(dp, Gs, srow, T, scol, S - j0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pass_a) {  // t = sum dp * exp(s - m), rescaled with l
          float ts = 0.f;
#pragma unroll
          for (int u = 0; u < 4; ++u) ts = fmaf(dp[i][u], E[2 * i * kBwdTStride + 16 * u], ts);
          t[i] = t[i] * f[i] + ts;
        } else {  // pass B: ds = fl(fl(p * fl(dp - delta)) * scale)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* e = E + 2 * i * kBwdTStride + 16 * u;
            *e = __fmul_rn(__fmul_rn(*e, __fsub_rn(dp[i][u], t[i])), scale);
          }
        }
      }
      if (st == 2 * chunks - 1) {
        // delta = t / l = rowsum(dp * p) with the unrounded p
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sum = half_sum(l[i]);
          const float delta = half_sum(t[i]) / sum;
          if (m[i] == -INFINITY) m[i] = 0.f;
          const int r = r0 + srow + 2 * i;
          if (scol == 0 && r < S) {
            stats[bh * S + r] = m[i];
            stats[bhs + bh * S + r] = sum;
            stats[2 * bhs + bh * S + r] = delta;
          }
          l[i] = __frcp_rn(sum);
          t[i] = delta;
        }
      }
    }
    if (pass_a) continue;
    // pass B: dq += ds . K with the step before's K tile
    __syncthreads();
    if (out_live)  // keys past S have ds = 0 and zero K rows
      acc_tile<DH>(o, Ds, prow, rq, ring + ((st - 1) % 3) * TILE, cg,
                   min(kBwdTile, (S - j0 + 3) / 4 * 4));
  }
  if (out_live) store_f32_rows<DH>(o, dq, in, b, h, r0, prow, rq, cg, S, vec);
}

// dk and dv, one block per (batch, head, `rows` keys), 4 * rows threads, the
// dq kernel's layout transposed: keys are rows, queries stream. s^T = k .
// q^T and dp^T = v . g^T (the same sums in the same order as dq_f32_kernel,
// so the same p and ds bits, from the statistics it wrote): the Q step
// leaves p in the shared tile, the G step forms ds, then dv += p^T . G
// through the tile, and dk += ds^T . Q through the same tile.
template <int DH>
__global__ void __launch_bounds__(4 * kBwdMaxRows, F32B_MIN_BLOCKS)
dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ mask, float* __restrict__ dk,
                float* __restrict__ dv, const float* __restrict__ stats,
                Strides in, Strides gs, int S, int heads, int tiles, int rows,
                size_t bhs, float scale, bool vec) {
  constexpr int QS = kF32Stride<DH>;
  constexpr int TILE = kBwdTile * QS;
  constexpr int ST = 3 * kBwdTile;  // one chunk's m, l and delta
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)rows * QS;
  float* ring = Vs + (size_t)rows * QS;  // 3 stages
  float* Ts = ring + 3 * TILE;
  float* Sts = Ts + (size_t)rows * kBwdTStride;  // 3 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const size_t bh = (size_t)b * heads + h;
  const int k0 = tile * rows;
  const int chunks = (S + kBwdTile - 1) / kBwdTile;
  const int steps = 2 * chunks;  // Q and its statistics, then G, a chunk
  const int srow = warp * kBwdRowStep + lane / 16, scol = lane % 16;
  const bool live = k0 + warp * kBwdRowStep < S;
  const int rq = rows / 4;
  const bool out_live = (int)threadIdx.x < rows * DH / 16;
  const int prow = threadIdx.x / (DH / 4), cg = threadIdx.x % (DH / 4);

  auto issue = [&](int st) {
    const int i0 = st / 2 * kBwdTile;
    float* dst = ring + (st % 3) * TILE;
    if (st & 1) {
      load_f32_tile<DH>(dst, g, gs, b, h, i0, kBwdTile, S, vec);
    } else {
      load_f32_tile<DH>(dst, q, in, b, h, i0, kBwdTile, S, vec);
      for (int idx = threadIdx.x; idx < ST; idx += blockDim.x) {
        const int which = idx / kBwdTile, i = i0 + idx % kBwdTile;
        cp_async4(Sts + (st % 3) * ST + idx,
                  stats + which * bhs + bh * S + min(i, S - 1), i < S);
      }
    }
    cp_async_commit();
  };
  load_f32_tile<DH>(Ks, k, in, b, h, k0, rows, S, vec);
  load_f32_tile<DH>(Vs, v, in, b, h, k0, rows, S, vec);
  cp_async_commit();
  issue(0);

  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[i][c] = dva[i][c] = 0.f;
  // this lane's entries of the shared tile (keys + 2r, queries + 16u): the
  // Q step leaves p there for the G step
  float* E = Ts + srow * kBwdTStride + scol;

  for (int st = 0; st < steps; ++st) {
    cp_async_wait<0>();
    __syncthreads();  // as in dq_f32_kernel
    if (st + 1 < steps) issue(st + 1);
    const float* T = ring + (st % 3) * TILE;
    const int i0 = st / 2 * kBwdTile;
    if ((st & 1) == 0) {
      if (!live) continue;
      float sc[4][4];
      dot_live<DH>(sc, Ks, srow, T, scol, S - i0);  // s^T
      const float* M = Sts + (st % 3) * ST;
      const float* L = M + kBwdTile;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ii = scol + 16 * u, i = i0 + ii;  // query
        const float mi = M[ii], rl = __frcp_rn(L[ii]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = min(k0 + srow + 2 * r, S - 1);  // key
          float s = __fmul_rn(sc[r][u], scale);
          if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)min(i, S - 1) * S + j]);
          // queries past S add nothing
          E[2 * r * kBwdTStride + 16 * u] = i < S ? expf(s - mi) * rl : 0.f;
        }
      }
      continue;
    }
    float dp[4][4];
    if (live) {
      dot_live<DH>(dp, Vs, srow, T, scol, S - i0);  // dp^T
      const float* Dl = Sts + ((st - 1) % 3) * ST + 2 * kBwdTile;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float di = Dl[scol + 16 * u];
#pragma unroll
        for (int r = 0; r < 4; ++r)  // ds (0 where p is)
          dp[r][u] = __fmul_rn(
              __fmul_rn(E[2 * r * kBwdTStride + 16 * u], __fsub_rn(dp[r][u], di)),
              scale);
      }
    }
    __syncthreads();
    const int n = min(kBwdTile, (S - i0 + 3) / 4 * 4);
    if (out_live) acc_tile<DH>(dva, Ts, prow, rq, T, cg, n);  // p^T . G
    __syncthreads();
    if (live) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) E[2 * r * kBwdTStride + 16 * u] = dp[r][u];
    }
    __syncthreads();
    if (out_live)  // ds^T . Q with the step before's Q tile
      acc_tile<DH>(dka, Ts, prow, rq, ring + ((st - 1) % 3) * TILE, cg, n);
  }
  if (out_live) {
    store_f32_rows<DH>(dka, dk, in, b, h, k0, prow, rq, cg, S, vec);
    store_f32_rows<DH>(dva, dv, in, b, h, k0, prow, rq, cg, S, vec);
  }
}

// The rows of a block (a multiple of 8, at most 64, whose shared memory
// fits in half an SM: two blocks an SM): the fewest rows computed over the
// head's S, each block counted 24 rows more for its fixed cost (staging,
// its stream of the other operands, its barriers; ties go to the larger
// block). 77 rows take two blocks of 40, 257 five of 56, 577 ten of 64
// (kernel_variants.py times the others). A build
// with F32B_ROWS / F32B_KEYS > 0 takes that many (0 if they do not fit).
template <int DH>
int bwd_rows(int S, int limit, bool stats, int fixed) {
  if (fixed > 0)
    return bwd_smem_bytes<DH>(fixed, stats) <= (size_t)limit ? fixed : 0;
  const int half = (limit + 1024) / 2 - 1024;
  int best = 0;
  long long best_cost = 0;
  for (int r = kBwdRowStep; r <= kBwdMaxAuto; r += kBwdRowStep) {
    if (bwd_smem_bytes<DH>(r, stats) > (size_t)half) break;
    const long long cost = (long long)((S + r - 1) / r) * (r + 24);
    if (best == 0 || cost <= best_cost) best = r, best_cost = cost;
  }
  return best;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* mask, void* dq, void* dk, void* dv,
                   float* stats, int B, int S, int heads, Strides in,
                   Strides gs, float scale, cudaStream_t stream) {
  const long long bh = (long long)B * heads;
  if (bh == 0 || S == 0) return cudaSuccess;
  bool vec = rows_aligned16(g, gs, 4);
  const void* same_layout[] = {q, k, v, dq, dk, dv};
  for (const void* p : same_layout) vec = vec && rows_aligned16(p, in, 4);
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const int rows = bwd_rows<DH>(S, limit, false, F32B_ROWS);
  const int keys = bwd_rows<DH>(S, limit, true, F32B_KEYS);
  if (rows == 0 || keys == 0) return cudaErrorInvalidValue;
  const size_t smem1 = bwd_smem_bytes<DH>(rows, false);
  const size_t smem2 = bwd_smem_bytes<DH>(keys, true);
  auto k1 = dq_f32_kernel<DH>;
  auto k2 = dkdv_f32_kernel<DH>;
  err = allow_smem(k1, smem1);
  if (err == cudaSuccess) err = allow_smem(k2, smem2);
  if (err != cudaSuccess) return err;
  const size_t bhs = (size_t)bh * S;
  const int tiles1 = (S + rows - 1) / rows, tiles2 = (S + keys - 1) / keys;
  k1<<<(unsigned)(bh * tiles1), 4 * rows, smem1, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, mask,
      (float*)dq, stats, in, gs, S, heads, tiles1, rows, bhs, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<(unsigned)(bh * tiles2), 4 * keys, smem2, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, mask,
      (float*)dk, (float*)dv, stats, in, gs, S, heads, tiles2, keys, bhs,
      scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma and TMA

// Variants for timing only (kernel_variants.py builds each with -D): the
// consumer warpgroups a block, and a cap on the ring's slots (0: as many
// as fit, so a head's streamed operands are resident when they fit).
#ifndef WGB_CONSUMERS
#define WGB_CONSUMERS 1
#endif
#ifndef WGB_STAGES
#define WGB_STAGES 0
#endif
static_assert(WGB_CONSUMERS >= 1 && WGB_CONSUMERS <= 4,
              "WGB_CONSUMERS: 1 to 4 warpgroups");
constexpr int kConsumers = WGB_CONSUMERS;
// the consumers and a producer warp. One consumer warpgroup a block and
// two blocks an SM give each thread about 200 registers, which the dk/dv
// kernel's 4 accumulators need (ptxas gave two consumer warpgroups a block
// 168, and setmaxnreg did not change its allocation); two blocks also
// work on two heads, so their warpgroups do not wait for each other
constexpr int kWgThreads = kConsumers * kWarpgroup + 32;
constexpr int kBwdMinBlocks = kConsumers == 1 ? 2 : 1;
constexpr int kStatBytes = 3 * kRows * 4;  // one chunk's m, 1 / l, delta

// Both kernels: one block per (batch, head), the last warp the producer
// (one thread of it issues the copies), the others kConsumers warpgroups
// that each take one 64-row tile of the head's own rows at a time (its two own operands by TMA on its own barrier); the other two
// operands come in 64-row chunks by TMA through a ring of slots as in
// attention.cu's attention_wgmma_kernel: resident (each chunk copied once a
// block) when the ring holds them all, else streamed in step, a round of
// kConsumers tiles at a time. kTail in the steps: the ragged last chunk
// (its rows past S are zeros, so the products need no other shape).
// kMask: the additive [S, S] mask.

// dq pass A over one chunk of keys (K and V tiles at KV): s = q . k^T and
// dp = g . v^T into the row max m, l = sum exp(s - m) and t = sum dp *
// exp(s - m)
template <int DH, bool kMask, bool kTail>
__device__ __forceinline__ void dq_stats_step(const bf16* Qs, const bf16* Gs,
                                              const bf16* KV, float (&m)[2],
                                              float (&l)[2], float (&tr)[2],
                                              int i_lo,
                                              const float* mask, float scale,
                                              int j0, int S) {
  constexpr int TILE = Tile<DH>::kElems;
  float sc[8][4], dp[8][4];
  wgmma_fence();
  issue_abt<DH>(sc, Qs, KV);
  issue_abt<DH>(dp, Gs, KV + TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  scale_scores<kMask, kTail>(sc, mask, scale, i_lo, j0, S);
  row_stats<kTail, true>(sc, dp, m, l, tr, live_blocks(S, j0));
}

// dq pass B over one chunk: s and dp again, ds = bf16(fl(p * (dp - delta))
// * scale) in registers as A operands, dq += ds . k (K MN-major). rl = 1
// / l.
template <int DH, bool kMask, bool kTail>
__device__ __forceinline__ void dq_step(const bf16* Qs, const bf16* Gs,
                                        const bf16* KV, float (&acc)[DH / 8][4],
                                        const float (&m)[2],
                                        const float (&rl)[2],
                                        const float (&delta)[2], int i_lo, const float* mask,
                                        float scale, int j0, int S) {
  constexpr int TILE = Tile<DH>::kElems;
  float sc[8][4], dp[8][4];
  wgmma_fence();
  issue_abt<DH>(sc, Qs, KV);
  issue_abt<DH>(dp, Gs, KV + TILE);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  // keys past S have s = -inf, so p = 0 and ds = 0 (and dp = 0: their V
  // rows are zeros); rows past S are never stored. No branch here: ptxas
  // merged the A registers of a branch's two sides through local memory.
  scale_scores<kMask, kTail>(sc, mask, scale, i_lo, j0, S);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2((sc[n][e] - m[e >> 1]) * kLog2e) * rl[e >> 1];
      sc[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], delta[e >> 1])), scale);
    }
  uint32_t df[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(df[kk], sc[2 * kk], sc[2 * kk + 1]);
  fence_frag(df);
  fence_acc(acc);
  wgmma_fence();
  issue_ab<DH>(acc, df, KV);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(df);
}

// dq: own Q and G tiles, K and V through the ring. Pass A (dq_stats_step):
// m, l and t; then delta = t / l = rowsum(dp * p) with the unrounded p,
// and m, 1 / l and delta go to the statistics scratch for
// dkdv_wgmma_kernel. Pass B (dq_step) recomputes s and dp and accumulates
// dq += ds . k. 5 products a (query tile, key chunk).
template <int DH, bool kMask>
__global__ void __launch_bounds__(kWgThreads, kBwdMinBlocks)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mg,
                const __grid_constant__ CUtensorMap mdq,
                const float* __restrict__ mask, float* __restrict__ stats,
                int S, int heads, int slots, int splits, size_t bhsp,
                float scale) {
  constexpr int TILE = Tile<DH>::kElems;
  constexpr unsigned kBytes = Tile<DH>::kBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* ring = reinterpret_cast<bf16*>(wg_smem);   // slots x (K, V)
  bf16* own = ring + (size_t)slots * 2 * TILE;  // kConsumers x (Q, G)
  uint64_t* full = reinterpret_cast<uint64_t*>(own + kConsumers * 2 * TILE);
  uint64_t* empty = full + slots;
  uint64_t* obar = empty + slots;  // one a warpgroup

  // block = (head, part), as in attention_wgmma_kernel
  const int part = blockIdx.x % splits;
  const size_t bh = blockIdx.x / splits;
  const int h = bh % heads, b = bh / heads;
  const int chunks = (S + kRows - 1) / kRows, sp = chunks * kRows;
  const int workers = kConsumers * splits;
  const int rounds = (chunks + workers - 1) / workers;
  const bool resident = slots >= chunks;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  check_smem_base(wg_smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(&obar[w], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp: K and V chunks
    if (lane == 0) {
      const int steps = resident ? chunks : rounds * 2 * chunks;
      for (int st = 0; st < steps; ++st) {
        const int slot = st % slots, j = st % chunks;
        if (!resident) mbar_wait(&empty[slot], ((st / slots) & 1) ^ 1);
        bf16* kv = ring + (size_t)slot * 2 * TILE;
        mbar_expect_tx(&full[slot], 2 * kBytes);
        tma_load(kv, &mk, &full[slot], 0, j * kRows, h, b);
        tma_load(kv + TILE, &mv, &full[slot], 0, j * kRows, h, b);
      }
    }
  } else {  // the consumers
    const int wg = warp / 4, wt = threadIdx.x % kWarpgroup, w16 = 16 * (warp % 4);
    bf16* Qs = own + (size_t)wg * 2 * TILE;
    bf16* Gs = Qs + TILE;
    int st = 0;  // ring steps taken (streamed)
    unsigned ophase = 0;
    for (int r = 0; r < rounds; ++r) {
      const int t = r * workers + wg * splits + part;
      if (t >= chunks) {  // as in attention_wgmma_kernel
        if (!resident)
          for (int step = 0; step < 2 * chunks; ++step, ++st) {
            mbar_wait(&full[st % slots], (st / slots) & 1);
            mbar_arrive(&empty[st % slots]);
          }
        continue;
      }
      const int r0 = t * kRows;
      if (wt == 0) {
        mbar_expect_tx(&obar[wg], 2 * kBytes);
        tma_load(Qs, &mq, &obar[wg], 0, r0, h, b);
        tma_load(Gs, &mg, &obar[wg], 0, r0, h, b);
      }
      mbar_wait(&obar[wg], ophase);
      ophase ^= 1;
      const int i_lo = r0 + w16 + lane / 4;  // this lane's rows: i_lo, i_lo + 8

      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, tr[2] = {0.f, 0.f};
      for (int j = 0; j < chunks; ++j) {  // pass A
        const int slot = resident ? j : st % slots, j0 = j * kRows;
        mbar_wait(&full[slot], resident ? 0 : (st / slots) & 1);
        const bf16* KV = ring + (size_t)slot * 2 * TILE;
        if (j0 + kRows <= S)
          dq_stats_step<DH, kMask, false>(Qs, Gs, KV, m, l, tr, i_lo, mask, scale, j0, S);
        else
          dq_stats_step<DH, kMask, true>(Qs, Gs, KV, m, l, tr, i_lo, mask, scale, j0, S);
        if (!resident) {
          mbar_arrive(&empty[slot]);
          ++st;
        }
      }
      // from here on 1 / l and delta
  #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sum = quad_sum(l[e]);
        tr[e] = quad_sum(tr[e]) / sum;
        if (m[e] == -INFINITY) m[e] = 0.f;
        l[e] = __frcp_rn(sum);
        const int i = i_lo + 8 * e;
        if (lane % 4 == 0 && i < S) {
          stats[bh * sp + i] = m[e];
          stats[bhsp + bh * sp + i] = l[e];
          stats[2 * bhsp + bh * sp + i] = tr[e];
        }
      }

      float acc[DH / 8][4];
  #pragma unroll
      for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      for (int j = 0; j < chunks; ++j) {  // pass B
        const int slot = resident ? j : st % slots, j0 = j * kRows;
        mbar_wait(&full[slot], resident ? 0 : (st / slots) & 1);
        const bf16* KV = ring + (size_t)slot * 2 * TILE;
        if (j0 + kRows <= S)
          dq_step<DH, kMask, false>(Qs, Gs, KV, acc, m, l, tr, i_lo, mask, scale, j0, S);
        else
          dq_step<DH, kMask, true>(Qs, Gs, KV, acc, m, l, tr, i_lo, mask, scale, j0, S);
        if (!resident) {
          mbar_arrive(&empty[slot]);
          ++st;
        }
      }

      warpgroup_sync(1 + wg);  // no product of this warpgroup reads Q now
      stage_tile<DH>(acc, Qs);
      fence_async_smem();
      warpgroup_sync(1 + wg);
      if (wt == 0) {
        tma_store(&mdq, Qs, 0, r0, h, b);
        bulk_commit();
        bulk_wait_read();  // before the next Q tile lands in the same place
      }
    }
    if (wt == 0) bulk_wait();
  }
}

// dk/dv over one chunk of queries (Q and G tiles at QG, their rows' m,
// 1 / l and delta at St): s^T = k . q^T and dp^T = v . g^T, p^T and
// ds^T as A operands straight from the accumulators, dv += bf16(p^T) . g
// and dk += ds^T . q (G and Q MN-major)
template <int DH, bool kMask, bool kTail>
__device__ __forceinline__ void dkdv_step(const bf16* Ks, const bf16* Vs,
                                          const bf16* QG, const float* St,
                                          float (&dka)[DH / 8][4],
                                          float (&dva)[DH / 8][4], int j_lo, const float* mask,
                                          float scale, int i0, int S) {
  constexpr int TILE = Tile<DH>::kElems;
  float sc[8][4], dp[8][4];
  wgmma_fence();
  issue_abt<DH>(sc, Ks, QG);         // s^T
  issue_abt<DH>(dp, Vs, QG + TILE);  // dp^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  {  // no branch on live keys (see dq_step); keys past S are never stored
    const int tq = threadIdx.x % 4;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int ii = n * 8 + 2 * tq;  // this lane's queries i0 + ii (+1)
      const float2 mx = *reinterpret_cast<const float2*>(St + ii);
      const float2 rl = *reinterpret_cast<const float2*>(St + kRows + ii);
      const float2 dl = *reinterpret_cast<const float2*>(St + 2 * kRows + ii);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + ii + (e & 1);  // query
        float s = __fmul_rn(sc[n][e], scale);
        if (kMask) {
          const int j = min(j_lo + (e >> 1) * 8, S - 1);  // key
          s = __fadd_rn(s, mask[(size_t)min(i, S - 1) * S + j]);
        }
        const float p = ex2((s - ((e & 1) ? mx.y : mx.x)) * kLog2e) *
                        ((e & 1) ? rl.y : rl.x);
        const float ds = __fmul_rn(
            __fmul_rn(p, __fsub_rn(dp[n][e], (e & 1) ? dl.y : dl.x)), scale);
        // queries past S add nothing (their statistics are not set)
        const bool in = !kTail || i < S;
        sc[n][e] = in ? p : 0.f;
        dp[n][e] = in ? ds : 0.f;
      }
    }
  }
  uint32_t pf[4][4], df[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    acc_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
    acc_to_a(df[kk], dp[2 * kk], dp[2 * kk + 1]);
  }
  fence_frag(pf);
  fence_frag(df);
  fence_acc(dva);
  fence_acc(dka);
  wgmma_fence();
  issue_ab<DH>(dva, pf, QG + TILE);
  issue_ab<DH>(dka, df, QG);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(dva);
  fence_acc(dka);
  fence_frag(pf);
  fence_frag(df);
}

// dk and dv: own K and V tiles (keys as rows), Q, G and their rows'
// statistics through the ring (a slot: a Q and a G tile, and the chunk's
// m, 1 / l and delta, [3, 64] f32, by TMA from the scratch
// dq_wgmma_kernel wrote), one dkdv_step a chunk. The tiles are computed
// transposed (keys as rows), so p^T and ds^T are A operands with no
// shuffle. Each output element is summed by one thread in a fixed order:
// no atomics, two runs give the same bits. 4 products a (key tile, query
// chunk).
template <int DH, bool kMask>
__global__ void __launch_bounds__(kWgThreads, kBwdMinBlocks)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mg,
                  const __grid_constant__ CUtensorMap mst,
                  const __grid_constant__ CUtensorMap mdk,
                  const __grid_constant__ CUtensorMap mdv,
                  const float* __restrict__ mask, int S, int heads, int slots,
                  int splits, float scale) {
  constexpr int TILE = Tile<DH>::kElems;
  constexpr unsigned kBytes = Tile<DH>::kBytes;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  bf16* ring = reinterpret_cast<bf16*>(wg_smem);   // slots x (Q, G)
  bf16* own = ring + (size_t)slots * 2 * TILE;  // kConsumers x (K, V)
  float* sts = reinterpret_cast<float*>(own + kConsumers * 2 * TILE);  // slots x [3, 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sts + (size_t)slots * 3 * kRows);
  uint64_t* empty = full + slots;
  uint64_t* obar = empty + slots;  // one a warpgroup

  const int part = blockIdx.x % splits, bh = blockIdx.x / splits;
  const int h = bh % heads, b = bh / heads;
  const int chunks = (S + kRows - 1) / kRows;
  const int workers = kConsumers * splits;
  const int rounds = (chunks + workers - 1) / workers;
  const bool resident = slots >= chunks;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  check_smem_base(wg_smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(&obar[w], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {  // the producer warp: Q, G and statistics
    if (lane == 0) {
      const int steps = resident ? chunks : rounds * chunks;
      for (int st = 0; st < steps; ++st) {
        const int slot = st % slots, i = st % chunks;
        if (!resident) mbar_wait(&empty[slot], ((st / slots) & 1) ^ 1);
        bf16* qg = ring + (size_t)slot * 2 * TILE;
        mbar_expect_tx(&full[slot], 2 * kBytes + kStatBytes);
        tma_load(qg, &mq, &full[slot], 0, i * kRows, h, b);
        tma_load(qg + TILE, &mg, &full[slot], 0, i * kRows, h, b);
        tma_load(sts + (size_t)slot * 3 * kRows, &mst, &full[slot], i * kRows, bh, 0, 0);
      }
    }
  } else {  // the consumers
    const int wg = warp / 4, wt = threadIdx.x % kWarpgroup, w16 = 16 * (warp % 4);
    bf16* Ks = own + (size_t)wg * 2 * TILE;
    bf16* Vs = Ks + TILE;
    int st = 0;
    unsigned ophase = 0;
    for (int r = 0; r < rounds; ++r) {
      const int t = r * workers + wg * splits + part;
      if (t >= chunks) {  // as in attention_wgmma_kernel
        if (!resident)
          for (int step = 0; step < chunks; ++step, ++st) {
            mbar_wait(&full[st % slots], (st / slots) & 1);
            mbar_arrive(&empty[st % slots]);
          }
        continue;
      }
      const int k0 = t * kRows;
      if (wt == 0) {
        mbar_expect_tx(&obar[wg], 2 * kBytes);
        tma_load(Ks, &mk, &obar[wg], 0, k0, h, b);
        tma_load(Vs, &mv, &obar[wg], 0, k0, h, b);
      }
      mbar_wait(&obar[wg], ophase);
      ophase ^= 1;
      const int j_lo = k0 + w16 + lane / 4;  // this lane's keys: j_lo, j_lo + 8

      float dka[DH / 8][4], dva[DH / 8][4];
  #pragma unroll
      for (int n = 0; n < DH / 8; ++n)
  #pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const int slot = resident ? c : st % slots, i0 = c * kRows;
        mbar_wait(&full[slot], resident ? 0 : (st / slots) & 1);
        const bf16* QG = ring + (size_t)slot * 2 * TILE;
        const float* St = sts + (size_t)slot * 3 * kRows;
        if (i0 + kRows <= S)
          dkdv_step<DH, kMask, false>(Ks, Vs, QG, St, dka, dva, j_lo, mask, scale, i0, S);
        else
          dkdv_step<DH, kMask, true>(Ks, Vs, QG, St, dka, dva, j_lo, mask, scale, i0, S);
        if (!resident) {
          mbar_arrive(&empty[slot]);
          ++st;
        }
      }

      warpgroup_sync(1 + wg);  // no product of this warpgroup reads K or V now
      stage_tile<DH>(dka, Ks);
      stage_tile<DH>(dva, Vs);
      fence_async_smem();
      warpgroup_sync(1 + wg);
      if (wt == 0) {
        tma_store(&mdk, Ks, 0, k0, h, b);
        tma_store(&mdv, Vs, 0, k0, h, b);
        bulk_commit();
        bulk_wait_read();  // before the next K and V tiles land there
      }
    }
    if (wt == 0) bulk_wait();
  }
}

// The rings' slots (dq, dk/dv) and the blocks' shared memory for one head
// of S rows
template <int DH>
void bwd_plan(int S, int limit, int slots[2], size_t smem[2]) {
  const int chunks = (S + kRows - 1) / kRows;
  const size_t slot = 2 * (size_t)Tile<DH>::kBytes;
  const size_t own = (size_t)kConsumers * slot;
  slots[0] = ring_slots(chunks, slot, own, 0, limit, WGB_STAGES);
  slots[1] = ring_slots(chunks, slot, own, kStatBytes, limit, WGB_STAGES);
  smem[0] = ring_smem(slots[0], slot, own, 0);
  smem[1] = ring_smem(slots[1], slot, own, kStatBytes);
}

template <int DH>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* g, const float* mask, void* dq, void* dk,
                         void* dv, float* stats, int B, int S, int heads,
                         Strides in, Strides gs, float scale,
                         cudaStream_t stream, const MapGeom* in_geom,
                         const MapGeom* g_geom, const MapGeom* st_geom) {
  const void* same_layout[] = {q, k, v, dq, dk, dv};
  for (const void* p : same_layout)
    if (!rows_aligned16(p, in)) return cudaErrorMisalignedAddress;
  if (!rows_aligned16(g, gs)) return cudaErrorMisalignedAddress;
  const long long bh = (long long)B * heads;
  if (bh == 0 || S == 0) return cudaSuccess;
  if (in_geom == nullptr || g_geom == nullptr || st_geom == nullptr)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int slots[2];
  size_t smem[2];
  bwd_plan<DH>(S, limit, slots, smem);
  if (slots[0] == 0 || slots[1] == 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mg, mdq, mdk, mdv, mst;
  if ((err = encode_map(&mq, q, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mk, k, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mv, v, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mg, g, *g_geom, true)) != cudaSuccess ||
      (err = encode_map(&mdq, dq, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mdk, dk, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mdv, dv, *in_geom, true)) != cudaSuccess ||
      (err = encode_map(&mst, stats, *st_geom, false)) != cudaSuccess)
    return err;
  auto k1 = mask != nullptr ? dq_wgmma_kernel<DH, true> : dq_wgmma_kernel<DH, false>;
  auto k2 = mask != nullptr ? dkdv_wgmma_kernel<DH, true>
                            : dkdv_wgmma_kernel<DH, false>;
  err = allow_smem(k1, smem[0]);
  if (err == cudaSuccess) err = allow_smem(k2, smem[1]);
  if (err != cudaSuccess) return err;
  const int chunks = (S + kRows - 1) / kRows;
  const int splits = head_splits(bh, chunks, kConsumers, kBwdMinBlocks);
  k1<<<(unsigned)(bh * splits), kWgThreads, smem[0], stream>>>(
      mq, mk, mv, mg, mdq, mask, stats, S, heads, slots[0], splits,
      (size_t)bh * chunks * kRows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<(unsigned)(bh * splits), kWgThreads, smem[1], stream>>>(
      mq, mk, mv, mg, mst, mdk, mdv, mask, S, heads, slots[1], splits, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(int dtype, const void* q, const void* k,
                        const void* v, const void* g, const float* mask,
                        void* dq, void* dk, void* dv, float* stats, int B,
                        int S, int heads, int dh, Strides in, Strides gs,
                        float scale, cudaStream_t s, const MapGeom* ig,
                        const MapGeom* gg, const MapGeom* sg) {
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch<16>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 32: return launch<32>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 64: return launch<64>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 16: return launch_wgmma<16>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s, ig, gg, sg);
      case 32: return launch_wgmma<32>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s, ig, gg, sg);
      case 64: return launch_wgmma<64>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s, ig, gg, sg);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (wgmma kernels;
// every row start 16-byte aligned, else cudaErrorMisalignedAddress; their
// tensor maps' geometry in in_geom, g_geom and st_geom: attn::MapGeom, from
// ops/attention.py tma_map / stats_map). mask: f32 [S, S] or null. in_*:
// the element strides of q, k, v and of dq, dk, dv; g_*: those of g (see
// attn::Strides). stats: f32 scratch of 3 * B * heads * Sp elements, Sp =
// S rounded up to 64.
int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* mask, void* dq, void* dk, void* dv, void* stats,
                  int B, int S, int heads, int dh, long long in_batch,
                  long long in_head, long long in_row, long long g_batch,
                  long long g_head, long long g_row, int dtype, float scale,
                  void* stream, const void* in_geom, const void* g_geom,
                  const void* st_geom) {
  const Strides in{in_batch, in_head, in_row}, gs{g_batch, g_head, g_row};
  return (int)dispatch_dh(dtype, q, k, v, g, (const float*)mask, dq, dk, dv,
                          (float*)stats, B, S, heads, dh, in, gs, scale,
                          (cudaStream_t)stream, (const MapGeom*)in_geom,
                          (const MapGeom*)g_geom, (const MapGeom*)st_geom);
}

// The bf16 backward's plan for one head of S rows on this card: out[0] and
// out[1] the dq and dk/dv kernels' ring slots (0: does not fit), out[2]
// the 64-row chunks (resident when a kernel's slots >= out[2], else
// streamed), out[3] and out[4] their bytes of shared memory.
int attention_bwd_plan(int S, int dh, int* out) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  int slots[2];
  size_t smem[2];
  switch (dh) {
    case 16: bwd_plan<16>(S, limit, slots, smem); break;
    case 32: bwd_plan<32>(S, limit, slots, smem); break;
    case 64: bwd_plan<64>(S, limit, slots, smem); break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = slots[0];
  out[1] = slots[1];
  out[2] = (S + kRows - 1) / kRows;
  out[3] = (int)smem[0];
  out[4] = (int)smem[1];
  return 0;
}

}  // extern "C"
