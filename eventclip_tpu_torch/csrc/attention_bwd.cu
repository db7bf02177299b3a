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
// pair writes each query row's max, sum and rowsum(dp * p) (f32,
// [3, B*H*S]) for the second. Two pairs, chosen by dtype (never one for the
// other's input):
//
// bf16: dq_tc_kernel and dkdv_tc_kernel (below), every product on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 sums: the TPU kernel's
// products; its exp and divide become __expf and a multiply by a rounded
// reciprocal, the approximation attention_common.cuh bounds). The TPU
// rounds p and ds to bf16 before the products that take them, which is what
// an A operand is; the accumulator-to-fragment register trick turns a score
// tile into that operand without a trip through shared memory. Operands stream through 2-stage cp.async rings of
// 64-row tiles padded to dh + 8 (conflict-free ldmatrix). dq_tc_kernel
// does 5 products (s and dp in a statistics pass, then s, dp and ds . k);
// dkdv_tc_kernel 4, on transposed tiles (keys as rows: s^T = k . q^T,
// dp^T = v . g^T), so p^T and ds^T are A fragments with no shuffle. The
// two kernels' p may differ in the last bits (their sums run in other
// orders); the tolerance against the plain version decides.
// Time at [256, 257, 3072] bf16 + g (chip_smoke.py, H100 80GB HBM3,
// 700.00 W): 3.2783 ms, against 20.4554 ms for an earlier CUDA-core design
// when it also ran bf16, and 1.3481 ms for the backward of torch's
// scaled_dot_product_attention.
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
//     dq_tc_kernel) and forms ds tile by tile in a second, so any S runs
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
// bf16: tensor cores

template <int DH>
constexpr size_t dq_tc_smem_bytes() {
  return 6 * TcTile<DH>::kElems * sizeof(bf16);  // Q, G, 2 x K, 2 x V
}
template <int DH>
constexpr size_t dkdv_tc_smem_bytes() {
  // K, V, 2 x Q, 2 x G, 2 x the chunk's row statistics (m, l, delta)
  return 6 * TcTile<DH>::kElems * sizeof(bf16) + 2 * 3 * kTcRows * sizeof(float);
}

// Both kernels run at most 168 registers a thread, so 3 blocks (12 warps)
// share an SM: on the card, more warps hiding each other's latency beat
// the few bytes spilled (2 blocks at 232-254 registers ran slower).
// Their A operands are read from shared memory by ldmatrix at each use
// rather than held in registers.
//
// dq, one block per (batch, head, 64 query rows), 4 warps of 16 rows. Q and
// G stay in shared memory; K and V stream through a 2-stage cp.async ring
// of 64-key tiles. Pass A: s = q . k^T and dp = g . v^T on mma.sync; the
// row max m, l = sum exp(s - m) and t = sum dp * exp(s - m), both rescaled
// as m grows; delta = t / l = rowsum(dp * p) with the unrounded p. Pass B
// recomputes s and dp, forms ds = bf16(fl(p * (dp - delta)) * scale) in
// registers as A fragments and accumulates dq += ds . k (K read
// transposed). Writes m, l and delta for dkdv_tc_kernel.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 3)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ g,
             const float* __restrict__ mask, bf16* __restrict__ dq,
             float* __restrict__ stats, Strides in, Strides gs, int S,
             int heads, int tiles, size_t bhs, float scale) {
  constexpr int TILE = TcTile<DH>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + TILE;
  bf16* Ks = Gs + TILE;      // 2 stages
  bf16* Vs = Ks + 2 * TILE;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const size_t bh = (size_t)b * heads + h;
  const int r0 = tile * kTcRows, w0 = warp * 16;
  const int i_lo = r0 + w0 + lane / 4;  // this lane's rows: i_lo, i_lo + 8
  const bool active = r0 + w0 < S;
  const int chunks = (S + kTcRows - 1) / kTcRows;

  // step st < chunks: pass A over chunk st; then pass B over st - chunks
  auto issue = [&](int st) {
    const int c = st < chunks ? st : st - chunks;
    load_tile<DH>(Ks + (st & 1) * TILE, k, in, b, h, c * kTcRows, S);
    load_tile<DH>(Vs + (st & 1) * TILE, v, in, b, h, c * kTcRows, S);
    cp_async_commit();
  };
  load_tile<DH>(Qs, q, in, b, h, r0, S);
  load_tile<DH>(Gs, g, gs, b, h, r0, S);
  issue(0);

  // m, then l (1 / l after pass A) and t (delta after pass A) of rows
  // i_lo and i_lo + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

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
      float sc[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      mma_abt<DH>(sc, Qs, w0, Ks + (st & 1) * TILE, S - j0);
      mma_abt<DH>(dp, Gs, w0, Vs + (st & 1) * TILE, S - j0);
      scores(sc, mask, scale, i_lo, j0, S);
      if (st < chunks) {
        row_stats(sc, dp, m, l, t);
        if (st == chunks - 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float sum = quad_sum(l[r]);
            const float delta = quad_sum(t[r]) / sum;
            if (m[r] == -INFINITY) m[r] = 0.f;
            const int i = i_lo + 8 * r;
            if (lane % 4 == 0 && i < S) {
              stats[bh * S + i] = m[r];
              stats[bhs + bh * S + i] = sum;
              stats[2 * bhs + bh * S + i] = delta;
            }
            l[r] = __frcp_rn(sum);
            t[r] = delta;
          }
        }
      } else {
        uint32_t df[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = __expf(sc[n][e] - m[e >> 1]) * l[e >> 1];
            sc[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], t[e >> 1])), scale);
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(df[kk], sc[2 * kk], sc[2 * kk + 1]);
        mma_ab<DH>(acc, df, Ks + (st & 1) * TILE, S - j0);
      }
    }
    __syncthreads();  // stage st % 2 is refilled by the next issue
  }
  if (active) store_rows<DH>(acc, Qs, dq, in, b, h, w0, r0, S);
}

// dk and dv, one block per (batch, head, 64 keys), 4 warps of 16 keys. K
// and V stay in shared memory; Q, G and the three row statistics stream
// in 64-query chunks. The tiles are computed transposed, keys as rows:
// s^T = k . q^T and dp^T = v . g^T, so p^T and ds^T are A fragments with no
// shuffle; dv += bf16(p^T) . g and dk += ds^T . q (G and Q read
// transposed). Each output element is written by one lane: no atomics.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 3)
dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ mask, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const float* __restrict__ stats,
               Strides in, Strides gs, int S, int heads, int tiles,
               size_t bhs, float scale) {
  constexpr int TILE = TcTile<DH>::kElems;
  constexpr int ST = 3 * kTcRows;  // one chunk's statistics
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;      // 2 stages
  bf16* Gs = Qs + 2 * TILE;  // 2 stages
  float* Sts = reinterpret_cast<float*>(Gs + 2 * TILE);  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);
  const size_t bh = (size_t)b * heads + h;
  const int r0 = tile * kTcRows, w0 = warp * 16;
  const int j_lo = r0 + w0 + lane / 4;  // this lane's keys: j_lo, j_lo + 8
  const bool active = r0 + w0 < S;
  const int chunks = (S + kTcRows - 1) / kTcRows;

  auto issue = [&](int c) {
    load_tile<DH>(Qs + (c & 1) * TILE, q, in, b, h, c * kTcRows, S);
    load_tile<DH>(Gs + (c & 1) * TILE, g, gs, b, h, c * kTcRows, S);
    for (int idx = threadIdx.x; idx < ST; idx += kTcThreads) {
      const int which = idx / kTcRows, i = c * kTcRows + idx % kTcRows;
      cp_async4(Sts + (c & 1) * ST + idx,
                stats + which * bhs + bh * S + min(i, S - 1), i < S);
    }
    cp_async_commit();
  };
  load_tile<DH>(Ks, k, in, b, h, r0, S);
  load_tile<DH>(Vs, v, in, b, h, r0, S);
  issue(0);

  float dka[DH / 8][4], dva[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      issue(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int i0 = c * kTcRows;
      const bf16* Qc = Qs + (c & 1) * TILE;
      const bf16* Gc = Gs + (c & 1) * TILE;
      const float* M = Sts + (c & 1) * ST;
      const float* L = M + kTcRows;
      const float* Dl = L + kTcRows;
      float sc[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
      mma_abt<DH>(dp, Vs, w0, Gc, S - i0);  // dp^T
      mma_abt<DH>(sc, Ks, w0, Qc, S - i0);  // s^T
      const int tq = lane % 4;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = n * 8 + 2 * tq + (e & 1), i = i0 + ii;  // query
          const int j = min(j_lo + (e >> 1) * 8, S - 1);            // key
          float s = __fmul_rn(sc[n][e], scale);
          if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)min(i, S - 1) * S + j]);
          float p = 0.f, ds = 0.f;
          if (i < S) {
            p = __expf(s - M[ii]) * __frcp_rn(L[ii]);
            ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], Dl[ii])), scale);
          }
          sc[n][e] = p;
          dp[n][e] = ds;
        }
      uint32_t pf[4][4], df[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pf[kk], sc[2 * kk], sc[2 * kk + 1]);
        acc_to_a(df[kk], dp[2 * kk], dp[2 * kk + 1]);
      }
      mma_ab<DH>(dva, pf, Gc, S - i0);
      mma_ab<DH>(dka, df, Qc, S - i0);
    }
    __syncthreads();  // stage c % 2 is refilled by the next issue
  }
  if (active) {
    store_rows<DH>(dka, Ks, dk, in, b, h, w0, r0, S);
    store_rows<DH>(dva, Vs, dv, in, b, h, w0, r0, S);
  }
}

template <int DH>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* g, const float* mask, void* dq, void* dk,
                      void* dv, float* stats, int B, int S, int heads,
                      Strides in, Strides gs, float scale,
                      cudaStream_t stream) {
  const void* same_layout[] = {q, k, v, dq, dk, dv};
  for (const void* p : same_layout)
    if (!rows_aligned16(p, in)) return cudaErrorMisalignedAddress;
  if (!rows_aligned16(g, gs)) return cudaErrorMisalignedAddress;
  auto k1 = dq_tc_kernel<DH>;
  auto k2 = dkdv_tc_kernel<DH>;
  cudaError_t err = allow_smem(k1, dq_tc_smem_bytes<DH>());
  if (err == cudaSuccess) err = allow_smem(k2, dkdv_tc_smem_bytes<DH>());
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTcRows - 1) / kTcRows;
  const long long bh = (long long)B * heads;
  if (bh == 0 || S == 0) return cudaSuccess;
  const size_t bhs = (size_t)bh * S;
  k1<<<(unsigned)(bh * tiles), kTcThreads, dq_tc_smem_bytes<DH>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, mask,
      (bf16*)dq, stats, in, gs, S, heads, tiles, bhs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<(unsigned)(bh * tiles), kTcThreads, dkdv_tc_smem_bytes<DH>(), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)g, mask,
      (bf16*)dk, (bf16*)dv, stats, in, gs, S, heads, tiles, bhs, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_dh(int dtype, const void* q, const void* k,
                        const void* v, const void* g, const float* mask,
                        void* dq, void* dk, void* dv, float* stats, int B,
                        int S, int heads, int dh, Strides in, Strides gs,
                        float scale, cudaStream_t s) {
  if (dtype == 0) {
    switch (dh) {
      case 16: return launch<16>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 32: return launch<32>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 64: return launch<64>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    }
  } else if (dtype == 1) {
    switch (dh) {
      case 16: return launch_tc<16>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 32: return launch_tc<32>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
      case 64: return launch_tc<64>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels; every row start 16-byte aligned, else
// cudaErrorMisalignedAddress). mask: f32 [S, S] or null. in_*: the strides
// of q, k, v and of dq, dk, dv; g_*: those of g (see attn::Strides).
// stats: f32 scratch of 3*B*heads*S elements.
int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* mask, void* dq, void* dk, void* dv, void* stats,
                  int B, int S, int heads, int dh, long long in_batch,
                  long long in_head, long long in_row, long long g_batch,
                  long long g_head, long long g_row, int dtype, float scale,
                  void* stream) {
  const Strides in{in_batch, in_head, in_row}, gs{g_batch, g_head, g_row};
  return (int)dispatch_dh(dtype, q, k, v, g, (const float*)mask, dq, dk, dv,
                          (float*)stats, B, S, heads, dh, in, gs, scale,
                          (cudaStream_t)stream);
}

}  // extern "C"
