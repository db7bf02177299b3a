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
// 700.00 W): 3.2783 ms, against 20.4554 ms for the CUDA-core kernels below
// when they also ran bf16, and 1.3481 ms for the backward of torch's
// scaled_dot_product_attention.
//
// f32 (the text tower's shapes; its tower is frozen): dq_kernel and
// dkdv_kernel on the CUDA cores, exact to 1e-5 of the plain version
// (tensor cores would mean TF32):
//   1. dq_kernel, one block per (batch, head, 64 query rows): stages the
//      head's K and V in chunks of keys that fit beside the score rows (all
//      S at once where they fit; rows padded against bank conflicts), so
//      any S whose 4 score and dp rows fit in shared memory runs (S up to
//      about 6,600 at dh 64); each warp carries 4 query rows, keeps their
//      score and dp rows in shared memory, forms p, the row's
//      rowsum(dp * p) and ds, then dq = ds . k.
//   2. dkdv_kernel, one block per (batch, head, 32 keys): stages those keys'
//      k and v rows, then walks the queries 32 at a time (their q, g and
//      row statistics staged in shared memory), recomputes p and ds for the
//      32 x 32 tile with the same sums in the same order as kernel 1 (so p
//      and ds are the same bits), and accumulates dv and dk for its keys in
//      registers: lanes own columns, warps own keys.

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kTileRows = 64;    // query rows per dq block
constexpr int kRowsPerWarp = 4;  // rows a warp carries at once
constexpr int kKeys = 32;        // keys per dk/dv block (one per lane)
constexpr int kChunk = 32;       // queries per step of a dk/dv block
constexpr int kWarps2 = kChunk / kRowsPerWarp;  // 8 warps in a dk/dv block

// K and V rows in shared memory are padded by one word, so lanes reading
// different rows at the same column hit different banks
template <int DH>
constexpr int kPadded = DH + 1;

// Shared memory of a dq block: `keys` rows each of K and V (one chunk of
// keys), and each warp's R query and g rows and R score and dp rows of S
template <int DH>
__host__ __device__ inline size_t dq_smem_bytes(int S, int nwarps, int keys) {
  return 2 * align16((size_t)keys * kPadded<DH> * sizeof(float)) +
         2 * align16((size_t)nwarps * kRowsPerWarp * DH * sizeof(float)) +
         2 * (size_t)nwarps * kRowsPerWarp * S * sizeof(float);
}

// K and V are staged `keys` rows at a time (a multiple of 32, or all S):
// each warp's score and dp rows stay in shared memory and are filled chunk
// by chunk, the row reductions run after the last chunk, and dq = ds . k
// walks the K chunks again. Every product and sum keeps the order it has
// with the whole head staged, so the chunk size never changes the bits.
template <int DH>
__global__ void dq_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ mask,
                          float* __restrict__ dq, float* __restrict__ stats,
                          Strides in, Strides gs, int S, int heads, int tiles,
                          size_t bhs, float scale, int keys) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = kPadded<DH>;
  constexpr int NACC = (DH + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);

  const size_t kv_bytes = align16((size_t)keys * KS * sizeof(float));
  const size_t row_bytes = align16((size_t)nwarps * R * DH * sizeof(float));
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + kv_bytes);
  float* qs = reinterpret_cast<float*>(smem + 2 * kv_bytes);
  float* gsm = reinterpret_cast<float*>(smem + 2 * kv_bytes + row_bytes);
  float* ps = reinterpret_cast<float*>(smem + 2 * kv_bytes + 2 * row_bytes);
  float* dps = ps + (size_t)nwarps * R * S;
  float* q_w = qs + (size_t)warp * R * DH;
  float* g_w = gsm + (size_t)warp * R * DH;
  float* p_w = ps + (size_t)warp * R * S;   // scores, then p, then ds
  float* dp_w = dps + (size_t)warp * R * S;

  // stage keys c0 .. c0+keys-1 of K and V; every thread of the block calls
  // it at the same points (all S at once stays staged)
  int staged = -1;
  auto stage = [&](int c0) {
    if (staged == c0) return;
    __syncthreads();  // the previous chunk is consumed
    const int n = min(keys, S - c0);
    for (int idx = threadIdx.x; idx < n * DH; idx += blockDim.x) {
      const int s = idx / DH, d = idx % DH;
      Ks[s * KS + d] = k[at(in, b, h, c0 + s) + d];
      Vs[s * KS + d] = v[at(in, b, h, c0 + s) + d];
    }
    __syncthreads();
    staged = c0;
  };

  const size_t bh = (size_t)b * heads + h;
  const int tile_start = tile * kTileRows;
  const int tile_end = min(tile_start + kTileRows, S);
  for (int base = tile_start; base < tile_end; base += nwarps * R) {
    // every warp walks the chunks (they stage together); a warp past the
    // tile computes nothing and writes nothing
    const int i0 = base + warp * R;
    const bool active = i0 < tile_end;
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        for (int d = lane; d < DH; d += 32) {
          q_w[r * DH + d] = i < S ? q[at(in, b, h, i) + d] : 0.f;
          g_w[r * DH + d] = i < S ? g[at(gs, b, h, i) + d] : 0.f;
        }
      }
    }
    __syncwarp();

    // s = q . k * scale (+ mask) and dp = g . v: lanes own keys
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
    for (int c0 = 0; c0 < S; c0 += keys) {
      stage(c0);
      if (!active) continue;
      const int c1 = min(c0 + keys, S);
      for (int j = c0 + lane; j < c1; j += 32) {
        float dot[R], dpd[R];
#pragma unroll
        for (int r = 0; r < R; ++r) dot[r] = dpd[r] = 0.f;
        const float* krow = Ks + (j - c0) * KS;
        const float* vrow = Vs + (j - c0) * KS;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float kv = krow[d], vv = vrow[d];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            dot[r] = fmaf(q_w[r * DH + d], kv, dot[r]);
            dpd[r] = fmaf(g_w[r * DH + d], vv, dpd[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = __fmul_rn(dot[r], scale);
          if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)min(i0 + r, S - 1) * S + j]);
          p_w[r * S + j] = s;
          dp_w[r * S + j] = dpd[r];
          mx[r] = fmaxf(mx[r], s);
        }
      }
    }
    // p over the whole row (masked keys give p = 0, hence ds = 0, and the
    // diagonal keeps m finite: no inf - inf), then ds
    if (active) {
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
        float dsum = 0.f;
        for (int j = lane; j < S; j += 32) {
          const float p = p_w[r * S + j] / sum;
          p_w[r * S + j] = p;
          dsum += __fmul_rn(dp_w[r * S + j], p);
        }
        dsum = warp_sum(dsum);
        for (int j = lane; j < S; j += 32) {
          const float ds = __fmul_rn(p_w[r * S + j], __fsub_rn(dp_w[r * S + j], dsum));
          p_w[r * S + j] = __fmul_rn(ds, scale);
        }
        const int i = i0 + r;
        if (lane == 0 && i < S) {
          stats[bh * S + i] = mx[r];
          stats[bhs + bh * S + i] = sum;
          stats[2 * bhs + bh * S + i] = dsum;
        }
      }
    }
    __syncwarp();

    // dq = ds . k: lanes own columns, keys in order, chunk by chunk
    float acc[R][NACC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[r][a] = 0.f;
    for (int c0 = 0; c0 < S; c0 += keys) {
      stage(c0);
      if (!active) continue;
      const int c1 = min(c0 + keys, S);
      for (int j = c0; j < c1; ++j) {
        float kk[NACC];
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          const int d = lane + 32 * a;
          kk[a] = d < DH ? Ks[(j - c0) * KS + d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ds = p_w[r * S + j];
#pragma unroll
          for (int a = 0; a < NACC; ++a) acc[r][a] = fmaf(ds, kk[a], acc[r][a]);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r;
        if (i >= S) break;
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          const int d = lane + 32 * a;
          if (d < DH) dq[at(in, b, h, i) + d] = acc[r][a];
        }
      }
    }
    __syncwarp();
  }
}

template <int DH>
__global__ void __launch_bounds__(kWarps2 * 32)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g,
            const float* __restrict__ mask, float* __restrict__ dk,
            float* __restrict__ dv, const float* __restrict__ stats,
            Strides in, Strides gs, int S, int heads, int ktiles, size_t bhs,
            float scale) {
  constexpr int KP = DH + 1;  // f32 rows padded by one word
  constexpr int NACC = (DH + 31) / 32;
  constexpr int U = kKeys / kWarps2;  // keys per warp in the accumulation
  __shared__ float Kt[kKeys * KP], Vt[kKeys * KP];
  __shared__ float Qc[kChunk * DH], Gc[kChunk * DH];
  __shared__ float P[kChunk * kKeys], DS[kChunk * kKeys];
  __shared__ float Mc[kChunk], Lc[kChunk], Dc[kChunk];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kt = blockIdx.x % ktiles;
  const int h = (blockIdx.x / ktiles) % heads;
  const int b = blockIdx.x / (ktiles * heads);
  const int j0 = kt * kKeys;
  const size_t bh = (size_t)b * heads + h;

  for (int idx = threadIdx.x; idx < kKeys * DH; idx += blockDim.x) {
    const int jj = idx / DH, d = idx % DH, j = j0 + jj;
    Kt[jj * KP + d] = j < S ? k[at(in, b, h, j) + d] : 0.f;
    Vt[jj * KP + d] = j < S ? v[at(in, b, h, j) + d] : 0.f;
  }

  float dka[U][NACC], dva[U][NACC];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int a = 0; a < NACC; ++a) dka[u][a] = dva[u][a] = 0.f;

  const int j = j0 + lane;  // this lane's key in the tile phase
  for (int q0 = 0; q0 < S; q0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and K/V staged)
    for (int idx = threadIdx.x; idx < kChunk * DH; idx += blockDim.x) {
      const int ii = idx / DH, d = idx % DH, i = q0 + ii;
      Qc[idx] = i < S ? q[at(in, b, h, i) + d] : 0.f;
      Gc[idx] = i < S ? g[at(gs, b, h, i) + d] : 0.f;
    }
    if (threadIdx.x < kChunk && q0 + (int)threadIdx.x < S) {
      const size_t row = bh * S + q0 + threadIdx.x;
      Mc[threadIdx.x] = stats[row];
      Lc[threadIdx.x] = stats[bhs + row];
      Dc[threadIdx.x] = stats[2 * bhs + row];
    }
    __syncthreads();

    // the 32 x 32 tile of p and ds: warps own 4 queries, lanes own keys;
    // the same sums as dq_kernel's, in the same order
    float dot[kRowsPerWarp], dpd[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) dot[r] = dpd[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kv = Kt[lane * KP + d], vv = Vt[lane * KP + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int ii = warp * kRowsPerWarp + r;
        dot[r] = fmaf(Qc[ii * DH + d], kv, dot[r]);
        dpd[r] = fmaf(Gc[ii * DH + d], vv, dpd[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int ii = warp * kRowsPerWarp + r, i = q0 + ii;
      float pq = 0.f, dsq = 0.f;
      if (i < S && j < S) {
        float s = __fmul_rn(dot[r], scale);
        if (mask != nullptr) s = __fadd_rn(s, mask[(size_t)i * S + j]);
        pq = expf(s - Mc[ii]) / Lc[ii];
        dsq = __fmul_rn(__fmul_rn(pq, __fsub_rn(dpd[r], Dc[ii])), scale);
      }
      P[ii * kKeys + lane] = pq;
      DS[ii * kKeys + lane] = dsq;
    }
    __syncthreads();

    // dv += p^T g, dk += ds^T q: warps own keys, lanes own columns
    const int rows = min(kChunk, S - q0);
    for (int ii = 0; ii < rows; ++ii) {
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int d = lane + 32 * a;
        const float gv = d < DH ? Gc[ii * DH + d] : 0.f;
        const float qv = d < DH ? Qc[ii * DH + d] : 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int jj = warp + kWarps2 * u;
          dva[u][a] = fmaf(P[ii * kKeys + jj], gv, dva[u][a]);
          dka[u][a] = fmaf(DS[ii * kKeys + jj], qv, dka[u][a]);
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int jk = j0 + warp + kWarps2 * u;
    if (jk >= S) continue;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int d = lane + 32 * a;
      if (d < DH) {
        dk[at(in, b, h, jk) + d] = dka[u][a];
        dv[at(in, b, h, jk) + d] = dva[u][a];
      }
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* mask, void* dq, void* dk, void* dv,
                   float* stats, int B, int S, int heads, Strides in,
                   Strides gs, float scale, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  // the most warps whose score and dp rows leave room for a chunk of 32
  // keys; then the largest chunk (a multiple of 32, or all S) that fits
  int nwarps = 8;
  while (nwarps > 1 && dq_smem_bytes<DH>(S, nwarps, 32) > (size_t)limit) nwarps /= 2;
  if (dq_smem_bytes<DH>(S, nwarps, 32) > (size_t)limit)
    return cudaErrorInvalidValue;  // one warp's score rows alone too big
  int keys = S;
  if (dq_smem_bytes<DH>(S, nwarps, S) > (size_t)limit) {
    keys = 32;
    while (dq_smem_bytes<DH>(S, nwarps, keys + 32) <= (size_t)limit) keys += 32;
  }
  const size_t smem = dq_smem_bytes<DH>(S, nwarps, keys);
  auto k1 = dq_kernel<DH>;
  err = allow_smem(k1, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const int ktiles = (S + kKeys - 1) / kKeys;
  const long long bh = (long long)B * heads;
  if (bh == 0 || S == 0) return cudaSuccess;
  const size_t bhs = (size_t)bh * S;
  k1<<<(unsigned)(bh * tiles), nwarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, mask,
      (float*)dq, stats, in, gs, S, heads, tiles, bhs, scale, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<DH><<<(unsigned)(bh * ktiles), kWarps2 * 32, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g, mask,
      (float*)dk, (float*)dv, stats, in, gs, S, heads, ktiles, bhs, scale);
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
