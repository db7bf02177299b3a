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
// f32 (the text tower): attention_kernel, on the CUDA cores, kept exact to
// 1e-5 of the plain version (tensor cores would mean TF32). One block per
// (batch, head, 64 query rows) stages the head's K (rows padded by one
// word) and V in shared memory; each warp takes 4 query rows at a time:
// lanes own keys for the scores (the row kept in shared memory), then own
// output columns for p @ v.

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

// ---------------------------------------------------------------------------
// f32: CUDA cores

constexpr int kTileRows = 64;   // query rows per block
constexpr int kRowsPerWarp = 4; // rows a warp carries at once

// K rows in shared memory are padded by one word, so lanes reading
// different rows at the same column hit different banks
template <int DH>
constexpr int kPadded = DH + 1;

template <int DH>
__host__ __device__ inline size_t smem_bytes(int S, int nwarps) {
  return align16((size_t)S * kPadded<DH> * sizeof(float)) +
         align16((size_t)S * DH * sizeof(float)) +
         align16((size_t)nwarps * kRowsPerWarp * DH * sizeof(float)) +
         (size_t)nwarps * kRowsPerWarp * S * sizeof(float);
}

template <int DH>
__global__ void attention_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ mask,
                                 float* __restrict__ out, Strides in,
                                 Strides os, int S, int heads, int tiles,
                                 float scale) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = kPadded<DH>;
  constexpr int NACC = (DH + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);

  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + align16((size_t)S * KS * sizeof(float)));
  float* qs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Vs) + align16((size_t)S * DH * sizeof(float)));
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
    // this group's query rows (rows past the end read as zeros)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      for (int d = lane; d < DH; d += 32)
        q_w[r * DH + d] = i < S ? q[at(in, b, h, i) + d] : 0.f;
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
      const float* krow = Ks + j * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = krow[d];
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
      for (int j = lane; j < S; j += 32) p_w[r * S + j] /= sum;
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
        vv[a] = d < DH ? Vs[j * DH + d] : 0.f;
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
        if (d < DH) out[at(os, b, h, i) + d] = acc[r][a];
      }
    }
    __syncwarp();  // q_w / p_w are rewritten by the next group
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* out, int B, int S, int heads,
                   Strides in, Strides os, float scale, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int nwarps = 8;
  while (nwarps > 1 && smem_bytes<DH>(S, nwarps) > (size_t)limit) nwarps /= 2;
  const size_t smem = smem_bytes<DH>(S, nwarps);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;  // K and V alone too big
  auto kernel = attention_kernel<DH>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const long long blocks = (long long)B * heads * tiles;
  if (blocks == 0) return cudaSuccess;
  kernel<<<(unsigned)blocks, nwarps * 32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, mask, (float*)out, in,
      os, S, heads, tiles, scale);
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

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel;
// every row start 16-byte aligned, else cudaErrorMisalignedAddress).
// mask: f32 [S, S] or null. in_*: the strides of q, k and v; out_*: those
// of out (see attn::Strides).
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
