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
// Design (simple, right and deterministic first). The TPU kernel holds
// q, k, v and g of a head in VMEM at once; here that is 4*S*dh elements,
// 263 KB in f32 at S = 257, dh = 64, more than a block's 227 KB. So the work
// is split by what each output needs, and no output is summed by atomics:
//   1. dq_kernel, one block per (batch, head, 64 query rows): stages the
//      head's K and V (rows padded against bank conflicts) like the
//      forward; each warp carries 4 query rows, keeps their score and dp
//      rows in shared memory, forms p, the row's rowsum(dp * p) and ds,
//      then dq = ds . k. It writes each row's max, sum and rowsum(dp * p)
//      (f32, [3, B*H*S]) for the second kernel.
//   2. dkdv_kernel, one block per (batch, head, 32 keys): stages those keys'
//      k and v rows, then walks the queries 32 at a time (their q, g and
//      row statistics staged in shared memory), recomputes p and ds for the
//      32 x 32 tile with the same sums in the same order as kernel 1 (so p
//      and ds are the same bits), and accumulates dv and dk for its keys in
//      registers: lanes own columns, warps own keys.
// Every output element is written by one thread: two runs give the same
// bits. The two kernels recompute s and dp twice (7 products where the TPU
// kernel does 5), all on the CUDA cores in f32.
//
// Bound on this card: operations. A ViT-L/14 training layer at B = 256
// views, S = 257, 16 heads of dh 64 needs the TPU kernel's 5 products,
// 10*B*H*S^2*dh = 173 GFLOP (0.175 ms at 989 TFLOP/s of bf16), against
// 943 MB of q, k, v, g in and dq, dk, dv out (0.28 ms at 3.35 TB/s):
// bytes bound the ideal kernel. This one, on CUDA cores, sits far from
// both; tensor cores (mma.sync, then wgmma) are later work.

#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kTileRows = 64;    // query rows per dq block
constexpr int kRowsPerWarp = 4;  // rows a warp carries at once
constexpr int kKeys = 32;        // keys per dk/dv block (one per lane)
constexpr int kChunk = 32;       // queries per step of a dk/dv block
constexpr int kWarps2 = kChunk / kRowsPerWarp;  // 8 warps in a dk/dv block

template <typename T, int DH>
__host__ __device__ inline size_t dq_smem_bytes(int S, int nwarps) {
  return 2 * align16((size_t)S * Padded<T, DH>::kStride * sizeof(T)) +
         2 * align16((size_t)nwarps * kRowsPerWarp * DH * sizeof(float)) +
         2 * (size_t)nwarps * kRowsPerWarp * S * sizeof(float);
}

template <typename T, int DH>
__global__ void dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ g,
                          const float* __restrict__ mask, T* __restrict__ dq,
                          float* __restrict__ stats, Strides in, Strides gs,
                          int S, int heads, int tiles, size_t bhs,
                          float scale) {
  constexpr int R = kRowsPerWarp;
  constexpr int KS = Padded<T, DH>::kStride;
  constexpr int NACC = (DH + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];

  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x % tiles;
  const int h = (blockIdx.x / tiles) % heads;
  const int b = blockIdx.x / (tiles * heads);

  const size_t kv_bytes = align16((size_t)S * KS * sizeof(T));
  const size_t row_bytes = align16((size_t)nwarps * R * DH * sizeof(float));
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + kv_bytes);
  float* qs = reinterpret_cast<float*>(smem + 2 * kv_bytes);
  float* gsm = reinterpret_cast<float*>(smem + 2 * kv_bytes + row_bytes);
  float* ps = reinterpret_cast<float*>(smem + 2 * kv_bytes + 2 * row_bytes);
  float* dps = ps + (size_t)nwarps * R * S;
  float* q_w = qs + (size_t)warp * R * DH;
  float* g_w = gsm + (size_t)warp * R * DH;
  float* p_w = ps + (size_t)warp * R * S;   // scores, then p, then ds
  float* dp_w = dps + (size_t)warp * R * S;

  for (int idx = threadIdx.x; idx < S * DH; idx += blockDim.x) {
    const int s = idx / DH, d = idx % DH;
    Ks[s * KS + d] = k[at(in, b, h, s) + d];
    Vs[s * KS + d] = v[at(in, b, h, s) + d];
  }
  __syncthreads();

  const size_t bh = (size_t)b * heads + h;
  const int tile_start = tile * kTileRows;
  const int tile_end = min(tile_start + kTileRows, S);
  for (int i0 = tile_start + warp * R; i0 < tile_end; i0 += nwarps * R) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      for (int d = lane; d < DH; d += 32) {
        q_w[r * DH + d] = i < S ? to_f32(q[at(in, b, h, i) + d]) : 0.f;
        g_w[r * DH + d] = i < S ? to_f32(g[at(gs, b, h, i) + d]) : 0.f;
      }
    }
    __syncwarp();

    // s = q . k * scale (+ mask) and dp = g . v: lanes own keys
    float mx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      float dot[R], dpd[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = dpd[r] = 0.f;
      const T* krow = Ks + j * KS;
      const T* vrow = Vs + j * KS;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) {
        const float kv = to_f32(krow[d]), vv = to_f32(vrow[d]);
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
    // p over the whole row (masked keys give p = 0, hence ds = 0, and the
    // diagonal keeps m finite: no inf - inf), then ds
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
        p_w[r * S + j] = round_to<T>(__fmul_rn(ds, scale));
      }
      const int i = i0 + r;
      if (lane == 0 && i < S) {
        stats[bh * S + i] = mx[r];
        stats[bhs + bh * S + i] = sum;
        stats[2 * bhs + bh * S + i] = dsum;
      }
    }
    __syncwarp();

    // dq = ds . k: lanes own columns
    float acc[R][NACC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[r][a] = 0.f;
    for (int j = 0; j < S; ++j) {
      float kk[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int d = lane + 32 * a;
        kk[a] = d < DH ? to_f32(Ks[j * KS + d]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ds = p_w[r * S + j];
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[r][a] = fmaf(ds, kk[a], acc[r][a]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r;
      if (i >= S) break;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        const int d = lane + 32 * a;
        if (d < DH) dq[at(in, b, h, i) + d] = from_f32<T>(acc[r][a]);
      }
    }
    __syncwarp();
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kWarps2 * 32)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ g,
            const float* __restrict__ mask, T* __restrict__ dk,
            T* __restrict__ dv, const float* __restrict__ stats, Strides in,
            Strides gs, int S, int heads, int ktiles, size_t bhs,
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
    Kt[jj * KP + d] = j < S ? to_f32(k[at(in, b, h, j) + d]) : 0.f;
    Vt[jj * KP + d] = j < S ? to_f32(v[at(in, b, h, j) + d]) : 0.f;
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
      Qc[idx] = i < S ? to_f32(q[at(in, b, h, i) + d]) : 0.f;
      Gc[idx] = i < S ? to_f32(g[at(gs, b, h, i) + d]) : 0.f;
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
        const float p = expf(s - Mc[ii]) / Lc[ii];
        pq = round_to<T>(p);
        dsq = round_to<T>(__fmul_rn(__fmul_rn(p, __fsub_rn(dpd[r], Dc[ii])), scale));
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
        dk[at(in, b, h, jk) + d] = from_f32<T>(dka[u][a]);
        dv[at(in, b, h, jk) + d] = from_f32<T>(dva[u][a]);
      }
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* mask, void* dq, void* dk, void* dv,
                   float* stats, int B, int S, int heads, Strides in,
                   Strides gs, float scale, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  int nwarps = 8;
  while (nwarps > 1 && dq_smem_bytes<T, DH>(S, nwarps) > (size_t)limit) nwarps /= 2;
  const size_t smem = dq_smem_bytes<T, DH>(S, nwarps);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;  // K and V alone too big
  auto k1 = dq_kernel<T, DH>;
  err = allow_smem(k1, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileRows - 1) / kTileRows;
  const int ktiles = (S + kKeys - 1) / kKeys;
  const long long bh = (long long)B * heads;
  if (bh == 0 || S == 0) return cudaSuccess;
  const size_t bhs = (size_t)bh * S;
  k1<<<(unsigned)(bh * tiles), nwarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, mask, (T*)dq, stats,
      in, gs, S, heads, tiles, bhs, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, DH><<<(unsigned)(bh * ktiles), kWarps2 * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)g, mask, (T*)dk, (T*)dv,
      stats, in, gs, S, heads, ktiles, bhs, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v,
                        const void* g, const float* mask, void* dq, void* dk,
                        void* dv, float* stats, int B, int S, int heads, int dh,
                        Strides in, Strides gs, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    case 32: return launch<T, 32>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    case 64: return launch<T, 64>(q, k, v, g, mask, dq, dk, dv, stats, B, S, heads, in, gs, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16. mask: f32 [S, S] or null. in_*: the
// strides of q, k, v and of dq, dk, dv; g_*: those of g (see attn::Strides).
// stats: f32 scratch of 3*B*heads*S elements.
int attention_bwd(const void* q, const void* k, const void* v, const void* g,
                  const void* mask, void* dq, void* dk, void* dv, void* stats,
                  int B, int S, int heads, int dh, long long in_batch,
                  long long in_head, long long in_row, long long g_batch,
                  long long g_head, long long g_row, int dtype, float scale,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* m = (const float*)mask;
  float* st = (float*)stats;
  const Strides in{in_batch, in_head, in_row}, gs{g_batch, g_head, g_row};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dh<float>(q, k, v, g, m, dq, dk, dv, st, B, S, heads, dh, in,
                             gs, scale, s);
  else if (dtype == 1)
    err = dispatch_dh<__nv_bfloat16>(q, k, v, g, m, dq, dk, dv, st, B, S, heads,
                                     dh, in, gs, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

}  // extern "C"
