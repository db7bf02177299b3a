// 2-D rotary positions on the fused q/k/v, in place (ops/rope.py).
//
// qkv [B, S, 3D] bf16, rows contiguous; cos, sin [S-1, dh] f32. For every
// token 1 ... S-1 of every view, the q and k thirds (the row's first 2D
// elements, contiguous) are rotated pair by pair: (x0, x1) at head
// dimensions (2j, 2j+1) -> (x0 c - x1 s, x1 c + x0 s), with c, s the
// tables' entries of the patch and dimension. Each value is read as f32,
// each product and the sum rounded apart (no fused multiply-add: the
// plain version's and EVA's order), and rounded once to bf16. The class
// token and the v third are not touched.
//
// One block a token; each thread moves 8 elements (16 bytes) of q or k
// and reads their 8 cos and 8 sin (32 bytes each, from L2: the tables are
// 2 x 576 x 64 x 4 bytes at EVA02-L/14-336). The kernel is bound by the
// memory: 2 x 2D x 2 bytes a token read and written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rope_qkv_kernel(__nv_bfloat16* __restrict__ qkv,
                    const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, int S, int D, int dh) {
  const int tokens = S - 1;
  const long long tok = blockIdx.x;  // over B x (S - 1)
  const long long b = tok / tokens;
  const int p = (int)(tok - b * tokens);  // the patch, token p + 1
  __nv_bfloat16* row = qkv + (b * S + p + 1) * 3LL * D;
  const float* crow = cos_t + (long long)p * dh;
  const float* srow = sin_t + (long long)p * dh;
  const int vecs = 2 * D / 8;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    const int e = 8 * v;
    const int d = e % dh;
    uint4 raw = *reinterpret_cast<const uint4*>(row + e);
    const float4 ca = __ldg(reinterpret_cast<const float4*>(crow + d));
    const float4 cb = __ldg(reinterpret_cast<const float4*>(crow + d + 4));
    const float4 sa = __ldg(reinterpret_cast<const float4*>(srow + d));
    const float4 sb = __ldg(reinterpret_cast<const float4*>(srow + d + 4));
    const float c[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    const float s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(h[j]);
      const float y0 =
          __fsub_rn(__fmul_rn(x.x, c[2 * j]), __fmul_rn(x.y, s[2 * j]));
      const float y1 = __fadd_rn(__fmul_rn(x.y, c[2 * j + 1]),
                                 __fmul_rn(x.x, s[2 * j + 1]));
      h[j] = __floats2bfloat162_rn(y0, y1);
    }
    *reinterpret_cast<uint4*>(row + e) = raw;
  }
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// qkv [B, S, 3D] bf16 and the tables cos, sin [S-1, D / heads] f32, all
// contiguous from 16-byte-aligned bases; the head dim a multiple of 8.
int rope_qkv(void* qkv, const void* cos_t, const void* sin_t, int B, int S,
             int D, int heads, void* stream) {
  if (((uintptr_t)qkv | (uintptr_t)cos_t | (uintptr_t)sin_t) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (B <= 0 || S < 2 || heads <= 0 || D % heads != 0 ||
      (D / heads) % 8 != 0 || (long long)B * (S - 1) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  rope_qkv_kernel<<<(unsigned)(B * (S - 1)), kThreads, 0,
                    (cudaStream_t)stream>>>(
      (__nv_bfloat16*)qkv, (const float*)cos_t, (const float*)sin_t, S, D,
      D / heads);
  return (int)cudaGetLastError();
}

}  // extern "C"
