// Per-window polarity event histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel eventclip_tpu/ops/rasterize.py::_pallas_histograms
// (kernel body _hist_kernel): for every window m and event e with x, y, p,
// add 1 at hist[m, y + H*[p<0], x]; events with p == 0 (padding) or outside
// [0, W) x [0, H) are dropped. Returns float32 [M, 2, H, W] (the layout and
// dtype _pallas_histograms returns) holding exact counts.
//
// The TPU builds one-hot tiles and counts with an MXU matmul because a
// scatter serializes there. On Hopper a histogram is a scatter: each thread
// takes one event and does a float atomicAdd of 1.0f straight into the f32
// output. A float sum of ones is exact and order-independent while it stays
// below 2^24, and no bin can exceed the window's N events; the launcher
// refuses N >= 2^24.
//
// Bound: bytes. Read M*N*ch*sizeof(elem) (M*N*6 for packed int16 windows),
// write M*2*H*W*4. For the N-Caltech main path (M = 320 windows of
// N = 20000 packed events, 180x240) that is 38.4 MB + 110.6 MB; no
// arithmetic to speak of. This design moves more than that: a memset of the
// output (one more write) and the atomics (read-modify-write in L2). One
// window's histogram is 337.5 KiB at 180x240 and 2.3 MiB at 480x640, more
// than the 227 KB of shared memory a block may use, so a shared-memory
// histogram would need row bands; that, and writing the histogram once, is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(int16_t v) { return (int)v; }

template <typename T>
__global__ void hist_kernel(const T* __restrict__ windows, int N, int ch,
                            int H, int W, float* __restrict__ out) {
  const int m = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N) return;
  const T* ev = windows + ((size_t)m * N + e) * ch;
  const int x = to_int(ev[0]);
  const int y = to_int(ev[1]);
  const T p = ev[ch - 1];
  // bounds on the signed values: centred packed events can be < 0 or >= W/H
  if (p == T(0) || x < 0 || x >= W || y < 0 || y >= H) return;
  const int row = y + (p < T(0) ? H : 0);
  atomicAdd(out + ((size_t)m * 2 * H + row) * W + x, 1.0f);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// windows: [M, N, ch] float32 (is_int16 = 0) or int16 (is_int16 = 1),
// polarity in the last channel. out: float32 [M, 2, H, W], fully written.
// Returns cudaErrorInvalidValue for N >= 2^24, where float counts could
// stop being exact.
int event_histogram(const void* windows, int M, int N, int ch, int is_int16,
                    int H, int W, void* out, void* stream) {
  if (N >= (1 << 24)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n_out = (size_t)M * 2 * H * W;
  cudaError_t err = cudaMemsetAsync(out, 0, n_out * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (M > 0 && N > 0) {
    const int threads = 256;
    dim3 grid((N + threads - 1) / threads, M);
    if (is_int16) {
      hist_kernel<int16_t><<<grid, threads, 0, s>>>(
          (const int16_t*)windows, N, ch, H, W, (float*)out);
    } else {
      hist_kernel<float><<<grid, threads, 0, s>>>(
          (const float*)windows, N, ch, H, W, (float*)out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
