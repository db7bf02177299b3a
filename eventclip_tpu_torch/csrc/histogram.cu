// Per-window polarity event histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel eventclip_tpu/ops/rasterize.py::_pallas_histograms
// (kernel body _hist_kernel): for every window m and event e with x, y, p,
// add 1 at hist[m, y + H*[p<0], x]; events with p == 0 (padding) or outside
// [0, W) x [0, H) are dropped. Returns float32 [M, 2, H, W] (the layout and
// dtype _pallas_histograms returns) holding exact counts.
//
// Bound: bytes. Read M*N*ch*sizeof(elem) (M*N*6 for packed int16 windows),
// write M*2*H*W*4 once; no arithmetic to speak of. For the N-Caltech serving
// batch (M = 320 windows of N = 20000 packed events, 180x240) that is
// 38.4 MB + 110.6 MB, 0.0445 ms at 3.35 TB/s; for the N-ImageNet training
// batch ([256, 70000, 3] @ 480x640) 107.5 MB + 629.1 MB, 0.2199 ms.
//
// The TPU counts with one-hot tiles on the MXU because a scatter serialises
// there, and keeps the [2H, W] accumulator in VMEM. On Hopper a histogram
// is a scatter, and the accumulator goes to shared memory: each window's
// counts are built there and written to device memory once, with 16-byte
// stores and no memset, so the kernel moves only the bound's bytes (each
// event read once, each output written once). One window's u32 counts are
// 337.5 KiB at 180x240 and 2.34 MiB at 480x640, more than one block's
// 227 KB, so a window is split over a thread-block cluster:
//   - each CTA of the cluster owns `rows` consecutive rows of the window's
//     [2H, W] plane in its shared memory (u32 counts), and zeroes them;
//   - cluster.sync(); each CTA reads a 1/cluster slice of the window's
//     events once (coalesced) and adds 1 for each live event into the
//     owning CTA's counts, through distributed shared memory (its own with
//     a plain shared atomic);
//   - cluster.sync(); each CTA converts its counts to f32 and stores its
//     rows (16-byte stores).
// A frame larger than 16 CTAs' shared memory (more than about 930k bins)
// runs in row bands: one cluster per (window, band), each reading the
// window's events once per band (from L2). The plan (cluster size, rows a
// CTA, bands) comes from ops/rasterize.py::histogram_plan, which the CPU
// tests check; clusters above 8 CTAs are a non-portable size, allowed with
// cudaFuncAttributeNonPortableClusterSizeAllowed.
//
// u32 counts are exact, and f32 holds them exactly below 2^24; no bin can
// exceed the window's N events, and the launcher refuses N >= 2^24.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCluster = 16;

__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }
__device__ __forceinline__ int to_int(int16_t v) { return (int)v; }

// x, y and p of event e (polarity in the last channel); `vec`: the f32
// [.., 4] layout from a 16-byte-aligned base, read as one 16-byte load an
// event (any other base of that layout reads scalars)
template <typename T>
__device__ __forceinline__ void read_event(const T* ev, int ch, bool vec,
                                           int* x, int* y, T* p) {
  *x = to_int(ev[0]);
  *y = to_int(ev[1]);
  *p = ev[ch - 1];
}
template <>
__device__ __forceinline__ void read_event<float>(const float* ev, int ch,
                                                  bool vec, int* x, int* y,
                                                  float* p) {
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(ev);
    *x = to_int(v.x);
    *y = to_int(v.y);
    *p = v.w;
  } else {
    *x = to_int(ev[0]);
    *y = to_int(ev[1]);
    *p = ev[ch - 1];
  }
}

// grid: (cluster * bands, windows); cluster dims (cluster, 1, 1). CTA `rank`
// of band `band` owns plane rows [band * cluster * rows + rank * rows, + rows)
// (clipped to 2H) of window m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ windows, int M, int N, int ch, bool vec,
            int H, int W, int rows, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t counts[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int band = blockIdx.x / csize;
  const int R = 2 * H;
  const int band_r0 = band * csize * rows;
  const int band_r1 = min(band_r0 + csize * rows, R);
  const int r0 = min(band_r0 + rank * rows, R);
  const int r1 = min(r0 + rows, R);
  const int n_own = (r1 - r0) * W;  // bins this CTA owns
  const int slice = (N + csize - 1) / csize;
  const int e0 = min(rank * slice, N), e1 = min(e0 + slice, N);

  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    // zero this CTA's rows (16-byte stores; the buffer is 16-byte padded)
    uint4* c4 = reinterpret_cast<uint4*>(counts);
    for (int i = threadIdx.x; i < (n_own + 3) / 4; i += blockDim.x)
      c4[i] = make_uint4(0u, 0u, 0u, 0u);
    cluster.sync();  // every CTA's counts are zero before any event lands

    const T* win = windows + (size_t)m * N * ch;
    for (int e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
      int x, y;
      T p;
      read_event(win + (size_t)e * ch, ch, vec, &x, &y, &p);
      // bounds on the signed values: centred packed events can be < 0 or
      // >= W/H
      if (p == T(0) || x < 0 || x >= W || y < 0 || y >= H) continue;
      const int row = y + (p < T(0) ? H : 0);
      if (row < band_r0 || row >= band_r1) continue;
      const int owner = (row - band_r0) / rows;
      const int bin = (row - band_r0 - owner * rows) * W + x;
      if (owner == rank)
        atomicAdd(counts + bin, 1u);
      else
        atomicAdd(cluster.map_shared_rank(counts, owner) + bin, 1u);
    }
    cluster.sync();  // every event has landed; no remote access after this

    // counts -> f32, this CTA's rows only: a scalar head up to a 16-byte
    // boundary of the output, 16-byte stores, a scalar tail
    float* dst = out + ((size_t)m * R + r0) * W;
    const int head = min((int)((16 - ((uintptr_t)dst & 15)) & 15) / 4, n_own);
    const int body = (n_own - head) / 4;
    if ((int)threadIdx.x < head) dst[threadIdx.x] = (float)counts[threadIdx.x];
    float4* d4 = reinterpret_cast<float4*>(dst + head);
    for (int i = threadIdx.x; i < body; i += blockDim.x) {
      const uint32_t* c = counts + head + 4 * i;
      d4[i] = make_float4((float)c[0], (float)c[1], (float)c[2], (float)c[3]);
    }
    for (int i = head + 4 * body + threadIdx.x; i < n_own; i += blockDim.x)
      dst[i] = (float)counts[i];
    __syncthreads();  // the counts are read before the next window zeroes them
  }
}

template <typename T>
cudaError_t launch(const void* windows, int M, int N, int ch, int H, int W,
                   int cluster, int rows, int bands, void* out,
                   cudaStream_t stream) {
  auto kernel = hist_kernel<T>;
  const size_t smem = (((size_t)rows * W + 3) / 4) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * bands), (unsigned)min(M, 65535), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = ch == 4 && ((uintptr_t)windows & 15) == 0;
  return cudaLaunchKernelEx(&cfg, kernel, (const T*)windows, M, N, ch, vec, H,
                            W, rows, (float*)out);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// windows: [M, N, ch] float32 (is_int16 = 0) or int16 (is_int16 = 1),
// polarity in the last channel, at any alignment. out: float32 [M, 2, H, W], fully written
// (never zeroed beforehand). The plan (ops/rasterize.py::histogram_plan):
// clusters of `cluster` CTAs (1..16), `rows` plane rows a CTA, `bands`
// clusters a window, covering all 2H rows. Returns cudaErrorInvalidValue
// for N >= 2^24 (f32 counts could stop being exact) or a plan that does not
// cover the plane.
int event_histogram(const void* windows, int M, int N, int ch, int is_int16,
                    int H, int W, int cluster, int rows, int bands, void* out,
                    void* stream) {
  if (N < 0 || N >= (1 << 24) || H <= 0 || W <= 0 || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || bands < 1 ||
      (long long)cluster * rows * bands < 2LL * H ||
      (long long)(bands - 1) * cluster * rows >= 2LL * H)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      is_int16 ? launch<int16_t>(windows, M, N, ch, H, W, cluster, rows, bands, out, s)
               : launch<float>(windows, M, N, ch, H, W, cluster, rows, bands, out, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
