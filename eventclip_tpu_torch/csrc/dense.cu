// D1: the bf16 dense product of the towers on Hopper (sm_90a):
//   out[M, N] = bf16(x[M, K] @ w[N, K]^T + b[N])
// x and w bf16 (row-major, K contiguous), b f32 or absent, out bf16.
//
// Replaces no TPU kernel: the JAX package's `dense` (models/clip/model.py)
// is an einsum that XLA lowers to a dot with the f32 bias add and the
// rounding fused into its epilogue. The port's first route, a library GEMM
// writing its f32 accumulator (`addmm(out_dtype=f32)`, the bias broadcast
// to [M, N] as its C) and a cast after it, wrote and read an f32 [M, N]
// matrix per product: at the serving request's M = 82,240 tokens about
// 12 GB a block, more card time than the products themselves. This kernel
// is the fused dot: the arithmetic of `dense` exactly, in its order:
//   bf16 x bf16 products summed in f32 (wgmma), + the f32 bias in the
//   accumulator's registers, one rounding to bf16 (round to nearest even);
// only the order of the f32 sums differs from another GEMM's.
//
// Bound on this card: operations. One ViT-L/14 block at M = 82,240 does
// 2 M (3d^2 + d^2 + 2 d m) = 2.07 TFLOP (d 1024, m 4096): 2.09 ms at 989
// TFLOP/s, against 2.7 GB of operands and outputs, 0.81 ms at 3.35 TB/s.
// What holds a tensor-core GEMM below that peak, and what the design does:
//   - feeding the tensor cores: a persistent block on each SM walks over
//     128 x BN output tiles (BN 256, or 128 where 256-wide tiles would not
//     give every SM one), n fastest, so the blocks in flight share each
//     A row panel and the whole of w through L2. One producer warp keeps
//     TMA copies of the K-major A [128, 64] and B [BN, 64] tiles (128-byte
//     swizzle, the layout wgmma reads) in flight through a ring of
//     D1_STAGES_256 / D1_STAGES_128 stages tracked by full / empty
//     mbarriers, also across the tile boundary;
//   - issue: two consumer warpgroups each take 64 rows of the tile and run
//     m64nBNk16 wgmma from shared memory (4 a stage), keeping one stage's
//     products in flight while the next stage is waited for, and release
//     a stage once the products that read it are done;
//   - the epilogue: the bias is added to the f32 accumulator in registers
//     and rounded once; each 64 x 64 piece is staged in shared memory in
//     the output map's swizzle (no bank conflicts) and stored by TMA (two
//     staging buffers a warpgroup, so a piece is written while the last
//     one is stored), which clips the rows past M and columns past N. The
//     producer has meanwhile filled the ring with the next tile's stages.
// The ragged edges need no code: TMA fills rows past M or N and columns
// past K with zeros on load, and the store clips. No f32 [M, N] matrix is
// ever written.
//
// Shape rule (ops/dense.py `d1_takes`): TMA needs 16-byte rows, so K and N
// are multiples of 8; the launcher also needs 16-byte-aligned bases.
#include "attention_common.cuh"

// Ring stages a tile width: 48 KB a stage at BN = 256 (4 stages and the
// staging buffers take 224 KB of the 227 KB a block may have), 32 KB at 128
#ifndef D1_STAGES_256
#define D1_STAGES_256 4
#endif
#ifndef D1_STAGES_128
#define D1_STAGES_128 6
#endif

namespace {

using namespace attn;

constexpr int kBM = 128;  // rows of an output tile, 64 a consumer warpgroup
constexpr int kBK = 64;   // k of one stage: a 128-byte row, the swizzle's span
constexpr int kSwz = 128;  // bytes of the swizzle (1 in the descriptors)
constexpr int kConsumers = 2;
constexpr int kProducerWarp = kConsumers * 4;
constexpr int kThreads = kConsumers * kWarpgroup + 32;  // + the producer warp
constexpr int kPiece = 64;  // columns of one staged output piece (128 bytes)
constexpr unsigned kPieceBytes = 64 * kPiece * 2;  // 8 KB

template <int BN>
struct Cfg {
  static_assert(BN == 256 || BN == 128, "tile width: 256 or 128");
  static constexpr int kStages = BN == 256 ? D1_STAGES_256 : D1_STAGES_128;
  static constexpr unsigned kABytes = kBM * kBK * 2;  // 16 KB
  static constexpr unsigned kBBytes = BN * kBK * 2;   // 32 or 16 KB
  static constexpr unsigned kStageBytes = kABytes + kBBytes;
  // the ring, two staging buffers a consumer warpgroup, the barriers
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes +
                                  2 * kConsumers * kPieceBytes +
                                  2 * 8 * kStages;
};

// d (+)= A . B^T, m64n256k16, A and B K-major in shared memory; accumulate
// 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same, m64n128k16
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// this thread's TMA stores but the newest have read their shared memory
__device__ __forceinline__ void bulk_wait_read_all_but_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// The 4 k-steps of one stage for consumer warpgroup cg: its 64 rows of the
// A tile against the whole B tile, both K-major with 128-byte rows (a
// k-step of 16 is 32 bytes further along the row; 8-row groups 1024 bytes
// apart). acc0: accumulate at the first k-step (0 starts the tile's sum).
template <int BN>
__device__ __forceinline__ void issue_stage(float (&acc)[BN / 8][4],
                                            const unsigned char* stage,
                                            int cg, int acc0) {
  const uint32_t a = smem_u32(stage) + cg * 64 * kSwz;
  const uint32_t b = smem_u32(stage) + Cfg<BN>::kABytes;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss(acc, smem_desc<kSwz>(a + 32 * kk, 16, 8 * kSwz),
             smem_desc<kSwz>(b + 32 * kk, 16, 8 * kSwz), kk == 0 ? acc0 : 1);
}

// One persistent block of two consumer warpgroups and a producer warp
// walks the 128 x BN output tiles t = blockIdx.x, + gridDim.x, ... (n
// fastest). The producer's first lane copies each tile's K in 64-wide
// stages, A [128, 64] and B [BN, 64] on the stage's full barrier, once the
// stage's empty barrier says every consumer thread is done with it. Each
// consumer warpgroup sums its 64 rows of the tile over the stages (one
// stage's products in flight while it waits for the next), adds the bias
// and rounds, and stores 64 x 64 pieces by TMA.
template <int BN, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
dense_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                   const __grid_constant__ CUtensorMap mb,
                   const __grid_constant__ CUtensorMap mo,
                   const float* __restrict__ bias, int M, int N, int K) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char d1_smem[];
  unsigned char* ring = d1_smem;
  unsigned char* staged = d1_smem + (size_t)kStages * C::kStageBytes;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staged + 2 * kConsumers * kPieceBytes);
  uint64_t* empty = full + kStages;

  const int ntiles = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * ntiles;
  const int ktiles = (K + kBK - 1) / kBK;
  const int warp = warp_index(), lane = threadIdx.x % 32;

  check_smem_base(d1_smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * kWarpgroup);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      int s = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / ntiles) * kBM, n0 = (t % ntiles) * BN;
        for (int kt = 0; kt < ktiles; ++kt) {
          // a fresh barrier passes the wait for parity 1: the first round
          // fills every stage at once
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* st = ring + (size_t)s * C::kStageBytes;
          mbar_expect_tx(&full[s], C::kStageBytes);
          tma_load(st, &ma, &full[s], kt * kBK, m0, 0, 0);
          tma_load(st + C::kABytes, &mb, &full[s], kt * kBK, n0, 0, 0);
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int cg = warp / 4, wt = threadIdx.x % kWarpgroup;
  // this lane's rows of the warpgroup's 64: row and row + 8
  const int row = 16 * (warp % 4) + lane / 4, t2 = 2 * (lane % 4);
  unsigned char* own = staged + (size_t)cg * 2 * kPieceBytes;
  float acc[BN / 8][4];  // each tile's first k-step overwrites it
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  int s = 0;
  unsigned phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / ntiles) * kBM, n0 = (t % ntiles) * BN;

    // the mainloop: every stage's products issued once it has landed; the
    // stage before is released once they are done (wgmma_wait<1>)
    wgmma_fence();  // the last tile's epilogue read acc
    mbar_wait(&full[s], phase);
    issue_stage<BN>(acc, ring + (size_t)s * C::kStageBytes, cg, 0);
    wgmma_commit();
    int prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
    for (int kt = 1; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      issue_stage<BN>(acc, ring + (size_t)s * C::kStageBytes, cg, 1);
      wgmma_commit();
      wgmma_wait<1>();
      mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(&empty[prev]);

    // the epilogue: acc + bias rounded once, in 64 x 64 pieces through
    // the two staging buffers to TMA stores (pieces wholly past M or N are
    // skipped; the store clips the rest)
    const int r0 = m0 + 64 * cg;
#pragma unroll
    for (int c = 0; c < BN / kPiece; ++c) {
      const int c0 = n0 + kPiece * c;
      if (r0 >= M || c0 >= N) continue;  // the same in the whole warpgroup
      unsigned char* buf = own + (c & 1) * kPieceBytes;
      if (wt == 0) bulk_wait_read_all_but_one();  // buf's last store read it
      warpgroup_sync(1 + cg);
#pragma unroll
      for (int n = 0; n < kPiece / 8; ++n) {
        const int nb = (kPiece / 8) * c + n, col = c0 + 8 * n + t2;
        float b0 = 0.f, b1 = 0.f;
        if (kBias && c0 + 8 * n < N) {  // N is a multiple of 8
          b0 = __ldg(bias + col);
          b1 = __ldg(bias + col + 1);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = (row + 8 * half) * kSwz + 16 * n + 2 * t2;
          const uint32_t sw = at ^ (((at >> 7) & (kSwz / 16 - 1)) << 4);
          *reinterpret_cast<uint32_t*>(buf + sw) =
              pack_bf16(acc[nb][2 * half] + b0, acc[nb][2 * half + 1] + b1);
        }
      }
      fence_async_smem();
      warpgroup_sync(1 + cg);
      if (wt == 0) {
        tma_store(&mo, buf, c0, r0, 0, 0);
        bulk_commit();
      }
    }
  }
  if (wt == 0) bulk_wait();
}

// A row-major [rows, cols] bf16 matrix as a tensor map: boxes of `box_rows`
// rows x 64 columns (128 bytes, the swizzle)
MapGeom matrix_geom(long long rows, long long cols, long long box_rows) {
  const long long row_bytes = 2 * cols;
  return MapGeom{{cols, rows, 1, 1},
                 {row_bytes, row_bytes * rows, row_bytes * rows},
                 {kBK, box_rows, 1, 1},
                 kSwz};
}

template <int BN, bool kBias>
cudaError_t launch(const void* x, const void* w, const float* bias, void* out,
                   int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap ma, mb, mo;
  cudaError_t err;
  if ((err = encode_map(&ma, x, matrix_geom(M, K, kBM), true)) != cudaSuccess ||
      (err = encode_map(&mb, w, matrix_geom(N, K, BN), true)) != cudaSuccess ||
      (err = encode_map(&mo, out, matrix_geom(M, N, 64), true)) != cudaSuccess)
    return err;
  auto kernel = dense_wgmma_kernel<BN, kBias>;
  if ((err = allow_smem(kernel, Cfg<BN>::kSmem)) != cudaSuccess) return err;
  kernel<<<grid, kThreads, Cfg<BN>::kSmem, stream>>>(ma, mb, mo, bias, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out [M, N] = bf16(x [M, K] @ w [N, K]^T + bias [N]) (bias f32 or null),
// all contiguous, bases 16-byte aligned, K and N multiples of 8; bn the
// tile width (256 or 128) and grid the persistent blocks, as ops/dense.py
// dense_plan chooses them.
int dense_bf16(const void* x, const void* w, const void* bias, void* out,
               int M, int N, int K, int bn, int grid, void* stream) {
  if (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) % 16 != 0 ||
      ((uintptr_t)bias % 4) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % 8 != 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  const float* b = (const float*)bias;
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 256)
    return (int)(b ? launch<256, true>(x, w, b, out, M, N, K, grid, s)
                   : launch<256, false>(x, w, b, out, M, N, K, grid, s));
  if (bn == 128)
    return (int)(b ? launch<128, true>(x, w, b, out, M, N, K, grid, s)
                   : launch<128, false>(x, w, b, out, M, N, K, grid, s));
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
