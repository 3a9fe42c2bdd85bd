// P1: C[b] = A[b] M[b] for d x d matrices in the row layout [d*d, B]
// (entry i*d + j of scenario b at (i*d + j) * B + b), float32 and float64.
// The probe of K7's core operation, a batched small matrix product; on no
// solver path.
//
// Replaces: benchmarks/mxu_probe.py:_row_kernel_matmul (the row-layout
// Pallas kernel over riccati_mid_pallas.py:_matmul_rows).
//
// What bounds it on this card: each input entry is read once and each
// output written once, 3 d^2 B values (at d = 48, B = 1024, f32: 28.3 MB,
// 0.0085 ms at 3.35 TB/s), against 2 d^3 B operations (0.23 GFLOP, 0.0034
// ms at 67 TFLOP/s): bytes.
//
// What the design does about it: a scenario's A and M are read from
// device memory once, in whole 32-byte sectors, and every reuse of an
// entry comes from shared memory or registers. A block takes SB
// neighbouring scenarios (8 in float32, 4 in float64: one sector an
// entry) and walks k in slabs of KS: the slab's columns of A and rows of M
// are copied into shared memory with cp.async, double-buffered, so the
// next slab's copy runs under the products of this one. Each thread takes
// one scenario and an R x Cc tile of its C in registers; a k step reads R
// entries of A and Cc of M from shared memory for R * Cc independent
// multiply-adds. A warp is SB scenarios by 32 / SB tiles of one tile
// column (its reads of M are broadcasts), and A's shared rows are padded
// so the tile rows of a warp fall in different banks. The tile comes from
// ops/riccati_mid.py per d, measured; at d = 48 in float32 (6 x 12 tiles)
// a block is 256 threads and 2 x 25,344 bytes of shared memory. Each
// entry is a d-term sum in ascending k; ragged edges are masked (a block
// past B stages and stores only its scenarios, tiles past d compute
// nothing). A version with no shared memory (a thread a scenario and a
// square register tile, A and M read from device memory) was 1.3-2.6x
// slower than this one on an H100 at every d of 16-48, best tile each
// (tools/kernel_versions.py), so both operands are staged.
#include "common.cuh"
#include "warp.cuh"

namespace tfmpc {
namespace {

constexpr int kMaxDim = 48;
constexpr int kSlab = 8;  // k values a stage

// Threads a block may have: 512 for tiles of at most 48 entries (their
// threads stay within 128 registers), else 256.
template <int R, int Cc>
__host__ __device__ constexpr int max_threads() {
  return R * Cc <= 48 ? 512 : 256;
}

// Shared layout of one stage: As[i][kk][s] with rows padded to
// kSlab * SB + pad (pad 4: a 16-byte step, so the tile rows R apart of a
// warp start in different banks), then Ms[kk][j][s].
template <int SB>
__host__ __device__ constexpr int a_row() { return kSlab * SB + 4; }
template <int SB>
__host__ __device__ constexpr int stage_elems(int d) {
  return d * a_row<SB>() + kSlab * d * SB;
}

template <typename S, int SB, int R, int Cc>
__global__ void __launch_bounds__(max_threads<R, Cc>())
    row_matmul_kernel(const S* __restrict__ A, const S* __restrict__ M,
                      S* __restrict__ C, int d, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* buf = reinterpret_cast<S*>(smem_raw);
  const int stage = stage_elems<SB>(d);
  const int b0 = blockIdx.x * SB;
  const int width = min(SB, B - b0);
  constexpr int kVec = 16 / sizeof(S);  // elements a 16-byte copy
  const bool whole = width == SB && B % kVec == 0;

  // copy slab k0's columns of A and rows of M into stage buffer st
  auto copy_slab = [&](int k0, S* st) {
    const int ks = min(kSlab, d - k0);
    S* As = st;
    S* Ms = st + d * a_row<SB>();
    if (whole) {
      constexpr int kPieces = SB / kVec;
      for (int e = threadIdx.x; e < d * ks * kPieces; e += blockDim.x) {
        const int p = e % kPieces, q = e / kPieces;  // q: (row, kk)
        const int r = q / ks, kk = q % ks;
        cp_async<16>(As + r * a_row<SB>() + kk * SB + p * kVec,
                     A + (static_cast<int64_t>(r) * d + k0 + kk) * B + b0 +
                         p * kVec);
        cp_async<16>(Ms + (kk * d + r) * SB + p * kVec,
                     M + (static_cast<int64_t>(k0 + kk) * d + r) * B + b0 +
                         p * kVec);
      }
    } else {
      for (int e = threadIdx.x; e < d * ks * SB; e += blockDim.x) {
        const int s = e % SB, q = e / SB;
        const int r = q / ks, kk = q % ks;
        if (s < width) {
          cp_async<sizeof(S)>(
              As + r * a_row<SB>() + kk * SB + s,
              A + (static_cast<int64_t>(r) * d + k0 + kk) * B + b0 + s);
          cp_async<sizeof(S)>(
              Ms + (kk * d + r) * SB + s,
              M + (static_cast<int64_t>(k0 + kk) * d + r) * B + b0 + s);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's scenario and tile: a warp is SB scenarios by 32 / SB
  // tile rows of one tile column
  constexpr int kRowsWarp = 32 / SB;
  const int Tr = (d + R - 1) / R, Tc = (d + Cc - 1) / Cc;
  const int s = threadIdx.x % SB, q = threadIdx.x / SB;
  const int w = q / kRowsWarp;
  const int tr = (w / Tc) * kRowsWarp + q % kRowsWarp, tc = w % Tc;
  const bool active = tr < Tr && s < width;
  const int i0 = tr * R, j0 = tc * Cc;
  int arow[R], mcol[Cc];
#pragma unroll
  for (int r = 0; r < R; ++r) arow[r] = min(i0 + r, d - 1) * a_row<SB>() + s;
#pragma unroll
  for (int c = 0; c < Cc; ++c) mcol[c] = min(j0 + c, d - 1) * SB + s;
  S acc[R][Cc];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < Cc; ++c) acc[r][c] = S(0);

  const int slabs = (d + kSlab - 1) / kSlab;
  copy_slab(0, buf);
  for (int sl = 0; sl < slabs; ++sl) {
    if (sl + 1 < slabs) {
      copy_slab((sl + 1) * kSlab, buf + ((sl + 1) & 1) * stage);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const S* As = buf + (sl & 1) * stage;
    const S* Ms = As + d * a_row<SB>();
    const int ks = min(kSlab, d - sl * kSlab);
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kSlab; ++kk) {
        if (kk >= ks) break;
        S av[R], mv[Cc];
#pragma unroll
        for (int r = 0; r < R; ++r) av[r] = As[arow[r] + kk * SB];
#pragma unroll
        for (int c = 0; c < Cc; ++c) mv[c] = Ms[mcol[c] + kk * d * SB];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < Cc; ++c) acc[r][c] += av[r] * mv[c];
      }
    }
    __syncthreads();  // the buffer is copied into again two slabs on
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (i0 + r >= d) break;
#pragma unroll
    for (int c = 0; c < Cc; ++c)
      if (j0 + c < d)
        C[(static_cast<int64_t>(i0 + r) * d + j0 + c) * B + b0 + s] =
            acc[r][c];
  }
}

// A block: 32 Tc ceil(Tr SB / 32) threads (Tr, Tc tiles down and across)
// and two stages of shared memory (ops/riccati_mid.py RowPlan repeats
// both).
template <typename S, int SB, int R, int Cc>
int launch(int d, int B, const void* A, const void* M, void* C,
           cudaStream_t stream) {
  const size_t bytes = 2 * static_cast<size_t>(stage_elems<SB>(d)) *
                       sizeof(S);
  const int Tr = (d + R - 1) / R, Tc = (d + Cc - 1) / Cc;
  const int threads = 32 * Tc * ((Tr * SB + 31) / 32);
  if (threads > max_threads<R, Cc>())
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = row_matmul_kernel<S, SB, R, Cc>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks_for(B, SB), threads, bytes, stream>>>(
      static_cast<const S*>(A), static_cast<const S*>(M), static_cast<S*>(C),
      d, B);
  return static_cast<int>(cudaGetLastError());
}

// The instantiated tiles (ops/riccati_mid.py ROW_TILES), R x Cc: 2 x 4,
// 3 x 6, 4 x 8 and 6 x 12; 32 bytes of scenarios a block (8 in float32, 4
// in float64: one sector of each entry).
template <typename S>
int launch_tile(int rows, int cols, int d, int B, const void* A,
                const void* M, void* C, cudaStream_t stream) {
  constexpr int SB = 32 / sizeof(S);
  if (rows == 2 && cols == 4) return launch<S, SB, 2, 4>(d, B, A, M, C, stream);
  if (rows == 3 && cols == 6) return launch<S, SB, 3, 6>(d, B, A, M, C, stream);
  if (rows == 4 && cols == 8) return launch<S, SB, 4, 8>(d, B, A, M, C, stream);
  if (rows == 6 && cols == 12)
    return launch<S, SB, 6, 12>(d, B, A, M, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tfmpc

// dtype 0 float32, 1 float64; A, M, C [d*d, B]; d in 1..48; the register
// tile's rows and columns from the plan.
extern "C" int tfmpc_row_matmul(int dtype, int d, int B, const void* A,
                                const void* M, void* C, int rows, int cols,
                                void* stream) {
  using namespace tfmpc;
  if (d < 1 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_tile<float>(rows, cols, d, B, A, M, C, s);
  if (dtype == kFloat64)
    return launch_tile<double>(rows, cols, d, B, A, M, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
