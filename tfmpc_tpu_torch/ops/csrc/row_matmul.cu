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
// What the design does about it: K7's scheme for a product, with the
// layout's scenarios on the fastest axis. A block stages SB neighbouring
// scenarios' A and M in shared memory (SB = 8 in float32, 4 in float64:
// one 32-byte sector per entry, so the loads and stores use whole
// sectors), then its threads take the (entry, scenario) pairs of C, each a
// d-term dot product read from shared memory; C goes straight to global
// memory. At d = 48 that is 147,456 bytes of shared memory per block.
#include "common.cuh"

namespace tfmpc {
namespace {

constexpr int kMaxDim = 48;

template <typename S>
__host__ __device__ constexpr int scenarios_per_block() {
  return 32 / static_cast<int>(sizeof(S));
}

template <typename S>
__global__ void row_matmul_kernel(const S* __restrict__ A,
                                  const S* __restrict__ M, S* __restrict__ C,
                                  int d, int B) {
  constexpr int SB = scenarios_per_block<S>();
  extern __shared__ unsigned char smem_raw[];
  S* As = reinterpret_cast<S*>(smem_raw);  // [d*d, SB]
  S* Ms = As + d * d * SB;
  const int b0 = blockIdx.x * SB;
  const int width = min(SB, B - b0);
  const int dd = d * d;
  for (int e = threadIdx.x; e < dd * SB; e += blockDim.x) {
    const int entry = e / SB, s = e % SB;
    if (s < width) {
      const int64_t g = static_cast<int64_t>(entry) * B + b0 + s;
      As[e] = A[g];
      Ms[e] = M[g];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < dd * SB; e += blockDim.x) {
    const int entry = e / SB, s = e % SB;
    if (s >= width) continue;
    const int p = entry / d, q = entry % d;
    S acc = 0;
    for (int k = 0; k < d; ++k)
      acc += As[(p * d + k) * SB + s] * Ms[(k * d + q) * SB + s];
    C[static_cast<int64_t>(entry) * B + b0 + s] = acc;
  }
}

template <typename S>
int launch(int d, int B, const void* A, const void* M, void* C, int block,
           cudaStream_t stream) {
  constexpr int SB = scenarios_per_block<S>();
  const size_t bytes = 2 * static_cast<size_t>(d) * d * SB * sizeof(S);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_matmul_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  row_matmul_kernel<S><<<blocks_for(B, SB), block, bytes, stream>>>(
      static_cast<const S*>(A), static_cast<const S*>(M), static_cast<S*>(C),
      d, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tfmpc

// dtype 0 float32, 1 float64; A, M, C [d*d, B]; d in 1..48.
extern "C" int tfmpc_row_matmul(int dtype, int d, int B, const void* A,
                                const void* M, void* C, int block,
                                void* stream) {
  using namespace tfmpc;
  if (d < 1 || d > kMaxDim || block < 32 || block > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(d, B, A, M, C, block, s);
  if (dtype == kFloat64) return launch<double>(d, B, A, M, C, block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
