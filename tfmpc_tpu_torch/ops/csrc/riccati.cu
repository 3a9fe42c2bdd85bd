// K1: the whole batched, regularized Riccati backward pass of iLQR in one
// kernel.
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw (adapter
// riccati_backward_pallas; body _kernel / _riccati_step_math /
// _chol_unrolled / _chol_solve_unrolled), unconstrained variant.
//
// What bounds it on this card: the T steps of one scenario form a serial
// chain (V_t depends on V_{t+1}), so the kernel is latency-bound, not
// bandwidth- or FLOP-bound. At n = m = 2 a step reads 22 scalars and writes
// 6 per scenario (B=4096, T=100, f32: ~11 MB in all, a few microseconds of
// HBM time at 3.35 TB/s) and does ~150 FLOPs of dependent arithmetic.
//
// What the design does about it: one thread owns one scenario and keeps the
// value function (V, v), the accumulators and every intermediate in
// registers for the whole chain; the dims are template parameters so all
// small-matrix loops unroll. Inputs keep the JAX kernel layout
// [T, entries, B], so the 32 threads of a warp read 32 consecutive
// addresses: every load and store is coalesced. A step's loads do not
// depend on the chain, so they are issued ahead of its arithmetic. At
// B=4096 there are only 4096 threads; blocks of 32 give 128 blocks, one per
// SM on 128 of the 132 SMs, rather than 16 blocks of 256 on 16 SMs.
//
// Arithmetic mirrors _riccati_step_math op for op (the step helpers of
// riccati_step.cuh): Q blocks from V and the regularized V + mu I, an
// unrolled Cholesky of the regularized Quu with a per-lane fail flag (pivot
// <= 0 or non-finite; sqrt clamped at 1e-30), k and K by two triangular
// solves, dV1/dV2 from the UNregularized Q terms, and V' computed on its
// upper triangle and mirrored.
#include "riccati_step.cuh"

namespace tfmpc {
namespace {

template <typename S, int N, int M>
__global__ void riccati_backward_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ VT, const S* __restrict__ vT,
    S* __restrict__ K_out, S* __restrict__ k_out, S* __restrict__ dV1_out,
    S* __restrict__ dV2_out, S* __restrict__ fail_out, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  S V[N][N], v[N];
  load_final<S, N>(VT, vT, b, B, V, v);
  const S mu = mu_in[b];
  S dV1 = 0, dV2 = 0;
  bool fail = false;

  for (int t = T - 1; t >= 0; --t) {
    QBlocks<S, N, M> q;
    q_blocks<S, N, M>(fx, fu, lx, lu, lxx, luu, lux, t, b, B, V, v, mu, q);

    // Cholesky of QuuR with the per-lane PD probe.
    S L[M][M];
    chol_probe<S, M>(q.QuuR, L, fail);

    // k = -QuuR^-1 Qu ; column i of K = -QuuR^-1 QuxR[:, i]
    S kv[M], Kt[M][N];
#pragma unroll
    for (int col = 0; col <= N; ++col) {
      S rhs[M], xs[M];
#pragma unroll
      for (int a = 0; a < M; ++a) rhs[a] = (col == N) ? q.Qu[a] : q.QuxR[a][col];
      chol_solve<S, M>(L, rhs, xs);
#pragma unroll
      for (int a = 0; a < M; ++a) {
        if (col == N) kv[a] = -xs[a];
        else Kt[a][col] = -xs[a];
      }
    }

    value_update<S, N, M>(q, kv, Kt, V, v, dV1, dV2);
    store_gains<S, N, M>(K_out, k_out, t, b, B, kv, Kt);
  }

  dV1_out[b] = dV1;
  dV2_out[b] = dV2;
  fail_out[b] = fail ? S(1) : S(0);
}

template <typename S, int N, int M>
int launch(int T, int B, const void* fx, const void* fu, const void* lx,
           const void* lu, const void* lxx, const void* luu, const void* lux,
           const void* mu, const void* VT, const void* vT, void* K, void* k,
           void* dV1, void* dV2, void* fail, int block, cudaStream_t stream) {
  riccati_backward_kernel<S, N, M>
      <<<blocks_for(B, block), block, 0, stream>>>(
          (const S*)fx, (const S*)fu, (const S*)lx, (const S*)lu,
          (const S*)lxx, (const S*)luu, (const S*)lux, (const S*)mu,
          (const S*)VT, (const S*)vT, (S*)K, (S*)k, (S*)dV1, (S*)dV2,
          (S*)fail, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace tfmpc

extern "C" int tfmpc_riccati_backward(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  using namespace tfmpc;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 2 && m == 2) {
    if (dtype == kFloat32)
      return launch<float, 2, 2>(T, B, fx, fu, lx, lu, lxx, luu, lux, mu, VT,
                                 vT, K, k, dV1, dV2, fail, block, s);
    if (dtype == kFloat64)
      return launch<double, 2, 2>(T, B, fx, fu, lx, lu, lxx, luu, lux, mu, VT,
                                  vT, K, k, dV1, dV2, fail, block, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tfmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
