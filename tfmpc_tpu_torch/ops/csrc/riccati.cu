// K1: the whole batched, regularized Riccati backward pass of iLQR in one
// kernel (riccati_kernel.cuh, variant Ilqr).
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
// addresses: every load and store is coalesced. At B=4096 there are only
// 4096 threads; blocks of 32 give 128 blocks, one per SM on 128 of the 132
// SMs, rather than 16 blocks of 256 on 16 SMs.
//
// Arithmetic mirrors _riccati_step_math op for op (the step helpers of
// riccati_step.cuh): Q blocks from V and the regularized V + mu I, an
// unrolled Cholesky of the regularized Quu with a per-lane fail flag (pivot
// <= 0 or non-finite; sqrt clamped at 1e-30), k and K by two triangular
// solves, dV1/dV2 from the UNregularized Q terms, and V' computed on its
// upper triangle and mirrored.
#include "riccati_kernel.cuh"

extern "C" int tfmpc_riccati_backward(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Ilqr>(dtype, n, m, T, B, 0, in, out,
                                            block, stream);
}

extern "C" const char* tfmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
