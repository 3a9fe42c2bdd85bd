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
// HBM time at the H100's 3.35 TB/s) and does ~150 FLOPs of dependent
// arithmetic.
//
// What the design does about it (riccati_kernel.cuh): the step's inputs are
// staged into shared memory with cp.async one step ahead, so a step's loads
// are in flight under the previous step's chain; a scenario runs on a group
// of G lanes (ops/riccati.py lane_plan: G and the scenarios a block, per
// dim and dtype), each lane computing its columns of the step's products.
// The value function and the blocks the lanes exchange stay in shared
// memory, the rest in registers. Every access to device memory is in the
// JAX kernel layout [T, entries, B], neighbouring scenarios on neighbouring
// addresses.
//
// Arithmetic mirrors _riccati_step_math op for op (the step helpers of
// riccati_step.cuh): Q blocks from V and the regularized V + mu I, an
// unrolled Cholesky of the regularized Quu with a per-lane fail flag (pivot
// <= 0 or non-finite; sqrt clamped at 1e-30), k and K by two triangular
// solves, dV1/dV2 from the UNregularized Q terms, and V' computed on its
// upper triangle and mirrored.
#include "riccati_kernel.cuh"

namespace {
using tfmpc::Insts;
using tfmpc::NG;
// (n, G) instantiated, as ops/riccati.py LANE_PLANS' K1 row
#ifdef TFMPC_LANE_ALL_G
using F32 = tfmpc::AllLaneG;
#else
using F32 = Insts<NG<2, 1>, NG<3, 4>, NG<5, 8>, NG<6, 8>>;
#endif
using F64 = Insts<NG<2, 1>, NG<3, 4>, NG<5, 8>, NG<6, 8>>;
}  // namespace

extern "C" int tfmpc_riccati_backward(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int groups, int spb,
    long long smem_bytes, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Ilqr, F32, F64>(
      dtype, n, m, T, B, 0, in, out, groups, spb, smem_bytes, stream);
}

// The dynamic shared bytes of a lane-kernel block of ``spb`` scenarios
// (riccati_step.cuh lane_smem_bytes), for the variant (``box``, ``ddp``)
// and the dtype: what a launch requires of its plan, so the wrapper can
// check its own sum.
extern "C" long long tfmpc_riccati_lane_smem_bytes(int box, int ddp,
                                                   int dtype, int n, int m,
                                                   int spb) {
  return tfmpc::lane_smem_bytes(box != 0, ddp != 0,
                                dtype == tfmpc::kFloat64 ? 8 : 4, n, m, spb);
}

extern "C" const char* tfmpc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
