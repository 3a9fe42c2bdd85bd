// K6a: the full second-order DDP Riccati backward pass in one kernel,
// unconstrained (riccati_kernel.cuh, variant Ddp). Its control-limited
// sibling K6b (variant DdpBoxqp) is riccati_ddp_boxqp.cu; this comment
// covers both.
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw with the
// dynamics Hessians fxx/fux/fuu (adapters riccati_backward_ddp_pallas and
// riccati_backward_ddp_boxqp_pallas; body _kernel with the sec branch of
// _riccati_step_math).
//
// K6a is K1 and K6b is K4 with ddp_terms (riccati_step.cuh) between the Q
// blocks and the gains: sum_p v[p] fxx[p], fux[p] and fuu[p] enter Qxx, Qux
// and Quu, plain and regularized, and QuuR gets + mu I_m after t_uu (the
// combined regularization). dV1/dV2 and the value update keep the
// unregularized blocks.
//
// What bounds it on this card: the Hessians multiply the bytes. K6a at the
// navigation headline (n = m = 2, B = 4096, T = 100) reads 46 values per
// step and scenario and writes 6 (~85 MB in f32, ~0.03 ms at the H100's
// 3.35 TB/s); K6b at reservoir-5 (n = m = 5, B = 2048, T = 100) reads 515
// and writes 35 (~450 MB, ~0.13 ms). The n^3 + 2 n^2 m contraction adds
// ~2 n (n^2 + 2 n m) operations per step, small beside K4's boxQP. As in K1
// and K4, the serial chain of T steps per scenario is what bounds it: the
// kernel is latency-bound, and one thread a scenario waited for each step's
// 46 loads at the start of that step.
//
// What the design does about it: the Hessians are staged into shared
// memory with the step's other inputs, one step ahead (riccati_kernel.cuh),
// so they arrive under the previous step's chain; each lane folds the
// entries of its own columns into its Q blocks (ddp_terms). The launch
// plan (ops/riccati.py lane_plan) sets G and the scenarios a block per dim
// and dtype. K6a and K6b are built in sources of their own, so that the
// parallel build compiles them side by side with K1 and K4.
#include "riccati_kernel.cuh"

namespace {
using tfmpc::Insts;
using tfmpc::NG;
// (n, G) instantiated: ops/riccati.py LANE_PLANS' K6a row, and every G at
// n = 2 for chip_smoke.py's sweep at the navigation headline
using Plan = Insts<NG<2, 2>, NG<3, 8>, NG<5, 8>, NG<6, 8>>;
#ifdef TFMPC_LANE_ALL_G
using F32 = tfmpc::AllLaneG;
#else
using F32 = tfmpc::Cat<Plan, Insts<NG<2, 1>, NG<2, 4>, NG<2, 8>>>::type;
#endif
using F64 = Plan;
}  // namespace

extern "C" int tfmpc_riccati_backward_ddp(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* fxx, const void* fux,
    const void* fuu, const void* VT, const void* vT, void* K, void* k,
    void* dV1, void* dV2, void* fail, int groups, int spb,
    long long smem_bytes, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, fxx, fux, fuu, VT,
                      vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Ddp, F32, F64>(
      dtype, n, m, T, B, 0, in, out, groups, spb, smem_bytes, stream);
}
