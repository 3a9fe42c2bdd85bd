// K4: the batched control-limited (boxQP) Riccati backward pass of iLQR in
// one kernel (riccati_kernel.cuh, variant Boxqp).
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw with
// boxqp_iters > 0 (adapter riccati_backward_boxqp_pallas; body _kernel /
// _riccati_step_math's boxQP branch / _boxqp_lane).
//
// Per scenario and step t = T-1 .. 0: the Q blocks with V + mu I, the PD
// probe of QuuR (sticky per-lane fail), then the fixed-iteration projected-
// Newton boxQP of ops/boxqp.py on (QuuR, Qu) within [lo - ubar_t,
// hi - ubar_t] and K from its final free set (boxqp.cuh says how, NaN
// semantics included). dV1/dV2 use the UNregularized Qu, Quu, and the value
// update is K1's (riccati_step.cuh).
//
// What bounds it on this card: at HVAC-6 (n = m = 6, B = 2048, T = 100) a
// step reads 198 values per scenario and writes 42 (~196 MB in f32, ~0.06
// ms of HBM time at the H100's 3.35 TB/s); the arithmetic is up to ~15k
// FLOPs per step and scenario with all 8 Newton x 8 line-search iterations.
// But the T steps of a scenario form a serial chain, and the boxQP loop
// inside a step is itself serial, so the kernel is bound by the latency of
// dependent arithmetic.
//
// What the design does about it (riccati_kernel.cuh): a group of G lanes a
// scenario. At n = m = 6 one thread a scenario needed ~300 values (V, five
// Q blocks, two factors, the boxQP vectors) and spilled past 255
// registers; with G = 8 a lane holds one column of each Q block and the
// exchanged blocks sit in the scenario's shared workspace. The Newton
// iterations run alike on every lane of the group, and the line search
// tries the eight step sizes side by side, one a lane, where one thread
// tried them one after another. The inputs of the next step are staged in
// shared memory while a step computes.
#include "riccati_kernel.cuh"

namespace {
using tfmpc::Insts;
using tfmpc::NG;
// (n, G) instantiated: ops/riccati.py LANE_PLANS' K4 row, and every G at
// n = 6 for chip_smoke.py's sweep at HVAC-6
using Plan = Insts<NG<2, 8>, NG<3, 8>, NG<5, 8>, NG<6, 8>>;
#ifdef TFMPC_LANE_ALL_G
using F32 = tfmpc::AllLaneG;
#else
using F32 = tfmpc::Cat<Plan, Insts<NG<6, 1>, NG<6, 2>, NG<6, 4>>>::type;
#endif
using F64 = Plan;
}  // namespace

extern "C" int tfmpc_riccati_backward_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* ubar,
    const void* lo, const void* hi, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int groups, int spb,
    long long smem_bytes, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Boxqp, F32, F64>(
      dtype, n, m, T, B, newton_iters, in, out, groups, spb, smem_bytes,
      stream);
}
