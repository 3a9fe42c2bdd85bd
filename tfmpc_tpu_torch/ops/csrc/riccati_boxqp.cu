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
// ms of HBM time at 3.35 TB/s); the arithmetic is up to ~15k FLOPs per step
// and scenario with all 8 Newton x 8 line-search iterations (~3 GFLOP,
// ~0.05 ms at 67 TFLOP/s). But like K1 the T steps of a scenario form a
// serial chain, and the boxQP loop inside a step is itself serial, so the
// kernel is bound by the latency of one thread's dependent arithmetic.
//
// What the design does about it, simple and right first: one thread per
// scenario, walking T; the [T, entries, B] layout keeps every load and
// store coalesced across a warp. The small-matrix loops unroll through the
// template dims; the Newton and line-search loops stay rolled. At
// n = m = 6 the working set (V, the five Q blocks, the factors, the boxQP
// vectors: ~300 values) exceeds the 255-register limit, so it spills to
// local memory (ptxas -v in chip_smoke.py reports how much). Splitting a
// scenario over several threads is later work.
#include "riccati_kernel.cuh"

extern "C" int tfmpc_riccati_backward_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* ubar,
    const void* lo, const void* hi, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Boxqp>(dtype, n, m, T, B, newton_iters,
                                             in, out, block, stream);
}
