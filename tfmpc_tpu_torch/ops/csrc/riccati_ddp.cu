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
// step and scenario and writes 6 (~85 MB in f32, ~0.03 ms at 3.35 TB/s);
// K6b at reservoir-5 (n = m = 5, B = 2048, T = 100) reads 515 and writes 35
// (~450 MB, ~0.13 ms). The n^3 + 2 n^2 m contraction adds ~2 n (n^2 + 2 n m)
// operations per step, small beside K4's boxQP. As in K1 and K4, the serial
// chain of T steps per scenario, one thread each, is what bounds it: the
// kernel is latency-bound.
//
// What the design does about it: the Hessians are streamed, each entry read
// once from global memory straight into its sum and folded into its Q block
// (ddp_terms), so no n^3 array competes for registers with K4's ~300-value
// working set; the reads are coalesced across a warp (scenario fastest) and
// independent of the chain, so they are issued ahead of the arithmetic.
// Launch shapes are K1's and K4's (ops/riccati.py DDP_BLOCK,
// DDP_BOXQP_BLOCK). K6a and K6b are built in sources of their own, so that
// the parallel build compiles them side by side with K1 and K4.
#include "riccati_kernel.cuh"

extern "C" int tfmpc_riccati_backward_ddp(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* fxx, const void* fux,
    const void* fuu, const void* VT, const void* vT, void* K, void* k,
    void* dV1, void* dV2, void* fail, int block, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, fxx, fux, fuu, VT,
                      vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::Ddp>(dtype, n, m, T, B, 0, in, out,
                                           block, stream);
}
