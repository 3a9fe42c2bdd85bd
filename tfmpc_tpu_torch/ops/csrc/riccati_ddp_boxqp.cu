// K6b: the full second-order DDP Riccati backward pass with the
// control-limited (boxQP) gains, in one kernel (riccati_kernel.cuh, variant
// DdpBoxqp): K4's kernel (riccati_boxqp.cu) with the DDP terms of K6a. What
// it replaces, what bounds it and its design: riccati_ddp.cu.
#include "riccati_kernel.cuh"

namespace {
using tfmpc::Insts;
using tfmpc::NG;
// (n, G) instantiated, as ops/riccati.py LANE_PLANS' K6b row
#ifdef TFMPC_LANE_ALL_G
using F32 = tfmpc::AllLaneG;
#else
using F32 = Insts<NG<2, 8>, NG<3, 8>, NG<5, 8>, NG<6, 8>>;
#endif
using F64 = Insts<NG<2, 8>, NG<3, 8>, NG<5, 8>, NG<6, 8>>;
}  // namespace

extern "C" int tfmpc_riccati_backward_ddp_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* ubar,
    const void* lo, const void* hi, const void* fxx, const void* fux,
    const void* fuu, const void* VT, const void* vT, void* K, void* k,
    void* dV1, void* dV2, void* fail, int groups, int spb,
    long long smem_bytes, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi,
                      fxx, fux, fuu, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::launch_riccati<tfmpc::DdpBoxqp, F32, F64>(
      dtype, n, m, T, B, newton_iters, in, out, groups, spb, smem_bytes,
      stream);
}
