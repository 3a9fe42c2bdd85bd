// K7's iLQR and boxQP variants and their C entries (riccati_mid.cuh says
// what K7 computes and how; riccati_mid_ddp.cu holds the full-DDP ones).
#include "riccati_mid.cuh"

// The dynamic shared bytes of a block of ``spb`` scenarios at (n, m), for
// the input dtype and whether the l blocks are staged: what the launch
// requires of the plan, so the wrapper can check its own sum and refuse a
// launch that would not fit. The DDP variants take the same bytes.
extern "C" long long tfmpc_riccati_mid_smem_bytes(int dtype, int n, int m,
                                                  int spb, int stage_l) {
  const size_t s_bytes = dtype == tfmpc::kFloat64 ? 8 : 4;
  return static_cast<long long>(tfmpc::mid_scenario_bytes(
             n, m, s_bytes, stage_l != 0)) *
         spb;
}

extern "C" int tfmpc_riccati_backward_mid(
    int dtype, int n, int m, int T, int B, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* VT,
    const void* vT, void* K, void* k, void* dV1, void* dV2, void* fail,
    int warps, int spb, int stage_l, long long smem_bytes, void* stream) {
  const void* in[] = {fx,      fu,      lx,      lu,      lxx, luu,
                      lux,     mu,      nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, VT,      vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::MidPlan p{warps, spb, stage_l, smem_bytes};
  return tfmpc::entry<false, false>(dtype, n, m, T, B, 0, in, out, p, stream);
}

extern "C" int tfmpc_riccati_backward_mid_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters,
    const void* fx, const void* fu, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* mu,
    const void* ubar, const void* lo, const void* hi, const void* VT,
    const void* vT, void* K, void* k, void* dV1, void* dV2, void* fail,
    int warps, int spb, int stage_l, long long smem_bytes, void* stream) {
  const void* in[] = {fx,  fu, lx, lu,      lxx,     luu,     lux, mu,
                      ubar, lo, hi, nullptr, nullptr, nullptr, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::MidPlan p{warps, spb, stage_l, smem_bytes};
  return tfmpc::entry<true, false>(dtype, n, m, T, B, newton_iters, in, out,
                                   p, stream);
}
