// K7's full-DDP variants, K6a and K6b at any n, m <= 12 outside the lane
// kernels' dims, and their C entries (riccati_mid.cuh says what they
// compute and how). A source of its own, so that the parallel build
// compiles it beside riccati_mid.cu.
#include "riccati_mid.cuh"

// As tfmpc_riccati_backward_mid, with the dynamics Hessians fxx [B, T, n,
// n, n], fux [B, T, n, m, n] and fuu [B, T, n, m, m] after mu.
extern "C" int tfmpc_riccati_backward_mid_ddp(
    int dtype, int n, int m, int T, int B, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* fxx,
    const void* fux, const void* fuu, const void* VT, const void* vT,
    void* K, void* k, void* dV1, void* dV2, void* fail, int warps, int spb,
    int stage_l, long long smem_bytes, void* stream) {
  const void* in[] = {fx,      fu,      lx,  lu,  lxx, luu, lux, mu,
                      nullptr, nullptr, nullptr, fxx, fux, fuu, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::MidPlan p{warps, spb, stage_l, smem_bytes};
  return tfmpc::entry<false, true>(dtype, n, m, T, B, 0, in, out, p, stream);
}

// As tfmpc_riccati_backward_mid_boxqp, with fxx, fux, fuu after hi.
extern "C" int tfmpc_riccati_backward_mid_ddp_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters,
    const void* fx, const void* fu, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* mu,
    const void* ubar, const void* lo, const void* hi, const void* fxx,
    const void* fux, const void* fuu, const void* VT, const void* vT,
    void* K, void* k, void* dV1, void* dV2, void* fail, int warps, int spb,
    int stage_l, long long smem_bytes, void* stream) {
  const void* in[] = {fx,   fu, lx, lu,  lxx, luu, lux, mu,
                      ubar, lo, hi, fxx, fux, fuu, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::MidPlan p{warps, spb, stage_l, smem_bytes};
  return tfmpc::entry<true, true>(dtype, n, m, T, B, newton_iters, in, out,
                                  p, stream);
}
