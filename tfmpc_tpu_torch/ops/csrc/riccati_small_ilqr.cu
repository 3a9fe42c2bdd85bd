// K1 at every 1 <= n, m <= 12 outside the lane kernels' dims: the
// unconstrained variant of riccati_small.cuh (which says what it computes
// and how) in float32 and float64 at each bucket of lanes (2, 4, 8, 16),
// and its C entry. riccati_small_ddp_ilqr.cu holds K6a, so the parallel
// build compiles them side by side with the boxQP variants' sources
// (riccati_small.cu has the shared-bytes entry of all four).
#include "riccati_small.cuh"

// As tfmpc_riccati_backward_mid (the solver's [B, T, ...] layout), with the
// plan's lanes a scenario, scenarios a block, Hessians staged (1; read
// only with ddp) and shared bytes.
extern "C" int tfmpc_riccati_backward_small(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int groups, int spb,
    int stage_h, long long smem_bytes, void* stream) {
  const void* in[] = {fx,      fu,      lx,      lu,      lxx,     luu,
                      lux,     mu,      nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, VT,      vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::SmallPlan p{groups, spb, stage_h, smem_bytes};
  return tfmpc::small_entry<false, false>(dtype, n, m, T, B, 0, in, out, p,
                                          stream);
}

#ifdef TFMPC_SMALL_CLOCKS
// The phase clocks of the last launch of this source's kernels
// (riccati_small.cuh small_clocks) into host[10].
extern "C" int tfmpc_riccati_small_ilqr_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, tfmpc::small_clocks, sizeof(tfmpc::small_clocks)));
}
#endif
