// K6b at every 1 <= n, m <= 12 outside the lane kernels' dims: the full-DDP
// variant of riccati_small.cuh (which says what it computes and how) in
// float32 and float64 at each bucket of lanes, and its C entry. A source
// of its own, so that the parallel build compiles it beside
// riccati_small.cu.
#include "riccati_small.cuh"

// As tfmpc_riccati_backward_small_boxqp, with the dynamics Hessians fxx
// [B, T, n, n, n], fux [B, T, n, m, n] and fuu [B, T, n, m, m] after hi.
extern "C" int tfmpc_riccati_backward_small_ddp_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters,
    const void* fx, const void* fu, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* mu,
    const void* ubar, const void* lo, const void* hi, const void* fxx,
    const void* fux, const void* fuu, const void* VT, const void* vT,
    void* K, void* k, void* dV1, void* dV2, void* fail, int groups, int spb,
    int stage_h, long long smem_bytes, void* stream) {
  const void* in[] = {fx,   fu, lx, lu,  lxx, luu, lux, mu,
                      ubar, lo, hi, fxx, fux, fuu, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::SmallPlan p{groups, spb, stage_h, smem_bytes};
  return tfmpc::small_entry<true, true>(dtype, n, m, T, B, newton_iters, in,
                                        out, p, stream);
}

#ifdef TFMPC_SMALL_CLOCKS
// The phase clocks of the last launch of this source's kernels
// (riccati_small.cuh small_clocks) into host[10].
extern "C" int tfmpc_riccati_small_ddp_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, tfmpc::small_clocks, sizeof(tfmpc::small_clocks)));
}
#endif
