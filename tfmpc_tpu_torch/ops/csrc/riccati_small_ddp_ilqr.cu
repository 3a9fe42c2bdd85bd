// K6a at every 1 <= n, m <= 12 outside the lane kernels' dims: the
// full-DDP unconstrained variant of riccati_small.cuh (which says what it
// computes and how) in float32 and float64 at each bucket of lanes, and
// its C entry. A source of its own, so that the parallel build compiles it
// beside riccati_small_ilqr.cu.
#include "riccati_small.cuh"

// As tfmpc_riccati_backward_small, with the dynamics Hessians fxx [B, T, n,
// n, n], fux [B, T, n, m, n] and fuu [B, T, n, m, m] after mu.
extern "C" int tfmpc_riccati_backward_small_ddp(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* fxx, const void* fux,
    const void* fuu, const void* VT, const void* vT, void* K, void* k,
    void* dV1, void* dV2, void* fail, int groups, int spb, int stage_h,
    long long smem_bytes, void* stream) {
  const void* in[] = {fx,      fu,      lx,  lu,  lxx, luu, lux, mu,
                      nullptr, nullptr, nullptr, fxx, fux, fuu, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::SmallPlan p{groups, spb, stage_h, smem_bytes};
  return tfmpc::small_entry<false, true>(dtype, n, m, T, B, 0, in, out, p,
                                         stream);
}

// The blocks of the plan an SM holds at once for this source's kernel
// (riccati_small.cuh small_blocks_per_sm): of the plans with the Hessians
// staged and read in place, the one that takes fewer waves of blocks is
// launched (ops/riccati_small.py small_launch_plan).
extern "C" int tfmpc_riccati_small_ddp_ilqr_blocks_per_sm(
    int dtype, int n, int m, int groups, int spb, int stage_h,
    long long smem_bytes) {
  const tfmpc::SmallPlan p{groups, spb, stage_h, smem_bytes};
  return tfmpc::small_blocks_per_sm<false, true>(dtype, n, m, p);
}

#ifdef TFMPC_SMALL_CLOCKS
// The phase clocks of the last launch of this source's kernels
// (riccati_small.cuh small_clocks) into host[10].
extern "C" int tfmpc_riccati_small_ddp_ilqr_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, tfmpc::small_clocks, sizeof(tfmpc::small_clocks)));
}
#endif
