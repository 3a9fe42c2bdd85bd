// K4 at every 1 <= n, m <= 12 outside the lane kernels' dims: the boxQP
// variant of riccati_small.cuh (which says what it computes and how) in
// float32 and float64 at each bucket of lanes (2, 4, 8, 16), and its C
// entries. riccati_small_ddp.cu holds K6b, riccati_small_ilqr.cu K1 and
// riccati_small_ddp_ilqr.cu K6a, so the parallel build compiles them side
// by side.
#include "riccati_small.cuh"

// The dynamic shared bytes of a block of ``spb`` scenarios at (n, m), for
// the input dtype and the variant (``box``: K4/K6b, else K1/K6a; ``ddp``:
// K6b/K6a; with ddp, ``stage_h``: the Hessians staged): what the launch
// requires of the plan, so the wrapper can check its own sum; -1 outside
// the kernel's dims.
extern "C" long long tfmpc_riccati_small_smem_bytes(int dtype, int box,
                                                    int ddp, int n, int m,
                                                    int spb, int stage_h) {
  return tfmpc::small_smem_bytes(n, m, dtype == tfmpc::kFloat64 ? 8 : 4,
                                 ddp != 0, spb, box != 0, stage_h != 0);
}

// The lanes a scenario the kernel takes at (n, m); 0 outside its dims.
extern "C" int tfmpc_riccati_small_groups(int n, int m) {
  return tfmpc::small_groups(n, m);
}

// As tfmpc_riccati_backward_mid_boxqp (the solver's [B, T, ...] layout),
// with the plan's lanes a scenario, scenarios a block, Hessians staged (1;
// read only with ddp) and shared bytes.
extern "C" int tfmpc_riccati_backward_small_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters,
    const void* fx, const void* fu, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* mu,
    const void* ubar, const void* lo, const void* hi, const void* VT,
    const void* vT, void* K, void* k, void* dV1, void* dV2, void* fail,
    int groups, int spb, int stage_h, long long smem_bytes, void* stream) {
  const void* in[] = {fx,  fu, lx, lu,      lxx,     luu,     lux, mu,
                      ubar, lo, hi, nullptr, nullptr, nullptr, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  const tfmpc::SmallPlan p{groups, spb, stage_h, smem_bytes};
  return tfmpc::small_entry<true, false>(dtype, n, m, T, B, newton_iters,
                                         in, out, p, stream);
}

#ifdef TFMPC_SMALL_CLOCKS
// The phase clocks of the last launch of this source's kernels
// (riccati_small.cuh small_clocks) into host[10].
extern "C" int tfmpc_riccati_small_clocks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, tfmpc::small_clocks, sizeof(tfmpc::small_clocks)));
}
#endif
