// K2 and K3 at n = m in {2, 3, 5, 6}, and the C entries of the rollout
// kernels (rollout.cuh says what they compute and how; rollout_traj.cu
// holds K5 at those dims, rollout_n12.cu and rollout_n16.cu the HVAC
// instantiations at n = m = 12 and 16, rollout_derivs.cu K8's).
#include "rollout.cuh"

namespace tfmpc {
namespace {

bool valid_plan(const TilePlan& p) {
  return p.spb >= 1 && p.spb <= kTileMaxSpb && (p.spb & (p.spb - 1)) == 0 &&
         p.depth >= 1 && p.depth <= kTileMaxDepth;
}

}  // namespace

int rollout_entry(const RolloutCall& c) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (c.kind < kCosts || c.kind > kDerivs || !valid_plan(c.plan) ||
      c.T < 1 || (c.lo == nullptr) != (c.hi == nullptr))
    return invalid;
  if (every_alpha(c.kind) ? c.A < 1 || c.A > kMaxAlphas : c.A != 1)
    return invalid;
  if (c.max_threads == nullptr) {
    if (c.kind != kCosts && (c.X == nullptr || c.U == nullptr))
      return invalid;
    if (!every_alpha(c.kind) && c.alpha == nullptr) return invalid;
    if (c.kind == kDerivs) {
      if (c.lin == nullptr) return invalid;
      for (int i = 0; i < 7; ++i)
        if (c.lin[i] == nullptr) return invalid;
    }
    if (c.B <= 0) return 0;
  }
  if (c.kind == kDerivs) return rollout_derivs(c);
  if (c.n == c.m && c.n == 12) return rollout_n12(c);
  if (c.n == c.m && c.n == 16) return rollout_n16(c);
  if (c.kind == kTraj) return rollout_traj(c);
  return rollout_dims<SmallDims, KindList<kCosts, kAlpha>>(c);
}

}  // namespace tfmpc

using tfmpc::RolloutCall;
using tfmpc::TilePlan;

// K2: J [A, B] with the launch plan (groups, spb, depth, shared bytes).
extern "C" int tfmpc_linesearch_costs(
    int dtype, int env, int n, int m, int T, int B, const void* xbar,
    const void* ubar, const void* K, const void* k, const void* lo,
    const void* hi, const double* alphas, int A, const void* const* params,
    int n_params, const int* int_params, int n_int_params, void* J,
    int groups, int spb, int depth, long long smem_bytes, void* stream) {
  return tfmpc::rollout_entry(RolloutCall{
      tfmpc::kCosts, dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
      alphas, A, nullptr, params, n_params, int_params, n_int_params, J,
      nullptr, nullptr, nullptr, TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}

// K5: J [A, B], X [T, A*n, B], U [T, A*m, B], with the launch plan.
extern "C" int tfmpc_linesearch_costs_traj(
    int dtype, int env, int n, int m, int T, int B, const void* xbar,
    const void* ubar, const void* K, const void* k, const void* lo,
    const void* hi, const double* alphas, int A, const void* const* params,
    int n_params, const int* int_params, int n_int_params, void* J, void* X,
    void* U, int groups, int spb, int depth, long long smem_bytes,
    void* stream) {
  return tfmpc::rollout_entry(RolloutCall{
      tfmpc::kTraj, dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
      alphas, A, nullptr, params, n_params, int_params, n_int_params, J, X,
      U, nullptr, TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}

// K3: X [T, n, B], U [T, m, B], J [B] at each scenario's alpha [B], with
// the launch plan.
extern "C" int tfmpc_rollout_alpha(
    int dtype, int env, int n, int m, int T, int B, const void* alpha,
    const void* xbar, const void* ubar, const void* K, const void* k,
    const void* lo, const void* hi, const void* const* params, int n_params,
    const int* int_params, int n_int_params, void* X, void* U, void* J,
    int groups, int spb, int depth, long long smem_bytes, void* stream) {
  return tfmpc::rollout_entry(RolloutCall{
      tfmpc::kAlpha, dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
      nullptr, 1, alpha, params, n_params, int_params, n_int_params, J, X, U,
      nullptr, TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}

// The most threads a block of ``kind`` (RolloutKind: 0 K2, 1 K3, 2 K5,
// 3 K8) can launch with at the env's step, dims, dtype and G: the
// kernel's registers bound it (at most 1024), so the plan keeps its blocks
// within it. A negative value is an error code (an unknown kind, env or
// dims, or a G not instantiated).
extern "C" int tfmpc_rollout_max_threads(int kind, int dtype, int env,
                                         int n, int m, int groups,
                                         const void* const* params,
                                         int n_params, const int* int_params,
                                         int n_int_params) {
  int max_threads = 0;
  const int rc = tfmpc::rollout_entry(RolloutCall{
      kind, dtype, env, n, m, 1, 1, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, 1, nullptr, params, n_params, int_params,
      n_int_params, nullptr, nullptr, nullptr, nullptr,
      TilePlan{groups, 1, 1, 0}, nullptr, &max_threads});
  return rc != 0 ? -rc : max_threads;
}

#ifdef TFMPC_ROLLOUT_CLOCKS
unsigned long long* tfmpc::tile_clocks = nullptr;

// Where the tile kernels add their phase clocks (device, 16 counters: the
// unrolled kernel's 0-7, the generic form's 8-13; null: nowhere). Only in
// the TFMPC_ROLLOUT_CLOCKS build.
extern "C" void tfmpc_rollout_clocks_buffer(void* clocks) {
  tfmpc::tile_clocks = static_cast<unsigned long long*>(clocks);
}
#endif

// The dynamic shared bytes of a tile block of any kind (rollout.cuh
// tile_smem_bytes) for an env with ``param_elems`` parameter values: what
// a launch requires of its plan, so the wrapper can check its own sum.
extern "C" long long tfmpc_rollout_smem_bytes(int dtype, int n, int m,
                                              int groups, int spb, int depth,
                                              int param_elems) {
  return tfmpc::tile_smem_bytes(dtype == tfmpc::kFloat64 ? 8 : 4, n, m,
                                groups, spb, depth, param_elems);
}
