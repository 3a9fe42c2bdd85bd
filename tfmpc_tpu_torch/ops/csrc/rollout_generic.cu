// K2 and K3 in the generic form, at any 1 <= n, m <= 48, and the generic
// form's C entries (rollout_generic.cuh says what it computes and how;
// rollout_generic_traj.cu holds K5, rollout_generic_derivs.cu K8).
#include "rollout_generic.cuh"

namespace tfmpc {

int rollout_generic_entry(const RolloutCall& c) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  const TilePlan& p = c.plan;
  if (c.kind < kCosts || c.kind > kDerivs || c.n < 1 || c.m < 1 ||
      c.n > kGenericMaxDim || c.m > kGenericMaxDim || c.T < 1 ||
      p.groups < 1 || p.groups > kGenericMaxGroups ||
      (p.groups & (p.groups - 1)) != 0 || p.spb < 1 ||
      p.spb > kTileMaxSpb || (p.spb & (p.spb - 1)) != 0 || p.depth < 1 ||
      p.depth > kTileMaxDepth || (c.lo == nullptr) != (c.hi == nullptr))
    return invalid;
  if (every_alpha(c.kind) ? c.A < 1 || c.A > kMaxAlphas : c.A != 1)
    return invalid;
  if (c.max_threads == nullptr) {
    if (c.kind != kCosts && (c.X == nullptr || c.U == nullptr))
      return invalid;
    if (c.kind == kDerivs && c.lin == nullptr) return invalid;
    if (!every_alpha(c.kind) && c.alpha == nullptr) return invalid;
    if (c.B <= 0) return 0;
  }
  if (c.kind == kTraj) return rollout_generic_traj(c);
  if (c.kind == kDerivs) return rollout_generic_derivs(c);
  return rollout_generic_kinds<KindList<kCosts, kAlpha>>(c);
}

}  // namespace tfmpc

using tfmpc::RolloutCall;
using tfmpc::TilePlan;

// K2 (kind 0: J [A, B]), K3 (1: X [T, n, B], U [T, m, B], J [B] at each
// scenario's alpha [B]), K5 (2: J [A, B], X [T, A*n, B], U [T, A*m, B]) or
// K8 (3: K3's outputs and lin, the seven [T, entries, B] blocks fx, fu,
// lx, lu, lxx, luu, lux (host array of device pointers); navigation at
// n = m <= 12) in the generic form, at any 1 <= n, m <= 48, with the
// launch plan (groups, spb, depth, shared bytes). The unused of alphas
// (host f64, K2, K5), alpha (device, K3, K8), X, U and lin are null.
extern "C" int tfmpc_rollout_generic(
    int kind, int dtype, int env, int n, int m, int T, int B,
    const void* xbar, const void* ubar, const void* K, const void* k,
    const void* lo, const void* hi, const double* alphas, int A,
    const void* alpha, const void* const* params, int n_params,
    const int* int_params, int n_int_params, void* J, void* X, void* U,
    void* const* lin, int groups, int spb, int depth, long long smem_bytes,
    void* stream) {
  return tfmpc::rollout_generic_entry(RolloutCall{
      kind, dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi, alphas, A,
      alpha, params, n_params, int_params, n_int_params, J, X, U, lin,
      TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}

// The most threads a generic block of ``kind`` can launch with at the env
// and dtype (its registers bound it, at most 1024); a negative value is an
// error code (an unknown kind or env, or dims it refuses).
extern "C" int tfmpc_rollout_generic_max_threads(
    int kind, int dtype, int env, int n, int m, const void* const* params,
    int n_params, const int* int_params, int n_int_params) {
  int max_threads = 0;
  const int rc = tfmpc::rollout_generic_entry(RolloutCall{
      kind, dtype, env, n, m, 1, 1, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, 1, nullptr, params, n_params, int_params,
      n_int_params, nullptr, nullptr, nullptr, nullptr,
      TilePlan{1, 1, 1, 0}, nullptr, &max_threads});
  return rc != 0 ? -rc : max_threads;
}

// The dynamic shared bytes of a generic block (rollout_generic.cuh
// generic_smem_bytes) of ``rollouts`` rollouts (spb, times A for K2 and
// K5), for an env with ``param_elems`` parameter values.
extern "C" long long tfmpc_rollout_generic_smem_bytes(
    int dtype, int n, int m, int groups, int spb, int depth, int param_elems,
    int rollouts) {
  return tfmpc::generic_smem_bytes(dtype == tfmpc::kFloat64 ? 8 : 4, n, m,
                                   groups, spb, depth, param_elems,
                                   rollouts);
}
