// K2, K3 and K5 on a user env: the generic form of the rollout tile kernel
// (rollout_generic.cuh) with a step functor generated from the env's PyTorch
// step.
//
// Replaces, for an env with no hand-written functor in envs.cuh:
// tfmpc_tpu/ops/rollout_pallas.py: linesearch_costs_pallas (K2),
// rollout_alpha_pallas (K3) and linesearch_costs_traj_pallas (K5), which
// the JAX package runs on any Env by tracing its public transition, cost
// and final_cost into the kernel body (Env.generic_lane_functions,
// tfmpc_tpu/models/base.py). Here ops/env_codegen.py traces the port's env
// the same way and emits tfmpc::UserStep, a functor in envs.cuh's contract
// at its traced (n, m) and dtype, into user_step.cuh; ops/_build.py
// user_library compiles this file with it, one library a generated source,
// and ops/rollout.py launches it at the generic form's plans
// (GENERIC_PLANS). The kernel, its bound and what its design does about it
// are rollout_generic.cuh's: the step's prep and rows are inlined into the
// rollout loop, as the JAX kernel inlines the traced step_fn, and its
// stage cost into the chunk's cost phase (one lane a step, off the steps'
// chain), its parameters copied into shared memory once a block.
//
// The C entries mirror rollout_generic.cu's tfmpc_rollout_generic,
// _max_threads and _smem_bytes without the env argument; they refuse a
// call at other dims or another dtype than the functor's, a parameter
// count it does not take, integer parameters, and K8 (a user env has no
// device linearization). A generated functor takes none: the env's float
// tensors are its parameters (tables included), and its integer tensors
// depend on no input, so ops/env_codegen.py writes them as literals of the
// source; the integers it computes from the state are its own values.
#include "rollout_generic.cuh"
#include "user_step.cuh"

namespace tfmpc {
namespace {

using UserS = UserStep::S;
constexpr int kUserDtype = sizeof(UserS) == 8 ? kFloat64 : kFloat32;

int user_entry(const RolloutCall& c) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  const TilePlan& p = c.plan;
  if (c.kind < kCosts || c.kind > kTraj || c.dtype != kUserDtype ||
      c.n != UserStep::kN || c.m != UserStep::kM || c.T < 1 ||
      c.n_params != UserStep::kParams || c.n_int_params != 0 ||
      c.lin != nullptr || p.groups < 1 || p.groups > kGenericMaxGroups ||
      (p.groups & (p.groups - 1)) != 0 || p.spb < 1 ||
      p.spb > kTileMaxSpb || (p.spb & (p.spb - 1)) != 0 || p.depth < 1 ||
      p.depth > kTileMaxDepth || (c.lo == nullptr) != (c.hi == nullptr))
    return invalid;
  if (every_alpha(c.kind) ? c.A < 1 || c.A > kMaxAlphas : c.A != 1)
    return invalid;
  if (c.max_threads == nullptr) {
    if (c.kind != kCosts && (c.X == nullptr || c.U == nullptr))
      return invalid;
    if (!every_alpha(c.kind) && c.alpha == nullptr) return invalid;
    if (c.B <= 0) return 0;
  }
  UserStep step{};
  for (int j = 0; j < c.n_params; ++j)
    step.p[j] = static_cast<const UserS*>(c.params[j]);
  step.dims = Dims<kAnyDim>{c.n, c.m};
  const TileArgs<UserS> a = tile_args<UserS>(c);
  if (c.kind == kCosts)
    return launch_generic<UserS, kCosts>(a, step, c.plan, c.stream,
                                         c.max_threads);
  if (c.kind == kAlpha)
    return launch_generic<UserS, kAlpha>(a, step, c.plan, c.stream,
                                         c.max_threads);
  return launch_generic<UserS, kTraj>(a, step, c.plan, c.stream,
                                      c.max_threads);
}

}  // namespace
}  // namespace tfmpc

using tfmpc::RolloutCall;
using tfmpc::TilePlan;

// K2 (kind 0), K3 (1) or K5 (2) on the generated step, arguments as
// tfmpc_rollout_generic's without env (int_params and lin null and 0).
extern "C" int tfmpc_rollout_user(
    int kind, int dtype, int n, int m, int T, int B, const void* xbar,
    const void* ubar, const void* K, const void* k, const void* lo,
    const void* hi, const double* alphas, int A, const void* alpha,
    const void* const* params, int n_params, const int* int_params,
    int n_int_params, void* J, void* X, void* U, void* const* lin,
    int groups, int spb, int depth, long long smem_bytes, void* stream) {
  return tfmpc::user_entry(RolloutCall{
      kind, dtype, tfmpc::kAnyDim, n, m, T, B, xbar, ubar, K, k, lo, hi,
      alphas, A, alpha, params, n_params, int_params, n_int_params, J, X, U,
      lin, TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}

// The most threads a block of ``kind`` can launch with (its registers bound
// it, at most 1024); a negative value is an error code.
extern "C" int tfmpc_rollout_user_max_threads(int kind, int dtype, int n,
                                              int m,
                                              const void* const* params,
                                              int n_params,
                                              const int* int_params,
                                              int n_int_params) {
  int max_threads = 0;
  const int rc = tfmpc::user_entry(RolloutCall{
      kind, dtype, tfmpc::kAnyDim, n, m, 1, 1, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, 1, nullptr, params, n_params,
      int_params, n_int_params, nullptr, nullptr, nullptr, nullptr,
      TilePlan{1, 1, 1, 0}, nullptr, &max_threads});
  return rc != 0 ? -rc : max_threads;
}

// A block's dynamic shared bytes (rollout_generic.cuh generic_smem_bytes).
extern "C" long long tfmpc_rollout_user_smem_bytes(int dtype, int n, int m,
                                                   int groups, int spb,
                                                   int depth,
                                                   int param_elems,
                                                   int rollouts) {
  return tfmpc::generic_smem_bytes(dtype == tfmpc::kFloat64 ? 8 : 4, n, m,
                                   groups, spb, depth, param_elems,
                                   rollouts);
}

extern "C" const char* tfmpc_rollout_user_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
