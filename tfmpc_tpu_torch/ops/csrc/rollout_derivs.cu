// K8 at n = m in {2, 3, 5, 6} with the navigation step, the only env with a
// closed-form device linearization (rollout.cuh says what K8 computes and
// how), and its C entry. A source of its own, so that the parallel build
// compiles it beside the other rollout kernels.
#include "rollout.cuh"

namespace tfmpc {
namespace {

template <typename S>
int derivs_dtype(const RolloutCall& c) {
  if (c.env != kNavigation || c.n_params != 3 || c.n_int_params != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const TileArgs<S> a = tile_args<S>(c);
  auto P = [&c](int i) { return static_cast<const S*>(c.params[i]); };
  return with_dims(SmallDims{}, c.n, c.m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    const NavigationStep<S, N> step{P(0), P(1), P(2), c.int_params[0]};
    return launch_kind<S, N>(KindList<kDerivs>{}, c, a, step);
  });
}

}  // namespace

int rollout_derivs(const RolloutCall& c) {
  if (c.dtype == kFloat32) return derivs_dtype<float>(c);
  if (c.dtype == kFloat64) return derivs_dtype<double>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfmpc

// K8: X [T, n, B], U [T, m, B], J [B] at each scenario's alpha [B] and
// lin, the seven output blocks fx, fu, lx, lu, lxx, luu, lux (host array
// of device pointers), each [T, entries, B]; with the launch plan.
extern "C" int tfmpc_rollout_alpha_derivs(
    int dtype, int env, int n, int m, int T, int B, const void* alpha,
    const void* xbar, const void* ubar, const void* K, const void* k,
    const void* lo, const void* hi, const void* const* params, int n_params,
    const int* int_params, int n_int_params, void* X, void* U, void* J,
    void* const* lin, int groups, int spb, int depth, long long smem_bytes,
    void* stream) {
  return tfmpc::rollout_entry(tfmpc::RolloutCall{
      tfmpc::kDerivs, dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
      nullptr, 1, alpha, params, n_params, int_params, n_int_params, J, X, U,
      lin, tfmpc::TilePlan{groups, spb, depth, smem_bytes},
      static_cast<cudaStream_t>(stream), nullptr});
}
