// K8 in the generic form (rollout_generic.cuh): navigation, the only env
// with a closed-form device linearization, at n = m <= kDerivsMaxDim (12,
// the JAX package's fused-iteration ceiling) outside K8's unrolled dims. A
// source of its own, so that nvcc compiles it in parallel with the other
// rollout kernels; rollout_generic.cu's rollout_generic_entry calls
// rollout_generic_derivs.
#include "rollout_generic.cuh"

namespace tfmpc {
namespace {

template <typename S>
int generic_derivs_dtype(const RolloutCall& c) {
  if (c.env != kNavigation || c.n_params != 3 || c.n_int_params != 1 ||
      c.n != c.m || c.n > kDerivsMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  auto P = [&c](int i) { return static_cast<const S*>(c.params[i]); };
  const NavigationStep<S, kAnyDim> step{P(0), P(1), P(2), c.int_params[0],
                                        Dims<kAnyDim>{c.n, c.m}};
  return launch_generic<S, kDerivs>(tile_args<S>(c), step, c.plan, c.stream,
                                    c.max_threads);
}

}  // namespace

int rollout_generic_derivs(const RolloutCall& c) {
  if (c.dtype == kFloat32) return generic_derivs_dtype<float>(c);
  if (c.dtype == kFloat64) return generic_derivs_dtype<double>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfmpc
