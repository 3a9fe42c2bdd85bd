// Env step functors compiled into the rollout kernels (rollout.cu).
//
// Each functor mirrors its env's public transition/cost/final_cost exactly
// (and the JAX package's lane_functions, e.g. navigation.py:182-214), and is
// selected by the env_id that the env's device_step() returns.
#pragma once

#include "common.cuh"

namespace tfmpc {

// env_id values (tfmpc_tpu_torch/models/*.py device_step)
constexpr int kNavigation = 0;

// Navigation: x' = x + lambda(x) u,
// lambda(x) = prod_z [2 / (1 + exp(-decay_z sqrt(|x - c_z|^2 + 1e-12))) - 1],
// stage cost |x - goal|^2 on the PRE-step state, final cost the same.
// Parameters (device pointers): goal [N], centers [Z, N], decays [Z].
template <typename S, int N>
struct NavigationStep {
  const S* __restrict__ goal;
  const S* __restrict__ centers;
  const S* __restrict__ decays;
  int zones;

  __device__ __forceinline__ S final_cost(const S (&x)[N]) const {
    S c = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const S d = x[i] - goal[i];
      c += d * d;
    }
    return c;
  }

  // Returns the stage cost at x and writes the next state.
  template <int M>
  __device__ __forceinline__ S step(const S (&x)[N], const S (&u)[M],
                                    S (&x_next)[N]) const {
    static_assert(M == N, "navigation actions have the state's size");
    const S cost = final_cost(x);
    S lam = 1;
    for (int z = 0; z < zones; ++z) {
      S d2 = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const S d = x[i] - centers[z * N + i];
        d2 += d * d;
      }
      const S dist = dsqrt(d2 + S(1e-12));
      lam = lam * (S(2) / (S(1) + dexp(-decays[z] * dist)) - S(1));
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x_next[i] = x[i] + lam * u[i];
    return cost;
  }
};

}  // namespace tfmpc
