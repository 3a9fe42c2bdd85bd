// K2, K3 and K5 with the HVAC step at n = m = 16 (rollout.cuh), a source
// of its own so that nvcc compiles it in parallel with the other dims;
// rollout.cu's C entries call these two.
#include "rollout.cuh"

namespace tfmpc {

TFMPC_ROLLOUT_ENTRIES(16) {
  return costs_dims<DimList<16>>(dtype, env, n, m, T, B, xbar, ubar, K, k,
                                  lo, hi, alphas, A, params, n_params,
                                  int_params, n_int_params, J, X, U, block,
                                  stream);
}

TFMPC_ALPHA_ENTRIES(16) {
  return alpha_dims<DimList<16>>(dtype, env, n, m, T, B, alpha, xbar, ubar,
                                  K, k, lo, hi, params, n_params, int_params,
                                  n_int_params, X, U, J, block, stream);
}

}  // namespace tfmpc
