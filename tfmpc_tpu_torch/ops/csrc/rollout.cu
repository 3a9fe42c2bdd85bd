// K2, K3 and K5 at n = m in {2, 3, 5, 6}, and the C entries of all three
// (rollout.cuh says what they compute and how; rollout_n12.cu and
// rollout_n16.cu hold the HVAC instantiations at n = m = 12 and 16).
#include "rollout.cuh"

namespace tfmpc {
namespace {

int costs_entry(int dtype, int env, int n, int m, int T, int B,
                const void* xbar, const void* ubar, const void* K,
                const void* k, const void* lo, const void* hi,
                const double* alphas, int A, const void* const* params,
                int n_params, const int* int_params, int n_int_params,
                void* J, void* X, void* U, int block, void* stream) {
  if (A < 1 || A > kMaxAlphas || T < 1 || (lo == nullptr) != (hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = n != m     ? &costs_dims<SmallDims>
             : n == 12  ? &costs_n12
             : n == 16  ? &costs_n16
                        : &costs_dims<SmallDims>;
  return run(dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi, alphas, A,
             params, n_params, int_params, n_int_params, J, X, U, block, s);
}

}  // namespace
}  // namespace tfmpc

extern "C" int tfmpc_linesearch_costs(
    int dtype, int env, int n, int m, int T, int B, const void* xbar,
    const void* ubar, const void* K, const void* k, const void* lo,
    const void* hi, const double* alphas, int A, const void* const* params,
    int n_params, const int* int_params, int n_int_params, void* J,
    int block, void* stream) {
  return tfmpc::costs_entry(dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
                            alphas, A, params, n_params, int_params,
                            n_int_params, J, nullptr, nullptr, block, stream);
}

extern "C" int tfmpc_linesearch_costs_traj(
    int dtype, int env, int n, int m, int T, int B, const void* xbar,
    const void* ubar, const void* K, const void* k, const void* lo,
    const void* hi, const double* alphas, int A, const void* const* params,
    int n_params, const int* int_params, int n_int_params, void* J, void* X,
    void* U, int block, void* stream) {
  if (X == nullptr || U == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return tfmpc::costs_entry(dtype, env, n, m, T, B, xbar, ubar, K, k, lo, hi,
                            alphas, A, params, n_params, int_params,
                            n_int_params, J, X, U, block, stream);
}

extern "C" int tfmpc_rollout_alpha(
    int dtype, int env, int n, int m, int T, int B, const void* alpha,
    const void* xbar, const void* ubar, const void* K, const void* k,
    const void* lo, const void* hi, const void* const* params, int n_params,
    const int* int_params, int n_int_params, void* X, void* U, void* J,
    int block, void* stream) {
  using namespace tfmpc;
  if (T < 1 || (lo == nullptr) != (hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = n != m     ? &alpha_dims<SmallDims>
             : n == 12  ? &alpha_n12
             : n == 16  ? &alpha_n16
                        : &alpha_dims<SmallDims>;
  return run(dtype, env, n, m, T, B, alpha, xbar, ubar, K, k, lo, hi, params,
             n_params, int_params, n_int_params, X, U, J, block, s);
}
