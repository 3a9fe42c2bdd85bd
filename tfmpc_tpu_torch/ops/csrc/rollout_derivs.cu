// K8 at n = m in {2, 3, 5, 6} with the navigation step, the only env with a
// closed-form device linearization (rollout.cuh says what K8 computes and
// how), and its C entry. A source of its own, so that the parallel build
// compiles it beside the other rollout kernels.
#include "rollout.cuh"

namespace tfmpc {
namespace {

template <typename S>
int derivs_dtype(int env, int n, int m, int T, int B, const void* alpha,
                 const void* xbar, const void* ubar, const void* K,
                 const void* k, const void* lo, const void* hi,
                 const void* const* params, int n_params,
                 const int* int_params, int n_int_params, void* X, void* U,
                 void* J, void* const* lin, int block, cudaStream_t stream) {
  if (env != kNavigation || n_params != 3 || n_int_params != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto P = [params](int i) { return static_cast<const S*>(params[i]); };
  auto L = [lin](int i) { return static_cast<S*>(lin[i]); };
  const LinOut<S> out{L(0), L(1), L(2), L(3), L(4), L(5), L(6)};
  return with_dims(SmallDims{}, n, m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    const NavigationStep<S, N> step{P(0), P(1), P(2), int_params[0]};
    rollout_alpha_derivs_kernel<S, N, N, NavigationStep<S, N>>
        <<<blocks_for(B, block), block, 0, stream>>>(
            (const S*)alpha, (const S*)xbar, (const S*)ubar, (const S*)K,
            (const S*)k, (const S*)lo, (const S*)hi, step, (S*)X, (S*)U,
            (S*)J, out, T, B);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace
}  // namespace tfmpc

// lin: the seven output blocks fx, fu, lx, lu, lxx, luu, lux (host array
// of device pointers), each [T, entries, B].
extern "C" int tfmpc_rollout_alpha_derivs(
    int dtype, int env, int n, int m, int T, int B, const void* alpha,
    const void* xbar, const void* ubar, const void* K, const void* k,
    const void* lo, const void* hi, const void* const* params, int n_params,
    const int* int_params, int n_int_params, void* X, void* U, void* J,
    void* const* lin, int block, void* stream) {
  using namespace tfmpc;
  if (T < 1 || (lo == nullptr) != (hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 7; ++i)
    if (lin[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return derivs_dtype<float>(env, n, m, T, B, alpha, xbar, ubar, K, k, lo,
                               hi, params, n_params, int_params, n_int_params,
                               X, U, J, lin, block, s);
  if (dtype == kFloat64)
    return derivs_dtype<double>(env, n, m, T, B, alpha, xbar, ubar, K, k, lo,
                                hi, params, n_params, int_params,
                                n_int_params, X, U, J, lin, block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
