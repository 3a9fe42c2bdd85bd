// K2, K3 and K5: the closed-loop rollouts of the iLQR line search.
//
// Replaces: tfmpc_tpu/ops/rollout_pallas.py:linesearch_costs_pallas (body
// _costs_kernel) as K2, rollout_pallas.py:rollout_alpha_pallas (body
// _materialize_kernel) as K3, and rollout_pallas.py:
// linesearch_costs_traj_pallas (body _costs_traj_kernel) as K5, and
// rollout_pallas.py:rollout_alpha_derivs_pallas (body
// _materialize_derivs_kernel) as K8.
//
// All roll u_t = clip(ubar_t + alpha k_t + K_t (x_t - xbar_t)), x_{t+1} =
// step(x_t, u_t), J += cost(x_t) from x_0 = xbar_0, and add the final cost
// once at T. The clip to [lo, hi] applies when the env has bounds (lo/hi
// are null otherwise), after the affine law, as rollout_pallas.py's
// has_bounds clip does; it keeps NaN. The env step is a functor from
// envs.cuh, dispatched on env_id; n = m in {2, 3, 5, 6}, and 12 and 16
// for HVAC.
// K5 is K2 that also stores x_{t+1} and u_t of every alpha at rows a*n + i
// and a*m + c of step t ([T, A*n, B], [T, A*m, B]); it shares K2's code
// path (policy_control, the functor, the running sum), so its J is K2's and
// its trajectory of any alpha is K3's at that alpha.
//
// The running cost J is summed in double for both dtypes and rounded once
// to the output's: in float32 a sequential sum over T=500 steps drifts by
// several ulps of J (one ulp is 0.0078 at reservoir-5's J of ~8.4e4), more
// than the late iterations' cost decreases, and the line search then
// rejects steps that a correctly rounded total accepts. (The plain versions
// take torch's pairwise sum, whose error stays near one ulp.) In float64
// the sum is the plain sequential one.
//
// What bounds them on this card: like K1, each rollout is a serial chain of
// T dependent steps, so the kernels are latency-bound. Per step a thread
// reads n + m + m*n + m inputs (10 scalars at n = m = 2, 54 at n = m = 6);
// K2 writes only J [A, B] (45,056 values at B=4096, A=11), K3 writes X, U
// and J. Total traffic is tens of MB, below what HBM moves in the time of
// the chain.
//
// What the design does about it: one thread per (scenario, alpha) pair in
// K2 (45,056 threads at B=4096, A=11: enough to fill the 132 SMs, which
// hides part of the chain's latency behind other warps) and one thread per
// scenario in K3, each holding its state in registers for the whole
// horizon. The thread index runs over scenarios fastest, so a warp reads 32
// consecutive addresses of the [T, entries, B] inputs (coalesced); the 11
// alphas of a scenario read the same inputs and meet in L1/L2. The alphas
// travel in the kernel's arguments. The policy arithmetic follows
// _costs_kernel's order: (ubar + alpha k) + sum_i K_i dx_i.
//
// K5 at reservoir-5, T=500, B=1024, A=11 reads ~82 MB and writes ~225 MB of
// trajectories, so its bound is bytes (~0.09 ms), but like K2 it is a chain
// of T dependent steps per thread and latency-bound far above that. The
// design keeps K2's: one thread per (scenario, alpha), scenario index
// fastest, so each warp's stores to the [T, A*n, B] outputs are 32
// consecutive addresses; state in registers for the whole chain, no time
// blocking (the TPU kernel's time blocks buffer stores in VMEM; here a
// store is issued and the chain goes on).
//
// K8 (the fused iteration's materialize) is K3 that also writes the env's
// closed-form linearization at each step's (x_t, clipped u_t): 7 blocks of
// n^2 + n m + n + m + n^2 + m^2 + m n entries, 26 values a step at n = m =
// 2 besides K3's 4 outputs and 10 inputs, ~62 MB at the navigation
// headline (B=4096, T=100, f32), so its bound is bytes (~0.019 ms). Like
// K3 it is a chain of T dependent steps per thread and latency-bound above
// that. The design keeps K3's (one thread per scenario, state in
// registers) and writes each entry as soon as it is computed, scenario
// index fastest, so every store of a warp is 32 consecutive addresses; the
// constant entries (l_xx = 2I, the zero blocks) are stores with no loads.
// Blocks of 32 threads spread B=4096 scenarios over 128 SMs, as K1.
//
// This header holds the kernels and their dispatch; each .cu instantiates
// its own dims so the parallel build compiles them side by side:
// rollout.cu n = m in {2, 3, 5, 6} for every env (and the C entries),
// rollout_n12.cu and rollout_n16.cu the HVAC step at n = m = 12 and 16
// (HVAC-12, HVAC-16), rollout_derivs.cu K8 with the navigation step at
// n = m in {2, 3, 5, 6} (and its C entry).
#pragma once

#include <utility>

#include "envs.cuh"

namespace tfmpc {
namespace {

constexpr int kMaxAlphas = 32;

template <typename S>
struct Alphas {
  S v[kMaxAlphas];
};

template <typename S, int N, int M>
__device__ __forceinline__ void policy_control(
    const S* __restrict__ xbar, const S* __restrict__ ubar,
    const S* __restrict__ K, const S* __restrict__ k,
    const S* __restrict__ lo, const S* __restrict__ hi, int t, int b, int B,
    S alpha, const S (&x)[N], S (&u)[M]) {
  S dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - xbar[at(t, i, N, b, B)];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const S base = ubar[at(t, c, M, b, B)] + alpha * k[at(t, c, M, b, B)];
    S acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) acc += K[at(t, c * N + i, M * N, b, B)] * dx[i];
    u[c] = base + acc;
    if (lo != nullptr) u[c] = clip(u[c], lo[c], hi[c]);
  }
}

template <typename S, int N, int M, class Env>
__global__ void linesearch_costs_kernel(
    const S* __restrict__ xbar, const S* __restrict__ ubar,
    const S* __restrict__ K, const S* __restrict__ k,
    const S* __restrict__ lo, const S* __restrict__ hi, Alphas<S> alphas,
    int A, Env env, S* __restrict__ J, int T, int B) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(A) * B) return;
  const int b = static_cast<int>(idx % B);
  const int a = static_cast<int>(idx / B);
  const S alpha = alphas.v[a];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
  }
  J[idx] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

template <typename S, int N, int M, class Env>
__global__ void linesearch_costs_traj_kernel(
    const S* __restrict__ xbar, const S* __restrict__ ubar,
    const S* __restrict__ K, const S* __restrict__ k,
    const S* __restrict__ lo, const S* __restrict__ hi, Alphas<S> alphas,
    int A, Env env, S* __restrict__ J, S* __restrict__ X,
    S* __restrict__ U, int T, int B) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(A) * B) return;
  const int b = static_cast<int>(idx % B);
  const int a = static_cast<int>(idx / B);
  const S alpha = alphas.v[a];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      X[at(t, a * N + i, A * N, b, B)] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int c = 0; c < M; ++c) U[at(t, a * M + c, A * M, b, B)] = u[c];
  }
  J[idx] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

template <typename S, int N, int M, class Env>
__global__ void rollout_alpha_kernel(
    const S* __restrict__ alpha_in, const S* __restrict__ xbar,
    const S* __restrict__ ubar, const S* __restrict__ K,
    const S* __restrict__ k, const S* __restrict__ lo,
    const S* __restrict__ hi, Env env, S* __restrict__ X, S* __restrict__ U,
    S* __restrict__ J, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const S alpha = alpha_in[b];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      X[at(t, i, N, b, B)] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int c = 0; c < M; ++c) U[at(t, c, M, b, B)] = u[c];
  }
  J[b] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

// K8: K3 that also writes, at every step, the env's closed-form
// linearization at the pre-step state and the clipped control
// (Env::derivatives, envs.cuh) into the seven [T, entries, B] blocks of
// `lin`, the Riccati kernels' input layout. X, U and J are K3's arithmetic
// (the same policy_control and step).
template <typename S, int N, int M, class Env>
__global__ void rollout_alpha_derivs_kernel(
    const S* __restrict__ alpha_in, const S* __restrict__ xbar,
    const S* __restrict__ ubar, const S* __restrict__ K,
    const S* __restrict__ k, const S* __restrict__ lo,
    const S* __restrict__ hi, Env env, S* __restrict__ X, S* __restrict__ U,
    S* __restrict__ J, LinOut<S> lin, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const S alpha = alpha_in[b];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    env.template derivatives<M>(x, u, lin, t, b, B);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      X[at(t, i, N, b, B)] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int c = 0; c < M; ++c) U[at(t, c, M, b, B)] = u[c];
  }
  J[b] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

// The env's step functor from its parameter pointers (the order of the
// env's device_step params), passed to f; an unknown env or a parameter
// count that does not match is refused.
template <typename S, int N, class F>
int with_env(int env, const void* const* p, int n_params, const int* ints,
             int n_ints, F&& f) {
  auto P = [p](int i) { return static_cast<const S*>(p[i]); };
  if (env == kNavigation && n_params == 3 && n_ints == 1)
    return f(NavigationStep<S, N>{P(0), P(1), P(2), ints[0]});
  if (env == kHVAC && n_params == 16 && n_ints == 0)
    return f(HVACStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                            P(8), P(9), P(10), P(11), P(12), P(13), P(14),
                            P(15)});
  if (env == kReservoir && n_params == 10 && n_ints == 0)
    return f(ReservoirStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6),
                                 P(7), P(8), P(9)});
  if (env == kLinear && n_params == 10 && n_ints == 0)
    return f(LinearStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6),
                              P(7), P(8), P(9)});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mid dims (n = m >= 12) compile the HVAC step only: an instantiation
// there costs ~15x one at n <= 6 (nvcc took 263 s for all four envs at 12
// and 16 on one H100 host), and HVAC-12 and HVAC-16 are the paths that
// run there.
constexpr int kMidRolloutDim = 12;

template <typename S, int N, class F>
int with_env_at(int env, const void* const* p, int n_params, const int* ints,
                int n_ints, F&& f) {
  if constexpr (N >= kMidRolloutDim) {
    if (env != kHVAC || n_params != 16 || n_ints != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    auto P = [p](int i) { return static_cast<const S*>(p[i]); };
    return f(HVACStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                            P(8), P(9), P(10), P(11), P(12), P(13), P(14),
                            P(15)});
  } else {
    return with_env<S, N>(env, p, n_params, ints, n_ints,
                          static_cast<F&&>(f));
  }
}

template <int... Ns>
struct DimList {};

// Calls f(std::integral_constant<int, N>) for n == m == N in the list.
template <class F>
int with_dims(DimList<>, int, int, F&&) {
  return static_cast<int>(cudaErrorInvalidValue);
}
template <int N0, int... Ns, class F>
int with_dims(DimList<N0, Ns...>, int n, int m, F&& f) {
  if (n == N0 && m == N0) return f(std::integral_constant<int, N0>{});
  return with_dims(DimList<Ns...>{}, n, m, static_cast<F&&>(f));
}

// K2 when X is null, else K5 (writing X and U too).
template <typename S, class Dims>
int costs_dtype(int env, int n, int m, int T, int B, const void* xbar,
                const void* ubar, const void* K, const void* k,
                const void* lo, const void* hi, const double* alphas, int A,
                const void* const* params, int n_params,
                const int* int_params, int n_int_params, void* J, void* X,
                void* U, int block, cudaStream_t stream) {
  Alphas<S> al{};
  for (int a = 0; a < A; ++a) al.v[a] = static_cast<S>(alphas[a]);
  const int grid = blocks_for(static_cast<int64_t>(A) * B, block);
  return with_dims(Dims{}, n, m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    return with_env_at<S, N>(env, params, n_params, int_params,
                             n_int_params,
                          [&](auto step) {
      if (X == nullptr)
        linesearch_costs_kernel<S, N, N, decltype(step)>
            <<<grid, block, 0, stream>>>(
                (const S*)xbar, (const S*)ubar, (const S*)K, (const S*)k,
                (const S*)lo, (const S*)hi, al, A, step, (S*)J, T, B);
      else
        linesearch_costs_traj_kernel<S, N, N, decltype(step)>
            <<<grid, block, 0, stream>>>(
                (const S*)xbar, (const S*)ubar, (const S*)K, (const S*)k,
                (const S*)lo, (const S*)hi, al, A, step, (S*)J, (S*)X,
                (S*)U, T, B);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

template <typename S, class Dims>
int alpha_dtype(int env, int n, int m, int T, int B, const void* alpha,
                const void* xbar, const void* ubar, const void* K,
                const void* k, const void* lo, const void* hi,
                const void* const* params, int n_params,
                const int* int_params, int n_int_params, void* X, void* U,
                void* J, int block, cudaStream_t stream) {
  return with_dims(Dims{}, n, m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    return with_env_at<S, N>(env, params, n_params, int_params,
                             n_int_params,
                          [&](auto step) {
      rollout_alpha_kernel<S, N, N, decltype(step)>
          <<<blocks_for(B, block), block, 0, stream>>>(
              (const S*)alpha, (const S*)xbar, (const S*)ubar, (const S*)K,
              (const S*)k, (const S*)lo, (const S*)hi, step, (S*)X, (S*)U,
              (S*)J, T, B);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

// The dtype dispatch over the dims ``Dims``: K2 (X null) or K5, and K3.
template <class Dims>
int costs_dims(int dtype, int env, int n, int m, int T, int B,
               const void* xbar, const void* ubar, const void* K,
               const void* k, const void* lo, const void* hi,
               const double* alphas, int A, const void* const* params,
               int n_params, const int* int_params, int n_int_params,
               void* J, void* X, void* U, int block, cudaStream_t stream) {
  if (dtype == kFloat32)
    return costs_dtype<float, Dims>(env, n, m, T, B, xbar, ubar, K, k, lo,
                                    hi, alphas, A, params, n_params,
                                    int_params, n_int_params, J, X, U, block,
                                    stream);
  if (dtype == kFloat64)
    return costs_dtype<double, Dims>(env, n, m, T, B, xbar, ubar, K, k, lo,
                                     hi, alphas, A, params, n_params,
                                     int_params, n_int_params, J, X, U,
                                     block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <class Dims>
int alpha_dims(int dtype, int env, int n, int m, int T, int B,
               const void* alpha, const void* xbar, const void* ubar,
               const void* K, const void* k, const void* lo,
               const void* hi, const void* const* params, int n_params,
               const int* int_params, int n_int_params, void* X, void* U,
               void* J, int block, cudaStream_t stream) {
  if (dtype == kFloat32)
    return alpha_dtype<float, Dims>(env, n, m, T, B, alpha, xbar, ubar, K, k,
                                    lo, hi, params, n_params, int_params,
                                    n_int_params, X, U, J, block, stream);
  if (dtype == kFloat64)
    return alpha_dtype<double, Dims>(env, n, m, T, B, alpha, xbar, ubar, K,
                                     k, lo, hi, params, n_params, int_params,
                                     n_int_params, X, U, J, block, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// rollout.cu's dims, and those of rollout_n12.cu and rollout_n16.cu (each
// defines its costs_nN and alpha_nN with TFMPC_ROLLOUT_ENTRIES, so the
// parallel build compiles the two mid dims side by side).
using SmallDims = DimList<2, 3, 5, 6>;

#define TFMPC_ROLLOUT_ENTRIES(N)                                              \
  int costs_n##N(int dtype, int env, int n, int m, int T, int B,              \
                 const void* xbar, const void* ubar, const void* K,           \
                 const void* k, const void* lo, const void* hi,               \
                 const double* alphas, int A, const void* const* params,      \
                 int n_params, const int* int_params, int n_int_params,       \
                 void* J, void* X, void* U, int block, cudaStream_t stream)
#define TFMPC_ALPHA_ENTRIES(N)                                                \
  int alpha_n##N(int dtype, int env, int n, int m, int T, int B,              \
                 const void* alpha, const void* xbar, const void* ubar,       \
                 const void* K, const void* k, const void* lo,                \
                 const void* hi, const void* const* params, int n_params,     \
                 const int* int_params, int n_int_params, void* X, void* U,   \
                 void* J, int block, cudaStream_t stream)

TFMPC_ROLLOUT_ENTRIES(12);
TFMPC_ROLLOUT_ENTRIES(16);
TFMPC_ALPHA_ENTRIES(12);
TFMPC_ALPHA_ENTRIES(16);

}  // namespace tfmpc
