// Phase clocks of the one-thread K2 and K3 of commit 0bac190 (one thread
// a rollout, each step's inputs read from device memory when the step
// begins, the env's parameters read through the functor's device
// pointers), for
// tools/kernel_versions.py rollout --clocks. The loop is that commit's
// linesearch_costs_kernel / rollout_alpha_kernel with clock64() between
// its phases:
//   0 load wait: issue the step's n + m + m n + m loads and wait for them
//                (a pairwise sum of the loaded values, kept alive by a
//                store under a condition that never holds, consumes each);
//   1 policy:    dx and u from the loaded values (policy_control's sums);
//   2 env step:  the functor's step (stage cost, next state);
//   3 stores:    K3's X and U of the step (K2: none).
// A stall is counted in the phase of the instruction that waits. Every
// thread adds its cycles to clocks[phase]; clocks[4] counts the threads
// (clocks[5] is the never-taken store's). Built alone with the port's
// nvcc flags and -I the port's csrc.
#include "rollout.cuh"

namespace tfmpc {
namespace {

__device__ __forceinline__ void hold(float v) { asm volatile("" ::"f"(v)); }
__device__ __forceinline__ void hold(double v) { asm volatile("" ::"d"(v)); }

template <typename S, int N, int M, class Env, bool kCosts>
__global__ void clocked_rollout(const S* __restrict__ xbar,
                                const S* __restrict__ ubar,
                                const S* __restrict__ K,
                                const S* __restrict__ k,
                                const S* __restrict__ lo,
                                const S* __restrict__ hi, Alphas<S> alphas,
                                const S* __restrict__ alpha_in, int A,
                                Env env, S* __restrict__ X,
                                S* __restrict__ U, S* __restrict__ J, int T,
                                int B, unsigned long long* clocks) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(kCosts ? A : 1) * B) return;
  const int b = static_cast<int>(idx % B);
  const int a = static_cast<int>(idx / B);
  const S alpha = kCosts ? alphas.v[a] : alpha_in[b];
  unsigned long long phase[4] = {0, 0, 0, 0};

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    long long c0 = clock64();
    S xb[N], ub[M], kk[M], KK[M * N];
#pragma unroll
    for (int i = 0; i < N; ++i) xb[i] = xbar[at(t, i, N, b, B)];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      ub[c] = ubar[at(t, c, M, b, B)];
      kk[c] = k[at(t, c, M, b, B)];
    }
#pragma unroll
    for (int e = 0; e < M * N; ++e) KK[e] = K[at(t, e, M * N, b, B)];
    constexpr int L = N + 2 * M + M * N;
    S vals[L];
#pragma unroll
    for (int i = 0; i < N; ++i) vals[i] = xb[i];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      vals[N + c] = ub[c];
      vals[N + M + c] = kk[c];
    }
#pragma unroll
    for (int e = 0; e < M * N; ++e) vals[N + 2 * M + e] = KK[e];
#pragma unroll
    for (int w = 1; w < L; w *= 2) {
#pragma unroll
      for (int i = 0; i + w < L; i += 2 * w) vals[i] += vals[i + w];
    }
    if (vals[0] == S(-1.25e-37)) atomicAdd(clocks + 5, 1ull);
    long long c1 = clock64();
    S dx[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) dx[i] = x[i] - xb[i];
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const S base = ub[c] + alpha * kk[c];
      S acc = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) acc += KK[c * N + i] * dx[i];
      u[c] = base + acc;
      if (lo != nullptr) u[c] = clip(u[c], lo[c], hi[c]);
      hold(u[c]);
    }
    long long c2 = clock64();
    S xn[N];
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) hold(xn[i]);
    long long c3 = clock64();
    if constexpr (!kCosts) {
#pragma unroll
      for (int i = 0; i < N; ++i) X[at(t, i, N, b, B)] = xn[i];
#pragma unroll
      for (int c = 0; c < M; ++c) U[at(t, c, M, b, B)] = u[c];
    }
    long long c4 = clock64();
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xn[i];
    phase[0] += c1 - c0;
    phase[1] += c2 - c1;
    phase[2] += c3 - c2;
    phase[3] += c4 - c3;
  }
  J[idx] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
  for (int p = 0; p < 4; ++p) atomicAdd(clocks + p, phase[p]);
  atomicAdd(clocks + 4, 1ull);
}

}  // namespace
}  // namespace tfmpc

// K2 (alpha_in null: the A alphas of ``alphas``) or K3 (alpha_in [B]) in
// float32 at the table's shapes' dims and envs: navigation at n = 2,
// reservoir at 5, HVAC at 6 and 16. ``clocks``: 6 device counters.
extern "C" int tfmpc_rollout_clocks(
    int env, int n, int T, int B, const void* xbar, const void* ubar,
    const void* K, const void* k, const void* lo, const void* hi,
    const double* alphas, int A, const void* alpha_in,
    const void* const* params, int n_params, const int* int_params,
    int n_int_params, void* X, void* U, void* J, void* clocks, int block,
    void* stream) {
  using namespace tfmpc;
  using S = float;
  Alphas<S> al{};
  for (int a = 0; a < A && a < kMaxAlphas; ++a)
    al.v[a] = static_cast<S>(alphas[a]);
  const bool costs = alpha_in == nullptr;
  const int64_t threads = static_cast<int64_t>(costs ? A : 1) * B;
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    return with_env_at<S, N>(env, params, n_params, int_params, n_int_params,
                             [&](auto step) {
      using Env = decltype(step);
      constexpr bool kSwept =
          (N == 2 && Env::kId == kNavigation) ||
          (N == 5 && Env::kId == kReservoir) ||
          ((N == 6 || N == 16) && Env::kId == kHVAC);
      if constexpr (!kSwept) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        auto args = [&](auto kernel) {
          kernel<<<blocks_for(threads, block), block, 0, s>>>(
              (const S*)xbar, (const S*)ubar, (const S*)K, (const S*)k,
              (const S*)lo, (const S*)hi, al, (const S*)alpha_in, A, step,
              (S*)X, (S*)U, (S*)J, T, B,
              static_cast<unsigned long long*>(clocks));
          return static_cast<int>(cudaGetLastError());
        };
        return costs ? args(clocked_rollout<S, N, N, Env, true>)
                     : args(clocked_rollout<S, N, N, Env, false>);
      }
    });
  };
  return with_dims(DimList<2, 5, 6, 16>{}, n, n, go);
}
