// The batched Riccati backward over T in one kernel, shared by its four
// variants: K1 (riccati.cu), K4 (riccati_boxqp.cu), K6a (riccati_ddp.cu)
// and K6b (riccati_ddp_boxqp.cu). Each .cu instantiates only its own
// variant, so the parallel build compiles them side by side.
//
// One thread owns one scenario and walks t = T-1 .. 0, keeping the value
// function (V, v), the accumulators and every intermediate in registers:
// the Q blocks (riccati_step.cuh), for DDP the v-contracted dynamics
// Hessians (ddp_terms), the gains (chol_gains, or boxqp_gains of
// boxqp.cuh), dV1/dV2 from the unregularized Q terms, and the symmetrized
// value update. Inputs keep the JAX kernel layout [T, entries, B], so a
// warp's 32 threads read 32 consecutive addresses; a step's loads do not
// depend on the chain, so they are issued ahead of its arithmetic.
#pragma once

#include "boxqp.cuh"
#include "riccati_step.cuh"

namespace tfmpc {

// The variants: whether k comes from the boxQP, and whether the full-DDP
// terms enter the Q blocks.
struct Ilqr { static constexpr bool kBox = false, kDdp = false; };
struct Boxqp { static constexpr bool kBox = true, kDdp = false; };
struct Ddp { static constexpr bool kBox = false, kDdp = true; };
struct DdpBoxqp { static constexpr bool kBox = true, kDdp = true; };

template <typename S, int N, int M, typename Var>
__device__ __forceinline__ void riccati_step(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ ubar,
    const S* __restrict__ lo, const S* __restrict__ hi,
    const S* __restrict__ fxx, const S* __restrict__ fux,
    const S* __restrict__ fuu, S* __restrict__ K_out, S* __restrict__ k_out,
    int t, int b, int B, int newton_iters, S mu, S (&V)[N][N], S (&v)[N],
    S& dV1, S& dV2, bool& fail) {
  QBlocks<S, N, M> q;
  q_blocks<S, N, M>(fx, fu, lx, lu, lxx, luu, lux, t, b, B, V, v, mu, q);
  if constexpr (Var::kDdp)
    ddp_terms<S, N, M>(fxx, fux, fuu, t, b, B, v, mu, q);

  S kv[M], Kt[M][N];
  if constexpr (Var::kBox)
    boxqp_gains<S, N, M>(q, ubar, lo, hi, t, b, B, newton_iters, fail, kv,
                         Kt);
  else
    chol_gains<S, N, M>(q, fail, kv, Kt);

  value_update<S, N, M>(q, kv, Kt, V, v, dV1, dV2);
  store_gains<S, N, M>(K_out, k_out, t, b, B, kv, Kt);
}

// ubar, lo, hi are null unless Var::kBox; fxx, fux, fuu unless Var::kDdp.
template <typename S, int N, int M, typename Var>
__global__ void riccati_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ ubar, const S* __restrict__ lo,
    const S* __restrict__ hi, const S* __restrict__ fxx,
    const S* __restrict__ fux, const S* __restrict__ fuu,
    const S* __restrict__ VT, const S* __restrict__ vT,
    S* __restrict__ K_out, S* __restrict__ k_out, S* __restrict__ dV1_out,
    S* __restrict__ dV2_out, S* __restrict__ fail_out, int T, int B,
    int newton_iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  S V[N][N], v[N];
  load_final<S, N>(VT, vT, b, B, V, v);
  const S mu = mu_in[b];
  S dV1 = 0, dV2 = 0;
  bool fail = false;

  if constexpr (Var::kBox) {
    // the boxQP loops are large: keep the T loop rolled
#pragma unroll 1
    for (int t = T - 1; t >= 0; --t)
      riccati_step<S, N, M, Var>(fx, fu, lx, lu, lxx, luu, lux, ubar, lo, hi,
                                 fxx, fux, fuu, K_out, k_out, t, b, B,
                                 newton_iters, mu, V, v, dV1, dV2, fail);
  } else {
    for (int t = T - 1; t >= 0; --t)
      riccati_step<S, N, M, Var>(fx, fu, lx, lu, lxx, luu, lux, ubar, lo, hi,
                                 fxx, fux, fuu, K_out, k_out, t, b, B,
                                 newton_iters, mu, V, v, dV1, dV2, fail);
  }

  dV1_out[b] = dV1;
  dV2_out[b] = dV2;
  fail_out[b] = fail ? S(1) : S(0);
}

template <typename Var, typename S, int N>
int launch_n(int T, int B, int iters, const void* const* in,
             void* const* out, int block, cudaStream_t stream) {
  // in: fx, fu, lx, lu, lxx, luu, lux, mu, [ubar, lo, hi], [fxx, fux, fuu],
  // VT, vT (the JAX kernel's input order; the bracketed groups only for
  // the variants that take them)
  int i = 0;
  auto next = [&]() { return static_cast<const S*>(in[i++]); };
  const S* first[8];
  for (auto& p : first) p = next();
  const S *ubar = nullptr, *lo = nullptr, *hi = nullptr;
  if (Var::kBox) {
    ubar = next();
    lo = next();
    hi = next();
  }
  const S *fxx = nullptr, *fux = nullptr, *fuu = nullptr;
  if (Var::kDdp) {
    fxx = next();
    fux = next();
    fuu = next();
  }
  const S* VT = next();
  const S* vT = next();
  riccati_kernel<S, N, N, Var><<<blocks_for(B, block), block, 0, stream>>>(
      first[0], first[1], first[2], first[3], first[4], first[5], first[6],
      first[7], ubar, lo, hi, fxx, fux, fuu, VT, vT, (S*)out[0], (S*)out[1],
      (S*)out[2], (S*)out[3], (S*)out[4], T, B, iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename Var, typename S>
int launch_dims(int n, int m, int T, int B, int iters, const void* const* in,
                void* const* out, int block, cudaStream_t stream) {
  if (n != m) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 2: return launch_n<Var, S, 2>(T, B, iters, in, out, block, stream);
    case 3: return launch_n<Var, S, 3>(T, B, iters, in, out, block, stream);
    case 5: return launch_n<Var, S, 5>(T, B, iters, in, out, block, stream);
    case 6: return launch_n<Var, S, 6>(T, B, iters, in, out, block, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The body of every C entry: (n, m) in {(2,2), (3,3), (5,5), (6,6)}
// (ops/riccati.py KERNEL_DIMS), float32 or float64.
template <typename Var>
int launch_riccati(int dtype, int n, int m, int T, int B, int newton_iters,
                   const void* const* in, void* const* out, int block,
                   void* stream) {
  if (T < 1 || newton_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dims<Var, float>(n, m, T, B, newton_iters, in, out, block, s);
  if (dtype == kFloat64)
    return launch_dims<Var, double>(n, m, T, B, newton_iters, in, out, block,
                                    s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfmpc
