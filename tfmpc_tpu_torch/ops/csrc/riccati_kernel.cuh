// The batched Riccati backward over T in one kernel, shared by its four
// variants: K1 (riccati.cu), K4 (riccati_boxqp.cu), K6a (riccati_ddp.cu)
// and K6b (riccati_ddp_boxqp.cu). Each .cu instantiates only its own
// variant, at the (n, G) pairs its launch plans and timings use.
//
// A group of G lanes (G in {1, 2, 4, 8}) owns one scenario and walks
// t = T-1 .. 0; a block holds ``spb`` scenarios (ops/riccati.py lane_plan).
// Lane l owns the state and control indices l, l + G, ... and computes the
// columns of the step's products on them (riccati_step.cuh): at G >= n a
// lane holds about one column of each Q block instead of all of them, so
// the working set fits the registers, and B scenarios give G B threads
// (HVAC-6, B=2048, G=8: 512 warps, one per scheduler of the H100's 132
// SMs, where one thread a scenario gave one warp an SM).
//
// Staged steps: the block's inputs of step t-1 (the linearization, K4's
// nominal control, K6's dynamics Hessians) are copied into shared memory
// with cp.async while step t computes, into three rotating buffers, so one
// barrier a step orders both the copies and the buffers' reuse. The copies
// keep the JAX kernel layout [T, entries, B], a block's scenarios side by
// side, so consecutive threads copy consecutive addresses. Every lane
// reads the step's inputs from shared memory; the carried value function
// and the blocks a group exchanges live in the scenario's workspace there
// too.
#pragma once

#include <initializer_list>

#include "boxqp.cuh"
#include "riccati_step.cuh"

namespace tfmpc {

// The variants: whether k comes from the boxQP, and whether the full-DDP
// terms enter the Q blocks.
struct Ilqr { static constexpr bool kBox = false, kDdp = false; };
struct Boxqp { static constexpr bool kBox = true, kDdp = false; };
struct Ddp { static constexpr bool kBox = false, kDdp = true; };
struct DdpBoxqp { static constexpr bool kBox = true, kDdp = true; };

constexpr int kLaneMaxThreads = 256;        // ops/riccati.py LANE_MAX_THREADS
constexpr long long kLaneMaxSmem = 232448;  // a block's shared memory

// The step's inputs, device pointers in the JAX kernel's order; ubar, lo,
// hi are null unless Var::kBox, fxx, fux, fuu unless Var::kDdp.
template <typename S>
struct LaneInputs {
  const S *fx, *fu, *lx, *lu, *lxx, *luu, *lux, *mu, *ubar, *lo, *hi, *fxx,
      *fux, *fuu, *VT, *vT;
};

template <typename S>
struct LaneOutputs {
  S *K, *k, *dV1, *dV2, *fail;
};

// Copy the entries of one [T, E, B] block at step t into the stage (entry
// e of scenario cs at stage[(e0 + e) * st + cs]): this thread's entries
// e = ce, ce + G, ... for its scenario column cs (unrolled: E and G are
// compile-time, ce < G).
template <int G, int E, typename S>
__device__ __forceinline__ void stage_block(const S* __restrict__ src,
                                            S* stage, int e0, int st, int t,
                                            int b, int B, int ce, int cs) {
  const S* from = src + at(t, ce, E, b, B);
  S* to = stage + (e0 + ce) * st + cs;
#pragma unroll
  for (int r = 0; r < (E + G - 1) / G; ++r)
    if (ce + G * r < E)
      cp_async<sizeof(S)>(to + G * r * st,
                          from + static_cast<int64_t>(G * r) * B);
}

template <typename S, int N, int M, int G, typename Var>
__device__ __forceinline__ void stage_step(const LaneInputs<S>& in, S* stage,
                                           int st, int t, int b, int B,
                                           int ce, int cs) {
  using E = Entries<N, M, Var>;
  stage_block<G, N * N>(in.fx, stage, E::fx, st, t, b, B, ce, cs);
  stage_block<G, N * M>(in.fu, stage, E::fu, st, t, b, B, ce, cs);
  stage_block<G, N>(in.lx, stage, E::lx, st, t, b, B, ce, cs);
  stage_block<G, M>(in.lu, stage, E::lu, st, t, b, B, ce, cs);
  stage_block<G, N * N>(in.lxx, stage, E::lxx, st, t, b, B, ce, cs);
  stage_block<G, M * M>(in.luu, stage, E::luu, st, t, b, B, ce, cs);
  stage_block<G, M * N>(in.lux, stage, E::lux, st, t, b, B, ce, cs);
  if constexpr (Var::kBox)
    stage_block<G, M>(in.ubar, stage, E::ubar, st, t, b, B, ce, cs);
  if constexpr (Var::kDdp) {
    stage_block<G, N * N * N>(in.fxx, stage, E::fxx, st, t, b, B, ce, cs);
    stage_block<G, N * M * N>(in.fux, stage, E::fux, st, t, b, B, ce, cs);
    stage_block<G, N * M * M>(in.fuu, stage, E::fuu, st, t, b, B, ce, cs);
  }
}

// One step of one scenario on its group: Q blocks (and the DDP terms), the
// gains (Cholesky, or the boxQP), the value update into the workspace, and
// the gains to the outputs. Two barriers over the group order the
// workspace's exchanges.
template <typename S, int N, int M, int G, typename Var>
__device__ __forceinline__ void riccati_step(
    const Staged<S>& X, S* __restrict__ ws, const Group<G>& grp, S mu,
    int newton_iters,
    const LaneOutputs<S>& out, int t, int b, int B, S& dV1, S& dV2,
    bool& fail) {
  using Ws = Workspace<N, M>;
  S v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = ws[Ws::v + i];
  LaneQ<S, N, M, G> q;
  q_blocks<S, N, M, G, Var>(X, ws, grp.lane, v, mu, q);
  if constexpr (Var::kDdp) ddp_terms<S, N, M, G, Var>(X, grp.lane, v, mu, q);
  publish_q<S, N, M, G>(q, grp.lane, ws);
  if constexpr (Var::kBox) {
    for (int a = grp.lane; a < M; a += G) {
      const S u = X(Entries<N, M, Var>::ubar + a);
      ws[Ws::lo_t + a] = ws[Ws::lo + a] - u;
      ws[Ws::hi_t + a] = ws[Ws::hi + a] - u;
    }
  }
  grp.sync();

  S Qx[Owned<N, M, G>::RX];
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) Qx[o] = q.Qx[o];

  S kv[M], Kt[Owned<N, M, G>::RX][M];
  if constexpr (Var::kBox)
    boxqp_gains<S, N, M, G>(ws, newton_iters, grp, fail, kv, Kt);
  else
    chol_gains<S, N, M, G>(grp.lane, ws, fail, kv, Kt);
  publish_gains<S, N, M, G>(kv, Kt, grp.lane, ws);
  grp.sync();

  value_update<S, N, M, G>(Qx, kv, Kt, grp.lane, ws, dV1, dV2);
  store_gains<S, N, M, G>(out.K, out.k, t, b, B, grp.lane, kv, Kt);
}

template <typename S, int N, int M, int G, typename Var>
__global__ void riccati_kernel(const LaneInputs<S> in,
                               const LaneOutputs<S> out, int T, int B,
                               int newton_iters, int spb) {
  extern __shared__ __align__(16) unsigned char lane_smem[];
  using E = Entries<N, M, Var>;
  const int tid = threadIdx.x;
  const int st = spb | 1;
  S* stage = reinterpret_cast<S*>(lane_smem);  // [kStages][E::total][st]
  const int step_elems = E::total * st;
  const int b0 = blockIdx.x * spb;
  // the copies: thread (ce, cs) copies scenario cs's entries ce, ce + G, ...
  const int cs = tid % spb, ce = tid / spb;
  const bool copies = b0 + cs < B;
  // the compute: group s, lane grp.lane
  const int s = tid / G;
  const int b = b0 + s;
  const bool active = b < B;
  const Group<G> grp(tid);
  S* ws = stage + kStages * step_elems + s * Workspace<N, M>::stride;

  S mu = 0, dV1 = 0, dV2 = 0;
  bool fail = false;
  if (active) {
    mu = in.mu[b];
    load_final<S, N, M, G>(in.VT, in.vT, in.lo, in.hi, b, B, grp.lane, ws);
  }

  // Step u's inputs go to buffer u % 3 one step before step u computes,
  // one commit group a step (empty at t = 0). Buffer (t - 1) % 3, written
  // as step t is about to compute, was last read by step t + 2, which
  // every thread finished before the previous step's barrier.
  if (copies)
    stage_step<S, N, M, G, Var>(in, stage + ((T - 1) % kStages) * step_elems,
                                st, T - 1, b0 + cs, B, ce, cs);
  cp_async_commit();
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    if (copies && t > 0)
      stage_step<S, N, M, G, Var>(
          in, stage + ((t - 1) % kStages) * step_elems, st, t - 1, b0 + cs,
          B, ce, cs);
    cp_async_commit();
    cp_async_wait_one();  // step t's group is done, step t-1's may not be
    __syncthreads();      // step t's copies, from every thread, have landed
    if (active)
      riccati_step<S, N, M, G, Var>(
          Staged<S>{stage + (t % kStages) * step_elems + s, st}, ws, grp, mu,
          newton_iters, out, t, b, B, dV1, dV2, fail);
  }

  if (active && grp.lane == 0) {
    out.dV1[b] = dV1;
    out.dV2[b] = dV2;
    out.fail[b] = fail ? S(1) : S(0);
  }
}

// The (n, G) pairs a source instantiates, per dtype.
template <int N_, int G_>
struct NG {
  static constexpr int n = N_, g = G_;
};
template <typename... P>
struct Insts {};
template <typename A, typename B>
struct Cat;
template <typename... A, typename... B>
struct Cat<Insts<A...>, Insts<B...>> {
  using type = Insts<A..., B...>;
};
// Every G at every lane dim: the G sweep's build (tools/kernel_versions.py
// lane --sweep defines TFMPC_LANE_ALL_G).
using AllLaneG =
    Insts<NG<2, 1>, NG<2, 2>, NG<2, 4>, NG<2, 8>, NG<3, 1>, NG<3, 2>,
          NG<3, 4>, NG<3, 8>, NG<5, 1>, NG<5, 2>, NG<5, 4>, NG<5, 8>,
          NG<6, 1>, NG<6, 2>, NG<6, 4>, NG<6, 8>>;

// A launch: the sizes, the plan (G lanes a scenario, spb scenarios a
// block, the block's dynamic shared bytes) and the C
// entry's pointers in the JAX kernel's input order (the bracketed groups
// only for the variants that take them): fx, fu, lx, lu, lxx, luu, lux,
// mu, [ubar, lo, hi], [fxx, fux, fuu], VT, vT; out: K, k, dV1, dV2, fail.
struct LaneLaunch {
  int T, B, iters, groups, spb;
  long long smem_bytes;
  const void* const* in;
  void* const* out;
  cudaStream_t stream;
};

template <typename Var, typename S, int N, int G>
int launch_lane(const LaneLaunch& l) {
  const long long bytes = lane_smem_bytes(Var::kBox, Var::kDdp, sizeof(S), N,
                                          N, l.spb);
  if (bytes != l.smem_bytes || bytes > kLaneMaxSmem ||
      G * l.spb > kLaneMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  int i = 0;
  auto next = [&]() { return static_cast<const S*>(l.in[i++]); };
  LaneInputs<S> in{};
  for (const S** p : {&in.fx, &in.fu, &in.lx, &in.lu, &in.lxx, &in.luu,
                       &in.lux, &in.mu})
    *p = next();
  if (Var::kBox) {
    in.ubar = next();
    in.lo = next();
    in.hi = next();
  }
  if (Var::kDdp) {
    in.fxx = next();
    in.fux = next();
    in.fuu = next();
  }
  in.VT = next();
  in.vT = next();
  const LaneOutputs<S> out{static_cast<S*>(l.out[0]),
                           static_cast<S*>(l.out[1]),
                           static_cast<S*>(l.out[2]),
                           static_cast<S*>(l.out[3]),
                           static_cast<S*>(l.out[4])};
  auto kernel = riccati_kernel<S, N, N, G, Var>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks_for(l.B, l.spb), G * l.spb, static_cast<size_t>(bytes),
           l.stream>>>(in, out, l.T, l.B, l.iters, l.spb);
  return static_cast<int>(cudaGetLastError());
}

template <typename Var, typename S, typename... P>
int dispatch(Insts<P...>, int n, const LaneLaunch& l) {
  int rc = static_cast<int>(cudaErrorInvalidValue);  // not instantiated
  (void)((n == P::n && l.groups == P::g
              ? (rc = launch_lane<Var, S, P::n, P::g>(l), true)
              : false) ||
         ...);
  return rc;
}

// The body of every C entry: (n, m) in {(2,2), (3,3), (5,5), (6,6)}
// (ops/riccati.py KERNEL_DIMS), float32 (the (n, G) pairs of F32) or
// float64 (F64).
template <typename Var, typename F32, typename F64>
int launch_riccati(int dtype, int n, int m, int T, int B, int newton_iters,
                   const void* const* in, void* const* out, int groups,
                   int spb, long long smem_bytes, void* stream) {
  if (n != m || T < 1 || newton_iters < 0 || spb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const LaneLaunch l{T, B, newton_iters, groups, spb, smem_bytes, in, out,
                     static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return dispatch<Var, float>(F32{}, n, l);
  if (dtype == kFloat64) return dispatch<Var, double>(F64{}, n, l);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tfmpc
