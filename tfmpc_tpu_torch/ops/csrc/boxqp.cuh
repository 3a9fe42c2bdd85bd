// The per-scenario projected-Newton boxQP of K4 and K6b (ops/boxqp.py;
// the JAX kernel's _boxqp_lane), and the control-limited gains built on it.
//
// On (QuuR, Qu) within [lo - ubar_t, hi - ubar_t]:
//   - x starts at clip(0, lo, hi);
//   - free = !((x <= lo & g > 0) | (x >= hi & g < 0)), g = Qu + QuuR x;
//   - converged when sum(free g^2) < 1e-16 or nothing is free;
//   - the Newton step solves the masked system (QuuR on free x free, 1 on
//     the clamped diagonal) by a Cholesky WITHOUT the clamp: a pivot that
//     is not > 0 makes the factor NaN, hence a NaN step, NaN candidates and
//     no improvement, as jnp.linalg.cholesky's NaN factor does;
//   - alpha = 2^-i for i < 8, the first candidate clip(x + alpha d) with
//     obj < obj_now - 1e-12 wins;
//   - a problem that converged or found no improvement is frozen (done).
// Then the final free set's masked Cholesky (with the probe: its failure
// also fails the lane) gives K with rhs free[a] * QuxR[a][i], so clamped
// rows are exactly 0; k = x.
//
// Every lane of a scenario's group runs the Newton iterations alike on
// QuuR read from the group's workspace (riccati_step.cuh): the same values
// in the same order, so the same free sets, tests and branches, and no
// lane of a group diverges from the others. The line search spreads its
// candidates over the group: lane l tries alpha = 2^-(i0 + l) for rounds
// i0 = 0, G, 2G, ..., and a ballot over the group takes the smallest i
// whose candidate improves, which is the sequential rule's winner. The
// Newton and line-search loops do NOT unroll (#pragma unroll 1) and end
// early once a problem is done or a candidate improves.
#pragma once

#include "riccati_step.cuh"

namespace tfmpc {

constexpr int kLsAlphas = 8;  // ops/boxqp.py LS_ALPHAS

// Cholesky that lets failure propagate: a pivot that is not > 0 (or NaN)
// gives NaN, as LAPACK's potrf failure gives jnp.linalg.cholesky a NaN
// factor. A(r, c) is read for r >= c.
template <typename S, int M, typename A>
__device__ __forceinline__ void chol_nan(A a_at, S (&L)[M][M]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < a; ++c) acc += L[a][c] * L[a][c];
    const S s = a_at(a, a) - acc;
    const S La = s > S(0) ? dsqrt(s) : dnan<S>();
    L[a][a] = La;
    const S inv = S(1) / La;
#pragma unroll
    for (int r = a + 1; r < M; ++r) {
      S acc2 = 0;
#pragma unroll
      for (int c = 0; c < a; ++c) acc2 += L[r][c] * L[a][c];
      L[r][a] = (a_at(r, a) - acc2) * inv;
    }
  }
}

// A read of the boxQP's blocks in the group's workspace. In double it is
// volatile, so the compiler re-reads shared memory in each Newton and
// line-search iteration instead of hoisting QuuR, Qu and the box into ~100
// registers, which K4 at n = 6 would spill; in float the hoisted copies
// fit, and re-reading measured slower (K4 at HVAC-6 on an H100,
// tools/kernel_versions.py lane against such a variant).
template <typename S>
__device__ __forceinline__ S ld(const S* p) {
  if constexpr (sizeof(S) == 8) return *static_cast<const volatile S*>(p);
  else return *p;
}

// The masked free system of H (row-major in shared memory): H on
// free x free, 1 on the clamped diagonal, as an accessor.
template <typename S, int M>
struct Masked {
  const S* H;
  const bool (&free)[M];
  __device__ __forceinline__ S operator()(int a, int c) const {
    return (free[a] && free[c]) ? ld(H + a * M + c) : (a == c ? S(1) : S(0));
  }
};

// One boxQP on the group's workspace: H = QuuR, q = Qu and the step's box
// [lo, hi], all in shared memory.
template <typename S>
struct BoxQp {
  const S *H, *q, *lo, *hi;
};

// g = q + H x and the free set at x.
template <typename S, int M>
__device__ __forceinline__ void gradient_free(const BoxQp<S>& p,
                                              const S (&x)[M], S (&g)[M],
                                              bool (&free)[M]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) acc += ld(p.H + a * M + c) * x[c];
    g[a] = ld(p.q + a) + acc;
    free[a] = !((x[a] <= ld(p.lo + a) && g[a] > S(0)) ||
                (x[a] >= ld(p.hi + a) && g[a] < S(0)));
  }
}

// 1/2 x^T H x + q^T x, summed as ops/boxqp.py's _objective.
template <typename S, int M>
__device__ __forceinline__ S objective(const BoxQp<S>& p, const S (&x)[M]) {
  S xHx = 0, qx = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) acc += ld(p.H + a * M + c) * x[c];
    xHx += x[a] * acc;
  }
#pragma unroll
  for (int a = 0; a < M; ++a) qx += ld(p.q + a) * x[a];
  return S(0.5) * xHx + qx;
}

// The line-search candidate clip(x - alpha d) at alpha = 2^-i (exact).
template <typename S, int M>
__device__ __forceinline__ void candidate(const BoxQp<S>& p, const S (&x)[M],
                                          const S (&d)[M], int i,
                                          S (&cand)[M]) {
  const S alpha = S(1) / S(1 << i);
#pragma unroll
  for (int a = 0; a < M; ++a)
    cand[a] = clip(x[a] - alpha * d[a], ld(p.lo + a), ld(p.hi + a));
}

// Projected-Newton boxQP (ops/boxqp.py) on a group of G lanes; writes the
// minimizer x and the final free set, the same in every lane.
template <typename S, int M, int G>
__device__ __forceinline__ void boxqp(const BoxQp<S>& p, int newton_iters,
                                      const Group<G>& grp, S (&x)[M],
                                      bool (&free)[M]) {
  S g[M];
#pragma unroll
  for (int a = 0; a < M; ++a) x[a] = clip(S(0), ld(p.lo + a), ld(p.hi + a));

#pragma unroll 1
  for (int it = 0; it < newton_iters; ++it) {
    gradient_free<S, M>(p, x, g, free);
    S gfree2 = 0;
    int nfree = 0;
    S gm[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      gm[a] = free[a] ? g[a] : S(0);
      gfree2 += gm[a] * gm[a];
      nfree += free[a] ? 1 : 0;
    }
    if (gfree2 < S(1e-16) || nfree == 0) break;  // converged: x stays

    S L[M][M], d[M];
    chol_nan<S, M>(Masked<S, M>{p.H, free}, L);
    chol_solve<S, M>(L, gm, d);

    const S obj_now = objective<S, M>(p, x);
    int win = -1;
#pragma unroll 1
    for (int i0 = 0; i0 < kLsAlphas; i0 += G) {
      const int i = i0 + grp.lane;
      bool better = false;
      if (i < kLsAlphas) {
        S cand[M];
        candidate<S, M>(p, x, d, i, cand);
        better = objective<S, M>(p, cand) < obj_now - S(1e-12);
      }
      const unsigned bits = grp.ballot(better);
      if (bits != 0u) {
        win = i0 + __ffs(bits) - 1;
        break;
      }
    }
    if (win < 0) break;  // no improvement: x stays, frozen
    S cand[M];
    candidate<S, M>(p, x, d, win, cand);
#pragma unroll
    for (int a = 0; a < M; ++a) x[a] = cand[a];
  }
  gradient_free<S, M>(p, x, g, free);
}

// K4's gains at one step: the PD probe of QuuR (its factor is not used),
// the boxQP within the step's box [lo - ubar_t, hi - ubar_t] (lo_t, hi_t
// of the workspace) for k (every lane), and the lane's columns K[:, j]
// from the final free set's factor, rhs free[a] * QuxR[a][j].
template <typename S, int N, int M, int G>
__device__ __forceinline__ void boxqp_gains(const S* __restrict__ ws,
                                            int newton_iters,
                                            const Group<G>& grp, bool& fail,
                                            S (&kv)[M],
                                            S (&Kt)[Owned<N, M, G>::RX][M]) {
  using Ws = Workspace<N, M>;
  const BoxQp<S> p{ws + Ws::H, ws + Ws::Qu, ws + Ws::lo_t, ws + Ws::hi_t};
  {
    S L[M][M];
    chol_probe<S, M>([&](int r, int c) { return p.H[r * M + c]; }, L, fail);
  }
  bool free[M];
  boxqp<S, M, G>(p, newton_iters, grp, kv, free);

  S Lf[M][M];
  chol_probe<S, M>(Masked<S, M>{p.H, free}, Lf, fail);
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    S rhs[M], xs[M];
    quxr_column<S, N, M>(ws, grp.lane + G * o, free, rhs);
    chol_solve<S, M>(Lf, rhs, xs);
#pragma unroll
    for (int a = 0; a < M; ++a) Kt[o][a] = -xs[a];
  }
}

}  // namespace tfmpc
