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
// The Newton and line-search loops do NOT unroll (#pragma unroll 1) and end
// early once a problem is done or a candidate improves, which keeps code
// size and compile time sane at (6, 6) in float64.
#pragma once

#include "riccati_step.cuh"

namespace tfmpc {

constexpr int kLsAlphas = 8;  // ops/boxqp.py LS_ALPHAS

// Cholesky that lets failure propagate: a pivot that is not > 0 (or NaN)
// gives NaN, as LAPACK's potrf failure gives jnp.linalg.cholesky a NaN
// factor.
template <typename S, int M>
__device__ __forceinline__ void chol_nan(const S (&A)[M][M], S (&L)[M][M]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < a; ++c) acc += L[a][c] * L[a][c];
    const S s = A[a][a] - acc;
    const S La = s > S(0) ? dsqrt(s) : dnan<S>();
    L[a][a] = La;
    const S inv = S(1) / La;
#pragma unroll
    for (int r = a + 1; r < M; ++r) {
      S acc2 = 0;
#pragma unroll
      for (int c = 0; c < a; ++c) acc2 += L[r][c] * L[a][c];
      L[r][a] = (A[r][a] - acc2) * inv;
    }
  }
}

// The masked free system: H on free x free, 1 on the clamped diagonal.
template <typename S, int M>
__device__ __forceinline__ void masked_system(const S (&H)[M][M],
                                              const bool (&free)[M],
                                              S (&Mx)[M][M]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int c = 0; c < M; ++c)
      Mx[a][c] = (free[a] && free[c]) ? H[a][c]
                                      : (a == c ? S(1) : S(0));
}

// g = q + H x and the free set at x.
template <typename S, int M>
__device__ __forceinline__ void gradient_free(const S (&H)[M][M],
                                              const S (&q)[M],
                                              const S (&x)[M],
                                              const S (&lo)[M],
                                              const S (&hi)[M], S (&g)[M],
                                              bool (&free)[M]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) acc += H[a][c] * x[c];
    g[a] = q[a] + acc;
    free[a] = !((x[a] <= lo[a] && g[a] > S(0)) ||
                (x[a] >= hi[a] && g[a] < S(0)));
  }
}

// 1/2 x^T H x + q^T x, summed as ops/boxqp.py's _objective.
template <typename S, int M>
__device__ __forceinline__ S objective(const S (&H)[M][M], const S (&q)[M],
                                       const S (&x)[M]) {
  S xHx = 0, qx = 0;
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) acc += H[a][c] * x[c];
    xHx += x[a] * acc;
  }
#pragma unroll
  for (int a = 0; a < M; ++a) qx += q[a] * x[a];
  return S(0.5) * xHx + qx;
}

// Projected-Newton boxQP (ops/boxqp.py); writes the minimizer x and the
// final free set.
template <typename S, int M>
__device__ __forceinline__ void boxqp(const S (&H)[M][M], const S (&q)[M],
                                      const S (&lo)[M], const S (&hi)[M],
                                      int newton_iters, S (&x)[M],
                                      bool (&free)[M]) {
  S g[M];
#pragma unroll
  for (int a = 0; a < M; ++a) x[a] = clip(S(0), lo[a], hi[a]);

#pragma unroll 1
  for (int it = 0; it < newton_iters; ++it) {
    gradient_free<S, M>(H, q, x, lo, hi, g, free);
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

    S Mx[M][M], L[M][M], d[M];
    masked_system<S, M>(H, free, Mx);
    chol_nan<S, M>(Mx, L);
    chol_solve<S, M>(L, gm, d);

    const S obj_now = objective<S, M>(H, q, x);
    bool found = false;
    S alpha = 1;
#pragma unroll 1
    for (int i = 0; i < kLsAlphas; ++i) {
      S cand[M];
#pragma unroll
      for (int a = 0; a < M; ++a) cand[a] = clip(x[a] - alpha * d[a], lo[a],
                                                 hi[a]);
      if (objective<S, M>(H, q, cand) < obj_now - S(1e-12)) {
#pragma unroll
        for (int a = 0; a < M; ++a) x[a] = cand[a];
        found = true;
        break;
      }
      alpha = alpha * S(0.5);  // 2^-i exactly
    }
    if (!found) break;  // no improvement: x stays, frozen
  }
  gradient_free<S, M>(H, q, x, lo, hi, g, free);
}

// K4's gains at step t of scenario b: the PD probe of QuuR (its factor is
// not used), the boxQP within [lo_in - ubar_t, hi_in - ubar_t] for k, and
// K from the final free set's factor, rhs free[a] * QuxR[a][i].
template <typename S, int N, int M>
__device__ __forceinline__ void boxqp_gains(
    const QBlocks<S, N, M>& q, const S* __restrict__ ubar,
    const S* __restrict__ lo_in, const S* __restrict__ hi_in, int t, int b,
    int B, int newton_iters, bool& fail, S (&kv)[M], S (&Kt)[M][N]) {
  {
    S L[M][M];
    chol_probe<S, M>(q.QuuR, L, fail);
  }

  S lo[M], hi[M];
  bool free[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    const S u = ubar[at(t, a, M, b, B)];
    lo[a] = lo_in[a] - u;
    hi[a] = hi_in[a] - u;
  }
  boxqp<S, M>(q.QuuR, q.Qu, lo, hi, newton_iters, kv, free);

  S Mx[M][M], Lf[M][M];
  masked_system<S, M>(q.QuuR, free, Mx);
  chol_probe<S, M>(Mx, Lf, fail);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S rhs[M], xs[M];
#pragma unroll
    for (int a = 0; a < M; ++a) rhs[a] = free[a] ? q.QuxR[a][i] : S(0);
    chol_solve<S, M>(Lf, rhs, xs);
#pragma unroll
    for (int a = 0; a < M; ++a) Kt[a][i] = -xs[a];
  }
}

}  // namespace tfmpc
