// One Riccati timestep of one scenario, shared by K1, K4, K6a and K6b
// (riccati_kernel.cuh): the Q blocks, the full-DDP terms, the small
// Cholesky factorizations and solves, and the value update. Every loop runs
// over the template dims, so it unrolls and the matrices stay in registers
// (or spill to local memory when they do not fit).
//
// Arithmetic mirrors tfmpc_tpu/ops/riccati_pallas.py::_riccati_step_math,
// _chol_unrolled and _chol_solve_unrolled op for op.
#pragma once

#include "common.cuh"

namespace tfmpc {

template <typename S, int N, int M>
struct QBlocks {
  S Qx[N], Qu[M];
  S Qxx[N][N], Quu[M][M], Qux[M][N];  // unregularized
  S QuuR[M][M], QuxR[M][N];           // with V + mu I
};

// Q blocks at step t of scenario b from the [T, entries, B] linearization
// and the carried value function (V, v), with VR = V + mu I.
template <typename S, int N, int M>
__device__ __forceinline__ void q_blocks(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, int t, int b, int B, const S (&V)[N][N],
    const S (&v)[N], S mu, QBlocks<S, N, M>& q) {
  S Fx[N][N], Fu[N][M], Lx[N], Lu[M], Lxx[N][N], Luu[M][M], Lux[M][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Fx[i][j] = fx[at(t, i * N + j, N * N, b, B)];
      Lxx[i][j] = lxx[at(t, i * N + j, N * N, b, B)];
    }
#pragma unroll
    for (int a = 0; a < M; ++a) Fu[i][a] = fu[at(t, i * M + a, N * M, b, B)];
    Lx[i] = lx[at(t, i, N, b, B)];
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    Lu[a] = lu[at(t, a, M, b, B)];
#pragma unroll
    for (int c = 0; c < M; ++c) Luu[a][c] = luu[at(t, a * M + c, M * M, b, B)];
#pragma unroll
    for (int i = 0; i < N; ++i) Lux[a][i] = lux[at(t, a * N + i, M * N, b, B)];
  }

  S VR[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) VR[i][j] = V[i][j] + (i == j ? mu : S(0));

  // Q_x = l_x + f_x^T v ; Q_u = l_u + f_u^T v
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S acc = 0;
#pragma unroll
    for (int p = 0; p < N; ++p) acc += Fx[p][i] * v[p];
    q.Qx[i] = Lx[i] + acc;
  }
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int p = 0; p < N; ++p) acc += Fu[p][a] * v[p];
    q.Qu[a] = Lu[a] + acc;
  }

  // W = V f_x, Wu = V f_u, WRu = (V + mu I) f_u, WRx = (V + mu I) f_x
  S W[N][N], Wu[N][M], WRu[N][M], WRx[N][N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S w = 0, wr = 0;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        w += V[p][r] * Fx[r][j];
        wr += VR[p][r] * Fx[r][j];
      }
      W[p][j] = w;
      WRx[p][j] = wr;
    }
#pragma unroll
    for (int c = 0; c < M; ++c) {
      S w = 0, wr = 0;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        w += V[p][r] * Fu[r][c];
        wr += VR[p][r] * Fu[r][c];
      }
      Wu[p][c] = w;
      WRu[p][c] = wr;
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) acc += Fx[p][i] * W[p][j];
      q.Qxx[i][j] = Lxx[i][j] + acc;
    }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      S acc = 0, accR = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        acc += Fu[p][a] * Wu[p][c];
        accR += Fu[p][a] * WRu[p][c];
      }
      q.Quu[a][c] = Luu[a][c] + acc;
      q.QuuR[a][c] = Luu[a][c] + accR;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S acc = 0, accR = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        acc += Fu[p][a] * W[p][i];
        accR += Fu[p][a] * WRx[p][i];
      }
      q.Qux[a][i] = Lux[a][i] + acc;
      q.QuxR[a][i] = Lux[a][i] + accR;
    }
  }
}

// The full-DDP terms (the sec branch of _riccati_step_math): the dynamics
// Hessians contracted with the value gradient v,
//   t_xx[i][j] = sum_p v[p] fxx[p][i][j], t_ux[a][i], t_uu[a][c] alike,
// added to Qxx, Qux, Quu and to QuxR, and QuuR = (QuuR + t_uu) + mu I_m
// (the combined regularization, in the JAX order of additions). Each
// Hessian entry is read once from global memory straight into its sum
// ([T, entries, B] layout, entry (p*N + i)*N + j etc.: a warp reads 32
// consecutive addresses), and each sum is folded into its Q block at once,
// so no n^3 array is held.
template <typename S, int N, int M>
__device__ __forceinline__ void ddp_terms(
    const S* __restrict__ fxx, const S* __restrict__ fux,
    const S* __restrict__ fuu, int t, int b, int B, const S (&v)[N], S mu,
    QBlocks<S, N, M>& q) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * fxx[at(t, (p * N + i) * N + j, N * N * N, b, B)];
      q.Qxx[i][j] = q.Qxx[i][j] + acc;
    }
#pragma unroll
  for (int a = 0; a < M; ++a) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * fux[at(t, (p * M + a) * N + i, N * M * N, b, B)];
      q.Qux[a][i] = q.Qux[a][i] + acc;
      q.QuxR[a][i] = q.QuxR[a][i] + acc;
    }
#pragma unroll
    for (int c = 0; c < M; ++c) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * fuu[at(t, (p * M + a) * M + c, N * M * M, b, B)];
      q.Quu[a][c] = q.Quu[a][c] + acc;
      q.QuuR[a][c] = (q.QuuR[a][c] + acc) + (a == c ? mu : S(0));
    }
  }
}

// Cholesky with the per-lane PD probe (_chol_unrolled with ``fail``): a
// pivot <= 0 or non-finite sets ``fail``; the sqrt is clamped at 1e-30 so
// the factor stays finite, and a NaN pivot stays NaN.
template <typename S, int M>
__device__ __forceinline__ void chol_probe(const S (&A)[M][M], S (&L)[M][M],
                                           bool& fail) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < a; ++c) acc += L[a][c] * L[a][c];
    const S s = A[a][a] - acc;
    if (!(s > S(0)) || !dfinite(s)) fail = true;
    const S sc = (s != s) ? s : (s > S(1e-30) ? s : S(1e-30));
    const S La = dsqrt(sc);
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

// Forward and back substitution with L L^T: x = (L L^T)^-1 rhs.
template <typename S, int M>
__device__ __forceinline__ void chol_solve(const S (&L)[M][M],
                                           const S (&rhs)[M], S (&x)[M]) {
  S y[M];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < a; ++c) acc += L[a][c] * y[c];
    y[a] = (rhs[a] - acc) / L[a][a];
  }
#pragma unroll
  for (int a = M - 1; a >= 0; --a) {
    S acc = 0;
#pragma unroll
    for (int r = a + 1; r < M; ++r) acc += L[r][a] * x[r];
    x[a] = (y[a] - acc) / L[a][a];
  }
}

// K1's gains: the Cholesky of QuuR with the PD probe, then
// k = -QuuR^-1 Qu and column i of K = -QuuR^-1 QuxR[:, i].
template <typename S, int N, int M>
__device__ __forceinline__ void chol_gains(const QBlocks<S, N, M>& q,
                                           bool& fail, S (&kv)[M],
                                           S (&Kt)[M][N]) {
  S L[M][M];
  chol_probe<S, M>(q.QuuR, L, fail);
#pragma unroll
  for (int col = 0; col <= N; ++col) {
    S rhs[M], xs[M];
#pragma unroll
    for (int a = 0; a < M; ++a) rhs[a] = (col == N) ? q.Qu[a] : q.QuxR[a][col];
    chol_solve<S, M>(L, rhs, xs);
#pragma unroll
    for (int a = 0; a < M; ++a) {
      if (col == N) kv[a] = -xs[a];
      else Kt[a][col] = -xs[a];
    }
  }
}

// Expected improvement (unregularized Q terms) and the value update
// V' = Qxx + K^T Quu K + K^T Qux + Qux^T K (upper triangle, mirrored),
// v' = Qx + K^T Quu k + K^T Qu + Qux^T k.
template <typename S, int N, int M>
__device__ __forceinline__ void value_update(const QBlocks<S, N, M>& q,
                                             const S (&kv)[M],
                                             const S (&Kt)[M][N],
                                             S (&V)[N][N], S (&v)[N],
                                             S& dV1, S& dV2) {
  {
    S acc = 0;
#pragma unroll
    for (int a = 0; a < M; ++a) acc += kv[a] * q.Qu[a];
    dV1 = dV1 + acc;
    S acc2 = 0;
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = 0; c < M; ++c) acc2 += kv[a] * q.Quu[a][c] * kv[c];
    dV2 = dV2 + S(0.5) * acc2;
  }

  S Quu_k[M], Quu_K[M][N];
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < M; ++c) acc += q.Quu[a][c] * kv[c];
    Quu_k[a] = acc;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      S acc2 = 0;
#pragma unroll
      for (int c = 0; c < M; ++c) acc2 += q.Quu[a][c] * Kt[c][j];
      Quu_K[a][j] = acc2;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        s1 += Kt[a][i] * Quu_K[a][j];
        s2 += Kt[a][i] * q.Qux[a][j];
        s3 += q.Qux[a][i] * Kt[a][j];
      }
      const S val = ((q.Qxx[i][j] + s1) + s2) + s3;
      V[i][j] = val;
      V[j][i] = val;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      s1 += Kt[a][i] * Quu_k[a];
      s2 += Kt[a][i] * q.Qu[a];
      s3 += q.Qux[a][i] * kv[a];
    }
    v[i] = ((q.Qx[i] + s1) + s2) + s3;
  }
}

// Initial value function from the final cost, and the step's outputs.
template <typename S, int N>
__device__ __forceinline__ void load_final(const S* __restrict__ VT,
                                           const S* __restrict__ vT, int b,
                                           int B, S (&V)[N][N], S (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) V[i][j] = VT[(int64_t)(i * N + j) * B + b];
    v[i] = vT[(int64_t)i * B + b];
  }
}

template <typename S, int N, int M>
__device__ __forceinline__ void store_gains(S* __restrict__ K_out,
                                            S* __restrict__ k_out, int t,
                                            int b, int B, const S (&kv)[M],
                                            const S (&Kt)[M][N]) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    k_out[at(t, a, M, b, B)] = kv[a];
#pragma unroll
    for (int i = 0; i < N; ++i) K_out[at(t, a * N + i, M * N, b, B)] = Kt[a][i];
  }
}

}  // namespace tfmpc
