// One Riccati timestep of one scenario on its group of G lanes, shared by
// K1, K4, K6a and K6b (riccati_kernel.cuh): the Q blocks, the full-DDP
// terms, the small Cholesky factorizations and solves, and the value update.
//
// Lane l of a group owns the state indices j = l, l + G, ... < N and the
// control indices c = l, l + G, ... < M. It computes the column j (or c) of
// every product whose right-hand factor it indexes: W = V f_x and its
// regularized twin, Qxx, Qux and QuxR, and the gains K[:, j]; Wu, WRu, Quu
// and QuuR for c. Each such column needs only the step's inputs (staged in
// shared memory, readable by every lane) and the carried value function,
// so the Q blocks need no exchange at all. The blocks a lane needs whole
// (V, v, Quu, QuuR, Qu, and K and Qux for the value update) go through the
// scenario's workspace in shared memory, each column written by its owner
// and read after a barrier over the group; a lane also parks its columns
// of Qxx and QuxR there across the gains. Blocks held whole in registers
// by every lane would not fit 255 registers at n = 6 in double.
// The Cholesky factors, the boxQP and k are computed by every lane of the
// group alike (the same inputs, the same instructions, so the same bits),
// except the boxQP's line search, whose candidates are spread over the
// lanes (boxqp.cuh). With G = 1 one lane owns every index: one thread per
// scenario, in the same code.
//
// Every sum keeps the order of tfmpc_tpu/ops/riccati_pallas.py::
// _riccati_step_math (and _chol_unrolled, _chol_solve_unrolled): each
// column is computed whole by one lane, summing over its index in order.
#pragma once

#include "warp.cuh"

namespace tfmpc {

// A scenario's G lanes: consecutive lanes of one warp, G a power of two.
template <int G>
struct Group {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "G in {1, 2, 4, 8}");
  static constexpr unsigned kBits = (1u << G) - 1u;
  int lane;       // 0 .. G-1
  int shift;      // the group's first lane within the warp
  unsigned mask;  // the group's lanes within the warp

  __device__ explicit Group(int tid)
      : lane(tid % G), shift((tid & 31) & ~(G - 1)), mask(kBits << shift) {}
  // orders the group's shared-memory writes before its reads
  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) __syncwarp(mask);
  }
  // bit l set where lane l's ``pred`` holds
  __device__ __forceinline__ unsigned ballot(bool pred) const {
    if constexpr (G == 1) return pred ? 1u : 0u;
    else return (__ballot_sync(mask, pred) >> shift) & kBits;
  }
};

// Per-step inputs in the staged order (the JAX kernel's input order):
// entry offsets of each block, and their total.
template <int N, int M, typename Var>
struct Entries {
  static constexpr int fx = 0, fu = fx + N * N, lx = fu + N * M,
                       lu = lx + N, lxx = lu + M, luu = lxx + N * N,
                       lux = luu + M * M, ubar = lux + M * N,
                       fxx = ubar + (Var::kBox ? M : 0),
                       fux = fxx + (Var::kDdp ? N * N * N : 0),
                       fuu = fux + (Var::kDdp ? N * M * N : 0),
                       total = fuu + (Var::kDdp ? N * M * M : 0);
};

// A scenario's workspace: the value function carried from step to step,
// the blocks its lanes exchange, and the blocks a lane parks there between
// the Q blocks and the value update (its columns of Qxx, Qux, QuxR), which
// would otherwise stay live in registers across the gains. Matrices
// row-major, K and the Qux blocks as [a][i]; the control box lo, hi, and
// the step's box shifted by the nominal control, lo_t, hi_t.
template <int N, int M>
struct Workspace {
  static constexpr int V = 0, v = V + N * N, Quu = v + N, H = Quu + M * M,
                       Qu = H + M * M, K = Qu + M, Qux = K + M * N,
                       Quuk = Qux + M * N, Qxx = Quuk + M,
                       QuxR = Qxx + N * N, lo = QuxR + M * N, hi = lo + M,
                       lo_t = hi + M, hi_t = lo_t + M, size = hi_t + M,
                       stride = size | 1;  // odd: scenarios on other banks
};

constexpr int kStages = 3;  // stage buffers (riccati_kernel.cuh)

// The dynamic shared bytes of a block of ``spb`` scenarios: the staged
// inputs of kStages steps ([kStages][entries][spb | 1], the scenarios of
// an entry side by side, as they lie in [T, entries, B]) and ``spb``
// workspaces. ops/riccati.py lane_smem_bytes computes the same sum.
inline long long lane_smem_bytes(bool box, bool ddp, int itemsize, int n,
                                 int m, int spb) {
  const long long entries = n * n + n * m + n + m + n * n + m * m + m * n +
                            (box ? m : 0) +
                            (ddp ? n * n * n + n * m * n + n * m * m : 0);
  const long long ws =
      (2 * n * n + n + 2 * m * m + 3 * m * n + 6 * m) | 1;
  return (kStages * entries * (spb | 1) + spb * ws) * itemsize;
}

// Cholesky with the per-lane PD probe (_chol_unrolled with ``fail``) of the
// matrix A(r, c) (only r >= c is read): a pivot <= 0 or non-finite sets
// ``fail``; the sqrt is clamped at 1e-30 so the factor stays finite, and a
// NaN pivot stays NaN.
template <typename S, int M, typename A>
__device__ __forceinline__ void chol_probe(A a_at, S (&L)[M][M], bool& fail) {
#pragma unroll
  for (int a = 0; a < M; ++a) {
    S acc = 0;
#pragma unroll
    for (int c = 0; c < a; ++c) acc += L[a][c] * L[a][c];
    const S s = a_at(a, a) - acc;
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
      L[r][a] = (a_at(r, a) - acc2) * inv;
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

// A step's staged inputs as one scenario sees them: entry e at in[e * st].
template <typename S>
struct Staged {
  const S* in;
  int st;
  __device__ __forceinline__ S operator()(int e) const { return in[e * st]; }
};

// The columns a lane owns: state index j = lane + G r (r < RX), control
// index c = lane + G r (r < RU); an index past N (M) is owned by no lane.
template <int N, int M, int G>
struct Owned {
  static constexpr int RX = (N + G - 1) / G, RU = (M + G - 1) / G;
};

// A lane's columns of the Q blocks: Qxx[r][i] = Qxx[i][j],
// Qux[r][a] = Qux[a][j] (and the regularized QuxR), Qx[r] = Qx[j] for its
// state index j = lane + G r; Quu[r][a] = Quu[a][c], QuuR likewise, and
// Qu[r] = Qu[c] for its control index c. QuuR, QuxR are with V + mu I.
template <typename S, int N, int M, int G>
struct LaneQ {
  static constexpr int RX = Owned<N, M, G>::RX, RU = Owned<N, M, G>::RU;
  S Qx[RX], Qxx[RX][N], Qux[RX][M], QuxR[RX][M];
  S Qu[RU], Quu[RU][M], QuuR[RU][M];
};

// The lane's columns of the Q blocks at one step from the staged inputs and
// the carried value function (V, v) of the workspace, with VR = V + mu I:
//   W = V f_x, WRx = VR f_x, Wu = V f_u, WRu = VR f_u (own columns),
//   Q_x = l_x + f_x^T v, Q_u = l_u + f_u^T v,
//   Qxx = l_xx + f_x^T W, Quu(R) = l_uu + f_u^T W(R)u, Qux(R) = l_ux +
//   f_u^T W(Rx).
template <typename S, int N, int M, int G, typename Var>
__device__ __forceinline__ void q_blocks(const Staged<S>& X,
                                         const S* __restrict__ ws, int lane,
                                         const S (&v)[N], S mu,
                                         LaneQ<S, N, M, G>& q) {
  using E = Entries<N, M, Var>;
  using Ws = Workspace<N, M>;
  constexpr int RX = Owned<N, M, G>::RX, RU = Owned<N, M, G>::RU;
  S Fx[RX][N], Fu[RU][N];  // own columns of f_x and f_u
#pragma unroll
  for (int r = 0; r < RX; ++r) {
    const int j = lane + G * r;
#pragma unroll
    for (int p = 0; p < N; ++p) Fx[r][p] = j < N ? X(E::fx + p * N + j) : S(0);
  }
#pragma unroll
  for (int r = 0; r < RU; ++r) {
    const int c = lane + G * r;
#pragma unroll
    for (int p = 0; p < N; ++p) Fu[r][p] = c < M ? X(E::fu + p * M + c) : S(0);
  }

  S W[RX][N], WRx[RX][N], Wu[RU][N], WRu[RU][N];  // [r][p]: row p, own column
#pragma unroll
  for (int p = 0; p < N; ++p) {
    S Vp[N];
#pragma unroll
    for (int r = 0; r < N; ++r) Vp[r] = ws[Ws::V + p * N + r];
#pragma unroll
    for (int o = 0; o < RX; ++o) {
      S w = 0, wr = 0;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        w += Vp[r] * Fx[o][r];
        wr += (Vp[r] + (p == r ? mu : S(0))) * Fx[o][r];
      }
      W[o][p] = w;
      WRx[o][p] = wr;
    }
#pragma unroll
    for (int o = 0; o < RU; ++o) {
      S w = 0, wr = 0;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        w += Vp[r] * Fu[o][r];
        wr += (Vp[r] + (p == r ? mu : S(0))) * Fu[o][r];
      }
      Wu[o][p] = w;
      WRu[o][p] = wr;
    }
  }

#pragma unroll
  for (int o = 0; o < RX; ++o) {
    const int j = lane + G * o;
    const bool own = j < N;
    S acc = 0;
#pragma unroll
    for (int p = 0; p < N; ++p) acc += Fx[o][p] * v[p];
    q.Qx[o] = (own ? X(E::lx + j) : S(0)) + acc;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S s = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) s += X(E::fx + p * N + i) * W[o][p];
      q.Qxx[o][i] = (own ? X(E::lxx + i * N + j) : S(0)) + s;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S s = 0, sR = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const S fpa = X(E::fu + p * M + a);
        s += fpa * W[o][p];
        sR += fpa * WRx[o][p];
      }
      const S l = own ? X(E::lux + a * N + j) : S(0);
      q.Qux[o][a] = l + s;
      q.QuxR[o][a] = l + sR;
    }
  }
#pragma unroll
  for (int o = 0; o < RU; ++o) {
    const int c = lane + G * o;
    const bool own = c < M;
    S acc = 0;
#pragma unroll
    for (int p = 0; p < N; ++p) acc += Fu[o][p] * v[p];
    q.Qu[o] = (own ? X(E::lu + c) : S(0)) + acc;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S s = 0, sR = 0;
#pragma unroll
      for (int p = 0; p < N; ++p) {
        const S fpa = X(E::fu + p * M + a);
        s += fpa * Wu[o][p];
        sR += fpa * WRu[o][p];
      }
      const S l = own ? X(E::luu + a * M + c) : S(0);
      q.Quu[o][a] = l + s;
      q.QuuR[o][a] = l + sR;
    }
  }
}

// The full-DDP terms (the sec branch of _riccati_step_math) on the lane's
// columns: the dynamics Hessians contracted with the value gradient v,
//   t_xx[i][j] = sum_p v[p] fxx[p][i][j], t_ux[a][i], t_uu[a][c] alike,
// added to Qxx, Qux, Quu and to QuxR, and QuuR = (QuuR + t_uu) + mu I_m
// (the combined regularization, in the JAX order of additions). The
// Hessians are staged with the step's other inputs (entry (p*N + i)*N + j
// etc.); each sum is folded into its Q block at once.
template <typename S, int N, int M, int G, typename Var>
__device__ __forceinline__ void ddp_terms(const Staged<S>& X, int lane,
                                          const S (&v)[N], S mu,
                                          LaneQ<S, N, M, G>& q) {
  using E = Entries<N, M, Var>;
  constexpr int RX = Owned<N, M, G>::RX, RU = Owned<N, M, G>::RU;
#pragma unroll
  for (int o = 0; o < RX; ++o) {
    const int j = lane + G * o;
    if (j >= N) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * X(E::fxx + (p * N + i) * N + j);
      q.Qxx[o][i] = q.Qxx[o][i] + acc;
    }
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * X(E::fux + (p * M + a) * N + j);
      q.Qux[o][a] = q.Qux[o][a] + acc;
      q.QuxR[o][a] = q.QuxR[o][a] + acc;
    }
  }
#pragma unroll
  for (int o = 0; o < RU; ++o) {
    const int c = lane + G * o;
    if (c >= M) continue;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int p = 0; p < N; ++p)
        acc += v[p] * X(E::fuu + (p * M + a) * M + c);
      q.Quu[o][a] = q.Quu[o][a] + acc;
      q.QuuR[o][a] = (q.QuuR[o][a] + acc) + (a == c ? mu : S(0));
    }
  }
}

// Each lane writes its columns of Quu, QuuR (H of the boxQP) and its Qu
// entries to the workspace, and parks its columns of Qxx, Qux and QuxR
// there; the group's barrier follows.
template <typename S, int N, int M, int G>
__device__ __forceinline__ void publish_q(const LaneQ<S, N, M, G>& q,
                                          int lane, S* __restrict__ ws) {
  using Ws = Workspace<N, M>;
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    const int j = lane + G * o;
    if (j >= N) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) ws[Ws::Qxx + i * N + j] = q.Qxx[o][i];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      ws[Ws::Qux + a * N + j] = q.Qux[o][a];
      ws[Ws::QuxR + a * N + j] = q.QuxR[o][a];
    }
  }
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RU; ++o) {
    const int c = lane + G * o;
    if (c >= M) continue;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      ws[Ws::Quu + a * M + c] = q.Quu[o][a];
      ws[Ws::H + a * M + c] = q.QuuR[o][a];
    }
    ws[Ws::Qu + c] = q.Qu[o];
  }
}

// The lane's column j of QuxR from the workspace, masked by ``keep`` (all
// rows, or the boxQP's free set); zero for an index past N.
template <typename S, int N, int M>
__device__ __forceinline__ void quxr_column(const S* __restrict__ ws, int j,
                                            const bool (&keep)[M],
                                            S (&rhs)[M]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
    rhs[a] = (j < N && keep[a]) ? ws[Workspace<N, M>::QuxR + a * N + j]
                                : S(0);
}

// K1's gains: the Cholesky of QuuR with the PD probe, then
// k = -QuuR^-1 Qu (every lane) and K[:, j] = -QuuR^-1 QuxR[:, j] (own j).
template <typename S, int N, int M, int G>
__device__ __forceinline__ void chol_gains(int lane,
                                           const S* __restrict__ ws,
                                           bool& fail, S (&kv)[M],
                                           S (&Kt)[Owned<N, M, G>::RX][M]) {
  using Ws = Workspace<N, M>;
  S L[M][M];
  chol_probe<S, M>([&](int r, int c) { return ws[Ws::H + r * M + c]; }, L,
                   fail);
  S qu[M], xs[M];
#pragma unroll
  for (int a = 0; a < M; ++a) qu[a] = ws[Ws::Qu + a];
  chol_solve<S, M>(L, qu, xs);
#pragma unroll
  for (int a = 0; a < M; ++a) kv[a] = -xs[a];
#pragma unroll
  bool all[M];
#pragma unroll
  for (int a = 0; a < M; ++a) all[a] = true;
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    S rhs[M];
    quxr_column<S, N, M>(ws, lane + G * o, all, rhs);
    chol_solve<S, M>(L, rhs, xs);
#pragma unroll
    for (int a = 0; a < M; ++a) Kt[o][a] = -xs[a];
  }
}

// Each lane writes its columns of K and its entries of Quu_k = Quu k (the
// row of Quu from the workspace) for the value update; the group's barrier
// follows.
template <typename S, int N, int M, int G>
__device__ __forceinline__ void publish_gains(
    const S (&kv)[M], const S (&Kt)[Owned<N, M, G>::RX][M], int lane,
    S* __restrict__ ws) {
  using Ws = Workspace<N, M>;
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    const int j = lane + G * o;
    if (j >= N) continue;
#pragma unroll
    for (int a = 0; a < M; ++a) ws[Ws::K + a * N + j] = Kt[o][a];
  }
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RU; ++o) {
    const int c = lane + G * o;
    if (c >= M) continue;
    S acc = 0;
#pragma unroll
    for (int cc = 0; cc < M; ++cc) acc += ws[Ws::Quu + c * M + cc] * kv[cc];
    ws[Ws::Quuk + c] = acc;
  }
}

// Expected improvement (unregularized Q terms; lane 0 keeps the sums) and
// the value update on the lane's columns, written to the workspace for the
// next step:
// V' = Qxx + K^T Quu K + K^T Qux + Qux^T K (upper triangle, mirrored),
// v' = Qx + K^T Quu k + K^T Qu + Qux^T k.
template <typename S, int N, int M, int G>
__device__ __forceinline__ void value_update(
    const S (&Qx)[Owned<N, M, G>::RX], const S (&kv)[M],
    const S (&Kt)[Owned<N, M, G>::RX][M], int lane, S* __restrict__ ws,
    S& dV1, S& dV2) {
  using Ws = Workspace<N, M>;
  const S* qu = ws + Ws::Qu;
  if (lane == 0) {
    S acc = 0;
#pragma unroll
    for (int a = 0; a < M; ++a) acc += kv[a] * qu[a];
    dV1 = dV1 + acc;
    S acc2 = 0;
#pragma unroll
    for (int a = 0; a < M; ++a)
#pragma unroll
      for (int c = 0; c < M; ++c)
        acc2 += kv[a] * ws[Ws::Quu + a * M + c] * kv[c];
    dV2 = dV2 + S(0.5) * acc2;
  }

#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    const int j = lane + G * o;
    if (j >= N) continue;
    S QuuK[M];  // (Quu K)[:, j]
#pragma unroll
    for (int a = 0; a < M; ++a) {
      S acc = 0;
#pragma unroll
      for (int c = 0; c < M; ++c) acc += ws[Ws::Quu + a * M + c] * Kt[o][c];
      QuuK[a] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i > j) continue;
      S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int a = 0; a < M; ++a) {
        const S Kai = ws[Ws::K + a * N + i];
        s1 += Kai * QuuK[a];
        s2 += Kai * ws[Ws::Qux + a * N + j];
        s3 += ws[Ws::Qux + a * N + i] * Kt[o][a];
      }
      const S val = ((ws[Ws::Qxx + i * N + j] + s1) + s2) + s3;
      ws[Ws::V + i * N + j] = val;
      ws[Ws::V + j * N + i] = val;
    }
    S s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
    for (int a = 0; a < M; ++a) {
      s1 += Kt[o][a] * ws[Ws::Quuk + a];
      s2 += Kt[o][a] * qu[a];
      s3 += ws[Ws::Qux + a * N + j] * kv[a];
    }
    ws[Ws::v + j] = ((Qx[o] + s1) + s2) + s3;
  }
}

// The step's gains to the [T, entries, B] outputs: each lane its columns of
// K and its entries of k.
template <typename S, int N, int M, int G>
__device__ __forceinline__ void store_gains(
    S* __restrict__ K_out, S* __restrict__ k_out, int t, int b, int B,
    int lane, const S (&kv)[M], const S (&Kt)[Owned<N, M, G>::RX][M]) {
#pragma unroll
  for (int o = 0; o < Owned<N, M, G>::RX; ++o) {
    const int j = lane + G * o;
    if (j >= N) continue;
#pragma unroll
    for (int a = 0; a < M; ++a)
      K_out[at(t, a * N + j, M * N, b, B)] = Kt[o][a];
  }
#pragma unroll
  for (int a = 0; a < M; ++a)
    if (a % G == lane) k_out[at(t, a, M, b, B)] = kv[a];
}

// The value function of the final cost and the control box (zero without
// one) into the workspace, each lane its share of the entries.
template <typename S, int N, int M, int G>
__device__ __forceinline__ void load_final(const S* __restrict__ VT,
                                           const S* __restrict__ vT,
                                           const S* __restrict__ lo,
                                           const S* __restrict__ hi, int b,
                                           int B, int lane,
                                           S* __restrict__ ws) {
  using Ws = Workspace<N, M>;
  for (int a = lane; a < M; a += G) {
    ws[Ws::lo + a] = lo != nullptr ? lo[a] : S(0);
    ws[Ws::hi + a] = hi != nullptr ? hi[a] : S(0);
  }
  for (int e = lane; e < N * N; e += G)
    ws[Ws::V + e] = VT[static_cast<int64_t>(e) * B + b];
  for (int i = lane; i < N; i += G)
    ws[Ws::v + i] = vT[static_cast<int64_t>(i) * B + b];
}

}  // namespace tfmpc
