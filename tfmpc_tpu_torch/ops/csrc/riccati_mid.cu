// K7: the batched regularized Riccati backward pass at mid dims (any
// 1 <= n, m <= 48, n != m allowed), plain iLQR and control-limited (boxQP)
// variants, float32 and float64.
//
// Replaces: tfmpc_tpu/ops/riccati_mid_pallas.py:_riccati_mid_raw (adapters
// riccati_backward_mid and riccati_backward_mid_boxqp; body _mid_kernel /
// _mid_step, with _matmul_rows, _chol_rows, _chol_solve_rows and
// _boxqp_rows).
//
// Per scenario and step t = T-1 .. 0, as _mid_step: W = V f_x, W_u = V f_u;
// Q_x, Q_u, Q_xx, Q_uu, Q_ux and the regularized QuuR, QuxR (V + mu I); the
// PD probe, a Cholesky of QuuR with a per-lane fail flag, in both variants;
// the gains (iLQR: k = -QuuR^-1 Q_u, K = -QuuR^-1 QuxR; boxQP: k the
// projected-Newton minimizer of (QuuR, Q_u) within [lo - ubar_t, hi -
// ubar_t], K rows through the final masked free system, clamped rows 0);
// dV1/dV2 from the UNregularized Q_u, Q_uu; V' = Q_xx + K^T Q_uu K +
// K^T Q_ux + Q_ux^T K, symmetrized, and v'. Every Cholesky clamps its pivot
// at 1e-30 (_chol_rows), the boxQP's Newton systems too: that differs from
// the plain version (which lets NaN propagate there) only on lanes whose PD
// probe already failed. The boxQP constants are ops/boxqp.py's: gradient
// tolerance 1e-8, alphas 2^-i for i < 8, first candidate that improves the
// objective by more than 1e-12, a problem that converged or found nothing
// frozen; boxqp_iters Newton iterations (runtime).
//
// What bounds it on this card: at HVAC-16 (B = 512, T = 50, n = m = 16,
// f32) a step reads ~1,330 values per scenario and writes 272 (~164 MB over
// the backward, ~0.05 ms at 3.35 TB/s) and does ~1.5e5 operations with the
// boxQP (~3.8 GFLOP, ~0.06 ms at 67 TFLOP/s): operations, barely. But each
// scenario's T steps are a serial chain, and inside a step the Cholesky
// and the triangular solves are chains of m dependent column steps, so
// the kernel is bound by that chain's latency far above both.
//
// Precision: the block computes in double for both dtypes (its shared
// arrays are double; float32 inputs are widened as they are read and the
// outputs rounded once). The boxQP backward is ill-conditioned in float32
// (a rounding change flips free sets: the float32 plain version is more
// than 1e-3 + 1e-3 |k| from its own float64 result on 23% of HVAC-12's
// lanes on an H100, and a float32 K7 landed 1.3 points below it), so K7
// stays as accurate as its float64 self on float32 inputs; the chain is
// bound by barriers and latency, not by the double rate.
//
// What the design does about it, simple and right first: one thread block
// per scenario (no lane padding: any B, the ragged sub-batches of the
// compacted restarts too), 128 or 256 threads taking the entries of each
// small product, the trailing update of each right-looking Cholesky column
// and the right-hand sides of each substitution row; __syncthreads between
// the dependent phases. The value function, the staged f_x and f_u, W, the
// Q blocks, the factor, the gains and the boxQP's vectors live in dynamic
// shared memory across the T loop; l_x, l_u, l_xx, l_uu, l_ux and ubar are
// read once, where they are used. Layout: the solver's own [B, T, ...]
// (scenario-major), not the lane kernels' [T, entries, B]: a block reads
// its scenario's contiguous n*n entries with neighbouring threads on
// neighbouring addresses, so the loads are coalesced with no permute in
// the wrapper, and K [B, T, m, n], k [B, T, m] come out in the solver's
// layout too.
//
// Shared memory, in doubles (mid_smem_elems below): 4 n^2
// (V, f_x then the unsymmetrized V', W, Q_xx) + 4 n m (f_u then Q_uu K,
// W_u, Q_ux, QuxR then K) + 3 m^2 (Q_uu, QuuR, the factor) + 2 n + 27 m +
// 16 (v, Q_x; Q_u, 1/diag, k, Q_uu k, the boxQP's x, gradient, step, box,
// free set, 8 candidates and their H x). At n = m = 48 that is 214,016
// bytes, under the 232,448 a block may have; at HVAC-16 26,368. Above 48 KB
// the launch raises the kernel's dynamic limit first.
#include "common.cuh"

namespace tfmpc {
namespace {

constexpr int kMidMaxDim = 48;       // ops/riccati_mid.py MID_DIM_MAX
constexpr int kMidAlphas = 8;        // ops/boxqp.py LS_ALPHAS
constexpr size_t kMaxSmemBytes = 232448;

#define TFMPC_FOR_TID(e, count) \
  for (int e = threadIdx.x; e < (count); e += blockDim.x)

size_t mid_smem_elems(int n, int m) {
  return 4 * static_cast<size_t>(n) * n + 4 * static_cast<size_t>(n) * m +
         3 * static_cast<size_t>(m) * m + 2 * static_cast<size_t>(n) +
         27 * static_cast<size_t>(m) + 16;
}

// The block's shared arrays (row-major matrices).
template <typename S>
struct MidSmem {
  S *V, *v, *Fx, *W, *Qxx;          // [n n] (Fx later the unsymmetrized V')
  S *Fu, *Wu, *Qux, *QuxR;          // [n m] / [m n] (Fu later Q_uu K,
                                    // QuxR later K)
  S *Quu, *QuuR, *L;                // [m m]
  S *Qx, *Qu, *invd, *k, *Quu_k;    // vectors
  S *x, *gm, *lo, *hi, *fr, *cand, *Hc, *obj;  // boxQP
};

template <typename S>
__device__ MidSmem<S> carve(S* p, int n, int m) {
  MidSmem<S> s;
  auto take = [&p](int count) { S* q = p; p += count; return q; };
  s.V = take(n * n);
  s.Fx = take(n * n);
  s.W = take(n * n);
  s.Qxx = take(n * n);
  s.Fu = take(n * m);
  s.Wu = take(n * m);
  s.Qux = take(m * n);
  s.QuxR = take(m * n);
  s.Quu = take(m * m);
  s.QuuR = take(m * m);
  s.L = take(m * m);
  s.v = take(n);
  s.Qx = take(n);
  s.Qu = take(m);
  s.invd = take(m);
  s.k = take(m);
  s.Quu_k = take(m);
  s.x = take(m);
  s.gm = take(m);
  s.lo = take(m);
  s.hi = take(m);
  s.fr = take(m);
  s.cand = take((kMidAlphas + 1) * m);  // 8 candidates, then x
  s.Hc = take((kMidAlphas + 1) * m);
  s.obj = take(kMidAlphas + 1);
  return s;
}

// Right-looking block Cholesky of the m x m matrix A, in place: on return
// column c below the diagonal holds the factor's column before its scaling,
// L[r][c] = A[r][c] * invd[c], and L[c][c] = 1 / invd[c]. A pivot <= 0 or
// non-finite sets ``fail``; sqrt(max(s, 1e-30)) keeps the factor finite,
// and a NaN pivot stays NaN (_chol_rows). Only the lower triangle is
// updated and read. Every thread reads the same pivots, so ``fail`` is the
// same in all of them.
template <typename S>
__device__ void chol_block(S* A, S* invd, int m, bool& fail) {
  for (int a = 0; a < m; ++a) {
    const S s = A[a * m + a];
    if (!(s > S(0)) || !dfinite(s)) fail = true;
    const S sc = (s != s) ? s : (s > S(1e-30) ? s : S(1e-30));
    const S inv = S(1) / dsqrt(sc);
    if (threadIdx.x == 0) invd[a] = inv;
    const int r0 = a + 1, w = m - r0;
    TFMPC_FOR_TID(e, w * w) {
      const int r = r0 + e / w, c = r0 + e % w;
      if (c <= r) A[r * m + c] -= (A[r * m + a] * inv) * (A[c * m + a] * inv);
    }
    __syncthreads();
  }
}

// Column j of the right-hand sides: X [m, R] row-major, then y [m] as
// column R when given.
template <typename S>
__device__ __forceinline__ S& rhs_at(S* X, S* y, int R, int a, int j) {
  return j < R ? X[a * R + j] : y[a];
}

// Solve (L L^T) Z = RHS in place for the factor of chol_block, all right-
// hand sides of a row at once (forward, then back substitution, right-
// looking); Z is multiplied by -1 when ``neg`` (the gains' sign).
template <typename S>
__device__ void chol_solve_block(const S* A, const S* invd, int m, S* X,
                                 S* y, int R, bool neg) {
  const int C = R + (y != nullptr ? 1 : 0);
  for (int k = 0; k + 1 < m; ++k) {
    const S ik = invd[k];
    const int w = m - k - 1;
    TFMPC_FOR_TID(e, w * C) {
      const int r = k + 1 + e / C, j = e % C;
      rhs_at(X, y, R, r, j) -=
          (A[r * m + k] * ik) * (rhs_at(X, y, R, k, j) * ik);
    }
    __syncthreads();
  }
  TFMPC_FOR_TID(e, m * C) {
    const int a = e / C, j = e % C;
    rhs_at(X, y, R, a, j) *= invd[a];
  }
  __syncthreads();
  for (int a = m - 1; a > 0; --a) {
    const S ia = invd[a];
    TFMPC_FOR_TID(e, a * C) {
      const int r = e / C, j = e % C;
      rhs_at(X, y, R, r, j) -=
          (A[a * m + r] * invd[r]) * (rhs_at(X, y, R, a, j) * ia);
    }
    __syncthreads();
  }
  TFMPC_FOR_TID(e, m * C) {
    const int a = e / C, j = e % C;
    rhs_at(X, y, R, a, j) *= neg ? -invd[a] : invd[a];
  }
  __syncthreads();
}

// g = q + H x at the block's x, the free set (1/0) and the free gradient.
template <typename S>
__device__ void gradient_free_block(const MidSmem<S>& s, int m) {
  TFMPC_FOR_TID(a, m) {
    S acc = 0;
    for (int c = 0; c < m; ++c) acc += s.QuuR[a * m + c] * s.x[c];
    const S g = s.Qu[a] + acc;
    const bool free = !((s.x[a] <= s.lo[a] && g > S(0)) ||
                        (s.x[a] >= s.hi[a] && g < S(0)));
    s.fr[a] = free ? S(1) : S(0);
    s.gm[a] = free ? g : S(0);
  }
  __syncthreads();
}

// The masked free system into L: QuuR on free x free, 1 on the clamped
// diagonal.
template <typename S>
__device__ void masked_system_block(const MidSmem<S>& s, int m) {
  TFMPC_FOR_TID(e, m * m) {
    const int a = e / m, c = e % m;
    s.L[e] = (s.fr[a] != S(0) && s.fr[c] != S(0))
                 ? s.QuuR[e]
                 : (a == c ? S(1) : S(0));
  }
}

// Projected-Newton boxQP on (QuuR, Q_u) within [lo, hi] (_boxqp_rows, ops/
// boxqp.py); leaves the minimizer in s.x. Every decision is taken on
// shared values that all threads read alike, so the breaks are uniform.
template <typename S>
__device__ void boxqp_block(const MidSmem<S>& s, int m, int iters) {
  TFMPC_FOR_TID(a, m) s.x[a] = clip(S(0), s.lo[a], s.hi[a]);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    gradient_free_block(s, m);
    S gfree2 = 0;
    int nfree = 0;
    for (int a = 0; a < m; ++a) {
      gfree2 += s.gm[a] * s.gm[a];
      nfree += s.fr[a] != S(0) ? 1 : 0;
    }
    if (gfree2 < S(1e-16) || nfree == 0) break;  // converged: x stays

    masked_system_block(s, m);
    __syncthreads();
    bool unused = false;  // the Newton systems' probe is not a lane failure
    chol_block(s.L, s.invd, m, unused);
    // the Newton step d = -(H_ff)^-1 g_free, in place in gm
    chol_solve_block(s.L, s.invd, m, static_cast<S*>(nullptr), s.gm, 0,
                     true);

    // candidates clip(x + 2^-i d), i < 8, and x itself in slot 8; their
    // objectives 1/2 c^T H c + q^T c
    TFMPC_FOR_TID(e, (kMidAlphas + 1) * m) {
      const int i = e / m, a = e % m;
      S alpha = 1;
      for (int j = 0; j < i; ++j) alpha *= S(0.5);
      s.cand[e] = i < kMidAlphas
                      ? clip(s.x[a] + alpha * s.gm[a], s.lo[a], s.hi[a])
                      : s.x[a];
    }
    __syncthreads();
    TFMPC_FOR_TID(e, (kMidAlphas + 1) * m) {
      const int i = e / m, a = e % m;
      S acc = 0;
      for (int c = 0; c < m; ++c) acc += s.QuuR[a * m + c] * s.cand[i * m + c];
      s.Hc[e] = acc;
    }
    __syncthreads();
    TFMPC_FOR_TID(i, kMidAlphas + 1) {
      S xhx = 0, qx = 0;
      for (int a = 0; a < m; ++a) xhx += s.cand[i * m + a] * s.Hc[i * m + a];
      for (int a = 0; a < m; ++a) qx += s.Qu[a] * s.cand[i * m + a];
      s.obj[i] = S(0.5) * xhx + qx;
    }
    __syncthreads();
    const S obj_now = s.obj[kMidAlphas];
    int best = -1;
    for (int i = 0; i < kMidAlphas; ++i)
      if (s.obj[i] < obj_now - S(1e-12)) {
        best = i;
        break;
      }
    if (best < 0) break;  // no improvement: x stays, frozen
    TFMPC_FOR_TID(a, m) s.x[a] = s.cand[best * m + a];
    __syncthreads();
  }
  __syncthreads();
}

// ubar, lo_in, hi_in are null unless kBox. Inputs and outputs in the
// solver's layout: fx [B, T, n, n], fu [B, T, n, m], lx [B, T, n], lu
// [B, T, m], lxx [B, T, n, n], luu [B, T, m, m], lux [B, T, m, n], mu [B],
// ubar [B, T, m], lo/hi [m], VT [B, n, n], vT [B, n]; K [B, T, m, n],
// k [B, T, m], dV1, dV2, fail [B].
template <typename S, bool kBox>
__global__ void riccati_mid_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ ubar, const S* __restrict__ lo_in,
    const S* __restrict__ hi_in, const S* __restrict__ VT,
    const S* __restrict__ vT, S* __restrict__ K_out, S* __restrict__ k_out,
    S* __restrict__ dV1_out, S* __restrict__ dV2_out,
    S* __restrict__ fail_out, int n, int m, int T, int newton_iters) {
  using C = double;  // the block's arithmetic, for both dtypes
  extern __shared__ unsigned char smem_raw[];
  const MidSmem<C> s = carve(reinterpret_cast<C*>(smem_raw), n, m);
  const int b = blockIdx.x;
  const int nn = n * n, nm = n * m, mm = m * m;

  TFMPC_FOR_TID(e, nn) s.V[e] = VT[static_cast<int64_t>(b) * nn + e];
  TFMPC_FOR_TID(i, n) s.v[i] = vT[static_cast<int64_t>(b) * n + i];
  const C mu = mu_in[b];
  C dV1 = 0, dV2 = 0;  // thread 0's
  bool fail = false;   // the same in every thread
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    // stage f_x, f_u (and the step's box)
    TFMPC_FOR_TID(e, nn) s.Fx[e] = fx[bt * nn + e];
    TFMPC_FOR_TID(e, nm) s.Fu[e] = fu[bt * nm + e];
    if (kBox) {
      TFMPC_FOR_TID(a, m) {
        const C u = ubar[bt * m + a];
        s.lo[a] = C(lo_in[a]) - u;
        s.hi[a] = C(hi_in[a]) - u;
      }
    }
    __syncthreads();

    // W = V f_x, W_u = V f_u, Q_x = l_x + f_x^T v, Q_u = l_u + f_u^T v
    TFMPC_FOR_TID(e, nn + nm + n + m) {
      if (e < nn) {
        const int p = e / n, j = e % n;
        C acc = 0;
        for (int r = 0; r < n; ++r) acc += s.V[p * n + r] * s.Fx[r * n + j];
        s.W[e] = acc;
      } else if (e < nn + nm) {
        const int f = e - nn, p = f / m, c = f % m;
        C acc = 0;
        for (int r = 0; r < n; ++r) acc += s.V[p * n + r] * s.Fu[r * m + c];
        s.Wu[f] = acc;
      } else if (e < nn + nm + n) {
        const int i = e - nn - nm;
        C acc = 0;
        for (int p = 0; p < n; ++p) acc += s.Fx[p * n + i] * s.v[p];
        s.Qx[i] = lx[bt * n + i] + acc;
      } else {
        const int a = e - nn - nm - n;
        C acc = 0;
        for (int p = 0; p < n; ++p) acc += s.Fu[p * m + a] * s.v[p];
        s.Qu[a] = lu[bt * m + a] + acc;
      }
    }
    __syncthreads();

    // Q_xx = l_xx + f_x^T W; Q_uu, QuuR = l_uu + f_u^T (W_u [+ mu f_u]) (and
    // the factor's copy); Q_ux, QuxR = l_ux + f_u^T (W [+ mu f_x]); k = Q_u
    // as the iLQR solve's right-hand side
    TFMPC_FOR_TID(e, nn + mm + nm + (kBox ? 0 : m)) {
      if (e < nn) {
        const int i = e / n, j = e % n;
        C acc = 0;
        for (int p = 0; p < n; ++p) acc += s.Fx[p * n + i] * s.W[p * n + j];
        s.Qxx[e] = lxx[bt * nn + e] + acc;
      } else if (e < nn + mm) {
        const int f = e - nn, a = f / m, c = f % m;
        C acc = 0, accR = 0;
        for (int p = 0; p < n; ++p) {
          const C fpa = s.Fu[p * m + a], wu = s.Wu[p * m + c];
          acc += fpa * wu;
          accR += fpa * (wu + mu * s.Fu[p * m + c]);
        }
        const C l = luu[bt * mm + f];
        s.Quu[f] = l + acc;
        s.QuuR[f] = l + accR;
        s.L[f] = l + accR;
      } else if (e < nn + mm + nm) {
        const int f = e - nn - mm, a = f / n, i = f % n;
        C acc = 0, accR = 0;
        for (int p = 0; p < n; ++p) {
          const C fpa = s.Fu[p * m + a], w = s.W[p * n + i];
          acc += fpa * w;
          accR += fpa * (w + mu * s.Fx[p * n + i]);
        }
        const C l = lux[bt * nm + f];
        s.Qux[f] = l + acc;
        s.QuxR[f] = l + accR;
      } else {
        const int a = e - nn - mm - nm;
        s.k[a] = s.Qu[a];
      }
    }
    __syncthreads();

    // the PD probe of QuuR (both variants), factor in L
    chol_block(s.L, s.invd, m, fail);

    if (kBox) {
      boxqp_block(s, m, newton_iters);
      // the final free set, its masked system and the K rows' right-hand
      // sides free[a] * QuxR[a][:] (clamped rows exactly 0); k = x
      gradient_free_block(s, m);
      masked_system_block(s, m);
      TFMPC_FOR_TID(e, nm) {
        if (s.fr[e / n] == C(0)) s.QuxR[e] = C(0);
      }
      TFMPC_FOR_TID(a, m) s.k[a] = s.x[a];
      __syncthreads();
      chol_block(s.L, s.invd, m, fail);
      chol_solve_block(s.L, s.invd, m, s.QuxR, static_cast<C*>(nullptr), n,
                       true);
    } else {
      // K = -QuuR^-1 QuxR and k = -QuuR^-1 Q_u, in place
      chol_solve_block(s.L, s.invd, m, s.QuxR, s.k, n, true);
    }
    const C* Kg = s.QuxR;  // the gains K [m, n]

    // Q_uu k and A1 = Q_uu K (into f_u's slot); store the gains
    C* A1 = s.Fu;
    TFMPC_FOR_TID(e, m + nm) {
      if (e < m) {
        C acc = 0;
        for (int c = 0; c < m; ++c) acc += s.Quu[e * m + c] * s.k[c];
        s.Quu_k[e] = acc;
        k_out[bt * m + e] = static_cast<S>(s.k[e]);
      } else {
        const int f = e - m, a = f / n, j = f % n;
        C acc = 0;
        for (int c = 0; c < m; ++c) acc += s.Quu[a * m + c] * Kg[c * n + j];
        A1[f] = acc;
        K_out[bt * nm + f] = static_cast<S>(Kg[f]);
      }
    }
    __syncthreads();

    // dV1, dV2 (thread 0); V' = ((Q_xx + K^T A1) + K^T Q_ux) + Q_ux^T K
    // into f_x's slot; v' = ((Q_x + K^T Q_uu k) + K^T Q_u) + Q_ux^T k
    if (threadIdx.x == 0) {
      C a1 = 0, a2 = 0;
      for (int a = 0; a < m; ++a) a1 += s.k[a] * s.Qu[a];
      for (int a = 0; a < m; ++a) a2 += s.k[a] * s.Quu_k[a];
      dV1 = dV1 + a1;
      dV2 = dV2 + C(0.5) * a2;
    }
    C* Vt = s.Fx;
    TFMPC_FOR_TID(e, nn + n) {
      if (e < nn) {
        const int i = e / n, j = e % n;
        C s1 = 0, s2 = 0, s3 = 0;
        for (int a = 0; a < m; ++a) {
          const C kai = Kg[a * n + i];
          s1 += kai * A1[a * n + j];
          s2 += kai * s.Qux[a * n + j];
          s3 += s.Qux[a * n + i] * Kg[a * n + j];
        }
        Vt[e] = ((s.Qxx[e] + s1) + s2) + s3;
      } else {
        const int i = e - nn;
        C s1 = 0, s2 = 0, s3 = 0;
        for (int a = 0; a < m; ++a) {
          const C kai = Kg[a * n + i];
          s1 += kai * s.Quu_k[a];
          s2 += kai * s.Qu[a];
          s3 += s.Qux[a * n + i] * s.k[a];
        }
        s.v[i] = ((s.Qx[i] + s1) + s2) + s3;
      }
    }
    __syncthreads();
    TFMPC_FOR_TID(e, nn) {
      const int i = e / n, j = e % n;
      s.V[e] = C(0.5) * (Vt[e] + Vt[j * n + i]);
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    dV1_out[b] = static_cast<S>(dV1);
    dV2_out[b] = static_cast<S>(dV2);
    fail_out[b] = fail ? S(1) : S(0);
  }
}

template <typename S, bool kBox>
int launch(int n, int m, int T, int B, int iters, const void* const* in,
           void* const* out, int block, cudaStream_t stream) {
  const size_t bytes = mid_smem_elems(n, m) * sizeof(double);
  if (bytes > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = riccati_mid_kernel<S, kBox>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto P = [in](int i) { return static_cast<const S*>(in[i]); };
  kernel<<<B, block, bytes, stream>>>(
      P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7), P(8), P(9), P(10),
      P(11), P(12), static_cast<S*>(out[0]), static_cast<S*>(out[1]),
      static_cast<S*>(out[2]), static_cast<S*>(out[3]),
      static_cast<S*>(out[4]), n, m, T, iters);
  return static_cast<int>(cudaGetLastError());
}

// in: fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT (ubar, lo, hi
// null for the iLQR variant); out: K, k, dV1, dV2, fail.
template <bool kBox>
int entry(int dtype, int n, int m, int T, int B, int iters,
          const void* const* in, void* const* out, int block, void* stream) {
  if (n < 1 || m < 1 || n > kMidMaxDim || m > kMidMaxDim || T < 1 ||
      iters < 0 || block < 32 || block > 1024 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBox && (in[8] == nullptr || in[9] == nullptr || in[10] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float, kBox>(n, m, T, B, iters, in, out, block, s);
  if (dtype == kFloat64)
    return launch<double, kBox>(n, m, T, B, iters, in, out, block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tfmpc

// The shared-memory bytes one block takes at (n, m) (the same for both
// dtypes: the block computes in double), so the wrapper can refuse a
// launch that would not fit.
extern "C" long long tfmpc_riccati_mid_smem_bytes(int n, int m) {
  return static_cast<long long>(tfmpc::mid_smem_elems(n, m)) *
         static_cast<long long>(sizeof(double));
}

extern "C" int tfmpc_riccati_backward_mid(
    int dtype, int n, int m, int T, int B, const void* fx, const void* fu,
    const void* lx, const void* lu, const void* lxx, const void* luu,
    const void* lux, const void* mu, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  const void* in[] = {fx,  fu,      lx,      lu,      lxx, luu, lux,
                      mu,  nullptr, nullptr, nullptr, VT,  vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::entry<false>(dtype, n, m, T, B, 0, in, out, block, stream);
}

extern "C" int tfmpc_riccati_backward_mid_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* ubar,
    const void* lo, const void* hi, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  return tfmpc::entry<true>(dtype, n, m, T, B, newton_iters, in, out, block,
                            stream);
}
