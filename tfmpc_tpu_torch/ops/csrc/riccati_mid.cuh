// K7: the batched regularized Riccati backward pass at mid dims (any
// 1 <= n, m <= 48, n != m allowed), plain iLQR and control-limited (boxQP)
// variants, float32 and float64; and its full-DDP variant (K6a at any n,
// m <= 12 outside the lane kernels' dims; K6b there runs on the small-dims
// kernel, riccati_small.cuh).
//
// Replaces: tfmpc_tpu/ops/riccati_mid_pallas.py:_riccati_mid_raw (adapters
// riccati_backward_mid and riccati_backward_mid_boxqp; body _mid_kernel /
// _mid_step, with _matmul_rows, _chol_rows, _chol_solve_rows and
// _boxqp_rows); with kDdp, tfmpc_tpu/ops/riccati_pallas.py:
// _riccati_pallas_raw's DDP terms (:306-324; adapters
// riccati_backward_ddp_pallas :545 and riccati_backward_ddp_boxqp_pallas
// :564), which the JAX package's lane kernel runs at any n, m <= 12.
//
// This header holds the kernel and its launch; riccati_mid.cu instantiates
// the iLQR and boxQP variants (and the C entries of both), and
// riccati_mid_ddp.cu the full-DDP iLQR one, so the parallel build compiles
// them side by side and the iLQR and boxQP instantiations keep their code.
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
// boxQP (~3.8 GFLOP, ~0.06 ms at 67 TFLOP/s, or ~0.11 ms at the 34 TFLOP/s
// of double outside the tensor cores): operations, barely. But each
// scenario's T steps are a serial chain, and inside a step the Cholesky
// and the triangular solves are chains of m dependent column steps (up to
// five factorizations a step at ~3 Newton iterations), so the kernel is
// bound by the latency of that chain: shared-memory loads, shuffles,
// double sqrt and division one after another, far above both bounds.
//
// What the design does about it: a TEAM of one warp (or a few, from the
// launch plan of ops/riccati_mid.py) per scenario, several scenarios per
// block, each team with its own slice of shared memory and its own
// barrier: __syncwarp for one warp, a named barrier (bar.sync 1 + slot)
// for more; no barrier spans two scenarios, so a block's tail teams of a
// ragged batch just return. The dependent chains run on the team's first
// warp with no block barrier at all:
// - the Cholesky goes column by column: lane r (and r + 32) forms its row's
//   entry as a dot product over the earlier columns of the scaled factor
//   (loads only), the pivot comes by shuffle, and the scaled factor
//   Ls = L / diag(L) goes to shared memory, so the substitutions multiply
//   by it directly; __syncwarp between columns. A right-looking factor
//   held in registers (lane a updating row a, up to m = 16) needs 255
//   registers and spills ~650 bytes in this kernel: on an H100 at
//   HVAC-16 it was 1.15x (iLQR) and 1.57x (boxQP) this kernel's time
//   (tools/kernel_versions.py), so the factor stays in shared memory;
// - the Newton step's substitutions keep the right-hand side in registers
//   (lane a holds entry a), broadcast each solved entry by shuffle, and
//   load the factor unconditionally (clamped rows, selects), so no branch
//   holds a load back;
// - the boxQP's free set is a ballot (a 64-bit mask in registers), its
//   free-gradient norm and dV are warp sums broadcast from lane 0, and the
//   nine candidates' objectives are summed one per lane in ascending order
//   and picked by a ballot, so every branch is taken alike by the warp;
// - the probe, each Newton iteration and the final set share one call of
//   the factorization, which reuses the factor it holds when asked for the
//   same free set again (bit for bit what a new one would be).
// The gains' many right-hand sides (K's n columns, and k) are solved by
// the whole team, a column per thread, each entry a dot product over the
// entries solved before it. The products (W, W_u, Q_x, Q_u, the Q blocks,
// Q_uu K, V', v') give each thread a column of up to four rows at once
// (four independent sums reading each column operand once); rows are
// padded to an odd length, so a warp reading one entry of each of 32 rows
// hits 32 banks. Each step's inputs (f_x, f_u, l_x, l_u, ubar and, where
// they fit, l_xx, l_uu, l_ux) are copied into the team's staging slot with
// cp.async (16-byte copies where aligned), issued as soon as the step
// before has read its own, so the copy of step t-1 runs under step t's
// boxQP, solves and value update. Each thread maps to its column once per
// product, not by a division per entry. The kernel may take 255 registers
// a thread (it needs ~190-245 and spills at 128), so an SM holds 8 warps:
// the plan gives a scenario fewer warps where the batch would not fit one
// wave (HVAC-16, B = 512: 2; HVAC-12, B = 1024: 1).
//
// Every sum keeps the order of _mid_step and of the block version before
// this design: each entry of each product in ascending index order, each
// factor and solve entry with the right-looking terms of _chol_rows and
// _chol_solve_rows in their order; only dV's and the free-gradient norm's
// warp sums are reduced as a tree.
//
// Precision: the team computes in double (C below) for both dtypes
// (float32 inputs are widened as they are read and the outputs rounded
// once). The boxQP backward is ill-conditioned in float32 (a rounding
// change flips free sets: the float32 plain version is more than 1e-3 +
// 1e-3 |k| from its own float64 result on 23% of HVAC-12's lanes on an
// H100), so K7 stays as accurate as its float64 self on float32 inputs.
// Float arithmetic was measured no faster at HVAC-16 (the chain is latency,
// not the double rate) and far less accurate, so it is not instantiated.
//
// Shared memory per scenario (mid_scenario_bytes below), with ln = n | 1,
// lm = m | 1: in C, 2 n ln (V, which holds Q_xx once W is formed, and W,
// which holds the unsymmetrized V') + max(n lm, m ln) (W_u, then Q_uu K)
// + 2 m ln (Q_ux, QuxR then K) + 3 m lm (Q_uu, QuuR, the scaled factor) +
// 2 n + 5 m (v, Q_x; Q_u, 1/diag, k, Q_uu k, the boxQP's x) + 18 lm (the
// nine candidates and their H c); in the input type S, the staging slot,
// n^2 + n m + n + 2 m (f_x, f_u, l_x, l_u, ubar) plus n^2 + m^2 + m n
// (l_xx, l_uu, l_ux) where the plan stages them; each part rounded up to
// 16 bytes. At HVAC-16, float32 inputs, double arithmetic: 20,752 + 5,312
// = 26,064 bytes a scenario; at n = m = 48 in float64, 160,272 + 38,016
// (l blocks read in place) = 198,288 bytes, under the 232,448 a block may
// have. Above 48 KB the launch raises the kernel's dynamic limit first.
//
// Layout: the solver's own [B, T, ...] (scenario-major), not the lane
// kernels' [T, entries, B]: a scenario's n*n entries of a step are
// contiguous, so the team's copies are coalesced with no permute in the
// wrapper, and K [B, T, m, n], k [B, T, m] come out in the solver's layout.
//
// Full DDP (kDdp, a compile-time variant: the iLQR and boxQP
// instantiations do not contain it). The dynamics Hessians of step t,
// f_xx [n, n, n], f_ux [n, m, n] and f_uu [n, m, m] (output component p
// leading), are contracted with the value gradient v of step t+1 into
// t_xx = sum_p v_p f_xx[p], t_ux and t_uu, in ascending p, and added to
// Q_xx, Q_uu, Q_ux and QuxR; the regularization is combined, QuuR =
// (l_uu + f_u^T (V + mu I) f_u + t_uu) + mu I_m (v . f_uu does not shrink
// with mu, and f_u can vanish), as _riccati_pallas_raw and the plain
// version (ops/riccati.py _backward_scan) add them; dV1, dV2 and the value
// update keep the unregularized blocks. Each Hessian value is read once,
// so they are streamed from global memory, not staged: the thread that
// owns entry (i, j) of a block sums over p, and consecutive threads read
// consecutive j (coalesced). The shared bytes are the iLQR variant's. At
// (12, 12) the Hessians are 5,184 values a step and scenario, most of the
// bytes a step reads: the DDP variants' bound is the bytes.
#pragma once

#include "common.cuh"
#include "warp.cuh"

namespace tfmpc {
namespace {

constexpr int kMidMaxDim = 48;       // ops/riccati_mid.py MID_DIM_MAX
constexpr int kMidDdpMaxDim = 12;    // ops/riccati_mid.py MID_DDP_DIM_MAX
constexpr int kMidAlphas = 8;        // ops/boxqp.py LS_ALPHAS
constexpr int kMaxThreads = 256;     // ops/riccati_mid.py MID_MAX_THREADS
constexpr int kMaxTeamsNamed = 15;   // named barriers 1..15
constexpr size_t kMaxSmemBytes = 232448;

__host__ __device__ constexpr int odd(int d) { return d | 1; }
__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

// Elements of the arithmetic type a scenario keeps in shared memory.
__host__ __device__ inline size_t mid_work_elems(int n, int m) {
  const size_t ln = odd(n), lm = odd(m);
  const size_t nm = n * lm, mn = m * ln;
  return 2 * n * ln + (nm > mn ? nm : mn) + 2 * mn + 3 * m * lm + 2 * n +
         5 * static_cast<size_t>(m) + 2 * (kMidAlphas + 1) * lm;
}

// Elements of the input type in a scenario's staging slot.
size_t mid_stage_elems(int n, int m, bool stage_l) {
  const size_t nn = static_cast<size_t>(n) * n, nm = static_cast<size_t>(n) * m;
  size_t e = nn + nm + n + 2 * static_cast<size_t>(m);
  if (stage_l) e += nn + static_cast<size_t>(m) * m + nm;
  return e;
}

size_t mid_scenario_bytes(int n, int m, size_t s_bytes, bool stage_l) {
  return align16(mid_work_elems(n, m) * sizeof(double)) +
         align16(mid_stage_elems(n, m, stage_l) * s_bytes);
}

// One scenario's threads: tid in [0, nt), nt = 32 * warps; the team's first
// warp runs the dependent chains.
struct Team {
  int tid, nt, barrier;  // barrier 0: one warp, __syncwarp
  __device__ __forceinline__ void sync() const {
    if (barrier == 0)
      __syncwarp();
    else
      named_barrier(barrier, nt);
  }
  __device__ __forceinline__ bool lead() const { return tid < 32; }
};

// Calls f(i, j) for the entries of an I x J output this thread owns: for
// J <= nt, thread t takes column t % J of rows t / J, t / J + nt / J, ...
// (one division per product); for J > nt, columns t, t + nt, ... of every
// row.
template <typename F>
__device__ __forceinline__ void for_entries(const Team& tm, int I, int J,
                                            F f) {
  if (J <= tm.nt) {
    const int G = tm.nt / J, g = tm.tid / J;
    if (g >= G) return;
    const int j = tm.tid - g * J;
    for (int i = g; i < I; i += G) f(i, j);
  } else {
    for (int j = tm.tid; j < J; j += tm.nt)
      for (int i = 0; i < I; ++i) f(i, j);
  }
}

// Calls f(rows, count, j) for the row tiles of the I x J output this thread
// owns, mapped as for_entries: column j and up to kTile of its rows, rows[t]
// for t < count (the rest repeat a valid row, computed and not stored), so
// a product runs kTile independent sums at once and reads each column
// operand once for all of them.
constexpr int kTile = 4;

template <typename F>
__device__ __forceinline__ void for_tiles(const Team& tm, int I, int J,
                                          F f) {
  int g = 0, G = 1, j0 = tm.tid, js = tm.nt;
  if (J <= tm.nt) {
    G = tm.nt / J;
    g = tm.tid / J;
    if (g >= G) return;
    j0 = tm.tid - g * J;
    js = J;
  }
  for (int j = j0; j < J; j += js)
    for (int i0 = g; i0 < I; i0 += kTile * G) {
      int rows[kTile];
      int count = 0;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int i = i0 + t * G;
        rows[t] = i < I ? i : i0;
        count += i < I ? 1 : 0;
      }
      f(rows, count, j);
    }
}

// The team's shared arrays (row-major, rows padded to ln = n | 1 or
// lm = m | 1 elements) and its staging slot.
template <typename C, typename S>
struct MidSmem {
  C *V, *Wt;         // [n, ln]: V, then Q_xx; W, then the unsymmetrized V'
  C *Wu;             // W_u [n, lm], then A1 = Q_uu K [m, ln]
  C *Qux, *QuxR;     // [m, ln] (QuxR later K)
  C *Quu, *QuuR, *L; // [m, lm]
  C *v, *Qx, *Qu, *invd, *k, *Quuk, *x;
  C *cand, *Hc;      // [9, lm]
  S *stage;          // f_x, f_u, l_x, l_u, ubar [, l_xx, l_uu, l_ux]
};

template <typename C, typename S>
__device__ MidSmem<C, S> carve(unsigned char* base, int n, int m) {
  MidSmem<C, S> s;
  const int ln = odd(n), lm = odd(m);
  C* p = reinterpret_cast<C*>(base);
  auto take = [&p](int count) { C* q = p; p += count; return q; };
  s.V = take(n * ln);
  s.Wt = take(n * ln);
  s.Wu = take(n * lm > m * ln ? n * lm : m * ln);
  s.Qux = take(m * ln);
  s.QuxR = take(m * ln);
  s.Quu = take(m * lm);
  s.QuuR = take(m * lm);
  s.L = take(m * lm);
  s.v = take(n);
  s.Qx = take(n);
  s.Qu = take(m);
  s.invd = take(m);
  s.k = take(m);
  s.Quuk = take(m);
  s.x = take(m);
  s.cand = take((kMidAlphas + 1) * lm);
  s.Hc = take((kMidAlphas + 1) * lm);
  s.stage = reinterpret_cast<S*>(
      base + align16(mid_work_elems(n, m) * sizeof(C)));
  return s;
}

// Issue the copies of step bt's inputs into the staging slot (the team's
// threads take neighbouring elements, so each warp's copies are coalesced).
template <typename S>
__device__ void stage_step(const Team& tm, S* st, int n, int m, bool box,
                           bool stage_l, int64_t bt, const S* fx,
                           const S* fu, const S* lx, const S* lu,
                           const S* ubar, const S* lxx, const S* luu,
                           const S* lux) {
  const int nn = n * n, nm = n * m, mm = m * m;
  // 16-byte copies where both ends are aligned and the count divides
  // (HVAC-12, HVAC-16), else one element a copy
  auto copy = [&tm](S* dst, const S* src, int count) {
    constexpr int kVec = 16 / sizeof(S);
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
         15) == 0 &&
        count % kVec == 0) {
      for (int e = tm.tid * kVec; e < count; e += tm.nt * kVec)
        cp_async<16>(dst + e, src + e);
    } else {
      for (int e = tm.tid; e < count; e += tm.nt)
        cp_async<sizeof(S)>(dst + e, src + e);
    }
  };
  copy(st, fx + bt * nn, nn);
  copy(st + nn, fu + bt * nm, nm);
  copy(st + nn + nm, lx + bt * n, n);
  copy(st + nn + nm + n, lu + bt * m, m);
  if (box) copy(st + nn + nm + n + m, ubar + bt * m, m);
  if (stage_l) {
    S* l = st + nn + nm + n + 2 * m;
    copy(l, lxx + bt * nn, nn);
    copy(l + nn, luu + bt * mm, mm);
    copy(l + nn + mm, lux + bt * nm, nm);
  }
  cp_async_commit();
}

// The Cholesky of the masked free system of H (H on free x free, 1 on
// the clamped diagonal; fm = all rows free is H itself, the PD probe) by
// one warp, column by column: lane r (and r + 32) forms its row's entry
// of column c as a dot product over the columns before it, with loads
// only, then the pivot comes from lane c by shuffle. On return Ls[r][c] =
// L[r][c] / L[c][c] for c < r (the scaled factor the substitutions
// multiply by) and invd[c] = 1 / L[c][c]. Each entry's terms are those of
// the right-looking update of _chol_rows in the same (ascending) order:
// a[r][c] - sum_k (a[r][k] invd[k]) (a[c][k] invd[k]). A pivot <= 0 or
// non-finite returns true (the same in every lane: they shuffle the same
// pivot); sqrt(max(s, 1e-30)) keeps the factor finite, and a NaN pivot
// stays NaN.
template <typename C>
__device__ bool chol_warp(const C* H, int lh, C* Ls, C* invd, int m,
                          int lane, uint64_t fm) {
  bool fail = false;
  const int r0 = lane, r1 = lane + 32;
  auto entry = [&](int r, int c) {
    C acc = ((fm >> r) & (fm >> c) & 1) ? H[r * lh + c]
                                         : (r == c ? C(1) : C(0));
    const C* lr = Ls + r * lh;
    const C* lc = Ls + c * lh;
#pragma unroll 4
    for (int k = 0; k < c; ++k) acc -= lr[k] * lc[k];
    return acc;
  };
  for (int c = 0; c < m; ++c) {
    const C a0 = (r0 >= c && r0 < m) ? entry(r0, c) : C(0);
    const C a1 = (r1 >= c && r1 < m) ? entry(r1, c) : C(0);
    const C s = __shfl_sync(kFullMask, c < 32 ? a0 : a1, c & 31);
    if (!(s > C(0)) || !dfinite(s)) fail = true;
    const C sc = (s != s) ? s : (s > C(1e-30) ? s : C(1e-30));
    const C inv = C(1) / dsqrt(sc);
    if (lane == 0) invd[c] = inv;
    if (r0 > c && r0 < m) Ls[r0 * lh + c] = a0 * inv;
    if (r1 > c && r1 < m) Ls[r1 * lh + c] = a1 * inv;
    __syncwarp();
  }
  return fail;
}

// Solve (L L^T) y = y in place for the factor of chol_warp, one right-hand
// side held in registers (lane a: y0 = y[a], y1 = y[a + 32]); each solved
// entry is broadcast by shuffle. The result is multiplied by -1 when
// ``neg``. Each entry's terms are the column solve's below.
template <typename C>
__device__ void solve_vec_warp(const C* Ls, int la, const C* invd, int m,
                               int lane, C& y0, C& y1, bool neg) {
  // rows clamped into the matrix: every lane loads, the selects keep the
  // entries each row really takes, and no branch holds a load back
  const int r0 = lane, r1 = lane + 32;
  const int c0 = r0 < m ? r0 : m - 1, c1 = r1 < m ? r1 : m - 1;
  for (int k = 0; k + 1 < m; ++k) {
    const C l0 = Ls[c0 * la + k], l1 = Ls[c1 * la + k], ik = invd[k];
    const C t = __shfl_sync(kFullMask, k < 32 ? y0 : y1, k & 31) * ik;
    const C u0 = y0 - l0 * t, u1 = y1 - l1 * t;
    y0 = (r0 > k && r0 < m) ? u0 : y0;
    y1 = (r1 > k && r1 < m) ? u1 : y1;
  }
  y0 = r0 < m ? y0 * invd[c0] : y0;
  y1 = r1 < m ? y1 * invd[c1] : y1;
  for (int a = m - 1; a > 0; --a) {
    const C l0 = Ls[a * la + c0], l1 = Ls[a * la + c1], ia = invd[a];
    const C t = __shfl_sync(kFullMask, a < 32 ? y0 : y1, a & 31) * ia;
    const C u0 = y0 - l0 * t, u1 = y1 - l1 * t;
    y0 = r0 < a ? u0 : y0;
    y1 = r1 < a ? u1 : y1;
  }
  y0 = r0 < m ? y0 * (neg ? -invd[c0] : invd[c0]) : y0;
  y1 = r1 < m ? y1 * (neg ? -invd[c1] : invd[c1]) : y1;
}

// Solve (L L^T) Z = RHS in place for the factor of chol_warp, a column per
// thread of the team: X [m, R] (row stride lx), then y [m] as column R
// when given; Z is multiplied by -1 when ``neg`` (the gains' sign). Each
// entry is a dot product over the entries solved before it (loads only,
// no store in the inner loop), with the terms of the right-looking
// substitutions of _chol_solve_rows in their order: forward t[r] = (b[r] -
// sum_{k<r} Ls[r][k] t[k]) invd[r]; back t[r] = (t[r] - sum_{a>r,
// descending} Ls[a][r] t[a]) invd[r]; the column holds t as it goes, and
// the result is -t (exact).
template <typename C>
__device__ void solve_columns(const Team& tm, const C* Ls, int la,
                              const C* invd, int m, C* X, int lx, int R,
                              C* y, bool neg) {
  const int cols = R + (y != nullptr ? 1 : 0);
  for (int j = tm.tid; j < cols; j += tm.nt) {
    C* col = j < R ? X + j : y;
    const int s = j < R ? lx : 1;
    for (int r = 0; r < m; ++r) {
      C acc = col[r * s];
      const C* lr = Ls + r * la;
#pragma unroll 4
      for (int k = 0; k < r; ++k) acc -= lr[k] * col[k * s];
      col[r * s] = acc * invd[r];
    }
    for (int r = m - 1; r >= 0; --r) {
      C acc = col[r * s];
#pragma unroll 4
      for (int a = m - 1; a > r; --a) acc -= Ls[a * la + r] * col[a * s];
      col[r * s] = acc * invd[r];
    }
    if (neg)
      for (int r = 0; r < m; ++r) col[r * s] = -col[r * s];
  }
}

// The lead warp's view of the boxQP's own entries: lane a holds entries a
// and a + 32 of x and of the box.
template <typename C>
struct BoxLane {
  C x0, x1, lo0, hi0, lo1, hi1;
};

// g = q + H x at the lane's entries (x read from shared), the free set as
// a 64-bit mask (the same in every lane) and the free gradient.
template <typename C>
__device__ uint64_t free_set(const C* H, int lh, const C* q, const C* x,
                             int m, int lane, const BoxLane<C>& bx, C& gm0,
                             C& gm1) {
  bool f0 = false, f1 = false;
  gm0 = C(0);
  gm1 = C(0);
  const int r0 = lane, r1 = lane + 32;
  if (r0 < m) {
    C acc = 0;
    for (int c = 0; c < m; ++c) acc += H[r0 * lh + c] * x[c];
    const C g = q[r0] + acc;
    f0 = !((bx.x0 <= bx.lo0 && g > C(0)) || (bx.x0 >= bx.hi0 && g < C(0)));
    gm0 = f0 ? g : C(0);
  }
  if (r1 < m) {
    C acc = 0;
    for (int c = 0; c < m; ++c) acc += H[r1 * lh + c] * x[c];
    const C g = q[r1] + acc;
    f1 = !((bx.x1 <= bx.lo1 && g > C(0)) || (bx.x1 >= bx.hi1 && g < C(0)));
    gm1 = f1 ? g : C(0);
  }
  return static_cast<uint64_t>(__ballot_sync(kFullMask, f0)) |
         (static_cast<uint64_t>(__ballot_sync(kFullMask, f1)) << 32);
}

// The lead warp's factor of a masked free system of QuuR and the free set
// it was formed for: asking for the same set again (the probe's all-free
// set, or a Newton iteration's set repeated) reuses it, bit for bit the
// factor a new Cholesky would form, and its PD-probe result.
template <typename C>
struct LeadFactor {
  uint64_t mask = ~0ull;  // no set: a free set has no bit at m or above
  bool fail = false;

  template <typename S>
  __device__ void form(const MidSmem<C, S>& s, int m, int lane,
                       uint64_t fm) {
    if (fm == mask) return;
    fail = chol_warp(s.QuuR, odd(m), s.L, s.invd, m, lane, fm);
    mask = fm;
  }
};

// The gains of step t. The lead warp runs the PD probe of QuuR and (kBox)
// the projected-Newton boxQP on (QuuR, Q_u) within [lo, hi] (_boxqp_rows,
// ops/boxqp.py) and the final free set's factor and right-hand sides; then
// the team solves K = -(QuxR solved) and, for iLQR, k = -QuuR^-1 Q_u
// (solve_columns). The lead warp's passes share one call of the
// factorization (the probe's all-free set, each Newton iteration's set, the
// final set). Returns the lead warp's fail bit of this step.
template <typename C, typename S, bool kBox>
__device__ bool gains(const Team& tm, const MidSmem<C, S>& s, int n, int m,
                      int iters, BoxLane<C>& bx) {
  const int lane = tm.tid & 31, lm = odd(m), ln = odd(n);
  const int r0 = lane, r1 = lane + 32;
  bool fail = false;
  if (tm.lead()) {
    LeadFactor<C> f;
    bool frozen = false;  // converged, or no candidate improved
    for (int it = -1;; ++it) {
      // pass -1: the probe; then the free set at x: a Newton iteration's,
      // or, once the iterations are spent or frozen, the final one
      uint64_t fm = (1ull << m) - 1;
      C d0 = 0, d1 = 0;
      bool newton = false;
      if (it >= 0) {
        fm = free_set(s.QuuR, lm, s.Qu, s.x, m, lane, bx, d0, d1);
        const C gfree2 = warp_sum(d0 * d0 + d1 * d1);
        frozen = frozen || gfree2 < C(1e-16) || fm == 0;
        newton = !frozen && it < iters;
      }
      f.form(s, m, lane, fm);
      if (it < 0) {
        fail = f.fail;  // the PD probe, both variants
        if (!kBox) break;
        bx.x0 = clip(C(0), bx.lo0, bx.hi0);
        bx.x1 = clip(C(0), bx.lo1, bx.hi1);
        if (r0 < m) s.x[r0] = bx.x0;
        if (r1 < m) s.x[r1] = bx.x1;
        __syncwarp();
        continue;
      }
      if (!newton) {
        // the final free set's factor and the K rows' right-hand sides
        // free[a] * QuxR[a][:] (clamped rows exactly 0); k = x
        fail |= f.fail;
        for (int r = lane; r < m; r += 32)
          if (!((fm >> r) & 1))
            for (int j = 0; j < n; ++j) s.QuxR[r * ln + j] = C(0);
        if (r0 < m) s.k[r0] = bx.x0;
        if (r1 < m) s.k[r1] = bx.x1;
        break;
      }
      // the Newton step d = -(H_ff)^-1 g_free, in registers
      solve_vec_warp(s.L, lm, s.invd, m, lane, d0, d1, true);
      // candidates clip(x + 2^-i d), i < 8, and x itself in slot 8
      C alpha = 1;
      for (int i = 0; i <= kMidAlphas; ++i) {
        if (r0 < m)
          s.cand[i * lm + r0] = i < kMidAlphas
                                    ? clip(bx.x0 + alpha * d0, bx.lo0, bx.hi0)
                                    : bx.x0;
        if (r1 < m)
          s.cand[i * lm + r1] = i < kMidAlphas
                                    ? clip(bx.x1 + alpha * d1, bx.lo1, bx.hi1)
                                    : bx.x1;
        alpha *= C(0.5);
      }
      __syncwarp();
      // H c for the nine candidates, lane a row a
      for (int r = lane; r < m; r += 32) {
        C acc[kMidAlphas + 1];
#pragma unroll
        for (int i = 0; i <= kMidAlphas; ++i) acc[i] = C(0);
#pragma unroll 1
        for (int c = 0; c < m; ++c) {
          const C h = s.QuuR[r * lm + c];
#pragma unroll
          for (int i = 0; i <= kMidAlphas; ++i)
            acc[i] += h * s.cand[i * lm + c];
        }
#pragma unroll
        for (int i = 0; i <= kMidAlphas; ++i) s.Hc[i * lm + r] = acc[i];
      }
      __syncwarp();
      // objectives 1/2 c^T H c + q^T c, candidate i summed by lane i in
      // ascending order; the first that improves on x by more than 1e-12
      C obj = 0;
      if (lane <= kMidAlphas) {
        C xhx = 0, qx = 0;
#pragma unroll 1
        for (int a = 0; a < m; ++a) {
          const C c = s.cand[lane * lm + a];
          xhx += c * s.Hc[lane * lm + a];
          qx += s.Qu[a] * c;
        }
        obj = C(0.5) * xhx + qx;
      }
      const C obj_now = __shfl_sync(kFullMask, obj, kMidAlphas);
      const unsigned better = __ballot_sync(
          kFullMask, lane < kMidAlphas && obj < obj_now - C(1e-12));
      if (better == 0) {
        frozen = true;  // no improvement: x stays
        continue;
      }
      const int best = __ffs(better) - 1;
      if (r0 < m) bx.x0 = s.cand[best * lm + r0];
      if (r1 < m) bx.x1 = s.cand[best * lm + r1];
      __syncwarp();
      if (r0 < m) s.x[r0] = bx.x0;
      if (r1 < m) s.x[r1] = bx.x1;
      __syncwarp();
    }
  }
  tm.sync();
  solve_columns(tm, s.L, lm, s.invd, m, s.QuxR, ln, n,
                kBox ? static_cast<C*>(nullptr) : s.k, true);
  return fail;
}

// The DDP terms of a tile of a Q block: h[t] = sum_p v_p H[p][ri[t]][j],
// p ascending, for the rows ri of column j of an I x J block whose
// Hessian H [n][I][J] (``block`` = I * J values a p, row stride J) is read
// in place from global memory; a warp's threads take consecutive j, so
// each p's reads are coalesced.
template <typename S, typename C>
__device__ __forceinline__ void ddp_terms(const S* __restrict__ H,
                                          const C* v, int n, int block,
                                          int J, const int (&ri)[kTile],
                                          int j, C (&h)[kTile]) {
  for (int p = 0; p < n; ++p) {
    const C vp = v[p];
    const S* Hp = H + p * block + j;
#pragma unroll
    for (int t = 0; t < kTile; ++t) h[t] += vp * C(Hp[ri[t] * J]);
  }
}

// ubar, lo_in, hi_in are null unless kBox, fxx, fux, fuu unless kDdp.
// Inputs and outputs in the solver's layout: fx [B, T, n, n], fu [B, T, n,
// m], lx [B, T, n], lu [B, T, m], lxx [B, T, n, n], luu [B, T, m, m], lux
// [B, T, m, n], mu [B], ubar [B, T, m], lo/hi [m], fxx [B, T, n, n, n], fux
// [B, T, n, m, n], fuu [B, T, n, m, m], VT [B, n, n], vT [B, n]; K [B, T,
// m, n], k [B, T, m], dV1, dV2, fail [B]. Team ``slot`` of block
// blockIdx.x takes scenario blockIdx.x * spb + slot. C, the arithmetic
// type, is double.
template <typename S, bool kBox, bool kDdp = false, typename C = double>
__global__ void __launch_bounds__(kMaxThreads, 1) riccati_mid_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ ubar, const S* __restrict__ lo_in,
    const S* __restrict__ hi_in, const S* __restrict__ fxx,
    const S* __restrict__ fux, const S* __restrict__ fuu,
    const S* __restrict__ VT,
    const S* __restrict__ vT, S* __restrict__ K_out, S* __restrict__ k_out,
    S* __restrict__ dV1_out, S* __restrict__ dV2_out,
    S* __restrict__ fail_out, int n, int m, int T, int B, int newton_iters,
    int warps, int spb, int stage_l, int scenario_bytes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // team ``slot`` takes the block's warps slot, slot + spb, ...: warp w
  // runs on the SM's sub-partition w % 4, so the teams' first warps,
  // which carry the dependent chains, are on different ones
  const int nt = 32 * warps;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int slot = warp % spb;
  const int b = blockIdx.x * spb + slot;
  if (b >= B) return;  // the whole team: no barrier spans two teams
  const Team tm{(warp / spb) * 32 + static_cast<int>(threadIdx.x) % 32, nt,
                warps > 1 ? 1 + slot : 0};
  const int lane = tm.tid & 31;
  const MidSmem<C, S> s =
      carve<C, S>(smem_raw + static_cast<size_t>(slot) * scenario_bytes, n, m);
  const int nn = n * n, nm = n * m, mm = m * m, ln = odd(n), lm = odd(m);
  // the staging slot's arrays
  const S* sfx = s.stage;
  const S* sfu = sfx + nn;
  const S* slx = sfu + nm;
  const S* slu = slx + n;
  const S* subar = slu + m;
  const S* sl = subar + m;  // l_xx, l_uu, l_ux when staged

  for_entries(tm, n, n, [&](int i, int j) {
    s.V[i * ln + j] = C(VT[static_cast<int64_t>(b) * nn + i * n + j]);
  });
  for (int i = tm.tid; i < n; i += tm.nt)
    s.v[i] = C(vT[static_cast<int64_t>(b) * n + i]);
  const C mu = C(mu_in[b]);
  C dV1 = 0, dV2 = 0;  // the lead warp's (every lane alike)
  bool fail = false;   // the lead warp's
  stage_step(tm, s.stage, n, m, kBox, stage_l != 0,
             static_cast<int64_t>(b) * T + T - 1, fx, fu, lx, lu, ubar, lxx,
             luu, lux);

  for (int t = T - 1; t >= 0; --t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    cp_async_wait_all();
    tm.sync();
    const S* lxx_t = stage_l ? sl : lxx + bt * nn;
    const S* luu_t = stage_l ? sl + nn : luu + bt * mm;
    const S* lux_t = stage_l ? sl + nn + mm : lux + bt * nm;
    // step t's Hessians, read in place (kDdp)
    const S* fxx_t = fxx + bt * nn * n;
    const S* fux_t = fux + bt * nm * n;
    const S* fuu_t = fuu + bt * mm * n;

    // W = V f_x, W_u = V f_u, Q_x = l_x + f_x^T v, Q_u = l_u + f_u^T v
    for_tiles(tm, n, n, [&](const int (&ri)[kTile], int cnt, int j) {
      C acc[kTile] = {};
      for (int r = 0; r < n; ++r) {
        const C b = C(sfx[r * n + j]);
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] += s.V[ri[t] * ln + r] * b;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) s.Wt[ri[t] * ln + j] = acc[t];
    });
    for_tiles(tm, n, m, [&](const int (&ri)[kTile], int cnt, int c) {
      C acc[kTile] = {};
      for (int r = 0; r < n; ++r) {
        const C b = C(sfu[r * m + c]);
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] += s.V[ri[t] * ln + r] * b;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) s.Wu[ri[t] * lm + c] = acc[t];
    });
    for_entries(tm, 1, n, [&](int, int i) {
      C acc = 0;
      for (int p = 0; p < n; ++p) acc += C(sfx[p * n + i]) * s.v[p];
      s.Qx[i] = C(slx[i]) + acc;
    });
    for_entries(tm, 1, m, [&](int, int a) {
      C acc = 0;
      for (int p = 0; p < n; ++p) acc += C(sfu[p * m + a]) * s.v[p];
      s.Qu[a] = C(slu[a]) + acc;
    });
    tm.sync();

    // Q_xx = l_xx + f_x^T W (into V's slot); Q_uu, QuuR = l_uu + f_u^T
    // (W_u [+ mu f_u]); Q_ux, QuxR = l_ux + f_u^T
    // (W [+ mu f_x]); k = Q_u as the iLQR solve's right-hand side. With
    // kDdp each adds its t block (ddp_terms) and QuuR mu on its diagonal.
    for_tiles(tm, n, n, [&](const int (&ri)[kTile], int cnt, int j) {
      C acc[kTile] = {};
      for (int p = 0; p < n; ++p) {
        const C w = s.Wt[p * ln + j];
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] += C(sfx[p * n + ri[t]]) * w;
      }
      C h[kTile] = {};
      if constexpr (kDdp) ddp_terms(fxx_t, s.v, n, nn, n, ri, j, h);
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) {
          C q = C(lxx_t[ri[t] * n + j]) + acc[t];
          if constexpr (kDdp) q += h[t];
          s.V[ri[t] * ln + j] = q;
        }
    });
    for_tiles(tm, m, m, [&](const int (&ri)[kTile], int cnt, int c) {
      C acc[kTile] = {}, accR[kTile] = {};
      for (int p = 0; p < n; ++p) {
        const C wu = s.Wu[p * lm + c];
        const C wuR = wu + mu * C(sfu[p * m + c]);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const C fpa = C(sfu[p * m + ri[t]]);
          acc[t] += fpa * wu;
          accR[t] += fpa * wuR;
        }
      }
      C h[kTile] = {};
      if constexpr (kDdp) ddp_terms(fuu_t, s.v, n, mm, m, ri, c, h);
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) {
          const int a = ri[t];
          const C l = C(luu_t[a * m + c]);
          C q = l + acc[t], qr = l + accR[t];
          if constexpr (kDdp) {
            q += h[t];
            qr += h[t];
            if (a == c) qr += mu;
          }
          s.Quu[a * lm + c] = q;
          s.QuuR[a * lm + c] = qr;
        }
    });
    for_tiles(tm, m, n, [&](const int (&ri)[kTile], int cnt, int i) {
      C acc[kTile] = {}, accR[kTile] = {};
      for (int p = 0; p < n; ++p) {
        const C w = s.Wt[p * ln + i];
        const C wR = w + mu * C(sfx[p * n + i]);
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const C fpa = C(sfu[p * m + ri[t]]);
          acc[t] += fpa * w;
          accR[t] += fpa * wR;
        }
      }
      C h[kTile] = {};
      if constexpr (kDdp) ddp_terms(fux_t, s.v, n, nm, n, ri, i, h);
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) {
          const int a = ri[t];
          const C l = C(lux_t[a * n + i]);
          C q = l + acc[t], qr = l + accR[t];
          if constexpr (kDdp) {
            q += h[t];
            qr += h[t];
          }
          s.Qux[a * ln + i] = q;
          s.QuxR[a * ln + i] = qr;
        }
    });
    if (!kBox)
      for (int a = tm.tid; a < m; a += tm.nt) s.k[a] = s.Qu[a];
    BoxLane<C> bx{};
    if (kBox && tm.lead()) {
      if (lane < m) {
        const C u = C(subar[lane]);
        bx.lo0 = C(lo_in[lane]) - u;
        bx.hi0 = C(hi_in[lane]) - u;
      }
      if (lane + 32 < m) {
        const C u = C(subar[lane + 32]);
        bx.lo1 = C(lo_in[lane + 32]) - u;
        bx.hi1 = C(hi_in[lane + 32]) - u;
      }
    }
    tm.sync();
    // the slot is read: copy step t-1's inputs under the rest of step t
    if (t > 0)
      stage_step(tm, s.stage, n, m, kBox, stage_l != 0, bt - 1, fx, fu, lx,
                 lu, ubar, lxx, luu, lux);

    // the gains: the PD probe, the boxQP, the final factor and the solves
    fail |= gains<C, S, kBox>(tm, s, n, m, newton_iters, bx);
    tm.sync();
    const C* Kg = s.QuxR;  // the gains K [m, ln]

    // Q_uu k and A1 = Q_uu K (into W_u's slot); store the gains
    C* A1 = s.Wu;
    for_entries(tm, 1, m, [&](int, int a) {
      C acc = 0;
      for (int c = 0; c < m; ++c) acc += s.Quu[a * lm + c] * s.k[c];
      s.Quuk[a] = acc;
      k_out[bt * m + a] = static_cast<S>(s.k[a]);
    });
    for_tiles(tm, m, n, [&](const int (&ri)[kTile], int cnt, int j) {
      C acc[kTile] = {};
      for (int c = 0; c < m; ++c) {
        const C kc = Kg[c * ln + j];
#pragma unroll
        for (int t = 0; t < kTile; ++t) acc[t] += s.Quu[ri[t] * lm + c] * kc;
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) {
          const int a = ri[t];
          A1[a * ln + j] = acc[t];
          K_out[bt * nm + a * n + j] = static_cast<S>(Kg[a * ln + j]);
        }
    });
    tm.sync();

    // dV1, dV2 (lead warp); V' = ((Q_xx + K^T A1) + K^T Q_ux) + Q_ux^T K
    // into W's slot; v' = ((Q_x + K^T Q_uu k) + K^T Q_u) + Q_ux^T k
    if (tm.lead()) {
      C p1 = 0, p2 = 0;
      for (int a = lane; a < m; a += 32) {
        p1 += s.k[a] * s.Qu[a];
        p2 += s.k[a] * s.Quuk[a];
      }
      dV1 = dV1 + warp_sum(p1);
      dV2 = dV2 + C(0.5) * warp_sum(p2);
    }
    for_tiles(tm, n, n, [&](const int (&ri)[kTile], int cnt, int j) {
      C s1[kTile] = {}, s2[kTile] = {}, s3[kTile] = {};
      for (int a = 0; a < m; ++a) {
        const C a1 = A1[a * ln + j], qj = s.Qux[a * ln + j],
                kj = Kg[a * ln + j];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const C kai = Kg[a * ln + ri[t]];
          s1[t] += kai * a1;
          s2[t] += kai * qj;
          s3[t] += s.Qux[a * ln + ri[t]] * kj;
        }
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t)
        if (t < cnt) {
          const int i = ri[t];
          s.Wt[i * ln + j] = ((s.V[i * ln + j] + s1[t]) + s2[t]) + s3[t];
        }
    });
    for_entries(tm, 1, n, [&](int, int i) {
      C s1 = 0, s2 = 0, s3 = 0;
      for (int a = 0; a < m; ++a) {
        const C kai = Kg[a * ln + i];
        s1 += kai * s.Quuk[a];
        s2 += kai * s.Qu[a];
        s3 += s.Qux[a * ln + i] * s.k[a];
      }
      s.v[i] = ((s.Qx[i] + s1) + s2) + s3;
    });
    tm.sync();
    for_entries(tm, n, n, [&](int i, int j) {
      s.V[i * ln + j] = C(0.5) * (s.Wt[i * ln + j] + s.Wt[j * ln + i]);
    });
    // the next step's wait and barrier order these writes before its reads
  }

  if (tm.tid == 0) {
    dV1_out[b] = static_cast<S>(dV1);
    dV2_out[b] = static_cast<S>(dV2);
    fail_out[b] = fail ? S(1) : S(0);
  }
}

// A launch plan (ops/riccati_mid.py mid_plan): warps per scenario,
// scenarios per block, whether l_xx, l_uu, l_ux are staged, and the
// dynamic shared bytes of a block, which must equal what this source
// computes for it.
struct MidPlan {
  int warps, spb, stage_l;
  long long smem_bytes;
};

template <typename S>
long long plan_bytes(int n, int m, const MidPlan& p) {
  return static_cast<long long>(
             mid_scenario_bytes(n, m, sizeof(S), p.stage_l != 0)) *
         p.spb;
}

template <typename S, bool kBox, bool kDdp>
int launch(int n, int m, int T, int B, int iters, const void* const* in,
           void* const* out, const MidPlan& p, cudaStream_t stream) {
  const size_t scenario =
      mid_scenario_bytes(n, m, sizeof(S), p.stage_l != 0);
  const long long bytes = plan_bytes<S>(n, m, p);
  if (bytes != p.smem_bytes || bytes > static_cast<long long>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = riccati_mid_kernel<S, kBox, kDdp>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto P = [in](int i) { return static_cast<const S*>(in[i]); };
  kernel<<<blocks_for(B, p.spb), 32 * p.warps * p.spb,
           static_cast<size_t>(bytes), stream>>>(
      P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7), P(8), P(9), P(10),
      P(11), P(12), P(13), P(14), P(15), static_cast<S*>(out[0]),
      static_cast<S*>(out[1]),
      static_cast<S*>(out[2]), static_cast<S*>(out[3]),
      static_cast<S*>(out[4]), n, m, T, B, iters, p.warps, p.spb, p.stage_l,
      static_cast<int>(scenario));
  return static_cast<int>(cudaGetLastError());
}

bool plan_ok(const MidPlan& p) {
  const int threads = 32 * p.warps * p.spb;
  return p.warps >= 1 && p.spb >= 1 && threads <= kMaxThreads &&
         (p.warps == 1 || p.spb <= kMaxTeamsNamed) &&
         (p.stage_l == 0 || p.stage_l == 1);
}

// in: fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, fxx, fux, fuu, VT,
// vT (ubar, lo, hi null without kBox, fxx, fux, fuu without kDdp); out: K,
// k, dV1, dV2, fail. The DDP variants take n, m <= kMidDdpMaxDim.
template <bool kBox, bool kDdp>
int entry(int dtype, int n, int m, int T, int B, int iters,
          const void* const* in, void* const* out, const MidPlan& p,
          void* stream) {
  const int top = kDdp ? kMidDdpMaxDim : kMidMaxDim;
  if (n < 1 || m < 1 || n > top || m > top || T < 1 || iters < 0 ||
      !plan_ok(p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBox && (in[8] == nullptr || in[9] == nullptr || in[10] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kDdp && (in[11] == nullptr || in[12] == nullptr || in[13] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float, kBox, kDdp>(n, m, T, B, iters, in, out, p, s);
  if (dtype == kFloat64)
    return launch<double, kBox, kDdp>(n, m, T, B, iters, in, out, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tfmpc
