// K1, K4, K6a and K6b at every 1 <= n, m <= 12 outside the lane kernels'
// dims: the batched Riccati backward pass, unconstrained or control-limited
// (kBox: the boxQP gains), with (kDdp) or without the full-DDP terms,
// float32 and float64 inputs, computed in double.
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw (adapters
// riccati_backward_pallas :520, riccati_backward_ddp_pallas :545,
// riccati_backward_boxqp_pallas :585 and riccati_backward_ddp_boxqp_pallas
// :564; body _kernel / _riccati_step_math :260-386: its DDP terms
// :306-324, its unconstrained branch :346-352 and its boxQP branch /
// _boxqp_lane), which the JAX package runs at every n, m <= 12
// (tfmpc_tpu/solvers/ilqr_batched.py lane_limit).
//
// This header holds the kernel and its launch; riccati_small.cu
// instantiates the boxQP variant (K4), riccati_small_ddp.cu the full-DDP
// boxQP one (K6b), riccati_small_ilqr.cu the unconstrained one (K1) and
// riccati_small_ddp_ilqr.cu the full-DDP unconstrained one (K6a), so the
// parallel build compiles them side by side.
//
// Per scenario and step t = T-1 .. 0, as K7 (riccati_mid.cuh): W = V f_x,
// W_u = V f_u; Q_x, Q_u, Q_xx, Q_uu, Q_ux and the regularized QuuR, QuxR
// (V + mu I); with kDdp the contractions t_xx = sum_p v_p f_xx[p], t_ux,
// t_uu added to the Q blocks, and mu I_m on QuuR; the PD probe of QuuR;
// without kBox, k = -QuuR^-1 Q_u and K = -QuuR^-1 QuxR, the n + 1
// right-hand sides solved against the probe's own factor; with kBox
// the projected-Newton boxQP on (QuuR, Q_u) within [lo - ubar_t, hi -
// ubar_t] (ops/boxqp.py's constants: gradient tolerance 1e-8, alphas 2^-i
// for i < 8, the first candidate that improves the objective by more than
// 1e-12, a problem that converged or found nothing frozen); K rows through
// the final free set's factor (clamped rows 0), k = x; then dV1/dV2 from
// the unregularized Q_u, Q_uu; V' = Q_xx + K^T Q_uu K + K^T Q_ux + Q_ux^T K,
// symmetrized, and v'. Every pivot is clamped at 1e-30 and a pivot <= 0 or
// non-finite sets the lane's fail flag (the probe's and the final free
// set's), as K7 does: the plain version lets NaN propagate instead, which
// differs only on lanes whose PD probe already failed. Without kBox the
// probe is the one factorization: no Newton step, no line search, no
// ubar, lo or hi staged or read, and no candidates in the workspace.
//
// What bounds it on this card: at D4's shape (the 12-room ring, n = m =
// 12, B = 512, T = 50, f32) a step reads 5,940 values a scenario, most of
// them the Hessians (~0.19 ms over the backward at 3.35 TB/s); without
// them (E2: B = 1024, T = 100) ~0.11 ms of bytes. But each scenario's T
// steps are a serial chain, and a step holds up to ten dependent
// factorizations and substitutions of the boxQP, so the kernel is bound by
// the latency of one warp's instruction stream: on an H100 its time does
// not change from B = 64 to B = 1024 (tools/kernel_versions.py small). K7
// ran the chain on one warp with the factor in shared memory and spent a
// whole warp on one scenario even at m = 4.
//
// What the design does about it: a GROUP of G lanes a scenario, G the
// smallest power of two >= max(n, m) (2, 4, 8 or 16, a compile-time
// bucket; n and m at run time inside it, arrays of D = min(G, 12)), so a
// warp carries 32 / G scenarios. The warp's groups run in lockstep: every
// shuffle, ballot and __syncwarp names the whole warp (blocks are whole
// warps; a ragged block's tail group runs the last scenario beside its
// owner and stores nothing), and a branch that differs between groups is
// taken by the warp as one (``all``, ``any``).
// - Rows in registers: lane a holds row a of QuuR and of the factor, and
//   the boxQP's entry a of x, the box, g and every right-hand side. The
//   factor is an LDL^T (the unit-lower L of K7's scaled factor, D its
//   squared pivots: no sqrt), right-looking: at column k lane k's pivot
//   comes by one shuffle, its reciprocal (the hardware's approximation and
//   two Newton steps) is the chain's only long operation, and the unscaled
//   column A[c][k] of the rows below is shuffled to every lane while it
//   runs; lane a updates its own row, and lane k keeps the column L[:, k]
//   for the back substitution. A Newton step's forward substitution runs
//   inside its factorization (one more shuffle a column); its back
//   substitution is one shuffle and one FMA a column. One call of the
//   factorization serves the probe, every Newton step and the final set,
//   and a free set asked for again reuses the factor held (the probe's
//   all-free set, a repeated Newton set, the final set).
// - The line search's nine candidates (clip(x + 2^-i d), i < 8, and x)
//   go through shared memory once (double-buffered by iteration), each
//   lane forms its row of H c for all nine, and each objective is an xor
//   butterfly over the group, bitwise alike in every lane (IEEE addition
//   commutes), so every branch of the boxQP is taken alike by the group.
//   The gradient at the accepted candidate is its row of H c, kept.
// - The products: lane j owns column j of W, Q_xx, Q_ux, QuxR and of K
//   (and lane c column c of W_u, Q_uu, QuuR), the other operand broadcast
//   from shared memory (f_x and f_u widened to double there once a step);
//   QuuR reaches the rows of the boxQP through shared memory once a step.
//   K's n right-hand sides are solved a column a lane against the factor
//   in shared memory. The loops over rows are NOT unrolled: a step's code
//   runs once a step, and unrolled (10k instructions an instantiation)
//   it ran 1.5-2x slower than these loops on an H100.
// - Staged inputs: each step's f_x, f_u, l_x, l_u, l_xx, l_uu, l_ux, ubar
//   and (kDdp) the Hessians f_xx [n, n, n], f_ux [n, m, n], f_uu [n, m, m]
//   are copied into the group's staging slot as soon as the step before
//   has read its own, so the copy of step t-1 runs under step t's boxQP:
//   an array of at least kSmallBulkMin bytes, aligned, in one bulk copy by
//   lane 0 counted on the group's mbarrier, a smaller one 16 bytes a copy
//   by the group's lanes (cp.async), an unaligned one an element a copy.
//   The contractions read the Hessians from the slot in ascending p, each
//   lane its column, each entry its own accumulator. Without the box
//   (K6a), where reading the Hessians in place takes fewer waves of blocks
//   than staging them, at the blocks an SM holds as the runtime computes
//   them for the kernel (small_blocks_per_sm; D5: n = m = 12, B = 1024
//   took two staged), the plan reads them in place (``stage_h`` 0;
//   ops/riccati_small.py small_launch_plan): the group's lanes prefetch
//   step t-1's into L2 where they would have staged them, and the
//   contraction loads them from global memory. K6b always stages them.
//
// Every sum keeps K7's order where it has one (each product's entries in
// ascending index order, the DDP terms added after the first-order terms,
// mu I_m last); the factor and the substitutions take the right-looking
// order, and the objectives and the free-gradient norm are butterflies.
//
// Precision: double for both input dtypes (float32 inputs are widened as
// they are read, outputs rounded once), as K7: the float32 boxQP backward
// is ill-conditioned at HVAC-12.
//
// Shared memory: a scenario's workspace of small_work_doubles(G, box)
// doubles (V, Q_xx then the unsymmetrized V', Q_uu, QuuR then the factor,
// Q_ux, QuxR then K, f_x, f_u, W then A1, W_u, rows padded to L = D | 1;
// with the box two sets of nine candidates; six vectors; the mbarrier),
// then its staging slot in the input type, each array padded to 16 bytes
// and the slot so that neighbouring groups' slots start G elements apart
// in the bank cycle (SmallStage). The workspace starts at zero and only
// entries inside (n, m) are written, so every loop runs to D with no
// branch: the rows and columns past n, m add 0. Layout: the solver's own
// [B, T, ...] (scenario-major), read in place, as K7.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "warp.cuh"

namespace tfmpc {
namespace {

constexpr int kSmallMaxDim = 12;      // ops/riccati_small.py SMALL_DIM_MAX
constexpr int kSmallAlphas = 8;       // ops/boxqp.py LS_ALPHAS
constexpr int kSmallCands = kSmallAlphas + 1;
constexpr int kSmallMaxThreads = 256;  // ops/riccati_small.py SMALL_MAX_THREADS
constexpr size_t kSmallMaxSmem = 232448;

__host__ __device__ constexpr int small_dim(int G) {
  return G < kSmallMaxDim ? G : kSmallMaxDim;
}
__host__ __device__ constexpr int small_ld(int G) { return small_dim(G) | 1; }

// Doubles in a scenario's workspace (odd, so neighbouring groups' copies of
// one entry fall in different banks); the line search's candidates only
// with the box.
__host__ __device__ constexpr int small_work_doubles(int G, bool box = true) {
  return (10 * small_dim(G) * small_ld(G) +
          (box ? 2 * kSmallCands * small_dim(G) : 0) + 6 * small_dim(G) + 1) |
         1;
}

// The lanes a scenario at (n, m): the smallest power of two >= max(n, m),
// at least 2; 0 outside the kernel's dims.
inline int small_groups(int n, int m) {
  const int d = n > m ? n : m;
  if (n < 1 || m < 1 || d > kSmallMaxDim) return 0;
  int G = 2;
  while (G < d) G *= 2;
  return G;
}

inline size_t pad16(size_t count, size_t s_bytes) {
  const size_t q = 16 / s_bytes;
  return (count + q - 1) / q * q;
}

// Where each staged array starts in a scenario's slot (elements of the
// input type), each padded to 16 bytes, and the slot's length; and how each
// step's block of array
// q (bit q, in the order below) is copied, set by the launch from the input
// pointers: where its bytes divide by 16 and its device array is 16-byte
// aligned (so every step's block is), in one bulk copy if it holds at least
// kSmallBulkMin bytes (``bulk``, with ``bulk_bytes`` in all), else 16 bytes
// a copy by the group's lanes (``vec``); otherwise one element a copy.
constexpr int kSmallBulkMin = 512;

struct SmallStage {
  int fx, fu, lx, lu, lxx, luu, lux, ubar, fxx, fux, fuu, elems;
  unsigned bulk = 0, vec = 0, bulk_bytes = 0;
  bool hess;  // the Hessians staged (with ddp), else read in place
  SmallStage(int n, int m, size_t s_bytes, bool ddp, bool box = true,
             bool stage_h = true)
      : hess(ddp && stage_h) {
    int e = 0;
    auto take = [&](size_t count) {
      const int at = e;
      e += static_cast<int>(pad16(count, s_bytes));
      return at;
    };
    const size_t nn = static_cast<size_t>(n) * n;
    const size_t nm = static_cast<size_t>(n) * m;
    const size_t mm = static_cast<size_t>(m) * m;
    fx = take(nn);
    fu = take(nm);
    lx = take(n);
    lu = take(m);
    lxx = take(nn);
    luu = take(mm);
    lux = take(nm);
    ubar = box ? take(m) : e;
    fxx = hess ? take(nn * n) : e;
    fux = hess ? take(nm * n) : e;
    fuu = hess ? take(mm * n) : e;
    // the slot's length is padded so that neighbouring groups' slots start
    // G elements apart in the 128-byte bank cycle (16 bytes at least): a
    // warp's lanes reading the same entry of their groups' slots hit
    // different banks
    const size_t G = static_cast<size_t>(small_groups(n, m));
    const size_t shift = (s_bytes * G) % 128 > 16 ? (s_bytes * G) % 128 : 16;
    const size_t bytes = static_cast<size_t>(e) * s_bytes;
    elems = static_cast<int>((bytes + (shift + 128 - bytes % 128) % 128) /
                             s_bytes);
  }
};

// A block's dynamic shared bytes: spb workspaces, then spb staging slots
// (``box``: the boxQP variants, else the unconstrained ones; ``stage_h``:
// with ddp, the Hessians staged).
inline long long small_smem_bytes(int n, int m, size_t s_bytes, bool ddp,
                                  int spb, bool box = true,
                                  bool stage_h = true) {
  const int G = small_groups(n, m);
  if (G == 0 || spb < 1) return -1;
  const size_t work =
      (static_cast<size_t>(spb) * small_work_doubles(G, box) * 8 + 15) / 16 *
      16;
  return static_cast<long long>(
      work + static_cast<size_t>(spb) *
                 SmallStage(n, m, s_bytes, ddp, box, stage_h).elems *
                     s_bytes);
}

// Phase clocks, built only with TFMPC_SMALL_CLOCKS (tools/
// kernel_versions.py small --clocks): thread 0 of block 0 adds the SM
// cycles of each phase of its steps, and the Newton iterations its warp
// ran, into small_clocks: 5 the wait for the staged step, 6 f_x, f_u
// widened, 7 W and W_u, 8 the Q blocks, 0 the box and the next staging,
// 1 the PD probe (without the box: the one factor, Q_u's forward
// substitution fused in), 2 the Newton iterations (without the box: k's
// back substitution), 3 the final factor, K's solve and dV, 4 the value
// update; 9 the iterations.
#ifdef TFMPC_SMALL_CLOCKS
__device__ unsigned long long small_clocks[10];
#define SMALL_CLOCK_START                  \
  long long clk_last = clock64();          \
  long long clk_acc[10] = {};
#define SMALL_CLOCK(i)                     \
  {                                        \
    const long long now = clock64();       \
    clk_acc[i] += now - clk_last;          \
    clk_last = now;                        \
  }
#define SMALL_ITERS(k) clk_acc[9] += (k);
#define SMALL_CLOCK_END                                 \
  if (blockIdx.x == 0 && tid == 0)                      \
    for (int i = 0; i < 10; ++i) small_clocks[i] = clk_acc[i];
#else
#define SMALL_CLOCK_START
#define SMALL_CLOCK(i)
#define SMALL_ITERS(k)
#define SMALL_CLOCK_END
#endif

// A scenario's lanes: lane 0..G-1 of the group and its first lane in the
// warp. A block is whole warps (the plan's scenarios a block are a multiple
// of 32 / G), and every exchange names the whole warp, so the warp's
// groups run its steps in lockstep: a shuffle of width G stays inside each
// group, a ballot is cut to the group's bits, and a branch that differs
// between groups is taken by the warp as one (``all``, ``any``).
template <int G>
struct SmallGroup {
  int lane, base;
  __device__ __forceinline__ void sync() const { __syncwarp(kFullMask); }
  __device__ __forceinline__ double bcast(double v, int src) const {
    return __shfl_sync(kFullMask, v, src, G);
  }
  // the group's bits, bit a for lane a
  __device__ __forceinline__ unsigned ballot(bool p) const {
    return (__ballot_sync(kFullMask, p) >> base) &
           (G == 32 ? 0xffffffffu : (1u << G) - 1u);
  }
  // an xor butterfly: every lane of the group ends with the same bits
  __device__ __forceinline__ double sum(double v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(kFullMask, v, o, G);
    return v;
  }
  __device__ __forceinline__ bool all(bool p) const {
    return __all_sync(kFullMask, p);
  }
  __device__ __forceinline__ bool any(bool p) const {
    return __any_sync(kFullMask, p);
  }
};

// Prefetch ``count`` elements from ``p`` into L2, a 128-byte line a lane in
// turn (the line of the last element too, for an unaligned array): with
// the Hessians in place the contraction waits on their loads, and without
// the prefetch a step ahead it waits longer (D5's shape on an H100).
template <typename S, int G>
__device__ __forceinline__ void small_prefetch(const SmallGroup<G>& g,
                                               const S* p, int count) {
  constexpr int kLine = 128 / static_cast<int>(sizeof(S));
#pragma unroll 1
  for (int e = g.lane * kLine; e < count + kLine; e += G * kLine) {
    const S* q = p + (e < count ? e : count - 1);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(q));
  }
}

// Issue the copies of step bt's inputs into the group's staging slot (the
// group's lanes take neighbouring elements; ubar only with kBox; the
// Hessians with kDdp, or where they are read in place, which only K6a
// does, their prefetch).
template <typename S, int G, bool kBox, bool kDdp>
__device__ __forceinline__ void small_stage(
    const SmallGroup<G>& g, S* st, const SmallStage& o, int n, int m,
    int64_t bt, const S* fx, const S* fu, const S* lx, const S* lu,
    const S* lxx, const S* luu, const S* lux, const S* ubar, const S* fxx,
    const S* fux, const S* fuu, uint64_t* bar) {
  const int nn = n * n, nm = n * m, mm = m * m;
  // array q: its bulk copy by lane 0 (``o.bulk``, counted on ``bar``), or
  // 16 bytes (``o.vec``) or one element a copy by the group's lanes
  auto copy = [&](int q, S* d, const S* s, int count) {
    constexpr int kVec = 16 / sizeof(S);
    if ((o.bulk >> q) & 1u) {
      if (g.lane == 0) bulk_copy(d, s, count * sizeof(S), bar);
    } else if ((o.vec >> q) & 1u) {
#pragma unroll 1
      for (int e = g.lane * kVec; e < count; e += G * kVec)
        cp_async<16>(d + e, s + e);
    } else {
#pragma unroll 1
      for (int e = g.lane; e < count; e += G)
        cp_async<sizeof(S)>(d + e, s + e);
    }
  };
  if (g.lane == 0) mbar_expect(bar, o.bulk_bytes);
  copy(0, st + o.fx, fx + bt * nn, nn);
  copy(1, st + o.fu, fu + bt * nm, nm);
  copy(2, st + o.lx, lx + bt * n, n);
  copy(3, st + o.lu, lu + bt * m, m);
  copy(4, st + o.lxx, lxx + bt * nn, nn);
  copy(5, st + o.luu, luu + bt * mm, mm);
  copy(6, st + o.lux, lux + bt * nm, nm);
  if constexpr (kBox) copy(7, st + o.ubar, ubar + bt * m, m);
  if constexpr (kDdp) {
    if (kBox || o.hess) {
      copy(8, st + o.fxx, fxx + bt * nn * n, nn * n);
      copy(9, st + o.fux, fux + bt * nm * n, nm * n);
      copy(10, st + o.fuu, fuu + bt * mm * n, mm * n);
    } else {
      small_prefetch(g, fxx + bt * nn * n, nn * n);
      small_prefetch(g, fux + bt * nm * n, nm * n);
      small_prefetch(g, fuu + bt * mm * n, mm * n);
    }
  }
  cp_async_commit();
}

// The group's LDL^T factor of a masked free system of H (H on free x free,
// 1 on the clamped diagonal; fm = every row free is H itself, the PD probe)
// with rows in registers, and the forward substitution of y fused in.
// Lane a: LA[c] = L[a][c] for c < a (the unit-lower factor), Lc[c] =
// L[c][a] for c > a, dinv = 1 / D[a]; y = (L^-1 y)[a]. A group whose
// ``refactor`` is false keeps the factor it holds (the warp forms factors
// where any of its groups asks for one; the others' writes are selected
// away). A pivot D_k <= 0 or non-finite sets ``fail`` (the same in every
// lane: they shuffle the same pivot); max(D_k, 1e-30) keeps the factor
// finite, and a NaN pivot stays NaN. Every lane shuffles every row's
// entry, rows past m included (a lane past m holds the identity's row), so
// no branch holds a shuffle back.
template <int G, int D>
__device__ __forceinline__ void small_factor(const SmallGroup<G>& g, int m,
                                             const double (&H)[D],
                                             unsigned fm, bool refactor,
                                             double (&LA)[D],
                                             double (&Lc)[D], double& dinv,
                                             bool& fail, double& y) {
  constexpr double kMax = 1.7976931348623157e308;
  const int a = g.lane;
  if (g.any(refactor)) {
    const bool fa = (fm >> a) & 1u;
#pragma unroll
    for (int c = 0; c < D; ++c)
      LA[c] = refactor ? ((fa && ((fm >> c) & 1u)) ? H[c]
                                                   : (c == a ? 1.0 : 0.0))
                       : LA[c];
    bool bad = false;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= m) break;
      const double Dk = g.bcast(LA[k], k);
      // the rows below k: their unscaled column k, shuffled while the
      // pivot's reciprocal is formed
      double u[D];
#pragma unroll
      for (int c = k + 1; c < D; ++c) u[c] = g.bcast(LA[k], c);
      bad = bad || !(Dk > 0.0 && Dk <= kMax);
      const double Dc = (Dk != Dk) ? Dk : (Dk > 1e-30 ? Dk : 1e-30);
      // 1 / D_k: the hardware's approximate reciprocal and two Newton
      // steps (within an ulp of the rounded quotient; the pivot is
      // clamped, so never subnormal): the chain's one long operation
      double r;
      asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(Dc));
      {
        const double e1 = fma(-Dc, r, 1.0);
        r = fma(r, e1, r);
        const double e2 = fma(-Dc, r, 1.0);
        r = fma(r, e2, r);
      }
      const double lk = LA[k] * r;  // L[a][k], for a > k
      const bool pivot = refactor && a == k;
      dinv = pivot ? r : dinv;
#pragma unroll
      for (int c = k + 1; c < D; ++c) {
        Lc[c] = pivot ? u[c] * r : Lc[c];
        LA[c] = (refactor && c <= a && c < m) ? LA[c] - lk * u[c] : LA[c];
      }
      LA[k] = (refactor && a > k) ? lk : LA[k];
      const double yk = g.bcast(y, k);
      y = a > k ? y - LA[k] * yk : y;
    }
    fail = refactor ? bad : fail;
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (k >= m) break;
      const double yk = g.bcast(y, k);
      y = a > k ? y - LA[k] * yk : y;
    }
  }
}

// The back substitution after small_factor: y = (D^-1 L^-T y)[a] for the
// group's factor, one shuffle a column; lanes a >= m end with 0.
template <int G, int D>
__device__ __forceinline__ double small_back(const SmallGroup<G>& g, int m,
                                             const double (&Lc)[D],
                                             double dinv, double y) {
  const int a = g.lane;
  y = a < m ? y * dinv : 0.0;
#pragma unroll
  for (int k = D - 1; k > 0; --k) {
    if (k >= m) continue;
    const double zk = g.bcast(y, k);
    y = a < k ? y - Lc[k] * zk : y;
  }
  return y;
}

// ubar, lo, hi null unless kBox; fxx, fux, fuu null unless kDdp. Inputs and
// outputs in the solver's layout, as K7's (riccati_mid.cuh). Group ``slot``
// of block blockIdx.x takes scenario blockIdx.x * spb + slot.
//
// Every unrolled loop runs to the bucket's D with no branch inside (the
// loops over rows run to n or m): the workspace starts at zero and only
// entries inside (n, m) are ever written, so the rows and columns past
// them stay 0 and add nothing (an index into a staged array is clamped
// into it, and its value weighted by such a 0).
template <typename S, bool kBox, bool kDdp, int G>
__global__ void __launch_bounds__(kSmallMaxThreads) riccati_small_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ ubar, const S* __restrict__ lo_in,
    const S* __restrict__ hi_in, const S* __restrict__ fxx,
    const S* __restrict__ fux, const S* __restrict__ fuu,
    const S* __restrict__ VT, const S* __restrict__ vT,
    S* __restrict__ K_out, S* __restrict__ k_out, S* __restrict__ dV1_out,
    S* __restrict__ dV2_out, S* __restrict__ fail_out, int n, int m, int T,
    int B, int newton_iters, int spb, SmallStage so) {
  using C = double;
  constexpr int D = small_dim(G), L = small_ld(G);
  constexpr int W = small_work_doubles(G, kBox);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = static_cast<int>(threadIdx.x);
  const int slot = tid / G;
  // a group past the batch (a ragged block's tail) runs the last scenario
  // beside its owner and stores nothing: the warp's exchanges need it
  const bool live = static_cast<int>(blockIdx.x) * spb + slot < B;
  const int b = live ? static_cast<int>(blockIdx.x) * spb + slot : B - 1;
  SmallGroup<G> g;
  g.lane = tid % G;
  g.base = (tid & 31) & ~(G - 1);
  const int a = g.lane;
  SMALL_CLOCK_START;

  C* w = reinterpret_cast<C*>(smem_raw) + static_cast<size_t>(slot) * W;
  S* st = reinterpret_cast<S*>(
              smem_raw + (static_cast<size_t>(spb) * W * 8 + 15) / 16 * 16) +
          static_cast<size_t>(slot) * so.elems;
  C* Vs = w;              // V
  C* Xs = w + D * L;      // Q_xx, then the unsymmetrized V'
  C* Quu = w + 2 * D * L;
  C* QR = w + 3 * D * L;  // QuuR, then the final factor's L
  C* Qux = w + 4 * D * L;
  C* KR = w + 5 * D * L;  // QuxR, then K
  C* Fx = w + 6 * D * L;  // the step's f_x and f_u, widened
  C* Fu = w + 7 * D * L;
  C* Ws = w + 8 * D * L;  // W = V f_x, then A1 = Q_uu K
  C* Wus = w + 9 * D * L;  // W_u = V f_u
  C* cand = w + 10 * D * L;  // [2][9][D] with kBox
  C* vs = cand + (kBox ? 2 * kSmallCands * D : 0);
  C* Qxs = vs + D;
  C* Qus = vs + 2 * D;
  C* ks = vs + 3 * D;
  C* Quuks = vs + 4 * D;
  C* Dinvs = vs + 5 * D;
  // the barrier of the group's bulk copies, and the parity of its phase
  uint64_t* bar = reinterpret_cast<uint64_t*>(vs + 6 * D);
  unsigned phase = 0;
  const S* sfx = st + so.fx;
  const S* sfu = st + so.fu;
  const S* slx = st + so.lx;
  const S* slu = st + so.lu;
  const S* slxx = st + so.lxx;
  const S* sluu = st + so.luu;
  const S* slux = st + so.lux;
  const S* subar = st + so.ubar;
  const S* sfxx = st + so.fxx;
  const S* sfux = st + so.fux;
  const S* sfuu = st + so.fuu;

  const int nn = n * n, nm = n * m;
  // lane a's x-column (a < n) and u-column (a < m); a lane past them
  // computes its last one again and stores nothing
  const int ja = a < n ? a : n - 1;
  const int ca = a < m ? a : m - 1;
  const bool xo = a < n, uo = a < m;
  const int ra = a < D ? a : 0;
  for (int e = a; e < W; e += G) w[e] = 0.0;
  g.sync();
  if (a == 0) mbar_init(bar, 1);
  g.sync();
  if (xo) {
    for (int i = 0; i < n; ++i)
      Vs[i * L + a] = C(VT[static_cast<int64_t>(b) * nn + i * n + a]);
    vs[a] = C(vT[static_cast<int64_t>(b) * n + a]);
  }
  const C mu = C(mu_in[b]);
  C lo_box = 0.0, hi_box = 0.0;
  if constexpr (kBox) {
    lo_box = uo ? C(lo_in[a]) : 0.0;
    hi_box = uo ? C(hi_in[a]) : 0.0;
  }
  C dV1 = 0, dV2 = 0;  // every lane alike
  bool fail = false;   // every lane alike
  small_stage<S, G, kBox, kDdp>(g, st, so, n, m,
                                static_cast<int64_t>(b) * T + T - 1, fx, fu,
                                lx, lu, lxx, luu, lux, ubar, fxx, fux, fuu,
                                bar);

  for (int t = T - 1; t >= 0; --t) {
    const int64_t bt = static_cast<int64_t>(b) * T + t;
    cp_async_wait_all();
    mbar_wait(bar, phase);
    phase ^= 1u;
    g.sync();
    SMALL_CLOCK(5);

    // -- column ja of f_x and ca of f_u, widened (into Fx, Fu), Q_x, Q_u
    C fxc[D], fuc[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const int rr = r < n ? r : n - 1;
      const C vx = C(sfx[rr * n + ja]), vu = C(sfu[rr * m + ca]);
      fxc[r] = r < n ? vx : 0.0;
      fuc[r] = r < n ? vu : 0.0;
    }
    {
      C ax = 0, au = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) {
        ax += fxc[p] * vs[p];
        au += fuc[p] * vs[p];
      }
      if (xo) {
        Qxs[a] = C(slx[a]) + ax;
#pragma unroll
        for (int r = 0; r < D; ++r) Fx[r * L + a] = fxc[r];
      }
      if (uo) {
        Qus[a] = C(slu[a]) + au;
#pragma unroll
        for (int r = 0; r < D; ++r) Fu[r * L + a] = fuc[r];
      }
    }
    g.sync();
    SMALL_CLOCK(6);

    // -- W = V f_x[:, ja] and W_u = V f_u[:, ca] (into Ws, Wus); then
    // Q_xx[:, ja], Q_ux[:, ja], QuxR[:, ja], Q_uu[:, ca], QuuR[:, ca]
    // (QuxR and QuuR with V + mu I: W + mu f_x, W_u + mu f_u). Loops over
    // rows, each a sum over p unrolled to D (the code of a step runs once
    // a step: it must stay small)
#pragma unroll 1
    for (int p = 0; p < n; ++p) {
      C ax = 0, au = 0;
#pragma unroll
      for (int r = 0; r < D; ++r) {
        const C vpr = Vs[p * L + r];
        ax += vpr * fxc[r];
        au += vpr * fuc[r];
      }
      if (xo) Ws[p * L + a] = ax;
      if (uo) Wus[p * L + a] = au;
    }
    SMALL_CLOCK(7);
    // the lane's own columns of W and W_u, and their regularized ones
    C wc[D], wr[D], wu[D], wur[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      wc[p] = Ws[p * L + ja];
      wu[p] = Wus[p * L + ca];
      wr[p] = wc[p] + mu * fxc[p];
      wur[p] = wu[p] + mu * fuc[p];
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      C acc = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) acc += Fx[p * L + i] * wc[p];
      const C q = C(slxx[i * n + ja]) + acc;
      if (xo) Xs[i * L + a] = q;
    }
#pragma unroll 1
    for (int c = 0; c < m; ++c) {
      C ax = 0, axR = 0, au = 0, auR = 0;
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const C fpc = Fu[p * L + c];
        ax += fpc * wc[p];
        axR += fpc * wr[p];
        au += fpc * wu[p];
        auR += fpc * wur[p];
      }
      const C lx_ = C(slux[c * n + ja]), lu_ = C(sluu[c * m + ca]);
      if (xo) {
        Qux[c * L + a] = lx_ + ax;
        KR[c * L + a] = lx_ + axR;
      }
      if (uo) {
        Quu[c * L + a] = lu_ + au;
        QR[c * L + a] = lu_ + auR;
      }
    }
    // -- with kDdp, t_xx = sum_p v_p f_xx[p], t_ux, t_uu added to the
    // lane's own columns after the first-order terms, mu on QuuR's diagonal
    // last (the plain version's order)
    if constexpr (kDdp) {
      // a loop over p, each entry of the lane's column its own accumulator
      // (ascending p, as the other sums); the Hessians from the staging
      // slot, or without the box in place (one copy of the loops for each
      // address space; K6b has only the staged one: the second copy cost
      // its G = 2 and 4 instantiations their registers, and they spilled)
      C hx[D], hu[D];
      auto contract = [&](const S* bxx, const S* bux, const S* buu) {
#pragma unroll
        for (int i = 0; i < D; ++i) hx[i] = hu[i] = 0.0;
#pragma unroll 1
        for (int p = 0; p < n; ++p) {
          const C vp = vs[p];
          const S* hxx = bxx + p * nn + ja;
#pragma unroll
          for (int i = 0; i < D; ++i) {
            const int ii = i < n ? i : n - 1;
            hx[i] += vp * C(hxx[ii * n]);
          }
        }
#pragma unroll
        for (int i = 0; i < D; ++i)
          if (xo && i < n) Xs[i * L + a] += hx[i];
#pragma unroll
        for (int i = 0; i < D; ++i) hx[i] = 0.0;
#pragma unroll 1
        for (int p = 0; p < n; ++p) {
          const C vp = vs[p];
          const S* hux = bux + p * nm + ja;
          const S* huu = buu + p * m * m + ca;
#pragma unroll
          for (int c = 0; c < D; ++c) {
            const int cc = c < m ? c : m - 1;
            hx[c] += vp * C(hux[cc * n]);
            hu[c] += vp * C(huu[cc * m]);
          }
        }
      };
      if (kBox || so.hess)
        contract(sfxx, sfux, sfuu);
      else
        contract(fxx + bt * nn * n, fux + bt * nm * n, fuu + bt * m * m * n);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        if (xo && c < m) {
          Qux[c * L + a] += hx[c];
          KR[c * L + a] += hx[c];
        }
        if (uo && c < m) {
          Quu[c * L + a] += hu[c];
          QR[c * L + a] = (QR[c * L + a] + hu[c]) + (c == a ? mu : 0.0);
        }
      }
    }
    SMALL_CLOCK(8);
    // the step's box for entry a
    const C ub = (kBox && uo) ? C(subar[a]) : 0.0;
    const C lo = lo_box - ub, hi = hi_box - ub;
    g.sync();
    // the slot is read: copy step t-1's inputs under the rest of step t
    if (t > 0)
      small_stage<S, G, kBox, kDdp>(g, st, so, n, m, bt - 1, fx, fu, lx, lu,
                                    lxx, luu, lux, ubar, fxx, fux, fuu, bar);
    SMALL_CLOCK(0);

    // -- the gains: the PD probe, then without the box k from its factor,
    // with it the boxQP and the final free set's factor
    C H[D], LA[D], Lc[D];
    C dinv = 1.0;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const C h = QR[ra * L + c];
      H[c] = uo ? h : 0.0;
      LA[c] = 0.0;
      Lc[c] = 0.0;
    }
    const C q = uo ? Qus[a] : 0.0;
    const unsigned all = (1u << m) - 1u;
    // k's entry a, and the rows K is solved on (every row without the box)
    C x;
    unsigned fm = all;
    if constexpr (!kBox) {
      // the probe's factor is the one factor: Q_u's forward substitution
      // fused in, then its back substitution, k = -QuuR^-1 Q_u
      bool pfail = false;
      C y = q;
      small_factor<G, D>(g, m, H, all, true, LA, Lc, dinv, pfail, y);
      SMALL_CLOCK(1);
      fail = fail || pfail;  // the PD probe
      x = -small_back<G, D>(g, m, Lc, dinv, y);
    } else {
      x = uo ? clip(0.0, lo, hi) : 0.0;
      // one call of the factorization serves the probe (pass -1: every
      // row free), each Newton step (its free set, the forward
      // substitution of g_free fused in) and the final free set
      // (``last``); a group asks for a new factor only where its set
      // differs from the one it holds. ``fin``: the group's problem
      // converged, found no improvement or spent its iterations (x and its
      // free set stay); the warp iterates until every group's has, then
      // forms the final factors
      unsigned held = 0u;
      bool ffail = false, fin = false, frozen = false;
      C gr = 0.0;  // g = q + H x at entry a
      int par = 0;
      for (int it = -1;; ++it) {
        bool last = false, step = false;
        C gm = 0.0;
        if (it >= 0) {
          const bool fa =
              uo && !((x <= lo && gr > 0.0) || (x >= hi && gr < 0.0));
          fm = g.ballot(fa);
          gm = fa ? gr : 0.0;
          const C gfree2 = g.sum(gm * gm);
          fin = fin || frozen || gfree2 < 1e-16 || fm == 0u ||
                it >= newton_iters;
          last = g.all(fin);
          step = !fin;
        }
        const bool refactor = it < 0 || ((step || last) && fm != held);
        C y = step ? gm : 0.0;
        small_factor<G, D>(g, m, H, fm, refactor, LA, Lc, dinv, ffail, y);
        held = refactor ? fm : held;
        if (it < 0) {
          SMALL_CLOCK(1);
          fail = fail || ffail;  // the PD probe
          C acc = 0;
#pragma unroll
          for (int c = 0; c < D; ++c) acc += H[c] * g.bcast(x, c);
          gr = q + acc;
          continue;
        }
        if (last) {
          SMALL_ITERS(it);
          fail = fail || ffail;  // the final free set's factor
          break;
        }
        // the Newton step d = -(H_ff)^-1 g_free
        const C d = -small_back<G, D>(g, m, Lc, dinv, y);
        // candidates clip(x + 2^-i d), i < 8, and x itself in slot 8
        C ci[kSmallCands];
        {
          C alpha = 1.0;
#pragma unroll
          for (int i = 0; i < kSmallAlphas; ++i) {
            ci[i] = uo ? clip(x + alpha * d, lo, hi) : 0.0;
            alpha *= 0.5;
          }
          ci[kSmallAlphas] = x;
        }
        C* cb = cand + par * kSmallCands * D;
        if (uo) {
#pragma unroll
          for (int i = 0; i < kSmallCands; ++i) cb[i * D + a] = ci[i];
        }
        g.sync();
        // row a of H c for the nine candidates, and their objectives 1/2
        // c^T H c + q^T c as sums over the group of c_a (H c / 2 + q)_a
        C Hc[kSmallCands];
#pragma unroll
        for (int i = 0; i < kSmallCands; ++i) Hc[i] = 0.0;
#pragma unroll
        for (int c = 0; c < D; ++c) {
#pragma unroll
          for (int i = 0; i < kSmallCands; ++i)
            Hc[i] += H[c] * cb[i * D + c];
        }
        int best = -1;
        const C obj_now =
            g.sum(uo ? x * (0.5 * Hc[kSmallAlphas] + q) : 0.0);
#pragma unroll
        for (int i = kSmallAlphas - 1; i >= 0; --i) {
          const C obj = g.sum(uo ? ci[i] * (0.5 * Hc[i] + q) : 0.0);
          best = obj < obj_now - 1e-12 ? i : best;
        }
        par ^= 1;
        if (!fin) {
          frozen = best < 0;  // no improvement: x stays
#pragma unroll
          for (int i = 0; i < kSmallAlphas; ++i) {
            x = i == best ? ci[i] : x;
            gr = i == best ? q + Hc[i] : gr;
          }
        }
      }
    }
    SMALL_CLOCK(2);
    // the factor and k for the group's solves
    if (uo) {
#pragma unroll
      for (int c = 0; c < D; ++c)
        if (c < a) QR[a * L + c] = LA[c];
      Dinvs[a] = dinv;
      ks[a] = x;
    }
    g.sync();

    // -- K[:, ja] = -(H_ff)^-1 (free * QuxR[:, ja]), a column a lane
    C Kc[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      const C v = KR[r * L + ja];
      Kc[r] = ((fm >> r) & 1u) ? v : 0.0;
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
#pragma unroll
      for (int r = k + 1; r < D; ++r) Kc[r] -= QR[r * L + k] * Kc[k];
    }
#pragma unroll
    for (int r = 0; r < D; ++r) Kc[r] *= Dinvs[r];
#pragma unroll
    for (int k = D - 1; k > 0; --k) {
#pragma unroll
      for (int r = 0; r < k; ++r) Kc[r] -= QR[k * L + r] * Kc[k];
    }
#pragma unroll
    for (int r = 0; r < D; ++r) Kc[r] = -Kc[r];
    if (xo) {
#pragma unroll
      for (int r = 0; r < D; ++r)
        if (r < m) {
          KR[r * L + a] = Kc[r];
          if (live) K_out[bt * nm + r * n + a] = static_cast<S>(Kc[r]);
        }
    }
    // Q_uu k (lane a's row), dV1, dV2
    C quuk = 0;
#pragma unroll
    for (int c = 0; c < D; ++c) quuk += Quu[ra * L + c] * ks[c];
    if (uo) {
      Quuks[a] = quuk;
      if (live) k_out[bt * m + a] = static_cast<S>(x);
    }
    dV1 = dV1 + g.sum(uo ? x * q : 0.0);
    dV2 = dV2 + 0.5 * g.sum(uo ? x * quuk : 0.0);
    g.sync();
    SMALL_CLOCK(3);

    // -- V'[:, ja] = ((Q_xx + K^T A1) + K^T Q_ux) + Q_ux^T K with A1 = Q_uu
    // K[:, ja] (into Ws); v'[ja] = ((Q_x + K^T Q_uu k) + K^T Q_u) + Q_ux^T k
#pragma unroll 1
    for (int c = 0; c < m; ++c) {
      C acc = 0;
#pragma unroll
      for (int e = 0; e < D; ++e) acc += Quu[c * L + e] * Kc[e];
      if (xo) Ws[c * L + a] = acc;
    }
    C a1c[D], quxc[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      a1c[c] = Ws[c * L + ja];
      quxc[c] = Qux[c * L + ja];
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      C s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const C kci = KR[c * L + i];
        s1 += kci * a1c[c];
        s2 += kci * quxc[c];
        s3 += Qux[c * L + i] * Kc[c];
      }
      const C v = ((Xs[i * L + ja] + s1) + s2) + s3;
      if (xo) Xs[i * L + a] = v;
    }
    {
      C s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s1 += Kc[c] * Quuks[c];
        s2 += Kc[c] * Qus[c];
        s3 += quxc[c] * ks[c];
      }
      if (xo) vs[a] = ((Qxs[a] + s1) + s2) + s3;
    }
    g.sync();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const C v = 0.5 * (Xs[i * L + ja] + Xs[ja * L + i]);
      if (xo) Vs[i * L + a] = v;
    }
    SMALL_CLOCK(4);
    // the next step's wait and barrier order these writes before its reads
  }

  SMALL_CLOCK_END;
  if (live && a == 0) {
    dV1_out[b] = static_cast<S>(dV1);
    dV2_out[b] = static_cast<S>(dV2);
    fail_out[b] = fail ? S(1) : S(0);
  }
}

// A launch plan (ops/riccati_small.py small_plan): lanes a scenario,
// scenarios a block, whether the Hessians are staged (with kDdp; else read
// in place) and the block's dynamic shared bytes, each of which must equal
// what this source computes for it.
struct SmallPlan {
  int groups, spb, stage_h;
  long long smem_bytes;
};

template <typename S, bool kBox, bool kDdp, int G>
int small_launch(int n, int m, int T, int B, int iters, const void* const* in,
                 void* const* out, const SmallPlan& p, cudaStream_t stream) {
  auto kernel = riccati_small_kernel<S, kBox, kDdp, G>;
  const long long bytes = p.smem_bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto P = [in](int i) { return static_cast<const S*>(in[i]); };
  SmallStage so(n, m, sizeof(S), kDdp, kBox, p.stage_h != 0);
  {
    // the staged arrays' inputs, in the order of small_stage
    const int idx[11] = {0, 1, 2, 3, 4, 5, 6, 8, 11, 12, 13};
    const long long count[11] = {n * n, n * m, n, m, n * n, m * m, n * m, m,
                                 n * n * n, n * m * n, n * m * m};
    for (int q = 0; q < (so.hess ? 11 : 8); ++q) {
      if (q == 7 && !kBox) continue;  // no ubar
      const long long bytes = count[q] * static_cast<long long>(sizeof(S));
      if (bytes % 16 != 0 ||
          reinterpret_cast<uintptr_t>(in[idx[q]]) % 16 != 0)
        continue;
      if (bytes >= kSmallBulkMin) {
        so.bulk |= 1u << q;
        so.bulk_bytes += static_cast<unsigned>(bytes);
      } else {
        so.vec |= 1u << q;
      }
    }
  }
  kernel<<<blocks_for(B, p.spb), G * p.spb, static_cast<size_t>(bytes),
           stream>>>(P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7), P(8),
                     P(9), P(10), P(11), P(12), P(13), P(14), P(15),
                     static_cast<S*>(out[0]), static_cast<S*>(out[1]),
                     static_cast<S*>(out[2]), static_cast<S*>(out[3]),
                     static_cast<S*>(out[4]), n, m, T, B, iters, p.spb, so);
  return static_cast<int>(cudaGetLastError());
}

// Call f(S(), std::integral_constant<int, G>()) at the input type of
// ``dtype`` and the plan's lanes a scenario G (2, 4, 8 or 16).
template <typename F>
int small_dispatch(int dtype, int groups, F&& f) {
  auto at = [&](auto s) {
    switch (groups) {
      case 2: return f(s, std::integral_constant<int, 2>());
      case 4: return f(s, std::integral_constant<int, 4>());
      case 8: return f(s, std::integral_constant<int, 8>());
      case 16: return f(s, std::integral_constant<int, 16>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  return dtype == kFloat32 ? at(float()) : at(double());
}

// Whether ``p`` is this variant's plan at (n, m): the lanes and shared bytes
// this source computes for it (small_groups, small_smem_bytes), a block of
// whole warps within the kernel's threads and shared bytes, the Hessians
// staged with the box.
template <bool kBox, bool kDdp>
bool small_plan_ok(int dtype, int n, int m, const SmallPlan& p) {
  if (dtype != kFloat32 && dtype != kFloat64) return false;
  const size_t s_bytes = dtype == kFloat64 ? 8 : 4;
  const int G = small_groups(n, m);
  return G != 0 && p.groups == G && p.spb >= 1 &&
         (!kBox || p.stage_h != 0) &&
         G * p.spb <= kSmallMaxThreads && G * p.spb % 32 == 0 &&
         p.smem_bytes ==
             small_smem_bytes(n, m, s_bytes, kDdp, p.spb, kBox,
                              p.stage_h != 0) &&
         p.smem_bytes <= static_cast<long long>(kSmallMaxSmem);
}

// in: fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, fxx, fux, fuu, VT,
// vT (ubar, lo, hi null without kBox; fxx, fux, fuu null without kDdp);
// out: K, k, dV1, dV2, fail. The plan must be this variant's at (n, m)
// (small_plan_ok), or the launch is refused. ``iters`` (the boxQP's
// Newton iterations) is read only with kBox.
template <bool kBox, bool kDdp>
int small_entry(int dtype, int n, int m, int T, int B, int iters,
                const void* const* in, void* const* out, const SmallPlan& p,
                void* stream) {
  if (!small_plan_ok<kBox, kDdp>(dtype, n, m, p) || T < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBox && (in[8] == nullptr || in[9] == nullptr || in[10] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kDdp && (in[11] == nullptr || in[12] == nullptr || in[13] == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return small_dispatch(dtype, p.groups, [&](auto st, auto g) {
    return small_launch<decltype(st), kBox, kDdp, decltype(g)::value>(
        n, m, T, B, iters, in, out, p, s);
  });
}

// The blocks of plan ``p`` that an SM holds at once, as the runtime
// computes them for this variant's kernel (its registers, the plan's
// threads and shared bytes): cudaOccupancyMaxActiveBlocksPerMultiprocessor.
// Minus the CUDA error where the query fails; minus cudaErrorInvalidValue
// for a plan that is not this variant's at (n, m).
template <bool kBox, bool kDdp>
int small_blocks_per_sm(int dtype, int n, int m, const SmallPlan& p) {
  if (!small_plan_ok<kBox, kDdp>(dtype, n, m, p))
    return -static_cast<int>(cudaErrorInvalidValue);
  return small_dispatch(dtype, p.groups, [&](auto st, auto g) {
    auto kernel = riccati_small_kernel<decltype(st), kBox, kDdp,
                                       decltype(g)::value>;
    cudaError_t err = cudaSuccess;
    if (p.smem_bytes > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(p.smem_bytes));
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, decltype(g)::value * p.spb,
          static_cast<size_t>(p.smem_bytes));
    return err == cudaSuccess ? blocks : -static_cast<int>(err);
  });
}

}  // namespace
}  // namespace tfmpc
