// K2, K3, K5 and K8: the closed-loop rollouts of the iLQR line search.
//
// Replaces: tfmpc_tpu/ops/rollout_pallas.py:linesearch_costs_pallas (body
// _costs_kernel) as K2, rollout_pallas.py:rollout_alpha_pallas (body
// _materialize_kernel) as K3, rollout_pallas.py:
// linesearch_costs_traj_pallas (body _costs_traj_kernel) as K5, and
// rollout_pallas.py:rollout_alpha_derivs_pallas (body
// _materialize_derivs_kernel) as K8.
//
// All roll u_t = clip(ubar_t + alpha k_t + K_t (x_t - xbar_t)), x_{t+1} =
// step(x_t, u_t), J += cost(x_t) from x_0 = xbar_0, and add the final cost
// once at T. The clip to [lo, hi] applies when the env has bounds (lo/hi
// are null otherwise), after the affine law, as rollout_pallas.py's
// has_bounds clip does; it keeps NaN. The env step is a functor from
// envs.cuh, dispatched on env_id; n = m in {2, 3, 5, 6}, and 12 and 16
// for HVAC. K2 rolls every (scenario, alpha) of an alpha grid and writes
// J [A, B]; K3 rolls each scenario at its own alpha [B] and writes X [T, n,
// B], U [T, m, B] and J [B]; K5 is K2 that also stores x_{t+1} and u_t of
// every alpha at rows a*n + i and a*m + c of step t ([T, A*n, B], [T, A*m,
// B]); K8 is K3 that also writes the env's closed-form linearization at
// each step's (x_t, clipped u_t): the seven [T, entries, B] blocks of the
// Riccati kernels' input layout, n^2 + n m + n + m + n^2 + m^2 + m n
// entries, 24 values a step at n = m = 2 besides K3's 4 outputs
// (navigation only: its functor's derivs_prep and derivs_row).
//
// The running cost J is summed in double for both dtypes and rounded once
// to the output's: in float32 a sequential sum over T=500 steps drifts by
// several ulps of J (one ulp is 0.0078 at reservoir-5's J of ~8.4e4), more
// than the late iterations' cost decreases, and the line search then
// rejects steps that a correctly rounded total accepts. (The plain versions
// take torch's pairwise sum, whose error stays near one ulp.) In float64
// the sum is the plain sequential one.
//
// What bounds them on this card: each rollout is a serial chain of T
// dependent steps, so the kernels are latency-bound. Per step a rollout
// reads n + m + m*n + m inputs (10 scalars at n = m = 2, 54 at n = m = 6);
// K2 writes only J [A, B] (45,056 values at B=4096, A=11), K3 writes X, U
// and J. Their traffic is tens of MB, below what HBM moves in the time of
// the chain. K5 at reservoir-5, T=500, B=1024, A=11 reads ~82 MB and
// writes ~225 MB of trajectories, and K8 at the navigation headline
// (B=4096, T=100, f32) moves ~62 MB: their bounds are bytes (~0.09 ms,
// ~0.019 ms), but they too are chains of T dependent steps.
//
// What the design does about it: the four are one tile kernel,
// rollout_tile_kernel, of four kinds (RolloutKind: kCosts K2, kAlpha K3,
// kTraj K5, kDerivs K8). A block holds ``spb`` scenarios and, for K2 and
// K5, all A alphas of each (the TPU kernel's one staged tile for every
// alpha of a lane block), so the A rollouts of a scenario read one copy of
// its inputs. The block's last warp only copies: it brings the inputs of
// steps t+1 .. t+D into a ring of D+2 buffers in shared memory with
// cp.async while the compute warps work on step t (16- or 8-byte copies
// where the batch and the pointers are aligned, element copies otherwise),
// one block barrier a step. A block's rows are segments of spb values
// spaced B apart, so the copies are many short requests; issued by the
// compute warps they took 16-65% of a step (phase clocks, PERF.md). The
// env's parameters and the box (-inf, +inf for an unbounded env) are
// copied into shared memory once a block and the step functor reads that
// copy. A rollout runs on a group of G consecutive lanes of a warp: lane l
// computes the control rows c = l, l + G, ... and the next-state rows i =
// l, l + G, ... (the env's row(), envs.cuh), and the group exchanges u
// and x_{t+1} by shuffles, so every lane holds the whole state; the stage
// cost is computed alike on every lane. Each lane stores its own rows of
// X and U (K3, K8; K5 at its alpha's rows), so a warp's store of a row is
// a segment of consecutive scenarios (32 / G where spb allows). K8's
// linearization is off the chain: after the rollouts, the whole block
// reads its scenarios' x_t and u_t back from its own stores and writes
// the seven blocks, a (step, scenario) a thread (derivs_tail); written
// inside the step loop by each lane (derivs_prep and derivs_row on the
// chain, PERF.md), they took 70% of a step.
// The plan (G, spb, D and the block's shared bytes, ops/rollout.py
// rollout_plan, one table row per kind and dim) spreads B over the SMs;
// the C side recomputes the shared bytes and refuses a plan that
// disagrees. Each thread takes its alpha once: K2's and K5's from the
// kernel's argument by constant indices (no local-memory copy of the
// array), K3's and K8's from alpha [B].
// The arithmetic is that of the one-thread kernels they replaced (commit
// 0bac190 for K2 and K3, 5ff9ffd for K5 and K8), bit for bit: the policy
// row (ubar + alpha k) + sum_i K_ci dx_i in ascending i, each env row in
// its order, the stage cost summed over i in order, the running sum in
// double rounded once, the linearization's expressions as they were; only
// the mapping and the data movement changed.
//
// This header holds the kernel and its dispatch; each .cu instantiates
// its own kinds and dims so the parallel build compiles them side by
// side: rollout.cu K2 and K3 at n = m in {2, 3, 5, 6} for every env (and
// the C entries), rollout_traj.cu K5 there, rollout_n12.cu and
// rollout_n16.cu those three with the HVAC step at n = m = 12 and 16
// (HVAC-12, HVAC-16), rollout_derivs.cu K8 with the navigation step at
// n = m in {2, 3, 5, 6} (and its C entry).
#pragma once

#include <utility>

#include "envs.cuh"
#include "warp.cuh"

namespace tfmpc {
namespace {

constexpr int kMaxAlphas = 32;

template <typename S>
struct Alphas {
  S v[kMaxAlphas];
};

// -- the tile kernel ----------------------------------------------------------

constexpr int kTileMaxThreads = 1024;       // ops/rollout.py TILE_MAX_THREADS
constexpr int kWarp = 32;                   // the producer warp's threads
constexpr int kTileMaxSpb = 32;             // scenarios a block: 1, 2, .., 32
constexpr int kTileMaxDepth = 6;            // steps staged ahead: 1 .. 6
constexpr long long kTileMaxSmem = 232448;  // a block's shared memory

// The rows of a staged step, each ``stride`` values wide (a block's
// scenarios side by side): xbar [N], ubar [M], k [M], then K transposed,
// row K + i*M + c holding K_ci, so the lanes of a group (consecutive c)
// read consecutive rows.
template <int N, int M>
struct TileRows {
  static constexpr int xbar = 0, ubar = N, k = N + M, K = N + 2 * M,
                       total = N + 2 * M + N * M;
};

// The row stride of the ring, in values: spb, rounded so that a warp's
// reads of rows r, r + 1, ... (one per lane of a group, for the 32 / G
// rollouts of the warp) fall on distinct banks where the 16-byte copies
// allow it. ops/rollout.py tile_stride mirrors it.
__host__ __device__ inline int tile_stride(int spb, int groups,
                                           int itemsize) {
  const int w = 32 / groups;  // rollouts a warp
  const int vmax = spb < 16 / itemsize ? spb : 16 / itemsize;
  if (groups == 1 || spb <= w || w % vmax != 0) return spb;
  return spb + w;  // an odd multiple of w
}

// A tile block's dynamic shared bytes: the env's parameters and the box
// (rounded to 16 bytes), then the ring of depth + 2 staged steps.
// ops/rollout.py rollout_smem_bytes computes the same sum.
inline long long tile_smem_bytes(int itemsize, int n, int m, int groups,
                                 int spb, int depth, int param_elems) {
  const int chunk = 16 / itemsize;
  const long long par = (param_elems + 2 * m + chunk - 1) / chunk * chunk;
  const long long rows = n + 2 * m + n * m;
  return (par + (depth + 2) * rows * tile_stride(spb, groups, itemsize)) *
         itemsize;
}

// The kinds of the tile kernel, and of a rollout C call.
enum RolloutKind { kCosts = 0, kAlpha = 1, kTraj = 2, kDerivs = 3 };

// The kinds that roll A alphas of each scenario (the others one, at the
// scenario's own alpha).
__host__ __device__ constexpr bool every_alpha(int kind) {
  return kind == kCosts || kind == kTraj;
}

template <typename S>
struct TileArgs {
  const S *xbar, *ubar, *K, *k, *lo, *hi;
  const S* alpha;  // K3, K8: each scenario's alpha [B]
  // K3, K8: X [T, n, B], U [T, m, B], J [B]; K2: J [A, B]; K5: J [A, B],
  // X [T, A*n, B], U [T, A*m, B]
  S *X, *U, *J;
  LinOut<S> lin;  // K8
  int T, B, A, spb, depth, stride, vec_bytes;
  Alphas<S> alphas;  // K2, K5
#ifdef TFMPC_ROLLOUT_CLOCKS
  unsigned long long* clocks;
#endif
};

// Phase clocks of the tile kernels, built only with TFMPC_ROLLOUT_CLOCKS
// (tools/kernel_versions.py rollout --clocks): each thread adds the SM
// cycles of each phase of its steps to clocks[phase] and 1 to
// clocks[slot]: the producer warp's 0 issuing the copies and 1 waiting for
// step t's and the barrier (slot 5), the compute warps' 1 waiting at the
// barrier, 2 dx and the policy rows, 3 the u exchange, prep and the env
// rows, 4 the cost, the stores, the x exchange and the sum (slot 7). A
// stall counts in the phase of the instruction that waits.
#ifdef TFMPC_ROLLOUT_CLOCKS
#define TFMPC_TILE_CLOCKS_BEGIN      \
  unsigned long long tile_ph[5] = {}; \
  long long tile_clk = clock64();
#define TFMPC_TILE_PHASE(p)              \
  {                                      \
    const long long now = clock64();     \
    tile_ph[p] += now - tile_clk;        \
    tile_clk = now;                      \
  }
#define TFMPC_TILE_CLOCKS_END(slot)                                   \
  if (a.clocks != nullptr) {                                          \
    for (int p = 0; p < 5; ++p)                                       \
      if (tile_ph[p]) atomicAdd(a.clocks + (slot == 5 && p == 1 ? 6 : p), \
                                tile_ph[p]);                          \
    atomicAdd(a.clocks + slot, 1ull);                                 \
  }
#else
#define TFMPC_TILE_CLOCKS_BEGIN
#define TFMPC_TILE_PHASE(p)
#define TFMPC_TILE_CLOCKS_END(slot)
#endif

__device__ __forceinline__ void cp_async_chunk(void* smem, const void* gmem,
                                               int bytes) {
  if (bytes == 16)
    cp_async<16>(smem, gmem);
  else if (bytes == 8)
    cp_async<8>(smem, gmem);
  else
    cp_async<4>(smem, gmem);
}

// A thread's share of the copies of a step, fixed for the whole launch:
// chunk q of the rows e_first, e_first + e_step, ... of the block's tile
// (consecutive threads, consecutive addresses). A chunk is ve values
// (vec_bytes): the batch and the pointers are aligned to it, so a chunk
// lies wholly inside or outside the batch.
struct TileCopier {
  int ve, q, e_first, e_step, bq;
  bool on;
};

template <typename S>
__device__ __forceinline__ TileCopier tile_copier(const TileArgs<S>& a,
                                                  int b0, int tid,
                                                  int nthr) {
  TileCopier c;
  c.ve = a.vec_bytes / static_cast<int>(sizeof(S));
  const int cpr = a.spb / c.ve;  // chunks a row, a power of two
  c.q = tid & (cpr - 1);
  c.e_first = tid / cpr;
  c.e_step = nthr / cpr;
  c.bq = b0 + c.q * c.ve;
  c.on = c.bq < a.B;
  return c;
}

// Copy step t's inputs of the block's scenarios into ``buf``.
template <typename S, int N, int M>
__device__ __forceinline__ void stage_tile_step(const TileArgs<S>& a, S* buf,
                                                int t, const TileCopier& c) {
  using R = TileRows<N, M>;
  if (!c.on) return;
  S* to = buf + c.q * c.ve;
  for (int e = c.e_first; e < R::total; e += c.e_step) {
    const S* from;
    int row = e;
    if (e < R::ubar) {
      from = a.xbar + at(t, e, N, c.bq, a.B);
    } else if (e < R::k) {
      from = a.ubar + at(t, e - R::ubar, M, c.bq, a.B);
    } else if (e < R::K) {
      from = a.k + at(t, e - R::k, M, c.bq, a.B);
    } else {
      const int ek = e - R::K;  // entry c*N + i of the [T, M*N, B] input
      from = a.K + at(t, ek, M * N, c.bq, a.B);
      row = R::K + (ek % N) * M + ek / N;
    }
    cp_async_chunk(to + row * a.stride, from, a.vec_bytes);
  }
}

// u_c = clip((ubar_c + alpha k_c) + sum_i K_ci dx_i), from the staged step
// (``in``: the scenario's column), as policy_control computes it; an
// unbounded env's box is -inf, +inf, which leaves every value as it is.
template <typename S, int N, int M>
__device__ __forceinline__ S policy_row(const S* in, int st, int c, S alpha,
                                        S lo, S hi, const S (&dx)[N]) {
  using R = TileRows<N, M>;
  const S base = in[(R::ubar + c) * st] + alpha * in[(R::k + c) * st];
  S acc = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) acc += in[(R::K + i * M + c) * st] * dx[i];
  return clip(base + acc, lo, hi);
}

// lane ``src``'s v within the group of G lanes (G == 1: v)
template <int G, typename S>
__device__ __forceinline__ S from_lane(S v, int src) {
  if constexpr (G == 1)
    return v;
  else
    return __shfl_sync(kFullMask, v, src, G);
}

// K8's linearization of the block's scenarios, after their rollouts (every
// thread of the block, the producer warp's too): step t of scenario b at
// its pre-step state and clipped control, read back from the block's own
// stores (x_t from X [t-1], x_0 from xbar, u_t from U [t]), which the
// barrier makes visible to the block. Thread tid takes scenario b0 + tid %
// spb at the steps tid / spb, + nthr / spb, ... (nthr is a multiple of
// spb): the steps are independent, so the work runs at the block's width
// instead of on the rollout's serial chain. The values are the registers
// the rollout stored, so the expressions (prep, derivs_prep, derivs_row)
// give the bits they give there.
template <typename S, int N, int M, class Env>
__device__ __forceinline__ void derivs_tail(const TileArgs<S>& a,
                                            const Env& env, int b0, int tid,
                                            int nthr) {
  __syncthreads();  // the block's X and U stores are visible
  const int b = b0 + (tid & (a.spb - 1));
  if (b >= a.B) return;
  const int64_t B = a.B;
#pragma unroll 1
  for (int t = tid / a.spb; t < a.T; t += nthr / a.spb) {
    const S* xs = t == 0 ? a.xbar : a.X + at(t - 1, 0, N, 0, a.B);
    S x[N], u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = xs[i * B + b];
#pragma unroll
    for (int c = 0; c < M; ++c) u[c] = a.U[at(t, c, M, b, a.B)];
    const auto dpre = env.derivs_prep(env.prep(x), x);
#pragma unroll
    for (int i = 0; i < N; ++i)
      env.derivs_row(dpre, i, x[i], u[i], a.lin, t, b, a.B);
  }
}

// The tile kernel of kind kKind: K2 (kCosts: the block's spb scenarios
// times A alphas, J [A, B]), K5 (kTraj: K2's rollouts, also every alpha's
// X and U), K3 (kAlpha: one rollout a scenario at its own alpha, X, U and
// J) or K8 (kDerivs: K3's rollouts, then the linearization,
// derivs_tail). Compute
// thread tid is lane tid % G of rollout tid / G; rollout r is scenario b0
// + r % spb at alpha r / spb. The threads past the last rollout (the
// compute threads are whole warps) and the scenarios past B run the steps
// on staged values that nobody reads and store nothing. The last warp
// copies the inputs (see the producer branch).
template <typename S, int N, int M, int G, class Env, int kKind>
__global__ void rollout_tile_kernel(const TileArgs<S> a, Env env) {
  static_assert(N == M, "the rollout kernels run n = m");
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16,
                "G in {1, 2, 4, 8, 16}");
  using R = TileRows<N, M>;
  constexpr int RN = (N + G - 1) / G;  // rows a lane owns
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * a.spb;

  // the env's parameters and the box, once a block; the functor reads the
  // copy (the first step's barrier orders these stores before any read)
  S* par = reinterpret_cast<S*>(tile_smem);
  int off = 0;
  env.each_param([&](auto& ptr, int len) {
    for (int j = tid; j < len; j += nthr) par[off + j] = ptr[j];
    ptr = par + off;
    off += len;
  });
  S* box = par + off;  // lo [M], hi [M]; -inf, +inf when unbounded
  for (int j = tid; j < M; j += nthr) {
    box[j] = a.lo != nullptr ? a.lo[j] : -dinf<S>();
    box[M + j] = a.hi != nullptr ? a.hi[j] : dinf<S>();
  }
  constexpr int kChunk = 16 / static_cast<int>(sizeof(S));
  S* ring = par + (off + 2 * M + kChunk - 1) / kChunk * kChunk;
  const int step_elems = R::total * a.stride;
  const int bufs = a.depth + 2;

  const int ncomp = nthr - kWarp;       // the compute warps' threads

  const bool producer = tid >= ncomp;  // the copying warp
  const int lane = tid & (G - 1);
  const int roll = tid / G;
  const int s = roll % a.spb;
  const int ai = roll / a.spb;
  const int b = b0 + s;
  constexpr bool kEvery = every_alpha(kKind);
  const bool live = !producer && ai < (kEvery ? a.A : 1) && b < a.B;
  S alpha = 0;
  if constexpr (kEvery) {
#pragma unroll
    for (int j = 0; j < kMaxAlphas; ++j)
      if (j == ai) alpha = a.alphas.v[j];
  } else if (live) {
    alpha = a.alpha[b];
  }

  // The last warp is the producer: it copies step u's inputs into buffer
  // u % bufs ``depth`` steps before step u computes (one commit group a
  // step, empty past T), waits for step t's and meets the compute warps at
  // step t's barrier. Buffer (t + depth) % bufs, written as the compute
  // warps work on step t - 1, was last read by step t - 2, which every
  // compute thread finished before step t - 1's barrier.
  if (producer) {
    const TileCopier copier = tile_copier(a, b0, tid - ncomp, kWarp);
    for (int d = 0; d < a.depth; ++d) {
      if (d < a.T)
        stage_tile_step<S, N, M>(a, ring + d * step_elems, d, copier);
      cp_async_commit();
    }
    cp_async_wait_pending(a.depth - 1);
    __syncthreads();  // step 0's inputs and the parameters have landed
    TFMPC_TILE_CLOCKS_BEGIN
    int next = a.depth;  // the buffer of step t + depth
#pragma unroll 1
    for (int t = 0; t < a.T; ++t) {
      if (t + a.depth < a.T)
        stage_tile_step<S, N, M>(a, ring + next * step_elems, t + a.depth,
                                 copier);
      cp_async_commit();
      TFMPC_TILE_PHASE(0)
      cp_async_wait_pending(a.depth);  // step t's group has landed
      __syncthreads();                 // for the compute warps
      TFMPC_TILE_PHASE(1)
      next = next + 1 == bufs ? 0 : next + 1;
    }
    TFMPC_TILE_CLOCKS_END(5)
    if constexpr (kKind == kDerivs) derivs_tail<S, N, M>(a, env, b0, tid, nthr);
    return;
  }

  S x[N], xo[RN];    // the state, whole, and at this lane's rows
  S lo[RN], hi[RN];  // the box at this lane's rows
  __syncthreads();   // step 0's inputs and the parameters have landed
  {
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int c = lane + G * r < M ? lane + G * r : M - 1;
      lo[r] = box[c];
      hi[r] = box[M + c];
    }
    const S* in = ring + s;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = in[(R::xbar + i) * a.stride];
#pragma unroll
    for (int r = 0; r < RN; ++r)
      xo[r] = lane + G * r < N ? in[(R::xbar + lane + G * r) * a.stride]
                               : S(0);
  }
  double total = 0;
  int cur = 0;  // the buffer of step t
  TFMPC_TILE_CLOCKS_BEGIN
#pragma unroll 1
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();  // step t's inputs have landed
    TFMPC_TILE_PHASE(1)

    const S* in = ring + cur * step_elems + s;
    const int st = a.stride;
    S dx[N];
#pragma unroll
    for (int i = 0; i < N; ++i) dx[i] = x[i] - in[(R::xbar + i) * st];
    S uo[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int c = lane + G * r;
      uo[r] = G * (r + 1) <= M || c < M
                  ? policy_row<S, N, M>(in, st, c, alpha, lo[r], hi[r], dx)
                  : S(0);
    }
    TFMPC_TILE_PHASE(2)
    S u[M];
#pragma unroll
    for (int c = 0; c < M; ++c) u[c] = from_lane<G>(uo[c / G], c % G);
    const auto pre = env.prep(x);
    S xn[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int i = lane + G * r;
      xn[r] = G * (r + 1) <= N || i < N
                  ? env.row(pre, i, x, u, xo[r], uo[r])
                  : S(0);
    }
    TFMPC_TILE_PHASE(3)
    const S cost = env.stage_cost(x, u);
    if constexpr (kKind != kCosts) {
      const int row0 = kKind == kTraj ? ai * N : 0;
      const int rows = kKind == kTraj ? a.A * N : N;
      if (live) {  // K5: alpha ai's rows of [T, A*n, B] and [T, A*m, B]
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const int i = lane + G * r;
          if (G * (r + 1) <= N || i < N) {
            a.X[at(t, row0 + i, rows, b, a.B)] = xn[r];
            a.U[at(t, row0 + i, rows, b, a.B)] = uo[r];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = from_lane<G>(xn[i / G], i % G);
#pragma unroll
    for (int r = 0; r < RN; ++r) xo[r] = xn[r];
    total += static_cast<double>(cost);
    cur = cur + 1 == bufs ? 0 : cur + 1;
    TFMPC_TILE_PHASE(4)
  }
  TFMPC_TILE_CLOCKS_END(7)
  if (live && lane == 0)
    a.J[kEvery ? static_cast<int64_t>(ai) * a.B + b : b] =
        static_cast<S>(total + static_cast<double>(env.final_cost(x)));
  if constexpr (kKind == kDerivs) derivs_tail<S, N, M>(a, env, b0, tid, nthr);
}

// The copy width: the widest of 16, 8 and 4 bytes that a block's row of
// spb values, the batch's rows and the four input pointers are aligned to.
template <typename S>
int tile_vec_bytes(const TileArgs<S>& a) {
  for (int vb : {16, 8, 4}) {
    if (vb < static_cast<int>(sizeof(S)) ||
        vb > a.spb * static_cast<int>(sizeof(S)) ||
        static_cast<long long>(a.B) * sizeof(S) % vb != 0)
      continue;
    bool aligned = true;
    for (const void* ptr : {static_cast<const void*>(a.xbar),
                            static_cast<const void*>(a.ubar),
                            static_cast<const void*>(a.K),
                            static_cast<const void*>(a.k)})
      aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % vb == 0;
    if (aligned) return vb;
  }
  return static_cast<int>(sizeof(S));
}

}  // namespace

// A tile launch's plan (ops/rollout.py RolloutPlan): G lanes a rollout,
// spb scenarios a block, depth steps staged ahead, the shared bytes.
struct TilePlan {
  int groups, spb, depth;
  long long smem_bytes;
};

#ifdef TFMPC_ROLLOUT_CLOCKS
// the phase-clock counters (device, 16), set by tfmpc_rollout_clocks_buffer
extern unsigned long long* tile_clocks;
#endif

// One call of a rollout C entry, of kind RolloutKind.
struct RolloutCall {
  int kind, dtype, env, n, m, T, B;
  const void *xbar, *ubar, *K, *k, *lo, *hi;
  const double* alphas;  // K2, K5 (host)
  int A;
  const void* alpha;  // K3, K8 (device, [B])
  const void* const* params;
  int n_params;
  const int* int_params;
  int n_int_params;
  void *J, *X, *U;
  void* const* lin;  // K8: fx, fu, lx, lu, lxx, luu, lux (host array)
  TilePlan plan;
  cudaStream_t stream;
  // where non-null, receives the most threads a block of the plan's G can
  // launch with (its registers bound it), and nothing runs
  int* max_threads;
};

namespace {

// The G of ops/rollout.py ROLLOUT_PLANS, per kind and dim: the G each
// source instantiates (with TFMPC_ROLLOUT_ALL_G, the sweep's build, a mask
// of kinds, bit k for kind k: every G of those kinds at each dim's swept
// env too).
struct PlanGroups {
  int kind, n, groups;
};
constexpr PlanGroups kPlanGroups[] = {
    {kCosts, 2, 1},   {kCosts, 3, 1},   {kCosts, 5, 4},    {kCosts, 6, 2},
    {kCosts, 12, 4},  {kCosts, 16, 2},  {kAlpha, 2, 2},    {kAlpha, 3, 4},
    {kAlpha, 5, 8},   {kAlpha, 6, 8},   {kAlpha, 12, 4},   {kAlpha, 16, 16},
    {kTraj, 2, 1},    {kTraj, 3, 1},    {kTraj, 5, 4},     {kTraj, 6, 2},
    {kTraj, 12, 2},   {kTraj, 16, 4},   {kDerivs, 2, 2},   {kDerivs, 3, 1},
    {kDerivs, 5, 2},  {kDerivs, 6, 2}};

constexpr int plan_groups(int kind, int n) {
  for (const PlanGroups& p : kPlanGroups)
    if (p.kind == kind && p.n == n) return p.groups;
  return 0;
}

// the largest G that gives a lane at least one row: 2 at n = 2, 4 at 3,
// 8 at 5 and 6, 16 at 12 and 16
constexpr int max_groups(int n) {
  int g = 1;
  while (g < n && g < 16) g *= 2;
  return g;
}

template <int N, int G, class F>
int with_group_upto(int groups, F&& f) {
  if constexpr (G > max_groups(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (groups == G) return f(std::integral_constant<int, G>{});
    return with_group_upto<N, G * 2>(groups, static_cast<F&&>(f));
  }
}

// Calls f(std::integral_constant<int, G>) for the plan's G, if instantiated.
template <int kKind, int N, class Env, class F>
int with_groups(int groups, F&& f) {
#ifdef TFMPC_ROLLOUT_ALL_G
  // the sweep's env at each dim: navigation at 2, reservoir at 5, HVAC at
  // 3, 6, 12 and 16 (tools/kernel_versions.py rollout --sweep); K8's,
  // navigation at every dim
  constexpr int swept = kKind == kDerivs ? kNavigation
                        : N == 2         ? kNavigation
                        : N == 5         ? kReservoir
                                         : kHVAC;
  if constexpr (Env::kId == swept && ((TFMPC_ROLLOUT_ALL_G) >> kKind & 1))
    return with_group_upto<N, 1>(groups, static_cast<F&&>(f));
#endif
  constexpr int G = plan_groups(kKind, N);
  static_assert(G > 0, "a rollout kind and dim without a plan");
  if (groups == G) return f(std::integral_constant<int, G>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S, int N, int G, int kKind, class Env>
int launch_tile(TileArgs<S> a, const Env& env, const TilePlan& plan,
                cudaStream_t stream, int* max_threads) {
  auto kernel = rollout_tile_kernel<S, N, N, G, Env, kKind>;
  static int kernel_max_threads = 0;  // this instantiation's, by registers
  if (kernel_max_threads == 0) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel_max_threads = attr.maxThreadsPerBlock;
  }
  if (max_threads != nullptr) {
    *max_threads = kernel_max_threads < kTileMaxThreads ? kernel_max_threads
                                                        : kTileMaxThreads;
    return 0;
  }
  const int threads =
      (a.spb * (every_alpha(kKind) ? a.A : 1) * G + kWarp - 1) / kWarp *
          kWarp +
      kWarp;
  const long long bytes =
      tile_smem_bytes(sizeof(S), N, N, G, a.spb, a.depth,
                      env.param_elems());
  if (bytes != plan.smem_bytes || bytes > kTileMaxSmem ||
      threads > kTileMaxThreads || threads > kernel_max_threads)
    return static_cast<int>(cudaErrorInvalidValue);

  a.stride = tile_stride(a.spb, G, sizeof(S));
  a.vec_bytes = tile_vec_bytes(a);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks_for(a.B, a.spb), threads, static_cast<size_t>(bytes),
           stream>>>(a, env);
  return static_cast<int>(cudaGetLastError());
}

// The env's step functor from its parameter pointers (the order of the
// env's device_step params), passed to f; an unknown env or a parameter
// count that does not match is refused.
template <typename S, int N, class F>
int with_env(int env, const void* const* p, int n_params, const int* ints,
             int n_ints, F&& f) {
  auto P = [p](int i) { return static_cast<const S*>(p[i]); };
  if (env == kNavigation && n_params == 3 && n_ints == 1)
    return f(NavigationStep<S, N>{P(0), P(1), P(2), ints[0]});
  if (env == kHVAC && n_params == 16 && n_ints == 0)
    return f(HVACStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                            P(8), P(9), P(10), P(11), P(12), P(13), P(14),
                            P(15)});
  if (env == kReservoir && n_params == 10 && n_ints == 0)
    return f(ReservoirStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6),
                                 P(7), P(8), P(9)});
  if (env == kLinear && n_params == 10 && n_ints == 0)
    return f(LinearStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6),
                              P(7), P(8), P(9)});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The mid dims (n = m >= 12) compile the HVAC step only: an instantiation
// there costs ~15x one at n <= 6 (nvcc took 263 s for all four envs at 12
// and 16 on one H100 host), and HVAC-12 and HVAC-16 are the paths that
// run there.
constexpr int kMidRolloutDim = 12;

template <typename S, int N, class F>
int with_env_at(int env, const void* const* p, int n_params, const int* ints,
                int n_ints, F&& f) {
  if constexpr (N >= kMidRolloutDim) {
    if (env != kHVAC || n_params != 16 || n_ints != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    auto P = [p](int i) { return static_cast<const S*>(p[i]); };
    return f(HVACStep<S, N>{P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                            P(8), P(9), P(10), P(11), P(12), P(13), P(14),
                            P(15)});
  } else {
    return with_env<S, N>(env, p, n_params, ints, n_ints,
                          static_cast<F&&>(f));
  }
}

template <int... Ns>
struct DimList {};

// Calls f(std::integral_constant<int, N>) for n == m == N in the list.
template <class F>
int with_dims(DimList<>, int, int, F&&) {
  return static_cast<int>(cudaErrorInvalidValue);
}
template <int N0, int... Ns, class F>
int with_dims(DimList<N0, Ns...>, int n, int m, F&& f) {
  if (n == N0 && m == N0) return f(std::integral_constant<int, N0>{});
  return with_dims(DimList<Ns...>{}, n, m, static_cast<F&&>(f));
}

template <int... Ks>
struct KindList {};

// The call's kind, if in the list, at dim N with the env's functor.
template <typename S, int N, class Env>
int launch_kind(KindList<>, const RolloutCall&, const TileArgs<S>&,
                const Env&) {
  return static_cast<int>(cudaErrorInvalidValue);
}
template <typename S, int N, class Env, int K0, int... Ks>
int launch_kind(KindList<K0, Ks...>, const RolloutCall& c,
                const TileArgs<S>& a, const Env& step) {
  if (c.kind != K0)
    return launch_kind<S, N>(KindList<Ks...>{}, c, a, step);
  return with_groups<K0, N, Env>(c.plan.groups, [&](auto g) {
    return launch_tile<S, N, decltype(g)::value, K0>(a, step, c.plan,
                                                     c.stream, c.max_threads);
  });
}

// The tile kernel's arguments of a call.
template <typename S>
TileArgs<S> tile_args(const RolloutCall& c) {
  TileArgs<S> a{};
  a.xbar = static_cast<const S*>(c.xbar);
  a.ubar = static_cast<const S*>(c.ubar);
  a.K = static_cast<const S*>(c.K);
  a.k = static_cast<const S*>(c.k);
  a.lo = static_cast<const S*>(c.lo);
  a.hi = static_cast<const S*>(c.hi);
  a.alpha = static_cast<const S*>(c.alpha);
  a.X = static_cast<S*>(c.X);
  a.U = static_cast<S*>(c.U);
  a.J = static_cast<S*>(c.J);
  if (c.lin != nullptr) {
    auto L = [&c](int i) { return static_cast<S*>(c.lin[i]); };
    a.lin = LinOut<S>{L(0), L(1), L(2), L(3), L(4), L(5), L(6)};
  }
#ifdef TFMPC_ROLLOUT_CLOCKS
  a.clocks = tile_clocks;
#endif
  a.T = c.T;
  a.B = c.B;
  a.A = c.A;
  a.spb = c.plan.spb;
  a.depth = c.plan.depth;
  for (int j = 0; j < c.A && c.alphas != nullptr; ++j)
    a.alphas.v[j] = static_cast<S>(c.alphas[j]);
  return a;
}

// The kinds ``Kinds`` of the call at the dims ``Dims``, every env's step
// (the HVAC step alone at the mid dims).
template <typename S, class Dims, class Kinds>
int rollout_dtype(const RolloutCall& c) {
  const TileArgs<S> a = tile_args<S>(c);
  return with_dims(Dims{}, c.n, c.m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    return with_env_at<S, N>(c.env, c.params, c.n_params, c.int_params,
                             c.n_int_params, [&](auto step) {
                               return launch_kind<S, N>(Kinds{}, c, a, step);
                             });
  });
}

}  // namespace

// The dtype dispatch over the dims ``Dims`` and kinds ``Kinds``.
template <class Dims, class Kinds>
int rollout_dims(const RolloutCall& c) {
  if (c.dtype == kFloat32) return rollout_dtype<float, Dims, Kinds>(c);
  if (c.dtype == kFloat64) return rollout_dtype<double, Dims, Kinds>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

// rollout.cu's dims (K2 and K3 there); rollout_traj.cu defines K5's entry
// at them, rollout_n12.cu and rollout_n16.cu the two mid dims' (K2, K3 and
// K5) and rollout_derivs.cu K8's, so the parallel build compiles them side
// by side. rollout_entry (rollout.cu) checks a call and sends it to the
// one that instantiates its kind and dims.
using SmallDims = DimList<2, 3, 5, 6>;
using StepKinds = KindList<kCosts, kAlpha, kTraj>;
int rollout_traj(const RolloutCall& c);
int rollout_n12(const RolloutCall& c);
int rollout_n16(const RolloutCall& c);
int rollout_derivs(const RolloutCall& c);
int rollout_entry(const RolloutCall& c);

}  // namespace tfmpc
