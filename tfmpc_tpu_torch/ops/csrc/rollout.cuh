// K2, K3 and K5: the closed-loop rollouts of the iLQR line search.
//
// Replaces: tfmpc_tpu/ops/rollout_pallas.py:linesearch_costs_pallas (body
// _costs_kernel) as K2, rollout_pallas.py:rollout_alpha_pallas (body
// _materialize_kernel) as K3, and rollout_pallas.py:
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
// for HVAC.
// K5 is K2 that also stores x_{t+1} and u_t of every alpha at rows a*n + i
// and a*m + c of step t ([T, A*n, B], [T, A*m, B]). It keeps the
// one-thread code (policy_control and the functor's step()); K2 and K3
// compute the same expressions row by row (policy_row and the functor's
// row(), which step() loops over), so K5's J is K2's and its trajectory
// of any alpha K3's at that alpha, bit for bit.
//
// The running cost J is summed in double for both dtypes and rounded once
// to the output's: in float32 a sequential sum over T=500 steps drifts by
// several ulps of J (one ulp is 0.0078 at reservoir-5's J of ~8.4e4), more
// than the late iterations' cost decreases, and the line search then
// rejects steps that a correctly rounded total accepts. (The plain versions
// take torch's pairwise sum, whose error stays near one ulp.) In float64
// the sum is the plain sequential one.
//
// What bounds them on this card: like K1, each rollout is a serial chain of
// T dependent steps, so the kernels are latency-bound. Per step a thread
// reads n + m + m*n + m inputs (10 scalars at n = m = 2, 54 at n = m = 6);
// K2 writes only J [A, B] (45,056 values at B=4096, A=11), K3 writes X, U
// and J. Total traffic is tens of MB, below what HBM moves in the time of
// the chain.
//
// What the design does about it (K2 and K3, the tile kernels below): a
// block holds ``spb`` scenarios and, for K2, all A alphas of each (the TPU
// kernel's one staged tile for every alpha of a lane block), so the A
// rollouts of a scenario read one copy of its inputs. The block's last
// warp only copies: it brings the inputs of steps t+1 .. t+D into a ring
// of D+2 buffers in shared memory with cp.async while the compute warps
// work on step t (16- or 8-byte copies where the batch and the pointers
// are aligned, element copies otherwise), one block barrier a step. A
// block's rows are segments of spb values spaced B apart, so the copies
// are many short requests; issued by the compute warps they took 16-65%
// of a step (phase clocks, PERF.md). The env's parameters and the box
// (-inf, +inf for an unbounded env) are copied into shared memory once a
// block and the step functor reads that copy. A rollout runs on a group
// of G consecutive lanes of a warp: lane l computes the control rows c =
// l, l + G, ... and the next-state rows i = l, l + G, ... (the env's
// row(), envs.cuh), and the group exchanges u and x_{t+1} by shuffles, so
// every lane holds the whole state; the stage cost is computed alike on
// every lane. The plan (G, spb, D and the block's shared bytes,
// ops/rollout.py rollout_plan) spreads B over the SMs; the C side
// recomputes the shared bytes and refuses a plan that disagrees. Each
// thread takes its alpha once: K2's from the kernel's argument by constant
// indices (no local-memory copy of the array), K3's from alpha [B].
// The arithmetic is that of the one-thread kernels they replaced (commit
// 0bac190), bit for bit: the policy row (ubar + alpha k) + sum_i K_ci
// dx_i in ascending i, each env row in its order, the stage cost summed
// over i in order, the running sum in double rounded once; only the
// mapping and the data movement changed.
//
// K5 at reservoir-5, T=500, B=1024, A=11 reads ~82 MB and writes ~225 MB of
// trajectories, so its bound is bytes (~0.09 ms), but like K2 it is a chain
// of T dependent steps per thread and latency-bound far above that. The
// design keeps K2's: one thread per (scenario, alpha), scenario index
// fastest, so each warp's stores to the [T, A*n, B] outputs are 32
// consecutive addresses; state in registers for the whole chain, no time
// blocking (the TPU kernel's time blocks buffer stores in VMEM; here a
// store is issued and the chain goes on).
//
// K8 (the fused iteration's materialize) is K3 that also writes the env's
// closed-form linearization at each step's (x_t, clipped u_t): 7 blocks of
// n^2 + n m + n + m + n^2 + m^2 + m n entries, 26 values a step at n = m =
// 2 besides K3's 4 outputs and 10 inputs, ~62 MB at the navigation
// headline (B=4096, T=100, f32), so its bound is bytes (~0.019 ms). Like
// K3 it is a chain of T dependent steps per thread and latency-bound above
// that. The design keeps K3's (one thread per scenario, state in
// registers) and writes each entry as soon as it is computed, scenario
// index fastest, so every store of a warp is 32 consecutive addresses; the
// constant entries (l_xx = 2I, the zero blocks) are stores with no loads.
// Blocks of 32 threads spread B=4096 scenarios over 128 SMs, as K1.
//
// This header holds the kernels and their dispatch; each .cu instantiates
// its own dims so the parallel build compiles them side by side:
// rollout.cu n = m in {2, 3, 5, 6} for every env (and the C entries),
// rollout_n12.cu and rollout_n16.cu the HVAC step at n = m = 12 and 16
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

template <typename S, int N, int M>
__device__ __forceinline__ void policy_control(
    const S* __restrict__ xbar, const S* __restrict__ ubar,
    const S* __restrict__ K, const S* __restrict__ k,
    const S* __restrict__ lo, const S* __restrict__ hi, int t, int b, int B,
    S alpha, const S (&x)[N], S (&u)[M]) {
  S dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = x[i] - xbar[at(t, i, N, b, B)];
#pragma unroll
  for (int c = 0; c < M; ++c) {
    const S base = ubar[at(t, c, M, b, B)] + alpha * k[at(t, c, M, b, B)];
    S acc = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) acc += K[at(t, c * N + i, M * N, b, B)] * dx[i];
    u[c] = base + acc;
    if (lo != nullptr) u[c] = clip(u[c], lo[c], hi[c]);
  }
}

template <typename S, int N, int M, class Env>
__global__ void linesearch_costs_traj_kernel(
    const S* __restrict__ xbar, const S* __restrict__ ubar,
    const S* __restrict__ K, const S* __restrict__ k,
    const S* __restrict__ lo, const S* __restrict__ hi, Alphas<S> alphas,
    int A, Env env, S* __restrict__ J, S* __restrict__ X,
    S* __restrict__ U, int T, int B) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<int64_t>(A) * B) return;
  const int b = static_cast<int>(idx % B);
  const int a = static_cast<int>(idx / B);
  const S alpha = alphas.v[a];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      X[at(t, a * N + i, A * N, b, B)] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int c = 0; c < M; ++c) U[at(t, a * M + c, A * M, b, B)] = u[c];
  }
  J[idx] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

// K8: K3 that also writes, at every step, the env's closed-form
// linearization at the pre-step state and the clipped control
// (Env::derivatives, envs.cuh) into the seven [T, entries, B] blocks of
// `lin`, the Riccati kernels' input layout. X, U and J are K3's arithmetic
// (the same policy_control and step).
template <typename S, int N, int M, class Env>
__global__ void rollout_alpha_derivs_kernel(
    const S* __restrict__ alpha_in, const S* __restrict__ xbar,
    const S* __restrict__ ubar, const S* __restrict__ K,
    const S* __restrict__ k, const S* __restrict__ lo,
    const S* __restrict__ hi, Env env, S* __restrict__ X, S* __restrict__ U,
    S* __restrict__ J, LinOut<S> lin, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const S alpha = alpha_in[b];

  S x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = xbar[at(0, i, N, b, B)];
  double total = 0;
  for (int t = 0; t < T; ++t) {
    S u[M], xn[N];
    policy_control<S, N, M>(xbar, ubar, K, k, lo, hi, t, b, B, alpha, x, u);
    env.template derivatives<M>(x, u, lin, t, b, B);
    total += static_cast<double>(env.template step<M>(x, u, xn));
#pragma unroll
    for (int i = 0; i < N; ++i) {
      X[at(t, i, N, b, B)] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int c = 0; c < M; ++c) U[at(t, c, M, b, B)] = u[c];
  }
  J[b] = static_cast<S>(total + static_cast<double>(env.final_cost(x)));
}

// -- K2 and K3: the tile kernels ---------------------------------------------

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

template <typename S>
struct TileArgs {
  const S *xbar, *ubar, *K, *k, *lo, *hi;
  const S* alpha;  // K3: each scenario's alpha [B]
  S *X, *U, *J;    // K3: X [T, n, B], U [T, m, B], J [B]; K2: J [A, B]
  int T, B, A, spb, depth, stride, vec_bytes;
  Alphas<S> alphas;  // K2
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

// K2 (kCosts: the block's spb scenarios times A alphas, J [A, B]) and K3
// (one rollout a scenario at its own alpha, X, U and J). Compute thread
// tid is lane tid % G of rollout tid / G; rollout r is scenario b0 + r %
// spb at alpha r / spb. The threads past the last rollout (the compute
// threads are whole warps) and the scenarios past B run the steps on
// staged values that nobody reads and store nothing. The last warp copies
// the inputs (see the producer branch).
template <typename S, int N, int M, int G, class Env, bool kCosts>
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
  env.template each_param<M>([&](auto& ptr, int len) {
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
  const bool live = !producer && ai < (kCosts ? a.A : 1) && b < a.B;
  S alpha = 0;
  if constexpr (kCosts) {
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
                  ? env.template row<M>(pre, i, x, u, xo[r], uo[r])
                  : S(0);
    }
    TFMPC_TILE_PHASE(3)
    const S cost = env.template stage_cost<M>(x, u);
    if constexpr (!kCosts) {
      if (live) {
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const int i = lane + G * r;
          if (G * (r + 1) <= N || i < N) {
            a.X[at(t, i, N, b, a.B)] = xn[r];
            a.U[at(t, i, M, b, a.B)] = uo[r];
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
    a.J[kCosts ? static_cast<int64_t>(ai) * a.B + b : b] =
        static_cast<S>(total + static_cast<double>(env.final_cost(x)));
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
// the phase-clock counters (device, 8), set by tfmpc_rollout_clocks_buffer
extern unsigned long long* tile_clocks;
#endif

// One call of a rollout C entry: K2 (kind kCostsK2), K3 (kAlphaK3) or K5
// (kTrajK5, the one-thread kernel with ``block`` threads a block).
enum RolloutKind { kCostsK2 = 0, kAlphaK3 = 1, kTrajK5 = 2 };

struct RolloutCall {
  int kind, dtype, env, n, m, T, B;
  const void *xbar, *ubar, *K, *k, *lo, *hi;
  const double* alphas;  // K2, K5 (host)
  int A;
  const void* alpha;  // K3 (device, [B])
  const void* const* params;
  int n_params;
  const int* int_params;
  int n_int_params;
  void *J, *X, *U;
  TilePlan plan;  // K2, K3
  int block;      // K5
  cudaStream_t stream;
  // K2, K3: where non-null, receives the most threads a block of the
  // plan's G can launch with (its registers bound it), and nothing runs
  int* max_threads;
};

namespace {

// The G of ops/rollout.py ROLLOUT_PLANS, per kernel and dim: the G each
// source instantiates (with TFMPC_ROLLOUT_ALL_G, the sweep's build, every
// G at each dim's swept env too).
struct PlanGroups {
  bool costs;
  int n, groups;
};
constexpr PlanGroups kPlanGroups[] = {
    {true, 2, 1},  {true, 3, 1},  {true, 5, 4},  {true, 6, 2},
    {true, 12, 4}, {true, 16, 2}, {false, 2, 2}, {false, 3, 4},
    {false, 5, 8}, {false, 6, 8}, {false, 12, 4}, {false, 16, 16}};

constexpr int plan_groups(bool costs, int n) {
  for (const PlanGroups& p : kPlanGroups)
    if (p.costs == costs && p.n == n) return p.groups;
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
template <bool kCosts, int N, class Env, class F>
int with_groups(int groups, F&& f) {
#ifdef TFMPC_ROLLOUT_ALL_G
  // the sweep's env at each dim: navigation at 2, reservoir at 5, HVAC at
  // 3, 6, 12 and 16 (tools/kernel_versions.py rollout --sweep)
  constexpr int swept = N == 2 ? kNavigation : N == 5 ? kReservoir : kHVAC;
  if constexpr (Env::kId == swept)
    return with_group_upto<N, 1>(groups, static_cast<F&&>(f));
#endif
  constexpr int G = plan_groups(kCosts, N);
  static_assert(G > 0, "a rollout dim without a plan");
  if (groups == G) return f(std::integral_constant<int, G>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S, int N, int G, bool kCosts, class Env>
int launch_tile(TileArgs<S> a, const Env& env, const TilePlan& plan,
                cudaStream_t stream, int* max_threads) {
  auto kernel = rollout_tile_kernel<S, N, N, G, Env, kCosts>;
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
      (a.spb * (kCosts ? a.A : 1) * G + kWarp - 1) / kWarp * kWarp + kWarp;
  const long long bytes =
      tile_smem_bytes(sizeof(S), N, N, G, a.spb, a.depth,
                      env.template param_elems<N>());
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

// K2, K3 or K5 at dim N with the env's functor.
template <typename S, int N, class Env>
int launch_kind(const RolloutCall& c, const Env& step) {
  if (c.kind == kTrajK5) {
    Alphas<S> al{};
    for (int a = 0; a < c.A; ++a) al.v[a] = static_cast<S>(c.alphas[a]);
    linesearch_costs_traj_kernel<S, N, N, Env>
        <<<blocks_for(static_cast<int64_t>(c.A) * c.B, c.block), c.block, 0,
           c.stream>>>(
            (const S*)c.xbar, (const S*)c.ubar, (const S*)c.K, (const S*)c.k,
            (const S*)c.lo, (const S*)c.hi, al, c.A, step, (S*)c.J, (S*)c.X,
            (S*)c.U, c.T, c.B);
    return static_cast<int>(cudaGetLastError());
  }
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
#ifdef TFMPC_ROLLOUT_CLOCKS
  a.clocks = tile_clocks;
#endif
  a.T = c.T;
  a.B = c.B;
  a.A = c.A;
  a.spb = c.plan.spb;
  a.depth = c.plan.depth;
  if (c.kind == kCostsK2) {
    for (int j = 0; j < c.A && c.alphas != nullptr; ++j)
      a.alphas.v[j] = static_cast<S>(c.alphas[j]);
    return with_groups<true, N, Env>(c.plan.groups, [&](auto g) {
      return launch_tile<S, N, decltype(g)::value, true>(
          a, step, c.plan, c.stream, c.max_threads);
    });
  }
  return with_groups<false, N, Env>(c.plan.groups, [&](auto g) {
    return launch_tile<S, N, decltype(g)::value, false>(
        a, step, c.plan, c.stream, c.max_threads);
  });
}

template <typename S, class Dims>
int rollout_dtype(const RolloutCall& c) {
  return with_dims(Dims{}, c.n, c.m, [&](auto dim) {
    constexpr int N = decltype(dim)::value;
    return with_env_at<S, N>(c.env, c.params, c.n_params, c.int_params,
                             c.n_int_params, [&](auto step) {
                               return launch_kind<S, N>(c, step);
                             });
  });
}

}  // namespace

// The dtype dispatch over the dims ``Dims``.
template <class Dims>
int rollout_dims(const RolloutCall& c) {
  if (c.dtype == kFloat32) return rollout_dtype<float, Dims>(c);
  if (c.dtype == kFloat64) return rollout_dtype<double, Dims>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

// rollout.cu's dims; rollout_n12.cu and rollout_n16.cu define the two mid
// dims' entries, so the parallel build compiles them side by side.
using SmallDims = DimList<2, 3, 5, 6>;
int rollout_n12(const RolloutCall& c);
int rollout_n16(const RolloutCall& c);

}  // namespace tfmpc
