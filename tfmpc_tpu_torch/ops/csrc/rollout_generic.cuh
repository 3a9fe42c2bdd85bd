// K2, K3, K5 and K8 at any dims: the generic form of the rollout tile
// kernel.
//
// Replaces, at every 1 <= n, m <= 48 that no unrolled instantiation of
// rollout.cuh covers: tfmpc_tpu/ops/rollout_pallas.py:
// linesearch_costs_pallas (body _costs_kernel) as K2, rollout_alpha_pallas
// (body _materialize_kernel) as K3 and linesearch_costs_traj_pallas as K5,
// which the JAX package runs at any max(n, m) <= 48, rectangular dims
// included; and rollout_alpha_derivs_pallas (body
// _materialize_derivs_kernel) as K8 at navigation's n = m <= 12
// (kDerivsMaxDim) outside K8's unrolled dims, which the JAX package's
// fused iteration runs at any dims <= 12. It computes what rollout.cuh's
// kinds kCosts, kAlpha, kTraj and kDerivs compute: u_t = clip(ubar_t +
// alpha k_t + K_t (x_t - xbar_t)) (the clip
// where the env is bounded), x_{t+1} = step(x_t, u_t), the running cost
// summed in double and rounded once, with the env's step at run-time dims
// (envs.cuh, NavigationStep<S, kAnyDim> and the others).
//
// The unrolled kernel holds a rollout's state x [N] and its control u [M]
// whole in every lane of its group and exchanges rows by shuffles, all
// sized at compile time: at n = m = 48 that is ~150 values a lane in
// float32 and twice that in float64, against 255 registers a thread, and
// an instantiation a dim (four envs at two dims took nvcc 263 s). Here the
// dims are run-time values and the state lives in shared memory instead,
// rollouts side by side (element i of rollout r at i * rp + r, so the
// groups of a warp read consecutive words). Lane l of a group of G
// computes the control rows c = l, l + G, ... < m and the next-state rows
// i = l, l + G, ... < n (G is a run-time value, a power of two up to 32;
// ragged n % G leaves the last lanes fewer rows), writes them there, and
// the group meets at a warp barrier after the controls and after the next
// state. The rest is the unrolled tile kernel's: a block of spb scenarios
// (K2, K5: times all A alphas), the last warp staging D steps of inputs
// ahead with cp.async into D + 2 buffers (one block barrier a step), the
// env's parameters and the box copied into shared memory once a block.
//
// What bounds it: each rollout is a chain of T dependent steps, and each
// step a few chains of dependent shared-memory reads and FMAs a lane. The
// stage cost is as long as the rest of the step or longer (the linear
// step's at (48, 48): n (1 + n + m) + m (1 + m) = 7,008 terms in one sum,
// against n (n + m) + m n = 6,912 terms of rows spread over the G lanes),
// yet nothing in the recursion x_{t+1} = f(x_t, u_t) waits for it. So the
// cost is off the chain: a group rolls chunks of G steps, keeping x_t and
// u_t of each in a ring of slots (G + 1 slots of x: x_t of the chunk's
// steps and x after them, G of u; step t0 + j reads slot j and writes
// slots j and j + 1), then lane j takes the stage cost of step t0 + j, all
// G at once, and the group adds them to the running sum in t order by
// shuffles. Chunks run up and down the x slots in turn (an odd chunk from
// slot G to slot 0), so each starts where the last ended and nothing is
// copied. After the last chunk the lane after its last step (lane 0 where
// the chunk is whole) takes the final cost and writes J. A step's critical
// path is its rows over G plus a G-th of a cost, where it was its rows
// over G plus a whole cost. Each cost is still the functor's own
// stage_cost expression on one thread, the total Σ_t double(c_t) in t
// order, then J = total + double(final_cost) as one expression, rounded
// once, as the unrolled kernel writes it (nvcc may fuse a final cost's
// last product into that sum in float64, so the final cost is computed
// where the sum is): J is bit for bit a lane-0 sum's, as are X and U,
// which each lane stores as it computes its rows. The ring's slots are
// padded (generic_slot_stride) so that the cost phase's reads, lane j of
// every group at slot j (G - j going down), fall on distinct banks. A lane
// with several policy rows interleaves up to four (policy_rows), each in
// its own order. The shared bytes (generic_smem_bytes) add the ring to
// the unrolled kernel's sum, and do not grow with T; ops/rollout.py
// generic_smem_bytes mirrors it and the launch refuses a plan that
// disagrees.
//
// K8 (kDerivs) runs K3's rollout, then the linearization as the unrolled
// kernel's derivs_tail does (generic_derivs_tail): after a block barrier
// every thread of the block, the producer warp's too, writes the seven
// [T, entries, B] blocks of a (step, scenario), reading x_t and u_t back
// from the block's own X and U stores through a Column (stride B), with
// navigation's derivs_prep and derivs_row at run-time dims.
//
// One instantiation per (dtype, env, kind): rollout_generic.cu holds K2 and
// K3 and the C entries, rollout_generic_traj.cu K5, rollout_generic_derivs.cu
// K8 (navigation only), so the parallel build compiles them side by side.
#pragma once

#include "rollout.cuh"

namespace tfmpc {
namespace {

constexpr int kGenericMaxDim = 48;     // ops/rollout.py GENERIC_DIM_MAX
constexpr int kGenericMaxGroups = 32;  // lanes a rollout: 1, 2, .., 32

// A rollout's vector in shared memory, element i at p[i * s]: how the env
// steps read x and u here.
template <typename S>
struct Column {
  const S* p;
  int s;
  __device__ __forceinline__ S operator[](int i) const { return p[i * s]; }
};

// Phase clocks of the generic form, built only with TFMPC_ROLLOUT_CLOCKS
// (tools/kernel_versions.py rollout --clocks): each compute thread adds the
// SM cycles of each phase of its steps to clocks[8 + phase] and 1 to
// clocks[13]: 0 waiting at the block barrier, 1 the policy rows and their
// U stores, 2 prep, the env rows and their X stores, 3 the stage costs and
// their sum, 4 the final cost and J; a phase ends where the group next
// meets, so a lane's wait for the group counts in the phase it waits on.
// The producer warp counts as the unrolled kernel's (slots 0, 5 and 6).
// The buffer holds 16 counters.
#ifdef TFMPC_ROLLOUT_CLOCKS
#define TFMPC_GENERIC_CLOCKS_BEGIN      \
  unsigned long long gen_ph[5] = {};    \
  long long gen_clk = clock64();
#define TFMPC_GENERIC_PHASE(p)           \
  {                                      \
    const long long now = clock64();     \
    gen_ph[p] += now - gen_clk;          \
    gen_clk = now;                       \
  }
#define TFMPC_GENERIC_CLOCKS_END                                      \
  if (a.clocks != nullptr) {                                          \
    for (int p = 0; p < 5; ++p)                                       \
      if (gen_ph[p]) atomicAdd(a.clocks + 8 + p, gen_ph[p]);          \
    atomicAdd(a.clocks + 13, 1ull);                                   \
  }
#else
#define TFMPC_GENERIC_CLOCKS_BEGIN
#define TFMPC_GENERIC_PHASE(p)
#define TFMPC_GENERIC_CLOCKS_END
#endif

// The rows of a staged step at run-time dims, TileRows' order: xbar [n],
// ubar [m], k [m], then K transposed (row K + i*m + c holds K_ci).
struct GenericRows {
  int ubar, k, K, total;
  __host__ __device__ GenericRows(int n, int m)
      : ubar(n), k(n + m), K(n + 2 * m), total(n + 2 * m + n * m) {}
};

// The compute threads of a block: ``rollouts`` groups of G lanes, whole
// warps.
__host__ __device__ inline int generic_compute_threads(int rollouts,
                                                       int groups) {
  return (rollouts * groups + kWarp - 1) / kWarp * kWarp;
}

// The values between two slots of the state ring: a slot holds a vector
// of len values of each of the rp columns (len * rp), padded so that the
// cost phase's reads, lane s of every group at slot s, fall on distinct
// banks: lane (group g, slot s) reads value s * stride + g of a row, so a
// stride that is an odd multiple of q = the values one wavefront serves
// (128 bytes) / G spreads the warp's reads over every bank (rp is a
// multiple of 32 / G, so len * rp is a multiple of q).
__host__ __device__ inline int generic_slot_stride(int len, int rp,
                                                   int groups, int itemsize) {
  const int wave = 128 / itemsize;
  const int q = wave > groups ? wave / groups : 1;
  const int v = len * rp;
  return (v / q) % 2 == 1 ? v : v + q;
}

// A generic block's dynamic shared bytes: tile_smem_bytes' parameters, box
// and ring, then the state ring of every compute group: G + 1 slots of x
// [n] (x_t of a chunk's G steps and x after them) and G slots of u [m], a
// group's column in each. ops/rollout.py generic_smem_bytes computes the
// same.
inline long long generic_smem_bytes(int itemsize, int n, int m, int groups,
                                    int spb, int depth, int param_elems,
                                    int rollouts) {
  const int cols = generic_compute_threads(rollouts, groups) / groups;
  return tile_smem_bytes(itemsize, n, m, groups, spb, depth, param_elems) +
         ((groups + 1LL) * generic_slot_stride(n, cols, groups, itemsize) +
          static_cast<long long>(groups) *
              generic_slot_stride(m, cols, groups, itemsize)) *
             itemsize;
}

// Copy step t's inputs of the block's scenarios into ``buf`` (rollout.cuh
// stage_tile_step at run-time dims).
template <typename S>
__device__ __forceinline__ void stage_generic_step(const TileArgs<S>& a,
                                                   int n, int m, S* buf,
                                                   int t,
                                                   const TileCopier& c) {
  if (!c.on) return;
  const GenericRows R(n, m);
  S* to = buf + c.q * c.ve;
  for (int e = c.e_first; e < R.total; e += c.e_step) {
    const S* from;
    int row = e;
    if (e < R.ubar) {
      from = a.xbar + at(t, e, n, c.bq, a.B);
    } else if (e < R.k) {
      from = a.ubar + at(t, e - R.ubar, m, c.bq, a.B);
    } else if (e < R.K) {
      from = a.k + at(t, e - R.k, m, c.bq, a.B);
    } else {
      const int ek = e - R.K;  // entry c*n + i of the [T, m*n, B] input
      from = a.K + at(t, ek, m * n, c.bq, a.B);
      row = R.K + (ek % n) * m + ek / n;
    }
    cp_async_chunk(to + row * a.stride, from, a.vec_bytes);
  }
}

// K8's linearization of the block's scenarios after their rollouts
// (rollout.cuh derivs_tail at run-time dims): thread tid takes scenario b0
// + tid % spb at the steps tid / spb, + nthr / spb, ...; x_t from X [t-1]
// (x_0 from xbar) and u_t from U [t], read in place.
template <typename S, class Env>
__device__ __forceinline__ void generic_derivs_tail(const TileArgs<S>& a,
                                                    const Env& env, int b0,
                                                    int tid, int nthr) {
  __syncthreads();  // the block's X and U stores are visible
  const int n = env.dims.n, m = env.dims.m;
  const int b = b0 + (tid & (a.spb - 1));
  if (b >= a.B) return;
#pragma unroll 1
  for (int t = tid / a.spb; t < a.T; t += nthr / a.spb) {
    const S* xs = t == 0 ? a.xbar : a.X + at(t - 1, 0, n, 0, a.B);
    const Column<S> x{xs + b, a.B};
    const Column<S> u{a.U + at(t, 0, m, b, a.B), a.B};
    const auto dpre = env.derivs_prep(env.prep(x), x);
#pragma unroll 1
    for (int i = 0; i < n; ++i)
      env.derivs_row(dpre, i, x[i], u[i], a.lin, t, b, a.B);
  }
}

// The policy rows c = c0, c0 + G, ... (kTile of them, those < m) of a
// staged step (``in``: the scenario's column): u_c = clip((ubar_c + alpha
// k_c) + sum_i K_ci dx_i), each row's sum in ascending i from 0, as the
// one-row loop takes it, so each u_c is bit for bit the same; the rows
// share each dx_i and their chains interleave. A row past m is computed on
// row c0's inputs and dropped. emit(c, u_c) stores a row.
template <int kTile, typename S, class X, class F>
__device__ __forceinline__ void policy_rows(const S* in, int st,
                                            const GenericRows& R, int n,
                                            int m, int c0, int groups,
                                            S alpha, const S* box, const X& x,
                                            F&& emit) {
  int c[kTile];
  S acc[kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    c[q] = c0 + q * groups < m ? c0 + q * groups : c0;
    acc[q] = 0;
  }
  for (int i = 0; i < n; ++i) {
    const S dx = x[i] - in[i * st];
    const S* k = in + (R.K + i * m) * st;
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[q] += k[c[q] * st] * dx;
  }
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (q > 0 && c0 + q * groups >= m) continue;
    const S base = in[(R.ubar + c[q]) * st] + alpha * in[(R.k + c[q]) * st];
    emit(c[q], clip(base + acc[q], box[c[q]], box[m + c[q]]));
  }
}

// lane ``src``'s v within the group of ``groups`` lanes
template <typename S>
__device__ __forceinline__ S group_value(S v, int src, int groups) {
  return groups == 1 ? v : __shfl_sync(kFullMask, v, src, groups);
}

// The generic tile kernel of kind kKind (kCosts K2, kAlpha K3, kTraj K5,
// kDerivs K8) with the env's run-time-dim step ``env`` (its n and m) and G
// = ``groups`` lanes a rollout. Compute thread tid is lane tid % G of
// rollout tid / G; rollout r is scenario b0 + r % spb at alpha r / spb.
// Rollouts past the last (the compute threads are whole warps) and
// scenarios past B run the steps and the costs on values nobody reads and
// store nothing; every compute thread runs every step and every chunk's
// costs, so the warp barriers and the shuffles see the whole warp.
template <typename S, class Env, int kKind>
__global__ void rollout_generic_kernel(const TileArgs<S> a, const int groups,
                                       Env env) {
  const int n = env.dims.n, m = env.dims.m;
  const GenericRows R(n, m);
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = blockIdx.x * a.spb;

  S* par = reinterpret_cast<S*>(tile_smem);
  int off = 0;
  env.each_param([&](auto& ptr, int len) {
    for (int j = tid; j < len; j += nthr) par[off + j] = ptr[j];
    ptr = par + off;
    off += len;
  });
  S* box = par + off;  // lo [m], hi [m]; -inf, +inf when unbounded
  for (int j = tid; j < m; j += nthr) {
    box[j] = a.lo != nullptr ? a.lo[j] : -dinf<S>();
    box[m + j] = a.hi != nullptr ? a.hi[j] : dinf<S>();
  }
  constexpr int kChunk = 16 / static_cast<int>(sizeof(S));
  S* ring = par + (off + 2 * m + kChunk - 1) / kChunk * kChunk;
  const int step_elems = R.total * a.stride;
  const int bufs = a.depth + 2;
  const int ncomp = nthr - kWarp;  // the compute warps' threads
  const int rp = ncomp / groups;   // the state's columns, one a group
  const int sx = generic_slot_stride(n, rp, groups, sizeof(S));
  const int sy = generic_slot_stride(m, rp, groups, sizeof(S));
  S* xs = ring + bufs * step_elems;  // x: [G + 1 slots of sx][n][rp]
  S* us = xs + (groups + 1) * sx;    // u: [G slots of sy][m][rp]

  const bool producer = tid >= ncomp;
  // the producer: rollout.cuh's, at run-time dims
  if (producer) {
    const TileCopier copier = tile_copier(a, b0, tid - ncomp, kWarp);
    for (int d = 0; d < a.depth; ++d) {
      if (d < a.T) stage_generic_step(a, n, m, ring + d * step_elems, d, copier);
      cp_async_commit();
    }
    cp_async_wait_pending(a.depth - 1);
    __syncthreads();  // step 0's inputs and the parameters have landed
    TFMPC_TILE_CLOCKS_BEGIN
    int next = a.depth;
#pragma unroll 1
    for (int t = 0; t < a.T; ++t) {
      if (t + a.depth < a.T)
        stage_generic_step(a, n, m, ring + next * step_elems, t + a.depth,
                           copier);
      cp_async_commit();
      TFMPC_TILE_PHASE(0)
      cp_async_wait_pending(a.depth);  // step t's group has landed
      __syncthreads();                 // for the compute warps
      TFMPC_TILE_PHASE(1)
      next = next + 1 == bufs ? 0 : next + 1;
    }
    TFMPC_TILE_CLOCKS_END(5)
    if constexpr (kKind == kDerivs)
      generic_derivs_tail(a, env, b0, tid, nthr);
    return;
  }

  const int lane = tid & (groups - 1);
  const int roll = tid / groups;
  const int s = roll % a.spb;
  const int ai = roll / a.spb;
  const int b = b0 + s;
  constexpr bool kEvery = every_alpha(kKind);
  const bool live = ai < (kEvery ? a.A : 1) && b < a.B;
  S alpha = 0;
  if constexpr (kEvery) {
#pragma unroll
    for (int j = 0; j < kMaxAlphas; ++j)
      if (j == ai) alpha = a.alphas.v[j];
  } else if (live) {
    alpha = a.alpha[b];
  }
  // K5: alpha ai's rows of [T, A*n, B] and [T, A*m, B]; K3: [T, n, B] and
  // [T, m, B]
  const int xrow0 = kKind == kTraj ? ai * n : 0;
  const int xrows = kKind == kTraj ? a.A * n : n;
  const int urow0 = kKind == kTraj ? ai * m : 0;
  const int urows = kKind == kTraj ? a.A * m : m;
  const bool stores = kKind != kCosts && live;

  __syncthreads();  // step 0's inputs and the parameters have landed
  for (int i = lane; i < n; i += groups)  // x_0 = xbar_0, slot 0
    xs[i * rp + roll] = ring[i * a.stride + s];
  __syncwarp();
  double total = 0;
  int cur = 0;  // the buffer of step t
  TFMPC_GENERIC_CLOCKS_BEGIN
  // chunks of G steps over the G + 1 x slots, in turn up and down: step
  // t0 + j reads x_t from slot j and writes x_{t+1} to slot j + 1 in an
  // even chunk, from slot G - j to slot G - j - 1 in an odd one, and u_t
  // to slot j; then lane j of the group takes the stage cost of step t0 +
  // j. Each chunk starts where the last ended, so nothing is copied.
  bool down = false;  // an odd chunk
#pragma unroll 1
  for (int t0 = 0; t0 < a.T; t0 += groups, down = !down) {
    const int steps = a.T - t0 < groups ? a.T - t0 : groups;
    const int dir = down ? -1 : 1;
    const int x0 = down ? groups : 0;  // x_{t0}'s slot
#pragma unroll 1
    for (int j = 0; j < steps; ++j) {
      __syncthreads();  // step t0 + j's inputs have landed
      TFMPC_GENERIC_PHASE(0)
      const int t = t0 + j;
      const S* in = ring + cur * step_elems + s;
      const int st = a.stride;
      const Column<S> x{xs + (x0 + dir * j) * sx + roll, rp};
      S* xn = xs + (x0 + dir * (j + 1)) * sx + roll;
      S* uo = us + j * sy + roll;
      const Column<S> u{uo, rp};
      // the policy rows, up to four a pass (as many as the lane has)
      const auto emit = [&](int c, S uc) {
        uo[c * rp] = uc;
        if (stores) a.U[at(t, urow0 + c, urows, b, a.B)] = uc;
      };
      if (m > 2 * groups) {
        for (int c0 = lane; c0 < m; c0 += 4 * groups)
          policy_rows<4>(in, st, R, n, m, c0, groups, alpha, box, x, emit);
      } else if (m > groups) {
        for (int c0 = lane; c0 < m; c0 += 2 * groups)
          policy_rows<2>(in, st, R, n, m, c0, groups, alpha, box, x, emit);
      } else if (lane < m) {
        policy_rows<1>(in, st, R, n, m, lane, groups, alpha, box, x, emit);
      }
      __syncwarp();  // the group's u_t is whole
      TFMPC_GENERIC_PHASE(1)
      const auto pre = env.prep(x);
      for (int i = lane; i < n; i += groups) {  // no u_i past m (m < n)
        const S xi = env.row(pre, i, x, u, x[i], i < m ? u[i] : S(0));
        xn[i * rp] = xi;
        if (stores) a.X[at(t, xrow0 + i, xrows, b, a.B)] = xi;
      }
      __syncwarp();  // x_{t+1} is whole
      TFMPC_GENERIC_PHASE(2)
      cur = cur + 1 == bufs ? 0 : cur + 1;
    }
    // the chunk's stage costs, one a lane, off the steps' chain, added to
    // the running sum in t order (every lane of the group keeps the sum)
    S c = 0;
    if (lane < steps)
      c = env.stage_cost(Column<S>{xs + (x0 + dir * lane) * sx + roll, rp},
                         Column<S>{us + lane * sy + roll, rp});
    TFMPC_GENERIC_PHASE(3)
    // four lanes' costs fetched at a time, so that only the adds are a
    // chain (a lane past the chunk's steps is fetched and not added)
    for (int j0 = 0; j0 < steps; j0 += 4) {
      S v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = group_value(c, j0 + q, groups);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < steps) total += static_cast<double>(v[q]);
    }
    TFMPC_GENERIC_PHASE(3)
    if (t0 + steps == a.T) {
      // the final cost at x_T and J on the lane after the last step's
      // (lane 0 where the chunk is whole), the sum's last term written as
      // the unrolled kernel writes it
      const int fl = steps == groups ? 0 : steps;
      if (live && lane == fl) {
        const Column<S> x{xs + (x0 + dir * steps) * sx + roll, rp};
        a.J[kEvery ? static_cast<int64_t>(ai) * a.B + b : b] =
            static_cast<S>(total + static_cast<double>(env.final_cost(x)));
      }
      TFMPC_GENERIC_PHASE(4)
    }
  }
  TFMPC_GENERIC_CLOCKS_END
  if constexpr (kKind == kDerivs) generic_derivs_tail(a, env, b0, tid, nthr);
}

template <typename S, int kKind, class Env>
int launch_generic(TileArgs<S> a, const Env& env, const TilePlan& plan,
                   cudaStream_t stream, int* max_threads) {
  auto kernel = rollout_generic_kernel<S, Env, kKind>;
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
  const int G = plan.groups;
  const int rollouts = a.spb * (every_alpha(kKind) ? a.A : 1);
  const int threads = generic_compute_threads(rollouts, G) + kWarp;
  const long long bytes =
      generic_smem_bytes(sizeof(S), env.dims.n, env.dims.m, G, a.spb,
                         a.depth, env.param_elems(), rollouts);
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
           stream>>>(a, G, env);
  return static_cast<int>(cudaGetLastError());
}

// The env's step functor at the call's dims, passed to f; an unknown env,
// a parameter count that does not match, or m != n for an env with one
// control per state row is refused.
template <typename S, class F>
int with_generic_env(const RolloutCall& c, F&& f) {
  auto P = [&c](int i) { return static_cast<const S*>(c.params[i]); };
  const int np = c.n_params, ni = c.n_int_params;
  const Dims<kAnyDim> d{c.n, c.m};
  if (c.env == kLinear && np == 10 && ni == 0)
    return f(LinearStep<S, kAnyDim>{P(0), P(1), P(2), P(3), P(4), P(5),
                                    P(6), P(7), P(8), P(9), d});
  if (c.n != c.m) return static_cast<int>(cudaErrorInvalidValue);
  if (c.env == kNavigation && np == 3 && ni == 1)
    return f(NavigationStep<S, kAnyDim>{P(0), P(1), P(2), c.int_params[0],
                                        d});
  if (c.env == kHVAC && np == 16 && ni == 0)
    return f(HVACStep<S, kAnyDim>{P(0), P(1), P(2), P(3), P(4), P(5), P(6),
                                  P(7), P(8), P(9), P(10), P(11), P(12),
                                  P(13), P(14), P(15), d});
  if (c.env == kReservoir && np == 10 && ni == 0)
    return f(ReservoirStep<S, kAnyDim>{P(0), P(1), P(2), P(3), P(4), P(5),
                                       P(6), P(7), P(8), P(9), d});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S, int... Ks>
int generic_dtype(KindList<Ks...>, const RolloutCall& c) {
  const TileArgs<S> a = tile_args<S>(c);
  return with_generic_env<S>(c, [&](const auto& step) {
    int rc = static_cast<int>(cudaErrorInvalidValue);
    ((c.kind == Ks ? (rc = launch_generic<S, Ks>(a, step, c.plan, c.stream,
                                                 c.max_threads))
                   : 0),
     ...);
    return rc;
  });
}

}  // namespace

// The kinds ``Kinds`` of a generic call, by dtype.
template <class Kinds>
int rollout_generic_kinds(const RolloutCall& c) {
  if (c.dtype == kFloat32) return generic_dtype<float>(Kinds{}, c);
  if (c.dtype == kFloat64) return generic_dtype<double>(Kinds{}, c);
  return static_cast<int>(cudaErrorInvalidValue);
}

// rollout_generic_traj.cu's K5 and rollout_generic_derivs.cu's K8;
// rollout_generic_entry (rollout_generic.cu) checks a call and sends it to
// the source of its kind.
int rollout_generic_traj(const RolloutCall& c);
int rollout_generic_derivs(const RolloutCall& c);
int rollout_generic_entry(const RolloutCall& c);

}  // namespace tfmpc
