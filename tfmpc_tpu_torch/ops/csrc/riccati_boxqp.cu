// K4: the batched control-limited (boxQP) Riccati backward pass of iLQR in
// one kernel.
//
// Replaces: tfmpc_tpu/ops/riccati_pallas.py:_riccati_pallas_raw with
// boxqp_iters > 0 (adapter riccati_backward_boxqp_pallas; body _kernel /
// _riccati_step_math's boxQP branch / _boxqp_lane).
//
// Per scenario and step t = T-1 .. 0: the Q blocks with V + mu I, the PD
// probe of QuuR (sticky per-lane fail), then the fixed-iteration projected-
// Newton boxQP of ops/boxqp.py on (QuuR, Qu) within [lo - ubar_t,
// hi - ubar_t]:
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
// rows are exactly 0; k = x. dV1/dV2 use the UNregularized Qu, Quu, and
// the value update is K1's (riccati_step.cuh).
//
// What bounds it on this card: at HVAC-6 (n = m = 6, B = 2048, T = 100) a
// step reads 198 values per scenario and writes 42 (~196 MB in f32, ~0.06
// ms of HBM time at 3.35 TB/s); the arithmetic is up to ~15k FLOPs per step
// and scenario with all 8 Newton x 8 line-search iterations (~3 GFLOP,
// ~0.05 ms at 67 TFLOP/s). But like K1 the T steps of a scenario form a
// serial chain, and the boxQP loop inside a step is itself serial, so the
// kernel is bound by the latency of one thread's dependent arithmetic.
//
// What the design does about it, simple and right first: one thread per
// scenario, walking T; the [T, entries, B] layout keeps every load and
// store coalesced across a warp. The small-matrix loops unroll through the
// template dims; the Newton and line-search loops do NOT unroll (#pragma
// unroll 1) and end early once a problem is done or a candidate improves,
// which keeps code size and compile time sane at (6, 6) in float64. At
// n = m = 6 the working set (V, the five Q blocks, the factors, the boxQP
// vectors: ~300 values) exceeds the 255-register limit, so it spills to
// local memory (ptxas -v in chip_smoke.py reports how much). Splitting a
// scenario over several threads is later work.
#include "riccati_step.cuh"

namespace tfmpc {
namespace {

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

template <typename S, int N, int M>
__global__ void riccati_backward_boxqp_kernel(
    const S* __restrict__ fx, const S* __restrict__ fu,
    const S* __restrict__ lx, const S* __restrict__ lu,
    const S* __restrict__ lxx, const S* __restrict__ luu,
    const S* __restrict__ lux, const S* __restrict__ mu_in,
    const S* __restrict__ ubar, const S* __restrict__ lo_in,
    const S* __restrict__ hi_in, const S* __restrict__ VT,
    const S* __restrict__ vT, S* __restrict__ K_out, S* __restrict__ k_out,
    S* __restrict__ dV1_out, S* __restrict__ dV2_out,
    S* __restrict__ fail_out, int T, int B, int newton_iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  S V[N][N], v[N];
  load_final<S, N>(VT, vT, b, B, V, v);
  const S mu = mu_in[b];
  S dV1 = 0, dV2 = 0;
  bool fail = false;

#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    QBlocks<S, N, M> q;
    q_blocks<S, N, M>(fx, fu, lx, lu, lxx, luu, lux, t, b, B, V, v, mu, q);

    {  // PD probe of QuuR (the factor itself is not used by boxQP)
      S L[M][M];
      chol_probe<S, M>(q.QuuR, L, fail);
    }

    S lo[M], hi[M], kv[M];
    bool free[M];
#pragma unroll
    for (int a = 0; a < M; ++a) {
      const S u = ubar[at(t, a, M, b, B)];
      lo[a] = lo_in[a] - u;
      hi[a] = hi_in[a] - u;
    }
    boxqp<S, M>(q.QuuR, q.Qu, lo, hi, newton_iters, kv, free);

    // K from the final free set's factor: rhs free[a] * QuxR[a][i].
    S Mx[M][M], Lf[M][M], Kt[M][N];
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

    value_update<S, N, M>(q, kv, Kt, V, v, dV1, dV2);
    store_gains<S, N, M>(K_out, k_out, t, b, B, kv, Kt);
  }

  dV1_out[b] = dV1;
  dV2_out[b] = dV2;
  fail_out[b] = fail ? S(1) : S(0);
}

template <typename S, int N>
int launch(int T, int B, int iters, const void* const* in, void* const* out,
           int block, cudaStream_t stream) {
  riccati_backward_boxqp_kernel<S, N, N>
      <<<blocks_for(B, block), block, 0, stream>>>(
          (const S*)in[0], (const S*)in[1], (const S*)in[2], (const S*)in[3],
          (const S*)in[4], (const S*)in[5], (const S*)in[6], (const S*)in[7],
          (const S*)in[8], (const S*)in[9], (const S*)in[10],
          (const S*)in[11], (const S*)in[12], (S*)out[0], (S*)out[1],
          (S*)out[2], (S*)out[3], (S*)out[4], T, B, iters);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_dims(int n, int m, int T, int B, int iters,
                const void* const* in, void* const* out, int block,
                cudaStream_t stream) {
  if (n != m) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 2: return launch<S, 2>(T, B, iters, in, out, block, stream);
    case 3: return launch<S, 3>(T, B, iters, in, out, block, stream);
    case 5: return launch<S, 5>(T, B, iters, in, out, block, stream);
    case 6: return launch<S, 6>(T, B, iters, in, out, block, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tfmpc

// (n, m) in {(2,2), (3,3), (5,5), (6,6)}: bounded navigation, the HVAC-3
// oracle problem, reservoir-5 and HVAC-6 (ops/riccati.py
// BOXQP_KERNEL_DIMS).
extern "C" int tfmpc_riccati_backward_boxqp(
    int dtype, int n, int m, int T, int B, int newton_iters, const void* fx,
    const void* fu, const void* lx, const void* lu, const void* lxx,
    const void* luu, const void* lux, const void* mu, const void* ubar,
    const void* lo, const void* hi, const void* VT, const void* vT, void* K,
    void* k, void* dV1, void* dV2, void* fail, int block, void* stream) {
  using namespace tfmpc;
  if (T < 1 || newton_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const void* in[] = {fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT};
  void* out[] = {K, k, dV1, dV2, fail};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch_dims<float>(n, m, T, B, newton_iters, in, out, block, s);
  if (dtype == kFloat64)
    return launch_dims<double>(n, m, T, B, newton_iters, in, out, block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
