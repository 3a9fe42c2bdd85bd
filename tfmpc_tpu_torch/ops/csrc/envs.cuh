// Env step functors compiled into the rollout kernels (rollout.cuh and its
// generic form, rollout_generic.cuh).
//
// Each functor mirrors its env's public transition/cost/final_cost exactly
// (and the JAX package's lane_functions, e.g. navigation.py:182-214), and is
// selected by the env_id that the env's device_step() returns. A functor
// that also has derivs_prep() and derivs_row() (navigation's, named by the
// env's device_derivatives()) runs in K8, the rollout that writes the
// linearization of its trajectory.
//
// Each functor's step is split for the rollout tile kernels, which spread a
// step's rows over a group of lanes: stage_cost(x, u) (the cost at the
// PRE-step state), prep(x) (what every row shares, computed alike by every
// lane) and row(pre, i, x, u, x_i, u_i) (row i of the next state).
// param_elems() and each_param() list the parameter arrays, so a kernel can
// copy them into shared memory once a block and point the functor at the
// copy.
//
// Each functor is written once over its dims (Dims): at a compile-time N,
// n = m = N and its loops unroll whole (the unrolled tile kernel); at N =
// kAnyDim, n and m are set at launch (the generic form, at any 1 <= n, m <=
// 48) and nvcc ignores ``#pragma unroll (N)``, an unroll count of 0, so it
// unrolls those loops by its own rule. Both run the same arithmetic in the
// same order. x and u are read through whatever indexes them: a register
// array in the unrolled kernel, a column of shared memory in the generic
// form.
#pragma once

#include "common.cuh"

namespace tfmpc {

// env_id values (tfmpc_tpu_torch/models/*.py device_step)
constexpr int kNavigation = 0;
constexpr int kHVAC = 1;
constexpr int kReservoir = 2;
constexpr int kLinear = 3;

// max(v, 0) that keeps NaN, as torch.clamp(v, min=0) does
template <typename S>
__device__ __forceinline__ S relu(S v) {
  return v < S(0) ? S(0) : v;
}

// A functor's dims: n = m = N at a compile-time N (the unrolled kernels run
// n = m); at N = kAnyDim, n and m set at launch. Only the linear step has
// m != n: the generic launch refuses it for the others.
constexpr int kAnyDim = 0;

template <int N>
struct Dims {
  static constexpr int n = N;
  static constexpr int m = N;
};
template <>
struct Dims<kAnyDim> {
  int n, m;
};

// The largest n = m K8 runs at: the JAX package's fused-iteration ceiling
// (ops/rollout.py DERIVS_DIM_MAX). At kAnyDim, K8's per-dim arrays
// (NavigationStep::DerivsPre) are sized by it.
constexpr int kDerivsMaxDim = 12;

// The seven linearization blocks K8 writes ([T, entries, B] each, the
// Riccati kernels' input layout): f_x [N*N], f_u [N*M], l_x [N], l_u [M],
// l_xx [N*N], l_uu [M*M], l_ux [M*N], row-major entries.
template <typename S>
struct LinOut {
  S* fx;
  S* fu;
  S* lx;
  S* lu;
  S* lxx;
  S* luu;
  S* lux;
};

// Navigation: x' = x + lambda(x) u,
// lambda(x) = prod_z [2 / (1 + exp(-decay_z sqrt(|x - c_z|^2 + 1e-12))) - 1],
// stage cost |x - goal|^2 on the PRE-step state, final cost the same.
// Parameters (device pointers): goal [n], centers [Z, n], decays [Z].
template <typename S, int N>
struct NavigationStep {
  static constexpr int kId = kNavigation;
  const S* __restrict__ goal;
  const S* __restrict__ centers;
  const S* __restrict__ decays;
  int zones;
  Dims<N> dims;

  template <class X>
  __device__ __forceinline__ S final_cost(const X& x) const {
    const int n = dims.n;
    S c = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      const S d = x[i] - goal[i];
      c += d * d;
    }
    return c;
  }

  __host__ __device__ int param_elems() const {
    return dims.n + zones * dims.n + zones;
  }
  template <class F>
  __device__ __forceinline__ void each_param(F&& f) {
    f(goal, dims.n);
    f(centers, zones * dims.n);
    f(decays, zones);
  }

  template <class X, class U>
  __device__ __forceinline__ S stage_cost(const X& x, const U&) const {
    return final_cost(x);
  }

  // the deceleration lam(x), shared by every row
  struct Pre {
    S lam;
  };
  template <class X>
  __device__ __forceinline__ Pre prep(const X& x) const {
    S lam = 1;
    for (int z = 0; z < zones; ++z) lam = lam * factor(x, z);
    return Pre{lam};
  }

  template <class X, class U>
  __device__ __forceinline__ S row(const Pre& p, int, const X&, const U&,
                                   S xi, S ui) const {
    return xi + p.lam * ui;
  }

  // The closed-form linearization at (x, u) (models/navigation.py
  // analytic_derivatives, one step; the JAX package's lane_derivatives):
  //   f_x = I + u dlam^T (entry i*N + j), f_u = lam I, l_x = 2 (x - goal),
  //   l_xx = 2 I, l_u = l_uu = l_ux = 0, with
  //   dlam = sum_z [lam / g_z if g_z != 0 else 0] g'_z / dist_z (x - c_z),
  //   g'_z = decay_z (1 - g_z^2) / 2,
  // split as the step is: derivs_prep (lam, from prep(), and dlam; the
  // zones are a runtime loop, so it recomputes each zone's g_z and dist_z
  // as factor() does) and derivs_row (row i of f_x, f_u, l_xx, l_uu and
  // l_ux and entry i of l_x and l_u, stored to step t of lane b of the
  // [T, entries, B] blocks of ``out``). K8 runs them (rollout.cuh
  // derivs_tail, rollout_generic.cuh generic_derivs_tail). Their loops
  // run to kDl, N at a compile-time N and kDerivsMaxDim at kAnyDim, each
  // entry guarded by i < n (always true at a compile-time N), so the
  // per-dim arrays stay in registers at run-time dims too.
  static constexpr int kDl = N == kAnyDim ? kDerivsMaxDim : N;
  struct DerivsPre {
    S lam;
    S dlam[kDl];
  };
  template <class X>
  __device__ __forceinline__ DerivsPre derivs_prep(const Pre& p,
                                                   const X& x) const {
    const int n = dims.n;
    DerivsPre q;
    q.lam = p.lam;
#pragma unroll
    for (int i = 0; i < kDl; ++i) q.dlam[i] = 0;
    for (int z = 0; z < zones; ++z) {
      S d[kDl], d2 = 0;
#pragma unroll
      for (int i = 0; i < kDl; ++i)
        if (i < n) {
          d[i] = x[i] - centers[z * n + i];
          d2 += d[i] * d[i];
        }
      const S dist = dsqrt(d2 + S(1e-12));
      const S g = S(2) / (S(1) + dexp(-decays[z] * dist)) - S(1);
      const S gp = decays[z] * (S(1) - g * g) / S(2);
      const S coef = (g != S(0) ? q.lam / g : S(0)) * gp / dist;
#pragma unroll
      for (int i = 0; i < kDl; ++i)
        if (i < n) q.dlam[i] += coef * d[i];
    }
    return q;
  }

  // Row i of the linearization at (x_i, u_i), the lane's own entries.
  __device__ __forceinline__ void derivs_row(const DerivsPre& q, int i, S xi,
                                             S ui, const LinOut<S>& out,
                                             int t, int b, int B) const {
    const int n = dims.n;
#pragma unroll
    for (int j = 0; j < kDl; ++j)
      if (j < n) {
        const int64_t e = at(t, i * n + j, n * n, b, B);
        out.fx[e] = ui * q.dlam[j] + S(i == j ? 1 : 0);
        out.fu[e] = i == j ? q.lam : S(0);
        out.lxx[e] = S(i == j ? 2 : 0);
        out.luu[e] = S(0);
        out.lux[e] = S(0);
      }
    out.lx[at(t, i, n, b, B)] = S(2) * (xi - goal[i]);
    out.lu[at(t, i, n, b, B)] = S(0);
  }

  // Zone z's deceleration factor 2 / (1 + exp(-decay_z dist_z)) - 1.
  template <class X>
  __device__ __forceinline__ S factor(const X& x, int z) const {
    const int n = dims.n;
    S d2 = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      const S d = x[i] - centers[z * n + i];
      d2 += d * d;
    }
    const S dist = dsqrt(d2 + S(1e-12));
    return S(2) / (S(1) + dexp(-decays[z] * dist)) - S(1);
  }
};

// HVAC (models/hvac.py): forward-Euler room temperatures,
//   x'_i = x_i + dt * (u_i Ka (Ta - x_i) + sum_j cond_ij x_j - x_i rowsum_i
//                      + k_out_i (To - x_i) + k_hall_i (Th - x_i)) / C_i,
// stage cost on the PRE-step state,
//   cost_air * sum(u) + penalty * sum(relu(lo - x)^2 + relu(x - hi)^2)
//                     + setpoint_weight * sum((x - mid)^2),
// final cost the same at u = 0. One control per room (m = n). Parameters
// (device pointers, the order of HVAC_STEP_PARAMS): cond [n, n],
// cond_rowsum, k_out, k_hall, capacity, temp_low, temp_high, temp_mid [n],
// then 0-d temp_out, temp_hall, temp_air, air_cap, cost_air, penalty,
// setpoint_weight, time_delta.
template <typename S, int N>
struct HVACStep {
  static constexpr int kId = kHVAC;
  const S* __restrict__ cond;
  const S* __restrict__ cond_rowsum;
  const S* __restrict__ k_out;
  const S* __restrict__ k_hall;
  const S* __restrict__ capacity;
  const S* __restrict__ temp_low;
  const S* __restrict__ temp_high;
  const S* __restrict__ temp_mid;
  const S* __restrict__ temp_out;
  const S* __restrict__ temp_hall;
  const S* __restrict__ temp_air;
  const S* __restrict__ air_cap;
  const S* __restrict__ cost_air;
  const S* __restrict__ penalty;
  const S* __restrict__ setpoint_weight;
  const S* __restrict__ time_delta;
  Dims<N> dims;

  template <class X>
  __device__ __forceinline__ S final_cost(const X& x) const {
    const int n = dims.n;
    S comfort = 0, setpoint = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      const S below = relu(temp_low[i] - x[i]);
      const S above = relu(x[i] - temp_high[i]);
      comfort += below * below + above * above;
      const S d = x[i] - temp_mid[i];
      setpoint += d * d;
    }
    return *penalty * comfort + *setpoint_weight * setpoint;
  }

  __host__ __device__ int param_elems() const {
    return dims.n * dims.n + 7 * dims.n + 8;
  }
  template <class F>
  __device__ __forceinline__ void each_param(F&& f) {
    const int n = dims.n;
    f(cond, n * n);
    f(cond_rowsum, n);
    f(k_out, n);
    f(k_hall, n);
    f(capacity, n);
    f(temp_low, n);
    f(temp_high, n);
    f(temp_mid, n);
    f(temp_out, 1);
    f(temp_hall, 1);
    f(temp_air, 1);
    f(air_cap, 1);
    f(cost_air, 1);
    f(penalty, 1);
    f(setpoint_weight, 1);
    f(time_delta, 1);
  }

  template <class X, class U>
  __device__ __forceinline__ S stage_cost(const X& x, const U& u) const {
    const int n = dims.n;
    S air = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) air += u[i];
    return *cost_air * air + final_cost(x);
  }

  // the scalar temperatures and rates every row reads
  struct Pre {
    S ta, ka, to, th, dt;
  };
  template <class X>
  __device__ __forceinline__ Pre prep(const X&) const {
    return Pre{*temp_air, *air_cap, *temp_out, *temp_hall, *time_delta};
  }

  template <class X, class U>
  __device__ __forceinline__ S row(const Pre& p, int i, const X& x,
                                   const U&, S xi, S ui) const {
    const int n = dims.n;
    const S heat = ui * p.ka * (p.ta - xi);
    S exch = 0;
#pragma unroll (N)
    for (int j = 0; j < n; ++j) exch += cond[i * n + j] * x[j];
    exch = exch - xi * cond_rowsum[i];
    const S leak_out = k_out[i] * (p.to - xi);
    const S leak_hall = k_hall[i] * (p.th - xi);
    const S dT = (heat + exch + leak_out + leak_hall) / capacity[i];
    return xi + p.dt * dT;
  }
};

// Reservoir (models/reservoir.py): x'_i = x_i + rain_i - evap_i - u_i +
// sum_j D_ji u_j with evap_i = evap_factor sin(x_i / cap_i) x_i; stage cost
// on the PRE-step state and independent of u,
//   sum(low_penalty relu(lb - x)^2 + high_penalty relu(x - ub)^2
//       + setpoint_weight (x - mid)^2),
// final cost the same. One release per reservoir (m = n). Parameters (the
// order of RESERVOIR_STEP_PARAMS): downstream [n, n], max_capacity, rain
// [n], evap_factor (0-d), lower_bound, upper_bound, mid [n], low_penalty,
// high_penalty, setpoint_weight (0-d).
template <typename S, int N>
struct ReservoirStep {
  static constexpr int kId = kReservoir;
  const S* __restrict__ downstream;
  const S* __restrict__ max_capacity;
  const S* __restrict__ rain;
  const S* __restrict__ evap_factor;
  const S* __restrict__ lower_bound;
  const S* __restrict__ upper_bound;
  const S* __restrict__ mid;
  const S* __restrict__ low_penalty;
  const S* __restrict__ high_penalty;
  const S* __restrict__ setpoint_weight;
  Dims<N> dims;

  template <class X>
  __device__ __forceinline__ S final_cost(const X& x) const {
    const int n = dims.n;
    const S lp = *low_penalty, hp = *high_penalty, sw = *setpoint_weight;
    S c = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      const S below = relu(lower_bound[i] - x[i]);
      const S above = relu(x[i] - upper_bound[i]);
      const S d = x[i] - mid[i];
      c += lp * below * below + hp * above * above + sw * d * d;
    }
    return c;
  }

  __host__ __device__ int param_elems() const {
    return dims.n * dims.n + 5 * dims.n + 4;
  }
  template <class F>
  __device__ __forceinline__ void each_param(F&& f) {
    const int n = dims.n;
    f(downstream, n * n);
    f(max_capacity, n);
    f(rain, n);
    f(evap_factor, 1);
    f(lower_bound, n);
    f(upper_bound, n);
    f(mid, n);
    f(low_penalty, 1);
    f(high_penalty, 1);
    f(setpoint_weight, 1);
  }

  template <class X, class U>
  __device__ __forceinline__ S stage_cost(const X& x, const U&) const {
    return final_cost(x);
  }

  struct Pre {
    S e;
  };
  template <class X>
  __device__ __forceinline__ Pre prep(const X&) const {
    return Pre{*evap_factor};
  }

  template <class X, class U>
  __device__ __forceinline__ S row(const Pre& p, int i, const X&,
                                   const U& u, S xi, S ui) const {
    const int n = dims.n;
    const S evap = p.e * dsin(xi / max_capacity[i]) * xi;
    S inflow = 0;
#pragma unroll (N)
    for (int j = 0; j < n; ++j) inflow += u[j] * downstream[j * n + i];
    return xi + rain[i] - evap - ui + inflow;
  }
};

// Linear system (models/linear.py): x' = A x + B u + c, stage cost
// 1/2 x^T Q x + 1/2 u^T R u + x^T N u + q^T x + r^T u on the PRE-step state,
// final cost 1/2 x^T Q_f x + q_f^T x. Term by term, in the summation order
// of the JAX package's LinearSystem.lane_functions step_fn/final_fn
// (tfmpc_tpu/models/linear.py:118-146). Parameters (the order of
// LINEAR_STEP_PARAMS): A [n, n], B [n, m], c [n], Q [n, n], R [m, m],
// N [n, m], q [n], r [m], Q_f [n, n], q_f [n], row-major.
template <typename S, int N>
struct LinearStep {
  static constexpr int kId = kLinear;
  const S* __restrict__ A;
  const S* __restrict__ B;
  const S* __restrict__ c;
  const S* __restrict__ Q;
  const S* __restrict__ R;
  const S* __restrict__ Nx;
  const S* __restrict__ q;
  const S* __restrict__ r;
  const S* __restrict__ Q_f;
  const S* __restrict__ q_f;
  Dims<N> dims;

  template <class X>
  __device__ __forceinline__ S final_cost(const X& x) const {
    const int n = dims.n;
    S cost = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      cost = cost + q_f[i] * x[i];
#pragma unroll (N)
      for (int j = 0; j < n; ++j)
        cost = cost + S(0.5) * Q_f[i * n + j] * x[i] * x[j];
    }
    return cost;
  }

  __host__ __device__ int param_elems() const {
    const int n = dims.n, m = dims.m;
    return 3 * n * n + 2 * n * m + m * m + 3 * n + m;
  }
  template <class F>
  __device__ __forceinline__ void each_param(F&& f) {
    const int n = dims.n, m = dims.m;
    f(A, n * n);
    f(B, n * m);
    f(c, n);
    f(Q, n * n);
    f(R, m * m);
    f(Nx, n * m);
    f(q, n);
    f(r, m);
    f(Q_f, n * n);
    f(q_f, n);
  }

  struct Pre {};
  template <class X>
  __device__ __forceinline__ Pre prep(const X&) const {
    return Pre{};
  }

  template <class X, class U>
  __device__ __forceinline__ S row(const Pre&, int i, const X& x,
                                   const U& u, S, S) const {
    const int n = dims.n, m = dims.m;
    S xi = c[i];
#pragma unroll (N)
    for (int j = 0; j < n; ++j) xi = xi + A[i * n + j] * x[j];
#pragma unroll (N)
    for (int a = 0; a < m; ++a) xi = xi + B[i * m + a] * u[a];
    return xi;
  }

  template <class X, class U>
  __device__ __forceinline__ S stage_cost(const X& x, const U& u) const {
    const int n = dims.n, m = dims.m;
    S cost = 0;
#pragma unroll (N)
    for (int i = 0; i < n; ++i) {
      cost = cost + q[i] * x[i];
#pragma unroll (N)
      for (int j = 0; j < n; ++j)
        cost = cost + S(0.5) * Q[i * n + j] * x[i] * x[j];
#pragma unroll (N)
      for (int a = 0; a < m; ++a) cost = cost + Nx[i * m + a] * x[i] * u[a];
    }
#pragma unroll (N)
    for (int a = 0; a < m; ++a) {
      cost = cost + r[a] * u[a];
#pragma unroll (N)
      for (int b = 0; b < m; ++b)
        cost = cost + S(0.5) * R[a * m + b] * u[a] * u[b];
    }
    return cost;
  }
};

}  // namespace tfmpc
