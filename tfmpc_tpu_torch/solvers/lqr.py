"""Finite-horizon discrete-time LQR: the exact solver.

Counterpart of ``tfmpc_tpu/solvers/lqr.py``: ``backward`` (the Riccati
recursion, a loop over reversed t), ``forward`` (the affine policy rolled
out) and ``solve`` (one of each; ``parallel=True`` takes the O(log T)
backward of ``lqr_parallel.py``, whose horizon a time axis may split over
processes). Every function takes any leading batch dims on the problem,
and ``x0`` may carry its own batch dims: the one policy rolls out for all
of them.

Float32 products must run in full float32: keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default), as
the JAX package runs these matmuls at ``"highest"`` precision.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfmpc_tpu_torch.core.types import LQRProblem, Policy, ValueFunction


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _vv(a, b):
    return (a * b).sum(dim=-1)


def cho_solve_nan(M, rhs):
    """``M^-1 rhs`` through a Cholesky factor of ``M [..., m, m]`` (``rhs
    [..., m, k]``), NaN wherever ``M`` is not PD, as the JAX package's
    ``cho_factor``/``cho_solve`` give it; never raises."""
    L, info = torch.linalg.cholesky_ex(M)
    X = torch.cholesky_solve(rhs, L)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(X, torch.nan), X)


def final_cost_terms(problem: LQRProblem):
    """``(C_f, c_f)``, zeros where the problem has none."""
    n = problem.state_size
    batch = problem.F.shape[:-3]
    opts = dict(dtype=problem.F.dtype, device=problem.F.device)
    C_f = problem.C_f if problem.C_f is not None \
        else torch.zeros(batch + (n, n), **opts)
    c_f = problem.c_f if problem.c_f is not None \
        else torch.zeros(batch + (n,), **opts)
    return C_f, c_f


def backward(problem: LQRProblem) -> Tuple[Policy, ValueFunction]:
    """Riccati backward recursion: the policy ``u_t = K_t x_t + k_t`` (``K
    [..., T, m, n]``, ``k [..., T, m]``) and the value function ``V_t`` for
    t = 0..T (``V_T`` is the final cost). A step whose ``Q_uu`` is not PD
    gives NaN gains from there back to t = 0."""
    n, T = problem.state_size, problem.horizon
    F, f, C, c = problem.F, problem.f, problem.C, problem.c
    V, v = final_cost_terms(problem)
    v0 = torch.zeros(V.shape[:-2], dtype=V.dtype, device=V.device)
    Vs, vs, v0s = [V], [v], [v0]
    Ks, ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        F_t, f_t = F[..., t, :, :], f[..., t, :]
        FV = F_t.mT @ V                                   # [n+m, n]
        Q = C[..., t, :, :] + FV @ F_t                    # [n+m, n+m]
        q = c[..., t, :] + _mv(F_t.mT, _mv(V, f_t) + v)   # [n+m]
        q0 = v0 + _vv(v, f_t) + 0.5 * _vv(f_t, _mv(V, f_t))

        Q_xx, Q_ux, Q_uu = Q[..., :n, :n], Q[..., n:, :n], Q[..., n:, n:]
        q_x, q_u = q[..., :n], q[..., n:]
        Kk = -cho_solve_nan(Q_uu, torch.cat([Q_ux, q_u[..., None]], dim=-1))
        K, k = Kk[..., :n], Kk[..., n]

        V = Q_xx + Q_ux.mT @ K
        V = 0.5 * (V + V.mT)
        v = q_x + _mv(K.mT, q_u)
        v0 = q0 + 0.5 * _vv(q_u, k)
        Ks[t], ks[t] = K, k
        Vs.append(V)
        vs.append(v)
        v0s.append(v0)
    value = ValueFunction(V_xx=torch.stack(Vs[::-1], dim=-3),
                          v_x=torch.stack(vs[::-1], dim=-2),
                          v_0=torch.stack(v0s[::-1], dim=-1))
    return Policy(K=torch.stack(Ks, dim=-3), k=torch.stack(ks, dim=-2)), value


def forward(problem: LQRProblem, x0: torch.Tensor, policy: Policy):
    """Roll the affine policy forward from ``x0 [..., n]``. Returns
    ``(states [..., T+1, n], actions [..., T, m], costs [..., T+1])``, the
    last cost being the final cost."""
    x, xs, us, costs = x0, [x0], [], []
    for t in range(problem.horizon):
        u = _mv(policy.K[..., t, :, :], x) + policy.k[..., t, :]
        z = torch.cat([x, u], dim=-1)
        costs.append(0.5 * _vv(z, _mv(problem.C[..., t, :, :], z))
                     + _vv(z, problem.c[..., t, :]))
        x = _mv(problem.F[..., t, :, :], z) + problem.f[..., t, :]
        xs.append(x)
        us.append(u)
    C_f, c_f = final_cost_terms(problem)
    costs.append(0.5 * _vv(x, _mv(C_f, x)) + _vv(x, c_f))
    return (torch.stack(xs, dim=-2), torch.stack(us, dim=-2),
            torch.stack(costs, dim=-1))


def solve(problem: LQRProblem, x0: torch.Tensor, *, parallel: bool = False,
          time=None):
    """Exact LQR solve, one backward and one forward pass, from ``x0 [n]``
    or a batch ``x0 [B, n]`` (the state-independent policy is computed once
    and rolled out for every row). ``parallel=True`` takes the O(log T)
    backward of ``lqr_parallel.backward_parallel``; ``time`` (a
    ``lqr_parallel.TimeAxis``, with ``parallel``) splits its horizon over
    the axis's processes, each of which passes the whole problem and gets
    the whole trajectory (``parallel/mesh.py::solve_lqr_time_sharded``)."""
    if time is not None and not parallel:
        raise ValueError("a time axis splits the parallel backward: pass "
                         "parallel=True")
    if parallel:
        from tfmpc_tpu_torch.solvers.lqr_parallel import backward_parallel

        policy, _ = backward_parallel(problem, time)
    else:
        policy, _ = backward(problem)
    return forward(problem, x0, policy)
