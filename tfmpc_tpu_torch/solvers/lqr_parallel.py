"""Parallel Riccati backward pass in O(log T) depth.

Counterpart of ``tfmpc_tpu/solvers/lqr_parallel.py`` (the temporal
parallelization of Särkkä and García-Fernández, extended to the stacked
``F/f/C/c`` form with cross terms):

1. each step condenses into a conditional value-function element
   ``e_k = (A, b, C, eta, J)`` by eliminating ``u`` through the Schur
   complement of ``C_uu`` (``_elements``);
2. element composition is associative (``_combine(earlier, later)``), and
   the suffix compositions ``e_k ∘ ... ∘ e_T`` give the value function at
   every step at once. PyTorch has no associative scan, so the suffixes come
   from a doubling loop: in round d, ``e[k] = e[k] ∘ e[k + d]`` for every k
   with k + d <= T, all at once (ceil(log2(T + 1)) rounds);
3. the gains follow from ``V_{t+1}`` for all t in one batched solve.

JAX's reverse ``associative_scan`` composes in another tree, so the two
packages agree to rounding, not bit for bit. Every function takes any
leading batch dims (``[..., T, ...]``), so the batched solver needs no
vmap. Singular solves (``C_uu`` or ``I + C_i J_j``) give NaN for that lane,
as ``jnp.linalg.solve`` gives non-finite values, and fail its ``ok``;
nothing raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tfmpc_tpu_torch.core.types import LQRProblem, Policy, ValueFunction
from tfmpc_tpu_torch.ops.boxqp import boxqp, cholesky_nan, solve_free_system
from tfmpc_tpu_torch.solvers.lqr import _mv, cho_solve_nan, final_cost_terms


def _solve_nan(M, rhs):
    """``M^-1 rhs`` (``M [..., k, k]``, ``rhs [..., k, j]``) by LU, NaN
    where ``M`` is singular."""
    X, info = torch.linalg.solve_ex(M, rhs)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(X, torch.nan), X)


def _sym(M):
    return 0.5 * (M + M.mT)


def _elements(problem: LQRProblem):
    """Every step condensed into an element ``(A [..., T, n, n], b [..., T,
    n], C, eta, J)``."""
    n = problem.state_size
    F, C = problem.F, problem.C
    F_x, F_u = F[..., :n], F[..., n:]
    C_xx, C_xu = C[..., :n, :n], C[..., :n, n:]
    C_ux, C_uu = C[..., n:, :n], C[..., n:, n:]
    c_x, c_u = problem.c[..., :n], problem.c[..., n:]

    # C_uu^-1 [C_ux | c_u | F_u^T] in one solve
    S = _solve_nan(C_uu, torch.cat([C_ux, c_u[..., None], F_u.mT], dim=-1))
    Cuu_inv_Cux, Cuu_inv_cu, Cuu_inv_FuT = S[..., :n], S[..., n], S[..., n + 1:]

    A = F_x - F_u @ Cuu_inv_Cux
    b = problem.f - _mv(F_u, Cuu_inv_cu)
    Cov = F_u @ Cuu_inv_FuT
    J = C_xx - C_xu @ Cuu_inv_Cux
    eta = -(c_x - _mv(C_xu, Cuu_inv_cu))
    return A, b, _sym(Cov), eta, _sym(J)


def _combine(earlier, later):
    """Associative composition of two (batched) elements, earlier ∘ later."""
    A_i, b_i, C_i, eta_i, J_i = earlier
    A_j, b_j, C_j, eta_j, J_j = later
    n = A_i.shape[-1]
    I = torch.eye(n, dtype=A_i.dtype, device=A_i.device)

    # M = (I + C_i J_j)^-1; (I + J_j C_i)^-1 = M^T for symmetric C, J
    M = _solve_nan(I + C_i @ J_j, I.expand(A_i.shape))
    AjM = A_j @ M
    A = AjM @ A_i
    b = _mv(AjM, b_i + _mv(C_i, eta_j)) + b_j
    C = _sym(AjM @ C_i @ A_j.mT + C_j)

    AiTMT = A_i.mT @ M.mT
    eta = _mv(AiTMT, eta_j - _mv(J_j, b_i)) + eta_i
    J = _sym(AiTMT @ J_j @ A_i + J_i)
    return A, b, C, eta, J


# The time axis of each element field (A, b, C, eta, J).
_TIME_DIMS = (-3, -2, -3, -2, -3)


def _time_slice(elems, start, stop):
    """The steps ``start:stop`` of each element field."""
    return tuple(a.narrow(dim, start, stop - start)
                 for a, dim in zip(elems, _TIME_DIMS))


def _suffix_scan(elems):
    """``out[k] = e[k] ∘ e[k+1] ∘ ... ∘ e[T]`` for every k, by doubling:
    after the round of stride d, ``e[k]`` covers steps k .. k + 2d - 1."""
    L = elems[0].shape[-3]                                      # T + 1
    d = 1
    while d < L:
        new = _combine(_time_slice(elems, 0, L - d),
                       _time_slice(elems, d, L))
        elems = tuple(torch.cat([x, tail], dim=dim) for x, tail, dim in
                      zip(new, _time_slice(elems, L - d, L), _TIME_DIMS))
        d *= 2
    return elems


def backward_parallel(problem: LQRProblem) -> Tuple[Policy, ValueFunction]:
    """Associative-composition Riccati: the contract of ``lqr.backward``.

    The constant terms ``v_0`` are not accumulated by the parallel
    formulation and are returned as zeros; they affect no policy,
    trajectory or cost.
    """
    n = problem.state_size
    A, b, Cov, eta, J = _elements(problem)
    C_f, c_f = final_cost_terms(problem)
    # terminal element V_T(x) = 1/2 x^T C_f x + c_f^T x
    zero_m = torch.zeros_like(A[..., :1, :, :])
    elems = (torch.cat([A, zero_m], dim=-3),
             torch.cat([b, torch.zeros_like(b[..., :1, :])], dim=-2),
             torch.cat([Cov, zero_m], dim=-3),
             torch.cat([eta, -c_f[..., None, :]], dim=-2),
             torch.cat([J, C_f[..., None, :, :]], dim=-3))
    _, _, _, eta_all, V_xx = _suffix_scan(elems)
    v_x = -eta_all

    # all gains at once from V_{t+1}
    F = problem.F
    Vn, vn = V_xx[..., 1:, :, :], v_x[..., 1:, :]
    Q = problem.C + F.mT @ Vn @ F
    q = problem.c + _mv(F.mT, _mv(Vn, problem.f) + vn)
    Kk = -cho_solve_nan(Q[..., n:, n:],
                        torch.cat([Q[..., n:, :n], q[..., n:, None]], dim=-1))
    value = ValueFunction(V_xx=V_xx, v_x=v_x,
                          v_0=torch.zeros_like(v_x[..., 0]))
    return Policy(K=Kk[..., :n], k=Kk[..., n]), value


def _finite(a, dims):
    return torch.isfinite(a).flatten(-dims).all(dim=-1)


def _mu_eff(mu, mu_floor, like):
    return torch.clamp(torch.as_tensor(mu, dtype=like.dtype,
                                       device=like.device), min=mu_floor)


def _parallel_value_and_Q(lin, quad, final, mu_eff):
    """Shared core of the parallel iLQR backward variants: the
    cost-regularized delta-coordinate problem (``l_uu + mu_eff I``, zero
    affine term), its O(log T) value recursion, and the per-step Q terms
    ``(policy, Q_u, Q_uu, Q_uu_reg, Q_ux)``."""
    m = lin.f_u.shape[-1]
    I_m = torch.eye(m, dtype=lin.f_x.dtype, device=lin.f_x.device)
    mu_I = mu_eff[..., None, None, None] * I_m                 # [..., 1, m, m]
    l_uu_reg = quad.l_uu + mu_I
    problem = LQRProblem(
        F=torch.cat([lin.f_x, lin.f_u], dim=-1),
        f=torch.zeros_like(lin.f),
        C=torch.cat([torch.cat([quad.l_xx, quad.l_ux.mT], dim=-1),
                     torch.cat([quad.l_ux, l_uu_reg], dim=-1)], dim=-2),
        c=torch.cat([quad.l_x, quad.l_u], dim=-1),
        C_f=final.l_xx,
        c_f=final.l_x,
    )
    policy, value = backward_parallel(problem)

    V1, v1 = value.V_xx[..., 1:, :, :], value.v_x[..., 1:, :]
    fuT_V = lin.f_u.mT @ V1
    Q_u = quad.l_u + _mv(lin.f_u.mT, v1)
    Q_uu = quad.l_uu + fuT_V @ lin.f_u
    Q_ux = quad.l_ux + fuT_V @ lin.f_x
    return policy, Q_u, Q_uu, Q_uu + mu_I, Q_ux


def _expected_improvement(k, Q_u, Q_uu):
    dV1 = (k * Q_u).sum(dim=(-2, -1))
    dV2 = 0.5 * (k * _mv(Q_uu, k)).sum(dim=(-2, -1))
    return dV1, dV2


def ilqr_backward_parallel(lin, quad, final, mu, mu_floor: float = 1e-5):
    """iLQR backward pass in O(log T) depth, with the contract of
    ``ilqr.backward``: ``(ok, Policy, dV1, dV2)`` per lane of the leading
    dims (``lin.f_x [..., T, n, n]``, ``mu [...]``).

    As in the JAX package, mu enters as a Levenberg term on ``l_uu`` (cost
    regularization, which keeps the composition exact) rather than Tassa's
    ``V + mu I``, and is floored at ``mu_floor`` so that ``C_uu`` is
    invertible for envs whose cost is linear or absent in u; both vanish
    at convergence.
    """
    mu_eff = _mu_eff(mu, mu_floor, lin.f_x)
    policy, Q_u, Q_uu, Q_uu_reg, _ = _parallel_value_and_Q(
        lin, quad, final, mu_eff)
    ok = (_finite(cholesky_nan(Q_uu_reg), 3) & _finite(policy.K, 3)
          & _finite(policy.k, 2))
    return (ok, policy) + _expected_improvement(policy.k, Q_u, Q_uu)


def ilqr_backward_parallel_boxqp(lin, quad, final, mu, bounds, Ubar,
                                 mu_floor: float = 1e-5,
                                 boxqp_iters: int = 8):
    """Control-limited parallel backward: the unconstrained O(log T) value
    recursion, then every step's Q-minimization as a box-constrained QP at
    once (``k_t`` within ``[low - ubar_t, high - ubar_t]``, clamped rows of
    ``K_t`` zero), as the JAX package's variant does. ``Ubar [..., T, m]``
    is the nominal control. The value function does not see downstream
    clamping; the line search and the projected expected improvement keep
    the solve sound (see the JAX docstring).
    """
    mu_eff = _mu_eff(mu, mu_floor, lin.f_x)
    _, Q_u, Q_uu, Q_uu_reg, Q_ux = _parallel_value_and_Q(
        lin, quad, final, mu_eff)
    res = boxqp(Q_uu_reg, Q_u, bounds.low - Ubar, bounds.high - Ubar,
                max_iters=boxqp_iters)
    k = res.x
    K = -solve_free_system(res, Q_ux)
    ok = (_finite(cholesky_nan(Q_uu_reg), 3) & _finite(res.chol_free, 3)
          & _finite(K, 3) & _finite(k, 2))
    return (ok, Policy(K=K, k=k)) + _expected_improvement(k, Q_u, Q_uu)
