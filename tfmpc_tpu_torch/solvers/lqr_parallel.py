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

The horizon can be split over the processes of a ``torch.distributed``
group (a ``TimeAxis``: ``parallel/mesh.py`` builds it, ``set_mesh`` makes
it the active one), as the JAX package places these ``[T]``-leading
tensors on a mesh's "time" axis and lets GSPMD insert the collectives:

1. each rank condenses the elements of its block of the T + 1 (its steps;
   the last rank's also the terminal element) and runs ``_suffix_scan`` on
   them, whose first element is its block's total ``S_r``;
2. the ranks all-gather the W totals;
3. rank r composes ``R_r = S_{r+1} ∘ ... ∘ S_{W-1}`` and finishes its
   suffixes as ``out[k] ∘ R_r``: the value function at its elements, and
   ``V`` just past its last step is ``R_r``'s;
4. each rank recovers the gains of its own steps (the boxQP variant's
   re-pass too);
5. ``ok`` is all-reduced with MIN and ``dV1``, ``dV2`` with SUM, and the
   gains are all-gathered, so every rank returns the whole policy.

Only the backward is split; everything after it runs alike on every rank.
A ``gloo`` group exchanges the elements through the CPU, so a card's
tensors never meet a backend without CUDA collectives.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tfmpc_tpu_torch.core.types import LQRProblem, Policy, ValueFunction
from tfmpc_tpu_torch.ops.boxqp import boxqp, cholesky_nan, solve_free_system
from tfmpc_tpu_torch.solvers.lqr import _mv, cho_solve_nan, final_cost_terms


TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class TimeAxis:
    """The horizon split over the processes of a ``torch.distributed``
    group: ``group`` (None for one process), ``size`` processes, this
    process's ``rank`` on it. Rank r holds the r-th contiguous block of
    the T + 1 value-function elements (``elements``), the first
    ``(T + 1) % size`` blocks one element longer than the rest."""

    group: Optional[object]
    size: int
    rank: int

    def elements(self, T: int) -> Tuple[int, int]:
        """This rank's block ``[start, stop)`` of the T + 1 elements."""
        return self.block_of(self.rank, T)

    def block_of(self, rank: int, T: int) -> Tuple[int, int]:
        if T + 1 < self.size:
            raise ValueError(
                f"a horizon of {T} steps cannot be split over a time axis "
                f"of {self.size}: each rank needs one of the T + 1 "
                "value-function elements")
        q, r = divmod(T + 1, self.size)
        start = rank * q + min(rank, r)
        return start, start + q + (rank < r)

    def steps(self, T: int) -> Tuple[int, int]:
        """This rank's steps ``[start, stop)``: its elements but the
        terminal one."""
        start, stop = self.elements(T)
        return start, min(stop, T)

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


_ACTIVE_TIME = contextvars.ContextVar("tfmpc_active_time_axis", default=None)


@contextlib.contextmanager
def time_axis_scope(axis: Optional[TimeAxis]):
    """Make ``axis`` the active time axis inside the ``with`` block (the
    counterpart of ``jax.set_mesh`` for ``ILQRConfig.time_axis``;
    ``parallel/mesh.py::set_mesh`` enters it)."""
    token = _ACTIVE_TIME.set(axis)
    try:
        yield axis
    finally:
        _ACTIVE_TIME.reset(token)


def active_time_axis() -> Optional[TimeAxis]:
    """The time axis of the innermost ``time_axis_scope``, or None."""
    return _ACTIVE_TIME.get()


def _split(time: Optional[TimeAxis]) -> Optional[TimeAxis]:
    """``time`` where it splits the horizon (more than one process), else
    None: a time axis of one process is the unsplit computation."""
    return time if time is not None and time.size > 1 else None


def _staging(time: TimeAxis, t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: on its device for ``nccl``, on the
    CPU for any other backend (gloo has no CUDA collectives)."""
    if dist.get_backend(time.group) == "nccl":
        return t.device
    return torch.device("cpu")


def _all_reduce(time: TimeAxis, t: torch.Tensor, op) -> torch.Tensor:
    x = t.to(_staging(time, t), copy=True).contiguous()
    dist.all_reduce(x, op=op, group=time.group)
    return x.to(t.device)


def _all_gather(time: TimeAxis, t: torch.Tensor):
    """Every rank's ``t`` (one shape on all ranks), in rank order."""
    x = t.to(_staging(time, t)).contiguous()
    out = [torch.empty_like(x) for _ in range(time.size)]
    dist.all_gather(out, x, group=time.group)
    return [o.to(t.device) for o in out]


def any_on_axis(flag: torch.Tensor, time: Optional[TimeAxis]) -> bool:
    """``bool(flag.any())``, the same on every rank of a split time axis
    (the ranks' flags OR-ed by an all-reduce), so that no rank takes a
    branch around the backward's collectives that another does not."""
    flag = flag.any()
    time = _split(time)
    if time is not None:
        flag = _all_reduce(time, flag.to(torch.int32), dist.ReduceOp.MAX)
    return bool(flag)


def _flat(t, dim):
    """``t [..., L, *tail]`` (time at ``dim``) as ``[..., L, prod(tail)]``."""
    return t.reshape(t.shape[:t.ndim + dim + 1] + (-1,))


def _gather_elements(time: TimeAxis, T: int, fields, dims):
    """Each of ``fields`` (this rank's block of the T + 1 elements on its
    dim ``dims[i]``, every other dim alike on every rank) with all T + 1
    elements, in rank order: one all-gather of the fields packed together,
    each block padded to the longest."""
    flat = [_flat(f, d) for f, d in zip(fields, dims)]
    widths = [f.shape[-1] for f in flat]
    packed = torch.cat(flat, dim=-1)
    start, stop = time.elements(T)
    longest = -(-(T + 1) // time.size)
    pad = packed.new_zeros(packed.shape[:-2] + (longest - (stop - start),
                                                packed.shape[-1]))
    blocks = _all_gather(time, torch.cat([packed, pad], dim=-2))
    whole = torch.cat([b[..., :hi - lo, :] for b, (lo, hi) in zip(
        blocks, (time.block_of(r, T) for r in range(time.size)))], dim=-2)
    out = []
    for f, d, piece in zip(fields, dims, whole.split(widths, dim=-1)):
        tail = f.shape[f.ndim + d + 1:]
        out.append(piece.reshape(piece.shape[:-1] + tail))
    return out


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


def _append_terminal(elems, problem):
    """The elements followed by the terminal one, ``V_T(x) = 1/2 x^T C_f x
    + c_f^T x``."""
    A, b, Cov, eta, J = elems
    C_f, c_f = final_cost_terms(problem)
    zero_m = A.new_zeros(A.shape[:-3] + (1,) + A.shape[-2:])
    return (torch.cat([A, zero_m], dim=-3),
            torch.cat([b, b.new_zeros(b.shape[:-2] + (1,) + b.shape[-1:])],
                      dim=-2),
            torch.cat([Cov, zero_m], dim=-3),
            torch.cat([eta, -c_f[..., None, :]], dim=-2),
            torch.cat([J, C_f[..., None, :, :]], dim=-3))


def _finish_block(out, time: TimeAxis):
    """Steps 2-3 of a split horizon: the suffixes ``out`` of this rank's
    block composed with ``R_r``, the composition of the later ranks'
    totals. Returns the finished suffixes and ``R_r`` (None on the last
    rank)."""
    total = tuple(a.narrow(dim, 0, 1) for a, dim in zip(out, _TIME_DIMS))
    # one element a rank: the W totals gathered as the elements of a
    # horizon of W - 1 steps
    gathered = _gather_elements(time, time.size - 1, total, _TIME_DIMS)
    if time.last:
        return out, None
    later = tuple(a.narrow(dim, time.size - 1, 1)
                  for a, dim in zip(gathered, _TIME_DIMS))
    for r in range(time.size - 2, time.rank, -1):
        later = _combine(tuple(a.narrow(dim, r, 1) for a, dim in
                               zip(gathered, _TIME_DIMS)), later)
    return _combine(out, later), later


def _gains(problem: LQRProblem, Vn, vn) -> Policy:
    """Every step's gains at once from ``V_{t+1}`` (``Vn``, ``vn``)."""
    n = problem.state_size
    F = problem.F
    Q = problem.C + F.mT @ Vn @ F
    q = problem.c + _mv(F.mT, _mv(Vn, problem.f) + vn)
    Kk = -cho_solve_nan(Q[..., n:, n:],
                        torch.cat([Q[..., n:, :n], q[..., n:, None]], dim=-1))
    return Policy(K=Kk[..., :n], k=Kk[..., n])


def _block_backward(problem: LQRProblem, time: Optional[TimeAxis]):
    """The value recursion and the gains of ``problem``'s steps: the whole
    horizon, or with a split ``time`` axis this rank's block of it
    (``time_block``). Returns ``(policy, V_xx, v_x, Vn, vn)``: the value
    function at the block's elements, and ``V_{t+1}`` of each step."""
    elems = _elements(problem)
    if time is None or time.last:
        elems = _append_terminal(elems, problem)
    out = _suffix_scan(elems)
    later = None
    if time is not None:
        out, later = _finish_block(out, time)
    _, _, _, eta_all, V_xx = out
    v_x = -eta_all
    Vn, vn = V_xx[..., 1:, :, :], v_x[..., 1:, :]
    if later is not None:
        Vn = torch.cat([Vn, later[4]], dim=-3)
        vn = torch.cat([vn, -later[3]], dim=-2)
    return _gains(problem, Vn, vn), V_xx, v_x, Vn, vn


def time_block(problem: LQRProblem, time: TimeAxis) -> LQRProblem:
    """This rank's steps of ``problem`` (``F``, ``f``, ``C``, ``c``); the
    final cost ``C_f``, ``c_f`` whole, as every rank keeps it."""
    step = lambda a, dim: _steps_of(a, time, problem.horizon,  # noqa: E731
                                    dim)
    return dataclasses.replace(problem, F=step(problem.F, -3),
                               f=step(problem.f, -2), C=step(problem.C, -3),
                               c=step(problem.c, -2))


def _with_terminal_row(x, dim, time: TimeAxis):
    """Per-step ``x`` as per-element: a zero row for the terminal element
    on the last rank, so that every rank's block has its elements' rows."""
    if not time.last:
        return x
    shape = list(x.shape)
    shape[dim] = 1
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _gather_policy(policy: Policy, T: int, time: TimeAxis) -> Policy:
    K, k = _gather_elements(time, T, (_with_terminal_row(policy.K, -3, time),
                                      _with_terminal_row(policy.k, -2, time)),
                            (-3, -2))
    return Policy(K=K[..., :T, :, :], k=k[..., :T, :])


def backward_parallel(problem: LQRProblem, time: Optional[TimeAxis] = None
                      ) -> Tuple[Policy, ValueFunction]:
    """Associative-composition Riccati: the contract of ``lqr.backward``.

    With a ``time`` axis of more than one process, every rank passes the
    whole problem, computes its block of the horizon (``time_block``) and
    returns the whole policy and value function, gathered.

    The constant terms ``v_0`` are not accumulated by the parallel
    formulation and are returned as zeros; they affect no policy,
    trajectory or cost.
    """
    time = _split(time)
    if time is None:
        policy, V_xx, v_x, _, _ = _block_backward(problem, None)
    else:
        T = problem.horizon
        policy, V_xx, v_x, _, _ = _block_backward(time_block(problem, time),
                                                  time)
        policy = _gather_policy(policy, T, time)
        V_xx, v_x = _gather_elements(time, T, (V_xx, v_x), (-3, -2))
    value = ValueFunction(V_xx=V_xx, v_x=v_x,
                          v_0=torch.zeros_like(v_x[..., 0]))
    return policy, value


def _finite(a, dims):
    return torch.isfinite(a).flatten(-dims).all(dim=-1)


def _mu_eff(mu, mu_floor, like):
    return torch.clamp(torch.as_tensor(mu, dtype=like.dtype,
                                       device=like.device), min=mu_floor)


def _steps_of(x, time: Optional[TimeAxis], T: int, dim: int):
    """This rank's steps of the per-step ``x`` (time at ``dim``), or all
    of them without a split axis."""
    if time is None:
        return x
    start, stop = time.steps(T)
    return x.narrow(dim, start, stop - start)


def _parallel_value_and_Q(lin, quad, final, mu_eff, time=None):
    """Shared core of the parallel iLQR backward variants: the
    cost-regularized delta-coordinate problem (``l_uu + mu_eff I``, zero
    affine term), its O(log T) value recursion, and the per-step Q terms
    ``(policy, Q_u, Q_uu, Q_uu_reg, Q_ux)``: of every step, or with a split
    ``time`` axis of this rank's steps (the models are whole on every
    rank)."""
    T, m = lin.f_u.shape[-3], lin.f_u.shape[-1]
    step = lambda a, dim: _steps_of(a, time, T, dim)  # noqa: E731
    f_x, f_u = step(lin.f_x, -3), step(lin.f_u, -3)
    l_x, l_u = step(quad.l_x, -2), step(quad.l_u, -2)
    l_xx, l_uu, l_ux = (step(quad.l_xx, -3), step(quad.l_uu, -3),
                        step(quad.l_ux, -3))
    I_m = torch.eye(m, dtype=f_x.dtype, device=f_x.device)
    mu_I = mu_eff[..., None, None, None] * I_m                 # [..., 1, m, m]
    l_uu_reg = l_uu + mu_I
    problem = LQRProblem(
        F=torch.cat([f_x, f_u], dim=-1),
        f=torch.zeros_like(step(lin.f, -2)),
        C=torch.cat([torch.cat([l_xx, l_ux.mT], dim=-1),
                     torch.cat([l_ux, l_uu_reg], dim=-1)], dim=-2),
        c=torch.cat([l_x, l_u], dim=-1),
        C_f=final.l_xx,
        c_f=final.l_x,
    )
    policy, _, _, V1, v1 = _block_backward(problem, time)
    fuT_V = f_u.mT @ V1
    Q_u = l_u + _mv(f_u.mT, v1)
    Q_uu = l_uu + fuT_V @ f_u
    Q_ux = l_ux + fuT_V @ f_x
    return policy, Q_u, Q_uu, Q_uu + mu_I, Q_ux


def _expected_improvement(k, Q_u, Q_uu):
    dV1 = (k * Q_u).sum(dim=(-2, -1))
    dV2 = 0.5 * (k * _mv(Q_uu, k)).sum(dim=(-2, -1))
    return dV1, dV2


def _combine_ranks(ok, policy, dV1, dV2, T, time):
    """Step 5 of a split horizon: ``ok`` all-reduced with MIN, ``dV1`` and
    ``dV2`` with SUM, the gains all-gathered; without a split axis the
    arguments as they are."""
    if time is None:
        return ok, policy, dV1, dV2
    ok = _all_reduce(time, ok.to(torch.int32), dist.ReduceOp.MIN).bool()
    dV = _all_reduce(time, torch.stack([dV1, dV2]), dist.ReduceOp.SUM)
    return ok, _gather_policy(policy, T, time), dV[0], dV[1]


def ilqr_backward_parallel(lin, quad, final, mu, mu_floor: float = 1e-5,
                           time: Optional[TimeAxis] = None):
    """iLQR backward pass in O(log T) depth, with the contract of
    ``ilqr.backward``: ``(ok, Policy, dV1, dV2)`` per lane of the leading
    dims (``lin.f_x [..., T, n, n]``, ``mu [...]``).

    As in the JAX package, mu enters as a Levenberg term on ``l_uu`` (cost
    regularization, which keeps the composition exact) rather than Tassa's
    ``V + mu I``, and is floored at ``mu_floor`` so that ``C_uu`` is
    invertible for envs whose cost is linear or absent in u; both vanish
    at convergence.

    With a ``time`` axis of more than one process every rank passes the
    whole models, computes its steps, and returns the whole result.
    """
    time = _split(time)
    mu_eff = _mu_eff(mu, mu_floor, lin.f_x)
    policy, Q_u, Q_uu, Q_uu_reg, _ = _parallel_value_and_Q(
        lin, quad, final, mu_eff, time)
    ok = (_finite(cholesky_nan(Q_uu_reg), 3) & _finite(policy.K, 3)
          & _finite(policy.k, 2))
    return _combine_ranks(ok, policy,
                          *_expected_improvement(policy.k, Q_u, Q_uu),
                          lin.f_u.shape[-3], time)


def ilqr_backward_parallel_boxqp(lin, quad, final, mu, bounds, Ubar,
                                 mu_floor: float = 1e-5,
                                 boxqp_iters: int = 8,
                                 time: Optional[TimeAxis] = None):
    """Control-limited parallel backward: the unconstrained O(log T) value
    recursion, then every step's Q-minimization as a box-constrained QP at
    once (``k_t`` within ``[low - ubar_t, high - ubar_t]``, clamped rows of
    ``K_t`` zero), as the JAX package's variant does. ``Ubar [..., T, m]``
    is the nominal control. The value function does not see downstream
    clamping; the line search and the projected expected improvement keep
    the solve sound (see the JAX docstring). With a split ``time`` axis
    each rank runs the boxQP re-pass of its own steps.
    """
    time = _split(time)
    T = lin.f_u.shape[-3]
    mu_eff = _mu_eff(mu, mu_floor, lin.f_x)
    _, Q_u, Q_uu, Q_uu_reg, Q_ux = _parallel_value_and_Q(
        lin, quad, final, mu_eff, time)
    Ubar = _steps_of(Ubar, time, T, -2)
    res = boxqp(Q_uu_reg, Q_u, bounds.low - Ubar, bounds.high - Ubar,
                max_iters=boxqp_iters)
    k = res.x
    K = -solve_free_system(res, Q_ux)
    ok = (_finite(cholesky_nan(Q_uu_reg), 3) & _finite(res.chol_free, 3)
          & _finite(K, 3) & _finite(k, 2))
    return _combine_ranks(ok, Policy(K=K, k=k),
                          *_expected_improvement(k, Q_u, Q_uu), T, time)
