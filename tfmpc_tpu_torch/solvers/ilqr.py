"""Iterative LQR (iLQR): configuration, schedules and the single-scenario
solver.

Counterpart of ``tfmpc_tpu/solvers/ilqr.py``: nominal rollout, then
linearize -> regularized Riccati backward (restarted with a larger mu while
a Cholesky PD probe fails) -> parallel line search over the alpha grid,
until the cost decrease drops below ``atol``. Controls of a bounded env are
clipped in the rollouts, and with ``ILQRConfig(boxqp=True)`` the backward
pass solves the control-limited (boxQP) Q-minimization; a bounded env also
gets the KKT stationarity test when the line search accepts nothing. With
``ILQRConfig(ddp=True)`` the backward pass is full second-order DDP: the
dynamics Hessians enter the Q blocks. The
JAX package runs the loop as one compiled ``lax.while_loop``; here it is a
host loop that reads one flag per iteration. ``solve`` is the semantics
oracle of the batched solver in ``ilqr_batched.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from tfmpc_tpu_torch.core.types import QuadraticFinal, map_fields
from tfmpc_tpu_torch.ops.riccati import (
    riccati_backward_boxqp_ref,
    riccati_backward_ddp_boxqp_ref,
    riccati_backward_ddp_ref,
    riccati_backward_ref,
)
from tfmpc_tpu_torch.ops.rollout import closed_loop_rollout
from tfmpc_tpu_torch.solvers.lqr_parallel import (
    ilqr_backward_parallel,
    ilqr_backward_parallel_boxqp,
)

# Options of the JAX ILQRConfig that this package does not implement yet,
# with the value that keeps them off and the ROADMAP item that ports them.
_NOT_PORTED = {
    "time_axis": (None, "queue 1 item 2 (parallel/mesh.py: time-sharded "
                  "solves)"),
}


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver configuration: the fields and defaults of the JAX package's
    ``ILQRConfig``, so a config carries over 1:1 (``interop.config_from_dict``).

    ``use_pallas`` keeps its name and switches the solver onto the CUDA
    kernels (``ops/``). Options this package does not implement yet raise
    ``NotImplementedError`` when set, naming the ROADMAP item that ports
    them; they are never silently ignored.

    ``parallel_backward=True`` runs the O(log T) associative-composition
    backward (``lqr_parallel.py``, cost-regularized with
    ``parallel_mu_floor``), with or without the kernels for the rollouts.
    ``linesearch_emit_trajectories`` picks the line search's layout on the
    kernel path: True runs K5, one rollout chain that writes every alpha's
    trajectory, and selects each lane's accepted one; False runs K2 for the
    costs and K3 to re-roll the accepted alpha; None (AUTO) takes the
    emit-trajectories layout (``ilqr_batched._resolve_emit_traj`` says
    why). Both layouts compute the same arithmetic, so the solve is the
    same.

    ``fuse_derivatives=True`` (with ``use_pallas``) runs the fully-fused
    iteration of ``ilqr_batched._iteration_fused``: the accepted-alpha
    rollout (K8) also writes the linearization of the new trajectory in
    the Riccati kernels' layout, so the loop has no derivatives stage and
    no layout copies. It needs an env with a device linearization
    (``Env.device_derivatives``: navigation) at the lane kernels' dims and
    neither ``ddp`` nor ``parallel_backward``; on CUDA anything else raises
    (``ilqr_batched._use_fused_derivs``). Its semantics are the split
    iteration's.

    ``ddp=True`` is full second-order DDP: each iteration also computes the
    dynamics Hessians (``Env.get_second_order_transition``), which the
    backward pass contracts with the value gradient (the JAX package's
    ``ILQRConfig.ddp``; on the kernel path K6a, or K6b with ``boxqp``). Far
    from the optimum it restarts more than iLQR; the JAX package's recipe
    is a few iLQR iterations, then ``resume`` with ``ddp=True``.
    """

    atol: float = 1e-4
    max_iterations: int = 100
    mu_init: float = 0.0
    mu_min: float = 1e-6
    mu_max: float = 1e10
    delta_0: float = 2.0
    num_alphas: int = 11
    accept_ratio: float = 0.0  # z-test threshold on actual/expected reduction
    max_backward_restarts: int = 40
    boxqp: bool = False
    boxqp_iters: int = 8
    ddp: bool = False
    use_pallas: bool = False
    fuse_derivatives: bool = False
    linesearch_emit_trajectories: Optional[bool] = None
    parallel_backward: bool = False
    parallel_mu_floor: float = 1e-5
    time_axis: Optional[str] = None
    kkt_atol: float = 1e-4

    def __post_init__(self):
        if self.ddp and self.parallel_backward:
            raise ValueError(
                "ddp=True is incompatible with parallel_backward=True: the "
                "associative-scan backward composes LINEAR value-recursion "
                "elements, and the DDP tensor terms depend on v_x mid-"
                "recursion"
            )
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ILQRConfig.{name}={getattr(self, name)!r} is not "
                    f"ported to PyTorch yet: ROADMAP {item}"
                )

    def alphas(self, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Tassa's line-search schedule alpha_i = 1.1^(-i^2), computed in
        float64 and rounded once to ``dtype``: exactly the values the
        line-search kernel receives (``alphas_static``), so the accepted
        alpha that the materialize rollout re-rolls is the one that was
        evaluated. (The JAX package computes this grid in ``dtype``; in
        float32 it then differs from the kernel's grid by about one ulp.)
        """
        return torch.tensor(self.alphas_static(), dtype=dtype, device=device)

    def alphas_static(self) -> tuple:
        """The same schedule as Python floats (passed to the kernels)."""
        return tuple(1.1 ** -float(i * i) for i in range(self.num_alphas))


class ILQRResult(NamedTuple):
    """Solve output (every field per scenario when batched)."""

    states: torch.Tensor      # [..., T+1, n]
    actions: torch.Tensor     # [..., T, m]
    costs: torch.Tensor       # [..., T+1] per-step costs of the final trajectory
    total_cost: torch.Tensor  # [...]
    iterations: torch.Tensor  # outer iterations executed (int32)
    converged: torch.Tensor   # bool: residual < atol reached
    residual: torch.Tensor    # last |cost decrease|
    mu: torch.Tensor          # final regularization
    delta: torch.Tensor       # regularization schedule multiplier
    failed: torch.Tensor      # bool: no progress possible (mu at ceiling)


class ILQRTrace(NamedTuple):
    """Per-iteration statistics, leading axis = outer iteration."""

    J: torch.Tensor
    residual: torch.Tensor
    mu: torch.Tensor
    alpha: torch.Tensor
    accepted: torch.Tensor
    converged: torch.Tensor


class _LoopState(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    J: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    iteration: torch.Tensor
    converged: torch.Tensor
    failed: torch.Tensor
    residual: torch.Tensor


def _increase_mu(mu, delta, config: ILQRConfig):
    """Tassa et al. 2012 regularization increase."""
    delta = torch.clamp(delta * config.delta_0, min=config.delta_0)
    mu = torch.clamp(mu * delta, min=config.mu_min)
    return mu, delta


def _decrease_mu(mu, delta, config: ILQRConfig):
    delta = torch.clamp(delta / config.delta_0, max=1.0 / config.delta_0)
    mu_scaled = mu * delta
    mu = torch.where(mu_scaled >= config.mu_min, mu_scaled,
                     torch.zeros_like(mu_scaled))
    return mu, delta


def _absmax(a, axes):
    a = a.abs()
    return a.amax(dim=axes) if axes is not None else a.max()


def _kkt_scale(g, axes=None):
    """``max(1, ||g||_inf)`` over ``axes`` (None: the whole tensor;
    ``(1, 2)``: per lane of a ``[B, T, m]`` gradient), the normalizer of
    the relative KKT test (see the JAX package's ``ILQRConfig.kkt_atol``)."""
    return torch.clamp(_absmax(g, axes), min=1.0)


def _kkt_threshold(config, g, bounds, axes=None):
    """Projected-gradient threshold ``kkt_atol * max(1, ||g||_inf)``,
    capped at 10% of the narrowest finite box width so the test can never
    pass vacuously everywhere in the box; all-infinite bounds leave it
    uncapped."""
    width = bounds.high - bounds.low
    finite_w = torch.where(torch.isfinite(width), width,
                           torch.full_like(width, torch.inf)).min()
    return torch.minimum(config.kkt_atol * _kkt_scale(g, axes),
                         0.1 * finite_w)


def _kkt_stationary(env, x0, U, config, axes=None):
    """KKT stationarity of the controls ``U`` of a bounded env:
    ``||U - clip(U - dJ/dU)||_inf`` below ``_kkt_threshold``, per lane over
    ``axes``. The gradient is ``torch.autograd.grad`` of the summed total
    cost; scenarios are independent, so each lane's gradient is that of
    its own cost (``jax.grad`` of ``env.total_cost`` in the JAX package)."""
    with torch.enable_grad():
        U_ = U.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(env.total_cost(x0.detach(), U_).sum(), U_)
    pg = U - env.clip(U - g)
    return _absmax(pg, axes) < _kkt_threshold(config, g, env.bounds, axes)


def derivatives(env, X, U):
    """Linearize the dynamics and quadratize the costs along ``X [..., T+1,
    n]``, ``U [..., T, m]`` (any leading batch dims): the env's closed-form
    ``analytic_derivatives`` where provided, else ``vmap(jacfwd)``."""
    analytic = env.analytic_derivatives(X, U)
    if analytic is not None:
        return analytic
    n, m = X.shape[-1], U.shape[-1]
    lead = U.shape[:-1]                      # [..., T]
    lin = env.get_linear_transition(
        X[..., :-1, :].reshape(-1, n), U.reshape(-1, m), batch=True
    )
    quad = env.get_quadratic_cost(
        X[..., :-1, :].reshape(-1, n), U.reshape(-1, m), batch=True
    )

    def final_fields(x):
        f = env.get_quadratic_final_cost(x)
        return f.l, f.l_x, f.l_xx

    xT = X[..., -1, :]
    final = QuadraticFinal(*vmap(final_fields)(xT.reshape(-1, n)))
    return (
        map_fields(lambda a: a.reshape(lead + a.shape[1:]), lin),
        map_fields(lambda a: a.reshape(lead + a.shape[1:]), quad),
        map_fields(lambda a: a.reshape(xT.shape[:-1] + a.shape[1:]), final),
    )


def second_derivatives(env, X, U):
    """The dynamics Hessians (full DDP) along ``X [..., T+1, n]``, ``U [...,
    T, m]`` (any leading batch dims): ``get_second_order_transition``
    mapped over the flattened ``[..., T]`` points, as ``derivatives``
    maps the linearization."""
    n, m = X.shape[-1], U.shape[-1]
    lead = U.shape[:-1]
    second = env.get_second_order_transition(
        X[..., :-1, :].reshape(-1, n), U.reshape(-1, m), batch=True)
    return map_fields(lambda a: a.reshape(lead + a.shape[1:]), second)


def backward(lin, quad, final, mu, config: ILQRConfig, bounds=None,
             Ubar=None, second=None):
    """Regularized Riccati backward pass (Tassa-style ``V + mu I``).

    Returns ``(ok, Policy, dV1, dV2)``; ``ok`` is False where a step's
    regularized ``Quu`` failed the Cholesky PD probe. With
    ``config.boxqp`` and ``bounds``/``Ubar`` given, each step's ``k`` is the
    boxQP minimizer within ``[low - ubar_t, high - ubar_t]`` and the clamped
    rows of ``K`` are zero (control-limited DDP). With ``second`` (a
    ``SecondOrderModel``) the pass is full DDP: the dynamics Hessians
    contracted with the value gradient enter every Q block and QuuR gets
    ``mu I_m`` (``ops/riccati.py::_backward_scan``). Works on any leading
    batch dims (the plain versions of kernels K1, K4, K6a and K6b).

    With ``config.parallel_backward`` the pass is the O(log T) composition
    of ``lqr_parallel.py`` instead (its boxQP variant under the same
    condition), regularized on the cost with ``mu`` floored at
    ``config.parallel_mu_floor``.
    """
    use_boxqp = config.boxqp and bounds is not None and Ubar is not None
    if config.parallel_backward:
        if second is not None:
            raise ValueError(
                "ddp=True is incompatible with parallel_backward=True: the "
                "associative-scan backward composes LINEAR value-recursion "
                "elements")
        if use_boxqp:
            return ilqr_backward_parallel_boxqp(
                lin, quad, final, mu, bounds, Ubar,
                mu_floor=config.parallel_mu_floor,
                boxqp_iters=config.boxqp_iters)
        return ilqr_backward_parallel(lin, quad, final, mu,
                                      mu_floor=config.parallel_mu_floor)
    if second is not None:
        if use_boxqp:
            return riccati_backward_ddp_boxqp_ref(
                lin, quad, final, mu, bounds, Ubar, second,
                config.boxqp_iters)
        return riccati_backward_ddp_ref(lin, quad, final, mu, second)
    if use_boxqp:
        return riccati_backward_boxqp_ref(lin, quad, final, mu, bounds, Ubar,
                                          config.boxqp_iters)
    return riccati_backward_ref(lin, quad, final, mu)


def backward_with_restarts(lin, quad, final, mu, delta, config: ILQRConfig,
                           bounds=None, Ubar=None, second=None):
    """Backward pass restarted with a larger mu while the PD probe fails
    (one scenario)."""
    def attempt(mu_):
        return backward(lin, quad, final, mu_, config, bounds, Ubar, second)

    ok, policy, dV1, dV2 = attempt(mu)
    tries = 0
    while (not bool(ok)) and bool(mu < config.mu_max) \
            and tries < config.max_backward_restarts:
        mu, delta = _increase_mu(mu, delta, config)
        ok, policy, dV1, dV2 = attempt(mu)
        tries += 1
    return ok, policy, dV1, dV2, mu, delta


def forward(env, X, U, policy, alpha):
    """Closed-loop rollout ``u = clip(ubar + alpha k + K (x - xbar))``.

    Returns ``(X_new, U_new, J_new)`` with ``J_new = +inf`` on numerical
    blowup; ``alpha`` broadcasts against the leading dims of ``X``.
    """
    return closed_loop_rollout(env, X, U, policy.K, policy.k, alpha)


def _iteration(env, state: _LoopState, config: ILQRConfig, alphas):
    """One outer iteration: derivatives -> backward -> line search."""
    lin, quad, final = derivatives(env, state.X, state.U)
    second = second_derivatives(env, state.X, state.U) if config.ddp \
        else None
    ok, policy, dV1, dV2, mu, delta = backward_with_restarts(
        lin, quad, final, state.mu, state.delta, config, env.bounds, state.U,
        second,
    )
    # every alpha of the grid at once: leading dim [A]
    X_all, U_all, J_all = forward(env, state.X, state.U, policy, alphas)

    expected = -(alphas * dV1 + alphas**2 * dV2)
    z = (state.J - J_all) / torch.where(
        expected > 0, expected, torch.ones_like(expected)
    )
    accepted = torch.where(
        expected > 0.0, z > config.accept_ratio, J_all < state.J
    ) & ok
    at_optimum = ok & (-(dV1 + dV2) < config.atol)

    any_accepted = accepted.any()
    best = torch.argmax(accepted.to(torch.uint8))  # first True: largest alpha
    X_new = torch.where(any_accepted, X_all[best], state.X)
    U_new = torch.where(any_accepted, U_all[best], state.U)
    J_new = torch.where(any_accepted, J_all[best], state.J)

    # KKT stationarity (bounded envs), only where nothing was accepted: the
    # only case in which it changes the outcome
    if env.bounds is not None and not bool(any_accepted):
        at_optimum = at_optimum | _kkt_stationary(env, state.X[0], U_new,
                                                  config)

    zero = torch.zeros_like(state.J)
    residual = torch.where(
        any_accepted, state.J - J_new,
        torch.where(at_optimum, zero, zero + torch.inf),
    )
    mu_dec, delta_dec = _decrease_mu(mu, delta, config)
    mu_inc, delta_inc = _increase_mu(mu, delta, config)
    good = any_accepted | at_optimum
    mu_next = torch.where(good, mu_dec, mu_inc)
    converged = at_optimum | (any_accepted & (residual.abs() < config.atol))
    failed = (~any_accepted) & ~at_optimum & (mu_next >= config.mu_max)
    return _LoopState(
        X=X_new,
        U=U_new,
        J=J_new,
        mu=mu_next,
        delta=torch.where(good, delta_dec, delta_inc),
        iteration=state.iteration + 1,
        converged=converged,
        failed=state.failed | failed,
        residual=residual,
    )


def solve(env, x0, U0=None, *, horizon: Optional[int] = None,
          config: ILQRConfig = ILQRConfig()) -> ILQRResult:
    """Solve one trajectory-optimization instance with iLQR.

    ``x0 [n]``; ``U0 [T, m]`` defaults to zeros (pass ``horizon`` instead).
    """
    if U0 is None:
        if horizon is None:
            raise ValueError("provide either U0 or horizon")
        U0 = torch.zeros((horizon, env.action_size), dtype=x0.dtype,
                         device=x0.device)
    U0 = env.clip(U0)
    X0, costs0 = env.rollout(x0, U0)
    alphas = config.alphas(x0.dtype, x0.device)
    scalar = lambda v, dtype=x0.dtype: torch.tensor(  # noqa: E731
        v, dtype=dtype, device=x0.device
    )
    state = _LoopState(
        X=X0,
        U=U0,
        J=costs0.sum(),
        mu=scalar(config.mu_init),
        delta=scalar(1.0),
        iteration=scalar(0, torch.int32),
        converged=scalar(False, torch.bool),
        failed=scalar(False, torch.bool),
        residual=scalar(torch.inf),
    )
    while int(state.iteration) < config.max_iterations \
            and not bool(state.converged) and not bool(state.failed):
        state = _iteration(env, state, config, alphas)

    _, costs = env.rollout(x0, state.U)
    return ILQRResult(
        states=state.X,
        actions=state.U,
        costs=costs,
        total_cost=state.J,
        iterations=state.iteration,
        converged=state.converged,
        residual=state.residual,
        mu=state.mu,
        delta=state.delta,
        failed=state.failed,
    )


def solve_batch(env, x0, U0=None, *, horizon: Optional[int] = None,
                config: ILQRConfig = ILQRConfig(), init_state=None,
                return_trace: bool = False):
    """Batched iLQR over a leading scenario axis; see
    ``ilqr_batched.solve_batch``."""
    from tfmpc_tpu_torch.solvers import ilqr_batched

    return ilqr_batched.solve_batch(
        env, x0, U0, horizon=horizon, config=config, init_state=init_state,
        return_trace=return_trace,
    )
