"""Iterative LQR (iLQR): configuration, schedules and the single-scenario
solver.

Counterpart of ``tfmpc_tpu/solvers/ilqr.py``: nominal rollout, then
linearize -> regularized Riccati backward (restarted with a larger mu while
a Cholesky PD probe fails) -> parallel line search over the alpha grid,
until the cost decrease drops below ``atol``. The JAX package runs the loop
as one compiled ``lax.while_loop``; here it is a host loop that reads one
flag per iteration. ``solve`` is the semantics oracle of the batched solver
in ``ilqr_batched.py``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch.func import vmap

from tfmpc_tpu_torch.core.types import QuadraticFinal, map_fields
from tfmpc_tpu_torch.ops.riccati import riccati_backward_ref
from tfmpc_tpu_torch.ops.rollout import closed_loop_rollout

# Options of the JAX ILQRConfig that this package does not implement yet,
# with the value that keeps them off and the ROADMAP item that ports them.
_NOT_PORTED = {
    "boxqp": (False, "queue 1 item 7 (boxQP backward, slice B)"),
    "ddp": (False, "queue 1 item 13 (full DDP, slice D)"),
    "parallel_backward": (False, "queue 1 item 11 (parallel scan, slice C)"),
    "fuse_derivatives": (False, "queue 1 item 19 (fused derivatives)"),
    "time_axis": (None, "queue 1 item 18 (time-sharded solves)"),
}


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver configuration: the fields and defaults of the JAX package's
    ``ILQRConfig``, so a config carries over 1:1 (``interop.config_from_dict``).

    ``use_pallas`` keeps its name and switches the solver onto the CUDA
    kernels (``ops/``). Options this package does not implement yet raise
    ``NotImplementedError`` when set, naming the ROADMAP item that ports
    them; they are never silently ignored.
    ``linesearch_emit_trajectories=None`` (AUTO) always runs the two-kernel
    line search, which the JAX package pins semantically equal to the
    emit-trajectories one.
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
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ILQRConfig.{name}={getattr(self, name)!r} is not "
                    f"ported to PyTorch yet: ROADMAP {item}"
                )
        if self.linesearch_emit_trajectories:
            raise NotImplementedError(
                "ILQRConfig.linesearch_emit_trajectories=True is not ported "
                "to PyTorch yet: ROADMAP queue 1 item 12 (with kernel K5)"
            )

    def alphas(self, dtype=torch.float32, device="cpu") -> torch.Tensor:
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


def _check_env(env) -> None:
    if env.bounds is not None:
        raise NotImplementedError(
            "bounded envs need the KKT stationarity test, not ported to "
            "PyTorch yet: ROADMAP queue 1 item 8 (slice B)"
        )


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


def backward(lin, quad, final, mu, config: ILQRConfig):
    """Regularized Riccati backward pass (Tassa-style ``V + mu I``).

    Returns ``(ok, Policy, dV1, dV2)``; ``ok`` is False where a step's
    regularized ``Quu`` failed the Cholesky PD probe. Works on any leading
    batch dims (the plain version of kernel K1).
    """
    return riccati_backward_ref(lin, quad, final, mu)


def backward_with_restarts(lin, quad, final, mu, delta, config: ILQRConfig):
    """Backward pass restarted with a larger mu while the PD probe fails
    (one scenario)."""
    ok, policy, dV1, dV2 = backward(lin, quad, final, mu, config)
    tries = 0
    while (not bool(ok)) and bool(mu < config.mu_max) \
            and tries < config.max_backward_restarts:
        mu, delta = _increase_mu(mu, delta, config)
        ok, policy, dV1, dV2 = backward(lin, quad, final, mu, config)
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
    ok, policy, dV1, dV2, mu, delta = backward_with_restarts(
        lin, quad, final, state.mu, state.delta, config
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
    _check_env(env)
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
