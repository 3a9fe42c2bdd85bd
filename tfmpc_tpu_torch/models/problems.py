"""LQR problem generators.

Counterpart of ``tfmpc_tpu/models/problems.py``: ``make_lqr`` (a random
time-invariant problem) and ``make_lqr_linear_navigation``, both broadcast
to the solver's time-varying ``[T, ...]`` contract.
"""

from __future__ import annotations

import torch

from tfmpc_tpu_torch.core.types import LQRProblem


def _broadcast_time(problem: LQRProblem, horizon: int) -> LQRProblem:
    """Tile time-invariant (F, f, C, c) to the ``[T, ...]`` contract."""
    tile = lambda a: a.expand((horizon,) + a.shape)  # noqa: E731
    return LQRProblem(F=tile(problem.F), f=tile(problem.f),
                      C=tile(problem.C), c=tile(problem.c),
                      C_f=problem.C_f, c_f=problem.c_f)


def make_lqr(generator: torch.Generator, state_size: int, action_size: int,
             horizon: int, *, stddev: float = 1.0, dtype=torch.float32,
             device="cuda") -> LQRProblem:
    """Random time-invariant LQR problem with PD ``C_uu``: normal ``F``,
    ``f`` and ``c``, and ``C = M M^T + 0.01 I`` from a normal ``M``.

    The draws come from ``generator`` (on its own device, in the order F, f,
    M, c) and then move to ``device``. They cannot match the JAX package's
    ``jax.random`` draws from any key, so to compare the two packages on one
    problem, carry its arrays across (``interop.lqr_problem_from_numpy``).
    """
    n, m = state_size, action_size

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device) * stddev

    F, f = normal(n, n + m), normal(n)
    M = normal(n + m, n + m)
    C = M @ M.T + 1e-2 * torch.eye(n + m, dtype=dtype, device=M.device)
    c = normal(n + m)
    base = LQRProblem(*(a.to(device) for a in (F, f, C, c)))
    return _broadcast_time(base, horizon)


def make_lqr_linear_navigation(goal, beta: float, horizon: int, *,
                               dtype=torch.float32,
                               device="cuda") -> LQRProblem:
    """Linear navigation, ``x' = x + u``, cost ``|x - g|^2 + beta |u|^2`` up
    to the constant ``g^T g``: ``F = [I | I]``, ``f = 0``,
    ``C = 2 blockdiag(I, beta I)``, ``c = [-2 g; 0]``, and the final cost
    ``|x - g|^2`` as ``C_f = 2 I``, ``c_f = -2 g``."""
    opts = dict(dtype=dtype, device=device)
    goal = torch.as_tensor(goal, **opts)
    n = m = goal.shape[-1]
    eye = torch.eye(n, **opts)
    C = torch.block_diag(2.0 * eye, 2.0 * beta * torch.eye(m, **opts))
    base = LQRProblem(
        F=torch.cat([eye, eye], dim=1),
        f=torch.zeros((n,), **opts),
        C=C,
        c=torch.cat([-2.0 * goal, torch.zeros((m,), **opts)]),
        C_f=2.0 * eye,
        c_f=-2.0 * goal,
    )
    return _broadcast_time(base, horizon)
