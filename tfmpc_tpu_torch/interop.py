"""Carry parameters, configs and solver state over from the JAX package.

Takes numpy arrays and plain dicts only, never JAX objects, so this package
stays free of JAX: ``np.asarray(jax_env.goal)``,
``dataclasses.asdict(jax_config)`` and the nine arrays of a JAX
``SolverState`` (``{k: np.asarray(v) for k, v in state._asdict().items()}``).
"""

from __future__ import annotations

import numpy as np
import torch

from tfmpc_tpu_torch.core.types import Bounds
from tfmpc_tpu_torch.models.navigation import Navigation
from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig
from tfmpc_tpu_torch.solvers.ilqr_batched import SolverState


def navigation_from_numpy(goal, centers, decays, low=None, high=None, *,
                          device, dtype) -> Navigation:
    """A ``Navigation`` env from the JAX env's parameter arrays."""
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dtype, device=device
    )
    goal = t(goal)
    bounds = None
    if low is not None or high is not None:
        n = goal.shape[-1]
        fill = lambda a, v: t(np.full(n, v) if a is None else a)  # noqa: E731
        bounds = Bounds(low=fill(low, -np.inf), high=fill(high, np.inf))
    return Navigation(goal=goal, centers=t(centers).reshape(-1, goal.shape[-1]),
                      decays=t(decays).reshape(-1), bounds=bounds)


def config_from_dict(d: dict) -> ILQRConfig:
    """An ``ILQRConfig`` from ``dataclasses.asdict`` of the JAX config (same
    field names; options not ported yet raise)."""
    return ILQRConfig(**d)


_STATE_DTYPES = {"iteration": torch.int32, "converged": torch.bool,
                 "failed": torch.bool}


def state_from_numpy(arrays: dict, *, device="cpu") -> SolverState:
    """A ``SolverState`` from the nine numpy arrays of a JAX ``SolverState``
    (keys ``X, U, J, mu, delta, iteration, converged, failed, residual``)."""
    return SolverState(**{
        name: torch.tensor(
            np.asarray(arrays[name]), dtype=_STATE_DTYPES.get(name),
            device=device,
        )
        for name in SolverState._fields
    })
