"""Carry parameters, configs and solver state over from the JAX package.

Takes numpy arrays and plain dicts only, never JAX objects, so this package
stays free of JAX: ``np.asarray(jax_env.goal)``,
``dataclasses.asdict(jax_config)`` and the nine arrays of a JAX
``SolverState`` (``{k: np.asarray(v) for k, v in state._asdict().items()}``).
Everything lands on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfmpc_tpu_torch.core.types import Bounds, LQRProblem
from tfmpc_tpu_torch.models.hvac import HVAC
from tfmpc_tpu_torch.models.linear import LinearSystem
from tfmpc_tpu_torch.models.navigation import Navigation
from tfmpc_tpu_torch.models.reservoir import Reservoir
from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig
from tfmpc_tpu_torch.solvers.ilqr_batched import SolverState

_ENV_CLASSES = {"navigation": Navigation, "hvac": HVAC,
                "reservoir": Reservoir, "linear": LinearSystem}


def env_from_numpy(name: str, arrays: dict, *, device="cuda",
                   dtype=torch.float32):
    """An env of the registry name ``name`` from the JAX env's parameter
    arrays: one numpy array per dataclass field of the JAX env (same field
    names), plus ``low``/``high`` for its bounds (None or absent: a side
    without a bound)."""
    cls = _ENV_CLASSES[name]
    t = lambda a: torch.tensor(  # noqa: E731
        np.asarray(a), dtype=dtype, device=device
    )
    fields = {f.name: t(arrays[f.name]) for f in dataclasses.fields(cls)
              if f.name != "bounds"}
    low, high = arrays.get("low"), arrays.get("high")
    bounds = None
    if low is not None or high is not None:
        m = cls(**fields).action_size
        side = lambda a, v: t(  # noqa: E731
            np.full(m, v) if a is None else np.broadcast_to(a, (m,)))
        bounds = Bounds(low=side(low, -np.inf), high=side(high, np.inf))
    return cls(**fields, bounds=bounds)


def navigation_from_numpy(goal, centers, decays, low=None, high=None, *,
                          device="cuda", dtype=torch.float32) -> Navigation:
    """A ``Navigation`` env from the JAX env's parameter arrays."""
    n = np.asarray(goal).shape[-1]
    return env_from_numpy(
        "navigation",
        dict(goal=goal, centers=np.reshape(centers, (-1, n)),
             decays=np.reshape(decays, (-1,)), low=low, high=high),
        device=device, dtype=dtype,
    )


def lqr_problem_from_numpy(F, f, C, c, C_f=None, c_f=None, *,
                          dtype=torch.float32, device="cuda") -> LQRProblem:
    """An ``LQRProblem`` from the JAX problem's arrays (``C_f``/``c_f`` None:
    no final cost)."""
    t = lambda a: None if a is None else torch.tensor(  # noqa: E731
        np.asarray(a), dtype=dtype, device=device)
    return LQRProblem(F=t(F), f=t(f), C=t(C), c=t(c), C_f=t(C_f),
                      c_f=t(c_f))


def config_from_dict(d: dict) -> ILQRConfig:
    """An ``ILQRConfig`` from ``dataclasses.asdict`` of the JAX config (same
    field names; options not ported yet raise)."""
    return ILQRConfig(**d)


_STATE_DTYPES = {"iteration": torch.int32, "converged": torch.bool,
                 "failed": torch.bool}


def state_from_numpy(arrays: dict, *, device="cuda") -> SolverState:
    """A ``SolverState`` from the nine numpy arrays of a JAX ``SolverState``
    (keys ``X, U, J, mu, delta, iteration, converged, failed, residual``)."""
    return SolverState(**{
        name: torch.tensor(
            np.asarray(arrays[name]), dtype=_STATE_DTYPES.get(name),
            device=device,
        )
        for name in SolverState._fields
    })
