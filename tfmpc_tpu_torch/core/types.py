"""Plain dataclasses carrying the linearized models and policies of iLQR.

Counterparts of ``tfmpc_tpu/core/types.py`` with the same field names and
the same ``[..., T, ...]`` layouts: ``f_x`` of a batch of scenarios is
``[B, T, n, n]``, of one scenario ``[T, n, n]``. Every field is a tensor;
``map_fields`` applies one function to all of them (the counterpart of
``jax.tree_util.tree_map`` for these records).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def map_fields(fn, *objs):
    """Apply ``fn`` field-wise across dataclass records of one type (or
    across plain tuples, element-wise)."""
    first = objs[0]
    if type(first) is tuple:
        return tuple(map(fn, *objs))
    return dataclasses.replace(
        first,
        **{
            f.name: fn(*(getattr(o, f.name) for o in objs))
            for f in dataclasses.fields(first)
        },
    )


@dataclasses.dataclass(frozen=True, eq=False)
class LQRProblem:
    """Finite-horizon LQR problem in stacked ``z = [x; u]`` form: dynamics
    ``x_{t+1} = F_t z_t + f_t``, stage cost ``1/2 z^T C_t z + z^T c_t``,
    final cost ``1/2 x^T C_f x + x^T c_f`` (zeros where None).

    ``F [..., T, n, n+m]``, ``f [..., T, n]``, ``C [..., T, n+m, n+m]``,
    ``c [..., T, n+m]``, ``C_f [..., n, n]``, ``c_f [..., n]``.
    """

    F: torch.Tensor
    f: torch.Tensor
    C: torch.Tensor
    c: torch.Tensor
    C_f: Optional[torch.Tensor] = None
    c_f: Optional[torch.Tensor] = None

    @property
    def horizon(self) -> int:
        return self.F.shape[-3]

    @property
    def state_size(self) -> int:
        return self.F.shape[-2]

    @property
    def action_size(self) -> int:
        return self.F.shape[-1] - self.F.shape[-2]


@dataclasses.dataclass(frozen=True, eq=False)
class Bounds:
    """Box bounds on controls, ``low <= u <= high`` elementwise."""

    low: torch.Tensor
    high: torch.Tensor

    def clip(self, u: torch.Tensor) -> torch.Tensor:
        return torch.clamp(u, self.low, self.high)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearModel:
    """Linearized dynamics: ``f [..., T, n]``, ``f_x [..., T, n, n]``,
    ``f_u [..., T, n, m]``."""

    f: torch.Tensor
    f_x: torch.Tensor
    f_u: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class SecondOrderModel:
    """Second derivatives of the dynamics (full DDP), leading index the
    transition's output component p:
    ``f_xx [..., T, n, n, n]`` with ``f_xx[p, i, j] = d2 f_p / dx_i dx_j``,
    ``f_ux [..., T, n, m, n]`` with ``f_ux[p, a, i] = d2 f_p / du_a dx_i``,
    ``f_uu [..., T, n, m, m]`` with ``f_uu[p, a, c] = d2 f_p / du_a du_c``.
    """

    f_xx: torch.Tensor
    f_ux: torch.Tensor
    f_uu: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class QuadraticModel:
    """Quadratized stage cost: ``l [..., T]``, ``l_x [..., T, n]``,
    ``l_u [..., T, m]``, ``l_xx [..., T, n, n]``, ``l_uu [..., T, m, m]``,
    ``l_ux [..., T, m, n]``."""

    l: torch.Tensor
    l_x: torch.Tensor
    l_u: torch.Tensor
    l_xx: torch.Tensor
    l_uu: torch.Tensor
    l_ux: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class QuadraticFinal:
    """Quadratized final cost: ``l [...]``, ``l_x [..., n]``,
    ``l_xx [..., n, n]``."""

    l: torch.Tensor
    l_x: torch.Tensor
    l_xx: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Policy:
    """Affine feedback ``u_t = ubar_t + alpha k_t + K_t (x_t - xbar_t)``:
    ``K [..., T, m, n]``, ``k [..., T, m]``."""

    K: torch.Tensor
    k: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class ValueFunction:
    """Quadratic value function ``V_t(x) = 1/2 x^T V_xx x + v_x^T x + v_0``:
    ``V_xx [..., T+1, n, n]``, ``v_x [..., T+1, n]``, ``v_0 [..., T+1]``."""

    V_xx: torch.Tensor
    v_x: torch.Tensor
    v_0: torch.Tensor
