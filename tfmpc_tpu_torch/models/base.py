"""Differentiable-environment base: dynamics and costs plus their linearization.

Counterpart of ``tfmpc_tpu/models/base.py``. ``transition``, ``cost`` and
``final_cost`` take states ``[..., n]`` and controls ``[..., m]`` with any
leading batch dims. The generic linearization is forward-mode autodiff
(``torch.func.jacfwd``, Hessians as ``jacfwd`` of ``grad``) mapped over a
leading axis with ``torch.func.vmap``: the semantics oracle for an env's
closed-form ``analytic_derivatives``.

``device_step`` replaces the JAX package's ``lane_functions`` hook: an env
whose step is compiled into the CUDA rollout kernels (``ops/csrc/envs.cuh``)
names it there, and every other env keeps the plain PyTorch rollout.
``device_derivatives`` replaces ``lane_derivatives`` in the same way.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import grad, jacfwd, vmap

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)


class DeviceStep(NamedTuple):
    """An env step compiled into the CUDA rollout kernels.

    ``env_id`` selects the step functor in ``ops/csrc/envs.cuh``;
    ``params`` are its parameter tensors and ``int_params`` its integer
    sizes, in the order that functor reads them.
    """

    env_id: int
    params: Tuple[torch.Tensor, ...]
    int_params: Tuple[int, ...]


class Env:
    """Base class for differentiable environments.

    Subclasses implement ``transition(x, u) -> x'``, ``cost(x, u)`` and
    ``final_cost(x)`` over ``[..., n]`` / ``[..., m]`` tensors, and may set
    ``bounds`` (a ``Bounds`` or None).
    """

    bounds: Optional[Bounds] = None

    # -- abstract ----------------------------------------------------------
    def transition(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def cost(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def final_cost(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def state_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        return self.state_size

    # -- autodiff linearization ---------------------------------------------
    def _linear(self, x, u):
        f_x, f_u = jacfwd(self.transition, argnums=(0, 1))(x, u)
        return self.transition(x, u), f_x, f_u

    def _quadratic(self, x, u):
        grad_x = grad(self.cost, argnums=0)
        grad_u = grad(self.cost, argnums=1)
        return (
            self.cost(x, u),
            grad_x(x, u),
            grad_u(x, u),
            jacfwd(grad_x, argnums=0)(x, u),
            jacfwd(grad_u, argnums=1)(x, u),
            jacfwd(grad_u, argnums=0)(x, u),
        )

    def get_linear_transition(self, x, u, batch: bool = False) -> LinearModel:
        """First-order model of the dynamics at ``(x, u)``; ``batch=True``
        maps over a leading axis."""
        fn = vmap(self._linear) if batch else self._linear
        return LinearModel(*fn(x, u))

    def get_quadratic_cost(self, x, u, batch: bool = False) -> QuadraticModel:
        """Second-order model of the stage cost at ``(x, u)``."""
        fn = vmap(self._quadratic) if batch else self._quadratic
        return QuadraticModel(*fn(x, u))

    def _second_order(self, x, u):
        jac_x = jacfwd(self.transition, argnums=0)
        jac_u = jacfwd(self.transition, argnums=1)
        return (
            jacfwd(jac_x, argnums=0)(x, u),   # [n, n, n]
            jacfwd(jac_u, argnums=0)(x, u),   # [n, m, n]
            jacfwd(jac_u, argnums=1)(x, u),   # [n, m, m]
        )

    def get_second_order_transition(self, x, u,
                                    batch: bool = False) -> SecondOrderModel:
        """Second derivatives of the dynamics at ``(x, u)`` (full DDP), by
        forward-over-forward autodiff; ``batch=True`` maps over a leading
        axis."""
        fn = vmap(self._second_order) if batch else self._second_order
        # torch.func returns a lazy ZeroTensor for a derivative that is zero
        # everywhere (f_uu of every shipped env); clone() materializes it
        return SecondOrderModel(*(a.clone() for a in fn(x, u)))

    def get_quadratic_final_cost(self, x) -> QuadraticFinal:
        """Second-order model of the final cost at ``x``."""
        return QuadraticFinal(
            l=self.final_cost(x),
            l_x=grad(self.final_cost)(x),
            l_xx=jacfwd(grad(self.final_cost))(x),
        )

    # -- rollout -----------------------------------------------------------
    def rollout(self, x0: torch.Tensor, U: torch.Tensor):
        """Open-loop rollout: ``x0 [..., n]``, ``U [..., T, m]`` ->
        ``(states [..., T+1, n], costs [..., T+1])``; the last cost is the
        final cost."""
        x, xs, costs = x0, [x0], []
        for t in range(U.shape[-2]):
            u = U[..., t, :]
            costs.append(self.cost(x, u))
            x = self.transition(x, u)
            xs.append(x)
        costs.append(self.final_cost(x))
        return torch.stack(xs, dim=-2), torch.stack(costs, dim=-1)

    def total_cost(self, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        return self.rollout(x0, U)[1].sum(dim=-1)

    def clip(self, u: torch.Tensor) -> torch.Tensor:
        if self.bounds is None:
            return u
        return self.bounds.clip(u)

    # -- optional hooks ------------------------------------------------------
    def analytic_derivatives(self, X: torch.Tensor, U: torch.Tensor):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]``, or None to use the autodiff route. Must match
        the autodiff linearization to floating-point tolerance."""
        return None

    def device_step(self) -> Optional[DeviceStep]:
        """The env's step compiled into the CUDA rollout kernels, or None
        (then the rollout kernels are not eligible for this env)."""
        return None

    def device_derivatives(self) -> Optional[DeviceStep]:
        """The env's step functor that also has a closed-form device
        linearization (``derivatives`` in ``ops/csrc/envs.cuh``, matching
        ``analytic_derivatives``), compiled into K8, the materialize
        rollout of the fused iteration (``ILQRConfig.fuse_derivatives``);
        or None (then that iteration is not eligible for this env). The
        counterpart of the JAX package's ``Env.lane_derivatives``."""
        return None
