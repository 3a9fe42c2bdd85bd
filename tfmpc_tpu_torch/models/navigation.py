"""2-D point-mass navigation with smooth deceleration zones.

Counterpart of ``tfmpc_tpu/models/navigation.py``:

- dynamics ``x' = x + lambda(x) u`` with
  ``lambda(x) = prod_z [2 / (1 + exp(-decay_z ||x - center_z||)) - 1]``;
- stage cost ``||x - goal||^2`` (independent of ``u``), final cost the same;
- optional box bounds on ``u``.

Zones are dense ``[Z, n]`` / ``[Z]`` tensors; Z may be 0 (the product over
an empty axis is 1). The norm keeps ``_NORM_EPS`` inside the sqrt so the
Jacobian stays finite at a zone center.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
)
from tfmpc_tpu_torch.models.base import DeviceStep, Env

_NORM_EPS = 1e-12

# Index of the navigation step functor in ops/csrc/envs.cuh.
NAVIGATION_STEP_ID = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Navigation(Env):
    """Nonlinear navigation toward ``goal [n]`` with deceleration zones
    ``centers [Z, n]`` / ``decays [Z]``."""

    goal: torch.Tensor
    centers: torch.Tensor
    decays: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self) -> int:
        return self.goal.shape[-1]

    @property
    def action_size(self) -> int:
        return self.goal.shape[-1]

    def deceleration(self, x: torch.Tensor) -> torch.Tensor:
        """``lambda(x)`` in (0, 1]: ``x [..., n]`` -> ``[...]``."""
        d = x[..., None, :] - self.centers                       # [..., Z, n]
        dist = torch.sqrt((d * d).sum(dim=-1) + _NORM_EPS)      # [..., Z]
        factors = 2.0 / (1.0 + torch.exp(-self.decays * dist)) - 1.0
        return factors.prod(dim=-1)

    def transition(self, x, u):
        return x + self.deceleration(x)[..., None] * u

    def cost(self, x, u):
        d = x - self.goal
        return (d * d).sum(dim=-1)

    def final_cost(self, x):
        d = x - self.goal
        return (d * d).sum(dim=-1)

    def analytic_derivatives(self, X, U):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]`` (the cost quadratics are constants: l_xx = 2I,
        l_uu = l_ux = 0; the only non-trivial term is d lambda / dx)."""
        n = self.state_size
        x = X[..., :-1, :]                                       # [..., T, n]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)

        d = x[..., None, :] - self.centers                       # [..., T, Z, n]
        dist = torch.sqrt((d * d).sum(dim=-1) + _NORM_EPS)      # [..., T, Z]
        g = 2.0 / (1.0 + torch.exp(-self.decays * dist)) - 1.0
        lam = g.prod(dim=-1)                                     # [..., T]
        # d g_z / d dist = k_z (1 - g_z^2) / 2 ; d dist / dx = (x - c_z) / dist
        gp = self.decays * (1.0 - g * g) / 2.0
        ratio = torch.where(g != 0.0, lam[..., None] / g, torch.zeros_like(g))
        coef = ratio * gp / dist
        dlam = (coef[..., None] * d).sum(dim=-2)                 # [..., T, n]

        lin = LinearModel(
            f=x + lam[..., None] * U,
            f_x=eye + U[..., :, None] * dlam[..., None, :],
            f_u=lam[..., None, None] * eye,
        )
        dx = x - self.goal
        lead = dx.shape[:-1]
        zeros_m = torch.zeros(lead + (n, n), dtype=x.dtype, device=x.device)
        quad = QuadraticModel(
            l=(dx * dx).sum(dim=-1),
            l_x=2.0 * dx,
            l_u=torch.zeros_like(dx),
            l_xx=(2.0 * eye).expand(lead + (n, n)),
            l_uu=zeros_m,
            l_ux=zeros_m,
        )
        dT = X[..., -1, :] - self.goal
        final = QuadraticFinal(
            l=(dT * dT).sum(dim=-1),
            l_x=2.0 * dT,
            l_xx=(2.0 * eye).expand(dT.shape[:-1] + (n, n)),
        )
        return lin, quad, final

    def device_step(self) -> DeviceStep:
        return DeviceStep(
            env_id=NAVIGATION_STEP_ID,
            params=(self.goal, self.centers, self.decays),
            int_params=(self.centers.shape[0],),
        )

    def device_derivatives(self) -> DeviceStep:
        """The step functor of ``device_step``, whose ``derivs_prep`` and
        ``derivs_row`` compute ``analytic_derivatives`` at one step in
        K8."""
        return self.device_step()


def make_navigation(goal, deceleration: Optional[dict] = None, low=None,
                    high=None, *, dtype=torch.float32,
                    device="cuda") -> Navigation:
    """Build a ``Navigation`` env from reference-style JSON config fields:
    ``deceleration = {"center": [[...], ...], "decay": [...]}``. The env
    lives on the card unless ``device="cpu"`` is passed."""
    goal = torch.as_tensor(goal, dtype=dtype, device=device).reshape(-1)
    n = goal.shape[0]
    if deceleration is not None:
        centers = torch.as_tensor(
            deceleration["center"], dtype=dtype, device=device
        ).reshape(-1, n)
        decays = torch.as_tensor(
            deceleration["decay"], dtype=dtype, device=device
        ).reshape(-1)
    else:
        centers = torch.zeros((0, n), dtype=dtype, device=device)
        decays = torch.zeros((0,), dtype=dtype, device=device)
    bounds = None
    if low is not None or high is not None:
        def side(v, fill):
            if v is None:
                return torch.full((n,), fill, dtype=dtype, device=device)
            return torch.as_tensor(v, dtype=dtype, device=device).expand(n)

        bounds = Bounds(low=side(low, -torch.inf), high=side(high, torch.inf))
    return Navigation(goal=goal, centers=centers, decays=decays, bounds=bounds)
