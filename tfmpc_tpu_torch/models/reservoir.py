"""Water-reservoir network environment (RDDL Reservoir lineage).

Counterpart of ``tfmpc_tpu/models/reservoir.py``. State: water levels;
action: release outflows in ``[0, max_release]``. Dynamics::

    evap_i  = evap_factor * sin(l_i / cap_i) * l_i
    l'_i    = l_i + rain_i - evap_i - u_i + sum_j D_ji u_j

with ``D[j, i] = 1`` when reservoir j releases into reservoir i. The cost
ignores the releases and penalizes the level (smooth asymmetric hinges)::

    sum_i [ low_penalty  * relu(lb_i - l_i)^2
          + high_penalty * relu(l_i - ub_i)^2
          + setpoint_weight * (l_i - (lb_i + ub_i)/2)^2 ]
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

# Index of the reservoir step functor in ops/csrc/envs.cuh.
RESERVOIR_STEP_ID = 2

# Names of the device step's parameters, in the order the functor reads
# them: the JAX package's Reservoir.lane_functions params, except that the
# functor divides by ``max_capacity`` as ``transition`` does, where the JAX
# lane step multiplies by ``inv_cap``.
RESERVOIR_STEP_PARAMS = (
    "downstream", "max_capacity", "rain", "evap_factor", "lower_bound",
    "upper_bound", "mid", "low_penalty", "high_penalty", "setpoint_weight",
)


@dataclasses.dataclass(frozen=True, eq=False)
class Reservoir(Env):
    """Chain or DAG of R reservoirs: ``downstream [R, R]``,
    ``max_capacity``, ``rain``, ``lower_bound``, ``upper_bound`` ``[R]``,
    and 0-d ``evap_factor``, ``low_penalty``, ``high_penalty``,
    ``setpoint_weight``."""

    downstream: torch.Tensor
    max_capacity: torch.Tensor
    rain: torch.Tensor
    evap_factor: torch.Tensor
    lower_bound: torch.Tensor
    upper_bound: torch.Tensor
    low_penalty: torch.Tensor
    high_penalty: torch.Tensor
    setpoint_weight: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self) -> int:
        return self.max_capacity.shape[-1]

    @property
    def action_size(self) -> int:
        return self.max_capacity.shape[-1]

    def evaporation(self, x):
        return self.evap_factor * torch.sin(x / self.max_capacity) * x

    def transition(self, x, u):
        inflow = u @ self.downstream
        return x + self.rain - self.evaporation(x) - u + inflow

    def cost(self, x, u):
        below = torch.clamp(self.lower_bound - x, min=0.0)
        above = torch.clamp(x - self.upper_bound, min=0.0)
        mid = 0.5 * (self.lower_bound + self.upper_bound)
        return (self.low_penalty * below**2 + self.high_penalty * above**2
                + self.setpoint_weight * (x - mid) ** 2).sum(dim=-1)

    def final_cost(self, x):
        return self.cost(x, torch.zeros_like(x))

    def analytic_derivatives(self, X, U):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]``: f_x = diag(1 - e (sin(x/cap) + (x/cap)
        cos(x/cap))), f_u = D^T - I; the cost Hessian is a
        piecewise-constant diagonal."""
        n = self.state_size
        x = X[..., :-1, :]
        dtype = x.dtype
        eye = torch.eye(n, dtype=dtype, device=x.device)

        r = x / self.max_capacity
        f = x + self.rain - self.evap_factor * torch.sin(r) * x - U \
            + U @ self.downstream
        dxdiag = 1.0 - self.evap_factor * (torch.sin(r) + r * torch.cos(r))
        f_x = dxdiag[..., :, None] * eye
        lead = x.shape[:-1]
        f_u = torch.broadcast_to(self.downstream.T - eye, lead + (n, n))
        lin = LinearModel(f=f, f_x=f_x, f_u=f_u)

        def cost_terms(xv):
            below = torch.clamp(self.lower_bound - xv, min=0.0)
            above = torch.clamp(xv - self.upper_bound, min=0.0)
            mid = 0.5 * (self.lower_bound + self.upper_bound)
            l = (self.low_penalty * below**2 + self.high_penalty * above**2
                 + self.setpoint_weight * (xv - mid) ** 2).sum(dim=-1)
            l_x = -2.0 * self.low_penalty * below \
                + 2.0 * self.high_penalty * above \
                + 2.0 * self.setpoint_weight * (xv - mid)
            hdiag = 2.0 * self.low_penalty * (below > 0).to(dtype) \
                + 2.0 * self.high_penalty * (above > 0).to(dtype) \
                + 2.0 * self.setpoint_weight
            return l, l_x, hdiag

        l, l_x, hdiag = cost_terms(x)
        zeros_m = torch.zeros(lead + (n, n), dtype=dtype, device=x.device)
        quad = QuadraticModel(
            l=l,
            l_x=l_x,
            l_u=torch.zeros(lead + (n,), dtype=dtype, device=x.device),
            l_xx=hdiag[..., :, None] * eye,
            l_uu=zeros_m,
            l_ux=zeros_m,
        )
        lT, lT_x, hT = cost_terms(X[..., -1, :])
        final = QuadraticFinal(l=lT, l_x=lT_x, l_xx=hT[..., :, None] * eye)
        return lin, quad, final

    def device_step(self) -> DeviceStep:
        """The ``ReservoirStep`` functor of ``ops/csrc/envs.cuh``
        (parameter names in ``RESERVOIR_STEP_PARAMS``)."""
        values = {
            "downstream": self.downstream,
            "max_capacity": self.max_capacity,
            "rain": self.rain,
            "evap_factor": self.evap_factor,
            "lower_bound": self.lower_bound,
            "upper_bound": self.upper_bound,
            "mid": 0.5 * (self.lower_bound + self.upper_bound),
            "low_penalty": self.low_penalty,
            "high_penalty": self.high_penalty,
            "setpoint_weight": self.setpoint_weight,
        }
        return DeviceStep(
            env_id=RESERVOIR_STEP_ID,
            params=tuple(values[k].contiguous()
                         for k in RESERVOIR_STEP_PARAMS),
            int_params=(),
        )


def make_reservoir(n_reservoirs: Optional[int] = None, *, downstream=None,
                   max_capacity=100.0, rain=5.0, evap_factor=0.5,
                   lower_bound=10.0, upper_bound=90.0, low_penalty=5.0,
                   high_penalty=100.0, setpoint_weight=0.1,
                   max_release=50.0, dtype=torch.float32,
                   device="cuda") -> Reservoir:
    """Build a ``Reservoir`` env from reference-style JSON config fields.
    The default topology is the chain ``0 -> 1 -> ... -> R-1 -> out``;
    pass ``downstream`` for a DAG."""
    opts = dict(dtype=dtype, device=device)
    if downstream is not None:
        D = torch.as_tensor(downstream, **opts)
        R = D.shape[0]
    else:
        if n_reservoirs is None:
            raise ValueError("provide n_reservoirs or downstream")
        R = n_reservoirs
        D = torch.zeros((R, R), **opts)
        if R > 1:
            idx = torch.arange(R - 1, device=device)
            D[idx, idx + 1] = 1.0

    def per_res(v):
        return torch.broadcast_to(torch.as_tensor(v, **opts), (R,)).clone()

    def scalar(v):
        return torch.as_tensor(v, **opts)

    return Reservoir(
        downstream=D,
        max_capacity=per_res(max_capacity),
        rain=per_res(rain),
        evap_factor=scalar(evap_factor),
        lower_bound=per_res(lower_bound),
        upper_bound=per_res(upper_bound),
        low_penalty=scalar(low_penalty),
        high_penalty=scalar(high_penalty),
        setpoint_weight=scalar(setpoint_weight),
        bounds=Bounds(low=torch.zeros((R,), **opts),
                      high=per_res(max_release)),
    )
