"""Multi-room HVAC environment (RDDL HVAC lineage).

Counterpart of ``tfmpc_tpu/models/hvac.py``. State: room temperatures;
action: heated-air volume per room in ``[0, air_max]``. One forward-Euler
step of length ``time_delta``::

    dT_i = dt / C_i * (  u_i * Ka * (Ta - T_i)                 # heated air
                       + sum_j A_ij (T_j - T_i) / Rw_ij        # wall exchange
                       + out_i  * (To - T_i) / Ro_i            # outside leak
                       + hall_i * (Th - T_i) / Rh_i )          # hallway leak

Stage cost on the pre-step state, smooth (squared hinges)::

    sum_i [ cost_air * u_i
          + penalty * (relu(lo_i - T_i)^2 + relu(T_i - hi_i)^2)
          + setpoint_weight * (T_i - (lo_i + hi_i)/2)^2 ]

and the final cost is the stage cost at u = 0.
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

# Index of the HVAC step functor in ops/csrc/envs.cuh.
HVAC_STEP_ID = 1

# Names of the device step's parameters, in the order the functor reads them
# (the keys of the JAX package's HVAC.lane_functions params).
HVAC_STEP_PARAMS = (
    "cond", "cond_rowsum", "k_out", "k_hall", "capacity", "temp_low",
    "temp_high", "temp_mid", "temp_out", "temp_hall", "temp_air", "air_cap",
    "cost_air", "penalty", "setpoint_weight", "time_delta",
)


@dataclasses.dataclass(frozen=True, eq=False)
class HVAC(Env):
    """Multi-room thermal control (R rooms): ``adj``/``r_wall`` ``[R, R]``,
    ``is_out``, ``r_out``, ``is_hall``, ``r_hall``, ``capacity``,
    ``temp_low``, ``temp_high`` ``[R]``, and 0-d ``temp_out``,
    ``temp_hall``, ``temp_air``, ``air_cap``, ``cost_air``, ``penalty``,
    ``setpoint_weight``, ``time_delta``."""

    adj: torch.Tensor
    r_wall: torch.Tensor
    is_out: torch.Tensor
    r_out: torch.Tensor
    is_hall: torch.Tensor
    r_hall: torch.Tensor
    capacity: torch.Tensor
    temp_low: torch.Tensor
    temp_high: torch.Tensor
    temp_out: torch.Tensor
    temp_hall: torch.Tensor
    temp_air: torch.Tensor
    air_cap: torch.Tensor
    cost_air: torch.Tensor
    penalty: torch.Tensor
    setpoint_weight: torch.Tensor
    time_delta: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self) -> int:
        return self.capacity.shape[-1]

    @property
    def action_size(self) -> int:
        return self.capacity.shape[-1]

    def transition(self, x, u):
        heating = u * self.air_cap * (self.temp_air - x)
        cond = self.adj / self.r_wall
        exchange = x @ cond.T - x * cond.sum(dim=1)
        leak_out = self.is_out * (self.temp_out - x) / self.r_out
        leak_hall = self.is_hall * (self.temp_hall - x) / self.r_hall
        dT = (heating + exchange + leak_out + leak_hall) / self.capacity
        return x + self.time_delta * dT

    def _comfort(self, x):
        below = torch.clamp(self.temp_low - x, min=0.0)
        above = torch.clamp(x - self.temp_high, min=0.0)
        comfort = self.penalty * (below**2 + above**2).sum(dim=-1)
        mid = 0.5 * (self.temp_low + self.temp_high)
        return comfort + self.setpoint_weight * ((x - mid) ** 2).sum(dim=-1)

    def cost(self, x, u):
        air = self.cost_air * u.sum(dim=-1)
        return air + self._comfort(x)

    def final_cost(self, x):
        return self.cost(x, torch.zeros_like(x))

    def analytic_derivatives(self, X, U):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]``: f_x = I + dt/C (cond - diag(u Ka + rowsum + ko +
        kh)), f_u = diag(dt/C Ka (Ta - x)); the cost Hessian is a
        piecewise-constant diagonal and l_u = cost_air."""
        n = self.state_size
        x = X[..., :-1, :]                                  # [..., T, n]
        dtype = x.dtype
        eye = torch.eye(n, dtype=dtype, device=x.device)
        dt_c = self.time_delta / self.capacity              # [n]

        cond = self.adj / self.r_wall                       # [n, n]
        rowsum = cond.sum(dim=1)
        ko = self.is_out / self.r_out
        kh = self.is_hall / self.r_hall

        heating = U * self.air_cap * (self.temp_air - x)
        exchange = x @ cond.T - x * rowsum
        leak = ko * (self.temp_out - x) + kh * (self.temp_hall - x)
        f = x + dt_c * (heating + exchange + leak)

        diag_term = -(U * self.air_cap + rowsum + ko + kh)  # [..., T, n]
        f_x = eye + dt_c[:, None] * cond \
            + (dt_c * diag_term)[..., :, None] * eye
        f_u = (dt_c * self.air_cap * (self.temp_air - x))[..., :, None] * eye
        lin = LinearModel(f=f, f_x=f_x, f_u=f_u)

        def cost_terms(xv):
            below = torch.clamp(self.temp_low - xv, min=0.0)
            above = torch.clamp(xv - self.temp_high, min=0.0)
            mid = 0.5 * (self.temp_low + self.temp_high)
            l = self.penalty * (below**2 + above**2).sum(dim=-1) \
                + self.setpoint_weight * ((xv - mid) ** 2).sum(dim=-1)
            l_x = 2.0 * self.penalty * (above - below) \
                + 2.0 * self.setpoint_weight * (xv - mid)
            hdiag = 2.0 * self.penalty * (
                (below > 0).to(dtype) + (above > 0).to(dtype)
            ) + 2.0 * self.setpoint_weight
            return l, l_x, hdiag

        l, l_x, hdiag = cost_terms(x)
        lead = x.shape[:-1]
        zeros_m = torch.zeros(lead + (n, n), dtype=dtype, device=x.device)
        quad = QuadraticModel(
            l=l + self.cost_air * U.sum(dim=-1),
            l_x=l_x,
            l_u=torch.broadcast_to(self.cost_air, lead + (n,)),
            l_xx=hdiag[..., :, None] * eye,
            l_uu=zeros_m,
            l_ux=zeros_m,
        )
        lT, lT_x, hT = cost_terms(X[..., -1, :])
        final = QuadraticFinal(l=lT, l_x=lT_x, l_xx=hT[..., :, None] * eye)
        return lin, quad, final

    def device_step(self) -> DeviceStep:
        """The ``HVACStep`` functor of ``ops/csrc/envs.cuh``, with the
        parameters of the JAX package's ``lane_functions`` (names in
        ``HVAC_STEP_PARAMS``)."""
        cond = self.adj / self.r_wall
        values = {
            "cond": cond,
            "cond_rowsum": cond.sum(dim=1),
            "k_out": self.is_out / self.r_out,
            "k_hall": self.is_hall / self.r_hall,
            "capacity": self.capacity,
            "temp_low": self.temp_low,
            "temp_high": self.temp_high,
            "temp_mid": 0.5 * (self.temp_low + self.temp_high),
            "temp_out": self.temp_out,
            "temp_hall": self.temp_hall,
            "temp_air": self.temp_air,
            "air_cap": self.air_cap,
            "cost_air": self.cost_air,
            "penalty": self.penalty,
            "setpoint_weight": self.setpoint_weight,
            "time_delta": self.time_delta,
        }
        return DeviceStep(
            env_id=HVAC_STEP_ID,
            params=tuple(values[k].contiguous() for k in HVAC_STEP_PARAMS),
            int_params=(),
        )


def make_hvac(adj, *, r_wall=1.5, is_out=None, r_out=4.0, is_hall=None,
              r_hall=2.0, capacity=80.0, temp_low=20.0, temp_high=23.5,
              temp_out=6.0, temp_hall=10.0, temp_air=40.0, air_cap=1.0,
              cost_air=1.0, penalty=20.0, setpoint_weight=0.1,
              time_delta=1.0, air_max=10.0, dtype=torch.float32,
              device="cuda") -> HVAC:
    """Build an ``HVAC`` env from reference-style JSON config fields: the
    adjacency is symmetrized with a zero diagonal, scalars broadcast per
    room (per wall for ``r_wall``), and controls are bounded to
    ``[0, air_max]``."""
    opts = dict(dtype=dtype, device=device)
    adj = torch.as_tensor(adj, **opts)
    R = adj.shape[0]
    adj = 0.5 * (adj + adj.T)
    adj = adj * (1.0 - torch.eye(R, **opts))

    def per_room(v):
        return torch.broadcast_to(torch.as_tensor(v, **opts), (R,)).clone()

    def scalar(v):
        return torch.as_tensor(v, **opts)

    return HVAC(
        adj=adj,
        r_wall=torch.broadcast_to(torch.as_tensor(r_wall, **opts),
                                  (R, R)).clone(),
        is_out=per_room(is_out if is_out is not None else [1.0] * R),
        r_out=per_room(r_out),
        is_hall=per_room(is_hall if is_hall is not None else [0.0] * R),
        r_hall=per_room(r_hall),
        capacity=per_room(capacity),
        temp_low=per_room(temp_low),
        temp_high=per_room(temp_high),
        temp_out=scalar(temp_out),
        temp_hall=scalar(temp_hall),
        temp_air=scalar(temp_air),
        air_cap=scalar(air_cap),
        cost_air=scalar(cost_air),
        penalty=scalar(penalty),
        setpoint_weight=scalar(setpoint_weight),
        time_delta=scalar(time_delta),
        bounds=Bounds(low=torch.zeros((R,), **opts),
                      high=torch.full((R,), float(air_max), **opts)),
    )
