"""Generic linear-dynamics / quadratic-cost environment.

Counterpart of ``tfmpc_tpu/models/linear.py``: the env-shaped wrapper over
the LQR problem class, so iLQR on a ``LinearSystem`` reproduces the exact
LQR solution (``solvers/lqr.py``), and the one stock env whose action size
may differ from its state size.

Dynamics   x' = A x + B u + c
Stage cost 1/2 x^T Q x + 1/2 u^T R u + x^T N u + q^T x + r^T u
Final cost 1/2 x^T Qf x + qf^T x
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    LQRProblem,
    QuadraticFinal,
    QuadraticModel,
)
from tfmpc_tpu_torch.models.base import DeviceStep, Env

# Index of the linear step functor in ops/csrc/envs.cuh.
LINEAR_STEP_ID = 3

# The device step's parameters, in the order the functor reads them: the
# JAX package's LinearSystem.lane_functions params.
LINEAR_STEP_PARAMS = ("A", "B", "c", "Q", "R", "N", "q", "r", "Q_f", "q_f")


def _quad_form(z, M):
    """``z^T M z`` over the trailing axis of ``z [..., k]``."""
    return (z * (z @ M.mT)).sum(dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class LinearSystem(Env):
    """``A [n, n]``, ``B [n, m]``, ``c [n]``, ``Q [n, n]`` (PSD), ``R [m, m]``
    (PD), cross term ``N [n, m]``, ``q [n]``, ``r [m]``, ``Q_f [n, n]``,
    ``q_f [n]``."""

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    N: torch.Tensor
    q: torch.Tensor
    r: torch.Tensor
    Q_f: torch.Tensor
    q_f: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self) -> int:
        return self.A.shape[-1]

    @property
    def action_size(self) -> int:
        return self.B.shape[-1]

    def transition(self, x, u):
        return x @ self.A.mT + u @ self.B.mT + self.c

    def cost(self, x, u):
        return (0.5 * _quad_form(x, self.Q) + 0.5 * _quad_form(u, self.R)
                + (x * (u @ self.N.mT)).sum(dim=-1)
                + (self.q * x).sum(dim=-1) + (self.r * u).sum(dim=-1))

    def final_cost(self, x):
        return 0.5 * _quad_form(x, self.Q_f) + (self.q_f * x).sum(dim=-1)

    def to_lqr_problem(self, horizon: int) -> LQRProblem:
        """The equivalent stacked F/f/C/c problem for the exact LQR
        solver."""
        F1 = torch.cat([self.A, self.B], dim=1)                  # [n, n+m]
        C1 = torch.cat([torch.cat([self.Q, self.N], dim=1),
                        torch.cat([self.N.mT, self.R], dim=1)])  # [n+m, n+m]
        c1 = torch.cat([self.q, self.r])
        rep = lambda a: a.expand((horizon,) + a.shape)  # noqa: E731
        return LQRProblem(F=rep(F1), f=rep(self.c), C=rep(C1), c=rep(c1),
                          C_f=self.Q_f, c_f=self.q_f)

    def analytic_derivatives(self, X, U):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]``: constant Jacobians and Hessians; the gradients
        and Hessians of ``1/2 z^T M z`` use the symmetric part of M."""
        n = self.state_size
        x = X[..., :-1, :]
        lead = x.shape[:-1]
        rep = lambda a: a.expand(lead + a.shape)  # noqa: E731
        lin = LinearModel(
            f=x @ self.A.mT + U @ self.B.mT + self.c,
            f_x=rep(self.A),
            f_u=rep(self.B),
        )
        Qs = 0.5 * (self.Q + self.Q.mT)
        Rs = 0.5 * (self.R + self.R.mT)
        Qfs = 0.5 * (self.Q_f + self.Q_f.mT)
        quad = QuadraticModel(
            l=self.cost(x, U),
            l_x=x @ Qs + U @ self.N.mT + self.q,
            l_u=U @ Rs + x @ self.N + self.r,
            l_xx=rep(Qs),
            l_uu=rep(Rs),
            l_ux=rep(self.N.mT),
        )
        xT = X[..., -1, :]
        final = QuadraticFinal(
            l=self.final_cost(xT),
            l_x=xT @ Qfs.mT + self.q_f,
            l_xx=Qfs.expand(xT.shape[:-1] + (n, n)),
        )
        return lin, quad, final

    def device_step(self) -> DeviceStep:
        """The ``LinearStep`` functor of ``ops/csrc/envs.cuh`` (parameter
        names in ``LINEAR_STEP_PARAMS``)."""
        return DeviceStep(
            env_id=LINEAR_STEP_ID,
            params=tuple(getattr(self, k).contiguous()
                         for k in LINEAR_STEP_PARAMS),
            int_params=(),
        )


def make_linear_system(A, B, *, c=None, Q=None, R=None, N=None, q=None,
                       r=None, Q_f=None, q_f=None, low=None, high=None,
                       dtype=torch.float32, device="cuda") -> LinearSystem:
    """Build a ``LinearSystem`` env with the JAX package's defaults (c = 0,
    Q = I, R = I, N = 0, q = 0, r = 0, ``Q_f`` = Q, q_f = 0) and optional
    control bounds ``low``/``high`` (a missing side is unbounded). The env
    lives on the card unless ``device="cpu"`` is passed."""
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)  # noqa: E731
    A, B = t(A), t(B)
    n, m = A.shape[0], B.shape[1]
    dflt = lambda v, s: t(v) if v is not None else torch.zeros(  # noqa: E731
        s, dtype=dtype, device=device)
    Q = t(Q) if Q is not None else torch.eye(n, dtype=dtype, device=device)
    R = t(R) if R is not None else torch.eye(m, dtype=dtype, device=device)
    Q_f = t(Q_f) if Q_f is not None else Q
    bounds = None
    if low is not None or high is not None:
        def side(v, fill):
            if v is None:
                return torch.full((m,), fill, dtype=dtype, device=device)
            return torch.broadcast_to(t(v), (m,)).clone()

        bounds = Bounds(low=side(low, -torch.inf), high=side(high, torch.inf))
    return LinearSystem(
        A=A, B=B, c=dflt(c, (n,)), Q=Q, R=R, N=dflt(N, (n, m)),
        q=dflt(q, (n,)), r=dflt(r, (m,)), Q_f=Q_f, q_f=dflt(q_f, (n,)),
        bounds=bounds,
    )
