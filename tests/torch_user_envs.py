"""User envs whose steps use the ops of the generated step functor's
families, in PyTorch only (``chip_smoke.py`` imports this module on the
card, where there is no JAX; the tests hold each against a JAX twin).

- ``ProbeEnv`` (3, 2): a step through ``atan2``, ``softmax``, ``cumsum``,
  ``einsum``, ``pad``, ``sign``, ``floor``, ``vector_norm``, ``softplus``
  and ``erf``, which the generator refused before it took these ops.
- ``KinematicBicycle`` (4, 2): a fleet of kinematic bicycles (p_x, p_y,
  heading, speed; acceleration, steering) driven to a goal around eight
  soft obstacles: ``split``, ``tan``, ``hypot``, ``atan2``, constant
  indexing, ``vector_norm`` over a dim and ``softplus`` in its step.
- ``TwoLinkArm`` (4, 2): Spong's planar two-link arm, its accelerations
  a ``torch.linalg.solve`` of the mass matrix, reaching a target around six
  point obstacles through ``topk(largest=False)`` of their distances.
- ``HydroCascade`` (4, 4): four reservoirs in a chain, each release
  flowing into the next, its surface area, forebay and tailwater levels
  33-knot tables read by piecewise-linear interpolation (``bucketize`` of
  the interior knots, the knots and values read at that 0-d index),
  releases boxed in [0, q_max].
- ``OpEnv``: a step that sums, for each family it names, a vector of that
  family's ops (``FAMILIES``): elementwise, reductions and scans, index
  maps, nodes with several outputs, linear algebra, sorts, integers. With
  the first six at (8, 3) it is the op-coverage env: every op of those
  families that the bicycle and the arm do not use; with the integers
  family alone, the integer-coverage env. Ops whose value jumps (floor,
  round, sign, an index, ...) enter with a small weight, so that a
  rounding difference that moves one across a jump moves the rollout by
  less than a float32 comparison's tolerance.

Every step takes states ``[..., n]`` and controls ``[..., m]`` with any
leading batch dims (the port's env contract); ``torch.trace``, which has
no batch form, is mapped with ``torch.vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tfmpc_tpu_torch import Bounds, Env


@dataclasses.dataclass(frozen=True, eq=False)
class ProbeEnv(Env):
    """x' = x + 0.1 (W u - 0.3 atan2(x, 1 + p^2) + 0.2 (softmax(x) -
    cumsum(x) / n)) + 0.01 floor(w) sign(x) x^2, p = x shifted right by
    one (a pad of 0.5); the cost a smooth distance to ``g`` (the norm of
    (x - g, 1)) plus controls, softplus and erf terms."""

    W: torch.Tensor   # [n, m]
    w: torch.Tensor   # [n]
    g: torch.Tensor   # [n]

    @property
    def state_size(self):
        return self.W.shape[0]

    @property
    def action_size(self):
        return self.W.shape[1]

    def transition(self, x, u):
        n = x.shape[-1]
        p = F.pad(x[..., :-1], (1, 0), value=0.5)
        y = torch.einsum("ij,...j->...i", self.W, u) \
            - 0.3 * torch.atan2(x, 1.0 + p * p) \
            + 0.2 * (torch.softmax(x, dim=-1) - torch.cumsum(x, dim=-1) / n)
        return x + 0.1 * y + 0.01 * torch.floor(self.w) * torch.sign(x) * x * x

    def _distance(self, x):
        return torch.linalg.vector_norm(F.pad(x - self.g, (0, 1), value=1.0),
                                        dim=-1)

    def cost(self, x, u):
        return (self._distance(x) ** 2 + 0.1 * (u * u).sum(-1)
                + 0.05 * F.softplus(x, beta=2.0).sum(-1)
                + 0.01 * torch.erf(x).sum(-1))

    def final_cost(self, x):
        return 5.0 * self._distance(x) ** 2


def probe_arrays(seed: int = 0, n: int = 3, m: int = 2) -> dict:
    """``ProbeEnv``'s fields, float64, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return dict(W=rng.standard_normal((n, m)), w=rng.uniform(0.5, 2.5, n),
                g=rng.uniform(-1.0, 1.0, n))


@dataclasses.dataclass(frozen=True, eq=False)
class KinematicBicycle(Env):
    """The kinematic bicycle, dt = 0.1, wheelbase 2.7: p += dt v (cos th,
    sin th), th += dt v / 2.7 tan(0.5 tanh(delta)), v += dt a. Stage cost:
    w_goal |goal - p| (``hypot``) + w_head wrap(atan2(goal - p) - th)^2 +
    w_obs sum_k softplus(kappa (r_k - |p - O_k|)) + u R u + w_v (v -
    v_ref)^2, with p = x[[0, 1]]; final cost w_final |goal - p| + v^2."""

    goal: torch.Tensor        # [2]
    obstacles: torch.Tensor   # [K, 2]
    radii: torch.Tensor       # [K]
    R: torch.Tensor           # [2, 2]
    dt: float = 0.1
    wheelbase: float = 2.7
    # weights that keep a solve's total cost ~1e2, where float32 resolves
    # the headline config's atol of 1e-4
    kappa: float = 1.0
    w_goal: float = 0.02
    w_head: float = 0.02
    w_obs: float = 0.05
    w_v: float = 0.01
    v_ref: float = 4.0
    w_final: float = 0.5

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 2

    def transition(self, x, u):
        px, py, th, v = x.split(1, dim=-1)
        a, delta = u.split(1, dim=-1)
        step = self.dt * v
        return torch.cat([
            px + step * torch.cos(th),
            py + step * torch.sin(th),
            th + step / self.wheelbase * torch.tan(0.5 * torch.tanh(delta)),
            v + self.dt * a], dim=-1)

    def _to_goal(self, x):
        d = self.goal - x[..., :2]
        return torch.hypot(d[..., :1], d[..., 1:])

    def cost(self, x, u):
        p = x[..., [0, 1]]
        d = self.goal - p
        e = torch.atan2(d[..., 1:], d[..., :1]) - x[..., 2:3]
        e = torch.atan2(torch.sin(e), torch.cos(e))
        gap = self.radii - torch.linalg.vector_norm(
            p[..., None, :] - self.obstacles, dim=-1)
        obstacles = F.softplus(self.kappa * gap).sum(-1, keepdim=True)
        return (self.w_goal * self._to_goal(x) + self.w_head * e * e
                + self.w_obs * obstacles
                + ((u @ self.R) * u).sum(-1, keepdim=True)
                + self.w_v * (x[..., 3:] - self.v_ref) ** 2).squeeze(-1)

    def final_cost(self, x):
        return (self.w_final * self._to_goal(x)
                + x[..., 3:] ** 2).squeeze(-1)


# the bicycle fleet's goal, eight obstacles between the start box and the
# goal, their radii, and R
BICYCLE = dict(
    goal=[60.0, 4.0],
    obstacles=[[10.0, -3.0], [14.0, 3.5], [20.0, 0.0], [26.0, -4.5],
               [30.0, 4.0], [36.0, -1.0], [42.0, 5.0], [48.0, -3.5]],
    radii=[1.5, 2.0, 1.8, 2.2, 1.6, 2.4, 1.7, 2.0],
    R=[[0.2, 0.0], [0.0, 2.0]])


def bicycle_x0(B: int, seed: int = 0) -> np.ndarray:
    """The fleet's initial states, ``default_rng(seed)``: p in [-5, 5]^2,
    heading in [-0.5, 0.5], speed in [1, 5]."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-5.0, 5.0, (B, 2)),
                           rng.uniform(-0.5, 0.5, (B, 1)),
                           rng.uniform(1.0, 5.0, (B, 1))], axis=1)


@dataclasses.dataclass(frozen=True, eq=False)
class TwoLinkArm(Env):
    """Spong's planar two-link arm (q1, q2 from the x axis, gravity along
    -y; dq1, dq2; torques u): M(q) ddq = u - C(q, dq) dq - G(q) - 0.1 dq,
    solved with ``torch.linalg.solve``, then semi-implicit Euler at dt =
    0.02. m1 = m2 = 1, l1 = l2 = 1, lc = 0.5, I = 1/12, g = 9.81. Stage
    cost: w_goal |p(q) - target|^2 + w_dq |dq|^2 + u R u + w_obs sum
    softplus(kappa (radius - d)) over the two smallest distances d from
    the end effector p(q) to the six point obstacles (``topk(largest=
    False)``); final cost 10 |p(q) - target|^2 + |dq|^2."""

    target: torch.Tensor      # [2]
    obstacles: torch.Tensor   # [6, 2]
    R: torch.Tensor           # [2, 2]
    dt: float = 0.02
    # weights that keep a solve's total cost ~1e2 or less, where float32
    # resolves the headline config's atol of 1e-4
    w_goal: float = 0.1
    w_dq: float = 1e-2
    w_obs: float = 0.5
    kappa: float = 4.0
    radius: float = 0.25

    m1 = m2 = 1.0
    l1 = l2 = 1.0
    lc = 0.5
    inertia = 1.0 / 12.0
    gravity = 9.81
    damping = 0.1

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 2

    def _accel(self, q, dq, u):
        q1, q2 = q[..., 0], q[..., 1]
        d1, d2 = dq[..., 0], dq[..., 1]
        m2, l1, lc, i = self.m2, self.l1, self.lc, self.inertia
        c2 = torch.cos(q2)
        m11 = self.m1 * lc * lc + m2 * (l1 * l1 + lc * lc
                                        + 2.0 * l1 * lc * c2) + 2.0 * i
        m12 = m2 * (lc * lc + l1 * lc * c2) + i
        m22 = (m2 * lc * lc + i) * torch.ones_like(q2)
        M = torch.stack([torch.stack([m11, m12], -1),
                         torch.stack([m12, m22], -1)], -2)
        h = m2 * l1 * lc * torch.sin(q2)
        coriolis = torch.stack([-h * (2.0 * d1 * d2 + d2 * d2), h * d1 * d1],
                               -1)
        g2 = m2 * lc * self.gravity * torch.cos(q1 + q2)
        g1 = (self.m1 * lc + m2 * l1) * self.gravity * torch.cos(q1) + g2
        rhs = u - coriolis - torch.stack([g1, g2], -1) - self.damping * dq
        return torch.linalg.solve(M, rhs)

    def transition(self, x, u):
        q, dq = x[..., :2], x[..., 2:]
        dq = dq + self.dt * self._accel(q, dq, u)
        return torch.cat([q + self.dt * dq, dq], -1)

    def _tip(self, x):
        a, b = x[..., 0], x[..., 0] + x[..., 1]
        return torch.stack([self.l1 * torch.cos(a) + self.l2 * torch.cos(b),
                            self.l1 * torch.sin(a) + self.l2 * torch.sin(b)],
                           -1)

    def cost(self, x, u):
        p = self._tip(x)
        e, dq = p - self.target, x[..., 2:]
        d = torch.linalg.vector_norm(p[..., None, :] - self.obstacles, dim=-1)
        near = torch.topk(d, 2, dim=-1, largest=False).values
        return (self.w_goal * (e * e).sum(-1) + self.w_dq * (dq * dq).sum(-1)
                + ((u @ self.R) * u).sum(-1)
                + self.w_obs * F.softplus(self.kappa * (self.radius - near))
                .sum(-1))

    def final_cost(self, x):
        e, dq = self._tip(x) - self.target, x[..., 2:]
        return 10.0 * (e * e).sum(-1) + (dq * dq).sum(-1)


# the arm's target, raised to the side of its hanging rest, six obstacles
# around the reach, and R
ARM = dict(
    target=[0.8, -1.5],
    obstacles=[[0.5, -1.9], [1.0, -1.1], [0.2, -1.4], [1.3, -1.6],
               [0.6, -0.9], [-0.3, -1.8]],
    R=[[1e-2, 0.0], [0.0, 2e-2]])


def arm_x0(B: int, seed: int = 0) -> np.ndarray:
    """The arm's initial states, ``default_rng(seed)``: near its hanging
    rest, q1 in -pi/2 + [-0.3, 0.3], q2 in [-0.3, 0.3], dq in [-0.2,
    0.2]^2. (Started near the target above the horizontal, the arm falls
    under the kernel checks' random controls and policy and its rollouts
    are chaotic: float32 against float64 on the same inputs, five of
    45,056 line-search costs moved past 1e-3 + 1e-3 |J|, and a one-ulp
    change of x0 nine.)"""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-np.pi / 2 - 0.3, -np.pi / 2 + 0.3,
                                       (B, 1)),
                           rng.uniform(-0.3, 0.3, (B, 1)),
                           rng.uniform(-0.2, 0.2, (B, 2))], axis=1)


@dataclasses.dataclass(frozen=True, eq=False)
class HydroCascade(Env):
    """Four reservoirs in a cascade, one step a period of dt: storage s_i'
    = s_i + dt (inflow_i + q_{i-1} - q_i - evap area_i(s_i)), q_{-1} = 0.
    Stage cost: sum_i [-price eta q_i (forebay_i(s_i) - tailwater_i(q_i))
    + w (s_i - target_i)^2 + w_spill softplus(kappa (s_i - s_max_i)) /
    kappa]; final cost w_final sum_i (s_i - target_i)^2. Surface area and
    forebay level are tables over 33 storage knots, the tailwater level one
    over 33 release knots (``s_knots``, ``q_knots``: [4, 33] each, a row a
    reservoir), interpolated piecewise-linearly, written for one scenario
    as a JAX user writes it: the segment is ``bucketize`` of the interior
    knots, and the knots and values are read at that 0-d index (with any
    leading batch dims the same code indexes by a tensor)."""

    s_knots: torch.Tensor     # [4, 33]
    area: torch.Tensor        # [4, 33]
    forebay: torch.Tensor     # [4, 33]
    q_knots: torch.Tensor     # [4, 33]
    tailwater: torch.Tensor   # [4, 33]
    inflow: torch.Tensor      # [4]
    s_max: torch.Tensor       # [4]
    target: torch.Tensor      # [4]
    bounds: Optional[Bounds] = None
    dt: float = 1.0
    evap: float = 0.01
    # weights that keep a solve's total cost ~1e2 or less, where float32
    # resolves the headline config's atol of 1e-4
    price: float = 0.5
    eta: float = 0.9
    w: float = 0.5
    w_spill: float = 2.0
    kappa: float = 20.0
    w_final: float = 5.0

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 4

    @staticmethod
    def _interp(knots, values, i, v):
        """Row i of the table ``values`` at v, linear between its knots
        (and past the end knots, on the end segments)."""
        k = torch.bucketize(v.contiguous(), knots[i, 1:-1])
        s0, s1 = knots[i, k], knots[i, k + 1]
        a0, a1 = values[i, k], values[i, k + 1]
        return a0 + (a1 - a0) * (v - s0) / (s1 - s0)

    def transition(self, x, u):
        out = []
        for i in range(4):
            up = u[..., i - 1] if i else 0.0
            area = self._interp(self.s_knots, self.area, i, x[..., i])
            out.append(x[..., i] + self.dt * (self.inflow[i] + up - u[..., i]
                                              - self.evap * area))
        return torch.stack(out, -1)

    def _storage(self, x):
        d = x - self.target
        return (d * d).sum(-1)

    def cost(self, x, u):
        revenue = 0.0
        for i in range(4):
            head = self._interp(self.s_knots, self.forebay, i, x[..., i]) \
                - self._interp(self.q_knots, self.tailwater, i, u[..., i])
            revenue = revenue + u[..., i] * head
        spill = F.softplus(self.kappa * (x - self.s_max)).sum(-1) / self.kappa
        return (-self.price * self.eta * revenue + self.w * self._storage(x)
                + self.w_spill * spill)

    def final_cost(self, x):
        return self.w_final * self._storage(x)


def cascade_arrays() -> tuple:
    """``HydroCascade``'s tables and its box (0, q_max), float64: storage
    knots over [0, 1.5 s_max], release knots over [0, 1.5 q_max]; area
    (0.5 + 0.7 sqrt(s / s_max)) s_max, forebay 1 + 0.8 (s / s_max)^0.6,
    tailwater 0.05 + 0.3 (q / q_max)^0.5 (monotone and concave, so the
    kinks are mild); inflows that q_max passes on down the chain."""
    s_max = np.array([1.0, 0.8, 1.2, 0.9])
    q_max = np.array([0.08, 0.12, 0.16, 0.2])
    grid = np.linspace(0.0, 1.5, 33)
    s_knots, q_knots = grid * s_max[:, None], grid * q_max[:, None]
    arrays = dict(
        s_knots=s_knots,
        area=(0.5 + 0.7 * np.sqrt(grid))[None] * s_max[:, None],
        forebay=np.broadcast_to(1.0 + 0.8 * grid ** 0.6, (4, 33)).copy(),
        q_knots=q_knots,
        tailwater=np.broadcast_to(0.05 + 0.3 * np.sqrt(grid),
                                  (4, 33)).copy(),
        inflow=np.array([0.03, 0.02, 0.025, 0.015]),
        s_max=s_max, target=0.6 * s_max)
    return arrays, (np.zeros(4), q_max)


def cascade_x0(B: int, seed: int = 0) -> np.ndarray:
    """The cascade's initial storages, ``default_rng(seed)``: each in
    [0.3, 0.9] s_max."""
    s_max = cascade_arrays()[0]["s_max"]
    return np.random.default_rng(seed).uniform(0.3, 0.9, (B, 4)) * s_max


# -- the op families ----------------------------------------------------------
# Each returns a vector [..., 8] of x [..., 8], u [..., 3] and the env's
# parameters; jumps (floor, ceil, trunc, round, sign, heaviside, fmod,
# remainder, masked_fill on a comparison) are weighted by JUMP.

JUMP = 1e-3


def _trace(M):
    if M.dim() == 2:
        return torch.trace(M)
    return torch.vmap(torch.trace)(M.flatten(0, -3)).reshape(M.shape[:-2])


def elementwise(env, x, u):
    t = torch.tanh(x)
    s = 1.0 + x * x
    u3 = torch.cat([u, u, u[..., :2]], dim=-1)
    smooth = torch.stack([
        torch.atan2(x[..., 0], 1.0 + u[..., 0] ** 2) + torch.atan(x[..., 1]),
        torch.tan(0.5 * t[..., 2]) + torch.sinh(0.5 * x[..., 3])
        - torch.cosh(0.3 * x[..., 4]),
        torch.asin(0.9 * t[..., 5]) + torch.acos(0.8 * t[..., 6])
        + torch.asinh(x[..., 7]),
        torch.acosh(s[..., 0]) + torch.atanh(0.7 * t[..., 1])
        + torch.erf(x[..., 2]) - torch.erfc(x[..., 3]),
        torch.hypot(x[..., 4], u[..., 1]) + torch.exp2(0.5 * x[..., 5])
        - torch.log2(s[..., 6]) + torch.log10(s[..., 7]),
        F.softplus(x[..., 0], beta=2.0, threshold=1.5)
        + F.gelu(x[..., 1]) + F.gelu(x[..., 2], approximate="tanh"),
        F.silu(x[..., 3]) + F.elu(x[..., 4], alpha=0.7)
        + F.leaky_relu(x[..., 5], 0.2),
        F.hardtanh(x[..., 6], -0.6, 0.8) + torch.nan_to_num(x[..., 7])],
        dim=-1)
    jumps = (torch.floor(2.0 * x) + torch.ceil(x - u3) + torch.trunc(3.0 * x)
             + torch.round(2.0 * x) + torch.sign(x - 0.1)
             + torch.heaviside(x, env.c) + torch.fmod(3.0 * x, 0.7)
             + torch.remainder(3.0 * x, 0.7)
             + torch.remainder(2.0 * x, -0.9)
             + (2.0 * x).masked_fill(x > 0.5, 0.25)
             + torch.copysign(x, u3 - 0.1) + torch.copysign(x, -1.0)
             + torch.sgn(x - 0.2))
    # 1 where x is finite (every input): isinf and isfinite as values
    finite = torch.isfinite(x).to(x.dtype) - torch.isinf(x).to(x.dtype)
    return smooth + JUMP * jumps + 0.1 * finite


def reductions(env, x, u):
    M = x[..., :, None] * x[..., None, :4] + env.W[:, :4]   # [..., 8, 4]
    pts = x.reshape(x.shape[:-1] + (4, 2))
    centers = env.W[:3, :2]
    d2 = torch.cdist(pts, centers)                           # [..., 4, 3]
    d1 = torch.cdist(pts, centers, p=1.0)
    d3 = torch.cdist(pts, centers, p=3.0)
    norms = torch.stack([
        torch.linalg.vector_norm(x, dim=-1),
        torch.linalg.vector_norm(x - u.sum(-1, keepdim=True), ord=1.0,
                                 dim=-1),
        torch.linalg.vector_norm(x, ord=float("inf"), dim=-1),
        torch.linalg.vector_norm(x, ord=float("-inf"), dim=-1),
        torch.linalg.vector_norm(x, ord=3.0, dim=-1),
        torch.linalg.vector_norm(M, ord=-1.5, dim=(-2, -1)),
        torch.linalg.vector_norm(M, dim=-2, keepdim=True).sum((-2, -1)),
        JUMP * torch.linalg.vector_norm(torch.relu(x), ord=0, dim=-1)],
        dim=-1)
    # traces of a square, a tall ([8, 4]) and a wide ([2, 4]) matrix
    square = M[..., :4, :] @ M[..., 4:, :].mT                # [..., 4, 4]
    return (norms + torch.softmax(x, dim=-1)
            - torch.log_softmax(0.5 * x, dim=-1)
            + torch.logsumexp(M, dim=-1).sum(-1, keepdim=True)
            + torch.logsumexp(M, dim=(-2, -1), keepdim=True)[..., 0]
            + 0.1 * torch.cumsum(x, dim=-1)
            + 0.1 * torch.cumprod(torch.tanh(x), dim=-1)
            + 0.1 * torch.cumsum(M, dim=-2).sum(-1)
            + 0.1 * (_trace(square) + _trace(M)
                     - _trace(M[..., :2, :]))[..., None]
            + torch.cat([d2.sum(-1), d1.sum(-2), d3[..., 0]], dim=-1)[..., :8])


def index_maps(env, x, u):
    M = x[..., :, None] * env.W                              # [..., 8, 8]
    pad = F.pad(x[..., 2:7], (2, 1), value=0.25)             # [..., 8]
    crop = F.pad(M, (-2, -2, 1, -1))[..., 3, :].repeat(
        *([1] * (x.dim() - 1)), 2)                           # [..., 8]
    v3 = torch.linalg.cross(x[..., :3], torch.cat([u[..., 1:], x[..., 4:5]],
                                                  dim=-1))
    A = x[..., :8].reshape(x.shape[:-1] + (2, 2, 2))
    Bm = env.W[:2, :4].reshape(2, 2, 2)
    prod = torch.einsum("...bij,bjk->...bik", A, Bm).flatten(-3)   # bmm
    diag = torch.diag_embed(x[..., :3], offset=1)            # [..., 4, 4]
    diag2 = torch.diag_embed(u, offset=-1, dim1=-1, dim2=-2)  # [..., 4, 4]
    return (pad + crop + torch.flip(x, dims=[-1])
            + torch.roll(x, 3, dims=-1) + torch.roll(M, (1, -2), (-2, -1))[
                ..., 0, :]
            + torch.cat([v3, torch.diagonal(M, -1, dim1=-2, dim2=-1)[
                ..., :5]], dim=-1)
            + prod + torch.tile(torch.diagonal(diag + diag2, 1, -2, -1)
                                .sum(-1, keepdim=True), (8,))
            + x[..., [3, 0, 7, 7, 1, 2, 6, 5]]
            + x[..., torch.arange(7, -1, -1)]
            + M[..., [0, 2, 4, 6, 1, 3, 5, 7], [1, 1, 0, 0, 2, 2, 3, 3]])


def multi_output(env, x, u):
    M = x.reshape(x.shape[:-1] + (2, 4))
    hi = torch.max(M, dim=-1).values                         # [..., 2]
    lo = torch.min(M, dim=-2, keepdim=True)[0][..., 0, :]    # [..., 4]
    head, tail = torch.split(x, [3, 5], dim=-1)
    a, b = torch.chunk(x, 2, dim=-1)
    rows = M.unbind(-2)
    return torch.cat([hi, lo, head[..., :2]], dim=-1) \
        + torch.cat([tail, u], dim=-1) + a.repeat(
            *([1] * (x.dim() - 1)), 2) * b.sum(-1, keepdim=True) \
        + rows[1].repeat(*([1] * (x.dim() - 1)), 2)


def _per_scenario(fn, x):
    """``fn`` of one scenario's ``x [8]`` over any leading batch dims (for
    the ops that reduce every dim)."""
    if x.dim() == 1:
        return fn(x)
    return torch.vmap(fn)(x.flatten(0, -2)).reshape(x.shape[:-1])


def linalg(env, x, u):
    """Solves, factorizations and determinants of 4x4 matrices of the
    state: a general one, 3 I + 0.3 tanh(x_:4) tanh(x_4:)^T + 0.1 u_0 W, and
    a symmetric positive definite one, 3 I + 0.3 tanh(x_:4) tanh(x_:4)^T +
    0.1 sigmoid(u_1) V V^T (what the arm's vector solve does not use)."""
    a, b = torch.tanh(x[..., :4]), torch.tanh(x[..., 4:])
    eye = torch.eye(4, dtype=x.dtype, device=x.device)
    G = 3.0 * eye + 0.3 * a[..., :, None] * b[..., None, :] \
        + 0.1 * u[..., :1, None] * env.W[:4, :4]
    V = env.W[4:, :4]
    S = 3.0 * eye + 0.3 * a[..., :, None] * a[..., None, :] \
        + 0.1 * torch.sigmoid(u[..., 1:2, None]) * (V @ V.mT)
    rhs = torch.stack([x[..., :4], x[..., 4:]], -1)           # [..., 4, 2]
    L = torch.linalg.cholesky(S)
    U = torch.linalg.cholesky(S, upper=True)
    LU, pivots = torch.linalg.lu_factor(G)
    sign, logabs = torch.linalg.slogdet(G)
    head = (torch.linalg.solve(G, rhs).sum(-1)
            + (torch.linalg.inv(S) @ x[..., :4, None])[..., 0]
            + torch.cholesky_solve(rhs, L)[..., 0]
            + torch.cholesky_solve(rhs, U, upper=True)[..., 1]
            + 0.1 * (L @ x[..., 4:, None])[..., 0]
            + 0.1 * (U @ x[..., :4, None])[..., 0])
    tail = (torch.linalg.lu_solve(LU, pivots, rhs)[..., 1]
            + torch.linalg.solve_triangular(torch.tril(G), rhs,
                                            upper=False)[..., 0]
            + torch.linalg.solve_triangular(G, rhs, upper=True,
                                            unitriangular=True)[..., 1]
            + torch.linalg.solve_triangular(G, x[..., None, 4:], upper=True,
                                            left=False)[..., 0, :]
            + 0.1 * torch.triu(G, 1).sum(-2))
    scalars = 0.01 * (torch.linalg.det(G) - 81.0) + 0.1 * logabs + 0.1 * sign
    return torch.cat([head, tail], -1) + scalars[..., None]


def sorts(env, x, u):
    """Sorted values along a dim (ascending, descending and stable),
    ``topk`` (largest), ``kthvalue``, ``median`` over every element and
    over a dim (the lower median): continuous in x, so no jump weight."""
    M = x.reshape(x.shape[:-1] + (2, 4))
    top = torch.cat([torch.topk(x, 3).values,
                     torch.topk(M, 2, dim=-1).values.flatten(-2),
                     torch.kthvalue(x, 3).values[..., None]], -1)
    lows = (torch.kthvalue(M, 2, dim=-1, keepdim=True).values
            + torch.median(M, dim=-1, keepdim=True).values).flatten(-2)
    return (torch.sort(x, dim=-1).values
            + torch.sort(x * u[..., :1], descending=True, stable=True).values
            + torch.sort(M, dim=-2, descending=True).values.flatten(-2)
            + top + lows.repeat(*([1] * (x.dim() - 1)), 4)
            + (_per_scenario(torch.median, x)
               + torch.median(x, dim=-1).values)[..., None])


def _each(fn, *args):
    """``fn`` of one scenario's arguments (each ``[..., k]``) over any
    leading batch dims (for an op whose index is one scenario's:
    ``index_select``, a flattened ``argmax``)."""
    if args[0].dim() == 1:
        return fn(*args)
    lead = args[0].shape[:-1]
    out = torch.vmap(fn)(*(a.reshape(-1, a.shape[-1]) for a in args))
    return out.reshape(lead + out.shape[1:])


def _read(env, v, k):
    """``v[..., k]`` at a 0-d (per scenario) index k as the generated
    functor and JAX's ``x[i]`` read it: negative k wraps, k still out of
    range is clamped into it. With ``env.raw_index`` (the step traced into
    the functor) the read is ``v[k]`` itself, which the functor clamps; in
    eager torch, which raises out of range, the clamp is written out."""
    if v.dim() == 1 and env.raw_index:
        return v[k]
    L = v.shape[-1]
    k = torch.where(k < 0, k + L, k).clamp(0, L - 1)
    return torch.gather(v, -1, k[..., None])[..., 0] if v.dim() > 1 \
        else v[k]


def integers(env, x, u):
    """Integer values and indices computed at run time: ``bucketize``
    (``right``, ``out_int32``) and ``searchsorted`` (``side``) of sorted
    knots from the parameters, float to int casts, integer arithmetic
    (floor and truncating divisions, remainders, wrapping add, mul, neg,
    abs, comparisons, clamp, min/max, where), floor and truncating
    divisions of floats, ``argmax``/``argmin`` at a
    tie (a value twice) and at a NaN (on half the inputs), flattened and
    over a dim, the indices of max/min over a dim and of sorts (``argsort``,
    ``topk``, ``kthvalue``, ``median``), reads at those indices (advanced
    indexing with a constant index and a None slot, ``gather``,
    ``index_select``, ``take_along_dim``, ``one_hot``, a negative index
    and one out of range, ``_read``); all but a smooth 0.1 tanh(x)
    weighted by JUMP (an index jumps)."""
    W, t = env.W, torch.tanh(x)
    knots = 2.4 * torch.cumsum(env.c, -1) / env.c.sum() - 1.2     # [8]
    xc = x.contiguous()
    kb = torch.bucketize(xc, knots)                                # 0..8
    kr = torch.bucketize(xc, knots, right=True, out_int32=True)
    ks = torch.searchsorted(knots, xc, side="right")
    kl = torch.searchsorted(knots, xc, out_int32=True)
    a = torch.floor(2.5 * x).long()                                # -4..3
    b = (3.0 * x).to(torch.int32)                                  # trunc
    arith = (torch.floor_divide(a, 3) + torch.div(a, -2, rounding_mode="floor")
             + torch.div(b, 2, rounding_mode="trunc") + torch.remainder(a, 3)
             + torch.remainder(a, -3) + torch.fmod(b, 3) - 2 * a + (-b).abs()
             + torch.clamp(a, -2, 2) * torch.minimum(kb, ks)
             + torch.maximum(kr, kl) + torch.where(a > b, a, b)
             + (kb == kl) + (a - kr) // 2)
    fdiv = (torch.div(x, -0.9, rounding_mode="trunc")
            + torch.div(x, 0.6, rounding_mode="floor"))
    # a tie (x_0, x_1 twice) and a NaN where x_5 > 0
    nan = torch.where(x[..., 5:6] > 0, torch.full_like(x[..., 5:6], math.nan),
                      x[..., 5:6])
    v = torch.cat([x[..., :2], x[..., :2], nan, t[..., 6:]], -1)   # [..., 7]
    finite = torch.cat([x[..., :2], x[..., :2], x[..., 5:6], t[..., 6:]], -1)
    M = x.reshape(x.shape[:-1] + (2, 4))
    hi = torch.max(M, dim=-1).indices                              # [..., 2]
    lo = torch.min(M, dim=-2, keepdim=True).indices             # [..., 1, 4]
    med = torch.median(M, dim=-1).indices                          # [..., 2]
    picks = torch.cat([
        torch.gather(finite, -1, torch.argmax(v, -1, keepdim=True)),
        torch.gather(finite, -1, torch.argmin(v, -1, keepdim=True)),
        torch.gather(M, -1, hi[..., None])[..., 0],
        torch.gather(M, -2, lo)[..., 0, :2],
        _each(lambda y: torch.gather(y, 0, torch.argmax(y.reshape(2, 4))[
            None]), x),
        torch.take_along_dim(x, torch.kthvalue(x, 4, keepdim=True).indices,
                             dim=-1)], -1)                         # [..., 8]
    rows = (W[torch.clamp(kb, max=7), torch.arange(8, device=x.device)]
            + W[:, torch.remainder(a, 8)].sum(0)
            + (F.one_hot(torch.clamp(kl, max=7).long(), 8).to(x.dtype)
               * W[0]).sum(-1))
    near = torch.topk(x, 3, largest=False).indices
    rank = (torch.gather(x, -1, torch.argsort(x * u[..., :1], dim=-1))
            + torch.take_along_dim(W[1].expand_as(x), torch.cat(
                [near, near, near[..., :2]], -1), dim=-1)
            + torch.gather(M, -1, med[..., None])[..., 0].sum(
                -1, keepdim=True))
    q = torch.floor(6.0 * x[..., 0]).long()                        # -9..8
    odd = torch.stack([
        _read(env, W[2], q), _read(env, x, -1 - q),
        _each(lambda y, k: torch.index_select(y, 0, k), x,
              torch.remainder(a, 8))[..., 0],
        (kb.to(x.dtype) - kr.to(x.dtype)).sum(-1)], -1)
    return 0.1 * t + JUMP * (picks + arith.to(x.dtype) + fdiv + rows + rank
                             + torch.cat([odd, odd], -1))


FAMILIES = {"elementwise": elementwise, "reductions": reductions,
            "index_maps": index_maps, "multi_output": multi_output,
            "linalg": linalg, "sorts": sorts, "integers": integers}
# the op-coverage env's families (the integer-coverage env's is "integers")
OPCOV_FAMILIES = ("elementwise", "reductions", "index_maps", "multi_output",
                  "linalg", "sorts")


@dataclasses.dataclass(frozen=True, eq=False)
class OpEnv(Env):
    """x' = x + 0.05 y / (1 + |y|), y the sum of ``families``' vectors
    (each [..., 8]): bounded steps that stay sensitive to y where it is
    large (tanh saturates: the reductions' y is 18-57 at the tests'
    inputs, where tanh' < 1e-15); cost |x|^2 + 0.1 |u|^2, final cost 2
    |x|^2 (y in the stage cost would have one lane compute all of it each
    step)."""

    W: torch.Tensor   # [8, 8]
    c: torch.Tensor   # [8]
    families: tuple = OPCOV_FAMILIES
    # the integers family's reads as written, out of range included
    # (``_read``): the step that its generated functor traces
    raw_index: bool = False

    @functools.cached_property
    def _as_written(self):
        return dataclasses.replace(self, raw_index=True)

    def generic_device_step(self, dtype=None, device=None):
        """The functor generated from the step as written: with the
        integers family, from its twin whose reads out of range are
        ``v[k]`` itself (eager torch raises there; this env's own step
        clamps as the functor does, so that its plain rollouts run)."""
        if self.raw_index or "integers" not in self.families:
            return super().generic_device_step(dtype, device)
        return self._as_written.generic_device_step(dtype, device)

    @property
    def state_size(self):
        return 8

    @property
    def action_size(self):
        return 3

    def _y(self, x, u):
        return sum(FAMILIES[f](self, x, u) for f in self.families)

    def transition(self, x, u):
        y = self._y(x, u)
        return x + 0.05 * y / (1.0 + torch.abs(y))

    def cost(self, x, u):
        return (x * x).sum(-1) + 0.1 * (u * u).sum(-1)

    def final_cost(self, x):
        return 2.0 * (x * x).sum(-1)


def op_arrays(seed: int = 8) -> dict:
    """``OpEnv``'s fields, float64, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return dict(W=0.5 * rng.standard_normal((8, 8)),
                c=rng.uniform(0.0, 1.0, 8))
