"""The step functor generated from a user env's PyTorch step.

``ops/env_codegen.py`` traces an env's public ``transition``, ``cost`` and
``final_cost`` on one scenario and emits C++ for a functor in
``csrc/envs.cuh``'s contract, which the rollout kernels compile in
(``csrc/rollout_user.cuh``), as the JAX package's ``generic_lane_functions``
traces the same three into its Pallas kernels. There is no nvcc here, so
the functor is compiled for the host with g++ (``env_codegen.host_source``:
the CUDA qualifiers defined away, and a harness that loops ``prep``,
``row``, ``stage_cost`` and ``final_cost`` over a batch) and held, on the
same seeded inputs in float64, against the port env's own step and the JAX
env's ``generic_lane_functions()`` step: within 1e-12 of the largest value
compared (the functor sums in index order, torch and XLA in their own).
Cases: the custom-env example's ``DampedChain``, a twin of
``tests/test_fuzz_envs.py``'s ``RandomSmoothEnv`` at (3, 2), (5, 5) and
(8, 3), and the public steps of navigation (two zones), HVAC-6,
reservoir-5 and a linear system at (24, 6); one env for each family of ops
the generator widened to (``tests/torch_user_envs.py``: elementwise,
reductions and scans, index maps, nodes with several outputs, linear
algebra, sorts, and all six together, the op-coverage env of
``chip_smoke.py`` phase 31), the probe env, the kinematic bicycle fleet and
the two-link arm, the tabulated hydro cascade and the integers family;
an env of the other supported ops against its own step. Then torch's
semantics where C's or JAX's differ (round half to even, remainder's
sign, sign and heaviside at NaN, nan_to_num's defaults, softplus's
threshold; NaN, infinities and tied signed zeros in sorts, singular and
indefinite matrices; integer indices negative and out of range, ties and
NaN in argmax, a value exactly at a knot, negative floor divisions and
remainders, NaN and infinities cast to integers) at the inputs that show
them, the integer patterns a user's step reads (two of them refused at
trace time before, ``ScalarIndexMode``), the steps refused as integer
values before, ops traced through ``torch._decomp``, the refusals (an
eigendecomposition, a random op, a random index, ``searchsorted`` with a
sorter, a data-dependent shape or branch, a wrong output shape, each
naming the opt-outs, and a solve that raises instead of falling back) and
that the source depends on the graph, dims and dtype, not on the parameter
values. Only the g++ cases skip, and only where g++ is absent.
"""

import ctypes
import dataclasses
import json
import runpy
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import jax.scipy.special as jsp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.fx.experimental.proxy_tensor import make_fx

from tfmpc_tpu import Env as JaxEnv
from tfmpc_tpu.core.types import pytree_dataclass
from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu_torch import Bounds, Env, interop
from tfmpc_tpu_torch.models.base import USER_STEP_ID
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.ops import env_codegen
from tfmpc_tpu_torch.solvers import ilqr

import test_fuzz_envs
import torch_user_envs as tue

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE = runpy.run_path(str(ROOT / "examples" / "torch_custom_env.py"))
JAX_EXAMPLE = runpy.run_path(str(ROOT / "examples" / "custom_env.py"))
B = 16
TOL = 1e-12


@dataclasses.dataclass(frozen=True, eq=False)
class RandomSmoothEnv(Env):
    """The port's twin of ``test_fuzz_envs.RandomSmoothEnv``, over
    ``[..., n]`` as the port's envs are: x' = x + dt (A x + B u + s
    tanh(x)); a quadratic plus tanh cost."""

    A: torch.Tensor
    B: torch.Tensor
    s: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    q: torch.Tensor
    bounds: Optional[Bounds] = None

    @property
    def state_size(self):
        return self.A.shape[0]

    @property
    def action_size(self):
        return self.B.shape[1]

    def transition(self, x, u):
        return x + 0.1 * (x @ self.A.mT + u @ self.B.mT
                          + self.s * torch.tanh(x))

    def cost(self, x, u):
        return (((x @ self.Q) * x).sum(-1) + ((u @ self.R) * u).sum(-1)
                + (self.q * torch.tanh(x)).sum(-1))

    def final_cost(self, x):
        return 2.0 * ((x @ self.Q) * x).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class OpsEnv(Env):
    """A step through the supported ops the other cases do not reach."""

    W: torch.Tensor   # [n, n]
    c: torch.Tensor   # [n]
    k: torch.Tensor   # 0-d

    @property
    def state_size(self):
        return self.W.shape[0]

    def transition(self, x, u):
        n = x.shape[-1]
        y = torch.where(x > 0.2, torch.sigmoid(x), -torch.abs(x) / 3.0)
        z = torch.maximum(x, self.c) - torch.minimum(u, 0.5 * self.c)
        w = torch.matmul(self.W, torch.clamp(x, -1.0, 1.0)) / (1.0 + x * x)
        s = torch.stack([x[0], x[1:].mean()]).sum() * self.k
        cat = torch.cat([x[1:], x[:1]])
        v = x.reshape(1, n).t().reshape(n) + x.view(1, n).expand(2, n)[1]
        f = torch.full((n,), 0.25, dtype=x.dtype) * torch.exp(-u * u)
        # a roll of the flattened tensor; indices on dims that are not
        # adjacent (their dim leads)
        r = torch.roll(torch.outer(x, u), 3).sum(-1)
        c = x[:, None, None] * u[None, :, None] * x[None, None, :]
        g = c[[0, 2], :, [1, 3]].sum(0)
        return (x + 0.05 * (y + z + w + cat - v + f + r + g) + 0.01 * s
                + torch.log(1.0 + u ** 2) * torch.sqrt(torch.abs(u) + 1.0))

    def cost(self, x, u):
        g = torch.relu(x - self.c).pow(3).sum() + torch.dot(u, u)
        return g + torch.sin(x).prod() + (x @ self.W).max() \
            - 1.0 / (2.0 + torch.cos(u).sum() ** 2)

    def final_cost(self, x):
        return torch.scalar_tensor(1.5, dtype=x.dtype) * (x * x).mean() \
            + torch.tanh(x).amin(dim=-1)


class SortIndicesAsValues(RandomSmoothEnv):
    """A sort's indices read as values (refused before the integer
    family)."""

    def transition(self, x, u):
        return x + 0.1 * torch.argsort(x, dim=-1).to(x.dtype)


class LinearSolve(RandomSmoothEnv):
    """An eigendecomposition (solves and factorizations are supported)."""

    def transition(self, x, u):
        S = self.Q + self.Q.mT + x[..., :, None] * x[..., None, :]
        return x + 0.1 * torch.linalg.eigh(S).eigenvalues


class BigSolve(RandomSmoothEnv):
    """A solve of a 9x9 matrix, past the functor's local arrays."""

    def transition(self, x, u):
        t = torch.tanh(torch.cat([x, x, x], -1))
        M = 3.0 * torch.eye(9, dtype=x.dtype, device=x.device) \
            + t[..., :, None] * t[..., None, :]
        return x + 0.1 * torch.linalg.solve(M, t)[..., :3]


class RightSolve(RandomSmoothEnv):
    """X A = B (``left=False``)."""

    def transition(self, x, u):
        A = self.Q + 3.0 * torch.eye(3, dtype=x.dtype, device=x.device)
        return x + 0.1 * torch.linalg.solve(A, x[..., None, :],
                                            left=False)[..., 0, :]


class RandomStep(RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * torch.rand_like(x)


class RandomIndex(RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * x[torch.randint(0, x.shape[-1], x.shape)]


class IntegerArithmetic(RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * torch.argmax(x, dim=-1, keepdim=True).to(x.dtype)


class MaxIndexAsValue(RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * torch.max(x, dim=-1, keepdim=True).indices.to(
            x.dtype)


class SorterSearch(RandomSmoothEnv):
    """``searchsorted`` with a ``sorter``."""

    def transition(self, x, u):
        k = torch.searchsorted(self.s, x.contiguous(),
                               sorter=torch.argsort(self.s))
        return x + 0.1 * k.to(x.dtype)


class NonzeroShape(RandomSmoothEnv):
    """``nonzero``, whose output's shape depends on the values."""

    def transition(self, x, u):
        return x + 0.1 * torch.nonzero(x > 0).sum().to(x.dtype)


class Branchy(RandomSmoothEnv):
    def transition(self, x, u):
        if x[0] > 0:
            return x + 0.1 * u
        return x - 0.1 * u


class WideCost(RandomSmoothEnv):
    def cost(self, x, u):
        return x * x


def _fuzz_envs(seed, n, m, bounded=False):
    """The JAX fuzz env and its port twin on the same float64 values."""
    jenv32 = test_fuzz_envs._make_env(seed, n, m, bounded)
    arrays = {f.name: np.asarray(getattr(jenv32, f.name), np.float64)
              for f in dataclasses.fields(jenv32) if f.name != "bounds"}
    bounds = None
    if bounded:
        bounds = tuple(np.asarray(a, np.float64) for a in
                       (jenv32.bounds.low, jenv32.bounds.high))
    jenv = test_fuzz_envs.RandomSmoothEnv(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        bounds=None if bounds is None else test_fuzz_envs.Bounds(
            low=jnp.asarray(bounds[0]), high=jnp.asarray(bounds[1])))
    tenv = interop.user_env_from_numpy(RandomSmoothEnv, arrays, bounds,
                                       dtype=torch.float64, device="cpu")
    return jenv, tenv


def _chain(d, coupling_seed=None):
    C = (-2.0 * np.eye(d) + np.eye(d, k=1) + np.eye(d, k=-1)) * 0.3
    if coupling_seed is not None:
        C = C + 0.05 * np.random.default_rng(coupling_seed).standard_normal(
            (d, d))
    jenv = JAX_EXAMPLE["DampedChain"](coupling=jnp.asarray(C))
    tenv = interop.user_env_from_numpy(EXAMPLE["DampedChain"],
                                       {"coupling": C},
                                       dtype=torch.float64, device="cpu")
    return jenv, tenv


def _linear24x6():
    rng = np.random.default_rng(24)
    n, m = 24, 6
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    return dict(name="linear", A=np.eye(n) + 0.05 * rng.standard_normal(
        (n, n)), B=0.1 * rng.standard_normal((n, m)),
        c=0.01 * rng.standard_normal(n), Q=0.5 * (L @ L.T) + 0.5 * np.eye(n),
        R=np.eye(m), N=0.01 * rng.standard_normal((n, m)),
        q=0.1 * rng.standard_normal(n), r=0.1 * rng.standard_normal(m),
        Q_f=np.eye(n), q_f=0.1 * rng.standard_normal(n))


def _registry(name, **over):
    if name == "linear":
        cfg = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
               for k, v in _linear24x6().items()}
    else:
        cfg = json.loads((ROOT / "configs" / f"{name}.json").read_text())
        cfg.pop("x0", None)
    cfg.update(over)
    return (jax_make_env(cfg, dtype=jnp.float64),
            make_env(cfg, dtype=torch.float64, device="cpu"))


# -- JAX twins of tests/torch_user_envs.py's envs, over one scenario -----------

def _j_softplus(x, beta=1.0, threshold=20.0):
    """torch's softplus: x past the threshold, else log1p(exp(beta x)) /
    beta."""
    return jnp.where(x * beta > threshold, x,
                     jnp.log1p(jnp.exp(x * beta)) / beta)


def _j_elementwise(env, x, u):
    t, s = jnp.tanh(x), 1.0 + x * x
    u3 = jnp.concatenate([u, u, u[:2]])
    smooth = jnp.stack([
        jnp.arctan2(x[0], 1.0 + u[0] ** 2) + jnp.arctan(x[1]),
        jnp.tan(0.5 * t[2]) + jnp.sinh(0.5 * x[3]) - jnp.cosh(0.3 * x[4]),
        jnp.arcsin(0.9 * t[5]) + jnp.arccos(0.8 * t[6]) + jnp.arcsinh(x[7]),
        jnp.arccosh(s[0]) + jnp.arctanh(0.7 * t[1]) + jsp.erf(x[2])
        - jsp.erfc(x[3]),
        jnp.hypot(x[4], u[1]) + jnp.exp2(0.5 * x[5]) - jnp.log2(s[6])
        + jnp.log10(s[7]),
        _j_softplus(x[0], 2.0, 1.5) + jax.nn.gelu(x[1], approximate=False)
        + jax.nn.gelu(x[2], approximate=True),
        jax.nn.silu(x[3]) + jax.nn.elu(x[4], alpha=0.7)
        + jax.nn.leaky_relu(x[5], 0.2),
        jnp.clip(x[6], -0.6, 0.8) + jnp.nan_to_num(x[7])])
    jumps = (jnp.floor(2.0 * x) + jnp.ceil(x - u3) + jnp.trunc(3.0 * x)
             + jnp.round(2.0 * x) + jnp.sign(x - 0.1)
             + jnp.heaviside(x, env.c) + jnp.fmod(3.0 * x, 0.7)
             + jnp.remainder(3.0 * x, 0.7) + jnp.remainder(2.0 * x, -0.9)
             + jnp.where(x > 0.5, 0.25, 2.0 * x)
             + jnp.copysign(x, u3 - 0.1) + jnp.copysign(x, -1.0)
             + jnp.sign(x - 0.2))
    finite = jnp.isfinite(x).astype(x.dtype) - jnp.isinf(x).astype(x.dtype)
    return smooth + tue.JUMP * jumps + 0.1 * finite


def _j_pnorm(v, p, axis=None):
    a = jnp.abs(v)
    return (a ** p).sum(axis) ** (1.0 / p)


def _j_reductions(env, x, u):
    M = x[:, None] * x[None, :4] + env.W[:, :4]
    diff = x.reshape(4, 2)[:, None, :] - env.W[:3, :2][None]
    d2 = jnp.sqrt((diff * diff).sum(-1))
    d1 = jnp.abs(diff).sum(-1)
    d3 = _j_pnorm(diff, 3.0, -1)
    norms = jnp.stack([
        jnp.linalg.norm(x), jnp.abs(x - u.sum()).sum(), jnp.abs(x).max(),
        jnp.abs(x).min(), _j_pnorm(x, 3.0), _j_pnorm(M, -1.5),
        jnp.sqrt((M * M).sum(0)).sum(),
        tue.JUMP * (jax.nn.relu(x) != 0).sum()])
    square = M[:4] @ M[4:].T
    return (norms + jax.nn.softmax(x) - jax.nn.log_softmax(0.5 * x)
            + jax.nn.logsumexp(M, axis=-1).sum() + jax.nn.logsumexp(M)
            + 0.1 * jnp.cumsum(x) + 0.1 * jnp.cumprod(jnp.tanh(x))
            + 0.1 * jnp.cumsum(M, axis=0).sum(-1)
            + 0.1 * (jnp.trace(square) + jnp.trace(M) - jnp.trace(M[:2]))
            + jnp.concatenate([d2.sum(-1), d1.sum(0), d3[:, 0]])[:8])


def _j_index_maps(env, x, u):
    M = x[:, None] * env.W
    pad = jnp.pad(x[2:7], (2, 1), constant_values=0.25)
    crop = jnp.tile(jnp.pad(M, ((1, 0), (0, 0)))[:-1, 2:-2][3], 2)
    v3 = jnp.cross(x[:3], jnp.concatenate([u[1:], x[4:5]]))
    prod = jnp.einsum("bij,bjk->bik", x.reshape(2, 2, 2),
                      env.W[:2, :4].reshape(2, 2, 2)).reshape(-1)
    D = jnp.diag(x[:3], k=1) + jnp.diag(u, k=1)
    return (pad + crop + x[::-1] + jnp.roll(x, 3)
            + jnp.roll(M, (1, -2), axis=(0, 1))[0]
            + jnp.concatenate([v3, jnp.diagonal(M, -1)[:5]]) + prod
            + jnp.diagonal(D, 1).sum()
            + x[jnp.array([3, 0, 7, 7, 1, 2, 6, 5])] + x[::-1]
            + M[jnp.array([0, 2, 4, 6, 1, 3, 5, 7]),
                jnp.array([1, 1, 0, 0, 2, 2, 3, 3])])


def _j_multi_output(env, x, u):
    M = x.reshape(2, 4)
    return (jnp.concatenate([M.max(-1), M.min(0), x[:2]])
            + jnp.concatenate([x[3:], u]) + jnp.tile(x[:4], 2) * x[4:].sum()
            + jnp.tile(M[1], 2))


def _j_linalg(env, x, u):
    a, b = jnp.tanh(x[:4]), jnp.tanh(x[4:])
    eye = jnp.eye(4, dtype=x.dtype)
    G = 3.0 * eye + 0.3 * a[:, None] * b[None, :] + 0.1 * u[0] * env.W[:4, :4]
    V = env.W[4:, :4]
    S = 3.0 * eye + 0.3 * a[:, None] * a[None, :] \
        + 0.1 * jax.nn.sigmoid(u[1]) * (V @ V.T)
    rhs = jnp.stack([x[:4], x[4:]], -1)
    L = jnp.linalg.cholesky(S)
    U = L.T
    sign, logabs = jnp.linalg.slogdet(G)
    head = (jnp.linalg.solve(G, rhs).sum(-1) + jnp.linalg.inv(S) @ x[:4]
            + jsl.cho_solve((L, True), rhs)[:, 0]
            + jsl.cho_solve((U, False), rhs)[:, 1]
            + 0.1 * (L @ x[4:]) + 0.1 * (U @ x[:4]))
    tail = (jsl.lu_solve(jsl.lu_factor(G), rhs)[:, 1]
            + jsl.solve_triangular(jnp.tril(G), rhs, lower=True)[:, 0]
            + jsl.solve_triangular(G, rhs, lower=False,
                                   unit_diagonal=True)[:, 1]
            + jsl.solve_triangular(G, x[4:], trans="T", lower=False)
            + 0.1 * jnp.triu(G, 1).sum(0))
    scalars = 0.01 * (jnp.linalg.det(G) - 81.0) + 0.1 * logabs + 0.1 * sign
    return jnp.concatenate([head, tail]) + scalars


def _j_sorts(env, x, u):
    M = x.reshape(2, 4)
    sx, sm = jnp.sort(x), jnp.sort(M, axis=-1)
    top = jnp.concatenate([jax.lax.top_k(x, 3)[0],
                           jax.lax.top_k(M, 2)[0].reshape(-1), sx[2:3]])
    lows = jnp.tile(sm[:, 1] + sm[:, 1], 4)   # kthvalue 2, lower median
    return (sx + jnp.sort(x * u[0])[::-1]
            + jnp.sort(M, axis=0)[::-1].reshape(-1) + top + lows
            + 2.0 * sx[3])


def _j_integers(env, x, u):
    """``torch_user_envs.integers``' twin: JAX's ``x[i]`` wraps a negative
    index and clamps one out of range, as the functor does."""
    W, t = env.W, jnp.tanh(x)
    knots = 2.4 * jnp.cumsum(env.c) / env.c.sum() - 1.2
    kb = jnp.searchsorted(knots, x)
    kr = jnp.searchsorted(knots, x, side="right").astype(jnp.int32)
    ks = jnp.searchsorted(knots, x, side="right")
    kl = kb.astype(jnp.int32)
    a = jnp.floor(2.5 * x).astype(jnp.int64)
    b = (3.0 * x).astype(jnp.int32)
    arith = (jnp.floor_divide(a, 3) + jnp.floor_divide(a, -2)
             + jax.lax.div(b, jnp.int32(2)) + jnp.remainder(a, 3)
             + jnp.remainder(a, -3) + jnp.fmod(b, 3) - 2 * a + jnp.abs(-b)
             + jnp.clip(a, -2, 2) * jnp.minimum(kb, ks) + jnp.maximum(kr, kl)
             + jnp.where(a > b, a, b) + (kb == kl) + (a - kr) // 2)
    fdiv = jnp.trunc(x / -0.9) + jnp.floor_divide(x, 0.6)
    v = jnp.concatenate([x[:2], x[:2], jnp.where(x[5:6] > 0, jnp.nan, x[5:6]),
                         t[6:]])
    finite = jnp.concatenate([x[:2], x[:2], x[5:6], t[6:]])
    M = x.reshape(2, 4)
    hi, lo = jnp.argmax(M, -1), jnp.argmin(M, 0)
    med = jnp.argsort(M, -1, stable=True)[:, 1]      # the lower median's
    order = jnp.argsort(x, stable=True)
    picks = jnp.stack([
        finite[jnp.argmax(v)], finite[jnp.argmin(v)], M[0, hi[0]],
        M[1, hi[1]], M[lo[0], 0], M[lo[1], 1], x[jnp.argmax(M.reshape(-1))],
        x[order[3]]])
    rows = (W[jnp.minimum(kb, 7), jnp.arange(8)] + W[:, a % 8].sum(0)
            + (jax.nn.one_hot(jnp.minimum(kl, 7), 8, dtype=x.dtype)
               * W[0]).sum(-1))
    near = order[:3]
    rank = (x[jnp.argsort(x * u[0], stable=True)]
            + W[1][jnp.concatenate([near, near, near[:2]])]
            + M[0, med[0]] + M[1, med[1]])
    q = jnp.floor(6.0 * x[0]).astype(jnp.int64)
    odd = jnp.stack([W[2][q], x[-1 - q], x[(a % 8)[0]],
                     (kb - kr).astype(x.dtype).sum()])
    return 0.1 * t + tue.JUMP * (picks + arith.astype(x.dtype) + fdiv + rows
                                 + rank + jnp.concatenate([odd, odd]))


_J_FAMILIES = {"elementwise": _j_elementwise, "reductions": _j_reductions,
               "index_maps": _j_index_maps, "multi_output": _j_multi_output,
               "linalg": _j_linalg, "sorts": _j_sorts,
               "integers": _j_integers}


def _jax_op_env(families):
    @pytree_dataclass
    class JaxOpEnv(JaxEnv):
        W: jnp.ndarray
        c: jnp.ndarray

        @property
        def state_size(self):
            return 8

        @property
        def action_size(self):
            return 3

        def _y(self, x, u):
            return sum(_J_FAMILIES[f](self, x, u) for f in families)

        def transition(self, x, u):
            y = self._y(x, u)
            return x + 0.05 * y / (1.0 + jnp.abs(y))

        def cost(self, x, u):
            return x @ x + 0.1 * (u @ u)

        def final_cost(self, x):
            return 2.0 * (x @ x)

    return JaxOpEnv


@pytree_dataclass
class JaxProbeEnv(JaxEnv):
    """``torch_user_envs.ProbeEnv``'s twin."""

    W: jnp.ndarray
    w: jnp.ndarray
    g: jnp.ndarray

    @property
    def state_size(self):
        return self.W.shape[0]

    @property
    def action_size(self):
        return self.W.shape[1]

    def transition(self, x, u):
        p = jnp.pad(x[:-1], (1, 0), constant_values=0.5)
        y = jnp.einsum("ij,j->i", self.W, u) \
            - 0.3 * jnp.arctan2(x, 1.0 + p * p) \
            + 0.2 * (jax.nn.softmax(x) - jnp.cumsum(x) / x.shape[-1])
        return x + 0.1 * y + 0.01 * jnp.floor(self.w) * jnp.sign(x) * x * x

    def _distance(self, x):
        return jnp.linalg.norm(jnp.pad(x - self.g, (0, 1),
                                       constant_values=1.0))

    def cost(self, x, u):
        return (self._distance(x) ** 2 + 0.1 * (u @ u)
                + 0.05 * _j_softplus(x, 2.0).sum() + 0.01 * jsp.erf(x).sum())

    def final_cost(self, x):
        return 5.0 * self._distance(x) ** 2


@pytree_dataclass
class JaxBicycle(JaxEnv):
    """``torch_user_envs.KinematicBicycle``'s twin at its default
    weights."""

    goal: jnp.ndarray
    obstacles: jnp.ndarray
    radii: jnp.ndarray
    R: jnp.ndarray

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 2

    def transition(self, x, u):
        step = 0.1 * x[3]
        return jnp.stack([
            x[0] + step * jnp.cos(x[2]), x[1] + step * jnp.sin(x[2]),
            x[2] + step / 2.7 * jnp.tan(0.5 * jnp.tanh(u[1])),
            x[3] + 0.1 * u[0]])

    def _to_goal(self, x):
        return jnp.hypot(self.goal[0] - x[0], self.goal[1] - x[1])

    def cost(self, x, u):
        e = jnp.arctan2(self.goal[1] - x[1], self.goal[0] - x[0]) - x[2]
        e = jnp.arctan2(jnp.sin(e), jnp.cos(e))
        # x[:2]: a constant index array would be a constant the Pallas
        # kernel captures, which it refuses
        gap = self.radii - jnp.linalg.norm(x[:2][None] - self.obstacles,
                                           axis=-1)
        return (0.02 * self._to_goal(x) + 0.02 * e * e
                + 0.05 * _j_softplus(gap).sum() + u @ self.R @ u
                + 0.01 * (x[3] - 4.0) ** 2)

    def final_cost(self, x):
        return 0.5 * self._to_goal(x) + x[3] ** 2


@pytree_dataclass
class JaxArm(JaxEnv):
    """``torch_user_envs.TwoLinkArm``'s twin at its default weights."""

    target: jnp.ndarray
    obstacles: jnp.ndarray
    R: jnp.ndarray

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 2

    def transition(self, x, u):
        q, dq = x[:2], x[2:]
        c2 = jnp.cos(q[1])
        m11 = 0.5 * 0.5 + (1.0 + 0.5 * 0.5 + 2.0 * 0.5 * c2) + 2.0 / 12.0
        m12 = (0.5 * 0.5 + 0.5 * c2) + 1.0 / 12.0
        m22 = 0.5 * 0.5 + 1.0 / 12.0 + 0.0 * c2
        M = jnp.stack([jnp.stack([m11, m12]), jnp.stack([m12, m22])])
        h = 0.5 * jnp.sin(q[1])
        coriolis = jnp.stack([-h * (2.0 * dq[0] * dq[1] + dq[1] * dq[1]),
                              h * dq[0] * dq[0]])
        g2 = 0.5 * 9.81 * jnp.cos(q[0] + q[1])
        g1 = 1.5 * 9.81 * jnp.cos(q[0]) + g2
        ddq = jnp.linalg.solve(M, u - coriolis - jnp.stack([g1, g2])
                               - 0.1 * dq)
        dq = dq + 0.02 * ddq
        return jnp.concatenate([q + 0.02 * dq, dq])

    def _tip(self, x):
        a, b = x[0], x[0] + x[1]
        return jnp.stack([jnp.cos(a) + jnp.cos(b), jnp.sin(a) + jnp.sin(b)])

    def cost(self, x, u):
        p = self._tip(x)
        e, dq = p - self.target, x[2:]
        d = jnp.linalg.norm(p[None] - self.obstacles, axis=-1)
        near = jnp.sort(d)[:2]
        return (0.1 * (e @ e) + 1e-2 * (dq @ dq) + u @ self.R @ u
                + 0.5 * _j_softplus(4.0 * (0.25 - near)).sum())

    def final_cost(self, x):
        e, dq = self._tip(x) - self.target, x[2:]
        return 10.0 * (e @ e) + dq @ dq


@pytree_dataclass
class JaxCascade(JaxEnv):
    """``torch_user_envs.HydroCascade``'s twin at its default weights."""

    s_knots: jnp.ndarray
    area: jnp.ndarray
    forebay: jnp.ndarray
    q_knots: jnp.ndarray
    tailwater: jnp.ndarray
    inflow: jnp.ndarray
    s_max: jnp.ndarray
    target: jnp.ndarray
    bounds: Optional[test_fuzz_envs.Bounds] = None

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 4

    @staticmethod
    def _interp(knots, values, i, v):
        k = jnp.searchsorted(knots[i, 1:-1], v)
        s0, s1 = knots[i, k], knots[i, k + 1]
        a0, a1 = values[i, k], values[i, k + 1]
        return a0 + (a1 - a0) * (v - s0) / (s1 - s0)

    def transition(self, x, u):
        out = []
        for i in range(4):
            up = u[i - 1] if i else 0.0
            area = self._interp(self.s_knots, self.area, i, x[i])
            out.append(x[i] + 1.0 * (self.inflow[i] + up - u[i]
                                     - 0.01 * area))
        return jnp.stack(out)

    def cost(self, x, u):
        revenue = 0.0
        for i in range(4):
            head = self._interp(self.s_knots, self.forebay, i, x[i]) \
                - self._interp(self.q_knots, self.tailwater, i, u[i])
            revenue = revenue + u[i] * head
        d = x - self.target
        spill = _j_softplus(20.0 * (x - self.s_max)).sum() / 20.0
        return -0.5 * 0.9 * revenue + 0.5 * (d @ d) + 2.0 * spill

    def final_cost(self, x):
        d = x - self.target
        return 5.0 * (d @ d)


def _twins(jax_cls, torch_cls, arrays, bounds=None, **fields):
    """A JAX env and its port twin on the same float64 arrays (and box)."""
    jenv = jax_cls(**{k: jnp.asarray(np.asarray(v, np.float64))
                      for k, v in arrays.items()})
    if bounds is not None:
        jenv = dataclasses.replace(jenv, bounds=test_fuzz_envs.Bounds(
            low=jnp.asarray(bounds[0]), high=jnp.asarray(bounds[1])))
    tenv = interop.user_env_from_numpy(torch_cls, arrays, bounds,
                                       dtype=torch.float64, device="cpu")
    return jenv, dataclasses.replace(tenv, **fields)


def _op_env(*families):
    families = families or tue.OPCOV_FAMILIES
    return _twins(_jax_op_env(families), tue.OpEnv, tue.op_arrays(),
                  families=families)


def _cascade():
    return _twins(JaxCascade, tue.HydroCascade, *tue.cascade_arrays())



def _probe():
    return _twins(JaxProbeEnv, tue.ProbeEnv, tue.probe_arrays())


def _bicycle():
    return _twins(JaxBicycle, tue.KinematicBicycle, tue.BICYCLE)


def _arm():
    return _twins(JaxArm, tue.TwoLinkArm, tue.ARM)


# label -> (a maker of (JAX env, port env), the inputs' range)
CASES = {
    "damped_chain": (lambda: _chain(6), (-2.0, 2.0)),
    "fuzz_3x2": (lambda: _fuzz_envs(11, 3, 2), (-1.5, 1.5)),
    "fuzz_5x5": (lambda: _fuzz_envs(22, 5, 5, True), (-1.5, 1.5)),
    "fuzz_8x3": (lambda: _fuzz_envs(88, 8, 3), (-1.5, 1.5)),
    "navigation_two_zones": (lambda: _registry("navigation"), (-2.0, 9.0)),
    "hvac6": (lambda: _registry("hvac"), (15.0, 28.0)),
    "reservoir5": (lambda: _registry("reservoir"), (0.0, 100.0)),
    "linear24x6": (lambda: _registry("linear"), (-1.0, 1.0)),
    **{f"ops_{f}": (lambda f=f: _op_env(f), (-1.5, 1.5))
       for f in tue.FAMILIES},
    "ops_coverage": (_op_env, (-1.5, 1.5)),
    "probe": (_probe, (-1.5, 1.5)),
    "bicycle": (_bicycle, (-5.0, 5.0)),
    "arm": (_arm, (-1.5, 1.5)),
    "cascade": (_cascade, (0.0, 1.3)),
}


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a generated functor for the host (g++) and load it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the host build of the generated functor "
                    "cannot run")
    out = tmp_path_factory.mktemp("functors")
    built = {}

    def build(source):
        if source not in built:
            k = len(built)
            cpp, so = out / f"step{k}.cpp", out / f"step{k}.so"
            cpp.write_text(env_codegen.host_source(source))
            subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", "-O1",
                            "-ffp-contract=off", "-o", str(so), str(cpp)],
                           check=True, capture_output=True, text=True)
            lib = ctypes.CDLL(str(so))
            lib.user_step_eval.argtypes = [ctypes.c_void_p, ctypes.c_int] \
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] \
                + [ctypes.c_void_p] * 3
            lib.user_step_eval.restype = ctypes.c_int
            built[source] = lib
        return built[source]

    return build


def _host_step(lib, step, x, u):
    """The host functor on ``x [B, n]``, ``u [B, m]``: (x_next, cost,
    final cost)."""
    params = [p.to(torch.float64).contiguous() for p in step.params]
    ptrs = (ctypes.c_void_p * max(len(params), 1))(
        *[p.data_ptr() for p in params])
    xn = torch.empty_like(x)
    cost = torch.empty(x.shape[0], dtype=x.dtype)
    final = torch.empty(x.shape[0], dtype=x.dtype)
    rc = lib.user_step_eval(ptrs, len(params), x.data_ptr(), u.data_ptr(),
                            x.shape[0], xn.data_ptr(), cost.data_ptr(),
                            final.data_ptr())
    assert rc == 0
    return xn, cost, final


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("label", list(CASES))
def test_generated_functor_matches_torch_and_jax_steps(label, host_build):
    build, lohi = CASES[label]
    jenv, tenv = build()
    n, m = tenv.state_size, tenv.action_size
    rng = np.random.default_rng(list(CASES).index(label))
    x = torch.as_tensor(rng.uniform(*lohi, (B, n)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, m)))
    step = tenv.generic_device_step(torch.float64, "cpu")
    assert step.env_id == USER_STEP_ID and step.int_params == ()
    xn, cost, final = _host_step(host_build(step.source), step, x, u)

    _close(xn, tenv.transition(x, u), "x_next vs torch")
    _close(cost, tenv.cost(x, u), "cost vs torch")
    _close(final, tenv.final_cost(x), "final vs torch")

    _, step_fn, final_fn = jenv.generic_lane_functions()
    jx, ju = jnp.asarray(x.numpy().T), jnp.asarray(u.numpy().T)
    jxn, jcost = step_fn(jenv, jx, ju)
    _close(xn.numpy().T, jxn, "x_next vs JAX")
    _close(cost, jcost, "cost vs JAX")
    _close(final, final_fn(jenv, jx), "final vs JAX")


def test_prep_holds_what_every_row_reads_whole():
    """Navigation's lambda(x), a product over the zones that every row
    multiplies its control by, is computed once in ``prep``; the rows read
    it and compute only their own element. The chain's rows restrict the
    coupling product to one dot product each, and hold nothing in prep."""
    _, nav = _registry("navigation")
    src = nav.generic_device_step(torch.float64, "cpu").source
    assert "double h0[1];" in src and "pre.h0[0]" in src
    row = src[src.index("S row("):src.index("S stage_cost(")]
    assert "exp(" not in row and "for (" not in row
    _, chain = _chain(6)
    src = chain.generic_device_step(torch.float64, "cpu").source
    row = src[src.index("S row("):src.index("S stage_cost(")]
    assert "struct Pre {\n\n  };" in src
    assert row.count("for (") == 1 and "< 6;" in row


def test_supported_ops_match_the_torch_step(host_build):
    n = 5
    rng = np.random.default_rng(5)
    env = OpsEnv(W=torch.as_tensor(rng.standard_normal((n, n))),
                 c=torch.as_tensor(rng.uniform(-0.5, 0.5, n)),
                 k=torch.tensor(0.7, dtype=torch.float64))
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, n)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n)))
    step = env.generic_device_step(torch.float64, "cpu")
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    per = lambda f, *a: torch.stack([f(*(v[b] for v in a))  # noqa: E731
                                     for b in range(B)])
    _close(xn, per(env.transition, x, u), "x_next")
    _close(cost, per(env.cost, x, u), "cost")
    _close(final, per(env.final_cost, x), "final")


@dataclasses.dataclass(frozen=True, eq=False)
class TrapEnv(Env):
    """Ops whose C or JAX counterpart differs from torch at some inputs:
    the next state holds those where JAX agrees with torch, the stage cost
    ``sign`` and ``heaviside``, which are 0 at NaN in torch (NaN in
    JAX)."""

    c: torch.Tensor   # [8]

    @property
    def state_size(self):
        return 8

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        v = x.unbind(-1)
        return torch.stack([
            torch.round(v[0]), torch.remainder(v[1], 0.7),
            torch.fmod(v[2], 0.7), torch.nan_to_num(v[3]),
            torch.nan_to_num(v[4], nan=1.5, posinf=2.0, neginf=-3.0),
            F.hardtanh(v[5]), F.softplus(v[6], beta=2.0, threshold=1.0),
            torch.remainder(v[7], -0.7)], dim=-1)

    def cost(self, x, u):
        return (torch.sign(x) + torch.heaviside(x, self.c)).sum(-1)

    def final_cost(self, x):
        return (torch.round(x, decimals=1)
                + torch.round(7.0 * x, decimals=-1)).sum(-1)


@pytree_dataclass
class JaxTrapEnv(JaxEnv):
    c: jnp.ndarray

    @property
    def state_size(self):
        return 8

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        return jnp.stack([
            jnp.round(x[0]), jnp.remainder(x[1], 0.7), jnp.fmod(x[2], 0.7),
            jnp.nan_to_num(x[3]),
            jnp.nan_to_num(x[4], nan=1.5, posinf=2.0, neginf=-3.0),
            jnp.clip(x[5], -1.0, 1.0), _j_softplus(x[6], 2.0, 1.0),
            jnp.remainder(x[7], -0.7)])

    def cost(self, x, u):
        return (jnp.sign(x) + jnp.heaviside(x, self.c)).sum()

    def final_cost(self, x):
        return (jnp.round(x * 10.0) / 10.0
                + jnp.round(7.0 * x / 10.0) * 10.0).sum()


NAN, INF = float("nan"), float("inf")
# half-integers, negative dividends, NaN, +-inf, zeros of either sign and
# the softplus threshold (beta x = 1) on either side
TRAP_X = [
    [2.5, -1.3, -1.3, NAN, NAN, NAN, 0.5, -1.3],
    [0.5, -0.6, -0.6, INF, INF, INF, 0.5 - 1e-12, 1.3],
    [-0.5, 1.3, 1.3, -INF, -INF, -INF, 0.5 + 1e-12, -0.35],
    [1.5, -0.7, -0.7, 1.0, 1.0, 0.3, -2.0, 0.7],
    [-2.5, 0.0, -0.0, -0.0, 2.0, -5.0, 30.0, -2.1],
    [3.5, -2.45, -2.45, -1e300, NAN, 1.0, 0.25, 0.0],
    [-1.5, 0.35, 0.35, 1e300, -INF, -1.0, -30.0, 1.05],
]


def test_torch_semantics_where_c_or_jax_differ(host_build):
    """round to even, remainder with the divisor's sign, fmod with the
    dividend's, nan_to_num's finfo defaults and options, hardtanh keeping
    NaN, softplus's threshold, round to decimals: the functor against the
    torch step and the JAX twin (NaN where both give NaN); sign and
    heaviside, 0 at NaN in torch, against torch only (against JAX on the
    rows without NaN)."""
    c = np.linspace(0.1, 0.8, 8)
    tenv = TrapEnv(c=torch.as_tensor(c))
    jenv = JaxTrapEnv(c=jnp.asarray(c))
    x = torch.tensor(TRAP_X, dtype=torch.float64)
    u = torch.zeros(x.shape[0], 1, dtype=torch.float64)
    step = tenv.generic_device_step(torch.float64, "cpu")
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    exact = dict(rtol=1e-15, atol=0, equal_nan=True)
    np.testing.assert_allclose(xn, tenv.transition(x, u), **exact)
    np.testing.assert_allclose(cost, tenv.cost(x, u), **exact)
    np.testing.assert_allclose(final, tenv.final_cost(x), rtol=1e-12,
                               equal_nan=True)
    assert torch.equal(xn[:, 0], torch.tensor([2.0, 0.0, -0.0, 2.0, -2.0,
                                               4.0, -2.0],
                                              dtype=torch.float64))
    assert not bool(cost.isnan().any())   # sign, heaviside at NaN: 0
    _, step_fn, final_fn = jenv.generic_lane_functions()
    jx, ju = jnp.asarray(x.numpy().T), jnp.asarray(u.numpy().T)
    jxn, jcost = step_fn(jenv, jx, ju)
    np.testing.assert_allclose(xn.numpy().T, jxn, **exact)
    rows = ~x.isnan().any(-1).numpy()
    np.testing.assert_allclose(cost.numpy()[rows], np.asarray(jcost)[rows],
                               **exact)
    np.testing.assert_allclose(final, final_fn(jenv, jx), rtol=1e-12,
                               equal_nan=True)


@dataclasses.dataclass(frozen=True, eq=False)
class SortTrapEnv(Env):
    """Sorts where NaN, infinities and signed zeros show torch's order:
    the next state the stable ascending sort, the stage cost the NaN that
    ``topk``, ``kthvalue`` and ``median`` take or propagate, the final cost
    the sign bits of the stable descending sort (``copysign``), which a
    tie between 0.0 and -0.0 moves."""

    w: torch.Tensor   # [6]

    @property
    def state_size(self):
        return 6

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        return torch.sort(x, dim=-1, stable=True).values

    def cost(self, x, u):
        return (torch.topk(x, 2).values.sum(-1)
                + torch.topk(x, 2, largest=False).values.sum(-1)
                + torch.kthvalue(x, 2).values + torch.median(x, -1).values)

    def final_cost(self, x):
        d = torch.sort(x, dim=-1, descending=True, stable=True).values
        return (self.w * torch.copysign(torch.ones_like(d), d)).sum(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class SingularEnv(Env):
    """A solve, a determinant and a Cholesky factor of M = x as a 2x2
    matrix, at matrices that are singular or not positive definite."""

    b: torch.Tensor   # [2]

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 1

    def _parts(self, x):
        M = x.reshape(x.shape[:-1] + (2, 2))
        S = 0.5 * (M + M.mT)
        return M, S

    def transition(self, x, u):
        M, S = self._parts(x)
        return torch.cat([torch.linalg.solve(M, self.b),
                          torch.linalg.det(M)[..., None],
                          torch.linalg.cholesky(S)[..., 1, 1:]], -1)

    def cost(self, x, u):
        return (x * x).sum(-1)

    def final_cost(self, x):
        return (x * x).sum(-1)


SORT_X = [
    [0.0, -0.0, 1.0, -0.0, 0.0, -1.0],
    [NAN, 1.0, -2.0, NAN, 0.5, 0.0],
    [3.0, 3.0, -0.0, 0.0, INF, -INF],
    [-0.0, 2.0, 0.0, NAN, -0.0, 2.0],
    [0.25, -1.5, 0.75, 2.5, -0.5, 1.25],
]
# singular (and positive semidefinite), not positive definite, regular,
# zero
SINGULAR_X = [[1.0, 2.0, 2.0, 4.0], [1.0, 3.0, 3.0, 1.0],
              [2.0, 0.5, 0.3, 1.5], [0.0, 0.0, 0.0, 0.0]]


def test_sorts_and_solves_at_nan_ties_and_singular_input(host_build):
    """The sort family on the host build against torch's step bit for bit:
    NaN sorts last ascending and first descending, ``topk``, ``kthvalue``
    and ``median`` take or propagate it as torch does, and a stable sort
    keeps ties (0.0 and -0.0) in their input order, so the sign bits
    agree. Linear algebra at a singular or indefinite matrix: the kernel
    cannot raise, so where torch's step raises (``LinAlgError``) the
    functor gives what the arithmetic gives (a non-finite solve, a
    Cholesky pivot that is NaN or not positive); the determinant is torch's
    at every input (0 where singular); the regular rows equal torch's."""
    w = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0], dtype=torch.float64)
    env = SortTrapEnv(w=w)
    x = torch.tensor(SORT_X, dtype=torch.float64)
    u = torch.zeros(x.shape[0], 1, dtype=torch.float64)
    step = env.generic_device_step(torch.float64, "cpu")
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    want = env.transition(x, u)
    assert torch.equal(xn.isnan(), want.isnan())
    ok = ~want.isnan()
    assert torch.equal(xn[ok], want[ok])
    assert torch.equal(torch.signbit(xn[ok]), torch.signbit(want[ok]))
    np.testing.assert_array_equal(cost.numpy(), env.cost(x, u).numpy())
    assert torch.equal(final, env.final_cost(x))
    assert bool(cost[1].isnan()) and bool(cost[3].isnan())
    assert bool(torch.isfinite(cost[[0, 4]]).all())

    env = SingularEnv(b=torch.tensor([1.0, -1.0], dtype=torch.float64))
    x = torch.tensor(SINGULAR_X, dtype=torch.float64)
    u = torch.zeros(x.shape[0], 1, dtype=torch.float64)
    step = env.generic_device_step(torch.float64, "cpu")
    xn, _, _ = _host_step(host_build(step.source), step, x, u)
    raised = []
    for r in range(x.shape[0]):
        M, S = env._parts(x[r])
        assert torch.equal(xn[r, 2], torch.linalg.det(M)), r
        try:
            want = torch.linalg.solve(M, env.b)
        except torch.linalg.LinAlgError:
            raised.append((r, "solve"))
            assert not bool(torch.isfinite(xn[r, :2]).all()), r
        else:
            _close(xn[r, :2], want, f"solve row {r}")
        try:
            want = torch.linalg.cholesky(S)[1, 1]
        except torch.linalg.LinAlgError:
            raised.append((r, "cholesky"))
            assert not bool(xn[r, 3] > 0), r
        else:
            _close(xn[r, 3], want, f"cholesky row {r}")
    assert raised == [(0, "solve"), (0, "cholesky"), (1, "cholesky"),
                      (3, "solve"), (3, "cholesky")]


# -- integer values and indices computed at run time -------------------------

# the integer patterns a user's step reads (each a vector [..., 4] of x [...,
# 4], u [..., 2] and the parameters vals [8], knots [7], W [4, 8]): a table
# read at a 0-d ``bucketize`` index and a weight at a 0-d ``argmin`` (both
# refused at trace time before: torch's indexing called ``.item()``), a
# kept-dim ``bucketize`` index, ``searchsorted``, ``floor().long()`` as an
# index, ``argmin(keepdim=True)`` into ``gather``, ``argsort`` into
# ``gather`` and ``take_along_dim``, ``one_hot`` of ``bucketize``,
# ``x.long() % 3`` read as a value, and a float floor division; each
# beside its JAX twin over one scenario
PATTERNS = {
    "bucketize_0d": (
        lambda e, x, u: e.vals[torch.bucketize(x[..., 0], e.knots)][
            ..., None] * x,
        lambda e, x, u: e.vals[jnp.searchsorted(e.knots, x[0])] * x),
    "argmin_0d": (
        lambda e, x, u: e.vals[((x[..., :, None] - e.W[:, :4]) ** 2).sum(
            -1).argmin(-1)][..., None] + x,
        lambda e, x, u: e.vals[((x[:, None] - e.W[:, :4]) ** 2).sum(
            -1).argmin()] + x),
    "bucketize_kept_dim": (
        lambda e, x, u: e.vals[torch.bucketize(x[..., :1], e.knots)] * x,
        lambda e, x, u: e.vals[jnp.searchsorted(e.knots, x[:1])] * x),
    "searchsorted": (
        lambda e, x, u: e.vals[torch.searchsorted(e.knots, x.contiguous(),
                                                  right=True)],
        lambda e, x, u: e.vals[jnp.searchsorted(e.knots, x, side="right")]),
    "floor_long_index": (
        lambda e, x, u: e.vals[((x + 1.9) * 2.0).floor().long()],
        lambda e, x, u: e.vals[jnp.floor((x + 1.9) * 2.0).astype(int)]),
    "argmin_gather": (
        lambda e, x, u: torch.gather(x, -1, (x * u.sum(-1, keepdim=True))
                                     .argmin(-1, keepdim=True)) * x,
        lambda e, x, u: x[jnp.argmin(x * u.sum())] * x),
    "argsort_gather": (
        lambda e, x, u: torch.gather(x, -1, torch.argsort(x * u[..., :1],
                                                          dim=-1))
        + torch.take_along_dim(e.W[:, 0].expand_as(x), torch.argsort(x),
                               dim=-1),
        lambda e, x, u: x[jnp.argsort(x * u[0], stable=True)]
        + e.W[:, 0][jnp.argsort(x, stable=True)]),
    "one_hot": (
        lambda e, x, u: F.one_hot(torch.bucketize(x, e.knots), 8).to(x.dtype)
        @ e.vals,
        lambda e, x, u: jax.nn.one_hot(jnp.searchsorted(e.knots, x), 8,
                                       dtype=x.dtype) @ e.vals),
    "long_remainder": (
        lambda e, x, u: ((3.0 * x).long() % 3).to(x.dtype) + x,
        lambda e, x, u: ((3.0 * x).astype(int) % 3).astype(x.dtype) + x),
    # a float floor division (torch's autograd has no derivative for it)
    "float_floor_divide": (
        lambda e, x, u: x // 0.7 + torch.floor_divide(x, -0.45) * u[..., :1],
        lambda e, x, u: x // 0.7 + jnp.floor_divide(x, -0.45) * u[0]),
}


@dataclasses.dataclass(frozen=True, eq=False)
class PatternEnv(Env):
    """x' = x + 0.1 y + 0.05 [u, u], y a ``PATTERNS`` vector; cost |x|^2
    + |y|^2, final cost |x|^2."""

    vals: torch.Tensor    # [8]
    knots: torch.Tensor   # [7]
    W: torch.Tensor       # [4, 8]
    pattern: str = "bucketize_0d"

    @property
    def state_size(self):
        return 4

    @property
    def action_size(self):
        return 2

    def _y(self, x, u):
        return PATTERNS[self.pattern][0](self, x, u)

    def transition(self, x, u):
        return x + 0.1 * self._y(x, u) + 0.05 * torch.cat([u, u], -1)

    def cost(self, x, u):
        y = self._y(x, u)
        return (x * x).sum(-1) + (y * y).sum(-1)

    def final_cost(self, x):
        return (x * x).sum(-1)


def _jax_pattern_env(pattern):
    @pytree_dataclass
    class JaxPatternEnv(JaxEnv):
        vals: jnp.ndarray
        knots: jnp.ndarray
        W: jnp.ndarray

        @property
        def state_size(self):
            return 4

        @property
        def action_size(self):
            return 2

        def _y(self, x, u):
            return PATTERNS[pattern][1](self, x, u)

        def transition(self, x, u):
            return x + 0.1 * self._y(x, u) + 0.05 * jnp.concatenate([u, u])

        def cost(self, x, u):
            y = self._y(x, u)
            return x @ x + y @ y

        def final_cost(self, x):
            return x @ x

    return JaxPatternEnv


def _pattern_twins(pattern):
    rng = np.random.default_rng(21)
    arrays = dict(vals=rng.standard_normal(8),
                  knots=np.linspace(-1.2, 1.2, 7),
                  W=rng.standard_normal((4, 8)))
    return _twins(_jax_pattern_env(pattern), PatternEnv, arrays,
                  pattern=pattern)


def _against_torch_and_jax(jenv, tenv, x, u, host_build, tol=TOL):
    """The host build of ``tenv``'s generated step against the torch step
    and the JAX twin's ``generic_lane_functions`` step at x, u."""
    step = tenv.generic_device_step(torch.float64, "cpu")
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    _close(xn, tenv.transition(x, u), "x_next vs torch")
    _close(cost, tenv.cost(x, u), "cost vs torch")
    _close(final, tenv.final_cost(x), "final vs torch")
    _, step_fn, final_fn = jenv.generic_lane_functions()
    jx, ju = jnp.asarray(x.numpy().T), jnp.asarray(u.numpy().T)
    jxn, jcost = step_fn(jenv, jx, ju)
    _close(xn.numpy().T, jxn, "x_next vs JAX")
    _close(cost, jcost, "cost vs JAX")
    _close(final, final_fn(jenv, jx), "final vs JAX")
    return step


@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_integer_patterns_yield_a_generated_step(pattern, host_build):
    """Each pattern the generator refused (two at trace time, seven as
    integer values, and a float floor division) gives a generated step
    equal to the torch step and the JAX step, at inputs that put x on
    either side of every knot."""
    jenv, tenv = _pattern_twins(pattern)
    rng = np.random.default_rng(list(PATTERNS).index(pattern))
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, 4)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, 2)))
    step = _against_torch_and_jax(jenv, tenv, x, u, host_build)
    assert ("int64_t" in step.source) == (pattern != "float_floor_divide")


def test_scalar_index_mode_matches_eager_indexing():
    """``ScalarIndexMode`` reads at 0-d integer tensors as torch's indexing
    reads at the ints they hold (negative ones included), bit for bit, and
    lets a trace take them: ``T[r, i]``, ``T[i, 1:]``, ``T[..., i]``,
    ``T[i, j]``, ``T[:, None, i]``, a slice read at ``j``, and ``v[i]``."""
    T3 = torch.as_tensor(np.random.default_rng(4).standard_normal((4, 6, 5)))
    v = T3[0, 0]

    def f(i, j):
        return torch.cat([T3[2, i].reshape(-1), T3[i, 1:].reshape(-1),
                          T3[..., i].reshape(-1), T3[i, j].reshape(-1),
                          T3[:, None, i].reshape(-1), v[1:][j].reshape(-1),
                          v[i].reshape(-1)])

    for i, j in ((1, 2), (-1, -3), (3, 0)):
        ti, tj = torch.tensor(i), torch.tensor(j)
        want = f(ti, tj)
        with env_codegen.ScalarIndexMode():
            got = f(ti, tj)
        assert torch.equal(got, want), (i, j)
    gm = make_fx(lambda i: f(i, torch.tensor(2)), tracing_mode="fake",
                 _allow_non_fake_inputs=True)
    with pytest.raises(RuntimeError, match="data-dependent"):
        gm(torch.tensor(1))
    with env_codegen.ScalarIndexMode():
        traced_f = make_fx(lambda i: f(i, torch.tensor(2)),
                           tracing_mode="fake",
                           _allow_non_fake_inputs=True)(torch.tensor(1))
    assert any(nd.target is torch.ops.aten.index.Tensor
               for nd in traced_f.graph.nodes)


@pytree_dataclass
class SortIndicesTwin(test_fuzz_envs.RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * jnp.argsort(x, stable=True).astype(x.dtype)


@pytree_dataclass
class ArgmaxTwin(test_fuzz_envs.RandomSmoothEnv):
    def transition(self, x, u):
        return x + 0.1 * jnp.argmax(x).astype(x.dtype)


@pytest.mark.parametrize("cls,jcls", [
    (SortIndicesAsValues, SortIndicesTwin),
    (IntegerArithmetic, ArgmaxTwin),
    (MaxIndexAsValue, ArgmaxTwin),
], ids=["SortIndicesAsValues", "IntegerArithmetic", "MaxIndexAsValue"])
def test_former_integer_refusals_match_torch_and_jax(cls, jcls, host_build):
    """The steps ``test_refusals_name_the_cause_and_the_opt_outs`` refused
    as integer values (a sort's indices, ``argmax`` and max's indices read
    as values) now generate a step equal to torch's and JAX's."""
    jenv, tenv = _fuzz_envs(11, 3, 3)
    env = cls(**{f.name: getattr(tenv, f.name)
                 for f in dataclasses.fields(tenv)})
    jenv = jcls(**{f.name: getattr(jenv, f.name)
                   for f in dataclasses.fields(jenv)})
    rng = np.random.default_rng(31)
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, 3)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, 3)))
    _against_torch_and_jax(jenv, env, x, u, host_build)


@dataclasses.dataclass(frozen=True, eq=False)
class IntTrapEnv(Env):
    """Integer ops at the inputs where their edges show: x_0 an index of
    ``v`` (negative, out of range on either side), x_1 against the knots
    (exactly at one, with and without ``right``), argmax/argmin of (x_2,
    x_3, x_2, x_3) (a tie; NaN), floor division and remainders of x_4 as an
    integer (negative), x_5 to int64 and int32 (negative, NaN, +-inf, past
    int32)."""

    v: torch.Tensor       # [6]
    knots: torch.Tensor   # [5]

    @property
    def state_size(self):
        return 8

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        e = x.unbind(-1)
        w = torch.stack([e[2], e[3], e[2], e[3]], -1)
        k = e[4].long()
        return torch.stack([
            self.v[e[0].long()],
            torch.bucketize(e[1], self.knots).to(x.dtype),
            torch.bucketize(e[1], self.knots, right=True).to(x.dtype),
            (torch.argmax(w, -1) + 10 * torch.argmin(w, -1)).to(x.dtype),
            (torch.floor_divide(k, -3) + 10 * torch.div(
                k, 4, rounding_mode="floor")).to(x.dtype),
            (torch.remainder(k, 3) + 10 * torch.remainder(k, -4)
             + 100 * torch.fmod(k, 3)).to(x.dtype),
            e[5].long().to(x.dtype), e[5].int().to(x.dtype)], -1)

    def cost(self, x, u):
        return (x * x).sum(-1)

    def final_cost(self, x):
        return (x * x).sum(-1)


@pytree_dataclass
class JaxIntTrapEnv(JaxEnv):
    v: jnp.ndarray
    knots: jnp.ndarray

    @property
    def state_size(self):
        return 8

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        w = jnp.stack([x[2], x[3], x[2], x[3]])
        k = x[4].astype(jnp.int64)
        return jnp.stack([
            self.v[x[0].astype(jnp.int64)],
            jnp.searchsorted(self.knots, x[1]).astype(x.dtype),
            jnp.searchsorted(self.knots, x[1], side="right").astype(x.dtype),
            (jnp.argmax(w) + 10 * jnp.argmin(w)).astype(x.dtype),
            (jnp.floor_divide(k, -3) + 10 * jnp.floor_divide(k, 4))
            .astype(x.dtype),
            (jnp.remainder(k, 3) + 10 * jnp.remainder(k, -4)
             + 100 * jnp.fmod(k, 3)).astype(x.dtype),
            x[5].astype(jnp.int64).astype(x.dtype),
            x[5].astype(jnp.int32).astype(x.dtype)])

    def cost(self, x, u):
        return x @ x

    def final_cost(self, x):
        return x @ x


# x_0: in range, negative, out of range above and below, truncated toward
# 0; x_1: at a knot, between, past both ends, NaN; x_2, x_3: a tie, NaN;
# x_4: negative dividends; x_5: negative, NaN, +-inf, past int32
INT_X = [
    [2.0, 0.5, 1.0, 1.0, -7.0, -2.7, 0, 0],
    [-1.0, -0.5, 0.5, 2.0, 7.0, 2.7, 0, 0],
    [7.0, 1.0, NAN, 1.0, -6.0, NAN, 0, 0],
    [-9.0, 0.2, 1.0, NAN, -1.0, INF, 0, 0],
    [9.0, -3.0, 2.0, 2.0, 0.0, -INF, 0, 0],
    [0.7, 3.0, -1.0, -1.0, -8.9, 3e9, 0, 0],
    [-0.7, NAN, 0.0, -0.0, 5.5, -3e9, 0, 0],
]
INT_KNOTS = [-1.0, -0.5, 0.0, 0.5, 1.0]


def test_integer_edges_match_torch_and_jax(host_build):
    """The integer family at its edges, the functor against torch bit for
    bit where torch computes the step (an index out of range raises there;
    a NaN or an infinity cast to an integer gives the type's least value,
    as torch's CPU casts) and against JAX's twin (its ``x[i]`` wraps a
    negative index and clamps one out of range, as the functor does; its
    casts of NaN and infinities differ, so x_5's rows are held against
    torch only)."""
    v = np.arange(6) * 1.5 - 2.0
    tenv = IntTrapEnv(v=torch.as_tensor(v),
                      knots=torch.tensor(INT_KNOTS, dtype=torch.float64))
    jenv = JaxIntTrapEnv(v=jnp.asarray(v), knots=jnp.asarray(INT_KNOTS))
    x = torch.tensor(INT_X, dtype=torch.float64)
    u = torch.zeros(x.shape[0], 1, dtype=torch.float64)
    step = tenv.generic_device_step(torch.float64, "cpu")
    xn, _, _ = _host_step(host_build(step.source), step, x, u)
    inside = (x[:, 0] > -7) & (x[:, 0] < 6)
    for r in range(x.shape[0]):
        row = x[r:r + 1]
        if bool(inside[r]):
            want = tenv.transition(row, u[:1])[0]
        else:   # torch raises; the rest of the row without x_0
            with pytest.raises(IndexError):
                tenv.transition(row, u[:1])
            want = tenv.transition(torch.cat([row[:, :1] * 0, row[:, 1:]],
                                             -1), u[:1])[0]
            want[0] = xn[r, 0]
        assert torch.equal(xn[r], want), (r, xn[r], want)
    assert torch.equal(xn[:, 0], torch.as_tensor(v[[2, 5, 5, 0, 5, 0, 0]]))
    assert xn[2, 6] == xn[3, 6] == xn[4, 6] == -2.0 ** 63
    assert xn[2, 7] == xn[5, 7] == xn[6, 7] == -2.0 ** 31
    _, step_fn, _ = jenv.generic_lane_functions()
    jxn = np.asarray(step_fn(jenv, jnp.asarray(x.numpy().T),
                             jnp.asarray(u.numpy().T))[0]).T
    np.testing.assert_array_equal(xn[:, :6].numpy(), jxn[:, :6])
    finite = torch.isfinite(x[:, 5]) & (x[:, 5].abs() < 2 ** 31)
    np.testing.assert_array_equal(xn[finite, 6:].numpy(), jxn[finite, 6:])


@dataclasses.dataclass(frozen=True, eq=False)
class DecomposedOpsEnv(Env):
    """Ops outside ``SUPPORTED_OPS`` that ``torch._decomp`` decomposes
    into supported ones, beside ``std`` and ``var`` (supported, two
    passes), on one scenario (``torch.dist`` reduces every dim)."""

    W: torch.Tensor   # [n, n]

    @property
    def state_size(self):
        return self.W.shape[0]

    def transition(self, x, u):
        return x + 0.1 * (torch.xlogy(x * x, 1.0 + u * u)
                          + torch.logaddexp(x, u) + torch.lerp(x, u, 0.3)
                          + F.hardswish(x) + F.mish(u)
                          + torch.addcmul(x, x, u, value=0.5)
                          + x.std(-1, keepdim=True))

    def cost(self, x, u):
        return torch.var(x @ self.W, -1) + torch.dist(x, u) \
            + torch.frac(3.0 * x).sum(-1) \
            + (torch.diag(torch.outer(x, u)) * torch.diag(x)[1]).sum(-1)

    def final_cost(self, x):
        return (x * x).sum(-1)


def test_decomposed_ops_match_the_torch_step(host_build):
    """An op outside ``SUPPORTED_OPS`` that ``torch._decomp`` decomposes is
    traced through its decomposition; the source's header names it (and
    not ``std``/``var``, which the functor computes itself), and the
    functor equals the torch step."""
    n = 5
    rng = np.random.default_rng(7)
    env = DecomposedOpsEnv(W=torch.as_tensor(rng.standard_normal((n, n))))
    step = env.generic_device_step(torch.float64, "cpu")
    header = step.source.splitlines()[3]
    for op in ("aten::xlogy", "aten::logaddexp", "aten::lerp",
               "aten::hardswish", "aten::mish", "aten::addcmul", "aten::dist",
               "aten::frac", "aten::diagonal_copy"):
        assert op in header, (op, header)
    assert "aten::std" not in header and "aten::var" not in header
    x = torch.as_tensor(rng.uniform(-1.5, 1.5, (B, n)))
    u = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n)))
    xn, cost, final = _host_step(host_build(step.source), step, x, u)
    per = lambda f, *a: torch.stack([f(*(v[b] for v in a))  # noqa: E731
                                     for b in range(B)])
    _close(xn, per(env.transition, x, u), "x_next")
    _close(cost, per(env.cost, x, u), "cost")
    _close(final, per(env.final_cost, x), "final")


def test_source_depends_on_graph_dims_and_dtype_not_values():
    _, a = _chain(6)
    _, b = _chain(6, coupling_seed=3)
    src = a.generic_device_step(torch.float64, "cpu").source
    assert b.generic_device_step(torch.float64, "cpu").source == src
    assert a.generic_device_step(torch.float64, "cpu") is \
        a.generic_device_step(torch.float64, "cpu")   # traced once
    assert a.generic_device_step(torch.float32, "cpu").source != src
    assert _chain(7)[1].generic_device_step(torch.float64,
                                            "cpu").source != src
    # the default device step is the generated one; its parameters are
    # the env's tensors, read at launch
    step = b.device_step()
    assert step.env_id == USER_STEP_ID
    assert torch.equal(step.params[0], b.coupling)


@pytest.mark.parametrize("cls,what", [
    (LinearSolve, "aten::_linalg_eigh"),
    (BigSolve, "aten::_linalg_solve_ex.*shape \\[9, 9\\]"),
    (RightSolve, "left=False"),
    (RandomStep, "aten::rand"),
    (RandomIndex, "aten::randint.*random ops"),
    (SorterSearch, "aten::searchsorted.*sorter"),
    (NonzeroShape, "data-dependent shape"),
    (Branchy, "data-dependent"),
    (WideCost, "returned shape"),
])
def test_refusals_name_the_cause_and_the_opt_outs(cls, what):
    _, tenv = _fuzz_envs(11, 3, 3)
    env = cls(**{f.name: getattr(tenv, f.name)
                 for f in dataclasses.fields(tenv)})
    with pytest.raises(NotImplementedError, match=what) as info:
        env.device_step()
    assert "use_pallas=False" in str(info.value)
    assert "device_step()" in str(info.value)



def test_a_solve_raises_instead_of_falling_back():
    """``solve_batch(use_pallas=True)`` on an env whose step the generator
    refuses raises, on the CPU as on the card; ``use_pallas=False`` solves
    it on the plain path."""
    _, tenv = _fuzz_envs(11, 3, 3)
    env = LinearSolve(**{f.name: getattr(tenv, f.name)
                         for f in dataclasses.fields(tenv)})
    x0 = torch.zeros(2, 3, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(max_iterations=2, use_pallas=True)
    with pytest.raises(NotImplementedError, match="aten::_linalg_eigh"):
        ilqr.solve_batch(env, x0, horizon=3, config=cfg)
    res = ilqr.solve_batch(env, x0, horizon=3,
                           config=dataclasses.replace(cfg, use_pallas=False))
    assert bool(torch.isfinite(res.total_cost).all())


def test_plan_family_follows_the_serial_work():
    """The launch plan of a generated step (``rollout.plan_family``): the
    chain, whose rows are most of its step, takes ``GENERIC_PLANS``'
    ``"user"`` rows; the (8, 3) fuzz env, whose stage cost's quadratic
    forms (computed whole by one lane) are as much work as its next
    state, the linear env's rows; a hand-written step its own."""
    from tfmpc_tpu_torch.ops import rollout

    cfg = ilqr.ILQRConfig()
    for env, want in ((_chain(6)[1], "user"), (_fuzz_envs(88, 8, 3)[1],
                                               "linear"),
                      (_registry("hvac")[1], None)):
        n, m = env.state_size, env.action_size
        X = torch.zeros(2, 4, n, dtype=torch.float64)
        U = torch.zeros(2, 3, m, dtype=torch.float64)
        policy = ilqr.backward(*ilqr.derivatives(env, X, U),
                               torch.zeros(2, dtype=torch.float64), cfg)[1]
        a = rollout.kernel_layout(env, X, U, policy)
        assert rollout.plan_family(a) == want
        if want is not None:
            serial, row = a["work"]
            assert serial > 0 and row > 0
