"""The port's autodiff linearization of user envs whose steps solve, factor
and sort, against the JAX package's, float64 on the CPU.

A user env without ``analytic_derivatives`` is linearized by autodiff
(``models/base.py``). Each case below is a small env (n = 3, m =
2) whose step goes through one linear-algebra or sort op, and its JAX twin
on the same float64 arrays (carried across by
``interop.user_env_from_numpy``). At the same seeded points (B = 16
scenarios, T = 4 steps) every field of ``ilqr.derivatives`` (f, f_x, f_u,
l, l_x, l_u, l_xx, l_uu, l_ux and the final cost's l, l_x, l_xx) is held
against ``jax.vmap`` of the JAX package's ``ilqr.derivatives``, and the
dynamics Hessians of ``ilqr.second_derivatives`` against the JAX env's
``get_second_order_transition`` (``jax.jacfwd`` of ``jax.jacfwd``), within
1e-12 of the largest value compared.

The matrices are well conditioned: 3 I plus small terms in tanh of the
state and in the controls (symmetric positive definite where the op
factors by Cholesky). The ops: ``linalg.solve`` (vector and matrix
right-hand side), ``det``, ``slogdet``, ``lu_factor`` + ``lu_solve``,
``inv``, ``cholesky``, ``cholesky_solve``, ``solve_triangular``, ``sort``
and ``topk`` values. Each goes into the next state, the stage cost (so
that the cost's Hessians differentiate through it) and the final cost.
"""

import contextlib
import dataclasses
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from tfmpc_tpu import Env as JaxEnv
from tfmpc_tpu.core.types import pytree_dataclass
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch import Bounds, Env, interop
from tfmpc_tpu_torch.models import base
from tfmpc_tpu_torch.models.registry import load_env
from tfmpc_tpu_torch.solvers import ilqr

import torch_user_envs as tue
from test_torch_env_codegen import _cascade, _op_env

ROOT = Path(__file__).resolve().parents[1]

N, M = 3, 2
B, T = 16, 4
TOL = 1e-12


def _matrix(t, u0, A, lib):
    """3 I + 0.3 tanh(x) tanh(x)^T + 0.2 sin(u_0) A: a general matrix."""
    outer = t[..., :, None] * t[..., None, :]
    return 3.0 * lib.eye(N) + 0.3 * outer + 0.2 * lib.sin(u0)[..., None,
                                                               None] * A


def _spd(t, u0, A, lib):
    """3 I + 0.3 tanh(x) tanh(x)^T + 0.1 sigmoid(u_0) A A^T: symmetric
    positive definite."""
    outer = t[..., :, None] * t[..., None, :]
    s = 1.0 / (1.0 + lib.exp(-u0))
    return 3.0 * lib.eye(N) + 0.3 * outer + 0.1 * s[..., None, None] * (
        A @ A.T)


def _torch_op(op, env, x, u):
    """The op's vector [..., n] at (x, u)."""
    t = torch.tanh(x)
    v = u @ env.Bm.mT + env.c * x
    if op in ("cholesky", "cholesky_solve"):
        S = _spd(t, u[..., 0], env.A, torch)
        L = torch.linalg.cholesky(S)
        if op == "cholesky":
            return (L @ v[..., None])[..., 0]
        return torch.cholesky_solve(v[..., None], L)[..., 0]
    Mx = _matrix(t, u[..., 0], env.A, torch)
    if op == "solve_vec":
        return torch.linalg.solve(Mx, v)
    if op == "solve_mat":
        rhs = torch.stack([v, torch.sin(x)], dim=-1)
        return torch.linalg.solve(Mx, rhs) @ env.w
    if op == "det":
        return torch.linalg.det(Mx)[..., None] * torch.tanh(v)
    if op == "slogdet":
        return torch.linalg.slogdet(Mx).logabsdet[..., None] * torch.tanh(v)
    if op == "lu":
        LU, piv = torch.linalg.lu_factor(Mx)
        return torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
    if op == "inv":
        return (torch.linalg.inv(Mx) @ v[..., None])[..., 0]
    if op == "solve_triangular":
        return torch.linalg.solve_triangular(torch.tril(Mx), v[..., None],
                                             upper=False)[..., 0]
    if op == "sort":
        return torch.sort(x * v + 0.3 * x, dim=-1).values
    if op == "topk":
        top = torch.topk(x + v, 2, dim=-1).values
        return top.sum(-1, keepdim=True) * t
    raise ValueError(op)


def _jax_op(op, env, x, u):
    t = jnp.tanh(x)
    v = env.Bm @ u + env.c * x
    if op in ("cholesky", "cholesky_solve"):
        L = jnp.linalg.cholesky(_spd(t, u[0], env.A, jnp))
        if op == "cholesky":
            return L @ v
        return jsl.cho_solve((L, True), v)
    Mx = _matrix(t, u[0], env.A, jnp)
    if op == "solve_vec":
        return jnp.linalg.solve(Mx, v)
    if op == "solve_mat":
        return jnp.linalg.solve(Mx, jnp.stack([v, jnp.sin(x)], -1)) @ env.w
    if op == "det":
        return jnp.linalg.det(Mx) * jnp.tanh(v)
    if op == "slogdet":
        return jnp.linalg.slogdet(Mx)[1] * jnp.tanh(v)
    if op == "lu":
        return jsl.lu_solve(jsl.lu_factor(Mx), v)
    if op == "inv":
        return jnp.linalg.inv(Mx) @ v
    if op == "solve_triangular":
        return jsl.solve_triangular(jnp.tril(Mx), v, lower=True)
    if op == "sort":
        return jnp.sort(x * v + 0.3 * x)
    if op == "topk":
        return jax.lax.top_k(x + v, 2)[0].sum() * t
    raise ValueError(op)


OPS = ("solve_vec", "solve_mat", "det", "slogdet", "lu", "inv", "cholesky",
       "cholesky_solve", "solve_triangular", "sort", "topk")


@dataclasses.dataclass(frozen=True, eq=False)
class OpStepEnv(Env):
    """x' = x + 0.1 y(x, u), y the op's vector; cost |x|^2 + 0.1 |u|^2 +
    0.05 |y|^2; final cost 2 |x|^2 + 0.05 |y(x, 0)|^2."""

    A: torch.Tensor    # [n, n]
    Bm: torch.Tensor   # [n, m]
    c: torch.Tensor    # [n]
    w: torch.Tensor    # [2]
    op: str = "solve_vec"
    bounds: Optional[Bounds] = None

    @property
    def state_size(self):
        return N

    @property
    def action_size(self):
        return M

    def transition(self, x, u):
        return x + 0.1 * _torch_op(self.op, self, x, u)

    def cost(self, x, u):
        y = _torch_op(self.op, self, x, u)
        return (x * x).sum(-1) + 0.1 * (u * u).sum(-1) + 0.05 * (y * y).sum(-1)

    def final_cost(self, x):
        y = _torch_op(self.op, self, x, torch.zeros_like(x[..., :M]))
        return 2.0 * (x * x).sum(-1) + 0.05 * (y * y).sum(-1)


def _jax_env(op):
    @pytree_dataclass
    class JaxOpStepEnv(JaxEnv):
        A: jnp.ndarray
        Bm: jnp.ndarray
        c: jnp.ndarray
        w: jnp.ndarray

        @property
        def state_size(self):
            return N

        @property
        def action_size(self):
            return M

        def transition(self, x, u):
            return x + 0.1 * _jax_op(op, self, x, u)

        def cost(self, x, u):
            y = _jax_op(op, self, x, u)
            return x @ x + 0.1 * (u @ u) + 0.05 * (y @ y)

        def final_cost(self, x):
            y = _jax_op(op, self, x, jnp.zeros(M, x.dtype))
            return 2.0 * (x @ x) + 0.05 * (y @ y)

    return JaxOpStepEnv


def _twins(op):
    rng = np.random.default_rng(OPS.index(op))
    arrays = dict(A=rng.standard_normal((N, N)),
                  Bm=rng.standard_normal((N, M)),
                  c=rng.uniform(0.5, 1.5, N), w=np.array([1.0, 0.5]))
    jenv = _jax_env(op)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tenv = interop.user_env_from_numpy(OpStepEnv, arrays,
                                       dtype=torch.float64, device="cpu")
    tenv = dataclasses.replace(tenv, op=op)
    rng = np.random.default_rng(100 + OPS.index(op))
    X = rng.uniform(-1.0, 1.0, (B, T + 1, N))
    U = rng.uniform(-1.0, 1.0, (B, T, M))
    return jenv, tenv, X, U


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("op", OPS)
def test_derivatives_match_jax(op):
    jenv, tenv, X, U = _twins(op)
    ours = ilqr.derivatives(tenv, torch.as_tensor(X), torch.as_tensor(U))
    theirs = jax.jit(jax.vmap(lambda x, u: jilqr.derivatives(jenv, x, u)))(
        jnp.asarray(X), jnp.asarray(U))
    for model, jmodel in zip(ours, theirs):
        for f in model.__dataclass_fields__:
            _close(getattr(model, f).numpy(), getattr(jmodel, f),
                   f"{op} {type(model).__name__}.{f}")


@pytest.mark.parametrize("op", OPS)
def test_second_derivatives_match_jax(op):
    jenv, tenv, X, U = _twins(op)
    ours = ilqr.second_derivatives(tenv, torch.as_tensor(X),
                                   torch.as_tensor(U))
    theirs = jax.jit(lambda x, u: jenv.get_second_order_transition(
        x, u, batch=True))(jnp.asarray(X[:, :-1].reshape(-1, N)),
                           jnp.asarray(U.reshape(-1, M)))
    for f in ("f_xx", "f_ux", "f_uu"):
        want = np.asarray(getattr(theirs, f))
        _close(getattr(ours, f).numpy(),
               want.reshape((B, T) + want.shape[1:]), f"{op} {f}")


# user envs whose steps read tables and vectors at indices computed from
# the state (``tests/torch_user_envs.py``; JAX twins in
# ``test_torch_env_codegen``): label -> (maker, x range, u range)
USER_ENVS = {
    "cascade": (_cascade, (0.2, 1.2), (0.0, 0.2)),
    "integers": (lambda: _op_env("integers"), (-1.5, 1.5), (-1.0, 1.0)),
}


@pytest.mark.parametrize("label", list(USER_ENVS))
def test_integer_user_env_derivatives_match_jax(label):
    """The hydro cascade's and the integer family's linearization (f, f_x,
    f_u, l and its derivatives, the final cost's) and dynamics Hessians
    against the JAX package's: zero through the integer paths (an index
    has no derivative), the gathered values' own derivatives through the
    reads."""
    build, xr, ur = USER_ENVS[label]
    jenv, tenv = build()
    n, m = tenv.state_size, tenv.action_size
    rng = np.random.default_rng(list(USER_ENVS).index(label))
    X, U = rng.uniform(*xr, (B, T + 1, n)), rng.uniform(*ur, (B, T, m))
    tX, tU = torch.as_tensor(X), torch.as_tensor(U)
    ours = ilqr.derivatives(tenv, tX, tU)
    theirs = jax.jit(jax.vmap(lambda x, u: jilqr.derivatives(jenv, x, u)))(
        jnp.asarray(X), jnp.asarray(U))
    for model, jmodel in zip(ours, theirs):
        for f in model.__dataclass_fields__:
            _close(getattr(model, f).numpy(), getattr(jmodel, f),
                   f"{label} {type(model).__name__}.{f}")
    second = ilqr.second_derivatives(tenv, tX, tU)
    jsecond = jax.jit(lambda x, u: jenv.get_second_order_transition(
        x, u, batch=True))(jnp.asarray(X[:, :-1].reshape(-1, n)),
                           jnp.asarray(U.reshape(-1, m)))
    for f in ("f_xx", "f_ux", "f_uu"):
        want = np.asarray(getattr(jsecond, f))
        _close(getattr(second, f).numpy(),
               want.reshape((B, T) + want.shape[1:]), f"{label} {f}")


@dataclasses.dataclass(frozen=True, eq=False)
class ScalarTimesFloat(Env):
    """A float32 env over 0-d elements times Python floats (``unbind``),
    whose derivatives ``torch.func.jacfwd`` made float64."""

    w: torch.Tensor   # [2]

    @property
    def state_size(self):
        return 2

    @property
    def action_size(self):
        return 1

    def transition(self, x, u):
        a, b = x.unbind(-1)
        return torch.stack([a + 0.1 * b, b + 0.1 * torch.sin(a)
                            + 0.1 * u[..., 0]], -1)

    def cost(self, x, u):
        a, b = x.unbind(-1)
        return 0.5 * a * a + 0.1 * b * b * self.w[0] + 0.01 * u[..., 0] ** 2

    def final_cost(self, x):
        return 2.0 * x[..., 0] ** 2 + x[..., 1] ** 2


def test_float32_env_keeps_float32_derivatives():
    """Every field of a float32 env's derivatives is float32 and within
    1e-6 of the float64 env's, rounded."""
    rng = np.random.default_rng(3)
    X, U = rng.uniform(-1, 1, (4, T + 1, 2)), rng.uniform(-1, 1, (4, T, 1))
    envs = [ScalarTimesFloat(w=torch.ones(2, dtype=d))
            for d in (torch.float32, torch.float64)]
    got, want = (ilqr.derivatives(e, torch.as_tensor(X, dtype=e.w.dtype),
                                  torch.as_tensor(U, dtype=e.w.dtype))
                 for e in envs)
    for model, model64 in zip(got, want):
        for f in model.__dataclass_fields__:
            a, b = getattr(model, f), getattr(model64, f)
            assert a.dtype == torch.float32, f
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f)


@pytest.mark.parametrize("op", ("solve_vec", "det", "topk"))
def test_chunked_derivatives_match_unchunked(op, monkeypatch):
    """With ``MAX_COPIES`` at 45 (point, copy) pairs every autodiff map
    splits its points into uneven chunks (the Jacobians 4 x 15 + 4 of 64
    points, the cost's Hessians 7 x 9 + 1, the final cost's 15 + 1 of 16,
    the dynamics Hessians 21 x 3 + 1): the fields equal the unchunked
    ones and the JAX package's."""
    jenv, tenv, X, U = _twins(op)
    X, U = torch.as_tensor(X), torch.as_tensor(U)
    whole = (*ilqr.derivatives(tenv, X, U),
             ilqr.second_derivatives(tenv, X, U))
    monkeypatch.setattr(base, "MAX_COPIES", 45)
    chunked = (*ilqr.derivatives(tenv, X, U),
               ilqr.second_derivatives(tenv, X, U))
    theirs = jax.jit(jax.vmap(lambda x, u: jilqr.derivatives(jenv, x, u)))(
        jnp.asarray(X.numpy()), jnp.asarray(U.numpy()))
    for model, ref, jmodel in zip(chunked, whole, (*theirs, None)):
        for f in model.__dataclass_fields__:
            got = getattr(model, f).numpy()
            _close(got, getattr(ref, f).numpy(), f"{op} chunked {f}")
            if jmodel is not None:
                _close(got, getattr(jmodel, f), f"{op} chunked vs JAX {f}")


def _inference_cases():
    """label -> (a maker of the env, x0, horizon, config, the points of its
    derivatives (X, U) or None): the lu twin bounded, HVAC with its box
    through ``load_env`` (closed-form derivatives: its solve's KKT test
    takes the gradient), the two-link arm without and with ``ddp``."""
    _, lu, X, U = _twins("lu")
    X, U = torch.as_tensor(X), torch.as_tensor(U)
    box = np.full(M, 0.5)
    boxqp = ilqr.ILQRConfig(atol=1e-6, max_iterations=10, boxqp=True)
    arm_cfg = ilqr.ILQRConfig(atol=1e-5, max_iterations=5)
    rng = np.random.default_rng(7)
    aX = torch.as_tensor(np.stack([tue.arm_x0(4, seed=t) for t in
                                   range(T + 1)], 1))
    aU = torch.as_tensor(rng.uniform(-3.0, 3.0, (4, T, 2)))
    arm = lambda: interop.user_env_from_numpy(  # noqa: E731
        tue.TwoLinkArm, tue.ARM, dtype=torch.float64, device="cpu")
    return {
        "lu": (lambda: dataclasses.replace(
            _twins("lu")[1], bounds=Bounds(low=-torch.as_tensor(box),
                                           high=torch.as_tensor(box))),
               X[:, 0], T, boxqp, (X, U)),
        "hvac": (lambda: load_env(ROOT / "configs" / "hvac.json",
                                  dtype=torch.float64, device="cpu"),
                 None, 8, ilqr.ILQRConfig(atol=1e-5, max_iterations=10,
                                          use_pallas=False), None),
        "arm": (arm, torch.as_tensor(tue.arm_x0(16)), T, arm_cfg, (aX, aU)),
        "arm_ddp": (arm, torch.as_tensor(tue.arm_x0(16)), T,
                    dataclasses.replace(arm_cfg, ddp=True), (aX, aU)),
    }


def test_derivatives_under_inference_mode():
    """Under ``torch.inference_mode`` the autodiff linearization, the
    dynamics Hessians and a bounded solve (whose KKT test takes a
    gradient) give what they give outside it, not zeros; and an env built
    under it, whose parameters are inference tensors that autograd cannot
    save for backward (``base.autograd_env`` clones them, once a solve),
    gives, inside it and outside, bit for bit what the same env built
    outside gives: the lu twin with a box, HVAC with its box through
    ``load_env`` (x0 = 20, B = 16, T = 8), the two-link arm without and
    with ``ddp=True``."""
    _, tenv, X, U = _twins("lu")
    X, U = torch.as_tensor(X), torch.as_tensor(U)
    box = torch.full((M,), 0.5, dtype=torch.float64)
    benv = dataclasses.replace(tenv, bounds=Bounds(low=-box, high=box))
    config = ilqr.ILQRConfig(atol=1e-6, max_iterations=10, boxqp=True)

    def run():
        return ((*ilqr.derivatives(tenv, X, U),
                 ilqr.second_derivatives(tenv, X, U)),
                ilqr.solve_batch(benv, X[:, 0], horizon=T, config=config))

    (want, want_res) = run()
    with torch.inference_mode():
        got, got_res = run()
    for model, ref in zip(got, want):
        for f in model.__dataclass_fields__:
            a, b = getattr(model, f), getattr(ref, f)
            assert b.abs().max() > 0, f
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f)
    for f in ("converged", "failed", "actions", "total_cost"):
        torch.testing.assert_close(getattr(got_res, f), getattr(want_res, f),
                                   rtol=0, atol=0, msg=f)

    def outputs(env, x0, horizon, cfg, points):
        if x0 is None:
            x0 = torch.full((16, env.state_size), 20.0, dtype=torch.float64)
        res = ilqr.solve_batch(env, x0, horizon=horizon, config=cfg)
        out = {f"solve {f}": getattr(res, f) for f in (
            "converged", "failed", "actions", "total_cost", "iterations")}
        if points is not None:
            models = (*ilqr.derivatives(env, *points),
                      ilqr.second_derivatives(env, *points))
            for model in models:
                for f in model.__dataclass_fields__:
                    out[f"{type(model).__name__}.{f}"] = getattr(model, f)
        return out

    for label, (make, x0, horizon, cfg, points) in _inference_cases().items():
        env = make()
        with torch.inference_mode():
            built = make()
        params = [v for v in vars(built).values()
                  if isinstance(v, torch.Tensor) and v.is_floating_point()]
        assert params and all(v.is_inference() for v in params), label
        want = outputs(env, x0, horizon, cfg, points)
        for mode in (contextlib.nullcontext, torch.inference_mode):
            with mode():
                got = outputs(built, x0, horizon, cfg, points)
            assert all(v.is_inference() for v in params), label  # unchanged
            for k, v in want.items():
                assert torch.equal(got[k], v), (label, mode.__name__, k)
        if label == "hvac":
            assert want["solve total_cost"].mean() == got[
                "solve total_cost"].mean()
