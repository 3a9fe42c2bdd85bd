"""The port's LinearSystem env vs the JAX package, float64 on CPU.

Dynamics, costs, the closed-form linearization, the LQR form, the device
step's parameters and the registry against the JAX env built from the same
numpy arrays (1e-12: the same float64 arithmetic in another order), and
iLQR on the double integrator against the exact LQR optimum (the port's
version of ``tests/test_linear_env.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.linear import make_linear_system as jax_make_linear
from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu_torch import interop
from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.models import registry
from tfmpc_tpu_torch.models.linear import (
    LINEAR_STEP_ID,
    LINEAR_STEP_PARAMS,
    make_linear_system,
)
from tfmpc_tpu_torch.ops import rollout
from tfmpc_tpu_torch.solvers import ilqr, lqr

TOL = dict(rtol=1e-12, atol=1e-12)
DT = 0.1
DOUBLE_INTEGRATOR = dict(A=[[1.0, DT], [0.0, 1.0]], B=[[0.5 * DT * DT], [DT]],
                         Q=[[1.0, 0.0], [0.0, 0.1]], R=[[0.01]])


def _random_system(n, m, seed):
    """A system with every term non-zero and non-symmetric Q, R, Q_f (the
    linearization must use their symmetric parts)."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, n))
    Lr = rng.standard_normal((m, m))
    return dict(
        A=np.eye(n) + 0.1 * rng.standard_normal((n, n)),
        B=rng.standard_normal((n, m)),
        c=0.1 * rng.standard_normal(n),
        Q=L @ L.T / n + 0.1 * np.eye(n) + 0.05 * rng.standard_normal((n, n)),
        R=Lr @ Lr.T / m + 0.5 * np.eye(m) + 0.05 * rng.standard_normal((m, m)),
        N=0.1 * rng.standard_normal((n, m)),
        q=rng.standard_normal(n),
        r=rng.standard_normal(m),
        Q_f=2.0 * np.eye(n) + 0.05 * rng.standard_normal((n, n)),
        q_f=rng.standard_normal(n),
    )


def _envs(kw):
    kw = dict(kw)
    A, B = kw.pop("A"), kw.pop("B")
    return (jax_make_linear(A, B, **kw, dtype=jnp.float64),
            make_linear_system(A, B, **kw, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("n,m,seed", [(2, 1, 0), (3, 2, 1), (2, 3, 2)])
def test_dynamics_costs_and_linearization_match_jax(n, m, seed):
    jenv, tenv = _envs(_random_system(n, m, seed))
    assert (tenv.state_size, tenv.action_size) == (n, m)
    rng = np.random.default_rng(seed + 10)
    T = 6
    x = rng.standard_normal((T, n))
    u = rng.standard_normal((T, m))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(tenv.transition(tx, tu).numpy(), np.asarray(
        jax.vmap(jenv.transition)(jnp.asarray(x), jnp.asarray(u))), **TOL)
    np.testing.assert_allclose(tenv.cost(tx, tu).numpy(), np.asarray(
        jax.vmap(jenv.cost)(jnp.asarray(x), jnp.asarray(u))), **TOL)
    np.testing.assert_allclose(tenv.final_cost(tx).numpy(), np.asarray(
        jax.vmap(jenv.final_cost)(jnp.asarray(x))), **TOL)

    X, _ = tenv.rollout(tx[0], tu)
    ours = tenv.analytic_derivatives(X, tu)
    theirs = jenv.analytic_derivatives(jnp.asarray(X.numpy()),
                                       jnp.asarray(u))
    for rec_t, rec_j in zip(ours, theirs):
        for f in rec_t.__dataclass_fields__:
            np.testing.assert_allclose(
                getattr(rec_t, f).numpy(), np.asarray(getattr(rec_j, f)),
                err_msg=f, **TOL)
    # ... and the port's closed form equals its own autodiff route
    for rec_a, rec_d in zip(ours, (
            tenv.get_linear_transition(X[:-1], tu, batch=True),
            tenv.get_quadratic_cost(X[:-1], tu, batch=True),
            tenv.get_quadratic_final_cost(X[-1]))):
        for f in rec_a.__dataclass_fields__:
            np.testing.assert_allclose(getattr(rec_a, f).numpy(),
                                       getattr(rec_d, f).numpy(),
                                       err_msg=f, **TOL)

    p_t, p_j = tenv.to_lqr_problem(T), jenv.to_lqr_problem(T)
    for f in ("F", "f", "C", "c", "C_f", "c_f"):
        np.testing.assert_array_equal(getattr(p_t, f).numpy(),
                                      np.asarray(getattr(p_j, f)), f)


def test_device_step_params_match_lane_functions():
    jenv, tenv = _envs(_random_system(3, 2, 3))
    params, _, _ = jenv.lane_functions()
    step = tenv.device_step()
    assert step.env_id == LINEAR_STEP_ID and step.int_params == ()
    assert list(params) == list(LINEAR_STEP_PARAMS)
    for name, p in zip(LINEAR_STEP_PARAMS, step.params):
        assert p.is_contiguous()
        np.testing.assert_array_equal(p.numpy(), np.asarray(params[name]),
                                      name)


def test_registry_and_interop_build_the_jax_env():
    config = {"name": "linear", "A": [[1.0, 0.1], [0.0, 1.0]],
              "B": [[0.0], [0.1]], "R": [[0.01]], "low": -0.5, "high": 0.5}
    jenv = jax_make_env(config, dtype=jnp.float64)
    tenv = registry.make_env(config, dtype=torch.float64, device="cpu")
    arrays = {f.name: np.asarray(getattr(jenv, f.name))
              for f in dataclasses.fields(jenv) if f.name != "bounds"}
    carried = interop.env_from_numpy(
        "linear", dict(arrays, low=np.asarray(jenv.bounds.low),
                       high=np.asarray(jenv.bounds.high)),
        dtype=torch.float64, device="cpu")
    for env in (tenv, carried):
        for name, a in arrays.items():
            np.testing.assert_array_equal(getattr(env, name).numpy(), a, name)
        np.testing.assert_array_equal(env.bounds.low.numpy(), [-0.5])
        np.testing.assert_array_equal(env.bounds.high.numpy(), [0.5])


@pytest.mark.parametrize("batched", [False, True])
def test_ilqr_on_the_double_integrator_reaches_the_lqr_optimum(batched):
    """iLQR on a linear-quadratic problem converges in one Newton step to
    the exact LQR optimum (1e-8: both in float64)."""
    _, env = _envs(DOUBLE_INTEGRATOR)
    T = 40
    x0 = torch.tensor([3.0, -1.0], dtype=torch.float64)
    _, U_l, costs_l = lqr.solve(env.to_lqr_problem(T), x0)
    cfg = ilqr.ILQRConfig(atol=1e-12, max_iterations=50, use_pallas=True)
    if batched:
        res = ilqr.solve_batch(env, x0[None], horizon=T, config=cfg)
        res = type(res)(*(a[0] for a in res))
    else:
        res = ilqr.solve(env, x0, horizon=T, config=cfg)
    assert bool(res.converged) and int(res.iterations) <= 3
    np.testing.assert_allclose(res.actions.numpy(), U_l.numpy(), rtol=1e-8,
                               atol=1e-8)
    assert float(res.total_cost) == pytest.approx(float(costs_l.sum()),
                                                  rel=1e-10)


def test_rectangular_env_has_no_kernel_instantiation():
    """n=2, m=1: with use_pallas on CPU tensors the solve runs the plain
    versions; the kernels' layout, which a CUDA solve launches on, is built
    for the rectangular dims (u [T, 1, B], K [T, 1*2, B]), and K2, K3 and
    K5 take the generic form's plan there (no unrolled instantiation has
    m != n)."""
    _, env = _envs(DOUBLE_INTEGRATOR)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (4, 2)))
    res = ilqr.solve_batch(env, x0, horizon=12, config=ilqr.ILQRConfig(
        atol=1e-8, max_iterations=20, use_pallas=True))
    assert bool(res.converged.all())
    policy = Policy(K=torch.zeros(4, 12, 1, 2, dtype=torch.float64),
                    k=torch.zeros(4, 12, 1, dtype=torch.float64))
    a = rollout.kernel_layout(env, res.states, res.actions, policy)
    assert a["dims"] == (4, 12, 2, 1) and a["env_id"] == LINEAR_STEP_ID
    assert a["ubar"].shape == (12, 1, 4) and a["K"].shape == (12, 2, 4)
    assert a["xbar"].shape == (12, 2, 4)
    assert not rollout.unrolled_dims(LINEAR_STEP_ID, 2, 1)
    pe = sum(p.numel() for p in a["params"])
    for kernel in ("costs", "alpha", "traj"):
        for dtype in (torch.float32, torch.float64):
            plan = rollout.rollout_plan(kernel, LINEAR_STEP_ID, 2, 1, 4096,
                                        11, dtype, pe)
            assert plan.generic
            assert plan.smem_bytes == rollout.generic_smem_bytes(
                2, 1, plan.groups, plan.scenarios, plan.depth, pe, dtype,
                plan.scenarios * (11 if kernel != "alpha" else 1))
