"""PyTorch port of the navigation env vs the JAX package, in float64 on CPU.

The same inputs, drawn with numpy from a seed, go through
``tfmpc_tpu.models.navigation`` and ``tfmpc_tpu_torch.models.navigation``.
Tolerance: 1e-12 absolute and relative. Both sides evaluate the same
float64 formulas; only the order of a few sums and the exp/sqrt libraries
differ, which moves results by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu_torch.models.navigation import (
    NAVIGATION_STEP_ID,
    make_navigation,
)
from tfmpc_tpu_torch.solvers import ilqr

TOL = dict(rtol=1e-12, atol=1e-12)

ZONES = {
    "one_zone": {"center": [[3.0, -2.0]], "decay": [2.0]},
    "two_zones": {"center": [[3.0, -2.0], [6.0, -4.0]], "decay": [2.0, 1.5]},
    "no_zones": None,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several pytest workers; keep torch from oversubscribing
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(zones):
    jenv = jax_make_navigation([8.0, -5.0], zones, dtype=jnp.float64)
    tenv = make_navigation([8.0, -5.0], zones, dtype=torch.float64,
                           device="cpu")
    return jenv, tenv


def _np(a):
    return np.asarray(a)


def _points(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-10.0, 10.0, shape + (2,))
    u = rng.normal(size=shape + (2,))
    return x, u


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_transition_and_costs_match_jax(zones):
    jenv, tenv = _envs(ZONES[zones])
    x, u = _points(0, (64,))
    # include points at and next to a zone center (the eps-guarded norm)
    x[0] = [3.0, -2.0]
    x[1] = [3.0 + 1e-7, -2.0]
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(
        tenv.transition(tx, tu).numpy(),
        _np(jax.vmap(jenv.transition)(x, u)), **TOL)
    np.testing.assert_allclose(
        tenv.cost(tx, tu).numpy(), _np(jax.vmap(jenv.cost)(x, u)), **TOL)
    np.testing.assert_allclose(
        tenv.final_cost(tx).numpy(), _np(jax.vmap(jenv.final_cost)(x)),
        **TOL)
    np.testing.assert_allclose(
        tenv.deceleration(tx).numpy(), _np(jax.vmap(jenv.deceleration)(x)),
        **TOL)


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_rollout_matches_jax(zones):
    jenv, tenv = _envs(ZONES[zones])
    rng = np.random.default_rng(1)
    x0 = rng.uniform(-10.0, 10.0, (8, 2))
    U = 0.3 * rng.normal(size=(8, 15, 2))
    X_j, c_j = jax.vmap(jenv.rollout)(x0, U)
    X_t, c_t = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))
    np.testing.assert_allclose(X_t.numpy(), _np(X_j), **TOL)
    np.testing.assert_allclose(c_t.numpy(), _np(c_j), **TOL)
    np.testing.assert_allclose(
        tenv.total_cost(torch.as_tensor(x0), torch.as_tensor(U)).numpy(),
        _np(jax.vmap(jenv.total_cost)(x0, U)), **TOL)


def _assert_models_match(ours, theirs, fields):
    for name in fields:
        np.testing.assert_allclose(
            getattr(ours, name).numpy(), _np(getattr(theirs, name)),
            err_msg=name, **TOL)


LIN = ("f", "f_x", "f_u")
QUAD = ("l", "l_x", "l_u", "l_xx", "l_uu", "l_ux")
FINAL = ("l", "l_x", "l_xx")


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_analytic_derivatives_match_jax(zones):
    """Closed-form linearization along a batch of trajectories: the port's
    batched call against the JAX method per scenario."""
    jenv, tenv = _envs(ZONES[zones])
    x, u = _points(2, (4, 13))
    X = np.concatenate([x, x[:, :1] + 0.5], axis=1)  # [4, T+1, 2]
    lin, quad, fin = tenv.analytic_derivatives(torch.as_tensor(X),
                                               torch.as_tensor(u))
    jl, jq, jf = jax.vmap(jenv.analytic_derivatives)(X, u)
    _assert_models_match(lin, jl, LIN)
    _assert_models_match(quad, jq, QUAD)
    _assert_models_match(fin, jf, FINAL)


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_autodiff_linearization_matches_jax(zones):
    """The generic autograd route (``models/base.py``) against the JAX
    autodiff methods, and against the port's own closed form."""
    jenv, tenv = _envs(ZONES[zones])
    x, u = _points(3, (32,))
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    _assert_models_match(tenv.get_linear_transition(tx, tu, batch=True),
                         jenv.get_linear_transition(x, u, batch=True), LIN)
    _assert_models_match(tenv.get_quadratic_cost(tx, tu, batch=True),
                         jenv.get_quadratic_cost(x, u, batch=True), QUAD)
    _assert_models_match(tenv.get_quadratic_final_cost(tx[0]),
                         jenv.get_quadratic_final_cost(x[0]), FINAL)

    class Autodiff(type(tenv)):
        def analytic_derivatives(self, X, U):
            return None

    generic = Autodiff(goal=tenv.goal, centers=tenv.centers,
                       decays=tenv.decays)
    X = torch.as_tensor(_points(4, (3, 11))[0])
    U = torch.as_tensor(_points(5, (3, 10))[1])
    for ours, theirs in zip(ilqr.derivatives(generic, X, U),
                            ilqr.derivatives(tenv, X, U)):
        for f in theirs.__dataclass_fields__:
            np.testing.assert_allclose(
                getattr(ours, f).numpy(), getattr(theirs, f).numpy(),
                err_msg=f, **TOL)


def test_device_step_and_bounds():
    _, tenv = _envs(ZONES["two_zones"])
    step = tenv.device_step()
    assert step.env_id == NAVIGATION_STEP_ID
    assert [p.shape for p in step.params] == [(2,), (2, 2), (2,)]
    assert step.int_params == (2,)
    assert tenv.bounds is None
    boxed = make_navigation([8.0, -5.0], None, low=-1.0, high=0.5,
                            dtype=torch.float64, device="cpu")
    u = torch.tensor([[-3.0, 3.0], [0.2, -0.7]], dtype=torch.float64)
    np.testing.assert_array_equal(boxed.clip(u).numpy(),
                                  [[-1.0, 0.5], [0.2, -0.7]])
    np.testing.assert_array_equal(tenv.clip(u).numpy(), u.numpy())
