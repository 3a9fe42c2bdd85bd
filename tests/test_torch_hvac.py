"""The port's HVAC and reservoir envs and its registry vs the JAX package.

Both envs are built from the repo's configs (``configs/hvac.json``, six
rooms, and ``configs/hvac16.json``, sixteen, the mid-dim slice's env;
``configs/reservoir.json``, five reservoirs) by each package's
``load_env`` in float64, and the same inputs, drawn with numpy from a seed,
go through both. Tolerance: 1e-12 relative and absolute; both evaluate the
same float64 formulas, and only the order of a few sums and the sin
library differ, which moves results by a few ulps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models import registry as jregistry
from tfmpc_tpu_torch import interop
from tfmpc_tpu_torch.models import registry
from tfmpc_tpu_torch.models.hvac import HVAC_STEP_ID, HVAC_STEP_PARAMS
from tfmpc_tpu_torch.models.hvac import make_hvac
from tfmpc_tpu_torch.models.linear import make_linear_system
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.models.problems import (
    make_lqr,
    make_lqr_linear_navigation,
)
from tfmpc_tpu_torch.models.reservoir import (
    RESERVOIR_STEP_ID,
    RESERVOIR_STEP_PARAMS,
    make_reservoir,
)
from tfmpc_tpu_torch.solvers import ilqr
from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

TOL = dict(rtol=1e-12, atol=1e-12)
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
ENVS = {"hvac": ("hvac.json", (8.0, 24.0), (0.0, 10.0)),
        "hvac16": ("hvac16.json", (8.0, 24.0), (0.0, 10.0)),
        "reservoir": ("reservoir.json", (5.0, 98.0), (0.0, 50.0))}
SIZES = {"hvac": 6, "hvac16": 16, "reservoir": 5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(name):
    path = CONFIGS / ENVS[name][0]
    return (jregistry.load_env(str(path), dtype=jnp.float64),
            registry.load_env(path, dtype=torch.float64, device="cpu"))


def _points(name, shape, seed):
    _, xr, ur = ENVS[name]
    n = SIZES[name]
    rng = np.random.default_rng(seed)
    return (rng.uniform(*xr, shape + (n,)), rng.uniform(*ur, shape + (n,)))


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_dynamics_and_costs_match_jax(name):
    jenv, tenv = _envs(name)
    x, u = _points(name, (64,), 0)
    # points exactly on the hinges of the comfort / level costs
    if name.startswith("hvac"):
        x[0, :3], x[1, :3] = 20.0, 23.5
    else:
        x[0, :3], x[1, :3] = 10.0, 90.0
    tx, tu = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(tenv.transition(tx, tu).numpy(),
                               _np(jax.vmap(jenv.transition)(x, u)), **TOL)
    np.testing.assert_allclose(tenv.cost(tx, tu).numpy(),
                               _np(jax.vmap(jenv.cost)(x, u)), **TOL)
    np.testing.assert_allclose(tenv.final_cost(tx).numpy(),
                               _np(jax.vmap(jenv.final_cost)(x)), **TOL)
    U = _points(name, (4, 12), 1)[1]
    X_t, c_t = tenv.rollout(tx[:4], torch.as_tensor(U))
    X_j, c_j = jax.vmap(jenv.rollout)(x[:4], U)
    np.testing.assert_allclose(X_t.numpy(), _np(X_j), **TOL)
    np.testing.assert_allclose(c_t.numpy(), _np(c_j), **TOL)


def _fields(model):
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_analytic_derivatives_match_jax_and_autodiff(name):
    """The closed-form linearization along a batch of trajectories against
    the JAX method per scenario, and against the port's own autodiff route
    (``ilqr.derivatives`` on the env with the closed form switched off)."""
    jenv, tenv = _envs(name)
    x, u = _points(name, (3, 9), 2)
    X = np.concatenate([x, x[:, :1] + 0.5], axis=1)       # [3, T+1, n]
    ours = tenv.analytic_derivatives(torch.as_tensor(X), torch.as_tensor(u))
    theirs = jax.vmap(jenv.analytic_derivatives)(X, u)
    for o, t in zip(ours, theirs):
        for f, v in _fields(o).items():
            np.testing.assert_allclose(v.numpy(), _np(getattr(t, f)),
                                       err_msg=f, **TOL)

    class Autodiff(type(tenv)):
        def analytic_derivatives(self, X, U):
            return None

    generic = Autodiff(**_fields(tenv))
    auto = ilqr.derivatives(generic, torch.as_tensor(X), torch.as_tensor(u))
    for o, a in zip(ours, auto):
        for f, v in _fields(o).items():
            np.testing.assert_allclose(
                torch.broadcast_to(v, getattr(a, f).shape).numpy(),
                getattr(a, f).numpy(), err_msg=f, **TOL)


@pytest.mark.parametrize("config", ["hvac.json", "hvac16.json",
                                    "reservoir.json",
                                    "navigation_bounded.json"])
def test_load_env_matches_jax_registry(config):
    jenv = jregistry.load_env(str(CONFIGS / config), dtype=jnp.float64)
    tenv = registry.load_env(CONFIGS / config, dtype=torch.float64,
                             device="cpu")
    assert type(tenv).__name__ == type(jenv).__name__
    for f in dataclasses.fields(jenv):
        if f.name == "bounds":
            continue
        np.testing.assert_array_equal(getattr(tenv, f.name).numpy(),
                                      _np(getattr(jenv, f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(tenv.bounds.low.numpy(),
                                  _np(jenv.bounds.low))
    np.testing.assert_array_equal(tenv.bounds.high.numpy(),
                                  _np(jenv.bounds.high))
    # the same env carried over as numpy arrays
    name = config.split(".")[0].replace("_bounded", "").replace("16", "")
    arrays = {f.name: _np(getattr(jenv, f.name))
              for f in dataclasses.fields(jenv) if f.name != "bounds"}
    carried = interop.env_from_numpy(
        name, {**arrays, "low": _np(jenv.bounds.low),
               "high": _np(jenv.bounds.high)},
        device="cpu", dtype=torch.float64)
    for f in dataclasses.fields(carried):
        a, b = getattr(carried, f.name), getattr(tenv, f.name)
        if f.name == "bounds":
            a, b = torch.stack([a.low, a.high]), torch.stack([b.low, b.high])
        assert torch.equal(a, b), f.name


@pytest.mark.parametrize("name", sorted(ENVS))
def test_device_step_params_match_jax_lane_params(name):
    jenv, tenv = _envs(name)
    step = tenv.device_step()
    jparams = jenv.lane_functions()[0]
    if name.startswith("hvac"):
        assert step.env_id == HVAC_STEP_ID and step.int_params == ()
        names = HVAC_STEP_PARAMS
    else:
        assert step.env_id == RESERVOIR_STEP_ID and step.int_params == ()
        names = RESERVOIR_STEP_PARAMS
        # the functor divides by max_capacity, as transition does
        jparams = {**jparams, "max_capacity": 1.0 / jparams["inv_cap"]}
    assert len(step.params) == len(names)
    for key, value in zip(names, step.params):
        assert value.is_contiguous(), key
        np.testing.assert_allclose(value.numpy(), _np(jparams[key]),
                                   err_msg=key, **TOL)


def test_registry_names_and_unported_linear():
    assert sorted(registry.registered()) == sorted(jregistry.registered())
    # linear is ported (models/linear.py): it builds instead of raising
    env = registry.make_env({"name": "linear", "A": [[1.0]], "B": [[1.0]]},
                            device="cpu")
    assert (env.state_size, env.action_size) == (1, 1)
    with pytest.raises(ValueError, match="unknown env"):
        registry.make_env({"name": "pendulum"}, device="cpu")
    with pytest.raises(ValueError, match="'name' key"):
        registry.make_env({"goal": [1.0, 2.0]}, device="cpu")


FACTORIES = {
    "make_navigation": lambda: make_navigation([8.0, -5.0]),
    "make_hvac": lambda: make_hvac([[0, 1], [1, 0]]),
    "make_reservoir": lambda: make_reservoir(3),
    "load_env": lambda: registry.load_env(CONFIGS / "hvac.json"),
    "make_env": lambda: registry.make_env({"name": "reservoir",
                                           "n_reservoirs": 2}),
    "env_from_numpy": lambda: interop.env_from_numpy(
        "navigation", {"goal": np.zeros(2), "centers": np.zeros((0, 2)),
                       "decays": np.zeros(0)}),
    "navigation_from_numpy": lambda: interop.navigation_from_numpy(
        np.zeros(2), np.zeros((0, 2)), np.zeros(0)),
    "state_from_numpy": lambda: interop.state_from_numpy(
        {"X": np.zeros((1, 2, 2)), "U": np.zeros((1, 1, 2)),
         "J": np.zeros(1), "mu": np.zeros(1), "delta": np.ones(1),
         "iteration": np.zeros(1, np.int32), "converged": np.zeros(1, bool),
         "failed": np.zeros(1, bool), "residual": np.zeros(1)}),
    "ILQRConfig.alphas": lambda: ILQRConfig().alphas(),
    "make_linear_system": lambda: make_linear_system([[1.0]], [[1.0]]),
    "make_lqr": lambda: make_lqr(torch.Generator().manual_seed(0), 2, 1, 3),
    "make_lqr_linear_navigation": lambda: make_lqr_linear_navigation(
        [1.0, 2.0], beta=0.5, horizon=3),
    "lqr_problem_from_numpy": lambda: interop.lqr_problem_from_numpy(
        np.zeros((3, 2, 3)), np.zeros((3, 2)), np.eye(3)[None].repeat(3, 0),
        np.zeros((3, 3))),
}


@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_factories_default_to_the_card(factory):
    """Called without ``device``, every factory builds on the card: on a
    machine with a GPU its tensors are CUDA tensors, and without one the
    call raises instead of quietly building on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            FACTORIES[factory]()
        return
    obj = FACTORIES[factory]()
    if isinstance(obj, torch.Tensor):
        tensors = [obj]
    else:
        tensors = [v for v in (vars(obj) if not hasattr(obj, "_asdict")
                               else obj._asdict()).values()
                   if isinstance(v, torch.Tensor)]
    assert tensors and all(t.device.type == "cuda" for t in tensors)
