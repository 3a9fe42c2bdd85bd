"""The port's receding-horizon MPC driver vs the JAX package's ``mpc.run``.

Inputs are drawn with numpy from a seed and handed to both packages, in
float64 on the CPU. The JAX side runs its XLA path (``use_pallas=False``),
the port its fused route (``use_pallas=True, fuse_derivatives=True``: on
CPU tensors the wrappers of K1/K4, K2 and K8 run their plain versions) and
its plain path. Both compute the same float64 algorithm re-plan by re-plan
and differ only in rounding order: identical iteration counts and
convergence per re-plan, states, actions and costs within 1e-8.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import mpc as jmpc
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import rollout
from tfmpc_tpu_torch.solvers import ilqr, mpc

GOAL = [8.0, -5.0]
ZONE = {"center": [[3.0, -2.0]], "decay": [2.0]}
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(bounded=False):
    box = dict(low=-1.0, high=1.0) if bounded else {}
    return (jax_make_navigation(GOAL, ZONE, dtype=jnp.float64, **box),
            make_navigation(GOAL, ZONE, dtype=torch.float64, device="cpu",
                            **box))


def _run_both(x0, steps, plan_horizon, cfg, bounded=False, fused=True):
    jenv, tenv = _envs(bounded)
    res_j = jmpc.run(jenv, jnp.asarray(x0), steps=steps,
                     plan_horizon=plan_horizon,
                     config=jilqr.ILQRConfig(**cfg))
    port_cfg = dict(cfg, use_pallas=True, fuse_derivatives=True) if fused \
        else cfg
    res_t = mpc.run(tenv, torch.as_tensor(x0), steps=steps,
                    plan_horizon=plan_horizon,
                    config=ilqr.ILQRConfig(**port_cfg))
    return res_t, res_j


def _assert_same(res_t, res_j):
    for name in res_t._fields:
        ours, theirs = getattr(res_t, name).numpy(), np.asarray(
            getattr(res_j, name))
        assert ours.shape == theirs.shape, name
        if name in ("iterations", "converged"):
            np.testing.assert_array_equal(ours, theirs, err_msg=name)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-8,
                                       err_msg=name)


def test_single_closed_loop_matches_jax():
    """An ``[n]`` x0 runs as a batch of one and is squeezed back; the
    fused route re-plans through K8's wrapper and never through K3's."""
    counts = rollout.DERIVS_PLAIN_CALLS, rollout.ALPHA_PLAIN_CALLS
    res_t, res_j = _run_both(np.zeros(2), 10, 10,
                             dict(atol=1e-6, max_iterations=30))
    assert res_t.states.shape == (11, 2) and res_t.actions.shape == (10, 2)
    assert res_t.total_cost.shape == ()
    _assert_same(res_t, res_j)
    assert rollout.DERIVS_PLAIN_CALLS > counts[0]
    assert rollout.ALPHA_PLAIN_CALLS == counts[1]
    # warm starts keep later re-plans cheap
    assert int(res_t.iterations[0]) >= int(res_t.iterations[5:].max())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "plain"])
def test_batched_closed_loop_matches_jax(fused):
    x0 = np.random.default_rng(0).uniform(-4.0, 4.0, (3, 2))
    res_t, res_j = _run_both(x0, 8, 6, dict(atol=1e-5, max_iterations=20),
                             fused=fused)
    assert res_t.states.shape == (3, 9, 2)
    _assert_same(res_t, res_j)


def test_bounded_closed_loop_matches_jax():
    """A bounded env with boxQP re-plans (K4 in the fused iteration); the
    executed actions stay in the box."""
    x0 = np.random.default_rng(1).uniform(-6.0, 6.0, (4, 2))
    res_t, res_j = _run_both(
        x0, 6, 8, dict(atol=1e-4, max_iterations=15, boxqp=True),
        bounded=True)
    _assert_same(res_t, res_j)
    assert float(res_t.actions.abs().max()) <= 1.0
    assert bool(torch.isfinite(res_t.total_cost).all())


def test_modules_never_import_jax():
    """The driver, the checkpoints and the trajectory table import and run
    with JAX blocked."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        from tfmpc_tpu_torch.models.navigation import make_navigation
        from tfmpc_tpu_torch.solvers import ilqr, mpc
        from tfmpc_tpu_torch.utils import checkpoint, trajectory
        env = make_navigation([8.0, -5.0], {"center": [[3.0, -2.0]],
                                            "decay": [2.0]}, device="cpu")
        res = mpc.run(env, torch.zeros(2, 2), steps=3, plan_horizon=5,
                      config=ilqr.ILQRConfig(use_pallas=True,
                                             fuse_derivatives=True))
        assert res.states.shape == (2, 4, 2)
        repr(trajectory.Trajectory(res.states[0], res.actions[0],
                                   torch.cat([res.costs[0],
                                              res.final_cost[:1]])))
        loaded = [m for m in sys.modules if m == "jax" or
                  m.startswith(("jax.", "tfmpc_tpu.")) or m == "tfmpc_tpu"]
        assert loaded == ["jax"], loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
