"""User envs through the rollout kernels' path, against the JAX package.

The port of ``tests/test_fuzz_envs.py``'s properties 1 and 4 for the
generated step functor (``Env.generic_device_step``): a user env with only
``transition``/``cost``/``final_cost`` solves with ``use_pallas=True``
through K5's wrapper (AUTO's line search) on its generated step's layout.
On the CPU the wrappers run their plain versions; on the card the same call
launches the generic kernel with the generated functor. Each solve is held,
in float64, against the JAX package's ``solve_batch(use_pallas=True)`` on
the same env (carried across with ``interop.user_env_from_numpy``):
identical converged and failed masks, controls within 1e-8, costs within
1e-10 relative, and a bounded solve's controls inside the box exactly. The
custom-env example's ``DampedChain`` runs unbounded at B=128, so that the
JAX package runs its rollout kernels on the generic lane adapter in
interpret mode (they take B % 128 == 0); the fuzz envs and the bounded
chain at B=8, where the JAX package's rollouts are XLA's with either
``use_pallas``. The bounded cases hold against its ``use_pallas=False``
solve: its boxQP Riccati kernel in interpret mode takes 100-250 s a solve
on a CPU, and the port's backward on the CPU is the plain one either way.
Two envs whose steps use the ops the generator widened to
(``tests/torch_user_envs.py``) solve the same way at B=128, T=8: the probe
env (``atan2``, ``softmax``, ``cumsum``, ``einsum``, ``pad``, ``sign``,
``floor``, ``vector_norm``, ``softplus``, ``erf``), whose generated step
was refused before, the kinematic bicycle fleet of ``chip_smoke.py``
phase 31, and the two-link arm of the same phase (a linear solve and a
``topk``), whose step was refused and whose linearization was wrong
before; and the tabulated hydro cascade of the same phase (its tables read
at ``bucketize`` indices), whose step was refused, at B=128, T=8 against
the JAX package's ``use_pallas=False`` solve.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch import Bounds
from tfmpc_tpu_torch.models.base import USER_STEP_ID
from tfmpc_tpu_torch.ops import rollout
from tfmpc_tpu_torch.parallel import mesh
from tfmpc_tpu_torch.solvers import ilqr, mpc

import test_fuzz_envs
import torch_user_envs as tue
from test_torch_env_codegen import (_arm, _bicycle, _cascade, _chain,
                                    _fuzz_envs, _probe)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bounded_chain(d):
    """The example's chain at d with its box at +-1 in both packages."""
    jenv, tenv = _chain(d)
    box = np.ones(d)
    jenv = dataclasses.replace(jenv, bounds=test_fuzz_envs.Bounds(
        low=jnp.asarray(-box), high=jnp.asarray(box)))
    tenv = dataclasses.replace(tenv, bounds=Bounds(
        low=torch.as_tensor(-box), high=torch.as_tensor(box)))
    return jenv, tenv


# label -> (a maker of (JAX env, port env), box half-width or None, B, T,
# the JAX solve's use_pallas)
CASES = {
    "damped_chain": (lambda: _chain(4), None, 128, 8, True),
    "damped_chain_boxqp": (lambda: _bounded_chain(4), 1.0, 8, 8, False),
    **{f"fuzz_{seed}_{n}x{m}": (
        lambda seed=seed, n=n, m=m, b=b: _fuzz_envs(seed, n, m, b),
        0.7 if b else None, 8, 8, not b)
       for seed, n, m, b in test_fuzz_envs.CASES},
}


@pytest.mark.parametrize("label", list(CASES))
def test_solve_batch_on_the_generated_step_matches_jax(label):
    build, box, B, T, jax_pallas = CASES[label]
    jenv, tenv = build()
    x0 = np.random.default_rng(1000 + B).uniform(-1.5, 1.5,
                                                 (B, tenv.state_size))
    _hold_against_jax(jenv, tenv, x0, box, T, jax_pallas)


def test_probe_env_solves_on_its_generated_step_as_jax_does():
    """The repair: the probe env's step was refused (``NotImplementedError``
    on every device, the CPU included); its ``use_pallas=True`` solve now
    equals the JAX package's, whose kernels run it in interpret mode."""
    jenv, tenv = _probe()
    x0 = np.random.default_rng(3).uniform(-1.5, 1.5, (128, 3))
    _hold_against_jax(jenv, tenv, x0, None, 8, True)


def test_bicycle_fleet_solve_matches_jax():
    """The kinematic bicycle fleet (``hypot``, ``atan2``, constant indexing,
    ``vector_norm`` over the obstacles, ``softplus``): its
    ``use_pallas=True`` solve against the JAX package's."""
    jenv, tenv = _bicycle()
    _hold_against_jax(jenv, tenv, tue.bicycle_x0(128), None, 8, True)


def test_two_link_arm_solve_matches_jax():
    """The two-link arm (``torch.linalg.solve`` of its mass matrix,
    ``topk(largest=False)`` of its obstacle distances): its
    ``use_pallas=True`` solve, on the generated step with the factor of
    M(q) in ``prep``, against the JAX package's, whose kernels run it in
    interpret mode; before the linearization's repair its derivatives
    were wrong and its step refused."""
    jenv, tenv = _arm()
    x0 = tue.arm_x0(128)
    res_j = _hold_against_jax(jenv, tenv, x0, None, 8, True)
    # the plain path, whose linearization is the same autodiff
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=8,
                             config=ilqr.ILQRConfig(atol=1e-5,
                                                    max_iterations=10))
    for f in ("converged", "failed"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-10)


def test_hydro_cascade_solve_matches_jax():
    """The tabulated hydro cascade (``bucketize`` of 33-knot tables, the
    knots and values read at that index, releases boxed in [0, q_max],
    n = m = 4), B=128, T=8, f64, ``use_pallas=True`` on its generated step,
    against the JAX package's ``use_pallas=False`` solve (its boxQP Riccati
    kernel in interpret mode takes 100-250 s a solve here).

    Iteration by iteration: from each of the port's iterates, one
    iteration of the port and one of the JAX package (resumed from the
    same state) give identical converged and failed masks, controls
    within 1e-8 and costs within 1e-10; chained, the port's iterations
    are its whole solve bit for bit. Whole solves: identical masks, and
    the same gates on every lane whose solve took the JAX solve's path
    (its cost after each iteration within 1e-10). A lane can part: where
    a release is pushed to its bound q_max, ubar + (q_max - ubar) lands
    on q_max or one ulp below it, and the boxQP (the same projected Newton
    in both packages, from 0 inside [lo, hi]) stalls at the one-ulp gap,
    so the two packages' arithmetic orders (torch's and XLA's) send the
    lane along different paths to different converged points (3 of the
    128 lanes here, their costs within 4e-6 of each other); at least 9 in
    10 lanes must keep the JAX solve's path."""
    from tfmpc_tpu.solvers import ilqr_batched as jib
    from tfmpc_tpu_torch.solvers import ilqr_batched as tib

    jenv, tenv = _cascade()
    x0, T, iters = tue.cascade_x0(128), 8, 10
    kw = dict(atol=1e-5, boxqp=True)
    one = ilqr.ILQRConfig(**kw, max_iterations=1, use_pallas=True)
    jone = jilqr.ILQRConfig(**kw, max_iterations=1, use_pallas=False)
    before = rollout.TRAJ_PLAIN_CALLS
    state = tib._initial_state(tenv, torch.as_tensor(x0), None, T, one)
    for it in range(iters):
        start = state._replace(iteration=torch.zeros_like(state.iteration))
        ours = ilqr.solve_batch(tenv, None, config=one, init_state=start)
        theirs = jilqr.solve_batch(jenv, None, config=jone,
                                   init_state=jib.SolverState(*(
                                       jnp.asarray(v.numpy()) for v in start)))
        _gates(ours, theirs, f"iteration {it}")
        state = tib.state_from_result(ours)._replace(
            iteration=state.iteration + 1)
    assert rollout.TRAJ_PLAIN_CALLS > before
    a = rollout.kernel_layout(tenv, state.X, state.U, ilqr.backward(
        *ilqr.derivatives(tenv, state.X, state.U),
        torch.zeros(len(x0), dtype=torch.float64), ilqr.ILQRConfig())[1])
    assert a["env_id"] == USER_STEP_ID
    assert a["source"] == tenv.device_step().source

    res_t, trace_t = ilqr.solve_batch(
        tenv, torch.as_tensor(x0), horizon=T, return_trace=True,
        config=ilqr.ILQRConfig(**kw, max_iterations=iters, use_pallas=True))
    assert torch.equal(res_t.actions, state.U)
    assert torch.equal(res_t.total_cost, state.J)
    res_j, trace_j = jilqr.solve_batch(
        jenv, jnp.asarray(x0), horizon=T, return_trace=True,
        config=jilqr.ILQRConfig(**kw, max_iterations=iters,
                                use_pallas=False))
    same = (np.abs(trace_t.J.numpy() - np.asarray(trace_j.J))
            <= 1e-10 * np.abs(np.asarray(trace_j.J))).all(0)
    _gates(res_t, res_j, "whole solves", lanes=same)
    assert same.mean() >= 0.9, np.nonzero(~same)
    lo, hi = tenv.bounds.low, tenv.bounds.high
    assert bool(((res_t.actions >= lo) & (res_t.actions <= hi)).all())


def _gates(res_t, res_j, what, lanes=slice(None)):
    """Identical converged and failed masks, and on ``lanes`` controls
    within 1e-8 and costs within 1e-10 relative."""
    for f in ("converged", "failed"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f"{what} {f}")
    np.testing.assert_allclose(res_t.actions.numpy()[lanes],
                               np.asarray(res_j.actions)[lanes], rtol=0,
                               atol=1e-8, err_msg=what)
    np.testing.assert_allclose(res_t.total_cost.numpy()[lanes],
                               np.asarray(res_j.total_cost)[lanes],
                               rtol=1e-10, err_msg=what)


def _hold_against_jax(jenv, tenv, x0, box, T, jax_pallas):
    """``box``: whether the env is bounded (its half-width, or True)."""
    B, n = x0.shape
    step = tenv.device_step()
    assert step.env_id == USER_STEP_ID and "UserStep" in step.source
    kw = dict(atol=1e-5, max_iterations=10, boxqp=box is not None)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**kw,
                                                      use_pallas=jax_pallas))
    before = (rollout.TRAJ_PLAIN_CALLS, rollout.COSTS_PLAIN_CALLS)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**kw, use_pallas=True))
    # the line search went through K5's wrapper (AUTO's layout), on the
    # generated step's kernel layout
    assert rollout.TRAJ_PLAIN_CALLS > before[0]
    assert rollout.COSTS_PLAIN_CALLS == before[1]
    a = rollout.kernel_layout(tenv, res_t.states, res_t.actions,
                              ilqr.backward(*ilqr.derivatives(
                                  tenv, res_t.states, res_t.actions),
                                  torch.zeros(B, dtype=torch.float64),
                                  ilqr.ILQRConfig())[1])
    assert a["env_id"] == USER_STEP_ID and a["source"] == step.source
    for f in ("converged", "failed"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-10)
    if box is not None:
        U, lo, hi = res_t.actions, tenv.bounds.low, tenv.bounds.high
        assert bool(((U >= lo) & (U <= hi)).all())
    return res_j


def test_mpc_and_the_mesh_run_the_generated_step():
    """``mpc.run`` and the one-process data-parallel mesh take a user env
    through the same kernel path: K5's wrapper on its generated step, and
    the mesh's solve equals ``solve_batch``'s bit for bit."""
    _, env = _bounded_chain(3)
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(-1.5, 1.5, (4, 3)))
    cfg = ilqr.ILQRConfig(atol=1e-6, max_iterations=10, boxqp=True,
                          use_pallas=True)
    before = rollout.TRAJ_PLAIN_CALLS
    res = mpc.run(env, x0, steps=2, plan_horizon=5, config=cfg)
    assert rollout.TRAJ_PLAIN_CALLS > before
    assert bool(torch.isfinite(res.total_cost).all())
    want = ilqr.solve_batch(env, x0, horizon=5, config=cfg)
    got = mesh.solve_ilqr_sharded(env, x0, horizon=5, config=cfg,
                                  mesh=mesh.make_mesh(devices="cpu"))
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
