"""Checkpoints and trajectory files of the port, against the JAX package's.

Both packages write the same ``.npz`` checkpoint (``utils/checkpoint.py``,
format 1) and the same trajectory CSV. A checkpoint written by either one
resumes in the other; the port resumes through its fused iteration
(``use_pallas=True, fuse_derivatives=True``, whose first linearization is
taken along the STORED trajectory), the JAX package through its XLA path.
Inputs are drawn with numpy from a seed, float64 on the CPU. Resumed
solves: identical converged and failed masks and iteration counts,
controls within 1e-8 (the same float64 algorithm in another rounding
order); the port's fused resume against its split resume: 1e-12.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import ilqr_batched as jbatched
from tfmpc_tpu.utils import checkpoint as jcheckpoint
from tfmpc_tpu.utils.trajectory import Trajectory as JTrajectory
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched
from tfmpc_tpu_torch.utils import checkpoint
from tfmpc_tpu_torch.utils.trajectory import Trajectory

GOAL = [8.0, -5.0]
ZONE = {"center": [[3.0, -2.0]], "decay": [2.0]}
B, T = 128, 20
FULL = dict(atol=1e-5, max_iterations=40)
FUSED = dict(FULL, use_pallas=True, fuse_derivatives=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    return (jax_make_navigation(GOAL, ZONE, dtype=jnp.float64),
            make_navigation(GOAL, ZONE, dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def jax_state(envs):
    """A JAX solve stopped after one iteration."""
    x0 = np.random.default_rng(0).uniform(-8.0, 8.0, (B, 2))
    res = jilqr.solve_batch(envs[0], jnp.asarray(x0), horizon=T,
                            config=jilqr.ILQRConfig(atol=1e-5,
                                                    max_iterations=1))
    return jbatched.state_from_result(res)


def _assert_same_solve(res_t, res_j):
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


def _resume_both(envs, path):
    """Resume the checkpoint at ``path`` in both packages: the port's fused
    and split iterations, the JAX package's XLA path."""
    jenv, tenv = envs
    res_j = jbatched.resume(jenv, jcheckpoint.load_state(path),
                            config=jilqr.ILQRConfig(**FULL))
    state = checkpoint.load_state(path, device="cpu")
    res_f = ilqr_batched.resume(tenv, state, config=ilqr.ILQRConfig(**FUSED))
    res_s = ilqr_batched.resume(tenv, state, config=ilqr.ILQRConfig(**FULL))
    return res_f, res_s, res_j


def _assert_fused_is_split(res_f, res_s):
    for name in ("converged", "failed", "iterations"):
        assert torch.equal(getattr(res_f, name), getattr(res_s, name))
    np.testing.assert_allclose(res_f.actions.numpy(), res_s.actions.numpy(),
                               rtol=1e-12, atol=1e-12)


def test_jax_checkpoint_resumes_in_the_port(envs, jax_state, tmp_path):
    path = jcheckpoint.save_state(str(tmp_path / "jax.npz"), jax_state)
    res_f, res_s, res_j = _resume_both(envs, path)
    _assert_same_solve(res_f, res_j)
    _assert_fused_is_split(res_f, res_s)
    assert bool(res_f.converged.all())
    assert int(res_f.iterations.max()) >= 2


def test_port_checkpoint_resumes_in_jax(envs, tmp_path):
    """A port solve through the fused iteration, stopped after one
    iteration, saved by the port and resumed by both; the file holds the
    JAX package's keys and dtypes."""
    _, tenv = envs
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(-8, 8, (B, 2)))
    res = ilqr.solve_batch(tenv, x0, horizon=T, config=ilqr.ILQRConfig(
        **dict(FUSED, max_iterations=1)))
    path = checkpoint.save_state(str(tmp_path / "port" / "ckpt.npz"),
                                 ilqr_batched.state_from_result(res))
    jstate = jcheckpoint.load_state(path)
    ref = jcheckpoint.save_state(str(tmp_path / "ref.npz"), jstate)
    with np.load(path) as ours, np.load(ref) as theirs:
        assert sorted(ours.files) == sorted(theirs.files)
        for key in ours.files:
            assert ours[key].dtype == theirs[key].dtype, key
            np.testing.assert_array_equal(ours[key], theirs[key])
    res_f, res_s, res_j = _resume_both(envs, path)
    _assert_same_solve(res_f, res_j)
    _assert_fused_is_split(res_f, res_s)


def test_resume_linearizes_the_stored_trajectory(envs, jax_state, tmp_path):
    """A stored X that is not ``rollout(x0, U)``: the fused iteration's
    first linearization is taken along it (``_initial_kargs``), as the
    split iteration's and the JAX package's are."""
    noise = np.random.default_rng(2).normal(
        scale=0.05, size=np.asarray(jax_state.X).shape)
    noise[:, 0] = 0.0
    X = np.asarray(jax_state.X) + noise
    state = jax_state._replace(X=jnp.asarray(X))
    path = jcheckpoint.save_state(str(tmp_path / "off.npz"), state)
    res_f, res_s, res_j = _resume_both(envs, path)
    _assert_same_solve(res_f, res_j)
    _assert_fused_is_split(res_f, res_s)
    # the deviation is real: resuming from the re-rolled X ends elsewhere
    rolled = jax_state._replace(
        X=jnp.asarray(envs[1].rollout(torch.as_tensor(X[:, 0]),
                                      torch.as_tensor(np.array(
                                          jax_state.U)))[0].numpy()))
    path2 = jcheckpoint.save_state(str(tmp_path / "rolled.npz"), rolled)
    res_r = ilqr_batched.resume(envs[1],
                                checkpoint.load_state(path2, device="cpu"),
                                config=ilqr.ILQRConfig(**FUSED))
    assert float((res_r.actions - res_f.actions).abs().max()) > 1e-6


def test_roundtrip_is_exact(envs, jax_state, tmp_path):
    path = jcheckpoint.save_state(str(tmp_path / "a.npz"), jax_state)
    state = checkpoint.load_state(path, device="cpu")
    again = checkpoint.load_state(
        checkpoint.save_state(str(tmp_path / "b.npz"), state), device="cpu")
    for name in state._fields:
        ours, theirs = getattr(again, name), getattr(state, name)
        assert ours.dtype == theirs.dtype and torch.equal(ours, theirs), name
        np.testing.assert_array_equal(ours.numpy(),
                                      np.asarray(getattr(jax_state, name)))
    assert state.iteration.dtype == torch.int32
    assert state.converged.dtype == torch.bool
    # the card unless the caller asks for the CPU
    assert inspect.signature(checkpoint.load_state).parameters[
        "device"].default == "cuda"


def _rewrite(src, dst, **changes):
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    for key, value in changes.items():
        if value is None:
            del arrays[key]
        else:
            arrays[key] = value
    with open(dst, "wb") as f:
        np.savez(f, **arrays)
    return str(dst)


REJECTIONS = {
    "newer_format": (dict(__tfmpc_meta__=np.array([2, B, T, 2, 2])),
                     "newer"),
    "missing_field": (dict(mu=None), "missing fields"),
    "metadata_shapes": (dict(__tfmpc_meta__=np.array([1, B, T + 1, 2, 2])),
                        "metadata"),
    "recorded_dtype": (dict(__dtype__=np.array("float32")), "dtype"),
    "batch_axis": (dict(mu=np.zeros(B + 1)), "inconsistent"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_load_rejects_a_bad_file(jax_state, tmp_path, case):
    changes, match = REJECTIONS[case]
    good = jcheckpoint.save_state(str(tmp_path / "good.npz"), jax_state)
    bad = _rewrite(good, tmp_path / "bad.npz", **changes)
    with pytest.raises(ValueError, match=match):
        checkpoint.load_state(bad, device="cpu")
    with pytest.raises(ValueError, match=match):
        jcheckpoint.load_state(bad)


@pytest.mark.parametrize("case", ["sizes", "dtype"])
def test_validate_rejects_the_wrong_env(jax_state, tmp_path, case):
    """A state for other state/action sizes, or in another dtype than the
    env's parameters, cannot resume; ``resume`` runs the same check."""
    path = jcheckpoint.save_state(str(tmp_path / "s.npz"), jax_state)
    state = checkpoint.load_state(path, device="cpu")
    if case == "sizes":
        env = make_navigation([1.0, 2.0, 3.0], None, dtype=torch.float64,
                              device="cpu")
    else:
        env = make_navigation(GOAL, ZONE, dtype=torch.float32, device="cpu")
    match = "sizes" if case == "sizes" else "float"
    with pytest.raises(ValueError, match=match):
        checkpoint.validate_state(state, env)
    with pytest.raises(ValueError, match=match):
        ilqr_batched.resume(env, state, config=ilqr.ILQRConfig(**FUSED))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trajectory_matches_jax(dtype, tmp_path):
    """``Trajectory`` of one scenario of a port solve: the same CSV text,
    table and totals as the JAX package's ``Trajectory`` of the same
    arrays."""
    env = make_navigation(GOAL, ZONE, dtype=dtype, device="cpu")
    x0 = torch.as_tensor(np.random.default_rng(3).uniform(-5, 5, (4, 2)),
                         dtype=dtype)
    res = ilqr.solve_batch(env, x0, horizon=6, config=ilqr.ILQRConfig(
        **FUSED))
    ours = Trajectory.from_result(res, index=2)
    theirs = JTrajectory(res.states[2].numpy(), res.actions[2].numpy(),
                         res.costs[2].numpy())
    a = ours.save(str(tmp_path / "port" / "traj.csv"))
    b = theirs.save(str(tmp_path / "jax.csv"))
    assert open(a).read() == open(b).read()
    assert repr(ours) == repr(theirs)
    assert len(ours) == len(theirs) == 6
    assert ours.total_cost == theirs.total_cost
    np.testing.assert_array_equal(ours.final_state, theirs.final_state)
    with pytest.raises(ValueError, match="single scenario"):
        Trajectory(res.states, res.actions, res.costs)


def test_config_file_round_trip_keeps_fused_options():
    """The fused options carry over between the packages' configs."""
    from tfmpc_tpu_torch import interop

    jcfg = jilqr.ILQRConfig(**FUSED)
    assert dataclasses.asdict(interop.config_from_dict(
        dataclasses.asdict(jcfg))) == dataclasses.asdict(jcfg)
