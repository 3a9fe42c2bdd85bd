"""The port's time-sharded solves (``parallel/mesh.py``: ``make_mesh_2d``,
``shard_problem_time``, ``solve_lqr_time_sharded``,
``solve_ilqr_time_sharded``; ``lqr_parallel.py``'s split horizon) against
the JAX package's and against the port's one-process solves, in float64.

A real gloo group of eight CPU processes (``torch_mp.run_group``) builds
a 2x4 ``("data", "time")`` mesh, so each data rank's four processes split
the horizon (T + 1 elements in blocks of unequal length), and a 2x2 mesh
on the first four processes for a data x time batch. Every case runs on
both data ranks, which must agree with each other and with the
references: the split backward with the one-process ``backward_parallel``
and the parallel iLQR backward variants within 1e-10; the solves with the
JAX package's time-sharded solves (its GSPMD path on the 8 virtual CPU
devices) and the port's one-process parallel-backward solve, with the same
converged masks and iteration counts and actions within 1e-6. A mesh of
one process is the unsplit solve bit for bit.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_mp
from test_torch_lqr import both, lqr_arrays
from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu.parallel import mesh as jmesh
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.core.types import (
    Bounds, LinearModel, LQRProblem, QuadraticFinal, QuadraticModel)
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.parallel import mesh
from tfmpc_tpu_torch.solvers import ilqr, lqr, lqr_parallel

REPO = Path(__file__).resolve().parents[1]
NAV = json.loads((REPO / "configs/navigation.json").read_text())
RESERVOIR = json.loads((REPO / "configs/reservoir.json").read_text())
WORLD = 8
# ~10 s alone; eight children beside the suite's other workers share the
# CPU, so the group gets more than torch_mp's default deadline
GROUP_DEADLINE_S = 300.0
SPLIT_TOL = dict(rtol=1e-10, atol=1e-10)
ACTIONS_ATOL = 1e-6

NAV_CFG = dict(atol=1e-5, parallel_backward=True)
# name -> (env config, x0, horizon, config, mesh, split the rows over the
# data axis); the JAX package's tests/test_distributed.py cases
SOLVES = {
    "navigation_single": (NAV, np.zeros(2), 64,
                          dict(NAV_CFG, max_iterations=60), (2, 4), False),
    "navigation_batched": (
        NAV, np.random.default_rng(5).uniform(-4, 4, (3, 2)), 32,
        dict(NAV_CFG, max_iterations=40), (2, 4), False),
    "reservoir5_boxqp": (
        RESERVOIR, np.array([95.0, 80.0, 60.0, 40.0, 20.0]), 64,
        dict(atol=1e-3, max_iterations=40, boxqp=True,
             parallel_backward=True), (2, 4), False),
    "data_x_time": (
        NAV, np.random.default_rng(7).uniform(-4, 4, (4, 2)), 32,
        dict(NAV_CFG, max_iterations=40), (2, 2), True),
}


def _lqr_problem(T, seed):
    return dict(zip(("F", "f", "C", "c", "C_f", "c_f"),
                    lqr_arrays(4, 2, T, seed=seed)))


def _derivatives(T=37, B=2):
    """Reservoir-5 linearizations along a random trajectory, and a mu that
    makes the first lane's regularized Q_uu indefinite at no step."""
    env = make_env(RESERVOIR, dtype=torch.float64, device="cpu")
    g = torch.Generator().manual_seed(11)
    X = 100 * torch.rand((B, T + 1, 5), generator=g, dtype=torch.float64)
    U = 50 * torch.rand((B, T, 5), generator=g, dtype=torch.float64)
    lin, quad, final = ilqr.derivatives(env, X, U)
    fields = lambda d: {f.name: getattr(d, f.name).numpy()  # noqa: E731
                        for f in dataclasses.fields(d)}
    return dict(lin=fields(lin), quad=fields(quad), final=fields(final),
                mu=np.array([1e-3, 0.0]), Ubar=U.numpy(),
                bounds=fields(env.bounds))


CASES = [
    dict(name="backward_T37", kind="backward", mesh=(2, 4),
         problem=_lqr_problem(37, 37)),
    # T + 1 = 4 elements over 4 ranks: the last holds only the terminal
    dict(name="backward_T3", kind="backward", mesh=(2, 4),
         problem=_lqr_problem(3, 3)),
    dict(name="ilqr_backward", kind="ilqr_backward", mesh=(2, 4),
         **_derivatives()),
    dict(name="lqr", kind="lqr", mesh=(2, 4), problem=_lqr_problem(64, 64),
         x0=np.array([1.0, -2.0, 0.5, 0.0])),
] + [dict(name=name, kind="ilqr", env=env, x0=x0, horizon=T, config=cfg,
          mesh=shape, split_rows=split)
     for name, (env, x0, T, cfg, shape, split) in SOLVES.items()]


@pytest.fixture(scope="module")
def group():
    """Every case on the eight-process gloo group: the ranks' results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield torch_mp.run_group(
            torch_mp.time_sharded,
            dict(meshes=[(2, 4), (2, 2)], cases=CASES), world=WORLD,
            deadline=GROUP_DEADLINE_S)
    finally:
        torch.set_num_threads(n)


def _ranks(group, name):
    """The ranks that ran ``name`` (on its mesh), and their results."""
    return [(r, out[name]) for r, out in enumerate(group)
            if out[name] is not None]


def test_mesh_layout(group):
    """rank = d * n_time + t, as the JAX function reshapes its devices;
    the processes past a mesh get no place on it."""
    for rank, out in enumerate(group):
        assert out["layout"][(2, 4)] == (rank // 4, rank % 4, 4)
        assert out["layout"][(2, 2)] == ((rank // 2, rank % 2, 2)
                                         if rank < 4 else (None, None, None))
    for case in CASES:
        ranks = [r for r, _ in _ranks(group, case["name"])]
        assert ranks == list(range(case["mesh"][0] * case["mesh"][1]))


@pytest.mark.parametrize("name", ["backward_T37", "backward_T3"])
def test_split_backward_matches_one_process(group, name):
    case = next(c for c in CASES if c["name"] == name)
    problem = LQRProblem(**torch_mp._tensors(case["problem"]))
    policy, value = lqr_parallel.backward_parallel(problem)
    want = dict(K=policy.K, k=policy.k, V_xx=value.V_xx, v_x=value.v_x)
    for rank, out in _ranks(group, name):
        for key, value in want.items():
            np.testing.assert_allclose(out[key], value.numpy(), **SPLIT_TOL,
                                       err_msg=f"rank {rank} {key}")


def test_split_ilqr_backward_variants_match_one_process(group):
    case = next(c for c in CASES if c["name"] == "ilqr_backward")
    t = {k: torch_mp._tensors(case[k]) for k in ("lin", "quad", "final", "bounds")}
    lin = LinearModel(**t["lin"])
    quad = QuadraticModel(**t["quad"])
    final = QuadraticFinal(**t["final"])
    mu, Ubar = torch.as_tensor(case["mu"]), torch.as_tensor(case["Ubar"])
    want = {}
    for name, (ok, policy, dV1, dV2) in (
            ("plain", lqr_parallel.ilqr_backward_parallel(lin, quad, final,
                                                          mu)),
            ("boxqp", lqr_parallel.ilqr_backward_parallel_boxqp(
                lin, quad, final, mu, Bounds(**t["bounds"]),
                Ubar))):
        want.update({f"{name}_ok": ok, f"{name}_K": policy.K,
                     f"{name}_k": policy.k, f"{name}_dV1": dV1,
                     f"{name}_dV2": dV2})
    assert bool(want["plain_ok"].all()) and bool(want["boxqp_ok"].all())
    for rank, out in _ranks(group, "ilqr_backward"):
        for key, value in want.items():
            if key.endswith("_ok"):
                np.testing.assert_array_equal(out[key], value.numpy())
            else:
                np.testing.assert_allclose(out[key], value.numpy(),
                                           **SPLIT_TOL,
                                           err_msg=f"rank {rank} {key}")


def test_lqr_time_sharded_matches_jax_and_one_process(group):
    """The counterpart of tests/test_distributed.py's LQR case: a 2x4
    mesh on both packages, against each other and the one-process
    sequential and parallel solves."""
    case = next(c for c in CASES if c["name"] == "lqr")
    arrays = tuple(case["problem"][k] for k in ("F", "f", "C", "c", "C_f",
                                                "c_f"))
    jp, tp = both(arrays)
    x0 = torch.as_tensor(case["x0"])
    theirs = jmesh.solve_lqr_time_sharded(jp, jnp.asarray(case["x0"]),
                                          mesh=jmesh.make_mesh_2d(2, 4))
    seq = lqr.solve(tp, x0)
    par = lqr.solve(tp, x0, parallel=True)
    blocks = []
    for rank, out in _ranks(group, "lqr"):
        for i, key in enumerate(("states", "actions", "costs")):
            np.testing.assert_allclose(out[key], np.asarray(theirs[i]),
                                       rtol=1e-8, atol=1e-8, err_msg=key)
            np.testing.assert_allclose(out[key], seq[i].numpy(), rtol=1e-8,
                                       atol=1e-8, err_msg=key)
            np.testing.assert_allclose(out[key], par[i].numpy(),
                                       **SPLIT_TOL, err_msg=key)
        blocks.append(out["block_F"])
    # shard_problem_time: the time ranks' blocks tile the horizon
    np.testing.assert_array_equal(np.concatenate(blocks[:4]), arrays[0])
    assert [b.shape[0] for b in blocks[:4]] == [17, 16, 16, 15]


def _jax_solve(env_cfg, x0, T, cfg, shape):
    env = jax_make_env(env_cfg, dtype=jnp.float64)
    config = jilqr.ILQRConfig(**cfg)
    if shape == (2, 2):  # data x time: the batch over the data axis
        m = jmesh.make_mesh_2d(2, 4)
        return jmesh.solve_ilqr_time_sharded(
            env, jmesh.shard_batch(jnp.asarray(x0), m), horizon=T,
            config=config, mesh=m)
    import jax

    return jmesh.solve_ilqr_time_sharded(
        env, jnp.asarray(x0), horizon=T, config=config,
        mesh=JMesh(np.asarray(jax.devices()), (jmesh.TIME_AXIS,)))


@pytest.mark.parametrize("name", list(SOLVES))
def test_ilqr_time_sharded_matches_jax_and_one_process(group, name):
    env_cfg, x0, T, cfg, shape, split = SOLVES[name]
    env = make_env(env_cfg, dtype=torch.float64, device="cpu")
    config = ilqr.ILQRConfig(**cfg)
    x0_t = torch.as_tensor(x0)
    one = (ilqr.solve if x0.ndim == 1 else ilqr.solve_batch)(
        env, x0_t, horizon=T, config=config)
    theirs = _jax_solve(env_cfg, x0, T, cfg, shape)
    assert bool(torch.as_tensor(one.converged).all())
    ranks = _ranks(group, name)
    for rank, out in ranks:
        rows = ...
        if split:
            n = x0.shape[0] // shape[0]
            d = rank // shape[1]
            rows = slice(d * n, (d + 1) * n)
        for ref, label in ((one, "one process"), (theirs, "JAX")):
            for key in ("converged", "iterations"):
                np.testing.assert_array_equal(
                    out[key], np.asarray(getattr(ref, key))[rows],
                    err_msg=f"rank {rank} {key} vs {label}")
            np.testing.assert_allclose(
                out["actions"], np.asarray(ref.actions)[rows], rtol=0,
                atol=ACTIONS_ATOL, err_msg=f"rank {rank} actions vs {label}")
    # the ranks of a time axis return the same solve, bit for bit
    for (r0, first), (r, out) in zip(ranks, ranks[1:]):
        if r // shape[1] == r0 // shape[1]:
            for key in first:
                np.testing.assert_array_equal(out[key], first[key])


def test_one_process_mesh_is_the_unsplit_solve():
    """Without a group, ``make_mesh_2d(1, 1)``: the time-sharded solves are
    the one-process parallel-backward solves bit for bit, and
    ``shard_problem_time`` the whole problem."""
    m = mesh.make_mesh_2d(1, 1, devices="cpu")
    assert m.time == lqr_parallel.TimeAxis(group=None, size=1, rank=0)
    env = make_env(NAV, dtype=torch.float64, device="cpu")
    cfg = ilqr.ILQRConfig(atol=1e-5, max_iterations=30, use_pallas=True)
    plain = dataclasses.replace(cfg, parallel_backward=True,
                                use_pallas=False)
    x0 = torch.tensor([1.0, -1.0], dtype=torch.float64)
    got = mesh.solve_ilqr_time_sharded(env, x0, horizon=20, config=cfg,
                                       mesh=m)
    want = ilqr.solve(env, x0, horizon=20, config=plain)
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    xb = torch.stack([x0, -x0])
    got, trace = mesh.solve_ilqr_time_sharded(env, xb, horizon=20,
                                              config=cfg, mesh=m,
                                              return_trace=True)
    want, want_trace = ilqr.solve_batch(env, xb, horizon=20, config=plain,
                                        return_trace=True)
    for a, b in zip(got + trace, want + want_trace):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="return_trace needs the batched"):
        mesh.solve_ilqr_time_sharded(env, x0, horizon=20, config=cfg,
                                     mesh=m, return_trace=True)

    _, tp = both(lqr_arrays(3, 2, 12, seed=5))
    x0 = torch.ones(3, dtype=torch.float64)
    for a, b in zip(mesh.solve_lqr_time_sharded(tp, x0, mesh=m),
                    lqr.solve(tp, x0, parallel=True)):
        assert torch.equal(a, b)
    assert mesh.shard_problem_time(tp, m).F is tp.F
    assert mesh.make_mesh_2d(1, 1, devices="cpu") == m
    # without a group only (1, 1) exists; a 1-D mesh has no time axis
    for shape in ((2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="this process has no group"):
            mesh.make_mesh_2d(*shape, devices="cpu")
    with pytest.raises(ValueError, match="without a time axis"):
        mesh.solve_lqr_time_sharded(tp, x0, mesh=mesh.make_mesh(
            devices="cpu"))


def test_time_axis_needs_an_active_mesh():
    """``ILQRConfig(time_axis="time")`` constructs; a parallel-backward
    solve with it needs an active time mesh (``set_mesh``) and the axis
    name ``"time"``; without ``parallel_backward`` it is unused, as in the
    JAX package."""
    env = make_env(NAV, dtype=torch.float64, device="cpu")
    x0 = torch.zeros(2, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(time_axis="time", parallel_backward=True,
                          max_iterations=3)
    with pytest.raises(ValueError, match="solve_ilqr_time_sharded"):
        ilqr.solve(env, x0, horizon=8, config=cfg)
    with pytest.raises(ValueError, match="solve_ilqr_time_sharded"):
        ilqr.solve_batch(env, x0[None], horizon=8, config=cfg)
    with mesh.set_mesh(mesh.make_mesh_2d(1, 1, devices="cpu")):
        assert lqr_parallel.active_time_axis().size == 1
        got = ilqr.solve(env, x0, horizon=8, config=cfg)
        with pytest.raises(ValueError, match="named 'time'"):
            ilqr.solve(env, x0, horizon=8, config=dataclasses.replace(
                cfg, time_axis="horizon"))
    assert lqr_parallel.active_time_axis() is None
    want = ilqr.solve(env, x0, horizon=8, config=dataclasses.replace(
        cfg, time_axis=None))
    assert torch.equal(got.actions, want.actions)
    unused = ilqr.solve(env, x0, horizon=8, config=ilqr.ILQRConfig(
        time_axis="time", max_iterations=3))
    assert unused.actions.shape == (8, 2)
