"""The port's data-parallel mesh (``tfmpc_tpu_torch/parallel/mesh.py``)
against ``solve_batch``, ``mpc.run`` and the JAX package's ``summarize``.

One process is a mesh of one device: ``solve_ilqr_sharded`` and
``mpc_sharded`` are the batched solves themselves, bit for bit. A real
two-process gloo group on the CPU (``torch_mp.run_group``, 120 s deadline)
splits 16 navigation scenarios in halves: each rank's lanes must equal the
one-process solve's bit for bit, and both ranks' ``summarize`` the
one-process one within 1e-12 relative. The kernels' wrappers run their
plain versions on CPU tensors (``use_pallas=True``).
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu.parallel import mesh as jmesh
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.parallel import mesh
from tfmpc_tpu_torch.solvers import ilqr, mpc

import torch_mp

REPO = Path(__file__).resolve().parents[1]
NAV = json.loads((REPO / "configs/navigation.json").read_text())
T = 12
B = 16
CFG = dict(atol=1e-6, max_iterations=30, use_pallas=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0(dtype=np.float64):
    return np.random.default_rng(3).uniform(-10.0, 10.0, (B, 2)).astype(dtype)


def _env(dtype=torch.float64):
    return make_env(NAV, dtype=dtype, device="cpu")


def _one_process_mesh():
    return mesh.make_mesh(devices="cpu")


def _assert_identical(got, want):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def test_one_process_mesh():
    m = _one_process_mesh()
    assert (m.group, m.size, m.rank, m.device) == (None, 1, 0,
                                                  torch.device("cpu"))
    assert (mesh.DATA_AXIS, mesh.TIME_AXIS) == ("data", "time")
    with pytest.raises(ValueError, match="1 to 1 processes"):
        mesh.make_mesh(2, devices="cpu")
    with pytest.raises(ValueError, match="1 to 1 processes"):
        mesh.make_mesh(0, devices="cpu")


def test_shard_batch_places_and_checks_divisibility():
    """One process passes the global batch, which must divide by the
    axis's size: a mesh of one process has size 1, so a two-device axis
    description reaches the JAX package's check and message."""
    m = _one_process_mesh()
    x = mesh.shard_batch(np.ones((3, 2), np.float32), m)
    assert x.device.type == "cpu" and x.shape == (3, 2)
    two = dataclasses.replace(m, size=2)
    with pytest.raises(ValueError, match="batch size 3 must be divisible by "
                                         "the 2-device data axis"):
        mesh.shard_batch(np.ones((3, 2)), two)
    assert mesh.shard_batch(np.ones((4, 2)), two).shape == (4, 2)
    with pytest.raises(ValueError, match="not on the mesh's data axis"):
        mesh.shard_batch(np.ones((4, 2)), dataclasses.replace(m, rank=None))


def test_replicate_moves_nested_tensors():
    env = make_env(json.loads(
        (REPO / "configs/navigation_bounded.json").read_text()),
        dtype=torch.float64, device="cpu")
    out = mesh.replicate(env, _one_process_mesh())
    assert type(out) is type(env) and out.bounds is not None
    assert torch.equal(out.bounds.low, env.bounds.low)
    assert torch.equal(out.goal, env.goal)
    assert mesh.replicate("not a dataclass", _one_process_mesh()) == \
        "not a dataclass"


def test_sharded_solve_is_solve_batch_with_the_trace_layout():
    env, x0 = _env(), torch.as_tensor(_x0())
    cfg = ilqr.ILQRConfig(**CFG)
    want = ilqr.solve_batch(env, x0, horizon=T, config=cfg)
    got = mesh.solve_ilqr_sharded(env, x0, horizon=T, config=cfg,
                                  mesh=_one_process_mesh())
    _assert_identical(got, want)
    got, trace = mesh.solve_ilqr_sharded(env, x0, horizon=T, config=cfg,
                                         mesh=_one_process_mesh(),
                                         return_trace=True)
    _assert_identical(got, want)
    for name in trace._fields:
        assert getattr(trace, name).shape == (cfg.max_iterations, B), name
    rows = torch.arange(B)
    last = (want.iterations - 1).long()
    assert torch.equal(trace.J[last, rows], want.total_cost)


def test_mpc_sharded_is_mpc_run():
    env, x0 = _env(), torch.as_tensor(_x0()[:4])
    cfg = ilqr.ILQRConfig(**CFG)
    want = mpc.run(env, x0, steps=4, plan_horizon=6, config=cfg)
    got = mesh.mpc_sharded(env, x0, steps=4, plan_horizon=6, config=cfg,
                           mesh=_one_process_mesh())
    _assert_identical(got, want)


def test_summarize_matches_jax():
    """The JAX package's ``summarize`` of its solve of the same float64
    inputs (its XLA path on the 8 virtual CPU devices) against the port's
    of its own solve: the seven statistics within 1e-9."""
    x0 = _x0()
    jres = jmesh.solve_ilqr_sharded(
        jax_make_env(NAV, dtype=jnp.float64), jnp.asarray(x0), horizon=T,
        config=jilqr.ILQRConfig(**dict(CFG, use_pallas=False)))
    theirs = {k: float(v) for k, v in jmesh.summarize(jres).items()}
    ours = mesh.summarize(mesh.solve_ilqr_sharded(
        _env(), x0, horizon=T, config=ilqr.ILQRConfig(**CFG),
        mesh=_one_process_mesh()))
    assert set(ours) == set(theirs)
    assert isinstance(ours["num_converged"], int)
    assert isinstance(ours["max_iterations"], int)
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-9, err_msg=key)


def _cli(argv):
    import contextlib
    import io

    from tfmpc_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def test_two_process_gloo_group_matches_one_process(tmp_path):
    """Two processes of a real gloo group each solve 8 of the 16 scenarios;
    each lane equals the one-process solve's bit for bit, and both ranks'
    ``summarize`` equals the one-process statistics within 1e-12 relative.
    A cap of one process (``make_mesh(1)``) leaves rank 1 off the axis.
    The same group then runs the command line (float32, the CLI's own
    inputs): the batched ``ilqr``, whose rank 0 prints the one-process
    line and whose two ranks' CSVs are the one-process CLI's files; the
    ``mpc`` fleet of 4, split over the ranks, whose line and CSVs are the
    one-process fleet's; and a fleet of 3, which the two ranks do not
    divide, so each runs it whole on its own device, as the JAX CLI runs
    such a fleet on one device."""
    x0 = _x0()
    nav = ["--env", str(REPO / "configs/navigation.json"), "--device", "cpu"]
    ilqr_argv = ["ilqr", *nav, "-T", str(T), "--num-samples", str(B)]
    mpc_argv = ["mpc", *nav, "--steps", "3", "--plan-horizon", "6"]
    argvs = [ilqr_argv + ["--logdir", str(tmp_path / "two")],
             mpc_argv + ["--num-samples", "4", "--logdir",
                         str(tmp_path / "two_mpc")],
             mpc_argv + ["--num-samples", "3"]]
    payload = dict(env=NAV, dtype="float64", x0=x0, horizon=T, config=CFG,
                   argvs=argvs)
    outs = torch_mp.run_group(torch_mp.solve_rows, payload)

    want = ilqr.solve_batch(_env(), torch.as_tensor(x0), horizon=T,
                            config=ilqr.ILQRConfig(**CFG))
    stats = mesh.summarize(want)
    for rank, out in enumerate(outs):
        assert out["mesh"] == (2, rank)
        assert out["capped"] == (1, 0 if rank == 0 else None)
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        for name in want._fields:
            np.testing.assert_array_equal(
                out["result"][name], getattr(want, name)[rows].numpy(),
                err_msg=f"rank {rank} {name}")
        assert out["trace_J"].shape == (CFG["max_iterations"], B // 2)
        assert out["stats"].keys() == stats.keys()
        for key, value in stats.items():
            np.testing.assert_allclose(out["stats"][key], value, rtol=1e-12,
                                       err_msg=f"rank {rank} {key}")
        assert [rc for rc, _ in out["cli"]] == [0, 0, 0]
        if rank == 1:
            assert all(text == "" for _, text in out["cli"])

    two = [text.splitlines() for _, text in outs[0]["cli"]]
    rc, one = _cli(ilqr_argv + ["--logdir", str(tmp_path / "one")])
    one = one.splitlines()
    assert two[0][0] == one[0].replace("on 1 device(s)", "on 2 device(s)")
    assert two[0][1] == one[1].replace("/one", "/two")
    rc, one_mpc = _cli(mpc_argv + ["--num-samples", "4", "--logdir",
                                   str(tmp_path / "one_mpc")])
    one_mpc = one_mpc.splitlines()
    assert two[1][0] == one_mpc[0].replace("on 1 device(s)",
                                           "on 2 device(s)")
    assert two[2] == _cli(mpc_argv + ["--num-samples", "3"])[1].splitlines()
    assert "fleet of 3 on 1 device(s)" in two[2][0]
    for ours, theirs, count in (("one", "two", B), ("one_mpc", "two_mpc", 4)):
        names = sorted(p.name for p in (tmp_path / ours).iterdir())
        assert names == sorted(p.name for p in (tmp_path / theirs).iterdir())
        assert len(names) == count
        for name in names:
            assert (tmp_path / ours / name).read_text() == \
                (tmp_path / theirs / name).read_text(), name
