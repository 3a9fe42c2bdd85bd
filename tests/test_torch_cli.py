"""The port's command line (``tfmpc_tpu_torch/cli.py``) against the JAX
package's, and the port's package API against the JAX package's.

Each case runs the JAX CLI (``CliRunner`` on ``tfmpc_tpu.cli.cli``, its
XLA path on the 8 virtual CPU devices of ``conftest.py``) and the port's
``cli.main([..., "--device", "cpu"])`` on the same config at small sizes
(T <= 20, <= 16 samples, mpc 5 steps of horizon 8), both in float32 from
the same numpy-made inputs, parses the printed figures and holds them
against each other (the batched solve's options and ``mpc`` are in
``test_torch_cli_options.py``, to keep each file's JAX compiles under a
minute): exit codes and converged counts equal, costs within
1e-4 relative, mean iterations within 1 (measured equal in every case).
``lqr`` draws its problem from a ``torch.Generator`` (another problem
than the JAX CLI's ``PRNGKey`` draws), so it is held against the port's
own ``lqr.solve`` on ``make_lqr(torch.Generator().manual_seed(seed),
...)``.
"""

import contextlib
import io
import json
import logging
import re
import subprocess
import sys
import tomllib
import types
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from click.testing import CliRunner

import tfmpc_tpu
import tfmpc_tpu_torch
import torch_mp
from tfmpc_tpu.cli import cli as jax_cli
from tfmpc_tpu.utils.trajectory import Trajectory as JTrajectory
from tfmpc_tpu_torch import cli
from tfmpc_tpu_torch.models.problems import make_lqr
from tfmpc_tpu_torch.solvers import lqr
from tfmpc_tpu_torch.utils.trajectory import Trajectory

REPO = Path(__file__).resolve().parents[1]
NAV = str(REPO / "configs/navigation.json")
NAV_BOUNDED = str(REPO / "configs/navigation_bounded.json")
RTOL = 1e-4

SINGLE = re.compile(r"converged=(True|False) iterations=(\d+) "
                    r"total_cost=(\S+) residual=(\S+)")
BATCHED = re.compile(r"solved (\d+) scenarios on \d+ device\(s\): "
                     r"(\d+)/(\d+) converged, mean_cost=(\S+) "
                     r"mean_iterations=(\S+)")
MPC = re.compile(r"closed-loop total_cost=(\S+) replans_converged=(\d+)/(\d+) "
                 r"mean_replan_iterations=(\S+)")
FLEET = re.compile(r"closed-loop fleet of (\d+) on \d+ device\(s\): "
                   r"mean_total_cost=(\S+) replans_converged=(\d+)/(\d+) "
                   r"mean_replan_iterations=(\S+)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_log_levels():
    """``-v`` sets the packages' logger levels; put them back."""
    loggers = [logging.getLogger(n) for n in ("tfmpc_tpu", "tfmpc_tpu_torch")]
    levels = [lg.level for lg in loggers]
    yield
    for lg, level in zip(loggers, levels):
        lg.setLevel(level)


def run_jax(args):
    res = CliRunner().invoke(jax_cli, args)
    if res.exception is not None and not isinstance(res.exception,
                                                    SystemExit):
        raise res.exception
    return res.exit_code, res.output


def run_port(args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([*args, "--device", "cpu"])
    return rc, out.getvalue() + err.getvalue()


def run_both(args):
    (rc_j, out_j), (rc_t, out_t) = run_jax(args), run_port(args)
    assert rc_t == rc_j, (out_t, out_j)
    return out_j, out_t


def figures(pattern, text):
    m = pattern.search(text)
    assert m is not None, text
    return m.groups()


def same_costs(ours, theirs):
    np.testing.assert_allclose(float(ours), float(theirs), rtol=RTOL)


def test_single_solve():
    out_j, out_t = run_both(["ilqr", "--env", NAV, "-T", "20"])
    conv_j, it_j, cost_j, _ = figures(SINGLE, out_j)
    conv_t, it_t, cost_t, _ = figures(SINGLE, out_t)
    assert conv_t == conv_j == "True"
    assert abs(int(it_t) - int(it_j)) <= 1
    same_costs(cost_t, cost_j)
    assert out_t.splitlines()[0] == out_j.splitlines()[0]  # Trajectory(...)


def test_single_solve_verbose_logs_each_iteration(caplog):
    """``-v``: the trace-recording batch of one, replayed as one log line
    an iteration under each package's logger."""
    caplog.set_level(logging.INFO)
    out_j, out_t = run_both(["-v", "ilqr", "--env", NAV, "-T", "20"])
    lines = {name: [r.getMessage() for r in caplog.records
                    if r.name == name and r.getMessage().startswith(
                        "iteration=")]
             for name in ("tfmpc_tpu", "tfmpc_tpu_torch")}
    it = int(figures(SINGLE, out_t)[1])
    assert len(lines["tfmpc_tpu_torch"]) == it > 0
    assert abs(len(lines["tfmpc_tpu"]) - it) <= 1
    cost = re.compile(r"cost=(\S+)")
    for ours, theirs in zip(lines["tfmpc_tpu_torch"], lines["tfmpc_tpu"]):
        same_costs(cost.search(ours).group(1), cost.search(theirs).group(1))
    same_costs(figures(SINGLE, out_t)[2], figures(SINGLE, out_j)[2])


def test_batched_verbose_logs_the_mean_lines(caplog):
    """``-v`` with a batch: one line an iteration of the batch's means (the
    ``[I, B]`` trace), the last one at the printed mean cost."""
    caplog.set_level(logging.INFO)
    rc, out = run_port(["-v", "ilqr", "--env", NAV, "-T", "20",
                        "--num-samples", "8"])
    assert rc == 0
    lines = [r.getMessage() for r in caplog.records
             if r.name == "tfmpc_tpu_torch"
             and r.getMessage().startswith("iteration=")]
    assert lines and "frac_converged=1.000" in lines[-1]
    last = re.search(r"mean_cost=(\S+)", lines[-1]).group(1)
    assert last == figures(BATCHED, out)[3]


def test_x0_override():
    out_j, out_t = run_both(["ilqr", "--env", NAV, "-T", "20",
                             "--x0", "[7.0, -4.0]"])
    assert figures(SINGLE, out_t)[0] == figures(SINGLE, out_j)[0]
    same_costs(figures(SINGLE, out_t)[2], figures(SINGLE, out_j)[2])


def read_csv(path):
    header, *rows = path.read_text().splitlines()
    return header, np.genfromtxt(rows, delimiter=",")


def test_batched_solve_writes_the_same_csvs(tmp_path):
    args = ["ilqr", "--env", NAV, "-T", "20", "--num-samples", "16"]
    out_j, out_t = run_both(args + ["--logdir", str(tmp_path / "jax")])
    assert run_port(args + ["--logdir", str(tmp_path / "port")])[0] == 0
    n_j, c_j, _, cost_j, it_j = figures(BATCHED, out_j)
    n_t, c_t, _, cost_t, it_t = figures(BATCHED, out_t)
    assert (n_t, c_t) == (n_j, c_j) == ("16", "16")
    same_costs(cost_t, cost_j)
    assert abs(float(it_t) - float(it_j)) <= 1
    assert out_t.splitlines()[-1] == f"16 trajectories saved to {tmp_path}/jax"
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(names) == 16
    for name in names:
        h_j, v_j = read_csv(tmp_path / "jax" / name)
        h_t, v_t = read_csv(tmp_path / "port" / name)
        assert h_t == h_j == "timestep,state_0,state_1,action_0,action_1,cost"
        np.testing.assert_allclose(v_t, v_j, rtol=RTOL, atol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("args,message", [
    (["ilqr", "--env", "/no/such/env.json"], "does not exist"),
    (["ilqr", "--env", NAV, "--x0", "[1.0, 2.0, 3.0]"], "state size 2"),
    (["ilqr", "--env", NAV, "--x0", "not json"], "JSON list"),
    (["mpc", "--env", NAV, "--x0", "[1.0]"], "state size 2"),
])
def test_usage_errors(args, message):
    rc_j, _ = run_jax(args)
    rc_t, out_t = run_port(args)
    assert rc_t == rc_j == 2
    assert message in out_t, out_t


def test_time_workers_raises_naming_the_roadmap_item():
    """``--time-workers`` past the processes that can hold it: the JAX CLI's
    usage error past its 8 devices, and the port's in one process without
    a group, which says how to launch the processes (the group's own case
    is ``test_time_workers_in_a_two_process_group``)."""
    for args in (["ilqr", "--env", NAV, "-T", "8"], ["lqr", "-T", "8"]):
        rc_j, out_j = run_jax(args + ["--time-workers", "9"])
        assert rc_j == 2 and "must be in [1, 8]" in out_j, out_j
        rc, out = run_port(args + ["--time-workers", "2"])
        assert rc == 2
        assert "--time-workers 2 must be in [1, 1]" in out, out
        assert "torchrun --nproc-per-node 2 -m tfmpc_tpu_torch" in out, out
        assert run_port(args + ["--time-workers", "0"])[0] == 2


SHARDED = re.compile(r"converged=(True|False) iterations=(\d+) "
                     r"total_cost=(\S+) residual=(\S+) "
                     r"\(horizon sharded over 2 device\(s\)\)")
DATA_X_TIME = re.compile(r"solved (\d+) scenarios on (\d+)x2 \(data x time\) "
                         r"devices: (\d+)/(\d+) converged, mean_cost=(\S+) "
                         r"mean_iterations=(\S+)")


def test_time_workers_in_a_two_process_group():
    """``lqr`` and ``ilqr --time-workers 2`` in a real two-process gloo group
    (the horizon over both) against the JAX CLI's on its 8 devices: the
    same exit codes and printed figures (reservoir-5 with boxQP, converged
    and stopped after one iteration; a navigation batch, data x time, 1x2
    here and 4x2 there, its float32 mean cost within 1e-6 relative, as the
    summed step costs of a trajectory); rank 1 prints nothing. ``lqr`` (another
    problem than the JAX CLI's) is held against the port's one-process
    ``--parallel`` run."""
    res = ["ilqr", "--env", str(REPO / "configs/reservoir.json"), "-T", "40"]
    nav = ["ilqr", "--env", NAV, "-T", "20"]
    argvs = [res, nav + ["--num-samples", "4"], ["lqr", "-T", "16"],
             res + ["--max-iterations", "1"],
             nav + ["--num-samples", "4", "--num-workers", "2"],
             nav + ["--num-workers", "1"] + ["--time-workers", "3"],
             nav + ["--ddp"]]
    argvs = [a + ["--time-workers", "2"] if "--time-workers" not in a
             else a for a in argvs]
    outs = torch_mp.run_group(torch_mp.cli_runs, dict(argvs=[
        a + ["--device", "cpu"] for a in argvs]))
    assert all(out == "" for _, out, _ in outs[1])
    runs = outs[0]
    assert [rc for rc, _, _ in runs] == [rc for rc, _, _ in outs[1]] == \
        [0, 0, 0, 3, 2, 2, 2]
    jax_runs = [run_jax(a) for a in argvs[:2] + argvs[3:4]]
    jax_runs.append(run_jax(argvs[4][:-4] + ["--num-workers", "8",
                                             "--time-workers", "2"]))
    assert [rc for rc, _ in jax_runs] == [0, 0, 3, 2]

    for (rc, out, _), (rc_j, out_j) in zip(runs[:1] + runs[3:4],
                                           jax_runs[:1] + jax_runs[2:3]):
        assert figures(SHARDED, out) == figures(SHARDED, out_j)
        # the trajectory's summed step costs: within f32 rounding
        total = re.compile(r"Trajectory\(T=40, total_cost=(\S+)\)")
        np.testing.assert_allclose(float(figures(total, out)[0]),
                                   float(figures(total, out_j)[0]),
                                   rtol=1e-6)
    n, n_data, c, _, cost, it = figures(DATA_X_TIME, runs[1][1])
    n_j, n_data_j, c_j, _, cost_j, it_j = figures(DATA_X_TIME, jax_runs[1][1])
    assert (n, n_data, n_data_j) == ("4", "1", "4")
    assert (c, it) == (c_j, it_j)
    np.testing.assert_allclose(float(cost), float(cost_j), rtol=1e-6)

    rc, one = run_port(["lqr", "-T", "16", "--parallel"])
    total = re.compile(r"Trajectory\(T=16, total_cost=(\S+)\)")
    np.testing.assert_allclose(float(figures(total, runs[2][1])[0]),
                               float(figures(total, one)[0]), rtol=1e-5)
    assert len(runs[2][1].splitlines()) == len(one.splitlines())
    assert "exceeds the 2 processes" in runs[4][2]
    assert "exceeds the 8 visible devices" in jax_runs[3][1]
    assert "must be in [1, 2]" in runs[5][2]
    assert "--ddp is incompatible" in runs[6][2]


def test_indivisible_samples():
    """``--num-samples`` that the device count does not divide: the JAX CLI
    on its 8 devices, and the port's under ``torchrun``'s variables in a
    real two-process gloo group (which it joins itself)."""
    rc_j, out_j = run_jax(["ilqr", "--env", NAV, "-T", "8",
                           "--num-samples", "12"])
    assert rc_j == 2 and "must be divisible by the device count 8" in out_j
    outs = torch_mp.run_group(torch_mp.cli_under_torchrun, dict(argv=[
        "ilqr", "--env", NAV, "-T", "8", "--num-samples", "3",
        "--device", "cpu"]))
    for out in outs:
        assert out["rc"] == 2
        assert "must be divisible by the device count 2" in out["err"]


def _lqr_reference(seed, n, m, T, samples=1):
    g = torch.Generator().manual_seed(seed)
    problem = make_lqr(g, n, m, T, device="cpu")
    shape = (samples, n) if samples > 1 else (n,)
    return lqr.solve(problem, torch.randn(shape, generator=g))


def test_lqr_against_the_ports_own_solve(tmp_path):
    rc, out = run_port(["lqr", "-n", "3", "-m", "2", "-T", "10",
                        "--seed", "3", "--logdir", str(tmp_path)])
    assert rc == 0
    ref = _lqr_reference(3, 3, 2, 10)
    assert out.splitlines()[:13] == repr(Trajectory(*ref)).splitlines()
    assert out.splitlines()[-1] == \
        f"trajectory saved to {tmp_path}/trajectory_0.csv"
    # the O(log T) backward: the same problem's total cost within f32
    # rounding of the sequential one's
    total = re.compile(r"Trajectory\(T=16, total_cost=(\S+)\)")
    seq = run_port(["lqr", "-T", "16", "--sequential"])[1]
    par = run_port(["lqr", "-T", "16", "--parallel"])[1]
    np.testing.assert_allclose(float(figures(total, par)[0]),
                               float(figures(total, seq)[0]), rtol=1e-5)
    rc, out = run_port(["lqr", "-n", "3", "-m", "2", "-T", "10",
                        "--seed", "3", "--num-samples", "4"])
    total = _lqr_reference(3, 3, 2, 10, 4)[2].double().sum(dim=1)
    assert out == (f"solved 4 initial states: "
                   f"mean_cost={float(total.mean()):.6f} "
                   f"max_cost={float(total.max()):.6f}\n")


def test_debug_nans_names_the_field(monkeypatch):
    """``--debug-nans`` checks each solve's result and names the first field
    that holds a NaN (here a planted one), exit code 1."""
    real = lqr.solve

    def poisoned(*a, **k):
        states, actions, costs = real(*a, **k)
        return states, actions * float("nan"), costs

    monkeypatch.setattr(lqr, "solve", poisoned)
    rc, out = run_port(["--debug-nans", "lqr", "-T", "4"])
    assert rc == 1 and "result field [1] holds a NaN" in out, out
    assert not torch.is_anomaly_enabled()
    monkeypatch.setattr(lqr, "solve", real)
    assert run_port(["--debug-nans", "lqr", "-T", "4"])[0] == 0


def test_python_dash_m_and_the_console_script():
    proc = subprocess.run(
        [sys.executable, "-m", "tfmpc_tpu_torch", "lqr", "-T", "5",
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Trajectory(T=5")
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["tfmpc-tpu"] == "tfmpc_tpu.cli:main"
    assert scripts["tfmpc-tpu-torch"] == "tfmpc_tpu_torch.cli:main"
    assert cli.main(["--help"]) == 0


# -- the package API -------------------------------------------------------------

def test_all_matches_the_jax_package():
    assert tfmpc_tpu_torch.__all__ == tfmpc_tpu.__all__
    assert len(tfmpc_tpu_torch.__all__) == 31
    for name in tfmpc_tpu_torch.__all__:
        ours, theirs = getattr(tfmpc_tpu_torch, name), getattr(tfmpc_tpu, name)
        assert type(ours) is type(theirs) or (
            isinstance(ours, type) and isinstance(theirs, type)), name
        home = ours.__name__ if isinstance(ours, types.ModuleType) \
            else ours.__module__
        assert home.startswith("tfmpc_tpu_torch."), name


def test_import_loads_neither_jax_pandas_nor_click():
    code = ("import sys, tfmpc_tpu_torch, tfmpc_tpu_torch.cli, "
            "tfmpc_tpu_torch.parallel.mesh; print(sorted(m for m in "
            "('jax', 'pandas', 'click', 'tfmpc_tpu') if m in sys.modules))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_to_dataframe_matches_jax():
    ref = _lqr_reference(0, 3, 2, 6)
    ours = Trajectory(*ref).to_dataframe()
    theirs = JTrajectory(*(a.numpy() for a in ref)).to_dataframe()
    pd.testing.assert_frame_equal(ours, theirs, rtol=1e-6)
    assert list(ours.columns) == ["state_0", "state_1", "state_2",
                                  "action_0", "action_1", "cost"]
    assert json.dumps(list(ours.columns))  # plain column names
