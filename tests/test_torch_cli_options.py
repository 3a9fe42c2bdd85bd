"""The port's command line against the JAX package's: the batched
``ilqr`` options (``--no-boxqp`` on a bounded env, ``--parallel-backward``,
``--ddp``) and ``mpc``, single and as a fleet, with ``test_torch_cli.py``'s
helpers and tolerances: exit codes and converged counts equal, costs
within 1e-4 relative, mean iterations within 1 (measured equal).
"""

import pytest

from test_torch_cli import (
    BATCHED,
    FLEET,
    MPC,
    NAV,
    NAV_BOUNDED,
    _one_torch_thread,  # noqa: F401 - the module's autouse fixture
    figures,
    run_both,
    run_port,
    same_costs,
)


@pytest.mark.parametrize("env,flags", [
    (NAV_BOUNDED, ["--no-boxqp"]),
    (NAV, ["--parallel-backward"]),
    (NAV, ["--ddp"]),
])
def test_batched_solve_options(env, flags):
    out_j, out_t = run_both(["ilqr", "--env", env, "-T", "20",
                             "--num-samples", "8", *flags])
    n_j, c_j, _, cost_j, it_j = figures(BATCHED, out_j)
    n_t, c_t, _, cost_t, it_t = figures(BATCHED, out_t)
    assert (n_t, c_t) == (n_j, c_j)
    same_costs(cost_t, cost_j)
    assert abs(float(it_t) - float(it_j)) <= 1


def test_mpc_single():
    out_j, out_t = run_both(["mpc", "--env", NAV, "--steps", "5",
                             "--plan-horizon", "8"])
    cost_j, conv_j, steps_j, it_j = figures(MPC, out_j)
    cost_t, conv_t, steps_t, it_t = figures(MPC, out_t)
    assert (conv_t, steps_t) == (conv_j, steps_j)
    same_costs(cost_t, cost_j)
    assert abs(float(it_t) - float(it_j)) <= 1
    assert out_t.splitlines()[0] == out_j.splitlines()[0]


def test_mpc_fleet(tmp_path):
    args = ["mpc", "--env", NAV, "--steps", "5", "--plan-horizon", "8",
            "--num-samples", "8"]
    out_j, out_t = run_both(args)
    n_j, cost_j, conv_j, all_j, it_j = figures(FLEET, out_j)
    n_t, cost_t, conv_t, all_t, it_t = figures(FLEET, out_t)
    assert (n_t, conv_t, all_t) == (n_j, conv_j, all_j) == ("8", "40", "40")
    same_costs(cost_t, cost_j)
    assert abs(float(it_t) - float(it_j)) <= 1
    rc, out = run_port(args + ["--logdir", str(tmp_path)])
    assert rc == 0 and out.splitlines()[-1] == \
        f"8 trajectories saved to {tmp_path}"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"mpc_trajectory_{i:04d}.csv" for i in range(8)]
