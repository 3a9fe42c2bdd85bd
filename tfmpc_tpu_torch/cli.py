"""Command line of the PyTorch port: ``tfmpc-tpu-torch lqr|ilqr|mpc``.

The JAX package's ``tfmpc_tpu/cli.py`` with the same commands, option
names, defaults, printed lines, trajectory CSVs and exit codes (3 when a
single iLQR solve does not converge, 2 on a usage error), written on
``argparse`` so that it needs nothing beyond PyTorch and numpy (no click,
no pandas). ``main(argv)`` returns the exit code, so tests and scripts can
call it in-process; ``python -m tfmpc_tpu_torch`` and the console script
``tfmpc-tpu-torch`` run it.

Every command runs on the card unless it is given ``--device cpu``; there
is no fallback. ``ilqr`` and ``mpc`` with ``--num-samples`` > 1 go through
the data-parallel mesh (``parallel/mesh.py``): in one process the whole
batch on one device; launched with ``torchrun`` (one process per card),
each process solves its rows and rank 0 prints the global figures.
``--time-workers`` > 1 (horizon sharding) is not ported yet: ROADMAP
queue 1 item 1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger("tfmpc_tpu_torch")

PROG = "tfmpc-tpu-torch"
TIME_WORKERS_ITEM = ("the time-sharded solves are not ported yet "
                     "(ROADMAP queue 1 item 1)")


class UsageError(Exception):
    """A command-line error found after parsing: exit code 2."""


def _setup_logging(verbose: int) -> None:
    level = logging.WARNING
    if verbose == 1:
        level = logging.INFO
    elif verbose >= 2:
        level = logging.DEBUG
    logging.basicConfig(
        level=level, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    # basicConfig does nothing where handlers are already installed (a test
    # runner, an embedding application): set the package logger's level too
    logger.setLevel(level)


def _lead() -> bool:
    """Whether this process prints: the only one, or rank 0 of a group."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _echo(line: str) -> None:
    if _lead():
        print(line)


def _check_nans(label: str, result, enabled: bool) -> None:
    """``--debug-nans``: raise naming the first field of ``result`` (a
    named tuple of tensors) that holds a NaN."""
    if not enabled:
        return
    names = getattr(result, "_fields", None) or [
        f"[{i}]" for i in range(len(result))]
    for name, value in zip(names, result):
        if isinstance(value, torch.Tensor) and bool(torch.isnan(value).any()):
            raise FloatingPointError(
                f"--debug-nans: {label} result field {name} holds a NaN")


def _log_trace(trace, upto: int) -> None:
    """Replay the per-iteration statistics of a B=1 trace as log lines."""
    col = lambda a: a[:, 0].cpu().numpy()  # noqa: E731
    J, residual, mu = col(trace.J), col(trace.residual), col(trace.mu)
    alpha, accepted = col(trace.alpha), col(trace.accepted)
    for i in range(min(upto, J.shape[0])):
        logger.info(
            "iteration=%d cost=%.6f residual=%.3e mu=%.3e alpha=%s",
            i, J[i], residual[i],
            mu[i], f"{alpha[i]:.4f}" if accepted[i] else "rejected",
        )


def _log_batched_trace(trace, result) -> None:
    """Replay an [I, B] trace as per-iteration mean lines (in several
    processes, of this process's rows)."""
    J = trace.J.double().cpu().numpy()
    conv = trace.converged.double().cpu().numpy()
    mu = trace.mu.double().cpu().numpy()
    upto = int(result.iterations.max())
    for i in range(min(upto, J.shape[0])):
        logger.info(
            "iteration=%d mean_cost=%.6f frac_converged=%.3f mean_mu=%.3e",
            i, J[i].mean(), conv[i].mean(), mu[i].mean(),
        )


def build_ilqr_config(**kwargs):
    """The solver config the commands run with: ``use_pallas`` defaults to
    True, so the command line runs the CUDA kernels on the card. An env
    without a device step (a user env) raises ``NotImplementedError``
    there (ROADMAP queue 2 item 3); ``--no-pallas`` selects the plain
    path."""
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    kwargs.setdefault("use_pallas", True)
    return ILQRConfig(**kwargs)


def _save_trajectories(result, logdir, rows=None, first=0):
    """Write ``result`` (an LQR tuple or an ``ILQRResult``) to ``logdir``:
    unbatched as ``trajectory_0.csv``, or its ``rows`` scenarios as
    ``trajectory_{first + i}.csv``."""
    from tfmpc_tpu_torch.utils.trajectory import Trajectory

    if not logdir:
        return []
    if rows is None:
        return [Trajectory.from_result(result).save(
            os.path.join(logdir, "trajectory_0.csv"))]
    return [Trajectory.from_result(result, index=i).save(
        os.path.join(logdir, f"trajectory_{first + i}.csv"))
        for i in range(rows)]


def _time_workers(time_workers: int) -> None:
    if time_workers < 1:
        raise UsageError(f"--time-workers {time_workers} must be >= 1")
    if time_workers > 1:
        raise UsageError(f"--time-workers {time_workers}: {TIME_WORKERS_ITEM}")


def _x0_from(x0_json, config_json, n, seed, *, sample):
    """The initial state: ``--x0``, else the config's ``x0``, else (with
    ``sample``) a draw from ``default_rng(seed)``, as the JAX CLI makes
    it."""
    if x0_json is not None:
        try:
            x0 = np.asarray(json.loads(x0_json), dtype=np.float32)
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            raise UsageError(
                f"--x0 must be a JSON list of {n} numbers, e.g. '[0.0, 0.0]'; "
                f"got {x0_json!r} ({e})"
            ) from e
    elif "x0" in config_json:
        x0 = np.asarray(config_json["x0"], dtype=np.float32)
    elif sample:
        x0 = np.random.default_rng(seed).normal(size=n).astype(np.float32)
        logger.info("no x0 given; sampled %s", x0)
    else:
        raise UsageError("provide --x0 or an x0 in the env config")
    if x0.shape != (n,):
        raise UsageError(
            f"x0 has shape {x0.shape} but env '{config_json['name']}' has "
            f"state size {n}"
        )
    return x0


def _perturbed(x0, num_samples, seed):
    """The scenario batch of ``ilqr``/``mpc --num-samples``: ``x0`` plus
    standard normal draws from ``default_rng(seed)``, as the JAX CLI."""
    rng = np.random.default_rng(seed)
    return x0[None, :] + rng.normal(size=(num_samples, x0.shape[0])).astype(
        np.float32)


def _mesh(num_workers, device):
    from tfmpc_tpu_torch.parallel import mesh as pmesh

    try:
        return pmesh.make_mesh(num_workers, devices=device)
    except ValueError as e:
        raise UsageError(f"--num-workers {num_workers}: {e}") from e


def _local_rows(batch, mesh):
    """This process's rows of the global batch, and the first row's
    index."""
    if mesh.group is None:
        return batch, 0
    rows = batch.shape[0] // mesh.size
    return batch[mesh.rank * rows:(mesh.rank + 1) * rows], mesh.rank * rows


# -- commands ------------------------------------------------------------------

def _lqr(args) -> int:
    """Generate a random LQR problem and solve it exactly."""
    from tfmpc_tpu_torch.models.problems import make_lqr
    from tfmpc_tpu_torch.solvers import lqr as lqr_solver
    from tfmpc_tpu_torch.utils.trajectory import Trajectory

    _time_workers(args.time_workers)
    device = torch.device(args.device)
    n, m = args.state_size, args.action_size
    generator = torch.Generator().manual_seed(args.seed)
    problem = make_lqr(generator, n, m, args.horizon, device=device)
    shape = (args.num_samples, n) if args.num_samples > 1 else (n,)
    x0 = (args.x0_scale * torch.randn(shape, generator=generator)).to(device)
    logger.info("solving LQR n=%d m=%d T=%d on %s", n, m, args.horizon,
                device.type)
    out = lqr_solver.solve(problem, x0, parallel=args.parallel)
    _check_nans("lqr", out, args.debug_nans)
    if args.num_samples > 1:
        total = out[2].double().sum(dim=1)
        _echo(f"solved {args.num_samples} initial states: "
              f"mean_cost={float(total.mean()):.6f} "
              f"max_cost={float(total.max()):.6f}")
        for p in _save_trajectories(out, args.logdir, args.num_samples):
            logger.info("trajectory saved to %s", p)
        if args.logdir:
            _echo(f"{args.num_samples} trajectories saved to {args.logdir}")
        return 0
    _echo(repr(Trajectory(*out)))
    for p in _save_trajectories(out, args.logdir):
        _echo(f"trajectory saved to {p}")
    return 0


def _ilqr(args) -> int:
    """Solve a differentiable env from a JSON config with iLQR."""
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.parallel import mesh as pmesh
    from tfmpc_tpu_torch.solvers import ilqr as ilqr_solver
    from tfmpc_tpu_torch.utils.trajectory import Trajectory

    with open(args.env) as f:
        config_json = json.load(f)
    device = torch.device(args.device)
    env = load_env(args.env, device=device)
    n = env.state_size
    x0_single = _x0_from(args.x0, config_json, n, args.seed, sample=True)

    boxqp = env.bounds is not None if args.boxqp is None else args.boxqp
    if args.ddp and (args.parallel_backward or args.time_workers > 1):
        raise UsageError(
            "--ddp is incompatible with --parallel-backward/--time-workers "
            "(the associative-scan backward composes linear value-recursion "
            "elements; see ILQRConfig.ddp)"
        )
    _time_workers(args.time_workers)
    config = build_ilqr_config(
        atol=args.atol, max_iterations=args.max_iterations, boxqp=boxqp,
        use_pallas=args.pallas, parallel_backward=args.parallel_backward,
        ddp=args.ddp,
    )
    trace_iters = logger.isEnabledFor(logging.INFO)

    if args.num_samples == 1:
        x0 = torch.as_tensor(x0_single, device=device)
        if trace_iters:
            # the per-iteration log lines: the trace-recording batch of one
            batch, trace = ilqr_solver.solve_batch(
                env, x0[None], horizon=args.horizon, config=config,
                return_trace=True,
            )
            _log_trace(trace, upto=int(batch.iterations[0]))
            result = type(batch)(*(a[0] for a in batch))
        else:
            result = ilqr_solver.solve(env, x0, horizon=args.horizon,
                                       config=config)
        _check_nans("ilqr", result, args.debug_nans)
        _echo(repr(Trajectory.from_result(result)))
        _echo(f"converged={bool(result.converged)} "
              f"iterations={int(result.iterations)} "
              f"total_cost={float(result.total_cost):.6f} "
              f"residual={float(result.residual):.3e}")
        if _lead():
            for p in _save_trajectories(result, args.logdir):
                print(f"trajectory saved to {p}")
        return 0 if bool(result.converged) else 3

    mesh = _mesh(args.num_workers, device)
    n_dev = mesh.size
    if args.num_samples % n_dev != 0:
        raise UsageError(
            f"--num-samples {args.num_samples} must be divisible by the device "
            f"count {n_dev} (pass --num-workers to change it)"
        )
    if mesh.rank is None:  # a process past --num-workers: not on the axis
        return 0
    x0_local, first = _local_rows(
        _perturbed(x0_single, args.num_samples, args.seed), mesh)
    out = pmesh.solve_ilqr_sharded(
        env, x0_local, horizon=args.horizon, config=config, mesh=mesh,
        return_trace=trace_iters,
    )
    result, trace = out if trace_iters else (out, None)
    _check_nans("ilqr", result, args.debug_nans)
    if trace_iters:
        _log_batched_trace(trace, result)
    stats = pmesh.summarize(result, mesh)
    _echo(f"solved {args.num_samples} scenarios on {n_dev} device(s): "
          f"{stats['num_converged']}/{args.num_samples} converged, "
          f"mean_cost={stats['mean_cost']:.6f} "
          f"mean_iterations={stats['mean_iterations']:.1f}")
    for p in _save_trajectories(result, args.logdir, x0_local.shape[0],
                                first):
        logger.info("trajectory saved to %s", p)
    if args.logdir:
        _echo(f"{args.num_samples} trajectories saved to {args.logdir}")
    return 0


def _mpc(args) -> int:
    """Closed-loop receding-horizon MPC from a JSON env config."""
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.parallel import mesh as pmesh
    from tfmpc_tpu_torch.solvers import mpc as mpc_solver
    from tfmpc_tpu_torch.utils.trajectory import Trajectory

    with open(args.env) as f:
        config_json = json.load(f)
    device = torch.device(args.device)
    env = load_env(args.env, device=device)
    x0 = _x0_from(args.x0, config_json, env.state_size, args.seed,
                  sample=False)
    boxqp = env.bounds is not None if args.boxqp is None else args.boxqp
    config = build_ilqr_config(
        atol=args.atol, max_iterations=args.max_iterations, boxqp=boxqp,
        use_pallas=args.pallas,
    )
    run = dict(steps=args.steps, plan_horizon=args.plan_horizon,
               config=config)

    if args.num_samples > 1:
        x0_batch = _perturbed(x0, args.num_samples, args.seed)
        mesh = pmesh.make_mesh(devices=device)
        n_dev = mesh.size
        if args.num_samples % n_dev == 0:
            x0_local, first = _local_rows(x0_batch, mesh)
            res = pmesh.mpc_sharded(env, x0_local, mesh=mesh, **run)
        else:  # a fleet the device count does not divide runs on one device
            n_dev, first, mesh = 1, 0, None
            res = mpc_solver.run(env, torch.as_tensor(x0_batch, device=device),
                                 **run)
        _check_nans("mpc", res, args.debug_nans)
        sums, _ = pmesh.reduce_stats(
            {"count": float(res.total_cost.numel()),
             "cost": float(res.total_cost.double().sum()),
             "replans": float(res.converged.numel()),
             "converged": float(res.converged.sum()),
             "iterations": float(res.iterations.double().sum())}, {}, mesh)
        _echo(f"closed-loop fleet of {args.num_samples} on {n_dev} device(s): "
              f"mean_total_cost={sums['cost'] / sums['count']:.6f} "
              f"replans_converged={int(sums['converged'])}/"
              f"{int(sums['replans'])} "
              f"mean_replan_iterations="
              f"{sums['iterations'] / sums['replans']:.1f}")
        if args.logdir:
            if mesh is not None or _lead():
                for i in range(res.states.shape[0]):
                    # the realized stage costs, then the final cost
                    costs = torch.cat([res.costs[i], res.final_cost[i, None]])
                    Trajectory(res.states[i], res.actions[i], costs).save(
                        os.path.join(args.logdir,
                                     f"mpc_trajectory_{first + i:04d}.csv"))
            _echo(f"{args.num_samples} trajectories saved to {args.logdir}")
        return 0

    res = mpc_solver.run(env, torch.as_tensor(x0, device=device), **run)
    _check_nans("mpc", res, args.debug_nans)
    tr = Trajectory(res.states, res.actions,
                    torch.cat([res.costs, res.final_cost[None]]))
    _echo(repr(tr))
    _echo(f"closed-loop total_cost={float(res.total_cost):.6f} "
          f"replans_converged={int(res.converged.sum())}/{args.steps} "
          f"mean_replan_iterations="
          f"{float(res.iterations.double().mean()):.1f}")
    if args.logdir and _lead():
        path = tr.save(os.path.join(args.logdir, "mpc_trajectory.csv"))
        print(f"trajectory saved to {path}")
    return 0


# -- the parser ----------------------------------------------------------------

def _existing_path(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f"path {path!r} does not exist")
    return path


def _common(p, run, *, samples_help, seed_help="(default: 0)"):
    p.add_argument("--device", default="cuda",
                   help="Device to run on (default: cuda, the card); "
                        "--device cpu runs every stage's plain PyTorch "
                        "version on the CPU.")
    p.add_argument("--num-samples", type=int, default=1, help=samples_help)
    p.add_argument("--seed", type=int, default=0, help=seed_help)
    p.set_defaults(run=run, subparser=p)


PALLAS_HELP = (
    "--pallas (the default) runs the hand-written CUDA kernels on the card "
    "(the name is the JAX package's switch). An env without a device step "
    "(a user env) raises NotImplementedError (ROADMAP queue 2 item 3); "
    "there is no automatic fallback. --no-pallas selects the plain PyTorch "
    "path.")


def parser() -> argparse.ArgumentParser:
    """The command line's parser (the JAX CLI's commands and options)."""
    top = argparse.ArgumentParser(
        prog=PROG,
        description="tfmpc-tpu on PyTorch and CUDA: LQR / iLQR trajectory "
                    "optimization and closed-loop MPC.")
    top.add_argument("-v", "--verbose", action="count", default=0,
                     help="-v info, -vv debug.")
    top.add_argument(
        "--debug-nans", action="store_true", default=False,
        help="Turn on torch.autograd.set_detect_anomaly(True), which traps "
             "a NaN in the backward pass of the KKT test, and check each "
             "solve's result fields, failing with the name of the first "
             "that holds a NaN (infinities are the solver's own markers: a "
             "diverged rollout's cost, the residual of a step that "
             "accepted nothing). PyTorch has no forward NaN trap like "
             "jax_debug_nans. Debugging only: slower.")
    sub = top.add_subparsers(dest="command", required=True, metavar="COMMAND")

    p = sub.add_parser("lqr", help="Generate a random LQR problem and solve "
                                   "it exactly.")
    p.add_argument("--state-size", "-n", type=int, default=3)
    p.add_argument("--action-size", "-m", type=int, default=2)
    p.add_argument("--horizon", "-T", type=int, default=100)
    p.add_argument("--x0-scale", type=float, default=1.0,
                   help="Std of the random initial state.")
    p.add_argument("--parallel", dest="parallel", action="store_true",
                   default=False,
                   help="Use the O(log T) associative-scan Riccati backward "
                        "pass.")
    p.add_argument("--sequential", dest="parallel", action="store_false",
                   help="The sequential Riccati backward pass (default).")
    p.add_argument("--time-workers", type=int, default=1,
                   help=f"Shard the horizon over this many devices: > 1 "
                        f"raises, {TIME_WORKERS_ITEM}.")
    p.add_argument("--logdir", default=None, help="Write trajectory CSVs here.")
    _common(p, _lqr,
            samples_help="Batch of random initial states rolled under the "
                         "one optimal policy (LQR gains are "
                         "state-independent).",
            seed_help="Seed of a torch.Generator that draws the problem "
                      "(through make_lqr), then x0 (default: 0). The JAX "
                      "CLI draws from jax.random.PRNGKey, so the same seed "
                      "gives another random problem there.")

    p = sub.add_parser("ilqr", help="Solve a differentiable env from a JSON "
                                    "config with iLQR.")
    p.add_argument("--env", required=True, type=_existing_path,
                   help="JSON env config file.")
    p.add_argument("--horizon", "-T", type=int, default=100)
    p.add_argument("--atol", type=float, default=1e-4,
                   help="Convergence tolerance on the cost decrease.")
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--x0", default=None,
                   help="Initial state as a JSON list; overrides the "
                        "config's x0; random if neither is given.")
    p.add_argument("--num-workers", type=int, default=None,
                   help="Cap the number of devices (processes of the "
                        "torch.distributed group) the batch is split over.")
    p.add_argument("--logdir", default=None, help="Write trajectory CSVs here.")
    p.add_argument("--boxqp", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Control-limited DDP backward pass (projected-Newton "
                        "boxQP). Default: on for box-constrained envs. "
                        "--no-boxqp gives the reference's clipping-only "
                        "behavior.")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                   default=True, help=PALLAS_HELP)
    p.add_argument("--parallel-backward", action="store_true", default=False,
                   help="O(log T) associative-scan backward pass (long "
                        "horizons).")
    p.add_argument("--ddp", action="store_true", default=False,
                   help="Full DDP backward: keep the second-order dynamics "
                        "tensors (one extra Hessian sweep per iteration; "
                        "excludes --parallel-backward).")
    p.add_argument("--time-workers", type=int, default=1,
                   help=f"Shard the horizon over this many devices: > 1 "
                        f"raises, {TIME_WORKERS_ITEM}.")
    _common(p, _ilqr, samples_help="Scenario batch size (solved in one "
                                   "batched program).")

    p = sub.add_parser("mpc", help="Closed-loop receding-horizon MPC from a "
                                   "JSON env config.")
    p.add_argument("--env", required=True, type=_existing_path,
                   help="JSON env config file.")
    p.add_argument("--steps", type=int, default=50,
                   help="Closed-loop control steps (re-plans).")
    p.add_argument("--plan-horizon", type=int, default=20,
                   help="Horizon of each warm-started re-plan.")
    p.add_argument("--atol", type=float, default=1e-4)
    p.add_argument("--max-iterations", type=int, default=15,
                   help="Per-replan solver budget (warm starts keep this "
                        "small).")
    p.add_argument("--x0", default=None,
                   help="Initial state as a JSON list; overrides the "
                        "config's x0.")
    p.add_argument("--boxqp", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Control-limited DDP (default: on for bounded envs).")
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction,
                   default=True, help=PALLAS_HELP)
    p.add_argument("--logdir", default=None,
                   help="Write the realized closed-loop trajectory CSV here.")
    _common(p, _mpc, samples_help="Closed-loop scenario fleet: x0 is "
                                  "perturbed into this many rollouts, run "
                                  "as one batch.")
    return top


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the command line on ``argv`` (default ``sys.argv[1:]``) and
    return its exit code. Under ``torchrun`` (``WORLD_SIZE`` > 1) it joins
    the process group itself (``mesh.init_multihost``) and leaves it at
    the end."""
    top = parser()
    try:
        args = top.parse_args(argv)
    except SystemExit as e:  # --help, or argparse's own usage error
        return int(e.code or 0)
    _setup_logging(args.verbose)

    import contextlib

    import torch.distributed as dist

    joined = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        from tfmpc_tpu_torch.parallel import mesh as pmesh

        args.device = str(pmesh.init_multihost(device=args.device))
        joined = True
    anomaly = torch.autograd.detect_anomaly() if args.debug_nans \
        else contextlib.nullcontext()
    try:
        with anomaly:
            return args.run(args)
    except UsageError as e:
        print(f"{args.subparser.format_usage()}{args.subparser.prog}: "
              f"error: {e}", file=sys.stderr)
        return 2
    except FloatingPointError as e:  # --debug-nans found a NaN
        print(f"{PROG}: error: {e}", file=sys.stderr)
        return 1
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
