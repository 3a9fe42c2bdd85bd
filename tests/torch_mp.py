"""A real ``torch.distributed`` gloo group of CPU processes for the port's
tests (``test_torch_mesh.py``, ``test_torch_cli.py``,
``test_torch_time_sharding.py``).

``run_group(fn, payload)`` starts ``world`` processes with
``torch.multiprocessing`` (spawn), each running ``fn(rank, world, port,
payload)`` for a free localhost port, and returns their results by rank.
The tests have their own deadline (there is no pytest-timeout, and the
suite runs under xdist): past it every child is killed and the group
raises ``TimeoutError``. A child's exception comes back as a
``RuntimeError`` carrying its traceback.

The child functions live here, so a spawned child imports torch and the
port, never JAX.
"""

from __future__ import annotations

import contextlib
import io
import os
import queue
import socket
import time
import traceback

DEADLINE_S = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, payload, results):
    try:
        out = fn(rank, world, port, payload)
        results.put((rank, True, out))
    except BaseException:  # noqa: B902 - reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))


def run_group(fn, payload, world: int = 2, deadline: float = DEADLINE_S):
    """Run ``fn`` in ``world`` processes of one group; returns the list of
    their results, indexed by rank."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_child,
                         args=(fn, rank, world, port, payload, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    outs = {}
    try:
        while len(outs) < world:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"the {world}-process group passed its "
                                   f"{deadline:.0f} s deadline")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"a child exited with code {dead[0].exitcode} "
                        "before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            outs[rank] = out
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [outs[r] for r in range(world)]


def _numpy(result) -> dict:
    return {name: value.cpu().numpy()
            for name, value in zip(result._fields, result)}


def solve_rows(rank, world, port, payload):
    """Join the gloo group, solve this rank's rows of ``payload["x0"]``
    through ``mesh.solve_ilqr_sharded`` on the CPU (the kernels' wrappers,
    ``use_pallas=True``), ``summarize`` over the group, then run the
    command line on the same group for each of ``payload["argvs"]``:
    returns the meshes' (size, rank), the local result, the statistics,
    and each command's exit code and output."""
    import torch
    import torch.distributed as dist

    from tfmpc_tpu_torch import cli
    from tfmpc_tpu_torch.models.registry import make_env
    from tfmpc_tpu_torch.parallel import mesh
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    torch.set_num_threads(1)
    device = mesh.init_multihost(
        device="cpu", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world)
    try:
        m = mesh.make_mesh(devices=device)
        capped = mesh.make_mesh(1, devices=device)  # collective: every rank
        env = make_env(payload["env"], dtype=getattr(torch, payload["dtype"]),
                       device="cpu")
        x0 = torch.as_tensor(payload["x0"])
        rows = x0.shape[0] // world
        res, trace = mesh.solve_ilqr_sharded(
            env, x0[rank * rows:(rank + 1) * rows],
            horizon=payload["horizon"], config=ILQRConfig(**payload["config"]),
            mesh=m, return_trace=True)
        stats = mesh.summarize(res, m)
        runs = []
        for argv in payload["argvs"]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                runs.append((cli.main(argv), out.getvalue()))
        return {"mesh": (m.size, m.rank), "capped": (capped.size, capped.rank),
                "result": _numpy(res), "trace_J": trace.J.numpy(),
                "stats": stats, "cli": runs}
    finally:
        dist.destroy_process_group()


def cli_under_torchrun(rank, world, port, payload):
    """Run the command line as ``torchrun`` would start it (the ``env://``
    variables set, no group yet): it joins the group itself. Returns the
    exit code, its output and its errors."""
    import torch

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    from tfmpc_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(payload["argv"])
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue()}


def _join(rank, world, port):
    import torch

    from tfmpc_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    return mesh.init_multihost(
        device="cpu", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world)


def _tensors(arrays: dict) -> dict:
    import torch

    return {k: None if v is None else torch.as_tensor(v)
            for k, v in arrays.items()}


def _time_case(m, case):
    """One case of ``time_sharded`` on the mesh ``m``."""
    import torch

    from tfmpc_tpu_torch.core.types import (
        Bounds, LinearModel, LQRProblem, QuadraticFinal, QuadraticModel)
    from tfmpc_tpu_torch.models.registry import make_env
    from tfmpc_tpu_torch.parallel import mesh
    from tfmpc_tpu_torch.solvers import lqr_parallel
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    kind = case["kind"]
    if kind == "backward":
        policy, value = lqr_parallel.backward_parallel(
            LQRProblem(**_tensors(case["problem"])), m.time)
        return {"K": policy.K, "k": policy.k, "V_xx": value.V_xx,
                "v_x": value.v_x}
    if kind == "ilqr_backward":
        lin = LinearModel(**_tensors(case["lin"]))
        quad = QuadraticModel(**_tensors(case["quad"]))
        final = QuadraticFinal(**_tensors(case["final"]))
        mu, Ubar = torch.as_tensor(case["mu"]), torch.as_tensor(case["Ubar"])
        out = {}
        for name, got in (
                ("plain", lqr_parallel.ilqr_backward_parallel(
                    lin, quad, final, mu, time=m.time)),
                ("boxqp", lqr_parallel.ilqr_backward_parallel_boxqp(
                    lin, quad, final, mu, Bounds(**_tensors(case["bounds"])),
                    Ubar, time=m.time))):
            ok, policy, dV1, dV2 = got
            out.update({f"{name}_ok": ok, f"{name}_K": policy.K,
                        f"{name}_k": policy.k, f"{name}_dV1": dV1,
                        f"{name}_dV2": dV2})
        return out
    if kind == "lqr":
        states, actions, costs = mesh.solve_lqr_time_sharded(
            LQRProblem(**_tensors(case["problem"])), case["x0"], mesh=m)
        return {"states": states, "actions": actions, "costs": costs,
                "block_F": mesh.shard_problem_time(
                    LQRProblem(**_tensors(case["problem"])), m).F}
    env = make_env(case["env"], dtype=torch.float64, device="cpu")
    x0 = case["x0"]
    if case.get("split_rows"):  # this data rank's rows of the batch
        rows = x0.shape[0] // m.size
        x0 = x0[m.rank * rows:(m.rank + 1) * rows]
    res = mesh.solve_ilqr_time_sharded(
        env, x0, horizon=case["horizon"], config=ILQRConfig(**case["config"]),
        mesh=m)
    return dict(zip(res._fields, res))


def time_sharded(rank, world, port, payload):
    """Join the gloo group, build ``make_mesh_2d(*shape)`` for each shape of
    ``payload["meshes"]`` (every rank, in that order), then run each of
    ``payload["cases"]`` on its mesh (``_time_case``). Returns each mesh's
    (data rank, time rank, time size) and each case's tensors as numpy,
    None off its mesh."""
    import torch.distributed as dist

    from tfmpc_tpu_torch.parallel import mesh

    _join(rank, world, port)
    try:
        meshes = {shape: mesh.make_mesh_2d(*shape, devices="cpu")
                  for shape in payload["meshes"]}
        out = {"layout": {
            shape: (m.rank, None if m.time is None else m.time.rank,
                    None if m.time is None else m.time.size)
            for shape, m in meshes.items()}}
        for case in payload["cases"]:
            m = meshes[case["mesh"]]
            out[case["name"]] = None if m.rank is None else {
                k: v.cpu().numpy() for k, v in _time_case(m, case).items()}
        return out
    finally:
        dist.destroy_process_group()


def cli_runs(rank, world, port, payload):
    """Join the gloo group and run the command line on it for each of
    ``payload["argvs"]``: returns each one's exit code, output and
    errors."""
    import torch.distributed as dist

    from tfmpc_tpu_torch import cli

    _join(rank, world, port)
    try:
        runs = []
        for argv in payload["argvs"]:
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            runs.append((rc, out.getvalue(), err.getvalue()))
        return runs
    finally:
        dist.destroy_process_group()
