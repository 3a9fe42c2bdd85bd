"""A real ``torch.distributed`` gloo group of CPU processes for the port's
tests (``test_torch_mesh.py``, ``test_torch_cli.py``).

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
