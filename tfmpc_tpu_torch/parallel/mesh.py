"""Data- and time-parallel solves on ``torch.distributed``.

Counterpart of ``tfmpc_tpu/parallel/mesh.py``. The JAX module runs one
controller over a ``("data",)`` or ``("data", "time")`` device mesh
(``shard_map``, GSPMD) and ``jax.distributed`` across hosts. Here, as
PyTorch does it, there is one process per device on a
``torch.distributed`` process group, and one process without a group is a
mesh of one device.

- **Data axis** (``make_mesh``): scenarios are independent, so each
  process solves its own rows with ``ilqr.solve_batch`` or ``mpc.run``,
  the CUDA kernels included, and its results stay on its device. The only
  communication is ``summarize``'s two all-reduces of the batch's
  statistics.
- **Time axis** (``make_mesh_2d``): the sequence-parallel path for long
  horizons. The processes of a time axis split the O(log T) backward's
  horizon (``lqr_parallel.py``: each composes its block, the blocks'
  totals are all-gathered, the gains too) and run everything else alike,
  so each returns the whole solve. ``solve_ilqr_time_sharded`` forces
  ``parallel_backward`` and plain torch (``use_pallas=False``), as the
  JAX function does. On a 2-D mesh, rank ``d * n_time + t`` solves the
  rows of data rank d with its time axis' t-th block of the horizon.

Launch one process per card with ``torchrun`` (which sets the ``env://``
variables and ``LOCAL_RANK``), or give ``init_multihost`` the address,
rank and world size yourself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from tfmpc_tpu_torch.solvers import ilqr as _ilqr
from tfmpc_tpu_torch.solvers import lqr as _lqr
from tfmpc_tpu_torch.solvers import lqr_parallel as _lqr_parallel
from tfmpc_tpu_torch.solvers import mpc as _mpc
from tfmpc_tpu_torch.solvers.lqr_parallel import TIME_AXIS, TimeAxis

DATA_AXIS = "data"

DeviceLike = Union[str, torch.device]


def init_multihost(device: DeviceLike = "cuda", **kwargs) -> torch.device:
    """Join the process group: call once in each process before
    ``make_mesh``. A thin wrapper over ``dist.init_process_group`` whose
    defaults are ``init_method="env://"`` and the backend ``nccl`` for a
    CUDA ``device`` and ``gloo`` for ``device="cpu"``; other keyword
    arguments (``backend``, ``init_method``, ``rank``, ``world_size``, ...)
    pass through. Returns this process's device: ``cuda:{LOCAL_RANK}``
    (made current) or the CPU. Like the JAX package's, the group is
    synchronous: a lost process aborts the job.
    """
    device = torch.device(device)
    kwargs.setdefault("backend", "nccl" if device.type == "cuda" else "gloo")
    kwargs.setdefault("init_method", "env://")
    dist.init_process_group(**kwargs)
    if device.type != "cuda":
        return device
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh as one process sees it.

    ``group``: the data axis's process group, None for one process
    without a group (or a data axis of one process); ``size``: the
    processes on the data axis; ``rank``: this process's place on it, None
    for a process that a cap left off the mesh; ``device``: this process's
    device; ``time``: its time axis (``make_mesh_2d``), None for a 1-D
    mesh.
    """

    group: Optional[object]
    size: int
    rank: Optional[int]
    device: torch.device
    time: Optional[TimeAxis] = None


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[DeviceLike] = None) -> Mesh:
    """The data axis over the first ``n_devices`` processes of the group
    (all of them by default; without a group, this one process).

    A cap above the group's size raises ``ValueError``. Below it, every
    process of the group must call this (``dist.new_group`` is
    collective), and the processes past the cap get a mesh with ``rank``
    None. ``devices``: this process's device; by default the one
    ``init_multihost`` picks (``cuda:{LOCAL_RANK}``), or ``cuda`` without
    a group.
    """
    grouped, world, rank = _world()
    size = world if n_devices is None else n_devices
    if not 1 <= size <= world:
        raise ValueError(
            f"a data axis of {size} device(s) needs 1 to {world} processes "
            f"({_has(grouped, world)})"
        )
    if not grouped:
        group = None
    elif size == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(size)))
    return Mesh(group=group, size=size, rank=rank if rank < size else None,
                device=_device(devices, grouped))


def _world():
    """(whether a group is joined, its size, this process's rank)."""
    grouped = dist.is_available() and dist.is_initialized()
    if not grouped:
        return False, 1, 0
    return True, dist.get_world_size(), dist.get_rank()


def _has(grouped: bool, world: int) -> str:
    return (f"this group has {world}" if grouped
            else "this process has no group: 1")


def _device(devices, grouped: bool) -> torch.device:
    """This process's device: ``devices``, else ``cuda:{LOCAL_RANK}`` in a
    group, else ``cuda``."""
    if devices is not None:
        return torch.device(devices)
    if grouped:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return torch.device("cuda")


def make_mesh_2d(n_data: int, n_time: int, devices=None) -> Mesh:
    """A 2-D ``("data", "time")`` mesh over the first ``n_data * n_time``
    processes, laid out as the JAX function reshapes its devices: rank
    ``d * n_time + t`` is data rank d and time rank t. Every data axis (the
    ranks of one t) and time axis (the ranks of one d) of more than one
    process gets its group, built with ``dist.new_group`` by every process
    in the same order, so every process of the group must call this; the
    processes past the mesh get ``rank`` None. Without a group the mesh is
    ``(1, 1)``. ``devices``: as ``make_mesh``'s.
    """
    grouped, world, rank = _world()
    if n_data < 1 or n_time < 1 or n_data * n_time > world:
        raise ValueError(
            f"a {n_data}x{n_time} (data x time) mesh needs {n_data * n_time} "
            f"processes ({_has(grouped, world)})")

    def group(ranks):
        if len(ranks) == 1:
            return None
        if len(ranks) == world:
            return dist.group.WORLD
        return dist.new_group(ranks)

    data = [group([d * n_time + t for d in range(n_data)])
            for t in range(n_time)]
    time = [group([d * n_time + t for t in range(n_time)])
            for d in range(n_data)]
    device = _device(devices, grouped)
    if rank >= n_data * n_time:
        return Mesh(group=None, size=n_data, rank=None, device=device)
    d, t = divmod(rank, n_time)
    return Mesh(group=data[t], size=n_data, rank=d, device=device,
                time=TimeAxis(group=time[d], size=n_time, rank=t))


@contextlib.contextmanager
def set_mesh(mesh: Mesh):
    """Make ``mesh``'s time axis the active one inside the ``with`` block,
    the counterpart of ``jax.set_mesh``: a solve there whose config sets
    ``time_axis="time"`` and ``parallel_backward`` splits its backward's
    horizon over that axis."""
    with _lqr_parallel.time_axis_scope(mesh.time):
        yield mesh


def _require_axis(mesh: Mesh) -> None:
    if mesh.rank is None:
        raise ValueError("this process is not on the mesh's data axis "
                         f"(the first {mesh.size} processes are)")


def _require_time(mesh: Mesh) -> None:
    _require_axis(mesh)
    if mesh.time is None:
        raise ValueError("a mesh without a time axis: build it with "
                         "make_mesh_2d")


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """Place a batch on this process's device.

    One process: ``x [B, ...]`` is the global batch, and B must divide by
    the axis's size. Several processes: each passes its LOCAL rows, as the
    JAX package's per-host data feed does; nothing is exchanged.
    """
    _require_axis(mesh)
    x = torch.as_tensor(x)
    if mesh.group is None and x.shape[0] % mesh.size != 0:
        raise ValueError(
            f"batch size {x.shape[0]} must be divisible by the "
            f"{mesh.size}-device data axis"
        )
    return x.to(mesh.device)


def _to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init
        })
    return obj


def replicate(tree, mesh: Mesh):
    """A copy of ``tree`` (an env, a ``Bounds``: a dataclass of tensors,
    nested ones included) with its tensors on this process's device; any
    other object is returned as it is."""
    return _to_device(tree, mesh.device)


def solve_ilqr_sharded(env, x0, *, horizon: int,
                       config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
                       mesh: Optional[Mesh] = None,
                       return_trace: bool = False):
    """Data-parallel batched iLQR: this process solves its rows of ``x0``
    (``shard_batch``) with ``ilqr.solve_batch`` on its device, the kernels
    included, as the JAX package's ``shard_map`` runs the solve on each
    device's shard. Returns the local rows' ``ILQRResult``, and with
    ``return_trace`` also their ``ILQRTrace``, ``[I, B_local]`` as in the
    JAX package."""
    if mesh is None:
        mesh = make_mesh()
    return _ilqr.solve_batch(
        replicate(env, mesh), shard_batch(x0, mesh), horizon=horizon,
        config=config, return_trace=return_trace,
    )


def mpc_sharded(env, x0, *, steps: int, plan_horizon: int,
                config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
                mesh: Optional[Mesh] = None) -> _mpc.MPCResult:
    """Data-parallel closed-loop MPC: this process runs ``mpc.run`` on its
    rows of the ``x0 [B, n]`` fleet. Returns the local rows' result."""
    if mesh is None:
        mesh = make_mesh()
    return _mpc.run(replicate(env, mesh), shard_batch(x0, mesh),
                    steps=steps, plan_horizon=plan_horizon, config=config)


def reduce_stats(sums: dict, maxima: dict, mesh: Optional[Mesh] = None):
    """Sum ``sums`` and take the maximum of ``maxima`` (name -> Python
    number) over the mesh's data axis: one all-reduce each, in float64.
    On a ``gloo`` group they are reduced on the CPU, so a card's tensors
    never meet a backend without CUDA collectives; on ``nccl`` on this
    process's card. Returns the two dicts of Python floats."""
    if mesh is None or mesh.group is None:
        return dict(sums), dict(maxima)
    _require_axis(mesh)
    device = mesh.device if dist.get_backend(mesh.group) == "nccl" \
        else torch.device("cpu")
    out = []
    for values, op in ((sums, dist.ReduceOp.SUM), (maxima, dist.ReduceOp.MAX)):
        t = torch.tensor(list(values.values()), dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op=op, group=mesh.group)
        out.append(dict(zip(values, t.tolist())))
    return tuple(out)


def summarize(result: _ilqr.ILQRResult, mesh: Optional[Mesh] = None) -> dict:
    """The seven global statistics of a (sharded) batched solve, those of
    the JAX package's ``summarize``: ``num_converged``,
    ``frac_converged``, ``mean_cost``, ``max_cost``, ``mean_iterations``,
    ``max_iterations`` and ``mean_mu``, as Python numbers. Each process
    passes its local rows; sums and the count are all-reduced with SUM,
    maxima with MAX, and each mean is a global sum over the global count.
    """
    cost = result.total_cost.double()
    iters = result.iterations.double()
    sums, maxima = reduce_stats(
        {"count": float(result.converged.numel()),
         "converged": float(result.converged.sum()),
         "cost": float(cost.sum()), "iterations": float(iters.sum()),
         "mu": float(result.mu.double().sum())},
        {"cost": float(cost.max()), "iterations": float(iters.max())},
        mesh,
    )
    count = sums["count"]
    return {
        "num_converged": int(sums["converged"]),
        "frac_converged": sums["converged"] / count,
        "mean_cost": sums["cost"] / count,
        "max_cost": maxima["cost"],
        "mean_iterations": sums["iterations"] / count,
        "max_iterations": int(maxima["iterations"]),
        "mean_mu": sums["mu"] / count,
    }


def shard_problem_time(problem, mesh: Mesh):
    """This process's block of an ``LQRProblem``'s horizon on ``mesh``'s
    time axis (``F``, ``f``, ``C``, ``c``: its steps, ``lqr_parallel.
    TimeAxis.steps``), with ``C_f``, ``c_f`` whole, as the JAX function
    replicates them, on this process's device: the block that
    ``solve_lqr_time_sharded`` composes here (the whole problem on a time
    axis of one process)."""
    _require_time(mesh)
    problem = replicate(problem, mesh)
    if mesh.time.size == 1:
        return problem
    return _lqr_parallel.time_block(problem, mesh.time)


def solve_lqr_time_sharded(problem, x0, mesh: Optional[Mesh] = None):
    """LQR solve with the O(log T) backward's horizon split over ``mesh``'s
    time axis (by default every process of the group, ``make_mesh_2d(1,
    world)``): every process passes the whole problem and ``x0`` and gets
    the whole ``(states, actions, costs)``, the same result as
    ``lqr.solve(problem, x0, parallel=True)`` up to the composition's
    rounding."""
    if mesh is None:
        mesh = make_mesh_2d(1, _world()[1])
    _require_time(mesh)
    return _lqr.solve(replicate(problem, mesh),
                      torch.as_tensor(x0, device=mesh.device),
                      parallel=True, time=mesh.time)


def solve_ilqr_time_sharded(env, x0, *, horizon: int,
                            config: _ilqr.ILQRConfig = _ilqr.ILQRConfig(),
                            mesh: Optional[Mesh] = None,
                            return_trace: bool = False):
    """iLQR with the backward's horizon split over ``mesh``'s time axis,
    the sequence-parallel path for long horizons (by default every process
    of the group, ``make_mesh_2d(1, world)``).

    Forces ``parallel_backward`` (the associative composition is what
    splits; a sequential recursion cannot) and ``time_axis="time"``, and
    ``use_pallas=False``, as the JAX function does: there the kernels'
    operands would arrive sharded over the mesh, which a ``pallas_call``
    does not take, and ``parallel_backward`` already keeps the Riccati
    kernels off. It composes with ``boxqp`` through the parallel boxQP
    re-pass.

    A 1-D ``x0`` goes through ``ilqr.solve`` (``return_trace`` then raises,
    as in the JAX package). A 2-D ``x0`` is this process's rows of the
    batch (``shard_batch``: the rows of its data rank, the same on every
    rank of its time axis) and goes through ``ilqr.solve_batch``; with
    ``return_trace`` its ``ILQRTrace`` comes too. Every process of a time
    axis returns the same whole-horizon result.
    """
    if mesh is None:
        mesh = make_mesh_2d(1, _world()[1])
    _require_time(mesh)
    cfg = dataclasses.replace(config, parallel_backward=True,
                              time_axis=TIME_AXIS, use_pallas=False)
    env = replicate(env, mesh)
    x0 = torch.as_tensor(x0, device=mesh.device)
    with set_mesh(mesh):
        if x0.ndim == 1:
            if return_trace:
                raise ValueError(
                    "return_trace needs the batched path; pass x0[None]")
            return _ilqr.solve(env, x0, horizon=horizon, config=cfg)
        return _ilqr.solve_batch(env, shard_batch(x0, mesh),
                                 horizon=horizon, config=cfg,
                                 return_trace=return_trace)
