"""Data-parallel batched solves on ``torch.distributed``.

Counterpart of the data-parallel half of ``tfmpc_tpu/parallel/mesh.py``.
The JAX module runs one controller over a 1-D ``("data",)`` device mesh
(``shard_map``) and ``jax.distributed`` across hosts. Here, as PyTorch
does it, there is one process per device on a ``torch.distributed``
process group, and one process without a group is a mesh of one device.
Scenarios are independent, so each process solves its own rows with
``ilqr.solve_batch`` or ``mpc.run``, the CUDA kernels included, and its
results stay on its device. The only communication is ``summarize``'s
two all-reduces of the batch's statistics.

Launch one process per card with ``torchrun`` (which sets the ``env://``
variables and ``LOCAL_RANK``), or give ``init_multihost`` the address,
rank and world size yourself.

The time-sharded half of the JAX module (``make_mesh_2d``,
``shard_problem_time``, ``solve_lqr_time_sharded``,
``solve_ilqr_time_sharded``) is not ported yet: ROADMAP queue 1 item 1.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from tfmpc_tpu_torch.solvers import ilqr as _ilqr
from tfmpc_tpu_torch.solvers import mpc as _mpc

DATA_AXIS = "data"
TIME_AXIS = "time"  # the name only; the time-sharded solves are not ported

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
    """The data axis as one process sees it.

    ``group``: the axis's process group, None for one process without a
    group; ``size``: the processes on the axis; ``rank``: this process's
    place on it, None for a process that a cap left off the axis;
    ``device``: this process's device.
    """

    group: Optional[object]
    size: int
    rank: Optional[int]
    device: torch.device


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
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    size = world if n_devices is None else n_devices
    if not 1 <= size <= world:
        raise ValueError(
            f"a data axis of {size} device(s) needs 1 to {world} processes "
            f"(this {'group has' if grouped else 'process has no group:'} "
            f"{world})"
        )
    if not grouped:
        group = None
    elif size == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(size)))
    if devices is not None:
        device = torch.device(devices)
    elif grouped:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    else:
        device = torch.device("cuda")
    return Mesh(group=group, size=size, rank=rank if rank < size else None,
                device=device)


def _require_axis(mesh: Mesh) -> None:
    if mesh.rank is None:
        raise ValueError("this process is not on the mesh's data axis "
                         f"(the first {mesh.size} processes are)")


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
