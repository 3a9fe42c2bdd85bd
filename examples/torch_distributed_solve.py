"""Split a scenario batch over processes, one per device, with the PyTorch
port.

The port of ``examples/distributed_solve.py``. ``solve_ilqr_sharded``
solves this process's rows of the batch with ``ilqr.solve_batch`` on its
device (the CUDA kernels on a card), and ``summarize`` all-reduces the
batch's seven statistics: the only communication. Run alone, the process
is a mesh of one device. Launched by ``torchrun``, every process joins the
group (``init_multihost``: NCCL on cards, gloo with ``--device cpu``) and
takes its share of the rows:

    python examples/torch_distributed_solve.py            (one card)
    python examples/torch_distributed_solve.py --device cpu
    torchrun --nproc-per-node 4 examples/torch_distributed_solve.py

Then, as the JAX example does, data and time parallelism in one solve: a
2-D ``("data", "time")`` mesh (``make_mesh_2d``) whose time axis of two
processes splits the parallel backward's horizon while its data axis
splits the batch (a mesh of one process, 1x1, when run alone or on an odd
number of processes).
"""

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from tfmpc_tpu_torch import ILQRConfig, make_navigation
from tfmpc_tpu_torch.parallel import mesh as pmesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if joined:
        device = pmesh.init_multihost(device=device)
    try:
        mesh = pmesh.make_mesh(devices=device)
        cpu = device.type == "cpu"
        env = make_navigation(
            goal=[8.0, -5.0],
            deceleration={"center": [[3.0, -2.0]], "decay": [2.0]},
            device=device,
        )
        B = (128 if cpu else 1024) // mesh.size * mesh.size
        T = 12 if cpu else 50
        x0 = np.random.default_rng(0).uniform(-10, 10, size=(B, 2)).astype(
            "f4")
        rows = B // mesh.size
        local = x0 if mesh.group is None \
            else x0[mesh.rank * rows:(mesh.rank + 1) * rows]
        result = pmesh.solve_ilqr_sharded(
            env, local, horizon=T, mesh=mesh,
            config=ILQRConfig(atol=1e-4, max_iterations=30, use_pallas=True),
        )
        stats = pmesh.summarize(result, mesh)
        if mesh.rank == 0:
            print(f"{B} scenarios over {mesh.size} device(s): "
                  f"{stats['num_converged']} converged, "
                  f"mean cost {stats['mean_cost']:.4f}, "
                  f"mean iterations {stats['mean_iterations']:.1f}")
        # each process's trajectories stay on its own device: nothing gathered
        print(f"rank {mesh.rank}: {result.states.shape[0]} trajectories on "
              f"{result.states.device}")

        # combined data x time: the batch over the data axis and the
        # horizon over the time axis of one 2-D mesh, in one solve
        world = dist.get_world_size() if joined else 1
        n_time = 2 if world % 2 == 0 else 1
        mesh2 = pmesh.make_mesh_2d(world // n_time, n_time, devices=device)
        rows = B // mesh2.size
        res_dt = pmesh.solve_ilqr_time_sharded(
            env, x0[mesh2.rank * rows:(mesh2.rank + 1) * rows], horizon=T,
            config=ILQRConfig(atol=1e-4, max_iterations=30,
                              parallel_backward=True),
            mesh=mesh2,
        )
        stats = pmesh.summarize(res_dt, mesh2)
        if mesh2.rank == 0 and mesh2.time.rank == 0:
            print(f"combined data x time ({mesh2.size}x{n_time}): "
                  f"{stats['num_converged']} of {B} converged, mean cost "
                  f"{stats['mean_cost']:.4f}, each time rank holding its "
                  f"data rank's {rows} whole trajectories")
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
