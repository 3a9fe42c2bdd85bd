"""Checkpoint a batched solve and resume it, with the PyTorch port.

The port of ``examples/checkpoint_resume.py``. ``solve_batch(...,
max_iterations=k)`` runs k outer iterations; ``state_from_result``
captures the full solver state (trajectories, mu, convergence masks),
``checkpoint.save_state`` writes it with its metadata (the JAX package's
``.npz`` format, so either package resumes the other's), and
``ilqr_batched.resume`` continues until convergence with the result of an
uninterrupted solve. On the card the solves run the CUDA kernels (K4 and
K5 at reservoir-5).

Run: python examples/torch_checkpoint_resume.py            (on the card)
     python examples/torch_checkpoint_resume.py --device cpu
"""

import argparse
import os
import tempfile

import numpy as np
import torch

from tfmpc_tpu_torch import (
    ILQRConfig,
    checkpoint,
    ilqr,
    make_reservoir,
    state_from_result,
)
from tfmpc_tpu_torch.solvers import ilqr_batched


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    cpu = device.type == "cpu"
    B, T = (16, 30) if cpu else (64, 100)
    env = make_reservoir(5, device=device)
    x0 = torch.as_tensor(
        np.random.default_rng(0).uniform(20, 95, size=(B, 5)).astype("f4"),
        device=device)
    cfg = ILQRConfig(atol=1e-4, max_iterations=30, boxqp=True,
                     use_pallas=True)

    # run the first 5 iterations, then "lose the job"
    partial = ilqr.solve_batch(
        env, x0, horizon=T,
        config=ILQRConfig(atol=1e-4, max_iterations=5, boxqp=True,
                          use_pallas=True),
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solve.ckpt.npz")
        checkpoint.save_state(path, state_from_result(partial))
        print(f"checkpointed after 5 iterations -> {path}")

        # resume in a fresh context
        restored = checkpoint.load_state(path, device=device)
    final = ilqr_batched.resume(env, restored, config=cfg)
    frac = float(final.converged.float().mean())
    print(f"resumed to convergence: {frac:.1%} converged, "
          f"mean cost {float(final.total_cost.mean()):.2f}")

    # the same as the uninterrupted solve
    direct = ilqr.solve_batch(env, x0, horizon=T, config=cfg)
    dev = float((final.actions - direct.actions).abs().max())
    print(f"max control deviation vs uninterrupted solve: {dev:.1e}")


if __name__ == "__main__":
    main()
