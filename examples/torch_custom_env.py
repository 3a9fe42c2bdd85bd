"""Define a custom environment and solve it with the PyTorch port.

The port of ``examples/custom_env.py``. Any env with ``transition`` /
``cost`` / ``final_cost`` over ``[..., n]`` / ``[..., m]`` tensors is a full
citizen: derivatives come from ``torch.func`` autodiff, bounds turn on
control-limited DDP (``boxqp=True``), and its step, traced and compiled
into a step functor at the first launch (``Env.generic_device_step``),
gives it the CUDA rollout kernels on the card with no extra code
(``use_pallas=True``), as the JAX package's generic lane adapter gives it
the Pallas kernels on a TPU. On the CPU the solve takes the plain path.

Run: python examples/torch_custom_env.py            (on the card)
     python examples/torch_custom_env.py --device cpu
"""

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from tfmpc_tpu_torch import Bounds, Env, ILQRConfig, ilqr


@dataclasses.dataclass(frozen=True, eq=False)
class DampedChain(Env):
    """Diffusively coupled nodes with cubic damping and bounded actuation."""

    coupling: torch.Tensor              # [d, d]
    bounds: Optional[Bounds] = None

    @property
    def state_size(self):
        return self.coupling.shape[0]

    @property
    def action_size(self):
        return self.coupling.shape[0]

    def transition(self, x, u):
        return x + 0.1 * (x @ self.coupling.T - 0.02 * x**3 + u)

    def cost(self, x, u):
        return (x * x).sum(-1) + 0.1 * (u * u).sum(-1)

    def final_cost(self, x):
        return 5.0 * (x * x).sum(-1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    cpu = device.type == "cpu"
    d = 6
    B, T = (128, 15) if cpu else (512, 40)
    C = (-2.0 * np.eye(d) + np.eye(d, k=1) + np.eye(d, k=-1)) * 0.3
    env = DampedChain(
        coupling=torch.as_tensor(C, dtype=torch.float32, device=device),
        bounds=Bounds(low=torch.full((d,), -1.0, device=device),
                      high=torch.full((d,), 1.0, device=device)),
    )
    # single scenario, control-limited DDP
    x0 = torch.linspace(-1.5, 1.5, d, device=device)
    res = ilqr.solve(env, x0, horizon=T,
                     config=ILQRConfig(atol=1e-6, max_iterations=30,
                                       boxqp=True))
    print(f"single solve: converged={bool(res.converged)} "
          f"cost={float(res.total_cost):.4f} "
          f"iterations={int(res.iterations)}")
    print(f"  max |u| = {float(res.actions.abs().max()):.3f} (bound 1.0)")

    # a scenario batch in one batched solve: the CUDA kernels on the card,
    # the rollouts on the env's generated step
    config = ILQRConfig(atol=1e-6, max_iterations=30, boxqp=True,
                        use_pallas=not cpu)
    print(f"use_pallas={config.use_pallas}")
    x0_batch = torch.as_tensor(
        np.random.default_rng(0).uniform(-2, 2, size=(B, d)).astype("f4"),
        device=device)
    resb = ilqr.solve_batch(env, x0_batch, horizon=T, config=config)
    frac = float(resb.converged.float().mean())
    print(f"batched solve: {B} scenarios, {frac:.1%} converged, "
          f"mean cost {float(resb.total_cost.mean()):.4f}")


if __name__ == "__main__":
    main()
