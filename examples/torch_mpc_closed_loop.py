"""Closed-loop receding-horizon MPC on the navigation environment, with the
PyTorch port.

The port of ``examples/mpc_closed_loop.py``. ``mpc.run`` re-solves a
short-horizon iLQR instance at every control step (warm-started from the
previous plan), applies the first action and steps the true dynamics. On
the card each re-plan runs the CUDA kernels (``use_pallas=True``).

Run: python examples/torch_mpc_closed_loop.py            (on the card)
     python examples/torch_mpc_closed_loop.py --device cpu
"""

import argparse

import torch

from tfmpc_tpu_torch import ILQRConfig, make_navigation, mpc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)
    cpu = device.type == "cpu"
    env = make_navigation(
        goal=[8.0, -5.0],
        deceleration={"center": [[3.0, -2.0]], "decay": [2.0]},
        device=device,
    )
    result = mpc.run(
        env, torch.zeros(2, device=device), steps=20 if cpu else 30,
        plan_horizon=10,
        config=ILQRConfig(atol=1e-6, max_iterations=15, use_pallas=True),
    )
    final = result.states[-1]
    print(f"closed-loop final state: [{float(final[0]):.3f}, "
          f"{float(final[1]):.3f}]  (goal [8, -5])")
    print(f"realized cost: {float(result.costs.sum()):.4f}")
    print(f"per-step replan converged: "
          f"{float(result.converged.float().mean()):.1%}")


if __name__ == "__main__":
    main()
