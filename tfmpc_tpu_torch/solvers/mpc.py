"""Receding-horizon MPC over the batched iLQR solver.

Counterpart of ``tfmpc_tpu/solvers/mpc.py``. Each control step re-plans a
``plan_horizon`` iLQR problem from the realized state, warm-started from
the previous plan shifted by one (its last action repeated), applies the
plan's first action and advances the true dynamics. A ``[B, n]`` batch of
closed loops runs as one batch of re-plans.

The JAX package compiles the loop over steps into one ``lax.scan``; here it
is a host loop of ``ilqr_batched._solve_batch_impl`` calls, each with the
solver's own host syncs. With ``use_pallas=True`` on CUDA every re-plan
runs the kernels (with ``fuse_derivatives``, K1, K2 and K8 on navigation)
or raises: there is no fallback (the JAX package's ``with_kernel_fallback``
is not ported).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig
from tfmpc_tpu_torch.solvers.ilqr_batched import _solve_batch_impl


class MPCResult(NamedTuple):
    """Closed-loop rollout of ``steps`` MPC decisions (batched: leading B).

    states:      [B, steps+1, n] realized closed-loop states
    actions:     [B, steps, m]   executed first actions of each plan
    costs:       [B, steps]      realized stage costs
    final_cost:  [B]             final cost at states[:, -1]
    total_cost:  [B]             sum(costs) + final_cost
    plan_cost:   [B, steps]      each re-plan's predicted total cost
    iterations:  [B, steps]      solver iterations of each re-plan
    converged:   [B, steps]      each re-plan's convergence
    """

    states: torch.Tensor
    actions: torch.Tensor
    costs: torch.Tensor
    final_cost: torch.Tensor
    total_cost: torch.Tensor
    plan_cost: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def run(env, x0, *, steps: int, plan_horizon: int,
        config: ILQRConfig = ILQRConfig()) -> MPCResult:
    """Closed-loop receding-horizon MPC from ``x0 [B, n]`` (or ``[n]``, and
    then every field loses its batch axis).

    The first plan starts from ``env.clip`` of zero controls; each later
    one from the previous plan shifted by one step, its last action
    repeated.
    """
    single = x0.ndim == 1
    if single:
        x0 = x0[None]
    B = x0.shape[0]
    U = env.clip(torch.zeros((B, plan_horizon, env.action_size),
                             dtype=x0.dtype, device=x0.device))
    x = x0
    xs, us, costs, plan, iters, conv = [x0], [], [], [], [], []
    for _ in range(steps):
        res = _solve_batch_impl(env, x, U, None, config)
        u = res.actions[:, 0]
        costs.append(env.cost(x, u))
        x = env.transition(x, u)
        U = torch.cat([res.actions[:, 1:], res.actions[:, -1:]], dim=1)
        xs.append(x)
        us.append(u)
        plan.append(res.total_cost)
        iters.append(res.iterations)
        conv.append(res.converged)
    final = env.final_cost(x)
    costs = torch.stack(costs, dim=1)
    result = MPCResult(
        states=torch.stack(xs, dim=1),
        actions=torch.stack(us, dim=1),
        costs=costs,
        final_cost=final,
        total_cost=costs.sum(dim=1) + final,
        plan_cost=torch.stack(plan, dim=1),
        iterations=torch.stack(iters, dim=1),
        converged=torch.stack(conv, dim=1),
    )
    if single:
        result = MPCResult(*(a[0] for a in result))
    return result
