"""Batch-explicit iLQR: the throughput path behind ``solve_batch``.

Counterpart of ``tfmpc_tpu/solvers/ilqr_batched.py`` (its split pipeline).
Semantically identical to solving each scenario with ``ilqr.solve``: the
divergent per-scenario control flow (mu escalation, line-search acceptance,
convergence) is masked arithmetic over the leading batch axis, and a
scenario that is done freezes. One iteration is

1. the closed-form linearization (``ilqr.derivatives``);
2. the Riccati backward inside the per-lane restart loop, compacted to the
   failing lanes when B > 128 (with ``use_pallas``: kernel K1, or K4 for
   ``boxqp`` on a bounded env, and with ``ddp`` K6a or K6b, which also take
   the dynamics Hessians of step 1, at the lane kernels' dims; K7 at other
   dims up to 48, and its full-DDP variants at other dims up to 12; with
   ``parallel_backward``: the O(log T) composition of ``lqr_parallel.py``);
3. the 11-alpha line search (K2), controls clipped to a bounded env's box;
4. acceptance and the mu schedule, with the KKT stationarity test of a
   bounded env where a lane accepted nothing;
5. the rollout at each scenario's accepted alpha (K3).

With the emit-trajectories layout (``_resolve_emit_traj``), steps 3 and 5
become one chain: K5 writes every alpha's cost and trajectory, and step 5
selects each scenario's accepted one.

The fully-fused iteration (``ILQRConfig.fuse_derivatives``, the JAX
package's ``_iteration_fused``; routed by ``_use_fused_derivs``) drops step
1 from the loop: step 5 runs K8, which also writes the linearization of
the new trajectory in the Riccati kernels' ``[T, entries, B]`` layout, and
the loop carries those blocks (``kargs``) into the next backward (K1, or K4
for ``boxqp``; K7 at dims without a lane instantiation), whose policy goes
to K2 and K8 in that layout as it is. A solve linearizes once, along its
initial (or resumed) trajectory (``_initial_kargs``). Where the JAX
package takes its split iteration by design (an env without a device
linearization, dims above 12), so does this one, on every device.

The JAX package's ``lax.while_loop``s become host loops that read one flag
per outer iteration and one per restart round (and, for a bounded env, one
for whether any lane stalled). With ``use_pallas=True`` on CUDA tensors the
stages run the CUDA kernels or raise (an env without a device step, or
dims without a kernel instantiation); nothing falls back to the plain path.
Where the JAX package runs its XLA route by design, the plain stages are
the route on every device: the backward of full DDP above 12 and every
stage above 48 (``_riccati_kernel_mode``, ``_rollout_dims_supported``);
where it takes its split iteration, so does this package
(``_use_fused_derivs``).
``use_pallas=False`` is the plain PyTorch path. Any batch size runs the
kernels: they mask the ragged edge themselves, so there is no lane
padding. The stages carry ``torch.profiler.record_function`` ranges
(``ilqr.derivatives``, ``ilqr.backward``, ``ilqr.linesearch``,
``ilqr.materialize``, ``ilqr.kkt``), the JAX package's named scopes, so a
profiler trace attributes time to them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from tfmpc_tpu_torch.core.types import map_fields
from tfmpc_tpu_torch.ops import riccati, riccati_mid, rollout
from tfmpc_tpu_torch.solvers.ilqr import (
    ILQRConfig,
    ILQRResult,
    ILQRTrace,
    _decrease_mu,
    _increase_mu,
    _kkt_stationary,
    backward,
    derivatives,
    forward,
    second_derivatives,
)


class SolverState(NamedTuple):
    """Complete per-scenario solver state: the checkpoint/resume unit."""

    X: torch.Tensor          # [B, T+1, n]
    U: torch.Tensor          # [B, T, m]
    J: torch.Tensor          # [B]
    mu: torch.Tensor         # [B]
    delta: torch.Tensor      # [B]
    iteration: torch.Tensor  # [B] int32
    converged: torch.Tensor  # [B] bool
    failed: torch.Tensor     # [B] bool
    residual: torch.Tensor   # [B]


def state_from_result(result: ILQRResult) -> SolverState:
    """Rebuild the resumable solver state from a batched solve result."""
    return SolverState(
        X=result.states,
        U=result.actions,
        J=result.total_cost,
        mu=result.mu,
        delta=result.delta,
        iteration=result.iterations,
        converged=result.converged,
        failed=result.failed,
        residual=result.residual,
    )


# The JAX package's lane kernel runs full DDP up to this dim on the TPU;
# above it the JAX package runs its vmapped scan, and so does this one
# (riccati_mid.MID_DDP_DIM_MAX, K7's DDP variants' ceiling, is the same).
DDP_LANE_DIM_MAX = riccati_mid.MID_DDP_DIM_MAX
# The JAX package's dims rule for the fused iteration
# (tfmpc_tpu/solvers/ilqr_batched.py:_use_fused_derivs): above it, the
# split iteration. A rule of the reference's, not a tuning constant of
# this card.
FUSED_DIM_MAX = 12


class _IterationAux(NamedTuple):
    alpha: torch.Tensor      # [B] accepted step size (0 where none accepted)
    accepted: torch.Tensor   # [B] bool


def _riccati_kernel_mode(n: int, m: int, config: ILQRConfig, device):
    """Which Riccati kernel family a batch at dims (n, m) runs on ``device``.

    None: the plain backward (``use_pallas=False``, or
    ``parallel_backward``, which owns the backward pass even with
    ``use_pallas``, as in the JAX package). "lane": K1/K4/K6a/K6b, for the
    dims they are instantiated at (``riccati.KERNEL_DIMS``). "mid": K7, for
    any other dims within ``riccati_mid.mid_kernel_supported``, and with
    ``ddp`` its full-DDP variants at max(n, m) <= ``DDP_LANE_DIM_MAX``.

    Where the JAX package runs its vmapped scan by design, the plain
    backward runs on every device too: full DDP at max(n, m) > 12 (its
    lane kernel stops at 12 and its mid kernel has no DDP terms) and any
    max(n, m) > ``riccati_mid.MID_DIM_MAX``. The lane/mid boundary is the
    port's own (the kernels' instantiations), not the JAX package's TPU
    lane limit of 12. The route is the same on every ``device``: on the
    CPU each wrapper runs its plain version.
    """
    if not config.use_pallas or config.parallel_backward:
        return None
    if (n, m) in riccati.KERNEL_DIMS:
        return "lane"
    if not riccati_mid.mid_kernel_supported(n, m) \
            or (config.ddp and max(n, m) > DDP_LANE_DIM_MAX):
        return None
    return "mid"


def _backward_batched(lin, quad, final, mu, config: ILQRConfig, bounds,
                      Ubar, second=None):
    """Batched regularized Riccati backward over [B] scenarios, routed by
    ``_riccati_kernel_mode``: the lane kernels' wrappers (K4 for ``boxqp``
    on a bounded env and K1 otherwise, or with the dynamics Hessians
    ``second`` (``ddp``) K6b and K6a), K7's (its boxQP variant under the
    same condition, its full-DDP variants with ``second``), or the plain
    ``backward``. A wrapper launches its CUDA kernel on CUDA tensors and
    runs its plain version on CPU tensors.
    """
    n, m = lin.f_x.shape[-1], lin.f_u.shape[-1]
    mode = _riccati_kernel_mode(n, m, config, lin.f_x.device)
    box = config.boxqp and bounds is not None
    if mode == "lane":
        if second is not None:
            if box:
                return riccati.riccati_backward_ddp_boxqp(
                    lin, quad, final, mu, bounds, Ubar, second,
                    config.boxqp_iters)
            return riccati.riccati_backward_ddp(lin, quad, final, mu, second)
        if box:
            return riccati.riccati_backward_boxqp(
                lin, quad, final, mu, bounds, Ubar, config.boxqp_iters)
        return riccati.riccati_backward(lin, quad, final, mu)
    if mode == "mid":
        if second is not None:
            if box:
                return riccati_mid.riccati_backward_mid_ddp_boxqp(
                    lin, quad, final, mu, bounds, Ubar, second,
                    config.boxqp_iters)
            return riccati_mid.riccati_backward_mid_ddp(lin, quad, final, mu,
                                                        second)
        if box:
            return riccati_mid.riccati_backward_mid_boxqp(
                lin, quad, final, mu, bounds, Ubar, config.boxqp_iters)
        return riccati_mid.riccati_backward_mid(lin, quad, final, mu)
    return backward(lin, quad, final, mu, config, bounds, Ubar, second)


_RESTART_SUB_BATCH = 128  # gathered-retry width of the compacted restarts


def _lane_needs(ok, mu, tries, config: ILQRConfig):
    return (~ok) & (mu < config.mu_max) & (tries < config.max_backward_restarts)


def _backward_restarts_batched(lin, quad, final, mu, delta,
                               config: ILQRConfig, bounds=None, Ubar=None,
                               second=None):
    """Per-scenario restart-on-non-PD loop, batch-wide.

    For B > ``_RESTART_SUB_BATCH`` the retries run on a sub-batch of only
    the failing lanes (``_restart_loop_compacted``), with their rows of
    ``Ubar`` and of the dynamics Hessians ``second`` gathered; every lane
    sees the same (escalate mu -> attempt) sequence as in the full-batch
    loop.
    """

    def attempt(mu_):
        return _backward_batched(lin, quad, final, mu_, config, bounds, Ubar,
                                 second)

    R = _RESTART_SUB_BATCH
    if mu.shape[0] <= R:
        return _restart_loop(attempt, mu, delta, config)

    def attempt_sub(idx, mu_sub):
        sub = lambda a: a.index_select(0, idx)  # noqa: E731
        return _backward_batched(
            map_fields(sub, lin), map_fields(sub, quad),
            map_fields(sub, final), mu_sub, config, bounds,
            None if Ubar is None else sub(Ubar),
            None if second is None else map_fields(sub, second),
        )

    return _restart_loop_compacted(attempt, attempt_sub, mu, delta, config, R)


def _restart_loop_compacted(attempt, attempt_sub, mu, delta, config, R,
                            policy_batch_last=False):
    """Restart loop re-running only (up to R) failing lanes per round.

    A stable argsort of the needs mask gathers the failing lanes to the
    front (the order the JAX package's ``jnp.argsort`` gives), the backward
    re-runs on that sub-batch, and results scatter back to the rows that
    retried. Lanes beyond R in a round wait, their mu and tries untouched.
    ``policy_batch_last``: the policy's fields carry the batch on their
    last axis (the kernel layout of the fused iteration).
    """
    ok, policy, dV1, dV2 = attempt(mu)
    tries = torch.zeros_like(mu, dtype=torch.int32)
    while True:
        needs = _lane_needs(ok, mu, tries, config)
        if not bool(needs.any()):
            break
        idx = torch.argsort((~needs).to(torch.uint8), stable=True)[:R]
        sel = needs[idx]                        # which gathered rows retry
        attempted = torch.zeros_like(needs)
        attempted[idx] = sel

        mu_inc, delta_inc = _increase_mu(mu, delta, config)
        mu = torch.where(attempted, mu_inc, mu)
        delta = torch.where(attempted, delta_inc, delta)
        ok_s, policy_s, dV1_s, dV2_s = attempt_sub(idx, mu[idx])

        def scatter(full, subv, batch_last=False):
            out = full.clone()
            if batch_last:
                mask = sel.reshape((1,) * (subv.ndim - 1) + (-1,))
                out[..., idx] = torch.where(mask, subv, full[..., idx])
            else:
                mask = sel.reshape((-1,) + (1,) * (subv.ndim - 1))
                out[idx] = torch.where(mask, subv, full[idx])
            return out

        ok = scatter(ok, ok_s)
        policy = map_fields(lambda f, v: scatter(f, v, policy_batch_last),
                            policy, policy_s)
        dV1 = scatter(dV1, dV1_s)
        dV2 = scatter(dV2, dV2_s)
        tries = tries + attempted.to(torch.int32)
    return ok, policy, dV1, dV2, mu, delta


def _restart_loop(attempt, mu, delta, config: ILQRConfig,
                  policy_batch_last=False):
    ok, policy, dV1, dV2 = attempt(mu)
    tries = torch.zeros_like(mu, dtype=torch.int32)
    while True:
        needs = _lane_needs(ok, mu, tries, config)
        if not bool(needs.any()):
            break
        mu_inc, delta_inc = _increase_mu(mu, delta, config)
        mu = torch.where(needs, mu_inc, mu)
        delta = torch.where(needs, delta_inc, delta)
        ok_n, policy_n, dV1_n, dV2_n = attempt(mu)

        def sel(new, old, batch_last=False):  # merge the lanes that restarted
            shape = ((1,) * (new.ndim - 1) + (-1,) if batch_last
                     else (-1,) + (1,) * (new.ndim - 1))
            return torch.where(needs.reshape(shape), new, old)

        ok = sel(ok_n, ok)
        policy = map_fields(lambda n_, o: sel(n_, o, policy_batch_last),
                            policy_n, policy)
        dV1 = sel(dV1_n, dV1)
        dV2 = sel(dV2_n, dV2)
        tries = tries + needs.to(torch.int32)
    return ok, policy, dV1, dV2, mu, delta


def _linesearch_batched(env, X, U, policy, alphas):
    """[B, A] closed-loop rollouts: every scenario tries every alpha."""
    return forward(
        env, X[:, None], U[:, None], map_fields(lambda a: a[:, None], policy),
        alphas[None, :],
    )


def _rollout_dims_supported(n: int, m: int) -> bool:
    """Whether the rollout kernels may run at dims (n, m): the JAX
    package's ``_rollout_dims_supported``, max(n, m) <= ``MID_DIM_MAX``.
    Above it the backward already runs plain, and the line search and
    materialize run plain on every device as the JAX package runs its XLA
    rollout there. Below it K2, K3 and K5 run at every dim: an unrolled
    instantiation where one covers the env and dims, the generic form
    (``csrc/rollout_generic.cuh``) elsewhere (``rollout.rollout_plan``)."""
    return max(n, m) <= riccati_mid.MID_DIM_MAX


def _use_pallas_rollout(env, config: ILQRConfig, device) -> bool:
    """Whether the line search runs through K2/K3/K5's wrappers.

    No with ``use_pallas=False`` or dims past ``_rollout_dims_supported``.
    An env without a device step keeps the plain rollout on the CPU, as the
    JAX package keeps the XLA path for an env without lane functions; on
    CUDA with ``use_pallas`` that is an error, not a silent slow path.
    """
    if not config.use_pallas \
            or not _rollout_dims_supported(env.state_size, env.action_size):
        return False
    if env.device_step() is None:
        if torch.device(device).type == "cuda":
            raise NotImplementedError(
                f"use_pallas=True on CUDA, but {type(env).__name__} has no "
                "device step for the rollout kernels (ROADMAP queue 2 item "
                "3); pass use_pallas=False"
            )
        return False
    return True


def _resolve_emit_traj(config: ILQRConfig, horizon: int, n: int,
                       m: int) -> bool:
    """The line-search layout of the kernel path: True and False pin it;
    None (AUTO) takes the emit-trajectories layout (K5 +
    ``select_alpha_trajectory``) at every shape.

    The JAX package's AUTO rule (T >= 250, max(n, m) <= 12) was measured on
    a TPU. On one H100 80GB HBM3 at 700 W, ``tools/kernel_versions.py
    rollout`` timed a line search and its materialize as
    ``_iteration_batched`` runs them (wrappers and layout copies, device
    time of graph replays, in turns), K5 + select against K2 + K3, in ms:
    the navigation headline (B=4096, T=100) 0.1522 vs 0.1871; HVAC-3
    (B=2048, T=100) 0.1554 vs 0.2180; HVAC-6 (B=2048, T=100) 0.2910 vs
    0.3895; reservoir-5 (B=1024, T=500) 0.7468 vs 0.9839; HVAC-16 (B=512,
    T=50) 0.2062 vs 0.3294; two-zone navigation (B=1024, T=20) 0.0486 vs
    0.0574. The emit layout was faster by more than 10% at every measured
    shape (one rollout chain and one layout copy instead of two), so AUTO
    takes it everywhere; it holds every alpha's trajectory, A (n + m)
    values a step and scenario, until the select. At the dims the generic
    form of K2, K3 and K5 runs, ``tools/kernel_versions.py rollout
    --generic-sweep`` timed the same on one H100 80GB HBM3 at 700 W, in
    ms: the double integrator (B=4096, T=100) 0.2192 vs 0.3114;
    reservoir-4 (B=1024, T=100) 0.2285 vs 0.3163; navigation-4 (B=4096,
    T=100) 0.4906 vs 0.4974; reservoir-12 (B=1024, T=100) 0.5601 vs 0.7962;
    the 24-room HVAC ring (B=512, T=50) 0.4731 vs 0.7984; linear (24, 6)
    (B=1024, T=100) 2.1901 vs 3.6354; linear (48, 48) (B=512, T=50) 5.0456
    vs 9.4657. The emit layout is faster there too, so AUTO has no dim
    ceiling, unlike the JAX package's (max(n, m) <= 12, set on a TPU for
    the footprint): at (48, 48), B=4096, T=500 the trajectories take
    8.65 GB in float32, a ninth of the card. ``horizon``, ``n`` and ``m``
    are the inputs a measured crossover would use.
    """
    flag = config.linesearch_emit_trajectories
    return True if flag is None else bool(flag)


def _active(state: SolverState, config: ILQRConfig):
    return (state.iteration < config.max_iterations) & ~state.converged \
        & ~state.failed


def _acceptance(state: SolverState, config: ILQRConfig, alphas, ok, dV1,
                dV2, J_all):
    """The line search's verdict per lane: whether it accepted an alpha
    (the z-test of the actual against the expected reduction), whether the
    backward pass predicts no further decrease (``at_optimum``), and the
    index of the largest accepted alpha: ``(any_accepted, at_optimum,
    best)``, each ``[B]``."""
    expected = -(alphas[None, :] * dV1[:, None]
                 + alphas[None, :] ** 2 * dV2[:, None])
    z = (state.J[:, None] - J_all) / torch.where(
        expected > 0, expected, torch.ones_like(expected)
    )
    accepted = torch.where(
        expected > 0.0, z > config.accept_ratio, J_all < state.J[:, None]
    ) & ok[:, None]
    at_optimum = ok & (-(dV1 + dV2) < config.atol)
    # first True = largest accepted alpha; index 0 on an all-False row,
    # which `upd` masks out in _advance
    best = torch.argmax(accepted.to(torch.uint8), dim=1)
    return accepted.any(dim=1), at_optimum, best


def _advance(env, state: SolverState, config: ILQRConfig, alphas, active,
             any_accepted, at_optimum, best, mu, delta, X_best, U_best,
             J_best):
    """The rest of an iteration once each lane's accepted-alpha trajectory
    is materialized: the update of the lanes that accepted, the KKT test of
    a bounded env, the residual, the mu schedule and the convergence and
    failure flags. Returns ``(new_state, aux)``; ``aux.accepted`` marks the
    lanes that took the new trajectory."""
    upd = active & any_accepted
    X_new = torch.where(upd[:, None, None], X_best, state.X)
    U_new = torch.where(upd[:, None, None], U_best, state.U)
    J_new = torch.where(upd, J_best, state.J)

    # KKT stationarity on the updated controls (bounded envs), computed only
    # when some active lane accepted nothing and applied only to lanes that
    # accepted nothing: the only case in which it changes the outcome
    if env.bounds is not None:
        with record_function("ilqr.kkt"):
            if bool((active & ~any_accepted).any()):
                stationary = _kkt_stationary(env, state.X[:, 0], U_new,
                                             config, axes=(1, 2))
                at_optimum = at_optimum | (stationary & ~any_accepted)

    zero = torch.zeros_like(state.J)
    residual = torch.where(
        any_accepted, state.J - J_new,
        torch.where(at_optimum, zero, zero + torch.inf),
    )

    mu_dec, delta_dec = _decrease_mu(mu, delta, config)
    mu_inc, delta_inc = _increase_mu(mu, delta, config)
    good = any_accepted | at_optimum
    mu_next = torch.where(active, torch.where(good, mu_dec, mu_inc), state.mu)
    delta_next = torch.where(
        active, torch.where(good, delta_dec, delta_inc), state.delta
    )
    converged_now = at_optimum | (any_accepted & (residual.abs() < config.atol))
    failed_now = (~any_accepted) & ~at_optimum & (mu_next >= config.mu_max)

    new_state = SolverState(
        X=X_new,
        U=U_new,
        J=J_new,
        mu=mu_next,
        delta=delta_next,
        iteration=state.iteration + active.to(torch.int32),
        converged=torch.where(active, converged_now, state.converged),
        failed=torch.where(active, state.failed | failed_now, state.failed),
        residual=torch.where(active, residual, state.residual),
    )
    aux = _IterationAux(
        alpha=torch.where(upd, alphas[best], torch.zeros_like(J_new)),
        accepted=upd,
    )
    return new_state, aux


def _iteration_batched(env, state: SolverState, config: ILQRConfig, alphas):
    active = _active(state, config)

    with record_function("ilqr.derivatives"):
        lin, quad, final = derivatives(env, state.X, state.U)
        second = second_derivatives(env, state.X, state.U) if config.ddp \
            else None
    with record_function("ilqr.backward"):
        ok, policy, dV1, dV2, mu, delta = _backward_restarts_batched(
            lin, quad, final, state.mu, state.delta, config, env.bounds,
            state.U, second,
        )
        del second  # the Hessians: free before the line search

    use_kernels = _use_pallas_rollout(env, config, state.X.device)
    emit_traj = use_kernels and _resolve_emit_traj(
        config, state.U.shape[1], env.state_size, env.action_size)
    with record_function("ilqr.linesearch"):
        if emit_traj:
            J_all, X_alpha, U_alpha = rollout.linesearch_costs_traj(
                env, state.X, state.U, policy, config.alphas_static()
            )
        elif use_kernels:
            J_all = rollout.linesearch_costs(
                env, state.X, state.U, policy, config.alphas_static()
            )
        else:
            X_all, U_all, J_all = _linesearch_batched(
                env, state.X, state.U, policy, alphas
            )

    any_accepted, at_optimum, best = _acceptance(state, config, alphas, ok,
                                                 dV1, dV2, J_all)
    with record_function("ilqr.materialize"):
        if emit_traj:
            X_best, U_best, J_best = rollout.select_alpha_trajectory(
                state.X, X_alpha, U_alpha, J_all, best
            )
            del X_alpha, U_alpha  # A trajectories: free before the KKT pass
        elif use_kernels:
            X_best, U_best, J_best = rollout.rollout_alpha(
                env, state.X, state.U, policy, alphas[best]
            )
        else:
            rows = torch.arange(best.shape[0], device=best.device)
            X_best, U_best = X_all[rows, best], U_all[rows, best]
            J_best = J_all[rows, best]

    return _advance(env, state, config, alphas, active, any_accepted,
                    at_optimum, best, mu, delta, X_best, U_best, J_best)


def _use_fused_derivs(env, config: ILQRConfig, device) -> bool:
    """Whether a solve runs the fully-fused iteration (``_iteration_fused``).

    The JAX package's rule (``tfmpc_tpu/solvers/ilqr_batched.py``
    ``_use_fused_derivs``), on every device: ``use_pallas`` and
    ``fuse_derivatives``, neither ``parallel_backward`` nor ``ddp`` (K8
    writes first-order blocks only), max(n, m) <= ``FUSED_DIM_MAX`` and a
    device linearization (``Env.device_derivatives``, the counterpart of
    ``lane_derivatives``: navigation's); else the split iteration runs.
    Its TPU rule B % 128 is not copied: the kernels mask any batch. Where
    the JAX rule fuses, K8 (unrolled or generic) and the backward (the
    lane kernels, or K7 through ``riccati.riccati_backward_lanes``) run at
    every such dim; an env with a device linearization but no device step
    (a user env) raises ``NotImplementedError`` on a CUDA ``device``
    (ROADMAP queue 2 item 3) and takes the split iteration on the CPU,
    where every wrapper runs its plain version.
    """
    if not (config.use_pallas and config.fuse_derivatives) \
            or config.parallel_backward or config.ddp:
        return False
    if max(env.state_size, env.action_size) > FUSED_DIM_MAX \
            or env.device_derivatives() is None:
        return False
    if env.device_step() is not None:
        return True
    if torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"fuse_derivatives=True with use_pallas=True on CUDA, but "
            f"{type(env).__name__} has no device step (Env.device_step) "
            "for the rollout kernels (ROADMAP queue 2 item 3); pass "
            "fuse_derivatives=False")
    return False


def _final_klayout(env, x_last):
    """The final value's quadratic at ``x_last [B, n]`` in the kernel
    layout, ``(l_xx [n*n, B], l_x [n, B])``: the env's closed form
    (``analytic_derivatives`` of the one-point trajectory; an env with
    ``device_derivatives`` has it). Range ``ilqr.backward.final``."""
    n, m = env.state_size, env.action_size
    with record_function("ilqr.backward.final"):
        final = env.analytic_derivatives(
            x_last[:, None], x_last.new_zeros(x_last.shape[0], 0, m))[2]
        return (final.l_xx.reshape(-1, n * n).T.contiguous(),
                final.l_x.T.contiguous())


def _backward_restarts_klayout(env, kargs, x_last, mu, delta,
                               config: ILQRConfig, Ubar):
    """The fused iteration's backward pass with the per-lane restarts, on
    the kernel-layout blocks ``kargs`` (``[T, entries, B]``): K1, or K4 for
    ``boxqp`` on a bounded env (K7's variants at dims without a lane
    instantiation), through ``riccati.riccati_backward_lanes``.
    The final value is ``_final_klayout``'s at ``x_last [B, n]``.
    Returns ``_backward_restarts_batched``'s tuple with the policy ``(K [T,
    m*n, B], k [T, m, B])`` in the layout K2 and K8 take; the compacted
    restarts (B > ``_RESTART_SUB_BATCH``) gather the failing lanes on the
    last axis."""
    n, m = env.state_size, env.action_size
    dtype = kargs["fx"].dtype

    VT, vT = _final_klayout(env, x_last)
    box = None
    if config.boxqp and env.bounds is not None:
        side = lambda a: torch.broadcast_to(  # noqa: E731
            a.to(dtype), (m,)).contiguous()
        box = (Ubar.permute(1, 2, 0).to(dtype).contiguous(),
               side(env.bounds.low), side(env.bounds.high))

    def attempt(mu_):
        return riccati.riccati_backward_lanes(kargs, VT, vT, mu_, box,
                                              config.boxqp_iters)

    R = _RESTART_SUB_BATCH
    if mu.shape[0] <= R:
        return _restart_loop(attempt, mu, delta, config,
                             policy_batch_last=True)

    def attempt_sub(idx, mu_sub):
        sub = lambda a: a.index_select(-1, idx)  # noqa: E731
        return riccati.riccati_backward_lanes(
            {key: sub(v) for key, v in kargs.items()}, sub(VT), sub(vT),
            mu_sub, None if box is None else (sub(box[0]),) + box[1:],
            config.boxqp_iters)

    return _restart_loop_compacted(attempt, attempt_sub, mu, delta, config,
                                   R, policy_batch_last=True)


def _iteration_fused(env, state: SolverState, kargs, config: ILQRConfig,
                     alphas):
    """One fully-fused iteration: the backward on the carried
    linearization blocks ``kargs``, K2 and K8 fed the kernel-layout policy,
    and K8's blocks of the new trajectory carried to the next iteration
    (a lane that keeps its trajectory keeps its blocks). Its semantics
    are ``_iteration_batched``'s. Returns ``(new_state, kargs_new,
    aux)``."""
    active = _active(state, config)
    with record_function("ilqr.backward"):
        ok, pol_lane, dV1, dV2, mu, delta = _backward_restarts_klayout(
            env, kargs, state.X[:, -1], state.mu, state.delta, config,
            state.U,
        )
    with record_function("ilqr.linesearch"):
        J_all = rollout.linesearch_costs(
            env, state.X, state.U, None, config.alphas_static(),
            policy_lane=pol_lane,
        )
    any_accepted, at_optimum, best = _acceptance(state, config, alphas, ok,
                                                 dV1, dV2, J_all)
    with record_function("ilqr.materialize"):
        X_best, U_best, J_best, kargs_cand = rollout.rollout_alpha_derivs(
            env, state.X, state.U, None, alphas[best], policy_lane=pol_lane
        )
    new_state, aux = _advance(env, state, config, alphas, active,
                              any_accepted, at_optimum, best, mu, delta,
                              X_best, U_best, J_best)
    kargs_new = {key: torch.where(aux.accepted, kargs_cand[key], kargs[key])
                 for key in kargs}
    return new_state, kargs_new, aux


def _initial_kargs(env, X, U):
    """The linearization blocks of the stored trajectory ``X``, ``U``, in
    the kernel layout: one ``derivatives`` pass (as the split iteration's)
    and the layout change. A resumed state whose ``X`` deviates from
    ``rollout(x0, U)`` is linearized along its stored ``X``. Runs once per
    solve; K8 writes every later iteration's blocks."""
    lin, quad, final = derivatives(env, X, U)
    a = riccati._to_kernel_layout(lin, quad, final, X.new_zeros(X.shape[0]))
    return {key: a[key] for key in rollout.D_KEYS}


def _initial_state(env, x0, U0, horizon, config: ILQRConfig) -> SolverState:
    B = x0.shape[0]
    if U0 is None:
        if horizon is None:
            raise ValueError("provide either U0 or horizon")
        U0 = torch.zeros((B, horizon, env.action_size), dtype=x0.dtype,
                         device=x0.device)
    U0 = env.clip(U0)
    X0, costs0 = env.rollout(x0, U0)
    full = lambda v, dtype=x0.dtype: torch.full(  # noqa: E731
        (B,), v, dtype=dtype, device=x0.device
    )
    return SolverState(
        X=X0,
        U=U0,
        J=costs0.sum(dim=1),
        mu=full(config.mu_init),
        delta=full(1.0),
        iteration=full(0, torch.int32),
        converged=full(False, torch.bool),
        failed=full(False, torch.bool),
        residual=full(torch.inf),
    )


def _solve_batch_impl(env, x0, U0, horizon, config: ILQRConfig,
                      init_state: Optional[SolverState] = None,
                      return_trace: bool = False):
    if init_state is not None:
        state = init_state
        x0 = state.X[:, 0]
    else:
        state = _initial_state(env, x0, U0, horizon, config)
    alphas = config.alphas(state.X.dtype, state.X.device)
    kargs = None
    if _use_fused_derivs(env, config, state.X.device):
        with record_function("ilqr.derivatives"):
            kargs = _initial_kargs(env, state.X, state.U)

    def iterate(s, kargs):
        if kargs is not None:
            return _iteration_fused(env, s, kargs, config, alphas)
        new_state, aux = _iteration_batched(env, s, config, alphas)
        return new_state, None, aux

    trace = None
    if return_trace:
        # exactly max_iterations rows; finished scenarios freeze
        rows = []
        for _ in range(config.max_iterations):
            state, kargs, aux = iterate(state, kargs)
            rows.append(ILQRTrace(
                J=state.J, residual=state.residual, mu=state.mu,
                alpha=aux.alpha, accepted=aux.accepted,
                converged=state.converged,
            ))
        trace = ILQRTrace(*(torch.stack(col) for col in zip(*rows)))
    else:
        # the loop's one host sync per iteration
        while bool(_active(state, config).any()):
            state, kargs, _ = iterate(state, kargs)

    _, costs = env.rollout(x0, state.U)
    result = ILQRResult(
        states=state.X,
        actions=state.U,
        costs=costs,
        total_cost=state.J,
        iterations=state.iteration,
        converged=state.converged,
        residual=state.residual,
        mu=state.mu,
        delta=state.delta,
        failed=state.failed,
    )
    if return_trace:
        return result, trace
    return result


def solve_batch(env, x0, U0=None, *, horizon: Optional[int] = None,
                config: ILQRConfig = ILQRConfig(),
                init_state: Optional[SolverState] = None,
                return_trace: bool = False):
    """Batch-explicit iLQR solve over ``x0 [B, n]`` (optional ``U0 [B, T, m]``).

    ``init_state``: resume from a previous solve's ``SolverState``
    (``x0``/``U0`` are then ignored and may be None).
    ``return_trace=True``: also return an ``ILQRTrace`` of per-iteration
    ``[I, B]`` statistics over exactly ``I = config.max_iterations``
    iterations (finished scenarios freeze, so the final state equals the
    early-stopping loop's).
    """
    return _solve_batch_impl(env, x0, U0, horizon, config, init_state,
                             return_trace)


def _validate_state(state: SolverState, env) -> None:
    n, m = state.X.shape[-1], state.U.shape[-1]
    if n != env.state_size or m != env.action_size:
        raise ValueError(
            f"state was saved for state/action sizes ({n}, {m}) but env "
            f"'{type(env).__name__}' has ({env.state_size}, "
            f"{env.action_size})"
        )
    env_dtypes = {
        v.dtype for v in vars(env).values()
        if isinstance(v, torch.Tensor) and v.is_floating_point()
    }
    if env_dtypes and state.X.dtype not in env_dtypes:
        raise ValueError(
            f"state arrays are {state.X.dtype} but env "
            f"'{type(env).__name__}' parameters are {sorted(map(str, env_dtypes))}"
        )


def resume(env, state: SolverState, *, config: ILQRConfig = ILQRConfig(),
           return_trace: bool = False):
    """Continue a saved solve until convergence or ``max_iterations``."""
    _validate_state(state, env)
    return solve_batch(env, None, None, config=config, init_state=state,
                       return_trace=return_trace)
