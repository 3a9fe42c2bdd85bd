"""Differentiable-environment base: dynamics and costs plus their linearization.

Counterpart of ``tfmpc_tpu/models/base.py``. ``transition``, ``cost`` and
``final_cost`` take states ``[..., n]`` and controls ``[..., m]`` with any
leading batch dims. The generic linearization is ``torch.autograd`` on
the env's own batched call at all the points at once, each point repeated
so that its copies take the unit cotangents of one reverse pass
(``_derive``; the copies are independent points, as the points are):
Jacobians one reverse pass, Hessians reverse over reverse, two
(``create_graph``), also under ``torch.inference_mode``, and for an env
built under it (``autograd_env``: its inference tensors cloned, once a
solve). It is the semantics oracle for an env's closed-form
``analytic_derivatives``, and gives what the JAX package's ``vmap(jacfwd)``
gives at each point, the points being independent under the env contract.

It is not ``torch.func``'s ``vmap(jacfwd)``, nor any ``torch.func``
transform: on torch 2.13 they give wrong derivatives, without an error,
through the LU-based ops (``linalg.solve``, ``linalg.det``, ``slogdet``,
``lu_factor`` + ``lu_solve``). Under two ``vmap`` levels (``jacfwd`` is a
``vmap`` over the directions) their batching rules are wrong on the CPU
(Jacobians off by up to 5e2 and Hessians by 6e5 on well-conditioned 3x3
matrices; on an H100 the two-link arm's came out right); forward over
forward (``jvp`` of ``jvp``) drops the tangent of the LU factors that
their forward formulas reuse, wrong at one point unmapped; and the
backward of ``det`` under any ``torch.func`` transform takes its SVD
formula, NaN where the matrix has repeated singular values (``3 I`` plus
a rank-one term). ``inv``, ``cholesky``, ``cholesky_solve`` and
``solve_triangular`` came out right either way. Plain autograd has none
of these faults, and it keeps a float32 env's derivatives float32 where
``jacfwd`` made them float64 (a 0-d tensor times a Python float).

``device_step`` replaces the JAX package's ``lane_functions`` hook: a
shipped env names its hand-written step functor (``ops/csrc/envs.cuh``),
and every other env gets by default a functor generated from a trace of
its public ``transition``/``cost``/``final_cost``
(``generic_device_step``, ``ops/env_codegen.py``), as the JAX package's
``lane_functions`` defaults to ``generic_lane_functions``. An env whose
``device_step`` returns None keeps the plain PyTorch rollout.
``device_derivatives`` replaces ``lane_derivatives``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)


# The env_id of a generated step functor (``Env.generic_device_step``):
# compiled from its ``DeviceStep.source`` into a library of its own
# (``ops/_build.py`` ``user_library``), not selected in ``envs.cuh``.
USER_STEP_ID = 4


# the most (point, copy) pairs that one reverse pass of the linearization
# takes: more points go in chunks, which bounds the graph's memory. On an
# H100 the full-DDP navigation-12 solve (288 copies a point, 51,200 points)
# ran as fast in one chunk (2^24) as in four, within its run-to-run spread,
# and slower in fifteen (2^20; ``tools/phase_ab.py --max-copies``)
MAX_COPIES = 1 << 22


def _grads(out, inputs, create_graph=False):
    """The gradients of ``out.sum()`` with respect to ``inputs``: zero for
    an input it does not read, and all zero where ``out`` reads none (the
    points of ``out`` independent, these are each point's own)."""
    if not out.requires_grad:
        return tuple(torch.zeros_like(a) for a in inputs)
    return torch.autograd.grad(out.sum(), inputs, retain_graph=True,
                               create_graph=create_graph, allow_unused=True,
                               materialize_grads=True)


def _unit(k: int, reps: int, like, each: int = 1):
    """Row j of the identity for the copies ``[reps, k, each]`` (copy
    (j, e) of a point takes row j), flattened to ``[reps * k * each, k]``."""
    eye = torch.eye(k, dtype=like.dtype, device=like.device)
    return eye.repeat_interleave(each, dim=0).repeat(reps, 1)


def _derive(fn, args, k: int, second: bool = False):
    """``fn(*args)`` at each point (``[P, k]``, or ``[P]`` for a scalar
    ``fn`` with k = 1), its first derivatives ``[P, k, K]`` over the
    concatenated ``args [P, d]`` (K values) and, if ``second``, its second
    ``[P, k, K, K]``. Each point is repeated as leaves, the copies
    independent points as the points are: copy a (copy (a, b) for
    ``second``) takes output a's unit cotangent in one reverse pass, and
    differentiates component b of that gradient in a second (reverse over
    reverse). Autograd records under ``torch.inference_mode`` too, so a
    caller there gets the same derivatives and not zeros."""
    K = sum(a.shape[-1] for a in args)
    each = K if second else 1
    with torch.inference_mode(False), torch.enable_grad():
        copies = tuple(a.detach().repeat_interleave(k * each, dim=0)
                       .requires_grad_(True) for a in args)
        out = fn(*copies)
        o = out.reshape(len(out), -1)                # [P * k * each, k]
        reps = len(o) // (k * each)
        g = torch.cat(_grads(o * _unit(k, reps, o, each), copies,
                             create_graph=second), dim=-1)
        H = torch.cat(_grads(g * _unit(K, reps * k, g), copies),
                      dim=-1) if second else None
    value = out.detach()[::k * each]
    first = g.detach()[::each].reshape(-1, k, K)
    return (value, first) if H is None else (value, first,
                                             H.reshape(-1, k, K, K))


# the copy of each env that ``autograd_env`` returns while a solve runs
# (``autograd_env_once``), by the env's id
_SOLVE_COPIES: Dict[int, object] = {}


def autograd_env(env):
    """``env`` for an autograd pass: itself, or, where some of its
    floating-point tensor fields are inference tensors (the env was built
    under ``torch.inference_mode``; autograd cannot save them for
    backward), a shallow copy whose such fields are clones made outside
    inference mode. The env passed in is not changed. While
    ``autograd_env_once(env)`` holds, the copy it made is returned."""
    held = _SOLVE_COPIES.get(id(env))
    if held is not None:
        return held
    fields = {k: v for k, v in getattr(env, "__dict__", {}).items()
              if isinstance(v, torch.Tensor) and v.is_floating_point()
              and v.is_inference()}
    if not fields:
        return env
    out = copy.copy(env)
    with torch.inference_mode(False):
        for k, v in fields.items():
            object.__setattr__(out, k, v.clone())
    return out


@contextlib.contextmanager
def autograd_env_once(env):
    """Within: ``autograd_env(env)`` returns one copy, made on entry (a
    solve's, so that its autograd passes clone the fields once)."""
    if id(env) in _SOLVE_COPIES:
        yield
        return
    _SOLVE_COPIES[id(env)] = autograd_env(env)
    try:
        yield
    finally:
        del _SOLVE_COPIES[id(env)]


def _by_chunks(derive, copies: int, *args):
    """``derive(*args)`` over chunks of the points of at most
    ``MAX_COPIES`` (point, copy) pairs each, its outputs (tensors over the
    points) concatenated."""
    P = args[0].shape[0]
    step = max(1, MAX_COPIES // copies)
    if P <= step:
        return derive(*args)
    parts = [derive(*(a[i:i + step] for a in args)) for i in range(0, P, step)]
    return tuple(torch.cat(part, dim=0) for part in zip(*parts))


class DeviceStep(NamedTuple):
    """An env step compiled into the CUDA rollout kernels.

    ``env_id`` selects the step functor in ``ops/csrc/envs.cuh``, or is
    ``USER_STEP_ID`` for the functor generated in ``source``, whose
    ``work`` a step is ``(serial, row)`` (the statements a lane runs whole,
    ``prep`` and the stage cost, and those of one row; the launch plans
    read it); ``params`` are its parameter tensors and ``int_params`` its
    integer sizes, in the order that functor reads them.
    """

    env_id: int
    params: Tuple[torch.Tensor, ...]
    int_params: Tuple[int, ...]
    source: Optional[str] = None
    work: Optional[Tuple[int, int]] = None


class Env:
    """Base class for differentiable environments.

    Subclasses implement ``transition(x, u) -> x'``, ``cost(x, u)`` and
    ``final_cost(x)`` over ``[..., n]`` / ``[..., m]`` tensors, and may set
    ``bounds`` (a ``Bounds`` or None).
    """

    bounds: Optional[Bounds] = None

    # -- abstract ----------------------------------------------------------
    def transition(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def cost(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def final_cost(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def state_size(self) -> int:
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        return self.state_size

    # -- autodiff linearization ---------------------------------------------
    # each at points x [P, n], u [P, m], on ``autograd_env(self)``
    def _linear(self, x, u):
        """``(f, f_x, f_u)``."""
        n, step = x.shape[-1], autograd_env(self).transition
        f, J = _by_chunks(lambda *a: _derive(step, a, n), n, x, u)
        return f, J[..., :n], J[..., n:]

    def _quadratic(self, x, u):
        """``(l, l_x, l_u, l_xx, l_uu, l_ux)``."""
        n, cost = x.shape[-1], autograd_env(self).cost
        l, g, H = _by_chunks(lambda *a: _derive(cost, a, 1, True),
                             n + u.shape[-1], x, u)
        g, H = g[:, 0], H[:, 0]
        return (l, g[:, :n], g[:, n:], H[:, :n, :n], H[:, n:, n:],
                H[:, n:, :n])

    def _final(self, x):
        """``(l, l_x, l_xx)`` of the final cost."""
        final = autograd_env(self).final_cost
        l, g, H = _by_chunks(lambda *a: _derive(final, a, 1, True),
                             x.shape[-1], x)
        return l, g[:, 0], H[:, 0]

    def _second_order(self, x, u):
        """``(f_xx, f_ux, f_uu)``."""
        n, step = x.shape[-1], autograd_env(self).transition
        H = _by_chunks(lambda *a: _derive(step, a, n, True),
                       n * (n + u.shape[-1]), x, u)[2]    # [P, a, b, c]
        return H[..., :n, :n], H[..., n:, :n], H[..., n:, n:]

    def _points(self, fn, batch, *args):
        out = fn(*args) if batch else fn(*(a[None] for a in args))
        return out if batch else tuple(a[0] for a in out)

    def get_linear_transition(self, x, u, batch: bool = False) -> LinearModel:
        """First-order model of the dynamics at ``(x, u)``; ``batch=True``
        maps over a leading axis."""
        return LinearModel(*self._points(self._linear, batch, x, u))

    def get_quadratic_cost(self, x, u, batch: bool = False) -> QuadraticModel:
        """Second-order model of the stage cost at ``(x, u)``."""
        return QuadraticModel(*self._points(self._quadratic, batch, x, u))

    def get_second_order_transition(self, x, u,
                                    batch: bool = False) -> SecondOrderModel:
        """Second derivatives of the dynamics at ``(x, u)`` (full DDP);
        ``batch=True`` maps over a leading axis."""
        return SecondOrderModel(*(
            a.contiguous() for a in self._points(self._second_order, batch,
                                                 x, u)))

    def get_quadratic_final_cost(self, x, batch: bool = False
                                 ) -> QuadraticFinal:
        """Second-order model of the final cost at ``x``; ``batch=True``
        maps over a leading axis."""
        return QuadraticFinal(*self._points(self._final, batch, x))

    # -- rollout -----------------------------------------------------------
    def rollout(self, x0: torch.Tensor, U: torch.Tensor):
        """Open-loop rollout: ``x0 [..., n]``, ``U [..., T, m]`` ->
        ``(states [..., T+1, n], costs [..., T+1])``; the last cost is the
        final cost."""
        x, xs, costs = x0, [x0], []
        for t in range(U.shape[-2]):
            u = U[..., t, :]
            costs.append(self.cost(x, u))
            x = self.transition(x, u)
            xs.append(x)
        costs.append(self.final_cost(x))
        return torch.stack(xs, dim=-2), torch.stack(costs, dim=-1)

    def total_cost(self, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        return self.rollout(x0, U)[1].sum(dim=-1)

    def clip(self, u: torch.Tensor) -> torch.Tensor:
        if self.bounds is None:
            return u
        return self.bounds.clip(u)

    # -- optional hooks ------------------------------------------------------
    def analytic_derivatives(self, X: torch.Tensor, U: torch.Tensor):
        """Closed-form linearization along ``X [..., T+1, n]``,
        ``U [..., T, m]``, or None to use the autodiff route. Must match
        the autodiff linearization to floating-point tolerance."""
        return None

    def device_step(self) -> Optional[DeviceStep]:
        """The env's step compiled into the CUDA rollout kernels: by
        default ``generic_device_step()``. Return None to keep this env's
        rollouts on the plain PyTorch path on every device (the JAX
        package's ``lane_functions() -> None``)."""
        return self.generic_device_step()

    def generic_device_step(self, dtype=None, device=None) -> DeviceStep:
        """A step functor generated from this env's ``transition``,
        ``cost`` and ``final_cost`` (``ops/env_codegen.py``): traced on one
        scenario at ``dtype`` on ``device`` (by default those of the env's
        first floating tensor), once per env instance. Raises
        ``NotImplementedError`` for a step it cannot express. The rollout
        kernels trace it again at each call's own dtype."""
        from tfmpc_tpu_torch.ops import env_codegen

        if dtype is None or device is None:
            fields = vars(self).values() if hasattr(self, "__dict__") else ()
            t = next((v for v in fields if isinstance(v, torch.Tensor)
                      and v.is_floating_point()), None)
            dtype = dtype or (torch.get_default_dtype() if t is None
                              else t.dtype)
            device = device or ("cpu" if t is None else t.device)
        return env_codegen.device_step(self, dtype, device)

    def device_derivatives(self) -> Optional[DeviceStep]:
        """The env's step functor that also has a closed-form device
        linearization (``derivatives`` in ``ops/csrc/envs.cuh``, matching
        ``analytic_derivatives``), compiled into K8, the materialize
        rollout of the fused iteration (``ILQRConfig.fuse_derivatives``);
        or None (then that iteration is not eligible for this env). The
        counterpart of the JAX package's ``Env.lane_derivatives``."""
        return None
