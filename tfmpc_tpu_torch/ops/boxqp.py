"""Batched projected-Newton box-constrained QP (boxQP).

Counterpart of ``tfmpc_tpu/ops/boxqp.py``. Solves, over any leading batch
dims,

    min_x  1/2 x^T H x + q^T x   s.t.  lo <= x <= hi   (H PD)

the constrained Q-minimization of control-limited DDP (Tassa, Mansard &
Todorov 2014): inside the iLQR backward pass it gives the feedforward step
``k_t`` within the control box, and its final free-set factorization gives
the feedback rows ``K_t`` (exactly zero on clamped dims).

A fixed number of Newton iterations with masked arithmetic, as in the JAX
package: the clamped set comes from the gradient signs at the bounds, the
free-subset Newton system is the masked matrix ``free (x) free * H +
diag(clamped)`` (one batched Cholesky, same shape every iteration), the
projected backtracking line search tries ``alpha = 1, 1/2, ...`` and keeps
the first candidate that improves the objective by more than 1e-12, and a
problem that converged or found no improvement freezes (``done``).

A non-PD masked system gives a NaN factor (``jnp.linalg.cholesky``
semantics, rebuilt here from ``cholesky_ex``'s ``info``), hence a NaN step,
NaN candidates, no improvement, and the problem stops. This is the plain
version behind kernel K4 (``ops/riccati.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# The line search's grid alpha = 2^-i, i < LS_ALPHAS, and the free-gradient
# norm below which a problem has converged (the JAX package's defaults, and
# the constants of kernel K4, csrc/riccati_boxqp.cu).
LS_ALPHAS = 8
GRAD_TOL = 1e-8


class BoxQPResult(NamedTuple):
    x: torch.Tensor           # [..., m] the (approximate) minimizer
    free: torch.Tensor        # [..., m] bool, free (not clamped) dimensions
    chol_free: torch.Tensor   # [..., m, m] Cholesky of the masked free system
    obj: torch.Tensor         # [...] final objective value
    iterations: torch.Tensor  # [...] int32, Newton iterations actually used


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _objective(H, q, x):
    return 0.5 * (x * _mv(H, x)).sum(dim=-1) + (q * x).sum(dim=-1)


def _masked_system(H, free):
    """``H`` on free x free, identity on the clamped diagonal."""
    mask2 = free[..., :, None] & free[..., None, :]
    clamped_diag = torch.diag_embed((~free).to(H.dtype))
    return torch.where(mask2, H, torch.zeros_like(H)) + clamped_diag


def cholesky_nan(M):
    """Lower Cholesky factor with its lower triangle NaN where ``M`` is not
    PD, as ``jnp.linalg.cholesky`` returns it."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, torch.nan), L).tril()


def _free_mask(x, g, lo, hi):
    clamped = ((x <= lo) & (g > 0)) | ((x >= hi) & (g < 0))
    return ~clamped


def boxqp(H, q, lo, hi, *, max_iters: int = 8) -> BoxQPResult:
    """Projected-Newton boxQP on ``H [..., m, m]``, ``q [..., m]`` within
    ``lo``/``hi`` (broadcasting against ``q``; infinite bounds never
    clamp), from ``x = clip(0, lo, hi)``, ``max_iters`` Newton
    iterations."""
    lo = torch.broadcast_to(lo, q.shape)
    hi = torch.broadcast_to(hi, q.shape)
    x = torch.clamp(torch.zeros_like(q), lo, hi)
    alphas = 2.0 ** -torch.arange(LS_ALPHAS, dtype=q.dtype, device=q.device)
    batch = q.shape[:-1]
    done = torch.zeros(batch, dtype=torch.bool, device=q.device)
    iters = torch.zeros(batch, dtype=torch.int32, device=q.device)

    for _ in range(max_iters):
        g = q + _mv(H, x)
        free = _free_mask(x, g, lo, hi)
        g_free = torch.where(free, g, torch.zeros_like(g))
        converged = (torch.linalg.vector_norm(g_free, dim=-1) < GRAD_TOL) \
            | ~free.any(dim=-1)

        chol = cholesky_nan(_masked_system(H, free))
        d = -torch.cholesky_solve(g_free[..., None], chol)[..., 0]

        # projected backtracking over the fixed grid: candidates [..., A, m]
        cand = torch.clamp(x[..., None, :] + alphas[:, None] * d[..., None, :],
                           lo[..., None, :], hi[..., None, :])
        obj_cand = _objective(H[..., None, :, :], q[..., None, :], cand)
        obj_now = _objective(H, q, x)
        improves = obj_cand < (obj_now - 1e-12)[..., None]
        any_improve = improves.any(dim=-1)
        best = torch.argmax(improves.to(torch.uint8), dim=-1)  # first True
        x_best = torch.take_along_dim(cand, best[..., None, None], dim=-2)
        x_new = torch.where(any_improve[..., None], x_best[..., 0, :], x)

        frozen = done | converged
        x = torch.where(frozen[..., None], x, x_new)
        iters = iters + (~done).to(torch.int32)
        done = frozen | ~any_improve

    # final clamped set and factorization at the solution (for the K rows)
    g = q + _mv(H, x)
    free = _free_mask(x, g, lo, hi)
    chol_free = cholesky_nan(_masked_system(H, free))
    return BoxQPResult(x=x, free=free, chol_free=chol_free,
                       obj=_objective(H, q, x), iterations=iters)


def solve_free_system(result: BoxQPResult, rhs):
    """Solve ``H_ff X_f = rhs_f`` with zeros on clamped rows (``rhs [..., m,
    k]``): ``K = -solve_free_system(res, Q_ux)`` gives the control-limited
    feedback gains."""
    rhs_masked = torch.where(result.free[..., :, None], rhs,
                             torch.zeros_like(rhs))
    return torch.cholesky_solve(rhs_masked, result.chol_free)
