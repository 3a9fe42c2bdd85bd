"""The port's exact LQR solver and problem generators vs the JAX package.

Problems are drawn with numpy from a seed (``make_lqr``'s recipe: normal
F, f, c and C = M M^T + 0.01 I) and handed to both packages, float64 on
CPU. Tolerance 1e-10 absolute and relative: both run the same recursion
in float64 and differ only in the rounding of the batched products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import lqr_backward_np, lqr_rollout_np
from tfmpc_tpu.core.types import LQRProblem as JLQRProblem
from tfmpc_tpu.models.problems import (
    make_lqr_linear_navigation as jax_make_lqr_linear_navigation,
)
from tfmpc_tpu.solvers import lqr as jlqr
from tfmpc_tpu_torch import interop
from tfmpc_tpu_torch.models.problems import make_lqr, make_lqr_linear_navigation
from tfmpc_tpu_torch.solvers import lqr

TOL = dict(rtol=1e-10, atol=1e-10)


def lqr_arrays(n, m, T, seed, stddev=0.4, final=True):
    """A random time-varying LQR problem as numpy arrays (F, f, C, c, C_f,
    c_f), ``C_t`` PD."""
    rng = np.random.default_rng(seed)
    F = stddev * rng.standard_normal((T, n, n + m))
    f = stddev * rng.standard_normal((T, n))
    M = stddev * rng.standard_normal((T, n + m, n + m))
    C = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(n + m)
    c = stddev * rng.standard_normal((T, n + m))
    if not final:
        return F, f, C, c, None, None
    L = stddev * rng.standard_normal((n, n))
    return F, f, C, c, L @ L.T + 0.1 * np.eye(n), rng.standard_normal(n)


def both(arrays):
    jp = JLQRProblem(*(None if a is None else jnp.asarray(a) for a in arrays))
    tp = interop.lqr_problem_from_numpy(*arrays, dtype=torch.float64,
                                        device="cpu")
    return jp, tp


def close(ours, theirs, **tol):
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               **(tol or TOL))


@pytest.mark.parametrize("T", [1, 7, 20])
@pytest.mark.parametrize("n,m", [(2, 2), (3, 1), (4, 2)])
def test_backward_forward_solve_match_jax(n, m, T):
    arrays = lqr_arrays(n, m, T, seed=n * 100 + m * 10 + T,
                        final=(n, m) != (3, 1))
    jp, tp = both(arrays)
    pol_j, val_j = jlqr.backward(jp)
    pol_t, val_t = lqr.backward(tp)
    assert pol_t.K.shape == (T, m, n) and val_t.V_xx.shape == (T + 1, n, n)
    for ours, theirs in ((pol_t.K, pol_j.K), (pol_t.k, pol_j.k),
                         (val_t.V_xx, val_j.V_xx), (val_t.v_x, val_j.v_x),
                         (val_t.v_0, val_j.v_0)):
        close(ours, theirs)
    x0 = np.random.default_rng(T).standard_normal(n)
    for ours, theirs in zip(lqr.forward(tp, torch.as_tensor(x0), pol_t),
                            jlqr.forward(jp, jnp.asarray(x0), pol_j)):
        close(ours, theirs)
    for ours, theirs in zip(lqr.solve(tp, torch.as_tensor(x0)),
                            jlqr.solve(jp, jnp.asarray(x0))):
        close(ours, theirs)


@pytest.mark.parametrize("n,m,T", [(3, 2, 20), (4, 1, 33)])
def test_matches_numpy_oracle(n, m, T):
    arrays = lqr_arrays(n, m, T, seed=T)
    _, tp = both(arrays)
    K_np, k_np = lqr_backward_np(*arrays)
    pol, _ = lqr.backward(tp)
    np.testing.assert_allclose(pol.K.numpy(), K_np, **TOL)
    np.testing.assert_allclose(pol.k.numpy(), k_np, **TOL)
    x0 = np.random.default_rng(1).standard_normal(n)
    X_np, U_np, J_np = lqr_rollout_np(*arrays, x0, K_np, k_np)
    X, U, costs = lqr.solve(tp, torch.as_tensor(x0))
    np.testing.assert_allclose(X.numpy(), X_np, **TOL)
    np.testing.assert_allclose(U.numpy(), U_np, **TOL)
    assert float(costs.sum()) == pytest.approx(J_np, rel=1e-10)


def test_batched_x0_rolls_one_policy_for_every_row():
    arrays = lqr_arrays(3, 2, 12, seed=5)
    jp, tp = both(arrays)
    x0 = np.random.default_rng(2).standard_normal((6, 3))
    X, U, costs = lqr.solve(tp, torch.as_tensor(x0))
    assert X.shape == (6, 13, 3) and U.shape == (6, 12, 2) \
        and costs.shape == (6, 13)
    for ours, theirs in zip((X, U, costs), jlqr.solve(jp, jnp.asarray(x0))):
        close(ours, theirs)
    for i in range(6):
        row = lqr.solve(tp, torch.as_tensor(x0[i]))
        close(row[1], U[i].numpy(), rtol=1e-12, atol=1e-12)


def test_non_pd_quu_gives_nan_gains_without_raising():
    F, f, C, c, C_f, c_f = lqr_arrays(2, 2, 5, seed=3)
    C = C.copy()
    C[2, 2:, 2:] = -np.eye(2)                    # Q_uu indefinite at t = 2
    jp, tp = both((F, f, C, c, C_f, c_f))
    pol_t, _ = lqr.backward(tp)
    pol_j, _ = jlqr.backward(jp)
    nan_t = torch.isnan(pol_t.K).any(dim=(-2, -1)).numpy()
    nan_j = np.isnan(np.asarray(pol_j.K)).any(axis=(-2, -1))
    np.testing.assert_array_equal(nan_t, nan_j)
    assert nan_t[:3].all() and not nan_t[3:].any()


def test_linear_navigation_matches_jax_field_by_field():
    jp = jax_make_lqr_linear_navigation(jnp.array([8.0, -5.0]), beta=0.5,
                                        horizon=100, dtype=jnp.float64)
    tp = make_lqr_linear_navigation([8.0, -5.0], beta=0.5, horizon=100,
                                    dtype=torch.float64, device="cpu")
    for name in ("F", "f", "C", "c", "C_f", "c_f"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert (tp.horizon, tp.state_size, tp.action_size) == (100, 2, 2)
    # the solve reaches the goal
    X, _, _ = lqr.solve(tp, torch.zeros(2, dtype=torch.float64))
    np.testing.assert_allclose(X[-1].numpy(), [8.0, -5.0], atol=0.5)


def test_make_lqr_shapes_psd_and_draws():
    n, m, T = 3, 2, 9
    p = make_lqr(torch.Generator().manual_seed(4), n, m, T, stddev=0.7,
                 dtype=torch.float64, device="cpu")
    assert p.F.shape == (T, n, n + m) and p.f.shape == (T, n)
    assert p.C.shape == (T, n + m, n + m) and p.c.shape == (T, n + m)
    assert p.C_f is None and p.c_f is None
    assert (p.horizon, p.state_size, p.action_size) == (T, n, m)
    assert torch.equal(p.C[0], p.C[0].T)
    assert float(torch.linalg.eigvalsh(p.C[0]).min()) >= 1e-2 - 1e-12
    assert torch.equal(p.F[0], p.F[-1])          # time-invariant
    again = make_lqr(torch.Generator().manual_seed(4), n, m, T, stddev=0.7,
                     dtype=torch.float64, device="cpu")
    other = make_lqr(torch.Generator().manual_seed(5), n, m, T, stddev=0.7,
                     dtype=torch.float64, device="cpu")
    for name in ("F", "f", "C", "c"):
        assert torch.equal(getattr(p, name), getattr(again, name))
        assert not torch.equal(getattr(p, name), getattr(other, name))
    pol, _ = lqr.backward(p)
    assert bool(torch.isfinite(pol.K).all())
