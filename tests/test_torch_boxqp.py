"""The port's boxQP (``tfmpc_tpu_torch.ops.boxqp``) vs the JAX package's.

Batches of problems drawn with numpy from a seed (random PD ``H``, finite,
one-sided and infinite bounds) go through ``tfmpc_tpu.ops.boxqp`` (vmapped)
and the port's batched ``boxqp``, in float64. Tolerance 1e-10: both run
the same fixed-iteration projected Newton on the same float64 data and
differ only in the rounding order of small matmuls and Cholesky
factorizations, far below the 1e-12 line-search margin's effect on these
well-separated problems. The objective is also held against the
independent float64 oracle ``tests/oracles.py::boxqp_np``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import boxqp_np
from tfmpc_tpu.ops.boxqp import boxqp as jax_boxqp
from tfmpc_tpu.ops.boxqp import solve_free_system as jax_solve_free_system
from tfmpc_tpu_torch.ops.boxqp import boxqp, solve_free_system

TOL = dict(rtol=1e-10, atol=1e-10)
P = 12  # problems per batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(m, bounds, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, m, m))
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(m)
    q = 3.0 * rng.normal(size=(P, m))
    width = rng.uniform(0.1, 2.0, size=(P, m))
    lo, hi = -width, width
    if bounds == "one_sided":
        lo[:, ::2] = -np.inf
        hi[:, 1::2] = np.inf
    elif bounds == "infinite":
        lo[:] = -np.inf
        hi[:] = np.inf
    return H, q, lo, hi


def _jax(H, q, lo, hi, **kw):
    return jax.vmap(lambda *a: jax_boxqp(*a, **kw))(
        *(jnp.asarray(a) for a in (H, q, lo, hi)))


def _torch(H, q, lo, hi, **kw):
    return boxqp(*(torch.as_tensor(a) for a in (H, q, lo, hi)), **kw)


@pytest.mark.parametrize("bounds", ["finite", "one_sided", "infinite"])
@pytest.mark.parametrize("m", [2, 3, 6])
def test_boxqp_matches_jax_and_oracle(m, bounds):
    H, q, lo, hi = _problems(m, bounds, seed=m)
    res_j = _jax(H, q, lo, hi)
    res_t = _torch(H, q, lo, hi)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x), **TOL)
    np.testing.assert_array_equal(res_t.free.numpy(), np.asarray(res_j.free))
    np.testing.assert_allclose(res_t.obj.numpy(), np.asarray(res_j.obj),
                               **TOL)
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))
    np.testing.assert_allclose(res_t.chol_free.numpy(),
                               np.asarray(res_j.chol_free), **TOL)
    if bounds == "infinite":
        assert bool(res_t.free.all())
    # the independent oracle: same minimum (8 Newton iterations suffice
    # for these problems)
    for i in range(P):
        x_o, free_o = boxqp_np(H[i], q[i], lo[i], hi[i])
        obj_o = 0.5 * x_o @ H[i] @ x_o + q[i] @ x_o
        np.testing.assert_allclose(float(res_t.obj[i]), obj_o, rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_array_equal(res_t.free[i].numpy(), free_o)

    rhs = np.random.default_rng(m + 1).normal(size=(P, m, 4))
    K_t = solve_free_system(res_t, torch.as_tensor(rhs))
    K_j = jax.vmap(jax_solve_free_system)(res_j, jnp.asarray(rhs))
    np.testing.assert_allclose(K_t.numpy(), np.asarray(K_j), **TOL)
    # clamped rows are exactly zero
    assert bool((K_t[~res_t.free] == 0.0).all())


def test_failed_masked_system_stops_with_nan_factor():
    """An H that is not PD on the free set: the Newton system's factor is
    NaN, so the step is NaN, nothing improves, and the problem stops at its
    start, exactly as in the JAX package; the final factor is NaN in both
    (the backward pass reads that as a failed lane)."""
    H = np.array([[[1.0, 2.0], [2.0, 1.0]],      # indefinite
                  [[2.0, 0.0], [0.0, -1.0]],     # indefinite
                  [[2.0, 0.5], [0.5, 1.0]]])     # PD
    q = np.array([[1.0, -1.0], [0.5, 0.5], [1.0, -2.0]])
    lo, hi = np.full((3, 2), -1.0), np.full((3, 2), 1.0)
    res_j = _jax(H, q, lo, hi, max_iters=4)
    res_t = _torch(H, q, lo, hi, max_iters=4)
    np.testing.assert_allclose(res_t.x.numpy(), np.asarray(res_j.x), **TOL)
    np.testing.assert_array_equal(res_t.free.numpy(), np.asarray(res_j.free))
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))
    nan_t = torch.isnan(res_t.chol_free).numpy()
    np.testing.assert_array_equal(nan_t, np.isnan(np.asarray(
        res_j.chol_free)))
    lower = np.tril(np.ones((2, 2), bool))
    assert nan_t[:2][:, lower].all() and not nan_t[2].any()
    np.testing.assert_array_equal(res_t.x[:2].numpy(), np.zeros((2, 2)))
