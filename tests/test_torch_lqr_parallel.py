"""The port's O(log T) parallel Riccati backward vs the JAX package.

``backward_parallel`` is held against the port's sequential
``lqr.backward`` and against the JAX ``backward_parallel``, and the
parallel iLQR backward variants against the JAX ones on navigation and
reservoir-4 linearizations, all float64 on CPU from numpy seeds.
Tolerance 1e-8: the port composes the suffixes by doubling, JAX's reverse
``associative_scan`` in another tree, so the two agree to rounding (the
JAX package pins its own parallel pass to the sequential one at 1e-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lqr import both, close, lqr_arrays
from tfmpc_tpu.core.types import Bounds as JBounds
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.models.reservoir import make_reservoir as jax_make_reservoir
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import lqr_parallel as jpar
from tfmpc_tpu_torch.core.types import Bounds
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.models.reservoir import make_reservoir
from tfmpc_tpu_torch.solvers import ilqr, lqr, lqr_parallel

TOL = dict(rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("T", [1, 2, 7, 64])
def test_backward_parallel_matches_sequential_and_jax(T):
    """T+1 elements: 2, 3, 8 and 65 (T+1 a power of two only for T=7)."""
    arrays = lqr_arrays(3, 2, T, seed=T)
    jp, tp = both(arrays)
    pol_s, val_s = lqr.backward(tp)
    pol_p, val_p = lqr_parallel.backward_parallel(tp)
    pol_j, val_j = jpar.backward_parallel(jp)
    for ours, seq, theirs in ((pol_p.K, pol_s.K, pol_j.K),
                              (pol_p.k, pol_s.k, pol_j.k),
                              (val_p.V_xx, val_s.V_xx, val_j.V_xx),
                              (val_p.v_x, val_s.v_x, val_j.v_x)):
        close(ours, seq.numpy(), **TOL)
        close(ours, theirs, **TOL)
    assert not bool(val_p.v_0.any())


def test_batched_problems_match_one_by_one():
    """Leading batch dims on the problem: each row equals its own solve."""
    rows = [lqr_arrays(2, 2, 9, seed=s) for s in range(3)]
    stacked = [np.stack(a) for a in zip(*rows)]
    _, tp = both(stacked)
    pol, val = lqr_parallel.backward_parallel(tp)
    assert pol.K.shape == (3, 9, 2, 2) and val.V_xx.shape == (3, 10, 2, 2)
    for i, arrays in enumerate(rows):
        pol_i, _ = lqr_parallel.backward_parallel(both(arrays)[1])
        close(pol.K[i], pol_i.K.numpy(), rtol=1e-12, atol=1e-12)


def _linearizations(name, B, T, seed):
    """A nominal trajectory's linearization in both packages: navigation
    (with l_uu made PD, as the JAX tests do) or reservoir-4 (l_uu = 0)."""
    rng = np.random.default_rng(seed)
    if name == "navigation":
        zone = {"center": [[3.0, -2.0]], "decay": [2.0]}
        jenv = jax_make_navigation([8.0, -5.0], zone, dtype=jnp.float64)
        tenv = make_navigation([8.0, -5.0], zone, dtype=torch.float64,
                               device="cpu")
        x0 = rng.uniform(-4.0, 4.0, (B, 2))
        U = 0.1 * rng.standard_normal((B, T, 2))
    else:
        jenv = jax_make_reservoir(4, dtype=jnp.float64)
        tenv = make_reservoir(4, dtype=torch.float64, device="cpu")
        x0 = rng.uniform(20.0, 95.0, (B, 4))
        U = rng.uniform(0.0, 4.0, (B, T, 4))
    X = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))[0]
    lin, quad, fin = ilqr.derivatives(tenv, X, torch.as_tensor(U))
    if name == "navigation":
        quad = dataclasses.replace(
            quad, l_uu=quad.l_uu + torch.eye(2, dtype=torch.float64))
    to_j = lambda rec, cls: cls(**{  # noqa: E731
        f: jnp.asarray(getattr(rec, f).numpy())
        for f in rec.__dataclass_fields__})
    from tfmpc_tpu.core import types as jt

    j = (to_j(lin, jt.LinearModel), to_j(quad, jt.QuadraticModel),
         to_j(fin, jt.QuadraticFinal))
    return jenv, tenv, j, (lin, quad, fin), U


CASES = [("navigation", 0.0, 1e-5), ("reservoir", 0.3, 1e-5),
         ("reservoir", 0.0, 1e-5)]


@pytest.mark.parametrize("boxqp", [False, True])
@pytest.mark.parametrize("name,mu0,floor", CASES)
def test_ilqr_backward_parallel_matches_jax(name, mu0, floor, boxqp):
    B, T = 3, 24
    jenv, tenv, jlin, tlin, U = _linearizations(name, B, T, seed=7)
    mu = np.full(B, mu0)
    mu[1] = 2.0 * mu0 + 0.01
    if boxqp:
        bounds = tenv.bounds or Bounds(
            low=torch.full((2,), -0.5, dtype=torch.float64),
            high=torch.full((2,), 0.5, dtype=torch.float64))
        jb = JBounds(low=jnp.asarray(bounds.low.numpy()),
                     high=jnp.asarray(bounds.high.numpy()))
        ours = lqr_parallel.ilqr_backward_parallel_boxqp(
            *tlin, torch.as_tensor(mu), bounds, torch.as_tensor(U),
            mu_floor=floor)
        theirs = jax.vmap(
            lambda l, q, f, m_, u: jpar.ilqr_backward_parallel_boxqp(
                l, q, f, m_, jb, u, mu_floor=floor))(
            *jlin, jnp.asarray(mu), jnp.asarray(U))
    else:
        ours = lqr_parallel.ilqr_backward_parallel(
            *tlin, torch.as_tensor(mu), mu_floor=floor)
        theirs = jax.vmap(
            lambda l, q, f, m_: jpar.ilqr_backward_parallel(
                l, q, f, m_, mu_floor=floor))(*jlin, jnp.asarray(mu))
    ok_t, pol_t, dv1_t, dv2_t = ours
    ok_j, pol_j, dv1_j, dv2_j = theirs
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert bool(ok_t.all())
    close(pol_t.K, pol_j.K, **TOL)
    close(pol_t.k, pol_j.k, **TOL)
    close(dv1_t, dv1_j, **TOL)
    close(dv2_t, dv2_j, **TOL)
    # the single-scenario call equals its row of the batched one
    one = lqr_parallel.ilqr_backward_parallel(
        *(dataclasses.replace(r, **{f: getattr(r, f)[0]
                                    for f in r.__dataclass_fields__})
          for r in tlin), torch.tensor(mu[0]), mu_floor=floor) \
        if not boxqp else None
    if one is not None:
        close(one[1].K, pol_t.K[0].numpy(), rtol=1e-12, atol=1e-12)


def test_boxqp_with_a_wide_box_equals_the_plain_pass():
    """With bounds too wide to clamp, the boxQP gains re-pass reduces to
    the plain parallel gains."""
    B, T = 2, 24
    _, _, _, tlin, U = _linearizations("navigation", B, T, seed=8)
    wide = Bounds(low=torch.full((2,), -1e6, dtype=torch.float64),
                  high=torch.full((2,), 1e6, dtype=torch.float64))
    mu = torch.zeros(B, dtype=torch.float64)
    ok_u, pol_u, dv1_u, dv2_u = lqr_parallel.ilqr_backward_parallel(
        *tlin, mu, mu_floor=0.0)
    ok_b, pol_b, dv1_b, dv2_b = lqr_parallel.ilqr_backward_parallel_boxqp(
        *tlin, mu, wide, torch.as_tensor(U), mu_floor=0.0, boxqp_iters=12)
    assert bool(ok_u.all()) and bool(ok_b.all())
    close(pol_b.k, pol_u.k.numpy(), rtol=0, atol=1e-7)
    close(pol_b.K, pol_u.K.numpy(), rtol=0, atol=1e-7)
    close(dv1_b, dv1_u.numpy(), rtol=1e-6, atol=0)
    close(dv2_b, dv2_u.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("boxqp", [False, True])
def test_singular_luu_without_floor_fails_the_lane_in_both(boxqp):
    """Reservoir's cost is independent of u, so with mu = 0 and no floor
    ``C_uu`` is singular: ``ok`` is False in both packages and the port
    does not raise. A lane with mu > 0 next to it is unaffected."""
    B, T = 2, 6
    jenv, tenv, jlin, tlin, U = _linearizations("reservoir", B, T, seed=9)
    mu = np.array([0.0, 0.5])
    if boxqp:
        ok_t = lqr_parallel.ilqr_backward_parallel_boxqp(
            *tlin, torch.as_tensor(mu), tenv.bounds, torch.as_tensor(U),
            mu_floor=0.0)[0]
        ok_j = jax.vmap(lambda l, q, f, m_, u: jpar.ilqr_backward_parallel_boxqp(
            l, q, f, m_, jenv.bounds, u, mu_floor=0.0)[0])(
            *jlin, jnp.asarray(mu), jnp.asarray(U))
    else:
        ok_t = lqr_parallel.ilqr_backward_parallel(
            *tlin, torch.as_tensor(mu), mu_floor=0.0)[0]
        ok_j = jax.vmap(lambda l, q, f, m_: jpar.ilqr_backward_parallel(
            l, q, f, m_, mu_floor=0.0)[0])(*jlin, jnp.asarray(mu))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.tolist() == [False, True]


def test_config_route_and_restarts():
    """``ilqr.backward`` with ``parallel_backward`` is the parallel pass
    (boxQP on a bounded env), and the restart loop escalates mu on a lane
    the pass fails."""
    B, T = 2, 6
    _, tenv, _, tlin, U = _linearizations("reservoir", B, T, seed=10)
    cfg = ilqr.ILQRConfig(parallel_backward=True, parallel_mu_floor=0.0,
                          boxqp=True)
    mu = torch.zeros(B, dtype=torch.float64)
    direct = lqr_parallel.ilqr_backward_parallel_boxqp(
        *tlin, mu, tenv.bounds, torch.as_tensor(U), mu_floor=0.0)
    routed = ilqr.backward(*tlin, mu, cfg, tenv.bounds, torch.as_tensor(U))
    assert torch.equal(direct[0], routed[0])
    row = lambda r: dataclasses.replace(  # noqa: E731
        r, **{f: getattr(r, f)[0] for f in r.__dataclass_fields__})
    ok, _, _, _, mu1, _ = ilqr.backward_with_restarts(
        *(row(r) for r in tlin), mu[0], torch.tensor(1.0, dtype=torch.float64),
        cfg, tenv.bounds, torch.as_tensor(U[0]))
    assert bool(ok) and float(mu1) > 0.0
