"""Slice D, full second-order DDP: the port vs the JAX package, float64 on CPU.

Inputs are drawn with numpy from a seed and handed to both packages:

- ``Env.get_second_order_transition`` (nested ``jacfwd``) against the JAX
  env's on navigation (f_xx and f_ux), HVAC-3 (bilinear: f_ux only) and
  reservoir-3 (evaporation: f_xx only), single and batched, within 1e-12
  (both are forward-mode autodiff of the same float64 expressions);
- the plain versions of K6a and K6b (``riccati_backward_ddp_ref``,
  ``riccati_backward_ddp_boxqp_ref``) against the JAX package's vmapped
  scan ``ilqr.backward(..., second=...)``, the reference its own DDP
  kernel tests pin (``tests/test_riccati_pallas.py::TestDDPKernelParity``),
  on the envs' Hessians and on synthetic random ones (no shipped env has a
  nonzero f_uu, so only these reach ``t_uu`` and the ``mu I_m`` after it).
  DDP fails the PD probe on a share of random lanes; failed lanes hold
  meaningless values on both sides, so the ok masks must be identical and
  K, k, dV1 and dV2 agree within 1e-9 on the ok lanes, of which there must
  be at least half (the same float64 algorithm on both sides, summed in
  another order);
- whole ``solve_batch(ddp=True)`` runs against the JAX package's: actions
  within 1e-6, identical converged/failed masks and iteration counts (the
  tolerances of ``tests/test_torch_ilqr.py``), and the compacted restart
  loop with the Hessians gathered against the full-batch one (1e-12: the
  same arithmetic on gathered rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.core.types import (
    LinearModel as JLinearModel,
    QuadraticFinal as JQuadraticFinal,
    QuadraticModel as JQuadraticModel,
    SecondOrderModel as JSecondOrderModel,
)
from tfmpc_tpu.models.hvac import make_hvac as jax_make_hvac
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.models.reservoir import make_reservoir as jax_make_reservoir
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import ilqr_batched as jbatched
from tfmpc_tpu_torch import interop
from tfmpc_tpu_torch.core.types import (
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)
from tfmpc_tpu_torch.models.hvac import make_hvac
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.models.reservoir import make_reservoir
from tfmpc_tpu_torch.ops import riccati
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

GOAL = [8.0, -5.0]
ZONE = {"center": [[3.0, -2.0]], "decay": [2.0]}
HVAC3 = dict(adj=[[0, 1, 0], [1, 0, 1], [0, 1, 0]], is_out=[1, 0, 1],
             is_hall=[0, 1, 0])
TOL = dict(rtol=1e-9, atol=1e-9)
B, T = 128, 10
# Scale of the synthetic Hessians, against each env's value gradients: at
# these, 84% (navigation) and 67% (HVAC-3, boxQP) of the lanes pass the PD
# probe, so both the ok masks and the ok lanes' values are compared.
SYNTHETIC_SCALE = {"navigation": 1e-2, "hvac": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(name):
    """(JAX env, port env, x0 range) in float64."""
    if name == "navigation":
        return (jax_make_navigation(GOAL, ZONE, dtype=jnp.float64),
                make_navigation(GOAL, ZONE, dtype=torch.float64,
                                device="cpu"), (-5.0, 5.0))
    if name == "linear_navigation":
        return (jax_make_navigation(GOAL, dtype=jnp.float64),
                make_navigation(GOAL, dtype=torch.float64, device="cpu"),
                (-5.0, 5.0))
    if name == "hvac":
        kw = dict(HVAC3)
        adj = kw.pop("adj")
        return (jax_make_hvac(adj, **kw, dtype=jnp.float64),
                make_hvac(adj, **kw, dtype=torch.float64, device="cpu"),
                (8.0, 18.0))
    return (jax_make_reservoir(3, dtype=jnp.float64),
            make_reservoir(3, dtype=torch.float64, device="cpu"),
            (20.0, 95.0))


def _fields(m, fn):
    return {f: fn(getattr(m, f)) for f in m.__dataclass_fields__}


# -- (a) the second-order model -------------------------------------------------

@pytest.mark.parametrize("name", ["navigation", "hvac", "reservoir"])
def test_second_order_transition_matches_jax(name):
    jenv, tenv, lohi = _envs(name)
    n, m = tenv.state_size, tenv.action_size
    rng = np.random.default_rng(5)
    X = rng.uniform(*lohi, (7, n))
    U = np.asarray(tenv.clip(torch.as_tensor(rng.uniform(0.5, 1.5, (7, m)))))
    ours = tenv.get_second_order_transition(torch.as_tensor(X),
                                            torch.as_tensor(U), batch=True)
    theirs = jenv.get_second_order_transition(jnp.asarray(X), jnp.asarray(U),
                                              batch=True)
    assert ours.f_xx.shape == (7, n, n, n)
    assert ours.f_ux.shape == (7, n, m, n)
    assert ours.f_uu.shape == (7, n, m, m)
    for f in ("f_xx", "f_ux", "f_uu"):
        np.testing.assert_allclose(getattr(ours, f).numpy(),
                                   np.asarray(getattr(theirs, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    one = tenv.get_second_order_transition(torch.as_tensor(X[3]),
                                           torch.as_tensor(U[3]))
    for f in ("f_xx", "f_ux", "f_uu"):
        np.testing.assert_allclose(getattr(one, f).numpy(),
                                   getattr(ours, f)[3].numpy(), rtol=1e-12,
                                   atol=1e-12)
    # each family exercises its own part of the contraction; none has f_uu
    nonzero = {f: bool(getattr(ours, f).abs().max() > 0)
               for f in ("f_xx", "f_ux", "f_uu")}
    assert nonzero == {"navigation": dict(f_xx=True, f_ux=True, f_uu=False),
                       "hvac": dict(f_xx=False, f_ux=True, f_uu=False),
                       "reservoir": dict(f_xx=True, f_ux=False, f_uu=False),
                       }[name]


def test_second_order_transition_is_zero_on_linear_navigation():
    _, tenv, _ = _envs("linear_navigation")
    X = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (5, 4, 3, 2)))
    U = torch.as_tensor(np.random.default_rng(1).normal(size=(5, 4, 2, 2)))
    second = ilqr.second_derivatives(tenv, X, U)
    assert second.f_xx.shape == (5, 4, 2, 2, 2, 2)
    for f in ("f_xx", "f_ux", "f_uu"):
        assert float(getattr(second, f).abs().max()) == 0.0


# -- (b), (c) the plain versions of K6a and K6b ---------------------------------

def _setup(name, hessians, seed=0):
    """Numpy dicts of the four models along a random nominal of the env, and
    per-lane mu ~ U(0, 0.5). ``hessians="synthetic"`` replaces the env's
    Hessians by seeded random ones (``SYNTHETIC_SCALE`` N(0, 1), symmetric
    in their two derivative indices), so f_uu != 0."""
    jenv, tenv, lohi = _envs(name)
    n, m = tenv.state_size, tenv.action_size
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(*lohi, (B, n)))
    scale = (0.3, 0.0) if tenv.bounds is None else (2.0, 2.0)
    U = tenv.clip(torch.as_tensor(scale[1] + scale[0] * rng.normal(
        size=(B, T, m))))
    X, _ = tenv.rollout(x0, U)
    lin, quad, fin = ilqr.derivatives(tenv, X, U)
    second = ilqr.second_derivatives(tenv, X, U)
    to_np = lambda mod: _fields(mod, lambda a: a.numpy().copy())  # noqa: E731
    models = [to_np(mod) for mod in (lin, quad, fin, second)]
    if hessians == "synthetic":
        sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))  # noqa: E731
        c = SYNTHETIC_SCALE[name]
        models[3] = dict(
            f_xx=sym(c * rng.normal(size=(B, T, n, n, n))),
            f_ux=c * rng.normal(size=(B, T, n, m, n)),
            f_uu=sym(c * rng.normal(size=(B, T, n, m, m))))
    mu = rng.uniform(0.0, 0.5, B)
    return jenv, tenv, models, mu, U.numpy()


def _torch_models(lin, quad, fin, sec):
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    return (LinearModel(**t(lin)), QuadraticModel(**t(quad)),
            QuadraticFinal(**t(fin)), SecondOrderModel(**t(sec)))


def _jax_models(lin, quad, fin, sec):
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return (JLinearModel(**j(lin)), JQuadraticModel(**j(quad)),
            JQuadraticFinal(**j(fin)), JSecondOrderModel(**j(sec)))


def _assert_same_backward(ours, theirs):
    ok_t, pol_t, dv1_t, dv2_t = ours
    ok_j, pol_j, dv1_j, dv2_j = theirs
    ok = ok_t.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    assert ok.mean() >= 0.5, ok.mean()  # the comparison is not vacuous
    for got, want in ((pol_t.K, pol_j.K), (pol_t.k, pol_j.k),
                      (dv1_t, dv1_j), (dv2_t, dv2_j)):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                                   **TOL)
    return ok


@pytest.mark.parametrize("hessians", ["env", "synthetic"])
def test_ddp_ref_matches_jax_scan_backward(hessians):
    jenv, tenv, models, mu, _ = _setup("navigation", hessians)
    lin, quad, fin, sec = _torch_models(*models)
    ours = riccati.riccati_backward_ddp_ref(lin, quad, fin,
                                            torch.as_tensor(mu), sec)
    jlin, jquad, jfin, jsec = _jax_models(*models)
    cfg = jilqr.ILQRConfig()
    theirs = jax.jit(jax.vmap(
        lambda l, q, f, m, s: jilqr.backward(l, q, f, m, cfg, second=s)))(
        jlin, jquad, jfin, jnp.asarray(mu), jsec)
    ok = _assert_same_backward(ours, theirs)
    if hessians == "synthetic":
        assert not ok.all()  # some lanes fail the probe, and match


@pytest.mark.parametrize("name,hessians", [
    ("hvac", "env"), ("reservoir", "env"), ("hvac", "synthetic"),
])
def test_ddp_boxqp_ref_matches_jax_scan_backward(name, hessians):
    jenv, tenv, models, mu, U = _setup(name, hessians, seed=7)
    lin, quad, fin, sec = _torch_models(*models)
    ours = riccati.riccati_backward_ddp_boxqp_ref(
        lin, quad, fin, torch.as_tensor(mu), tenv.bounds, torch.as_tensor(U),
        sec)
    jlin, jquad, jfin, jsec = _jax_models(*models)
    cfg = jilqr.ILQRConfig(boxqp=True)
    theirs = jax.jit(jax.vmap(
        lambda l, q, f, m, u, s: jilqr.backward(
            l, q, f, m, cfg, bounds=jenv.bounds, Ubar=u, second=s)))(
        jlin, jquad, jfin, jnp.asarray(mu), jnp.asarray(U), jsec)
    ok = _assert_same_backward(ours, theirs)
    # the box is active: some k sit on a face of the shifted box
    k = ours[1].k.numpy()[ok]
    lo = tenv.bounds.low.numpy() - U[ok]
    hi = tenv.bounds.high.numpy() - U[ok]
    assert (np.isclose(k, lo, rtol=0, atol=1e-12)
            | np.isclose(k, hi, rtol=0, atol=1e-12)).any()


def test_second_kernel_layout_matches_jax():
    from tfmpc_tpu.ops.riccati_pallas import (
        _second_to_kernel_layout as jax_second_layout,
    )

    _, _, models, _, _ = _setup("hvac", "synthetic", seed=3)
    ours = riccati._second_to_kernel_layout(_torch_models(*models)[3])
    n, m = 3, 3
    theirs = jax_second_layout(_jax_models(*models)[3], (B, T, n, m))
    for key, want in zip(("fxx", "fux", "fuu"), theirs):
        assert ours[key].is_contiguous()
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(want),
                                      err_msg=key)
    assert ours["fxx"].shape == (T, n * n * n, B)
    # entry (p*n + i)*n + j of fxx is d2 f_p / dx_i dx_j
    p, i, j, t, b = 2, 0, 1, 4, 77
    assert float(ours["fxx"][t, (p * n + i) * n + j, b]) == \
        models[3]["f_xx"][b, t, p, i, j]


# -- (d) the terms vanish on linear dynamics, and enter otherwise ---------------

def test_ddp_equals_ilqr_on_linear_dynamics_and_differs_otherwise():
    _, tenv, models, mu, _ = _setup("linear_navigation", "env", seed=2)
    lin, quad, fin, sec = _torch_models(*models)
    zero = torch.zeros(B, dtype=torch.float64)
    # mu = 0: the zero tensor terms and the mu I_m leave every block as it is
    ddp = riccati.riccati_backward_ddp_ref(lin, quad, fin, zero, sec)
    plain = riccati.riccati_backward_ref(lin, quad, fin, zero)
    assert torch.equal(ddp[0], plain[0]) and bool(ddp[0].all())
    for a, b in zip((ddp[1].K, ddp[1].k, ddp[2], ddp[3]),
                    (plain[1].K, plain[1].k, plain[2], plain[3])):
        assert torch.equal(a, b)
    # and the whole solve
    x0 = torch.as_tensor(np.random.default_rng(4).uniform(-5, 5, (4, 2)))
    cfg = dict(atol=1e-8, max_iterations=30, use_pallas=True)
    r_ddp = ilqr.solve_batch(tenv, x0, horizon=T,
                             config=ilqr.ILQRConfig(**cfg, ddp=True))
    r_ilqr = ilqr.solve_batch(tenv, x0, horizon=T,
                              config=ilqr.ILQRConfig(**cfg))
    assert torch.equal(r_ddp.actions, r_ilqr.actions)
    assert torch.equal(r_ddp.iterations, r_ilqr.iterations)

    # the nonlinear env: the DDP gains differ from iLQR's
    _, _, models, mu, _ = _setup("navigation", "env", seed=3)
    lin, quad, fin, sec = _torch_models(*models)
    mu = torch.full((B,), 0.1, dtype=torch.float64)
    ok_d, pol_d, _, _ = riccati.riccati_backward_ddp_ref(lin, quad, fin, mu,
                                                         sec)
    ok_i, pol_i, _, _ = riccati.riccati_backward_ref(lin, quad, fin, mu)
    ok = ok_d & ok_i
    assert float(ok.double().mean()) > 0.5
    assert float((pol_d.K[ok] - pol_i.K[ok]).abs().max()) > 1e-5


# -- (e), (h) whole solves, and the kernel wrappers on CPU tensors ------------

def _assert_same_solve(res_t, res_j, atol=1e-6):
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=atol)
    for f in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)


def _counts():
    return (riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS,
            riccati.DDP_PLAIN_CALLS, riccati.DDP_BOXQP_PLAIN_CALLS)


@pytest.mark.parametrize("name", ["navigation", "hvac2"])
def test_ddp_solve_batch_matches_jax(name):
    """The slice as a whole: navigation (B=8, T=25) and HVAC-2 with boxQP
    (B=3, T=20, x0 five degrees below the comfort band), with
    ``use_pallas=True``: on CPU tensors the DDP wrappers run their plain
    versions (K6a's for navigation, K6b's for boxQP), and nothing else."""
    if name == "navigation":
        jenv, tenv, _ = _envs("navigation")
        x0 = np.random.default_rng(2).uniform(-6.0, 6.0, (8, 2))
        cfg, horizon = dict(atol=1e-8, max_iterations=60, ddp=True), 25
        wrapper = 2
    else:
        jenv = jax_make_hvac([[0, 1], [1, 0]], dtype=jnp.float64)
        tenv = make_hvac([[0, 1], [1, 0]], dtype=torch.float64, device="cpu")
        x0 = np.broadcast_to(np.asarray(jenv.temp_low) - 5.0, (3, 2)).copy()
        cfg = dict(atol=1e-6, max_iterations=60, ddp=True, boxqp=True)
        horizon, wrapper = 20, 3
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=horizon,
                              config=jilqr.ILQRConfig(**cfg))
    before = _counts()
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=horizon,
                             config=ilqr.ILQRConfig(**cfg, use_pallas=True))
    calls = [a - b for a, b in zip(_counts(), before)]
    assert calls[wrapper] > 0
    assert sum(calls) == calls[wrapper], calls
    _assert_same_solve(res_t, res_j)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
    assert bool(res_t.converged.all())
    if tenv.bounds is not None:
        assert float(res_t.actions.min()) >= float(tenv.bounds.low.min())
        assert float(res_t.actions.max()) <= float(tenv.bounds.high.max())
    # the plain path (use_pallas=False) and the single-scenario solver
    res_p = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=horizon,
                             config=ilqr.ILQRConfig(**cfg))
    _assert_same_solve(res_p, res_j)
    res_1 = ilqr.solve(tenv, torch.as_tensor(x0[1]), horizon=horizon,
                       config=ilqr.ILQRConfig(**cfg))
    np.testing.assert_allclose(res_1.actions.numpy(),
                               res_t.actions[1].numpy(), rtol=1e-9,
                               atol=1e-9)
    assert int(res_1.iterations) == int(res_t.iterations[1])


@pytest.mark.parametrize("boxqp", [False, True], ids=["K6a", "K6b"])
def test_ddp_wrappers_run_plain_versions_on_cpu_only(boxqp):
    name = "hvac" if boxqp else "navigation"
    _, tenv, models, mu, U = _setup(name, "synthetic", seed=5)
    lin, quad, fin, sec = _torch_models(*models)
    mu_t, U_t = torch.as_tensor(mu), torch.as_tensor(U)
    if boxqp:
        wrapper = lambda: riccati.riccati_backward_ddp_boxqp(  # noqa: E731
            lin, quad, fin, mu_t, tenv.bounds, U_t, sec)
        ref = riccati.riccati_backward_ddp_boxqp_ref(lin, quad, fin, mu_t,
                                                     tenv.bounds, U_t, sec)
        a = riccati._to_kernel_layout(lin, quad, fin, mu_t, tenv.bounds, U_t)
        keys, launcher = riccati.K6B_ARGS, \
            riccati.riccati_backward_ddp_boxqp_kernel
    else:
        wrapper = lambda: riccati.riccati_backward_ddp(  # noqa: E731
            lin, quad, fin, mu_t, sec)
        ref = riccati.riccati_backward_ddp_ref(lin, quad, fin, mu_t, sec)
        a = riccati._to_kernel_layout(lin, quad, fin, mu_t)
        keys, launcher = riccati.K6A_ARGS, riccati.riccati_backward_ddp_kernel
    a.update(riccati._second_to_kernel_layout(sec))
    launches = (riccati.DDP_LAUNCHES, riccati.DDP_BOXQP_LAUNCHES)
    before = _counts()
    ok, pol, dv1, dv2 = wrapper()
    after = _counts()
    assert [x - y for x, y in zip(after, before)] == \
        ([0, 0, 0, 1] if boxqp else [0, 0, 1, 0])
    assert torch.equal(ok, ref[0]) and not bool(ok.all())
    assert torch.equal(pol.K[ok], ref[1].K[ok])
    assert torch.equal(dv2[ok], ref[3][ok])
    # the launcher never computes on the CPU
    assert set(keys) == set(a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(*(a[k] for k in keys))
    assert (riccati.DDP_LAUNCHES, riccati.DDP_BOXQP_LAUNCHES) == launches


# -- (f) the compacted restart loop with the Hessians gathered ------------------

@pytest.mark.parametrize("n_bad", [4, 140])
def test_compacted_restart_loop_with_second_matches_full(n_bad):
    """B=160 > R=128 routes the DDP backward's restarts through the
    compacted sub-batch loop, which must gather each retried lane's rows of
    the Hessians: it equals the full-batch loop lane for lane. With 140
    failing lanes some wait a round."""
    _, tenv, _ = _envs("navigation")
    Bc, Tc = 160, 6
    rng = np.random.default_rng(9)
    x0 = torch.as_tensor(rng.uniform(-6, 6, (Bc, 2)))
    U = torch.as_tensor(0.3 * rng.standard_normal((Bc, Tc, 2)))
    X, _ = tenv.rollout(x0, U)
    lin, quad, fin = ilqr.derivatives(tenv, X, U)
    second = ilqr.second_derivatives(tenv, X, U)
    bad = rng.choice(Bc, n_bad, replace=False)
    l_uu = quad.l_uu.clone()
    l_uu[bad] = -4.0 * torch.eye(2, dtype=torch.float64)
    quad = dataclasses.replace(quad, l_uu=l_uu)
    mu = torch.zeros(Bc, dtype=torch.float64)
    delta = torch.ones(Bc, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(use_pallas=True, ddp=True)

    ok_c, pol_c, dv1_c, dv2_c, mu_c, delta_c = \
        ilqr_batched._backward_restarts_batched(lin, quad, fin, mu, delta,
                                                cfg, None, U, second)
    assert int((mu_c > 0).sum()) >= n_bad  # the bad lanes did restart
    ok_f, pol_f, dv1_f, dv2_f, mu_f, delta_f = ilqr_batched._restart_loop(
        lambda mu_: ilqr_batched._backward_batched(
            lin, quad, fin, mu_, cfg, None, U, second), mu, delta, cfg)
    assert torch.equal(ok_c, ok_f) and bool(ok_c.all())
    assert torch.equal(mu_c, mu_f) and torch.equal(delta_c, delta_f)
    for got, want in ((pol_c.K, pol_f.K), (pol_c.k, pol_f.k), (dv1_c, dv1_f),
                      (dv2_c, dv2_f)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
    # without the Hessians the same lanes give other gains
    ok_i, pol_i, *_ = ilqr_batched._backward_restarts_batched(
        lin, quad, fin, mu, delta, cfg, None, U)
    assert float((pol_i.K - pol_c.K).abs().max()) > 1e-5


# -- (g) the warm-start recipe ----------------------------------------------------

def test_warm_start_recipe_resumes_as_jax():
    """The JAX package's far-from-optimum recipe: three iLQR iterations in
    JAX, the state carried over as numpy arrays, then ``resume`` with
    ``ddp=True`` in the port, equal to JAX's own resume."""
    jenv, tenv, _ = _envs("navigation")
    x0 = jnp.asarray(np.random.default_rng(3).uniform(-8, 8, (3, 2)))
    warm = jilqr.solve_batch(jenv, x0, horizon=25,
                             config=jilqr.ILQRConfig(atol=1e-10,
                                                     max_iterations=3))
    jstate = jbatched.state_from_result(warm)
    full = jilqr.ILQRConfig(atol=1e-8, max_iterations=60, ddp=True)
    res_j = jbatched.resume(jenv, jstate, config=full)

    state = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()},
        device="cpu")
    config = interop.config_from_dict(dataclasses.asdict(full))
    assert config.ddp
    res_t = ilqr_batched.resume(tenv, state, config=config)
    _assert_same_solve(res_t, res_j)
    assert bool(res_t.converged.all())
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
