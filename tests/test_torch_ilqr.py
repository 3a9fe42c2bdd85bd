"""The port's iLQR solvers vs the JAX package, float64 on CPU.

Inputs are drawn with numpy from a seed and handed to both packages. The
JAX side runs ``solve_batch(use_pallas=True)``: its Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU. On CPU
tensors the port's kernel wrappers run their plain PyTorch versions.

Tolerances: controls within 1e-6 of the JAX solve and identical
converged/failed masks and iteration counts (the ROADMAP's slice-A
target): the two packages compute the same float64 algorithm and differ
only in rounding order (~1e-14 per step), far below both the controls'
tolerance and the convergence threshold. The batch-vs-single and
compacted-restart checks compare the port with itself at 1e-9, as the JAX
package's tests do.
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracles import ilqr_navigation_oracle_np
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import ilqr_batched as jbatched
from tfmpc_tpu_torch import interop
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import riccati, riccati_mid, rollout
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

GOAL = [8.0, -5.0]
ZONE = {"center": [[3.0, -2.0]], "decay": [2.0]}
T = 20
HEADLINE = dict(atol=1e-4, max_iterations=50, use_pallas=True)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    return (jax_make_navigation(GOAL, ZONE, dtype=jnp.float64),
            make_navigation(GOAL, ZONE, dtype=torch.float64, device="cpu"))


def _x0(B, seed=0):
    return np.random.default_rng(seed).uniform(-10.0, 10.0, (B, 2))


def _assert_same_solve(res_t, res_j, atol=1e-6):
    np.testing.assert_allclose(res_t.actions.numpy(), np.asarray(res_j.actions),
                               rtol=0, atol=atol)
    np.testing.assert_array_equal(res_t.converged.numpy(),
                                  np.asarray(res_j.converged))
    np.testing.assert_array_equal(res_t.failed.numpy(),
                                  np.asarray(res_j.failed))
    np.testing.assert_array_equal(res_t.iterations.numpy(),
                                  np.asarray(res_j.iterations))


@pytest.mark.parametrize("B", [128, 100])
def test_solve_batch_matches_jax_kernel_path(envs, B):
    """The slice end to end. B=100 is ragged: the JAX package pads it to
    its 128-lane rule, the port runs it as it is."""
    jenv, tenv = envs
    x0 = _x0(B)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**HEADLINE))
    plain = riccati.PLAIN_CALLS, rollout.TRAJ_PLAIN_CALLS
    launches = (riccati.LAUNCHES, rollout.COSTS_LAUNCHES,
                rollout.ALPHA_LAUNCHES, rollout.TRAJ_LAUNCHES)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**HEADLINE))
    _assert_same_solve(res_t, res_j)
    assert bool(res_t.converged.all())
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
    np.testing.assert_allclose(res_t.states.numpy(), np.asarray(res_j.states),
                               rtol=0, atol=1e-6)
    # CPU tensors: the wrappers ran their plain versions (the line search
    # on AUTO's emit-trajectories layout), no kernel launched
    assert riccati.PLAIN_CALLS > plain[0]
    assert rollout.TRAJ_PLAIN_CALLS > plain[1]
    assert (riccati.LAUNCHES, rollout.COSTS_LAUNCHES,
            rollout.ALPHA_LAUNCHES, rollout.TRAJ_LAUNCHES) == launches
    # the plain PyTorch path (use_pallas=False) reaches the same solve
    res_p = ilqr.solve_batch(
        tenv, torch.as_tensor(x0), horizon=T,
        config=ilqr.ILQRConfig(**{**HEADLINE, "use_pallas": False}))
    _assert_same_solve(res_p, res_j)


def test_batch_matches_single(envs):
    _, tenv = envs
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(-8, 8, (5, 2)))
    config = ilqr.ILQRConfig(atol=1e-8, max_iterations=50, use_pallas=True)
    resb = ilqr.solve_batch(tenv, x0, horizon=T, config=config)
    for i in range(5):
        res1 = ilqr.solve(tenv, x0[i], horizon=T, config=config)
        np.testing.assert_allclose(resb.actions[i].numpy(),
                                   res1.actions.numpy(), rtol=1e-9, atol=1e-9)
        assert bool(resb.converged[i]) == bool(res1.converged)
        assert int(resb.iterations[i]) == int(res1.iterations)


@pytest.mark.parametrize("n_bad", [4, 150])
def test_compacted_restart_loop_matches_full(envs, n_bad):
    """B > 128 routes restarts through the compacted sub-batch loop; every
    lane must see the escalation sequence of the single-scenario restart
    loop, and the JAX package's compacted loop must agree. With 150 failing
    lanes (> R = 128) some lanes wait a round."""
    jenv, tenv = envs
    B, Tb = 256, 8
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-6, 6, (B, 2))
    U = 0.2 * rng.standard_normal((B, Tb, 2))
    X, _ = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))
    lin, quad, fin = ilqr.derivatives(tenv, X, torch.as_tensor(U))
    bad = rng.choice(B, n_bad, replace=False)
    l_uu = quad.l_uu.clone()
    l_uu[bad] = -4.0 * torch.eye(2, dtype=torch.float64)
    quad = dataclasses.replace(quad, l_uu=l_uu)
    mu = torch.zeros(B, dtype=torch.float64)
    delta = torch.ones(B, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(use_pallas=True)

    ok_c, pol_c, dv1_c, dv2_c, mu_c, delta_c = \
        ilqr_batched._backward_restarts_batched(lin, quad, fin, mu, delta, cfg)
    assert int((mu_c > 0).sum()) >= n_bad  # the bad lanes did restart
    for i in range(B):
        row = lambda m: dataclasses.replace(  # noqa: E731
            m, **{f: getattr(m, f)[i] for f in m.__dataclass_fields__})
        ok, pol, dv1, dv2, mu_i, delta_i = ilqr.backward_with_restarts(
            row(lin), row(quad), row(fin), mu[i], delta[i], cfg)
        assert bool(ok) == bool(ok_c[i])
        assert float(mu_i) == float(mu_c[i])
        assert float(delta_i) == float(delta_c[i])
        if bool(ok):
            np.testing.assert_allclose(pol.K.numpy(), pol_c.K[i].numpy(),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(pol.k.numpy(), pol_c.k[i].numpy(),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(float(dv1), float(dv1_c[i]),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(float(dv2), float(dv2_c[i]),
                                       rtol=1e-9, atol=1e-12)

    jlin, jquad, jfin = jbatched._derivatives_batched(jenv, jnp.asarray(X),
                                                      jnp.asarray(U))
    jquad = dataclasses.replace(jquad, l_uu=jnp.asarray(l_uu.numpy()))
    ok_j, _, _, _, mu_j, delta_j = jax.jit(
        lambda: jbatched._backward_restarts_batched(
            jlin, jquad, jfin, jnp.zeros(B), jnp.ones(B),
            jilqr.ILQRConfig(), None, jnp.asarray(U)))()
    np.testing.assert_array_equal(ok_c.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(mu_c.numpy(), np.asarray(mu_j))
    np.testing.assert_array_equal(delta_c.numpy(), np.asarray(delta_j))


def test_resume_from_jax_state(envs):
    """A JAX solve stopped after one iteration, carried over as numpy
    arrays, resumes in the port exactly as it resumes in JAX."""
    jenv, tenv = envs
    x0 = jnp.asarray(_x0(128, seed=3))
    first = jilqr.ILQRConfig(**{**HEADLINE, "max_iterations": 1})
    jstate = jbatched.state_from_result(
        jilqr.solve_batch(jenv, x0, horizon=T, config=first))
    full = jilqr.ILQRConfig(**HEADLINE)
    res_j = jbatched.resume(jenv, jstate, config=full)

    state = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in jstate._asdict().items()},
        device="cpu")
    config = interop.config_from_dict(dataclasses.asdict(full))
    res_t = ilqr_batched.resume(tenv, state, config=config)
    _assert_same_solve(res_t, res_j)
    assert int(res_t.iterations.max()) >= 2
    with pytest.raises(ValueError, match="sizes"):
        ilqr_batched.resume(
            make_navigation([1.0, 2.0, 3.0], None, dtype=torch.float64,
                            device="cpu"),
            state, config=config)


def test_trace_mode_matches_jax(envs):
    jenv, tenv = envs
    x0 = _x0(8, seed=4)
    cfg = dict(atol=1e-8, max_iterations=5)
    res_j, tr_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                                    config=jilqr.ILQRConfig(**cfg),
                                    return_trace=True)
    res_t, tr_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                                   config=ilqr.ILQRConfig(**cfg),
                                   return_trace=True)
    _assert_same_solve(res_t, res_j)
    for name in tr_t._fields:
        ours, theirs = getattr(tr_t, name).numpy(), np.asarray(getattr(tr_j,
                                                                       name))
        assert ours.shape == theirs.shape == (5, 8), name
        if ours.dtype == bool:
            np.testing.assert_array_equal(ours, theirs, err_msg=name)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9,
                                       err_msg=name)
    # the early-stopping loop ends in the same state
    res_w = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**cfg))
    assert torch.equal(res_w.actions, res_t.actions)


ORACLE_CASES = [
    # (goal, centers, decays, x0)
    ([8.0, -5.0], [[3.0, -2.0]], [2.0], [0.0, 0.0]),
    ([8.0, -5.0], [[3.0, -2.0], [6.0, -4.0]], [2.0, 1.5], [-1.0, 1.0]),
    ([5.0, 5.0], [], [], [0.0, 0.0]),
]


@pytest.mark.parametrize("goal,centers,decays,x0", ORACLE_CASES)
def test_controls_match_numpy_oracle(goal, centers, decays, x0):
    """Against the independent float64 NumPy iLQR: the port converges to
    the oracle's optimum (1e-6: both solve to atol=1e-10 in float64)."""
    _, U_np, J_np = ilqr_navigation_oracle_np(goal, centers, decays, x0, T,
                                              atol=1e-10)
    env = make_navigation(
        goal, {"center": centers, "decay": decays} if centers else None,
        dtype=torch.float64, device="cpu")
    res = ilqr.solve_batch(
        env, torch.as_tensor([x0], dtype=torch.float64), horizon=T,
        config=ilqr.ILQRConfig(atol=1e-10, max_iterations=200,
                               use_pallas=True))
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.actions[0].numpy(), U_np, rtol=0,
                               atol=1e-6)
    assert abs(float(res.total_cost[0]) - J_np) < 1e-9 * max(1.0, abs(J_np))


def test_config_carries_over_and_refuses_unported_options(envs):
    jcfg = jilqr.ILQRConfig(atol=1e-5, max_iterations=7, use_pallas=True,
                            mu_min=1e-5)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for option in (dict(time_axis="time"),
                   dict(time_axis="time", parallel_backward=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ilqr.ILQRConfig(**option)
    # the associative-scan backward cannot carry the DDP terms
    with pytest.raises(ValueError, match="parallel_backward"):
        ilqr.ILQRConfig(ddp=True, parallel_backward=True)
    # slice C's, D's and F's options are ported and carry over
    for option in (dict(parallel_backward=True, parallel_mu_floor=1e-4),
                   dict(linesearch_emit_trajectories=True),
                   dict(linesearch_emit_trajectories=False),
                   dict(ddp=True), dict(ddp=True, boxqp=True),
                   dict(use_pallas=True, fuse_derivatives=True)):
        jc = jilqr.ILQRConfig(**option)
        assert dataclasses.asdict(interop.config_from_dict(
            dataclasses.asdict(jc))) == dataclasses.asdict(jc)
    # boxQP is ported: the option carries over, and a bounded env solves
    # with its controls inside the box
    jbox = jilqr.ILQRConfig(boxqp=True, boxqp_iters=5)
    assert dataclasses.asdict(interop.config_from_dict(
        dataclasses.asdict(jbox))) == dataclasses.asdict(jbox)
    bounded = interop.navigation_from_numpy(
        GOAL, ZONE["center"], ZONE["decay"], low=-1.0, high=1.0,
        device="cpu", dtype=torch.float64)
    res = ilqr.solve_batch(bounded, torch.zeros(2, 2, dtype=torch.float64),
                           horizon=5, config=ilqr.ILQRConfig(boxqp=True))
    assert bool(torch.isfinite(res.actions).all())
    assert float(res.actions.abs().max()) <= 1.0
    # alphas follow the state's dtype
    assert ilqr.ILQRConfig().alphas(torch.float32,
                                    device="cpu").dtype == torch.float32


def test_package_never_imports_jax():
    """``import tfmpc_tpu_torch`` and a tiny CPU solve with JAX blocked."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import torch
        import tfmpc_tpu_torch
        from tfmpc_tpu_torch import interop
        from tfmpc_tpu_torch.models.navigation import make_navigation
        from tfmpc_tpu_torch.solvers import ilqr
        env = make_navigation([8.0, -5.0], {"center": [[3.0, -2.0]],
                                            "decay": [2.0]}, device="cpu")
        res = ilqr.solve_batch(env, torch.zeros(3, 2), horizon=10,
                               config=ilqr.ILQRConfig(use_pallas=True))
        assert bool(res.converged.all())
        loaded = [m for m in sys.modules if m == "jax" or
                  m.startswith(("jax.", "tfmpc_tpu.")) or m == "tfmpc_tpu"]
        assert loaded == ["jax"], loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- slice B: control limits (boxQP backward, clipped rollouts, KKT) ----------
#
# The port's solve_batch on bounded envs against the JAX package's
# (use_pallas=False: its vmapped-scan boxQP backward and XLA line search,
# the reference its own kernel tests pin), float64, B=8. Tolerances as
# above: identical converged/failed masks and iteration counts, controls
# within 1e-6 and total costs within 1e-9 relative.

HVAC3 = dict(adj=[[0, 1, 0], [1, 0, 1], [0, 1, 0]],
             is_out=[1, 0, 1], is_hall=[0, 1, 0])


def _bounded_envs(name):
    from tfmpc_tpu.models.hvac import make_hvac as jax_make_hvac
    from tfmpc_tpu.models.reservoir import make_reservoir as jax_make_reservoir
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.reservoir import make_reservoir

    if name == "hvac":
        kw = dict(HVAC3)
        adj = kw.pop("adj")
        return (jax_make_hvac(adj, **kw, dtype=jnp.float64),
                make_hvac(adj, **kw, dtype=torch.float64, device="cpu"),
                (8.0, 18.0))
    if name == "reservoir":
        return (jax_make_reservoir(4, dtype=jnp.float64),
                make_reservoir(4, dtype=torch.float64, device="cpu"),
                (20.0, 95.0))
    return (jax_make_navigation(GOAL, ZONE, low=-1.0, high=1.0,
                                dtype=jnp.float64),
            make_navigation(GOAL, ZONE, low=-1.0, high=1.0,
                            dtype=torch.float64, device="cpu"),
            (-10.0, 10.0))


@pytest.mark.parametrize("name,boxqp,horizon", [
    ("hvac", True, 10), ("reservoir", True, 10), ("navigation", False, 20),
])
def test_bounded_solve_batch_matches_jax(name, boxqp, horizon):
    """The slice as a whole: boxQP on HVAC-3 and reservoir-4 (kernel K4's
    plain version; at reservoir-4's dims (4, 4), outside K4's
    instantiations, K7's, the same function) and clip-only bounded
    navigation (K1's), each with the clipped line search and the KKT test,
    against the JAX package."""
    jenv, tenv, lohi = _bounded_envs(name)
    x0 = np.random.default_rng(3).uniform(*lohi, (8, tenv.state_size))
    cfg = dict(atol=1e-3, max_iterations=30, boxqp=boxqp)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=horizon,
                              config=jilqr.ILQRConfig(**cfg))
    counts = _backward_plain_calls()
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=horizon,
                             config=ilqr.ILQRConfig(**cfg, use_pallas=True))
    _assert_same_solve(res_t, res_j)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
    assert bool(res_t.converged.any())
    assert float(res_t.actions.min()) >= float(tenv.bounds.low.min())
    assert float(res_t.actions.max()) <= float(tenv.bounds.high.max())
    # the kernel wrappers ran their plain versions: K4's (or K7's boxQP
    # variant) for boxqp, K1's (or K7's iLQR variant) for clip-only
    box, plain = _backward_plain_calls()
    if boxqp:
        assert box > counts[0]
        assert plain == counts[1]
    else:
        assert box == counts[0]
        assert plain > counts[1]


def _backward_plain_calls():
    """Plain-version calls of the boxQP backward wrappers (K4's and K7's)
    and of the iLQR ones (K1's and K7's)."""
    return (riccati.BOXQP_PLAIN_CALLS + riccati_mid.MID_BOXQP_PLAIN_CALLS,
            riccati.PLAIN_CALLS + riccati_mid.MID_PLAIN_CALLS)


KKT_CASES = {
    # (g, low, high) from tests/test_kkt_scaling.py
    "normal": ([[50.0, -300.0]], [0.0, 0.0], [10.0, 10.0]),
    "capped": ([[1e7, 1e7]], [0.0, 0.0], [10.0, 10.0]),
    "infinite": ([[1e7, 1e7]], [-np.inf, -np.inf], [np.inf, np.inf]),
    "one_sided": ([[1e7, 1e7]], [0.0, -2.0], [np.inf, 2.0]),
    "small": ([[5e-4, -3e-3]], [0.0, 0.0], [10.0, 10.0]),
}


@pytest.mark.parametrize("case", sorted(KKT_CASES))
def test_kkt_scale_and_threshold_match_jax(case):
    from tfmpc_tpu.core.types import Bounds as JBounds
    from tfmpc_tpu.solvers.ilqr import _kkt_scale as j_scale
    from tfmpc_tpu.solvers.ilqr import _kkt_threshold as j_threshold
    from tfmpc_tpu_torch.core.types import Bounds

    g, low, high = (np.asarray(a, float) for a in KKT_CASES[case])
    jb = JBounds(low=jnp.asarray(low), high=jnp.asarray(high))
    tb = Bounds(low=torch.as_tensor(low), high=torch.as_tensor(high))
    cfg, jcfg = ilqr.ILQRConfig(), jilqr.ILQRConfig()
    assert float(ilqr._kkt_scale(torch.as_tensor(g))) == float(
        j_scale(jnp.asarray(g)))
    assert float(ilqr._kkt_threshold(cfg, torch.as_tensor(g), tb)) == \
        pytest.approx(float(j_threshold(jcfg, jnp.asarray(g), jb)),
                      rel=1e-15)
    # batched: per-lane scale over the trailing axes of [B, T, m]
    gb = np.stack([g, 10.0 * g, 1e-3 * g])[:, None, :, 0]
    np.testing.assert_allclose(
        ilqr._kkt_threshold(cfg, torch.as_tensor(gb), tb, axes=(1, 2)),
        np.asarray(j_threshold(jcfg, jnp.asarray(gb), jb, axes=(1, 2))),
        rtol=1e-15)


def test_kkt_stationarity_matches_jax():
    """The gradient behind the KKT test (autograd of the summed batch
    cost) equals the JAX package's per-scenario ``jax.grad`` of
    ``total_cost``, and the test's verdict agrees, at random controls and
    at a solved trajectory."""
    from tfmpc_tpu.solvers.ilqr import _kkt_threshold as j_threshold

    jenv, tenv, lohi = _bounded_envs("hvac")
    rng = np.random.default_rng(8)
    x0 = rng.uniform(*lohi, (4, 3))
    solved = ilqr.solve_batch(
        tenv, torch.as_tensor(x0), horizon=12,
        config=ilqr.ILQRConfig(atol=1e-10, max_iterations=100, boxqp=True))
    U_rand = np.clip(rng.uniform(-2.0, 12.0, (4, 12, 3)), 0.0, 10.0)
    verdicts = []
    for U in (U_rand, solved.actions.numpy()):
        g_j = jax.vmap(jax.grad(jenv.total_cost, argnums=1))(
            jnp.asarray(x0), jnp.asarray(U))
        pg = U - np.asarray(jenv.clip(jnp.asarray(U) - g_j))
        want = np.abs(pg).max(axis=(1, 2)) < np.asarray(j_threshold(
            jilqr.ILQRConfig(), g_j, jenv.bounds, axes=(1, 2)))
        got = ilqr._kkt_stationary(tenv, torch.as_tensor(x0),
                                   torch.as_tensor(U), ilqr.ILQRConfig(),
                                   axes=(1, 2))
        np.testing.assert_array_equal(got.numpy(), want)
        verdicts.append(want)
    assert not verdicts[0].any() and verdicts[1].all()


def test_bounded_batch_matches_single():
    _, tenv, lohi = _bounded_envs("hvac")
    x0 = torch.as_tensor(np.random.default_rng(4).uniform(*lohi, (3, 3)))
    config = ilqr.ILQRConfig(atol=1e-8, max_iterations=40, boxqp=True,
                             use_pallas=True)
    resb = ilqr.solve_batch(tenv, x0, horizon=10, config=config)
    for i in range(3):
        res1 = ilqr.solve(tenv, x0[i], horizon=10, config=config)
        np.testing.assert_allclose(resb.actions[i].numpy(),
                                   res1.actions.numpy(), rtol=1e-9, atol=1e-9)
        assert bool(resb.converged[i]) == bool(res1.converged)
        assert int(resb.iterations[i]) == int(res1.iterations)


@pytest.mark.parametrize("n_bad", [4, 150])
def test_compacted_restart_loop_with_ubar_matches_full(n_bad):
    """B > 128 routes the boxQP backward's restarts through the compacted
    sub-batch loop, which must gather each retried lane's row of Ubar: every
    lane sees the escalation sequence and the gains of the single-scenario
    restart loop, and the JAX package's compacted loop agrees."""
    jenv, tenv, lohi = _bounded_envs("hvac")
    B, Tb = 256, 4
    rng = np.random.default_rng(9)
    x0 = torch.as_tensor(rng.uniform(*lohi, (B, 3)))
    U = tenv.clip(torch.as_tensor(rng.uniform(0.0, 4.0, (B, Tb, 3))))
    X, _ = tenv.rollout(x0, U)
    lin, quad, fin = ilqr.derivatives(tenv, X, U)
    bad = rng.choice(B, n_bad, replace=False)
    l_uu = quad.l_uu.clone()
    l_uu[bad] = -40.0 * torch.eye(3, dtype=torch.float64)
    quad = dataclasses.replace(quad, l_uu=l_uu)
    mu = torch.zeros(B, dtype=torch.float64)
    delta = torch.ones(B, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(boxqp=True, use_pallas=True)

    ok_c, pol_c, dv1_c, dv2_c, mu_c, delta_c = \
        ilqr_batched._backward_restarts_batched(lin, quad, fin, mu, delta,
                                                cfg, tenv.bounds, U)
    assert int((mu_c > 0).sum()) >= n_bad
    for i in sorted(set(bad[:6].tolist()) | set(range(0, B, 32))):
        row = lambda m: dataclasses.replace(  # noqa: E731
            m, **{f: getattr(m, f)[i] for f in m.__dataclass_fields__})
        ok, pol, dv1, dv2, mu_i, delta_i = ilqr.backward_with_restarts(
            row(lin), row(quad), row(fin), mu[i], delta[i], cfg,
            tenv.bounds, U[i])
        assert bool(ok) == bool(ok_c[i])
        assert float(mu_i) == float(mu_c[i])
        assert float(delta_i) == float(delta_c[i])
        if bool(ok):
            np.testing.assert_allclose(pol.K.numpy(), pol_c.K[i].numpy(),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(pol.k.numpy(), pol_c.k[i].numpy(),
                                       rtol=1e-9, atol=1e-9)
            np.testing.assert_allclose(float(dv1), float(dv1_c[i]),
                                       rtol=1e-9, atol=1e-12)

    jlin, jquad, jfin = jbatched._derivatives_batched(
        jenv, jnp.asarray(X.numpy()), jnp.asarray(U.numpy()))
    jquad = dataclasses.replace(jquad, l_uu=jnp.asarray(l_uu.numpy()))
    ok_j, _, _, _, mu_j, delta_j = jax.jit(
        lambda: jbatched._backward_restarts_batched(
            jlin, jquad, jfin, jnp.zeros(B), jnp.ones(B),
            jilqr.ILQRConfig(boxqp=True), jenv.bounds,
            jnp.asarray(U.numpy())))()
    np.testing.assert_array_equal(ok_c.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(mu_c.numpy(), np.asarray(mu_j))
    np.testing.assert_array_equal(delta_c.numpy(), np.asarray(delta_j))


# -- slice C: long horizons (emit-trajectories line search, parallel backward) --
#
# The port's solve_batch with the emit-trajectories line search (K5's and
# K4's plain versions on CPU tensors, and the select) and with the O(log T)
# parallel backward, against the JAX package (use_pallas=False: its XLA
# line search and vmapped backward), float64. Tolerances as above:
# identical masks and iterations, controls within 1e-6, costs within 1e-9
# relative. The parallel backward composes in another tree than JAX's
# associative scan, which moves its gains by rounding only (~1e-12).

def _x0_of(tenv, lohi, B, seed):
    return np.random.default_rng(seed).uniform(*lohi, (B, tenv.state_size))


def test_emit_trajectories_solve_batch_matches_jax():
    """The slice as a whole, at a small size: reservoir-4 boxQP with the
    emit-trajectories line search, then the same solve on the two-kernel
    layout, which must give the identical result."""
    jenv, tenv, lohi = _bounded_envs("reservoir")
    x0 = _x0_of(tenv, lohi, 8, seed=20)
    cfg = dict(atol=1e-3, max_iterations=30, boxqp=True)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=30,
                              config=jilqr.ILQRConfig(**cfg))
    counts = (rollout.TRAJ_PLAIN_CALLS, rollout.COSTS_PLAIN_CALLS,
              rollout.ALPHA_PLAIN_CALLS, _backward_plain_calls()[0])
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=30,
                             config=ilqr.ILQRConfig(
                                 **cfg, use_pallas=True,
                                 linesearch_emit_trajectories=True))
    assert rollout.TRAJ_PLAIN_CALLS > counts[0]
    assert (rollout.COSTS_PLAIN_CALLS, rollout.ALPHA_PLAIN_CALLS) \
        == counts[1:3]
    assert _backward_plain_calls()[0] > counts[3]
    _assert_same_solve(res_t, res_j)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
    assert bool(res_t.converged.all())
    res_2k = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=30,
                              config=ilqr.ILQRConfig(
                                  **cfg, use_pallas=True,
                                  linesearch_emit_trajectories=False))
    assert rollout.ALPHA_PLAIN_CALLS > counts[2]
    for name in res_t._fields:
        assert torch.equal(getattr(res_t, name), getattr(res_2k, name)), name


@pytest.mark.parametrize("name,boxqp,horizon", [
    ("reservoir", True, 24), ("navigation_free", False, 20),
])
def test_parallel_backward_solve_batch_matches_jax(name, boxqp, horizon):
    if name == "navigation_free":
        jenv, tenv = (jax_make_navigation(GOAL, ZONE, dtype=jnp.float64),
                      make_navigation(GOAL, ZONE, dtype=torch.float64,
                                      device="cpu"))
        lohi = (-5.0, 5.0)
    else:
        jenv, tenv, lohi = _bounded_envs(name)
    x0 = _x0_of(tenv, lohi, 6, seed=21)
    cfg = dict(atol=1e-4, max_iterations=40, boxqp=boxqp,
               parallel_backward=True)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=horizon,
                              config=jilqr.ILQRConfig(**cfg))
    plain = (riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=horizon,
                             config=ilqr.ILQRConfig(**cfg, use_pallas=True))
    # the parallel pass owns the backward even with use_pallas
    assert (riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS) == plain
    _assert_same_solve(res_t, res_j)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
    assert bool(res_t.converged.all())


def test_parallel_backward_single_solve_matches_jax():
    jenv, tenv, lohi = _bounded_envs("hvac")
    x0 = [10.0, 12.0, 14.0]
    cfg = dict(atol=1e-4, max_iterations=60, boxqp=True,
               parallel_backward=True)
    res_j = jilqr.solve(jenv, jnp.asarray(x0), horizon=12,
                        config=jilqr.ILQRConfig(**cfg))
    res_t = ilqr.solve(tenv, torch.tensor(x0, dtype=torch.float64),
                       horizon=12, config=ilqr.ILQRConfig(**cfg))
    assert bool(res_t.converged) == bool(res_j.converged)
    assert int(res_t.iterations) == int(res_j.iterations)
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-6)
    assert float(res_t.total_cost) == pytest.approx(
        float(res_j.total_cost), rel=1e-9)


def test_emit_trajectories_auto_resolution():
    """True and False pin the layout at any shape; AUTO (the default)
    takes the emit-trajectories layout everywhere, the H100 A/B of device
    times having found it faster by more than 10% at every shape measured,
    T from 20 to 500 and n = m from 2 to 16 (the port's version of
    tests/test_rollout_pallas.py::test_emit_trajectories_auto_resolution,
    whose TPU rule turns it on from T=250 up to max(n, m) = 12)."""
    resolve = ilqr_batched._resolve_emit_traj
    auto = ilqr.ILQRConfig()
    assert auto.linesearch_emit_trajectories is None
    on = ilqr.ILQRConfig(linesearch_emit_trajectories=True)
    off = ilqr.ILQRConfig(linesearch_emit_trajectories=False)
    for horizon, n, m in ((4, 2, 2), (20, 2, 2), (100, 6, 6), (250, 2, 2),
                          (500, 5, 5), (500, 12, 12), (500, 48, 48)):
        assert resolve(auto, horizon, n, m)
        assert resolve(on, horizon, n, m)
        assert not resolve(off, horizon, n, m)
