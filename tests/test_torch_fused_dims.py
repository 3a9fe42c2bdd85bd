"""The fused iteration at every navigation dim up to 12, and its rule.

K8 runs unrolled at n = m in ``rollout.DERIVS_DIMS`` and in the generic
form (``csrc/rollout_generic.cuh``, kind kDerivs) at every other n = m <=
12; the fused iteration's backward runs the lane kernels or, at other
dims, K7 through ``riccati.riccati_backward_lanes``. The port's
``_use_fused_derivs`` is the JAX package's rule on every device: the split
iteration for an env without a device linearization and above 12 dims.
No CUDA tensor exists on the CPU, so the wrappers run their plain
versions here, in float64:

- K8's plain version at navigation in 1 and 4 dims against the JAX
  package's K8 (``rollout_alpha_derivs_pallas``, interpret mode, B=128,
  T=8, free and boxed; 1e-9, as ``tests/test_torch_fused.py``), and at 12
  against the JAX package's closed-form ``analytic_derivatives`` of the
  same trajectory (1e-12);
- the fused ``solve_batch`` at navigation-4 against the JAX package's
  fused solve (B=128, which its CPU rule fuses; masks and iterations
  identical, actions within 1e-8), and at navigation-12, with and without
  boxQP, against the port's split solve (1e-12);
- the rule: HVAC and navigation above 12 take the split iteration on a
  card too (where the port raised before), and an HVAC-3 solve with
  ``fuse_derivatives=True`` matches the JAX package's with the same
  config (1e-8);
- the generic K8's index maps: each (step, scenario) of a launch is
  linearized by exactly one thread of its block, and each control and
  next-state row of its rollouts is computed by exactly one lane, at
  every n <= 12 and G of the plan rule, on a block-ragged batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.core.types import Policy as JPolicy
from tfmpc_tpu.models.hvac import make_hvac as jax_make_hvac
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.ops.rollout_pallas import rollout_alpha_derivs_pallas
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import ilqr_batched as jbatched
from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.models.hvac import make_hvac
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import riccati, riccati_mid, rollout
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

ALPHAS = ilqr.ILQRConfig().alphas_static()
FUSED = dict(atol=1e-5, max_iterations=40, use_pallas=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nav(n, bounded=False):
    """Navigation in n dims: the headline's goal and zone padded with 2.0
    and 0.0 (cut at n = 1), in both packages; box +-1 where bounded."""
    goal = ([8.0, -5.0] + [2.0] * n)[:n]
    zones = {"center": [([3.0, -2.0] + [0.0] * n)[:n]], "decay": [2.0]}
    box = dict(low=-1.0, high=1.0) if bounded else {}
    return (jax_make_navigation(goal, zones, dtype=jnp.float64, **box),
            make_navigation(goal, zones, dtype=torch.float64, device="cpu",
                            **box))


def _k8_inputs(tenv, B, T, seed):
    """A nominal trajectory, a feedback policy and each lane's alpha, lane
    0 started on the zone center."""
    n = tenv.state_size
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-6.0, 6.0, (B, n))
    x0[0] = tenv.centers[0].numpy()
    U = tenv.clip(torch.as_tensor(rng.uniform(-1.5, 1.5, (B, T, n))))
    X = tenv.rollout(torch.as_tensor(x0), U)[0]
    policy = Policy(K=torch.as_tensor(0.1 * rng.standard_normal((B, T, n, n))),
                    k=torch.as_tensor(rng.standard_normal((B, T, n))))
    alpha = torch.as_tensor(
        np.asarray(ALPHAS)[rng.integers(0, len(ALPHAS), B)])
    return X, U, policy, alpha


@pytest.mark.parametrize("bounded", [False, True], ids=["free", "box"])
@pytest.mark.parametrize("n", [1, 4])
def test_generic_k8_plain_version_matches_jax_kernel(n, bounded):
    """K8's plain version at dims its generic form runs against the JAX K8
    in interpret mode, B=128, T=8: the trajectory, its cost and all seven
    linearization blocks in the Riccati kernels' entry order."""
    jenv, tenv = _nav(n, bounded)
    assert (n, n) not in rollout.DERIVS_DIMS and rollout.derivs_dims(n, n)
    X, U, policy, alpha = _k8_inputs(tenv, 128, 8, n)
    out_t = rollout.rollout_alpha_derivs_ref(tenv, X, U, policy, alpha)
    out_j = rollout_alpha_derivs_pallas(
        jenv, jnp.asarray(X.numpy()), jnp.asarray(U.numpy()),
        JPolicy(K=jnp.asarray(policy.K.numpy()),
                k=jnp.asarray(policy.k.numpy())), jnp.asarray(alpha.numpy()))
    for name, a, b in zip("XUJ", out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    for key in rollout.D_KEYS:
        np.testing.assert_allclose(out_t[3][key].numpy(),
                                   np.asarray(out_j[3][key]), rtol=1e-9,
                                   atol=1e-9, err_msg=key)


def test_generic_k8_plain_version_at_12_matches_jax_closed_form():
    """At n = 12 (above the JAX package's CPU interpret ceiling of 8): K8's
    plain version's blocks against the JAX package's
    ``analytic_derivatives`` of the trajectory it rolled, laid out [T,
    entries, B] (entries i*n + j of f_x, i*m + c of f_u, c*n + i of l_ux),
    at the clipped controls of a boxed env."""
    jenv, tenv = _nav(12, bounded=True)
    X, U, policy, alpha = _k8_inputs(tenv, 16, 6, 12)
    X_new, U_new, _, blocks = rollout.rollout_alpha_derivs_ref(
        tenv, X, U, policy, alpha)
    assert float((U_new.abs() == 1.0).double().mean()) > 0.1
    lin, quad, _ = jax.vmap(jenv.analytic_derivatives)(
        jnp.asarray(X_new.numpy()), jnp.asarray(U_new.numpy()))
    B, T = U_new.shape[:2]
    lay = lambda a: np.asarray(a).reshape(B, T, -1).transpose(1, 2, 0)  # noqa
    want = dict(fx=lin.f_x, fu=lin.f_u, lx=quad.l_x, lu=quad.l_u,
                lxx=quad.l_xx, luu=quad.l_uu, lux=quad.l_ux)
    for key in rollout.D_KEYS:
        np.testing.assert_allclose(blocks[key].numpy(), lay(want[key]),
                                   rtol=1e-12, atol=1e-12, err_msg=key)


def test_fused_solve_nav4_matches_jax_fused_solve():
    """Navigation in 4 dims, B=128, T=12, x0 ~ U(-8, 8): the port's fused
    iteration (K8's and, for the backward, K7's plain versions through the
    kernel layout) against the JAX package's fused solve."""
    jenv, tenv = _nav(4)
    x0 = np.random.default_rng(0).uniform(-8.0, 8.0, (128, 4))
    jcfg = jilqr.ILQRConfig(**FUSED, fuse_derivatives=True)
    assert jbatched._use_fused_derivs(jenv, jcfg, 128)
    cfg = ilqr.ILQRConfig(**FUSED, fuse_derivatives=True)
    assert ilqr_batched._use_fused_derivs(tenv, cfg, "cuda")
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=12, config=jcfg)
    before = (rollout.DERIVS_PLAIN_CALLS, riccati.PLAIN_CALLS)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=12,
                             config=cfg)
    assert rollout.DERIVS_PLAIN_CALLS > before[0]
    assert riccati.PLAIN_CALLS > before[1]
    assert bool(res_t.converged.all())
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


@pytest.mark.parametrize("boxqp", [False, True])
def test_fused_solve_nav12_matches_split_solve(boxqp):
    """Navigation in 12 dims (boxed with boxQP): the fused iteration,
    which the port now takes there, against its split one (1e-12)."""
    _, tenv = _nav(12, bounded=boxqp)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(-4, 4, (12, 12)))
    base = dict(FUSED, boxqp=boxqp)
    cfg = ilqr.ILQRConfig(**base, fuse_derivatives=True)
    assert ilqr_batched._use_fused_derivs(tenv, cfg, "cuda")
    before = rollout.DERIVS_PLAIN_CALLS
    res_f = ilqr.solve_batch(tenv, x0, horizon=8, config=cfg)
    assert rollout.DERIVS_PLAIN_CALLS - before == int(res_f.iterations.max())
    res_s = ilqr.solve_batch(tenv, x0, horizon=8,
                             config=ilqr.ILQRConfig(**base))
    for name in ("converged", "failed", "iterations"):
        assert torch.equal(getattr(res_f, name), getattr(res_s, name)), name
    for name in ("actions", "states", "total_cost", "mu"):
        np.testing.assert_allclose(getattr(res_f, name).numpy(),
                                   getattr(res_s, name).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


HVAC3 = dict(adj=[[0, 1, 0], [1, 0, 1], [0, 1, 0]], is_out=[1, 0, 1],
             is_hall=[0, 1, 0])


def test_use_fused_derivs_takes_the_split_iteration_where_jax_does():
    """The fault the JAX rule repairs: with ``fuse_derivatives=True`` on a
    card the port raised for an env without a device linearization and
    above 12 dims, where the JAX package takes its split iteration. Now
    HVAC-2 and navigation-16 take it on CUDA too, and an HVAC-3 solve with
    ``fuse_derivatives=True`` (clip-only, T=6) is the JAX package's (f64,
    1e-8; its kernels in interpret mode)."""
    fused = ilqr.ILQRConfig(use_pallas=True, fuse_derivatives=True)
    hvac2 = make_hvac([[0, 1], [1, 0]], is_out=[1, 0], is_hall=[0, 1],
                      dtype=torch.float64, device="cpu")
    _, nav16 = _nav(16)
    for env in (hvac2, nav16):
        assert not ilqr_batched._use_fused_derivs(env, fused, "cuda")
        assert not ilqr_batched._use_fused_derivs(env, fused, "cpu")
    kw = dict(atol=1e-6, max_iterations=20, use_pallas=True,
              fuse_derivatives=True)
    x0 = np.random.default_rng(2).uniform(8.0, 18.0, (5, 3))
    jenv = jax_make_hvac(**HVAC3, dtype=jnp.float64)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=6,
                              config=jilqr.ILQRConfig(**kw))
    tenv = make_hvac(**HVAC3, dtype=torch.float64, device="cpu")
    before = rollout.DERIVS_PLAIN_CALLS
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=6,
                             config=ilqr.ILQRConfig(**kw))
    assert rollout.DERIVS_PLAIN_CALLS == before   # the split iteration
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-8)


def _tail_cover(plan, B, T):
    """How many times the generic K8's tail (csrc/rollout_generic.cuh
    generic_derivs_tail) linearizes each (step, scenario): thread tid of a
    block of ``plan.threads()`` (every thread, the producer warp's too)
    takes scenario b0 + tid % spb at the steps tid // spb, + threads //
    spb, ...; scenarios past B are skipped."""
    spb, nthr = plan.scenarios, plan.threads()
    assert nthr % spb == 0
    cover = np.zeros((T, B), dtype=int)
    for blk in range(plan.blocks(B)):
        for tid in range(nthr):
            b = blk * spb + tid % spb
            if b < B:
                cover[tid // spb::nthr // spb, b] += 1
    return cover


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_generic_derivs_plan_covers_each_step_once(dtype):
    """At every n <= 12, the generic K8's plan (and the plan at each G of
    ``GENERIC_PLANS["derivs"]``) on a block-ragged batch of 37: each (step,
    scenario) is linearized exactly once, each control and next-state row
    of each rollout computed by exactly one lane (K3's map), the block's
    threads and shared bytes within the card's."""
    Bb, Tn = 37, 7
    groups = sorted({row[0] for _, row in
                     rollout.GENERIC_PLANS["derivs"]["other"]})
    for n in range(1, rollout.DERIVS_DIM_MAX + 1):
        pe = 2 * n + 1
        plan = rollout.rollout_plan("derivs", 0, n, n, Bb, 1, dtype, pe)
        assert plan.generic == ((n, n) not in rollout.DERIVS_DIMS)
        for G in sorted(set(groups) | {plan.groups}):
            for spb in (4, 2, 1):
                try:
                    p = rollout._generic_plan("derivs", 0, n, n, Bb, 1,
                                              dtype, pe, G, spb, 1,
                                              rollout.TILE_MAX_THREADS)
                    break
                except ValueError:
                    continue
            assert (_tail_cover(p, Bb, Tn) == 1).all(), (n, G)
            tid = np.arange(p.threads() - 32)
            lane, roll = tid % G, tid // G
            b = np.arange(p.blocks(Bb))[:, None] * p.scenarios + roll \
                % p.scenarios
            live = (roll // p.scenarios < 1) & (b < Bb)
            lane = np.broadcast_to(lane, b.shape)[live]
            k = lane[:, None] + G * np.arange(-(-n // G))[None, :]
            rows = (b[live][:, None] * n + k)[k < n]
            assert (np.bincount(rows, minlength=Bb * n) == 1).all(), (n, G)
            assert p.threads() <= rollout.TILE_MAX_THREADS
            assert p.smem_bytes <= rollout.SMEM_LIMIT


def test_fused_backward_at_mid_dims_runs_k7_on_the_card_route():
    """``riccati.riccati_backward_lanes`` at dims without a lane
    instantiation: on the CPU its plain version through the solver layout
    (counted as K1's plain calls, as at the lane dims), equal to K7's
    wrapper on the same values; K7's launchers are the card's route there
    and refuse CPU tensors."""
    _, tenv = _nav(7)
    X, U, _, _ = _k8_inputs(tenv, 6, 5, 3)
    ka = ilqr_batched._initial_kargs(tenv, X, U)
    VT, vT = ilqr_batched._final_klayout(tenv, X[:, -1])
    mu = torch.full((6,), 0.1, dtype=torch.float64)
    before = riccati.PLAIN_CALLS
    ok, (K, k), dV1, dV2 = riccati.riccati_backward_lanes(ka, VT, vT, mu)
    assert riccati.PLAIN_CALLS == before + 1
    lin, quad, final = tenv.analytic_derivatives(X, U)
    ok_m, pol_m, dV1_m, dV2_m = riccati_mid.riccati_backward_mid(
        lin, quad, final, mu)
    pol = rollout.policy_from_lanes((K, k))
    assert torch.equal(ok, ok_m) and bool(ok.all())
    for got, want in ((pol.K, pol_m.K), (pol.k, pol_m.k), (dV1, dV1_m),
                      (dV2, dV2_m)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati._mid_lanes(ka, VT, vT, mu, None, 8)
