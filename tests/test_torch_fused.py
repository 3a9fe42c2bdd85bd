"""The fully-fused iteration (``fuse_derivatives``) and K8, vs the JAX package.

Inputs are drawn with numpy from a seed and handed to both packages, in
float64 on the CPU. The JAX side runs its Pallas kernels in interpret mode
(``rollout_alpha_derivs_pallas``, and inside ``solve_batch`` K1, K2 and K8,
with ``_use_fused_derivs`` asserted True so the comparison is with its
fused path); on CPU tensors the port's wrappers run their plain versions.

Tolerances: K8's plain version against the JAX K8 within 1e-9 (both
float64; the JAX kernel sums the cost as a running sum, the plain version
sums the stacked stage costs, and the linearization repeats the rollout's
arithmetic in another order: a few ulps). Solves: identical converged and
failed masks and iteration counts, controls within 1e-8. The port's fused
solve against its own split solve: 1e-12 (the same functions on the same
values, in another layout).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.core.types import Policy as JPolicy
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.ops.rollout_pallas import rollout_alpha_derivs_pallas
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu.solvers import ilqr_batched as jbatched
from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.models.hvac import make_hvac
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import riccati, rollout
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

ALPHAS = ilqr.ILQRConfig().alphas_static()
# (goal, zones): n = 2 with one zone (the headline's), n = 3 with two
# zones, and n = 2 with a zone of decay 0, whose factor g is exactly 0 (the
# `g != 0` guard of the linearization)
CASES = {
    "n2": ([8.0, -5.0], {"center": [[3.0, -2.0]], "decay": [2.0]}),
    "n3_two_zones": ([4.0, -3.0, 2.0],
                     {"center": [[1.0, -1.0, 0.5], [2.5, -2.0, 1.0]],
                      "decay": [2.0, 1.5]}),
    "n2_zero_decay": ([8.0, -5.0],
                      {"center": [[3.0, -2.0], [0.0, 1.0]],
                       "decay": [2.0, 0.0]}),
}
FUSED = dict(atol=1e-5, max_iterations=40, use_pallas=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _envs(case, bounded):
    goal, zones = CASES[case]
    box = dict(low=-1.0, high=1.0) if bounded else {}
    return (jax_make_navigation(goal, zones, dtype=jnp.float64, **box),
            make_navigation(goal, zones, dtype=torch.float64, device="cpu",
                            **box))


@pytest.mark.parametrize("bounded", [False, True], ids=["free", "box"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k8_plain_version_matches_jax_kernel(case, bounded):
    """``rollout_alpha_derivs_ref`` against ``rollout_alpha_derivs_pallas``
    in interpret mode, B=128, T=8: the trajectory, its cost and all seven
    linearization blocks in the Riccati kernels' entry order. Lane 0 starts
    on a zone center; a transposed f_u or l_ux would show at n = 3, where
    the box clips many controls (the blocks are taken at the clipped u)."""
    jenv, tenv = _envs(case, bounded)
    n = tenv.state_size
    B, T = 128, 8
    rng = np.random.default_rng(3)
    x0 = rng.uniform(-6.0, 6.0, (B, n))
    x0[0] = np.asarray(CASES[case][1]["center"][0])
    U = rng.uniform(-1.5, 1.5, (B, T, n))
    X = tenv.rollout(torch.as_tensor(x0), tenv.clip(torch.as_tensor(U)))[0]
    U = tenv.clip(torch.as_tensor(U)).numpy()
    K = 0.1 * rng.standard_normal((B, T, n, n))
    k = rng.standard_normal((B, T, n))
    alpha = np.asarray(ALPHAS)[rng.integers(0, len(ALPHAS), B)]

    out_t = rollout.rollout_alpha_derivs_ref(
        tenv, X, torch.as_tensor(U),
        Policy(K=torch.as_tensor(K), k=torch.as_tensor(k)),
        torch.as_tensor(alpha))
    out_j = rollout_alpha_derivs_pallas(
        jenv, jnp.asarray(X.numpy()), jnp.asarray(U),
        JPolicy(K=jnp.asarray(K), k=jnp.asarray(k)), jnp.asarray(alpha))
    if bounded:
        assert float((out_t[1].abs() == 1.0).double().mean()) > 0.1
    for name, a, b in zip("XUJ", out_t[:3], out_j[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-9, err_msg=name)
    assert set(out_j[3]) == set(rollout.D_KEYS)
    for key in rollout.D_KEYS:
        assert out_t[3][key].shape == out_j[3][key].shape, key
        np.testing.assert_allclose(out_t[3][key].numpy(),
                                   np.asarray(out_j[3][key]), rtol=1e-9,
                                   atol=1e-9, err_msg=key)


def test_fused_solve_batch_matches_jax_fused_solve():
    """The slice end to end, the settings of tests/test_fused_derivs.py's
    end-to-end test: B=128, T=20, x0 ~ U(-8, 8), in float64."""
    jenv, tenv = _envs("n2", False)
    x0 = np.random.default_rng(0).uniform(-8.0, 8.0, (128, 2))
    jcfg = jilqr.ILQRConfig(**FUSED, fuse_derivatives=True)
    assert jbatched._use_fused_derivs(jenv, jcfg, 128)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=20, config=jcfg)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=20,
                             config=ilqr.ILQRConfig(**FUSED,
                                                    fuse_derivatives=True))
    assert bool(res_t.converged.all())
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


@pytest.mark.parametrize("boxqp", [False, True])
def test_fused_solve_matches_split_solve(boxqp):
    """The port's fused iteration against its split one (1e-12), and the
    fused route's counters: K8's wrapper materializes, K3's never does,
    and the backward runs K1's wrapper (K4's with boxQP)."""
    _, tenv = _envs("n3_two_zones", boxqp)
    x0 = torch.as_tensor(np.random.default_rng(1).uniform(-4, 4, (16, 3)))
    base = dict(FUSED, boxqp=boxqp)
    counts = (rollout.DERIVS_PLAIN_CALLS, rollout.ALPHA_PLAIN_CALLS,
              riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS)
    res_f = ilqr.solve_batch(tenv, x0, horizon=12, config=ilqr.ILQRConfig(
        **base, fuse_derivatives=True))
    after = (rollout.DERIVS_PLAIN_CALLS, rollout.ALPHA_PLAIN_CALLS,
             riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS)
    iters = int(res_f.iterations.max())
    assert after[0] - counts[0] == iters and after[1] == counts[1]
    assert (after[3] if boxqp else after[2]) > (counts[3] if boxqp
                                                else counts[2])
    res_s = ilqr.solve_batch(tenv, x0, horizon=12,
                             config=ilqr.ILQRConfig(**base))
    for name in ("converged", "failed", "iterations"):
        assert torch.equal(getattr(res_f, name), getattr(res_s, name)), name
    for name in ("actions", "states", "total_cost", "mu"):
        np.testing.assert_allclose(getattr(res_f, name).numpy(),
                                   getattr(res_s, name).numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_fused_trace_mode_bounded_boxqp_matches_jax():
    """Trace mode with a bounded navigation env and boxQP (K4 in the fused
    iteration), against the JAX package's fused trace: B=128, T=10, the
    settings of tests/test_fused_derivs.py's trace test."""
    jenv, tenv = _envs("n2", True)
    x0 = np.random.default_rng(2).uniform(-6.0, 6.0, (128, 2))
    cfg = dict(atol=1e-4, max_iterations=12, use_pallas=True, boxqp=True,
               fuse_derivatives=True)
    jcfg = jilqr.ILQRConfig(**cfg)
    assert jbatched._use_fused_derivs(jenv, jcfg, 128)
    res_j, tr_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=10,
                                    config=jcfg, return_trace=True)
    res_t, tr_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=10,
                                   config=ilqr.ILQRConfig(**cfg),
                                   return_trace=True)
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)))
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    assert float(res_t.actions.abs().max()) <= 1.0
    for name in tr_t._fields:
        ours, theirs = getattr(tr_t, name).numpy(), np.asarray(
            getattr(tr_j, name))
        assert ours.shape == theirs.shape == (12, 128), name
        if ours.dtype == bool:
            np.testing.assert_array_equal(ours, theirs, err_msg=name)
        else:
            np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-8,
                                       err_msg=name)


@pytest.mark.parametrize("n_bad", [3, 129])
def test_compacted_kernel_layout_restarts_match_split(n_bad):
    """B=130 > R=128 routes the fused backward's restarts through the
    compacted loop with the batch on the last axis (gathered with
    ``index_select(-1, idx)``); every lane must end as in the split
    path's restart loop on the same linearization. With 129 failing lanes
    (> R) some wait a round."""
    _, tenv = _envs("n2", False)
    B, T = 130, 8
    rng = np.random.default_rng(7)
    U = torch.as_tensor(0.2 * rng.standard_normal((B, T, 2)))
    X, _ = tenv.rollout(torch.as_tensor(rng.uniform(-6, 6, (B, 2))), U)
    lin, quad, fin = ilqr.derivatives(tenv, X, U)
    bad = rng.choice(B, n_bad, replace=False)
    l_uu = quad.l_uu.clone()
    l_uu[bad] = -4.0 * torch.eye(2, dtype=torch.float64)
    quad = dataclasses.replace(quad, l_uu=l_uu)
    mu = torch.zeros(B, dtype=torch.float64)
    delta = torch.ones(B, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(use_pallas=True, fuse_derivatives=True)

    ok_s, pol_s, dv1_s, dv2_s, mu_s, delta_s = \
        ilqr_batched._backward_restarts_batched(lin, quad, fin, mu, delta,
                                                cfg)
    a = riccati._to_kernel_layout(lin, quad, fin, mu)
    kargs = {key: a[key] for key in rollout.D_KEYS}
    ok_k, pol_k, dv1_k, dv2_k, mu_k, delta_k = \
        ilqr_batched._backward_restarts_klayout(tenv, kargs, X[:, -1], mu,
                                                delta, cfg, U)
    assert int((mu_k > 0).sum()) >= n_bad  # the bad lanes did restart
    for ours, theirs in ((ok_k, ok_s), (mu_k, mu_s), (delta_k, delta_s)):
        assert torch.equal(ours, theirs)
    pol_k = rollout.policy_from_lanes(pol_k)
    for ours, theirs in ((pol_k.K, pol_s.K), (pol_k.k, pol_s.k),
                         (dv1_k, dv1_s), (dv2_k, dv2_s)):
        np.testing.assert_allclose(ours[ok_k].numpy(), theirs[ok_s].numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_final_value_matches_autodiff_bit_for_bit(case, dtype):
    """The fused backward's final value (``_final_klayout``, the env's
    closed form) equals ``get_quadratic_final_cost`` under ``vmap``
    (autodiff, as the JAX package's fused path takes it) bit for bit, in
    the kernel layout."""
    goal, zones = CASES[case]
    env = make_navigation(goal, zones, dtype=dtype, device="cpu")
    n = env.state_size
    x = torch.as_tensor(np.random.default_rng(11).uniform(-6, 6, (64, n)),
                        dtype=dtype)
    VT, vT = ilqr_batched._final_klayout(env, x)
    def final_fields(xi):
        f = env.get_quadratic_final_cost(xi)
        return f.l_x, f.l_xx

    l_x, l_xx = torch.func.vmap(final_fields)(x)
    assert VT.dtype == vT.dtype == dtype
    assert torch.equal(VT, l_xx.reshape(-1, n * n).T)
    assert torch.equal(vT, l_x.T)


def test_use_fused_derivs_routing():
    """The JAX package's rule on both devices: the configuration, then the
    split iteration for an env without a device linearization (HVAC) and
    above 12 dims; navigation fuses at every n <= 12 (K8 unrolled or
    generic, the backward on the lane kernels or K7). K8's argument
    preparation refuses what it cannot run."""
    _, nav = _envs("n2", False)
    fused = ilqr.ILQRConfig(use_pallas=True, fuse_derivatives=True)
    for device in ("cpu", "cuda"):
        assert ilqr_batched._use_fused_derivs(nav, fused, device)
        for off in (dict(use_pallas=False), dict(fuse_derivatives=False),
                    dict(parallel_backward=True), dict(ddp=True)):
            cfg = dataclasses.replace(fused, **off)
            assert not ilqr_batched._use_fused_derivs(nav, cfg, device)
    hvac = make_hvac([[0, 1], [1, 0]], is_out=[1, 0], is_hall=[0, 1],
                     dtype=torch.float64, device="cpu")
    nav4 = make_navigation([1.0, 2.0, 3.0, 4.0], None, dtype=torch.float64,
                           device="cpu")
    nav13 = make_navigation(list(range(13)), None, dtype=torch.float64,
                            device="cpu")
    for device in ("cpu", "cuda"):
        assert ilqr_batched._use_fused_derivs(nav4, fused, device)
        assert not ilqr_batched._use_fused_derivs(hvac, fused, device)
        assert not ilqr_batched._use_fused_derivs(nav13, fused, device)
    # K8's argument preparation refuses what it cannot run
    X = torch.zeros(4, 3, 13, dtype=torch.float64)
    U = torch.zeros(4, 2, 13, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="K8"):
        rollout.kernel_layout(nav13, X, U, Policy(
            K=torch.zeros(4, 2, 13, 13, dtype=torch.float64),
            k=torch.zeros(4, 2, 13, dtype=torch.float64)), derivatives=True)
    with pytest.raises(NotImplementedError, match="device derivatives"):
        rollout.kernel_layout(hvac, X[..., :2], U[..., :2], Policy(
            K=torch.zeros(4, 2, 2, 2, dtype=torch.float64),
            k=torch.zeros(4, 2, 2, dtype=torch.float64)), derivatives=True)
