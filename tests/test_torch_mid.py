"""Slice E (mid dims) of the port against the JAX package.

K7's wrappers (``tfmpc_tpu_torch/ops/riccati_mid.py``) on CPU tensors run
their plain versions; these are held against the JAX mid kernel in Pallas
interpret mode (as ``tests/test_riccati_mid.py`` runs it) and against the
JAX scan ``backward``, with identical ok masks and 1e-9 on the ok lanes in
float64 (the kernel clamps the Cholesky pivots where the scan lets NaN
propagate, so failed lanes are not compared). P1's plain version is held
against the JAX probe's row kernel. The routing rule is tested as a
function of (n, m, config, device), since no CUDA tensor exists on the CPU.
The slice as a whole: ``solve_batch`` on ``configs/hvac16.json`` through
the K7/K2/K3 wrappers against the JAX package's plain path, and the
compacted restarts at mid dims. Inputs are made with numpy from seeds.

Run as a script, ``python tests/test_torch_mid.py --e1-reference`` runs the
JAX package's ``solve_batch`` on the exact inputs of ``chip_smoke.py``'s E1
solve (suite config 3b: HVAC-16, B=512, T=50, float32, its plain XLA path,
on the CPU) and prints its converged fraction and mean cost.
"""

import dataclasses
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_riccati_mid import _synthetic
from tfmpc_tpu.core.types import Bounds as JBounds
from tfmpc_tpu.models.registry import load_env as jax_load_env
from tfmpc_tpu.ops.riccati_mid_pallas import (
    riccati_backward_mid as jax_riccati_backward_mid,
    riccati_backward_mid_boxqp as jax_riccati_backward_mid_boxqp,
)
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
)
from tfmpc_tpu_torch.models.registry import load_env
from tfmpc_tpu_torch.ops import riccati, riccati_mid
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

ROOT = Path(__file__).resolve().parents[1]
HVAC16 = ROOT / "configs" / "hvac16.json"
# E1's solve config (suite config 3b, benchmarks/suite.py:140-165)
E1 = dict(atol=1e-2, max_iterations=20, boxqp=True)
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_models(lin, quad, final):
    """JAX linearization records -> the port's, float64 on the CPU."""
    conv = lambda cls, m: cls(**{  # noqa: E731
        f.name: torch.as_tensor(np.array(getattr(m, f.name)))
        for f in dataclasses.fields(m)})
    return (conv(LinearModel, lin), conv(QuadraticModel, quad),
            conv(QuadraticFinal, final))


def _box(m, rng, B, T):
    """The JAX release gate's box +-0.4 and a nominal ~ 0.2 N(0, 1), in
    both packages' types."""
    lo, hi = np.full(m, -0.4), np.full(m, 0.4)
    Ubar = 0.2 * rng.standard_normal((B, T, m))
    return (JBounds(low=jnp.asarray(lo), high=jnp.asarray(hi)),
            jnp.asarray(Ubar),
            Bounds(low=torch.as_tensor(lo), high=torch.as_tensor(hi)),
            torch.as_tensor(Ubar))


def _assert_same_backward(ours, theirs):
    """Identical ok masks; K, k, dV1, dV2 within 1e-9 on the ok lanes."""
    ok_t, pol_t, dv1_t, dv2_t = ours
    ok_j, pol_j, dv1_j, dv2_j = theirs
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert ok.mean() > 0.5
    for got, want in ((pol_t.K, pol_j.K), (pol_t.k, pol_j.k),
                      (dv1_t, dv1_j), (dv2_t, dv2_j)):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                                   **TOL)


# -- K7's plain versions against the JAX mid kernel and scan ------------------

@pytest.mark.parametrize("boxqp", [False, True])
def test_mid_wrappers_match_jax_mid_kernel(boxqp):
    """(n, m) = (14, 13), B=128, T=3, four lanes forced indefinite (l_uu =
    -10 I, mu = 0): the wrapper on CPU tensors (the plain version) against
    the JAX mid kernel in interpret mode; boxQP with the release gate's box
    and 4 Newton iterations."""
    rng = np.random.default_rng(31)
    B, T, n, m = 128, 3, 14, 13
    lin, quad, final, mu = _synthetic(rng, B, T, n, m)
    bad = np.array([0, 5, 77, 127])
    l_uu = np.asarray(quad.l_uu).copy()
    l_uu[bad] = -10.0 * np.eye(m)
    quad = dataclasses.replace(quad, l_uu=jnp.asarray(l_uu))
    mu = mu.at[bad].set(0.0)
    tlin, tquad, tfinal = _torch_models(lin, quad, final)
    tmu = torch.as_tensor(np.asarray(mu))
    counts = (riccati_mid.MID_PLAIN_CALLS, riccati_mid.MID_BOXQP_PLAIN_CALLS)
    if boxqp:
        jb, jU, tb, tU = _box(m, rng, B, T)
        theirs = jax_riccati_backward_mid_boxqp(lin, quad, final, mu, jb, jU,
                                                boxqp_iters=4)
        ours = riccati_mid.riccati_backward_mid_boxqp(tlin, tquad, tfinal,
                                                      tmu, tb, tU,
                                                      boxqp_iters=4)
    else:
        theirs = jax_riccati_backward_mid(lin, quad, final, mu)
        ours = riccati_mid.riccati_backward_mid(tlin, tquad, tfinal, tmu)
    _assert_same_backward(ours, theirs)
    assert not bool(ours[0][torch.as_tensor(bad)].any())
    assert (riccati_mid.MID_PLAIN_CALLS, riccati_mid.MID_BOXQP_PLAIN_CALLS) \
        == (counts[0] + (not boxqp), counts[1] + boxqp)


@pytest.mark.parametrize("boxqp", [False, True])
@pytest.mark.parametrize("n,m", [(12, 12), (16, 16), (10, 9)])
def test_mid_plain_versions_match_jax_scan(n, m, boxqp):
    """The plain versions against the JAX scan ``backward`` (vmapped, XLA)
    at E2's and E1's dims and a rectangular pair, B=16, T=4; boxQP with 8
    Newton iterations (the default)."""
    rng = np.random.default_rng(100 * n + m)
    B, T = 16, 4
    lin, quad, final, mu = _synthetic(rng, B, T, n, m)
    tlin, tquad, tfinal = _torch_models(lin, quad, final)
    tmu = torch.as_tensor(np.asarray(mu))
    cfg = jilqr.ILQRConfig(boxqp=boxqp)
    if boxqp:
        jb, jU, tb, tU = _box(m, rng, B, T)
        theirs = jax.vmap(lambda l, q, f, mv, u: jilqr.backward(
            l, q, f, mv, cfg, bounds=jb, Ubar=u))(lin, quad, final, mu, jU)
        ours = riccati_mid.riccati_backward_mid_boxqp_ref(
            tlin, tquad, tfinal, tmu, tb, tU)
    else:
        theirs = jax.vmap(lambda l, q, f, mv: jilqr.backward(
            l, q, f, mv, cfg))(lin, quad, final, mu)
        ours = riccati_mid.riccati_backward_mid_ref(tlin, tquad, tfinal, tmu)
    _assert_same_backward(ours, theirs)


def test_mid_launchers_refuse_cpu_tensors_and_big_dims():
    """The raw launchers take only CUDA tensors (checked before any build),
    and the envelope is 1 <= n, m <= 48."""
    rng = np.random.default_rng(3)
    lin, quad, final, mu = _synthetic(rng, 2, 2, 14, 13)
    tlin, tquad, tfinal = _torch_models(lin, quad, final)
    a = riccati_mid.mid_layout(tlin, tquad, tfinal,
                               torch.as_tensor(np.asarray(mu)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati_mid.riccati_backward_mid_kernel(
            *(a[k] for k in riccati_mid.MID_ARGS))
    assert riccati_mid.mid_kernel_supported(1, 1)
    assert riccati_mid.mid_kernel_supported(48, 13)
    assert not riccati_mid.mid_kernel_supported(49, 49)
    assert not riccati_mid.mid_kernel_supported(0, 3)


@pytest.mark.parametrize("n", [12, 16])
def test_rollout_kernels_take_the_hvac_step_at_mid_dims(n):
    """K2/K3/K5 are instantiated unrolled at n = m = 12 and 16 for the HVAC
    step alone; every other env of those dims takes the generic form: the
    kernel layout builds for each of the four envs, and the plan is the
    unrolled one for HVAC and the generic one for the rest."""
    from tfmpc_tpu_torch.core.types import Policy
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.linear import make_linear_system
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.reservoir import make_reservoir
    from tfmpc_tpu_torch.ops import rollout

    adj = [[1 if abs(i - j) in (1, n - 1) else 0 for j in range(n)]
           for i in range(n)]
    hvac = load_env(HVAC16, dtype=torch.float64, device="cpu") if n == 16 \
        else make_hvac(adj, dtype=torch.float64, device="cpu")
    envs = {
        "hvac": hvac,
        "reservoir": make_reservoir(n, dtype=torch.float64, device="cpu"),
        "navigation": make_navigation([1.0] * n, {"center": [[0.0] * n],
                                                  "decay": [2.0]},
                                      dtype=torch.float64, device="cpu"),
        "linear": make_linear_system(np.eye(n), np.eye(n),
                                     dtype=torch.float64, device="cpu"),
    }
    for name, env in envs.items():
        U = torch.zeros(2, 3, n, dtype=torch.float64)
        X, _ = env.rollout(torch.full((2, n), 15.0, dtype=torch.float64), U)
        policy = Policy(K=torch.zeros(2, 3, n, n, dtype=torch.float64),
                        k=torch.zeros(2, 3, n, dtype=torch.float64))
        a = rollout.kernel_layout(env, X, U, policy)
        assert a["dims"] == (2, 3, n, n)
        pe = sum(p.numel() for p in a["params"])
        for kernel in ("costs", "alpha", "traj"):
            plan = rollout.rollout_plan(kernel, a["env_id"], n, n, 512, 11,
                                        torch.float32, pe)
            assert plan.generic == (name != "hvac"), (name, kernel)


# -- P1 -----------------------------------------------------------------------

def _mxu_probe():
    """``benchmarks/mxu_probe.py``, imported with ``benchmarks/`` on
    sys.path as its ``_bootstrap`` expects; the JAX settings and the warning
    filter that ``_bootstrap`` installs are put back afterwards."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    bench = str(ROOT / "benchmarks")
    sys.path.insert(0, bench)
    try:
        with warnings.catch_warnings():
            import mxu_probe
    finally:
        sys.path.remove(bench)
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
    return mxu_probe


@pytest.mark.parametrize("d", [16, 48])
def test_row_matmul_ref_matches_jax_probe(d):
    """P1's wrapper on CPU tensors (its plain version) against the JAX
    probe's row kernel in interpret mode, B=128, float64."""
    probe = _mxu_probe()
    rng = np.random.default_rng(d)
    A = rng.standard_normal((d * d, 128))
    M = rng.standard_normal((d * d, 128))
    want = np.asarray(probe._row_kernel_matmul(jnp.asarray(A),
                                               jnp.asarray(M), d=d))
    calls = riccati_mid.ROW_MATMUL_PLAIN_CALLS
    got = riccati_mid.row_matmul(torch.as_tensor(A), torch.as_tensor(M), d)
    assert riccati_mid.ROW_MATMUL_PLAIN_CALLS == calls + 1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # and against C[b] = A[b] M[b] in the solver's [B, d, d] layout
    Ab = A.T.reshape(128, d, d)
    Mb = M.T.reshape(128, d, d)
    np.testing.assert_allclose(got.numpy().T.reshape(128, d, d), Ab @ Mb,
                               rtol=1e-12, atol=1e-12)


# -- the launch plans ---------------------------------------------------------------

PLAN_BATCHES = (1, 2, 31, 33, 128, 130, 512)


def test_mid_plan_fits_and_covers_each_scenario_once():
    """K7's plan at every (n, m) and both dtypes: the block's shared memory
    fits ``SMEM_LIMIT``, its threads are whole warps, at most 1024, and
    under the kernel's warp-to-team map (warp w of a block is warp w //
    scenarios of team w % scenarios, which takes scenario block *
    scenarios + w % scenarios; teams past the batch return) every scenario
    gets each of its team's warps exactly once, ragged batches of the
    compacted restarts included."""
    for dtype in (torch.float32, torch.float64):
        for n in range(1, riccati_mid.MID_DIM_MAX + 1):
            for m in range(1, riccati_mid.MID_DIM_MAX + 1):
                for B in PLAN_BATCHES:
                    plan = riccati_mid.mid_plan(n, m, B, dtype)
                    assert plan.smem_bytes <= riccati_mid.SMEM_LIMIT
                    assert plan.smem_bytes == plan.scenarios * \
                        riccati_mid.mid_scenario_bytes(n, m, dtype,
                                                       plan.stage_l)
                    assert plan.threads % 32 == 0 and plan.threads <= 1024
                    assert plan.warps == riccati_mid.mid_warps(n, m, B)
                    warp = np.arange(plan.threads // 32)
                    blocks = np.arange(plan.blocks(B))[:, None]
                    b = (blocks * plan.scenarios
                         + warp % plan.scenarios).ravel()
                    rank = np.broadcast_to(warp // plan.scenarios,
                                           (blocks.size, warp.size)).ravel()
                    cover = np.zeros((B, plan.warps), dtype=int)
                    np.add.at(cover, (b[b < B], rank[b < B]), 1)
                    assert (cover == 1).all(), (n, m, B, dtype, plan)


def test_mid_plan_shared_bytes_and_staging():
    """The per-scenario sums the kernel's source note states, and the l
    blocks left in place only where staging them would not fit."""
    f32, f64 = torch.float32, torch.float64
    assert riccati_mid.mid_scenario_bytes(16, 16, f32) == 26064
    assert riccati_mid.mid_scenario_bytes(48, 48, f64, stage_l=False) \
        == 198288
    assert not riccati_mid.mid_plan(48, 48, 128, f64).stage_l
    assert riccati_mid.mid_plan(48, 48, 128, f32).stage_l
    assert riccati_mid.mid_plan(16, 16, 512, f32).stage_l
    # a small batch spreads over the SMs; a large one packs teams, with
    # fewer warps each where an SM would not hold them in one wave
    assert riccati_mid.mid_plan(16, 16, 128, f32).scenarios == 1
    p512 = riccati_mid.mid_plan(16, 16, 512, f32)
    assert (p512.scenarios, p512.warps) == (4, 2)
    p1024 = riccati_mid.mid_plan(12, 12, 1024, f32)
    assert (p1024.scenarios, p1024.warps) == (4, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", range(1, riccati_mid.MID_DIM_MAX + 1))
def test_row_plan_covers_each_entry_once(d, dtype):
    """P1's plan (and every instantiated plan that fits at d): whole warps,
    within the kernel's thread bound and the shared-memory limit, and the
    threads store each (entry, scenario) of C exactly once, B = 1, 33 (a
    ragged last block) and 1024."""
    plans = [riccati_mid.row_plan(d, dtype)]
    for tile in riccati_mid.ROW_TILES:
        try:
            plans.append(riccati_mid.row_plan(d, dtype, tile))
        except ValueError:
            plan = riccati_mid.RowPlan(*tile, plans[0].scenarios)
            assert plan.threads(d) > plan.max_threads or \
                plan.smem_bytes(d, dtype) > riccati_mid.SMEM_LIMIT
    for plan in plans:
        assert plan.threads(d) % 32 == 0
        assert plan.threads(d) <= plan.max_threads <= 1024
        assert plan.smem_bytes(d, dtype) <= riccati_mid.SMEM_LIMIT
        for B in (1, 33, 1024):
            cover = riccati_mid.row_matmul_cover(plan, d, B)
            assert cover.shape == (d * d, B)
            assert (cover == 1).all(), (plan, B)


# -- the routing rule -------------------------------------------------------------

def test_kernel_mode_routes_lane_mid_and_raises():
    mode = ilqr_batched._riccati_kernel_mode
    cfg = ilqr.ILQRConfig(use_pallas=True, boxqp=True)
    ddp = dataclasses.replace(cfg, ddp=True)
    for dims in sorted(riccati.KERNEL_DIMS):
        assert mode(*dims, cfg, "cuda") == "lane"
        assert mode(*dims, ddp, "cuda") == "lane"
    # boxQP at n, m <= 12 without a lane instantiation: the small-dims
    # kernel (K4's and K6b's, ops/riccati_small.py), on every device; above
    # 12, K7
    for dims in ((12, 12), (4, 4), (2, 1)):
        assert mode(*dims, cfg, "cuda") == "small"
        assert mode(*dims, cfg, "cpu") == "small"
    for dims in ((16, 16), (14, 13), (48, 48)):
        assert mode(*dims, cfg, "cuda") == "mid"
        assert mode(*dims, cfg, "cpu") == "mid"
    # without boxQP those dims run the small-dims kernel's K1, above 12
    # K7's iLQR variant
    ilqr_cfg = dataclasses.replace(cfg, boxqp=False)
    for dims in ((12, 12), (4, 4), (2, 1)):
        assert mode(*dims, ilqr_cfg, "cuda") == "small"
    assert mode(16, 16, ilqr_cfg, "cuda") == "mid"
    # full DDP at n, m <= 12 without a lane instantiation, where the JAX
    # lane kernel runs it: the small-dims kernel's K6b with boxQP and its
    # K6a without, on every device
    for dims in ((12, 12), (4, 4), (7, 3), (2, 1), (1, 12)):
        assert mode(*dims, ddp, "cuda") == "small"
        assert mode(*dims, ddp, "cpu") == "small"
        assert mode(*dims, dataclasses.replace(ddp, boxqp=False),
                    "cuda") == "small"
    # where the JAX package runs its vmapped scan by design (DDP above 12,
    # any dims above 48), the plain backward runs on the card too
    assert mode(16, 16, ddp, "cuda") is None
    assert mode(13, 2, ddp, "cuda") is None
    assert mode(49, 49, cfg, "cuda") is None
    # on the CPU those run the plain backward
    assert mode(16, 16, ddp, "cpu") is None
    assert mode(49, 49, cfg, "cpu") is None
    # no kernel without use_pallas, and the parallel backward owns it
    assert mode(16, 16, dataclasses.replace(cfg, use_pallas=False),
                "cuda") is None
    assert mode(16, 16, dataclasses.replace(cfg, parallel_backward=True),
                "cuda") is None


# -- the slice as a whole -------------------------------------------------------

def _x0(B, seed=0):
    return np.random.default_rng(seed).uniform(8.0, 18.0, (B, 16))


@pytest.mark.parametrize("B", [4, 130])
def test_hvac16_solve_batch_matches_jax(B):
    """``solve_batch`` on HVAC-16 (E1's config, T=10, float64), through the
    K7-boxQP, K2 and K3 wrappers on CPU tensors, against the JAX package's
    plain path: the same controls within 1e-6, converged and failed masks
    and iteration counts. B=130 > 128 puts any restart through the
    compacted loop."""
    T = 10
    jenv = jax_load_env(str(HVAC16), dtype=jnp.float64)
    tenv = load_env(HVAC16, dtype=torch.float64, device="cpu")
    x0 = _x0(B)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**E1))
    counts = (riccati_mid.MID_BOXQP_PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**E1, use_pallas=True))
    assert riccati_mid.MID_BOXQP_PLAIN_CALLS > counts[0]
    assert riccati.BOXQP_PLAIN_CALLS == counts[1]
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-6)
    for f in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


def test_compacted_restarts_gather_at_mid_dims():
    """B=130 > 128 on HVAC-16's linearization with the boxQP, five lanes
    forced indefinite (l_uu = -4 I, mu = 0): the compacted restart loop
    (which gathers the failing lanes' rows, ``Ubar``'s too, into K7's
    wrapper) gives every lane the full-batch loop's ok, mu, delta and
    gains."""
    tenv = load_env(HVAC16, dtype=torch.float64, device="cpu")
    B, T = 130, 6
    rng = np.random.default_rng(11)
    U = tenv.clip(torch.as_tensor(rng.uniform(0.0, 4.0, (B, T, 16))))
    X, _ = tenv.rollout(torch.as_tensor(_x0(B, 1)), U)
    lin, quad, fin = ilqr.derivatives(tenv, X, U)
    bad = [0, 7, 64, 128, 129]
    l_uu = quad.l_uu.clone()
    l_uu[bad] = -4.0 * torch.eye(16, dtype=torch.float64)
    quad = dataclasses.replace(quad, l_uu=l_uu)
    mu = torch.zeros(B, dtype=torch.float64)
    delta = torch.ones(B, dtype=torch.float64)
    cfg = ilqr.ILQRConfig(use_pallas=True, boxqp=True)
    calls = riccati_mid.MID_BOXQP_PLAIN_CALLS
    ok_c, pol_c, dv1_c, dv2_c, mu_c, delta_c = \
        ilqr_batched._backward_restarts_batched(lin, quad, fin, mu, delta,
                                                cfg, tenv.bounds, U)
    rounds = riccati_mid.MID_BOXQP_PLAIN_CALLS - calls
    assert rounds > 1                           # restarts ran through K7's
    assert bool((mu_c[bad] > 0).all()) and bool(ok_c.all())
    ok_f, pol_f, dv1_f, dv2_f, mu_f, delta_f = ilqr_batched._restart_loop(
        lambda mu_: ilqr_batched._backward_batched(
            lin, quad, fin, mu_, cfg, tenv.bounds, U), mu, delta, cfg)
    assert torch.equal(ok_c, ok_f)
    assert torch.equal(mu_c, mu_f) and torch.equal(delta_c, delta_f)
    for got, want in ((pol_c.K, pol_f.K), (pol_c.k, pol_f.k), (dv1_c, dv1_f),
                      (dv2_c, dv2_f)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)


def _e1_reference():
    """The JAX package's E1 solve on the CPU (float32, XLA path): prints its
    converged and failed fractions and mean total cost."""
    jax.config.update("jax_platforms", "cpu")
    env = jax_load_env(str(HVAC16))
    x0 = jnp.asarray(np.random.default_rng(0).uniform(
        8, 18, size=(512, 16)).astype("f4"))
    res = jilqr.solve_batch(env, x0, horizon=50,
                            config=jilqr.ILQRConfig(**E1))
    print(f"JAX solve_batch, HVAC-16 B=512 T=50 f32, XLA path, CPU: "
          f"converged {float(jnp.mean(res.converged)):.6f}, failed "
          f"{float(jnp.mean(res.failed)):.6f}, mean iterations "
          f"{float(jnp.mean(res.iterations)):.3f}, mean total cost "
          f"{float(jnp.mean(res.total_cost.astype(jnp.float64))):.6f}")


if __name__ == "__main__" and "--e1-reference" in sys.argv:
    _e1_reference()
