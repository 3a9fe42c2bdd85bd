"""K1: the port's Riccati backward vs the JAX Pallas kernel, float64 on CPU.

``riccati_backward_ref`` (the plain PyTorch version of the CUDA kernel) is
held against ``tfmpc_tpu``'s ``riccati_backward_pallas``, run in Pallas
interpret mode on the CPU as ``tests/test_riccati_pallas.py`` runs it, on
the same linearizations (navigation along random nominals drawn with numpy
from a seed). Tolerance: 1e-9 relative and absolute. Both are float64; the
kernel unrolls its sums and its Cholesky while the plain version calls
batched matmul and LAPACK, which reorders the rounding of a T-step chain.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.core.types import (
    LinearModel as JLinearModel,
    QuadraticFinal as JQuadraticFinal,
    QuadraticModel as JQuadraticModel,
)
from tfmpc_tpu.ops.riccati_pallas import (
    _to_kernel_layout as jax_to_kernel_layout,
    riccati_backward_pallas,
)
from tfmpc_tpu_torch.core.types import (
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
)
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import riccati
from tfmpc_tpu_torch.solvers import ilqr

TOL = dict(rtol=1e-9, atol=1e-9)
B, T = 128, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linearization(seed, indefinite=()):
    """Navigation linearizations along random nominals, as numpy dicts of
    the three models' fields, plus per-lane mu. ``indefinite`` lanes get
    l_uu = -10 I and mu = 0, which makes their regularized Quu indefinite."""
    env = make_navigation([8.0, -5.0], {"center": [[3.0, -2.0]],
                                        "decay": [2.0]}, dtype=torch.float64,
                          device="cpu")
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(-5.0, 5.0, (B, 2)))
    U = torch.as_tensor(0.3 * rng.normal(size=(B, T, 2)))
    X, _ = env.rollout(x0, U)
    lin, quad, fin = env.analytic_derivatives(X, U)
    to_np = lambda m: {f: getattr(m, f).numpy().copy()  # noqa: E731
                       for f in m.__dataclass_fields__}
    lin, quad, fin = to_np(lin), to_np(quad), to_np(fin)
    mu = rng.uniform(0.0, 0.5, B)
    for lane in indefinite:
        quad["l_uu"][lane] = -10.0 * np.eye(2)
        mu[lane] = 0.0
    return lin, quad, fin, mu


def _torch_models(lin, quad, fin):
    t = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}  # noqa: E731
    return LinearModel(**t(lin)), QuadraticModel(**t(quad)), \
        QuadraticFinal(**t(fin))


def _jax_models(lin, quad, fin):
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return JLinearModel(**j(lin)), JQuadraticModel(**j(quad)), \
        JQuadraticFinal(**j(fin))


BAD = (3, 64, 127)


@pytest.mark.parametrize("indefinite", [(), BAD], ids=["pd", "indefinite"])
def test_ref_matches_jax_kernel(indefinite):
    lin, quad, fin, mu = _linearization(0, indefinite)
    ok_t, pol_t, dv1_t, dv2_t = riccati.riccati_backward_ref(
        *_torch_models(lin, quad, fin), torch.as_tensor(mu))
    ok_j, pol_j, dv1_j, dv2_j = riccati_backward_pallas(
        *_jax_models(lin, quad, fin), jnp.asarray(mu))
    ok_t = ok_t.numpy()
    np.testing.assert_array_equal(ok_t, np.asarray(ok_j))
    assert (~ok_t).sum() == len(indefinite)
    assert not ok_t[list(indefinite)].any()
    # failed lanes hold meaningless values on both sides
    np.testing.assert_allclose(pol_t.K.numpy()[ok_t], np.asarray(pol_j.K)[ok_t],
                               **TOL)
    np.testing.assert_allclose(pol_t.k.numpy()[ok_t], np.asarray(pol_j.k)[ok_t],
                               **TOL)
    np.testing.assert_allclose(dv1_t.numpy()[ok_t], np.asarray(dv1_j)[ok_t],
                               **TOL)
    np.testing.assert_allclose(dv2_t.numpy()[ok_t], np.asarray(dv2_j)[ok_t],
                               **TOL)


def test_single_scenario_backward_is_the_batched_one():
    """``ilqr.backward`` on one scenario equals row i of the batch (the
    plain version takes any leading dims)."""
    lin, quad, fin, mu = _linearization(1)
    models = _torch_models(lin, quad, fin)
    mu_t = torch.as_tensor(mu)
    cfg = ilqr.ILQRConfig()
    ok_b, pol_b, dv1_b, dv2_b = ilqr.backward(*models, mu_t, cfg)
    for i in (0, 77):
        row = [dataclasses.replace(m, **{f: getattr(m, f)[i]
                                         for f in m.__dataclass_fields__})
               for m in models]
        ok, pol, dv1, dv2 = ilqr.backward(*row, mu_t[i], cfg)
        assert bool(ok) and bool(ok_b[i])
        np.testing.assert_allclose(pol.K.numpy(), pol_b.K[i].numpy(), **TOL)
        np.testing.assert_allclose(pol.k.numpy(), pol_b.k[i].numpy(), **TOL)
        np.testing.assert_allclose(float(dv1), float(dv1_b[i]), **TOL)
        np.testing.assert_allclose(float(dv2), float(dv2_b[i]), **TOL)


def test_kernel_layout_matches_jax():
    lin, quad, fin, mu = _linearization(2)
    ours = riccati._to_kernel_layout(*_torch_models(lin, quad, fin),
                                     torch.as_tensor(mu))
    theirs, _ = jax_to_kernel_layout(*_jax_models(lin, quad, fin),
                                     jnp.asarray(mu))
    assert set(ours) == set(theirs)
    for key in ours:
        np.testing.assert_array_equal(
            ours[key].numpy(), np.asarray(theirs[key]).reshape(ours[key].shape),
            err_msg=key)


def test_wrapper_runs_plain_version_on_cpu_only():
    lin, quad, fin, mu = _linearization(3, BAD)
    models = _torch_models(lin, quad, fin)
    mu_t = torch.as_tensor(mu)
    launches, plain = riccati.LAUNCHES, riccati.PLAIN_CALLS
    ok, pol, dv1, dv2 = riccati.riccati_backward(*models, mu_t)
    assert (riccati.LAUNCHES, riccati.PLAIN_CALLS) == (launches, plain + 1)
    ok_r, pol_r, dv1_r, dv2_r = riccati.riccati_backward_ref(*models, mu_t)
    assert torch.equal(ok, ok_r)
    assert torch.equal(pol.K[ok], pol_r.K[ok])
    assert torch.equal(dv2[ok], dv2_r[ok])
    # the launcher itself never computes on the CPU
    args = riccati._to_kernel_layout(*models, mu_t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati.riccati_backward_kernel(
            *(args[k] for k in ("fx", "fu", "lx", "lu", "lxx", "luu", "lux",
                                "mu", "VT", "vT")))
    assert riccati.LAUNCHES == launches


# -- K4: the control-limited (boxQP) backward ---------------------------------
#
# ``riccati_backward_boxqp_ref`` (the plain version of K4) against the JAX
# package's vmapped scan ``ilqr.backward(..., ILQRConfig(boxqp=True),
# bounds, Ubar)``, the reference that tests/test_riccati_pallas.py::
# TestBoxQPKernelParity pins the JAX K4 kernel to, on HVAC-3 and reservoir-4
# in the setup of that test (clipped random nominals), float64. Tolerance
# 1e-8: the same float64 algorithm on both sides, whose boxQP line search
# only flips a candidate on a rounding difference near its 1e-12 margin,
# which these small, well-scaled problems stay clear of.

BOX_TOL = dict(rtol=1e-8, atol=1e-8)
BOX_B, BOX_T = 16, 8


def _bounded_setup(name, indefinite=()):
    from tfmpc_tpu.models.hvac import make_hvac as jax_make_hvac
    from tfmpc_tpu.models.reservoir import make_reservoir as jax_make_reservoir
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.reservoir import make_reservoir

    if name == "hvac":
        kw = dict(is_out=[1, 0, 1], is_hall=[0, 1, 0])
        adj = [[0, 1, 0], [1, 0, 1], [0, 1, 0]]
        jenv = jax_make_hvac(adj, **kw, dtype=jnp.float64)
        tenv = make_hvac(adj, **kw, dtype=torch.float64, device="cpu")
        lohi = (8.0, 18.0)
    else:
        jenv = jax_make_reservoir(4, dtype=jnp.float64)
        tenv = make_reservoir(4, dtype=torch.float64, device="cpu")
        lohi = (20.0, 95.0)
    rng = np.random.default_rng(11)
    n = tenv.state_size
    x0 = torch.as_tensor(rng.uniform(*lohi, size=(BOX_B, n)))
    U = tenv.clip(torch.as_tensor(rng.uniform(0.0, 4.0, (BOX_B, BOX_T, n))))
    X, _ = tenv.rollout(x0, U)
    lin, quad, fin = tenv.analytic_derivatives(X, U)
    to_np = lambda m: {f: getattr(m, f).numpy().copy()  # noqa: E731
                       for f in m.__dataclass_fields__}
    lin, quad, fin = to_np(lin), to_np(quad), to_np(fin)
    mu = rng.uniform(0.0, 0.5, BOX_B)
    for lane in indefinite:
        quad["l_uu"][lane] = -10.0 * np.eye(n)
        mu[lane] = 0.0
    return jenv, tenv, (lin, quad, fin), mu, U.numpy()


@pytest.mark.parametrize("name", ["hvac", "reservoir"])
@pytest.mark.parametrize("indefinite", [(), (2, 9)], ids=["pd", "indefinite"])
def test_boxqp_ref_matches_jax_scan_backward(name, indefinite):
    from tfmpc_tpu.solvers import ilqr as jilqr

    jenv, tenv, models, mu, U = _bounded_setup(name, indefinite)
    ok_t, pol_t, dv1_t, dv2_t = riccati.riccati_backward_boxqp_ref(
        *_torch_models(*models), torch.as_tensor(mu), tenv.bounds,
        torch.as_tensor(U))
    cfg = jilqr.ILQRConfig(boxqp=True)
    ok_j, pol_j, dv1_j, dv2_j = jax.jit(jax.vmap(
        lambda l, q, f, m, u: jilqr.backward(l, q, f, m, cfg,
                                             bounds=jenv.bounds, Ubar=u)))(
        *_jax_models(*models), jnp.asarray(mu), jnp.asarray(U))
    ok_t = ok_t.numpy()
    np.testing.assert_array_equal(ok_t, np.asarray(ok_j))
    assert (~ok_t).sum() == len(indefinite)
    for ours, theirs in ((pol_t.K, pol_j.K), (pol_t.k, pol_j.k),
                         (dv1_t, dv1_j), (dv2_t, dv2_j)):
        np.testing.assert_allclose(ours.numpy()[ok_t],
                                   np.asarray(theirs)[ok_t], **BOX_TOL)
    # the box is active somewhere, and clamped rows of K are exactly zero
    k, K = pol_t.k.numpy()[ok_t], pol_t.K.numpy()[ok_t]
    ubar = U[ok_t]
    lo = tenv.bounds.low.numpy() - ubar
    hi = tenv.bounds.high.numpy() - ubar
    at_bound = np.isclose(k, lo, rtol=0, atol=1e-12) \
        | np.isclose(k, hi, rtol=0, atol=1e-12)
    assert at_bound.any()
    assert (np.abs(K).sum(axis=-1)[at_bound] == 0.0).mean() > 0.5
    # ilqr.backward routes boxqp + bounds to the same plain version
    ok_b, pol_b, _, _ = ilqr.backward(
        *_torch_models(*models), torch.as_tensor(mu),
        ilqr.ILQRConfig(boxqp=True), tenv.bounds, torch.as_tensor(U))
    assert np.array_equal(ok_b.numpy(), ok_t)
    assert torch.equal(pol_b.k[ok_t], pol_t.k[ok_t])


def test_boxqp_kernel_layout_and_wrapper_on_cpu():
    """K4's kernel layout (ubar [T, m, B], lo/hi [m]) matches the JAX
    adapter's; on CPU tensors the wrapper runs the plain version, and the
    launcher refuses to compute."""
    from tfmpc_tpu.ops.riccati_pallas import (
        _to_kernel_layout as jax_layout,
    )

    jenv, tenv, models, mu, U = _bounded_setup("hvac", (3,))
    tmodels = _torch_models(*models)
    a = riccati._to_kernel_layout(*tmodels, torch.as_tensor(mu), tenv.bounds,
                                  torch.as_tensor(U))
    theirs, _ = jax_layout(*_jax_models(*models), jnp.asarray(mu))
    for key in theirs:
        np.testing.assert_array_equal(
            a[key].numpy(), np.asarray(theirs[key]).reshape(a[key].shape))
    np.testing.assert_array_equal(a["ubar"].numpy(), U.transpose(1, 2, 0))
    np.testing.assert_array_equal(a["lo"].numpy(), np.zeros(3))
    np.testing.assert_array_equal(a["hi"].numpy(), np.full(3, 10.0))
    assert set(riccati.K4_ARGS) == set(a)

    counts = (riccati.BOXQP_LAUNCHES, riccati.BOXQP_PLAIN_CALLS,
              riccati.LAUNCHES, riccati.PLAIN_CALLS)
    args = (*tmodels, torch.as_tensor(mu), tenv.bounds, torch.as_tensor(U))
    ok, pol, dv1, dv2 = riccati.riccati_backward_boxqp(*args)
    ok_r, pol_r, _, dv2_r = riccati.riccati_backward_boxqp_ref(*args)
    assert torch.equal(ok, ok_r) and not bool(ok[3])
    assert torch.equal(pol.K[ok], pol_r.K[ok])
    assert torch.equal(dv2[ok], dv2_r[ok])
    with pytest.raises(ValueError, match="CUDA tensors"):
        riccati.riccati_backward_boxqp_kernel(*(a[k] for k in
                                                riccati.K4_ARGS))
    assert (riccati.BOXQP_LAUNCHES, riccati.BOXQP_PLAIN_CALLS,
            riccati.LAUNCHES, riccati.PLAIN_CALLS) == (
        counts[0], counts[1] + 1, counts[2], counts[3])
    assert riccati.KERNEL_DIMS == {(2, 2), (3, 3), (5, 5), (6, 6)}


LANE_SOURCES = {"ilqr": "riccati.cu", "boxqp": "riccati_boxqp.cu",
                "ddp": "riccati_ddp.cu", "ddp_boxqp": "riccati_ddp_boxqp.cu"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("variant", sorted(riccati.VARIANTS))
def test_lane_plan_covers_each_scenario_once(variant, dtype):
    """``lane_plan`` at every lane dim and at batches that fill their last
    block or leave it ragged: the kernel's thread-to-scenario map (group
    ``tid // G`` of block ``blk``, lane ``tid % G``) gives every scenario
    each of its G lanes exactly once, and its copy map (scenario column
    ``tid % spb``, entries ``tid // spb``, ``+ G``, ...) stages every entry
    of every scenario of a block once; G is 1 or a power of two >= max(n,
    m), instantiated in the variant's source; a block fits the H100's
    threads and shared memory."""
    source = (Path(riccati.__file__).parent / "csrc"
              / LANE_SOURCES[variant]).read_text()
    box, ddp = riccati.VARIANTS[variant]
    for n in (2, 3, 5, 6):
        entries = (2 * n * n + n * n + 2 * n + 2 * n * n + (n if box else 0)
                   + (3 * n ** 3 if ddp else 0))
        for B in (1, 31, 2047, 2048, 4095, 4096):
            plan = riccati.lane_plan(variant, n, n, B, dtype)
            G, spb = plan.groups, plan.scenarios
            assert G == 1 or (G & (G - 1) == 0 and G >= n)
            assert f"NG<{n}, {G}>" in source
            assert plan.threads <= riccati.LANE_MAX_THREADS
            assert plan.smem_bytes <= riccati.SMEM_LIMIT
            assert plan.smem_bytes == riccati.lane_smem_bytes(
                variant, n, n, spb, dtype)
            tid = np.arange(plan.threads)
            blk = np.arange(plan.blocks(B))[:, None]
            b = blk * spb + tid // G
            lanes = np.zeros((B, G), dtype=int)
            np.add.at(lanes, (b[b < B], np.broadcast_to(tid % G, b.shape)[
                b < B]), 1)
            assert (lanes == 1).all(), (n, B)
            staged = np.zeros((B, entries), dtype=int)
            for ce in range(G):
                cols = tid[tid // spb == ce] % spb
                sc = blk * spb + cols
                for e in range(ce, entries, G):
                    np.add.at(staged[:, e], sc[sc < B], 1)
            assert (staged == 1).all(), (n, B)
