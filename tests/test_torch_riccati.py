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
                                        "decay": [2.0]}, dtype=torch.float64)
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
