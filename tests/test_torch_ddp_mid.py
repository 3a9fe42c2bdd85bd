"""Full DDP at every n, m <= 12 outside the lane kernels' dims: K7's
full-DDP variant and the small-dims kernel's K6b, against their plain
versions and the JAX package.

The JAX lane kernel runs full DDP at any n, m <= 12; the port runs it at
those dims on K7's full-DDP variant (``riccati_mid.riccati_backward_mid_ddp``)
and, with boxQP, on the small-dims kernel
(``riccati_small.riccati_backward_small_ddp_boxqp``), whose plain versions
are K6a's and K6b's (``riccati.riccati_backward_ddp_ref``, ``_boxqp_ref``).
No CUDA tensor exists on the CPU, so here the wrappers run their plain
versions (counted), and the launch plan is checked as arithmetic.

- The wrappers at (4, 4), (12, 12), (7, 3) and (2, 1), on synthetic
  Hessians (f_uu != 0) from a numpy seed: the plain version's outputs bit
  for bit, one plain call each, no launch; the raw launchers refuse CPU
  tensors.
- ``solve_batch(ddp=True, use_pallas=True)`` in float64 against the JAX
  package's ``solve_batch`` with the same config: reservoir-4 with boxQP
  and the 12-room HVAC ring with boxQP against its XLA route
  (``use_pallas=False``: its interpret-mode kernels at B padded to 128 take
  minutes on the CPU), the double integrator against its lane kernel in
  interpret mode; the boxQP solves' backward goes through the small-dims
  K6b wrapper, the double integrator's through its K6a (K7's DDP variant
  until the small-dims kernel had one), none through K7's. Identical
  converged and failed masks and iteration
  counts, actions within 1e-6 and costs within 1e-9 (the tolerances of
  ``tests/test_torch_ddp.py``'s solves).
- K7's plan at every n, m <= 12, both dtypes, fits a block: the DDP
  variants stream the Hessians from global memory, so their shared bytes
  are the iLQR variant's.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.ops import riccati, riccati_mid, riccati_small
from tfmpc_tpu_torch.solvers import ilqr

ROOT = Path(__file__).resolve().parents[1]
B, T = 64, 5
# the synthetic Hessians' scale: 76-99% of the lanes pass the PD probe
SCALE = {(4, 4): 0.05, (12, 12): 0.03, (7, 3): 0.05, (2, 1): 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _synthetic(n, m, seed):
    """A well-posed random linearization at (n, m) (stable dynamics, PSD
    costs; lane 0 forced indefinite), seeded random Hessians, per-lane mu
    (half 0), the box +-0.4 and a nominal control, float64."""
    rng = np.random.default_rng(seed)
    t = torch.as_tensor

    def psd(k, lead):
        a = 0.3 * rng.standard_normal(lead + (k, k))
        return t(np.einsum("...ij,...kj->...ik", a, a) + 0.5 * np.eye(k))

    lin = LinearModel(
        f=t(np.zeros((B, T, n))),
        f_x=t(0.9 * np.eye(n) + 0.1 * rng.standard_normal((B, T, n, n))),
        f_u=t(0.3 * rng.standard_normal((B, T, n, m))))
    quad = QuadraticModel(
        l=t(np.zeros((B, T))), l_x=t(rng.standard_normal((B, T, n))),
        l_u=t(rng.standard_normal((B, T, m))), l_xx=psd(n, (B, T)),
        l_uu=psd(m, (B, T)), l_ux=t(0.1 * rng.standard_normal((B, T, m, n))))
    final = QuadraticFinal(l=t(np.zeros(B)), l_x=t(rng.standard_normal((B, n))),
                           l_xx=psd(n, (B,)))
    c = SCALE[(n, m)]
    sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))  # noqa: E731
    second = SecondOrderModel(
        f_xx=t(sym(c * rng.standard_normal((B, T, n, n, n)))),
        f_ux=t(c * rng.standard_normal((B, T, n, m, n))),
        f_uu=t(sym(c * rng.standard_normal((B, T, n, m, m)))))
    mu = t(np.where(rng.uniform(size=B) < 0.5, 0.0, rng.uniform(0, 0.3, B)))
    # lane 0 forced indefinite: l_uu = -100 I and mu = 0
    quad.l_uu[0] = -100.0 * torch.eye(m, dtype=torch.float64)
    mu[0] = 0.0
    bounds = Bounds(low=t(np.full(m, -0.4)), high=t(np.full(m, 0.4)))
    return lin, quad, final, mu, bounds, t(0.2 * rng.standard_normal(
        (B, T, m))), second


def _counts():
    return (riccati_mid.MID_DDP_PLAIN_CALLS,
            riccati_small.SMALL_DDP_BOXQP_PLAIN_CALLS,
            riccati_mid.MID_DDP_LAUNCHES,
            riccati_small.SMALL_DDP_BOXQP_LAUNCHES)


@pytest.mark.parametrize("boxqp", [False, True], ids=["ddp", "ddp_boxqp"])
@pytest.mark.parametrize("dims", sorted(SCALE), ids=str)
def test_mid_ddp_wrappers_run_plain_versions_on_cpu(dims, boxqp):
    """On CPU tensors the wrapper is its plain version, bit for bit, with
    one plain call counted and no launch; the forced-indefinite lane
    fails the PD probe and most lanes pass; the DDP terms change the
    gains; the raw launcher refuses CPU tensors."""
    n, m = dims
    lin, quad, final, mu, bounds, U, second = _synthetic(n, m, 10 * n + m)
    before = _counts()
    if boxqp:
        got = riccati_small.riccati_backward_small_ddp_boxqp(
            lin, quad, final, mu, bounds, U, second, 4)
        want = riccati.riccati_backward_ddp_boxqp_ref(
            lin, quad, final, mu, bounds, U, second, 4)
        keys = riccati_small.SMALL_DDP_BOXQP_ARGS
        launcher = riccati_small.riccati_backward_small_ddp_boxqp_kernel
        a = riccati_mid.mid_layout(lin, quad, final, mu, bounds, U, second)
    else:
        got = riccati_mid.riccati_backward_mid_ddp(lin, quad, final, mu,
                                                   second)
        want = riccati.riccati_backward_ddp_ref(lin, quad, final, mu, second)
        keys = riccati_mid.MID_DDP_ARGS
        launcher = riccati_mid.riccati_backward_mid_ddp_kernel
        a = riccati_mid.mid_layout(lin, quad, final, mu, second=second)
    assert [x - y for x, y in zip(_counts(), before)] == \
        ([0, 1, 0, 0] if boxqp else [1, 0, 0, 0])
    ok = got[0]
    assert torch.equal(ok, want[0])
    assert not bool(ok[0]) and float(ok.double().mean()) >= 0.5
    for x, y in ((got[1].K, want[1].K), (got[1].k, want[1].k),
                 (got[2], want[2]), (got[3], want[3])):
        assert torch.equal(x[ok], y[ok])
    # the DDP terms change the gains against K7's iLQR/boxQP plain version
    plain = (riccati.riccati_backward_boxqp_ref(lin, quad, final, mu, bounds,
                                                U, 4) if boxqp else
             riccati.riccati_backward_ref(lin, quad, final, mu))
    both = ok & plain[0]
    assert not torch.allclose(got[1].k[both], plain[1].k[both])
    assert set(keys) == set(a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(*(a[k] for k in keys))
    assert _counts()[2:] == before[2:]


def _ring(R):
    adj = [[1 if abs(i - j) in (1, R - 1) else 0 for j in range(R)]
           for i in range(R)]
    return dict(name="hvac", adj=adj,
                is_out=[1 if i % 4 == 0 else 0 for i in range(R)],
                is_hall=[1 if i % 4 == 2 else 0 for i in range(R)])


def _reservoir4():
    cfg = json.loads((ROOT / "configs" / "reservoir.json").read_text())
    cfg.update(n_reservoirs=4)
    cfg.pop("x0")
    return cfg


DOUBLE_INTEGRATOR = dict(name="linear", A=[[1.0, 0.1], [0.0, 1.0]],
                         B=[[0.005], [0.1]], Q=[[1.0, 0.0], [0.0, 0.1]],
                         R=[[0.01]])
# label -> (env config, x0 range, B, T, ILQRConfig kwargs, JAX use_pallas)
SOLVES = {
    "reservoir4_boxqp": (_reservoir4(), (20.0, 95.0), 6, 10,
                         dict(atol=1e-3, max_iterations=30, boxqp=True),
                         False),
    "hvac12_ring_boxqp": (_ring(12), (8.0, 18.0), 4, 6,
                          dict(atol=1e-3, max_iterations=30, boxqp=True),
                          False),
    "double_integrator": (DOUBLE_INTEGRATOR, (-3.0, 3.0), 6, 12,
                          dict(atol=1e-10, max_iterations=20), True),
}


@pytest.mark.parametrize("label", list(SOLVES))
def test_ddp_solve_batch_at_mid_dims_matches_jax(label):
    """``solve_batch(ddp=True, use_pallas=True)`` in float64 at dims without
    a lane instantiation: the backward goes through the small-dims K6b
    wrapper with boxQP and its K6a wrapper without (their plain versions
    on the CPU), never K7's or the lane kernels', and the solve matches the
    JAX package's with the same config."""
    cfg, lohi, Bs, Ts, kw, jax_pallas = SOLVES[label]
    tenv = make_env(cfg, dtype=torch.float64, device="cpu")
    n, m = tenv.state_size, tenv.action_size
    assert (n, m) not in riccati.KERNEL_DIMS
    x0 = np.random.default_rng(0).uniform(*lohi, (Bs, n))
    jenv = jax_make_env(cfg, dtype=jnp.float64)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=Ts,
                              config=jilqr.ILQRConfig(**kw, ddp=True,
                                                      use_pallas=jax_pallas))
    others = (riccati.DDP_PLAIN_CALLS, riccati.DDP_BOXQP_PLAIN_CALLS,
              riccati_mid.MID_DDP_PLAIN_CALLS)
    counts = lambda: (riccati_small.SMALL_DDP_PLAIN_CALLS,  # noqa: E731
                      riccati_small.SMALL_DDP_BOXQP_PLAIN_CALLS)
    before = counts()
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=Ts,
                             config=ilqr.ILQRConfig(**kw, ddp=True,
                                                    use_pallas=True))
    calls = [x - y for x, y in zip(counts(), before)]
    boxqp = kw.get("boxqp", False) and tenv.bounds is not None
    assert calls[1 if boxqp else 0] > 0 and calls[0 if boxqp else 1] == 0
    assert (riccati.DDP_PLAIN_CALLS, riccati.DDP_BOXQP_PLAIN_CALLS,
            riccati_mid.MID_DDP_PLAIN_CALLS) == others
    for f in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    assert bool(res_t.converged.all())
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_mid_ddp_plan_fits_every_dim(dtype):
    """K7's plan at every 1 <= n, m <= ``MID_DDP_DIM_MAX`` and batches of 1,
    1023 and 4096 fits a block's threads and shared memory (the DDP
    variants launch with it: the Hessians are not staged), with the l
    blocks staged, and its teams cover the batch."""
    top = riccati_mid.MID_DDP_DIM_MAX
    assert top == 12
    for n in range(1, top + 1):
        for m in range(1, top + 1):
            for Bb in (1, 1023, 4096):
                plan = riccati_mid.mid_plan(n, m, Bb, dtype)
                assert plan.stage_l
                assert plan.threads <= riccati_mid.MID_MAX_THREADS
                assert plan.smem_bytes == plan.scenarios * \
                    riccati_mid.mid_scenario_bytes(n, m, dtype)
                assert plan.smem_bytes <= riccati_mid.SMEM_LIMIT
                assert plan.blocks(Bb) * plan.scenarios >= Bb
