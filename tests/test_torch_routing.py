"""Where the JAX package runs its XLA route by design, the port runs plain
PyTorch on every device, the card included: the Riccati backward of full
DDP at max(n, m) > 12 and every stage at max(n, m) > 48. Where the JAX
package has a kernel, so has the port: full DDP at n, m <= 12 outside the
lane kernels' dims runs K7's full-DDP variants, and the rollout kernels
take every dim up to 48, in the generic form where no unrolled
instantiation runs.

No CUDA tensor exists on the CPU, so the rules are tested as functions of
the dims, the config and the device; the solves run on CPU tensors, where
the wrappers run their plain versions. The HVAC-16 DDP solve is held
against the JAX package's (its vmapped scan and XLA rollout) in float64.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.registry import load_env as jax_load_env
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.models.base import Env
from tfmpc_tpu_torch.models.linear import make_linear_system
from tfmpc_tpu_torch.models.registry import load_env
from tfmpc_tpu_torch.ops import riccati, riccati_mid, rollout
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

ROOT = Path(__file__).resolve().parents[1]
HVAC16 = ROOT / "configs" / "hvac16.json"
E1_DDP = dict(atol=1e-2, max_iterations=20, boxqp=True, ddp=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _linear(n, m, dtype=torch.float64):
    rng = np.random.default_rng(n * 100 + m)
    A = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    B = 0.1 * rng.standard_normal((n, m))
    return make_linear_system(A, B, dtype=dtype, device="cpu")


class _NoStep(Env):
    """An env that opts out of the rollout kernels (``device_step()``
    returns None, the JAX package's ``lane_functions() -> None``), at any
    dims."""

    def __init__(self, n):
        self.n = n

    @property
    def state_size(self):
        return self.n

    def device_step(self):
        return None


class _Chain(Env):
    """A user env with only the public step (``device_step()`` is its
    generated step)."""

    def __init__(self, n):
        self.C = 0.3 * torch.eye(n, dtype=torch.float64)

    @property
    def state_size(self):
        return self.C.shape[0]

    def transition(self, x, u):
        return x + 0.1 * (x @ self.C.T - 0.02 * x**3 + u)

    def cost(self, x, u):
        return (x * x).sum(-1) + 0.1 * (u * u).sum(-1)

    def final_cost(self, x):
        return 5.0 * (x * x).sum(-1)


def test_rollout_rule_at_the_dim_ceiling():
    cfg = ilqr.ILQRConfig(use_pallas=True)
    use = ilqr_batched._use_pallas_rollout
    assert ilqr_batched._rollout_dims_supported(48, 48)
    assert not ilqr_batched._rollout_dims_supported(49, 49)
    assert not ilqr_batched._rollout_dims_supported(2, 49)
    # past 48 the plain rollout runs on the card, as the JAX package's
    # XLA rollout does, even for an env without a device step
    assert use(_linear(49, 49), cfg, "cuda") is False
    assert use(_NoStep(49), cfg, "cuda") is False
    # at or below it the kernels' wrappers take the line search
    assert use(_linear(48, 48), cfg, "cuda") is True
    assert use(_linear(2, 2), cfg, "cpu") is True
    assert use(_linear(2, 2), dataclasses.replace(cfg, use_pallas=False),
               "cuda") is False
    # below it an env that opts out keeps the plain rollout on the card
    # too, and a user env takes the kernels on its generated step
    assert use(_NoStep(6), cfg, "cuda") is False
    assert use(_NoStep(6), cfg, "cpu") is False
    assert use(_Chain(6), cfg, "cuda") is True


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_device_step_none_takes_the_plain_rollout_on_every_device(device):
    """The JAX package's documented opt-out, ``lane_functions() -> None``,
    sends an env to its XLA rollout on every backend. The port's
    ``device_step() -> None`` raised on CUDA with ``use_pallas=True``; it
    now keeps the plain rollout there too (``_use_pallas_rollout``, and the
    split iteration in ``_use_fused_derivs``), while a direct
    ``kernel_layout`` call still raises, naming the opt-out."""
    cfg = ilqr.ILQRConfig(use_pallas=True)
    fused = dataclasses.replace(cfg, fuse_derivatives=True)
    env = _NoStep(6)
    assert ilqr_batched._use_pallas_rollout(env, cfg, device) is False
    assert ilqr_batched._use_fused_derivs(env, fused, device) is False
    chain = _Chain(3)
    X = torch.zeros(2, 4, 3, dtype=torch.float64)
    U = torch.zeros(2, 3, 3, dtype=torch.float64)
    policy = ilqr.backward(*ilqr.derivatives(chain, X, U),
                           torch.zeros(2, dtype=torch.float64), cfg)[1]
    with pytest.raises(NotImplementedError, match="device_step"):
        rollout.kernel_layout(env, X, U, policy)
    a = rollout.kernel_layout(chain, X, U, policy)
    assert a["env_id"] == rollout.USER_STEP_ID and "UserStep" in a["source"]


def _env_at(kind, n, dtype=torch.float64):
    """An env of ``kind`` (with a device step) at n states and controls."""
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.reservoir import make_reservoir

    if kind == "linear":
        return _linear(n, n, dtype)
    if kind == "reservoir":
        return make_reservoir(n, dtype=dtype, device="cpu")
    if kind == "navigation":
        return make_navigation([1.0] * n, {"center": [[0.0] * n],
                                           "decay": [2.0]},
                               dtype=dtype, device="cpu")
    adj = [[1 if abs(i - j) in (1, n - 1) else 0 for j in range(n)]
           for i in range(n)]
    return make_hvac(adj, dtype=dtype, device="cpu")


@pytest.mark.parametrize("kind", ["linear", "reservoir", "navigation",
                                  "hvac"])
@pytest.mark.parametrize("n", [8, 12, 48])
def test_uncovered_rollout_dims_raise_naming_queue_2(n, kind):
    """Dims 7-48 that no unrolled rollout instantiation covers (12 is built
    for the HVAC step alone) no longer raise: ``kernel_layout`` (what every
    launch goes through) builds the layout for every env with a device
    step, and K2, K3 and K5 take the generic form's plan there (the
    unrolled one for HVAC-12). Above 48 the layout still raises."""
    env = _env_at(kind, n)
    B, T = 2, 3
    X = torch.zeros(B, T + 1, n, dtype=torch.float64)
    U = torch.zeros(B, T, n, dtype=torch.float64)
    policy = ilqr.backward(*ilqr.derivatives(env, X, U),
                           torch.zeros(B, dtype=torch.float64),
                           ilqr.ILQRConfig())[1]
    a = rollout.kernel_layout(env, X, U, policy)
    assert a["dims"] == (B, T, n, n)
    pe = sum(p.numel() for p in a["params"])
    for kernel in ("costs", "alpha", "traj"):
        plan = rollout.rollout_plan(kernel, a["env_id"], n, n, B, 11,
                                    torch.float64, pe)
        assert plan.generic == (not (kind == "hvac" and n == 12))
        assert plan.smem_bytes <= rollout.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="1 <= n, m <= 48"):
        rollout.kernel_layout(_linear(49, 49), torch.zeros(B, T + 1, 49),
                              torch.zeros(B, T, 49), policy)


def test_ddp_at_lane_dims_without_a_kernel_raises_naming_queue_2():
    """Full DDP at n, m <= 12 outside the lane kernels' dims, where the JAX
    lane kernel runs it and the port raised until it had K7's full-DDP
    variants (ROADMAP queue 2 item 2, done): it routes to the small-dims
    kernel on a card, every such dim, its K6a without boxQP (K7's until
    that kernel had the variant) and its K6b with; above 12 the plain
    backward, the JAX scan's route."""
    ddp = ilqr.ILQRConfig(use_pallas=True, ddp=True)
    ddp_box = ilqr.ILQRConfig(use_pallas=True, ddp=True, boxqp=True)
    for n in range(1, 13):
        for m in range(1, 13):
            lane = (n, m) in riccati.KERNEL_DIMS
            assert ilqr_batched._riccati_kernel_mode(
                n, m, ddp, "cuda") == ("lane" if lane else "small")
            # with boxQP the small-dims kernel's K6b (ops/riccati_small.py)
            assert ilqr_batched._riccati_kernel_mode(
                n, m, ddp_box, "cuda") == ("lane" if lane else "small")
    for dims in ((13, 2), (16, 16), (48, 48), (60, 3)):
        assert ilqr_batched._riccati_kernel_mode(*dims, ddp, "cuda") is None
        assert ilqr_batched._riccati_kernel_mode(*dims, ddp_box,
                                                 "cuda") is None


def _plain_calls():
    return (riccati.PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS,
            riccati.DDP_PLAIN_CALLS, riccati.DDP_BOXQP_PLAIN_CALLS,
            riccati_mid.MID_PLAIN_CALLS, riccati_mid.MID_BOXQP_PLAIN_CALLS,
            rollout.COSTS_PLAIN_CALLS, rollout.ALPHA_PLAIN_CALLS,
            rollout.TRAJ_PLAIN_CALLS)


def test_dims_above_48_solve_on_the_plain_route():
    """A 49-dim linear system with ``use_pallas=True``: no kernel wrapper
    is called (the route is the plain stages themselves, the one a card
    runs), and the solve equals the ``use_pallas=False`` one bit for
    bit."""
    env = _linear(49, 49)
    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 49)))
    cfg = ilqr.ILQRConfig(atol=1e-6, max_iterations=10, use_pallas=True)
    before = _plain_calls()
    res = ilqr.solve_batch(env, x0, horizon=4, config=cfg)
    assert _plain_calls() == before
    want = ilqr.solve_batch(env, x0, horizon=4,
                            config=dataclasses.replace(cfg, use_pallas=False))
    for name in res._fields:
        assert torch.equal(getattr(res, name), getattr(want, name)), name
    assert bool(res.converged.all())


def test_hvac16_ddp_solve_batch_matches_jax():
    """HVAC-16 (E1's env and config) with ``ddp=True``, B=4, T=10, float64,
    ``use_pallas=True``: the port's backward is plain DDP (no wrapper of a
    Riccati kernel is called) and its line search goes through K5's
    wrapper; the JAX package routes the backward to its vmapped scan.
    Identical converged and failed masks, costs within 1e-9."""
    B, T = 4, 10
    x0 = np.random.default_rng(0).uniform(8.0, 18.0, (B, 16))
    jenv = jax_load_env(str(HVAC16), dtype=jnp.float64)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**E1_DDP,
                                                      use_pallas=True))
    tenv = load_env(HVAC16, dtype=torch.float64, device="cpu")
    before = _plain_calls()
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**E1_DDP,
                                                    use_pallas=True))
    calls = [a - b for a, b in zip(_plain_calls(), before)]
    assert calls[:6] == [0] * 6            # no Riccati wrapper: plain DDP
    assert calls[8] > 0 and calls[6:8] == [0, 0]   # K5's wrapper (AUTO)
    for f in ("converged", "failed"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)
