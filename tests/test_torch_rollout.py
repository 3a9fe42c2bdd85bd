"""K2 and K3: the port's line-search rollouts vs the JAX Pallas kernels.

``linesearch_costs_ref`` / ``rollout_alpha_ref`` (the plain PyTorch
versions of the CUDA kernels) are held against ``tfmpc_tpu``'s
``linesearch_costs_pallas`` / ``rollout_alpha_pallas`` in Pallas interpret
mode on the CPU, float64, on nominals and small random feedback policies
drawn with numpy from a seed (the inputs of
``tests/test_rollout_pallas.py``'s parity tests). Tolerance: 1e-10
relative and absolute. Both are float64 over a T=12 chain; the JAX kernel
accumulates the cost as a running sum and the plain version sums the
stacked stage costs, which moves J by a few ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.core.types import Policy as JPolicy
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.ops.rollout_pallas import (
    linesearch_costs_pallas,
    rollout_alpha_pallas,
)
from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import rollout
from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

TOL = dict(rtol=1e-10, atol=1e-10)
B, T = 128, 12
ALPHAS = ILQRConfig().alphas_static()
ZONES = {
    "one_zone": {"center": [[3.0, -2.0]], "decay": [2.0]},
    "no_zones": None,
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(zones, seed=0):
    jenv = jax_make_navigation([8.0, -5.0], zones, dtype=jnp.float64)
    tenv = make_navigation([8.0, -5.0], zones, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-6.0, 6.0, (B, 2))
    U = rng.uniform(0.0, 2.0, (B, T, 2))
    X, _ = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))
    X = X.numpy()
    K = 0.05 * rng.standard_normal((B, T, 2, 2))
    k = 0.1 * rng.standard_normal((B, T, 2))
    j = (jenv, jnp.asarray(X), jnp.asarray(U),
         JPolicy(K=jnp.asarray(K), k=jnp.asarray(k)))
    t = (tenv, torch.as_tensor(X), torch.as_tensor(U),
         Policy(K=torch.as_tensor(K), k=torch.as_tensor(k)))
    return j, t, rng


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_linesearch_costs_ref_matches_jax_kernel(zones):
    j, t, _ = _setup(ZONES[zones])
    J_t = rollout.linesearch_costs_ref(*t, ALPHAS)
    J_j = linesearch_costs_pallas(*j, ALPHAS)
    assert J_t.shape == (B, len(ALPHAS))
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), **TOL)


@pytest.mark.parametrize("zones", sorted(ZONES))
def test_rollout_alpha_ref_matches_jax_kernel(zones):
    j, t, rng = _setup(ZONES[zones], seed=1)
    alpha = np.asarray(ALPHAS)[rng.integers(0, len(ALPHAS), B)]
    X_t, U_t, J_t = rollout.rollout_alpha_ref(*t, torch.as_tensor(alpha))
    X_j, U_j, J_j = rollout_alpha_pallas(*j, jnp.asarray(alpha))
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j), **TOL)
    np.testing.assert_allclose(U_t.numpy(), np.asarray(U_j), **TOL)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), **TOL)


def test_materialize_reproduces_the_evaluated_alpha():
    """Each scenario's re-roll at alpha_i gives exactly the J that the line
    search evaluated for alpha_i (both sides use the same alpha values)."""
    _, t, rng = _setup(ZONES["one_zone"], seed=2)
    J_all = rollout.linesearch_costs_ref(*t, ALPHAS)
    best = torch.as_tensor(rng.integers(0, len(ALPHAS), B))
    alphas = ILQRConfig().alphas(torch.float64)
    _, _, J = rollout.rollout_alpha_ref(*t, alphas[best])
    np.testing.assert_allclose(J.numpy(), J_all[torch.arange(B), best].numpy(),
                               rtol=1e-14, atol=0)


def test_blowup_costs_are_inf():
    """A diverging candidate gets J = +inf, never NaN, so it is rejected."""
    _, (env, X, U, policy), _ = _setup(ZONES["one_zone"], seed=3)
    huge = Policy(K=policy.K * 0.0, k=policy.k * 0.0 + 1e300)
    J = rollout.linesearch_costs_ref(env, X, U, huge, ALPHAS)
    assert bool(torch.isinf(J).all()) and bool((J > 0).all())


def test_wrappers_run_plain_versions_on_cpu_only():
    _, t, rng = _setup(ZONES["one_zone"], seed=4)
    counts = (rollout.COSTS_LAUNCHES, rollout.COSTS_PLAIN_CALLS,
              rollout.ALPHA_LAUNCHES, rollout.ALPHA_PLAIN_CALLS)
    J = rollout.linesearch_costs(*t, ALPHAS)
    assert torch.equal(J, rollout.linesearch_costs_ref(*t, ALPHAS))
    alpha = torch.as_tensor(np.asarray(ALPHAS)[rng.integers(0, 11, B)])
    out = rollout.rollout_alpha(*t, alpha)
    for a, b in zip(out, rollout.rollout_alpha_ref(*t, alpha)):
        assert torch.equal(a, b)
    assert (rollout.COSTS_LAUNCHES, rollout.COSTS_PLAIN_CALLS,
            rollout.ALPHA_LAUNCHES, rollout.ALPHA_PLAIN_CALLS) == (
        counts[0], counts[1] + 1, counts[2], counts[3] + 1)
    # the kernels' argument preparation refuses what they cannot run
    with pytest.raises(ValueError, match="CUDA tensors"):
        rollout.kernel_args(*t)
