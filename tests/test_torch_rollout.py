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
    tenv = make_navigation([8.0, -5.0], zones, dtype=torch.float64,
                           device="cpu")
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


# -- clipped rollouts on bounded envs -------------------------------------------
#
# The plain versions against the JAX package's XLA line search
# (``ilqr_batched._linesearch_batched``: vmapped ``ilqr.forward`` with the
# env's clip) on bounded HVAC-3 and reservoir-5, float64, with a random
# policy that drives many controls onto the box's faces. Tolerance as above.

def _bounded_setup(name, seed):
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
        jenv = jax_make_reservoir(5, dtype=jnp.float64)
        tenv = make_reservoir(5, dtype=torch.float64, device="cpu")
        lohi = (20.0, 95.0)
    Bb, n = 16, tenv.state_size
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(*lohi, (Bb, n))
    U = tenv.clip(torch.as_tensor(rng.uniform(0.0, 4.0, (Bb, T, n)))).numpy()
    X = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))[0].numpy()
    K = 0.05 * rng.standard_normal((Bb, T, n, n))
    k = 3.0 * rng.standard_normal((Bb, T, n))
    j = (jenv, jnp.asarray(X), jnp.asarray(U),
         JPolicy(K=jnp.asarray(K), k=jnp.asarray(k)))
    t = (tenv, torch.as_tensor(X), torch.as_tensor(U),
         Policy(K=torch.as_tensor(K), k=torch.as_tensor(k)))
    return j, t, rng


@pytest.mark.parametrize("name", ["hvac", "reservoir"])
def test_clipped_rollouts_match_jax_linesearch(name):
    from tfmpc_tpu.solvers.ilqr_batched import _linesearch_batched

    j, t, rng = _bounded_setup(name, seed=5)
    X_j, U_j, J_j = _linesearch_batched(*j, jnp.asarray(ALPHAS))
    J_t = rollout.linesearch_costs_ref(*t, ALPHAS)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), **TOL)
    U_j = np.asarray(U_j)
    env = t[0]
    on_face = (U_j == env.bounds.low.numpy()) | (U_j == env.bounds.high.numpy())
    assert 0.05 < on_face.mean() < 0.95
    best = rng.integers(0, len(ALPHAS), U_j.shape[0])
    alpha = torch.as_tensor(np.asarray(ALPHAS)[best])
    X_t, U_t, Jm_t = rollout.rollout_alpha_ref(*t, alpha)
    rows = np.arange(U_j.shape[0])
    np.testing.assert_allclose(X_t.numpy(), np.asarray(X_j)[rows, best], **TOL)
    np.testing.assert_allclose(U_t.numpy(), U_j[rows, best], **TOL)
    np.testing.assert_allclose(Jm_t.numpy(), np.asarray(J_j)[rows, best],
                               **TOL)


@pytest.mark.parametrize("name", ["hvac", "reservoir"])
def test_kernel_layout_of_a_bounded_env(name):
    """What the CUDA kernels would receive for a bounded env, shown without
    launching: the step id, the box as two [m] tensors behind non-null
    pointers, and one pointer per step parameter."""
    from tfmpc_tpu_torch.models.hvac import HVAC_STEP_ID
    from tfmpc_tpu_torch.models.reservoir import RESERVOIR_STEP_ID

    _, t, _ = _bounded_setup(name, seed=6)
    env, X, U, policy = t
    a = rollout.kernel_layout(*t)
    n = env.state_size
    assert a["dims"] == (16, T, n, n) and a["dtype"] == torch.float64
    assert a["env_id"] == {"hvac": HVAC_STEP_ID,
                           "reservoir": RESERVOIR_STEP_ID}[name]
    assert torch.equal(a["lo"], env.bounds.low)
    assert torch.equal(a["hi"], env.bounds.high)
    lo_p, hi_p = rollout._bound_pointers(a)
    assert lo_p.value == a["lo"].data_ptr() and hi_p.value == a["hi"].data_ptr()
    params, n_params, _, n_ints = rollout._env_pointers(a)
    assert n_params == len(env.device_step().params) and n_ints == 0
    assert list(params) == [p.data_ptr() for p in a["params"]]
    np.testing.assert_array_equal(a["ubar"].numpy(),
                                  U.numpy().transpose(1, 2, 0))
    # an unbounded env passes null pointers
    _, tn, _ = _setup(ZONES["one_zone"])
    null = rollout._bound_pointers(rollout.kernel_layout(*tn))
    assert [p.value for p in null] == [None, None]
    assert (n, n) in rollout.KERNEL_DIMS
