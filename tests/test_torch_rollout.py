"""K2, K3 and K5: the port's line-search rollouts vs the JAX Pallas kernels.

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
    alphas = ILQRConfig().alphas(torch.float64, device="cpu")
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


# -- K5: the emit-trajectories line search ----------------------------------------
#
# ``linesearch_costs_traj_ref`` against the JAX package's
# ``linesearch_costs_traj_pallas`` in interpret mode (B=128, T=4, the size
# of tests/test_rollout_pallas.py's parity tests) and against its XLA line
# search at B=16, float64, tolerance as above. The layout: J [B, A],
# X_all [T, A, n, B] (x_{t+1}), U_all [T, A, m, B].

def _traj_setup(name, seed, Bb, Tb):
    """Navigation (unbounded) or reservoir-5 (bounded, many controls on the
    box's faces) with a random nominal and feedback policy."""
    from tfmpc_tpu.models.reservoir import make_reservoir as jax_make_reservoir
    from tfmpc_tpu_torch.models.reservoir import make_reservoir

    if name == "navigation":
        zone = ZONES["one_zone"]
        jenv = jax_make_navigation([8.0, -5.0], zone, dtype=jnp.float64)
        tenv = make_navigation([8.0, -5.0], zone, dtype=torch.float64,
                               device="cpu")
        lohi, ulohi, kscale = (-6.0, 6.0), (0.0, 2.0), 0.1
    else:
        jenv = jax_make_reservoir(5, dtype=jnp.float64)
        tenv = make_reservoir(5, dtype=torch.float64, device="cpu")
        lohi, ulohi, kscale = (20.0, 95.0), (0.0, 4.0), 3.0
    n = tenv.state_size
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(*lohi, (Bb, n))
    U = tenv.clip(torch.as_tensor(rng.uniform(*ulohi, (Bb, Tb, n)))).numpy()
    X = tenv.rollout(torch.as_tensor(x0), torch.as_tensor(U))[0].numpy()
    K = 0.05 * rng.standard_normal((Bb, Tb, n, n))
    k = kscale * rng.standard_normal((Bb, Tb, n))
    j = (jenv, jnp.asarray(X), jnp.asarray(U),
         JPolicy(K=jnp.asarray(K), k=jnp.asarray(k)))
    t = (tenv, torch.as_tensor(X), torch.as_tensor(U),
         Policy(K=torch.as_tensor(K), k=torch.as_tensor(k)))
    return j, t, rng


@pytest.mark.parametrize("name", ["navigation", "reservoir"])
def test_linesearch_costs_traj_ref_matches_jax_kernel(name):
    from tfmpc_tpu.ops.rollout_pallas import linesearch_costs_traj_pallas

    j, t, _ = _traj_setup(name, seed=11, Bb=128, Tb=4)
    n = t[0].state_size
    ours = rollout.linesearch_costs_traj_ref(*t, ALPHAS)
    theirs = linesearch_costs_traj_pallas(*j, ALPHAS)
    A = len(ALPHAS)
    for got, shape in zip(ours, ((128, A), (4, A, n, 128), (4, A, n, 128))):
        assert got.shape == shape
    for got, want in zip(ours, theirs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["navigation", "reservoir"])
def test_linesearch_costs_traj_ref_matches_jax_linesearch(name):
    """Against the JAX XLA line search (vmapped ``ilqr.forward``): every
    alpha's cost and trajectory."""
    from tfmpc_tpu.solvers.ilqr_batched import _linesearch_batched

    j, t, _ = _traj_setup(name, seed=12, Bb=16, Tb=T)
    X_j, U_j, J_j = _linesearch_batched(*j, jnp.asarray(ALPHAS))
    J_t, X_t, U_t = rollout.linesearch_costs_traj_ref(*t, ALPHAS)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), **TOL)
    # [B, A, T+1, n] -> the kernel layout [T, A, n, B] of x_1 .. x_T
    np.testing.assert_allclose(
        X_t.numpy(), np.asarray(X_j)[:, :, 1:].transpose(2, 1, 3, 0), **TOL)
    np.testing.assert_allclose(
        U_t.numpy(), np.asarray(U_j).transpose(2, 1, 3, 0), **TOL)


@pytest.mark.parametrize("name", ["navigation", "reservoir"])
def test_costs_traj_agrees_with_the_two_kernel_line_search(name):
    """K5's J is K2's, and the trajectory selected at each lane's alpha is
    K3's rollout at that alpha (the plain versions share one rollout); the
    wrapper runs the plain version on CPU tensors."""
    _, t, rng = _traj_setup(name, seed=13, Bb=16, Tb=T)
    counts = (rollout.TRAJ_LAUNCHES, rollout.TRAJ_PLAIN_CALLS)
    J_all, X_all, U_all = rollout.linesearch_costs_traj(*t, ALPHAS)
    assert (rollout.TRAJ_LAUNCHES, rollout.TRAJ_PLAIN_CALLS) == (
        counts[0], counts[1] + 1)
    assert torch.equal(J_all, rollout.linesearch_costs_ref(*t, ALPHAS))
    best = torch.as_tensor(rng.integers(0, len(ALPHAS), 16))
    X_s, U_s, J_s = rollout.select_alpha_trajectory(t[1], X_all, U_all,
                                                    J_all, best)
    alphas = ILQRConfig().alphas(torch.float64, device="cpu")
    X_m, U_m, J_m = rollout.rollout_alpha_ref(*t, alphas[best])
    for got, want in ((X_s, X_m), (U_s, U_m), (J_s, J_m)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14,
                                   atol=0)


def test_select_alpha_trajectory_matches_jax_and_is_nan_safe():
    """The port's gather against the JAX where-chain on random blocks, and
    a diverged (inf/NaN) candidate does not poison lanes that selected
    another alpha (the port's version of
    tests/test_rollout_pallas.py::test_select_alpha_trajectory_is_nan_safe)."""
    from tfmpc_tpu.ops.rollout_pallas import select_alpha_trajectory

    Tb, A, n, m, Bb = 3, 4, 2, 1, 5
    rng = np.random.default_rng(14)
    X = rng.standard_normal((Bb, Tb + 1, n))
    X_all = rng.standard_normal((Tb, A, n, Bb))
    U_all = rng.standard_normal((Tb, A, m, Bb))
    J_all = rng.standard_normal((Bb, A))
    X_all[:, 0] = np.nan                      # alpha 0 diverged everywhere
    U_all[:, 0] = np.inf
    J_all[:, 0] = np.inf
    best = np.array([1, 3, 2, 1, 0])          # lane 4 picked the NaN one
    ours = rollout.select_alpha_trajectory(
        *(torch.as_tensor(a) for a in (X, X_all, U_all, J_all, best)))
    theirs = select_alpha_trajectory(
        *(jnp.asarray(a) for a in (X, X_all, U_all, J_all, best)))
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    X_s, U_s, J_s = ours
    assert bool(torch.isfinite(X_s[:4]).all() & torch.isfinite(U_s[:4]).all())
    assert bool(torch.isnan(X_s[4, 1:]).all()) and float(J_s[4]) == np.inf
    np.testing.assert_array_equal(X_s[:, 0].numpy(), X[:, 0])


def test_kernel_layout_of_a_linear_env():
    """A linear env reaches the kernels as the LinearStep functor: env id
    kLinear (3), its ten parameters in order, no integer parameters."""
    from tfmpc_tpu_torch.models.linear import (
        LINEAR_STEP_ID,
        make_linear_system,
    )

    env = make_linear_system([[1.0, 0.1], [0.0, 1.0]],
                             [[0.005, 0.0], [0.1, 0.05]], q=[1.0, -1.0],
                             low=-2.0, high=2.0, dtype=torch.float64,
                             device="cpu")
    rng = np.random.default_rng(15)
    Bb, Tb = 3, 5
    U = torch.as_tensor(rng.uniform(-1.0, 1.0, (Bb, Tb, 2)))
    X = env.rollout(torch.zeros(Bb, 2, dtype=torch.float64), U)[0]
    policy = Policy(K=torch.zeros(Bb, Tb, 2, 2, dtype=torch.float64),
                    k=torch.zeros(Bb, Tb, 2, dtype=torch.float64))
    a = rollout.kernel_layout(env, X, U, policy)
    assert a["env_id"] == LINEAR_STEP_ID == 3
    assert len(a["params"]) == 10 and a["int_params"] == ()
    assert [p.shape for p in a["params"]] == [
        (2, 2), (2, 2), (2,), (2, 2), (2, 2), (2, 2), (2,), (2,), (2, 2),
        (2,)]
    np.testing.assert_array_equal(a["params"][6].numpy(), [1.0, -1.0])
    np.testing.assert_array_equal(a["lo"].numpy(), [-2.0, -2.0])


# -- the launch plans of the tile kernel (K2, K3, K5, K8) ---------------------
#
# ``rollout_plan`` at every kernel dim, both dtypes and batches that fill
# their last block or leave it ragged, held to a mirror of
# csrc/rollout.cuh rollout_tile_kernel's index maps: compute thread tid is
# lane tid % G of rollout tid // G, scenario r % spb at alpha r // spb;
# lane l computes and stores the rows l, l + G, ... < n; the copies of a
# step are the last warp's: its thread p puts chunk q = p % cpr of rows
# p // cpr, + 32 // cpr, ... of the block's tile.

PLAN_BATCHES = (1, 513, 1023, 512, 1024, 2048, 4096)
PLAN_ENV_PARAMS = {  # (env id, parameter values) of an env at each dim
    2: (0, 2 + 2 * 2 + 2),       # navigation, two zones
    3: (1, 3 * 3 + 7 * 3 + 8),   # HVAC-3
    5: (2, 5 * 5 + 5 * 5 + 4),   # reservoir-5
    6: (1, 6 * 6 + 7 * 6 + 8),   # HVAC-6
    12: (1, 12 * 12 + 7 * 12 + 8),
    16: (1, 16 * 16 + 7 * 16 + 8),
}


# (kind, n) of every plan: K2, K3 and K5 at every kernel dim, K8 at its own
PLAN_KINDS = [(kernel, n) for kernel in ("costs", "alpha", "traj")
              for n in sorted(n for n, _ in rollout.KERNEL_DIMS)] \
    + [("derivs", n) for n in sorted(n for n, _ in rollout.DERIVS_DIMS)]
KIND_NAMES = {"costs": "kCosts", "alpha": "kAlpha", "traj": "kTraj",
              "derivs": "kDerivs"}


def _plan_env(kernel, n):
    """(env id, parameter values) of the env a kind runs at n: K8's is
    navigation (two zones)."""
    return (0, n + 2 * n + 2) if kernel == "derivs" else PLAN_ENV_PARAMS[n]


def _rollout_lanes(plan, Bb, per):
    """The mirror's compute threads of every block: ``(b, ai, lane, live)``,
    each ``[blocks, compute threads]``."""
    G, spb = plan.groups, plan.scenarios
    tid = np.arange(plan.threads(per) - 32)  # the compute warps
    lane, roll = tid % G, tid // G
    s, ai = roll % spb, roll // spb
    b = np.arange(plan.blocks(Bb))[:, None] * spb + s
    live = (ai < per) & (b < Bb)
    return b, np.broadcast_to(ai, b.shape), np.broadcast_to(lane, b.shape), \
        live


def _vec_bytes(spb, B, item):
    """csrc/rollout.cuh tile_vec_bytes for aligned pointers."""
    for vb in (16, 8, 4):
        if item <= vb <= spb * item and B * item % vb == 0:
            return vb
    return item


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel, n", PLAN_KINDS)
def test_rollout_plan_covers_each_row_once(kernel, n, dtype):
    """Every (scenario, alpha, row) is computed by exactly one lane, every
    staged (scenario, entry) is copied once into the block's tile and read
    inside it; the threads and shared bytes fit the H100 and equal the
    plan's sums; G is the one the sources instantiate."""
    import re
    from pathlib import Path

    source = (Path(rollout.__file__).parent / "csrc"
              / "rollout.cuh").read_text()
    env_id, params = _plan_env(kernel, n)
    A = len(ALPHAS)
    per = A if kernel in rollout.EVERY_ALPHA else 1
    item = 4 if dtype == torch.float32 else 8
    entries = n + 2 * n + n * n
    for Bb in PLAN_BATCHES:
        plan = rollout.rollout_plan(kernel, env_id, n, n, Bb, A, dtype,
                                    params)
        G, spb = plan.groups, plan.scenarios
        assert f"{{{KIND_NAMES[kernel]}, {n}, {G}}}" \
            in re.sub(r"\s+", " ", source)
        assert spb & (spb - 1) == 0 and 1 <= spb <= rollout.TILE_MAX_SPB
        # the largest power of two at most B over the table's blocks, or
        # the largest that fits the block's threads and shared memory
        blocks = rollout.ROLLOUT_PLANS[kernel][n][1]
        capped = spb == rollout.TILE_MAX_SPB or -(
            -2 * spb * per * G // 32) * 32 + 32 > rollout.TILE_MAX_THREADS \
            or rollout.rollout_smem_bytes(n, n, G, 2 * spb, plan.depth,
                                          params, dtype) > rollout.SMEM_LIMIT
        assert spb <= -(-Bb // blocks) and (2 * spb > -(-Bb // blocks)
                                            or capped)
        threads = plan.threads(per)
        assert threads % 32 == 0 and threads <= rollout.TILE_MAX_THREADS
        assert plan.smem_bytes <= rollout.SMEM_LIMIT
        assert plan.smem_bytes == rollout.rollout_smem_bytes(
            n, n, G, spb, plan.depth, params, dtype)
        st = rollout.tile_stride(spb, G, item)
        assert st >= spb
        b, ai, lane, live = _rollout_lanes(plan, Bb, per)
        blk = np.arange(plan.blocks(Bb))[:, None]
        rows = np.zeros((Bb, per, n), dtype=int)
        for r in range(-(-n // G)):
            i = lane + G * r
            ok = live & (i < n)
            np.add.at(rows, (b[ok], ai[ok], i[ok]), 1)
        assert (rows == 1).all(), (kernel, n, Bb)
        ve = _vec_bytes(spb, Bb, item) // item
        cpr = spb // ve
        tid = np.arange(32)  # the copying warp
        q = tid % cpr
        # thread tid copies entries e = tid // cpr + k * (32 // cpr)
        e = tid[:, None] // cpr + np.arange(entries)[None, :] * (32 // cpr)
        mine = e < entries
        ek = e - 3 * n
        row = np.where(e < 3 * n, e, 3 * n + ek % n * n + ek // n)
        assert (row[mine] < entries).all() and (q * ve + ve <= st).all()
        assert sorted(row[mine]) == sorted(e[mine])  # a permutation
        staged = np.zeros((plan.blocks(Bb) * spb, entries), dtype=int)
        bq = blk * spb + q * ve                        # [blocks, threads]
        for j in range(ve):                            # a chunk's values
            cols = np.broadcast_to((bq + j)[:, :, None], bq.shape
                                   + (entries,))
            ents = np.broadcast_to(e[None], cols.shape)
            take = np.broadcast_to(mine[None], cols.shape) \
                & np.broadcast_to((bq < Bb)[:, :, None], cols.shape)
            np.add.at(staged, (cols[take], ents[take]), 1)
        assert (staged[:Bb] == 1).all() and not staged[Bb:].any(), (
            kernel, n, Bb)


def test_a_rollout_plan_exists_for_every_kernel_dim():
    """``rollout_plan`` gives a plan for every (n, m) that ``kernel_layout``
    accepts: the unrolled table's at the instantiated dims (K2, K3 and K5
    at ``KERNEL_DIMS``, the HVAC step alone at the mid dims, K8 at
    ``DERIVS_DIMS``), and K2, K3 and K5 at every other 1 <= n, m <= 48 in
    both dtypes the generic form's, within ``SMEM_LIMIT`` and the block's
    threads at the largest env's parameters (the linear step's), and K8's
    at every other n = m <= 12; it refuses K8 elsewhere and every dim
    above 48."""
    for kernel, n in PLAN_KINDS:
        env_id, params = _plan_env(kernel, n)
        for dtype in (torch.float32, torch.float64):
            assert not rollout.rollout_plan(kernel, env_id, n, n, 1024,
                                            len(ALPHAS), dtype,
                                            params).generic
    assert set(rollout.ROLLOUT_PLANS) == set(rollout.KIND_CODES)
    for kernel in ("costs", "alpha", "traj"):
        assert set(rollout.ROLLOUT_PLANS[kernel]) \
            == {n for n, _ in rollout.KERNEL_DIMS}
    assert set(rollout.ROLLOUT_PLANS["derivs"]) \
        == {n for n, _ in rollout.DERIVS_DIMS}
    A = len(ALPHAS)
    for dtype in (torch.float32, torch.float64):
        for n in range(1, 49):
            for m in range(1, 49):
                pe = 3 * n * n + 2 * n * m + m * m + 3 * n + m
                for kernel in ("costs", "alpha", "traj"):
                    per = A if kernel in rollout.EVERY_ALPHA else 1
                    plan = rollout.rollout_plan(kernel, 3, n, m, 1024, A,
                                                dtype, pe)
                    assert plan.generic == ((n, m) not in
                                            rollout.KERNEL_DIMS
                                            or (n, m) in
                                            rollout.HVAC_ONLY_DIMS)
                    assert plan.smem_bytes <= rollout.SMEM_LIMIT
                    assert plan.threads(per) <= rollout.TILE_MAX_THREADS
    # the reservoir at 16 and navigation at 4: the generic form
    assert rollout.rollout_plan("costs", 2, 16, 16, 1024, 11, torch.float32,
                                400).generic
    assert rollout.rollout_plan("alpha", 0, 4, 4, 1024, 11, torch.float32,
                                10).generic
    for kernel in ("costs", "alpha", "traj"):
        for dims in ((49, 49), (2, 49), (0, 3)):
            with pytest.raises(NotImplementedError):
                rollout.rollout_plan(kernel, 3, *dims, 1024, 11,
                                     torch.float32, 400)
    # K8: the generic form at every other n = m <= 12, refused elsewhere
    for n in range(1, 13):
        plan = rollout.rollout_plan("derivs", 0, n, n, 1024, 11,
                                    torch.float32, 2 * n + 1)
        assert plan.generic == ((n, n) not in rollout.DERIVS_DIMS)
    for dims in ((13, 13), (16, 16), (2, 3)):
        with pytest.raises(NotImplementedError, match="n = m <= 12"):
            rollout.rollout_plan("derivs", 0, *dims, 1024, 11,
                                 torch.float32, 38)


# The stores of K5 and K8: output -> its entries a step. In the step loop
# (every step the same entries) a lane stores its rows i: K5's of alpha ai
# at ai*n + i of X [T, A*n, B] and U [T, A*m, B], K8's at row i of X and
# U. K8's linearization blocks are the tail's (csrc/rollout.cuh
# derivs_tail): thread tid of a block writes every entry of scenario
# tid % spb at the steps tid // spb, + threads // spb, ...
def _store_map(kernel, n, A):
    if kernel == "traj":
        return {"X": A * n, "U": A * n}
    return {"X": n, "U": n}


TAIL_T = 7  # steps of the tail's mirror (not a multiple of its stride)


def _derivs_row_entries(key, n):
    """The entries derivs_row (csrc/envs.cuh) writes of block ``key`` over
    its rows i < n: i*n + j of the square blocks, i of l_x and l_u."""
    if key in ("lx", "lu"):
        return list(range(n))
    return [i * n + j for i in range(n) for j in range(n)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel, n", [kn for kn in PLAN_KINDS
                                       if kn[0] in ("traj", "derivs")])
def test_rollout_plan_stores_each_output_once(kernel, n, dtype):
    """K5's and K8's stores under their plans at the ragged and full
    batches of the plan test: every entry of a step of K5's ``X_all`` /
    ``U_all`` ``[T, A*n, B]`` and of K8's X and U is written by exactly one
    (block, compute thread), and each (step, scenario) of K8's seven
    ``D_KEYS`` blocks by exactly one (block, thread) of its tail; no entry
    past B is written; under a mirror of rollout_tile_kernel's store maps
    (the lane's rows l, l + G, ... < n of its live rollout) and of
    derivs_tail's."""
    env_id, params = _plan_env(kernel, n)
    A = len(ALPHAS)
    per = A if kernel in rollout.EVERY_ALPHA else 1
    for Bb in PLAN_BATCHES:
        plan = rollout.rollout_plan(kernel, env_id, n, n, Bb, A, dtype,
                                    params)
        b, ai, lane, live = _rollout_lanes(plan, Bb, per)
        padded = plan.blocks(Bb) * plan.scenarios
        writers = {key: np.zeros((E, padded), dtype=int)
                   for key, E in _store_map(kernel, n, A).items()}

        def store(key, e, ok):  # one store of each (block, thread) on ok
            np.add.at(writers[key], (e[ok], b[ok]), 1)

        for r in range(-(-n // plan.groups)):
            i = lane + plan.groups * r
            ok = live & (i < n)
            row = ai * n + i if kernel == "traj" else i
            store("X", row, ok)
            store("U", row, ok)
        for key, count in writers.items():
            assert (count[:, :Bb] == 1).all(), (kernel, n, Bb, key)
            assert not count[:, Bb:].any(), (kernel, n, Bb, key)
        if kernel != "derivs":
            continue
        nthr, spb = plan.threads(per), plan.scenarios
        assert nthr % spb == 0
        tid = np.arange(nthr)  # every thread of the block
        bt = np.arange(plan.blocks(Bb))[:, None] * spb + tid % spb
        steps = np.zeros((TAIL_T, padded), dtype=int)
        for t in range(TAIL_T):
            mine = (t >= tid // spb) & ((t - tid // spb) % (nthr // spb) == 0)
            ok = np.broadcast_to(mine, bt.shape) & (bt < Bb)
            np.add.at(steps[t], bt[ok], 1)
        for key in rollout.D_KEYS:  # a (step, scenario) writes its entries
            cover = np.bincount(_derivs_row_entries(key, n))
            lin = steps[:, None, :] * cover[None, :, None]
            assert (lin[:, :, :Bb] == 1).all(), (kernel, n, Bb, key)
            assert not lin[:, :, Bb:].any(), (kernel, n, Bb, key)


@pytest.mark.parametrize("name", ["navigation", "hvac", "reservoir",
                                  "linear"])
def test_rollout_param_elems_match_the_env(name):
    """The parameter values a tile block copies into shared memory
    (csrc/envs.cuh ``param_elems``) are the env's device_step parameters,
    element for element: the plan's shared bytes count them."""
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.linear import make_linear_system
    from tfmpc_tpu_torch.models.reservoir import make_reservoir

    kw = dict(dtype=torch.float64, device="cpu")
    if name == "navigation":
        env = make_navigation([8.0, -5.0], {"center": [[3.0, -2.0],
                                                       [1.0, 1.0]],
                                            "decay": [2.0, 1.0]}, **kw)
        n, zones = 2, 2
        want = n + zones * n + zones
    elif name == "hvac":
        env = make_hvac([[0, 1, 0], [1, 0, 1], [0, 1, 0]], **kw)
        n = 3
        want = n * n + 7 * n + 8
    elif name == "reservoir":
        env = make_reservoir(5, **kw)
        n = 5
        want = n * n + 5 * n + 4
    else:
        env = make_linear_system([[1.0, 0.1], [0.0, 1.0]],
                                 [[0.005, 0.0], [0.1, 0.05]], **kw)
        n = 2
        want = 3 * n * n + 2 * n * n + n * n + 3 * n + n
    step = env.device_step()
    assert sum(p.numel() for p in step.params) == want
