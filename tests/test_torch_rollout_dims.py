"""The rollout kernels K2, K3 and K5 at every dim the JAX kernels cover.

The port runs K2, K3 and K5 at every 1 <= n, m <= 48: its unrolled
instantiations where they exist, the generic form
(``csrc/rollout_generic.cuh``) elsewhere. No CUDA tensor exists on the CPU,
so here the wrappers run their plain versions, and a ``solve_batch`` with
``use_pallas=True`` at those dims is held against the JAX package's in
float64 (identical converged and failed masks, controls within 1e-8): the
double integrator (n=2, m=1) with the JAX kernels in interpret mode, as
``tests/test_linear_env.py`` runs them, then reservoir-4, navigation in
four dims, an 8-room HVAC ring with boxQP and linear systems at (7, 3) and
(24, 6), the JAX package on its own route.

The generic form's index maps are mirrored in NumPy, as
``tests/test_torch_mid.py`` mirrors P1's (``row_matmul_cover``): at every
1 <= n, m <= 48 and every G of the plan rule, each control and next-state
row of each rollout is computed and stored by exactly one lane (ragged n %
G included), each group's state columns lie inside the block's shared
memory and no two rollouts share one, and the plan fits the H100.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.ops import rollout
from tfmpc_tpu_torch.solvers import ilqr

ROOT = Path(__file__).resolve().parents[1]
ALPHAS = ilqr.ILQRConfig().alphas_static()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(R):
    adj = [[1 if abs(i - j) in (1, R - 1) else 0 for j in range(R)]
           for i in range(R)]
    return dict(name="hvac", adj=adj,
                is_out=[1 if i % 4 == 0 else 0 for i in range(R)],
                is_hall=[1 if i % 4 == 2 else 0 for i in range(R)])


def _linear(n, m, seed):
    """A stable linear system at (n, m) with every cost term."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    arr = dict(A=(V * rng.uniform(0.9, 0.99, n)) @ V.T,
               B=0.1 * rng.standard_normal((n, m)),
               c=0.01 * rng.standard_normal(n),
               Q=0.5 * (L @ L.T) + 0.5 * np.eye(n), R=np.eye(m),
               N=0.01 * rng.standard_normal((n, m)),
               q=0.1 * rng.standard_normal(n), r=0.1 * rng.standard_normal(m),
               Q_f=np.eye(n), q_f=0.1 * rng.standard_normal(n))
    return dict(name="linear", **{k: v.tolist() for k, v in arr.items()})


def _reservoir4():
    cfg = json.loads((ROOT / "configs" / "reservoir.json").read_text())
    cfg.update(n_reservoirs=4)
    cfg.pop("x0")
    return cfg


DT = 0.1
DOUBLE_INTEGRATOR = dict(name="linear", A=[[1.0, DT], [0.0, 1.0]],
                         B=[[0.5 * DT * DT], [DT]],
                         Q=[[1.0, 0.0], [0.0, 0.1]], R=[[0.01]])
NAV4 = dict(name="navigation", goal=[8.0, -5.0, 4.0, -2.0],
            deceleration={"center": [[3.0, -2.0, 1.0, 0.0]],
                          "decay": [2.0]})

# label -> (env config, x0 range, B, T, ILQRConfig kwargs, JAX use_pallas)
CASES = {
    "double_integrator": (DOUBLE_INTEGRATOR, (-3.0, 3.0), 128, 12,
                          dict(atol=1e-10, max_iterations=20), True),
    "reservoir4": (_reservoir4(), (20.0, 95.0), 8, 20,
                   dict(atol=1e-3, max_iterations=30, boxqp=True), False),
    "nav4": (NAV4, (-10.0, 10.0), 8, 20,
             dict(atol=1e-8, max_iterations=50), False),
    "hvac8_ring": (_ring(8), (8.0, 18.0), 8, 20,
                   dict(atol=1e-2, max_iterations=20, boxqp=True), False),
    "linear7x3": (_linear(7, 3, 7), (-1.0, 1.0), 8, 20,
                  dict(atol=1e-10, max_iterations=20), False),
    "linear24x6": (_linear(24, 6, 24), (-1.0, 1.0), 4, 10,
                   dict(atol=1e-10, max_iterations=20), False),
}


@pytest.mark.parametrize("label", list(CASES))
def test_solve_batch_at_generic_dims_matches_jax(label):
    """``solve_batch(use_pallas=True)`` in float64 at dims no unrolled
    instantiation covers (the wrappers' plain versions on the CPU; the
    generic form on a card) against the JAX package's ``solve_batch``:
    identical converged and failed masks, controls and costs within
    1e-8. The double integrator runs the JAX rollout kernels in interpret
    mode; the other cases the JAX package's own route."""
    cfg, lohi, B, T, kw, jax_pallas = CASES[label]
    tenv = make_env(cfg, dtype=torch.float64, device="cpu")
    n, m = tenv.state_size, tenv.action_size
    step = tenv.device_step()
    assert not rollout.unrolled_dims(step.env_id, n, m)
    x0 = np.random.default_rng(0).uniform(*lohi, (B, n))
    jenv = jax_make_env(cfg, dtype=jnp.float64)
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**kw,
                                                      use_pallas=jax_pallas))
    before = (rollout.TRAJ_PLAIN_CALLS, rollout.COSTS_PLAIN_CALLS)
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**kw, use_pallas=True))
    # the line search went through K5's wrapper (AUTO's layout)
    assert rollout.TRAJ_PLAIN_CALLS > before[0]
    assert rollout.COSTS_PLAIN_CALLS == before[1]
    for f in ("converged", "failed"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    assert bool(res_t.converged.any())
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-8)


# -- the generic form's index maps --------------------------------------------

def _linear_params(n, m):
    """The linear step's parameter values, the most of the four envs at
    (n, m): the plan's shared bytes at their largest."""
    return 3 * n * n + 2 * n * m + m * m + 3 * n + m


def _generic_threads(plan, Bb, per):
    """The generic kernel's compute-thread map (csrc/rollout_generic.cuh
    rollout_generic_kernel) over every block of a launch, flattened:
    (the live threads' (scenario, alpha) index b * per + ai, their lane,
    every compute thread's state column tid / G, the columns rp)."""
    G, spb = plan.groups, plan.scenarios
    ncomp = plan.threads(per) - 32
    tid = np.arange(ncomp)
    lane, roll = tid % G, tid // G
    s, ai = roll % spb, roll // spb
    b = np.arange(plan.blocks(Bb))[:, None] * spb + s     # [blocks, threads]
    live = (ai < per) & (b < Bb)
    ai, lane = (np.broadcast_to(v, b.shape) for v in (ai, lane))
    return (b * per + ai)[live], lane[live], roll, ncomp // G


def _row_counts(rollouts, lane, G, rows, Bb, per):
    """How many lanes compute (and, when live, store) each row of each
    (scenario, alpha): lane l takes rows l, l + G, ... < ``rows``."""
    k = lane[:, None] + G * np.arange(-(-rows // G))[None, :]
    ok = k < rows
    idx = (rollouts[:, None] * rows + k)[ok]
    return np.bincount(idx, minlength=Bb * per * rows)


GENERIC_DIMS = [(n, m) for n in range(1, 49) for m in range(1, 49)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["costs", "alpha", "traj"])
def test_generic_plan_covers_each_row_once(kernel, dtype):
    """At every 1 <= n, m <= 48 (the generic form runs at the unrolled
    dims too when asked) and every G of ``GENERIC_PLANS`` (and the plan's
    own), a block-ragged batch of 37 at up to 4 scenarios a block (a G
    that fits no block is skipped: the plan rule lowers it): each control
    and next-state row of each live rollout is computed by exactly one
    lane, and no other (so each K3/K5 store is made once); the groups'
    state columns (column tid / G of rp in each slot of the state ring, G
    + 1 slots of x [n] and G of u [m], each slot padded to an odd multiple
    of 128 bytes / G) are distinct per rollout and lie within the block's
    shared bytes, which equal ``generic_smem_bytes`` and fit
    ``SMEM_LIMIT``; the threads fit a block."""
    A = len(ALPHAS)
    per = A if kernel in rollout.EVERY_ALPHA else 1
    item = 4 if dtype == torch.float32 else 8
    groups = sorted({row[0] for rows in rollout.GENERIC_PLANS[kernel].values()
                     for _, row in rows})
    Bb = 37
    for n, m in GENERIC_DIMS:
        pe = _linear_params(n, m)
        plan = rollout.rollout_plan(kernel, 3, n, m, Bb, A, dtype, pe)
        assert plan.generic or rollout.unrolled_dims(3, n, m)
        for G in sorted(set(groups) | {plan.groups}):
            for spb in (4, 2, 1):  # the most that fits: ragged blocks
                try:
                    p = rollout._generic_plan(kernel, 3, n, m, Bb, A,
                                              dtype, pe, G, spb, 1,
                                              rollout.TILE_MAX_THREADS)
                    break
                except ValueError:
                    continue
            else:
                assert G != plan.groups, (n, m, G)
                continue
            rolls, lane, roll, rp = _generic_threads(p, Bb, per)
            for rows in (m, n):  # the control rows, the next-state rows
                assert (_row_counts(rolls, lane, G, rows, Bb, per)
                        == 1).all(), (n, m, G, rows)
            assert roll.max() < rp                # one column a group
            assert p.threads(per) <= rollout.TILE_MAX_THREADS
            ring = rollout.rollout_smem_bytes(n, m, G, p.scenarios, p.depth,
                                              pe, dtype)
            assert ring % item == 0                # the state is aligned
            q = max(1, 128 // item // G)
            sx, su = (v if (v // q) % 2 else v + q
                      for v in (n * rp, m * rp))
            assert p.smem_bytes == ring + ((G + 1) * sx + G * su) * item
            assert p.smem_bytes <= rollout.SMEM_LIMIT, (n, m, G)


def test_generic_plan_rule_fits_every_dim():
    """The default generic plan at every (n, m) <= 48 that no unrolled
    instantiation takes, for K2, K3 and K5 in both dtypes, for the linear
    env's rows of ``GENERIC_PLANS`` and the other envs' (HVAC's id), at the
    largest env's parameters (the linear step's), fits the shared memory and the threads; D is
    lowered only where one scenario a block would not fit at the table's
    D, and G (the state ring grows with it) only where one would not fit
    at the table's G."""
    A = len(ALPHAS)
    for dtype, env_id in ((torch.float32, 3), (torch.float64, 3),
                          (torch.float32, 1), (torch.float64, 1)):
        for n, m in GENERIC_DIMS:
            if rollout.unrolled_dims(env_id, n, m):
                continue
            pe = _linear_params(n, m)
            for kernel in ("costs", "alpha", "traj"):
                per = A if kernel in rollout.EVERY_ALPHA else 1
                plan = rollout.rollout_plan(kernel, env_id, n, m, 4096, A,
                                            dtype, pe)
                G, blocks, D = rollout.generic_row(kernel, env_id, n, m)
                assert plan.generic and plan.groups <= G
                assert plan.smem_bytes <= rollout.SMEM_LIMIT
                assert plan.threads(per) <= rollout.TILE_MAX_THREADS
                assert plan.depth <= D
                if plan.depth < D:
                    assert rollout.generic_smem_bytes(
                        n, m, G, 1, plan.depth + 1, pe, dtype,
                        per) > rollout.SMEM_LIMIT
                if plan.groups < G:
                    assert plan.depth == 1 and rollout.generic_smem_bytes(
                        n, m, 2 * plan.groups, 1, 1, pe, dtype,
                        per) > rollout.SMEM_LIMIT
