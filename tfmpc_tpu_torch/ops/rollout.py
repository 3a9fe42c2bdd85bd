"""K2, K3, K5 and K8: the closed-loop rollouts of the iLQR line search.

Counterpart of ``tfmpc_tpu/ops/rollout_pallas.py``. The two-kernel line
search: ``linesearch_costs`` (K2) rolls every (scenario, alpha) pair and
keeps only the total costs; ``rollout_alpha`` (K3) re-rolls once at each
scenario's accepted alpha to materialize the new trajectory. The
emit-trajectories line search: ``linesearch_costs_traj`` (K5) is K2 that
also writes every alpha's trajectory, and ``select_alpha_trajectory`` picks
each scenario's accepted one, so an iteration runs one rollout chain
instead of two. The fused iteration (``ILQRConfig.fuse_derivatives``):
``rollout_alpha_derivs`` (K8) is K3 that also writes the env's closed-form
linearization of the new trajectory in the Riccati kernels' ``[T,
entries, B]`` layout, and K2 and K8 take the Riccati kernels' policy in
that layout as it is (``policy_lane``). On CUDA tensors the wrappers
launch the CUDA kernels of ``csrc/rollout.cuh`` (the env step compiled in,
selected by ``Env.device_step``; K8's by ``Env.device_derivatives``) or
raise; on CPU tensors they run the plain PyTorch versions
``linesearch_costs_ref`` / ``rollout_alpha_ref`` /
``linesearch_costs_traj_ref`` / ``rollout_alpha_derivs_ref``. The module
counts kernel launches and plain-version calls per wrapper. A bounded
env's controls are clipped to its box after the affine law, in the
kernels as in the plain versions. The four kernels are one tile kernel of
four kinds, each launched with a plan (``rollout_plan``: the lanes a
rollout, the scenarios a block, the steps staged ahead and the shared
bytes), unrolled at the dims it is instantiated for (``unrolled_dims``).
K2, K3 and K5 run every other 1 <= n, m <= ``GENERIC_DIM_MAX`` in the
generic form (``csrc/rollout_generic.cuh``: n, m and the lanes a rollout
at run time), and K8 every other n = m <= ``DERIVS_DIM_MAX``, counted
under ``*_GENERIC_LAUNCHES``. An env without a hand-written functor runs
K2, K3 and K5 in the generic form with a functor generated from its
PyTorch step (``Env.generic_device_step``, ``env_codegen.py``; env id
``USER_STEP_ID``), from a library of its own (``_build.user_library``),
counted under ``*_USER_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from tfmpc_tpu_torch.models.base import USER_STEP_ID
from tfmpc_tpu_torch.models.hvac import HVAC_STEP_ID
from tfmpc_tpu_torch.models.linear import LINEAR_STEP_ID
from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.ops import _build, env_codegen, riccati

COSTS_LAUNCHES = 0
COSTS_PLAIN_CALLS = 0
ALPHA_LAUNCHES = 0
ALPHA_PLAIN_CALLS = 0
TRAJ_LAUNCHES = 0
TRAJ_PLAIN_CALLS = 0
DERIVS_LAUNCHES = 0
DERIVS_PLAIN_CALLS = 0
# launches of the generic form (csrc/rollout_generic.cuh), K2, K3 and K5
# at the dims no unrolled instantiation covers; their plain versions count
# in the *_PLAIN_CALLS above
COSTS_GENERIC_LAUNCHES = 0
ALPHA_GENERIC_LAUNCHES = 0
TRAJ_GENERIC_LAUNCHES = 0
DERIVS_GENERIC_LAUNCHES = 0
# launches of K2, K3 and K5 on a generated step functor (a user env,
# csrc/rollout_user.cuh)
COSTS_USER_LAUNCHES = 0
ALPHA_USER_LAUNCHES = 0
TRAJ_USER_LAUNCHES = 0

# (n, m) pairs the unrolled CUDA kernels are instantiated for
# (csrc/rollout.cuh): every env's step at the small dims (rollout.cu, K5's
# rollout_traj.cu), the HVAC step alone at the mid dims (rollout_n12.cu,
# rollout_n16.cu: HVAC-12 and HVAC-16). K2, K3 and K5 run every other
# 1 <= n, m <= GENERIC_DIM_MAX in the generic form
# (csrc/rollout_generic.cuh), the JAX rollout kernels' dims.
KERNEL_DIMS = {(2, 2), (3, 3), (5, 5), (6, 6), (12, 12), (16, 16)}
HVAC_ONLY_DIMS = {(12, 12), (16, 16)}
# (n, m) pairs K8 is instantiated for unrolled (csrc/rollout_derivs.cu),
# with the navigation step, the only env with a device linearization; the
# generic form (csrc/rollout_generic_derivs.cu) runs every other n = m up
# to DERIVS_DIM_MAX (csrc/envs.cuh kDerivsMaxDim), the JAX package's
# fused-iteration ceiling
DERIVS_DIMS = {(2, 2), (3, 3), (5, 5), (6, 6)}
DERIVS_DIM_MAX = 12
GENERIC_DIM_MAX = 48  # csrc/rollout_generic.cuh kGenericMaxDim
MAX_ALPHAS = 32  # size of the alpha array passed by value (csrc/rollout.cuh)
# The launch plans of the tile kernel's kinds, ``rollout_plan``: K2
# ("costs"), K3 ("alpha"), K5 ("traj") and K8 ("derivs"). A block holds
# ``spb`` scenarios (K2, K5: each with all A alphas) and a rollout runs on
# G consecutive lanes (csrc/rollout.cuh rollout_tile_kernel): lane l
# computes the control and next-state rows l, l + G, ... and stores its
# own rows of the outputs; one more warp copies D steps of inputs ahead
# into shared memory. ROLLOUT_PLANS gives, per kind and dim, (G, the
# blocks a launch aims at, D): the fastest plan of
# ``tools/kernel_versions.py rollout --sweep`` on one H100 at the paths'
# shapes (PERF.md section 6), its blocks kept at other batches. The G of
# each entry is the one the sources instantiate (csrc/rollout.cuh
# kPlanGroups), so another G raises at launch.
ROLLOUT_PLANS = {
    "costs": {2: (1, 512, 2), 3: (1, 512, 2), 5: (4, 128, 2),
              6: (2, 512, 2), 12: (4, 256, 2), 16: (2, 128, 2)},
    "alpha": {2: (2, 512, 2), 3: (4, 512, 2), 5: (8, 256, 2),
              6: (8, 512, 2), 12: (4, 256, 2), 16: (16, 128, 2)},
    "traj": {2: (1, 512, 2), 3: (1, 256, 2), 5: (4, 128, 2),
             6: (2, 256, 2), 12: (2, 128, 2), 16: (4, 128, 2)},
    "derivs": {2: (2, 512, 2), 3: (1, 512, 2), 5: (2, 256, 2),
               6: (2, 256, 2)},
}
# The generic form's plans, by kind and env family: (the largest max(n, m)
# a row takes, (G, the blocks a launch aims at, D)), rows in ascending
# order. G is a run-time value there (any power of two up to 32). The
# linear step's stage cost, n^2 + nm + m^2 terms summed on lane 0 of a
# rollout's group, is most of its step, so it runs best on few lanes a
# rollout; the other envs' rows are most of theirs, so they take more
# lanes as n grows. The fastest plan of ``tools/kernel_versions.py rollout
# --generic-sweep`` on one H100 at the shapes of chip_smoke.py's phase 29
# (the double integrator for the linear rows at 2, (24, 6) at 24, (48, 48)
# at 48; reservoir-12 at 12, HVAC-24 for the rest; PERF.md section 6),
# its blocks kept at other batches. The other envs' row at 4 serves
# reservoir-4 and navigation-4, whose fastest plans differ: it is within
# 2.1% of the fastest for both envs' K3 and navigation-4's K2, and
# 1.28-1.38x off for reservoir-4's K2 and K5 and navigation-4's K5.
# ``rollout_plan`` lowers D where one scenario a block does not fit the
# shared memory (the linear env's parameters at n = m = 48 in float64 take
# 113 KB). A user env's generated step (``USER_STEP_ID``) takes the
# ``"user"`` rows, or the ``"linear"`` ones where its serial work is large
# (``plan_family``): ``--generic-sweep user`` on one H100 found the
# ``"other"`` rows 1.19-1.52x the fastest plans at the custom-env example's
# chain (d = 6, B=512, T=40), whose fastest plans at d = 6, 12 and 24 are
# the ``"user"`` rows (within 5.1% of the fastest at d = 48), and the
# ``"user"`` rows 1.07-1.77x the fastest at the (8, 3) fuzz env (its stage
# cost's quadratic forms: serial work 0.9x its next state's), whose
# fastest plans the ``"linear"`` rows match within 1% (PERF.md section 6).
GENERIC_PLANS = {
    "costs": {"linear": ((2, (1, 512, 1)), (48, (4, 128, 1))),
              "other": ((4, (2, 256, 1)), (12, (4, 128, 1)),
                        (48, (8, 128, 1))),
              "user": ((48, (8, 128, 1)),)},
    "alpha": {"linear": ((2, (2, 128, 1)), (24, (8, 128, 1)),
                         (48, (16, 128, 1))),
              "other": ((4, (4, 256, 1)), (12, (16, 512, 1)),
                        (48, (16, 128, 1))),
              "user": ((48, (16, 128, 1)),)},
    "traj": {"linear": ((2, (1, 128, 1)), (24, (4, 128, 1)),
                        (48, (2, 128, 1))),
             "other": ((4, (2, 256, 1)), (12, (4, 128, 1)),
                       (48, (8, 128, 1))),
             "user": ((48, (8, 128, 1)),)},
    # K8, navigation only, n = m <= DERIVS_DIM_MAX: the fastest plans of
    # ``--generic-sweep derivs`` at chip_smoke.py phase 30's G4 (n = 4,
    # B=4096, T=100) and G5 (n = 12, B=1024, T=50) shapes
    "derivs": {"other": ((4, (8, 256, 1)), (12, (16, 128, 1)))},
}
GENERIC_GROUPS = (1, 2, 4, 8, 16, 32)
# the kinds' codes in the C entries (csrc/rollout.cuh RolloutKind)
KIND_CODES = {"costs": 0, "alpha": 1, "traj": 2, "derivs": 3}
# the kinds that roll every alpha of the grid (the others one a scenario)
EVERY_ALPHA = ("costs", "traj")
TILE_MAX_THREADS = 1024  # csrc/rollout.cuh kTileMaxThreads
TILE_MAX_SPB = 32
TILE_MAX_DEPTH = 6
SMEM_LIMIT = 232448  # a block's shared memory on the H100
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
# K8's linearization blocks, in the order of its C entry
D_KEYS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux")


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """A tile launch: ``groups`` lanes a rollout, ``scenarios`` a block,
    ``depth`` steps staged ahead, and the block's dynamic shared bytes,
    which the C side recomputes and must equal. Rollout r of a block is
    scenario ``r % scenarios`` at alpha ``r // scenarios`` (K2, K5; K3 and
    K8 have one rollout a scenario) on threads ``r * groups`` to ``+ groups
    - 1``; the compute threads are whole warps, and one more warp copies
    the inputs."""

    groups: int
    scenarios: int
    depth: int
    smem_bytes: int
    generic: bool = False  # the generic form (csrc/rollout_generic.cuh)

    def threads(self, rollouts_per_scenario: int = 1) -> int:
        return -(-self.scenarios * rollouts_per_scenario * self.groups
                 // 32) * 32 + 32

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def tile_stride(spb: int, groups: int, itemsize: int) -> int:
    """The ring's row stride in values (csrc/rollout.cuh tile_stride): spb,
    or an odd multiple of the rollouts a warp where that keeps a group's
    reads of consecutive rows on distinct banks and the 16-byte copies
    aligned."""
    w = 32 // groups
    vmax = min(spb, 16 // itemsize)
    if groups == 1 or spb <= w or w % vmax:
        return spb
    return spb + w


def rollout_smem_bytes(n: int, m: int, groups: int, spb: int, depth: int,
                       param_elems: int, dtype) -> int:
    """A tile block's shared bytes (csrc/rollout.cuh tile_smem_bytes): the
    env's ``param_elems`` parameter values and the box, rounded to 16
    bytes, then ``depth + 2`` staged steps of ``n + 2m + nm`` rows."""
    item = _ITEMSIZE[dtype]
    chunk = 16 // item
    par = -(-(param_elems + 2 * m) // chunk) * chunk
    rows = n + 2 * m + n * m
    return (par + (depth + 2) * rows * tile_stride(spb, groups, item)) * item


def generic_smem_bytes(n: int, m: int, groups: int, spb: int, depth: int,
                       param_elems: int, dtype, rollouts: int) -> int:
    """A generic block's shared bytes (csrc/rollout_generic.cuh
    generic_smem_bytes): ``rollout_smem_bytes``, then the state of every
    compute group, x_t and x_{t+1} [n] and u_t [m] a group, for
    ``rollouts`` rollouts a block (spb, times A for K2 and K5)."""
    lanes = -(-rollouts * groups // 32) * 32
    return (rollout_smem_bytes(n, m, groups, spb, depth, param_elems, dtype)
            + (2 * n + m) * (lanes // groups) * _ITEMSIZE[dtype])


def derivs_dims(n: int, m: int) -> bool:
    """Whether K8 runs at (n, m): n = m <= ``DERIVS_DIM_MAX`` (unrolled at
    ``DERIVS_DIMS``, the generic form elsewhere)."""
    return n == m and 1 <= n <= DERIVS_DIM_MAX


def unrolled_dims(env_id: int, n: int, m: int, kernel: str = "costs") -> bool:
    """Whether an unrolled instantiation of ``kernel`` runs the env
    ``env_id`` at (n, m): every env at the small ``KERNEL_DIMS``, the HVAC
    step alone at ``HVAC_ONLY_DIMS``; K8 (``"derivs"``) at ``DERIVS_DIMS``.
    The generic form takes every other dim, and every dim of a generated
    step (``USER_STEP_ID``)."""
    if env_id == USER_STEP_ID:
        return False
    if kernel == "derivs":
        return (n, m) in DERIVS_DIMS
    return (n, m) in KERNEL_DIMS and (
        (n, m) not in HVAC_ONLY_DIMS or env_id == HVAC_STEP_ID)


def plan_family(a):
    """The ``GENERIC_PLANS`` family of the step of ``kernel_args`` output
    ``a``: None (its env id's) for a hand-written step. A generated step
    whose serial work a step (``prep`` and the stage cost, which a lane
    computes whole) is at least half its next state's (n rows) takes the
    ``"linear"`` rows, whose few lanes a rollout suit a step bound by its
    serial cost, as the linear env's is; any other the ``"user"`` rows."""
    if a["env_id"] != USER_STEP_ID:
        return None
    serial, row = a["work"]
    return "linear" if 2 * serial >= a["dims"][2] * row else "user"


def generic_row(kernel: str, env_id: int, n: int, m: int,
                family: str | None = None):
    """``GENERIC_PLANS``' (G, blocks, D) of ``kernel`` for the env
    ``env_id`` at (n, m), from the rows of ``family`` (by default the
    linear env's for it, the ``"other"`` rows for the rest)."""
    if family is None:
        family = "linear" if env_id == LINEAR_STEP_ID else "other"
    for ceiling, row in GENERIC_PLANS[kernel][family]:
        if max(n, m) <= ceiling:
            return row
    raise NotImplementedError(
        f"the rollout kernels take 1 <= n, m <= {GENERIC_DIM_MAX}, got "
        f"{(n, m)}")


def _generic_plan(kernel, env_id, n, m, B, A, dtype, param_elems, groups,
                  scenarios, depth, max_threads,
                  family=None) -> RolloutPlan:
    """``rollout_plan`` of the generic form: ``GENERIC_PLANS``' G and D, D
    lowered (to 1 at the least) until one scenario a block fits the shared
    memory, then the largest power of two of scenarios a block as the
    unrolled rule takes it."""
    G, blocks, D = generic_row(kernel, env_id, n, m, family)
    G = groups or G
    per = A if kernel in EVERY_ALPHA else 1
    if G not in GENERIC_GROUPS:
        raise ValueError(f"plan G={G}: G is a power of two <= 32")

    def fits(spb, D):
        return (-(-spb * per * G // 32) * 32 + 32 <= max_threads
                and generic_smem_bytes(n, m, G, spb, D, param_elems, dtype,
                                       spb * per) <= SMEM_LIMIT)

    if depth is None:
        while D > 1 and not fits(1, D):
            D -= 1
    else:
        D = depth
    if not 1 <= D <= TILE_MAX_DEPTH:
        raise ValueError(f"plan D={D}: 1 <= D <= {TILE_MAX_DEPTH}")
    if scenarios is None:
        spb = 1
        while 2 * spb <= min(-(-B // blocks), TILE_MAX_SPB) \
                and fits(2 * spb, D):
            spb *= 2
    else:
        spb = scenarios
    if spb & (spb - 1) or not 1 <= spb <= TILE_MAX_SPB:
        raise ValueError(f"{spb} scenarios a block: a power of two <= "
                         f"{TILE_MAX_SPB}")
    if not fits(spb, D) and env_id == USER_STEP_ID:
        raise NotImplementedError(
            f"the generated step's {param_elems} parameter values do not fit "
            f"a {kernel} block's shared memory at (n, m) = {(n, m)} (G={G}, "
            f"{spb} scenario(s) a block, D={D}, {SMEM_LIMIT} bytes); "
            f"{env_codegen.OPT_OUTS}")
    if not fits(spb, D):
        raise ValueError(
            f"no generic {kernel} plan fits at (n, m) = {(n, m)}: G={G}, "
            f"{spb} scenario(s) a block, D={D} exceed {max_threads} threads "
            f"or {SMEM_LIMIT} shared bytes")
    return RolloutPlan(groups=G, scenarios=spb, depth=D,
                       smem_bytes=generic_smem_bytes(
                           n, m, G, spb, D, param_elems, dtype, spb * per),
                       generic=True)


@functools.cache
def rollout_plan(kernel: str, env_id: int, n: int, m: int, B: int, A: int,
                 dtype, param_elems: int, groups: int | None = None,
                 scenarios: int | None = None, depth: int | None = None,
                 max_threads: int = TILE_MAX_THREADS,
                 family: str | None = None) -> RolloutPlan:
    """The launch plan of K2 (``kernel="costs"``, A alphas), K3
    (``"alpha"``), K5 (``"traj"``, A alphas) or K8 (``"derivs"``) at (n, m)
    for B scenarios of the env ``env_id`` with ``param_elems`` parameter
    values. Where an unrolled instantiation runs (``unrolled_dims``; K8's
    at ``DERIVS_DIMS``): ``ROLLOUT_PLANS``' G and depth and
    the largest power of two of scenarios a block that does not exceed B
    over the table's blocks, at most ``TILE_MAX_SPB``, ``max_threads``
    threads (``kernel_max_threads``: the kernel's registers bound it) and
    ``SMEM_LIMIT`` shared bytes. Elsewhere up to ``GENERIC_DIM_MAX`` (K8:
    n = m <= ``DERIVS_DIM_MAX``) the generic form's plan (``generic=True``,
    ``_generic_plan``; ``family``: ``plan_family``). ``groups``,
    ``scenarios`` and ``depth`` override the table (the sweep's plans)."""
    if kernel == "derivs" and not derivs_dims(n, m):
        raise NotImplementedError(
            f"K8 takes n = m <= {DERIVS_DIM_MAX}, got {(n, m)} (the JAX "
            "package's fused-iteration ceiling; the solver takes the split "
            "iteration above it)")
    if not unrolled_dims(env_id, n, m, kernel):
        if not (1 <= n <= GENERIC_DIM_MAX and 1 <= m <= GENERIC_DIM_MAX):
            raise NotImplementedError(
                f"the rollout kernels take 1 <= n, m <= {GENERIC_DIM_MAX}, "
                f"got {(n, m)}")
        return _generic_plan(kernel, env_id, n, m, B, A, dtype, param_elems,
                             groups, scenarios, depth, max_threads, family)
    G, blocks, D = ROLLOUT_PLANS[kernel][n]
    G, D = groups or G, depth or D
    if G not in (1, 2, 4, 8, 16) or not 1 <= D <= TILE_MAX_DEPTH:
        raise ValueError(f"plan G={G}, D={D}: G is a power of two <= 16, "
                         f"1 <= D <= {TILE_MAX_DEPTH}")
    per = A if kernel in EVERY_ALPHA else 1
    if scenarios is None:
        spb = 1
        while (2 * spb <= min(-(-B // blocks), TILE_MAX_SPB)
               and -(-2 * spb * per * G // 32) * 32 + 32 <= max_threads
               and rollout_smem_bytes(n, m, G, 2 * spb, D, param_elems,
                                      dtype) <= SMEM_LIMIT):
            spb *= 2
    else:
        spb = scenarios
    if spb & (spb - 1) or not 1 <= spb <= TILE_MAX_SPB:
        raise ValueError(f"{spb} scenarios a block: a power of two <= "
                         f"{TILE_MAX_SPB}")
    return RolloutPlan(groups=G, scenarios=spb, depth=D,
                       smem_bytes=rollout_smem_bytes(n, m, G, spb, D,
                                                     param_elems, dtype))


_MAX_THREADS: dict = {}


def kernel_max_threads(kernel: str, a, generic: bool | None = None) -> int:
    """The most threads a block of the kind ``kernel`` (a key of
    ``ROLLOUT_PLANS``) can launch with at the plan's G for ``kernel_args``
    output ``a``: the kernel's registers bound it (at most
    ``TILE_MAX_THREADS``). Asked of the library once per kind, dtype, env
    and dims (the generic form's, once per kind, dtype and env: its G is a
    run-time value). ``generic`` picks the form (by default the one that
    runs at the dims)."""
    B, T, n, m = a["dims"]
    if generic is None:
        generic = not unrolled_dims(a["env_id"], n, m, kernel)
    if a["env_id"] == USER_STEP_ID:
        key = (kernel, a["dtype"], a["source"])
        if key not in _MAX_THREADS:
            lib = _build.user_library(a["source"])
            got = lib.tfmpc_rollout_user_max_threads(
                KIND_CODES[kernel], _build.DTYPE_CODES[a["dtype"]], n, m,
                *_env_pointers(a))
            if got <= 0:
                _build.check(-got, "rollout_user_max_threads", lib)
            _MAX_THREADS[key] = got
        return _MAX_THREADS[key]
    if generic:
        key = (kernel, a["dtype"], a["env_id"], "generic")
        if key not in _MAX_THREADS:
            got = _build.library().tfmpc_rollout_generic_max_threads(
                KIND_CODES[kernel], _build.DTYPE_CODES[a["dtype"]],
                a["env_id"], n, m, *_env_pointers(a))
            if got <= 0:
                _build.check(-got, "rollout_generic_max_threads")
            _MAX_THREADS[key] = got
        return _MAX_THREADS[key]
    G = ROLLOUT_PLANS[kernel][n][0]
    key = (kernel, a["dtype"], a["env_id"], n, m, G)
    if key not in _MAX_THREADS:
        params, n_params, ints, n_ints = _env_pointers(a)
        got = _build.library().tfmpc_rollout_max_threads(
            KIND_CODES[kernel], _build.DTYPE_CODES[a["dtype"]],
            a["env_id"], n, m, G, params, n_params, ints, n_ints)
        if got <= 0:
            _build.check(-got, "rollout_max_threads")
        _MAX_THREADS[key] = got
    return _MAX_THREADS[key]


def launch_plan(a, kernel: str, A: int = 1) -> RolloutPlan:
    """The plan of a launch of the kind ``kernel`` on ``kernel_args``
    output ``a``."""
    B, T, n, m = a["dims"]
    return rollout_plan(kernel, a["env_id"], n, m, B, A, a["dtype"],
                        sum(p.numel() for p in a["params"]),
                        max_threads=kernel_max_threads(kernel, a),
                        family=plan_family(a))


def generic_launch_plan(a, kernel: str, A: int = 1) -> RolloutPlan:
    """The generic form's plan of ``kernel`` (K2, K3, K5, K8) on
    ``kernel_args`` output ``a`` at any dims up to ``GENERIC_DIM_MAX``,
    those of an unrolled instantiation included (where ``launch_plan``
    takes the unrolled one): to hold and time the generic form there."""
    B, T, n, m = a["dims"]
    return _generic_plan(kernel, a["env_id"], n, m, B, A, a["dtype"],
                         sum(p.numel() for p in a["params"]), None, None,
                         None, kernel_max_threads(kernel, a, generic=True),
                         plan_family(a))


def _plan_args(a, kernel, A=1):
    """The plan of a ``kernel_args`` launch, as the C entries take it."""
    plan = launch_plan(a, kernel, A)
    return (plan.groups, plan.scenarios, plan.depth,
            ctypes.c_longlong(plan.smem_bytes))


def _finite_or_inf(J):
    return torch.where(torch.isfinite(J), J, torch.full_like(J, torch.inf))


def closed_loop_rollout(env, X, U, K, k, alpha):
    """Plain PyTorch closed-loop rollout with step size ``alpha``.

    ``X [..., T+1, n]`` and ``U [..., T, m]`` are the nominal trajectory,
    ``K [..., T, m, n]`` / ``k [..., T, m]`` the policy; ``alpha``
    broadcasts against the leading dims. The control law is
    ``u = clip(ubar + alpha k + K (x - xbar))`` from ``x_0 = X[..., 0, :]``.
    Returns ``(X_new [..., T+1, n], U_new [..., T, m], J [...])`` with
    ``J = +inf`` wherever the rollout blew up, so a diverging candidate is
    always rejected.
    """
    T = U.shape[-2]
    batch = torch.broadcast_shapes(X.shape[:-2], alpha.shape)
    alpha = alpha[..., None]
    x = X[..., 0, :].expand(batch + X.shape[-1:])
    xs, us, costs = [x], [], []
    for t in range(T):
        dx = x - X[..., t, :]
        u = U[..., t, :] + alpha * k[..., t, :]
        u = u + (K[..., t, :, :] * dx[..., None, :]).sum(dim=-1)
        u = env.clip(u)
        costs.append(env.cost(x, u))
        x = env.transition(x, u)
        xs.append(x)
        us.append(u)
    J = torch.stack(costs, dim=-1).sum(dim=-1) + env.final_cost(x)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2), _finite_or_inf(J)


def linesearch_costs_ref(env, X, U, policy, alphas: Sequence[float]):
    """Plain version of K2: ``J_all [B, A]`` for ``X [B, T+1, n]``,
    ``U [B, T, m]``, ``policy`` ``[B, T, ...]`` and the alpha grid."""
    a = torch.as_tensor(alphas, dtype=X.dtype, device=X.device)
    return closed_loop_rollout(
        env, X[:, None], U[:, None], policy.K[:, None], policy.k[:, None],
        a[None, :],
    )[2]


def rollout_alpha_ref(env, X, U, policy, alpha_vec):
    """Plain version of K3: the rollout at each scenario's ``alpha_vec [B]``.
    Returns ``(X_new [B, T+1, n], U_new [B, T, m], J [B])``."""
    return closed_loop_rollout(
        env, X, U, policy.K, policy.k, alpha_vec.to(X.dtype)
    )


def linesearch_costs_traj_ref(env, X, U, policy, alphas: Sequence[float]):
    """Plain version of K5: ``(J_all [B, A], X_all [T, A, n, B], U_all [T,
    A, m, B])``, the trajectories ``x_{t+1}`` and ``u_t`` of every alpha in
    the kernel's layout."""
    a = torch.as_tensor(alphas, dtype=X.dtype, device=X.device)
    X_new, U_new, J = closed_loop_rollout(
        env, X[:, None], U[:, None], policy.K[:, None], policy.k[:, None],
        a[None, :],
    )
    return J, X_new[:, :, 1:].permute(2, 1, 3, 0), U_new.permute(2, 1, 3, 0)


def select_alpha_trajectory(X, X_all, U_all, J_all, best):
    """Each scenario's trajectory at its accepted alpha ``best [B]`` from the
    all-alpha blocks of ``linesearch_costs_traj``: ``(X_new [B, T+1, n],
    U_new [B, T, m], J_best [B])``, equal to ``rollout_alpha`` at
    ``alphas[best]``. A gather on the alpha axis, not a one-hot product: a
    diverged candidate may hold inf or NaN, and ``0 * inf`` is NaN."""
    T, _, n, B = X_all.shape
    m = U_all.shape[2]
    pick = lambda a, e: a.gather(  # noqa: E731
        1, best.view(1, 1, 1, B).expand(T, 1, e, B))[:, 0]   # [T, e, B]
    X_new = torch.cat([X[:, :1], pick(X_all, n).permute(2, 0, 1)], dim=1)
    J_best = J_all.gather(1, best[:, None])[:, 0]
    return X_new, pick(U_all, m).permute(2, 0, 1), J_best


def policy_from_lanes(policy_lane):
    """The solver-layout ``Policy`` of a kernel-layout one ``(K [T, m*n,
    B], k [T, m, B])``."""
    K, k = policy_lane
    T, mn, B = K.shape
    m = k.shape[1]
    return Policy(K=K.permute(2, 0, 1).reshape(B, T, m, mn // m),
                  k=k.permute(2, 0, 1))


def kernel_args(env, X, U, policy, policy_lane=None, derivatives=False,
                step=None):
    """Check that the CUDA kernels cover this call (raises if not) and lay
    its inputs out for them (``kernel_layout``)."""
    if X.device.type != "cuda":
        raise ValueError(f"the CUDA kernels need CUDA tensors, got {X.device}")
    return kernel_layout(env, X, U, policy, policy_lane, derivatives, step)


def kernel_layout(env, X, U, policy, policy_lane=None, derivatives=False,
                  step=None):
    """The kernels' inputs, on the tensors' own device: ``[T, entries, B]``
    trajectories and policy, the box ``lo``/``hi [m]`` (None for an
    unbounded env), and the env step's id and parameters. A kernel-layout
    ``policy_lane = (K [T, m*n, B], k [T, m, B])`` is taken as it is
    (``policy`` is then unused). With ``derivatives``, K8's: the env's
    ``device_derivatives`` functor at n = m <= ``DERIVS_DIM_MAX``. A
    generated step (``USER_STEP_ID``) is traced at the call's dtype and
    device (``Env.generic_device_step``), its source under ``"source"``;
    ``step`` overrides the env's (a shipped env's generated step, to hold it
    against the hand-written one). Raises for a dtype, env or dims the
    kernels do not cover: an env whose device step is None, K8 outside
    ``derivs_dims`` and any dim above
    ``GENERIC_DIM_MAX`` (K2, K3 and K5 take every 1 <= n, m <= 48, and K8
    every n = m <= 12, in the generic form where no unrolled instantiation
    runs)."""
    if X.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32/float64, got {X.dtype}")
    if step is None:
        step = env.device_derivatives() if derivatives else env.device_step()
        if step is not None and step.env_id == USER_STEP_ID:
            step = env.generic_device_step(X.dtype, X.device)
    if step is None:
        what = ("device derivatives compiled into K8" if derivatives
                else "device step compiled into the rollout kernels: its "
                "device_step() returns None")
        raise NotImplementedError(
            f"{type(env).__name__} has no {what}; run with use_pallas=False"
        )
    B, T, m = U.shape
    n = X.shape[-1]
    if derivatives and not derivs_dims(n, m):
        raise NotImplementedError(
            f"K8 takes n = m <= {DERIVS_DIM_MAX}, got {(n, m)} (the JAX "
            "package's fused-iteration ceiling); run with "
            "fuse_derivatives=False"
        )
    if not (1 <= n <= GENERIC_DIM_MAX and 1 <= m <= GENERIC_DIM_MAX):
        raise NotImplementedError(
            f"the rollout kernels take 1 <= n, m <= {GENERIC_DIM_MAX}, got "
            f"{(n, m)}; the solver runs the plain rollout above it"
        )
    params = [
        p.to(dtype=X.dtype, device=X.device).contiguous() for p in step.params
    ]
    if policy_lane is None:
        K = policy.K.reshape(B, T, m * n).permute(1, 2, 0)
        k = policy.k.permute(1, 2, 0)
    else:
        K, k = policy_lane
    if env.bounds is None:
        lo = hi = None
    else:
        lo, hi = (torch.broadcast_to(a.to(dtype=X.dtype, device=X.device),
                                     (m,)).contiguous()
                  for a in (env.bounds.low, env.bounds.high))
    return dict(
        dims=(B, T, n, m),
        dtype=X.dtype,
        env_id=step.env_id,
        xbar=X[:, :-1].permute(1, 2, 0).contiguous(),           # [T, n, B]
        ubar=U.permute(1, 2, 0).contiguous(),                   # [T, m, B]
        K=K.contiguous(),                                       # [T, m*n, B]
        k=k.contiguous(),                                       # [T, m, B]
        lo=lo,                                                  # [m] or None
        hi=hi,
        params=params,
        int_params=step.int_params,
        source=step.source,
        work=step.work,
    )


def _bound_pointers(a):
    """Device pointers of ``lo``/``hi``, null for an unbounded env."""
    if a["lo"] is None:
        return ctypes.c_void_p(None), ctypes.c_void_p(None)
    return _build.ptr(a["lo"]), _build.ptr(a["hi"])


def _env_pointers(a):
    params, ints = a["params"], a["int_params"]
    return (
        (ctypes.c_void_p * len(params))(*[p.data_ptr() for p in params]),
        len(params),
        (ctypes.c_int * len(ints))(*ints),
        len(ints),
    )


def _launch_generic(a, kernel, plan, J, X=None, U=None, alphas=(),
                    alpha=None, kargs=None):
    """Launch the generic form's ``kernel`` (K2, K3, K5, or K8 with its
    ``D_KEYS`` output blocks ``kargs``) with ``plan`` on ``kernel_args``
    output ``a`` (a generated step's from its user library); returns the C
    entry's code."""
    B, T, n, m = a["dims"]
    null = ctypes.c_void_p(None)
    A = len(alphas) or 1
    lin = None if kargs is None else (ctypes.c_void_p * len(D_KEYS))(
        *[kargs[key].data_ptr() for key in D_KEYS])
    if a["env_id"] == USER_STEP_ID:
        call = functools.partial(
            _build.user_library(a["source"]).tfmpc_rollout_user,
            KIND_CODES[kernel], _build.DTYPE_CODES[a["dtype"]])
    else:
        call = functools.partial(
            _build.library().tfmpc_rollout_generic, KIND_CODES[kernel],
            _build.DTYPE_CODES[a["dtype"]], a["env_id"])
    return call(
        n, m, T, B,
        *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
        *_bound_pointers(a),
        (ctypes.c_double * A)(*map(float, alphas)) if alphas else None, A,
        null if alpha is None else _build.ptr(alpha), *_env_pointers(a),
        _build.ptr(J), null if X is None else _build.ptr(X),
        null if U is None else _build.ptr(U), lin, plan.groups,
        plan.scenarios, plan.depth, ctypes.c_longlong(plan.smem_bytes),
        _build.stream())


def _check_generic(rc, what, a):
    """``_build.check`` of a generic-form launch (a generated step's in its
    user library)."""
    if a["env_id"] == USER_STEP_ID:
        _build.check(rc, f"{what} (generated step)",
                     _build.user_library(a["source"]))
    else:
        _build.check(rc, f"{what} (generic)")


def linesearch_costs_kernel(a, alphas: Sequence[float]):
    """Launch K2 on ``kernel_args`` output: raw ``J [A, B]``. The unrolled
    instantiation runs where one covers the env and dims
    (``COSTS_LAUNCHES``), the generic form elsewhere
    (``COSTS_GENERIC_LAUNCHES``; on a generated step
    ``COSTS_USER_LAUNCHES``)."""
    global COSTS_LAUNCHES, COSTS_GENERIC_LAUNCHES, COSTS_USER_LAUNCHES
    B, T, n, m = a["dims"]
    A = len(alphas)
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"linesearch_costs takes 1..{MAX_ALPHAS} alphas")
    J = torch.empty((A, B), dtype=a["dtype"], device=a["xbar"].device)
    plan = launch_plan(a, "costs", A)
    if plan.generic:
        _check_generic(_launch_generic(a, "costs", plan, J, alphas=alphas),
                       "linesearch_costs", a)
        if a["env_id"] == USER_STEP_ID:
            COSTS_USER_LAUNCHES += 1
        else:
            COSTS_GENERIC_LAUNCHES += 1
        return J
    rc = _build.library().tfmpc_linesearch_costs(
        _build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B,
        *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
        *_bound_pointers(a),
        (ctypes.c_double * A)(*map(float, alphas)), A, *_env_pointers(a),
        _build.ptr(J), *_plan_args(a, "costs", A), _build.stream(),
    )
    _build.check(rc, "linesearch_costs")
    COSTS_LAUNCHES += 1
    return J


def linesearch_costs_traj_kernel(a, alphas: Sequence[float]):
    """Launch K5 on ``kernel_args`` output: raw ``(J [A, B], X [T, A*n, B],
    U [T, A*m, B])``, row ``a*n + i`` of step t holding ``x_{t+1, i}`` of
    alpha ``a`` (``a*m + c``: ``u_{t, c}``). The generic form where no
    unrolled instantiation runs (``TRAJ_GENERIC_LAUNCHES``; on a generated
    step ``TRAJ_USER_LAUNCHES``)."""
    global TRAJ_LAUNCHES, TRAJ_GENERIC_LAUNCHES, TRAJ_USER_LAUNCHES
    B, T, n, m = a["dims"]
    A = len(alphas)
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"linesearch_costs_traj takes 1..{MAX_ALPHAS} "
                         "alphas")
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    J = torch.empty((A, B), **opts)
    X_out = torch.empty((T, A * n, B), **opts)
    U_out = torch.empty((T, A * m, B), **opts)
    plan = launch_plan(a, "traj", A)
    if plan.generic:
        _check_generic(_launch_generic(a, "traj", plan, J, X_out, U_out,
                                       alphas=alphas),
                       "linesearch_costs_traj", a)
        if a["env_id"] == USER_STEP_ID:
            TRAJ_USER_LAUNCHES += 1
        else:
            TRAJ_GENERIC_LAUNCHES += 1
        return J, X_out, U_out
    rc = _build.library().tfmpc_linesearch_costs_traj(
        _build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B,
        *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
        *_bound_pointers(a),
        (ctypes.c_double * A)(*map(float, alphas)), A, *_env_pointers(a),
        _build.ptr(J), _build.ptr(X_out), _build.ptr(U_out),
        *_plan_args(a, "traj", A), _build.stream(),
    )
    _build.check(rc, "linesearch_costs_traj")
    TRAJ_LAUNCHES += 1
    return J, X_out, U_out


def rollout_alpha_kernel(a, alpha):
    """Launch K3 on ``kernel_args`` output and per-lane ``alpha [B]``:
    raw ``(X [T, n, B], U [T, m, B], J [B])``. The generic form where no
    unrolled instantiation runs (``ALPHA_GENERIC_LAUNCHES``; on a generated
    step ``ALPHA_USER_LAUNCHES``)."""
    global ALPHA_LAUNCHES, ALPHA_GENERIC_LAUNCHES, ALPHA_USER_LAUNCHES
    B, T, n, m = a["dims"]
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    if alpha.shape != (B,) or alpha.dtype != a["dtype"] \
            or alpha.device != opts["device"] or not alpha.is_contiguous():
        raise ValueError("alpha must be a contiguous [B] tensor of the "
                         "trajectory's dtype and device")
    X_out = torch.empty((T, n, B), **opts)
    U_out = torch.empty((T, m, B), **opts)
    J = torch.empty((B,), **opts)
    plan = launch_plan(a, "alpha")
    if plan.generic:
        _check_generic(_launch_generic(a, "alpha", plan, J, X_out, U_out,
                                       alpha=alpha),
                       "rollout_alpha", a)
        if a["env_id"] == USER_STEP_ID:
            ALPHA_USER_LAUNCHES += 1
        else:
            ALPHA_GENERIC_LAUNCHES += 1
        return X_out, U_out, J
    rc = _build.library().tfmpc_rollout_alpha(
        _build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B,
        _build.ptr(alpha),
        *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
        *_bound_pointers(a), *_env_pointers(a),
        _build.ptr(X_out), _build.ptr(U_out), _build.ptr(J),
        *_plan_args(a, "alpha"), _build.stream(),
    )
    _build.check(rc, "rollout_alpha")
    ALPHA_LAUNCHES += 1
    return X_out, U_out, J


def linesearch_costs(env, X, U, policy, alphas: Sequence[float],
                     policy_lane=None):
    """Total cost of the closed-loop rollout for every (scenario, alpha):
    ``J_all [B, A]``. ``alphas`` are Python floats
    (``ILQRConfig.alphas_static()``), passed to the kernel by value. The
    policy is ``policy`` or, in the Riccati kernels' layout, ``policy_lane
    = (K [T, m*n, B], k [T, m, B])``."""
    global COSTS_PLAIN_CALLS
    if X.device.type == "cpu":
        COSTS_PLAIN_CALLS += 1
        if policy_lane is not None:
            policy = policy_from_lanes(policy_lane)
        return linesearch_costs_ref(env, X, U, policy, alphas)
    J = linesearch_costs_kernel(kernel_args(env, X, U, policy, policy_lane),
                                alphas)
    return _finite_or_inf(J).T


def linesearch_costs_traj(env, X, U, policy, alphas: Sequence[float]):
    """``linesearch_costs`` that also returns every alpha's trajectory:
    ``(J_all [B, A], X_all [T, A, n, B], U_all [T, A, m, B])``, the
    trajectories in the kernel's layout (``select_alpha_trajectory`` picks
    from them, then transposes once)."""
    global TRAJ_PLAIN_CALLS
    if X.device.type == "cpu":
        TRAJ_PLAIN_CALLS += 1
        return linesearch_costs_traj_ref(env, X, U, policy, alphas)
    B, T, m = U.shape
    n, A = X.shape[-1], len(alphas)
    J, X_out, U_out = linesearch_costs_traj_kernel(
        kernel_args(env, X, U, policy), alphas)
    return (_finite_or_inf(J).T, X_out.view(T, A, n, B),
            U_out.view(T, A, m, B))


def rollout_alpha(env, X, U, policy, alpha_vec):
    """Materialize the closed-loop rollout at each scenario's own alpha
    ``alpha_vec [B]``: ``(X_new [B, T+1, n], U_new [B, T, m], J [B])``."""
    global ALPHA_PLAIN_CALLS
    if X.device.type == "cpu":
        ALPHA_PLAIN_CALLS += 1
        return rollout_alpha_ref(env, X, U, policy, alpha_vec)
    X_out, U_out, J = rollout_alpha_kernel(
        kernel_args(env, X, U, policy), alpha_vec.to(X.dtype).contiguous()
    )
    X_new = torch.cat([X[:, :1], X_out.permute(2, 0, 1)], dim=1)
    return X_new, U_out.permute(2, 0, 1), _finite_or_inf(J)


def rollout_alpha_derivs_ref(env, X, U, policy, alpha_vec):
    """Plain version of K8: ``rollout_alpha_ref``, then
    ``env.analytic_derivatives`` of the rolled trajectory in the Riccati
    kernels' layout (``riccati._to_kernel_layout``). Returns ``(X_new [B,
    T+1, n], U_new [B, T, m], J [B], kargs)``, ``kargs`` the dict of the
    ``D_KEYS`` blocks ``[T, entries, B]``."""
    X_new, U_new, J = rollout_alpha_ref(env, X, U, policy, alpha_vec)
    lin, quad, final = env.analytic_derivatives(X_new, U_new)
    a = riccati._to_kernel_layout(lin, quad, final, torch.zeros_like(J))
    return X_new, U_new, J, {key: a[key] for key in D_KEYS}


def rollout_alpha_derivs_kernel(a, alpha):
    """Launch K8 on ``kernel_args(..., derivatives=True)`` output and per-lane
    ``alpha [B]``: raw ``(X [T, n, B], U [T, m, B], J [B], kargs)``. The
    generic form outside ``DERIVS_DIMS`` (``DERIVS_GENERIC_LAUNCHES``)."""
    global DERIVS_LAUNCHES, DERIVS_GENERIC_LAUNCHES
    B, T, n, m = a["dims"]
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    if alpha.shape != (B,) or alpha.dtype != a["dtype"] \
            or alpha.device != opts["device"] or not alpha.is_contiguous():
        raise ValueError("alpha must be a contiguous [B] tensor of the "
                         "trajectory's dtype and device")
    X_out = torch.empty((T, n, B), **opts)
    U_out = torch.empty((T, m, B), **opts)
    J = torch.empty((B,), **opts)
    entries = dict(fx=n * n, fu=n * m, lx=n, lu=m, lxx=n * n, luu=m * m,
                   lux=m * n)
    kargs = {key: torch.empty((T, entries[key], B), **opts)
             for key in D_KEYS}
    plan = launch_plan(a, "derivs")
    if plan.generic:
        _build.check(_launch_generic(a, "derivs", plan, J, X_out, U_out,
                                     alpha=alpha, kargs=kargs),
                     "rollout_alpha_derivs (generic)")
        DERIVS_GENERIC_LAUNCHES += 1
        return X_out, U_out, J, kargs
    rc = _build.library().tfmpc_rollout_alpha_derivs(
        _build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B,
        _build.ptr(alpha),
        *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
        *_bound_pointers(a), *_env_pointers(a),
        _build.ptr(X_out), _build.ptr(U_out), _build.ptr(J),
        (ctypes.c_void_p * len(D_KEYS))(*[kargs[key].data_ptr()
                                           for key in D_KEYS]),
        *_plan_args(a, "derivs"), _build.stream(),
    )
    _build.check(rc, "rollout_alpha_derivs")
    DERIVS_LAUNCHES += 1
    return X_out, U_out, J, kargs


def rollout_alpha_derivs(env, X, U, policy, alpha_vec, policy_lane=None):
    """``rollout_alpha`` that also returns the env's closed-form
    linearization of the new trajectory, at each step's pre-step state and
    clipped control: ``(X_new [B, T+1, n], U_new [B, T, m], J [B],
    kargs)``, ``kargs`` the ``D_KEYS`` blocks ``[T, entries, B]`` that the
    Riccati kernels take (entries ``i*n + j`` of f_x, ``i*m + c`` of f_u,
    ``c*n + i`` of l_ux). The policy as in ``linesearch_costs``."""
    global DERIVS_PLAIN_CALLS
    if X.device.type == "cpu":
        DERIVS_PLAIN_CALLS += 1
        if policy_lane is not None:
            policy = policy_from_lanes(policy_lane)
        return rollout_alpha_derivs_ref(env, X, U, policy, alpha_vec)
    X_out, U_out, J, kargs = rollout_alpha_derivs_kernel(
        kernel_args(env, X, U, policy, policy_lane, derivatives=True),
        alpha_vec.to(X.dtype).contiguous())
    X_new = torch.cat([X[:, :1], X_out.permute(2, 0, 1)], dim=1)
    return X_new, U_out.permute(2, 0, 1), _finite_or_inf(J), kargs
