"""K1, K4, K6a and K6b at every n, m <= 12 outside the lane kernels' dims.

Counterpart of ``tfmpc_tpu/ops/riccati_pallas.py``'s four variants,
``riccati_backward_pallas`` (:520, K1), ``riccati_backward_ddp_pallas``
(:545, K6a), ``riccati_backward_boxqp_pallas`` (:585, K4) and
``riccati_backward_ddp_boxqp_pallas`` (:564, K6b), which the JAX package
runs at every n, m <= 12 (its lane kernel's limit). The port's lane
template (``ops/riccati.py``) is instantiated at n = m in ``KERNEL_DIMS``
only; at every other ``1 <= n, m <= SMALL_DIM_MAX`` the solver routes the
backward here, unconstrained or with boxQP, with or without the full-DDP
terms: ``riccati_backward_small``, ``riccati_backward_small_ddp``,
``riccati_backward_small_boxqp`` and ``riccati_backward_small_ddp_boxqp``
take K1's, K6a's, K4's and K6b's inputs (``ops/riccati.py``) and return
``(ok [B], Policy(K [B, T, m, n], k [B, T, m]), dV1 [B], dV2 [B])``. On a
CUDA tensor they launch the CUDA kernel of ``csrc/riccati_small.cuh`` (a
group of G lanes a scenario with its rows in registers, several
scenarios a warp; ``small_plan`` is its launch plan, by variant: ``box``
or not, ``ddp`` or not, and ``small_launch_plan`` the one a launch takes)
or raise; on a CPU tensor they run the plain versions,
``riccati.riccati_backward_ref``, ``riccati_backward_ddp_ref``,
``riccati_backward_boxqp_ref`` and ``riccati_backward_ddp_boxqp_ref``.
Without the box the kernel runs no boxQP: its PD probe's factor gives k
and K.

The kernel clamps every pivot at 1e-30 and computes in double for float32
inputs too, as K7 (``ops/riccati_mid.py``) does: its ok mask equals the
plain version's, and on the ok lanes it is as accurate as the float64
plain version.

The raw launchers take the solver's own layout (``riccati_mid.mid_layout``,
``[B, T, ...]``, contiguous) and a ``plan``. ``small_cover`` repeats the
kernel's map of groups to scenarios, so its plans can be checked on the
CPU.

``SMALL_LAUNCHES``, ``SMALL_DDP_LAUNCHES``, ``SMALL_BOXQP_LAUNCHES`` and
``SMALL_DDP_BOXQP_LAUNCHES`` count kernel launches; the matching
``*_PLAIN_CALLS`` the calls that took the plain version.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from tfmpc_tpu_torch.ops import _build
from tfmpc_tpu_torch.ops.riccati import (
    riccati_backward_boxqp_ref,
    riccati_backward_ddp_boxqp_ref,
    riccati_backward_ddp_ref,
    riccati_backward_ref,
)
from tfmpc_tpu_torch.ops.riccati_mid import (
    MID_ARGS,
    MID_BOXQP_ARGS,
    MID_DDP_ARGS,
    SMEM_LIMIT,
    SMS,
    _result,
    _sm_count,
    mid_layout,
)

SMALL_LAUNCHES = 0
SMALL_PLAIN_CALLS = 0
SMALL_DDP_LAUNCHES = 0
SMALL_DDP_PLAIN_CALLS = 0
SMALL_BOXQP_LAUNCHES = 0
SMALL_BOXQP_PLAIN_CALLS = 0
SMALL_DDP_BOXQP_LAUNCHES = 0
SMALL_DDP_BOXQP_PLAIN_CALLS = 0

# The kernel's envelope (csrc/riccati_small.cuh kSmallMaxDim): the JAX lane
# kernel's limit, every 1 <= n, m <= 12.
SMALL_DIM_MAX = 12
SMALL_MAX_THREADS = 256  # csrc/riccati_small.cuh kSmallMaxThreads
# The threads a block holds at most: the fastest bound, or within 0.2% of
# it, at every path's shape on one H100 (``tools/kernel_versions.py small
# --sweep``, 32-256 threads: all within 1%; PERF.md section 6). A block
# holds as many scenarios as B spread over the SMs asks for, up to this.
SMALL_THREADS = 64
_LS_CANDS = 9  # ops/boxqp.py LS_ALPHAS candidates, and x
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}

riccati_backward_small_ref = riccati_backward_ref
riccati_backward_small_ddp_ref = riccati_backward_ddp_ref
riccati_backward_small_boxqp_ref = riccati_backward_boxqp_ref
riccati_backward_small_ddp_boxqp_ref = riccati_backward_ddp_boxqp_ref

# Argument order of the launchers and of the C entries (K7's: first
# order, boxQP, DDP, final value).
SMALL_ARGS = MID_ARGS
SMALL_DDP_ARGS = MID_DDP_ARGS
SMALL_BOXQP_ARGS = MID_BOXQP_ARGS
SMALL_DDP_BOXQP_ARGS = MID_BOXQP_ARGS[:11] + ("fxx", "fux", "fuu") \
    + MID_BOXQP_ARGS[11:]


def small_kernel_supported(n: int, m: int) -> bool:
    """Whether the kernel runs at these dims: ``1 <= min(n, m)`` and
    ``max(n, m) <= 12``, every variant, float32 and float64 (the solver
    sends it the dims outside ``riccati.KERNEL_DIMS``)."""
    return 1 <= min(n, m) and max(n, m) <= SMALL_DIM_MAX


def small_groups(n: int, m: int) -> int:
    """Lanes a scenario: the smallest power of two >= max(n, m), at least
    2 (csrc/riccati_small.cuh ``small_groups``)."""
    G = 2
    while G < max(n, m):
        G *= 2
    return G


def small_work_doubles(G: int, box: bool = True) -> int:
    """A scenario's workspace in doubles (``small_work_doubles``): ten
    matrices of D rows padded to D | 1, with ``box`` two sets of nine
    candidates, six vectors and the bulk copies' barrier, D = min(G, 12),
    the count made odd."""
    D = min(G, SMALL_DIM_MAX)
    cands = 2 * _LS_CANDS * D if box else 0
    return (10 * D * (D | 1) + cands + 6 * D + 1) | 1


def small_stage_elems(n: int, m: int, dtype, ddp: bool,
                      box: bool = True, stage_h: bool = True) -> int:
    """A scenario's staging slot in elements of ``dtype`` (``SmallStage``):
    f_x, f_u, l_x, l_u, l_xx, l_uu, l_ux, with ``box`` ubar, and with
    ``ddp`` and ``stage_h`` f_xx, f_ux, f_uu, each padded to 16 bytes, the
    whole padded so that neighbouring groups' slots start G elements apart
    in the 128-byte bank cycle (16 bytes at least)."""
    size = _ITEMSIZE[dtype]
    q = 16 // size
    counts = [n * n, n * m, n, m, n * n, m * m, m * n] + ([m] if box else [])
    if ddp and stage_h:
        counts += [n * n * n, n * m * n, n * m * m]
    nbytes = sum(-(-c // q) * q for c in counts) * size
    shift = max(16, size * small_groups(n, m) % 128)
    return (nbytes + (shift - nbytes) % 128) // size


def small_smem_bytes(n: int, m: int, dtype, ddp: bool, spb: int,
                     box: bool = True, stage_h: bool = True) -> int:
    """A block's dynamic shared bytes (``small_smem_bytes``) for the
    variant (``box``, ``ddp``; with ``ddp``, ``stage_h``: the Hessians
    staged): ``spb`` workspaces (in double, rounded up to 16 bytes), then
    ``spb`` staging slots."""
    work = -(-spb * small_work_doubles(small_groups(n, m), box) * 8
             // 16) * 16
    return work + spb * small_stage_elems(n, m, dtype, ddp, box, stage_h) \
        * _ITEMSIZE[dtype]


@dataclasses.dataclass(frozen=True)
class SmallPlan:
    """The kernel's launch: ``groups`` lanes a scenario, ``scenarios`` a
    block, the block's dynamic shared bytes, which the C side recomputes
    and must equal, and with full DDP whether the Hessians are staged
    (``stage_h``; else read in place from global memory, prefetched into
    L2 a step ahead). Scenario b runs on block ``b // scenarios``, threads
    ``(b % scenarios) * groups`` to ``+ groups - 1``."""

    groups: int
    scenarios: int
    smem_bytes: int
    stage_h: bool = True

    @property
    def threads(self) -> int:
        return self.groups * self.scenarios

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def small_waves(plan: SmallPlan, B: int, per_sm: int, sms: int = SMS) -> int:
    """The waves of blocks a batch of B takes under ``plan`` where an SM
    holds ``per_sm`` of its blocks at once (``small_blocks_per_sm``)."""
    return -(-plan.blocks(B) // (per_sm * sms))


@functools.cache
def small_plan(n: int, m: int, B: int, dtype, ddp: bool,
               threads: int | None = None, sms: int = SMS,
               box: bool = True, stage_h: bool = True) -> SmallPlan:
    """The launch plan of the variant (``box``, ``ddp``; with ``ddp``,
    ``stage_h``: the Hessians staged, else read in place) at (n, m) for B
    scenarios: ``small_groups`` lanes a scenario, and as many scenarios a
    block as B spread over ``sms`` SMs asks for, in whole warps (the
    kernel's exchanges name the whole warp: a multiple of 32 / G
    scenarios), at most ``threads`` (``SMALL_THREADS`` by default) threads
    and ``SMEM_LIMIT`` shared bytes a block. ``small_launch_plan`` picks
    the Hessians' way for a launch."""
    if not small_kernel_supported(n, m):
        raise NotImplementedError(f"the small-dims kernel takes 1 <= n, m <= "
                                  f"{SMALL_DIM_MAX}, got {(n, m)}")
    G = small_groups(n, m)
    warp = 32 // G
    threads = threads or SMALL_THREADS
    if threads % 32 or not 32 <= threads <= SMALL_MAX_THREADS:
        raise ValueError(f"{threads} threads a block: whole warps, at most "
                         f"{SMALL_MAX_THREADS}")

    stage_h = stage_h or not ddp
    nbytes = functools.partial(small_smem_bytes, n, m, dtype, ddp, box=box,
                               stage_h=stage_h)
    cap = threads // G
    while cap > warp and nbytes(cap) > SMEM_LIMIT:
        cap -= warp
    if nbytes(cap) > SMEM_LIMIT:
        raise ValueError(f"a warp of scenarios at {(n, m)} exceeds a "
                         f"block's {SMEM_LIMIT} shared bytes")
    spread = -(-B // sms)  # scenarios a block that reach every SM
    spb = max(warp, min(cap, -(-spread // warp) * warp))
    return SmallPlan(groups=G, scenarios=spb, smem_bytes=nbytes(spb),
                     stage_h=stage_h)


def small_blocks_per_sm(plan: SmallPlan, n: int, m: int, dtype) -> int:
    """The blocks of K6a's ``plan`` an SM of the current card holds at
    once, as the CUDA runtime computes them for the kernel (its registers,
    the plan's threads and shared bytes;
    ``tfmpc_riccati_small_ddp_ilqr_blocks_per_sm``). Raises where the
    query fails or an SM holds none."""
    per_sm = _build.library().tfmpc_riccati_small_ddp_ilqr_blocks_per_sm(
        _build.DTYPE_CODES[dtype], n, m, plan.groups, plan.scenarios,
        int(plan.stage_h), plan.smem_bytes)
    if per_sm < 0:
        _build.check(-per_sm, f"the occupancy of the small-dims plan {plan}")
    if per_sm == 0:
        raise ValueError(f"no block of the small-dims plan {plan} fits an SM")
    return per_sm


@functools.cache
def small_launch_plan(n: int, m: int, B: int, dtype, ddp: bool, box: bool,
                      sms: int) -> SmallPlan:
    """The plan a launch takes (on the current card, with ``sms`` SMs):
    ``small_plan``'s. With ``ddp`` and no box (K6a) the Hessians are staged
    unless reading them in place takes fewer waves of blocks
    (``small_waves`` at the occupancy the runtime gives each plan,
    ``small_blocks_per_sm``): at D5's shape (n = m = 12, B = 1024, f32) a
    block with them staged fills an SM's shared memory, and the batch took
    two waves (``tools/kernel_versions.py small``, PERF.md section 6). K6b
    always stages them (its kernel has no in-place read)."""
    staged = small_plan(n, m, B, dtype, ddp, sms=sms, box=box)
    if not ddp or box:
        return staged
    in_place = small_plan(n, m, B, dtype, ddp, sms=sms, box=box,
                          stage_h=False)
    waves = [small_waves(p, B, small_blocks_per_sm(p, n, m, dtype), sms)
             for p in (staged, in_place)]
    return in_place if waves[1] < waves[0] else staged


def small_cover(plan: SmallPlan, B: int) -> np.ndarray:
    """How many groups of lanes take each of B scenarios under ``plan``,
    as the kernel maps them: thread t of block k is lane t % G of group
    t // G, which takes scenario k * scenarios + t // G (past B it
    returns); a group counts once when all its G lanes are in the block."""
    tid = np.arange(plan.threads)
    slot = tid // plan.groups
    blk = np.arange(plan.blocks(B))
    b = (blk[:, None] * plan.scenarios + slot[None, :]).ravel()
    lanes = np.bincount(b[b < B], minlength=B)
    return lanes // plan.groups


@functools.cache
def _kernel_smem_bytes(code: int, box: bool, ddp: bool, n: int, m: int,
                       spb: int, stage_h: bool):
    """The C side's shared bytes for a block of the variant
    (``tfmpc_riccati_small_smem_bytes``) and its lanes a scenario
    (``tfmpc_riccati_small_groups``)."""
    lib = _build.library()
    return (lib.tfmpc_riccati_small_smem_bytes(code, int(box), int(ddp), n, m,
                                               spb, int(stage_h)),
            lib.tfmpc_riccati_small_groups(n, m))


def _launch(entry, inputs, boxqp_iters, ddp, plan=None, box=True):
    """Check the inputs (``SMALL_BOXQP_ARGS`` order, ``SMALL_DDP_BOXQP_ARGS``
    with ``ddp``; without ``box`` ``SMALL_ARGS`` and ``SMALL_DDP_ARGS``),
    allocate the outputs and launch the C entry with ``plan``
    (``small_launch_plan``'s for the variant by default). Returns ``(K [B,
    T, m, n], k [B, T, m], dV1 [B], dV2 [B], fail [B])``, ``fail`` 1.0 on lanes
    whose PD probe (or with ``box`` final free set) failed."""
    fx, fu = inputs[0], inputs[1]
    dev, dtype = fx.device, fx.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if fx.ndim != 4 or fu.ndim != 4:
        raise ValueError(f"{entry} takes [B, T, ...] inputs")
    B, T, n, m = fu.shape
    if not small_kernel_supported(n, m):
        raise NotImplementedError(
            f"{entry}: no CUDA kernel for (n, m) = {(n, m)} (it takes 1 <= "
            f"n, m <= {SMALL_DIM_MAX}); run with use_pallas=False")
    if box and boxqp_iters < 0:
        raise ValueError("boxqp_iters must be >= 0")
    shapes = [(B, T, n, n), (B, T, n, m), (B, T, n), (B, T, m),
              (B, T, n, n), (B, T, m, m), (B, T, m, n), (B,)]
    if box:
        shapes += [(B, T, m), (m,), (m,)]
    if ddp:
        shapes += [(B, T, n, n, n), (B, T, n, m, n), (B, T, n, m, m)]
    shapes += [(B, n, n), (B, n)]
    if tuple(a.shape for a in inputs) != tuple(shapes) or any(
            a.device != dev or a.dtype != dtype or not a.is_contiguous()
            for a in inputs):
        raise ValueError(
            f"{entry}'s inputs must share one device and dtype, be "
            "contiguous and have the solver's [B, T, ...] shapes")
    if plan is None:
        plan = small_launch_plan(n, m, B, dtype, ddp, box, _sm_count(dev))
    code = _build.DTYPE_CODES[dtype]
    smem, groups = _kernel_smem_bytes(code, box, ddp, n, m, plan.scenarios,
                                      plan.stage_h)
    if smem != plan.smem_bytes or groups != plan.groups \
            or smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: the plan's {plan.groups} lanes and "
                         f"{plan.smem_bytes} shared bytes at {(n, m)} are not "
                         f"the kernel's {groups} and {smem}, or exceed a "
                         f"block's {SMEM_LIMIT}")
    opts = dict(dtype=dtype, device=dev)
    out = (torch.empty((B, T, m, n), **opts), torch.empty((B, T, m), **opts),
           *(torch.empty((B,), **opts) for _ in range(3)))
    ints = (code, n, m, T, B) + ((boxqp_iters,) if box else ())
    rc = getattr(_build.library(), "tfmpc_" + entry)(
        *ints, *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out), plan.groups, plan.scenarios,
        int(plan.stage_h), plan.smem_bytes, _build.stream())
    _build.check(rc, f"{entry} with {plan.groups} lanes and {plan.scenarios}"
                 f" scenarios a block at {(n, m)} {dtype}")
    return out


def riccati_backward_small_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT,
                                  plan: SmallPlan | None = None):
    """Launch K1's small-dims kernel on ``riccati_mid.mid_layout``'s tensors
    (``SMALL_ARGS``). Returns ``(K [B, T, m, n], k [B, T, m], dV1 [B], dV2
    [B], fail [B])``."""
    global SMALL_LAUNCHES
    out = _launch("riccati_backward_small",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT), None, False,
                  plan, box=False)
    SMALL_LAUNCHES += 1
    return out


def riccati_backward_small_ddp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu,
                                      fxx, fux, fuu, VT, vT,
                                      plan: SmallPlan | None = None):
    """Launch K6a's small-dims kernel: K1's inputs plus the dynamics
    Hessians ``fxx [B, T, n, n, n]``, ``fux [B, T, n, m, n]``, ``fuu [B, T,
    n, m, m]`` (``SMALL_DDP_ARGS``); outputs as
    ``riccati_backward_small_kernel``."""
    global SMALL_DDP_LAUNCHES
    out = _launch("riccati_backward_small_ddp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, fxx, fux, fuu, VT, vT),
                  None, True, plan, box=False)
    SMALL_DDP_LAUNCHES += 1
    return out


def riccati_backward_small_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu,
                                        ubar, lo, hi, VT, vT,
                                        boxqp_iters: int = 8,
                                        plan: SmallPlan | None = None):
    """Launch K4's small-dims kernel on ``riccati_mid.mid_layout``'s tensors
    (``ubar [B, T, m]``, the box ``lo``/``hi [m]``). Returns ``(K [B, T, m,
    n], k [B, T, m], dV1 [B], dV2 [B], fail [B])``."""
    global SMALL_BOXQP_LAUNCHES
    out = _launch("riccati_backward_small_boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT),
                  boxqp_iters, False, plan)
    SMALL_BOXQP_LAUNCHES += 1
    return out


def riccati_backward_small_ddp_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux,
                                            mu, ubar, lo, hi, fxx, fux, fuu,
                                            VT, vT, boxqp_iters: int = 8,
                                            plan: SmallPlan | None = None):
    """Launch K6b's small-dims kernel: K4's inputs plus the dynamics
    Hessians ``fxx [B, T, n, n, n]``, ``fux [B, T, n, m, n]``, ``fuu [B, T,
    n, m, m]``; outputs as ``riccati_backward_small_boxqp_kernel``."""
    global SMALL_DDP_BOXQP_LAUNCHES
    out = _launch("riccati_backward_small_ddp_boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, fxx, fux,
                   fuu, VT, vT), boxqp_iters, True, plan)
    SMALL_DDP_BOXQP_LAUNCHES += 1
    return out


def riccati_backward_small(lin, quad, final, mu):
    """K1's wrapper at small dims: the contract of
    ``riccati.riccati_backward`` at any 1 <= n, m <= 12. CUDA tensors go
    through the CUDA kernel; CPU tensors through the plain version."""
    global SMALL_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        SMALL_PLAIN_CALLS += 1
        return riccati_backward_small_ref(lin, quad, final, mu)
    a = mid_layout(lin, quad, final, mu)
    return _result(riccati_backward_small_kernel(
        *(a[k] for k in SMALL_ARGS)))


def riccati_backward_small_ddp(lin, quad, final, mu, second):
    """K6a's wrapper at small dims: the contract of
    ``riccati.riccati_backward_ddp`` at any 1 <= n, m <= 12. CUDA tensors
    go through the CUDA kernel; CPU tensors through the plain version."""
    global SMALL_DDP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        SMALL_DDP_PLAIN_CALLS += 1
        return riccati_backward_small_ddp_ref(lin, quad, final, mu, second)
    a = mid_layout(lin, quad, final, mu, second=second)
    return _result(riccati_backward_small_ddp_kernel(
        *(a[k] for k in SMALL_DDP_ARGS)))


def riccati_backward_small_boxqp(lin, quad, final, mu, bounds, Ubar,
                                 boxqp_iters: int = 8):
    """K4's wrapper at small dims: the contract of
    ``riccati.riccati_backward_boxqp`` at any 1 <= n, m <= 12. CUDA tensors
    go through the CUDA kernel; CPU tensors through the plain version."""
    global SMALL_BOXQP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        SMALL_BOXQP_PLAIN_CALLS += 1
        return riccati_backward_small_boxqp_ref(lin, quad, final, mu, bounds,
                                                Ubar, boxqp_iters)
    a = mid_layout(lin, quad, final, mu, bounds, Ubar)
    return _result(riccati_backward_small_boxqp_kernel(
        *(a[k] for k in SMALL_BOXQP_ARGS), boxqp_iters=boxqp_iters))


def riccati_backward_small_ddp_boxqp(lin, quad, final, mu, bounds, Ubar,
                                     second, boxqp_iters: int = 8):
    """K6b's wrapper at small dims: the contract of
    ``riccati.riccati_backward_ddp_boxqp`` at any 1 <= n, m <= 12. CUDA
    tensors go through the CUDA kernel; CPU tensors through the plain
    version."""
    global SMALL_DDP_BOXQP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        SMALL_DDP_BOXQP_PLAIN_CALLS += 1
        return riccati_backward_small_ddp_boxqp_ref(
            lin, quad, final, mu, bounds, Ubar, second, boxqp_iters)
    a = mid_layout(lin, quad, final, mu, bounds, Ubar, second)
    return _result(riccati_backward_small_ddp_boxqp_kernel(
        *(a[k] for k in SMALL_DDP_BOXQP_ARGS), boxqp_iters=boxqp_iters))
