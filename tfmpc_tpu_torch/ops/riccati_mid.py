"""K7: the batched Riccati backward pass at mid dims, and its probe P1.

Counterpart of ``tfmpc_tpu/ops/riccati_mid_pallas.py`` (K7) and of
``benchmarks/mxu_probe.py::_row_kernel_matmul`` (P1). K7 has the contract
of K1 and K4 (``ops/riccati.py``) for any ``1 <= n, m <= 48``, n != m
included: ``riccati_backward_mid`` (plain iLQR gains) and
``riccati_backward_mid_boxqp`` (control-limited, boxQP gains) return ``(ok
[B], Policy(K [B, T, m, n], k [B, T, m]), dV1 [B], dV2 [B])``. On a CUDA
tensor they launch the CUDA kernel of ``csrc/riccati_mid.cuh`` (a team of
one warp or a few per scenario, several scenarios per block, the matrices
in shared memory; ``mid_plan`` is its launch plan) or raise; on a CPU
tensor they run the plain versions ``riccati_backward_mid_ref`` and
``riccati_backward_mid_boxqp_ref``, which are ``ops/riccati.py``'s plain
versions of K1 and K4: they hold for any (n, m), and the JAX package pins
its mid kernel to the same contract (``tests/test_riccati_mid.py``).

K7's full-DDP variant runs K6a's contract (``ops/riccati.py``) at any
``n, m <= MID_DDP_DIM_MAX`` (12, the JAX lane kernel's DDP ceiling):
``riccati_backward_mid_ddp`` takes the dynamics Hessians ``second`` as
well, and its plain version is ``riccati.riccati_backward_ddp_ref``. It
is a compile-time variant of the same kernel (``csrc/riccati_mid_ddp.cu``)
with the same launch plan: the Hessians are streamed from global memory,
so the shared bytes do not change. K6b at those dims runs on the
small-dims kernel (``ops/riccati_small.py``).

The kernel clamps every Cholesky pivot at 1e-30, its boxQP's Newton
systems included (``_chol_rows``), where the plain version lets NaN
propagate; the two differ only on lanes whose PD probe already failed, so
they are compared with identical ok masks, on the ok lanes. The kernel
computes in double for float32 inputs too (rounding its outputs once):
the float32 boxQP backward is ill-conditioned, and the plain version's
float32 result is the less accurate one.

K7's raw launchers take the solver's own layout (``[B, T, ...]``,
contiguous): a team reads its scenario's contiguous entries, so no permute
into the lane kernels' ``[T, entries, B]`` is needed. They also take a
``plan`` (``mid_plan``'s by default).

P1, ``row_matmul``, computes ``C[b] = A[b] M[b]`` for d x d matrices in the
JAX probe's row layout ``[d*d, B]``: K7's core operation alone, on no
solver path; a block streams a few scenarios' A and M through shared
memory in k-slabs and each thread keeps a register tile of one
scenario's C (``row_plan``).
``row_matmul_ref`` is its plain version.

``row_matmul_cover`` repeats P1's index map (which thread stores which
entry), so its plans can be checked on the CPU.

``MID_LAUNCHES``, ``MID_BOXQP_LAUNCHES``, ``MID_DDP_LAUNCHES`` and
``ROW_MATMUL_LAUNCHES`` count kernel launches; the matching
``*_PLAIN_CALLS`` the calls that took the plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.ops import _build
from tfmpc_tpu_torch.ops.riccati import (
    riccati_backward_boxqp_ref,
    riccati_backward_ddp_ref,
    riccati_backward_ref,
)

MID_LAUNCHES = 0
MID_PLAIN_CALLS = 0
MID_BOXQP_LAUNCHES = 0
MID_BOXQP_PLAIN_CALLS = 0
MID_DDP_LAUNCHES = 0
MID_DDP_PLAIN_CALLS = 0
ROW_MATMUL_LAUNCHES = 0
ROW_MATMUL_PLAIN_CALLS = 0

# The kernel's envelope: every (n, m) with 1 <= n, m <= MID_DIM_MAX; at
# (48, 48) in float64 a scenario takes 198,288 bytes of shared memory, of
# the 232,448 a block may have (csrc/riccati_mid.cuh: the team computes in
# double for both dtypes, and l_xx, l_uu, l_ux are read in place there).
MID_DIM_MAX = 48
# The DDP variant's envelope (csrc/riccati_mid.cuh kMidDdpMaxDim): the JAX
# lane kernel's DDP ceiling; above it the JAX package runs its scan, and so
# does the solver here.
MID_DDP_DIM_MAX = 12
SMEM_LIMIT = 232448
# A block's threads at most (csrc/riccati_mid.cuh kMaxThreads), teams per
# block at most, and the card's SMs (an H100 SXM's 132; the launch reads
# the device's own count).
MID_MAX_THREADS = 256
MID_MAX_SCENARIOS = 4
SMS = 132
# Warps per scenario by max(n, m): (largest dim, warps), first that holds;
# no more than MID_WARPS_PER_SM / (scenarios an SM holds) allows: the
# kernel takes up to 255 registers a thread, so an SM holds 8 warps.
MID_WARPS = ((16, 2), (MID_DIM_MAX, 4))
MID_WARPS_PER_SM = 8
# P1's register tiles by d, (largest d, rows, cols) first that holds;
# csrc/row_matmul.cu instantiates ROW_TILES, with ROW_SLAB k values a
# stage and 32 bytes of scenarios a block (8 in float32, 4 in float64).
ROW_PLANS = ((16, 2, 4), (24, 3, 6), (32, 4, 8), (MID_DIM_MAX, 6, 12))
ROW_TILES = ((2, 4), (3, 6), (4, 8), (6, 12))
ROW_SLAB = 8
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}
_LS_ALPHAS = 8  # ops/boxqp.py LS_ALPHAS: the candidates, and x

# The plain versions: K1's, K4's and K6a's, general in (n, m).
riccati_backward_mid_ref = riccati_backward_ref
riccati_backward_mid_boxqp_ref = riccati_backward_boxqp_ref
riccati_backward_mid_ddp_ref = riccati_backward_ddp_ref

# Argument order of the launchers and of the C entries (the JAX kernel's:
# first order, boxQP, DDP, final value).
MID_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "VT", "vT")
MID_BOXQP_ARGS = MID_ARGS[:8] + ("ubar", "lo", "hi") + MID_ARGS[8:]
MID_DDP_ARGS = MID_ARGS[:8] + ("fxx", "fux", "fuu") + MID_ARGS[8:]


def mid_kernel_supported(n: int, m: int) -> bool:
    """Whether K7 runs at these dims: ``1 <= min(n, m)`` and ``max(n, m)
    <= 48``, both variants, float32 and float64."""
    return 1 <= min(n, m) and max(n, m) <= MID_DIM_MAX


@dataclasses.dataclass(frozen=True)
class MidPlan:
    """K7's launch: ``warps`` per scenario (its team), ``scenarios`` teams
    per block, whether ``stage_l`` (l_xx, l_uu, l_ux copied into shared
    memory with the step's other inputs, else read in place) and the
    block's dynamic shared bytes, which the C side recomputes and must
    equal."""

    warps: int
    scenarios: int
    stage_l: bool
    smem_bytes: int

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.scenarios

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def mid_scenario_bytes(n: int, m: int, dtype, stage_l: bool = True) -> int:
    """One team's shared bytes (csrc/riccati_mid.cuh ``mid_scenario_bytes``):
    its matrices, rows padded to an odd length, and vectors in double; its
    staging slot in the input dtype."""
    ln, lm = n | 1, m | 1
    work = (2 * n * ln + max(n * lm, m * ln) + 2 * m * ln + 3 * m * lm
            + 2 * n + 5 * m + 2 * (_LS_ALPHAS + 1) * lm)
    stage = n * n + n * m + n + 2 * m
    if stage_l:
        stage += n * n + m * m + m * n
    return (_align16(work * 8)
            + _align16(stage * _ITEMSIZE[dtype]))


def mid_warps(n: int, m: int, B: int = 1, sms: int = SMS) -> int:
    """Warps per scenario: ``MID_WARPS``' at these dims, fewer where B
    scenarios spread over ``sms`` SMs would not fit ``MID_WARPS_PER_SM``
    warps an SM in one wave."""
    w = next(w for top, w in MID_WARPS if max(n, m) <= top)
    return max(1, min(w, MID_WARPS_PER_SM // -(-B // sms)))


def mid_plan(n: int, m: int, B: int, dtype, warps: int | None = None,
             sms: int = SMS) -> MidPlan:
    """K7's launch plan at (n, m) for B scenarios: ``warps`` per scenario
    (``mid_warps`` by default), the l blocks staged where a team's shared
    memory still fits ``SMEM_LIMIT`` with them, and as many teams per block
    as fit, up to ``MID_MAX_SCENARIOS``, but no more than B spread over
    ``sms`` SMs asks for, so a small batch still reaches every SM."""
    if not mid_kernel_supported(n, m):
        raise NotImplementedError(f"K7 takes 1 <= n, m <= {MID_DIM_MAX}, "
                                  f"got {(n, m)}")
    warps = warps or mid_warps(n, m, B, sms)
    if warps < 1 or 32 * warps > MID_MAX_THREADS:
        raise ValueError(f"{warps} warps per scenario: a block holds at most "
                         f"{MID_MAX_THREADS} threads")
    for stage_l in (True, False):
        per = mid_scenario_bytes(n, m, dtype, stage_l)
        if per <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"K7 at {(n, m)}: {per} bytes of shared memory a "
                         f"scenario exceed a block's {SMEM_LIMIT}")
    cap = min(MID_MAX_SCENARIOS, SMEM_LIMIT // per,
              MID_MAX_THREADS // (32 * warps), 32 if warps == 1 else 15)
    spb = max(1, min(cap, -(-B // sms)))
    return MidPlan(warps=warps, scenarios=spb, stage_l=stage_l,
                   smem_bytes=per * spb)


def mid_layout(lin, quad, final, mu, bounds=None, Ubar=None, second=None):
    """The solver's tensors as K7 takes them: contiguous, in the
    linearization's dtype; with ``bounds`` and ``Ubar`` also ``ubar [B, T,
    m]`` and the box ``lo``/``hi [m]``; with the dynamics Hessians
    ``second`` (a ``SecondOrderModel``) also ``fxx [B, T, n, n, n]``,
    ``fux [B, T, n, m, n]`` and ``fuu [B, T, n, m, m]``."""
    dtype = lin.f_x.dtype
    c = lambda a: a.to(dtype).contiguous()  # noqa: E731
    args = dict(fx=c(lin.f_x), fu=c(lin.f_u), lx=c(quad.l_x), lu=c(quad.l_u),
                lxx=c(quad.l_xx), luu=c(quad.l_uu), lux=c(quad.l_ux),
                mu=c(mu), VT=c(final.l_xx), vT=c(final.l_x))
    if bounds is not None:
        m = lin.f_u.shape[-1]
        side = lambda a: c(torch.broadcast_to(a.to(dtype), (m,)))  # noqa: E731
        args.update(ubar=c(Ubar), lo=side(bounds.low), hi=side(bounds.high))
    if second is not None:
        args.update(fxx=c(second.f_xx), fux=c(second.f_ux),
                    fuu=c(second.f_uu))
    return args


def _launch(entry, inputs, box, boxqp_iters=None, plan=None, ddp=False):
    """Check K7's inputs (``MID_ARGS`` order, ``MID_BOXQP_ARGS`` with
    ``box``, ``MID_DDP_ARGS`` with ``ddp``), allocate the outputs and launch
    the C entry with ``plan`` (``mid_plan``'s for these dims, batch and
    dtype by default). Returns ``(K [B, T, m, n], k [B, T, m], dV1 [B],
    dV2 [B], fail [B])``, ``fail`` 1.0 on lanes whose PD probe failed."""
    fx, fu = inputs[0], inputs[1]
    dev, dtype = fx.device, fx.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if fx.ndim != 4 or fu.ndim != 4:
        raise ValueError("K7 takes [B, T, ...] inputs")
    B, T, n, m = fu.shape
    top = MID_DDP_DIM_MAX if ddp else MID_DIM_MAX
    if not mid_kernel_supported(n, m) or max(n, m) > top:
        raise NotImplementedError(
            f"{entry}: no CUDA kernel for (n, m) = {(n, m)} (K7 takes "
            f"1 <= n, m <= {top}{' with ddp' if ddp else ''}); run with "
            "use_pallas=False")
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
            "K7's inputs must share one device and dtype, be contiguous and "
            "have the solver's [B, T, ...] shapes")
    if plan is None:
        plan = mid_plan(n, m, B, dtype, sms=_sm_count(dev))
    lib = _build.library()
    code = _build.DTYPE_CODES[dtype]
    smem = lib.tfmpc_riccati_mid_smem_bytes(code, n, m, plan.scenarios,
                                            int(plan.stage_l))
    if smem != plan.smem_bytes or smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: the plan's {plan.smem_bytes} bytes of "
                         f"shared memory at {(n, m)} are not the kernel's "
                         f"{smem}, or exceed a block's {SMEM_LIMIT}")
    ints = (code, n, m, T, B)
    if boxqp_iters is not None:
        if boxqp_iters < 0:
            raise ValueError("boxqp_iters must be >= 0")
        ints += (boxqp_iters,)
    opts = dict(dtype=dtype, device=dev)
    out = (torch.empty((B, T, m, n), **opts), torch.empty((B, T, m), **opts),
           *(torch.empty((B,), **opts) for _ in range(3)))
    rc = getattr(lib, "tfmpc_" + entry)(
        *ints, *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out), plan.warps, plan.scenarios,
        int(plan.stage_l), plan.smem_bytes, _build.stream())
    _build.check(rc, entry)
    return out


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def riccati_backward_mid_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT,
                                plan: MidPlan | None = None):
    """Launch K7's iLQR variant on the solver-layout tensors of
    ``mid_layout``. Returns ``(K [B, T, m, n], k [B, T, m], dV1 [B], dV2
    [B], fail [B])``, ``fail`` 1.0 on lanes whose PD probe failed."""
    global MID_LAUNCHES
    out = _launch("riccati_backward_mid",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT), False,
                  plan=plan)
    MID_LAUNCHES += 1
    return out


def riccati_backward_mid_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu,
                                      ubar, lo, hi, VT, vT,
                                      boxqp_iters: int = 8,
                                      plan: MidPlan | None = None):
    """Launch K7's boxQP variant: the inputs of the iLQR variant plus
    ``ubar [B, T, m]`` and the box ``lo``/``hi [m]``; outputs as
    ``riccati_backward_mid_kernel``."""
    global MID_BOXQP_LAUNCHES
    out = _launch("riccati_backward_mid_boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT),
                  True, boxqp_iters, plan=plan)
    MID_BOXQP_LAUNCHES += 1
    return out


def riccati_backward_mid_ddp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, fxx,
                                    fux, fuu, VT, vT,
                                    plan: MidPlan | None = None):
    """Launch K7's full-DDP variant (K6a's contract) on ``mid_layout``'s
    tensors with the Hessians ``fxx [B, T, n, n, n]``, ``fux [B, T, n, m,
    n]``, ``fuu [B, T, n, m, m]``, n, m <= ``MID_DDP_DIM_MAX``; outputs as
    ``riccati_backward_mid_kernel``."""
    global MID_DDP_LAUNCHES
    out = _launch("riccati_backward_mid_ddp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, fxx, fux, fuu, VT, vT),
                  False, plan=plan, ddp=True)
    MID_DDP_LAUNCHES += 1
    return out


def _result(out):
    K, k, dV1, dV2, fail = out
    return fail == 0.0, Policy(K=K, k=k), dV1, dV2


def riccati_backward_mid(lin, quad, final, mu):
    """K7's iLQR wrapper: the batched backward pass over ``[B, T, ...]``
    linearizations, ``mu [B]``; the contract of ``riccati.riccati_backward``
    at any 1 <= n, m <= 48. CUDA tensors go through the CUDA kernel; CPU
    tensors through the plain version."""
    global MID_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        MID_PLAIN_CALLS += 1
        return riccati_backward_mid_ref(lin, quad, final, mu)
    a = mid_layout(lin, quad, final, mu)
    return _result(riccati_backward_mid_kernel(*(a[k] for k in MID_ARGS)))


def riccati_backward_mid_boxqp(lin, quad, final, mu, bounds, Ubar,
                               boxqp_iters: int = 8):
    """K7's boxQP wrapper: the control-limited backward pass (the env's
    ``bounds``, nominal controls ``Ubar [B, T, m]``); the contract of
    ``riccati.riccati_backward_boxqp`` at any 1 <= n, m <= 48. CUDA tensors
    go through the CUDA kernel; CPU tensors through the plain version."""
    global MID_BOXQP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        MID_BOXQP_PLAIN_CALLS += 1
        return riccati_backward_mid_boxqp_ref(lin, quad, final, mu, bounds,
                                              Ubar, boxqp_iters)
    a = mid_layout(lin, quad, final, mu, bounds, Ubar)
    return _result(riccati_backward_mid_boxqp_kernel(
        *(a[k] for k in MID_BOXQP_ARGS), boxqp_iters=boxqp_iters))


def riccati_backward_mid_ddp(lin, quad, final, mu, second):
    """K7's full-DDP wrapper: the contract of ``riccati.riccati_backward_ddp``
    at any n, m <= ``MID_DDP_DIM_MAX``. CUDA tensors go through the CUDA
    kernel; CPU tensors through the plain version."""
    global MID_DDP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        MID_DDP_PLAIN_CALLS += 1
        return riccati_backward_mid_ddp_ref(lin, quad, final, mu, second)
    a = mid_layout(lin, quad, final, mu, second=second)
    return _result(riccati_backward_mid_ddp_kernel(
        *(a[k] for k in MID_DDP_ARGS)))


# -- P1 ------------------------------------------------------------------------

def row_matmul_ref(A_rows, M_rows, d: int):
    """Plain version of P1: ``C[b] = A[b] M[b]`` with entry ``i*d + j`` of
    scenario ``b`` at ``[i*d + j, b]``; returns ``C [d*d, B]``."""
    B = A_rows.shape[-1]
    C = torch.einsum("ikb,kjb->ijb", A_rows.reshape(d, d, B),
                     M_rows.reshape(d, d, B))
    return C.reshape(d * d, B)


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """P1's launch: the rows and columns of each thread's register tile of
    its scenario's C; ``scenarios`` a block (32 bytes of each entry)."""

    rows: int
    cols: int
    scenarios: int

    @property
    def max_threads(self) -> int:
        """512 for tiles of at most 48 entries, else 256 (the kernel's
        launch bounds)."""
        return 512 if self.rows * self.cols <= 48 else 256

    def tiles(self, d: int) -> tuple[int, int]:
        return -(-d // self.rows), -(-d // self.cols)

    def threads(self, d: int) -> int:
        tr, tc = self.tiles(d)
        return 32 * tc * -(-tr * self.scenarios // 32)

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)

    def smem_bytes(self, d: int, dtype) -> int:
        stage = d * (ROW_SLAB * self.scenarios + 4) \
            + ROW_SLAB * d * self.scenarios
        return 2 * stage * _ITEMSIZE[dtype]


def row_plan(d: int, dtype, tile: tuple[int, int] | None = None) -> RowPlan:
    """P1's plan at d: ``ROW_PLANS``' tile (or ``tile``, (rows, cols))."""
    if not 1 <= d <= MID_DIM_MAX:
        raise NotImplementedError(f"row_matmul takes 1 <= d <= "
                                  f"{MID_DIM_MAX}, got {d}")
    if tile is None:
        tile = next((r, c) for top, r, c in ROW_PLANS if d <= top)
    if tile not in ROW_TILES:
        raise ValueError(f"no P1 instantiation with a {tile} tile")
    plan = RowPlan(*tile, scenarios=32 // _ITEMSIZE[dtype])
    if plan.threads(d) > plan.max_threads or \
            plan.smem_bytes(d, dtype) > SMEM_LIMIT:
        raise ValueError(f"P1's {tile} tile does not fit a block at d={d}")
    return plan


def row_matmul_cover(plan: RowPlan, d: int, B: int) -> np.ndarray:
    """How many times P1's threads store each (entry, scenario) of C
    ``[d*d, B]``, as the kernel maps them: thread t of block k takes
    scenario k * scenarios + t % scenarios; its warp holds 32 / scenarios
    tile rows of one tile column; threads past the tiles or the batch
    store nothing."""
    sb, R, Cc = plan.scenarios, plan.rows, plan.cols
    Tr, Tc = plan.tiles(d)
    per_warp = 32 // sb
    tid = np.arange(plan.threads(d))
    q = tid // sb
    w = q // per_warp
    tr, tc = (w // Tc) * per_warp + q % per_warp, w % Tc
    blk = np.arange(plan.blocks(B))
    b = (blk[:, None] * sb + (tid % sb)[None, :]).ravel()
    tr = np.broadcast_to(tr[None, :], (blk.size, tid.size)).ravel()
    tc = np.broadcast_to(tc[None, :], (blk.size, tid.size)).ravel()
    keep = (tr < Tr) & (b < B)
    b, tr, tc = b[keep], tr[keep], tc[keep]
    i = tr[:, None, None] * R + np.arange(R)[None, :, None]
    j = tc[:, None, None] * Cc + np.arange(Cc)[None, None, :]
    i, j = np.broadcast_arrays(i, j)
    bb = np.broadcast_to(b[:, None, None], i.shape)
    ok = (i < d) & (j < d)
    return np.bincount(((i * d + j) * B + bb)[ok],
                       minlength=d * d * B).reshape(d * d, B)


def row_matmul_kernel(A_rows, M_rows, d: int, plan: RowPlan | None = None):
    """Launch P1 on CUDA tensors ``A_rows``, ``M_rows [d*d, B]`` with
    ``plan`` (``row_plan``'s by default)."""
    global ROW_MATMUL_LAUNCHES
    dev, dtype = A_rows.device, A_rows.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    plan = plan or row_plan(d, dtype)
    if A_rows.ndim != 2 or A_rows.shape[0] != d * d \
            or M_rows.shape != A_rows.shape or M_rows.device != dev \
            or M_rows.dtype != dtype or not A_rows.is_contiguous() \
            or not M_rows.is_contiguous():
        raise ValueError("row_matmul takes two contiguous [d*d, B] tensors "
                         "of one device and dtype")
    C = torch.empty_like(A_rows)
    rc = _build.library().tfmpc_row_matmul(
        _build.DTYPE_CODES[dtype], d, A_rows.shape[1], _build.ptr(A_rows),
        _build.ptr(M_rows), _build.ptr(C), plan.rows, plan.cols,
        _build.stream())
    _build.check(rc, "row_matmul")
    ROW_MATMUL_LAUNCHES += 1
    return C


def row_matmul(A_rows, M_rows, d: int):
    """P1's wrapper: ``C[b] = A[b] M[b]`` in the row layout ``[d*d, B]``.
    CUDA tensors go through the CUDA kernel; CPU tensors through the plain
    version."""
    global ROW_MATMUL_PLAIN_CALLS
    if A_rows.device.type == "cpu":
        ROW_MATMUL_PLAIN_CALLS += 1
        return row_matmul_ref(A_rows, M_rows, d)
    return row_matmul_kernel(A_rows, M_rows, d)
