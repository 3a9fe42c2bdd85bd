"""K1, K4, K6a and K6b: the batched regularized Riccati backward pass.

Counterpart of ``tfmpc_tpu/ops/riccati_pallas.py`` (its unconstrained,
control-limited and full-DDP variants). The solver's entries are
``riccati_backward`` (K1), ``riccati_backward_boxqp`` (K4),
``riccati_backward_ddp`` (K6a) and ``riccati_backward_ddp_boxqp`` (K6b): on
a CUDA tensor they launch the CUDA kernel (``csrc/riccati.cu``,
``riccati_boxqp.cu``, ``riccati_ddp.cu``, ``riccati_ddp_boxqp.cu``) or
raise; on a CPU
tensor they run the plain PyTorch versions ``riccati_backward_ref``,
``riccati_backward_boxqp_ref``, ``riccati_backward_ddp_ref`` and
``riccati_backward_ddp_boxqp_ref``. The four kernels are one template run
with a launch plan (``lane_plan``: the lanes a scenario, the scenarios a
block, the shared bytes). The fused iteration's entry,
``riccati_backward_lanes``, takes and returns the kernels' own ``[T,
entries, B]`` layout and launches K1 or K4 (at dims without a lane
instantiation the small-dims kernel of ``ops/riccati_small.py``, which
runs K1, K4, K6a and K6b at the other n, m <= 12, or K7 above 12).
``LAUNCHES``, ``BOXQP_LAUNCHES``, ``DDP_LAUNCHES`` and
``DDP_BOXQP_LAUNCHES`` count kernel launches and the matching
``*PLAIN_CALLS`` the calls that took the plain version.

All compute, per scenario and for t = T-1 .. 0, the Q blocks from the
linearization and the carried value function, the regularized
``Quu + f_u^T mu f_u`` (Tassa's ``V + mu I``), its Cholesky factor with a
per-lane PD probe, the gains, the expected improvement ``dV1``/``dV2`` from
the unregularized Q terms, and the symmetrized value update. K1's gains are
``k = -QuuR^-1 Q_u``, ``K = -QuuR^-1 QuxR``; K4's ``k`` is the boxQP
minimizer within the control box shifted by the nominal control, and its
``K`` rows come from the final free set (clamped rows zero). K6a and K6b
are K1 and K4 with the full-DDP terms: the dynamics Hessians contracted
with the value gradient in every Q block, and ``mu I_m`` on QuuR.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    Policy,
    QuadraticFinal,
    QuadraticModel,
)
from tfmpc_tpu_torch.ops import _build
from tfmpc_tpu_torch.ops.boxqp import boxqp, solve_free_system

LAUNCHES = 0
PLAIN_CALLS = 0
BOXQP_LAUNCHES = 0
BOXQP_PLAIN_CALLS = 0
DDP_LAUNCHES = 0
DDP_PLAIN_CALLS = 0
DDP_BOXQP_LAUNCHES = 0
DDP_BOXQP_PLAIN_CALLS = 0

# (n, m) pairs the four CUDA kernels are instantiated for (csrc/riccati*.cu,
# one template in riccati_kernel.cuh): bounded navigation (2), the HVAC-3
# oracle problem (3), reservoir-5 (5) and HVAC-6 (6). The solver routes
# the backward at other dims up to 12 (K1, K4, K6a, K6b) to the small-dims
# kernel (ops/riccati_small.py) and other dims up to 48 to K7
# (ops/riccati_mid.py).
KERNEL_DIMS = {(2, 2), (3, 3), (5, 5), (6, 6)}
# The launch plans (``lane_plan``). A group of G lanes owns a scenario
# (csrc/riccati_kernel.cuh): lane l computes the columns l, l + G, ... of
# the step's products, so G >= n gives each lane about one column of each
# Q block; G = 1 is one thread a scenario. LANE_PLANS gives, per variant
# and dim, G and the most scenarios a block: the fastest pair of G = 1 or
# a power of two >= n and 4, 8, 16 or 32 scenarios a block, as timed on
# one H100 by ``tools/kernel_versions.py lane --sweep`` at the paths'
# batches (PERF.md section 6). Fewer scenarios a block wait for fewer slow
# boxQPs at each step's barrier and leave more blocks an SM; more share
# the staged copies. Each C source instantiates exactly these (n, G)
# pairs (and, at f32, the Gs that chip_smoke.py sweeps), so a G outside
# them raises at launch.
LANE_PLANS = {
    "ilqr": {2: (1, 16), 3: (4, 16), 5: (8, 8), 6: (8, 16)},
    "boxqp": {2: (8, 4), 3: (8, 4), 5: (8, 4), 6: (8, 16)},
    "ddp": {2: (2, 8), 3: (8, 16), 5: (8, 16), 6: (8, 16)},
    "ddp_boxqp": {2: (8, 8), 3: (8, 8), 5: (8, 8), 6: (8, 16)},
}
# whether each variant takes the box and the dynamics Hessians
VARIANTS = {"ilqr": (False, False), "boxqp": (True, False),
            "ddp": (False, True), "ddp_boxqp": (True, True)}
LANE_MAX_THREADS = 256  # csrc/riccati_kernel.cuh kLaneMaxThreads
SMEM_LIMIT = 232448  # a block's shared memory on the H100
SMS = 132  # the H100's SMs: the scenarios of a block spread B over them
_ITEMSIZE = {torch.float32: 4, torch.float64: 8}


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """A lane kernel's launch: ``groups`` lanes a scenario, ``scenarios``
    a block, and the block's dynamic shared bytes, which the C side
    recomputes and must equal. Scenario b runs on block ``b //
    scenarios``, threads ``(b % scenarios) * groups`` to ``+ groups -
    1``."""

    groups: int
    scenarios: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return self.groups * self.scenarios

    def blocks(self, B: int) -> int:
        return -(-B // self.scenarios)


def lane_smem_bytes(variant: str, n: int, m: int, spb: int, dtype) -> int:
    """A block's shared bytes (csrc/riccati_step.cuh ``lane_smem_bytes``):
    three steps' staged inputs, ``[3][entries][spb | 1]``, and ``spb``
    workspaces of the value function, the exchanged and parked blocks and
    the box, an odd number of values each."""
    box, ddp = VARIANTS[variant]
    entries = (2 * n * n + n * m + n + m + m * m + m * n + (m if box else 0)
               + (n * n * n + n * m * n + n * m * m if ddp else 0))
    ws = (2 * n * n + n + 2 * m * m + 3 * m * n + 6 * m) | 1
    return (3 * entries * (spb | 1) + spb * ws) * _ITEMSIZE[dtype]


@functools.cache
def lane_plan(variant: str, n: int, m: int, B: int, dtype,
              groups: int | None = None, sms: int = SMS) -> LanePlan:
    """The launch plan of a lane kernel (``variant`` one of ``VARIANTS``)
    at (n, m) for B scenarios: ``groups`` lanes a scenario (``LANE_PLANS``'
    by default) and as many scenarios a block as B spread over ``sms``
    SMs asks for, at most ``LANE_PLANS``', ``LANE_MAX_THREADS`` threads
    and ``SMEM_LIMIT`` shared bytes a block."""
    if (n, m) not in KERNEL_DIMS:
        raise NotImplementedError(
            f"the lane kernels take (n, m) in {sorted(KERNEL_DIMS)}, got "
            f"{(n, m)}")
    G_plan, spb_max = LANE_PLANS[variant][n]
    G = groups or G_plan
    if G not in (1, 2, 4, 8):
        raise ValueError(f"{G} lanes a scenario: G is 1, 2, 4 or 8")
    cap = LANE_MAX_THREADS // G
    while cap > 1 and lane_smem_bytes(variant, n, m, cap, dtype) > SMEM_LIMIT:
        cap -= 1
    spb = max(1, min(cap, spb_max, -(-B // sms)))
    return LanePlan(groups=G, scenarios=spb,
                    smem_bytes=lane_smem_bytes(variant, n, m, spb, dtype))


@functools.cache
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _kernel_smem_bytes(variant, code, n, m, spb) -> int:
    """The shared bytes the C side computes for a block of ``spb``
    scenarios (``tfmpc_riccati_lane_smem_bytes``)."""
    return _build.library().tfmpc_riccati_lane_smem_bytes(
        *map(int, VARIANTS[variant]), code, n, m, spb)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _cholesky_gains(t, Q_u, Quu_reg, Qux_reg, chol):
    """K1's gains: ``k = -QuuR^-1 Q_u``, ``K = -QuuR^-1 QuxR``."""
    K = -torch.cholesky_solve(Qux_reg, chol)
    k = -torch.cholesky_solve(Q_u[..., None], chol)[..., 0]
    return K, k, None


def _boxqp_gains(bounds, Ubar, boxqp_iters, stats):
    """K4's gains: ``k`` the boxQP minimizer of (QuuR, Q_u) within
    ``[low - ubar_t, high - ubar_t]``, ``K`` from its final masked free
    system (clamped rows exactly zero); a lane also fails where that free
    system is not PD."""
    low, high = bounds.low, bounds.high

    def gains(t, Q_u, Quu_reg, Qux_reg, chol):
        ubar = Ubar[..., t, :]
        res = boxqp(Quu_reg, Q_u, low - ubar, high - ubar,
                    max_iters=boxqp_iters)
        if stats is not None:
            stats["newton_iterations"] = stats.get("newton_iterations", 0) \
                + int(res.iterations.sum())
        K = -solve_free_system(res, Qux_reg)
        return K, res.x, ~torch.isfinite(res.chol_free).all(dim=(-2, -1))

    return gains


def riccati_backward_ref(lin, quad, final, mu):
    """Plain PyTorch backward pass: a loop over T of batched matmuls and
    ``cholesky_ex``.

    ``lin.f_x [..., T, n, n]`` etc. with any leading batch dims, ``mu
    [...]``. Returns ``(ok [...], Policy, dV1 [...], dV2 [...])``; a lane
    fails when any step's Cholesky reports a non-PD pivot or a non-finite
    factor (its outputs are then meaningless and discarded by the caller).
    """
    return _backward_scan(lin, quad, final, mu, _cholesky_gains)


def riccati_backward_boxqp_ref(lin, quad, final, mu, bounds, Ubar,
                               boxqp_iters: int = 8, stats=None):
    """Plain PyTorch control-limited backward pass (the plain version of
    K4): as ``riccati_backward_ref``, but each step's ``k`` is the boxQP
    minimizer of (QuuR, Q_u) within ``[low - ubar_t, high - ubar_t]``
    (``ops/boxqp.py``, ``boxqp_iters`` Newton iterations) and ``K`` comes
    from its final masked free system, clamped rows exactly zero. A lane
    also fails where that free system is not PD.

    ``Ubar [..., T, m]`` is the nominal control. With a dict ``stats``,
    ``stats["newton_iterations"]`` receives the number of boxQP Newton
    iterations run over all lanes and steps (a work count for the kernel's
    bound).
    """
    return _backward_scan(lin, quad, final, mu,
                          _boxqp_gains(bounds, Ubar, boxqp_iters, stats))


def riccati_backward_ddp_ref(lin, quad, final, mu, second):
    """Plain PyTorch full-DDP backward pass (the plain version of K6a):
    ``riccati_backward_ref`` with the dynamics Hessians ``second`` (a
    ``SecondOrderModel``, ``[..., T]``-leading) contracted with the value
    gradient into every Q block, and ``mu I_m`` added to QuuR."""
    return _backward_scan(lin, quad, final, mu, _cholesky_gains, second)


def riccati_backward_ddp_boxqp_ref(lin, quad, final, mu, bounds, Ubar,
                                   second, boxqp_iters: int = 8,
                                   stats=None):
    """Plain PyTorch full-DDP control-limited backward pass (the plain
    version of K6b): ``riccati_backward_boxqp_ref`` with the DDP terms of
    ``riccati_backward_ddp_ref``."""
    return _backward_scan(lin, quad, final, mu,
                          _boxqp_gains(bounds, Ubar, boxqp_iters, stats),
                          second)


def _backward_scan(lin, quad, final, mu, gains, second=None):
    """The reverse loop shared by the plain versions: Q blocks with the
    regularized ``V + mu I``, the full-DDP terms when ``second`` is given,
    the PD probe of QuuR, ``gains(t, Q_u, QuuR, QuxR, chol) -> (K, k,
    extra_fail or None)``, dV1/dV2 from the unregularized terms and the
    symmetrized value update.

    The DDP terms (Tassa et al. 2012, eqs. 5c-5e, as the JAX package's
    ``ilqr.backward``): ``t_xx = sum_p v_p f_xx[p]``, ``t_ux``, ``t_uu``
    alike, added to Qxx, Quu and Qux and to QuuR and QuxR; the
    regularization is combined, QuuR becoming ``(QuuR + t_uu) + mu I_m``
    (``v . f_uu`` does not shrink with mu, and ``f_u`` can vanish, so the
    state regularization alone cannot restore PD). dV1, dV2 and the value
    update keep the unregularized blocks."""
    f_x, f_u = lin.f_x, lin.f_u
    T, n = f_x.shape[-3], f_x.shape[-1]
    m = f_u.shape[-1]
    batch = mu.shape
    eye = torch.eye(n, dtype=f_x.dtype, device=f_x.device)
    mu_eye = mu[..., None, None] * eye
    if second is not None:
        mu_eye_m = mu[..., None, None] * torch.eye(m, dtype=f_x.dtype,
                                                   device=f_x.device)
    V, v = final.l_xx, final.l_x
    dV1 = torch.zeros(batch, dtype=f_x.dtype, device=f_x.device)
    dV2 = torch.zeros_like(dV1)
    fail = torch.zeros(batch, dtype=torch.bool, device=f_x.device)
    Ks, ks = [None] * T, [None] * T
    for t in reversed(range(T)):
        fx, fu = f_x[..., t, :, :], f_u[..., t, :, :]
        fxT, fuT = fx.mT, fu.mT
        fuT_V = fuT @ V
        fuT_Vreg = fuT @ (V + mu_eye)

        Q_x = quad.l_x[..., t, :] + _mv(fxT, v)
        Q_u = quad.l_u[..., t, :] + _mv(fuT, v)
        Q_xx = quad.l_xx[..., t, :, :] + fxT @ (V @ fx)
        Q_uu = quad.l_uu[..., t, :, :] + fuT_V @ fu
        Q_ux = quad.l_ux[..., t, :, :] + fuT_V @ fx
        Quu_reg = quad.l_uu[..., t, :, :] + fuT_Vreg @ fu
        Qux_reg = quad.l_ux[..., t, :, :] + fuT_Vreg @ fx

        if second is not None:
            t_xx, t_ux, t_uu = (
                torch.einsum("...p,...pij->...ij", v, h[..., t, :, :, :])
                for h in (second.f_xx, second.f_ux, second.f_uu))
            Q_xx = Q_xx + t_xx
            Q_uu = Q_uu + t_uu
            Q_ux = Q_ux + t_ux
            Quu_reg = Quu_reg + t_uu + mu_eye_m
            Qux_reg = Qux_reg + t_ux

        chol, info = torch.linalg.cholesky_ex(Quu_reg)
        fail = fail | (info != 0) | ~torch.isfinite(chol).all(dim=(-2, -1))
        K, k, extra_fail = gains(t, Q_u, Quu_reg, Qux_reg, chol)
        if extra_fail is not None:
            fail = fail | extra_fail

        dV1 = dV1 + (k * Q_u).sum(dim=-1)
        dV2 = dV2 + 0.5 * (k * _mv(Q_uu, k)).sum(dim=-1)

        KT = K.mT
        V = Q_xx + KT @ (Q_uu @ K) + KT @ Q_ux + Q_ux.mT @ K
        V = 0.5 * (V + V.mT)
        v = Q_x + _mv(KT, _mv(Q_uu, k)) + _mv(KT, Q_u) + _mv(Q_ux.mT, k)
        Ks[t], ks[t] = K, k
    policy = Policy(K=torch.stack(Ks, dim=-3), k=torch.stack(ks, dim=-2))
    return ~fail, policy, dV1, dV2


def _to_k(a, B, T, e):
    """``[B, T, ...]`` -> ``[T, e, B]``, contiguous."""
    return a.reshape(B, T, e).permute(1, 2, 0).contiguous()


def _to_kernel_layout(lin, quad, final, mu, bounds=None, Ubar=None):
    """Solver layout ``[B, T, ...]`` -> kernel layout ``[T, entries, B]``;
    with ``bounds`` and ``Ubar`` also K4's ``ubar [T, m, B]`` and
    ``lo``/``hi [m]``."""
    B, T, n, _ = lin.f_x.shape
    m = lin.f_u.shape[-1]
    dtype = lin.f_x.dtype
    args = dict(
        fx=_to_k(lin.f_x, B, T, n * n),
        fu=_to_k(lin.f_u, B, T, n * m),
        lx=_to_k(quad.l_x, B, T, n),
        lu=_to_k(quad.l_u, B, T, m),
        lxx=_to_k(quad.l_xx, B, T, n * n),
        luu=_to_k(quad.l_uu, B, T, m * m),
        lux=_to_k(quad.l_ux, B, T, m * n),
        mu=mu.to(dtype).contiguous(),
        VT=final.l_xx.reshape(B, n * n).T.contiguous(),
        vT=final.l_x.T.contiguous(),
    )
    if bounds is not None:
        side = lambda a: torch.broadcast_to(  # noqa: E731
            a.to(dtype), (m,)).contiguous()
        args.update(ubar=_to_k(Ubar.to(dtype), B, T, m), lo=side(bounds.low),
                    hi=side(bounds.high))
    return args


def _second_to_kernel_layout(second):
    """A ``SecondOrderModel`` over ``[B, T]`` -> ``fxx [T, n*n*n, B]``,
    ``fux [T, n*m*n, B]`` and ``fuu [T, n*m*m, B]``, entry indices
    ``(p*n + i)*n + j``, ``(p*m + a)*n + i`` and ``(p*m + a)*m + c``
    (output component p major, as the JAX kernel's)."""
    B, T, n, m, _ = second.f_ux.shape
    return dict(fxx=_to_k(second.f_xx, B, T, n * n * n),
                fux=_to_k(second.f_ux, B, T, n * m * n),
                fuu=_to_k(second.f_uu, B, T, n * m * m))


# Argument order of the launchers, and of the C entries after their ints
# (the JAX kernel's input order: first order, boxQP, DDP, final value).
K1_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "VT", "vT")
K4_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "ubar", "lo",
           "hi", "VT", "vT")
K6A_ARGS = K1_ARGS[:8] + ("fxx", "fux", "fuu") + K1_ARGS[8:]
K6B_ARGS = K4_ARGS[:11] + ("fxx", "fux", "fuu") + K4_ARGS[11:]


def _outputs(T, n, m, B, like):
    opts = dict(dtype=like.dtype, device=like.device)
    K = torch.empty((T, m * n, B), **opts)
    k = torch.empty((T, m, B), **opts)
    dV1, dV2, fail = (torch.empty((B,), **opts) for _ in range(3))
    return K, k, dV1, dV2, fail


def _launch(entry, variant, first, box, second, final, boxqp_iters=None,
            plan=None):
    """Check kernel-layout inputs, allocate the outputs and launch the C
    entry ``entry`` with ``plan`` (``lane_plan``'s for ``variant``, these
    dims, batch and dtype by default): ``first`` = (fx, fu, lx, lu, lxx,
    luu, lux, mu), ``box`` = (ubar, lo, hi) or (), ``second`` = (fxx, fux,
    fuu) or (), ``final`` = (VT, vT). Returns ``(K [T, m*n, B], k [T, m,
    B], dV1 [B], dV2 [B], fail [B])``, ``fail`` 1.0 on lanes whose PD probe
    failed."""
    fx, lx, lu = first[0], first[2], first[3]
    T, nn, B = fx.shape
    n, m = lx.shape[1], lu.shape[1]
    shapes_ok = nn == n * n
    if box:
        ubar, lo, hi = box
        shapes_ok &= ubar.shape == (T, m, B) and lo.shape == hi.shape == (m,)
    if second:
        shapes_ok &= tuple(a.shape for a in second) == (
            (T, n * n * n, B), (T, n * m * n, B), (T, n * m * m, B))
    inputs = first + box + second + final
    _check_inputs(entry, inputs, (n, m), shapes_ok)
    ints = (n, m, T, B)
    if boxqp_iters is not None:
        if boxqp_iters < 0:
            raise ValueError("boxqp_iters must be >= 0")
        ints += (boxqp_iters,)
    if plan is None:
        plan = lane_plan(variant, n, m, B, fx.dtype, sms=_sm_count(fx.device))
    code = _build.DTYPE_CODES[fx.dtype]
    smem = _kernel_smem_bytes(variant, code, n, m, plan.scenarios)
    if smem != plan.smem_bytes or smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: the plan's {plan.smem_bytes} bytes of "
                         f"shared memory at {(n, m)} are not the kernel's "
                         f"{smem}, or exceed a block's {SMEM_LIMIT}")
    out = _outputs(T, n, m, B, fx)
    rc = getattr(_build.library(), "tfmpc_" + entry)(
        code, *ints,
        *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out),
        plan.groups, plan.scenarios, plan.smem_bytes, _build.stream(),
    )
    if rc != 0:
        _build.check(rc, f"{entry} with {plan.groups} lanes a scenario at "
                     f"{(n, m)} {fx.dtype}")
    return out


def riccati_backward_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT,
                            plan: LanePlan | None = None):
    """Launch K1 on kernel-layout tensors ``[T, entries, B]`` (with
    ``plan``, or ``lane_plan``'s).

    Returns ``(K [T, m*n, B], k [T, m, B], dV1 [B], dV2 [B], fail [B])``
    with ``fail`` 1.0 on lanes whose Cholesky probe failed.
    """
    global LAUNCHES
    out = _launch("riccati_backward", "ilqr",
                  (fx, fu, lx, lu, lxx, luu, lux, mu), (), (), (VT, vT),
                  plan=plan)
    LAUNCHES += 1
    return out


def riccati_backward_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, ubar,
                                  lo, hi, VT, vT, boxqp_iters: int = 8,
                                  plan: LanePlan | None = None):
    """Launch K4 on kernel-layout tensors ``[T, entries, B]``, ``ubar [T, m,
    B]`` and bounds ``lo``/``hi [m]``; outputs as
    ``riccati_backward_kernel``."""
    global BOXQP_LAUNCHES
    out = _launch("riccati_backward_boxqp", "boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu), (ubar, lo, hi), (),
                  (VT, vT), boxqp_iters, plan)
    BOXQP_LAUNCHES += 1
    return out


def riccati_backward_ddp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, fxx, fux,
                                fuu, VT, vT, plan: LanePlan | None = None):
    """Launch K6a on kernel-layout tensors ``[T, entries, B]`` with the
    dynamics Hessians ``fxx [T, n*n*n, B]``, ``fux [T, n*m*n, B]``, ``fuu
    [T, n*m*m, B]``; outputs as ``riccati_backward_kernel``."""
    global DDP_LAUNCHES
    out = _launch("riccati_backward_ddp", "ddp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu), (), (fxx, fux, fuu),
                  (VT, vT), plan=plan)
    DDP_LAUNCHES += 1
    return out


def riccati_backward_ddp_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu,
                                      ubar, lo, hi, fxx, fux, fuu, VT, vT,
                                      boxqp_iters: int = 8,
                                      plan: LanePlan | None = None):
    """Launch K6b: K4's inputs plus K6a's Hessians; outputs as
    ``riccati_backward_kernel``."""
    global DDP_BOXQP_LAUNCHES
    out = _launch("riccati_backward_ddp_boxqp", "ddp_boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu), (ubar, lo, hi),
                  (fxx, fux, fuu), (VT, vT), boxqp_iters, plan)
    DDP_BOXQP_LAUNCHES += 1
    return out


def _check_inputs(name, inputs, dims, shapes_ok):
    dev, dtype = inputs[0].device, inputs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if dims not in KERNEL_DIMS:
        raise NotImplementedError(
            f"{name} has no CUDA instantiation for (n, m) = {dims} "
            f"(compiled: {sorted(KERNEL_DIMS)}); other dims up to 48 run "
            "through K7 (ops/riccati_mid.py), or run with use_pallas=False"
        )
    if not shapes_ok or any(
        a.device != dev or a.dtype != dtype or not a.is_contiguous()
        for a in inputs
    ):
        raise ValueError(
            "kernel inputs must share one device and dtype, be contiguous "
            "and have consistent [T, entries, B] shapes"
        )


def _from_kernel_layout(out, B, T, n, m):
    K, k, dV1, dV2, fail = out
    policy = Policy(
        K=K.permute(2, 0, 1).reshape(B, T, m, n),
        k=k.permute(2, 0, 1),
    )
    return fail == 0.0, policy, dV1, dV2


def riccati_backward(lin, quad, final, mu):
    """K1's wrapper: batched backward pass over ``[B, T, ...]``
    linearizations, ``mu [B]``.

    Returns ``(ok [B], Policy(K [B, T, m, n], k [B, T, m]), dV1, dV2)``.
    CUDA tensors go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    global PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        PLAIN_CALLS += 1
        return riccati_backward_ref(lin, quad, final, mu)
    B, T, n, _ = lin.f_x.shape
    a = _to_kernel_layout(lin, quad, final, mu)
    out = riccati_backward_kernel(*(a[k] for k in K1_ARGS))
    return _from_kernel_layout(out, B, T, n, lin.f_u.shape[-1])


def riccati_backward_boxqp(lin, quad, final, mu, bounds, Ubar,
                           boxqp_iters: int = 8):
    """K4's wrapper: the control-limited backward pass over ``[B, T, ...]``
    linearizations, ``mu [B]``, the env's ``bounds`` and the nominal
    controls ``Ubar [B, T, m]``. Returns what ``riccati_backward`` returns.
    CUDA tensors go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    global BOXQP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        BOXQP_PLAIN_CALLS += 1
        return riccati_backward_boxqp_ref(lin, quad, final, mu, bounds, Ubar,
                                          boxqp_iters)
    B, T, n, _ = lin.f_x.shape
    a = _to_kernel_layout(lin, quad, final, mu, bounds, Ubar)
    out = riccati_backward_boxqp_kernel(*(a[k] for k in K4_ARGS),
                                        boxqp_iters=boxqp_iters)
    return _from_kernel_layout(out, B, T, n, lin.f_u.shape[-1])


def riccati_backward_ddp(lin, quad, final, mu, second):
    """K6a's wrapper: the full-DDP backward pass over ``[B, T, ...]``
    linearizations and dynamics Hessians ``second``, ``mu [B]``. Returns
    what ``riccati_backward`` returns. CUDA tensors go through the CUDA
    kernel; CPU tensors through the plain version.
    """
    global DDP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        DDP_PLAIN_CALLS += 1
        return riccati_backward_ddp_ref(lin, quad, final, mu, second)
    B, T, n, _ = lin.f_x.shape
    a = _to_kernel_layout(lin, quad, final, mu)
    a.update(_second_to_kernel_layout(second))
    out = riccati_backward_ddp_kernel(*(a[k] for k in K6A_ARGS))
    return _from_kernel_layout(out, B, T, n, lin.f_u.shape[-1])


def riccati_backward_ddp_boxqp(lin, quad, final, mu, bounds, Ubar, second,
                               boxqp_iters: int = 8):
    """K6b's wrapper: the full-DDP control-limited backward pass (K4's
    inputs plus ``second``). Returns what ``riccati_backward`` returns. CUDA
    tensors go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    global DDP_BOXQP_PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        DDP_BOXQP_PLAIN_CALLS += 1
        return riccati_backward_ddp_boxqp_ref(lin, quad, final, mu, bounds,
                                              Ubar, second, boxqp_iters)
    B, T, n, _ = lin.f_x.shape
    a = _to_kernel_layout(lin, quad, final, mu, bounds, Ubar)
    a.update(_second_to_kernel_layout(second))
    out = riccati_backward_ddp_boxqp_kernel(*(a[k] for k in K6B_ARGS),
                                            boxqp_iters=boxqp_iters)
    return _from_kernel_layout(out, B, T, n, lin.f_u.shape[-1])


def _mid_lanes(ka, VT, vT, mu, box, boxqp_iters):
    """The small-dims kernel's K1, or with ``box`` its K4
    (``ops/riccati_small.py``; above its dims K7's iLQR or boxQP variant),
    on ``riccati_backward_lanes``' kernel-layout tensors at dims without a
    lane instantiation: the blocks to the solver's ``[B, T, ...]`` layout
    those kernels take and the policy back to ``(K [T, m*n, B], k [T, m,
    B])``; counted as the launched kernel's launches."""
    from tfmpc_tpu_torch.ops import riccati_mid, riccati_small

    T, _, B = ka["fx"].shape
    n, m = ka["lx"].shape[1], ka["lu"].shape[1]

    def lanes(a, *shape):  # [T, e, B] -> [B, T, *shape], contiguous
        return a.permute(2, 0, 1).reshape(B, T, *shape).contiguous()

    ins = (lanes(ka["fx"], n, n), lanes(ka["fu"], n, m), lanes(ka["lx"], n),
           lanes(ka["lu"], m), lanes(ka["lxx"], n, n),
           lanes(ka["luu"], m, m), lanes(ka["lux"], m, n),
           mu.to(ka["fx"].dtype).contiguous())
    final = (VT.T.reshape(B, n, n).contiguous(), vT.T.contiguous())
    small = riccati_small.small_kernel_supported(n, m)
    if box is None:
        launch = (riccati_small.riccati_backward_small_kernel if small
                  else riccati_mid.riccati_backward_mid_kernel)
        out = launch(*ins, *final)
    else:
        ubar, lo, hi = box
        launch = (riccati_small.riccati_backward_small_boxqp_kernel if small
                  else riccati_mid.riccati_backward_mid_boxqp_kernel)
        out = launch(*ins, lanes(ubar, m), lo, hi, *final,
                     boxqp_iters=boxqp_iters)
    K, k, dV1, dV2, fail = out
    return fail == 0.0, (_to_k(K, B, T, m * n), _to_k(k, B, T, m)), dV1, dV2


def riccati_backward_lanes(ka, VT, vT, mu, box=None, boxqp_iters: int = 8):
    """The fused iteration's backward pass on kernel-layout tensors: ``ka``
    the linearization blocks ``fx, fu, lx, lu, lxx, luu, lux`` ``[T,
    entries, B]`` (K8's output), the final value ``VT [n*n, B]``, ``vT [n,
    B]`` and ``mu [B]``; with ``box = (ubar [T, m, B], lo [m], hi [m])``
    K4's control-limited pass, else K1's. Returns ``(ok [B], (K [T, m*n,
    B], k [T, m, B]), dV1 [B], dV2 [B])``, the policy in the layout K2 and
    K8 take as it is. CUDA tensors launch K1 or K4 at ``KERNEL_DIMS``, and
    at other dims the small-dims kernel's K1 or K4 (K7's above n, m = 12;
    through the solver layout and back, ``_mid_lanes``); CPU tensors run
    the plain version through the solver layout and back (counted as the
    plain calls of K1's or K4's wrapper).
    """
    global PLAIN_CALLS, BOXQP_PLAIN_CALLS
    T, _, B = ka["fx"].shape
    n, m = ka["lx"].shape[1], ka["lu"].shape[1]
    if ka["fx"].device.type != "cpu":
        if (n, m) not in KERNEL_DIMS:
            return _mid_lanes(ka, VT, vT, mu, box, boxqp_iters)
        first = tuple(ka[key] for key in K1_ARGS[:7]) + (
            mu.to(ka["fx"].dtype).contiguous(),)
        if box is None:
            out = riccati_backward_kernel(*first, VT, vT)
        else:
            out = riccati_backward_boxqp_kernel(*first, *box, VT, vT,
                                                boxqp_iters=boxqp_iters)
        K, k, dV1, dV2, fail = out
        return fail == 0.0, (K, k), dV1, dV2

    def lanes(key, *shape):  # [T, e, B] -> [B, T, *shape]
        return ka[key].permute(2, 0, 1).reshape(B, T, *shape)

    lin = LinearModel(f=None, f_x=lanes("fx", n, n), f_u=lanes("fu", n, m))
    quad = QuadraticModel(l=None, l_x=lanes("lx", n), l_u=lanes("lu", m),
                          l_xx=lanes("lxx", n, n), l_uu=lanes("luu", m, m),
                          l_ux=lanes("lux", m, n))
    final = QuadraticFinal(l=None, l_x=vT.T, l_xx=VT.T.reshape(B, n, n))
    if box is None:
        PLAIN_CALLS += 1
        ok, policy, dV1, dV2 = riccati_backward_ref(lin, quad, final, mu)
    else:
        BOXQP_PLAIN_CALLS += 1
        ubar, lo, hi = box
        ok, policy, dV1, dV2 = riccati_backward_boxqp_ref(
            lin, quad, final, mu, Bounds(low=lo, high=hi),
            ubar.permute(2, 0, 1), boxqp_iters)
    return ok, (_to_k(policy.K, B, T, m * n), _to_k(policy.k, B, T, m)), \
        dV1, dV2
