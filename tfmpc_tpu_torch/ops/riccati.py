"""K1 and K4: the batched regularized Riccati backward pass of iLQR.

Counterpart of ``tfmpc_tpu/ops/riccati_pallas.py`` (unconstrained and
control-limited variants). ``riccati_backward`` (K1) and
``riccati_backward_boxqp`` (K4) are the solver's entries: on a CUDA tensor
they launch the CUDA kernel (``csrc/riccati.cu``, ``csrc/riccati_boxqp.cu``)
or raise; on a CPU tensor they run the plain PyTorch versions
``riccati_backward_ref`` / ``riccati_backward_boxqp_ref``. ``LAUNCHES`` /
``BOXQP_LAUNCHES`` count kernel launches and ``PLAIN_CALLS`` /
``BOXQP_PLAIN_CALLS`` the calls that took the plain version.

Both compute, per scenario and for t = T-1 .. 0, the Q blocks from the
linearization and the carried value function, the regularized
``Quu + f_u^T mu f_u`` (Tassa's ``V + mu I``), its Cholesky factor with a
per-lane PD probe, the gains, the expected improvement ``dV1``/``dV2`` from
the unregularized Q terms, and the symmetrized value update. K1's gains are
``k = -QuuR^-1 Q_u``, ``K = -QuuR^-1 QuxR``; K4's ``k`` is the boxQP
minimizer within the control box shifted by the nominal control, and its
``K`` rows come from the final free set (clamped rows zero).
"""

from __future__ import annotations

import torch

from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.ops import _build
from tfmpc_tpu_torch.ops.boxqp import boxqp, solve_free_system

LAUNCHES = 0
PLAIN_CALLS = 0
BOXQP_LAUNCHES = 0
BOXQP_PLAIN_CALLS = 0

# (n, m) pairs the CUDA kernels are instantiated for (csrc/riccati.cu,
# csrc/riccati_boxqp.cu).
KERNEL_DIMS = {(2, 2)}
BOXQP_KERNEL_DIMS = {(2, 2), (3, 3), (5, 5), (6, 6)}
# Threads per block: at B=4096, 32 gives 128 blocks, which spread over 128
# of the H100's 132 SMs (one thread per scenario, see csrc/riccati.cu).
BLOCK = 32
# K4 at B=2048 (HVAC-6): 16 threads per block give 128 blocks on 128 SMs
# (csrc/riccati_boxqp.cu).
BOXQP_BLOCK = 16


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def riccati_backward_ref(lin, quad, final, mu):
    """Plain PyTorch backward pass: a loop over T of batched matmuls and
    ``cholesky_ex``.

    ``lin.f_x [..., T, n, n]`` etc. with any leading batch dims, ``mu
    [...]``. Returns ``(ok [...], Policy, dV1 [...], dV2 [...])``; a lane
    fails when any step's Cholesky reports a non-PD pivot or a non-finite
    factor (its outputs are then meaningless and discarded by the caller).
    """
    def gains(t, Q_u, Quu_reg, Qux_reg, chol):
        K = -torch.cholesky_solve(Qux_reg, chol)
        k = -torch.cholesky_solve(Q_u[..., None], chol)[..., 0]
        return K, k, None

    return _backward_scan(lin, quad, final, mu, gains)


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

    return _backward_scan(lin, quad, final, mu, gains)


def _backward_scan(lin, quad, final, mu, gains):
    """The reverse loop shared by both plain versions: Q blocks with the
    regularized ``V + mu I``, the PD probe of QuuR, ``gains(t, Q_u, QuuR,
    QuxR, chol) -> (K, k, extra_fail or None)``, dV1/dV2 from the
    unregularized terms and the symmetrized value update."""
    f_x, f_u = lin.f_x, lin.f_u
    T, n = f_x.shape[-3], f_x.shape[-1]
    batch = mu.shape
    eye = torch.eye(n, dtype=f_x.dtype, device=f_x.device)
    mu_eye = mu[..., None, None] * eye
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


def _to_kernel_layout(lin, quad, final, mu, bounds=None, Ubar=None):
    """Solver layout ``[B, T, ...]`` -> kernel layout ``[T, entries, B]``;
    with ``bounds`` and ``Ubar`` also K4's ``ubar [T, m, B]`` and
    ``lo``/``hi [m]``."""
    B, T, n, _ = lin.f_x.shape
    m = lin.f_u.shape[-1]
    dtype = lin.f_x.dtype

    def to_k(a, e):
        return a.reshape(B, T, e).permute(1, 2, 0).contiguous()

    args = dict(
        fx=to_k(lin.f_x, n * n),
        fu=to_k(lin.f_u, n * m),
        lx=to_k(quad.l_x, n),
        lu=to_k(quad.l_u, m),
        lxx=to_k(quad.l_xx, n * n),
        luu=to_k(quad.l_uu, m * m),
        lux=to_k(quad.l_ux, m * n),
        mu=mu.to(dtype).contiguous(),
        VT=final.l_xx.reshape(B, n * n).T.contiguous(),
        vT=final.l_x.T.contiguous(),
    )
    if bounds is not None:
        side = lambda a: torch.broadcast_to(  # noqa: E731
            a.to(dtype), (m,)).contiguous()
        args.update(ubar=to_k(Ubar.to(dtype), m), lo=side(bounds.low),
                    hi=side(bounds.high))
    return args


K1_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "VT", "vT")
K4_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "ubar", "lo",
           "hi", "VT", "vT")


def _outputs(T, n, m, B, like):
    opts = dict(dtype=like.dtype, device=like.device)
    K = torch.empty((T, m * n, B), **opts)
    k = torch.empty((T, m, B), **opts)
    dV1, dV2, fail = (torch.empty((B,), **opts) for _ in range(3))
    return K, k, dV1, dV2, fail


def riccati_backward_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT):
    """Launch K1 on kernel-layout tensors ``[T, entries, B]``.

    Returns ``(K [T, m*n, B], k [T, m, B], dV1 [B], dV2 [B], fail [B])``
    with ``fail`` 1.0 on lanes whose Cholesky probe failed.
    """
    global LAUNCHES
    T, nn, B = fx.shape
    n = lx.shape[1]
    m = lu.shape[1]
    inputs = (fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT)
    _check_inputs("riccati_backward", KERNEL_DIMS, inputs, (n, m),
                  nn == n * n)
    out = _outputs(T, n, m, B, fx)
    rc = _build.library().tfmpc_riccati_backward(
        _build.DTYPE_CODES[fx.dtype], n, m, T, B,
        *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out),
        BLOCK, _build.stream(),
    )
    _build.check(rc, "riccati_backward")
    LAUNCHES += 1
    return out


def riccati_backward_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, ubar,
                                  lo, hi, VT, vT, boxqp_iters: int = 8):
    """Launch K4 on kernel-layout tensors ``[T, entries, B]``, ``ubar [T, m,
    B]`` and bounds ``lo``/``hi [m]``; outputs as
    ``riccati_backward_kernel``."""
    global BOXQP_LAUNCHES
    T, nn, B = fx.shape
    n = lx.shape[1]
    m = lu.shape[1]
    inputs = (fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT)
    _check_inputs("riccati_backward_boxqp", BOXQP_KERNEL_DIMS, inputs,
                  (n, m), nn == n * n and ubar.shape == (T, m, B)
                  and lo.shape == hi.shape == (m,))
    if boxqp_iters < 0:
        raise ValueError("boxqp_iters must be >= 0")
    out = _outputs(T, n, m, B, fx)
    rc = _build.library().tfmpc_riccati_backward_boxqp(
        _build.DTYPE_CODES[fx.dtype], n, m, T, B, boxqp_iters,
        *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out),
        BOXQP_BLOCK, _build.stream(),
    )
    _build.check(rc, "riccati_backward_boxqp")
    BOXQP_LAUNCHES += 1
    return out


def _check_inputs(name, kernel_dims, inputs, dims, shapes_ok):
    dev, dtype = inputs[0].device, inputs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if dims not in kernel_dims:
        raise NotImplementedError(
            f"{name} has no CUDA instantiation for (n, m) = {dims} "
            f"(compiled: {sorted(kernel_dims)}); run with use_pallas=False"
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
