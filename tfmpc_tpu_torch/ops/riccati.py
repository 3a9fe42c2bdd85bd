"""K1: the batched regularized Riccati backward pass of iLQR.

Counterpart of ``tfmpc_tpu/ops/riccati_pallas.py`` (unconstrained variant).
``riccati_backward`` is the solver's entry: on a CUDA tensor it launches the
CUDA kernel (``csrc/riccati.cu``) or raises; on a CPU tensor it runs the
plain PyTorch version ``riccati_backward_ref``. ``LAUNCHES`` counts kernel
launches and ``PLAIN_CALLS`` the calls that took the plain version.

Both compute, per scenario and for t = T-1 .. 0, the Q blocks from the
linearization and the carried value function, the regularized
``Quu + f_u^T mu f_u`` (Tassa's ``V + mu I``), its Cholesky factor with a
per-lane PD probe, ``k = -QuuR^-1 Q_u``, ``K = -QuuR^-1 QuxR``, the expected
improvement ``dV1``/``dV2`` from the unregularized Q terms, and the
symmetrized value update.
"""

from __future__ import annotations

import torch

from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.ops import _build

LAUNCHES = 0
PLAIN_CALLS = 0

# (n, m) pairs the CUDA kernel is instantiated for (csrc/riccati.cu).
KERNEL_DIMS = {(2, 2)}
# Threads per block: at B=4096, 32 gives 128 blocks, which spread over 128
# of the H100's 132 SMs (one thread per scenario, see csrc/riccati.cu).
BLOCK = 32


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
        K = -torch.cholesky_solve(Qux_reg, chol)
        k = -torch.cholesky_solve(Q_u[..., None], chol)[..., 0]

        dV1 = dV1 + (k * Q_u).sum(dim=-1)
        dV2 = dV2 + 0.5 * (k * _mv(Q_uu, k)).sum(dim=-1)

        KT = K.mT
        V = Q_xx + KT @ (Q_uu @ K) + KT @ Q_ux + Q_ux.mT @ K
        V = 0.5 * (V + V.mT)
        v = Q_x + _mv(KT, _mv(Q_uu, k)) + _mv(KT, Q_u) + _mv(Q_ux.mT, k)
        Ks[t], ks[t] = K, k
    policy = Policy(K=torch.stack(Ks, dim=-3), k=torch.stack(ks, dim=-2))
    return ~fail, policy, dV1, dV2


def _to_kernel_layout(lin, quad, final, mu):
    """Solver layout ``[B, T, ...]`` -> kernel layout ``[T, entries, B]``."""
    B, T, n, _ = lin.f_x.shape
    m = lin.f_u.shape[-1]

    def to_k(a, e):
        return a.reshape(B, T, e).permute(1, 2, 0).contiguous()

    return dict(
        fx=to_k(lin.f_x, n * n),
        fu=to_k(lin.f_u, n * m),
        lx=to_k(quad.l_x, n),
        lu=to_k(quad.l_u, m),
        lxx=to_k(quad.l_xx, n * n),
        luu=to_k(quad.l_uu, m * m),
        lux=to_k(quad.l_ux, m * n),
        mu=mu.to(lin.f_x.dtype).contiguous(),
        VT=final.l_xx.reshape(B, n * n).T.contiguous(),
        vT=final.l_x.T.contiguous(),
    )


def riccati_backward_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT):
    """Launch the CUDA kernel on kernel-layout tensors ``[T, entries, B]``.

    Returns ``(K [T, m*n, B], k [T, m, B], dV1 [B], dV2 [B], fail [B])``
    with ``fail`` 1.0 on lanes whose Cholesky probe failed.
    """
    global LAUNCHES
    T, nn, B = fx.shape
    n = lx.shape[1]
    m = lu.shape[1]
    inputs = (fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT)
    _check_inputs(inputs, (n, m), nn == n * n)
    opts = dict(dtype=fx.dtype, device=fx.device)
    K = torch.empty((T, m * n, B), **opts)
    k = torch.empty((T, m, B), **opts)
    dV1, dV2, fail = (torch.empty((B,), **opts) for _ in range(3))
    lib = _build.library()
    rc = lib.tfmpc_riccati_backward(
        _build.DTYPE_CODES[fx.dtype], n, m, T, B,
        *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in (K, k, dV1, dV2, fail)),
        BLOCK, _build.stream(),
    )
    _build.check(rc, "riccati_backward")
    LAUNCHES += 1
    return K, k, dV1, dV2, fail


def _check_inputs(inputs, dims, shapes_ok):
    dev, dtype = inputs[0].device, inputs[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if dims not in KERNEL_DIMS:
        raise NotImplementedError(
            f"riccati_backward has no CUDA instantiation for (n, m) = {dims} "
            f"(compiled: {sorted(KERNEL_DIMS)}); run with use_pallas=False"
        )
    if not shapes_ok or any(
        a.device != dev or a.dtype != dtype or not a.is_contiguous()
        for a in inputs
    ):
        raise ValueError(
            "kernel inputs must share one device and dtype, be contiguous "
            "and have consistent [T, entries, B] shapes"
        )


def riccati_backward(lin, quad, final, mu):
    """Batched backward pass over ``[B, T, ...]`` linearizations, ``mu [B]``.

    Returns ``(ok [B], Policy(K [B, T, m, n], k [B, T, m]), dV1, dV2)``.
    CUDA tensors go through the CUDA kernel; CPU tensors through the plain
    version.
    """
    global PLAIN_CALLS
    if lin.f_x.device.type == "cpu":
        PLAIN_CALLS += 1
        return riccati_backward_ref(lin, quad, final, mu)
    B, T, n, _ = lin.f_x.shape
    m = lin.f_u.shape[-1]
    a = _to_kernel_layout(lin, quad, final, mu)
    K, k, dV1, dV2, fail = riccati_backward_kernel(
        a["fx"], a["fu"], a["lx"], a["lu"], a["lxx"], a["luu"], a["lux"],
        a["mu"], a["VT"], a["vT"],
    )
    policy = Policy(
        K=K.permute(2, 0, 1).reshape(B, T, m, n),
        k=k.permute(2, 0, 1),
    )
    return fail == 0.0, policy, dV1, dV2
