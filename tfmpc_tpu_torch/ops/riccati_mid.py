"""K7: the batched Riccati backward pass at mid dims, and its probe P1.

Counterpart of ``tfmpc_tpu/ops/riccati_mid_pallas.py`` (K7) and of
``benchmarks/mxu_probe.py::_row_kernel_matmul`` (P1). K7 has the contract
of K1 and K4 (``ops/riccati.py``) for any ``1 <= n, m <= 48``, n != m
included: ``riccati_backward_mid`` (plain iLQR gains) and
``riccati_backward_mid_boxqp`` (control-limited, boxQP gains) return ``(ok
[B], Policy(K [B, T, m, n], k [B, T, m]), dV1 [B], dV2 [B])``. On a CUDA
tensor they launch the CUDA kernel of ``csrc/riccati_mid.cu`` (one thread
block per scenario, the matrices in shared memory) or raise; on a CPU
tensor they run the plain versions ``riccati_backward_mid_ref`` and
``riccati_backward_mid_boxqp_ref``, which are ``ops/riccati.py``'s plain
versions of K1 and K4: they hold for any (n, m), and the JAX package pins
its mid kernel to the same contract (``tests/test_riccati_mid.py``).

The kernel clamps every Cholesky pivot at 1e-30, its boxQP's Newton
systems included (``_chol_rows``), where the plain version lets NaN
propagate; the two differ only on lanes whose PD probe already failed, so
they are compared with identical ok masks, on the ok lanes. The kernel
computes in double for float32 inputs too (rounding its outputs once):
the float32 boxQP backward is ill-conditioned, and the plain version's
float32 result is the less accurate one.

K7's raw launchers take the solver's own layout (``[B, T, ...]``,
contiguous): a block reads its scenario's contiguous entries, so no permute
into the lane kernels' ``[T, entries, B]`` is needed.

P1, ``row_matmul``, computes ``C[b] = A[b] M[b]`` for d x d matrices in the
JAX probe's row layout ``[d*d, B]``: K7's core operation alone, on no
solver path. ``row_matmul_ref`` is its plain version.

``MID_LAUNCHES``, ``MID_BOXQP_LAUNCHES`` and ``ROW_MATMUL_LAUNCHES`` count
kernel launches; the matching ``*_PLAIN_CALLS`` the calls that took the
plain version.
"""

from __future__ import annotations

import torch

from tfmpc_tpu_torch.core.types import Policy
from tfmpc_tpu_torch.ops import _build
from tfmpc_tpu_torch.ops.riccati import (
    riccati_backward_boxqp_ref,
    riccati_backward_ref,
)

MID_LAUNCHES = 0
MID_PLAIN_CALLS = 0
MID_BOXQP_LAUNCHES = 0
MID_BOXQP_PLAIN_CALLS = 0
ROW_MATMUL_LAUNCHES = 0
ROW_MATMUL_PLAIN_CALLS = 0

# The kernel's envelope: every (n, m) with 1 <= n, m <= MID_DIM_MAX; its
# shared memory at (48, 48) is 214,016 bytes of the 232,448 a block may
# have (csrc/riccati_mid.cu; the block computes in double for both
# dtypes).
MID_DIM_MAX = 48
SMEM_LIMIT = 232448
# P1's block (csrc/row_matmul.cu).
ROW_BLOCK = 256

# The plain versions: K1's and K4's, general in (n, m).
riccati_backward_mid_ref = riccati_backward_ref
riccati_backward_mid_boxqp_ref = riccati_backward_boxqp_ref

# Argument order of the launchers and of the C entries (the JAX kernel's).
MID_ARGS = ("fx", "fu", "lx", "lu", "lxx", "luu", "lux", "mu", "VT", "vT")
MID_BOXQP_ARGS = MID_ARGS[:8] + ("ubar", "lo", "hi") + MID_ARGS[8:]


def mid_kernel_supported(n: int, m: int) -> bool:
    """Whether K7 runs at these dims: ``1 <= min(n, m)`` and ``max(n, m)
    <= 48``, both variants, float32 and float64."""
    return 1 <= min(n, m) and max(n, m) <= MID_DIM_MAX


def mid_block(n: int, m: int) -> int:
    """Threads per block (one block per scenario): 128 up to HVAC-16's
    dims, where a 16 x 16 product has 256 entries, 256 above."""
    return 128 if max(n, m) <= 16 else 256


def mid_layout(lin, quad, final, mu, bounds=None, Ubar=None):
    """The solver's tensors as K7 takes them: contiguous, in the
    linearization's dtype; with ``bounds`` and ``Ubar`` also ``ubar [B, T,
    m]`` and the box ``lo``/``hi [m]``."""
    dtype = lin.f_x.dtype
    c = lambda a: a.to(dtype).contiguous()  # noqa: E731
    args = dict(fx=c(lin.f_x), fu=c(lin.f_u), lx=c(quad.l_x), lu=c(quad.l_u),
                lxx=c(quad.l_xx), luu=c(quad.l_uu), lux=c(quad.l_ux),
                mu=c(mu), VT=c(final.l_xx), vT=c(final.l_x))
    if bounds is not None:
        m = lin.f_u.shape[-1]
        side = lambda a: c(torch.broadcast_to(a.to(dtype), (m,)))  # noqa: E731
        args.update(ubar=c(Ubar), lo=side(bounds.low), hi=side(bounds.high))
    return args


def _launch(entry, inputs, box, boxqp_iters=None):
    """Check K7's inputs (``MID_ARGS`` order, ``MID_BOXQP_ARGS`` with
    ``box``), allocate the outputs and launch the C entry. Returns ``(K [B,
    T, m, n], k [B, T, m], dV1 [B], dV2 [B], fail [B])``, ``fail`` 1.0 on
    lanes whose PD probe failed."""
    fx, fu = inputs[0], inputs[1]
    dev, dtype = fx.device, fx.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if fx.ndim != 4 or fu.ndim != 4:
        raise ValueError("K7 takes [B, T, ...] inputs")
    B, T, n, m = fu.shape
    if not mid_kernel_supported(n, m):
        raise NotImplementedError(
            f"{entry}: no CUDA kernel for (n, m) = {(n, m)} (K7 takes "
            f"1 <= n, m <= {MID_DIM_MAX}); run with use_pallas=False")
    shapes = [(B, T, n, n), (B, T, n, m), (B, T, n), (B, T, m),
              (B, T, n, n), (B, T, m, m), (B, T, m, n), (B,)]
    if box:
        shapes += [(B, T, m), (m,), (m,)]
    shapes += [(B, n, n), (B, n)]
    if tuple(a.shape for a in inputs) != tuple(shapes) or any(
            a.device != dev or a.dtype != dtype or not a.is_contiguous()
            for a in inputs):
        raise ValueError(
            "K7's inputs must share one device and dtype, be contiguous and "
            "have the solver's [B, T, ...] shapes")
    lib = _build.library()
    code = _build.DTYPE_CODES[dtype]
    smem = lib.tfmpc_riccati_mid_smem_bytes(n, m)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: {smem} bytes of shared memory at "
                         f"{(n, m)} exceed a block's {SMEM_LIMIT}")
    ints = (n, m, T, B)
    if boxqp_iters is not None:
        if boxqp_iters < 0:
            raise ValueError("boxqp_iters must be >= 0")
        ints += (boxqp_iters,)
    opts = dict(dtype=dtype, device=dev)
    out = (torch.empty((B, T, m, n), **opts), torch.empty((B, T, m), **opts),
           *(torch.empty((B,), **opts) for _ in range(3)))
    rc = getattr(lib, "tfmpc_" + entry)(
        code, *ints, *(_build.ptr(a) for a in inputs),
        *(_build.ptr(a) for a in out), mid_block(n, m), _build.stream())
    _build.check(rc, entry)
    return out


def riccati_backward_mid_kernel(fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT):
    """Launch K7's iLQR variant on the solver-layout tensors of
    ``mid_layout``. Returns ``(K [B, T, m, n], k [B, T, m], dV1 [B], dV2
    [B], fail [B])``, ``fail`` 1.0 on lanes whose PD probe failed."""
    global MID_LAUNCHES
    out = _launch("riccati_backward_mid",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, VT, vT), False)
    MID_LAUNCHES += 1
    return out


def riccati_backward_mid_boxqp_kernel(fx, fu, lx, lu, lxx, luu, lux, mu,
                                      ubar, lo, hi, VT, vT,
                                      boxqp_iters: int = 8):
    """Launch K7's boxQP variant: the inputs of the iLQR variant plus
    ``ubar [B, T, m]`` and the box ``lo``/``hi [m]``; outputs as
    ``riccati_backward_mid_kernel``."""
    global MID_BOXQP_LAUNCHES
    out = _launch("riccati_backward_mid_boxqp",
                  (fx, fu, lx, lu, lxx, luu, lux, mu, ubar, lo, hi, VT, vT),
                  True, boxqp_iters)
    MID_BOXQP_LAUNCHES += 1
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


# -- P1 ------------------------------------------------------------------------

def row_matmul_ref(A_rows, M_rows, d: int):
    """Plain version of P1: ``C[b] = A[b] M[b]`` with entry ``i*d + j`` of
    scenario ``b`` at ``[i*d + j, b]``; returns ``C [d*d, B]``."""
    B = A_rows.shape[-1]
    C = torch.einsum("ikb,kjb->ijb", A_rows.reshape(d, d, B),
                     M_rows.reshape(d, d, B))
    return C.reshape(d * d, B)


def row_matmul_kernel(A_rows, M_rows, d: int):
    """Launch P1 on CUDA tensors ``A_rows``, ``M_rows [d*d, B]``."""
    global ROW_MATMUL_LAUNCHES
    dev, dtype = A_rows.device, A_rows.dtype
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32/float64, got {dtype}")
    if not 1 <= d <= MID_DIM_MAX:
        raise NotImplementedError(f"row_matmul takes 1 <= d <= "
                                  f"{MID_DIM_MAX}, got {d}")
    if A_rows.ndim != 2 or A_rows.shape[0] != d * d \
            or M_rows.shape != A_rows.shape or M_rows.device != dev \
            or M_rows.dtype != dtype or not A_rows.is_contiguous() \
            or not M_rows.is_contiguous():
        raise ValueError("row_matmul takes two contiguous [d*d, B] tensors "
                         "of one device and dtype")
    C = torch.empty_like(A_rows)
    rc = _build.library().tfmpc_row_matmul(
        _build.DTYPE_CODES[dtype], d, A_rows.shape[1], _build.ptr(A_rows),
        _build.ptr(M_rows), _build.ptr(C), ROW_BLOCK, _build.stream())
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
