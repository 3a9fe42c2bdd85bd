"""K4 and K6b at small dims (``ops/riccati_small.py``) against the JAX
package, float64 on the CPU.

At every n, m <= 12 outside ``riccati.KERNEL_DIMS`` the port routes the
boxQP backward, with or without the full-DDP terms, to the small-dims
kernel (``csrc/riccati_small.cuh``), whose plain versions are K4's and
K6b's (``riccati.riccati_backward_boxqp_ref``, ``_ddp_boxqp_ref``). No CUDA
tensor exists on the CPU, so here the wrappers run their plain versions
(counted), and the launch plan is checked as arithmetic:

- the plan at every such (n, m), both dtypes and both variants, fits a
  block's threads and shared memory, and gives each scenario of ragged
  batches one group of lanes (``small_cover``, the kernel's map);
- the shared bytes the C side requires (``small_smem_bytes`` and
  ``small_groups`` of the header, compiled for the host with g++; only
  these cases skip, and only where g++ is absent) equal the plan's;
- the wrappers on CPU tensors are their plain versions bit for bit, one
  plain call each and no launch; the raw launchers refuse CPU tensors;
- the plain versions against the JAX lane kernel in interpret mode at (4,
  4) (B=128, T=2, as ``tests/test_riccati_pallas.py`` calls it; interpret
  mode costs ~15-25 s a call here, so 2 Newton iterations for K6b and 1
  for K4), and against the JAX scan (``ilqr.backward`` vmapped; the JAX
  package's CPU lane limit is 8) at (12, 12) and (12, 1): identical ok
  masks, K, k, dV1, dV2 within 1e-9 on the ok lanes;
- one ``solve_batch`` of reservoir-4 with full DDP and boxQP at B=130 (the
  compacted restarts run) against the JAX package's solve;
- ``ilqr_batched._BACKWARD``: the small-dims wrappers for every key of
  their family (the unconstrained ones since they have kernels of their
  own, ``tests/test_torch_riccati_small_ilqr.py``), every other key the
  wrapper it had; the fused
  iteration's ``riccati_backward_lanes`` with a box launches the
  small-dims K4 at n, m <= 12 and K7's boxQP variant above (the launchers
  stubbed).
"""

import dataclasses
import json
import re
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_riccati_mid import _synthetic
from tfmpc_tpu.core.types import (
    Bounds as JBounds,
    SecondOrderModel as JSecondOrderModel,
)
from tfmpc_tpu.models.registry import make_env as jax_make_env
from tfmpc_tpu.ops.riccati_pallas import (
    riccati_backward_boxqp_pallas,
    riccati_backward_ddp_boxqp_pallas,
)
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.core.types import (
    Bounds,
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)
from tfmpc_tpu_torch.models.registry import make_env
from tfmpc_tpu_torch.ops import riccati, riccati_mid, riccati_small
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tfmpc_tpu_torch" / "ops" / "csrc"
TOL = dict(rtol=1e-9, atol=1e-9)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# every dim the small-dims kernel takes on the solver's route
SMALL_DIMS = [(n, m) for n in range(1, 13) for m in range(1, 13)
              if (n, m) not in riccati.KERNEL_DIMS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the launch plan ----------------------------------------------------------

@pytest.mark.parametrize("ddp", [False, True], ids=["boxqp", "ddp_boxqp"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_small_plan_fits_every_dim(dtype, ddp):
    """At every (n, m) of ``SMALL_DIMS`` and batches of 1, 128, 401, 1023
    and 2048 the plan's lanes are the smallest power of two >= max(n, m)
    (2 at least, 16 at most), its block holds at most SMALL_MAX_THREADS
    threads and SMEM_LIMIT shared bytes, its bytes are
    ``small_smem_bytes``' (with the Hessians staged or in place, as the
    plan says), and each scenario gets one group."""
    dtype = DTYPES[dtype]
    for n, m in SMALL_DIMS:
        G = riccati_small.small_groups(n, m)
        assert G in (2, 4, 8, 16) and G >= max(n, m) and (G == 2 or
                                                         G < 2 * max(n, m))
        for Bb in (1, 128, 401, 1023, 2048):
            plan = riccati_small.small_plan(n, m, Bb, dtype, ddp)
            assert plan.groups == G
            assert plan.threads <= riccati_small.SMALL_MAX_THREADS
            assert plan.smem_bytes == riccati_small.small_smem_bytes(
                n, m, dtype, ddp, plan.scenarios, stage_h=plan.stage_h)
            assert plan.smem_bytes <= riccati_mid.SMEM_LIMIT
            cover = riccati_small.small_cover(plan, Bb)
            assert cover.shape == (Bb,) and (cover == 1).all(), (n, m, Bb)


_HOST_STANDIN = """
#pragma once
#include <math.h>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
#define __shared__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct HostDim3 { unsigned x, y, z; };
extern HostDim3 threadIdx, blockIdx, blockDim;
void __syncwarp(unsigned);
template <class T> T __shfl_sync(unsigned, T, int, int);
template <class T> T __shfl_xor_sync(unsigned, T, int, int);
unsigned __ballot_sync(unsigned, int);
int __all_sync(unsigned, int);
int __any_sync(unsigned, int);
long long clock64();
size_t __cvta_generic_to_shared(const void*);
float __int_as_float(int);
double __longlong_as_double(long long);
double __drcp_rn(double);
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
cudaError_t cudaGetLastError();
"""

_HOST_ENTRY = """
#include "riccati_small.cuh"
extern "C" long long small_smem_bytes(int dtype, int ddp, int n, int m,
                                      int spb) {
  return tfmpc::small_smem_bytes(n, m, dtype == tfmpc::kFloat64 ? 8 : 4,
                                 ddp != 0, spb);
}
extern "C" int small_groups(int n, int m) {
  return tfmpc::small_groups(n, m);
}
"""


def test_small_smem_bytes_match_the_c_side(tmp_path):
    """The C side's shared bytes (what ``tfmpc_riccati_small_smem_bytes``
    returns and the launch requires) and lanes a scenario, from the
    header's own functions compiled for the host, equal the Python plan's
    at every (n, m) of ``SMALL_DIMS``, both dtypes and variants, at 1, 3,
    8 and 16 scenarios a block."""
    import ctypes

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the header's host functions cannot be "
                    "compiled here")
    for name in ("common.cuh", "warp.cuh"):
        (tmp_path / name).write_text((CSRC / name).read_text())
    # the launch's <<<...>>> is not C++: dropped (nothing here launches)
    (tmp_path / "riccati_small.cuh").write_text(re.sub(
        r"<<<.*?>>>", "", (CSRC / "riccati_small.cuh").read_text(),
        flags=re.S))
    (tmp_path / "cuda_runtime.h").write_text(_HOST_STANDIN)
    (tmp_path / "entry.cpp").write_text(_HOST_ENTRY)
    so = tmp_path / "libsmallbytes.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    str(tmp_path), "-o", str(so), str(tmp_path / "entry.cpp")],
                   check=True, capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.small_smem_bytes.restype = ctypes.c_longlong
    for n, m in SMALL_DIMS:
        assert lib.small_groups(n, m) == riccati_small.small_groups(n, m)
        for code, dtype in ((0, torch.float32), (1, torch.float64)):
            for ddp in (0, 1):
                for spb in (1, 3, 8, 16):
                    assert lib.small_smem_bytes(code, ddp, n, m, spb) == \
                        riccati_small.small_smem_bytes(n, m, dtype,
                                                       bool(ddp), spb)
    assert lib.small_groups(13, 2) == 0
    assert lib.small_smem_bytes(0, 0, 13, 2, 1) == -1


# -- the wrappers on CPU tensors ----------------------------------------------

def _inputs(n, m, B, T, seed, scale=0.05):
    """A synthetic linearization at (n, m) (``test_riccati_mid._synthetic``,
    float64), seeded Hessians symmetric in their derivative indices, per
    lane mu (half 0), the box +-0.4 and a nominal ~ 0.2 N(0, 1); lanes 0
    and B // 2 forced indefinite (l_uu = -10 I, mu = 0). Returns the JAX
    and the port's records: (lin, quad, final, mu, bounds, Ubar, second)
    each."""
    rng = np.random.default_rng(seed)
    lin, quad, final, mu = _synthetic(rng, B, T, n, m)
    bad = np.array([0, B // 2])
    l_uu = np.asarray(quad.l_uu).copy()
    l_uu[bad] = -10.0 * np.eye(m)
    quad = dataclasses.replace(quad, l_uu=jnp.asarray(l_uu))
    mu = mu.at[bad].set(0.0)
    sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))  # noqa: E731
    h = dict(f_xx=sym(scale * rng.standard_normal((B, T, n, n, n))),
             f_ux=scale * rng.standard_normal((B, T, n, m, n)),
             f_uu=sym(scale * rng.standard_normal((B, T, n, m, m))))
    lo, hi = np.full(m, -0.4), np.full(m, 0.4)
    Ubar = 0.2 * rng.standard_normal((B, T, m))
    jax_side = (lin, quad, final, mu,
                JBounds(low=jnp.asarray(lo), high=jnp.asarray(hi)),
                jnp.asarray(Ubar),
                JSecondOrderModel(**{k: jnp.asarray(v) for k, v in h.items()}))
    conv = lambda cls, r: cls(**{  # noqa: E731
        f.name: torch.as_tensor(np.array(getattr(r, f.name)))
        for f in dataclasses.fields(r)})
    torch_side = (conv(LinearModel, lin), conv(QuadraticModel, quad),
                  conv(QuadraticFinal, final),
                  torch.as_tensor(np.asarray(mu)),
                  Bounds(low=torch.as_tensor(lo), high=torch.as_tensor(hi)),
                  torch.as_tensor(Ubar),
                  SecondOrderModel(**{k: torch.as_tensor(v)
                                      for k, v in h.items()}))
    return jax_side, torch_side


def _counts():
    return (riccati_small.SMALL_BOXQP_PLAIN_CALLS,
            riccati_small.SMALL_DDP_BOXQP_PLAIN_CALLS,
            riccati_small.SMALL_BOXQP_LAUNCHES,
            riccati_small.SMALL_DDP_BOXQP_LAUNCHES)


@pytest.mark.parametrize("ddp", [False, True], ids=["boxqp", "ddp_boxqp"])
@pytest.mark.parametrize("dims", [(4, 4), (12, 12), (7, 3), (2, 1)],
                         ids=str)
def test_small_wrappers_run_plain_versions_on_cpu(dims, ddp):
    """On CPU tensors each wrapper is its plain version bit for bit, with
    one plain call counted and no launch; the forced-indefinite lanes fail
    and most lanes pass; the raw launcher refuses CPU tensors."""
    n, m = dims
    _, (lin, quad, final, mu, bounds, U, second) = _inputs(n, m, 64, 4,
                                                           7 * n + m)
    before = _counts()
    if ddp:
        got = riccati_small.riccati_backward_small_ddp_boxqp(
            lin, quad, final, mu, bounds, U, second, 4)
        want = riccati.riccati_backward_ddp_boxqp_ref(
            lin, quad, final, mu, bounds, U, second, 4)
        keys = riccati_small.SMALL_DDP_BOXQP_ARGS
        launcher = riccati_small.riccati_backward_small_ddp_boxqp_kernel
    else:
        got = riccati_small.riccati_backward_small_boxqp(
            lin, quad, final, mu, bounds, U, 4)
        want = riccati.riccati_backward_boxqp_ref(lin, quad, final, mu,
                                                  bounds, U, 4)
        keys = riccati_small.SMALL_BOXQP_ARGS
        launcher = riccati_small.riccati_backward_small_boxqp_kernel
    assert [x - y for x, y in zip(_counts(), before)] == \
        ([0, 1, 0, 0] if ddp else [1, 0, 0, 0])
    ok = got[0]
    assert torch.equal(ok, want[0])
    assert not bool(ok[0]) and not bool(ok[32])
    assert float(ok.double().mean()) >= 0.5
    for x, y in ((got[1].K, want[1].K), (got[1].k, want[1].k),
                 (got[2], want[2]), (got[3], want[3])):
        assert torch.equal(x[ok], y[ok])
    a = riccati_mid.mid_layout(lin, quad, final, mu, bounds, U,
                               second if ddp else None)
    assert set(keys) == set(a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher(*(a[k] for k in keys))
    assert _counts()[2:] == before[2:]


# -- the plain versions against the JAX package -------------------------------

def _assert_same_backward(ours, theirs):
    """Identical ok masks; K, k, dV1, dV2 within 1e-9 on the ok lanes."""
    ok_t, pol_t, dv1_t, dv2_t = ours
    ok_j, pol_j, dv1_j, dv2_j = theirs
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok)
    assert 0.5 < ok.mean() < 1.0
    for got, want in ((pol_t.K, pol_j.K), (pol_t.k, pol_j.k),
                      (dv1_t, dv1_j), (dv2_t, dv2_j)):
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok],
                                   **TOL)


@pytest.mark.parametrize("ddp", [False, True], ids=["boxqp", "ddp_boxqp"])
def test_plain_versions_match_jax_lane_kernel_at_4x4(ddp):
    """(n, m) = (4, 4), B=128, T=2: the wrapper on CPU tensors (the plain
    version) against the JAX lane kernel in interpret mode, K6b with 2
    Newton iterations, K4 with 1."""
    (jlin, jquad, jfin, jmu, jb, jU, jsec), (lin, quad, fin, mu, b, U, sec) \
        = _inputs(4, 4, 128, 2, 44)
    if ddp:
        theirs = riccati_backward_ddp_boxqp_pallas(
            jlin, jquad, jfin, jmu, jb, jU, jsec, boxqp_iters=2)
        ours = riccati_small.riccati_backward_small_ddp_boxqp(
            lin, quad, fin, mu, b, U, sec, 2)
    else:
        theirs = riccati_backward_boxqp_pallas(jlin, jquad, jfin, jmu, jb,
                                               jU, boxqp_iters=1)
        ours = riccati_small.riccati_backward_small_boxqp(lin, quad, fin, mu,
                                                          b, U, 1)
    _assert_same_backward(ours, theirs)


@pytest.mark.parametrize("ddp", [False, True], ids=["boxqp", "ddp_boxqp"])
@pytest.mark.parametrize("dims", [(12, 12), (12, 1)], ids=str)
def test_plain_versions_match_jax_scan(dims, ddp):
    """(12, 12) and (12, 1), B=16, T=3, 4 Newton iterations: the wrapper on
    CPU tensors against the JAX package's scan backward (``ilqr.backward``
    vmapped over the batch, with ``second`` for full DDP)."""
    n, m = dims
    (jlin, jquad, jfin, jmu, jb, jU, jsec), (lin, quad, fin, mu, b, U, sec) \
        = _inputs(n, m, 16, 3, 12 * n + m, scale=0.03)
    cfg = jilqr.ILQRConfig(boxqp=True, boxqp_iters=4)
    theirs = jax.vmap(
        lambda l, q, f, mv, u, s: jilqr.backward(
            l, q, f, mv, cfg, bounds=jb, Ubar=u, second=s if ddp else None)
    )(jlin, jquad, jfin, jmu, jU, jsec)
    ours = (riccati_small.riccati_backward_small_ddp_boxqp(
        lin, quad, fin, mu, b, U, sec, 4) if ddp else
        riccati_small.riccati_backward_small_boxqp(lin, quad, fin, mu, b, U,
                                                   4))
    _assert_same_backward(ours, theirs)


def _reservoir4():
    cfg = json.loads((ROOT / "configs" / "reservoir.json").read_text())
    cfg.update(n_reservoirs=4)
    cfg.pop("x0")
    return cfg


def test_reservoir4_ddp_boxqp_solve_matches_jax():
    """Reservoir-4 with full DDP and boxQP, B=130 (> 128: the restarts run
    compacted), T=8, float64, ``use_pallas=True``: every backward goes
    through the small-dims K6b wrapper (its plain version here), none
    through K7's or the lane kernels', and the solve matches the JAX
    package's (its scan route): identical converged, failed and iteration
    counts, actions within 1e-6, costs within 1e-9."""
    cfg = _reservoir4()
    kw = dict(atol=1e-3, max_iterations=30, boxqp=True, ddp=True)
    B, T = 130, 8
    x0 = np.random.default_rng(0).uniform(20.0, 95.0, (B, 4))
    res_j = jilqr.solve_batch(jax_make_env(cfg, dtype=jnp.float64),
                              jnp.asarray(x0), horizon=T,
                              config=jilqr.ILQRConfig(**kw))
    others = (riccati.DDP_BOXQP_PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS,
              riccati_mid.MID_DDP_PLAIN_CALLS,
              riccati_mid.MID_BOXQP_PLAIN_CALLS)
    before = _counts()
    res_t = ilqr.solve_batch(make_env(cfg, dtype=torch.float64,
                                      device="cpu"),
                             torch.as_tensor(x0), horizon=T,
                             config=ilqr.ILQRConfig(**kw, use_pallas=True))
    calls = [x - y for x, y in zip(_counts(), before)]
    assert calls[1] > 0 and calls[0] == 0 and calls[2:] == [0, 0]
    assert (riccati.DDP_BOXQP_PLAIN_CALLS, riccati.BOXQP_PLAIN_CALLS,
            riccati_mid.MID_DDP_PLAIN_CALLS,
            riccati_mid.MID_BOXQP_PLAIN_CALLS) == others
    for f in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, f).numpy(),
                                      np.asarray(getattr(res_j, f)),
                                      err_msg=f)
    assert float(res_t.converged.double().mean()) > 0.9
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-6)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


# -- the routing table --------------------------------------------------------

def test_backward_table_routes_boxqp_at_small_dims():
    """``_BACKWARD``: the small-dims wrappers for boxQP with and without
    full DDP in their family, and for its batches without a box its own
    K1 and K6a wrappers (K7's iLQR and DDP wrappers until the kernel had
    those variants), and the lane and K7 families' wrappers as before."""
    table = ilqr_batched._BACKWARD
    assert table["small", False, True] is \
        riccati_small.riccati_backward_small_boxqp
    assert table["small", True, True] is \
        riccati_small.riccati_backward_small_ddp_boxqp
    assert table["small", False, False] is \
        riccati_small.riccati_backward_small
    assert table["small", True, False] is \
        riccati_small.riccati_backward_small_ddp
    lane = (riccati.riccati_backward, riccati.riccati_backward_boxqp,
            riccati.riccati_backward_ddp, riccati.riccati_backward_ddp_boxqp)
    mid = (riccati_mid.riccati_backward_mid,
           riccati_mid.riccati_backward_mid_boxqp,
           riccati_mid.riccati_backward_mid_ddp)
    keys = ((False, False), (False, True), (True, False), (True, True))
    for key, fn in zip(keys, lane):
        assert table[("lane",) + key] is fn
    for key, fn in zip(keys, mid):
        assert table[("mid",) + key] is fn
    assert ("mid", True, True) not in table


@pytest.mark.parametrize("dims", [(12, 12), (14, 13)], ids=str)
def test_fused_backward_routes_boxqp_to_the_small_kernel(dims, monkeypatch):
    """``riccati.riccati_backward_lanes`` with a box at dims without a lane
    instantiation (the fused iteration's route on the card, through the
    solver layout): the small-dims K4's launcher at n, m <= 12, K7's boxQP
    one above, each given the blocks in the solver layout and the policy
    handed back in the kernel layout."""
    n, m = dims
    B, T = 3, 2
    rng = np.random.default_rng(5)
    ka = {k: torch.as_tensor(rng.standard_normal((T, e, B)))
          for k, e in (("fx", n * n), ("fu", n * m), ("lx", n), ("lu", m),
                       ("lxx", n * n), ("luu", m * m), ("lux", m * n))}
    VT = torch.as_tensor(rng.standard_normal((n * n, B)))
    vT = torch.as_tensor(rng.standard_normal((n, B)))
    mu = torch.full((B,), 0.1, dtype=torch.float64)
    box = (torch.as_tensor(rng.standard_normal((T, m, B))),
           -torch.ones(m, dtype=torch.float64),
           torch.ones(m, dtype=torch.float64))
    calls = []

    def fake(name):
        def launch(*args, boxqp_iters):
            calls.append((name, args[0].shape, args[8].shape, boxqp_iters))
            z = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
            return z(B, T, m, n), z(B, T, m), z(B), z(B), z(B)
        return launch

    monkeypatch.setattr(riccati_small, "riccati_backward_small_boxqp_kernel",
                        fake("small"))
    monkeypatch.setattr(riccati_mid, "riccati_backward_mid_boxqp_kernel",
                        fake("mid"))
    ok, (K, k), dV1, dV2 = riccati._mid_lanes(ka, VT, vT, mu, box, 5)
    want = "small" if max(n, m) <= riccati_small.SMALL_DIM_MAX else "mid"
    assert calls == [(want, (B, T, n, n), (B, T, m), 5)]
    assert K.shape == (T, m * n, B) and k.shape == (T, m, B)
    assert bool(ok.all())
