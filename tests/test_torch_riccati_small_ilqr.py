"""K1 and K6a at small dims (``ops/riccati_small.py``) against the JAX
package, float64 on the CPU.

At every n, m <= 12 outside ``riccati.KERNEL_DIMS`` the port routes the
unconstrained backward, with or without the full-DDP terms, to the
small-dims kernel's variants without a box (``csrc/riccati_small.cuh``,
``riccati_small_ilqr.cu`` and ``riccati_small_ddp_ilqr.cu``), whose plain
versions are K1's and K6a's (``riccati.riccati_backward_ref``,
``riccati_backward_ddp_ref``). No CUDA tensor exists on the CPU, so here
the wrappers run their plain versions (counted), and the launch plan is
checked as arithmetic:

- the plan of both variants at every such (n, m), both dtypes, fits a
  block's threads and shared memory, and gives each scenario of ragged
  batches one group of lanes (``small_cover``); without the box it is no
  larger than the boxQP variant's (no candidates, no ubar staged);
- the shared bytes the C side requires (``small_smem_bytes`` of the
  header, compiled for the host with g++; only this case skips, and only
  where g++ is absent) equal the plan's;
- with full DDP the plan reads the Hessians in place where staging them
  would take more waves of blocks (D5's shape), and stages them at the
  other paths' shapes;
- the wrappers on CPU tensors are their plain versions bit for bit, one
  plain call each and no launch; the raw launchers refuse CPU tensors;
- the plain versions against the JAX lane kernel in interpret mode at (4,
  4) (B=128, T=2), and against the JAX scan (``ilqr.backward`` vmapped;
  the JAX package's CPU lane limit is 8) at (12, 12), (12, 1) and (2, 1):
  identical ok masks, K, k, dV1, dV2 within 1e-9 on the ok lanes;
- ``solve_batch`` of the double integrator with full DDP and of
  navigation-4, split and fused, against the JAX package's solve (its
  scan route, ``use_pallas=False``): the split solves' backward through
  the small-dims K6a and K1 wrappers, none through K7's;
- the fused iteration's ``riccati_backward_lanes`` without a box launches
  the small-dims K1 at n, m <= 12 and K7's iLQR variant above (the
  launchers stubbed).
"""

import ctypes
import dataclasses
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_riccati_mid import _synthetic
from test_torch_riccati_small import (
    _HOST_STANDIN,
    CSRC,
    DTYPES,
    SMALL_DIMS,
    TOL,
)
from tfmpc_tpu.core.types import SecondOrderModel as JSecondOrderModel
from tfmpc_tpu.models.linear import make_linear_system as jax_make_linear
from tfmpc_tpu.models.navigation import make_navigation as jax_make_navigation
from tfmpc_tpu.ops.riccati_pallas import (
    riccati_backward_ddp_pallas,
    riccati_backward_pallas,
)
from tfmpc_tpu.solvers import ilqr as jilqr
from tfmpc_tpu_torch.core.types import (
    LinearModel,
    QuadraticFinal,
    QuadraticModel,
    SecondOrderModel,
)
from tfmpc_tpu_torch.models.linear import make_linear_system
from tfmpc_tpu_torch.models.navigation import make_navigation
from tfmpc_tpu_torch.ops import riccati, riccati_mid, riccati_small
from tfmpc_tpu_torch.solvers import ilqr, ilqr_batched

DDP_IDS = ["ilqr", "ddp"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the launch plan ----------------------------------------------------------

@pytest.mark.parametrize("ddp", [False, True], ids=DDP_IDS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_unconstrained_plan_fits_every_dim(dtype, ddp):
    """At every (n, m) of ``SMALL_DIMS`` and batches of 1, 128, 401, 1023
    and 4096 the unconstrained plan has the boxQP plan's lanes, a block of
    at most SMALL_MAX_THREADS threads and SMEM_LIMIT shared bytes, its
    bytes ``small_smem_bytes(box=False)``' and no more than the boxQP
    variant's for the same scenarios, and gives each scenario one
    group."""
    dtype = DTYPES[dtype]
    for n, m in SMALL_DIMS:
        for Bb in (1, 128, 401, 1023, 4096):
            plan = riccati_small.small_plan(n, m, Bb, dtype, ddp, box=False)
            assert plan.groups == riccati_small.small_groups(n, m)
            assert plan.threads <= riccati_small.SMALL_MAX_THREADS
            assert plan.threads % 32 == 0
            assert plan.smem_bytes == riccati_small.small_smem_bytes(
                n, m, dtype, ddp, plan.scenarios, box=False,
                stage_h=plan.stage_h)
            assert plan.smem_bytes < riccati_small.small_smem_bytes(
                n, m, dtype, ddp, plan.scenarios, stage_h=plan.stage_h)
            assert plan.smem_bytes <= riccati_mid.SMEM_LIMIT
            cover = riccati_small.small_cover(plan, Bb)
            assert cover.shape == (Bb,) and (cover == 1).all(), (n, m, Bb)


_HOST_ENTRY = """
#include "riccati_small.cuh"
extern "C" long long small_smem_bytes(int dtype, int box, int ddp, int n,
                                      int m, int spb, int stage_h) {
  return tfmpc::small_smem_bytes(n, m, dtype == tfmpc::kFloat64 ? 8 : 4,
                                 ddp != 0, spb, box != 0, stage_h != 0);
}
"""


def test_unconstrained_smem_bytes_match_the_c_side(tmp_path):
    """The C side's shared bytes of every variant (what
    ``tfmpc_riccati_small_smem_bytes`` returns and the launch requires,
    with and without the box), from the header's own function compiled for
    the host, equal the Python plan's at every (n, m) of ``SMALL_DIMS``,
    both dtypes, with and without DDP, the Hessians staged or read in
    place, at 1, 3, 8 and 16 scenarios a block."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is absent: the header's host functions cannot be "
                    "compiled here")
    for name in ("common.cuh", "warp.cuh"):
        (tmp_path / name).write_text((CSRC / name).read_text())
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
        for code, dtype in ((0, torch.float32), (1, torch.float64)):
            for box, ddp, stage_h in np.ndindex(2, 2, 2):
                for spb in (1, 3, 8, 16):
                    assert lib.small_smem_bytes(code, box, ddp, n, m, spb,
                                                stage_h) == \
                        riccati_small.small_smem_bytes(
                            n, m, dtype, bool(ddp), spb, box=bool(box),
                            stage_h=bool(stage_h))
    assert lib.small_smem_bytes(0, 0, 0, 13, 2, 1, 1) == -1


@pytest.mark.parametrize("box", [False, True], ids=["ddp", "ddp_boxqp"])
def test_plan_reads_the_hessians_in_place_where_staging_costs_a_wave(
        box, monkeypatch):
    """With full DDP and no box (K6a) the launch plan
    (``small_launch_plan``) stages the Hessians unless reading them in
    place takes fewer waves of blocks (``small_waves``) at the blocks an SM
    holds, which on the card the CUDA runtime gives for the kernel
    (``small_blocks_per_sm``; here a stand-in that counts an H100 SM's
    shared memory, 228 KiB less 1 KiB a block, and its 2048 threads). At
    D5's shape (12, 12), B=1024 on 132 SMs, both dtypes, a block with them
    staged holds fewer scenarios and the batch takes two waves in float32
    (four in float64), in place one; at the double integrator's (2, 1,
    B=4096) both take one and they stay staged. K6b (``box``) always
    stages them, and without full DDP nothing is chosen: neither asks the
    occupancy."""
    rs = riccati_small
    asked = []

    def per_sm(plan, n, m, dtype):
        asked.append((n, m, dtype))
        return min(233472 // (plan.smem_bytes + 1024), 2048 // plan.threads)

    monkeypatch.setattr(rs, "small_blocks_per_sm", per_sm)
    rs.small_launch_plan.cache_clear()
    try:
        for dtype in (torch.float32, torch.float64):
            staged = rs.small_plan(12, 12, 1024, dtype, True, sms=132,
                                   box=box)
            plan = rs.small_launch_plan(12, 12, 1024, dtype, True, box, 132)
            assert staged.stage_h
            if box:
                assert plan == staged and not asked
            else:
                assert not plan.stage_h
                assert plan.smem_bytes < staged.smem_bytes
                assert rs.small_waves(plan, 1024, per_sm(
                    plan, 12, 12, dtype), 132) == 1
                assert rs.small_waves(staged, 1024, per_sm(
                    staged, 12, 12, dtype), 132) == (
                    2 if dtype == torch.float32 else 4)
            assert rs.small_launch_plan(2, 1, 4096, dtype, True, box,
                                        132).stage_h
            asked.clear()
            assert rs.small_launch_plan(12, 12, 1024, dtype, False, box,
                                        132) == rs.small_plan(
                12, 12, 1024, dtype, False, sms=132, box=box)
            assert not asked
    finally:
        rs.small_launch_plan.cache_clear()


# -- the wrappers on CPU tensors ----------------------------------------------

def _inputs(n, m, B, T, seed, scale=0.05):
    """A synthetic linearization at (n, m) (``test_riccati_mid._synthetic``,
    float64) and seeded Hessians symmetric in their derivative indices,
    per lane mu (half 0); lanes 0 and B // 2 forced indefinite (l_uu = -10
    I, mu = 0). Returns the JAX and the port's records: (lin, quad, final,
    mu, second) each."""
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
    jax_side = (lin, quad, final, mu,
                JSecondOrderModel(**{k: jnp.asarray(v) for k, v in h.items()}))
    conv = lambda cls, r: cls(**{  # noqa: E731
        f.name: torch.as_tensor(np.array(getattr(r, f.name)))
        for f in dataclasses.fields(r)})
    torch_side = (conv(LinearModel, lin), conv(QuadraticModel, quad),
                  conv(QuadraticFinal, final),
                  torch.as_tensor(np.array(mu)),
                  SecondOrderModel(**{k: torch.as_tensor(v)
                                      for k, v in h.items()}))
    return jax_side, torch_side


def _counts():
    return (riccati_small.SMALL_PLAIN_CALLS,
            riccati_small.SMALL_DDP_PLAIN_CALLS,
            riccati_small.SMALL_LAUNCHES,
            riccati_small.SMALL_DDP_LAUNCHES)


@pytest.mark.parametrize("ddp", [False, True], ids=DDP_IDS)
@pytest.mark.parametrize("dims", [(4, 4), (12, 12), (7, 3), (2, 1)],
                         ids=str)
def test_unconstrained_wrappers_run_plain_versions_on_cpu(dims, ddp):
    """On CPU tensors each wrapper is its plain version bit for bit, with
    one plain call counted and no launch; the forced-indefinite lanes fail
    and most lanes pass; the raw launcher refuses CPU tensors."""
    n, m = dims
    # at (12, 12) the Hessians' contraction leaves fewer lanes PD: a
    # smaller scale keeps most of them ok (as tests/test_torch_ddp_mid.py)
    _, (lin, quad, final, mu, second) = _inputs(
        n, m, 64, 4, 7 * n + m, scale=0.03 if n == 12 else 0.05)
    before = _counts()
    if ddp:
        got = riccati_small.riccati_backward_small_ddp(lin, quad, final, mu,
                                                       second)
        want = riccati.riccati_backward_ddp_ref(lin, quad, final, mu, second)
        keys = riccati_small.SMALL_DDP_ARGS
        launcher = riccati_small.riccati_backward_small_ddp_kernel
    else:
        got = riccati_small.riccati_backward_small(lin, quad, final, mu)
        want = riccati.riccati_backward_ref(lin, quad, final, mu)
        keys = riccati_small.SMALL_ARGS
        launcher = riccati_small.riccati_backward_small_kernel
    assert [x - y for x, y in zip(_counts(), before)] == \
        ([0, 1, 0, 0] if ddp else [1, 0, 0, 0])
    ok = got[0]
    assert torch.equal(ok, want[0])
    assert not bool(ok[0]) and not bool(ok[32])
    assert float(ok.double().mean()) >= 0.5
    for x, y in ((got[1].K, want[1].K), (got[1].k, want[1].k),
                 (got[2], want[2]), (got[3], want[3])):
        assert torch.equal(x[ok], y[ok])
    a = riccati_mid.mid_layout(lin, quad, final, mu,
                               second=second if ddp else None)
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


@pytest.mark.parametrize("ddp", [False, True], ids=DDP_IDS)
def test_plain_versions_match_jax_lane_kernel_at_4x4(ddp):
    """(n, m) = (4, 4), B=128, T=2: the wrapper on CPU tensors (the plain
    version) against the JAX lane kernel in interpret mode."""
    (jlin, jquad, jfin, jmu, jsec), (lin, quad, fin, mu, sec) = _inputs(
        4, 4, 128, 2, 45)
    if ddp:
        theirs = riccati_backward_ddp_pallas(jlin, jquad, jfin, jmu, jsec)
        ours = riccati_small.riccati_backward_small_ddp(lin, quad, fin, mu,
                                                        sec)
    else:
        theirs = riccati_backward_pallas(jlin, jquad, jfin, jmu)
        ours = riccati_small.riccati_backward_small(lin, quad, fin, mu)
    _assert_same_backward(ours, theirs)


@pytest.mark.parametrize("ddp", [False, True], ids=DDP_IDS)
@pytest.mark.parametrize("dims", [(12, 12), (12, 1), (2, 1)], ids=str)
def test_plain_versions_match_jax_scan(dims, ddp):
    """(12, 12), (12, 1) and (2, 1), B=16, T=3: the wrapper on CPU tensors
    against the JAX package's scan backward (``ilqr.backward`` vmapped
    over the batch, with ``second`` for full DDP)."""
    n, m = dims
    (jlin, jquad, jfin, jmu, jsec), (lin, quad, fin, mu, sec) = _inputs(
        n, m, 16, 3, 12 * n + m, scale=0.03)
    cfg = jilqr.ILQRConfig()
    theirs = jax.vmap(
        lambda l, q, f, mv, s: jilqr.backward(
            l, q, f, mv, cfg, second=s if ddp else None)
    )(jlin, jquad, jfin, jmu, jsec)
    ours = (riccati_small.riccati_backward_small_ddp(lin, quad, fin, mu, sec)
            if ddp else
            riccati_small.riccati_backward_small(lin, quad, fin, mu))
    _assert_same_backward(ours, theirs)


# -- solves --------------------------------------------------------------------

DOUBLE_INTEGRATOR = dict(A=[[1.0, 0.1], [0.0, 1.0]], B=[[0.005], [0.1]],
                         Q=[[1.0, 0.0], [0.0, 0.1]], R=[[0.01]])
GOAL4 = [8.0, -5.0, 4.0, -2.0]
ZONES4 = {"center": [[3.0, -2.0, 1.0, 0.0]], "decay": [2.0]}


def _k7_plain_calls():
    return (riccati_mid.MID_PLAIN_CALLS, riccati_mid.MID_DDP_PLAIN_CALLS)


@pytest.mark.parametrize("case", ["double_integrator_ddp", "nav4",
                                  "nav4_fused"])
def test_solve_batch_matches_jax(case):
    """``solve_batch(use_pallas=True)`` in float64 against the JAX
    package's solve with the same config on its scan route
    (``use_pallas=False``; its interpret-mode kernels at B padded to 128
    take minutes on the CPU): the double integrator with full DDP (B=8,
    T=12) and navigation-4 (B=8, T=10), split and fused. The split solves'
    backward goes through the small-dims K6a or K1 wrapper, none through
    K7's (on the CPU the fused iteration's backward is
    ``riccati_backward_lanes``' plain version, counted as K1's). Identical
    converged and failed masks and iteration counts, actions within 1e-8,
    costs within 1e-9."""
    rng = np.random.default_rng(17)
    if case.startswith("double_integrator"):
        kw = dict(DOUBLE_INTEGRATOR)
        A, Bm = kw.pop("A"), kw.pop("B")
        jenv = jax_make_linear(A, Bm, **kw, dtype=jnp.float64)
        tenv = make_linear_system(A, Bm, **kw, dtype=torch.float64,
                                  device="cpu")
        x0 = rng.uniform(-3.0, 3.0, (8, 2))
        cfg, horizon = dict(atol=1e-10, max_iterations=20, ddp=True), 12
        counter = "SMALL_DDP_PLAIN_CALLS"
    else:
        jenv = jax_make_navigation(GOAL4, ZONES4, dtype=jnp.float64)
        tenv = make_navigation(GOAL4, ZONES4, dtype=torch.float64,
                               device="cpu")
        x0 = rng.uniform(-8.0, 8.0, (8, 4))
        cfg = dict(atol=1e-5, max_iterations=40,
                   fuse_derivatives=case.endswith("fused"))
        horizon = 10
        counter = "SMALL_PLAIN_CALLS"
    res_j = jilqr.solve_batch(jenv, jnp.asarray(x0), horizon=horizon,
                              config=jilqr.ILQRConfig(**cfg))
    config = ilqr.ILQRConfig(**cfg, use_pallas=True)
    fused = ilqr_batched._use_fused_derivs(tenv, config, "cuda")
    assert fused == case.endswith("fused")
    before = (getattr(riccati_small, counter), riccati.PLAIN_CALLS,
              _k7_plain_calls())
    res_t = ilqr.solve_batch(tenv, torch.as_tensor(x0), horizon=horizon,
                             config=config)
    if fused:
        assert riccati.PLAIN_CALLS > before[1]
    else:
        assert getattr(riccati_small, counter) > before[0]
        assert riccati.PLAIN_CALLS == before[1]
    assert _k7_plain_calls() == before[2]
    assert bool(res_t.converged.all())
    for name in ("converged", "failed", "iterations"):
        np.testing.assert_array_equal(getattr(res_t, name).numpy(),
                                      np.asarray(getattr(res_j, name)),
                                      err_msg=name)
    np.testing.assert_allclose(res_t.actions.numpy(),
                               np.asarray(res_j.actions), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res_t.total_cost.numpy(),
                               np.asarray(res_j.total_cost), rtol=1e-9)


# -- routing --------------------------------------------------------------------

def test_kernel_mode_routes_every_small_dim_to_the_small_kernel():
    """Every n, m <= 12 outside the lane dims routes to the small-dims
    family with and without boxQP and full DDP, and the table gives its
    own wrapper for each of the four keys; above 12 K7 (iLQR, boxQP) or
    the plain backward (full DDP)."""
    mode = ilqr_batched._riccati_kernel_mode
    table = ilqr_batched._BACKWARD
    base = ilqr.ILQRConfig(use_pallas=True)
    configs = [dataclasses.replace(base, boxqp=box, ddp=ddp)
               for box in (False, True) for ddp in (False, True)]
    for n, m in SMALL_DIMS:
        for cfg in configs:
            assert mode(n, m, cfg, "cuda") == "small", (n, m, cfg)
    wrappers = {(False, False): riccati_small.riccati_backward_small,
                (True, False): riccati_small.riccati_backward_small_ddp,
                (False, True): riccati_small.riccati_backward_small_boxqp,
                (True, True): riccati_small.riccati_backward_small_ddp_boxqp}
    for key, fn in wrappers.items():
        assert table[("small",) + key] is fn
    for dims in ((13, 12), (16, 16), (1, 13)):
        assert mode(*dims, configs[0], "cuda") == "mid"
        assert mode(*dims, configs[2], "cuda") == "mid"
        assert mode(*dims, configs[1], "cuda") is None


@pytest.mark.parametrize("dims", [(4, 4), (14, 13)], ids=str)
def test_fused_backward_routes_unconstrained_to_the_small_kernel(
        dims, monkeypatch):
    """``riccati.riccati_backward_lanes`` without a box at dims without a
    lane instantiation (the fused iteration's route on the card, through
    the solver layout): the small-dims K1's launcher at n, m <= 12, K7's
    iLQR one above, each given the blocks in the solver layout and the
    policy handed back in the kernel layout."""
    n, m = dims
    B, T = 3, 2
    rng = np.random.default_rng(6)
    ka = {k: torch.as_tensor(rng.standard_normal((T, e, B)))
          for k, e in (("fx", n * n), ("fu", n * m), ("lx", n), ("lu", m),
                       ("lxx", n * n), ("luu", m * m), ("lux", m * n))}
    VT = torch.as_tensor(rng.standard_normal((n * n, B)))
    vT = torch.as_tensor(rng.standard_normal((n, B)))
    mu = torch.full((B,), 0.1, dtype=torch.float64)
    calls = []

    def fake(name):
        def launch(*args):
            calls.append((name, len(args), args[0].shape, args[8].shape))
            z = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
            return z(B, T, m, n), z(B, T, m), z(B), z(B), z(B)
        return launch

    monkeypatch.setattr(riccati_small, "riccati_backward_small_kernel",
                        fake("small"))
    monkeypatch.setattr(riccati_mid, "riccati_backward_mid_kernel",
                        fake("mid"))
    ok, (K, k), dV1, dV2 = riccati._mid_lanes(ka, VT, vT, mu, None, 8)
    want = "small" if max(n, m) <= riccati_small.SMALL_DIM_MAX else "mid"
    assert calls == [(want, 10, (B, T, n, n), (B, n, n))]
    assert K.shape == (T, m * n, B) and k.shape == (T, m, B)
    assert bool(ok.all())
