#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. Phases, in order; any failure raises (non-zero exit):

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for float32 matmuls;
2. build: compile ``tfmpc_tpu_torch/ops/csrc/*.cu`` with nvcc (timed);
3. each kernel (K1 Riccati backward, K2 line-search costs, K3 accepted-alpha
   rollout) against its plain PyTorch version on the card, at the headline
   shapes (B=4096, T=100, n=m=2, A=11), in float32 and float64, including
   K1 lanes forced indefinite (fail masks must be identical), and timed;
4. the headline solve: ``solve_batch`` on 2-D navigation, T=100, B=4096,
   float32, ``ILQRConfig(atol=1e-4, max_iterations=50, use_pallas=True)``,
   with launch counters proving all three kernels ran and no plain version
   did; controls of 4 scenarios held against the float64 NumPy oracle
   (``tests/oracles.py``), max-abs < 1e-4;
5. solves/s with the kernels and with the plain PyTorch path
   (``use_pallas=False``), median of 5 windows after one warm-up.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

B, T, N, A = 4096, 100, 2, 11
GOAL = [8.0, -5.0]
ZONES = {"center": [[3.0, -2.0]], "decay": [2.0]}
HEADLINE = dict(atol=1e-4, max_iterations=50, use_pallas=True)
# Tolerances of kernel vs plain version, |err| <= atol + rtol * |plain|.
# float32: the two sum in different orders (the kernels unroll and fuse
# multiply-adds; the plain versions call batched matmul and LAPACK-style
# Cholesky), and a T=100 serial chain compounds the rounding.
# float64: the same chain at double precision.
TOL = {"float32": (1e-3, 1e-3), "float64": (1e-9, 1e-9)}
WINDOW_S = 1.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, timed with CUDA
    events after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, dtype_name, mask=None):
    """Max abs error of ``got`` vs ``want`` (on ``mask`` rows); raises past
    the stated tolerance."""
    import torch

    if mask is not None:
        got, want = got[mask], want[mask]
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(want).all()) or not bool(
            torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    atol, rtol = TOL[dtype_name]
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name} [{dtype_name}]: max_abs_err={max_err:.3e} "
          f"(tol {atol:g} + {rtol:g}*|plain|)")
    if bool(bad.any()):
        raise AssertionError(f"{name} [{dtype_name}]: {int(bad.sum())} "
                             "entries outside tolerance")
    return max_err


def headline_inputs(dtype, device):
    """The headline env, a random nominal (x0 ~ U(-10, 10), small random
    controls) with its linearization, per-lane mu, and a small random
    feedback policy (K ~ 0.05 N(0, 1), k ~ 0.1 N(0, 1)) whose closed-loop
    rollouts stay well-conditioned over T steps, made from a numpy seed."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Policy
    from tfmpc_tpu_torch.models.navigation import make_navigation

    env = make_navigation(GOAL, ZONES, dtype=dtype, device=device)
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    x0 = t(rng.uniform(-10.0, 10.0, (B, N)))
    U = t(0.1 * rng.standard_normal((B, T, N)))
    X, _ = env.rollout(x0, U)
    lin, quad, final = env.analytic_derivatives(X, U)
    mu = t(rng.uniform(0.0, 0.5, B))
    policy = Policy(K=t(0.05 * rng.standard_normal((B, T, N, N))),
                    k=t(0.1 * rng.standard_normal((B, T, N))))
    return env, X, U, lin, quad, final, mu, policy


def check_kernels(dtype, timings):
    """Phase 3 for one dtype: every kernel against its plain version."""
    import torch

    from tfmpc_tpu_torch.ops import riccati, rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    dname = str(dtype).split(".")[-1]
    env, X, U, lin, quad, final, mu, policy = headline_inputs(dtype, "cuda")
    errs = {}

    # K1, with a few lanes forced indefinite: l_uu = -100 I and mu = 0 make
    # the regularized Quu negative definite at t = T-1.
    bad = torch.tensor([0, 1, 777, 2048, B - 1], device="cuda")
    luu = quad.l_uu.clone()
    luu[bad] = -100.0 * torch.eye(N, dtype=dtype, device="cuda")
    quad_k1 = dataclasses.replace(quad, l_uu=luu)
    mu_k1 = mu.clone()
    mu_k1[bad] = 0.0
    ok_k, pol_k, dv1_k, dv2_k = riccati.riccati_backward(
        lin, quad_k1, final, mu_k1)
    ok_p, pol_p, dv1_p, dv2_p = riccati.riccati_backward_ref(
        lin, quad_k1, final, mu_k1)
    torch.cuda.synchronize()
    if not torch.equal(ok_k, ok_p):
        raise AssertionError("K1: fail masks differ from the plain version")
    if bool(ok_k[bad].any()) or int(ok_k.sum()) != B - bad.numel():
        raise AssertionError("K1: forced-indefinite lanes not flagged, or "
                             "other lanes failed")
    print(f"  K1 fail masks identical: {int((~ok_k).sum())} failing lanes")
    errs["riccati_backward"] = max(
        compare("K1 K", pol_k.K, pol_p.K, dname, ok_k),
        compare("K1 k", pol_k.k, pol_p.k, dname, ok_k),
    )
    compare("K1 dV1", dv1_k, dv1_p, dname, ok_k)
    compare("K1 dV2", dv2_k, dv2_p, dname, ok_k)

    # K2 / K3
    alphas = ILQRConfig().alphas_static()
    J_k = rollout.linesearch_costs(env, X, U, policy, alphas)
    J_p = rollout.linesearch_costs_ref(env, X, U, policy, alphas)
    torch.cuda.synchronize()
    errs["linesearch_costs"] = compare("K2 J", J_k, J_p, dname)

    alpha_vec = torch.as_tensor(alphas, dtype=dtype, device="cuda")[
        torch.arange(B, device="cuda") % A]
    X_k, U_k, Jm_k = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    X_p, U_p, Jm_p = rollout.rollout_alpha_ref(env, X, U, policy, alpha_vec)
    torch.cuda.synchronize()
    errs["rollout_alpha"] = max(
        compare("K3 X", X_k, X_p, dname),
        compare("K3 U", U_k, U_p, dname),
    )
    compare("K3 J", Jm_k, Jm_p, dname)

    if dtype == torch.float32:
        a = riccati._to_kernel_layout(lin, quad, final, mu)
        k1_args = [a[k] for k in ("fx", "fu", "lx", "lu", "lxx", "luu",
                                  "lux", "mu", "VT", "vT")]
        timings["riccati_backward"] = (
            cuda_ms(lambda: riccati.riccati_backward_kernel(*k1_args), 50),
            cuda_ms(lambda: riccati.riccati_backward(lin, quad, final, mu),
                    50),
            cuda_ms(lambda: riccati.riccati_backward_ref(lin, quad, final,
                                                         mu), 5),
        )
        ra = rollout.kernel_args(env, X, U, policy)
        timings["linesearch_costs"] = (
            cuda_ms(lambda: rollout.linesearch_costs_kernel(ra, alphas), 50),
            cuda_ms(lambda: rollout.linesearch_costs(env, X, U, policy,
                                                     alphas), 50),
            cuda_ms(lambda: rollout.linesearch_costs_ref(env, X, U, policy,
                                                         alphas), 5),
        )
        timings["rollout_alpha"] = (
            cuda_ms(lambda: rollout.rollout_alpha_kernel(ra, alpha_vec), 50),
            cuda_ms(lambda: rollout.rollout_alpha(env, X, U, policy,
                                                  alpha_vec), 50),
            cuda_ms(lambda: rollout.rollout_alpha_ref(env, X, U, policy,
                                                      alpha_vec), 5),
        )
    return errs


def headline_solve(config):
    import numpy as np
    import torch

    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.solvers import ilqr

    env = make_navigation(GOAL, ZONES, dtype=torch.float32, device="cuda")
    x0_np = np.random.default_rng(0).uniform(-10.0, 10.0, (B, N)).astype(
        "float32")
    x0 = torch.as_tensor(x0_np, device="cuda")

    def run():
        res = ilqr.solve_batch(env, x0, horizon=T, config=config)
        torch.cuda.synchronize()
        return res

    return x0_np, run


def solves_per_s(run) -> list:
    """Five timing windows after one warm-up window; each window repeats
    whole solves for at least WINDOW_S seconds."""
    windows = []
    for _ in range(6):
        reps, t0 = 0, time.perf_counter()
        while reps == 0 or time.perf_counter() - t0 < WINDOW_S:
            run()
            reps += 1
        windows.append(B * reps / (time.perf_counter() - t0))
    return windows[1:]


def main() -> int:
    if not (ROOT / "tfmpc_tpu_torch").is_dir():
        raise SystemExit("chip_smoke.py: tfmpc_tpu_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))

    import numpy as np
    import torch

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # -- 2. build ----------------------------------------------------------
    from tfmpc_tpu_torch.ops import _build, riccati, rollout

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({_build.library_path().name})")
    log = _build.library_path().with_suffix(".log")
    for line in log.read_text().splitlines():
        if "entry function" in line or "registers" in line:
            print(f"  ptxas: {line.strip()}")

    # -- 3. kernels vs plain versions ---------------------------------------
    timings = {}
    errs = {}
    for dtype in (torch.float32, torch.float64):
        print(f"kernels vs plain versions, {dtype}, B={B} T={T} A={A}:")
        e = check_kernels(dtype, timings)
        if dtype == torch.float32:
            errs = e

    # -- 4. the headline solve through the kernels ---------------------------
    from oracles import ilqr_navigation_oracle_np
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    config = ILQRConfig(**HEADLINE)
    x0_np, run = headline_solve(config)
    run()  # first solve: one-time costs (cuSOLVER/cuBLAS handles etc.)
    riccati.LAUNCHES = riccati.PLAIN_CALLS = 0
    rollout.COSTS_LAUNCHES = rollout.COSTS_PLAIN_CALLS = 0
    rollout.ALPHA_LAUNCHES = rollout.ALPHA_PLAIN_CALLS = 0
    res = run()
    launches = {
        "riccati_backward": riccati.LAUNCHES,
        "linesearch_costs": rollout.COSTS_LAUNCHES,
        "rollout_alpha": rollout.ALPHA_LAUNCHES,
    }
    plain = (riccati.PLAIN_CALLS, rollout.COSTS_PLAIN_CALLS,
             rollout.ALPHA_PLAIN_CALLS)
    print(f"headline solve: launches {launches}, plain-version calls {plain}")
    if min(launches.values()) == 0 or any(plain):
        raise AssertionError("the headline solve did not run every kernel, "
                             "or ran a plain version")
    if res.actions.shape != (B, T, N) or res.states.shape != (B, T + 1, N):
        raise AssertionError("headline solve: wrong output shapes")
    if not bool(torch.isfinite(res.actions).all()) or not bool(
            torch.isfinite(res.total_cost[~res.failed]).all()):
        raise AssertionError("headline solve: non-finite output")
    conv = float(res.converged.float().mean())
    fail = float(res.failed.float().mean())
    iters = float(res.iterations.float().mean())
    print(f"  converged {conv:.4f}, failed {fail:.4f}, mean iterations "
          f"{iters:.3f}, max iterations {int(res.iterations.max())}")
    if conv < 0.99:
        raise AssertionError(f"headline solve converged only {conv:.4f}")
    dev = 0.0
    for i in range(4):
        _, U_np, _ = ilqr_navigation_oracle_np(
            GOAL, ZONES["center"], ZONES["decay"], x0_np[i].astype(float), T,
            atol=1e-10,
        )
        dev = max(dev, float(np.abs(res.actions[i].cpu().numpy() - U_np).max()))
    print(f"  controls vs fp64 NumPy oracle (4 scenarios): max-abs {dev:.3e} "
          "(target < 1e-4)")
    if dev >= 1e-4:
        raise AssertionError("controls deviate from the fp64 oracle")

    plain_config = dataclasses.replace(config, use_pallas=False)
    _, run_plain = headline_solve(plain_config)
    res_plain = run_plain()
    d_plain = float((res_plain.actions - res.actions).abs().max())
    same = bool(torch.equal(res_plain.converged, res.converged))
    print(f"  plain path (use_pallas=False): controls max-abs diff "
          f"{d_plain:.3e} vs kernels, same converged mask: {same}")

    # -- 5. timing -----------------------------------------------------------
    w_k = solves_per_s(run)
    w_p = solves_per_s(run_plain)
    for label, w in (("kernels (use_pallas=True)", w_k),
                     ("plain PyTorch (use_pallas=False)", w_p)):
        print(f"solves/s, {label}, navigation T={T} B={B} f32: median "
              f"{sorted(w)[2]:.1f}, windows {[round(x, 1) for x in w]} "
              f"[{card}]")
    for name, (k_ms, w_ms, p_ms) in timings.items():
        print(f"{name} at headline shapes f32: kernel {k_ms:.4f} ms, "
              f"wrapper with layout copies {w_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms [{card}]")

    sources = {
        "riccati_backward": ("tfmpc_tpu_torch/ops/csrc/riccati.cu",
                             "tfmpc_tpu/ops/riccati_pallas.py:462"),
        "linesearch_costs": ("tfmpc_tpu_torch/ops/csrc/rollout.cu",
                             "tfmpc_tpu/ops/rollout_pallas.py:647"),
        "rollout_alpha": ("tfmpc_tpu_torch/ops/csrc/rollout.cu",
                          "tfmpc_tpu/ops/rollout_pallas.py:804"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        k_ms, w_ms, p_ms = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": k_ms, "wrapper_ms": w_ms,
            "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": kernels, "build_s": build_s,
                      "solves_per_s": sorted(w_k)[2],
                      "plain_solves_per_s": sorted(w_p)[2], "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
