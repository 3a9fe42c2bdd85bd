#!/usr/bin/env python3
"""Time other versions of K7 or P1 beside the checkout's own, on one GPU.

    python3 tools/kernel_versions.py p1 LABEL=PATH [LABEL=PATH ...]
    python3 tools/kernel_versions.py k7 LABEL=PATH [LABEL=PATH ...]

Each PATH is another version of ``ops/csrc/row_matmul.cu`` (``p1``) or of
``ops/csrc/riccati_mid.cu`` (``k7``), for example an earlier one taken
with ``git show <rev>:tfmpc_tpu_torch/ops/csrc/row_matmul.cu``. Each is
built alone with the port's nvcc flags (``-I`` the checkout's ``csrc``
for its headers) into the git-ignored ``tfmpc_tpu_torch/ops/_build/
versions/``; its ptxas registers and spills are printed. Its C entry's
parameter list is read from the source, so versions whose entries differ
from the checkout's can be launched:

- P1 with ``block`` (threads a block: 256), with ``rows, cols`` (the
  register tile of ``riccati_mid.row_plan``) or with ``tile, threads``
  (each square tile side 4, 8, 12 with 128 and 256 threads that
  launches, each printed);
- K7 with or without an ``arith`` argument (0: double), with
  ``riccati_mid.mid_plan``'s plan and the version's own
  ``tfmpc_riccati_mid_smem_bytes``.

P1 runs at d = 16, 24, 32, 48, B = 1024, float32, each version held
against ``row_matmul_ref`` at 1e-5, then timed as the device time of a
CUDA graph replay of 100 calls (``chip_smoke.graph_ms``) and as an eager
loop of 50 (``chip_smoke.cuda_ms``), beside ``torch.bmm``; K7 runs at E1's
shape (HVAC-16, B=512, T=50, float32 inputs, ``chip_smoke.mid_case``),
both variants, against the checkout's kernel (identical ok masks; the
share of ok lanes within 1e-3 + 1e-3 |ref|; the largest K/k difference),
timed with CUDA events over 10 calls. Times are taken in turns (every
version, then again in reverse order) and the best of the two is
printed, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "tfmpc_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "tfmpc_tpu_torch" / "ops" / "_build" / "versions"
P1_DIMS, P1_B = (16, 24, 32, 48), 1024
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def entry_params(source: str, name: str) -> list[str]:
    """The parameter names of the C entry ``name`` in ``source``."""
    m = re.search(r'extern "C"[^(]*\b' + name + r"\(([^)]*)\)", source)
    if m is None:
        raise ValueError(f"no C entry {name} in the source")
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


def build(label: str, path: Path) -> ctypes.CDLL | None:
    """Compile ``path`` alone into a shared library and load it; print its
    ptxas registers and spills. None, with nvcc's errors printed, where it
    does not compile."""
    from tfmpc_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    so = OUT / f"{label}.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
         "-o", str(so), str(path)], capture_output=True, text=True)
    print(f"{label} ({path}):")
    if proc.returncode != 0:
        print(f"  nvcc failed, left out:\n{proc.stderr[-3000:]}")
        return None
    cs.print_ptxas(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so))


def in_turns(fns: dict, timer) -> dict:
    """Each fn timed twice, every fn in order and then in reverse; the
    best of its two times."""
    times: dict = {}
    for order in (list(fns), list(fns)[::-1]):
        for key in order:
            times.setdefault(key, []).append(timer(fns[key]))
    return {k: min(v) for k, v in times.items()}


# -- P1 -----------------------------------------------------------------------

def p1_launchers(label, lib, params, d, A_rows, M_rows, C):
    """{name: fn} launching version ``label`` at d into C."""
    import torch

    from tfmpc_tpu_torch.ops import _build, riccati_mid as rm

    fn = lib.tfmpc_row_matmul
    head = (0, d, P1_B, _build.ptr(A_rows), _build.ptr(M_rows), _build.ptr(C))
    if "block" in params:
        fn.argtypes = [_I] * 3 + [_P] * 3 + [_I, _P]
        shapes = {label: (256,)}
    elif "rows" in params:
        fn.argtypes = [_I] * 3 + [_P] * 3 + [_I, _I, _P]
        plan = rm.row_plan(d, torch.float32)
        shapes = {label: (plan.rows, plan.cols)}
    elif "tile" in params:
        fn.argtypes = [_I] * 3 + [_P] * 3 + [_I, _I, _P]
        shapes = {f"{label} {t}x{t}/{th}": (t, th)
                  for t in (4, 8, 12) for th in (128, 256)}
    else:
        raise ValueError(f"{label}: unknown P1 entry {params}")
    out = {}
    for name, extra in shapes.items():
        call = lambda extra=extra: fn(*head, *extra,  # noqa: E731
                                      _build.stream())
        if call() == 0:
            torch.cuda.synchronize()
            out[name] = call
    return out


def run_p1(versions, card):
    import numpy as np
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    libs = {label: (build(label, path), entry_params(
        path.read_text(), "tfmpc_row_matmul"))
        for label, path in [("checkout", CSRC / "row_matmul.cu"), *versions]}
    libs = {k: v for k, v in libs.items() if v[0] is not None}
    for d in P1_DIMS:
        rng = np.random.default_rng(d)
        A = torch.as_tensor(rng.standard_normal((P1_B, d, d)),
                            dtype=torch.float32, device="cuda")
        M = torch.as_tensor(rng.standard_normal((P1_B, d, d)),
                            dtype=torch.float32, device="cuda")
        rows = lambda X: X.reshape(P1_B, d * d).T.contiguous()  # noqa: E731
        A_rows, M_rows = rows(A), rows(M)
        want = rm.row_matmul_ref(A_rows, M_rows, d)
        fns, outs = {}, []  # outs: each launcher's C, alive while timed
        for label, (lib, params) in libs.items():
            out = torch.empty_like(A_rows)
            outs.append(out)
            for name, fn in p1_launchers(label, lib, params, d, A_rows,
                                         M_rows, out).items():
                out.zero_()
                fn()
                cs.compare(f"P1 {name} d={d}", out, want, "float32",
                           tol=(1e-5, 1e-5))
                fns[name] = fn
        fns["torch.bmm"] = lambda: torch.bmm(A, M)
        dev = in_turns(fns, lambda f: cs.graph_ms(f, 100))
        eager = in_turns(fns, lambda f: cs.cuda_ms(f, 50))
        bmm = dev["torch.bmm"]
        print(f"P1 d={d} B={P1_B} f32, device ms (graph replays) and eager "
              f"ms, best of two turns [{card}]:")
        for name in fns:
            print(f"  {name}: {dev[name]:.4f} device ({dev[name] / bmm:.3f}x "
                  f"torch.bmm), {eager[name]:.4f} eager")


# -- K7 -----------------------------------------------------------------------

def run_k7(versions, card):
    import torch

    from tfmpc_tpu_torch.ops import _build, riccati_mid as rm

    label, lin, quad, final, mu, bounds, U, iters = cs.mid_case(
        "hvac16", torch.float32)
    Bn, Tn, n, m = lin.f_u.shape
    a = rm.mid_layout(lin, quad, final, mu, bounds, U)
    plan = rm.mid_plan(n, m, Bn, torch.float32)
    libs = {v: (build(v, path), entry_params(
        path.read_text(), "tfmpc_riccati_backward_mid")) for v, path in
        versions}
    libs = {k: v for k, v in libs.items() if v[0] is not None}
    for box in (False, True):
        keys = rm.MID_BOXQP_ARGS if box else rm.MID_ARGS
        ins = [a[k] for k in keys]
        ref = (rm.riccati_backward_mid_boxqp_kernel(*ins, boxqp_iters=iters)
               if box else rm.riccati_backward_mid_kernel(*ins))
        fns = {"checkout": (lambda: rm.riccati_backward_mid_boxqp_kernel(
            *ins, boxqp_iters=iters)) if box else
            (lambda: rm.riccati_backward_mid_kernel(*ins))}
        for v, (lib, params) in libs.items():
            dtype = (0, 0) if "arith" in params else (0,)  # f32, double
            smem_fn = lib.tfmpc_riccati_mid_smem_bytes
            smem_fn.argtypes = [_I] * (len(dtype) + 4)
            smem_fn.restype = _LL
            smem = smem_fn(*dtype, n, m, plan.scenarios, int(plan.stage_l))
            fn = getattr(lib, "tfmpc_riccati_backward_mid"
                         + ("_boxqp" if box else ""))
            ints = (*dtype, n, m, Tn, Bn, *((iters,) if box else ()))
            fn.argtypes = [_I] * len(ints) + [_P] * (len(ins) + 5) \
                + [_I] * 3 + [_LL, _P]
            out = (torch.empty_like(ref[0]), torch.empty_like(ref[1]),
                   *(torch.empty_like(ref[2]) for _ in range(3)))
            call = lambda fn=fn, ints=ints, out=out, smem=smem: fn(  # noqa
                *ints, *(_build.ptr(x) for x in ins),
                *(_build.ptr(x) for x in out), plan.warps, plan.scenarios,
                int(plan.stage_l), smem, _build.stream())
            _build.check(call(), f"{v} K7")
            torch.cuda.synchronize()
            ok, ok_ref = out[4] == 0, ref[4] == 0
            both = ok & ok_ref
            share = cs.lane_share(out[:4], ref[:4], both, *cs.K4_F32_TOL)
            err = max(float((x.double()[both] - y.double()[both])
                            .abs().max()) for x, y in zip(out[:2], ref[:2]))
            print(f"  {v} K7-{'boxQP' if box else 'iLQR'} {label}: ok masks "
                  f"identical {bool(torch.equal(ok, ok_ref))}, share of ok "
                  f"lanes within {cs.K4_F32_TOL[0]:g} + "
                  f"{cs.K4_F32_TOL[1]:g}*|checkout| {share:.6f}, max K/k "
                  f"difference {err:.3e}")
            fns[v] = call
        times = in_turns(fns, lambda f: cs.cuda_ms(f, 10))
        print(f"K7-{'boxQP' if box else 'iLQR'} {label} (B={Bn}, T={Tn}, "
              f"f32 inputs, plan {plan.warps} warp(s) x {plan.scenarios} "
              f"scenarios), ms, best of two turns [{card}]: "
              + ", ".join(f"{k} {t:.4f}" for k, t in times.items()))


def main() -> int:
    import torch

    if len(sys.argv) < 3 or sys.argv[1] not in ("p1", "k7"):
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("kernel_versions.py needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    versions = []
    for arg in sys.argv[2:]:
        label, _, path = arg.partition("=")
        versions.append((label, Path(path).resolve()))
    (run_p1 if sys.argv[1] == "p1" else run_k7)(versions, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
