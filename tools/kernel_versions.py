#!/usr/bin/env python3
"""Time other versions of K7, P1, the lane Riccati kernels (K1, K4, K6a,
K6b) or the rollout kernels K2, K3, K5 and K8 beside the checkout's own,
or the small-dims Riccati kernel beside K7, on one GPU.

    python3 tools/kernel_versions.py p1 LABEL=PATH [LABEL=PATH ...]
    python3 tools/kernel_versions.py k7 LABEL=PATH [LABEL=PATH ...]
    python3 tools/kernel_versions.py lane LABEL=REV|DIR [LABEL=REV|DIR ...]
    python3 tools/kernel_versions.py lane --sweep
    python3 tools/kernel_versions.py rollout LABEL=REV|DIR[,-DNAME] [...]
        [--generic] [--clocks]
    python3 tools/kernel_versions.py rollout --sweep [KIND ...]
    python3 tools/kernel_versions.py rollout --generic-sweep [KIND ...]
    python3 tools/kernel_versions.py rollout --generic-sweep user
    python3 tools/kernel_versions.py small [--sweep] [--clocks]
        [k7ddp=PATH]

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

``lane`` takes the lane template (``LANE_FILES``: ``riccati_kernel.cuh``,
``riccati_step.cuh``, ``boxqp.cuh``, ``common.cuh`` and the four
``riccati*.cu``) and ``ops/riccati.py`` of commit REV with ``git show`` into
``ops/_build/versions/lane/LABEL/`` (git-ignored; where that directory
exists it is used as it is, so extract in a checkout and time where there
is a GPU); a DIR already holding those files, for example a variant of
the checkout's, is used as it is. It builds the four sources with that
directory first on ``-I``
(one nvcc each, in parallel), prints their ptxas lines, and holds each
kernel against the checkout's at its path's shape: K1 and K6a at the
navigation headline (B=4096, T=100), K4 at HVAC-6 (B=2048), K6b at
reservoir-5 (D1's, B=2048); in float64 identical ok masks and the ok
lanes within ``chip_smoke.TOL`` (K1, K6a) or K4's share gates (K4, K6b),
then timed in float32 in turns beside the checkout's kernel, as device
times of CUDA graph replays of 20 calls and as eager loops of 10. A version whose C entries take ``block`` launches with the block
sizes of its own ``ops/riccati.py``; one whose entries take a lane plan
with the checkout's ``lane_plan`` and its own shared-memory sum.
``lane --sweep`` builds the checkout's four sources with every G at every
lane dim (``-DTFMPC_LANE_ALL_G``) and times each variant at each dim with
every G and 4, 8, 16 and 32 scenarios a block, in float32, as device times
of graph replays (K1 and K6a at the headline's B, K4 and K6b at B=2048; n = 2
navigation, 5 reservoir-5, 6 HVAC-6, 3 HVAC-3, T=100): the measurement
behind ``ops/riccati.py`` LANE_PLANS.

``rollout`` takes the rollout sources (``ROLLOUT_FILES``) and
``ops/rollout.py`` of commit REV with ``git show`` into
``ops/_build/versions/rollout/LABEL/`` (as ``lane`` does: extract where
there is a checkout, then run where there is a GPU), builds its rollout
sources (one nvcc each, in parallel; ``,-DNAME`` after REV or DIR adds
that define to its build) and prints their ptxas lines and nvcc's wall
time per source; at ``ROLLOUT_CASES`` (the navigation headline, HVAC-6,
reservoir-5 T=500 and E1's HVAC-16 shape, with ``chip_smoke.py``'s
inputs) K2, K3 and K5, and at ``DERIVS_CASES`` (the headline, bounded
navigation and G3's two-zone shape) K8, in float32 and float64, it
requires the checkout's outputs to be bitwise equal to the version's
(K5's J, X and U; K8's X, U, J and all seven linearization blocks), then
times both in float32 in turns as device times of graph replays of 10
calls (and eager loops). A version whose C entries take ``block``
launches with its own ``ops/rollout.py`` BLOCK (K5: TRAJ_BLOCK, K8:
DERIVS_BLOCK); one whose entries take a plan with the checkout's
``rollout_plan``. Before those, the generic form (``run_generic_versions``):
K2, K3 and K5 at ``GENERIC_SWEEP_CASES``, K8 at
``DERIVS_GENERIC_SWEEP_CASES`` and, on a user env's generated step (each
version's ``rollout_user.cuh`` built on the same generated source), at
``USER_SWEEP_CASES``, each version launched at its own plans (its
``rollout.py`` loaded as a module of its own, ``rollout_module``), every
output bitwise equal to the checkout's in float64 and float32, then timed
in turns; ``--generic`` stops there. Then, at ``EMIT_CASES``, the
checkout's two line-search layouts as the solver runs them, K5 +
``select_alpha_trajectory`` against K2 + K3, as device times of graph
replays in turns (the measurement behind
``ilqr_batched._resolve_emit_traj``). ``--clocks`` also builds
``tools/rollout_clocks.cu`` (the one-thread K2/K3 loop of commit 0bac190
with clock64() between its phases) and prints, at each case, the SM
cycles a step of load wait, policy, env step and stores; then the
checkout's sources with their own phase clocks
(``-DTFMPC_ROLLOUT_CLOCKS``, csrc/rollout.cuh), the same for every kind,
and the generic form's (csrc/rollout_generic.cuh) at its cases; a version
built with that define (``LABEL=DIR,-DTFMPC_ROLLOUT_CLOCKS``) prints its
generic form's clocks too (with ``--generic``, only the generic form's).
``rollout --sweep`` builds the checkout's rollout sources with every G of
the kinds named (``costs``, ``alpha``, ``traj``, ``derivs``; all by
default) at each dim's swept env (``-DTFMPC_ROLLOUT_ALL_G``, a mask of
kinds) and times them at ``SWEEP_CASES`` (K8: ``DERIVS_SWEEP_CASES``) with
every G, 1-32 scenarios a block and 1, 2 or 4 steps staged ahead, in
float32, as device times of graph replays: the measurement behind
``ops/rollout.py`` ROLLOUT_PLANS. ``rollout --generic-sweep`` times every
plan of the generic form of the kinds named (``costs``, ``alpha``,
``traj``: K2, K3 and K5 by default; ``derivs``: K8) (``csrc/
rollout_generic.cuh``; G, 1-32 scenarios a block, 1, 2 or 4 steps ahead)
at ``GENERIC_SWEEP_CASES`` (K8: ``DERIVS_GENERIC_SWEEP_CASES``) with the
checkout's library, in float32, as device times of graph replays in turns
(the measurement behind ``ops/rollout.py`` GENERIC_PLANS), then, with K2,
K3 or K5, its two line-search layouts at each case with K5's footprint
(behind ``ilqr_batched._resolve_emit_traj`` there). ``rollout
--generic-sweep user`` times every plan of K2, K3 and K5 on a user env's
generated step functor (``csrc/rollout_user.cuh``) at
``USER_SWEEP_CASES`` (phase 31's shapes and the chain at d = 12 and 24),
beside the plan ``GENERIC_PLANS`` gives it.

``small`` times the small-dims kernel (``ops/riccati_small.py``), its
four variants, at ``SMALL_CASES`` in f32 beside K7 on the same inputs,
graph replays in turns: K4 and K6b at D3, D4, a D4 restart round, E2 and
G5, K1 at G4 (also ``riccati.riccati_backward_lanes``, the fused
iteration's layout round trip), navigation-4 split, the double
integrator and at E2's shape without the box, K6a at the double
integrator and D5 (and D5 at half its batch, one wave of blocks). K7's
boxQP, iLQR and full-DDP variants come from the checkout, its full-DDP
boxQP variant from PATH (a version of ``ops/csrc/riccati_mid_ddp.cu`` that
still has it, taken with ``git show <rev>:...`` into a copied, git-ignored
place and built alone against the checkout's ``riccati_mid.cuh``).
``--sweep`` adds every ``SMALL_SWEEP_THREADS`` bound of the plan (the
measurement behind ``riccati_small.SMALL_THREADS``); ``--clocks`` builds
the four sources with ``-DTFMPC_SMALL_CLOCKS`` and prints each case's
phase clocks a step. Each case also prints its plan and the waves of
blocks B takes for K6a (``riccati_small.small_waves`` at the runtime's
blocks an SM), which is also timed with its Hessians the other way than
the plan takes them (staged, or read in place), at the same scenarios a
block: the measurement behind ``small_launch_plan``'s choice.
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
    log = _build.library_path().with_suffix(".log").read_text()
    print("checkout (its K7 instantiations, from the library's build log):")
    keep, lines = False, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = "riccati_mid_kernel" in line
        if keep:
            lines.append(line)
    cs.print_ptxas("\n".join(lines))
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
            same = all(torch.equal(x, y) for x, y in zip(out, ref))
            both = ok & ok_ref
            share = cs.lane_share(out[:4], ref[:4], both, *cs.K4_F32_TOL)
            err = max(float((x.double()[both] - y.double()[both])
                            .abs().max()) for x, y in zip(out[:2], ref[:2]))
            print(f"  {v} K7-{'boxQP' if box else 'iLQR'} {label}: outputs "
                  f"bitwise equal to the checkout's {same}; ok masks "
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


# -- the lane Riccati kernels ------------------------------------------------

LANE_FILES = ("riccati_kernel.cuh", "riccati_step.cuh", "boxqp.cuh",
              "common.cuh", "riccati.cu", "riccati_boxqp.cu",
              "riccati_ddp.cu", "riccati_ddp_boxqp.cu")
# kernel -> (variant, C entry, old block-size name in ops/riccati.py)
LANE_KERNELS = {
    "K1": ("ilqr", "riccati_backward", "BLOCK"),
    "K4": ("boxqp", "riccati_backward_boxqp", "BOXQP_BLOCK"),
    "K6a": ("ddp", "riccati_backward_ddp", "DDP_BLOCK"),
    "K6b": ("ddp_boxqp", "riccati_backward_ddp_boxqp", "DDP_BOXQP_BLOCK"),
}


def extract_lane(label: str, rev: str) -> Path:
    """The lane template and ops/riccati.py of ``rev`` in
    ``OUT/lane/label/`` (taken with git show where the directory is
    missing)."""
    dest = OUT / "lane" / label
    if dest.is_dir():
        return dest
    tmp = dest.with_name(label + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    for name in LANE_FILES + ("riccati.py",):
        path = ("tfmpc_tpu_torch/ops/" + name if name.endswith(".py")
                else "tfmpc_tpu_torch/ops/csrc/" + name)
        text = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT,
                              capture_output=True, text=True, check=True)
        (tmp / name).write_text(text.stdout)
    tmp.rename(dest)
    return dest


def build_lane(label: str, src: Path, defines=()) -> ctypes.CDLL:
    """The four lane sources of ``src`` (headers first from ``src``, then
    the checkout's), one nvcc each in parallel, linked into one library;
    ptxas's lines printed."""
    from tfmpc_tpu_torch.ops import _build

    objs = [OUT / f"lane_{label}_{cu}.o" for cu in range(4)]
    so = OUT / f"lane_{label}.so"
    cus = [src / name for name in LANE_FILES if name.endswith(".cu")]
    log = _build._run_all(
        [[_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(src), "-I",
          str(CSRC), "-c", "-o", str(o), str(cu)] for cu, o in zip(cus, objs)],
        OUT / f"lane_{label}.compile")
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(so), *map(str, objs)]], OUT / f"lane_{label}.link")
    print(f"{label} ({src}):")
    cs.print_ptxas(log)
    return ctypes.CDLL(str(so))


def lane_case(kernel, dtype, case=None):
    """A kernel's inputs in kernel layout, as the C entry's arguments after
    its ints: (B, T, n, ints, pointers' tensors). ``case`` is an env of
    ``chip_smoke.ddp_inputs`` (by default the kernel's path: K1 and K6a the
    navigation headline, K4 HVAC-6, K6b reservoir-5), or ``hvac3``, the
    HVAC-3 oracle env at a random nominal (``env_case``; B as the
    headline's for K1 and K6a, else B_BOX)."""
    from tfmpc_tpu_torch.ops import riccati

    variant = LANE_KERNELS[kernel][0]
    box, ddp = riccati.VARIANTS[variant]
    case = case or {"K1": "navigation", "K6a": "navigation", "K4": "hvac6",
                    "K6b": "reservoir5"}[kernel]
    if case == "hvac3":
        from tfmpc_tpu_torch.models.hvac import make_hvac

        env = make_hvac([[0, 1, 0], [1, 0, 1], [0, 1, 0]], is_out=[1, 0, 0],
                        is_hall=[0, 1, 0], dtype=dtype, device="cuda")
        Bn = cs.B if kernel in ("K1", "K6a") else cs.B_BOX
        lin, quad, final, mu, U, second = env_case(env, Bn, dtype)
        bounds = env.bounds
    else:
        _, U, lin, quad, final, mu, bounds, second = cs.ddp_inputs(case,
                                                                   dtype)
    Bn, Tn, n = U.shape
    a = riccati._to_kernel_layout(lin, quad, final, mu,
                                  *((bounds, U) if box else ()))
    if ddp:
        a.update(riccati._second_to_kernel_layout(second))
    keys = {"ilqr": riccati.K1_ARGS, "boxqp": riccati.K4_ARGS,
            "ddp": riccati.K6A_ARGS, "ddp_boxqp": riccati.K6B_ARGS}[variant]
    ints = (n, n, Tn, Bn) + ((8,) if box else ())
    return Bn, Tn, n, ints, [a[k] for k in keys]


def lane_launcher(lib, source_dir, kernel, dtype, n, Bn, ints, ins, plan=None):
    """A call launching ``kernel`` of ``lib`` (its sources in
    ``source_dir``) on ``ins``, writing into fresh outputs: returns (call,
    outputs), or None where its entry refuses the shape."""
    import torch

    from tfmpc_tpu_torch.ops import _build, riccati

    variant, entry, block_name = LANE_KERNELS[kernel]
    cu = {"ilqr": "riccati.cu", "boxqp": "riccati_boxqp.cu",
          "ddp": "riccati_ddp.cu", "ddp_boxqp": "riccati_ddp_boxqp.cu"}
    params = entry_params((source_dir / cu[variant]).read_text(),
                          "tfmpc_" + entry)
    fn = getattr(lib, "tfmpc_" + entry)
    code = _build.DTYPE_CODES[dtype]
    T = ins[0].shape[0]
    m = n
    out = (torch.empty((T, m * n, Bn), dtype=dtype, device="cuda"),
           torch.empty((T, m, Bn), dtype=dtype, device="cuda"),
           *(torch.empty((Bn,), dtype=dtype, device="cuda")
             for _ in range(3)))
    ptrs = [_build.ptr(x) for x in (*ins, *out)]
    if "block" in params:
        m_ = re.search(rf"^{block_name} = (\d+)",
                       (source_dir / "riccati.py").read_text(), re.M)
        fn.argtypes = [_I] * (1 + len(ints)) + [_P] * len(ptrs) + [_I, _P]
        tail = (int(m_.group(1)),)
    else:
        plan = plan or riccati.lane_plan(variant, n, n, Bn, dtype)
        box, ddp = riccati.VARIANTS[variant]
        smem_fn = lib.tfmpc_riccati_lane_smem_bytes
        smem_fn.argtypes = [_I] * 6
        smem_fn.restype = _LL
        smem = smem_fn(int(box), int(ddp), code, n, n, plan.scenarios)
        fn.argtypes = [_I] * (1 + len(ints)) + [_P] * len(ptrs) \
            + [_I, _I, _LL, _P]
        tail = (plan.groups, plan.scenarios, smem)
    def call():
        return fn(code, *ints, *ptrs, *tail, _build.stream())

    call.outputs = out  # the kernel writes them: alive as long as the call
    if call() != 0:
        return None
    torch.cuda.synchronize()
    return call, out


def hold_lane(kernel, label, out, ref):
    """float64: a version's outputs against the checkout's; raises where
    the ok masks differ or the ok lanes fall outside the gates."""
    import torch

    ok, ok_ref = out[4] == 0, ref[4] == 0
    if not torch.equal(ok, ok_ref):
        raise AssertionError(f"{label} {kernel}: ok masks differ from the "
                             "checkout's")
    lanes = lambda o: (o[0].permute(2, 0, 1), o[1].permute(2, 0, 1),  # noqa
                       o[2], o[3])
    if LANE_KERNELS[kernel][0] in ("boxqp", "ddp_boxqp"):
        share = cs.lane_share(lanes(out), lanes(ref), ok, *cs.K4_F64_TOL)
        share_all = cs.lane_share(lanes(out), lanes(ref), ok,
                                  *cs.K4_F64_ALL_TOL)
        what = (f"share of ok lanes within {cs.K4_F64_TOL[0]:g} + "
                f"{cs.K4_F64_TOL[1]:g}*|checkout| {share:.6f} (gate >= "
                f"{cs.K4_F64_SHARE}), within {cs.K4_F64_ALL_TOL[0]:g} + "
                f"{cs.K4_F64_ALL_TOL[1]:g}*|checkout| {share_all:.6f}")
        passed = share >= cs.K4_F64_SHARE and share_all == 1.0
    else:
        share = cs.lane_share(lanes(out), lanes(ref), ok, *cs.TOL["float64"])
        what = (f"share of ok lanes within {cs.TOL['float64'][0]:g} + "
                f"{cs.TOL['float64'][1]:g}*|checkout| {share:.6f} (gate 1)")
        passed = share == 1.0
    err = max(float((x[..., ok] - y[..., ok]).abs().max())
              for x, y in zip(out[:2], ref[:2]))
    print(f"  {label} {kernel} [float64]: ok masks identical "
          f"({int((~ok).sum())} failing); {what}; max K/k difference "
          f"{err:.3e}")
    if not passed:
        raise AssertionError(f"{label} {kernel}: outside the gates")


def run_lane(versions, card):
    import torch

    from tfmpc_tpu_torch.ops import riccati

    dirs = {label: Path(rev) if Path(rev).is_dir()
            else extract_lane(label, rev) for label, rev in versions}
    if not torch.cuda.is_available():
        raise SystemExit("kernel_versions.py lane: extracted "
                         f"{sorted(dirs)}; timing needs a CUDA device")
    libs = {label: build_lane(label, d) for label, d in dirs.items()}
    launchers = {"K1": riccati.riccati_backward_kernel,
                 "K4": riccati.riccati_backward_boxqp_kernel,
                 "K6a": riccati.riccati_backward_ddp_kernel,
                 "K6b": riccati.riccati_backward_ddp_boxqp_kernel}
    for kernel in LANE_KERNELS:
        for dtype in (torch.float64, torch.float32):
            Bn, Tn, n, ints, ins = lane_case(kernel, dtype)
            ref = launchers[kernel](*ins)
            fns = {"checkout": lambda: launchers[kernel](*ins)}
            for label, lib in libs.items():
                got = lane_launcher(lib, dirs[label], kernel, dtype, n, Bn,
                                    ints, ins)
                if got is None:
                    print(f"  {label} {kernel}: refused the launch, left out")
                    continue
                call, out = got
                if dtype == torch.float64:
                    hold_lane(kernel, label, out, ref)
                fns[label] = call
            if dtype == torch.float32:
                dev = in_turns(fns, lambda f: cs.graph_ms(f, 20))
                eager = in_turns(fns, lambda f: cs.cuda_ms(f, 10))
                print(f"{kernel} (B={Bn}, T={Tn}, n=m={n}, f32), device ms "
                      "(graph replays) and eager ms, best of two turns "
                      f"[{card}]: " + ", ".join(
                          f"{k} {dev[k]:.4f} / {eager[k]:.4f}" for k in fns))


def run_lane_sweep(card):
    import torch

    from tfmpc_tpu_torch.ops import riccati

    lib = build_lane("sweep", CSRC, ("-DTFMPC_LANE_ALL_G",))
    for kernel, (variant, _, _) in LANE_KERNELS.items():
        for n, case in ((2, "navigation"), (3, "hvac3"), (5, "reservoir5"),
                        (6, "hvac6")):
            Bn, Tn, _, ints, ins = lane_case(kernel, torch.float32, case)
            fns = {}
            for G in (1, 2, 4, 8):
                for spb in (4, 8, 16, 32):
                    smem = riccati.lane_smem_bytes(variant, n, n, spb,
                                                   torch.float32)
                    if G * spb > riccati.LANE_MAX_THREADS or \
                            smem > riccati.SMEM_LIMIT:
                        continue
                    plan = riccati.LanePlan(groups=G, scenarios=spb,
                                            smem_bytes=smem)
                    got = lane_launcher(lib, CSRC, kernel, torch.float32, n,
                                        Bn, ints, ins, plan)
                    if got is not None:
                        fns[G, spb] = got[0]
            times = in_turns(fns, lambda f: cs.graph_ms(f, 10))
            allowed = [k for k in times if k[0] == 1 or k[0] >= n]
            best = min(allowed, key=times.get)
            print(f"{kernel} {case} (B={Bn}, T={Tn}, n=m={n}, f32), device "
                  "ms by lanes a scenario G and scenarios a block, best of "
                  "two turns: " + ", ".join(
                      f"G={G}/{spb} {t:.4f}" for (G, spb), t in times.items())
                  + f"; fastest with G = 1 or G >= n: G={best[0]}/{best[1]};"
                  f" LANE_PLANS {riccati.LANE_PLANS[variant][n]} [{card}]")


def env_case(env, Bn, dtype):
    """A random clipped nominal of ``env`` at Bn x T (as
    ``chip_smoke.boxqp_inputs`` draws HVAC's), its linearization, mu and
    dynamics Hessians."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.solvers.ilqr import second_derivatives

    n = env.state_size
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa
    x0 = t(rng.uniform(8.0, 18.0, (Bn, n)))
    U = env.clip(t(rng.uniform(0.0, 4.0, (Bn, cs.T, n))))
    X, _ = env.rollout(x0, U)
    lin, quad, final = env.analytic_derivatives(X, U)
    mu = t(rng.uniform(0.0, 0.5, Bn))
    return lin, quad, final, mu, U, second_derivatives(env, X, U)


# -- the rollout kernels K2, K3, K5 and K8 -----------------------------------

ROLLOUT_SOURCES = ("rollout.cu", "rollout_traj.cu", "rollout_n12.cu",
                   "rollout_n16.cu", "rollout_derivs.cu", "rollout_generic.cu",
                   "rollout_generic_traj.cu", "rollout_generic_derivs.cu")
ROLLOUT_FILES = ("rollout.cuh", "rollout_generic.cuh", "rollout_user.cuh",
                 "envs.cuh", "common.cuh", "warp.cuh", *ROLLOUT_SOURCES)
# label -> chip_smoke.py inputs: the table's shapes of K2, K3 and K5
ROLLOUT_CASES = {
    "headline": ("navigation", None, None),          # B=4096, T=100
    "hvac6": ("hvac6", None, None),                  # B=2048, T=100
    "reservoir5_t500": ("reservoir5", 1024, 500),
    "e1_hvac16": ("hvac16", 512, 50),
}
# label -> inputs of the emit-layout A/B (``emit_layouts``): the table's
# shapes, HVAC-3 and G3's re-plan (two-zone navigation, B=1024, T=20)
EMIT_CASES = {**ROLLOUT_CASES, "hvac3": ("hvac3", 2048, 100),
              "g3": ("g3", None, None)}
# label -> chip_smoke.k8_inputs case: K8's shapes (G1, G2, G3)
DERIVS_CASES = {
    "headline": "navigation",        # B=4096, T=100, one zone
    "g2_nav_bounded": "nav_bounded",  # B=256, T=50, box +-1
    "g3": "g3",                      # B=1024, T=20, two zones
}
# the sweep's shapes, one a dim (the env each dim's TFMPC_ROLLOUT_ALL_G
# build sweeps): the headline, HVAC-3 and HVAC-6 at B=2048, reservoir-5 at
# T=500, E2's HVAC-12 and E1's HVAC-16; K8's: DERIVS_CASES at n = 2 and
# the headline's n-dim navigation at 3, 5 and 6
SWEEP_CASES = {
    2: ("navigation", None, None),
    3: ("hvac3", 2048, 100),
    5: ("reservoir5", 1024, 500),
    6: ("hvac6", None, None),
    12: ("hvac12", 1024, 100),
    16: ("hvac16", 512, 50),
}
DERIVS_SWEEP_CASES = {2: tuple(DERIVS_CASES.values()),
                      **{n: (case,) for case, n in cs.K8_DIM_CASES.items()}}
# kind -> (key, C entry, the old block-size name in ops/rollout.py)
ROLLOUT_KINDS = {
    "costs": ("K2", "tfmpc_linesearch_costs", "BLOCK"),
    "alpha": ("K3", "tfmpc_rollout_alpha", "BLOCK"),
    "traj": ("K5", "tfmpc_linesearch_costs_traj", "TRAJ_BLOCK"),
    "derivs": ("K8", "tfmpc_rollout_alpha_derivs", "DERIVS_BLOCK"),
}


def extract_rollout(label: str, rev: str) -> Path:
    """The rollout sources and ops/rollout.py of ``rev`` in
    ``OUT/rollout/label/`` (taken with git show where the directory is
    missing; a file the commit lacks is left out)."""
    dest = OUT / "rollout" / label
    if dest.is_dir():
        return dest
    tmp = dest.with_name(label + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    for name in ROLLOUT_FILES + ("rollout.py",):
        path = ("tfmpc_tpu_torch/ops/" + name if name.endswith(".py")
                else "tfmpc_tpu_torch/ops/csrc/" + name)
        out = subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT,
                             capture_output=True, text=True)
        if out.returncode == 0:
            (tmp / name).write_text(out.stdout)
    tmp.rename(dest)
    return dest


def build_rollout(label: str, src: Path, defines=()) -> ctypes.CDLL:
    """The rollout sources of ``src`` that it has (headers first from
    ``src``, then the checkout's), one nvcc each in parallel, linked into
    one library; ptxas's lines printed, one per rollout instantiation, and
    nvcc's wall time per source."""
    from tfmpc_tpu_torch.ops import _build

    sources = [cu for cu in ROLLOUT_SOURCES if (src / cu).exists()]
    objs = [OUT / f"rollout_{label}_{i}.o" for i in range(len(sources))]
    so = OUT / f"rollout_{label}.so"
    log = _build._run_all(
        [[_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(src), "-I",
          str(CSRC), "-c", "-o", str(o), str(src / cu)]
         for cu, o in zip(sources, objs)], OUT / f"rollout_{label}.compile")
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(so), *map(str, objs)]], OUT / f"rollout_{label}.link")
    print(f"{label} ({src}):")
    cs.print_ptxas(log, every_rollout=True)
    cs.print_build_times(log)
    lib = ctypes.CDLL(str(so))
    if hasattr(lib, "tfmpc_rollout_generic"):  # has the generic form
        lib.tfmpc_rollout_generic.argtypes = \
            _build._SIGNATURES["tfmpc_rollout_generic"]
        lib.tfmpc_rollout_generic_max_threads.argtypes = [_I] * 5 + [
            _P, _I, _P, _I]
        lib.tfmpc_rollout_generic.restype = ctypes.c_int
        lib.tfmpc_rollout_generic_max_threads.restype = ctypes.c_int
    return lib


def _user_dir(label: str, source: str) -> Path:
    import hashlib

    return OUT / "user" / label / hashlib.sha256(
        source.encode()).hexdigest()[:16]


def build_version_users(label: str, src: Path, sources) -> None:
    """Build the user libraries (``csrc/rollout_user.cuh``) of the version
    in ``src`` on the generated steps ``sources`` that are not built yet,
    one nvcc each, all started together, as ``_build.build_user_libraries``
    builds the checkout's (which ``label="checkout"`` takes), with ``src``
    first on ``-I``, into ``OUT/user/label/``."""
    from tfmpc_tpu_torch.ops import _build

    if label == "checkout":
        _build.build_user_libraries(sources)
        return
    cmds = []
    for source in dict.fromkeys(sources):
        d = _user_dir(label, source)
        if (d / "libtfmpc_user.so").exists():
            continue
        d.mkdir(parents=True, exist_ok=True)
        (d / "user_step.cuh").write_text("#pragma once\n" + source)
        (d / "user.cu").write_text('#include "rollout_user.cuh"\n')
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-I",
                     str(CSRC), "-I", str(d), "-shared", "-o",
                     str(d / "libtfmpc_user.so"), str(d / "user.cu")])
    if cmds:
        _build._run_all(cmds, OUT / "user" / f"{label}.build")


def version_user_library(label: str, src: Path, source: str):
    """The user library of the version in ``src`` on the generated step
    ``source`` (``build_version_users``); the checkout's own for
    ``label="checkout"``."""
    from tfmpc_tpu_torch.ops import _build

    if label == "checkout":
        return _build.user_library(source)
    key = (label, source)
    if key in _VERSION_USER:
        return _VERSION_USER[key]
    build_version_users(label, src, [source])
    lib = ctypes.CDLL(str(_user_dir(label, source) / "libtfmpc_user.so"))
    for name, argtypes in _build._USER_SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.tfmpc_rollout_user_max_threads.argtypes = [_I] * 4 + [_P, _I, _P, _I]
    lib.tfmpc_rollout_user_max_threads.restype = ctypes.c_int
    lib.tfmpc_rollout_user_error_string.argtypes = [ctypes.c_int]
    lib.tfmpc_rollout_user_error_string.restype = ctypes.c_char_p
    _VERSION_USER[key] = lib
    return lib


_VERSION_USER: dict = {}


def rollout_module(label: str, src: Path, lib):
    """``ops/rollout.py`` of the version in ``src`` (the checkout's where
    ``src`` has none), loaded as a module of its own whose kernels are
    ``lib``'s and whose user libraries are the version's
    (``version_user_library``): so a version's generic launches take its
    own plans (``launch_plan``, its ``GENERIC_PLANS`` and shared-memory
    sum) and its own kernels."""
    import importlib.util
    import types

    from tfmpc_tpu_torch.ops import _build

    path = src / "rollout.py"
    if not path.exists():
        path = ROOT / "tfmpc_tpu_torch" / "ops" / "rollout.py"
    spec = importlib.util.spec_from_file_location(f"rollout_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass resolves its annotations
    spec.loader.exec_module(mod)
    proxy = types.SimpleNamespace(**vars(_build))
    proxy.library = lambda: lib
    proxy.user_library = lambda source: version_user_library(label, src,
                                                             source)
    mod._build = proxy
    mod.version_src = src
    return mod


def rollout_case(case, dtype):
    """(env, X, U, policy, kernel_args) of ``chip_smoke.py``'s inputs at a
    case of ``ROLLOUT_CASES``, ``EMIT_CASES`` or ``SWEEP_CASES``."""
    from tfmpc_tpu_torch.ops import rollout

    name, Bn, Tn = case
    if name == "navigation":
        env, X, U, _, _, _, _, policy = cs.headline_inputs(dtype, "cuda")
    elif name == "g3":
        env, X, U, policy, _ = cs.k8_inputs("g3", dtype)
    elif name == "hvac3":
        from tfmpc_tpu_torch.models.hvac import make_hvac
        import numpy as np
        import torch
        from tfmpc_tpu_torch.core.types import Policy

        env = make_hvac([[0, 1, 0], [1, 0, 1], [0, 1, 0]], is_out=[1, 0, 0],
                        is_hall=[0, 1, 0], dtype=dtype, device="cuda")
        rng = np.random.default_rng(11)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa
        U = env.clip(t(rng.uniform(0.0, 4.0, (Bn, Tn, 3))))
        X, _ = env.rollout(t(rng.uniform(8.0, 18.0, (Bn, 3))), U)
        policy = Policy(K=t(0.05 * rng.standard_normal((Bn, Tn, 3, 3))),
                        k=t(2.0 * rng.standard_normal((Bn, Tn, 3))))
    else:
        env, X, U, _, _, _, _, policy = cs.boxqp_inputs(
            name, dtype, *((Bn, Tn) if Bn else ()))
    return env, X, U, policy, rollout.kernel_args(env, X, U, policy)


def _entry_tail(source_dir, kind, plan):
    """(values, argtypes) of the launch tail of ``kind``'s C entry in the
    version in ``source_dir``: its own block size where the entry takes
    ``block``, else ``plan``."""
    _, entry, block = ROLLOUT_KINDS[kind]
    source = "rollout_derivs.cu" if kind == "derivs" else "rollout.cu"
    if "block" in entry_params((source_dir / source).read_text(), entry):
        m_ = re.search(rf"^{block} = (\d+)",
                       (source_dir / "rollout.py").read_text(), re.M)
        return (int(m_.group(1)),), [_I]
    return ((plan.groups, plan.scenarios, plan.depth, plan.smem_bytes),
            [_I, _I, _I, _LL])


def rollout_launchers(lib, source_dir, a, alphas, alpha_vec, plans=None,
                      kinds=("costs", "alpha", "traj")):
    """{"K2": call, "K3": call, "K5": call} (the keys of ``kinds``)
    launching ``lib``'s kernels (its sources in ``source_dir``) on
    ``kernel_args`` output ``a``, each writing into its own outputs
    (``call.outputs``); ``plans`` ({kind: plan}) overrides the checkout's
    ``rollout_plan`` for a version whose entries take a plan. A launch the
    entry refuses is left out."""
    import torch

    from tfmpc_tpu_torch.ops import _build, rollout

    B, T, n, m = a["dims"]
    A = len(alphas)
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    head = [_build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B]
    inputs = [_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")]
    bounds = list(rollout._bound_pointers(a))
    env_ptrs = list(rollout._env_pointers(a))
    al = (ctypes.c_double * A)(*map(float, alphas))
    plans = plans or {}
    out = {}
    for kind in kinds:
        key, entry, _ = ROLLOUT_KINDS[kind]
        tail, tail_types = _entry_tail(
            source_dir, kind, plans.get(kind)
            or rollout.launch_plan(a, kind, A))
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        if kind == "alpha":
            outs = (torch.empty((T, n, B), **opts),
                    torch.empty((T, m, B), **opts),
                    torch.empty((B,), **opts))
            fn.argtypes = [_I] * 6 + [_P] * 8 + [_I, _P, _I] + [_P] * 3 \
                + tail_types + [_P]
            args = [*head, _build.ptr(alpha_vec), *inputs, *bounds,
                    *env_ptrs, *map(_build.ptr, outs)]
        else:
            outs = (torch.empty((A, B), **opts),) if kind == "costs" else (
                torch.empty((A, B), **opts),
                torch.empty((T, A * n, B), **opts),
                torch.empty((T, A * m, B), **opts))
            fn.argtypes = [_I] * 6 + [_P] * 7 + [_I, _P, _I, _P, _I] \
                + [_P] * len(outs) + tail_types + [_P]
            args = [*head, *inputs, *bounds, al, A, *env_ptrs,
                    *map(_build.ptr, outs)]

        def call(fn=fn, args=args, tail=tail):
            return fn(*args, *tail, _build.stream())

        call.outputs = outs
        call.inputs = (a, alpha_vec)  # alive while the call may run
        if call() == 0:
            torch.cuda.synchronize()
            out[key] = call
    return out


def derivs_launchers(lib, source_dir, a, alpha_vec, plan=None):
    """{"K8": call} launching ``lib``'s K8 on ``kernel_args(...,
    derivatives=True)`` output ``a`` into its own outputs (X, U, J and the
    seven ``D_KEYS`` blocks, ``call.outputs``); ``plan`` as in
    ``rollout_launchers``. Empty where the entry refuses the launch."""
    import torch

    from tfmpc_tpu_torch.ops import _build, rollout

    B, T, n, m = a["dims"]
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    entries = dict(fx=n * n, fu=n * m, lx=n, lu=m, lxx=n * n, luu=m * m,
                   lux=m * n)
    outs = (torch.empty((T, n, B), **opts), torch.empty((T, m, B), **opts),
            torch.empty((B,), **opts),
            *(torch.empty((T, entries[key], B), **opts)
              for key in rollout.D_KEYS))
    lin = (ctypes.c_void_p * 7)(*[o.data_ptr() for o in outs[3:]])
    tail, tail_types = _entry_tail(source_dir, "derivs",
                                   plan or rollout.launch_plan(a, "derivs"))
    fn = lib.tfmpc_rollout_alpha_derivs
    fn.argtypes = [_I] * 6 + [_P] * 8 + [_I, _P, _I] + [_P] * 4 \
        + tail_types + [_P]
    fn.restype = ctypes.c_int

    def call():
        return fn(_build.DTYPE_CODES[a["dtype"]], a["env_id"], n, m, T, B,
                  _build.ptr(alpha_vec),
                  *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K", "k")),
                  *rollout._bound_pointers(a), *rollout._env_pointers(a),
                  *map(_build.ptr, outs[:3]), lin, *tail, _build.stream())

    call.outputs = outs
    call.inputs = (a, alpha_vec)  # alive while the call may run
    if call() != 0:
        return {}
    torch.cuda.synchronize()
    return {"K8": call}


def rollout_inputs(case, dtype):
    import torch

    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env, X, U, policy, a = rollout_case(case, dtype)
    alphas = ILQRConfig().alphas_static()
    B = a["dims"][0]
    dev = a["xbar"].device
    alpha_vec = torch.as_tensor(alphas, dtype=dtype, device=dev)[
        torch.arange(B, device=dev) % len(alphas)].contiguous()
    return a, alphas, alpha_vec


def derivs_inputs(case, dtype):
    """(kernel_args(..., derivatives=True), alpha_vec) of
    ``chip_smoke.k8_inputs``."""
    from tfmpc_tpu_torch.ops import rollout

    env, X, U, policy, alpha_vec = cs.k8_inputs(case, dtype)
    return (rollout.kernel_args(env, X, U, policy, derivatives=True),
            alpha_vec.contiguous())


def hold_and_time(label, shape, mine, theirs_by_version, dtype, card):
    """Each version's kernels bitwise equal to the checkout's (raises if
    not); in float32, each kernel timed in turns across the versions as
    device times of graph replays of 10 calls and eager loops of 10."""
    import torch

    fns = {("checkout", k): f for k, f in mine.items()}
    for v, theirs in theirs_by_version.items():
        for k, f in theirs.items():
            same = all(torch.equal(x, y) for x, y in zip(
                mine[k].outputs, f.outputs))
            print(f"  {v} {k} {label} [{cs.dname(dtype)}]: bitwise equal "
                  f"to the checkout's ({len(f.outputs)} outputs): {same}")
            if not same:
                raise AssertionError(f"{v} {k} {label}: outputs differ from "
                                     "the checkout's")
            fns[v, k] = f
    if dtype != torch.float32:
        return
    for k in mine:
        pick = {v: f for (v, kk), f in fns.items() if kk == k}
        dev = in_turns(pick, lambda f: cs.graph_ms(f, 10))
        eager = in_turns(pick, lambda f: cs.cuda_ms(f, 10))
        print(f"{k} {label} ({shape}, f32), device ms (graph replays) / "
              f"eager ms, best of two turns [{card}]: " + ", ".join(
                  f"{v} {dev[v]:.4f} / {eager[v]:.4f}" for v in pick))


def emit_layouts(label, case, card):
    """The line search's two layouts at a case of ``EMIT_CASES``, f32,
    as ``ilqr_batched._iteration_batched`` runs them: K5 +
    ``select_alpha_trajectory`` (emit) against K2 + K3 (two-kernel), the
    wrappers with their layout copies and, beside, the kernels alone;
    device times of graph replays of 10 iterations, in turns."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env, X, U, policy, a = rollout_case(case, torch.float32)
    alphas = ILQRConfig().alphas_static()
    B, T, n, _ = a["dims"]
    best = torch.arange(B, device="cuda") % len(alphas)
    alpha_vec = ILQRConfig().alphas(torch.float32, device="cuda")[best]

    def emit():
        J, X_a, U_a = rollout.linesearch_costs_traj(env, X, U, policy,
                                                    alphas)
        return rollout.select_alpha_trajectory(X, X_a, U_a, J, best)

    def two_kernel():
        rollout.linesearch_costs(env, X, U, policy, alphas)
        return rollout.rollout_alpha(env, X, U, policy, alpha_vec)

    a_vec = alpha_vec.contiguous()

    def emit_kernels():
        J, X_a, U_a = rollout.linesearch_costs_traj_kernel(a, alphas)
        return rollout.select_alpha_trajectory(
            X, X_a.view(T, len(alphas), n, B), U_a.view(T, len(alphas), n, B),
            J.T, best)

    def two_kernels():
        rollout.linesearch_costs_kernel(a, alphas)
        return rollout.rollout_alpha_kernel(a, a_vec)

    ms = in_turns({"emit": emit, "two_kernel": two_kernel,
                   "emit_kernels": emit_kernels,
                   "two_kernels": two_kernels},
                  lambda f: cs.graph_ms(f, 10))
    print(f"emit layouts {label} (B={B}, T={T}, n=m={n}, f32), device ms a "
          "line search + materialize, graph replays, best of two turns: "
          f"K5 + select {ms['emit']:.4f} vs K2 + K3 {ms['two_kernel']:.4f} "
          f"(ratio {ms['emit'] / ms['two_kernel']:.3f}); kernels alone: K5 "
          f"+ select {ms['emit_kernels']:.4f} vs K2 + K3 "
          f"{ms['two_kernels']:.4f} [{card}]")


def generic_hold_cases():
    """The generic form's cases of ``rollout LABEL=REV``: (label, (n, m)
    case of ``chip_smoke.generic_inputs``, B, T, kinds), K2, K3 and K5 at
    ``GENERIC_SWEEP_CASES`` and, on the generated step, at
    ``USER_SWEEP_CASES``; K8 at ``DERIVS_GENERIC_SWEEP_CASES``."""
    out = [(f"generic {case}", case, Bn, Tn, ("costs", "alpha", "traj"))
           for case, (Bn, Tn) in GENERIC_SWEEP_CASES.items()]
    out += [(f"generic {case}", case, Bn, Tn, ("derivs",))
            for case, (Bn, Tn) in DERIVS_GENERIC_SWEEP_CASES.items()]
    out += [(f"user {case}", case, Bn, Tn, ("costs", "alpha", "traj"))
            for case, (Bn, Tn) in USER_SWEEP_CASES.items()]
    return out


def generic_case_inputs(case, Bn, Tn, kinds, dtype):
    """(kernel_args output, alphas, alpha_vec) of a ``generic_hold_cases``
    case."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    alphas = ILQRConfig().alphas_static()
    if kinds == ("derivs",):
        env, X, U, policy, alpha_vec = cs.k8_generic_inputs(case, dtype, Bn,
                                                            Tn)
        a = rollout.kernel_args(env, X, U, policy, derivatives=True)
        return a, alphas, alpha_vec.contiguous()
    env, X, U, policy = cs.generic_inputs(case, dtype, Bn, Tn)
    alpha_vec = torch.as_tensor(alphas, dtype=dtype, device=X.device)[
        torch.arange(Bn, device=X.device) % len(alphas)].contiguous()
    return rollout.kernel_args(env, X, U, policy), alphas, alpha_vec


def generic_calls(mod, a, kinds, alphas, alpha_vec):
    """{"K2": call, ...}: the generic ``kinds`` on ``a`` through the
    rollout module ``mod`` (``rollout_module``), each at that module's own
    launch plan, into its own outputs; raises if a launch is refused."""
    import torch

    out = {}
    for kind in kinds:
        per = len(alphas) if kind in mod.EVERY_ALPHA else 1
        plan = mod.launch_plan(a, kind, per)
        call = generic_launcher(a, kind, plan, alphas, alpha_vec, mod)
        mod._check_generic(call(), f"{mod.__name__} {kind}", a)
        torch.cuda.synchronize()
        out[ROLLOUT_KINDS[kind][0]] = call
    return out


def run_generic_versions(mods, card):
    """The generic form of each version (``mods``: label -> its rollout
    module, ``rollout_module``) against the checkout's (``mods
    ["checkout"]``) at ``generic_hold_cases``: in float64 and float32 every
    output (J, X, U; K8's seven blocks too) bitwise equal, then each kernel
    timed in float32 in turns (``hold_and_time``), every one at its own
    version's plan."""
    import torch

    cases = generic_hold_cases()
    for dtype in (torch.float64, torch.float32):
        sources = [generic_case_inputs(case, Bn, Tn, kinds, dtype)[0]["source"]
                   for _, case, Bn, Tn, kinds in cases
                   if case in USER_SWEEP_CASES]
        for label, mod in mods.items():
            build_version_users(label, mod.version_src, sources)
    for label, case, Bn, Tn, kinds in cases:
        for dtype in (torch.float64, torch.float32):
            a, alphas, alpha_vec = generic_case_inputs(case, Bn, Tn, kinds,
                                                       dtype)
            calls = {v: generic_calls(mod, a, kinds, alphas, alpha_vec)
                     for v, mod in mods.items()}
            B, T, n, m = a["dims"]
            mine = calls.pop("checkout")
            hold_and_time(label, f"B={B}, T={T}, (n, m) = ({n}, {m})", mine,
                          calls, dtype, card)


def run_rollout(versions, card, clocks=False, generic_only=False):
    """``rollout LABEL=REV ...`` (see the module's docstring); with
    ``generic_only`` (``--generic``) the generic form alone: its holds and
    times (``run_generic_versions``) and, with ``clocks``, its phase
    clocks."""
    import torch

    # LABEL=REV|DIR[,-DNAME...]: the version built with those defines
    specs = {label: rev.split(",") for label, rev in versions}
    dirs = {label: Path(rev) if Path(rev).is_dir()
            else extract_rollout(label, rev)
            for label, (rev, *_) in specs.items()}
    if not torch.cuda.is_available():
        raise SystemExit("kernel_versions.py rollout: extracted "
                         f"{sorted(dirs)}; timing needs a CUDA device")
    libs = {label: build_rollout(label, d, tuple(specs[label][1:]))
            for label, d in dirs.items()}
    checkout = build_rollout("checkout", CSRC)
    run_generic_versions(
        {"checkout": rollout_module("checkout", CSRC, checkout),
         **{label: rollout_module(label, dirs[label], lib)
            for label, lib in libs.items()}}, card)
    if clocks:
        for label, lib in libs.items():  # the versions built with clocks
            if "-DTFMPC_ROLLOUT_CLOCKS" in specs[label][1:]:
                run_generic_clocks(lib, card, rollout_module(
                    label, dirs[label], lib), label)
        run_rollout_clocks(card, generic_only)
    if generic_only:
        return
    for label, case in ROLLOUT_CASES.items():
        for dtype in (torch.float64, torch.float32):
            a, alphas, alpha_vec = rollout_inputs(case, dtype)
            mine = rollout_launchers(checkout, CSRC, a, alphas, alpha_vec)
            if set(mine) != {"K2", "K3", "K5"}:
                raise AssertionError(f"checkout refused a launch at {label}")
            B, T, n, _ = a["dims"]
            hold_and_time(label, f"B={B}, T={T}, n=m={n}", mine, {
                v: rollout_launchers(lib, dirs[v], a, alphas, alpha_vec)
                for v, lib in libs.items()}, dtype, card)
    for label, case in DERIVS_CASES.items():
        for dtype in (torch.float64, torch.float32):
            a, alpha_vec = derivs_inputs(case, dtype)
            mine = derivs_launchers(checkout, CSRC, a, alpha_vec)
            if not mine:
                raise AssertionError(f"checkout refused K8 at {label}")
            B, T, n, _ = a["dims"]
            hold_and_time(label, f"B={B}, T={T}, n=m={n}", mine, {
                v: derivs_launchers(lib, dirs[v], a, alpha_vec)
                for v, lib in libs.items()}, dtype, card)
    for label, case in EMIT_CASES.items():
        emit_layouts(label, case, card)


def run_generic_clocks(tiles, card, mod=None, label="checkout"):
    """The generic form built with its phase clocks (``tiles``,
    ``-DTFMPC_ROLLOUT_CLOCKS``; the checkout's, or the version ``label``'s
    through its rollout module ``mod``): K2, K3 and K5 at
    ``GENERIC_SWEEP_CASES`` and K8 at ``DERIVS_GENERIC_SWEEP_CASES``,
    float32, each at its plan: SM cycles a step of each phase
    (csrc/rollout_generic.cuh), the mean over the compute threads, and the
    producer warp's."""
    import torch

    from tfmpc_tpu_torch.ops import _build

    tiles.tfmpc_rollout_clocks_buffer.argtypes = [_P]
    tiles.tfmpc_rollout_clocks_buffer.restype = None
    mod = mod or rollout_module("clocks", CSRC, tiles)
    names = ("barrier", "policy rows and U stores",
             "prep, env rows and X stores", "stage costs and their sum",
             "final cost and J")
    for _, case, Bn, Tn, kinds in generic_hold_cases():
        if case in USER_SWEEP_CASES:
            continue
        a, alphas, alpha_vec = generic_case_inputs(case, Bn, Tn, kinds,
                                                   torch.float32)
        for kernel, call in generic_calls(mod, a, kinds, alphas,
                                          alpha_vec).items():
            kind = next(k for k, v in ROLLOUT_KINDS.items()
                        if v[0] == kernel)
            per = len(alphas) if kind in mod.EVERY_ALPHA else 1
            plan = mod.launch_plan(a, kind, per)
            clk = torch.zeros(16, dtype=torch.int64, device="cuda")
            tiles.tfmpc_rollout_clocks_buffer(_build.ptr(clk))
            _build.check(call(), f"clocked generic {kernel} {case}")
            torch.cuda.synchronize()
            tiles.tfmpc_rollout_clocks_buffer(ctypes.c_void_p(None))
            c = clk.tolist()
            per_step = [x / c[13] / Tn for x in c[8:13]]
            n, m = a["dims"][2:]
            print(f"{label} generic {kernel} {case} (B={Bn}, T={Tn}, "
                  f"(n, m) = ({n}, {m}), f32, plan G={plan.groups}, "
                  f"{plan.scenarios} a "
                  f"block, D={plan.depth}, with phase clocks): SM cycles a "
                  f"step, mean over {c[13]} compute threads: " + ", ".join(
                      f"{nm} {x:.0f}" for nm, x in zip(names, per_step))
                  + f", total {sum(per_step):.0f}; the copying warp: issuing "
                  f"{c[0] / c[5] / Tn:.0f}, waiting for the step and the "
                  f"barrier {c[6] / c[5] / Tn:.0f} [{card}]")


def run_rollout_clocks(card, generic_only=False):
    """The one-thread K2/K3 loop with phase clocks
    (tools/rollout_clocks.cu) at each of ``ROLLOUT_CASES``, float32, 128
    threads a block; then the checkout's tile kernel with its own, every
    kind at its cases; then the generic form's (``run_generic_clocks``).
    ``generic_only``: the generic form's alone."""
    import torch

    from tfmpc_tpu_torch.ops import _build, rollout

    tiles = build_rollout("tile_clocks", CSRC, ("-DTFMPC_ROLLOUT_CLOCKS",))
    run_generic_clocks(tiles, card)
    if generic_only:
        return

    lib = build(f"rollout_clocks", ROOT / "tools" / "rollout_clocks.cu")
    fn = lib.tfmpc_rollout_clocks
    fn.argtypes = [_I] * 4 + [_P] * 7 + [_I, _P, _P, _I, _P, _I] + [_P] * 4 \
        + [_I, _P]
    fn.restype = ctypes.c_int
    names = ("load wait", "policy", "env step", "stores")
    for label, case in ROLLOUT_CASES.items():
        a, alphas, alpha_vec = rollout_inputs(case, torch.float32)
        B, T, n, m = a["dims"]
        A = len(alphas)
        ref2 = rollout.linesearch_costs_kernel(a, alphas)
        ref3 = rollout.rollout_alpha_kernel(a, alpha_vec)
        for kernel, costs in (("K2", True), ("K3", False)):
            opts = dict(dtype=torch.float32, device="cuda")
            X = torch.empty((T, n, B), **opts)
            U = torch.empty((T, m, B), **opts)
            J = torch.empty((A, B) if costs else (B,), **opts)
            clk = torch.zeros(6, dtype=torch.int64, device="cuda")
            rc = fn(a["env_id"], n, T, B,
                    *(_build.ptr(a[key]) for key in ("xbar", "ubar", "K",
                                                     "k")),
                    *rollout._bound_pointers(a),
                    (ctypes.c_double * A)(*map(float, alphas)), A,
                    ctypes.c_void_p(None) if costs else _build.ptr(alpha_vec),
                    *rollout._env_pointers(a), _build.ptr(X), _build.ptr(U),
                    _build.ptr(J), _build.ptr(clk), 128, _build.stream())
            _build.check(rc, f"rollout clocks {kernel} {label}")
            torch.cuda.synchronize()
            same = torch.equal(J, ref2) if costs else (
                torch.equal(J, ref3[2]) and torch.equal(X, ref3[0]))
            c = clk.tolist()
            per = [x / c[4] / T for x in c[:4]]
            print(f"{kernel} {label} (B={B}, T={T}, n=m={n}, f32, the "
                  "one-thread loop with phase clocks, 128 threads a block): "
                  "SM cycles "
                  f"a step, mean over {c[4]} threads: " + ", ".join(
                      f"{nm} {x:.0f}" for nm, x in zip(names, per))
                  + f", total {sum(per):.0f}; outputs equal to the "
                  f"checkout's kernel: {same} [{card}]")
    # the checkout's tile kernels, built with their phase clocks
    names = ("barrier", "policy rows", "u exchange and env rows",
             "cost, stores, x exchange")
    runs = []
    for label, case in ROLLOUT_CASES.items():
        a, alphas, alpha_vec = rollout_inputs(case, torch.float32)
        runs.append((label, rollout_launchers(tiles, CSRC, a, alphas,
                                              alpha_vec), a["dims"][1]))
    for label, case in DERIVS_CASES.items():
        a, alpha_vec = derivs_inputs(case, torch.float32)
        runs.append((label, derivs_launchers(tiles, CSRC, a, alpha_vec),
                     a["dims"][1]))
    for label, calls, T in runs:
        for kernel, call in calls.items():
            B = call.outputs[0].shape[-1]
            clk = torch.zeros(16, dtype=torch.int64, device="cuda")
            tiles.tfmpc_rollout_clocks_buffer(_build.ptr(clk))
            _build.check(call(), f"clocked {kernel} {label}")
            torch.cuda.synchronize()
            tiles.tfmpc_rollout_clocks_buffer(ctypes.c_void_p(None))
            c = clk.tolist()
            per = [x / c[7] / T for x in c[1:5]]
            print(f"{kernel} {label} (B={B}, T={T}, f32, the tile "
                  "kernel with phase clocks, its plan): SM cycles a step, "
                  f"mean over {c[7]} compute threads: " + ", ".join(
                      f"{nm} {x:.0f}" for nm, x in zip(names, per))
                  + f", total {sum(per):.0f}; the copying warp: issuing "
                  f"{c[0] / c[5] / T:.0f}, waiting for the step and the "
                  f"barrier {c[6] / c[5] / T:.0f} [{card}]")


def sweep_plans(kind, n, B, A, dtype, param_elems, env_id):
    """Every plan of ``kind`` at n the sweep tries: each G up to the
    dim's largest, 1-32 scenarios a block, 1, 2 or 4 steps ahead, within
    the block's threads and shared memory."""
    from tfmpc_tpu_torch.ops import rollout

    per = A if kind in rollout.EVERY_ALPHA else 1
    G = 1
    while G <= min(16, max(1, 1 << (n - 1).bit_length())):
        for spb in (1, 2, 4, 8, 16, 32):
            for D in (1, 2, 4):
                plan = rollout.rollout_plan(kind, env_id, n, n, B, A, dtype,
                                            param_elems, groups=G,
                                            scenarios=spb, depth=D)
                if plan.threads(per) <= rollout.TILE_MAX_THREADS and \
                        plan.smem_bytes <= rollout.SMEM_LIMIT:
                    yield (G, spb, D), plan
        G *= 2


def print_sweep(kind, label, B, T, n, times, sms, card):
    from tfmpc_tpu_torch.ops import rollout

    best = min(times, key=times.get)
    spread = [k for k in times if -(-B // k[1]) >= sms]
    best_spread = min(spread, key=times.get) if spread else None
    print(f"{ROLLOUT_KINDS[kind][0]} {label} (B={B}, T={T}, n=m={n}, f32), "
          "device ms by G/scenarios a block/depth, best of two turns: "
          + ", ".join(f"{G}/{spb}/{D} {t:.4f}"
                      for (G, spb, D), t in sorted(times.items()))
          + f"; fastest {'/'.join(map(str, best))} {times[best]:.4f}; "
          f"fastest with >= {sms} blocks "
          + (f"{'/'.join(map(str, best_spread))} {times[best_spread]:.4f}"
             if best_spread else "none")
          + f"; ROLLOUT_PLANS {rollout.ROLLOUT_PLANS[kind][n]} [{card}]")


def run_rollout_sweep(card, kinds):
    import torch

    from tfmpc_tpu_torch.ops import rollout

    mask = sum(1 << rollout.KIND_CODES[kind] for kind in kinds)
    lib = build_rollout("sweep", CSRC, (f"-DTFMPC_ROLLOUT_ALL_G={mask}",))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, case in SWEEP_CASES.items():
        a, alphas, alpha_vec = rollout_inputs(case, torch.float32)
        B, T, _, _ = a["dims"]
        A = len(alphas)
        pe = sum(p.numel() for p in a["params"])
        for kind in kinds:
            if kind == "derivs":
                continue
            fns = {}
            for key, plan in sweep_plans(kind, n, B, A, torch.float32, pe,
                                         a["env_id"]):
                got = rollout_launchers(lib, CSRC, a, alphas, alpha_vec,
                                        {kind: plan}, kinds=(kind,))
                fns.update({key: f for f in got.values()})
            times = in_turns(fns, lambda f: cs.graph_ms(f, 10))
            print_sweep(kind, case[0], B, T, n, times, sms, card)
    if "derivs" not in kinds:
        return
    for n, cases in DERIVS_SWEEP_CASES.items():
        for case in cases:
            a, alpha_vec = derivs_inputs(case, torch.float32)
            B, T, _, _ = a["dims"]
            pe = sum(p.numel() for p in a["params"])
            fns = {}
            for key, plan in sweep_plans("derivs", n, B, 1, torch.float32,
                                         pe, a["env_id"]):
                fns.update({key: f for f in derivs_launchers(
                    lib, CSRC, a, alpha_vec, plan).values()})
            times = in_turns(fns, lambda f: cs.graph_ms(f, 10))
            print_sweep("derivs", case, B, T, n, times, sms, card)


# -- the generic form of K2, K3 and K5 ---------------------------------------

# the generic sweep's shapes: chip_smoke.py's phase 29 cases (its paths'
# shapes and the rectangular (24, 6)) and reservoir-12 (B=1024, T=100), so
# that a row of ops/rollout.py GENERIC_PLANS is measured at each of
# max(n, m) = 2, 4, 12, 24 and 48
GENERIC_SWEEP_CASES = {**cs.GENERIC_KERNEL_CASES, "reservoir12": (1024, 100)}
# the generic K8's: chip_smoke.py's phase 30 G4 (navigation in 4 dims) and
# G5 (12 dims, box +-1) shapes, one for each row of GENERIC_PLANS["derivs"]
DERIVS_GENERIC_SWEEP_CASES = {
    case: (Bn, Tn) for case, Bn, Tn, _ in cs.FUSED_MID_PATHS.values()}
# the generated step's: chip_smoke.py's phase 31 paths (the custom-env
# example's chain at its own size, d = 6 with the box at +-1, and at d =
# 48, and the (8, 3) fuzz env) and the chain at d = 12 and 24, so that a
# plan is measured at max(n, m) = 6, 8, 12, 24 and 48
USER_SWEEP_CASES = {**{case: v[:2] for case, v in cs.USER_PATHS.items()},
                    "chain12": (512, 50), "chain24": (512, 50)}


def generic_launcher(a, kind, plan, alphas, alpha_vec, rollout=None):
    """A call launching the generic ``kind`` with ``plan`` on
    ``kernel_args`` output ``a`` into its own outputs, through
    ``rollout._launch_generic`` (by default the checkout's module; a
    version's from ``rollout_module``)."""
    import torch

    if rollout is None:
        from tfmpc_tpu_torch.ops import rollout

    B, T, n, m = a["dims"]
    A = len(alphas)
    opts = dict(dtype=a["dtype"], device=a["xbar"].device)
    if kind == "costs":
        outs = (torch.empty((A, B), **opts),)
        kw = dict(alphas=alphas)
    elif kind == "derivs":
        entries = dict(fx=n * n, fu=n * m, lx=n, lu=m, lxx=n * n, luu=m * m,
                       lux=m * n)
        kargs = {key: torch.empty((T, entries[key], B), **opts)
                 for key in rollout.D_KEYS}
        outs = (torch.empty((B,), **opts), torch.empty((T, n, B), **opts),
                torch.empty((T, m, B), **opts),
                *(kargs[key] for key in rollout.D_KEYS))
        kw = dict(alpha=alpha_vec, kargs=kargs)
    elif kind == "alpha":
        outs = (torch.empty((B,), **opts), torch.empty((T, n, B), **opts),
                torch.empty((T, m, B), **opts))
        kw = dict(alpha=alpha_vec)
    else:
        outs = (torch.empty((A, B), **opts),
                torch.empty((T, A * n, B), **opts),
                torch.empty((T, A * m, B), **opts))
        kw = dict(alphas=alphas)

    def call():
        return rollout._launch_generic(a, kind, plan, *outs[:3], **kw)

    call.outputs = outs
    return call


def generic_sweep_plans(kind, env_id, n, m, B, A, dtype, param_elems,
                        max_threads):
    """Every generic plan of ``kind`` at (n, m) the sweep tries: each G up
    to twice the larger dim's power of two (at most 32), 1-32 scenarios a
    block, 1, 2 or 4 steps ahead, within the block's threads and shared
    memory."""
    from tfmpc_tpu_torch.ops import rollout

    top = min(32, 2 * (1 << (max(n, m) - 1).bit_length()))
    for G in (g for g in rollout.GENERIC_GROUPS if g <= top):
        for spb in (1, 2, 4, 8, 16, 32):
            for D in (1, 2, 4):
                try:
                    yield (G, spb, D), rollout._generic_plan(
                        kind, env_id, n, m, B, A, dtype, param_elems, G,
                        spb, D, max_threads)
                except (ValueError, NotImplementedError):
                    continue


def generic_emit_layouts(label, case, card):
    """The line search's two layouts on the generic form at a
    ``GENERIC_SWEEP_CASES`` case, f32, as ``emit_layouts`` times them (the
    wrappers with their layout copies, then the kernels alone), and the
    emit layout's footprint: the A (n + m) T B values K5 holds until the
    select."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    Bn, Tn = GENERIC_SWEEP_CASES[case]
    env, X, U, policy = cs.generic_inputs(case, torch.float32, Bn, Tn)
    a = rollout.kernel_args(env, X, U, policy)
    alphas = ILQRConfig().alphas_static()
    A = len(alphas)
    B, T, n, m = a["dims"]
    best = torch.arange(B, device="cuda") % A
    alpha_vec = ILQRConfig().alphas(torch.float32, device="cuda")[best]
    a_vec = alpha_vec.contiguous()

    def emit():
        J, X_a, U_a = rollout.linesearch_costs_traj(env, X, U, policy,
                                                    alphas)
        return rollout.select_alpha_trajectory(X, X_a, U_a, J, best)

    def two_kernel():
        rollout.linesearch_costs(env, X, U, policy, alphas)
        return rollout.rollout_alpha(env, X, U, policy, alpha_vec)

    def emit_kernels():
        J, X_a, U_a = rollout.linesearch_costs_traj_kernel(a, alphas)
        return rollout.select_alpha_trajectory(
            X, X_a.view(T, A, n, B), U_a.view(T, A, m, B), J.T, best)

    def two_kernels():
        rollout.linesearch_costs_kernel(a, alphas)
        return rollout.rollout_alpha_kernel(a, a_vec)

    ms = in_turns({"emit": emit, "two_kernel": two_kernel,
                   "emit_kernels": emit_kernels,
                   "two_kernels": two_kernels},
                  lambda f: cs.graph_ms(f, 5))
    held = A * (n + m) * T * B * 4
    print(f"generic emit layouts {label} (B={B}, T={T}, (n, m) = ({n}, {m}),"
          f" f32), device ms a line search + materialize, graph replays, "
          f"best of two turns: K5 + select {ms['emit']:.4f} vs K2 + K3 "
          f"{ms['two_kernel']:.4f} (ratio {ms['emit'] / ms['two_kernel']:.3f}"
          f"); kernels alone: K5 + select {ms['emit_kernels']:.4f} vs K2 + "
          f"K3 {ms['two_kernels']:.4f}; K5's trajectories {held} bytes "
          f"({held / 1e9:.3f} GB; at B=4096, T=500: "
          f"{A * (n + m) * 500 * 4096 * 4 / 1e9:.2f} GB) [{card}]")


def run_generic_sweep(card, kinds=("costs", "alpha", "traj")):
    """Every generic plan of ``kinds`` at ``GENERIC_SWEEP_CASES`` (K8:
    ``DERIVS_GENERIC_SWEEP_CASES``), f32, as device times of graph replays
    of 5 calls in turns (the measurement behind ops/rollout.py
    GENERIC_PLANS), then, for K2, K3 or K5, the two line-search layouts on
    the generic form at each case (``generic_emit_layouts``: the
    measurement behind ``ilqr_batched._resolve_emit_traj`` at those
    dims). ``kinds`` = ``("user",)``: K2, K3 and K5 on the generated step
    at ``USER_SWEEP_CASES``, each beside ``GENERIC_PLANS``' plan for it."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    alphas = ILQRConfig().alphas_static()
    A = len(alphas)
    cases = [(case, Bn, Tn, [k for k in kinds if k != "derivs"])
             for case, (Bn, Tn) in GENERIC_SWEEP_CASES.items()]
    if "user" in kinds:
        kinds = ("costs", "alpha", "traj")
        cases = [(case, Bn, Tn, list(kinds))
                 for case, (Bn, Tn) in USER_SWEEP_CASES.items()]
    elif "derivs" in kinds:
        cases += [(case, Bn, Tn, ["derivs"])
                  for case, (Bn, Tn) in DERIVS_GENERIC_SWEEP_CASES.items()]
    for case, Bn, Tn, case_kinds in cases:
        if not case_kinds:
            continue
        if case_kinds == ["derivs"]:
            env, X, U, policy, _ = cs.k8_generic_inputs(case, torch.float32,
                                                        Bn, Tn)
        else:
            env, X, U, policy = cs.generic_inputs(case, torch.float32, Bn,
                                                  Tn)
        a = rollout.kernel_args(env, X, U, policy,
                                derivatives=case_kinds == ["derivs"])
        n, m = env.state_size, env.action_size
        pe = sum(p.numel() for p in a["params"])
        alpha_vec = torch.as_tensor(alphas, dtype=torch.float32,
                                    device="cuda")[
            torch.arange(Bn, device="cuda") % A].contiguous()
        for kind in case_kinds:
            fns = {}
            for key, plan in generic_sweep_plans(
                    kind, a["env_id"], n, m, Bn, A, torch.float32, pe,
                    rollout.kernel_max_threads(kind, a, generic=True)):
                call = generic_launcher(a, kind, plan, alphas, alpha_vec)
                if call() == 0:
                    torch.cuda.synchronize()
                    fns[key] = call
            times = in_turns(fns, lambda f: cs.graph_ms(f, 5))
            best = min(times, key=times.get)
            spread = [k for k in times if -(-Bn // k[1]) >= sms]
            best_spread = min(spread, key=times.get) if spread else None
            plan = rollout.launch_plan(a, kind, A)
            table = times.get((plan.groups, plan.scenarios, plan.depth))
            print(f"generic {ROLLOUT_KINDS[kind][0]} {case} (B={Bn}, T={Tn}, "
                  f"(n, m) = ({n}, {m}), f32), device ms by G/scenarios a "
                  "block/depth, best of two turns: " + ", ".join(
                      f"{G}/{spb}/{D} {t:.4f}"
                      for (G, spb, D), t in sorted(times.items()))
                  + f"; fastest {'/'.join(map(str, best))} "
                  f"{times[best]:.4f}; fastest with >= {sms} blocks "
                  + (f"{'/'.join(map(str, best_spread))} "
                     f"{times[best_spread]:.4f}" if best_spread else "none")
                  + f"; GENERIC_PLANS' plan {plan.groups}/{plan.scenarios}/"
                  f"{plan.depth}"
                  + (f" {table:.4f} ({table / times[best]:.3f}x the "
                     "fastest)" if table is not None else "") + f" [{card}]")
    if set(kinds) - {"derivs"} and cases[0][0] in GENERIC_SWEEP_CASES:
        for case in GENERIC_SWEEP_CASES:
            generic_emit_layouts(case, case, card)


# -- K4 and K6b at small dims -------------------------------------------------

# label -> (chip_smoke.py case, (n, m), B, T, full DDP, box): the paths
# that run the small-dims kernel (phase 30's D3 and D4, a D4 restart round
# of 128 gathered lanes, E2, G5 with the box; G4, navigation-4 split, the
# double integrator and D5 without), chip_smoke.py's inputs at each; K1 at
# E2's shape and D5 at half its batch besides
SMALL_CASES = {
    "D3": ("reservoir4", (4, 4), 2048, 100, True, True),
    "D4": ("hvac12ring", (12, 12), 512, 50, True, True),
    "D4 restart round": ("hvac12ring", (12, 12), 128, 50, True, True),
    "E2": ("hvac12", (12, 12), 1024, 100, False, True),
    "G5": ("nav12_box", (12, 12), 1024, 50, False, True),
    "G4": ("nav4", (4, 4), 4096, 100, False, False),
    "navigation-4 split": ("nav4", (4, 4), 4096, 100, False, False),
    "double integrator": ("double_integrator", (2, 1), 4096, 100, False,
                          False),
    "double integrator DDP": ("double_integrator", (2, 1), 4096, 100, True,
                              False),
    "D5": ("nav12", (12, 12), 1024, 50, True, False),
    "D5 at B=512": ("nav12", (12, 12), 512, 50, True, False),
    "K1 at E2's shape": ("hvac12ring", (12, 12), 1024, 100, False, False),
}
SMALL_SWEEP_THREADS = (32, 64, 128, 256)
# the phase clocks' slots (csrc/riccati_small.cuh small_clocks) in the
# order a step runs them, and their names
SMALL_CLOCK_ORDER = (5, 6, 7, 8, 0, 1, 2, 3, 4)
SMALL_CLOCK_NAMES = ("wait", "f_x, f_u widened", "W, W_u", "Q blocks",
                     "box and staging", "PD probe", "Newton iterations "
                     "(without the box: k's back substitution)",
                     "final factor, K, dV", "value update")
SMALL_FILES = ("riccati_small.cu", "riccati_small_ddp.cu",
               "riccati_small_ilqr.cu", "riccati_small_ddp_ilqr.cu")
# each variant's (box, ddp) C entry suffix: tfmpc_riccati_backward_small<s>
# and the clocks' tfmpc_riccati_small<c>_clocks
SMALL_ENTRIES = {(True, False): ("_boxqp", ""),
                 (True, True): ("_ddp_boxqp", "_ddp"),
                 (False, False): ("", "_ilqr"),
                 (False, True): ("_ddp", "_ddp_ilqr")}


def build_small(label: str, defines=()) -> ctypes.CDLL:
    """The checkout's four small-dims sources built with ``defines`` (one
    nvcc each, in parallel) into one library under ``OUT``; ptxas lines
    printed."""
    from concurrent.futures import ThreadPoolExecutor

    from tfmpc_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    objs = [OUT / f"small_{label}_{Path(f).stem}.o" for f in SMALL_FILES]

    def one(src_obj):
        src, obj = src_obj
        return subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-c", "-o",
             str(obj), str(CSRC / src)], capture_output=True, text=True)

    with ThreadPoolExecutor(len(SMALL_FILES)) as ex:
        procs = list(ex.map(one, zip(SMALL_FILES, objs)))
    for proc in procs:
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stderr[-3000:]}")
        cs.print_ptxas(proc.stdout + proc.stderr)
    so = OUT / f"small_{label}.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), *map(str, objs)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    tail = [_I] * 3 + [_LL, _P]  # the plan and the stream
    lib.tfmpc_riccati_backward_small_boxqp.argtypes = [_I] * 6 + [_P] * 18 \
        + tail
    lib.tfmpc_riccati_backward_small_ddp_boxqp.argtypes = [_I] * 6 \
        + [_P] * 21 + tail
    lib.tfmpc_riccati_backward_small.argtypes = [_I] * 5 + [_P] * 15 + tail
    lib.tfmpc_riccati_backward_small_ddp.argtypes = [_I] * 5 + [_P] * 18 \
        + tail
    return lib


def small_case(case, dims, Bn, Tn, ddp, box=True):
    """chip_smoke.py's f32 inputs of a ``SMALL_CASES`` shape in the solver
    layout (``riccati_mid.mid_layout``; without ``box`` no ubar, lo, hi)
    and their boxQP iterations."""
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    if case == "hvac12":
        _, lin, quad, final, mu, bounds, U, iters = cs.mid_case(
            "hvac12", torch.float32)
        second = None
    else:
        _, lin, quad, final, mu, bounds, U, second, iters = \
            cs.ddp_mid_inputs(case, dims, torch.float32, Bn, Tn)
    if not box:
        bounds = U = None
    return rm.mid_layout(lin, quad, final, mu, bounds, U,
                         second if ddp else None), iters


def round_trip(case, Bn, Tn):
    """The fused iteration's backward without a box at a G4 shape
    (``riccati.riccati_backward_lanes`` on ``chip_smoke.time_k7_lanes``'
    kernel-layout blocks of a random nominal): the small-dims K1 through
    the layout round trip."""
    import torch

    from tfmpc_tpu_torch.ops import riccati
    from tfmpc_tpu_torch.solvers import ilqr_batched

    env, X, U, _, _ = cs.k8_generic_inputs(case, torch.float32, Bn, Tn)
    ka = ilqr_batched._initial_kargs(env, X, U)
    VT, vT = ilqr_batched._final_klayout(env, X[:, -1])
    mu = torch.full((Bn,), 0.1, device="cuda")
    return lambda: riccati.riccati_backward_lanes(ka, VT, vT, mu)


def run_small(card, sweep=False, clocks=False, k7ddp=None):
    """The small-dims kernel at ``SMALL_CASES`` in f32, as device times of
    graph replays of 5 calls in turns beside K7 on the same inputs (its
    boxQP, iLQR and full-DDP variants from the checkout; its full-DDP boxQP
    variant from the source ``k7ddp``, a version of ``riccati_mid_ddp.cu``
    built alone against the checkout's ``riccati_mid.cuh``, where given);
    at G4 also the fused iteration's layout round trip (``round_trip``);
    ``sweep``: also each of ``SMALL_SWEEP_THREADS`` threads a block at
    most (the measurement behind ``riccati_small.SMALL_THREADS``);
    ``clocks``: the kernel built with ``-DTFMPC_SMALL_CLOCKS``, its phase
    clocks a step (thread 0 of block 0, ``SMALL_CLOCK_NAMES``) and its
    warp's Newton iterations."""
    import torch

    from tfmpc_tpu_torch.ops import _build, riccati_mid as rm, \
        riccati_small as rs

    k7lib = None
    if k7ddp is not None:
        k7lib = build("k7ddp", Path(k7ddp).resolve())
        k7lib.tfmpc_riccati_backward_mid_ddp_boxqp.argtypes = [_I] * 6 \
            + [_P] * 21 + [_I] * 3 + [_LL, _P]
    clk = build_small("clocks", ("-DTFMPC_SMALL_CLOCKS",)) if clocks \
        else None
    launchers = {
        (True, False): (rs.riccati_backward_small_boxqp_kernel,
                        rs.SMALL_BOXQP_ARGS),
        (True, True): (rs.riccati_backward_small_ddp_boxqp_kernel,
                       rs.SMALL_DDP_BOXQP_ARGS),
        (False, False): (rs.riccati_backward_small_kernel, rs.SMALL_ARGS),
        (False, True): (rs.riccati_backward_small_ddp_kernel,
                        rs.SMALL_DDP_ARGS)}
    import dataclasses

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (case, dims, Bn, Tn, ddp, box) in SMALL_CASES.items():
        n, m = dims
        a, iters = small_case(case, dims, Bn, Tn, ddp, box)
        launcher, keys = launchers[box, ddp]
        ins = [a[k] for k in keys]

        def waves(p, n=n, m=m, Bn=Bn):
            return rs.small_waves(p, Bn, rs.small_blocks_per_sm(
                p, n, m, torch.float32), sms)

        it = dict(boxqp_iters=iters) if box else {}
        plan = rs.small_launch_plan(n, m, Bn, torch.float32, ddp, box, sms)
        print(f"{label}: plan {plan.groups} lanes x {plan.scenarios} "
              f"scenarios, {plan.smem_bytes} B shared a block"
              + (f", Hessians {'staged' if plan.stage_h else 'in place'}, "
                 f"{waves(plan)} wave(s) at B={Bn}" if ddp and not box
                 else ""))
        fns = {f"small ({plan.groups} lanes x {plan.scenarios})":
               lambda: launcher(*ins, **it)}
        if ddp and not box:
            # the other side of small_launch_plan's choice for K6a's
            # Hessians, at the same scenarios a block
            other = dataclasses.replace(
                plan, stage_h=not plan.stage_h,
                smem_bytes=rs.small_smem_bytes(n, m, torch.float32, True,
                                               plan.scenarios, box=box,
                                               stage_h=not plan.stage_h))
            fns[f"small, Hessians {'staged' if other.stage_h else 'in place'}"
                f" ({waves(other)} wave(s))"] = \
                lambda other=other: launcher(*ins, **it, plan=other)
        if sweep:
            for threads in SMALL_SWEEP_THREADS:
                p = rs.small_plan(n, m, Bn, torch.float32, ddp, threads,
                                  box=box, stage_h=plan.stage_h)
                fns[f"small, <= {threads} threads ({p.scenarios} a block)"] \
                    = lambda p=p: launcher(*ins, **it, plan=p)
        if label == "G4":
            fns["small through the layout round trip"] = round_trip(
                case, Bn, Tn)
        if box and not ddp:
            fns["K7"] = lambda: rm.riccati_backward_mid_boxqp_kernel(
                *(a[k] for k in rm.MID_BOXQP_ARGS), boxqp_iters=iters)
        elif not box:
            k7, k7keys = ((rm.riccati_backward_mid_ddp_kernel,
                           rm.MID_DDP_ARGS) if ddp else
                          (rm.riccati_backward_mid_kernel, rm.MID_ARGS))
            fns["K7"] = lambda k7=k7, k7keys=k7keys: k7(
                *(a[k] for k in k7keys))
        elif k7lib is not None:
            kp = rm.mid_plan(n, m, Bn, torch.float32)
            k7ins = [a[k] for k in rs.SMALL_DDP_BOXQP_ARGS]
            out = launcher(*ins, boxqp_iters=iters)
            k7out = [torch.empty_like(x) for x in out]

            def k7call(k7ins=k7ins, k7out=k7out, kp=kp):
                _build.check(k7lib.tfmpc_riccati_backward_mid_ddp_boxqp(
                    0, n, m, Tn, Bn, iters, *map(_build.ptr, k7ins),
                    *map(_build.ptr, k7out), kp.warps, kp.scenarios,
                    int(kp.stage_l), kp.smem_bytes, _build.stream()),
                    "K7 DDP boxQP")

            k7call()
            torch.cuda.synchronize()
            ok = (out[4] == 0) & (k7out[4] == 0)
            print(f"  {label}: K7's DDP boxQP variant, ok masks identical "
                  f"{bool(torch.equal(out[4], k7out[4]))}, largest K/k "
                  "difference on lanes ok in both "
                  + str(max(float((x - y)[ok].abs().max())
                            for x, y in zip(out[:2], k7out[:2]))))
            fns["K7"] = k7call
        if "K7" in fns and not box:
            out, out7 = launcher(*ins), fns["K7"]()
            torch.cuda.synchronize()
            ok = (out[4] == 0) & (out7[4] == 0)
            print(f"  {label}: K7's fail mask identical "
                  f"{bool(torch.equal(out[4], out7[4]))}, largest K/k "
                  "difference on lanes ok in both "
                  + str(max(float((x - y)[ok].abs().max())
                            for x, y in zip(out[:2], out7[:2]))))
        times = in_turns(fns, lambda f: cs.graph_ms(f, 5))
        print(f"{label}, {case} {dims} B={Bn} T={Tn}, f32, ms (graph "
              f"replays of 5, best of two turns) [{card}]: "
              + ", ".join(f"{k} {t:.4f}" for k, t in times.items()))
        if clk is not None:
            entry, suffix = SMALL_ENTRIES[box, ddp]
            fn = getattr(clk, "tfmpc_riccati_backward_small" + entry)
            out = [torch.empty_like(x) for x in launcher(*ins, **it)]
            ints = (0, n, m, Tn, Bn) + ((iters,) if box else ())
            _build.check(fn(*ints, *map(_build.ptr, ins),
                            *map(_build.ptr, out), plan.groups,
                            plan.scenarios, int(plan.stage_h),
                            plan.smem_bytes, _build.stream()), "clocks")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 10)()
            getattr(clk, f"tfmpc_riccati_small{suffix}_clocks")(buf)
            c = [buf[i] / Tn for i in SMALL_CLOCK_ORDER] + [buf[9] / Tn]
            print(f"  {label} phase clocks a step ("
                  + ", ".join(SMALL_CLOCK_NAMES) + "): "
                  + ", ".join(f"{x:.0f}" for x in c[:-1])
                  + f"; total {sum(c[:-1]):.0f}; its warp's Newton "
                  f"iterations {c[-1]:.2f} a step")


def main() -> int:
    import torch

    if sys.argv[1:] != ["small"] and (
            len(sys.argv) < 3 or sys.argv[1] not in ("p1", "k7", "lane",
                                                     "rollout", "small")):
        print(__doc__)
        return 2
    if sys.argv[1] == "rollout" and sys.argv[2] not in ("--sweep",
                                                        "--generic-sweep"):
        args = [arg for arg in sys.argv[2:]
                if arg not in ("--clocks", "--generic")]
        versions = [tuple(arg.partition("=")[::2]) for arg in args]
        if torch.cuda.is_available():
            torch.backends.cuda.matmul.allow_tf32 = False
            card = cs.card_line()
            print(card)
        else:
            card = None
        run_rollout(versions, card, clocks="--clocks" in sys.argv,
                    generic_only="--generic" in sys.argv)
        return 0
    if sys.argv[1] == "lane" and sys.argv[2] != "--sweep":
        versions = [tuple(arg.partition("=")[::2]) for arg in sys.argv[2:]]
        if torch.cuda.is_available():
            torch.backends.cuda.matmul.allow_tf32 = False
            card = cs.card_line()
            print(card)
        else:
            card = None
        run_lane(versions, card)
        return 0
    if not torch.cuda.is_available():
        print("kernel_versions.py needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card)
    if sys.argv[1] == "lane":
        run_lane_sweep(card)
        return 0
    if sys.argv[1] == "small":
        k7ddp = [a.partition("=")[2] for a in sys.argv[2:]
                 if a.startswith("k7ddp=")]
        run_small(card, "--sweep" in sys.argv, "--clocks" in sys.argv,
                  k7ddp[0] if k7ddp else None)
        return 0
    if sys.argv[1] == "rollout" and sys.argv[2] == "--generic-sweep":
        run_generic_sweep(card, sys.argv[3:] or ("costs", "alpha", "traj"))
        return 0
    if sys.argv[1] == "rollout":
        run_rollout_sweep(card, sys.argv[3:] or ("costs", "alpha", "traj",
                                                 "derivs"))
        return 0
    versions = []
    for arg in sys.argv[2:]:
        label, _, path = arg.partition("=")
        versions.append((label, Path(path).resolve()))
    (run_p1 if sys.argv[1] == "p1" else run_k7)(versions, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
