#!/usr/bin/env python3
"""Time other versions of K7, P1 or the lane Riccati kernels (K1, K4, K6a,
K6b) beside the checkout's own, on one GPU.

    python3 tools/kernel_versions.py p1 LABEL=PATH [LABEL=PATH ...]
    python3 tools/kernel_versions.py k7 LABEL=PATH [LABEL=PATH ...]
    python3 tools/kernel_versions.py lane LABEL=REV|DIR [LABEL=REV|DIR ...]
    python3 tools/kernel_versions.py lane --sweep

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


def main() -> int:
    import torch

    if len(sys.argv) < 3 or sys.argv[1] not in ("p1", "k7", "lane"):
        print(__doc__)
        return 2
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
    versions = []
    for arg in sys.argv[2:]:
        label, _, path = arg.partition("=")
        versions.append((label, Path(path).resolve()))
    (run_p1 if sys.argv[1] == "p1" else run_k7)(versions, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
