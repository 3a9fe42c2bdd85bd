"""Time slices of ``chip_smoke.py``'s phases in one checkout or several.

    python tools/phase_ab.py [--slices b,e,generic,h,user]
        [--max-copies N[,N ...]] ROOT [ROOT ...]

For each ROOT (a checkout of the repo, e.g. one unpacked from ``git
archive`` of a parent commit), in the order given and each in a process of
its own: its ``chip_smoke.py`` builds its kernels, runs what the slices
need (K4 at HVAC-6, whose bound phase 20 reads, for ``e``), then the
slices named, in this order,
with every gate they hold: ``b`` phases 5-7 (HVAC-6, reservoir-5, bounded
navigation), ``e`` phases 20-23, ``generic`` phase 29, ``h`` phase 30,
``user`` phase 31 (default: all five). It prints one line ``AB {"root":
..., "phase_s": {...}, "card": ...}``. Give the roots as parent, change,
change, parent to compare two versions on one card in turns. With
``--max-copies`` each root runs once for each value given, in that order,
with ``tfmpc_tpu_torch.models.base.MAX_COPIES`` (the most (point, copy)
pairs of one reverse pass of the autodiff linearization) set to it; the
AB line names it. Needs one CUDA card; exits non-zero if a root's run
fails.

A checkout whose ``main()`` still runs phases 5-7 inline (no ``slice_b``)
runs them here as that ``main()`` did: the same solves and holds, each
plain-path hold at the solve's own horizon.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

SLICES = ("b", "e", "generic", "h", "user")


def inline_slice_b(cs, phase, launches, plain_s):
    """Phases 5-7 of a ``chip_smoke.py`` that runs them inline in
    ``main()``, through that module's helpers."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    config = ILQRConfig(**cs.BOXQP)
    kernels = {"riccati_backward_boxqp"} | cs.line_search_kernels(
        config, cs.T, 6)
    plain_cfg = dataclasses.replace(config, use_pallas=False)
    for step, (name, lohi) in (("5. HVAC-6", ("hvac6", (8.0, 18.0))),
                               ("7. reservoir-5 and bounded navigation",
                                ("reservoir5", (20.0, 95.0)))):
        env = cs.bounded_env(name, torch.float32)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            *lohi, (cs.B_BOX, env.state_size)).astype("float32"),
            device="cuda")
        run = cs.solver(env, x0, cs.T, config)
        run()
        res, launches[name], plain = cs.counted(run)
        cs.require_path(name, launches[name], plain, kernels)
        cs.check_result(name, res, cs.B_BOX, env.state_size)
        plain_s[name] = cs.agree_with_plain(name, res, cs.solver(
            env, x0, cs.T, plain_cfg))
        if name == "hvac6":
            cs.layouts_agree(name, res, cs.solver(env, x0, cs.T, (
                dataclasses.replace(config,
                                    linesearch_emit_trajectories=False))),
                "riccati_backward_boxqp")
            phase.done(step)
            cs.hvac3_accuracy()
            phase.done("6. HVAC-3 accuracy")
            continue
        nav_b = cs.bounded_env("nav_bounded", torch.float32)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            -10.0, 10.0, (cs.B_NAV_BOUNDED, cs.N)).astype("float32"),
            device="cuda")
        for boxqp, backward in ((True, "riccati_backward_boxqp"),
                                (False, "riccati_backward")):
            cfg = ILQRConfig(**{**cs.HEADLINE, "boxqp": boxqp})
            res, counts, plain = cs.counted(cs.solver(nav_b, x0,
                                                      cs.T_NAV_BOUNDED, cfg))
            cs.require_path(f"bounded navigation {boxqp}", counts, plain,
                            {backward} | cs.line_search_kernels(cfg, cs.T,
                                                                cs.N))
            cs.agree_with_plain(f"bounded navigation {boxqp}", res,
                                cs.solver(nav_b, x0, cs.T_NAV_BOUNDED,
                                          dataclasses.replace(
                                              cfg, use_pallas=False)))
        phase.done(step)


def run_root(root: Path, slices, max_copies=None) -> int:
    """The slices of ``root``'s ``chip_smoke.py`` in this process."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "tests"))
    import chip_smoke as cs
    import torch

    from tfmpc_tpu_torch.models import base

    if max_copies is not None:
        base.MAX_COPIES = max_copies

    if not torch.cuda.is_available():
        raise SystemExit("phase_ab.py: no CUDA device available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = cs.card_line()
    print(card)
    from tfmpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s")
    timings, errs, launches, plain_s, rates = {}, {}, {}, {}, {}
    if "e" in slices:
        cs.check_k4("hvac6", torch.float32, timings, errs)
    phase = cs.Phases(time.perf_counter())
    if "b" in slices:
        if hasattr(cs, "slice_b"):
            cs.slice_b(phase, launches, plain_s)
        else:
            inline_slice_b(cs, phase, launches, plain_s)
    if "e" in slices:
        cs.slice_e(phase, timings, errs, launches, plain_s, rates, card)
    if "generic" in slices:
        cs.slice_generic(phase, timings, errs, launches, plain_s, card)
    if "h" in slices:
        cs.slice_h(phase, timings, errs, launches, plain_s, rates, card)
    if "user" in slices:
        cs.slice_user(phase, timings, errs, launches, plain_s, card)
    print("AB " + json.dumps({"root": str(root),
                              "max_copies": getattr(base, "MAX_COPIES", None),
                              "phase_s": phase.seconds,
                              "total_s": sum(phase.seconds.values()),
                              "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slices", default=",".join(SLICES))
    ap.add_argument("--max-copies", default="")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    slices = args.slices.split(",")
    if any(s not in SLICES for s in slices):
        ap.error(f"--slices: each of {', '.join(SLICES)}")
    copies = [int(v) for v in args.max_copies.split(",") if v]
    if args.one:
        return run_root(Path(args.roots[0]).resolve(), slices,
                        copies[0] if copies else None)
    rc = 0
    for root in map(str, (Path(r).resolve() for r in args.roots)):
        for extra in ([["--max-copies", str(v)] for v in copies] or [[]]):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 "--slices", args.slices, *extra, root], cwd=root)
            print(f"phase_ab.py: {root} {' '.join(extra)} exit "
                  f"{proc.returncode}", flush=True)
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
