"""Time ``chip_smoke.py``'s phases 20-23, 29 and 30 of one checkout.

    python tools/phase_ab.py ROOT [ROOT ...]

For each ROOT (a checkout of the repo, e.g. one unpacked from ``git
archive`` of a parent commit), in the order given and each in a process of
its own: its ``chip_smoke.py`` builds its kernels, runs what the phases
need from phase 3 (K4 at HVAC-6, whose bound phase 20 reads), then the
three slices, with every gate they hold, and prints one line ``AB {"root":
..., "phase_s": {...}, "card": ...}``. Give the roots as parent, change,
change, parent to compare two versions on one card in turns. Needs one
CUDA card; exits non-zero if a root's run fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def run_root(root: Path) -> int:
    """The phases of ``root``'s ``chip_smoke.py`` in this process."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "tests"))
    import chip_smoke as cs
    import torch

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
    cs.check_k4("hvac6", torch.float32, timings, errs)
    phase = cs.Phases(time.perf_counter())
    cs.slice_e(phase, timings, errs, launches, plain_s, rates, card)
    cs.slice_generic(phase, timings, errs, launches, plain_s, card)
    cs.slice_h(phase, timings, errs, launches, plain_s, rates, card)
    print("AB " + json.dumps({"root": str(root), "phase_s": phase.seconds,
                              "card": card}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    if sys.argv[1] == "--one":
        return run_root(Path(sys.argv[2]).resolve())
    rc = 0
    for root in map(str, (Path(r).resolve() for r in sys.argv[1:])):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", root], cwd=root)
        print(f"phase_ab.py: {root} exit {proc.returncode}", flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
