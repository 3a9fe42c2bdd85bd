#!/usr/bin/env python3
"""Build the PyTorch port's CUDA kernels and drive its main paths on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit. Phases, in order; any failure raises (non-zero exit):

1. device: require CUDA, print the card's name and power limit (the line
   ``nvidia-smi --query-gpu=name,power.limit`` gives), turn TF32 off for
   float32 matmuls;
2. build: compile ``tfmpc_tpu_torch/ops/csrc/*.cu`` with nvcc, one process
   per source, all started together (timed, and nvcc's wall time per
   source); print ptxas's registers and spills per kernel instantiation
   (each lane kernel's per G; K2 and K3 at n = m = 5, 6 and 16; every K5
   and K8 instantiation, every instantiation of the generic form), and
   each lane kernel's and each K2, K3, K5 and K8 launch plan (the generic
   form's at phase 29's shapes) beside the shared bytes the kernel
   computes for it;
3. each kernel against its plain PyTorch version on the card, in float32
   and float64: K1 Riccati backward, K2 line-search costs and K3
   accepted-alpha rollout at the navigation headline shapes (B=4096,
   T=100, n=m=2, A=11); K4 boxQP Riccati backward at HVAC-6 (B=2048,
   T=100, n=m=6, 8 boxQP iterations) and once at reservoir-5 (n=m=5); the
   clipped K2/K3 at HVAC-6 and reservoir-5 shapes, and K2/K3/K5 at the
   block-ragged batches reservoir-5 B=1023 (T=100) and HVAC-16 B=513
   (T=50) and K8 at the headline's env at B=1023 (T=50), after checking
   that their plans leave the last block part-full. K1 and K4 get lanes
   forced indefinite (fail masks must be identical). Timed (the lane
   kernels K1, K4, K6a, K6b and the rollout kernels K2, K3, K5, K8 as
   device times of CUDA graph replays: an eager loop of their launches
   measures the host's Python launch path at the headline's shapes); K4 at
   HVAC-6 with 1, 2, 4 and 8 lanes a scenario, each held to K4's float32
   gate, timed in turns;
4. the navigation headline solve (slice A): ``solve_batch``, T=100,
   B=4096, f32, ``ILQRConfig(atol=1e-4, max_iterations=50,
   use_pallas=True)``; launch counters prove K1 and AUTO's line search (K5
   on the emit-trajectories layout) ran and no plain version did; controls
   of 4 scenarios within 1e-4 of the float64 NumPy oracle
   (``tests/oracles.py``); the same solve on the two-kernel layout (K1,
   K2, K3) has the identical converged mask and every lane's cost within
   1e-5 relative;
5. the HVAC-6 solve (slice B's main path): ``load_env("configs/hvac.json")``,
   T=100, B=2048, f32, ``ILQRConfig(atol=1e-3, max_iterations=30,
   boxqp=True, use_pallas=True)``, x0 ~ U(8, 18) from seed 0; counters
   prove K4 and K5 ran, K1 did not and no plain version did; >= 99%
   converged; the plain path (``use_pallas=False``) reaches the same
   converged mask on >= 99% of lanes and the same mean cost within 1e-4;
   the two-kernel layout (K4, K2, K3) agrees as in phase 4;
6. constrained accuracy: HVAC-3, x0 = (8, 12, 16), T=100, f64, through the
   kernels, against the float64 boxQP oracle: cost relative deviation
   < 1e-5 and KKT residual < 5e-3 in the fp64 model;
7. reservoir-5 (T=100, B=2048, x0 ~ U(20, 95)) and bounded navigation
   (``configs/navigation_bounded.json``, T=50, B=256) with boxqp=True (K4 at
   n=m=2) and
   boxqp=False (K1 with the clipped K2/K3): counters, converged fractions,
   and agreement with the plain path;
8. solves/s of the navigation, HVAC-6 and reservoir-5 solves with the
   kernels (median of 3 windows after a warm-up) and of one plain solve
   each; a ``torch.profiler`` trace of one HVAC-6 solve: host time per
   ``ilqr.*`` range and the device's busy share;
9. slice C (long horizons), the reservoir-5 T=500 solve (suite config 4):
   ``load_env("configs/reservoir.json")``, T=500, B=1024, f32,
   ``ILQRConfig(atol=1e-3, max_iterations=30, boxqp=True, use_pallas=True,
   linesearch_emit_trajectories=True)``, x0 ~ U(20, 95) from seed 0;
   counters prove K4 and K5 ran and nothing else; >= 99% converged; the
   same solve on the two-kernel layout (K4, K2, K3) has the identical
   converged mask and every lane's cost within 1e-5 relative;
10. long-horizon accuracy: reservoir-5 from x0 = (95, 80, 60, 40, 20),
    T=500, f32, through K4 and K5 to atol=1e-8, against the float64 boxQP
    oracle: cost relative deviation < 1e-5 and KKT residual < 2e-2 in the
    fp64 model;
11. the parallel backward: the same x0 with ``parallel_backward=True``
    converges within 1e-4 relative of the sequential solve's cost;
    ``backward_parallel`` against ``lqr.backward`` in f64 at T=500 (1e-8);
    ms per solve of suite config 4's three latency variants (the plain
    sequential one at T=100);
12. exact LQR (suite config 1): linear navigation, T=100, f64 on the card,
    against the NumPy Riccati oracle (1e-9); solves/s single and batched;
13. the emit A/B: solves/s with ``linesearch_emit_trajectories`` True and
    False, in turns, at HVAC-6 T=100 (3 windows each): the end-to-end
    side of AUTO's rule (``ilqr_batched._resolve_emit_traj``, decided on
    device times by ``tools/kernel_versions.py rollout``);
14. none: the trace of the reservoir-5 T=500 solve (2 million events,
    68-84 s on one H100) left the script to keep it inside its time limit
    with phase 30 (its last figures are PERF.md's);
15. slice D (full DDP): K6a at the navigation headline's shapes and K6b at
    reservoir-5 and HVAC-6 (B=2048), on the envs' dynamics Hessians (five
    lanes forced indefinite) and on synthetic ones (f_uu != 0) at n = m = 2
    and 6, against their plain versions: identical ok masks and the ok
    lanes within tolerance in float64, against the float64 plain version in
    float32; K6a's gains differ from K1's; K1 at n = m = 5; K4 and K6b at
    HVAC-6 B=2047 and K1 and K6a at the headline's B=4095, T=20
    (block-ragged under their plans, which is checked first), five lanes
    forced indefinite, under the same gates; K6a at the headline with 1,
    2, 4 and 8 lanes a scenario, timed in turns;
16. D1, suite config 4c: the reservoir-5 solve of phase 7 with
    ``ddp=True``; counters prove K6b/K5 ran and nothing else; >= 99%
    converged; agreement with the plain path; its mean iterations and cost
    printed beside phase 7's iLQR solve;
17. D2, the navigation headline with ``ddp=True``: counters prove K6a/K5;
    agreement with the plain path; DDP controls through the kernels within
    1e-4 of the fp64 oracle at the JAX release claim's case (x0 = 0, f32)
    and at D2's first 4 scenarios in f64 (``ddp_oracle_checks``);
18. HVAC-3 f64 through K6b against the fp64 boxQP oracle (cost < 1e-5);
19. solves/s of D1 and D2, and ``torch.profiler`` traces of both;
20. slice E (mid dims): K7, both variants, against its plain versions at
    E1's shapes (HVAC-16, B=512, T=50) and E2's (the 12-room ring, B=1024,
    T=100) and on synthetic inputs at (14, 13), (24, 24), (32, 32),
    (48, 48), (40, 33), (7, 9) and (1, 1) (B=128, T=6, box +-0.4, 4 boxQP
    iterations) and at block-ragged batches of HVAC-12 (B=1023) and HVAC-16
    (B=513), T=20, five lanes forced indefinite each: identical ok masks and
    the ok lanes within tolerance in float64, against the float64 plain
    version in float32; K7 timed at each of those shapes; K7-boxQP with
    1, 2 and 4 warps a scenario at E1's shape and at (24, 24), (32, 32),
    (48, 48) (the launch plan's table); the clipped K2/K3 at E1's and
    E2's shapes; K7
    against K4 on phase 3's HVAC-6 inputs (the lane/mid boundary: both
    times); P1 against its plain version at d in {16, 24, 32, 48},
    B=1024, its device time beside ``torch.bmm``'s (CUDA graph replays,
    in turns), every instantiated plan timed, and the probe's chain of
    dependent contractions. The build phase prints each K7 plan beside
    the kernel's own shared-memory sum;
21. E1, suite config 3b: ``load_env("configs/hvac16.json")``, T=50,
    B=512, f32, ``ILQRConfig(atol=1e-2, max_iterations=20, boxqp=True,
    use_pallas=True)``, x0 ~ U(8, 18) from seed 0; counters prove
    K7-boxQP/K5 ran and nothing else; >= 0.98 converged and 0 failed
    (the JAX release gate); agreement with the plain path and with the
    two-kernel layout (K7-boxQP, K2, K3) as in phase 4; the same solve
    clip-only runs K7's iLQR variant/K5;
22. E2, suite config 3c: the 12-room ring, T=100, B=1024,
    ``ILQRConfig(atol=1e-3, max_iterations=30, boxqp=True,
    use_pallas=True)``: K7-boxQP/K5 only, >= 0.99 converged;
23. solves/s of E1 and E2 and a ``torch.profiler`` trace of E1;
24. slice F (the fused iteration): K8, the materialize rollout that also
    writes the linearization, against its plain version (X, U, J and the
    seven blocks within ``TOL``) and against K3 on the same inputs (bit
    for bit), in float32 and float64, at the navigation headline's shapes,
    bounded navigation's (``configs/navigation_bounded.json``, B=256,
    T=50) and G3's (two zones, B=1024, T=20), lane 0 on the zone center;
    timed at each;
25. G1, the headline with ``fuse_derivatives=True``: counters prove K1, K2
    and K8 ran and nothing else, and one derivatives pass per solve;
    controls of 4 scenarios within 1e-4 of the float64 oracle; agreement
    with phase 4's split-kernel solve;
26. G2, bounded navigation (T=50, B=256) with ``boxqp=True`` and
    ``fuse_derivatives=True``: K4, K2 and K8 only; agreement with the
    split-kernel solve;
27. G3, the MPC fleet: ``configs/navigation.json`` (two zones), the JAX
    CLI's ``mpc`` defaults (50 steps, plan horizon 20, atol 1e-4, 15
    iterations a re-plan), x0 + N(0, 1) from ``default_rng(0)``, B=1024,
    f32, fused: K1, K2 and K8 only; realized total costs within 1e-4
    relative of the split-kernel MPC on >= 99% of lanes, and of the plain
    MPC on its first 64 x0 for 10 steps; then solves/s of G1 and the split
    headline and control steps/s of G3 fused and split, in turns, and a
    ``torch.profiler`` trace of one G1 solve;
28. slice G, the user surface: the command line in this process
    (``cli.main``), every launch counter zeroed just before each command:
    ``ilqr`` on ``configs/navigation.json`` with 1024 samples (K1, K5),
    held against its ``--no-pallas`` run (the same converged mask on >=
    99% of lanes, mean cost within 1e-4); ``ilqr`` on ``configs/hvac.json``
    with 256 samples, T=50 and ``--logdir`` (K4, K5; 256 CSVs);
    ``ilqr`` on ``configs/hvac16.json`` with ``--ddp``, 128 samples, T=20,
    10 iterations (the plain DDP backward, counted, and K5; no Riccati
    kernel), against ``--no-pallas``; ``mpc`` on the navigation fleet of
    256 for 10 steps (K1, K5), realized costs within 1e-4 of the
    ``--no-pallas`` fleet on >= 99% of lanes; ``lqr --num-samples 8``; one
    subprocess ``python -m tfmpc_tpu_torch ilqr --env
    configs/reservoir.json --num-samples 256 -T 50``; a two-process gloo
    group, both ranks on this card, each solving 128 of 256 navigation
    scenarios through ``mesh.solve_ilqr_sharded`` (K1, K5 counted in each
    rank): every lane equal to the one-process solve's and ``summarize``
    within 1e-12; and ``-v ilqr`` on the navigation config, the B=1 trace
    through the kernels;
29. the generic form of K2, K3 and K5 (``csrc/rollout_generic.cuh``,
    every 1 <= n, m <= 48 no unrolled instantiation covers): each kind
    against its plain version in float32 and float64 (phase 3's
    tolerances, identical fail masks in float64, K5 against K2 and K3 bit
    for bit) and timed, at each path's shape below and at a rectangular
    (24, 6) linear system (B=1024, T=100); then five f32 ``solve_batch``
    paths on AUTO, counted (the routed Riccati kernel, K7 at these dims,
    and the generic rollouts only), each against its ``use_pallas=False``
    run (the same converged mask on >= 99% of lanes, mean cost within
    1e-4) and on the other line-search layout (same mask, costs within
    1e-5): the double integrator (n=2, m=1, B=4096, T=100; its controls
    also within 1e-4 of the exact LQR in float64, ``solvers/lqr.py``),
    reservoir-4 with boxQP (B=1024, T=100), navigation in four dims (one
    zone, B=4096, T=100), the 24-room HVAC ring with boxQP (E1's config,
    B=512, T=50) and a random stable linear system at (48, 48) (B=512,
    T=50); and the generic form beside the unrolled kernel, in turns, at
    HVAC-6 and E1's shape (the price of generality);
30. full DDP and K8 at every dim up to 12: K7's full-DDP variants (both,
    ``csrc/riccati_mid_ddp.cu``) against their plain versions (K6a's and
    K6b's) on the dynamics Hessians of reservoir-4, the 12-room ring,
    navigation in 12 dims and the double integrator and on synthetic ones
    at (4, 4), (12, 12), (7, 3) and (2, 1), at the block-ragged B=401,
    T=6, five lanes forced indefinite each (phase 15's
    gates: identical f64 ok masks); the generic K8 (kind kDerivs,
    ``csrc/rollout_generic_derivs.cu``) against its plain version and the
    generic K3 (bit for bit) at navigation in 1, 4, 7 and 12 dims, one
    and two zones (>= 5% of the steps inside both), B=401, T=20; all
    timed at their paths' shapes, K7 also in the fused iteration's layout
    round trip (``riccati.riccati_backward_lanes``, bit for bit K7's own
    wrapper); then six f32 solves, counted (launches of the kernels each
    should run, no plain version): D3 reservoir-4 with full DDP and boxQP
    (B=2048, T=100), D5 navigation in 12 dims with full DDP (B=1024,
    T=50; its first 4 scenarios also in f64 against the fp64 NumPy
    oracle, 1e-4) and the double integrator with full DDP (B=4096, T=100;
    its controls within 1e-4 of the exact LQR), each against its plain
    path; D4 the 12-room ring with full DDP and boxQP (B=512, T=50, E1's
    release gate: its plain solve takes minutes, ``NO_PLAIN_CHECK``); G4
    navigation in 4 dims fused (B=4096, T=100) and G5 navigation in 12
    dims in the box +-1, fused with boxQP (B=1024, T=50), each against
    its split-kernel solve (one derivatives pass a fused solve); the
    solves/s of each.

K5 (the emit-trajectories line search, AUTO's layout) is checked with
the other kernels in phase 3 at the shapes of the paths that run it
(reservoir-5 T=500, the navigation headline, HVAC-6 and E1): against its
plain version and against K2 and K3 bit for bit (its J equal to K2's,
its trajectory at each lane's alpha equal to K3's). Each phase prints its
seconds. The second-to-last line is a JSON object
describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

B, T, N, A = 4096, 100, 2, 11
GOAL = [8.0, -5.0]
ZONES = {"center": [[3.0, -2.0]], "decay": [2.0]}
HEADLINE = dict(atol=1e-4, max_iterations=50, use_pallas=True)
# slice B: suite config 3 (HVAC-6) and 4b (reservoir-5), T=100, B=2048
B_BOX = 2048
# bounded navigation, compared with the plain path: B=256 at T=50 (T=100
# until PR 4; its plain boxQP solve alone took ~55 s there)
B_NAV_BOUNDED, T_NAV_BOUNDED = 256, 50
BOXQP = dict(atol=1e-3, max_iterations=30, boxqp=True, use_pallas=True)
# mean total cost and converged fraction the JAX package recorded for the
# HVAC-6 solve with this config and seed (docs/sweeps/r5_emit_traj.md:65)
JAX_HVAC6_MEAN_COST, JAX_HVAC6_CONVERGED = 9813.396, 1.0
# Tolerances of kernel vs plain version, |err| <= atol + rtol * |plain|.
# float32: the two sum in different orders (the kernels unroll and fuse
# multiply-adds; the plain versions call batched matmul and LAPACK-style
# Cholesky), and a T=100 serial chain compounds the rounding.
# float64: the same chain at double precision.
TOL = {"float32": (1e-3, 1e-3), "float64": (1e-9, 1e-9)}
# K4 (boxQP) gates; fail masks must be identical in both dtypes.
# float64: kernel vs plain version, >= 99.5% of lanes within 1e-8 +
# 1e-8 |plain| and every lane within 1e-5 + 1e-5 |plain|. The line search's
# 1e-12 margin is below the rounding of objectives of ~1e4 (one ulp is
# ~2e-12), so a near-tie can pick another candidate of equal objective; in
# a flat direction of the QP that moves k by up to ~1e-6 (on an H100: 4 of
# 2043 HVAC-6 lanes, k within 7.9e-7; every other lane within 1e-8 +
# 1e-8 |plain|).
# float32: the boxQP backward is ill-conditioned in float32 on these
# inputs: over T=100 the plain version ITSELF moves k by more than
# 1e-3 + 1e-3 |k| from its own float64 result on ~1/5 of the HVAC-6 lanes
# (on an H100; this phase prints the share), and its projected
# line search (first candidate with obj < obj_now - 1e-12) flips marginal
# candidates on rounding differences (the JAX package's test accepts such
# flips, tests/test_riccati_pallas.py:204-210). So in float32 both the
# kernel and the plain version are held against the plain version in
# float64 on the same inputs, and the kernel must be as accurate: its share
# of lanes within 1e-3 + 1e-3 |ref| at least the plain version's, less one
# percentage point.
K4_F64_TOL, K4_F64_SHARE, K4_F64_ALL_TOL = (1e-8, 1e-8), 0.995, (1e-5, 1e-5)
K4_F32_TOL = (1e-3, 1e-3)
K4_F32_SHARE_SLACK = 0.01
# slice C: suite config 4, reservoir-5 at T=500, B=1024
T_LONG, B_LONG = 500, 1024
LONG = dict(atol=1e-3, max_iterations=30, boxqp=True, use_pallas=True)
X0_ACCURACY = [95.0, 80.0, 60.0, 40.0, 20.0]
# K5 against K2 and K3, and K8 against K3: the same arithmetic in other
# kernels (the same policy row, env rows and double sum, in the same
# order), so their outputs must be bitwise equal in both dtypes; the
# largest |got - want| / (|want| + 1) is printed beside.
# K5's shapes besides phase 3's reservoir-5 T=500 and navigation cases: the
# HVAC-6 (B=2048, T=100) and E1 (HVAC-16, B=512, T=50) paths', where AUTO
# now runs it
K5_PATH_SHAPES = (("hvac6", B_BOX, T), ("hvac16", 512, 50))
# K2 and K3 at block-ragged batches under their plans (the last block
# part-full, the copies element by element): reservoir-5 B=1023 at T=100
# and HVAC-16 B=513 at T=50
ROLLOUT_RAGGED = (("reservoir5", 1023, 100), ("hvac16", 513, 50))
# K5 against its plain version: float64 as TOL. float32: over a T=500 chain
# the two may drift apart on a lane whose rollout is unstable (rounding
# grows step by step), so both are held against the plain version in
# float64 on the same inputs, and the kernel's share of lanes within
# 1e-3 + 1e-3 |ref| must be at least the plain version's, less one
# percentage point (as K4's float32 gate).
K5_F32_TOL = (1e-3, 1e-3)
# slice D: suite config 4c (reservoir-5 full DDP, B=2048, T=100) and the
# navigation headline with DDP
DDP_BOXQP = dict(BOXQP, ddp=True)
DDP_HEADLINE = dict(HEADLINE, ddp=True)
# Scale of the synthetic Hessians of the K6 checks (``ddp_inputs``): with
# the plain versions in float64 on the CPU, at these scales 99.6% (K6a) and
# 78% (K6b) of the navigation inputs' lanes pass the PD probe, and 90% and
# 91% of HVAC-6's, so the ok masks and the ok lanes are both compared.
DDP_SYNTHETIC_SCALE = {"synthetic2": 3e-3, "synthetic6": 2e-5}
# slice E: suite config 3b (HVAC-16, configs/hvac16.json: T=50, B=512) and
# 3c (the 12-room HVAC ring: T=100, B=1024), benchmarks/suite.py:140-197
B_E1, T_E1 = 512, 50
B_E2, T_E2 = 1024, 100
E1_CONFIG = dict(atol=1e-2, max_iterations=20, boxqp=True, use_pallas=True)
E2_CONFIG = dict(atol=1e-3, max_iterations=30, boxqp=True, use_pallas=True)
# the JAX release gate of E1 (benchmarks/release_check.py:528-550): its
# unconverged tail is lanes still iterating at the cap of 20, not mu_max
# failures (PARITY.md:200-209), so >= 0.98 converged and 0 failed
E1_MIN_CONVERGED = 0.98
# E2's: the JAX suite records 1.0 (docs/sweeps/r5.md:36)
E2_MIN_CONVERGED = 0.99
# K7 on synthetic inputs: the JAX release gate's cases
# (release_check.py:342-388: B=128, T=6, box +-0.4, 4 boxQP iterations),
# one rectangular pair of tests/test_riccati_mid.py, m > 32 with n != m
# (a lane holds two rows), a small rectangular pair and the smallest dims
MID_SYNTHETIC_DIMS = ((14, 13), (24, 24), (32, 32), (48, 48), (40, 33),
                      (7, 9), (1, 1))
# K7 at block-ragged batches, where a block's tail teams return while its
# other teams run on: HVAC-12 at B=1023 (teams of one warp, four a block,
# three in the last) and HVAC-16 at B=513 (teams of two warps on named
# barriers, four a block, one in the last); T_RAGGED steps (the
# scenario-to-team map does not depend on T)
MID_RAGGED = (("hvac12", 1023), ("hvac16", 513))
T_RAGGED = 20
# the lane kernels (K1/K4/K6a/K6b) at block-ragged batches, where the last
# block's tail groups idle while its other groups run: HVAC-6 at B=2047
# (K4, K6b) and the headline at B=4095 (K1, K6a), T_RAGGED steps, five lanes
# forced indefinite each
LANE_RAGGED = (("hvac6", 2047), ("navigation", 4095))
# the lanes a scenario the G sweep times (K4 at HVAC-6, K6a at the
# headline; ops/riccati.py LANE_PLANS is set from such sweeps)
LANE_SWEEP_G = (1, 2, 4, 8)
# K7's warps per scenario, timed at these dims (the plan's MID_WARPS
# table is set from them)
MID_WARPS_SWEEP = ((16, 16), (24, 24), (32, 32), (48, 48))
# P1: the JAX probe's dims and batch (benchmarks/mxu_probe.py), and the
# length of its chain of dependent contractions
P1_DIMS, P1_B, P1_CHAIN = (16, 24, 32, 48), 1024, 128
# slice F: G3, the MPC fleet: configs/navigation.json (two zones) with the
# JAX CLI's mpc defaults (tfmpc_tpu/cli.py:402-409) and its fleet draw
# x0 + N(0, 1) from default_rng(seed) (cli.py:466-468), B=1024, f32; the
# plain MPC it is held against runs its first 64 x0 for 10 steps
B_G3, G3_STEPS, G3_PLAN_HORIZON, G3_SEED = 1024, 50, 20, 0
G3_CONFIG = dict(atol=1e-4, max_iterations=15, use_pallas=True,
                 fuse_derivatives=True)
G3_PLAIN_B, G3_PLAIN_STEPS = 64, 10
# G3's actions against the split and the plain MPC: max-abs difference.
# The realized cost is |x - goal|^2 on the pre-step state and the fleet
# reaches the goal in about one step, so the cost alone would pass a
# step-1 position error up to ~0.09; the actions are gated as well.
G3_ACTIONS_ATOL = 1e-4
# K8 at G3's shape: the least share of (lane, step) points inside both
# zones (g_z < 0.99 for each), so the multi-zone linearization is exercised
K8_TWO_ZONE_SHARE = 0.05
# K8 at a block-ragged batch of the headline's env (B, T); the n-dim
# navigation cases of K8's plan sweep (tools/kernel_versions.py)
K8_RAGGED = (1023, 50)
K8_DIM_CASES = {"nav3": 3, "nav5": 5, "nav6": 6}
# phase 29: the generic form of K2, K3 and K5 (csrc/rollout_generic.cuh)
# on the paths it opens, each an f32 solve_batch on AUTO held against its
# plain path and its other line-search layout. The double integrator
# (tests/test_torch_linear.py DOUBLE_INTEGRATOR, n=2, m=1: the JAX kernels'
# rectangular case) from x0 ~ U(-3, 3); reservoir-4 (configs/reservoir.json
# with n_reservoirs=4, x0 its first four entries plus N(0, 1), the CLI's
# ``--num-samples`` draw); navigation in four dims (one zone, the
# headline's config); the 24-room HVAC ring (``hvac_ring``, E1's config);
# a random stable linear system at (48, 48), the JAX kernels' ceiling.
# label -> (B, T, config)
GENERIC_PATHS = {
    "double_integrator": (4096, 100, HEADLINE),
    "reservoir4": (1024, 100, BOXQP),
    "nav4": (4096, 100, HEADLINE),
    "hvac24": (512, 50, E1_CONFIG),
    "linear48": (512, 50, HEADLINE),
}
# the kernels alone, besides the paths' shapes: a rectangular (24, 6)
# linear system
GENERIC_KERNEL_CASES = {**{k: v[:2] for k, v in GENERIC_PATHS.items()},
                        "linear24x6": (1024, 100)}
DOUBLE_INTEGRATOR = dict(A=[[1.0, 0.1], [0.0, 1.0]], B=[[0.005], [0.1]],
                         Q=[[1.0, 0.0], [0.0, 0.1]], R=[[0.01]])
GOAL4 = [8.0, -5.0, 4.0, -2.0]
ZONES4 = {"center": [[3.0, -2.0, 1.0, 0.0]], "decay": [2.0]}
# the double integrator's controls against the exact LQR in float64
# (solvers/lqr.py) on its first scenarios, through the kernels in f64
DI_LQR_ATOL, DI_LQR_B = 1e-4, 64
WINDOW_S = 1.0
# the windows of a solves/s median (5 until PR 13; 3 keep the script
# inside its time limit with phase 30)
RATE_WINDOWS = 3
# H100 SXM peaks (NVIDIA data sheet): HBM
# bytes/s, and FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}


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


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls captured in
    one CUDA graph and replayed (after a warm-up call and a warm-up
    replay): the time of the launches themselves, without the ~10-20 us of
    host work a Python call adds, which an eager loop of microsecond
    kernels would measure instead."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def compare(name, got, want, dtype_name, mask=None, tol=None):
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
    atol, rtol = tol or TOL[dtype_name]
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = float(err.max()) if err.numel() else 0.0
    print(f"  {name} [{dtype_name}]: max_abs_err={max_err:.3e} "
          f"(tol {atol:g} + {rtol:g}*|plain|)")
    if bool(bad.any()):
        raise AssertionError(f"{name} [{dtype_name}]: {int(bad.sum())} "
                             "entries outside tolerance")
    return max_err


# -- work counts for the bounds (each input read once, each output written
#    once; a multiply or an add is one operation, a sqrt, exp, sin or
#    divide is one) ---------------------------------------------------------

def riccati_step_flops(n: int, m: int) -> int:
    """Operations of one K1/K4 step outside the gain solve: Q blocks, the
    PD probe of QuuR, dV1/dV2 and the value update (riccati_step.cuh)."""
    q = n + 2 * n * n + 2 * m * n              # VR, Qx, Qu
    q += 4 * n * n * n + 4 * n * n * m         # W, WRx, Wu, WRu
    q += 2 * n * n * n + 4 * m * m * n + 4 * m * n * n  # Qxx, Quu(R), Qux(R)
    chol = m * m * m // 3 * 2 + 3 * m * m
    dv = 2 * m + 3 * m * m + 2
    upd = 2 * m * m + 2 * m * m * n + (n * (n + 1) // 2 + n) * (6 * m + 3)
    return q + chol + dv + upd


def k1_work(Bn, Tn, n, m, itemsize):
    per_step_in = 2 * n * n + n * m + n + m + m * m + m * n
    bytes_ = itemsize * (Bn * Tn * (per_step_in + m * n + m)
                         + Bn * (1 + n * n + n + 3))
    solves = (n + 1) * 2 * m * m
    return bytes_, Bn * Tn * (riccati_step_flops(n, m) + solves)


def k4_work(Bn, Tn, n, m, itemsize, newton_iterations):
    """K4's bytes and operations; ``newton_iterations`` is the number of
    boxQP Newton iterations this run's data needed over all lanes and steps
    (from the plain version), each counted with all 8 line-search
    candidates."""
    per_step_in = 2 * n * n + n * m + n + m + m * m + m * n + m
    bytes_ = itemsize * (Bn * Tn * (per_step_in + m * n + m)
                         + Bn * (1 + n * n + n + 3) + 2 * m)
    obj = 2 * m * m + 3 * m + 2
    newton = (3 * m * m + 4 * m) + m * m + (m * m * m // 3 * 2 + 3 * m * m) \
        + 2 * m * m + obj + 8 * (3 * m + obj)
    fixed = riccati_step_flops(n, m) + 2 * m + 2 * m * m \
        + (m * m * m // 3 * 2 + 3 * m * m) + n * 2 * m * m
    return bytes_, Bn * Tn * fixed + newton_iterations * newton


def ddp_extra(Bn, Tn, n, m, itemsize):
    """Bytes and operations the full-DDP terms add to K1's or K4's work:
    the three Hessians read once, and per step the v-contractions (a
    multiply and an add per Hessian entry), their adds into Qxx, Qux, QuxR,
    Quu and QuuR, and mu on QuuR's diagonal (riccati_step.cuh
    ``ddp_terms``)."""
    entries = n * (n * n + m * n + m * m)
    flops = 2 * entries + n * n + 2 * m * n + 2 * m * m + m
    return itemsize * Bn * Tn * entries, Bn * Tn * flops


def k6a_work(Bn, Tn, n, m, itemsize):
    return tuple(a + b for a, b in zip(k1_work(Bn, Tn, n, m, itemsize),
                                       ddp_extra(Bn, Tn, n, m, itemsize)))


def k6b_work(Bn, Tn, n, m, itemsize, newton_iterations):
    return tuple(a + b for a, b in zip(
        k4_work(Bn, Tn, n, m, itemsize, newton_iterations),
        ddp_extra(Bn, Tn, n, m, itemsize)))


def env_step_flops(env_name: str, n: int, zones: int = 1,
                   m: int | None = None) -> int:
    if env_name == "navigation":
        return 3 * n + zones * (3 * n + 8) + 2 * n
    if env_name == "hvac":
        return (n + 2) + 8 * n + 2 + n * (9 + 2 * n + 2)
    if env_name == "linear":
        # the rows A x + B u + c, then the cost at its least: Q x, N u and
        # R u, each then a dot product, and q.x, r.u
        m = n if m is None else m
        return 2 * n * (n + m) + n + 2 * n * n + 2 * n * m + 2 * m * m \
            + 6 * n + 4 * m + 6
    return 10 * n + n * (7 + 2 * n)            # reservoir


def rollout_work(Bn, Tn, n, m, itemsize, env_name, n_params, lanes, bounded,
                 writes_traj):
    """K2 (``lanes`` = A rollouts per scenario, writes J [A, B]) or K3
    (``lanes`` = 1, writes X, U and J)."""
    per_step_in = n + m + m * n + m
    out = Bn * lanes if not writes_traj else Bn * (Tn * (n + m) + 1)
    bytes_ = itemsize * (Bn * Tn * per_step_in + out + n_params
                         + (2 * m if bounded else 0)
                         + (Bn if writes_traj else 0))
    return bytes_, Bn * lanes * Tn * rollout_step_flops(n, m, env_name,
                                                        bounded)


def rollout_step_flops(n, m, env_name, bounded):
    return n + m * (2 + 2 * n) + (2 * m if bounded else 0) \
        + env_step_flops(env_name, n, m=m) + 1


def traj_work(Bn, Tn, n, m, itemsize, env_name, n_params, A, bounded):
    """K5: A rollouts per scenario, writing J [A, B] and every alpha's
    trajectory, X [T, A*n, B] and U [T, A*m, B]."""
    bytes_ = itemsize * (Bn * Tn * (n + m + m * n + m)
                         + Bn * A * (Tn * (n + m) + 1) + n_params
                         + (2 * m if bounded else 0))
    return bytes_, Bn * A * Tn * rollout_step_flops(n, m, env_name, bounded)


def bound(bytes_, flops, dtype_name="float32"):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth
    and the operations over the non-tensor peak."""
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    f_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


# -- inputs ------------------------------------------------------------------

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


def bounded_env(name, dtype):
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.models.registry import load_env

    if name == "hvac12":
        # suite config 3c's ring (benchmarks/suite.py:168-183)
        R = 12
        adj = [[1 if abs(i - j) in (1, R - 1) else 0 for j in range(R)]
               for i in range(R)]
        return make_hvac(adj, is_out=[1 if i % 4 == 0 else 0
                                      for i in range(R)],
                         is_hall=[1 if i % 4 == 2 else 0 for i in range(R)],
                         dtype=dtype, device="cuda")
    path = {"hvac6": "configs/hvac.json",
            "hvac16": "configs/hvac16.json",
            "reservoir5": "configs/reservoir.json",
            "nav_bounded": "configs/navigation_bounded.json"}[name]
    return load_env(ROOT / path, dtype=dtype, device="cuda")


def hvac_ring(R, dtype, device="cuda"):
    """Suite config 3c's ring (benchmarks/suite.py:168-183) of R rooms:
    each room joined to its two neighbours, every fourth room outside and
    every fourth (offset 2) on the hall."""
    from tfmpc_tpu_torch.models.hvac import make_hvac

    adj = [[1 if abs(i - j) in (1, R - 1) else 0 for j in range(R)]
           for i in range(R)]
    return make_hvac(adj, is_out=[1 if i % 4 == 0 else 0 for i in range(R)],
                     is_hall=[1 if i % 4 == 2 else 0 for i in range(R)],
                     dtype=dtype, device=device)


def stable_linear(n, m, seed, dtype, device="cuda"):
    """A random linear system at (n, m) with every cost term: A = V diag(s)
    V^T (V orthogonal, s ~ U(0.9, 0.99), so stable), B ~ 0.1 N(0, 1), Q and
    Q_f symmetric positive definite, R = I, small N, q, r, c, q_f; from
    ``default_rng(seed)``."""
    import numpy as np

    from tfmpc_tpu_torch.models.linear import make_linear_system

    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    L = rng.standard_normal((n, n)) / np.sqrt(n)
    return make_linear_system(
        (V * rng.uniform(0.9, 0.99, n)) @ V.T, 0.1 * rng.standard_normal(
            (n, m)), c=0.01 * rng.standard_normal(n),
        Q=0.5 * (L @ L.T) + 0.5 * np.eye(n), R=np.eye(m),
        N=0.01 * rng.standard_normal((n, m)), q=0.1 * rng.standard_normal(n),
        r=0.1 * rng.standard_normal(m), Q_f=np.eye(n),
        q_f=0.1 * rng.standard_normal(n), dtype=dtype, device=device)


def generic_env(case, dtype, device="cuda"):
    """The env of a ``GENERIC_KERNEL_CASES`` case."""
    import json

    from tfmpc_tpu_torch.models.linear import make_linear_system
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.registry import make_env

    if case == "double_integrator":
        kw = dict(DOUBLE_INTEGRATOR)
        return make_linear_system(kw.pop("A"), kw.pop("B"), **kw, dtype=dtype,
                                  device=device)
    if case.startswith("reservoir"):  # reservoir<k>: k reservoirs
        cfg = json.loads((ROOT / "configs/reservoir.json").read_text())
        cfg.update(n_reservoirs=int(case[len("reservoir"):]))
        cfg.pop("x0")
        return make_env(cfg, dtype=dtype, device=device)
    if case == "nav4":
        return make_navigation(GOAL4, ZONES4, dtype=dtype, device=device)
    if case == "hvac24":
        return hvac_ring(24, dtype, device)
    if case == "linear48":
        return stable_linear(48, 48, 48, dtype, device)
    if case == "linear24x6":
        return stable_linear(24, 6, 24, dtype, device)
    raise ValueError(case)


def generic_x0(case, Bn, dtype, device="cuda"):
    """The solve's initial states of a ``GENERIC_KERNEL_CASES`` case [Bn,
    n], from ``default_rng(0)``."""
    import json

    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    n = generic_env(case, dtype, "cpu").state_size
    if case == "reservoir4":
        x0 = np.asarray(json.loads((ROOT / "configs/reservoir.json")
                                   .read_text())["x0"][:4])
        x0 = x0[None] + rng.normal(size=(Bn, 4))
    else:
        lohi = {"double_integrator": (-3.0, 3.0), "nav4": (-10.0, 10.0),
                "hvac24": (8.0, 18.0)}.get(
            case, (20.0, 95.0) if case.startswith("reservoir")
            else (-1.0, 1.0))
        x0 = rng.uniform(*lohi, (Bn, n))
    return torch.as_tensor(x0.astype("float32"), dtype=dtype, device=device)


def generic_inputs(case, dtype, Bn, Tn, device="cuda"):
    """A random nominal of a ``GENERIC_KERNEL_CASES`` case at (Bn, Tn) (its
    solve's x0, controls ~ U(0, 4) clipped where bounded, else 0.1 N(0, 1))
    and a small random feedback policy (K ~ 0.05 N(0, 1) / sqrt(n), k ~
    N(0, 1), 2 N(0, 1) where bounded so that many controls reach the box),
    from a numpy seed: (env, X, U, policy)."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Policy

    env = generic_env(case, dtype, device)
    n, m = env.state_size, env.action_size
    rng = np.random.default_rng(12)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    x0 = generic_x0(case, Bn, dtype, device)
    bounded = env.bounds is not None
    U = env.clip(t(rng.uniform(0.0, 4.0, (Bn, Tn, m)))) if bounded \
        else t(0.1 * rng.standard_normal((Bn, Tn, m)))
    X, _ = env.rollout(x0, U)
    policy = Policy(
        K=t(0.05 / np.sqrt(n) * rng.standard_normal((Bn, Tn, m, n))),
        k=t((2.0 if bounded else 1.0) * rng.standard_normal((Bn, Tn, m))))
    return env, X, U, policy


def boxqp_inputs(name, dtype, Bn=B_BOX, Tn=T):
    """A bounded env (``hvac6``, ``reservoir5``, ``hvac16``, ``hvac12``),
    by default at B=2048, T=100: a random clipped nominal (x0 as its solve
    draws it, controls ~ U(0, 4)), its linearization, per-lane mu ~ U(0,
    0.5), and a small random feedback policy, from a numpy seed."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Policy

    env = bounded_env(name, dtype)
    n = env.state_size
    lohi = (8.0, 18.0) if name.startswith("hvac") else (20.0, 95.0)
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    x0 = t(rng.uniform(*lohi, (Bn, n)))
    U = env.clip(t(rng.uniform(0.0, 4.0, (Bn, Tn, n))))
    X, _ = env.rollout(x0, U)
    lin, quad, final = env.analytic_derivatives(X, U)
    mu = t(rng.uniform(0.0, 0.5, Bn))
    policy = Policy(K=t(0.05 * rng.standard_normal((Bn, Tn, n, n))),
                    k=t(2.0 * rng.standard_normal((Bn, Tn, n))))
    return env, X, U, lin, quad, final, mu, policy


# -- phase 3: kernels vs plain versions --------------------------------------

def check_nav_kernels(dtype, timings, errs):
    """K1, K2 and K3 at the navigation headline shapes."""
    import torch

    from tfmpc_tpu_torch.ops import riccati, rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    dn = dname(dtype)
    env, X, U, lin, quad, final, mu, policy = headline_inputs(dtype, "cuda")

    # K1, with a few lanes forced indefinite: l_uu = -100 I and mu = 0 make
    # the regularized Quu negative definite at t = T-1.
    bad = torch.tensor([0, 1, B // 5, B // 2, B - 1], device="cuda")
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
    err = max(
        compare("K1 K", pol_k.K, pol_p.K, dn, ok_k),
        compare("K1 k", pol_k.k, pol_p.k, dn, ok_k),
    )
    compare("K1 dV1", dv1_k, dv1_p, dn, ok_k)
    compare("K1 dV2", dv2_k, dv2_p, dn, ok_k)

    alphas = ILQRConfig().alphas_static()
    J_k = rollout.linesearch_costs(env, X, U, policy, alphas)
    J_p = rollout.linesearch_costs_ref(env, X, U, policy, alphas)
    torch.cuda.synchronize()
    err2 = compare("K2 J", J_k, J_p, dn)

    alpha_vec = torch.as_tensor(alphas, dtype=dtype, device="cuda")[
        torch.arange(B, device="cuda") % A]
    X_k, U_k, Jm_k = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    X_p, U_p, Jm_p = rollout.rollout_alpha_ref(env, X, U, policy, alpha_vec)
    torch.cuda.synchronize()
    err3 = max(compare("K3 X", X_k, X_p, dn), compare("K3 U", U_k, U_p, dn))
    compare("K3 J", Jm_k, Jm_p, dn)

    if dtype != torch.float32:
        return
    errs.update(riccati_backward=err, linesearch_costs=err2,
                rollout_alpha=err3)
    a = riccati._to_kernel_layout(lin, quad, final, mu)
    k1_args = [a[k] for k in riccati.K1_ARGS]
    timings["riccati_backward"] = (
        graph_ms(lambda: riccati.riccati_backward_kernel(*k1_args), 50),
        cuda_ms(lambda: riccati.riccati_backward(lin, quad, final, mu), 50),
        cuda_ms(lambda: riccati.riccati_backward_ref(lin, quad, final, mu),
                5),
        bound(*k1_work(B, T, N, N, 4)),
    )
    ra = rollout.kernel_args(env, X, U, policy)
    n_params = sum(p.numel() for p in ra["params"])
    timings["linesearch_costs"] = (
        graph_ms(lambda: rollout.linesearch_costs_kernel(ra, alphas), 50),
        cuda_ms(lambda: rollout.linesearch_costs(env, X, U, policy, alphas),
                50),
        cuda_ms(lambda: rollout.linesearch_costs_ref(env, X, U, policy,
                                                     alphas), 5),
        bound(*rollout_work(B, T, N, N, 4, "navigation", n_params, A, False,
                            False)),
    )
    timings["rollout_alpha"] = (
        graph_ms(lambda: rollout.rollout_alpha_kernel(ra, alpha_vec), 50),
        cuda_ms(lambda: rollout.rollout_alpha(env, X, U, policy, alpha_vec),
                50),
        cuda_ms(lambda: rollout.rollout_alpha_ref(env, X, U, policy,
                                                  alpha_vec), 5),
        bound(*rollout_work(B, T, N, N, 4, "navigation", n_params, 1, False,
                            True)),
    )


def lane_share(outs, refs, ok, atol, rtol):
    """Share of the ``ok`` lanes whose every output lies within
    ``atol + rtol |ref|`` of ``refs``."""
    import torch

    lane = torch.ones(int(ok.sum()), dtype=torch.bool, device=ok.device)
    for got, ref in zip(outs, refs):
        got, ref = got[ok].to(ref.dtype), ref[ok]
        within = (got - ref).abs() <= atol + rtol * ref.abs()
        lane &= within.reshape(within.shape[0], -1).all(dim=1)
    # an exact count: a float32 mean of all-true lanes can round below 1
    return int(lane.sum()) / max(lane.numel(), 1)


def check_k4(name, dtype, timings=None, errs=None):
    """K4 against its plain version at a bounded env's solve shapes, with
    five lanes forced indefinite (l_uu = -100 I, mu = 0)."""
    import torch

    from tfmpc_tpu_torch.ops import riccati

    dn = dname(dtype)
    env, X, U, lin, quad, final, mu, _ = boxqp_inputs(name, dtype)
    n = env.state_size
    bad = torch.tensor([0, 1, B_BOX // 5, B_BOX // 2, B_BOX - 1],
                       device="cuda")
    luu = quad.l_uu.clone()
    luu[bad] = -100.0 * torch.eye(n, dtype=dtype, device="cuda")
    quad_b = dataclasses.replace(quad, l_uu=luu)
    mu_b = mu.clone()
    mu_b[bad] = 0.0
    args = (lin, quad_b, final, mu_b, env.bounds, U)
    ok_k, pol_k, dv1_k, dv2_k = riccati.riccati_backward_boxqp(*args)
    stats = {}
    ok_p, pol_p, dv1_p, dv2_p = riccati.riccati_backward_boxqp_ref(
        *args, stats=stats)
    torch.cuda.synchronize()
    if not torch.equal(ok_k, ok_p):
        raise AssertionError(f"K4 {name}: fail masks differ from the plain "
                             "version")
    if bool(ok_k[bad].any()):
        raise AssertionError(f"K4 {name}: forced-indefinite lanes not "
                             "flagged")
    print(f"  K4 {name} fail masks identical: {int((~ok_k).sum())} failing "
          f"lanes ({bad.numel()} forced); {stats['newton_iterations']} "
          "boxQP Newton iterations in the plain version")
    outs_k = (pol_k.K, pol_k.k, dv1_k, dv2_k)
    outs_p = (pol_p.K, pol_p.k, dv1_p, dv2_p)
    max_err = 0.0
    for label, got, want in zip(("K", "k", "dV1", "dV2"), outs_k, outs_p):
        got, want = got[ok_k], want[ok_k]
        if not bool(torch.isfinite(got).all() & torch.isfinite(want).all()):
            raise AssertionError(f"K4 {name} {label}: non-finite values")
        e = float((got - want).abs().max())
        print(f"  K4 {name} {label} [{dn}]: max_abs_err vs plain {e:.3e}")
        if label in ("K", "k"):
            max_err = max(max_err, e)
    if dtype == torch.float64:
        share = lane_share(outs_k, outs_p, ok_k, *K4_F64_TOL)
        share_all = lane_share(outs_k, outs_p, ok_k, *K4_F64_ALL_TOL)
        print(f"  K4 {name} [{dn}]: share of lanes within "
              f"{K4_F64_TOL[0]:g} + {K4_F64_TOL[1]:g}*|plain| {share:.6f} "
              f"(gate >= {K4_F64_SHARE}), within {K4_F64_ALL_TOL[0]:g} + "
              f"{K4_F64_ALL_TOL[1]:g}*|plain| {share_all:.6f} (gate 1)")
        if share < K4_F64_SHARE or share_all < 1.0:
            raise AssertionError(f"K4 {name} [{dn}]: lanes outside "
                                 "tolerance")
    else:
        to64 = lambda m: dataclasses.replace(m, **{  # noqa: E731
            f: getattr(m, f).double() for f in m.__dataclass_fields__})
        ref = riccati.riccati_backward_boxqp_ref(
            to64(lin), to64(quad_b), to64(final), mu_b.double(),
            to64(env.bounds), U.double())
        outs_r = (ref[1].K, ref[1].k, ref[2], ref[3])
        ok = ok_k & ref[0]
        share_k = lane_share(outs_k, outs_r, ok, *K4_F32_TOL)
        share_p = lane_share(outs_p, outs_r, ok, *K4_F32_TOL)
        share_kp = lane_share(outs_k, outs_p, ok, *K4_F32_TOL)
        print(f"  K4 {name} [{dn}]: share of lanes within "
              f"{K4_F32_TOL[0]:g} + {K4_F32_TOL[1]:g}*|ref| of the plain "
              f"version in float64: kernel {share_k:.6f}, plain version "
              f"{share_p:.6f} (gate: kernel >= plain - "
              f"{K4_F32_SHARE_SLACK}); kernel vs plain in float32 "
              f"{share_kp:.6f}")
        if share_k < share_p - K4_F32_SHARE_SLACK:
            raise AssertionError(f"K4 {name} [{dn}]: the kernel is less "
                                 "accurate than the plain version")
    if timings is None:
        return
    errs["riccati_backward_boxqp"] = max_err
    a = riccati._to_kernel_layout(lin, quad, final, mu, env.bounds, U)
    k4_args = [a[k] for k in riccati.K4_ARGS]
    stats_main = {}
    riccati.riccati_backward_boxqp_ref(lin, quad, final, mu, env.bounds, U,
                                       stats=stats_main)
    timings["riccati_backward_boxqp"] = (
        graph_ms(lambda: riccati.riccati_backward_boxqp_kernel(*k4_args),
                 20),
        cuda_ms(lambda: riccati.riccati_backward_boxqp(
            lin, quad, final, mu, env.bounds, U), 20),
        cuda_ms(lambda: riccati.riccati_backward_boxqp_ref(
            lin, quad, final, mu, env.bounds, U), 2),
        bound(*k4_work(B_BOX, T, n, n, 4, stats_main["newton_iterations"])),
    )


def check_clipped_rollouts(name, dtype, timings=None, errs=None, Bn=B_BOX,
                           Tn=T, suffix=""):
    """The clipped K2 and K3 against their plain versions at a bounded
    env's solve shapes (the random policy drives many controls into the
    box's faces); with ``timings``, timed under the names
    ``linesearch_costs_clipped`` + ``suffix`` and ``rollout_alpha_clipped``
    + ``suffix``."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    dn = dname(dtype)
    env, X, U, _, _, _, _, policy = boxqp_inputs(name, dtype, Bn, Tn)
    n = env.state_size
    env_name = "hvac" if name.startswith("hvac") else "reservoir"
    alphas = ILQRConfig().alphas_static()
    J_k = rollout.linesearch_costs(env, X, U, policy, alphas)
    J_p = rollout.linesearch_costs_ref(env, X, U, policy, alphas)
    alpha_vec = torch.as_tensor(alphas, dtype=dtype, device="cuda")[
        torch.arange(Bn, device="cuda") % A]
    X_k, U_k, Jm_k = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    X_p, U_p, Jm_p = rollout.rollout_alpha_ref(env, X, U, policy, alpha_vec)
    torch.cuda.synchronize()
    clipped = float(((U_p == env.bounds.low) | (U_p == env.bounds.high))
                    .float().mean())
    print(f"  {name}: {clipped:.3f} of the K3 controls on a face of the box")
    e2 = compare(f"K2 {name} J", J_k, J_p, dn)
    e3 = max(compare(f"K3 {name} X", X_k, X_p, dn),
             compare(f"K3 {name} U", U_k, U_p, dn))
    compare(f"K3 {name} J", Jm_k, Jm_p, dn)
    if timings is None:
        return
    costs, alpha = "linesearch_costs_clipped" + suffix, \
        "rollout_alpha_clipped" + suffix
    errs.update({costs: e2, alpha: e3})
    ra = rollout.kernel_args(env, X, U, policy)
    n_params = sum(p.numel() for p in ra["params"])
    timings[costs] = (
        graph_ms(lambda: rollout.linesearch_costs_kernel(ra, alphas), 20),
        cuda_ms(lambda: rollout.linesearch_costs(env, X, U, policy, alphas),
                20),
        cuda_ms(lambda: rollout.linesearch_costs_ref(env, X, U, policy,
                                                     alphas), 3),
        bound(*rollout_work(Bn, Tn, n, n, 4, env_name, n_params, A, True,
                            False)),
    )
    timings[alpha] = (
        graph_ms(lambda: rollout.rollout_alpha_kernel(ra, alpha_vec), 20),
        cuda_ms(lambda: rollout.rollout_alpha(env, X, U, policy, alpha_vec),
                20),
        cuda_ms(lambda: rollout.rollout_alpha_ref(env, X, U, policy,
                                                  alpha_vec), 3),
        bound(*rollout_work(Bn, Tn, n, n, 4, env_name, n_params, 1, True,
                            True)),
    )


def rel_err(got, want):
    """Largest ``|got - want| / (|want| + 1)``."""
    return float(((got.double() - want.double()).abs()
                  / (want.double().abs() + 1.0)).max())


def check_k5(case, dtype, timings=None, errs=None, Bn=B_LONG, Tn=T_LONG):
    """K5 at the slice's shape (``reservoir5``: B=1024, T=500, bounded, the
    random nominal and policy of ``boxqp_inputs``), the navigation
    headline's (B=4096, T=100, unbounded) or a bounded env's at (Bn, Tn):
    against K2 and K3 on the same inputs (its J is K2's; the trajectory
    selected at each lane's alpha is K3's at that alpha), bit for bit, and
    against its plain version; with ``timings``, timed under
    ``linesearch_costs_traj`` (reservoir-5 T=500), ``_navigation`` or
    ``_<case>``."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    dn = dname(dtype)
    if case == "navigation":
        env, X, U, _, _, _, _, policy = headline_inputs(dtype, "cuda")
        label, env_name = "K5 navigation", "navigation"
    else:
        env, X, U, _, _, _, _, policy = boxqp_inputs(case, dtype, Bn, Tn)
        label = f"K5 {case} B={Bn} T={Tn}"
        env_name = "hvac" if case.startswith("hvac") else "reservoir"
    Bn, Tn, n = U.shape
    alphas = ILQRConfig().alphas_static()
    J_k, X_k, U_k = rollout.linesearch_costs_traj(env, X, U, policy, alphas)
    J_2 = rollout.linesearch_costs(env, X, U, policy, alphas)
    best = torch.arange(Bn, device="cuda") % A
    alpha_vec = ILQRConfig().alphas(dtype, device="cuda")[best]
    sel = rollout.select_alpha_trajectory(X, X_k, U_k, J_k, best)
    mat = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    torch.cuda.synchronize()
    for what, got, want in (("J vs K2", J_k, J_2),
                            ("selected X vs K3", sel[0], mat[0]),
                            ("selected U vs K3", sel[1], mat[1]),
                            ("selected J vs K3", sel[2], mat[2])):
        same = torch.equal(got, want)
        print(f"  {label} {what} [{dn}]: bitwise equal {same} (gate), max "
              f"rel err {rel_err(got, want):.3e}")
        if not same:
            raise AssertionError(f"{label} {what} [{dn}]: not bitwise equal")

    J_p, X_p, U_p = rollout.linesearch_costs_traj_ref(env, X, U, policy,
                                                      alphas)
    torch.cuda.synchronize()
    outs_k, outs_p = (J_k, X_k, U_k), (J_p, X_p, U_p)
    max_err = max(float((k - p).abs().max()) for k, p in zip(outs_k[1:],
                                                              outs_p[1:]))
    if dtype == torch.float64:
        for what, k, p in zip(("J", "X", "U"), outs_k, outs_p):
            compare(f"{label} {what}", k, p, dn)
    else:
        to64 = lambda m: dataclasses.replace(m, **{  # noqa: E731
            f: getattr(m, f).double() for f in m.__dataclass_fields__})
        env64 = (headline_inputs(torch.float64, "cuda")[0]
                 if case == "navigation" else bounded_env(case,
                                                          torch.float64))
        outs_r = rollout.linesearch_costs_traj_ref(
            env64, X.double(), U.double(), to64(policy), alphas)
        # lanes first: J [B, A]; X, U [T, A, e, B] -> [B, ...]
        lanes = lambda o: (o[0], o[1].permute(3, 0, 1, 2),  # noqa: E731
                           o[2].permute(3, 0, 1, 2))
        ok = torch.ones(Bn, dtype=torch.bool, device="cuda")
        share_k = lane_share(lanes(outs_k), lanes(outs_r), ok, *K5_F32_TOL)
        share_p = lane_share(lanes(outs_p), lanes(outs_r), ok, *K5_F32_TOL)
        err_k = max(rel_err(a, b) for a, b in zip(outs_k, outs_r))
        err_p = max(rel_err(a, b) for a, b in zip(outs_p, outs_r))
        print(f"  {label} [{dn}]: max abs err vs the plain version "
              f"{max_err:.3e}; vs the plain version in float64: max rel err "
              f"kernel {err_k:.3e}, plain {err_p:.3e}; share of lanes within "
              f"{K5_F32_TOL[0]:g} + {K5_F32_TOL[1]:g}*|ref|: kernel "
              f"{share_k:.6f}, plain {share_p:.6f} (gate: kernel >= plain - "
              f"{K4_F32_SHARE_SLACK})")
        if share_k < share_p - K4_F32_SHARE_SLACK:
            raise AssertionError(f"{label} [{dn}]: the kernel is less "
                                 "accurate than the plain version")
    if timings is None:
        return
    key = "linesearch_costs_traj" + ("" if case == "reservoir5"
                                     else f"_{case}")
    errs[key] = max_err
    ra = rollout.kernel_args(env, X, U, policy)
    n_params = sum(p.numel() for p in ra["params"])
    bounded = env.bounds is not None
    reps, plain_reps = (10, 1) if case == "reservoir5" else (20, 2)
    timings[key] = (
        graph_ms(lambda: rollout.linesearch_costs_traj_kernel(ra, alphas),
                 reps),
        cuda_ms(lambda: rollout.linesearch_costs_traj(env, X, U, policy,
                                                      alphas), reps),
        cuda_ms(lambda: rollout.linesearch_costs_traj_ref(env, X, U, policy,
                                                          alphas),
                plain_reps),
        bound(*traj_work(Bn, Tn, n, n, 4, env_name, n_params, A, bounded)),
    )
    select_ms = cuda_ms(lambda: rollout.select_alpha_trajectory(
        X, X_k, U_k, J_k, best), reps)
    print(f"  {label}: select_alpha_trajectory {select_ms:.4f} ms")
    timings[key + "_select_ms"] = select_ms
    if case != "reservoir5":
        return
    # K2 and K3 at the slice's shape, the two-kernel layout's line search
    timings["linesearch_costs_t500"] = (
        graph_ms(lambda: rollout.linesearch_costs_kernel(ra, alphas), reps),
        cuda_ms(lambda: rollout.linesearch_costs(env, X, U, policy, alphas),
                reps),
        cuda_ms(lambda: rollout.linesearch_costs_ref(env, X, U, policy,
                                                     alphas), plain_reps),
        bound(*rollout_work(Bn, Tn, n, n, 4, env_name, n_params, A, True,
                            False)),
    )
    timings["rollout_alpha_t500"] = (
        graph_ms(lambda: rollout.rollout_alpha_kernel(ra, alpha_vec), reps),
        cuda_ms(lambda: rollout.rollout_alpha(env, X, U, policy, alpha_vec),
                reps),
        cuda_ms(lambda: rollout.rollout_alpha_ref(env, X, U, policy,
                                                  alpha_vec), plain_reps),
        bound(*rollout_work(Bn, Tn, n, n, 4, env_name, n_params, 1, True,
                            True)),
    )
    mat_p = rollout.rollout_alpha_ref(env, X, U, policy, alpha_vec)
    errs["linesearch_costs_t500"] = float((J_2 - J_p).abs().max())
    errs["rollout_alpha_t500"] = max(float((k - p).abs().max())
                                     for k, p in zip(mat[:2], mat_p[:2]))


# -- slice F: K8 (materialize plus derivatives) -------------------------------

def nav_derivs_flops(n: int, zones: int = 1) -> int:
    """Operations of navigation's ``derivatives`` at one step (envs.cuh):
    lam, then per zone the distance, g, g' and the ratio, dlam, f_x and
    l_x."""
    return zones * (3 * n + 8) + zones * (3 * n + 8 + 7 + 2 * n) \
        + 2 * n * n + 2 * n


def k8_work(Bn, Tn, n, m, itemsize, n_params, bounded, zones=1):
    """K8: K3's bytes and operations plus the seven linearization blocks
    written at every step and their operations."""
    bytes_, flops = rollout_work(Bn, Tn, n, m, itemsize, "navigation",
                                 n_params, 1, bounded, True)
    entries = 2 * n * n + n * m + n + m + m * m + m * n
    return (bytes_ + itemsize * Bn * Tn * entries,
            flops + Bn * Tn * nav_derivs_flops(n, zones))


def k8_inputs(case, dtype):
    """K8's inputs: the navigation headline's (``headline_inputs``),
    bounded navigation's (``configs/navigation_bounded.json``, B=256, T=50:
    x0 ~ U(-10, 10), controls ~ 0.5 N(0, 1) clipped, a feedback policy
    with k ~ N(0, 1) that drives many controls to the box) or G3's
    (``configs/navigation.json``, two zones, B=1024, T=20: x0 ~ U over the
    box [1, 8] x [-6, 0] that holds both zones, controls ~ 0.5 N(0, 1), a
    feedback policy with k ~ 0.5 N(0, 1), so u stays non-zero and the
    trajectories cross both zones), the headline's env at the block-ragged
    ``K8_RAGGED`` (``nav_ragged``) or its n-dim extension at the
    headline's B and T (``K8_DIM_CASES``, the plan sweep's); lane z
    started on zone z's center, each lane's alpha from the grid."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Policy
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    if case == "navigation":
        env, X, U, _, _, _, _, policy = headline_inputs(dtype, "cuda")
    elif case == "nav_ragged" or case in K8_DIM_CASES:
        # the headline's env at a block-ragged batch, or its n-dim
        # extension (goal and center padded with 2 and 0) at its B and T
        n = K8_DIM_CASES.get(case, N)
        env = make_navigation(GOAL + [2.0] * (n - N), {
            "center": [ZONES["center"][0] + [0.0] * (n - N)],
            "decay": ZONES["decay"]}, dtype=dtype, device="cuda")
        Bn, Tn = K8_RAGGED if case == "nav_ragged" else (B, T)
        rng = np.random.default_rng(7)
        U = t(0.1 * rng.standard_normal((Bn, Tn, n)))
        X, _ = env.rollout(t(rng.uniform(-10.0, 10.0, (Bn, n))), U)
        policy = Policy(K=t(0.05 * rng.standard_normal((Bn, Tn, n, n))),
                        k=t(0.1 * rng.standard_normal((Bn, Tn, n))))
    elif case == "nav_bounded":
        env = bounded_env("nav_bounded", dtype)
        Bn, Tn = B_NAV_BOUNDED, T_NAV_BOUNDED
        rng = np.random.default_rng(5)
        U = env.clip(t(0.5 * rng.standard_normal((Bn, Tn, N))))
        X, _ = env.rollout(t(rng.uniform(-10.0, 10.0, (Bn, N))), U)
        policy = Policy(K=t(0.05 * rng.standard_normal((Bn, Tn, N, N))),
                        k=t(rng.standard_normal((Bn, Tn, N))))
    else:
        env = load_env(ROOT / "configs/navigation.json", dtype=dtype,
                       device="cuda")
        Bn, Tn = B_G3, G3_PLAN_HORIZON
        rng = np.random.default_rng(6)
        U = t(0.5 * rng.standard_normal((Bn, Tn, N)))
        X, _ = env.rollout(t(rng.uniform((1.0, -6.0), (8.0, 0.0),
                                         (Bn, N))), U)
        policy = Policy(K=t(0.05 * rng.standard_normal((Bn, Tn, N, N))),
                        k=t(0.5 * rng.standard_normal((Bn, Tn, N))))
    # lane z starts on zone z's center, where the distance is the 1e-12
    # inside the norm's square root
    x0 = X[:, 0].clone()
    x0[:env.centers.shape[0]] = env.centers
    X, _ = env.rollout(x0, U)
    Bn = U.shape[0]
    alpha_vec = ILQRConfig().alphas(dtype, device="cuda")[
        torch.arange(Bn, device="cuda") % A]
    return env, X, U, policy, alpha_vec


def check_k8(case, dtype, timings=None, errs=None, inputs=None, key=None,
             reps=(50, 3)):
    """K8 at the navigation headline's shapes (``navigation``: B=4096,
    T=100, one zone), bounded navigation's (``nav_bounded``: B=256, T=50,
    box +-1), G3's (``g3``: two zones, B=1024, T=20; it prints and gates
    the share of steps at which both zones slow the agent, g_z < 0.99,
    where the product over the other zones and the per-zone sum into
    d lambda / dx matter) or the block-ragged ``nav_ragged`` (or on
    ``inputs``, ``k8_inputs``' tuple): X, U, J and the seven linearization
    blocks against its plain version within ``TOL``; X, U and J against K3
    on the same inputs (the same arithmetic in another kernel), bit for
    bit; the kernel-layout policy (the fused iteration's ``policy_lane``)
    gives the same outputs bit for bit. With ``timings``, timed under
    ``key`` (by default the case's), ``reps`` the kernel's and the plain
    version's repetitions."""
    import torch

    from tfmpc_tpu_torch.ops import rollout

    dn = dname(dtype)
    env, X, U, policy, alpha_vec = inputs or k8_inputs(case, dtype)
    Bn, Tn, n = U.shape
    label = f"K8 {case}"
    out_k = rollout.rollout_alpha_derivs(env, X, U, policy, alpha_vec)
    out_p = rollout.rollout_alpha_derivs_ref(env, X, U, policy, alpha_vec)
    out_3 = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    lane = rollout.kernel_layout(env, X, U, policy)
    pol_lane = (lane["K"], lane["k"])
    out_l = rollout.rollout_alpha_derivs(env, X, U, None, alpha_vec,
                                         policy_lane=pol_lane)
    torch.cuda.synchronize()
    if env.bounds is not None:
        clipped = float(((out_p[1] == env.bounds.low)
                         | (out_p[1] == env.bounds.high)).float().mean())
        print(f"  {label}: {clipped:.3f} of the controls on a face of the "
              "box")
    if env.centers.shape[0] > 1:
        d = out_p[0][:, :-1, None, :] - env.centers
        g = torch.tanh(env.decays * (d * d).sum(-1).sqrt() / 2)
        both = float(((g < 0.99).sum(-1) >= 2).double().mean())
        print(f"  {label}: {both:.3f} of the steps inside both zones "
              f"(g_z < 0.99; gate >= {K8_TWO_ZONE_SHARE})")
        if both < K8_TWO_ZONE_SHARE:
            raise AssertionError(f"{label}: too few steps in both zones")
    max_err = 0.0
    for what, got, want in zip(("X", "U", "J"), out_k[:3], out_p[:3]):
        max_err = max(max_err, compare(f"{label} {what}", got, want, dn))
    for k in rollout.D_KEYS:
        max_err = max(max_err, compare(f"{label} {k}", out_k[3][k],
                                       out_p[3][k], dn))
    for what, got, want in zip(("X", "U", "J"), out_k[:3], out_3):
        same = torch.equal(got, want)
        print(f"  {label} {what} vs K3 [{dn}]: bitwise equal {same} (gate), "
              f"max rel err {rel_err(got, want):.3e}")
        if not same:
            raise AssertionError(f"{label} {what} vs K3 [{dn}]: not bitwise "
                                 "equal")
    same = all(torch.equal(a, b) for a, b in zip(out_k[:3], out_l[:3])) \
        and all(torch.equal(out_k[3][k], out_l[3][k])
                for k in rollout.D_KEYS)
    print(f"  {label} [{dn}]: the kernel-layout policy gives the same "
          f"outputs bit for bit: {same}")
    if not same:
        raise AssertionError(f"{label} [{dn}]: policy_lane changes K8's "
                             "outputs")
    if timings is None:
        return
    key = key or "rollout_alpha_derivs" + {
        "navigation": "", "nav_bounded": "_bounded", "g3": "_g3"}[case]
    errs[key] = max_err
    a = rollout.kernel_args(env, X, U, None, pol_lane, derivatives=True)
    n_params = sum(p.numel() for p in a["params"])
    reps, plain_reps = (50, 5) if case == "navigation" else reps
    timings[key] = (
        graph_ms(lambda: rollout.rollout_alpha_derivs_kernel(a, alpha_vec),
                 reps),
        cuda_ms(lambda: rollout.rollout_alpha_derivs(
            env, X, U, None, alpha_vec, policy_lane=pol_lane), reps),
        cuda_ms(lambda: rollout.rollout_alpha_derivs_ref(
            env, X, U, policy, alpha_vec), plain_reps),
        bound(*k8_work(Bn, Tn, n, n, X.element_size(), n_params,
                       env.bounds is not None,
                       zones=env.centers.shape[0])),
    )


# -- slice D: K6a and K6b (full DDP) ---------------------------------------------

def to64(model):
    """A dataclass record of tensors in float64."""
    return dataclasses.replace(model, **{
        f: getattr(model, f).double() for f in model.__dataclass_fields__})


def ddp_inputs(case, dtype):
    """Inputs of a K6 check: the headline's (``navigation``, n = m = 2) or a
    bounded env's (``reservoir5``, ``hvac6``) random nominal with its
    linearization and per-lane mu (``headline_inputs``, ``boxqp_inputs``),
    its dynamics Hessians, and the box (navigation's: [-1, 1]). The
    ``synthetic2`` and ``synthetic6`` cases (the navigation and HVAC-6
    inputs) replace the Hessians by seeded random ones, symmetric in their
    derivative indices, at DDP_SYNTHETIC_SCALE: no shipped env has a
    nonzero f_uu, so only these reach t_uu and the mu I_m after it."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Bounds, SecondOrderModel
    from tfmpc_tpu_torch.solvers.ilqr import second_derivatives

    if case in ("navigation", "synthetic2"):
        env, X, U, lin, quad, final, mu, _ = headline_inputs(dtype, "cuda")
        one = torch.ones(N, dtype=dtype, device="cuda")
        bounds = Bounds(low=-one, high=one)
    else:
        env, X, U, lin, quad, final, mu, _ = boxqp_inputs(
            "hvac6" if case == "synthetic6" else case, dtype)
        bounds = env.bounds
    if case.startswith("synthetic"):
        Bn, Tn, n = U.shape
        c = DDP_SYNTHETIC_SCALE[case]
        rng = np.random.default_rng(12)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
        sym = lambda a: 0.5 * (a + a.transpose(-1, -2))  # noqa: E731
        second = SecondOrderModel(
            f_xx=sym(t(c * rng.standard_normal((Bn, Tn, n, n, n)))),
            f_ux=t(c * rng.standard_normal((Bn, Tn, n, n, n))),
            f_uu=sym(t(c * rng.standard_normal((Bn, Tn, n, n, n)))))
    else:
        second = second_derivatives(env, X, U)
    return env, U, lin, quad, final, mu, bounds, second


def force_indefinite(quad, mu, n):
    """Five lanes with l_uu = -100 I and mu = 0: their regularized Quu is
    negative definite at t = T-1, so the kernel and the plain version must
    both flag them."""
    import torch

    Bn = mu.shape[0]
    bad = torch.tensor([0, 1, Bn // 5, Bn // 2, Bn - 1], device="cuda")
    luu = quad.l_uu.clone()
    luu[bad] = -100.0 * torch.eye(n, dtype=luu.dtype, device="cuda")
    mu = mu.clone()
    mu[bad] = 0.0
    return dataclasses.replace(quad, l_uu=luu), mu, bad


def hold_backward(label, dtype, run, run_plain, run_ref64, boxqp, bad=None,
                  run_plain_cpu=None):
    """A Riccati kernel against its plain version on the same inputs.

    float64: identical ok masks, at least half the lanes ok, and on the ok
    lanes K, k, dV1, dV2 within TOL (without the boxQP), or K4's share
    gates (with it; the lanes outside 1e-8 are the line search's near-tie
    flips, counted and printed). float32: the kernel and the float32 plain
    version both against the plain version in float64 (``run_ref64``), the
    kernel's share of lanes within K4_F32_TOL at least the plain version's
    less K4_F32_SHARE_SLACK, mask differences printed. With
    ``run_plain_cpu`` (the plain version on CPU copies of the inputs), where
    the plain version's own share across the two devices falls below
    K4_F64_SHARE, the float64 boxQP share gate is that share less
    K4_F32_SHARE_SLACK: on an ill-conditioned boxQP the plain version does
    not reproduce itself to 1e-8 across two rounding orders either. Returns the largest K/k error
    against the plain version on the lanes ok in both."""
    import torch

    dn = dname(dtype)
    stats = {}
    ok_k, pol_k, dv1_k, dv2_k = run()
    ok_p, pol_p, dv1_p, dv2_p = run_plain(stats)
    torch.cuda.synchronize()
    Bn = ok_k.shape[0]
    outs_k = (pol_k.K, pol_k.k, dv1_k, dv2_k)
    outs_p = (pol_p.K, pol_p.k, dv1_p, dv2_p)
    both = ok_k & ok_p
    max_err = max(float((a[both] - b[both]).abs().max())
                  for a, b in zip(outs_k[:2], outs_p[:2]))
    share_ok = float(ok_p.float().mean())
    print(f"  {label} [{dn}]: {int((~ok_k).sum())} failing lanes in the "
          f"kernel, {int((~ok_p).sum())} in the plain version, "
          f"{int((ok_k != ok_p).sum())} differ; ok share {share_ok:.4f}; "
          f"max K/k err on lanes ok in both {max_err:.3e}"
          + (f"; {stats['newton_iterations']} boxQP Newton iterations in "
             "the plain version" if boxqp else ""))
    if bad is not None and bool(ok_k[bad].any()):
        raise AssertionError(f"{label}: forced-indefinite lanes not flagged")
    if dtype == torch.float64:
        if not torch.equal(ok_k, ok_p):
            raise AssertionError(f"{label}: ok masks differ from the plain "
                                 "version")
        if share_ok < 0.5:
            raise AssertionError(f"{label}: fewer than half the lanes ok, "
                                 "the comparison would be vacuous")
        if not boxqp:
            for what, a, b in zip(("K", "k", "dV1", "dV2"), outs_k, outs_p):
                compare(f"{label} {what}", a, b, dn, ok_k)
        else:
            share = lane_share(outs_k, outs_p, ok_k, *K4_F64_TOL)
            share_all = lane_share(outs_k, outs_p, ok_k, *K4_F64_ALL_TOL)
            flips = round((1.0 - share) * int(ok_k.sum()))
            gate = K4_F64_SHARE
            if run_plain_cpu is not None:
                ok_c, pol_c, dv1_c, dv2_c = (
                    a.cuda() if torch.is_tensor(a) else dataclasses.replace(
                        a, K=a.K.cuda(), k=a.k.cuda())
                    for a in run_plain_cpu())
                if not torch.equal(ok_c, ok_p):
                    raise AssertionError(f"{label}: the plain version's ok "
                                         "masks differ across devices")
                base = lane_share((pol_p.K, pol_p.k, dv1_p, dv2_p),
                                  (pol_c.K, pol_c.k, dv1_c, dv2_c), ok_p,
                                  *K4_F64_TOL)
                if base < K4_F64_SHARE:
                    gate = base - K4_F32_SHARE_SLACK
                print(f"  {label} [{dn}]: the plain version on the card vs on "
                      f"the CPU: share of ok lanes within {K4_F64_TOL[0]:g} + "
                      f"{K4_F64_TOL[1]:g}*|plain| {base:.6f}")
            print(f"  {label} [{dn}]: share of ok lanes within "
                  f"{K4_F64_TOL[0]:g} + {K4_F64_TOL[1]:g}*|plain| "
                  f"{share:.6f} (gate >= {gate:.6f}; {flips} near-tie "
                  f"lanes), within {K4_F64_ALL_TOL[0]:g} + "
                  f"{K4_F64_ALL_TOL[1]:g}*|plain| {share_all:.6f} (gate 1)")
            if share < gate or share_all < 1.0:
                raise AssertionError(f"{label} [{dn}]: lanes outside "
                                     "tolerance")
        return max_err, stats
    ok_r, pol_r, dv1_r, dv2_r = run_ref64()
    outs_r = (pol_r.K, pol_r.k, dv1_r, dv2_r)
    ok = ok_k & ok_p & ok_r
    share_k = lane_share(outs_k, outs_r, ok, *K4_F32_TOL)
    share_p = lane_share(outs_p, outs_r, ok, *K4_F32_TOL)
    print(f"  {label} [{dn}]: lanes whose ok differs from the float64 plain "
          f"version: kernel {int((ok_k != ok_r).sum())}, plain "
          f"{int((ok_p != ok_r).sum())} of {Bn}; share of lanes within "
          f"{K4_F32_TOL[0]:g} + {K4_F32_TOL[1]:g}*|ref| of it: kernel "
          f"{share_k:.6f}, plain version {share_p:.6f} (gate: kernel >= "
          f"plain - {K4_F32_SHARE_SLACK})")
    if share_k < share_p - K4_F32_SHARE_SLACK:
        raise AssertionError(f"{label} [{dn}]: the kernel is less accurate "
                             "than the plain version")
    return max_err, stats


def check_k6(kernel, case, dtype, timings=None, errs=None):
    """K6a (``kernel="K6a"``) or K6b against its plain version on the
    inputs of ``ddp_inputs(case)``; the env cases with five lanes forced
    indefinite. With ``timings``: the kernel, wrapper and plain times and
    the bound at these shapes (f32)."""
    from tfmpc_tpu_torch.ops import riccati

    env, U, lin, quad, final, mu, bounds, second = ddp_inputs(case, dtype)
    Bn, Tn, n = U.shape
    bad = None
    if not case.startswith("synthetic"):
        quad, mu, bad = force_indefinite(quad, mu, n)
    box = kernel == "K6b"
    fns = ((riccati.riccati_backward_ddp_boxqp,
            riccati.riccati_backward_ddp_boxqp_ref) if box else
           (riccati.riccati_backward_ddp, riccati.riccati_backward_ddp_ref))

    def call(fn, lin, quad, final, mu, second, bounds, U, **stats):
        if box:
            return fn(lin, quad, final, mu, bounds, U, second, **stats)
        return fn(lin, quad, final, mu, second)

    args = (lin, quad, final, mu, second, bounds, U)
    args64 = (to64(lin), to64(quad), to64(final), mu.double(), to64(second),
              to64(bounds), U.double())
    err, stats = hold_backward(
        f"{kernel} {case}", dtype, lambda: call(fns[0], *args),
        lambda st: call(fns[1], *args, stats=st),
        lambda: call(fns[1], *args64), box, bad)
    if timings is None:
        return
    # times on the unforced inputs
    env, U, lin, quad, final, mu, bounds, second = ddp_inputs(case, dtype)
    args = (lin, quad, final, mu, second, bounds, U)
    if not box:
        a = riccati._to_kernel_layout(lin, quad, final, mu)
        a.update(riccati._second_to_kernel_layout(second))
        kargs = [a[k] for k in riccati.K6A_ARGS]
        launch = lambda: riccati.riccati_backward_ddp_kernel(*kargs)  # noqa
        name, work, reps = "riccati_backward_ddp", k6a_work(Bn, Tn, n, n, 4), 50
    else:
        a = riccati._to_kernel_layout(lin, quad, final, mu, bounds, U)
        a.update(riccati._second_to_kernel_layout(second))
        kargs = [a[k] for k in riccati.K6B_ARGS]
        launch = lambda: riccati.riccati_backward_ddp_boxqp_kernel(  # noqa
            *kargs)
        stats = {}
        call(fns[1], *args, stats=stats)
        name, reps = "riccati_backward_ddp_boxqp", 20
        work = k6b_work(Bn, Tn, n, n, 4, stats["newton_iterations"])
    errs[name] = err
    timings[name] = (
        graph_ms(launch, reps),
        cuda_ms(lambda: call(fns[0], *args), reps),
        cuda_ms(lambda: call(fns[1], *args), 2),
        bound(*work),
    )


def check_ddp_terms_enter():
    """K6a's gains differ from K1's on navigation's ok lanes (f64): the
    contraction is not silently dropped."""
    import torch

    from tfmpc_tpu_torch.ops import riccati

    _, _, lin, quad, final, mu, _, second = ddp_inputs("navigation",
                                                       torch.float64)
    ok_d, pol_d, _, _ = riccati.riccati_backward_ddp(lin, quad, final, mu,
                                                     second)
    ok_1, pol_1, _, _ = riccati.riccati_backward(lin, quad, final, mu)
    ok = ok_d & ok_1
    diff = float((pol_d.K[ok] - pol_1.K[ok]).abs().max())
    print(f"  K6a vs K1 on navigation [float64]: max |K| difference on "
          f"{int(ok.sum())} ok lanes {diff:.3e} (gate > 1e-5)")
    if not diff > 1e-5:
        raise AssertionError("K6a: the DDP terms do not change the gains")


def check_k1_dims(dtype):
    """K1 at reservoir-5 (n = m = 5, one of its new instantiations) against
    its plain version, five lanes forced indefinite."""
    from tfmpc_tpu_torch.ops import riccati

    _, _, U, lin, quad, final, mu, _ = boxqp_inputs("reservoir5", dtype)
    quad, mu, bad = force_indefinite(quad, mu, U.shape[-1])
    hold_backward("K1 reservoir5", dtype,
                  lambda: riccati.riccati_backward(lin, quad, final, mu),
                  lambda st: riccati.riccati_backward_ref(lin, quad, final,
                                                          mu),
                  lambda: riccati.riccati_backward_ref(
                      to64(lin), to64(quad), to64(final), mu.double()),
                  False, bad)


def print_lane_plans(lib):
    """Each lane kernel's launch plan at the shapes this script runs (K1
    and K6a at the headline's B, K4 and K6b at B_BOX, and LANE_RAGGED's
    batches), beside the shared bytes the kernel computes for it
    (``tfmpc_riccati_lane_smem_bytes``), which must agree."""
    import torch

    from tfmpc_tpu_torch.ops import riccati

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant, (box, ddp) in riccati.VARIANTS.items():
        Bs = (B_BOX, 2047) if box else (B, 4095)
        for n in (2, 3, 5, 6):
            for dtype in (torch.float32, torch.float64):
                for Bn in Bs:
                    p = riccati.lane_plan(variant, n, n, Bn, dtype, sms=sms)
                    lib_bytes = lib.tfmpc_riccati_lane_smem_bytes(
                        int(box), int(ddp),
                        0 if dtype == torch.float32 else 1, n, n,
                        p.scenarios)
                    print(f"  lane plan {variant} n=m={n} B={Bn} "
                          f"{dname(dtype)}: {p.groups} lane(s) a scenario, "
                          f"{p.scenarios} scenarios ({p.threads} threads) a "
                          f"block, {p.blocks(Bn)} blocks, {p.smem_bytes} B "
                          f"shared (kernel: {lib_bytes} B)")
                    if lib_bytes != p.smem_bytes:
                        raise AssertionError(f"lane plan {variant} n={n}: "
                                             "shared bytes disagree with "
                                             "the kernel's")


def lane_g_sweep(kernel, card):
    """K4 at HVAC-6 (``kernel="K4"``) or K6a at the headline (``"K6a"``),
    f32, with each of LANE_SWEEP_G lanes a scenario (the block's scenarios
    as ``lane_plan`` gives them for that G): every G held to the kernel's
    float32 gate (its share of lanes within K4_F32_TOL of the float64 plain
    version at least the float32 plain version's, less K4_F32_SHARE_SLACK;
    ok-mask differences printed), then all timed in turns (every G, then
    again in reverse; the best of the two), as device times of CUDA graph
    replays. Returns {G: ms}."""
    import torch

    from tfmpc_tpu_torch.ops import riccati

    f32 = torch.float32
    if kernel == "K4":
        env, _, U, lin, quad, final, mu, _ = boxqp_inputs("hvac6", f32)
        variant, keys, n = "boxqp", riccati.K4_ARGS, env.state_size
        a = riccati._to_kernel_layout(lin, quad, final, mu, env.bounds, U)
        launch = riccati.riccati_backward_boxqp_kernel
        plain = lambda *x: riccati.riccati_backward_boxqp_ref(  # noqa: E731
            *x[:4], env.bounds if x[0].f_x.dtype == f32 else to64(
                env.bounds), x[4])
        ins, ins64 = (lin, quad, final, mu, U), (to64(lin), to64(quad),
                                                  to64(final), mu.double(),
                                                  U.double())
    else:
        _, U, lin, quad, final, mu, _, second = ddp_inputs("navigation", f32)
        variant, keys, n = "ddp", riccati.K6A_ARGS, N
        a = riccati._to_kernel_layout(lin, quad, final, mu)
        a.update(riccati._second_to_kernel_layout(second))
        launch = riccati.riccati_backward_ddp_kernel
        plain = riccati.riccati_backward_ddp_ref
        ins = (lin, quad, final, mu, second)
        ins64 = (to64(lin), to64(quad), to64(final), mu.double(),
                 to64(second))
    Bn, Tn = U.shape[:2]
    kargs = [a[k] for k in keys]
    ok_r, pol_r, dv1_r, dv2_r = plain(*ins64)
    ok_p, pol_p, dv1_p, dv2_p = plain(*ins)
    outs_r = (pol_r.K, pol_r.k, dv1_r, dv2_r)
    share_p = lane_share((pol_p.K, pol_p.k, dv1_p, dv2_p), outs_r,
                         ok_p & ok_r, *K4_F32_TOL)
    fns = {}
    for G in LANE_SWEEP_G:
        plan = riccati.lane_plan(variant, n, n, Bn, f32, groups=G,
                                 sms=torch.cuda.get_device_properties(
                                     0).multi_processor_count)
        fn = lambda plan=plan: launch(*kargs, plan=plan)  # noqa: E731
        ok_k, pol_k, dv1_k, dv2_k = riccati._from_kernel_layout(
            fn(), Bn, Tn, n, n)
        share_k = lane_share((pol_k.K, pol_k.k, dv1_k, dv2_k), outs_r,
                             ok_k & ok_r, *K4_F32_TOL)
        print(f"  {kernel} G={G} ({plan.scenarios} scenarios a block) "
              f"[float32]: ok differs from the float64 plain version on "
              f"{int((ok_k != ok_r).sum())} of {Bn} lanes; share of lanes "
              f"within {K4_F32_TOL[0]:g} + {K4_F32_TOL[1]:g}*|ref| "
              f"{share_k:.6f} (gate >= plain {share_p:.6f} - "
              f"{K4_F32_SHARE_SLACK})")
        if share_k < share_p - K4_F32_SHARE_SLACK:
            raise AssertionError(f"{kernel} G={G}: less accurate than the "
                                 "plain version")
        fns[G] = fn
    times = {}
    for order in (list(fns), list(fns)[::-1]):
        for G in order:
            times.setdefault(G, []).append(graph_ms(fns[G], 10))
    out = {G: min(v) for G, v in times.items()}
    print(f"  {kernel} (B={Bn}, T={Tn}, n=m={n}, f32) by lanes a scenario, "
          "device ms, best of two turns: " + ", ".join(
              f"G={G} {ms:.4f}" for G, ms in out.items())
          + f"; the plan takes G={riccati.LANE_PLANS[variant][n][0]} "
          f"[{card}]")
    return out


def rollout_plan_cases():
    """(label, env, B, T) of every K2/K3/K5 launch shape this script runs,
    block-ragged ones included."""
    return [("navigation", None, B, T), ("hvac6", "hvac6", B_BOX, T),
            ("reservoir5", "reservoir5", B_BOX, T),
            ("reservoir5 T=500", "reservoir5", B_LONG, T_LONG),
            ("nav_bounded", "nav_bounded", B_NAV_BOUNDED, T_NAV_BOUNDED),
            ("e1_hvac16", "hvac16", B_E1, T_E1),
            ("e2_hvac12", "hvac12", B_E2, T_E2),
            *((f"{case} B={Bn} (ragged)", case, Bn, Tn)
              for case, Bn, Tn in ROLLOUT_RAGGED)]


def plan_layout(env, Bn, dtype):
    """What ``rollout.launch_plan`` reads of ``kernel_args`` output, for
    ``env`` at Bn scenarios."""
    step, n = env.device_step(), env.state_size
    return {"dims": (Bn, 1, n, n), "dtype": dtype, "env_id": step.env_id,
            "params": [p.to(dtype=dtype, device="cuda").contiguous()
                       for p in step.params],
            "int_params": step.int_params}


# K8's launch shapes: (label, k8_inputs case, B): the headline, bounded
# navigation, G3 and the block-ragged batch
K8_PLAN_CASES = (("navigation", "navigation", B),
                 ("nav_bounded", "nav_bounded", B_NAV_BOUNDED),
                 ("g3", "g3", B_G3), ("nav B=1023 (ragged)", "nav_ragged",
                                      K8_RAGGED[0]))
KERNEL_NAMES = {"costs": "K2", "alpha": "K3", "traj": "K5", "derivs": "K8"}


def print_rollout_plans(lib):
    """The tile kernel's launch plans: K2's, K3's and K5's at
    ``rollout_plan_cases``, K8's at ``K8_PLAN_CASES``, beside the shared
    bytes the kernel computes for them (``tfmpc_rollout_smem_bytes``),
    which must agree, and the most threads a block of the kernel can
    launch with."""
    import torch

    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.ops import rollout

    shapes = [(label, case, Bn, ("costs", "alpha", "traj"))
              for label, case, Bn, _ in rollout_plan_cases()] + [
        (label, case, Bn, ("derivs",)) for label, case, Bn in K8_PLAN_CASES]
    for label, case, Bn, kinds in shapes:
        for dtype in (torch.float32, torch.float64):
            if case in (None, "navigation", "nav_ragged"):
                env = make_navigation(GOAL, ZONES, dtype=dtype, device="cuda")
            elif case == "g3":
                env = load_env(ROOT / "configs/navigation.json", dtype=dtype,
                               device="cuda")
            else:
                env = bounded_env(case, dtype)
            a = plan_layout(env, Bn, dtype)
            n = env.state_size
            pe = sum(p.numel() for p in a["params"])
            for kernel in kinds:
                per = A if kernel in rollout.EVERY_ALPHA else 1
                p = rollout.launch_plan(a, kernel, A)
                lib_bytes = lib.tfmpc_rollout_smem_bytes(
                    0 if dtype == torch.float32 else 1, n, n, p.groups,
                    p.scenarios, p.depth, pe)
                print(f"  rollout plan {KERNEL_NAMES[kernel]} {label} "
                      f"n=m={n} B={Bn} {dname(dtype)}: {p.groups} lane(s) a "
                      f"rollout, {p.scenarios} scenario(s) a block "
                      f"({p.threads(per)} threads of at most "
                      f"{rollout.kernel_max_threads(kernel, a)}), {p.depth} "
                      f"step(s) ahead, {p.blocks(Bn)} blocks, "
                      f"{p.smem_bytes} B shared (kernel: {lib_bytes} B)")
                if lib_bytes != p.smem_bytes:
                    raise AssertionError(f"rollout plan {kernel} {label}: "
                                         "shared bytes disagree with the "
                                         "kernel's")


def print_generic_plans(lib):
    """The generic form's launch plans of K2, K3 and K5 at
    ``GENERIC_KERNEL_CASES``' shapes in both dtypes, beside the shared
    bytes the kernel computes for them
    (``tfmpc_rollout_generic_smem_bytes``), which must agree, and the most
    threads a block of the kernel can launch with."""
    import torch

    from tfmpc_tpu_torch.ops import rollout

    for case, (Bn, _) in GENERIC_KERNEL_CASES.items():
        for dtype in (torch.float32, torch.float64):
            env = generic_env(case, dtype)
            step, n, m = env.device_step(), env.state_size, env.action_size
            a = {"dims": (Bn, 1, n, m), "dtype": dtype,
                 "env_id": step.env_id,
                 "params": [p.to(dtype=dtype, device="cuda").contiguous()
                            for p in step.params],
                 "int_params": step.int_params}
            pe = sum(p.numel() for p in a["params"])
            for kernel in ("costs", "alpha", "traj"):
                per = A if kernel in rollout.EVERY_ALPHA else 1
                p = rollout.launch_plan(a, kernel, A)
                lib_bytes = lib.tfmpc_rollout_generic_smem_bytes(
                    0 if dtype == torch.float32 else 1, n, m, p.groups,
                    p.scenarios, p.depth, pe, p.scenarios * per)
                print(f"  generic plan {KERNEL_NAMES[kernel]} {case} (n, m) "
                      f"= ({n}, {m}) B={Bn} {dname(dtype)}: {p.groups} "
                      f"lane(s) a rollout, {p.scenarios} scenario(s) a block "
                      f"({p.threads(per)} threads of at most "
                      f"{rollout.kernel_max_threads(kernel, a)}), {p.depth} "
                      f"step(s) ahead, {p.blocks(Bn)} blocks, {p.smem_bytes}"
                      f" B shared (kernel: {lib_bytes} B)")
                if not p.generic or lib_bytes != p.smem_bytes:
                    raise AssertionError(f"generic plan {kernel} {case}: not "
                                         "the generic form's, or its shared "
                                         "bytes disagree with the kernel's")


def require_ragged(a, kernel, label):
    """Raise unless ``kernel``'s plan for ``kernel_args``-like ``a`` leaves
    the last block part-full."""
    from tfmpc_tpu_torch.ops import rollout

    Bn = a["dims"][0]
    plan = rollout.launch_plan(a, kernel, A)
    tail = Bn - (plan.blocks(Bn) - 1) * plan.scenarios
    name = KERNEL_NAMES[kernel]
    print(f"  {name} {label} {dname(a['dtype'])}: {plan.scenarios} scenarios "
          f"a block, {tail} in the last block")
    if plan.scenarios < 2 or tail == plan.scenarios:
        raise AssertionError(f"{name} {label}: the batch is not block-ragged "
                             "under the plan")


def check_rollout_ragged(dtype):
    """K2, K3 and K5 at ``ROLLOUT_RAGGED``'s block-ragged batches and K8 at
    ``K8_RAGGED``'s (the headline's env), after checking that each plan
    leaves the last block part-full: K2 and K3 against their plain versions
    within ``TOL`` (``check_clipped_rollouts``), K5 against K2 and K3 bit
    for bit and against its plain version (``check_k5``), K8 against its
    plain version and K3 (``check_k8``)."""
    for case, Bn, Tn in ROLLOUT_RAGGED:
        a = plan_layout(bounded_env(case, dtype), Bn, dtype)
        for kernel in ("costs", "alpha", "traj"):
            require_ragged(a, kernel, f"{case} B={Bn} T={Tn}")
        check_clipped_rollouts(case, dtype, Bn=Bn, Tn=Tn)
        check_k5(case, dtype, Bn=Bn, Tn=Tn)
    env, X, U, policy, _ = k8_inputs("nav_ragged", dtype)
    require_ragged(plan_layout(env, U.shape[0], dtype), "derivs",
                   f"navigation B={U.shape[0]} T={U.shape[1]}")
    check_k8("nav_ragged", dtype)


def check_lane_ragged(dtype):
    """K1/K4/K6a/K6b at LANE_RAGGED's block-ragged batches (T_RAGGED steps,
    five lanes forced indefinite, ``force_indefinite``; the last of them
    in the last block), after checking that each plan leaves the last block
    part-full: ``hold_backward``'s gates (identical ok masks and TOL, or
    K4's share gates, in float64; against the float64 plain version in
    float32)."""
    import torch

    from tfmpc_tpu_torch.ops import riccati

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, Bn in LANE_RAGGED:
        env, U, lin, quad, final, mu, bounds, second = ddp_inputs(case,
                                                                  dtype)
        cut = lambda r: dataclasses.replace(r, **{  # noqa: E731
            f: (getattr(r, f)[:Bn, :T_RAGGED] if getattr(r, f).ndim > 1
                and r is not final else getattr(r, f)[:Bn])
            for f in r.__dataclass_fields__ if getattr(r, f) is not None})
        lin, quad, final, second = cut(lin), cut(quad), cut(final), \
            cut(second)
        mu, U = mu[:Bn], U[:Bn, :T_RAGGED]
        n = U.shape[-1]
        quad, mu, bad = force_indefinite(quad, mu, n)
        box_case = case != "navigation"
        pairs = (("K4", "boxqp"), ("K6b", "ddp_boxqp")) if box_case else \
            (("K1", "ilqr"), ("K6a", "ddp"))
        for kernel, variant in pairs:
            plan = riccati.lane_plan(variant, n, n, Bn, dtype, sms=sms)
            tail = Bn - (plan.blocks(Bn) - 1) * plan.scenarios
            print(f"  {kernel} {case} B={Bn} T={T_RAGGED} {dname(dtype)}: "
                  f"{plan.groups} lane(s) a scenario, {plan.scenarios} a "
                  f"block, {tail} in the last block")
            if plan.scenarios < 2 or tail == plan.scenarios:
                raise AssertionError(f"{kernel} {case} B={Bn}: the batch is "
                                     "not block-ragged under the plan")
            box, ddp = riccati.VARIANTS[variant]
            name = "riccati_backward" + ("_ddp" if ddp else "") + (
                "_boxqp" if box else "")
            wrap, ref = (getattr(riccati, name),
                         getattr(riccati, name + "_ref"))

            def call(fn, lin, quad, final, mu, bounds, U, second, **st):
                args = (lin, quad, final, mu) + ((bounds, U) if box else ())
                args += (second,) if ddp else ()
                return fn(*args, **(st if box else {}))

            args = (lin, quad, final, mu, bounds, U, second)
            args64 = (to64(lin), to64(quad), to64(final), mu.double(),
                      to64(bounds), U.double(), to64(second))
            hold_backward(f"{kernel} {case} B={Bn}", dtype,
                          lambda: call(wrap, *args),
                          lambda st: call(ref, *args, stats=st),
                          lambda: call(ref, *args64), box, bad)


def ddp_oracle_devs(res, x0s, horizon=T):
    """Max-abs control deviation of each scenario of ``res`` from the fp64
    NumPy navigation oracle."""
    import numpy as np

    from oracles import ilqr_navigation_oracle_np

    devs = []
    for i, x0 in enumerate(x0s):
        _, U_np, _ = ilqr_navigation_oracle_np(
            GOAL, ZONES["center"], ZONES["decay"], np.asarray(x0, float),
            horizon, atol=1e-10)
        devs.append(float(np.abs(res.actions[i].double().cpu().numpy()
                                 - U_np).max()))
    return devs


def ddp_oracle_checks(nav32, x0s):
    """Full DDP through K6a, K2 and K3 against the fp64 navigation oracle,
    gated at 1e-4: the JAX release claim's case (x0 = 0, float32,
    atol=1e-10, 200 iterations; benchmarks/release_check.py:64-78), and
    D2's first four scenarios with D2's config in float64. In float32 DDP
    stops ~7e-4 from the optimum on one of those four (x0 = (2.13, 4.59)),
    in the JAX package too (CPU, XLA path), so D2's own float32 controls
    are printed, not gated."""
    import torch

    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    nav64 = make_navigation(GOAL, ZONES, dtype=torch.float64, device="cuda")
    cases = (
        ("release claim, x0 = 0, f32", nav32,
         [[0.0, 0.0]], ILQRConfig(atol=1e-10, max_iterations=200,
                                  use_pallas=True, ddp=True)),
        ("D2's first 4 scenarios, f64", nav64, x0s,
         ILQRConfig(**DDP_HEADLINE)),
    )
    for label, env, x0, cfg in cases:
        x0_t = torch.as_tensor(x0, dtype=env.goal.dtype, device="cuda")
        res, launches, plain = counted(solver(env, x0_t, T, cfg))
        require_path(f"DDP oracle solve, {label}", launches, plain,
                     {"riccati_backward_ddp"}
                     | line_search_kernels(cfg, T, N))
        devs = ddp_oracle_devs(res, x0)
        print(f"  DDP controls vs the fp64 NumPy oracle, {label}: converged "
              f"{res.converged.tolist()}, iterations "
              f"{res.iterations.tolist()}, max-abs {max(devs):.3e} (gate < "
              "1e-4)")
        if not bool(res.converged.all()) or max(devs) >= 1e-4:
            raise AssertionError(f"DDP controls deviate from the fp64 "
                                 f"oracle ({label})")


# -- slice E: K7, P1 and the mid-dim rollouts ----------------------------------

def synthetic_mid_inputs(n, m, dtype, Bn=128, Tn=6):
    """A random well-posed batched linearization at (n, m) (stable
    dynamics, PSD costs; ``tests/test_riccati_mid.py::_synthetic``), per-lane
    mu (half 0), the box +-0.4 and a nominal ``Ubar`` ~ 0.2 N(0, 1), from a
    numpy seed."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import (Bounds, LinearModel,
                                            QuadraticFinal, QuadraticModel)

    rng = np.random.default_rng(100 * n + m)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731

    def psd(k, scale):
        a = rng.standard_normal((Bn, Tn, k, k)) * scale
        return t(np.einsum("btij,btkj->btik", a, a) + 0.5 * np.eye(k))

    lin = LinearModel(
        f=t(np.zeros((Bn, Tn, n))),
        f_x=t(0.9 * np.eye(n) + 0.1 * rng.standard_normal((Bn, Tn, n, n))),
        f_u=t(0.3 * rng.standard_normal((Bn, Tn, n, m))))
    quad = QuadraticModel(
        l=t(np.zeros((Bn, Tn))), l_x=t(rng.standard_normal((Bn, Tn, n))),
        l_u=t(rng.standard_normal((Bn, Tn, m))), l_xx=psd(n, 0.3),
        l_uu=psd(m, 0.3),
        l_ux=t(0.1 * rng.standard_normal((Bn, Tn, m, n))))
    final = QuadraticFinal(l=t(np.zeros(Bn)),
                           l_x=t(rng.standard_normal((Bn, n))),
                           l_xx=psd(n, 0.3)[:, 0])
    mu = t(np.where(rng.uniform(size=Bn) < 0.5, 0.0,
                    rng.uniform(0.0, 0.3, Bn)))
    bounds = Bounds(low=t(np.full(m, -0.4)), high=t(np.full(m, 0.4)))
    Ubar = t(0.2 * rng.standard_normal((Bn, Tn, m)))
    return lin, quad, final, mu, bounds, Ubar


def to_cpu(a):
    """A tensor, or a dataclass record of tensors, on the CPU."""
    if hasattr(a, "cpu"):
        return a.cpu()
    return dataclasses.replace(a, **{f: getattr(a, f).cpu()
                                     for f in a.__dataclass_fields__})


def mid_case(case, dtype):
    """K7's inputs: ``hvac16`` (E1's shapes) and ``hvac12`` (E2's), or one
    of ``MID_RAGGED``'s (env, B) pairs at T_RAGGED steps, the env's
    linearization at a random nominal (``boxqp_inputs``) with 8 boxQP
    iterations, or an (n, m) pair's synthetic inputs with 4. Returns
    (label, lin, quad, final, mu, bounds, Ubar, boxqp_iters)."""
    if isinstance(case, str):
        name, label = case, case
        Bn, Tn = (B_E1, T_E1) if case == "hvac16" else (B_E2, T_E2)
    elif isinstance(case[0], str):
        (name, Bn), Tn = case, T_RAGGED
        label = f"{name} B={Bn}"
    else:
        n, m = case
        return (f"synthetic ({n}, {m})", *synthetic_mid_inputs(n, m, dtype),
                4)
    env, _, U, lin, quad, final, mu, _ = boxqp_inputs(name, dtype, Bn, Tn)
    return label, lin, quad, final, mu, env.bounds, U, 8


def check_k7(case, dtype, timings=None, errs=None, suffix=""):
    """K7, both variants, against its plain versions on ``mid_case(case)``
    with five lanes forced indefinite (``hold_backward``: identical ok
    masks and the ok lanes within tolerance in float64, the boxQP's share
    gate set by the plain version's own agreement across the card and the
    CPU; the float32 share rule against the float64 plain version). With
    ``timings``: the kernel, wrapper and plain times and the bounds at
    these shapes, on the unforced inputs, under the kernels' names plus
    ``suffix``."""
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    label, lin, quad, final, mu, bounds, U, iters = mid_case(case, dtype)
    Bn, Tn, n, m = lin.f_u.shape
    quad_b, mu_b, bad = force_indefinite(quad, mu, m)
    args = (lin, quad_b, final, mu_b)
    args64 = (to64(lin), to64(quad_b), to64(final), mu_b.double())
    box, box64 = (bounds, U), (to64(bounds), U.double())
    for variant in ("ilqr", "boxqp"):
        if variant == "ilqr":
            run = lambda: rm.riccati_backward_mid(*args)  # noqa: E731
            plain = lambda st: rm.riccati_backward_mid_ref(*args)  # noqa: E731
            ref64 = lambda: rm.riccati_backward_mid_ref(*args64)  # noqa: E731
        else:
            run = lambda: rm.riccati_backward_mid_boxqp(  # noqa: E731
                *args, *box, iters)
            plain = lambda st: rm.riccati_backward_mid_boxqp_ref(  # noqa: E731
                *args, *box, iters, stats=st)
            ref64 = lambda: rm.riccati_backward_mid_boxqp_ref(  # noqa: E731
                *args64, *box64, iters)
        plain_cpu = None
        if variant == "boxqp" and dtype == torch.float64:
            plain_cpu = lambda: rm.riccati_backward_mid_boxqp_ref(  # noqa
                *(to_cpu(a) for a in args + box), iters)
        err, _ = hold_backward(f"K7-{variant} {label}", dtype, run, plain,
                               ref64, variant == "boxqp", bad, plain_cpu)
        if timings is None:
            continue
        a = rm.mid_layout(lin, quad, final, mu, bounds, U)
        if variant == "ilqr":
            name, work = "riccati_backward_mid", k1_work(Bn, Tn, n, m, 4)
            kargs = [a[k] for k in rm.MID_ARGS]
            launch = lambda: rm.riccati_backward_mid_kernel(*kargs)  # noqa
            wrap = lambda: rm.riccati_backward_mid(lin, quad, final, mu)  # noqa
            ref = lambda: rm.riccati_backward_mid_ref(  # noqa: E731
                lin, quad, final, mu)
        else:
            stats = {}
            rm.riccati_backward_mid_boxqp_ref(lin, quad, final, mu, bounds, U,
                                              iters, stats=stats)
            name = "riccati_backward_mid_boxqp"
            work = k4_work(Bn, Tn, n, m, 4, stats["newton_iterations"])
            kargs = [a[k] for k in rm.MID_BOXQP_ARGS]
            launch = lambda: rm.riccati_backward_mid_boxqp_kernel(  # noqa
                *kargs, boxqp_iters=iters)
            wrap = lambda: rm.riccati_backward_mid_boxqp(  # noqa: E731
                lin, quad, final, mu, bounds, U, iters)
            ref = lambda: rm.riccati_backward_mid_boxqp_ref(  # noqa: E731
                lin, quad, final, mu, bounds, U, iters)
        errs[name + suffix] = err
        timings[name + suffix] = (cuda_ms(launch, 20), cuda_ms(wrap, 20),
                                  cuda_ms(ref, 2), bound(*work))
        # the kernel computes in double: its bound at the FP64 peak too
        # (at the 67 TFLOP/s of the FP64 tensor cores it is the f32 one)
        b64, by64 = bound(*work, "float64")
        k_ms = timings[name + suffix][0]
        print(f"  {name}{suffix}: {k_ms:.4f} ms; bound {bound(*work)[0]:.4f}"
              f" ms at the f32 peak, {b64:.4f} ms ({by64}) at the FP64 "
              f"peak: {b64 / k_ms:.4f} of it")


def check_k7_ragged(case, dtype):
    """``check_k7`` on one of ``MID_RAGGED``'s batches, after checking that
    its plan has more than one team a block and a last block that is not
    full (the lane forced indefinite last, ``force_indefinite``, is there)."""
    from tfmpc_tpu_torch.ops import riccati_mid as rm

    name, Bn = case
    n = 16 if name == "hvac16" else 12
    plan = rm.mid_plan(n, n, Bn, dtype)
    tail = Bn - (plan.blocks(Bn) - 1) * plan.scenarios
    print(f"  K7 {name} B={Bn} {dname(dtype)}: {plan.warps} warp(s) a team, "
          f"{plan.scenarios} teams a block, {tail} in the last block")
    if plan.scenarios < 2 or tail == plan.scenarios:
        raise AssertionError(f"K7 {name} B={Bn}: the batch is not "
                             "block-ragged under the plan")
    check_k7(case, dtype)


def print_mid_plans(lib):
    """K7's launch plan at each shape phase 20 runs, beside the shared
    bytes the kernel computes for it (``tfmpc_riccati_mid_smem_bytes``),
    which must agree."""
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    shapes = [((12, 12), B_E2), ((16, 16), B_E1)] + [
        (dims, 128) for dims in MID_SYNTHETIC_DIMS] + [
        ((12, 12) if name == "hvac12" else (16, 16), Bn)
        for name, Bn in MID_RAGGED]
    for (n, m), Bn in shapes:
        for dtype in (torch.float32, torch.float64):
            p = rm.mid_plan(n, m, Bn, dtype)
            lib_bytes = lib.tfmpc_riccati_mid_smem_bytes(
                0 if dtype == torch.float32 else 1, n, m, p.scenarios,
                int(p.stage_l))
            print(f"  K7 plan ({n}, {m}) B={Bn} {dname(dtype)}: {p.threads} "
                  f"threads, {p.warps} warp(s) a scenario, {p.scenarios} "
                  f"scenarios a block, l blocks "
                  f"{'staged' if p.stage_l else 'read in place'}, "
                  f"{p.smem_bytes} B shared (kernel: {lib_bytes} B)")
            if lib_bytes != p.smem_bytes:
                raise AssertionError(f"K7 plan at {(n, m)}: shared bytes "
                                     "disagree with the kernel's")


def k7_warps_sweep(card):
    """K7-boxQP's time (f32 inputs) with 1, 2 and 4 warps a scenario at
    E1's shape (HVAC-16, B=512, T=50) and on the synthetic inputs at
    (24, 24), (32, 32) and (48, 48): the measurement behind
    ``riccati_mid.MID_WARPS``. Returns {dims: {warps: ms}}."""
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    out = {}
    for dims in MID_WARPS_SWEEP:
        case = "hvac16" if dims == (16, 16) else dims
        label, lin, quad, final, mu, bounds, U, iters = mid_case(
            case, torch.float32)
        Bn, Tn, n, m = lin.f_u.shape
        a = rm.mid_layout(lin, quad, final, mu, bounds, U)
        kargs = [a[k] for k in rm.MID_BOXQP_ARGS]
        row = {}
        for warps in (1, 2, 4):
            plan = rm.mid_plan(n, m, Bn, torch.float32, warps=warps)
            row[warps] = cuda_ms(lambda: rm.riccati_backward_mid_boxqp_kernel(
                *kargs, boxqp_iters=iters, plan=plan), 10)
        out[f"{n}x{m}"] = row
        print(f"  K7-boxQP {label} (B={Bn}, T={Tn}) by warps a scenario: "
              + ", ".join(f"{w}: {ms:.4f} ms" for w, ms in row.items())
              + f"; the plan takes {rm.mid_warps(n, m)} [{card}]")
    return out


def k7_vs_k4(card, k4_bound):
    """K7 and K4 on phase 3's HVAC-6 inputs (n = m = 6, B=2048, T=100):
    the same contract, so in float64 identical ok masks and K4's share
    gates between the two kernels; in float32 both kernels' times, the
    lane/mid boundary's measurement, K7's wrapper time and the bound of
    this work (``k4_bound``, phase 3's K4 bound on the same inputs: the
    two kernels do the same work). Returns the times and the bound."""
    import torch

    from tfmpc_tpu_torch.ops import riccati, riccati_mid as rm

    env, _, U, lin, quad, final, mu, _ = boxqp_inputs("hvac6", torch.float64)
    args = (lin, quad, final, mu, env.bounds, U)
    ok4, pol4, a4, b4 = riccati.riccati_backward_boxqp(*args)
    ok7, pol7, a7, b7 = rm.riccati_backward_mid_boxqp(*args)
    torch.cuda.synchronize()
    outs4, outs7 = (pol4.K, pol4.k, a4, b4), (pol7.K, pol7.k, a7, b7)
    share = lane_share(outs7, outs4, ok4, *K4_F64_TOL)
    share_all = lane_share(outs7, outs4, ok4, *K4_F64_ALL_TOL)
    print(f"  K7 vs K4 on HVAC-6 [float64]: ok masks identical "
          f"{bool(torch.equal(ok4, ok7))} ({int((~ok4).sum())} failing); "
          f"share of ok lanes within {K4_F64_TOL[0]:g} + {K4_F64_TOL[1]:g}*"
          f"|K4| {share:.6f} (gate >= {K4_F64_SHARE}), within "
          f"{K4_F64_ALL_TOL[0]:g} + {K4_F64_ALL_TOL[1]:g}*|K4| "
          f"{share_all:.6f} (gate 1)")
    if not torch.equal(ok4, ok7) or share < K4_F64_SHARE or share_all < 1.0:
        raise AssertionError("K7 disagrees with K4 on HVAC-6")
    env, _, U, lin, quad, final, mu, _ = boxqp_inputs("hvac6", torch.float32)
    a = riccati._to_kernel_layout(lin, quad, final, mu, env.bounds, U)
    k4_args = [a[k] for k in riccati.K4_ARGS]
    a = rm.mid_layout(lin, quad, final, mu, env.bounds, U)
    k7_args = [a[k] for k in rm.MID_BOXQP_ARGS]
    times = {}
    for rnd in range(2):  # in turns: K4, K7, K7, K4
        order = ("K4", "K7") if rnd == 0 else ("K7", "K4")
        for k in order:
            fn = (lambda: riccati.riccati_backward_boxqp_kernel(*k4_args)) \
                if k == "K4" else \
                (lambda: rm.riccati_backward_mid_boxqp_kernel(*k7_args))
            times.setdefault(k, []).append(cuda_ms(fn, 10))
    out = {k: min(v) for k, v in times.items()}
    out["K7_wrapper"] = cuda_ms(lambda: rm.riccati_backward_mid_boxqp(
        lin, quad, final, mu, env.bounds, U), 10)
    out["bound"], out["bound_by"] = k4_bound
    print(f"  lane/mid boundary at HVAC-6 (n = m = 6, B={B_BOX}, T={T}, f32):"
          f" K4 {out['K4']:.4f} ms, K7 {out['K7']:.4f} ms per backward "
          f"(best of two turns; K7/K4 {out['K7'] / out['K4']:.3f}), K7's "
          f"wrapper {out['K7_wrapper']:.4f} ms, bound {out['bound']:.4f} ms "
          f"({out['bound_by']}) [{card}]")
    return out


def check_p1(d, timings, errs, card):
    """P1 against ``row_matmul_ref`` at d, B=1024 (float32 and float64);
    in float32 the kernel, wrapper and plain times, the bound and
    ``torch.bmm`` on ``[B, d, d]`` (the library call computing the same
    function, timed as a yardstick only), then the probe's own chain of
    P1_CHAIN dependent contractions through the wrapper (each rescaled, as
    ``mxu_probe._chained``) with the launch counter set to 0 just before.
    Returns the chain's launches."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    for dtype in (torch.float64, torch.float32):
        dn = dname(dtype)
        rng = np.random.default_rng(d)
        A = torch.as_tensor(rng.standard_normal((P1_B, d, d)), dtype=dtype,
                            device="cuda")
        M = torch.as_tensor(rng.standard_normal((P1_B, d, d)), dtype=dtype,
                            device="cuda")
        rows = lambda X: X.reshape(P1_B, d * d).T.contiguous()  # noqa: E731
        A_rows, M_rows = rows(A), rows(M)
        err = compare(f"P1 d={d}", rm.row_matmul(A_rows, M_rows, d),
                      rm.row_matmul_ref(A_rows, M_rows, d), dn,
                      tol=(1e-5, 1e-5) if dtype == torch.float32 else None)
    name = f"row_matmul_d{d}"
    errs[name] = err
    A, M = A.contiguous(), M.contiguous()
    bytes_ = 3 * d * d * P1_B * 4
    # kernel and library: device times of graph replays (in turns: kernel,
    # bmm, bmm, kernel, the best of each); wrapper and plain: eager loops
    turns = {"k": [], "lib": []}
    for key in ("k", "lib", "lib", "k"):
        turns[key].append(graph_ms(
            (lambda: rm.row_matmul_kernel(A_rows, M_rows, d)) if key == "k"
            else (lambda: torch.bmm(A, M)), 100))
    timings[name] = (
        min(turns["k"]),
        cuda_ms(lambda: rm.row_matmul(A_rows, M_rows, d), 50),
        cuda_ms(lambda: rm.row_matmul_ref(A_rows, M_rows, d), 50),
        bound(bytes_, 2 * d ** 3 * P1_B),
        min(turns["lib"]),
    )
    rm.ROW_MATMUL_LAUNCHES = 0
    C = A_rows
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(P1_CHAIN):
        C = rm.row_matmul(C, M_rows, d)
        C = C * torch.rsqrt((C * C).mean() + 1e-6)
    end.record()
    torch.cuda.synchronize()
    launches = rm.ROW_MATMUL_LAUNCHES
    if launches != P1_CHAIN or not bool(torch.isfinite(C).all()):
        raise AssertionError(f"P1 chain d={d}: {launches} launches")
    k_ms, w_ms, p_ms, (b_ms, b_by), lib_ms = timings[name]
    plan = rm.row_plan(d, dtype)
    print(f"  P1 d={d} B={P1_B} f32: kernel {k_ms:.4f} ms ({plan.scenarios} "
          f"scenarios a block, {plan.rows} x {plan.cols} tiles), torch.bmm "
          f"{lib_ms:.4f} ms (both device times of graph replays, best of "
          f"two turns; P1/bmm {k_ms / lib_ms:.3f}), wrapper {w_ms:.4f} ms "
          f"and plain {p_ms:.4f} ms (eager), bound {b_ms:.4f} ms ({b_by}); "
          f"chain of {P1_CHAIN}: {start.elapsed_time(end) / P1_CHAIN:.4f} ms "
          f"per contraction with its rescale, {launches} launches [{card}]")
    return launches


def p1_tiles(d, card):
    """P1's device time (f32, B=1024, graph replays) with each instantiated
    register tile that fits at d, beside ``torch.bmm``'s: the measurement
    behind ``riccati_mid.ROW_PLANS``. Returns {"rows x cols": ms} and
    "bmm"."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    rng = np.random.default_rng(d)
    A = torch.as_tensor(rng.standard_normal((P1_B, d, d)),
                        dtype=torch.float32, device="cuda")
    M = torch.as_tensor(rng.standard_normal((P1_B, d, d)),
                        dtype=torch.float32, device="cuda")
    rows = lambda X: X.reshape(P1_B, d * d).T.contiguous()  # noqa: E731
    A_rows, M_rows = rows(A), rows(M)
    want = rm.row_matmul_ref(A_rows, M_rows, d)
    out = {}
    for tile in rm.ROW_TILES:
        try:
            plan = rm.row_plan(d, torch.float32, tile)
        except ValueError:
            continue
        key = "{} x {}".format(*tile)
        compare(f"P1 d={d} {key}", rm.row_matmul_kernel(
            A_rows, M_rows, d, plan), want, "float32", tol=(1e-5, 1e-5))
        out[key] = graph_ms(
            lambda: rm.row_matmul_kernel(A_rows, M_rows, d, plan), 100)
    out["bmm"] = graph_ms(lambda: torch.bmm(A, M), 100)
    print(f"  P1 d={d} B={P1_B} f32 by register tile (rows x cols): "
          + ", ".join(f"{t}: {ms:.4f} ms" for t, ms in out.items())
          + f" [{card}]")
    return out


# -- solves ------------------------------------------------------------------

COUNTERS = {
    "riccati_backward": ("riccati", "LAUNCHES", "PLAIN_CALLS"),
    "riccati_backward_boxqp": ("riccati", "BOXQP_LAUNCHES",
                               "BOXQP_PLAIN_CALLS"),
    "linesearch_costs": ("rollout", "COSTS_LAUNCHES", "COSTS_PLAIN_CALLS"),
    "rollout_alpha": ("rollout", "ALPHA_LAUNCHES", "ALPHA_PLAIN_CALLS"),
    "linesearch_costs_traj": ("rollout", "TRAJ_LAUNCHES",
                              "TRAJ_PLAIN_CALLS"),
    "riccati_backward_ddp": ("riccati", "DDP_LAUNCHES", "DDP_PLAIN_CALLS"),
    "riccati_backward_ddp_boxqp": ("riccati", "DDP_BOXQP_LAUNCHES",
                                   "DDP_BOXQP_PLAIN_CALLS"),
    "riccati_backward_mid": ("riccati_mid", "MID_LAUNCHES",
                             "MID_PLAIN_CALLS"),
    "riccati_backward_mid_boxqp": ("riccati_mid", "MID_BOXQP_LAUNCHES",
                                   "MID_BOXQP_PLAIN_CALLS"),
    "rollout_alpha_derivs": ("rollout", "DERIVS_LAUNCHES",
                             "DERIVS_PLAIN_CALLS"),
    # the generic form of K2, K3 and K5 (its plain versions are theirs)
    "linesearch_costs_generic": ("rollout", "COSTS_GENERIC_LAUNCHES",
                                 "COSTS_PLAIN_CALLS"),
    "rollout_alpha_generic": ("rollout", "ALPHA_GENERIC_LAUNCHES",
                              "ALPHA_PLAIN_CALLS"),
    "linesearch_costs_traj_generic": ("rollout", "TRAJ_GENERIC_LAUNCHES",
                                      "TRAJ_PLAIN_CALLS"),
    # K7's full-DDP variants and the generic K8 (phase 30)
    "riccati_backward_mid_ddp": ("riccati_mid", "MID_DDP_LAUNCHES",
                                 "MID_DDP_PLAIN_CALLS"),
    "riccati_backward_mid_ddp_boxqp": ("riccati_mid",
                                       "MID_DDP_BOXQP_LAUNCHES",
                                       "MID_DDP_BOXQP_PLAIN_CALLS"),
    "rollout_alpha_derivs_generic": ("rollout", "DERIVS_GENERIC_LAUNCHES",
                                     "DERIVS_PLAIN_CALLS"),
}


def line_search_kernels(config, horizon, n):
    """The rollout kernels a kernel-path solve runs: K5 on the
    emit-trajectories layout, else K2 and K3 (AUTO resolved as the solver
    resolves it)."""
    from tfmpc_tpu_torch.solvers.ilqr_batched import _resolve_emit_traj

    if _resolve_emit_traj(config, horizon, n, n):
        return {"linesearch_costs_traj"}
    return {"linesearch_costs", "rollout_alpha"}


def counted(run):
    """Run ``run()`` with every launch and plain-call counter set to 0 just
    before it; returns (result, launches, plain calls) read just after."""
    from tfmpc_tpu_torch.ops import riccati, riccati_mid, rollout

    mods = {"riccati": riccati, "riccati_mid": riccati_mid,
            "rollout": rollout}
    for mod, launches, plain in COUNTERS.values():
        setattr(mods[mod], launches, 0)
        setattr(mods[mod], plain, 0)
    res = run()
    launches = {k: getattr(mods[m], lc) for k, (m, lc, _) in COUNTERS.items()}
    plain = {k: getattr(mods[m], pc) for k, (m, _, pc) in COUNTERS.items()}
    return res, launches, plain


def require_path(label, launches, plain, expect):
    """Every kernel in ``expect`` launched, every other not, and no plain
    version called."""
    print(f"{label}: launches {launches}, plain-version calls {plain}")
    for name, n in launches.items():
        if (n > 0) != (name in expect):
            raise AssertionError(f"{label}: kernel {name} launched {n} "
                                 f"times (expected {'some' if name in expect else 'none'})")
    if any(plain.values()):
        raise AssertionError(f"{label}: a plain version ran")


def solver(env, x0, horizon, config):
    import torch

    from tfmpc_tpu_torch.solvers import ilqr

    def run():
        res = ilqr.solve_batch(env, x0, horizon=horizon, config=config)
        torch.cuda.synchronize()
        return res

    return run


def check_result(label, res, Bn, n, horizon=T, m=None):
    import torch

    if res.actions.shape != (Bn, horizon, n if m is None else m) \
            or res.states.shape != (Bn, horizon + 1, n):
        raise AssertionError(f"{label}: wrong output shapes")
    if not bool(torch.isfinite(res.actions).all()) or not bool(
            torch.isfinite(res.total_cost[~res.failed]).all()):
        raise AssertionError(f"{label}: non-finite output")
    conv = float(res.converged.float().mean())
    print(f"  converged {conv:.4f}, failed {float(res.failed.float().mean()):.4f}"
          f", mean iterations {float(res.iterations.float().mean()):.3f}, max "
          f"iterations {int(res.iterations.max())}, mean total cost "
          f"{float(res.total_cost.double().mean()):.6f}")
    return conv


def agree_with_plain(label, res, run_plain, cost_rtol=1e-4, share=0.99,
                     what="plain path (use_pallas=False)"):
    """One solve on the plain path (or on the path ``what`` that
    ``run_plain`` runs): same converged mask on >= ``share`` of lanes, and
    mean cost within ``cost_rtol`` over the lanes converged in both (a lane
    that ran out of iterations stopped at an arbitrary iterate; in float32
    full DDP on navigation such a lane ends far apart on the two paths).
    Returns its seconds."""
    t0 = time.perf_counter()
    res_p = run_plain()
    secs = time.perf_counter() - t0
    same = float((res_p.converged == res.converged).float().mean())
    both = res.converged & res_p.converged
    c_k, c_p = res.total_cost.double()[both], res_p.total_cost.double()[both]
    rel = abs(float(c_k.mean()) - float(c_p.mean())) / abs(float(c_p.mean()))
    lane_rel = float(((c_k - c_p).abs() / c_p.abs()).max())
    print(f"  {what}: {secs:.2f} s, converged "
          f"{float(res_p.converged.float().mean()):.4f}, same converged mask "
          f"on {same:.4f} of lanes; over the {int(both.sum())} lanes "
          f"converged in both: mean cost {float(c_p.mean()):.6f} (rel diff "
          f"{rel:.3e}), largest per-lane cost rel diff {lane_rel:.3e}; "
          f"controls max-abs diff "
          f"{float((res_p.actions - res.actions).abs().max()):.3e}")
    if same < share or not rel <= cost_rtol:
        raise AssertionError(f"{label}: the kernel solve disagrees with the "
                             f"{what}")
    return secs


def solves_per_s(run, Bn) -> list:
    """RATE_WINDOWS timing windows after one warm-up window; each window
    repeats whole solves for at least WINDOW_S seconds."""
    windows = []
    for _ in range(RATE_WINDOWS + 1):
        reps, t0 = 0, time.perf_counter()
        while reps == 0 or time.perf_counter() - t0 < WINDOW_S:
            run()
            reps += 1
        windows.append(Bn * reps / (time.perf_counter() - t0))
    return windows[1:]


def hvac3_accuracy(ddp=False):
    """HVAC-3 through the kernels in float64 against the fp64 boxQP oracle,
    with the JAX release gate's criteria (benchmarks/release_check.py;
    with ``ddp``, through K6b, its full-DDP claim at :144-157, which gates
    the cost only)."""
    import numpy as np
    import torch

    from oracles import (_hvac_cost_np, _hvac_step_np, hvac_grad_np,
                         hvac_params_np, ilqr_hvac_boxqp_oracle_np)
    from tfmpc_tpu_torch.models.hvac import make_hvac
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    adj3 = [[0, 1, 0], [1, 0, 1], [0, 1, 0]]
    kw3 = dict(is_out=[1, 0, 1], is_hall=[0, 1, 0])
    x0_3 = [8.0, 12.0, 16.0]
    p3 = hvac_params_np(adj3, **kw3)
    _, _, J_o = ilqr_hvac_boxqp_oracle_np(p3, x0_3, T, atol=1e-10)
    env3 = make_hvac(adj3, **kw3, dtype=torch.float64, device="cuda")
    config = ILQRConfig(atol=1e-10, max_iterations=300, boxqp=True,
                        use_pallas=True, ddp=ddp)
    run = solver(env3, torch.tensor([x0_3], dtype=torch.float64,
                                    device="cuda"), T, config)
    res, launches, plain = counted(run)
    require_path(f"HVAC-3 f64 accuracy solve, ddp={ddp}", launches, plain,
                 {"riccati_backward_ddp_boxqp" if ddp
                  else "riccati_backward_boxqp"}
                 | line_search_kernels(config, T, 3))
    U_s = res.actions[0].cpu().numpy()
    x, J_s = np.asarray(x0_3, float), 0.0
    for t in range(T):
        J_s += _hvac_cost_np(p3, x, U_s[t])
        x = _hvac_step_np(p3, x, U_s[t])
    J_s += _hvac_cost_np(p3, x, np.zeros(3))
    cost_rel = abs(J_s - J_o) / abs(J_o)
    g = hvac_grad_np(p3, x0_3, U_s)
    kkt = float(np.abs(U_s - np.clip(U_s - g, p3["low"], p3["high"])).max())
    print(f"  converged {bool(res.converged[0])} in "
          f"{int(res.iterations[0])} iterations; cost {J_s:.10f} vs oracle "
          f"{J_o:.10f}: rel dev {cost_rel:.3e} (gate < 1e-5); KKT residual "
          f"{kkt:.3e} ({'printed, not gated' if ddp else 'gate < 5e-3'})")
    if not cost_rel < 1e-5 or not (ddp or kkt < 5e-3):
        raise AssertionError("HVAC-3 constrained accuracy gate failed")
    return cost_rel, kkt


# -- slice C: long horizons --------------------------------------------------

def reservoir_t500_solves(runs):
    """The slice's main path, emit-trajectories layout (K4 + K5), then the
    two-kernel layout (K4 + K2 + K3) on the same inputs (``layouts_agree``).
    Returns the emit solve's launches and the two-kernel solve's."""
    emit_run, two_run = runs
    res, launches, plain = counted(emit_run)
    require_path(f"reservoir-5 T={T_LONG} solve (emit trajectories)",
                 launches, plain, {"riccati_backward_boxqp", "linesearch_costs_traj"})
    conv = check_result(f"reservoir-5 T={T_LONG}", res, B_LONG, 5, T_LONG)
    if conv < 0.99:
        raise AssertionError(f"reservoir-5 T={T_LONG} converged only "
                             f"{conv:.4f}")
    return launches, layouts_agree(f"reservoir-5 T={T_LONG}", res, two_run,
                                   "riccati_backward_boxqp")


def layouts_agree(label, res, two_run, backward,
                  line_search=("linesearch_costs", "rollout_alpha"),
                  what="two kernels"):
    """The solve ``two_run`` on the two-kernel layout (``backward``, K2 and
    K3 only; ``line_search`` names their counters) against ``res``, the
    same solve on the emit-trajectories layout (or, with ``what``, the
    other way round): the same converged mask and every lane's cost within
    1e-5 relative (|a - b| / (|b| + 1), the JAX release gate's criterion,
    benchmarks/release_check.py:591-619). Returns its launches."""
    res2, launches2, plain2 = counted(two_run)
    require_path(f"{label} solve ({what})", launches2, plain2,
                 {backward, *line_search})
    same_mask = bool((res.converged == res2.converged).all())
    dev = rel_err(res.total_cost, res2.total_cost)
    print(f"  {label}, {what}: identical converged mask "
          f"{same_mask}, per-lane cost max rel dev {dev:.3e} (gate 1e-5), "
          f"identical controls {bool((res.actions == res2.actions).all())}")
    if not same_mask or not dev < 1e-5:
        raise AssertionError(f"{label}: the emit-trajectories and two-kernel "
                             "layouts disagree")
    return launches2


def reservoir_t500_accuracy():
    """Reservoir-5 from X0_ACCURACY at T=500, f32 through K4 and K5, to
    atol=1e-8, against the float64 boxQP oracle with the JAX release gate's
    criteria (benchmarks/release_check.py:552-589): the f32 controls rolled
    out in the fp64 model within 1e-5 relative of the oracle's cost, and a
    KKT residual < 2e-2."""
    import numpy as np
    import torch

    from oracles import (_res_cost_np, _res_step_np,
                         ilqr_reservoir_boxqp_oracle_np, reservoir_grad_np,
                         reservoir_params_np)
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = bounded_env("reservoir5", torch.float32)
    config = ILQRConfig(atol=1e-8, max_iterations=100, boxqp=True,
                        use_pallas=True, linesearch_emit_trajectories=True)
    run = solver(env, torch.tensor([X0_ACCURACY], device="cuda"), T_LONG,
                 config)
    res, launches, plain = counted(run)
    require_path(f"reservoir-5 T={T_LONG} accuracy solve", launches, plain,
                 {"riccati_backward_boxqp", "linesearch_costs_traj"})
    pr = reservoir_params_np(5)
    _, _, J_o = ilqr_reservoir_boxqp_oracle_np(pr, X0_ACCURACY, T_LONG,
                                               atol=1e-9)
    U32 = res.actions[0].double().cpu().numpy()
    x, J_s = np.asarray(X0_ACCURACY, float), 0.0
    for t in range(T_LONG):
        J_s += _res_cost_np(pr, x)
        x = _res_step_np(pr, x, U32[t])
    J_s += _res_cost_np(pr, x)
    cost_rel = abs(J_s - J_o) / abs(J_o)
    g = reservoir_grad_np(pr, X0_ACCURACY, U32)
    kkt = float(np.abs(U32 - np.clip(U32 - g, pr["low"], pr["high"])).max())
    print(f"  converged {bool(res.converged[0])} in "
          f"{int(res.iterations[0])} iterations; cost {J_s:.10f} vs oracle "
          f"{J_o:.10f}: rel dev {cost_rel:.3e} (gate < 1e-5); KKT residual "
          f"{kkt:.3e} (gate < 2e-2)")
    if not bool(res.converged[0]) or not cost_rel < 1e-5 or not kkt < 2e-2:
        raise AssertionError(f"reservoir-5 T={T_LONG} accuracy gate failed")
    return cost_rel, kkt


def parallel_backward_checks():
    """The O(log T) backward on the card: the reservoir-5 T=500 solve from
    X0_ACCURACY with ``parallel_backward=True`` (rollouts on the kernels)
    converges within 1e-4 relative of the sequential kernel solve's cost
    (tests/test_ilqr_parallel_backward.py:167-184), and
    ``backward_parallel`` equals ``lqr.backward`` in f64 at T=500 (1e-8)."""
    import torch

    from tfmpc_tpu_torch.models.problems import make_lqr_linear_navigation
    from tfmpc_tpu_torch.solvers import lqr, lqr_parallel
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = bounded_env("reservoir5", torch.float32)
    x0 = torch.tensor([X0_ACCURACY], device="cuda")
    base = dict(atol=1e-3, max_iterations=60, boxqp=True, use_pallas=True)
    res_s = solver(env, x0, T_LONG, ILQRConfig(**base))()
    par = ILQRConfig(**base, parallel_backward=True)
    res_p, launches, plain = counted(solver(env, x0, T_LONG, par))
    require_path(f"reservoir-5 T={T_LONG} parallel-backward solve", launches,
                 plain, line_search_kernels(par, T_LONG, 5))
    gap = abs(float(res_s.total_cost[0]) - float(res_p.total_cost[0])) \
        / abs(float(res_s.total_cost[0]))
    print(f"  parallel backward: converged {bool(res_p.converged[0])} in "
          f"{int(res_p.iterations[0])} iterations (sequential "
          f"{bool(res_s.converged[0])} in {int(res_s.iterations[0])}); cost "
          f"rel gap {gap:.3e} (gate 1e-4)")
    if not (bool(res_p.converged[0]) and bool(res_s.converged[0])
            and gap <= 1e-4):
        raise AssertionError("parallel backward: solve disagrees with the "
                             "sequential one")
    p = make_lqr_linear_navigation([8.0, -5.0], beta=0.5, horizon=T_LONG,
                                   dtype=torch.float64, device="cuda")
    pol_s, val_s = lqr.backward(p)
    pol_p, val_p = lqr_parallel.backward_parallel(p)
    torch.cuda.synchronize()
    for what, a, b in (("K", pol_p.K, pol_s.K), ("k", pol_p.k, pol_s.k),
                       ("V_xx", val_p.V_xx, val_s.V_xx)):
        compare(f"backward_parallel {what} vs lqr.backward, T={T_LONG}", a, b,
                "float64", tol=(1e-8, 1e-8))
    return gap


def latency_variants(x1):
    """ms per solve of suite config 4's three single-scenario variants
    (benchmarks/suite.py:272-291): the kernels (K4 and the line-search
    kernels) and the parallel-scan backward with the plain rollouts at
    T=500, the median of three solves each; and the plain sequential boxQP
    backward, one solve at T=100 (at T=500 it alone took 96-155 s, most of
    the script's time limit)."""
    import torch

    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = bounded_env("reservoir5", torch.float32)
    base = dict(atol=1e-3, max_iterations=30, boxqp=True)
    out = {}
    for label, cfg, horizon, reps in (
            ("fused-kernel boxQP backward", ILQRConfig(**base,
                                                       use_pallas=True),
             T_LONG, 3),
            ("parallel-scan boxQP backward",
             ILQRConfig(**base, parallel_backward=True), T_LONG, 3),
            ("sequential boxQP backward", ILQRConfig(**base), T, 1)):
        run = solver(env, x1, horizon, cfg)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        label = f"{label} T={horizon}"
        out[label] = sorted(times)[len(times) // 2]
        print(f"  reservoir-5 single-solve latency, {label}: "
              f"{out[label]:.1f} ms (of {[round(x, 1) for x in times]})")
    return out


def lqr_config1(card):
    """Suite config 1: exact LQR on linear navigation, T=100, from x0 = 0,
    f64 on the card against the NumPy Riccati oracle (1e-9); then solves/s
    in f32 (the suite's dtype) for the single instance and for a batch of
    4096 initial states (one policy, rolled out for every row)."""
    import numpy as np
    import torch

    from oracles import lqr_backward_np, lqr_rollout_np
    from tfmpc_tpu_torch.models.problems import make_lqr_linear_navigation
    from tfmpc_tpu_torch.solvers import lqr

    p = make_lqr_linear_navigation(GOAL, beta=0.5, horizon=T,
                                   dtype=torch.float64, device="cuda")
    X, U, costs = lqr.solve(p, torch.zeros(2, dtype=torch.float64,
                                           device="cuda"))
    arrays = [a.cpu().numpy() for a in (p.F, p.f, p.C, p.c, p.C_f, p.c_f)]
    K_np, k_np = lqr_backward_np(*arrays)
    X_np, U_np, J_np = lqr_rollout_np(*arrays, np.zeros(2), K_np, k_np)
    compare("LQR states vs the NumPy oracle", X.cpu(),
            torch.as_tensor(X_np), "float64")
    compare("LQR actions vs the NumPy oracle", U.cpu(),
            torch.as_tensor(U_np), "float64")
    J = float(costs.sum())
    print(f"  LQR total cost {J:.12f} vs oracle {J_np:.12f}, final state "
          f"{X[-1].tolist()}")
    if not abs(J - J_np) <= 1e-9 * max(1.0, abs(J_np)):
        raise AssertionError("LQR cost differs from the NumPy oracle")
    p32 = make_lqr_linear_navigation(GOAL, beta=0.5, horizon=T,
                                     device="cuda")
    rates = {}
    for label, x0 in (("single", torch.zeros(2, device="cuda")),
                      ("batched_4096", torch.zeros(B, 2, device="cuda"))):
        def run(x0=x0):
            out = lqr.solve(p32, x0)
            torch.cuda.synchronize()
            return out
        w = solves_per_s(run, 1 if x0.ndim == 1 else x0.shape[0])
        rates[label] = sorted(w)[len(w) // 2]
        print(f"LQR linear navigation T={T} f32, {label}: median "
              f"{rates[label]:.1f} solves/s, windows "
              f"{[round(x, 1) for x in w]} [{card}]")
    return rates


def emit_ab(label, env, x0, horizon, config, windows, card):
    """Solves/s with ``linesearch_emit_trajectories`` True and False, one
    window of whole solves (>= WINDOW_S seconds) of each in turns, the
    order swapped every round. Both layouts' kernels ran in earlier
    phases, so no round is a warm-up. Returns each arm's median and the
    relative spread (max - min) / median."""
    runs = {flag: solver(env, x0, horizon, dataclasses.replace(
        config, linesearch_emit_trajectories=flag)) for flag in (True, False)}
    rates = {True: [], False: []}
    for r in range(windows):
        for flag in ((True, False) if r % 2 == 0 else (False, True)):
            reps, t0 = 0, time.perf_counter()
            while reps == 0 or time.perf_counter() - t0 < WINDOW_S:
                runs[flag]()
                reps += 1
            rates[flag].append(x0.shape[0] * reps
                               / (time.perf_counter() - t0))
    out = {}
    for flag in (True, False):
        w = sorted(rates[flag])
        med = w[len(w) // 2]
        out[flag] = (med, (w[-1] - w[0]) / med)
        print(f"emit A/B, {label}, linesearch_emit_trajectories={flag}: "
              f"median {med:.1f} solves/s, windows "
              f"{[round(x, 1) for x in rates[flag]]}, spread "
              f"{out[flag][1]:.4f} [{card}]")
    print(f"  emit/two-kernel ratio of medians {out[True][0] / out[False][0]:.4f}")
    return out


class Phases:
    """The seconds of each phase, printed as it ends."""

    def __init__(self, t0):
        self.t, self.seconds = t0, {}

    def done(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        print(f"[phase {name}: {self.seconds[name]:.1f} s]", flush=True)


def print_profile(label, run, card, n_solves=1):
    """``profile_solve`` of ``n_solves`` solves, printed; returns its
    figures."""
    ranges, busy, per_solve, ms, top = profile_solve(run, n_solves)
    print(f"profile, {label} solve with the kernels ({n_solves} solve): "
          f"{ms:.2f} ms per solve on the trace's clock, device busy share "
          f"{busy:.4f}, {per_solve:.0f} kernels per solve; host ms per solve "
          f"by range: { {k: round(v, 3) for k, v in sorted(ranges.items())} }"
          f" [{card}]")
    for name, (k_ms, count) in top:
        print(f"  device kernel {name[:90]}: {k_ms:.3f} ms and {count:.0f} "
              "launches per solve")
    return {"busy_share": busy, "host_ms_by_range": ranges,
            "ms_per_solve": ms, "kernels_per_solve": per_solve}


def profile_solve(run, n_solves=2):
    """Host time per ``ilqr.*`` range (per solve), the device's busy share,
    kernels per solve, the traced ms per solve, and the six device kernels
    with the most time (ms and launches per solve) over ``n_solves``
    solves, from a torch.profiler trace. It reads the trace's raw events
    (name, device, start, duration): turning a T=500 solve's ~2 million
    events into ``FunctionEvent``s (``prof.events()``) takes minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_solves):
            run()
    events = [(e.name(), e.device_type(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    ranges, by_name, kernels = {}, {}, []
    for name, dev, start, dur in events:
        if name.startswith("ilqr."):
            # the profiler mirrors record_function ranges on the device
            # timeline; only the host's span is the range's time
            if dev == DeviceType.CPU:
                ranges[name] = ranges.get(name, 0.0) + dur / 1e6 / n_solves
        elif dev == DeviceType.CUDA:
            kernels.append((start, start + dur))
            ms, count = by_name.get(name, (0.0, 0))
            by_name[name] = (ms + dur / 1e6 / n_solves, count + 1 / n_solves)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    kernels.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = max(s + d for _, _, s, d in events) - min(s for _, _, s, _ in events)
    return (ranges, busy / span, len(kernels) / n_solves,
            span / 1e6 / n_solves, top)


# rollout_tile_kernel's last template argument, its kind (csrc/rollout.cuh
# RolloutKind), as the kernel it is
TILE_KINDS = {"0": "K2", "1": "K3", "2": "K5", "3": "K8"}


def print_ptxas(log_text, every_rollout=False):
    """ptxas's registers, stack and spills: one line per Riccati kernel
    instantiation (variants Ilqr: K1, Boxqp: K4, Ddp: K6a, DdpBoxqp: K6b;
    K7's riccati_mid_kernel), one summary line per rollout kernel
    (rollout_tile_kernel by kind: K2, K3, K5, K8) and for P1 over its
    instantiations, and one line per K2 and K3 instantiation at n = m = 5
    and 6, per K5 and K8 instantiation, per HVAC rollout instantiation
    at n = m = 12 and 16 and per instantiation of the generic form
    (rollout_generic_kernel; ``every_rollout``: per rollout
    instantiation)."""
    entry, rows = None, []
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry, stack = line.split("'")[1], ""
        elif entry and "bytes stack frame" in line:
            stack = line.split(":")[-1].strip()
        elif entry and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((entry, regs, stack))
            entry = None
    names = [r[0] for r in rows]
    cxxfilt = shutil.which("c++filt")
    if cxxfilt and names:
        names = subprocess.run([cxxfilt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    rollout = {}
    for name, (_, regs, stack) in zip(names, rows):
        short = name.replace("tfmpc::(anonymous namespace)::", "").replace(
            "tfmpc::", "").split("(")[0]
        if "riccati" in short:
            print(f"  ptxas: {short}: {regs} registers; {stack}")
            continue
        generic = "rollout_generic" in short
        kind = TILE_KINDS.get(short[-2:-1], "") \
            if "tile" in short or generic else ""
        rollout.setdefault(f"{short.split('<')[0]} {kind}".strip(),
                           []).append((regs, stack))
        if every_rollout or generic or kind in ("K5", "K8") or (
                "HVACStep" in short and (", 12, 12," in short
                                         or ", 16, 16," in short)) or (
                "tile" in short and (", 5, 5," in short
                                     or ", 6, 6," in short)):
            print(f"  ptxas: {short} ({kind}): {regs} registers; {stack}"
                  if kind else f"  ptxas: {short}: {regs} registers; "
                  f"{stack}")
    for kernel, insts in sorted(rollout.items()):
        spills = sum(int(s.split(",")[1].split()[0]) for _, s in insts)
        stacks = max(int(s.split()[0]) for _, s in insts)
        print(f"  ptxas: {kernel}, {len(insts)} instantiations: "
              f"{min(r for r, _ in insts)}-{max(r for r, _ in insts)} "
              f"registers, {spills} bytes of spill stores in all, largest "
              f"stack frame {stacks} bytes")


def print_build_times(log_text):
    """nvcc's wall time per source, from the build log's ``nvcc wall s``
    lines (ops/_build.py ``_run_all``)."""
    walls = [line.split("nvcc wall s ")[1] for line in log_text.splitlines()
             if line.startswith("nvcc wall s ")]
    print("  nvcc wall time per source, s: " + ", ".join(walls))


def slice_e(phase, timings, errs, launches_by_path, plain_s, rates, card):
    """Phases 20-23 (slice E): K7, P1 and the mid-dim K2/K3 against their
    plain versions, the E1 and E2 solves, their rates and the E1 profile.
    Fills the dicts it is given; returns (e1, e2, the K7/K4 times at
    HVAC-6, the E1 profile, K7's warps sweep and P1's tile sweep)."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    # -- 20. slice E: K7, P1 and the mid-dim K2/K3 vs plain versions ---------
    for dtype in (torch.float32, torch.float64):
        print(f"slice E kernels vs plain versions, {dtype}:")
        f32 = (timings, errs) if dtype == torch.float32 else ()
        check_k7("hvac16", dtype, *f32)
        check_k7("hvac12", dtype, *f32, suffix="_hvac12")
        for n, m in MID_SYNTHETIC_DIMS:
            check_k7((n, m), dtype, *f32, suffix=f"_{n}x{m}")
        for case in MID_RAGGED:
            check_k7_ragged(case, dtype)
        check_clipped_rollouts("hvac16", dtype, *f32, Bn=B_E1, Tn=T_E1,
                               suffix="_hvac16")
        check_clipped_rollouts("hvac12", dtype, Bn=B_E2, Tn=T_E2)
    extra = {"k7_warps_ms": k7_warps_sweep(card), "p1_tiles_ms": {}}
    k7_k4 = k7_vs_k4(card, timings["riccati_backward_boxqp"][3])
    for d in P1_DIMS:
        launches_by_path[f"p1_chain_d{d}"] = {
            "row_matmul": check_p1(d, timings, errs, card)}
        extra["p1_tiles_ms"][d] = p1_tiles(d, card)
    phase.done("20. K7, P1 and the mid-dim K2/K3 vs plain versions")

    # -- 21. E1: HVAC-16 (suite config 3b, slice E's main path) --------------
    env16 = bounded_env("hvac16", torch.float32)
    x0_16 = torch.as_tensor(np.random.default_rng(0).uniform(
        8.0, 18.0, (B_E1, 16)).astype("float32"), device="cuda")
    e1_cfg = ILQRConfig(**E1_CONFIG)
    mid_kernels = line_search_kernels(e1_cfg, T_E1, 16)
    run_e1 = solver(env16, x0_16, T_E1, e1_cfg)
    run_e1()
    print(f"E1, HVAC-16 T={T_E1} B={B_E1} solve (slice E's main path):")
    res, launches, plain = counted(run_e1)
    launches_by_path["e1_hvac16"] = launches
    require_path("E1 solve", launches, plain,
                 {"riccati_backward_mid_boxqp"} | mid_kernels)
    e1 = {"converged": check_result("E1", res, B_E1, 16, T_E1),
          "failed": int(res.failed.sum()),
          "mean_cost": float(res.total_cost.double().mean())}
    print(f"  E1 gate (release_check.py:528-550): converged >= "
          f"{E1_MIN_CONVERGED} and 0 failed: {e1}")
    if e1["converged"] < E1_MIN_CONVERGED or e1["failed"]:
        raise AssertionError("E1 solve below the release gate")
    plain_s["e1_hvac16"] = agree_with_plain("E1", res, solver(
        env16, x0_16, T_E1, dataclasses.replace(e1_cfg, use_pallas=False)))
    launches_by_path["e1_hvac16_two_kernel"] = layouts_agree(
        "E1", res, solver(env16, x0_16, T_E1, dataclasses.replace(
            e1_cfg, linesearch_emit_trajectories=False)),
        "riccati_backward_mid_boxqp")
    # K7's iLQR variant: the same solve clip-only (boxqp=False), whose
    # convergence is printed, not gated (clip-only is the weaker algorithm)
    res, launches, plain = counted(solver(
        env16, x0_16, T_E1, dataclasses.replace(e1_cfg, boxqp=False)))
    launches_by_path["e1_hvac16_clip"] = launches
    require_path("E1 clip-only solve", launches, plain,
                 {"riccati_backward_mid"} | mid_kernels)
    check_result("E1 clip-only", res, B_E1, 16, T_E1)
    phase.done("21. E1 HVAC-16")

    # -- 22. E2: the 12-room HVAC ring (suite config 3c) ----------------------
    env12 = bounded_env("hvac12", torch.float32)
    x0_12 = torch.as_tensor(np.random.default_rng(0).uniform(
        8.0, 18.0, (B_E2, 12)).astype("float32"), device="cuda")
    run_e2 = solver(env12, x0_12, T_E2, ILQRConfig(**E2_CONFIG))
    run_e2()
    print(f"E2, HVAC-12 ring T={T_E2} B={B_E2} solve:")
    res, launches, plain = counted(run_e2)
    launches_by_path["e2_hvac12"] = launches
    require_path("E2 solve", launches, plain,
                 {"riccati_backward_mid_boxqp"} | mid_kernels)
    e2 = {"converged": check_result("E2", res, B_E2, 12, T_E2),
          "failed": int(res.failed.sum()),
          "mean_cost": float(res.total_cost.double().mean())}
    if e2["converged"] < E2_MIN_CONVERGED:
        raise AssertionError(f"E2 solve converged only {e2['converged']:.4f}")
    phase.done("22. E2 HVAC-12")

    # -- 23. slice E timing and the E1 profile --------------------------------
    for label, run, Bn in (("e1_hvac16", run_e1, B_E1),
                           ("e2_hvac12", run_e2, B_E2)):
        w = solves_per_s(run, Bn)
        rates[label] = sorted(w)[len(w) // 2]
        plain_txt = (f"; one plain solve {plain_s[label]:.2f} s "
                     f"({Bn / plain_s[label]:.1f} solves/s)"
                     if label in plain_s else "")
        print(f"solves/s, {label}, kernels, f32, B={Bn}: median "
              f"{rates[label]:.1f}, windows {[round(x, 1) for x in w]}"
              f"{plain_txt} [{card}]")
    e1_profile = print_profile("E1 HVAC-16", run_e1, card)
    phase.done("23. slice E solves/s and the E1 profile")
    return e1, e2, k7_k4, e1_profile, extra


def mpc_runner(env, x0, steps, config):
    """A closed-loop MPC run of ``steps`` control steps, plan horizon
    ``G3_PLAN_HORIZON``, synchronized."""
    import torch

    from tfmpc_tpu_torch.solvers import mpc

    def run():
        res = mpc.run(env, x0, steps=steps, plan_horizon=G3_PLAN_HORIZON,
                      config=config)
        torch.cuda.synchronize()
        return res

    return run


def cost_share(label, got, want, rtol, share):
    """Share of lanes whose realized total cost lies within ``rtol``
    relative of ``want``'s; raises below ``share``."""
    got, want = got.double(), want.double()
    rel = (got - want).abs() / want.abs()
    within = float((rel <= rtol).double().mean())
    print(f"  {label}: {within:.4f} of lanes within {rtol:g} relative "
          f"(gate >= {share}), largest rel diff {float(rel.max()):.3e}")
    if within < share:
        raise AssertionError(f"{label}: realized costs disagree")
    return within


def actions_gate(label, got, want):
    """Max-abs difference of two MPC runs' actions; raises past
    ``G3_ACTIONS_ATOL``."""
    err = float((got.double() - want.double()).abs().max())
    print(f"  {label}: actions max-abs diff {err:.3e} (gate "
          f"{G3_ACTIONS_ATOL:g})")
    if not err <= G3_ACTIONS_ATOL:
        raise AssertionError(f"{label}: actions disagree")
    return err


def slice_f(phase, timings, errs, launches_by_path, rates, card, nav_split):
    """Phases 24-27 (slice F): K8 against its plain version and K3, the G1
    and G2 fused solves against the split-kernel ones, the G3 MPC fleet,
    their rates and a G1 profile. ``nav_split`` is phase 4's
    ``(run, result, x0 numpy)`` of the split-kernel headline. Fills the
    dicts it is given; returns the slice's figures for the JSON line."""
    import numpy as np
    import torch

    from oracles import ilqr_navigation_oracle_np
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.solvers import ilqr_batched
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    # -- 24. K8 vs its plain version and K3 ----------------------------------
    for dtype in (torch.float32, torch.float64):
        print(f"slice F kernel K8 vs its plain version and K3, {dtype}:")
        f32 = (timings, errs) if dtype == torch.float32 else ()
        check_k8("navigation", dtype, *f32)
        check_k8("nav_bounded", dtype, *f32)
        check_k8("g3", dtype, *f32)
    phase.done("24. K8 vs its plain version and K3")

    # -- 25. G1: the headline with fuse_derivatives (slice F's main path) ----
    fused_kernels = {"riccati_backward", "linesearch_costs",
                     "rollout_alpha_derivs"}
    run_nav, res_nav, x0_np = nav_split
    nav = make_navigation(GOAL, ZONES, dtype=torch.float32, device="cuda")
    x0 = torch.as_tensor(x0_np, device="cuda")
    run_g1 = solver(nav, x0, T, ILQRConfig(**HEADLINE,
                                           fuse_derivatives=True))
    run_g1()
    print(f"G1, navigation headline T={T} B={B} with fuse_derivatives=True "
          "(slice F's main path):")
    passes = []
    derivatives = ilqr_batched.derivatives
    ilqr_batched.derivatives = lambda *a: (passes.append(1),
                                           derivatives(*a))[1]
    try:
        res, launches, plain = counted(run_g1)
    finally:
        ilqr_batched.derivatives = derivatives
    launches_by_path["g1_navigation_fused"] = launches
    require_path("G1 solve", launches, plain, fused_kernels)
    print(f"  derivatives passes in the solve: {len(passes)} (expected 1)")
    if len(passes) != 1:
        raise AssertionError("G1: the derivatives pass ran more than once")
    g1 = {"converged": check_result("G1", res, B, N, T)}
    if g1["converged"] < 0.99:
        raise AssertionError("G1 solve converged < 0.99")
    dev = 0.0
    for i in range(4):
        _, U_np, _ = ilqr_navigation_oracle_np(
            GOAL, ZONES["center"], ZONES["decay"], x0_np[i].astype(float), T,
            atol=1e-10,
        )
        dev = max(dev, float(np.abs(res.actions[i].cpu().numpy()
                                    - U_np).max()))
    print(f"  controls vs fp64 NumPy oracle (4 scenarios): max-abs "
          f"{dev:.3e} (target < 1e-4)")
    if dev >= 1e-4:
        raise AssertionError("G1 controls deviate from the fp64 oracle")
    g1["oracle_dev"] = dev
    agree_with_plain("G1", res, lambda: res_nav,
                     what="phase 4's split-kernel solve")
    phase.done("25. G1 navigation fused")

    # -- 26. G2: fused bounded navigation with boxQP -------------------------
    nav_b = bounded_env("nav_bounded", torch.float32)
    x0_b = torch.as_tensor(np.random.default_rng(0).uniform(
        -10.0, 10.0, (B_NAV_BOUNDED, N)).astype("float32"), device="cuda")
    g2_cfg = ILQRConfig(**HEADLINE, boxqp=True, fuse_derivatives=True)
    res, launches, plain = counted(solver(nav_b, x0_b, T_NAV_BOUNDED,
                                          g2_cfg))
    print(f"G2, bounded navigation T={T_NAV_BOUNDED} B={B_NAV_BOUNDED}, "
          "boxqp=True, fuse_derivatives=True:")
    launches_by_path["g2_nav_bounded_fused"] = launches
    require_path("G2 solve", launches, plain,
                 {"riccati_backward_boxqp", "linesearch_costs",
                  "rollout_alpha_derivs"})
    g2 = {"converged": check_result("G2", res, B_NAV_BOUNDED, N,
                                    T_NAV_BOUNDED)}
    agree_with_plain("G2", res, solver(
        nav_b, x0_b, T_NAV_BOUNDED,
        dataclasses.replace(g2_cfg, fuse_derivatives=False)),
        what="split-kernel solve (fuse_derivatives=False)")
    phase.done("26. G2 bounded navigation fused")

    # -- 27. G3: the MPC fleet -------------------------------------------------
    env3 = load_env(ROOT / "configs/navigation.json", dtype=torch.float32,
                    device="cuda")
    x0_cfg = np.asarray(json.loads((ROOT / "configs/navigation.json")
                                   .read_text())["x0"], dtype=np.float32)
    x0_fleet = x0_cfg[None, :] + np.random.default_rng(G3_SEED).normal(
        size=(B_G3, N)).astype(np.float32)
    x0_3 = torch.as_tensor(x0_fleet, device="cuda")
    g3_cfg = ILQRConfig(**G3_CONFIG)
    run_g3 = mpc_runner(env3, x0_3, G3_STEPS, g3_cfg)
    run_g3()
    print(f"G3, MPC fleet (configs/navigation.json, two zones), B={B_G3}, "
          f"{G3_STEPS} steps, plan horizon {G3_PLAN_HORIZON}, "
          "fuse_derivatives=True:")
    res, launches, plain = counted(run_g3)
    launches_by_path["g3_mpc_fused"] = launches
    require_path("G3 MPC", launches, plain, fused_kernels)
    if res.states.shape != (B_G3, G3_STEPS + 1, N) or not bool(
            torch.isfinite(res.total_cost).all()):
        raise AssertionError("G3: wrong shapes or non-finite costs")
    goal = torch.as_tensor(GOAL, device="cuda")
    g3 = {
        "mean_final_distance": float((res.states[:, -1] - goal).norm(dim=1)
                                     .double().mean()),
        "mean_total_cost": float(res.total_cost.double().mean()),
        "mean_iterations_per_replan": float(res.iterations.double().mean()),
        "converged_share": float(res.converged.double().mean()),
    }
    print(f"  {g3}")
    run_g3_split = mpc_runner(env3, x0_3, G3_STEPS, dataclasses.replace(
        g3_cfg, fuse_derivatives=False))
    res_s = run_g3_split()
    g3["vs_split"] = cost_share("G3 vs the split-kernel MPC",
                                res.total_cost, res_s.total_cost, 1e-4,
                                0.99)
    g3["actions_vs_split"] = actions_gate("G3 vs the split-kernel MPC",
                                          res.actions, res_s.actions)
    x0_64 = x0_3[:G3_PLAIN_B]
    res_k = mpc_runner(env3, x0_64, G3_PLAIN_STEPS, g3_cfg)()
    t0 = time.perf_counter()
    res_p = mpc_runner(env3, x0_64, G3_PLAIN_STEPS, dataclasses.replace(
        g3_cfg, use_pallas=False))()
    print(f"  plain MPC (use_pallas=False), first {G3_PLAIN_B} x0, "
          f"{G3_PLAIN_STEPS} steps: {time.perf_counter() - t0:.2f} s")
    g3["vs_plain"] = cost_share("G3 kernel MPC vs the plain MPC",
                                res_k.total_cost, res_p.total_cost, 1e-4,
                                0.99)
    g3["actions_vs_plain"] = actions_gate("G3 kernel MPC vs the plain MPC",
                                          res_k.actions, res_p.actions)
    phase.done("27. G3 MPC fleet")

    # rates, in turns on one card
    windows = {"navigation_split": [], "g1_navigation_fused": []}
    for label in ("navigation_split", "g1_navigation_fused",
                  "g1_navigation_fused", "navigation_split"):
        run = run_nav if label == "navigation_split" else run_g1
        windows[label] += solves_per_s(run, B)
    for label, w in windows.items():
        rates[label] = float(np.median(w))
        print(f"solves/s, {label}, kernels, T={T} B={B} f32, in turns: "
              f"median {rates[label]:.1f}, windows "
              f"{[round(x, 1) for x in w]} [{card}]")
    steps_s = {"g3_mpc_fused": [], "g3_mpc_split": []}
    for label in ("g3_mpc_fused", "g3_mpc_split", "g3_mpc_split",
                  "g3_mpc_fused"):
        run = run_g3 if label == "g3_mpc_fused" else run_g3_split
        t0 = time.perf_counter()
        run()
        steps_s[label].append(B_G3 * G3_STEPS / (time.perf_counter() - t0))
    for label, w in steps_s.items():
        rates[label + "_steps_per_s"] = float(np.median(w))
        print(f"closed-loop control steps/s, {label}, B={B_G3}, "
              f"{G3_STEPS} steps, in turns: {[round(x, 1) for x in w]} "
              f"[{card}]")
    g1_profile = print_profile("G1 navigation fused", run_g1, card)
    phase.done("27b. slice F rates and the G1 profile")
    return {"g1": g1, "g2": g2, "g3": g3, "g1_profile": g1_profile}


# -- slice G: the user surface ----------------------------------------------

# phase 28: the command line's batch sizes, and the two-process group's
G_NAV_B, G_HVAC_B, G_HVAC16_B, G_MPC_B, G_RESERVOIR_B = 1024, 256, 128, 256, 256
G_GLOO_B, G_GLOO_WORLD, G_GLOO_DEADLINE_S = 256, 2, 180.0
G_CLI_TIMEOUT_S = 300


def cli_call(argv, capture=()):
    """``cli.main(argv)`` in this process, its output captured; with
    ``capture`` (names of ``parallel/mesh.py`` functions), the result of
    each such call the command makes. Returns (exit code, output, {name:
    result})."""
    import contextlib
    import io

    from tfmpc_tpu_torch import cli
    from tfmpc_tpu_torch.parallel import mesh

    got, real = {}, {name: getattr(mesh, name) for name in capture}

    def keep(name):
        def call(*args, **kwargs):
            got[name] = real[name](*args, **kwargs)
            return got[name]
        return call

    for name in capture:
        setattr(mesh, name, keep(name))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
    finally:
        for name, fn in real.items():
            setattr(mesh, name, fn)
    out = buf.getvalue()
    print(f"  $ tfmpc-tpu-torch {' '.join(argv)}: exit {rc}; "
          + " | ".join(out.splitlines()[-2:]))
    if rc != 0:
        raise AssertionError(f"{argv}: exit code {rc}")
    return rc, out, got


def cli_line(pattern, out, what):
    import re

    m = re.search(pattern, out)
    if m is None:
        raise AssertionError(f"{what}: no line matching {pattern!r}")
    return m


def counted_cli(argv, capture=()):
    """``cli_call`` with every launch and plain-call counter set to 0 just
    before it and read just after."""
    (rc, out, got), launches, plain = counted(lambda: cli_call(argv, capture))
    return out, got, launches, plain


def cli_agree(label, res, res_p, share=0.99, cost_rtol=1e-4):
    """A command's solve against its ``--no-pallas`` run, ``PERF.md`` §2's
    gate: the same converged mask on >= ``share`` of lanes and the mean
    cost within ``cost_rtol`` over the lanes converged in both, or over
    every lane where none converged in both (both runs then stopped at the
    iteration cap)."""
    import torch

    same = float((res.converged == res_p.converged).float().mean())
    both = res.converged & res_p.converged
    lanes = both if bool(both.any()) else torch.ones_like(both)
    c_k = res.total_cost.double()[lanes]
    c_p = res_p.total_cost.double()[lanes]
    rel = abs(float(c_k.mean()) - float(c_p.mean())) / abs(float(c_p.mean()))
    which = "converged in both" if bool(both.any()) \
        else "(none converged in both: all)"
    print(f"  {label} vs --no-pallas: converged "
          f"{float(res.converged.float().mean()):.4f} vs "
          f"{float(res_p.converged.float().mean()):.4f}, same mask on "
          f"{same:.4f} of lanes; mean cost over {int(lanes.sum())} lanes "
          f"{which} {float(c_k.mean()):.6f} vs {float(c_p.mean()):.6f} (rel "
          f"diff {rel:.3e}, gate {cost_rtol:g})")
    if same < share or not rel <= cost_rtol:
        raise AssertionError(f"{label}: disagrees with --no-pallas")
    return {"same_mask": same, "mean_cost_rel": rel}


def gloo_rank(rank, world, port, x0, horizon, config, results):
    """One process of phase 28's two-process gloo group, on the one card:
    joins the group, solves its rows of ``x0`` through
    ``mesh.solve_ilqr_sharded`` (the kernels, counted), ``summarize``s
    over the group, and puts its lanes, statistics and counters on
    ``results``."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        import torch
        import torch.distributed as dist

        from tfmpc_tpu_torch.models.registry import load_env
        from tfmpc_tpu_torch.parallel import mesh
        from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

        device = mesh.init_multihost(
            device="cuda", backend="gloo", rank=rank, world_size=world,
            init_method=f"tcp://127.0.0.1:{port}")
        try:
            m = mesh.make_mesh(devices=device)
            env = load_env(ROOT / "configs/navigation.json", device=device)
            rows = x0.shape[0] // world
            local = x0[rank * rows:(rank + 1) * rows]

            def run():
                res = mesh.solve_ilqr_sharded(env, local, horizon=horizon,
                                              config=ILQRConfig(**config),
                                              mesh=m)
                torch.cuda.synchronize()
                return res

            res, launches, plain = counted(run)
            stats = mesh.summarize(res, m)
            results.put((rank, True, {
                "result": {f: v.cpu().numpy()
                           for f, v in zip(res._fields, res)},
                "stats": stats, "launches": launches, "plain": plain,
                "device": str(m.device), "backend": dist.get_backend()}))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: B902 - the parent reports it and fails
        results.put((rank, False, traceback.format_exc()))


def gloo_group(x0, horizon, config):
    """Phase 28's two processes (spawned, a free localhost port, both on
    card 0) run ``gloo_rank``; returns their reports by rank. Past
    ``G_GLOO_DEADLINE_S`` the children are killed and this raises."""
    import queue
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=gloo_rank, args=(
        rank, G_GLOO_WORLD, port, x0, horizon, config, results))
        for rank in range(G_GLOO_WORLD)]
    for p in procs:
        p.start()
    end, outs = time.monotonic() + G_GLOO_DEADLINE_S, {}
    try:
        while len(outs) < G_GLOO_WORLD:
            if time.monotonic() > end:
                raise AssertionError("the gloo group passed its deadline")
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise AssertionError("a gloo rank died before reporting")
                continue
            if not ok:
                raise AssertionError(f"gloo rank {rank} failed:\n{out}")
            outs[rank] = out
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [outs[r] for r in range(G_GLOO_WORLD)]


def slice_g(phase, launches_by_path, card):
    """Phase 28 (slice G): the command line in this process through
    ``cli.main`` with the launch counters, one ``python -m
    tfmpc_tpu_torch`` subprocess, and a two-process gloo group on the one
    card. Returns its figures."""
    import logging
    import tempfile

    import numpy as np
    import torch

    from tfmpc_tpu_torch.solvers import ilqr_batched

    batched = (r"solved (\d+) scenarios on 1 device\(s\): (\d+)/\d+ "
               r"converged, mean_cost=(\S+) mean_iterations=(\S+)")
    figures = {}
    nav = ["--env", str(ROOT / "configs/navigation.json")]
    nav_kernels = {"riccati_backward", "linesearch_costs_traj"}

    def with_plain(label, argv, capture, expect):
        """The command with the kernels (counted: ``expect`` ran, and
        nothing else) and with ``--no-pallas``: both outputs and the
        results of their ``mesh.<capture>`` calls."""
        out, got, launches, plain = counted_cli(argv, (capture,))
        launches_by_path[label] = launches
        require_path(label, launches, plain, expect)
        out_p, got_p, _, _ = counted_cli([*argv, "--no-pallas"], (capture,))
        return out, got[capture], got_p[capture], out_p

    # ilqr, the navigation batch: K1 and K5 + select
    argv = ["ilqr", *nav, "--num-samples", str(G_NAV_B)]
    out, res, res_p, _ = with_plain("cli_ilqr_navigation", argv,
                                    "solve_ilqr_sharded", nav_kernels)
    cli_line(batched, out, "ilqr navigation")
    check_result("CLI ilqr navigation", res, G_NAV_B, N)
    cli_agree("CLI ilqr navigation", res, res_p)

    # ilqr, HVAC-6 with boxQP by default and trajectory CSVs: K4 and K5
    with tempfile.TemporaryDirectory() as logdir:
        argv = ["ilqr", "--env", str(ROOT / "configs/hvac.json"),
                "--num-samples", str(G_HVAC_B), "-T", "50",
                "--logdir", logdir]
        out, got, launches, plain = counted_cli(argv)
        launches_by_path["cli_ilqr_hvac6"] = launches
        require_path("CLI ilqr HVAC-6", launches, plain,
                     {"riccati_backward_boxqp", "linesearch_costs_traj"})
        cli_line(batched, out, "ilqr hvac")
        csvs = sorted(Path(logdir).glob("trajectory_*.csv"))
        print(f"  {len(csvs)} trajectory CSVs written")
        if len(csvs) != G_HVAC_B:
            raise AssertionError("CLI ilqr HVAC-6: wrong number of CSVs")
        figures["hvac6_csvs"] = len(csvs)

    # ilqr, HVAC-16 with full DDP: the repaired route, the plain DDP
    # backward (counted here: no kernel wrapper runs it) and K5 + select
    real_backward, plain_backward = ilqr_batched.backward, [0]

    def counting_backward(*args, **kwargs):
        plain_backward[0] += 1
        return real_backward(*args, **kwargs)

    argv = ["ilqr", "--env", str(ROOT / "configs/hvac16.json"), "--ddp",
            "--num-samples", str(G_HVAC16_B), "-T", "20",
            "--max-iterations", "10"]
    ilqr_batched.backward = counting_backward
    try:
        out, res, res_p, _ = with_plain("cli_ilqr_hvac16_ddp", argv,
                                        "solve_ilqr_sharded",
                                        {"linesearch_costs_traj"})
    finally:
        ilqr_batched.backward = real_backward
    print(f"  plain DDP backward calls, kernel and --no-pallas runs: "
          f"{plain_backward[0]}")
    if plain_backward[0] == 0:
        raise AssertionError("CLI ilqr HVAC-16 --ddp: the plain backward "
                             "did not run")
    cli_line(batched, out, "ilqr hvac16 ddp")
    check_result("CLI ilqr HVAC-16 DDP", res, G_HVAC16_B, 16, 20)
    cli_agree("CLI ilqr HVAC-16 DDP", res, res_p)
    figures["hvac16_ddp_plain_backward_calls"] = plain_backward[0]

    # mpc, the navigation fleet: K1 and K5 + select each re-plan
    argv = ["mpc", *nav, "--num-samples", str(G_MPC_B), "--steps", "10"]
    out, res, res_p, _ = with_plain("cli_mpc_navigation", argv,
                                    "mpc_sharded", nav_kernels)
    cli_line(r"closed-loop fleet of \d+ on 1 device\(s\): mean_total_cost="
             r"(\S+) replans_converged=(\d+)/(\d+)", out, "mpc fleet")
    figures["mpc_vs_plain"] = cost_share(
        "CLI mpc fleet vs --no-pallas", res.total_cost, res_p.total_cost,
        1e-4, 0.99)

    # lqr, plain torch (no kernel, as in the JAX package)
    out, _, launches, plain = counted_cli(["lqr", "--num-samples", "8"])
    cli_line(r"solved 8 initial states: mean_cost=\S+ max_cost=\S+", out,
             "lqr")
    require_path("CLI lqr", launches, plain, set())

    # one subprocess: python -m tfmpc_tpu_torch (its own build cache hit)
    argv = [sys.executable, "-m", "tfmpc_tpu_torch", "ilqr", "--env",
            str(ROOT / "configs/reservoir.json"), "--num-samples",
            str(G_RESERVOIR_B), "-T", "50"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=G_CLI_TIMEOUT_S)
    print(f"  $ python -m tfmpc_tpu_torch ilqr --env configs/reservoir.json "
          f"--num-samples {G_RESERVOIR_B} -T 50: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {proc.stdout.strip()[-200:]}")
    if proc.returncode != 0:
        raise AssertionError(f"python -m tfmpc_tpu_torch failed:\n"
                             f"{proc.stderr[-2000:]}")
    cli_line(batched, proc.stdout, "python -m tfmpc_tpu_torch")

    # a two-process gloo group, both ranks on this card, against one process
    x0 = np.random.default_rng(0).uniform(-10.0, 10.0, (G_GLOO_B, N)).astype(
        "float32")
    t0 = time.perf_counter()
    outs = gloo_group(x0, T, HEADLINE)
    print(f"  gloo group of {G_GLOO_WORLD} on {outs[0]['device']} "
          f"({outs[0]['backend']}): {time.perf_counter() - t0:.1f} s")
    from tfmpc_tpu_torch.models.registry import load_env
    from tfmpc_tpu_torch.parallel import mesh
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = load_env(ROOT / "configs/navigation.json", device="cuda")
    one = mesh.make_mesh(devices="cuda")
    whole = mesh.solve_ilqr_sharded(env, x0, horizon=T,
                                    config=ILQRConfig(**HEADLINE), mesh=one)
    stats = mesh.summarize(whole, one)
    rows = G_GLOO_B // G_GLOO_WORLD
    for rank, out in enumerate(outs):
        launches_by_path[f"gloo_rank{rank}"] = out["launches"]
        require_path(f"gloo rank {rank}", out["launches"], out["plain"],
                     nav_kernels)
        for name, value in out["result"].items():
            want = getattr(whole, name)[rank * rows:(rank + 1) * rows]
            if not np.array_equal(value, want.cpu().numpy(),
                                  equal_nan=value.dtype.kind == "f"):
                raise AssertionError(f"gloo rank {rank}: lanes of {name} "
                                     "differ from the one-process solve")
        for key, value in stats.items():
            if abs(out["stats"][key] - value) > 1e-12 * abs(value):
                raise AssertionError(f"gloo rank {rank}: summarize {key} "
                                     f"{out['stats'][key]} vs {value}")
    print(f"  both ranks' lanes identical to the one-process solve of "
          f"{G_GLOO_B}; summarize equal within 1e-12: {stats}")
    figures["gloo_summarize"] = stats

    # -v: the trace path of a single solve (B=1 through the kernels)
    out, _, launches, plain = counted_cli(["-v", "ilqr", *nav])
    logging.getLogger("tfmpc_tpu_torch").setLevel(logging.WARNING)
    launches_by_path["cli_ilqr_verbose_b1"] = launches
    require_path("CLI -v ilqr (B=1 trace)", launches, plain, nav_kernels)
    cli_line(r"converged=True iterations=\d+", out, "-v ilqr")
    phase.done("28. slice G: the user surface")
    figures["seconds"] = phase.seconds["28. slice G: the user surface"]
    return figures


# -- phase 29: the generic form of K2, K3 and K5 -----------------------------

GENERIC_ENV_NAMES = {"double_integrator": "linear", "reservoir4": "reservoir",
                     "nav4": "navigation", "hvac24": "hvac",
                     "linear48": "linear", "linear24x6": "linear",
                     "reservoir12": "reservoir"}


def generic_kinds(config, horizon, n, m):
    """The rollout kernels a kernel-path solve at dims without an unrolled
    instantiation runs: the generic K5 on the emit-trajectories layout,
    else the generic K2 and K3 (AUTO resolved as the solver resolves
    it)."""
    from tfmpc_tpu_torch.solvers.ilqr_batched import _resolve_emit_traj

    if _resolve_emit_traj(config, horizon, n, m):
        return {"linesearch_costs_traj_generic"}
    return {"linesearch_costs_generic", "rollout_alpha_generic"}


def check_generic_kernels(case, dtype, Bn, Tn, timings=None, errs=None):
    """The generic K2, K3 and K5 at a ``GENERIC_KERNEL_CASES`` shape
    (``generic_inputs``), through the wrappers, which must launch the
    generic form: K5 against K2 and K3 bit for bit (as ``check_k5``), each
    against its plain version (K2 and K3 within ``TOL``; K5 within ``TOL``
    in float64 and by ``check_k5``'s share gate against the float64 plain
    version in float32), the fail masks (lanes whose J is not finite)
    identical in float64. With ``timings``, timed under
    ``<wrapper>_generic_<case>``."""
    import torch

    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    dn = dname(dtype)
    env, X, U, policy = generic_inputs(case, dtype, Bn, Tn)
    n, m = env.state_size, env.action_size
    label = f"generic {case} (n, m) = ({n}, {m}) B={Bn} T={Tn}"
    alphas = ILQRConfig().alphas_static()
    best = torch.arange(Bn, device="cuda") % A
    alpha_vec = ILQRConfig().alphas(dtype, device="cuda")[best]
    counts = lambda: (rollout.COSTS_GENERIC_LAUNCHES,  # noqa: E731
                      rollout.ALPHA_GENERIC_LAUNCHES,
                      rollout.TRAJ_GENERIC_LAUNCHES)
    before = counts()
    J2 = rollout.linesearch_costs(env, X, U, policy, alphas)
    X3, U3, J3 = rollout.rollout_alpha(env, X, U, policy, alpha_vec)
    J5, X5, U5 = rollout.linesearch_costs_traj(env, X, U, policy, alphas)
    if [a - b for a, b in zip(counts(), before)] != [1, 1, 1]:
        raise AssertionError(f"{label}: the wrappers did not launch the "
                             "generic form")
    sel = rollout.select_alpha_trajectory(X, X5, U5, J5, best)
    torch.cuda.synchronize()
    for what, got, want in (("K5 J vs K2", J5, J2),
                            ("K5 selected X vs K3", sel[0], X3),
                            ("K5 selected U vs K3", sel[1], U3),
                            ("K5 selected J vs K3", sel[2], J3)):
        same = torch.equal(got, want)
        print(f"  {label} {what} [{dn}]: bitwise equal {same} (gate)")
        if not same:
            raise AssertionError(f"{label} {what} [{dn}]: not bitwise equal")
    J2p = rollout.linesearch_costs_ref(env, X, U, policy, alphas)
    X3p, U3p, J3p = rollout.rollout_alpha_ref(env, X, U, policy, alpha_vec)
    J5p, X5p, U5p = rollout.linesearch_costs_traj_ref(env, X, U, policy,
                                                      alphas)
    torch.cuda.synchronize()
    if dtype == torch.float64:
        for what, k, p in (("K2", J2, J2p), ("K3", J3, J3p), ("K5", J5, J5p)):
            same = torch.equal(torch.isfinite(k), torch.isfinite(p))
            print(f"  {label} {what} fail mask (J not finite on "
                  f"{int((~torch.isfinite(p)).sum())} of {p.numel()}) [{dn}]: "
                  f"identical {same} (gate)")
            if not same:
                raise AssertionError(f"{label} {what}: fail masks differ")
    e2 = compare(f"{label} K2 J", J2, J2p, dn)
    e3 = max(compare(f"{label} K3 X", X3, X3p, dn),
             compare(f"{label} K3 U", U3, U3p, dn))
    compare(f"{label} K3 J", J3, J3p, dn)
    outs_k, outs_p = (J5, X5, U5), (J5p, X5p, U5p)
    e5 = max(float((k - p).abs().max()) for k, p in zip(outs_k, outs_p))
    if dtype == torch.float64:
        for what, k, p in zip(("J", "X", "U"), outs_k, outs_p):
            compare(f"{label} K5 {what}", k, p, dn)
    else:
        outs_r = rollout.linesearch_costs_traj_ref(
            generic_env(case, torch.float64), X.double(), U.double(),
            to64(policy), alphas)
        lanes = lambda o: (o[0], o[1].permute(3, 0, 1, 2),  # noqa: E731
                           o[2].permute(3, 0, 1, 2))
        ok = torch.ones(Bn, dtype=torch.bool, device="cuda")
        share_k = lane_share(lanes(outs_k), lanes(outs_r), ok, *K5_F32_TOL)
        share_p = lane_share(lanes(outs_p), lanes(outs_r), ok, *K5_F32_TOL)
        print(f"  {label} K5 [{dn}]: max abs err vs the plain version "
              f"{e5:.3e}; share of lanes within {K5_F32_TOL[0]:g} + "
              f"{K5_F32_TOL[1]:g}*|ref| of the float64 plain version: kernel "
              f"{share_k:.6f}, plain {share_p:.6f} (gate: kernel >= plain - "
              f"{K4_F32_SHARE_SLACK})")
        if share_k < share_p - K4_F32_SHARE_SLACK:
            raise AssertionError(f"{label} K5 [{dn}]: the kernel is less "
                                 "accurate than the plain version")
    if timings is None:
        return
    ra = rollout.kernel_args(env, X, U, policy)
    n_params = sum(p.numel() for p in ra["params"])
    bounded = env.bounds is not None
    env_name = GENERIC_ENV_NAMES[case]
    costs, alpha, traj = (f"{w}_generic_{case}" for w in (
        "linesearch_costs", "rollout_alpha", "linesearch_costs_traj"))
    errs.update({costs: e2, alpha: e3, traj: e5})
    a_vec = alpha_vec.contiguous()
    timings[costs] = (
        graph_ms(lambda: rollout.linesearch_costs_kernel(ra, alphas), 10),
        cuda_ms(lambda: rollout.linesearch_costs(env, X, U, policy, alphas),
                10),
        cuda_ms(lambda: rollout.linesearch_costs_ref(env, X, U, policy,
                                                     alphas), 2),
        bound(*rollout_work(Bn, Tn, n, m, 4, env_name, n_params, A, bounded,
                            False)),
    )
    timings[alpha] = (
        graph_ms(lambda: rollout.rollout_alpha_kernel(ra, a_vec), 10),
        cuda_ms(lambda: rollout.rollout_alpha(env, X, U, policy, alpha_vec),
                10),
        cuda_ms(lambda: rollout.rollout_alpha_ref(env, X, U, policy,
                                                  alpha_vec), 2),
        bound(*rollout_work(Bn, Tn, n, m, 4, env_name, n_params, 1, bounded,
                            True)),
    )
    timings[traj] = (
        graph_ms(lambda: rollout.linesearch_costs_traj_kernel(ra, alphas),
                 10),
        cuda_ms(lambda: rollout.linesearch_costs_traj(env, X, U, policy,
                                                      alphas), 10),
        cuda_ms(lambda: rollout.linesearch_costs_traj_ref(env, X, U, policy,
                                                          alphas), 2),
        bound(*traj_work(Bn, Tn, n, m, 4, env_name, n_params, A, bounded)),
    )
    plans = {k: rollout.launch_plan(ra, k, A) for k in ("costs", "alpha",
                                                        "traj")}
    for (key, k), p in zip(((costs, "costs"), (alpha, "alpha"),
                            (traj, "traj")), plans.values()):
        k_ms, w_ms, p_ms, (b_ms, b_by) = timings[key]
        print(f"  {label} {KERNEL_NAMES[k]} f32, plan G={p.groups}, "
              f"{p.scenarios} a block, D={p.depth}: kernel {k_ms:.4f} ms "
              f"(graph replays), wrapper {w_ms:.4f} ms, plain {p_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by})")


def di_lqr_check(res32, x0, horizon, cfg=HEADLINE,
                 backward="riccati_backward_mid"):
    """The double integrator's controls against the exact LQR
    (``solvers/lqr.py``) in float64 on its first ``DI_LQR_B`` scenarios:
    the same solve (``cfg``, at atol 1e-10) through the kernels in float64
    (``backward`` and the generic rollouts, counted) and the f32 solve's,
    each within ``DI_LQR_ATOL`` max-abs. Returns both deviations."""
    import torch

    from tfmpc_tpu_torch.solvers import ilqr, lqr
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env64 = generic_env("double_integrator", torch.float64)
    x0_64 = x0[:DI_LQR_B].double()
    _, U_l, _ = lqr.solve(env64.to_lqr_problem(horizon), x0_64)
    config = ILQRConfig(**{**cfg, "atol": 1e-10})
    res64, launches, plain = counted(lambda: ilqr.solve_batch(
        env64, x0_64, horizon=horizon, config=config))
    require_path("double integrator f64 solve", launches, plain,
                 {backward} | generic_kinds(config, horizon, 2, 1))
    dev64 = float((res64.actions - U_l).abs().max())
    dev32 = float((res32.actions[:DI_LQR_B].double() - U_l).abs().max())
    print(f"  double integrator controls vs the exact LQR in float64 "
          f"({DI_LQR_B} scenarios): f64 kernel solve max-abs {dev64:.3e}, "
          f"f32 kernel solve {dev32:.3e} (gates < {DI_LQR_ATOL:g})")
    if not (dev64 < DI_LQR_ATOL and dev32 < DI_LQR_ATOL):
        raise AssertionError("double integrator: controls deviate from the "
                             "exact LQR")
    return {"f64": dev64, "f32": dev32}


def generic_vs_unrolled(card):
    """The price of generality: the generic form beside the unrolled
    instantiation that runs there, K2, K3 and K5 at HVAC-6 (B=2048, T=100)
    and E1's shape (HVAC-16, B=512, T=50), f32, ``boxqp_inputs``; the same
    outputs (within ``TOL``, and whether bit for bit), device times of
    graph replays, in turns (unrolled, generic, generic, unrolled; best of
    two). The unrolled kernel stays the route there."""
    import torch

    from tfmpc_tpu_torch.ops import _build, rollout
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    out = {}
    for case, Bn, Tn in (("hvac6", B_BOX, T), ("hvac16", B_E1, T_E1)):
        env, X, U, _, _, _, _, policy = boxqp_inputs(case, torch.float32,
                                                     Bn, Tn)
        a = rollout.kernel_args(env, X, U, policy)
        n = env.state_size
        alphas = ILQRConfig().alphas_static()
        a_vec = ILQRConfig().alphas(torch.float32, device="cuda")[
            torch.arange(Bn, device="cuda") % A].contiguous()
        opts = dict(dtype=torch.float32, device="cuda")
        for kind in ("costs", "alpha", "traj"):
            per = A if kind in rollout.EVERY_ALPHA else 1
            plan = rollout.generic_launch_plan(a, kind, per)
            if kind == "costs":
                outs = (torch.empty((A, Bn), **opts),)
                unrolled = lambda: rollout.linesearch_costs_kernel(  # noqa
                    a, alphas)
                generic = lambda: rollout._launch_generic(  # noqa: E731
                    a, "costs", plan, outs[0], alphas=alphas)
            elif kind == "alpha":
                outs = (torch.empty((Tn, n, Bn), **opts),
                        torch.empty((Tn, n, Bn), **opts),
                        torch.empty((Bn,), **opts))    # X, U, J
                unrolled = lambda: rollout.rollout_alpha_kernel(  # noqa
                    a, a_vec)
                generic = lambda: rollout._launch_generic(  # noqa: E731
                    a, "alpha", plan, outs[2], outs[0], outs[1],
                    alpha=a_vec)
            else:
                outs = (torch.empty((A, Bn), **opts),
                        torch.empty((Tn, A * n, Bn), **opts),
                        torch.empty((Tn, A * n, Bn), **opts))
                unrolled = lambda: rollout.linesearch_costs_traj_kernel(  # noqa
                    a, alphas)
                generic = lambda: rollout._launch_generic(  # noqa: E731
                    a, "traj", plan, *outs, alphas=alphas)
            want = unrolled()
            want = want if isinstance(want, tuple) else (want,)
            _build.check(generic(), "generic " + kind)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(outs, want))
            err = max(compare(f"generic vs unrolled {KERNEL_NAMES[kind]} "
                              f"{case} output {i}", g, w, "float32")
                      for i, (g, w) in enumerate(zip(outs, want)))
            t_u = [graph_ms(unrolled, 10)]
            t_g = [graph_ms(generic, 10), graph_ms(generic, 10)]
            t_u.append(graph_ms(unrolled, 10))
            u_plan = rollout.launch_plan(a, kind, per)
            key = f"{KERNEL_NAMES[kind]}_{case}"
            out[key] = {"unrolled_ms": min(t_u), "generic_ms": min(t_g),
                        "bitwise_equal": same, "max_abs_err": err,
                        "generic_plan": [plan.groups, plan.scenarios,
                                         plan.depth],
                        "unrolled_plan": [u_plan.groups, u_plan.scenarios,
                                          u_plan.depth]}
            print(f"  {KERNEL_NAMES[kind]} {case} (B={Bn}, T={Tn}, n=m={n}, "
                  f"f32): unrolled {min(t_u):.4f} ms (G={u_plan.groups}, "
                  f"{u_plan.scenarios} a block), generic {min(t_g):.4f} ms "
                  f"(G={plan.groups}, {plan.scenarios} a block, "
                  f"D={plan.depth}), ratio {min(t_g) / min(t_u):.2f}; "
                  f"outputs bitwise equal {same} [{card}]")
    return out


def slice_generic(phase, timings, errs, launches_by_path, plain_s, card):
    """Phase 29: the generic form of K2, K3 and K5 (csrc/
    rollout_generic.cuh) at ``GENERIC_KERNEL_CASES``' shapes against its
    plain versions in float32 and float64 (``check_generic_kernels``,
    timed in f32), then each ``GENERIC_PATHS`` solve on AUTO (counted: the
    routed Riccati kernel and the generic rollouts, nothing else, no plain
    version) against its plain path and on the other line-search layout,
    the double integrator against the exact LQR; then the generic form
    beside the unrolled one at HVAC-6 and E1's shape. Returns its
    figures."""
    import torch

    from tfmpc_tpu_torch.solvers import ilqr_batched
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    figures = {"paths": {}}
    for case, (Bn, Tn) in GENERIC_KERNEL_CASES.items():
        for dtype in (torch.float32, torch.float64):
            f32 = (timings, errs) if dtype == torch.float32 else ()
            check_generic_kernels(case, dtype, Bn, Tn, *f32)
    for label, (Bn, Tn, cfg) in GENERIC_PATHS.items():
        env = generic_env(label, torch.float32)
        n, m = env.state_size, env.action_size
        x0 = generic_x0(label, Bn, torch.float32)
        config = ILQRConfig(**cfg)
        mode = ilqr_batched._riccati_kernel_mode(n, m, config, "cuda")
        backward = {"lane": "riccati_backward",
                    "mid": "riccati_backward_mid"}[mode] + (
            "_boxqp" if config.boxqp and env.bounds is not None else "")
        emit = ilqr_batched._resolve_emit_traj(config, Tn, n, m)
        layout, other = ("emit", "two_kernel") if emit else ("two_kernel",
                                                             "emit")
        print(f"generic path {label}, (n, m) = ({n}, {m}), B={Bn}, T={Tn}, "
              f"f32, AUTO's layout {layout}:")
        res, launches, plain = counted(solver(env, x0, Tn, config))
        launches_by_path[f"generic_{label}_{layout}"] = launches
        require_path(f"{label} solve", launches, plain,
                     {backward} | generic_kinds(config, Tn, n, m))
        conv = check_result(label, res, Bn, n, Tn, m)
        plain_s[f"generic_{label}"] = agree_with_plain(label, res, solver(
            env, x0, Tn, dataclasses.replace(config, use_pallas=False)))
        other_cfg = dataclasses.replace(config,
                                        linesearch_emit_trajectories=not emit)
        launches_by_path[f"generic_{label}_{other}"] = layouts_agree(
            label, res, solver(env, x0, Tn, other_cfg), backward,
            line_search=tuple(generic_kinds(other_cfg, Tn, n, m)),
            what=f"the {other} layout")
        figures["paths"][label] = {
            "converged": conv, "failed": float(res.failed.float().mean()),
            "mean_iterations": float(res.iterations.float().mean()),
            "mean_cost": float(res.total_cost.double().mean()),
            "auto_layout": layout}
        if label == "double_integrator":
            figures["double_integrator_vs_lqr"] = di_lqr_check(res, x0, Tn)
    figures["generic_vs_unrolled"] = generic_vs_unrolled(card)
    phase.done("29. the generic form of K2, K3 and K5")
    return figures


# -- phase 30: full DDP and K8 at every dim up to 12 ---------------------------

# K7's full-DDP variants against their plain versions: on envs' dynamics
# Hessians along a random nominal (reservoir-4, the 12-room ring, navigation
# in 12 dims, the double integrator, whose Hessians are 0) and on seeded
# synthetic ones at (4, 4), (12, 12), (7, 3) and (2, 1), T=6 (as K7's
# synthetic checks), at the scale that leaves 64-99% of the lanes PD
# in the plain versions in float64 (set on the CPU from
# ``synthetic_mid_inputs``' linearization; five more lanes forced
# indefinite each), at a batch K7's plan leaves block-ragged (four teams a
# block, one in the last)
DDP_MID_ENV_CASES = (("reservoir4", (4, 4)), ("hvac12ring", (12, 12)),
                     ("nav12", (12, 12)), ("double_integrator", (2, 1)))
DDP_MID_SYNTHETIC_SCALE = {(4, 4): 0.05, (12, 12): 0.03, (7, 3): 0.05,
                           (2, 1): 0.2}
DDP_MID_RAGGED = (401, 6)
# the generic K8 against its plain version and the generic K3: navigation
# in these dims (the headline's goal and zone, or configs/navigation.json's
# two, padded with 2.0 and 0.0), at a block-ragged batch under its plan
K8_GENERIC_DIMS = (1, 4, 7, 12)
K8_GENERIC_RAGGED = (401, 20)
# the paths, f32: label -> (env, B, T, config). D3: suite config 4c at four
# reservoirs; D4: the 12-room ring (E2's env) with full DDP and boxQP, at
# full DDP's iteration cap (50, the DDP headline's; at E2's 30 a share of
# the lanes stops at the cap, where the f32 plain path and the kernels
# stop at different iterates); D5: navigation
# in 12 dims (one zone) with full DDP; the double integrator with full DDP
# (linear dynamics: its controls are the exact LQR's); G4: navigation in 4
# dims, fused; G5: navigation in 12 dims in the box +-1, fused with boxQP
DDP_MID_PATHS = {
    "d3_reservoir4_ddp": ("reservoir4", 2048, 100, DDP_BOXQP),
    "d4_hvac12_ddp": ("hvac12ring", 512, 50,
                      dict(E2_CONFIG, ddp=True, max_iterations=50)),
    "d5_nav12_ddp": ("nav12", 1024, 50, DDP_HEADLINE),
    "double_integrator_ddp": ("double_integrator", 4096, 100, DDP_HEADLINE),
}
FUSED_MID_PATHS = {
    "g4_nav4_fused": ("nav4", 4096, 100,
                      dict(HEADLINE, fuse_derivatives=True)),
    "g5_nav12_box_fused": ("nav12_box", 1024, 50,
                           dict(HEADLINE, boxqp=True,
                                fuse_derivatives=True)),
}
# D5's first scenarios in float64 against the fp64 navigation oracle
D5_ORACLE_B = 4
# D4 is not held against its plain path here: the f32 plain DDP + boxQP
# backward at n = 12 takes ~1 s an attempt at T=50 and D4 makes ~7 attempts
# an iteration (its restarts gather at most 128 failing lanes a round), so
# the plain solve took 237 s on one H100 (PR 13 call 3: the same converged
# mask on every lane, mean cost within 2.3e-7) and 69 s on its first 128
# scenarios (call 6: every lane, 1.4e-6), a fifth of the script's time
# limit; a shorter horizon leaves other lanes unconverged at the cap on
# each path (calls 4, 5). It is held to E1's release gate instead (>= 0.98
# converged, 0 failed), and its backward to its plain version at these
# dims in 30a (the ring's Hessians, both dtypes).
NO_PLAIN_CHECK = ("d4_hvac12_ddp",)
# D4's solve takes ~6 s, longer than a rate window: its rate is its
# counted solve's
SOLVE_RATE = ("d4_hvac12_ddp",)


def phase30_env(case, dtype, device="cuda"):
    """The env of a phase-30 case: ``generic_env``'s (``reservoir4``,
    ``double_integrator``, ``nav4``), the 12-room ring (``hvac12ring``) or
    navigation in k dims, ``nav<k>`` (one zone), ``nav<k>_2z`` (two) or
    ``nav<k>_box`` (one, in the box +-1): the headline's goal and zone, or
    configs/navigation.json's two zones, padded to k dims with 2.0 (goal)
    and 0.0 (centers), cut at k = 1."""
    from tfmpc_tpu_torch.models.navigation import make_navigation

    if case == "hvac12ring":
        return hvac_ring(12, dtype, device)
    if not case.startswith("nav") or case == "nav4":
        return generic_env(case, dtype, device)
    k, _, kind = case[3:].partition("_")
    k = int(k)
    pad = lambda v, fill: (list(v) + [fill] * k)[:k]  # noqa: E731
    centers = [[3.0, -2.0], [6.0, -4.0]] if kind == "2z" else [[3.0, -2.0]]
    decays = [2.0, 1.5] if kind == "2z" else [2.0]
    box = dict(low=-1.0, high=1.0) if kind == "box" else {}
    return make_navigation(pad(GOAL, 2.0), {
        "center": [pad(c, 0.0) for c in centers], "decay": decays}, **box,
        dtype=dtype, device=device)


def phase30_x0(case, Bn, dtype, device="cuda"):
    """A phase-30 solve's initial states [Bn, n] from ``default_rng(0)``:
    ``generic_x0``'s, U(8, 18) for the ring, U(-10, 10) for navigation."""
    import numpy as np
    import torch

    if case in ("reservoir4", "double_integrator", "nav4"):
        return generic_x0(case, Bn, dtype, device)
    n = phase30_env(case, dtype, "cpu").state_size
    lohi = (8.0, 18.0) if case == "hvac12ring" else (-10.0, 10.0)
    x0 = np.random.default_rng(0).uniform(*lohi, (Bn, n))
    return torch.as_tensor(x0.astype("float32"), dtype=dtype, device=device)


def ddp_mid_inputs(case, dims, dtype, Bn, Tn):
    """The inputs of a K7 full-DDP check: (label, lin, quad, final, mu,
    bounds, Ubar, second, boxqp_iters). An env case: a random nominal of
    ``phase30_env(case)`` from its solve's x0 (controls ~ U(0, 4) clipped
    where bounded, else 0.1 N(0, 1)), its linearization and dynamics
    Hessians, mu ~ U(0, 0.5), its box (navigation and the double
    integrator: +-1), 8 boxQP iterations. ``"synthetic"``:
    ``synthetic_mid_inputs`` at ``dims`` with seeded random Hessians at
    ``DDP_MID_SYNTHETIC_SCALE`` (symmetric in their derivative indices), 4
    boxQP iterations."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Bounds, SecondOrderModel
    from tfmpc_tpu_torch.solvers.ilqr import second_derivatives

    n, m = dims
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    if case == "synthetic":
        lin, quad, final, mu, bounds, U = synthetic_mid_inputs(n, m, dtype,
                                                               Bn, Tn)
        c = DDP_MID_SYNTHETIC_SCALE[dims]
        rng = np.random.default_rng(13 * n + m)
        sym = lambda a: 0.5 * (a + a.transpose(-1, -2))  # noqa: E731
        second = SecondOrderModel(
            f_xx=sym(t(c * rng.standard_normal((Bn, Tn, n, n, n)))),
            f_ux=t(c * rng.standard_normal((Bn, Tn, n, m, n))),
            f_uu=sym(t(c * rng.standard_normal((Bn, Tn, n, m, m)))))
        return (f"synthetic ({n}, {m})", lin, quad, final, mu, bounds, U,
                second, 4)
    env = phase30_env(case, dtype)
    rng = np.random.default_rng(14)
    bounded = env.bounds is not None
    U = env.clip(t(rng.uniform(0.0, 4.0, (Bn, Tn, m)))) if bounded \
        else t(0.1 * rng.standard_normal((Bn, Tn, m)))
    X, _ = env.rollout(phase30_x0(case, Bn, dtype), U)
    lin, quad, final = env.analytic_derivatives(X, U)
    one = torch.ones(m, dtype=dtype, device="cuda")
    bounds = env.bounds if bounded else Bounds(low=-one, high=one)
    return (case, lin, quad, final, t(rng.uniform(0.0, 0.5, Bn)), bounds, U,
            second_derivatives(env, X, U), 8)


def check_k7_ddp(case, dims, dtype, Bn=None, Tn=None, timings=None,
                 errs=None, name_suffix="", timed=("ddp", "ddp_boxqp")):
    """K7's full-DDP variants (K6a's and K6b's contracts) through their
    wrappers, which must launch them, against their plain versions on
    ``ddp_mid_inputs(case, dims)`` (``DDP_MID_RAGGED`` by default, the
    plan checked to leave the last block part-full) with five lanes
    forced indefinite: ``hold_backward``'s gates (identical ok masks and
    the ok lanes within tolerance in float64, the boxQP variant's share
    gate on an env's inputs set by the plain version's own agreement
    across the card and the CPU; the float32 share rule against the
    float64 plain version). With
    ``timings``: kernel (graph replays), wrapper and plain times and the
    bounds (the Hessians' bytes counted) of the ``timed`` variants on the
    unforced inputs, under ``riccati_backward_mid_ddp[_boxqp]`` +
    ``name_suffix``."""
    import torch

    from tfmpc_tpu_torch.ops import riccati_mid as rm

    n, m = dims
    Bn, Tn = (Bn, Tn) if Bn else DDP_MID_RAGGED
    plan = rm.mid_plan(n, m, Bn, dtype)
    tail = Bn - (plan.blocks(Bn) - 1) * plan.scenarios
    label, lin, quad, final, mu, bounds, U, second, iters = ddp_mid_inputs(
        case, dims, dtype, Bn, Tn)
    label = f"K7-DDP {label} (n, m) = {dims} B={Bn} T={Tn}"
    print(f"  {label} {dname(dtype)}: plan {plan.warps} warp(s) a team, "
          f"{plan.scenarios} teams a block, {tail} in the last block")
    if timings is None and tail == plan.scenarios:
        raise AssertionError(f"{label}: the batch is not block-ragged")
    quad_b, mu_b, bad = force_indefinite(quad, mu, m)
    args = (lin, quad_b, final, mu_b)
    args64 = (to64(lin), to64(quad_b), to64(final), mu_b.double())
    box, box64 = (bounds, U), (to64(bounds), U.double())
    sec64 = to64(second)
    for variant in ("ddp", "ddp_boxqp"):
        counter = "MID_DDP_LAUNCHES" if variant == "ddp" \
            else "MID_DDP_BOXQP_LAUNCHES"
        before = getattr(rm, counter)
        if variant == "ddp":
            run = lambda: rm.riccati_backward_mid_ddp(  # noqa: E731
                *args, second)
            plain = lambda st: rm.riccati_backward_mid_ddp_ref(  # noqa
                *args, second)
            ref64 = lambda: rm.riccati_backward_mid_ddp_ref(  # noqa: E731
                *args64, sec64)
            plain_cpu = None
        else:
            run = lambda: rm.riccati_backward_mid_ddp_boxqp(  # noqa: E731
                *args, *box, second, iters)
            plain = lambda st: rm.riccati_backward_mid_ddp_boxqp_ref(  # noqa
                *args, *box, second, iters, stats=st)
            ref64 = lambda: rm.riccati_backward_mid_ddp_boxqp_ref(  # noqa
                *args64, *box64, sec64, iters)
            plain_cpu = None
            if dtype == torch.float64 and case != "synthetic":
                plain_cpu = lambda: rm.riccati_backward_mid_ddp_boxqp_ref(  # noqa
                    *(to_cpu(a) for a in args + box + (second,)), iters)
        err, _ = hold_backward(f"{label} {variant}", dtype, run, plain, ref64,
                               variant == "ddp_boxqp", bad, plain_cpu)
        if getattr(rm, counter) != before + 1:
            raise AssertionError(f"{label} {variant}: the wrapper did not "
                                 "launch K7's DDP variant")
        if timings is None or variant not in timed:
            continue
        a = rm.mid_layout(lin, quad, final, mu, bounds, U, second)
        if variant == "ddp":
            name = "riccati_backward_mid_ddp"
            work = k6a_work(Bn, Tn, n, m, 4)
            kargs = [a[k] for k in rm.MID_DDP_ARGS]
            launch = lambda: rm.riccati_backward_mid_ddp_kernel(  # noqa
                *kargs)
            wrap = lambda: rm.riccati_backward_mid_ddp(  # noqa: E731
                lin, quad, final, mu, second)
            ref = lambda: rm.riccati_backward_mid_ddp_ref(  # noqa: E731
                lin, quad, final, mu, second)
        else:
            stats = {}
            rm.riccati_backward_mid_ddp_boxqp_ref(lin, quad, final, mu,
                                                  bounds, U, second, iters,
                                                  stats=stats)
            name = "riccati_backward_mid_ddp_boxqp"
            work = k6b_work(Bn, Tn, n, m, 4, stats["newton_iterations"])
            kargs = [a[k] for k in rm.MID_DDP_BOXQP_ARGS]
            launch = lambda: rm.riccati_backward_mid_ddp_boxqp_kernel(  # noqa
                *kargs, boxqp_iters=iters)
            wrap = lambda: rm.riccati_backward_mid_ddp_boxqp(  # noqa: E731
                lin, quad, final, mu, bounds, U, second, iters)
            ref = lambda: rm.riccati_backward_mid_ddp_boxqp_ref(  # noqa
                lin, quad, final, mu, bounds, U, second, iters)
        key = name + name_suffix
        errs[key] = err
        timings[key] = (graph_ms(launch, 5), cuda_ms(wrap, 5),
                        cuda_ms(ref, 1), bound(*work))
        b64, by64 = bound(*work, "float64")
        k_ms = timings[key][0]
        b_ms, b_by = timings[key][3]
        print(f"  {key} (B={Bn}, T={Tn}, f32, plan {plan.warps} warp(s) x "
              f"{rm.mid_plan(n, m, Bn, torch.float32).scenarios}): kernel "
              f"{k_ms:.4f} ms (graph replays), wrapper {timings[key][1]:.4f}"
              f" ms, plain {timings[key][2]:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}) at the f32 peak, {b64:.4f} ms ({by64}) at the FP64 "
              f"peak: {b64 / k_ms:.4f} of it")


def k8_generic_inputs(case, dtype, Bn, Tn):
    """Generic K8's inputs: navigation ``phase30_env(case)`` from x0 ~
    U((1, -6), (8, 0)) in its first two dims (the box that holds both
    zones; U(1, 8) at n = 1) and U(-0.2, 0.2) in the others, controls ~
    0.5 N(0, 1) (0.1 N(0, 1) past the first two dims, where the zones'
    centers are 0; clipped where bounded), a feedback policy with K ~ 0.05
    N(0, 1) / sqrt(n) and k ~ the controls' law, lane z started on zone
    z's center, each lane's alpha from the grid; ``k8_inputs``' tuple."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.core.types import Policy
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = phase30_env(case, dtype)
    n = env.state_size
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")  # noqa: E731
    rng = np.random.default_rng(15 + n)
    lo = ([1.0, -6.0] + [-0.2] * n)[:n]
    hi = ([8.0, 0.0] + [0.2] * n)[:n]
    scale = np.asarray(([0.5, 0.5] + [0.1] * n)[:n])
    x0 = t(rng.uniform(lo, hi, (Bn, n)))
    x0[:env.centers.shape[0]] = env.centers
    U = env.clip(t(scale * rng.standard_normal((Bn, Tn, n))))
    X, _ = env.rollout(x0, U)
    policy = Policy(K=t(0.05 / np.sqrt(n)
                        * rng.standard_normal((Bn, Tn, n, n))),
                    k=t(scale * rng.standard_normal((Bn, Tn, n))))
    alpha_vec = ILQRConfig().alphas(dtype, device="cuda")[
        torch.arange(Bn, device="cuda") % A]
    return env, X, U, policy, alpha_vec


def check_k8_generic(case, dtype, Bn=None, Tn=None, timings=None,
                     errs=None, key=None):
    """``check_k8`` of the generic K8 on ``k8_generic_inputs(case)``
    (``K8_GENERIC_RAGGED`` by default, the plan checked to leave the last
    block part-full), which must launch the generic form (K8 and its K3)
    and no unrolled kernel; the K3 it is held against bit for bit is the
    generic one. With ``timings``: timed under ``key``."""
    from tfmpc_tpu_torch.ops import rollout

    Bn, Tn = (Bn, Tn) if Bn else K8_GENERIC_RAGGED
    inputs = k8_generic_inputs(case, dtype, Bn, Tn)
    env, X, U, policy, _ = inputs
    plan = rollout.launch_plan(
        rollout.kernel_args(env, X, U, policy, derivatives=True), "derivs")
    tail = Bn - (plan.blocks(Bn) - 1) * plan.scenarios
    print(f"  generic K8 {case} B={Bn} T={Tn} [{dname(dtype)}]: plan "
          f"G={plan.groups}, {plan.scenarios} a block, D={plan.depth}, "
          f"{tail} in the last block")
    if not plan.generic or (timings is None and tail == plan.scenarios):
        raise AssertionError(f"generic K8 {case}: not the generic form, or "
                             "the batch is not block-ragged")
    counts = lambda: (rollout.DERIVS_GENERIC_LAUNCHES,  # noqa: E731
                      rollout.ALPHA_GENERIC_LAUNCHES,
                      rollout.DERIVS_LAUNCHES, rollout.ALPHA_LAUNCHES)
    before = counts()
    check_k8(f"{case} (generic) B={Bn} T={Tn}", dtype, timings, errs,
             inputs, key, (20, 2))
    launched = [x - y for x, y in zip(counts(), before)]
    if not (launched[0] >= 2 and launched[1] >= 1 and launched[2:] == [0, 0]):
        raise AssertionError(f"generic K8 {case}: launches {launched} (the "
                             "generic K8 and K3, no unrolled kernel)")


def time_k7_lanes(case, Bn, Tn, boxqp, timings, errs, key):
    """K7 (iLQR, or boxQP) as the fused iteration runs it at a G4/G5
    shape, on the blocks of a random nominal of ``phase30_env(case)`` in
    the kernel layout: ``riccati.riccati_backward_lanes`` (K7 through the
    layout round trip) must give K7's own wrapper's outputs on the same
    values in the solver layout bit for bit; its largest K/k difference
    from the plain version in float64 (K7 computes in double) on the lanes
    ok in both is printed. Timed under ``key``: the raw launch (graph
    replays), the kernel-layout wrapper and the plain version."""
    import torch

    from tfmpc_tpu_torch.ops import riccati, riccati_mid as rm, rollout
    from tfmpc_tpu_torch.solvers import ilqr_batched

    env, X, U, policy, alpha_vec = k8_generic_inputs(case, torch.float32, Bn,
                                                     Tn)
    n, m = env.state_size, env.action_size
    ka = ilqr_batched._initial_kargs(env, X, U)
    VT, vT = ilqr_batched._final_klayout(env, X[:, -1])
    mu = torch.full((Bn,), 0.1, device="cuda")
    box = None
    if boxqp:
        box = (U.permute(1, 2, 0).contiguous(),
               env.bounds.low.contiguous(), env.bounds.high.contiguous())
    lin, quad, final = env.analytic_derivatives(X, U)
    a = rm.mid_layout(lin, quad, final, mu, env.bounds if boxqp else None,
                      U if boxqp else None)
    args64 = (to64(lin), to64(quad), to64(final), mu.double())
    if boxqp:
        launch = lambda: rm.riccati_backward_mid_boxqp_kernel(  # noqa: E731
            *(a[k] for k in rm.MID_BOXQP_ARGS))
        ref = lambda: rm.riccati_backward_mid_boxqp_ref(  # noqa: E731
            lin, quad, final, mu, env.bounds, U)
        ref64 = lambda: rm.riccati_backward_mid_boxqp_ref(  # noqa: E731
            *args64, to64(env.bounds), U.double())
        stats = {}
        rm.riccati_backward_mid_boxqp_ref(lin, quad, final, mu, env.bounds,
                                          U, stats=stats)
        work = k4_work(Bn, Tn, n, m, 4, stats["newton_iterations"])
    else:
        launch = lambda: rm.riccati_backward_mid_kernel(  # noqa: E731
            *(a[k] for k in rm.MID_ARGS))
        ref = lambda: rm.riccati_backward_mid_ref(lin, quad, final, mu)  # noqa
        ref64 = lambda: rm.riccati_backward_mid_ref(*args64)  # noqa: E731
        work = k1_work(Bn, Tn, n, m, 4)
    wrap = lambda: riccati.riccati_backward_lanes(ka, VT, vT, mu, box)  # noqa
    ok_k, pol_lane, dv1_k, dv2_k = wrap()
    pol_k = rollout.policy_from_lanes(pol_lane)
    if boxqp:
        ok_s, pol_s, dv1_s, dv2_s = rm.riccati_backward_mid_boxqp(
            lin, quad, final, mu, env.bounds, U)
    else:
        ok_s, pol_s, dv1_s, dv2_s = rm.riccati_backward_mid(lin, quad, final,
                                                            mu)
    ok_p, pol_p, _, _ = ref64()
    torch.cuda.synchronize()
    same = torch.equal(ok_k, ok_s) and all(torch.equal(x, y) for x, y in (
        (pol_k.K, pol_s.K), (pol_k.k, pol_s.k), (dv1_k, dv1_s),
        (dv2_k, dv2_s)))
    both = ok_k & ok_p
    err = max(float((pol_k.K.double() - pol_p.K)[both].abs().max()),
              float((pol_k.k.double() - pol_p.k)[both].abs().max()))
    what = f"K7-{'boxQP' if boxqp else 'iLQR'} in the kernel layout"
    print(f"  {what}, {case} B={Bn} T={Tn} f32: equal to K7's wrapper on the "
          f"solver layout bit for bit {same} (gate); ok on {int(ok_k.sum())}"
          f" lanes (plain f64 {int(ok_p.sum())}), max K/k difference from "
          f"the float64 plain version on lanes ok in both {err:.3e}")
    if not same:
        raise AssertionError(f"{what}, {case}: not K7's own outputs")
    errs[key] = err
    timings[key] = (graph_ms(launch, 5), cuda_ms(wrap, 5), cuda_ms(ref, 1),
                    bound(*work))
    k_ms, w_ms, p_ms, (b_ms, b_by) = timings[key]
    print(f"  {key}: kernel {k_ms:.4f} ms (graph replays), wrapper with the "
          f"layout round trip {w_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")


def phase30_kinds(env, config, horizon):
    """The kernels a phase-30 solve runs, as the solver routes them: the
    Riccati kernel (``_riccati_kernel_mode``: lane or K7, with ``ddp`` its
    DDP variant, with boxQP on a bounded env its boxQP one), then the
    fused iteration's K2 and K8, or the split iteration's line search (K5
    on AUTO), each unrolled or generic."""
    from tfmpc_tpu_torch.ops import rollout
    from tfmpc_tpu_torch.solvers import ilqr_batched

    n, m = env.state_size, env.action_size
    mode = ilqr_batched._riccati_kernel_mode(n, m, config, "cuda")
    backward = {"lane": "riccati_backward",
                "mid": "riccati_backward_mid"}[mode] \
        + ("_ddp" if config.ddp else "") \
        + ("_boxqp" if config.boxqp and env.bounds is not None else "")
    if ilqr_batched._use_fused_derivs(env, config, "cuda"):
        g = "" if (n, m) in rollout.DERIVS_DIMS else "_generic"
        return {backward, "linesearch_costs" + g, "rollout_alpha_derivs" + g}
    if rollout.unrolled_dims(env.device_step().env_id, n, m):
        return {backward} | line_search_kernels(config, horizon, n)
    return {backward} | generic_kinds(config, horizon, n, m)


def d5_oracle_check(horizon):
    """D5's first ``D5_ORACLE_B`` scenarios in float64 through K7's DDP
    variant and the generic rollouts (counted) against the fp64 NumPy
    navigation oracle: converged, controls within 1e-4 max-abs."""
    import numpy as np
    import torch

    from oracles import ilqr_navigation_oracle_np
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    env = phase30_env("nav12", torch.float64)
    x0 = phase30_x0("nav12", D5_ORACLE_B, torch.float64)
    config = ILQRConfig(**DDP_HEADLINE)
    res, launches, plain = counted(solver(env, x0, horizon, config))
    require_path("D5 f64 oracle solve", launches, plain,
                 phase30_kinds(env, config, horizon))
    devs = []
    for i in range(D5_ORACLE_B):
        _, U_np, _ = ilqr_navigation_oracle_np(
            env.goal.tolist(), env.centers.tolist(), env.decays.tolist(),
            x0[i].cpu().numpy(), horizon, atol=1e-10)
        devs.append(float(np.abs(res.actions[i].cpu().numpy()
                                 - U_np).max()))
    print(f"  D5 f64, first {D5_ORACLE_B} scenarios, DDP controls vs the "
          f"fp64 NumPy oracle: converged {res.converged.tolist()}, max-abs "
          f"by scenario {[f'{d:.3e}' for d in devs]} (gate < 1e-4)")
    if not bool(res.converged.all()) or max(devs) >= 1e-4:
        raise AssertionError("D5: DDP controls deviate from the fp64 oracle")
    return max(devs)


def slice_h(phase, timings, errs, launches_by_path, plain_s, rates, card):
    """Phase 30: K7's full-DDP variants (``check_k7_ddp``) and the generic
    K8 (``check_k8_generic``, also against the generic K3) against their
    plain versions in float32 and float64, then timed at the paths'
    shapes (f32), K7 at G4's and G5's shapes in the kernel layout; then
    each ``DDP_MID_PATHS`` solve against its plain path and each
    ``FUSED_MID_PATHS`` solve against its split-kernel solve (the same
    converged mask on >= 99% of lanes, mean cost within 1e-4), counted
    (launches > 0 for the kernels it should run, every other 0, no plain
    version); D5's f64 lanes against the fp64 oracle, the double
    integrator's controls against the exact LQR; each path's solves/s.
    Returns its figures."""
    import numpy as np
    import torch

    from tfmpc_tpu_torch.solvers import ilqr_batched
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    figures = {"paths": {}}
    for dtype in (torch.float32, torch.float64):
        print(f"K7's full-DDP variants vs their plain versions, {dtype}:")
        for case, dims in DDP_MID_ENV_CASES:
            check_k7_ddp(case, dims, dtype)
        for dims in DDP_MID_SYNTHETIC_SCALE:
            check_k7_ddp("synthetic", dims, dtype)
        print(f"the generic K8 vs its plain version and the generic K3, "
              f"{dtype}:")
        for n in K8_GENERIC_DIMS:
            for kind in ("", "_2z"):
                check_k8_generic(f"nav{n}{kind}", dtype)
    print("phase 30's kernels at the paths' shapes, f32:")
    for label, (case, Bn, Tn, cfg) in DDP_MID_PATHS.items():
        env = phase30_env(case, torch.float32, "cpu")
        box = cfg.get("boxqp") and env.bounds is not None
        check_k7_ddp(case, (env.state_size, env.action_size), torch.float32,
                     Bn, Tn, timings, errs, "_" + label,
                     ("ddp_boxqp",) if box else ("ddp",))
    for label, (case, Bn, Tn, _) in FUSED_MID_PATHS.items():
        check_k8_generic(case, torch.float32, Bn, Tn, timings, errs,
                         "rollout_alpha_derivs_generic_" + label)
        time_k7_lanes(case, Bn, Tn, case.endswith("_box"), timings, errs,
                      "riccati_backward_mid" + ("_boxqp" if case.endswith(
                          "_box") else "") + "_" + label)
    phase.done("30a. K7's DDP variants and the generic K8 vs plain versions")

    runs = {}
    for label, (case, Bn, Tn, cfg) in {**DDP_MID_PATHS,
                                       **FUSED_MID_PATHS}.items():
        env = phase30_env(case, torch.float32)
        n, m = env.state_size, env.action_size
        x0 = phase30_x0(case, Bn, torch.float32)
        config = ILQRConfig(**cfg)
        fused = ilqr_batched._use_fused_derivs(env, config, "cuda")
        print(f"phase 30 path {label}, (n, m) = ({n}, {m}), B={Bn}, T={Tn}, "
              f"f32, {'fused' if fused else 'split'} iteration:")
        run = solver(env, x0, Tn, config)
        passes = []
        derivatives = ilqr_batched.derivatives
        ilqr_batched.derivatives = lambda *a: (passes.append(1),
                                               derivatives(*a))[1]
        t0 = time.perf_counter()
        try:
            res, launches, plain = counted(run)
        finally:
            ilqr_batched.derivatives = derivatives
        solve_s = time.perf_counter() - t0
        launches_by_path[label] = launches
        require_path(f"{label} solve", launches, plain,
                     phase30_kinds(env, config, Tn))
        if fused and len(passes) != 1:
            raise AssertionError(f"{label}: {len(passes)} derivatives passes"
                                 " in a fused solve (expected 1)")
        conv = check_result(label, res, Bn, n, Tn, m)
        if fused:
            other = dataclasses.replace(config, fuse_derivatives=False)
            what = "split-kernel solve (fuse_derivatives=False)"
        else:
            other = dataclasses.replace(config, use_pallas=False)
            what = "plain path (use_pallas=False)"
        if label in NO_PLAIN_CHECK:
            print(f"  {label}: converged {conv:.4f} (gate >= "
                  f"{E1_MIN_CONVERGED}), failed "
                  f"{float(res.failed.float().mean()):.4f} (gate 0); not "
                  "held against the plain path (NO_PLAIN_CHECK)")
            if conv < E1_MIN_CONVERGED or bool(res.failed.any()):
                raise AssertionError(f"{label}: converged < "
                                     f"{E1_MIN_CONVERGED} or a lane failed")
        else:
            plain_s[label] = agree_with_plain(label, res, solver(
                env, x0, Tn, other), what=what)
        figures["paths"][label] = {
            "converged": conv, "failed": float(res.failed.float().mean()),
            "mean_iterations": float(res.iterations.float().mean()),
            "mean_cost": float(res.total_cost.double().mean()),
            "iteration": "fused" if fused else "split"}
        if label == "double_integrator_ddp":
            figures["double_integrator_ddp_vs_lqr"] = di_lqr_check(
                res, x0, Tn, DDP_HEADLINE, "riccati_backward_mid_ddp")
        if label == "d5_nav12_ddp":
            figures["d5_oracle_dev"] = d5_oracle_check(Tn)
        runs[label] = (run, Bn, Tn, solve_s)
    phase.done("30b. phase 30's solves")
    for label, (run, Bn, Tn, solve_s) in runs.items():
        w = [Bn / solve_s] if label in SOLVE_RATE else solves_per_s(run, Bn)
        rates[label] = float(np.median(w))
        other = "split" if "fused" in label else "plain"
        print(f"solves/s, {label}, kernels, T={Tn} B={Bn} f32: median "
              f"{rates[label]:.1f}, windows {[round(x, 1) for x in w]}"
              + (f"; one {other} solve {plain_s[label]:.2f} s"
                 if label in plain_s else "") + f" [{card}]")
    phase.done("30c. phase 30's solves/s")
    return figures


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
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # -- 2. build ----------------------------------------------------------
    from tfmpc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({_build.library_path().name})")
    build_log = _build.library_path().with_suffix(".log").read_text()
    print_ptxas(build_log)
    print_build_times(build_log)
    lib = _build.library()
    print_mid_plans(lib)
    print_lane_plans(lib)
    print_rollout_plans(lib)
    print_generic_plans(lib)

    # -- 3. kernels vs plain versions ---------------------------------------
    timings, errs = {}, {}
    phase = Phases(time.perf_counter())
    for dtype in (torch.float32, torch.float64):
        print(f"kernels vs plain versions, {dtype}:")
        check_nav_kernels(dtype, timings, errs)
        check_k4("hvac6", dtype, *((timings, errs)
                                   if dtype == torch.float32 else ()))
        check_clipped_rollouts("hvac6", dtype, *(
            (timings, errs) if dtype == torch.float32 else ()))
        check_clipped_rollouts("reservoir5", dtype)
        for case in ("reservoir5", "navigation"):
            check_k5(case, dtype, *((timings, errs)
                                    if dtype == torch.float32 else ()))
        for case, Bn, Tn in K5_PATH_SHAPES:
            check_k5(case, dtype, *((timings, errs)
                                    if dtype == torch.float32 else ()),
                     Bn=Bn, Tn=Tn)
        check_rollout_ragged(dtype)
    check_k4("reservoir5", torch.float32)
    lane_sweeps = {"K4_hvac6": lane_g_sweep("K4", card)}
    phase.done("3. kernels vs plain versions")

    # -- 4. the navigation headline solve (slice A) ---------------------------
    from oracles import ilqr_navigation_oracle_np
    from tfmpc_tpu_torch.models.navigation import make_navigation
    from tfmpc_tpu_torch.solvers.ilqr import ILQRConfig

    launches_by_path = {}
    config = ILQRConfig(**HEADLINE)
    nav = make_navigation(GOAL, ZONES, dtype=torch.float32, device="cuda")
    x0_np = np.random.default_rng(0).uniform(-10.0, 10.0, (B, N)).astype(
        "float32")
    run_nav = solver(nav, torch.as_tensor(x0_np, device="cuda"), T, config)
    run_nav()  # first solve: one-time costs (cuSOLVER/cuBLAS handles etc.)
    res, launches, plain = counted(run_nav)
    launches_by_path["navigation"] = launches
    require_path("navigation headline solve", launches, plain,
                 {"riccati_backward"} | line_search_kernels(config, T, N))
    if check_result("navigation headline", res, B, N) < 0.99:
        raise AssertionError("headline solve converged < 0.99")
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
    launches_by_path["navigation_two_kernel"] = layouts_agree(
        "navigation headline", res, solver(
            nav, torch.as_tensor(x0_np, device="cuda"), T,
            dataclasses.replace(config, linesearch_emit_trajectories=False)),
        "riccati_backward")
    run_nav_plain = solver(nav, torch.as_tensor(x0_np, device="cuda"), T,
                           dataclasses.replace(config, use_pallas=False))
    plain_s = {"navigation": agree_with_plain("navigation", res,
                                              run_nav_plain)}
    nav_split = (run_nav, res, x0_np)
    phase.done("4. navigation headline")

    # -- 5. the HVAC-6 solve (slice B's main path) ----------------------------
    boxqp_config = ILQRConfig(**BOXQP)
    box_kernels = {"riccati_backward_boxqp"} | line_search_kernels(
        boxqp_config, T, 6)
    plain_box = dataclasses.replace(boxqp_config, use_pallas=False)
    runs = {}
    for name, lohi in (("hvac6", (8.0, 18.0)), ("reservoir5", (20.0, 95.0))):
        env = bounded_env(name, torch.float32)
        x0 = torch.as_tensor(np.random.default_rng(0).uniform(
            *lohi, (B_BOX, env.state_size)).astype("float32"), device="cuda")
        runs[name] = (env, x0, solver(env, x0, T, boxqp_config),
                      solver(env, x0, T, plain_box))
    env, x0_h, run_h, run_h_plain = runs["hvac6"]
    run_h()
    res, launches, plain = counted(run_h)
    launches_by_path["hvac6"] = launches
    require_path("HVAC-6 solve", launches, plain, box_kernels)
    conv = check_result("HVAC-6", res, B_BOX, 6)
    print(f"  mean total cost {float(res.total_cost.double().mean()):.6f} "
          f"vs {JAX_HVAC6_MEAN_COST} recorded by the JAX package on a TPU "
          f"(converged {JAX_HVAC6_CONVERGED}), printed, not gated")
    if conv < 0.99:
        raise AssertionError(f"HVAC-6 solve converged only {conv:.4f}")
    plain_s["hvac6"] = agree_with_plain("HVAC-6", res, run_h_plain)
    launches_by_path["hvac6_two_kernel"] = layouts_agree(
        "HVAC-6", res, solver(env, x0_h, T, dataclasses.replace(
            boxqp_config, linesearch_emit_trajectories=False)),
        "riccati_backward_boxqp")
    phase.done("5. HVAC-6")

    # -- 6. constrained accuracy vs the fp64 oracle ---------------------------
    print("HVAC-3 f64 through the kernels vs the fp64 boxQP oracle:")
    hvac3_accuracy()
    phase.done("6. HVAC-3 accuracy")

    # -- 7. reservoir-5 and bounded navigation --------------------------------
    env, _, run_r, run_r_plain = runs["reservoir5"]
    run_r()
    res, launches, plain = counted(run_r)
    launches_by_path["reservoir5"] = launches
    require_path("reservoir-5 solve", launches, plain, box_kernels)
    if check_result("reservoir-5", res, B_BOX, 5) < 0.99:
        raise AssertionError("reservoir-5 solve converged < 0.99")
    res_r5 = res
    plain_s["reservoir5"] = agree_with_plain("reservoir-5", res, run_r_plain)

    nav_b = bounded_env("nav_bounded", torch.float32)
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(
        -10.0, 10.0, (B_NAV_BOUNDED, N)).astype("float32"), device="cuda")
    for boxqp, backward in ((True, "riccati_backward_boxqp"),
                            (False, "riccati_backward")):
        cfg = ILQRConfig(**{**HEADLINE, "boxqp": boxqp})
        label = f"bounded navigation, boxqp={boxqp}"
        res, launches, plain = counted(solver(nav_b, x0, T_NAV_BOUNDED,
                                              cfg))
        launches_by_path[f"nav_bounded_boxqp_{boxqp}"] = launches
        require_path(label, launches, plain,
                     {backward} | line_search_kernels(cfg, T, N))
        check_result(label, res, B_NAV_BOUNDED, N, T_NAV_BOUNDED)
        agree_with_plain(label, res, solver(
            nav_b, x0, T_NAV_BOUNDED, dataclasses.replace(cfg,
                                                          use_pallas=False)))
    phase.done("7. reservoir-5 and bounded navigation")

    # -- 8. timing and the profile --------------------------------------------
    rates = {}
    for label, run, Bn in (("navigation", run_nav, B),
                           ("hvac6", run_h, B_BOX),
                           ("reservoir5", run_r, B_BOX)):
        w = solves_per_s(run, Bn)
        rates[label] = sorted(w)[len(w) // 2]
        print(f"solves/s, {label}, kernels, T={T} B={Bn} f32: median "
              f"{rates[label]:.1f}, windows {[round(x, 1) for x in w]}; one "
              f"plain solve {plain_s[label]:.2f} s ({Bn / plain_s[label]:.1f}"
              f" solves/s) [{card}]")
    hvac6_profile = print_profile("HVAC-6", run_h, card)
    phase.done("8. solves/s and the HVAC-6 profile")

    # -- 9. slice C: the reservoir-5 T=500 solve (suite config 4) -------------
    env_l = bounded_env("reservoir5", torch.float32)
    x0_l = torch.as_tensor(np.random.default_rng(0).uniform(
        20.0, 95.0, (B_LONG, 5)).astype("float32"), device="cuda")
    long_cfg = ILQRConfig(**LONG, linesearch_emit_trajectories=True)
    run_l = solver(env_l, x0_l, T_LONG, long_cfg)
    print(f"reservoir-5 T={T_LONG} B={B_LONG} solve (slice C's main path):")
    launches_by_path["reservoir5_t500"], \
        launches_by_path["reservoir5_t500_two_kernel"] = \
        reservoir_t500_solves((run_l, solver(
            env_l, x0_l, T_LONG, dataclasses.replace(
                long_cfg, linesearch_emit_trajectories=False))))
    phase.done("9. reservoir-5 T=500")

    # -- 10. long-horizon accuracy vs the fp64 oracle -------------------------
    print(f"reservoir-5 T={T_LONG} f32 through K4 and K5 vs the fp64 boxQP "
          "oracle:")
    reservoir_t500_accuracy()
    phase.done("10. reservoir-5 T=500 accuracy")

    # -- 11. the parallel backward --------------------------------------------
    print(f"parallel backward, reservoir-5 T={T_LONG}:")
    parallel_backward_checks()
    latency_ms = latency_variants(x0_l[:1])
    phase.done("11. parallel backward and latency variants")

    # -- 12. exact LQR (suite config 1) ---------------------------------------
    print("exact LQR, linear navigation (suite config 1):")
    lqr_rates = lqr_config1(card)
    phase.done("12. LQR")

    # -- 13. the emit A/B ------------------------------------------------------
    # the T=500 arm (four whole solves of ~20 s) is left out to keep the
    # script's time: its verdict, two-kernel within the spread, held in
    # every earlier run (PERF.md)
    ab = {
        "hvac6_t100": emit_ab(f"HVAC-6 T={T} B={B_BOX}", runs["hvac6"][0],
                              x0_h, T, boxqp_config, 3, card),
    }
    phase.done("13. emit A/B")


    # -- 15. slice D: K6a and K6b against their plain versions ---------------
    for dtype in (torch.float32, torch.float64):
        print(f"slice D kernels vs plain versions, {dtype}:")
        f32 = (timings, errs) if dtype == torch.float32 else ()
        check_k6("K6a", "navigation", dtype, *f32)
        check_k6("K6b", "reservoir5", dtype, *f32)
        check_k6("K6b", "hvac6", dtype)
        for case in ("synthetic2", "synthetic6"):
            for kernel in ("K6a", "K6b"):
                check_k6(kernel, case, dtype)
        check_k1_dims(dtype)
        check_lane_ragged(dtype)
    check_ddp_terms_enter()
    lane_sweeps["K6a_navigation"] = lane_g_sweep("K6a", card)
    phase.done("15. K6a and K6b vs plain versions")

    # -- 16. D1: full DDP on reservoir-5 (suite config 4c) --------------------
    ddp_box = ILQRConfig(**DDP_BOXQP)
    env_r, x0_r = runs["reservoir5"][:2]
    run_d1 = solver(env_r, x0_r, T, ddp_box)
    run_d1()
    print(f"D1, full-DDP reservoir-5 T={T} B={B_BOX} solve (slice D's main "
          "path):")
    res, launches, plain = counted(run_d1)
    launches_by_path["d1_reservoir5_ddp"] = launches
    require_path("D1 solve", launches, plain,
                 {"riccati_backward_ddp_boxqp"}
                 | line_search_kernels(ddp_box, T, 5))
    if check_result("D1", res, B_BOX, 5) < 0.99:
        raise AssertionError("D1 solve converged < 0.99")
    plain_s["d1_reservoir5_ddp"] = agree_with_plain(
        "D1", res, solver(env_r, x0_r, T, dataclasses.replace(
            ddp_box, use_pallas=False)))
    ddp_vs_ilqr = {
        "ddp_mean_iterations": float(res.iterations.float().mean()),
        "ilqr_mean_iterations": float(res_r5.iterations.float().mean()),
        "ddp_mean_cost": float(res.total_cost.double().mean()),
        "ilqr_mean_cost": float(res_r5.total_cost.double().mean()),
    }
    print(f"  beside the iLQR reservoir-5 solve of phase 7 (printed, not "
          f"gated): {ddp_vs_ilqr}")
    phase.done("16. D1 reservoir-5 DDP")

    # -- 17. D2: the navigation headline with DDP -----------------------------
    ddp_nav = ILQRConfig(**DDP_HEADLINE)
    x0_nav = torch.as_tensor(x0_np, device="cuda")
    run_d2 = solver(nav, x0_nav, T, ddp_nav)
    run_d2()
    print(f"D2, full-DDP navigation T={T} B={B} solve:")
    res, launches, plain = counted(run_d2)
    launches_by_path["d2_navigation_ddp"] = launches
    require_path("D2 solve", launches, plain,
                 {"riccati_backward_ddp"} | line_search_kernels(ddp_nav, T, N))
    d2_converged = check_result("D2", res, B, N)
    plain_s["d2_navigation_ddp"] = agree_with_plain(
        "D2", res, solver(nav, x0_nav, T, dataclasses.replace(
            ddp_nav, use_pallas=False)))
    print(f"  D2 controls vs the fp64 NumPy oracle, float32, by scenario "
          f"(printed, not gated): {ddp_oracle_devs(res, x0_np[:4])}")
    ddp_oracle_checks(nav, x0_np[:4])
    phase.done("17. D2 navigation DDP")

    # -- 18. DDP + boxQP accuracy vs the fp64 oracle ---------------------------
    print("HVAC-3 f64 through K6b vs the fp64 boxQP oracle:")
    hvac3_accuracy(ddp=True)
    phase.done("18. HVAC-3 DDP accuracy")

    # -- 19. slice D timing and the D1 profile --------------------------------
    for label, run, Bn in (("d1_reservoir5_ddp", run_d1, B_BOX),
                           ("d2_navigation_ddp", run_d2, B)):
        w = solves_per_s(run, Bn)
        rates[label] = sorted(w)[len(w) // 2]
        print(f"solves/s, {label}, kernels, T={T} B={Bn} f32: median "
              f"{rates[label]:.1f}, windows {[round(x, 1) for x in w]}; one "
              f"plain solve {plain_s[label]:.2f} s ({Bn / plain_s[label]:.1f}"
              f" solves/s) [{card}]")
    d1_profile = print_profile("D1 reservoir-5 DDP", run_d1, card)
    d2_profile = print_profile("D2 navigation DDP", run_d2, card)
    phase.done("19. slice D solves/s and the D1 and D2 profiles")

    e1, e2, k7_k4, e1_profile, e_extra = slice_e(
        phase, timings, errs, launches_by_path, plain_s, rates, card)
    f_figures = slice_f(phase, timings, errs, launches_by_path, rates, card,
                        nav_split)
    g_figures = slice_g(phase, launches_by_path, card)
    generic_figures = slice_generic(phase, timings, errs, launches_by_path,
                                    plain_s, card)
    h_figures = slice_h(phase, timings, errs, launches_by_path, plain_s,
                        rates, card)

    for name, value in timings.items():
        if name.endswith("_select_ms"):
            continue
        k_ms, w_ms, p_ms, (b_ms, b_by), *lib = value
        print(f"{name} f32: kernel {k_ms:.4f} ms, wrapper with layout copies "
              f"{w_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})" + (f", library {lib[0]:.4f} ms" if lib else "")
              + f" [{card}]")

    # name -> (source, TPU kernel it replaces, path, launch counter)
    rollout_cu = "tfmpc_tpu_torch/ops/csrc/rollout.cuh"
    mid_cu = "tfmpc_tpu_torch/ops/csrc/riccati_mid.cuh"
    k7_tpu = "tfmpc_tpu/ops/riccati_mid_pallas.py:462"
    k2_tpu = "tfmpc_tpu/ops/rollout_pallas.py:647"
    k3_tpu = "tfmpc_tpu/ops/rollout_pallas.py:804"
    k5_tpu = "tfmpc_tpu/ops/rollout_pallas.py:713"
    derivs_cu = "tfmpc_tpu_torch/ops/csrc/rollout_derivs.cu"
    k8_tpu = "tfmpc_tpu/ops/rollout_pallas.py:544"
    sources = {
        "riccati_backward": ("tfmpc_tpu_torch/ops/csrc/riccati.cu",
                             "tfmpc_tpu/ops/riccati_pallas.py:462",
                             "navigation", "riccati_backward"),
        "linesearch_costs": (rollout_cu, k2_tpu, "navigation_two_kernel",
                             "linesearch_costs"),
        "rollout_alpha": (rollout_cu, k3_tpu, "navigation_two_kernel",
                          "rollout_alpha"),
        "riccati_backward_boxqp": ("tfmpc_tpu_torch/ops/csrc/riccati_boxqp.cu",
                                   "tfmpc_tpu/ops/riccati_pallas.py:585",
                                   "hvac6", "riccati_backward_boxqp"),
        "linesearch_costs_clipped": (rollout_cu, k2_tpu, "hvac6_two_kernel",
                                     "linesearch_costs"),
        "rollout_alpha_clipped": (rollout_cu, k3_tpu, "hvac6_two_kernel",
                                  "rollout_alpha"),
        "linesearch_costs_traj": (rollout_cu, k5_tpu, "reservoir5_t500",
                                  "linesearch_costs_traj"),
        "linesearch_costs_traj_navigation": (rollout_cu, k5_tpu, "navigation",
                                             "linesearch_costs_traj"),
        "linesearch_costs_traj_hvac6": (rollout_cu, k5_tpu, "hvac6",
                                        "linesearch_costs_traj"),
        "linesearch_costs_traj_hvac16": (rollout_cu, k5_tpu, "e1_hvac16",
                                         "linesearch_costs_traj"),
        "linesearch_costs_t500": (rollout_cu, k2_tpu,
                                  "reservoir5_t500_two_kernel",
                                  "linesearch_costs"),
        "rollout_alpha_t500": (rollout_cu, k3_tpu,
                               "reservoir5_t500_two_kernel", "rollout_alpha"),
        "riccati_backward_ddp": ("tfmpc_tpu_torch/ops/csrc/riccati_ddp.cu",
                                 "tfmpc_tpu/ops/riccati_pallas.py:545",
                                 "d2_navigation_ddp", "riccati_backward_ddp"),
        "riccati_backward_ddp_boxqp": (
            "tfmpc_tpu_torch/ops/csrc/riccati_ddp_boxqp.cu",
            "tfmpc_tpu/ops/riccati_pallas.py:564", "d1_reservoir5_ddp",
            "riccati_backward_ddp_boxqp"),
        "riccati_backward_mid": (mid_cu, k7_tpu, "e1_hvac16_clip",
                                 "riccati_backward_mid"),
        "riccati_backward_mid_boxqp": (mid_cu, k7_tpu, "e1_hvac16",
                                       "riccati_backward_mid_boxqp"),
        "riccati_backward_mid_boxqp_hvac12": (mid_cu, k7_tpu, "e2_hvac12",
                                              "riccati_backward_mid_boxqp"),
        "linesearch_costs_clipped_hvac16": (rollout_cu, k2_tpu,
                                            "e1_hvac16_two_kernel",
                                            "linesearch_costs"),
        "rollout_alpha_clipped_hvac16": (rollout_cu, k3_tpu,
                                         "e1_hvac16_two_kernel",
                                         "rollout_alpha"),
        **{f"row_matmul_d{d}": ("tfmpc_tpu_torch/ops/csrc/row_matmul.cu",
                                "benchmarks/mxu_probe.py:82",
                                f"p1_chain_d{d}", "row_matmul")
           for d in P1_DIMS},
        "rollout_alpha_derivs": (derivs_cu, k8_tpu, "g1_navigation_fused",
                                 "rollout_alpha_derivs"),
        "rollout_alpha_derivs_bounded": (derivs_cu, k8_tpu,
                                         "g2_nav_bounded_fused",
                                         "rollout_alpha_derivs"),
        "rollout_alpha_derivs_g3": (derivs_cu, k8_tpu, "g3_mpc_fused",
                                    "rollout_alpha_derivs"),
    }
    # the generic form at each path's shape: K5 counted in the path's emit
    # solve, K2 and K3 in its two-kernel solve (one of the two is AUTO's)
    generic_cu = "tfmpc_tpu_torch/ops/csrc/rollout_generic.cuh"
    for label in GENERIC_PATHS:
        for wrapper, tpu, layout in (
                ("linesearch_costs_traj", k5_tpu, "emit"),
                ("linesearch_costs", k2_tpu, "two_kernel"),
                ("rollout_alpha", k3_tpu, "two_kernel")):
            sources[f"{wrapper}_generic_{label}"] = (
                generic_cu, tpu, f"generic_{label}_{layout}",
                f"{wrapper}_generic")
    # phase 30: K7's DDP variants (K6a's and K6b's contracts) on the DDP
    # paths, and on the fused ones the generic K8 and K7 in the kernel
    # layout
    for label, (case, _, _, cfg) in DDP_MID_PATHS.items():
        box = cfg.get("boxqp") and phase30_env(case, torch.float32,
                                               "cpu").bounds is not None
        name = "riccati_backward_mid_ddp" + ("_boxqp" if box else "")
        sources[f"{name}_{label}"] = (
            mid_cu, "tfmpc_tpu/ops/riccati_pallas.py:"
            + ("564" if box else "545"), label, name)
    for label, (case, _, _, cfg) in FUSED_MID_PATHS.items():
        sources[f"rollout_alpha_derivs_generic_{label}"] = (
            generic_cu, k8_tpu, label, "rollout_alpha_derivs_generic")
        name = "riccati_backward_mid" + ("_boxqp" if case.endswith("_box")
                                         else "")
        sources[f"{name}_{label}"] = (mid_cu, k7_tpu, label, name)
    kernels = []
    for name, (src, replaces, path, counter) in sources.items():
        k_ms, w_ms, p_ms, (b_ms, b_by), *lib = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "path": path,
            "launches": launches_by_path[path][counter],
            "max_abs_err": errs[name], "ms": k_ms, "wrapper_ms": w_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[0] if lib else None,
        })
    print(json.dumps({"kernels": kernels, "build_s": build_s,
                      "solves_per_s": rates, "plain_solve_s": plain_s,
                      "launches_by_path": launches_by_path,
                      "select_ms": {k: v for k, v in timings.items()
                                    if k.endswith("_select_ms")},
                      "t500_latency_ms": latency_ms,
                      "lqr_solves_per_s": lqr_rates,
                      "emit_ab": {k: {str(f): v for f, v in d.items()}
                                  for k, d in ab.items()},
                      "hvac6_profile": hvac6_profile,
                      "d1_profile": d1_profile,
                      "d2_profile": d2_profile,
                      "d1_vs_ilqr": ddp_vs_ilqr,
                      "d2_converged": d2_converged,
                      "e1_profile": e1_profile,
                      "e1": e1, "e2": e2,
                      "k7_vs_k4_hvac6_ms": k7_k4,
                      "lane_g_sweep_ms": lane_sweeps,
                      **e_extra,
                      "k7_synthetic": {
                          k: {"ms": v[0], "plain_ms": v[2],
                              "bound_ms": v[3][0], "max_abs_err": errs[k]}
                          for k, v in timings.items()
                          if k.startswith("riccati_backward_mid")
                          and k not in sources},
                      **f_figures,
                      "slice_g": g_figures,
                      "generic": {**generic_figures, "linear24x6": {
                          k: {"ms": v[0], "wrapper_ms": v[1],
                              "plain_ms": v[2], "bound_ms": v[3][0],
                              "max_abs_err": errs[k]}
                          for k, v in timings.items()
                          if k.endswith("_generic_linear24x6")}},
                      "phase30": h_figures,
                      "phase_s": phase.seconds,
                      "total_s": time.perf_counter() - t_start,
                      "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
