#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card, and check them.

    python3 chip_smoke.py [--profile]

The main paths of ``g1_locomotion_tpu_torch``, at the G1's full width,
float32, from seeded generators:

* the batched SRBD-MPC update (SRBD linearization -> ZOH -> condensation ->
  friction-cone rows -> segmented ADMM with active-set polish -> rollout):
  N = 10, 120 decision variables, 200 constraint rows;
* the WBID tick of the 23-DoF G1 (FK, RNEA / CRBA, the task stack's QP with
  41 variables and 80 rows, the same ADMM, torques by RNEA - Jc' f);
* the control period (MPC, 40 WBID ticks and the plant), for the 23-DoF G1
  and the 29-DoF and with-hand variants (QP nx = 47 / 61);
* the SRBD-level closed loop of planner, MPC and rigid body, and the
  reference-compatible MPC class.

Phases, each of which must pass:

0. build the four CUDA kernels from ``g1_locomotion_tpu_torch/csrc`` (and,
   beside them, the barrier probe that measures the chains of dependent
   steps); the kernels that keep their matrices in registers (B1, the tiles
   of B2, B3 and B4, B3's cluster tile, B4's tile at 13 and 14 rows of A a
   thread) must not spill, and their registers are printed;
1. each kernel against its plain PyTorch version on the card, on inputs
   recorded from every main path (so at the shapes, and for B1 the strided
   views, they give it: the MPC's 120 / 200 at B = 4096 and, through the
   MPC class, at B = 1, the WBID's 41 / 80 and the variants' 47 / 92 and
   61 / 120, and at float64 the MuJoCo bridge's (1, 30 / 25 / 21 / 20));
   B3 at m = 210 (its two-CTA cluster tile) and B4 at n = 120, m = 210 (its
   tile with 14 rows of A a thread) from a serving solve with
   ``MPCConfig.roll_moment_max``, whose routes the plans must name; where no
   instance of a recorded B1 layout is numerically SPD,
   a seeded SPD batch of that shape through the same strides instead; and
   B1-B3 also on random SPD systems at those widths, B3's cluster tile at
   m = 209, 210, 224, 240 with B = 1 and 150 (more clusters than the card
   has pairs of SMs), B4's wide tile on seeded QPs at (n, m) = (120, 209),
   (120, 210), (128, 224); B1 also at float64 on
   seeded SPD batches (4096, n, n), n = 30, 25, 21, 20 (phase 0 prints its
   registers; a spill at either type is a fault);
2. MPC throughput: one ``MPCSolver`` call at B = 4096 in the ``bench.py``
   configuration (matmul inverses, kernel B1); physical invariants; the
   first 256 instances against the plain-version path on the card;
3. MPC serving: 22 data-dependent B = 1 solves in the
   ``tools/bench_latency.py`` configuration (kernels B2, B3, B4); then the
   same chain with ``MPCConfig.roll_moment_max`` (m = 210: B3 on the
   cluster tile, B4 on the 14-row tile, each launch counted by route), its
   invariants, and its last solve against the plain-version path;
5. WBID serving: 40 data-dependent B = 1 ticks (one control period: 20 in
   double support, 20 with the left foot swinging; v += qddot dt,
   q = integrate_q(q, v, dt)) in the serving configuration
   (``polish_kernel``, ``fast_stack``: kernels B2, B3, B4); the WBID
   invariants on every tick; one tick against the plain-version path;
6. WBID batched: one tick at B = 2048 (tools/bench_cascade.py's size) in the
   default ``WBIDConfig`` (kernel B1), a seeded mix of double support and
   left / right swing; the invariants on every instance; the first 256
   against the plain-version path;
7. serving period: a data-dependent chain of 25 control periods (1.0 s: the
   stand, the first double support, the first swing; each an MPC solve, 40
   WBID ticks and 40 plant steps) from ``init_state`` in the serving
   configuration of ``tools/bench_tick_p99.py`` (``polish_kernel`` on both
   QPs, ``fast_stack``), ``default_scenario``, B = 1: kernels B2, B3, B4
   at exactly 123 / 122 / 82 launches per period; the period invariants on
   every tick; one period against the plain-version path;
8. batched cascade: one period of the default ``EngineConfig`` at B = 2048
   (``tools/bench_cascade.py``): B1 at exactly 748 launches (28 for the MPC
   solve, 18 per tick); the invariants on every instance; the first 256
   instances against the plain-version path;
9. golden prefix: ``walking_config()`` with ``walking_scenario`` at float64,
   the first 20 periods (800 ticks, through the first swing onset) against
   the first 800 rows of ``tests/goldens/walk_golden.npz``: contact flags
   equal, CoM within 1e-4 m, tau within 5e-2 N m, forces within 0.5 N
   (``tests/test_golden.py``'s tolerances); no kernel launches;
10. batched SRBD loop: ``mpc/srbd_loop.SRBDLoop`` in ``MPCConfig()`` (N = 10,
    the matmul inverses) with ``walking_scenario``, B = 4096, 200 periods
    (8 steps and the settle), each instance kicked laterally at period 60
    by a seeded draw in [0, 0.15] m/s: B1 at exactly 28 launches a period;
    no NaN, swing forces exactly 0, pri_res and the CoM height within
    SRBD_BOUNDS; the kick's period for the first 8 instances against the
    plain-version path;
11. the SRBD loop's serving chain: 50 data-dependent B = 1 periods with
    ``polish_kernel`` (B2 3, B3 2, B4 2 a period, B4 at 30 iterations a
    segment), p50 / max per period; the same invariants; one period
    against the plain-version path;
12. the validated SRBD walk: ``walking_config().mpc`` at float64, B = 1,
    200 periods, against ``tests/test_srbd_loop.py:33-57``'s bar; no kernel;
13. the variant cascade: one default-configuration period of
    ``g1_29dof`` and of ``g1_29dof_with_hand`` (their torso / hand tasks
    from ``variant_walking_config``, ``variant_walking_scenario``) at B =
    2048 from ``init_state``: B1 at the new block sizes (23 / 24; 30, 15 /
    16), exactly 748 / 868 launches; the period invariants within twice the
    JAX package's f32 maxima; the first 256 instances against the
    plain-version path;
14. the reference-compatible ``mpc/api.MPC`` class: two updates of the
    standing case (``tests/test_compat_api.py:10-49``): sum fz within 0.5%
    of m g, the warm-started second within DU0_MAX_N of the first, each
    within DU0_MAX_N of the same update through the plain versions; B1 28
    launches each;
15. the pod sweep (BASELINE config 5): ``parallel/sweep.run_sweep`` over
    ``SweepSpec()``'s 4096 scenarios drawn by ``randomize`` from a seeded
    generator (SRBD mass and inertia, WBID mu, swing duration, step length
    and v_cmd per instance), the default ``EngineConfig``, 2 periods
    unchunked and then as 2 chunks of one period through a
    ``utils/checkpoint`` save and restore: B1 at exactly 748 launches a
    period in both, the chunked statistics equal to the unchunked (``n`` and
    ``fell_count`` exactly, the drift and tau_max within SWEEP_STATS_RTOL),
    no scenario falls, every instance within the period invariants of
    PERIOD_BOUNDS[15]; the first 256 instances against the plain-version
    path; then the gait sweep demo (BASELINE config 3, B = 4096, B1 56);
16. telemetry (``EngineConfig.telemetry``: CUDA events around the MPC solve
    and each tick's WBID solve): one serving period and one default period
    at B = 2048 with the launches of telemetry off, ``mpc_ms`` and
    ``wbid_ms`` positive and finite, ``mpc_ms`` the same on a period's
    ticks, the WBID solves no longer than the period's own events; the
    fields exactly 0 in phases 7 and 8 (telemetry off);
17. the MuJoCo bridge (``engine/mujoco_bridge.py``) at float64 on the card,
    B = 1, the default ``EngineConfig`` with
    ``tests/test_engine_mujoco.py``'s standing scenario: the bridge's
    controller replays ``tests/torch_mujoco_trace.npz`` (two periods of
    MuJoCo measurements and the torques the JAX package's ``MujocoLoop``
    computed from them; numpy, no MuJoCo): B1 ``<double, n>`` at exactly 28
    launches a period's MPC solve and 18 a tick (n = 30 / 25, 20 / 21);
    tau, the contact normal forces and the CoM per tick within
    BRIDGE_TOL of the recorded ones; the second period through the plain
    versions within BRIDGE_TOL of the kernels'; the tick's wall time (p50,
    max). Where the ``mujoco`` package is installed (importlib finds it),
    the closed loop in MuJoCo too: BRIDGE_LOOP_TICKS ticks of standing
    through ``tools/torch_mujoco_bar.standing_bar`` (the invariants of
    ``test_standing_balance_in_mujoco``; tests/test_torch_engine_mujoco.py
    runs the same function on the CPU) and the exact B1 count; where it is
    not, a line says so;
4. timings (run after phase 14) with CUDA events (not counted as main-path
   launches): each kernel at each shape its paths give it, its plain version
   and, where one PyTorch call computes the same function, that call, in
   turns; beside them the card bound (bytes over the memory rate, operations
   over the fp32 rate, fp64 for B1 ``<double, n>``) and, for the kernels
   that a serving path launches as one block, the one-SM bound (B1 at B = 1:
   a warp's chain of n steps; B3's cluster tile the two-SM bound: operations
   at 2/132 of the rate, or m steps of the block barrier's chain, beside
   what m steps of the probe's cluster chain would take);
   at the roll-moment cap's shapes also the shared-memory kernel that ran
   them before, and at B3's tile shapes its cluster tile, in turns; B1
   ``<double, n>`` also at the pod-sweep
   demo's (4096, n, n); B4's fixed part and its slope per iteration;
   the capped serving solve's host-clock p50 and its device time (CUDA
   events, queued behind a busy card);
   the MPC's throughput and serving latency, the WBID serving tick's p50 /
   p99 and the batched tick's ticks/s; the serving period's wall time (p50,
   max, per tick; from phase 7's chain) and the batched cascade's period
   (CUDA events) and ticks/s; each variant cascade's ticks/s; the batched
   SRBD loop's instance-periods/s and the serving chain's p50 (from phases
   10 and 11); the pod sweep's scenario-periods/s and scenario-ticks/s
   (phase 15, CUDA events) and the gait sweep demo's solves/s. Kernel times
   are device times: the
   launches queue up behind a kernel that keeps the card busy meanwhile, so
   a wrapper that takes the host longer than its kernel runs does not show.

The WBID invariants: no NaN, pri_res < 0.05, |tau| <= tau_max + 1e-4, in
double support sum fz within 5% of m g, on a swinging foot's contacts
|f| <= SWING_F_MAX_N, |base_wrench_res| <= BASE_RES_MAX. The period
invariants (phases 7 and 8): no NaN, |tau| <= tau_max + 1e-4, and MPC and
WBID pri_res, the force on a swinging foot's contacts, the deviation of the
summed normal force from m g in double support and the base's tilt within
PERIOD_BOUNDS (twice the JAX package's maxima, tools/period_invariant_bounds.py).

Launch counters are zeroed right before each path (phases 2, 3, 5-17) and
read right after it; every kernel must have launched as often as that path
calls it, and every path but phase 3's capped chain only by the routes the
kernels took before B3's cluster tile and B4's 14-row tile
(``cuda_lin.route_counts()``). The line before the last is a JSON object with one entry per
kernel (its launches by route, and every timed shape with its route); the
last line is ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero, and so does a machine without a CUDA device.
``--profile`` adds ``torch.profiler`` passes over 50 MPC serving solves, 3
MPC throughput batches, the SPD inverse alone, 50 WBID serving ticks, 3
batched WBID ticks, one serving period, one batched period, 5 periods of
the batched SRBD loop, 10 of its serving chain, one pod-sweep period at
B = 4096 and one with-hand cascade period (device busy share, device time by kernel and by kind); they are
measurements, not checks.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from statistics import median

import numpy as np
import torch

B_THROUGHPUT = 4096
B_COMPARE = 256     # instances held against the plain-version path
B_RECORD = 8        # serving-path instances recorded for phase 1
SERVING_CHAIN = 22  # data-dependent B = 1 solves (tools/bench_latency.py)
DU0_MAX_N = 0.5     # |u0 kernel path - u0 plain path| bound [N]
THROUGHPUT_BATCHES = 10  # timed B = 4096 batches
SERVING_SAMPLES = 1000   # timed B = 1 solves: 10 samples beyond the p99
PROFILE_SOLVES = 50      # serving solves under torch.profiler (--profile)
PROFILE_BATCHES = 3      # throughput batches under torch.profiler (--profile)
SOURCE = "g1_locomotion_tpu_torch/csrc/lin_kernels.cu"
# Launches each path must make: B1 four per 120-wide inverse (x 2 segments),
# four for Hr, eight per 200-wide S (x 2 polish rounds); per serving solve B2
# for both segments' K and Hr, B3 per polish round, B4 per segment.
THROUGHPUT_LAUNCHES = {"chol_inverse_base": 28, "gj_inverse": 0, "gj_solve": 0,
                       "admm_iterate": 0}
SERVING_LAUNCHES = {"chol_inverse_base": 0, "gj_inverse": 3 * SERVING_CHAIN,
                    "gj_solve": 2 * SERVING_CHAIN, "admm_iterate": 2 * SERVING_CHAIN}
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory rate,
# fp32 rate outside the tensor cores, and that rate's share of one of 132 SMs.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
SM_COUNT = 132
GJ_WARPS = 16    # warps per block of B2 / B3 (csrc/lin_kernels.cu)
ADMM_WARPS = 16  # of B4
# The kernels that hold their matrices in registers: a spill there is a fault.
REGISTER_KERNELS = ("gj_tile_kernel", "gj_cluster_kernel", "chol_inv_base_kernel",
                    "admm_tile_kernel")
# Clocks the card is kept busy while the launches to be timed queue up
# behind (a few ms), so that the events see device time only.
BUSY_CYCLES = 8_000_000
# For a whole B = 1 serving solve, which takes the host ~5-9 ms to enqueue.
SOLVE_BUSY_CYCLES = 60_000_000
# The WBID tick (phases 5 and 6): the G1 23-DoF, nv = 29, nx = 41, m = 80.
WBID_DT = 0.001            # control tick [s]
WBID_TICKS = 40            # one control period of serving ticks
WBID_STANCE_TICKS = 20     # of which double support first, then left swing
SWING_TARGET = (0.05, 0.0, 0.04)  # left foot's swing target from its pose [m]
B_WBID = 2048              # the batched tick (tools/bench_cascade.py's size)
B_WBID_COMPARE = 256       # batched instances held against the plain path
FZ_RTOL = 0.05             # double support: sum fz within 5% of m g
# Per phase (5 serving, 6 batched), twice the largest value the JAX package
# gives at float32 on the CPU for the same states (tools/
# wbid_invariant_bounds.py; .claude/skills/verify/SKILL.md):
SWING_F_MAX_N = {5: 2 * 3.909279257641174e-05, 6: 2 * 0.00016369271907024086}  # [N]
BASE_RES_MAX = {5: 2 * 0.005706787109375, 6: 2 * 0.007476806640625}  # [N, N m]
WBID_CMP_MAX = 1.0         # kernel path vs plain path: |df| [N], |dtau| [N m]
TICK_SAMPLES = 200         # timed serving ticks: 2 samples beyond the p99
TICK_BATCHES = 5           # timed batched ticks
PROFILE_TICKS = 50         # serving ticks under torch.profiler (--profile)
# Launches per path: the serving tick runs B2 for both ADMM segments' K and
# the polish Hr, B3 per polish round (3), B4 per segment; the batched tick
# ends every SPD inverse in B1: 41 -> 20 | 21 (2 per K, 2 segments, and Hr),
# 80 -> 40 -> 20 (4 per polish S, 3 rounds): 18.
WBID_SERVING_LAUNCHES = {"chol_inverse_base": 0, "gj_inverse": 3 * WBID_TICKS,
                         "gj_solve": 3 * WBID_TICKS, "admm_iterate": 2 * WBID_TICKS}
WBID_BATCHED_LAUNCHES = {"chol_inverse_base": 18, "gj_inverse": 0, "gj_solve": 0,
                         "admm_iterate": 0}
# The control period (phases 7-9; engine/tick.py's ControlLoop).
SERVING_PERIODS = 25       # 1.0 s: the stand, the first double support, the first swing
PERIOD_TICKS = 40          # WBID ticks (and plant steps) per period
B_CASCADE = 2048           # the batched cascade (tools/bench_cascade.py's size)
GOLDEN_PERIODS = 20        # 0.8 s of the golden walk, through the first swing onset
GOLDEN_TOL = {"com": 1e-4, "tau": 5e-2, "forces": 5e-1}  # tests/test_golden.py:55-57
CASCADE_REPS = 1           # timed batched periods
# Launches per period: the serving MPC solve B2 3, B3 2, B4 2 and each tick
# B2 3, B3 3, B4 2; the default configuration's MPC solve B1 28 and each
# tick B1 18.
SERVING_PERIOD_LAUNCHES = {
    "chol_inverse_base": 0, "gj_inverse": (3 + PERIOD_TICKS * 3) * SERVING_PERIODS,
    "gj_solve": (2 + PERIOD_TICKS * 3) * SERVING_PERIODS,
    "admm_iterate": (2 + PERIOD_TICKS * 2) * SERVING_PERIODS}
CASCADE_LAUNCHES = {"chol_inverse_base": 28 + PERIOD_TICKS * 18, "gj_inverse": 0,
                    "gj_solve": 0, "admm_iterate": 0}
# Per phase (7 serving, 8 batched), twice the largest value the JAX package
# gives at float32 on the CPU for the same chain (tools/
# period_invariant_bounds.py): MPC and WBID pri_res, a swinging foot's
# contact force [N], the double-support |sum fz - m g| [N] (the first ticks
# lower the CoM from the standing 0.628 m to the 0.598 m target, so the MPC
# plans ~40% less than m g there), the base's tilt [rad]. Where the JAX
# maximum is exactly 0 (no row violated at all; no foot swinging in the one
# standing period of phase 8), the bound is that of the earlier phases
# instead: pri_res < 0.05 (phases 2 and 3), swing |f| <= SWING_F_MAX_N[5].
PERIOD_BOUNDS = {
    7: {"mpc_pri_res": 2 * 0.00390625, "wbid_pri_res": 2 * 0.022430419921875,
        "f_swing_N": 2 * 5.1355080358916894e-05, "fz_dev_N": 2 * 132.95550537109375,
        "tilt_rad": 2 * 0.07162471115589142},
    8: {"mpc_pri_res": 0.05, "wbid_pri_res": 2 * 0.013153076171875,
        "f_swing_N": SWING_F_MAX_N[5], "fz_dev_N": 2 * 132.9462890625,
        "tilt_rad": 2 * 0.010178102180361748},
}
# A period through the kernels against the same period through their plain
# versions: |df| [N], |dtau| [N m] over the ticks, |dq| at the period's end.
PERIOD_CMP_MAX = {"df": 1.0, "dtau": 1.0, "dq": 1e-3}
# The SRBD-level closed loop (phases 10-12; mpc/srbd_loop.py's SRBDLoop):
# planner, MPC and the rigid body, each period one MPC solve.
SRBD_COM_HEIGHT = 0.598    # the loop's CoM height target [m]
B_SRBD = 4096              # phase 10: a batch user's gait sweep
SRBD_PERIODS = 200         # 8 s: 8 steps and the settle (tests/test_srbd_loop.py:18-30)
SRBD_KICK_AT = 60          # the period of each instance's lateral kick
SRBD_KICK_MAX = 0.15       # kicks drawn in [0, SRBD_KICK_MAX] m/s (test_srbd_walk_kick_recovery)
SRBD_COMPARE = 8           # phase 10 instances held against the plain path
SRBD_SERVING_PERIODS = 50  # phase 11: 2 s of data-dependent B = 1 periods
SRBD_CMP_MAX = {"du0": DU0_MAX_N, "dx": 1e-3}  # kernel path vs plain path, one period
# Per phase (10 batched, 11 serving), twice the largest value the JAX
# package gives at float32 on the CPU for the same loop
# (tools/period_invariant_bounds.py srbd_batched srbd_serving): pri_res and
# the CoM height's deviation from its target [m]. The force on a swinging
# foot's contacts is exactly 0 (the solve masks it).
SRBD_BOUNDS = {
    10: {"pri_res": 2 * 0.9044551849365234, "com_z_dev_m": 2 * 0.14531230926513672},
    11: {"pri_res": 2 * 2.04301904886961e-05, "com_z_dev_m": 2 * 0.021333694458007812},
}
# Launches per SRBD-loop period: MPCConfig()'s solve B1 28 (12 at n = 30, 16
# at n = 25); with polish_kernel B2 3, B3 2, B4 2 (30 iterations a segment).
SRBD_LAUNCHES = {"chol_inverse_base": 28 * SRBD_PERIODS, "gj_inverse": 0, "gj_solve": 0,
                 "admm_iterate": 0}
SRBD_SERVING_LAUNCHES = {"chol_inverse_base": 0, "gj_inverse": 3 * SRBD_SERVING_PERIODS,
                         "gj_solve": 2 * SRBD_SERVING_PERIODS,
                         "admm_iterate": 2 * SRBD_SERVING_PERIODS}
# Phase 12's walk: tests/test_srbd_loop.py:33-57's bar.
SRBD_WALK_BAR = {"com_z_atol": 0.055, "com_z_settle_atol": 2e-3, "com_y_max": 0.25,
                 "com_x_final": (0.25, 0.65), "v_final_max": 0.05, "touchdowns": 4}
# Phase 13: the variant cascade, one default-configuration period at B =
# 2048 with the variant's torso / hand tasks. The WBID QP's nx = nv + 12 =
# 47 / 61 and m = 92 / 120 end in B1 at new block sizes: 47 -> 23 | 24,
# 92 -> 46 -> 23 (18 a tick); 61 -> 30 | 31 -> 15 | 16, 120 -> 60 -> 30 (21
# a tick); the MPC solve 28 as in phase 8.
B_VARIANT = 2048
VARIANTS = ("g1_29dof", "g1_29dof_with_hand")
VARIANT_LAUNCHES = {
    v: {"chol_inverse_base": 28 + PERIOD_TICKS * per_tick, "gj_inverse": 0, "gj_solve": 0,
        "admm_iterate": 0}
    for v, per_tick in (("g1_29dof", 18), ("g1_29dof_with_hand", 21))}
# Twice the JAX package's f32 maxima of the same period
# (tools/period_invariant_bounds.py g1_29dof g1_29dof_with_hand); a 0
# maximum (the period is standing) takes the earlier phases' bound. The
# WBID's pri_res is held to the tick's own bound, pri_res < 0.05 (phases 5
# and 6), instead: at float32 it is the ADMM's rounding floor, a spread
# that both packages share, so the largest of 40 ticks is a draw from it
# (tools/wbid_f32_cross.py, on the 29-DoF period's QPs: the JAX solver
# 7.263e-03 on its own, 9.003e-03 on the port's; the port's 9.644e-03 on
# the JAX package's; 1.67e-06 for both at float64; the polish keeps no
# round in either package).
PERIOD_BOUNDS.update({
    "g1_29dof": {"mpc_pri_res": 0.05, "wbid_pri_res": 0.05,
                 "f_swing_N": SWING_F_MAX_N[5], "fz_dev_N": 2 * 157.66336059570312,
                 "tilt_rad": 2 * 0.004979516379535198},
    "g1_29dof_with_hand": {"mpc_pri_res": 0.05, "wbid_pri_res": 0.05,
                           "f_swing_N": SWING_F_MAX_N[5], "fz_dev_N": 2 * 93.91232299804688,
                           "tilt_rad": 2 * 0.005382186267524958},
})
# The MPC class (phase 14; tests/test_compat_api.py:10-49's standing case):
# two updates, B1 28 each.
API_LAUNCHES = {"chol_inverse_base": 2 * 28, "gj_inverse": 0, "gj_solve": 0, "admm_iterate": 0}
# Phase 15: the pod sweep (parallel/sweep.py), SweepSpec()'s 4096 scenarios
# drawn by randomize from a CPU generator of this seed, the default
# EngineConfig: SWEEP_PERIODS periods unchunked, then as that many chunks of
# one period through a utils/checkpoint save and restore. B1 748 a period.
SWEEP_SEED = 0
SWEEP_PERIODS = 2
B1_F64_SIZES = (30, 25, 21, 20)  # phase 1: B1 at float64, the sweep's block sizes
SWEEP_LAUNCHES = {"chol_inverse_base": CASCADE_LAUNCHES["chol_inverse_base"] * SWEEP_PERIODS,
                  "gj_inverse": 0, "gj_solve": 0, "admm_iterate": 0}
SWEEP_STATS_RTOL = 1e-5  # chunked against unchunked: com_drift_sum, tau_max
# Twice the JAX package's f32 maxima over the same 4096 drawn scenarios
# (tools/period_invariant_bounds.py sweep); a 0 maximum (the MPC's pri_res,
# and no foot swings before the gait starts at 0.5 s) takes the earlier
# phases' bound, as phase 8. The randomized SRBD mass moves the MPC's
# double-support sum fz off the plant's m g, so phase 8's fz bound does
# not carry over. The WBID's pri_res is held to the tick's own bound, as in
# phase 13: at f32 it is the ADMM's rounding floor, and on the first 512 of
# these scenarios on the CPU the port reaches 4.309e-02 where the JAX
# package reaches 1.825e-02 (2.063e-02 over all 4096); at f64 the two agree
# to 5e-10 N in the forces (tests/test_torch_sweep_batch.py).
PERIOD_BOUNDS[15] = {"mpc_pri_res": 0.05, "wbid_pri_res": 0.05,
                     "f_swing_N": SWING_F_MAX_N[5], "fz_dev_N": 2 * 142.73638916015625,
                     "tilt_rad": 2 * 0.03032771311700344}
# The gait sweep demo (api/demos.demo_gait_sweep, BASELINE config 3): two
# batched MPC solves (the first builds, the second is timed), B1 28 each.
GAIT_SWEEP_LAUNCHES = {"chol_inverse_base": 2 * 28, "gj_inverse": 0, "gj_solve": 0,
                       "admm_iterate": 0}
# Phase 16: telemetry (EngineConfig.telemetry: CUDA events around the MPC
# solve and each tick's WBID solve) on one serving period and one default
# period at B_CASCADE; the launches those periods make with telemetry off.
TELEMETRY_LAUNCHES = {
    "serving": {k: v // SERVING_PERIODS for k, v in SERVING_PERIOD_LAUNCHES.items()},
    "batched": CASCADE_LAUNCHES}
# Phases 1 and 3: serving solves with the roll-moment cap
# (MPCConfig.roll_moment_max, one more row per knot: m = 210), past the
# float32 tiles of B3 and B4 at 13 rows a thread: B3 runs its two-CTA cluster
# tile, B4 its tile with 14 rows of A a thread. Phase 3's capped chain
# launches as the serving chain, and by these routes only.
ROLL_MOMENT_MAX = 20.0
CAPPED_ROUTES = {"gj_solve": "cluster", "admm_iterate": "tile14"}
CAPPED_SAMPLES = 200  # timed capped serving solves (host clock)
# Phase 1: B3's cluster tile on seeded SPD systems at its edges and the
# cap's width, at B = 1 and at more clusters than the card has pairs of SMs;
# B4's 14-row tile on seeded QPs (n, m).
B3_CLUSTER_CASES = [(m, b) for m in (209, 210, 224, 240) for b in (1, 150)]
B4_WIDE_CASES = [(120, 209), (120, 210), (128, 224)]
CLUSTER_SMS = 2  # SMs of B3's cluster tile
# Phase 17: the MuJoCo bridge at float64 (B = 1, the default EngineConfig,
# tests/test_engine_mujoco.py's standing scenario) on the recorded trace of
# the JAX package's MujocoLoop (tools/record_mujoco_trace.py).
TRACE = "tests/torch_mujoco_trace.npz"
BRIDGE_TICKS = 2 * PERIOD_TICKS  # two periods of the trace
# The golden's tolerances (tau [N m], contact normal forces [N], CoM [m]):
# on some ticks the WBID QP's polish takes another acceptance decision than
# the JAX package's jitted tick, which moves tau by ~1e-2 N m (the JAX
# package's own eager tick does so too: tools/record_mujoco_trace.py
# --compare-eager); elsewhere the two agree to ~1e-12
# (tests/test_torch_mujoco.py). The same bound holds the plain path.
BRIDGE_TOL = {"tau": 5e-2, "fz": 0.5, "com": 1e-4}
# The closed loop in MuJoCo, where installed: the standing bar of
# tools/torch_mujoco_bar.py (test_standing_balance_in_mujoco's invariants).
BRIDGE_LOOP_TICKS = 200
PEAK_FP64_FLOPS = 34e12    # fp64 outside the tensor cores (H100 SXM data sheet)


def bridge_launches(ticks: int) -> dict:
    """B1 launches of `ticks` bridge ticks from tick 0: 28 per MPC solve
    (every PERIOD_TICKS ticks), 18 a tick."""
    return {"chol_inverse_base": 28 * -(-ticks // PERIOD_TICKS) + 18 * ticks,
            "gj_inverse": 0, "gj_solve": 0, "admm_iterate": 0}


REPLACES = {
    "chol_inverse_base": "g1_locomotion_tpu/ops/pallas_lin.py:118",
    "gj_inverse": "g1_locomotion_tpu/ops/pallas_lin.py:271",
    "gj_solve": "g1_locomotion_tpu/ops/pallas_lin.py:215",
    "admm_iterate": "g1_locomotion_tpu/ops/pallas_lin.py:374",
}


# Every path but the capped serving chain takes the routes the kernels took
# before the cluster and 14-row tiles (cuda_lin.route_counts()).
EARLIER_ROUTES = {"warp", "tile", "tile13"}
ROUTE_LAUNCHES: dict = {}  # {kernel: {route: launches}} over every path read


def read_counts(routes=EARLIER_ROUTES) -> dict:
    """One path's launches (since the last cuda_lin.reset_launch_counts()),
    as cuda_lin.launch_counts() gives them; their routes are added to
    ROUTE_LAUNCHES, and with `routes` any other route is a fault."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    for name, by_route in cuda_lin.route_counts().items():
        if routes is not None and set(by_route) - routes:
            raise AssertionError(f"{name} took routes {by_route}, expected only {routes}")
        for route, count in by_route.items():
            total = ROUTE_LAUNCHES.setdefault(name, {})
            total[route] = total.get(route, 0) + count
    return cuda_lin.launch_counts()


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def configs():
    from g1_locomotion_tpu_torch.mpc.solver import MPCConfig
    from g1_locomotion_tpu_torch.ops.qp import QPConfig

    qp = QPConfig(iters=20, scaling_iters=0, rho=1.0, rho_segments=2, polish_rounds=2,
                  iter_precision="high")
    return (MPCConfig(horizon=10, qp=qp),
            MPCConfig(horizon=10, qp=qp._replace(polish_kernel=True)))


def bench_inputs(B: int, device, dtype, seed: int = 0):
    """bench.py's workload: standing CoM over four foot contacts, mixed
    standing / left-swing / right-swing patterns, lateral CoM offsets."""
    from g1_locomotion_tpu_torch.models.srbd import GRAVITY

    N = 10
    gen = torch.Generator().manual_seed(seed)
    com = torch.tensor([0.0527, 0.0, 0.598], dtype=dtype)
    feet = torch.tensor([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0],
                         [-0.05, -0.12, 0.0], [0.12, -0.12, 0.0]], dtype=dtype)
    x0 = torch.zeros(13, dtype=dtype)
    x0[3:6] = com
    x0[12] = GRAVITY
    stand = torch.ones((N, 4), dtype=dtype)
    left_up, right_up = stand.clone(), stand.clone()
    left_up[:, :2] = 0.0
    right_up[:, 2:] = 0.0
    pattern = torch.randint(0, 3, (B,), generator=gen)
    pattern[: min(B, 3)] = torch.arange(min(B, 3))  # every pattern up front
    x0s = x0.repeat(B, 1)
    x0s[:, 4] += (torch.rand(B, generator=gen, dtype=dtype) - 0.5) * 0.06
    return {k: v.to(device) for k, v in dict(
        x0=x0s, x_ref=x0.repeat(N, 1), contact=torch.stack([stand, left_up, right_up])[pattern],
        c_hor=feet.repeat(N, 1, 1), p_hor=com.repeat(N, 1),
    ).items()}


def solver_for(cfg, device, dtype):
    from g1_locomotion_tpu_torch.models import srbd
    from g1_locomotion_tpu_torch.mpc import solver as mpc

    return mpc.MPCSolver(cfg, mpc.default_weights(device=device, dtype=dtype),
                         srbd.default_params(device=device, dtype=dtype))


def run(solver, inp, rows=slice(None)):
    return solver(inp["x0"][rows], inp["x_ref"], inp["contact"][rows], inp["c_hor"],
                  inp["p_hor"])


def wbid_configs():
    """(serving, batched) WBIDConfig: the serving tick of
    tools/bench_tick_p99.py (``polish_kernel``, ``fast_stack``) and the
    default WBIDConfig of tools/bench_cascade.py (matmul inverses)."""
    from g1_locomotion_tpu_torch.wbid.solver import WBIDConfig

    base = WBIDConfig()
    return base._replace(qp=base.qp._replace(polish_kernel=True), fast_stack=True), base


def wbid_batch_spec(B: int, nj: int, seed: int = 0) -> dict:
    """The batched tick's instances in numpy (tools/wbid_invariant_bounds.py
    makes the same): contact pattern 0 double support, 1 left swing, 2 right
    swing (every one among the first three), joint offsets from the
    standing pose, velocities, CoM reference offsets."""
    rng = np.random.default_rng(seed)
    pattern = rng.integers(0, 3, B)
    pattern[: min(B, 3)] = np.arange(min(B, 3))
    return dict(pattern=pattern, dqj=rng.uniform(-0.02, 0.02, (B, nj)),
                v=rng.uniform(-0.002, 0.002, (B, 6 + nj)),
                dcom=rng.uniform(-5e-4, 5e-4, (B, 3)))


def wbid_refs(model, idx, q, active, com_offset=None):
    """Quiet-stance references at the state q (tests/test_wbid.py's
    standing_refs), batched: CoM, base and feet held where they are, each
    swinging foot's target SWING_TARGET from its pose, the weight split
    over the stance contacts. active (B, 2) is the feet's stance flag."""
    from g1_locomotion_tpu_torch.models import robot as rb
    from g1_locomotion_tpu_torch.models.dynamics import GRAVITY
    from g1_locomotion_tpu_torch.wbid.tasks import WBIDReferences

    B = q.shape[0]
    X = rb.fk(model, q)
    feet = [rb.frame_pose(model, X, f) for f in idx.feet]
    foot_p = torch.stack([P.p for P in feet], dim=1)
    foot_R = torch.stack([P.R for P in feet], dim=1)
    on = active.repeat_interleave(2, dim=1)  # (B, 4) contacts
    fz = model.total_mass * GRAVITY * on / on.sum(dim=1, keepdim=True)
    zeros3 = q.new_zeros((B, 3))
    com = rb.com_position(model, X)
    return WBIDReferences(
        com_pos=com if com_offset is None else com + com_offset,
        com_vel=zeros3, com_acc=zeros3, base_R=X.R[:, 0], base_angvel=zeros3,
        base_angacc=zeros3, posture_q=q[:, 7:], contact_pos=foot_p, contact_R=foot_R,
        swing_pos=foot_p + (1 - active)[..., None] * q.new_tensor(SWING_TARGET),
        swing_vel=q.new_zeros((B, 2, 3)), swing_acc=q.new_zeros((B, 2, 3)), swing_R=foot_R,
        f_des=torch.stack([torch.zeros_like(fz), torch.zeros_like(fz), fz], dim=-1),
        contact_active=active, angmom_L=zeros3, angmom_Ldot=zeros3,
    )


def wbid_batch(model, idx, B: int, device, dtype, seed: int = 0):
    """(q, v, refs) of the batched tick on the card."""
    from g1_locomotion_tpu_torch.engine.state import q_init_standing

    spec = wbid_batch_spec(B, model.nj, seed)
    q = q_init_standing(model, B)
    q[:, 7:] += torch.tensor(spec["dqj"], dtype=dtype).to(device)
    active = torch.tensor([[1.0, 1.0], [0.0, 1.0], [1.0, 0.0]], dtype=dtype)[spec["pattern"]]
    refs = wbid_refs(model, idx, q, active.to(device),
                     torch.tensor(spec["dcom"], dtype=dtype).to(device))
    return q, torch.tensor(spec["v"], dtype=dtype).to(device), refs


def wbid_violations(model, sol, active, phase: int) -> dict:
    """The largest violation of each WBID invariant over the batch (a value
    <= 0 means it holds): non-finite count, pri_res - 0.05,
    |tau| - tau_max - 1e-4, double support |sum fz - m g| - FZ_RTOL m g,
    swing contacts |f| - SWING_F_MAX_N, |base_wrench_res| - BASE_RES_MAX
    (the bounds of `phase`).
    Also the raw maxima, for the record."""
    from g1_locomotion_tpu_torch.models.dynamics import GRAVITY

    mg = float(model.total_mass) * GRAVITY
    finite = all(bool(torch.isfinite(getattr(sol, k)).all()) for k in sol._fields)
    on = active.repeat_interleave(2, dim=1) > 0.5
    double = active.sum(dim=1) > 1.5
    fz_err = (sol.forces[..., 2].sum(dim=1) - mg).abs()
    f_swing = torch.where(on[..., None], 0.0, sol.forces).abs().amax()
    tau_over = (sol.tau.abs() - model.tau_max).amax()
    res = sol.base_wrench_res.abs().amax()
    fz_dev = float(fz_err[double].amax()) if bool(double.any()) else 0.0
    return {
        "non_finite": 0.0 if finite else 1.0,
        "pri_res": float(sol.pri_res.amax()) - 0.05,
        "tau_over": float(tau_over) - 1e-4,
        "fz_double": fz_dev - FZ_RTOL * mg,
        "f_swing": float(f_swing) - SWING_F_MAX_N[phase],
        "base_res": float(res) - BASE_RES_MAX[phase],
        "max": {"pri_res": float(sol.pri_res.amax()), "fz_dev_N": fz_dev,
                "f_swing_N": float(f_swing), "base_res": float(res),
                "tau_over_limit": float(tau_over)},
    }


def check_wbid(label: str, worst: dict, phase: int) -> None:
    bad = [k for k, x in worst.items() if k != "max" and x > 0]
    print(f"{label}: " + ("invariants ok" if not bad else f"FAILED {bad}") + f"; maxima {worst['max']}"
          f" (bounds: pri_res < 0.05, |tau| <= tau_max + 1e-4, double-support sum fz within "
          f"{FZ_RTOL:.0%} of m g, swing |f| <= {SWING_F_MAX_N[phase]:.3e} N, |base_wrench_res| "
          f"<= {BASE_RES_MAX[phase]:.3e})")
    if bad:
        raise AssertionError(f"{label}: WBID invariants violated: {bad}")


def merge_worst(a: dict, b: dict) -> dict:
    out = {k: max(a[k], b[k]) for k in a if k != "max"}
    out["max"] = {k: max(a["max"][k], b["max"][k]) for k in a["max"]}
    return out


def engine_configs():
    """(serving, batched) EngineConfig with the configuration logged per
    tick (``log_q``, for the tilt): the serving period of
    tools/bench_tick_p99.py (``polish_kernel`` on both QPs, ``fast_stack``)
    and the default EngineConfig of tools/bench_cascade.py."""
    from g1_locomotion_tpu_torch.engine.tick import EngineConfig

    base = EngineConfig(log_q=True)
    serving = base._replace(
        mpc=base.mpc._replace(qp=base.mpc.qp._replace(polish_kernel=True)),
        wbid=base.wbid._replace(qp=base.wbid.qp._replace(polish_kernel=True), fast_stack=True))
    return serving, base


def period_maxima(log: dict, tau_max: np.ndarray, mg: float) -> dict:
    """The largest value of each period invariant over a log's instances and
    ticks (numpy arrays, ticks and instances in the leading axes, as
    TickLog's fields): non-finite values (a count), MPC and WBID pri_res,
    the force on a swinging foot's contacts (the MPC's contact flag 0), the
    double-support |sum fz - m g|, the base's tilt from upright (from the
    logged q), |tau| beyond tau_max. tools/period_invariant_bounds.py gives
    it the JAX package's logs."""
    non_finite = sum(int((~np.isfinite(log[k])).sum())
                     for k in ("com", "tau", "forces", "q", "mpc_pri_res", "wbid_pri_res"))
    contact, forces = log["contact"], log["forces"]
    swing = contact < 0.5
    f_swing = float(np.abs(forces[swing]).max()) if swing.any() else 0.0
    double = contact.min(axis=-1) > 0.5
    fz_dev = np.abs(forces[..., 2].sum(axis=-1) - mg)[double]
    quat = log["q"][..., 3:7]
    r22 = 1.0 - 2.0 * (quat[..., 1] ** 2 + quat[..., 2] ** 2)
    return {"non_finite": non_finite, "mpc_pri_res": float(log["mpc_pri_res"].max()),
            "wbid_pri_res": float(log["wbid_pri_res"].max()), "f_swing_N": f_swing,
            "fz_dev_N": float(fz_dev.max()) if fz_dev.size else 0.0,
            "tilt_rad": float(np.arccos(np.clip(r22, -1.0, 1.0)).max()),
            "tau_over": float((np.abs(log["tau"]) - tau_max).max())}


def log_numpy(log) -> dict:
    return {k: v.detach().cpu().double().numpy() for k, v in log._asdict().items()}


def check_period(label: str, maxima: dict, phase: int) -> None:
    bounds = PERIOD_BOUNDS[phase]
    bad = [k for k, b in bounds.items() if not maxima[k] <= b]
    bad += [k for k in ("non_finite",) if maxima[k]] + (
        ["tau_over"] if maxima["tau_over"] > 1e-4 else [])
    print(f"{label}: " + ("invariants ok" if not bad else f"FAILED {bad}") + f"; maxima {maxima}"
          f" (bounds: no NaN, |tau| <= tau_max + 1e-4, "
          + ", ".join(f"{k} <= {b:.3e}" for k, b in bounds.items()) + ")")
    if bad:
        raise AssertionError(f"{label}: period invariants violated: {bad}")


def compare_periods(label: str, kernel, plain) -> None:
    """A period through the kernels against the same period through their
    plain versions: ((state, log), (state, log)), within PERIOD_CMP_MAX."""
    torch.cuda.synchronize()
    (ks, kl), (ps, pl) = kernel, plain
    d = {"df": float((kl.forces - pl.forces).abs().amax()),
         "dtau": float((kl.tau - pl.tau).abs().amax()),
         "dq": float((ks.q - ps.q).abs().amax())}
    print(f"{label}: kernel path vs plain path |df| max {d['df']:.3e} N, |dtau| max "
          f"{d['dtau']:.3e} N m, |dq| at the period's end {d['dq']:.3e} (bounds {PERIOD_CMP_MAX})")
    if not all(d[k] <= PERIOD_CMP_MAX[k] for k in d):
        raise AssertionError(f"{label}: the kernel path differs from the plain path")


def check_golden(log, periods: int) -> dict:
    """The walk's log (B = 1) against the first rows of the golden: contact
    flags equal, CoM, tau and forces within GOLDEN_TOL. Returns the largest
    deviations."""
    from pathlib import Path

    n = periods * PERIOD_TICKS
    with np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "walk_golden.npz") as z:
        golden = {k: z[k][:n] for k in ("com", "tau", "forces", "contact")}
    got = {k: v.reshape((n,) + golden[k].shape[1:])
           for k, v in log_numpy(log).items() if k in golden}
    if not np.array_equal(got["contact"], golden["contact"]):
        raise AssertionError("phase 9: the contact sequence differs from the golden's")
    dev = {k: float(np.abs(got[k] - golden[k]).max()) for k in GOLDEN_TOL}
    if not all(dev[k] <= GOLDEN_TOL[k] for k in dev):
        raise AssertionError(f"phase 9: deviations {dev} beyond {GOLDEN_TOL}")
    return dev


def srbd_kicks(batch: int, periods: int = SRBD_PERIODS, seed: int = 0) -> np.ndarray:
    """(batch, periods, 3) velocity kicks of phase 10: each instance's
    lateral kick at period SRBD_KICK_AT, drawn in [0, SRBD_KICK_MAX] m/s
    from a seeded generator (so any first instances are the same draws)."""
    kicks = np.zeros((batch, periods, 3))
    kicks[:, SRBD_KICK_AT, 1] = np.random.default_rng(seed).uniform(0.0, SRBD_KICK_MAX, batch)
    return kicks


def srbd_maxima(log: dict) -> dict:
    """The largest value of each SRBD-loop invariant over a log's instances
    and periods (numpy arrays (B, periods, ...), as SRBDLoopLog's fields):
    non-finite values (a count), pri_res, the force on the contacts of a
    foot that swings in that period (its previous period's end flag is 0),
    the CoM height's deviation from SRBD_COM_HEIGHT.
    tools/period_invariant_bounds.py gives it the JAX package's logs."""
    non_finite = sum(int((~np.isfinite(log[k])).sum()) for k in ("x", "u0", "pri_res"))
    flags = np.concatenate([np.ones_like(log["contact"][:, :1]), log["contact"][:, :-1]], axis=1)
    swing = np.repeat(flags < 0.5, 2, axis=-1)  # (B, periods, 4) contacts
    forces = log["u0"].reshape(swing.shape + (3,))
    return {"non_finite": non_finite, "pri_res": float(log["pri_res"].max()),
            "f_swing_N": float(np.abs(forces[swing]).max()) if swing.any() else 0.0,
            "com_z_dev_m": float(np.abs(log["x"][..., 5] - SRBD_COM_HEIGHT).max())}


def check_srbd(label: str, maxima: dict, phase: int) -> None:
    bounds = SRBD_BOUNDS[phase]
    bad = [k for k, b in bounds.items() if not maxima[k] <= b]
    bad += [k for k in ("non_finite", "f_swing_N") if maxima[k]]
    print(f"{label}: " + ("invariants ok" if not bad else f"FAILED {bad}") + f"; maxima {maxima}"
          f" (bounds: no NaN, swing forces exactly 0, "
          + ", ".join(f"{k} <= {b:.3e}" for k, b in bounds.items()) + ")")
    if bad:
        raise AssertionError(f"{label}: SRBD-loop invariants violated: {bad}")


def compare_srbd(label: str, kernel, plain) -> None:
    """One SRBD-loop period through the kernels against the same period
    through their plain versions: ((state, log), (state, log))."""
    torch.cuda.synchronize()
    (ks, kl), (ps, pl) = kernel, plain
    d = {"du0": float((kl.u0 - pl.u0).abs().amax()), "dx": float((ks.x - ps.x).abs().amax())}
    print(f"{label}: kernel path vs plain path |du0| max {d['du0']:.3e} N, |dx| at the "
          f"period's end {d['dx']:.3e} (bounds {SRBD_CMP_MAX})")
    if not all(d[k] <= SRBD_CMP_MAX[k] for k in d):
        raise AssertionError(f"{label}: the kernel path differs from the plain path")


def check_srbd_walk(log) -> dict:
    """tests/test_srbd_loop.py:33-57's assertions on a B = 1 walk's log;
    returns the values checked."""
    x = log.x[0].double().cpu().numpy()
    c = log.contact[0].double().cpu().numpy()
    bar = SRBD_WALK_BAR
    td = np.clip(np.diff((c > 0.5).astype(int), axis=0), 0, 1).sum(axis=0)
    got = {"finite": bool(np.isfinite(x).all()),
           "com_z_dev": float(np.abs(x[:, 5] - SRBD_COM_HEIGHT).max()),
           "com_z_settle_dev": float(np.abs(x[-20:, 5] - SRBD_COM_HEIGHT).max()),
           "com_y_max": float(np.abs(x[:, 4]).max()), "com_x_final": float(x[-1, 3]),
           "v_final_max": float(np.abs(x[-1, 9:11]).max()), "touchdowns": td.tolist()}
    held = (got["finite"] and got["com_z_dev"] <= bar["com_z_atol"]
            and got["com_z_settle_dev"] <= bar["com_z_settle_atol"]
            and got["com_y_max"] < bar["com_y_max"]
            and bar["com_x_final"][0] < got["com_x_final"] < bar["com_x_final"][1]
            and got["v_final_max"] < bar["v_final_max"] and min(td) >= bar["touchdowns"])
    if not held:
        raise AssertionError(f"phase 12: the SRBD walk misses the bar {bar}: {got}")
    return got


def serving_chain(solver, model, idx, device, dtype, ticks=WBID_TICKS, record=None):
    """The serving tick's data-dependent chain from the standing pose: each
    tick's qddot feeds v += qddot dt, q = integrate_q(q, v, dt); the first
    WBID_STANCE_TICKS in double support, the rest with the left foot
    swinging. The references are those of the standing state. Returns the
    invariants' worst values over the chain and the final (q, v)."""
    from g1_locomotion_tpu_torch.engine.state import standing_state
    from g1_locomotion_tpu_torch.models import robot as rb

    q, v = standing_state(model, 1)
    stances = [q.new_tensor([[1.0, 1.0]]), q.new_tensor([[0.0, 1.0]])]
    refs = [wbid_refs(model, idx, q, a) for a in stances]
    worst = None
    for t in range(ticks):
        k = 0 if t < WBID_STANCE_TICKS else 1
        sol = solver(q, v, refs[k])
        if record is not None:
            record.append((q, v, refs[k]))
        w = wbid_violations(model, sol, stances[k], phase=5)
        worst = w if worst is None else merge_worst(worst, w)
        v = v + sol.qddot * WBID_DT
        q = rb.integrate_q(model, q, v, WBID_DT)
    return worst, (q, v, refs[1])


def take(t, n: int):
    """The first n instances of a NamedTuple of batched tensors (None stays)."""
    return type(t)(*(None if x is None else x[:n] for x in t))


def compare_paths(label: str, kernel_sol, plain_sol) -> None:
    """The WBID tick through the kernels against the same tick through their
    plain versions: forces within WBID_CMP_MAX N and torques within
    WBID_CMP_MAX N m."""
    torch.cuda.synchronize()
    df = float((kernel_sol.forces - plain_sol.forces).abs().amax())
    dtau = float((kernel_sol.tau - plain_sol.tau).abs().amax())
    print(f"{label}: kernel path vs plain path |df| max {df:.3e} N, |dtau| max {dtau:.3e} N m "
          f"(each <= {WBID_CMP_MAX})")
    if not (df <= WBID_CMP_MAX and dtau <= WBID_CMP_MAX):
        raise AssertionError(f"{label}: the kernel path differs from the plain path")


def mpc_class_case(device):
    """(a fresh MPC class on the card, the arguments of its update): the
    standing case of tests/test_compat_api.py:10-49."""
    from g1_locomotion_tpu_torch.mpc.api import MPC

    api = MPC(dt=0.04, device=device)
    api.init_matrices()
    api.x0[3:6] = np.array([[5.26790425e-02], [7.44339342e-05], [5.97983255e-01]])
    api.x_ref_hor[:, :] = 0.0
    api.x_ref_hor[0, :] = api.x0[:, 0]
    api.x_ref_hor[:, 3:6] = api.x0[3:6, 0]
    api.x_ref_hor[:, -1] = api.g
    feet = np.array([[-0.05, 0.12, 0.0], [0.12, 0.12, 0.0], [-0.05, -0.12, 0.0],
                     [0.12, -0.12, 0.0]])
    return api, ([np.ones(4)] * api.HORIZON_LENGTH, [feet.reshape(-1)] * api.HORIZON_LENGTH,
                 api.x_ref_hor[:, 3:6].copy())


def first_per_shape(recorded):
    """One B = 1 instance of the first recorded call of each instance shape
    and set of scalar arguments (for B4: each iteration count)."""
    seen, out = set(), []
    for _, args, _ in recorded:
        key = tuple(tuple(a.shape[1:]) if isinstance(a, torch.Tensor) else a for a in args)
        if key not in seen:
            seen.add(key)
            out.append([a[:1].contiguous() if isinstance(a, torch.Tensor) else a for a in args])
    return out


@contextlib.contextmanager
def replaced_kernels(make):
    """Swap each kernel wrapper in ops/cuda_lin for make(name, wrapper)."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    saved = {name: getattr(cuda_lin, name) for name in cuda_lin.PLAIN}
    try:
        for name, fn in saved.items():
            setattr(cuda_lin, name, make(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_lin, name, fn)


def plain_kernels():
    """Route the main path through the plain versions (for the comparison)."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    return replaced_kernels(lambda name, fn: cuda_lin.PLAIN[name])


def recording_kernels(calls, per_shape: int = 3):
    """Record each kernel's inputs on the main path: the first `per_shape`
    calls of each input shape and dtype (for B2 on the serving path: the K of both
    ADMM segments and the polish Hr) and, beyond them, the first call with
    each further layout (for B1: every strided view the recursion hands
    it), as calls[name] = [(shapes, args, strides)]. The
    arguments are kept as dense copies; `strides` are those of the tensors
    among the arguments and then of ``out``, as the path gave them."""

    def make(name, fn):
        def wrapper(*args, **kwargs):
            tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
            # The input shapes and then the dtype (B1 runs at both types).
            key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor)) + (
                tensors[0].dtype,)
            strides = tuple(a.stride() for a in tensors)
            seen = calls.setdefault(name, [])
            if (sum(k == key for k, _, _ in seen) < per_shape
                    or not any(k == key and st == strides for k, _, st in seen)):
                seen.append((key, [a.contiguous().clone() if isinstance(a, torch.Tensor) else a
                                   for a in args], strides))
            return fn(*args, **kwargs)
        return wrapper

    return replaced_kernels(make)


def strided_copy(t: torch.Tensor, stride, fill: float = 7.0):
    """(buffer, view): a view with strides `stride` that equals `t`, inside a
    fresh flat buffer that holds `fill` everywhere else."""
    size = 1 + sum((n - 1) * st for n, st in zip(t.shape, stride))
    buf = torch.full((size,), fill, dtype=t.dtype, device=t.device)
    view = buf.as_strided(tuple(t.shape), stride)
    view.copy_(t)
    return buf, view


def check_invariants(sol, contact, label: str) -> None:
    """Standing instances carry m*g within 1%; swing contacts carry exactly 0;
    the post-polish constraint residual is below 0.05 N; no NaN."""
    from g1_locomotion_tpu_torch.models.srbd import G1_MASS, GRAVITY

    for k in ("u0", "U", "x_horizon", "pri_res", "dua_res"):
        if not torch.isfinite(getattr(sol, k)).all():
            raise AssertionError(f"{label}: non-finite {k}")
    mg = G1_MASS * -GRAVITY
    standing = contact[:, 0].sum(dim=-1) == 4
    fz = sol.u0[standing][:, 2::3].sum(dim=-1)
    if standing.any() and not torch.all((fz - mg).abs() <= 0.01 * mg):
        raise AssertionError(f"{label}: standing sum fz in [{fz.min():.3f}, {fz.max():.3f}] N, "
                             f"m*g = {mg:.3f} N")
    swing = contact[:, 0].repeat_interleave(3, dim=-1) == 0
    if not torch.all(sol.u0[swing] == 0):
        raise AssertionError(f"{label}: swing-contact forces are not exactly 0")
    if float(sol.pri_res.max()) >= 0.05:
        raise AssertionError(f"{label}: pri_res max {float(sol.pri_res.max()):.3e} >= 0.05 N")
    print(f"{label}: invariants ok: {int(standing.sum())} standing, sum fz "
          f"[{float(fz.min()) if standing.any() else float('nan'):.3f}, "
          f"{float(fz.max()) if standing.any() else float('nan'):.3f}] N (m*g {mg:.3f}), "
          f"pri_res max {float(sol.pri_res.max()):.3e} N, "
          f"dua_res max {float(sol.dua_res.max()):.3e}")


def cuda_ms(fn, reps: int, warmup: int = 2, queue_ahead: bool = False,
            busy_cycles: int = BUSY_CYCLES) -> float:
    """Mean device time of fn() in ms, CUDA events around `reps` calls. With
    `queue_ahead` the card is first kept busy for `busy_cycles` clocks, so
    that the calls queue up behind and run back to back whatever the host
    takes to make them (for calls that enqueue without waiting for the
    card, and take the host less than that)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_ahead:
        torch.cuda._sleep(busy_cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def eye_residual(K: torch.Tensor, X: torch.Tensor) -> float:
    """max |K X - I| (X an inverse of K)."""
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return float((K @ X - eye).abs().amax())


def chol_residuals(K: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """max |K W'W - I| per instance (W = L^-1 of K = L L'), in float64 so
    that a huge W (a block that is not numerically SPD) does not overflow;
    NaN where W is not finite."""
    K, W = K.double(), W.double()
    eye = torch.eye(K.shape[-1], dtype=torch.float64, device=K.device)
    return (K @ (W.mT @ W) - eye).abs().flatten(1).amax(dim=1)


def random_spd(b: int, n: int, cond: float, seed: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """(b, n, n) SPD matrices with eigenvalues in [1, cond]."""
    gen = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn((b, n, n), generator=gen, dtype=torch.float64))
    lam = torch.exp(torch.rand((b, n), generator=gen, dtype=torch.float64)
                    * torch.log(torch.tensor(cond, dtype=torch.float64)))
    return ((Q * lam[:, None, :]) @ Q.mT).to(dtype).to(device)


def work(name: str, args) -> dict:
    """What one call of kernel `name` on `args` must do at the least: bytes
    (each input read once, each output written once), floating-point
    operations, and, for the kernels that run one instance as one block (or
    one cluster), the dependent steps of the chain (each at least one
    exchange through shared memory and one barrier), which chain of the
    barrier probe bounds a step (`chain`: a block's warps, or "cluster"), and
    the SMs one instance runs on (`sms`)."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    size = args[0].element_size()
    if name == "chol_inverse_base":
        b, n, _ = args[0].shape
        # Cholesky n^3 / 3 and the triangular inverse n^3 / 3.
        return {"bytes": 2 * b * n * n * size, "flops": b * 2 * n**3 / 3}
    if name == "gj_inverse":
        b, m, _ = args[0].shape
        return {"bytes": 2 * b * m * m * size, "flops": b * 2 * m**3,
                "steps": m, "chain": GJ_WARPS, "sms": 1}
    if name == "gj_solve":
        b, m, _ = args[0].shape
        # The least for one right-hand side: elimination below the diagonal
        # (2/3 m^3) and two triangular solves (4 m^2, dropped); the kernel's
        # Gauss-Jordan order does m^3. The cluster tile runs on two SMs; a
        # pivot's step still passes it to all warps of the CTA that holds it,
        # one block barrier's chain.
        cluster = cuda_lin.gj_plan(name, m, args[0].dtype)[0] == "cluster"
        return {"bytes": b * (m * m + 2 * m) * size, "flops": b * 2 * m**3 / 3,
                "steps": m, "chain": GJ_WARPS, "sms": CLUSTER_SMS if cluster else 1}
    b, m, n = args[1].shape
    num = args[9]
    # Per iteration K^-1 rhs, A' w and A x~ (2 n^2 + 4 m n) and ~10 (n + m) of
    # vector updates. The chain is what the function demands, whatever the
    # kernel: three products per iteration, each of which needs the one
    # before it whole (A' w -> K^-1 rhs -> A x~ -> next w), so three
    # exchanges across the block.
    return {"bytes": b * (n * n + m * n + 3 * n + 7 * m) * size,
            "flops": b * num * (2 * n * n + 4 * m * n + 10 * (n + m)),
            "steps": 3 * num, "chain": ADMM_WARPS, "sms": 1}


def library_call(name: str, args):
    """(what it is, a function making the one PyTorch call that computes the
    kernel's function on `args`), or None where there is no such call. A
    yardstick only: the port never calls these."""
    if name == "gj_inverse":
        return "torch.linalg.inv", lambda: torch.linalg.inv(args[0])
    if name == "gj_solve":
        return "torch.linalg.solve", lambda: torch.linalg.solve(args[0], args[1][..., None])
    return None


def kernel_route(name: str, args) -> str:
    """The route (cuda_lin's plans) by which kernel `name` runs `args`."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    if name == "chol_inverse_base":
        return "warp"
    if name == "admm_iterate":
        _, m, n = args[1].shape
        return cuda_lin.admm_plan(n, m, args[1].dtype)[0]
    return cuda_lin.gj_plan(name, args[0].shape[-1], args[0].dtype)[0]


# A second route timed beside a kernel's own at the same shape: the
# shared-memory kernel that ran the roll-moment cap's shapes before the
# cluster and 14-row tiles, and B3's cluster tile where the one-SM tile
# runs (the two do the same arithmetic; the cluster's cost a step apart from
# its multiply-adds).
ALSO_TIMED = {("gj_solve", "cluster"): "smem", ("admm_iterate", "tile14"): "smem",
              ("gj_solve", "tile"): "cluster"}


def forced_launch(name: str, args, route: str):
    """A function launching B3 or B4 on `args` by `route` (cuda_lin's route
    names), whichever route the plan picks; uncounted, for timing one route
    beside another."""
    from g1_locomotion_tpu_torch.ops import cuda_lin as cl

    if name == "gj_solve":
        K, b = args
        x = torch.empty_like(b)
        return lambda: cl._launch("lin_gj_solve", K.dtype, cl._ptr(K), cl._ptr(b), cl._ptr(x),
                                  K.shape[0], K.shape[-1], cl.GJ_ROUTES[route], cl._stream(K))
    tensors, (num, sigma, alpha) = args[:9], args[9:]
    outs = [torch.empty_like(t) for t in args[6:9]]
    B, m, n = args[1].shape
    return lambda: cl._launch("lin_admm_iterate", args[1].dtype,
                              *(cl._ptr(t) for t in (*tensors, *outs)), B, n, m, int(num),
                              float(sigma), float(alpha), cl.ADMM_ROUTES[route],
                              cl._stream(args[1]))


def barrier_chain_us(lib_path, warps, device) -> float:
    """Microseconds per step of the barrier probe's chain (one warp's store
    to shared memory, one block barrier, all warps' load) in one block of
    `warps` warps: the slope between two chain lengths. With `warps` = 0 the
    chain inside one warp (one lane's store, __syncwarp(), all lanes' load);
    with "cluster" the chain across a two-CTA cluster of GJ_WARPS warps each
    (one warp's store into both CTAs' shared memory, one cluster barrier,
    all warps' load), the owner alternating between the CTAs."""
    lib = ctypes.CDLL(str(lib_path))
    for fn in (lib.probe_barrier_chain, lib.probe_cluster_chain):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_warp_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.probe_barrier_chain, lib.probe_cluster_chain, lib.probe_warp_chain):
        fn.restype = ctypes.c_int
    out = torch.empty(CLUSTER_SMS * GJ_WARPS * 32, dtype=torch.float32, device=device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def launch(steps):
        if warps == "cluster":
            err = lib.probe_cluster_chain(out.data_ptr(), steps, GJ_WARPS, stream)
        elif warps:
            err = lib.probe_barrier_chain(out.data_ptr(), steps, warps, stream)
        else:
            err = lib.probe_warp_chain(out.data_ptr(), steps, stream)
        if err != 0:
            raise RuntimeError(f"barrier probe: CUDA error {err} at launch")

    short, long = 1000, 5000
    return (cuda_ms(lambda: launch(long), reps=20)
            - cuda_ms(lambda: launch(short), reps=20)) / (long - short) * 1e3


def cases_b1(calls):
    """B1's main-path inputs, widest block first, float32 before float64:
    per block size and dtype the first input with each layout the path gave
    it, then the same input dense, as (K dense, (K strides, out strides) or
    None for dense)."""
    recorded = calls["chol_inverse_base"]
    cases = []
    for group in sorted({(key[0], key[-1]) for key, _, _ in recorded},
                        key=lambda g: (-g[0][-1], g[1] == torch.float64, -g[0][0])):
        layouts = {}
        for key, args, strides in recorded:
            if (key[0], key[-1]) == group:
                layouts.setdefault(strides, args[0])
        cases += [(K, strides) for strides, K in layouts.items()]
        cases.append((next(iter(layouts.values())), None))
    return cases


def kernel_id(device_kernel_name: str) -> str:
    """B1-B4 for the port's own kernels (plain or mangled name), else 'other ops'."""
    for mark, key in (("gj_tile_kernel<true", "B3"), ("gj_tile_kernelILb1", "B3"),
                      ("gj_tile_kernel<false", "B2"), ("gj_tile_kernelILb0", "B2"),
                      ("gj_smem_kernel", "B2/B3 shared-memory kernel"),
                      ("admm_tile_kernel", "B4"), ("admm_smem_kernel", "B4 shared-memory kernel"),
                      ("chol_inv_base_kernel", "B1")):
        if mark in device_kernel_name:
            return key
    return "other ops"


def op_kind(device_kernel_name: str) -> str:
    """A coarse kind for a device kernel's name: the port's own kernels by
    id, cuBLAS products, `torch.cat`, copies, fills, everything else."""
    kind = kernel_id(device_kernel_name)
    if kind != "other ops":
        return kind
    low = device_kernel_name.lower()
    for kind, marks in (("cuBLAS", ("gemm", "gemv", "cutlass", "cublas")),
                        ("cat", ("catarray",)), ("copy", ("copy", "memcpy")),
                        ("fill", ("memset", "fill"))):
        if any(mark in low for mark in marks):
            return kind
    return "other elementwise / reduction"


def profile_path(label: str, once, reps: int, unit: str, gpu: str, by=kernel_id) -> None:
    """torch.profiler over `reps` calls of once(): the device-busy share of the
    wall time (union of the device kernels' intervals) and the device time by
    by(kernel name)."""
    from torch.profiler import ProfilerActivity, profile

    once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            once()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        print(f"[{gpu}] {label} profile: the profiler recorded no device events; not measured")
        return
    busy, edge, by_name = 0.0, spans[0][0], {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    busy_ms = busy / 1e3 / reps
    print(f"[{gpu}] {label} profile over {reps} x {unit}: wall {plain_wall:.3f} ms per "
          f"{unit} unprofiled, {wall:.3f} ms profiled; {len(spans) / reps:.0f} device "
          f"kernels per {unit}; device busy {busy_ms:.3f} ms per {unit} = "
          f"{100 * busy_ms / plain_wall:.1f}% of the unprofiled wall, "
          f"{100 * busy_ms / wall:.1f}% of the profiled")
    mine = {}
    for name, us in by_name.items():
        mine[by(name)] = mine.get(by(name), 0.0) + us / 1e3 / reps
    total = sum(mine.values())
    print(f"[{gpu}] {label} profile, device ms per {unit}: "
          + ", ".join(f"{k} {v:.4f} ({100 * v / total:.1f}%)" for k, v in sorted(mine.items())))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        print(f"  {us / 1e3 / reps:.4f} ms per {unit}  {name[:110]}")


def compare_kernels(calls, gen_device) -> dict:
    """Phase 1: every kernel against its plain version on the same inputs on
    the card. Returns {name: max_abs_err} over the checked inputs."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    errs = {}

    def note(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    # B1 on random SPD blocks at (B*4, 30, 30) and (B*8, 25, 25), cond 1e3:
    # W within 2e-4 relative (tests/test_pallas_lin.py) and W'W K = I.
    gen = torch.Generator().manual_seed(1)
    for b, n in ((B_THROUGHPUT * 4, 30), (B_THROUGHPUT * 8, 25)):
        Q, _ = torch.linalg.qr(torch.randn((b, n, n), generator=gen, dtype=torch.float64))
        lam = torch.exp(torch.rand((b, n), generator=gen, dtype=torch.float64) * 6.9)
        K = ((Q * lam[:, None, :]) @ Q.mT).to(torch.float32).to(gen_device)
        W = cuda_lin.chol_inverse_base(K)
        W_ref = cuda_lin.chol_inverse_base_ref(K)
        torch.cuda.synchronize()
        err, res = rel_err(W, W_ref), eye_residual(K, W.mT @ W)
        print(f"B1 random SPD {tuple(K.shape)}: rel err {err:.3e} (<= 2e-4), "
              f"max|W'WK - I| {res:.3e} (<= 5e-3)")
        if not (err <= 2e-4 and res <= 5e-3):
            raise AssertionError("B1 disagrees with its plain version on random SPD blocks")

    # B1 at float64 (chol_inv_base_kernel<double, n>, which the pod-sweep
    # demo's float64 default reaches on the card) on seeded SPD batches at
    # the pod sweep's block sizes, cond 1e3: within 1e-10 (about 1e6 ulps:
    # a fault gives errors of order one).
    for n in B1_F64_SIZES:
        K = random_spd(B_THROUGHPUT, n, 1e3, 200 + n, gen_device, torch.float64)
        W, W_ref = cuda_lin.chol_inverse_base(K), cuda_lin.chol_inverse_base_ref(K)
        torch.cuda.synchronize()
        err, res = rel_err(W, W_ref), eye_residual(K, W.mT @ W)
        note("chol_inverse_base", float((W - W_ref).abs().max()))
        print(f"B1 float64 random SPD {tuple(K.shape)}: rel err {err:.3e} (<= 1e-10), "
              f"max|W'WK - I| {res:.3e} (<= 1e-10)")
        if not (err <= 1e-10 and res <= 1e-10):
            raise AssertionError("B1 at float64 disagrees with its plain version")

    # B2 / B3 on random SPD systems at the main path's widths, cond 1e2,
    # B = 3: within 2e-4 of the plain version (tests/test_torch_cuda_kernels.py).
    checks = []
    for m_inv, m_solve in ((120, 200), (41, 80)):  # the MPC's and the WBID's
        K = random_spd(3, m_inv, 1e2, 3, gen_device)
        S = random_spd(3, m_solve, 1e2, 4, gen_device)
        b = torch.randn((3, m_solve), generator=torch.Generator().manual_seed(5)).to(gen_device)
        checks += [(f"B2 random SPD (3, {m_inv}, {m_inv})", cuda_lin.gj_inverse(K),
                    cuda_lin.gj_inverse_ref(K)),
                   (f"B3 random SPD (3, {m_solve}, {m_solve})", cuda_lin.gj_solve(S, b),
                    cuda_lin.gj_solve_ref(S, b))]
    # B3's cluster tile at its edges and the roll-moment cap's width, at B = 1
    # and at more clusters than the card has pairs of SMs: the same check.
    for m, bsz in B3_CLUSTER_CASES:
        S = random_spd(bsz, m, 1e2, 300 + m, gen_device)
        b = torch.randn((bsz, m), generator=torch.Generator().manual_seed(m)).to(gen_device)
        if cuda_lin.gj_plan("gj_solve", m, S.dtype)[0] != "cluster":
            raise AssertionError(f"B3 at m = {m} does not take the cluster tile")
        checks.append((f"B3 cluster tile random SPD ({bsz}, {m}, {m})", cuda_lin.gj_solve(S, b),
                       cuda_lin.gj_solve_ref(S, b)))
    torch.cuda.synchronize()
    for label, got, ref in checks:
        worst = float(((got - ref).abs() - 2e-4 * ref.abs()).max())
        print(f"{label}: max abs err {float((got - ref).abs().max()):.3e} "
              f"(|err| <= 2e-4 + 2e-4 |ref|)")
        if not worst <= 2e-4:
            raise AssertionError(f"{label}: kernel disagrees with its plain version")

    # Every kernel on the inputs the main path gave it.
    # B1 reads the block where the recursion's view of K has it and writes W
    # into the view of the parent's W (the recorded strides), and dense too.
    # Around the views the buffers hold a fill value, which must survive.
    # The residual is held per instance against the plain version's, on the
    # instances where the plain version gives an inverse good to 1%: the
    # polish's Schur systems of some WBID instances are not numerically SPD
    # at float32; there neither gives an inverse (either may overflow), and
    # the polish drops the candidate, as the reference's does. Where no
    # instance of a layout is left, a seeded SPD batch of the same shape
    # (cond 1e3) goes through the same strides instead, so that every
    # layout's values are checked.
    for i, (key, args, (k_stride, w_stride)) in enumerate(calls["chol_inverse_base"]):
        K = args[0]
        W_ref = cuda_lin.chol_inverse_base_ref(K)
        res_ref = chol_residuals(K, W_ref)
        kept = res_ref <= 1e-2  # False where NaN
        if not bool(kept.all()):
            print(f"B1 main-path blocks {key[0]} {K.dtype}, K strides {k_stride}: "
                  f"{int((~kept).sum())} instances not numerically SPD at {K.dtype} (plain "
                  f"version's residual above 1e-2 or not finite), left out")
        if not bool(kept.any()):
            K = random_spd(K.shape[0], K.shape[-1], 1e3, 100 + i, K.device).to(K.dtype)
            W_ref = cuda_lin.chol_inverse_base_ref(K)
            res_ref = chol_residuals(K, W_ref)
            kept = res_ref <= 1e-2
            print(f"B1 main-path blocks {key[0]} {K.dtype}, K strides {k_stride}: no instance "
                  f"left; "
                  f"a seeded SPD batch of that shape (cond 1e3) through the same strides "
                  f"instead, {int(kept.sum())} instances good to 1% on the plain version")
            if not bool(kept.any()):
                raise AssertionError("B1: the plain version fails on the seeded SPD batch")
        k_buf, k_view = strided_copy(K, k_stride)
        w_buf, w_view = strided_copy(torch.full_like(K, float("nan")), w_stride)
        cuda_lin.chol_inverse_base(k_view, out=w_view)
        W_dense = cuda_lin.chol_inverse_base(K)
        torch.cuda.synchronize()
        inside = torch.zeros(w_buf.shape, dtype=torch.bool, device=w_buf.device)
        inside.as_strided(tuple(K.shape), w_stride).fill_(True)
        bits = torch.int32 if K.dtype == torch.float32 else torch.int64  # NaN-proof equality
        if not (torch.all(w_buf[~inside] == 7.0)
                and torch.equal(k_view.contiguous().view(bits), K.view(bits))):
            raise AssertionError(f"B1 wrote outside its block of W, or into K "
                                 f"(strides {k_stride}, {w_stride})")
        if not torch.all(torch.triu(w_view, 1) == 0):
            raise AssertionError("B1 left non-zeros above the diagonal of W")
        for label, W in (("strided", w_view), ("dense", W_dense)):
            res = chol_residuals(K, W)[kept]
            W, W_kept = W[kept], W_ref[kept]
            note("chol_inverse_base", float((W - W_kept).abs().max()))
            print(f"B1 main-path blocks {key[0]} {K.dtype}, K strides {k_stride}, "
                  f"W strides {w_stride}, "
                  f"{label}, {int(kept.sum())} instances: rel err {rel_err(W, W_kept):.3e}; "
                  f"max|W'WK - I| kernel {float(res.max()):.3e}, plain "
                  f"{float(res_ref[kept].max()):.3e} (per instance kernel <= 4 plain + 1e-4)")
            if not bool(torch.all(res <= 4 * res_ref[kept] + 1e-4)):
                raise AssertionError("B1 inverse residual worse than its plain version's")
        del k_buf, w_buf, inside

    # B2 on the ADMM K (120) and the polish Hr (120) of real MPC instances:
    # ill-conditioned (rho up to 1e3 on equality rows), so the check is the
    # inverse residual against the plain version's.
    for key, args, _ in calls["gj_inverse"]:
        K = args[0]
        X, X_ref = cuda_lin.gj_inverse(K), cuda_lin.gj_inverse_ref(K)
        torch.cuda.synchronize()
        res, res_ref = eye_residual(K, X), eye_residual(K, X_ref)
        note("gj_inverse", float((X - X_ref).abs().max()))
        print(f"B2 {key[0]}: rel err {rel_err(X, X_ref):.3e}; max|K X - I| kernel {res:.3e}, "
              f"plain {res_ref:.3e} (kernel <= 4 plain + 1e-4)")
        if not res <= 4 * res_ref + 1e-4:
            raise AssertionError("B2 inverse residual worse than its plain version's")

    # B3 on the polish Schur complement S (200): ill-conditioned, so the check
    # is the residual |S x - b| relative to |b|.
    for key, args, _ in calls["gj_solve"]:
        S, b = args
        x, x_ref = cuda_lin.gj_solve(S, b), cuda_lin.gj_solve_ref(S, b)
        torch.cuda.synchronize()

        def resid(v):  # relative to |b| (0 where b = 0 and so is the solution)
            return float(((S @ v[..., None])[..., 0] - b).abs().amax()
                         / b.abs().amax().clamp_min(1e-30))

        res, res_ref = resid(x), resid(x_ref)
        note("gj_solve", float((x - x_ref).abs().max()))
        print(f"B3 {key[0]}: rel err {rel_err(x, x_ref):.3e}; |Sx - b|/|b| kernel {res:.3e}, "
              f"plain {res_ref:.3e} (kernel <= 4 plain + 1e-5)")
        if not res <= 4 * res_ref + 1e-5:
            raise AssertionError("B3 solve residual worse than its plain version's")

    # B4 on the main path's inputs, then its 14-row tile on seeded QPs.
    gen = torch.Generator().manual_seed(6)
    for key, args, _ in calls["admm_iterate"]:
        note("admm_iterate", check_b4(f"B4 A {key[1]}", args, gen))
    for i, (n, m) in enumerate(B4_WIDE_CASES):
        if cuda_lin.admm_plan(n, m, torch.float32)[0] != "tile14":
            raise AssertionError(f"B4 at (n, m) = ({n}, {m}) does not take the 14-row tile")
        for bsz in (1, 150):
            args = admm_case(bsz, n, m, 400 + i, gen_device)
            check_b4(f"B4 14-row tile seeded A {tuple(args[1].shape)}", args, gen)
    return errs


def check_b4(label: str, args, gen) -> float:
    """B4 against the plain loop on `args`, both measured from the plain loop
    in float64: each of x, z, y within 2e-4 of its scale
    (tests/test_pallas_lin.py's tolerance between the two loops) or, where the
    iterations amplify rounding beyond that, within twice the spread that
    float32 rounding alone gives the plain loop (its largest deviation over
    four runs on inputs moved by one float32 rounding, 2^-24 relative, at
    random). The WBID's scaled duals are such a case: a 1e-7 relative change
    of K^-1 moves y there by ~10% of its largest entry. Returns the largest
    |kernel - plain in f64|."""
    from g1_locomotion_tpu_torch.ops import cuda_lin

    out = cuda_lin.admm_iterate(*args)
    ref = cuda_lin.admm_iterate_ref(*(a.double() if isinstance(a, torch.Tensor) else a
                                      for a in args))
    band = [0.0, 0.0, 0.0]
    for _ in range(4):
        moved = [a * (1 + 2.0**-24 * torch.randn(a.shape, generator=gen).to(a))
                 if isinstance(a, torch.Tensor) else a for a in args]
        for i, (o, r) in enumerate(zip(cuda_lin.admm_iterate_ref(*moved), ref)):
            band[i] = max(band[i], float((o.double() - r).abs().max()))
    torch.cuda.synchronize()
    for name, o, r, spread in zip("xzy", out, ref, band):
        err, scale = float((o.double() - r).abs().max()), float(r.abs().max())
        print(f"{label}, num {args[9]}, {name}: |kernel - plain in f64| {err:.3e} "
              f"(scale {scale:.3e}); float32 rounding spread of the plain loop {spread:.3e} "
              f"(<= max(2e-4 scale, 2 spread))")
        if not err <= max(2e-4 * scale, 2 * spread):
            raise AssertionError(f"{label}: B4 disagrees with its plain loop")
    return max(float((o.double() - r).abs().max()) for o, r in zip(out, ref))


def admm_case(b: int, n: int, m: int, seed: int, device, num: int = 17):
    """B4's arguments for a seeded float32 QP batch (tests/test_pallas_lin.py's
    construction): K = P + sigma I + A' diag(rho) A with P SPD (cond 1e2),
    K^-1 by float64 inversion, box bounds around 0, x small, z = y = 0."""
    rng = np.random.default_rng(seed)
    sigma, alpha = 1e-6, 1.6
    Q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    P = np.einsum("bik,bk,bjk->bij", Q, np.exp(rng.uniform(0.0, np.log(1e2), (b, n))), Q)
    A = rng.standard_normal((b, m, n))
    rho = np.abs(rng.standard_normal((b, m))) + 0.5
    K = P + sigma * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    vecs = (np.linalg.inv(K), A, rng.standard_normal((b, n)),
            -np.abs(rng.standard_normal((b, m))) - 0.1, np.abs(rng.standard_normal((b, m))) + 0.1,
            rho, rng.standard_normal((b, n)) * 0.1, np.zeros((b, m)), np.zeros((b, m)))
    return [torch.tensor(v, dtype=torch.float32, device=device) for v in vecs] + [num, sigma,
                                                                                   alpha]


@contextlib.contextmanager
def observed_periods(loop, sink):
    """Route loop.period through a wrapper that times each period with a
    CUDA event pair and then hands (ms, log) to sink(ms, log)."""
    period = loop.period

    def wrapper(state, params):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = period(state, params)
        end.record()
        end.synchronize()
        sink(start.elapsed_time(end), out[1])
        return out

    loop.period = wrapper
    try:
        yield
    finally:
        del loop.period


def pod_sweep(loop, params, tau_max, mg, dtype) -> dict:
    """Phase 15: parallel/sweep.run_sweep over params (the 4096 randomized
    scenarios) through loop (the default configuration): SWEEP_PERIODS
    periods unchunked, each period timed by CUDA events and its log held to
    the period invariants; then the same periods as chunks of one period,
    the states, statistics, drift origin and lowest heights through a
    utils/checkpoint save and restore between them. B1 must launch 748
    times a period in both; the chunked statistics must equal the
    unchunked (n and fell_count exactly, the drift and tau_max within
    SWEEP_STATS_RTOL); no scenario falls. The first B_COMPARE instances'
    first period against the plain-version path."""
    import tempfile

    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.ops import cuda_lin
    from g1_locomotion_tpu_torch.parallel import sweep
    from g1_locomotion_tpu_torch.utils import checkpoint, tree

    B = params.batch()
    state0 = eng.init_state(loop.model, loop.cfg, B, dtype)
    period_ms, maxima = [], []

    def sink(ms, log):
        period_ms.append(ms)
        maxima.append(period_maxima(log_numpy(log), tau_max, mg))

    torch.cuda.synchronize()
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    with observed_periods(loop, sink):
        _, _, whole = sweep.run_sweep(loop, params, SWEEP_PERIODS, states0=state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [read_counts()]
    print(f"phase 15 pod sweep: B={B}, {SWEEP_PERIODS} periods unchunked in {wall:.3f} s (host "
          f"clock, with the invariants' logs); periods {['%.3f' % m for m in period_ms]} ms "
          f"(CUDA events); launches {launches[0]} "
          f"({launches[0]['chol_inverse_base'] / SWEEP_PERIODS:.0f} B1 a period)")
    if launches[0] != SWEEP_LAUNCHES:
        raise AssertionError(f"the pod sweep launched {launches[0]}, expected {SWEEP_LAUNCHES}")
    worst = {k: max(m[k] for m in maxima) for k in maxima[0]}
    check_period(f"phase 15 pod sweep (B={B}, {SWEEP_PERIODS} periods)", worst, phase=15)

    cuda_lin.reset_launch_counts()
    states, com_ref, min_z, acc = state0, None, None, None
    with tempfile.TemporaryDirectory() as tmp:
        for chunk in range(SWEEP_PERIODS):
            states, (start, z), stats = sweep.run_sweep(loop, params, 1, states0=states,
                                                        com_ref=com_ref)
            com_ref = start if com_ref is None else com_ref
            min_z = z if min_z is None else torch.minimum(min_z, z)
            acc = stats if acc is None else stats._replace(
                tau_max=torch.maximum(acc.tau_max, stats.tau_max))
            saved = (states, acc, com_ref, min_z)
            checkpoint.save(f"{tmp}/sweep", saved, meta={"chunk": chunk + 1})
            (states, acc, com_ref, min_z), meta = checkpoint.restore(
                f"{tmp}/sweep", tree.map_leaves(torch.empty_like, saved))
            if meta != {"chunk": chunk + 1} or not all(
                    torch.equal(a, b) for a, b in zip(tree.leaves(saved), tree.leaves(
                        (states, acc, com_ref, min_z)))):
                raise AssertionError("phase 15: the checkpoint did not round-trip")
    launches.append(read_counts())
    if launches[1] != SWEEP_LAUNCHES:
        raise AssertionError(f"the chunked pod sweep launched {launches[1]}, "
                             f"expected {SWEEP_LAUNCHES}")
    fell = (min_z < sweep.FALL_HEIGHT).to(dtype).sum()
    got = {"n": float(acc.n), "fell_count": float(fell),
           "com_drift_sum": float(acc.com_drift_sum), "tau_max": float(acc.tau_max)}
    want = {k: float(getattr(whole, k)) for k in got}
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
           for k in ("com_drift_sum", "tau_max")}
    print(f"phase 15 pod sweep, {SWEEP_PERIODS} chunks of one period through a checkpoint: "
          f"{got}; unchunked {want}; relative differences {rel} (<= {SWEEP_STATS_RTOL}; "
          f"equal: {got == want})")
    if not (got["n"] == want["n"] == B and got["fell_count"] == want["fell_count"] == 0.0
            and all(r <= SWEEP_STATS_RTOL for r in rel.values())):
        raise AssertionError("phase 15: the chunked sweep's statistics differ from the "
                             "unchunked run's, or a scenario fell")

    first = params.rows(slice(0, B_COMPARE))
    kernel = loop.period(take(state0, B_COMPARE), first)
    with plain_kernels():
        plain = loop.period(take(state0, B_COMPARE), first)
    compare_periods(f"phase 15 pod sweep, first {B_COMPARE} instances", kernel, plain)
    return {"launches": launches, "period_ms": period_ms, "batch": B}


def telemetry_period(name: str, loop, batch: int, params, dtype) -> dict:
    """Phase 16: one period of loop (EngineConfig.telemetry on) at batch
    from init_state, its own CUDA event pair around it: the launches must be
    those of the same period with telemetry off; mpc_ms and wbid_ms > 0 and
    finite, mpc_ms the same on every tick, the period's WBID solves no
    longer than the period. Returns the launches."""
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.ops import cuda_lin

    state = eng.init_state(loop.model, loop.cfg, batch, dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    cuda_lin.reset_launch_counts()
    start.record()
    _, log = loop.period(state, params)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    period = start.elapsed_time(end)
    mpc, wbid = log.mpc_ms.double().cpu(), log.wbid_ms.double().cpu()
    wbid_sum = float(wbid.sum(dim=1).max())
    print(f"phase 16 telemetry, {name} period (B={batch}): period {period:.3f} ms (CUDA events); "
          f"mpc_ms {float(mpc[0, 0]):.3f}; wbid_ms per tick {float(wbid.min()):.3f}-"
          f"{float(wbid.max()):.3f}, {wbid_sum:.3f} over the period; launches {launches}")
    if launches != TELEMETRY_LAUNCHES[name]:
        raise AssertionError(f"phase 16 {name}: launched {launches}, expected "
                             f"{TELEMETRY_LAUNCHES[name]} (as with telemetry off)")
    if not (bool(torch.isfinite(mpc).all() and torch.isfinite(wbid).all())
            and bool((mpc > 0).all() and (wbid > 0).all())
            and torch.equal(mpc, mpc[:, :1].expand_as(mpc)) and wbid_sum <= period):
        raise AssertionError(f"phase 16 {name}: the stage times are off")
    return launches


def load_trace() -> dict:
    """The recorded MuJoCo trace of phase 17 (numpy arrays)."""
    from pathlib import Path

    with np.load(Path(__file__).resolve().parent / TRACE) as z:
        return {k: z[k] for k in z.files}


def bridge_replay(ctrl, trace: dict, ticks: range):
    """Drive the bridge's controller through the trace's measurements at
    `ticks`: (tau (n, nj), CoM (n, 3), contact normal forces (n, 4) as
    numpy, wall ms per tick). A tick ends in tau's copy to the host, so the
    host clock times it whole."""
    taus, coms, fzs, ms = [], [], [], []
    for t in ticks:
        t0 = time.perf_counter()
        tau, log = ctrl.step(trace["qpos"][t], trace["qvel"][t])
        ms.append((time.perf_counter() - t0) * 1e3)
        taus.append(tau)
        coms.append(log.com[0])
        fzs.append(log.forces[0, :, 2])
    return (np.stack(taus), torch.stack(coms).double().cpu().numpy(),
            torch.stack(fzs).double().cpu().numpy(), ms)


def bridge_phase(model, device, gpu: str) -> dict:
    """Phase 17: the MuJoCo bridge at float64 on the card. Returns the
    replay's launches (and the closed loop's, where it ran)."""
    import importlib.util
    from pathlib import Path

    from g1_locomotion_tpu_torch.engine import mujoco_bridge as mb
    from g1_locomotion_tpu_torch.engine import tick as eng
    from g1_locomotion_tpu_torch.ops import cuda_lin

    trace = load_trace()
    params = eng.mujoco_standing_scenario(device=device, dtype=torch.float64)
    ctrl = mb.BridgeController(model, params=params)
    ctrl.reset(trace["qpos"][0], trace["qvel"][0])
    torch.cuda.synchronize()
    cuda_lin.reset_launch_counts()
    first = bridge_replay(ctrl, trace, range(PERIOD_TICKS))
    snapshot = ctrl.state, ctrl.tick
    second = bridge_replay(ctrl, trace, range(PERIOD_TICKS, BRIDGE_TICKS))
    launches = read_counts()
    got = [np.concatenate([a, b]) for a, b in zip(first[:3], second[:3])]
    tick_ms = first[3] + second[3]
    print(f"phase 17 MuJoCo bridge replay: {BRIDGE_TICKS} ticks of {TRACE} at float64 (B = 1, "
          f"default EngineConfig); launches {launches}")
    if launches != bridge_launches(BRIDGE_TICKS):
        raise AssertionError(f"the bridge launched {launches}, expected "
                             f"{bridge_launches(BRIDGE_TICKS)}")
    err = {k: np.abs(g - trace[k][:BRIDGE_TICKS]).reshape(BRIDGE_TICKS, -1).max(axis=1)
           for k, g in zip(("tau", "com", "fz"), got)}
    if not all(np.isfinite(g).all() for g in got):
        raise AssertionError("phase 17: non-finite torques, CoM or forces")
    print(f"phase 17 replay against the JAX package's MujocoLoop: max |dtau| "
          f"{err['tau'].max():.3e} N m (ticks within 1e-6: {int((err['tau'] <= 1e-6).sum())} "
          f"of {BRIDGE_TICKS}), |dfz| {err['fz'].max():.3e} N, |dCoM| {err['com'].max():.3e} m "
          f"(bounds {BRIDGE_TOL})")
    if not all(err[k].max() <= tol for k, tol in BRIDGE_TOL.items()):
        raise AssertionError("phase 17: the bridge's controller leaves the recorded trace")
    # The second period again, through the plain versions.
    plain = mb.BridgeController(model, params=params)
    plain.state, plain.tick = snapshot
    with plain_kernels():
        ref = bridge_replay(plain, trace, range(PERIOD_TICKS, BRIDGE_TICKS))
    dev = {"tau": float(np.abs(ref[0] - second[0]).max()),
           "com": float(np.abs(ref[1] - second[1]).max()),
           "fz": float(np.abs(ref[2] - second[2]).max())}
    print(f"phase 17 second period, kernel path vs plain path: {dev} (bounds {BRIDGE_TOL})")
    if not all(dev[k] <= BRIDGE_TOL[k] for k in dev):
        raise AssertionError("phase 17: the bridge's kernel path differs from its plain path")
    ms = sorted(tick_ms)
    mpc_ms = [tick_ms[t] for t in range(0, BRIDGE_TICKS, PERIOD_TICKS)]
    print(f"[{gpu}] MuJoCo bridge tick (B = 1, float64, default EngineConfig, the controller "
          f"on the card): p50 {median(ms):.3f} ms, max {ms[-1]:.3f} ms, min {ms[0]:.3f} ms over "
          f"{BRIDGE_TICKS} ticks (host clock, each tick ending in tau's copy to the host); the "
          f"ticks with an MPC solve {', '.join('%.3f' % m for m in mpc_ms)} ms; the reference's "
          f"budget 1 ms a tick; solve timers {ctrl.stats.export()}")
    out = {"replay": launches}
    if importlib.util.find_spec("mujoco") is None:
        print("phase 17 closed loop in MuJoCo: the mujoco package is not installed on this "
              "machine, so the closed loop is not run here (tests/test_torch_mujoco.py and "
              "tests/test_torch_engine_mujoco.py run it on the CPU)")
        return out
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import torch_mujoco_bar

    loop = mb.MujocoLoop(model, params=params)
    torch.cuda.synchronize()
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    checks = torch_mujoco_bar.standing_bar(loop, BRIDGE_LOOP_TICKS)
    wall = time.perf_counter() - t0
    out["closed loop"] = read_counts()
    print(f"phase 17 closed loop in MuJoCo: {BRIDGE_LOOP_TICKS} ticks in {wall:.3f} s; "
          f"{ {k: v[0] for k, v in checks.items()} }; launches {out['closed loop']}")
    if out["closed loop"] != bridge_launches(BRIDGE_LOOP_TICKS):
        raise AssertionError(f"the closed loop launched {out['closed loop']}, expected "
                             f"{bridge_launches(BRIDGE_LOOP_TICKS)}")
    failed = {k: v for k, v in checks.items() if not v[2]}
    if failed:
        raise AssertionError(f"phase 17: the closed loop in MuJoCo misses the standing bar: "
                             f"{failed}")
    return out


T_START = time.perf_counter()


def main(argv) -> None:
    from g1_locomotion_tpu_torch._device import require_cuda

    if argv not in ([], ["--profile"]):
        raise SystemExit("usage: python3 chip_smoke.py [--profile]")

    device = require_cuda()
    from g1_locomotion_tpu_torch.ops import cuda_lin

    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    dtype = torch.float32

    # Phase 0: build from the checkout's sources, both libraries at once.
    probe_source = cuda_lin.SOURCE.with_name("barrier_probe.cu")
    with ThreadPoolExecutor(2) as pool:
        kernels_build = pool.submit(cuda_lin.build, verbose=True)
        probe_build = pool.submit(cuda_lin.build, verbose=True, source=probe_source)
        (path, seconds, log), (probe_path, probe_seconds, _) = (kernels_build.result(),
                                                                probe_build.result())
    cuda_lin._lib()
    print(f"phase 0 build: {seconds:.1f} s -> {path.name}; {probe_seconds:.1f} s -> "
          f"{probe_path.name}")
    entry, base_regs = "", {}
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line
        # B1 has one kernel per type and block size: one line for each type.
        base = re.search(r"chol_inv_base_kernelI([fd])Li(\d+)E", entry)
        if ("spill" in line and any(k in entry for k in REGISTER_KERNELS)
                and not line.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")):
            raise AssertionError(f"a kernel that keeps its matrix in registers spills: "
                                 f"{entry.strip()} {line.strip()}")
        regs = re.search(r"Used (\d+) registers", line)
        if base and regs:
            base_regs.setdefault(base.group(1), {})[int(base.group(2))] = int(regs.group(1))
        elif not base and ("registers" in line or "Compiling entry" in line or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    for kind, regs in sorted(base_regs.items()):
        print(f"  ptxas: chol_inv_base_kernel<{'float' if kind == 'f' else 'double'}, n> for n = "
              f"{min(regs)}..{max(regs)}: registers at n = 20 / 21 / 25 / 30 / 32: "
              + " / ".join(str(regs.get(n)) for n in (20, 21, 25, 30, 32)) + "; no spill")

    thr_cfg, srv_cfg = configs()
    thr, srv = solver_for(thr_cfg, device, dtype), solver_for(srv_cfg, device, dtype)
    inp = bench_inputs(B_THROUGHPUT, device, dtype)
    from g1_locomotion_tpu_torch.models.robot import load_robot
    from g1_locomotion_tpu_torch.wbid.solver import WBIDSolver
    from g1_locomotion_tpu_torch.wbid.tasks import default_gains

    robot = load_robot("g1_23dof", device=device, dtype=dtype)
    gains = default_gains(device=device, dtype=dtype)
    wsrv_cfg, wbat_cfg = wbid_configs()
    wsrv, wbat = WBIDSolver(wsrv_cfg, robot, gains), WBIDSolver(wbat_cfg, robot, gains)
    wq, wv, wrefs = wbid_batch(wbat.model, wbat.idx, B_WBID, device, dtype)
    from g1_locomotion_tpu_torch.engine import tick as eng

    esrv_cfg, ebat_cfg = engine_configs()
    esrv, ebat = eng.ControlLoop(robot, esrv_cfg), eng.ControlLoop(robot, ebat_cfg)
    eparams = eng.default_scenario(device=device, dtype=dtype)
    tau_max, mg = robot.tau_max.double().cpu().numpy(), float(robot.total_mass) * 9.80665
    vloops, vparams = {}, {}
    for variant in VARIANTS:
        vmodel = load_robot(variant, device=device, dtype=dtype)
        vcfg = eng.variant_walking_config(vmodel)
        vloops[variant] = eng.ControlLoop(vmodel, ebat_cfg._replace(
            torso_task=vcfg.torso_task, hand_task=vcfg.hand_task))
        vparams[variant] = eng.variant_walking_scenario(vmodel, dtype=dtype)
    from g1_locomotion_tpu_torch.parallel import sweep

    # The pod sweep's batch (phase 15), drawn on the CPU and moved to the card.
    sparams_pod = sweep.randomize(sweep.SweepSpec(), torch.Generator().manual_seed(SWEEP_SEED),
                                  eparams)
    B_SWEEP = sparams_pod.batch()

    # Phase 1: record each kernel's main-path inputs (both MPC paths and the
    # serving path with the roll-moment cap, one serving WBID tick, the
    # batched WBID tick, one serving period, one batched period, one period
    # of the pod sweep's batch, one period of each variant cascade, one
    # update of the MPC class at B = 1, the MuJoCo bridge's first two ticks
    # at float64; the SRBD loop's phases give the kernels the MPC paths'
    # shapes), then hold each kernel against its plain version on them.
    from g1_locomotion_tpu_torch.engine import mujoco_bridge as mb

    robot64 = load_robot("g1_23dof", device=device, dtype=torch.float64)
    srv_cap = solver_for(srv_cfg._replace(roll_moment_max=ROLL_MOMENT_MAX), device, dtype)
    trace = load_trace()
    bridge = mb.BridgeController(robot64, params=eng.mujoco_standing_scenario(
        device=device, dtype=torch.float64))
    bridge.reset(trace["qpos"][0], trace["qvel"][0])
    calls = {}
    with recording_kernels(calls):
        run(srv_cap, inp, slice(0, B_RECORD))
        for t in range(2):
            bridge.step(trace["qpos"][t], trace["qvel"][t])
        run(thr, inp)
        run(srv, inp, slice(0, B_RECORD))
        serving_chain(wsrv, wsrv.model, wsrv.idx, device, dtype, ticks=1)
        wbat(wq, wv, wrefs)
        esrv.period(eng.init_state(esrv.model, esrv_cfg, 1, dtype), eparams)
        ebat.period(eng.init_state(ebat.model, ebat_cfg, B_CASCADE, dtype), eparams)
        ebat.period(eng.init_state(ebat.model, ebat_cfg, B_SWEEP, dtype), sparams_pod)
        for variant, vloop in vloops.items():
            vloop.period(eng.init_state(vloop.model, vloop.cfg, B_VARIANT, dtype),
                         vparams[variant])
        api, api_args = mpc_class_case(device)
        api.update(*api_args, x_current=api.x0)
    torch.cuda.synchronize()
    errs = compare_kernels(calls, device)
    m_cap = 200 + srv_cfg.horizon
    routes = {"gj_solve": cuda_lin.gj_plan("gj_solve", m_cap, dtype)[0],
              "admm_iterate": cuda_lin.admm_plan(120, m_cap, dtype)[0]}
    # B3's first input is S (1, m, m), B4's second A (1, m, n).
    recorded = {"gj_solve": any(key[0][-1] == m_cap for key, _, _ in calls["gj_solve"]),
                "admm_iterate": any(key[1][-2] == m_cap for key, _, _ in calls["admm_iterate"])}
    print(f"phase 1 serving solve with roll_moment_max = {ROLL_MOMENT_MAX}: m = {m_cap}; B3 "
          f"takes route {routes['gj_solve']} (gj_cluster_kernel), B4 at n = 120 route "
          f"{routes['admm_iterate']} (admm_tile_kernel<14>); both held above: {recorded}")
    if routes != CAPPED_ROUTES or not all(recorded.values()):
        raise AssertionError(f"phase 1: the capped serving solve's B3 / B4 take {routes}, "
                             f"expected {CAPPED_ROUTES}, or were not recorded")
    print("phase 1 kernels vs plain versions: ok")

    # Phases 2 and 3: the main path, each path counted on its own.
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    sol = run(thr, inp)
    torch.cuda.synchronize()
    thr_launches = read_counts()
    print(f"phase 2 throughput: B={B_THROUGHPUT} solved in {time.perf_counter() - t0:.3f} s "
          f"(first call, host clock); launches {thr_launches}")
    if thr_launches != THROUGHPUT_LAUNCHES:
        raise AssertionError(f"throughput path launched {thr_launches}, "
                             f"expected {THROUGHPUT_LAUNCHES}")
    check_invariants(sol, inp["contact"], "phase 2 throughput")
    with plain_kernels():
        ref = run(thr, inp, slice(0, B_COMPARE))
    torch.cuda.synchronize()
    du = (sol.u0[:B_COMPARE] - ref.u0).abs().amax(dim=-1)
    print(f"phase 2 kernel path vs plain path, first {B_COMPARE} instances: |du0| max "
          f"{float(du.max()):.3e} N, median {float(du.median()):.3e} N (max <= {DU0_MAX_N})")
    if float(du.max()) > DU0_MAX_N:
        bad = torch.nonzero(du > DU0_MAX_N).flatten().tolist()
        for i in bad[:10]:
            print(f"  instance {i}: |du0| {float(du[i]):.3e} N, pri/dua kernel "
                  f"{float(sol.pri_res[i]):.3e}/{float(sol.dua_res[i]):.3e}, plain "
                  f"{float(ref.pri_res[i]):.3e}/{float(ref.dua_res[i]):.3e}")
        raise AssertionError(f"{len(bad)} instances differ from the plain path by > {DU0_MAX_N} N")

    one = bench_inputs(1, device, dtype)  # instance 0 is standing
    x = one["x0"]
    cuda_lin.reset_launch_counts()
    for _ in range(SERVING_CHAIN):
        s1 = srv(x, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
        x = x + 1e-9 * torch.nn.functional.pad(s1.u0, (0, 1))  # data dependence
    torch.cuda.synchronize()
    check_invariants(s1, one["contact"], f"phase 3 serving ({SERVING_CHAIN}-solve chain)")
    srv_launches = read_counts()
    if srv_launches != SERVING_LAUNCHES:
        raise AssertionError(f"serving path launched {srv_launches}, expected {SERVING_LAUNCHES}")

    # Phase 3, capped: the same chain with the roll-moment cap (m = 210), B3
    # on its cluster tile and B4 on its 14-row tile, and by no other route.
    xc = one["x0"]
    cuda_lin.reset_launch_counts()
    for _ in range(SERVING_CHAIN):
        sc = srv_cap(xc, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
        xc = xc + 1e-9 * torch.nn.functional.pad(sc.u0, (0, 1))
    torch.cuda.synchronize()
    cap_routes = cuda_lin.route_counts()
    cap_launches = read_counts(routes=None)
    print(f"phase 3 capped serving ({SERVING_CHAIN}-solve chain, roll_moment_max = "
          f"{ROLL_MOMENT_MAX}): launches {cap_launches}, by route {cap_routes}")
    if cap_launches != SERVING_LAUNCHES or any(
            cap_routes[name] != {route: cap_launches[name]} for name, route in CAPPED_ROUTES.items()):
        raise AssertionError(f"capped serving path launched {cap_launches} by {cap_routes}, "
                             f"expected {SERVING_LAUNCHES} by {CAPPED_ROUTES}")
    check_invariants(sc, one["contact"], f"phase 3 capped serving ({SERVING_CHAIN}-solve chain)")
    sc = srv_cap(xc, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
    with plain_kernels():
        sc_plain = srv_cap(xc, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
    du = float((sc.u0 - sc_plain.u0).abs().max())
    print(f"phase 3 capped serving, one solve: kernel path vs plain path |du0| {du:.3e} N "
          f"(<= {DU0_MAX_N})")
    if not du <= DU0_MAX_N:
        raise AssertionError(f"capped serving solve: |du0| {du} N against the plain path")

    # Phase 5: the WBID serving tick, one control period of data-dependent
    # B = 1 ticks (kernels B2, B3, B4).
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    worst, (wq1, wv1, wrefs1) = serving_chain(wsrv, wsrv.model, wsrv.idx, device, dtype)
    torch.cuda.synchronize()
    wsrv_launches = read_counts()
    print(f"phase 5 WBID serving: {WBID_TICKS} ticks ({WBID_STANCE_TICKS} double support, then "
          f"left swing) in {time.perf_counter() - t0:.3f} s (host clock, with the checks); "
          f"launches {wsrv_launches}")
    if wsrv_launches != WBID_SERVING_LAUNCHES:
        raise AssertionError(f"WBID serving path launched {wsrv_launches}, "
                             f"expected {WBID_SERVING_LAUNCHES}")
    check_wbid(f"phase 5 WBID serving ({WBID_TICKS}-tick chain)", worst, phase=5)
    sk = wsrv(wq1, wv1, wrefs1)
    with plain_kernels():
        sp = wsrv(wq1, wv1, wrefs1)
    compare_paths("phase 5 WBID serving, one tick", sk, sp)

    # Phase 6: the batched WBID tick at B = 2048 (kernel B1).
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    wsol = wbat(wq, wv, wrefs)
    torch.cuda.synchronize()
    wbat_launches = read_counts()
    print(f"phase 6 WBID batched: B={B_WBID} in {time.perf_counter() - t0:.3f} s (host clock); "
          f"launches {wbat_launches}")
    if wbat_launches != WBID_BATCHED_LAUNCHES:
        raise AssertionError(f"WBID batched path launched {wbat_launches}, "
                             f"expected {WBID_BATCHED_LAUNCHES}")
    pattern = wrefs.contact_active.sum(dim=1)
    print(f"phase 6 instances: {int((pattern == 2).sum())} double support, "
          f"{int((pattern == 1).sum())} single support")
    check_wbid(f"phase 6 WBID batched (B={B_WBID})",
               wbid_violations(robot, wsol, wrefs.contact_active, phase=6), phase=6)
    with plain_kernels():
        wref = wbat(wq[:B_WBID_COMPARE], wv[:B_WBID_COMPARE], take(wrefs, B_WBID_COMPARE))
    compare_paths(f"phase 6 WBID batched, first {B_WBID_COMPARE} instances",
                  take(wsol, B_WBID_COMPARE), wref)

    # Phase 7: the serving period, a data-dependent chain of periods from
    # init_state (kernels B2, B3, B4), each period timed on the host clock.
    state = eng.init_state(esrv.model, esrv_cfg, 1, dtype)
    cuda_lin.reset_launch_counts()
    period_ms, logs, mid_state = [], [], None
    t0 = time.perf_counter()
    for k in range(SERVING_PERIODS):
        if k == SERVING_PERIODS - 6:
            mid_state = state  # the first swing's onset, for the comparison below
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, log = esrv.period(state, eparams)
        torch.cuda.synchronize()
        period_ms.append((time.perf_counter() - t1) * 1e3)
        logs.append(log_numpy(log))
    psrv_launches = read_counts()
    print(f"phase 7 serving period: {SERVING_PERIODS} periods ({SERVING_PERIODS * PERIOD_TICKS} "
          f"ticks) in {time.perf_counter() - t0:.3f} s (host clock); launches {psrv_launches}")
    if psrv_launches != SERVING_PERIOD_LAUNCHES:
        raise AssertionError(f"serving period launched {psrv_launches}, "
                             f"expected {SERVING_PERIOD_LAUNCHES}")
    chain_log = {k: np.concatenate([lg[k] for lg in logs], axis=1) for k in logs[0]}
    check_period(f"phase 7 serving ({SERVING_PERIODS}-period chain)",
                 period_maxima(chain_log, tau_max, mg), phase=7)
    swung = chain_log["contact"][..., 0].min()
    if swung != 0.0:
        raise AssertionError("phase 7: the chain never lifted the left foot")
    kernel_period = esrv.period(mid_state, eparams)
    with plain_kernels():
        plain_period = esrv.period(mid_state, eparams)
    compare_periods(f"phase 7 serving period {SERVING_PERIODS - 6} (the first swing)",
                    kernel_period, plain_period)

    # Phase 8: the batched cascade, one period at B = 2048 (kernel B1).
    bstate = eng.init_state(ebat.model, ebat_cfg, B_CASCADE, dtype)
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    bfin, blog = ebat.period(bstate, eparams)
    torch.cuda.synchronize()
    pbat_launches = read_counts()
    print(f"phase 8 batched cascade: B={B_CASCADE} period in {time.perf_counter() - t0:.3f} s "
          f"(host clock, first call); launches {pbat_launches}")
    if pbat_launches != CASCADE_LAUNCHES:
        raise AssertionError(f"batched cascade launched {pbat_launches}, "
                             f"expected {CASCADE_LAUNCHES}")
    check_period(f"phase 8 batched cascade (B={B_CASCADE})",
                 period_maxima(log_numpy(blog), tau_max, mg), phase=8)
    with plain_kernels():
        pref = ebat.period(take(bstate, B_COMPARE), eparams)
    compare_periods(f"phase 8 batched cascade, first {B_COMPARE} instances",
                    (take(bfin, B_COMPARE), take(blog, B_COMPARE)), pref)

    # Phase 9: the validated walk at float64, the golden's first periods (no
    # kernel on this path).
    walk = eng.ControlLoop(robot64, eng.walking_config())
    wstate = eng.init_state(walk.model, walk.cfg, 1, torch.float64)
    wparams = eng.walking_scenario(device=device, dtype=torch.float64, n_steps=8.0,
                                   v_cmd=(0.1, 0.0))
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    _, glog = walk.rollout(wstate, wparams, GOLDEN_PERIODS)
    torch.cuda.synchronize()
    walk_launches = read_counts()
    walk_s = time.perf_counter() - t0
    if any(walk_launches.values()):
        raise AssertionError(f"the walk launched {walk_launches}, expected no kernel")
    dev = check_golden(glog, GOLDEN_PERIODS)
    print(f"phase 9 golden prefix: {GOLDEN_PERIODS} periods ({GOLDEN_PERIODS * PERIOD_TICKS} "
          f"ticks) at float64 in {walk_s:.3f} s; launches {walk_launches}; contacts equal; "
          f"max |dCoM| {dev['com']:.3e} m, |dtau| {dev['tau']:.3e} N m, |df| "
          f"{dev['forces']:.3e} N (bounds {GOLDEN_TOL})")

    # Phase 10: the batched SRBD loop at B = 4096 (kernel B1), 200 periods
    # with a lateral kick per instance at period 60.
    from g1_locomotion_tpu_torch.mpc import srbd_loop as sl
    from g1_locomotion_tpu_torch.mpc.solver import MPCConfig

    scfg = MPCConfig()
    sloop = sl.SRBDLoop(scfg, SRBD_COM_HEIGHT)
    sparams = eng.walking_scenario(device=device, dtype=dtype)
    kicks = torch.tensor(srbd_kicks(B_SRBD), dtype=dtype, device=device)
    sstate = sl.init_loop_state(scfg, SRBD_COM_HEIGHT, batch=B_SRBD, device=device, dtype=dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    start.record()
    s_mid, slog1 = sloop.rollout(sstate, sparams, SRBD_KICK_AT, kicks[:, :SRBD_KICK_AT])
    s_fin, slog2 = sloop.rollout(s_mid, sparams, SRBD_PERIODS - SRBD_KICK_AT,
                                 kicks[:, SRBD_KICK_AT:])
    end.record()
    torch.cuda.synchronize()
    srbd_wall = time.perf_counter() - t0
    srbd_ms = start.elapsed_time(end)
    srbd_launches = read_counts()
    print(f"phase 10 batched SRBD loop: B={B_SRBD}, {SRBD_PERIODS} periods in {srbd_ms:.1f} ms "
          f"(CUDA events; host clock {srbd_wall:.3f} s): {SRBD_PERIODS / (srbd_ms / 1e3):.1f} "
          f"periods/s, {B_SRBD * SRBD_PERIODS / (srbd_ms / 1e3):.1f} instance-periods/s; "
          f"launches {srbd_launches} "
          f"({srbd_launches['chol_inverse_base'] / SRBD_PERIODS:.1f} B1 a period)")
    if srbd_launches != SRBD_LAUNCHES:
        raise AssertionError(f"batched SRBD loop launched {srbd_launches}, "
                             f"expected {SRBD_LAUNCHES}")
    slog = {k: np.concatenate([log_numpy(slog1)[k], log_numpy(slog2)[k]], axis=1)
            for k in slog1._fields}
    check_srbd(f"phase 10 batched SRBD loop (B={B_SRBD})", srbd_maxima(slog), phase=10)
    print(f"phase 10 lateral CoM at the end: |y| max {float(s_fin.x[:, 4].abs().max()):.4f} m, "
          f"x mean {float(s_fin.x[:, 3].mean()):.4f} m; kicks {float(kicks.min()):.4f}-"
          f"{float(kicks.max()):.4f} m/s")
    s8 = take(s_mid, SRBD_COMPARE)
    k8 = kicks[:SRBD_COMPARE, SRBD_KICK_AT]
    kernel_s = sloop.period(s8, sparams, k8)
    with plain_kernels():
        plain_s = sloop.period(s8, sparams, k8)
    compare_srbd(f"phase 10 batched SRBD loop, period {SRBD_KICK_AT} (the kick), first "
                 f"{SRBD_COMPARE} instances", kernel_s, plain_s)

    # Phase 11: the SRBD loop's serving chain, B = 1 (kernels B2, B3, B4).
    srv_scfg = scfg._replace(qp=scfg.qp._replace(polish_kernel=True))
    sloop_srv = sl.SRBDLoop(srv_scfg, SRBD_COM_HEIGHT)
    state1 = sl.init_loop_state(srv_scfg, SRBD_COM_HEIGHT, batch=1, device=device, dtype=dtype)
    cuda_lin.reset_launch_counts()
    srbd_srv_ms, srv_logs, s_cmp = [], [], None
    for k in range(SRBD_SERVING_PERIODS):
        if k == SRBD_SERVING_PERIODS // 2:
            s_cmp = state1
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state1, log1 = sloop_srv.period(state1, sparams)
        torch.cuda.synchronize()
        srbd_srv_ms.append((time.perf_counter() - t1) * 1e3)
        srv_logs.append(log1)
    ssrv_launches = read_counts()
    print(f"phase 11 SRBD-loop serving chain: {SRBD_SERVING_PERIODS} B = 1 periods, p50 "
          f"{median(srbd_srv_ms):.3f} ms, max {max(srbd_srv_ms):.3f} ms per period (host "
          f"clock, synchronized); launches {ssrv_launches}")
    if ssrv_launches != SRBD_SERVING_LAUNCHES:
        raise AssertionError(f"SRBD-loop serving chain launched {ssrv_launches}, "
                             f"expected {SRBD_SERVING_LAUNCHES}")
    srv_log = sl.SRBDLoopLog(*(torch.stack(f, dim=1) for f in zip(*srv_logs)))
    check_srbd(f"phase 11 SRBD-loop serving chain ({SRBD_SERVING_PERIODS} periods)",
               srbd_maxima(log_numpy(srv_log)), phase=11)
    kernel_1 = sloop_srv.period(s_cmp, sparams)
    with plain_kernels():
        plain_1 = sloop_srv.period(s_cmp, sparams)
    compare_srbd(f"phase 11 SRBD-loop serving chain, period {SRBD_SERVING_PERIODS // 2}",
                 kernel_1, plain_1)

    # Phase 12: the validated SRBD walk at float64 (no kernel: the
    # factorization path).
    wcfg = eng.walking_config().mpc
    state64 = sl.init_loop_state(wcfg, SRBD_COM_HEIGHT, batch=1, device=device,
                                 dtype=torch.float64)
    cuda_lin.reset_launch_counts()
    t0 = time.perf_counter()
    _, wlog = sl.SRBDLoop(wcfg, SRBD_COM_HEIGHT).rollout(state64, wparams, SRBD_PERIODS)
    torch.cuda.synchronize()
    swalk_s = time.perf_counter() - t0
    swalk_launches = read_counts()
    if any(swalk_launches.values()):
        raise AssertionError(f"the SRBD walk launched {swalk_launches}, expected no kernel")
    bar = check_srbd_walk(wlog)
    print(f"phase 12 SRBD walk at float64: {SRBD_PERIODS} periods in {swalk_s:.3f} s (host "
          f"clock); launches {swalk_launches}; meets tests/test_srbd_loop.py's bar: {bar}")

    # Phase 13: the variant cascade, one default period at B = 2048 for each
    # variant (kernel B1 at the new block sizes).
    var_launches, var_ms = {}, {}
    for variant, vloop in vloops.items():
        vstate = eng.init_state(vloop.model, vloop.cfg, B_VARIANT, dtype)
        torch.cuda.synchronize()
        cuda_lin.reset_launch_counts()
        start.record()
        vfin, vlog = vloop.period(vstate, vparams[variant])
        end.record()
        torch.cuda.synchronize()
        var_ms[variant] = start.elapsed_time(end)
        var_launches[variant] = read_counts()
        print(f"phase 13 variant cascade {variant} (nv = {vloop.model.nv}): B={B_VARIANT} period "
              f"in {var_ms[variant]:.3f} ms (CUDA events; the model's first period); launches "
              f"{var_launches[variant]}")
        if var_launches[variant] != VARIANT_LAUNCHES[variant]:
            raise AssertionError(f"{variant} cascade launched {var_launches[variant]}, "
                                 f"expected {VARIANT_LAUNCHES[variant]}")
        vmg = float(vloop.model.total_mass) * 9.80665
        check_period(f"phase 13 {variant} cascade (B={B_VARIANT})",
                     period_maxima(log_numpy(vlog), vloop.model.tau_max.double().cpu().numpy(),
                                   vmg), phase=variant)
        with plain_kernels():
            vref = vloop.period(take(vstate, B_COMPARE), vparams[variant])
        compare_periods(f"phase 13 {variant} cascade, first {B_COMPARE} instances",
                        (take(vfin, B_COMPARE), take(vlog, B_COMPARE)), vref)
        del vfin, vlog, vref

    # Phase 14: the reference-compatible MPC class on the card (B1 at B = 1).
    from g1_locomotion_tpu_torch.models.srbd import G1_MASS, GRAVITY

    api, api_args = mpc_class_case(device)
    cuda_lin.reset_launch_counts()
    u_api, x_api = api.update(*api_args, x_current=api.x0, one_rollout=True)
    u_api2, _ = api.update(*api_args, x_current=api.x0)
    api_launches = read_counts()
    with plain_kernels():
        api_ref, _ = mpc_class_case(device)
        u_ref = api_ref.update(*api_args, x_current=api_ref.x0)[0]
        u_ref2 = api_ref.update(*api_args, x_current=api_ref.x0)[0]
    api_mg = G1_MASS * -GRAVITY
    api_fz, api_du = float(u_api[2::3].sum()), float(np.abs(u_api2 - u_api).max())
    api_cmp = max(float(np.abs(u_api - u_ref).max()), float(np.abs(u_api2 - u_ref2).max()))
    print(f"phase 14 MPC class: sum fz {api_fz:.3f} N (m g {api_mg:.3f} N, within 0.5%), "
          f"warm-started second update |du0| {api_du:.3e} N (<= {DU0_MAX_N}); x_opt "
          f"{x_api.shape}; launches {api_launches}; both updates kernel path vs plain path "
          f"|du0| max {api_cmp:.3e} N (<= {DU0_MAX_N})")
    if api_launches != API_LAUNCHES:
        raise AssertionError(f"the MPC class launched {api_launches}, expected {API_LAUNCHES}")
    if not (abs(api_fz - api_mg) <= 5e-3 * api_mg and api_du <= DU0_MAX_N
            and u_api.shape == (12,) and x_api.shape == (11, 13)):
        raise AssertionError("phase 14: the MPC class's standing solve is off")
    if not api_cmp <= DU0_MAX_N:
        raise AssertionError("phase 14: the MPC class's kernel path differs from its plain path")

    # Phase 15: the pod sweep (parallel/sweep.run_sweep) at full width, the
    # default configuration, SWEEP_PERIODS periods unchunked, then the same
    # periods as chunks of one period through a checkpoint.
    pod = pod_sweep(ebat, sparams_pod, tau_max, mg, dtype)

    # The gait sweep demo (BASELINE config 3) at B = 4096: B1 on both solves.
    from g1_locomotion_tpu_torch.api import demos

    cuda_lin.reset_launch_counts()
    gait = demos.demo_gait_sweep(batch=B_THROUGHPUT, device=device)
    gait_launches = read_counts()
    print(f"gait sweep demo: {gait}; launches {gait_launches}")
    if gait_launches != GAIT_SWEEP_LAUNCHES:
        raise AssertionError(f"the gait sweep demo launched {gait_launches}, "
                             f"expected {GAIT_SWEEP_LAUNCHES}")
    if not (np.isfinite(gait["max_pri_res"]) and gait["solves_per_s"] > 0):
        raise AssertionError(f"the gait sweep demo's result is off: {gait}")

    # Phase 16: telemetry on the serving period and on a default period at
    # B_CASCADE; with telemetry off (phases 7 and 8) the fields are zeros.
    for label, log in (("phase 7", chain_log), ("phase 8", log_numpy(blog))):
        if np.abs(log["mpc_ms"]).max() != 0.0 or np.abs(log["wbid_ms"]).max() != 0.0:
            raise AssertionError(f"{label}: telemetry off, but mpc_ms / wbid_ms are not 0")
    tel_launches = {}
    for name, cfg, batch in (("serving", esrv_cfg, 1), ("batched", ebat_cfg, B_CASCADE)):
        tel_launches[name] = telemetry_period(name, eng.ControlLoop(robot, cfg._replace(
            telemetry=True)), batch, eparams, dtype)

    # Phase 17: the MuJoCo bridge at float64 (kernel B1 <double, n> at B = 1).
    bridge_paths = bridge_phase(robot64, device, gpu)

    paths = {"MPC throughput": thr_launches, "MPC serving": srv_launches,
             "MPC serving, roll-moment cap": cap_launches,
             "WBID serving": wsrv_launches, "WBID batched": wbat_launches,
             "serving period": psrv_launches, "batched cascade": pbat_launches,
             "SRBD loop batched": srbd_launches, "SRBD loop serving": ssrv_launches,
             **{f"{v} cascade": var_launches[v] for v in VARIANTS}, "MPC class": api_launches,
             "pod sweep": {k: pod["launches"][0][k] + pod["launches"][1][k] for k in REPLACES},
             "gait sweep demo": gait_launches,
             **{f"telemetry {k} period": v for k, v in tel_launches.items()},
             **{f"MuJoCo bridge {k}": v for k, v in bridge_paths.items()}}
    launches = {name: sum(p[name] for p in paths.values()) for name in REPLACES}
    print(f"main-path launches: {launches} ("
          + "; ".join(f"{path} {count}" for path, count in paths.items()) + ")")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # Phase 4: timings (the card's name and power limit on every line).
    thr_ms = sorted(cuda_ms(lambda: run(thr, inp), reps=1, warmup=1 if i == 0 else 0)
                    for i in range(THROUGHPUT_BATCHES))
    rates = [B_THROUGHPUT / (ms / 1e3) for ms in thr_ms]
    print(f"[{gpu}] throughput: median {B_THROUGHPUT / (median(thr_ms) / 1e3):.1f} solves/s "
          f"(B={B_THROUGHPUT} batch {median(thr_ms):.3f} ms median, range "
          f"{thr_ms[0]:.3f}-{thr_ms[-1]:.3f} ms, solves/s {min(rates):.1f}-{max(rates):.1f}; "
          f"{THROUGHPUT_BATCHES} batches, CUDA events)")
    for _ in range(3):
        srv(x, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
    lat = []
    for _ in range(SERVING_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv(x, one["x_ref"], one["contact"], one["c_hor"], one["p_hor"])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_t = torch.tensor(lat)
    print(f"[{gpu}] serving B=1 solve latency: p50 {float(lat_t.quantile(0.5)):.3f} ms, "
          f"p99 {float(lat_t.quantile(0.99)):.3f} ms over {len(lat)} sequential solves "
          f"(host clock, synchronized)")

    for _ in range(3):
        wsrv(wq1, wv1, wrefs1)
    lat = []
    for _ in range(TICK_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wsrv(wq1, wv1, wrefs1)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat_t = torch.tensor(lat)
    print(f"[{gpu}] WBID serving B=1 tick latency: p50 {float(lat_t.quantile(0.5)):.3f} ms, "
          f"p99 {float(lat_t.quantile(0.99)):.3f} ms over {len(lat)} sequential ticks "
          f"(host clock, synchronized)")
    tick_ms = sorted(cuda_ms(lambda: wbat(wq, wv, wrefs), reps=1, warmup=1 if i == 0 else 0)
                     for i in range(TICK_BATCHES))
    print(f"[{gpu}] WBID batched tick: median {B_WBID / (median(tick_ms) / 1e3):.1f} ticks/s "
          f"(B={B_WBID} tick {median(tick_ms):.3f} ms median, range {tick_ms[0]:.3f}-"
          f"{tick_ms[-1]:.3f} ms; {TICK_BATCHES} ticks, CUDA events)")

    srv_p = sorted(period_ms)
    print(f"[{gpu}] serving period (B=1, {PERIOD_TICKS} ticks): p50 {median(srv_p):.3f} ms, "
          f"max {srv_p[-1]:.3f} ms, min {srv_p[0]:.3f} ms over the {SERVING_PERIODS}-period "
          f"chain of phase 7; per tick {median(srv_p) / PERIOD_TICKS:.3f} ms at the p50 "
          f"(host clock, synchronized; {40 / (median(srv_p) / 1e3):.1f} ticks/s)")
    cas_ms = sorted(cuda_ms(lambda: ebat.period(bstate, eparams), reps=1, warmup=0)
                    for _ in range(CASCADE_REPS))
    print(f"[{gpu}] batched cascade (B={B_CASCADE}): period median {median(cas_ms):.3f} ms, "
          f"range {cas_ms[0]:.3f}-{cas_ms[-1]:.3f} ms ({CASCADE_REPS} periods, CUDA events); "
          f"{B_CASCADE * PERIOD_TICKS / (median(cas_ms) / 1e3):.1f} ticks/s, "
          f"{B_CASCADE / (median(cas_ms) / 1e3):.1f} periods/s")

    for variant, v_ms in var_ms.items():
        print(f"[{gpu}] {variant} cascade (B={B_VARIANT}, nv = {vloops[variant].model.nv}): "
              f"period {v_ms:.3f} ms (phase 13's, CUDA events); "
              f"{B_VARIANT * PERIOD_TICKS / (v_ms / 1e3):.1f} ticks/s")
    print(f"[{gpu}] batched SRBD loop (B={B_SRBD}): {srbd_ms / SRBD_PERIODS:.3f} ms a period, "
          f"{B_SRBD * SRBD_PERIODS / (srbd_ms / 1e3):.1f} instance-periods/s (phase 10's "
          f"{SRBD_PERIODS} periods, CUDA events); SRBD-loop serving (B=1): p50 "
          f"{median(srbd_srv_ms):.3f} ms, max {max(srbd_srv_ms):.3f} ms a period (phase 11, "
          f"host clock)")
    pod_ms = median(pod["period_ms"])
    print(f"[{gpu}] pod sweep (B={pod['batch']}, default configuration): period median "
          f"{pod_ms:.3f} ms over phase 15's {SWEEP_PERIODS} unchunked periods "
          f"({', '.join('%.3f' % m for m in pod['period_ms'])} ms, CUDA events); "
          f"{pod['batch'] / (pod_ms / 1e3):.1f} scenario-periods/s, "
          f"{pod['batch'] * PERIOD_TICKS / (pod_ms / 1e3):.1f} scenario-ticks/s")
    print(f"[{gpu}] gait sweep demo (B={gait['batch']}): {gait['solves_per_s']:.1f} solves/s "
          f"(one batched solve after the first, host clock, synchronized)")

    # A batch of SPD matrices of the throughput K's size, for the recursion alone.
    gen = torch.Generator().manual_seed(2)
    M = torch.randn((B_THROUGHPUT, 120, 120), generator=gen).to(device)
    Kb = M @ M.mT + 120 * torch.eye(120, device=device)
    del M

    if argv == ["--profile"]:
        from g1_locomotion_tpu_torch.ops import lin

        profile_path("serving", lambda: srv(x, one["x_ref"], one["contact"], one["c_hor"],
                                            one["p_hor"]), PROFILE_SOLVES, "solve", gpu)
        profile_path("throughput", lambda: run(thr, inp), PROFILE_BATCHES, "batch", gpu,
                     by=op_kind)
        profile_path("lin.chol_inverse (4096, 120, 120)", lambda: lin.chol_inverse(Kb), 5,
                     "call", gpu, by=op_kind)
        profile_path("WBID serving", lambda: wsrv(wq1, wv1, wrefs1), PROFILE_TICKS, "tick", gpu,
                     by=op_kind)
        profile_path(f"WBID batched B={B_WBID}", lambda: wbat(wq, wv, wrefs), 3, "tick", gpu,
                     by=op_kind)
        profile_path("serving period", lambda: esrv.period(mid_state, eparams), 1, "period",
                     gpu, by=op_kind)
        profile_path(f"batched cascade B={B_CASCADE}", lambda: ebat.period(bstate, eparams), 1,
                     "period", gpu, by=op_kind)
        profile_path(f"batched SRBD loop B={B_SRBD}", lambda: sloop.period(s_mid, sparams), 5,
                     "period", gpu, by=op_kind)
        profile_path("SRBD-loop serving B=1", lambda: sloop_srv.period(s_cmp, sparams), 10,
                     "period", gpu, by=op_kind)
        pod_state = eng.init_state(ebat.model, ebat_cfg, B_SWEEP, dtype)
        profile_path(f"pod sweep B={B_SWEEP}",
                     lambda: sweep.run_sweep(ebat, sparams_pod, 1, states0=pod_state), 1,
                     "period", gpu, by=op_kind)
        hand = vloops["g1_29dof_with_hand"]
        hstate = eng.init_state(hand.model, hand.cfg, B_VARIANT, dtype)
        profile_path(f"g1_29dof_with_hand cascade B={B_VARIANT}",
                     lambda: hand.period(hstate, vparams["g1_29dof_with_hand"]), 1, "period",
                     gpu, by=op_kind)

    # Each kernel beside its plain version, its library call and its bounds.
    # B1 at each block size of the throughput path, widest first, on each
    # strided layout the recursion gave it and dense; B2-B4 on one serving
    # instance. The kernel and the library call are timed in turns, ROUNDS
    # times REPS launches each, and the medians kept.
    ROUNDS, REPS = 5, 20
    # B1 <double, n> at the pod-sweep demo's (4096, n, n): phase 1's batches.
    b1_f64_batches = [random_spd(B_THROUGHPUT, n, 1e3, 200 + n, device, torch.float64)
                      for n in B1_F64_SIZES]
    chain_us = {w: barrier_chain_us(probe_path, w, device)
                for w in (*sorted({GJ_WARPS, ADMM_WARPS}, reverse=True), 0, "cluster")}
    for w, us in chain_us.items():
        what = {0: "one warp: store to shared memory, __syncwarp(), load",
                "cluster": f"a cluster of {CLUSTER_SMS} CTAs of {GJ_WARPS} warps: store to "
                           f"both CTAs' shared memory, cluster barrier, load"}.get(
            w, f"one block of {w} warps: store to shared memory, block barrier, load")
        print(f"[{gpu}] barrier chain, {what}: {us:.4f} us per step")
    rows = {}    # {name: the kernels-line numbers at the first (widest) shape}
    shapes = {}  # {name: [the numbers at each timed shape, with its route]}
    for name in REPLACES:
        kernel, plain = getattr(cuda_lin, name), cuda_lin.PLAIN[name]
        if name == "chol_inverse_base":
            cases = []
            for K, strides in cases_b1(calls) + [(K, None) for K in b1_f64_batches]:
                if strides is None:
                    k_view, w_view = K, torch.empty_like(K)
                    label = f"{tuple(K.shape)} dense"
                else:
                    (_, k_view), (_, w_view) = (strided_copy(K, strides[0]),
                                                strided_copy(K, strides[1]))
                    label = f"{tuple(K.shape)} K strides {strides[0]}, W strides {strides[1]}"
                cases.append((label, [K], lambda k=k_view, w=w_view: kernel(k, out=w)))
        else:
            cases = []
            for args in first_per_shape(calls[name]):
                label = str(tuple(args[0].shape))
                if name == "admm_iterate":
                    label = f"K^-1 {tuple(args[0].shape)}, A {tuple(args[1].shape)}, {args[9]} iterations"
                cases.append((label, args, lambda args=args: kernel(*args)))
        for label, args, launch in cases:
            lib = library_call(name, args)
            route = kernel_route(name, args)
            other = ALSO_TIMED.get((name, route))
            also = forced_launch(name, args, other) if other else None
            k_all, l_all, a_all = [], [], []
            for _ in range(ROUNDS):
                k_all.append(cuda_ms(launch, reps=REPS, queue_ahead=True))
                if lib:
                    l_all.append(cuda_ms(lib[1], reps=REPS, queue_ahead=True))
                if also:
                    a_all.append(cuda_ms(also, reps=REPS, queue_ahead=True))
            k_ms, l_ms = median(k_all), (median(l_all) if lib else None)
            p_ms = cuda_ms(lambda: plain(*args), reps=5)
            need = work(name, args)
            peak = PEAK_FP64_FLOPS if args[0].dtype == torch.float64 else PEAK_FP32_FLOPS
            bound_ms, bound_by = max((need["bytes"] / PEAK_BYTES_PER_S * 1e3, "bytes"),
                                     (need["flops"] / peak * 1e3, "operations"))
            row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": l_ms}
            rows.setdefault(name, row)
            line = (f"[{gpu}] {name} at {label} (route {route}): kernel {k_ms:.4f} ms "
                    f"(rounds {min(k_all):.4f}-{max(k_all):.4f}), plain {p_ms:.4f} ms, "
                    f"card bound {bound_ms:.6f} ms by {bound_by} "
                    f"({need['bytes']} B, {need['flops']:.0f} flop)")
            if lib:
                line += (f", {lib[0]} {l_ms:.4f} ms (rounds {min(l_all):.4f}-{max(l_all):.4f}), "
                         f"kernel / library {k_ms / l_ms:.3f}")
            if also:
                row[f"{other}_ms"] = median(a_all)
                what = ("the shared-memory kernel that ran this shape before" if other == "smem"
                        else "B3's cluster tile at this shape")
                line += (f"; by route {other}, {what}: {row[f'{other}_ms']:.4f} ms (rounds "
                         f"{min(a_all):.4f}-{max(a_all):.4f}), "
                         f"{row[f'{other}_ms'] / k_ms:.2f}x the kernel's time")
            if "steps" in need:
                sms = need["sms"]
                ops_ms = need["flops"] / (PEAK_FP32_FLOPS * sms / SM_COUNT) * 1e3
                chain_ms = need["steps"] * chain_us[need["chain"]] / 1e3
                row["sm_bound_ms"] = max(ops_ms, chain_ms)
                word = "one-SM" if sms == 1 else f"{sms}-SM"
                line += (f"; {word} bound {row['sm_bound_ms']:.4f} ms (operations at "
                         f"{sms}/{SM_COUNT} of the fp32 rate {ops_ms:.4f} ms, chain of "
                         f"{need['steps']} steps {chain_ms:.4f} ms), kernel / {word} bound "
                         f"{k_ms / row['sm_bound_ms']:.2f}, "
                         f"{k_ms / need['steps'] * 1e3:.3f} us per step")
                if sms > 1:
                    line += (f"; a cluster barrier every step would add the probe's cluster "
                             f"chain, {need['steps']} x {chain_us['cluster']:.4f} us = "
                             f"{need['steps'] * chain_us['cluster'] / 1e3:.4f} ms")
            if name == "chol_inverse_base":
                b, n = args[0].shape[0], args[0].shape[-1]
                line += (f"; a warp's chain of {n} column steps at {chain_us[0]:.4f} us: "
                         f"{n * chain_us[0] / 1e3:.6f} ms")
                if b == 1:
                    # One matrix is one warp on one SM: the larger of its
                    # operations at 1/SM_COUNT of the rate and the chain.
                    row["sm_bound_ms"] = max(need["flops"] / (peak / SM_COUNT) * 1e3,
                                             n * chain_us[0] / 1e3)
                    line += (f"; one-SM bound {row['sm_bound_ms']:.6f} ms, kernel / one-SM "
                             f"bound {k_ms / row['sm_bound_ms']:.2f}")
            shapes.setdefault(name, []).append({"shape": label, "kernel_route": route, **row})
            print(line)

    # B4's fixed part (the launch, reading K^-1 and A, writing x, z, y) and its
    # slope per iteration: the same instance at 0, 10 and 20 iterations, at
    # each shape.
    for b4 in first_per_shape(calls["admm_iterate"]):
        b4_ms = {num: median(cuda_ms(lambda: cuda_lin.admm_iterate(*b4[:9], num, *b4[10:]),
                                     reps=REPS, queue_ahead=True) for _ in range(ROUNDS))
                 for num in (0, 10, 20)}
        print(f"[{gpu}] admm_iterate at {tuple(b4[1].shape)}: " + ", ".join(
            f"{num} iterations {ms:.4f} ms" for num, ms in b4_ms.items())
              + f"; fixed part {b4_ms[0] * 1e3:.3f} us, slope "
              f"{(b4_ms[20] - b4_ms[0]) / 20 * 1e3:.3f} us per iteration")

    # Yardsticks that take more than one PyTorch call (printed, not in the
    # kernels line): B2 by Cholesky, and B1 as a factorization and a solve.
    for args in first_per_shape(calls["gj_inverse"]):
        K2 = args[0]
        ms_chol = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(K2).L),
                          reps=REPS)
        print(f"[{gpu}] gj_inverse at {tuple(K2.shape)}: torch.linalg.cholesky_ex + "
              f"torch.cholesky_inverse (a pair) {ms_chol:.4f} ms")
    for K1 in [K for K, strides in cases_b1(calls) if strides is None] + b1_f64_batches:
        eye = torch.eye(K1.shape[-1], device=device, dtype=K1.dtype).expand_as(K1)
        ms_pair = cuda_ms(lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky_ex(K1).L, eye, upper=False), reps=5)
        print(f"[{gpu}] chol_inverse_base at {tuple(K1.shape)}: torch.linalg.cholesky_ex + "
              f"torch.linalg.solve_triangular on the identity (a pair) {ms_pair:.4f} ms")

    # For later perf work: the recursion ending in B1 against the library
    # Cholesky inverse at the throughput K's size. Recorded, not switched.
    from g1_locomotion_tpu_torch.ops.lin import spd_inverse

    rec_ms = cuda_ms(lambda: spd_inverse(Kb), reps=5)
    lib_ms = cuda_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky_ex(Kb).L), reps=5)
    print(f"[{gpu}] SPD inverse (4096, 120, 120): recursion + B1 {rec_ms:.3f} ms, "
          f"torch.linalg.cholesky_ex + cholesky_inverse {lib_ms:.3f} ms")

    # The capped serving solve (phase 3's chain): host clock, and its device
    # time by CUDA events with the solve queued behind a busy card (no
    # operation of the serving solve waits for the card), beside the
    # uncapped one's.
    for label, solver in (("serving", srv), ("capped serving", srv_cap)):
        args = (xc if solver is srv_cap else x, one["x_ref"], one["contact"], one["c_hor"],
                one["p_hor"])
        for _ in range(3):
            solver(*args)
        lat = []
        for _ in range(CAPPED_SAMPLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver(*args)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        dev = [cuda_ms(lambda: solver(*args), reps=1, warmup=0, queue_ahead=True,
                       busy_cycles=SOLVE_BUSY_CYCLES) for _ in range(ROUNDS)]
        print(f"[{gpu}] {label} B=1 solve (roll_moment_max "
              f"{solver.cfg.roll_moment_max}): host clock p50 {median(lat):.3f} ms over "
              f"{CAPPED_SAMPLES} solves; device time {median(dev):.4f} ms (CUDA events, "
              f"queued behind a busy card; rounds {min(dev):.4f}-{max(dev):.4f})")

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": errs[name], **rows[name],
         "launches_by_route": ROUTE_LAUNCHES.get(name, {}), "shapes": shapes[name],
         "paths": {path: p[name] for path, p in paths.items() if p[name]}}
        for name in REPLACES
    ]
    for kernel in kernels:
        if sum(kernel["launches_by_route"].values()) != kernel["launches"]:
            raise AssertionError(f"{kernel['name']}: launches by route "
                                 f"{kernel['launches_by_route']} do not add up to "
                                 f"{kernel['launches']}")
    print(f"chip_smoke.py: {time.perf_counter() - T_START:.1f} s in all, the build included")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.stdout.flush()
