"""On-card smoke run of the PyTorch/CUDA port: the whole-body solve, the
whole-body closed loop and its fleet, the scenario-batched and
sample-sharded solves, the drone MPPI path, the arm node, the
pick_weight task, the multirotor preset and the perfect-model whole-body
loop, the fixed-wing flyby, mapped flight, the plain whole-body solve on
the card, the rotorcraft flight layer, the solver bridge (the QMM
server with both sessions, the sim and HIL adapters, the float64 plant
oracle), the camera stack with the scenario command line, and the offline
tools (the config tree, dataset collection, profiling, the rosbag reader,
the URDF loader with the matrix FK).

    python3 chip_smoke.py
    python3 chip_smoke.py --phases 10,26   # the build, then phases 10 and 26 alone

Needs one CUDA card and ``nvcc``; builds the kernels from ``csrc/`` at
first use, one ``nvcc`` per source, all at once.  Phases (each prints its
lines; any failure exits non-zero before the final ``ok`` line):

1. device and build: the card's name and power limit, ``ptxas -v`` lines;
2. each solve kernel against its plain PyTorch version at K=4096, H=50 in
   the attitude, position and wrench presets, with explicit noise, plus one
   full step against the plain pipeline;
3. the Philox path: the kernel's spilled noise against the plain Philox;
4. the serving path: 50 packed solves of the flagship configuration through
   ``make_packed_step``, each a CUDA-graph replay: launches counted per
   replay, replies and warm start bit-equal to the eager call
   (``graph=False``), host ms per solve of both (under 10 ms graphed), the
   bridge head graphed against eager; then kernel timings and profiles of
   graphed and eager solves (device busy share);
5. the plant tick (eight lanes per vehicle row) against its plain version
   at B=1 and B=1024, bit-equal reruns and rows equal to their one-row
   launches, its CUDA-event and CUDA-graph timings beside its bound and
   the launch floor (an empty kernel's graph replay), and its registers;
6. the serving episode: 100 control steps of the position-mode closed loop
   at K=4096, H=50 with the plant-tick kernel, one replay of a captured
   control step per step: launches counted per replay, logs and final
   plant bit-equal to the eager loop, no host synchronization in the
   replay loop, host ms per step and device busy share of both, the eager
   step's host time per part;
7. the reach gate: 1000-step graphed episodes (10 s of flight) for seeds
   0-2 in position mode (serving loop) and in attitude and wrench modes
   (the per-substep RNEA plant), K=4096, H=50, scored with
   ``episode_quality``; each must converge and hold;
8. the scenario batch, B=256 x K=4096 x H=50 in the attitude preset: the
   no-spill pair (rows 4, 5) against its plain versions on all 256
   scenarios and the spill pair on 4, the batched step against unbatched
   steps (batches of 4 and 8, and 4 scenarios of the B=256 batch), 1 + 1
   launches per batched solve, ms per batched solve
   at B=1, 16, 256, then the kernels alone at B=256 (pass 2 and
   ``torch.bmm`` also by the profiler and by CUDA-graph replay);
9. no spill against spill at K=4096 (du, u_seq, sigma), and each new
   kernel (rows 4-7) against its plain version at one scenario, K=4096,
   with timings and bounds;
10. the sample-sharded solve: two gloo ranks on the one card, K=4096 as
   2 x 2048, both kernel pairs against the one-rank solve over 3 solves,
   all-reduce calls per solve, ms per sharded solve, weak scaling; then
   on each rank pass 2 (rows 7, 6) on that rank's own inputs of each solve
   against its plain version, and its timings at K_local = 2048; and on
   the same two ranks the arm node's plain solve sample-sharded (K=100 as
   2 x 50) against the one-rank arm solve over 3 solves (2e-3); the
   multirotor, fixed-wing and mapped presets (spheres, ESDF) through
   ``make_sharded_solver`` at K=1024 as 2 x 512, unbatched and with 2
   scenarios (two different maps), against the one-rank solve over 3
   solves (1e-5 of the plan's largest entry), 3 all-reduces per solve, ms
   per unbatched sharded solve; ``measure_weak_scaling`` with
   ``backend="cuda"`` and ``backend="torch"``, each named in its result;
11. the drone kernels (rows 9a-9d) against their plain versions at the
   preset K=1000, H=32, at K=1024, 4096, 16384 (H=32) and at K=16384,
   H=100, with CUDA-event, profiler and CUDA-graph timings, bounds, the
   launch floor and the ``torch.mv`` yardstick of pass 2 (column blocks:
   one column and all K at small K, 32-column tiles with K split across
   blocks at large K);
   the kernel solve against the first step of ``make_drone_solver`` on the
   same seed; host ms per solve of both at K=1024, with profiles;
12. the drone's closed loops: (a) the kernel solve in the point-mass loop,
   800 steps at the preset, the key advanced on the card (800 + 800
   launches of rows 9a and 9b); (b) the explicit-noise loop, 80 steps at
   K=1024 (80 + 80 of rows 9c and 9d); (c) the drone waypoint episode,
   ``make_drone_solver`` at the preset through ``make_episode`` with
   backstepping, 2000 control steps, each a replay of one captured control
   step: no host synchronization in the replay loop, the first 100 steps'
   logs and final state bit-equal to the eager loop, host ms per step
   graphed and eager, the graphed step's device busy share; each with its
   gate; (d) the batched
   drone preset, ``make_drone_solver(n_scenarios=256)`` at K=1000, H=32 on
   the Philox stream: four of its scenarios against their unbatched solves
   over three steps (1e-6), host ms per batched solve;
13. ``wb_update`` at every rows-per-block R the source is built for, at
   its main paths' shapes (row 3 at B=1 and B=256, row 5 at B=256, rows 6
   and 7 at K_local): the sums bit-equal for every R, CUDA-graph and
   profiler ms per R, the R the launcher picks, the library call's;
14. ``wb_cost`` (a warp per sample, the horizon across its lanes) in the
   three modes and the three variants (spill, no spill, explicit noise), at
   B=1, 16, 256 and at K_local=2048 with a sample offset: S against the
   plain version, each scenario of a batch bit-equal to its unbatched
   launch, the spill bit-equal to ``philox_eps``, bit-equal reruns,
   CUDA-graph and profiler ms;
15. the fleet episode (``make_whole_body_episode(n_scenarios=B)``, one
   graphed control step for B vehicles, position mode, serving loop, starts
   from ``fleet_starts``): 4 scenarios of a B=16 fleet against their
   unbatched graphed episodes over 20 steps (1e-4); BASELINE.md's K=512
   row, B=16 x K=512 x H=50 over 1500 steps, the reach gate per scenario
   (at least 13 of 16), control steps/s and vehicles at 100 Hz; B=256 x
   K=512 over 100 steps, ms per fleet step, peak memory, busy share;
16. the arm node at its preset (K=100, H=32, A=7): 50 replays of one
   captured arm solve bit-equal to the eager solves; ``run_arm_reach``
   (graphed, 800 steps) on seeds 0-2, MPPI engaged and the commanded EE
   within 0.10 m at its best; ms per control step graphed and eager, no
   host synchronization in the replay loop, the device busy share; a
   checkpoint written at step 400 and restored, the next 10 control steps
   bit-equal to the uninterrupted run;
17. the pick_weight task: ``run_pick_weight`` at K=256, H=50, 700 steps on
   seeds 0-2 with the gates of ``tests/test_cli.py`` (grasped, hold error
   < 0.05 m, lift error < 0.15 m, tilt < 0.1 rad), ``wb_cost`` and
   ``wb_update`` once per control step, ms per control step of each stage
   (seed 0, each stage's capture included);
   at K=4096 the graspable approach (50 steps) and the payload lift on the
   serving configuration (200 steps, rows 1, 3 and 8 once per step), each
   graphed bit-equal to eager; ``wb_cost`` and ``wb_update`` at the task's
   solver (K=256 and 4096, the stand obstacle live on some samples) against
   their plain versions; ``plant_tick`` with the payload's frozen
   coefficients against its plain version at B=1 and B=1024;
18. the multirotor preset (K=1024, H=30, A=4): 20 replays of one captured
   solve bit-equal to eager; tests/test_multirotor_mppi.py's hover (300
   steps, max error < 0.5 m) and ``run_multirotor_waypoint`` (500 steps,
   min < 0.4 m, final < 1.0 m) at the preset; 20 graphed steps bit-equal
   to eager, ms per control step graphed and eager, no host sync in the
   replay loop, device ops per step; ``run_whole_body`` (K=4096, H=50,
   attitude), 80 steps, tests/test_cli.py's gates, rows 1 and 3 launched
   once per step;
19. the fixed-wing flyby at K=1024, H=40: ``run_fixed_wing`` 400 steps
   with tests/test_cli.py's gates (reached, closest < 20 m, altitude > 80
   m, 10 < mean speed < 25 m/s); 20 graphed steps bit-equal to eager; ms
   per control step graphed and eager, device ops per step;
20. mapped flight (lidar, occupancy grid, map-aware MPPI, backstepping):
   ``run_mapped_flight`` at K=512, 3000 steps, sphere and ESDF mode, with
   tests/test_cli.py's gates; the first 100 steps graphed bit-equal to
   eager in both modes (logs, plant, grid, solver state); at K=1024 ms per
   control step graphed and eager, no host sync in the replay loop, device
   ops per step and busy share; ``occupied_centers`` on the card against
   the CPU index for index (more tied voxels than slots); a state saved at
   step 1500 and resumed, bit-equal to the uninterrupted run for 10 steps;
21. F6 and F7, the plain whole-body pipeline (``backend="torch"``) on the
   card at K=4096, H=50 in the configurations the kernels refuse (the
   wrench preset's sequential rollout; the serving preset with zero-mean
   noise and the euler orientation metric): one solve on explicit normals
   against the CPU (2e-4), ``backend="cuda"`` refusing each, 20 graphed
   solves bit-equal to eager, ms and device ops per graphed solve;
22. the rotorcraft flight layer (Lee, PID and backstepping laws, wind,
   ground contact, the mission machine), 1 kHz ticks captured 10 per
   control step: the JAX tests' gates for hover, figure-eight, mission,
   a saved and resumed mission (its first 10 steps bit-equal to the live
   carry's), the waypoint files (the inline one, the default one smooth) and the gust
   recovery; ``run_disturbance`` beside the JAX package's CPU figures; 10
   control steps of each scenario graphed bit-equal to eager; ms per
   control step graphed and eager, device ops per tick, no host sync in
   the replay loop;
23. the solver bridge: (a) ``evaluation/parity.oracle_parity_report`` on
   the card (128 single steps, 1000 near-hover ticks) with the JAX test's
   gates; (b) a ``BridgeServer`` on 127.0.0.1 with a ``WholeBodySession``
   (K=512, H=50, rows 1 and 3) and (c) with a ``SolverSession`` at its
   defaults, each driven by a Python QMM client: 20 requests bit-equal to
   an eager session on the same states, then a teleop nudge and an
   EE_REACH goal and 5 more bit-equal, rows 1 and 3 launched twice at the
   capture and once per request, then both against their plain versions
   at the session's K=512, H=50 on its own Philox key, solve index, warm
   start and a request's observation, the client's round trip (p50, p99
   over 200 requests), one readback per request and no other host sync,
   the head replay's device time; (d) the sim adapter against each session
   for 2 s with tests/test_bridge.py's gate, the solver plant's adapter and
   session built and captured while the whole-body plant runs, 10 graphed
   control periods bit-equal to eager, ms per period (CUDA events and host
   clock), no host sync in the period's replay;
   (e) tests/test_hil.py's two gates on the card, 100 graphed ticks
   bit-equal to eager, ms per tick;
24. the camera stack and the scenario command line, each scenario through
   ``run.main`` as a user runs it: (a) ``camera-survey --steps 400`` with
   tests/test_cli.py's gates (3 frames or more, pointing error tail < 10
   deg, a geotagged 2-D first frame), 10 control steps graphed bit-equal
   to eager, ms per control step, device ops per tick, no host sync in the
   replay loop; (b) the depth camera at 640 x 480 on 8 poses of the
   survey's log in one call against float64 on the CPU (1e-4 relative,
   +inf masks equal off the silhouettes), the Kinect noise on explicit
   normals card against CPU (1e-6), ms per batched render; (c) the survey
   streamed to a live ``BridgeServer``, its last frame read back equal to
   the stored one; (d) ``drone-waypoint`` (300 steps, ``--save-log``, the
   Lee refusal), ``whole-body-full`` (200 steps, rows 1 and 3 once per
   step), its save and resume at K=64, H=12 (30 + 30 against 60, 1e-5),
   ``whole-body-batch`` (4 x K=64, 120 steps) with their gates, rows 1 and
   3 against plain on the resumed run's and the fleet's live states, and
   ``bench-scaling`` on the card; (e) every registered name resolved to
   the port's runner;
25. the offline tools: (a) ``WholeBodyMPPIParams()`` saved in an
   ``ExperimentConfig`` and loaded back: the loaded tree's solve (backend
   cuda) bit-equal to the in-memory tree's; (b) ``collect_whole_body``
   (20 solves at K=4096, H=50, each one replay of a captured solve: rows 1
   and 3 once per solve, plus the capture's 2 warm-up calls) with the JAX
   test's gates, graphed bit-equal to ``graph=False``, the ``.npz`` round
   trip bit-equal, rows 1 and 3 against plain on the collector's last live
   state, ms per collected solve with its readback; (c) ``time_fn`` on the
   collector's graphed step (50 iterations, 3 warm-up) beside phase 4's
   solve, and ``profiling.trace`` around 5 replays: its Chrome trace holds
   5 ``wb_cost`` and 5 ``wb_update`` kernels; (d) the camera survey's log
   written as a ``nav_msgs/Odometry`` bag (one bz2 chunk) and compared with
   its npz by ``evaluation/parity.main`` (1e-6 m); (e) the Kinova URDF of
   ``tests/kinova_urdf.py`` through ``models/urdf``, equal to
   ``kinova.chain()`` and ``kinova.inertials()`` (1e-12), the matrix FK of
   4096 configurations with base poses on the card against the quaternion
   FK and float64 on the CPU (1e-5), ``arm_gravity_wrench`` at B=4096
   against float64 (1e-5);
26. the whole-body callers on the plain pipeline (``backend="torch"``) in
   configurations the kernels refuse, each refused first by the default
   backend with a message naming ``backend="torch"``: (a)
   ``make_packed_step`` at K=4096, H=50, attitude, zero-mean noise, 50
   graphed solves bit-equal to eager, ms per solve graphed and eager,
   device ops per solve; (b) ``WholeBodySession`` in position mode at
   K=4004, H=50 behind a ``BridgeServer`` (requests bit-equal to an eager
   session, 50 round trips p50/p99, one readback per request, the head's
   device ops); (c) ``collect_whole_body`` at (a)'s configuration, 5
   solves graphed = eager, finite; none of the three launches a whole-body
   kernel; (d) the same callers on the default backend launch rows 1 and 3
   once per call plus the capture's 2 warm-up calls, beside the counts of
   phases 4, 23 and 25;
then one ``kernels`` JSON line (rows 4-5 at B=256, rows 6-7 at K_local,
rows 9a-9b at K=1000 and 9c-9d at K=1024: the shapes of the runs that
count their launches; each ``wb_update`` row with the R it used and its
device time over the library call's; rows 1, 2, 4, 9a and 9c with their
layout; rows 1 and 3 with the launches of every later path, phase 25's
as ``dataset_launches``), the ``nvidia-smi`` line and the ``ok`` line.
"""

import contextlib
import dataclasses
import io
import json
import os
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from quadrotor_manipulator_mppi_tpu_torch import config as config_mod
from quadrotor_manipulator_mppi_tpu_torch import run as cli
from quadrotor_manipulator_mppi_tpu_torch import scenarios as registry
from quadrotor_manipulator_mppi_tpu_torch.bridge import action as bridge_action
from quadrotor_manipulator_mppi_tpu_torch.bridge import camera as bridge_camera
from quadrotor_manipulator_mppi_tpu_torch.bridge import hil as hil_mod
from quadrotor_manipulator_mppi_tpu_torch.bridge import mavlink as mav
from quadrotor_manipulator_mppi_tpu_torch.bridge import protocol as proto
from quadrotor_manipulator_mppi_tpu_torch.bridge import server as bridge
from quadrotor_manipulator_mppi_tpu_torch.bridge.sim_adapter import SimAdapter
from quadrotor_manipulator_mppi_tpu_torch.evaluation import dataset as ds
from quadrotor_manipulator_mppi_tpu_torch.evaluation import parity
from quadrotor_manipulator_mppi_tpu_torch.evaluation import rosbag
from quadrotor_manipulator_mppi_tpu_torch.evaluation.metrics import episode_quality
from quadrotor_manipulator_mppi_tpu_torch.models import chain as chain_mod
from quadrotor_manipulator_mppi_tpu_torch.models import fixed_wing as fw_model
from quadrotor_manipulator_mppi_tpu_torch.models import kinova
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import Multirotor12State
from quadrotor_manipulator_mppi_tpu_torch.models import point_mass as pm
from quadrotor_manipulator_mppi_tpu_torch.models import rigid_body as rb
from quadrotor_manipulator_mppi_tpu_torch.models import urdf
from quadrotor_manipulator_mppi_tpu_torch.models.whole_body import arm_gravity_wrench
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import build
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import drone_kernel as dk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import whole_body_kernel as wk
from quadrotor_manipulator_mppi_tpu_torch.parallel import mesh as mesh_mod
from quadrotor_manipulator_mppi_tpu_torch.parallel import multihost, scaling, sharded
from quadrotor_manipulator_mppi_tpu_torch.parallel.multihost import tree_map
from quadrotor_manipulator_mppi_tpu_torch.scenarios import rotorcraft as rc
from quadrotor_manipulator_mppi_tpu_torch.scenarios import solvers as scenarios
from quadrotor_manipulator_mppi_tpu_torch.scenarios.common import hover_plant, tick_episode
from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import run_arm_reach
from quadrotor_manipulator_mppi_tpu_torch.scenarios.whole_body import (
    run_pick_weight, run_whole_body_full,
)
from quadrotor_manipulator_mppi_tpu_torch.sim import arm_loop
from quadrotor_manipulator_mppi_tpu_torch.sim import closed_loop as cl
from quadrotor_manipulator_mppi_tpu_torch.sim import depth_camera as dcam
from quadrotor_manipulator_mppi_tpu_torch.sim import gimbal as gb
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import graspable as gr
from quadrotor_manipulator_mppi_tpu_torch.sim import lee_controller as lee
from quadrotor_manipulator_mppi_tpu_torch.sim import mapped_loop
from quadrotor_manipulator_mppi_tpu_torch.sim import occupancy as occ
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.sim import wind as wind_mod
from quadrotor_manipulator_mppi_tpu_torch.solver import arm, drone, mppi, serving
from quadrotor_manipulator_mppi_tpu_torch.solver import fixed_wing as fws
from quadrotor_manipulator_mppi_tpu_torch.solver import mapped as mapped_solver
from quadrotor_manipulator_mppi_tpu_torch.solver import multirotor_mppi as mm
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb
from quadrotor_manipulator_mppi_tpu_torch.utils import checkpoint, graphs, profiling
from quadrotor_manipulator_mppi_tpu_torch.utils import rotations as rotlib
from quadrotor_manipulator_mppi_tpu_torch.utils import se3
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

# The Kinova URDF that the tests build (tests/kinova_urdf.py; NumPy only).
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from kinova_urdf import LINK_7, ROOT, TIP, kinova_urdf_text  # noqa: E402

K, H, A = 4096, 50, wk.A_TOTAL
N_SERVE = 50
TOL_COST = 1e-4      # max|dS| / max(1, max|S|): recurrence vs operator form
TOL_UPDATE = 1e-5    # max|d du| / max|du|: summation order only
TOL_STEP = 2e-3      # |a - b| <= TOL (1 + |b|): the JAX parity tolerance
TOL_NOISE = 1e-5     # erfinvf vs torch.erfinv on the card
# The stand's obstacle term (S with it less S without), kernel against plain,
# relative to its largest value: each S carries ~2e-6 |S| (phase 2), a few
# 1e-4 of a term of ~30 beside an S of ~1300.
TOL_OBSTACLE = 1e-2

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_OPS_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores

# Arithmetic per sample and horizon step of wb_cost in attitude mode, all
# instructions counted at the float32 rate (a lower bound on time):
# 11 Philox draws (10 rounds x ~10 integer ops) + 11 erfinv and scalings
# (~35), arm double integration and clamp (70), rotor lag + 3 PD axes +
# rpy quaternion + thrust/velocity/position (140), 7-joint FK (~580), cost
# stack (~150).
WB_COST_OPS_PER_SAMPLE_STEP = 11 * 100 + 11 * 35 + 70 + 140 + 580 + 150
# wb_update per noise element: the two weighted accumulations (w e and
# w e^2: two multiplies, two adds); per sample, once: the softmin weight
# (subtract, scale, exp, divide ~20).
WB_UPDATE_OPS_PER_ELEMENT = 4
WB_WEIGHT_OPS_PER_SAMPLE = 20
# wb_cost on explicit noise draws nothing: the same work less the 11
# Philox draws, and it reads the 9.0 MB of noise where the Philox variant
# writes it.
WB_COST_NOISE_OPS_PER_SAMPLE_STEP = WB_COST_OPS_PER_SAMPLE_STEP - 11 * 100
KERNEL_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/whole_body_kernel.cu"
TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/whole_body_kernel.py"
PLANT_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/plant_kernel.cu"
PLANT_TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/plant_kernel.py"

# plant_tick arithmetic per vehicle row and 1 ms substep, counted from the
# kernel body (each +, -, *, /, compare, select, sqrt and libm call counted
# as one float32 operation): gravity direction a0 16; frozen nle (7 rows of
# g_tau.a0 and the 7x7x7 Coriolis contraction) 777; M^-1 rhs, integration
# and joint stops 161; arm moment on the base 18; rotation entries 39; ZYX
# angles 6; errors, integrals, altitude law and thrust 40; two lateral laws
# 44; desired tilt 20; attitude backstepping 73; allocation and rotor lag
# 8 x 17; rotor wrench 8 x 11; drag and torques 27; rigid-body integration
# 58; ground test 1; quaternion update 59.
PLANT_OPS_PER_SUBSTEP = 16 + 777 + 161 + 18 + 39 + 6 + 40 + 44 + 20 + 73 + 136 + 88 + 27 \
    + 58 + 1 + 59
PLANT_FLOATS_PER_ROW = pk.STATE_SIZE + pk.DYN_SIZE + 4 + 7 + pk.STATE_SIZE  # in + out
TOL_PLANT = 1e-4     # max |d state| per field: atan2f vs torch.atan2 on one card
N_EPISODE = 100      # phase 6 control steps
N_REACH = 1000       # phase 7 control steps per seed (10 s of flight)
REACH_SEEDS = (0, 1, 2)
SERVING_LOOP = dict(arm_coeffs_per_control=True, plant_kernel=True)

FLEET_K = 512                  # phase 15: BASELINE.md's batched-serving K=512 row
FLEET_B = 16
FLEET_STEPS = 1500             # 15 s
FLEET_MIN_HELD = 13            # of 16 (the JAX package's record: 15)
FLEET_CHECKED = (0, 5, 10, 15)
FLEET_CHECK_STEPS = 20
TOL_FLEET = 1e-4               # a fleet scenario against its unbatched episode
FLEET_B_TIMED = 256
FLEET_TIMED_STEPS = 100
FLEET_B16_TIMED = 100          # phase 15: B=16 fleet steps timed (replays only)
B_BATCH = 256                  # phase 8: BASELINE.json config 5's 256 scenarios
B_TIMED = (1, 16, B_BATCH)
CHECK_SCENARIOS = (0, 85, 170, 255)
TOL_BATCH = 1e-6     # batched vs unbatched step, relative to max|u|: float order only
TOL_SPILL = 1e-6     # no spill vs spill: the same draws, relative
# wb_update's REGEN variants per noise element: the second Philox draw
# (~100), erfinv and scaling (~35), the accumulations (4); the weight is
# counted per sample (WB_WEIGHT_OPS_PER_SAMPLE).  Every operation is
# counted at the float32 rate, optimistic for Philox's integer multiplies.
WB_REGEN_OPS_PER_ELEMENT = 100 + 35 + WB_UPDATE_OPS_PER_ELEMENT
SHARD_RANKS = 2
N_SHARD_SOLVES = 3
SHARD_TIMEOUT_S = 300

DRONE_SOURCE = "quadrotor_manipulator_mppi_tpu_torch/csrc/drone_kernel.cu"
DRONE_TPU_KERNEL = "quadrotor_manipulator_mppi_tpu/ops/pallas/drone_kernel.py"
DRONE_H, DRONE_A = 32, 3
DRONE_K = 1000                 # the reference preset (K=1000, H=32)
DRONE_NOISE_K = 1024           # the explicit-noise loop of tests/test_pallas_kernel.py
# Phase 11's sweep: the preset, the JAX crossover sweep, and the 20 MB
# noise case of the TPU kernel's notes.
DRONE_SIZES = ((1000, 32), (1024, 32), (4096, 32), (16384, 32), (16384, 100))
# Operations per element (sample, step, action): a Philox draw (~100
# integer operations) with the erfinv normal and its scaling (~35); the
# integration and cost of pass 1 (~10); pass 2's weighted accumulation (2).
DRONE_DRAW_OPS = 100 + 35
DRONE_COST_OPS = 10
DRONE_UPDATE_OPS = 2
TOL_DRONE_STEP = 2e-4          # |a - b| <= TOL (1 + |b|): tests/test_pallas_kernel.py's
N_DRONE_LOOP = 800             # phase 12a: tests/test_solver_golden.py's loop
N_DRONE_NOISE_LOOP = 80        # phase 12b: tests/test_pallas_kernel.py's loop
N_DRONE_EPISODE = 2000         # phase 12c: tests/test_sim.py's waypoint episode
N_DRONE_CHECKED = 100          # phase 12c: steps held bit-equal against the eager loop
N_ARM_SOLVES = 50              # phase 16a: graphed arm solves against eager ones
N_ARM_STEPS = 800              # phase 16b: the arm-reach scenario's preset episode
ARM_SEEDS = (0, 1, 2)
N_ARM_EAGER = 10               # phase 16c: eager arm control steps timed
N_ARM_TIMED = 50               # phase 16c: graphed arm control steps timed (replays only)
N_ARM_UNINTERRUPTED = 410      # phase 16d: the uninterrupted run (steps 400-410 compared)
N_PROFILED = 1                 # phases 6, 12c, 15, 16c, 18-22: control steps in a profiled window
N_ARM_CHECKPOINT, N_ARM_RESUMED = 400, 10  # phase 16d
PICK_SEEDS = (0, 1, 2)         # phase 17a: run_pick_weight at its preset
PICK_K, N_PICK_STEPS = 256, 700
PICK_TIMED_SEED = 0            # phase 17a: the seed whose stages are timed
N_PICK_WIDE = 100              # phase 17b: the graspable approach at K=4096
N_PICK_LIFT = 200              # phase 17b: the payload lift at K=4096, serving loop
B_DRONE = 256                  # phase 12d: the batched drone preset's scenarios
N_MR_SOLVES = 20               # phase 18a: graphed multirotor solves against eager ones
N_MR_HOVER, N_MR_WAYPOINT = 300, 500  # phase 18b: tests/test_multirotor_mppi.py's loops
MR_WAYPOINT = scenarios.MR_TARGET
N_WB_PERFECT = 80              # phase 18d: tests/test_cli.py's whole-body scenario
N_SCENARIO_EAGER = 10          # phases 18-20: eager control steps timed
N_SCENARIO_CHECKED = 20        # phases 18c, 19b: graphed steps held bit-equal to eager
N_FW_STEPS = 400               # phase 19a: tests/test_cli.py's fixed-wing flyby, K=1024
N_FW_TIMED = 20                # phase 19c: graphed control steps timed
MAPPED_K, N_MAPPED_STEPS = 512, 3000  # phase 20a: tests/test_cli.py's mapped flight
N_MAPPED_CHECKED = 100         # phase 20b: graphed steps held bit-equal to eager
MAPPED_SERVING_K = 1024        # phase 20c: the serving shape (run.py's default K)
N_MAPPED_TIMED = 20            # phase 20c: graphed control steps timed
N_MAPPED_SAVE, N_MAPPED_RESUMED = 1500, 10  # phase 20e
N_PLAIN_SOLVES = 20            # phase 21b: graphed plain whole-body solves against eager ones
TOL_PLAIN_CARD = 2e-4          # phase 21a: u_seq card vs CPU, of its largest entry
N_PLAIN_TIMED = 20             # phase 21c: graphed plain solves timed
N_HOVER, N_FIG8, N_MISSION = 400, 1800, 1500  # phase 22a-c: tests/test_cli.py's lengths
N_MISSION_SAVE, N_MISSION_CHECKED = 400, 10   # phase 22d: tests/test_cli.py's resume, 10 checked
N_GUST_STEPS = 800             # phase 22f: tests/test_lee_wind.py's 8,000-tick gust loop
N_DISTURBANCE = 1000           # phase 22g: run_disturbance, beside the JAX package's figures
N_ROTOR_CHECKED = 10           # phase 22h: graphed control steps held bit-equal to eager
N_ROTOR_TIMED = 20             # phase 22i: graphed control steps timed
N_BRIDGE_CHECKED = 20          # phase 23b-c: requests held bit-equal to the eager session
N_BRIDGE_AFTER = 5             # phase 23b-c: requests after the nudge and the goal
N_BRIDGE_RTT = 200             # phase 23b-c: client round trips timed
N_BRIDGE_SYNC = 20             # phase 23b-c: requests under the host-sync check
BRIDGE_SIM_S = 2.0             # phase 23d: tests/test_bridge.py's loop, 200 exchanges
N_SIM_CHECKED = 10             # phase 23d: control periods held bit-equal to eager
N_SIM_TIMED = 10               # phase 23d: control periods timed (replays only)
N_HIL_CLIMB, N_HIL_GROUNDED = 600, 200  # phase 23e: tests/test_hil.py's lengths
N_HIL_CHECKED = 100            # phase 23e: ticks held bit-equal to eager
BRIDGE_TIMEOUT_S = 30.0        # phase 23: every socket wait
EE_GOAL = (0.2, 0.4, 1.6)      # phase 23b-c: the EE_REACH goal's target
N_SURVEY = 400                 # phase 24a: tests/test_cli.py's camera survey
N_SURVEY_CHECKED = 10          # phase 24a: graphed control steps held bit-equal to eager
N_SURVEY_TIMED = 20            # phase 24a: graphed control steps timed
N_RENDER = 8                   # phase 24b: poses of the survey's log rendered at once
RENDER_W, RENDER_H = 640, 480  # phase 24b: the Kinect's frame
TOL_RENDER = 1e-4              # phase 24b: float32 card vs float64 CPU, relative
# Phase 24b's silhouette pixels: |discriminant| / b^2 below SILHOUETTE_REL.
# Near a tangent ray the float32 hit distance's relative error grows as
# ~3e-8 / sqrt(|disc| / b^2): 9.6e-5 was seen on the CPU at 1e-6, 3.8e-5 at 1e-5.
SILHOUETTE_REL = 1e-5
MAX_SILHOUETTE = 512           # phase 24b: silhouette pixels allowed in the 8 frames (of 2.46M)
TOL_DEPTH_NOISE = 1e-6         # phase 24b: the Kinect noise on explicit normals, relative
N_DRONE_CLI = 300              # phase 24d: tests/test_cli.py's drone waypoint
N_WB_FULL = 200                # phase 24d: whole-body-full, SKILL.md's gates
N_RESUME = 30                  # phase 24d: tests/test_cli.py:175, 30 + 30 against 60
RESUME_K, RESUME_H = 64, 12    # phase 24d: its solver
N_WB_BATCH, WB_BATCH_B, WB_BATCH_K = 120, 4, 64  # phase 24d: tests/test_cli.py's batch
TOL_RESUME = 1e-5              # phase 24d: resumed against continuous
# Phase 24e: the phase that drives each registered scenario on the card.
SCENARIO_PHASES = {"arm-reach": "16", "pick-weight": "17", "multirotor-waypoint": "18",
                   "whole-body": "18", "fixed-wing": "19", "mapped-flight": "20",
                   "hover": "22", "figure-eight": "22", "mission": "22", "waypoint-file": "22",
                   "disturbance": "22", "camera-survey": "24", "drone-waypoint": "24",
                   "whole-body-full": "24", "whole-body-batch": "24", "bench-scaling": "24"}
# tests/test_cli.py's inline waypoint file (tests/test_cli.py:115-119).
CLI_WAYPOINTS = "3.0 0.0 0.0 2.0 0.0\n4.0 1.5 1.5 2.5 60.0\n4.0 0.0 1.5 2.0 0.0\n"
# The JAX package's run_disturbance on the same length, on the CPU (its own
# command line: python -m quadrotor_manipulator_mppi_tpu.run disturbance
# --steps 1000 --seed 0 --platform cpu); the turbulence streams differ.
JAX_DISTURBANCE = {"pos_rms_m": 0.0011, "ang_rate_rms": 0.0011, "passed": True,
                   "peak_err_m": 0.0085, "peak_time_s": 3.11, "recovery_time_s": 0.0,
                   "final_err_m": 0.0009}
N_DRONE_BATCH_STEPS = 3
N_ARM_SHARD_SOLVES = 3         # phase 10: sharded arm solves (2 x K/2) against the one-rank solve
N_FLIGHT_SHARD_SOLVES = 3      # phase 10: sharded flight-preset solves against the one-rank solve
FLIGHT_SHARD_SCENARIOS = 2     # phase 10: the flight presets' scenario batch
TOL_FLIGHT_SHARD = 1e-5        # phase 10: of the plan's largest entry (summation order only)
SESSION_TORCH_K = 4004         # phase 26b: a sample count the kernels refuse (4004 % 16 = 4)
N_SESSION_TORCH_RTT = 50       # phase 26b: client round trips timed
N_COLLECT_TORCH = 5            # phase 26c: collected solves on the plain pipeline
N_DEFAULT_CALLS = 5            # phase 26d: calls of each default-backend caller
N_COLLECT = 20                 # phase 25b: collect_whole_body's solves at K=4096, H=50
COLLECT_WARMUP = 2             # phase 25b: the capture's warm-up calls (utils/graphs.GraphedStep)
N_TIME_FN, N_TIME_FN_WARMUP = 50, 3  # phase 25c: time_fn on the collector's graphed step
N_TRACED = 5                   # phase 25c: graphed collector solves inside profiling.trace
TOL_BAG = 1e-6                 # phase 25d: parity compare of a run's bag against its npz log, m
TOL_URDF = 1e-12               # phase 25e: the loaded ChainSpec / inertials against kinova's
N_FK = 4096                    # phase 25e: joint configurations through the matrix FK
TOL_FK = 1e-5                  # phase 25e: matrix FK against pos-quat FK and float64 CPU
TOL_WRENCH = 1e-5              # phase 25e: arm_gravity_wrench against float64, of its largest
# The instantiation each drone wrapper launches, as the profiler names it.
DRONE_KEYS = {"drone_cost": "drone_cost_kernel<true>", "drone_update": "drone_update_kernel<true>",
              "drone_cost_noise": "drone_cost_kernel<false>",
              "drone_update_noise": "drone_update_kernel<false>"}
DRONE_REPLACES = {"drone_cost": "99 _cost_kernel (call :216)",
                  "drone_update": "115 _update_kernel (call :249)",
                  "drone_cost_noise": "130 _cost_kernel_noise (call :230)",
                  "drone_update_noise": "140 _update_kernel_noise (call :258)"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def sync() -> None:
    torch.cuda.synchronize()


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` (``fn`` launches it once), from the profiler: where a kernel
    is shorter than its wrapper's host work, ``event_ms`` times the wrapper
    calls instead.  Averaged over the launches the profiler recorded, which
    may be fewer than ``reps``.  None (not measured) when it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / n / 1e3 if n else None


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call of ``fn`` with the host out of the way: ``reps``
    calls captured in one CUDA graph, its replay timed with CUDA events
    (median of 5 replays).  Unlike ``device_ms`` it never loses launches;
    unlike ``event_ms`` it does not time the host's enqueue of small
    kernels."""
    fn()
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def launch_floor_ms() -> float:
    """The CUDA-graph replay time of an empty kernel (``torch.cuda._sleep``
    of 0 cycles): what any one launch costs on this card, beside a bound."""
    return graph_ms(lambda: torch.cuda._sleep(0))


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def timed_once(fn):
    """(result, device ms) of one call of ``fn``, from CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sync()
    start.record()
    out = fn()
    end.record()
    sync()
    return out, start.elapsed_time(end)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a synchronize."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def presets():
    return {"attitude": wb.WholeBodyMPPIParams(),
            "position": wb.position_mode_params(),
            "wrench": wb.wrench_mode_params()}


def phase_build(dev) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    names = ("whole_body_kernel", "plant_kernel", "drone_kernel")
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.build, names))
    for name in names:
        build.load_library(name)
    print(f"[1] device {torch.cuda.get_device_name(dev)} | {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("whole_body_kernel", "drone_kernel"):
        print_ptxas(name)
    return smi


def print_ptxas(name: str) -> None:
    for line in build.build_report(name).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"    ptxas: {line.strip()}")


def inputs(params, dev, gen):
    """Scalar pack, warm start and explicit noise of one solve."""
    cfg = params.mppi
    step, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
    state = init(0)
    obs = wb.default_obs(device=dev)
    sigma = state.sigma
    if cfg.sigma_scale_fn is not None:
        sigma = sigma * cfg.sigma_scale_fn(obs)
    z = torch.randn((K, H, A), generator=gen, device=dev)
    eps = (z * sigma).permute(2, 1, 0).contiguous()
    return state, obs, z, wk.pack_scalars(obs, sigma), eps


def phase_kernels(dev, errs) -> None:
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    for mode, params in presets().items():
        kc = wk.make_kernel_config(params)
        state, obs, z, sc, eps = inputs(params, dev, gen)
        u_prev = state.u_prev.contiguous()
        s_k, m_k, e_k, _ = wk.wb_cost(kc, sc, u_prev, eps)
        s_p, _, _, _ = wk.wb_cost_plain(kc, sc, u_prev, eps)
        sync()
        abs_s = (s_k - s_p).abs().max().item()
        rel_s = abs_s / max(1.0, s_p.abs().max().item())
        du_k, m2_k = wk.wb_update(kc, eps, s_k, m_k, e_k)
        du_p, m2_p = wk.wb_update_plain(kc, eps, s_k, m_k, e_k)
        sync()
        abs_du = max((du_k - du_p).abs().max().item(), (m2_k - m2_p).abs().max().item())
        rel_du = max((du_k - du_p).abs().max().item() / du_p.abs().max().item(),
                     (m2_k - m2_p).abs().max().item() / m2_p.abs().max().item())

        step_k = wk.make_whole_body_cuda_step(params, dev)
        step_p = mppi.make_step(params.mppi, *wb.rollout_cost_fns(params))
        u_k, st_k = step_k(state, obs, z)
        u_p, st_p = step_p(state, obs, z)
        sync()
        step_err = max(((a - b).abs() / (1.0 + b.abs())).max().item() for a, b in
                       ((u_k, u_p), (st_k.u_prev, st_p.u_prev), (st_k.sigma, st_p.sigma)))
        print(f"[2] {mode:8s} wb_cost max|dS| {abs_s:.3e} (rel {rel_s:.2e}, S in "
              f"[{s_p.min().item():.1f}, {s_p.max().item():.1f}]) | wb_update rel {rel_du:.2e} "
              f"| full step {step_err:.2e}", flush=True)
        if not (rel_s <= TOL_COST and rel_du <= TOL_UPDATE and step_err <= TOL_STEP):
            fail(f"{mode}: kernel disagrees with its plain version")
        errs["wb_cost"] = max(errs["wb_cost"], abs_s)
        errs["wb_update"] = max(errs["wb_update"], abs_du)


def phase_philox(dev) -> None:
    params = wb.WholeBodyMPPIParams()
    kc = wk.make_kernel_config(params)
    state, obs, _, sc, _ = inputs(params, dev, torch.Generator(device=dev))
    seed, step = 0x5EED_0123_4567_89AB, 17
    _, _, _, eps = wk.wb_cost(kc, sc, state.u_prev.contiguous(), None,
                              wk.philox_keys(seed, dev), step)
    sigma = sc[wk.SC_SIGMA:wk.SC_SIGMA + A].view(A, 1, 1)
    z_k = eps / sigma
    z_p = sampling.philox_normals(seed, step, K, H, A, dev)
    sync()
    err = (z_k - z_p).abs().max().item()
    print(f"[3] philox spill vs plain max|dz| {err:.2e} | z mean {z_k.mean().item():+.5f} "
          f"std {z_k.std().item():.5f} max|z| {z_k.abs().max().item():.3f}", flush=True)
    if not err <= TOL_NOISE:
        fail("Philox spill disagrees with the plain Philox stream")


def serve_solves(pstep, pinit, obs_vec, target_vec, n: int, seed: int = 0):
    """(the n replies, the final carry's warm start) of ``n`` packed solves
    from ``pinit(seed)``; each reply is the caller's copy."""
    carry, outs = pinit(seed), []
    for _ in range(n):
        out, carry = pstep(carry, obs_vec, target_vec)
        outs.append(out)
    return outs, carry.u_prev.clone()


def solve_blocks(pstep, carry, obs_vec, target_vec, outs=None):
    """Median host ms per solve over N_SERVE solves in blocks of 10, each
    block ending in a synchronize; the final carry."""
    block_ms = []
    for _ in range(N_SERVE // 10):
        t0 = time.perf_counter()
        for _ in range(10):
            out, carry = pstep(carry, obs_vec, target_vec)
            if outs is not None:
                outs.append(out)
        sync()
        block_ms.append((time.perf_counter() - t0) * 1e3 / 10)
    return statistics.median(block_ms), carry


def phase_serving(dev):
    """The packed serving solve as a CUDA graph (one replay per solve)
    against the eager call (``graph=False``): bit-equal replies and warm
    starts over N_SERVE solves from one seed, launches counted per replay,
    host ms per solve of both, then the bridge head graphed against eager."""
    params = wb.WholeBodyMPPIParams()
    pstep, pinit = serving.make_packed_step(params, device=dev)
    pstep_e, pinit_e = serving.make_packed_step(params, device=dev, graph=False)
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    serve_solves(pstep, pinit, obs_vec, target_vec, 3)  # capture (warm-up launches count)
    serve_solves(pstep_e, pinit_e, obs_vec, target_vec, 3)  # warm up (allocator, library load)
    sync()
    torch.cuda.reset_peak_memory_stats(dev)

    reset_counts()
    outs = []
    solve_ms, carry = solve_blocks(pstep, pinit(0), obs_vec, target_vec, outs)
    launches = {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches}
    peak_mib = torch.cuda.max_memory_allocated(dev) / 2**20
    finite = all(bool(torch.isfinite(o).all()) for o in outs) and bool(
        torch.isfinite(carry.u_prev).all())
    eager_outs, eager_u = serve_solves(pstep_e, pinit_e, obs_vec, target_vec, N_SERVE)
    sync()
    equal = all(torch.equal(a, b) for a, b in zip(outs, eager_outs)) and torch.equal(
        carry.u_prev, eager_u)
    worst = max((a - b).abs().max().item() for a, b in zip(outs, eager_outs))
    eager_ms, _ = solve_blocks(pstep_e, pinit_e(0), obs_vec, target_vec)
    print(f"[4] serving {N_SERVE} solves, CUDA graph: launches {launches} | finite {finite} | "
          f"bit-equal to the eager call over {N_SERVE} solves {equal} (max|d| {worst:.2e}) | "
          f"{solve_ms:.3f} ms/solve graphed, {eager_ms:.3f} eager (host, median of "
          f"{N_SERVE // 10} blocks of 10) | peak {peak_mib:.1f} MiB", flush=True)
    if launches != {"wb_cost": N_SERVE, "wb_update": N_SERVE} or not finite:
        fail("serving path did not run through both kernels with finite output")
    if not equal:
        fail("the graphed serving solve is not bit-equal to the eager one")
    if not solve_ms < 10.0:
        fail(f"the graphed serving solve takes {solve_ms:.3f} ms on the host, not under 10")

    bstep, bpinit = serving.make_bridge_step(device=dev)
    bstep_e, bpinit_e = serving.make_bridge_step(device=dev, graph=False)
    replies = [serve_solves(f, init, obs_vec, target_vec, 20)
               for f, init in ((bstep, bpinit), (bstep_e, bpinit_e))]
    sync()
    b_equal = all(torch.equal(a, b) for a, b in zip(replies[0][0], replies[1][0])) and \
        torch.equal(replies[0][1], replies[1][1])
    b_ms = {name: solve_blocks(f, init(0), obs_vec, target_vec)[0]
            for name, f, init in (("graphed", bstep, bpinit), ("eager", bstep_e, bpinit_e))}
    print(f"[4] bridge head (K=512, H=50, position): graphed bit-equal to eager over 20 solves "
          f"{b_equal} | {b_ms['graphed']:.3f} ms/solve graphed, {b_ms['eager']:.3f} eager",
          flush=True)
    if not b_equal:
        fail("the graphed bridge head is not bit-equal to the eager one")
    return launches, {"graphed": solve_ms, "eager": eager_ms, "bridge": b_ms}, (
        (pstep, carry, obs_vec, target_vec), (pstep_e, pinit_e(0), obs_vec, target_vec))


# The device symbol of each kernel family and the wrappers that launch it:
# profile_solves holds the wrappers' launch counters (on a graphed path,
# the launches the capture recorded, added per replay) against the kernels
# the device ran.
KERNEL_FAMILIES = {
    "wb_cost_kernel<": (wk.wb_cost, wk.wb_cost_nospill),
    "wb_update_kernel<": (wk.wb_update, wk.wb_update_regen, wk.wb_update_shard,
                          wk.wb_update_shard_regen),
    "plant_tick_kernel": (pk.plant_tick,),
    "drone_cost_kernel<": (dk.drone_cost, dk.drone_cost_noise),
    "drone_update_kernel<": (dk.drone_update, dk.drone_update_noise),
}


def family_counts() -> dict:
    return {sym: sum(w.launches for w in ws) for sym, ws in KERNEL_FAMILIES.items()}


def profile_solves(tag: str, fn, n: int, solve_ms: float, unit: str = "solve",
                   check_counts: bool = False):
    """Where a solve's (or a control step's: ``unit``) device time goes:
    CUDA-side profiler events of ``n`` calls of ``fn`` (after one call the
    profiler's schedule traces and drops, so that tracing has started),
    their busy share of the profiled wall time, their ratio to the
    unprofiled time per call ``solve_ms``, and the device ops that take the
    most time.  The ratio is not a share: where a call is device-bound the
    traced kernels can take longer than the whole unprofiled call, and it
    passes 1.  With ``check_counts`` the kernels of each family that the
    device ran must equal the launches the wrappers' counters added, and
    the profiler must have seen them.  Returns (device us per call, device
    time over the unprofiled call, device ops per call, busy share of the
    profiled wall), or None when the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        fn()
        sync()
        prof.step()
        host0 = family_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
        host = {k: v - host0[k] for k, v in family_counts().items()}
        prof.step()
    # The profiler's steps also appear on the device timeline as annotations.
    ops = [e for e in (traced[0] if traced else [])
           if e.device_type == DeviceType.CUDA and not e.key.startswith("ProfilerStep")]
    dev_us = sum(e.self_device_time_total for e in ops)
    launches = sum(e.count for e in ops)
    if check_counts:
        device = {sym: sum(e.count for e in ops if sym in e.key) for sym in KERNEL_FAMILIES}
        ran = {k: v for k, v in host.items() if v or device[k]}
        print(f"{tag} kernels over {n} x {unit}: counted by the wrappers "
              f"{ran}, run on the device {({k: device[k] for k in ran})}", flush=True)
        if not dev_us:
            fail(f"{tag}: the profiler saw no device work; the launch counts are unchecked")
        if any(host[k] != device[k] for k in ran) or not ran:
            fail(f"{tag}: the launch counters disagree with the kernels the device ran")
    if not dev_us:
        print(f"{tag} profiler: device time not measured (no CUDA events)", flush=True)
        return None
    ratio = dev_us / n / (solve_ms * 1e3)
    print(f"{tag} profiler: device busy {dev_us / n:.1f} us/{unit}; busy share "
          f"{dev_us / wall_us:.3f} of the profiled wall ({wall_us / n:.1f} us/{unit}); device "
          f"time {ratio:.3f} x the unprofiled {unit} (above 1: the traced kernels outlast the "
          f"whole unprofiled {unit}); {launches / n:.0f} device ops/{unit}", flush=True)
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n:8.1f} us/{unit} {e.count / n:6.1f} ops/{unit}  "
              f"{e.key[:90]}")
    return dev_us / n, ratio, launches / n, dev_us / wall_us


def phase_profile(serve, solve_ms: dict) -> dict:
    """Profiles of 10 graphed and 10 eager serving solves."""
    out = {}
    for (pstep, carry, obs_vec, target_vec), name in zip(serve, ("graphed", "eager")):
        box = [carry]

        def one():
            _, box[0] = pstep(box[0], obs_vec, target_vec)

        out[name] = profile_solves(f"[4] {name}", one, 5, solve_ms[name], check_counts=True)
    return out


def phase_timing(dev):
    params = wb.WholeBodyMPPIParams()
    kc = wk.make_kernel_config(params)
    state, obs, z, sc, _ = inputs(params, dev, torch.Generator(device=dev))
    u_prev = state.u_prev.contiguous()
    keys = wk.philox_keys(1, dev)
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, keys, 0)
    rho = m.min()
    w = torch.exp((rho - s) * kc.inv_lam) / torch.sum(e * torch.exp((rho - m) * kc.inv_lam))
    flat = eps.view(A * H, K)

    eps_in = eps.clone()
    t = {
        "wb_cost": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, keys, 0)),
        "wb_cost_graph": graph_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, keys, 0)),
        "wb_cost_device": device_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, keys, 0),
                                    cost_key(1)),
        "wb_cost_plain": event_ms(lambda: wk.wb_cost_plain(kc, sc, u_prev, None, keys, 0),
                                  reps=5),
        "wb_cost_noise": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, eps_in)),
        "wb_cost_noise_graph": graph_ms(lambda: wk.wb_cost(kc, sc, u_prev, eps_in)),
        "wb_cost_noise_device": device_ms(lambda: wk.wb_cost(kc, sc, u_prev, eps_in),
                                          cost_key(0)),
        "wb_cost_noise_plain": event_ms(lambda: wk.wb_cost_plain(kc, sc, u_prev, eps_in),
                                        reps=5),
        "wb_update": event_ms(lambda: wk.wb_update(kc, eps, s, m, e)),
        "wb_update_plain": event_ms(lambda: wk.wb_update_plain(kc, eps, s, m, e)),
        "library_mv": event_ms(lambda: torch.mv(flat, w)),
    }
    step_p = mppi.make_step(params.mppi, *wb.rollout_cost_fns(params))
    step_k = wk.make_whole_body_cuda_step(params, dev)
    t["plain_step"] = host_ms(lambda: step_p(state, obs))
    t["kernel_step"] = host_ms(lambda: step_k(state, obs))
    print(f"[4] timings (ms): "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in t.items()), flush=True)

    noise_bytes = A * H * K * 4
    cost_bytes = (wk.SC_LEN + H * A + K + 2 * kc.n_blocks) * 4 + noise_bytes
    cost_ops = K * H * WB_COST_OPS_PER_SAMPLE_STEP
    bounds = {}
    noise_ops = K * H * WB_COST_NOISE_OPS_PER_SAMPLE_STEP
    for name, nbytes, ops in (("wb_cost", cost_bytes, cost_ops),
                              ("wb_cost_noise", cost_bytes, noise_ops),
                              ("wb_update", *new_work(K)["wb_update"])):
        bounds[name] = bound(nbytes, ops)
    return t, bounds


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for moving ``nbytes`` and doing
    ``ops`` float32 operations on the H100 SXM."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def plant_config(params):
    m = params.model
    return pk.make_plant_config(m.vehicle, fc.FlightGains(), m.chain(),
                                extra_mass=m.arm_mass_lump)


def perturbed_row(params, dev):
    """One plant row away from equilibrium (tilt, rates, joint motion,
    controller integrals), with its frozen coefficients, a command and an
    arm torque."""
    m = params.model
    plant = wbl.init_plant(m.vehicle, device=dev)
    quat = torch.tensor([0.998, 0.03, -0.04, 0.02], device=dev)
    base = plant.base._replace(
        pos=torch.tensor([0.12, -0.2, 2.05], device=dev), quat=quat / quat.norm(),
        vel=torch.tensor([0.15, -0.1, 0.05], device=dev),
        omega=torch.tensor([0.05, -0.08, 0.02], device=dev))
    ctrl = plant.ctrl._replace(int_err=torch.tensor([0.01, -0.02, 0.005], device=dev),
                               prev_err=torch.tensor([0.02, 0.01, -0.01], device=dev))
    plant = plant._replace(base=base, qdot=torch.full((7,), 0.15, device=dev), ctrl=ctrl)
    dyn = pk.pack_dyn(rb.frozen_arm_coeffs(m.chain(), m.inertials(), plant.q))
    cmd = torch.tensor([0.1, -0.15, 2.1, 0.05], device=dev)
    tau = torch.tensor([1.0, -2.0, 0.5, 3.0, -0.2, 0.1, 0.05], device=dev)
    return pk.pack_plant(plant)[None].contiguous(), dyn[None], cmd[None], tau[None]


PLANT_FIELDS = (("pos", 0, 3), ("quat", 3, 7), ("vel", 7, 10), ("omega", 10, 13),
                ("rotor", 13, 21), ("q", 21, 28), ("qdot", 28, 35), ("int_err", 35, 38),
                ("prev_err", 38, 41), ("m_hat", 41, 44), ("n_hat", 44, 46))


def phase_plant(dev, errs):
    """The plant tick against its plain version at B=1 and B=1024, then
    its timings at both sizes."""
    params = wb.position_mode_params()
    pc = plant_config(params)
    m = params.model
    cases = {1: perturbed_row(params, dev),
             1024: pk.sample_rows(m.vehicle, m.chain(), m.inertials(), 1024, seed=0, device=dev)}
    for rows, args in cases.items():
        got = pk.plant_tick(pc, *args)
        again = pk.plant_tick(pc, *args)
        want = pk.plant_tick_plain(pc, *args)
        sync()
        diff = (got - want).abs().max(dim=0).values
        per_field = {name: diff[a:b].max().item() for name, a, b in PLANT_FIELDS}
        worst = max(per_field.values())
        alone = all(torch.equal(pk.plant_tick(pc, *(x[b] for x in args)), got[b])
                    for b in sorted({0, rows // 3, rows - 1}))
        print(f"[5] plant_tick B={rows} max|d| per field: "
              + ", ".join(f"{k} {v:.2e}" for k, v in per_field.items())
              + f" | rerun bit-equal {torch.equal(got, again)} | rows equal their one-row "
              f"launches {alone}", flush=True)
        if not (worst <= TOL_PLANT and bool(torch.isfinite(got).all())):
            fail(f"plant_tick disagrees with its plain version at B={rows}")
        if not (torch.equal(got, again) and alone):
            fail(f"plant_tick is not deterministic per row at B={rows}")
        errs["plant_tick"] = max(errs["plant_tick"], worst)
    t = {"plant_tick": event_ms(lambda: pk.plant_tick(pc, *cases[1]), reps=200),
         "plant_tick_graph": graph_ms(lambda: pk.plant_tick(pc, *cases[1])),
         "plant_tick_plain": event_ms(lambda: pk.plant_tick_plain(pc, *cases[1]), reps=5),
         "plant_tick_b1024": event_ms(lambda: pk.plant_tick(pc, *cases[1024]), reps=200),
         "plant_tick_b1024_graph": graph_ms(lambda: pk.plant_tick(pc, *cases[1024])),
         "plant_tick_plain_b1024": event_ms(lambda: pk.plant_tick_plain(pc, *cases[1024]),
                                            reps=5),
         "launch_floor": launch_floor_ms()}
    ops = pc.substeps * PLANT_OPS_PER_SUBSTEP
    b1 = bound(PLANT_FLOATS_PER_ROW * 4, ops)
    b1024 = bound(1024 * PLANT_FLOATS_PER_ROW * 4, 1024 * ops)
    print(f"[5] plant_tick timings (ms, events / graph): B=1 {t['plant_tick']:.4f} / "
          f"{t['plant_tick_graph']:.4f} (plain {t['plant_tick_plain']:.3f}, bound {b1[0]:.2e} "
          f"by {b1[1]}) | B=1024 {t['plant_tick_b1024']:.4f} / {t['plant_tick_b1024_graph']:.4f}"
          f" = {t['plant_tick_b1024_graph'] / 1024 * 1e3:.4f} us/row (plain "
          f"{t['plant_tick_plain_b1024']:.3f}, bound {b1024[0]:.2e} by {b1024[1]}) | launch "
          f"floor {t['launch_floor']:.4f} | {ops} ops/row", flush=True)
    print_ptxas("plant_kernel")
    return t, b1, b1024


def serving_episode(params, dev, n_steps, loop=SERVING_LOOP, graph=True):
    """(run, start): ``run(*start(seed))`` is one episode of ``n_steps``
    control steps from the hover start (the serving loop by default)."""
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**loop),
                                      n_control_steps=n_steps, device=dev, graph=graph)
    _, init = wb.make_whole_body_solver(params, device=dev)
    obs = wb.default_obs(device=dev)

    def start(seed):
        return (wbl.init_plant(params.model.vehicle, device=dev), init(seed), obs.ee_target,
                obs.base_target)

    return run, start


def episodes_equal(a, b) -> tuple:
    """(bit-equal, max |d|) of two episodes' logs and final plants."""
    (fa, la), (fb, lb) = a, b
    pairs = list(zip(la, lb)) + list(zip(pk.pack_plant(fa[0]), pk.pack_plant(fb[0])))
    return (all(torch.equal(x, y) for x, y in pairs),
            max((x - y).abs().max().item() for x, y in pairs))


def count_episode_launches() -> dict:
    return {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches,
            "plant_tick": pk.plant_tick.launches}


def timed_episode(run, args, n_steps) -> tuple:
    """(episode, host ms per control step) of ``run(*args)``."""
    sync()
    t0 = time.perf_counter()
    out = run(*args)
    sync()
    return out, (time.perf_counter() - t0) * 1e3 / n_steps


def phase_episode(dev):
    """100 control steps of the serving episode replaying one captured
    control step per step, against the eager loop (``graph=False``) from
    the same start: logs and final plant bit-equal, launches counted per
    replay, no host synchronization in the replay loop, host ms per step
    and device busy share of both."""
    params = wb.position_mode_params()
    run, start = serving_episode(params, dev, N_EPISODE)
    run_e, _ = serving_episode(params, dev, N_EPISODE, graph=False)
    run(*start(0))  # capture (warm-up launches count), then a first full run
    warm_e, warm_start = serving_episode(params, dev, 5, graph=False)
    warm_e(*warm_start(0))  # warm up (allocator, library loads)
    reset_counts()
    pk.plant_tick.launches = 0
    graphed, step_ms = timed_episode(run, start(0), N_EPISODE)
    launches = count_episode_launches()
    finite = all(bool(torch.isfinite(f).all()) for f in graphed[1])
    eager, eager_ms = timed_episode(run_e, start(0), N_EPISODE)
    equal, worst = episodes_equal(graphed, eager)
    print(f"[6] serving episode {N_EPISODE} control steps (K={K}, H={H}, position mode, "
          f"plant kernel), CUDA graph of one control step: {step_ms:.3f} ms/control step "
          f"graphed, {eager_ms:.3f} eager | launches {launches} | finite logs {finite} | "
          f"logs and final plant bit-equal to the eager loop {equal} (max|d| {worst:.2e}) | "
          f"final l1_cmd {graphed[1].l1_cmd[-1].item() * 1e3:.2f} mm", flush=True)
    if launches != {"wb_cost": N_EPISODE, "wb_update": N_EPISODE, "plant_tick": N_EPISODE} \
            or not finite:
        fail("serving episode did not run through all three kernels with finite logs")
    if not equal:
        fail("the graphed serving episode is not bit-equal to the eager loop")

    args = start(2)
    check_no_syncs("[6]", f"the replay loop of {N_EPISODE} control steps", lambda: run(*args))

    n_prof = N_PROFILED
    window, window_start = serving_episode(params, dev, n_prof)
    window_e, _ = serving_episode(params, dev, n_prof, graph=False)
    window(*window_start(1))  # capture
    busy = {}
    for name, fn, ms in (("graphed", window, step_ms), ("eager", window_e, eager_ms)):
        args = window_start(1)
        busy[name] = profile_solves(f"[6] {name}", lambda: fn(*args), 1, ms * n_prof,
                                    unit=f"{n_prof} control steps", check_counts=True)
    eager_parts(dev, window_e, window_start, n_prof)
    return launches, {"graphed": step_ms, "eager": eager_ms}, busy


def eager_parts(dev, window, window_start, n_prof) -> None:
    """Host time per part of the eager control step: the ranges its
    wb_loop.* stage marks open under a profiler while a tracer is
    installed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = window_start(1)
    sync()
    with profiling.tracing(dev) as tracer, profile(activities=[ProfilerActivity.CPU]) as prof:
        window(*args)
        sync()
        tracer.close_ranges()
    parts = sorted((e for e in prof.key_averages()
                    if e.key.startswith("wb_loop.") and e.device_type == DeviceType.CPU),
                   key=lambda e: -e.cpu_time_total)
    print("[6] eager host time per part (profiled, us/control step): " + ", ".join(
        f"{e.key[8:]} {e.cpu_time_total / n_prof:.0f}" for e in parts), flush=True)


def sync_sites(fn) -> list:
    """The ``file:line`` of every host synchronization while ``fn`` runs
    (each synchronizing CUDA call shows up as a warning)."""
    import warnings

    sync()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing" in str(w.message)]


def check_no_syncs(tag: str, what: str, fn) -> None:
    """No host synchronization inside a loop: any synchronizing CUDA call
    while ``fn`` runs fails the phase."""
    syncs = sync_sites(fn)
    print(f"{tag} host synchronizations in {what}: {len(syncs)}", flush=True)
    if syncs:
        for where in sorted(set(syncs)):
            print(f"    {syncs.count(where)} x {where}")
        fail("the loop synchronizes the host with the card")


def synced_run(tag: str, what: str, run, args, n_steps: int) -> tuple:
    """(``run(*args)``, host ms per step) with ``check_no_syncs`` watching
    the run; the clock stops at a synchronize after it."""
    box = []
    t0 = time.perf_counter()
    check_no_syncs(tag, what, lambda: box.append(run(*args)))
    sync()
    return box[0], (time.perf_counter() - t0) * 1e3 / n_steps


def reach_quality(tag: str, logs, tail_n: int, base_target=None) -> dict:
    """``episode_quality`` of one episode's logs, printed; with
    ``base_target`` also the base's largest distance from it, over the
    episode and over its last ``tail_n`` steps."""
    q = episode_quality(logs.l1_cmd.cpu().numpy(), logs.l1_meas.cpu().numpy(), tail_n=tail_n)
    exc = ""
    if base_target is not None:
        d = torch.linalg.norm(logs.base_pos - base_target, dim=-1)
        q["base_exc_max_m"] = d.max().item()
        q["base_exc_tail_max_m"] = d[-tail_n:].max().item()
        exc = (f" | base excursion max {q['base_exc_max_m']:.3f} m, tail max "
               f"{q['base_exc_tail_max_m']:.3f} m")
    print(f"{tag}: converged step {q['converged_step']} | held "
          f"{q['held_fraction_after_converge']:.3f} after | first reach "
          f"{q['reach_gate_first_step']} | l1_cmd tail max {q['l1_cmd_tail_max_mm']:.2f} mm "
          f"(mean {q['l1_cmd_tail_mean_mm']:.2f}) | l1_meas tail max "
          f"{q['l1_meas_tail_max_mm']:.2f} mm (mean {q['l1_meas_tail_mean_mm']:.2f})" + exc,
          flush=True)
    return q


def gate_met(q: dict) -> bool:
    return q["converged_step"] >= 0 and q["held_fraction_after_converge"] >= 0.99


# Phase 7's modes: (preset, loop configuration).  Position runs the serving
# loop; attitude and wrench the default loop, the per-substep RNEA plant,
# as the JAX package's parity runs (BASELINE.md, "Control parity").
REACH_MODES = {"position": (wb.position_mode_params, SERVING_LOOP),
               "attitude": (wb.WholeBodyMPPIParams, {}),
               "wrench": (wb.wrench_mode_params, {})}


def phase_reach(dev, modes=tuple(REACH_MODES), seeds=REACH_SEEDS, summary=None) -> dict:
    """The reach gate on the card, graphed episodes: converge (L1 of the
    commanded EE < 5 mm held 50 steps) and hold >= 99% of the steps after,
    for every seed, in the modes of REACH_MODES at K=4096, H=50.  Returns
    the host ms per control step of each mode and the per-seed metrics.
    ``summary`` (the card's ``nvidia-smi`` line): print them all as one
    JSON line before the gate is judged."""
    results, ms = {}, {}
    base_target = wb.default_obs(device=dev).base_target
    for mode in modes:
        make, loop = REACH_MODES[mode]
        run, start = serving_episode(make(), dev, N_REACH, loop)
        t0 = time.perf_counter()
        for seed in seeds:
            _, logs = run(*start(seed))
            results[(mode, seed)] = reach_quality(f"[7] {mode} reach seed {seed}", logs, 300,
                                                  base_target)
        ms[mode] = (time.perf_counter() - t0) * 1e3 / (N_REACH * len(seeds))
        print(f"[7] {mode}: {ms[mode]:.3f} ms/control step over {len(seeds)} x "
              f"{N_REACH} steps (graphed, capture included)", flush=True)
    bad = [key for key, q in results.items() if not gate_met(q)]
    if summary is not None:
        print(json.dumps({"k": K, "h": H, "steps": N_REACH, "nvidia_smi": summary,
                          "ms_per_control_step": ms, "missed": [list(b) for b in bad],
                          "per_seed": {f"{m} {s}": q for (m, s), q in results.items()}}))
    if bad:
        fail(f"reach gate not met (converged and held >= 0.99) for {bad}")
    return ms, results


def fleet_run(params, dev, n_scenarios: int, n_steps: int, seed: int = 0):
    run = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**SERVING_LOOP),
                                      n_control_steps=n_steps, device=dev,
                                      n_scenarios=n_scenarios)
    return run, wbl.fleet_starts(params, n_scenarios, seed=seed, device=dev)


def phase_fleet(dev) -> dict:
    """The fleet episode: B vehicles in one graphed control step
    (``make_whole_body_episode(n_scenarios=B)``), position mode, serving
    loop.  (a) FLEET_CHECKED scenarios of a B=16 fleet against their own
    unbatched graphed episodes over 20 steps; (b) BASELINE.md's K=512 row:
    B=16, K=512, H=50, 1500 steps, the reach gate per scenario; (c) B=256,
    K=512, 100 steps, timing only."""
    params = wb.position_mode_params(n_samples=FLEET_K, n_horizon=H)
    run, starts = fleet_run(params, dev, FLEET_B, FLEET_CHECK_STEPS)
    final, logs = run(*starts)
    single = wbl.make_whole_body_episode(params, cfg=wbl.WholeBodyLoopConfig(**SERVING_LOOP),
                                         n_control_steps=FLEET_CHECK_STEPS, device=dev)
    plants, solver, targets, base_targets = starts
    # The logs and the final base position (atol TOL_FLEET, as the CPU
    # test), then every plant field, relative to its largest entry.
    worst, worst_plant, equal = 0.0, {}, True
    for b in FLEET_CHECKED:
        one = mppi.MPPIState(u_prev=solver.u_prev[b], sigma=solver.sigma[b],
                             seed=solver.seed[b:b + 1], step=0)
        f1, l1 = single(tree_map(lambda x: x[b], plants), one, tree_map(lambda x: x[b], targets),
                        base_targets[b])
        pairs = [(getattr(logs, f)[b], getattr(l1, f)) for f in l1._fields]
        pairs.append((final[0].base.pos[b], f1[0].base.pos))
        worst = max([worst] + [(x - y).abs().max().item() for x, y in pairs])
        got, want = pk.pack_plant(final[0])[b], pk.pack_plant(f1[0])
        for name, lo, hi in PLANT_FIELDS:
            worst_plant[name] = max(worst_plant.get(name, 0.0), rel_err(got[lo:hi], want[lo:hi]))
        equal = equal and all(torch.equal(x, y) for x, y in pairs) and torch.equal(got, want)
    print(f"[15] fleet B={FLEET_B} x K={FLEET_K} x H={H}, {FLEET_CHECK_STEPS} steps: scenarios "
          f"{FLEET_CHECKED} against their unbatched graphed episodes: logs and final base "
          f"position max|d| {worst:.2e} (limit {TOL_FLEET:g}); final plant, relative per field: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst_plant.items())
          + f"; bit-equal {equal}", flush=True)
    if not worst <= TOL_FLEET:
        fail("a fleet scenario disagrees with its unbatched episode")

    run, starts = fleet_run(params, dev, FLEET_B, FLEET_STEPS)
    reset_counts()
    pk.plant_tick.launches = 0
    _, logs = run(*starts)  # its capture included: two warm-up calls launch the kernels
    launches = count_episode_launches()
    timed, timed_starts = fleet_run(params, dev, FLEET_B, FLEET_B16_TIMED)
    timed(*timed_starts)  # capture
    _, step_ms = timed_episode(timed, timed_starts, FLEET_B16_TIMED)
    tail_n = min(100, FLEET_STEPS // 3)
    quality = [reach_quality(f"[15] fleet scenario {b}", tree_map(lambda x: x[b], logs), tail_n)
               for b in range(FLEET_B)]
    held = [gate_met(q) for q in quality]
    conv = sorted(q["converged_step"] for q in quality if q["converged_step"] >= 0)
    rate = FLEET_B * FLEET_STEPS / (step_ms * FLEET_STEPS / 1e3)
    print(f"[15] fleet B={FLEET_B} x K={FLEET_K}, {FLEET_STEPS} steps ({FLEET_STEPS / 100:.0f} s): "
          f"gate held in {sum(held)} of {FLEET_B} (held fraction {sum(held) / FLEET_B:.3f}; "
          f"JAX package's record 15 of 16) | median converged step "
          f"{statistics.median(conv) if conv else -1} | {step_ms:.3f} ms per fleet step "
          f"({FLEET_B16_TIMED} replays) | "
          f"{rate:.0f} control steps/s = {rate / 100:.1f} vehicles at 100 Hz | launches "
          f"{launches}", flush=True)
    if launches != dict.fromkeys(("wb_cost", "wb_update", "plant_tick"), FLEET_STEPS + 2):
        fail("the fleet episode did not run through all three kernels once per step")
    if sum(held) < FLEET_MIN_HELD:
        fail(f"the fleet held the reach gate in {sum(held)} of {FLEET_B} scenarios, "
             f"fewer than {FLEET_MIN_HELD}")

    run, starts = fleet_run(params, dev, FLEET_B_TIMED, FLEET_TIMED_STEPS)
    run(*starts)  # capture and a first run
    torch.cuda.reset_peak_memory_stats(dev)
    (_, logs), big_ms = timed_episode(run, starts, FLEET_TIMED_STEPS)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    window, window_starts = fleet_run(params, dev, FLEET_B_TIMED, N_PROFILED)
    window(*window_starts)  # capture
    busy = profile_solves(f"[15] fleet B={FLEET_B_TIMED}", lambda: window(*window_starts), 1,
                          big_ms * N_PROFILED, unit=f"{N_PROFILED} fleet steps",
                          check_counts=True)
    big_rate = FLEET_B_TIMED * 1e3 / big_ms
    print(f"[15] fleet B={FLEET_B_TIMED} x K={FLEET_K}, {FLEET_TIMED_STEPS} steps: "
          f"{big_ms:.3f} ms per fleet step | {big_rate:.0f} control steps/s = "
          f"{big_rate / 100:.1f} vehicles at 100 Hz | peak {peak_gib:.2f} GiB | finite "
          f"{all(bool(torch.isfinite(f).all()) for f in logs)}", flush=True)
    return {"b16_ms": step_ms, "b16_rate": rate, "held": sum(held), "b256_ms": big_ms,
            "b256_rate": big_rate, "b256_busy": busy, "peak_gib": peak_gib}


def scenario_obs(dev, n: int, seed: int = 8):
    """n hover-and-reach observations that differ in base position, tilt,
    velocity, rates, arm angles and EE target position."""
    obs = wb.default_obs(device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def rnd(width, scale):
        return scale * (2.0 * torch.rand((n, width), generator=gen, device=dev) - 1.0)

    st, base = obs.state, obs.state.base
    base = base._replace(pos=base.pos + rnd(3, 0.1), rpy=base.rpy + rnd(3, 0.05),
                         vel=base.vel + rnd(3, 0.1), omega=base.omega + rnd(3, 0.05))
    state = st._replace(base=base, q=st.q + rnd(7, 0.1), qdot=st.qdot.expand(n, 7).clone())
    target = obs.ee_target._replace(position=obs.ee_target.position + rnd(3, 0.1),
                                    quat=obs.ee_target.quat.expand(n, 4).clone())
    return obs._replace(state=state, ee_target=target,
                        base_target=obs.base_target.expand(n, 3).clone())


def rel_err(got, want) -> float:
    """max |got - want| / max(1, max |want|)."""
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def reset_counts() -> None:
    for f in wk.KERNEL_WRAPPERS:
        f.launches = 0


def counts(*fns) -> dict:
    return {f.__name__: f.launches for f in fns}


PAIRS = {True: (wk.wb_cost, wk.wb_update), False: (wk.wb_cost_nospill, wk.wb_update_regen)}


def phase_batch(dev, errs):
    """The scenario batch at B=256 (BASELINE.json config 5's shape on one
    card): the no-spill pair (rows 4 and 5, whose main path this is)
    against its plain versions on all 256 scenarios, the spill pair on 4,
    the batched step against unbatched steps, launches per batched solve,
    ms per batched solve at B=1, 16, 256 for both kernel pairs, then the
    kernels alone at B=256."""
    params = wb.WholeBodyMPPIParams()
    cfg = params.mppi
    kc = wk.make_kernel_config(params)
    obs = scenario_obs(dev, B_BATCH)
    _, init = wb.make_whole_body_solver(params, device=dev, n_scenarios=B_BATCH)
    state = init(0)
    sc = wk.pack_scalars(obs, state.sigma * cfg.sigma_scale_fn(obs))
    u_prev, seeds = state.u_prev, state.seed
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seeds, 0)
    du, m2 = wk.wb_update(kc, eps, s, m, e)
    s4, m4, e4 = wk.wb_cost_nospill(kc, sc, u_prev, seeds, 0)
    du5, m2_5 = wk.wb_update_regen(kc, sc, s4, m4, e4, seeds, 0)
    plain_ms = {}
    (s_p, m_p, _), plain_ms["wb_cost_nospill"] = timed_once(
        lambda: wk.wb_cost_nospill_plain(kc, sc, u_prev, seeds, 0))
    (du5_p, m2_5p), plain_ms["wb_update_regen"] = timed_once(
        lambda: wk.wb_update_regen_plain(kc, sc, s4, m4, e4, seeds, 0))
    # (S, block minima) of pass 1 as in phase 2; (du, m2) of pass 2
    worst = {"S_nospill": max(rel_err(s4, s_p), rel_err(m4, m_p)),
             "du_regen": max(rel_err(du5, du5_p), rel_err(m2_5, m2_5p)),
             "S": 0.0, "eps": 0.0, "du": 0.0}
    errs["wb_cost_nospill"] = max((s4 - s_p).abs().max().item(), (m4 - m_p).abs().max().item())
    errs["wb_update_regen"] = max((du5 - du5_p).abs().max().item(),
                                  (m2_5 - m2_5p).abs().max().item())
    for i in CHECK_SCENARIOS:
        eps_p = wk.philox_eps(kc, sc[i], seeds[i:i + 1], 0)
        du_p, m2_p = wk.wb_update_plain(kc, eps[i], s[i], m[i], e[i])
        sync()
        worst["S"] = max(worst["S"], rel_err(s[i], s_p[i]))
        worst["eps"] = max(worst["eps"], (eps[i] - eps_p).abs().max().item())
        worst["du"] = max(worst["du"], rel_err(du[i], du_p), rel_err(m2[i], m2_p))
    print(f"[8] B={B_BATCH} batched kernels vs plain (no-spill pair on all {B_BATCH} scenarios, "
          f"spill pair on {CHECK_SCENARIOS}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" | plain ms at B={B_BATCH}: " + ", ".join(f"{k} {v:.1f}" for k, v in plain_ms.items()),
          flush=True)
    if not (worst["S"] <= TOL_COST and worst["S_nospill"] <= TOL_COST
            and worst["eps"] <= TOL_NOISE and worst["du"] <= TOL_UPDATE
            and worst["du_regen"] <= TOL_UPDATE):
        fail("a batched kernel disagrees with its plain version")
    del s, m, e, eps, du, m2, s4, m4, e4, du5, m2_5, s_p, m_p, du5_p, m2_5p

    # The batched step against unbatched steps on the same seeds and z, in
    # batches of 4, 8 and 256 (4 of its scenarios checked).
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    for nb, picked in ((4, range(4)), (8, range(8)), (B_BATCH, CHECK_SCENARIOS)):
        obs_b = tree_map(lambda x: x[:nb], obs)
        z = torch.randn((nb, K, H, A), generator=gen, device=dev)
        step_err = 0.0
        for spill in (True, False):
            step_b, init_b = wb.make_whole_body_solver(params, device=dev, n_scenarios=nb,
                                                       noise_spill=spill)
            step_1, init_1 = wb.make_whole_body_solver(params, device=dev, noise_spill=spill)
            st_b = init_b(3)
            seeds_b = st_b.seed.tolist()
            for zz in (None, z):
                out_b, st_nb = step_b(st_b, obs_b, zz)
                for b in picked:
                    out_1, st_n1 = step_1(init_1(seeds_b[b]), tree_map(lambda x: x[b], obs_b),
                                          None if zz is None else zz[b])
                    step_err = max(step_err, rel_err(out_b.u_seq[b], out_1.u_seq),
                                   rel_err(st_nb.u_prev[b], st_n1.u_prev))
        sync()
        del z
        print(f"[8] batched step (B={nb}) vs {len(picked)} unbatched steps (Philox and z, "
              f"spill and no spill): max rel {step_err:.2e}", flush=True)
        if not step_err <= TOL_BATCH:
            fail(f"the batched step at B={nb} disagrees with the unbatched steps")

    # Launches per batched solve, then ms per solve at B = 1, 16, 256.
    rows, launches = [], {}
    for b in B_TIMED:
        obs_b = tree_map(lambda x: x[:b], obs)
        for spill in (True, False):
            step_b, init_b = wb.make_whole_body_solver(params, device=dev, n_scenarios=b,
                                                       noise_spill=spill)
            st = init_b(0)
            step_b(st, obs_b)  # warm up
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            out, _ = step_b(st, obs_b)
            sync()
            one = counts(*PAIRS[spill])
            if list(one.values()) != [1, 1] or not bool(torch.isfinite(out.u_seq).all()):
                fail(f"B={b}: a batched solve launched {one}, not one of each kernel")
            reset_counts()
            h_ms = host_ms(lambda: step_b(st, obs_b), reps=5)
            e_ms = event_ms(lambda: step_b(st, obs_b), reps=10, warmup=1)
            if b == B_BATCH:
                launches.update(counts(*PAIRS[spill]))
                if spill:
                    profile_solves(f"[8] B={b}", lambda: step_b(st, obs_b), 5, e_ms)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            rows.append((b, spill, h_ms, e_ms, b * 1e3 / e_ms, peak, one))
    for b, spill, h_ms, e_ms, rate, peak, one in rows:
        print(f"[8] B={b:3d} {'spill   ' if spill else 'no spill'} {one}: host {h_ms:.3f} ms, "
              f"events {e_ms:.3f} ms per batched solve, {rate:.1f} solves/s, "
              f"peak {peak:.3f} GiB", flush=True)

    # The kernels alone at B=256 (the inputs of the checks above) against B
    # times the one-scenario bound; the library yardstick of pass 2 is one
    # batched matrix-vector product of the spilled noise by the weights.
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, seeds, 0)
    se = wk.softmin_normalizers(kc, m, e)
    w = torch.exp((se[:, :1] - s) * kc.inv_lam) / se[:, 1:]
    flat = eps.view(B_BATCH, A * H, K)
    t = {"wb_cost": event_ms(lambda: wk.wb_cost(kc, sc, u_prev, None, seeds, 0), reps=5),
         "wb_cost_nospill": event_ms(lambda: wk.wb_cost_nospill(kc, sc, u_prev, seeds, 0), reps=5),
         "wb_update": event_ms(lambda: wk.wb_update(kc, eps, s, m, e), reps=5),
         "wb_update_regen": event_ms(lambda: wk.wb_update_regen(kc, sc, s, m, e, seeds, 0),
                                     reps=5),
         "library_bmm": event_ms(lambda: torch.bmm(flat, w[..., None]), reps=5)}
    # Device times of pass 2 and its yardstick (profiler, and CUDA-graph
    # replay), so that kernel and library compare device time with device
    # time.
    pass2 = {"wb_update": (lambda: wk.wb_update(kc, eps, s, m, e), update_key("wb_update")),
             "wb_update_regen": (lambda: wk.wb_update_regen(kc, sc, s, m, e, seeds, 0),
                                 update_key("wb_update_regen")),
             "library_bmm": (lambda: torch.bmm(flat, w[..., None]), "")}
    t.update({f"{k}_plain": v for k, v in plain_ms.items()})
    for k, (fn, key) in pass2.items():
        t[f"{k}_device"] = device_ms(fn, key, reps=5)
        t[f"{k}_graph"] = graph_ms(fn, reps=5)
    work = new_work(K)
    bounds = {k: bound(B_BATCH * work[k][0], B_BATCH * work[k][1])
              for k in ("wb_update", "wb_cost_nospill", "wb_update_regen")}
    b_cost = bound(B_BATCH * cost_bytes(K, True), B_BATCH * K * H * WB_COST_OPS_PER_SAMPLE_STEP)
    print(f"[8] kernels at B={B_BATCH} (ms per launch; per scenario): " + ", ".join(
        f"{k} {fmt_ms(v)} ({'-' if v is None else f'{v / B_BATCH * 1e3:.2f}'} us)"
        for k, v in t.items())
        + f" | bounds: wb_cost {b_cost[0]:.3f} ms by {b_cost[1]}, "
        + ", ".join(f"{k} {v[0]:.3f} ms by {v[1]}" for k, v in bounds.items()), flush=True)
    return launches, t, rows, bounds


def cost_bytes(k: int, spill: bool) -> int:
    """Bytes pass 1 must move for one scenario of k samples: scalars, warm
    start, costs, partials, and the noise it spills."""
    return (wk.SC_LEN + H * A + k + 2 * (k // wk.BLOCK)) * 4 + (A * H * k * 4 if spill else 0)


def new_work(k: int) -> dict:
    """(bytes, float32 operations) of rows 3-7 for one scenario of k
    samples: pass 1 without the spill; pass 2 reads the costs and either
    the scalars (to draw the noise again) or the noise, the block partials
    or the given (rho, eta), and writes du and m2."""
    small = (k + wk.SC_LEN + 2 * A * H) * 4
    weight_ops = k * WB_WEIGHT_OPS_PER_SAMPLE
    regen_ops = A * H * k * WB_REGEN_OPS_PER_ELEMENT + weight_ops
    read_ops = A * H * k * WB_UPDATE_OPS_PER_ELEMENT + weight_ops
    return {"wb_update": (A * H * k * 4 + (k + 2 * (k // wk.BLOCK) + 2 * A * H) * 4, read_ops),
            "wb_cost_nospill": (cost_bytes(k, False), k * H * WB_COST_OPS_PER_SAMPLE_STEP),
            "wb_update_regen": (small + 2 * (k // wk.BLOCK) * 4, regen_ops),
            "wb_update_shard_regen": (small + 2 * 4, regen_ops),
            "wb_update_shard": (A * H * k * 4 + (k + 2 + 2 * A * H) * 4, read_ops)}


def update_key(name: str, r=None) -> str:
    """The profiler's name of the wb_update instantiation ``name`` launches
    (any rows per block, or ``r``)."""
    regen, given = "regen" in name, "shard" in name
    return f"wb_update_kernel<{str(regen).lower()}, {str(given).lower()}, {r or ''}"


def cost_key(variant: int, mode: int = 0) -> str:
    """The profiler's name of the wb_cost instantiation for wb_cost_launch's
    ``variant`` (0 explicit noise, 1 spill, 2 no spill)."""
    draw, store = str(variant != 0).lower(), str(variant == 1).lower()
    return f"wb_cost_kernel<{mode}, {draw}, {store}>"


# The instantiation each new wrapper launches at one scenario, K=4096, as
# the profiler names it.
KERNEL_KEYS = {"wb_cost_nospill": cost_key(2),
               **{n: update_key(n) for n in
                  ("wb_update_regen", "wb_update_shard_regen", "wb_update_shard")}}


def compare(kern, plain, args):
    """(max |d|, max relative error) of a wrapper against its plain version
    on ``args``: (S, block minima) of pass 1, (du, m2) of pass 2.  Pass 1's
    block sums of exp((m - S)/lambda) amplify S's last bits by 1/lambda and
    are checked through pass 2's du, as in phase 2."""
    got, want = kern(*args)[:2], plain(*args)[:2]
    sync()
    return (max((g - p).abs().max().item() for g, p in zip(got, want)),
            max(rel_err(g, p) for g, p in zip(got, want)))


def time_kernel(name, kern, plain, args) -> dict:
    return {"ms": event_ms(lambda: kern(*args)),
            "device_ms": device_ms(lambda: kern(*args), KERNEL_KEYS[name]),
            "graph_ms": graph_ms(lambda: kern(*args)),
            "plain_ms": event_ms(lambda: plain(*args), reps=5)}


def time_library(flat, w) -> dict:
    """torch.mv of the noise rows by the weights: one PyTorch call for what
    pass 2 computes (its du)."""
    return {"ms": event_ms(lambda: torch.mv(flat, w)),
            "device_ms": device_ms(lambda: torch.mv(flat, w), "gemv"),  # cuBLAS gemv
            "graph_ms": graph_ms(lambda: torch.mv(flat, w))}


def phase_nospill(dev):
    """No spill against spill at K=4096 on one scenario (du, u_seq, sigma),
    then each new kernel against its plain version at one scenario, K=4096,
    with its timings (beside the main paths' numbers of phases 8 and 10)."""
    adaptive = wb.position_mode_params()
    adaptive = dataclasses.replace(adaptive, mppi=dataclasses.replace(
        adaptive.mppi, adaptive_sigma=True, sigma_scale_fn=None))
    keys = wk.philox_keys(5, dev)
    for name, params in (("attitude", wb.WholeBodyMPPIParams()),
                         ("position, adaptive sigma", adaptive)):
        kc = wk.make_kernel_config(params)
        state, obs, _, sc, _ = inputs(params, dev, torch.Generator(device=dev))
        u_prev = state.u_prev.contiguous()
        s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, keys, 2)
        du3, _ = wk.wb_update(kc, eps, s, m, e)
        s4, m4, e4 = wk.wb_cost_nospill(kc, sc, u_prev, keys, 2)
        du5, _ = wk.wb_update_regen(kc, sc, s4, m4, e4, keys, 2)
        res = {}
        for spill in (True, False):
            step = wk.make_whole_body_cuda_step(params, dev, noise_spill=spill)
            res[spill] = step(state, obs)
        sync()
        err = {"du": rel_err(du5, du3),
               "u_seq": rel_err(res[False][0], res[True][0]),
               "sigma": rel_err(res[False][1].sigma, res[True][1].sigma)}
        print(f"[9] {name}: no spill vs spill " + ", ".join(
            f"{k} {v:.2e}" for k, v in err.items()) + " (relative)", flush=True)
        if max(err.values()) > TOL_SPILL:
            fail("the no-spill pair disagrees with the spill pair")

    params = wb.WholeBodyMPPIParams()
    kc = wk.make_kernel_config(params)
    state, obs, _, sc, _ = inputs(params, dev, torch.Generator(device=dev))
    u_prev = state.u_prev.contiguous()
    keys, step, k_off = wk.philox_keys(1, dev), 0, 0
    s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, keys, step)
    se = wk.softmin_normalizers(kc, m, e)
    cases = {  # wrapper, plain version, arguments, tolerance
        "wb_cost_nospill": (wk.wb_cost_nospill, wk.wb_cost_nospill_plain,
                            (kc, sc, u_prev, keys, step, k_off), TOL_COST),
        "wb_update_regen": (wk.wb_update_regen, wk.wb_update_regen_plain,
                            (kc, sc, s, m, e, keys, step, k_off), TOL_UPDATE),
        "wb_update_shard_regen": (wk.wb_update_shard_regen, wk.wb_update_shard_regen_plain,
                                  (kc, sc, s, se, keys, step, k_off), TOL_UPDATE),
        "wb_update_shard": (wk.wb_update_shard, wk.wb_update_shard_plain,
                            (kc, eps, s, se), TOL_UPDATE),
    }
    t = {"wb_update": {"device_ms": device_ms(lambda: wk.wb_update(kc, eps, s, m, e),
                                              update_key("wb_update")),
                       "graph_ms": graph_ms(lambda: wk.wb_update(kc, eps, s, m, e))}}
    for name, (kern, plain, args, tol) in cases.items():
        _, rel = compare(kern, plain, args)
        if not rel <= tol:
            fail(f"{name} disagrees with its plain version ({rel:.2e})")
        t[name] = time_kernel(name, kern, plain, args)
        print(f"[9] {name} vs plain rel {rel:.2e}", flush=True)
    t["library_mv"] = time_library(eps.view(A * H, K), torch.exp((se[0] - s) * kc.inv_lam) / se[1])
    bounds = {k: bound(*v) for k, v in new_work(K).items()}
    print(f"[9] timings at one scenario, K={K} (ms): " + ", ".join(
        f"{k} {q} {fmt_ms(v)}" for k, d in t.items() for q, v in d.items())
        + " | bounds (ms): " + ", ".join(f"{k} {v[0]:.2e} by {v[1]}" for k, v in bounds.items()),
        flush=True)
    return t


# wb_update's main-path shapes: (PERF.md row, wrapper, scenarios, samples);
# rows 6-7 at K_local with rank 1's sample offset.
UPDATE_SHAPES = (("3", "wb_update", 1, K), ("3", "wb_update", B_BATCH, K),
                 ("5", "wb_update_regen", B_BATCH, K),
                 ("6", "wb_update_shard_regen", 1, K // SHARD_RANKS),
                 ("7", "wb_update_shard", 1, K // SHARD_RANKS))


def phase_update_rows(dev):
    """wb_update at every rows-per-block R the source is built for, at each
    main-path shape: (du, m2) bit-equal for every R (a row's reduction
    order does not depend on R), CUDA-graph and profiler ms per R beside
    the R the launcher picks and the library call's; at B=256 the
    draw variant against the read variant on the same costs."""
    params = wb.WholeBodyMPPIParams()
    res = {}
    for row, name, b, k in UPDATE_SHAPES:
        kc = wk.make_kernel_config(params, k)
        batch = b > 1
        _, init = wb.make_whole_body_solver(params, device=dev, n_scenarios=b if batch else None)
        state = init(0)
        obs = scenario_obs(dev, b) if batch else wb.default_obs(device=dev)
        sc = wk.pack_scalars(obs, state.sigma * params.mppi.sigma_scale_fn(obs))
        seeds = wk.philox_keys(state.seed, dev)
        k_off = K - k
        s, m, e, eps = wk.wb_cost(kc, sc, state.u_prev.contiguous(), None, seeds, 0, k_off)
        se = wk.softmin_normalizers(kc, m, e)

        def launch(r, name=name):
            kw = {"se": se} if "shard" in name else {"m_part": m, "e_part": e}
            if "regen" in name:
                kw.update(sc=sc, seeds=seeds, k_off=k_off)
            else:
                kw["eps"] = eps
            return wk._launch_update(kc, name, s, rows_per_block=r, **kw)

        outs = {r: launch(r) for r in wk.UPDATE_ROWS}
        sync()
        equal = all(torch.equal(outs[r][i], outs[1][i]) for r in outs for i in (0, 1))
        ms = {r: graph_ms(lambda r=r: launch(r)) for r in wk.UPDATE_ROWS}
        dev_ms = {r: device_ms(lambda r=r: launch(r), update_key(name, r)) for r in wk.UPDATE_ROWS}
        flat = eps.view(s.shape[:-1] + (A * H, k))
        w = torch.exp((se[..., :1] - s) * kc.inv_lam) / se[..., 1:]
        lib = (lambda: torch.bmm(flat, w[..., None])) if batch else (lambda: torch.mv(flat, w))
        lib_ms, lib_dev = graph_ms(lib), device_ms(lib, "")
        chosen = wk.update_rows_per_block("regen" in name, b, A * H)
        vs_read = None
        if "regen" in name:  # the same costs and draws, read from the spill
            read = wk._launch_update(kc, name, s, eps=eps, m_part=m, e_part=e,
                                     rows_per_block=chosen)
            sync()
            vs_read = max((outs[chosen][i] - read[i]).abs().max().item() for i in (0, 1))
        res[(row, b)] = {"name": name, "b": b, "k": k, "rows_per_block": chosen,
                         "graph_ms": ms, "device_ms": dev_ms, "library_graph_ms": lib_ms,
                         "library_device_ms": lib_dev}
        print(f"[13] row {row} {name} B={b} K={k}: ms by R (graph / profiler) " + ", ".join(
            f"R={r} {ms[r]:.4f}/{fmt_ms(dev_ms[r])}" for r in wk.UPDATE_ROWS)
            + f" | launcher's R {chosen} | {'torch.bmm' if batch else 'torch.mv'} "
            f"{lib_ms:.4f}/{fmt_ms(lib_dev)} | bit-equal across R {equal}"
            + ("" if vs_read is None else f" | vs the read variant max|d| {vs_read:.2e}"),
            flush=True)
        if not equal:
            fail(f"{name}: (du, m2) differ between rows-per-block choices")
    return res


# wb_cost's main-path shapes: (label, scenarios, samples, sample offset):
# the serving solve and episode, the scenario batch at 16 and 256, and one
# rank's share of the sharded solve (rank 1's offset).
COST_SHAPES = (("B=1", 1, K, 0), ("B=16", 16, K, 0), ("B=256", B_BATCH, K, 0),
               ("K_local", 1, K // SHARD_RANKS, K - K // SHARD_RANKS))
COST_VARIANTS = {1: "spill", 2: "no spill", 0: "explicit noise"}  # wb_cost_launch's codes
# The pass-1 kernels' layout (wb_cost and drone_cost), named in the kernels line.
COST_LAYOUT = "a warp per sample, the horizon across its lanes"
# The layouts of plant_tick and drone_update, named in the kernels line.
PLANT_LAYOUT = "eight lanes per vehicle row, four rows per warp"
UPDATE_LAYOUT = ("column blocks of the (K, H*A) noise: one column and all K at small K, "
                 "32-column tiles with K split across blocks at large K")


def cost_work(b: int, k: int, variant: int):
    """(bytes, float32 operations) of one wb_cost launch of b scenarios of
    k samples: the spill written or the explicit noise read (none without
    the spill), the draws counted where the kernel draws."""
    ops = WB_COST_OPS_PER_SAMPLE_STEP if variant else WB_COST_NOISE_OPS_PER_SAMPLE_STEP
    return b * cost_bytes(k, variant != 2), b * k * H * ops


def phase_cost_shapes(dev):
    """wb_cost in three modes and three variants at each shape of
    COST_SHAPES: S against the plain version and each scenario of a batch
    against its unbatched launch (all scenarios, or the CHECK_SCENARIOS of
    256), the spill bit-equal to philox_eps, each launch bit-equal on a
    rerun, CUDA-graph and profiler ms."""
    res = {}
    for label, b, k, k_off in COST_SHAPES:
        batch = b > 1
        reps = 3 if b == B_BATCH else 20
        checked = CHECK_SCENARIOS if b == B_BATCH else range(b)
        for mode_i, (mode, params) in enumerate(presets().items()):
            kc = wk.make_kernel_config(params, k)
            _, init = wb.make_whole_body_solver(params, device=dev,
                                                n_scenarios=b if batch else None)
            state = init(0)
            obs = scenario_obs(dev, b) if batch else wb.default_obs(device=dev)
            sigma = state.sigma
            if params.mppi.sigma_scale_fn is not None:
                sigma = sigma * params.mppi.sigma_scale_fn(obs)
            sc = wk.pack_scalars(obs, sigma)
            u_prev, seeds = state.u_prev.contiguous(), wk.philox_keys(state.seed, dev)

            def one(x, i):
                return x[i] if batch else x

            plain = {i: wk.wb_cost_plain(kc, one(sc, i), one(u_prev, i),
                                         None, seeds[i:i + 1], 0, k_off) for i in checked}
            spill = None
            for variant, vname in COST_VARIANTS.items():  # the spill first: noise reads it
                def launch(variant=variant):
                    return wk._launch_cost(kc, "wb_cost", sc, u_prev,
                                           spill if variant == 0 else None,
                                           seeds if variant else None, 0, k_off, variant)

                first, again = launch(), launch()
                sync()
                if variant == 1:
                    spill = first[3]
                rerun = all(torch.equal(x, y) for x, y in zip(first[:3], again[:3])) and (
                    variant != 1 or torch.equal(first[3], again[3]))
                del again
                rel_plain = max(rel_err(one(first[0], i), plain[i][0]) for i in checked)
                spill_eq = None if variant != 1 else all(
                    torch.equal(one(first[3], i), plain[i][3]) for i in checked)
                unbatched_eq = None if not batch else all(
                    all(torch.equal(x[i], y) for x, y in zip(first[:3], wk._launch_cost(
                        kc, "wb_cost", sc[i], u_prev[i], spill[i] if variant == 0 else None,
                        seeds[i:i + 1] if variant else None, 0, k_off, variant)[:3]))
                    for i in checked)
                del first
                bnd = bound(*cost_work(b, k, variant))
                r = res[(label, mode, variant)] = {
                    "rel_plain": rel_plain, "rerun": rerun, "spill_eq_philox": spill_eq,
                    "unbatched_eq": unbatched_eq, "graph_ms": graph_ms(launch, reps),
                    "device_ms": device_ms(launch, cost_key(variant, mode_i), reps),
                    "bound_ms": bnd[0], "bound_by": bnd[1]}
                print(f"[14] {label} K={k} k_off={k_off} {mode:8s} {vname:14s}: graph/prof "
                      f"{r['graph_ms']:.4f}/{fmt_ms(r['device_ms'])} ms, vs plain "
                      f"{rel_plain:.2e}, reruns bit-equal {rerun}"
                      + ("" if variant != 1 else f", spill == philox_eps {spill_eq}")
                      + ("" if not batch else f", == unbatched {unbatched_eq}")
                      + f" | bound {bnd[0]:.4f} ms by {bnd[1]}", flush=True)
                if not (rel_plain <= TOL_COST and rerun and spill_eq in (None, True)
                        and unbatched_eq in (None, True)):
                    fail(f"wb_cost {vname} at {label}, {mode} disagrees with the plain version, "
                         "its unbatched launches or its rerun")
            del spill, plain
    return res


def _counting(calls: list):
    """``dist.all_reduce`` that records each call."""
    inner = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(kwargs.get("op"))
        return inner(*args, **kwargs)

    return counted


# Pass 2 of the sharded solve: (wrapper, plain version) with the spill
# (row 7) and without (row 6).
SHARD_PASS2 = {True: (wk.wb_update_shard, wk.wb_update_shard_plain),
               False: (wk.wb_update_shard_regen, wk.wb_update_shard_regen_plain)}


def shard_pass2(kc, params, states, obs, spill: bool, k_off: int, group):
    """Pass 2 of the sharded solve on this rank's own inputs of each solve
    in ``states`` (pass 1 again at this rank's sample offset, then the
    global (rho, eta) through the group's collectives) against its plain
    version: (max |d|, max relative error, the last solve's arguments)."""
    kern, plain = SHARD_PASS2[spill]
    worst_abs = worst_rel = 0.0
    for st in states:
        sc = wk.pack_scalars(obs, st.sigma * params.mppi.sigma_scale_fn(obs))
        u_prev, keys = st.u_prev.contiguous(), wk.philox_keys(st.seed, sc.device)
        if spill:
            s, m, e, eps = wk.wb_cost(kc, sc, u_prev, None, keys, st.step, k_off)
            args = (kc, eps, s, wk.softmin_normalizers(kc, m, e, group))
        else:
            s, m, e = wk.wb_cost_nospill(kc, sc, u_prev, keys, st.step, k_off)
            args = (kc, sc, s, wk.softmin_normalizers(kc, m, e, group), keys, st.step, k_off)
        d_abs, d_rel = compare(kern, plain, args)
        worst_abs, worst_rel = max(worst_abs, d_abs), max(worst_rel, d_rel)
    return worst_abs, worst_rel, args


FLIGHT_SHARD_PRESETS = ("multirotor", "fixed-wing", "mapped spheres", "mapped ESDF")


def flight_maps(dev) -> list:
    """Two different occupancy grids on the mapped flight's geometry (a
    seeded random field of free, unknown and occupied voxels, the second
    shifted by 6 voxels): (grid params, [(centers, radii + margin, distance
    field)] per map)."""
    p = mapped_loop.MappedFlightConfig().grid
    gen = torch.Generator(device=dev).manual_seed(16)
    pick = torch.randint(0, 4, tuple(p.shape), generator=gen, device=dev)
    lo = torch.tensor([0.0, occ.LOG_ODDS_MISS, occ.LOG_ODDS_MIN, occ.LOG_ODDS_MAX],
                      device=dev)[pick]
    maps = []
    for grid_lo in (lo, torch.roll(lo, -6, dims=0)):
        grid = occ.OccupancyGrid(grid_lo)
        c, r = occ.occupied_centers(p, grid)
        maps.append((c, torch.where(r > 0, r + mapped_loop.MappedFlightConfig().margin, 0.0),
                     occ.distance_field(p, grid)))
    return p, maps


def flight_shard_case(name: str, dev, n_scn):
    """(preset factory, params at the JAX default K=1024, observation of one
    problem or of ``n_scn``) for phase 10's flight-preset runs; each
    scenario its own state and target (and, mapped, its own map)."""
    def rows(*vals):
        t = torch.tensor(vals, dtype=torch.float32, device=dev)
        return t[0] if n_scn is None else t[:n_scn]

    if name == "multirotor":
        obs = mm.MultirotorObs(
            state=Multirotor12State(pos=rows([0.3, -0.2, 2.1], [0.0, 0.0, 2.0]),
                                    rpy=rows([0.05, -0.03, 0.2], [0.0, 0.02, -0.1]),
                                    vel=rows([0.2, 0.1, -0.05], [0.0, -0.2, 0.1]),
                                    omega=rows([0.1, -0.05, 0.02], [0.0, 0.03, 0.0])),
            target=rows(list(MR_WAYPOINT), [1.0, -1.0, 2.5]))
        return mm.make_multirotor_solver, mm.MultirotorMPPIParams(), obs
    if name == "fixed-wing":
        c, s_ = np.cos(0.1), np.sin(0.1)
        obs = fws.FwObs(
            state=fw_model.FixedWingState(pos=rows([0.0, 0.0, 100.0], [10.0, -5.0, 95.0]),
                                        quat=rows([1.0, 0.0, 0.0, 0.0], [c, s_, 0.0, 0.0]),
                                        vel=rows([15.0, 0.0, 0.0], [14.0, 1.0, -0.5]),
                                        omega=rows([0.0, 0.0, 0.0], [0.1, -0.05, 0.02])),
            target=rows(list(scenarios.FW_TARGET), [-100.0, 200.0, 90.0]),
            cruise_speed=rows(scenarios.FW_CRUISE, 17.0))
        return fws.make_fixed_wing_solver, fws.FwMPPIParams(), obs
    esdf = name == "mapped ESDF"
    grid_p, maps = flight_maps(dev)
    params = mapped_solver.MappedMPPIParams(altitude_weight=8.0, use_esdf=esdf,
                                            esdf_params=grid_p)
    pick = (lambda i: maps[0][i]) if n_scn is None else \
        (lambda i: torch.stack([m[i] for m in maps[:n_scn]]))
    obs = mapped_solver.MappedObs(x=rows([0.5, 0.1, 1.8], [1.0, -0.4, 1.7]),
                       v=rows([1.5, 0.2, 0.0], [1.0, -0.1, 0.05]),
                       target=rows([9.0, 0.0, 1.8], [8.0, 0.5, 1.8]),
                       obst_centers=pick(0), obst_radii=pick(1),
                       dist_field=pick(2) if esdf else None)
    return mapped_solver.make_mapped_solver, params, obs


def shard_flight(mesh, dev) -> dict:
    """F9 on this rank: each flight preset through ``make_sharded_solver``
    (K=1024 as 2 x 512), with ``batch_scenarios=False`` and with
    FLIGHT_SHARD_SCENARIOS scenarios, against the one-rank solve on the same
    seed over N_FLIGHT_SHARD_SOLVES solves (of the plan's largest entry),
    all-reduces per solve, and host ms per unbatched sharded solve (two
    ranks contending for one card: recorded as seen)."""
    out = {}
    for name in FLIGHT_SHARD_PRESETS:
        for n_scn in (None, FLIGHT_SHARD_SCENARIOS):
            make, params, obs = flight_shard_case(name, dev, n_scn)
            kw = {"n_scenarios": n_scn} if n_scn else {}
            step, init = sharded.make_sharded_solver(make, mesh, batch_scenarios=bool(n_scn),
                                                     params=params, device=dev, **kw)
            step1, init1 = make(params, device=dev, n_scenarios=n_scn)
            st, st1, err = init(7), init1(7), 0.0
            for _ in range(N_FLIGHT_SHARD_SOLVES):
                res, st = step(st, obs)
                res1, st1 = step1(st1, obs)
                err = max(err, ((res.u_seq - res1.u_seq).abs().max()
                                / res1.u_seq.abs().max()).item())
            calls, plain = [], dist.all_reduce
            dist.all_reduce = _counting(calls)
            try:
                step(st, obs)
            finally:
                dist.all_reduce = plain
            box = [st]

            def one():
                _, box[0] = step(box[0], obs)

            tag = f"{name}, " + (f"B={n_scn}" if n_scn else "unbatched")
            out[tag] = {"err": err, "all_reduce": len(calls),
                        "finite": bool(torch.isfinite(res.u_seq).all()),
                        "ms": host_ms(one, reps=5) if n_scn is None else None}
    return out


def shard_rank(rank: int, port: int, device: str, queue) -> None:
    """One of two gloo ranks on the one card (NCCL refuses two ranks on one
    device): the sample-sharded solve at K_local = 2048 for both kernel
    pairs against the one-rank K=4096 solve, collective counts, ms per
    sharded solve; then pass 2 (rows 7 and 6) on this rank's own inputs of
    each solve against its plain version, and (rank 0, while rank 1 waits)
    its timings at K_local."""
    import traceback

    try:
        dev = torch.device(device)
        multihost.initialize(f"tcp://127.0.0.1:{port}", SHARD_RANKS, rank, backend="gloo")
        mesh = mesh_mod.make_mesh()
        params = wb.WholeBodyMPPIParams()
        obs = wb.default_obs(device=dev)
        kc = wk.make_kernel_config(params, K // SHARD_RANKS)
        k_off = mesh.sample_index * kc.n_samples
        ref = []
        if rank == 0:
            step1, init1 = wb.make_whole_body_solver(params, device=dev)
            st = init1(0)
            for _ in range(N_SHARD_SOLVES):
                out, st = step1(st, obs)
                ref.append(out.u_seq)
        out_d = {"rank": rank, "k_off": k_off, "err": {}, "launches": {}, "all_reduce": {},
                 "ms": {}, "kernel_err": {}, "timing": {}}
        last_args = {}
        for spill in (True, False):
            step, init = sharded.make_sharded_solver(
                wb.make_whole_body_solver, mesh, batch_scenarios=False, params=params,
                device=dev, noise_spill=spill)
            name = "spill" if spill else "no spill"
            reset_counts()
            st, err, states = init(0), 0.0, []
            for i in range(N_SHARD_SOLVES):
                states.append(st)
                out, st = step(st, obs)
                if ref:
                    b = ref[i]
                    err = max(err, ((out.u_seq - b).abs() / (1.0 + b.abs())).max().item())
            sync()
            out_d["err"][name] = err
            out_d["launches"].update({f.__name__: f.launches for f in wk.KERNEL_WRAPPERS
                                      if f.launches})
            kern_name = SHARD_PASS2[spill][0].__name__
            d_abs, d_rel, last_args[kern_name] = shard_pass2(kc, params, states, obs, spill,
                                                             k_off, mesh.sample_group)
            out_d["kernel_err"][kern_name] = {"abs": d_abs, "rel": d_rel}
            calls, plain = [], dist.all_reduce
            dist.all_reduce = _counting(calls)
            try:
                step(st, obs)
            finally:
                dist.all_reduce = plain
            out_d["all_reduce"][name] = len(calls)
            out_d["ms"][name] = host_ms(lambda: step(st, obs), reps=10)
        adaptive = dataclasses.replace(params, mppi=dataclasses.replace(
            params.mppi, adaptive_sigma=True, sigma_scale_fn=None))
        step, init = sharded.make_sharded_solver(wb.make_whole_body_solver, mesh,
                                                 batch_scenarios=False, params=adaptive,
                                                 device=dev, low_k_guard="off")
        calls, plain = [], dist.all_reduce
        dist.all_reduce = _counting(calls)
        try:
            step(init(0), obs)
        finally:
            dist.all_reduce = plain
        out_d["all_reduce"]["adaptive sigma"] = len(calls)
        # The arm node's plain pipeline sample-sharded (K=100 as 2 x 50)
        # against the one-rank arm solve on the same seed.
        aparams, aobs = arm.ArmMPPIParams(), arm_obs(dev)
        astep, ainit = sharded.make_sharded_solver(arm.make_arm_solver, mesh,
                                                   batch_scenarios=False, params=aparams,
                                                   device=dev)
        astep1, ainit1 = arm.make_arm_solver(aparams, device=dev)
        st, st1, err = ainit(4), ainit1(4), 0.0
        for _ in range(N_ARM_SHARD_SOLVES):
            res, st = astep(st, aobs)
            res1, st1 = astep1(st1, aobs)
            err = max(err, ((res.u_seq - res1.u_seq).abs() / (1.0 + res1.u_seq.abs())).max().item(),
                      ((res.qdes - res1.qdes).abs() / (1.0 + res1.qdes.abs())).max().item())
        out_d["arm_err"] = err
        out_d["flight"] = shard_flight(mesh, dev)
        dist.barrier()
        if rank == 0:  # the card to itself: rank 1 waits at the barrier
            for spill, (kern, plain) in SHARD_PASS2.items():
                name = kern.__name__
                out_d["timing"][name] = time_kernel(name, kern, plain, last_args[name])
            _, eps, s, se = last_args["wb_update_shard"]
            out_d["timing"]["library_mv"] = time_library(
                eps.view(A * H, kc.n_samples), torch.exp((se[0] - s) * kc.inv_lam) / se[1])
        dist.barrier()
        out_d["scaling"] = scaling.measure_weak_scaling(k_per_device=K // SHARD_RANKS, h=H,
                                                        iters=10, device=dev)
        out_d["scaling_torch"] = scaling.measure_weak_scaling(
            k_per_device=K // SHARD_RANKS, h=H, iters=10, device=dev, backend="torch")
        queue.put(out_d)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the phase
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise


def phase_sharded(dev):
    """Two gloo ranks on the card run the sample-sharded solve; any rank that
    fails, hangs past the timeout or exits non-zero fails the phase."""
    import queue as queue_mod
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=shard_rank, args=(r, port, str(dev), q))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.time() + SHARD_TIMEOUT_S
        while len(results) < SHARD_RANKS:
            try:
                res = q.get(timeout=max(1.0, deadline - time.time()))
            except queue_mod.Empty:
                fail(f"sharded ranks did not report within {SHARD_TIMEOUT_S} s")
            if "error" in res:
                fail(f"sharded rank {res['rank']} failed:\n{res['error']}")
            results[res["rank"]] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * SHARD_RANKS:
        fail(f"sharded ranks exited with {codes}")
    r0 = results[0]
    sc = r0["scaling"]
    print(f"[10] {SHARD_RANKS} gloo ranks on one card, K={K} as {SHARD_RANKS} x "
          f"{K // SHARD_RANKS}: sharded vs one-rank over {N_SHARD_SOLVES} solves "
          + ", ".join(f"{k} {v:.2e}" for k, v in r0["err"].items())
          + f" | all_reduce per solve {r0['all_reduce']} | launches {r0['launches']} | "
          f"ms per sharded solve (host) " + ", ".join(f"{k} {v:.3f}" for k, v in r0["ms"].items()),
          flush=True)
    for key in ("scaling", "scaling_torch"):
        print(f"[10] weak scaling (rank 0, CUDA events): " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}" for k, v in r0[key].items()),
            flush=True)
    for r, res in sorted(results.items()):
        print(f"[10] rank {r} (k_off {res['k_off']}): pass 2 on its own inputs of each sharded "
              f"solve vs plain " + ", ".join(
                  f"{k} max|d| {v['abs']:.2e} rel {v['rel']:.2e}"
                  for k, v in res["kernel_err"].items()), flush=True)
    print(f"[10] pass 2 at K_local={K // SHARD_RANKS}, rank 0 alone on the card (ms): " + ", ".join(
        f"{k} {q} {fmt_ms(v)}" for k, d in r0["timing"].items() for q, v in d.items()),
        flush=True)
    arm_k = arm.ArmMPPIParams().mppi.n_samples
    print(f"[10] the arm node sample-sharded (make_arm_solver through make_sharded_solver, "
          f"K={arm_k} as {SHARD_RANKS} x {arm_k // SHARD_RANKS}) vs the one-rank arm solve over "
          f"{N_ARM_SHARD_SOLVES} solves: " + ", ".join(
              f"rank {r} {res['arm_err']:.2e}" for r, res in sorted(results.items()))
          + f" (limit {TOL_STEP:g})", flush=True)
    if any(res["arm_err"] > TOL_STEP for res in results.values()):
        fail("the sharded arm solve disagrees with the one-rank arm solve")
    for tag in r0["flight"]:
        f = [res["flight"][tag] for _, res in sorted(results.items())]
        ms_txt = "" if f[0]["ms"] is None else f" | {f[0]['ms']:.3f} ms per sharded solve " \
            "(host, rank 0, two ranks on one card)"
        print(f"[10] F9 {tag} through make_sharded_solver (K=1024 as {SHARD_RANKS} x "
              f"{1024 // SHARD_RANKS}) vs the one-rank solve over {N_FLIGHT_SHARD_SOLVES} "
              "solves: " + ", ".join(f"rank {r} {x['err']:.2e}" for r, x in enumerate(f))
              + f" of the plan's largest entry (limit {TOL_FLIGHT_SHARD:g}) | all_reduce per "
              f"solve {[x['all_reduce'] for x in f]} | finite {all(x['finite'] for x in f)}"
              + ms_txt, flush=True)
        if any(x["err"] > TOL_FLIGHT_SHARD or x["all_reduce"] != 3 or not x["finite"]
               for x in f):
            fail(f"the sharded {tag} solve disagrees with the one-rank solve or makes other "
                 "than 3 all-reduces per solve")
    if r0["scaling"]["backend"] != "cuda" or r0["scaling_torch"]["backend"] != "torch":
        fail("measure_weak_scaling does not report the backend it was given")
    want = {"spill": 3, "no spill": 3, "adaptive sigma": 4}
    if max(r0["err"].values()) > TOL_STEP or r0["all_reduce"] != want:
        fail("the sharded solve disagrees with the one-rank solve or its collective count")
    if any(v["rel"] > TOL_UPDATE for res in results.values() for v in res["kernel_err"].values()):
        fail("a sharded pass-2 kernel disagrees with its plain version")
    if r0["launches"] != {"wb_cost": N_SHARD_SOLVES, "wb_update_shard": N_SHARD_SOLVES,
                          "wb_cost_nospill": N_SHARD_SOLVES,
                          "wb_update_shard_regen": N_SHARD_SOLVES}:
        fail(f"the sharded solve did not run through rows 1+7 and 4+6: {r0['launches']}")
    r0["kernel_err_all_ranks"] = {
        k: max(res["kernel_err"][k]["abs"] for res in results.values()) for k in r0["kernel_err"]}
    return r0


def drone_case(dev, k: int, h: int):
    """Arguments of each drone wrapper at K=k, H=h, made on the card from a
    seed: a warm start, the state, the target, a key, sigma-scaled
    explicit noise, and pass 2's weights.  The solve's own softmin of pass
    1 is one-hot at lambda = 0.1 (the two lowest costs lie ~136 apart), so
    du would be one sample's noise; these weights (a softmax of normals of
    scale 3) spread over every sample, so pass 2's whole sum is checked."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * k + h)
    u_prev = torch.randn((h, DRONE_A), generator=gen, device=dev)
    x0 = torch.tensor([0.1, -0.2, 1.0], device=dev)
    v0 = torch.tensor([0.0, 0.3, 0.0], device=dev)
    target = torch.tensor(drone.DEFAULT_TARGET, device=dev)
    keys = sampling.philox_keys(2**36 + 1000 * k + h, dev)
    noise = 30.0 * torch.randn((k, h, DRONE_A), generator=gen, device=dev)
    cost = (u_prev, x0, v0, target, keys, k, 0.01, 30.0, 100.0, 20.0)
    cost_noise = (u_prev, noise, x0, v0, target, 0.01, 100.0, 20.0)
    w = torch.softmax(3.0 * torch.randn(k, generator=gen, device=dev), dim=0)
    return {"drone_cost": cost, "drone_update": (w, keys, h, DRONE_A, 30.0),
            "drone_cost_noise": cost_noise, "drone_update_noise": (noise, w)}


def drone_work(name: str, k: int, h: int):
    """(bytes, float32 operations) of one drone kernel at K=k, H=h: each
    input read once and each output written once, the draws counted where
    the kernel draws, the noise bytes where it reads them."""
    el = k * h * DRONE_A
    small = (h * DRONE_A + 3 * DRONE_A) * 4
    return {"drone_cost": (small + k * 4 + 8, el * (DRONE_DRAW_OPS + DRONE_COST_OPS)),
            "drone_cost_noise": (small + k * 4 + el * 4, el * DRONE_COST_OPS),
            "drone_update": (k * 4 + h * DRONE_A * 4 + 8, el * (DRONE_DRAW_OPS + DRONE_UPDATE_OPS)),
            "drone_update_noise": (k * 4 + el * 4 + h * DRONE_A * 4,
                                   el * DRONE_UPDATE_OPS)}[name]


def drone_compare(name: str, args):
    """(max |d|, relative error) of a drone wrapper against its plain
    version: S relative to max(1, max|S|), du relative to max|du|."""
    got, want = getattr(dk, name)(*args), getattr(dk, name + "_plain")(*args)
    sync()
    d = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item()) if "cost" in name else want.abs().max().item()
    return d, d / scale


def drone_params(k: int):
    params = drone.DroneMPPIParams()
    return dataclasses.replace(params, mppi=dataclasses.replace(params.mppi, n_samples=k))


def drone_solve_inputs(dev):
    """The preset's first step: (step, state, obs)."""
    step, init = drone.make_drone_solver(drone_params(DRONE_K), device=dev)
    obs = drone.DroneObs(x=torch.tensor([0.1, -0.2, 1.0], device=dev),
                         v=torch.tensor([0.0, 0.3, 0.0], device=dev),
                         target=torch.tensor(drone.DEFAULT_TARGET, device=dev))
    return step, init(21), obs


def phase_drone_kernels(dev, errs):
    """Rows 9a-9d against their plain versions at every size of the sweep
    (S 1e-4, du 1e-5 on the same weights), with CUDA-event, profiler and
    plain times, bounds and the torch.mv yardstick of pass 2; the kernel
    solve against the preset's first step; host ms per solve of both at
    K=1024."""
    sweep = {}
    floor = launch_floor_ms()
    print(f"[11] launch floor (an empty kernel, graph replay): {floor:.4f} ms", flush=True)
    for k, h in DRONE_SIZES:
        case = drone_case(dev, k, h)
        rels = {}
        for name, args in case.items():
            d, rels[name] = drone_compare(name, args)
            tol = TOL_COST if "cost" in name else TOL_UPDATE
            if not rels[name] <= tol:
                fail(f"{name} at K={k}, H={h} disagrees with its plain version ({rels[name]:.2e})")
            errs[name] = max(errs.get(name, 0.0), d)
        noise, w = case["drone_update_noise"]
        flat = noise.view(k, h * DRONE_A).t()
        lib = {"ms": event_ms(lambda: torch.mv(flat, w)),
               "device_ms": device_ms(lambda: torch.mv(flat, w), "gemv"),
               "graph_ms": graph_ms(lambda: torch.mv(flat, w))}
        for name, args in case.items():
            kern, plain = getattr(dk, name), getattr(dk, name + "_plain")
            b = bound(*drone_work(name, k, h))
            sweep[(name, k, h)] = {
                "k": k, "h": h, "ms": event_ms(lambda: kern(*args)),
                "device_ms": device_ms(lambda: kern(*args), DRONE_KEYS[name]),
                "graph_ms": graph_ms(lambda: kern(*args)),
                "plain_ms": event_ms(lambda: plain(*args), reps=5), "bound_ms": b[0],
                "bound_by": b[1],
                "library_ms": lib["ms"] if "update" in name else None,
                "library_device_ms": lib["device_ms"] if "update" in name else None,
                "library_graph_ms": lib["graph_ms"] if "update" in name else None,
                **({"split": dict(zip(("tile", "column_blocks", "chunks", "k_chunk"),
                                      dk.update_split(k, h, DRONE_A)))}
                   if "update" in name else {})}
        print(f"[11] K={k} H={h}: vs plain " + ", ".join(f"{n} {r:.2e}" for n, r in rels.items())
              + " | ms (events / device / graph / plain / bound): " + ", ".join(
                  f"{n} {fmt_ms(s['ms'])}/{fmt_ms(s['device_ms'])}/{fmt_ms(s['graph_ms'])}/"
                  f"{s['plain_ms']:.3f}/{s['bound_ms']:.2e} by {s['bound_by']}"
                  for (n, kk, hh), s in sweep.items() if (kk, hh) == (k, h))
              + f" | torch.mv {lib['ms']:.4f}/{fmt_ms(lib['device_ms'])}/"
              f"{lib['graph_ms']:.4f} | drone_update (tile, column blocks, K-chunks, "
              f"samples per chunk) {dk.update_split(k, h, DRONE_A)}", flush=True)

    # The kernel solve against the preset's first step on the same seed.
    step, state, obs = drone_solve_inputs(dev)
    out, _ = step(state, obs)
    u = dk.solve_drone_cuda(state.u_prev, obs.x, obs.v, obs.target, state.seed,
                            n_samples=DRONE_K)
    sync()
    step_err = ((u - out.u_seq).abs() / (1.0 + out.u_seq.abs())).max().item()
    s_sorted = dk.drone_cost_plain(state.u_prev, obs.x, obs.v, obs.target,
                                   sampling.philox_keys(state.seed, dev), DRONE_K, 0.01, 30.0,
                                   100.0, 20.0).sort().values
    gap = (s_sorted[1] - s_sorted[0]).item()
    print(f"[11] solve_drone_cuda vs make_drone_solver's first step (K={DRONE_K}, seed "
          f"{state.seed}): {step_err:.2e} | gap between the two lowest S {gap:.4g} "
          f"(lambda 0.1)", flush=True)
    if not step_err <= TOL_DRONE_STEP:
        fail("the kernel solve disagrees with the preset's first step")

    # Host ms per solve at K=1024: the kernel solve (production mode)
    # against the preset's plain step, and where each spends the card.
    step_p, init_p = drone.make_drone_solver(drone_params(DRONE_NOISE_K), device=dev)
    st_p = init_p(3)
    keys = sampling.philox_keys(3, dev)
    u0 = st_p.u_prev

    def kernel_solve():
        return dk.solve_drone_cuda(u0, obs.x, obs.v, obs.target, keys, n_samples=DRONE_NOISE_K)

    def plain_step():
        return step_p(st_p, obs)

    host = {"kernel_solve": host_ms(kernel_solve, reps=20),
            "make_drone_solver_step": host_ms(plain_step, reps=20)}
    print(f"[11] host ms per solve at K={DRONE_NOISE_K}, H={DRONE_H}: " + ", ".join(
        f"{n} {v:.4f}" for n, v in host.items()), flush=True)
    profile_solves("[11] kernel solve", kernel_solve, 20, host["kernel_solve"])
    profile_solves("[11] make_drone_solver step", plain_step, 20, host["make_drone_solver_step"])
    return sweep, host, floor


def drone_point_mass_loop(target, n_steps: int, k: int, gen=None, seed: int = 0):
    """The kernel solve closing the point-mass loop toward ``target`` (3,)
    on the card: per step one solve (Philox, or explicit noise from
    ``gen``), the plant stepped on u[0], the distance to the target kept
    on the card.  The key tensor is this loop's own and is advanced in
    place on the card."""
    dev = target.device
    u = torch.zeros((DRONE_H, DRONE_A), device=dev)
    st = pm.PointMassState(torch.zeros(3, device=dev), torch.zeros(3, device=dev))
    keys = sampling.philox_keys(seed, dev).clone()
    errs = []
    for _ in range(n_steps):
        noise = None if gen is None else 30.0 * torch.randn((k, DRONE_H, DRONE_A), generator=gen,
                                                            device=dev)
        u = dk.solve_drone_cuda(u, st.pos, st.vel, target, keys, noise=noise, n_samples=k)
        keys.add_(1)
        st = pm.step(st, u[0], 0.01)
        errs.append(torch.linalg.norm(st.pos - target))
    return torch.stack(errs)


def reset_drone_counts() -> None:
    for f in dk.KERNEL_WRAPPERS:
        f.launches = 0


def drone_counts() -> dict:
    return {f.__name__: f.launches for f in dk.KERNEL_WRAPPERS}


def phase_drone_loops(dev):
    """(a) the kernel solve in production mode in the point-mass loop, 800
    steps at the preset; (b) the explicit-noise loop, 80 steps at K=1024;
    (c) the drone waypoint episode: the preset through make_episode with
    backstepping, 2000 control steps, each a replay of one captured control
    step, its first 100 steps against the eager loop (bit-equal).  Each
    with its gate, launch counts, host ms per step; (a) and (c) with a
    host-sync check (on the replays of (c)'s 100-step window); (c) with the
    device busy share of the graphed step."""
    target = torch.tensor(drone.DEFAULT_TARGET, device=dev)
    drone_point_mass_loop(target, 3, DRONE_K)  # warm up
    check_no_syncs("[12a]", "5 kernel-solve steps",
                   lambda: drone_point_mass_loop(target, 5, DRONE_K, seed=9))
    launches = {}
    reset_drone_counts()
    t0 = time.perf_counter()
    errs = drone_point_mass_loop(target, N_DRONE_LOOP, DRONE_K).cpu().numpy()
    ms_a = (time.perf_counter() - t0) * 1e3 / N_DRONE_LOOP
    launches["a"] = drone_counts()
    late = float(errs[300:].mean())
    print(f"[12a] kernel solve, point-mass loop, {N_DRONE_LOOP} steps at K={DRONE_K}, H={DRONE_H}: "
          f"min err {errs.min():.4f} m | mean err[300:] {late:.4f} m | {ms_a:.4f} ms/step | "
          f"launches {launches['a']}", flush=True)
    if not (errs.min() < 0.15 and late < 0.6):
        fail("the kernel-solve loop missed its gate (min err < 0.15, mean err[300:] < 0.6)")
    if launches["a"] != {"drone_cost": N_DRONE_LOOP, "drone_update": N_DRONE_LOOP,
                         "drone_cost_noise": 0, "drone_update_noise": 0}:
        fail("the kernel-solve loop did not run through rows 9a and 9b once per step")

    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    reset_drone_counts()
    t0 = time.perf_counter()
    errs_b = drone_point_mass_loop(target, N_DRONE_NOISE_LOOP, DRONE_NOISE_K,
                                   gen=gen).cpu().numpy()
    ms_b = (time.perf_counter() - t0) * 1e3 / N_DRONE_NOISE_LOOP
    launches["b"] = drone_counts()
    print(f"[12b] explicit-noise loop, {N_DRONE_NOISE_LOOP} steps at K={DRONE_NOISE_K}: err "
          f"{errs_b[0]:.4f} -> {errs_b[-1]:.4f} m | {ms_b:.4f} ms/step | launches {launches['b']}",
          flush=True)
    if not errs_b[-1] < 0.6 * errs_b[0]:
        fail("the explicit-noise loop missed its gate (errs[-1] < 0.6 errs[0])")
    if launches["b"] != {"drone_cost": 0, "drone_update": 0,
                         "drone_cost_noise": N_DRONE_NOISE_LOOP,
                         "drone_update_noise": N_DRONE_NOISE_LOOP}:
        fail("the explicit-noise loop did not run through rows 9c and 9d once per step")

    # (c) The waypoint episode of tests/test_sim.py on the card, one
    # captured control step replayed per step.
    step, init = drone.make_drone_solver(drone_params(DRONE_K), device=dev)
    cfg = cl.LoopConfig(controller="backstepping")
    veh = mr.MultirotorParams()

    def episode(n, graph=True):
        return cl.make_episode(
            cfg, veh, fc.FlightGains(), step,
            make_obs=lambda plant: drone.DroneObs(x=plant.pos, v=plant.vel, target=target),
            setpoint_of=lambda out, plant: fc.hover_setpoint(out.xdes), n_control_steps=n,
            graph=graph)

    def start(seed):
        return cl.init_loop_state(cfg, veh, init(seed), pos=(0.0, 0.0, 2.0), device=dev)

    reset_drone_counts()
    final, (pos, _, _) = episode(N_DRONE_EPISODE)(start(0))  # its capture included
    err = torch.linalg.norm(pos - target, dim=-1).cpu().numpy()
    finite = bool(torch.isfinite(pos).all())
    # The first N_DRONE_CHECKED steps graphed (replays only, timed, with the
    # host-sync check) against the eager loop.
    short_g, short_e = episode(N_DRONE_CHECKED), episode(N_DRONE_CHECKED, graph=False)
    short_g(start(1))  # capture
    (fg, lg), ms_c = synced_run("[12c]", f"the replay loop of {N_DRONE_CHECKED} control steps",
                                short_g, (start(0),), N_DRONE_CHECKED)
    (fe, le), ms_eager = timed_episode(short_e, (start(0),), N_DRONE_CHECKED)
    pairs = list(zip(lg, le)) + list(zip(fg.plant, fe.plant)) + list(zip(fg.ctrl, fe.ctrl)) \
        + [(fg.solver.u_prev, fe.solver.u_prev)]
    equal = all(torch.equal(a, b) for a, b in pairs)
    prefix = all(torch.equal(a, b[:N_DRONE_CHECKED]) for a, b in zip(lg, (pos,)))
    print(f"[12c] drone waypoint episode, {N_DRONE_EPISODE} control steps (preset K={DRONE_K}, "
          f"backstepping), CUDA graph of one control step: min err {err.min():.4f} m | mean "
          f"err[1000:] {err[1000:].mean():.4f} m | final {err[-1]:.4f} m | finite {finite} | "
          f"{ms_c:.3f} ms/control step graphed ({N_DRONE_CHECKED} replays), {ms_eager:.3f} "
          f"eager | first "
          f"{N_DRONE_CHECKED} steps: logs and final state bit-equal to the eager loop {equal}, "
          f"the long run's first {N_DRONE_CHECKED} positions equal {prefix} | solve index "
          f"{final.solver.step.tolist()} | drone kernel launches {drone_counts()}", flush=True)
    if not (finite and err.min() < 0.8 and err[1000:].mean() < 1.5):
        fail("the drone episode missed its gate (min err < 0.8, mean err[1000:] < 1.5)")
    if not equal:
        fail("the graphed drone episode is not bit-equal to the eager loop")
    window, s3 = episode(N_PROFILED), start(3)
    window(s3)  # capture
    busy = {"graphed": profile_solves("[12c] graphed", lambda: window(s3), 1, ms_c * N_PROFILED,
                                      unit=f"{N_PROFILED} control steps"), "eager": None}
    return launches, {"a": ms_a, "b": ms_b, "c": ms_c, "c_eager": ms_eager}, busy


def phase_drone_batch(dev):
    """(d) The batched drone preset: ``make_drone_solver(n_scenarios=256)``
    at K=1000, H=32 on the Philox stream, each scenario with its own
    position and velocity; four scenarios against their unbatched solves
    under their keys over three steps; host ms per batched solve."""
    params = drone_params(DRONE_K)
    step, init = drone.make_drone_solver(params, device=dev, n_scenarios=B_DRONE)
    step1, init1 = drone.make_drone_solver(params, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    x = torch.tensor([0.1, -0.2, 1.0], device=dev) + 0.3 * torch.randn(
        (B_DRONE, DRONE_A), generator=gen, device=dev)
    v = 0.2 * torch.randn((B_DRONE, DRONE_A), generator=gen, device=dev)
    target = torch.tensor(drone.DEFAULT_TARGET, device=dev).expand(B_DRONE, DRONE_A).contiguous()
    obs = drone.DroneObs(x=x, v=v, target=target)
    state = init(12)
    keys = sampling.key_list(state.seed)
    singles = {b: init1(keys[b]) for b in CHECK_SCENARIOS}
    err = 0.0
    for _ in range(N_DRONE_BATCH_STEPS):
        out, state = step(state, obs)
        for b in CHECK_SCENARIOS:
            one, singles[b] = step1(singles[b], drone.DroneObs(x=x[b], v=v[b], target=target[b]))
            err = max(err, rel_err(out.u_seq[b], one.u_seq), rel_err(out.xdes[b], one.xdes))
    finite = bool(torch.isfinite(out.u_seq).all())
    ms = host_ms(lambda: step(state, obs), reps=10)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[12d] batched drone preset, B={B_DRONE} x K={DRONE_K} x H={DRONE_H}: scenarios "
          f"{CHECK_SCENARIOS} vs their unbatched solves over {N_DRONE_BATCH_STEPS} steps, max rel "
          f"{err:.2e} (limit {TOL_BATCH:g}) | finite {finite} | u_seq {tuple(out.u_seq.shape)} | "
          f"{ms:.3f} ms per batched solve (host) = {B_DRONE / ms * 1e3:.0f} solves/s | peak "
          f"{peak:.2f} GiB since start", flush=True)
    if not (finite and err <= TOL_BATCH):
        fail("the batched drone preset disagrees with its unbatched solves")
    return ms


def arm_episode(params, dev, n, graph=True):
    """(run, start): the arm node's episode of ``n`` control steps at
    ``params`` and its rest start for a seed."""
    _, init = arm.make_arm_solver(params, device=dev)
    run = arm_loop.make_arm_episode(params=params, n_control_steps=n, device=dev, graph=graph)
    return run, lambda seed: arm_loop.init_arm_loop(init(seed), device=dev)


def arm_obs(dev) -> "arm.ArmObs":
    """The arm node's observation near home (phases 10 and 16)."""
    return arm.ArmObs(q=torch.tensor(kinova.Q_HOME, dtype=torch.float32, device=dev) + 0.02,
                      qdot=torch.full((7,), 0.05, device=dev),
                      base_pose=Pose(torch.tensor([0.0, 0.0, 2.1], device=dev),
                                     torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)),
                      target=arm.default_target(device=dev))


def phase_arm(dev) -> dict:
    """The arm node at its preset (K=100, H=32, A=7): (a) 50 solves of
    ``make_arm_solver`` replayed from one captured solve against the eager
    solves, bit for bit; (b) ``run_arm_reach`` (graphed) for 800 steps on
    seeds 0-2, MPPI engaged and the commanded EE within 0.10 m at its best;
    (c) host ms per control step graphed and eager, no host sync in the
    replay loop, the device busy share; (d) a checkpoint written at step 400
    and restored: the next 10 control steps bit-equal to those of a 410-step
    run from the same seed."""
    params = arm.ArmMPPIParams()
    step, init = arm.make_arm_solver(params, device=dev)
    obs = arm_obs(dev)

    def solve_in_place(state, obs):
        out, new = step(state, obs)
        graphs.copy_into(state, new)
        return out

    load = graphs.graphed(solve_in_place, dev)
    g = load(mppi.device_counters(init(5), dev), obs)
    eager_state, equal = init(5), True
    for _ in range(N_ARM_SOLVES):
        out_g = g.replay()
        out_e, eager_state = step(eager_state, obs)
        equal = equal and all(torch.equal(a, b) for a, b in zip(out_g, out_e))
    equal = equal and torch.equal(g.args[0].u_prev, eager_state.u_prev)
    print(f"[16a] arm solves (K={params.mppi.n_samples}, H={params.mppi.n_horizon}, A=7), "
          f"{N_ARM_SOLVES} replays of one captured solve: outputs and warm start bit-equal to the "
          f"eager solves {equal} | solve index {g.args[0].step.tolist()}", flush=True)
    if not equal:
        fail("the graphed arm solve is not bit-equal to the eager solve")

    reach = {}
    t0 = time.perf_counter()
    for seed in ARM_SEEDS:
        reach[seed] = run_arm_reach(seed, N_ARM_STEPS, device=dev)
    reach_ms = (time.perf_counter() - t0) * 1e3 / (N_ARM_STEPS * len(ARM_SEEDS))
    print(f"[16b] run_arm_reach, {N_ARM_STEPS} steps (graphed, capture included, "
          f"{reach_ms:.3f} ms/control step): " + " | ".join(
              f"seed {s}: phase2 {r['phase2']}, min_ee_err {r['min_ee_err_m']:.4f} m, final "
              f"{r['final_ee_err_m']:.4f} m" for s, r in reach.items())
          + " | JAX package, CPU, seeds 0-2: min 0.0456/0.0546/0.0551, final 0.365/0.381/0.392",
          flush=True)
    missed = [s for s, r in reach.items() if not (r["phase2"] and r["min_ee_err_m"] < 0.10)]
    if missed:
        fail(f"the arm node missed its gate (MPPI engaged, min EE error < 0.10 m) on seeds "
             f"{missed}")

    run, start = arm_episode(params, dev, N_ARM_UNINTERRUPTED)
    _, logs_w = run(start(0))  # the uninterrupted run of (d), its capture included
    timed, _ = arm_episode(params, dev, N_ARM_TIMED)
    timed(start(1))  # capture
    _, ms_g = synced_run("[16c]", f"the replay loop of {N_ARM_TIMED} arm control steps", timed,
                         (start(0),), N_ARM_TIMED)
    run_e, _ = arm_episode(params, dev, N_ARM_EAGER, graph=False)
    run_e(start(0))  # warm up
    _, ms_e = timed_episode(run_e, (start(0),), N_ARM_EAGER)
    (window, _), s3 = arm_episode(params, dev, N_PROFILED), start(3)
    window(s3)  # capture
    busy = {"graphed": profile_solves("[16c] graphed", lambda: window(s3), 1, ms_g * N_PROFILED,
                                      unit=f"{N_PROFILED} control steps"), "eager": None}
    print(f"[16c] arm control step: {ms_g:.3f} ms graphed ({N_ARM_TIMED} steps), {ms_e:.3f} ms "
          f"eager ({N_ARM_EAGER} steps)", flush=True)

    # The 410-step run from seed 0 is the uninterrupted run.
    first, _ = arm_episode(params, dev, N_ARM_CHECKPOINT)
    rest, _ = arm_episode(params, dev, N_ARM_RESUMED)
    mid, _ = first(start(0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "arm_checkpoint.npz")
        checkpoint.save(path, mid)
        restored = checkpoint.restore(path, start(0), device=dev)
    _, logs_r = rest(restored)
    end = N_ARM_CHECKPOINT + N_ARM_RESUMED
    resumed = all(torch.equal(a, b[N_ARM_CHECKPOINT:end]) for a, b in zip(logs_r, logs_w))
    print(f"[16d] checkpoint at step {N_ARM_CHECKPOINT} (phase2 {bool(mid.phase2)}, solve index "
          f"{mid.solver.step.tolist()}) restored: the next {N_ARM_RESUMED} control steps (q, "
          f"ee_err, tau) bit-equal to the uninterrupted run {resumed}", flush=True)
    if not (resumed and bool(mid.phase2)):
        fail("the resumed arm episode is not bit-equal to the uninterrupted run")
    return {"graphed_ms": ms_g, "eager_ms": ms_e, "busy": busy, "reach": reach}


PICK_STAGES = ("approach", "descent", "lift")


def pick_params(n_samples: int):
    """The pick_weight solver: position mode, H=50, the stand as a sphere
    obstacle under the grasp point (as ``run_pick_weight`` builds it)."""
    params = wb.position_mode_params(n_samples=n_samples, n_horizon=H)
    grasp = wb.default_obs(device="cpu").ee_target.position.tolist()
    return dataclasses.replace(params, cost=dataclasses.replace(
        params.cost, obstacle_weight=100.0,
        obstacle_centers=((grasp[0], grasp[1], grasp[2] - 0.35),), obstacle_radii=(0.25,)))


STAND_DEPTH = 0.05  # m: the end effector's start below the top of the stand's sphere


def stand_obs(params, dev):
    """The default observation with the base moved so that the end
    effector at the home pose starts STAND_DEPTH inside the top of the
    stand's sphere: a rollout's steps inside it and outside it both
    count, the first through the penetration, the second through its
    clamp at zero."""
    obs = wb.default_obs(device=dev)
    st = obs.state
    ee, _ = chain_mod.forward_kinematics_posquat(
        params.model.chain(), st.q, base_pos=st.base.pos,
        base_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
    top = torch.tensor(params.cost.obstacle_centers[0], device=dev)
    top[2] += params.cost.obstacle_radii[0] - STAND_DEPTH
    return obs._replace(state=st._replace(base=st.base._replace(pos=st.base.pos + top - ee)))


def pick_kernels(dev, errs) -> dict:
    """``wb_cost`` (row 1: position mode, the stand as one sphere obstacle,
    Philox draw and spill) and ``wb_update`` (row 3) at the pick_weight
    solver's K=256 and K=4096, against their plain versions on the same
    draws, from :func:`stand_obs`: S within TOL_COST, du and m2 within
    TOL_UPDATE, the spill bit-equal to the plain draw, and the obstacle
    term alone (S with it less S without, each side) within TOL_OBSTACLE of
    its largest value, nonzero on some samples."""
    res = {}
    for k in (PICK_K, K):
        params = pick_params(k)
        free = dataclasses.replace(params, cost=dataclasses.replace(params.cost,
                                                                    obstacle_weight=0.0))
        kc, kc_free = wk.make_kernel_config(params), wk.make_kernel_config(free)
        _, init = wb.make_whole_body_solver(params, device=dev)
        state, obs = init(7), stand_obs(params, dev)
        sigma = state.sigma
        if params.mppi.sigma_scale_fn is not None:
            sigma = sigma * params.mppi.sigma_scale_fn(obs)
        sc, u_prev = wk.pack_scalars(obs, sigma), state.u_prev.contiguous()
        seeds, step = wk.philox_keys(state.seed, dev), 3
        s_k, m_k, e_k, eps = wk.wb_cost(kc, sc, u_prev, None, seeds, step)
        s_p, _, _, eps_p = wk.wb_cost_plain(kc, sc, u_prev, None, seeds, step)
        s_free = wk.wb_cost_plain(kc_free, sc, u_prev, None, seeds, step)[0]
        s_k_free = wk.wb_cost(kc_free, sc, u_prev, None, seeds, step)[0]
        du_k, m2_k = wk.wb_update(kc, eps, s_k, m_k, e_k)
        du_p, m2_p = wk.wb_update_plain(kc, eps, s_k, m_k, e_k)
        sync()
        abs_s = (s_k - s_p).abs().max().item()
        rel_s = rel_err(s_k, s_p)
        abs_du = max((du_k - du_p).abs().max().item(), (m2_k - m2_p).abs().max().item())
        rel_du = max((du_k - du_p).abs().max().item() / du_p.abs().max().item(),
                     (m2_k - m2_p).abs().max().item() / m2_p.abs().max().item())
        spill_eq = torch.equal(eps, eps_p)
        obstacle = s_p - s_free
        hit = int((obstacle > 0).sum().item())
        rel_obs = ((s_k - s_k_free) - obstacle).abs().max().item() / max(
            obstacle.abs().max().item(), 1e-30)
        print(f"[17c] pick_weight solver K={k}, H={H}, position mode, stand obstacle: wb_cost "
              f"max|dS| {abs_s:.3e} (rel {rel_s:.2e}, limit {TOL_COST:g}) | wb_update rel "
              f"{rel_du:.2e} (limit {TOL_UPDATE:g}) | spill == plain draw {spill_eq} | obstacle "
              f"term on {hit} of {k} samples, max {obstacle.max().item():.3e} of S max "
              f"{s_p.max().item():.3e}, kernel vs plain rel {rel_obs:.2e} (limit "
              f"{TOL_OBSTACLE:g})", flush=True)
        if not (rel_s <= TOL_COST and rel_du <= TOL_UPDATE and spill_eq
                and rel_obs <= TOL_OBSTACLE):
            fail(f"wb_cost or wb_update at the pick_weight solver (K={k}) disagrees with its "
                 "plain version")
        if not 0 < hit:
            fail(f"the stand obstacle is on no sample at K={k}: the check does not hold it")
        errs["wb_cost"] = max(errs["wb_cost"], abs_s)
        errs["wb_update"] = max(errs["wb_update"], abs_du)
        res[k] = {"rel_s": rel_s, "rel_du": rel_du, "rel_obstacle": rel_obs,
                  "obstacle_samples": hit}
    return res


def phase_pick(dev, errs) -> dict:
    """The pick_weight task: (a) ``run_pick_weight`` at K=256, H=50, 700
    steps on seeds 0-2 with the gates of tests/test_cli.py, the kernel
    launches per control step and the host ms per control step of each
    stage (first and replay-only runs, seed 0); (b) at K=4096: the
    graspable approach, 100 steps, graphed against eager (bit-equal); the
    payload lift on the serving configuration, 200 steps, graphed against
    eager (bit-equal), rows 1, 3 and 8 launched once per step; (c)
    ``wb_cost`` and ``wb_update`` at the path's configurations against
    their plain versions (:func:`pick_kernels`); (d) ``plant_tick`` with
    the payload's frozen coefficients and mass against its plain version at
    B=1 and B=1024."""
    results, stages = {}, None
    for seed in PICK_SEEDS:
        reset_counts()
        timed = seed == PICK_TIMED_SEED
        if timed:
            stages = {}
        t0 = time.perf_counter()
        results[seed] = run_pick_weight(seed, N_PICK_STEPS, n_samples=PICK_K, device=dev,
                                        stage_ms=stages if timed else None)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches}
        r = results[seed]
        print(f"[17a] pick_weight seed {seed} (K={PICK_K}, H={H}, {N_PICK_STEPS} steps): "
              + ", ".join(f"{k} {v}" for k, v in r.items())
              + (" | ms/control step (each stage's capture included): "
                 + ", ".join(f"{k} {stages[k]:.3f}" for k in PICK_STAGES)
                 if timed else f" | {wall_ms / N_PICK_STEPS:.3f} ms/control step over the "
                 "scenario (3 captures included)")
              + f" | launches {launches}", flush=True)
        # Three episodes (approach, descent, lift), each capture making two
        # warm-up calls before its replays.
        want = N_PICK_STEPS + 3 * 2
        if launches != {"wb_cost": want, "wb_update": want}:
            fail(f"pick_weight seed {seed} did not run wb_cost and wb_update once per control "
                 f"step ({want - 6} steps + 6 warm-up calls)")
    print("[17a] JAX package, CPU, seeds 0-2: grasp_hold_err_m 0.0303/0.0316/0.0320, "
          "lift_min_err_m 0.0569/0.0382/0.0046, max_tilt_rad 0.022/0.021/0.022", flush=True)
    missed = [s for s, r in results.items()
              if not (r["grasped"] and r["grasp_hold_err_m"] < 0.05 and r["lift_min_err_m"] < 0.15
                      and r["max_tilt_rad"] < 0.1)]
    if missed:
        fail(f"pick_weight missed its gates (grasped, hold < 0.05, lift min < 0.15, tilt < 0.1) "
             f"on seeds {missed}")

    # (b) At full width: the graspable approach.
    params = pick_params(K)
    obs = wb.default_obs(device=dev)
    grasp = obs.ee_target.position.tolist()
    gp = gr.GraspableParams(mass=0.5, stand_center_xy=(grasp[0], grasp[1]),
                            stand_top_z=grasp[2] - 0.04)
    pregrasp = Pose(obs.ee_target.position + torch.tensor([0.0, 0.0, 0.12], device=dev),
                    obs.ee_target.quat)
    _, init = wb.make_whole_body_solver(params, device=dev)

    def approach_start(seed):
        return (wbl.init_plant(params.model.vehicle, device=dev), init(seed), pregrasp,
                obs.base_target, gr.init_graspable(gp, pos=grasp, device=dev))

    out = {}
    runs = [wbl.make_whole_body_episode(params, n_control_steps=N_PICK_WIDE, graspable=gp,
                                        device=dev, graph=g) for g in (True, False)]
    runs[0](*approach_start(1))  # capture
    (ga, eg_a), out["approach_ms"] = timed_episode(runs[0], approach_start(0), N_PICK_WIDE)
    (ea, ee_a), out["approach_eager_ms"] = timed_episode(runs[1], approach_start(0), N_PICK_WIDE)
    eq_a = all(torch.equal(a, b) for a, b in zip(eg_a, ee_a)) \
        and torch.equal(pk.pack_plant(ga[0]), pk.pack_plant(ea[0])) \
        and all(torch.equal(a, b) for a, b in zip(ga[4], ea[4]))
    print(f"[17b] graspable approach, K={K}, H={H}, {N_PICK_WIDE} steps: {out['approach_ms']:.3f} "
          f"ms/control step graphed, {out['approach_eager_ms']:.3f} eager | logs, final plant and "
          f"object bit-equal {eq_a} | final ee_err {eg_a.ee_err[-1].item():.4f} m, object moved "
          f"{(eg_a.obj_pos[-1] - eg_a.obj_pos[0]).norm().item():.2e} m", flush=True)
    if not eq_a:
        fail("the graphed graspable approach is not bit-equal to the eager loop")

    # The payload lift on the serving configuration (plant_tick).
    lump = params.model.arm_mass_lump
    params2 = dataclasses.replace(params, model=dataclasses.replace(
        params.model, arm_mass_lump=lump + 0.5))
    loop = wbl.WholeBodyLoopConfig(payload_mass=0.5, plant_arm_lump=lump, **SERVING_LOOP)
    lift = Pose(obs.ee_target.position + torch.tensor([0.0, 0.0, 0.4], device=dev),
                obs.ee_target.quat)
    _, init2 = wb.make_whole_body_solver(params2, device=dev)

    def lift_start(seed):
        return wbl.init_plant(params.model.vehicle, device=dev), init2(seed), lift, obs.base_target

    runs = [wbl.make_whole_body_episode(params2, cfg=loop, n_control_steps=N_PICK_LIFT,
                                        device=dev, graph=g) for g in (True, False)]
    runs[0](*lift_start(1))  # capture
    reset_counts()
    pk.plant_tick.launches = 0
    (gl, lg), out["lift_ms"] = timed_episode(runs[0], lift_start(0), N_PICK_LIFT)
    out["lift_launches"] = count_episode_launches()
    (el, le), out["lift_eager_ms"] = timed_episode(runs[1], lift_start(0), N_PICK_LIFT)
    eq_l = all(torch.equal(a, b) for a, b in zip(lg, le)) \
        and torch.equal(pk.pack_plant(gl[0]), pk.pack_plant(el[0]))
    print(f"[17b] payload lift, serving configuration (plant_tick), K={K}, {N_PICK_LIFT} steps: "
          f"{out['lift_ms']:.3f} ms/control step graphed, {out['lift_eager_ms']:.3f} eager | "
          f"launches {out['lift_launches']} | logs and final plant bit-equal {eq_l} | ee_err "
          f"min {lg.ee_err.min().item():.4f} m, tilt max {lg.tilt.max().item():.4f} rad",
          flush=True)
    if out["lift_launches"] != dict.fromkeys(("wb_cost", "wb_update", "plant_tick"), N_PICK_LIFT):
        fail("the payload lift did not run rows 1, 3 and 8 once per control step")
    if not (eq_l and bool(torch.isfinite(lg.ee_err).all())):
        fail("the graphed payload lift is not bit-equal to the eager loop")

    # (c) The path's kernels against their plain versions.
    out["kernel_errs"] = pick_kernels(dev, errs)
    m = params.model
    heavy = wbl.payload_inertials(m.inertials(), 0.5)
    pc = pk.make_plant_config(m.vehicle, fc.FlightGains(), m.chain(), extra_mass=lump + 0.5)
    worst = 0.0
    for rows in (1, 1024):
        args = pk.sample_rows(m.vehicle, m.chain(), heavy, rows, seed=4, device=dev,
                              extra_mass=lump + 0.5)
        got, want = pk.plant_tick(pc, *args), pk.plant_tick_plain(pc, *args)
        sync()
        d = (got - want).abs().max().item()
        worst = max(worst, d)
        print(f"[17d] plant_tick with the payload (link 7 {heavy.mass[-1]:.2f} kg, base "
              f"+{lump + 0.5:.2f} kg) B={rows}: max|d| {d:.2e} (limit {TOL_PLANT:g}) | finite "
              f"{bool(torch.isfinite(got).all())}", flush=True)
        if not (d <= TOL_PLANT and bool(torch.isfinite(got).all())):
            fail(f"plant_tick with the payload disagrees with its plain version at B={rows}")
    errs["plant_tick"] = max(errs["plant_tick"], worst)
    out.update(results=results, stages=stages, payload_err=worst)
    return out


def trees_equal(a, b) -> bool:
    """Every tensor of two pytrees bit-equal."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(trees_equal(x, y) for x, y in zip(a, b))


def graphed_solves(tag: str, step, state, obs, n: int, dev) -> None:
    """``n`` replays of one captured solve of ``step`` against ``n`` eager
    solves from the same state: outputs and warm start bit-equal."""
    def solve_in_place(state, obs):
        out, new = step(state, obs)
        graphs.copy_into(state, new)
        return out

    g = graphs.graphed(solve_in_place, dev)(mppi.device_counters(state, dev), obs)
    eager, equal = state, True
    for _ in range(n):
        out_g = g.replay()
        out_e, eager = step(eager, obs)
        equal = equal and trees_equal(out_g, out_e)
    equal = equal and torch.equal(g.args[0].u_prev, eager.u_prev)
    print(f"{tag} {n} replays of one captured solve: outputs and warm start bit-equal to the "
          f"eager solves {equal} | solve index {g.args[0].step.tolist()}", flush=True)
    if not equal:
        fail(f"{tag}: the graphed solve is not bit-equal to the eager solve")


def graphed_equals_eager(tag: str, build, n: int, seed: int = 0) -> tuple:
    """An episode of ``n`` steps graphed and eager (``build(n, graph) ->
    (run, start)``): logs and every field of the final carry bit-equal.
    Returns the graphed (final carry, logs) and the eager run's host ms per
    control step (the graphed run first: the eager one finds every cache
    warm)."""
    outs = []
    for graph in (True, False):
        run, start = build(n, graph)
        out, eager_ms = timed_episode(run, (start(seed),), n)
        outs.append(out)
    (fg, lg), (fe, le) = outs
    equal, finite = trees_equal((fg, lg), (fe, le)), all(bool(torch.isfinite(x).all()) for x in lg)
    print(f"{tag} {n} control steps graphed against eager: logs and final state bit-equal "
          f"{equal} | finite logs {finite} | {eager_ms:.3f} ms/control step eager", flush=True)
    if not (equal and finite):
        fail(f"{tag}: the graphed episode is not bit-equal to the eager loop")
    return outs[0], eager_ms


def scenario_times(tag: str, build, n_graphed: int, eager_ms=None, seed: int = 0) -> dict:
    """Host ms per control step of a scenario episode (``build(n, graph) ->
    (run, start)``): graphed over ``n_graphed`` replays (capture excluded)
    with the host-sync check on the replay loop; eager over
    ``N_SCENARIO_EAGER`` steps unless ``eager_ms`` is given; and a profile
    of a graphed ``N_PROFILED``-step window (device ops per step, busy
    share; the eager step launches the same ops)."""
    run, start = build(n_graphed, True)
    run(start(1))  # capture, then a first run
    _, ms_g = synced_run(tag, f"the replay loop of {n_graphed} control steps", run,
                         (start(seed),), n_graphed)
    if eager_ms is None:
        warm, _ = build(2, False)
        warm(start(1))
        run_e, _ = build(N_SCENARIO_EAGER, False)
        _, eager_ms = timed_episode(run_e, (start(seed),), N_SCENARIO_EAGER)
    window, _ = build(N_PROFILED, True)
    s3 = start(3)
    window(s3)  # capture
    busy = profile_solves(f"{tag} graphed", lambda: window(s3), 1, ms_g * N_PROFILED,
                          unit=f"{N_PROFILED} control steps")
    out = {"graphed_ms": ms_g, "eager_ms": eager_ms,
           "graphed_ops": None if busy is None else busy[2] / N_PROFILED,
           "graphed_busy": None if busy is None else busy[3]}
    print(f"{tag} control step: {ms_g:.3f} ms graphed ({n_graphed} steps), {eager_ms:.3f} ms "
          f"eager | device ops/step {fmt_ops(out['graphed_ops'])}", flush=True)
    return out


def fmt_ops(v) -> str:
    return "not measured" if v is None else f"{v:.0f}"


def phase_multirotor(dev) -> dict:
    """The multirotor preset (K=1024, H=30, A=4) and the perfect-model
    loops: (a) 20 replays of one captured solve bit-equal to the eager
    solves; (b) tests/test_multirotor_mppi.py's loops at the preset, seed
    0: hover 300 steps (max error < 0.5 m), ``run_multirotor_waypoint``
    500 steps (min < 0.4 m, final < 1.0 m); (c) 20 graphed steps bit-equal
    to eager, ms per control step graphed and eager, no host sync in the
    replay loop, device ops per step; (d) ``run_whole_body`` (K=4096, H=50,
    attitude mode, rows 1 and 3) 80 steps with tests/test_cli.py's gates,
    each kernel launched once per step."""
    params = mm.MultirotorMPPIParams()
    step, init = mm.make_multirotor_solver(params, device=dev)
    state = tilted_multirotor(dev)
    graphed_solves(f"[18a] multirotor solves (K={params.mppi.n_samples}, "
                   f"H={params.mppi.n_horizon}, A=4),", step, init(5),
                   mm.MultirotorObs(state=state, target=torch.tensor(MR_WAYPOINT, device=dev)),
                   N_MR_SOLVES, dev)

    def build(target):
        return lambda n, graph: scenarios.multirotor_episode(params, target, n, dev, graph)

    run, start = build((0.0, 0.0, 2.0))(N_MR_HOVER, True)
    _, (hover,) = run(start(0))
    way = scenarios.run_multirotor_waypoint(0, N_MR_WAYPOINT, dev)
    print(f"[18b] multirotor hover, {N_MR_HOVER} steps: max err {hover.max().item():.4f} m "
          f"(gate 0.5), finite {bool(torch.isfinite(hover).all())} | run_multirotor_waypoint, "
          f"{N_MR_WAYPOINT} steps: min {way['min_err_m']:.4f} m (gate 0.4), final "
          f"{way['final_err_m']:.4f} m (gate 1.0)", flush=True)
    if not (bool(torch.isfinite(hover).all()) and hover.max().item() < 0.5
            and way["min_err_m"] < 0.4 and way["final_err_m"] < 1.0):
        fail("the multirotor preset missed tests/test_multirotor_mppi.py's gates")
    _, eager_ms = graphed_equals_eager("[18c] multirotor waypoint loop,", build(MR_WAYPOINT),
                                       N_SCENARIO_CHECKED)
    out = scenario_times("[18c] multirotor", build(MR_WAYPOINT), N_MR_WAYPOINT, eager_ms)

    reset_counts()
    pk.plant_tick.launches = 0
    t0 = time.perf_counter()
    wbr = scenarios.run_whole_body(0, N_WB_PERFECT, dev)
    wall = (time.perf_counter() - t0) * 1e3 / N_WB_PERFECT
    out["whole_body_launches"] = count_episode_launches()
    out["whole_body_ms"] = wall
    print(f"[18d] run_whole_body (K={K}, H={H}, attitude mode), {N_WB_PERFECT} steps: "
          + ", ".join(f"{k} {v}" for k, v in wbr.items())
          + f" | {wall:.3f} ms/control step (capture included) | launches "
          f"{out['whole_body_launches']}", flush=True)
    # One capture: two warm-up calls, then one launch of each kernel per replay.
    want = {"wb_cost": N_WB_PERFECT + 2, "wb_update": N_WB_PERFECT + 2, "plant_tick": 0}
    if out["whole_body_launches"] != want:
        fail(f"run_whole_body did not launch rows 1 and 3 once per control step ({want})")
    if not (wbr["min_ee_err_m"] < 0.75 * wbr["initial_ee_err_m"]
            and abs(wbr["base_alt_final_m"] - 2.1) < 0.8):
        fail("run_whole_body missed tests/test_cli.py's gates (min EE error < 0.75 x initial, "
             "|final altitude - 2.1| < 0.8)")
    out.update(hover_max=hover.max().item(), waypoint=way, whole_body=wbr)
    return out


def tilted_multirotor(dev) -> Multirotor12State:
    """A tilted, moving multirotor state for the solve checks."""
    return Multirotor12State(pos=torch.tensor([0.3, -0.2, 2.1], device=dev),
                             rpy=torch.tensor([0.05, -0.03, 0.2], device=dev),
                             vel=torch.tensor([0.2, 0.1, -0.05], device=dev),
                             omega=torch.tensor([0.1, -0.05, 0.02], device=dev))


def phase_fixed_wing(dev) -> dict:
    """The fixed-wing flyby at K=1024 (run.py's default), H=40: (a)
    ``run_fixed_wing`` 400 steps, seed 0, with tests/test_cli.py's gates;
    (b) 20 graphed steps bit-equal to eager; (c) ms per control step
    graphed and eager, no host sync in the replay loop, device ops per
    step (a solve's 40-step rollout is a Python loop captured whole)."""
    t0 = time.perf_counter()
    r = scenarios.run_fixed_wing(0, N_FW_STEPS, dev)
    wall = (time.perf_counter() - t0) * 1e3 / N_FW_STEPS
    print(f"[19a] run_fixed_wing (K=1024, H=40), {N_FW_STEPS} steps: "
          + ", ".join(f"{k} {v}" for k, v in r.items())
          + f" | {wall:.3f} ms/control step (capture included) | JAX package, CPU, K=192: the "
          "gates of tests/test_cli.py", flush=True)
    if not (r["reached"] and r["closest_approach_m"] < 20.0 and r["min_altitude_m"] > 80.0
            and 10.0 < r["mean_speed_ms"] < 25.0):
        fail("the fixed-wing flyby missed tests/test_cli.py's gates (reached, closest < 20 m, "
             "min altitude > 80 m, 10 < mean speed < 25 m/s)")
    params = fws.FwMPPIParams()

    def build(n, graph):
        return scenarios.fixed_wing_episode(params, n, dev, graph)

    _, eager_ms = graphed_equals_eager("[19b] fixed-wing flyby,", build, N_SCENARIO_CHECKED)
    out = scenario_times("[19c] fixed-wing", build, N_FW_TIMED, eager_ms)
    out.update(result=r, wall_ms=wall)
    return out


def phase_mapped(dev) -> dict:
    """Mapped flight (lidar -> occupancy grid -> map-aware MPPI ->
    backstepping): (a) ``run_mapped_flight`` at K=512, 3000 steps, seed 0,
    sphere and ESDF mode, with tests/test_cli.py's gates; (b) the first 100
    steps graphed bit-equal to eager in both modes (logs, plant, grid,
    solver state, noise counters); (c) at the serving shape K=1024: ms per
    control step graphed and eager, no host sync in the replay loop, device
    ops per step and busy share; (d) ``occupied_centers`` on the card
    against the CPU, index for index, on a grid with more tied voxels than
    slots and on a flown grid; (e) a state saved at step 1500 and resumed:
    the next 10 steps bit-equal to the uninterrupted run's."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        logs = {}
        for mode in ("spheres", "esdf"):
            t0 = time.perf_counter()
            logs[mode] = {}
            r = scenarios.run_mapped_flight(0, N_MAPPED_STEPS, dev, MAPPED_K, mode,
                                            logs=logs[mode])
            wall = (time.perf_counter() - t0) * 1e3 / N_MAPPED_STEPS
            print(f"[20a] run_mapped_flight ({mode}, K={MAPPED_K}), {N_MAPPED_STEPS} steps: "
                  + ", ".join(f"{k} {v}" for k, v in r.items())
                  + f" | {wall:.3f} ms/control step (capture included)", flush=True)
            ok = r["reached"] and not r["collided"] and r["min_clearance_m"] > 0.1
            if mode == "spheres":
                ok = ok and r["final_dist_m"] < 0.6 and r["mapped_occupied_voxels"] > 20
            if not ok:
                fail(f"mapped flight ({mode}) missed tests/test_cli.py's gates")
            out[mode] = dict(r, wall_ms=wall)

        flown = None
        for mode in ("spheres", "esdf"):
            (final, _), _ = graphed_equals_eager(
                f"[20b] mapped flight ({mode}, K={MAPPED_K}),",
                lambda n, graph: scenarios.mapped_flight_episode(n, dev, MAPPED_K, mode, graph),
                N_MAPPED_CHECKED)
            flown = flown if flown is not None else final.grid

        for mode in ("spheres", "esdf"):
            out[f"serving_{mode}"] = scenario_times(
                f"[20c] mapped flight ({mode}, K={MAPPED_SERVING_K})",
                lambda n, graph: scenarios.mapped_flight_episode(n, dev, MAPPED_SERVING_K, mode,
                                                                 graph),
                N_MAPPED_TIMED)

        p = mapped_loop.MappedFlightConfig().grid
        gen = torch.Generator(device=dev).manual_seed(5)
        pick = torch.randint(0, 3, tuple(p.shape), generator=gen, device=dev)
        lo = torch.tensor([0.0, occ.LOG_ODDS_MISS, occ.LOG_ODDS_MIN], device=dev)[pick]
        flat = lo.view(-1)
        flat[torch.randperm(flat.numel(), generator=gen, device=dev)[:100]] = occ.LOG_ODDS_MAX
        tied = int((flat == occ.LOG_ODDS_MAX).sum())
        same = True
        for grid in (occ.OccupancyGrid(lo), flown):
            c, r = occ.occupied_centers(p, grid)
            cc, rc = occ.occupied_centers(p, occ.OccupancyGrid(grid.log_odds.cpu()))
            same = same and torch.equal(c.cpu(), cc) and torch.equal(r.cpu(), rc)
        print(f"[20d] occupied_centers on the card against the CPU, index for index: {same} "
              f"({tied} voxels tied at the clamp for 64 slots; the grid flown in [20b])",
              flush=True)
        if not same:
            fail("occupied_centers on the card differs from the CPU")

        ck, d = os.path.join(tmp, "mapped_ck.npz"), {}
        scenarios.run_mapped_flight(0, N_MAPPED_SAVE, dev, MAPPED_K, "spheres", save_state=ck)
        scenarios.run_mapped_flight(0, N_MAPPED_RESUMED, dev, MAPPED_K, "spheres", resume=ck,
                                    logs=d)
        end = N_MAPPED_SAVE + N_MAPPED_RESUMED
        resumed = all((d[k] == logs["spheres"][k][N_MAPPED_SAVE:end]).all()
                      for k in ("pos", "clearance"))
        print(f"[20e] mapped flight saved at step {N_MAPPED_SAVE} and resumed: the next "
              f"{N_MAPPED_RESUMED} steps (pos, clearance) bit-equal to the uninterrupted run "
              f"{resumed}", flush=True)
        if not resumed:
            fail("the resumed mapped flight is not bit-equal to the uninterrupted run")
    return out


def refused_configs() -> dict:
    """The whole-body configurations the kernels refuse, at full width:
    the wrench preset with the sequential rollout, and the serving preset
    (attitude) with zero-mean noise and the euler orientation metric."""
    wrench, serving_p = wb.wrench_mode_params(), wb.WholeBodyMPPIParams()
    return {
        "wrench, sequential rollout": dataclasses.replace(
            wrench, model=dataclasses.replace(wrench.model, time_parallel=False)),
        "attitude, zero-mean noise, euler_zyx": dataclasses.replace(
            serving_p, mppi=dataclasses.replace(serving_p.mppi, zero_mean_noise=True),
            cost=dataclasses.replace(serving_p.cost, ori_mode="euler_zyx")),
    }


def phase_plain(dev) -> dict:
    """F6 and F7: the plain whole-body pipeline (``backend="torch"``) on the
    card, K=4096, H=50, in each configuration the kernels refuse: (a) one
    solve on explicit normals against the same solve on the CPU (u_seq
    within 2e-4 of its largest entry), the default ``backend="cuda"``
    refusing the configuration; (b) 20 replays of one captured solve
    bit-equal to 20 eager solves; (c) ms per graphed solve, device ops per
    solve."""
    out = {}
    obs, obs_cpu = wb.default_obs(device=dev), wb.default_obs(device="cpu")
    gen = torch.Generator().manual_seed(21)
    for name, params in refused_configs().items():
        try:
            wb.make_whole_body_solver(params, device=dev)
            fail(f"backend='cuda' took the configuration the kernels refuse ({name})")
        except ValueError as exc:
            refusal = str(exc)
        step, init = wb.make_whole_body_solver(params, device=dev, backend="torch")
        step_c, init_c = wb.make_whole_body_solver(params, device="cpu", backend="torch")
        z = torch.randn((K, H, A), generator=gen)
        got, _ = step(init(0), obs, z.to(dev))
        want, _ = step_c(init_c(0), obs_cpu, z)
        err = ((got.u_seq.cpu() - want.u_seq).abs().max() / want.u_seq.abs().max()).item()
        finite = bool(torch.isfinite(got.u_seq).all())
        print(f"[21a] plain whole-body solve on the card ({name}, K={K}, H={H}): u_seq against "
              f"the CPU on the same normals {err:.2e} of its largest entry (tol "
              f"{TOL_PLAIN_CARD:g}), finite {finite} | backend='cuda' refuses: {refusal}",
              flush=True)
        if not (finite and err <= TOL_PLAIN_CARD):
            fail(f"the plain whole-body solve on the card differs from the CPU ({name})")
        graphed_solves(f"[21b] plain whole-body solves ({name}),", step, init(5), obs,
                       N_PLAIN_SOLVES, dev)

        def solve_in_place(state, obs):
            o, new = step(state, obs)
            graphs.copy_into(state, new)
            return o

        g = graphs.graphed(solve_in_place, dev)(mppi.device_counters(init(6), dev), obs)
        ms = host_ms(lambda: [g.replay() for _ in range(N_PLAIN_TIMED)]) / N_PLAIN_TIMED
        eager_state = [mppi.device_counters(init(6), dev)]

        def eager_solve():
            _, eager_state[0] = step(eager_state[0], obs)

        eager = host_ms(eager_solve, reps=3)
        busy = profile_solves(f"[21c] ({name}) graphed", g.replay, 1, ms)
        out[name] = {"u_seq_err": err, "graphed_ms": ms, "eager_ms": eager,
                     "ops": None if busy is None else busy[2]}
        print(f"[21c] plain whole-body solve ({name}): {ms:.3f} ms graphed, {eager:.3f} ms "
              f"eager | device ops/solve {fmt_ops(out[name]['ops'])}", flush=True)
    return out


def gust_episode(n_steps: int, dev, graph: bool = True):
    """tests/test_lee_wind.py's gust loop: Lee hover of the HarrierD7 at
    (0, 0, 2), rotors at hover speed, a 5 m/s gust along x from 2 s for
    1 s; one tick per millisecond, 10 per control step.  ``(run, start)``;
    the log is the position."""
    veh = mr.MultirotorParams()
    gains, sp = lee.LeeGains(), lee.setpoint([0.0, 0.0, 2.0], device=dev)
    wp = wind_mod.WindParams(gust_velocity=(5.0, 0.0, 0.0), gust_start=2.0, gust_duration=1.0,
                             gust_period=1e9)

    def tick(carry, i, noise):
        plant, ws = carry
        wvel, ws = wind_mod.wind_velocity(wp, ws, i.to(torch.float32) * 0.001, 0.001)
        u = lee.lee_control(gains, veh, sp, pos=plant.pos, vel_world=plant.vel, quat=plant.quat,
                            omega_body=plant.omega)
        plant = mr.step(veh, plant, fc.allocate(veh, u), 0.001, wind_world=wvel)
        return (plant, ws), (plant.pos,)

    run = tick_episode(tick, lambda c: (c[0].pos,), n_steps * 10, dev, graph)
    return run, lambda seed=0: (hover_plant(veh, (0.0, 0.0, 2.0), device=dev),
                                wind_mod.init_wind(device=dev))


def rotorcraft_builds(dev) -> dict:
    """``build(n, graph) -> (run, start)`` of each rotorcraft scenario."""
    return {
        "hover": lambda n, g: rc.hover_episode(n, dev, g, controller="lee"),
        "figure-eight": lambda n, g: rc.figure_eight_episode(n, dev, g),
        "mission": lambda n, g: rc.mission_episode(n, dev, g),
        "waypoint-file": lambda n, g: rc.waypoint_file_episode(None, dev, g,
                                                               n_ticks=n * 10)[:2],
        "disturbance": lambda n, g: rc.disturbance_episode(n, dev, g),
    }


def phase_rotorcraft(dev) -> dict:
    """The rotorcraft flight layer (no solver in the loop; 1 kHz ticks, one
    captured control step of 10 ticks replayed per step), harrier, seed 0,
    with the JAX tests' gates at their lengths: (a) Lee hover 400 steps
    (passed, pos RMS < 0.1 m); (b) figure-eight 1800 (passed, track RMS <
    0.15 m, tilt < 0.6 rad); (c) mission 1500 (max altitude > 1.9 m,
    landed); (d) mission 400 saved, then 400 resumed (phase >= 1, resumed
    max altitude >= the saved run's final - 0.2 m) and the resumed run's
    first 10 steps bit-equal to 10 steps continued from the live carry;
    (e) waypoint file: tests/test_cli.py's inline file (max end error <
    0.2 m) and the default resource smooth (track RMS and max end error <
    0.05 m); the default resource flown raw (tests/test_cli.py:127) stays
    off the card, for the phase-wall budget; (f) tests/test_lee_wind.py's gust
    recovery (error < 0.05 m at tick 1500, < 0.1 m at the end); (g)
    ``run_disturbance`` 1000 steps beside the JAX package's CPU figures (no
    gate); (h) 10 control steps of each scenario graphed bit-equal to
    eager; (i) ms per control step graphed and eager, device ops per tick,
    no host sync in the replay loop."""
    out, gates = {}, []

    def gate(tag, r, ok, what, wall=None):
        print(f"{tag} " + ", ".join(f"{k} {v}" for k, v in r.items() if k != "file")
              + ("" if wall is None else f" | {wall:.3f} ms/control step (capture included)"),
              flush=True)
        gates.append(ok)
        if not ok:
            fail(f"{what} missed the JAX tests' gates")

    def timed(fn, n_steps):
        t0 = time.perf_counter()
        r = fn()
        sync()
        return r, (time.perf_counter() - t0) * 1e3 / n_steps

    r, wall = timed(lambda: rc.run_hover(0, N_HOVER, dev, controller="lee"), N_HOVER)
    gate(f"[22a] run_hover (lee), {N_HOVER} steps:", r, r["passed"] and r["pos_rms_m"] < 0.1,
         "the Lee hover", wall)
    r, wall = timed(lambda: rc.run_figure_eight(0, N_FIG8, dev), N_FIG8)
    gate(f"[22b] run_figure_eight, {N_FIG8} steps:", r,
         r["passed"] and r["track_rms_m"] < 0.15 and r["max_tilt_rad"] < 0.6, "the figure-eight",
         wall)
    r, wall = timed(lambda: rc.run_mission(0, N_MISSION, dev), N_MISSION)
    gate(f"[22c] run_mission, {N_MISSION} steps:", r, r["max_alt_m"] > 1.9 and r["landed"],
         "the mission", wall)

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "mission.npz")
        run, start = rc.mission_episode(N_MISSION_SAVE, dev)
        live, logs = run(start(0), save_state=ck)
        r1 = {"final_phase": int(live[2].phase), "final_alt_m": round(logs[0][-1, 2].item(), 3)}
        r2 = rc.run_mission(0, N_MISSION_SAVE, dev, resume=ck)
        land_after = N_MISSION_SAVE * 10 * 3 // 5
        cont, _ = rc.mission_episode(N_MISSION_CHECKED, dev, land_after=land_after)
        same = trees_equal(cont(live), cont(start(0), resume=ck))
        print(f"[22d] run_mission {N_MISSION_SAVE} steps saved: final phase "
              f"{r1['final_phase']}, final alt {r1['final_alt_m']} m | resumed {N_MISSION_SAVE} steps: max alt "
              f"{r2['max_alt_m']} m (gate >= {r1['final_alt_m'] - 0.2:.3f}), final phase "
              f"{r2['final_phase']} | the resumed run's first {N_MISSION_CHECKED} control steps "
              f"bit-equal to the live carry's {same}", flush=True)
        if not (r1["final_phase"] >= 1 and r2["max_alt_m"] >= r1["final_alt_m"] - 0.2 and same):
            fail("the mission's save and resume missed tests/test_cli.py's gate or is not "
                 "bit-equal to the live carry")
        gates.append(True)

        path = os.path.join(tmp, "wps.txt")
        with open(path, "w") as f:
            f.write(CLI_WAYPOINTS)
        r = rc.run_waypoint_file(device=dev, path=path)
        gate("[22e] run_waypoint_file (tests/test_cli.py's inline file):", r,
             r["n_waypoints"] == 3 and r["passed"] and r["max_end_err_m"] < 0.2,
             "the inline waypoint file")
    r = rc.run_waypoint_file(device=dev, smooth=True)
    gate("[22e] run_waypoint_file (default resource, smooth):", r,
         r["passed"] and r["track_rms_m"] < 0.05 and r["max_end_err_m"] < 0.05,
         "the smooth waypoint file")

    run, start = gust_episode(N_GUST_STEPS, dev)
    _, (pos,) = run(start())
    err = torch.linalg.norm(pos - torch.tensor([0.0, 0.0, 2.0], device=dev), dim=-1).cpu()
    gate(f"[22f] gust recovery (tests/test_lee_wind.py, {N_GUST_STEPS * 10} ticks):",
         {"err_at_1500": round(err[1500].item(), 4), "final_err": round(err[-1].item(), 4),
          "peak_err": round(err.max().item(), 4)},
         err[1500].item() < 0.05 and err[-1].item() < 0.1, "the gust recovery")

    r, wall = timed(lambda: rc.run_disturbance(0, N_DISTURBANCE, dev), N_DISTURBANCE)
    print(f"[22g] run_disturbance, {N_DISTURBANCE} steps (no gate): "
          + ", ".join(f"{k} {v}" for k, v in r.items())
          + " | JAX package, CPU, same length: "
          + ", ".join(f"{k} {v}" for k, v in JAX_DISTURBANCE.items())
          + f" | {wall:.3f} ms/control step (capture included)", flush=True)
    out["disturbance"] = r

    for name, build in rotorcraft_builds(dev).items():
        _, eager_ms = graphed_equals_eager(f"[22h] {name},", build, N_ROTOR_CHECKED)
        t = scenario_times(f"[22i] {name}", build, N_ROTOR_TIMED, eager_ms)
        t["ops_per_tick"] = None if t["graphed_ops"] is None else t["graphed_ops"] / 10
        out[name] = t
    out["gates"] = len(gates)
    return out


def bridge_states(n: int, seed: int = 23) -> list:
    """``n`` ROBOT_STATES payloads (the reference's 14 + 13 layout, base
    quaternion xyzw) near hover: the base within ~0.1 m of (0, 0, 2.1),
    tilted a few degrees and drifting, the arm near home."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        axis_angle = rng.normal(0.0, 0.05, 3)
        angle = np.linalg.norm(axis_angle)
        quat_xyzw = np.concatenate([axis_angle / angle * np.sin(angle / 2), [np.cos(angle / 2)]])
        state = np.concatenate([np.array([0.0, 0.0, 2.1]) + rng.normal(0.0, 0.1, 3), quat_xyzw,
                                kinova.Q_HOME + rng.normal(0.0, 0.05, 7),
                                rng.normal(0.0, 0.1, 6), rng.normal(0.0, 0.1, 7)])
        out.append([float(x) for x in state.astype(np.float32)])
    return out


class QmmClient:
    """A Python QMM client (the native tools' part): one TCP connection to
    a ``BridgeServer``, every wait bounded by ``BRIDGE_TIMEOUT_S``."""

    def __init__(self, server):
        self.sock = socket.create_connection((server.host, server.port),
                                             timeout=BRIDGE_TIMEOUT_S)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.dec = proto.Decoder()
        self.pending = []

    def send(self, frame) -> None:
        self.sock.sendall(proto.encode(frame))

    def take(self, mtype):
        """The next frame of type ``mtype`` (frames of other types stay
        pending)."""
        while True:
            for i, f in enumerate(self.pending):
                if f.type == mtype:
                    return self.pending.pop(i)
            data = self.sock.recv(65536)
            if not data:
                fail("the bridge server closed the connection")
            self.dec.feed(data)
            self.pending.extend(self.dec.frames())

    def request(self, state) -> tuple:
        """ROBOT_STATES -> (ROBOT_CMD payload, DRONE_POSE payload)."""
        self.send(proto.Frame(proto.MsgType.ROBOT_STATES, state))
        return (self.take(proto.MsgType.ROBOT_CMD).payload,
                self.take(proto.MsgType.DRONE_POSE).payload)

    def close(self) -> None:
        self.sock.close()


def fmt_vec(v) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"


def cmd_and_pose(frames) -> tuple:
    by_type = {f.type: f.payload for f in frames}
    return by_type[proto.MsgType.ROBOT_CMD], by_type[proto.MsgType.DRONE_POSE]


def replies_equal(a, b) -> bool:
    return all(np.array_equal(np.float32(x), np.float32(y)) for x, y in zip(a, b))


def bridge_counts() -> dict:
    return {"wb_cost": wk.wb_cost.launches, "wb_update": wk.wb_update.launches}


def session_kernels(tag: str, live, state, errs) -> dict:
    """``kernels_vs_plain`` at the whole-body session's own shape (K=512,
    H=50), on its Philox key, solve index and warm start after the
    requests, and the packed observation and targets of the request
    ``state``."""
    dev = live._head.device
    obs = serving.unpack_obs(torch.tensor(live._obs_vec(state), device=dev),
                             torch.tensor(live._targets(), device=dev))
    return kernels_vs_plain(tag, "the session's", live.params, obs, live._head._state, errs)


def bridge_session(tag: str, make, kernels: bool, errs, n_rtt: int = N_BRIDGE_RTT,
                   profile: bool = False) -> dict:
    """Phase 23b/c for one session kind (``make(graph)``): the replies of
    an eager session first, then a BridgeServer on 127.0.0.1 with the
    graphed session and a Python QMM client; its replies bit-equal to the
    eager session's on the same states, before and after a teleop nudge and
    an EE_REACH goal; rows 1 and 3's launches by the live session
    (``kernels``: its path runs them; its capture's two warm-up calls plus
    one per request), then both kernels against their plain versions on
    the live session's inputs; the client's round trip; one readback per
    request; the head replay's device time (``n_rtt`` round trips; with
    ``profile`` the head replay's device ops too)."""
    states = bridge_states(N_BRIDGE_CHECKED)
    goal = bridge_action.goal_frame(1, bridge_action.Task.EE_REACH, EE_GOAL)
    eager, eager_times = make(False), []

    def eager_reply(state):
        t1 = time.perf_counter()
        reply = cmd_and_pose(eager.handle_states(state))
        eager_times.append((time.perf_counter() - t1) * 1e3)
        return reply

    want = [eager_reply(st) for st in states]
    eager.handle_teleop_uav(1)
    eager.actions.handle_goal(goal.payload, eager)
    want_after = [eager_reply(st) for st in states[:N_BRIDGE_AFTER]]

    reset_counts()
    t0 = time.perf_counter()
    server = bridge.BridgeServer(session_factory=lambda: make(True))
    server.start()
    live = server.session()  # built, its head captured, before any client
    build_s = time.perf_counter() - t0
    client = QmmClient(server)
    try:
        equal = all([replies_equal(client.request(st), w) for st, w in zip(states, want)])
        client.send(proto.Frame(proto.MsgType.TELEOP_UAV, [1.0]))
        client.send(goal)
        fb = client.take(proto.MsgType.ACTION_FEEDBACK)
        after = all([replies_equal(client.request(st), w)
                     for st, w in zip(states[:N_BRIDGE_AFTER], want_after)])
        with server._session_lock:
            targets_ok = (np.array_equal(live.drone_target, eager.drone_target)
                          and np.array_equal(live.ee_position, np.float32(EE_GOAL))
                          and fb.payload[:2] == [1.0, float(bridge_action.ActionStatus.ACTIVE)])
        print(f"{tag} {N_BRIDGE_CHECKED} requests over the wire bit-equal to the eager session "
              f"{equal} | after a teleop nudge and an EE_REACH goal, {N_BRIDGE_AFTER} more "
              f"bit-equal {after} (targets moved {targets_ok}) | session built and captured in "
              f"{build_s:.3f} s", flush=True)
        if not (equal and after and targets_ok):
            fail(f"{tag}: the graphed session is not bit-equal to the eager session")

        rtts = []
        for i in range(n_rtt):
            t1 = time.perf_counter()
            client.request(states[i % len(states)])
            rtts.append((time.perf_counter() - t1) * 1e3)
        p50, p99 = np.percentile(rtts, [50, 99])
        with server._session_lock:
            sites = sync_sites(lambda: [live.handle_states(st) for st in states[:N_BRIDGE_SYNC]])
            launches = bridge_counts()
            want_n = N_BRIDGE_CHECKED + N_BRIDGE_AFTER + n_rtt + N_BRIDGE_SYNC + 2 \
                if kernels else 0
            check = session_kernels(tag, live, states[0], errs) if kernels else None
            head = live._head
            g = head._bind(head._z_none)
            head_ms = event_ms(g.replay, reps=20)
            busy = profile_solves(f"{tag} head replay", g.replay, 1, head_ms,
                                  unit="request") if profile else None
            req_ms = host_ms(lambda: live.handle_states(states[0]), reps=10)
        eager_ms = statistics.median(eager_times[1:])
        one_site = len(sites) == N_BRIDGE_SYNC and len(set(sites)) == 1 \
            and "bridge/server.py" in sites[0]
        print(f"{tag} host synchronizations in {N_BRIDGE_SYNC} requests: {len(sites)} at "
              f"{sorted(set(sites))} (one readback per request {one_site})", flush=True)
        print(f"{tag} rows 1 and 3 launched by the live session {launches} "
              + (f"(want {want_n} each: 2 warm-up calls + {want_n - 2} requests)" if kernels
                 else "(want 0: no kernel on this path)"), flush=True)
        if not one_site:
            fail(f"{tag}: a request synchronizes the host other than by its one readback")
        if launches != {"wb_cost": want_n, "wb_update": want_n}:
            fail(f"{tag}: rows 1 and 3 were not launched once per request")
        print(f"{tag} client round trip p50 {p50:.3f} ms, p99 {p99:.3f} ms ({n_rtt} "
              f"requests) | request {req_ms:.3f} ms graphed, {eager_ms:.3f} ms eager (session "
              f"call, host clock) | head replay {head_ms:.4f} ms (CUDA events)", flush=True)
    finally:
        client.close()
        server.stop()
    return {"rtt_p50_ms": p50, "rtt_p99_ms": p99, "request_ms": req_ms, "eager_ms": eager_ms,
            "head_ms": head_ms, "launches": launches, "build_s": build_s, "kernels": check,
            "head_ops": None if busy is None else busy[2]}


def hil_climb(dev, graph: bool = True, n_ticks: int = N_HIL_CLIMB, armed: bool = True):
    """tests/test_hil.py's loop on ``dev``: a loopback autopilot sends one
    HIL_ACTUATOR_CONTROLS frame (5 % above hover on every rotor, armed; or
    all channels full, disarmed), then ``n_ticks`` ticks.  Returns (the
    session, the last message of each name, host ms per tick)."""
    veh = mr.MultirotorParams()
    ap = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    ap.bind(("127.0.0.1", 0))
    ap.setblocking(False)
    session = hil_mod.HilSession(vehicle=veh, peer=ap.getsockname(), device=dev, graph=graph)
    cmd = min(1.0, 1.05 * veh.hover_rotor_speed() / veh.max_rotor_speed) if armed else 1.0
    n_on = veh.n_rotors if armed else 16
    ap.sendto(mav.encode("HIL_ACTUATOR_CONTROLS", dict(
        time_usec=0, flags=mav.MOTOR_SPEED_FLAG, controls=[cmd] * n_on + [0.0] * (16 - n_on),
        mode=mav.MAV_MODE_FLAG_SAFETY_ARMED if armed else 0)), session.address)
    parser, got = mav.Parser(), {}
    t0 = time.perf_counter()
    try:
        for _ in range(n_ticks):
            session.tick()
            try:
                while True:
                    data, _ = ap.recvfrom(4096)
                    got.update(parser.push(data))
            except BlockingIOError:
                pass
    finally:
        session.close()
        ap.close()
    return session, got, (time.perf_counter() - t0) * 1e3 / n_ticks


def phase_bridge(dev, errs) -> dict:
    """The solver bridge on the card: (a) the port's plant against the
    float64 oracle with the JAX test's gates; (b) a BridgeServer with a
    WholeBodySession (K=512, H=50, rows 1 and 3) and (c) with a
    SolverSession at its defaults, each driven by a Python QMM client
    (``bridge_session``); (d) the sim adapter against each session for 2 s
    with tests/test_bridge.py's gate, the solver session built lazily while
    the whole-body plant runs, 10 graphed control periods bit-equal to
    eager, ms per period, no host sync in the period's replay; (e)
    both tests/test_hil.py gates on the card, 100 graphed ticks bit-equal
    to eager, ms per tick."""
    out, walls, mark = {}, {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        walls[part] = now - mark[0]
        mark[0] = now

    rep = parity.oracle_parity_report(n_steps=1000, n_ensemble=128, device=dev)
    dev_ = rep["single_step_max_dev"]
    ok = (dev_["pos"] < 1e-5 and dev_["vel"] < 1e-4 and dev_["omega"] < 1e-4
          and dev_["quat"] < 1e-5 and rep["rmse_m"] < 1e-4)
    print(f"[23a] plant vs float64 oracle (n_ensemble 128, 1000 ticks): single-step max dev "
          f"{dev_}, rmse {rep['rmse_m']} m, max dev {rep['max_dev_m']} m | gates {ok}", flush=True)
    if not ok:
        fail("the port's plant missed the float64 oracle's gates")
    out["oracle"] = rep
    lap("a")

    sessions = {
        "whole-body": (lambda g: bridge.WholeBodySession(device=dev, graph=g), True),
        "solver": (lambda g: bridge.SolverSession(device=dev, graph=g), False),
    }
    for tag, (make, kernels) in sessions.items():
        out[tag] = bridge_session(f"[23{'b' if kernels else 'c'}] {tag} session:", make, kernels,
                                  errs)
        lap("b" if kernels else "c")

    # Two plants at once, one server each ("run several servers for several
    # plants"), each adapter on its own CUDA stream.  The whole-body plant
    # starts first; while it runs, the solver plant's adapter captures its
    # control period and its server builds its session lazily, at the first
    # exchange, in a handler thread: each capture of the bridge is
    # thread-local, so it may overlap another thread's use of the card.
    servers, adapters, runs, built = {}, {}, {}, {}

    def timed_factory(tag, make):
        def factory():
            t0 = time.perf_counter()
            session = make(True)
            built[tag] = (t0, time.perf_counter())
            return session
        return factory

    def fly(tag):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            t0 = time.perf_counter()
            res = adapters[tag].run(BRIDGE_SIM_S)
            return res, time.perf_counter() - t0, t0

    def adapter(tag):
        t0 = time.perf_counter()
        adapters[tag] = SimAdapter(servers[tag].host, servers[tag].port, device=dev)
        adapters[tag]._sock.settimeout(BRIDGE_TIMEOUT_S)
        built[f"{tag} adapter"] = (t0, time.perf_counter())

    try:
        for tag, (make, _) in sessions.items():
            servers[tag] = bridge.BridgeServer(session_factory=timed_factory(tag, make))
            servers[tag].start()
        servers["whole-body"].session()
        adapter("whole-body")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sessions)) as pool:
            futures = {"whole-body": pool.submit(fly, "whole-body")}
            adapter("solver")
            futures["solver"] = pool.submit(fly, "solver")
            runs = {tag: f.result() for tag, f in futures.items()}
        both = time.perf_counter() - t0
    finally:
        for server in servers.values():
            server.stop()
    n_ex = int(round(BRIDGE_SIM_S / 0.001)) // 10
    for tag, (res, wall, _) in runs.items():
        pos = res["pos"]
        ok = (bool(np.isfinite(pos).all()) and pos[-1, 2] > 1.5
              and bool(np.isfinite(res["final_setpoint"]).all()))
        print(f"[23d] sim adapter against the {tag} session, {BRIDGE_SIM_S} s ({n_ex} exchanges): "
              f"final pos {fmt_vec(pos[-1])}, min alt {pos[:, 2].min():.4f} m, "
              f"final setpoint {fmt_vec(res['final_setpoint'])} | gate {ok} | "
              f"{wall * 1e3 / n_ex:.3f} ms per exchange and period (wall, both plants at once)",
              flush=True)
        if not ok:
            fail(f"the sim adapter against the {tag} session missed tests/test_bridge.py's gate")
        out[f"sim_{tag}_ms"] = wall * 1e3 / n_ex
    _, wb_wall, wb_t0 = runs["whole-body"]
    inside = {k: wb_t0 < a and b < wb_t0 + wb_wall for k, (a, b) in built.items()
              if k.startswith("solver")}
    print(f"[23d] both plants' runs: {both:.3f} s of wall | built and captured while the "
          f"whole-body plant ran: " + ", ".join(
              f"{k} ({built[k][1] - built[k][0]:.3f} s) {v}" for k, v in inside.items()),
          flush=True)
    if not (len(inside) == 2 and all(inside.values())):
        fail("the solver session and its adapter were not built while the other plant ran: "
             "the check of concurrent captures did not hold")

    lap("d runs")
    # The whole-body run's adapter (its graph captured already) against an
    # eager adapter from its final state, under one command.
    ga = adapters["whole-body"]
    with socket.create_server(("127.0.0.1", 0)) as lis:
        ea = SimAdapter(*lis.getsockname(), device=dev, graph=False)
        ea._carry = graphs.clone_tree(ga._carry)
        cmd = torch.tensor([2.0, -3.0, 1.0, 0.5, -0.5, 0.2, 0.1, 0.3, -0.2, 2.4], device=dev)
        ga._cmd.copy_(cmd)
        ea._cmd.copy_(cmd)
        equal, eager_times = True, []
        for _ in range(N_SIM_CHECKED):
            rows = ga._replay_period()
            sync()
            t0 = time.perf_counter()
            rows_e = ea._replay_period()
            sync()
            eager_times.append((time.perf_counter() - t0) * 1e3)
            equal = torch.equal(rows, rows_e) and equal
        equal = equal and trees_equal(ga._carry, ea._carry)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def replays():
            start.record()
            for _ in range(N_SIM_TIMED):
                ga._replay_period()
            end.record()

        _, period_host_ms = synced_run("[23d]", f"{N_SIM_TIMED} replays of the control period",
                                       replays, (), N_SIM_TIMED)
        period_ms = start.elapsed_time(end) / N_SIM_TIMED
        eager_ms = statistics.median(eager_times)
        ea._sock.close()
    print(f"[23d] {N_SIM_CHECKED} control periods (10 ticks each) graphed against eager: "
          f"positions and plant bit-equal {equal} | {period_ms:.4f} ms per period graphed (CUDA "
          f"events; {period_host_ms:.4f} by the host clock), {eager_ms:.3f} ms eager (host "
          f"clock)", flush=True)
    if not equal:
        fail("the sim adapter's graphed control period is not bit-equal to eager")
    out["period_ms"], out["period_host_ms"] = period_ms, period_host_ms
    out["period_eager_ms"] = eager_ms
    lap("d period")

    session, got, tick_ms = hil_climb(dev)
    state, sensor = got.get("HIL_STATE_QUATERNION"), got.get("HIL_SENSOR")
    ok = (session.armed and float(session.plant.pos[2]) > 0.05 and state is not None
          and sensor is not None and state["alt"] > int(mav.KALT_ZURICH_M * 1000)
          and state["vz"] < 0 and sensor["zacc"] < -5.0
          and 900.0 < sensor["abs_pressure"] < 1013.0)
    print(f"[23e] HIL climb, {N_HIL_CLIMB} ticks: alt {float(session.plant.pos[2]):.4f} m, "
          f"vz {None if state is None else state['vz']} cm/s, zacc "
          f"{None if sensor is None else round(sensor['zacc'], 3)} | gate {ok} | "
          f"{tick_ms:.4f} ms per tick (host clock, messages included)", flush=True)
    if not ok:
        fail("the HIL climb missed tests/test_hil.py's gate")
    session, _, _ = hil_climb(dev, n_ticks=N_HIL_GROUNDED, armed=False)
    ok = (not session.armed and not np.any(session.rotor_cmd)
          and abs(float(session.plant.pos[2])) < 1e-3)
    print(f"[23e] HIL disarmed, {N_HIL_GROUNDED} ticks: alt {float(session.plant.pos[2]):.6f} m "
          f"| gate {ok}", flush=True)
    if not ok:
        fail("the disarmed HIL session missed tests/test_hil.py's gate")
    gs, gmsg, _ = hil_climb(dev, n_ticks=N_HIL_CHECKED)
    es, emsg, eager_tick_ms = hil_climb(dev, graph=False, n_ticks=N_HIL_CHECKED)
    equal = trees_equal(gs.plant, es.plant) and gmsg == emsg
    print(f"[23e] {N_HIL_CHECKED} HIL ticks graphed against eager: plant and last messages "
          f"bit-equal {equal} | {eager_tick_ms:.4f} ms per tick eager", flush=True)
    if not equal:
        fail("the graphed HIL step is not bit-equal to eager")
    out["hil_tick_ms"], out["hil_eager_tick_ms"] = tick_ms, eager_tick_ms
    lap("e")
    print("[t] phase 23 wall s per part: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()),
          flush=True)
    out["walls"] = walls
    return out


def run_cli(argv) -> dict:
    """``python -m quadrotor_manipulator_mppi_tpu_torch.run`` in this
    process: the JSON line it printed, read back."""
    out = cli.main(argv)
    print(f"    run {' '.join(argv)}", flush=True)
    return out


def kernels_vs_plain(tag: str, what: str, params, obs, solver, errs) -> dict:
    """``wb_cost`` (row 1: Philox draw and spill) and ``wb_update`` (row 3)
    against their plain versions on a live solver state (its Philox keys,
    solve index and warm start; a fleet's scenarios one by one) and the
    observation ``obs``.  S within TOL_COST, du and m2 within TOL_UPDATE,
    the spill bit-equal to the plain draw."""
    dev, cfg = obs.base_target.device, params.mppi
    kc = wk.make_kernel_config(params)
    sigma = solver.sigma if cfg.adaptive_sigma else mppi._diag_sigma(cfg, device=dev)
    if cfg.sigma_scale_fn is not None:
        sigma = sigma * cfg.sigma_scale_fn(obs)
    sc, u_prev = wk.pack_scalars(obs, sigma), solver.u_prev.contiguous()
    seeds = sampling.philox_keys(solver.seed, dev)
    step = sampling.step_tensor(solver.step, dev)
    s_k, m_k, e_k, eps = wk.wb_cost(kc, sc, u_prev, None, seeds, step)
    du_k, m2_k = wk.wb_update(kc, eps, s_k, m_k, e_k)
    rows = list(range(sc.shape[0])) if sc.ndim == 2 else [None]
    worst = {"rel_s": 0.0, "rel_du": 0.0, "abs_s": 0.0, "abs_du": 0.0}
    spill_eq = True
    for i in rows:
        pick = (lambda x: x) if i is None else (lambda x: x[i])
        key = seeds if i is None else seeds[i:i + 1]
        n = step if step.numel() == 1 else step[i:i + 1]
        s_p, _, _, eps_p = wk.wb_cost_plain(kc, pick(sc), pick(u_prev), None, key, n)
        du_p, m2_p = wk.wb_update_plain(kc, pick(eps), pick(s_k), pick(m_k), pick(e_k))
        sync()
        du_i, m2_i = pick(du_k), pick(m2_k)
        worst["rel_s"] = max(worst["rel_s"], rel_err(pick(s_k), s_p))
        worst["abs_s"] = max(worst["abs_s"], (pick(s_k) - s_p).abs().max().item())
        worst["abs_du"] = max(worst["abs_du"], (du_i - du_p).abs().max().item(),
                              (m2_i - m2_p).abs().max().item())
        worst["rel_du"] = max(worst["rel_du"],
                              (du_i - du_p).abs().max().item() / du_p.abs().max().item(),
                              (m2_i - m2_p).abs().max().item() / m2_p.abs().max().item())
        spill_eq = spill_eq and torch.equal(pick(eps), eps_p)
    batch = "" if rows[0] is None else f"B={len(rows)} x "
    print(f"{tag} wb_cost / wb_update at {what} {batch}K={kc.n_samples}, H={cfg.n_horizon} "
          f"(solve index {step.tolist()}, its live keys and warm start) vs plain: S rel "
          f"{worst['rel_s']:.2e} (max|dS| {worst['abs_s']:.3e}, limit {TOL_COST:g}) | du/m2 rel "
          f"{worst['rel_du']:.2e} (limit {TOL_UPDATE:g}) | spill == plain draw {spill_eq}",
          flush=True)
    if not (worst["rel_s"] <= TOL_COST and worst["rel_du"] <= TOL_UPDATE and spill_eq):
        fail(f"{tag}: wb_cost or wb_update at {what} shape disagrees with its plain version")
    errs["wb_cost"] = max(errs["wb_cost"], worst["abs_s"])
    errs["wb_update"] = max(errs["wb_update"], worst["abs_du"])
    return worst


def runner_kernels(tag: str, params, plant, solver, ee_target, base_target, errs) -> dict:
    """``kernels_vs_plain`` at a runner's own shape, on its live solver
    state and the observation of its plant."""
    obs = wb.WholeBodyObs(state=wbl.observe(plant), ee_target=ee_target, base_target=base_target)
    return kernels_vs_plain(tag, "the runner's", params, obs, solver, errs)


def render_check(dev, pos, rot) -> dict:
    """Phase 24b: ``N_RENDER`` frames of the survey's scene at 640 x 480
    rendered in one call in float32 on the card, against the same call on
    the same inputs in float64 on the CPU; the Kinect noise on explicit
    normals, card against CPU."""
    cam = dcam.DepthCameraParams(width=RENDER_W, height=RENDER_H, max_depth=30.0)
    sc = torch.tensor(rc.SURVEY_SPHERES, device=dev)
    sr = torch.tensor(rc.SURVEY_RADII, device=dev)

    def render():
        return dcam.depth_render(cam, pos, rot, sphere_centers=sc, sphere_radii=sr)

    got = render()
    ms = event_ms(render)
    p64, r64, c64, rad64 = (x.cpu().double() for x in (pos, rot, sc, sr))
    want = dcam.depth_render(cam, p64, r64, sphere_centers=c64, sphere_radii=rad64)
    got_h = got.cpu()
    # The float64 discriminant of each pixel's ray against each sphere.
    dirs = dcam.depth_to_points(cam, torch.ones(RENDER_H, RENDER_W, dtype=torch.float64),
                                torch.zeros(3, dtype=torch.float64),
                                torch.eye(3, dtype=torch.float64))[0]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    oc = p64[:, None, None, :] - c64
    b = (torch.einsum("fij,pj->fpi", r64, dirs)[:, :, None, :] * oc).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - rad64 ** 2)
    edge = ((disc.abs() / (b * b)).amin(-1) < SILHOUETTE_REL).reshape(got_h.shape)
    fin = torch.isfinite(got_h) & torch.isfinite(want) & ~edge
    rel = ((got_h.double() - want).abs() / want.abs())[fin].max().item()
    inf_eq = torch.equal(torch.isinf(got_h) & ~edge, torch.isinf(want) & ~edge)
    inf_diff_edge = int(((torch.isinf(got_h) != torch.isinf(want)) & edge).sum())
    n_edge = int(edge.sum())
    gen = torch.Generator()
    gen.manual_seed(24)
    z = torch.randn(got_h.shape, generator=gen)
    noisy_card = dcam.noisy_depth(cam, got, noise=z.to(dev)).cpu()
    noisy_cpu = dcam.noisy_depth(cam, got_h, noise=z)
    nan_eq = torch.equal(torch.isnan(noisy_card), torch.isnan(noisy_cpu))
    ok_n = ~torch.isnan(noisy_cpu)
    rel_n = ((noisy_card - noisy_cpu).abs() / noisy_cpu.abs())[ok_n].max().item()
    print(f"[24b] depth render, {N_RENDER} poses of the survey's log at {RENDER_W} x {RENDER_H} "
          f"in one call (float32, card) vs float64 on the CPU: max rel {rel:.2e} on pixels "
          f"finite in both (limit {TOL_RENDER:g}) | +inf masks equal off the silhouettes "
          f"{inf_eq} | silhouette pixels (|disc| < {SILHOUETTE_REL:g} b^2) {n_edge} (limit "
          f"{MAX_SILHOUETTE}; {inf_diff_edge} of them +inf on one side only) | +inf pixels "
          f"{int(torch.isinf(got_h).sum())} | Kinect noise on explicit normals, card vs CPU: "
          f"max rel {rel_n:.2e} (limit {TOL_DEPTH_NOISE:g}), NaN masks equal {nan_eq} | "
          f"{ms:.4f} ms per batched render (CUDA events)", flush=True)
    if not (rel <= TOL_RENDER and inf_eq and n_edge <= MAX_SILHOUETTE and nan_eq
            and rel_n <= TOL_DEPTH_NOISE):
        fail("the depth render or its noise on the card disagrees with the CPU")
    return {"render_ms": ms, "rel": rel, "silhouette": n_edge, "noise_rel": rel_n}


def phase_camera_cli(dev, errs) -> dict:
    """The camera stack and the scenario command line on the card, each
    scenario through ``run.main`` as a user calls it: (a) ``camera-survey
    --steps 400`` with tests/test_cli.py's gates, streaming to a live
    server (c), 10 control steps graphed bit-equal to eager, ms per step,
    device ops per tick, no host sync in the replay loop; (b) the depth
    camera at 640 x 480 on 8 poses of the survey's log against float64 on
    the CPU, and its Kinect noise; (c) the streamed frames read back from
    the server; (d) ``drone-waypoint``, ``whole-body-full``, its resume at
    K=64, H=12, ``whole-body-batch`` (4 x K=64) with their gates, rows 1
    and 3 against plain on the runners' live states at those shapes, and
    ``bench-scaling`` on the card; (e) every registered name resolves to
    the port's runner."""
    out, walls, mark = {}, {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        walls[part] = now - mark[0]
        mark[0] = now

    server = bridge.BridgeServer()
    server.start()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            frames, log = os.path.join(tmp, "frames"), os.path.join(tmp, "survey.npz")
            t0 = time.perf_counter()
            r = run_cli(["camera-survey", "--steps", str(N_SURVEY), "--out-dir", frames,
                         "--save-log", log, "--stream", f"127.0.0.1:{server.port}"])
            wall = (time.perf_counter() - t0) * 1e3 / N_SURVEY
            first = np.load(r["first_frame"])
            img = first["image"]
            ok = (r["frames_written"] >= 3 and r["point_err_tail_max_deg"] < 10.0
                  and img.ndim == 2 and bool(np.isfinite(img).any())
                  and abs(float(first["lat_deg"]) - 47.3667) < 0.01
                  and float(first["alt_m"]) > 488.0 and r["device"] == torch.cuda.get_device_name(0))
            print(f"[24a] camera-survey --steps {N_SURVEY}: frames {r['frames_written']}, point err "
                  f"tail max {r['point_err_tail_max_deg']} deg (mean "
                  f"{r['point_err_tail_mean_deg']}), orbit alt {r['orbit_alt_final_m']} m | first "
                  f"frame {img.shape}, {int(np.isfinite(img).sum())} finite px, lat "
                  f"{float(first['lat_deg']):.6f}, alt {float(first['alt_m']):.3f} m | gates {ok} | "
                  f"{wall:.3f} ms/control step (capture and capture pass included)", flush=True)
            if not ok:
                fail("the camera survey missed tests/test_cli.py's gates")
            last = np.load(os.path.join(frames, f"DSC{r['frames_written'] - 1:05d}.npz"))["image"]
            with np.load(log) as f:
                saved = dict(f)
            out["survey_log"] = saved
            lap("a survey")

            # (c) The last streamed frame, read back from the server.
            got, meta = None, {}
            deadline = time.time() + BRIDGE_TIMEOUT_S
            with socket.create_connection((server.host, server.port),
                                          timeout=BRIDGE_TIMEOUT_S) as viewer:
                while time.time() < deadline:
                    got, meta = bridge_camera.fetch_image(viewer)
                    if got is not None and meta.get("seq") == r["frames_written"] - 1:
                        break
                    time.sleep(0.05)
            ok = (got is not None and got.shape == last.shape
                  and np.array_equal(np.isnan(got), np.isnan(last))
                  and np.array_equal(got[~np.isnan(last)], last[~np.isnan(last)]))
            print(f"[24c] --stream to a live BridgeServer: frame seq {meta.get('seq')} of "
                  f"{r['frames_written']} read back with fetch_image, equal to the last npz frame "
                  f"with its {int(np.isnan(last).sum())} NaNs in place {ok}", flush=True)
            if not ok:
                fail("the streamed camera frame does not match the stored one")
            lap("c stream")
    finally:
        server.stop()

    # (a) The survey's control step graphed against eager, timed.
    def build(n, g):
        return rc.camera_survey_episode(n, dev, g)

    _, eager_ms = graphed_equals_eager("[24a] camera survey,", build, N_SURVEY_CHECKED)
    t = scenario_times("[24a] camera survey", build, N_SURVEY_TIMED, eager_ms)
    t["ops_per_tick"] = None if t["graphed_ops"] is None else t["graphed_ops"] / 10
    out["survey"] = t
    lap("a timing")

    # (b) The depth camera on 8 poses of the survey's saved log, from the
    # settled orbit (the gimbal starts level, its first frame half sky; near
    # the horizon a float32 ray's ground hit loses relative precision as
    # 1/|dz|).
    idx = np.linspace(N_SURVEY * 10 // 4, N_SURVEY * 10 - 1, N_RENDER).astype(int)
    pos, quat, gang = (torch.tensor(saved[k][idx], device=dev) for k in ("pos", "quat", "gimbal"))
    rot = gb.camera_rotation(gb.GimbalState(gang, torch.zeros_like(gang)), quat)
    out.update(render_check(dev, pos, rot.contiguous()))
    lap("b render")

    # (d) The runners this command line adds.
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "drone.npz")
        r = run_cli(["drone-waypoint", "--steps", str(N_DRONE_CLI), "--save-log", log])
        shape = np.load(log)["pos"].shape
        try:
            run_cli(["drone-waypoint", "--controller", "lee", "--steps", "10"])
            refused = False
        except SystemExit:
            refused = True
        ok = np.isfinite(r["min_err_m"]) and shape == (N_DRONE_CLI, 3) and refused
        print(f"[24d] drone-waypoint --steps {N_DRONE_CLI}: min err {r['min_err_m']} m, final "
              f"{r['final_err_m']} m, response {r['response_time_s']} s | log pos {shape} | "
              f"--controller lee refused {refused} | gates {ok}", flush=True)
        if not ok:
            fail("drone-waypoint missed tests/test_cli.py's gates")
        lap("d drone")

        reset_counts()
        t0 = time.perf_counter()
        r = run_cli(["whole-body-full", "--steps", str(N_WB_FULL)])
        sync()
        wall = (time.perf_counter() - t0) * 1e3 / N_WB_FULL
        launches = {"whole-body-full": bridge_counts()}
        ok = r["min_ee_err_m"] < 0.4 and r["min_alt_m"] > 0.5
        print(f"[24d] whole-body-full --steps {N_WB_FULL} (position, K=512, H=50, the RNEA "
              f"plant): min EE err {r['min_ee_err_m']} m, final {r['final_ee_err_m']} m, min alt "
              f"{r['min_alt_m']} m, tilt {r['max_tilt_rad']} | rows 1/3 launches "
              f"{launches['whole-body-full']} | gates {ok} | {wall:.3f} ms/control step "
              f"(capture included)", flush=True)
        if not ok or launches["whole-body-full"] != {"wb_cost": N_WB_FULL + 2,
                                                     "wb_update": N_WB_FULL + 2}:
            fail("whole-body-full missed its gates or did not run through rows 1 and 3")
        out["wb_full_ms"] = wall
        lap("d full")

        # tests/test_cli.py:175's resume at K=64, H=12, through the runner.
        mid, end_r, end_c = (os.path.join(tmp, f) for f in ("mid.npz", "res.npz", "cont.npz"))
        kw = dict(seed=0, device=dev, n_samples=RESUME_K, n_horizon=RESUME_H)
        log_r, log_c = {}, {}
        reset_counts()
        run_whole_body_full(steps=N_RESUME, save_state=mid, **kw)
        run_whole_body_full(steps=N_RESUME, resume=mid, save_state=end_r, logs=log_r, **kw)
        run_whole_body_full(steps=2 * N_RESUME, save_state=end_c, logs=log_c, **kw)
        launches["resume"] = bridge_counts()
        with np.load(end_r) as a, np.load(end_c) as b:
            worst = max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a.files
                        if k != "__meta__")
        d_ee = abs(float(log_r["ee_err"][-1]) - float(log_c["ee_err"][-1]))
        ok = worst <= TOL_RESUME and d_ee <= TOL_RESUME
        print(f"[24d] whole-body-full K={RESUME_K}, H={RESUME_H}: {N_RESUME} steps saved + "
              f"{N_RESUME} resumed against {2 * N_RESUME} continuous: every state leaf max|d| "
              f"{worst:.2e}, last EE error |d| {d_ee:.2e} (limit {TOL_RESUME:g}) | rows 1/3 "
              f"launches {launches['resume']}", flush=True)
        if not ok:
            fail("the resumed whole-body episode is not the continuous one")
        params = wb.position_mode_params(n_samples=RESUME_K, n_horizon=RESUME_H)
        _, init = wb.make_whole_body_solver(params, device=dev, low_k_guard="off")
        plant, solver = checkpoint.restore(
            end_r, (wbl.init_plant(params.model.vehicle, device=dev), init(0)), device=dev)
        obs0 = wb.default_obs(device=dev)
        out["resume_kernels"] = runner_kernels("[24d] resume,", params, plant, solver,
                                               obs0.ee_target, obs0.base_target, errs)
        lap("d resume")

    reset_counts()
    r = run_cli(["whole-body-batch", "--scenarios", str(WB_BATCH_B), "--k-per-device",
                 str(WB_BATCH_K), "--steps", str(N_WB_BATCH)])
    launches["whole-body-batch"] = bridge_counts()
    ok = (r["l1_cmd_tail_mean_mm"] < 1500.0 and r["max_tilt_rad"] < 0.5
          and r["control_steps_per_s"] > 0 and r["scenarios"] == WB_BATCH_B)
    print(f"[24d] whole-body-batch {WB_BATCH_B} x K={WB_BATCH_K}, {N_WB_BATCH} steps: l1_cmd tail "
          f"mean {r['l1_cmd_tail_mean_mm']} mm, tilt {r['max_tilt_rad']}, "
          f"{r['control_steps_per_s']} control steps/s ({r['wall_s']} s timed run), gate held "
          f"{r['gate_held_fraction']} | rows 1/3 launches {launches['whole-body-batch']} | gates "
          f"{ok}", flush=True)
    if not ok or launches["whole-body-batch"] != {"wb_cost": 2 * N_WB_BATCH + 2,
                                                  "wb_update": 2 * N_WB_BATCH + 2}:
        fail("whole-body-batch missed tests/test_cli.py's gates or skipped rows 1 and 3")
    # The runner's fleet built again as it builds it, for its live state.
    params = wb.position_mode_params(n_samples=WB_BATCH_K, n_horizon=H)
    run = wbl.make_whole_body_episode(
        params, n_control_steps=N_WB_BATCH, device=dev, n_scenarios=WB_BATCH_B,
        cfg=wbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, substep_unroll=10))
    (plants, solver, targets, base_targets), _ = run(
        *wbl.fleet_starts(params, WB_BATCH_B, seed=0, device=dev))
    out["batch_kernels"] = runner_kernels("[24d] batch,", params, plants, solver, targets,
                                          base_targets, errs)
    out["launches"] = launches
    lap("d batch")

    r = run_cli(["bench-scaling"])
    vals = [r[k] for k in ("weak_eff_sample_axis", "weak_eff_scenario_axis", "t_1dev_ms",
                           "t_sample_sharded_ms", "t_scenario_sharded_ms")]
    ok = r["devices"] == torch.cuda.device_count() and all(np.isfinite(v) and v > 0 for v in vals)
    print(f"[24d] bench-scaling on {r['devices']} card(s), K per device {r['k_per_device']}: "
          f"weak efficiency sample axis {r['weak_eff_sample_axis']:.3f}, scenario axis "
          f"{r['weak_eff_scenario_axis']:.3f} | 1-rank solve {r['t_1dev_ms']:.3f} ms (CUDA "
          f"events) | finite {ok}", flush=True)
    if not ok:
        fail("bench-scaling gave no finite efficiencies on the card")
    lap("d scaling")

    resolved = {}
    for name in registry.NAMES:
        fn = registry.get(name)
        resolved[name] = fn.__module__.startswith("quadrotor_manipulator_mppi_tpu_torch.")
    ok = all(resolved.values()) and set(resolved) == set(SCENARIO_PHASES)
    print(f"[24e] {len(resolved)} registered names, each resolved to the port's runner {ok}; "
          "driven on the card in phase " + ", ".join(f"{n} {SCENARIO_PHASES[n]}"
                                                     for n in registry.NAMES), flush=True)
    if not ok:
        fail("a registered scenario does not resolve to the port's runner")
    lap("e")
    print("[t] phase 24 wall s per part: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()),
          flush=True)
    out["walls"] = walls
    return out


def _bag_fields(fields: dict) -> bytes:
    """A rosbag 2.0 field block: length-prefixed ``name=value`` entries."""
    return b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"=" + v
                    for k, v in fields.items())


def _bag_record(fields: dict, data: bytes) -> bytes:
    """One rosbag 2.0 record: its header's field block, then the data."""
    header = _bag_fields(fields)
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def write_odometry_bag(path: str, topic: str, t, pos, quat_xyzw) -> None:
    """A minimal rosbag 2.0 writer (this script's scaffolding, not a feature
    of the package): one connection and one ``nav_msgs/Odometry`` message
    per row, all in one bz2 chunk."""
    import bz2

    def ros_string(x: str) -> bytes:
        return struct.pack("<I", len(x)) + x.encode()

    conn = struct.pack("<I", 0)
    body = _bag_record({"op": bytes([rosbag.OP_CONNECTION]), "conn": conn,
                        "topic": topic.encode()},
                       _bag_fields({"type": b"nav_msgs/Odometry", "md5sum": b"0" * 32}))
    for ti, p, q in zip(t, pos, quat_xyzw):
        secs, nsecs = int(ti), int(round((ti - int(ti)) * 1e9))
        msg = (struct.pack("<III", 0, secs, nsecs) + ros_string("world") + ros_string("base")
               + struct.pack("<7d", *p, *q) + struct.pack("<36d", *([0.0] * 36))
               + struct.pack("<6d", *([0.0] * 6)) + struct.pack("<36d", *([0.0] * 36)))
        body += _bag_record({"op": bytes([rosbag.OP_MSG]), "conn": conn,
                             "time": struct.pack("<II", secs, nsecs)}, msg)
    chunk = _bag_record({"op": bytes([rosbag.OP_CHUNK]), "compression": b"bz2",
                         "size": struct.pack("<I", len(body))}, bz2.compress(body))
    head = _bag_record({"op": bytes([rosbag.OP_BAG_HEADER]), "index_pos": struct.pack("<Q", 0),
                        "conn_count": struct.pack("<I", 1), "chunk_count": struct.pack("<I", 1)},
                       b" " * 64)
    with open(path, "wb") as f:
        f.write(rosbag.MAGIC + head + chunk)


def trace_kernel_counts(path: str) -> dict:
    """Kernel events per whole-body family in a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {fam: sum(fam in n for n in names) for fam in ("wb_cost_kernel<", "wb_update_kernel<")}


def phase_offline(dev, errs, serving_ms: float, survey_log: dict) -> dict:
    """The offline tools on the card: (a) the flagship parameters saved in
    an ``ExperimentConfig`` and loaded back build a solver whose solve
    equals the in-memory tree's bit for bit; (b) ``collect_whole_body`` at
    K=4096, H=50 (20 solves, each a graph replay, rows 1 and 3 once each)
    with the JAX test's gates, graphed = eager, the ``.npz`` round trip,
    rows 1 and 3 against plain on the collector's last live state, ms per
    collected solve; (c) ``time_fn`` on the collector's graphed step and a
    ``trace`` of 5 replays holding 5 + 5 kernel events; (d) the camera
    survey's log written as a bz2 Odometry bag, compared with its npz by
    ``parity.main``; (e) the Kinova URDF loaded and held against the arm
    model, the matrix FK on 4096 configurations against the quaternion FK
    and float64 on the CPU, ``arm_gravity_wrench`` against float64."""
    out, walls, mark = {}, {}, [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        walls[part] = now - mark[0]
        mark[0] = now

    params = wb.WholeBodyMPPIParams()
    obs = wb.default_obs(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        # (a) The config tree through JSON and back into a solver.
        exp = config_mod.ExperimentConfig(solver=params)
        path = os.path.join(tmp, "exp.json")
        config_mod.save_config(exp, path)
        back = config_mod.load_config(path)
        same_tree = config_mod.to_dict(back) == config_mod.to_dict(exp)
        outs = []
        for tree in (exp, back):
            step, init = wb.make_whole_body_solver(tree.solver, device=dev, backend="cuda")
            outs.append(step(init(tree.seed), obs)[0])
        equal = all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))
        print(f"[25a] ExperimentConfig(WholeBodyMPPIParams()) saved ({os.path.getsize(path)} B of "
              f"JSON) and loaded: tree equal {same_tree}, the loaded tree's solve (backend cuda, "
              f"K={back.solver.mppi.n_samples}, H={back.solver.mppi.n_horizon}) bit-equal to the "
              f"in-memory tree's {equal}", flush=True)
        if not (same_tree and equal):
            fail("the loaded config tree does not reproduce the in-memory solve")
        lap("a config")

        # (b) The whole-body dataset at full width.
        reset_counts()
        t0 = time.perf_counter()
        rec = ds.collect_whole_body(n_solves=N_COLLECT, seed=0, device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = counts(wk.wb_cost, wk.wb_update)
        arrs = rec.arrays()
        rec_e = ds.collect_whole_body(n_solves=N_COLLECT, seed=0, device=dev, graph=False)
        eager_equal = all(np.array_equal(arrs[k], v) for k, v in rec_e.arrays().items())
        path = os.path.join(tmp, "wb.npz")
        rec.save(path)
        loaded, meta = ds.load_dataset(path)
        round_trip = (set(loaded) == set(arrs)
                      and all(np.array_equal(loaded[k], arrs[k]) for k in arrs))
        ok = (arrs["u_seq"].shape == (N_COLLECT, H, A) and bool(np.isfinite(arrs["u_seq"]).all())
              and arrs["q"].shape == (N_COLLECT, 7)
              and float(np.std(arrs["base_pos"], axis=0).max()) > 0.01
              and meta["n_horizon"] == H and meta["task"] == "whole_body_reach"
              and meta["n_steps"] == N_COLLECT)
        want = {"wb_cost": N_COLLECT + COLLECT_WARMUP, "wb_update": N_COLLECT + COLLECT_WARMUP}
        print(f"[25b] collect_whole_body(n_solves={N_COLLECT}, seed=0) at K={K}, H={H}, attitude: "
              f"u_seq {arrs['u_seq'].shape} finite, q {arrs['q'].shape}, base_pos std max "
              f"{float(np.std(arrs['base_pos'], axis=0).max()):.4f} m, meta {meta} | gates {ok} | "
              f"rows 1/3 launches {launches} ({N_COLLECT} replays + {COLLECT_WARMUP} warm-up "
              f"calls of the capture) | graphed = eager (graph=False) bit for bit {eager_equal} | "
              f".npz round trip bit-equal {round_trip} | {wall_ms / N_COLLECT:.3f} ms per collected "
              f"solve with its readback (build and capture included; {wall_ms:.1f} ms in all)",
              flush=True)
        if not (ok and eager_equal and round_trip) or launches != want:
            fail("collect_whole_body missed its gates, its eager twin or rows 1 and 3")
        out["launches"], out["collect_ms"] = launches, wall_ms / N_COLLECT

        # The collector's graphed step again, to its last live state.
        step, init = ds.make_whole_body_collector(device=dev)
        rows, state = ds.whole_body_obs_rows(N_COLLECT, 0), init(1)
        replayed = []
        for row in rows:
            row_out, state = step(state, row)
            replayed.append(row_out)
        same = all(np.array_equal(ds.split_out_row(r, H)["u_seq"], u)
                   for r, u in zip(replayed, arrs["u_seq"]))
        print(f"[25b] make_whole_body_collector's step over the same {N_COLLECT} rows equals the "
              f"collected plans {same}", flush=True)
        if not same:
            fail("the collector's step does not reproduce collect_whole_body's plans")
        live_obs = ds.whole_body_obs(torch.tensor(rows[-1], device=dev), obs)
        out["kernels"] = kernels_vs_plain("[25b]", "the collector's", params, live_obs, state,
                                          errs)
        lap("b dataset")

        # (c) Profiling: time_fn on the graphed step, and a trace of 5 replays.
        tf = profiling.time_fn(step, state, rows[-1], iters=N_TIME_FN, warmup=N_TIME_FN_WARMUP)
        print(f"[25c] time_fn(collector step, iters={N_TIME_FN}, warmup={N_TIME_FN_WARMUP}): mean "
              f"{tf['mean_ms']:.4f} ms, p50 {tf['p50_ms']:.4f}, p99 {tf['p99_ms']:.4f}, "
              f"{tf['solves_per_s']:.0f} solves/s, 100 Hz budget {tf['meets_100hz_budget']} | "
              f"phase 4's graphed serving solve {serving_ms:.4f} ms", flush=True)
        if tf["n"] != N_TIME_FN:
            fail("time_fn did not time the collector's step")
        reset_counts()
        with profiling.trace(os.path.join(tmp, "trace"), device=dev) as trace_path:
            for _ in range(N_TRACED):
                step(state, rows[-1])
        host = counts(wk.wb_cost, wk.wb_update)
        in_trace = trace_kernel_counts(trace_path)
        print(f"[25c] profiling.trace around {N_TRACED} graphed collector solves: "
              f"{os.path.getsize(trace_path)} B of Chrome trace, kernel events {in_trace}, "
              f"counted by the wrappers {host}", flush=True)
        if list(in_trace.values()) != [N_TRACED, N_TRACED] or list(host.values()) != [N_TRACED] * 2:
            fail("the trace does not hold one wb_cost and one wb_update per traced solve")
        out["time_fn"] = tf
        lap("c profiling")

        # (d) A rotorcraft run's log (phase 24's camera survey) as a bag.
        pos = survey_log["pos"].astype(np.float64)
        quat = survey_log["quat"].astype(np.float64)
        t = np.arange(pos.shape[0]) * rc.TICK_DT
        bag, npz = os.path.join(tmp, "survey.bag"), os.path.join(tmp, "survey.npz")
        write_odometry_bag(bag, "/survey/odometry", t, pos, np.roll(quat, -1, axis=-1))
        np.savez(npz, pos=survey_log["pos"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            parity.main(["compare", bag, npz])
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        devs = [rep[k] for k in ("rmse_m", "max_dev_m", "final_dev_m")]
        topics = rosbag.list_topics(bag)
        print(f"[25d] the camera survey's log ({pos.shape[0]} ticks) as a nav_msgs/Odometry bag "
              f"in one bz2 chunk ({os.path.getsize(bag)} B; topics {topics}) | parity.main "
              f"compare bag npz: rmse {rep['rmse_m']:.3g}, max {rep['max_dev_m']:.3g}, final "
              f"{rep['final_dev_m']:.3g} m (limit {TOL_BAG:g})", flush=True)
        if max(devs) > TOL_BAG or topics != {"/survey/odometry": ("nav_msgs/Odometry",
                                                                   pos.shape[0])}:
            fail("the bag does not compare equal to its own log")
        lap("d rosbag")

    # (e) The URDF loader and the matrix FK on the card.
    model = urdf.Urdf.from_string(kinova_urdf_text(kinova))
    worst = 0.0
    for tip, hard in ((LINK_7, kinova.chain()), (TIP, kinova.chain("end_effector"))):
        spec = model.build_chain(ROOT, tip)
        for f in ("origin_rot", "origin_trans", "axis", "lower", "upper", "velocity", "effort",
                  "tip_rot", "tip_trans"):
            worst = max(worst, float(np.abs(getattr(spec, f) - getattr(hard, f)).max()))
    loaded_in, hard_in = model.build_inertials(ROOT, LINK_7), kinova.inertials()
    worst_in = max(float(np.abs(getattr(loaded_in, f) - getattr(hard_in, f)).max())
                   for f in ("mass", "com", "inertia"))
    spec = model.build_chain(ROOT, TIP)
    gen = np.random.default_rng(25)
    q64 = torch.tensor(gen.uniform(-2.0, 2.0, size=(N_FK, 7)))
    rpy64 = torch.tensor(gen.uniform(-0.4, 0.4, size=(N_FK, 3)))
    quat64 = rotlib.matrix_to_quat(rotlib.euler_to_matrix(rpy64.flip(-1), "ZYX"))
    pos64 = torch.tensor(gen.uniform(-1.0, 1.0, size=(N_FK, 3)))
    q, quat_b, pos_b = (x.to(dev, torch.float32) for x in (q64, quat64, pos64))
    base = se3.Transform(rotlib.quat_to_matrix(quat_b), pos_b)
    fk, fk_ms = timed_once(lambda: chain_mod.forward_kinematics(spec, q, base=base))
    pq_pos, pq_quat = chain_mod.forward_kinematics_posquat(spec, q, base_pos=pos_b,
                                                           base_quat=quat_b)
    fk64 = chain_mod.forward_kinematics(
        spec, q64, base=se3.Transform(rotlib.quat_to_matrix(quat64), pos64))
    d_pq = max((fk.trans - pq_pos).abs().max().item(),
               (fk.rot - rotlib.quat_to_matrix(pq_quat)).abs().max().item())
    d_64 = max((fk.trans.cpu().double() - fk64.trans).abs().max().item(),
               (fk.rot.cpu().double() - fk64.rot).abs().max().item())
    hard_spec = kinova.chain()
    base_rot64 = rotlib.euler_to_matrix(rpy64.flip(-1), "ZYX")
    (f32, t32), w_ms = timed_once(lambda: arm_gravity_wrench(
        hard_spec, hard_in, q, base_rot64.to(dev, torch.float32)))
    f64, t64 = arm_gravity_wrench(hard_spec, hard_in, q64, base_rot64)
    d_w = max(rel_err(f32.cpu().double(), f64), rel_err(t32.cpu().double(), t64))
    print(f"[25e] the Kinova URDF (tests/kinova_urdf.py) through models/urdf: ChainSpec (link 7 "
          f"and end effector) max|d| {worst:.1e}, inertials max|d| {worst_in:.1e} against "
          f"kinova.chain()/inertials() (limit {TOL_URDF:g}) | matrix FK of {N_FK} configurations "
          f"with base poses on the card ({fk_ms:.3f} ms): vs pos-quat FK {d_pq:.2e}, vs float64 "
          f"on the CPU {d_64:.2e} (limit {TOL_FK:g}) | arm_gravity_wrench at B={N_FK} "
          f"({w_ms:.3f} ms) vs float64 {d_w:.2e} of its largest (limit {TOL_WRENCH:g})",
          flush=True)
    if worst > TOL_URDF or worst_in > TOL_URDF or d_pq > TOL_FK or d_64 > TOL_FK \
            or d_w > TOL_WRENCH or fk.trans.device != dev:
        fail("the URDF loader, the matrix FK or the gravity wrench disagrees")
    lap("e urdf")
    print("[t] phase 25 wall s per part: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()),
          flush=True)
    out["walls"] = walls
    return out


def zero_mean_params():
    """The serving preset (attitude, K=4096, H=50) with zero-mean noise: a
    configuration the kernels refuse."""
    p = wb.WholeBodyMPPIParams()
    return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, zero_mean_noise=True))


def refuses_naming_torch(tag: str, build) -> str:
    """``build()`` on the default backend must raise a ValueError that names
    ``backend="torch"``; returns its message."""
    try:
        build()
    except ValueError as exc:
        if 'backend="torch"' not in str(exc):
            fail(f"{tag}: the refusal does not name backend=\"torch\": {exc}")
        return str(exc)
    fail(f"{tag}: backend='cuda' took a configuration the kernels refuse")


def phase_backends(dev, errs, earlier=None) -> dict:
    """Phase 26 (F8): the whole-body callers on the plain pipeline
    (``backend="torch"``) at full width, in configurations the kernels
    refuse, each refused first by the default backend with a message naming
    ``backend="torch"``: (a) ``make_packed_step`` at K=4096, H=50, attitude,
    zero-mean noise: N_SERVE graphed solves bit-equal to the eager ones, ms
    per solve graphed and eager, device ops per solve, no whole-body kernel
    launched; (b) ``WholeBodySession`` in position mode at K=4004, H=50
    behind a ``BridgeServer`` (``bridge_session``: requests bit-equal to the
    eager session, N_SESSION_TORCH_RTT round trips p50/p99, one readback per
    request, no kernel launched); (c) ``collect_whole_body`` at (a)'s
    configuration, N_COLLECT_TORCH solves, graphed = eager, finite; (d) the
    same three callers on the default backend launch rows 1 and 3 once per
    call plus the capture's two warm-up calls, as phases 4, 23 and 25
    (``earlier``: their counts, when the whole script ran)."""
    out = {}
    params = zero_mean_params()
    obs_vec, target_vec = serving.pack_obs(wb.default_obs(device=dev))
    refusal = refuses_naming_torch("[26a]", lambda: serving.make_packed_step(params, device=dev))
    pstep, pinit = serving.make_packed_step(params, device=dev, backend="torch")
    pstep_e, pinit_e = serving.make_packed_step(params, device=dev, backend="torch", graph=False)
    serve_solves(pstep, pinit, obs_vec, target_vec, 3)  # capture
    serve_solves(pstep_e, pinit_e, obs_vec, target_vec, 3)  # warm up
    sync()
    reset_counts()
    outs = []
    ms_g, carry = solve_blocks(pstep, pinit(0), obs_vec, target_vec, outs)
    launches = bridge_counts()
    eager_outs, eager_u = serve_solves(pstep_e, pinit_e, obs_vec, target_vec, N_SERVE)
    sync()
    equal = all(torch.equal(a, b) for a, b in zip(outs, eager_outs)) and torch.equal(
        carry.u_prev, eager_u)
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    ms_e, _ = solve_blocks(pstep_e, pinit_e(0), obs_vec, target_vec)
    box = [carry]

    def one():
        _, box[0] = pstep(box[0], obs_vec, target_vec)

    busy = profile_solves("[26a] graphed plain packed solve", one, 1, ms_g)
    out["packed"] = {"graphed_ms": ms_g, "eager_ms": ms_e,
                     "ops": None if busy is None else busy[2]}
    print(f"[26a] make_packed_step(backend='torch'), K={K}, H={H}, attitude, zero-mean noise: "
          f"{N_SERVE} graphed solves bit-equal to the eager ones {equal} | finite {finite} | "
          f"whole-body kernels launched {launches} | {ms_g:.3f} ms/solve graphed, {ms_e:.3f} "
          f"eager (host, median of {N_SERVE // 10} blocks of 10) | device ops/solve "
          f"{fmt_ops(out['packed']['ops'])} | backend='cuda' refuses: {refusal}", flush=True)
    if not (equal and finite) or any(launches.values()):
        fail("[26a] the plain packed solve is not bit-equal to eager, not finite, or launched "
             "a whole-body kernel")

    sp = wb.position_mode_params(n_samples=SESSION_TORCH_K, n_horizon=H)
    refuses_naming_torch("[26b]", lambda: bridge.WholeBodySession(params=sp, device=dev))
    out["session"] = bridge_session(
        f"[26b] whole-body session (backend='torch', K={SESSION_TORCH_K}, H={H}, position),",
        lambda g: bridge.WholeBodySession(params=sp, device=dev, graph=g, backend="torch"),
        False, errs, n_rtt=N_SESSION_TORCH_RTT, profile=True)

    refuses_naming_torch("[26c]", lambda: ds.collect_whole_body(n_solves=1, params=params,
                                                                device=dev))
    reset_counts()
    t0 = time.perf_counter()
    rec = ds.collect_whole_body(n_solves=N_COLLECT_TORCH, seed=0, params=params, device=dev,
                                backend="torch")
    collect_ms = (time.perf_counter() - t0) * 1e3 / N_COLLECT_TORCH
    c_launches = bridge_counts()
    rec_e = ds.collect_whole_body(n_solves=N_COLLECT_TORCH, seed=0, params=params, device=dev,
                                  graph=False, backend="torch")
    a, e = rec.arrays(), rec_e.arrays()
    c_equal = set(a) == set(e) and all(np.array_equal(a[k], e[k]) for k in a)
    c_finite = bool(np.isfinite(a["u_seq"]).all()) and a["u_seq"].shape == (N_COLLECT_TORCH, H, A)
    out["collect_ms"] = collect_ms
    print(f"[26c] collect_whole_body(backend='torch', n_solves={N_COLLECT_TORCH}) at (a)'s "
          f"configuration: graphed = eager {c_equal} | finite plans {a['u_seq'].shape} "
          f"{c_finite} | whole-body kernels launched {c_launches} | {collect_ms:.3f} ms per "
          "collected solve (build and capture included)", flush=True)
    if not (c_equal and c_finite) or any(c_launches.values()):
        fail("[26c] the plain collector is not bit-equal to eager, not finite, or launched a "
             "whole-body kernel")

    want = {"wb_cost": N_DEFAULT_CALLS + 2, "wb_update": N_DEFAULT_CALLS + 2}
    counts_d = {}
    reset_counts()
    dstep, dinit = serving.make_packed_step(device=dev)
    serve_solves(dstep, dinit, obs_vec, target_vec, N_DEFAULT_CALLS)
    counts_d["make_packed_step"] = bridge_counts()
    reset_counts()
    session = bridge.WholeBodySession(device=dev)
    for st in bridge_states(N_DEFAULT_CALLS):
        session.handle_states(st)
    counts_d["WholeBodySession"] = bridge_counts()
    reset_counts()
    ds.collect_whole_body(n_solves=N_DEFAULT_CALLS, seed=0, device=dev)
    counts_d["collect_whole_body"] = bridge_counts()
    sync()
    print(f"[26d] the default backend ('cuda'), {N_DEFAULT_CALLS} calls each: rows 1 and 3 "
          f"launched {counts_d} (want {want}: the calls + the capture's 2 warm-up calls)"
          + ("" if earlier is None else f" | phases 4, 23, 25 counted {earlier}"), flush=True)
    if any(c != want for c in counts_d.values()):
        fail("[26d] a default-backend caller did not launch rows 1 and 3 once per call")
    out["default_launches"] = counts_d
    return out


def reach_sweep(mode: str, seeds) -> None:
    """``--reach MODE --seeds ...``: phase 7 alone, for one mode on any
    seeds; prints one JSON line of the per-seed metrics and exits non-zero
    if a seed misses the gate."""
    dev = torch.device("cuda", 0)
    phase_reach(dev, (mode,), seeds, summary=phase_build(dev))


SELECTABLE = {"10": lambda dev, errs: phase_sharded(dev),
              "26": lambda dev, errs: phase_backends(dev, errs)}


def run_selected(names) -> None:
    """``--phases 10,26``: the build, then those phases alone, each with its
    gates; prints the phase walls, the ``nvidia-smi`` line and an ``ok``
    line naming the phases (no ``kernels`` line: it needs every phase)."""
    unknown = [n for n in names if n not in SELECTABLE]
    if unknown:
        fail(f"no phase {unknown} to run alone; choose from {sorted(SELECTABLE)}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smi = phase_build(dev)
    walls = [("1", time.perf_counter() - t0)]
    errs = dict.fromkeys(("wb_cost", "wb_update"), 0.0)
    for name in names:
        t0 = time.perf_counter()
        SELECTABLE[name](dev, errs)
        walls.append((name, time.perf_counter() - t0))
    print("[t] wall s per phase: " + ", ".join(f"{n} {w:.1f}" for n, w in walls)
          + f" | total {sum(w for _, w in walls):.1f}", flush=True)
    print(smi)
    print(json.dumps({"ok": True, "phases": names,
                      "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch/CUDA port.")
    ap.add_argument("--reach", choices=sorted(REACH_MODES),
                    help="run phase 7 alone, in this mode, on --seeds")
    ap.add_argument("--seeds", default=",".join(map(str, REACH_SEEDS)),
                    help="comma-separated solver seeds for --reach")
    ap.add_argument("--phases", help="comma-separated phases to run alone after the build "
                    f"(of {','.join(SELECTABLE)})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if args.reach:
        reach_sweep(args.reach, tuple(int(x) for x in args.seeds.split(",")))
        return
    if args.phases:
        run_selected(args.phases.split(","))
        return
    dev = torch.device("cuda", 0)
    walls = []

    def lap(name, fn, *fn_args):
        """``fn(*fn_args)``, its wall time kept for the phase-time line."""
        t0 = time.perf_counter()
        out = fn(*fn_args)
        walls.append((name, time.perf_counter() - t0))
        return out

    smi = lap("1", phase_build, dev)
    errs = dict.fromkeys(("wb_cost", "wb_update", "plant_tick", "wb_cost_nospill",
                          "wb_update_regen", "wb_update_shard_regen", "wb_update_shard"), 0.0)
    lap("2", phase_kernels, dev, errs)
    lap("3", phase_philox, dev)
    launches, solve_ms, serve = lap("4", phase_serving, dev)
    t, bounds = lap("4t", phase_timing, dev)
    serve_busy = lap("4p", phase_profile, serve, solve_ms)
    t_plant, plant_bound, plant_bound_b1024 = lap("5", phase_plant, dev, errs)
    episode_launches, step_ms, episode_busy = lap("6", phase_episode, dev)
    reach_ms, _ = lap("7", phase_reach, dev)
    batch_launches, t_b256, batch_rows, b256_bounds = lap("8", phase_batch, dev, errs)
    t_k4096 = lap("9", phase_nospill, dev)
    shard = lap("10", phase_sharded, dev)
    errs.update(shard["kernel_err_all_ranks"])
    drone_sweep, drone_host, drone_floor = lap("11", phase_drone_kernels, dev, errs)
    drone_launches, drone_loop_ms, drone_busy = lap("12", phase_drone_loops, dev)
    drone_batch_ms = lap("12d", phase_drone_batch, dev)
    rows_sweep = lap("13", phase_update_rows, dev)
    cost_sweep = lap("14", phase_cost_shapes, dev)
    fleet = lap("15", phase_fleet, dev)
    arm_node = lap("16", phase_arm, dev)
    pick = lap("17", phase_pick, dev, errs)
    multirotor = lap("18", phase_multirotor, dev)
    fixed_wing = lap("19", phase_fixed_wing, dev)
    mapped = lap("20", phase_mapped, dev)
    plain = lap("21", phase_plain, dev)
    rotor = lap("22", phase_rotorcraft, dev)
    bridge_out = lap("23", phase_bridge, dev, errs)
    camera = lap("24", phase_camera_cli, dev, errs)
    offline = lap("25", phase_offline, dev, errs, solve_ms["graphed"], camera["survey_log"])
    backends = lap("26", phase_backends, dev, errs, {
        "4": launches, "23": bridge_out["whole-body"]["launches"], "25": offline["launches"]})
    print("[t] wall s per phase: " + ", ".join(f"{n} {w:.1f}" for n, w in walls)
          + f" | total {sum(w for _, w in walls):.1f}", flush=True)
    b256 = {(b, spill): e_ms for b, spill, _, e_ms, _, _, _ in batch_rows}
    shard_bounds = {k: bound(*v) for k, v in new_work(K // SHARD_RANKS).items()}

    def vs_library(kern, lib, prefix=""):
        """A pass-2 kernel's device ms beside the library call's, both from
        this run (profiler, may be null; CUDA-graph replay), and their
        ratio by the graph times."""
        return {f"{prefix}device_ms": kern["device_ms"], f"{prefix}graph_ms": kern["graph_ms"],
                f"{prefix}library_device_ms": lib["device_ms"],
                f"{prefix}library_graph_ms": lib["graph_ms"],
                f"{prefix}library_ratio": kern["graph_ms"] / lib["graph_ms"]}

    def at_b256(name):
        return {"device_ms": t_b256[f"{name}_device"], "graph_ms": t_b256[f"{name}_graph"]}

    def rows_of(row, b, prefix=""):
        """The R the launcher used at a wb_update shape and phase 13's
        graph ms at every R there."""
        sw = rows_sweep[(row, b)]
        return {f"{prefix}rows_per_block": sw["rows_per_block"],
                f"{prefix}rows_sweep_graph_ms": sw["graph_ms"]}

    def new_row(name, replaces, launches_n, ms, plain_ms, bound_ms, library_ms, **extra):
        """Rows 4-7: every number from the shape the main path gives the
        kernel (B=256 for rows 4-5, K_local for rows 6-7), and its one-scenario
        K=4096 times of phase 9 beside them."""
        one = t_k4096[name]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": f"{TPU_KERNEL}:{replaces}", "launches": launches_n,
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms[0], "bound_by": bound_ms[1], "library_ms": library_ms,
                **extra, "k4096_b1_ms": one["ms"], "k4096_b1_device_ms": one["device_ms"],
                "k4096_b1_graph_ms": one["graph_ms"], "k4096_b1_plain_ms": one["plain_ms"]}

    def shapes_of(variant, prefix=""):
        """Phase 14's attitude-mode graph ms at every shape for
        wb_cost_launch's ``variant``."""
        return {f"{prefix}shape_sweep_graph_ms": {
            label: cost_sweep[(label, "attitude", variant)]["graph_ms"]
            for label, _, _, _ in COST_SHAPES}}

    def batch_row(name, replaces, library_ms, **extra):
        return new_row(name, replaces, batch_launches[name], t_b256[name],
                       t_b256[name + "_plain"], b256_bounds[name], library_ms, b=B_BATCH,
                       **extra)

    def shard_row(name, replaces, row):
        tm, lib = shard["timing"][name], shard["timing"]["library_mv"]
        return new_row(name, replaces, shard["launches"][name], tm["ms"], tm["plain_ms"],
                       shard_bounds[name], lib["ms"], k_local=K // SHARD_RANKS,
                       **vs_library(tm, lib), **rows_of(row, 1))

    kernels = [
        {"name": "wb_cost", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:575 _cost_kernel_store, {TPU_KERNEL}:564 _cost_kernel_noise",
         "launches": launches["wb_cost"], "max_abs_err": errs["wb_cost"],
         "ms": t["wb_cost"], "plain_ms": t["wb_cost_plain"],
         "bound_ms": bounds["wb_cost"][0], "bound_by": bounds["wb_cost"][1],
         "library_ms": None,
         "noise_ms": t["wb_cost_noise"], "noise_plain_ms": t["wb_cost_noise_plain"],
         "noise_bound_ms": bounds["wb_cost_noise"][0],
         "noise_bound_by": bounds["wb_cost_noise"][1],
         "episode_launches": episode_launches["wb_cost"],
         "pick_lift_launches": pick["lift_launches"]["wb_cost"],
         "whole_body_launches": multirotor["whole_body_launches"]["wb_cost"],
         "bridge_launches": bridge_out["whole-body"]["launches"]["wb_cost"],
         "cli_launches": {k: v["wb_cost"] for k, v in camera["launches"].items()},
         "dataset_launches": offline["launches"]["wb_cost"],
         "b256_ms": t_b256["wb_cost"],
         "layout": COST_LAYOUT, "noise_layout": COST_LAYOUT,
         "graph_ms": t["wb_cost_graph"], "device_ms": t["wb_cost_device"],
         "noise_graph_ms": t["wb_cost_noise_graph"], "noise_device_ms": t["wb_cost_noise_device"],
         **shapes_of(1), **shapes_of(0, "noise_")},
        {"name": "wb_update", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": f"{TPU_KERNEL}:655 _update_kernel_fused_noise (_fused_update_body :624)",
         "launches": launches["wb_update"], "max_abs_err": errs["wb_update"],
         "ms": t["wb_update"], "plain_ms": t["wb_update_plain"],
         "bound_ms": bounds["wb_update"][0], "bound_by": bounds["wb_update"][1],
         "library_ms": t["library_mv"], "episode_launches": episode_launches["wb_update"],
         "pick_lift_launches": pick["lift_launches"]["wb_update"],
         "whole_body_launches": multirotor["whole_body_launches"]["wb_update"],
         "bridge_launches": bridge_out["whole-body"]["launches"]["wb_update"],
         "cli_launches": {k: v["wb_update"] for k, v in camera["launches"].items()},
         "dataset_launches": offline["launches"]["wb_update"],
         **vs_library(t_k4096["wb_update"], t_k4096["library_mv"]), **rows_of("3", 1),
         "b256_ms": t_b256["wb_update"], "b256_bound_ms": b256_bounds["wb_update"][0],
         **vs_library(at_b256("wb_update"), at_b256("library_bmm"), "b256_"),
         **rows_of("3", B_BATCH, "b256_")},
        {"name": "plant_tick", "route": "cuda", "source": PLANT_SOURCE,
         "replaces": f"{PLANT_TPU_KERNEL}:116 make_plant_tick_kernel (kernel :137)",
         "launches": episode_launches["plant_tick"], "max_abs_err": errs["plant_tick"],
         "ms": t_plant["plant_tick"], "plain_ms": t_plant["plant_tick_plain"],
         "bound_ms": plant_bound[0], "bound_by": plant_bound[1], "library_ms": None,
         "layout": PLANT_LAYOUT, "graph_ms": t_plant["plant_tick_graph"],
         "pick_lift_launches": pick["lift_launches"]["plant_tick"],
         "payload_max_abs_err": pick["payload_err"],
         "launch_floor_ms": t_plant["launch_floor"],
         "b1024_ms": t_plant["plant_tick_b1024"],
         "b1024_graph_ms": t_plant["plant_tick_b1024_graph"],
         "b1024_plain_ms": t_plant["plant_tick_plain_b1024"],
         "b1024_bound_ms": plant_bound_b1024[0], "b1024_bound_by": plant_bound_b1024[1]},
        batch_row("wb_cost_nospill", "551 _cost_kernel", None,
                  layout=COST_LAYOUT,
                  k_local_graph_ms=cost_sweep[("K_local", "attitude", 2)]["graph_ms"],
                  **shapes_of(2)),
        batch_row("wb_update_regen", "647 _update_kernel_fused", t_b256["library_bmm"],
                  **vs_library(at_b256("wb_update_regen"), at_b256("library_bmm")),
                  **rows_of("5", B_BATCH)),
        shard_row("wb_update_shard_regen", "607 _update_kernel", "6"),
        shard_row("wb_update_shard", "616 _update_kernel_noise", "7"),
    ]

    def drone_row(name, k, launches_n):
        """Rows 9a-9d: the numbers at the K of the loop that counts the
        launches (phase 12a: the preset K=1000; 12b: K=1024), the sweep
        of phase 11 beside them."""
        s = drone_sweep[(name, k, DRONE_H)]
        return {"name": name, "route": "cuda", "source": DRONE_SOURCE,
                "replaces": f"{DRONE_TPU_KERNEL}:{DRONE_REPLACES[name]}", "launches": launches_n,
                "max_abs_err": errs[name], "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                "library_ms": s["library_ms"], "device_ms": s["device_ms"],
                "library_device_ms": s["library_device_ms"], "k": k, "h": DRONE_H,
                "graph_ms": s["graph_ms"], "launch_floor_ms": drone_floor,
                "layout": COST_LAYOUT if "cost" in name else UPDATE_LAYOUT,
                **({"library_graph_ms": s["library_graph_ms"], "split": s["split"]}
                   if "update" in name else {}),
                "sweep": [v for (n, _, _), v in drone_sweep.items() if n == name]}

    kernels += [drone_row("drone_cost", DRONE_K, drone_launches["a"]["drone_cost"]),
                drone_row("drone_update", DRONE_K, drone_launches["a"]["drone_update"]),
                drone_row("drone_cost_noise", DRONE_NOISE_K,
                          drone_launches["b"]["drone_cost_noise"]),
                drone_row("drone_update_noise", DRONE_NOISE_K,
                          drone_launches["b"]["drone_update_noise"])]
    print(json.dumps({"kernels": kernels}))
    def share(busy):
        """The busy share of the profiled wall, and the device time over the
        unprofiled step."""
        return "not measured" if busy is None else f"{busy[3]:.3f} ({busy[1]:.3f} x unprofiled)"

    print(f"serving solve {solve_ms['graphed']:.4f} ms graphed ({solve_ms['eager']:.4f} eager; "
          f"device busy share {share(serve_busy['graphed'])} / {share(serve_busy['eager'])}), "
          f"serving episode {step_ms['graphed']:.4f} ms/control step graphed "
          f"({step_ms['eager']:.4f} eager; busy share {share(episode_busy['graphed'])} / "
          f"{share(episode_busy['eager'])}), reach episodes (graphed) "
          + ", ".join(f"{m} {v:.3f}" for m, v in reach_ms.items()) + " ms/control step, "
          f"fleet B={FLEET_B} x K={FLEET_K} {fleet['b16_ms']:.3f} ms per fleet step "
          f"({fleet['b16_rate'] / 100:.1f} vehicles at 100 Hz, gate held {fleet['held']}/"
          f"{FLEET_B}), B={FLEET_B_TIMED} {fleet['b256_ms']:.3f} ms per fleet step "
          f"({fleet['b256_rate'] / 100:.1f} vehicles at 100 Hz, busy share "
          f"{share(fleet['b256_busy'])}, peak {fleet['peak_gib']:.2f} GiB), "
          f"batched solve at B={B_BATCH} {b256[(B_BATCH, True)]:.3f} ms (spill) / "
          f"{b256[(B_BATCH, False)]:.3f} ms (no spill), sharded solve "
          f"{shard['ms']['spill']:.3f} ms, drone kernel solve {drone_host['kernel_solve']:.4f} ms "
          f"/ preset step {drone_host['make_drone_solver_step']:.4f} ms at K={DRONE_NOISE_K}, "
          f"drone episode {drone_loop_ms['c']:.3f} ms/control step graphed "
          f"({drone_loop_ms['c_eager']:.3f} eager; busy share {share(drone_busy['graphed'])} / "
          f"{share(drone_busy['eager'])}), batched drone preset at B={B_DRONE} "
          f"{drone_batch_ms:.3f} ms, arm control step {arm_node['graphed_ms']:.3f} ms graphed "
          f"({arm_node['eager_ms']:.3f} eager; busy share {share(arm_node['busy']['graphed'])} / "
          f"{share(arm_node['busy']['eager'])}), pick_weight K={PICK_K} ms/control step "
          "(seed 0, captures included) "
          + ", ".join(f"{k} {pick['stages'][k]:.3f}" for k in PICK_STAGES)
          + f", K={K} approach {pick['approach_ms']:.3f} / lift (serving) {pick['lift_ms']:.3f} "
          f"ms/control step graphed ({pick['approach_eager_ms']:.3f} / "
          f"{pick['lift_eager_ms']:.3f} eager), multirotor {multirotor['graphed_ms']:.3f} "
          f"ms/control step graphed ({multirotor['eager_ms']:.3f} eager; {fmt_ops(multirotor['graphed_ops'])} "
          f"device ops/step), whole-body perfect-model {multirotor['whole_body_ms']:.3f} "
          f"(capture included), fixed-wing {fixed_wing['graphed_ms']:.3f} graphed "
          f"({fixed_wing['eager_ms']:.3f} eager; {fmt_ops(fixed_wing['graphed_ops'])} ops/step), "
          f"mapped flight K={MAPPED_SERVING_K} "
          + ", ".join(f"{m} {mapped['serving_' + m]['graphed_ms']:.3f} graphed "
                      f"({mapped['serving_' + m]['eager_ms']:.3f} eager; "
                      f"{fmt_ops(mapped['serving_' + m]['graphed_ops'])} ops/step)"
                      for m in ("spheres", "esdf"))
          + ", plain whole-body solve (graphed) "
          + ", ".join(f"{n} {v['graphed_ms']:.3f} ms ({fmt_ops(v['ops'])} ops)"
                      for n, v in plain.items())
          + ", rotorcraft control step of 10 ticks (graphed / eager; ops per tick) "
          + ", ".join(f"{n} {rotor[n]['graphed_ms']:.3f} / {rotor[n]['eager_ms']:.3f} ms; "
                      f"{fmt_ops(rotor[n]['ops_per_tick'])}" for n in rotorcraft_builds(dev))
          + ", bridge round trip p50/p99 (head replay) "
          + ", ".join(f"{n} {bridge_out[n]['rtt_p50_ms']:.3f}/{bridge_out[n]['rtt_p99_ms']:.3f} "
                      f"ms ({bridge_out[n]['head_ms']:.4f})" for n in ("whole-body", "solver"))
          + f", sim adapter period {bridge_out['period_ms']:.4f} ms graphed (CUDA events; "
          f"{bridge_out['period_host_ms']:.4f} host clock; {bridge_out['period_eager_ms']:.3f} "
          f"eager), HIL tick "
          f"{bridge_out['hil_tick_ms']:.4f} ms ({bridge_out['hil_eager_tick_ms']:.4f} eager), "
          f"camera survey {camera['survey']['graphed_ms']:.3f} ms/control step graphed "
          f"({camera['survey']['eager_ms']:.3f} eager; {fmt_ops(camera['survey']['ops_per_tick'])} "
          f"ops per tick), {RENDER_W} x {RENDER_H} render of {N_RENDER} frames "
          f"{camera['render_ms']:.4f} ms, whole-body-full {camera['wb_full_ms']:.3f} ms/control "
          f"step (capture included), collected whole-body solve {offline['collect_ms']:.3f} ms "
          f"(capture included; time_fn {offline['time_fn']['mean_ms']:.4f}), plain packed "
          f"solve (zero-mean) {backends['packed']['graphed_ms']:.3f} ms graphed "
          f"({backends['packed']['eager_ms']:.3f} eager; {fmt_ops(backends['packed']['ops'])} "
          f"ops), plain session K={SESSION_TORCH_K} round trip p50/p99 "
          f"{backends['session']['rtt_p50_ms']:.3f}/{backends['session']['rtt_p99_ms']:.3f} ms "
          f"(head {backends['session']['head_ms']:.4f}; "
          f"{fmt_ops(backends['session']['head_ops'])} ops), sharded flight presets (host, "
          "two ranks on one card) " + ", ".join(
              f"{k.split(',')[0]} {v['ms']:.3f} ms" for k, v in shard["flight"].items()
              if v["ms"] is not None)
          + f" on {smi}")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
