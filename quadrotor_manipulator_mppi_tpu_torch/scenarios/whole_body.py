"""Whole-body scenarios of the port on the full plant: the flagship closed
loop, the pick_weight task and the batched multi-scenario episode.

Port of the JAX package's ``scenarios/whole_body.py``, each scenario a
function that returns the JAX scenario's metrics (``run.py`` is their
command line).  On the card the solver is the kernel pipeline
(``make_whole_body_episode``'s ``backend="cuda"``: rows 1 and 3 of the
kernel table once per control step), on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..evaluation.metrics import episode_quality
from ..models import chain as chain_mod
from ..sim import graspable as gr
from ..sim import whole_body_loop as wbl
from ..solver import whole_body as wbs
from ..utils.device import resolve_device
from ..utils.pose import Pose
from .common import maybe_resume, maybe_save

PAYLOAD_KG = 0.5  # the pick_weight weight (the JAX package's MissionConfig.payload_mass)


def full_mode_params(mode: str = "position", n_samples: int = 512,
                     n_horizon: int = 50) -> wbs.WholeBodyMPPIParams:
    """The preset of a control mode at K=``n_samples``: the position
    cascade, the attitude preset (the benchmark headline; it needs K >=
    ~2048 in closed loop) or direct wrench with its stabilizers."""
    if mode == "position":
        return wbs.position_mode_params(n_samples=n_samples, n_horizon=n_horizon)
    if mode == "wrench":
        return wbs.wrench_mode_params(n_samples=n_samples, n_horizon=n_horizon)
    if mode != "attitude":
        raise ValueError(f"unknown mode {mode!r}")
    base = wbs.WholeBodyMPPIParams()
    return dataclasses.replace(base, mppi=dataclasses.replace(
        base.mppi, n_samples=n_samples, n_horizon=n_horizon))


def run_whole_body_full(seed: int = 0, steps: int = 1000, device="cuda", mode: str = "position",
                        n_samples: Optional[int] = None, n_horizon: int = 50,
                        save_state: Optional[str] = None, resume: Optional[str] = None,
                        logs: Optional[dict] = None) -> dict:
    """Whole-body MPPI on the full plant (quaternion body, rotor lag, the
    per-substep RNEA arm dynamics), the flagship closed loop, in ``mode``
    at K=``n_samples`` (512 by default), on the hover + reach task.
    ``resume`` starts from a ``save_state`` checkpoint of (plant, solver
    state): the run continues the uninterrupted one's noise stream.
    Returns the JAX scenario's metrics; ``logs``, if given, receives its
    log arrays."""
    dev = resolve_device(device)
    params = full_mode_params(mode, n_samples or 512, n_horizon)
    run = wbl.make_whole_body_episode(params, n_control_steps=steps, device=dev)
    _, init = wbs.make_whole_body_solver(params, device=dev, low_k_guard="off")
    obs0 = wbs.default_obs(device=dev)
    plant, solver = maybe_resume(resume, (wbl.init_plant(params.model.vehicle, device=dev),
                                          init(seed)), dev)
    final, lg = run(plant, solver, obs0.ee_target, obs0.base_target)
    maybe_save(save_state, (final[0], final[1]))
    e = lg.ee_err.cpu().numpy()
    arrays = {f: getattr(lg, f).cpu().numpy()
              for f in ("ee_err", "l1_cmd", "l1_meas", "ori_err", "base_pos", "tilt")}
    if logs is not None:
        logs.update(arrays)
    return {"min_ee_err_m": round(float(e.min()), 4), "final_ee_err_m": round(float(e[-1]), 4),
            **episode_quality(arrays["l1_cmd"], arrays["l1_meas"], min(300, steps // 3)),
            "max_tilt_rad": round(float(arrays["tilt"].max()), 3),
            "min_alt_m": round(float(arrays["base_pos"][:, 2].min()), 3)}


def run_whole_body_batch(seed: int = 0, steps: int = 1000, device="cuda", n_scenarios: int = 32,
                         n_samples: int = 2048, hold: float = 0.99,
                         logs: Optional[dict] = None) -> dict:
    """The batched closed loop, the production-serving shape: one fleet
    episode of ``n_scenarios`` vehicles (``make_whole_body_episode(
    n_scenarios=B)``; position mode, K=``n_samples``, H=50, the
    frozen-coefficient plant of the JAX loop configuration) from randomized
    starts and EE targets (``sim/whole_body_loop.fleet_starts``).  A first
    run carries the capture; the second is timed, ending in a synchronize
    on the card.

    A scenario passes the gate only if, after its debounced convergence to
    the reference's 5 mm commanded-EE gate, it holds the gate for at least
    ``hold`` of the remaining steps.  Returns the JAX scenario's metrics;
    ``logs``, if given, receives ``l1_cmd``, ``l1_meas`` and ``ee_err``
    (B, steps)."""
    dev = resolve_device(device)
    params = wbs.position_mode_params(n_samples=n_samples, n_horizon=50)
    run = wbl.make_whole_body_episode(
        params, n_control_steps=steps, device=dev, n_scenarios=n_scenarios,
        cfg=wbl.WholeBodyLoopConfig(arm_coeffs_per_control=True, substep_unroll=10))
    starts = wbl.fleet_starts(params, n_scenarios, seed=seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run(*starts)  # the warm run carries the capture
    sync()
    t0 = time.perf_counter()
    _, lg = run(*starts)
    sync()
    wall = time.perf_counter() - t0

    l1c, l1m = lg.l1_cmd.cpu().numpy(), lg.l1_meas.cpu().numpy()   # (B, steps)
    tail_n = min(100, steps // 3)
    per = [episode_quality(l1c[i], l1m[i], tail_n) for i in range(n_scenarios)]
    held = np.asarray([p["held_fraction_after_converge"] for p in per])
    conv = np.asarray([p["converged_step"] for p in per])
    meas_tail_max = np.asarray([p["l1_meas_tail_max_mm"] for p in per])
    gate_held = (conv >= 0) & (held >= hold)
    if logs is not None:
        logs.update(l1_cmd=l1c, l1_meas=l1m, ee_err=lg.ee_err.cpu().numpy())
    return {"scenarios": n_scenarios, "k": n_samples, "steps": steps, "hold_gate": hold,
            "wall_s": round(wall, 1), "episodes_per_s": round(n_scenarios / wall, 2),
            "control_steps_per_s": round(n_scenarios * steps / wall, 1),
            "gate_held_fraction": round(float(gate_held.mean()), 3),
            "median_converge_step": int(np.median(conv[conv >= 0])) if (conv >= 0).any() else -1,
            "reach_gate_fraction": round(float((l1c < 0.005).any(1).mean()), 3),
            "held_min": round(float(held.min()), 3),
            "l1_cmd_tail_mean_mm": round(float(l1c[:, -tail_n:].mean()) * 1000, 2),
            "l1_cmd_tail_p95_mm": round(float(np.percentile(l1c[:, -tail_n:], 95)) * 1000, 2),
            "l1_meas_tail_max_mm": round(float(meas_tail_max.max()), 2),
            "max_tilt_rad": round(float(lg.tilt.max()), 4)}


def _offset(pose: Pose, dz: float) -> Pose:
    up = torch.tensor([0.0, 0.0, dz], dtype=pose.position.dtype, device=pose.position.device)
    return Pose(position=pose.position + up, quat=pose.quat)


def run_pick_weight(seed: int = 0, steps: int = 700, n_samples: int = 256, device="cuda",
                    stage_ms: Optional[dict] = None, logs: Optional[dict] = None) -> dict:
    """Fly the whole-body system to the graspable weight resting on its
    support stand, close the gripper (the grasp holds only if the measured
    end effector reached the object where it is), then lift it 0.4 m, all
    on the full plant (the per-substep RNEA plant) with the kernel solve at
    K=``n_samples``, H=50.

    The stand is scene geometry in the solver's cost (a sphere obstacle)
    and the object's rest.  The approach is staged: the pre-grasp pose
    0.12 m above the object, then a vertical descent with the open fingers
    straddling it.  For the lift the plant carries the payload on link 7
    while the solver is told only the added lump mass, as the reference's
    controller is.

    Returns the JAX scenario's metrics.  ``stage_ms``, if given, receives
    the host ms per control step of each stage (``approach``, ``descent``,
    ``lift``), each ending in a synchronize (on the card its two eager
    warm-up steps and the graph capture included).  ``logs``, if given,
    receives ``reach_err`` and ``obj_pos`` (no grasp) or ``reach_err``
    and ``lift_err``."""
    dev = resolve_device(device)
    params = wbs.position_mode_params(n_samples=n_samples, n_horizon=50)
    obs0 = wbs.default_obs(device=dev)
    grasp_target = obs0.ee_target
    payload_pos = grasp_target.position.cpu().numpy().astype(np.float64)
    # The support stand: a column under the payload (its top just below the
    # grasp point), a sphere obstacle in the solver's cost.
    stand_center = tuple(float(x) for x in payload_pos + np.asarray([0.0, 0.0, -0.35]))
    params = dataclasses.replace(params, cost=dataclasses.replace(
        params.cost, obstacle_weight=100.0, obstacle_centers=(stand_center,),
        obstacle_radii=(0.25,)))
    _, init = wbs.make_whole_body_solver(params, device=dev)
    plant = wbl.init_plant(params.model.vehicle, device=dev)
    solver = init(seed)
    phase1 = max(steps * 2 // 3, 100)
    half = max(steps - phase1, 100)
    gp = gr.GraspableParams(mass=PAYLOAD_KG, stand_center_xy=stand_center[:2],
                            stand_top_z=float(payload_pos[2]) - 0.04, stand_radius=0.25)
    obj = gr.init_graspable(gp, pos=tuple(payload_pos), device=dev)

    def timed(run, n, args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = run(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, (time.perf_counter() - t0) * 1e3 / n

    def stage(name, run, n, *args):
        if stage_ms is None:
            return run(*args)
        out, stage_ms[name] = timed(run, n, args)
        return out

    # Approach: the pre-grasp pose above the object, gripper open; from
    # above, so the lateral transient stays away from the free body.
    p1a = max(phase1 * 3 // 5, 60)
    p1b = max(phase1 - p1a, 60)
    run1a = wbl.make_whole_body_episode(params, n_control_steps=p1a, graspable=gp, device=dev)
    (plant, solver, _, _, obj), log1a = stage("approach", run1a, p1a, plant, solver,
                                              _offset(grasp_target, 0.12), obs0.base_target, obj)
    # Descent onto the weight: the open fingers straddle it, so the palm
    # contact engages only once the object reaches the palm.
    run1b = wbl.make_whole_body_episode(params, n_control_steps=p1b, graspable=gp, device=dev)
    (plant, solver, _, _, obj), log1b = stage("descent", run1b, p1b, plant, solver,
                                              grasp_target, obs0.base_target, obj)
    e1 = torch.cat([log1a.ee_err, log1b.ee_err]).cpu().numpy()
    t1 = torch.cat([log1a.tilt, log1b.tilt]).cpu().numpy()
    obj_track = torch.cat([log1a.obj_pos, log1b.obj_pos]).cpu().numpy()
    grasp_err = float(e1[-50:].mean())
    obj_max_disp = float(np.linalg.norm(obj_track - payload_pos, axis=-1).max())

    # The gripper closes on the object where it actually is.
    ee_pos, _ = chain_mod.forward_kinematics_posquat(
        params.model.chain(), plant.q, base_pos=plant.base.pos, base_quat=plant.base.quat)
    ee_obj_dist = float(torch.linalg.norm(ee_pos - obj.pos))
    if not ee_obj_dist < gp.grasp_tol:
        if logs is not None:
            logs.update(reach_err=e1, obj_pos=obj_track)
        return {"grasped": False, "grasp_hold_err_m": round(grasp_err, 4),
                "ee_to_object_m": round(ee_obj_dist, 4),
                "object_max_disp_m": round(obj_max_disp, 4), "payload_kg": PAYLOAD_KG}

    # Lift: the plant carries the payload on link 7 (mass, centre of mass,
    # the gravity moment on the base); the solver knows only the lump.
    params2 = dataclasses.replace(params, model=dataclasses.replace(
        params.model, arm_mass_lump=params.model.arm_mass_lump + PAYLOAD_KG))
    run2 = wbl.make_whole_body_episode(
        params2, cfg=wbl.WholeBodyLoopConfig(payload_mass=PAYLOAD_KG,
                                             plant_arm_lump=params.model.arm_mass_lump),
        n_control_steps=half, device=dev)
    _, log2 = stage("lift", run2, half, plant, solver, _offset(grasp_target, 0.4),
                    obs0.base_target)
    e2 = log2.ee_err.cpu().numpy()
    if logs is not None:
        logs.update(reach_err=e1, lift_err=e2)
    return {"grasped": True, "grasp_hold_err_m": round(grasp_err, 4),
            "lift_min_err_m": round(float(e2.min()), 4),
            "lift_final_err_m": round(float(e2[-1]), 4),
            "max_tilt_rad": round(float(max(t1.max(), log2.tilt.max().item())), 3),
            "payload_kg": PAYLOAD_KG,
            "stand_obstacle": [round(x, 3) for x in stand_center]}
