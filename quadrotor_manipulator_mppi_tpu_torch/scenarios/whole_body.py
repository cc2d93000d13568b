"""Whole-body scenarios of the port: the pick_weight task.

Port of ``run_pick_weight`` of the JAX package's ``scenarios/whole_body.py``,
as a function that returns the scenario's metrics (the command line and its
output files are not ported).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..models import chain as chain_mod
from ..sim import graspable as gr
from ..sim import whole_body_loop as wbl
from ..solver import whole_body as wbs
from ..utils.device import resolve_device
from ..utils.pose import Pose

PAYLOAD_KG = 0.5  # the pick_weight weight (the JAX package's MissionConfig.payload_mass)


def _offset(pose: Pose, dz: float) -> Pose:
    up = torch.tensor([0.0, 0.0, dz], dtype=pose.position.dtype, device=pose.position.device)
    return Pose(position=pose.position + up, quat=pose.quat)


def run_pick_weight(seed: int = 0, steps: int = 700, n_samples: int = 256, device="cuda",
                    stage_ms: Optional[dict] = None) -> dict:
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
    warm-up steps and the graph capture included)."""
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
    return {"grasped": True, "grasp_hold_err_m": round(grasp_err, 4),
            "lift_min_err_m": round(float(e2.min()), 4),
            "lift_final_err_m": round(float(e2[-1]), 4),
            "max_tilt_rad": round(float(max(t1.max(), log2.tilt.max().item())), 3),
            "payload_kg": PAYLOAD_KG,
            "stand_obstacle": [round(x, 3) for x in stand_center]}
