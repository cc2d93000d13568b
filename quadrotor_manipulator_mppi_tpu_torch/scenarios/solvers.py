"""Single-solver scenarios of the port: the reference's drone and arm
nodes, the perfect-model whole-body and multirotor loops, the fixed-wing
flyby and mapped flight.

Port of the JAX package's ``scenarios/solvers.py``, each scenario a
function that returns the JAX scenario's metrics (``run.py`` is their
command line).  Each builds its episode with an ``*_episode`` function, ``(run,
start)``: ``run(start(seed))`` is one episode, on the card one captured
control step replayed per step (``graph=False`` runs it eagerly).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..evaluation import metrics as metrics_mod
from ..models import chain as chain_mod
from ..models import fixed_wing as fw
from ..models import multirotor as mr
from ..models import whole_body as wbm
from ..models.multirotor import Multirotor12State
from ..models.whole_body import WholeBodyState
from ..sim import arm_loop, mapped_loop
from ..sim import closed_loop as cl
from ..sim import flight_control as fc
from ..solver import arm as arm_solver
from ..solver import drone as drone_solver
from ..solver import fixed_wing as fw_solver
from ..solver import mapped as mapped_solver
from ..solver import multirotor_mppi as mm
from ..solver import whole_body as wbs
from ..solver.mppi import device_counters
from ..utils import graphs
from ..utils import rotations as rot
from ..utils.device import resolve_device
from .common import maybe_resume, maybe_save, perfect_model_episode


def _with_samples(params, n_samples: Optional[int]):
    if n_samples is None:
        return params
    return dataclasses.replace(params, mppi=dataclasses.replace(params.mppi,
                                                                n_samples=n_samples))


def _base12(base: wbm.BaseTraj) -> Multirotor12State:
    """A (1, 1) rollout BaseTraj -> the reduced state it ends in."""
    ang = rot.matrix_to_euler(rot.quat_to_matrix(base.quat[0, 0]), "ZYX")
    return Multirotor12State(pos=base.pos[0, 0], rpy=torch.stack([ang[2], ang[1], ang[0]]),
                             vel=base.vel[0, 0], omega=base.omega[0, 0])


def drone_waypoint_episode(n_steps: int, device="cuda", graph: bool = True,
                           controller: str = "backstepping"):
    """The reference's drone node: the point-mass MPPI preset
    (``solver/drone.make_drone_solver``, K=1000, H=32, the plain pipeline
    as the JAX preset runs XLA) sets the position setpoint of the pid
    (``SIM_TUNED_GAINS``) or backstepping inner loop of the octorotor, from
    rest at (0, 0, 2) toward ``DEFAULT_TARGET``.  ``(run, start)``;
    ``run(start(seed))`` is one ``sim/closed_loop.make_episode`` episode,
    its logs the position, attitude and velocity after each step."""
    if controller not in ("pid", "backstepping"):
        raise SystemExit("drone-waypoint drives the pid/backstepping inner loop; "
                         "use 'hover --controller lee' for the Lee controller")
    dev = resolve_device(device)
    veh = mr.MultirotorParams()
    target = torch.tensor(drone_solver.DEFAULT_TARGET, device=dev)
    step, init = drone_solver.make_drone_solver(device=dev)
    cfg = cl.LoopConfig(controller=controller)
    run = cl.make_episode(
        cfg, veh, fc.SIM_TUNED_GAINS if controller == "pid" else fc.FlightGains(), step,
        make_obs=lambda p: drone_solver.DroneObs(x=p.pos, v=p.vel, target=target),
        setpoint_of=lambda out, p: fc.hover_setpoint(out.xdes), n_control_steps=n_steps,
        graph=graph)
    return run, lambda seed=0: cl.init_loop_state(cfg, veh, init(seed), pos=(0.0, 0.0, 2.0),
                                                  device=dev)


def run_drone_waypoint(seed: int = 0, steps: int = 1000, device="cuda",
                       controller: str = "backstepping", save_state: Optional[str] = None,
                       resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """Fly ``drone_waypoint_episode`` (the Lee controller is refused with
    SystemExit, as the JAX scenario refuses it).  Returns the JAX
    scenario's metrics: the least and last distance to the target and the
    response time into 0.5 m of it; ``logs``, if given, receives ``pos``,
    ``rpy`` and ``vel``.  ``save_state``/``resume`` checkpoint the loop
    state (the solver's key and solve index included)."""
    dev = resolve_device(device)
    run, start = drone_waypoint_episode(steps, dev, controller=controller)
    final, (pos, rpy, vel) = run(maybe_resume(resume, start(seed), dev))
    maybe_save(save_state, final)
    target = torch.tensor(drone_solver.DEFAULT_TARGET, device=dev)
    reach_t = metrics_mod.waypoint_response(pos, target, dt=0.01, radius=0.5)
    pos_np = pos.cpu().numpy()
    err = np.linalg.norm(pos_np - np.asarray(drone_solver.DEFAULT_TARGET), axis=-1)
    if logs is not None:
        logs.update(pos=pos_np, rpy=rpy.cpu().numpy(), vel=vel.cpu().numpy())
    return {"min_err_m": round(float(err.min()), 4), "final_err_m": round(float(err[-1]), 4),
            "response_time_s": round(float(reach_t), 2)}


def run_arm_reach(seed: int = 0, steps: int = 800, device="cuda",
                  logs: Optional[dict] = None) -> dict:
    """The arm node at its preset (K=100, H=32, A=7): phase 1 homes the arm,
    MPPI takes over and reaches for the demo target.  Returns the JAX
    scenario's metrics: whether MPPI engaged (``phase2``) and the least and
    last L1 error of the commanded EE position; ``logs``, if given,
    receives ``q``, ``ee_err`` and ``tau`` per step."""
    dev = resolve_device(device)
    params = arm_solver.ArmMPPIParams()
    _, init = arm_solver.make_arm_solver(params, device=dev)
    run = arm_loop.make_arm_episode(params=params, n_control_steps=steps, device=dev)
    final, (q, err, tau) = run(arm_loop.init_arm_loop(init(seed), device=dev))
    err = err.cpu()
    if logs is not None:
        logs.update(q=q.cpu().numpy(), ee_err=err.numpy(), tau=tau.cpu().numpy())
    return {"phase2": bool(final.phase2),
            "min_ee_err_m": round(float(err.min()), 4),
            "final_ee_err_m": round(float(err[-1]), 4)}


def whole_body_episode(params: wbs.WholeBodyMPPIParams, n_steps: int, device="cuda",
                       graph: bool = True):
    """The perfect-model whole-body loop: ``make_whole_body_solver`` (the
    CUDA kernels on the card, their plain versions on the CPU) on the hover
    + reach task of ``default_obs``, the plant one step of the solver's own
    rollout model (attitude-mode actions are setpoints).  ``(run, start)``;
    the logs are the EE error and the base position after each step."""
    dev = resolve_device(device)
    step, init = wbs.make_whole_body_solver(params, device=dev)
    obs0 = wbs.default_obs(device=dev)
    spec = params.model.chain()

    def plant_step(state: WholeBodyState, action):
        _, q, qdot, base = wbm.rollout(params.model, state, action[None, None, :], 0.01)
        return WholeBodyState(base=_base12(base), q=q[0, 0], qdot=qdot[0, 0])

    def log_of(state: WholeBodyState):
        ee_pos, _ = chain_mod.forward_kinematics_posquat(
            spec, state.q, base_pos=state.base.pos,
            base_quat=wbm._quat_from_rpy(state.base.rpy))
        return torch.linalg.norm(ee_pos - obs0.ee_target.position), state.base.pos

    run = perfect_model_episode(
        step, lambda st: wbs.WholeBodyObs(state=st, ee_target=obs0.ee_target,
                                          base_target=obs0.base_target),
        plant_step, log_of, n_steps, dev, graph)
    return run, lambda seed: (obs0.state, init(seed))


def run_whole_body(seed: int = 0, steps: int = 300, device="cuda",
                   n_samples: Optional[int] = None, save_state: Optional[str] = None,
                   resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """The whole-body perfect-model loop at its preset (K=4096, H=50,
    attitude mode; ``n_samples`` overrides K).  Returns the JAX scenario's
    metrics: the EE error after the first step, its least and last value,
    and the base's final altitude; ``logs``, if given, receives ``ee_err``
    and ``base_pos``.  ``save_state``/``resume`` checkpoint (state, solver
    state)."""
    dev = resolve_device(device)
    run, start = whole_body_episode(_with_samples(wbs.WholeBodyMPPIParams(), n_samples),
                                    steps, dev)
    final, (errs, base_pos) = run(maybe_resume(resume, start(seed), dev))
    maybe_save(save_state, final)
    errs, base_pos = errs.cpu(), base_pos.cpu()
    if logs is not None:
        logs.update(ee_err=errs.numpy(), base_pos=base_pos.numpy())
    return {"initial_ee_err_m": round(float(errs[0]), 4),
            "min_ee_err_m": round(float(errs.min()), 4),
            "final_ee_err_m": round(float(errs[-1]), 4),
            "base_alt_final_m": round(float(base_pos[-1, 2]), 3)}


def multirotor_episode(params: mm.MultirotorMPPIParams, target, n_steps: int, device="cuda",
                       graph: bool = True):
    """The perfect-model multirotor loop from rest at (0, 0, 2) toward
    ``target``; the plant is one step of the attitude rollout.  ``(run,
    start)``; the log is the distance to the target after each step."""
    dev = resolve_device(device)
    step, init = mm.make_multirotor_solver(params, device=dev)
    tgt = torch.tensor(target, dtype=torch.float32, device=dev)

    def plant_step(state: Multirotor12State, action):
        return _base12(wbm._base_rollout_attitude(
            params.model, WholeBodyState(base=state, q=None, qdot=None),
            action[None, None, :], 0.01))

    run = perfect_model_episode(
        step, lambda st: mm.MultirotorObs(state=st, target=tgt), plant_step,
        lambda st: (torch.linalg.norm(st.pos - tgt),), n_steps, dev, graph)

    def start(seed):
        zero = torch.zeros(3, device=dev)
        state = Multirotor12State(pos=torch.tensor([0.0, 0.0, 2.0], device=dev), rpy=zero,
                                  vel=zero, omega=zero)
        return state, init(seed)

    return run, start


MR_TARGET = (1.0, 2.0, 3.4)


def run_multirotor_waypoint(seed: int = 0, steps: int = 500, device="cuda",
                            n_samples: Optional[int] = None, save_state: Optional[str] = None,
                            resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """Quadrotor-only MPPI (12-state rigid-body rollouts, K=1024, H=30) to
    the waypoint ``MR_TARGET``.  Returns the JAX scenario's metrics: the
    least and last distance to it; ``logs``, if given, receives ``err``.
    ``save_state``/``resume`` checkpoint (state, solver state)."""
    dev = resolve_device(device)
    run, start = multirotor_episode(_with_samples(mm.MultirotorMPPIParams(), n_samples),
                                    MR_TARGET, steps, dev)
    final, (errs,) = run(maybe_resume(resume, start(seed), dev))
    maybe_save(save_state, final)
    errs = errs.cpu()
    if logs is not None:
        logs.update(err=errs.numpy())
    return {"min_err_m": round(float(errs.min()), 4),
            "final_err_m": round(float(errs[-1]), 4)}


FW_TARGET = (250.0, 60.0, 110.0)
FW_CRUISE = 15.0


def fixed_wing_episode(params: fw_solver.FwMPPIParams, n_steps: int, device="cuda",
                       graph: bool = True):
    """The fixed-wing flyby: one solve per 0.05 s, the plant integrating
    5 x 0.01 s substeps holding the commanded surfaces, from level flight at
    100 m and 15 m/s toward a waypoint ahead and off-axis.  ``(run,
    start)``; the logs are the position and the speed after each step."""
    dev = resolve_device(device)
    step, init = fw_solver.make_fixed_wing_solver(params, device=dev)
    target = torch.tensor(FW_TARGET, device=dev)
    cruise = torch.tensor(FW_CRUISE, device=dev)

    def control_step(carry, z):
        plant, sol = carry
        out, sol = step(sol, fw_solver.FwObs(state=plant, target=target, cruise_speed=cruise), z)
        for _ in range(5):
            plant = fw.step(params.aero, params.veh, plant, out.controls, 0.01)
        return (plant, sol), (plant.pos, torch.linalg.norm(plant.vel))

    run = graphs.episode_runner(control_step, lambda c: (c[0].pos, c[0].pos[0]), n_steps, dev,
                                graph)

    def start(seed):
        plant = fw.init_state(pos=(0.0, 0.0, 100.0), vel=(FW_CRUISE, 0.0, 0.0), device=dev)
        return plant, device_counters(init(seed), dev)

    return run, start


def run_fixed_wing(seed: int = 0, steps: int = 400, device="cuda",
                   n_samples: Optional[int] = None, save_state: Optional[str] = None,
                   resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """The fixed-wing waypoint flyby (K=1024 unless ``n_samples``).  Returns
    the JAX scenario's metrics: closest approach, whether it came within
    20 m, the least altitude and the mean speed; ``logs``, if given,
    receives ``pos`` and ``speed``.  ``save_state``/``resume`` checkpoint
    (plant, solver state)."""
    dev = resolve_device(device)
    run, start = fixed_wing_episode(_with_samples(fw_solver.FwMPPIParams(), n_samples or 1024),
                                    steps, dev)
    final, (pos, speed) = run(maybe_resume(resume, start(seed), dev))
    maybe_save(save_state, final)
    pos, speed = pos.cpu().numpy(), speed.cpu().numpy()
    if logs is not None:
        logs.update(pos=pos, speed=speed)
    dist = np.linalg.norm(pos - np.asarray(FW_TARGET), axis=-1)
    return {"closest_approach_m": round(float(dist.min()), 2),
            "reached": bool(dist.min() < 20.0),
            "min_altitude_m": round(float(pos[:, 2].min()), 2),
            "mean_speed_ms": round(float(speed.mean()), 2),
            "steps": steps}


def mapped_flight_episode(n_steps: int, device="cuda", n_samples: Optional[int] = None,
                          obstacles: str = "spheres", graph: bool = True):
    """Mapped flight: lidar -> occupancy grid -> map-aware MPPI (K=1024
    unless ``n_samples``) -> backstepping, through the hidden two-sphere
    scene of ``MappedFlightConfig``, the obstacles as the grid's top-64
    voxels (``obstacles="spheres"``) or its distance field (``"esdf"``).
    ``(run, start)``; the lidar's key is the seed + 1, the solver's the
    seed; the logs are the position and the clearance to the true scene."""
    if obstacles not in ("spheres", "esdf"):
        raise ValueError(f"unknown obstacle representation {obstacles!r}")
    dev = resolve_device(device)
    cfg = mapped_loop.MappedFlightConfig()
    params = _with_samples(mapped_solver.MappedMPPIParams(
        altitude_weight=8.0, use_esdf=obstacles == "esdf", esdf_params=cfg.grid),
        n_samples or 1024)
    _, init = mapped_solver.make_mapped_solver(params, device=dev)
    run = mapped_loop.make_mapped_episode(cfg, params, n_steps, device=dev, graph=graph)
    return run, lambda seed: mapped_loop.init_mapped_flight(cfg, init(seed), seed + 1,
                                                            device=dev)


def run_mapped_flight(seed: int = 0, steps: int = 3000, device="cuda",
                      n_samples: Optional[int] = None, obstacles: str = "spheres",
                      save_state: Optional[str] = None, resume: Optional[str] = None,
                      logs: Optional[dict] = None) -> dict:
    """Fly to the waypoint through obstacles the solver does not know a
    priori (``mapped_flight_episode``).  ``resume`` starts from a state
    saved with ``save_state`` (the grid, the plant, the controller, the
    solver and both noise streams: the run continues as the uninterrupted
    one would); ``logs``, if given, receives the logs (``pos``,
    ``clearance``).  Returns the JAX scenario's metrics: the final and least distance
    to the goal, whether it ended within 0.5 m, the least clearance to the
    true scene, whether it touched it, and the occupied voxels of the map."""
    dev = resolve_device(device)
    run, start = mapped_flight_episode(steps, dev, n_samples, obstacles)
    final, (pos, clr) = run(maybe_resume(resume, start(seed), dev))
    maybe_save(save_state, final)
    pos, clr = pos.cpu().numpy(), clr.cpu().numpy()
    if logs is not None:
        logs.update(pos=pos, clearance=clr)
    dist = np.linalg.norm(pos - np.asarray(mapped_loop.MappedFlightConfig().target), axis=-1)
    return {"final_dist_m": round(float(dist[-1]), 3),
            "min_dist_m": round(float(dist.min()), 3),
            "reached": bool(dist[-1] < 0.5),
            "min_clearance_m": round(float(clr.min()), 3),
            "collided": bool(clr.min() <= 0.0),
            "mapped_occupied_voxels": int((final.grid.log_odds > 0.0).sum()),
            "steps": steps}
