"""Inner-loop rotorcraft scenarios: hover, aggressive figure-eight
tracking, wind disturbance, the full mission, file-driven waypoints and
the camera survey.

Port of the JAX package's ``scenarios/rotorcraft.py``: the flight-control,
wind, contact and mission layers with no MPPI solver in the loop.  Each
scenario is a function ``run_*(seed, steps, device="cuda", ...)`` that
returns the JAX scenario's metrics (``run.py`` is their command line), beside
an ``*_episode`` builder, ``(run, start)``:
``run(start(seed))`` is one episode of 1 kHz ticks, on the card one
captured control period of 10 ticks replayed per step
(``scenarios.common.tick_episode``; ``graph=False`` runs it eagerly).
``steps`` counts control steps of 10 ticks, as the JAX scenarios' do; the
defaults are the JAX command line's (1000 steps, the backstepping law).

The disturbance's turbulence draws from the Philox stream of
``ops/sampling`` under the seed's key, once per control step for its 10
ticks, where the JAX scenario folds each tick into a ``jax.random`` key: the two streams differ
(the tests feed the JAX draws to the port through ``run(start(seed), z)``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..bridge.camera import CameraPublisher
from ..evaluation import analyze as analyze_mod
from ..evaluation import metrics as metrics_mod
from ..models import multirotor as mr
from ..models import vehicles
from ..ops import sampling
from ..sim import closed_loop as cl
from ..sim import depth_camera as dc
from ..sim import flight_control as fc
from ..sim import gimbal as gb
from ..sim import lee_controller as lee
from ..sim import scenario as mission_mod
from ..sim import sensors
from ..sim import wind as wind_mod
from ..utils.device import device_const, resolve_device
from ..utils.trajectory import (
    gerono_reference, polynomial_sample, read_waypoint_file, waypoint_splines,
)
from ..sim.geotag import GeotagParams, GeotagRecorder, replay_capture
from .common import TICK_DT, TICKS_PER_STEP, hover_plant, tick_episode

DT = TICK_DT
HOVER_TARGET = (0.0, 0.0, 2.0)
HOVER_START = (0.2, -0.2, 1.8)
EXAMPLE_WAYPOINTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "resources",
                                 "example_waypoints.txt")


def _tilt(plant: mr.MultirotorState) -> torch.Tensor:
    return torch.linalg.norm(cl.rpy_of(plant)[:2])


def hover_episode(n_steps: int, device="cuda", graph: bool = True, vehicle: str = "harrier",
                  controller: str = "backstepping"):
    """Hover at (0, 0, 2) from (0.2, -0.2, 1.8), rotors at hover speed, under
    the Lee (the vehicle's gains), PID (``SIM_TUNED_GAINS``) or backstepping
    law.  ``(run, start)``; the logs are the position and the body rates
    after each tick."""
    dev = resolve_device(device)
    veh = vehicles.get(vehicle)
    target = torch.tensor(HOVER_TARGET, device=dev)
    if controller == "lee":
        gains, sp = vehicles.lee_gains(vehicle), lee.setpoint(target)

        def control(plant, c):
            return lee.lee_control(gains, veh, sp, pos=plant.pos, vel_world=plant.vel,
                                   quat=plant.quat, omega_body=plant.omega), c
    elif controller in ("pid", "backstepping"):
        law = fc.pid_step if controller == "pid" else fc.backstepping_step
        gains = fc.SIM_TUNED_GAINS if controller == "pid" else fc.FlightGains()
        sp = fc.hover_setpoint(target)

        def control(plant, c):
            return law(gains, veh, c, sp, pos=plant.pos, vel_world=plant.vel,
                       rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=DT)
    else:
        raise ValueError(f"unknown controller {controller!r}")

    def tick(carry, i, noise):
        plant, c = carry
        u, c = control(plant, c)
        plant = mr.step(veh, plant, fc.allocate(veh, u), DT)
        return (plant, c), (plant.pos, plant.omega)

    run = tick_episode(tick, lambda c: (c[0].pos, c[0].omega), n_steps * TICKS_PER_STEP, dev,
                       graph)
    return run, lambda seed=0: (hover_plant(veh, HOVER_START, device=dev),
                                fc.init_ctrl_state(veh.mass, device=dev))


def run_hover(seed: int = 0, steps: int = 1000, device="cuda", vehicle: str = "harrier",
              controller: str = "backstepping", save_state: Optional[str] = None,
              resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """The hover gate (the reference's hovering_eval thresholds): position
    RMS and body-rate RMS over the second half, settling time.  ``logs``,
    if given, receives ``pos`` and ``omega`` per tick."""
    run, start = hover_episode(steps, device, vehicle=vehicle, controller=controller)
    _, (pos, omega) = run(start(seed), save_state=save_state, resume=resume)
    if logs is not None:
        logs.update(pos=pos.cpu().numpy(), omega=omega.cpu().numpy())
    m = metrics_mod.hover_metrics(pos, omega, device_const(HOVER_TARGET, pos), dt=DT)
    return {"vehicle": vehicle, "controller": controller,
            "pos_rms_m": round(float(m.pos_rms), 4),
            "ang_rate_rms": round(float(m.ang_rate_rms), 4),
            "settling_time_s": round(float(m.settling_time), 2),
            "passed": bool(m.passed)}


FIG8_AMP, FIG8_Z = 1.5, 2.0


def figure_eight_episode(n_steps: int, device="cuda", graph: bool = True,
                         vehicle: str = "harrier", period: float = 6.0):
    """The adaptive backstepping law with ``AGGRESSIVE_GAINS``, its
    safeguards and full velocity + acceleration feed-forward tracking the
    Gerono figure-eight (amplitude 1.5 m at 2 m, ``period`` s, a smooth
    time-warp entry from rest).  ``(run, start)``; the logs are the
    tracking error and the tilt after each tick."""
    dev = resolve_device(device)
    veh = vehicles.get(vehicle)
    omega = 2.0 * np.pi / period
    gains, safe = fc.AGGRESSIVE_GAINS, fc.aggressive_safeguards(veh)

    def tick(carry, i, noise):
        plant, c = carry
        p_ref, v_ref, a_ref = gerono_reference(i.to(torch.float32) * DT, FIG8_AMP, omega, FIG8_Z)
        zero = torch.zeros((), dtype=p_ref.dtype, device=p_ref.device)
        sp = fc.FlightSetpoint(pos=p_ref, vel=v_ref, yaw=zero, yaw_rate=zero)
        u, c = fc.backstepping_step(gains, veh, c, sp, pos=plant.pos, vel_world=plant.vel,
                                    rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=DT,
                                    acc_ff=a_ref, **safe)
        plant = mr.step(veh, plant, fc.allocate(veh, u), DT)
        return (plant, c), (torch.linalg.norm(plant.pos - p_ref), _tilt(plant))

    run = tick_episode(tick, lambda c: (c[0].pos[0], c[0].pos[0]), n_steps * TICKS_PER_STEP, dev,
                       graph)
    return run, lambda seed=0: (hover_plant(veh, (0.0, 0.0, FIG8_Z), device=dev),
                                fc.init_ctrl_state(veh.mass, device=dev))


def run_figure_eight(seed: int = 0, steps: int = 1000, device="cuda", vehicle: str = "harrier",
                     period: float = 6.0, save_state: Optional[str] = None,
                     resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """The aggressive-maneuver gate: post-transient tracking RMSE < 0.15 m
    (the first lap, or half the run, skipped).  ``logs``, if given,
    receives ``err`` and ``tilt`` per tick."""
    run, start = figure_eight_episode(steps, device, vehicle=vehicle, period=period)
    _, (err, tilt) = run(start(seed), save_state=save_state, resume=resume)
    err, tilt = err.cpu().numpy(), tilt.cpu().numpy()
    if logs is not None:
        logs.update(err=err, tilt=tilt)
    settle = min(int(period / DT), len(err) // 2)
    e_track = err[settle:]
    rms = float(np.sqrt((e_track ** 2).mean()))
    return {"vehicle": vehicle, "period_s": period,
            "peak_speed_ms": round(FIG8_AMP * 2.0 * np.pi / period, 2),
            "track_rms_m": round(rms, 4), "track_max_m": round(float(e_track.max()), 4),
            "max_tilt_rad": round(float(tilt.max()), 3), "passed": bool(rms < 0.15)}


DISTURBANCE_TARGET = (0.0, 0.0, 2.0)
DISTURBANCE_WIND = wind_mod.WindParams(gust_velocity=(5.0, 0.0, 0.0), gust_start=2.0,
                                       gust_duration=1.0, gust_period=1e9,
                                       turbulence_sigma=0.3, turbulence_tau=0.5)


def disturbance_field() -> wind_mod.WindField:
    """The shear field: wind growing with altitude and varying across x."""
    return wind_mod.uniform_grid_field(
        lambda px, py, pz: (0.15 * pz + 0.1 * px, 0.05 * pz, np.zeros_like(px)),
        x=(-10.0, 10.0, 9), y=(-10.0, 10.0, 9), z=(0.0, 12.0, 7))


def disturbance_episode(n_steps: int, device="cuda", graph: bool = True):
    """Backstepping hover of the HarrierD7 in the shear field, a 5 m/s gust
    at t = 2 s and OU turbulence.  ``(run, start)``: the carry holds the
    turbulence's Philox key (the seed); each control step draws its ticks'
    normals at once, under the counter of its first tick.
    ``run(start(seed), z)`` takes the turbulence's standard normals
    (n_ticks, 3) instead.  The logs are the position and the body rates."""
    dev = resolve_device(device)
    veh = mr.MultirotorParams()
    field, gains = disturbance_field(), fc.FlightGains()
    sp = fc.hover_setpoint(torch.tensor(DISTURBANCE_TARGET, device=dev))

    def tick(carry, i, noise):
        plant, c, ws, key = carry
        wvel, ws = wind_mod.wind_velocity_at(DISTURBANCE_WIND, field, ws, i.to(torch.float32) * DT,
                                             plant.pos, DT, noise=noise)
        u, c = fc.backstepping_step(gains, veh, c, sp, pos=plant.pos, vel_world=plant.vel,
                                    rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=DT)
        plant = mr.step(veh, plant, fc.allocate(veh, u), DT, wind_world=wvel)
        return (plant, c, ws, key), (plant.pos, plant.omega)

    def draw(carry, i):
        return sensors.normals(3 * TICKS_PER_STEP, carry[3], i).reshape(TICKS_PER_STEP, 3)

    run = tick_episode(tick, lambda c: (c[0].pos, c[0].omega), n_steps * TICKS_PER_STEP, dev,
                       graph, draw=draw)

    def start(seed=0):
        return (hover_plant(veh, DISTURBANCE_TARGET, device=dev),
                fc.init_ctrl_state(veh.mass, device=dev), wind_mod.init_wind(device=dev),
                sampling.philox_keys(seed, dev).clone())

    return run, start


def run_disturbance(seed: int = 0, steps: int = 1000, device="cuda",
                    save_state: Optional[str] = None, resume: Optional[str] = None,
                    logs: Optional[dict] = None) -> dict:
    """The hover gate under the wind, and the recovery after the peak
    excursion (the reference's disturbance_eval).  ``logs``, if given,
    receives ``pos`` and ``omega`` per tick."""
    run, start = disturbance_episode(steps, device)
    _, (pos, omega) = run(start(seed), save_state=save_state, resume=resume)
    if logs is not None:
        logs.update(pos=pos.cpu().numpy(), omega=omega.cpu().numpy())
    target = device_const(DISTURBANCE_TARGET, pos)
    m = metrics_mod.hover_metrics(pos, omega, target, dt=DT)
    rec = analyze_mod.analyze_disturbance({"pos": pos}, np.asarray(DISTURBANCE_TARGET), DT, 0.1)
    return {"pos_rms_m": round(float(m.pos_rms), 4),
            "ang_rate_rms": round(float(m.ang_rate_rms), 4),
            "passed": bool(m.passed), **rec}


MISSION_CONTACT = mr.GroundContactParams()


def mission_episode(n_steps: int, device="cuda", graph: bool = True,
                    land_after: Optional[int] = None):
    """Takeoff -> cruise (gear retracts) -> land: backstepping on the
    mission machine's setpoints, the rotor commands cut after touchdown,
    the vehicle resting on the penalty ground contact of its gear.  The
    Land command comes at tick ``land_after`` (by default three fifths of
    the ticks).  ``(run, start)``; the carry is (plant, controller,
    mission); the logs are the position, the phase, the tilt, the Land
    command and the payload flag."""
    dev = resolve_device(device)
    veh, cfg, gains = mr.MultirotorParams(), mission_mod.MissionConfig(), fc.FlightGains()
    n_ticks = n_steps * TICKS_PER_STEP
    land_after = n_ticks * 3 // 5 if land_after is None else land_after

    def tick(carry, t, noise):
        plant, ctrl, mission = carry
        mission = mission._replace(land_cmd=mission.land_cmd | (t > land_after))
        mission, sp, motors_on = mission_mod.mission_step(cfg, mission, plant.pos, plant.vel, DT)
        u, ctrl = fc.backstepping_step(gains, veh, ctrl, sp, pos=plant.pos, vel_world=plant.vel,
                                       rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=DT)
        plant = mr.step(veh, plant, fc.allocate(veh, u) * motors_on, DT,
                        contact=MISSION_CONTACT, gear_ext=mission.gear)
        return (plant, ctrl, mission), (plant.pos, mission.phase, _tilt(plant),
                                        mission.land_cmd, mission.payload_attached)

    run = tick_episode(tick, lambda c: (c[0].pos, c[2].phase, c[0].pos[2], c[2].land_cmd,
                                        c[2].payload_attached), n_ticks, dev, graph)

    def start(seed=0):
        # At rest on the extended gear (the feet at -gear_height).
        return (mr.init_state(veh, pos=(0.0, 0.0, MISSION_CONTACT.gear_height), device=dev),
                fc.init_ctrl_state(veh.mass, device=dev), mission_mod.init_mission(device=dev))

    return run, start


def run_mission(seed: int = 0, steps: int = 1000, device="cuda",
                save_state: Optional[str] = None, resume: Optional[str] = None,
                logs: Optional[dict] = None) -> dict:
    """The mission's metrics: the highest and last altitude, the final
    phase, whether it landed, and the contact quality (the rest height in
    the landed phase, the final tilt and vertical speed).  ``save_state``
    checkpoints the final carry; ``resume`` starts from one (the tick index
    restarts, so the Land command comes after three fifths of this run).
    ``logs``, if given, receives ``z``, ``phase`` and ``tilt`` per tick."""
    run, start = mission_episode(steps, device)
    (plant, _, mission), (pos, phase, tilt, _, _) = run(start(seed), save_state=save_state,
                                                        resume=resume)
    z, phase, tilt = pos[:, 2].cpu().numpy(), phase.cpu().numpy(), tilt.cpu().numpy()
    if logs is not None:
        logs.update(z=z, phase=phase, tilt=tilt)
    landed = phase == mission_mod.LANDED
    final_phase = int(mission.phase)
    return {"max_alt_m": round(float(z.max()), 3), "final_alt_m": round(float(z[-1]), 3),
            "final_phase": final_phase, "landed": final_phase == mission_mod.LANDED,
            "rest_height_m": round(float(z[landed].mean()), 3) if landed.any() else None,
            "final_tilt_rad": round(float(tilt[-1]), 4),
            "final_vspeed_m_s": round(float(plant.vel[2]), 4)}


YAW_SLEW = 0.6 * DT   # rad per tick
CARROT_R = 1.0        # m


def waypoint_file_episode(path: Optional[str] = None, device="cuda", graph: bool = True,
                          vehicle: str = "harrier", smooth: bool = False,
                          n_ticks: Optional[int] = None):
    """A RotorS waypoint file (``wait_time x y z yaw_deg``; the package's
    example mission by default) flown with the Lee controller, each
    waypoint commanded for its wait window.  Raw waypoints go through a
    1 m carrot and a 0.6 rad/s yaw slew; ``smooth`` tracks the C2 cubic
    spline through them with velocity, acceleration and yaw feed-forward.
    ``n_ticks`` cuts the flight short (by default it runs to the end of the
    last window).  Returns ``(run, start, schedule)``: ``schedule`` is
    (waits, positions, yaws, the schedule's ticks); the logs are the
    position (and, smooth, the reference) after each tick."""
    dev = resolve_device(device)
    waits, positions, yaws = read_waypoint_file(path or EXAMPLE_WAYPOINTS)
    n_wp = len(waits)
    if n_wp == 0:
        raise ValueError(f"no complete waypoints in {path}")
    veh, gains = vehicles.get(vehicle), vehicles.lee_gains(vehicle)
    ends = np.cumsum(waits) / DT
    total = int(ends[-1])
    n_ticks = total if n_ticks is None else n_ticks
    like = torch.zeros((), device=dev)

    if smooth:
        breaks, coeffs, ycoeffs = (device_const(x, like) for x in waypoint_splines(waits,
                                                                                   positions,
                                                                                   yaws))

        def tick(plant, t, noise):
            ts = t.to(torch.float32) * DT
            p_ref = polynomial_sample(breaks, coeffs, ts)
            v_ref = polynomial_sample(breaks, coeffs, ts, derivative=1)
            a_ref = polynomial_sample(breaks, coeffs, ts, derivative=2)
            yaw_ref = polynomial_sample(breaks, ycoeffs, ts)[0]
            yaw_rate = polynomial_sample(breaks, ycoeffs, ts, derivative=1)[0]
            sp = lee.LeeSetpoint(p_ref, v_ref, a_ref, yaw_ref, yaw_rate)
            u = lee.lee_control(gains, veh, sp, pos=plant.pos, vel_world=plant.vel,
                                quat=plant.quat, omega_body=plant.omega)
            plant = mr.step(veh, plant, fc.allocate(veh, u), DT)
            return plant, (plant.pos, p_ref)

        run = tick_episode(tick, lambda p: (p.pos, p.pos), n_ticks, dev, graph)

        def start(seed=0):
            return hover_plant(veh, tuple(positions[0]), device=dev)
    else:
        ends_t, pos_t, yaw_t = (device_const(x, like) for x in (ends, positions, yaws))
        zero3 = device_const([0.0, 0.0, 0.0], like)

        def tick(carry, t, noise):
            plant, yaw_cmd = carry
            # A (1,) index: indexing with a 0-d tensor reads it on the host.
            idx = torch.searchsorted(ends_t, t.to(torch.float32).reshape(1), right=True)
            idx = idx.clamp(max=n_wp - 1)
            dyaw = wind_mod.fmod_floor(yaw_t[idx][0] - yaw_cmd + np.pi, 2 * np.pi) - np.pi
            yaw_cmd = yaw_cmd + dyaw.clamp(-YAW_SLEW, YAW_SLEW)
            err = pos_t[idx][0] - plant.pos
            d = torch.linalg.norm(err)
            carrot = plant.pos + err * (CARROT_R / d.clamp(min=1e-6)).clamp(max=1.0)
            sp = lee.LeeSetpoint(carrot, zero3, zero3, yaw_cmd, torch.zeros_like(yaw_cmd))
            u = lee.lee_control(gains, veh, sp, pos=plant.pos, vel_world=plant.vel,
                                quat=plant.quat, omega_body=plant.omega)
            plant = mr.step(veh, plant, fc.allocate(veh, u), DT)
            return (plant, yaw_cmd), (plant.pos,)

        run = tick_episode(tick, lambda c: (c[0].pos,), n_ticks, dev, graph)

        def start(seed=0):
            # The slewed yaw starts at the plant's yaw (0), not the first
            # waypoint's.
            return (hover_plant(veh, tuple(positions[0]), device=dev),
                    torch.zeros((), dtype=torch.float32, device=dev))

    return run, start, (waits, positions, yaws, total)


def run_waypoint_file(seed: int = 0, steps: Optional[int] = None, device="cuda",
                      path: Optional[str] = None, smooth: bool = False,
                      vehicle: str = "harrier", save_state: Optional[str] = None,
                      resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """``waypoint_publisher_file`` parity: each waypoint's position error
    at the end of its window against the hover-eval 0.2 m gate; smooth,
    also the tracking error against the spline.  The schedule sets the
    length (``steps`` is accepted for a uniform signature and ignored, as
    the JAX scenario ignores it).  ``logs``, if given, receives ``pos``
    (and, smooth, the reference ``ref``) per tick."""
    run, start, (waits, positions, _, n_ticks) = waypoint_file_episode(path, device, True,
                                                                       vehicle, smooth)
    _, lg = run(start(seed), save_state=save_state, resume=resume)
    pos = lg[0].cpu().numpy()
    if logs is not None:
        logs.update(pos=pos, **({"ref": lg[1].cpu().numpy()} if smooth else {}))
    ends = np.cumsum(waits) / DT
    end_errors = [float(np.linalg.norm(pos[int(min(e, n_ticks)) - 1] - positions[i]))
                  for i, e in enumerate(ends)]
    out = {"file": path or EXAMPLE_WAYPOINTS, "n_waypoints": len(waits)}
    if smooth:
        err = np.linalg.norm(pos - lg[1].cpu().numpy(), axis=-1)
        out.update(smooth=True, track_rms_m=round(float(np.sqrt((err ** 2).mean())), 4),
                   track_max_m=round(float(err.max()), 4))
    out.update(end_window_err_m=[round(e, 4) for e in end_errors],
               max_end_err_m=round(max(end_errors), 4))
    out["passed"] = bool(err.max() < 0.2) if smooth else bool(max(end_errors) < 0.2)
    return out


SURVEY_TARGET = (2.0, 0.0, 0.0)
SURVEY_RADIUS, SURVEY_ALT, SURVEY_PERIOD = 3.0, 3.0, 12.0   # m, m, s per orbit
SURVEY_CAMERA = dc.DepthCameraParams(width=32, height=24, max_depth=30.0)
SURVEY_SPHERES = ((2.0, 0.0, 0.6), (0.5, 1.5, 0.4))
SURVEY_RADII = (0.6, 0.4)


def camera_survey_episode(n_steps: int, device="cuda", graph: bool = True):
    """The multirotor (backstepping) orbits the ground target at 3 m radius
    and 3 m altitude, one lap per 12 s, while the gimbal's world-frame
    servo holds the camera's optical axis on the target.  ``(run,
    start)``; the carry is (plant, controller, gimbal); the logs are the
    position, the attitude, the gimbal angles and the pointing error [rad]
    after each tick."""
    dev = resolve_device(device)
    veh, gains, gparams = mr.MultirotorParams(), fc.FlightGains(), gb.GimbalParams()

    def tick(carry, i, noise):
        plant, ctrl, gim = carry
        target = device_const(SURVEY_TARGET, plant.pos)
        ang = 2.0 * np.pi * i.to(plant.pos.dtype) / (SURVEY_PERIOD * 1000.0)
        zero = torch.zeros((), dtype=plant.pos.dtype, device=plant.pos.device)
        sp = fc.FlightSetpoint(
            pos=torch.stack([target[0] + SURVEY_RADIUS * torch.cos(ang),
                             target[1] + SURVEY_RADIUS * torch.sin(ang), zero + SURVEY_ALT]),
            vel=torch.zeros_like(plant.pos), yaw=zero, yaw_rate=zero)
        u, ctrl = fc.backstepping_step(gains, veh, ctrl, sp, pos=plant.pos, vel_world=plant.vel,
                                       rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=DT)
        plant = mr.step(veh, plant, fc.allocate(veh, u), DT)
        gim = gb.gimbal_step(gparams, gim, gb.point_at(plant.pos, target), plant.quat, DT)
        axis = gb.camera_rotation(gim, plant.quat)[:, 2]
        want = target - plant.pos
        want = want / torch.linalg.norm(want)
        point_err = torch.acos(torch.clamp(torch.dot(axis, want), -1.0, 1.0))
        return (plant, ctrl, gim), (plant.pos, plant.quat, gim.angles, point_err)

    run = tick_episode(tick, lambda c: (c[0].pos, c[0].quat, c[2].angles, c[0].pos[0]),
                       n_steps * TICKS_PER_STEP, dev, graph)

    def start(seed=0):
        pos = (SURVEY_TARGET[0] + SURVEY_RADIUS, 0.0, SURVEY_ALT)
        return (mr.init_state(veh, pos=pos, device=dev), fc.init_ctrl_state(veh.mass, device=dev),
                gb.init_gimbal(device=dev))

    return run, start


def _stream_socket(stream: str):
    """A connection to a live QMM server at ``HOST:PORT``."""
    import socket

    host, sep, port_s = stream.rpartition(":")
    try:
        if not sep:
            raise ValueError
        port = int(port_s)
    except ValueError:
        raise SystemExit(f"--stream expects HOST:PORT (got {stream!r}); "
                         "e.g. --stream 127.0.0.1:9911") from None
    return socket.create_connection((host or "127.0.0.1", port), timeout=5)


def run_camera_survey(seed: int = 0, steps: int = 400, device="cuda", out_dir: Optional[str] = None,
                      stream: Optional[str] = None, save_state: Optional[str] = None,
                      resume: Optional[str] = None, logs: Optional[dict] = None) -> dict:
    """The aerial survey with the whole camera stack: the orbit of
    ``camera_survey_episode``, then the capture pass over its logs
    (``sim/geotag.replay_capture``): every second the gimbal-steered depth
    frame (32 x 24, Kinect noise) of the scene (the ground and two spheres)
    is geotagged with the GPS fix and stored as an npz in ``out_dir``
    (``frames`` by default).  ``stream`` (``HOST:PORT``) also pushes each
    captured frame to a live QMM server as IMAGE frames
    (``bridge/camera.CameraPublisher``).  The capture noise draws under the
    seed's Philox key.  Returns the JAX scenario's metrics; ``logs``, if
    given, receives its log arrays (``pos``, ``gimbal``, ``point_err``) and
    the base attitude ``quat``, which with them gives each tick's camera
    pose."""
    dev = resolve_device(device)
    run, start = camera_survey_episode(steps, dev)
    _, (pos, quat, gangles, perr) = run(start(seed), save_state=save_state, resume=resume)
    rec = GeotagRecorder(params=GeotagParams(interval=1.0), out_dir=out_dir or "frames")
    sock = _stream_socket(stream) if stream else None
    try:
        replay_capture(rec, pos, quat, gangles, cam=SURVEY_CAMERA,
                       seed=sampling.philox_keys(seed, dev), sphere_centers=SURVEY_SPHERES,
                       sphere_radii=SURVEY_RADII,
                       publisher=None if sock is None else CameraPublisher(sock, rate_hz=10.0))
    finally:
        if sock is not None:
            sock.close()
    perr_np, pos_np = perr.cpu().numpy(), pos.cpu().numpy()
    tail = perr_np[perr_np.shape[0] // 2:]
    if logs is not None:
        logs.update(pos=pos_np, gimbal=gangles.cpu().numpy(), point_err=perr_np,
                    quat=quat.cpu().numpy())
    return {"frames_written": len(rec.written),
            "first_frame": rec.written[0] if rec.written else None,
            "point_err_tail_max_deg": round(float(np.rad2deg(tail.max())), 2),
            "point_err_tail_mean_deg": round(float(np.rad2deg(tail.mean())), 2),
            "orbit_alt_final_m": round(float(pos_np[-1, 2]), 3)}
