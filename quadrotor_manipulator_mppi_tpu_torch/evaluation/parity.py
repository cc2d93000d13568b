"""Plant-parity tooling: the in-framework plant against the reference
(Gazebo) plant and against an independent float64 model of its physics.

Port of the JAX package's ``evaluation/parity.py``:

1. **Cross-plant trajectory comparison** (:func:`compare_logs`,
   ``python -m ...evaluation.parity compare a.npz b.npz``): two trajectory
   logs recorded under the same solver, one from the in-framework plant
   (``bridge/sim_adapter.py`` against a ``BridgeServer``) and one from the
   original Gazebo sim (``bridge/ros_adapter.py`` against the same server),
   reported as per-axis RMSE, maximum and final deviations.  The QMM server
   is deterministic at a fixed seed, so the differences isolate the plants.
   A ``.bag`` log (the Gazebo side's recording) is converted on the way in
   by ``evaluation/rosbag.bag_to_npz``.

2. **Float64 oracle cross-check** (:func:`oracle_parity_report`): the
   port's float32 plant (``models/multirotor.step``) against an
   independent NumPy float64 integrator of the same reference physics
   (thrust k_f w^2, yaw drag k_m, rotor drag, asymmetric rotor lag —
   ``gazebo_motor_model.cpp:407-484`` — and rigid-body quaternion
   integration) under identical open-loop rotor commands.  On the card it
   is the gate that holds the port's plant against a model written
   independently of both packages.

:func:`compare_logs` and :func:`oracle_step` are the JAX module's NumPy
code, copied.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import Dict

import numpy as np
import torch

from .rosbag import bag_to_npz

# ---------------------------------------------------------------------------
# 1. Log-vs-log comparison
# ---------------------------------------------------------------------------


def compare_logs(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
                 key: str = "pos", dt: float = 0.01) -> dict:
    """RMSE/max/final deviation between two trajectory logs' ``key`` arrays
    (truncated to the common length)."""
    xa, xb = np.asarray(a[key], np.float64), np.asarray(b[key], np.float64)
    n = min(len(xa), len(xb))
    xa, xb = xa[:n], xb[:n]
    d = np.linalg.norm(xa - xb, axis=-1) if xa.ndim > 1 else np.abs(xa - xb)

    def sig(x):  # keep small deviations visible (float32-vs-64 is ~1e-6 m)
        return float(f"{x:.4g}")

    return {
        "key": key,
        "n_steps": int(n),
        "duration_s": round(n * dt, 2),
        "rmse_m": sig(float(np.sqrt(np.mean(d * d)))),
        "max_dev_m": sig(float(d.max())),
        "max_dev_time_s": round(float(d.argmax()) * dt, 2),
        "final_dev_m": sig(float(d[-1])),
    }


# ---------------------------------------------------------------------------
# 2. Independent float64 oracle of the reference plant physics
# ---------------------------------------------------------------------------


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def oracle_step(params, state, rotor_cmd, dt):
    """One float64 step of the reference plant physics, written from the
    cited equations independently of ``models/multirotor.py`` (different
    code path, same math — a genuine cross-check, not a mirror)."""
    pos, quat, vel, omega, w_rot = state
    cmd = np.clip(np.asarray(rotor_cmd, np.float64), 0.0, params.max_rotor_speed)
    tau = np.where(cmd > w_rot, params.time_constant_up, params.time_constant_down)
    alpha = np.exp(-dt / tau)
    w_rot = alpha * w_rot + (1.0 - alpha) * cmd

    r = _quat_to_mat(quat)
    v_body = r.T @ vel
    v_perp = np.array([v_body[0], v_body[1], 0.0])
    w2 = w_rot * w_rot
    thrust = params.motor_constant * w2.sum()
    roll_t = params.motor_constant * params.ylen * float(
        np.dot(np.asarray(params.roll_signs, np.float64), w2))
    pitch_t = params.motor_constant * params.xlen * float(
        np.dot(np.asarray(params.pitch_signs, np.float64), w2))
    yaw_t = params.motor_constant * params.moment_constant * float(
        np.dot(np.asarray(params.yaw_signs, np.float64), w2))
    abs_w = np.abs(w_rot).sum()
    drag = -params.rotor_drag_coefficient * abs_w * v_perp
    rolling = -params.rolling_moment_coefficient * abs_w * v_perp
    force_b = drag + np.array([0.0, 0.0, thrust])
    torque_b = np.array([roll_t, pitch_t, yaw_t]) + rolling

    inertia = np.asarray(params.inertia, np.float64)
    acc = r @ force_b / params.mass - np.array([0.0, 0.0, 9.81])
    omega_dot = (torque_b - np.cross(omega, inertia * omega)) / inertia
    vel = vel + acc * dt
    pos = pos + vel * dt
    omega = omega + omega_dot * dt
    th = np.linalg.norm(omega) * dt
    axis = omega / (np.linalg.norm(omega) + 1e-30)
    dq = np.concatenate([[np.cos(th / 2)], axis * np.sin(th / 2)])
    quat = _quat_mul(quat, dq)
    quat = quat / np.linalg.norm(quat)
    return pos, quat, vel, omega, w_rot


def _near_hover_positions(veh, cmds: np.ndarray, dt: float, dev: torch.device) -> np.ndarray:
    """The port's plant flown open loop from a hover at (0, 0, 2) under the
    float32 rotor commands ``cmds`` (n_steps, R): one tick per command, on
    the card ten ticks per replay of a captured step
    (``scenarios.common.tick_episode``, the commands riding as the ticks'
    explicit input), on the CPU the same ticks eagerly.  The positions
    come back once, (n_steps, 3) float64."""
    from ..models import multirotor as mr
    from ..scenarios.common import hover_plant, tick_episode

    def tick(plant, i, cmd):
        plant = mr.step(veh, plant, cmd, dt)
        return plant, (plant.pos,)

    run = tick_episode(tick, lambda plant: (plant.pos,), len(cmds), dev, label="parity.ticks")
    _, (pos,) = run(hover_plant(veh, (0.0, 0.0, 2.0), device=dev),
                    z=torch.tensor(cmds, dtype=torch.float32, device=dev))
    return pos.cpu().numpy().astype(np.float64)


def oracle_parity_report(n_steps: int = 2000, dt: float = 0.001, seed: int = 0,
                         n_ensemble: int = 256, device="cuda") -> dict:
    """Cross-check the port's plant on ``device`` against the float64
    oracle.

    Two comparisons (a rigid body driven open-loop is CHAOTIC — long
    aggressive trajectories diverge exponentially from float32 rounding
    alone, so raw trajectory RMSE only measures the Lyapunov exponent):

    * **single-step ensemble** — from ``n_ensemble`` random states
      (attitude, rates, velocities, rotor speeds) and random commands,
      advance ONE physics step in both implementations (the port's as one
      batched call) and report the worst next-state deviation.  This is
      the model-equivalence check proper; any physics discrepancy shows
      here without chaos amplification.
    * **near-hover trajectory** — a mild (+-2%) profile over ``n_steps``
      integrated end-to-end; deviation stays at float32-integration scale.

    The inputs are drawn from ``seed`` with NumPy in the JAX report's
    order, so both packages' reports see the same states and commands."""
    from ..models import multirotor as mr
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    veh = mr.MultirotorParams()
    rng = np.random.default_rng(seed)
    hover = veh.hover_rotor_speed()

    # --- single-step ensemble ------------------------------------------------
    axis = rng.standard_normal((n_ensemble, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-0.6, 0.6, (n_ensemble, 1))
    quats = np.concatenate(
        [np.cos(ang / 2), axis * np.sin(ang / 2)], axis=-1
    )
    states = dict(
        pos=rng.uniform(-5, 5, (n_ensemble, 3)) + np.array([0, 0, 10.0]),
        quat=quats,
        vel=rng.uniform(-3, 3, (n_ensemble, 3)),
        omega=rng.uniform(-2, 2, (n_ensemble, 3)),
        rotor=rng.uniform(0.2, 1.3, (n_ensemble, veh.n_rotors)) * hover,
    )
    cmds1 = rng.uniform(0.0, 1.2, (n_ensemble, veh.n_rotors)) * hover

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    s_batch = mr.MultirotorState(pos=f32(states["pos"]), quat=f32(states["quat"]),
                                 vel=f32(states["vel"]), omega=f32(states["omega"]),
                                 rotor_speed=f32(states["rotor"]))
    nxt = mr.step(veh, s_batch, f32(cmds1), dt)
    got = {k: getattr(nxt, k).cpu().numpy().astype(np.float64)
           for k in ("pos", "vel", "omega", "quat")}
    step_dev = dict(pos=0.0, vel=0.0, omega=0.0, quat=0.0)
    for i in range(n_ensemble):
        st = (states["pos"][i], states["quat"][i], states["vel"][i],
              states["omega"][i], states["rotor"][i].astype(np.float64))
        p, q, v, w, _ = oracle_step(veh, st, cmds1[i], dt)
        step_dev["pos"] = max(step_dev["pos"], float(np.abs(got["pos"][i] - p).max()))
        step_dev["vel"] = max(step_dev["vel"], float(np.abs(got["vel"][i] - v).max()))
        step_dev["omega"] = max(step_dev["omega"], float(np.abs(got["omega"][i] - w).max()))
        qt = got["quat"][i]
        step_dev["quat"] = max(
            step_dev["quat"], float(min(np.abs(qt - q).max(), np.abs(qt + q).max()))
        )

    # --- near-hover trajectory ------------------------------------------------
    cmds = hover * (
        1.0 + 0.02 * rng.standard_normal((n_steps, veh.n_rotors))
    ).astype(np.float64)
    pos_port = _near_hover_positions(veh, cmds.astype(np.float32), dt, dev)

    state = (
        np.array([0.0, 0.0, 2.0]), np.array([1.0, 0.0, 0.0, 0.0]),
        np.zeros(3), np.zeros(3), np.full(veh.n_rotors, hover, np.float64),
    )
    pos_oracle = np.empty((n_steps, 3))
    for i in range(n_steps):
        state = oracle_step(veh, state, cmds[i], dt)
        pos_oracle[i] = state[0]

    report = compare_logs({"pos": pos_port}, {"pos": pos_oracle}, dt=dt)
    report["kind"] = "torch_plant_vs_float64_oracle"
    report["device"] = str(dev)
    report["single_step_max_dev"] = {
        k: float(f"{v:.3g}") for k, v in step_dev.items()
    }
    report["n_ensemble"] = n_ensemble
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    cmp_p = sub.add_parser("compare", help="compare two trajectory logs (.npz, or .bag)")
    cmp_p.add_argument("log_a")
    cmp_p.add_argument("log_b")
    cmp_p.add_argument("--key", default="pos")
    cmp_p.add_argument("--dt", type=float, default=0.01)
    orc = sub.add_parser("oracle", help="the port's plant vs the float64 oracle")
    orc.add_argument("--steps", type=int, default=2000)
    orc.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.mode == "compare":

        def load(path):
            # Reference-side recordings arrive as rosbags: convert them.
            if path.endswith(".bag"):
                with tempfile.NamedTemporaryFile(suffix=".npz") as tmp:
                    bag_to_npz(path, tmp.name)
                    return dict(np.load(tmp.name))
            return dict(np.load(path))

        out = compare_logs(load(args.log_a), load(args.log_b), key=args.key, dt=args.dt)
    else:
        out = oracle_parity_report(n_steps=args.steps, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
