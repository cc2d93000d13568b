"""The reference's entry points: a whole-body solve and an episode's first
control steps, on the frozen plain pipeline, in any dtype.

Nothing here imports the port.  The preset of a configuration is built
from its file (:func:`make_params`), the same way the harness builds the
port's, and every state the port derived (warm start at solve 0, the
plant's hover rotor speeds, the controller state) is worked out again.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .frozen.models.multirotor import Multirotor12State, MultirotorState
from .frozen.models.whole_body import WholeBodyState
from .frozen.sim import whole_body_loop as wbl
from .frozen.sim.flight_control import FlightCtrlState
from .frozen.solver import serving
from .frozen.solver import whole_body as wbs
from .frozen.solver.mppi import MPPIState, _diag_sigma
from .frozen.utils.pose import Pose

LOG_FIELDS = ("ee_err", "base_pos", "tilt", "l1_cmd", "l1_meas", "ori_err")


PRESETS = ("attitude", "position", "wrench")
OBSTACLE_KEYS = ("weight", "centers", "radii")


def make_params(wbs_module, config: dict, n_samples: Optional[int] = None,
                n_horizon: Optional[int] = None):
    """The configuration's solver preset from ``wbs_module`` (the port's
    ``solver.whole_body`` or the frozen copy), at K and H of the file unless
    overridden (the CPU tests run tiny sizes): ``"attitude"``,
    ``WholeBodyMPPIParams()``; ``"position"``, ``position_mode_params``;
    ``"wrench"``, ``wrench_mode_params``.  An ``"obstacles"`` object
    (``weight``, ``centers`` [[x, y, z], ...], ``radii``) replaces the
    preset's sphere obstacles."""
    k = int(n_samples or config["n_samples"])
    h = int(n_horizon or config["n_horizon"])
    preset = config["preset"]
    if preset == "attitude":
        p = wbs_module.WholeBodyMPPIParams()
        p = dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=k, n_horizon=h))
    elif preset in PRESETS:
        p = getattr(wbs_module, f"{preset}_mode_params")(n_samples=k, n_horizon=h)
    else:
        raise SystemExit(f"unknown preset {preset!r}; one of {', '.join(PRESETS)}")
    obstacles = config.get("obstacles")
    if obstacles is not None:
        if sorted(obstacles) != sorted(OBSTACLE_KEYS):
            raise SystemExit(f"the obstacles object has the keys {sorted(obstacles)}; it needs "
                             f"exactly {', '.join(OBSTACLE_KEYS)}")
        centers = tuple(tuple(float(x) for x in c) for c in obstacles["centers"])
        radii = tuple(float(r) for r in obstacles["radii"])
        if len(centers) != len(radii) or any(len(c) != 3 for c in centers):
            raise SystemExit("obstacles: one [x, y, z] centre per radius")
        p = dataclasses.replace(p, cost=dataclasses.replace(
            p.cost, obstacle_weight=float(obstacles["weight"]), obstacle_centers=centers,
            obstacle_radii=radii))
    return p


def stated(params) -> dict:
    """The numbers of a preset that a configuration file states; its sphere
    obstacles whole (``obstacles``) only where there are any."""
    cfg, cost = params.mppi, params.cost
    out = {"control_mode": params.model.control_mode, "n_action": cfg.n_action,
           "lam": cfg.lam, "dt": cfg.dt, "sigma": [float(x) for x in np.asarray(cfg.sigma)],
           "savgol_window": cfg.savgol_window, "warm_start_decay": cfg.warm_start_decay,
           "n_obstacles": len(cost.obstacle_centers)}
    if len(cost.obstacle_centers):
        out["obstacles"] = {"weight": float(cost.obstacle_weight),
                            "centers": [[float(x) for x in c] for c in cost.obstacle_centers],
                            "radii": [float(r) for r in cost.obstacle_radii]}
    return out


def obs_from_fields(f: dict) -> "wbs.WholeBodyObs":
    """The solver's observation from named field tensors (one vehicle or a
    leading vehicle axis)."""
    base = Multirotor12State(pos=f["pos"], rpy=f["rpy"], vel=f["vel"], omega=f["omega"])
    return wbs.WholeBodyObs(state=WholeBodyState(base=base, q=f["q"], qdot=f["qdot"]),
                            ee_target=Pose(position=f["ee_pos"], quat=f["ee_quat"]),
                            base_target=f["base_target"])


class Reference:
    """The plain whole-body solve and closed loop of one configuration.

    ``dtype`` float64 is the check's reference; float32 with ``tf32`` is the
    control (the reference in the precision below the configuration's
    float32 with TF32 off).  ``n_samples`` overrides K (a stand-in that
    leaves samples out).  ``solver_dtype`` (episodes only; default
    ``dtype``) runs the episode's solves in another dtype than its plant:
    the bfloat16 control, whose plant stays in float32."""

    def __init__(self, config: dict, device, dtype=torch.float64, tf32: bool = False,
                 n_samples: Optional[int] = None, n_horizon: Optional[int] = None,
                 solver_dtype=None):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.solver_dtype = solver_dtype
        self.params = make_params(wbs, config, n_samples, n_horizon)
        self.step, self.init = wbs.make_whole_body_solver(self.params, device=self.device,
                                                          low_k_guard="off")
        self.sigma = _diag_sigma(self.params.mppi, dtype, self.device)

    def tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype).to(self.device)

    def initial_warm_start(self) -> torch.Tensor:
        """The warm start of solve 0 (hover nominal, or zeros in position mode)."""
        return self.init(0, self.dtype).u_prev

    def _solve(self, u_prev, key: int, step: int, obs, z=None):
        state = MPPIState(u_prev=self.tensor(u_prev), sigma=self.sigma, seed=int(key),
                          step=int(step))
        out, new = self.step(state, obs, None if z is None else self.tensor(z))
        return torch.cat([out.action, out.qdes, out.vdes]), new.u_prev

    def solve_packed(self, u_prev, key: int, step: int, packed, z=None):
        """One solve of a packed request (37 floats: obs 27, target 10).
        Returns (reply (25,), the next warm start (H, A)).  ``z`` (K, H, A)
        replaces the Philox draw (the tests share another stream's noise)."""
        x = self.tensor(packed)
        return self._solve(u_prev, key, step, serving.unpack_obs(x[:27], x[27:]), z)

    def solve_fields(self, u_prev, key: int, step: int, fields: dict, z=None):
        """One solve of one vehicle's observation fields (``inputs.FLAT``)."""
        return self._solve(u_prev, key, step,
                           obs_from_fields({k: self.tensor(v) for k, v in fields.items()}), z)

    def start_rows(self, start: dict) -> dict:
        """The state rows (as :meth:`episode` returns them) of the hover
        start at ``start["pos"]``: the plant at rest, the initial warm start."""
        plant = wbl.init_plant(self.params.model.vehicle, pos=np.asarray(start["pos"]),
                               dtype=self.dtype, device=self.device)
        u0 = self.initial_warm_start()
        return _rows(plant, u0.expand(len(start["keys"]), *u0.shape))

    def episode(self, start: dict, loop: dict, n_steps: int, carry: Optional[dict] = None,
                step0: int = 0, z=None) -> tuple:
        """``n_steps`` control steps of the eager closed loop for every vehicle
        of ``start`` (``inputs.episode_start`` rows: targets and Philox keys),
        the plant's physics on the plain substeps.  From the hover start at
        ``start["pos"]`` with the initial warm start, or from ``carry`` (state
        rows: ``base``, ``q``, ``qdot``, ``ctrl``, ``u_prev``, each
        (vehicles, ...)) at solve index ``step0``.  ``z`` (n_steps, vehicles,
        K, H, A) replaces the Philox draws.  Returns (each log field as a host
        array (vehicles, n_steps, ...); the state rows after the last step)."""
        n = len(start["keys"])
        # The plant kernel's physics on the plain substeps it stands for.
        cfg = wbl.WholeBodyLoopConfig(**{k: v for k, v in loop.items() if k != "plant_kernel"})
        run = wbl.make_whole_body_episode(self.params, cfg=cfg, n_control_steps=n_steps,
                                          low_k_guard="off", device=self.device, n_scenarios=n,
                                          solver_dtype=self.solver_dtype)
        sigma = self.sigma
        if carry is None:
            plant = wbl.init_plant(self.params.model.vehicle, pos=np.asarray(start["pos"]),
                                   dtype=self.dtype, device=self.device)
            u0 = self.initial_warm_start()
            u0 = u0.expand(n, *u0.shape).clone()
        else:
            t = self.tensor
            plant = wbl.WholeBodyPlant(
                base=MultirotorState(**{f: t(v) for f, v in carry["base"].items()}),
                q=t(carry["q"]), qdot=t(carry["qdot"]),
                ctrl=FlightCtrlState(**{f: t(v) for f, v in carry["ctrl"].items()}))
            u0 = t(carry["u_prev"])
        if self.solver_dtype is not None:
            u0, sigma = u0.to(self.solver_dtype), sigma.to(self.solver_dtype)
        solver = MPPIState(u_prev=u0, sigma=sigma.expand(n, *sigma.shape).clone(),
                           seed=torch.tensor(start["keys"], dtype=torch.int64, device=self.device),
                           step=int(step0))
        target = Pose(position=self.tensor(start["ee_pos"]), quat=self.tensor(start["ee_quat"]))
        final, logs = run(plant, solver, target, self.tensor(start["base_target"]),
                          z=None if z is None else self.tensor(z))
        logs = {f: getattr(logs, f).double().cpu().numpy() for f in LOG_FIELDS}
        return logs, _rows(final[0], final[1].u_prev)


def _rows(plant, u_prev) -> dict:
    def host(x):
        return x.detach().double().cpu().numpy()

    return {"base": {f: host(getattr(plant.base, f)) for f in plant.base._fields},
            "q": host(plant.q), "qdot": host(plant.qdot),
            "ctrl": {f: host(getattr(plant.ctrl, f)) for f in plant.ctrl._fields},
            "u_prev": host(u_prev)}
