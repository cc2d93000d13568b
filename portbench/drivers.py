"""The system under test behind one interface per traffic driver.

A traffic mix names its ``driver``: ``packed`` (one vehicle's packed
serving solve, ``solver.serving.make_packed_step``), ``batched`` (B
vehicles' observations in one solve, ``solver.whole_body.
make_whole_body_solver(n_scenarios=B)`` replayed through
``utils.graphs.graphed``) or ``episode`` (the closed loop,
``sim.whole_body_loop.make_whole_body_episode``, graphed).  Each adapter
offers ``init``/``call``/``snapshot`` (requests) or ``start``/``call``
(episodes); the harness times the calls and never looks inside.

:func:`port_adapter` builds the port's.  :func:`stand_in_adapter` puts the
plain reference in the program's place, in a lower precision (the control)
or with a planted fault; no run of the benchmark uses it unless asked with
``--stand-in``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import inputs
from .reference import solve as ref_solve

FAULTS = ("unchanged_state", "half_samples", "altered_answer")
ALTERED_M = 0.1  # the altered answer of an episode: one logged base position moved by 10 cm


def check_preset(params, config: dict, who: str) -> None:
    """Refuse a preset that differs from what the configuration file states."""
    stated = ref_solve.stated(params)
    keys = sorted(set(stated) | ({"obstacles"} & set(config)))
    got, want = {k: stated.get(k) for k in keys}, {k: config.get(k) for k in keys}
    if got != want:
        raise SystemExit(f"{who}'s preset differs from the configuration file: {got} != {want}")


# ---------------------------------------------------------------- the port


class PortPacked:
    """One vehicle, one packed solve per request (a graph replay on the card)."""

    def __init__(self, config, dev, k=None, h=None):
        from quadrotor_manipulator_mppi_tpu_torch.solver import serving
        from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs

        params = ref_solve.make_params(wbs, config, k, h)
        check_preset(params, config, "the port")
        self.pstep, self.pinit = serving.make_packed_step(params, device=dev, low_k_guard="off")

    def init(self, keys):
        return self.pinit(keys[0])

    def call(self, carry, x):
        reply, carry = self.pstep(carry, x[0, :27], x[0, 27:])
        return reply[None], carry

    @staticmethod
    def snapshot(carry):
        return carry.u_prev.clone()[None], carry.step.clone()


class PortBatched:
    """B vehicles' observations in one batched solve (a graph replay on the
    card, as ``make_packed_step`` replays one vehicle's)."""

    def __init__(self, config, dev, k=None, h=None, n=1):
        from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import Multirotor12State
        from quadrotor_manipulator_mppi_tpu_torch.models.whole_body import WholeBodyState
        from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs
        from quadrotor_manipulator_mppi_tpu_torch.utils import graphs
        from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

        params = ref_solve.make_params(wbs, config, k, h)
        check_preset(params, config, "the port")
        self.dev = torch.device(dev)

        def obs(f):
            base = Multirotor12State(pos=f["pos"], rpy=f["rpy"], vel=f["vel"], omega=f["omega"])
            return wbs.WholeBodyObs(state=WholeBodyState(base=base, q=f["q"], qdot=f["qdot"]),
                                    ee_target=Pose(position=f["ee_pos"], quat=f["ee_quat"]),
                                    base_target=f["base_target"])

        self.obs = obs
        self.step, self.init_fn = wbs.make_whole_body_solver(params, device=dev, n_scenarios=n,
                                                             low_k_guard="off")

        def fn(state, obs):
            out, new = self.step(state, obs)
            graphs.copy_into(state, new)
            return torch.cat([out.action, out.qdes, out.vdes], dim=-1)

        self.load = graphs.graphed(fn, self.dev) if self.dev.type == "cuda" else None

    def init(self, keys):
        state = self.init_fn(keys)
        return state._replace(step=torch.zeros(1, dtype=torch.int64, device=self.dev))

    def call(self, state, x):
        obs = self.obs(inputs.split_flat(x))
        if self.load is None:
            out, new = self.step(state, obs)
            return torch.cat([out.action, out.qdes, out.vdes], dim=-1), new
        g = self.load(state, obs)
        return g.replay().clone(), g.args[0]

    @staticmethod
    def snapshot(state):
        return state.u_prev.clone(), state.step.clone()


class PortEpisode:
    """The closed loop: one call runs ``n_steps`` control steps from a start
    (:meth:`start`) or from the carry the previous call returned."""

    def __init__(self, config, dev, k=None, h=None, n=1, n_steps=1, loop=None):
        from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
        from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wbs
        from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

        params = ref_solve.make_params(wbs, config, k, h)
        check_preset(params, config, "the port")
        self.dev, self.n, self.wbl, self.Pose = torch.device(dev), n, wbl, Pose
        self.vehicle = params.model.vehicle
        lead = None if n == 1 else n
        self.lead = lead
        self.run = wbl.make_whole_body_episode(
            params, cfg=wbl.WholeBodyLoopConfig(**(loop or {})), n_control_steps=n_steps,
            low_k_guard="off", device=self.dev, n_scenarios=lead)
        _, self.init_fn = wbs.make_whole_body_solver(params, device=self.dev, low_k_guard="off",
                                                     n_scenarios=lead)

    def start(self, st: dict):
        def t(x):
            x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(self.dev)
            return x if self.lead else x[0]

        pos = np.asarray(st["pos"]) if self.lead else np.asarray(st["pos"][0])
        plant = self.wbl.init_plant(self.vehicle, pos=pos, device=self.dev)
        solver = self.init_fn(st["keys"] if self.lead else st["keys"][0])
        target = self.Pose(position=t(st["ee_pos"]), quat=t(st["ee_quat"]))
        return plant, solver, target, t(st["base_target"])

    def call(self, args) -> tuple:
        """(the carry for the next call, each log field as a host array
        (vehicles, n_steps, ...))."""
        carry, logs = self.run(*args)
        out = {}
        for f in ref_solve.LOG_FIELDS:
            x = getattr(logs, f).double().cpu().numpy()
            out[f] = x if self.lead else x[None]
        return carry, out

    def rows(self, carry, idx) -> dict:
        """The program's state in ``carry`` for the vehicles ``idx``, as host
        arrays (vehicles, ...): the plant (``base``, ``q``, ``qdot``, the
        position controller's ``ctrl``) and the solver's warm start."""
        plant, solver = carry[0], carry[1]

        def pick(x):
            x = x.detach().double().cpu().numpy()
            return x[np.asarray(idx)] if self.lead else x[None]

        return {"base": {f: pick(getattr(plant.base, f)) for f in plant.base._fields},
                "q": pick(plant.q), "qdot": pick(plant.qdot),
                "ctrl": {f: pick(getattr(plant.ctrl, f)) for f in plant.ctrl._fields},
                "u_prev": pick(solver.u_prev)}


def port_adapter(driver: str, config: dict, dev, shape: dict, n_steps: Optional[int] = None):
    k, h, n = shape["K"], shape["H"], shape["B"]
    if driver == "packed":
        return PortPacked(config, dev, k, h)
    if driver == "batched":
        return PortBatched(config, dev, k, h, n)
    if driver == "episode":
        return PortEpisode(config, dev, k, h, n, n_steps, shape["loop"])
    raise SystemExit(f"unknown driver {driver!r}")


# ------------------------------------------------- the reference in its place


class StandIn:
    """The plain reference in the program's place, for the controls and the
    planted faults: ``precision`` ``"tf32"`` (the control: float32 with TF32
    on), ``"bf16"`` (the step below it, bfloat16) or ``"float32"`` with one
    of :data:`FAULTS` planted.  An episode's ``"bf16"`` runs the solves in
    bfloat16 and the plant (physics, servo, arm torque) in float32, cast at
    the solver's boundary: the per-substep plant's Cholesky factor and
    triangular solves have no bfloat16 kernel."""

    SOLVER_ONLY = False  # "bf16" lowers the solver alone, not the plant

    def __init__(self, config, dev, shape, precision="tf32", fault=None):
        if fault is not None and fault not in FAULTS:
            raise SystemExit(f"unknown fault {fault!r}; one of {FAULTS}")
        k = shape["K"] // 2 if fault == "half_samples" else shape["K"]
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        solver_dtype = None
        if self.SOLVER_ONLY and dtype == torch.bfloat16:
            dtype, solver_dtype = torch.float32, torch.bfloat16
        self.ref = ref_solve.Reference(config, dev, dtype=dtype, tf32=precision == "tf32",
                                       n_samples=k, n_horizon=shape["H"],
                                       solver_dtype=solver_dtype)
        self.fault, self.shape = fault, shape


class RequestStandIn(StandIn):
    """Requests (``packed`` and ``batched``): one reference solve per vehicle."""

    def __init__(self, driver, *args):
        super().__init__(*args)
        self.driver = driver

    def init(self, keys):
        u0 = self.ref.initial_warm_start()
        return [u0.expand(len(keys), *u0.shape).clone(), list(keys), 0]

    def call(self, carry, x):
        u, keys, step = carry
        x = x.double().cpu().numpy()
        replies, nxt = [], []
        for b in range(len(keys)):
            if self.driver == "packed":
                r, w = self.ref.solve_packed(u[b], keys[b], step, x[b])
            else:
                r, w = self.ref.solve_fields(u[b], keys[b], step, inputs.split_flat(x[b]))
            replies.append(r)
            nxt.append(w)
        reply = torch.stack(replies).float()
        if self.fault == "altered_answer":
            reply[0, 0] += self.ref.sigma[0]
        if self.fault == "unchanged_state":
            return reply, carry
        return reply, [torch.stack(nxt), keys, step + 1]

    @staticmethod
    def snapshot(carry):
        return carry[0].clone(), torch.tensor([carry[2]])


class EpisodeStandIn(StandIn):
    """Episodes: the reference's eager loop for every vehicle, from a start
    or from the state the previous call left.  A call runs only the control
    steps the check reads (the first ``check_steps``), since no other row
    is compared and the eager loop at the cell's size takes seconds a step:
    its state after them stands for the state after the call's
    ``n_steps``, and the solve index advances by ``n_steps``, as the
    program's does."""

    SOLVER_ONLY = True

    def __init__(self, check_steps, n_steps, *args):
        super().__init__(*args)
        self.check_steps, self.n_steps = check_steps, n_steps

    @staticmethod
    def start(st: dict):
        return {"start": st, "carry": None, "step0": 0}

    def call(self, args: dict) -> tuple:
        st, step0 = args["start"], args["step0"]
        logs, carry = self.ref.episode(st, self.shape["loop"], self.check_steps, args["carry"],
                                       step0)
        if self.fault == "unchanged_state":
            carry = args["carry"] or self.ref.start_rows(st)
            for f in logs:
                logs[f] = np.repeat(logs[f][:, :1], logs[f].shape[1], axis=1)
            logs["base_pos"] = np.repeat(np.asarray(carry["base"]["pos"])[:, None],
                                         logs["base_pos"].shape[1], axis=1)
        if self.fault == "altered_answer":
            logs["base_pos"][0, -1, 2] += ALTERED_M
        return {"start": st, "carry": carry, "step0": step0 + self.n_steps}, logs

    @staticmethod
    def rows(carry, idx) -> dict:
        def pick(x):
            return {k: pick(v) for k, v in x.items()} if isinstance(x, dict) else \
                np.asarray(x)[np.asarray(idx)]

        return pick(carry["carry"])


def stand_in_adapter(spec: str, driver: str, config: dict, dev, shape: dict, check_steps: int,
                     n_steps: int = 1):
    """``spec``: ``control`` (TF32), ``control-bf16`` or ``fault:<name>``."""
    controls = {"control": "tf32", "control-bf16": "bf16"}
    if spec in controls:
        args = (config, dev, shape, controls[spec], None)
    elif spec.startswith("fault:"):
        args = (config, dev, shape, "float32", spec.split(":", 1)[1])
    else:
        raise SystemExit(f"unknown stand-in {spec!r}: one of {sorted(controls)} or "
                         "'fault:<name>'")
    if driver == "episode":
        return EpisodeStandIn(check_steps, n_steps, *args)
    return RequestStandIn(driver, *args)
