"""Trajectory / control dataset collection.

Port of the JAX package's ``evaluation/dataset.py``.  A typed recorder
accumulates named per-step arrays from any control loop (the closed-loop
sim, the bridge server, hardware logs) and round-trips them through one
``.npz`` file with JSON metadata, in the JAX package's format: a file
written by either package loads with the other's :func:`load_dataset`.
:func:`collect_solver_dataset` rolls a solver against an observation stream
to produce (observation, plan) pairs for offline or imitation learning, and
:func:`collect_whole_body` does so for the flagship whole-body solve.

The recorder holds NumPy arrays: collection happens at the host boundary,
where the card's results have been read back.  On the card each collected
whole-body solve is one replay of a captured solve (``utils/graphs``): one
copy of the observation in, one readback of the plan out.

    rec = collect_whole_body(n_solves=20, seed=0)      # on the card
    rec.save("wb.npz")
    arrays, meta = load_dataset("wb.npz")
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.multirotor import Multirotor12State
from ..models.whole_body import WholeBodyState
from ..solver import mppi
from ..solver import whole_body as wb
from ..utils import graphs
from ..utils.device import resolve_device

_META_KEY = "__qmm_metadata__"

# The observation row of the whole-body collector: the fields of the base
# state, then the arm's, as (column, width).
WB_OBS_COLUMNS = (("base_pos", 3), ("base_rpy", 3), ("base_vel", 3), ("base_omega", 3),
                  ("q", 7), ("qdot", 7))


@dataclass
class TrajectoryRecorder:
    """Accumulate named per-step records; every field must be recorded at
    every step (enforced) so the saved arrays stay aligned."""

    metadata: Dict = field(default_factory=dict)
    _rows: Dict[str, list] = field(default_factory=dict)
    _n: int = 0

    def record(self, **named_values) -> None:
        if self._n == 0 and not self._rows:
            self._rows = {k: [] for k in named_values}
        if set(named_values) != set(self._rows):
            raise ValueError(
                f"record fields {sorted(named_values)} != {sorted(self._rows)}"
            )
        for k, v in named_values.items():
            self._rows[k].append(np.asarray(v))
        self._n += 1

    def __len__(self) -> int:
        return self._n

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.stack(v) for k, v in self._rows.items()}

    def save(self, path: str) -> None:
        arrs = self.arrays()
        meta = dict(self.metadata)
        meta["n_steps"] = self._n
        arrs[_META_KEY] = np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
        )
        np.savez_compressed(path, **arrs)


def load_dataset(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Inverse of :meth:`TrajectoryRecorder.save` -> (arrays, metadata)."""
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files if k != _META_KEY}
        meta = {}
        if _META_KEY in z.files:
            meta = json.loads(bytes(z[_META_KEY].tobytes()).decode())
    return arrs, meta


def collect_solver_dataset(
    step: Callable,
    state,
    obs_stream,
    extract_obs: Callable[[object], Dict[str, np.ndarray]],
    extract_out: Callable[[object], Dict[str, np.ndarray]],
    metadata: Optional[Dict] = None,
) -> TrajectoryRecorder:
    """Roll ``step(state, obs) -> (out, state)`` over ``obs_stream`` and
    record ``extract_obs(obs) | extract_out(out)`` per solve: the
    (observation, plan) pairs an imitation / offline-RL pipeline trains on.
    Tensors are read back to the host."""
    def host(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    rec = TrajectoryRecorder(metadata=dict(metadata or {}))
    for obs in obs_stream:
        out, state = step(state, obs)
        row = dict(extract_obs(obs))
        row.update(extract_out(out))
        rec.record(**{k: host(v) for k, v in row.items()})
    return rec


def whole_body_obs_rows(n_solves: int, seed: int) -> np.ndarray:
    """The collector's observations: the hover task's state perturbed per
    solve (base position by 0.2 N(0, 1) m, arm q by 0.02 N(0, 1) rad, base
    velocity by 0.02 N(0, 1) m/s, the JAX collector's scales), drawn from
    ``np.random.default_rng(seed)``; float32 rows (n_solves, 26) in the
    order of :data:`WB_OBS_COLUMNS`."""
    base = wb.default_obs(device="cpu")
    st = base.state
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_solves):
        dp, dq, dv = (np.float32(0.2) * rng.standard_normal(n).astype(np.float32)
                      for n in (3, 7, 3))
        rows.append(np.concatenate([
            st.base.pos.numpy() + dp, st.base.rpy.numpy(),
            st.base.vel.numpy() + np.float32(0.1) * dv, st.base.omega.numpy(),
            st.q.numpy() + np.float32(0.1) * dq, st.qdot.numpy()]))
    return np.stack(rows).astype(np.float32)


def whole_body_obs(row: torch.Tensor, task):
    """The whole-body observation of a collector row (26 floats, on the
    device of ``task``'s tensors) with ``task``'s EE and base targets."""
    return wb.WholeBodyObs(
        state=WholeBodyState(base=Multirotor12State(row[0:3], row[3:6], row[6:9], row[9:12]),
                             q=row[12:19], qdot=row[19:26]),
        ee_target=task.ee_target, base_target=task.base_target)


def make_whole_body_collector(params=None, low_k_guard: str = "warn", device="cuda",
                              graph: bool = True, backend: str = "cuda"):
    """The whole-body collector's solve: ``(step, init)`` with
    ``step(state, obs_row) -> (out_row, state)``, ``obs_row`` a host float32
    row of :func:`whole_body_obs_rows` and ``out_row`` the host float32 row
    [u_seq (H * 11), action (11), qdes (7), vdes (7)] (:func:`split_out_row`);
    ``init(seed)`` the solver state, its Philox key and solve index on the
    device.  The task's targets (the EE reach target, the base hover point)
    stay on the device.

    On the card (``graph=True``) each call copies the row into a captured
    solve's static buffer, replays it (the state advances in place, so the
    returned state is the graph's own) and reads the plan back: one copy
    in, one readback.  ``graph=False`` and the CPU run the same solve
    eagerly, bit for bit the same.

    ``backend="cuda"`` (the default) solves on the hand-written kernels;
    ``backend="torch"`` on the plain pipeline, the counterpart of the JAX
    collector's XLA solve (the JAX ``"pallas"`` is ``"cuda"`` here), for
    configurations the kernels refuse; either is captured on the card."""
    params = params or wb.WholeBodyMPPIParams()
    dev = resolve_device(device)
    solver, init = wb.make_whole_body_solver(params, device=dev, backend=backend,
                                             low_k_guard=low_k_guard)
    task = wb.default_obs(device=dev)

    def solve(state, row):
        out, new = solver(state, whole_body_obs(row, task))
        graphs.copy_into(state, new)
        return torch.cat([out.u_seq.reshape(-1), out.action, out.qdes, out.vdes])

    load = graphs.graphed(solve, dev) if graph and dev.type == "cuda" else None

    def step(state, obs_row):
        row = torch.as_tensor(np.asarray(obs_row, np.float32))
        if load is not None:
            g = load(state, row)
            out, state = g.replay(), g.args[0]
        else:
            out = solve(state, row.to(dev))
        return out.cpu().numpy(), state

    def init_state(seed: int):
        # A private copy: the solve advances it in place (the initial sigma
        # may share memory with the parameters' array).
        return graphs.clone_tree(mppi.device_counters(init(seed), dev))

    return step, init_state


def split_out_row(out_row: np.ndarray, n_horizon: int) -> Dict[str, np.ndarray]:
    """The collector's out row -> {u_seq (H, 11), action, qdes, vdes}."""
    n = n_horizon * 11
    return {"u_seq": out_row[:n].reshape(n_horizon, 11), "action": out_row[n:n + 11],
            "qdes": out_row[n + 11:n + 18], "vdes": out_row[n + 18:n + 25]}


def collect_whole_body(
    n_solves: int = 20,
    seed: int = 0,
    params=None,
    low_k_guard: str = "warn",
    device="cuda",
    graph: bool = True,
    backend: str = "cuda",
) -> TrajectoryRecorder:
    """Ready-made collector for the flagship solver (K=4096, H=50, attitude
    mode at the defaults; on the card rows 1 and 3 run once per solve):
    perturbed hover states -> whole-body plans.  Columns: base state (12),
    arm q/qdot (7+7), ee_target (3), u_seq (H, 11), action (11), qdes/vdes
    (7+7).  The perturbations come from ``np.random.default_rng(seed)``
    (:func:`whole_body_obs_rows`), the solver's Philox key from
    ``seed + 1``.  ``backend``: as :func:`make_whole_body_collector`
    (``"torch"`` for a configuration the kernels refuse)."""
    params = params or wb.WholeBodyMPPIParams()
    h = params.mppi.n_horizon
    step, init = make_whole_body_collector(params, low_k_guard, device, graph, backend)
    ee_target = wb.default_obs(device="cpu").ee_target.position.numpy()
    widths = np.cumsum([0] + [w for _, w in WB_OBS_COLUMNS])

    def extract_obs(row):
        cols = {name: row[widths[i]:widths[i + 1]] for i, (name, _) in enumerate(WB_OBS_COLUMNS)}
        return {**cols, "ee_target": ee_target}

    return collect_solver_dataset(
        step, init(seed + 1), whole_body_obs_rows(n_solves, seed),
        extract_obs=extract_obs, extract_out=lambda out: split_out_row(out, h),
        metadata={"task": "whole_body_reach", "n_samples": params.mppi.n_samples,
                  "n_horizon": h, "seed": seed},
    )
