"""Traffic generation: every input a run hands the system, made from the seed.

One general generator reads a mix's parameters (``traffic/<mix>.json``) and
the configuration's task (``configs/<config>.json``).  Inputs are a pure
function of (seed, request or episode index), so the same seed gives the
same inputs whatever rate the system reaches, and every seed gives the same
amount of work (the shapes are fixed; only the values differ).

* :class:`VehicleStream`: observations of ``vehicles`` independent
  vehicles, one row per request at ``request_period_s``.  Base pose and
  velocities drift smoothly (three seeded sinusoids per channel) around the
  station-keeping target, arm q and qdot near the home pose, and the EE
  target switches every ``target_switch_every`` requests to a new seeded
  point within ``target_box_m`` of the default target (the base station
  moves with it).
* :func:`episode_start`: a closed-loop episode's start (each base within
  ``base_box_m`` of the hover point, each EE target within
  ``target_box_m`` of the default, its base station moved by the same
  offset) and one 63-bit Philox key per vehicle.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# Channel layout of a drifting observation: (name, width, drift key).
OBS_FIELDS = (("pos", 3, "pos_m"), ("rpy", 3, "rpy_rad"), ("vel", 3, "vel_mps"),
              ("omega", 3, "omega_radps"), ("q", 7, "q_rad"), ("qdot", 7, "qdot_radps"))
N_DRIFT = sum(w for _, w, _ in OBS_FIELDS)  # 26
N_SINES = 3
BLOCK = 256  # requests generated together
_STREAM, _TARGET, _EPISODE = 0x5E12, 0x7A46, 0xE915


def _rng(*words: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(w) for w in words]))


def quat_from_rpy(rpy: np.ndarray) -> np.ndarray:
    """wxyz quaternion of R = Rz(yaw) Ry(pitch) Rx(roll), rows (..., 3)."""
    r, p, y = (rpy[..., i] * 0.5 for i in range(3))
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], axis=-1)


class VehicleStream:
    """The observations of ``mix["vehicles"]`` vehicles, request by request."""

    def __init__(self, seed: int, task: dict, mix: dict):
        self.seed, self.task, self.mix = int(seed), task, mix
        self.n = int(mix["vehicles"])
        drift = mix["drift"]
        rng = _rng(self.seed, _STREAM)
        lo, hi = drift["freq_hz"]
        self.freq = rng.uniform(lo, hi, (self.n, N_DRIFT, N_SINES))
        self.phase = rng.uniform(0.0, 2.0 * np.pi, (self.n, N_DRIFT, N_SINES))
        amp = np.concatenate([np.full(w, drift[key]) for _, w, key in OBS_FIELDS])
        self.amp = np.broadcast_to(amp[None, :, None] / N_SINES, self.freq.shape)
        self.centre = np.concatenate([np.zeros(12), np.asarray(task["q_home"]), np.zeros(7)])
        self._blocks: Dict[int, dict] = {}

    def _target_offset(self, block: int) -> np.ndarray:
        box = self.mix["target_box_m"]
        return _rng(self.seed, _TARGET, block).uniform(-box, box, (self.n, 3))

    def _block(self, b: int) -> dict:
        if b not in self._blocks:
            if len(self._blocks) > 4:
                self._blocks.pop(min(self._blocks))
            idx = np.arange(b * BLOCK, (b + 1) * BLOCK)
            t = idx * self.mix["request_period_s"]
            x = self.centre + np.sum(self.amp * np.sin(
                2.0 * np.pi * self.freq * t[:, None, None, None] + self.phase), axis=-1)
            switch = self.mix["target_switch_every"]
            offs = {s: self._target_offset(s) for s in np.unique(idx // switch)}
            off = np.stack([offs[s] for s in idx // switch])            # (BLOCK, n, 3)
            base_target = np.asarray(self.task["hover_pos"]) + off
            fields, i = {}, 0
            for name, w, _ in OBS_FIELDS:
                fields[name] = x[..., i:i + w]
                i += w
            fields["pos"] = fields["pos"] + base_target
            fields["ee_pos"] = np.asarray(self.task["ee_target_pos"]) + off
            quat = np.asarray(self.task["ee_target_quat_wxyz"], dtype=np.float64)
            fields["ee_quat"] = np.broadcast_to(quat, off.shape[:-1] + (4,))
            fields["base_target"] = base_target
            fields["packed"] = np.concatenate(
                [fields["pos"], quat_from_rpy(fields["rpy"]), fields["q"], fields["vel"],
                 fields["omega"], fields["qdot"], fields["ee_pos"], fields["ee_quat"],
                 base_target], axis=-1).astype(np.float32)
            fields["flat"] = np.concatenate([fields[k] for k, _ in FLAT],
                                            axis=-1).astype(np.float32)
            self._blocks[b] = fields
        return self._blocks[b]

    def block(self, b: int, kind: str) -> np.ndarray:
        """Requests ``b * BLOCK .. (b + 1) * BLOCK - 1`` in the ``kind`` layout,
        (BLOCK, vehicles, width): ``"packed"``, the serving wire, float32 (the
        obs vector (27: pos, quat wxyz, q, vel, omega, qdot) then the target
        vector (10: EE position, EE quaternion wxyz, base target));
        ``"flat"``, the solver's observation fields (:data:`FLAT`), float32;
        or one of those fields by name, float64."""
        return self._block(b)[kind]


FLAT = (("pos", 3), ("rpy", 3), ("vel", 3), ("omega", 3), ("q", 7), ("qdot", 7),
        ("ee_pos", 3), ("ee_quat", 4), ("base_target", 3))


def split_flat(x):
    """Columns of a :meth:`VehicleStream.flat` array (or tensor) by name."""
    out, i = {}, 0
    for name, w in FLAT:
        out[name] = x[..., i:i + w]
        i += w
    return out


def episode_start(seed: int, episode: int, task: dict, mix: dict) -> dict:
    """Episode ``episode``'s start for ``mix["vehicles"]`` vehicles (float64
    rows, (vehicles, width)) and their Philox keys (63-bit ints)."""
    n = int(mix["vehicles"])
    rng = _rng(seed, _EPISODE, episode)
    base_off = rng.uniform(-1.0, 1.0, (n, 3)) * mix["base_box_m"]
    tgt_off = rng.uniform(-1.0, 1.0, (n, 3)) * mix["target_box_m"]
    keys = [int(k) for k in rng.integers(0, 2**63 - 1, n, dtype=np.int64)]
    hover = np.asarray(task["hover_pos"], dtype=np.float64)
    return {
        "pos": hover + base_off,
        "ee_pos": np.asarray(task["ee_target_pos"]) + tgt_off,
        "ee_quat": np.broadcast_to(np.asarray(task["ee_target_quat_wxyz"], dtype=np.float64),
                                   (n, 4)).copy(),
        "base_target": hover + tgt_off,
        "keys": keys,
    }


def request_keys(seed: int, n: int) -> list:
    """One 63-bit Philox key per vehicle of a request stream."""
    return [int(k) for k in _rng(seed, _STREAM, 1).integers(0, 2**63 - 1, n, dtype=np.int64)]
