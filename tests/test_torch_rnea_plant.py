"""The port's RNEA-plant module (``ops/cuda/rnea_plant_kernel``) on the CPU.

The whole-body loop's rule for which code runs a control period's physics
(``sim/whole_body_loop.plant_path``): the kernel on a CUDA device with the
kernel backend and the per-substep RNEA plant, the reach traffic's loop
block included; the plain loop on the CPU, with ``backend="torch"`` and
with the frozen coefficients.  The plain version equal bit for bit to the
substep loop of ``physics_tick`` it replaced, in every mode, with and
without the factor taken once per period, a payload and an external
wrench.  The C interface (the ctypes struct against the CUDA source, which
this machine cannot compile), the struct's values, and the wrapper's
refusal of what it does not take.  Torch only."""

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu_torch.models import rigid_body as rb
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import rnea_plant_kernel as rpk
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as wb

ROOT = Path(__file__).resolve().parents[1]
CU_SOURCE = Path(rpk.__file__).resolve().parents[2] / "csrc" / "rnea_plant_kernel.cu"
REACH_TRAFFIC = ROOT / "portbench" / "traffic" / "reach_b1.json"
PRESETS = {"attitude": wb.WholeBodyMPPIParams, "position": wb.position_mode_params,
           "wrench": wb.wrench_mode_params}
CUDA = torch.device("cuda", 0)  # a device object only: nothing runs on it here
CPU = torch.device("cpu")


def _physics(mode, mass_matrix_per_control=False, payload=0.0):
    return wbl.plant_physics(PRESETS[mode](), wbl.WholeBodyLoopConfig(
        mass_matrix_per_control=mass_matrix_per_control, payload_mass=payload))


@pytest.mark.parametrize("loop,backend,device,want", [
    (json.loads(REACH_TRAFFIC.read_text())["loop"], "cuda", CUDA, "rnea_kernel"),
    (json.loads(REACH_TRAFFIC.read_text())["loop"], "cuda", CPU, "plain"),
    (json.loads(REACH_TRAFFIC.read_text())["loop"], "torch", CUDA, "plain"),
    ({}, "cuda", CUDA, "rnea_kernel"),
    ({"mass_matrix_per_control": True}, "cuda", CUDA, "rnea_kernel"),
    ({"payload_mass": 0.5}, "cuda", CUDA, "rnea_kernel"),
    ({"arm_coeffs_per_control": True}, "cuda", CUDA, "plain"),
    ({"arm_coeffs_per_control": True, "plant_kernel": True}, "cuda", CUDA, "plant_tick"),
    ({"arm_coeffs_per_control": True, "plant_kernel": True}, "cuda", CPU, "plant_tick"),
    ({}, "cuda", "cpu", "plain"),
], ids=["reach-card", "reach-cpu", "reach-torch-backend", "default-card", "mm-once-card",
        "payload-card", "frozen-coeffs-card", "plant-tick-card", "plant-tick-cpu",
        "default-cpu-str"])
def test_plant_path(loop, backend, device, want):
    cfg = wbl.WholeBodyLoopConfig(**loop)
    assert wbl.plant_path(cfg, backend, device) == want


def test_reach_traffic_loop_is_the_rnea_plant():
    """The reach cells' loop block names no frozen coefficients and no plant
    tick: the flag ``plant_kernel`` (the frozen-coefficient plant_tick) is
    off, and that does not keep the RNEA kernel out."""
    loop = json.loads(REACH_TRAFFIC.read_text())["loop"]
    cfg = wbl.WholeBodyLoopConfig(**loop)
    assert not cfg.plant_kernel and not cfg.arm_coeffs_per_control
    assert wbl.plant_path(cfg, "cuda", CUDA) == "rnea_kernel"


CASES = [(mode, mm, payload, ext) for mode in sorted(PRESETS) for mm in (False, True)
         for payload, ext in ((0.0, False), (0.6, True))]


@pytest.mark.parametrize("mode,mm,payload,ext", CASES)
def test_plain_equals_the_substep_loop(mode, mm, payload, ext):
    """``rnea_plant_period_plain`` is the loop of ``physics_tick`` the
    control step ran, bit for bit (the period's factor of M from the same
    mass matrix)."""
    ph = _physics(mode, mm, payload)
    rc = rpk.make_rnea_plant_config(ph, 10)
    plant, cmd, tau, ext_w = rpk.sample_rows(rc, 3, seed=4, device="cpu", external=ext)
    dyn = (torch.linalg.cholesky_ex(rb.mass_matrix(ph.spec, ph.inertials, plant.q)).L
           if mm else None)
    want = plant
    for _ in range(10):
        want = wbl.physics_tick(ph, want, cmd, tau, dyn, ext_w)
    for given in (dyn, None):  # the loop's factor, or the plain version's own
        got = rpk.rnea_plant_period_plain(ph, 10, plant, cmd, tau, given, ext_w)
        assert torch.equal(rpk.pack_state(got), rpk.pack_state(want))
    assert not torch.equal(rpk.pack_state(want), rpk.pack_state(plant))


def test_pack_round_trip():
    rc = rpk.make_rnea_plant_config(_physics("position"), 10)
    plant, *_ = rpk.sample_rows(rc, 4, seed=1, device="cpu")
    vec = rpk.pack_state(plant)
    assert vec.shape == (4, rpk.STATE_SIZE)
    assert torch.equal(rpk.pack_state(rpk.unpack_state(vec)), vec)


def _c_struct_fields(src: str, name: str):
    body = re.search(rf"struct {name} \{{(.*?)\}};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        ctype, names = decl.split(None, 1)
        for item in names.split(","):
            dims = [int(defines.get(d, d)) for d in re.findall(r"\[(\w+)\]", item)]
            fields.append((item.split("[")[0].strip(), ctype, int(np.prod(dims or [1]))))
    return fields


def test_ctypes_struct_matches_the_cuda_source():
    src = CU_SOURCE.read_text()
    want = _c_struct_fields(src, "RneaPlantParams")
    got = []
    for name, ctype in rpk.RneaPlantParams._fields_:
        n = 1
        while hasattr(ctype, "_length_"):  # nested ctypes arrays
            n, ctype = n * ctype._length_, ctype._type_
        got.append((name, "int" if ctype is ctypes.c_int else "float", n))
    assert got == want
    assert ctypes.sizeof(rpk.RneaPlantParams) == 4 * sum(n for _, _, n in want)
    # a kernel parameter: under the 4 KB a launch takes by value
    assert ctypes.sizeof(rpk.RneaPlantParams) < 4096


def test_lane_layout_matches_the_cuda_source():
    """Eight lanes per vehicle row (seven mass-matrix columns and nle; eight
    rotors), whole rows in a warp and a block, as the wrapper declares."""
    d = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", CU_SOURCE.read_text())}
    assert (d["RP_LANES"], d["RP_BLOCK"], d["RP_STATE"], d["RP_EXT"]) == \
        (rpk.LANES, rpk.BLOCK, rpk.STATE_SIZE, rpk.EXT_SIZE)
    assert (d["RP_J"], d["RP_R"]) == (rpk.N_J, rpk.N_R)
    assert d["RP_J"] + 1 == rpk.LANES and d["RP_R"] <= rpk.LANES
    assert 32 % rpk.LANES == 0 and rpk.BLOCK % 32 == 0


def test_modes_match_the_cuda_source():
    """Every (mode, factor once) pair the wrapper can ask for has its
    template instance in the launcher's switch."""
    src = CU_SOURCE.read_text()
    inst = set(re.findall(r"launch<(\d), (true|false)>", src))
    assert inst == {(str(m), b) for m in rpk.MODES.values() for b in ("true", "false")}


def test_config_struct_values():
    ph = _physics("wrench", mass_matrix_per_control=True, payload=0.6)
    rc = rpk.make_rnea_plant_config(ph, 10)
    s, m = rc.struct, ph.model
    assert (rc.mode, rc.mass_matrix_per_control, rc.substeps) == (2, True, 10)
    assert s.ff_gravity == int(not m.couple_arm_gravity) == 1
    assert s.rate_damping == pytest.approx(m.rate_damping)
    assert s.mass == pytest.approx(m.vehicle.mass + m.arm_mass_lump + 0.6)
    base = m.inertials()
    assert s.link_mass[6] == pytest.approx(base.mass[6] + 0.6)
    np.testing.assert_allclose(list(s.com[6]), base.com[6] * base.mass[6] / (base.mass[6] + 0.6),
                               rtol=1e-6)
    np.testing.assert_allclose([list(r) for r in s.pinv], m.vehicle.allocation_pinv(), rtol=1e-6)
    att = rpk.make_rnea_plant_config(_physics("attitude"), 10).struct
    mp = wb.WholeBodyMPPIParams().model
    assert list(att.att_kp) == pytest.approx([mp.att_kp_rp, mp.att_kp_rp, mp.att_kp_yaw])
    assert list(att.att_kd) == pytest.approx([mp.att_kd_rp, mp.att_kd_rp, mp.att_kd_yaw])
    assert att.ff_gravity == 0 and att.rate_damping == 0.0


def test_config_refuses_the_frozen_coefficients():
    ph = _physics("position")
    with pytest.raises(ValueError, match="per-substep RNEA"):
        rpk.make_rnea_plant_config(wbl.PlantPhysics(**{**ph.__dict__,
                                                       "arm_coeffs_per_control": True}), 10)


def test_kernel_refuses_a_cpu_plant():
    """A plant off the card never falls back to the plain loop silently."""
    rc = rpk.make_rnea_plant_config(_physics("attitude"), 10)
    plant, cmd, tau, _ = rpk.sample_rows(rc, 1, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        rpk.rnea_plant_period(rc, plant, cmd, tau)


def test_cpu_episode_runs_the_plain_loop(monkeypatch):
    """On the CPU the default loop steps the plain version, never the
    kernel, and counts no launch."""
    calls = []
    monkeypatch.setattr(rpk, "rnea_plant_period",
                        lambda *a, **k: calls.append(a) or pytest.fail("kernel on the CPU"))
    real = rpk.rnea_plant_period_plain
    monkeypatch.setattr(rpk, "rnea_plant_period_plain",
                        lambda *a, **k: calls.append("plain") or real(*a, **k))
    params = wb.wrench_mode_params(n_samples=32, n_horizon=4)
    run = wbl.make_whole_body_episode(params, n_control_steps=2, device="cpu",
                                      low_k_guard="off")
    _, init = wb.make_whole_body_solver(params, device="cpu", low_k_guard="off")
    obs = wb.default_obs(device="cpu")
    run(wbl.init_plant(params.model.vehicle, device="cpu"), init(0), obs.ee_target,
        obs.base_target)
    assert calls == ["plain", "plain"]
