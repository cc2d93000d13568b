"""The port's plant-tick module (``ops/cuda/plant_kernel``) on the CPU.

Its plain version runs one control period of the serving plant from the
perturbed state of the JAX package's own plant-kernel test and is held to
the JAX XLA period built the same way and to the JAX Pallas kernel in
interpret mode (rtol/atol 2e-4 per field).  Also: the state and
coefficient layouts element for element, the C interface (the ctypes
struct against the CUDA source, which this machine cannot compile), the
configuration struct's values and the tick's refusal of other devices and
layouts."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu.models import rigid_body as jrb
from quadrotor_manipulator_mppi_tpu.ops.pallas import plant_kernel as jpk
from quadrotor_manipulator_mppi_tpu.sim import closed_loop as jcl
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwbs
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models import rigid_body as rb
from quadrotor_manipulator_mppi_tpu_torch.ops.cuda import plant_kernel as pk
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc

from torch_parity import N, T, to_port, torch_one_thread  # noqa: F401

CU_SOURCE = Path(pk.__file__).resolve().parents[2] / "csrc" / "plant_kernel.cu"
FIELDS = [("pos", 0, 3), ("quat", 3, 7), ("vel", 7, 10), ("omega", 10, 13),
          ("rotor", 13, 21), ("q", 21, 28), ("qdot", 28, 35), ("int_err", 35, 38),
          ("prev_err", 38, 41), ("m_hat", 41, 44), ("n_hat", 44, 46)]


@pytest.fixture(scope="module")
def case():
    """The perturbed plant, frozen coefficients, command and torque of
    tests/test_plant_kernel.py, and one JAX XLA control period from it."""
    params = jwbs.position_mode_params(n_samples=64, n_horizon=8)
    vehicle, spec = params.model.vehicle, params.model.chain()
    inertials, extra = params.model.inertials(), params.model.arm_mass_lump
    plant = jwbl.init_plant(vehicle)
    quat = jnp.asarray([0.998, 0.03, -0.04, 0.02])
    base = plant.base._replace(pos=jnp.asarray([0.12, -0.2, 2.05]),
                               quat=quat / jnp.linalg.norm(quat),
                               vel=jnp.asarray([0.15, -0.1, 0.05]),
                               omega=jnp.asarray([0.05, -0.08, 0.02]))
    ctrl = plant.ctrl._replace(int_err=jnp.asarray([0.01, -0.02, 0.005]),
                               prev_err=jnp.asarray([0.02, 0.01, -0.01]))
    plant = plant._replace(base=base, qdot=jnp.full(7, 0.15), ctrl=ctrl)
    dyn = jrb.frozen_arm_coeffs(spec, inertials, plant.q)
    cmd = jnp.asarray([0.1, -0.15, 2.1, 0.05])
    tau = jnp.asarray([1.0, -2.0, 0.5, 3.0, -0.2, 0.1, 0.05])

    def tick(carry, _):
        pl_, = carry
        w, x, y, z = pl_.base.quat
        a0 = 9.81 * jnp.stack([2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
                               1.0 - 2.0 * (x * x + y * y)])
        qdd = jrb.frozen_forward_dynamics(dyn, a0, pl_.qdot, tau)
        tau_g = jrb.frozen_gravity_torque_on_base(dyn, a0)
        qdot = pl_.qdot + qdd * 0.001
        q_raw = pl_.q + qdot * 0.001
        q_lo, q_hi = jnp.asarray(spec.lower, q_raw.dtype), jnp.asarray(spec.upper, q_raw.dtype)
        q = jnp.clip(q_raw, q_lo, q_hi)
        qdot = jnp.where((q_raw < q_lo) | (q_raw > q_hi), 0.0, qdot)
        sp = jfc.FlightSetpoint(pos=cmd[0:3], vel=jnp.zeros(3), yaw=cmd[3],
                                yaw_rate=jnp.zeros(()))
        u, ctrl2 = jfc.backstepping_step(
            jfc.FlightGains(), vehicle, pl_.ctrl, sp, pos=pl_.base.pos,
            vel_world=pl_.base.vel, rpy=jcl.rpy_of(pl_.base), omega_body=pl_.base.omega,
            dt=0.001, tau_g=tau_g)
        base2 = jmr.step(vehicle, pl_.base, jfc.allocate(vehicle, u), 0.001, extra_mass=extra,
                         external_wrench_body=(jnp.zeros(3), tau_g))
        return (pl_._replace(base=base2, q=q, qdot=qdot, ctrl=ctrl2),), None

    (want,), _ = jax.lax.scan(tick, (plant,), None, length=10)
    port = to_port(params)
    pc = pk.make_plant_config(port.model.vehicle, fc.FlightGains(), port.model.chain(),
                              substeps=10, dt=0.001, extra_mass=extra)
    return {"params": params, "plant": plant, "dyn": dyn, "cmd": cmd, "tau": tau,
            "want": np.asarray(jpk.pack_plant(want)), "pc": pc, "extra": extra}


def _port_period(case):
    state = T(jpk.pack_plant(case["plant"]))
    return pk.plant_tick(case["pc"], state, T(jpk.pack_dyn(case["dyn"])), T(case["cmd"]),
                         T(case["tau"]))


def _assert_fields(got, want, tol=2e-4):
    for name, a, b in FIELDS:
        np.testing.assert_allclose(got[..., a:b], want[..., a:b], rtol=tol, atol=tol,
                                   err_msg=name)


def test_layouts_match_jax(case):
    plant = case["plant"]
    state = jpk.pack_plant(plant)
    tplant = convert.plant_from_numpy(np.asarray(state), device="cpu")
    np.testing.assert_array_equal(N(pk.pack_plant(tplant)), np.asarray(state))
    back = jpk.unpack_plant(jnp.asarray(N(pk.pack_plant(tplant))), plant)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(plant)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    tdyn = rb.frozen_arm_coeffs(to_port(case["params"]).model.chain(),
                                to_port(case["params"]).model.inertials(), T(plant.q))
    jvec, tvec = np.asarray(jpk.pack_dyn(case["dyn"])), N(pk.pack_dyn(tdyn))
    assert tvec.shape == jvec.shape == (pk.DYN_SIZE,) and pk.STATE_SIZE == jpk.STATE_SIZE
    np.testing.assert_allclose(tvec, jvec, rtol=1e-4, atol=1e-5)
    # c_tau sits last, C order: [(i*7 + j)*7 + k]
    np.testing.assert_array_equal(tvec[79 + (2 * 7 + 5) * 7 + 3], N(tdyn.c_tau[2, 5, 3]))
    back = pk.unpack_dyn(pk.pack_dyn(tdyn))
    for name in ("minv", "g_tau", "g_n", "c_tau"):
        torch.testing.assert_close(getattr(back, name), getattr(tdyn, name), rtol=0, atol=0)


def test_plain_period_matches_jax_xla_period(case):
    _assert_fields(N(_port_period(case)), case["want"])


def test_plain_period_matches_jax_pallas_interpret(case):
    params = case["params"]
    tick = jpk.make_plant_tick_kernel(params.model.vehicle, jfc.FlightGains(),
                                      params.model.chain(), substeps=10, dt=0.001,
                                      extra_mass=case["extra"], interpret=True)
    want = np.asarray(tick(jpk.pack_plant(case["plant"]), jpk.pack_dyn(case["dyn"]),
                           case["cmd"], case["tau"]))
    _assert_fields(N(_port_period(case)), want)


def test_plain_period_is_batched_row_by_row(case):
    """(B, 46) rows tick independently: each equals its own (46,) tick."""
    rng = np.random.default_rng(3)
    state = T(jpk.pack_plant(case["plant"])).repeat(4, 1)
    state[:, 0:3] += T(rng.normal(0, 0.1, (4, 3)))
    state[:, 28:35] += T(rng.normal(0, 0.3, (4, 7)))
    dyn = T(jpk.pack_dyn(case["dyn"])).repeat(4, 1)
    cmd, tau = T(case["cmd"]).repeat(4, 1), T(case["tau"]).repeat(4, 1)
    out = pk.plant_tick(case["pc"], state, dyn, cmd, tau)
    assert out.shape == (4, pk.STATE_SIZE)
    for b in range(4):
        torch.testing.assert_close(out[b], pk.plant_tick(case["pc"], state[b], dyn[b], cmd[b],
                                                         tau[b]), rtol=1e-6, atol=1e-6)


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
    want = _c_struct_fields(src, "PlantParams")
    got = []
    for name, ctype in pk.PlantParams._fields_:
        n = 1
        while hasattr(ctype, "_length_"):  # nested ctypes arrays
            n, ctype = n * ctype._length_, ctype._type_
        got.append((name, "int" if ctype is ctypes.c_int else "float", n))
    assert got == want
    assert ctypes.sizeof(pk.PlantParams) == 4 * sum(n for _, _, n in want)
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert (int(defines["PT_STATE"]), int(defines["PT_DYN"]), int(defines["PT_BLOCK"])) == \
        (pk.STATE_SIZE, pk.DYN_SIZE, pk.BLOCK)


def test_lane_layout_matches_the_cuda_source():
    """Eight lanes per vehicle row: a lane for each joint and each rotor,
    whole rows in a warp and a block, as the wrapper declares."""
    defines = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", CU_SOURCE.read_text())}
    assert (defines["PT_LANES"], defines["PT_BLOCK"]) == (pk.LANES, pk.BLOCK)
    assert max(defines["PT_J"], defines["PT_R"]) <= pk.LANES
    assert 32 % pk.LANES == 0 and pk.BLOCK % 32 == 0
    assert (defines["PT_J"], defines["PT_R"]) == (pk.N_J, pk.N_R)


def test_config_struct_values(case):
    s = case["pc"].struct
    vehicle = jmr.MultirotorParams()
    assert s.substeps == 10 and s.dt == pytest.approx(0.001)
    assert s.mass == pytest.approx(vehicle.mass + case["extra"])
    np.testing.assert_allclose([list(r) for r in s.pinv], vehicle.allocation_pinv(), rtol=1e-6)
    np.testing.assert_allclose([list(r) for r in s.alloc], vehicle.allocation_matrix(),
                               rtol=1e-6)
    assert s.a_up == pytest.approx(np.exp(-0.001 / vehicle.time_constant_up))
    assert (s.kp_pitch, s.kd_pitch, s.ki_z) == (10.0, 26.0, pytest.approx(0.3))


def test_tick_refuses_other_devices_and_layouts(case):
    params = to_port(case["params"])
    tick = pk.make_plant_tick_kernel(params.model.vehicle, fc.FlightGains(),
                                     params.model.chain(), extra_mass=case["extra"],
                                     device="cpu")
    with pytest.raises(ValueError, match="built for cpu"):
        tick(torch.zeros(46, device="meta"), torch.zeros(422), torch.zeros(4), torch.zeros(7))
    with pytest.raises(ValueError, match="expected a contiguous float32"):
        pk._check(torch.zeros(46, dtype=torch.float64), (46,), torch.device("cpu"), "state")
