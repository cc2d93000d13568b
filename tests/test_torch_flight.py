"""The port's rotorcraft flight layer against the JAX package's, on the CPU.

Module level, float32, on inputs made with numpy from a seed (1e-5
absolute, or relative for large values): the ground-contact wrench, the
payload's point-mass effects, ``multirotor.step`` in each of its branches
(wind, contact with a float and a tensor gear extension, payload inertia
and mass, an external wrench, the ground clamp), ``step12`` and
``euler_rate_matrix``, ``lee_control``, ``roll_pitch_yawrate_thrust_step``,
``mission_step`` over every phase, ``wind_velocity`` (the JAX draws fed to
both sides) and ``wind_field_velocity``, each sensor on the JAX ``split``
chain's draws, ``analyze_*``, ``utils/se3``, the vehicle presets and the
configuration crossing through ``convert``.

Then the JAX package's own tests on the port, at their thresholds:
``tests/test_vehicles.py``, ``test_lee_wind.py`` (the wind and Lee cases),
``test_wind_field.py``, ``test_contact.py``, ``test_scenario.py``,
``test_sensors_metrics.py`` (the sensor cases), ``test_aux_sensors.py``
(the non-lidar cases) and ``test_plant.py``'s attitude-command case, each
at its own length except the full mission, whose Land command comes at
4 s of a 10 s flight instead of at 12 s of 20 s (the same transitions and
gates at half the ticks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.evaluation import analyze as janalyze
from quadrotor_manipulator_mppi_tpu.models import multirotor as jmr
from quadrotor_manipulator_mppi_tpu.models import vehicles as jveh
from quadrotor_manipulator_mppi_tpu.sim import flight_control as jfc
from quadrotor_manipulator_mppi_tpu.sim import lee_controller as jlee
from quadrotor_manipulator_mppi_tpu.sim import scenario as jsc
from quadrotor_manipulator_mppi_tpu.sim import sensors as jsens
from quadrotor_manipulator_mppi_tpu.sim import wind as jwind
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu.utils import se3 as jse3
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.evaluation import analyze
from quadrotor_manipulator_mppi_tpu_torch.models import multirotor as mr
from quadrotor_manipulator_mppi_tpu_torch.models import vehicles
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.sim import closed_loop as cl
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import lee_controller as lee
from quadrotor_manipulator_mppi_tpu_torch.sim import scenario
from quadrotor_manipulator_mppi_tpu_torch.sim import sensors
from quadrotor_manipulator_mppi_tpu_torch.sim import wind as wind_mod
from quadrotor_manipulator_mppi_tpu_torch.utils import rotations as rot
from quadrotor_manipulator_mppi_tpu_torch.utils import se3

from torch_parity import N, T, torch_one_thread  # noqa: F401

TOL = 1e-5
VEH = mr.MultirotorParams()
CONTACT = mr.GroundContactParams()


@pytest.fixture(autouse=True)
def no_autograd():
    with torch.inference_mode():
        yield


def close(got, want, tol=TOL, what=""):
    """|got - want| <= tol * max(1, |want|): absolute, or relative for large
    values."""
    got, want = N(got), np.asarray(want)
    scale = np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want) / scale
    assert err.max(initial=0.0) <= tol, f"{what}: {err.max()} > {tol}"


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def random_quats(rng, n, tilt=0.3):
    rpy = rng.uniform(-tilt, tilt, size=(n, 3)).astype(np.float32)
    rpy[:, 2] *= 5.0
    return np.asarray(jrot.matrix_to_quat(jrot.euler_to_matrix(J(rpy[:, ::-1]), "ZYX")))


def plant_states(rng, n=6, z=(0.2, 0.5)):
    pos = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    pos[:, 2] = rng.uniform(*z, size=n)
    quat = random_quats(rng, n)
    vel = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    om = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    w = rng.uniform(300, 560, size=(n, 8)).astype(np.float32)
    return (jmr.MultirotorState(*map(J, (pos, quat, vel, om, w))),
            mr.MultirotorState(*map(T, (pos, quat, vel, om, w))))


# --- the plant -------------------------------------------------------------

@pytest.mark.parametrize("gear", [1.0, 0.0, 0.37])
def test_ground_contact_wrench_matches_jax(gear, rng):
    js, ts = plant_states(rng, 16, z=(0.1, 0.5))
    r_j, r_t = jrot.quat_to_matrix(js.quat), rot.quat_to_matrix(ts.quat)
    gear_t = torch.tensor(gear) if gear == 0.37 else gear
    fj, tj = jmr.ground_contact_wrench(CONTACT, js.pos, r_j, js.vel, js.omega, gear, 0.0)
    ft, tt = mr.ground_contact_wrench(CONTACT, ts.pos, r_t, ts.vel, ts.omega, gear_t, 0.0)
    assert float(jnp.abs(fj).max()) > 1.0  # some feet are in contact
    close(ft, fj, what="force")
    close(tt, tj, what="torque")


def test_payload_point_mass_effects_match_jax(rng):
    r = rng.normal(size=(5, 3)).astype(np.float32)
    for got, want in zip(mr.payload_point_mass_effects(0.7, T(r)),
                         jmr.payload_point_mass_effects(0.7, J(r))):
        close(got, want)


BRANCHES = {
    "free": {},
    "wind": {"wind": True},
    "contact": {"contact": True},
    "contact_gear_tensor": {"contact": True, "gear": 0.4},
    "payload": {"inertia": True, "mass": 0.5},
    "external": {"external": True},
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_branches_match_jax(branch, rng):
    opt = BRANCHES[branch]
    js, ts = plant_states(rng, 8, z=(-0.05, 0.45))
    cmd = rng.uniform(200, 600, size=(8, 8)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if opt.get("wind"):
        w = rng.normal(size=(8, 3)).astype(np.float32) * 3.0
        kw_j["wind_world"], kw_t["wind_world"] = J(w), T(w)
    if opt.get("contact"):
        kw_j["contact"] = kw_t["contact"] = CONTACT
        if "gear" in opt:
            kw_j["gear_ext"], kw_t["gear_ext"] = J(opt["gear"]), torch.tensor(opt["gear"])
    if opt.get("inertia"):
        _, di = jmr.payload_point_mass_effects(opt["mass"], J([0.2, 0.1, -0.4]))
        kw_j["extra_inertia"], kw_t["extra_inertia"] = di, T(di)
        kw_j["extra_mass"], kw_t["extra_mass"] = J(opt["mass"]), torch.tensor(opt["mass"])
    if opt.get("external"):
        f, tq = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
        kw_j["external_wrench_body"], kw_t["external_wrench_body"] = (J(f), J(tq)), (T(f), T(tq))
    want = jmr.step(VEH, js, J(cmd), 0.001, **kw_j)
    got = mr.step(VEH, ts, T(cmd), 0.001, **kw_t)
    for name, g, w in zip(want._fields, got, want):
        close(g, w, what=name)


def test_step12_and_euler_rate_matrix_match_jax(rng):
    n = 32
    pos, vel = (rng.normal(size=(n, 3)).astype(np.float32) for _ in range(2))
    rpy = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    om = rng.normal(size=(n, 3)).astype(np.float32)
    u = np.concatenate([rng.uniform(100, 250, size=(n, 1)), rng.normal(size=(n, 3))],
                       -1).astype(np.float32)
    close(mr.euler_rate_matrix(T(rpy)), jmr.euler_rate_matrix(J(rpy)))
    js, ts = jmr.Multirotor12State(*map(J, (pos, rpy, vel, om))), \
        mr.Multirotor12State(*map(T, (pos, rpy, vel, om)))
    for kw in ({}, {"extra_mass": 5.54, "drag_kd": 0.8, "rate_damping": 12.0}):
        want = jmr.step12(VEH, js, J(u), 0.01, **kw)
        got = mr.step12(VEH, ts, T(u), 0.01, **kw)
        for name, g, w in zip(want._fields, got, want):
            close(g, w, what=name)


# --- flight control --------------------------------------------------------

@pytest.mark.parametrize("vehicle", ["harrier", "firefly"])
def test_lee_control_matches_jax(vehicle, rng):
    veh_j, veh_t = jveh.get(vehicle), vehicles.get(vehicle)
    gains_j, gains_t = jveh.lee_gains(vehicle), vehicles.lee_gains(vehicle)
    js, ts = plant_states(rng, 6, z=(1.5, 2.5))
    for i in range(6):
        p, v, a = (rng.normal(size=3).astype(np.float32) for _ in range(3))
        p[2] += 2.0
        yaw, yaw_rate = (float(x) for x in rng.uniform(-1.5, 1.5, size=2))
        sp_j = jlee.LeeSetpoint(p, velocity=v, acceleration=a, yaw=yaw, yaw_rate=yaw_rate)
        sp_t = lee.setpoint(p, velocity=v, acceleration=a, yaw=yaw, yaw_rate=yaw_rate)
        want = jlee.lee_control(gains_j, veh_j, sp_j, js.pos[i], js.vel[i], js.quat[i],
                                js.omega[i])
        got = lee.lee_control(gains_t, veh_t, sp_t, ts.pos[i], ts.vel[i], ts.quat[i],
                              ts.omega[i])
        close(got, want, what=f"U {i}")


def test_roll_pitch_yawrate_thrust_matches_jax(rng):
    rpy, om = (rng.normal(size=(7, 3)).astype(np.float32) * 0.3 for _ in range(2))
    des = rng.normal(size=(4, 7)).astype(np.float32) * 0.2
    des[3] += 150.0
    want = jfc.roll_pitch_yawrate_thrust_step(VEH, *map(J, des[:3]), J(des[3]), J(rpy), J(om))
    got = fc.roll_pitch_yawrate_thrust_step(VEH, *map(T, des[:3]), T(des[3]), T(rpy), T(om))
    close(got, want)


def mission_cases():
    """(phase, land_cmd, gripper_cmd, gripper, z, zdot) covering every
    transition and its guard."""
    return [(jsc.TAKEOFF, False, 0.0, 0.0, 1.0, 0.5), (jsc.TAKEOFF, False, 0.0, 0.0, 2.0, 0.01),
            (jsc.TAKEOFF, True, 0.0, 0.0, 1.0, 0.3), (jsc.CRUISE, False, 1.0, 0.93, 2.1, 0.0),
            (jsc.CRUISE, True, 1.0, 0.99, 2.1, 0.0), (jsc.LANDING, True, 0.0, 0.5, 1.2, -0.4),
            (jsc.LANDING, True, 0.0, 0.0, 0.45, -0.4), (jsc.LANDED, True, 0.0, 0.0, 0.34, 0.0),
            (jsc.IDLE, False, 0.0, 0.0, 0.3, 0.0)]


@pytest.mark.parametrize("case", range(9))
def test_mission_step_matches_jax(case):
    phase, land, g_cmd, grip, z, zdot = mission_cases()[case]
    cfg = jsc.MissionConfig()
    jm = jsc.init_mission()._replace(phase=jnp.asarray(phase, jnp.int32),
                                     land_cmd=jnp.asarray(land), gripper_cmd=J(g_cmd),
                                     gripper=J(grip), gear=J(0.6), land_z=J(1.3))
    tm = convert.mission_state_from_numpy(*jm, device="cpu")
    pos, vel = np.asarray([0.1, -0.2, z], np.float32), np.asarray([0.0, 0.1, zdot], np.float32)
    jnew, jsp, jon = jsc.mission_step(cfg, jm, J(pos), J(vel), 0.001)
    tnew, tsp, ton = scenario.mission_step(convert.config_from_dict(jcfg.to_dict(cfg)), tm, T(pos),
                                           T(vel), 0.001)
    for name, g, w in zip(jnew._fields, tnew, jnew):
        assert g.dtype == {"phase": torch.int32, "payload_attached": torch.bool,
                           "land_cmd": torch.bool}.get(name, torch.float32), name
        close(g, w, 1e-7, name)
    for g, w in zip(tsp, jsp):
        close(g, w, 1e-7)
    assert bool(ton) == bool(jon)
    close(scenario.payload_mass(scenario.MissionConfig(), tnew), jsc.payload_mass(cfg, jnew))


# --- wind ------------------------------------------------------------------

def test_wind_velocity_matches_jax_on_its_draws():
    wp = jwind.WindParams(mean_velocity=(0.5, -0.2, 0.0), gust_velocity=(3.0, 1.0, 0.5),
                          gust_start=0.2, gust_duration=0.3, gust_period=0.5,
                          turbulence_sigma=0.4, turbulence_tau=0.3)
    tp = convert.config_from_dict(jcfg.to_dict(wp))
    assert isinstance(tp, wind_mod.WindParams) and tp == wind_mod.WindParams(**vars(wp))
    key0 = jax.random.key(4)
    js, ts = jwind.init_wind(), wind_mod.init_wind()
    for i in range(0, 1200, 7):
        t = jnp.asarray(i, jnp.int32) * 0.001
        k = jax.random.fold_in(key0, i)
        z = jax.random.normal(k, (3,), jnp.float32)
        vj, js = jwind.wind_velocity(wp, js, t, k, 0.001)
        vt, ts = wind_mod.wind_velocity(tp, ts, torch.tensor(i, dtype=torch.int32) * 0.001, 0.001,
                                        noise=T(z))
        close(vt, vj, what=f"tick {i}")
        close(ts.turbulence, js.turbulence)


def test_wind_turbulence_draws_from_the_philox_stream():
    wp = wind_mod.WindParams(turbulence_sigma=0.5, turbulence_tau=0.2)
    seed, step = sampling.philox_keys(7, "cpu"), torch.tensor([3])
    a, _ = wind_mod.wind_velocity(wp, wind_mod.init_wind(), 0.0, 0.01, seed=seed, step=step)
    b, _ = wind_mod.wind_velocity(wp, wind_mod.init_wind(), 0.0, 0.01,
                                  noise=sensors.normals(3, seed, step))
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="standard normals or a"):
        wind_mod.wind_velocity(wp, wind_mod.init_wind(), 0.0, 0.01)


def affine(px, py, pz):
    return 0.5 + 0.2 * px - 0.1 * py, 1.0 + 0.3 * pz, -0.4 * px + 0.05 * pz


def terrain_field(rng):
    nz, ny, nx = 4, 3, 5
    return jwind.WindField(
        min_x=-2.0, min_y=-1.0, res_x=1.0, res_y=1.5,
        vertical_spacing_factors=np.asarray([0.0, 0.2, 0.6, 1.0], np.float32),
        bottom_z=rng.uniform(0.0, 2.0, size=(ny, nx)).astype(np.float32),
        top_z=rng.uniform(8.0, 12.0, size=(ny, nx)).astype(np.float32),
        u=rng.normal(size=(nz, ny, nx)).astype(np.float32),
        v=rng.normal(size=(nz, ny, nx)).astype(np.float32),
        w=rng.normal(size=(nz, ny, nx)).astype(np.float32))


@pytest.mark.parametrize("kind", ["uniform", "terrain"])
def test_wind_field_velocity_matches_jax(kind, rng):
    field = (jwind.uniform_grid_field(affine, x=(-4.0, 4.0, 5), y=(-3.0, 3.0, 4),
                                      z=(0.0, 10.0, 6))
             if kind == "uniform" else terrain_field(rng))
    tf = convert.wind_field_from_numpy(field)
    assert tf.shape == field.shape
    # Inside, on the vertices and outside the grid.
    pts = rng.uniform([-5.0, -4.0, -1.0], [5.0, 4.0, 13.0], size=(64, 3)).astype(np.float32)
    pts[:8] = np.round(pts[:8])
    want = jax.vmap(lambda p: jwind.wind_field_velocity(field, p))(J(pts))
    close(wind_mod.wind_field_velocity(tf, T(pts)), want, what="batched")
    close(wind_mod.wind_field_velocity(tf, T(pts[5])), want[5], what="one point")
    vj, _ = jwind.wind_velocity_at(jwind.WindParams(mean_velocity=(1.0, 0.0, 0.0)), field,
                                   jwind.init_wind(), J(0.0), J(pts[3]), jax.random.key(0), 0.01)
    vt, _ = wind_mod.wind_velocity_at(wind_mod.WindParams(mean_velocity=(1.0, 0.0, 0.0)), tf,
                                      wind_mod.init_wind(), 0.0, T(pts[3]), 0.01)
    close(vt, vj)


def test_fmod_floor_matches_jnp_mod(rng):
    x = rng.normal(size=1000).astype(np.float32) * 10.0
    x[:4] = [0.0, -0.0, 2 * np.pi, -2 * np.pi]
    for y in (2 * np.pi, 1e9, -3.0):
        np.testing.assert_array_equal(N(wind_mod.fmod_floor(T(x), y)),
                                      np.asarray(jnp.mod(J(x), y)))


# --- sensors ---------------------------------------------------------------

def split_normals(key, shapes):
    """The JAX split chain's draws: sub-key i draws shapes[i]."""
    keys = jax.random.split(key, len(shapes))
    return np.concatenate([np.asarray(jax.random.normal(k, s, jnp.float32)).reshape(-1)
                           for k, s in zip(keys, shapes)])


def test_imu_matches_jax_on_its_draws(rng):
    jp = jsens.ImuParams()
    tp = convert.config_from_dict(jcfg.to_dict(jp))
    key = jax.random.key(3)
    js = jsens.init_imu(jp, key)
    ts = sensors.init_imu(tp, noise=T(split_normals(key, [(3,), (3,)])))
    for got, want in zip(ts, js):
        close(got, want)
    for i in range(20):
        k = jax.random.key(100 + i)
        acc, gyr = (rng.normal(size=3).astype(np.float32) for _ in range(2))
        ja, jg, js = jsens.imu_measure(jp, js, k, J(acc), J(gyr), 0.001)
        ta, tg, ts = sensors.imu_measure(tp, ts, T(acc), T(gyr), 0.001,
                                         noise=T(split_normals(k, [(3,)] * 4)))
        close(ta, ja, what="accel")
        close(tg, jg, what="gyro")
        for got, want in zip(ts, js):
            close(got, want)


def test_gps_barometer_magnetometer_flow_match_jax(rng):
    k = jax.random.key(11)
    gp = jsens.GpsParams(horizontal_noise=0.5, vertical_noise=1.0)
    pos = rng.normal(size=3).astype(np.float32) * 10
    close(sensors.gps_measure(convert.config_from_dict(jcfg.to_dict(gp)), T(pos),
                              noise=T(split_normals(k, [(2,), (1,)]))),
          jsens.gps_measure(gp, k, J(pos)))
    bp = jsens.BarometerParams(noise_std_pa=3.0)
    for alt in (0.0, 2.1, 100.0):
        want = jsens.barometer_measure(bp, k, J(alt))
        got = sensors.barometer_measure(convert.config_from_dict(jcfg.to_dict(bp)),
                                        torch.tensor(alt),
                                        noise=T(jax.random.normal(k, (), jnp.float32)))
        close(got[0], want[0], what="pressure")
        close(got[1], want[1], 1e-4, what="altitude")
    mp = jsens.MagnetometerParams(noise_std=0.01)
    r = np.asarray(jrot.quat_to_matrix(J(random_quats(rng, 1)[0])))
    close(sensors.magnetometer_measure(convert.config_from_dict(jcfg.to_dict(mp)), T(r),
                                       noise=T(jax.random.normal(k, (3,), jnp.float32))),
          jsens.magnetometer_measure(mp, k, J(r)))
    op = jsens.OpticalFlowParams()
    for h in (2.0, 0.1):
        vb, om = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
        close(sensors.optical_flow_measure(convert.config_from_dict(jcfg.to_dict(op)), T(vb),
                                           T(om), torch.tensor(h),
                                           noise=T(jax.random.normal(k, (2,), jnp.float32))),
              jsens.optical_flow_measure(op, k, J(vb), J(om), J(h)))


@pytest.mark.parametrize("noisy", [False, True])
def test_odometry_matches_jax_on_its_draws(noisy, rng):
    jp = jsens.OdometryParams(delay_steps=2, **({"pos_noise": 0.1, "vel_noise": 0.2,
                                                  "att_noise": 0.0, "rate_noise": 0.05}
                                                 if noisy else {}))
    tp = convert.config_from_dict(jcfg.to_dict(jp))
    p0 = rng.normal(size=3).astype(np.float32)
    js, ts = jsens.init_odometry(jp, J(p0)), sensors.init_odometry(tp, T(p0))
    for t in range(7):
        k = jax.random.key(t)
        truth = [rng.normal(size=3).astype(np.float32) for _ in range(4)]
        jm, js = jsens.odometry_measure(jp, js, k, *map(J, truth))
        tm, ts = sensors.odometry_measure(tp, ts, *map(T, truth),
                                          noise=T(split_normals(k, [(3,)] * 4)))
        for got, want in zip(tm, jm):
            close(got, want)
        assert int(ts.head) == int(js.head) and ts.head.dtype == torch.int32


def test_sensors_draw_from_the_philox_stream():
    seed, step = sampling.philox_keys(9, "cpu"), torch.tensor([4])
    z = sensors.normals(12, seed, step)
    st = sensors.init_imu(sensors.ImuParams(), noise=torch.zeros(6))
    a = sensors.imu_measure(sensors.ImuParams(), st, torch.zeros(3), torch.zeros(3), 0.001,
                            seed=seed, step=step)
    b = sensors.imu_measure(sensors.ImuParams(), st, torch.zeros(3), torch.zeros(3), 0.001,
                            noise=z)
    assert all(torch.equal(x, y) for x, y in zip(a[:2], b[:2]))
    with pytest.raises(ValueError, match="expected 3 standard normals"):
        sensors.gps_measure(sensors.GpsParams(), torch.zeros(3), noise=torch.zeros(2))


# --- evaluation, se3, vehicles, configs --------------------------------------

def test_analyze_matches_jax(rng):
    t = np.arange(600) * 0.01
    pos = np.zeros((600, 3), np.float32)
    pos[:, 2] = 2.0 - np.exp(-3 * t)
    pos[300:320, 0] += 0.4 * np.sin(np.linspace(0, np.pi, 20))
    data = {"pos": pos, "omega": rng.normal(size=(600, 3)).astype(np.float32) * 0.05}
    target = [0.0, 0.0, 2.0]
    assert analyze.analyze_hover(data, target, 0.01) == janalyze.analyze_hover(data, target, 0.01)
    assert analyze.analyze_hover({"pos": T(pos)}, target, 0.01) == \
        janalyze.analyze_hover({"pos": pos}, target, 0.01)
    for fn, jfn in ((analyze.analyze_waypoint, janalyze.analyze_waypoint),
                    (analyze.analyze_disturbance, janalyze.analyze_disturbance)):
        assert fn(data, target, 0.01, 0.1) == jfn(data, target, 0.01, 0.1)
        assert fn({"pos": T(pos)}, target, 0.01, 0.1) == jfn(data, target, 0.01, 0.1)


def test_se3_matches_jax(rng):
    xyz, rpy = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(
        np.float32)
    quat = random_quats(rng, 5)
    q = rng.normal(size=(5,)).astype(np.float32)
    axis = np.asarray([0.0, 0.6, 0.8], np.float32)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    a_j, a_t = jse3.from_xyz_rpy(J(xyz), J(rpy)), se3.from_xyz_rpy(T(xyz), T(rpy))
    b_j, b_t = jse3.from_xyz_quat(J(xyz[::-1]), J(quat)), se3.from_xyz_quat(T(xyz[::-1].copy()),
                                                                           T(quat))
    pairs = [(a_t, a_j), (b_t, b_j), (a_t.compose(b_t), a_j.compose(b_j)),
             (a_t.inverse(), a_j.inverse()),
             (se3.revolute(a_t, T(axis), T(q)), jse3.revolute(a_j, J(axis), J(q))),
             (se3.prismatic(a_t, T(axis), T(q)), jse3.prismatic(a_j, J(axis), J(q)))]
    for got, want in pairs:
        close(got.rot, want.rot)
        close(got.trans, want.trans)
    close(a_t.apply(T(pts)), a_j.apply(J(pts)))
    close(a_t.to_homogeneous(), a_j.to_homogeneous())
    h = se3.from_homogeneous(a_t.to_homogeneous())
    close(h.rot, a_j.rot)
    close(se3.skew(T(pts)), jse3.skew(J(pts)))
    close(se3.unskew(se3.skew(T(pts))), pts)
    close(se3.identity((2,)).to_homogeneous(), jse3.identity((2,)).to_homogeneous())


@pytest.mark.parametrize("name", jveh.names())
def test_vehicle_presets_match_jax(name):
    assert vehicles.names() == jveh.names()
    got, want = vehicles.get(name), jveh.get(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.allocation_pinv(), want.allocation_pinv())
    assert dataclasses.asdict(vehicles.lee_gains(name)) == \
        dataclasses.asdict(jveh.lee_gains(name))
    assert convert.config_from_dict(jcfg.to_dict(want)) == got


def test_new_configs_cross_through_convert():
    for jobj, cls in ((jmr.GroundContactParams(stiffness=1e4), mr.GroundContactParams),
                      (jlee.LeeGains(position=(1.0, 2.0, 3.0)), lee.LeeGains),
                      (jsc.MissionConfig(land_descent_rate=0.3), scenario.MissionConfig),
                      (jsens.ImuParams(gyro_bias_corr_time=5.0), sensors.ImuParams),
                      (jsens.OdometryParams(delay_steps=3), sensors.OdometryParams)):
        got = convert.config_from_dict(jcfg.to_dict(jobj))
        assert isinstance(got, cls) and dataclasses.asdict(got) == dataclasses.asdict(jobj)


# --- the JAX package's own tests, on the port --------------------------------

def hover_plant(veh, pos):
    s = mr.init_state(veh, pos=pos)
    return s._replace(rotor_speed=torch.full((veh.n_rotors,), veh.hover_rotor_speed()))


def test_registry():  # tests/test_vehicles.py
    assert set(vehicles.names()) == {"harrier", "firefly", "hummingbird", "pelican", "iris",
                                     "neo11", "ardrone"}
    with pytest.raises(KeyError, match="unknown vehicle"):
        vehicles.get("techpod")


def test_hummingbird_allocation_matches_rotors_formula():
    veh = vehicles.hummingbird()
    a = veh.allocation_matrix()
    kf, km, length = 8.54858e-6, 1.6e-2, 0.17
    np.testing.assert_allclose(a[:, 0], [0.0, -length * kf, kf * km, kf], atol=1e-12)
    np.testing.assert_allclose(a[:, 1], [length * kf, 0.0, -kf * km, kf], atol=1e-12)
    assert np.linalg.matrix_rank(a) == 4
    np.testing.assert_allclose(a @ veh.allocation_pinv(), np.eye(4), atol=1e-9)


@pytest.mark.parametrize("name", vehicles.names())
def test_hover_equilibrium_every_vehicle(name):
    veh = vehicles.get(name)
    w2 = veh.allocation_pinv() @ np.array([0.0, 0.0, 0.0, veh.mass * mr.GRAVITY])
    trim = T(np.sqrt(np.maximum(w2, 0.0)))
    s = mr.init_state(veh, pos=(0.0, 0.0, 2.0))._replace(rotor_speed=trim)
    for _ in range(200):
        s = mr.step(veh, s, trim, 0.001)
    np.testing.assert_allclose(N(s.pos), [0.0, 0.0, 2.0], atol=1e-3)
    assert float(torch.linalg.norm(s.omega)) < 1e-3


def lee_fly(veh, gains, sp, s, n, wind_params=None):
    ws = wind_mod.init_wind()
    pos = []
    for i in range(n):
        wvel = None
        if wind_params is not None:
            wvel, ws = wind_mod.wind_velocity(wind_params, ws, torch.tensor(i, dtype=torch.int32)
                                              * 0.001, 0.001)
        u = lee.lee_control(gains, veh, sp, pos=s.pos, vel_world=s.vel, quat=s.quat,
                            omega_body=s.omega)
        s = mr.step(veh, s, fc.allocate(veh, u), 0.001, wind_world=wvel)
        pos.append(s.pos)
    return N(torch.stack(pos)), s


@pytest.mark.parametrize("name", ["firefly", "iris", "hummingbird"])
def test_lee_hover_stock_vehicle(name):
    veh = vehicles.get(name)
    pos, _ = lee_fly(veh, vehicles.lee_gains(name), lee.setpoint([0.0, 0.0, 2.0]),
                     hover_plant(veh, (0.3, -0.2, 1.5)), 5000)
    err = np.linalg.norm(pos - [0.0, 0.0, 2.0], axis=-1)
    assert err[-1] < 0.03, f"{name}: final err {err[-1]:.3f}"
    assert err[-500:].max() < 0.05, f"{name}: not settled"


def test_lee_controller_tracks_waypoint():  # tests/test_lee_wind.py
    pos, _ = lee_fly(VEH, lee.LeeGains(), lee.setpoint([1.0, -0.5, 2.5]),
                     hover_plant(VEH, (0.0, 0.0, 2.0)), 8000)
    assert np.linalg.norm(pos[-1] - [1.0, -0.5, 2.5]) < 0.05
    assert np.all(np.isfinite(pos))


def test_lee_controller_yaw_setpoint():
    _, final = lee_fly(VEH, lee.LeeGains(), lee.setpoint([0.0, 0.0, 2.0], yaw=0.8),
                       hover_plant(VEH, (0.0, 0.0, 2.0)), 6000)
    ang = rot.matrix_to_euler(rot.quat_to_matrix(final.quat), "ZYX")
    assert abs(float(ang[0]) - 0.8) < 0.1


def test_hover_rejects_wind_gust():
    wp = wind_mod.WindParams(gust_velocity=(5.0, 0.0, 0.0), gust_start=2.0, gust_duration=1.0,
                             gust_period=1e9)
    pos, _ = lee_fly(VEH, lee.LeeGains(), lee.setpoint([0.0, 0.0, 2.0]),
                     hover_plant(VEH, (0.0, 0.0, 2.0)), 8000, wp)
    err = np.linalg.norm(pos - [0.0, 0.0, 2.0], axis=-1)
    assert err[1500] < 0.05
    assert err[-1] < 0.1, f"did not recover: {err[-1]:.3f}"


def test_wind_velocity_gust_envelope():
    wp = wind_mod.WindParams(mean_velocity=(1.0, 0.0, 0.0), gust_velocity=(0.0, 2.0, 0.0),
                             gust_start=1.0, gust_duration=2.0, gust_period=10.0)
    ws = wind_mod.init_wind()
    for t, want, atol in ((0.5, [1.0, 0.0, 0.0], 1e-6), (2.0, [1.0, 2.0, 0.0], 1e-5),
                          (4.0, [1.0, 0.0, 0.0], 1e-6)):
        v, _ = wind_mod.wind_velocity(wp, ws, torch.tensor(t), 0.01)
        np.testing.assert_allclose(N(v), want, atol=atol)


def test_ou_turbulence_statistics():
    wp = wind_mod.WindParams(turbulence_sigma=0.5, turbulence_tau=0.2)
    ws, seed = wind_mod.init_wind(), sampling.philox_keys(1, "cpu")
    z = sensors.normals(3 * 3000, seed, torch.tensor([0])).reshape(3000, 3)
    vals = []
    for i in range(3000):
        v, ws = wind_mod.wind_velocity(wp, ws, torch.tensor(i * 0.01), 0.01, noise=z[i])
        vals.append(N(v))
    assert abs(np.stack(vals)[500:].std() - 0.5) < 0.12


def test_lee_yaw_step_damped():
    veh = vehicles.get("harrier")
    _, pf = lee_fly(veh, vehicles.lee_gains("harrier"), lee.setpoint([0.0, 0.0, 2.0],
                                                                     yaw=np.pi / 4),
                    hover_plant(veh, (0.0, 0.0, 2.0)), 3000)
    ang = rot.matrix_to_euler(rot.quat_to_matrix(pf.quat), "ZYX")
    assert abs(float(ang[0]) - np.pi / 4) < 0.06
    assert float(torch.linalg.norm(pf.pos - torch.tensor([0.0, 0.0, 2.0]))) < 0.5
    assert float(pf.omega[2].abs()) < 0.1


def test_trilinear_reproduces_affine_field_exactly(rng):  # tests/test_wind_field.py
    field = wind_mod.uniform_grid_field(affine, x=(-4.0, 4.0, 5), y=(-3.0, 3.0, 4),
                                        z=(0.0, 10.0, 6))
    pts = rng.uniform([-3.9, -2.9, 0.1], [3.9, 2.9, 9.9], size=(64, 3))
    want = np.stack(affine(pts[:, 0], pts[:, 1], pts[:, 2]), axis=-1)
    np.testing.assert_allclose(N(wind_mod.wind_field_velocity(field, T(pts))), want, rtol=1e-4,
                               atol=1e-4)


def test_grid_vertices_sampled_exactly():
    field = wind_mod.uniform_grid_field(lambda px, py, pz: (np.sin(px) * py, pz * 0.1,
                                                            px + py + pz),
                                        x=(-2.0, 2.0, 5), y=(-2.0, 2.0, 5), z=(0.0, 4.0, 5))
    for ix, iy, iz in [(0, 0, 0), (2, 3, 1), (4, 4, 4)]:
        p = torch.tensor([field.min_x + ix * field.res_x, field.min_y + iy * field.res_y,
                          float(field.vertical_spacing_factors[iz]) * 4.0])
        np.testing.assert_allclose(N(wind_mod.wind_field_velocity(field, p)),
                                   [field.u[iz, iy, ix], field.v[iz, iy, ix],
                                    field.w[iz, iy, ix]], atol=1e-5)


def test_outside_grid_clamps_to_boundary():
    field = wind_mod.uniform_grid_field(affine, x=(-4.0, 4.0, 5), y=(-3.0, 3.0, 4),
                                        z=(0.0, 10.0, 6))
    inside = wind_mod.wind_field_velocity(field, torch.tensor([4.0, 3.0, 10.0]))
    outside = wind_mod.wind_field_velocity(field, torch.tensor([40.0, 30.0, 100.0]))
    np.testing.assert_allclose(N(outside), N(inside), atol=1e-5)


def test_terrain_following_columns():
    nz, ny, nx = 3, 2, 2
    field = wind_mod.WindField(
        min_x=0.0, min_y=0.0, res_x=1.0, res_y=1.0,
        vertical_spacing_factors=np.asarray([0.0, 0.5, 1.0], np.float32),
        bottom_z=np.asarray([[0.0, 10.0], [0.0, 10.0]], np.float32),
        top_z=np.asarray([[20.0, 30.0], [20.0, 30.0]], np.float32),
        u=np.arange(nz * ny * nx, dtype=np.float32).reshape(nz, ny, nx),
        v=np.zeros((nz, ny, nx), np.float32), w=np.zeros((nz, ny, nx), np.float32))
    got = wind_mod.wind_field_velocity(field, torch.tensor([0.0, 0.0, 10.0]))
    np.testing.assert_allclose(float(got[0]), field.u[1, 0, 0], atol=1e-5)
    got = wind_mod.wind_field_velocity(field, torch.tensor([1.0, 0.0, 10.0]))
    np.testing.assert_allclose(float(got[0]), field.u[0, 0, 1], atol=1e-5)


def test_read_reference_text_format(tmp_path):
    path = tmp_path / "field.txt"
    path.write_text("min_x: -1.0\nmin_y: -2.0\nn_x: 2\nn_y: 2\nres_x: 2.0\nres_y: 4.0\n"
                    "vertical_spacing_factors: 0.0 1.0\nbottom_z: 0.0 0.0 0.0 0.0\n"
                    "top_z: 10.0 10.0 10.0 10.0\nu: 1.0 2.0 3.0 4.0 5.0 6.0 7.0 8.0\n"
                    "v: 0.0 0.0 0.0 0.0 0.0 0.0 0.0 0.0\nw: 0.5 0.5 0.5 0.5 0.5 0.5 0.5 0.5\n")
    field = wind_mod.read_wind_field(str(path))
    assert field.shape == (2, 2, 2)
    assert field.min_x == -1.0 and field.res_y == 4.0
    assert field.u[0, 0, 1] == 2.0
    got = wind_mod.wind_field_velocity(field, torch.tensor([1.0, -2.0, 0.0]))
    np.testing.assert_allclose(N(got), [2.0, 0.0, 0.5], atol=1e-5)


def test_wind_velocity_at_combines_field_and_gust():
    field = wind_mod.uniform_grid_field(
        lambda px, py, pz: (np.full_like(px, 2.0), np.zeros_like(px), np.zeros_like(px)),
        x=(-4.0, 4.0, 3), y=(-4.0, 4.0, 3), z=(0.0, 10.0, 3))
    v, _ = wind_mod.wind_velocity_at(wind_mod.WindParams(mean_velocity=(1.0, 0.0, 0.0)), field,
                                     wind_mod.init_wind(), torch.tensor(0.0),
                                     torch.tensor([0.0, 0.0, 2.0]), 0.01)
    np.testing.assert_allclose(N(v), [3.0, 0.0, 0.0], atol=1e-5)


def drop(state0, n=3000, gear_ext=1.0):  # tests/test_contact.py
    s = state0
    for _ in range(n):
        s = mr.step(VEH, s, torch.zeros(8), 0.001, contact=CONTACT, gear_ext=gear_ext)
    return s


def test_drop_settles_on_gear_springs():
    s = drop(mr.init_state(VEH, pos=(0.0, 0.0, 0.6)))
    rest = CONTACT.gear_height - VEH.mass * 9.81 / (4 * CONTACT.stiffness)
    assert abs(float(s.pos[2]) - rest) < 0.01
    assert float(torch.linalg.norm(s.vel)) < 0.02
    assert float(torch.linalg.norm(s.omega)) < 0.05
    assert float(rot.quat_to_matrix(s.quat)[2, 2]) > 0.999


def test_tilted_touchdown_self_rights():
    q0 = rot.matrix_to_quat(rot.euler_to_matrix(torch.tensor([0.0, 0.0, 0.15]), "ZYX"))
    s = drop(mr.init_state(VEH, pos=(0.0, 0.0, 0.5))._replace(quat=q0), n=5000)
    assert float(rot.quat_to_matrix(s.quat)[2, 2]) > 0.995, "did not right itself"
    assert float(torch.linalg.norm(s.vel)) < 0.05


def test_friction_stops_lateral_slide():
    s0 = mr.init_state(VEH, pos=(0.0, 0.0, CONTACT.gear_height))._replace(
        vel=torch.tensor([1.0, 0.0, 0.0]))
    s = drop(s0, n=4000)
    assert float(s.vel[0].abs()) < 0.02
    assert 0.01 < float(s.pos[0]) < 2.0


def test_belly_contact_when_gear_retracted():
    s = drop(mr.init_state(VEH, pos=(0.0, 0.0, 0.4)), gear_ext=0.0)
    rest = CONTACT.belly_height - VEH.mass * 9.81 / (4 * CONTACT.stiffness)
    assert abs(float(s.pos[2]) - rest) < 0.01


def test_payload_point_mass_effects():
    mr_arm, di = mr.payload_point_mass_effects(0.5, torch.tensor([0.2, 0.0, -0.4]))
    np.testing.assert_allclose(N(mr_arm), [0.1, 0.0, -0.2], atol=1e-6)
    r2 = 0.2 ** 2 + 0.4 ** 2
    np.testing.assert_allclose(N(di), [0.5 * (r2 - 0.04), 0.5 * r2, 0.5 * (r2 - 0.16)],
                               atol=1e-6)


def test_contact_free_flight_unaffected():
    s0 = hover_plant(VEH, (0.0, 0.0, 2.0))
    cmd = torch.full((8,), VEH.hover_rotor_speed())
    a, b = mr.step(VEH, s0, cmd, 0.001, contact=CONTACT), mr.step(VEH, s0, cmd, 0.001)
    np.testing.assert_allclose(N(a.pos), N(b.pos), atol=1e-7)
    np.testing.assert_allclose(N(a.vel), N(b.vel), atol=1e-7)


def test_full_mission_episode():  # tests/test_scenario.py, Land at 4 s of 10 s
    cfg, gains = scenario.MissionConfig(), fc.FlightGains()
    plant, ctrl, mission = (mr.init_state(VEH, pos=(0.0, 0.0, 0.1)), fc.init_ctrl_state(VEH.mass),
                            scenario.init_mission())
    z, phases, gear = [], [], []
    for t in range(10000):
        mission = mission._replace(land_cmd=mission.land_cmd | (t > 4000))
        mission, sp, motors_on = scenario.mission_step(cfg, mission, plant.pos, plant.vel, 0.001)
        u, ctrl = fc.backstepping_step(gains, VEH, ctrl, sp, pos=plant.pos, vel_world=plant.vel,
                                       rpy=cl.rpy_of(plant), omega_body=plant.omega, dt=0.001)
        plant = mr.step(VEH, plant, fc.allocate(VEH, u) * motors_on, 0.001)
        z.append(plant.pos[2])
        phases.append(mission.phase)
        gear.append(mission.gear)
    z, phases, gear = N(torch.stack(z)), N(torch.stack(phases)), N(torch.stack(gear))
    assert scenario.CRUISE in phases
    cruise_idx = np.where(phases == scenario.CRUISE)[0]
    assert z[cruise_idx].max() > 1.95
    assert gear[cruise_idx[-1]] < 0.1
    assert int(mission.phase) == scenario.LANDED
    assert z[-1] < 0.6
    assert float(plant.rotor_speed.max()) < 1.0


def test_gripper_payload_attach():
    cfg = scenario.MissionConfig()
    m = scenario.init_mission()._replace(gripper_cmd=torch.ones(()))
    pos, vel = torch.tensor([0.0, 0.0, 2.1]), torch.zeros(3)
    for _ in range(40):
        m, _, _ = scenario.mission_step(cfg, m, pos, vel, 0.01)
    assert bool(m.payload_attached)
    assert float(scenario.payload_mass(cfg, m)) == cfg.payload_mass


def imu_quiet(**kw):
    return sensors.ImuParams(**{**dict(gyro_random_walk=0.0, gyro_turn_on_bias_sigma=0.0,
                                       accel_random_walk=0.0, accel_turn_on_bias_sigma=0.0), **kw})


def test_imu_zero_noise_is_passthrough():  # tests/test_sensors_metrics.py
    p = imu_quiet(gyro_noise_density=0.0, accel_noise_density=0.0)
    seed = sampling.philox_keys(0, "cpu")
    st = sensors.init_imu(p, seed=seed, step=torch.tensor([0]))
    accel, gyro = torch.tensor([0.1, -0.2, 9.8]), torch.tensor([0.01, 0.0, -0.02])
    a, g, _ = sensors.imu_measure(p, st, accel, gyro, 0.001, seed=seed, step=torch.tensor([1]))
    np.testing.assert_allclose(N(a), N(accel), atol=1e-7)
    np.testing.assert_allclose(N(g), N(gyro), atol=1e-7)


def test_imu_noise_statistics():
    p, dt = imu_quiet(), 0.001
    seed = sampling.philox_keys(2, "cpu")
    st = sensors.init_imu(p, noise=torch.zeros(6))
    z = sensors.normals(12 * 2000, seed, torch.tensor([0])).reshape(2000, 12)
    a_s, g_s = [], []
    for i in range(2000):
        a, g, _ = sensors.imu_measure(p, st, torch.zeros(3), torch.zeros(3), dt, noise=z[i])
        a_s.append(N(a))
        g_s.append(N(g))
    np.testing.assert_allclose(np.std(a_s), p.accel_noise_density / np.sqrt(dt), rtol=0.1)
    np.testing.assert_allclose(np.std(g_s), p.gyro_noise_density / np.sqrt(dt), rtol=0.1)


def test_imu_bias_random_walk_accumulates():
    p, seed = sensors.ImuParams(), sampling.philox_keys(0, "cpu")
    st = sensors.init_imu(p, seed=seed, step=torch.tensor([0]))
    for i in range(50):
        _, _, st = sensors.imu_measure(p, st, torch.zeros(3), torch.zeros(3), 0.01, seed=seed,
                                       step=torch.tensor([i + 10]))
    assert float(torch.linalg.norm(st.accel_bias)) > 0.0


def test_odometry_delay_queue():
    p = sensors.OdometryParams(delay_steps=3)
    st = sensors.init_odometry(p, torch.zeros(3))
    outs = []
    for t in range(8):
        truth = torch.full((3,), float(t))
        meas, st = sensors.odometry_measure(p, st, truth, truth, truth, truth)
        outs.append(float(meas[0][0]))
    assert outs[:4] == [0.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(outs[4:], [1.0, 2.0, 3.0, 4.0])


def test_odometry_zero_delay_passthrough():
    p = sensors.OdometryParams()
    truth = torch.tensor([1.0, 2.0, 3.0])
    meas, _ = sensors.odometry_measure(p, sensors.init_odometry(p, torch.zeros(3)), truth, truth,
                                       truth, truth)
    np.testing.assert_allclose(N(meas[0]), N(truth))


def test_gps_noise_statistics():  # tests/test_aux_sensors.py
    p = sensors.GpsParams(horizontal_noise=0.5, vertical_noise=1.0)
    pos = torch.tensor([10.0, -5.0, 100.0])
    z = sensors.normals(3 * 2000, sampling.philox_keys(0, "cpu"), torch.tensor([0]))
    fixes = N(torch.stack([sensors.gps_measure(p, pos, noise=zi) for zi in z.reshape(2000, 3)]))
    np.testing.assert_allclose(fixes.mean(axis=0), N(pos), atol=0.1)
    assert abs(fixes[:, 0].std() - 0.5) < 0.05
    assert abs(fixes[:, 2].std() - 1.0) < 0.1


def test_barometer_altitude_roundtrip():
    p = sensors.BarometerParams()
    for alt in [0.0, 2.1, 100.0]:
        pres, alt_meas = sensors.barometer_measure(p, torch.tensor(alt), noise=torch.zeros(1))
        np.testing.assert_allclose(float(alt_meas), alt, atol=1e-3)
        assert float(pres) <= p.p0 + 1e-6


def test_magnetometer_rotates_reference_field():
    from scipy.spatial.transform import Rotation as R

    p = sensors.MagnetometerParams()
    r = torch.tensor(R.from_euler("z", np.pi / 2).as_matrix(), dtype=torch.float32)
    h = N(sensors.magnetometer_measure(p, r, noise=torch.zeros(3)))
    want = R.from_euler("z", np.pi / 2).as_matrix().T @ np.asarray(p.ref_field)
    np.testing.assert_allclose(h, want, atol=1e-6)


def test_optical_flow_model():
    p = sensors.OpticalFlowParams(noise=0.0)
    flow = sensors.optical_flow_measure(p, torch.tensor([1.0, -0.5, 0.0]),
                                        torch.tensor([0.1, 0.2, 0.0]), torch.tensor(2.0),
                                        noise=torch.zeros(2))
    np.testing.assert_allclose(N(flow), [0.3, -0.15], atol=1e-6)
    flow2 = sensors.optical_flow_measure(p, torch.tensor([10.0, 0.0, 0.0]), torch.zeros(3),
                                         torch.tensor(0.01), noise=torch.zeros(2))
    assert float(flow2[0]) == p.max_flow


def test_roll_pitch_yawrate_thrust_controller():  # tests/test_plant.py:91
    s = hover_plant(VEH, (0.0, 0.0, 2.0))
    thrust = torch.tensor(VEH.mass * 9.81 / np.cos(0.1), dtype=torch.float32)
    for _ in range(2000):
        rpy = cl.rpy_of(s)
        u = fc.roll_pitch_yawrate_thrust_step(VEH, torch.tensor(0.1), torch.tensor(0.0),
                                              torch.tensor(0.0), thrust, rpy, s.omega)
        s = mr.step(VEH, s, fc.allocate(VEH, u), 0.001)
    assert abs(float(rpy[0]) - 0.1) < 0.02, f"roll {float(rpy[0]):.3f}"
