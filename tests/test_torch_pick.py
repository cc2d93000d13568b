"""The port's pick_weight pieces against the JAX package's, on the CPU.

Cases: ``graspable_step`` and the contact layer (``sim/contact``) against
the JAX functions at 1e-5 relative to the largest force or state entry;
the end effector's closed-form velocity and Jacobian against ``jax.jvp`` and
``jax.jacfwd`` of the FK; short whole-body episodes (position mode, K=96,
H=16) with a grasped payload (on the per-substep RNEA plant and on the
serving configuration, the plant tick's plain version), with the graspable
object pushed by the palm, and with arm-link contact, each against the
jitted JAX episode on the JAX key chain's draws at 5e-3, the tolerance of
``tests/test_whole_body_loop.py``'s payload case; and a B=2 fleet with the
object against ``jax.vmap`` of the JAX episode.  Then the JAX package's own
tests of the object and the contact layer (``tests/test_graspable.py``,
``tests/test_contact_general.py``) on the port alone.

Each JAX episode compiles once (module-scoped fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.models import chain as jchain
from quadrotor_manipulator_mppi_tpu.models import kinova as jkinova
from quadrotor_manipulator_mppi_tpu.parallel.sharded import scenario_keys
from quadrotor_manipulator_mppi_tpu.sim import contact as jct
from quadrotor_manipulator_mppi_tpu.sim import graspable as jgr
from quadrotor_manipulator_mppi_tpu.sim import whole_body_loop as jwbl
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwbs
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu.utils.pose import Pose as JPose
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models import chain as tchain
from quadrotor_manipulator_mppi_tpu_torch.models import kinova
from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import MultirotorState
from quadrotor_manipulator_mppi_tpu_torch.sim import contact as ct
from quadrotor_manipulator_mppi_tpu_torch.sim import graspable as gr
from quadrotor_manipulator_mppi_tpu_torch.sim import whole_body_loop as wbl
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twbs
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose

from torch_parity import N, T, shared_z, to_port, torch_one_thread  # noqa: F401

TOL_FORCE = 1e-5   # relative to the largest entry of the JAX result
TOL_EPISODE = 5e-3
SPEC = kinova.chain("link_7")
JSPEC = jkinova.chain("link_7")
K, H = 96, 16


def close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def to_port_cfg(jax_cfg):
    return convert.config_from_dict(jcfg.to_dict(jax_cfg))


def home_ee():
    """The hover start's end-effector position (base at (0, 0, 2.1))."""
    p, _ = jchain.forward_kinematics_posquat(JSPEC, jnp.asarray(jkinova.Q_HOME, jnp.float32),
                                             base_pos=jnp.asarray([0.0, 0.0, 2.1]),
                                             base_quat=jnp.asarray([1.0, 0.0, 0.0, 0.0]))
    return np.asarray(p, np.float64)


# ---------------------------------------------------------------------------
# graspable_step and the contact layer against the JAX functions
# ---------------------------------------------------------------------------

GP = dict(stand_center_xy=(1.0, 0.5), stand_top_z=1.2)


@pytest.mark.parametrize("case", ["rest", "push", "attach", "fall"])
def test_graspable_step_matches_jax(case):
    jp, tp = jgr.GraspableParams(**GP), to_port_cfg(jgr.GraspableParams(**GP))
    assert isinstance(tp, gr.GraspableParams)
    js = jgr.init_graspable(jp)
    if case == "fall":
        js = jgr.init_graspable(jp, pos=(1.0 + jp.stand_radius + 0.1, 0.5, 1.2 + jp.radius))
    ee = {"rest": [10.0, 10.0, 10.0], "push": np.asarray(js.pos) + [-0.06, 0.0, 0.01],
          "attach": np.asarray(js.pos) + [0.0, 0.0, 0.03], "fall": [10.0, 10.0, 10.0]}[case]
    ee = np.asarray(ee, np.float32)
    ev = np.asarray([0.2, 0.0, -0.05], np.float32)
    jstep = jax.jit(lambda st, closed: jgr.graspable_step(jp, st, jnp.asarray(ee),
                                                          jnp.asarray(ev), closed, 0.01))
    s = convert.graspable_state_from_numpy(js.pos, js.vel, js.attached, device="cpu")
    for i in range(40):
        closed = case == "attach" and i >= 20 or case == "push" and i % 2 == 1
        js, jr = jstep(js, jnp.asarray(closed))
        s, r = gr.graspable_step(tp, s, T(ee), T(ev), closed, 0.01)
        close(s.pos, js.pos, TOL_FORCE, f"{case} step {i}: pos")
        close(s.vel, js.vel, TOL_FORCE, f"{case} step {i}: vel")
        close(r, jr, TOL_FORCE, f"{case} step {i}: reaction")
        assert bool(s.attached) == bool(js.attached)
    assert bool(s.attached) == (case == "attach")


def test_graspable_step_tensor_gripper_and_batch():
    """A bool-tensor gripper command and a batch of objects step as their
    unbatched Python-bool counterparts."""
    tp = gr.GraspableParams(**GP)
    s0 = gr.init_graspable(tp, device="cpu")
    ee = torch.stack([s0.pos + torch.tensor([-0.06, 0.0, 0.0]), s0.pos])
    sb = gr.GraspableState(*(x.expand(2, *x.shape).clone() for x in s0))
    closed = torch.tensor([False, True])
    sb, rb = gr.graspable_step(tp, sb, ee, torch.zeros(2, 3), closed, 0.01)
    for b in range(2):
        s1, r1 = gr.graspable_step(tp, s0, ee[b], torch.zeros(3), bool(closed[b]), 0.01)
        assert torch.equal(sb.pos[b], s1.pos) and torch.equal(rb[b], r1)
        assert bool(sb.attached[b]) == bool(s1.attached)


WORLD = dict(ground_z=0.0, spheres=((0.1, 0.3, 0.0, 0.4),), discs=((0.0, 0.2, 0.2, 0.5),),
             cylinders=((0.1, 0.0, -1.0, 1.0, 0.3),))


def test_sphere_world_force_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.uniform([-0.6, -0.4, -0.1], [0.6, 0.8, 0.7], (256, 3)).astype(np.float32)
    v = rng.normal(size=(256, 3)).astype(np.float32)
    jp = jct.ContactParams(world=jct.WorldPrimitives(**WORLD))
    tp = to_port_cfg(jp)
    assert isinstance(tp, ct.ContactParams) and tp.world.cylinders == jp.world.cylinders
    for radius in (0.05, 0.35):
        want = jct.sphere_world_force(jp, jnp.asarray(p), jnp.asarray(v), radius)
        close(ct.sphere_world_force(tp, T(p), T(v), radius), want, TOL_FORCE)
        assert np.abs(np.asarray(want)).max() > 10.0  # the primitives push


def _contact_state(seed):
    rng = np.random.default_rng(seed)
    q = (jkinova.Q_HOME + 0.3 * rng.normal(size=7)).astype(np.float32)
    bq = rng.normal(size=4) * [1, 0.1, 0.1, 0.3] + [1, 0, 0, 0]
    return (q, rng.normal(size=7).astype(np.float32), np.array([0.1, 0.2, 2.0], np.float32),
            (bq / np.linalg.norm(bq)).astype(np.float32), rng.normal(size=3).astype(np.float32),
            rng.normal(size=3).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_whole_body_contact_matches_jax(seed):
    """World spheres just under the elbow, wrist and end-effector spheres,
    the base moving and turning, the arm moving: forces, moments and joint
    torques against ``jax.jvp``/``jax.jacfwd`` of the JAX layer."""
    state = _contact_state(seed)
    q, _, bp, bq = state[:4]
    pts = np.asarray(jax.jit(lambda qq: jchain.link_positions_posquat(
        JSPEC, qq, np.zeros((7, 3))))(jnp.asarray(q)))
    pw = bp + pts @ np.asarray(jrot.quat_to_matrix(jnp.asarray(bq))).T
    world = dict(has_ground=False, spheres=tuple(
        (float(p[0]), float(p[1]), float(p[2]) - 0.05, 0.1) for p in pw[[3, 5, 6]]))
    jp = jct.ContactParams(world=jct.WorldPrimitives(**world))
    want = jax.jit(lambda *x: jct.whole_body_contact(jp, JSPEC, *x))(*map(jnp.asarray, state))
    got = ct.whole_body_contact(to_port_cfg(jp), SPEC, *map(T, state))
    for name, a, b in zip(("f_base", "tau_base", "tau_arm"), got, want):
        close(a, b, TOL_FORCE, name)
        assert np.abs(np.asarray(b)).max() > 1.0, name


def test_ee_motion_matches_jax_jvp():
    """The end effector's velocity and position Jacobian in closed form
    against the JAX episode's ``jax.jvp`` and ``jax.jacfwd`` of its FK."""
    q, qd, bp, bq, bv, om = _contact_state(2)

    def fk(qq, p, quat):
        return jchain.forward_kinematics_posquat(JSPEC, qq, base_pos=p, base_quat=quat)[0]

    @jax.jit
    def tangent(q, qd, bp, bq, bv, om):
        quat_dot = 0.5 * jrot.quat_multiply(bq, jnp.concatenate([jnp.zeros(1), om]))
        p, v = jax.jvp(fk, (q, bp, bq), (qd, bv, quat_dot))
        return p, v, jax.jacfwd(lambda qq: fk(qq, bp, bq))(q)

    p, v, jac = tangent(*map(jnp.asarray, (q, qd, bp, bq, bv, om)))
    base = MultirotorState(pos=T(bp), quat=T(bq), vel=T(bv), omega=T(om),
                                  rotor_speed=torch.zeros(8))
    plant = wbl.WholeBodyPlant(base=base, q=T(q), qdot=T(qd), ctrl=None)
    ee, vel, j_ee = wbl.ee_motion(SPEC, plant)
    close(ee, p, 1e-6, "position")
    close(vel, v, 1e-5, "velocity")
    close(j_ee, jac, 1e-5, "jacobian")


# ---------------------------------------------------------------------------
# Whole-body episodes against the JAX episode
# ---------------------------------------------------------------------------

def _payload_params(jp):
    return dataclasses.replace(jp, model=dataclasses.replace(
        jp.model, arm_mass_lump=jp.model.arm_mass_lump + 0.5))


def _obj_start():
    return tuple(home_ee() + [0.0, 0.0, -0.025])  # in palm contact (open: onset at 0.04 m)


def _contact():
    ee = home_ee()
    return dict(world=dict(spheres=((float(ee[0]), float(ee[1]), float(ee[2]) - 0.1, 0.08),)))


# name: (payload, port loop config, JAX loop config, graspable and contact)
EPISODES = {
    # The lift's plant on the serving configuration: the payload in the
    # frozen coefficients (the plant tick's plain version on the port side,
    # the XLA substeps on the JAX side).
    "payload_serving": (True, dict(arm_coeffs_per_control=True, plant_kernel=True),
                        dict(arm_coeffs_per_control=True), False),
    # The per-substep RNEA plant with every branch: the payload, the object
    # in palm contact, an arm-link sphere in contact with a world sphere.
    "payload_graspable_contact": (True, {}, {}, True),
}
N_STEPS = 20


def _episode_args(with_object):
    if not with_object:
        return {}
    c = _contact()
    return {"graspable": jgr.GraspableParams(stand_center_xy=tuple(_obj_start()[:2]),
                                             stand_top_z=_obj_start()[2] - 0.04),
            "contact": jct.ContactParams(world=jct.WorldPrimitives(**c["world"]))}


@pytest.fixture(scope="module", params=sorted(EPISODES))
def episodes(request):
    payload, loop, jloop, with_object = EPISODES[request.param]
    n = N_STEPS
    jp = jwbs.position_mode_params(n_samples=K, n_horizon=H)
    if payload:
        jp = _payload_params(jp)
        pay = dict(payload_mass=0.5, plant_arm_lump=5.54)
        loop, jloop = dict(loop, **pay), dict(jloop, **pay)
    kw = _episode_args(with_object)
    jrun = jwbl.make_whole_body_episode(jp, cfg=jwbl.WholeBodyLoopConfig(**jloop),
                                        n_control_steps=n, low_k_guard="off", **kw)
    _, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    jobs, js = jwbs.default_obs(), jinit(jax.random.key(0))
    jargs = [jwbl.init_plant(jp.model.vehicle), js, jobs.ee_target, jobs.base_target]
    if with_object:
        jargs.append(jgr.init_graspable(kw["graspable"], pos=_obj_start()))
    jfinal, jlogs = jax.jit(jrun)(*jargs)
    key, zs = js.key, []
    for _ in range(n):
        key, z = shared_z(key, K, H)
        zs.append(z)

    tp = to_port(jp)
    tkw = {name: to_port_cfg(v) for name, v in kw.items()}
    run = wbl.make_whole_body_episode(tp, cfg=wbl.WholeBodyLoopConfig(**loop), n_control_steps=n,
                                      low_k_guard="off", device="cpu", **tkw)
    _, init = twbs.make_whole_body_solver(tp, device="cpu", low_k_guard="off")
    obs = twbs.default_obs(device="cpu")
    args = [wbl.init_plant(tp.model.vehicle, device="cpu"), init(0), obs.ee_target,
            obs.base_target]
    if with_object:
        args.append(gr.init_graspable(tkw["graspable"], pos=_obj_start(), device="cpu"))
    with torch.inference_mode():
        final, logs = run(*args, z=T(np.stack(zs)))
    return request.param, (jfinal, jlogs), (final, logs)


def test_pick_episode_matches_jax(episodes):
    name, (jfinal, jlogs), (final, logs) = episodes
    assert all(bool(torch.isfinite(f).all()) for f in logs)
    for field in ("ee_err", "l1_cmd", "l1_meas", "tilt", "base_pos", "obj_pos"):
        np.testing.assert_allclose(N(getattr(logs, field)), np.asarray(getattr(jlogs, field)),
                                   atol=TOL_EPISODE, err_msg=f"{name}: {field}")
    np.testing.assert_allclose(N(final[0].base.pos), np.asarray(jfinal[0].base.pos),
                               atol=TOL_EPISODE, err_msg=name)
    np.testing.assert_allclose(N(final[0].q), np.asarray(jfinal[0].q), atol=TOL_EPISODE,
                               err_msg=name)
    if EPISODES[name][3]:
        np.testing.assert_allclose(N(final[4].pos), np.asarray(jfinal[4].pos), atol=TOL_EPISODE)
        # The palm pushed the object: its track moved off the start.
        assert np.abs(np.asarray(jlogs.obj_pos)[-1] - _obj_start()).max() > 1e-3


def test_payload_changes_the_plant():
    """The grasped payload reaches the plant: link 7's mass and centre of
    mass (the frozen coefficients' inertials too) and the base's mass."""
    inr = kinova.inertials()
    heavy = wbl.payload_inertials(inr, 0.5)
    assert heavy.mass[-1] == inr.mass[-1] + 0.5
    np.testing.assert_allclose(heavy.com[-1], inr.com[-1] * inr.mass[-1] / (inr.mass[-1] + 0.5))
    assert np.array_equal(heavy.mass[:-1], inr.mass[:-1])
    assert wbl.payload_inertials(inr, 0.0) is inr


@pytest.fixture(scope="module")
def fleet():
    """B=2 vehicles with an object each (one in palm contact, one far),
    against jax.vmap of the JAX episode, 10 steps at K=64."""
    b, n, k = 2, 10, 64
    jp = jwbs.position_mode_params(n_samples=k, n_horizon=H)
    gp = jgr.GraspableParams(stand_center_xy=tuple(_obj_start()[:2]),
                             stand_top_z=_obj_start()[2] - 0.04)
    objs = np.stack([_obj_start(), np.asarray(_obj_start()) + [0.5, 0.5, 0.0]]).astype(np.float32)
    jrun = jwbl.make_whole_body_episode(jp, n_control_steps=n, low_k_guard="off", graspable=gp)
    _, jinit = jwbs.make_whole_body_solver(jp, low_k_guard="off")
    jobs = jwbs.default_obs()
    jplants = jax.vmap(lambda _: jwbl.init_plant(jp.model.vehicle))(jnp.arange(b))
    jsolvers = jax.vmap(jinit)(scenario_keys(jax.random.key(0), b))
    jtargets = JPose(position=jnp.broadcast_to(jobs.ee_target.position, (b, 3)),
                     quat=jnp.broadcast_to(jobs.ee_target.quat, (b, 4)))
    jbase = jnp.broadcast_to(jobs.base_target, (b, 3))
    jobj = jax.vmap(lambda p: jgr.init_graspable(gp, pos=p))(jnp.asarray(objs))
    jfinal, jlogs = jax.jit(jax.vmap(jrun))(jplants, jsolvers, jtargets, jbase, jobj)
    z = np.zeros((n, b, k, H, 11), np.float32)
    for s in range(b):
        key = jsolvers.key[s]
        for i in range(n):
            key, z[i, s] = shared_z(key, k, H)

    tp = to_port(jp)
    run = wbl.make_whole_body_episode(tp, n_control_steps=n, low_k_guard="off", device="cpu",
                                      n_scenarios=b, graspable=to_port_cfg(gp))
    _, init = twbs.make_whole_body_solver(tp, device="cpu", low_k_guard="off", n_scenarios=b)
    obs = twbs.default_obs(device="cpu")
    plants = wbl.init_plant(tp.model.vehicle, pos=np.tile([0.0, 0.0, 2.1], (b, 1)), device="cpu")
    targets = Pose(obs.ee_target.position.expand(b, 3).clone(),
                   obs.ee_target.quat.expand(b, 4).clone())
    with torch.inference_mode():
        final, logs = run(plants, init(0), targets, obs.base_target.expand(b, 3).clone(),
                          gr.init_graspable(to_port_cfg(gp), pos=objs, device="cpu"), z=T(z))
    return (jfinal, jlogs), (final, logs)


def test_fleet_with_graspable_matches_jax_vmap(fleet):
    (jfinal, jlogs), (final, logs) = fleet
    assert logs.obj_pos.shape == (2, 10, 3)
    for field in ("ee_err", "base_pos", "obj_pos", "tilt"):
        np.testing.assert_allclose(N(getattr(logs, field)), np.asarray(getattr(jlogs, field)),
                                   atol=TOL_EPISODE, err_msg=field)
    np.testing.assert_allclose(N(final[4].pos), np.asarray(jfinal[4].pos), atol=TOL_EPISODE)
    assert N(final[4].attached).tolist() == np.asarray(jfinal[4].attached).tolist()


# ---------------------------------------------------------------------------
# The JAX package's graspable tests (tests/test_graspable.py) on the port
# ---------------------------------------------------------------------------

PARAMS = gr.GraspableParams(stand_center_xy=(1.0, 0.5), stand_top_z=1.2)
FAR = torch.tensor([10.0, 10.0, 10.0])
ZERO3 = torch.zeros(3)


def _roll(params, state, ee_pos, ee_vel, closed, n, dt=0.01):
    reaction = None
    for _ in range(n):
        state, reaction = gr.graspable_step(params, state, ee_pos, ee_vel, closed, dt)
    return state, reaction


def test_rests_on_stand():
    s0 = gr.init_graspable(PARAMS, device="cpu")
    s, _ = _roll(PARAMS, s0, FAR, ZERO3, False, 200)
    sag = PARAMS.mass * gr.GRAVITY / PARAMS.stiffness
    assert abs(float(s.pos[2]) - float(s0.pos[2])) < 3 * sag + 1e-3
    assert float(torch.linalg.norm(s.pos[:2] - s0.pos[:2])) < 1e-3
    assert not bool(s.attached)


def test_falls_off_support_to_ground():
    s0 = gr.init_graspable(PARAMS, pos=(1.0 + PARAMS.stand_radius + 0.1, 0.5,
                                        1.2 + PARAMS.radius), device="cpu")
    s, _ = _roll(PARAMS, s0, FAR, ZERO3, False, 300)
    assert float(s.pos[2]) < PARAMS.ground_z + PARAMS.radius + 0.02
    assert abs(float(s.vel[2])) < 0.05


def test_ee_push_moves_object_and_reacts():
    s0 = gr.init_graspable(PARAMS, device="cpu")
    ee = s0.pos + torch.tensor([-(PARAMS.radius + PARAMS.ee_radius) * 0.6, 0.0, 0.0])
    s, reaction = _roll(PARAMS, s0, ee, torch.tensor([0.2, 0.0, 0.0]), True, 1)
    assert float(s.pos[0]) > float(s0.pos[0]) + 1e-4
    assert float(reaction[0]) < 0.0
    assert not bool(s.attached)


def test_open_gripper_straddles_to_grasp_tolerance():
    assert PARAMS.radius + PARAMS.ee_radius_open < PARAMS.grasp_tol
    s0 = gr.init_graspable(PARAMS, device="cpu")
    ee = s0.pos + torch.tensor([0.0, 0.0, PARAMS.radius + PARAMS.ee_radius_open + 0.005])
    s, reaction = _roll(PARAMS, s0, ee, ZERO3, False, 100)
    assert float(torch.linalg.norm(s.pos - ee)) < PARAMS.grasp_tol
    assert float(torch.linalg.norm(s.pos[:2] - s0.pos[:2])) < 1e-3
    np.testing.assert_allclose(N(reaction), 0.0, atol=1e-6)
    s, _ = _roll(PARAMS, s, ee, ZERO3, True, 1)
    assert bool(s.attached)


def test_gripper_open_near_object_does_not_attach():
    s0 = gr.init_graspable(PARAMS, device="cpu")
    s, _ = _roll(PARAMS, s0, s0.pos, ZERO3, False, 3)
    assert not bool(s.attached)


def test_attach_follows_ee():
    s0 = gr.init_graspable(PARAMS, device="cpu")
    s, reaction = _roll(PARAMS, s0, s0.pos, ZERO3, True, 1)
    assert bool(s.attached)
    ee2 = s0.pos + torch.tensor([0.3, -0.2, 0.5])
    s, reaction = _roll(PARAMS, s, ee2, ZERO3, True, 1)
    np.testing.assert_allclose(N(s.pos), N(ee2), atol=1e-6)
    np.testing.assert_allclose(N(reaction), 0.0, atol=1e-9)


def test_episode_with_free_body_object():
    """The object stays on its stand while the vehicle holds position (the
    end effector nowhere near it), and the log carries its track."""
    params = twbs.position_mode_params(n_samples=32, n_horizon=20)
    obs0 = twbs.default_obs(device="cpu")
    gp = gr.GraspableParams(stand_center_xy=(5.0, 5.0), stand_top_z=1.0)
    run = wbl.make_whole_body_episode(params, n_control_steps=10, graspable=gp, device="cpu")
    _, init = twbs.make_whole_body_solver(params, device="cpu")
    obj = gr.init_graspable(gp, device="cpu")
    (_, _, _, _, obj_f), log = run(wbl.init_plant(params.model.vehicle, device="cpu"), init(0),
                                   obs0.ee_target, obs0.base_target, obj)
    assert log.obj_pos.shape == (10, 3)
    assert float(torch.linalg.norm(obj_f.pos[:2] - obj.pos[:2])) < 1e-3
    assert not bool(obj_f.attached)


# ---------------------------------------------------------------------------
# The JAX package's contact tests (tests/test_contact_general.py) on the port
# ---------------------------------------------------------------------------

def _f(p, v, radius=0.05, world=None, **kw):
    cp = ct.ContactParams(world=world or ct.WorldPrimitives(), **kw)
    return N(ct.sphere_world_force(cp, torch.tensor(p, dtype=torch.float32),
                                   torch.tensor(v, dtype=torch.float32), radius))


def test_ground_plane_force():
    out = _f([0.0, 0.0, 0.03], [0.0, 0.0, 0.0])
    assert out[2] > 0 and abs(out[0]) < 1e-6
    np.testing.assert_allclose(out[2], 3000.0 * 0.02, rtol=1e-5)
    np.testing.assert_allclose(_f([0, 0, 0.2], [0, 0, 0]), 0.0)
    assert _f([0.0, 0.0, 0.03], [0.5, 0.0, 0.0])[0] < 0


def test_world_sphere_and_cylinder_and_disc():
    w = ct.WorldPrimitives(has_ground=False, spheres=((1.0, 0.0, 1.0, 0.2),),
                           cylinders=((0.0, 2.0, 0.0, 1.5, 0.1),), discs=((3.0, 0.0, 1.0, 0.3),))
    out = _f([1.22, 0.0, 1.0], [0, 0, 0], world=w)
    assert out[0] > 0 and abs(out[1]) < 1e-6
    assert _f([0.12, 2.0, 0.7], [0, 0, 0], world=w)[0] > 0
    np.testing.assert_allclose(_f([0.12, 2.0, 2.0], [0, 0, 0], world=w), 0.0)
    assert _f([3.0, 0.0, 1.03], [0, 0, 0], world=w)[2] > 0
    np.testing.assert_allclose(_f([3.5, 0.0, 1.03], [0, 0, 0], world=w), 0.0)


def test_whole_body_contact_arm_feels_the_stand():
    q = torch.tensor(kinova.Q_HOME, dtype=torch.float32)
    base_pos, base_quat = torch.tensor([0.0, 0.0, 2.1]), torch.tensor([1.0, 0.0, 0.0, 0.0])
    ee, _ = tchain.forward_kinematics_posquat(SPEC, q, base_pos=base_pos, base_quat=base_quat)
    cp = ct.ContactParams(world=ct.WorldPrimitives(
        has_ground=False, spheres=((float(ee[0]), float(ee[1]), float(ee[2]) - 0.05, 0.1),)),
        link_spheres=((6, 0.05),))
    f_b, tau_b, tau_arm = ct.whole_body_contact(cp, SPEC, q, torch.zeros(7), base_pos, base_quat,
                                                torch.zeros(3), torch.zeros(3))
    assert float(torch.linalg.norm(tau_arm)) > 0.1, "arm feels nothing"
    assert float(torch.linalg.norm(f_b)) > 1.0, "base feels nothing"
    assert float(torch.linalg.norm(tau_b)) > 0.01, "no moment about the base"
    assert float(f_b[2]) > 0


def test_hull_ground_contact_supports_vehicle():
    f_b, _, tau_arm = ct.whole_body_contact(
        ct.ContactParams(link_spheres=()), SPEC, torch.tensor(kinova.Q_HOME, dtype=torch.float32),
        torch.zeros(7), torch.tensor([0.0, 0.0, 0.3]), torch.tensor([1.0, 0.0, 0.0, 0.0]),
        torch.zeros(3), torch.zeros(3))
    assert float(f_b[2]) > 0
    np.testing.assert_allclose(N(tau_arm), 0.0)


@pytest.mark.slow
def test_closed_loop_stand_no_passthrough_and_avoidance():
    """(a) without the obstacle cost, an EE target inside a stand column
    does not pass through it (the contact layer holds the EE near the
    column's surface); (b) with the obstacle cost the loop keeps clear and
    no contact force acts at the end.  Slow, as the JAX package's own."""
    params = twbs.position_mode_params(n_samples=128, n_horizon=30)
    obs0 = twbs.default_obs(device="cpu")
    tgt = N(obs0.ee_target.position).astype(np.float64)
    col_r = 0.12
    cp = ct.ContactParams(world=ct.WorldPrimitives(
        ground_z=0.0, cylinders=((float(tgt[0]), float(tgt[1]), 0.0, float(tgt[2]) + 0.5,
                                  col_r),)))

    def run(with_obstacle_cost):
        p = params
        if with_obstacle_cost:
            p = dataclasses.replace(p, cost=dataclasses.replace(
                p.cost, obstacle_weight=200.0, obstacle_centers=(tuple(map(float, tgt)),),
                obstacle_radii=(col_r + 0.1,)))
        ep = wbl.make_whole_body_episode(p, n_control_steps=250, contact=cp, device="cpu")
        _, init = twbs.make_whole_body_solver(p, device="cpu")
        with torch.inference_mode():
            final, logs = ep(wbl.init_plant(p.model.vehicle, device="cpu"), init(0),
                             obs0.ee_target, obs0.base_target)
        ee, _ = tchain.forward_kinematics_posquat(SPEC, final[0].q, base_pos=final[0].base.pos,
                                                  base_quat=final[0].base.quat)
        return final[0], logs, float(np.linalg.norm(N(ee)[:2] - tgt[:2]))

    _, logs_a, standoff_a = run(False)
    assert np.all(np.isfinite(N(logs_a.ee_err)))
    assert standoff_a > col_r - 0.07, f"passed through the stand: {standoff_a:.3f} m"
    plant_b, _, _ = run(True)
    f_b, _, tau_arm = ct.whole_body_contact(cp, SPEC, plant_b.q, plant_b.qdot, plant_b.base.pos,
                                            plant_b.base.quat, plant_b.base.vel,
                                            plant_b.base.omega)
    np.testing.assert_allclose(N(f_b), 0.0, atol=1e-5)
    np.testing.assert_allclose(N(tau_arm), 0.0, atol=1e-5)


def test_contact_wrench_survives_graspable_branch():
    """With both the contact layer and an object far away (no reaction),
    the base track equals the contact-only episode's."""
    params = twbs.position_mode_params(n_samples=64, n_horizon=16)
    obs0 = twbs.default_obs(device="cpu")
    cp, gp = ct.ContactParams(), gr.GraspableParams()
    far = gr.init_graspable(gp, pos=(100.0, 100.0, 50.0), device="cpu")
    _, init = twbs.make_whole_body_solver(params, device="cpu")

    def run(graspable, obj):
        ep = wbl.make_whole_body_episode(params, n_control_steps=40, contact=cp,
                                         graspable=graspable, device="cpu")
        args = [wbl.init_plant(params.model.vehicle, device="cpu"), init(0), obs0.ee_target,
                obs0.base_target] + ([obj] if graspable is not None else [])
        with torch.inference_mode():
            return N(ep(*args)[1].base_pos)

    np.testing.assert_allclose(run(gp, far), run(None, None), atol=1e-5)
