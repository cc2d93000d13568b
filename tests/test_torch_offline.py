"""The port's offline tools against the JAX package, on the CPU: profiling
(``utils/profiling``), the rosbag reader and ``parity compare`` on a
``.bag`` (``evaluation/rosbag``, ``evaluation/parity``), dataset collection
(``evaluation/dataset``), the URDF loader with the matrix FK
(``models/urdf``, ``models/chain``), and the helpers this slice adds
(rotations, pose errors, sampling, costs, the scan rollout, the arm's
gravity wrench).  Inputs come from a numpy seed; the JAX functions run on
the CPU; the Kinova URDF is built inline (``tests/kinova_urdf.py``).
"""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R

from quadrotor_manipulator_mppi_tpu.evaluation import dataset as jds
from quadrotor_manipulator_mppi_tpu.evaluation import parity as jparity
from quadrotor_manipulator_mppi_tpu.evaluation import rosbag as jbag
from quadrotor_manipulator_mppi_tpu.models import chain as jchain
from quadrotor_manipulator_mppi_tpu.models import kinova as jkinova
from quadrotor_manipulator_mppi_tpu.models import urdf as jurdf
from quadrotor_manipulator_mppi_tpu.models import whole_body as jwbm
from quadrotor_manipulator_mppi_tpu.ops import costs as jcosts
from quadrotor_manipulator_mppi_tpu.ops import integrators as jint
from quadrotor_manipulator_mppi_tpu.ops import sampling as jsampling
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu.solver.mppi import MPPIConfig as JMPPIConfig
from quadrotor_manipulator_mppi_tpu.utils import pose as jpose
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu.utils import se3 as jse3
from quadrotor_manipulator_mppi_tpu_torch.evaluation import dataset as tds
from quadrotor_manipulator_mppi_tpu_torch.evaluation import parity as tparity
from quadrotor_manipulator_mppi_tpu_torch.evaluation import rosbag as tbag
from quadrotor_manipulator_mppi_tpu_torch.models import chain as tchain
from quadrotor_manipulator_mppi_tpu_torch.models import kinova as tkinova
from quadrotor_manipulator_mppi_tpu_torch.models import urdf as turdf
from quadrotor_manipulator_mppi_tpu_torch.models import whole_body as twbm
from quadrotor_manipulator_mppi_tpu_torch.ops import costs as tcosts
from quadrotor_manipulator_mppi_tpu_torch.ops import integrators as tint
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling as tsampling
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb
from quadrotor_manipulator_mppi_tpu_torch.utils import pose as tpose
from quadrotor_manipulator_mppi_tpu_torch.utils import profiling
from quadrotor_manipulator_mppi_tpu_torch.utils import rotations as trot
from quadrotor_manipulator_mppi_tpu_torch.utils import se3 as tse3

from kinova_urdf import LINK_7, ROOT, TIP, kinova_urdf_text
from test_kinematics import fk_oracle
from test_rosbag import _connection, _joint_state, _message, _odometry, _ros_header, _write_bag
from torch_parity import N, T, obs_to_port, shared_z, to_port, torch_one_thread  # noqa: F401

TOL = 1e-5


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Profiling (tests/test_profiling.py on the port)
# ---------------------------------------------------------------------------

def test_solve_timer_stats():
    t = profiling.SolveTimer()
    for v in [0.001, 0.002, 0.003, 0.004]:
        t.record(v)
    s = t.stats()
    assert s["n"] == 4
    assert abs(s["mean_ms"] - 2.5) < 1e-6
    assert s["solves_per_s"] == 400.0
    assert s["meets_100hz_budget"] is True
    t.record(0.05)
    assert t.stats()["meets_100hz_budget"] is False
    assert profiling.SolveTimer().stats() == {}


def test_time_fn_runs():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2 + 1

    s = profiling.time_fn(f, torch.arange(128.0), iters=5, warmup=2)
    assert s["n"] == 5 and s["mean_ms"] > 0 and len(calls) == 7


def test_measure_context():
    t = profiling.SolveTimer()
    x = torch.arange(16.0)
    with t.measure(result_to_block=(x, {"y": [x]})):
        x + 1
    assert len(t.times) == 1 and t.times[0] >= 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profiling.trace(str(tmp_path), device="cuda"):
            pass


# ---------------------------------------------------------------------------
# Rosbag: the synthetic cases of tests/test_rosbag.py on both readers
# ---------------------------------------------------------------------------

def _robot_states_bag(path, compress):
    rng = np.random.default_rng(0)
    positions, velocities = rng.normal(size=(5, 14)), rng.normal(size=(5, 13))
    body = _connection(0, "/harrierD7/robot_states", "sensor_msgs/JointState")
    for i in range(5):
        body += _message(0, 10 + i, 500, _joint_state(10 + i, 500, positions[i], velocities[i]))
    _write_bag(path, body, compress)
    return positions, velocities


def _odometry_bag(path, n=8):
    t = np.linspace(0.0, 0.7, n)
    pos = np.stack([t, 2 * t, 1.0 + 0 * t], axis=1)
    body = _connection(0, "/harrierD7/odometry", "nav_msgs/Odometry")
    for i in range(n):
        body += _message(0, i, 0, _odometry(i, 0, pos[i], [0, 0, 0, 1], [1.0, 2.0, 0.0],
                                            [0, 0, 0]))
    _write_bag(path, body, compress=False)
    return pos


def _both_npz(bag, tmp_path, **kw):
    """bag_to_npz through both readers: (port summary, port arrays, JAX arrays)."""
    out_t = tbag.bag_to_npz(str(bag), str(tmp_path / "port.npz"), **kw)
    out_j = jbag.bag_to_npz(str(bag), str(tmp_path / "jax.npz"), **kw)
    a, b = dict(np.load(tmp_path / "port.npz")), dict(np.load(tmp_path / "jax.npz"))
    for k in ("topic", "msg_type", "rows", "keys"):
        assert out_t[k] == out_j[k]
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    return out_t, a


@pytest.mark.parametrize("compress", [False, True])
def test_robot_states_bag_on_both_readers(tmp_path, compress):
    bag = tmp_path / "rs.bag"
    positions, velocities = _robot_states_bag(bag, compress)
    out, d = _both_npz(bag, tmp_path)
    assert out["rows"] == 5
    np.testing.assert_allclose(d["pos"], positions[:, 0:3])
    np.testing.assert_allclose(d["quat_xyzw"], positions[:, 3:7])
    np.testing.assert_allclose(d["q"], positions[:, 7:14])
    np.testing.assert_allclose(d["vel"], velocities[:, 0:3])
    np.testing.assert_allclose(d["omega"], velocities[:, 3:6])
    np.testing.assert_allclose(d["qdot"], velocities[:, 6:13])
    np.testing.assert_allclose(d["t"], 10 + np.arange(5) + 5e-7)
    assert tbag.list_topics(str(bag)) == jbag.list_topics(str(bag))
    got, want = list(tbag.read_messages(str(bag))), list(jbag.read_messages(str(bag)))
    assert got == want and len(got) == 5


def test_odometry_bag_and_parity_compare(tmp_path):
    """Odometry on both readers, and ``parity compare ref.bag ours.npz``:
    the port's command prints what the JAX one prints."""
    bag = tmp_path / "odo.bag"
    pos = _odometry_bag(bag)
    out, d = _both_npz(bag, tmp_path)
    assert out["msg_type"] == "nav_msgs/Odometry"
    np.testing.assert_allclose(d["pos"], pos)
    np.testing.assert_allclose(d["vel"], np.tile([1.0, 2.0, 0.0], (8, 1)))
    np.savez(tmp_path / "ours.npz", pos=pos + [0.01, 0.0, 0.0])
    reports = []
    for main in (tparity.main, jparity.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["compare", str(bag), str(tmp_path / "ours.npz")])
        reports.append(buf.getvalue().strip().splitlines()[-1])
    assert reports[0] == reports[1]
    rep = json.loads(reports[0])
    assert abs(rep["rmse_m"] - 0.01) < 1e-6 and abs(rep["max_dev_m"] - 0.01) < 1e-6


def test_explicit_topic_errors_and_cli(tmp_path):
    body = _connection(0, "/x/pose", "geometry_msgs/PoseStamped")
    body += _message(0, 1, 0, _ros_header(1, 0) + np.array([1, 2, 3, 0, 0, 0, 1], "<f8").tobytes())
    bag = tmp_path / "p.bag"
    _write_bag(bag, body, compress=False)
    out, d = _both_npz(bag, tmp_path, topic="/x/pose")
    assert out["rows"] == 1 and np.array_equal(d["pos"], [[1.0, 2.0, 3.0]])
    with pytest.raises(ValueError, match="no messages"):
        tbag.bag_to_npz(str(bag), str(tmp_path / "q.npz"), topic="/nope")
    with pytest.raises(ValueError, match="not a rosbag"):
        (tmp_path / "junk.bag").write_bytes(b"hello")
        tbag.list_topics(str(tmp_path / "junk.bag"))
    printed = []
    for main in (tbag.main, jbag.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(["topics", str(bag)])
        printed.append(buf.getvalue())
    assert printed[0] == printed[1] and json.loads(printed[0]) == {
        "/x/pose": {"type": "geometry_msgs/PoseStamped", "count": 1}}


# ---------------------------------------------------------------------------
# Dataset collection
# ---------------------------------------------------------------------------

def _small_jax_params():
    return jwb.WholeBodyMPPIParams(
        mppi=JMPPIConfig(n_samples=32, n_horizon=8, n_action=jwb.N_ACTIONS, dt=0.01, lam=0.1,
                         sigma=jwb.default_sigma(), savgol_window=5))


def test_recorder_round_trip_and_cross_package_files(tmp_path):
    recs = {"port": tds.TrajectoryRecorder(metadata={"task": "unit"}),
            "jax": jds.TrajectoryRecorder(metadata={"task": "unit"})}
    for rec in recs.values():
        for i in range(4):
            rec.record(x=np.full(3, float(i)), u=np.full((2, 5), float(-i)))
        with pytest.raises(ValueError, match="fields"):
            rec.record(x=np.zeros(3))
    recs["port"].save(str(tmp_path / "port.npz"))
    recs["jax"].save(str(tmp_path / "jax.npz"))
    for load in (tds.load_dataset, jds.load_dataset):
        for name in ("port", "jax"):
            arrs, meta = load(str(tmp_path / f"{name}.npz"))
            assert meta == {"task": "unit", "n_steps": 4}
            assert arrs["x"].shape == (4, 3) and arrs["u"].shape == (4, 2, 5)
            np.testing.assert_array_equal(arrs["x"][:, 0], [0, 1, 2, 3])
    assert len(recs["port"]) == 4


def test_collect_solver_dataset_matches_jax_collect_whole_body():
    """The port's collect_solver_dataset with the port's step, on the JAX
    collector's perturbations (drawn here with jax.random as it draws them)
    and its solver's normals, against JAX collect_whole_body(n_solves=3,
    seed=1), column by column within 2e-3."""
    _collect_against_jax(_small_jax_params())


def _refused_jax_params():
    """A collector configuration the kernels refuse: K=40 (not a multiple
    of 16) with zero-mean noise."""
    p = _small_jax_params()
    return dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, n_samples=40,
                                                           zero_mean_noise=True))


def test_torch_backend_collect_matches_jax_collect_whole_body_on_a_refused_config():
    """As above, on a configuration the kernels refuse, with the port's
    step on backend="torch" (the JAX collector's XLA solve)."""
    _collect_against_jax(_refused_jax_params(), backend="torch")


def _collect_against_jax(jp, backend="cuda"):
    n_k, h = jp.mppi.n_samples, jp.mppi.n_horizon
    want = jds.collect_whole_body(n_solves=3, seed=1, params=jp, low_k_guard="off").arrays()
    base = jwb.default_obs()
    keys = jax.random.split(jax.random.key(1), 3)
    jobs = []
    for k in keys:
        dp, dq, dv = (0.2 * jax.random.normal(jax.random.fold_in(k, i), (n,))
                      for i, n in enumerate((3, 7, 3)))
        st = base.state
        jobs.append(base._replace(state=st._replace(
            base=st.base._replace(pos=st.base.pos + dp, vel=st.base.vel + 0.1 * dv),
            q=st.q + 0.1 * dq)))
    _, jinit = jwb.make_whole_body_solver(jp, low_k_guard="off")
    key, zs = jinit(jax.random.key(2)).key, []
    for _ in range(3):
        key, z = shared_z(key, n_k, h)
        zs.append(z)
    step, init = twb.make_whole_body_solver(to_port(jp), device="cpu", low_k_guard="off",
                                            backend=backend)
    z_iter = iter(zs)

    def port_step(state, obs):
        return step(state, obs, next(z_iter))

    rec = tds.collect_solver_dataset(
        port_step, init(2), [obs_to_port(o) for o in jobs],
        extract_obs=lambda o: {"base_pos": o.state.base.pos, "base_rpy": o.state.base.rpy,
                               "base_vel": o.state.base.vel, "base_omega": o.state.base.omega,
                               "q": o.state.q, "qdot": o.state.qdot,
                               "ee_target": o.ee_target.position},
        extract_out=lambda out: {"u_seq": out.u_seq, "action": out.action, "qdes": out.qdes,
                                 "vdes": out.vdes})
    got = rec.arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=2e-3, err_msg=k)


def test_port_collect_whole_body_meets_the_jax_gates(tmp_path):
    """tests/test_action_dataset.py's gates on the port's collector."""
    params = to_port(_small_jax_params())
    rec = tds.collect_whole_body(n_solves=3, seed=1, params=params, low_k_guard="off",
                                 device="cpu")
    assert len(rec) == 3
    path = str(tmp_path / "wb.npz")
    rec.save(path)
    arrs, meta = tds.load_dataset(path)
    assert arrs["u_seq"].shape == (3, 8, 11)
    assert arrs["q"].shape == (3, 7)
    assert np.isfinite(arrs["u_seq"]).all()
    assert meta["n_horizon"] == 8 and meta["task"] == "whole_body_reach"
    assert np.std(arrs["base_pos"], axis=0).max() > 0.01
    jarrs, jmeta = jds.load_dataset(path)  # the JAX package reads the port's file
    assert jmeta == meta and all(np.array_equal(jarrs[k], arrs[k]) for k in arrs)
    # The columns are the collector's rows; the plan is its solve on them.
    rows = tds.whole_body_obs_rows(3, 1)
    np.testing.assert_array_equal(arrs["q"], rows[:, 12:19])
    step, init = tds.make_whole_body_collector(params, "off", "cpu")
    state = init(2)
    for i, row in enumerate(rows):
        out, state = step(state, row)
        np.testing.assert_array_equal(tds.split_out_row(out, 8)["u_seq"], arrs["u_seq"][i])


def test_port_collect_whole_body_torch_backend_meets_the_jax_gates(tmp_path):
    """collect_whole_body(backend="torch") on the refused configuration:
    tests/test_action_dataset.py's gates, the plans the collector step's on
    its rows; the default backend still refuses it, naming "torch"."""
    params = to_port(_refused_jax_params())
    with pytest.raises(ValueError, match='backend="torch"'):
        tds.collect_whole_body(n_solves=3, seed=1, params=params, low_k_guard="off",
                               device="cpu")
    rec = tds.collect_whole_body(n_solves=3, seed=1, params=params, low_k_guard="off",
                                 device="cpu", backend="torch")
    arrs = rec.arrays()
    assert len(rec) == 3 and arrs["u_seq"].shape == (3, 8, 11)
    assert np.isfinite(arrs["u_seq"]).all() and np.std(arrs["base_pos"], axis=0).max() > 0.01
    assert rec.metadata["n_samples"] == 40
    step, init = tds.make_whole_body_collector(params, "off", "cpu", backend="torch")
    state = init(2)
    for i, row in enumerate(tds.whole_body_obs_rows(3, 1)):
        out, state = step(state, row)
        np.testing.assert_array_equal(tds.split_out_row(out, 8)["u_seq"], arrs["u_seq"][i])


def test_collector_perturbations_use_the_jax_scales():
    rows = tds.whole_body_obs_rows(2000, 0)
    base = N(twb.default_obs(device="cpu").state.base.pos)
    np.testing.assert_allclose(np.std(rows[:, 0:3] - base, axis=0), 0.2, rtol=0.1)
    np.testing.assert_allclose(np.std(rows[:, 6:9], axis=0), 0.02, rtol=0.1)
    np.testing.assert_allclose(np.std(rows[:, 12:19] - tkinova.Q_HOME, axis=0), 0.02, rtol=0.1)
    assert np.array_equal(rows[:, 3:6], np.zeros((2000, 3), np.float32))
    assert rows.dtype == np.float32 and np.array_equal(rows, tds.whole_body_obs_rows(2000, 0))


# ---------------------------------------------------------------------------
# URDF loader and the matrix FK
# ---------------------------------------------------------------------------

SPEC_FIELDS = ("origin_rot", "origin_trans", "axis", "joint_type", "lower", "upper", "velocity",
               "effort", "tip_rot", "tip_trans")


@pytest.mark.parametrize("tip,hard_tip", [(LINK_7, "link_7"), (TIP, "end_effector")])
def test_urdf_loaders_agree_with_the_hardcoded_spec(tmp_path, tip, hard_tip):
    text = kinova_urdf_text(jkinova)
    assert text == kinova_urdf_text(tkinova)
    (tmp_path / "arm.urdf").write_text(text)
    port, inert = turdf.load_chain(str(tmp_path / "arm.urdf"), ROOT, tip)
    jax_spec = jurdf.Urdf.from_string(text).build_chain(ROOT, tip)
    hard = tkinova.chain(hard_tip)
    for f in SPEC_FIELDS:
        np.testing.assert_allclose(getattr(port, f), getattr(jax_spec, f), rtol=0, atol=1e-12)
        np.testing.assert_allclose(getattr(port, f), getattr(hard, f), rtol=0, atol=1e-12)
    assert port.joint_names == jax_spec.joint_names == hard.joint_names
    jin = jurdf.Urdf.from_string(text).build_inertials(ROOT, tip)
    for f in ("mass", "com", "inertia"):
        np.testing.assert_allclose(getattr(inert, f), getattr(jin, f), rtol=0, atol=1e-12)
        np.testing.assert_allclose(getattr(inert, f), getattr(tkinova.inertials(), f), rtol=0,
                                   atol=1e-12)
    q = torch.linspace(-1, 1, 7)
    a, b = tchain.forward_kinematics(port, q), tchain.forward_kinematics(hard, q)
    torch.testing.assert_close(a.trans, b.trans, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.rot, b.rot, rtol=0, atol=1e-6)


def test_urdf_errors():
    u = turdf.Urdf.from_string(kinova_urdf_text(tkinova))
    with pytest.raises(ValueError, match="no path"):
        u.build_chain("j2s7s300_link_3", "world")
    with pytest.raises(ValueError, match="no actuated joints"):
        u.build_chain(ROOT, "j2s7s300_link_base")
    assert len(u.chain_joints(ROOT, TIP)) == 9


@pytest.fixture(scope="module")
def spec():
    return tkinova.chain()


def test_fk_matches_oracle(spec, rng):
    for _ in range(5):
        q = rng.uniform(-2, 2, size=7)
        got = tchain.forward_kinematics(spec, torch.tensor(q, dtype=torch.float32))
        want = fk_oracle(q)
        np.testing.assert_allclose(N(got.trans), want[:3, 3], atol=1e-5)
        np.testing.assert_allclose(N(got.rot), want[:3, :3], atol=1e-5)


def test_fk_with_base_pose(spec, rng):
    q = rng.uniform(-2, 2, size=7)
    pos = np.array([0.5, -1.0, 2.1])
    quat_xyzw = R.from_euler("ZYX", [0.3, 0.1, -0.2]).as_quat()
    base = tpose.Pose.from_xyzw(T(pos), T(quat_xyzw))
    got = tchain.forward_kinematics(spec, T(q), base=base.to_transform())
    base44 = np.eye(4)
    base44[:3, :3] = R.from_quat(quat_xyzw).as_matrix()
    base44[:3, 3] = pos
    want = fk_oracle(q, base44)
    np.testing.assert_allclose(N(got.trans), want[:3, 3], atol=1e-5)
    np.testing.assert_allclose(N(got.rot), want[:3, :3], atol=1e-5)


def test_fk_batched_shapes(spec, rng):
    q = T(rng.uniform(-2, 2, size=(10, 5, 7)))
    ee = tchain.forward_kinematics(spec, q)
    assert ee.trans.shape == (10, 5, 3) and ee.rot.shape == (10, 5, 3, 3)
    one = tchain.forward_kinematics(spec, q[3, 2])
    np.testing.assert_allclose(N(ee.trans[3, 2]), N(one.trans), atol=1e-6)


@pytest.mark.parametrize("tip", ["link_7", "end_effector"])
def test_posquat_fk_matches_matrix_fk(rng, tip):
    spec = tkinova.chain(tip)
    q = T(rng.uniform(-2, 2, size=(6, 4, 7)))
    pos_q, quat_q = tchain.forward_kinematics_posquat(spec, q)
    ee = tchain.forward_kinematics(spec, q)
    np.testing.assert_allclose(N(pos_q), N(ee.trans), atol=1e-5)
    np.testing.assert_allclose(N(trot.quat_to_matrix(quat_q)), N(ee.rot), atol=1e-5)
    base_pos = torch.tensor([0.3, -0.2, 2.1])
    base_quat = trot.quat_normalize(torch.tensor([0.9, 0.1, -0.2, 0.3]))
    pos_b, quat_b = tchain.forward_kinematics_posquat(spec, q, base_pos=base_pos,
                                                      base_quat=base_quat)
    ee_b = tchain.forward_kinematics(
        spec, q, base=tse3.Transform(rot=trot.quat_to_matrix(base_quat), trans=base_pos))
    np.testing.assert_allclose(N(pos_b), N(ee_b.trans), atol=1e-5)
    np.testing.assert_allclose(N(trot.quat_to_matrix(quat_b)), N(ee_b.rot), atol=1e-5)


def test_matrix_fk_and_link_transforms_match_jax(rng):
    spec_j, spec_t = jkinova.chain("end_effector"), tkinova.chain("end_effector")
    q = rng.uniform(-2, 2, size=(3, 7)).astype(np.float32)
    quat = _quats(rng, 3).astype(np.float32)
    pos = rng.normal(size=(3, 3)).astype(np.float32)
    jbase = jse3.Transform(jrot.quat_to_matrix(jnp.asarray(quat)), jnp.asarray(pos))
    tbase = tse3.Transform(trot.quat_to_matrix(T(quat)), T(pos))
    for fn in ("forward_kinematics", "link_transforms"):
        want = getattr(jchain, fn)(spec_j, jnp.asarray(q), base=jbase)
        got = getattr(tchain, fn)(spec_t, T(q), base=tbase)
        assert got.rot.shape == want.rot.shape
        np.testing.assert_allclose(N(got.rot), np.asarray(want.rot), atol=TOL)
        np.testing.assert_allclose(N(got.trans), np.asarray(want.trans), atol=TOL)
    for j in range(7):
        want = jchain.joint_transform(spec_j, j, jnp.asarray(q[:, j]))
        got = tchain.joint_transform(spec_t, j, T(q[:, j]))
        np.testing.assert_allclose(N(got.rot), np.asarray(want.rot), atol=TOL)
        np.testing.assert_allclose(N(got.trans), np.asarray(want.trans), atol=TOL)


def test_prismatic_joint_transform_matches_jax():
    args = dict(origins_xyz=[[0.1, 0.0, 0.2], [0.0, 0.3, 0.0]],
                origins_rpy=[[0.1, 0.2, 0.3], [0.0, -0.4, 0.5]], axes=[[0, 0, 1], [1, 1, 0]],
                joint_types=[tchain.PRISMATIC, tchain.REVOLUTE], lower=[-1, -1], upper=[1, 1])
    spec_t, spec_j = tchain.build_chain(**args), jchain.build_chain(**args)
    q = np.array([[0.3, -0.7], [-0.2, 1.1]], np.float32)
    want = jchain.forward_kinematics(spec_j, jnp.asarray(q))
    got = tchain.forward_kinematics(spec_t, T(q))
    np.testing.assert_allclose(N(got.rot), np.asarray(want.rot), atol=TOL)
    np.testing.assert_allclose(N(got.trans), np.asarray(want.trans), atol=TOL)
    pos, quat = tchain.forward_kinematics_posquat(spec_t, T(q))
    np.testing.assert_allclose(N(pos), N(got.trans), atol=TOL)


def test_transform_compose_inverse(rng):
    q = _quats(rng, 1)[0]
    t = tse3.from_xyz_quat(T(rng.normal(size=3)), T(q))
    ident = t.compose(t.inverse())
    np.testing.assert_allclose(N(ident.rot), np.eye(3), atol=1e-6)
    np.testing.assert_allclose(N(ident.trans), np.zeros(3), atol=1e-6)


# ---------------------------------------------------------------------------
# Helpers against their JAX functions
# ---------------------------------------------------------------------------

def test_rotation_helpers_match_jax(rng):
    w = rng.normal(size=(32, 3)).astype(np.float32)
    w[0] = [1e-9, 0, 0]
    m = R.from_rotvec(rng.normal(size=(32, 3))).as_matrix().astype(np.float32)
    m2 = R.from_rotvec(rng.normal(size=(32, 3))).as_matrix().astype(np.float32)
    d6 = rng.normal(size=(32, 6)).astype(np.float32)
    cases = [("axis_angle_to_matrix", (w,)), ("matrix_to_axis_angle", (m,)),
             ("rotation_6d_to_matrix", (d6,)), ("matrix_to_rotation_6d", (m,)),
             ("so3_log", (m,)), ("so3_error", (m, m2))]
    for name, args in cases:
        want = getattr(jrot, name)(*(jnp.asarray(a) for a in args))
        got = getattr(trot, name)(*(T(a) for a in args))
        np.testing.assert_allclose(N(got), np.asarray(want), atol=TOL, err_msg=name)
    # so3_error is log(R^T R*): the transpose of the first argument
    np.testing.assert_allclose(
        N(trot.so3_error(T(m), T(m2))),
        R.from_matrix(np.swapaxes(m, -1, -2) @ m2).as_rotvec(), atol=1e-5)


def test_axis_angle_roundtrip(rng):
    w = rng.normal(size=(32, 3))
    m = N(trot.axis_angle_to_matrix(T(w)))
    want = R.from_rotvec(w).as_matrix()
    np.testing.assert_allclose(m, want, atol=1e-6)
    back = N(trot.matrix_to_axis_angle(T(m)))
    np.testing.assert_allclose(back, R.from_matrix(want).as_rotvec(), atol=1e-5)


def test_small_angle_axis_angle_stability():
    w = torch.tensor([[1e-9, 0, 0], [0.0, 0.0, 0.0]])
    q = trot.quat_from_axis_angle(w)
    assert torch.isfinite(q).all()
    np.testing.assert_allclose(N(trot.quat_to_axis_angle(q)), N(w), atol=1e-8)


def test_rotation_6d_roundtrip(rng):
    m = trot.quat_to_matrix(T(_quats(rng, 8)))
    m2 = trot.rotation_6d_to_matrix(trot.matrix_to_rotation_6d(m))
    np.testing.assert_allclose(N(m2), N(m), atol=1e-6)


def test_pose_helpers_match_jax(rng):
    pa, pb = rng.normal(size=(2, 16, 3)).astype(np.float32)
    qa, qb = _quats(rng, 16).astype(np.float32), _quats(rng, 16).astype(np.float32)
    ja, jb = jpose.Pose(jnp.asarray(pa), jnp.asarray(qa)), jpose.Pose(jnp.asarray(pb),
                                                                      jnp.asarray(qb))
    ta, tb = tpose.Pose(T(pa), T(qa)), tpose.Pose(T(pb), T(qb))
    for name in ("position_error_l1", "orientation_error_vec"):
        np.testing.assert_allclose(N(getattr(tpose, name)(ta, tb)),
                                   np.asarray(getattr(jpose, name)(ja, jb)), atol=TOL)
    for got, want in ((ta.compose(tb), ja.compose(jb)), (ta.inverse(), ja.inverse()),
                      (tpose.Pose.from_transform(ta.to_transform()),
                       jpose.Pose.from_transform(ja.to_transform()))):
        np.testing.assert_allclose(N(got.position), np.asarray(want.position), atol=TOL)
        np.testing.assert_allclose(N(got.quat), np.asarray(want.quat), atol=TOL)
    np.testing.assert_allclose(N(ta.rotation_matrix), np.asarray(ja.rotation_matrix), atol=TOL)
    ident = tpose.Pose.identity((2,))
    assert ident.position.shape == (2, 3) and N(ident.quat).tolist() == [[1, 0, 0, 0]] * 2


@pytest.mark.parametrize("sigma", [0.3, [0.1, 0.2, 0.3], [[0.2, 0.0, 0.0], [0.1, 0.3, 0.0],
                                                         [0.0, 0.2, 0.4]]])
def test_sigma_matrix_matches_jax(sigma):
    want = np.asarray(jsampling.sigma_matrix(np.asarray(sigma, np.float32), 3))
    got = N(tsampling.sigma_matrix(np.asarray(sigma, np.float32), 3))
    assert got.shape == (3, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"c": 0.5, "s": 0.1, "n": 1},
                                {"c": 0.3, "n": 0, "r": 2.0, "disp_weight": [1.0, 2.0, 0.5]}])
def test_gaussian_projected_dist_cost_matches_jax(rng, kw):
    states = rng.normal(size=(4, 6, 3)).astype(np.float32)
    goal = rng.normal(size=3).astype(np.float32)
    jkw = {k: (jnp.asarray(v, jnp.float32) if k == "disp_weight" else v) for k, v in kw.items()}
    tkw = {k: (T(v) if k == "disp_weight" else v) for k, v in kw.items()}
    want = jcosts.gaussian_projected_dist_cost(jnp.asarray(states), jnp.asarray(goal), **jkw)
    got = tcosts.gaussian_projected_dist_cost(T(states), T(goal), **tkw)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(N(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_scan_rollout_matches_jax(rng):
    """A double integrator over the horizon (state leaves with the K axis),
    extracting a tuple per step, against lax.scan."""
    x0 = rng.normal(size=(2, 5, 3)).astype(np.float32)
    u = rng.normal(size=(7, 5, 3)).astype(np.float32)

    def step(xp, state, u_t):
        p, v = state
        return (p + 0.1 * v, v + 0.1 * u_t)

    want = jint.scan_rollout(lambda s, u_t: step(jnp, s, u_t),
                             (jnp.asarray(x0[0]), jnp.asarray(x0[1])), jnp.asarray(u))
    got = tint.scan_rollout(lambda s, u_t: step(torch, s, u_t), (T(x0[0]), T(x0[1])), T(u))
    for g, w in zip(got, want):
        assert g.shape == (7, 5, 3)
        np.testing.assert_allclose(N(g), np.asarray(w), atol=TOL)
    pos_only = tint.scan_rollout(lambda s, u_t: step(torch, s, u_t), (T(x0[0]), T(x0[1])), T(u),
                                 extract=lambda s: s[0])
    np.testing.assert_allclose(N(pos_only), np.asarray(want[0]), atol=TOL)


def test_arm_gravity_wrench_matches_jax(rng):
    spec_j, spec_t = jkinova.chain(), tkinova.chain()
    q = rng.uniform(-2, 2, size=(16, 7)).astype(np.float32)
    rpy = rng.uniform(-0.3, 0.3, size=(16, 3)).astype(np.float32)
    base_rot = R.from_euler("ZYX", rpy[:, ::-1]).as_matrix().astype(np.float32)
    jf, jt = jwbm.arm_gravity_wrench(spec_j, jkinova.inertials(), jnp.asarray(q),
                                     jnp.asarray(base_rot))
    tf, tt = twbm.arm_gravity_wrench(spec_t, tkinova.inertials(), T(q), T(base_rot))
    np.testing.assert_allclose(N(tf), np.asarray(jf), atol=TOL)
    np.testing.assert_allclose(N(tt), np.asarray(jt), atol=TOL)
    # its torque is the fast gravity moment's (the weight rides the base lump)
    np.testing.assert_allclose(
        N(tt), N(twbm.arm_gravity_torque_fast(spec_t, tkinova.inertials(), T(q), T(base_rot))),
        atol=1e-4)
