"""The port's camera stack against the JAX package's, on the CPU.

Module level, on inputs made with numpy from a seed: ``gimbal_step`` over
1,000 ticks on the same base attitudes and commands (1e-4 rad),
``quat_to_zxy`` and ``camera_rotation`` (1e-5), ``depth_render`` on the
same poses and scene (1e-5 relative, the +inf masks identical), each noise
model on the JAX draws (1e-6), ``depth_to_points`` (1e-5 m), the geodetic
conversion (exact: a copy) and ``replay_capture`` against the JAX replay on
one logged flight (the same schedule, poses within 1e-5, images and
geotags within the sensors' noise, whose streams differ).

Then the JAX package's own tests on the port, at their thresholds:
``tests/test_camera_stack.py`` (its ten cases; the stream case against a
live port ``BridgeServer``) and the depth-camera cases of
``tests/test_depth_occupancy.py``.  Last, the camera survey end to end:
the JAX command line and the port's each fly ``camera-survey --steps 20
--save-log``, and their logs agree (pos 1e-4 m, gimbal angles 1e-4 rad,
pointing error 1e-3 rad: the arccos near 1 amplifies float32 rounding),
with the same frames at the same capture times, geotagged within the GPS
noise; and ``--stream`` pushes the frame to a live server that gives it
back with its NaNs in place.
"""

import json
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.run import main as jax_main
from quadrotor_manipulator_mppi_tpu.sim import depth_camera as jdc
from quadrotor_manipulator_mppi_tpu.sim import geotag as jgeo
from quadrotor_manipulator_mppi_tpu.sim import gimbal as jgb
from quadrotor_manipulator_mppi_tpu_torch import run as trun
from quadrotor_manipulator_mppi_tpu_torch.bridge import camera as cam
from quadrotor_manipulator_mppi_tpu_torch.bridge import protocol as proto
from quadrotor_manipulator_mppi_tpu_torch.bridge.server import BridgeServer
from quadrotor_manipulator_mppi_tpu_torch.models.whole_body import _quat_from_rpy
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling
from quadrotor_manipulator_mppi_tpu_torch.sim import depth_camera as dc
from quadrotor_manipulator_mppi_tpu_torch.sim import gimbal as gb
from quadrotor_manipulator_mppi_tpu_torch.sim.geotag import (
    GeotagParams, GeotagRecorder, capture_schedule, local_to_geodetic, replay_capture,
)

from torch_parity import N, T, torch_one_thread  # noqa: F401

TIMEOUT = 30.0
GIMBAL = gb.GimbalParams()
# Optical -> world for a camera looking straight down (optical x -> world
# x, optical y -> world -y, the axis -> world -z).
R_DOWN = np.asarray([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]], np.float32).T
SCENE = (np.asarray([[2.0, 0.0, 0.6], [0.5, 1.5, 0.4]], np.float32),
         np.asarray([0.6, 0.4], np.float32))


@pytest.fixture(autouse=True)
def no_autograd():
    with torch.inference_mode():
        yield


def _rpy_quats(rng, n):
    """(n, 4) float32 base attitudes from seeded roll/pitch/yaw."""
    rpy = np.stack([0.3 * np.sin(np.linspace(0, 6, n)) + rng.normal(0, 0.02, n),
                    0.25 * np.cos(np.linspace(0, 4, n)), np.linspace(-2.5, 2.5, n)], -1)
    return N(_quat_from_rpy(T(rpy)))


# ---------------------------------------------------------------------------
# Module parity with the JAX package
# ---------------------------------------------------------------------------


def test_quat_to_zxy_and_camera_rotation_match_jax():
    rng = np.random.default_rng(1)
    angles = rng.uniform(-1.2, 1.2, (16, 3)).astype(np.float32)
    quats = _rpy_quats(rng, 16)
    np.testing.assert_allclose(N(gb._joint_quat(T(angles))),
                               np.stack([np.asarray(jgb._joint_quat(jnp.asarray(a)))
                                         for a in angles]), atol=1e-6)
    np.testing.assert_allclose(N(gb.quat_to_zxy(T(quats))),
                               np.asarray(jgb.quat_to_zxy(jnp.asarray(quats))), atol=1e-5)
    for a, q in zip(angles[:8], quats[:8]):
        want = jgb.camera_rotation(jgb.GimbalState(jnp.asarray(a), jnp.zeros(3)), jnp.asarray(q))
        got = gb.camera_rotation(gb.GimbalState(T(a), torch.zeros(3)), T(q))
        np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-5)
    # Batched: one call for every row.
    got = gb.camera_rotation(gb.GimbalState(T(angles), torch.zeros(16, 3)), T(quats))
    assert got.shape == (16, 3, 3)
    np.testing.assert_allclose(N(got[5]), N(gb.camera_rotation(
        gb.GimbalState(T(angles[5]), torch.zeros(3)), T(quats[5]))), atol=1e-7)
    cam_pos, target = rng.normal(0, 2, (16, 3)), rng.normal(0, 2, (16, 3))
    np.testing.assert_allclose(N(gb.point_at(T(cam_pos), T(target))),
                               np.asarray(jgb.point_at(jnp.asarray(cam_pos, jnp.float32),
                                                       jnp.asarray(target, jnp.float32))),
                               atol=1e-6)


def test_shortest_rounds_half_to_even():
    a = np.asarray([np.pi, -np.pi, 3 * np.pi, 5 * np.pi, 0.3, -7.0], np.float32)
    np.testing.assert_allclose(N(gb._shortest(T(a))), np.asarray(jgb._shortest(jnp.asarray(a))),
                               atol=1e-6)


def test_gimbal_step_1000_ticks_matches_jax():
    """1,000 ticks on the same base attitudes and world commands (the
    commands sweep past the pitch and roll stops): angles within 1e-4 rad,
    rates within 1e-3 rad/s."""
    rng = np.random.default_rng(2)
    n = 1000
    quats = _rpy_quats(rng, n)
    cmds = np.stack([np.linspace(-1.0, 2.6, n), 0.9 * np.sin(np.linspace(0, 9, n)),
                     np.linspace(-3.0, 3.0, n)], -1).astype(np.float32)

    def body(s, x):
        s = jgb.gimbal_step(jgb.GimbalParams(), s, x[0], x[1], 1e-3)
        return s, (s.angles, s.rates)

    _, (ja, jr) = jax.jit(lambda s, c, q: jax.lax.scan(body, s, (c, q)))(
        jgb.init_gimbal(), jnp.asarray(cmds), jnp.asarray(quats))
    state, angles, rates = gb.init_gimbal(device="cpu"), [], []
    for c, q in zip(T(cmds), T(quats)):
        state = gb.gimbal_step(GIMBAL, state, c, q, 1e-3)
        angles.append(state.angles)
        rates.append(state.rates)
    np.testing.assert_allclose(N(torch.stack(angles)), np.asarray(ja), atol=1e-4)
    np.testing.assert_allclose(N(torch.stack(rates)), np.asarray(jr), atol=1e-3)
    a = N(torch.stack(angles))
    assert a[:, 0].max() <= GIMBAL.pitch_limits[1] + 1e-6 and a[:, 1].min() >= -0.785 - 1e-6


def _render_poses():
    """(pos, rot) poses: straight down over the scene, two gimbal-steered
    oblique views from the survey's orbit and one pitched 0.25 rad below
    the horizon (sky in the upper rows)."""
    poses = [(np.asarray([2.0, 0.0, 5.0], np.float32), R_DOWN)]
    quats = _rpy_quats(np.random.default_rng(0), 8)
    for k, (ang, pitch) in enumerate(((0.0, 0.75), (1.3, 0.8), (2.9, 0.25))):
        pos = np.asarray([2.0 + 3.0 * np.cos(ang), 3.0 * np.sin(ang), 3.0], np.float32)
        angles = T([pitch, 0.02 * k, np.pi + ang])
        poses.append((pos, N(gb.camera_rotation(gb.GimbalState(angles, torch.zeros(3)),
                                                T(quats[k] if k < 2 else [1.0, 0, 0, 0])))))
    return poses


def test_depth_render_matches_jax():
    """32 x 24 frames of the survey's scene on four poses: 1e-5 relative on
    finite pixels, the +inf masks identical; the batched call equals the
    frame-by-frame calls."""
    p = dc.DepthCameraParams(width=32, height=24, max_depth=30.0)
    jp = jdc.DepthCameraParams(width=32, height=24, max_depth=30.0)
    poses = _render_poses()
    outs = []
    for pos, rot in poses:
        want = np.asarray(jdc.depth_render(jp, jnp.asarray(pos), jnp.asarray(rot),
                                           sphere_centers=jnp.asarray(SCENE[0]),
                                           sphere_radii=jnp.asarray(SCENE[1])))
        got = N(dc.depth_render(p, T(pos), T(rot), sphere_centers=T(SCENE[0]),
                                sphere_radii=T(SCENE[1])))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
        outs.append(got)
    assert np.isfinite(outs[3]).any() and np.isinf(outs[3]).any()  # the horizon in view
    assert (outs[1] < 3.0).any()  # a sphere in view
    batched = dc.depth_render(p, T(np.stack([x for x, _ in poses])),
                              T(np.stack([r for _, r in poses])),
                              sphere_centers=T(SCENE[0]), sphere_radii=T(SCENE[1]))
    assert batched.shape == (4, 24, 32)
    np.testing.assert_allclose(N(batched), np.stack(outs), rtol=1e-6)


@pytest.mark.parametrize("model", ["kinect", "pmd", "d435"])
def test_noise_models_on_the_jax_draws(model):
    """Each model on the JAX key's normals fed to the port: 1e-6, NaN in
    the same places (out-of-range and +inf pixels)."""
    p, jp = dc.DepthCameraParams(), jdc.DepthCameraParams()
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.05, 40.0, (48, 64)).astype(np.float32)
    depth[0, :5] = np.inf
    key = jax.random.PRNGKey(7)
    want = np.asarray(jdc.noisy_depth(jp, key, jnp.asarray(depth), model=model))
    z = jax.random.normal(key, depth.shape, jnp.float32)
    got = N(dc.noisy_depth(p, T(depth), model=model, noise=T(np.asarray(z))))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], atol=1e-6, rtol=1e-6)


def test_noise_draws_from_the_philox_stream():
    """Without explicit normals the model draws one Philox normal per pixel
    under (seed, step), row-major; a batch of frames is one draw."""
    p = dc.DepthCameraParams()
    depth = torch.full((2, 4, 6), 3.0)
    seed = sampling.philox_keys(5, "cpu")
    got = dc.pmd_depth_noise(p, depth, seed=seed, step=1)
    z = sampling.philox_normals(5, 1, 48, 1, 1, "cpu").reshape(2, 4, 6)
    torch.testing.assert_close(got, 3.0 + 0.03 * z, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        dc.kinect_depth_noise(p, depth)


def test_depth_to_points_matches_jax():
    p = dc.DepthCameraParams(width=16, height=12, max_depth=50.0)
    jp = jdc.DepthCameraParams(width=16, height=12, max_depth=50.0)
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.1, 9.0, (12, 16)).astype(np.float32)
    depth[3, 4] = np.nan
    pos, rot = np.asarray([0.5, -0.25, 3.0], np.float32), _render_poses()[2][1]
    jpts, jvalid = jdc.depth_to_points(jp, jnp.asarray(depth), jnp.asarray(pos),
                                       jnp.asarray(rot))
    pts, valid = dc.depth_to_points(p, T(depth), T(pos), T(rot))
    np.testing.assert_array_equal(N(valid), np.asarray(jvalid))
    np.testing.assert_allclose(N(pts), np.asarray(jpts), atol=1e-5)


def test_local_to_geodetic_is_the_jax_conversion():
    rng = np.random.default_rng(5)
    for xyz in rng.normal(0, 300, (10, 3)):
        assert local_to_geodetic(GeotagParams(), xyz) == jgeo.local_to_geodetic(
            jgeo.GeotagParams(), xyz)


def _flight_log(n=2550):
    """A synthetic logged flight: a climbing arc, a weaving attitude and a
    sweeping gimbal, per 1 ms tick."""
    t = np.arange(n) * 1e-3
    pos = np.stack([2.0 + 3.0 * np.cos(0.3 * t), 3.0 * np.sin(0.3 * t), 2.5 + 0.2 * t], -1)
    quat = _rpy_quats(np.random.default_rng(6), n)
    gim = np.stack([0.9 + 0.2 * np.sin(t), 0.05 * np.cos(t), np.pi + 0.3 * t], -1)
    return pos.astype(np.float32), quat, gim.astype(np.float32)


def test_replay_capture_matches_the_jax_replay(tmp_path):
    """One flight through both replays: the same capture schedule (frame
    count, times, file names), camera poses within 1e-5, the images' NaN
    masks equal away from the range limits and values within the Kinect
    noise, the geotags within the GPS noise (the noise streams differ)."""
    pos, quat, gim = _flight_log()
    cam_p = dc.DepthCameraParams(width=32, height=24, max_depth=30.0)
    jrec = jgeo.GeotagRecorder(params=jgeo.GeotagParams(), out_dir=str(tmp_path / "jax"))
    jgeo.replay_capture(jrec, pos, quat, gim, jdc.DepthCameraParams(width=32, height=24,
                                                                     max_depth=30.0),
                        jax.random.key(0), SCENE[0], SCENE[1])
    rec = GeotagRecorder(params=GeotagParams(), out_dir=str(tmp_path / "port"))
    out = replay_capture(rec, T(pos), T(quat), T(gim), cam_p, sampling.philox_keys(0, "cpu"),
                         SCENE[0], SCENE[1])
    assert capture_schedule(GeotagRecorder(), len(pos)) == (list(range(0, 2550, 100)),
                                                           [0, 1000, 2000])
    assert len(rec.written) == len(jrec.written) == 3 and out["frames"].shape == (3, 24, 32)
    assert [p.split("/")[-1] for p in rec.written] == [p.split("/")[-1] for p in jrec.written]
    for mine, theirs in zip(rec.written, jrec.written):
        a, b = np.load(mine), np.load(theirs)
        assert set(a.files) == set(b.files) and float(a["t"]) == float(b["t"])
        np.testing.assert_allclose(a["cam_pos"], b["cam_pos"], atol=1e-6)
        np.testing.assert_allclose(a["cam_rot"], b["cam_rot"], atol=1e-5)
        ia, ib = a["image"], b["image"]
        assert ia.shape == ib.shape == (24, 32) and ia.dtype == ib.dtype == np.float32
        both = np.isfinite(ia) & np.isfinite(ib)
        assert both.sum() >= 0.95 * np.isfinite(ib).sum() > 0
        sigma = 0.0012 + 0.0019 * (ib[both] - 0.4) ** 2
        assert np.all(np.abs(ia[both] - ib[both]) < 12.0 * sigma)
        np.testing.assert_allclose(a["gps_local_xyz"], b["gps_local_xyz"],
                                   atol=6 * np.sqrt(2) * 0.1)
        assert abs(float(a["lat_deg"]) - float(b["lat_deg"])) < 1e-5
        assert abs(float(a["alt_m"]) - float(b["alt_m"])) < 1.0


# ---------------------------------------------------------------------------
# The JAX package's tests/test_camera_stack.py on the port
# ---------------------------------------------------------------------------


def _quat_rpy(roll, pitch, yaw):
    return _quat_from_rpy(torch.tensor([roll, pitch, yaw], dtype=torch.float32))


def test_quat_to_zxy_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        angles = T(rng.uniform(-1.0, 1.0, 3))
        np.testing.assert_allclose(N(gb.quat_to_zxy(gb._joint_quat(angles))), N(angles),
                                   atol=1e-5)


def _settle(cmd, base_quat, ticks=3000):
    state = gb.init_gimbal(device="cpu")
    for _ in range(ticks):
        state = gb.gimbal_step(GIMBAL, state, cmd, base_quat, 1e-3)
    return state


def test_gimbal_points_camera_down_by_default():
    base = torch.tensor([1.0, 0.0, 0.0, 0.0])
    state = _settle(torch.tensor([0.5 * np.pi, 0.0, 0.0]), base)
    axis = N(gb.camera_rotation(state, base))[:, 2]
    np.testing.assert_allclose(axis, [0.0, 0.0, -1.0], atol=2e-2)


def test_gimbal_tracks_target_through_base_motion():
    state = gb.init_gimbal(device="cpu")
    target, cam_pos = torch.tensor([4.0, -2.0, 0.5]), torch.tensor([0.0, 0.0, 2.1])
    errs = []
    for i in range(4000):
        t = i * 1e-3
        base = _quat_rpy(0.2 * np.sin(2.0 * t), 0.2 * np.cos(1.5 * t), 0.4 * np.sin(t))
        state = gb.gimbal_step(GIMBAL, state, gb.point_at(cam_pos, target), base, 1e-3)
        if i % 50 == 0:
            axis = gb.camera_rotation(state, base)[:, 2]
            want = (target - cam_pos) / torch.linalg.norm(target - cam_pos)
            errs.append(float(torch.acos(torch.clamp(torch.dot(axis, want), -1, 1))))
    tail = np.asarray(errs[len(errs) // 2:])
    assert tail.max() < np.deg2rad(6.0), np.rad2deg(tail.max())


def test_gimbal_respects_joint_limits():
    a = N(_settle(torch.tensor([-2.0, 1.5, 0.0]), torch.tensor([1.0, 0.0, 0.0, 0.0])).angles)
    assert a[0] >= GIMBAL.pitch_limits[0] - 1e-6
    assert a[1] <= GIMBAL.roll_limits[1] + 1e-6


def test_geodetic_conversion_signs():
    p = GeotagParams()
    north = local_to_geodetic(p, [100.0, 0.0, 0.0])
    west = local_to_geodetic(p, [0.0, 100.0, 0.0])
    up = local_to_geodetic(p, [0.0, 0.0, 50.0])
    assert north["lat_deg"] > p.lat_home_deg
    assert west["lon_deg"] < p.lon_home_deg      # NWU +y = west
    assert up["alt_m"] == pytest.approx(p.alt_home_m + 50.0)
    assert north["lat_deg"] - p.lat_home_deg == pytest.approx(np.rad2deg(100.0 / 6356766.0))


def test_geotag_recorder_writes_tagged_artifacts(tmp_path):
    rec = GeotagRecorder(params=GeotagParams(interval=1.0), out_dir=str(tmp_path / "frames"))
    img = np.full((4, 6), 3.0, np.float32)
    assert rec.on_frame(0.0, img) is None          # no GPS fix yet
    rec.on_gps([10.0, -5.0, 2.0])
    p1 = rec.on_frame(0.1, img, cam_pos=[1.0, 2.0, 3.0], cam_rot=np.eye(3))
    assert p1 is not None
    assert rec.on_frame(0.5, img) is None          # within the interval
    rec.on_gps([20.0, -5.0, 2.0])
    p2 = rec.on_frame(1.2, img)
    assert p2 is not None and p2 != p1
    d1 = np.load(p1)
    assert d1["image"].shape == (4, 6)
    assert float(d1["lat_deg"]) > GeotagParams().lat_home_deg
    assert float(d1["alt_m"]) == pytest.approx(488.0 + 2.0)
    np.testing.assert_allclose(d1["cam_pos"], [1.0, 2.0, 3.0])
    assert float(np.load(p2)["lat_deg"]) > float(d1["lat_deg"])  # moved north
    assert rec.written == [p1, p2]


def test_image_frame_roundtrip_with_nan():
    img = np.arange(12, dtype=np.float32).reshape(3, 4)
    img[1, 2] = np.nan
    dec = proto.Decoder()
    dec.feed(proto.encode(proto.encode_image(img, seq=7, t=1.5)))
    out = dec.pop()
    assert out.type == proto.MsgType.IMAGE
    rec, meta = proto.decode_image(out)
    assert meta == {"seq": 7, "t": 1.5}
    np.testing.assert_array_equal(np.isnan(rec), np.isnan(img))
    np.testing.assert_allclose(rec[~np.isnan(img)], img[~np.isnan(img)])


def _poll(viewer, seq):
    """Poll the server's latest frame until the frame ``seq`` is there."""
    got, meta = None, {}
    deadline = time.time() + TIMEOUT
    while time.time() < deadline:
        got, meta = cam.fetch_image(viewer)
        if got is not None and meta.get("seq") == seq:
            break
        time.sleep(0.05)
    return got, meta


def test_camera_stream_round_trips_over_live_bridge():
    server = BridgeServer()
    server.start()
    try:
        with socket.create_connection((server.host, server.port), timeout=5) as pub_sock, \
                socket.create_connection((server.host, server.port), timeout=5) as viewer:
            pub = cam.CameraPublisher(pub_sock, rate_hz=10.0)
            img0 = np.linspace(0.5, 8.0, 4 * 8, dtype=np.float32).reshape(4, 8)
            assert pub.publish(img0, t=0.0)
            assert not pub.publish(img0 + 1.0, t=0.05)   # rate-limited
            assert pub.publish(img0 + 1.0, t=0.2)
            got, meta = _poll(viewer, 1)
            assert got is not None and meta.get("seq") == 1
            np.testing.assert_allclose(got, img0 + 1.0)
    finally:
        server.stop()


def test_ascii_depth_renders_near_far():
    img = np.full((8, 16), 10.0, np.float32)
    img[:, :8] = 1.0                    # near half
    img[0, 0] = np.nan                  # invalid
    lines = cam.ascii_depth(img, width=16, max_depth=10.0).splitlines()
    assert lines
    assert lines[-1][0] != " " and lines[-1][-1] == " "


def test_gimbal_feeds_depth_camera_render():
    base = torch.tensor([1.0, 0.0, 0.0, 0.0])
    state = _settle(torch.tensor([0.5 * np.pi, 0.0, 0.0]), base)
    depth = dc.depth_render(dc.DepthCameraParams(width=16, height=12), torch.tensor([0.0, 0.0, 2.0]),
                            gb.camera_rotation(state, base))
    assert float(depth[6, 8]) == pytest.approx(2.0, abs=0.05)  # ground 2 m below


# ---------------------------------------------------------------------------
# The depth-camera cases of the JAX package's tests/test_depth_occupancy.py
# ---------------------------------------------------------------------------


def test_down_camera_sees_flat_ground():
    depth = dc.depth_render(dc.DepthCameraParams(width=32, height=24), torch.tensor([0.0, 0.0, 2.0]),
                            T(R_DOWN), ground_z=0.0)
    np.testing.assert_allclose(N(depth), 2.0, rtol=1e-5)


def test_sphere_silhouette_and_depth():
    p = dc.DepthCameraParams(width=33, height=25, max_depth=50.0)
    d = N(dc.depth_render(p, torch.tensor([0.0, 0.0, 10.0]), T(R_DOWN), ground_z=-100.0,
                          sphere_centers=torch.tensor([[0.0, 0.0, 5.0]]),
                          sphere_radii=torch.tensor([1.0]), background=50.0))
    cy, cx = p.height // 2, p.width // 2
    np.testing.assert_allclose(d[cy, cx], 4.0, atol=1e-3)     # 10 - 5 - 1
    np.testing.assert_allclose(d[0, 0], 110.0, rtol=1e-5)     # the far ground
    hits = np.isfinite(d) & (d < 100.0)
    assert hits.sum() > 4
    np.testing.assert_array_equal(hits, hits[::-1, :])
    np.testing.assert_array_equal(hits, hits[:, ::-1])


def _jax_normals(seed, shape):
    return T(np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)))


def test_kinect_noise_statistics_and_badpoints():
    p = dc.DepthCameraParams(width=200, height=200)
    err = N(dc.kinect_depth_noise(p, torch.full((200, 200), 1.0),
                                  noise=_jax_normals(0, (200, 200)))) - 1.0
    expect = 0.0012 + 0.0019 * (1.0 - 0.4) ** 2
    assert abs(err.std() - expect) < 0.1 * expect
    bad = dc.kinect_depth_noise(p, torch.full((4, 4), 0.1), noise=_jax_normals(0, (4, 4)))
    assert np.all(np.isnan(N(bad)))


def test_pmd_noise_statistics():
    p = dc.DepthCameraParams(width=200, height=200)
    err = N(dc.pmd_depth_noise(p, torch.full((200, 200), 5.0),
                               noise=_jax_normals(1, (200, 200)))) - 5.0
    assert abs(err.std() - 0.05) < 0.005


def test_d435_noise_statistics():
    p = dc.DepthCameraParams(width=64, height=64, h_fov=float(np.pi / 2))
    f = 0.5 * 64 / np.tan(np.pi / 4)
    rms = (1.0 * 1000.0) ** 2 * 0.1 / (f * 0.05 * 1e6)
    expect = rms * rms
    err = N(dc.d435_depth_noise(p, torch.full((200, 200), 1.0),
                                noise=_jax_normals(2, (200, 200)))) - 1.0
    assert abs(err.std() - expect) < 0.15 * expect
    err_far = N(dc.d435_depth_noise(p, torch.full((200, 200), 30.0),
                                    noise=_jax_normals(3, (200, 200)))) - 30.0
    assert abs(err_far.std() - 3.0) < 0.45


def test_noise_model_registry():
    p, d = dc.DepthCameraParams(), torch.full((4, 4), 2.0)
    for name in ("Kinect", "pmd", "D435"):
        out = dc.noisy_depth(p, d, model=name, seed=sampling.philox_keys(0, "cpu"), step=0)
        assert out.shape == d.shape


def test_backprojection_roundtrip():
    p = dc.DepthCameraParams(width=16, height=12, max_depth=50.0)
    pos = torch.tensor([0.5, -0.25, 3.0])
    depth = dc.depth_render(p, pos, T(R_DOWN), ground_z=0.0)
    pts, valid = dc.depth_to_points(p, depth, pos, T(R_DOWN))
    assert bool(valid.all())
    np.testing.assert_allclose(N(pts[:, 2]), 0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# The camera survey end to end, through both command lines
# ---------------------------------------------------------------------------


def _cli(capsys, main, argv):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_camera_survey_cli_matches_jax(capsys, tmp_path):
    jr = _cli(capsys, jax_main, ["camera-survey", "--steps", "20", "--platform", "cpu",
                                 "--save-log", str(tmp_path / "jax.npz"),
                                 "--out-dir", str(tmp_path / "jax")])
    r = _cli(capsys, trun.main, ["camera-survey", "--steps", "20", "--platform", "cpu",
                                 "--save-log", str(tmp_path / "port.npz"),
                                 "--out-dir", str(tmp_path / "port")])
    assert list(r)[0] == "scenario" and r["scenario"] == "camera-survey"
    assert set(jr) | {"device"} == set(r) and r["device"] == "cpu"
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(b.files) == {"pos", "gimbal", "point_err"}
    assert set(a.files) == set(b.files) | {"quat"} and a["quat"].shape == (200, 4)
    assert a["pos"].shape == b["pos"].shape == (200, 3)
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-4)
    np.testing.assert_allclose(a["gimbal"], b["gimbal"], atol=1e-4)
    np.testing.assert_allclose(a["point_err"], b["point_err"], atol=1e-3)
    assert r["frames_written"] == jr["frames_written"] >= 1
    for k in ("point_err_tail_max_deg", "point_err_tail_mean_deg"):
        assert abs(r[k] - jr[k]) <= 0.1
    assert abs(r["orbit_alt_final_m"] - jr["orbit_alt_final_m"]) <= 2e-3
    fa, fb = np.load(r["first_frame"]), np.load(jr["first_frame"])
    assert float(fa["t"]) == float(fb["t"])
    np.testing.assert_allclose(fa["cam_pos"], fb["cam_pos"], atol=1e-4)
    np.testing.assert_allclose(fa["gps_local_xyz"], fb["gps_local_xyz"], atol=6 * np.sqrt(2) * 0.1)
    assert fa["image"].ndim == 2 and np.isfinite(fa["image"]).any()
    assert abs(float(fa["lat_deg"]) - 47.3667) < 0.01 and float(fa["alt_m"]) > 488.0


def test_camera_survey_streams_its_frames(capsys, tmp_path):
    """``--stream``: each captured frame reaches a live server, which gives
    the last one back equal to the last npz frame, NaNs in place."""
    server = BridgeServer()
    server.start()
    try:
        r = _cli(capsys, trun.main, ["camera-survey", "--steps", "20", "--platform", "cpu",
                                     "--out-dir", str(tmp_path), "--stream",
                                     f"127.0.0.1:{server.port}"])
        last = np.load(sorted(tmp_path.glob("DSC*.npz"))[-1])["image"]
        with socket.create_connection((server.host, server.port), timeout=5) as viewer:
            got, meta = _poll(viewer, r["frames_written"] - 1)
        assert got is not None and got.shape == last.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(last))
        np.testing.assert_array_equal(got[~np.isnan(last)], last[~np.isnan(last)])
        assert np.isnan(last).any()   # the sky beyond max_depth
    finally:
        server.stop()
    with pytest.raises(SystemExit):
        trun.main(["camera-survey", "--steps", "1", "--platform", "cpu", "--stream", "nohost"])
