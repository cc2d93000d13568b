"""The port's mapped flight (lidar -> occupancy grid -> map-aware MPPI ->
backstepping) against the JAX package's, on the CPU.

Cases, each with its tolerance: ``lidar_measure`` on explicit normals
(1e-5 m); ``insert_rays`` on fixed ray sets, voxel for voxel, where a
voxel may differ only if a ray sample lies within 1e-5 m of a voxel face
(counted and bounded); ``occupied_centers`` on a grid with more tied
voxels than slots, index for index against ``jax.lax.top_k``;
``distance_field``, ``query_distance``, ``query`` and ``occupancy_prob``
(1e-6), ``voxel_centers`` (equal); three mapped solves in
sphere and ESDF mode on the JAX key chain's draws (u_seq and setpoint
2e-4); 20 steps of ``make_mapped_control_step`` against the JAX control
step on the same lidar normals and MPPI draws (position 1e-3 m); the
checkpoint round trip of the loop state, the resumed run bit-equal to the
uninterrupted one; the configuration crossing through ``convert``.  Then
the JAX package's occupancy and mapped-solver tests
(``tests/test_depth_occupancy.py``, their scans through the port's depth
camera in float64) on the port alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu.sim import mapped_loop as jml
from quadrotor_manipulator_mppi_tpu.sim import occupancy as jocc
from quadrotor_manipulator_mppi_tpu.sim import sensors as jsensors
from quadrotor_manipulator_mppi_tpu.solver import mapped as jms
from quadrotor_manipulator_mppi_tpu.utils import rotations as jrot
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import MultirotorState
from quadrotor_manipulator_mppi_tpu_torch.ops import integrators
from quadrotor_manipulator_mppi_tpu_torch.scenarios.solvers import (
    mapped_flight_episode, run_mapped_flight,
)
from quadrotor_manipulator_mppi_tpu_torch.sim import depth_camera as dc
from quadrotor_manipulator_mppi_tpu_torch.sim import flight_control as fc
from quadrotor_manipulator_mppi_tpu_torch.sim import mapped_loop as ml
from quadrotor_manipulator_mppi_tpu_torch.sim import occupancy as occ
from quadrotor_manipulator_mppi_tpu_torch.sim import sensors
from quadrotor_manipulator_mppi_tpu_torch.solver import mapped as ms
from quadrotor_manipulator_mppi_tpu_torch.utils import checkpoint

from torch_parity import N, T, shared_z, torch_one_thread  # noqa: F401

TOL_LIDAR = 1e-5     # m
FACE_EPS = 1e-5      # m: a sample this close to a voxel face may land either side
TOL_FIELD = 1e-6     # m
TOL_SOLVE = 2e-4     # relative to the largest entry
TOL_STEPS = 1e-3     # m, position over 20 control steps
SCENE_C = np.asarray([[3.5, 0.35, 1.8], [6.5, -0.5, 1.8], [1.0, -2.0, 0.5]], np.float32)
SCENE_R = np.asarray([1.0, 1.0, 0.4], np.float32)


def close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(N(got), want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def _rot(seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jrot.quat_to_matrix(jnp.asarray(rng.normal(size=4) * [4, 0.3, 0.3, 1])))


# ---------------------------------------------------------------------------
# The lidar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pitch", [0.0, -0.3])
def test_lidar_matches_jax(pitch):
    lp = dict(n_beams=48, max_range=12.0, noise=0.01, pitch=pitch)
    for seed in range(4):
        pos = np.asarray([0.5 * seed, 0.2, 1.8], np.float32)
        rotm = _rot(seed)
        key = jax.random.PRNGKey(seed)
        want = jsensors.lidar_measure(jsensors.LidarParams(**lp), key, jnp.asarray(pos),
                                      jnp.asarray(rotm), ground_z=-0.5,
                                      sphere_centers=jnp.asarray(SCENE_C),
                                      sphere_radii=jnp.asarray(SCENE_R))
        normals = jax.random.normal(key, (48,), jnp.float32)
        got = sensors.lidar_measure(sensors.LidarParams(**lp), T(pos), T(rotm), ground_z=-0.5,
                                    sphere_centers=T(SCENE_C), sphere_radii=T(SCENE_R),
                                    noise=T(normals))
        close(got, want, TOL_LIDAR, f"seed {seed}")
        assert float(want.min()) < 11.0  # the scene is hit


def test_lidar_noise_is_a_philox_stream():
    lp = sensors.LidarParams(n_beams=48)
    seed, step = torch.tensor([7]), torch.tensor([3])
    z = sensors.lidar_noise(lp, seed, step)
    assert z.shape == (48,) and torch.equal(z, sensors.lidar_noise(lp, seed, step.clone()))
    assert not torch.equal(z, sensors.lidar_noise(lp, seed, step + 1))
    assert not torch.equal(z, sensors.lidar_noise(lp, seed + 1, step))
    assert abs(float(z.mean())) < 0.5 and 0.6 < float(z.std()) < 1.5
    pos, rotm = torch.tensor([0.0, 0.0, 1.8]), torch.eye(3)
    assert torch.equal(sensors.lidar_measure(lp, pos, rotm, seed=seed, step=step),
                       sensors.lidar_measure(lp, pos, rotm, noise=z))
    assert not torch.equal(sensors.lidar_measure(lp, pos, rotm, noise=z),
                           sensors.lidar_measure(lp, pos, rotm))


# ---------------------------------------------------------------------------
# The occupancy grid
# ---------------------------------------------------------------------------

GRID = dict(origin=(-1.0, -4.0, 0.8), resolution=0.25, shape=(48, 32, 8), n_free_samples=24,
            max_range=10.0)


def _near_face_samples(params, origin, ends, valid):
    """Ray samples (free samples and endpoints) within FACE_EPS of a voxel
    face, in float64."""
    origin, ends = np.float64(origin), np.float64(ends)
    delta = ends - origin
    length = np.linalg.norm(delta, axis=-1)
    scale = np.where(length > params.max_range, params.max_range / np.maximum(length, 1e-9), 1.0)
    capped = origin + delta * scale[:, None]
    n = params.n_free_samples
    fr = (np.arange(n) + 0.5) / (n + 1)
    pts = np.concatenate([(origin + (capped - origin)[:, None, :] * fr[None, :, None])
                          .reshape(-1, 3), ends])
    keep = np.concatenate([np.repeat(valid, n), valid])
    g = (pts - np.asarray(params.origin)) / params.resolution
    return int((np.abs(g - np.round(g)) * params.resolution < FACE_EPS).any(-1)[keep].sum())


def _ray_sets(n_sets=3, n_rays=64, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_sets):
        origin = np.asarray([0.3 * i, 0.1, 1.8], np.float32)
        d = rng.normal(size=(n_rays, 3)) * [1.0, 1.0, 0.15]
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        ends = (origin + d * rng.uniform(0.5, 13.0, size=(n_rays, 1))).astype(np.float32)
        valid = rng.uniform(size=n_rays) > 0.1
        yield origin, ends, valid


def test_insert_rays_matches_jax_voxel_for_voxel():
    jp, p = jocc.OccupancyParams(**GRID), occ.OccupancyParams(**GRID)
    jgrid, grid, near = jocc.init_grid(jp), occ.init_grid(p, device="cpu"), 0
    for origin, ends, valid in _ray_sets():
        jgrid = jocc.insert_rays(jp, jgrid, jnp.asarray(origin), jnp.asarray(ends),
                                 jnp.asarray(valid))
        grid = occ.insert_rays(p, grid, T(origin), T(ends), torch.tensor(valid))
        near += _near_face_samples(p, origin, ends, valid)
    want, got = np.asarray(jgrid.log_odds), N(grid.log_odds)
    differ = int((got != want).sum())
    assert (want > 0).sum() > 20 and (want < 0).sum() > 200  # hits and carving both landed
    assert differ <= 2 * near, f"{differ} voxels differ, {near} samples lie on a voxel face"


def test_occupied_centers_ties_match_top_k():
    """More voxels tie at the clamp and at one hit than there are slots:
    the export is the JAX one index for index."""
    rng = np.random.default_rng(1)
    lo = rng.choice([0.0, jocc.LOG_ODDS_MISS, jocc.LOG_ODDS_MIN], size=GRID["shape"])
    flat = lo.reshape(-1)
    flat[rng.choice(flat.size, 40, replace=False)] = jocc.LOG_ODDS_MAX
    flat[rng.choice(np.flatnonzero(flat == 0.0), 90, replace=False)] = jocc.LOG_ODDS_HIT
    lo = lo.astype(np.float32)
    jp, p = jocc.OccupancyParams(**GRID), occ.OccupancyParams(**GRID)
    jc, jr = jocc.occupied_centers(jp, jocc.OccupancyGrid(jnp.asarray(lo)), max_n=64)
    c, r = occ.occupied_centers(p, convert.grid_from_numpy(lo, device="cpu"), max_n=64)
    np.testing.assert_array_equal(N(c), np.asarray(jc))
    np.testing.assert_array_equal(N(r), np.asarray(jr))
    # slots past the occupied ones are inert
    c, r = occ.occupied_centers(p, convert.grid_from_numpy(np.minimum(lo, 0.0), device="cpu"))
    assert float(r.max()) == 0.0


def test_distance_field_matches_jax():
    rng = np.random.default_rng(2)
    lo = np.where(rng.uniform(size=GRID["shape"]) < 0.02, jocc.LOG_ODDS_MAX,
                  jocc.LOG_ODDS_MISS).astype(np.float32)
    jp, p = jocc.OccupancyParams(**GRID), occ.OccupancyParams(**GRID)
    jd = jocc.distance_field(jp, jocc.OccupancyGrid(jnp.asarray(lo)), max_dist=2.0)
    d = occ.distance_field(p, convert.grid_from_numpy(lo, device="cpu"), max_dist=2.0)
    close(d, jd, TOL_FIELD, "field")
    pts = (rng.uniform(size=(500, 3)) * [14, 10, 3] + [-2, -5, 0.5]).astype(np.float32)
    close(occ.query_distance(p, d, T(pts)), jocc.query_distance(jp, jd, jnp.asarray(pts)),
          TOL_FIELD, "query")
    close(occ.query(p, convert.grid_from_numpy(lo, device="cpu"), T(pts)),
          jocc.query(jp, jocc.OccupancyGrid(jnp.asarray(lo)), jnp.asarray(pts)), TOL_FIELD,
          "occupancy")


def test_voxel_centers_and_probabilities_match_jax():
    lo = np.random.default_rng(5).normal(size=GRID["shape"]).astype(np.float32)
    jp, p = jocc.OccupancyParams(**GRID), occ.OccupancyParams(**GRID)
    np.testing.assert_array_equal(occ.voxel_centers(p), jocc.voxel_centers(jp))
    close(occ.occupancy_prob(convert.grid_from_numpy(lo, device="cpu")),
          jocc.occupancy_prob(jocc.OccupancyGrid(jnp.asarray(lo))), TOL_FIELD, "probability")


def test_save_npz_round_trip_and_params_cross(tmp_path):
    lo = np.random.default_rng(3).normal(size=(4, 5, 6)).astype(np.float32)
    p = occ.OccupancyParams(origin=(0.0, 1.0, 2.0), resolution=0.5, shape=(4, 5, 6))
    occ.save_npz(str(tmp_path / "m.npz"), p, convert.grid_from_numpy(lo, device="cpu"))
    p2, g2 = occ.load_npz(str(tmp_path / "m.npz"), device="cpu")
    assert p2 == p and np.array_equal(N(g2.log_odds), lo)
    jp2, jg2 = jocc.load_npz(str(tmp_path / "m.npz"))
    assert np.array_equal(np.asarray(jg2.log_odds), lo) and tuple(jp2.shape) == p.shape
    cfg = convert.config_from_dict(jcfg.to_dict(jml.MappedFlightConfig()))
    assert cfg == ml.MappedFlightConfig()


# ---------------------------------------------------------------------------
# The mapped solver and the control step
# ---------------------------------------------------------------------------

def _jax_params(mode, k=64):
    cfg = jml.MappedFlightConfig()
    base = jms.MappedMPPIParams(altitude_weight=8.0, use_esdf=mode == "esdf",
                                esdf_params=cfg.grid)
    return dataclasses.replace(base, mppi=dataclasses.replace(base.mppi, n_samples=k))


def _port_params(jp):
    """The port's params of a JAX tree: the JAX schedule is a bare lambda,
    which ``to_dict`` refuses, so the tree crosses without it and gets the
    port's own schedule back."""
    p = convert.config_from_dict(jcfg.to_dict(dataclasses.replace(
        jp, mppi=dataclasses.replace(jp.mppi, sigma_scale_fn=None))))
    return dataclasses.replace(p, mppi=dataclasses.replace(
        p.mppi, sigma_scale_fn=ms.distance_to_go_scale))


def _lo_with_blobs():
    rng = np.random.default_rng(4)
    lo = np.where(rng.uniform(size=GRID["shape"]) < 0.5, jocc.LOG_ODDS_MISS, 0.0)
    lo[17:21, 14:19, 3:6] = jocc.LOG_ODDS_MAX   # a block astride the line ahead
    return lo.astype(np.float32)


@pytest.mark.parametrize("mode", ["spheres", "esdf"])
def test_mapped_solves_match_jax(mode):
    jp = _jax_params(mode)
    jstep, jinit = jms.make_mapped_solver(jp)
    step, init = ms.make_mapped_solver(_port_params(jp), device="cpu")
    lo = _lo_with_blobs()
    op = jocc.OccupancyParams(**GRID)
    jc, jr = jocc.occupied_centers(op, jocc.OccupancyGrid(jnp.asarray(lo)))
    jr = jnp.where(jr > 0, jr + 0.65, 0.0)
    jd = jocc.distance_field(op, jocc.OccupancyGrid(jnp.asarray(lo))) if mode == "esdf" \
        else None
    x, v, tgt = (np.asarray(a, np.float32) for a in ([0.5, 0.1, 1.8], [1.5, 0.2, 0.0],
                                                     [9.0, 0.0, 1.8]))
    jobs = jms.MappedObs(x=jnp.asarray(x), v=jnp.asarray(v), target=jnp.asarray(tgt),
                         obst_centers=jc, obst_radii=jr, dist_field=jd)
    obs = ms.MappedObs(x=T(x), v=T(v), target=T(tgt), obst_centers=T(jc), obst_radii=T(jr),
                       dist_field=None if jd is None else T(jd))
    js, s = jinit(jax.random.PRNGKey(6)), init(0)
    key, jstep = js.key, jax.jit(jstep)
    for i in range(3):
        key, z = shared_z(key, 64, 32, 3)
        jout, js = jstep(js, jobs)
        out, s = step(s, obs, T(z))
        for name in ("u_seq", "xdes", "vdes"):
            close(getattr(out, name), getattr(jout, name), TOL_SOLVE, f"solve {i}: {name}")


@pytest.mark.parametrize("mode", ["spheres", "esdf"])
def test_batched_solve_equals_unbatched(mode):
    """Two scenarios on two different maps in one batched solve
    (``n_scenarios=2``) against their unbatched solves, three solves on the
    Philox stream (1e-6 of the largest entry); each scenario must read its
    own obstacles or distance field: scenario 1 on map 0 solves otherwise."""
    p = _port_params(_jax_params(mode))
    step, init = ms.make_mapped_solver(p, device="cpu", n_scenarios=2)
    step1, init1 = ms.make_mapped_solver(p, device="cpu")
    op = occ.OccupancyParams(**GRID)
    maps = []
    for b, lo in enumerate((_lo_with_blobs(), np.roll(_lo_with_blobs(), -6, axis=0))):
        grid = occ.OccupancyGrid(T(lo))
        c, r = occ.occupied_centers(op, grid)
        maps.append((c, torch.where(r > 0, r + 0.65, 0.0), occ.distance_field(op, grid)))
    x = torch.tensor([[0.5, 0.1, 1.8], [1.0, -0.4, 1.7]])
    v = torch.tensor([[1.5, 0.2, 0.0], [1.0, -0.1, 0.05]])
    tgt = torch.tensor([[9.0, 0.0, 1.8], [8.0, 0.5, 1.8]])
    field = (lambda d: d) if mode == "esdf" else (lambda d: None)

    def one(b, m):
        return ms.MappedObs(x[b], v[b], tgt[b], maps[m][0], maps[m][1], field(maps[m][2]))

    obs = ms.MappedObs(x, v, tgt, torch.stack([m[0] for m in maps]),
                       torch.stack([m[1] for m in maps]),
                       field(torch.stack([m[2] for m in maps])))
    s, singles, wrong = init([3, 4]), [init1(3), init1(4)], init1(4)
    for i in range(3):
        out, s = step(s, obs)
        for b in range(2):
            res, singles[b] = step1(singles[b], one(b, b))
            for name in ("u_seq", "xdes", "vdes"):
                close(getattr(out, name)[b], N(getattr(res, name)), 1e-6, f"{i} {b} {name}")
        res_wrong, wrong = step1(wrong, one(1, 0))
        assert (res_wrong.u_seq - out.u_seq[1]).abs().max() > 1e-3


def _plant_to_port(jplant):
    return MultirotorState(*(T(x) for x in jplant))


@pytest.mark.parametrize("mode", ["spheres", "esdf"])
def test_control_steps_match_jax(mode):
    """20 control steps from the scenario's start, each on the JAX step's
    lidar normals and MPPI draw."""
    n, k = 20, 64
    jp = _jax_params(mode, k)
    cfg = jml.MappedFlightConfig()
    jstep = jax.jit(jml.make_mapped_control_step(cfg, jp))
    _, jinit = jms.make_mapped_solver(jp)
    jplant, jctrl, jgrid = jml.init_mapped_flight(cfg)
    jsol = jinit(jax.random.PRNGKey(0))
    ek, skey = jax.random.PRNGKey(1), jsol.key
    state = ml.MappedFlightState(
        plant=_plant_to_port(jplant), ctrl=fc.FlightCtrlState(*(T(x) for x in jctrl)),
        solver=convert.state_from_numpy(jsol.u_prev, jsol.sigma, 0, device="cpu"),
        grid=convert.grid_from_numpy(jgrid.log_odds, device="cpu"),
        lidar_seed=torch.tensor([0]), lidar_step=torch.tensor([0]))
    step = ml.make_mapped_control_step(convert.config_from_dict(jcfg.to_dict(cfg)),
                                       _port_params(jp), device="cpu")
    for i in range(n):
        ek, sub = jax.random.split(ek)
        skey, z = shared_z(skey, k, 32, 3)
        normals = jax.random.normal(sub, (cfg.lidar.n_beams,), jnp.float32)
        (jplant, jctrl, jsol, jgrid), (jpos, jclr) = jstep(jplant, jctrl, jsol, jgrid, sub)
        state, (pos, clr) = step(state, T(normals), T(z))
        close(pos, jpos, TOL_STEPS, f"step {i}: position")
        close(clr, jclr, TOL_STEPS, f"step {i}: clearance")
    # The plants part by float rounding, so a ray sample near a voxel face
    # may land on its other side: at most 1% of the touched voxels differ.
    want = np.asarray(jgrid.log_odds)
    touched = int((want != 0.0).sum())
    differ = int((N(state.grid.log_odds) != want).sum())
    assert touched > 300 and differ <= 0.01 * touched, (differ, touched)
    assert state.solver.step == n and state.lidar_step.tolist() == [n]


def test_esdf_params_must_match_the_grid():
    cfg = ml.MappedFlightConfig()
    bad = ms.MappedMPPIParams(use_esdf=True, esdf_params=occ.OccupancyParams())
    with pytest.raises(ValueError, match="wrong frame"):
        ml.make_mapped_control_step(cfg, bad, device="cpu")
    ml.make_mapped_control_step(cfg, ms.MappedMPPIParams(use_esdf=True), device="cpu")


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """A loop state saved after 6 steps and restored: the next 4 steps equal
    the uninterrupted run's, bit for bit, grid and noise streams included;
    ``run_mapped_flight``'s save_state/resume and its logs do the same."""
    run10, start = mapped_flight_episode(10, "cpu", n_samples=32)
    run6, _ = mapped_flight_episode(6, "cpu", n_samples=32)
    run4, _ = mapped_flight_episode(4, "cpu", n_samples=32)
    full, (pos, clr) = run10(start(3))
    mid, _ = run6(start(3))
    path = str(tmp_path / "mapped.npz")
    checkpoint.save(path, mid)
    back = checkpoint.restore(path, start(0))
    assert back.lidar_seed.tolist() == start(3).lidar_seed.tolist()
    end, (pos4, clr4) = run4(back)
    assert torch.equal(pos4, pos[6:]) and torch.equal(clr4, clr[6:])
    assert torch.equal(end.grid.log_odds, full.grid.log_odds)
    for a, b in zip(end.plant, full.plant):
        assert torch.equal(a, b)
    assert torch.equal(end.solver.u_prev, full.solver.u_prev)

    ck, logs = str(tmp_path / "run.npz"), {}
    r1 = run_mapped_flight(3, 6, "cpu", n_samples=32, save_state=ck)
    r2 = run_mapped_flight(3, 4, "cpu", n_samples=32, resume=ck, logs=logs)
    assert np.array_equal(logs["pos"], N(pos[6:]))
    assert r1["mapped_occupied_voxels"] > 0 and r2["steps"] == 4
    assert set(r2) == {"final_dist_m", "min_dist_m", "reached", "min_clearance_m", "collided",
                       "mapped_occupied_voxels", "steps"}


# ---------------------------------------------------------------------------
# The JAX package's occupancy and mapped-solver tests on the port
# ---------------------------------------------------------------------------

PARAMS = occ.OccupancyParams(origin=(-2.0, -2.0, -0.5), resolution=0.25, shape=(16, 16, 16),
                             n_free_samples=16, max_range=8.0)


def _scan_into_grid(grid, cam_pos, sphere=None, width=24, height=18, max_depth=40.0):
    """One noiseless downward depth-camera scan (``sim/depth_camera``, 90 deg
    horizontal FOV) of the ground plane z = 0 and an optional sphere,
    rendered and back-projected in float64 on the CPU and inserted into
    ``grid``: the JAX tests' scan."""
    p = dc.DepthCameraParams(width=width, height=height, max_depth=max_depth)
    pos = torch.tensor(cam_pos, dtype=torch.float64)
    down = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]],
                        dtype=torch.float64).T
    kw = {}
    if sphere is not None:
        kw = dict(sphere_centers=torch.tensor([sphere[0]], dtype=torch.float64),
                  sphere_radii=torch.tensor([sphere[1]], dtype=torch.float64))
    depth = dc.depth_render(p, pos, down, ground_z=0.0, **kw)
    pts, valid = dc.depth_to_points(p, depth, pos, down)
    return occ.insert_rays(PARAMS, grid, pos.float(), pts.float(), valid)


def test_ground_becomes_occupied_and_path_free():
    grid = occ.init_grid(PARAMS, device="cpu")
    for _ in range(3):
        grid = _scan_into_grid(grid, (0.0, 0.0, 2.0))
    assert float(occ.query(PARAMS, grid, torch.tensor([0.0, 0.0, 0.05]))) > 0.6
    assert float(occ.query(PARAMS, grid, torch.tensor([0.0, 0.0, 1.0]))) < 0.3
    assert float(occ.query(PARAMS, grid, torch.tensor([50.0, 0.0, 0.0]))) == 0.5


def test_sphere_obstacle_mapped():
    grid = occ.init_grid(PARAMS, device="cpu")
    for _ in range(3):
        grid = _scan_into_grid(grid, (0.0, 0.0, 3.0), sphere=((0.5, 0.5, 1.0), 0.4))
    assert float(occ.query(PARAMS, grid, torch.tensor([0.5, 0.5, 1.35]))) > 0.6
    assert float(occ.query(PARAMS, grid, torch.tensor([0.5, 0.5, 2.2]))) < 0.3
    _, radii = occ.occupied_centers(PARAMS, grid, max_n=32)
    live = radii > 0.0
    assert int(live.sum()) > 0 and bool((radii[live] > 0.2).all())


def test_max_range_only_carves():
    p = occ.OccupancyParams(origin=(-1.0, -1.0, -1.0), resolution=0.25, shape=(8, 8, 8),
                            n_free_samples=8, max_range=0.5)
    end = torch.tensor([[0.9, 0.0, 0.0]])
    grid = occ.insert_rays(p, occ.init_grid(p, device="cpu"), torch.zeros(3), end,
                           torch.tensor([True]))
    assert float(occ.query(p, grid, end[0])) <= 0.5
    assert float(occ.query(p, grid, torch.tensor([0.2, 0.0, 0.0]))) < 0.5


def test_log_odds_clamping():
    p = occ.OccupancyParams(origin=(-1.0, -1.0, -1.0), resolution=0.5, shape=(4, 4, 4),
                            n_free_samples=4, max_range=5.0)
    grid = occ.init_grid(p, device="cpu")
    for _ in range(50):
        grid = occ.insert_rays(p, grid, torch.tensor([-0.9, 0.0, 0.0]),
                               torch.tensor([[0.8, 0.0, 0.0]]), torch.tensor([True]))
    assert float(grid.log_odds.max()) <= occ.LOG_ODDS_MAX + 1e-5
    assert float(grid.log_odds.min()) >= occ.LOG_ODDS_MIN - 1e-5


def test_save_load_roundtrip(tmp_path):
    grid = _scan_into_grid(occ.init_grid(PARAMS, device="cpu"), (0.0, 0.0, 2.0))
    path = str(tmp_path / "map.npz")
    occ.save_npz(path, PARAMS, grid)
    params2, grid2 = occ.load_npz(path, device="cpu")
    assert params2.shape == PARAMS.shape
    np.testing.assert_allclose(N(grid2.log_odds), N(grid.log_odds))


def _solver(k, **kw):
    base = ms.MappedMPPIParams(**kw)
    params = dataclasses.replace(base, mppi=dataclasses.replace(base.mppi, n_samples=k))
    return params, *ms.make_mapped_solver(params, device="cpu")


def test_mapped_solver_avoids_dynamic_obstacles():
    params, step, init = _solver(512)
    x, target = torch.tensor([0.0, 0.0, 2.0]), torch.tensor([6.0, 0.0, 2.0])
    center = torch.tensor([[3.0, 0.0, 2.0]])

    def plan_clearance(radii):
        sol = init(0)
        obs = ms.MappedObs(x=x, v=torch.zeros(3), target=target, obst_centers=center,
                           obst_radii=radii)
        for _ in range(15):
            out, sol = step(sol, obs)
        traj, _ = integrators.double_integrate(out.u_seq[None], x, torch.zeros(3),
                                               params.mppi.dt)
        return float(torch.linalg.norm(traj[0] - center[0], dim=-1).min())

    free, blocked = plan_clearance(torch.tensor([0.0])), plan_clearance(torch.tensor([1.2]))
    assert blocked > free
    assert blocked > 1.0


def test_mapped_solver_inert_slots_do_not_repel():
    _, step, init = _solver(256)
    x, target = torch.tensor([0.0, 0.0, 2.0]), torch.tensor([4.0, 0.0, 2.0])

    def u_with(centers, radii):
        out, _ = step(init(1), ms.MappedObs(x=x, v=torch.zeros(3), target=target,
                                            obst_centers=centers, obst_radii=radii))
        return N(out.u_seq)

    on_path = torch.tensor([[2.0, 0.0, 2.0], [1.0, 0.0, 2.0]])
    np.testing.assert_allclose(u_with(on_path, torch.zeros(2)),
                               u_with(torch.zeros(2, 3), torch.zeros(2)), atol=1e-6)


def test_distance_field_chamfer():
    p = occ.OccupancyParams(origin=(0.0, 0.0, 0.0), resolution=0.5, shape=(12, 12, 6),
                            n_free_samples=4, max_range=10.0)
    lo = torch.zeros(12, 12, 6)
    lo[6, 6, 3] = occ.LOG_ODDS_MAX
    d = occ.distance_field(p, occ.OccupancyGrid(lo), max_dist=2.0)
    assert float(d[6, 6, 3]) == 0.0
    np.testing.assert_allclose(float(d[7, 6, 3]), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(d[6, 8, 3]), 1.0, atol=1e-6)
    np.testing.assert_allclose(float(d[7, 7, 3]), 1.0, atol=1e-6)
    assert float(d[0, 0, 0]) == 2.0
    assert float(occ.query_distance(p, d, torch.tensor([3.25, 3.25, 1.75]), 2.0)) == 0.0
    assert float(occ.query_distance(p, d, torch.tensor([100.0, 0.0, 0.0]), 2.0)) == 2.0


def test_distance_field_from_scanned_scene():
    grid = occ.init_grid(PARAMS, device="cpu")
    for _ in range(3):
        grid = _scan_into_grid(grid, (0.0, 0.0, 3.0), sphere=((0.5, 0.5, 1.0), 0.4))
    d = occ.distance_field(PARAMS, grid, max_dist=1.5)
    assert float(occ.query_distance(PARAMS, d, torch.tensor([0.5, 0.5, 1.55]), 1.5)) < 0.6
    assert float(occ.query_distance(PARAMS, d, torch.tensor([0.5, 0.5, 2.6]), 1.5)) > 1.0


def test_mapped_solver_esdf_cost_bends_plans():
    op = occ.OccupancyParams(origin=(-1.0, -3.0, 0.0), resolution=0.25, shape=(32, 24, 12),
                             n_free_samples=8, max_range=10.0)
    params, step, init = _solver(512, use_esdf=True, esdf_params=op)
    x, v0 = torch.tensor([0.0, 0.0, 1.5]), torch.tensor([2.5, 0.0, 0.0])
    target, center = torch.tensor([6.0, 0.0, 1.5]), torch.tensor([3.0, 0.0, 1.5])

    def plan_min_dist(lo):
        d = occ.distance_field(op, occ.OccupancyGrid(lo), max_dist=params.esdf_max_dist)
        sol = init(0)
        obs = ms.MappedObs(x=x, v=v0, target=target, obst_centers=torch.zeros(1, 3),
                           obst_radii=torch.zeros(1), dist_field=d)
        for _ in range(25):
            out, sol = step(sol, obs)
        traj, _ = integrators.double_integrate(out.u_seq[None], x, v0, params.mppi.dt)
        return float(torch.linalg.norm(traj[0] - center, dim=-1).min())

    free = plan_min_dist(torch.zeros(op.shape))
    (i, j, k), _ = occ._voxel_index(op, center)
    lo = torch.zeros(op.shape)
    lo[i - 1:i + 2, j - 1:j + 2, k - 1:k + 2] = occ.LOG_ODDS_MAX
    blocked = plan_min_dist(lo)
    assert free < 0.55
    assert blocked > free + 0.15
    assert blocked > params.esdf_margin * 0.6
