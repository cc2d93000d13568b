"""The port's packed serving API: wire-format round trip, packed step ==
pytree step, and packed step == the JAX packed step (XLA backend) with the
JAX noise shared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.solver import serving as jserving
from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb
from quadrotor_manipulator_mppi_tpu_torch.solver import serving
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb

from torch_parity import N, T, shared_z, small, to_port, torch_one_thread  # noqa: F401

MODES = {"attitude": jwb.WholeBodyMPPIParams, "position": jwb.position_mode_params,
         "wrench": jwb.wrench_mode_params}


def _perturbed_port_obs():
    obs = twb.default_obs(device="cpu")
    base = obs.state.base._replace(
        pos=torch.tensor([0.3, -0.2, 2.4]), rpy=torch.tensor([0.05, -0.08, 0.4]),
        vel=torch.tensor([0.1, 0.2, -0.05]), omega=torch.tensor([0.01, -0.02, 0.03]),
    )
    return obs._replace(state=obs.state._replace(base=base, qdot=torch.full((7,), 0.1)))


def test_obs_roundtrip():
    obs = _perturbed_port_obs()
    obs_vec, target_vec = serving.pack_obs(obs)
    assert obs_vec.shape == (serving.OBS_SIZE,) and target_vec.shape == (serving.TARGET_SIZE,)
    back = serving.unpack_obs(obs_vec, target_vec)
    for a, b in ((obs.state.base.pos, back.state.base.pos), (obs.state.base.rpy, back.state.base.rpy),
                 (obs.state.base.vel, back.state.base.vel), (obs.state.base.omega, back.state.base.omega),
                 (obs.state.q, back.state.q), (obs.state.qdot, back.state.qdot),
                 (obs.ee_target.position, back.ee_target.position),
                 (obs.ee_target.quat, back.ee_target.quat), (obs.base_target, back.base_target)):
        np.testing.assert_allclose(N(b), N(a), atol=1e-5)


def test_wire_format_matches_jax():
    obs = _perturbed_port_obs()
    jobs = jwb.default_obs()
    b = obs.state.base
    jbase = jobs.state.base._replace(pos=jnp.asarray(N(b.pos)), rpy=jnp.asarray(N(b.rpy)),
                                     vel=jnp.asarray(N(b.vel)), omega=jnp.asarray(N(b.omega)))
    jobs = jobs._replace(state=jobs.state._replace(base=jbase, qdot=jnp.full(7, 0.1)))
    for got, want in zip(serving.pack_obs(obs), jserving.pack_obs(jobs)):
        np.testing.assert_allclose(N(got), np.asarray(want), atol=1e-6)
    vec = np.asarray(jserving.pack_obs(jobs)[0])
    tvec = np.asarray(jserving.pack_obs(jobs)[1])
    got, want = serving.unpack_obs(T(vec), T(tvec)), jserving.unpack_obs(jnp.asarray(vec), jnp.asarray(tvec))
    np.testing.assert_allclose(N(got.state.base.rpy), np.asarray(want.state.base.rpy), atol=1e-6)


def test_unpack_out():
    out = serving.unpack_out(torch.arange(25.0))
    assert out.u_seq is None
    np.testing.assert_array_equal(N(out.action), np.arange(11.0))
    np.testing.assert_array_equal(N(out.vdes), np.arange(18.0, 25.0))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_equals_pytree_step(mode):
    params = to_port(small(MODES[mode](), k=128, h=10))
    step, init = twb.make_whole_body_solver(params, device="cpu", low_k_guard="off")
    pstep, pinit = serving.make_packed_step(params, device="cpu", low_k_guard="off")
    state, carry = init(7), pinit(7)
    obs = twb.default_obs(device="cpu")
    obs_vec, target_vec = serving.pack_obs(obs)
    for _ in range(3):
        out, state = step(state, obs)
        out_vec, carry = pstep(carry, obs_vec, target_vec)
        np.testing.assert_allclose(N(out_vec[:11]), N(out.action), atol=2e-5)
        np.testing.assert_allclose(N(out_vec[11:18]), N(out.qdes), atol=2e-5)
        np.testing.assert_allclose(N(out_vec[18:25]), N(out.vdes), atol=2e-5)
        np.testing.assert_allclose(N(carry.u_prev), N(state.u_prev), atol=2e-5)
        assert (carry.seed, carry.step) == (state.seed, state.step)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_packed_matches_jax_packed(mode):
    jp = small(MODES[mode](), k=256, h=12)
    jstep, jinit = jserving.make_packed_step(jp, backend="xla", low_k_guard="off")
    pstep, pinit = serving.make_packed_step(to_port(jp), device="cpu", low_k_guard="off")
    jcarry, carry = jinit(jax.random.key(5)), pinit(5)
    key = jcarry.key
    obs_vec, target_vec = jserving.pack_obs(jwb.default_obs())
    for _ in range(3):
        key, z = shared_z(key, 256, 12)
        jout, jcarry = jstep(jcarry, obs_vec, target_vec)
        out, carry = pstep(carry, T(obs_vec), T(target_vec), z)
        np.testing.assert_allclose(N(out), np.asarray(jout), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(N(carry.u_prev), np.asarray(jcarry.u_prev), rtol=2e-3, atol=2e-3)


def test_static_targets_variant():
    params = to_port(small(jwb.position_mode_params(), k=128, h=10))
    obs = twb.default_obs(device="cpu")
    pstep_d, pinit = serving.make_packed_step(params, device="cpu")
    pstep_s, _ = serving.make_packed_step(params, device="cpu",
                                          static_targets=(obs.ee_target, obs.base_target))
    pstep_o, _ = serving.make_packed_step(params, device="cpu", static_targets=obs)
    obs_vec, target_vec = serving.pack_obs(obs)
    out_d, _ = pstep_d(pinit(3), obs_vec, target_vec)
    out_s, _ = pstep_s(pinit(3), obs_vec)
    out_o, _ = pstep_o(pinit(3), obs_vec)
    np.testing.assert_allclose(N(out_d), N(out_s), atol=1e-6)
    np.testing.assert_allclose(N(out_o), N(out_s), atol=0)


def test_packed_rejects_adaptive_sigma():
    import dataclasses

    p = to_port(small(jwb.position_mode_params()))
    p = dataclasses.replace(p, mppi=dataclasses.replace(p.mppi, adaptive_sigma=True,
                                                        sigma_scale_fn=None))
    with pytest.raises(ValueError, match="adaptive_sigma"):
        serving.make_packed_step(p, device="cpu")
