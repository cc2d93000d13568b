"""Shared helpers for the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to the JAX package and to
the PyTorch port alike; noise is shared by reproducing the JAX solver's key
split and passing the standard normals it draws to the port as ``z``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu import config as jcfg
from quadrotor_manipulator_mppi_tpu_torch import convert
from quadrotor_manipulator_mppi_tpu_torch.models.multirotor import Multirotor12State
from quadrotor_manipulator_mppi_tpu_torch.models.whole_body import WholeBodyState
from quadrotor_manipulator_mppi_tpu_torch.solver import whole_body as twb
from quadrotor_manipulator_mppi_tpu_torch.utils.pose import Pose


@pytest.fixture(autouse=True)
def torch_one_thread():
    torch.set_num_threads(1)


def T(x) -> torch.Tensor:
    """numpy / JAX array -> float32 CPU tensor (a private copy)."""
    return torch.tensor(np.array(x, dtype=np.float32))


def N(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def small(params, k=256, h=12):
    return dataclasses.replace(
        params, mppi=dataclasses.replace(params.mppi, n_samples=k, n_horizon=h)
    )


def to_port(jax_params):
    """The port's params for a JAX params tree, through config.to_dict."""
    return convert.params_from_dict(jcfg.to_dict(jax_params))


def obs_to_port(jobs) -> "twb.WholeBodyObs":
    b = jobs.state.base
    return twb.WholeBodyObs(
        state=WholeBodyState(
            base=Multirotor12State(T(b.pos), T(b.rpy), T(b.vel), T(b.omega)),
            q=T(jobs.state.q), qdot=T(jobs.state.qdot),
        ),
        ee_target=Pose(T(jobs.ee_target.position), T(jobs.ee_target.quat)),
        base_target=T(jobs.base_target),
    )


def shared_z(key, k, h, a=11):
    """The JAX solver's draw for a step from ``key``: (next key, z numpy)."""
    key, sub = jax.random.split(key)
    return key, np.array(jax.random.normal(sub, (k, h, a)))


def perturbed_obs(jobs, rpy=(0.08, -0.05, 0.3), omega=(0.2, -0.1, 0.05),
                  vel=(0.3, 0.0, -0.1)):
    import jax.numpy as jnp

    base = jobs.state.base._replace(
        rpy=jnp.asarray(rpy), omega=jnp.asarray(omega), vel=jnp.asarray(vel)
    )
    return jobs._replace(state=jobs.state._replace(base=base))


def wrench_params(k=256, h=12, couple=True):
    """The JAX kernel tests' generic wrench config (no bounds, no schedule)."""
    from quadrotor_manipulator_mppi_tpu.solver import whole_body as jwb

    base = jwb.WholeBodyMPPIParams()
    mppi = dataclasses.replace(
        base.mppi, n_samples=k, n_horizon=h, sigma=jwb.wrench_sigma(),
        u_min=None, u_max=None,
        nominal_action=np.concatenate(
            [[jwb.default_nominal_action()[0]], np.zeros(jwb.N_ACTIONS - 1)]
        ),
        sigma_scale_fn=None,
    )
    return dataclasses.replace(
        base, mppi=mppi,
        model=dataclasses.replace(base.model, control_mode="wrench",
                                  couple_arm_gravity=couple),
    )
