"""The port's noise: the plain Philox4x32-10 against Random123's published
known-answer vectors, the 24-bit inverse-CDF normals' moments and tail, the
stream's determinism per (seed, step), and the sigma shaping against the
JAX package's ``ops/sampling.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadrotor_manipulator_mppi_tpu.ops import sampling as jsampling
from quadrotor_manipulator_mppi_tpu_torch.ops import sampling

from torch_parity import N, T, torch_one_thread  # noqa: F401

# (counter words, key words) -> output words, from Random123's kat_vectors.
KAT = {
    "zeros": ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("name", sorted(KAT))
def test_philox_known_answers(name):
    ctr, key, want = KAT[name]
    got = sampling.philox4x32_10(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_philox_is_elementwise_over_counter_tensors():
    """A batch of counters gives, word for word, the scalar results."""
    c1 = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    batch = sampling.philox4x32_10((0, c1, 5, 0), (7, 9))
    for i, c in enumerate(c1.tolist()):
        one = sampling.philox4x32_10((0, c, 5, 0), (7, 9))
        assert [int(w[i]) for w in batch] == [int(w) for w in one]


def test_normals_moments_and_tail():
    z = sampling.philox_normals(0x1234_5678_9ABC_DEF0, 3, 2**16, 16, 1)
    assert z.shape == (1, 16, 2**16) and z.dtype == torch.float32
    assert abs(z.mean().item()) < 0.01
    assert abs(z.std().item() - 1.0) < 0.01
    assert z.abs().max().item() <= 5.5


def test_bits_to_normal_extremes_are_finite():
    z = sampling.bits_to_normal(torch.tensor([0, 2**31, 2**32 - 1], dtype=torch.int64))
    assert bool(torch.isfinite(z).all()) and z.abs().max().item() <= 5.5
    assert z[0].item() < 0 < z[2].item()
    np.testing.assert_allclose(N(z[0]), -N(z[2]), rtol=0, atol=0)


def test_stream_is_deterministic_per_seed_and_step():
    draw = lambda seed, step: sampling.philox_normals(seed, step, 64, 8, 11)  # noqa: E731
    torch.testing.assert_close(draw(5, 0), draw(5, 0), rtol=0, atol=0)
    for other in (draw(5, 1), draw(6, 0), draw(5 + 2**32, 0)):
        assert (other != draw(5, 0)).float().mean().item() > 0.99


def test_sigma_shaping_matches_jax(rng):
    key = jax.random.key(4)
    z = np.asarray(jax.random.normal(key, (32, 10, 11)))
    diag = rng.uniform(0.1, 2.0, size=11).astype(np.float32)
    full = rng.normal(size=(11, 11)).astype(np.float32)
    for sigma in (np.float32(0.3), diag, full):
        want = jsampling.sample_noise(key, 32, 10, 11, jnp.asarray(sigma))
        got = sampling.sample_noise(T(z), torch.as_tensor(sigma))
        np.testing.assert_allclose(N(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    noise = rng.normal(size=(32, 10, 11)).astype(np.float32)
    np.testing.assert_allclose(N(sampling.zero_mean_trick(T(noise))),
                               np.asarray(jsampling.zero_mean_trick(jnp.asarray(noise))),
                               atol=1e-6)
