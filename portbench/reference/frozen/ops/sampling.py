"""Control-noise sampling: sigma shaping and the Philox4x32-10 stream.

Randomness is explicit.  A solve either receives standard normals ``z``
(the parity path: tests hand both packages the same numbers) or draws them
from Philox4x32-10 with key = the solver state's 64-bit seed and counter =
(solve index, global sample index, action*H + t, 0), using output word 0.
The CUDA kernels (``csrc/philox.cuh``) draw the same stream; the functions
here are its plain version, in int64 arithmetic so they run on any device.
The kernels read their keys from a device tensor (:func:`philox_keys`).

A shard of the sample axis that starts at global sample ``sample_offset``
draws exactly its slice of the one-rank noise set, so a sample-sharded
solve equals the one-rank solve on the same seed up to summation order.
That is how shards decorrelate (the counterpart of the JAX package's
``fold_in`` of the shard index); a counter-based generator makes it free.

Normals use the 24-bit inverse-CDF form of the TPU kernel:
x = ((bits >> 8) - (2^23 - 0.5)) * 2^-23 is exact in float32 and lies in
+-(1 - 2^-24), so z = sqrt(2) * erfinv(x) is finite with |z| <= ~5.4.
"""

from __future__ import annotations

import functools
import math

import torch

Tensor = torch.Tensor

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments
_MASK = 0xFFFFFFFF


def sigma_matrix(sigma, n_action: int, dtype=torch.float32, device=None) -> Tensor:
    """Normalize a sigma spec (scalar | (A,) diagonal | (A, A) full) to (A, A)."""
    s = torch.as_tensor(sigma, dtype=dtype, device=device)
    if s.ndim == 0:
        return torch.eye(n_action, dtype=dtype, device=device) * s
    if s.ndim == 1:
        return torch.diag(s)
    return s


def sample_noise(z: Tensor, sigma: Tensor, batched: bool = False) -> Tensor:
    """Shape standard normals z (K, H, A) into eps = z @ Sigma; scalar or
    (A,) sigma take the elementwise path.  ``batched``: z (B, K, H, A) and
    sigma (B, A) or (B, A, A), one per scenario."""
    if not batched:
        if sigma.ndim <= 1:
            return z * sigma
        return torch.einsum("kha,ab->khb", z, sigma)
    if sigma.ndim <= 2:
        return z * sigma[:, None, None, :]
    return torch.einsum("bkha,bac->bkhc", z, sigma)


def zero_mean_trick(noise: Tensor) -> Tensor:
    """Subtract the sample mean so the noise population is exactly zero-mean
    (the sample axis of (..., K, H, A))."""
    return noise - torch.mean(noise, dim=-3, keepdim=True)


def _mulhilo(m: int, c: Tensor):
    """(hi, lo) 32-bit words of m * c for c in [0, 2^32), without leaving
    int64: m is split into 16-bit halves so no partial product overflows."""
    p1 = c * (m & 0xFFFF)
    p2 = c * (m >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (t >> 32), t & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 reference).

    ctr: four int64 tensors (or ints) holding 32-bit words; key: two ints,
    or two int64 tensors that broadcast against the counters (a key per
    problem, split on the device).  Returns the four output words as int64
    tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = ((k & _MASK) if isinstance(k, Tensor) else int(k) & _MASK for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_normal(bits: Tensor) -> Tensor:
    """32-bit words -> standard normals via the exact 24-bit erfinv form."""
    x = ((bits >> 8).to(torch.float32) - 8388607.5) * (1.0 / 8388608.0)
    return torch.erfinv(x) * math.sqrt(2.0)


_U64 = 0xFFFFFFFFFFFFFFFF


def philox_keys(seed, device) -> Tensor:
    """The kernels' Philox keys: a (B,) int64 tensor as it is (a batch's
    ``state.seed``), or one int seed as a (1,) tensor on ``device``, filled
    there without a host sync and kept for later calls with that seed (so
    never modify it in place: clone it first)."""
    if isinstance(seed, Tensor):
        return seed
    return _key_tensor(int(seed) & _U64, torch.device(device))


@functools.lru_cache(maxsize=64)
def _key_tensor(seed: int, device: torch.device) -> Tensor:
    signed = seed - (1 << 64) if seed >> 63 else seed  # the same 64 bits as int64
    return torch.full((1,), signed, dtype=torch.int64, device=device)


def step_tensor(step, device) -> Tensor:
    """A solve index as the kernels read it: an int64 tensor on ``device``.
    An int is written into a new (1,) tensor there by a fill, without a
    host sync; a tensor is returned as it is."""
    if isinstance(step, Tensor):
        return step
    return torch.full((1,), int(step), dtype=torch.int64, device=device)


def key_list(seeds: Tensor) -> list:
    """A key tensor's seeds as unsigned 64-bit host ints."""
    return [int(x) & _U64 for x in seeds.reshape(-1).tolist()]


def philox_normals(
    seed, step, n_samples: int, n_horizon: int, n_action: int,
    device=None, sample_offset: int = 0,
) -> Tensor:
    """Standard normals of solve ``step`` under ``seed`` for the global
    samples ``sample_offset .. sample_offset + n_samples - 1``, laid out
    (A, H, K) — sample index fastest, the layout the cost kernel spills.

    ``seed`` is an int, or a (B,) int64 key tensor (``philox_keys``): then
    the result is (B, A, H, K), scenario b drawn under key b.  The keys are
    split into their two 32-bit words on the device, with no host sync.
    ``step`` is an int, or an int64 tensor on the device: (1,), one solve
    index for every scenario, or (B,), one per scenario.  Either draws the
    same words as the int."""
    k = torch.arange(sample_offset, sample_offset + n_samples, dtype=torch.int64,
                     device=device)
    row = torch.arange(n_action * n_horizon, dtype=torch.int64, device=device)
    c1 = k.view(1, 1, -1).expand(n_action, n_horizon, n_samples)
    c2 = row.view(n_action, n_horizon, 1).expand(n_action, n_horizon, n_samples)
    batched = isinstance(seed, Tensor)
    if isinstance(step, Tensor):
        c0 = (step.to(torch.int64) & _MASK).view((-1, 1, 1, 1) if batched else (1, 1, 1))
    else:
        c0 = torch.full_like(c1, int(step) & _MASK)
    c3 = torch.zeros_like(c1)
    if batched:
        keys = seed.to(torch.int64).view(-1, 1, 1, 1)
        key = (keys, keys >> 32)  # the low word, and the high word (masked in philox4x32_10)
    else:
        key = (seed & _MASK, seed >> 32)
    bits, _, _, _ = philox4x32_10((c0, c1, c2, c3), key)
    return bits_to_normal(bits)
