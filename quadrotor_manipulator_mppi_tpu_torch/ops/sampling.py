"""Control-noise sampling: sigma shaping and the Philox4x32-10 stream.

Randomness is explicit.  A solve either receives standard normals ``z``
(the parity path: tests hand both packages the same numbers) or draws them
from Philox4x32-10 with key = the solver state's 64-bit seed and counter =
(solve index, sample, action*H + t, 0), using output word 0.  The CUDA
kernel (``csrc/whole_body_kernel.cu``) draws the same stream; the functions
here are its plain version, in int64 arithmetic so they run on any device.

Normals use the 24-bit inverse-CDF form of the TPU kernel:
x = ((bits >> 8) - (2^23 - 0.5)) * 2^-23 is exact in float32 and lies in
+-(1 - 2^-24), so z = sqrt(2) * erfinv(x) is finite with |z| <= ~5.4.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_M0, _M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments
_MASK = 0xFFFFFFFF


def sample_noise(z: Tensor, sigma: Tensor) -> Tensor:
    """Shape standard normals z (K, H, A) into eps = z @ Sigma; scalar or
    (A,) sigma take the elementwise path."""
    if sigma.ndim <= 1:
        return z * sigma
    return torch.einsum("kha,ab->khb", z, sigma)


def zero_mean_trick(noise: Tensor) -> Tensor:
    """Subtract the sample mean so the noise population is exactly zero-mean."""
    return noise - torch.mean(noise, dim=0, keepdim=True)


def _mulhilo(m: int, c: Tensor):
    """(hi, lo) 32-bit words of m * c for c in [0, 2^32), without leaving
    int64: m is split into 16-bit halves so no partial product overflows."""
    p1 = c * (m & 0xFFFF)
    p2 = c * (m >> 16)
    t = p1 + ((p2 & 0xFFFF) << 16)
    return (p2 >> 16) + (t >> 32), t & _MASK


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11; the Random123 reference).

    ctr: four int64 tensors (or ints) holding 32-bit words; key: two ints.
    Returns the four output words as int64 tensors in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
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


def philox_normals(
    seed: int, step: int, n_samples: int, n_horizon: int, n_action: int,
    device=None,
) -> Tensor:
    """Standard normals of solve ``step`` under ``seed``, laid out (A, H, K)
    — sample index fastest, the layout the cost kernel spills."""
    k = torch.arange(n_samples, dtype=torch.int64, device=device)
    row = torch.arange(n_action * n_horizon, dtype=torch.int64, device=device)
    c1 = k.view(1, 1, -1).expand(n_action, n_horizon, n_samples)
    c2 = row.view(n_action, n_horizon, 1).expand(n_action, n_horizon, n_samples)
    c0 = torch.full_like(c1, int(step) & _MASK)
    c3 = torch.zeros_like(c1)
    bits, _, _, _ = philox4x32_10((c0, c1, c2, c3), (seed & _MASK, seed >> 32))
    return bits_to_normal(bits)
