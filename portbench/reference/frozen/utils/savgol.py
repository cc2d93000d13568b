"""Savitzky-Golay smoothing along the horizon axis.

Odd window, least-squares polynomial coefficients, reflect-flip edge padding
(``data[:p].flip, data, data[-p:].flip``), applied per DoF.  The padding is
folded into one dense (H, H) operator built once in float64 NumPy, so the
filter is a single matmul — the same design as the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def savgol_coefficients(window: int, polyorder: int) -> np.ndarray:
    """Central smoothing coefficients: the first row of ``(A^T A)^-1 A^T``
    for the centered Vandermonde ``A`` over the window."""
    if window % 2 != 1:
        raise ValueError("window must be odd")
    if polyorder >= window:
        raise ValueError("polyorder must be < window")
    half = window // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    a = np.stack([x**i for i in range(polyorder + 1)], axis=1)
    return np.linalg.lstsq(a, np.eye(window), rcond=None)[0][0]


@lru_cache(maxsize=None)
def savgol_matrix(horizon: int, window: int, polyorder: int) -> np.ndarray:
    """Dense (horizon, horizon) smoothing operator including edge padding:
    padding index ``-k`` maps to input ``k - 1`` and ``H - 1 + k`` to
    ``H - k`` (flip without repeating the edge sample)."""
    c = savgol_coefficients(window, polyorder)
    half = window // 2
    s = np.zeros((horizon, horizon))
    for t in range(horizon):
        for j, w in enumerate(c):
            src = t + j - half
            if src < 0:
                src = -src - 1
            elif src >= horizon:
                src = 2 * horizon - 1 - src
            s[t, src] += w
    return s


def smooth(seq: torch.Tensor, window: int, polyorder: int) -> torch.Tensor:
    """Smooth ``seq`` of shape [..., H, A] along the H axis (one matmul)."""
    s = torch.as_tensor(
        savgol_matrix(seq.shape[-2], window, polyorder),
        dtype=seq.dtype, device=seq.device,
    )
    return torch.matmul(s, seq)
