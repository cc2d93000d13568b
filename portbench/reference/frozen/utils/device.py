"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A request
for CUDA on a machine without a card raises instead of carrying on quietly
on the CPU: a CPU run must always be something the caller asked for.
"""

from __future__ import annotations

import numpy as np
import torch


_CONSTS: dict = {}


def device_const(array, like: torch.Tensor) -> torch.Tensor:
    """A host constant (NumPy array or nested floats) as a tensor of
    ``like``'s dtype on ``like``'s device.  It is copied there once per
    process, keyed by its value, and reused after that, so a loop that asks
    for it again makes no host-to-device copy (a blocking copy would make
    the host wait for the card).  The result is shared: never modify it in
    place."""
    a = np.asarray(array, np.float64)
    key = (a.shape, a.tobytes(), like.dtype, like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(a, dtype=like.dtype).to(like.device)
    return t


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
