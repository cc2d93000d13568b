"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU.  A request
for CUDA on a machine without a card raises instead of carrying on quietly
on the CPU: a CPU run must always be something the caller asked for.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev
