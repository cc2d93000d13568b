"""Checkpoint and resume of solver and simulation state.

Port of the JAX package's ``utils/checkpoint.py``: any pytree of the port
(tensors and ints in tuples, lists and NamedTuples; an MPPI solver state, a
closed-loop state) is written to one ``.npz``, and restored into a tree of
the same structure.  The Philox seed and the solve index are kept as they
were saved (ints, or int64 tensors), so a resumed solve continues the same
noise stream.
"""

from __future__ import annotations

import json
import os
from typing import Any, List

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _rebuild(like: Any, leaves: List[Any]) -> Any:
    if isinstance(like, (tuple, list)):
        parts = [_rebuild(x, leaves) for x in like]
        if hasattr(like, "_fields"):
            return type(like)(*parts)
        return type(like)(parts)
    return leaves.pop(0)


def save(path: str, tree: Any) -> None:
    """Save the pytree ``tree`` to ``path`` (.npz): each tensor as an array
    with its dtype, each int exactly (any 64-bit seed)."""
    arrays, kinds = {}, []
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            arrays[f"leaf_{i}"] = leaf.detach().cpu().numpy()
            kinds.append("tensor")
        elif leaf is None:
            kinds.append("none")
        elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
            kinds.append(str(int(leaf)))
        else:
            raise TypeError(f"cannot checkpoint a {type(leaf).__name__}")
    meta = json.dumps({"kinds": kinds})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)


def restore(path: str, like: Any, device=None) -> Any:
    """Restore a pytree saved by :func:`save` in the structure of ``like``
    (a fresh initial state).  A tensor goes to its ``like`` leaf's device
    (or ``device``, where that leaf is not a tensor); an int comes back an
    int."""
    with np.load(path) as data:
        kinds = json.loads(bytes(data["__meta__"]).decode())["kinds"]
        refs = _leaves(like)
        if len(kinds) != len(refs):
            raise ValueError(f"checkpoint has {len(kinds)} leaves, the target tree {len(refs)}")
        out = []
        for i, (kind, ref) in enumerate(zip(kinds, refs)):
            if kind == "tensor":
                dev = ref.device if isinstance(ref, torch.Tensor) else (device or "cpu")
                out.append(torch.from_numpy(data[f"leaf_{i}"].copy()).to(dev))
            else:
                out.append(None if kind == "none" else int(kind))
    return _rebuild(like, out)
