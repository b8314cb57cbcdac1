"""BVH serialization: save a built tree, reload it for traversal-only runs
(the port of `tpu_bvh.utils.serialize`).

An `.npz` of the NamedTuple's fields under their own names plus
`__kind__`, the keys the JAX package writes, so a tree saved by either
package loads in the other with the same bytes (the port's Bvh2 and Bvh4
have JAX's fields, dtypes and layouts).
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import Bvh2, Bvh4

_TYPES = {"Bvh2": Bvh2, "Bvh4": Bvh4}


def save_bvh(path: str, bvh) -> None:
    kind = type(bvh).__name__
    if kind not in _TYPES:
        raise TypeError(f"unsupported type {kind}")
    arrays = {f: v.detach().cpu().numpy() for f, v in zip(bvh._fields, bvh)}
    np.savez_compressed(path, __kind__=np.array(kind), **arrays)


def load_bvh(path: str, device="cuda"):
    """The saved Bvh2 or Bvh4 with its tensors on `device` (the GPU unless
    the caller names another). A Bvh4 written before JAX's `root` field
    existed gets JAX's default root, 0."""
    with np.load(path) as data:
        cls = _TYPES[str(data["__kind__"])]
        fields = {f: torch.from_numpy(np.array(data[f])).to(device)
                  for f in cls._fields if f in data}
    if cls is Bvh4 and "root" not in fields:
        fields["root"] = torch.zeros((), dtype=torch.int32, device=device)
    return cls(**fields)
