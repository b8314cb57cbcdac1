"""State carried across from the JAX package, and back.

`to_torch(cls, state, device)` builds one of the port's NamedTuples
(`Bvh2`, `Bvh4`, `RasterScene`, `Camera`, `Transformation`, `Rays`, ...)
from a mapping or NamedTuple of array-likes: for a Bvh2, the field dict
that `tpu_bvh.utils.serialize.save_bvh` writes (packed_t, left, right,
root) or the JAX `Bvh2` itself, batch-stacked ones included (the leading
axis of `tpu_bvh.models.batched.build_batched`'s fields carries across);
for a Bvh4, the JAX `Bvh4` itself (slot_packed_t, child_t, parent,
child_count, n_nodes, leaf_prim, leaf_parent, root). The tensors land on
the GPU unless `device` says otherwise. `to_numpy(obj)` goes back to a
dict of numpy arrays. Integer fields that are not arrays
(RasterScene.n_real, leaf_size) pass through as ints.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _field(value, device):
    if isinstance(value, (int, np.integer)) and not isinstance(value, bool):
        return int(value)
    arr = np.asarray(value)
    if arr.dtype == np.uint32:  # u32 values (Morton codes) ride in int64
        arr = arr.astype(np.int64)
    return torch.as_tensor(np.array(arr, copy=True), device=device)


def to_torch(cls, state, device="cuda"):
    """`cls` instance with every field of `state` (a mapping or a
    NamedTuple) as a tensor on `device` (the GPU by default; pass
    device="cpu" for the plain paths)."""
    items = state if isinstance(state, Mapping) else state._asdict()
    return cls(**{f: _field(items[f], device) for f in cls._fields})


def to_numpy(obj) -> dict:
    """Dict of numpy arrays (ints pass through) from a port NamedTuple."""
    out = {}
    for f, v in obj._asdict().items():
        out[f] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    return out
