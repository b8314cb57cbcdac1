"""PLOC++ and HPLOC builders (the port of `tpu_bvh.models.ploc`).

Triangle soup -> extents, Morton codes and the sorted leaves (the LBVH's
front half, `lbvh._sorted_leaves_from_tris`) -> agglomerative
clustering (`ops.ploc.ploc_build_topology_packed`, the PLOC kernels on CUDA
tensors). The clustering emits the internal boxes itself, so no refit
follows. The root is node 0. Under a running profiler the front half is
the span `bvh.front_half` and the output's assembly `bvh.finalize`.
"""
from __future__ import annotations

import torch

from ..ops import ploc as ploc_ops
from ..types import Bvh2
from ..utils import timer
from . import lbvh

I32 = torch.int32
HPLOC_SHIFT0 = 9  # HPLOC's first segment shift
HPLOC_SHIFT_STEP = 6  # and its growth per round


def _build(tris, use_extended: bool, hploc: bool, shift0: int = HPLOC_SHIFT0,
           shift_step: int = HPLOC_SHIFT_STEP) -> Bvh2:
    """HPLOC's segment schedule starts at prefix shift `shift0` and grows by
    `shift_step` per round; plain PLOC ignores both (one segment)."""
    codes, leaf_packed_t, leaf_prim = lbvh._sorted_leaves_from_tris(tris, use_extended)
    n = leaf_prim.shape[0]
    left, right, int_packed_t = ploc_ops.ploc_build_topology_packed(
        leaf_packed_t, codes, hploc=hploc, shift0=shift0, shift_step=shift_step)
    dev = leaf_prim.device
    with timer.span("bvh.finalize"):
        return Bvh2(
            packed_t=torch.cat([int_packed_t, leaf_packed_t], dim=1),
            left=torch.cat([left, leaf_prim]),
            right=torch.cat([right, torch.full((n,), -1, dtype=I32, device=dev)]),
            root=torch.zeros((), dtype=I32, device=dev),
        )


def build_ploc(tris, use_extended: bool = True) -> Bvh2:
    """PLOC++ (`PLOC++Bvh.cpp`). tris: f32[N, 3, 3]."""
    return _build(tris, use_extended, hploc=False)


def build_hploc(tris, use_extended: bool = True) -> Bvh2:
    """HPLOC (`Hploc.cpp`): PLOC merges held inside Morton-prefix segments
    that coarsen bottom-up, from shift 9 by 6 bits a round."""
    return _build(tris, use_extended, hploc=True)
