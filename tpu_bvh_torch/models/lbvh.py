"""LBVH builders, single-pass (Apetrei layout) and two-pass (Karras
layout): the port of `tpu_bvh.models.lbvh`.

The front half (leaf boxes, the scene box, extended Morton codes, the
(code, prim_idx) sort and its gathers, `ops/front_half.py`), the topology
scan and the dense refit run hand-written kernels on CUDA tensors and
their plain PyTorch versions on the CPU. The single-pass tail on the card
(`radix_tree.apetrei_tree`) is three launches that write the finished
tree's arrays, so its Bvh2 needs no assembly.

`build_single_pass_bvh4` collapses the single-pass tree to a 4-wide BVH
(`ops/collapse_fast.py`, kernel B3 on the card).

Under a running profiler each build marks its front half (`bvh.front_half`,
with the sort and its gathers as `bvh.sort`), its topology and refit
(`bvh.topology`, `bvh.refit`), its output assembly (`bvh.finalize`; none
in the single-pass build on the card) and
the collapse (`bvh.collapse`, with B3 as `bvh.collapse_block`).
`last_build["host_syncs"]` holds the last build's device-to-host reads
(the extent copy; on the CPU the refit's long-node count and its
`nonzero`; the collapse's long-node count and, on the card, B3's error
flag), counted where they happen and tallied by `utils/timer.tally`.
"""
from __future__ import annotations

import torch

from ..ops import aabb, collapse_fast, front_half, radix_tree
from ..types import Bvh2, Bvh4, PrimRefs
from ..utils import timer

I32 = torch.int32
last_build = {"host_syncs": 0}


def prim_refs_from_triangles(tris) -> PrimRefs:
    """One reference per triangle (no split clipping)."""
    mn, mx = aabb.triangle_aabbs(tris)
    n = tris.shape[0]
    return PrimRefs(aabb_min=mn, aabb_max=mx,
                    prim_idx=torch.arange(n, dtype=I32, device=tris.device))


def _sorted_leaves_packed(refs: PrimRefs, use_extended: bool):
    """The front half from PrimRefs: (sorted_codes int64 [n] of u32 values,
    leaf_packed_t f32[6, n], the packed rows in sorted order, leaf_prim
    i32[n]); `ops/front_half.from_rows`."""
    with timer.span("bvh.front_half"):
        return front_half.from_rows(packed_rows(refs), refs.prim_idx, use_extended)


def packed_rows(refs: PrimRefs):
    """The references' boxes as rows f32[6, n]: min xyz, -max xyz."""
    return torch.cat([refs.aabb_min.T, -refs.aabb_max.T])


def _sorted_leaves_from_tris(tris, use_extended: bool):
    """Triangle-soup front end: the contract of `_sorted_leaves_packed`,
    prim i being triangle i; `ops/front_half.from_tris`."""
    with timer.span("bvh.front_half"):
        return front_half.from_tris(tris, use_extended)


def _finalize_packed(leaf_packed_t, leaf_prim, left, right, int_packed_t, root):
    """Internal rows then leaf rows; a leaf's `left` is its primitive."""
    n = leaf_prim.shape[0]
    with timer.span("bvh.finalize"):
        node_packed = torch.cat([int_packed_t, leaf_packed_t], dim=1)
        left = left.clone()
        left[n - 1:] = leaf_prim
        return Bvh2(packed_t=node_packed, left=left, right=right, root=root)


def _two_pass(codes, leaf_packed_t, leaf_prim) -> Bvh2:
    left, right, int_packed_t = radix_tree.karras_build_packed(codes, leaf_packed_t)
    root = torch.zeros((), dtype=I32, device=leaf_prim.device)
    return _finalize_packed(leaf_packed_t, leaf_prim, left, right, int_packed_t, root)


def build_two_pass(tris, use_extended: bool = True) -> Bvh2:
    """Two-pass (Karras-layout) LBVH: the single-pass scans and refit, then
    one relabel sort; the root is node 0. tris: f32[N, 3, 3]."""
    with timer.tally(last_build):
        return _two_pass(*_sorted_leaves_from_tris(tris, use_extended))


def build_two_pass_refs(refs: PrimRefs, use_extended: bool = True) -> Bvh2:
    """`build_two_pass` from PrimRefs."""
    with timer.tally(last_build):
        return _two_pass(*_sorted_leaves_packed(refs, use_extended))


def build_single_pass(tris, use_extended: bool = True) -> Bvh2:
    """Single-pass (Apetrei-layout) LBVH: internal node i sits at Morton
    boundary i; the root index is data-dependent. tris: f32[N, 3, 3]."""
    return build_single_pass_aux(tris, use_extended)[0]


def _single_pass(codes, leaf_packed_t, leaf_prim):
    """The single-pass tail: (Bvh2, parent, first, last)."""
    packed_t, left, right, parent, root, first, last = radix_tree.apetrei_tree(
        codes, leaf_packed_t, leaf_prim)
    return Bvh2(packed_t=packed_t, left=left, right=right, root=root), parent, first, last


def build_single_pass_refs(refs: PrimRefs, use_extended: bool = True) -> Bvh2:
    """`build_single_pass` from PrimRefs."""
    with timer.tally(last_build):
        return _single_pass(*_sorted_leaves_packed(refs, use_extended))[0]


def build_single_pass_aux(tris, use_extended: bool = True):
    """`build_single_pass` plus parent i32[2n-1] and the per-node leaf
    ranges first/last i32[n-1]."""
    with timer.tally(last_build):
        return _single_pass(*_sorted_leaves_from_tris(tris, use_extended))


def build_single_pass_bvh4(tris, use_extended: bool = True) -> Bvh4:
    """`build_single_pass` collapsed to a 4-wide BVH by the fast collapse
    (`collapse_fast.collapse_lbvh_to_bvh4`): wide node x keeps its bvh2
    id and the root is the bvh2 root. tris: f32[N, 3, 3], N >= 2."""
    with timer.tally(last_build):
        return collapse_fast.collapse_lbvh_to_bvh4(*build_single_pass_aux(tris, use_extended))
