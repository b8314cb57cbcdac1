"""The front half of the LBVH and PLOC builds: leaf boxes, the scene box,
Morton codes, the (code, prim) sort and its gathers.

On CUDA tensors it is three hand-written launches around `torch.sort`
(`csrc/front_half.cu`):

* A, `tri_rows`: the triangles' packed rows f32[6, n] (min xyz, -max
  xyz; `aabb.packed_bounds` bit for bit) and the scene box, scene_min and
  extent f32[3] each, reduced exactly on `aabb.min_key` integers in the
  same launch;
* the host step: one copy of the extent and `morton.bit_budget` (the
  extended code only);
* B, `keys`: the biased key (code - 2^31) * 2^32 + prim i64[n], whose
  signed order is the (u32 code, prim) order;
* `torch.sort(key)`, then C, `gather`: the sorted codes, the rows in
  sorted order and leaf_prim (the key's low 32 bits). From triangles the
  low bits are also each leaf's position before the sort, so C reads no
  `pos`.

A CPU tensor takes the plain PyTorch version of each step (`*_reference`,
which run on either device), the ops the JAX package is held to. The
kernels give the same bits; the scene box's min of +0.0 and -0.0 may
differ in its sign (`amin` keeps either), which changes no code.

The PrimRefs route (`from_rows`) starts from packed rows: its scene box
is the plain reduction, and B and C follow. `last_build["launches"]`
holds the hand-written launches of the last front half (on CUDA 3 from
triangles, 2 from rows; 0 on the CPU), `kernels.launches` each kernel's.
"""
from __future__ import annotations

import torch

from ..utils import kernels, timer, work
from ..utils.platform import on_cuda
from . import aabb, morton

I32 = torch.int32
last_build = {"launches": 0}
_scratch = {}  # (device, stream) -> the box kernel's i32 keys [6] and counter [1]


def tri_rows_reference(tris):
    """(rows f32[6, n], scene_min f32[3], extent f32[3]) of tris f32[n, 3, 3]."""
    rows = aabb.packed_bounds(tris.permute(1, 2, 0), 0, 1)
    return (rows, *row_box(rows))


def row_box(rows):
    """(scene_min, extent) of packed rows f32[6, n]."""
    scene_min = rows[0:3].amin(dim=1)
    return scene_min, (-rows[3:6]).amax(dim=1) - scene_min


def keys_reference(rows, prim_idx, scene_min, ext, use_extended: bool):
    """The sort key i64[n] of each box's centroid; prim_idx None is arange.
    (code, prim) is unique, so one sort of the key gives the canonical
    order; the code is biased by -2^31 so the signed key keeps the
    unsigned order of the u32 code."""
    mn, mx = rows[0:3], -rows[3:6]
    safe = torch.where(ext > 0, ext, 1.0)
    nx, ny, nz = ((mn + mx) * 0.5 - scene_min[:, None]) / safe[:, None]
    if use_extended:
        codes = morton.extended_morton30_cols(nx, ny, nz, ext)
    else:
        codes = morton.morton30_cols(nx, ny, nz)
    if prim_idx is None:
        prim_idx = torch.arange(rows.shape[1], dtype=I32, device=rows.device)
    return (codes - (1 << 31)) * (1 << 32) + prim_idx.to(torch.int64)


def gather_reference(skey, pos, rows, prim_idx):
    """(sorted codes i64[n] of u32 values, rows[:, pos], prim_idx[pos]);
    prim_idx None is arange."""
    leaf_prim = pos.to(I32) if prim_idx is None else prim_idx[pos]
    return (skey >> 32) + (1 << 31), rows[:, pos], leaf_prim


def _box_work(device):
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    if key not in _scratch:  # the keys start at INT_MAX, the counter at 0; each launch resets both
        _scratch[key] = (torch.full((6,), torch.iinfo(I32).max, dtype=I32, device=device),
                         torch.zeros(1, dtype=I32, device=device))
    return _scratch[key]


def tri_rows(tris):
    """`tri_rows_reference`; kernel A on a CUDA tensor."""
    if not on_cuda(tris):
        return tri_rows_reference(tris)
    n = tris.shape[0]
    tris = tris.contiguous()  # a strided view is copied; a dense soup is read in place
    kernels.require(tris, "tris", torch.float32, (n, 3, 3))
    _check_n(n)
    rows = torch.empty((6, n), dtype=torch.float32, device=tris.device)
    box = torch.empty(6, dtype=torch.float32, device=tris.device)
    scratch, done = _box_work(tris.device)
    kernels.launch("front_tri_box", "tbvh_front_tri_box", tris, n, rows, scratch, done, box,
                   like=tris, count=lambda: work.front_half("tri_box", n),
                   symbols="front_box_kernel")
    return rows, box[0:3], box[3:6]


def keys(rows, prim_idx, scene_min, ext, use_extended: bool):
    """`keys_reference`; kernel B on CUDA tensors, after the extent's copy
    to the host (the extended code only)."""
    if not on_cuda(rows):
        return keys_reference(rows, prim_idx, scene_min, ext, use_extended)
    n = rows.shape[1]
    kernels.require(rows, "rows", torch.float32, (6, n))
    kernels.require(scene_min, "scene_min", torch.float32, (3,))
    kernels.require(ext, "ext", torch.float32, (3,))
    if prim_idx is not None:
        kernels.require(prim_idx, "prim_idx", I32, (n,))
    _check_n(n)
    if use_extended:
        b = morton.bit_budget(ext)  # the extent to the host: the one host sync
        budget = (1, *b.start_axis, b.bits_x, b.bits_y, b.bits_z, b.pre_x, b.pre_y,
                  int(b.use_swap), int(b.prebits_sum > 0))
    else:
        budget = (0,) * 11
    key = torch.empty(n, dtype=torch.int64, device=rows.device)
    kernels.launch("front_keys", "tbvh_front_keys", rows, n, prim_idx, scene_min, ext, *budget,
                   key, like=rows,
                   count=lambda: work.front_half("keys", n, refs=prim_idx is not None),
                   symbols="front_keys_kernel")
    return key


def gather(skey, pos, rows, prim_idx):
    """`gather_reference`; kernel C on CUDA tensors (leaf_prim from the
    key's low bits, which hold prim_idx[pos]; with prim_idx None they are
    pos itself, and C reads no pos)."""
    if not on_cuda(skey):
        return gather_reference(skey, pos, rows, prim_idx)
    n = skey.shape[0]
    kernels.require(skey, "skey", torch.int64, (n,))
    kernels.require(pos, "pos", torch.int64, (n,))
    kernels.require(rows, "rows", torch.float32, (6, n))
    dev = skey.device
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    leaf = torch.empty((6, n), dtype=torch.float32, device=dev)
    leaf_prim = torch.empty(n, dtype=I32, device=dev)
    refs = prim_idx is not None
    kernels.launch("front_gather", "tbvh_front_gather", skey, pos if refs else None, rows, n,
                   codes, leaf, leaf_prim, like=skey,
                   count=lambda: work.front_half("gather", n, refs=refs),
                   symbols="front_gather_kernel")
    return codes, leaf, leaf_prim


def _check_n(n: int) -> None:
    if not 1 <= n < 1 << 31:
        raise ValueError(f"the front half needs 1 <= n < 2^31 primitives, got {n}")


def _sorted(rows, prim_idx, scene_min, ext, use_extended):
    key = keys(rows, prim_idx, scene_min, ext, use_extended)
    with timer.span("bvh.sort"):
        skey, pos = torch.sort(key)
        return gather(skey, pos, rows, prim_idx)


def from_tris(tris, use_extended: bool):
    """(sorted_codes i64[n] of u32 values, leaf_packed_t f32[6, n],
    leaf_prim i32[n]) of a triangle soup f32[n, 3, 3]; prim i is triangle i."""
    with timer.tally(last_build):
        rows, scene_min, ext = tri_rows(tris)
        return _sorted(rows, None, scene_min, ext, use_extended)


def from_rows(rows, prim_idx, use_extended: bool):
    """`from_tris`' contract from packed rows f32[6, n] and prim_idx i32[n]."""
    with timer.tally(last_build):
        return _sorted(rows, prim_idx, *row_box(rows), use_extended)


def from_tris_reference(tris, use_extended: bool):
    """`from_tris` by the plain steps alone, on either device."""
    rows, scene_min, ext = tri_rows_reference(tris)
    skey, pos = torch.sort(keys_reference(rows, None, scene_min, ext, use_extended))
    return gather_reference(skey, pos, rows, None)


def from_rows_reference(rows, prim_idx, use_extended: bool):
    """`from_rows` by the plain steps alone, on either device."""
    skey, pos = torch.sort(keys_reference(rows, prim_idx, *row_box(rows),
                                          use_extended))
    return gather_reference(skey, pos, rows, prim_idx)
