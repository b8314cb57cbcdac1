"""Dense anchored-refit stencil: the short-node unions and the level-4 row.

The contract of `tpu_bvh.ops.pallas.refit_dense.refit_dense_pallas`.
Input `mat` i32[8, s] holds rows 0-5 = packed leaf columns (min xyz,
-max xyz) as f32 bits, row 6 = first, row 7 = last (per boundary i).
For each column i:

* acc[:, i] = min of leaf columns j in [first, last] with
  i - R < j <= i + R (j = i counted when first <= i), columns j >= n
  read as +3e38 on the forward side (j > i);
* short[i] = (i - first < R) & (last - i <= R);
* t4[:, i] = min over leaves [i, i + 16), columns >= n taken as +3e38.

`refit_dense_cols(packed_t, first, last, n, radius)` is the same function
on the refit's own arrays (f32[6, n], i32[n - 1] twice; the edge column
n - 1 takes first = last = n - 1), so the refit builds no `mat`.
`refit_dense_nodes` is its tree mode: acc of the n - 1 internal columns
lands in the tree's boxes f32[6, 2n - 1], followed by the leaf columns
(the LBVH tail's second launch, `refit.refit_tree`).

Every min is `aabb.fmin` (`jnp.minimum`'s rule: -0.0 < +0.0, NaN
propagates), under which a min does not depend on the order of its
arguments, so every path is bit-exact. A CUDA tensor launches
`csrc/refit_dense.cu` (one launch; all three entries, counted in
`kernels.launches`);
a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda
from .aabb import fmin

BIG = 3.0e38
MAX_RADIUS = 128  # the contract's largest radius: the kernel's halo (kMaxHalo)
MIN_RADIUS = 15  # the t4 window needs 15 forward columns
TILE = 1024  # columns one block owns (kTile in csrc/refit_dense.cu)


def _check_radius(radius: int) -> None:
    if not MIN_RADIUS <= radius <= MAX_RADIUS:
        raise ValueError(f"radius {radius} outside [{MIN_RADIUS}, {MAX_RADIUS}]")


def refit_dense(mat, n: int, radius: int):
    """Returns (acc f32[6, s], short bool[s], t4 f32[6, s]); dispatch by device."""
    _check_radius(radius)
    if on_cuda(mat):
        s = mat.shape[1]
        kernels.require(mat, "mat", torch.int32, (8, s))
        return _launch(mat, mat[6], mat[7], s, n, radius)
    return refit_dense_reference(mat, n, radius)


def refit_dense_cols(packed_t, first, last, n: int, radius: int):
    """`refit_dense` on packed_t f32[6, n] and first/last i32[n - 1]."""
    _check_radius(radius)
    if on_cuda(packed_t):
        kernels.require(packed_t, "packed_t", torch.float32, (6, n))
        kernels.require(first, "first", torch.int32, (n - 1,))
        kernels.require(last, "last", torch.int32, (n - 1,))
        return _launch(packed_t, first, last, n - 1, n, radius)
    return refit_dense_cols_reference(packed_t, first, last, n, radius)


def refit_dense_nodes(packed_t, first, last, radius: int):
    """`refit_dense_cols` in its tree mode: (nodes f32[6, 2n - 1], short
    bool[n], t4 f32[n, 6]) where nodes holds acc of the internal columns
    [0, n - 1) and then the n leaf columns, and t4 a column's six words side
    by side; dispatch by device."""
    _check_radius(radius)
    n = packed_t.shape[1]
    if not on_cuda(packed_t):
        acc, short, t4 = refit_dense_cols_reference(packed_t, first, last, n, radius)
        return torch.cat([acc[:, :n - 1], packed_t], dim=1), short, t4.T.contiguous()
    kernels.require(packed_t, "packed_t", torch.float32, (6, n))
    kernels.require(first, "first", torch.int32, (n - 1,))
    kernels.require(last, "last", torch.int32, (n - 1,))
    dev = packed_t.device
    nodes = torch.empty((6, 2 * n - 1), dtype=torch.float32, device=dev)
    short = torch.empty((n,), dtype=torch.bool, device=dev)
    t4 = torch.empty((n, 6), dtype=torch.float32, device=dev)
    kernels.launch("refit_dense", "tbvh_refit_dense_nodes", packed_t, n, first, last, radius,
                   nodes, short, t4, like=packed_t,
                   count=lambda: work.refit_dense(packed_t, first, last, (nodes, short, t4)),
                   symbols="refit_dense_tile")
    return nodes, short, t4


def cols_mat(packed_t, first, last):
    """The `mat` of `refit_dense` for `refit_dense_cols`'s arguments."""
    edge = torch.full((1,), packed_t.shape[1] - 1, dtype=torch.int32, device=packed_t.device)
    return torch.cat([packed_t.contiguous().view(torch.int32), torch.cat([first, edge])[None],
                      torch.cat([last, edge])[None]])


def refit_dense_cols_reference(packed_t, first, last, n: int, radius: int):
    """Plain PyTorch version of `refit_dense_cols` (any device)."""
    return refit_dense_reference(cols_mat(packed_t, first, last), n, radius)


def refit_dense_reference(mat, n: int, radius: int):
    """Plain PyTorch version (any device): one masked shifted min per offset."""
    R = radius
    s = mat.shape[1]
    dev = mat.device
    cols = mat[0:6].contiguous().view(torch.float32)
    first = mat[6]
    last = mat[7]
    i = torch.arange(s, dtype=torch.int32, device=dev)
    la = last - i  # forward budget
    ab = i - first  # backward budget
    colsv = torch.where(i <= n - 1, cols, BIG)
    big = torch.full((6, R), BIG, dtype=torch.float32, device=dev)
    fwd = torch.cat([colsv, big], dim=1)  # fwd[:, i + d] = colsv[:, i + d]
    bwd = torch.cat([big, cols], dim=1)  # bwd[:, R + i - d] = cols[:, i - d]

    acc = torch.full((6, s), BIG, dtype=torch.float32, device=dev)
    t4 = colsv
    for d in range(1, R + 1):  # R >= 15 covers the t4 window
        w = fwd[:, d:d + s]
        if d < 16:
            t4 = fmin(t4, w)
        acc = torch.where(d <= la, fmin(acc, w), acc)
    for d in range(0, R):
        w = bwd[:, R - d:R - d + s]
        acc = torch.where(d <= ab, fmin(acc, w), acc)
    short = (ab < R) & (la <= R)
    return acc, short, t4


def _launch(cols, first, last, m_fl: int, n: int, radius: int):
    """One launch on column rows `cols` (6 rows of stride s) and the ranges
    of the first `m_fl` columns (the rest take first = last = n - 1)."""
    s = cols.shape[1]
    if not 1 <= n <= s:
        raise ValueError(f"refit_dense needs 1 <= n <= {s}, got {n}")
    dev = cols.device
    acc = torch.empty((6, s), dtype=torch.float32, device=dev)
    short = torch.empty((s,), dtype=torch.bool, device=dev)
    t4 = torch.empty((6, s), dtype=torch.float32, device=dev)
    kernels.launch("refit_dense", "tbvh_refit_dense", cols, s, first, last, m_fl, n, radius,
                   acc, short, t4, like=cols,
                   count=lambda: work.refit_dense(cols[0:6], first, last, (acc, short, t4)),
                   symbols="refit_dense_tile")
    return acc, short, t4
