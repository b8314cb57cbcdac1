"""Dense anchored-refit stencil: the short-node unions and the level-4 row.

The contract of `tpu_bvh.ops.pallas.refit_dense.refit_dense_pallas`.
Input `mat` i32[8, s] holds rows 0-5 = packed leaf columns (min xyz,
-max xyz) as f32 bits, row 6 = first, row 7 = last (per boundary i).
For each column i:

* acc[:, i] = min of leaf columns j in [first, last] with
  i - R < j <= i + R (j = i counted when first <= i);
* short[i] = (i - first < R) & (last - i <= R);
* t4[:, i] = min over leaves [i, i + 16), columns >= n taken as +3e38.

Only min operations are involved, so every path is bit-exact. A CUDA
tensor launches `csrc/refit_dense.cu`; a CPU tensor takes
`refit_dense_reference`.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from ..utils.platform import on_cuda

BIG = 3.0e38
_HALO = 128  # largest radius the contract allows
launches = 0  # kernel launches by `refit_dense` since the last reset


def refit_dense(mat, n: int, radius: int):
    """Returns (acc f32[6, s], short bool[s], t4 f32[6, s]); dispatch by device."""
    if not 15 <= radius <= _HALO:
        raise ValueError(f"radius {radius} outside [15, {_HALO}]")
    if on_cuda(mat):
        return _refit_dense_cuda(mat, n, radius)
    return refit_dense_reference(mat, n, radius)


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
            t4 = torch.minimum(t4, w)
        acc = torch.where(d <= la, torch.minimum(acc, w), acc)
    for d in range(0, R):
        w = bwd[:, R - d:R - d + s]
        acc = torch.where(d <= ab, torch.minimum(acc, w), acc)
    short = (ab < R) & (la <= R)
    return acc, short, t4


def _refit_dense_cuda(mat, n: int, radius: int):
    global launches
    s = mat.shape[1]
    kernels.require(mat, "mat", torch.int32, (8, s))
    if not 1 <= n <= s:
        raise ValueError(f"refit_dense needs 1 <= n <= {s}, got {n}")
    dev = mat.device
    acc = torch.empty((6, s), dtype=torch.float32, device=dev)
    short = torch.empty((s,), dtype=torch.bool, device=dev)
    t4 = torch.empty((6, s), dtype=torch.float32, device=dev)
    err = kernels.lib().tbvh_refit_dense(
        mat.data_ptr(), s, n, radius, acc.data_ptr(), short.data_ptr(),
        t4.data_ptr(), kernels.stream_of(mat),
    )
    kernels.check("tbvh_refit_dense", err)
    launches += 1
    return acc, short, t4
