"""Inclusive min/max scan of an i32[m, V] plane along axis 0 (the rows),
forward or from the bottom.

The contract of `tpu_bvh.ops.pallas.plane_scan.plane_scan`. A CUDA tensor
launches `csrc/plane_scan.cu`; a CPU tensor takes `plane_scan_reference`,
a Hillis-Steele doubling over the rows (what the TPU kernel does inside a
chunk). One PyTorch call computes the same function (`torch.cummin` /
`torch.cummax` along dim 0); `chip_smoke.py` times it as the yardstick,
and the port does not call it.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from ..utils.platform import on_cuda

_SEG_ROWS = 256  # rows per block of csrc/plane_scan.cu (4 segments of 64)
launches = 0  # kernel launches by `plane_scan` since the last reset


def plane_scan(x, *, is_min: bool, reverse: bool):
    """Inclusive cummin (is_min) or cummax of x i32[m, V] along axis 0;
    `reverse=True` scans from the bottom. Dispatch by device."""
    if on_cuda(x):
        return _plane_scan_cuda(x, is_min, reverse)
    return plane_scan_reference(x, is_min=is_min, reverse=reverse)


plane_scan_auto = plane_scan  # the TPU's size gate does not apply here


def plane_scan_reference(x, *, is_min: bool, reverse: bool):
    """Plain PyTorch version (any device): log2(m) shifted min/max steps."""
    op = torch.minimum if is_min else torch.maximum
    m = x.shape[0]
    k = 1
    while k < m:
        if reverse:
            x = torch.cat([op(x[:-k], x[k:]), x[m - k:]])
        else:
            x = torch.cat([x[:k], op(x[k:], x[:-k])])
        k <<= 1
    return x


def _plane_scan_cuda(x, is_min: bool, reverse: bool):
    global launches
    if x.dim() != 2:
        raise ValueError(f"plane_scan: expected a 2-D plane, got shape {tuple(x.shape)}")
    m, v = x.shape
    kernels.require(x, "x", torch.int32, (m, v))
    if m < 1 or v < 1:
        raise ValueError(f"plane_scan needs a non-empty plane, got shape {(m, v)}")
    segs = (m + _SEG_ROWS - 1) // _SEG_ROWS * 4
    work = torch.empty(2 * segs * v, dtype=torch.int32, device=x.device)
    out = torch.empty_like(x)
    err = kernels.lib().tbvh_plane_scan(x.data_ptr(), m, v, int(is_min), int(reverse),
                                        work.data_ptr(), work[segs * v:].data_ptr(),
                                        out.data_ptr(), kernels.stream_of(x))
    kernels.check("tbvh_plane_scan", err)
    launches += 1
    return out
