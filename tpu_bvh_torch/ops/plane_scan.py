"""Inclusive min/max scan of an i32[m, V] plane along axis 0 (the rows),
forward or from the bottom.

The contract of `tpu_bvh.ops.pallas.plane_scan.plane_scan`. A CUDA tensor
launches `csrc/plane_scan.cu` (one launch: a chained scan with decoupled
look-back); a CPU tensor takes `plane_scan_reference`, a Hillis-Steele
doubling over the rows (what the TPU kernel does inside a chunk). The
port's caller is the sharded build (`parallel/sharded_build.py`), whose psv
and nsv are a forward max and a reverse min over [L, 64] threshold planes,
as JAX's `lax.cummax` / `lax.cummin` there. One PyTorch call computes the
same function (`torch.cummin` / `torch.cummax` along dim 0);
`chip_smoke.py` times it as the yardstick, and the port does not call it.
"""
from __future__ import annotations

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda

TILE_ROWS = 128  # rows per tile of csrc/plane_scan.cu (kRows)
COLS = 64  # columns per strip of csrc/plane_scan.cu (kCols)
_work = {}  # (device, stream) -> (status i64, ticket i32[1]), reused by every call


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
    if x.dim() != 2:
        raise ValueError(f"plane_scan: expected a 2-D plane, got shape {tuple(x.shape)}")
    m, v = x.shape
    kernels.require(x, "x", torch.int32, (m, v))
    if m < 1 or v < 1:
        raise ValueError(f"plane_scan needs a non-empty plane, got shape {(m, v)}")
    stream = kernels.stream_of(x)
    words = -(-m // TILE_ROWS) * -(-v // COLS) * COLS  # one a column of every tile's strip
    status, ticket, epoch = kernels.look_back_work(_work, x.device, stream, words)
    out = torch.empty_like(x)
    kernels.launch("plane_scan", "tbvh_plane_scan", x, m, v, int(is_min), int(reverse), out,
                   status, ticket, epoch, like=x, count=lambda: work.plane_scan(x),
                   symbols="plane_scan_kernel")
    return out
