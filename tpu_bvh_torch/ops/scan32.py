"""Topology scan: per Morton boundary, the previous/next smaller adjacent
delta (position and value) and the left/right internal child.

The contract of `tpu_bvh.ops.pallas.scan32.scan_core`: from raw adjacent
deltas i32[m] (values [2, 31] for distinct codes, [41, 63] for ties),
return (psv_pos, psv_val, lc, nsv_pos, nsv_val, rc), each i32[m], values
on the order-preserving [0, 52] scale, sentinels psv_pos -1, nsv_pos m,
values -1, children -1 (= leaf).

A CUDA tensor launches `csrc/scan32.cu` (a bottom-up Apetrei climb); a
CPU tensor takes `scan_core_reference`, the vectorised threshold scans.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from ..utils.platform import on_cuda
from . import threshold_core

launches = 0  # kernel launches by `scan_core` since the last reset


def remap_deltas(dlt_raw):
    """Raw deltas -> [0, 52]: distinct [2, 31] -> [0, 29], ties [41, 63] -> [30, 52]."""
    return torch.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11)


def scan_core(dlt_raw):
    """Topology scans from raw adjacent deltas; dispatch by device."""
    if on_cuda(dlt_raw):
        return _scan_core_cuda(dlt_raw)
    return scan_core_reference(dlt_raw)


def scan_core_reference(dlt_raw):
    """Plain PyTorch version (any device): threshold-scan PSV/NSV plus the
    sparse-table child argmin."""
    m = dlt_raw.shape[0]
    dlt = remap_deltas(dlt_raw)
    psv_packed, nsv_packed = threshold_core.psv_nsv_packed_reference(dlt)
    has_psv = psv_packed >= 0
    has_nsv = nsv_packed != threshold_core.BIG
    psv_pos = torch.where(has_psv, psv_packed >> 6, -1)
    psv_val = torch.where(has_psv, psv_packed & 63, -1)
    nsv_pos = torch.where(has_nsv, nsv_packed >> 6, m)
    nsv_val = torch.where(has_nsv, nsv_packed & 63, -1)
    lc, rc = threshold_core.child_positions_from_ranges(dlt, psv_pos, nsv_pos)
    return psv_pos, psv_val, lc, nsv_pos, nsv_val, rc


def _scan_core_cuda(dlt_raw):
    global launches
    m = dlt_raw.shape[0]
    kernels.require(dlt_raw, "dlt_raw", torch.int32, (m,))
    if not 1 <= m < (1 << 22):
        raise ValueError(f"scan_core needs 1 <= m < 2^22, got {m}")
    outs = [torch.empty(m, dtype=torch.int32, device=dlt_raw.device) for _ in range(6)]
    other = torch.empty(m, dtype=torch.int32, device=dlt_raw.device)  # scratch
    psv_pos, psv_val, lc, nsv_pos, nsv_val, rc = outs
    err = kernels.lib().tbvh_scan32(
        dlt_raw.data_ptr(), m, other.data_ptr(),
        psv_pos.data_ptr(), psv_val.data_ptr(), lc.data_ptr(),
        nsv_pos.data_ptr(), nsv_val.data_ptr(), rc.data_ptr(),
        kernels.stream_of(dlt_raw),
    )
    kernels.check("tbvh_scan32", err)
    launches += 1
    return tuple(outs)
