"""Topology scan: per Morton boundary, the previous/next smaller adjacent
delta (position and value) and the left/right internal child.

The contract of `tpu_bvh.ops.pallas.scan32.scan_core`: from raw adjacent
deltas i32[m] (values [2, 31] for distinct codes, [41, 63] for ties),
return (psv_pos, psv_val, lc, nsv_pos, nsv_val, rc), each i32[m], values
on the order-preserving [0, 52] scale, sentinels psv_pos -1, nsv_pos m,
values -1, children -1 (= leaf).

A CUDA tensor launches `csrc/scan32.cu`: one launch of the strict psv/nsv
scan of `csrc/psv_scan.cuh` whose epilogue splits the packed keys and
scatters the children by the Apetrei climb's rule. A CPU tensor takes
`scan_core_reference`, the vectorised threshold scans.

`scan_fwd` and `scan_rev` are the two halves of the TPU's V=32 form
(`scan32._run` with `_fwd_kernel` / `_rev_kernel`): from the V=32 deltas
of sorted codes (distinct codes raw - 2, every tie on lane 30) the first
three outputs, and from their flip the last three in flipped order. On the
card each is one cooperative launch of the same scan with its own
epilogue, which rebuilds the remapped deltas (a tie at true position j is
the ruler value 32 + clz(j ^ (j + 1))) and writes only its half; the
reverse half scans the flipped array itself, so its psv is the true nsv
and every row writes its own slot.
"""
from __future__ import annotations

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda
from . import threshold_core


def remap_deltas(dlt_raw):
    """Raw deltas -> [0, 52]: distinct [2, 31] -> [0, 29], ties [41, 63] -> [30, 52]."""
    return torch.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11)


def dlt32_from_raw(dlt_raw):
    """Raw deltas -> the V=32 form: distinct [2, 31] -> [0, 29], ties -> 30."""
    return torch.where(dlt_raw <= 31, dlt_raw - 2, 30)


def raw_from_dlt32(dlt32):
    """The raw deltas of sorted codes back from their V=32 form."""
    m = dlt32.shape[0]
    j = torch.arange(m, dtype=torch.int64, device=dlt32.device)
    ruler = 64 - torch.frexp((j ^ (j + 1)).to(torch.float64)).exponent  # 32 + clz32
    return torch.where(dlt32 == 30, ruler.to(torch.int32), dlt32 + 2)


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
    m = dlt_raw.shape[0]
    kernels.require(dlt_raw, "dlt_raw", torch.int32, (m,))
    if not 1 <= m < (1 << 22):
        raise ValueError(f"scan_core needs 1 <= m < 2^22, got {m}")
    outs = [torch.empty(m, dtype=torch.int32, device=dlt_raw.device) for _ in range(6)]
    agg = threshold_core.scan_scratch(m, dlt_raw.device)
    kernels.launch("scan32", "tbvh_scan32", dlt_raw, m, agg, *outs, like=dlt_raw,
                   count=lambda: work.scan32(dlt_raw, outs), symbols="scan_kernel<Topology")
    return tuple(outs)


def scan_fwd(dlt32):
    """(psv_pos, psv_val, lc) i32[m] from the V=32 deltas; dispatch by device."""
    if on_cuda(dlt32):
        return _scan_half_cuda(dlt32, dlt32.shape[0], False)
    return scan_fwd_reference(dlt32)


def scan_fwd_reference(dlt32):
    """Plain version (any device): `scan_core_reference` of the raw deltas."""
    return scan_core_reference(raw_from_dlt32(dlt32))[:3]


def scan_rev(dlt32_flipped, m: int):
    """(nsv_pos, nsv_val, rc) i32[m] in flipped order (entry g is true
    position m - 1 - g), true coordinates, from the flipped V=32 deltas;
    dispatch by device."""
    if dlt32_flipped.shape[0] != m:
        raise ValueError(f"scan_rev: m = {m} but {dlt32_flipped.shape[0]} deltas")
    if on_cuda(dlt32_flipped):
        return _scan_half_cuda(dlt32_flipped, m, True)
    return scan_rev_reference(dlt32_flipped, m)


def scan_rev_reference(dlt32_flipped, m: int):
    """Plain version (any device)."""
    raw = raw_from_dlt32(torch.flip(dlt32_flipped, [0]))
    return tuple(torch.flip(x, [0]) for x in scan_core_reference(raw)[3:])


def _scan_half_cuda(dlt32, m: int, flipped: bool):
    kernels.require(dlt32, "dlt32", torch.int32, (m,))
    if not 1 <= m < (1 << 22):
        raise ValueError(f"scan_fwd / scan_rev need 1 <= m < 2^22, got {m}")
    outs = [torch.empty(m, dtype=torch.int32, device=dlt32.device) for _ in range(3)]
    agg = threshold_core.scan_scratch(m, dlt32.device)
    kernels.launch("scan32_halves", "tbvh_scan32_rev" if flipped else "tbvh_scan32_fwd",
                   dlt32, m, agg, *outs, like=dlt32,
                   count=lambda: work.per_row("scan32_half", m),
                   symbols="scan_kernel<Scan32Rev" if flipped else "scan_kernel<Scan32Fwd")
    return tuple(outs)
