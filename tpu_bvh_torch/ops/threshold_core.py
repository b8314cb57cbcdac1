"""Plain PyTorch threshold scans: the vectorised PSV/NSV and child-position
queries over remapped adjacent deltas (values in [0, 63]).

These are the `*_reference` forms of `tpu_bvh.ops.pallas.threshold_core`;
together they are the plain side of the topology-scan kernel
(`ops/scan32.py`). `lax.associative_scan` has no PyTorch counterpart, so
the child positions come from a sparse min table instead: for sorted keys
every range has a unique minimum delta (threshold_core.py:504-508), so
any exact range-argmin gives the same answer.
"""
from __future__ import annotations

import torch

V = 64
BIG = 2**31 - 1
_POSB = 22  # pos bits in the packed (dlt << 22 | pos) key; needs m < 2^22


def psv_nsv_packed_reference(dlt):
    """(psv_packed, nsv_packed) i32[m] with packing pos * 64 + dlt.
    psv sentinel: -1 (none); nsv sentinel: 2^31 - 1 (none)."""
    m = dlt.shape[0]
    dev = dlt.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    packed = pos * 64 + dlt
    vr = torch.arange(V, dtype=torch.int32, device=dev)
    maskv = dlt[:, None] < vr[None, :]
    pk = torch.where(maskv, packed[:, None], BIG)
    suf = torch.flip(torch.cummin(torch.flip(pk, [0]), dim=0).values, [0])
    nsv_rows = torch.cat([suf[1:], torch.full((1, V), BIG, dtype=torch.int32, device=dev)])
    pk2 = torch.where(maskv, packed[:, None], -1)
    pre = torch.cummax(pk2, dim=0).values
    psv_rows = torch.cat([torch.full((1, V), -1, dtype=torch.int32, device=dev), pre[:-1]])
    lane = dlt.to(torch.int64)[:, None]
    return psv_rows.gather(1, lane)[:, 0], nsv_rows.gather(1, lane)[:, 0]


def child_positions_from_ranges(dlt, psv, nsv):
    """(left, right) i32[m]: boundary index of each node's internal child,
    or -1 where the child is a leaf. Node k covers (psv[k], nsv[k]]; its
    left child is the delta argmin over (psv, k), the right over (k, nsv)."""
    m = dlt.shape[0]
    dev = dlt.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    key = (dlt << _POSB) | pos
    levels = max(1, (m - 1).bit_length())
    tabs = [key]
    cur = key
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < m:
            cur = torch.minimum(cur, torch.cat([cur[s:], cur[-1:].expand(s)]))
        tabs.append(cur)
    table = torch.cat(tabs)  # [(levels + 1) * m]

    def argmin(a, b):
        empty = b < a
        ln = torch.clamp(b - a + 1, min=1)
        k = torch.frexp(ln.to(torch.float64)).exponent.to(torch.int32) - 1
        a_ = torch.clamp(a, 0, m - 1)
        b2 = torch.clamp(b - (1 << k) + 1, 0, m - 1)
        best = torch.minimum(table[k * m + a_], table[k * m + b2])
        return torch.where(empty, -1, best & ((1 << _POSB) - 1))

    return argmin(psv + 1, pos - 1), argmin(pos + 1, nsv - 1)


def child_positions_reference(dlt):
    """(left, right) child boundary positions from deltas alone."""
    m = dlt.shape[0]
    psv_packed, nsv_packed = psv_nsv_packed_reference(dlt)
    psv = torch.where(psv_packed >= 0, psv_packed >> 6, -1)
    nsv = torch.where(nsv_packed != BIG, nsv_packed >> 6, m)
    return child_positions_from_ranges(dlt, psv, nsv)
