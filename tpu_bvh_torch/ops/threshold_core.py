"""Threshold scans over remapped adjacent deltas (values in [0, 63]): the
packed previous/next-smaller-value queries, the same with a payload read
at the answer, and the segmented child-position argmins.

The contract of `tpu_bvh.ops.pallas.threshold_core`:

* `psv_nsv_packed(dlt)` -> (psv, nsv) i32[m]:
  psv(i) = max_{j < i, d_j < d_i} (64 j + d_j), -1 where none;
  nsv(i) = min_{j > i, d_j < d_i} (64 j + d_j), 2^31 - 1 where none.
  The TPU has a sublane and a lane layout of it (`psv_nsv_packed`,
  `psv_nsv_packed_lanes`); on the card both are one kernel.
* `psv_nsv_payload_auto(dlt, pay)` -> (psv, pay[psv], nsv, pay[nsv]),
  the payload -1 where there is no smaller value.
* `child_positions_auto(dlt)` -> (left, right) i32[m]: per row k and
  lane v = d_k, the segmented minimum of (d_j << 22 | j) over the rows
  since the last row with d_j <= v, exclusive of k (left), and its mirror
  (right); -1 where that window is empty.

A CUDA tensor launches `csrc/threshold_scan.cu` (the first two) or
`csrc/child_scan.cu`, each one cooperative launch of `csrc/psv_scan.cuh`;
a CPU tensor takes the `*_reference` forms, which
build the 64-lane threshold planes. `lax.associative_scan` has no PyTorch
counterpart, so the plain child positions run the same segmented combine
as a Hillis-Steele doubling loop, which is exact (min and or).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda

V = 64
BIG = 2**31 - 1
_POSB = 22  # pos bits in the packed (dlt << 22 | pos) key; needs m < 2^22
MAX_M = 1 << 25  # 64 * pos + dlt must fit an i32
MAX_M_CHILD = 1 << _POSB
TILE = 1024  # rows per tile of csrc/psv_scan.cuh (kTile)


def _check_size(dlt, limit: int, what: str) -> int:
    m = dlt.shape[0]
    if m >= limit:
        raise ValueError(f"{what} needs m < {limit}, got {m}")
    return m


# ------------------------------------------------------------ B12 / B13

def psv_nsv_packed(dlt):
    """(psv_packed, nsv_packed) i32[m]; dispatch by device."""
    _check_size(dlt, MAX_M, "psv_nsv_packed")
    if on_cuda(dlt):
        return _threshold_cuda(dlt, None)
    return psv_nsv_packed_reference(dlt)


# the TPU's lane layout and its size dispatch are the same function here
psv_nsv_packed_lanes = psv_nsv_packed
psv_nsv_packed_auto = psv_nsv_packed


def psv_nsv_packed_reference(dlt):
    """Plain PyTorch version (any device): (psv_packed, nsv_packed) i32[m]
    with packing pos * 64 + dlt; sentinels -1 and 2^31 - 1. The planes are
    [64, m] (the TPU's lane layout), so the scans run along contiguous rows."""
    m = dlt.shape[0]
    dev = dlt.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    packed = (pos * 64 + dlt)[None, :]
    vr = torch.arange(V, dtype=torch.int32, device=dev)[:, None]
    maskv = dlt[None, :] < vr
    suf = torch.flip(torch.cummin(torch.flip(torch.where(maskv, packed, BIG), [1]), dim=1).values,
                     [1])
    nsv_rows = torch.cat([suf[:, 1:], torch.full((V, 1), BIG, dtype=torch.int32, device=dev)], 1)
    pre = torch.cummax(torch.where(maskv, packed, -1), dim=1).values
    psv_rows = torch.cat([torch.full((V, 1), -1, dtype=torch.int32, device=dev), pre[:, :-1]], 1)
    lane = dlt.to(torch.int64)[None, :]
    return psv_rows.gather(0, lane)[0], nsv_rows.gather(0, lane)[0]


# ------------------------------------------------------------ B14

def psv_nsv_payload_auto(dlt, pay):
    """(psv_packed, pay[psv], nsv_packed, pay[nsv]) i32[m]; dispatch by device."""
    m = _check_size(dlt, MAX_M, "psv_nsv_payload_auto")
    if on_cuda(dlt):
        kernels.require(pay, "pay", torch.int32, (m,))
        return _threshold_cuda(dlt, pay)
    return psv_nsv_payload_reference(dlt, pay)


def psv_nsv_payload_reference(dlt, pay):
    """Plain version (any device): the packed scans, then the payload
    gathered at their positions; -1 where there is no smaller value."""
    m = dlt.shape[0]
    psv, nsv = psv_nsv_packed_reference(dlt)
    has_p = psv >= 0
    has_n = nsv != BIG
    pp = torch.where(has_p, pay[torch.clamp(psv >> 6, 0, m - 1)], -1)
    np_ = torch.where(has_n, pay[torch.clamp(nsv >> 6, 0, m - 1)], -1)
    return psv, pp, nsv, np_


def scan_scratch(m: int, device):
    """The tile totals, block totals and block masks of one
    `csrc/psv_scan.cuh` launch over m rows (B1, B12/B13, B14, B15, B16's
    halves); no value needs clearing."""
    nt = -(-m // TILE)
    return torch.empty((4 * V + 32) * nt, dtype=torch.int32, device=device)


def launch_grid(m: int, device, topology: bool = False) -> dict:
    """The grid a `psv_scan.cuh` launch over m rows takes on `device`'s
    card (psv/nsv, or B1's with `topology`): blocks, most tiles a block,
    resident blocks an SM (the occupancy query) and SMs."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        kernels.query("tbvh_scan32_grid" if topology else "tbvh_psv_nsv_grid", m, out)
    return dict(zip(("blocks", "tiles_a_block", "blocks_an_sm", "sms"), out))


def psv_nsv_phase_cycles(dlt) -> dict:
    """One B12 launch on the CUDA tensor `dlt` with its phase clocks on:
    per phase (phase 1, the grid sync, phase 2, phase 3; `csrc/psv_scan.cuh`)
    the median and the largest of the blocks' SM clock cycles, and the
    median of their totals."""
    g = launch_grid(dlt.shape[0], dlt.device)
    clk = torch.zeros((g["blocks"], 5), dtype=torch.int64, device=dlt.device)
    _threshold_cuda(dlt, None, clk)
    d = torch.diff(clk.cpu(), dim=1)
    out = {}
    for k, name in enumerate(("phase1", "sync", "phase2", "phase3")):
        out[name] = (d[:, k].median().item(), d[:, k].max().item())
    out["total"] = d.sum(1).median().item()
    return out


def _threshold_cuda(dlt, pay, clk=None):
    m = dlt.shape[0]
    kernels.require(dlt, "dlt", torch.int32, (m,))
    if m < 1:
        raise ValueError("the threshold scan needs m >= 1")
    dev = dlt.device
    agg = scan_scratch(m, dev)
    psv = torch.empty(m, dtype=torch.int32, device=dev)
    nsv = torch.empty(m, dtype=torch.int32, device=dev)
    if pay is None:
        kernels.launch("psv_nsv_packed", "tbvh_psv_nsv", dlt, m, agg, psv, nsv, clk, like=dlt,
                       count=lambda: work.per_row("psv_nsv_packed", m),
                       symbols="scan_kernel<PsvNsv")
        return psv, nsv
    pp = torch.empty(m, dtype=torch.int32, device=dev)
    np_ = torch.empty(m, dtype=torch.int32, device=dev)
    kernels.launch("psv_nsv_payload", "tbvh_psv_nsv_payload", dlt, pay, m, agg, psv, pp, nsv,
                   np_, like=dlt, count=lambda: work.per_row("psv_nsv_payload", m),
                   symbols="scan_kernel<PsvNsv")
    return psv, pp, nsv, np_


# ------------------------------------------------------------ B15

def child_positions_auto(dlt):
    """(left, right) i32[m] internal-child boundary positions, -1 where the
    child is a leaf; dispatch by device."""
    _check_size(dlt, MAX_M_CHILD, "child_positions_auto")
    if on_cuda(dlt):
        return _child_cuda(dlt)
    return child_positions_reference(dlt)


def _segmented_min(cand, reset):
    """Inclusive segmented running min along dim 0 of [m, V]: a reset row
    starts a new segment. Hillis-Steele doubling with the combine of
    threshold_core.py:528-530, comb(a, b) = (b.reset ? b.x : min(a.x, b.x),
    a.reset | b.reset)."""
    m = cand.shape[0]
    x, r = cand, reset
    k = 1
    while k < m:
        x = torch.cat([x[:k], torch.where(r[k:], x[k:], torch.minimum(x[:-k], x[k:]))])
        r = torch.cat([r[:k], r[k:] | r[:-k]])
        k <<= 1
    return x


def child_positions_reference(dlt):
    """Plain version (any device) of JAX's `child_positions_reference`: per
    lane v, candidates are rows with d > v and a segment resets at rows
    with d <= v; the left child selects lane d[k] exclusively before k, the
    right child the mirrored scan exclusively after k."""
    m = dlt.shape[0]
    dev = dlt.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    packed = (dlt << _POSB) | pos
    vr = torch.arange(V, dtype=torch.int32, device=dev)
    cand = torch.where(dlt[:, None] > vr[None, :], packed[:, None], BIG)
    reset = dlt[:, None] <= vr[None, :]
    none = torch.full((1, V), BIG, dtype=torch.int32, device=dev)
    fwd = _segmented_min(cand, reset)
    m_excl = torch.cat([none, fwd[:-1]])
    rev = torch.flip(_segmented_min(torch.flip(cand, [0]), torch.flip(reset, [0])), [0])
    m_excl_r = torch.cat([rev[1:], none])
    lane = dlt.to(torch.int64)[:, None]
    lpk = m_excl.gather(1, lane)[:, 0]
    rpk = m_excl_r.gather(1, lane)[:, 0]
    mask = (1 << _POSB) - 1
    return (torch.where(lpk == BIG, -1, lpk & mask), torch.where(rpk == BIG, -1, rpk & mask))


def child_positions_from_ranges(dlt, psv, nsv):
    """(left, right) i32[m] from the nodes' ranges: node k covers
    (psv[k], nsv[k]]; its left child is the delta argmin over (psv, k),
    the right over (k, nsv), -1 where empty (a sparse min table).

    Valid only for the deltas of sorted Morton codes, where every range
    has a unique minimum: there the strict psv/nsv bound the same windows
    as `child_positions_reference`'s resets at d <= v. On deltas that
    repeat a value the two differ; B1's plain version (`scan32`) is its
    only caller."""
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


def _child_cuda(dlt):
    m = dlt.shape[0]
    kernels.require(dlt, "dlt", torch.int32, (m,))
    if m < 1:
        raise ValueError("child_positions_auto needs m >= 1")
    dev = dlt.device
    agg = scan_scratch(m, dev)
    scratch = torch.empty(3 * m, dtype=torch.int32, device=dev)  # nsv <, psv <=, nsv <=
    left = torch.empty(m, dtype=torch.int32, device=dev)
    right = torch.empty(m, dtype=torch.int32, device=dev)
    kernels.launch("child_positions", "tbvh_child_positions", dlt, m, agg, scratch, left, right,
                   like=dlt, count=lambda: work.per_row("child_positions", m),
                   symbols="scan_kernel<ChildPositions")
    return left, right
