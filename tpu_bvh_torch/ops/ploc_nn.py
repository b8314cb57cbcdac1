"""PLOC nearest-neighbour stage: one round's radius-R search, mutual pairs
and partner unions.

The contract of `tpu_bvh.ops.pallas.ploc_nn.ploc_nn_round_raw`. The state
`mat` i32[8, S] holds rows 0-5 = cluster AABB (min xyz, -max xyz) as f32
bits, row 6 = Morton code (< 2^31), row 7 = cluster node id; the clusters
i < nc are live. For every lane i < S:

* the candidates are the live lanes i +- d, 1 <= d <= R, in i's segment
  (code >> min(shift, 31); one segment when shift >= 32);
* the neighbour is the lexicographic minimum of (union area, index): the
  forward offsets 1..R are tried with a strict `<`, then the backward ones,
  where an equal area goes to the smaller index;
* row 7 of the output flags mutual pairs: 1 on the left partner (merge),
  2 on the right one (dropped); rows 0-5 hold min(own box, box of the best
  forward candidate) and row 6 that candidate's node id (+0.0 boxes and id
  0 where there is none), as the TPU kernel leaves them.

The union area is `2 * ((ex*ey + ex*ez) + ey*ez)` with `ex = -u3 - u0`
etc., and the union takes the min of `jnp.minimum` (`aabb.fmin`), so the
CUDA kernel (`csrc/ploc_nn.cu`) equals `ploc_nn_round_raw_reference` bit
for bit. A CUDA tensor launches the kernel; a CPU tensor takes the plain
version.
"""
from __future__ import annotations

import torch

from ..types import PLOC_RADIUS
from ..utils import kernels, work
from ..utils.platform import on_cuda
from .aabb import fmin

I32 = torch.int32
BIG = 3.0e38  # "no candidate" area
MAX_RADIUS = PLOC_RADIUS  # the kernel's halo is 2 * MAX_RADIUS lanes (kMaxR in the .cuh)
LANES = 4  # adjacent table columns a thread owns (kLanes in csrc/ploc_nn.cu)
THREADS = 256  # threads a block (kThreads)
COLS = THREADS * LANES  # table columns a block (kCols): its lanes and 3 * MAX_RADIUS more
TILE = COLS - 3 * MAX_RADIUS  # output lanes a block (kTile)
PHASES = ("load", "areas", "best_rel", "mutual_writes")  # the kernel's clock64 stamps


def area6(c):
    """Surface area from packed (min3, -max3) rows c[0..5], in the order of
    `tpu_bvh.ops.ploc._area6`."""
    ex = -c[3] - c[0]
    ey = -c[4] - c[1]
    ez = -c[5] - c[2]
    return 2.0 * (ex * ey + ex * ez + ey * ez)


def segments(codes, shift_bits: int):
    """HPLOC segment ids: the code's prefix above `shift_bits` bits, one
    segment at 32 or more. Codes are < 2^31, so `>>` is a logical shift."""
    if shift_bits >= 32:
        return torch.zeros_like(codes)
    return codes >> shift_bits


def _check(radius: int):
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"PLOC radius must be in [1, {MAX_RADIUS}], got {radius}")


def ploc_nn_round_raw(mat, n_clusters: int, shift_bits: int, radius: int):
    """Raw NN output i32[8, S] (layout in the module docstring); dispatch by device."""
    _check(radius)
    if on_cuda(mat):
        out = torch.empty_like(mat)
        launch(mat, int(n_clusters), int(shift_bits), radius, out, mat.shape[1])
        return out
    return ploc_nn_round_raw_reference(mat, n_clusters, shift_bits, radius)


def ploc_nn_round(mat, n_clusters: int, radius: int, shift_bits: int = 32):
    """Unpacked NN stage: (merge bool[S], dropped bool[S], ucols f32[6, S],
    rnode i32[S])."""
    out = ploc_nn_round_raw(mat, n_clusters, shift_bits, radius)
    return out[7] == 1, out[7] == 2, out[0:6].view(torch.float32), out[6]


def ploc_nn_round_raw_reference(mat, n_clusters: int, shift_bits: int, radius: int):
    """Plain PyTorch version (any device): one shifted view per offset."""
    _check(radius)
    R = radius
    S = mat.shape[1]
    nc = int(n_clusters)
    dev = mat.device
    cols = mat[0:6].contiguous().view(torch.float32)
    seg = segments(mat[6], int(shift_bits))
    node = mat[7]
    lanes = torch.arange(S, dtype=I32, device=dev)
    valid = lanes < nc
    # neighbour views beyond the end read padding, which no live lane uses
    pad = lambda x: torch.cat([x, torch.zeros((*x.shape[:-1], R), dtype=x.dtype, device=dev)], -1)
    cols_p, seg_p, node_p = pad(cols), pad(seg), pad(node)

    best_area = torch.full((S,), BIG, dtype=torch.float32, device=dev)
    best_rel = torch.zeros((S,), dtype=I32, device=dev)
    p_cols = torch.zeros((6, S), dtype=torch.float32, device=dev)
    p_node = torch.zeros((S,), dtype=I32, device=dev)
    areas = []
    for d in range(1, R + 1):
        w = cols_p[:, d:d + S]
        ok = valid & (lanes + d < nc) & (seg == seg_p[d:d + S])
        area = torch.where(ok, area6(fmin(cols, w)), BIG)
        areas.append(area)
        better = area < best_area
        best_area = torch.where(better, area, best_area)
        best_rel = torch.where(better, d, best_rel)
        p_cols = torch.where(better, w, p_cols)
        p_node = torch.where(better, node_p[d:d + S], p_node)
    for d in range(1, R + 1):
        # the pair (i - d, i) as lane i - d saw it
        area_b = torch.cat([torch.full((min(d, S),), BIG, device=dev),
                            areas[d - 1][:max(S - d, 0)]])
        better = (area_b < best_area) | ((area_b == best_area) & (-d < best_rel))
        best_area = torch.where(better, area_b, best_area)
        best_rel = torch.where(better, -d, best_rel)

    has_nn = best_area < BIG
    zeros = torch.zeros((R,), dtype=I32, device=dev)
    rel_p = torch.cat([zeros, best_rel, zeros])  # rel_p[R + i] = best_rel[i]
    merge = torch.zeros((S,), dtype=torch.bool, device=dev)
    dropped = torch.zeros((S,), dtype=torch.bool, device=dev)
    for d in range(1, R + 1):
        merge |= (best_rel == d) & (rel_p[R + d:R + d + S] == -d)
        dropped |= (best_rel == -d) & (rel_p[R - d:R - d + S] == d)
    flags = ((merge & has_nn & valid).to(I32)
             + 2 * (dropped & has_nn & valid).to(I32))
    ucols = fmin(cols, p_cols).view(I32)
    return torch.cat([ucols, p_node[None], flags[None]])


def phase_cycles(mat, n_clusters: int, shift_bits: int, radius: int) -> dict:
    """One launch on the CUDA tensor `mat` with its phase clocks on: per
    phase of `PHASES` (`csrc/ploc_nn.cu`) the median and the largest of
    the blocks' SM clock cycles, and the median of their totals. The
    output equals the launch's without clocks."""
    s = mat.shape[1]
    clk = torch.zeros((-(-s // TILE), len(PHASES) + 1), dtype=torch.int64, device=mat.device)
    launch(mat, int(n_clusters), int(shift_bits), radius, torch.empty_like(mat), s, clk)
    d = torch.diff(clk.cpu(), dim=1)
    out = {name: (d[:, k].median().item(), d[:, k].max().item())
           for k, name in enumerate(PHASES)}
    out["total"] = d.sum(1).median().item()
    return out


def launch(mat, nc: int, shift_bits: int, radius: int, out, s: int, clk=None):
    """Launch the kernel on lanes [0, s) of `mat` (i32[8, C], s <= C, live
    clusters nc <= s), writing lanes [0, s) of `out` (i32[8, C']); `clk`
    i64[ceil(s / TILE), 5] takes each block's phase clocks."""
    _check(radius)
    kernels.require(mat, "mat", I32)
    kernels.require(out, "out", I32)
    if mat.dim() != 2 or mat.shape[0] != 8 or out.dim() != 2 or out.shape[0] != 8:
        raise ValueError("ploc_nn: mat and out must be i32[8, *]")
    if not 0 <= nc <= s <= min(mat.shape[1], out.shape[1]) or s < 1:
        raise ValueError(f"ploc_nn needs 0 <= nc <= s <= width, s >= 1; got nc={nc}, s={s}")
    if clk is not None:
        kernels.require(clk, "clk", torch.int64, (-(-s // TILE), len(PHASES) + 1))
    kernels.launch("ploc_nn", "tbvh_ploc_nn", mat, mat.shape[1], s, nc, shift_bits, radius, out,
                   out.shape[1], clk, like=mat, count=lambda: work.ploc_nn(nc, radius, shift_bits),
                   symbols="ploc_nn_kernel")
