"""PLOC merge rounds: emission and survivor compaction, one whole round,
and the finisher.

The contracts of `tpu_bvh.ops.pallas.ploc_round`. State `mat` i32[8, S]
in the layout of `ploc_nn` (rows 0-5 box bits, 6 Morton code, 7 node id),
live clusters i < nc at the front; `nodes` i32[8, W] is the node buffer,
column c = [left child, right child, union box bits (min xyz, -max xyz)].
Node ids are allocated bottom-up: the `base` clusters already merged
own ids [0, base), and a round's merges take [base, base + n_merged) in
cluster order (the round loop flips them to root-at-0 once at the end).

* `ploc_emit_compact` (B9): given the NN output, write each merge's node
  column and front-compact the kept clusters (merged ones carry the union
  and their new id, and keep their own code). Node columns outside
  [base, base + n_merged) are not touched. On the card one launch of
  `csrc/ploc_round.cu` (a single-pass scan with decoupled look-back, which
  also writes the zeros past the survivors); its status words and ticket
  are kept per device and stream, so a call allocates only its output.
* `ploc_round_fused` (B8) and `ploc_round_pp` (B6): one round = the NN
  stage on the live lanes, then the emission. On the card both are one
  launch of `csrc/ploc_round_fused.cu`. B8 allocates its outputs; B6
  writes the survivors into the caller's second buffer (the round loop
  swaps the two) and reuses the caller's scratch (`RoundWork`), so a
  round allocates nothing and its work is sized to the live count.
* `ploc_finish` (B7): every remaining round of at most MAX_FIN_WIDTH
  clusters in one launch of a thread-block cluster of FIN_CTAS CTAs,
  which leaves the cluster for CTA 0 at FIN_ONE_CTA live clusters and for
  one warp at 32 (`csrc/ploc_finish.cu`; its device counters per regime
  land in `last_finish_stats`). The HPLOC segment shift grows by
  `shift_step` per round, as in the plain round loop; the TPU kernel
  hard-codes 3 (tpu_bvh/ops/pallas/ploc_round.py:574).

A CUDA tensor launches `csrc/ploc_round.cu` (B9), `csrc/ploc_round_fused.cu`
(B6/B8) and `csrc/ploc_finish.cu` (B7); a CPU tensor takes the `*_reference`
versions, which run on any device. Both update `nodes` in place and
return it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils import kernels, timer
from ..utils import work as counts
from ..utils.platform import on_cuda
from . import ploc_nn

I32 = torch.int32
# the round loop hands the last FIN_WIDTH clusters to the finisher (the
# TPU kernel's width; the fastest of 4096, 8192 and 16384 in chip_smoke.py)
FIN_WIDTH = 16384
# the finisher's constants, mirrors of csrc/ploc_finish.cu: the CTAs of its
# thread-block cluster (kCtas), the live count at which CTA 0 goes on alone
# (kOneCtaAt), and the lanes of one CTA's slice (kMaxCap: 98 B a lane and
# 2,848 B of halos in dynamic shared memory, within the 232,448 B a block may
# opt in to on the H100 less 512 B for the static shared memory, a multiple of 4)
FIN_CTAS = 8
FIN_ONE_CTA = 1024
FIN_CAP = (232_448 - 512 - 2_848) // 98 // 4 * 4
MAX_FIN_WIDTH = FIN_CTAS * FIN_CAP
# B7's device counters, per regime (cluster, one CTA, one warp): rounds, then
# clock64 cycles of the round, NN stage, flags and scans, emission,
# compaction and barrier waits
FIN_STATS = (3, 7)
_EMIT_BLOCK = 256  # lanes per block of csrc/ploc_round_fused.cu (kThreads)
_EMIT_TILE = 1024  # lanes per block of csrc/ploc_round.cu (kTile)
last_finish_stats = None  # the last B7 launch's counters, i64[FIN_STATS]
_cluster_checked = False  # whether the card can schedule the finisher's cluster (checked once)
_emit_work = {}  # (device, stream) -> B9's (status i64, ticket i32[1]), reused by every call


class RoundWork(NamedTuple):
    """Scratch a round reuses: the blocks' look-back status words, and the
    ticket with the round's (n_merged, n_keep)."""

    status: torch.Tensor  # i64[2 * ceil(capacity / 256)]: (merges, keeps) per block
    ctl: torch.Tensor  # i32[4]: ticket (0 between launches), n_merged, n_keep, 0
    n_merged: torch.Tensor  # i32[], a view of ctl[1]


def round_work(capacity: int, device) -> RoundWork:
    nb = -(-capacity // _EMIT_BLOCK)
    ctl = torch.zeros((4,), dtype=I32, device=device)
    return RoundWork(torch.zeros((2 * nb,), dtype=torch.int64, device=device), ctl, ctl[1])


def _require_states(what: str, **states):
    """Each argument a contiguous CUDA i32[8, *]; raises naming `what`."""
    for name, x in states.items():
        kernels.require(x, name, I32)
        if x.dim() != 2 or x.shape[0] != 8:
            raise ValueError(f"{what}: {name} must be i32[8, *]")


# ---------------------------------------------------------------- B9

def ploc_emit_compact(mat, nn, nodes, n_clusters: int, base: int):
    """Returns (new_mat i32[8, S] with zeros past the survivors, nodes,
    n_merged i32[] on mat's device); dispatch by device."""
    if on_cuda(mat):
        return _emit_compact_cuda(mat, nn, nodes, int(n_clusters), int(base))
    return ploc_emit_compact_reference(mat, nn, nodes, n_clusters, base)


def ploc_emit_compact_reference(mat, nn, nodes, n_clusters: int, base: int, out=None):
    """Plain PyTorch version (any device): cumsum ranks, masked selects.
    Writes the survivors to the front of `out` (a new zero state if None)."""
    S = mat.shape[1]
    nc, base = int(n_clusters), int(base)
    dev = mat.device
    lanes = torch.arange(S, dtype=I32, device=dev)
    valid = lanes < nc
    merge = valid & (nn[7] == 1)
    keep = valid & (nn[7] != 2)
    mi = merge.to(I32)
    new_id = base + torch.cumsum(mi, 0, dtype=I32) - mi
    emit = torch.cat([mat[7:8], nn[6:7], nn[0:6]])[:, merge]
    nodes[:, base:base + emit.shape[1]] = emit
    surv = torch.where(merge, torch.cat([nn[0:6], mat[6:7], new_id[None]]), mat)[:, keep]
    if out is None:
        out = torch.zeros_like(mat)
    out[:, :surv.shape[1]] = surv
    return out, nodes, mi.sum(dtype=I32)


def _emit_compact_cuda(mat, nn, nodes, nc: int, base: int):
    _require_states("ploc_emit_compact", mat=mat, nn=nn, nodes=nodes)
    S = mat.shape[1]
    if not 1 <= nc <= min(S, nn.shape[1]):
        raise ValueError(f"ploc_emit_compact needs 1 <= n_clusters <= width, got {nc}")
    if base < 0 or base + nc // 2 > nodes.shape[1]:
        raise ValueError(f"ploc_emit_compact: ids [{base}, {base + nc // 2}) exceed the "
                         f"{nodes.shape[1]} node columns")
    stream = kernels.stream_of(mat)
    status, ticket, epoch = kernels.look_back_work(_emit_work, mat.device, stream,
                                                   2 * -(-nc // _EMIT_TILE))  # two a tile
    # one allocation: the new state, then the word that receives n_merged
    buf = torch.empty(8 * S + 1, dtype=I32, device=mat.device)
    kernels.launch("ploc_emit_compact", "tbvh_ploc_emit_compact", mat, S, nn, nn.shape[1], nc,
                   base, buf, S, nodes, nodes.shape[1], status, ticket,
                   buf.data_ptr() + 4 * 8 * S, epoch, like=mat,
                   count=lambda: counts.ploc_emit_compact(
                       nc, int((nn[7, :nc] == 1).sum()), int((nn[7, :nc] == 2).sum()), S),
                   symbols="emit_kernel")
    return buf[:8 * S].view(8, S), nodes, buf[8 * S]


# ---------------------------------------------------------------- B8 / B6

def ploc_round_fused(mat, nodes, n_clusters: int, shift_bits: int, base: int, radius: int):
    """One full round. Returns (new_mat i32[8, S] with zeros past the
    survivors, nodes, n_merged i32[]); dispatch by device."""
    if on_cuda(mat):
        out = torch.zeros_like(mat)
        work = round_work(int(n_clusters), mat.device)
        nm = _round_cuda("ploc_round_fused", counts.ploc_round_fused, mat, out, nodes,
                         int(n_clusters), int(shift_bits), int(base), radius, work)
        return out, nodes, nm
    return ploc_round_reference(mat, nodes, n_clusters, shift_bits, base, radius)


def ploc_round_reference(mat, nodes, n_clusters: int, shift_bits: int, base: int, radius: int,
                         out=None):
    """Plain PyTorch version (any device): the plain NN stage on the live
    lanes, then the plain emission into `out` (a new zero state if None)."""
    nc = int(n_clusters)
    live = mat[:, :nc]
    nn = ploc_nn.ploc_nn_round_raw_reference(live, nc, shift_bits, radius)
    if out is None:
        out = torch.zeros_like(mat)
    return ploc_emit_compact_reference(live, nn, nodes, nc, base, out)


def ploc_round_pp(matA, matB, nodes, n_clusters: int, shift_bits: int, base: int, radius: int,
                  work: RoundWork | None = None):
    """Ping-pong round: reads the live lanes of matA, writes the survivors
    to the front of matB (nothing else of matB) and the merges to nodes.
    Returns (matB, nodes, n_merged i32[]); dispatch by device. On the card
    n_merged is a view of `work`, valid until the next round."""
    if on_cuda(matA):
        if work is None:
            work = round_work(matA.shape[1], matA.device)
        nm = _round_cuda("ploc_round", counts.ploc_round, matA, matB, nodes, int(n_clusters),
                         int(shift_bits), int(base), radius, work)
        return matB, nodes, nm
    return ploc_round_pp_reference(matA, matB, nodes, n_clusters, shift_bits, base, radius)


def ploc_round_pp_reference(matA, matB, nodes, n_clusters: int, shift_bits: int, base: int,
                            radius: int, work=None):
    """Plain version of `ploc_round_pp` (any device; `work` is not used)."""
    return ploc_round_reference(matA, nodes, n_clusters, shift_bits, base, radius, out=matB)


def _round_cuda(name, count, mat, out, nodes, nc: int, shift_bits: int, base: int, radius: int,
                work: RoundWork):
    """One launch of the round kernel, counted as `name` (B6 or B8); its
    counts (`count`) come from the (n_merged, n_keep) it left in work.ctl."""
    def round_counts():
        nm, n_keep = work.ctl[1:3].tolist()
        return count(nc, nm, nc - n_keep, radius, shift_bits)

    ploc_nn._check(radius)
    _require_states("a PLOC round", mat=mat, out=out, nodes=nodes)
    if not 1 <= nc <= min(mat.shape[1], out.shape[1]):
        raise ValueError(f"a PLOC round needs 1 <= n_clusters <= width, got {nc}")
    if base < 0 or base + nc // 2 > nodes.shape[1]:
        raise ValueError(f"a PLOC round: ids [{base}, {base + nc // 2}) exceed the "
                         f"{nodes.shape[1]} node columns")
    nb = -(-nc // _EMIT_BLOCK)
    kernels.require(work.status, "RoundWork.status", torch.int64)
    kernels.require(work.ctl, "RoundWork.ctl", I32, (4,))
    if work.status.numel() < 2 * nb:
        raise ValueError(f"a PLOC round of {nc} clusters needs RoundWork.status i64[>= {2 * nb}]")
    kernels.launch(name, "tbvh_ploc_round", mat, mat.shape[1], nc, shift_bits, radius, base, out,
                   out.shape[1], nodes, nodes.shape[1], work.status, work.ctl,
                   kernels.next_epoch(), like=mat, count=round_counts,
                   symbols="ploc_round_kernel")
    return work.n_merged  # as the kernel left it


# ---------------------------------------------------------------- B7

def ploc_finish(mat, nodes, n_clusters: int, shift_bits: int, base: int, radius: int,
                shift_step: int = 3):
    """Every remaining round of the nc live clusters of `mat` (nc <=
    MAX_FIN_WIDTH on the card): writes node columns [base, base + nc - 1).
    Returns nodes; dispatch by device. A cluster launch the card refuses
    raises."""
    nc = int(n_clusters)
    if nc <= 1:
        return nodes
    if on_cuda(mat):
        return _finish_cuda(mat, nodes, nc, int(shift_bits), int(base), radius, int(shift_step))
    return ploc_finish_reference(mat, nodes, nc, shift_bits, base, radius, shift_step)


def ploc_finish_reference(mat, nodes, n_clusters: int, shift_bits: int, base: int, radius: int,
                          shift_step: int = 3):
    """Plain version (any device): plain rounds until one cluster is left,
    at most nc + 16 of them (the TPU kernel's bound)."""
    nc0 = nc = int(n_clusters)
    shift = int(shift_bits)
    mat = mat[:, :nc]
    for _ in range(nc0 + 16):
        if nc <= 1:
            return nodes
        mat, nodes, nm = ploc_round_reference(mat, nodes, nc, shift, int(base) + nc0 - nc, radius)
        nc -= int(nm)
        mat = mat[:, :nc]
        shift = min(shift + shift_step, 32)
    if nc > 1:
        raise RuntimeError(f"ploc_finish: {nc} clusters left after {nc0 + 16} rounds "
                           "(non-finite boxes?)")
    return nodes


def _finish_cuda(mat, nodes, nc: int, shift_bits: int, base: int, radius: int, step: int):
    global last_finish_stats, _cluster_checked
    ploc_nn._check(radius)
    _require_states("ploc_finish", mat=mat, nodes=nodes)
    if not nc <= min(MAX_FIN_WIDTH, mat.shape[1]):
        raise ValueError(f"ploc_finish takes n_clusters <= MAX_FIN_WIDTH = {MAX_FIN_WIDTH} "
                         f"(and <= the state's width), got {nc}")
    if base < 0 or base + nc - 1 > nodes.shape[1]:
        raise ValueError(f"ploc_finish: ids [{base}, {base + nc - 1}) exceed the "
                         f"{nodes.shape[1]} node columns")
    if not _cluster_checked:  # at the largest slice
        out = ctypes.c_int(0)
        kernels.query("tbvh_ploc_finish_clusters", ctypes.byref(out))
        if out.value == 0:
            raise RuntimeError(f"ploc_finish: the card cannot hold a cluster of {FIN_CTAS} CTAs "
                               f"with {FIN_CAP} lanes of shared memory each")
        _cluster_checked = True
    # a slice holds ceil(nc / FIN_CTAS) lanes in the cluster, CTA 0 up to
    # FIN_ONE_CTA once the cluster is done
    cap = max(-(-nc // FIN_CTAS), min(nc, FIN_ONE_CTA))
    cap = -(-cap // 4) * 4
    err = torch.zeros((1,), dtype=I32, device=mat.device)
    stats = torch.zeros(FIN_STATS, dtype=torch.int64, device=mat.device)
    kernels.launch("ploc_finish", "tbvh_ploc_finish", mat, mat.shape[1], nc, shift_bits, step,
                   base, radius, nodes, nodes.shape[1], err, stats, cap, like=mat,
                   count=lambda: counts.ploc_finish(mat, nc, shift_bits, radius, step, FIN_CTAS),
                   symbols="ploc_finish_kernel")
    last_finish_stats = stats
    flag = int(err)  # one host sync
    timer.count_host_sync()
    if flag != 0:
        raise RuntimeError(f"ploc_finish: clusters left after {nc + 16} rounds "
                           "(non-finite boxes?)")
    return nodes
