"""PLOC++ agglomerative clustering and its HPLOC-guided variant.

The port of `tpu_bvh.ops.ploc.ploc_build_topology(_packed)`. Morton-sorted
leaves are merged round by round: each live cluster finds its nearest
neighbour within radius R in Morton order (smallest union area, the
smaller index on ties), mutual pairs merge, and the survivors stay
compacted at the front in cluster order (`ploc_nn`, `ploc_round`). HPLOC
restricts merges to Morton-prefix segments whose shift starts at `shift0`
and grows by `shift_step` each round (32 = one segment, plain PLOC).

The round loop runs rounds while more than `ploc_round.FIN_WIDTH` clusters
are live, reading the merge count back once per round for the loop test
(the reference's own per-round readback, PLOC++Bvh.cpp:132-152), then
hands the rest to `ploc_finish`. On CUDA tensors the rounds are B6 and the
tail is B7; on the CPU, and in `ploc_build_topology_packed_reference` on
any device, both are their plain versions. The rounds do not depend on
where the hand-over falls, so every path builds the same tree.

`last_build` keeps the last build's round loop: its rounds, the finisher
call, its counted host syncs (each round's readback and, on the card, the
finisher's error flag: `utils/timer.tally`), and per round the live
clusters at its start (`clusters`) and the merges its readback returned
(`merged`), so round k + 1 starts with clusters[k] - merged[k]. Under a
running profiler the state's set-up is the span `bvh.ploc_init`, each
round `bvh.ploc_round`, the finisher `bvh.ploc_finish` and the flip
`bvh.finalize`.

Node ids are allocated bottom-up (a round's merges take the next ids in
cluster order) and flipped once at the end to the reference's root-at-0
numbering: column c -> n_int-1-c, internal child v -> n_int-1-v, leaves
(v >= n_int) unchanged.
"""
from __future__ import annotations

import torch

from ..types import PLOC_RADIUS
from ..utils import timer
from ..utils.platform import on_cuda
from . import ploc_round

I32 = torch.int32
# the last build's round-loop counts: rounds before the finisher, finisher
# calls, counted host syncs, and each round's live clusters and merges
last_build = {"rounds": 0, "finish": 0, "host_syncs": 0, "clusters": [], "merged": []}


def ploc_build_topology(leaf_min, leaf_max, codes, hploc: bool = False,
                        radius: int = PLOC_RADIUS, shift0: int = 3, shift_step: int = 3):
    """Row-major wrapper: leaf_min/max f32[n, 3] sorted leaf boxes, codes
    [n] sorted Morton codes. Returns (left i32[n-1], right i32[n-1],
    node_min f32[n-1, 3], node_max f32[n-1, 3]); root = 0."""
    packed_t = torch.cat([leaf_min, -leaf_max], dim=1).T
    left, right, int_packed_t = ploc_build_topology_packed(
        packed_t, codes, hploc=hploc, radius=radius, shift0=shift0, shift_step=shift_step)
    out = int_packed_t.T
    return left, right, out[:, :3], -out[:, 3:]


def ploc_build_topology_packed(leaf_packed_t, codes, hploc: bool = False,
                               radius: int = PLOC_RADIUS, shift0: int = 3, shift_step: int = 3):
    """leaf_packed_t: f32[6, n] (rows min xyz, -max xyz) in sorted order;
    codes: [n] sorted Morton codes (< 2^31; used only by the HPLOC segments).
    Returns (left i32[n-1], right i32[n-1], int_packed_t f32[6, n-1]), root
    = 0. CUDA tensors run the kernels, CPU tensors the plain versions."""
    return _agglomerate(leaf_packed_t, codes, hploc, radius, shift0, shift_step,
                        on_cuda(leaf_packed_t))


def ploc_build_topology_packed_reference(leaf_packed_t, codes, hploc: bool = False,
                                         radius: int = PLOC_RADIUS, shift0: int = 3,
                                         shift_step: int = 3):
    """`ploc_build_topology_packed` with the plain rounds and finisher, on
    any device."""
    return _agglomerate(leaf_packed_t, codes, hploc, radius, shift0, shift_step, False)


def initial_state(leaf_packed_t, codes):
    """The first round's cluster state i32[8, n]: one cluster per sorted
    leaf, with its box bits, its Morton code and its leaf id n - 1 + i."""
    n = leaf_packed_t.shape[1]
    return torch.cat([
        leaf_packed_t.contiguous().view(I32),
        codes.to(I32)[None],  # Morton codes < 2^31 fit an i32 row
        (torch.arange(n, dtype=I32, device=leaf_packed_t.device) + n - 1)[None],
    ])


def _agglomerate(leaf_packed_t, codes, hploc, radius, shift0, shift_step, use_kernels):
    n = leaf_packed_t.shape[1]
    n_int = n - 1
    dev = leaf_packed_t.device
    with timer.span("bvh.ploc_init"):
        mat = initial_state(leaf_packed_t, codes)
        nodes = torch.zeros((8, max(n_int, 0)), dtype=I32, device=dev)
        if use_kernels:
            round_fn, finish_fn = ploc_round.ploc_round_pp, ploc_round.ploc_finish
            work = ploc_round.round_work(n, dev)
        else:
            round_fn = ploc_round.ploc_round_pp_reference
            finish_fn = ploc_round.ploc_finish_reference
            work = None
        spare = torch.empty_like(mat)
    nc, shift = n, (shift0 if hploc else 32)
    clusters, merged = [], []
    # counted: one readback a round and, on the card, the finisher's error
    # flag (the plain finisher's own per-round reads are not counted)
    with timer.tally(last_build):
        while nc > ploc_round.FIN_WIDTH:
            if len(clusters) >= n + 16:  # only non-finite boxes stall every round
                raise RuntimeError(f"PLOC: {nc} clusters left after {len(clusters)} rounds")
            with timer.span("bvh.ploc_round"):
                _, _, nm = round_fn(mat, spare, nodes, nc, shift, n - nc, radius, work)
                clusters.append(nc)
                merged.append(int(nm))  # the loop test: one host sync per round
                timer.count_host_sync()
                nc -= merged[-1]
                mat, spare = spare, mat
                shift = min(shift + shift_step, 32)
        with timer.span("bvh.ploc_finish"):
            finish_fn(mat, nodes, nc, shift, n - nc, radius, shift_step)
        last_build.update(rounds=len(clusters), finish=int(nc > 1), clusters=clusters,
                          merged=merged)

    with timer.span("bvh.finalize"):
        nodes = nodes.flip(1)
        remap = lambda v: torch.where(v < n_int, n_int - 1 - v, v)
        return remap(nodes[0]), remap(nodes[1]), nodes[2:8].contiguous().view(torch.float32)
