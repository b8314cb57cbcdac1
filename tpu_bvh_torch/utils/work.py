"""What each hand-written kernel must move and compute in one call: the
counts behind its bound.

A kernel's bound is the least time the card could take for its work, the
larger of its bytes over the memory rate and its f32 operations over the
f32 peak (`introspect.optimal_seconds`). Each function here returns
(bytes, flops, info) for one call: every input byte the work needs read
once, every output byte written once, and where the work depends on the
data (ray-prim tests, merges, rows a walk stood on) what this call's data
needs; `info` says what the data-dependent parts came to. The launch
wrappers hand these counts to `kernels.launch`, which reports them to
`introspect.record` (read inside `introspect.cost_analysis` only), and
chip_smoke.py prints its bounds from the same functions.
"""
from __future__ import annotations

import torch

# flops per ray-prim test, as counted in the kernels' notes
FLOPS_PER_TEST = {"raster_sweep": 26, "ray_sweep": 50}
# flops per PLOC pair area: 6 mins for the union, 6 for the extents
# (negate, subtract), 5 for the products and their sums, 1 doubling; a
# lane needs R pair areas (each pair serves both its lanes)
FLOPS_PER_PAIR = 18
# bytes a traversal row stood on must give once (internal, leaf), on either
# layout: two child boxes, left and right; or the triangle and its prim. A
# ray reads 24 B and writes 20 B
TRAVERSE_ROW_BYTES = (56, 40)
TRAVERSE_RAY_BYTES = 44
# bytes each traversal step loads (node step, leaf step), most of them from
# the caches: four or three 16-byte words of a packed row; on the Bvh2
# layout left, right and two child boxes, or left and the triangle
TRAVERSE_STEP_BYTES = {"packed": (64, 48), "bvh2": (56, 40)}
# flops a node step (two slabs), a leaf step (three vertex transforms and
# the triangle test) and a ray (two inverse transforms, three reciprocals)
TRAVERSE_STEP_FLOPS = (48, 203)
TRAVERSE_RAY_FLOPS = 81
# bytes a row of deltas: B12/B13 read 4 and write 8, B14 8 and 16, B15 4
# and 8, each B16 half 4 and 12
ROW_BYTES = {"psv_nsv_packed": 12, "psv_nsv_payload": 24, "child_positions": 12,
             "scan32_half": 16}
# bytes a primitive of the front half's kernels from triangles: A reads 36
# and writes 24, B reads 24 and writes 8, C reads 8 (the key), gathers 24
# and writes 36; from PrimRefs B reads prim_idx (4) and C pos (8) besides
FRONT_HALF_BYTES = {"tri_box": 60, "keys": 32, "gather": 68}
FRONT_HALF_REFS_BYTES = {"tri_box": 0, "keys": 4, "gather": 8}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def per_row(kind: str, m: int):
    """A threshold scan (B12/B13, B14, B15) or a B16 half on m deltas."""
    return ROW_BYTES[kind] * m, 0, f"m {m}"


def front_half(kind: str, n: int, refs: bool = False):
    """A front-half kernel (`ops/front_half.py`: A, B, C) on n primitives:
    each input byte read once, each output written once; `refs`, the
    PrimRefs route, adds the reads of prim_idx (B) and pos (C)."""
    return (FRONT_HALF_BYTES[kind] + refs * FRONT_HALF_REFS_BYTES[kind]) * n, 0, f"n {n}"


def plane_scan(x):
    """B11 reads and writes its plane once."""
    return 2 * nbytes(x), 0, f"plane {tuple(x.shape)}"


def scan32(dlt, outs):
    """B1: its deltas read, its six rows written."""
    return nbytes(dlt, *outs), 0, ""


def refit_dense(cols, first, last, outs):
    """B2: the leaf columns and the ranges read, acc, short and t4 written."""
    return nbytes(cols, first, last, *outs), 0, ""


def batched(tris_b):
    """A batched build: 36 B a prim read; per mesh 32 B a node (6 box rows,
    left, right) and 4 B of root written."""
    B, M = tris_b.shape[:2]
    return B * M * 36 + B * (32 * (2 * M - 1) + 4), 0, f"{B} x {M}"


def collapse_block(meta, carr, outm, outa, m: int):
    """B3: the 8 meta rows and carr row 5 at every lane, carr's other 29
    used rows (slots, count, slot AABBs) only at the coarse wide lanes, and
    the 6 AABB rows of node8 or leaf8 only at the slots of the short wide
    lanes read; outm and the four outa written once."""
    W = meta.shape[1]
    n_cw = int((carr[5] == 1).sum())
    short_wide = (outm[5] == 0) & (meta[5] == 1) & (torch.arange(W, device=meta.device) < m)
    n_slots = int((outm[0:4][:, short_wide] >= 0).sum())
    n_bytes = 4 * (9 * W + 29 * n_cw + 6 * n_slots) + nbytes(outm, *outa)
    return n_bytes, 0, f"W {W}, {n_cw} coarse wide lanes, {n_slots} slots of short wide lanes"


def collapse_prep(n: int, n_long: int, meta=None, carr=None):
    """The collapse's prep kernels on a tree of n leaves with n_long long
    nodes. P1 (`collapse_prep`, no rows given): the box (6 words) of each of
    the 2n - 1 nodes, left, right, parent, first and last of the n - 1
    internal nodes and the n leaves' parents read; the 56 rows of B3's input
    (W = n), rank and the long ids written. P2 (`collapse_coarse`, given the
    rows it wrote into): per long node its id, links and parent's rank, its
    children's areas and links read and its seed and own written; the seed
    and own of each short node it seeds; and per wide long node its 30
    coarse words written and 6 box words a slot read (the expansion's
    deeper gathers and the doubling's scratch left out, so a floor)."""
    m = n - 1
    if meta is None:
        words = 6 * (2 * n - 1) + 5 * m + n + 56 * n + m + n_long
        return 4 * words, 0, f"n {n}, {n_long} long nodes"
    seeded = int((((meta[4, :m] >> 23) < 3) & (meta[5, :m] == 1)).sum())
    wide = carr[5] == 1
    n_wide = int(wide.sum())
    n_slots = int((carr[0:4][:, wide] >= 0).sum())
    words = 13 * n_long + 2 * seeded + 30 * n_wide + 6 * n_slots
    return (4 * words, 0, f"{n_long} long nodes, {n_wide} of them wide with {n_slots} slots, "
                          f"{seeded} short nodes seeded")


def sweep(name: str, args, out):
    """A split sweep (B4 `raster_sweep`, B5 `ray_sweep`): every input read
    once (of the slabs only the treelets that live pairs touch), every
    output written once; flops = the ray-prim tests this call made (the sum
    of the count output) times the flops per test."""
    rays_in, slabs, p_tid, p_tlb, p_bits, t_start, t_end = args[:7]
    touched = int(torch.unique(p_tid[p_bits != 0]).numel())
    slab_bytes = touched * slabs.shape[1] * slabs.shape[2] * slabs.element_size()
    n_bytes = nbytes(rays_in, p_tid, p_tlb, p_bits, t_start, t_end, *out) + slab_bytes
    tests = int(out[4].sum(dtype=torch.int64))
    # a subgroup's rays share their count: its sweeps = count / L
    sweeps = out[4].reshape(-1, 256)[:, 0].double() / slabs.shape[1]
    info = (f"{tests} ray-prim tests; sweeps per 256-ray block: mean {float(sweeps.mean())!r}, "
            f"max {int(sweeps.max())}")
    return n_bytes, tests * FLOPS_PER_TEST[name], info


def traverse(stats, rows, name: str, n_rays: int):
    """A traversal kernel: every row its steps stood on read once (`rows`:
    internal, leaf) and the rays' bytes, against the slab and triangle
    flops of its steps (`stats`, its device counters: node steps, leaf
    steps, overflowed rays). The steps' own loads, mostly served by the
    caches, are in the info."""
    node_steps, leaf_steps = (int(x) for x in stats[:2])
    n_int, n_leaf = (int(x) for x in rows)
    n_bytes = (n_int * TRAVERSE_ROW_BYTES[0] + n_leaf * TRAVERSE_ROW_BYTES[1]
               + n_rays * TRAVERSE_RAY_BYTES)
    f_node, f_leaf = TRAVERSE_STEP_FLOPS
    flops = node_steps * f_node + leaf_steps * f_leaf + n_rays * TRAVERSE_RAY_FLOPS
    s_node, s_leaf = TRAVERSE_STEP_BYTES["packed" if name == "packed" else "bvh2"]
    info = (f"{n_int} internal and {n_leaf} leaf rows stood on; {node_steps} node steps, "
            f"{leaf_steps} leaf steps ({node_steps * s_node + leaf_steps * s_leaf} B loaded by "
            f"the steps), {int(stats[2])} overflowed rays over {n_rays} rays")
    return n_bytes, flops, info


def _ploc_info(nc, n_merged, n_dropped, shift):
    return f"{nc} clusters, {n_merged} merges, {n_dropped} dropped, shift {shift}"


def _state_rows(shift: int) -> int:
    return 7 if shift >= 32 else 8  # one segment at shift 32: the code row is not needed


def ploc_nn(nc: int, radius: int, shift: int):
    """B10: the state rows of every live lane read, its 8 output rows
    written, R pair areas a lane."""
    return (4 * (_state_rows(shift) + 8) * nc, nc * radius * FLOPS_PER_PAIR,
            f"{nc} clusters, shift {shift}")


def ploc_emit_compact(nc: int, n_merged: int, n_dropped: int, width: int):
    """B9: the flag row of every live lane, the 8 state rows of a survivor
    that did not merge, state rows 6-7 and NN rows 0-6 of a merge lane and
    nothing more of a dropped lane read; 8 rows per survivor and per merged
    node written, and 8 rows of zeros per column past the survivors (its
    new state is whole)."""
    n_keep = nc - n_dropped
    reads = nc + 8 * (n_keep - n_merged) + 9 * n_merged
    writes = 8 * n_keep + 8 * n_merged + 8 * (width - n_keep)
    return (4 * (reads + writes), 0,
            f"{nc} clusters, {n_merged} merges, {n_dropped} dropped, {width} columns")


def _round_reads(nc, n_keep, shift):
    """A round reads the state once (at shift 32 the code row only of
    survivors)."""
    return _state_rows(shift) * nc + (n_keep if shift >= 32 else 0)


def ploc_round(nc: int, n_merged: int, n_dropped: int, radius: int, shift: int):
    """B6: the state read once, the survivors and the merged nodes written."""
    n_keep = nc - n_dropped
    writes = 8 * n_keep + 8 * n_merged
    return (4 * (_round_reads(nc, n_keep, shift) + writes), nc * radius * FLOPS_PER_PAIR,
            _ploc_info(nc, n_merged, n_dropped, shift))


def ploc_round_fused(nc: int, n_merged: int, n_dropped: int, radius: int, shift: int):
    """B8: as B6, but it writes the whole new state, zeros past the
    survivors."""
    n_keep = nc - n_dropped
    return (4 * (_round_reads(nc, n_keep, shift) + 8 * nc + 8 * n_merged),
            nc * radius * FLOPS_PER_PAIR, _ploc_info(nc, n_merged, n_dropped, shift))


def finish_rounds(mat, nc: int, shift: int, radius: int, step: int):
    """(rounds, cluster-rounds) of the finisher on nc live clusters of
    `mat`: the plain rounds until one cluster is left, the sum of their
    live clusters."""
    from ..ops import ploc_round

    rounds = lanes = 0
    nc0 = nc
    sink = torch.empty((8, max(nc - 1, 1)), dtype=torch.int32, device=mat.device)
    st = mat[:, :nc]
    while nc > 1:
        if rounds == nc0 + 16:  # the finisher's own limit
            raise RuntimeError(f"finish_rounds: {nc} clusters left after {rounds} rounds")
        rounds, lanes = rounds + 1, lanes + nc
        st, _, nm = ploc_round.ploc_round_reference(st, sink, nc, shift, 0, radius)
        nc -= int(nm)
        st = st[:, :nc]
        shift = min(shift + step, 32)
    return rounds, lanes


def ploc_finish(mat, nc: int, shift: int, radius: int, step: int, ctas: int):
    """B7: the state rows of its clusters read once, its nc - 1 nodes
    written; R pair areas a cluster a round."""
    rounds, lanes = finish_rounds(mat, nc, shift, radius, step)
    return (4 * (_state_rows(shift) * nc + 8 * (nc - 1)), lanes * radius * FLOPS_PER_PAIR,
            f"{nc} clusters, {rounds} rounds, {lanes} cluster-rounds, a cluster of {ctas} CTAs")
