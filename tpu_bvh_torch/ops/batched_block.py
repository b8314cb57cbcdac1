"""Batched build of mid-size meshes: one BVH2 per mesh of 65 to 1024 prims.

The contract of `tpu_bvh.models.batched.build_batched` past the dense
form's capacity, `jax.vmap(lambda t: lbvh.build_single_pass(t,
use_extended=False))`: for tris_b f32[B, M, 3, 3] (64 < M <= MAX_PRIMS)
it returns, per mesh b, the single-pass (Apetrei layout) tree of its M
prims with plain 30-bit Morton codes:

* packed_t f32[B, 6, 2M - 1]: internal nodes 0..M-2, then the leaves in
  sorted order, rows (min xyz, -max xyz);
* left, right i32[B, 2M - 1]: a leaf's left is its prim, its right -1;
* root i32[B].

Leaves are sorted stably by code (the key (code << 10) | prim); boundary j
has delta clz(code_j ^ code_j+1), or 32 + clz(j ^ (j + 1)) on equal codes,
remapped to [0, 52]; an internal node's leaf range [first, last] ends at
the last earlier and the first later smaller delta, and its children are
the earliest argmins of the deltas inside. Its box is the exact min over
its leaves, taken down to 3e38 where the single-pass refit's stencil or
its two-level table fills with 3e38 (`_clamped`): JAX's
`refit_anchored_packed` at its radius 16, whose `lax.cond` between that
path and the exact full table is, under `vmap`, a choice per mesh. Mins
and maxes follow `jnp.minimum` / `jnp.maximum` (`aabb.fmin`, `fmax`; a
reduction is one exact min of `aabb.min_key`s), so the trees equal JAX's
bit for bit. (JAX's dense form for M <= 64 packs a child as
(delta << 6) | j, which holds only while m <= 63: past that it gives
other children than the vmapped build, so this contract is the vmapped
build's.)

A CUDA tensor launches `csrc/batched_block.cu` (one launch a call, one
block a mesh, counted in `kernels.launches`); a CPU tensor takes the plain
version, `batched_block_reference`. M outside (64, MAX_PRIMS] is refused
on either device before any work.
"""
from __future__ import annotations

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda
from . import batched_build, morton, radix_tree, refit, scan32, threshold_core
from .aabb import fmax, fmin, from_min_key, min_key

MIN_PRIMS = batched_build.MAX_PRIMS + 1  # the first capacity past the warp kernel
MAX_PRIMS = 1024  # the largest capacity (kMaxPrims in csrc/batched_block.cu)
RADIUS = 16  # JAX's refit radius off the TPU's stencil kernel (kRadius)
BIG_KEY = int(min_key(torch.tensor([refit.BIG], dtype=torch.float32)))
I32 = torch.int32
FOLD_ROWS = 1 << 21  # rows of one folded plain topology (its child table needs < 2^22)


def _check(tris_b) -> None:
    if tris_b.dim() != 4 or tuple(tris_b.shape[2:]) != (3, 3):
        raise ValueError(f"tris_b: expected [B, M, 3, 3], got {tuple(tris_b.shape)}")
    if not MIN_PRIMS <= tris_b.shape[1] <= MAX_PRIMS:
        raise ValueError(f"batched_block takes {MIN_PRIMS} <= M <= {MAX_PRIMS} prims a mesh, "
                         f"got M = {tris_b.shape[1]}")


def batched_block(tris_b):
    """(packed_t, left, right, root) of every mesh; dispatch by device."""
    _check(tris_b)
    if on_cuda(tris_b):
        kernels.require(tris_b, "tris_b", torch.float32)
        return _launch(tris_b)
    return batched_block_reference(tris_b)


def _empty(B, M, dev):
    W = 2 * M - 1
    return (torch.empty((B, 6, W), dtype=torch.float32, device=dev),
            torch.empty((B, W), dtype=I32, device=dev), torch.empty((B, W), dtype=I32, device=dev),
            torch.empty((B,), dtype=I32, device=dev))


def batched_block_reference(tris_b):
    """Plain PyTorch version (any device), with no [B, M, M] temporaries:
    the sort per mesh, the topology as one threshold scan of the batch
    folded into one row (each mesh's deltas shifted up by one and walled at
    its end by a 0, so no node's range crosses a wall), the boxes from a
    [levels, B, 6, M] min table, in chunks of at most FOLD_ROWS rows."""
    _check(tris_b)
    B, M = tris_b.shape[:2]
    if B == 0:
        return _empty(0, M, tris_b.device)
    step = max(1, FOLD_ROWS // M)
    outs = [_reference_chunk(tris_b[s:s + step]) for s in range(0, B, step)]
    return tuple(torch.cat(f) for f in zip(*outs))


def _reference_chunk(tris_b):
    B, M = tris_b.shape[:2]
    m = M - 1
    dev = tris_b.device
    t9 = tris_b.reshape(B, M, 9).transpose(1, 2)  # [B, 9, M]
    mn = [fmin(fmin(t9[:, a], t9[:, 3 + a]), t9[:, 6 + a]) for a in range(3)]
    mx = [fmax(fmax(t9[:, a], t9[:, 3 + a]), t9[:, 6 + a]) for a in range(3)]
    smin = [from_min_key(min_key(c).amin(dim=1, keepdim=True)) for c in mn]
    smax = [-from_min_key(min_key(-c).amin(dim=1, keepdim=True)) for c in mx]
    norm = []
    for lo, hi, s0, s1 in zip(mn, mx, smin, smax):
        ext = s1 - s0
        norm.append(((lo + hi) * 0.5 - s0) / torch.where(ext > 0, ext, 1.0))
    codes = morton.morton30_cols(*norm)  # int64 [B, M] of u32 values
    prim = torch.arange(M, dtype=torch.int64, device=dev)
    skey = torch.sort(codes * 1024 + prim, dim=1).values  # (code, prim) is unique: stable
    order = skey & 1023
    rows = torch.stack([*mn, *(-c for c in mx)], dim=1)  # [B, 6, M] by prim
    leaf_packed = rows.gather(2, order[:, None, :].expand(B, 6, M))
    dlt = scan32.remap_deltas(radix_tree.adjacent_deltas(skey >> 10)).to(I32)  # [B, m]

    # the topology of the folded row: mesh b's boundary j at b * M + j, its wall at b * M + m
    row = torch.cat([dlt + 1, torch.zeros((B, 1), dtype=I32, device=dev)], dim=1).reshape(-1)
    n_row = B * M
    psv_p, nsv_p = threshold_core.psv_nsv_packed_reference(row)
    psv_g = torch.where(psv_p >= 0, psv_p >> 6, -1)
    nsv_g = torch.where(nsv_p != threshold_core.BIG, nsv_p >> 6, n_row)
    lc_g, rc_g = threshold_core.child_positions_from_ranges(row, psv_g, nsv_g)
    base = torch.arange(B, dtype=I32, device=dev)[:, None] * M

    def local(x):
        return x.reshape(B, M)[:, :m] - base

    first = local(psv_g) + 1
    last = local(nsv_g)
    lc = torch.where(lc_g.reshape(B, M)[:, :m] >= 0, local(lc_g), -1)
    rc = torch.where(rc_g.reshape(B, M)[:, :m] >= 0, local(rc_g), -1)

    # the boxes: the exact min over [first, last] from a min table per mesh
    keys = min_key(leaf_packed).reshape(B * 6, M)
    tabs = [keys]
    while 1 << len(tabs) <= M:  # ranges of up to M leaves
        tabs.append(refit._shift_min(tabs[-1], 1 << (len(tabs) - 1)))
    table = torch.stack(tabs).reshape(len(tabs), B, 6, M)
    k = refit._floor_log2(last - first + 1)  # [B, m]
    b_idx = torch.arange(B, device=dev)[:, None, None]
    r_idx = torch.arange(6, device=dev)[None, :, None]
    kk = k[:, None, :].long()
    lo = table[kk, b_idx, r_idx, first[:, None, :].long()]
    hi = table[kk, b_idx, r_idx, (last - (1 << k) + 1)[:, None, :].long()]
    exact = torch.minimum(lo, hi)  # [B, 6, m]
    clamp = _clamped(first, last)
    int_packed = from_min_key(torch.where(clamp[:, None, :], exact.clamp(max=BIG_KEY), exact))

    jj = torch.arange(m, dtype=I32, device=dev)
    is_root = (first == 0) & (last == m)
    root = torch.argmax(is_root.to(I32), dim=1).to(I32)
    left = torch.cat([torch.where(lc >= 0, lc, m + jj), order.to(I32)], dim=1)
    right = torch.cat([torch.where(rc >= 0, rc, m + jj + 1),
                       torch.full((B, M), -1, dtype=I32, device=dev)], dim=1)
    return torch.cat([int_packed, leaf_packed], dim=2), left, right, root


def _clamped(first, last):
    """bool[B, m]: the nodes whose box the single-pass refit takes down to
    3e38 (JAX's `refit_anchored_packed` at RADIUS 16). A mesh whose long
    nodes (range reaching more than RADIUS past its boundary) outnumber
    the budget `cap` takes the exact full table; otherwise a short node is
    the stencil's min from 3e38, and a long node the two-level table's,
    which fills with 3e38 where no whole block of 16 leaves lies inside."""
    m = first.shape[1]
    i = torch.arange(m, dtype=I32, device=first.device)
    long = ~((i - first < RADIUS) & (last - i <= RADIUS))
    cap = min(m, max(64, (4 * m) // (3 * RADIUS)))
    full_table = (long.sum(1, keepdim=True) > cap) & (cap < m)
    has_mid = (((last + 1) >> 4) - 1) >= ((first + 15) >> 4)
    return ~full_table & (~long | ~has_mid)


def _launch(tris_b, clk=None):
    """One launch for the whole batch (none for an empty batch)."""
    B, M = tris_b.shape[:2]
    out = _empty(B, M, tris_b.device)
    if B == 0:
        return out
    kernels.launch("batched_block", "tbvh_batched_block", tris_b, B, M, *out, clk, like=tris_b,
                   count=lambda: work.batched(tris_b), symbols="batched_block")
    return out


def phase_cycles(tris_b) -> dict:
    """One launch on the CUDA tensor `tris_b` with its phase clocks on
    (thread 0 of each block reads clock64 at the start and after each of
    `batched_build.PHASES`, into i64[B, 6]): per phase the median and the largest of
    the blocks' SM cycles and the sum over the blocks, and the median of
    their totals."""
    _check(tris_b)
    kernels.require(tris_b, "tris_b", torch.float32)
    clk = torch.zeros((tris_b.shape[0], len(batched_build.PHASES) + 1), dtype=torch.int64,
                      device=tris_b.device)
    _launch(tris_b, clk)
    return batched_build.cycles_by_phase(clk)
