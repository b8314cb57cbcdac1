"""Dense batched build of tiny meshes: one BVH2 per mesh of at most 64 prims.

The contract of `tpu_bvh.models.batched._build_batched_small`, the JAX
package's all-pairs form of the reference's whole-pipeline-in-one-block
batched kernel (`BatchedBuildKernel.h:218-312`). For tris_b f32[B, M, 3, 3]
(2 <= M <= 64) it returns, per mesh b, the single-pass (Apetrei layout)
tree of its M prims with plain 30-bit Morton codes:

* packed_t f32[B, 6, 2M - 1]: internal nodes 0..M-2, then the leaves in
  sorted order, rows (min xyz, -max xyz);
* left, right i32[B, 2M - 1]: a leaf's left is its prim, its right -1;
* root i32[B].

Leaves are sorted stably by code (the key (code << 6) | prim); boundary j
has delta clz(code_j ^ code_j+1), or 32 + clz(j ^ (j + 1)) on equal codes,
remapped to [0, 52]; an internal node's leaf range ends at the last earlier
and the first later smaller delta, its children are the earliest argmins of
the deltas inside, and its box is the min over its leaves (with 3e38 where
the range is not the whole mesh, as JAX's masked min has it). Every min and
max follows `jnp.minimum` / `jnp.maximum` (`aabb.fmin`, `fmax`; reductions as
one exact min of `aabb.min_key`s), so the trees equal JAX's bit for bit.

A CUDA tensor launches `csrc/batched_build.cu` (one launch a call, one warp
a mesh, counted in `kernels.launches`); a CPU tensor takes the plain version,
`batched_build_reference`. M outside [2, MAX_PRIMS] is refused on either
device before any work (JAX fails on M = 1; the packing (delta << 6) | j
holds up to 63 boundaries).
"""
from __future__ import annotations

import torch

from ..utils import kernels, work
from ..utils.platform import on_cuda
from . import morton, radix_tree, scan32
from .aabb import fmax, fmin, from_min_key, min_key

MAX_PRIMS = 64  # the largest capacity (kMaxPrims in csrc/batched_build.cu)
WALK_MAX = 48  # past it (two slots a lane) the kernel refits from tables (kWalkMax)
BIG = 3.0e38
I32 = torch.int32


def _check(tris_b) -> None:
    if tris_b.dim() != 4 or tuple(tris_b.shape[2:]) != (3, 3):
        raise ValueError(f"tris_b: expected [B, M, 3, 3], got {tuple(tris_b.shape)}")
    if not 2 <= tris_b.shape[1] <= MAX_PRIMS:
        raise ValueError(f"batched_build takes 2 <= M <= {MAX_PRIMS} prims a mesh, "
                         f"got M = {tris_b.shape[1]}")


def batched_build(tris_b):
    """(packed_t, left, right, root) of every mesh; dispatch by device."""
    _check(tris_b)
    if on_cuda(tris_b):
        kernels.require(tris_b, "tris_b", torch.float32)
        return _launch(tris_b)
    return batched_build_reference(tris_b)


def batched_build_reference(tris_b):
    """Plain PyTorch version (any device): JAX's all-pairs form, with
    [B, m, m] masks for the leaf ranges and children and a [B, 6, m, M]
    masked min for the boxes."""
    _check(tris_b)
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
    skey = torch.sort(codes * 64 + prim, dim=1).values  # (code, prim) is unique: stable
    leaf_prim = (skey & 63).to(I32)
    rows = torch.stack([*mn, *(-c for c in mx)], dim=1)  # [B, 6, M] by prim
    leaf_packed = rows.gather(2, (skey & 63)[:, None, :].expand(B, 6, M))
    dlt = scan32.remap_deltas(radix_tree.adjacent_deltas(skey >> 6))  # [B, m] in [0, 52]

    bigi = 1 << 30
    jj = torch.arange(m, dtype=I32, device=dev)
    jlt = jj[None, :] < jj[:, None]  # [i, j]: j < i
    jgt = jj[None, :] > jj[:, None]
    less = dlt[:, None, :] < dlt[:, :, None]  # [B, i, j]: dlt_j < dlt_i
    psv = torch.where(jlt & less, jj, -1).amax(dim=2)
    nsv = torch.where(jgt & less, jj, bigi).amin(dim=2)
    first = psv + 1
    last = torch.where(nsv < bigi, nsv, m)
    packed = ((dlt << 6) | jj)[:, None, :]
    lmin = torch.where((jj > psv[..., None]) & jlt, packed, bigi).amin(dim=2)
    rmin = torch.where(jgt & (jj < last[..., None]), packed, bigi).amin(dim=2)
    lc = torch.where(lmin < bigi, lmin & 63, -1)
    rc = torch.where(rmin < bigi, rmin & 63, -1)

    jl = torch.arange(M, dtype=I32, device=dev)
    inr = (jl >= first[..., None]) & (jl <= last[..., None])  # [B, m, M]
    fill = min_key(torch.tensor(BIG, dtype=torch.float32, device=dev))
    keys = torch.where(inr[:, None], min_key(leaf_packed)[:, :, None, :], fill)
    int_packed = from_min_key(keys.amin(dim=3))  # [B, 6, m]

    is_root = (first == 0) & (last == m)
    root = torch.where(is_root, jj, bigi).amin(dim=1)
    left = torch.cat([torch.where(lc >= 0, lc, m + jj), leaf_prim], dim=1)
    right = torch.cat([torch.where(rc >= 0, rc, m + jj + 1),
                       torch.full((B, M), -1, dtype=I32, device=dev)], dim=1)
    return torch.cat([int_packed, leaf_packed], dim=2), left, right, root


def _launch(tris_b, clk=None):
    """One launch for the whole batch (none for an empty batch); `clk`
    i64[B, 6] takes each warp's phase clocks."""
    B, M = tris_b.shape[:2]
    dev = tris_b.device
    packed_t = torch.empty((B, 6, 2 * M - 1), dtype=torch.float32, device=dev)
    left = torch.empty((B, 2 * M - 1), dtype=I32, device=dev)
    right = torch.empty((B, 2 * M - 1), dtype=I32, device=dev)
    root = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return packed_t, left, right, root
    kernels.launch("batched_build", "tbvh_batched_build", tris_b, B, M, packed_t, left, right,
                   root, clk, like=tris_b, count=lambda: work.batched(tris_b),
                   symbols="batched_build_warp")
    return packed_t, left, right, root


PHASES = ("load and boxes", "codes and sort", "topology", "refit", "writes")


def phase_cycles(tris_b) -> dict:
    """One launch on the CUDA tensor `tris_b` with its phase clocks on
    (lane 0 of each warp reads clock64 at the start and after each of the
    PHASES, into i64[B, 6]): per phase the median and the largest of the
    warps' SM cycles and their sum over the meshes, and the median of the
    warps' totals."""
    _check(tris_b)
    kernels.require(tris_b, "tris_b", torch.float32)
    clk = torch.zeros((tris_b.shape[0], len(PHASES) + 1), dtype=torch.int64,
                      device=tris_b.device)
    _launch(tris_b, clk)
    return cycles_by_phase(clk)


def cycles_by_phase(clk) -> dict:
    """Per phase of an i64[units, 6] clock64 record: (median, largest, sum)
    of the units' cycles; "total" the median of their sums."""
    d = torch.diff(clk.cpu(), dim=1)
    out = {name: (d[:, k].median().item(), d[:, k].max().item(), d[:, k].sum().item())
           for k, name in enumerate(PHASES)}
    out["total"] = d.sum(1).median().item()
    return out
