"""The tile schedule of B2, the dense refit (`csrc/refit_dense.cu`), held on
the CPU by a plain-torch emulation.

The kernel's block owns T columns [t0, t0 + T). It stages the six packed
rows of columns [t0 - R, t0 + T + max(R, 15)) (+3e38 outside [0, s)) and
answers each column's union as one contiguous range of staged columns,
[i - kb + 1, i + kf] with the forward part cut at column n - 1, then one
more min with +3e38; t4 as the range [i, min(i + 15, n - 1)], with +3e38
where the window passes n - 1. The ranges come from a sparse table built in
place over the staged rows (two lookups at level floor(log2(len))). The
emulation runs that schedule with small tiles (T = 64 and 256), so a call
spans several tiles and n is no multiple of T, at radius 15, 24 and 128, on
columns that hold +0.0, -0.0 and NaN, and on a `mat` wider than n; every
output must equal `refit_dense_reference` bit for bit.
"""
import numpy as np
import pytest
import torch

from tpu_bvh_torch.ops import refit_dense
from tpu_bvh_torch.ops.aabb import fmin

BIG = refit_dense.BIG
F32 = torch.float32


def _floor_log2(x):
    return (torch.frexp(x.to(torch.float64)).exponent - 1).to(torch.int64)


def tiled(mat, n, radius, tile):
    """(acc, short, t4) of the kernel's schedule on `mat` i32[8, s]."""
    s = mat.shape[1]
    cols = mat[0:6].view(F32)
    R = radius
    acc = torch.empty((6, s), dtype=F32)
    t4 = torch.empty((6, s), dtype=F32)
    short = torch.empty((s,), dtype=torch.bool)
    for t0 in range(0, s, tile):
        lo0 = t0 - R
        span = min(tile, s - t0) + R + max(R, 15)
        j = torch.arange(lo0, lo0 + span)
        sm = torch.where((j >= 0) & (j < s), cols[:, j.clamp(0, s - 1)], BIG)
        i = torch.arange(t0, min(t0 + tile, s))
        f, l = mat[6, i].long(), mat[7, i].long()
        la, ab = l - i, i - f
        kb = torch.where(ab < 0, 0, torch.clamp(ab, max=R - 1) + 1)
        kf = torch.where(la < 1, 0, torch.clamp(la, max=R))
        a_lo = i - kb + 1 - lo0
        a_len = kb + torch.clamp(torch.minimum(kf, n - 1 - i), min=0)
        t_lo = i - lo0
        t_len = torch.clamp(torch.clamp(n - 1 - i, max=15) + 1, min=0)
        short[i] = (ab < R) & (la <= R)
        va = torch.full((6, i.numel()), BIG, dtype=F32)
        vt = va.clone()
        top = int(_floor_log2(torch.tensor(2 * R)))
        ka, kt = _floor_log2(a_len.clamp(min=1)), _floor_log2(t_len.clamp(min=1))
        for k in range(top + 1):
            h = 1 << k
            for v, lo, ln, kk in ((va, a_lo, a_len, ka), (vt, t_lo, t_len, kt)):
                sel = (ln > 0) & (kk == k)
                v[:, sel] = fmin(sm[:, lo[sel]], sm[:, (lo + ln - h)[sel]])
            if k < top:  # the next level in place, as the kernel's read-barrier-write
                sm[:, :span - h] = fmin(sm[:, :span - h], sm[:, h:span])
        acc[:, i] = fmin(va, torch.full_like(va, BIG))
        t4[:, i] = torch.where(t_len < 16, fmin(vt, torch.full_like(vt, BIG)), vt)
    return acc, short, t4


def _mat(n, s, radius, seed):
    """Packed columns with +-0.0 pairs and a NaN in a min and a -max row,
    mixed ranges first <= i < last; `mat` is s >= n columns wide."""
    rng = np.random.default_rng(seed)
    cols = rng.random((6, s), dtype=np.float32)
    cols[3:] = -(cols[:3] + 0.1)
    zeros = np.where(rng.random(s) < 0.5, np.float32(0.0), np.float32(-0.0))
    for r in (0, 4):
        cols[r] = np.where(rng.random(s) < 0.4, zeros, cols[r])
    cols[1, rng.integers(0, s, 2)] = np.nan
    cols[5, rng.integers(0, s, 2)] = np.nan
    i = np.arange(s)
    first = np.clip(i - rng.integers(0, 3 * radius, s), 0, n - 1)
    last = np.minimum(i + 1 + rng.integers(0, 3 * radius, s), n - 1)
    first[n - 1:], last[n - 1:] = n - 1, n - 1
    mat = np.concatenate([cols.view(np.int32), first[None], last[None]]).astype(np.int32)
    return torch.from_numpy(mat)


def assert_bits(got, want):
    for g, w, name in zip(got, want, ("acc", "short", "t4")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.numpy().tobytes() == w.numpy().tobytes(), name


@pytest.mark.parametrize("radius", [15, 24, 128])
@pytest.mark.parametrize("n,s", [(1000, 1000), (333, 340)])
@pytest.mark.parametrize("tile", [64, 256])
def test_tile_schedule_equals_plain(radius, n, s, tile):
    mat = _mat(n, s, radius, n + radius)
    assert_bits(tiled(mat, n, radius, tile), refit_dense.refit_dense_reference(mat, n, radius))


def test_cols_entry_equals_mat_entry():
    """`refit_dense_cols` on (packed_t, first, last) == `refit_dense` on the
    concatenated `mat` (edge column n - 1: first = last = n - 1)."""
    n, radius = 700, 24
    mat = _mat(n, n, radius, 3)
    packed_t, first, last = mat[0:6].view(F32), mat[6, :n - 1], mat[7, :n - 1]
    assert torch.equal(refit_dense.cols_mat(packed_t, first, last), mat)
    assert_bits(refit_dense.refit_dense_cols(packed_t, first, last, n, radius),
                refit_dense.refit_dense(mat, n, radius))


@pytest.mark.parametrize("radius", [14, 129])
def test_radius_outside_the_halo_raises(radius):
    mat = _mat(64, 64, 24, 0)
    with pytest.raises(ValueError):
        refit_dense.refit_dense(mat, 64, radius)
