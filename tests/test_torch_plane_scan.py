"""B11 plane scan: the port's plain version equals the Pallas kernel
(interpret mode) and lax's cumulative ops bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops.pallas import plane_scan as jps
from tpu_bvh_torch.ops import plane_scan


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("reverse", [True, False])
def test_plane_scan_matches_pallas(is_min, reverse):
    m = 1500
    rng = np.random.default_rng(m + is_min * 10 + reverse)
    x = rng.integers(-(2**30), 2**30, size=(m, 64), dtype=np.int32)
    got = plane_scan.plane_scan(torch.from_numpy(x), is_min=is_min, reverse=reverse)
    assert got.dtype == torch.int32 and got.shape == (m, 64)
    want = jps.plane_scan(jnp.asarray(x), is_min=is_min, reverse=reverse, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lax = jps.plane_scan_reference(jnp.asarray(x), is_min=is_min, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lax))
    auto = plane_scan.plane_scan_auto(torch.from_numpy(x), is_min=is_min, reverse=reverse)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("m,v", [(1, 64), (2, 3), (257, 5), (64, 130)])
def test_plane_scan_odd_shapes_match_cummin(m, v):
    """Single rows and widths other than 64, against torch's own cumulative ops."""
    x = torch.from_numpy(np.random.default_rng(m * v).integers(-9, 9, size=(m, v), dtype=np.int32))
    for is_min, fn in ((True, torch.cummin), (False, torch.cummax)):
        assert torch.equal(plane_scan.plane_scan(x, is_min=is_min, reverse=False),
                           fn(x, dim=0).values)
        assert torch.equal(plane_scan.plane_scan(x, is_min=is_min, reverse=True),
                           torch.flip(fn(torch.flip(x, [0]), dim=0).values, [0]))


# ---------------------------------------------------------------------------
# csrc/plane_scan.cu's schedule, emulated: a tile is 16 row groups of
# `rows` rows (8 in the kernel: plane_scan.TILE_ROWS) by a strip of
# plane_scan.COLS columns; a warp holds two row groups, a block 8 warps.
# The tiles' carries come from a decoupled look-back run in a shuffled
# order: tickets are drawn in scan order, and any drawn tile may take its
# next step (publish some of its columns' aggregates, look at the tile
# before it, publish some of its inclusive prefixes) at any time.
# ---------------------------------------------------------------------------

GROUPS = 16  # row groups a tile (kThreads / 16 column groups)
WARPS = 8


def _tile(x, is_min, reverse, rows):
    """One tile [16 * rows, COLS] as the kernel scans it: each row group
    in registers, the pair by a shuffle, the warps through their
    aggregates. Returns (the tile scanned without its carry, its aggregate)."""
    op = torch.minimum if is_min else torch.maximum
    ident = torch.iinfo(torch.int32).max if is_min else torch.iinfo(torch.int32).min
    v = x.view(GROUPS, rows, -1).clone()
    order = range(rows - 2, -1, -1) if reverse else range(1, rows)
    for k in order:
        v[:, k] = op(v[:, k + 1] if reverse else v[:, k - 1], v[:, k])
    own = v[:, 0] if reverse else v[:, -1]
    own = own.view(WARPS, 2, -1)
    first, second = (own[:, 1], own[:, 0]) if reverse else (own[:, 0], own[:, 1])
    pair = torch.full_like(own, ident)  # the second group of a pair takes the first's
    pair[:, 0 if reverse else 1] = first
    warp = op(first, second)
    pre = torch.full_like(warp, ident)
    for w in range(WARPS):
        for u in (range(w + 1, WARPS) if reverse else range(w)):
            pre[w] = op(pre[w], warp[u])
    pre = op(pair, pre[:, None]).reshape(GROUPS, 1, -1)
    agg = warp.amin(0) if is_min else warp.amax(0)
    return op(pre, v).reshape(GROUPS * rows, -1), agg


def _look_back(aggs, is_min, rng):
    """Each tile's exclusive carry (aggs [T, C] in scan order) from the
    look-back in a shuffled order; a column's status is None, ("A", value)
    or ("P", value)."""
    op = min if is_min else max
    ident = torch.iinfo(torch.int32).max if is_min else torch.iinfo(torch.int32).min
    t_count, cols = aggs.shape
    status = [[None] * cols for _ in range(t_count)]
    carry = [None] * t_count
    state = {}  # drawn tiles: [step, columns left to publish, tile looked at, ex, done]
    drawn = 0
    while any(c is None for c in carry):
        movable = [t for t, st in state.items() if st[0] != "end"]
        if drawn < t_count:
            movable.append(-1)  # the next draw
        mine = [t for t in movable if t < 0 or state[t][0] != "walk" or all(
            state[t][4][c] or status[state[t][2]][c] is not None for c in range(cols))]
        assert mine, "the look-back stalled"
        t = mine[rng.integers(len(mine))]
        if t < 0:
            state[drawn] = ["publish_A" if drawn else "publish_P", list(range(cols)), drawn - 1,
                            [ident] * cols, [False] * cols]
            drawn += 1
            continue
        st = state[t]
        if st[0] in ("publish_A", "publish_P"):  # some of the columns, in a random order
            rng.shuffle(st[1])
            k = int(rng.integers(1, len(st[1]) + 1))
            for c in st[1][:k]:
                value = aggs[t, c].item() if st[0] == "publish_A" else op(st[3][c],
                                                                           aggs[t, c].item())
                status[t][c] = (st[0][-1], value)
            st[1] = st[1][k:]
            if not st[1]:
                if st[0] == "publish_A":
                    st[0] = "walk"
                else:
                    st[0] = "end"
                    carry[t] = st[3]
        else:  # walk: every column still open is ready at tile st[2]
            for c in range(cols):
                if not st[4][c]:
                    flag, value = status[st[2]][c]
                    st[3][c] = op(st[3][c], value)
                    st[4][c] = flag == "P"
            if all(st[4]):
                st[0], st[1] = "publish_P", list(range(cols))
            else:
                st[2] -= 1
    return torch.tensor(carry, dtype=torch.int32)


def schedule(x, is_min, reverse, rows, rng):
    """plane_scan by the kernel's schedule, strip by strip."""
    op = torch.minimum if is_min else torch.maximum
    ident = torch.iinfo(torch.int32).max if is_min else torch.iinfo(torch.int32).min
    m, v = x.shape
    tr, c = GROUPS * rows, plane_scan.COLS
    nt, strips = -(-m // tr), -(-v // c)
    pad = torch.full((nt * tr, strips * c), ident, dtype=torch.int32)
    pad[:m, :v] = x
    out = torch.empty_like(pad)
    for s in range(strips):
        tiles = [_tile(pad[t * tr:(t + 1) * tr, s * c:(s + 1) * c], is_min, reverse, rows)
                 for t in range(nt)]
        order = list(range(nt - 1, -1, -1)) if reverse else list(range(nt))  # scan order
        carry = _look_back(torch.stack([tiles[t][1] for t in order]), is_min, rng)
        for k, t in enumerate(order):
            out[t * tr:(t + 1) * tr, s * c:(s + 1) * c] = op(tiles[t][0], carry[k])
    return out[:m, :v]


def test_schedule_tile_is_the_kernels():
    assert GROUPS * 8 == plane_scan.TILE_ROWS and plane_scan.COLS == 64


@pytest.mark.parametrize("rows", [1, 8])
@pytest.mark.parametrize("m,v", [(1, 64), (37, 3), (129, 64), (300, 64), (257, 130)])
def test_schedule_matches_pallas(rows, m, v):
    """The kernel's tiles and shuffled look-back against the plain version
    and the Pallas kernel (interpret mode), bit for bit, in all four modes."""
    rng = np.random.default_rng(m * v + rows)
    x = rng.integers(-(2**31), 2**31, size=(m, v), dtype=np.int64).astype(np.int32)
    x[rng.random((m, v)) < 0.05] = np.iinfo(np.int32).max  # the identities occur too
    x[rng.random((m, v)) < 0.05] = np.iinfo(np.int32).min
    for is_min in (True, False):
        for reverse in (False, True):
            got = schedule(torch.from_numpy(x), is_min, reverse, rows, rng)
            want = plane_scan.plane_scan_reference(torch.from_numpy(x), is_min=is_min,
                                                   reverse=reverse)
            assert torch.equal(got, want), (is_min, reverse)
            pallas = jps.plane_scan(jnp.asarray(x), is_min=is_min, reverse=reverse,
                                    interpret=True)
            np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
