"""The plain versions of the PLOC kernels against JAX, bit for bit.

B10 (`ploc_nn_round_raw`), B9 (`ploc_emit_compact`), B8/B6 (one round,
`ploc_round_fused` / `ploc_round_pp`) and B7 (`ploc_finish`) run their
Pallas kernels in interpret mode on the CPU; the port's CPU tensors take
the plain versions, which the CUDA kernels equal bit for bit on the card
(tests/test_torch_cuda.py). Every output is compared in full: raw rows at
every lane, the whole new state, every column of the node buffer. The
one-launch schedules of B10 and B9 are emulated in numpy at the kernels'
indexing and held against the same references.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops import ploc as jploc
from tpu_bvh.ops.pallas import ploc_nn as jploc_nn
from tpu_bvh.ops.pallas import ploc_round as jploc_round
from tpu_bvh_torch.ops import ploc_nn, ploc_round

R = 8


def make_state(rng, size, codes=None, n_segs=1, signed_zeros=False):
    """i32[8, size] cluster state: boxes (min xyz, -max xyz) as f32 bits,
    sorted codes (segment ids when `codes` is None), random node ids.
    `signed_zeros` puts -0.0 and +0.0 on box faces and makes areas tie."""
    if signed_zeros:
        mn = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5], np.float32), (3, size))
        mx = mn + rng.choice(np.array([0.0, 0.5], np.float32), (3, size))
        cols = np.concatenate([mn, -mx]).astype(np.float32)
    else:
        m = rng.random((6, size), dtype=np.float32)
        cols = np.concatenate([m[:3], -(m[:3] + 0.1 + m[3:])])
    if codes is None:
        codes = np.sort(rng.integers(0, n_segs, size))
    node = rng.integers(0, 2 * size, size)
    rows = [cols.view(np.int32), np.asarray(codes)[None], node[None]]
    return np.concatenate(rows).astype(np.int32)


def morton_like(rng, size):
    return np.sort(rng.integers(0, 1 << 30, size))


def assert_same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ B10

@pytest.mark.parametrize("size,nc,nsegs", [(256, 256, 1), (384, 300, 7), (128, 5, 2)])
@pytest.mark.parametrize("radius", [8, 4])
def test_nn_matches_pallas(size, nc, nsegs, radius):
    """The cases of test_ploc_nn.py: segments via shift 0, nc < S."""
    mat = make_state(np.random.default_rng(size + radius), size, n_segs=nsegs)
    want = jploc_nn.ploc_nn_round_raw(jnp.asarray(mat), nc, 0, radius, interpret=True)
    assert_same(ploc_nn.ploc_nn_round_raw(torch.from_numpy(mat), nc, 0, radius), want)


@pytest.mark.parametrize("size,nc,nsegs", [(1024, 1024, 1), (1024, 900, 11)])
def test_nn_matches_pallas_multiblock(monkeypatch, size, nc, nsegs):
    monkeypatch.setattr(jploc_nn, "_BLK", 256)  # four grid steps with halos
    mat = make_state(np.random.default_rng(99), size, n_segs=nsegs)
    want = jploc_nn.ploc_nn_round_raw(jnp.asarray(mat), nc, 0, R, interpret=True)
    assert_same(ploc_nn.ploc_nn_round_raw(torch.from_numpy(mat), nc, 0, R), want)


@pytest.mark.parametrize("shift", [32, 24])
def test_nn_signed_zeros_and_ties(shift):
    """-0.0 and +0.0 on box faces and many equal areas: the union takes
    jnp.minimum's -0.0, and equal areas go to the smaller index."""
    rng = np.random.default_rng(shift)
    mat = make_state(rng, 640, codes=morton_like(rng, 640), signed_zeros=True)
    want = jploc_nn.ploc_nn_round_raw(jnp.asarray(mat), 600, shift, R, interpret=True)
    got = ploc_nn.ploc_nn_round_raw(torch.from_numpy(mat), 600, shift, R)
    assert_same(got, want)
    flags = got[7].numpy()
    assert (flags == 1).sum() == (flags == 2).sum() > 0
    assert (got[0:6].numpy() == -2**31).any()  # some union face is -0.0


@pytest.mark.parametrize("radius", [0, R + 1])
def test_nn_refuses_radius_outside_the_halo(radius):
    """The CUDA kernel's halo is sized for PLOC_RADIUS; both versions
    refuse a radius it cannot hold."""
    mat = torch.from_numpy(make_state(np.random.default_rng(1), 64))
    with pytest.raises(ValueError, match="radius"):
        ploc_nn.ploc_nn_round_raw(mat, 64, 32, radius)


def test_nn_unpacked():
    mat = make_state(np.random.default_rng(5), 256, n_segs=3)
    want = jploc_nn.ploc_nn_round(jnp.asarray(mat), 250, R, interpret=True, shift_bits=0)
    got = ploc_nn.ploc_nn_round(torch.from_numpy(mat), 250, R, shift_bits=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# B10's one launch (csrc/ploc_nn.cu), emulated in numpy at the kernel's
# indexing: blocks of `threads` x `lanes` table columns over the lanes
# [lo - 2R, lo + tile + R), tile = columns - 3R output lanes; the tile of
# boxes zero outside [0, S), its codes zero at shift 32; each thread's
# forward pair areas (the union's min NaN-propagating, its zero signs as
# numpy's, not jnp.minimum's) kept for its own search and written to the
# area table, whose earlier columns its backward search reads through the
# two float4 words before its own; best_rel packed with the forward offset
# and has_nn; the mutual check and the rows lane by lane.

KR = ploc_nn.MAX_RADIUS


def _nn_by_schedule(mat, nc, shift, radius, threads=ploc_nn.THREADS, lanes=ploc_nn.LANES):
    S = mat.shape[1]
    cols_n = threads * lanes
    tile = cols_n - 3 * KR
    box_w = cols_n + KR
    out = np.full((8, S), -7, np.int32)
    writes = np.zeros(S, np.int64)
    best_rel = np.zeros(S, np.int64)
    for b in range(-(-S // tile)):
        lo = b * tile
        t0 = lo - 2 * KR
        lane = t0 + np.arange(box_w)
        inside = (lane >= 0) & (lane < S)
        src = np.clip(lane, 0, S - 1)
        box = np.where(inside, mat[0:6, src], 0).astype(np.int32).view(np.float32)
        code = np.where(inside & (shift < 32), mat[6, src], 0)
        node = np.where(inside, mat[7, src], 0)
        seg = code >> shift if shift < 32 else np.zeros_like(code)
        area = np.empty((KR, cols_n), np.float32)
        own = {}
        with np.errstate(invalid="ignore", over="ignore"):
            for t in range(threads):
                c0 = lanes * t
                a = np.full((lanes, KR), 3.0e38, np.float32)
                for j in range(lanes):
                    c, l = c0 + j, t0 + c0 + j
                    for d in range(1, min(radius, KR) + 1):
                        if 0 <= l < nc and l + d < nc and seg[c + d] == seg[c]:
                            u = np.minimum(box[:, c], box[:, c + d])
                            ex, ey, ez = -u[3] - u[0], -u[4] - u[1], -u[5] - u[2]
                            a[j, d - 1] = np.float32(2) * ((ex * ey + ex * ez) + ey * ez)
                own[t] = a
                area[:, c0:c0 + lanes] = a.T
        info = np.zeros(cols_n, np.int64)
        for t in range(KR // lanes, threads):  # the first kMaxR columns' are not needed
            c0, a = lanes * t, own[t]
            best = np.full(lanes, 3.0e38, np.float32)
            rel = np.zeros(lanes, np.int64)
            for d in range(1, radius + 1):
                for j in range(lanes):
                    if a[j, d - 1] < best[j]:
                        best[j], rel[j] = a[j, d - 1], d
            fwd = rel.copy()
            for d in range(1, radius + 1):
                back = area[d - 1, c0 - 2 * lanes:c0]  # the words at c0 - 8 and c0 - 4
                for j in range(lanes):
                    q = j - d
                    v = a[q, d - 1] if q >= 0 else back[q + 2 * lanes]
                    if v < best[j] or (v == best[j] and -d < rel[j]):
                        best[j], rel[j] = v, -d
            info[c0:c0 + lanes] = (rel & 0xFF) | (fwd << 8) | ((best < 3.0e38) << 16)
        for i in range(tile):
            l = lo + i
            if l >= S:
                break
            c = i + 2 * KR
            br = (info[c] & 0xFF) - 256 * ((info[c] & 0xFF) > 127)
            f = (info[c] >> 8) & 0xFF
            partner = (info[c + br] & 0xFF) - 256 * ((info[c + br] & 0xFF) > 127)
            live = (info[c] >> 16) != 0 and l < nc
            flag = (br > 0) + 2 * (br < 0) if (br != 0 and partner == -br and live) else 0
            p = box[:, c + f] if f > 0 else np.zeros(6, np.float32)
            out[0:6, l] = ploc_nn.fmin(torch.from_numpy(box[:, c].copy()),
                                       torch.from_numpy(p.copy())).view(torch.int32).numpy()
            out[6, l] = node[c + f] if f > 0 else 0
            out[7, l] = flag
            writes[l] += 1
            best_rel[l] = br
    return out, writes, best_rel


_NN_JAX = {}


@pytest.mark.parametrize("threads", [ploc_nn.THREADS, 16])
@pytest.mark.parametrize("size,nc,shift,radius,segs", [
    (2 * ploc_nn.TILE + 77, 2 * ploc_nn.TILE + 77, 32, 8, None),
    (2 * ploc_nn.TILE + 77, ploc_nn.TILE + 3, 9, 3, "morton"),
    (ploc_nn.TILE + 1, ploc_nn.TILE - 2, 0, 1, 40),
    (3 * 40 + 5, 3 * 40, 0, 8, 9),
    (300, 211, 9, 3, "morton"),
])
def test_nn_schedule_matches_pallas(threads, size, nc, shift, radius, segs):
    """B10's one launch by its schedule, at the kernel's 256 threads
    (1000-lane tiles) and at 16 (40-lane tiles, many tile edges): widths
    that are no multiple of a tile, nc < S, radius 1, 3 and 8, shifts 0,
    9 and 32 with segments; every lane written once and every row equal to
    JAX's `ploc_nn_round_raw` (interpret) and the plain version bit for
    bit, with mutual pairs and segment starts across tile edges."""
    rng = np.random.default_rng(size + nc + radius)
    if segs == "morton":
        mat = make_state(rng, size, codes=morton_like(rng, size))
    else:
        mat = make_state(rng, size, n_segs=segs or 1)
    tile = threads * ploc_nn.LANES - 3 * KR
    edges = np.arange(tile, nc, tile)
    # the two lanes at each tile edge below nc hold one point: their union
    # has area 0, so they pair across the edge where one segment holds both
    mat[0:6, edges - 1] = mat[0:6, edges] = np.float32(0.25).view(np.int32)
    mat[3:6, edges - 1] = mat[3:6, edges] = np.float32(-0.25).view(np.int32)
    key = (size, nc, shift, radius, segs, threads)
    if key not in _NN_JAX:
        _NN_JAX[key] = np.asarray(jploc_nn.ploc_nn_round_raw(jnp.asarray(mat), nc, shift, radius,
                                                             interpret=True))
    want = _NN_JAX[key]
    got, writes, best_rel = _nn_by_schedule(mat, nc, shift, radius, threads=threads)
    assert bool((writes == 1).all())
    np.testing.assert_array_equal(got, want)
    plain = ploc_nn.ploc_nn_round_raw_reference(torch.from_numpy(mat), nc, shift, radius)
    np.testing.assert_array_equal(got, plain.numpy())
    lanes = np.arange(size)
    seg_ids = mat[6] >> shift if shift < 32 else np.zeros(size, np.int64)
    if bool((seg_ids[edges - 1] == seg_ids[edges]).any()):  # a segment across a tile edge
        merge = want[7] == 1
        assert bool((merge & (lanes // tile != (lanes + best_rel) // tile)).any())


def test_nn_schedule_with_nan_and_signed_zeros():
    """The schedule's areas with a NaN-propagating min that keeps numpy's
    zero signs, on boxes with NaN and +-0 faces and many equal areas: flags,
    best offsets and rows equal JAX's and the plain version's."""
    rng = np.random.default_rng(3)
    size, nc = 2 * ploc_nn.TILE + 13, 2 * ploc_nn.TILE
    mat = make_state(rng, size, codes=morton_like(rng, size), signed_zeros=True)
    cols = mat[0:6].view(np.float32)
    cols[rng.random(cols.shape) < 1 / 40] = np.nan
    want = np.asarray(jploc_nn.ploc_nn_round_raw(jnp.asarray(mat), nc, 24, R, interpret=True))
    got, writes, _ = _nn_by_schedule(mat, nc, 24, R)
    assert bool((writes == 1).all())
    np.testing.assert_array_equal(got, want)
    plain = ploc_nn.ploc_nn_round_raw_reference(torch.from_numpy(mat), nc, 24, R)
    np.testing.assert_array_equal(got, plain.numpy())
    assert (want[7] == 1).sum() == (want[7] == 2).sum() > 0
    assert np.isnan(got[0:6].view(np.float32)).any()


# ------------------------------------------------------------------ B9

def _nodes(rng, w):
    return rng.integers(-2**30, 2**30, (8, w)).astype(np.int32)


@pytest.mark.parametrize("size,nc,shift", [(512, 500, 32), (1024, 1000, 18)])
def test_emit_compact_matches_pallas(monkeypatch, size, nc, shift):
    """Multi-block (_BLK 256); nodes outside [base, base + n_merged) stay."""
    monkeypatch.setattr(jploc_round, "_BLK", 256)
    rng = np.random.default_rng(size + shift)
    mat = make_state(rng, size, codes=morton_like(rng, size))
    nodes = _nodes(rng, 2 * size + 512)
    base = 37
    nn = ploc_nn.ploc_nn_round_raw(torch.from_numpy(mat), nc, shift, R)
    want_mat, want_nodes = jploc_round.ploc_emit_compact(
        jnp.asarray(mat), jnp.asarray(nn.numpy()), jnp.asarray(nodes), nc, base, interpret=True)
    got_mat, got_nodes, nm = ploc_round.ploc_emit_compact(
        torch.from_numpy(mat), nn, torch.from_numpy(nodes.copy()), nc, base)
    assert_same(got_mat, want_mat)
    assert_same(got_nodes, want_nodes)
    n_merged = int((nn[7, :nc] == 1).sum())
    assert int(nm) == n_merged > 0
    untouched = np.ones(nodes.shape[1], bool)
    untouched[base:base + n_merged] = False
    np.testing.assert_array_equal(got_nodes.numpy()[:, untouched], nodes[:, untouched])


def test_emit_compact_no_merges(monkeypatch):
    """n_merged == 0 (an HPLOC stall): the state passes through, nodes untouched."""
    monkeypatch.setattr(jploc_round, "_BLK", 256)
    rng = np.random.default_rng(3)
    mat = make_state(rng, 512)
    nodes = _nodes(rng, 2 * 512 + 512)
    nn = np.zeros((8, 512), np.int32)
    want_mat, want_nodes = jploc_round.ploc_emit_compact(
        jnp.asarray(mat), jnp.asarray(nn), jnp.asarray(nodes), 500, 0, interpret=True)
    got_mat, got_nodes, nm = ploc_round.ploc_emit_compact(
        torch.from_numpy(mat), torch.from_numpy(nn), torch.from_numpy(nodes.copy()), 500, 0)
    assert int(nm) == 0
    assert_same(got_mat, want_mat)
    assert_same(got_nodes, want_nodes)
    np.testing.assert_array_equal(got_nodes.numpy(), nodes)


# csrc/ploc_round.cu's schedule, emulated: one launch over the S columns of
# the output, blocks of `block` lanes (the kernel's tile of 1024, and 256
# and 8 here too, so that there are blocks past the live lanes and the
# look-back walks windows of 32 predecessors several times). A
# block with live lanes draws a ticket in scan order and publishes its
# (merges, keeps) status words one at a time (the merge word first), walks
# back 32 predecessors at a time once all 32 show both words with the
# launch's epoch and one flag, and publishes its inclusive prefix; any
# drawn block may take its next step at any time. The words start as those
# of an earlier launch (another epoch, any flag and count), as B9's and
# B6's leave them. A block past the live lanes zeroes its columns.

EPOCH = 5
AGG, INC = 1, 2


def _look_back(counts, rng):
    """Each live block's exclusive (merges, keeps) from the look-back in a
    shuffled order; counts [nb, 2] in scan order. Returns the prefixes and
    the ticket after the launch."""
    nb = counts.shape[0]
    stale = [(EPOCH - 1, int(rng.integers(0, 4)), int(rng.integers(0, 99))) for _ in range(2 * nb)]
    status = list(stale)  # per block: its merge word, then its keep word
    state = {}  # drawn block -> [step, window top, exclusive sums]
    prefix = [None] * nb
    ticket = 0

    def ready(p):
        wm, wk = status[2 * p], status[2 * p + 1]
        return wm[0] == wk[0] == EPOCH and wm[1] == wk[1] != 0

    while any(x is None for x in prefix):
        movable = [b for b, st in state.items() if st[0] != "end" and (
            st[0] != "walk" or all(ready(p) for p in range(max(st[1] - 31, 0), st[1] + 1)))]
        if ticket < nb and (len(state) < nb):
            movable.append(-1)
        assert movable, "the look-back stalled"
        b = movable[rng.integers(len(movable))]
        if b < 0:  # the next draw; the last draw resets the ticket
            b = ticket
            ticket = 0 if b == nb - 1 else ticket + 1
            state[b] = ["A0" if b else "P0", b - 1, np.zeros(2, np.int64)]
            continue
        st = state[b]
        if st[0] in ("A0", "A1", "P0", "P1"):  # one word a step, the merge word first
            k = int(st[0][1])
            flag = AGG if st[0][0] == "A" else INC
            value = counts[b, k] + (st[2][k] if flag == INC else 0)
            status[2 * b + k] = (EPOCH, flag, int(value))
            if k == 0:
                st[0] = st[0][0] + "1"
            elif flag == AGG:
                st[0] = "walk"
            else:
                st[0] = "end"
                prefix[b] = st[2].copy()
        else:  # walk one window: sum up to the nearest inclusive word
            for p in range(st[1], max(st[1] - 31, 0) - 1, -1):
                st[2] += [status[2 * p][2], status[2 * p + 1][2]]
                if status[2 * p][1] == INC:
                    st[0] = "P0"
                    break
            else:
                st[1] -= 32
    return np.array(prefix), ticket


def _emit_by_schedule(mat, nn, nodes, nc, base, block, rng):
    """B9 by the kernel's schedule: (out, nodes, n_merged) and the writes
    each output column and each node column took."""
    S = mat.shape[1]
    nb = -(-nc // block)
    lanes = np.arange(S)
    flags = np.where(lanes < nc, nn[7], 0)
    merge, keep = (lanes < nc) & (flags == 1), (lanes < nc) & (flags != 2)
    out = np.full((8, S), -7, np.int32)
    nodes = nodes.copy()
    col_writes = np.zeros(S, np.int64)
    node_writes = np.zeros(nodes.shape[1], np.int64)
    pad = -(-S // block) * block - S
    blocks = lambda x: np.concatenate([x, np.zeros(pad, x.dtype)]).reshape(-1, block)
    counts = np.stack([blocks(merge).sum(1), blocks(keep).sum(1)], 1)[:nb]
    prefix, ticket = _look_back(counts, rng)
    assert ticket == 0
    n_merged = None
    for b in rng.permutation(-(-S // block)):
        cols = lanes[b * block:(b + 1) * block]
        if b >= nb:  # past the live lanes: zero its columns
            out[:, cols] = 0
            col_writes[cols] += 1
            continue
        ex_m, ex_k = prefix[b]
        if b == nb - 1:
            n_merged = ex_m + counts[b, 0]
        m_b, k_b = merge[cols], keep[cols]
        m_before = np.cumsum(m_b) - m_b  # the block's exclusive scans
        k_before = np.cumsum(k_b) - k_b
        for t, l in enumerate(cols):
            if l >= nc:
                out[:, l] = 0
                col_writes[l] += 1
                continue
            new = base + ex_m + m_before[t]
            if m_b[t]:
                nodes[:, new] = np.concatenate([mat[7:8, l], nn[6:7, l], nn[0:6, l]])
                node_writes[new] += 1
            if k_b[t]:
                r = ex_k + k_before[t]
                src = nn[0:6, l] if m_b[t] else mat[0:6, l]
                out[:, r] = np.concatenate([src, mat[6:7, l], [new if m_b[t] else mat[7, l]]])
                col_writes[r] += 1
            else:  # mirrored from the end: the z-th dropped lane zeroes nc - 1 - z
                z = (cols[0] - ex_k) + (t - k_before[t])
                out[:, nc - 1 - z] = 0
                col_writes[nc - 1 - z] += 1
    return out, nodes, n_merged, col_writes, node_writes


_EMIT_JAX = {}


@pytest.mark.parametrize("block", [ploc_round._EMIT_TILE, 256, 8])
@pytest.mark.parametrize("nc,merges", [(1, True), (255, True), (256, True), (257, True),
                                       (500, True), (500, False)])
def test_emit_schedule_matches_pallas(monkeypatch, block, nc, merges):
    """B9's one launch, in shuffled orders, at S = 640 > nc (blocks with no
    live lane), and with no merge (an HPLOC stall): every output column is
    written exactly once, the survivors, the mirrored zero tail, the node
    buffer (columns outside [base, base + n_merged) untouched) and n_merged
    equal `ploc_emit_compact` (interpret, _BLK 256) and the plain version,
    exactly; the ticket is back at 0."""
    S, base = 640, 29
    rng = np.random.default_rng(nc)
    mat = make_state(rng, S, codes=morton_like(rng, S))
    nodes = _nodes(rng, 2 * S + 512)
    if merges:
        nn = ploc_nn.ploc_nn_round_raw(torch.from_numpy(mat), nc, 32, R).numpy()
    else:
        nn = rng.integers(-2**30, 2**30, (8, S)).astype(np.int32)
        nn[7] = 0
    if (nc, merges) not in _EMIT_JAX:
        monkeypatch.setattr(jploc_round, "_BLK", 256)
        _EMIT_JAX[nc, merges] = [np.asarray(x) for x in jploc_round.ploc_emit_compact(
            jnp.asarray(mat), jnp.asarray(nn), jnp.asarray(nodes), nc, base, interpret=True)]
    want_mat, want_nodes = _EMIT_JAX[nc, merges]
    plain = ploc_round.ploc_emit_compact_reference(
        torch.from_numpy(mat), torch.from_numpy(nn), torch.from_numpy(nodes.copy()), nc, base)
    n_merged = int((nn[7, :nc] == 1).sum())
    assert (n_merged > 0) == (merges and nc > 1)
    for seed in range(2):
        got_mat, got_nodes, nm, col_writes, node_writes = _emit_by_schedule(
            mat, nn, nodes, nc, base, block, np.random.default_rng(seed))
        assert bool((col_writes == 1).all())
        np.testing.assert_array_equal(node_writes[base:base + n_merged], 1)
        assert int(node_writes.sum()) == n_merged == nm == int(plain[2])
        for g, w, p in ((got_mat, want_mat, plain[0]), (got_nodes, want_nodes, plain[1])):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p.numpy())
    n_keep = nc - int((nn[7, :nc] == 2).sum())
    assert not want_mat[:, n_keep:].any()


# ------------------------------------------------------------------ B8 / B6

@pytest.mark.parametrize("size,nc", [(384, 384), (512, 300), (1024, 1000)])
@pytest.mark.parametrize("shift", [32, 18])
def test_round_matches_pallas_and_xla(monkeypatch, size, nc, shift):
    """One round (B8) == ploc_round_fused (interpret, _BLK 256) in every
    column of the state and the nodes, and == the XLA `_round` on the live
    columns."""
    monkeypatch.setattr(jploc_round, "_BLK", 256)
    rng = np.random.default_rng(size + shift + 7)
    mat = make_state(rng, size, codes=morton_like(rng, size))
    nodes = _nodes(rng, 2 * size + 512)
    base = 11
    want_mat, want_nodes, want_nm = jploc_round.ploc_round_fused(
        jnp.asarray(mat), jnp.asarray(nodes), nc, shift, base, R, interpret=True)
    got_mat, got_nodes, nm = ploc_round.ploc_round_fused(
        torch.from_numpy(mat), torch.from_numpy(nodes.copy()), nc, shift, base, R)
    assert int(nm) == int(want_nm) > 0
    assert_same(got_mat, want_mat)
    assert_same(got_nodes, want_nodes)

    # the XLA round allocates from base = n0 - nc
    x_nc, _, x_mat, x_nodes = jploc._round(
        (jnp.asarray(nc, jnp.int32), jnp.asarray(shift, jnp.int32), jnp.asarray(mat),
         jnp.asarray(nodes)), nc + base, R)
    n_keep = int(x_nc)
    np.testing.assert_array_equal(got_mat.numpy()[:, :n_keep], np.asarray(x_mat)[:, :n_keep])
    np.testing.assert_array_equal(got_nodes.numpy(), np.asarray(x_nodes))


def test_round_pp_matches_pallas(monkeypatch):
    """B6: the ping-pong round writes only the survivors into the second
    buffer; against `ploc_round_pp` in interpret mode (its padded layout:
    one block of padding, the data, two blocks of slack)."""
    blk = 256
    rng = np.random.default_rng(21)
    n, nc, shift = 1000, 900, 12
    mat = make_state(rng, n, codes=morton_like(rng, n))
    nodes = _nodes(rng, 2 * n + 512)
    nblk = -(-n // blk)
    width = (nblk + 2) * blk + jploc_round._WPAD
    a = np.zeros((8, width), np.int32)
    a[:, blk:blk + n] = mat
    b = rng.integers(-2**30, 2**30, (8, width)).astype(np.int32)
    want_b, want_nodes, want_nm = jploc_round.ploc_round_pp(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(nodes), nc, shift, 5, R, blk,
        -(-nc // blk), interpret=True)
    spare = torch.from_numpy(rng.integers(-2**30, 2**30, (8, n)).astype(np.int32))
    before = spare.clone()
    got_b, got_nodes, nm = ploc_round.ploc_round_pp(
        torch.from_numpy(mat), spare, torch.from_numpy(nodes.copy()), nc, shift, 5, R)
    assert got_b is spare and int(nm) == int(want_nm)
    n_keep = nc - int(nm)
    np.testing.assert_array_equal(got_b.numpy()[:, :n_keep],
                                  np.asarray(want_b)[:, blk:blk + n_keep])
    assert torch.equal(got_b[:, n_keep:], before[:, n_keep:])
    assert_same(got_nodes, want_nodes)


# ------------------------------------------------------------------ B7

FINISH_CASES = [(512, 500, 9), (512, 512, 12), (300, 300, 32)]


@pytest.mark.parametrize("size,nc,shift", FINISH_CASES)
def test_finish_matches_pallas_at_step_3(monkeypatch, size, nc, shift):
    """At shift_step 3, the TPU finisher's own step, the plain finisher
    equals `ploc_finish` (interpret, _FIN_WIDTH 1024) in every node column."""
    monkeypatch.setattr(jploc_round, "_FIN_WIDTH", 1024)
    rng = np.random.default_rng(size + nc + shift)
    mat = make_state(rng, size, codes=morton_like(rng, size))
    nodes = _nodes(rng, 2 * size + 512)
    want = jploc_round.ploc_finish(jnp.asarray(mat), jnp.asarray(nodes), nc, shift, 0, R,
                                   interpret=True)
    got = ploc_round.ploc_finish(torch.from_numpy(mat), torch.from_numpy(nodes.copy()), nc,
                                 shift, 0, R, shift_step=3)
    assert_same(got, want)
    np.testing.assert_array_equal(got.numpy()[:, nc - 1:], nodes[:, nc - 1:])


@pytest.mark.parametrize("size,nc,shift", FINISH_CASES)
def test_finish_matches_iterated_rounds_at_step_6(size, nc, shift):
    """At shift_step 6, the HPLOC schedule the port's round loop follows, the
    finisher equals the XLA `_round` iterated with step 6. The TPU
    finisher hard-codes a step of 3 (ploc_round.py:574), so it gives
    another tree whenever the start shift is below 32 (the first two
    cases); the port takes the step it is given."""
    rng = np.random.default_rng(size + nc + shift)
    mat = make_state(rng, size, codes=morton_like(rng, size))
    nodes = _nodes(rng, 2 * size + 512)
    state = (jnp.asarray(nc, jnp.int32), jnp.asarray(shift, jnp.int32), jnp.asarray(mat),
             jnp.asarray(nodes))
    for _ in range(nc + 16):
        if int(state[0]) <= 1:
            break
        state = jploc._round(state, nc, R, 6)
    want = np.asarray(state[3])
    got = ploc_round.ploc_finish(torch.from_numpy(mat), torch.from_numpy(nodes.copy()), nc,
                                 shift, 0, R, shift_step=6)
    np.testing.assert_array_equal(got.numpy(), want)
    if shift < 32:
        step3 = ploc_round.ploc_finish(torch.from_numpy(mat), torch.from_numpy(nodes.copy()),
                                       nc, shift, 0, R, shift_step=3)
        assert not torch.equal(step3, got)
