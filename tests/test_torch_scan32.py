"""Kernel 1 (topology scan): the port's plain version equals the Pallas
kernel (interpret mode) and the stack oracle bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops import radix_tree as jradix
from tpu_bvh.ops.pallas import scan32 as jscan32
from tpu_bvh.ops.pallas import threshold_core as jthreshold
from tpu_bvh_torch.ops import radix_tree, scan32, threshold_core


def _codes(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        c = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    elif kind == "dups":
        c = rng.integers(0, 64, size=n, dtype=np.uint32) * 1024
    elif kind == "all_equal":
        c = np.full(n, 12345, np.uint32)
    elif kind == "sorted_line":
        c = np.arange(n, dtype=np.uint32) * 7
    else:
        raise ValueError(kind)
    return np.sort(c)


KINDS = ["random", "dups", "all_equal", "sorted_line"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [97, 4096, 4097, 9000])
def test_plain_scan_matches_pallas_and_oracle(kind, n):
    codes = _codes(kind, n)
    dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
    got_dlt = radix_tree.adjacent_deltas(torch.from_numpy(codes.astype(np.int64)))
    np.testing.assert_array_equal(got_dlt.numpy(), dlt_raw)
    got = [g.numpy() for g in scan32.scan_core(torch.from_numpy(dlt_raw))]
    pallas = [np.asarray(x) for x in jscan32.scan_core(jnp.asarray(dlt_raw), interpret=True)]
    oracle = jscan32.scan_core_reference(dlt_raw)
    for name, g, p, o in zip(["psv_pos", "psv_val", "lc", "nsv_pos", "nsv_val", "rc"],
                             got, pallas, oracle):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, o, err_msg=name)


def test_scan_dispatch_raises_on_other_devices():
    with pytest.raises(ValueError):
        scan32.scan_core(torch.zeros(4, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("kind", KINDS)
def test_threshold_reference_forms_match_jax(kind):
    """The port's plain threshold scans equal JAX's `*_reference` forms."""
    codes = _codes(kind, 4097, seed=1)
    dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
    dlt = np.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11).astype(np.int32)
    want = list(jthreshold.psv_nsv_packed_reference(jnp.asarray(dlt)))
    want += list(jthreshold.child_positions_reference(jnp.asarray(dlt)))
    got = list(threshold_core.psv_nsv_packed_reference(torch.from_numpy(dlt)))
    got += list(threshold_core.child_positions_reference(torch.from_numpy(dlt)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


_HALVES = {}


def _halves(kind, n):
    """The V=32 deltas of n sorted codes and `scan32._run`'s two halves on
    them (interpret mode): `_fwd_kernel` on the deltas, `_rev_kernel` on
    their flip."""
    if (kind, n) not in _HALVES:
        codes = _codes(kind, n, seed=2)
        dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
        dlt32 = np.where(dlt_raw <= 31, dlt_raw - 2, 30).astype(np.int32)
        m = dlt32.shape[0]
        fwd = jscan32._run(jscan32._fwd_kernel, jnp.asarray(dlt32), True)
        rev = jscan32._run(jscan32._rev_kernel, jnp.asarray(dlt32[::-1].copy()), True, m=m)
        _HALVES[kind, n] = (dlt_raw, dlt32, [np.asarray(w) for w in fwd],
                            [np.asarray(w) for w in rev])
    return _HALVES[kind, n]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [97, 4097])
def test_scan_halves_match_pallas(kind, n):
    """B16: `scan_fwd` / `scan_rev` equal `scan32._run` with `_fwd_kernel` on
    the V=32 deltas and `_rev_kernel` on their flip (interpret mode)."""
    dlt_raw, dlt32, fwd, rev = _halves(kind, n)
    m = dlt32.shape[0]
    t32 = torch.from_numpy(dlt32)
    assert torch.equal(scan32.dlt32_from_raw(torch.from_numpy(dlt_raw)), t32)
    assert torch.equal(scan32.raw_from_dlt32(t32), torch.from_numpy(dlt_raw))
    for got, want in ((scan32.scan_fwd(t32), fwd),
                      (scan32.scan_rev(torch.flip(t32, [0]), m), rev)):
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# B16 on the card: each half is one launch of csrc/psv_scan.cuh with its
# own Op (Scan32Fwd, Scan32Rev in csrc/scan32.cu), emulated here in numpy.
# The Op rebuilds the remapped delta from the V=32 form at the row's true
# position; the scan gives every row its strict psv and nsv as packed keys
# (64 j + d_j; -1 and BIG where none) and parks them in the two outputs the
# row writes at its own index; the rows then write in any order (here a
# shuffled one), each reading its parked answers first. The reverse half
# scans the flipped array itself, so its psv is the true nsv.
# ---------------------------------------------------------------------------

BIG = threshold_core.BIG
JUNK = -7  # a child slot no row has written


def _delta32(v, j):
    """The Op's delta at true position j: a tie (lane 30) is the ruler
    value 32 + clz(j ^ (j + 1)) remapped (- 11), the rest keep v."""
    clz = 32 - np.frexp((j ^ (j + 1)).astype(np.float64))[1]
    return np.where(v == 30, 21 + clz, v)


def _strict_psv_nsv(d):
    """Packed strict psv and nsv keys of d by monotone stacks."""
    m = d.shape[0]
    p = np.full(m, -1, np.int64)
    n = np.full(m, BIG, np.int64)
    for rows, out in ((range(m), p), (range(m - 1, -1, -1), n)):
        stack = []
        for i in rows:
            while stack and d[stack[-1]] >= d[i]:
                stack.pop()
            if stack:
                out[i] = 64 * stack[-1] + d[stack[-1]]
            stack.append(i)
    return p, n


def _half_by_op(dlt32, rev, rng):
    """One half as its Op writes it (`dlt32` flipped for the reverse half):
    (pos, val, child) and the writes each child slot took."""
    m = dlt32.shape[0]
    g = np.arange(m, dtype=np.int64)
    d = _delta32(dlt32.astype(np.int64), m - 1 - g if rev else g)
    assert d.min() >= 0 and d.max() <= 52  # psv_scan.cuh takes [0, 63]
    pos, val = _strict_psv_nsv(d)  # parked in the row's own outputs
    child = np.full(m, JUNK, np.int64)
    writes = np.zeros(m, np.int64)

    def put(at, who):
        child[at] = who
        writes[at] += 1

    for i in rng.permutation(m):
        p, n = pos[i], val[i]
        if rev:  # Scan32Rev: the flipped psv is the true nsv, the flipped nsv the true psv
            dn = p & 63 if p >= 0 else -1
            dp = n & 63 if n != BIG else -1
            pos[i], val[i] = (m - 1 - (p >> 6) if p >= 0 else m), dn
            if dp > dn:  # B1's strict rule, mirrored: the right child of the true psv
                put(n >> 6, m - 1 - i)
            if i == 0 or d[i - 1] < d[i]:  # leaf m - i is the right child of true m - 1 - i
                put(i, -1)
        else:  # Scan32Fwd
            dp = p & 63 if p >= 0 else -1
            dn = n & 63 if n != BIG else -1
            pos[i], val[i] = (p >> 6 if p >= 0 else -1), dp
            if n != BIG and dp <= dn:
                put(n >> 6, i)
            if not (i > 0 and d[i - 1] > d[i]):  # leaf i is the left child of i
                put(i, -1)
    return tuple(x.astype(np.int32) for x in (pos, val, child)), writes


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [97, 4097])
def test_scan_half_ops_match_pallas(kind, n):
    """B16's two Ops, rows written in shuffled orders: every child slot is
    written exactly once, no row's write reaches another row's parked
    answers, and both halves equal `_fwd_kernel` / `_rev_kernel`
    (interpret mode) and the plain versions, exactly."""
    _, dlt32, fwd, rev = _halves(kind, n)
    m = dlt32.shape[0]
    t32 = torch.from_numpy(dlt32)
    flipped = dlt32[::-1].copy()
    plain = (scan32.scan_fwd_reference(t32),
             scan32.scan_rev_reference(torch.from_numpy(flipped), m))
    rng = np.random.default_rng(n)
    for _ in range(2):
        for half, rev_, want, pw in ((dlt32, False, fwd, plain[0]),
                                     (flipped, True, rev, plain[1])):
            got, writes = _half_by_op(half, rev_, rng)
            assert bool((writes == 1).all()), (kind, rev_)
            for g, w, p in zip(got, want, pw):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, p.numpy())
