"""Kernel 2 (dense refit stencil): the port's plain version equals the
Pallas kernel (interpret mode) bit for bit; the anchored refit equals JAX
on a normal and a degenerate (full-table) input. The LBVH tail on the card
(B1's links form, B2's tree mode, the long-node launch L): their plain
versions equal the CPU build's topology and refit bit for bit, with no
budget on the long nodes, on soups, a caterpillar past the budget and
coordinates past the stencil's +3e38 fill."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import refit as jrefit
from tpu_bvh.ops.pallas import refit_dense as jrefit_dense
from tpu_bvh.utils import scenes as jscenes
from tail_scenes import caterpillar, caterpillar_huge, huge, soup
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import radix_tree, refit, refit_dense


def _mk(rng, n, radius):
    """Boundary-ordered ranges first <= i < i+1 <= last of mixed lengths."""
    leaf_min = rng.random((n, 3), dtype=np.float32)
    leaf_max = leaf_min + 0.05 + rng.random((n, 3), dtype=np.float32)
    i = np.arange(n - 1)
    first = np.maximum(i - rng.integers(0, 3 * radius, n - 1), 0).astype(np.int32)
    last = np.minimum(i + 1 + rng.integers(0, 3 * radius, n - 1), n - 1).astype(np.int32)
    packed_t = np.concatenate([leaf_min, -leaf_max], axis=1).T.copy()
    return packed_t, first, last


def _mat(packed_t, first, last):
    n = packed_t.shape[1]
    edge = np.array([n - 1], np.int32)
    return np.concatenate([
        packed_t.view(np.int32),
        np.concatenate([first, edge])[None],
        np.concatenate([last, edge])[None],
    ]).copy()


@pytest.mark.parametrize("n", [64, 257, 1024, 5000])
@pytest.mark.parametrize("radius", [16, 24])
def test_plain_dense_matches_pallas(n, radius, monkeypatch):
    monkeypatch.setattr(jrefit_dense, "_BLK", 256)  # several blocks, halos used
    mat = _mat(*_mk(np.random.default_rng(n + radius), n, radius))
    want = [np.asarray(x) for x in jrefit_dense.refit_dense_pallas(
        jnp.asarray(mat), n, radius, interpret=True)]
    got = [x.numpy() for x in refit_dense.refit_dense(torch.from_numpy(mat), n, radius)]
    for g, w, name in zip(got, want, ["acc", "short", "t4"]):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _caterpillar(n):
    """Every node i covers [0, i+1]: nearly all nodes are long, so the
    anchored refit takes the full-table path."""
    m = n - 1
    return np.zeros(m, np.int32), (np.arange(m) + 1).astype(np.int32)


@pytest.mark.parametrize("case", ["normal", "degenerate"])
def test_refit_anchored_matches_jax(case, monkeypatch):
    # normal: the leaf order and ranges of a real build (sponza_like)
    tris = jnp.asarray(jscenes.sponza_like(3000))
    _, packed_t, _ = jlbvh._sorted_leaves_from_tris(tris, True)
    _, _, first, last = jlbvh.build_single_pass_aux(tris)
    packed_t, first, last = (np.array(x) for x in (packed_t, first, last))
    n = packed_t.shape[1]
    if case == "degenerate":
        first, last = _caterpillar(n)
    want = np.asarray(jrefit.refit_anchored_packed(
        jnp.asarray(packed_t), jnp.asarray(first), jnp.asarray(last)))
    full_table_calls = []
    full_table = refit._refit_full_table
    monkeypatch.setattr(refit, "_refit_full_table",
                        lambda *a: full_table_calls.append(1) or full_table(*a))
    got = refit.refit_anchored_packed(
        torch.from_numpy(packed_t), torch.from_numpy(first), torch.from_numpy(last))
    assert len(full_table_calls) == (case == "degenerate")
    assert got.numpy().tobytes() == want.tobytes()
    # and against a brute-force range min
    k = 1234
    np.testing.assert_array_equal(
        got.numpy()[:, k], packed_t[:, first[k]:last[k] + 1].min(axis=1))


def _bits(x):
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


TAIL_SCENES = {
    "soup_2": lambda: soup(2), "soup_40": lambda: soup(40, 1), "soup_1025": lambda: soup(1025, 2),
    "soup_5000": lambda: soup(5000, 3), "sponza_3000": lambda: jscenes.sponza_like(3000),
    "caterpillar": caterpillar, "soup_5000_huge": lambda: huge(soup(5000, 3)),
    "caterpillar_huge": caterpillar_huge,
}


def _tail_inputs(scene, extended=True):
    """(codes, leaf columns, leaf prims, first, last, the long-node count,
    the CPU refit's budget) of a scene's CPU build."""
    codes, packed_t, prim = lbvh._sorted_leaves_from_tris(
        torch.from_numpy(np.asarray(TAIL_SCENES[scene]())), extended)
    first, last = radix_tree.apetrei_build_packed_full(codes, packed_t)[5:]
    m = first.shape[0]
    i = torch.arange(m, dtype=torch.int32)
    n_long = int(((i - first >= refit.RADIUS) | (last - i > refit.RADIUS)).sum())
    return codes, packed_t, prim, first, last, n_long, refit._cap(m, refit.RADIUS)


def _cpu_refit(packed_t, first, last, monkeypatch):
    """`_refit_anchored_packed` on the CPU, and whether it took the full table."""
    calls = []
    full_table = refit._refit_full_table
    monkeypatch.setattr(refit, "_refit_full_table", lambda *a: calls.append(1) or full_table(*a))
    out = refit._refit_anchored_packed(packed_t, first, last, refit.RADIUS)
    monkeypatch.undo()
    return out, bool(calls)


@pytest.mark.parametrize("scene", ["soup_40", "soup_1025", "soup_5000", "sponza_3000",
                                   "caterpillar"])
def test_long_query_with_no_budget_equals_the_cpu_refit(scene, monkeypatch):
    """The premise of the card's long-node launch: the two-level query
    applied to every node whose short flag is clear, with no budget and no
    count, over B2's unions equals the CPU refit bit for bit, also on the
    caterpillar, whose long count passes the budget so that the CPU path
    takes `_refit_full_table`."""
    _, packed_t, _, first, last, n_long, cap = _tail_inputs(scene)
    want, full_table = _cpu_refit(packed_t, first, last, monkeypatch)
    assert full_table == (scene == "caterpillar") == (cap < first.shape[0] and n_long > cap)
    acc, short, t4 = refit_dense.refit_dense_cols(packed_t, first, last, packed_t.shape[1],
                                                  refit.RADIUS)
    m = first.shape[0]
    at = torch.nonzero(~short[:m]).squeeze(1)
    assert at.numel() == n_long
    got = acc[:, :m].clone()
    got[:, at] = refit.long_unions(t4, first[at], last[at], refit.BIG_KEY)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("scene", list(TAIL_SCENES))
def test_refit_tree_plain_equals_the_cpu_refit(scene, monkeypatch):
    """`refit.refit_tree`'s plain path (B2's tree mode, then L) gives the
    CPU refit's unions and then the leaf columns, bit for bit. Past the
    budget with x beyond +3e38 the two CPU branches differ (the fill
    would change short and long nodes), and L follows the full table."""
    _, packed_t, _, first, last, n_long, cap = _tail_inputs(scene)
    want, full_table = _cpu_refit(packed_t, first, last, monkeypatch)
    got = refit.refit_tree(packed_t, first, last)
    assert got.shape == (6, 2 * packed_t.shape[1] - 1)
    assert torch.equal(_bits(got), _bits(torch.cat([want, packed_t], dim=1)))
    if scene == "caterpillar_huge":
        assert full_table
        fast = refit._refit_anchored_fast(packed_t, first, last, refit.RADIUS)
        assert not torch.equal(_bits(fast), _bits(want))


@pytest.mark.parametrize("extended", [True, False])
@pytest.mark.parametrize("scene", ["soup_2", "soup_1025", "caterpillar"])
def test_links_plain_equals_the_topology_oracle(scene, extended):
    """B1's links form, plain: first, last, parent, left, right and the root
    of the plain oracle `apetrei_topology`, with each leaf's left its
    primitive; and `apetrei_tree` on the CPU is the build's join."""
    codes, packed_t, prim, first, last, _, _ = _tail_inputs(scene, extended)
    got = radix_tree.apetrei_links_reference(codes, prim)
    left, right, parent, o_first, o_last, root = radix_tree.apetrei_topology(codes)
    left[codes.shape[0] - 1:] = prim
    for g, w in zip(got, (o_first, o_last, parent, left, right, root)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    tree = radix_tree.apetrei_tree(codes, packed_t, prim)
    assert radix_tree.last_build["launches"] == 0
    for g, w in zip(tree[1:], (left, right, parent, root, o_first, o_last)):
        assert torch.equal(g, w)
