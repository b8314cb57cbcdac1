"""Kernel 2 (dense refit stencil): the port's plain version equals the
Pallas kernel (interpret mode) bit for bit; the anchored refit equals JAX
on a normal and a degenerate (full-table) input."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import refit as jrefit
from tpu_bvh.ops.pallas import refit_dense as jrefit_dense
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.ops import refit, refit_dense


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
