"""The single-pass LBVH collapsed to a BVH4 (`models/lbvh.build_single_pass_bvh4`)
on the CPU.

* The entry equals the benchmark's plain reference
  (`benchmark/reference/collapse.py`) in every Bvh4 field bit for bit, on
  seeded soups, a coincident soup and the chain-shaped caterpillar (which
  takes the coarse stage's rerun at capacity m: `test_torch_collapse.py`).
* The reference follows the JAX package: its fast collapse
  (`tpu_bvh.ops.collapse_fast.collapse_lbvh_to_bvh4`, under
  `jax.disable_jit()`) field by field, and its sequential oracle
  (`tpu_bvh.utils.cpu_reference.collapse_cpu`) renumbered by its bvh2 ids.
* Under a profiler the collapse is the top-level span `bvh.collapse` after
  `bvh.finalize`, with `bvh.collapse_prep` and `bvh.collapse_block` inside
  it, and
  `last_build["host_syncs"]` counts the collapse's reads.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import build as ref_build
from benchmark.reference import collapse as ref_collapse
from tpu_bvh import types as jtypes
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops.collapse_fast import collapse_lbvh_to_bvh4 as jcollapse_fast
from tpu_bvh.utils import cpu_reference as jcpu_reference
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.types import Bvh4
from tpu_bvh_torch.utils import scenes, timer

SOUPS = ["random_2", "random_3", "random_17", "random_300", "random_2000", "coincident",
         "caterpillar"]


def _soup(name):
    if name == "coincident":  # every triangle the same: every Morton code equal
        return np.repeat(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0.5]]], np.float32), 64, 0)
    if name == "caterpillar":
        return scenes.caterpillar()
    n = int(name.split("_")[1])
    rng = np.random.default_rng(n)
    base = rng.uniform(-10.0, 10.0, size=(n, 1, 3))
    return (base + rng.normal(0.0, 0.5, size=(n, 3, 3))).astype(np.float32)


def _bytes(x):
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _assert_same(got, want):
    for f in Bvh4._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), f
        assert _bytes(g) == _bytes(w), f


@pytest.mark.parametrize("name", SOUPS)
def test_bvh4_entry_equals_the_reference(name):
    tris = torch.from_numpy(_soup(name))
    got = lbvh.build_single_pass_bvh4(tris)
    want = ref_collapse.build_lbvh_bvh4(tris, {})
    _assert_same(got, want)
    assert int(got.n_nodes) >= 1 and int(got.child_count[int(got.root)]) >= 2


def test_reference_follows_the_jax_fast_collapse():
    """Op by op (`jax.disable_jit()`: no FMA contraction in its areas),
    JAX's fast collapse of JAX's single-pass tree (min / max and integer
    work, built jitted) equals the reference's collapse of the same tree in
    every field. The Pallas kernel's interpreter still compiles its small
    programs: 10-20 s on one core."""
    tris = _soup("random_17")
    aux = jlbvh.build_single_pass_aux(jnp.asarray(tris))
    with jax.disable_jit():
        want = jcollapse_fast(*aux, interpret=True)
    tree = tuple(torch.from_numpy(np.array(x)) for x in
                 (aux[0].packed_t, aux[0].left, aux[0].right, aux[0].root))
    got = ref_collapse.collapse(tree)
    for f in Bvh4._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape and _bytes(g) == _bytes(w), f


@pytest.mark.parametrize("name", ["random_3", "random_300", "coincident", "caterpillar"])
def test_reference_follows_the_jax_oracle(name):
    """The JAX package's sequential oracle numbers wide nodes in BFS order
    and records the bvh2 node of each (`b2_node`); renumbered by it, it
    is the reference's collapse of the same tree."""
    tree = ref_build.build_lbvh(torch.from_numpy(_soup(name)), {})
    got = ref_collapse.collapse(tree)
    jtree = jtypes.Bvh2(*(jnp.asarray(x.numpy()) for x in tree))
    o = jcpu_reference.collapse_cpu(jtree)
    m = tree[1].shape[0] // 2
    k = int(o["n_nodes"])
    b2 = o["b2_node"][:k]
    ids = lambda c: np.where((c >= 0) & (c < m), o["b2_node"][np.clip(c, 0, m - 1)], c)
    child = got.child_t.numpy()
    assert int(got.n_nodes) == k
    assert np.array_equal(child[:, b2], ids(o["child"][:k]).T)
    assert np.array_equal(got.child_count.numpy()[b2], o["child_count"][:k])
    assert np.array_equal(got.parent.numpy()[b2], ids(o["parent"][:k]))
    assert np.array_equal(got.leaf_parent.numpy(), ids(o["leaf_parent"]))
    assert np.array_equal(got.leaf_prim.numpy(), o["leaf_prim"])
    boxes = got.slot_packed_t.numpy()[:, :, b2]  # [4, 6, k]
    for j in range(k):
        for s in range(int(o["child_count"][j])):
            assert _bytes(boxes[s, 0:3, j]) == _bytes(o["child_min"][j, s])
            assert _bytes(-boxes[s, 3:6, j]) == _bytes(o["child_max"][j, s])


def _spans_of(fn, tmp_path):
    """fn() under torch.profiler: the `bvh.` cpu_op spans as (start, end,
    name, innermost enclosing `bvh.` span or None), in start order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        found = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                        for e in json.load(f)["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                        and e["name"].startswith("bvh.")), key=lambda s: (s[0], -s[1]))
    out = []
    for k, (a, b, name) in enumerate(found):
        parents = [p for p in found[:k] if p[0] <= a and b <= p[1]]
        out.append((a, b, name, parents[-1][2] if parents else None))
    return out


def test_collapse_spans_follow_the_build(tmp_path):
    tris = torch.from_numpy(_soup("random_300"))
    got = _spans_of(lambda: lbvh.build_single_pass_bvh4(tris), tmp_path)
    assert [(name, parent) for _, _, name, parent in got] == [
        ("bvh.front_half", None), ("bvh.sort", "bvh.front_half"), ("bvh.topology", None),
        ("bvh.refit", "bvh.topology"), ("bvh.finalize", None), ("bvh.collapse", None),
        ("bvh.collapse_prep", "bvh.collapse"), ("bvh.collapse_block", "bvh.collapse")]
    finalize, collapse = got[4], got[5]
    assert finalize[1] <= collapse[0]


@pytest.mark.parametrize("name,reads", [
    ("random_3", 0),  # capacity m already: no long count
    ("random_300", 1),  # the long count
    ("caterpillar", 1),
])
def test_host_syncs_count_the_collapse_reads(name, reads):
    tris = torch.from_numpy(_soup(name))
    lbvh.build_single_pass(tris)
    build = lbvh.last_build["host_syncs"]
    start = timer.host_syncs
    lbvh.build_single_pass_bvh4(tris)
    assert lbvh.last_build["host_syncs"] == build + reads == timer.host_syncs - start
