"""Both BVH2 -> BVH4 collapses of the port against JAX on the CPU.

* Kernel 4 (`collapse_block`): the plain version equals the Pallas kernel
  in interpret mode bit for bit on the same meta/node8/leaf8/carr rows.
* `collapse_lbvh_to_bvh4` equals JAX's fast collapse bit for bit in
  every Bvh4 field, is isomorphic to the port's `collapse_cpu` (the check
  of test_collapse_fast.py), passes `check_bvh4_correctness`, and its SAH
  equals JAX's `sah_cost_bvh4` within 1e-6 relative.
* `collapse_bvh2_to_bvh4` (queue order) equals JAX's and `collapse_cpu`
  byte for byte.
* A JAX Bvh4 carried across by `convert` equals the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tests.test_collapse_fast import _caterpillar_tris
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import collapse as jcollapse
from tpu_bvh.ops.aabb import triangle_aabbs as jtriangle_aabbs
from tpu_bvh.ops.collapse_fast import collapse_lbvh_to_bvh4 as jcollapse_fast
from tpu_bvh.ops.pallas.collapse_block import collapse_block_pallas
from tpu_bvh.utils import cpu_reference as jcpu_reference
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh.utils.cost import sah_cost_bvh4 as jsah_cost_bvh4
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import collapse, collapse_block, collapse_fast
from tpu_bvh_torch.ops.aabb import triangle_aabbs
from tpu_bvh_torch.types import Bvh2, Bvh4
from tpu_bvh_torch.utils import convert, scenes, validate
from tpu_bvh_torch.utils.cost import sah_cost_bvh4
from tpu_bvh_torch.utils.cpu_reference import collapse_cpu


def scene(name):
    rng = np.random.default_rng(1234)
    if name == "cornellbox":
        return jscenes.cornellbox()
    if name == "random_513":
        return random_tris(rng, 513)
    if name == "random_3000":  # more than one TPU block
        return random_tris(rng, 3000, spread=30.0)
    if name == "dup_codes":
        return np.repeat(random_tris(rng, 64), 16, axis=0)
    if name == "caterpillar":  # takes the overflow branch (n_long > ccap)
        return scenes.caterpillar()
    raise ValueError(name)


SCENES = ["cornellbox", "random_513", "random_3000", "dup_codes", "caterpillar"]


def assert_same_bvh4(got, want):
    """Every field bit for bit, dtypes and shapes included."""
    for f in Bvh4._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def _port_aux(tris_np):
    return lbvh.build_single_pass_aux(torch.from_numpy(tris_np))


@pytest.mark.parametrize("name", SCENES)
def test_collapse_block_plain_matches_pallas(name):
    bvh, parent, first, last = _port_aux(scene(name))
    m = bvh.n_internal
    rows = collapse_fast.kernel_inputs(bvh, parent, first, last)
    got_m, got_a = collapse_block.collapse_block_reference(*rows, m)
    want_m, want_a = collapse_block_pallas(*(jnp.asarray(r.numpy()) for r in rows), m,
                                           interpret=True)
    assert got_m.numpy().tobytes() == np.asarray(want_m).tobytes()
    for g, w in zip(got_a, want_a):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("name", SCENES)
def test_fast_collapse_matches_jax(name):
    tris_np = scene(name)
    bvh, parent, first, last = _port_aux(tris_np)
    got = collapse_fast.collapse_lbvh_to_bvh4(bvh, parent, first, last)
    jaux = jlbvh.build_single_pass_aux(jnp.asarray(tris_np))
    want = jax.block_until_ready(jcollapse_fast(*jaux, interpret=True))
    assert_same_bvh4(got, want)
    assert validate.check_bvh4_isomorphic(got, collapse_cpu(bvh))
    assert validate.check_bvh4_correctness(got, tris_np.shape[0])
    # SAH from the port's own primitive boxes against JAX's
    sah = float(sah_cost_bvh4(got, *triangle_aabbs(torch.from_numpy(tris_np))))
    jsah = float(jsah_cost_bvh4(want, *jtriangle_aabbs(jnp.asarray(tris_np))))
    assert abs(sah - jsah) <= 1e-6 * abs(jsah)


@pytest.mark.parametrize("name", SCENES)
def test_prepare_rows_do_not_depend_on_the_capacity(name):
    """The plain prep gives the same four rows at every coarse capacity
    from the long count up to m: the lanes past the count touch no row, so
    the card's coarse stage skips them, and a chain-shaped crown runs at
    capacity m in the same launch."""
    bvh, parent, first, last = _port_aux(scene(name))
    is_long = (last - first + 1) > collapse_block.S_LEN
    lowest = max(int(is_long.sum()), 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of small calls run fastest on one thread
    try:
        want = collapse_fast._prepare(bvh, parent, is_long, lowest)
        for cap in range(lowest + 1, bvh.n_internal + 1):
            got = collapse_fast._prepare(bvh, parent, is_long, cap)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), cap
    finally:
        torch.set_num_threads(threads)


def test_caterpillar_takes_the_overflow_branch():
    assert scenes.caterpillar().tobytes() == _caterpillar_tris().tobytes()
    bvh, parent, first, last = _port_aux(scene("caterpillar"))
    n = bvh.n_leaves
    n_long = int(((last - first + 1) > collapse_block.S_LEN).sum())
    assert n_long > 2 * n // (collapse_block.S_LEN + 1) + 2


@pytest.mark.parametrize("n", [2, 3, 4, 9, 33, 500])
def test_queue_collapse_matches_jax_and_oracle(n):
    """On JAX's two-pass trees (the scenes of test_collapse.py) carried
    across: the port's queue-ordered collapse == JAX's == collapse_cpu."""
    tris_np = random_tris(np.random.default_rng(n), n)
    jbvh = jlbvh.build_two_pass(jnp.asarray(tris_np))
    bvh = convert.to_torch(Bvh2, jbvh, device="cpu")
    got = collapse.collapse_bvh2_to_bvh4(bvh)
    want = jax.block_until_ready(jcollapse.collapse_bvh2_to_bvh4(jbvh))
    k = int(want.n_nodes)
    assert int(got.n_nodes) == k
    for f in ("child", "parent", "child_count"):
        assert getattr(got, f)[:k].numpy().tobytes() == np.asarray(getattr(want, f))[:k].tobytes()
    for f in ("leaf_prim", "leaf_parent"):
        assert getattr(got, f).numpy().tobytes() == np.asarray(getattr(want, f)).tobytes()
    slots = np.asarray(want.child)[:k] >= 0
    for f in ("child_min", "child_max"):
        assert (getattr(got, f)[:k].numpy()[slots].tobytes()
                == np.asarray(getattr(want, f))[:k][slots].tobytes())
    oracle = jcpu_reference.collapse_cpu(jbvh)
    assert collapse_cpu(bvh).keys() == oracle.keys()
    for key, v in collapse_cpu(bvh).items():
        np.testing.assert_array_equal(v, oracle[key])
    assert int(got.n_nodes) == oracle["n_nodes"]
    for f in ("child", "parent", "child_count"):
        np.testing.assert_array_equal(getattr(got, f)[:k].numpy(), oracle[f][:k])
    assert validate.check_bvh4_correctness(got, n)


def test_queue_collapse_on_single_pass_tree():
    tris_np = scene("random_513")
    bvh = lbvh.build_single_pass(torch.from_numpy(tris_np))
    got = collapse.collapse_bvh2_to_bvh4(bvh)
    oracle = collapse_cpu(bvh)
    k = oracle["n_nodes"]
    assert int(got.n_nodes) == k
    np.testing.assert_array_equal(got.child[:k].numpy(), oracle["child"][:k])
    np.testing.assert_array_equal(got.leaf_parent.numpy(), oracle["leaf_parent"])
    assert validate.check_bvh4_correctness(got, tris_np.shape[0])


def test_jax_bvh4_carries_across():
    tris_np = scene("cornellbox")
    jaux = jlbvh.build_single_pass_aux(jnp.asarray(tris_np))
    want = jax.block_until_ready(jcollapse_fast(*jaux, interpret=True))
    carried = convert.to_torch(Bvh4, want, device="cpu")
    bvh, parent, first, last = _port_aux(tris_np)
    got = collapse_fast.collapse_lbvh_to_bvh4(bvh, parent, first, last)
    for f in Bvh4._fields:
        assert torch.equal(getattr(carried, f), getattr(got, f)), f
    back = convert.to_numpy(carried)
    for f in Bvh4._fields:
        assert back[f].tobytes() == np.asarray(getattr(want, f)).tobytes()
