"""The port's LBVH builds vs JAX: single-pass packed_t, left, right, root,
parent, first and last, and the two-pass and `*_refs` Bvh2s, are
bit-identical; the port's own validity checks pass."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tests.test_torch_frontend import SCENES, scene
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import radix_tree as jradix
from tpu_bvh.utils.cost import sah_cost_bvh2 as jsah
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import radix_tree
from tpu_bvh_torch.utils import validate
from tpu_bvh_torch.utils.cost import sah_cost_bvh2


@pytest.mark.parametrize("name", SCENES)
def test_build_single_pass_bit_identical(name):
    tris = scene(name)
    jb, jparent, jfirst, jlast = jlbvh.build_single_pass_aux(jnp.asarray(tris))
    bvh, parent, first, last = lbvh.build_single_pass_aux(torch.from_numpy(tris))
    for field in ("packed_t", "left", "right", "root"):
        want = np.asarray(getattr(jb, field))
        got = getattr(bvh, field).numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), field
    for got, want in ((parent, jparent), (first, jfirst), (last, jlast)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = lbvh.build_single_pass(torch.from_numpy(tris))
    assert all(torch.equal(a, b) for a, b in zip(plain, bvh))
    assert validate.check_bvh2_correctness(bvh, tris.shape[0])
    assert validate.check_root_aabb(bvh)
    assert validate.check_parent_child_consistency(bvh)
    assert float(sah_cost_bvh2(bvh)) == pytest.approx(float(jsah(jb)), rel=1e-5)


def _same_bvh(got, want):
    for field in ("packed_t", "left", "right", "root"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), field


@pytest.mark.parametrize("name", SCENES)
def test_build_two_pass_bit_identical(name):
    """The two-pass (Karras) build and both `*_refs` variants."""
    tris = scene(name)
    bvh = lbvh.build_two_pass(torch.from_numpy(tris))
    _same_bvh(bvh, jlbvh.build_two_pass(jnp.asarray(tris)))
    assert validate.check_bvh2_correctness(bvh, tris.shape[0])
    assert validate.check_root_aabb(bvh)
    assert validate.check_parent_child_consistency(bvh)
    refs = lbvh.prim_refs_from_triangles(torch.from_numpy(tris))
    jrefs = jlbvh.prim_refs_from_triangles(jnp.asarray(tris))
    for g, w in zip(refs, jrefs):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    _same_bvh(lbvh.build_two_pass_refs(refs), jlbvh.build_two_pass_refs(jrefs))
    _same_bvh(lbvh.build_single_pass_refs(refs), jlbvh.build_single_pass_refs(jrefs))
    # the row-major Karras wrapper on the sorted leaves
    codes, packed_t, _ = lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), True)
    mn, mx = packed_t[0:3].T, -packed_t[3:6].T
    got = radix_tree.karras_build(codes, mn, mx)
    want = jradix.karras_build(jnp.asarray(codes.numpy().astype(np.uint32)),
                               jnp.asarray(mn.numpy()), jnp.asarray(mx.numpy()))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("n", [2, 3, 5, 33, 1000])
def test_small_random_builds_bit_identical(n):
    """Tiny trees: the root at either end, leaf children everywhere."""
    tris = random_tris(np.random.default_rng(n), n)
    want = jlbvh.build_single_pass_aux(jnp.asarray(tris))
    got = lbvh.build_single_pass_aux(torch.from_numpy(tris))
    for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert validate.check_bvh2_correctness(got[0], n)
    two = lbvh.build_two_pass(torch.from_numpy(tris))
    _same_bvh(two, jlbvh.build_two_pass(jnp.asarray(tris)))
    assert validate.check_bvh2_correctness(two, n)
