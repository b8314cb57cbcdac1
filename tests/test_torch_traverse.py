"""The port's wavefront traversal (`tpu_bvh_torch.ops.traverse`) and its
helpers against JAX's (`tpu_bvh.ops.traverse`, `tpu_bvh.ops.aabb`) on the
CPU, on the same trees, triangles, rays and transforms.

Tolerances: prim ids and leaf-visit counts equal the jitted JAX output.
t, u and v equal JAX's bit for bit under `jax.disable_jit()`, where every
op runs alone: jitted, XLA on the CPU contracts the triangle test's
products and sums into FMAs, so its u and v differ from the written order
in the last bits (the port, like the CUDA kernel, keeps the written
order). The aabb helpers are held to JAX's eager ops by their bits (the
slab test's NaNs by their places only: the payload of a NaN is not
specified). The four variants of the port's plain engine agree with each
other bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tests.test_traverse import _caterpillar_bvh as _jax_caterpillar
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import aabb as jaabb
from tpu_bvh.ops import traverse as jtraverse
from tpu_bvh.types import Bvh2 as JBvh2
from tpu_bvh.types import Rays as JRays
from tpu_bvh.types import Transformation as JTransformation
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import cpu_reference as jcpu_reference
from tpu_bvh.utils import image as jimage
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.ops import aabb, traverse
from tpu_bvh_torch.types import Bvh2, Rays, Transformation, identity_transform
from tpu_bvh_torch.utils import convert, cpu_reference, image, scenes

VARIANTS = list(traverse.VARIANTS)
FIELDS = ("prim_idx", "t", "u", "v")


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rotated():
    """A transform with a rotation, a non-unit scale and a translation."""
    axis = np.array([0.3, -0.8, 0.5])
    axis /= np.linalg.norm(axis)
    quat = np.array([*(axis * np.sin(0.35)), np.cos(0.35)], np.float32)
    return JTransformation(translation=jnp.asarray([0.5, -1.25, 2.0], jnp.float32),
                           scale=jnp.asarray([1.5, 0.75, 2.0], jnp.float32),
                           quat=jnp.asarray(quat))


def _jax_identity():
    return JTransformation(translation=jnp.zeros(3, jnp.float32), scale=jnp.ones(3, jnp.float32),
                           quat=jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32))


def _soup_rays(rng, n):
    origins = rng.uniform(-8, 8, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return JRays(origin=jnp.asarray(origins), direction=jnp.asarray(dirs),
                 tmin=jnp.zeros(n, jnp.float32), tmax=jnp.full(n, 3.4e38, jnp.float32))


def _case(name):
    """(JAX Bvh2, tris, rays, transform) of each named input."""
    if name == "cornellbox":  # JAX's own test size
        tris = jnp.asarray(jscenes.cornellbox())
        tr, cam = jscenes.preset("cornellbox")
        return jlbvh.build_two_pass(tris), tris, jcamera.generate_rays(cam, 24, 24), tr
    rng = np.random.default_rng({"soup300": 300, "soup500_rotated": 500}[name])
    n_tris = 300 if name == "soup300" else 500
    tris = jnp.asarray(random_tris(rng, n_tris, spread=5.0, size=1.0))
    rays = _soup_rays(rng, 64 if name == "soup300" else 128)
    tr = _rotated() if name.endswith("rotated") else _jax_identity()
    return jlbvh.build_single_pass(tris), tris, rays, tr


_CASES = {}
_JAX = {}


def _inputs(name):
    """The JAX inputs and the port's copies of them, made once a module."""
    if name not in _CASES:
        jbvh, jtris, jrays, jtr = _case(name)
        _CASES[name] = ((jbvh, jtris, jrays, jtr),
                        (convert.to_torch(Bvh2, jbvh, device="cpu"),
                         torch.from_numpy(np.array(jtris)),
                         convert.to_torch(Rays, jrays, device="cpu"),
                         convert.to_torch(Transformation, jtr, device="cpu")))
    return _CASES[name]


def _jax_traverse(name, variant, eager):
    key = (name, variant, eager)
    if key not in _JAX:
        (jbvh, jtris, jrays, jtr), _ = _inputs(name)
        if variant == "packed":
            def run():
                packed = jtraverse.pack_bvh2(jbvh, jtris)
                return jtraverse.traverse_packed(packed, jbvh.n_internal, jbvh.root, jrays, jtr)
        else:
            def run():
                return jtraverse.traverse_bvh2(jbvh, jtris, jrays, jtr, variant=variant)
        if eager:
            with jax.disable_jit():
                _JAX[key] = run()
        else:
            _JAX[key] = run()
    return _JAX[key]


def _assert_like_jax(name, variant, got):
    hit, counts = got
    jhit, jcounts = _jax_traverse(name, variant, eager=False)
    assert counts.dtype == torch.int32 and hit.prim_idx.dtype == torch.int32
    np.testing.assert_array_equal(hit.prim_idx.numpy(), np.asarray(jhit.prim_idx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int64))
    ehit, _ = _jax_traverse(name, variant, eager=True)
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(hit, f)), _bits(getattr(ehit, f)), err_msg=f)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["cornellbox", "soup300"])
def test_traverse_bvh2_equals_jax(name, variant):
    _, (bvh, tris, rays, tr) = _inputs(name)
    before = dict(traverse.launches)
    got = traverse.traverse_bvh2(bvh, tris, rays, tr, variant=variant)
    assert traverse.launches == before  # a CPU tensor takes the plain engine
    _assert_like_jax(name, variant, got)
    assert bool((got[0].prim_idx >= 0).any()) and bool((got[0].prim_idx < 0).any())


@pytest.mark.parametrize("name", ["cornellbox", "soup500_rotated"])
def test_pack_bvh2_and_traverse_packed_equal_jax(name):
    """On the cornellbox frame and on a soup under a rotated, scaled and
    shifted transform."""
    (jbvh, jtris, _, _), (bvh, tris, rays, tr) = _inputs(name)
    packed = traverse.pack_bvh2(bvh, tris)
    want = jtraverse.pack_bvh2(jbvh, jtris)
    assert packed.dtype == torch.int32 and packed.shape == want.shape
    assert packed.numpy().tobytes() == np.asarray(want).tobytes()
    before = dict(traverse.launches)
    got = traverse.traverse_packed(packed, bvh.n_internal, bvh.root, rays, tr)
    assert traverse.launches == before
    _assert_like_jax(name, "packed", got)


@pytest.mark.parametrize("name", ["cornellbox", "soup500_rotated"])
def test_plain_variants_agree_bit_for_bit(name):
    """The three stack schedules and the packed engine give every ray the
    same steps: the same hits and counts, to the bit. The restart trail
    finds the same hits; it counts its own leaf visits (a restart from the
    root re-tests the path against the closer hit and may cull more)."""
    _, (bvh, tris, rays, tr) = _inputs(name)
    base = traverse.traverse_bvh2_reference(bvh, tris, rays, tr, "if_if")
    others = {v: traverse.traverse_bvh2_reference(bvh, tris, rays, tr, v) for v in VARIANTS[1:]}
    others["packed"] = traverse.traverse_packed_reference(traverse.pack_bvh2(bvh, tris),
                                                          bvh.n_internal, bvh.root, rays, tr)
    for name, (hit, counts) in others.items():
        for f in FIELDS:
            assert _bits(getattr(hit, f)).tobytes() == _bits(getattr(base[0], f)).tobytes(), f
        assert torch.equal(counts, base[1]) or name == "restart_trail"


def test_traverse_cpu_equals_jax():
    (jbvh, jtris, jrays, jtr), (bvh, tris, rays, tr) = _inputs("cornellbox")
    args = [np.asarray(x) for x in (jrays.origin, jrays.direction, jtr.scale, jtr.quat,
                                    jtr.translation)]
    want = jcpu_reference.traverse_cpu(jbvh, jtris, *args)
    got = cpu_reference.traverse_cpu(bvh, tris, rays.origin, rays.direction, tr.scale, tr.quat,
                                     tr.translation)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    # and the port's engine finds the oracle's hits
    hit, _ = traverse.traverse_bvh2(bvh, tris, rays, tr)
    np.testing.assert_array_equal(hit.prim_idx.numpy(), got[0])
    m = got[0] >= 0
    np.testing.assert_allclose(hit.t.numpy()[m], got[1][m], rtol=1e-4)
    np.testing.assert_allclose(hit.u.numpy()[m], got[2][m], rtol=1e-3, atol=1e-5)


def test_heatmap_equals_jax():
    counts = np.random.default_rng(7).integers(0, 40, 24 * 16).astype(np.int32)
    want = jimage.heatmap(counts.astype(np.uint32), 24, 16)
    assert image.heatmap(torch.from_numpy(counts), 24, 16).tobytes() == want.tobytes()
    zeros = np.zeros(12, np.int32)
    assert image.heatmap(zeros, 3, 4).tobytes() == jimage.heatmap(zeros, 3, 4).tobytes()


def _caterpillar():
    """The deep chain as (node_min, node_max, left, right, tris, origin,
    direction) numpy arrays."""
    d = scenes.deep_chain()
    return tuple(d[k] for k in ("node_min", "node_max", "left", "right", "tris", "origin",
                                "direction"))


def test_deep_chain_is_the_jax_tests_tree():
    """`scenes.deep_chain` is tests/test_traverse.py's caterpillar."""
    jbvh, jtris = _jax_caterpillar()
    node_min, node_max, left, right, tris = _caterpillar()[:5]
    want = (jbvh.node_min, jbvh.node_max, jbvh.left, jbvh.right, jtris)
    for g, w in zip((node_min, node_max, left, right, tris), want):
        assert g.dtype == np.asarray(w).dtype and g.tobytes() == np.asarray(w).tobytes()


def test_bvh2_from_rows_equals_jax():
    node_min, node_max, left, right = _caterpillar()[:4]
    want = JBvh2.from_rows(jnp.asarray(node_min), jnp.asarray(node_max), jnp.asarray(left),
                           jnp.asarray(right), jnp.int32(0))
    got = Bvh2.from_rows(*(torch.from_numpy(x) for x in (node_min, node_max, left, right)),
                         torch.tensor(0, dtype=torch.int32))
    assert got.packed_t.is_contiguous()
    for f in Bvh2._fields:
        assert _bits(getattr(got, f)).tobytes() == _bits(getattr(want, f)).tobytes(), f


@pytest.mark.parametrize("variant", VARIANTS + ["packed"])
def test_deep_tree_takes_the_restart_trail(variant):
    """The chain is deeper than STACK_DEPTH: the first ray's stack overflows
    and its walk is redone stackless; it must still find prim 60 at t = 2,
    and the second ray misses."""
    node_min, node_max, left, right, tris_np, origin, direction = _caterpillar()
    bvh = Bvh2.from_rows(*(torch.from_numpy(x) for x in (node_min, node_max, left, right)),
                         torch.tensor(0, dtype=torch.int32))
    tris = torch.from_numpy(tris_np)
    rays = Rays(torch.from_numpy(origin), torch.from_numpy(direction), torch.zeros(2),
                torch.full((2,), 3.4e38))
    tr = identity_transform(device="cpu")
    if variant == "packed":
        hit, counts = traverse.traverse_packed(traverse.pack_bvh2(bvh, tris), bvh.n_internal,
                                               bvh.root, rays, tr)
    else:
        hit, counts = traverse.traverse_bvh2(bvh, tris, rays, tr, variant=variant)
    assert hit.prim_idx.tolist() == [60, -1]
    assert abs(float(hit.t[0]) - 2.0) < 1e-5
    assert int(counts[1]) == 0


def test_miss_rays_do_no_leaf_work_and_counts_are_reasonable():
    """AABB culling: rays that miss the scene visit no leaf; the mean leaf
    visits of the cornellbox frame lie in (0, 4)."""
    _, (bvh, tris, rays, tr) = _inputs("cornellbox")
    hit, counts = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="if_if")
    miss = hit.prim_idx < 0
    assert bool(miss.any()) and int(counts[miss].max()) == 0
    assert int(counts.max()) <= tris.shape[0]
    assert 0 < float(counts.double().mean()) < 4


@pytest.mark.parametrize("variant", VARIANTS)
def test_cornellbox_256_equals_jax(variant):
    """The verify recipe's sanity frame, cornellbox at 256x256: every
    variant's prims and counts equal JAX's."""
    tris_np = jscenes.cornellbox()
    jtr, jcam = jscenes.preset("cornellbox")
    jrays = jcamera.generate_rays(jcam, 256, 256)
    jbvh = jlbvh.build_two_pass(jnp.asarray(tris_np))
    jhit, jcounts = jtraverse.traverse_bvh2(jbvh, jnp.asarray(tris_np), jrays, jtr, variant=variant)
    hit, counts = traverse.traverse_bvh2(
        convert.to_torch(Bvh2, jbvh, device="cpu"), torch.from_numpy(tris_np),
        convert.to_torch(Rays, jrays, device="cpu"),
        convert.to_torch(Transformation, jtr, device="cpu"), variant=variant)
    np.testing.assert_array_equal(hit.prim_idx.numpy(), np.asarray(jhit.prim_idx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts).astype(np.int64))


def test_unknown_variant_is_refused():
    _, (bvh, tris, rays, tr) = _inputs("cornellbox")
    with pytest.raises(ValueError, match="unknown traversal variant"):
        traverse.traverse_bvh2(bvh, tris, rays, tr, variant="while_if")


def _helper_inputs(n=4096, seed=11):
    """Boxes, rays and triangles with zeros of both signs in the
    directions and origins on box planes (0 * inf = NaN in the slabs)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    amin = rng.uniform(-4, 0, (n, 3)).astype(f32)
    amax = (amin + rng.uniform(0, 4, (n, 3))).astype(f32)
    origin = rng.uniform(-6, 6, (n, 3)).astype(f32)
    on_plane = rng.random((n, 3)) < 0.2
    origin = np.where(on_plane, amin, origin).astype(f32)
    direction = rng.normal(size=(n, 3)).astype(f32)
    pick = rng.random((n, 3))
    direction = np.where(pick < 0.15, f32(0.0), np.where(pick < 0.3, f32(-0.0), direction))
    max_t = np.where(rng.random(n) < 0.5, f32(3.402823466e38),
                     rng.uniform(0, 10, n)).astype(f32)
    v = rng.normal(size=(3, n, 3)).astype(f32)
    return amin, amax, origin, direction.astype(f32), max_t, v


def _same_bits_but_nan_payloads(got, want):
    """Equal bits where not NaN, NaN at the same places; returns the NaNs."""
    g, w = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(g)
    assert g[ok].view(np.int32).tobytes() == w[ok].view(np.int32).tobytes()
    return int((~ok).sum())


def test_aabb_helpers_equal_jax():
    amin, amax, origin, direction, max_t, v = _helper_inputs()
    tr = _rotated()
    q = np.asarray(tr.quat)
    t = {k: torch.from_numpy(x) for k, x in dict(amin=amin, amax=amax, o=origin, d=direction,
                                                   mt=max_t, q=q).items()}
    j = {k: jnp.asarray(x) for k, x in dict(amin=amin, amax=amax, o=origin, d=direction,
                                              mt=max_t, q=q, v=v).items()}
    with jax.disable_jit():
        want_slab = jaabb.slab_intersect(j["amin"], j["amax"], j["o"], 1.0 / j["d"], j["mt"])
        want_tri = jaabb.intersect_triangle(j["v"][0], j["v"][1], j["v"][2], j["o"], j["d"])
        want_qi = jaabb.qt_invert(j["q"])
        want_rot = jaabb.qt_inv_rotate(j["q"], j["o"])
        want_inv = jaabb.inv_transform_point(j["o"], tr.scale, tr.quat, tr.translation)
    got_slab = aabb.slab_intersect(t["amin"], t["amax"], t["o"], 1.0 / t["d"], t["mt"])
    assert sum(_same_bits_but_nan_payloads(g, w) for g, w in zip(got_slab, want_slab)) > 0
    # a NaN slab is a miss
    hits = (got_slab[0] <= got_slab[1]).numpy()
    assert not hits[np.isnan(got_slab[1].numpy())].any()
    got_tri = aabb.intersect_triangle(*(torch.from_numpy(x) for x in v), t["o"], t["d"])
    for g, w in zip(got_tri, want_tri):  # NaN where a zero direction meets 1 / 0
        _same_bits_but_nan_payloads(g, w)
    assert _bits(aabb.qt_invert(t["q"])).tobytes() == _bits(want_qi).tobytes()
    assert _bits(aabb.qt_inv_rotate(t["q"], t["o"])).tobytes() == _bits(want_rot).tobytes()
    ptr = convert.to_torch(Transformation, tr, device="cpu")
    got_inv = aabb.inv_transform_point(t["o"], ptr.scale, ptr.quat, ptr.translation)
    assert _bits(got_inv).tobytes() == _bits(want_inv).tobytes()


def test_identity_transform_equals_jax():
    from tpu_bvh.types import identity_transform as jidentity

    got = identity_transform(device="cpu")
    for g, w in zip(got, jidentity()):
        assert _bits(g).tobytes() == _bits(w).tobytes()
