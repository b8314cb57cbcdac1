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
from tpu_bvh_torch.types import Bvh2, HitInfo, Rays, Transformation, identity_transform
from tpu_bvh_torch.utils import convert, cpu_reference, image, kernels, scenes

VARIANTS = list(traverse.VARIANTS)
FIELDS = ("prim_idx", "t", "u", "v")


def _traverse_launches():
    """The traversal kernels' launch counts, by kernel."""
    return {k: kernels.launches[f"traverse_{k}"] for k in traverse.KERNELS}


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
    before = _traverse_launches()
    got = traverse.traverse_bvh2(bvh, tris, rays, tr, variant=variant)
    assert _traverse_launches() == before  # a CPU tensor takes the plain engine
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
    before = _traverse_launches()
    got = traverse.traverse_packed(packed, bvh.n_internal, bvh.root, rays, tr)
    assert _traverse_launches() == before
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


# ------------------------------------------- the kernel's schedule, emulated on the CPU


def _take(pool, n, lanes, fetch, counter):
    """The kernel's `Pool::take` for one lane: the next ray of its block's
    chunk (one shared atomic) of the rays past the grid's `lanes`; the lane
    that finds the chunk spent fetches the next `fetch` of them from the
    shared counter. -1 once the rays are spent."""
    while True:
        base, k = lanes + pool["base"], pool["taken"]
        pool["taken"] += 1
        if base >= n:
            return -1
        if k < fetch:
            return base + k if base + k < n else -1
        nxt = counter[0]
        counter[0] += fetch
        pool.update(base=min(nxt, max(n - lanes, 0)), taken=0)


class _Warp:
    """One persistent block of `csrc/traverse.cu`'s schedule, one warp of
    `lanes` lanes with a pool of its own. Its lanes walk with the plain
    engine's step functions (`traverse._node_step`, `_leaf_step`,
    `_packed_step`, `_trail_step`), one outer-loop pass each at a time; a
    lane whose ray has ended takes its next one at once (the speculative
    shape: every lane, when the warp's outer vote ends), in lane order, and
    every piece of per-ray state is reset then, except the stack's slots,
    which the kernel does not clear either."""

    def __init__(self, kernel, bvh, tris, packed, rays, tr, lanes, fetch, counter, out,
                 restarts, block, blocks):
        self.kernel, self.bvh, self.tris, self.packed = kernel, bvh, tris, packed
        self.restarts = restarts
        self.rays, self.tr, self.fetch, self.counter, self.out = rays, tr, fetch, counter, out
        self.n = rays.origin.shape[0]
        self.ni = bvh.n_internal
        self.nodes = (bvh.node_min, bvh.node_max, bvh.left, bvh.right)
        self.lane_fetch = (traverse._packed_fetch(packed) if kernel == "packed"
                           else traverse._bvh2_fetch(bvh, tris))
        self.ids = torch.arange(lanes)
        self.ray = torch.full((lanes,), -1, dtype=torch.int64)
        self.node = torch.full((lanes,), traverse.INVALID, dtype=torch.int32)
        self.stack = torch.full((lanes, traverse.STACK_DEPTH), 12345, dtype=torch.int32)
        self.stack[:, 0] = traverse.INVALID
        self.top = torch.ones(lanes, dtype=torch.int32)
        self.hit = traverse._fresh_hit(lanes, "cpu")
        self.counts = torch.zeros(lanes, dtype=torch.int32)
        self.lane_rays = Rays(torch.zeros(lanes, 3), torch.ones(lanes, 3), torch.zeros(lanes),
                              torch.zeros(lanes))
        self.t_org, self.t_inv = traverse._transform_rays(self.lane_rays, tr)
        self.walk = traverse._trail_start(bvh.root, lanes, "cpu")
        self.pool = {"base": 0, "taken": fetch}  # a spent chunk: the first taker fetches
        self.first = torch.arange(block * lanes, (block + 1) * lanes)  # each lane's first ray
        self.grid_lanes = blocks * lanes
        self.started = False
        self.overflows = 0

    def _start(self, new):
        """The lanes in `new` start their rays: origin, direction, the
        object-space ray, a fresh hit and count, the root, top 1, the trail."""
        idx = self.ray[new]
        org = self.lane_rays.origin.clone()
        dirs = self.lane_rays.direction.clone()
        org[new] = self.rays.origin[idx]
        dirs[new] = self.rays.direction[idx]
        self.lane_rays = self.lane_rays._replace(origin=org, direction=dirs)
        t_org, t_inv = traverse._transform_rays(self.lane_rays, self.tr)
        self.t_org = torch.where(new[:, None], t_org, self.t_org)
        self.t_inv = torch.where(new[:, None], t_inv, self.t_inv)
        self.hit = traverse._reset_hit(self.hit, new)
        self.counts = torch.where(new, 0, self.counts)
        self.node = torch.where(new, torch.as_tensor(self.bvh.root).to(torch.int32), self.node)
        self.top = torch.where(new, 1, self.top)
        walk = traverse._trail_start(self.bvh.root, new.shape[0], "cpu")
        self.walk = tuple(
            torch.where(new, w, v) if isinstance(w, torch.Tensor)
            else (torch.where(new, w[0], v[0]), torch.where(new, w[1], v[1]))
            for w, v in zip(walk, self.walk))

    def _restart(self, over):
        """The overflowed lanes walk again through the restart trail from a
        fresh hit, in their own lanes: they take their rays' restart-trail
        results (`restarts`, every ray's, walked together once), as the
        kernel's in-lane walk leaves them."""
        if not bool(over.any()):
            return
        self.overflows += int(over.sum())
        hit, counts = self.restarts()
        ids = self.ray[over]
        self.hit = HitInfo(*(_scatter(h[ids], over, g) for h, g in zip(hit, self.hit)))
        self.counts = _scatter(counts[ids], over, self.counts)

    def _finish(self, done):
        for f, field in zip(self.out[:4], self.hit):
            f[self.ray[done]] = field[done]
        self.out[4][self.ray[done]] = self.counts[done]
        self.out[5][self.ray[done]] += 1
        self.ray = torch.where(done, -1, self.ray)

    def _node_steps(self, act, over):
        if self.kernel == "packed":
            self.node, self.top, self.hit, self.counts, over = traverse._packed_step(
                self.packed, self.ni, self.lane_rays, self.tr, self.t_org, self.t_inv, self.node,
                self.stack, self.top, self.hit, self.counts, over, self.ids, act)
            return over
        self.node, self.top, over = traverse._node_step(
            self.nodes, self.t_org, self.t_inv, self.node, self.stack, self.top, self.hit.t, act,
            over, self.ids)
        return over

    def _leaf_steps(self, act):
        if self.kernel == "packed":
            self.node, self.top, self.hit, self.counts, _ = traverse._packed_step(
                self.packed, self.ni, self.lane_rays, self.tr, self.t_org, self.t_inv, self.node,
                self.stack, self.top, self.hit, self.counts, torch.zeros_like(act), self.ids, act)
        else:
            self.node, self.top, self.hit, self.counts = traverse._leaf_step(
                self.nodes, self.tris, self.tr, self.lane_rays, self.node, self.stack, self.top,
                self.hit, self.counts, act, self.ids)

    def _take(self, want):
        """Each lane in `want` takes its next ray, in lane order, and starts
        it: its own thread's first, then from the pool."""
        if not self.started:
            got = torch.where(want & (self.first < self.n), self.first, -1)
        else:
            got = torch.tensor([_take(self.pool, self.n, self.grid_lanes, self.fetch,
                                      self.counter) if w else -1 for w in want.tolist()],
                               dtype=torch.int64)
        new = got >= 0
        self.ray = torch.where(want, got, self.ray)
        self._start(new)

    def iterate(self):
        """One pass of the outer loop; False once the warp has exited."""
        if self.kernel == "speculative" or not self.started:
            if self.kernel == "speculative" and bool((self.ray >= 0).any()):
                raise AssertionError("a speculative warp refills only when all its lanes are done")
            self._take(torch.ones_like(self.ray, dtype=torch.bool))
            self.started = True
        live = self.ray >= 0
        if not bool(live.any()):
            return False
        valid = live & (self.node != traverse.INVALID)
        internal = valid & (self.node < self.ni)
        over = torch.zeros_like(live)
        if self.kernel == "restart_trail":
            self.walk, self.hit, self.counts, exited = traverse._trail_step(
                self.lane_fetch, self.ni, traverse._roots(self.bvh.root, live.shape[0], "cpu"),
                self.lane_rays, self.tr, self.t_org, self.t_inv, self.walk, self.hit,
                self.counts, live)
            self._finish(exited)
            self._take(exited)
            return True
        if self.kernel in ("if_if", "packed"):
            over = self._node_steps(internal, over)
            self._leaf_steps(live & ~over & (self.node != traverse.INVALID)
                             & (self.node >= self.ni))
        elif self.kernel == "while_while":
            while bool(internal.any()):
                over = self._node_steps(internal, over)
                internal = live & ~over & (self.node != traverse.INVALID) & (self.node < self.ni)
            leaf = live & ~over & (self.node != traverse.INVALID) & (self.node >= self.ni)
            while bool(leaf.any()):
                self._leaf_steps(leaf)
                leaf = live & ~over & (self.node != traverse.INVALID) & (self.node >= self.ni)
        else:  # speculative: both votes over the whole warp
            while bool((self.node != traverse.INVALID).any()):
                internal = (self.node != traverse.INVALID) & (self.node < self.ni)
                while bool(internal.any()):
                    before = over
                    over = self._node_steps(internal, over)
                    self.node = torch.where(over & ~before, traverse.INVALID, self.node)
                    internal = (self.node != traverse.INVALID) & (self.node < self.ni)
                self._leaf_steps((self.node != traverse.INVALID) & (self.node >= self.ni))
        self._restart(over)
        done = live & (over | (self.node == traverse.INVALID))
        self._finish(done)
        if self.kernel != "speculative":
            self._take(done)
        return True


def _scatter(values, mask, like):
    """`values` (one a set lane of `mask`) spread over the lanes."""
    out = like.clone()
    out[mask] = values
    return out


def _emulate(kernel, bvh, tris, rays, tr, lanes, warps, fetch, max_passes=20_000):
    """The kernel's schedule: `warps` blocks of one warp of `lanes` lanes,
    taking turns one outer-loop pass at a time; each lane's first ray is its
    own thread's, the rest come through its block's pool, fed `fetch` rays
    at a time from the shared counter. Returns the hits and counts, how
    often each ray was written, the rays handed out (the grid's lanes' and
    the counter's), and the overflows."""
    n = rays.origin.shape[0]
    out = (torch.full((n,), -7, dtype=torch.int32), *(torch.full((n,), -7.0) for _ in range(3)),
           torch.full((n,), -7, dtype=torch.int32), torch.zeros(n, dtype=torch.int64))
    counter = [0]
    packed = traverse.pack_bvh2(bvh, tris) if kernel == "packed" else None
    fetcher = traverse._packed_fetch(packed) if kernel == "packed" else traverse._bvh2_fetch(bvh,
                                                                                            tris)
    trail = []

    def restarts():
        """Every ray's walk through the restart trail from a fresh hit."""
        if not trail:
            t_org, t_inv = traverse._transform_rays(rays, tr)
            trail.append(traverse._restart_trail_engine(
                fetcher, bvh.n_internal, bvh.root, rays, tr, t_org, t_inv,
                torch.zeros(n, dtype=torch.bool), traverse._fresh_hit(n, "cpu"),
                torch.zeros(n, dtype=torch.int32)))
        return trail[0]

    ws = [_Warp(kernel, bvh, tris, packed, rays, tr, lanes, fetch, counter, out, restarts, b,
                warps) for b in range(warps)]
    running = list(ws)
    for _ in range(max_passes):
        running = [w for w in running if w.iterate()]
        if not running:
            break
    assert not running, "the schedule did not end"
    return ((HitInfo(*out[:4]), out[4]), out[5], min(n, warps * lanes) + counter[0],
            sum(w.overflows for w in ws))


KERNELS = list(traverse.KERNELS)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name,lanes,warps,fetch", [("cornellbox", 4, 3, 4), ("soup", 8, 2, 11)])
def test_refill_schedule_equals_jax(name, lanes, warps, fetch, kernel):
    """The persistent schedule (warps of 4 or 8 lanes, block pools fed 4 or
    11 rays a fetch) gives every ray JAX's bits, whatever lane and block it
    lands in: prims and counts as the jitted run, t, u and v as the eager
    one; each ray is written once, and the counter hands out all rays and,
    past the chunk that holds the last ray, at most one fetch a block."""
    case = name if name == "cornellbox" else ("soup500_rotated" if kernel == "packed"
                                              else "soup300")
    _, (bvh, tris, rays, tr) = _inputs(case)
    got, writes, handed, overflows = _emulate(kernel, bvh, tris, rays, tr, lanes, warps, fetch)
    assert torch.equal(writes, torch.ones_like(writes)) and overflows == 0
    n = rays.origin.shape[0]
    assert n <= handed < n + (warps + 1) * fetch
    _assert_like_jax(case, kernel, got)


CHAIN_LEAVES, CHAIN_HOT = 50, 40  # a chain just deep enough to overflow the stack


def _chain_mix(seed=5, n=24):
    """A 50-leaf deep chain with a batch mixing rays that enter its boxes and
    overflow the stack (hitting the hot prim, one of the stacked triangles,
    or none) and rays that miss every box (no step past the root)."""
    d = scenes.deep_chain(CHAIN_LEAVES, CHAIN_HOT)
    starts = np.array([[0.0, 0.0, -1.0], [6.5, 0.0, -1.0], [3.0, 5.0, -1.0], [50.0, 50.0, -1.0],
                       [0.0, 0.0, -20.0], [-40.0, 0.0, 0.0]], np.float32)
    dirs = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0]],
                    np.float32)
    pick = np.random.default_rng(seed).integers(0, len(starts), n)
    rows = tuple(d[k] for k in ("node_min", "node_max", "left", "right"))
    return rows, d["tris"], starts[pick], dirs[pick]


_CHAIN = {}


def _chain_case():
    """The mixed chain batch on the port (CPU) and what JAX makes of it: the
    port's plain engine (every kernel gives the restart trail's result for
    an overflowed ray and a miss at the root otherwise, so one run serves
    all) and JAX's jitted prims and counts."""
    if not _CHAIN:
        rows, tris_np, origin, direction = _chain_mix()
        n = origin.shape[0]
        bvh = Bvh2.from_rows(*map(torch.from_numpy, rows), torch.tensor(0, dtype=torch.int32))
        rays = Rays(torch.from_numpy(origin), torch.from_numpy(direction), torch.zeros(n),
                    torch.full((n,), 3.4e38))
        args = (bvh, torch.from_numpy(tris_np), rays, identity_transform(device="cpu"))
        jbvh = JBvh2.from_rows(*map(jnp.asarray, rows), jnp.int32(0))
        jrays = JRays(origin=jnp.asarray(origin), direction=jnp.asarray(direction),
                      tmin=jnp.zeros(n, jnp.float32), tmax=jnp.full(n, 3.4e38, jnp.float32))
        jhit, jcounts = jtraverse.traverse_bvh2(jbvh, jnp.asarray(tris_np), jrays,
                                                _jax_identity(), variant="if_if")
        _CHAIN.update(args=args, entering=np.abs(origin[:, 0]) < 10,
                      want=traverse.traverse_bvh2_reference(*args, "if_if"),
                      jax=(np.asarray(jhit.prim_idx), np.asarray(jcounts).astype(np.int64)))
    return _CHAIN


@pytest.mark.parametrize("kernel", KERNELS)
def test_refill_schedule_resets_overflowed_lanes(kernel):
    """Overflowing and ordinary rays share warps of 4 lanes: a lane that
    takes a ray after an overflowed one must not inherit its hit, count,
    stack top or trail. The schedule equals the plain engine on the batch,
    bit for bit, and JAX's prims and counts; the stack kernels count one
    overflow a ray that enters the boxes."""
    case = _chain_case()
    got, writes, _, overflows = _emulate(kernel, *case["args"], 4, 2, 6)
    for g, w in zip([*got[0], got[1]], [*case["want"][0], case["want"][1]]):
        assert _bits(g).tobytes() == _bits(w).tobytes()
    entering = case["entering"]
    assert torch.equal(writes, torch.ones_like(writes))
    assert overflows == (0 if kernel == "restart_trail" else int(entering.sum()))
    assert set(got[0].prim_idx[torch.from_numpy(entering)].tolist()) > {CHAIN_HOT, -1}
    np.testing.assert_array_equal(got[0].prim_idx.numpy(), case["jax"][0])
    np.testing.assert_array_equal(got[1].numpy(), case["jax"][1])


@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_engine_does_not_depend_on_ray_order(kernel):
    """Each ray's walk is its own: the plain engine on the rays permuted,
    then un-permuted, equals it on the given order, bit for bit (the refill
    hands rays to lanes in any order)."""
    _, (bvh, tris, rays, tr) = _inputs("soup300")
    perm = torch.from_numpy(np.random.default_rng(3).permutation(rays.origin.shape[0]))
    want = traverse.traverse_by_name(kernel, bvh, tris, rays, tr, plain=True)
    hit, counts = traverse.traverse_by_name(kernel, bvh, tris, Rays(*(x[perm] for x in rays)), tr,
                                            plain=True)
    inv = torch.argsort(perm)
    for g, w in zip([*hit, counts], [*want[0], want[1]]):
        assert _bits(g[inv]).tobytes() == _bits(w).tobytes()
