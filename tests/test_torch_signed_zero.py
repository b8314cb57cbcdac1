"""Signed zeros: every AABB min and max of the port's build path follows
`jnp.minimum` / `jnp.maximum` (-0.0 < +0.0, equal values give the OR / AND
of their bits), so on a soup whose coordinates hold both zeros the port's
CPU builds equal JAX's byte for byte, and the dense refit's plain version
equals the Pallas kernel in interpret mode byte for byte. The render and
the ray sweep, whose culling bounds keep torch's amin / amax, agree with
JAX on the soup under their own agreement rules.

`np.testing.assert_array_equal` and `torch.equal` compare values, under
which -0.0 == +0.0; these tests compare bytes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raster import assert_render_close, jax_render, port_render
from tests.test_torch_ray_sweep import _pack, _trace_both, assert_hits_close
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.models import ploc as jploc
from tpu_bvh.ops import refit as jrefit
from tpu_bvh.ops.pallas import refit_dense as jrefit_dense
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.models import lbvh, ploc
from tpu_bvh_torch.ops import aabb, refit, refit_dense

F32 = np.float32


def signed_zero_soup(n=512, seed=0):
    """n triangles with coordinates drawn from {-0.0, +0.0, 1.0}, half of
    them replaced by uniform draws (`np.where` keeps the -0.0)."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 3, (n, 3, 3))
    coords = np.where(pick == 0, F32(-0.0), np.where(pick == 1, F32(0.0), F32(1.0)))
    draws = rng.random((n, 3, 3), dtype=F32)
    return np.where(rng.random((n, 3, 3)) < 0.5, coords, draws).astype(F32)


def assert_same_bytes(got, want, fields=("packed_t", "left", "right", "root")):
    for f in fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def test_the_soup_holds_both_zeros():
    tris = signed_zero_soup()
    zeros = tris[tris == 0]
    assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()


@pytest.mark.parametrize("a,b", [(0.0, -0.0), (-0.0, 0.0), (0.0, 0.0), (-0.0, -0.0),
                                 (1.0, -0.0), (np.nan, 1.0), (1.0, np.nan), (-2.0, 3.0)])
def test_fmin_fmax_follow_jnp(a, b):
    ta, tb = torch.tensor([a], dtype=torch.float32), torch.tensor([b], dtype=torch.float32)
    ja, jb = jnp.asarray([a], F32), jnp.asarray([b], F32)
    for got, want in ((aabb.fmin(ta, tb), jnp.minimum(ja, jb)),
                      (aabb.fmax(ta, tb), jnp.maximum(ja, jb))):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("name", ["single_pass", "two_pass"])
def test_lbvh_equals_jax_in_bytes(name):
    tris = signed_zero_soup()
    got = getattr(lbvh, f"build_{name}")(torch.from_numpy(tris))
    want = getattr(jlbvh, f"build_{name}")(jnp.asarray(tris))
    assert_same_bytes(got, want)
    # the scene extents keep torch's amin / amax: their zero signs cannot
    # reach the Morton codes (ROADMAP.md C), which equal JAX's
    codes = lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), True)[0]
    jcodes = jlbvh._sorted_leaves_from_tris(jnp.asarray(tris), True)[0]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int64))


@pytest.mark.parametrize("name", ["ploc", "hploc"])
def test_ploc_equals_jax_in_bytes(name):
    """JAX op by op (`tests/test_torch_ploc.py`: a jitted loop contracts
    the area into FMAs)."""
    tris = signed_zero_soup()
    got = getattr(ploc, f"build_{name}")(torch.from_numpy(tris))
    with jax.disable_jit():
        want = getattr(jploc, f"build_{name}")(jnp.asarray(tris))
    assert_same_bytes(got, want)


def _zero_pairs(n, seed):
    """Packed columns (min xyz, -max xyz) where neighbouring columns pair
    +0.0 with -0.0 in a min row (0) and in a -max row (4), beside draws."""
    rng = np.random.default_rng(seed)
    cols = rng.random((6, n), dtype=F32)
    zeros = np.where(np.arange(n) % 2 == 0, F32(0.0), F32(-0.0))
    hit = rng.random(n) < 0.7
    cols[0] = np.where(hit, zeros, cols[0])
    cols[4] = np.where(hit, zeros[::-1], -cols[4])
    return cols


@pytest.mark.parametrize("radius", [15, 24])
def test_refit_dense_plain_equals_pallas_in_bytes(radius):
    n = 64
    cols = _zero_pairs(n, radius)
    i = np.arange(n - 1)
    rng = np.random.default_rng(radius)
    first = np.maximum(i - rng.integers(0, 2 * radius, n - 1), 0).astype(np.int32)
    last = np.minimum(i + 1 + rng.integers(0, 2 * radius, n - 1), n - 1).astype(np.int32)
    mat = refit_dense.cols_mat(*(torch.from_numpy(x) for x in (cols, first, last)))
    got = refit_dense.refit_dense_reference(mat, n, radius)
    want = jrefit_dense.refit_dense_pallas(jnp.asarray(mat.numpy()), n, radius, interpret=True)
    for g, w, name in zip(got, want, ["acc", "short", "t4"]):
        assert g.numpy().tobytes() == np.asarray(w).tobytes(), name


def test_refit_anchored_full_table_equals_jax_in_bytes(monkeypatch):
    """Every node i covers [0, i + 1] (the caterpillar's ranges): the
    anchored refit takes its full-table path."""
    n = 300
    cols = _zero_pairs(n, 7)
    first = np.zeros(n - 1, np.int32)
    last = (np.arange(n - 1) + 1).astype(np.int32)
    calls = []
    full_table = refit._refit_full_table
    monkeypatch.setattr(refit, "_refit_full_table", lambda *a: calls.append(1) or full_table(*a))
    got = refit.refit_anchored_packed(*(torch.from_numpy(x) for x in (cols, first, last)))
    want = jrefit.refit_anchored_packed(*(jnp.asarray(x) for x in (cols, first, last)))
    assert calls == [1]
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_raster_render_agrees_with_jax():
    """The render keeps torch's amin / amax for its culling bounds (their
    zero signs reach no output, ROADMAP.md C): on the soup it renders what
    JAX renders, under the agreement rules of `test_torch_raster.py`."""
    tris = signed_zero_soup()
    caps = (64, 1024, 4)
    jbvh, rays, tr, want = jax_render(tris, "cornellbox", 64, 64, 16, caps)
    assert_render_close(port_render(jbvh._asdict(), tris, rays, tr, 64, 64, 16, caps), want)


def test_ray_sweep_agrees_with_jax():
    """The same for the general-ray sweep, with ray origins on +-0.0 planes."""
    tris = signed_zero_soup()
    _, _, jpacked, packed = _pack(tris)
    rng = np.random.default_rng(3)
    n = 500
    zeros = np.where(rng.random((n, 3)) < 0.5, F32(0.0), F32(-0.0))
    o = np.where(rng.random((n, 3)) < 0.4, zeros, rng.uniform(-1.0, 2.0, (n, 3))).astype(F32)
    d = rng.normal(size=(n, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = (o, d, np.zeros(n, F32), np.full(n, 3.4e38, F32))
    got, want = _trace_both(jpacked, packed, rays, jscenes.preset("cornellbox")[0], (32, 2048, 4))
    assert assert_hits_close(got, want).any()
