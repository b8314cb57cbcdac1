"""The port's sharded single-scene build (`tpu_bvh_torch.parallel.
sharded_build`) on gloo ranks on the CPU, against JAX.

JAX's contract (tests/test_sharded_build.py) is that the sharded tree
equals the single-device `lbvh.build_single_pass` tree bit for bit; the
port's `to_bvh2(build_single_pass_sharded(...))` is held to JAX's
single-device build on `packed_t` (as i32 bits), `left`, `right` and
`root`, at 1, 2, 4 and 8 ranks, on JAX's three scenes and on the +-0 soup.
The ranks are spawned once per world size (each runs every case); the JAX
references are built once in this process.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from tests.test_torch_signed_zero import signed_zero_soup
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.parallel import comm, sharded_build
from tpu_bvh_torch.types import Bvh2
from tpu_bvh_torch.utils import validate

WORLDS = (1, 2, 4, 8)
FIELDS = ("packed_t", "left", "right", "root")
DEADLINE = 240.0  # seconds for one launch of ranks; they are killed past it


def _random():
    rng = np.random.default_rng(42)
    n = 4096
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


def _duplicates():
    rng = np.random.default_rng(7)
    n = 2048
    cells = rng.integers(0, 4, size=(n, 1, 3)).astype(np.float32)
    return cells + rng.normal(0, 0.01, size=(n, 3, 3)).astype(np.float32)


def _cornellbox_tiled():
    base = np.asarray(jscenes.cornellbox(), np.float32)
    reps = int(np.ceil(2048 / base.shape[0]))
    offs = np.arange(reps, dtype=np.float32)[:, None, None, None] * 3.0
    return (base[None] + offs).reshape(-1, 3, 3)[:2048]


def _overflowing():
    rng = np.random.default_rng(3)
    n = 2048
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    return (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)


SCENES = {"random": _random, "duplicates": _duplicates, "cornellbox_tiled": _cornellbox_tiled,
          "signed_zero": signed_zero_soup}


@pytest.fixture(scope="module")
def soups():
    return {name: make() for name, make in SCENES.items()}


@pytest.fixture(scope="module")
def jax_trees(soups):
    return {name: jlbvh.build_single_pass(jnp.asarray(t)) for name, t in soups.items()}


_RUNS = {}


def _run(p, soups):
    """Every rank's results at world size p, from one launch per module."""
    if p not in _RUNS:
        cases = {name: (t, {}) for name, t in soups.items()}
        if p == 8:  # JAX's test_sharded_overflow_flag
            cases["overflow"] = (_overflowing(), {"route_cap": 4})
        _RUNS[p] = comm.spawn(torch_ranks.sharded_builds, p, device="cpu", backend="gloo",
                              args=(cases,), timeout=DEADLINE)
    return _RUNS[p]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda p: f"p{p}")
def ranks(request, soups):
    """(world size, every rank's results)."""
    return request.param, _run(request.param, soups)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("scene", list(SCENES))
def test_sharded_build_equals_jax(ranks, scene, jax_trees):
    p, results = ranks
    want = jax_trees[scene]
    got = results[0][scene]
    assert not got["overflow"], "routing capacity overflowed"
    for f in FIELDS:
        g, w = got["bvh"][f], np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


@pytest.mark.parametrize("scene", list(SCENES))
def test_sharded_build_equals_the_ports_single_device_build(ranks, scene, soups):
    _, results = ranks
    want = lbvh.build_single_pass(torch.from_numpy(soups[scene]))
    got = results[0][scene]["bvh"]
    for f in FIELDS:
        assert got[f].tobytes() == getattr(want, f).numpy().tobytes(), f
    tree = Bvh2(**{f: torch.from_numpy(got[f]) for f in FIELDS})
    n = soups[scene].shape[0]
    assert validate.check_bvh2_correctness(tree, n) and validate.check_root_aabb(tree)


@pytest.mark.parametrize("scene", list(SCENES))
def test_parents_are_the_links_read_backwards(ranks, scene, soups):
    """parent_internal and parent_leaf equal the parents read off the
    assembled tree's left and right."""
    _, results = ranks
    n = soups[scene].shape[0]
    m = n - 1
    got = results[0][scene]
    left, right = got["bvh"]["left"][:m], got["bvh"]["right"][:m]
    parent = np.full(2 * n - 1, -1, np.int32)
    parent[left] = np.arange(m)
    parent[right] = np.arange(m)
    np.testing.assert_array_equal(got["gathered"]["parent_internal"][:m], parent[:m])
    np.testing.assert_array_equal(got["gathered"]["parent_leaf"], parent[m:])


def test_every_rank_assembles_the_same_tree(ranks):
    p, results = ranks
    assert len(results) == p
    for r in range(1, p):
        for scene in SCENES:
            for part in ("bvh", "gathered"):
                assert torch_ranks.fields_equal(results[r][scene][part],
                                                results[0][scene][part]), (r, scene, part)


def test_overflow_flag_at_a_small_route_cap(soups):
    """JAX's test_sharded_overflow_flag: route_cap=4 at p = 8, n = 2048."""
    assert all(r["overflow"]["overflow"] for r in _run(8, soups))


class _NoCollective:
    """A mesh of `size` ranks whose collectives fail the test."""

    def __init__(self, size):
        self.size = size

    def axis_index(self):
        raise AssertionError("the shape check must come before any collective")

    def __getattr__(self, name):
        raise AssertionError(f"collective {name} called before the shape check")


@pytest.mark.parametrize("n,p,kw,what", [
    (1028, 8, {}, "divide"),  # n % p != 0
    (504, 8, {}, "too small"),  # L = 63 < 64
    ((1 << 22) + 8, 8, {}, "2^22"),  # positions past the 22-bit packing
    (1024, 8, {"route_cap": 129}, "route_cap"),  # more queries than a shard holds
])
def test_shape_errors_raise_before_any_collective(n, p, kw, what):
    tris = torch.zeros((1, 3, 3)).expand(n, 3, 3)  # no memory behind it
    with pytest.raises(ValueError, match=what.replace("^", r"\^")):
        sharded_build.build_single_pass_sharded(_NoCollective(p), tris, **kw)


@pytest.mark.slow
def test_jax_sharded_build_fields():
    """Every ShardedBvh2 field against JAX's own sharded build at p = 4,
    n = 512 (JAX's build takes minutes to compile on the CPU)."""
    from tpu_bvh.parallel import sharded_build as jsharded_build
    from tpu_bvh.parallel.sharded import default_mesh

    tris = _random()[:512]
    want = jsharded_build.build_single_pass_sharded(default_mesh(4), jnp.asarray(tris))
    got = comm.spawn(torch_ranks.sharded_builds, 4, device="cpu", backend="gloo",
                     args=({"soup": (tris, {})},), timeout=DEADLINE)[0]["soup"]
    for f in sharded_build.ShardedBvh2._fields:
        g, w = got["gathered"][f], np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)
