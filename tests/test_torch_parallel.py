"""The port's multi-device paths (`tpu_bvh_torch.parallel`: `comm`,
`sharded`, `dryrun`) on gloo ranks on the CPU, against JAX's
`tpu_bvh.parallel.sharded` and the unsharded calls JAX's `shard_map`
bodies run.

Each world size's ranks are spawned once for the file and run every case
(`tests/torch_ranks.py`); the JAX references are computed in this process.
Tolerances: the extents and the batched trees bit for bit; the traversal
under `tests/test_torch_traverse.py`'s rules (prim ids and counts equal the
jitted JAX run, t, u and v its `jax.disable_jit()` run bit for bit); the
raster strips under `tests/test_torch_raster.py`'s rules against the
Pallas kernel in interpret mode (hit masks equal; t within 1e-3; prims
differ only on t ties).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from tests.conftest import random_tris
from tpu_bvh.models import batched as jbatched
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import raster as jraster
from tpu_bvh.ops import raster_tpu
from tpu_bvh.ops import traverse as jtraverse
from tpu_bvh.parallel import sharded as jsharded
from tpu_bvh.types import Bvh2 as JBvh2
from tpu_bvh.types import Rays as JRays
from tpu_bvh.types import Transformation as JTransformation
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.parallel import comm, dryrun, sharded

DEADLINE = 240.0  # seconds for one launch of ranks; they are killed past it
RASTER = (128, 64, {"cand_cap": 16, "pair_cap": 128, "group": 4}, 8)  # w, h, caps, leaf


def _np(tree):
    return {f: np.asarray(v) for f, v in tree._asdict().items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    ext = random_tris(rng, 8 * 100)
    tris_b, _ = jbatched.pad_meshes([random_tris(rng, 32) for _ in range(32)])
    tris = jnp.asarray(jscenes.cornellbox())
    tr, cam = jscenes.preset("cornellbox")
    bvh = jlbvh.build_two_pass(tris)
    w, h, caps, leaf = RASTER
    return {"extents": ext, "batched": np.asarray(tris_b),
            "traverse": (_np(bvh), np.asarray(tris), _np(jcamera.generate_rays(cam, 32, 32)),
                         _np(tr)),
            "raster": (_np(jraster.pack_raster(bvh, tris, leaf_size=leaf)),
                       _np(jcamera.generate_rays(cam, w, h)), _np(tr), w, h, caps)}


_RUNS = {}


def _run(p, inputs, names):
    """Every rank's results at world size p, from one launch per file."""
    if p not in _RUNS:
        _RUNS[p] = comm.spawn(torch_ranks.sharded_paths, p, device="cpu", backend="gloo",
                              args=({k: inputs[k] for k in names},), timeout=DEADLINE)
    return _RUNS[p]


def _cat(parts):
    return {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}


def test_sharded_scene_extents_equals_jax(inputs):
    """p = 8, n = 800: bit for bit, on every rank."""
    results = _run(8, inputs, ["extents", "batched"])
    lo, hi = jsharded.sharded_scene_extents(jsharded.default_mesh(8), inputs["extents"])
    for r in results:
        assert r["extents"][0].tobytes() == np.asarray(lo).tobytes()
        assert r["extents"][1].tobytes() == np.asarray(hi).tobytes()


def test_build_batched_sharded_equals_jax(inputs):
    """32 random meshes of 32 at p = 8 (4 a rank) against JAX's unsharded
    `build_batched`, byte for byte."""
    got = _cat([r["batched"] for r in _run(8, inputs, ["extents", "batched"])])
    want = _np(jbatched.build_batched(inputs["batched"]))
    assert torch_ranks.fields_equal(got, want)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def test_traverse_sharded_equals_jax(inputs):
    """The cornellbox at 32x32 over p = 4 ranks (256 rays a rank)."""
    results = _run(4, inputs, ["traverse"])
    hit = _cat([r["traverse"][0] for r in results])
    counts = np.concatenate([r["traverse"][1] for r in results])
    bvh, tris, rays, tr = inputs["traverse"]
    args = (JBvh2(**bvh), jnp.asarray(tris), JRays(**rays), JTransformation(**tr))
    jhit, jcounts = jtraverse.traverse_bvh2(*args)
    np.testing.assert_array_equal(hit["prim_idx"], np.asarray(jhit.prim_idx))
    np.testing.assert_array_equal(counts.astype(np.int64), np.asarray(jcounts).astype(np.int64))
    with jax.disable_jit():
        ehit, _ = jtraverse.traverse_bvh2(*args)
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(_bits(hit[f]), _bits(getattr(ehit, f)), err_msg=f)
    assert (hit["prim_idx"] >= 0).any() and (hit["prim_idx"] < 0).any()


@pytest.mark.parametrize("strip", [0, 1])
def test_render_raster_sharded_equals_jax(inputs, strip):
    """128x64 over p = 2 ranks, caps (16, 128, 4), leaf 8: each rank's
    64x64 strip against JAX's `_render_tpu_impl` (the body JAX's shard_map
    runs) in interpret mode on the same strip."""
    got = _run(2, inputs, ["raster"])[strip]["raster"]
    scene, rays, tr, w, h, caps = inputs["raster"]
    wl = w // 2
    chunk = slice(strip * wl * h, (strip + 1) * wl * h)
    want, _counts, ovf = raster_tpu._render_tpu_impl(
        jnp.asarray(scene["tris_sorted"]), jnp.asarray(scene["prim_ids"]),
        JRays(*(jnp.asarray(rays[f][chunk]) for f in JRays._fields)),
        JTransformation(**tr), wl, h, caps["cand_cap"], caps["pair_cap"],
        caps["group"], int(scene["leaf_size"]), True)
    assert not bool(ovf)
    gp, wp = got["prim_idx"], np.asarray(want.prim_idx)
    np.testing.assert_array_equal(gp >= 0, wp >= 0)
    both = gp >= 0
    assert both.any()
    gt, wt = got["t"], np.asarray(want.t)
    np.testing.assert_allclose(gt[both], wt[both], rtol=1e-3, atol=1e-3)
    diff = both & (gp != wp)
    np.testing.assert_allclose(gt[diff], wt[diff], rtol=1e-3)
    same = both & (gp == wp)
    for f in ("u", "v"):
        np.testing.assert_allclose(got[f][same], np.asarray(getattr(want, f))[same], rtol=1e-3,
                                   atol=1e-3)


def test_dryrun_multichip_on_the_cpu():
    """The five steps of `__graft_entry__.dryrun_multichip` at 4 ranks,
    step 5 bit for bit against the single-device build on every rank."""
    summaries = dryrun.dryrun_multichip(4, device="cpu", timeout=DEADLINE)
    assert len(summaries) == 4
    assert len({s["sharded build root"] for s in summaries}) == 1
    assert len({str(s["extents"]) for s in summaries}) == 1
    assert sum(s["raster hits"] for s in summaries) > 0


@pytest.fixture(scope="module")
def collectives():
    return comm.spawn(torch_ranks.collectives, 4, device="cpu", backend="gloo",
                      timeout=DEADLINE)


def test_all_gather_stacks_on_a_new_axis(collectives):
    want = np.array([[r + 1.0, -r - 0.5] for r in range(4)], np.float32)
    for res in collectives:
        np.testing.assert_array_equal(res["all_gather"], want)
        np.testing.assert_array_equal(res["all_gather_bool"], [[True], [False], [True], [False]])


def test_pmin_pmax(collectives):
    for res in collectives:
        np.testing.assert_array_equal(res["pmin"], [1.0, -3.5])
        np.testing.assert_array_equal(res["pmax"], [4.0, -0.5])
        assert int(res["pmax_int"]) == 9


def test_ppermute_sends_zeros_where_no_pair_arrives(collectives):
    """lax.ppermute's rule: a partial permutation leaves its first rank
    with zeros; a ring wraps."""
    for res in collectives:
        r = res["rank"]
        prev = [0.0, 0.0] if r == 0 else [float(r), -r + 0.5]
        np.testing.assert_array_equal(res["shift"], prev)
        np.testing.assert_array_equal(res["int_shift"], [0, 0, 0] if r == 0 else
                                      [10 * (r - 1), 10 * (r - 1) + 1, 10 * (r - 1) + 2])
        q = (r - 1) % 4
        np.testing.assert_array_equal(res["ring"], [q + 1.0, -q - 0.5])


def test_default_mesh_refuses_another_size(collectives):
    assert all("4 ranks" in res["mismatch"] for res in collectives)


def test_a_failing_rank_fails_the_launch():
    """Rank 1 raises while rank 0 waits on a collective: the launch raises
    with rank 1's traceback and leaves no rank running."""
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        comm.spawn(torch_ranks.fails_on_rank_1, 2, device="cpu", backend="gloo", timeout=60.0)


def test_ranks_past_the_deadline_are_killed():
    with pytest.raises(TimeoutError, match="killed"):
        comm.spawn(torch_ranks.sleeper, 2, device="cpu", backend="gloo", args=(120.0,),
                   timeout=8.0)


def test_ranks_default_to_the_card(monkeypatch):
    """Without a card, a launch that names no device raises before it
    starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        comm.spawn(torch_ranks.sleeper, 1, args=(0.0,))


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match='backend="gloo"'):
        comm.spawn(torch_ranks.sleeper, 4, device="cuda", backend="nccl", args=(0.0,))


class _Mesh:
    size, rank = 2, 0


def test_render_raster_sharded_refuses_a_width_past_whole_strips():
    with pytest.raises(ValueError, match="64 px"):
        sharded.render_raster_sharded(_Mesh(), None, None, None, 96, 64)
