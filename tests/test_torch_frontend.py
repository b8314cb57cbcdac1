"""Port front half vs JAX: Morton codes and the sorted leaf order
(codes, packed leaf AABBs, leaf prims) are bit-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.utils import scenes


def scene(name):
    """The shared test scenes, as numpy soups made from fixed seeds."""
    rng = np.random.default_rng(1234)
    if name == "cornellbox":
        return jscenes.cornellbox()
    if name == "random_tris":
        return random_tris(rng, 1000)
    if name == "dup_centroids":
        return np.repeat(random_tris(rng, 1), 64, axis=0)
    if name == "sponza_like":
        return jscenes.sponza_like(16_384)
    if name == "bunny_like":
        return jscenes.bunny_like(8_192)
    raise ValueError(name)


SCENES = ["cornellbox", "random_tris", "dup_centroids", "sponza_like", "bunny_like"]


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("extended", [True, False])
def test_sorted_leaves_bit_identical(name, extended):
    tris = scene(name)
    want = [np.asarray(x) for x in jlbvh._sorted_leaves_from_tris(jnp.asarray(tris), extended)]
    got = [x.numpy() for x in lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), extended)]
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))  # codes
    assert got[1].tobytes() == want[1].tobytes()  # leaf packed_t, bit for bit
    np.testing.assert_array_equal(got[2], want[2])  # leaf prims


@pytest.mark.parametrize("name", ["sponza_like", "bunny_like"])
def test_scene_generators_match(name):
    """The port's numpy scene copies give the JAX package's triangles."""
    sizes = {"sponza_like": 16_384, "bunny_like": 8_192}
    want = getattr(jscenes, name)(sizes[name])
    assert getattr(scenes, name)(sizes[name]).tobytes() == want.tobytes()


@pytest.mark.parametrize("name", ["cornellbox", "sponza"])
def test_presets_match(name):
    jt, jc = jscenes.preset(name)
    tt, tc = scenes.preset(name, device="cpu")
    for a, b in zip(list(jt) + list(jc), list(tt) + list(tc)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cornellbox_default_path_matches_jax(tmp_path, monkeypatch):
    """Without TPU_BVH_CORNELLBOX both packages read the reference's OBJ at
    their default path (here a small OBJ written for the test) and return
    the same triangles, not the procedural box."""
    obj = tmp_path / "cornellBox.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                   "f 1 2 3 4\nf 1 -1 2\n")
    monkeypatch.delenv("TPU_BVH_CORNELLBOX", raising=False)
    monkeypatch.setattr(jscenes, "_REFERENCE_CORNELLBOX", str(obj))
    monkeypatch.setattr(scenes, "_REFERENCE_CORNELLBOX", str(obj))
    want = jscenes.cornellbox()
    got = scenes.cornellbox()
    assert want.shape == (3, 3, 3)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
