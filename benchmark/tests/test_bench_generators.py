"""The scene and ray generators: deterministic per seed, the recipe's hall, the
cell's triangle count."""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import camera, scene  # noqa: E402
from benchmark import run as bench  # noqa: E402


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_bench_hall_is_the_ports_recipe():
    from tpu_bvh_torch.utils import scenes

    port = scenes.sponza_like(1128 + 24, seed=1)[:1128]
    assert np.array_equal(scene.hall().view(np.int32), port.view(np.int32))


def test_bench_scene_is_deterministic_per_seed():
    big = 2**31 + 12345
    a = scene.Scene(3000, 262_000, 3, 1.0, big, "cpu")
    b = scene.Scene(3000, 262_000, 3, 1.0, big, "cpu")
    c = scene.Scene(3000, 262_000, 3, 1.0, big + 1, "cpu")
    for fa, fb in zip(a.frames, b.frames):
        assert torch.equal(_bits(fa), _bits(fb))
    assert not torch.equal(_bits(a.frames[0]), _bits(c.frames[0]))


def test_bench_scene_motion_moves_only_clutter():
    s = scene.Scene(3000, 262_000, 3, 1.0, 9, "cpu")
    fixed = scene.hall().shape[0]
    assert torch.equal(s.frames[0][:fixed], s.frames[2][:fixed])
    d = (s.frames[1][fixed:] - s.frames[0][fixed:]).reshape(-1, 12, 3, 3)
    assert (d.abs().amax(dim=(1, 2, 3)) > 0).all()  # every clutter box moved
    assert torch.allclose(d, d[:, :1].expand_as(d), atol=1e-5)  # rigidly
    lo = s.frames[0][fixed:].reshape(-1, 36, 3).amin(1)
    hi = s.frames[0][fixed:].reshape(-1, 36, 3).amax(1)
    half = (hi - lo) / 2
    assert (d[:, 0, 0].abs() <= half * (1 + 1e-5) + 1e-6).all()


def test_bench_cell_sizes():
    """The configuration's 4,000,000 give 3,999,996 triangles (12 a box), and
    the clutter's half-sizes shrink by (262,000 / 4,000,000)^(1/3)."""
    cfg = bench.cell("lbvh_4m.rebuild")["config"]
    fixed = scene.hall().shape[0]
    assert fixed + (cfg["n_tris"] - fixed) // 12 * 12 == 3_999_996
    assert cfg["n_tris"] < 2**22
    s = scene.Scene(50_000, 262_000, 1, 0.0, 1, "cpu")
    box = s.frames[0][fixed:].reshape(-1, 36, 3)
    half = (box.amax(1) - box.amin(1)) / 2
    k = (262_000 / 50_000) ** (1 / 3)
    assert half.max() <= 0.5 * k * (1 + 1e-6) and half.min() >= 0.05 * k * (1 - 1e-6)


def test_bench_rays_are_deterministic_per_seed():
    a = camera.Frames(2, 16, 8, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 77, "cpu")
    b = camera.Frames(2, 16, 8, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 77, "cpu")
    c = camera.Frames(2, 16, 8, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 78, "cpu")
    for p in range(2):
        assert torch.equal(_bits(a.origin[p]), _bits(b.origin[p]))
        assert torch.equal(_bits(a.direction[p]), _bits(b.direction[p]))
    assert not torch.equal(_bits(a.direction[0]), _bits(c.direction[0]))
    assert a.origin[0].stride(0) == 0  # the eye's row, read in place
    assert torch.allclose(a.direction[0].norm(dim=1), torch.ones(128), atol=1e-6)
    eye = a.origin[0][0]
    assert 1.6 <= eye[1] <= 8.0 and abs(eye[0]) <= 16 and abs(eye[2]) <= 7


def test_bench_rays_jitter_changes_every_frame():
    a = camera.Frames(2, 16, 8, 60.0, (3.0, 3.0), (0.0, 0.0), 1, 5, "cpu")
    # the two poses differ in eye and yaw; their per-pixel offsets differ too
    assert not torch.equal(a.direction[0], a.direction[1])


def test_bench_every_seed_sees_the_mixs_poses():
    """The poses come from the mix's path seed: another run seed reorders
    them and jitters them anew, so a frame's work does not depend on the seed."""
    a = camera.Frames(4, 8, 4, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 77, "cpu")
    b = camera.Frames(4, 8, 4, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 78, "cpu")
    eyes = lambda f: sorted(tuple(o[0].tolist()) for o in f.origin)
    assert eyes(a) == eyes(b)
    c = camera.Frames(4, 8, 4, 60.0, (1.6, 8.0), (-0.35, 0.15), 2, 77, "cpu")
    assert eyes(a) != eyes(c)
