"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch and the CUDA toolkit
are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import (collapse_block, collapse_fast, radix_tree, raster, raster_gpu,
                               ray_sweep, refit_dense, scan32)
from tpu_bvh_torch.types import Bvh4, Rays
from tpu_bvh_torch.utils import camera, scenes, validate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    return torch.device("cuda")


def _codes(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        c = rng.integers(0, 1 << 30, size=n)
    elif kind == "dups":
        c = rng.integers(0, 64, size=n) * 1024
    elif kind == "all_equal":
        c = np.full(n, 12345)
    else:  # sorted_line
        c = np.arange(n) * 7
    return torch.from_numpy(np.sort(c).astype(np.int64))


@pytest.mark.parametrize("kind", ["random", "dups", "all_equal", "sorted_line"])
@pytest.mark.parametrize("n", [2, 97, 100_003])
def test_scan_kernel_matches_plain(cuda, kind, n):
    dlt_raw = radix_tree.adjacent_deltas(_codes(kind, n).to(cuda))
    before = scan32.launches
    got = scan32.scan_core(dlt_raw)
    torch.cuda.synchronize()
    assert scan32.launches == before + 1
    for g, w in zip(got, scan32.scan_core_reference(dlt_raw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("radius", [16, 24])
@pytest.mark.parametrize("n", [64, 100_003])
def test_refit_kernel_matches_plain(cuda, radius, n):
    rng = np.random.default_rng(n + radius)
    packed_t = rng.random((6, n), dtype=np.float32)
    i = np.arange(n - 1)
    first = np.maximum(i - rng.integers(0, 3 * radius, n - 1), 0)
    last = np.minimum(i + 1 + rng.integers(0, 3 * radius, n - 1), n - 1)
    edge = [n - 1]
    mat = np.concatenate([packed_t.view(np.int32), np.concatenate([first, edge])[None],
                          np.concatenate([last, edge])[None]]).astype(np.int32)
    mat = torch.from_numpy(mat).to(cuda)
    before = refit_dense.launches
    got = refit_dense.refit_dense(mat, n, radius)
    torch.cuda.synchronize()
    assert refit_dense.launches == before + 1
    for g, w in zip(got, refit_dense.refit_dense_reference(mat, n, radius)):
        assert torch.equal(g, w)


def test_build_matches_cpu(cuda):
    tris = torch.from_numpy(scenes.sponza_like(16_384))
    want = lbvh.build_single_pass_aux(tris)
    got = lbvh.build_single_pass_aux(tris.to(cuda))
    for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert torch.equal(g.cpu(), w)
    assert validate.check_bvh2_correctness(got[0], tris.shape[0])


@pytest.mark.parametrize("scene,preset,w,h,leaf,caps", [
    ("cornellbox", "cornellbox", 128, 128, 16, (64, 512, 4)),
    ("sponza_like", "sponza", 256, 256, 64, (1024, 4096, 32)),
])
def test_raster_kernel_matches_plain(cuda, scene, preset, w, h, leaf, caps):
    soup = scenes.cornellbox() if scene == "cornellbox" else scenes.sponza_like(16_384)
    tris = torch.from_numpy(soup).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=leaf)
    tr, cam = scenes.preset(preset, cuda)
    rays = camera.generate_rays(cam, w, h)
    args, _, ovf = raster_gpu.prepare_sweep(packed, rays, tr, w, h, *caps)
    assert not bool(ovf)
    before = raster_gpu.launches
    got = raster_gpu.raster_sweep(*args)
    torch.cuda.synchronize()
    assert raster_gpu.launches == before + 1
    for g, x in zip(got, raster_gpu.raster_sweep_reference(*args)):
        assert torch.equal(g, x)
    assert bool((got[1] >= 0).any())


def _soup(scene):
    if scene == "sponza_like":
        return scenes.sponza_like(16_384)
    if scene == "dup":
        rng = np.random.default_rng(0)
        return np.repeat(scenes.sponza_like(16_384)[rng.choice(16_384, 256, replace=False)],
                         64, axis=0)
    return scenes.caterpillar()


@pytest.mark.parametrize("scene", ["sponza_like", "dup", "caterpillar"])
def test_collapse_kernel_matches_plain(cuda, scene):
    tris = torch.from_numpy(_soup(scene))
    aux = lbvh.build_single_pass_aux(tris.to(cuda))
    m = aux[0].n_internal
    rows = collapse_fast.kernel_inputs(*aux)
    before = collapse_block.launches
    got_m, got_a = collapse_block.collapse_block(*rows, m)
    torch.cuda.synchronize()
    assert collapse_block.launches == before + 1
    want_m, want_a = collapse_block.collapse_block_reference(*rows, m)
    assert torch.equal(got_m, want_m)
    for g, w in zip(got_a, want_a):
        assert torch.equal(g, w)
    # the whole collapse on the GPU == the port's CPU collapse
    got = collapse_fast.collapse_lbvh_to_bvh4(*aux)
    want = collapse_fast.collapse_lbvh_to_bvh4(*lbvh.build_single_pass_aux(tris))
    for f in Bvh4._fields:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert validate.check_bvh4_correctness(got, tris.shape[0])


@pytest.mark.parametrize("occlusion", [False, True])
def test_ray_sweep_kernel_matches_plain(cuda, occlusion):
    tris = torch.from_numpy(scenes.sponza_like(16_384)).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=64)
    tr, cam = scenes.preset("sponza", cuda)
    prim = camera.generate_rays(cam, 128, 128)
    hit, _, ovf = raster_gpu.render_raster_gpu(packed, prim, tr, 128, 128, 1024, 4096, 32)
    assert not bool(ovf)
    # rays from the primary hits towards a point light above the scene
    live = hit.prim_idx >= 0
    pts = prim.origin + prim.direction * torch.where(live, hit.t, 0.0)[:, None]
    light = torch.tensor([0.0, 20.0, 0.0], device=cuda)
    dvec = light - pts
    dist = torch.linalg.norm(dvec, dim=1)
    dirs = dvec / dist[:, None]
    rays = Rays(pts + dirs * 1e-3, dirs, torch.zeros_like(dist),
                torch.where(live, dist - 2e-3, -1.0))
    args, _, _, ovf = ray_sweep.prepare_trace(packed, rays, tr, 4096, 24576, 32)
    assert not bool(ovf)
    before = ray_sweep.launches
    got = ray_sweep.ray_sweep_kernel(*args, occlusion)
    torch.cuda.synchronize()
    assert ray_sweep.launches == before + 1
    for g, x in zip(got, ray_sweep.ray_sweep_reference(*args, occlusion)):
        assert torch.equal(g, x)
    assert bool((got[1] >= 0).any())


@pytest.mark.parametrize("leaf", [ray_sweep.MAX_L, ray_sweep.MAX_L + 1])
def test_ray_sweep_kernel_at_its_leaf_size_limit(cuda, leaf):
    """The largest slab that fits the kernel's shared memory launches and
    equals the plain version; one prim more raises before the launch."""
    tris = torch.from_numpy(scenes.sponza_like(4096)).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=leaf)
    tr, cam = scenes.preset("sponza", cuda)
    args, _, _, ovf = ray_sweep.prepare_trace(packed, camera.generate_rays(cam, 64, 64), tr,
                                              64, 4096, 32)
    assert not bool(ovf) and args[1].shape[1] == leaf
    before = ray_sweep.launches
    if leaf > ray_sweep.MAX_L:
        with pytest.raises(ValueError, match="L <="):
            ray_sweep.ray_sweep_kernel(*args)
        assert ray_sweep.launches == before
        return
    got = ray_sweep.ray_sweep_kernel(*args)
    torch.cuda.synchronize()
    assert ray_sweep.launches == before + 1
    for g, x in zip(got, ray_sweep.ray_sweep_reference(*args)):
        assert torch.equal(g, x)
    assert bool((got[1] >= 0).any())
