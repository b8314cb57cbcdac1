"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch and the CUDA toolkit
are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from front_half_scenes import SCENES as FRONT_SCENES
from tpu_bvh_torch.models import batched, lbvh, ploc
from tpu_bvh_torch.ops import (batched_block, batched_build, collapse_block, collapse_fast,
                               front_half,
                               plane_scan, ploc_nn, ploc_round, radix_tree, raster, raster_gpu,
                               ray_sweep, refit_dense, scan32, threshold_core, traverse)
from tpu_bvh_torch.ops import ploc as ploc_ops
from tpu_bvh_torch.types import (PLOC_RADIUS, Bvh2, Bvh4, PrimRefs, Rays, Transformation,
                                 identity_transform)
from tpu_bvh_torch.utils import camera, introspect, kernels, scenes, validate, work

pytestmark = pytest.mark.cuda
FRONT_KERNELS = ("front_tri_box", "front_keys", "front_gather")


def _launches(*names):
    """The named kernels' launches (`kernels.launches`), summed."""
    return sum(kernels.launches[k] for k in names)


def _traverse_launches():
    """The traversal kernels' launches, by kernel."""
    return {k: kernels.launches[f"traverse_{k}"] for k in traverse.KERNELS}


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
    before = kernels.launches["scan32"]
    got = scan32.scan_core(dlt_raw)
    torch.cuda.synchronize()
    assert kernels.launches["scan32"] == before + 1
    for g, w in zip(got, scan32.scan_core_reference(dlt_raw)):
        assert torch.equal(g, w)


TILE_EDGES = [1, 2, 31, 32, 33, 1023, 1024, 1025]  # rows around a warp and a tile


@pytest.mark.parametrize("kind", ["random", "dups", "all_equal", "sorted_line"])
@pytest.mark.parametrize("m", TILE_EDGES)
def test_scan_kernel_matches_plain_at_tile_edges(cuda, kind, m):
    """B1 (one launch of the psv/nsv scan with its child epilogue) at row
    counts around a warp and a tile."""
    dlt_raw = radix_tree.adjacent_deltas(_codes(kind, m + 1, seed=m).to(cuda))
    got = scan32.scan_core(dlt_raw)
    for g, w in zip(got, scan32.scan_core_reference(dlt_raw)):
        assert torch.equal(g, w)


def test_scan_kernel_past_one_resident_wave(cuda):
    """B1 at its largest size, 2^22 - 1 boundaries: many tiles a block."""
    m = (1 << 22) - 1
    assert threshold_core.launch_grid(m, cuda, topology=True)["tiles_a_block"] > 1
    dlt_raw = radix_tree.adjacent_deltas(_codes("random", m + 1, seed=3).to(cuda))
    got = scan32.scan_core(dlt_raw)
    for g, w in zip(got, scan32.scan_core_reference(dlt_raw)):
        assert torch.equal(g, w)


def _refit_mat(n, radius, seed, signed_zeros=False):
    """Packed columns (optionally with +0.0/-0.0 in a min and a -max row)
    and mixed ranges first <= i < last, as the `mat` of refit_dense."""
    rng = np.random.default_rng(seed)
    packed_t = rng.random((6, n), dtype=np.float32)
    if signed_zeros:
        zeros = np.where(rng.random(n) < 0.5, np.float32(0.0), np.float32(-0.0))
        packed_t[0] = np.where(rng.random(n) < 0.5, zeros, packed_t[0])
        packed_t[4] = np.where(rng.random(n) < 0.5, zeros[::-1], -packed_t[4])
    i = np.arange(n - 1)
    first = np.maximum(i - rng.integers(0, 3 * radius, n - 1), 0)
    last = np.minimum(i + 1 + rng.integers(0, 3 * radius, n - 1), n - 1)
    edge = [n - 1]
    return np.concatenate([packed_t.view(np.int32), np.concatenate([first, edge])[None],
                           np.concatenate([last, edge])[None]]).astype(np.int32)


def _same_bits(got, want):
    return all(g.dtype == w.dtype and torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("radius", [16, 24])
@pytest.mark.parametrize("n", [64, 100_003])
def test_refit_kernel_matches_plain(cuda, radius, n):
    mat = torch.from_numpy(_refit_mat(n, radius, n + radius)).to(cuda)
    before = kernels.launches["refit_dense"]
    got = refit_dense.refit_dense(mat, n, radius)
    torch.cuda.synchronize()
    assert kernels.launches["refit_dense"] == before + 1
    assert _same_bits(got, refit_dense.refit_dense_reference(mat, n, radius))


T = refit_dense.TILE


@pytest.mark.parametrize("radius", [15, 24, 128])
@pytest.mark.parametrize("n", [T - 1, T, T + 1, 3 * T + 5])
def test_refit_tiles_match_plain_with_signed_zeros(cuda, radius, n):
    """B2 at tile borders and its halo's full radius, on +0.0/-0.0 columns:
    both entries, bit for bit, one launch each."""
    mat = torch.from_numpy(_refit_mat(n, radius, n * radius, signed_zeros=True)).to(cuda)
    want = refit_dense.refit_dense_reference(mat, n, radius)
    before = kernels.launches["refit_dense"]
    got = refit_dense.refit_dense(mat, n, radius)
    packed_t, first, last = mat[0:6].view(torch.float32), mat[6, :n - 1], mat[7, :n - 1]
    got_cols = refit_dense.refit_dense_cols(packed_t, first, last, n, radius)
    torch.cuda.synchronize()
    assert kernels.launches["refit_dense"] == before + 2
    assert _same_bits(got, want) and _same_bits(got_cols, want)


def test_build_matches_cpu(cuda):
    tris = torch.from_numpy(scenes.sponza_like(16_384))
    want = lbvh.build_single_pass_aux(tris)
    got = lbvh.build_single_pass_aux(tris.to(cuda))
    for g, w in zip(list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        assert g.dtype == w.dtype and torch.equal(_bits(g.cpu()), _bits(w))
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
    before = kernels.launches["raster_sweep"]
    got = raster_gpu.raster_sweep(*args)
    torch.cuda.synchronize()
    assert kernels.launches["raster_sweep"] == before + 1
    for g, x in zip(got, raster_gpu.raster_sweep_reference(*args)):
        assert torch.equal(g, x)
    assert bool((got[1] >= 0).any())


RENDER_CAPS = {(512, 512): (1024, 4096, 32), (1920, 1080): (1024, 8192, 32)}


@pytest.mark.parametrize("w,h", list(RENDER_CAPS))
def test_raster_split_matches_plain(cuda, w, h):
    """B4 on the renders' sponza workload (262K triangles, leaf 64, their
    caps), where one subtile sweeps tens of pairs and most sweep none: all
    five outputs bit for bit, the pair sweeps spread over the SMs."""
    tris = torch.from_numpy(scenes.sponza_like(262_000)).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=64)
    tr, cam = scenes.preset("sponza", cuda)
    rays, wp, hp = raster_gpu.pad_rays(camera.generate_rays(cam, w, h), w, h)
    args, _, ovf = raster_gpu.prepare_sweep(packed, rays, tr, wp, hp, *RENDER_CAPS[(w, h)])
    assert not bool(ovf)
    before = kernels.launches["raster_sweep"]
    got = raster_gpu.raster_sweep(*args)
    torch.cuda.synchronize()
    assert kernels.launches["raster_sweep"] == before + 1
    for g, x in zip(got, raster_gpu.raster_sweep_reference(*args)):
        assert torch.equal(g, x)
    sweeps = got[4].reshape(-1, 256)[:, 0] // 64
    assert int(sweeps.max()) > 10 * float(sweeps.float().mean())  # heavily imbalanced
    stats = raster_gpu.last_stats.cpu()
    assert int(stats[1]) >= int(sweeps.sum()) and int(stats[4:].sum()) == int(stats[1])
    assert int(stats[0]) >= int(got[4].sum(dtype=torch.int64))
    assert int((stats[4:] > 0).sum()) > 64  # the sweeps spread over the SMs


def test_raster_split_resweeps_with_inflated_bounds(cuda):
    """B4 with every entry bound tripled (still sorted, no longer below
    every hit) on small triangles before a slanted backdrop, one prim a
    treelet: hits past the stop pair beat the serial walk's, and the finish
    pass re-sweeps those subtiles serially."""
    rng = np.random.default_rng(5)
    small = rng.uniform(-1.5, 1.5, (120, 1, 3)) + rng.uniform(-0.3, 0.3, (120, 3, 3))
    back = np.array([[[-30.0, -30.0, 4.0], [30.0, -30.0, 4.0], [0.0, 40.0, -40.0]]])
    tris = torch.from_numpy(np.concatenate([small, back] * 2).astype(np.float32)).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=1)
    tr, cam = scenes.preset("cornellbox", cuda)
    args, _, ovf = raster_gpu.prepare_sweep(packed, camera.generate_rays(cam, 128, 128), tr, 128,
                                            128, 256, 8192, 4)
    assert not bool(ovf)
    args = list(args)
    args[3] = torch.where(args[3] < raster_gpu.BIG, args[3] * 3.0 + 0.5, args[3])
    got = raster_gpu.raster_sweep(*args)
    torch.cuda.synchronize()
    for g, x in zip(got, raster_gpu.raster_sweep_reference(*args)):
        assert torch.equal(g, x)
    assert int(raster_gpu.last_stats[2]) > 0


def test_raster_sweep_refuses_2_pow_22_pairs(cuda):
    tris = torch.from_numpy(scenes.cornellbox()).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=16)
    tr, cam = scenes.preset("cornellbox", cuda)
    args, _, _ = raster_gpu.prepare_sweep(packed, camera.generate_rays(cam, 64, 64), tr, 64, 64,
                                          64, 512, 4)
    P = raster_gpu.MAX_P
    pad = lambda x, v: torch.cat([x, torch.full((P - x.shape[0],), v, dtype=x.dtype, device=cuda)])
    big = (*args[:2], pad(args[2], -1), pad(args[3], raster_gpu.BIG), pad(args[4], 0), *args[5:])
    before = kernels.launches["raster_sweep"]
    with pytest.raises(ValueError, match="2\\^22"):
        raster_gpu.raster_sweep(*big)
    assert kernels.launches["raster_sweep"] == before


def _soup(scene):
    if scene == "sponza_like":
        return scenes.sponza_like(16_384)
    if scene == "dup":
        rng = np.random.default_rng(0)
        return np.repeat(scenes.sponza_like(16_384)[rng.choice(16_384, 256, replace=False)],
                         64, axis=0)
    return scenes.caterpillar()


def _same_rows(got, want):
    """B3's four input rows on the card equal the plain prep's on the CPU."""
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32 and torch.equal(g.cpu(), w)


@pytest.mark.parametrize("scene", ["sponza_like", "dup", "caterpillar"])
def test_collapse_kernel_matches_plain(cuda, scene):
    """P1 and P2 (the caterpillar's crown overflows the bushy capacity and
    runs at capacity m) give the plain prep's rows; B3 on them gives the
    plain version's outputs; the whole collapse on the card makes three
    hand-written launches and equals the CPU collapse."""
    tris = torch.from_numpy(_soup(scene))
    aux = lbvh.build_single_pass_aux(tris.to(cuda))
    m = aux[0].n_internal
    before = _launches("collapse_prep", "collapse_coarse")
    rows = collapse_fast.kernel_inputs(*aux)
    torch.cuda.synchronize()
    assert _launches("collapse_prep", "collapse_coarse") == before + 2
    _same_rows(rows, collapse_fast.kernel_inputs(*lbvh.build_single_pass_aux(tris)))
    before = kernels.launches["collapse_block"]
    got_m, got_a = collapse_block.collapse_block(*rows, m)
    torch.cuda.synchronize()
    assert kernels.launches["collapse_block"] == before + 1
    want_m, want_a = collapse_block.collapse_block_reference(*rows, m)
    assert torch.equal(got_m, want_m)
    for g, w in zip(got_a, want_a):
        assert torch.equal(g, w)
    # the whole collapse on the GPU == the port's CPU collapse
    got = collapse_fast.collapse_lbvh_to_bvh4(*aux)
    torch.cuda.synchronize()
    assert collapse_fast.last_build["launches"] == 3
    n_long = int(collapse_fast.last_build["long"])
    want = collapse_fast.collapse_lbvh_to_bvh4(*lbvh.build_single_pass_aux(tris))
    assert collapse_fast.last_build["launches"] == 0
    assert int(collapse_fast.last_build["long"]) == n_long
    for f in Bvh4._fields:
        assert torch.equal(_bits(getattr(got, f).cpu()), _bits(getattr(want, f))), f
    assert validate.check_bvh4_correctness(got, tris.shape[0])


CT = collapse_block.TILE


@pytest.mark.parametrize("w", [CT - 1, CT, CT + 1, 3 * CT + 5])
def test_collapse_tiles_match_plain(cuda, w):
    """P1, P2 and B3 where W (the leaf count) falls at and across tile
    borders (P1's tile and B3's are both TILE lanes): the rows equal the
    plain prep's on the CPU, B3's outputs the plain version's."""
    rng = np.random.default_rng(w)
    base = rng.uniform(-10.0, 10.0, (w, 1, 3))
    tris = torch.from_numpy((base + rng.normal(0.0, 0.5, (w, 3, 3))).astype(np.float32))
    aux = lbvh.build_single_pass_aux(tris.to(cuda))
    rows = collapse_fast.kernel_inputs(*aux)
    assert rows[0].shape[1] == w
    _same_rows(rows, collapse_fast.kernel_inputs(*lbvh.build_single_pass_aux(tris)))
    got_m, got_a = collapse_block.collapse_block(*rows, aux[0].n_internal)
    want_m, want_a = collapse_block.collapse_block_reference(*rows, aux[0].n_internal)
    torch.cuda.synchronize()
    assert torch.equal(got_m, want_m) and all(torch.equal(g, x) for g, x in zip(got_a, want_a))


@pytest.mark.parametrize("scene", ["sponza_262k", "bench_4m"])
def test_build_single_pass_bvh4_on_the_card_equals_the_cpu_path(cuda, scene):
    """The build-plus-collapse entry at the benchmark's sizes (a 4M frame of
    `benchmark/scene.py`: 3,999,995 internal nodes): one B3 launch, three
    hand-written launches in the collapse, B3's rows and the card's Bvh4
    equal the plain path's on the CPU bit for bit; the card reads B3's error
    flag once more than the CPU path reads, five reads at 4M."""
    if scene == "sponza_262k":
        tris = torch.from_numpy(scenes.sponza_like(262_000))
    else:
        from benchmark.scene import Scene

        tris = Scene(4_000_000, 262_000, 1, 0.0, 2**31 + 23, "cpu").frames[0]
    before = kernels.launches["collapse_block"]
    got = lbvh.build_single_pass_bvh4(tris.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["collapse_block"] == before + 1
    assert collapse_fast.last_build["launches"] == 3
    syncs = lbvh.last_build["host_syncs"]
    if scene == "bench_4m":
        assert syncs == 5
    want = lbvh.build_single_pass_bvh4(tris)
    assert syncs == lbvh.last_build["host_syncs"] + 1
    for f in Bvh4._fields:
        assert torch.equal(_bits(getattr(got, f).cpu()), _bits(getattr(want, f))), f
    del got, want
    aux = lbvh.build_single_pass_aux(tris.to(cuda))
    cpu_aux = (Bvh2(*(x.cpu() for x in aux[0])), *(x.cpu() for x in aux[1:]))
    _same_rows(collapse_fast.kernel_inputs(*aux), collapse_fast.kernel_inputs(*cpu_aux))


@pytest.mark.parametrize("n", [2, 300, 70_000])
def test_build_single_pass_bvh4_replays_equal_the_cpu_path(cuda, n):
    """Repeated calls at one size: three soups of n triangles, the first
    one again last: every call one B3 launch and one flag read more than
    the CPU path, and every Bvh4 equal to the CPU path's bit for bit, read
    after the last call (no call's output is reused by a later one)."""
    g = torch.Generator().manual_seed(n)
    soups = [torch.rand((1, 1, 3), generator=g) * 20 + torch.rand((n, 3, 3), generator=g)
             for _ in range(2)]
    soups.append(torch.rand((n, 3, 3), generator=g) * 50)
    got, want = [], []
    for tris in soups + soups[:1]:
        before = kernels.launches["collapse_block"]
        got.append(lbvh.build_single_pass_bvh4(tris.to(cuda)))
        torch.cuda.synchronize()
        assert kernels.launches["collapse_block"] == before + 1
        syncs = lbvh.last_build["host_syncs"]
        want.append(lbvh.build_single_pass_bvh4(tris))
        assert syncs == lbvh.last_build["host_syncs"] + 1
    for a, b in zip(got, want):  # after every call
        for f in Bvh4._fields:
            assert torch.equal(_bits(getattr(a, f).cpu()), _bits(getattr(b, f))), f


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
    before = kernels.launches["ray_sweep"]
    got = ray_sweep.ray_sweep_kernel(*args, occlusion)
    torch.cuda.synchronize()
    assert kernels.launches["ray_sweep"] == before + 1
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
    before = kernels.launches["ray_sweep"]
    if leaf > ray_sweep.MAX_L:
        with pytest.raises(ValueError, match="L <="):
            ray_sweep.ray_sweep_kernel(*args)
        assert kernels.launches["ray_sweep"] == before
        return
    got = ray_sweep.ray_sweep_kernel(*args)
    torch.cuda.synchronize()
    assert kernels.launches["ray_sweep"] == before + 1
    for g, x in zip(got, ray_sweep.ray_sweep_reference(*args)):
        assert torch.equal(g, x)
    assert bool((got[1] >= 0).any())


def _inside_sponza_rays(cuda, n=16_384):
    """Rays from one point inside the sponza hall in every direction: many
    pairs per group, and the serial rule stops each subgroup somewhere
    along its list."""
    soup = scenes.sponza_like(16_384)
    pts = soup.reshape(-1, 3)
    centre = torch.from_numpy((pts.min(0) + pts.max(0)) / 2) + torch.tensor([0.0, 0.5, 0.0])
    d = np.random.default_rng(13).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(centre.expand(n, 3).contiguous().to(cuda), torch.from_numpy(d).to(cuda),
                torch.zeros(n, device=cuda), torch.full((n,), 1000.0, device=cuda))
    return torch.from_numpy(soup).to(cuda), rays


@pytest.mark.parametrize("inflate", [False, True])
@pytest.mark.parametrize("occlusion", [False, True])
def test_ray_sweep_split_over_many_chunks(cuda, occlusion, inflate):
    """B5 where a subgroup's swept pairs span many chunks; with the entry
    bounds tripled (still sorted, no longer below every hit) the least key
    may lie past the stop pair and the finish pass re-sweeps."""
    tris, rays = _inside_sponza_rays(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=16)
    tr, _ = scenes.preset("sponza", cuda)
    args, _, _, ovf = ray_sweep.prepare_trace(packed, rays, tr, 4096, 1 << 16, 32)
    assert not bool(ovf)
    if inflate:
        args = list(args)
        args[3] = torch.where(args[3] < ray_sweep.BIG, args[3] * 3.0 + 0.5, args[3])
    before = kernels.launches["ray_sweep"]
    got = ray_sweep.ray_sweep_kernel(*args, occlusion)
    torch.cuda.synchronize()
    assert kernels.launches["ray_sweep"] == before + 1
    for g, x in zip(got, ray_sweep.ray_sweep_reference(*args, occlusion)):
        assert torch.equal(g, x)
    sweeps = got[4].reshape(-1, 256)[:, 0] // 16
    assert int(sweeps.max()) > 4 * ray_sweep.CHUNK
    stats = ray_sweep.last_stats.cpu()
    assert int(stats[1]) >= int(sweeps.sum())  # pair sweeps, speculation included
    assert int(stats[4:].sum()) == int(stats[1])
    assert int(stats[0]) >= int(got[4].sum(dtype=torch.int64))


def test_ray_sweep_refuses_2_pow_23_pairs(cuda):
    tris = torch.from_numpy(scenes.sponza_like(4096)).to(cuda)
    packed = raster.pack_raster(lbvh.build_single_pass(tris), tris, leaf_size=64)
    tr, cam = scenes.preset("sponza", cuda)
    args, _, _, _ = ray_sweep.prepare_trace(packed, camera.generate_rays(cam, 64, 64), tr,
                                            64, 4096, 32)
    P = ray_sweep.MAX_P
    pad = lambda x, v: torch.cat([x, torch.full((P - x.shape[0],), v, dtype=x.dtype, device=cuda)])
    big = (*args[:2], pad(args[2], -1), pad(args[3], ray_sweep.BIG), pad(args[4], 0), *args[5:])
    before = kernels.launches["ray_sweep"]
    with pytest.raises(ValueError, match="2\\^23"):
        ray_sweep.ray_sweep_kernel(*big)
    assert kernels.launches["ray_sweep"] == before
    got = ray_sweep.ray_sweep_kernel(*(x[:-1] if i in (2, 3, 4) else x for i, x in enumerate(big)))
    torch.cuda.synchronize()  # one pair less launches
    for g, x in zip(got, ray_sweep.ray_sweep_reference(*args)):
        assert torch.equal(g, x)


# ------------------------------------------------------------ front half


def _same_or_nan(got, want, signed_zeros):
    """f32[3] of the scene box: NaN where the other is NaN, equal bits
    elsewhere, or equal values where the sign of a zero may differ."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    assert torch.equal(g, w) if signed_zeros else torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name", list(FRONT_SCENES))
@pytest.mark.parametrize("extended", [True, False])
def test_front_half_kernels_match_plain(cuda, name, extended):
    """The three front-half kernels (A, B, C around torch.sort) against
    the plain steps on the same CUDA triangles: the sorted codes, leaf
    rows and leaf prims bit for bit; the packed rows bit for bit; the
    extent's bits (a NaN by place); the scene minimum's values (the plain
    amin may keep either zero)."""
    tris = torch.from_numpy(FRONT_SCENES[name]()).to(cuda)
    before = _launches(*FRONT_KERNELS)
    got = lbvh._sorted_leaves_from_tris(tris, extended)
    torch.cuda.synchronize()
    assert _launches(*FRONT_KERNELS) == before + 3 and front_half.last_build == {"launches": 3}
    assert _same_bits(got, front_half.from_tris_reference(tris, extended))
    rows, scene_min, ext = front_half.tri_rows(tris)
    want_rows, want_min, want_ext = front_half.tri_rows_reference(tris)
    assert _same_bits([rows], [want_rows])
    _same_or_nan(ext, want_ext, signed_zeros=False)
    _same_or_nan(scene_min, want_min, signed_zeros=True)
    assert _same_bits([front_half.keys(rows, None, scene_min, ext, extended)],
                      [front_half.keys_reference(rows, None, scene_min, ext, extended)])


@pytest.mark.parametrize("name", ["sponza", "soup_70001", "one", "signed_zeros", "nan", "cap"])
def test_front_half_refs_route_matches_plain(cuda, name):
    """The PrimRefs route (the plain scene box, then B with prim_idx and
    C) with shuffled prim ids, against the plain steps."""
    tris = torch.from_numpy(FRONT_SCENES[name]()).to(cuda)
    mn, mx = lbvh.prim_refs_from_triangles(tris)[:2]
    g = torch.Generator().manual_seed(5)
    refs = PrimRefs(mn, mx, torch.randperm(tris.shape[0], generator=g).to(cuda, torch.int32))
    before = _launches(*FRONT_KERNELS)
    got = lbvh._sorted_leaves_packed(refs, True)
    torch.cuda.synchronize()
    assert _launches(*FRONT_KERNELS) == before + 2 and front_half.last_build == {"launches": 2}
    assert _same_bits(got, front_half.from_rows_reference(lbvh.packed_rows(refs), refs.prim_idx,
                                                          True))


@pytest.mark.parametrize("name", ["sponza", "signed_zeros", "swap"])
def test_front_half_ploc_route_equals_the_refs_route(cuda, name):
    """PLOC's front half takes the triangles; the PrimRefs route it took
    before (`prim_refs_from_triangles` and `packed_rows`) gives the same
    bits, by the kernels and by the plain steps."""
    tris = torch.from_numpy(FRONT_SCENES[name]()).to(cuda)
    refs = lbvh.prim_refs_from_triangles(tris)
    got = lbvh._sorted_leaves_from_tris(tris, True)
    assert _same_bits(got, lbvh._sorted_leaves_packed(refs, True))
    assert _same_bits(got, front_half.from_rows_reference(lbvh.packed_rows(refs), refs.prim_idx,
                                                          True))


def test_front_half_launches_per_build(cuda):
    """Three launches a build on the card, for the LBVH and PLOC
    builders, none for CPU input; the builds equal the CPU's."""
    tris = torch.from_numpy(FRONT_SCENES["swap"]()).to(cuda)
    for build in (lbvh.build_single_pass, ploc.build_ploc):
        before = _launches(*FRONT_KERNELS)
        got = build(tris)
        assert _launches(*FRONT_KERNELS) == before + 3 and front_half.last_build == {"launches": 3}
        want = build(tris.cpu())
        assert _launches(*FRONT_KERNELS) == before + 3 and front_half.last_build == {"launches": 0}
        for f in ("packed_t", "left", "right", "root"):
            assert torch.equal(_bits(getattr(got, f)).cpu(), _bits(getattr(want, f)))


@pytest.mark.parametrize("view", ["every_other", "transposed"])
def test_front_half_strided_soup_builds_as_its_copy(cuda, view):
    """A strided view of a soup (every other triangle; each triangle's
    vertex and axis dimensions swapped) builds the tree of its contiguous
    copy, with the kernels' three launches."""
    soup = torch.from_numpy(FRONT_SCENES["sponza"]()).to(cuda)
    tris = soup[::2] if view == "every_other" else soup.transpose(1, 2)
    assert not tris.is_contiguous()
    before = {k: kernels.launches[k] for k in FRONT_KERNELS}
    got = lbvh.build_single_pass(tris)
    assert all(kernels.launches[k] == before[k] + 1 for k in before)
    want = lbvh.build_single_pass(tris.contiguous())
    for f in ("packed_t", "left", "right", "root"):
        assert torch.equal(_bits(getattr(got, f)), _bits(getattr(want, f)))
    assert _same_bits(lbvh._sorted_leaves_from_tris(tris, True),
                      front_half.from_tris_reference(tris, True))


def test_cost_analysis_counts_the_front_half_kernels(cuda):
    """Each front-half kernel's cost_analysis row holds its count
    (`work.front_half`): from triangles C reads no pos (68 B a primitive),
    from PrimRefs B reads prim_idx and C pos besides."""
    tris = torch.from_numpy(FRONT_SCENES["soup_70001"]()).to(cuda)
    n = tris.shape[0]
    rows, scene_min, ext = front_half.tri_rows(tris)
    prim = torch.randperm(n, device=cuda).to(torch.int32)
    skey, pos = torch.sort(front_half.keys(rows, prim, scene_min, ext, True))
    cases = [("front_tri_box", lambda: front_half.tri_rows(tris), "tri_box", False,
              "front_box_kernel")]
    for refs, p in ((False, None), (True, prim)):
        cases += [("front_keys", lambda p=p: front_half.keys(rows, p, scene_min, ext, True), "keys",
                   refs, "front_keys_kernel"),
                  ("front_gather", lambda p=p: front_half.gather(skey, pos, rows, p), "gather",
                   refs, "front_gather_kernel")]
    for name, fn, kind, refs, kernel in cases:
        row = introspect.cost_analysis(fn)["ops"][name]
        assert row["hand_kernel"] and row["calls"] == 1, name
        assert (row["bytes accessed"], row["flops"]) == work.front_half(kind, n, refs)[:2], name
        names = [r["name"] for r in introspect.kernel_report(fn)]
        assert names and all(kernel in nm for nm in names), (name, names)
    assert work.front_half("gather", n)[0] == 68 * n
    assert work.front_half("gather", n, refs=True)[0] == 76 * n


# ------------------------------------------------------------------ PLOC

R = PLOC_RADIUS


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _junk(shape, cuda):
    """A buffer of -3s: a column that only one version writes shows."""
    return torch.full(shape, -3, dtype=torch.int32, device=cuda)


def _ploc_state(cuda, n_tris=16_384):
    """The first-round cluster state of sponza_like(n_tris)."""
    tris = torch.from_numpy(scenes.sponza_like(n_tris)).to(cuda)
    codes, packed_t, _ = lbvh._sorted_leaves_packed(lbvh.prim_refs_from_triangles(tris), True)
    return ploc_ops.initial_state(packed_t, codes)


def _signed_zero_state(cuda, size=640, seed=0):
    """Boxes with -0.0 and +0.0 faces and many equal areas."""
    rng = np.random.default_rng(seed)
    mn = rng.choice(np.array([-1.0, -0.0, 0.0, 0.5], np.float32), (3, size))
    mx = mn + rng.choice(np.array([0.0, 0.5], np.float32), (3, size))
    cols = np.concatenate([mn, -mx]).astype(np.float32).view(np.int32)
    codes = np.sort(rng.integers(0, 1 << 30, size))
    node = rng.integers(0, 2 * size, size)
    mat = np.concatenate([cols, codes[None], node[None]]).astype(np.int32)
    return torch.from_numpy(mat).to(cuda)


def _hploc_states(cuda):
    """(n, [(state, nc, shift) before each of the first six HPLOC rounds])
    of sponza_like(16384), from the plain rounds on the card."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    states, nc, shift = [], n, ploc.HPLOC_SHIFT0
    sink = _junk((8, n - 1), cuda)
    while len(states) < 6:
        states.append((mat, nc, shift))
        mat, _, nm = ploc_round.ploc_round_reference(mat, sink, nc, shift, n - nc, R)
        nc -= int(nm)
        shift = min(shift + ploc.HPLOC_SHIFT_STEP, 32)
    return n, states


@pytest.mark.parametrize("radius", [4, R])
@pytest.mark.parametrize("state,nc,shift", [("sponza", None, 32), ("sponza", None, 9),
                                            ("sponza", 5000, 3), ("zeros", 600, 32),
                                            ("zeros", 640, 24)])
def test_ploc_nn_kernel_matches_plain(cuda, state, nc, shift, radius):
    """B10 on the sponza state (the segments of shifts 9 and 3, nc < S) and
    on signed-zero boxes with tied areas."""
    mat = _ploc_state(cuda) if state == "sponza" else _signed_zero_state(cuda)
    nc = mat.shape[1] if nc is None else nc
    before = kernels.launches["ploc_nn"]
    got = ploc_nn.ploc_nn_round_raw(mat, nc, shift, radius)
    torch.cuda.synchronize()
    assert kernels.launches["ploc_nn"] == before + 1
    assert torch.equal(got, ploc_nn.ploc_nn_round_raw_reference(mat, nc, shift, radius))
    assert bool((got[7] == 1).any())


def _nn_special_state(cuda, size, seed=0):
    """Boxes with -0.0 and +0.0 faces, many equal areas and one face in 40
    a NaN; codes in runs of about 8 equal values above bit 9, so shifts 0
    and 9 make segments of several lanes."""
    mat = _signed_zero_state(cuda, size, seed)
    cols = mat[0:6].view(torch.float32)
    rng = np.random.default_rng(seed + 1)
    cols[torch.from_numpy(rng.random(cols.shape) < 1 / 40).to(cuda)] = float("nan")
    codes = np.sort(rng.integers(0, max(size // 8, 1), size)) << 9
    mat[6] = torch.from_numpy(codes.astype(np.int32)).to(cuda)
    return mat


T = ploc_nn.TILE


@pytest.mark.parametrize("width,nc,shift,radius,state", [
    (T, T, 32, 8, "sponza"), (T + 1, T + 1, 9, 8, "sponza"), (2 * T + 17, T - 1, 0, 3, "sponza"),
    (2 * T + 17, 2 * T, 32, 1, "sponza"), (3 * T + 5, 3 * T + 5, 32, 8, "special"),
    (3 * T + 5, 2 * T + 1, 9, 3, "special"), (3 * T + 5, T - 7, 0, 1, "special"),
    (16_384, 16_384, 32, 8, "special"), (16_384, 9_999, 24, 8, "special")])
def test_ploc_nn_kernel_at_tile_edges(cuda, width, nc, shift, radius, state):
    """B10 at its tiles' edges (widths of one tile and one lane past it,
    live lanes ending on either side of a tile's end), radius 1, 3 and 8,
    shifts 0, 9, 24 and 32, and on boxes with NaN and +-0 faces, where the
    areas' hardware min must make jnp.minimum's choices: every row equal,
    one launch a call."""
    if state == "sponza":
        mat = _ploc_state(cuda)[:, :width].contiguous()
    else:
        mat = _nn_special_state(cuda, width)
    before = kernels.launches["ploc_nn"]
    got = ploc_nn.ploc_nn_round_raw(mat, nc, shift, radius)
    torch.cuda.synchronize()
    assert kernels.launches["ploc_nn"] == before + 1
    assert torch.equal(got, ploc_nn.ploc_nn_round_raw_reference(mat, nc, shift, radius))
    assert bool((got[7] == 1).any())


@pytest.mark.parametrize("shift", [32, ploc.HPLOC_SHIFT0])
def test_ploc_nn_phase_clocks_change_no_output(cuda, shift):
    """With the clock record the launch writes the same rows, and every
    phase of every block took cycles."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    want = ploc_nn.ploc_nn_round_raw(mat, n, shift, R)
    got = torch.empty_like(mat)
    clk = torch.zeros((-(-n // T), 5), dtype=torch.int64, device=cuda)
    ploc_nn.launch(mat, n, shift, R, got, n, clk)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((torch.diff(clk, dim=1) > 0).all())
    cyc = ploc_nn.phase_cycles(mat, n, shift, R)
    assert set(cyc) == {*ploc_nn.PHASES, "total"}
    assert all(cyc[k][0] > 0 and cyc[k][1] >= cyc[k][0] for k in ploc_nn.PHASES)


@pytest.mark.parametrize("k", [0, 2, 5])
def test_ploc_round_kernels_match_plain(cuda, k):
    """B9, B6 (ping-pong) and B8 (allocating) on states along the HPLOC
    build, in every output: the survivors, the node buffer, n_merged."""
    n, states = _hploc_states(cuda)
    mat, nc, shift = states[k]
    base = n - nc
    nn = ploc_nn.ploc_nn_round_raw_reference(mat, nc, shift, R)
    before = (kernels.launches["ploc_emit_compact"], _launches("ploc_round", "ploc_round_fused"))
    cases = [
        (ploc_round.ploc_emit_compact(mat, nn, _junk((8, n - 1), cuda), nc, base),
         ploc_round.ploc_emit_compact_reference(mat, nn, _junk((8, n - 1), cuda), nc, base)),
        (ploc_round.ploc_round_pp(mat, _junk(mat.shape, cuda), _junk((8, n - 1), cuda), nc, shift,
                                  base, R),
         ploc_round.ploc_round_pp_reference(mat, _junk(mat.shape, cuda), _junk((8, n - 1), cuda),
                                            nc, shift, base, R)),
        (ploc_round.ploc_round_fused(mat, _junk((8, n - 1), cuda), nc, shift, base, R),
         ploc_round.ploc_round_reference(mat, _junk((8, n - 1), cuda), nc, shift, base, R)),
    ]
    torch.cuda.synchronize()
    # B9 launches once; each round is one launch of the fused kernel
    assert (kernels.launches["ploc_emit_compact"],
            _launches("ploc_round", "ploc_round_fused")) == (before[0] + 1, before[1] + 2)
    for got, want in cases:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(cases[0][1][2]) > 0


@pytest.mark.parametrize("nc", [1, 2, 255, 256, 257, 1023, 1024, 1025, 5000, "all"])
@pytest.mark.parametrize("merges", [True, False])
def test_emit_compact_one_launch_matches_plain(cuda, nc, merges):
    """B9 around its block edges (tiles of 1024 lanes, 512 threads), with
    nc < S (the zeros past nc, whole blocks past the live lanes) and with
    no merge (an HPLOC stall), into memory that held junk: one launch a
    call; the survivors, the zero tail, the node buffer and n_merged equal
    the plain version, and node columns outside [base, base + n_merged)
    keep their junk."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    nc = n if nc == "all" else nc
    nn = ploc_nn.ploc_nn_round_raw_reference(mat, nc, 32, R)
    if not merges:
        nn[7] = 0
    base = 7
    _junk((8 * n + 1,), cuda)  # freed at once: the output's allocation takes this block
    before = kernels.launches["ploc_emit_compact"]
    got = ploc_round.ploc_emit_compact(mat, nn, _junk((8, n - 1), cuda), nc, base)
    torch.cuda.synchronize()
    assert kernels.launches["ploc_emit_compact"] == before + 1
    want = ploc_round.ploc_emit_compact_reference(mat, nn, _junk((8, n - 1), cuda), nc, base)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    nm = int(want[2])
    assert (nm > 0) == (merges and nc > 1)
    junk = _junk((8, n - 1), cuda)
    assert torch.equal(got[1][:, :base], junk[:, :base])
    assert torch.equal(got[1][:, base + nm:], junk[:, base + nm:])


def test_emit_and_round_alternate_on_one_stream(cuda):
    """B9 and B6 alternate on one stream (each with its own look-back words,
    one epoch count for both), twelve times over the HPLOC states, the live
    count falling and then jumping back up: every call equals the plain
    version in every output."""
    n, states = _hploc_states(cuda)
    work = ploc_round.round_work(n, cuda)
    for k in range(12):
        mat, nc, shift = states[k % len(states)]
        base = n - nc
        nn = ploc_nn.ploc_nn_round_raw_reference(mat, nc, shift, R)
        cases = [
            (ploc_round.ploc_emit_compact(mat, nn, _junk((8, n - 1), cuda), nc, base),
             ploc_round.ploc_emit_compact_reference(mat, nn, _junk((8, n - 1), cuda), nc, base)),
            (ploc_round.ploc_round_pp(mat, _junk(mat.shape, cuda), _junk((8, n - 1), cuda), nc,
                                      shift, base, R, work),
             ploc_round.ploc_round_pp_reference(mat, _junk(mat.shape, cuda),
                                                _junk((8, n - 1), cuda), nc, shift, base, R))]
        for got, want in cases:
            for g, w in zip(got, want):
                assert torch.equal(g, w), k


@pytest.mark.parametrize("nc", [1, 2, 3, 300])
def test_ploc_round_kernel_few_clusters(cuda, nc):
    mat = _ploc_state(cuda)[:, :1000].contiguous()
    got = ploc_round.ploc_round_fused(mat, _junk((8, 999), cuda), nc, 32, 0, R)
    want = ploc_round.ploc_round_reference(mat, _junk((8, 999), cuda), nc, 32, 0, R)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nc", [1, 2, 3, 255, 256, 257, 300, 5000, "all"])
def test_ploc_round_one_launch_matches_plain(cuda, nc):
    """B6 and B8 around the fused kernel's block edges and on the whole
    16K state: one launch a round, no B9 or B10 launch."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    nc = n if nc == "all" else nc
    before = (_launches("ploc_round", "ploc_round_fused"), kernels.launches["ploc_emit_compact"],
              kernels.launches["ploc_nn"])
    got = [ploc_round.ploc_round_pp(mat, _junk(mat.shape, cuda), _junk((8, n - 1), cuda), nc, 9,
                                    0, R),
           ploc_round.ploc_round_fused(mat, _junk((8, n - 1), cuda), nc, 9, 0, R)]
    torch.cuda.synchronize()
    assert (_launches("ploc_round", "ploc_round_fused"), kernels.launches["ploc_emit_compact"],
            kernels.launches["ploc_nn"]) == (before[0] + 2, before[1], before[2])
    want = [ploc_round.ploc_round_pp_reference(mat, _junk(mat.shape, cuda),
                                               _junk((8, n - 1), cuda), nc, 9, 0, R),
            ploc_round.ploc_round_reference(mat, _junk((8, n - 1), cuda), nc, 9, 0, R)]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert torch.equal(g, w)


def test_ploc_rounds_reuse_their_scratch(cuda):
    """Twenty consecutive rounds on one RoundWork (the ticket and the
    look-back epochs are reused), held round by round against the plain
    round: survivors, node buffer and n_merged."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    work = ploc_round.round_work(n, cuda)
    got_m, got_s, got_n = mat, _junk(mat.shape, cuda), _junk((8, n - 1), cuda)
    want_m, want_n = mat, _junk((8, n - 1), cuda)
    nc, shift = n, ploc.HPLOC_SHIFT0
    for _ in range(20):
        _, _, nm = ploc_round.ploc_round_pp(got_m, got_s, got_n, nc, shift, n - nc, R, work)
        want_s, _, want_nm = ploc_round.ploc_round_pp_reference(
            want_m, _junk(mat.shape, cuda), want_n, nc, shift, n - nc, R)
        torch.cuda.synchronize()
        assert int(nm) == int(want_nm)
        keep = nc - int((ploc_nn.ploc_nn_round_raw_reference(want_m[:, :nc], nc, shift, R)[7]
                         == 2).sum())
        assert torch.equal(got_s[:, :keep], want_s[:, :keep]) and torch.equal(got_n, want_n)
        assert int(work.ctl[0]) == 0 and int(work.ctl[2]) == keep
        nc -= int(nm)
        got_m, got_s, want_m = got_s, got_m, want_s
        shift = min(shift + ploc.HPLOC_SHIFT_STEP, 32)


ONE_CTA = ploc_round.FIN_ONE_CTA
CTAS = ploc_round.FIN_CTAS


@pytest.mark.parametrize("width,shift,step", [
    (2, 32, 6), (3, 9, 6), (32, 9, 6), (33, 9, 3), (1000, 9, 6), (ONE_CTA, 9, 6),
    (ONE_CTA + 1, 9, 3), (CTAS * 256 + 1, 32, 6), (4096, 9, 3), (16_384, 9, 6),
    ("max", 32, 6), ("max", 9, 6)])
def test_ploc_finish_kernel_matches_plain(cuda, width, shift, step):
    """B7 down to one cluster, at widths around its regime thresholds (one
    warp at 32, one CTA at FIN_ONE_CTA) and slice borders, up to its
    shared-memory width limit MAX_FIN_WIDTH."""
    w = ploc_round.MAX_FIN_WIDTH if width == "max" else width
    mat = _ploc_state(cuda, max(w, 16_384) + 64)[:, :w].contiguous()
    before = kernels.launches["ploc_finish"]
    got = ploc_round.ploc_finish(mat, _junk((8, w), cuda), w, shift, 0, R, step)
    torch.cuda.synchronize()
    assert kernels.launches["ploc_finish"] == before + 1
    want = ploc_round.ploc_finish_reference(mat, _junk((8, w), cuda), w, shift, 0, R, step)
    assert torch.equal(got, want)
    assert bool((got[:, :w - 1] != -3).all()) and bool((got[:, w - 1:] == -3).all())


def test_ploc_finish_refuses_past_its_width(cuda):
    w = ploc_round.MAX_FIN_WIDTH + 1
    mat = _ploc_state(cuda, w + 64)[:, :w].contiguous()
    before = kernels.launches["ploc_finish"]
    with pytest.raises(ValueError, match="MAX_FIN_WIDTH"):
        ploc_round.ploc_finish(mat, _junk((8, w), cuda), w, 32, 0, R, 6)
    assert kernels.launches["ploc_finish"] == before


def test_ploc_finish_runs_every_regime(cuda):
    """One cluster launch of B7 from the HPLOC hand-over width down: its
    counters show rounds in the cluster, in CTA 0 and in one warp, with
    cycles in every phase, and rounds that add up to the plain loop's."""
    w = 16_384
    mat = _ploc_state(cuda, w + 64)[:, :w].contiguous()
    got = ploc_round.ploc_finish(mat, _junk((8, w), cuda), w, 9, 0, R, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, ploc_round.ploc_finish_reference(mat, _junk((8, w), cuda), w, 9, 0,
                                                             R, 6))
    stats = ploc_round.last_finish_stats.cpu()
    assert stats.shape == ploc_round.FIN_STATS
    assert bool((stats[:, 0] > 0).all()) and bool((stats[:, 1:6] > 0).all())
    assert bool((stats[:, 1] >= stats[:, 2:].sum(dim=1)).all())


@pytest.mark.parametrize("name,fin", [("ploc", None), ("hploc", None), ("ploc", 4096),
                                      ("hploc", 4096), ("hploc", 256), ("two_pass", None)])
def test_builds_match_cpu(cuda, monkeypatch, name, fin):
    """The GPU builds equal the port's CPU builds in every Bvh2 field: at
    the default hand-over width (the whole soup goes to the finisher, no
    round runs) and with the width cut to 4096 or 256, where the GPU's
    round loop runs rounds before the finisher, the hand-over moves and
    the tree does not."""
    build = {"ploc": ploc.build_ploc, "hploc": ploc.build_hploc,
             "two_pass": lbvh.build_two_pass}[name]
    tris = torch.from_numpy(scenes.sponza_like(16_384))
    want = build(tris)
    if fin is not None:
        monkeypatch.setattr(ploc_round, "FIN_WIDTH", fin)
    before = (_launches("ploc_round", "ploc_round_fused"), kernels.launches["ploc_finish"])
    got = build(tris.to(cuda))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(_bits(g.cpu()), _bits(w))
    assert validate.check_bvh2_correctness(got, tris.shape[0])
    if name != "two_pass":
        rounds = ploc_ops.last_build["rounds"]
        if fin is None:  # the whole soup goes to the finisher
            assert tris.shape[0] <= ploc_round.FIN_WIDTH and rounds == 0
        else:
            assert rounds > 0
        assert _launches("ploc_round", "ploc_round_fused") == before[0] + rounds
        assert kernels.launches["ploc_finish"] == before[1] + 1


# ------------------------------------------------------ threshold scans

def _deltas(kind, m, cuda):
    """Deltas in [0, 52]: drawn at random (values repeat), all equal, or the
    remapped deltas of sorted codes (unique range minima)."""
    if kind == "draws":
        d = np.random.default_rng(m).integers(0, 53, m).astype(np.int32)
        return torch.from_numpy(d).to(cuda)
    if kind == "zeros":
        return torch.zeros(m, dtype=torch.int32, device=cuda)
    return scan32.remap_deltas(radix_tree.adjacent_deltas(_codes(kind, m + 1).to(cuda)))


@pytest.mark.parametrize("kind", ["draws", "zeros", "random", "dups"])
@pytest.mark.parametrize("m", [1, 1000, 1025, 262_144])
def test_threshold_kernels_match_plain(cuda, kind, m):
    """B12/B13, B14 and B15 against their plain versions, one launch each."""
    dlt = _deltas(kind, m, cuda)
    pay = torch.from_numpy(np.random.default_rng(1).integers(0, 2**22, m).astype(np.int32))
    pay = pay.to(cuda)
    counters = ("psv_nsv_packed", "psv_nsv_payload", "child_positions")
    before = [kernels.launches[c] for c in counters]
    got = [threshold_core.psv_nsv_packed(dlt), threshold_core.psv_nsv_payload_auto(dlt, pay),
           threshold_core.child_positions_auto(dlt)]
    torch.cuda.synchronize()
    assert [kernels.launches[c] for c in counters] == [b + 1 for b in before]
    want = [threshold_core.psv_nsv_packed_reference(dlt),
            threshold_core.psv_nsv_payload_reference(dlt, pay),
            threshold_core.child_positions_reference(dlt)]
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["draws", "zeros", "random", "dups"])
@pytest.mark.parametrize("m", TILE_EDGES)
def test_psv_nsv_kernels_match_plain_at_tile_edges(cuda, kind, m):
    """B12/B13 and B14 at row counts around a warp and a tile."""
    dlt = _deltas(kind, m, cuda)
    pay = torch.from_numpy(np.random.default_rng(m).integers(0, 2**22, m).astype(np.int32))
    pay = pay.to(cuda)
    for g, w in zip(threshold_core.psv_nsv_packed(dlt), threshold_core.psv_nsv_packed_reference(dlt)):
        assert torch.equal(g, w)
    got = threshold_core.psv_nsv_payload_auto(dlt, pay)
    for g, w in zip(got, threshold_core.psv_nsv_payload_reference(dlt, pay)):
        assert torch.equal(g, w)


def test_psv_nsv_kernels_past_one_resident_wave(cuda):
    """B12/B13 and B14 on 2^23 draws in [0, 63]: many tiles a block."""
    m = 1 << 23
    assert threshold_core.launch_grid(m, cuda)["tiles_a_block"] > 1
    rng = np.random.default_rng(23)
    dlt = torch.from_numpy(rng.integers(0, 64, m).astype(np.int32)).to(cuda)
    pay = torch.from_numpy(rng.integers(0, 2**22, m).astype(np.int32)).to(cuda)
    for g, w in zip(threshold_core.psv_nsv_packed(dlt), threshold_core.psv_nsv_packed_reference(dlt)):
        assert torch.equal(g, w)
    got = threshold_core.psv_nsv_payload_auto(dlt, pay)
    for g, w in zip(got, threshold_core.psv_nsv_payload_reference(dlt, pay)):
        assert torch.equal(g, w)


def test_topology_and_psv_scans_are_one_launch_each(cuda):
    """B1, B12/B13, B14, B15, B11, B16's two halves and B9 are one CUDA
    kernel a call, with no memset: one torch.profiler trace of one call
    each, a synchronize between them (one trace for all: a later trace in
    the same process can come back empty)."""
    dlt_raw = radix_tree.adjacent_deltas(_codes("random", 262_145).to(cuda))
    dlt = scan32.remap_deltas(dlt_raw)
    dlt32 = scan32.dlt32_from_raw(dlt_raw)
    flipped = torch.flip(dlt32, [0])
    plane = torch.where(dlt[:, None] < torch.arange(64, device=cuda)[None, :],
                        dlt[:, None], threshold_core.BIG)
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    nn = ploc_nn.ploc_nn_round_raw_reference(mat, n, 32, R)
    nodes = _junk((8, n - 1), cuda)
    calls = (lambda: scan32.scan_core(dlt_raw), lambda: threshold_core.psv_nsv_packed(dlt),
             lambda: threshold_core.psv_nsv_payload_auto(dlt, dlt),
             lambda: threshold_core.child_positions_auto(dlt),
             lambda: plane_scan.plane_scan(plane, is_min=True, reverse=True),
             lambda: scan32.scan_fwd(dlt32), lambda: scan32.scan_rev(flipped, dlt32.shape[0]),
             lambda: ploc_round.ploc_emit_compact(mat, nn, nodes, n, 0))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for fn in calls:
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in sorted(events, key=lambda e: e["ts"]) if e.get("cat") == "kernel"]
    assert sum(e.get("cat") == "gpu_memset" for e in events) == 0
    assert len(names) == 8, names
    assert "Topology" in names[0] and all("PsvNsv" in nm for nm in names[1:3]), names
    assert "ChildPositions" in names[3] and "plane_scan_kernel" in names[4], names
    assert "Scan32Fwd" in names[5] and "Scan32Rev" in names[6], names
    assert "emit_kernel" in names[7], names


def test_psv_nsv_phase_clocks(cuda):
    """The phase clocks of B12's launch: every phase of every block took
    cycles, and the call with clocks gives the same answers."""
    dlt = _deltas("random", 262_144, cuda)
    cyc = threshold_core.psv_nsv_phase_cycles(dlt)
    assert set(cyc) == {"phase1", "sync", "phase2", "phase3", "total"}
    assert all(med > 0 and most >= med for med, most in (cyc[k] for k in cyc if k != "total"))
    want = threshold_core.psv_nsv_packed_reference(dlt)
    clk = torch.zeros((threshold_core.launch_grid(dlt.shape[0], cuda)["blocks"], 5),
                      dtype=torch.int64, device=cuda)
    for g, w in zip(threshold_core._threshold_cuda(dlt, None, clk), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("which", ["psv_nsv", "payload", "child"])
def test_threshold_kernels_refuse_large_m(cuda, which):
    """m >= 2^25 (64 * pos packing) and, for B15, m >= 2^22 (22-bit
    positions) raise before any launch."""
    limit = threshold_core.MAX_M_CHILD if which == "child" else threshold_core.MAX_M
    dlt = torch.zeros(limit, dtype=torch.int32, device=cuda)
    fn = {"psv_nsv": threshold_core.psv_nsv_packed,
          "payload": lambda d: threshold_core.psv_nsv_payload_auto(d, d),
          "child": threshold_core.child_positions_auto}[which]
    before = (kernels.launches["psv_nsv_packed"], kernels.launches["psv_nsv_payload"],
              kernels.launches["child_positions"])
    with pytest.raises(ValueError, match=f"m < {limit}"):
        fn(dlt)
    assert (kernels.launches["psv_nsv_packed"], kernels.launches["psv_nsv_payload"],
            kernels.launches["child_positions"]) == before
    got = fn(dlt[:-1])  # one row less launches: equal deltas have no smaller
    torch.cuda.synchronize()  # value and empty child windows
    assert bool((got[0] == -1).all())


_T = plane_scan.TILE_ROWS
PLANES = sorted({(1000, 64), (262_144, 64), (300, 5), (700, 130)}
                | {(m, v) for m in (1, 2, _T - 1, _T, _T + 1, 262_143) for v in (3, 64, 130)})


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("m,v", PLANES)
def test_plane_scan_kernel_matches_plain(cuda, is_min, reverse, m, v):
    """B11 (one launch) around a tile's rows, at widths of one strip, part
    of one and three strips (V = 130: no 16-byte rows)."""
    x = np.random.default_rng(m + v).integers(-(2**31), 2**31 - 1, size=(m, v), dtype=np.int64)
    x = torch.from_numpy(x.astype(np.int32)).to(cuda)
    before = kernels.launches["plane_scan"]
    got = plane_scan.plane_scan(x, is_min=is_min, reverse=reverse)
    torch.cuda.synchronize()
    assert kernels.launches["plane_scan"] == before + 1
    assert torch.equal(got, plane_scan.plane_scan_reference(x, is_min=is_min, reverse=reverse))


def test_plane_scan_reuses_its_scratch(cuda):
    """Calls of other shapes and modes back to back, with no synchronize:
    each reads only its own epoch's status words from the shared scratch,
    and a 16-byte-misaligned view takes the scalar loads."""
    rng = np.random.default_rng(5)
    big = torch.from_numpy(rng.integers(-50, 50, size=(5000, 130), dtype=np.int32)).to(cuda)
    cases = [(big, True, False), (big[:3000, :64].contiguous(), False, True),
             (big[:70].contiguous(), True, True), (big.view(-1)[1:64 * 999 + 1].view(999, 64),
                                                   False, False),
             (big[:4000], False, True), (big, True, False)]
    got = [plane_scan.plane_scan(x, is_min=mn, reverse=rv) for x, mn, rv in cases]
    for g, (x, mn, rv) in zip(got, cases):
        assert torch.equal(g, plane_scan.plane_scan_reference(x, is_min=mn, reverse=rv))


_SPONZA_DELTAS = {}


def _child_deltas(kind, m, cuda):
    """Deltas in [0, 63] for B15: a soup of a few repeated values, every
    delta equal, draws, or sponza 262K's remapped deltas (repeated past
    its 261,995 rows)."""
    rng = np.random.default_rng(m + 11)
    if kind == "soup":
        d = rng.choice(np.array([0, 5, 5, 17, 62, 63], np.int32), m)
    elif kind == "equal":
        d = np.full(m, 7, np.int32)
    elif kind == "draws":
        d = rng.integers(0, 64, m).astype(np.int32)
    else:
        if "d" not in _SPONZA_DELTAS:
            tris = torch.from_numpy(scenes.sponza_like(262_000)).to(cuda)
            codes = lbvh._sorted_leaves_from_tris(tris, True)[0]
            _SPONZA_DELTAS["d"] = scan32.remap_deltas(radix_tree.adjacent_deltas(codes))
        s = _SPONZA_DELTAS["d"]
        return s.repeat(-(-m // s.shape[0]))[:m].contiguous()
    return torch.from_numpy(d).to(cuda)


@pytest.mark.parametrize("kind", ["soup", "equal", "draws", "sponza"])
@pytest.mark.parametrize("m", [1, 2, 1023, 1025, 262_143, (1 << 22) - 1])
def test_child_positions_kernel_one_pass(cuda, kind, m):
    """B15 (one cooperative launch of psv_scan.cuh with the <= answers and
    the scatter) against its plain version: at and past one resident wave
    (2^22 - 1 rows: many tiles a block, the answers parked)."""
    d = _child_deltas(kind, m, cuda)
    before = kernels.launches["child_positions"]
    got = threshold_core.child_positions_auto(d)
    torch.cuda.synchronize()
    assert kernels.launches["child_positions"] == before + 1
    for g, w in zip(got, threshold_core.child_positions_reference(d)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["random", "dups", "all_equal", "sorted_line"])
@pytest.mark.parametrize("n", [2, 97, 100_003])
def test_scan_halves_match_plain_and_b1(cuda, kind, n):
    """B16's halves against their plain versions and against B1's outputs."""
    dlt_raw = radix_tree.adjacent_deltas(_codes(kind, n).to(cuda))
    dlt32 = scan32.dlt32_from_raw(dlt_raw)
    m = n - 1
    before = kernels.launches["scan32_halves"]
    fwd = scan32.scan_fwd(dlt32)
    rev = scan32.scan_rev(torch.flip(dlt32, [0]), m)
    torch.cuda.synchronize()
    assert kernels.launches["scan32_halves"] == before + 2
    want = (scan32.scan_fwd_reference(dlt32), scan32.scan_rev_reference(torch.flip(dlt32, [0]), m))
    for gs, ws in zip((fwd, rev), want):
        for g, w in zip(gs, ws):
            assert torch.equal(g, w)
    b1 = scan32.scan_core(dlt_raw)
    for g, w in zip(fwd + tuple(torch.flip(x, [0]) for x in rev), b1):
        assert torch.equal(g, w)


@pytest.mark.parametrize("scene", ["sponza_like", "dup"])
def test_fast_topologies_match_b1_route(cuda, scene):
    """Both fast topologies launch the threshold kernels and equal B1's
    route, the plain oracles and the port's CPU run."""
    tris = torch.from_numpy(_soup(scene)).to(cuda)
    codes, leaves, _ = lbvh._sorted_leaves_from_tris(tris, True)
    before = (kernels.launches["psv_nsv_packed"], kernels.launches["psv_nsv_payload"])
    ape = radix_tree.apetrei_topology_fast(codes)
    kar = radix_tree.karras_topology_fast(codes)
    torch.cuda.synchronize()
    assert kernels.launches["psv_nsv_packed"] == before[0] + 2
    assert kernels.launches["psv_nsv_payload"] == before[1] + 1
    left, right, parent, _, root, first, last = radix_tree.apetrei_build_packed_full(codes, leaves)
    kl, kr, _ = radix_tree.karras_build_packed(codes, leaves)
    for got, want in ((ape, (left, right, parent, first, last, root)), (kar[:2], (kl, kr)),
                      (ape, radix_tree.apetrei_topology(codes)),
                      (kar, radix_tree.karras_topology(codes)),
                      (ape, radix_tree.apetrei_topology_fast(codes.cpu())),
                      (kar, radix_tree.karras_topology_fast(codes.cpu()))):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())


def _batched_meshes(kind, seed=0):
    """Meshes and a capacity for the batched kernel: random soups at a
    capacity (sizes 2 to it), the demo (the cornellbox at its own size),
    every prim at one point, repeated triangles, a +-0 soup and coordinates
    near FLT_MAX (where a node's box takes the 3e38 fill)."""
    rng = np.random.default_rng(seed)

    def soup(n):
        return (rng.uniform(-10, 10, (n, 1, 3)) + rng.normal(0, 0.5, (n, 3, 3))).astype(np.float32)

    if kind.startswith("random"):
        cap = int(kind[len("random"):])
        return scenes.random_meshes(1000, cap, seed), cap
    if kind == "demo":
        box = scenes.cornellbox()
        return [box] * 4096, box.shape[0]
    if kind == "one_point":
        pts = rng.uniform(-5, 5, (300, 1, 1, 3)).astype(np.float32)
        return [np.broadcast_to(p, (int(n), 3, 3)).copy()
                for p, n in zip(pts, rng.integers(1, 65, 300))], 64
    if kind == "duplicates":
        return [np.tile(soup(k), (64 // k, 1, 1)) for k in rng.integers(1, 6, 300)], 64
    if kind == "signed_zero":
        pick = rng.integers(0, 3, (8192, 3, 3))
        f32 = np.float32
        coords = np.where(pick == 0, f32(-0.0), np.where(pick == 1, f32(0.0), f32(1.0)))
        tris = np.where(rng.random((8192, 3, 3)) < 0.5, coords, rng.random((8192, 3, 3), f32))
        return list(tris.astype(f32).reshape(-1, 32, 3, 3)), 32
    assert kind == "huge"
    return [rng.uniform(3.1e38, 3.35e38, (int(n), 3, 3)).astype(np.float32)
            for n in rng.integers(2, 33, 300)], 32


@pytest.mark.parametrize("kind", ["random2", "random3", "random31", "random32", "random33",
                                  "random63", "random64", "demo", "one_point", "duplicates",
                                  "signed_zero", "huge"])
def test_batched_kernel_matches_plain(cuda, kind):
    """The batched kernel (one launch a call) against its plain version on
    the card and on the CPU, floats by their bits; every tree valid."""
    meshes, cap = _batched_meshes(kind)
    tris_b = batched.pad_meshes(meshes, cap, device=cuda)[0]
    before = kernels.launches["batched_build"]
    got = batched.build_batched(tris_b)
    torch.cuda.synchronize()
    assert kernels.launches["batched_build"] == before + 1
    for want in (batched._build_batched_small(tris_b), batched._build_batched_small(tris_b.cpu())):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(_bits(g).cpu(), _bits(w).cpu())
    for b in range(0, tris_b.shape[0], max(1, tris_b.shape[0] // 64)):
        one = type(got)(*(f[b] for f in got))
        assert validate.check_bvh2_correctness(one, cap) and validate.check_root_aabb(one)


def test_batched_kernel_refuses_past_its_capacity(cuda):
    """A capacity past MAX_PRIMS is refused by the warp kernel before any
    launch, and build_batched sends 65 to the block kernel (one launch, no
    B1 or B2); the block kernel refuses 1025 before any launch, and
    build_batched takes the per-mesh single-pass build there (B1 and B2
    once a mesh). Each route equals the CPU build."""
    cap = batched_build.MAX_PRIMS + 1
    meshes, _ = _batched_meshes("random64", seed=1)
    tris_b = batched.pad_meshes(meshes[:3], cap, device=cuda)[0]
    before = kernels.launches["batched_build"]
    with pytest.raises(ValueError, match="2 <= M <= 64"):
        batched_build.batched_build(tris_b)
    scans, refits, blocks = (kernels.launches[k] for k in ("scan32", "refit_dense",
                                                            "batched_block"))
    got = batched.build_batched(tris_b)
    torch.cuda.synchronize()
    assert kernels.launches["batched_build"] == before
    assert kernels.launches["batched_block"] == blocks + 1
    assert kernels.launches["scan32"] == scans and kernels.launches["refit_dense"] == refits
    for g, w in zip(got, batched.build_batched(tris_b.cpu())):
        assert g.dtype == w.dtype and torch.equal(_bits(g).cpu(), _bits(w))
    cap = batched_block.MAX_PRIMS + 1
    tris_b = batched.pad_meshes(meshes[:3], cap, device=cuda)[0]
    with pytest.raises(ValueError, match="65 <= M <= 1024"):
        batched_block.batched_block(tris_b)
    got = batched.build_batched(tris_b)
    torch.cuda.synchronize()
    assert kernels.launches["batched_block"] == blocks + 1
    assert kernels.launches["scan32"] == scans + 3 and kernels.launches["refit_dense"] == refits + 3
    for g, w in zip(got, batched.build_batched(tris_b.cpu())):
        assert g.dtype == w.dtype and torch.equal(_bits(g).cpu(), _bits(w))


def _block_meshes(kind, seed=0):
    """Meshes and a capacity for the block kernel: random soups at a
    capacity (sizes 2 to it), the +-0 soup, one triangle repeated (every
    code equal), the cornellbox padded, x near FLT_MAX with a geometric run
    (the 3e38 rule of both refit paths)."""
    rng = np.random.default_rng(seed)
    if kind.startswith("random"):
        cap = int(kind[len("random"):])
        return scenes.random_meshes(max(64, 65_536 // cap), cap, seed), cap
    if kind == "signed_zero":
        pick = rng.integers(0, 3, (8192, 3, 3))
        f32 = np.float32
        coords = np.where(pick == 0, f32(-0.0), np.where(pick == 1, f32(0.0), f32(1.0)))
        tris = np.where(rng.random((8192, 3, 3)) < 0.5, coords, rng.random((8192, 3, 3), f32))
        return list(tris.astype(f32).reshape(-1, 128, 3, 3)), 128
    if kind == "one_tri":
        tri = scenes.random_meshes(1, 2, seed)[0][:1]
        return [np.repeat(tri, int(n), axis=0) for n in rng.integers(1, 97, 64)], 96
    if kind == "cornellbox":
        box = scenes.cornellbox()
        return [box] * 512, 65
    assert kind == "huge"
    out = scenes.random_meshes(64, 1024, seed)
    out[0] = np.concatenate([out[0]] * (1024 // len(out[0]) + 1))[:1024]
    out[0][..., 1] = (np.float32(0.97) ** np.arange(1024, dtype=np.float32))[:, None]
    for t in out:
        t[..., 0] = rng.uniform(3.1e38, 3.35e38, t.shape[:2])
    return out, 1024


@pytest.mark.parametrize("kind", ["random65", "random96", "random128", "random257", "random512",
                                  "random1024", "signed_zero", "one_tri", "cornellbox", "huge"])
def test_batched_block_kernel_matches_plain(cuda, kind):
    """The block kernel (one launch a call, through build_batched) against
    its plain version on the card and on the CPU, floats by their bits;
    every tree valid."""
    meshes, cap = _block_meshes(kind)
    tris_b = batched.pad_meshes(meshes, cap, device=cuda)[0]
    before, warps = kernels.launches["batched_block"], kernels.launches["batched_build"]
    scans, refits = kernels.launches["scan32"], kernels.launches["refit_dense"]
    got = batched.build_batched(tris_b)
    torch.cuda.synchronize()
    assert kernels.launches["batched_block"] == before + 1
    assert kernels.launches["batched_build"] == warps
    assert kernels.launches["scan32"] == scans and kernels.launches["refit_dense"] == refits
    for want in (batched_block.batched_block_reference(tris_b),
                 batched_block.batched_block_reference(tris_b.cpu())):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(_bits(g).cpu(), _bits(w).cpu())
    for b in range(0, tris_b.shape[0], max(1, tris_b.shape[0] // 32)):
        one = type(got)(*(f[b] for f in got))
        assert validate.check_bvh2_correctness(one, cap) and validate.check_root_aabb(one)


def test_batched_phase_clocks(cuda):
    """Both kernels' clock64 phase stamps: every phase of every mesh takes
    cycles, and a launch with its clocks on builds the same trees."""
    for mod, cap in ((batched_build, 64), (batched_block, 1024)):
        tris_b = batched.pad_meshes(scenes.random_meshes(256, cap, 3), cap, device=cuda)[0]
        want = (batched_build.batched_build if mod is batched_build
                else batched_block.batched_block)(tris_b)
        cyc = mod.phase_cycles(tris_b)
        assert all(cyc[p][0] > 0 and cyc[p][2] >= cyc[p][1] for p in batched_build.PHASES)
        assert cyc["total"] > 0
        clk = torch.zeros((256, 6), dtype=torch.int64, device=cuda)
        got = mod._launch(tris_b, clk)
        torch.cuda.synchronize()
        assert _same_bits(got, want) and bool((clk.diff(dim=1) > 0).all())


def test_batched_block_on_an_empty_batch(cuda):
    got = batched.build_batched(torch.zeros((0, 200, 3, 3), device=cuda))
    assert [tuple(f.shape) for f in got] == [(0, 6, 399), (0, 399), (0, 399), (0,)]


def test_batched_kernel_on_an_empty_batch(cuda):
    got = batched.build_batched(torch.zeros((0, 32, 3, 3), device=cuda))
    assert [tuple(f.shape) for f in got] == [(0, 6, 63), (0, 63), (0, 63), (0,)]


def _traverse_case(kind, cuda):
    """(Bvh2, tris, rays, transform) on the card: the cornellbox frame, a
    random soup under a rotated, scaled and shifted transform with rays
    from everywhere (some with zero direction components), and a
    sponza_like frame."""
    if kind in ("cornellbox", "sponza"):
        tris = torch.from_numpy(scenes.cornellbox() if kind == "cornellbox"
                                else scenes.sponza_like(16_384)).to(cuda)
        tr, cam = scenes.preset(kind, cuda)
        bvh = (lbvh.build_two_pass if kind == "cornellbox" else lbvh.build_single_pass)(tris)
        return bvh, tris, camera.generate_rays(cam, 96, 64), tr
    rng = np.random.default_rng(17)
    soup = (rng.uniform(-5, 5, (2000, 1, 3)) + rng.normal(0, 1.0, (2000, 3, 3))).astype(np.float32)
    tris = torch.from_numpy(soup).to(cuda)
    n = 4096
    origin = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    direction[: n // 8, rng.integers(0, 3)] = 0.0
    rays = Rays(*(torch.from_numpy(x).to(cuda) for x in (origin, direction)),
                torch.zeros(n, device=cuda), torch.full((n,), 3.4e38, device=cuda))
    axis = np.array([0.3, -0.8, 0.5]) / np.linalg.norm([0.3, -0.8, 0.5])
    quat = np.array([*(axis * np.sin(0.35)), np.cos(0.35)], np.float32)
    tr = Transformation(*(torch.tensor(x, dtype=torch.float32, device=cuda)
                          for x in ([0.5, -1.25, 2.0], [1.5, 0.75, 2.0], quat)))
    return lbvh.build_single_pass(tris), tris, rays, tr


def _same_hits(got, want):
    (gh, gc), (wh, wc) = got, want
    for g, w in zip(gh, wh):
        assert g.dtype == w.dtype and torch.equal(_bits(g).cpu(), _bits(w).cpu())
    assert gc.dtype == torch.int32 and torch.equal(gc.cpu(), wc.cpu())


@pytest.mark.parametrize("variant", list(traverse.VARIANTS) + ["packed"])
@pytest.mark.parametrize("kind", ["cornellbox", "soup", "sponza"])
def test_traverse_kernel_matches_plain(cuda, kind, variant):
    """Each traversal kernel (one launch a call) against the plain engine on
    the card and on the CPU, t, u and v by their bits, the counts exactly;
    its device counters add up to the counts."""
    bvh, tris, rays, tr = _traverse_case(kind, cuda)
    before = _traverse_launches()
    got = traverse.traverse_by_name(variant, bvh, tris, rays, tr)
    torch.cuda.synchronize()
    assert _traverse_launches() == {**before, variant: before[variant] + 1}
    _same_hits(got, traverse.traverse_by_name(variant, bvh, tris, rays, tr, plain=True))
    cpu = [type(x)(*(f.cpu() for f in x)) for x in (bvh, rays, tr)]
    _same_hits(got, traverse.traverse_by_name(variant, cpu[0], tris.cpu(), cpu[1], cpu[2],
                                              plain=True))
    stats = traverse.last_stats.cpu().tolist()
    assert stats[2] == 0 and stats[1] == int(got[1].sum())
    assert stats[0] > 0 and bool((got[0].prim_idx >= 0).any())


def test_traverse_kernels_agree(cuda):
    """The three stack shapes and the packed kernel: the same hits and
    counts; the restart trail: the same hits."""
    bvh, tris, rays, tr = _traverse_case("sponza", cuda)
    base = traverse.traverse_by_name("if_if", bvh, tris, rays, tr)
    for variant in ("while_while", "speculative", "packed"):
        _same_hits(traverse.traverse_by_name(variant, bvh, tris, rays, tr), base)
    hit, _ = traverse.traverse_by_name("restart_trail", bvh, tris, rays, tr)
    for g, w in zip(hit, base[0]):
        assert torch.equal(_bits(g), _bits(w))


def test_traverse_kernel_counts_rows(cuda):
    """With `count_rows` set each launch marks the rows its steps stand on:
    the hits stay the same, the stack kernels and the packed one stand on
    the same rows, every hit prim's leaf row is among them, and there are
    no more of them than steps."""
    bvh, tris, rays, tr = _traverse_case("sponza", cuda)
    rows = {}
    try:
        traverse.count_rows = True
        for variant in traverse.KERNELS:
            got = traverse.traverse_by_name(variant, bvh, tris, rays, tr)
            _same_hits(got, traverse.traverse_by_name(variant, bvh, tris, rays, tr, plain=True))
            rows[variant] = traverse.last_rows.cpu().tolist()
            stats = traverse.last_stats.cpu().tolist()
            assert 1 <= rows[variant][0] <= stats[0] and rows[variant][1] <= stats[1]
            prims = got[0].prim_idx
            assert rows[variant][1] >= int(torch.unique(prims[prims >= 0]).numel()) > 0
    finally:
        traverse.count_rows = False
    assert rows["while_while"] == rows["speculative"] == rows["packed"] == rows["if_if"]


def test_cost_analysis_counts_each_hand_kernel(cuda):
    """cost_analysis of one call of a hand kernel: its row holds the count
    its bound is made of (utils/work.py), as chip_smoke.py prints it; and
    kernel_report(fn) names the kernels the call launched."""
    mat = _ploc_state(cuda)
    n = mat.shape[1]
    nn = ploc_nn.ploc_nn_round_raw_reference(mat, n, 32, R)
    merged, dropped = (int((nn[7] == k).sum()) for k in (1, 2))
    nodes = _junk((8, n - 1), cuda)
    dlt_raw = radix_tree.adjacent_deltas(_codes("random", 65_537).to(cuda))
    dlt = scan32.remap_deltas(dlt_raw)
    m = dlt.shape[0]
    plane = torch.where(dlt[:, None] < torch.arange(64, device=cuda)[None, :],
                        dlt[:, None], threshold_core.BIG)
    bvh, tris, rays, tr = _traverse_case("sponza", cuda)
    meshes = batched.pad_meshes(scenes.random_meshes(256, 32, 2), 32, device=cuda)[0]
    caux = lbvh.build_single_pass_aux(torch.from_numpy(_soup("sponza_like")).to(cuda))
    c_meta, _, _, c_carr = collapse_fast.kernel_inputs(*caux)
    c_n = caux[0].n_leaves
    c_long = int(((caux[3] - caux[2] + 1) > collapse_block.S_LEN).sum())
    cases = [
        ("collapse_prep", lambda: collapse_fast.kernel_inputs(*caux),
         work.collapse_prep(c_n, c_long), "collapse_"),
        ("collapse_coarse", lambda: collapse_fast.kernel_inputs(*caux),
         work.collapse_prep(c_n, c_long, c_meta, c_carr), "collapse_"),
        ("ploc_nn", lambda: ploc_nn.ploc_nn_round_raw(mat, n, 32, R), work.ploc_nn(n, R, 32),
         "ploc_nn_kernel"),
        ("ploc_emit_compact", lambda: ploc_round.ploc_emit_compact(mat, nn, nodes, n, 0),
         work.ploc_emit_compact(n, merged, dropped, n), "emit_kernel"),
        ("ploc_round", lambda: ploc_round.ploc_round_pp(mat, _junk(mat.shape, cuda), nodes, n, 32,
                                                        0, R),
         work.ploc_round(n, merged, dropped, R, 32), "ploc_round_kernel"),
        ("ploc_round_fused", lambda: ploc_round.ploc_round_fused(mat, nodes, n, 32, 0, R),
         work.ploc_round_fused(n, merged, dropped, R, 32), "ploc_round_kernel"),
        ("ploc_finish", lambda: ploc_round.ploc_finish(mat[:, :4096].contiguous(), nodes, 4096,
                                                       32, 0, R, 3),
         work.ploc_finish(mat[:, :4096], 4096, 32, R, 3, ploc_round.FIN_CTAS),
         "ploc_finish_kernel"),
        ("scan32", lambda: scan32.scan_core(dlt_raw),
         work.scan32(dlt_raw, scan32.scan_core_reference(dlt_raw)), "Topology"),
        ("psv_nsv_packed", lambda: threshold_core.psv_nsv_packed(dlt),
         work.per_row("psv_nsv_packed", m), "PsvNsv"),
        ("child_positions", lambda: threshold_core.child_positions_auto(dlt),
         work.per_row("child_positions", m), "ChildPositions"),
        ("plane_scan", lambda: plane_scan.plane_scan(plane, is_min=True, reverse=False),
         work.plane_scan(plane), "plane_scan_kernel"),
        ("batched_build", lambda: batched_build.batched_build(meshes), work.batched(meshes),
         "batched_build_warp"),
        ("traverse_packed", lambda: traverse.traverse_by_name("packed", bvh, tris, rays, tr),
         None, "PackedNodes"),
    ]
    for name, fn, want, kernel in cases:
        got = introspect.cost_analysis(fn)
        row = got["ops"][name]
        assert row["hand_kernel"] and row["calls"] == 1, name
        if want is not None:
            assert (row["bytes accessed"], row["flops"]) == want[:2], name
        assert row["optimal_seconds"] == introspect.optimal_seconds(row["bytes accessed"],
                                                                    row["flops"])
        assert got["flops"] >= row["flops"] and got["bytes accessed"] >= row["bytes accessed"]
        names = [r["name"] for r in introspect.kernel_report(fn)]
        assert names and all(kernel in nm for nm in names), (name, names)
    # the traversal's rows from the same launch as the count, marked because
    # a cost_analysis is counting
    try:
        traverse.count_rows = True
        traverse.traverse_by_name("packed", bvh, tris, rays, tr)
        rows, stats = traverse.last_rows.cpu().tolist(), traverse.last_stats.cpu().tolist()
    finally:
        traverse.count_rows = False
    row = introspect.cost_analysis(
        lambda: traverse.traverse_by_name("packed", bvh, tris, rays, tr))["ops"]["traverse_packed"]
    assert (row["bytes accessed"], row["flops"]) == work.traverse(stats, rows, "packed",
                                                                  rays.origin.shape[0])[:2]


def _caterpillar(cuda):
    """`scenes.deep_chain` on the card: only prim 60 crosses the first ray,
    whose stack overflows."""
    d = {k: torch.from_numpy(v).to(cuda) for k, v in scenes.deep_chain().items()}
    bvh = Bvh2.from_rows(d["node_min"], d["node_max"], d["left"], d["right"],
                         torch.tensor(0, dtype=torch.int32, device=cuda))
    rays = Rays(d["origin"], d["direction"], torch.zeros(2, device=cuda),
                torch.full((2,), 3.4e38, device=cuda))
    return bvh, d["tris"], rays, identity_transform(cuda)


@pytest.mark.parametrize("variant", list(traverse.VARIANTS) + ["packed"])
def test_traverse_kernel_deep_tree_overflow(cuda, variant):
    """The overflowed ray walks again through the restart trail in the same
    thread: prim 60 at t = 2, a miss for the second ray, equal to the plain
    engine; the stack kernels count one overflowed ray."""
    bvh, tris, rays, tr = _caterpillar(cuda)
    got = traverse.traverse_by_name(variant, bvh, tris, rays, tr)
    torch.cuda.synchronize()
    assert got[0].prim_idx.tolist() == [60, -1] and abs(float(got[0].t[0]) - 2.0) < 1e-5
    assert int(traverse.last_stats[2]) == (0 if variant == "restart_trail" else 1)
    _same_hits(got, traverse.traverse_by_name(variant, bvh, tris, rays, tr, plain=True))


def test_traverse_kernel_takes_a_stride0_origin(cuda):
    """A camera's origins are one row expanded (stride 0): the kernel reads
    them in place, and the hits equal those of materialized origins."""
    bvh, tris, rays, tr = _traverse_case("cornellbox", cuda)
    assert rays.origin.stride(0) == 0
    got = traverse.traverse_packed(traverse.pack_bvh2(bvh, tris), bvh.n_internal, bvh.root, rays, tr)
    dense = rays._replace(origin=rays.origin.contiguous())
    _same_hits(got, traverse.traverse_packed(traverse.pack_bvh2(bvh, tris), bvh.n_internal,
                                             bvh.root, dense, tr))
    _same_hits(traverse.traverse_bvh2(bvh, tris, rays, tr, "speculative"),
               traverse.traverse_bvh2_reference(bvh, tris, dense, tr, "speculative"))


_ONE_LAUNCH = """
import json, os, sys, tempfile
import torch
sys.path.insert(0, sys.argv[1])
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import traverse
from tpu_bvh_torch.utils import camera, scenes
dev = torch.device("cuda")
tris = torch.from_numpy(scenes.cornellbox()).to(dev)
tr, cam = scenes.preset("cornellbox", dev)
bvh = lbvh.build_two_pass(tris)
packed = traverse.pack_bvh2(bvh, tris)
rays = camera.generate_rays(cam, 96, 64)
assert rays.origin.stride(0) == 0
calls = [lambda: traverse.traverse_packed(packed, bvh.n_internal, bvh.root, rays, tr)]
calls += [lambda v=v: traverse.traverse_bvh2(bvh, tris, rays, tr, v) for v in traverse.VARIANTS]
for fn in calls:
    fn()
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
out = []
for fn in calls:
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    out.append([[e["name"] for e in events if e.get("cat") == "kernel"],
                sum(e.get("cat") == "gpu_memset" for e in events)])
print(json.dumps(out))
"""


def test_traverse_kernel_is_one_launch_a_call(cuda):
    """`traverse_packed` and each `traverse_bvh2` variant on a camera's rays
    (a stride-0 origin, read in place) are one CUDA kernel and one memset
    (the counters) a call: a torch.profiler trace of one call each, in a
    process of their own (a later trace in a pytest process can come back
    empty)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _ONE_LAUNCH, root], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    calls = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(calls) == len(traverse.KERNELS)
    for names, memsets in calls:
        assert len(names) == 1 and "traverse_kernel" in names[0] and memsets == 1, (names, memsets)


@pytest.mark.parametrize("variant", list(traverse.KERNELS))
@pytest.mark.parametrize("n", [1, 31, 33, "past_a_wave"])
def test_traverse_kernel_ray_counts(cuda, variant, n):
    """The persistent warps at ray counts below, around and past one warp,
    and past what one wave of the card holds (every SM full: 2048 threads):
    every ray's hit and count bit-equal to the plain engine's."""
    bvh, tris, rays, tr = _traverse_case("soup", cuda)
    if n == "past_a_wave":
        n = torch.cuda.get_device_properties(cuda).multi_processor_count * 2048 + 777
        reps = -(-n // rays.origin.shape[0])
        rays = Rays(*(x.repeat(reps, *([1] * (x.dim() - 1)))[:n] for x in rays))
    else:
        rays = Rays(*(x[:n] for x in rays))
    got = traverse.traverse_by_name(variant, bvh, tris, rays, tr)
    want = traverse.traverse_by_name(variant, bvh, tris, rays, tr, plain=True)
    _same_hits(got, want)
    stats = traverse.last_stats.cpu().tolist()
    assert stats[1] == int(got[1].sum()) and stats[2] == 0
    assert int(traverse.last_warp_steps) * 32 >= stats[0] + stats[1] > 0


@pytest.mark.parametrize("variant", list(traverse.KERNELS))
def test_traverse_kernel_mixes_overflowing_and_ordinary_rays(cuda, variant):
    """Rays that overflow the stack (they enter the deep chain's boxes) and
    rays that miss them share warps, and lanes take new rays after an
    overflow: hits and counts bit-equal to the plain engine, one overflowed
    ray a ray that enters (none for the restart trail)."""
    d = scenes.deep_chain(50, 40)
    rows = [torch.from_numpy(d[k]).to(cuda) for k in ("node_min", "node_max", "left", "right")]
    bvh = Bvh2.from_rows(*rows, torch.tensor(0, dtype=torch.int32, device=cuda))
    rng = np.random.default_rng(9)
    n = 1000
    starts = np.array([[0.0, 0.0, -1.0], [6.5, 0.0, -1.0], [3.0, 5.0, -1.0], [50.0, 50.0, -1.0],
                       [-40.0, 0.0, 0.0]], np.float32)
    dirs = np.array([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 0]], np.float32)
    pick = rng.integers(0, len(starts), n)
    rays = Rays(torch.from_numpy(starts[pick]).to(cuda), torch.from_numpy(dirs[pick]).to(cuda),
                torch.zeros(n, device=cuda), torch.full((n,), 3.4e38, device=cuda))
    tris = torch.from_numpy(d["tris"]).to(cuda)
    tr = identity_transform(cuda)
    got = traverse.traverse_by_name(variant, bvh, tris, rays, tr)
    stats = traverse.last_stats.cpu().tolist()
    _same_hits(got, traverse.traverse_by_name(variant, bvh, tris, rays, tr, plain=True))
    entering = int((np.abs(starts[pick, 0]) < 10).sum())
    assert stats[2] == (0 if variant == "restart_trail" else entering)
    assert {40, -1} < set(got[0].prim_idx.tolist())


def test_traverse_kernel_launch_counter_and_no_rays(cuda):
    """One launch a call on CUDA tensors, none for an empty ray set, none
    on CPU tensors."""
    bvh, tris, rays, tr = _traverse_case("cornellbox", cuda)
    before = _traverse_launches()
    after = {**before, "if_if": before["if_if"] + 1}
    traverse.traverse_bvh2(bvh, tris, rays, tr, "if_if")
    assert _traverse_launches() == after
    empty = Rays(*(x[:0] for x in rays))
    hit, counts = traverse.traverse_bvh2(bvh, tris, empty, tr, "if_if")
    assert _traverse_launches() == after and hit.prim_idx.shape == (0,) and counts.shape == (0,)
    cpu = [type(x)(*(f.cpu() for f in x)) for x in (bvh, rays, tr)]
    traverse.traverse_bvh2(cpu[0], tris.cpu(), cpu[1], cpu[2], "if_if")
    assert _traverse_launches() == after


# ---- the sharded paths (tpu_bvh_torch.parallel) on ranks that use the card ----


def _sharded_soup():
    soup = scenes.sponza_like(16_384)
    return soup[:(soup.shape[0] // 4) * 4]


def test_sharded_build_on_gloo_ranks_sharing_the_card(cuda):
    """Two gloo ranks on cuda:0: the assembled tree equals the
    single-device GPU build bit for bit, on both ranks."""
    import torch_ranks
    from tpu_bvh_torch.parallel import comm

    lbvh.build_single_pass(torch.from_numpy(_sharded_soup()).to(cuda))  # build the kernels once
    got = comm.spawn(torch_ranks.sharded_vs_single, 2, device="cuda", backend="gloo",
                     args=(_sharded_soup(),), timeout=300.0)
    assert [r["same"] and not r["overflow"] for r in got] == [True, True]
    assert {r["device"] for r in got} == {"cuda:0"}


def test_sharded_build_over_nccl_at_world_size_1(cuda):
    import torch_ranks
    from tpu_bvh_torch.parallel import comm

    lbvh.build_single_pass(torch.from_numpy(_sharded_soup()).to(cuda))
    (got,) = comm.spawn(torch_ranks.sharded_vs_single, 1, device="cuda", backend="nccl",
                        args=(_sharded_soup(),), timeout=300.0)
    assert got["same"] and not got["overflow"] and got["backend"] == "nccl"


def test_sharded_paths_on_the_card_equal_the_unsharded_calls(cuda):
    """Two gloo ranks on the card: the extents, the batched build, the
    traversal and the raster strips (B4), concatenated in rank order, equal
    the unsharded calls on the card bit for bit."""
    import torch_ranks
    from tpu_bvh_torch.parallel import comm
    from tpu_bvh_torch.utils import convert

    tris_np = scenes.cornellbox()
    tris = torch.from_numpy(tris_np).to(cuda)
    tr, cam = scenes.preset("cornellbox", cuda)
    bvh = lbvh.build_two_pass(tris)
    rays = camera.generate_rays(cam, 128, 64)
    packed = raster.pack_raster(bvh, tris, leaf_size=8)
    caps = {"cand_cap": 16, "pair_cap": 128, "group": 4}
    meshes = np.stack([tris_np[:32] + i for i in range(64)]).astype(np.float32)
    np_of = lambda nt: {f: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)  # noqa: E731
                        for f, v in nt._asdict().items()}
    inputs = {"extents": tris_np, "batched": meshes,
              "traverse": (np_of(bvh), tris_np, np_of(rays), np_of(tr)),
              "raster": (np_of(packed), np_of(rays), np_of(tr), 128, 64, caps)}
    want_b = batched.build_batched(torch.from_numpy(meshes).to(cuda))
    want_t = traverse.traverse_bvh2(bvh, tris, rays, tr)
    want_r = raster_gpu.render_raster_gpu(packed, rays, tr, 128, 64, *caps.values())[0]
    got = comm.spawn(torch_ranks.sharded_paths, 2, device="cuda", backend="gloo",
                     args=(inputs,), timeout=300.0)
    cat = lambda parts: {f: np.concatenate([p[f] for p in parts]) for f in parts[0]}  # noqa: E731
    assert torch_ranks.fields_equal(cat([r["batched"] for r in got]), np_of(want_b))
    assert torch_ranks.fields_equal(cat([r["traverse"][0] for r in got]), np_of(want_t[0]))
    assert np.concatenate([r["traverse"][1] for r in got]).tobytes() == \
        want_t[1].cpu().numpy().tobytes()
    assert torch_ranks.fields_equal(cat([r["raster"] for r in got]), np_of(want_r))
    for r in got:
        np.testing.assert_array_equal(r["extents"][0], tris_np.reshape(-1, 3).min(0))
        np.testing.assert_array_equal(r["extents"][1], tris_np.reshape(-1, 3).max(0))
