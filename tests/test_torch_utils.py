"""The port's utilities and the row forms the app calls, against the JAX
package on the CPU, bit for bit (floats by their bits):

* `utils/timer` (tokens, accumulation, the perf block), `ops/sort`
  (duplicate codes, codes >= 2^31, int64 and int32 carriers),
  `morton.morton30` / `extended_morton30` / `normalize_centroids`,
  `refit.refit_ranges` / `refit_anchored` (also on the +-0 soup),
  `radix_tree.apetrei_build`, `validate.reference_radix_tree_ranges`;
* `utils/split_clip` at a finite `sa_max`, `models/binned_sah` (arrays,
  SAH, check, `to_bvh2`) on the cornellbox and a 2,000-triangle soup;
* the camera jitter (`tea`, `lcg_randf`, jittered rays at 64 x 48);
* `utils/native`, `image.write_png` and `obj.load_obj` with both codecs;
  `utils/serialize` across the packages in both directions;
  `utils/introspect` (ptxas report parsing, the CPU's memory analysis,
  a profiler trace);
* `ops/collapse_analytic` against JAX's and against the sequential
  oracle `collapse_cpu`.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tests.test_torch_signed_zero import signed_zero_soup
from tpu_bvh.models import binned_sah as jbinned_sah
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.models import ploc as jploc
from tpu_bvh.ops import collapse_analytic as jcollapse_analytic
from tpu_bvh.ops import morton as jmorton
from tpu_bvh.ops import radix_tree as jradix_tree
from tpu_bvh.ops import refit as jrefit
from tpu_bvh.ops import sort as jsort
from tpu_bvh.ops.aabb import center as jcenter
from tpu_bvh.ops.aabb import triangle_aabbs as jtriangle_aabbs
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import image as jimage
from tpu_bvh.utils import native as jnative
from tpu_bvh.utils import obj as jobj
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh.utils import serialize as jserialize
from tpu_bvh.utils import split_clip as jsplit_clip
from tpu_bvh.utils import timer as jtimer
from tpu_bvh.utils import validate as jvalidate
from tpu_bvh_torch.models import binned_sah
from tpu_bvh_torch.ops import collapse_analytic, morton, radix_tree, refit, sort
from tpu_bvh_torch.ops.aabb import center, triangle_aabbs
from tpu_bvh_torch.types import Bvh2, Bvh4
from tpu_bvh_torch.utils import (camera, convert, image, introspect, native, obj, scenes,
                                 serialize, split_clip, timer, validate)
from tpu_bvh_torch.utils.cpu_reference import collapse_cpu

U32 = np.uint32


def bits(x):
    """The bytes of a tensor or array, dtype and shape checked by callers."""
    return x.numpy().tobytes() if isinstance(x, torch.Tensor) else np.asarray(x).tobytes()


def same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    return g.shape == w.shape and g.tobytes() == w.astype(g.dtype).tobytes()


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- timer


def test_timer_codes_and_report_follow_jax():
    assert [(c.name, c.value) for c in timer.TimerCodes] == [
        (c.name, c.value) for c in jtimer.TimerCodes]
    tm = timer.Timer(device="cpu")
    assert tm.measure(timer.TimerCodes.SORTING, lambda a, b=0: a + b, 2, b=3) == 5
    for token in (timer.TimerCodes.CALCULATE_MORTON_CODES, timer.TimerCodes.TRAVERSAL):
        with tm.span(token):
            sum(range(1000))
    with tm.span(timer.TimerCodes.TRAVERSAL):  # times accumulate per token
        pass
    total = sum(tm.ms(c) for c in (timer.TimerCodes.CALCULATE_MORTON_CODES,
                                   timer.TimerCodes.SORTING))
    assert tm.total_ms == pytest.approx(total) and tm.ms(timer.TimerCodes.TRAVERSAL) > 0
    assert tm.device_ms(timer.TimerCodes.SORTING) == 0.0  # no events on the CPU
    jt = jtimer.Timer()  # JAX's timer holding the same times under the same tokens
    jt._ms.update({jtimer.TimerCodes[c.name]: ms for c, ms in tm._ms.items()})
    assert tm.report() == jt.report()


# ---------------------------------------------------------------- sort


def _codes(n, seed):
    """u32 codes with duplicates on both sides of 2^31."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 32, n // 4, dtype=np.uint64).astype(U32)
    pool[:4] = [0, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    return rng.choice(pool, n)


@pytest.mark.parametrize("carrier", ["int64", "int32"])
def test_sort_pairs_matches_jax(carrier):
    codes = _codes(2000, 1)
    vals = np.random.default_rng(2).permutation(2000).astype(np.int32)
    want_c, want_v = jsort.sort_pairs(jnp.asarray(codes), jnp.asarray(vals))
    tc = t(codes.astype(np.int64)) if carrier == "int64" else t(codes.view(np.int32))
    got_c, got_v = sort.sort_pairs(tc, t(vals))
    assert got_c.dtype == tc.dtype and got_v.dtype == torch.int32
    assert same(got_c.to(torch.int64) & 0xFFFFFFFF, np.asarray(want_c).astype(np.int64))
    assert same(got_v, want_v)
    assert (np.asarray(want_c) >= 1 << 31).any() and len(np.unique(codes)) < len(codes)


def test_sort_with_payload_matches_jax():
    codes = _codes(1500, 3)
    idx = np.random.default_rng(4).permutation(1500).astype(np.int32)
    col = np.random.default_rng(5).random(1500, dtype=np.float32)
    want_c, want_p = jsort.sort_with_payload(jnp.asarray(codes), (jnp.asarray(idx),
                                                                  jnp.asarray(col)))
    got_c, got_p = sort.sort_with_payload(t(codes.astype(np.int64)), (t(idx), t(col)))
    assert same(got_c, np.asarray(want_c).astype(np.int64))
    assert all(same(g, w) for g, w in zip(got_p, want_p))


# ---------------------------------------------------------------- row forms


def _centroid_scenes():
    rng = np.random.default_rng(7)
    flat = random_tris(rng, 300)
    flat[..., 2] = 0.5  # a zero extent on z
    return {"cornellbox": jscenes.cornellbox(), "soup": random_tris(rng, 1000),
            "sponza_4096": jscenes.sponza_like(4096), "flat_z": flat}


@pytest.mark.parametrize("name", list(_centroid_scenes()))
def test_morton_row_forms_match_jax(name):
    tris = _centroid_scenes()[name]
    jmn, jmx = jtriangle_aabbs(jnp.asarray(tris))
    smin, smax = jmn.min(axis=0), jmx.max(axis=0)
    want_norm = jmorton.normalize_centroids(jcenter(jmn, jmx), smin, smax - smin)
    mn, mx = triangle_aabbs(t(tris))
    tsmin, tsmax = t(np.asarray(smin)), t(np.asarray(smax))
    norm = morton.normalize_centroids(center(mn, mx), tsmin, tsmax - tsmin)
    assert same(norm, want_norm)
    assert same(morton.morton30(norm), np.asarray(jmorton.morton30(want_norm)).astype(np.int64))
    want = jmorton.extended_morton30(want_norm, smax - smin)
    assert same(morton.extended_morton30(norm, tsmax - tsmin), np.asarray(want).astype(np.int64))


@jax.jit
def _sorted_leaves(tris):
    """JAX's sorted codes and leaf boxes of a soup."""
    codes, packed_t, _ = jlbvh._sorted_leaves_from_tris(tris, True)
    return codes, packed_t[0:3].T, -packed_t[3:6].T


# JAX's functions under one jit each (integer topology and exact mins:
# the jit changes no bit), which compiles far faster than op by op
jkarras_topology = jax.jit(jradix_tree.karras_topology)
japetrei_build = jax.jit(jradix_tree.apetrei_build)
jrefit_ranges = jax.jit(jrefit.refit_ranges)
jrefit_anchored = jax.jit(jrefit.refit_anchored)


@pytest.mark.parametrize("name", ["soup", "signed_zero"])
def test_refit_row_forms_match_jax(name):
    tris = (random_tris(np.random.default_rng(8), 700) if name == "soup"
            else signed_zero_soup())
    codes, lmin, lmax = _sorted_leaves(jnp.asarray(tris))
    _, _, _, first, last = jkarras_topology(codes)
    tl, tx = t(np.asarray(lmin)), t(np.asarray(lmax))
    tf, tla = t(np.asarray(first)), t(np.asarray(last))
    ranges = jrefit_ranges(lmin, lmax, first, last)
    for got, want in ((refit.refit_ranges(tl, tx, tf, tla), ranges),
                      (refit.refit_anchored(tl, tx, tf, tla),
                       jrefit_anchored(lmin, lmax, first, last)),
                      # below radius 15 JAX's refit_anchored is refit_ranges
                      (refit.refit_anchored(tl, tx, tf, tla, radius=8), ranges)):
        assert same(got[0], want[0]) and same(got[1], want[1])


@pytest.mark.parametrize("name", ["cornellbox", "signed_zero", "dup"])
def test_apetrei_build_and_reference_ranges_match_jax(name):
    tris = {"cornellbox": jscenes.cornellbox(), "signed_zero": signed_zero_soup(256),
            "dup": np.repeat(random_tris(np.random.default_rng(9), 40), 6, axis=0)}[name]
    codes, lmin, lmax = _sorted_leaves(jnp.asarray(tris))
    want = japetrei_build(codes, lmin, lmax)
    tcodes = t(np.asarray(codes).astype(np.int64))
    got = radix_tree.apetrei_build(tcodes, t(np.asarray(lmin)), t(np.asarray(lmax)))
    assert all(same(g, w) for g, w in zip(got, want))
    ranges = validate.reference_radix_tree_ranges(tcodes)
    assert ranges == jvalidate.reference_radix_tree_ranges(np.asarray(codes))
    _, _, _, first, last, _ = radix_tree.apetrei_topology(tcodes)
    assert sorted(zip(first.tolist(), last.tolist())) == ranges


def test_reference_ranges_on_codes_past_2_31():
    codes = np.sort(_codes(300, 10))
    want = jvalidate.reference_radix_tree_ranges(codes)
    assert validate.reference_radix_tree_ranges(t(codes.view(np.int32))) == want
    assert validate.reference_radix_tree_ranges(t(codes.astype(np.int64))) == want


# ---------------------------------------------------------------- host builders


@pytest.mark.parametrize("sa_max", [np.inf, 4.0, 0.05])
def test_early_split_clipping_matches_jax(sa_max):
    tris = random_tris(np.random.default_rng(11), 400, spread=3.0, size=0.6)
    got = split_clip.early_split_clipping(tris, sa_max)
    want = jsplit_clip.early_split_clipping(tris, sa_max)
    assert all(g.dtype == w.dtype and g.tobytes() == w.tobytes() for g, w in zip(got, want))
    if np.isfinite(sa_max):
        assert len(got[2]) > len(tris)


@pytest.fixture(scope="module")
def sah_trees():
    """(tris, port SahBvh, JAX SahBvh) for the cornellbox and a 2,000-triangle soup."""
    out = {}
    for name, tris in (("cornellbox", jscenes.cornellbox()),
                       ("soup_2000", random_tris(np.random.default_rng(12), 2000))):
        out[name] = (tris, binned_sah.build_binned_sah(tris),
                     jbinned_sah.build_binned_sah(tris))
    return out


@pytest.mark.parametrize("name", ["cornellbox", "soup_2000"])
def test_binned_sah_matches_jax(sah_trees, name):
    tris, got, want = sah_trees[name]
    assert got.n_nodes == want.n_nodes
    for f in ("node_min", "node_max", "first_child", "prim_count"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f
    assert binned_sah.sah_cost(got) == jbinned_sah.sah_cost(want)
    assert binned_sah.check_correctness(got, len(tris))
    tb = binned_sah.to_bvh2(got, device="cpu")
    jb = jbinned_sah.to_bvh2(want)
    assert all(same(getattr(tb, f), getattr(jb, f)) for f in Bvh2._fields)
    assert validate.check_bvh2_correctness(tb, len(tris))


# ---------------------------------------------------------------- camera jitter


def test_tea_and_lcg_match_jax():
    v = np.array([0, 1, 12345, (1 << 31) - 1, 1 << 31, 0xDEADBEEF, (1 << 32) - 1], U32)
    for v1 in (0, 7, 0xFFFFFFFF):
        want = jcamera.tea(jnp.asarray(v), v1)
        got = camera.tea(t(v.astype(np.int64)), v1)
        assert all(same(g, np.asarray(w).astype(np.int64)) for g, w in zip(got, want))
    wf, ws = jcamera.lcg_randf(jnp.asarray(v))
    gf, gs = camera.lcg_randf(t(v.astype(np.int64)))
    assert same(gf, wf) and same(gs, np.asarray(ws).astype(np.int64))


@pytest.mark.parametrize("preset", ["cornellbox", "sponza"])
@pytest.mark.parametrize("jitter", [False, True])
def test_rays_match_jax(preset, jitter):
    _, jcam = jscenes.preset(preset)
    _, cam = scenes.preset(preset, device="cpu")
    want = jcamera.generate_rays(jcam, 64, 48, jitter=jitter)
    got = camera.generate_rays(cam, 64, 48, jitter=jitter)
    assert all(same(g, w) for g, w in zip(got, want))
    if jitter:  # the jitter moves the rays off the pixel centers
        assert not torch.equal(got.direction, camera.generate_rays(cam, 64, 48).direction)


# ---------------------------------------------------------------- native, serialize


def test_native_codecs_match_jax(tmp_path):
    assert native.available() == jnative.available()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.LIB_PATH == os.path.join(root, "native", "libtbvh_native.so")
    tris = jscenes.cornellbox()[:8]
    path = tmp_path / "mesh.obj"
    with open(path, "w") as f:
        for v in tris.reshape(-1, 3):
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        for k in range(len(tris)):
            f.write(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n")
    rgba = np.random.default_rng(13).integers(0, 256, (12, 20, 4), dtype=np.uint8)
    for prefer in (True, False):
        got = obj.load_obj(str(path), prefer)
        assert got.tobytes() == jobj.load_obj(str(path), prefer).tobytes()
        codec = image.write_png(str(tmp_path / "port.png"), rgba, prefer_native=prefer)
        jimage.write_png(str(tmp_path / "jax.png"), rgba, prefer_native=prefer)
        assert codec == ("native" if prefer and native.available() else "python")
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


@pytest.mark.parametrize("kind", ["Bvh2", "Bvh4"])
def test_serialize_crosses_packages(tmp_path, kind):
    tris = jnp.asarray(random_tris(np.random.default_rng(14), 300))
    jb = jploc.build_ploc(tris)
    want = jb if kind == "Bvh2" else jcollapse_analytic.collapse_bvh2_to_bvh4_analytic(jb)
    cls = Bvh2 if kind == "Bvh2" else Bvh4
    jserialize.save_bvh(str(tmp_path / "jax.npz"), want)
    got = serialize.load_bvh(str(tmp_path / "jax.npz"), device="cpu")
    assert type(got) is cls and all(same(getattr(got, f), getattr(want, f)) for f in cls._fields)
    serialize.save_bvh(str(tmp_path / "port.npz"), got)
    back = jserialize.load_bvh(str(tmp_path / "port.npz"))
    assert all(same(getattr(got, f), getattr(back, f)) for f in cls._fields)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes() for k in a.files)


# ---------------------------------------------------------------- introspect

PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z11scan_kernelPKii' for 'sm_90a'
ptxas info    : Function properties for _Z11scan_kernelPKii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 4096 bytes smem, 368 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8traverseILi2EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z8traverseILi2EEvPf
    192 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 56 registers, 400 bytes cmem[0]
"""


def test_kernel_report_parses_ptxas():
    got = introspect.kernel_report(report=PTXAS)
    assert got == [
        {"name": "_Z11scan_kernelPKii", "stack_frame_bytes": 0, "spill_store_bytes": 0,
         "spill_load_bytes": 0, "registers": 40, "smem_bytes": 4096},
        {"name": "_Z8traverseILi2EEvPf", "stack_frame_bytes": 192, "spill_store_bytes": 8,
         "spill_load_bytes": 12, "registers": 56, "smem_bytes": 0},
    ]
    assert introspect.kernel_report(report="") == []


def test_memory_analysis_and_profiler_trace_on_the_cpu(tmp_path):
    assert introspect.memory_analysis(lambda: torch.ones(8), device="cpu") is None
    with introspect.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------- collapse_analytic


COLLAPSE_CASES = {  # name: (triangles, JAX builder)
    "cornellbox_ploc": (jscenes.cornellbox, jploc.build_ploc),
    "soup_two_pass": (lambda: random_tris(np.random.default_rng(15), 600), jlbvh.build_two_pass),
    "soup_single_pass": (lambda: random_tris(np.random.default_rng(15), 600),
                         jlbvh.build_single_pass),
    "two_leaves": (lambda: jscenes.cornellbox()[:2], jlbvh.build_two_pass),
    "signed_zero_hploc": (lambda: signed_zero_soup(200), jploc.build_hploc),
}


@pytest.mark.parametrize("name", list(COLLAPSE_CASES))
def test_collapse_analytic_matches_jax_and_oracle(name):
    make, build = COLLAPSE_CASES[name]
    tris = make()
    jb = build(jnp.asarray(tris))
    want = jax.block_until_ready(jcollapse_analytic.collapse_bvh2_to_bvh4_analytic(jb))
    bvh = convert.to_torch(Bvh2, jb, device="cpu")
    got = collapse_analytic.collapse_bvh2_to_bvh4_analytic(bvh)
    assert all(same(getattr(got, f), getattr(want, f)) for f in Bvh4._fields)
    oracle = collapse_cpu(bvh)
    k = oracle["n_nodes"]
    assert int(got.n_nodes) == k
    for f in ("child", "parent", "child_count"):
        assert same(getattr(got, f)[:k], oracle[f][:k]), f
    for f in ("leaf_prim", "leaf_parent"):
        assert same(getattr(got, f), oracle[f]), f
    slots = oracle["child"][:k] >= 0
    for f in ("child_min", "child_max"):
        assert getattr(got, f)[:k].numpy()[slots].tobytes() == oracle[f][:k][slots].tobytes()
    assert validate.check_bvh4_correctness(got, len(tris))
