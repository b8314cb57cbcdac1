"""The slice as a whole: scene -> build -> pack_raster -> render, the port
(its own scenes, presets, rays and build) against JAX (`build_single_pass`,
then the Pallas raster in interpret mode), under the raster rules of
test_torch_raster.py. Also: a JAX-built tree carried across by `convert`
renders the same in the port, and the port never imports jax."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_raster import assert_render_close
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import raster as jraster
from tpu_bvh.ops import raster_tpu
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import raster, raster_gpu
from tpu_bvh_torch.types import Bvh2
from tpu_bvh_torch.utils import camera, convert, scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICES = {
    # scene, preset, leaf, (cand_cap, pair_cap, group)
    "cornellbox_128": (lambda m: m.cornellbox(), "cornellbox", 16, (64, 512, 4)),
    "sponza_like_16k_128": (lambda m: m.sponza_like(16_384), "sponza", 64, (1024, 4096, 32)),
}
W = H = 128


def port_slice(tris_np, preset, leaf, caps, bvh=None):
    tris = torch.from_numpy(tris_np)
    if bvh is None:
        bvh = lbvh.build_single_pass(tris)
    tr, cam = scenes.preset(preset, device="cpu")
    rays = camera.generate_rays(cam, W, H)
    packed = raster.pack_raster(bvh, tris, leaf_size=leaf)
    return raster_gpu.render_raster_gpu(packed, rays, tr, W, H, *caps)


@pytest.mark.parametrize("case", list(SLICES))
def test_slice_matches_jax(case):
    make, preset, leaf, caps = SLICES[case]
    tris_np = make(scenes)
    assert tris_np.tobytes() == make(jscenes).tobytes()
    got = port_slice(tris_np, preset, leaf, caps)

    tris = jnp.asarray(tris_np)
    tr, cam = jscenes.preset(preset)
    rays = jcamera.generate_rays(cam, W, H)
    packed = jraster.pack_raster(jlbvh.build_single_pass(tris), tris, leaf_size=leaf)
    want = raster_tpu.render_raster_tpu(packed, rays, tr, W, H, *caps, interpret=True)
    assert_render_close(got, want)


def test_jax_tree_renders_same_in_port():
    make, preset, leaf, caps = SLICES["cornellbox_128"]
    tris_np = make(scenes)
    jbvh = jlbvh.build_single_pass(jnp.asarray(tris_np))
    carried = convert.to_torch(Bvh2, {f: np.asarray(v) for f, v in jbvh._asdict().items()},
                               device="cpu")
    back = convert.to_numpy(carried)
    for f, v in jbvh._asdict().items():
        assert back[f].tobytes() == np.asarray(v).tobytes()
    got = port_slice(tris_np, preset, leaf, caps, bvh=carried)
    want = port_slice(tris_np, preset, leaf, caps)
    for g, w in zip(list(got[0]) + [got[1]], list(want[0]) + [want[1]]):
        assert torch.equal(g, w)


def test_port_imports_no_jax():
    """In a fresh interpreter: every module of the port (the multi-device
    modules of `tpu_bvh_torch.parallel` among them), and every import
    statement of chip_smoke.py, pulls in neither jax nor tpu_bvh."""
    code = (
        "import ast, pkgutil, importlib, sys\n"
        "import tpu_bvh_torch\n"
        "for m in pkgutil.walk_packages(tpu_bvh_torch.__path__, 'tpu_bvh_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for node in ast.walk(ast.parse(open('chip_smoke.py').read())):\n"
        "    if isinstance(node, ast.ImportFrom):\n"
        "        importlib.import_module(node.module)\n"
        "    elif isinstance(node, ast.Import):\n"
        "        for a in node.names: importlib.import_module(a.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tpu_bvh' or m.startswith('tpu_bvh.')]\n"
        "assert not bad, bad\n"
        "assert 'tpu_bvh_torch.ops.collapse_fast' in sys.modules\n"
        "assert 'tpu_bvh_torch.ops.ray_sweep' in sys.modules\n"
        "assert 'tpu_bvh_torch.ops.ploc_round' in sys.modules\n"
        "assert 'tpu_bvh_torch.models.ploc' in sys.modules\n"
        "for m in ('comm', 'sharded', 'sharded_build', 'dryrun'):\n"
        "    assert 'tpu_bvh_torch.parallel.' + m in sys.modules, m\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
