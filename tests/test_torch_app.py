"""The port's app (`python -m tpu_bvh_torch.app --cpu`) against JAX's
(`python -m tpu_bvh.app --cpu`) on the cornellbox at 32 x 32.

For every builder with `raster` and `speculative`, and the other three
variants once, both apps run with `--heatmap`; the SAH lines they print
must be equal, `sah_bvh4` equal within 1e-6 relative (XLA and torch sum
the BVH4's areas in other orders), and the image and heat-map arrays
(captured at `image.write_png` in both packages) equal.

JAX's app jits its ray generation, and XLA contracts it into FMAs: at
32 x 32, 981 of the 3,072 direction words differ by an ulp from JAX's
eager rays, which the port's equal bit for bit. The rendered pixels do
not move (checked on the unpatched JAX app), but a ray's leaf-visit
count can, so the comparisons hand JAX's app its eager rays.

Also: the batched demo (both apps refuse the 36-triangle procedural box;
both build the same first tree from a 32-triangle OBJ), `parse_args`
against JAX's, the refusal to run on a missing card, and the app and
`e2e_drive` importing and running with jax blocked.
"""
import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_bvh import app as japp
from tpu_bvh import config as jconfig
from tpu_bvh.utils import camera as jcamera
from tpu_bvh.utils import image as jimage
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh.utils import validate as jvalidate
from tpu_bvh_torch import app, config
from tpu_bvh_torch.types import Bvh2
from tpu_bvh_torch.utils import image, validate

SIZE = 32
CASES = [(b, t) for b in ("two_pass", "single_pass", "ploc", "hploc", "binned_sah")
         for t in ("raster", "speculative")]
CASES += [("two_pass", "if_if"), ("single_pass", "while_while"), ("ploc", "restart_trail")]


def _run(pkg, argv, monkeypatch, eager_rays=True):
    """Run one app; returns (its Cost lines, {path: image array}, result)."""
    imgs = {}
    img_mod = jimage if pkg == "jax" else image
    monkeypatch.setattr(img_mod, "write_png",
                        lambda path, rgba, *a, **k: imgs.__setitem__(os.path.basename(path),
                                                                     np.array(rgba)))
    if pkg == "jax" and eager_rays:  # the app jits a closure over the camera
        make = jcamera.generate_rays

        def eager(cam, w, h, **k):
            with jax.ensure_compile_time_eval():
                return make(cam, w, h, **k)

        monkeypatch.setattr(jcamera, "generate_rays", eager)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            if pkg == "jax":
                res = japp.run(jconfig.parse_args(argv))
            else:
                res = app.run(config.parse_args(argv))
    finally:
        monkeypatch.undo()
    return [ln for ln in out.getvalue().splitlines() if "Cost" in ln], imgs, res


def _argv(builder, traversal, extra=()):
    return ["--cpu", "--builder", builder, "--traversal", traversal, "--width", str(SIZE),
            "--height", str(SIZE), "--heatmap", *extra]


@pytest.fixture(scope="module")
def runs():
    """Both apps' outputs per case, run once for the module's tests."""
    mp = pytest.MonkeyPatch()
    out = {}
    for case in CASES:
        out[case] = (_run("jax", _argv(*case), mp), _run("port", _argv(*case), mp))
    return out


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_app_prints_jax_sah_lines(runs, case):
    (jlines, _, jres), (lines, _, res) = runs[case]
    assert lines == jlines and len(lines) == (1 if case[0] == "binned_sah" else 2)
    if case[0] == "binned_sah":
        assert "sah_bvh4" not in res and "sah_bvh4" not in jres
    else:
        assert res["sah_bvh4"] == pytest.approx(jres["sah_bvh4"], rel=1e-6)
    assert res["device_ms"] == {} and res["total_ms"] >= 0.0
    assert validate.check_bvh2_correctness(res["bvh"], 36)


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
def test_app_writes_jax_pixels(runs, case):
    (_, jimgs, _), (_, imgs, res) = runs[case]
    assert sorted(imgs) == sorted(jimgs) == ["colorMap.png", "test.png"]
    for name in imgs:
        assert imgs[name].shape == (SIZE, SIZE, 4) and np.array_equal(imgs[name], jimgs[name])
    assert (imgs["test.png"][..., 3] == 255).any()  # something was hit


@pytest.mark.parametrize("traversal", ["raster", "speculative"])
def test_app_image_equals_the_unpatched_jax_app(monkeypatch, traversal):
    argv = _argv("two_pass", traversal)
    _, jimgs, _ = _run("jax", argv, monkeypatch, eager_rays=False)
    _, imgs, _ = _run("port", argv, monkeypatch)
    assert np.array_equal(imgs["test.png"], jimgs["test.png"])


def test_batched_demo_refuses_the_36_triangle_box(monkeypatch):
    assert jscenes.cornellbox().shape[0] == 36  # the procedural box
    argv = _argv("batched", "speculative")
    with pytest.raises(AssertionError):
        _run("jax", argv, monkeypatch)
    with pytest.raises(ValueError, match="<= 32"):
        _run("port", argv, monkeypatch)


def test_batched_demo_builds_jax_first_tree(tmp_path, monkeypatch):
    tris = jscenes.cornellbox()[:32]
    path = tmp_path / "box32.obj"
    with open(path, "w") as f:
        for v in tris.reshape(-1, 3):
            f.write("v %.9g %.9g %.9g\n" % tuple(v))
        for k in range(len(tris)):
            f.write(f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}\n")
    firsts = []
    check = jvalidate.check_bvh2_correctness
    monkeypatch.setattr(jvalidate, "check_bvh2_correctness",
                        lambda bvh, n: firsts.append(bvh) or check(bvh, n))
    argv = _argv("batched", "speculative", ("--scene", str(path)))
    _, _, jres = _run("jax", argv, monkeypatch)
    _, _, res = _run("port", argv, monkeypatch)
    (want,) = firsts
    got = res["bvh"]
    for f in Bvh2._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes(), f
    assert got.n_leaves == 32 and "total_ms" in res and "total_ms" in jres


@pytest.mark.parametrize("argv", [
    [],
    ["--cpu", "--builder", "hploc", "--traversal", "raster", "--scene", "sponza_like"],
    ["--builder", "binned_sah", "--width", "64", "--height", "48", "--plain-morton",
     "--split-clip", "2.5", "--no-collapse", "--heatmap", "--out", "x.png"],
])
def test_parse_args_matches_jax(argv):
    got = config.parse_args(argv)
    want = jconfig.parse_args(argv)
    fields = dict(vars(got))
    assert fields.pop("device") == ("cpu" if "--cpu" in argv else "cuda")
    assert fields == vars(want)
    assert config.BUILDERS == jconfig.BUILDERS and config.SCENES == jconfig.SCENES
    assert config.TRAVERSAL_VARIANTS == jconfig.TRAVERSAL_VARIANTS
    with pytest.raises(SystemExit):
        config.parse_args(["--builder", "nope"])


def test_app_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--cpu"):
        app.main(["--width", "16", "--height", "16"])


BLOCK_JAX = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tpu_bvh"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from tpu_bvh_torch import app, e2e_drive
res = app.main(["--cpu", "--builder", "hploc", "--traversal", "raster", "--width", "16",
                "--height", "16", "--heatmap", "--out", sys.argv[2] + "/t.png"])
assert "sah_bvh4" in res
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_bvh")]
print("ok")
"""


def test_app_and_e2e_drive_run_without_jax(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", BLOCK_JAX, root, str(tmp_path)], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok") and (tmp_path / "t.png").exists()
