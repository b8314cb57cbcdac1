"""The port's PLOC++ and HPLOC builders against JAX: packed_t, left, right
and root are bit-identical; the validity checks pass; the finisher's
hand-over point does not change the tree; the SAH relations of
test_ploc.py hold."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tpu_bvh.models import ploc as jploc
from tpu_bvh.ops import ploc as jploc_ops
from tpu_bvh.utils import scenes as jscenes
from tpu_bvh_torch.models import lbvh, ploc
from tpu_bvh_torch.ops import ploc as ploc_ops
from tpu_bvh_torch.ops import ploc_round
from tpu_bvh_torch.utils import validate
from tpu_bvh_torch.utils.cost import sah_cost_bvh2

BUILDERS = {"ploc": (ploc.build_ploc, jploc.build_ploc),
            "hploc": (ploc.build_hploc, jploc.build_hploc)}


def assert_same_bvh(got, want):
    for field in ("packed_t", "left", "right", "root"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


def check_valid(bvh, n):
    assert validate.check_bvh2_correctness(bvh, n)
    assert validate.check_root_aabb(bvh)
    assert validate.check_parent_child_consistency(bvh)


def soup(name):
    if name == "cornellbox":
        return jscenes.cornellbox()
    if name == "dup33":  # all-equal codes and areas
        return np.repeat(random_tris(np.random.default_rng(7), 1), 33, axis=0)
    return random_tris(np.random.default_rng(int(name)), int(name))


@pytest.mark.parametrize("scene", ["cornellbox", "1", "2", "3", "9", "64", "700", "3000", "dup33"])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_bit_identical(name, scene):
    tris = soup(scene)
    port, jax_build = BUILDERS[name]
    got = port(torch.from_numpy(tris))
    assert_same_bvh(got, jax_build(jnp.asarray(tris)))
    check_valid(got, tris.shape[0])


@pytest.mark.parametrize("name", list(BUILDERS))
def test_sponza_like_bit_identical(name, monkeypatch):
    """sponza_like(8192) with the finisher width at 4096: more than that, so
    the round loop runs rounds before it hands over. JAX runs op by op
    here: inside a jitted loop XLA:CPU contracts the area's multiply-adds
    into FMAs, which rounds some areas differently from the written order
    that the TPU kernel and the port follow, and on this scene's many
    near-equal areas that picks other neighbours from the second round on."""
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", 4096)
    tris = jscenes.sponza_like(8192)
    port, jax_build = BUILDERS[name]
    got = port(torch.from_numpy(tris))
    assert ploc_ops.last_build["rounds"] > 0 and ploc_ops.last_build["finish"] == 1
    with jax.disable_jit():
        want = jax_build(jnp.asarray(tris))
    assert_same_bvh(got, want)
    check_valid(got, tris.shape[0])


@pytest.mark.parametrize("name", list(BUILDERS))
def test_hand_over_takes_the_whole_soup(name, monkeypatch):
    """FIN_WIDTH >= n, as on the TPU for scenes of at most 16,384 tris (the
    JAX driver hands over at min(16384, n)): no round runs before the
    finisher, and the tree is JAX's (op by op, as above)."""
    tris = jscenes.sponza_like(2048)
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", max(ploc_round.FIN_WIDTH, tris.shape[0]))
    port, jax_build = BUILDERS[name]
    got = port(torch.from_numpy(tris))
    assert ploc_ops.last_build["rounds"] == 0 and ploc_ops.last_build["finish"] == 1
    with jax.disable_jit():
        want = jax_build(jnp.asarray(tris))
    assert_same_bvh(got, want)
    check_valid(got, tris.shape[0])


def test_hploc_schedule_3_3():
    """`_build` keeps shift0 / shift_step (tools/profile_hploc_schedule.py)."""
    tris = random_tris(np.random.default_rng(11), 700)
    got = ploc._build(torch.from_numpy(tris), True, hploc=True, shift0=3, shift_step=3)
    want = jploc._build(jnp.asarray(tris), True, hploc=True, shift0=3, shift_step=3)
    assert_same_bvh(got, want)
    assert not torch.equal(got.left, ploc.build_hploc(torch.from_numpy(tris)).left)


@pytest.mark.parametrize("hploc", [False, True])
def test_topology_row_major(hploc):
    """The row-major wrapper on sorted leaves (the form the JAX app calls)."""
    tris = random_tris(np.random.default_rng(12), 500)
    codes, packed_t, _ = lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), True)
    leaf_min, leaf_max = packed_t[0:3].T, -packed_t[3:6].T
    got = ploc_ops.ploc_build_topology(leaf_min, leaf_max, codes, hploc=hploc)
    want = jploc_ops.ploc_build_topology(
        jnp.asarray(leaf_min.numpy()), jnp.asarray(leaf_max.numpy()),
        jnp.asarray(codes.numpy().astype(np.uint32)), hploc=hploc)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


@pytest.mark.parametrize("fin", [2, 64, 700])
def test_hand_over_point_keeps_the_tree(monkeypatch, fin):
    """The round loop runs rounds above `FIN_WIDTH` and the finisher below it,
    as on the card; wherever the hand-over falls the tree is the same, and
    equal to the plain round loop's."""
    tris = torch.from_numpy(random_tris(np.random.default_rng(13), 3000))
    want = {name: build(tris) for name, (build, _) in BUILDERS.items()}
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", fin)
    for name, (build, _) in BUILDERS.items():
        got = build(tris)
        assert ploc_ops.last_build["rounds"] > 0
        assert all(torch.equal(g, w) for g, w in zip(got, want[name])), name
    codes, packed_t, _ = lbvh._sorted_leaves_from_tris(tris, True)
    ref = ploc_ops.ploc_build_topology_packed_reference(packed_t, codes, hploc=True, shift0=9,
                                                        shift_step=6)
    assert torch.equal(ref[0], want["hploc"].left[:2999])


def test_sah_against_two_pass():
    """test_ploc.py's relation on its scene: PLOC within 5% of the two-pass
    LBVH's SAH (better, in fact), HPLOC within 10%."""
    tris = torch.from_numpy(random_tris(np.random.default_rng(1234), 3000, spread=15.0,
                                        size=0.4))
    c_lbvh = float(sah_cost_bvh2(lbvh.build_two_pass(tris)))
    assert float(sah_cost_bvh2(ploc.build_ploc(tris))) <= c_lbvh * 1.05
    assert float(sah_cost_bvh2(ploc.build_hploc(tris))) <= c_lbvh * 1.1
