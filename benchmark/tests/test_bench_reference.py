"""The plain reference against hand-checked scenes, and against the program's
plain CPU paths on small seeded scenes (run: python -m pytest benchmark/tests -q)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import camera, scene  # noqa: E402
from benchmark.reference import build as rb  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference import traverse as rt  # noqa: E402

F32 = torch.float32
PLOC = {"radius": 8}  # the ploc_4m configuration's radius
BUILD = {"lbvh": rb.build_lbvh, "ploc": rb.build_ploc}


def _tri_box(lo, hi):
    """A triangle whose box is [lo, hi]."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    return [[x0, y0, z0], [x1, y1, z0], [x1, y1, z1]]


def test_bench_leaf_boxes_order_signed_zeros():
    tris = torch.tensor([[[0.0, -0.0, 1.0], [-0.0, 0.0, 2.0], [0.5, 0.0, -0.0]]])
    packed = rb.leaf_boxes(tris)
    bits = packed.view(torch.int32)[:, 0].tolist()
    neg0 = torch.tensor(-0.0).view(torch.int32).item()
    assert bits[0] == neg0 and bits[1] == neg0  # min(+0, -0) is -0
    assert packed[2, 0] == -0.0 and packed[2, 0].view(torch.int32) == neg0  # min z is -0
    assert packed[3:6, 0].tolist() == [-0.5, -0.0, -2.0]
    assert packed[4, 0].view(torch.int32) == neg0  # -(max(+0, -0)) = -(+0)


def test_bench_lbvh_two_triangles():
    tris = torch.tensor([_tri_box((0, 0, 0), (1, 1, 1)), _tri_box((5, 0, 0), (6, 1, 1))], dtype=F32)
    packed, left, right, root = rb.build_lbvh(tris, {})
    assert int(root) == 0
    assert left.tolist() == [1, 0, 1] and right.tolist() == [2, -1, -1]
    assert packed[:, 0].tolist() == [0, 0, 0, -6, -1, -1]


def test_bench_lbvh_four_in_a_row():
    """Four boxes along x: codes rise with x, the root splits 2 + 2 at
    boundary 1, its children are boundaries 0 and 2."""
    tris = torch.tensor([_tri_box((x, 0, 0), (x + 1, 1, 1)) for x in (0, 10, 20, 30)], dtype=F32)
    packed, left, right, root = rb.build_lbvh(tris, {})
    assert int(root) == 1
    assert left[:3].tolist() == [3, 0, 5] and right[:3].tolist() == [4, 2, 6]
    assert left[3:].tolist() == [0, 1, 2, 3]
    assert packed[:, 1].tolist() == [0, 0, 0, -31, -1, -1]


def test_bench_ploc_three_boxes():
    """A and B touch, C lies far: round 1 merges A and B (node id 0), round 2
    merges that with C (id 1); flipped, the root 0 is (AB, C) and node 1 is
    (A, B). Leaves are ids 2, 3, 4 in sorted order."""
    tris = torch.tensor([_tri_box((0, 0, 0), (1, 1, 1)), _tri_box((1.1, 0, 0), (2, 1, 1)),
                         _tri_box((10, 0, 0), (11, 1, 1))], dtype=F32)
    packed, left, right, root = rb.build_ploc(tris, PLOC)
    assert int(root) == 0
    assert left.tolist() == [1, 2, 0, 1, 2] and right.tolist() == [4, 3, -1, -1, -1]
    assert packed[:, 0].tolist() == [0, 0, 0, -11, -1, -1]
    assert packed[:, 1].tolist() == [0, 0, 0, -2, -1, -1]


def test_bench_hits_one_triangle():
    tri = torch.tensor([[[-1.0, -1.0, 5.0], [1.0, -1.0, 5.0], [0.0, 1.0, 5.0]]])
    tree = (rb.leaf_boxes(tri), torch.tensor([0], dtype=torch.int32),  # a one-leaf tree
            torch.tensor([-1], dtype=torch.int32), torch.tensor(0, dtype=torch.int32))
    origin = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    direction = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    prim, t, u, v = rt.closest_hits(tree, tri, origin, direction)
    assert prim.tolist() == [0, -1]
    assert t[0].item() == 5.0 and t[1].item() == torch.finfo(F32).max
    assert u[0].item() == pytest.approx(0.25) and v[0].item() == pytest.approx(0.5)


def test_bench_hits_take_the_closest():
    near = [[-1.0, -1.0, 2.0], [1.0, -1.0, 2.0], [0.0, 1.0, 2.0]]
    far = [[-1.0, -1.0, 7.0], [1.0, -1.0, 7.0], [0.0, 1.0, 7.0]]
    tris = torch.tensor([far, near, far])
    tree = rb.build_lbvh(tris, {})
    prim, t, _, _ = rt.closest_hits(tree, tris, torch.zeros(1, 3), torch.tensor([[0.0, 0, 1]]))
    assert prim.tolist() == [1] and t.tolist() == [2.0]


@pytest.mark.parametrize("builder", ["lbvh", "ploc"])
@pytest.mark.parametrize("scale", [(1, 1, 1), (1, 5, 0.1), (0.01, 3, 40)])
def test_bench_reference_equals_port_plain_build(builder, scale):
    from tpu_bvh_torch.models import lbvh, ploc

    tris = scene.Scene(2500, 262_000, 2, 1.0, 11, "cpu").frames[1] * torch.tensor(scale)
    got = (lbvh.build_single_pass if builder == "lbvh" else ploc.build_ploc)(tris)
    want = BUILD[builder](tris, PLOC)
    assert compare.trees(got, want) == {"order_differs": 0, "links_differ": 0, "boxes_differ": 0}


def test_bench_reference_equals_port_plain_hits():
    from tpu_bvh_torch.models import lbvh
    from tpu_bvh_torch.ops import traverse
    from tpu_bvh_torch.types import Rays, identity_transform

    tris = scene.Scene(2500, 262_000, 1, 0.0, 3, "cpu").frames[0]
    bvh = lbvh.build_single_pass(tris)
    fr = camera.Frames(1, 24, 16, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 3, "cpu")
    o, d = fr.origin[0], fr.direction[0]
    n = o.shape[0]
    hit, _ = traverse.traverse_packed(traverse.pack_bvh2(bvh, tris), bvh.n_internal, bvh.root,
                                      Rays(o, d, torch.zeros(n), torch.full((n,), 3e38)),
                                      identity_transform("cpu"))
    want = rt.closest_hits(rb.build_lbvh(tris, {}), tris, o, d)
    assert compare.hits((hit.prim_idx, hit.t, hit.u, hit.v), want) == {
        "prims_differ": 0, "t_gap": 0.0, "uv_gap": 0.0}
    assert (want[0] >= 0).float().mean() > 0.9  # an interior: nearly every ray hits


@pytest.mark.parametrize("builder", ["lbvh", "ploc"])
def test_bench_control_build_differs(builder):
    tris = scene.Scene(2500, 262_000, 1, 0.0, 5, "cpu").frames[0]
    got = compare.trees(BUILD[builder](tris, PLOC, torch.bfloat16), BUILD[builder](tris, PLOC))
    assert got["order_differs"] > 0 and got["boxes_differ"] > 0


def test_bench_control_hits_differ():
    tris = scene.Scene(2500, 262_000, 1, 0.0, 5, "cpu").frames[0]
    fr = camera.Frames(1, 24, 16, 60.0, (1.6, 8.0), (-0.35, 0.15), 1, 5, "cpu")
    tree = rb.build_lbvh(tris, {})
    o, d = fr.origin[0], fr.direction[0]
    got = compare.hits(rt.closest_hits(tree, tris, o, d, torch.bfloat16),
                       rt.closest_hits(tree, tris, o, d))
    assert got["t_gap"] > 1e-4
