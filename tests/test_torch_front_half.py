"""The front half's plain route on the CPU (`ops/front_half.py`): the
extended code's bit budget (`morton.bit_budget`, which the CUDA kernel's
arguments come from too) on scenes that take each of its paths and on
extent ratios at powers of two, against JAX's codes and sorted leaves;
the triangle route against the PrimRefs route; and the launch counter,
which stays at 0 on the CPU. The kernels against this route on the card:
`test_torch_cuda.py`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from front_half_scenes import PATHS, SMALL
from tpu_bvh.models import lbvh as jlbvh
from tpu_bvh.ops import morton as jmorton
from tpu_bvh_torch.models import lbvh, ploc
from tpu_bvh_torch.ops import front_half, morton
from tpu_bvh_torch.utils import kernels

FRONT_KERNELS = ("front_tri_box", "front_keys", "front_gather")


def _budget(tris):
    return morton.bit_budget(front_half.tri_rows_reference(torch.from_numpy(tris))[2])


def test_each_path_of_the_budget_is_taken():
    flat, swap, cap = (_budget(PATHS[k]()) for k in ("flat", "swap", "cap"))
    assert flat.bits_z == 0 and flat.prebits_sum == 0
    assert swap.use_swap and swap.prebits_sum > 0
    assert cap.pre_x + 2 * cap.pre_y == 30 and cap.bits_z == 0


@pytest.mark.parametrize("name", list(SMALL))
def test_budget_codes_equal_jax(name):
    """The codes of the budget, on the normalized centroids, equal JAX's
    `extended_morton30_cols`, which decides the budget inline."""
    tris = torch.from_numpy(SMALL[name]())
    rows, scene_min, ext = front_half.tri_rows_reference(tris)
    mn, mx = rows[0:3], -rows[3:6]
    p = ((mn + mx) * 0.5 - scene_min[:, None]) / torch.where(ext > 0, ext, 1.0)[:, None]
    got = morton.extended_morton30_cols(p[0], p[1], p[2], ext)
    want = jmorton.extended_morton30_cols(*(jnp.asarray(p[k].numpy()) for k in range(3)),
                                          jnp.asarray(ext.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("extended", [True, False])
def test_sorted_leaves_equal_jax(name, extended):
    tris = SMALL[name]()
    want = [np.asarray(x) for x in jlbvh._sorted_leaves_from_tris(jnp.asarray(tris), extended)]
    got = [x.numpy() for x in lbvh._sorted_leaves_from_tris(torch.from_numpy(tris), extended)]
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    assert got[1].tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("name", ["signed_zeros", "swap", "cap"])
def test_triangle_route_equals_the_refs_route(name):
    """PLOC's front half takes the triangles; the PrimRefs route it took
    before gives the same bits."""
    tris = torch.from_numpy(SMALL[name]())
    refs = lbvh.prim_refs_from_triangles(tris)
    got = lbvh._sorted_leaves_from_tris(tris, True)
    for g, w in zip(got, lbvh._sorted_leaves_packed(refs, True)):
        assert g.numpy().tobytes() == w.numpy().tobytes()


def test_no_launch_on_the_cpu():
    tris = torch.from_numpy(SMALL["swap"]())
    before = {k: kernels.launches[k] for k in FRONT_KERNELS}
    front_half.last_build["launches"] = -1
    lbvh.build_single_pass(tris)
    assert front_half.last_build == {"launches": 0}
    ploc.build_ploc(tris[:256])
    assert ({k: kernels.launches[k] for k in FRONT_KERNELS} == before
            and front_half.last_build == {"launches": 0})
