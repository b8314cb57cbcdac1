"""B11 plane scan: the port's plain version equals the Pallas kernel
(interpret mode) and lax's cumulative ops bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops.pallas import plane_scan as jps
from tpu_bvh_torch.ops import plane_scan


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("reverse", [True, False])
def test_plane_scan_matches_pallas(is_min, reverse):
    m = 1500
    rng = np.random.default_rng(m + is_min * 10 + reverse)
    x = rng.integers(-(2**30), 2**30, size=(m, 64), dtype=np.int32)
    got = plane_scan.plane_scan(torch.from_numpy(x), is_min=is_min, reverse=reverse)
    assert got.dtype == torch.int32 and got.shape == (m, 64)
    want = jps.plane_scan(jnp.asarray(x), is_min=is_min, reverse=reverse, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lax = jps.plane_scan_reference(jnp.asarray(x), is_min=is_min, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lax))
    auto = plane_scan.plane_scan_auto(torch.from_numpy(x), is_min=is_min, reverse=reverse)
    assert torch.equal(auto, got)


@pytest.mark.parametrize("m,v", [(1, 64), (2, 3), (257, 5), (64, 130)])
def test_plane_scan_odd_shapes_match_cummin(m, v):
    """Single rows and widths other than 64, against torch's own cumulative ops."""
    x = torch.from_numpy(np.random.default_rng(m * v).integers(-9, 9, size=(m, v), dtype=np.int32))
    for is_min, fn in ((True, torch.cummin), (False, torch.cummax)):
        assert torch.equal(plane_scan.plane_scan(x, is_min=is_min, reverse=False),
                           fn(x, dim=0).values)
        assert torch.equal(plane_scan.plane_scan(x, is_min=is_min, reverse=True),
                           torch.flip(fn(torch.flip(x, [0]), dim=0).values, [0]))
