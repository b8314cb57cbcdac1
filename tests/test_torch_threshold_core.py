"""The threshold scans (B12/B13, B14, B15): the port's plain versions equal
the Pallas kernels (interpret mode) and JAX's `*_reference` forms bit for
bit, and the size limits are refused before any work."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops.pallas import threshold_core as jtc
from tpu_bvh_torch.ops import threshold_core


def _deltas(m, seed, hi=53):
    return np.random.default_rng(seed).integers(0, hi, size=m).astype(np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [512, 513, 1024, 2000, "all_equal"])
def test_psv_nsv_matches_both_pallas_layouts(m):
    """B12 (sublane layout) and B13 (lane layout) against one port function."""
    dlt = np.zeros(700, np.int32) if m == "all_equal" else _deltas(m, m)
    got = threshold_core.psv_nsv_packed(torch.from_numpy(dlt))
    _same(got, jtc.psv_nsv_packed(jnp.asarray(dlt), interpret=True))
    _same(got, jtc.psv_nsv_packed_lanes(jnp.asarray(dlt), interpret=True))
    _same(threshold_core.psv_nsv_packed_auto(torch.from_numpy(dlt)), got)
    _same(threshold_core.psv_nsv_packed_lanes(torch.from_numpy(dlt)), got)


def test_payload_matches_pallas():
    """B14 against `_run_lanes_pay` in interpret mode and the JAX oracle."""
    rng = np.random.default_rng(42)
    m = 5000
    dlt = rng.integers(0, 53, m).astype(np.int32)
    pay = rng.integers(0, 2**22, m).astype(np.int32)
    got = threshold_core.psv_nsv_payload_auto(torch.from_numpy(dlt), torch.from_numpy(pay))
    psv, pp = jtc._run_lanes_pay(jtc._psv_kernel_lanes_pay, jnp.asarray(dlt), jnp.asarray(pay),
                                 False, 63, True, 1024)
    nsv, np_ = jtc._run_lanes_pay(jtc._nsv_kernel_lanes_pay, jnp.asarray(dlt), jnp.asarray(pay),
                                  True, 63, True, 1024)
    _same(got, [psv, pp, nsv, np_])
    _same(got, jtc.psv_nsv_payload_reference(jnp.asarray(dlt), jnp.asarray(pay)))


@pytest.mark.parametrize("m", [700, 2048, 3333])
def test_child_positions_match_jax_on_repeated_deltas(m):
    """B15's plain version against JAX's on deltas that repeat values,
    where windows reset at d <= v (the strict-psv form differed here)."""
    dlt = _deltas(m, 7)
    got = threshold_core.child_positions_auto(torch.from_numpy(dlt))
    _same(got, jax.jit(jtc.child_positions_reference)(jnp.asarray(dlt)))
    _same(threshold_core.child_positions_reference(torch.from_numpy(dlt)), got)


def test_child_positions_match_pallas():
    """B15 against the Pallas child kernels (interpret mode), m = 700."""
    dlt = np.random.default_rng(7).integers(0, 53, 700).astype(np.int32)
    mask = (1 << jtc._POSB) - 1
    want = []
    for kernel, reverse in ((jtc._child_kernel_lanes_fwd, False),
                            (jtc._child_kernel_lanes_rev, True)):
        pk = jtc._run_child(kernel, jnp.asarray(dlt), reverse, True, 512)
        want.append(jnp.where(pk == jtc._BIG, -1, pk & mask))
    _same(threshold_core.child_positions_auto(torch.from_numpy(dlt)), want)


@pytest.mark.parametrize("fn,limit", [
    (threshold_core.psv_nsv_packed, threshold_core.MAX_M),
    (lambda d: threshold_core.psv_nsv_payload_auto(d, d), threshold_core.MAX_M),
    (threshold_core.child_positions_auto, threshold_core.MAX_M_CHILD),
])
def test_size_limits_refused(fn, limit):
    """64 * pos must fit an i32 (m < 2^25), B15's position field 22 bits."""
    assert threshold_core.MAX_M == 1 << 25 and threshold_core.MAX_M_CHILD == 1 << 22
    big = torch.zeros(1, dtype=torch.int32).expand(limit)  # no memory behind it
    with pytest.raises(ValueError, match=f"m < {limit}"):
        fn(big)
