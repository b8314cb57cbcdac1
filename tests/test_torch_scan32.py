"""Kernel 1 (topology scan): the port's plain version equals the Pallas
kernel (interpret mode) and the stack oracle bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops import radix_tree as jradix
from tpu_bvh.ops.pallas import scan32 as jscan32
from tpu_bvh.ops.pallas import threshold_core as jthreshold
from tpu_bvh_torch.ops import radix_tree, scan32, threshold_core


def _codes(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        c = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    elif kind == "dups":
        c = rng.integers(0, 64, size=n, dtype=np.uint32) * 1024
    elif kind == "all_equal":
        c = np.full(n, 12345, np.uint32)
    elif kind == "sorted_line":
        c = np.arange(n, dtype=np.uint32) * 7
    else:
        raise ValueError(kind)
    return np.sort(c)


KINDS = ["random", "dups", "all_equal", "sorted_line"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [97, 4096, 4097, 9000])
def test_plain_scan_matches_pallas_and_oracle(kind, n):
    codes = _codes(kind, n)
    dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
    got_dlt = radix_tree.adjacent_deltas(torch.from_numpy(codes.astype(np.int64)))
    np.testing.assert_array_equal(got_dlt.numpy(), dlt_raw)
    got = [g.numpy() for g in scan32.scan_core(torch.from_numpy(dlt_raw))]
    pallas = [np.asarray(x) for x in jscan32.scan_core(jnp.asarray(dlt_raw), interpret=True)]
    oracle = jscan32.scan_core_reference(dlt_raw)
    for name, g, p, o in zip(["psv_pos", "psv_val", "lc", "nsv_pos", "nsv_val", "rc"],
                             got, pallas, oracle):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, o, err_msg=name)


def test_scan_dispatch_raises_on_other_devices():
    with pytest.raises(ValueError):
        scan32.scan_core(torch.zeros(4, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("kind", KINDS)
def test_threshold_reference_forms_match_jax(kind):
    """The port's plain threshold scans equal JAX's `*_reference` forms."""
    codes = _codes(kind, 4097, seed=1)
    dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
    dlt = np.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11).astype(np.int32)
    want = list(jthreshold.psv_nsv_packed_reference(jnp.asarray(dlt)))
    want += list(jthreshold.child_positions_reference(jnp.asarray(dlt)))
    got = list(threshold_core.psv_nsv_packed_reference(torch.from_numpy(dlt)))
    got += list(threshold_core.child_positions_reference(torch.from_numpy(dlt)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [97, 4097])
def test_scan_halves_match_pallas(kind, n):
    """B16: `scan_fwd` / `scan_rev` equal `scan32._run` with `_fwd_kernel` on
    the V=32 deltas and `_rev_kernel` on their flip (interpret mode)."""
    codes = _codes(kind, n, seed=2)
    dlt_raw = np.array(jradix.adjacent_deltas(jnp.asarray(codes)))
    dlt32 = np.where(dlt_raw <= 31, dlt_raw - 2, 30).astype(np.int32)
    m = dlt32.shape[0]
    t32 = torch.from_numpy(dlt32)
    assert torch.equal(scan32.dlt32_from_raw(torch.from_numpy(dlt_raw)), t32)
    assert torch.equal(scan32.raw_from_dlt32(t32), torch.from_numpy(dlt_raw))
    fwd = jscan32._run(jscan32._fwd_kernel, jnp.asarray(dlt32), True)
    rev = jscan32._run(jscan32._rev_kernel, jnp.asarray(dlt32[::-1].copy()), True, m=m)
    for got, want in ((scan32.scan_fwd(t32), fwd),
                      (scan32.scan_rev(torch.flip(t32, [0]), m), rev)):
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
