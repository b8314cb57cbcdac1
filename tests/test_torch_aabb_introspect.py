"""The port's aabb helpers, `types.INVALID_IDX` and `introspect.cost_analysis`
against JAX on the CPU, and the launch recorder's rules.

The helpers take seeded numpy inputs with +-0.0, NaN and zero-extent axes
and are compared by their bits, `qt_rotation` to 1 ulp (rtol 1e-6: sin and
cos may differ by an ulp between XLA and torch). `cost_analysis` of a
single op equals XLA's flops and bytes accessed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh import types as jtypes
from tpu_bvh.ops import aabb as jaabb
from tpu_bvh.utils import introspect as jintrospect
from tpu_bvh_torch import types
from tpu_bvh_torch.ops import aabb, ploc_nn
from tpu_bvh_torch.utils import introspect


def _boxes(rng, n=512):
    """Boxes [n, 3] whose faces take -1, -0.0, +0.0, 0.5 and random values,
    one face in 30 a NaN; a third of the axes have no extent."""
    vals = np.array([-1.0, -0.0, 0.0, 0.5], np.float32)
    mn = np.where(rng.random((n, 3)) < 0.5, rng.choice(vals, (n, 3)),
                  rng.standard_normal((n, 3))).astype(np.float32)
    ext = np.where(rng.random((n, 3)) < 1 / 3, 0.0, rng.random((n, 3))).astype(np.float32)
    other_zero = np.where(mn == 0, -mn, mn)  # a face at -0.0 against one at +0.0
    mx = np.where(ext == 0, np.where(rng.random((n, 3)) < 0.5, mn, other_zero), mn + ext)
    mn[rng.random((n, 3)) < 1 / 30] = np.nan
    return mn, mx.astype(np.float32)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_empty_aabb_and_invalid_idx():
    for shape in ((), (4,), (2, 3)):
        for g, w in zip(aabb.empty_aabb(shape, device="cpu"), jaabb.empty_aabb(shape)):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            _same(g, w)
    assert types.INVALID_IDX == int(jtypes.INVALID_IDX) == -1


@pytest.mark.parametrize("seed", [0, 1])
def test_union_extent_dim_offset_match_jax(seed):
    rng = np.random.default_rng(seed)
    amin, amax = _boxes(rng)
    bmin, bmax = _boxes(rng)
    p = rng.choice(np.array([-0.0, 0.0, 0.25, np.nan], np.float32), (512, 3))
    p = np.where(rng.random((512, 3)) < 0.5, p, rng.standard_normal((512, 3))).astype(np.float32)
    t = lambda *xs: [torch.from_numpy(x) for x in xs]
    j = lambda *xs: [jnp.asarray(x) for x in xs]
    boxes = (amin, amax, bmin, bmax)
    for g, w in zip(aabb.union(*t(*boxes)), jaabb.union(*j(*boxes))):
        _same(g, w)
    _same(aabb.extent(*t(amin, amax)), jaabb.extent(*j(amin, amax)))
    got = aabb.max_extent_dim(*t(amin, amax))
    assert got.dtype == torch.int32
    _same(got, jaabb.max_extent_dim(*j(amin, amax)))
    _same(aabb.offset(*t(amin, amax, p)), jaabb.offset(*j(amin, amax, p)))
    # what the inputs hold: signed zeros, NaNs, zero-extent axes, ties of extents
    assert np.isnan(amin).any() and ((amax - amin) == 0).any()
    assert (_bits(amin) == np.int32(-2**31)).any()


def test_qt_rotation_matches_jax_to_an_ulp():
    rng = np.random.default_rng(5)
    aa = rng.standard_normal((256, 4)).astype(np.float32)
    aa[:8, 3] = [0.0, -0.0, np.pi, -np.pi, 2 * np.pi, 1e-7, 100.0, -3.0]
    got = aabb.qt_rotation(torch.from_numpy(aa)).numpy()
    want = np.asarray(jaabb.qt_rotation(jnp.asarray(aa)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.shape == (256, 4)


@pytest.mark.parametrize("op", ["add", "minimum"])
def test_cost_analysis_of_one_op_equals_xla(op):
    """A single op on f32[1000]: XLA:CPU counts 1000 flops and 12000 bytes
    for `a + b`, and the same for `minimum`."""
    a = np.random.default_rng(0).random(1000, dtype=np.float32)
    b = np.random.default_rng(1).random(1000, dtype=np.float32)
    fns = {"add": (lambda x, y: x + y, lambda x, y: x + y),
           "minimum": (torch.minimum, jnp.minimum)}[op]
    got = introspect.cost_analysis(fns[0], torch.from_numpy(a), torch.from_numpy(b))
    want = jintrospect.cost_analysis(fns[1], jnp.asarray(a), jnp.asarray(b))
    assert got["flops"] == want["flops"] == 1000
    assert got["bytes accessed"] == want["bytes accessed"] == 12000
    assert got["optimal_seconds"] == max(12000 / introspect.HBM_BYTES_PER_S,
                                         1000 / introspect.F32_FLOPS)
    assert got["ops"] == {f"aten.{op}": {"calls": 1, "flops": 1000, "bytes accessed": 12000,
                                         "optimal_seconds": got["optimal_seconds"]}}


def test_cost_analysis_classes():
    """Views and allocations count nothing, copies and sorts only bytes, a
    reduction an operation per element reduced."""
    x = torch.arange(100, dtype=torch.float32)
    got = introspect.cost_analysis(
        lambda v: (v.view(10, 10).T.contiguous(), torch.empty(7), torch.sort(v), v.sum()), x)
    ops = got["ops"]
    assert ops["aten.view"]["bytes accessed"] == ops["aten.empty"]["bytes accessed"] == 0
    assert ops["aten.clone"] == {"calls": 1, "flops": 0, "bytes accessed": 800,
                                 "optimal_seconds": 800 / introspect.HBM_BYTES_PER_S}
    assert ops["aten.sort"]["flops"] == 0 and ops["aten.sort"]["bytes accessed"] == 400 + 400 + 800
    assert ops["aten.sum"]["flops"] == 100
    assert got["flops"] == 100


def test_recorder_does_nothing_outside_cost_analysis():
    def count():
        raise AssertionError("a count ran outside cost_analysis")

    introspect.record("some_kernel", count, "some_kernel")
    assert not introspect.recording()


def test_recorder_inside_cost_analysis():
    """A wrapper's report is its kernel's row; the torch ops its count runs
    are left out; kernel_report(fn) keeps the kernels it names."""
    x = torch.ones(64)

    def fn(v):
        y = v * 2.0
        introspect.record("my_kernel", lambda: (int((y + 1).sum()) * 4, 7, ""),
                          "my_kernel_fn", "scan_kernel<MyOp")
        return y

    got = introspect.cost_analysis(fn, x)
    assert got["ops"]["my_kernel"] == {"calls": 1, "flops": 7, "bytes accessed": 192 * 4,
                                       "hand_kernel": True,
                                       "optimal_seconds": 768 / introspect.HBM_BYTES_PER_S}
    assert set(got["ops"]) == {"aten.mul", "my_kernel"}
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112my_kernel_fnEPf' for "
        "'sm_90a'",
        "ptxas info    : Used 20 registers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_111scan_kernelINS_4MyOpEEvT_' for 'sm_90a'",
        "ptxas info    : Used 30 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111scan_kernelINS_5Other' for "
        "'sm_90a'",
        "ptxas info    : Used 40 registers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116not_my_kernel_fnEPf' for "
        "'sm_90a'",
        "ptxas info    : Used 50 registers"])
    rows = introspect.kernel_report(fn, x, report=report)
    assert [r["registers"] for r in rows] == [20, 30]
    assert len(introspect.kernel_report(report=report)) == 4


def test_plain_paths_record_no_kernel():
    """On CPU tensors the wrappers take their plain versions: cost_analysis
    counts their torch ops and no hand kernel."""
    mat = torch.zeros((8, 64), dtype=torch.int32)
    got = introspect.cost_analysis(ploc_nn.ploc_nn_round_raw, mat, 64, 32, 8)
    assert got["flops"] > 0 and not any(r.get("hand_kernel") for r in got["ops"].values())
