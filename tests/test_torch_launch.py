"""The port's one launch seam (`utils/kernels.launch`, `query`,
`look_back_work`) against a stub kernel library on the CPU, the build
tally (`utils/timer.tally`), and a source check that every wrapper in
`ops/` and every build in `models/` goes through them. Imports no JAX."""
import ast
import collections
import os

import pytest
import torch

from tpu_bvh_torch.utils import introspect, kernels, timer

STREAM = 0xABC  # the stub's current stream handle
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tpu_bvh_torch")


class _StubLib:
    """Every `tbvh_*` entry records its arguments and returns `code`."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("tbvh_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.code
        return entry


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(kernels, "_lib", lib)
    monkeypatch.setattr(kernels, "stream_of", lambda x: STREAM)
    monkeypatch.setattr(kernels, "launches", collections.Counter())
    return lib


def _no_work():
    return 0, 0, ""


def test_launch_passes_tensors_as_pointers_and_the_stream_last(stub):
    a = torch.zeros(4, dtype=torch.int32)
    b = torch.zeros((2, 3))
    kernels.launch("scan32", "tbvh_scan32", a, 7, None, b, b.data_ptr() + 8, like=a,
                   count=_no_work, symbols="scan_kernel<Topology")
    assert stub.calls == [("tbvh_scan32",
                           (a.data_ptr(), 7, None, b.data_ptr(), b.data_ptr() + 8, STREAM))]


def test_launch_counts_one_under_the_kernel_name(stub):
    a = torch.zeros(4)
    for _ in range(2):
        kernels.launch("ploc_round", "tbvh_ploc_round", a, like=a, count=_no_work, symbols="k")
    kernels.launch("ploc_round_fused", "tbvh_ploc_round", a, like=a, count=_no_work,
                   symbols="k")
    assert kernels.launches == {"ploc_round": 2, "ploc_round_fused": 1}
    assert [name for name, _ in stub.calls] == ["tbvh_ploc_round"] * 3


def test_launch_raises_on_a_nonzero_return_without_counting(stub, monkeypatch):
    reported = []
    monkeypatch.setattr(introspect, "record", lambda *args: reported.append(args))
    stub.code = 1
    a = torch.zeros(4)
    with pytest.raises(RuntimeError, match="tbvh_plane_scan: CUDA error 1"):
        kernels.launch("plane_scan", "tbvh_plane_scan", a, like=a, count=_no_work,
                       symbols="plane_scan_kernel")
    assert kernels.launches == {} and reported == []
    assert len(stub.calls) == 1


def test_launch_reports_under_the_same_name(stub, monkeypatch):
    reported = []
    monkeypatch.setattr(introspect, "record", lambda *args: reported.append(args))
    a = torch.zeros(4)
    kernels.launch("ray_sweep", "tbvh_ray_sweep", a, like=a, count=_no_work,
                   symbols=("rs_init", "rs_sweep"))
    assert reported == [("ray_sweep", _no_work, ("rs_init", "rs_sweep"))]


@pytest.mark.parametrize("symbols,want", [("refit_dense_tile", ["refit_dense_tile"]),
                                          (("rs_init", "rs_sweep"), ["rs_init", "rs_sweep"])])
def test_a_launch_inside_cost_analysis_is_its_hand_kernel_row(stub, symbols, want):
    a = torch.zeros(4)

    def fn():
        kernels.launch("refit_dense", "tbvh_refit_dense", a, like=a,
                       count=lambda: (96, 5, ""), symbols=symbols)

    row = introspect.cost_analysis(fn)["ops"]["refit_dense"]
    assert row["calls"] == 1 and row["hand_kernel"]
    assert (row["bytes accessed"], row["flops"]) == (96, 5)
    assert introspect._run_recorded(fn, (), {}).symbols == want


@pytest.mark.cuda
def test_stream_of_is_the_current_streams_handle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stream handle is the card's")
    x = torch.zeros(4, device="cuda")
    assert kernels.stream_of(x) == torch.cuda.current_stream(x.device).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert kernels.stream_of(x) == side.cuda_stream != torch.cuda.default_stream().cuda_stream


def test_query_checks_and_counts_nothing(stub):
    kernels.query("tbvh_psv_nsv_grid", 5, None)
    assert stub.calls == [("tbvh_psv_nsv_grid", (5, None))] and kernels.launches == {}
    stub.code = 2
    with pytest.raises(RuntimeError, match="tbvh_ploc_finish_clusters: CUDA error 2"):
        kernels.query("tbvh_ploc_finish_clusters", None)


def test_look_back_epochs_never_repeat_across_kernels(monkeypatch):
    """Two kernels' stores and the round kernel's own words draw from one
    epoch, which skips 0 (a zeroed word) where it wraps."""
    monkeypatch.setattr(kernels, "_epoch", (1 << 30) - 4)
    store_a, store_b = {}, {}
    epochs = []
    for k in range(6):
        status, ticket, e = kernels.look_back_work(store_a, "cpu", 0, 4 + k)
        assert status.numel() >= 4 + k and ticket.numel() == 1
        epochs.append(e)
        epochs.append(kernels.look_back_work(store_b, "cpu", 0, 2)[2])
        epochs.append(kernels.next_epoch())
    assert len(set(epochs)) == len(epochs)
    assert all(1 <= e < 1 << 30 for e in epochs)
    assert epochs[:4] == [(1 << 30) - 3, (1 << 30) - 2, (1 << 30) - 1, 1]
    # the words are kept per (device, stream) and grown, never shrunk
    assert store_a[("cpu", 0)][0].numel() == 9 and store_b[("cpu", 0)][0].numel() == 2


def test_tally_writes_the_keys_the_dict_holds(monkeypatch):
    monkeypatch.setattr(kernels, "launches", collections.Counter(scan32=4))
    both = {"launches": -1, "host_syncs": -1, "long": "kept"}
    syncs = {"host_syncs": 7}
    with timer.tally(both) as d, timer.tally(syncs):
        assert d is both
        kernels.launches["scan32"] += 2
        kernels.launches["front_keys"] += 1
        timer.count_host_sync()
    assert both == {"launches": 3, "host_syncs": 1, "long": "kept"}
    assert syncs == {"host_syncs": 1}
    with pytest.raises(ValueError), timer.tally(both):
        timer.count_host_sync()
        raise ValueError
    assert both == {"launches": 3, "host_syncs": 1, "long": "kept"}


def _sources(*dirs):
    return [f"{d}/{name}" for d in dirs for name in sorted(os.listdir(os.path.join(PKG, d)))
            if name.endswith(".py")]


def _tree(rel):
    with open(os.path.join(PKG, rel)) as f:
        return ast.parse(f.read())


_COUNTER = ("launches", "rounds", "_epoch", "kernel_launches")


def _is_counter(name):
    return name in _COUNTER or name.endswith("_launches")


@pytest.mark.parametrize("rel", _sources("ops", "models"))
def test_wrappers_launch_through_the_seam(rel):
    """No module in ops/ or models/ calls the library itself, keeps a
    launch counter or an epoch (module-level or through `global`), or
    copies the seam's helpers; a module's `last_build` is filled by
    `timer.tally` alone."""
    tree = _tree(rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            assert node.func.attr != "lib", f"{rel}:{node.lineno} calls the library"
        if isinstance(node, ast.Global):
            bad = [n for n in node.names if _is_counter(n)]
            assert not bad, f"{rel}:{node.lineno} global {bad}"
        if isinstance(node, ast.FunctionDef):
            assert node.name not in ("_launched", "_ptrs", "_next_epoch", "_counts_host_syncs"), (
                f"{rel}:{node.lineno} defines {node.name}")
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "last_build" and isinstance(t.slice, ast.Constant)):
                    assert t.slice.value not in ("launches", "host_syncs"), (
                        f"{rel}:{node.lineno} writes last_build[{t.slice.value!r}]")
    names = [t.id for node in tree.body if isinstance(node, (ast.Assign, ast.AnnAssign))
             for t in (node.targets if isinstance(node, ast.Assign) else [node.target])
             if isinstance(t, ast.Name)]
    assert not [n for n in names if _is_counter(n)], rel
    if "last_build" in names:
        assert "tally(last_build)" in ast.unparse(tree), f"{rel} fills last_build by hand"


def test_only_the_kernel_module_calls_the_library():
    for rel in _sources(".", "ops", "models", "parallel", "utils"):
        if rel == "utils/kernels.py":
            continue
        calls = [n.lineno for n in ast.walk(_tree(rel)) if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute) and n.func.attr == "lib"
                 and isinstance(n.func.value, ast.Name) and n.func.value.id == "kernels"]
        assert not calls, f"{rel}:{calls} calls kernels.lib()"
    assert not os.path.exists(os.path.join(PKG, "traverse_probe.py"))
