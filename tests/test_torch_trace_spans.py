"""The port's spans and build counters: `utils/timer.span` records nothing
while no profiler runs; under `torch.profiler` each build marks its layers
with `bvh.` spans (`cpu_op` events) of fixed names and nesting; PLOC's
`last_build` keeps each round's live clusters and merges and its counted
reads, and the LBVH's `last_build` its device-to-host reads. Imports no JAX; the one CUDA test
skips without a card."""
import json

import numpy as np
import pytest
import torch

from tpu_bvh_torch.models import lbvh, ploc
from tpu_bvh_torch.ops import ploc as ploc_ops
from tpu_bvh_torch.ops import ploc_round, traverse
from tpu_bvh_torch.types import PLOC_RADIUS, Rays, identity_transform
from tpu_bvh_torch.utils import scenes, timer
from tpu_bvh_torch.utils.timer import Timer, TimerCodes

N = 3000
FIN = 256  # the finisher's hand-over, lowered so a 3000-triangle build runs rounds
LBVH_SPANS = [("bvh.front_half", None), ("bvh.sort", "bvh.front_half"),
              ("bvh.topology", None), ("bvh.refit", "bvh.topology"), ("bvh.finalize", None)]


def _soup(n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10.0, 10.0, size=(n, 1, 3))
    return torch.from_numpy((base + rng.normal(0.0, 0.5, size=(n, 3, 3))).astype(np.float32))


def _cpu_rays(n=4):
    o = torch.zeros((n, 3), dtype=torch.float32)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3).contiguous()
    return Rays(o, d, torch.zeros(n), torch.full((n,), 1e30))


def _prep_on_cpu():
    """`_launch_packed` on CPU tensors: it enters its span, then refuses
    the rays as not on the card."""
    packed = torch.zeros((3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected CUDA"):
        traverse._launch_packed(packed, 1, 0, _cpu_rays(), identity_transform("cpu"))


def _profiled_spans(fn, tmp_path):
    """fn() under torch.profiler; returns (its result, [(name, parent)] of
    the `bvh.` cpu_op events in start order, parent the innermost enclosing
    `bvh.` span or None)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and e["name"].startswith("bvh.")]
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events), key=lambda s: (s[0], -s[1]))
    named = []
    for k, (a, b, name) in enumerate(spans):
        parents = [p for p in spans[:k] if p[0] <= a and b <= p[1]]
        named.append((name, parents[-1][2] if parents else None))
    return out, named


def test_no_span_records_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} entered a RecordFunction with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", FIN)
    tris = _soup(N)
    lbvh.build_single_pass(tris)
    ploc.build_ploc(tris)
    assert ploc_ops.last_build["rounds"] > 0
    _prep_on_cpu()
    Timer("cpu").measure(TimerCodes.SORTING, lambda: None)


def test_lbvh_spans_under_a_profiler(tmp_path):
    _, named = _profiled_spans(lambda: lbvh.build_single_pass(_soup(N)), tmp_path)
    assert named == LBVH_SPANS


def test_two_pass_and_refs_builds_mark_the_same_layers(tmp_path):
    tris = _soup(500, seed=3)
    refs = lbvh.prim_refs_from_triangles(tris)
    for build in (lambda: lbvh.build_two_pass(tris), lambda: lbvh.build_single_pass_refs(refs),
                  lambda: lbvh.build_two_pass_refs(refs)):
        _, named = _profiled_spans(build, tmp_path)
        assert named == LBVH_SPANS


@pytest.mark.parametrize("name", ["ploc", "hploc"])
def test_ploc_spans_under_a_profiler(name, tmp_path, monkeypatch):
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", FIN)
    build = getattr(ploc, f"build_{name}")
    _, named = _profiled_spans(lambda: build(_soup(N)), tmp_path)
    rounds = ploc_ops.last_build["rounds"]
    assert rounds > 0
    assert named == ([("bvh.front_half", None), ("bvh.sort", "bvh.front_half"),
                      ("bvh.ploc_init", None)] + [("bvh.ploc_round", None)] * rounds
                     + [("bvh.ploc_finish", None), ("bvh.finalize", None),
                        ("bvh.finalize", None)])


def test_traverse_prep_and_timer_spans_under_a_profiler(tmp_path):
    def work():
        _prep_on_cpu()
        Timer("cpu").measure(TimerCodes.SORTING, lambda: lbvh.build_single_pass(_soup(64)))

    _, named = _profiled_spans(work, tmp_path)
    assert named == [("bvh.traverse_prep", None), ("bvh.SortingTime", None)] + [
        (n, p or "bvh.SortingTime") for n, p in LBVH_SPANS]


def _rounds_by_hand(tris, hploc, shift0, step):
    """(clusters, merged) of the round loop, stepping the plain round."""
    codes, leaf_packed_t, _ = lbvh._sorted_leaves_from_tris(tris, True)
    n = leaf_packed_t.shape[1]
    mat = ploc_ops.initial_state(leaf_packed_t, codes)
    nodes = torch.zeros((8, n - 1), dtype=torch.int32)
    nc, shift = n, (shift0 if hploc else 32)
    clusters, merged = [], []
    while nc > ploc_round.FIN_WIDTH:
        mat, nodes, nm = ploc_round.ploc_round_reference(mat, nodes, nc, shift, n - nc,
                                                         PLOC_RADIUS)
        clusters.append(nc)
        merged.append(int(nm))
        nc -= int(nm)
        shift = min(shift + step, 32)
    return clusters, merged


@pytest.mark.parametrize("name", ["ploc", "hploc"])
def test_ploc_round_counters(name, monkeypatch):
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", FIN)
    tris = _soup(N, seed=1)
    getattr(ploc, f"build_{name}")(tris)
    got = ploc_ops.last_build
    clusters, merged = got["clusters"], got["merged"]
    assert len(clusters) == len(merged) == got["rounds"] > 0
    assert clusters[0] == N
    for k in range(len(clusters) - 1):
        assert clusters[k + 1] == clusters[k] - merged[k]
    assert clusters[-1] - merged[-1] <= FIN < clusters[-1]
    assert (clusters, merged) == _rounds_by_hand(
        tris, name == "hploc", ploc.HPLOC_SHIFT0, ploc.HPLOC_SHIFT_STEP)


def test_ploc_counters_are_empty_when_the_finisher_takes_all():
    ploc.build_ploc(_soup(100))
    assert ploc_ops.last_build["rounds"] == 0
    assert ploc_ops.last_build["clusters"] == [] and ploc_ops.last_build["merged"] == []


@pytest.mark.parametrize("n,extended,syncs", [
    (N, True, 3),  # the extent copy, the long-node count, the nonzero
    (N, False, 2),  # the plain Morton code reads no extent
    (40, True, 2),  # 39 nodes fit the long-node budget: no count, the nonzero
    (40, False, 1),
])
def test_lbvh_host_syncs_count_the_reads_the_build_ran(n, extended, syncs):
    tris = _soup(n, seed=2)
    start = timer.host_syncs
    lbvh.build_single_pass(tris, extended)
    assert lbvh.last_build["host_syncs"] == syncs == timer.host_syncs - start
    lbvh.build_two_pass(tris, extended)
    assert lbvh.last_build["host_syncs"] == syncs


@pytest.mark.parametrize("name", ["ploc", "hploc"])
def test_ploc_host_syncs_count_the_round_loop_reads(name, monkeypatch):
    """On the CPU the plain round loop reads each round's merge count once,
    counted where it happens; the front half's extent read is the build's
    other counted read, outside the round loop."""
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", 4096)
    tris = torch.from_numpy(scenes.sponza_like(16_384))
    start = timer.host_syncs
    getattr(ploc, f"build_{name}")(tris)
    got = ploc_ops.last_build
    assert got["host_syncs"] == got["rounds"] == len(got["clusters"]) > 0
    assert timer.host_syncs - start == got["host_syncs"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ploc", "hploc"])
def test_ploc_round_counters_kernel_path_equal_the_plain_path(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the PLOC kernels run only on the GPU")
    monkeypatch.setattr(ploc_round, "FIN_WIDTH", 4096)
    tris = torch.from_numpy(scenes.sponza_like(16_384))
    build = getattr(ploc, f"build_{name}")
    build(tris)
    want = dict(ploc_ops.last_build)
    build(tris.to("cuda"))
    torch.cuda.synchronize()
    got = ploc_ops.last_build
    assert got["rounds"] > 0 and got["host_syncs"] == got["rounds"] + 1
    assert (got["clusters"], got["merged"]) == (want["clusters"], want["merged"])
