"""The readers of the program's spans and counters (`benchmark/spans.py` and
the seven metrics that use it) on hand-made Chrome traces whose values are
worked out by hand; the idle split against `Trace.idle_gaps`; the frozen B6
formula against the program's `utils/work.ploc_round`; and a traced CPU run
of each cell at tiny sizes."""
import json
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import profiling, spans  # noqa: E402
from benchmark import run as bench  # noqa: E402

KERNELS = os.path.join(ROOT, "benchmark", "kernels")
PEAKS = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}
STEP_US = 2000.0  # the second step repeats the first this much later


def _x(cat, name, ts, dur, ext=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


def _trace(tmp_path, step, events, steps=2):
    """A trace of `steps` copies of one step's events, each inside its
    `step.<mix>` annotation, External ids made unique per copy."""
    out = []
    for k in range(steps):
        dt = k * STEP_US
        out.append(_x("user_annotation", step[0], step[1] + dt, step[2], 9000 + k))
        for e in events:
            e = dict(e, ts=e["ts"] + dt)
            if e.get("args", {}).get("External id"):
                e["args"] = {"External id": e["args"]["External id"] + 1000 * k}
            out.append(e)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": out}))
    return profiling.Trace(str(path))


def _ctx(trace, store=None, steps=2):
    return profiling.Context(trace, steps, {}, KERNELS, PEAKS, store or {})


def _read(name, ctx):
    return bench._load("metrics", name).read(ctx)


# One LBVH build, in µs: front half [10, 300) with its sort [150, 290),
# topology [300, 700) with its refit [500, 690), finalize [700, 950), the
# harness after it; kernels launched by aten ops, by ctypes inside a span
# (the span's own id), with no id (placed by their device start) and under
# no span.
LBVH = [
    _x("cpu_op", "bvh.front_half", 10, 290, 1),
    _x("cpu_op", "aten::mul", 20, 10, 10),
    _x("cpu_op", "bvh.sort", 150, 140, 2),
    _x("cpu_op", "aten::sort", 160, 10, 11),
    _x("cpu_op", "bvh.topology", 300, 400, 3),
    _x("cpu_op", "aten::copy_", 400, 20, 12),
    _x("cpu_op", "bvh.refit", 500, 190, 4),
    _x("cpu_op", "bvh.finalize", 700, 250, 5),
    _x("cpu_op", "aten::cat", 710, 10, 13),
    _x("cpu_op", "aten::fill_", 960, 10, 14),
    _x("kernel", "void at::native::mul", 40, 50, 10),
    _x("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", 180, 100, 11),
    _x("kernel", "scan_kernel<Topology>", 320, 60, 3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 430, 10, 12),
    _x("kernel", "refit_dense_tile", 520, 40, 4),
    _x("kernel", "void at::native::where", 600, 20),
    _x("kernel", "void at::native::CatArrayBatchedCopy", 730, 100, 13),
    _x("kernel", "void at::native::fill", 975, 5, 0),
]
LBVH_STEP = ("step.rebuild", 0, 1000)
# idle, by hand: [0, 40) [90, 180) [280, 320) [380, 430) [440, 520)
# [560, 600) [620, 730) [830, 975) [980, 1000), split at 10, 300, 700, 950
LBVH_IDLE = {"bvh.front_half": 30 + 90 + 20, "bvh.topology": 20 + 50 + 80 + 40 + 80,
             "bvh.finalize": 30 + 120, None: 10 + 25 + 20}


def test_device_time_goes_to_the_innermost_span_of_its_launch(tmp_path):
    s = spans.Spans(_trace(tmp_path, LBVH_STEP, LBVH))
    got = s.device_seconds()
    assert {k: round(v * 1e6 / 2, 6) for k, v in got.items()} == {
        ("bvh.front_half",): 50, ("bvh.front_half", "bvh.sort"): 100,
        ("bvh.topology",): 60 + 10, ("bvh.topology", "bvh.refit"): 40 + 20,
        ("bvh.finalize",): 100, (): 5}
    assert s.matched_share() == pytest.approx(6 / 8)
    assert s.coverage() == pytest.approx(940 / 1000)
    assert s.durations("bvh.refit") == pytest.approx([190e-6, 190e-6])


def test_lbvh_readers_by_hand(tmp_path):
    ctx = _ctx(_trace(tmp_path, LBVH_STEP, LBVH))
    assert _read("front_half_ms_per_build", ctx) == pytest.approx(0.150)
    assert _read("idle_ms_per_build.front_half", ctx) == pytest.approx(0.140)
    assert _read("idle_ms_per_build.lbvh_tail", ctx) == pytest.approx(0.270 + 0.150)
    for name in ("idle_ms_per_build.ploc_rounds", "traverse_prep_ms_per_call"):
        assert _read(name, ctx) is None  # no such span in this trace


def test_idle_split_sums_to_the_idle_gaps(tmp_path):
    tr = _trace(tmp_path, LBVH_STEP, LBVH)
    split = spans.Spans(tr).idle_by_top()
    assert {k: round(v * 1e6 / 2, 6) for k, v in split.items()} == LBVH_IDLE
    total = sum(split.values())
    assert total == pytest.approx(sum(v for _, v in tr.idle_gaps()))
    assert total == pytest.approx(tr.window_s - tr.busy_s)
    assert sum(b - a for a, b in spans.idle_intervals(tr)) / 1e6 == pytest.approx(total)


# One PLOC build: two rounds, each a ctypes launch of B6 under its span and
# the read of its merge count (an aten op with a DtoH copy), then the
# finisher; 7 µs of host time between the two rounds lies under no span.
PLOC = [
    _x("cpu_op", "bvh.ploc_round", 0, 100, 1),
    _x("kernel", "ploc_round_kernel<int const>", 50, 20, 1),
    _x("cpu_op", "aten::_local_scalar_dense", 72, 20, 11),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 75, 1, 11),
    _x("cpu_op", "bvh.ploc_round", 107, 93, 2),
    _x("kernel", "ploc_round_kernel<int const>", 150, 20, 2),
    _x("cpu_op", "bvh.ploc_finish", 200, 100, 3),
    _x("kernel", "ploc_finish_kernel", 210, 80, 3),
]
PLOC_STEP = ("step.rebuild", 0, 300)


def test_ploc_readers_by_hand(tmp_path):
    builds = [([1000, 800], [200, 150])] * 2
    ctx = _ctx(_trace(tmp_path, PLOC_STEP, PLOC), {"ploc_round_roofline_pct": builds})
    # round 1: idle [0, 50) [70, 75) [76, 100); the gap [100, 107) under no
    # span; round 2: [107, 150) [170, 200)
    assert _read("idle_ms_per_build.ploc_rounds", ctx) == pytest.approx(
        (50 + 5 + 24 + 43 + 30) / 1e3)
    least = (4 * (7 * 1000 + 800 + 8 * 800 + 8 * 200) + 4 * (7 * 800 + 650 + 8 * 650 + 8 * 150)) \
        / PEAKS["bytes_per_s"]
    assert _read("ploc_round_roofline_pct", ctx) == pytest.approx(100 * least / 40e-6)
    split = spans.Spans(ctx.trace).idle_by_top()
    assert split[None] == pytest.approx(2 * 7e-6)
    assert sum(split.values()) == pytest.approx(sum(v for _, v in ctx.trace.idle_gaps()))


def test_traverse_prep_reader_by_hand(tmp_path):
    trace = _trace(tmp_path, ("step.trace", 0, 1000), [
        _x("cpu_op", "bvh.traverse_prep", 10, 250, 1),
        _x("cpu_op", "aten::empty", 20, 5, 10),
        _x("kernel", "traverse_kernel<PackedNodes, 0, 256>", 300, 600, 0),
    ])
    assert _read("traverse_prep_ms_per_call", _ctx(trace)) == pytest.approx(0.250)


def test_readers_of_the_program_counters():
    ctx = _ctx(None, {"lbvh_host_syncs_per_build": [3, 3, 4, 2]})
    assert _read("lbvh_host_syncs_per_build", ctx) == 3
    for name in ("lbvh_host_syncs_per_build", "ploc_round_roofline_pct"):
        assert _read(name, _ctx(None, {name: []})) is None  # a program that keeps none


@pytest.mark.parametrize("nc,merged,shift", [(4_000_000, 760_000, 32), (1000, 1, 32),
                                             (16_385, 8_192, 32), (5000, 900, 9),
                                             (777, 0, 27)])
def test_frozen_b6_formula_equals_the_programs(nc, merged, shift):
    from tpu_bvh_torch.utils import work

    reader = bench._load("metrics", "ploc_round_roofline_pct")
    want_bytes, want_flops, _ = work.ploc_round(nc, merged, merged, reader.RADIUS, shift)
    assert reader.round_bytes(nc, merged, shift) == want_bytes
    assert reader.round_flops(nc) == want_flops


TINY = {"config": {"n_tris": 3000},
        "traffic": {"trace_steps": 2, "width": 24, "height": 16, "poses": 3}}


@pytest.mark.parametrize("cell", ["lbvh_4m.rebuild", "ploc_4m.rebuild", "lbvh_4m.trace"])
def test_traced_cpu_run_keeps_correct(cell):
    r = bench.run(cell, 2**33 + 7, 0.2, True, device="cpu", overrides=TINY,
                  t_start=time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    names = {m["name"] for m in bench.cell(cell)["per_layer"]}
    assert set(r["metrics"]) <= names
    # no device: the device-trace readers report nothing; the counters do
    for name in ("front_half_ms_per_build", "idle_ms_per_build.front_half",
                 "idle_ms_per_build.lbvh_tail", "idle_ms_per_build.ploc_rounds",
                 "ploc_round_roofline_pct"):
        assert name not in r["metrics"]
    if cell == "lbvh_4m.rebuild":
        assert r["metrics"]["lbvh_host_syncs_per_build"]["value"] == 3
