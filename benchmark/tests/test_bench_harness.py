"""The harness driven on the CPU at tiny sizes, with the look for a card
skipped: the last line's schema, the control, and the faults planted under
the timed path, each of which has to turn `correct` false."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import control  # noqa: E402
from benchmark import run as bench  # noqa: E402

CELLS = ("lbvh_4m.rebuild", "ploc_4m.rebuild", "lbvh_4m.trace")
TINY = {"config": {"n_tris": 3000},
        "traffic": {"trace_steps": 2, "width": 24, "height": 16, "poses": 3}}
SEED = 2**31 + 99


def _run(cell, seconds=0.2, trace=False, hook=None):
    return bench.run(cell, SEED, seconds, trace, device="cpu", overrides=TINY, steps_hook=hook,
                     t_start=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_bench_last_line_schema(cell):
    r = _run(cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    spec = bench.cell(cell)
    assert set(r["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert r["metrics"][m["name"]]["unit"] == m["unit"]
        assert r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_bench_traced_line(cell):
    r = _run(cell, trace=True)
    assert r["correct"] is True
    assert set(r["device"]) >= {"busy_s", "window_s"} and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in bench.cell(cell)["per_layer"]}
    assert set(r["metrics"]) <= names  # a reader that finds nothing reports nothing


def test_bench_every_cell_reports_its_metrics():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in spec["workloads"]:
        c = bench.cell(w["name"])
        assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"} and len(c["end_to_end"]) >= 2
        assert c["per_layer"]
        for m in c["per_layer"]:
            assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
            assert m["moves"] in {e["name"] for e in c["end_to_end"]}
        for m in c["end_to_end"]:
            assert os.path.exists(os.path.join(ROOT, "benchmark", "end_to_end", m["name"] + ".py"))


@pytest.mark.parametrize("cell", CELLS)
def test_bench_control_is_not_correct(cell):
    """The reference in bfloat16 in the program's place fails a number."""
    r = _run(cell, hook=control.control_hook)
    assert r["correct"] is False


class _Fault:
    """The program's steps with a fault planted in what they return."""

    def __init__(self, steps, kind):
        self.steps, self.kind = steps, kind
        self.inputs, self.work_per_step = steps.inputs, steps.work_per_step

    def __call__(self, i):
        idx, out = self.steps(i)
        if self.kind == "unchanged":  # another input's output under this input's index
            _, out = self.steps(i + 1)
        elif self.kind == "altered":
            if isinstance(out, tuple) and len(out) == 4 and out[0].dim() == 1:  # hits
                prim = out[0].clone()
                prim[len(prim) // 2] += 1
                out = (prim, *out[1:])
            else:  # a tree: one box float one ulp off
                packed = out.packed_t.clone()
                packed.view(torch.int32)[0, 0] += 1
                out = out._replace(packed_t=packed)
        elif self.kind == "half":  # half of the work left out
            if hasattr(self.steps, "frames"):
                out = self.steps.build(self.steps.frames[idx][: len(self.steps.frames[idx]) // 2])
            else:
                prim, t, u, v = (x.clone() for x in out)
                h = len(prim) // 2
                prim[h:], t[h:], u[h:], v[h:] = -1, 3.402823466e38, 0.0, 0.0
                out = (prim, t, u, v)
        return idx, out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", ["unchanged", "altered", "half"])
def test_bench_fault_is_not_correct(cell, kind):
    r = _run(cell, hook=lambda steps, *_: _Fault(steps, kind))
    assert r["correct"] is False and r["failed"] >= 1


def test_bench_refuses_without_a_card(tmp_path):
    """No card: a non-zero exit and no result line (this box has none; on a
    machine with a card the command would run)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"), "--workload",
                        "lbvh_4m.rebuild", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_bench_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_bvh_torch_like", sys)
    assert "tpu_bvh" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_bvh.fake", sys)
    assert bench.forbidden_modules() == ["tpu_bvh"]


def _fake_trace(tmp_path):
    """Two traced steps: a PyTorch kernel, CUB's sort, a hand kernel, a memcpy
    and a memset in each (times in microseconds)."""
    ev = []
    for k, t0 in enumerate((0.0, 1000.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "step.rebuild", "ts": t0,
                   "dur": 900.0})
        ev += [{"ph": "X", "cat": "kernel", "ts": t0 + 10, "dur": 100.0,
                "name": "void at::native::vectorized_elementwise_kernel<4, X>(int, X)"},
               {"ph": "X", "cat": "kernel", "ts": t0 + 120, "dur": 50.0,
                "name": "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<Y>(Y)"},
               {"ph": "X", "cat": "kernel", "ts": t0 + 200, "dur": 300.0,
                "name": "(anonymous namespace)::ploc_round_kernel(int const*, int)"},
               {"ph": "X", "cat": "gpu_memcpy", "ts": t0 + 600, "dur": 20.0,
                "name": "Memcpy DtoH (Device -> Pinned)"},
               {"ph": "X", "cat": "gpu_memset", "ts": t0 + 700, "dur": 5.0,
                "name": "Memset (Device)"}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


@pytest.mark.parametrize("metric,want", [("torch_ops_ms_per_build", 0.150),
                                         ("copy_fill_ms_per_build", 0.025),
                                         ("ploc_round_ms_per_build", 0.300),
                                         ("launches_per_build", 5.0)])
def test_bench_readers_on_a_known_trace(tmp_path, metric, want):
    """PyTorch's kernels are told by their namespaces alone, so a hand kernel,
    with or without a file in benchmark/kernels/, is never counted as one."""
    from benchmark import profiling

    tr = profiling.Trace(_fake_trace(tmp_path))
    ctx = profiling.Context(tr, 2, {"n": 10}, os.path.join(ROOT, "benchmark", "kernels"), {}, {})
    got = bench._load("metrics", metric).read(ctx)
    assert got == pytest.approx(want)
    assert tr.busy_s == pytest.approx(2 * 475e-6) and tr.window_s == pytest.approx(2 * 900e-6)
