"""The build-plus-collapse cell (`lbvh4_4m.rebuild`) on the CPU at a tiny
size: its check reads 0 on the program and more than 0 on the reference in
bfloat16 and on planted faults; the four collapse readers on a hand-made
Chrome trace whose values are worked out by hand."""
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import checks_bvh4, control, profiling  # noqa: E402
from benchmark import run as bench  # noqa: E402
from benchmark.reference import collapse as ref_collapse  # noqa: E402

CELL = "lbvh4_4m.rebuild"
TINY = {"config": {"n_tris": 3000}, "traffic": {"trace_steps": 2}}
SEED = 2**31 + 1023
KERNELS = os.path.join(ROOT, "benchmark", "kernels")
PEAKS = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}
READERS = ("collapse_ms_per_build", "idle_ms_per_build.collapse", "collapse_block_roofline_pct",
           "collapse_roofline_pct")


def _run(trace=False, hook=None):
    return bench.run(CELL, SEED, 0.2, trace, device="cpu", overrides=TINY, steps_hook=hook,
                     t_start=time.perf_counter())


def test_bvh4_cell_reads_zero_on_the_program():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert {k: v["value"] for k, v in r["checks"].items()} == {
        "order_differs": 0, "links_differ": 0, "boxes_differ": 0}
    assert set(r["metrics"]) == {"build_ms", "build_p95_ms", "setup_s"}


def test_bvh4_cell_traced_on_the_cpu():
    r = _run(trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) <= {m["name"] for m in bench.cell(CELL)["per_layer"]}
    for name in READERS:  # no device events on the CPU: nothing to read
        assert name not in r["metrics"]
    # the build's 3 reads and the collapse's long count
    assert r["metrics"]["lbvh_host_syncs_per_build"]["value"] == 4


def test_bvh4_control_in_bfloat16_reads_more_than_zero():
    r = _run(hook=control.control_hook)
    assert r["correct"] is False
    assert all(v["value"] > 0 for v in r["checks"].values()), r["checks"]


def _soup(n=400, seed=5):
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((n, 1, 3), generator=g) * 20 - 10
    return base + torch.randn((n, 3, 3), generator=g) * 0.5


def test_compare4_counts_planted_faults():
    want = ref_collapse.build_lbvh_bvh4(_soup(), {})
    zero = {"order_differs": 0, "links_differ": 0, "boxes_differ": 0}
    assert checks_bvh4.compare4(want, want) == zero
    x = int(want.root)
    count = int(want.child_count[x])
    # one ulp in a used slot's box; an empty slot's box is not compared
    boxes = want.slot_packed_t.clone()
    boxes.view(torch.int32)[0, 2, x] += 1
    assert checks_bvh4.compare4(want._replace(slot_packed_t=boxes), want) == dict(
        zero, boxes_differ=1)
    unused = int(torch.nonzero(want.child_count == 0)[0])
    boxes = want.slot_packed_t.clone()
    boxes.view(torch.int32)[1, 0, unused] += 1
    assert checks_bvh4.compare4(want._replace(slot_packed_t=boxes), want) == zero
    # two slots swapped: one node's links, and both slots' boxes where they differ
    child = want.child_t.clone()
    child[[0, count - 1], x] = child[[count - 1, 0], x]
    got = checks_bvh4.compare4(want._replace(child_t=child), want)
    assert got["links_differ"] == 1 and got["order_differs"] == 0
    prim = want.leaf_prim.clone()
    prim[[3, 4]] = prim[[4, 3]]
    assert checks_bvh4.compare4(want._replace(leaf_prim=prim), want)["order_differs"] == 2
    lp = want.leaf_parent.clone()
    lp[0] = -1
    assert checks_bvh4.compare4(want._replace(leaf_parent=lp), want)["links_differ"] == 1
    root = want.root + 1
    assert checks_bvh4.compare4(want._replace(root=root), want)["links_differ"] == 1
    half = ref_collapse.build_lbvh_bvh4(_soup()[:200], {})
    assert checks_bvh4.compare4(half, want)["order_differs"] == want.leaf_prim.shape[0]


def _x(cat, name, ts, dur, ext=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if ext is not None:
        e["args"] = {"External id": ext}
    return e


# One build-plus-collapse step of 1000 µs: the finalize [0, 100) with a
# kernel, the collapse [100, 900) with a PyTorch kernel, then B3 under
# `bvh.collapse_block` [500, 800) and its flag's DtoH copy; the harness after.
COLLAPSE = [
    _x("cpu_op", "bvh.finalize", 0, 100, 1),
    _x("kernel", "void at::native::CatArrayBatchedCopy", 10, 40, 1),
    _x("cpu_op", "bvh.collapse", 100, 800, 2),
    _x("cpu_op", "aten::sort", 110, 10, 11),
    _x("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", 130, 100, 11),
    _x("cpu_op", "bvh.collapse_block", 500, 300, 3),
    _x("kernel", "(anonymous namespace)::collapse_block_kernel(int const*)", 550, 200, 3),
    _x("cpu_op", "aten::_local_scalar_dense", 760, 30, 12),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 770, 5, 12),
]
N = 1000


def _ctx(tmp_path, events, steps=2):
    out = []
    for k in range(steps):
        dt = 2000.0 * k
        out.append(_x("user_annotation", "step.rebuild_bvh4", dt, 1000, 9000 + k))
        for e in events:
            e = dict(e, ts=e["ts"] + dt)
            if e.get("args"):
                e["args"] = {"External id": e["args"]["External id"] + 1000 * k}
            out.append(e)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": out}))
    return profiling.Context(profiling.Trace(str(path)), steps, {"n": N}, KERNELS, PEAKS, {})


def _read(name, ctx):
    return bench._load("metrics", name).read(ctx)


def test_collapse_readers_by_hand(tmp_path):
    ctx = _ctx(tmp_path, COLLAPSE)
    # device: sort 100 + B3 200 + the copy 5 under the collapse
    assert _read("collapse_ms_per_build", ctx) == pytest.approx(0.305)
    # idle under the collapse: [100, 130) [230, 550) [750, 770) [775, 900)
    assert _read("idle_ms_per_build.collapse", ctx) == pytest.approx(0.495)
    b3 = 100 * 196 * N / PEAKS["bytes_per_s"] / 200e-6
    assert _read("collapse_block_roofline_pct", ctx) == pytest.approx(b3)
    least = 32 * (2 * N - 1) + 120 * (N - 1) + 8 * N
    assert _read("collapse_roofline_pct", ctx) == pytest.approx(
        100 * least / PEAKS["bytes_per_s"] / 305e-6)


def test_collapse_readers_report_nothing_without_the_collapse(tmp_path):
    """A build that does not collapse (the parent's program, or another
    cell's) has no `bvh.collapse` span and no B3 kernel."""
    ctx = _ctx(tmp_path, COLLAPSE[:2])
    for name in READERS:
        assert _read(name, ctx) is None, name


def test_collapse_kernel_file_is_the_programs_unconditional_bytes():
    spec = json.load(open(os.path.join(KERNELS, "collapse_block.json")))
    assert profiling.evaluate(spec["bytes"], {"n": N}) == 4 * (8 + 1 + 8 + 4 * 8) * N
