"""Reading a `torch.profiler` Chrome trace of the traced steps.

The interval arithmetic is a copy of the port's `profile_slice.py`: the device
is busy during the union of its kernel, memcpy and memset intervals. The traced
window is the union of the traced steps' spans (the benchmark's own
`step.<mix>` annotations); each step ends in a synchronise, so its device work
lies inside its span, and the harness's own time between steps (the
profiler's bookkeeping) is left out.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "step."  # the benchmark's own spans around each traced step
TOP = 10


def union_us(intervals) -> float:
    """Length of the union of [ts, ts + dur) over (ts, dur) pairs."""
    total, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


class Trace:
    """The device activity and host spans of one traced slice."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "ts" in e and "dur" in e]
        spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                        and e["name"].startswith(SPAN_PREFIX)), key=lambda e: e["ts"])
        if not spans:
            raise RuntimeError("the trace holds none of the benchmark's step spans")
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans]
        self._span_starts = [a for a, _, _ in self.spans]
        self.gpu = [e for e in events if e.get("cat") in GPU_CATS and self._span_of(float(e["ts"]))]
        self.host = sorted((e for e in events if e.get("cat") == "cpu_op"
                            and self._span_of(float(e["ts"]))), key=lambda e: float(e["ts"]))
        self._host_starts = [float(e["ts"]) for e in self.host]
        self.window_s = union_us((a, b - a) for a, b, _ in self.spans) / 1e6
        self.busy_s = union_us(
            (max(float(e["ts"]), span[0]), min(float(e["ts"]) + float(e["dur"]), span[1])
             - max(float(e["ts"]), span[0]))
            for e in self.gpu for span in [self._span_of(float(e["ts"]))]) / 1e6

    def _span_of(self, t: float):
        """The step span running at time t, or None."""
        i = bisect.bisect_right(self._span_starts, t) - 1
        if i >= 0 and t < self.spans[i][1]:
            return self.spans[i]
        return None

    def seconds(self, pattern=None, cats=GPU_CATS) -> float:
        """Device seconds of the events of the categories `cats` whose name
        matches `pattern` (all when None)."""
        rx = re.compile(pattern) if pattern else None
        return sum(float(e["dur"]) for e in self.gpu
                   if e.get("cat") in cats and (rx is None or rx.search(e["name"]))) / 1e6

    def count(self, pattern=None) -> int:
        rx = re.compile(pattern) if pattern else None
        return sum(1 for e in self.gpu if rx is None or rx.search(e["name"]))

    def device_ops(self):
        """The device operations with the most time: [[name, seconds], ...]."""
        by_name = collections.Counter()
        for e in self.gpu:
            by_name[e["name"][:160]] += float(e["dur"]) / 1e6
        return [[k, v] for k, v in by_name.most_common(TOP)]

    def _host_at(self, t: float) -> str:
        """The step span and the innermost host operation running at time t."""
        span = self._span_of(t)
        i = bisect.bisect_right(self._host_starts, t) - 1
        inner = ""
        for e in reversed(self.host[max(0, i - 400):i + 1]):
            if float(e["ts"]) <= t < float(e["ts"]) + float(e["dur"]):
                inner = e["name"]
                break
        return f"{span[2] if span else 'between steps'} > {inner or 'no torch op'}"

    def idle_gaps(self):
        """Idle device time inside the traced steps, grouped by what the host
        was doing when each gap began: [[host operation, seconds], ...], the
        largest first."""
        by_host = collections.Counter()
        gpu = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.gpu)
        k = 0
        for a, b, _ in self.spans:
            end = a
            while k < len(gpu) and gpu[k][0] < b:
                ts, te = gpu[k]
                if ts > end:
                    by_host[self._host_at(end)] += (ts - end) / 1e6
                end = max(end, te)
                k += 1
            if b > end:
                by_host[self._host_at(end)] += (b - end) / 1e6
        return [[key, v] for key, v in by_host.most_common(TOP)]


class Context:
    """What a per-layer metric's reader sees: the trace of the traced steps,
    their count, the cell's sizes, the folder of the hand kernels' files, the
    card's peaks and what the metric's own `collect` kept after each traced
    step."""

    def __init__(self, trace, steps: int, sizes: dict, kernels_dir: str, peaks: dict,
                 store: dict):
        self.trace, self.steps, self.sizes = trace, steps, sizes
        self.kernels_dir, self.peaks, self.store = kernels_dir, peaks, store

    def kernel(self, name: str) -> dict:
        """The hand kernel's file `<kernels_dir>/<name>.json`."""
        with open(os.path.join(self.kernels_dir, name + ".json")) as f:
            return json.load(f)

    def kernel_seconds_per_step(self, kernel: str):
        """Device seconds a step of a hand kernel; None where it never ran."""
        pattern = self.kernel(kernel)["pattern"]
        if self.trace.count(pattern) == 0:
            return None
        return self.trace.seconds(pattern) / self.steps

    def roofline_pct(self, kernel: str):
        """The least time the card could take for one step's call of the
        kernel (its bytes at the peak rate or its f32 operations at the f32
        peak, the larger), over its device time a step, in per cent."""
        t = self.kernel_seconds_per_step(kernel)
        spec = self.kernel(kernel)
        if t is None or not t > 0 or spec.get("bytes") is None or not self.peaks:
            return None
        nbytes = evaluate(spec["bytes"], self.sizes)
        flops = evaluate(spec.get("flops") or "0", self.sizes)
        least = max(nbytes / self.peaks["bytes_per_s"], flops / self.peaks["f32_flops_per_s"])
        return 100.0 * least / t

    def idle_pct(self):
        if not self.trace.window_s > 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)


def evaluate(formula: str, sizes: dict) -> float:
    """A kernel file's byte or operation formula of the call's sizes: an
    arithmetic expression in the names of `sizes`."""
    if not re.fullmatch(r"[A-Za-z0-9_ +\-*/().]*", formula):
        raise ValueError(f"not an arithmetic formula: {formula!r}")
    return float(eval(formula, {"__builtins__": {}}, dict(sizes)))  # noqa: S307
