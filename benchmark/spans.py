"""The program's own spans in a traced slice, and what device time and idle
time lie under each.

Under a running profiler the port marks each layer of its build and
traversal paths with a `bvh.` span (`tpu_bvh_torch/utils/timer.span`): a
`cpu_op` event on the trace's own clock, so `Trace.host` keeps it. This
module reads `Trace.host`, `Trace.gpu` and the step spans `Trace.spans`,
nothing else.

- A device event (kernel, memcpy, memset) belongs to the innermost `bvh.`
  span that encloses the host event that launched it: the `cpu_op` with the
  same `External id`. A hand kernel is launched through ctypes, not by an
  aten op, so it carries the id of the innermost operation open at its
  launch, which is the span itself. An event whose id matches no host event
  is placed by its own start on the device clock (the launch's host time is
  not in `Trace`).
- Idle device time inside the step spans, found with `Trace.idle_gaps`' gap
  arithmetic, is split by the top-level `bvh.` span (one that no other
  `bvh.` span encloses) the host was in over it, and the rest goes to None:
  the split sums to the whole idle time.
"""
from __future__ import annotations

import bisect
import collections

PREFIX = "bvh."


def _interval(e):
    ts = float(e["ts"])
    return ts, ts + float(e["dur"])


class Spans:
    """The `bvh.` spans of a `profiling.Trace`, each with its path: the
    names from its top-level span down to itself."""

    def __init__(self, trace):
        self.trace = trace
        found = sorted(((*_interval(e), e) for e in trace.host if e["name"].startswith(PREFIX)),
                       key=lambda s: (s[0], -s[1]))
        self.spans, stack = [], []  # (start, end, path); the open spans
        self._path_of_id = {}
        for a, b, e in found:
            while stack and not (stack[-1][0] <= a and b <= stack[-1][1]):
                stack.pop()
            path = (stack[-1][2] if stack else ()) + (e["name"],)
            stack.append((a, b, path))
            self.spans.append((a, b, path))
            self._path_of_id[_external_id(e)] = path
        self._path_of_id.pop(None, None)
        self._starts = [a for a, _, _ in self.spans]
        self.top = [(a, b, p[0]) for a, b, p in self.spans if len(p) == 1]
        self._top_ends = [b for _, b, _ in self.top]
        self._host_of_id = {i: e for e in trace.host for i in [_external_id(e)] if i is not None}

    def has(self, name: str) -> bool:
        return any(p[-1] == name for _, _, p in self.spans)

    def path_at(self, t: float) -> tuple:
        """The path of the innermost span running at host time t; () where
        none runs."""
        for k in range(bisect.bisect_right(self._starts, t) - 1, -1, -1):
            a, b, path = self.spans[k]
            if t < b:
                return path
            if len(path) == 1:  # an earlier top-level span ended before it
                return ()
        return ()

    def device_path(self, e) -> tuple:
        """The path of the span a device event belongs to."""
        i = _external_id(e)
        if i in self._path_of_id:
            return self._path_of_id[i]
        host = self._host_of_id.get(i)
        return self.path_at(float((host or e)["ts"]))

    def matched_share(self) -> float:
        """The share of device events placed through their External id."""
        n = len(self.trace.gpu)
        hit = sum(1 for e in self.trace.gpu
                  if _external_id(e) in self._path_of_id or _external_id(e) in self._host_of_id)
        return hit / n if n else 0.0

    def device_seconds(self) -> collections.Counter:
        """Device seconds by path; () holds the events under no span."""
        out = collections.Counter()
        for e in self.trace.gpu:
            out[self.device_path(e)] += float(e["dur"]) / 1e6
        return out

    def device_seconds_under(self, name: str) -> float:
        """Device seconds of the events under every span `name`, its
        children's included."""
        return sum(v for p, v in self.device_seconds().items() if name in p)

    def idle_by_top(self) -> collections.Counter:
        """Idle device seconds inside the step spans, by the top-level span
        the host was in; None holds the idle time outside every one."""
        out = collections.Counter()
        for x, y in idle_intervals(self.trace):
            k = bisect.bisect_right(self._top_ends, x)
            while x < y:
                if k >= len(self.top) or self.top[k][0] >= y:
                    out[None] += (y - x) / 1e6
                    break
                a, b, name = self.top[k]
                if a > x:
                    out[None] += (a - x) / 1e6
                    x = a
                end = min(b, y)
                out[name] += (end - x) / 1e6
                x, k = end, k + 1
        return out

    def durations(self, name: str) -> list:
        """The host seconds of each span `name`."""
        return [(b - a) / 1e6 for a, b, p in self.spans if p[-1] == name]

    def coverage(self) -> float:
        """The share of the step spans' time that the top-level spans
        cover."""
        steps = sum(b - a for a, b, _ in self.trace.spans)
        covered = sum(max(0.0, min(b, sb) - max(a, sa))
                      for a, b, _ in self.top for sa, sb, _ in self.trace.spans)
        return covered / steps if steps else 0.0


def _external_id(e):
    i = (e.get("args") or {}).get("External id")
    return i or None  # 0: launched under no operation


def idle_intervals(trace) -> list:
    """The idle (start, end) intervals inside the step spans, in µs, by
    `Trace.idle_gaps`' arithmetic."""
    gpu = sorted(_interval(e) for e in trace.gpu)
    out, k = [], 0
    for a, b, _ in trace.spans:
        end = a
        while k < len(gpu) and gpu[k][0] < b:
            ts, te = gpu[k]
            if ts > end:
                out.append((end, ts))
            end = max(end, te)
            k += 1
        if b > end:
            out.append((end, b))
    return out
