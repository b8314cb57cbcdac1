"""Phase timer: the reference's per-phase perf block, on the host clock
and on CUDA events.

Mirrors `tpu_bvh.utils.timer`: the `TimerCodes` tokens carry the
reference's names, times accumulate per token across calls, and
`report()` prints the same block, with "Total" = extents + Morton + sort
+ build. On the card `measure` and `span` record a pair of CUDA events
around the work and synchronise the device before they read the host
clock (where JAX calls `block_until_ready`), so each token has a host
time (`ms`) and a device time (`device_ms`). The port is bound by the
host's launch rate: a phase's host time is mostly launch overhead, its
event time what the stream spent between the two events.

`span(name)` marks a stretch of the build and traversal paths in a
`torch.profiler` trace, as a `cpu_op` event on the trace's own clock. It
records only while a profiler runs and costs one attribute check
otherwise; `Timer.span` enters it under `bvh.<token value>`. The
`host_syncs` counter counts the device-to-host reads of the build paths,
each at its site (`count_host_sync`); `tally` writes a build's launches
and host syncs into its `last_build`.
"""
from __future__ import annotations

import contextlib
import enum
import time
from collections import defaultdict

import torch

from . import kernels

# device-to-host reads counted at their sites since the process started
host_syncs = 0
_NO_SPAN = contextlib.nullcontext()  # what `span` gives while no profiler runs


def span(name: str):
    """A context manager that marks its block as `name` in a running
    profiler's trace (a `cpu_op` event: `record_function`'s events land as
    `user_annotation`, which trace readers that keep host operations do not
    see). With no profiler running it does nothing: no event, no sync."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def count_host_sync() -> None:
    """Count one device-to-host read (a host sync on the card) at its site."""
    global host_syncs
    host_syncs += 1


@contextlib.contextmanager
def tally(d: dict):
    """Write into `d`, in place, what the block ran: under "launches" the
    hand-written kernel launches (`kernels.launches`, all kernels) and
    under "host_syncs" the counted device-to-host reads, each only where
    `d` holds the key. A block that raises leaves `d` as it was."""
    launches, syncs = kernels.launches.total(), host_syncs
    yield d
    if "launches" in d:
        d["launches"] = kernels.launches.total() - launches
    if "host_syncs" in d:
        d["host_syncs"] = host_syncs - syncs


class TimerCodes(enum.Enum):
    CALCULATE_CENTROID_EXTENTS = "CalculateCentroidExtentsTime"
    CALCULATE_MORTON_CODES = "CalculateMortonCodesTime"
    SORTING = "SortingTime"
    BVH_BUILD = "BvhBuildTime"
    TRAVERSAL = "TraversalTime"
    COLLAPSE_BVH = "CollapseBvhTime"
    RAY_GEN = "RayGenTime"


_TOTAL_TOKENS = (
    TimerCodes.CALCULATE_CENTROID_EXTENTS,
    TimerCodes.CALCULATE_MORTON_CODES,
    TimerCodes.SORTING,
    TimerCodes.BVH_BUILD,
)


class Timer:
    """Per-token times of the work on `device` (the GPU unless the caller
    names another; on the CPU there are no events)."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self._ms: dict[TimerCodes, float] = defaultdict(float)
        self._events: dict[TimerCodes, list] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, token: TimerCodes):
        """Time the block's work under `token` (on the card: to a
        synchronize, with a pair of events)."""
        cuda = self.device.type == "cuda"
        with span(f"bvh.{token.value}"):
            if cuda:
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
            t0 = time.perf_counter()
            yield
            if cuda:
                pair[1].record()
                torch.cuda.synchronize(self.device)
                self._events[token].append(pair)
            self._ms[token] += (time.perf_counter() - t0) * 1e3

    def measure(self, token: TimerCodes, fn, *args, **kwargs):
        """Run fn, wait for its work, accumulate its time under token."""
        with self.span(token):
            out = fn(*args, **kwargs)
        return out

    def ms(self, token: TimerCodes) -> float:
        """Host milliseconds accumulated under `token`."""
        return self._ms[token]

    def device_ms(self, token: TimerCodes) -> float:
        """Milliseconds between each span's CUDA events, summed (0.0 on the
        CPU, where no event is recorded)."""
        return sum(a.elapsed_time(b) for a, b in self._events[token])

    @property
    def total_ms(self) -> float:
        """extents + morton + sort + build, the reference's 'Total Time'
        accounting (collapse and traversal excluded)."""
        return sum(self._ms[t] for t in _TOTAL_TOKENS)

    def report(self) -> str:
        lines = ["==========================Perf Times=========================="]
        for token in TimerCodes:
            if token in self._ms:
                lines.append(f"{token.value} : {self._ms[token]:.3f}ms")
        lines.append(f"Total Time : {self.total_ms:.3f}ms")
        lines.append("==============================================================")
        return "\n".join(lines)
