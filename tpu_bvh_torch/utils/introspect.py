"""Kernel introspection and profiling hooks: the port of
`tpu_bvh.utils.introspect`.

- `cost_analysis`: the flops and bytes one call of a function takes, by
  the key names of XLA's cost analysis, counted as the call runs: every
  torch op it dispatches and every hand-written kernel it launches (the
  counterpart of JAX's `cost_analysis`, which reads them from the compiled
  program).
- `kernel_report`: per CUDA kernel, its registers, spills, stack frame and
  static shared memory, from the ptxas report of the kernel build
  (`utils/kernels.build_report`), for every kernel or for those one call
  of a function launched: the counterpart of JAX's `pallas_kernel_report`
  and of the reference's `Kernel::getNumSmem/getNumRegs`.
- `memory_analysis`: peak device bytes of one call
  (`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`).
- `profiler_trace`: a `torch.profiler` trace of the block, written as a
  Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import re
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# the rates of a bound (H100 SXM): device memory and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")

# torch ops that move no data: views and allocations
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_",
            "set_", "record_stream"}
# torch ops that move data and compute nothing: copies, fills, indexing, sorts
_MOVES = {"copy_", "clone", "_to_copy", "contiguous", "cat", "stack", "flip", "roll", "repeat",
          "constant_pad_nd", "fill_", "zero_", "zeros", "zeros_like", "ones", "ones_like", "full",
          "full_like", "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor",
          "lift_fresh_copy", "_local_scalar_dense", "index", "index_select", "gather",
          "take_along_dim", "scatter", "scatter_", "scatter_add", "scatter_add_", "index_put",
          "index_put_", "_index_put_impl_", "index_copy", "index_copy_", "masked_select",
          "nonzero", "sort", "argsort", "topk", "unique", "_unique2", "unique_consecutive",
          "narrow_copy", "select_scatter", "slice_scatter", "split_with_sizes_copy"}


def optimal_seconds(n_bytes, flops) -> float:
    """The least time the card could take for the work: the larger of the
    bytes over the memory rate and the f32 operations over the f32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


class _Recording:
    """The counts of one `cost_analysis` call: op name -> calls, flops,
    bytes; hand kernels also the patterns of their CUDA kernels' names."""

    def __init__(self):
        self.ops: dict[str, dict] = {}
        self.symbols: list[str] = []
        self.paused = False

    def add(self, name, flops, n_bytes, kernel=False):
        row = self.ops.setdefault(name, {"calls": 0, "flops": 0, "bytes accessed": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes accessed"] += n_bytes
        if kernel:
            row["hand_kernel"] = True

    @contextlib.contextmanager
    def pause(self):
        was, self.paused = self.paused, True
        try:
            yield
        finally:
            self.paused = was


_state = threading.local()  # .rec: the recording in progress on this thread, if any


def _active():
    return getattr(_state, "rec", None)


def recording() -> bool:
    """Whether a `cost_analysis` is counting on this thread (a wrapper
    whose count needs more than its outputs, such as the rows a traversal
    stood on, asks its kernel for it only then)."""
    rec = _active()
    return rec is not None and not rec.paused


def record(kernel: str, count, *symbols) -> None:
    """Report one launch of a hand-written kernel, called by
    `kernels.launch` right after the launch. Does nothing outside
    `cost_analysis`. Inside it, `count()` gives the call's (bytes, flops,
    info) (`utils/work.py`; it may read the kernel's outputs, a host sync
    that happens only here), with the torch ops it runs left out of the
    counts. `symbols` name the
    CUDA kernels the launch ran, for `kernel_report(fn)`: the kernel
    function's identifier, or "name<Type" for its instantiations with a
    type argument of that name; a tuple of them counts as its members."""
    rec = _active()
    if rec is None or rec.paused:
        return
    with rec.pause():
        n_bytes, flops, _ = count()
    rec.add(kernel, int(flops), int(n_bytes), kernel=True)
    for s in symbols:
        rec.symbols.extend(x for x in ((s,) if isinstance(s, str) else s)
                           if x not in rec.symbols)


def _op_kind(func) -> str:
    name = func.overloadpacket.__name__
    if name in _NO_DATA or func.is_view:
        return "none"
    return "move" if name in _MOVES else "arith"


class _CountOps(TorchDispatchMode):
    def __init__(self, rec: _Recording):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.rec.paused:
            kind = _op_kind(func)
            results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            flops = n_bytes = 0
            if kind != "none":
                inputs = [t for t in tree_leaves((args, kwargs or {}))
                          if isinstance(t, torch.Tensor)]
                n_bytes = sum(t.numel() * t.element_size() for t in inputs + results)
            if kind == "arith":
                flops = max([sum(t.numel() for t in results)] + [t.numel() for t in inputs])
            self.rec.add(str(func.overloadpacket), flops, n_bytes)
        return out


def _run_recorded(fn, args, kwargs) -> _Recording:
    if _active() is not None:
        raise RuntimeError("cost_analysis and kernel_report(fn) do not nest")
    rec = _Recording()
    _state.rec = rec
    try:
        with _CountOps(rec):
            fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        _state.rec = None
    return rec


def cost_analysis(fn, *args, **kwargs) -> dict:
    """Run fn once and return what it took: "flops", "bytes accessed" and
    "optimal_seconds" (the larger of bytes at `HBM_BYTES_PER_S` and flops
    at `F32_FLOPS`), XLA's key names, and under "ops" the same per torch op
    ("aten.add", ...) and per hand-written kernel (its launch counter's
    name, with "hand_kernel": True), with its calls.

    Torch ops are counted as they are dispatched. Bytes are every tensor
    argument plus every result. Flops are 0 for ops that only move data:
    copies, fills and factories, concatenation, indexing, gathers and
    scatters, sorts (`_MOVES`). Every other op is arithmetic (elementwise
    math, compares, selects, scans, reductions), one operation an element
    of its result, or of its largest argument where that is larger (a
    reduction: one an element reduced). Views and allocations
    (`_NO_DATA`) count neither. A hand-written kernel is counted by its wrapper
    (`record`, `utils/work.py`): the bytes and flops its bound is made
    of. On a single op this equals XLA's count (`a + b` on f32[1000]:
    1000 flops, 12000 bytes); a longer expression differs, since eager
    PyTorch writes every intermediate that XLA fuses away."""
    rec = _run_recorded(fn, args, kwargs)
    for row in rec.ops.values():
        row["optimal_seconds"] = optimal_seconds(row["bytes accessed"], row["flops"])
    flops = sum(r["flops"] for r in rec.ops.values())
    n_bytes = sum(r["bytes accessed"] for r in rec.ops.values())
    return {"flops": flops, "bytes accessed": n_bytes,
            "optimal_seconds": optimal_seconds(n_bytes, flops), "ops": rec.ops}


def _fragments(symbol: str) -> list[str]:
    """What a mangled kernel name holds for "name" or "name<Arg": each
    identifier as its length and itself (so "scan_kernel<PsvNsv" is a
    `scan_kernel` instantiated with the type `PsvNsv`, in any namespace)."""
    return [f"{len(x)}{x}" for x in symbol.split("<")]


def kernel_report(fn=None, *args, report: str | None = None, **kwargs) -> list[dict]:
    """One dict per kernel entry of a ptxas `-v` report (the library's
    build, `kernels.build_report`, by default): name (mangled), registers,
    smem_bytes (static), stack_frame_bytes, spill_store_bytes,
    spill_load_bytes. Given fn, it runs fn(*args, **kwargs) once and keeps
    the kernels that call launched, as `pallas_kernel_report(fn, ...)`
    reports the kernels of fn's traced program: every instantiation of
    each kernel function a launch names (`record`'s symbols)."""
    wanted = None
    if fn is not None:
        wanted = [_fragments(s) for s in _run_recorded(fn, args, kwargs).symbols]
    if report is None:
        from . import kernels

        report = kernels.build_report
    rows: dict[str, dict] = {}
    current = props = None
    for line in report.splitlines():
        if m := _ENTRY.search(line):
            current = m.group(1)
            rows.setdefault(current, {"name": current})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _FRAME.search(line)) and props in rows:
            rows[props].update(stack_frame_bytes=int(m.group(1)),
                               spill_store_bytes=int(m.group(2)),
                               spill_load_bytes=int(m.group(3)))
        elif (m := _USED.search(line)) and current is not None:
            smem = _SMEM.search(line)
            rows[current].update(registers=int(m.group(1)),
                                 smem_bytes=int(smem.group(1)) if smem else 0)
    out = list(rows.values())
    if wanted is not None:
        out = [r for r in out if any(all(f in r["name"] for f in w) for w in wanted)]
    return out


def memory_analysis(fn, *args, device="cuda", **kwargs) -> int | None:
    """Peak device bytes allocated during one call of fn on `device` (the
    GPU unless the caller names another); None on the CPU, which has no
    device memory to read."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Trace the block with `torch.profiler` (host activity, and the card's
    where there is one) and write `log_dir/trace.json` (Chrome format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
