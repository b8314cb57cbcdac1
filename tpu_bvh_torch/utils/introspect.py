"""Kernel introspection and profiling hooks: the port of
`tpu_bvh.utils.introspect`.

- `kernel_report`: per CUDA kernel, its registers, spills, stack frame and
  static shared memory, from the ptxas report of the kernel build
  (`utils/kernels.build_report`): the counterpart of JAX's
  `pallas_kernel_report` and of the reference's
  `Kernel::getNumSmem/getNumRegs`.
- `memory_analysis`: peak device bytes of one call
  (`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`).
- `profiler_trace`: a `torch.profiler` trace of the block, written as a
  Chrome trace.

JAX's `cost_analysis` (XLA's compiled flops and bytes estimate) has no
counterpart: eager PyTorch compiles no program whose cost could be read,
so it is not ported.
"""
from __future__ import annotations

import contextlib
import os
import re

import torch

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_report(report: str | None = None) -> list[dict]:
    """One dict per kernel entry of a ptxas `-v` report (the last kernel
    build's, `kernels.build_report`, by default; empty when this process
    found the library built): name (mangled), registers, smem_bytes
    (static), stack_frame_bytes, spill_store_bytes, spill_load_bytes."""
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
    return list(rows.values())


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
