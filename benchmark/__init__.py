"""The benchmark of `tpu_bvh_torch` on one NVIDIA H100.

`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(or `python3 -m benchmark.run ...`) from the root of a checkout runs one cell of
`BENCHMARK.json`. Everything a cell needs is found by name: its configuration in
`configs/<config>.json`, its traffic mix in `traffic/<mix>.json`, each end-to-end
metric's reader in `end_to_end/<metric>.py`, each per-layer metric's reader in
`metrics/<metric>.py` and each hand kernel's profiler pattern and byte formula in
`kernels/<kernel>.json`. A configuration names its scene generator and its plain
reference, and a mix names its input generator, its steps, its check and its
control, each as "module:attribute" (`entry`), so a mix of a new kind comes as
files of its own. The plain reference that decides `correct` lives in
`reference/` and imports nothing of the program.
"""
from __future__ import annotations

import importlib


def entry(spec: str | None):
    """The attribute "package.module:attribute", or None for a None spec."""
    if spec is None:
        return None
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)
