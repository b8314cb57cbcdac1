"""The reader of `collapse_kernels_per_build`: the mean of the program's
counter over the traced builds on a hand-made store, the counter as the
program keeps it, and nothing from a program whose collapse keeps no
`last_build` (an older checkout of the program)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import profiling  # noqa: E402
from benchmark import run as bench  # noqa: E402

NAME = "collapse_kernels_per_build"
KERNELS = os.path.join(ROOT, "benchmark", "kernels")
PEAKS = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 6.7e13}


def _read(store):
    ctx = profiling.Context(None, 2, {}, KERNELS, PEAKS, store)
    return bench._load("metrics", NAME).read(ctx)


def test_reads_the_mean_of_the_stored_counts():
    assert _read({NAME: [3, 3, 3, 3]}) == 3
    assert _read({NAME: [3, 3, 0, 0]}) == 1.5
    assert _read({NAME: []}) is None


def test_collects_the_programs_counter(monkeypatch):
    from tpu_bvh_torch.ops import collapse_fast

    monkeypatch.setitem(collapse_fast.last_build, "launches", 3)
    store = []
    bench._load("metrics", NAME).collect(store, None)
    assert store == [3]


def test_nothing_from_a_program_without_the_counter(monkeypatch):
    from tpu_bvh_torch.ops import collapse_fast

    monkeypatch.delattr(collapse_fast, "last_build")
    store = []
    bench._load("metrics", NAME).collect(store, None)
    assert store == [] and _read({NAME: store}) is None
