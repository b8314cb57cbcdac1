"""The harness on the card at a small size: every cell correct, traced and
untraced. Marked `cuda`; each test looks for a card itself and skips without
one (run on the card: python -m pytest benchmark/tests/test_bench_cuda.py -q)."""
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import control  # noqa: E402
from benchmark import run as bench  # noqa: E402

pytestmark = pytest.mark.cuda
SMALL = {"config": {"n_tris": 200_000}, "traffic": {"width": 320, "height": 180}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("cell", ["lbvh_4m.rebuild", "ploc_4m.rebuild", "lbvh_4m.trace"])
@pytest.mark.parametrize("trace", [False, True])
def test_bench_cell_on_the_card(card, cell, trace):
    r = bench.run(cell, 2**31 + 5, 1.0, trace, device=card, overrides=SMALL,
                  t_start=time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    if trace:
        assert r["device"]["busy_s"] > 0
        assert r["metrics"]


@pytest.mark.parametrize("cell", ["lbvh_4m.rebuild", "lbvh_4m.trace"])
def test_bench_control_on_the_card(card, cell):
    r = bench.run(cell, 3, 0.5, False, device=card, overrides=SMALL,
                  steps_hook=control.control_hook, t_start=time.perf_counter())
    assert r["correct"] is False
