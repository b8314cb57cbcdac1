"""The wrappers size their scratch and refuse inputs from Python mirrors of
constants fixed at compile time in `tpu_bvh_torch/csrc/`; each mirror must
equal its source's `constexpr`."""
import os
import re

import pytest

from tpu_bvh_torch.ops import (batched_block, batched_build, collapse_block, plane_scan,
                               ploc_nn, ploc_round, raster_gpu, ray_sweep, refit, refit_dense,
                               threshold_core, traverse)
from tpu_bvh_torch.utils import kernels


def _constexpr(source: str, name: str) -> int:
    with open(os.path.join(kernels.CSRC, source)) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    assert len(found) == 1, f"{source}: {name}"
    return int(found[0])


@pytest.mark.parametrize("source,name,mirror", [
    ("ploc_finish.cu", "kCtas", lambda: ploc_round.FIN_CTAS),
    ("ploc_finish.cu", "kOneCtaAt", lambda: ploc_round.FIN_ONE_CTA),
    ("ploc_finish.cu", "kMaxCap", lambda: ploc_round.FIN_CAP),
    ("ploc_round.cu", "kTile", lambda: ploc_round._EMIT_TILE),
    ("ploc_nn.cu", "kThreads", lambda: ploc_nn.THREADS),
    ("ploc_nn.cu", "kLanes", lambda: ploc_nn.LANES),
    ("ploc_common.cuh", "kMaxR", lambda: ploc_nn.MAX_RADIUS),
    ("ploc_round_fused.cu", "kThreads", lambda: ploc_round._EMIT_BLOCK),
    ("raster.cu", "kChunk", lambda: raster_gpu.CHUNK),
    ("ray_sweep.cu", "kChunk", lambda: ray_sweep.CHUNK),
    ("refit_dense.cu", "kTile", lambda: refit_dense.TILE),
    ("refit_dense.cu", "kMaxHalo", lambda: refit_dense.MAX_RADIUS),
    ("refit_long.cu", "kBlock", lambda: refit.BLOCK),
    ("refit_long.cu", "kLocal", lambda: refit.LOCAL_LEVELS),
    ("refit_long.cu", "kMaxSuper", lambda: refit.MAX_SUPER),
    ("refit_long.cu", "kMaxBlocks", lambda: refit.MAX_BLOCKS),
    ("collapse_block.cu", "kTile", lambda: collapse_block.TILE),
    ("collapse_block.cu", "kHalo", lambda: collapse_block.HALO),
    ("collapse_block.cu", "kSLen", lambda: collapse_block.S_LEN),
    ("collapse_block.cu", "kErrChain", lambda: collapse_block.ERR_CHAIN),
    ("collapse_block.cu", "kErrWindow", lambda: collapse_block.ERR_WINDOW),
    ("psv_scan.cuh", "kTile", lambda: threshold_core.TILE),
    ("psv_scan.cuh", "kV", lambda: threshold_core.V),
    ("plane_scan.cu", "kRows", lambda: plane_scan.TILE_ROWS),
    ("plane_scan.cu", "kCols", lambda: plane_scan.COLS),
    ("batched_build.cu", "kMaxPrims", lambda: batched_build.MAX_PRIMS),
    ("batched_build.cu", "kWalkMax", lambda: batched_build.WALK_MAX),
    ("batched_block.cu", "kMinPrims", lambda: batched_block.MIN_PRIMS),
    ("batched_block.cu", "kMaxPrims", lambda: batched_block.MAX_PRIMS),
    ("batched_block.cu", "kRadius", lambda: batched_block.RADIUS),
    ("traverse.cu", "kStackDepth", lambda: traverse.STACK_DEPTH),
    ("traverse.cu", "kBlock", lambda: traverse.BLOCK),
    ("traverse.cu", "kSmallBlock", lambda: traverse.SMALL_BLOCK),
    ("traverse.cu", "kFetch", lambda: traverse.FETCH),
    ("traverse.cu", "kStats", lambda: traverse.STATS),
])
def test_python_mirror_equals_source(source, name, mirror):
    assert mirror() == _constexpr(source, name)


def test_finisher_width_is_its_slices():
    assert ploc_round.MAX_FIN_WIDTH == ploc_round.FIN_CTAS * ploc_round.FIN_CAP
    assert ploc_round.FIN_ONE_CTA <= ploc_round.FIN_CAP


def test_traversal_block_is_whole_warps():
    """The traversal sums its counters over whole warps, then the block."""
    assert traverse.BLOCK % 32 == 0 and traverse.SMALL_BLOCK % 32 == 0 and traverse.FETCH >= 1


def test_ploc_nn_tile_is_its_columns_less_three_halos():
    """B10's block holds COLS = THREADS x LANES table columns and writes
    TILE = COLS - 3 kMaxR lanes, as the source derives kCols and kTile."""
    with open(os.path.join(kernels.CSRC, "ploc_nn.cu")) as f:
        src = f.read()
    assert "constexpr int kCols = kThreads * kLanes;" in src
    assert "constexpr int kTile = kCols - 3 * ploc::kMaxR;" in src
    assert ploc_nn.COLS == ploc_nn.THREADS * ploc_nn.LANES
    assert ploc_nn.TILE == ploc_nn.COLS - 3 * ploc_nn.MAX_RADIUS
