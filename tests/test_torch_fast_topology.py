"""The gather-free topologies and their search-based oracles: the port's
`apetrei_topology_fast`, `karras_topology_fast`, `apetrei_topology`,
`karras_topology` and `_threshold_core` equal `tpu_bvh`'s bit for bit on
the cases of tests/test_fast_topology.py and on sponza_like(8192)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bvh.ops import radix_tree as jradix
from tpu_bvh_torch.models import lbvh
from tpu_bvh_torch.ops import radix_tree
from tpu_bvh_torch.utils import scenes


def _codes(n, seed, bits=30):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 2**bits, size=n).astype(np.uint32))


CASES = {
    "2": lambda: _codes(2, 0),
    "3": lambda: _codes(3, 1),
    "64": lambda: _codes(64, 2),
    "257": lambda: _codes(257, 3),
    "400_dups": lambda: _codes(400, 4, bits=4),
    "100_equal": lambda: np.zeros(100, np.uint32),
    "sponza_8192": lambda: lbvh._sorted_leaves_from_tris(
        torch.from_numpy(scenes.sponza_like(8192)), True)[0].numpy().astype(np.uint32),
}
FUNCS = ["apetrei_topology_fast", "karras_topology_fast", "apetrei_topology",
         "karras_topology", "_threshold_core"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", FUNCS)
def test_topology_matches_jax(fn, case):
    codes = CASES[case]()
    jfn = getattr(jradix, fn)
    if fn != "karras_topology":  # its unrolled searches compile slower than they run
        jfn = jax.jit(jfn)
    want = jfn(jnp.asarray(codes))
    got = getattr(radix_tree, fn)(torch.from_numpy(codes.astype(np.int64)))
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{fn} output {k}")


@pytest.mark.parametrize("case", ["257", "400_dups", "sponza_8192"])
def test_fast_topologies_match_the_builders_route(case):
    """The fast topologies equal B1's route: `apetrei_build_packed_full`'s
    (left, right, parent, first, last, root) and `karras_build_packed`'s
    (left, right)."""
    codes = torch.from_numpy(CASES[case]().astype(np.int64))
    leaves = torch.zeros((6, codes.shape[0]), dtype=torch.float32)
    left, right, parent, _, root, first, last = radix_tree.apetrei_build_packed_full(codes, leaves)
    for g, w in zip(radix_tree.apetrei_topology_fast(codes), (left, right, parent, first, last,
                                                              root)):
        assert torch.equal(g, w)
    kl, kr, _ = radix_tree.karras_build_packed(codes, leaves)
    fast = radix_tree.karras_topology_fast(codes)
    assert torch.equal(fast[0], kl) and torch.equal(fast[1], kr)
