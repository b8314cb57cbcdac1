"""The port's batched builder past 64 prims a mesh (`models.batched.
build_batched` at 64 < M <= 1024, `ops.batched_block`) against JAX's
(`tpu_bvh.models.batched.build_batched`, the vmapped single-pass build)
on the CPU, byte for byte, and a plain emulation of the card's kernel
(`csrc/batched_block.cu`) against the plain version.

The emulation follows the kernel's schedule for one block of T threads a
mesh (T the power of two from 128 that holds M): the boxes and the scene
box reduced as min_keys (in each warp, then over the warps), the codes,
the bitonic network over the 64-bit keys (code << 10) | prim with ~0 past
the mesh (a compare-exchange with thread t ^ j), each sorted leaf re-boxed
from its prim, the deltas from the next sorted code, the u16 sparse table
of (delta << 10) | j whose unwritten entries hold 0 (any read of one would
change the tree), the binary descents to psv and nsv, the children as two
table reads each, the parents scattered by the children, and the refit as
leaf threads that climb while they are the second to arrive at a parent,
stepped one at a time in a chosen order (each second arrival must find
its sibling's keys written); then the 3e38 rule of JAX's refit at radius
16 and the root as the least root boundary.

Floats are compared by their bytes: `torch.equal` and
`np.testing.assert_array_equal` take -0.0 for +0.0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_tris
from tests.test_torch_signed_zero import signed_zero_soup
from tpu_bvh.models import batched as jbatched
from tpu_bvh_torch.models import batched
from tpu_bvh_torch.ops import aabb, batched_block, batched_build, morton, refit
from tpu_bvh_torch.types import Bvh2
from tpu_bvh_torch.utils import kernels, scenes, validate

I64 = torch.int64
INT_MAX = 2**31 - 1
NO_KEY = 2**63 - 1  # a padding thread's key: ~0, above every real key
B = 4  # meshes a batch: one JAX compile a capacity


def _meshes(case):
    """(list of [n, 3, 3] f32 meshes, capacity) for each named input: the
    capacity is the number at the end of the name; every batch has B
    meshes, padding in all but the first."""
    name = case.rstrip("0123456789")
    cap = int(case[len(name):])
    rng = np.random.default_rng(sum(map(ord, case)))
    sizes = [cap, *(int(n) for n in rng.integers(2, cap, size=B - 2)), 2]
    if name == "random":
        return [random_tris(rng, n) for n in sizes], cap
    if name == "cornellbox":  # the demo's mesh (36 prims) and its halves, padded
        box = scenes.cornellbox()
        return [box, box[:18], box[18:], box[:2]], cap
    if name == "signed_zero":  # the +-0 soup cut into meshes
        soup = signed_zero_soup(n=B * cap, seed=cap)
        return [soup[k * cap:k * cap + n] for k, n in enumerate(sizes)], cap
    if name == "one_tri":  # one triangle repeated: every code equal
        tri = random_tris(rng, 1)
        return [np.repeat(tri, n, axis=0) for n in sizes[:-1]] + [random_tris(rng, 2)], cap
    if name == "duplicates":  # a few triangles, each repeated
        return [np.repeat(random_tris(rng, k), n // k, axis=0) for k, n in
                zip((1, 3, 7, 2), sizes)], cap
    if name == "huge":  # x near FLT_MAX: the 3e38 rule of each node's box shows in row 0
        out = [random_tris(rng, n) for n in sizes]
        y = np.float32(0.97) ** np.arange(cap, dtype=np.float32)  # a geometric run: long nodes
        out[0][..., 1] = y[:, None]
        for t in out:
            t[..., 0] = rng.uniform(3.1e38, 3.35e38, size=t.shape[:2])
        return out, cap
    raise ValueError(case)


CASES = ["random65", "random96", "random128", "random257", "random1024", "cornellbox65",
         "signed_zero128", "signed_zero1024", "one_tri96", "one_tri1024", "duplicates128",
         "huge300", "huge1024"]


def _padded(case):
    meshes, cap = _meshes(case)
    return jbatched.pad_meshes(meshes, cap)


def _assert_same_bytes(got, want):
    for f in Bvh2._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("case", CASES)
def test_build_batched_equals_jax(case):
    """build_batched's plain route, every field byte for byte against the
    vmapped single-pass build, and every tree valid."""
    tris_b, _ = _padded(case)
    if case.startswith("signed_zero"):
        zeros = tris_b[tris_b == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    before = kernels.launches["batched_block"]
    got = batched.build_batched(torch.from_numpy(tris_b))
    assert kernels.launches["batched_block"] == before  # a CPU tensor takes the plain version
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))
    for b in range(B):
        one = Bvh2(*(f[b] for f in got))
        assert validate.check_bvh2_correctness(one, one.n_leaves), b
        assert validate.check_root_aabb(one), b


def test_huge_meshes_take_both_refit_paths(monkeypatch):
    """At M = 1024 the huge batch holds a mesh whose long nodes exceed the
    budget (the exact full table: its geometric run) and one within it
    (the 3e38 fill), so
    `test_build_batched_equals_jax[huge1024]` holds both."""
    seen = []
    clamped = batched_block._clamped

    def spy(first, last):
        out = clamped(first, last)
        i = torch.arange(first.shape[1], dtype=torch.int32)
        long = ~((i - first < batched_block.RADIUS) & (last - i <= batched_block.RADIUS))
        seen.extend(long.sum(1).tolist())
        return out

    monkeypatch.setattr(batched_block, "_clamped", spy)
    batched_block.batched_block_reference(torch.from_numpy(_padded("huge1024")[0]))
    cap = max(64, 4 * 1023 // (3 * batched_block.RADIUS))
    assert any(n > cap for n in seen) and any(n <= cap for n in seen), (seen, cap)


@pytest.mark.parametrize("cap", [batched_build.MAX_PRIMS, batched_block.MAX_PRIMS + 1])
def test_batched_block_refuses_a_capacity_outside_its_range(cap):
    tris_b = torch.zeros((1, cap, 3, 3))
    for fn in (batched_block.batched_block, batched_block.batched_block_reference):
        with pytest.raises(ValueError, match="65 <= M <= 1024"):
            fn(tris_b)


def test_build_batched_past_the_block_capacity_equals_jax():
    """M = 1025 builds each mesh with the single-pass build, as JAX's
    vmapped path does."""
    rng = np.random.default_rng(1025)
    tris_b, _ = jbatched.pad_meshes([random_tris(rng, 1025), random_tris(rng, 300)], 1025)
    before = kernels.launches["batched_block"]
    got = batched.build_batched(torch.from_numpy(tris_b))
    assert kernels.launches["batched_block"] == before
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))


def test_empty_batch_in_the_block_range_equals_jax():
    tris_b = np.zeros((0, 200, 3, 3), np.float32)
    got = batched.build_batched(torch.from_numpy(tris_b))
    assert got.packed_t.shape == (0, 6, 399) and got.root.shape == (0,)
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))


def test_plain_version_folds_the_batch_in_chunks(monkeypatch):
    """The plain version's chunks (FOLD_ROWS rows of the folded topology)
    do not change its trees."""
    tris_b = torch.from_numpy(_padded("random128")[0])
    whole = batched_block.batched_block_reference(tris_b)
    monkeypatch.setattr(batched_block, "FOLD_ROWS", 128)  # one mesh a chunk
    for g, w in zip(batched_block.batched_block_reference(tris_b), whole):
        assert g.numpy().tobytes() == w.numpy().tobytes()


# -- the kernel's schedule ---------------------------------------------------

def _climb(par, kids, leaf_keys, m, order, rng):
    """Phase 4 of one mesh: each leaf's thread climbs while it is the
    second to arrive at a parent (an atomicAdd on the parent's count), one
    step at a time in `order` ("random", "forward": the lowest live thread
    first, "reverse": the highest). Returns the internal nodes' keys
    i64[6, m]; asserts that each second arrival finds its sibling's keys
    and that every node is written once."""
    M = m + 1
    s_int = np.zeros((6, m), np.int64)
    written = np.zeros(m, bool)
    count = np.zeros(m, np.int64)
    state = {t: (m + t, leaf_keys[:, t].copy()) for t in range(M)}
    live = list(range(M))
    while live:
        k = {"random": lambda: int(rng.integers(len(live))), "forward": lambda: 0,
             "reverse": lambda: len(live) - 1}[order]()
        t = live[k]
        x, v = state[t]
        p = par[x]
        if p < 0:  # the root
            live.pop(k)
            continue
        count[p] += 1
        if count[p] == 1:  # the first to arrive: the sibling's thread goes on
            live.pop(k)
            continue
        sib = kids[1][p] if kids[0][p] == x else kids[0][p]
        if sib >= m:
            w = leaf_keys[:, sib - m]
        else:
            assert written[sib], f"node {p}: sibling {sib} not yet written"
            w = s_int[:, sib]
        assert not written[p]
        v = np.minimum(v, w)
        s_int[:, p] = v
        written[p] = True
        state[t] = (p, v)
    assert written.all()
    return s_int


def emulate_block_kernel(tris_b, order="random", seed=0):
    """`csrc/batched_block.cu` step by step on the CPU: [B, T] tensors over
    a block's threads."""
    nb, M = tris_b.shape[:2]
    m = M - 1
    T = 128
    while T < M:
        T *= 2
    L = T.bit_length() - 1
    t = torch.arange(T, dtype=I64)
    in_mesh = t < M

    # 1. prim boxes (thread t holds prim t) and the scene box, warp then block
    v = tris_b[:, t.clamp(max=m)]  # [nb, T, vertex, axis]
    mn = aabb.fmin(aabb.fmin(v[:, :, 0], v[:, :, 1]), v[:, :, 2])
    mx = aabb.fmax(aabb.fmax(v[:, :, 0], v[:, :, 1]), v[:, :, 2])
    kb = torch.where(in_mesh[None, :, None], aabb.min_key(torch.cat([mn, -mx], 2)), INT_MAX)
    scene = kb.reshape(nb, T // 32, 32, 6).amin(2).amin(1)  # [nb, 6]
    smin = aabb.from_min_key(scene[:, :3])
    ext = -aabb.from_min_key(scene[:, 3:]) - smin
    safe = torch.where(ext > 0, ext, 1.0)
    p = ((mn + mx) * 0.5 - smin[:, None]) / safe[:, None]
    code = morton.morton30_cols(p[..., 0], p[..., 1], p[..., 2])

    # 2. the bitonic network, the kernel's loops; the sorted leaves and deltas
    key0 = torch.where(in_mesh, (code << 10) | t, NO_KEY)
    key = key0
    size = 2
    while size <= T:
        j = size // 2
        while j > 0:
            other = key[:, t ^ j]  # a shuffle, or the double buffer past the warp
            keep_min = ((t & j) == 0) == ((t & size) == 0)
            key = torch.where((key < other) == keep_min, key, other)
            j //= 2
        size *= 2
    assert torch.equal(key, torch.sort(key0, dim=1).values)
    prim = (key & 1023).clamp(max=m)
    w = tris_b[torch.arange(nb)[:, None], prim]  # the staged prim, re-boxed
    leaf = torch.cat([aabb.fmin(aabb.fmin(w[:, :, 0], w[:, :, 1]), w[:, :, 2]),
                      -aabb.fmax(aabb.fmax(w[:, :, 0], w[:, :, 1]), w[:, :, 2])], 2)
    leaf = leaf.transpose(1, 2)  # [nb, 6, T]
    scode = key >> 10
    nxt = scode[:, (t + 1).clamp(max=T - 1)]
    x = scode ^ nxt
    raw = torch.where(x != 0, 32 - torch.frexp(x.double()).exponent,
                      64 - torch.frexp((t ^ (t + 1)).double()).exponent)
    d = torch.where(t < m, torch.where(raw <= 31, raw - 2, raw - 11), 0).to(I64)

    # 3. the u16 table (unwritten entries 0), psv / nsv, children, parents
    tab = [torch.where(t < m, (d << 10) | t, 0)]
    for k in range(1, L):
        prev = tab[-1]
        shifted = prev[:, (t + (1 << (k - 1))).clamp(max=T - 1)]
        tab.append(torch.where(t + (1 << k) <= m, torch.minimum(prev, shifted), 0))
    assert all(int(x.max()) < 1 << 16 for x in tab)

    tabs = torch.stack(tab)  # [L, nb, T]

    def at(k, idx):
        return tabs[k, torch.arange(nb)[:, None].expand(-1, T), idx.clamp(0, T - 1)]

    thr = d << 10
    first = t.expand(nb, T).clone()
    for k in range(L - 1, -1, -1):
        q = first - (1 << k)
        ok = (q >= 0) & (at(torch.full_like(q, k), q) >= thr)
        first = torch.where(ok, q, first)
    last = (t + 1).expand(nb, T).clone()
    for k in range(L - 1, -1, -1):
        ok = (last + (1 << k) <= m) & (at(torch.full_like(last, k), last) >= thr)
        last = torch.where(ok, last + (1 << k), last)

    def argmin(a, z):
        ln = (z - a + 1).clamp(min=1)
        k = (torch.frexp(ln.double()).exponent - 1).to(I64)
        return torch.minimum(at(k, a), at(k, z - (1 << k) + 1)) & 1023

    bnd = t < m
    lnode = torch.where(first <= t - 1, argmin(first, t - 1), m + t)
    rnode = torch.where(t + 1 <= last - 1, argmin(t + 1, last - 1), m + t + 1)
    is_root = bnd & (first == 0) & (last == m)
    root = torch.where(is_root, t, INT_MAX).amin(1)
    root = torch.where(root == INT_MAX, 0, root)
    is_long = bnd & ~((t - first < batched_block.RADIUS) & (last - t <= batched_block.RADIUS))
    has_mid = (((last + 1) >> 4) - 1) >= ((first + 15) >> 4)
    n_long = is_long.sum(1, keepdim=True)
    cap = min(m, max(64, (4 * m) // (3 * batched_block.RADIUS)))
    clamp = (~is_long | ~has_mid) & ~((cap < m) & (n_long > cap))

    # 4. the climb, mesh by mesh
    rng = np.random.default_rng(seed)
    leaf_keys = aabb.min_key(leaf)
    int_keys = torch.zeros((nb, 6, m), dtype=torch.int32)
    for b in range(nb):
        par = np.full(2 * T, -1, np.int64)
        ln, rn = lnode[b, :m].numpy(), rnode[b, :m].numpy()
        par[ln] = np.arange(m)
        par[rn] = np.arange(m)
        int_keys[b] = torch.from_numpy(
            _climb(par, (ln, rn), leaf_keys[b, :, :M].numpy().astype(np.int64), m, order, rng))

    # 5. the outputs
    big = int(aabb.min_key(torch.tensor(refit.BIG)))
    boxes = torch.where(clamp[:, None, :m], int_keys.clamp(max=big), int_keys)
    i32 = torch.int32
    packed_t = torch.cat([aabb.from_min_key(boxes), leaf[:, :, :M]], dim=2)
    left = torch.cat([lnode[:, :m], key[:, :M] & 1023], 1).to(i32)
    right = torch.cat([rnode[:, :m], torch.full((nb, M), -1, dtype=I64)], 1).to(i32)
    return Bvh2(packed_t, left, right, root.to(i32))


@pytest.mark.parametrize("case, order", [(c, "random") for c in CASES] + [
    (c, o) for c in ("random1024", "one_tri96", "huge1024") for o in ("forward", "reverse")])
def test_block_schedule_equals_plain(case, order):
    tris_b = torch.from_numpy(_padded(case)[0])
    got = emulate_block_kernel(tris_b, order)
    want = batched_block.batched_block_reference(tris_b)
    for f, g, w in zip(Bvh2._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.numpy().tobytes() == w.numpy().tobytes(), f
