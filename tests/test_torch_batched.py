"""The port's batched builder (`tpu_bvh_torch.models.batched`) against JAX's
(`tpu_bvh.models.batched`) on the CPU, byte for byte, and a plain-torch
emulation of the card's kernel (`csrc/batched_build.cu`) against the plain
version.

The emulation follows the kernel's schedule for one warp a mesh, slot
k = e * 32 + lane (one slot a lane up to 32 prims, two up to 64): the
boxes and the scene box reduced as min_keys, the codes, the bitonic
network over the 64-bit keys (code << 6) | prim with ~0 in the padding
slots (a compare-exchange with slot k ^ j: a shuffle, or the lane's other
slot at j = 32), the deltas from the next slot's code, the six ballots
of the deltas' bit planes, each boundary's comparator mask of smaller
deltas and its psv / nsv as the highest / lowest set bit (`__clzll`,
`__ffsll`), the children as bit-sliced argmins, the root as the lowest bit
of a ballot, and the refit: up to WALK_MAX prims a walk over each node's
leaves, past it (two slots a lane) two tables built by shuffles over the
sorted leaves' keys (each leaf's min from the start of its block of 8
slots and to its end, and a min table over the blocks): a range across
blocks is the suffix of its first block, the prefix of its last and two
windows over the blocks between, a range inside one block a walk; with
the key of 3e38 where the range is not the whole mesh.

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
from tpu_bvh_torch.ops import aabb, batched_build, morton, radix_tree, scan32
from tpu_bvh_torch.types import MAX_BATCHED_PRIMS, Bvh2
from tpu_bvh_torch.utils import convert, kernels, scenes, validate

I64 = torch.int64
INT_MAX = 2**31 - 1
NO_KEY = 2**63 - 1  # a padding slot's key: ~0, above every real key


def _meshes(case):
    """(list of [n, 3, 3] f32 meshes, capacity) for each named input."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("random"):
        cap = int(case[len("random"):])
        return [random_tris(rng, int(n)) for n in rng.integers(2, cap + 1, size=16)], cap
    if case == "cornellbox_x8":  # the demo's mesh (its own size: 36 prims)
        box = scenes.cornellbox()
        return [box] * 8, box.shape[0]
    if case.startswith("signed_zero"):  # the +-0 soup cut into meshes
        cap = int(case[len("signed_zero"):])
        return list(signed_zero_soup().reshape(-1, cap, 3, 3)), cap
    if case == "one_point":  # every prim of a mesh at one point
        pts = rng.uniform(-5, 5, size=(12, 1, 1, 3)).astype(np.float32)
        pts[0] = 0.0
        pts[1] = -0.0
        sizes = rng.integers(1, 33, size=12)
        return [np.broadcast_to(p, (n, 3, 3)).copy() for p, n in zip(pts, sizes)], 32
    if case == "duplicates":  # a few triangles, each repeated
        out = []
        for k in (1, 2, 3, 5):
            tris = random_tris(rng, k)
            out += [np.repeat(tris, 48 // k, axis=0), np.tile(tris, (60 // k, 1, 1))]
        return out, 64
    if case == "huge":  # coordinates near FLT_MAX: the 3e38 fill of a node's box shows
        return [rng.uniform(3.1e38, 3.35e38, size=(int(n), 3, 3)).astype(np.float32)
                for n in rng.integers(2, 33, size=8)], 32
    if case == "m2":
        return [random_tris(rng, 2), random_tris(rng, 1), np.repeat(random_tris(rng, 1), 2, 0)], 2
    raise ValueError(case)


CASES = ["random32", "random33", "random64", "cornellbox_x8", "signed_zero32",
         "signed_zero64", "one_point", "duplicates", "huge", "m2"]


def _padded(case):
    meshes, cap = _meshes(case)
    return jbatched.pad_meshes(meshes, cap)


def _assert_same_bytes(got, want):
    for f in Bvh2._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


def _assert_valid(trees):
    for b in range(trees.root.shape[0]):
        one = Bvh2(*(f[b] for f in trees))
        assert validate.check_bvh2_correctness(one, one.n_leaves), b
        assert validate.check_root_aabb(one), b


@pytest.mark.parametrize("cap", [MAX_BATCHED_PRIMS, 64])
def test_pad_meshes_equals_jax(cap):
    meshes, _ = _meshes("random32")
    want = jbatched.pad_meshes(meshes, cap)
    got = batched.pad_meshes(meshes, cap, device="cpu")
    assert got[0].numpy().tobytes() == want[0].tobytes() and got[0].shape == want[0].shape
    assert got[1].numpy().tobytes() == want[1].tobytes() and got[1].dtype == torch.int32


def test_pad_meshes_refuses_a_mesh_past_the_capacity():
    with pytest.raises(ValueError, match="33 > 32"):
        batched.pad_meshes([random_tris(np.random.default_rng(0), 33)], 32, device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_build_batched_equals_jax(case):
    """The dense path's plain version, every field byte for byte, and every
    tree valid."""
    tris_b, _ = _padded(case)
    if case.startswith("signed_zero"):
        zeros = tris_b[tris_b == 0]
        assert np.signbit(zeros).any() and (~np.signbit(zeros)).any()
    before = kernels.launches["batched_build"]
    got = batched.build_batched(torch.from_numpy(tris_b))
    assert kernels.launches["batched_build"] == before  # a CPU tensor takes the plain version
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))
    _assert_valid(got)


def test_build_batched_wide_meshes_equal_jax():
    """Capacity 96 > 64 takes the block kernel's plain version
    (`ops/batched_block.py`), the contract of JAX's vmapped single-pass
    path."""
    rng = np.random.default_rng(96)
    tris_b, _ = jbatched.pad_meshes([random_tris(rng, int(n)) for n in (96, 70, 2)], 96)
    got = batched.build_batched(torch.from_numpy(tris_b))
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))
    _assert_valid(got)


def test_one_prim_meshes_are_refused_as_jax_refuses_them():
    tris_b = np.ones((2, 1, 3, 3), np.float32)
    with pytest.raises(ValueError):
        jbatched.build_batched(jnp.asarray(tris_b))
    with pytest.raises(ValueError, match="2 <= M <= 64"):
        batched.build_batched(torch.from_numpy(tris_b))


def test_empty_batch_equals_jax():
    tris_b = np.zeros((0, 4, 3, 3), np.float32)
    _assert_same_bytes(batched.build_batched(torch.from_numpy(tris_b)),
                       jbatched.build_batched(jnp.asarray(tris_b)))


def test_empty_batch_past_the_dense_capacity_equals_jax():
    """B = 0 at M = 96 (the per-mesh path) has JAX's empty shapes: packed_t
    f32[0, 6, 191], left and right i32[0, 191], root i32[0]."""
    tris_b = np.zeros((0, 96, 3, 3), np.float32)
    got = batched.build_batched(torch.from_numpy(tris_b))
    assert got.packed_t.shape == (0, 6, 191) and got.root.shape == (0,)
    _assert_same_bytes(got, jbatched.build_batched(jnp.asarray(tris_b)))


def test_dense_build_refuses_a_capacity_past_its_limit():
    tris_b = torch.zeros((1, batched_build.MAX_PRIMS + 1, 3, 3))
    for fn in (batched_build.batched_build, batched_build.batched_build_reference):
        with pytest.raises(ValueError, match="2 <= M <= 64"):
            fn(tris_b)


def test_to_torch_carries_a_batch_stacked_bvh2():
    tris_b, _ = _padded("random32")
    want = jbatched.build_batched(jnp.asarray(tris_b))
    got = convert.to_torch(Bvh2, want, device="cpu")
    assert got.root.shape == (16,) and got.packed_t.shape == (16, 6, 63)
    _assert_same_bytes(got, want)


# -- the kernel's schedule ---------------------------------------------------

def _bit_index(x, highest):
    """Index of the highest (`__clzll`) or lowest (`__ffsll`) set bit of
    each i64 mask, -1 for 0."""
    bits = torch.arange(64, dtype=I64)
    on = ((x[..., None] >> bits) & 1) == 1
    if highest:
        return torch.where(on, bits, -1).amax(-1)
    return torch.where(on, bits, 64).amin(-1).masked_fill(x == 0, -1)


def _argmin(c, planes):
    """The kernel's `argmin`: the earliest argmin of the deltas over the
    boundaries in mask c, from the top bit plane down."""
    for bit in range(5, -1, -1):
        z = c & ~planes[bit]
        c = torch.where(z != 0, z, c)
    return _bit_index(c, highest=False)


def emulate_kernel(tris_b):
    """`csrc/batched_build.cu` step by step on the CPU: [B, N] tensors over a
    warp's slots, N = 32 * E."""
    B, M = tris_b.shape[:2]
    m = M - 1
    N = 32 if M <= 32 else 64
    k = torch.arange(N, dtype=I64)  # slot e * 32 + lane
    lane, elem = k % 32, k // 32
    prim_ok = k < M

    # 1. prim boxes (slot k holds prim k) and the scene box over the warp
    v = tris_b[:, k.clamp(max=m)]  # [B, N, vertex, axis]
    mn = aabb.fmin(aabb.fmin(v[:, :, 0], v[:, :, 1]), v[:, :, 2])
    mx = aabb.fmax(aabb.fmax(v[:, :, 0], v[:, :, 1]), v[:, :, 2])
    rows = torch.cat([mn, -mx], dim=2).transpose(1, 2)  # [B, 6, N]: s_row, by prim
    keep = prim_ok[None, :, None]
    smin = aabb.from_min_key(torch.where(keep, aabb.min_key(mn), INT_MAX).amin(1))
    smax = -aabb.from_min_key(torch.where(keep, aabb.min_key(-mx), INT_MAX).amin(1))
    ext = smax - smin
    safe = torch.where(ext > 0, ext, 1.0)
    p = ((mn + mx) * 0.5 - smin[:, None]) / safe[:, None]
    code = morton.morton30_cols(p[..., 0], p[..., 1], p[..., 2])

    # 2. the bitonic network, the kernel's loops
    key0 = torch.where(prim_ok, (code << 6) | k, NO_KEY)
    key = key0
    size = 2
    while size <= N:
        j = size // 2
        while j > 0:
            other = key[:, k ^ j]  # __shfl_xor_sync, or the lane's other slot at j = 32
            keep_min = ((k & j) == 0) == ((k & size) == 0)
            key = torch.where((key < other) == keep_min, key, other)
            j //= 2
        size *= 2
    assert torch.equal(key, torch.sort(key0, dim=1).values)

    # 3. sorted leaves, deltas, bit planes, ranges and children
    prim = key & 63
    leaf = rows.gather(2, prim.clamp(max=m)[:, None, :].expand(B, 6, N))
    leaf_keys = aabb.min_key(leaf)  # s_key, by sorted leaf
    scode = (key >> 6) & 0xFFFFFFFF
    nxt = scode[:, (k + 1).clamp(max=N - 1)]  # __shfl_down_sync; lane 31 <- next row's lane 0
    x = scode ^ nxt
    raw = torch.where(x != 0, radix_tree._clz32(x), 32 + radix_tree._clz32(k ^ (k + 1)))
    dlt = scan32.remap_deltas(raw).to(I64)
    bnd = k < m
    planes = []
    for bit in range(6):
        ballots = torch.where(bnd & (((dlt >> bit) & 1) == 1), 1 << lane, 0)
        planes.append(sum(ballots[:, elem == e].sum(1) << (32 * e) for e in range(N // 32)))
    planes = [pl[:, None] for pl in planes]
    lt = torch.zeros_like(dlt)
    eq = torch.full_like(dlt, (1 << m) - 1)
    for bit in range(5, -1, -1):
        on = ((dlt >> bit) & 1) == 1
        lt = torch.where(on, lt | (eq & ~planes[bit]), lt)
        eq = torch.where(on, eq & planes[bit], eq & ~planes[bit])
    below = (1 << k) - 1
    above = ~((2 << k) - 1)
    before, after = lt & below, lt & above
    first = torch.where(before != 0, _bit_index(before, highest=True) + 1, 0)
    last = torch.where(after != 0, _bit_index(after, highest=False), m)
    lc = _argmin(below & ~((1 << first) - 1), planes)
    rc = _argmin(above & ((1 << last) - 1), planes)
    root_ballot = torch.where(bnd & (first == 0) & (last == m), 1 << k, 0).sum(1)
    root = _bit_index(root_ballot, highest=False)

    # 4. refit, past WALK_MAX prims (two slots a lane): in-block prefix and
    # suffix mins of the sorted leaves' keys
    # (blocks of 8 slots; three shuffles within groups of 8 lanes) and a min
    # table over the blocks, whose unwritten entries hold 0 (a read of one
    # would change the tree); a range across blocks is the suffix of its
    # first, the prefix of its last and two windows over the blocks between,
    # a range inside one block a walk
    NB = N // 8
    kv = torch.where(prim_ok[None, None, :], leaf_keys, INT_MAX)  # [B, 6, N]
    sub = k % 8
    pre, suf = kv, kv
    for d in (1, 2, 4):
        up = pre[:, :, (k - d).clamp(min=0)]  # __shfl_up_sync(.., d, 8)
        dn = suf[:, :, (k + d).clamp(max=N - 1)]  # __shfl_down_sync(.., d, 8)
        pre = torch.where(sub >= d, torch.minimum(pre, up), pre)
        suf = torch.where(sub + d < 8, torch.minimum(suf, dn), suf)
    x = torch.arange(NB)
    blk = [suf[:, :, ::8]]  # [B, 6, NB]: each block's min
    for lvl in (1, 2):
        prev = blk[-1]
        nxt = prev[:, :, (x + (1 << (lvl - 1))).clamp(max=NB - 1)]
        blk.append(torch.where(x + (1 << lvl) <= NB, torch.minimum(prev, nxt), 0))
    blk = torch.stack(blk)  # [3, B, 6, NB]

    def gather(t, idx):  # t [B, 6, n] at idx [B, N]
        return t.gather(2, idx.clamp(0, t.shape[2] - 1)[:, None, :].expand(B, 6, N))

    bf, bl = first >> 3, last >> 3
    cross = torch.minimum(gather(suf, first), gather(pre, last))
    a, z = bf + 1, bl - 1
    kk = (torch.frexp((z - a + 1).clamp(min=1).double()).exponent - 1).long()
    bi = torch.arange(B)[:, None, None]
    ri = torch.arange(6)[None, :, None]
    k3 = kk[:, None, :]
    mid = torch.minimum(blk[k3, bi, ri, a.clamp(0, NB - 1)[:, None, :]],
                        blk[k3, bi, ri, (z - (1 << kk) + 1).clamp(0, NB - 1)[:, None, :]])
    cross = torch.where((bl - bf >= 2)[:, None], torch.minimum(cross, mid), cross)
    walk = torch.full((B, 6, N), INT_MAX, dtype=torch.int32)
    for t in range(N):  # the walk over each range
        inside = ((first <= t) & (t <= last))[:, None, :]
        walk = torch.where(inside, torch.minimum(walk, leaf_keys[:, :, t:t + 1]), walk)
    acc = torch.where((bf == bl)[:, None], walk, cross)
    if N == 32 or M <= batched_build.WALK_MAX:  # one slot a lane or short meshes: the walk
        acc = walk
    fill = torch.where(last - first + 1 < M, aabb.min_key(torch.tensor(3.0e38)), INT_MAX)
    box = aabb.from_min_key(torch.minimum(acc, fill[:, None, :].to(torch.int32)))

    # 5. the outputs
    i32 = torch.int32
    j = k[:m]
    packed_t = torch.cat([box[:, :, :m], leaf[:, :, :M]], dim=2)
    left = torch.cat([torch.where(lc[:, :m] >= 0, lc[:, :m], m + j), prim[:, :M]], 1).to(i32)
    right = torch.cat([torch.where(rc[:, :m] >= 0, rc[:, :m], m + j + 1),
                       torch.full((B, M), -1, dtype=I64)], 1).to(i32)
    return Bvh2(packed_t, left, right, root.to(i32))


@pytest.mark.parametrize("case", CASES + ["random3", "random31", "random48", "random49",
                                          "random63"])
def test_kernel_schedule_equals_plain(case):
    tris_b = torch.from_numpy(_padded(case)[0])
    got = emulate_kernel(tris_b)
    want = batched._build_batched_small(tris_b)
    for f in Bvh2._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.numpy().tobytes() == w.numpy().tobytes(), f
