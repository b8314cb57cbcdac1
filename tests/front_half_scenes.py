"""Triangle soups (numpy f32[n, 3, 3]) for the front half's tests, on the
CPU against JAX and on the card against the plain version: scenes whose
extents lead the extended Morton code down each of its paths, signed
zeros, a NaN vertex, and sizes around the kernels' tiles."""
import numpy as np

from tpu_bvh_torch.utils import scenes


def in_box(ext, n=2048, seed=0):
    """n random triangles in [0, ext]; triangle 0 spans the box, so the
    scene's extent is ext exactly."""
    rng = np.random.default_rng(seed)
    e = np.asarray(ext, np.float32)
    tris = (rng.random((n, 3, 3), dtype=np.float32) * e).astype(np.float32)
    tris[0] = [np.zeros(3, np.float32), e, np.zeros(3, np.float32)]
    return tris


def soup(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 3, 3)).astype(np.float32)


def signed_zeros(n=2048, seed=2):
    """Coordinates from {-0.0, +0.0, 0.25, 0.5}: both zeros in the
    vertices and at the scene's minimum on every axis."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.array([-0.0, 0.0, 0.25, 0.5], np.float32), (n, 3, 3))


def with_nan(n=2048):
    tris = soup(n, seed=3)
    tris[7, 1, 2] = np.nan
    return tris


# extents whose ratios sit at a power of two and one ulp to either side
RATIOS = {f"ratio_2^{k}_{tag}": (lambda k=k, f=f: in_box((np.float32(2.0 ** k) * f, 1.0, 1.0)))
          for k in (1, 7, 20)
          for tag, f in (("below", np.float32(1 - 2 ** -24)), ("at", np.float32(1.0)),
                         ("above", np.float32(1 + 2 ** -23)))}

# the extended code's paths, as `morton.bit_budget` takes them
PATHS = {
    "flat": lambda: in_box((4.0, 2.0, 0.0)),  # no z extent: bits_z == 0, the 2D interleave
    "swap": lambda: in_box((2.25, 1.5, 1.0)),  # ratios 1.5, 1.5: swap 1
    "cap": lambda: in_box((1024.0, 1.0, 1.0 / 1024)),  # 10 + 2 * 10 prebits: the cap, 30
}

SMALL = {"signed_zeros": signed_zeros, **PATHS, **RATIOS}

SCENES = {
    "sponza": lambda: scenes.sponza_like(16_384),
    "soup_70001": lambda: soup(70_001),  # no multiple of the 256-triangle tile
    "one": lambda: soup(1),
    "soup_1000003": lambda: soup(1_000_003),  # many tiles a block of the box kernel
    "nan": with_nan,
    **SMALL,
}
