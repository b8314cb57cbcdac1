"""Triangle soups (numpy f32[n, 3, 3]) for the LBVH tail's tests, on the CPU
and on the card: seeded soups, their copies with x past the refit's +3e38
fill, and a caterpillar whose long-node count passes the refit's budget.

The caterpillar is a grid of chains on the 1024-cell Morton grid (in both
Morton modes): in each of `blocks`^3 corner cells, `cluster` coincident
triangles and, along each axis, outliers 1, 2, 4, ... 2^(levels - 1)
cells away, each splitting one leaf off its chain; one triangle in the far
cell fixes the extent. Every chain node keeps the cluster on one side, so
most nodes are long and the CPU refit takes `_refit_full_table`.
"""
import numpy as np


def soup(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-10, 10, (n, 1, 3)) + rng.normal(0, 0.5, (n, 3, 3))).astype(np.float32)


def huge(tris, seed=0):
    """x of every vertex drawn from [3.1e38, 3.35e38]: every box's min x and
    the unions of x pass the stencil's +3e38 fill."""
    out = tris.copy()
    out[..., 0] = np.random.default_rng(seed).uniform(3.1e38, 3.35e38, out.shape[:2])
    return out


def caterpillar(blocks=4, levels=8, cluster=25, x0=0.0, cell=1.0):
    """The grid of chains (3137 triangles at the defaults); x0 shifts x and
    `cell` scales the grid (x0 = 3.1e38, cell = 2e34 puts x past 3e38)."""
    step = 1024 // blocks
    pts = []
    for corner in np.stack(np.meshgrid(*[np.arange(blocks)] * 3, indexing="ij"), -1).reshape(-1, 3):
        c = corner * step
        pts += [c] * cluster
        for ax in range(3):
            for j in range(levels):
                p = c.copy()
                p[ax] += 1 << j
                pts.append(p)
    pts.append(np.full(3, 1023))
    ctr = (np.asarray(pts, np.float64) + 0.5) * cell
    ctr[:, 0] += x0
    return np.repeat(ctr[:, None, :], 3, axis=1).astype(np.float32)


def caterpillar_huge():
    return caterpillar(x0=3.1e38, cell=2e34)
