"""Minimal OBJ mesh loader: v / f records, polygon fan triangulation,
negative indices. Returns a flat triangle soup. `load_obj` uses the
repo's C++ loader (`utils/native.py`) when it loads."""
from __future__ import annotations

import numpy as np


def load_obj(path: str, prefer_native: bool = True) -> np.ndarray:
    """Parse an OBJ file into a triangle soup f32[N, 3, 3], with the C++
    loader when `prefer_native` and the library loads, else in Python."""
    if prefer_native:
        from . import native

        tris = native.load_obj(path)
        if tris is not None:
            return tris
    verts: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for p in line.split()[1:]:
                    i = int(p.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, dtype=np.float32)
    return v[np.asarray(faces, dtype=np.int64)]  # [N, 3, 3]
