"""Tetrahedral connectivity for the opacity-field seed points (a copy of
f3d_gaus_tpu/mesh/delaunay.py).

Two constructions:

  * `triangulate` — 3D Delaunay on the host via scipy/Qhull, the same
    architectural role as the reference's CGAL tetra-triangulation
    submodule (triangulation.cpp:27-68 — also a host-CPU C/C++ library
    behind a thin binding; Qhull is the in-image equivalent);
  * `lattice_tets` — a regular-grid Kuhn/Freudenthal tetrahedralization
    with IMPLICIT connectivity (the "opacity sampling grid"): no host
    geometry pass at all, cells derive from index arithmetic.
"""
from __future__ import annotations

import numpy as np


def triangulate(points: np.ndarray) -> np.ndarray:
    """Delaunay tetrahedralization.  points: (N, 3) -> cells (T, 4) int32,
    the contract of cpp.triangulate (py_binding.cpp:26-43)."""
    from scipy.spatial import Delaunay
    pts = np.asarray(points, np.float64)
    # joggle coincident/degenerate inputs the way CGAL's exact predicates
    # tolerate them; QJ guarantees full-dimensional simplices
    tri = Delaunay(pts, qhull_options="QJ")
    return tri.simplices.astype(np.int32)


# the 6 tets of the Kuhn subdivision of a unit cube, as corner offsets
_KUHN = np.array([
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]],
    [[0, 0, 0], [1, 0, 0], [1, 0, 1], [1, 1, 1]],
    [[0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 1, 1]],
    [[0, 0, 0], [0, 1, 0], [0, 1, 1], [1, 1, 1]],
    [[0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1]],
    [[0, 0, 0], [0, 0, 1], [0, 1, 1], [1, 1, 1]],
], np.int64)


def lattice_points(lo, hi, res: int):
    """(res^3, 3) vertex grid spanning the [lo, hi] box."""
    axes = [np.linspace(lo[i], hi[i], res, dtype=np.float32) for i in range(3)]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1)
    return g.reshape(-1, 3)


def lattice_tets(res: int) -> np.ndarray:
    """Implicit-connectivity tets for a res^3 vertex grid: 6 Kuhn tets per
    cube, ((res-1)^3 * 6, 4) int64.  Vertex id = (ix*res + iy)*res + iz."""
    c = res - 1
    base = np.stack(np.meshgrid(np.arange(c), np.arange(c), np.arange(c),
                                indexing="ij"), -1).reshape(-1, 1, 1, 3)
    corner = base + _KUHN[None]                         # (C, 6, 4, 3)
    ids = (corner[..., 0] * res + corner[..., 1]) * res + corner[..., 2]
    return ids.reshape(-1, 4)
