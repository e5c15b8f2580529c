"""Marching tetrahedra (host-side numpy, vectorized; a copy of
f3d_gaus_tpu/mesh/tetra.py).

Counterpart of the reference's kaolin-derived marching_tetrahedra
(src/utils_tetmesh.py:47-190) with the same caller contract: crossing-edge
endpoints are returned UNAVERAGED as (edge_points (E, 2, 3), edge_sdf
(E, 2)) so the caller can binary-search the iso-crossing along each edge
(visualize.py:478-517), plus per-endpoint scales for the face filter.

Design notes (not a port):
  * the 16-case triangle table is GENERATED at import time from first
    principles (crossing edges of each occupancy case; 1-inside/3-inside
    cases give one triangle, 2-inside gives a quad split into two), rather
    than hard-coding kaolin's table;
  * face winding is fixed at extraction time geometrically — each
    triangle is flipped so its normal points toward the positive-sdf side
    (outside), which is deterministic and independent of table ordering;
  * topology (unique edges, face assembly) is combinatorial host work —
    the same split the reference uses (CUDA field eval + CPU CGAL): the
    expensive opacity-field evaluation runs on the card (ops/integrate.py),
    the once-per-scene mesh assembly runs here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# tet edges in canonical (lo, hi) vertex order
EDGES = np.array([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)], np.int32)


def _build_tables():
    """Triangle table over the 16 vertex-occupancy cases.

    Entry values index into the 6 tet edges; -1 pads.  Orientation is NOT
    encoded here (fixed geometrically in marching_tetrahedra).
    """
    tri = -np.ones((16, 6), np.int32)
    ntri = np.zeros(16, np.int32)

    def edge_id(u, v):
        return int(np.where((EDGES == sorted((u, v))).all(1))[0][0])

    for case in range(1, 15):
        inside = [v for v in range(4) if case & (1 << v)]
        outside = [v for v in range(4) if not case & (1 << v)]
        if len(inside) in (1, 3):
            apex = inside[0] if len(inside) == 1 else outside[0]
            others = [v for v in range(4) if v != apex]
            cross = [edge_id(apex, o) for o in others]
            tri[case, :3] = cross
            ntri[case] = 1
        else:
            a, b = inside
            x, y = outside
            quad = [edge_id(a, x), edge_id(a, y), edge_id(b, y), edge_id(b, x)]
            tri[case, :6] = [quad[0], quad[1], quad[2],
                             quad[0], quad[2], quad[3]]
            ntri[case] = 2
    return tri, ntri


TRIANGLE_TABLE, NUM_TRIANGLES = _build_tables()


class MTOutput(NamedTuple):
    edge_points: np.ndarray   # (E, 2, 3) crossing-edge endpoints (unaveraged)
    edge_sdf: np.ndarray      # (E, 2)    sdf at the endpoints
    edge_scales: np.ndarray   # (E, 2)    per-endpoint scales
    faces: np.ndarray         # (F, 3)    int32 indices into the E edges


def marching_tetrahedra(vertices: np.ndarray, tets: np.ndarray,
                        sdf: np.ndarray, scales: np.ndarray,
                        chunk: int = 1 << 22) -> MTOutput:
    """vertices: (N, 3); tets: (T, 4) int; sdf: (N,); scales: (N,).

    A mesh vertex is born on every tet edge whose endpoints straddle the
    iso-level (sdf = 0); faces triangulate each straddling tet.  Edges are
    deduplicated globally (chunked over tets for memory, with an id-merge
    pass — src/utils_tetmesh.py:54-95 semantics).
    """
    vertices = np.asarray(vertices, np.float32)
    sdf = np.asarray(sdf, np.float32).reshape(-1)
    scales = np.asarray(scales, np.float32).reshape(-1)
    tets = np.asarray(tets, np.int64)

    occ = sdf > 0
    # straddling tets only
    occ4 = occ[tets]
    osum = occ4.sum(1)
    tets = tets[(osum > 0) & (osum < 4)]

    edge_keys = []      # (E_c, 2) canonical global edges per chunk
    face_keys = []      # (F_c, 2) edges referenced by faces, as key rows
    for lo in range(0, len(tets), chunk):
        t = tets[lo:lo + chunk]
        o = occ[t]
        case = (o << np.arange(4)).sum(1)

        e = t[:, EDGES]                                # (Tc, 6, 2)
        e = np.sort(e, axis=-1)                        # canonical order

        tt = TRIANGLE_TABLE[case]                      # (Tc, 6)
        nt = NUM_TRIANGLES[case]
        idx1 = tt[nt >= 1][:, :3]
        idx2 = tt[nt == 2][:, 3:6]
        f_edges = np.concatenate([
            np.take_along_axis(e[nt >= 1], idx1[..., None], axis=1),
            np.take_along_axis(e[nt == 2], idx2[..., None], axis=1),
        ]).reshape(-1, 2)                              # (3F_c, 2)
        face_keys.append(f_edges)
        edge_keys.append(np.unique(f_edges, axis=0))

    if not face_keys or sum(len(f) for f in face_keys) == 0:
        z = np.zeros
        return MTOutput(z((0, 2, 3), np.float32), z((0, 2), np.float32),
                        z((0, 2), np.float32), z((0, 3), np.int32))

    all_edges = np.unique(np.concatenate(edge_keys), axis=0)    # (E, 2)
    flat_faces = np.concatenate(face_keys)                      # (3F, 2)
    # map face edge pairs -> edge row ids via lexsearch
    keys = all_edges[:, 0].astype(np.int64) * (vertices.shape[0] + 1) \
        + all_edges[:, 1]
    fkeys = flat_faces[:, 0].astype(np.int64) * (vertices.shape[0] + 1) \
        + flat_faces[:, 1]
    order = np.argsort(keys)
    faces = order[np.searchsorted(keys[order], fkeys)].reshape(-1, 3)

    edge_points = vertices[all_edges]                           # (E, 2, 3)
    edge_sdf = sdf[all_edges]
    edge_scales = scales[all_edges]

    # geometric winding: normal points toward positive sdf (outside)
    p = edge_points.mean(1)                                     # midpoints
    v0, v1, v2 = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    # direction to the outside: from the inside endpoints toward outside ones
    sgn = np.sign(edge_sdf)                                     # (E, 2)
    d_out = (edge_points * sgn[..., None]).sum(1)               # out - in
    d_face = (d_out[faces[:, 0]] + d_out[faces[:, 1]] + d_out[faces[:, 2]])
    flip = (n * d_face).sum(-1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return MTOutput(edge_points.astype(np.float32),
                    edge_sdf.astype(np.float32),
                    edge_scales.astype(np.float32),
                    faces.astype(np.int32))
