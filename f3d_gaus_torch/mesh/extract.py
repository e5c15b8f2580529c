"""End-to-end mesh extraction from a Gaussian set (counterpart of
f3d_gaus_tpu/mesh/extract.py).

The reference pipeline (visualize.py:420-548): seed points from Gaussian
boxes -> Delaunay -> opacity field = min over the views of the integrate
pass -> sdf = (1 - min_alpha) - 0.5 -> marching tetrahedra -> 8-step
binary search re-evaluating the field at edge midpoints -> face filter
(edge length <= 3 * summed endpoint scales).

The field sweeps (ops/integrate.py:integrate_min_alpha) run on the device,
in csrc/integrate.cu on the card; connectivity and topology are host-side
numpy (mesh/tetra.py, mesh/delaunay.py).  `method="grid"` replaces the
Delaunay stage with an implicit lattice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import integrate as I
from ..utils import profiling
from . import delaunay as D
from . import points as MP
from . import tetra as MT

GAUSS_KEYS = ("xyz", "scaling", "rotation", "opacity", "shs")


class MeshResult(NamedTuple):
    vertices: np.ndarray          # (V, 3) float32
    faces: np.ndarray             # (F, 3) int32
    vertex_colors: Optional[np.ndarray]   # (V, 3) uint8 or None


def _field_opts(opts):
    return dict(sh_degree=opts.get("sh_degree", 1),
                kernel_size=opts.get("kernel_size", 0.0),
                pair_cap=opts.get("pair_cap", 1 << 18),
                max_per_tile=opts.get("max_per_tile", 1024),
                chunk=opts.get("chunk", 128))


def _field_eval(gauss, cams, points, opts) -> np.ndarray:
    """sdf = (1 - min_v alpha) - 0.5 at `points` (visualize.py:461-470);
    `gauss` holds the Gaussians as tensors on the run's device."""
    min_alpha = I.integrate_min_alpha(
        *(gauss[k] for k in GAUSS_KEYS), cams["world_view"],
        cams["full_proj"], cams["cam_centers"], points,
        width=opts["width"], height=opts["height"],
        tan_fovx=opts["tan_fov"], tan_fovy=opts["tan_fov"],
        point_chunk=opts.get("point_chunk", 1 << 14),
        backend=opts.get("backend", "auto"), **_field_opts(opts))
    return (1.0 - min_alpha.cpu().numpy()) - 0.5


@profiling.spanned("mesh")
def extract_mesh(gauss: dict, cams: dict, *, width: int, height: int,
                 tan_fov: float, fov_deg: float, z_near: float = 0.02,
                 z_far: float = 1e6, method: str = "delaunay",
                 grid_res: int = 128, binary_steps: int = 8,
                 filter_faces: bool = True, texture: bool = False,
                 device=None, timings: Optional[dict] = None,
                 counts: Optional[dict] = None, **field_opts) -> MeshResult:
    """Extract the opacity-0.5 iso-surface of one Gaussian set.

    gauss: dict with xyz (P,3), scaling (P,3) activated, rotation (P,4)
    normalized, opacity (P,1), shs (P,K,3), as arrays or tensors.
    cams: dict with world_view (V,4,4), full_proj (V,4,4), cam_centers (V,3)
    numpy arrays — the evaluation views (frontal + NVS orbit in the
    reference).  The field runs on `device` (default: the tensors' device,
    else cuda); field_opts go to integrate_min_alpha (sh_degree,
    kernel_size, pair_cap, max_per_tile, chunk, point_chunk, backend).
    timings: a dict to receive each stage's wall seconds (seed_points,
    delaunay or lattice, field, marching_tetrahedra, bisection,
    vertex_colors with `texture`, face_filter); counts: a dict to receive
    seed_points, tets, crossing_edges, vertices and faces.  While tracing
    is on (utils.profiling) the call is a root span `mesh` with a span per
    stage.
    """
    opts = dict(width=width, height=height, tan_fov=tan_fov, **field_opts)
    x0 = gauss["xyz"]
    dev = resolve_device(device, x0 if torch.is_tensor(x0) else None)
    g = {k: torch.as_tensor(gauss[k], dtype=torch.float32, device=dev)
         for k in GAUSS_KEYS}
    host = {k: g[k].cpu().numpy() for k in ("xyz", "scaling", "rotation")}
    xyz = host["xyz"]
    clock = profiling.StageClock(dev, timings)
    counts = {} if counts is None else counts

    if method == "delaunay":
        pts, pscale = MP.tetra_points(xyz, host["scaling"], host["rotation"],
                                      cams["world_view"], fov_deg,
                                      z_near, z_far, resolution=width)
        clock.lap("seed_points")
        cells = D.triangulate(pts)
        clock.lap("delaunay")
    elif method == "grid":
        scale3 = np.abs(host["scaling"]) * 3.0
        lo = (xyz - scale3).min(0)
        hi = (xyz + scale3).max(0)
        pts = D.lattice_points(lo, hi, grid_res)
        cell_size = float(np.max((hi - lo) / max(grid_res - 1, 1)))
        pscale = np.full(len(pts), cell_size, np.float32)
        clock.lap("seed_points")
        cells = D.lattice_tets(grid_res)
        clock.lap("lattice")
    else:
        raise ValueError(f"unknown method {method!r}")
    counts.update(seed_points=len(pts), tets=len(cells))

    sdf = _field_eval(g, cams, pts, opts)
    clock.lap("field")

    mt = MT.marching_tetrahedra(pts, cells, sdf, pscale)
    clock.lap("marching_tetrahedra")
    counts["crossing_edges"] = len(mt.edge_points)
    if len(mt.faces) == 0:
        counts.update(vertices=0, faces=0)
        return MeshResult(np.zeros((0, 3), np.float32),
                          np.zeros((0, 3), np.int32), None)

    left, right = mt.edge_points[:, 0].copy(), mt.edge_points[:, 1].copy()
    left_sdf = mt.edge_sdf[:, 0:1].copy()
    right_sdf = mt.edge_sdf[:, 1:2].copy()
    distance = np.linalg.norm(left - right, axis=-1)
    scale_sum = mt.edge_scales[:, 0] + mt.edge_scales[:, 1]

    # bisection on the field along each crossing edge (visualize.py:491-517)
    for _ in range(binary_steps):
        mid = (left + right) / 2.0
        mid_sdf = _field_eval(g, cams, mid, opts)[:, None]
        low = (((mid_sdf < 0) & (left_sdf < 0))
               | ((mid_sdf > 0) & (left_sdf > 0)))
        lowf = low[:, 0]
        left_sdf = np.where(low, mid_sdf, left_sdf)
        right_sdf = np.where(low, right_sdf, mid_sdf)
        left[lowf] = mid[lowf]
        right[~lowf] = mid[~lowf]
    verts = (left + right) / 2.0
    clock.lap("bisection")

    colors = None
    if texture:
        colors = _vertex_colors(g, cams, verts, opts)
        clock.lap("vertex_colors")

    faces = mt.faces
    if filter_faces:
        keep = distance <= 3.0 * scale_sum
        faces = faces[keep[faces].all(1)]
        remap = -np.ones(len(verts), np.int64)
        used = np.zeros(len(verts), bool)
        used[keep] = True
        remap[used] = np.arange(used.sum())
        verts = verts[used]
        if colors is not None:
            colors = colors[used]
        faces = remap[faces].astype(np.int32)
    clock.lap("face_filter")
    counts.update(vertices=len(verts), faces=len(faces))
    return MeshResult(verts.astype(np.float32), faces.astype(np.int32),
                      colors)


def _vertex_colors(gauss, cams, verts, opts) -> np.ndarray:
    """Per-vertex color from the most-transmissive view (the reference's
    texture_mesh branch, visualize.py:521-533): track the view with the
    lowest alpha_integrated, take its rendered pixel color."""
    from ..core.cameras import Camera
    from ..ops import rasterize

    fo = _field_opts(opts)
    backend = opts.get("backend", "auto")
    args = tuple(gauss[k] for k in GAUSS_KEYS)
    best_alpha = np.ones(len(verts), np.float32)
    best_color = np.ones((len(verts), 3), np.float32)
    for v in range(len(cams["world_view"])):
        cam = Camera(cams["world_view"][v], cams["full_proj"][v],
                     cams["cam_centers"][v], opts["width"], opts["height"],
                     opts["tan_fov"], opts["tan_fov"])
        with torch.no_grad():
            img = rasterize.render(*args, cam, backend=backend,
                                   **fo)["render"]
        out = I.integrate_points(*args, cam, verts, pixel_color=img,
                                 point_chunk=opts.get("point_chunk", 1 << 14),
                                 backend=backend, **fo)
        a = out["alpha_integrated"].cpu().numpy()
        c = out["color_integrated"].cpu().numpy()
        take = a < best_alpha
        best_alpha = np.where(take, a, best_alpha)
        best_color = np.where(take[:, None], c, best_color)
    return (np.clip(best_color, 0, 1) * 255).astype(np.uint8)
