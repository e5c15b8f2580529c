"""f3d_gaus_torch.mesh against f3d_gaus_tpu.mesh on the CPU: seed points
and the frustum mask, Delaunay and lattice connectivity, marching
tetrahedra on the sphere and blob fields of tests/test_mesh.py, and
extract_mesh on TestExtract's two clouds (grid and Delaunay), with the
port's field in its plain version.

Vertex tolerance of extract_mesh: both sides bisect the same f32 edge
endpoints with the same numpy arithmetic, so a vertex comes out bit for
bit the same unless the field's sign differs at one of its midpoints,
which needs |sdf| below the field's own 2e-5 tolerance there.  A flip at
step j sends the two bisections into different halves of a bracket of
|edge| / 2^(j-1), so the vertices can then differ by up to |edge| / 2 (a
flip at the first step).  The test holds >= 99 % of the vertices bit for
bit (on these clouds all are) and every vertex within |edge| / 2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.core.quaternions import quat_to_rotmat as jax_rotmat
from f3d_gaus_tpu.mesh import delaunay as JD
from f3d_gaus_tpu.mesh import extract as JE
from f3d_gaus_tpu.mesh import points as JMP
from f3d_gaus_tpu.mesh import tetra as JMT
from f3d_gaus_torch.mesh import delaunay as TD
from f3d_gaus_torch.mesh import extract as TE
from f3d_gaus_torch.mesh import points as TMP
from f3d_gaus_torch.mesh import tetra as TMT
from f3d_gaus_torch.ops import integrate as TI
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

FOV = torch_cases.FOV


def test_triangle_tables_equal():
    np.testing.assert_array_equal(TMT.TRIANGLE_TABLE, JMT.TRIANGLE_TABLE)
    np.testing.assert_array_equal(TMT.NUM_TRIANGLES, JMT.NUM_TRIANGLES)
    np.testing.assert_array_equal(TMT.EDGES, JMT.EDGES)


@pytest.mark.parametrize("resolution", [32, 256])
def test_tetra_points_and_frustum_mask_match_jax(resolution):
    rng = np.random.default_rng(0)
    means, scales, quats, _, _ = torch_cases.make_gaussian_cloud(rng, 200)
    means[:20, 0] += 3.0                       # some outside every frustum
    wv = torch_cases.orbit_views(8).world_view
    got = TMP.tetra_points(means, scales, quats, wv, FOV,
                           resolution=resolution)
    ref = JMP.tetra_points(means, scales, quats, wv, FOV,
                           resolution=resolution)
    assert got[0].shape == ref[0].shape and 0 < len(got[0]) < 9 * 200
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-6, rtol=0)
    pts = np.concatenate([means, means + rng.normal(size=means.shape)
                          .astype(np.float32)])
    m = TMP.frustum_mask(pts, wv, FOV, resolution=resolution)
    np.testing.assert_array_equal(m, JMP.frustum_mask(pts, wv, FOV,
                                                      resolution=resolution))
    assert m.any() and not m.all()
    np.testing.assert_allclose(TMP.quat_to_rotmat(quats), np.asarray(
        jax_rotmat(jnp.asarray(quats))), atol=1e-6, rtol=0)


def test_connectivity_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cells = TD.triangulate(pts)
    assert cells.dtype == np.int32 and cells.shape[1] == 4
    np.testing.assert_array_equal(cells, JD.triangulate(pts))
    for res in (2, 5, 9):
        np.testing.assert_array_equal(TD.lattice_tets(res),
                                      JD.lattice_tets(res))
        np.testing.assert_array_equal(
            TD.lattice_points(np.zeros(3), np.ones(3), res),
            JD.lattice_points(np.zeros(3), np.ones(3), res))


def _sphere_field(pts):
    return np.linalg.norm(pts, axis=-1) - 0.6


def _blob_field(pts):
    """Three overlapping balls (union): a non-convex closed surface."""
    c = np.array([[-0.3, 0, 0], [0.3, 0.1, 0], [0, -0.2, 0.3]], np.float32)
    return (np.linalg.norm(pts[:, None] - c[None], axis=-1) - 0.35).min(1)


@pytest.mark.parametrize("field", [_sphere_field, _blob_field])
@pytest.mark.parametrize("connect", ["lattice", "delaunay"])
def test_marching_tetrahedra_matches_jax(field, connect):
    if connect == "lattice":
        pts = TD.lattice_points(np.full(3, -1.0), np.full(3, 1.0), 24)
        tets = TD.lattice_tets(24)
    else:
        pts = np.random.default_rng(1).uniform(-1, 1, (3000, 3)).astype(
            np.float32)
        tets = TD.triangulate(pts)
    sdf = field(pts)
    scales = np.random.default_rng(2).uniform(0.05, 0.2, len(pts))
    got = TMT.marching_tetrahedra(pts, tets, sdf, scales)
    ref = JMT.marching_tetrahedra(pts, tets, sdf, scales)
    assert len(got.faces) > 100
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def _edge_lengths(gauss, cams, kw):
    """|edge| of every crossing edge that the face filter keeps, in the
    order of extract_mesh's vertices (the port's own field)."""
    opts = dict(width=32, height=32, tan_fov=kw["tan_fov"], **{
        k: kw[k] for k in ("pair_cap", "max_per_tile", "chunk",
                           "point_chunk")})
    if kw["method"] == "grid":
        scale3 = np.abs(gauss["scaling"]) * 3.0
        lo = (gauss["xyz"] - scale3).min(0)
        hi = (gauss["xyz"] + scale3).max(0)
        pts = TD.lattice_points(lo, hi, kw["grid_res"])
        cells = TD.lattice_tets(kw["grid_res"])
        cell = float(np.max((hi - lo) / (kw["grid_res"] - 1)))
        pscale = np.full(len(pts), cell, np.float32)
    else:
        pts, pscale = TMP.tetra_points(gauss["xyz"], gauss["scaling"],
                                       gauss["rotation"], cams["world_view"],
                                       FOV, resolution=32)
        cells = TD.triangulate(pts)
    g = {k: torch.from_numpy(np.asarray(v)) for k, v in gauss.items()}
    sdf = TE._field_eval(g, cams, pts, opts)
    mt = TMT.marching_tetrahedra(pts, cells, sdf, pscale)
    edge = np.linalg.norm(mt.edge_points[:, 0] - mt.edge_points[:, 1], axis=-1)
    keep = edge <= 3.0 * (mt.edge_scales[:, 0] + mt.edge_scales[:, 1])
    return edge[keep]


@pytest.mark.parametrize("name", ["blob_grid", "cloud48_delaunay"])
def test_extract_mesh_matches_jax(name):
    gauss, cams, kw = torch_cases.mesh_case(name)
    ref = JE.extract_mesh(gauss, cams, **kw)
    timings, counts = {}, {}
    before = TI.overflow_views
    got = TE.extract_mesh(gauss, cams, device="cpu", timings=timings,
                          counts=counts, **kw)
    assert TI.overflow_views == before
    assert len(got.faces) > (50 if name == "blob_grid" else 0)
    np.testing.assert_array_equal(got.faces, ref.faces)
    assert got.vertices.shape == ref.vertices.shape
    err = np.abs(got.vertices - ref.vertices).max(1)
    assert (err <= _edge_lengths(gauss, cams, kw) / 2.0).all(), err.max()
    assert (err == 0).mean() >= 0.99
    stages = {"seed_points", "field", "marching_tetrahedra", "bisection",
              "face_filter",
              "lattice" if kw["method"] == "grid" else "delaunay"}
    assert set(timings) == stages and all(t >= 0 for t in timings.values())
    assert counts["vertices"] == len(got.vertices)
    assert counts["faces"] == len(got.faces)
    assert counts["crossing_edges"] >= counts["vertices"] > 0
    assert counts["tets"] > 0 and counts["seed_points"] > 0


def test_extract_mesh_empty_field_and_texture():
    """A cloud below alpha = 1/255 gives no faces (the bisection never
    runs); the texture branch colours every vertex from the views'
    renders."""
    gauss, cams, kw = torch_cases.mesh_case("blob_grid")
    counts = {}
    empty = TE.extract_mesh(dict(gauss, opacity=gauss["opacity"] * 0.003),
                            cams, device="cpu", counts=counts, **kw)
    assert len(empty.faces) == 0 and counts["crossing_edges"] == 0
    kw = dict(kw, grid_res=12, binary_steps=1)
    tex = TE.extract_mesh(gauss, cams, device="cpu", texture=True, **kw)
    assert len(tex.faces) > 0
    assert tex.vertex_colors.shape == (len(tex.vertices), 3)
    assert tex.vertex_colors.dtype == np.uint8 and tex.vertex_colors.max() > 0
