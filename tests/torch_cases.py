"""Render cases shared by the port's tests and chip_smoke.py.

numpy and f3d_gaus_torch only (no JAX), so the card's machine can import
it.  The clouds are the recipes of tests/conftest.py:make_gaussian_cloud,
tests/test_rasterize_parity.py:_setup, the near-opaque stack of
tests/test_pallas_raster.py and bench.py's 65,536-Gaussian cloud; the
arrays feed the JAX package and the port alike.
"""
from __future__ import annotations

import numpy as np

from f3d_gaus_torch.core import cameras

FOV = 13.164
TAN = float(np.tan(FOV * np.pi / 360))


def make_gaussian_cloud(rng, n, center=(0.0, 0.0, 7.667), spread=0.8,
                        scale_range=(0.01, 0.08), sh_degree=1):
    """tests/conftest.py:make_gaussian_cloud, numpy only."""
    k = (sh_degree + 1) ** 2
    means = rng.normal(size=(n, 3)).astype(np.float32) * spread \
        + np.array(center, np.float32)
    scales = rng.uniform(*scale_range, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = rng.uniform(0.2, 0.95, size=(n, 1)).astype(np.float32)
    shs = rng.normal(size=(n, k, 3)).astype(np.float32) * 0.3
    shs[:, 0, :] += 0.8
    return means, scales, quats, opacities, shs


def orbit_camera(width=32, height=32, yaw=0.12, pitch=-0.07):
    """The off-axis camera of tests/test_rasterize_parity.py:_setup."""
    _, inv_first = cameras.canonical_camera_set(FOV, 7.667, 7.667, 6.667, 8.667)
    cs = cameras.build_camera_set(
        np.array([yaw], np.float32), np.array([pitch], np.float32),
        7.667, 7.667, FOV, 6.667, 8.667, rebase=inv_first)
    return cs.camera(0, width, height, TAN, TAN)


def small_camera():
    """tests/conftest.py:small_camera."""
    return orbit_camera(32, 32, yaw=0.15, pitch=-0.05)


def orbit_views(n):
    """An n-view orbit rebased to the canonical first camera (the view
    sweep of the mesh tests)."""
    _, inv_first = cameras.canonical_camera_set(FOV, 7.667, 7.667, 6.667,
                                                8.667)
    return cameras.orbit_camera_set(n, FOV, 7.667, 7.667, 6.667, 8.667,
                                    rebase=inv_first)


def setup(rng, n=96, width=32, height=32):
    """tests/test_rasterize_parity.py:_setup: (camera, cloud)."""
    cam = orbit_camera(width, height)
    cloud = make_gaussian_cloud(rng, n, spread=0.35, scale_range=(0.02, 0.12))
    return cam, cloud


def near_opaque_stack(rng, n=64):
    """The near-opaque stack of tests/test_pallas_raster.py:55-72: enough
    opacity along the center rays that the stop rule fires."""
    means = np.tile(np.array([[0.0, 0.0, 7.4]], np.float32), (n, 1))
    means[:, 2] += np.linspace(0, 0.8, n).astype(np.float32)
    means[:, :2] += rng.normal(size=(n, 2)).astype(np.float32) * 0.02
    scales = np.tile(np.array([[0.3, 0.2, 0.25]], np.float32), (n, 1))
    quats = (np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
             + rng.normal(size=(n, 4)).astype(np.float32) * 0.1)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = np.full((n, 1), 0.95, np.float32)
    shs = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.2
    return means, scales, quats, opac, shs


def behind_camera(rng, n=32):
    """A cloud entirely behind the camera: every Gaussian is culled and the
    render is pure background."""
    cloud = list(make_gaussian_cloud(rng, n))
    cloud[0] = cloud[0].copy()
    cloud[0][:, 2] = -5.0 - np.abs(cloud[0][:, 2])
    return tuple(cloud)


def pixel_aligned(rng, res=32):
    """(camera, cloud): one Gaussian on each pixel-centre ray of the
    canonical res^2 camera at a random depth, as the predictor lays them
    out; on its own ray num = |b x Md|^2 is 0 up to rounding, and often
    exactly 0."""
    cam = orbit_camera(res, res, yaw=0.0, pitch=0.0)
    n = res * res
    px = np.arange(n) % res + 0.5
    py = np.arange(n) // res + 0.5
    depth = rng.uniform(6.9, 8.4, n)
    means = np.stack([cam_point(cam, x, y, d)
                      for x, y, d in zip(px, py, depth)])
    scales = rng.uniform(0.02, 0.06, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, size=(n, 1)).astype(np.float32)
    shs = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    shs[:, 0] += 0.8
    return cam, (means, scales, quats, opac, shs)


def zero_qk(feat, every=3):
    """A copy of the (P, NFEAT) feature table with the qk rows (the
    monomial form of num = |b x Md|^2) of every `every`-th Gaussian zeroed:
    num is then exactly 0 on each of its rays in every evaluation."""
    from f3d_gaus_torch.ops import rasterize as R
    out = feat.clone()
    out[::every, R.ROW_QK:R.ROW_QK + 6] = 0.0
    return out


def bench_scene(rng, res=256, n=256 * 256):
    """bench.py:29-47: (camera, cloud) of the 65,536-Gaussian flagship."""
    cam = orbit_camera(res, res)
    means = (rng.normal(size=(n, 3)) * 0.45 + [0, 0, 7.667]).astype(np.float32)
    scales = rng.uniform(0.004, 0.02, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.9, size=(n, 1)).astype(np.float32)
    shs = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    shs[:, 0] += 0.8
    return cam, (means, scales, quats, opac, shs)


# the cases whose windows run past 256 Gaussians (slow under JAX on the CPU,
# so their parity tests have a file of their own)
DEEP_CASES = ("dense600_mpt300", "dense600_mpt768")


def small_cases(seed=0):
    """The kernel-vs-plain cases at 32^2: (name, camera, cloud, bg,
    render kwargs).  Each chunk divides max_per_tile, so the JAX XLA
    backend (whole chunks only) walks the same window.  The 600-Gaussian
    cloud puts more than 256 Gaussians in every tile: its windows run past
    the kernel's first 256-row batch, and at max_per_tile 300 they are cut
    inside the second."""
    rng = np.random.default_rng(seed)
    cam, cloud = setup(rng, n=96)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    stack = near_opaque_stack(rng)
    behind = behind_camera(rng)
    dense = make_gaussian_cloud(rng, 600, spread=0.35,
                                scale_range=(0.02, 0.12))
    return [
        ("cloud96_mpt128", cam, cloud, bg,
         dict(pair_cap=1 << 14, max_per_tile=128, chunk=32)),
        ("cloud96_mpt256", cam, cloud, bg,
         dict(pair_cap=1 << 14, max_per_tile=256, chunk=32)),
        ("cloud96_mpt100", cam, cloud, bg,
         dict(pair_cap=1 << 14, max_per_tile=100, chunk=50)),
        ("near_opaque64", cam, stack, np.zeros(3, np.float32),
         dict(pair_cap=1 << 14, max_per_tile=128, chunk=32)),
        ("behind_camera", cam, behind, bg,
         dict(pair_cap=1 << 12, max_per_tile=128, chunk=32)),
        ("dense600_mpt300", cam, dense, bg,
         dict(pair_cap=1 << 14, max_per_tile=300, chunk=60)),
        ("dense600_mpt768", cam, dense, bg,
         dict(pair_cap=1 << 14, max_per_tile=768, chunk=64)),
    ]


def integrate_cases(seed=0):
    """The field-query cases at 32^2, from tests/test_integrate.py:
    (name, camera, cloud, query points, integrate kwargs).  The 48-Gaussian
    cloud with its centres, jittered copies and outliers is that file's
    first test on the same seed; the 16-Gaussian cloud adds a point far
    outside the frustum to its centres; the 600-Gaussian cloud puts more
    pairs in a tile than max_per_tile, so windows are cut; `long_window`
    puts a 900-Gaussian cluster on one tile (a window of more than three
    slices of LONG_WINDOW_SLICE rows) and a lone point on another tile."""
    rng = np.random.default_rng(seed)
    cloud48 = make_gaussian_cloud(rng, 48)
    m = cloud48[0]
    pts48 = np.concatenate([
        m, m + rng.normal(scale=0.05, size=m.shape).astype(np.float32),
        rng.normal(size=(32, 3)).astype(np.float32) * 2.0 + [0, 0, 7.667],
    ]).astype(np.float32)
    cloud16 = make_gaussian_cloud(rng, 16)
    pts16 = np.concatenate([np.array([[100.0, 100.0, 7.7], [0.0, 0.0, 7.667]],
                                     np.float32), cloud16[0]])
    dense = make_gaussian_cloud(rng, 600, spread=0.35,
                                scale_range=(0.02, 0.12))
    pts600 = (dense[0] + rng.normal(scale=0.05, size=dense[0].shape)
              ).astype(np.float32)
    cam = small_camera()
    # a tight cluster in front of the top-left tile's rays and one Gaussian
    # on the bottom-right tile, each with query points near it
    centre = cam_point(cam, 8.0, 8.0, 7.667)
    lone = cam_point(cam, 26.0, 26.0, 7.667)
    long_ = make_gaussian_cloud(rng, 901, center=centre, spread=0.05,
                                scale_range=(0.02, 0.04))
    long_[0][-1] = lone
    pts_long = np.concatenate([
        long_[0][:64] + rng.normal(scale=0.03, size=(64, 3)),
        lone[None] + [[0.0, 0.0, 0.01]]]).astype(np.float32)
    return [
        ("cloud48_mpt64", cam, cloud48, pts48,
         dict(pair_cap=1 << 12, max_per_tile=64, chunk=16, point_chunk=32)),
        ("cloud16_outside", cam, cloud16, pts16, dict(point_chunk=8)),
        ("dense600_mpt128", cam, dense, pts600,
         dict(pair_cap=1 << 14, max_per_tile=128, chunk=32, point_chunk=256)),
        ("long_window", cam, long_, pts_long,
         dict(pair_cap=1 << 14, max_per_tile=1024, chunk=128,
              point_chunk=64)),
    ]


LONG_WINDOW_SLICE = 64       # the forced slice length of the split runs


def thin_integrate_case(seed=0):
    """A field-query case of thin Gaussians, as integrate_cases gives
    them: each of 300 has one scale 1e-4 to 1e-2 of the others, where the
    f32 ray quadratic is ill-conditioned (two f32 evaluations differ there
    beyond the JAX package's 2e-5, so it is no parity case); the query
    points lie near the centres."""
    rng = np.random.default_rng(seed + 7)
    thin = make_gaussian_cloud(rng, 300, spread=0.3, scale_range=(0.03, 0.1))
    thin[1][np.arange(300), rng.integers(0, 3, 300)] *= 10.0 ** rng.uniform(
        -4, -2, 300).astype(np.float32)
    pts = (thin[0] + rng.normal(scale=0.02, size=thin[0].shape)
           ).astype(np.float32)
    return ("thin300", small_camera(), thin, pts,
            dict(pair_cap=1 << 14, max_per_tile=512, chunk=64,
                 point_chunk=256))


def cam_point(cam, px, py, depth):
    """The world point at view depth `depth` on pixel (px, py)'s ray."""
    u = (px - cam.width / 2.0) / cam.focal_x
    v = (py - cam.height / 2.0) / cam.focal_y
    view = np.array([u * depth, v * depth, depth, 1.0])
    return (view @ np.linalg.inv(np.asarray(cam.world_view, np.float64))
            )[:3].astype(np.float32)


def mesh_case(name):
    """The clouds of tests/test_mesh.py:TestExtract on the rng fixture's
    seed: (gauss, cams, extract_mesh kwargs).  `blob_grid`, 96 opaque
    Gaussians on a 24^3 lattice seen from 8 views with 4 bisection steps;
    `cloud48_delaunay`, 48 on Delaunay seed points from 4 views, 2
    steps."""
    rng = np.random.default_rng(0)
    if name == "blob_grid":
        cloud = make_gaussian_cloud(rng, 96, spread=0.12,
                                    scale_range=(0.06, 0.10))
        orbit = orbit_views(8)
        kw = dict(method="grid", grid_res=24, binary_steps=4)
    else:
        cloud = make_gaussian_cloud(rng, 48, spread=0.1,
                                    scale_range=(0.06, 0.10))
        orbit = orbit_views(4)
        kw = dict(method="delaunay", binary_steps=2)
    means, scales, quats, opac, shs = cloud
    opac[:] = 0.95
    gauss = {"xyz": means, "scaling": scales, "rotation": quats,
             "opacity": opac, "shs": shs}
    cams = {"world_view": orbit.world_view, "full_proj": orbit.full_proj,
            "cam_centers": orbit.cam_centers}
    kw.update(width=32, height=32, tan_fov=TAN, fov_deg=FOV,
              pair_cap=1 << 12, max_per_tile=128, chunk=32,
              point_chunk=1 << 10)
    return gauss, cams, kw


def raised_opacity_checkpoint(path, cfg, seed=0):
    """The seeded EDM-init predictor of `cfg` with the opacity logit's bias
    at 1.0 (opacity about 0.73, as tests/test_torch_train_grad.py sets it),
    saved as a reference-format .pt for --load_model.  At the init's
    opacity of about 0.05 no point of the field reaches alpha 0.5 and the
    mesh has no faces; at 0.73 each Gaussian's centre is inside the
    surface in every view."""
    import torch
    from f3d_gaus_torch.models import predictor as P
    model = P.GaussianPredictor(cfg.predictor_config(),
                                torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.out.bias[3] = 1.0
    torch.save({"gaussian_predictor.network_with_offset." + k: v
                for k, v in model.state_dict().items()}, path)


def exercised(name, tile_count, aux, max_per_tile):
    """What case `name` is there to exercise, each claim checked on its
    render: {claim: holds}.  tile_count is the binning's (unclamped)
    per-tile count, aux the render's RenderAux."""
    tc, lp = tile_count.max().item(), aux.last_pos.max().item()
    if name == "near_opaque64":
        return {"stop_rule_fired": aux.final_T.min().item() < 1e-3}
    if name == "behind_camera":
        return {"pure_background": bool((aux.last_pos == -1).all())}
    if name == "dense600_mpt300":
        return {"tile_count_over_window": tc > max_per_tile,
                "last_contributor_at_window_end": lp == max_per_tile - 1}
    if name == "dense600_mpt768":
        return {"window_holds_every_pair": tc <= max_per_tile,
                "contributor_past_position_300": lp >= 300}
    return {}


def bench_parity(a9, b9):
    """bench.py:65-90's anchor on two (9, H, W) renders: channels 0-5, 7, 8
    (depth, a discrete max-contributor choice, excluded).  Returns
    (max abs error, fraction of values above 1e-3); the anchor holds when
    max < 2e-2 and fraction < 1e-3."""
    ch = list(range(6)) + [7, 8]
    err = np.abs(np.asarray(a9)[ch] - np.asarray(b9)[ch])
    return float(err.max()), float((err > 1e-3).mean())


def turntable_views(azimuths, elevation=20.0, radius=4.03):
    """(n, 4, 4) row-vector world_view matrices of cameras on a circle
    around the origin (z up) at `elevation` degrees, each looking at it,
    in COLMAP's axes (+y down, +z forward), as
    benchmark/inputs.py:blender_cameras makes them: GS-LRM's input and
    turntable cameras."""
    out = []
    el = np.radians(elevation)
    for az in azimuths:
        p = radius * np.array([np.cos(el) * np.cos(az),
                               np.cos(el) * np.sin(az), np.sin(el)])
        f = -p / np.linalg.norm(p)
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([r, np.cross(r, f), -f], 1)
        c2w[:3, 3] = p
        c2w[:3, 1:3] *= -1
        out.append(np.linalg.inv(c2w).T)
    return np.stack(out)


def turntable_camera(azimuth, res=512, fov_deg=39.5971132214912,
                     znear=0.01, zfar=100.0):
    """One turntable_views camera as a core.cameras.Camera at res^2 (GS-LRM's
    512^2 orbit at its configuration's field of view)."""
    wv = turntable_views([azimuth])[0].astype(np.float32)
    fov = np.radians(fov_deg)
    proj = cameras.projection_matrix(znear, zfar, fov, fov).T
    full_proj = (wv @ proj).astype(np.float32)
    center = np.linalg.inv(wv.astype(np.float64))[3, :3].astype(np.float32)
    tan = float(np.tan(fov / 2))
    return cameras.Camera(wv, full_proj, center, res, res, tan, tan)


def preprocess_cases(seed=0):
    """(name, camera, cloud, sh_degree, kernel_size) of the preprocess
    kernel's tests: an orbit view of a 589,824-Gaussian set (a request's
    merged set: 9 x 65,536) at 256^2, SH degree 1; an aggregation view at
    65,536; 1,048,576 Gaussians about the origin at a 512^2 turntable
    view, SH degree 0 (GS-LRM's orbit); and 4,096 Gaussians of which some
    lie behind the near plane (view depth -1 to 0.2), some exactly at the
    camera centre (|dirs| = 0), some have zero scales (a zero 2D
    determinant at kernel_size 0, a zero low-pass coefficient above it),
    some are thin, at SH degree 3 and kernel_size 0.3 and at SH degree 2
    (of 16 coefficients a Gaussian) and kernel_size 0."""
    from f3d_gaus_torch.pipeline import config, cycle, dataset
    rng = np.random.default_rng(seed)
    cfg = config.PipelineConfig()
    inv_first = dataset.canonical_cameras(cfg).inverse_first_camera
    r, tan = cfg.resolution, cfg.tan_fov
    orbit = cycle.nvs_cameras(cfg, inv_first).camera(40, r, r, tan, tan)
    agg = cycle.aggregation_cameras(cfg, inv_first).camera(3, r, r, tan, tan)
    _, merged = bench_scene(rng, n=9 * 65536)
    _, first = bench_scene(rng)

    n = 1 << 20
    lrm = (
        (rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        rng.uniform(0.002, 0.02, size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0.01, 0.99, size=(n, 1)).astype(np.float32),
        (rng.normal(size=(n, 1, 3)) * 0.5).astype(np.float32))
    lrm[2][:] /= np.linalg.norm(lrm[2], axis=-1, keepdims=True)

    cam = orbit_camera(64, 64)
    edges = list(make_gaussian_cloud(rng, 4096, sh_degree=3,
                                     scale_range=(0.001, 0.2)))
    px, py = rng.uniform(-8, 72, size=(2, 512))
    edges[0][:512] = [cam_point(cam, x, y, d) for x, y, d in
                      zip(px, py, rng.uniform(-1.0, 0.2, 512))]
    edges[0][512:544] = np.asarray(cam.cam_center, np.float32)
    edges[1][544:640] = 0.0
    edges[1][640:768, 0] = 1e-7
    return [("orbit_589824", orbit, merged, 1, 0.0),
            ("aggregation_65536", agg, first, 1, 0.0),
            ("gslrm_1048576", turntable_camera(0.7), lrm, 0, 0.0),
            ("edges_sh3", cam, tuple(edges), 3, 0.3),
            ("edges_sh2_k0", cam, tuple(edges), 2, 0.0)]


def frame_camera(azimuth, width, height, fov_x_deg=60.0, elevation=25.0,
                 radius=3.0, znear=0.01, zfar=100.0):
    """A turntable_views camera with a frame of width × height and a
    horizontal field of view of fov_x_deg (square pixels), as a
    core.cameras.Camera: Long-LRM's scene views."""
    wv = turntable_views([azimuth], elevation, radius)[0].astype(np.float32)
    tan_x = float(np.tan(np.radians(fov_x_deg) / 2))
    tan_y = tan_x * height / width
    proj = cameras.projection_matrix(znear, zfar, 2 * np.arctan(tan_x),
                                     2 * np.arctan(tan_y)).T
    full_proj = (wv @ proj).astype(np.float32)
    center = np.linalg.inv(wv.astype(np.float64))[3, :3].astype(np.float32)
    return cameras.Camera(wv, full_proj, center, width, height, tan_x, tan_y)
