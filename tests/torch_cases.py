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
    pairs in a tile than max_per_tile, so windows are cut."""
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
    return [
        ("cloud48_mpt64", cam, cloud48, pts48,
         dict(pair_cap=1 << 12, max_per_tile=64, chunk=16, point_chunk=32)),
        ("cloud16_outside", cam, cloud16, pts16, dict(point_chunk=8)),
        ("dense600_mpt128", cam, dense, pts600,
         dict(pair_cap=1 << 14, max_per_tile=128, chunk=32, point_chunk=256)),
    ]


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
