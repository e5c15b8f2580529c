"""The stage cap planner's kernel (csrc/footprint.cu, through
binning.footprint_need) against its plain version (binning.
_footprint_need_impl) on the card: the most pairs and the fullest tile,
exactly, at the stage shapes the port plans (the serving orbit and
aggregation stages, GS-LRM's turntable, Long-LRM's 960x540 targets, a
per-scene fit's cameras, two batch elements) and on edge clouds; the
launches a serving request counts; and the frames the kernel refuses.
Needs a CUDA device and nvcc; skips elsewhere.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_plan.py -m cuda -q --noconftest
"""
import math

import numpy as np
import pytest
import torch

from f3d_gaus_torch.core.cameras import Camera
from f3d_gaus_torch.models import predictor as TP
from f3d_gaus_torch.ops import binning as TB
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as TC
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.train import per_scene as TPS
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def counted(fn):
    """fn() inside profiling.record(): its output and its counters."""
    with profiling.record():
        out = fn()
        torch.cuda.synchronize()
        counters = profiling.snapshot()["counters"]
    return out, counters


def cloud(rng, n, center=(0.0, 0.0, 7.667), spread=0.45,
          scale=(0.004, 0.02)):
    """(xyz, scaling, rotation) of n Gaussians, float32 numpy."""
    xyz = (rng.normal(size=(n, 3)) * spread + center).astype(np.float32)
    s = rng.uniform(*scale, size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return xyz, s, q


def serving_stage(stage):
    cfg = TCfg.PipelineConfig()
    inv = TD.canonical_cameras(cfg).inverse_first_camera
    pick = (TC.aggregation_cameras if stage == "aggregation"
            else TC.nvs_cameras)
    cs = pick(cfg, inv)
    r = cfg.resolution
    return cs.world_view, cs.full_proj, cs.camera(0, r, r, cfg.tan_fov,
                                                   cfg.tan_fov)


def stage_case(name):
    """(clouds (B of them), world_views, full_projs, camera, kernel_size)
    of the stage shapes the port plans."""
    rng = np.random.default_rng(23)
    if name == "orbit_589824":
        return ([cloud(rng, 9 * 65536)], *serving_stage("nvs"), 0.0)
    if name == "aggregation_65536":
        return ([cloud(rng, 65536)], *serving_stage("aggregation"), 0.0)
    if name == "aggregation_b2":
        return ([cloud(rng, 65536), cloud(rng, 65536, spread=0.6)],
                *serving_stage("aggregation"), 0.1)
    if name == "gslrm_1048576":
        az = np.linspace(0, 2 * np.pi, 32, endpoint=False)
        cams = [torch_cases.turntable_camera(a) for a in az]
        return ([cloud(rng, 1 << 20, center=(0, 0, 0), spread=0.5,
                       scale=(0.002, 0.02))],
                np.stack([c.world_view for c in cams]),
                np.stack([c.full_proj for c in cams]), cams[0], 0.0)
    if name == "frame_960x540":
        az = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        cams = [torch_cases.frame_camera(a, 960, 540) for a in az]
        return ([cloud(rng, 1 << 20, center=(0, 0, 0), spread=0.7,
                       scale=(0.001, 0.03))],
                np.stack([c.world_view for c in cams]),
                np.stack([c.full_proj for c in cams]), cams[0], 0.0)
    raise KeyError(name)


STAGES = ("orbit_589824", "aggregation_65536", "aggregation_b2",
          "gslrm_1048576", "frame_960x540")


@pytest.mark.parametrize("name", STAGES)
def test_footprint_kernel_counts_exactly(cuda, name):
    """At each stage shape: the kernel's most pairs and fullest tile equal
    the plain version's on the same card tensors, in one counted launch;
    at a few single views, the binning's own count of the preprocess
    kernel's footprints (count_pairs, bin_gaussians' tile_count)."""
    clouds, wv, fp, cam, ks = stage_case(name)
    g = [torch.from_numpy(np.stack(a)).to(cuda) for a in zip(*clouds)]
    got, c = counted(lambda: TB.footprint_need(*g, wv, fp, cam, ks))
    assert c.get("launches.footprint", 0) == 1
    want = TB._footprint_need_impl(*g, wv, fp, cam, ks)
    assert got == want
    assert got["pairs"] > 0 and got["tile"] > 0
    w, h = cam.width, cam.height
    opac = torch.full((g[0].shape[1], 1), 0.5, device=cuda)
    shs = torch.zeros((g[0].shape[1], 1, 3), device=cuda)
    for v in (0, len(wv) // 2, len(wv) - 1):
        one = TB.footprint_need(*g, wv[v:v + 1], fp[v:v + 1], cam, ks)
        view = Camera(wv[v], fp[v], np.zeros(3, np.float32), w, h,
                      cam.tan_fovx, cam.tan_fovy)
        pairs = tile = 0
        for b in range(g[0].shape[0]):
            _, extra, depths, radii = cuda_raster.preprocess(
                g[0][b], g[1][b], g[2][b], opac, shs, 0, view, ks)
            n = int(TB.count_pairs(extra[:, 3:5], radii, w, h))
            bng = TB.bin_gaussians(extra[:, 3:5], radii, depths, w, h,
                                   TB.suggest_pair_cap(n))
            pairs = max(pairs, n)
            tile = max(tile, int(bng.tile_count.max()))
        assert one == {"pairs": pairs, "tile": tile}, v


def test_footprint_kernel_counts_the_alive_rows_of_a_fit(cuda, monkeypatch):
    """per_scene.needed_caps over a fit's 800^2 cameras (two groups of
    fields of view) on a scene with dead rows: the kernel's counts equal
    the plain version's given the same alive rows, one launch a group."""
    rng = np.random.default_rng(7)
    n = 300_000
    xyz, s, q = cloud(rng, n, center=(0, 0, 0), spread=0.6,
                      scale=(0.002, 0.03))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    scene = TPS.SceneParams(
        xyz=t(xyz), f_dc=torch.zeros(n, 1, 3, device=cuda),
        f_rest=torch.zeros(n, 15, 3, device=cuda),
        opacity=torch.zeros(n, 1, device=cuda), scaling=t(np.log(s)),
        rotation=t(q), alive=t(rng.uniform(size=n) < 0.8))
    az = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    cameras = [torch_cases.turntable_camera(a, res=800) for a in az[:60]]
    cameras += [torch_cases.turntable_camera(a, res=800, fov_deg=45.0)
                for a in az[60:]]
    cfg = TPS.PerSceneConfig()
    got, c = counted(lambda: TPS.needed_caps(scene, cameras, cfg))
    assert c.get("launches.footprint", 0) == 2
    monkeypatch.setattr(TB, "footprint_need", TB._footprint_need_impl)
    want = TPS.needed_caps(scene, cameras, cfg)
    assert got == want and got["pairs"] > 0


def edge_case(name):
    """A 64 x 48 camera and one batch element of an edge cloud."""
    rng = np.random.default_rng(5)
    cam = torch_cases.orbit_camera(64, 48)
    n = 1200
    xyz, s, q = cloud(rng, n, spread=0.8, scale=(0.005, 0.08))
    if name == "behind_near_plane":
        px, py = rng.uniform(-20, 84, size=(2, n))
        xyz[:] = [torch_cases.cam_point(cam, x, y, d) for x, y, d in
                  zip(px, py, rng.uniform(-1.0, 0.3, n))]
    elif name == "det_zero":
        s[: n // 2] = 0.0
    elif name == "borders":
        bx = np.r_[rng.uniform(-30, 0, 300), rng.uniform(64, 90, 300),
                   rng.uniform(0, 64, 600)]
        by = np.r_[rng.uniform(0, 48, 600), rng.uniform(-30, 0, 300),
                   rng.uniform(48, 70, 300)]
        xyz[:] = [torch_cases.cam_point(cam, x, y, 7.0)
                  for x, y in zip(bx, by)]
    elif name == "tile_boundaries":
        k = rng.integers(0, 5, size=(2, n))
        xyz[:] = [torch_cases.cam_point(cam, 16.0 * a, 16.0 * b, 7.0)
                  for a, b in zip(*k)]
    elif name == "covers_every_tile":
        xyz[:] = torch_cases.cam_point(cam, 32, 24, 3.0)
        s[:] = 3.0
    elif name == "all_culled":
        xyz[:] = torch_cases.cam_point(cam, 32, 24, -1.0)
    elif name == "empty":
        xyz, s, q = xyz[:0], s[:0], q[:0]
    return cam, (xyz, s, q)


EDGES = ("behind_near_plane", "det_zero", "borders", "tile_boundaries",
         "covers_every_tile", "all_culled", "empty")


@pytest.mark.parametrize("kernel_size", [0.0, 0.3])
@pytest.mark.parametrize("name", EDGES)
def test_footprint_kernel_edge_clouds(cuda, name, kernel_size):
    """Gaussians behind the near plane, with zero scales (a zero
    determinant at kernel_size 0), clamped at each border, on tile
    boundaries, one footprint over every tile, every one culled, none: the
    kernel's counts equal the plain version's."""
    cam, arrays = edge_case(name)
    g = [torch.from_numpy(np.ascontiguousarray(a))[None].to(cuda)
         for a in arrays]
    wv, fp = cam.world_view[None], cam.full_proj[None]
    got = TB.footprint_need(*g, wv, fp, cam, kernel_size)
    want = TB._footprint_need_impl(*g, wv, fp, cam, kernel_size)
    assert got == want
    if name == "covers_every_tile":
        tiles = math.ceil(cam.width / 16) * math.ceil(cam.height / 16)
        assert got == {"pairs": tiles * g[0].shape[1],
                       "tile": g[0].shape[1]}
    if name in ("all_culled", "empty"):
        assert got == {"pairs": 0, "tile": 0}


def test_serving_request_counts_two_footprint_launches(cuda):
    """One serving request (run_nvs_replanned at PipelineConfig() width)
    plans its two stages with one footprint launch each: launches.footprint
    2, caps.plans 2, and the planned caps are the orbit stage's counts."""
    cfg = TCfg.PipelineConfig()
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0)).to(cuda)
    cams = TD.canonical_cameras(cfg)
    rng = np.random.default_rng(0)
    r = cfg.resolution
    images = rng.uniform(size=(1, r, r, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(1, r, r)).astype(np.float32)
    res, c = counted(lambda: TC.run_nvs_replanned(model, cfg, cams, images,
                                                  depth, device=cuda))
    assert res.attempts == 1
    assert c.get("launches.footprint", 0) == 2 and c["caps.plans"] == 2
    wv, fp, cam = serving_stage("nvs")
    need = TB._footprint_need_impl(res.merged["xyz"], res.merged["scaling"],
                                   res.merged["rotation"], wv, fp, cam,
                                   cfg.kernel_size)
    assert res.cfg.pair_cap == TB.suggest_pair_cap(need["pairs"])
    assert res.cfg.max_per_tile == -(-need["tile"] // 256) * 256


def test_footprint_kernel_refuses(cuda):
    """The wrapper raises on what the kernel does not take: float64 or
    non-contiguous inputs, a wrong width, no view, and a frame whose tile
    grid does not fit in a block's shared memory."""
    cam = torch_cases.orbit_camera(64, 64)
    wv, fp = cam.world_view[None], cam.full_proj[None]
    g = [torch.zeros(1, 8, k, device=cuda) for k in (3, 3, 4)]
    grid = (0.0, 4, 4)     # kernel_size and the 64^2 frame's tiles
    with pytest.raises(ValueError):
        cuda_raster.footprint_need(g[0].double(), g[1], g[2], wv, fp, cam, *grid)
    with pytest.raises(ValueError):
        cuda_raster.footprint_need(torch.zeros(1, 8, 6, device=cuda)[..., :3],
                                   g[1], g[2], wv, fp, cam, *grid)
    with pytest.raises(ValueError):
        cuda_raster.footprint_need(g[0], g[1], g[1], wv, fp, cam, *grid)
    with pytest.raises(ValueError):
        cuda_raster.footprint_need(*g, wv[:0], fp[:0], cam, *grid)
    huge = cam._replace(width=16384, height=16384)
    with pytest.raises(RuntimeError, match="shared memory"):
        cuda_raster.footprint_need(*g, wv, fp, huge, 0.0, 1024, 1024)
