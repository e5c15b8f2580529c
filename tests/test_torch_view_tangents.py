"""Render stages whose views each have their own tangents (the cameras a
pose-free model predicts): the stage's camera table, the cap planner and
the renders, on the CPU at 32 × 32 (pipeline/renderer.py,
ops/cuda_raster.py:camera_rows, ops/binning.py:footprint_need,
pipeline/cycle.py:stage_caps)."""
import math

import numpy as np
import pytest
import torch

from f3d_gaus_torch.ops import binning as TB
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import renderer as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

torch.set_num_threads(1)


def _cfg(height=None):
    return TCfg.PipelineConfig(resolution=32, height=height, fov_deg=50.0,
                               max_sh_degree=0, pair_cap=1 << 14,
                               max_per_tile=256, chunk=32)


def _views(n, cfg, fovs=None):
    """n cameras around the origin at cfg's frame (torch_cases.frame_camera),
    view v at fovs[v] degrees horizontally (cfg's when None): world_view,
    full_proj, cam_centers and each view's (tan_fovx, tan_fovy)."""
    fovs = [cfg.fov_deg] * n if fovs is None else fovs
    cams = [torch_cases.frame_camera(0.4 * v, cfg.resolution,
                                     cfg.frame_height, f)
            for v, f in zip(range(n), fovs)]
    return (np.stack([c.world_view for c in cams]),
            np.stack([c.full_proj for c in cams]),
            np.stack([c.cam_center for c in cams]),
            [(c.tan_fovx, c.tan_fovy) for c in cams])


def _gaussians(n=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    rot = torch.randn(1, n, 4, generator=g)
    xyz = torch.randn(1, n, 3, generator=g) * 0.4
    return {"xyz": xyz,
            "opacity": torch.rand(1, n, 1, generator=g) * 0.8 + 0.1,
            "scaling": torch.rand(1, n, 3, generator=g) * 0.05 + 0.01,
            "rotation": rot / rot.norm(dim=-1, keepdim=True),
            "features_dc": torch.rand(1, n, 1, 3, generator=g),
            "features_rest": torch.zeros(1, n, 0, 3)}


@pytest.mark.parametrize("height", [None, 24])
def test_equal_tangents_give_todays_rows(height):
    """A table built with every view at cfg's tangents is, bit for bit, the
    table built without per-view tangents."""
    cfg = _cfg(height)
    wv, fp, cc, _ = _views(4, cfg)
    same = [(cfg.tan_fov, cfg.tan_fovy)] * 4
    a = TR.camera_table(wv, fp, cc, cfg, "cpu")
    b = TR.camera_table(wv, fp, cc, cfg, "cpu", same)
    assert torch.equal(a, b)


def test_each_row_is_its_own_cameras():
    """Row v of camera_rows at per-view tangents is camera_scalars of view
    v's own camera (its focal lengths and clip limits)."""
    cfg = _cfg()
    wv, fp, cc, tans = _views(3, cfg, [40.0, 50.0, 63.0])
    cam = TR._camera(wv[0], fp[0], cc[0], cfg)
    rows = cuda_raster.camera_rows(cam, wv, fp, cc, 0.0, tans)
    for v, t in enumerate(tans):
        own = TR._camera(wv[v], fp[v], cc[v], cfg, t)
        np.testing.assert_array_equal(
            rows[v], np.asarray(cuda_raster.camera_scalars(own), np.float32))
    assert rows[0, 35] != rows[2, 35]


def test_mixed_tangents_stage_equals_single_renders():
    """A stage whose views have their own tangents (two share theirs)
    equals, bit for bit, each view rendered alone at its own camera (a
    stage of one view at its tangents, and render_gaussians at cfg's
    when they are cfg's)."""
    cfg = _cfg()
    wv, fp, cc, tans = _views(4, cfg, [44.0, 58.0, 44.0, 50.0])
    g = _gaussians()
    bg = torch.zeros(3)
    out = TR.render_views_batched(g, wv, fp, cc, bg, cfg, "cpu", tans)
    assert not bool(out["overflow"].any())
    for v, t in enumerate(tans):
        one = TR.render_views_batched(g, wv[v:v + 1], fp[v:v + 1],
                                      cc[v:v + 1], bg, cfg, "cpu", [t])
        for k in ("render", "rendered_depth", "rendered_alpha",
                  "rendered_normal", "depth_normal"):
            assert torch.equal(out[k][0, v], one[k][0, 0]), (v, k)
    # view 3 is at cfg's 50 degrees: render_gaussians renders it the same
    plain = TR.render_gaussians(g, 0, wv[3], fp[3], cc[3], bg, cfg)
    assert torch.equal(out["render"][0, 3], plain["render"])
    # a view's tangents change what it sees
    assert not torch.equal(out["render"][0, 0], out["render"][0, 1])


def test_views_of_equal_tangents_share_a_stage(monkeypatch):
    """A stage whose views share their tangents (given per view or by
    cfg) may take the graph route; one whose views differ in them renders
    eagerly, each view at its own, without asking."""
    cfg = _cfg()
    wv, fp, cc, tans = _views(5, cfg, [40.0, 50.0, 40.0, 50.0, 60.0])
    asked = []
    monkeypatch.setattr(TR, "_graph_route",
                        lambda dev, g, n: asked.append(n) or False)
    g = _gaussians()
    bg = torch.zeros(3)
    TR.render_views_batched(g, wv, fp, cc, bg, cfg, "cpu", [tans[0]] * 5)
    TR.render_views_batched(g, wv, fp, cc, bg, cfg, "cpu")
    assert asked == [5, 5]
    out = TR.render_views_batched(g, wv, fp, cc, bg, cfg, "cpu", tans)
    assert asked == [5, 5]
    for v, t in enumerate(tans):
        one = TR.render_views_batched(g, wv[v:v + 1], fp[v:v + 1],
                                      cc[v:v + 1], bg, cfg, "cpu", [t])
        assert torch.equal(out["render"][:, v], one["render"][:, 0])


@pytest.mark.parametrize("height", [None, 24])
def test_planned_caps_take_each_views_tangents(height):
    """footprint_need at per-view tangents is the largest of each view's
    own need, and stage_caps plans from it; at cfg's tangents it is
    today's plan."""
    cfg = _cfg(height)
    wv, fp, cc, tans = _views(3, cfg, [30.0, 50.0, 70.0])
    g = _gaussians()
    cam = TR._camera(wv[0], fp[0], cc[0], cfg)
    need = TB.footprint_need(g["xyz"], g["scaling"], g["rotation"], wv, fp,
                             cam, 0.0, tans)
    each = [TB.footprint_need(g["xyz"], g["scaling"], g["rotation"],
                              wv[v:v + 1], fp[v:v + 1],
                              cam._replace(tan_fovx=t[0], tan_fovy=t[1]))
            for v, t in enumerate(tans)]
    assert need == {"pairs": max(e["pairs"] for e in each),
                    "tile": max(e["tile"] for e in each)}
    assert len({e["pairs"] for e in each}) == 3
    same = [(cfg.tan_fov, cfg.tan_fovy)] * 3
    assert (Tcycle.stage_caps(g, wv, fp, cfg, same)
            == Tcycle.stage_caps(g, wv, fp, cfg))


def test_pixel_rays_keep_a_bounded_cache():
    """Each field of view builds its own rays; the cache keeps the last
    few, so predicted cameras do not grow it request after request."""
    before = dict(TR._RAYS)
    try:
        TR._RAYS.clear()
        for i in range(3 * TR._RAYS_KEPT):
            t = 0.3 + 0.01 * i
            TR._pixel_rays(8, 8, t, t, torch.device("cpu"))
        assert len(TR._RAYS) == TR._RAYS_KEPT
        rays = TR._pixel_rays(8, 8, 0.5, 0.25, torch.device("cpu"))
        assert math.isclose(float(rays[0, 0, 0]), -4.0 / (8 / (2 * 0.5)))
        assert math.isclose(float(rays[0, 0, 1]), -4.0 / (8 / (2 * 0.25)))
    finally:
        TR._RAYS.clear()
        TR._RAYS.update(before)
