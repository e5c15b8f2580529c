"""A render stage's camera table, its route and its accounting, on the CPU
(pipeline/renderer.py, utils/profiling.py).

render_views_batched uploads a stage's cameras once, as a table whose row
holds each view's preprocess camera (cuda_raster.camera_scalars) and its
camera-to-world; it renders a stage of two or more views of Gaussians whose
renders take the preprocess kernel as CUDA graphs, every other stage
eagerly.  Here: the table's rows against each view's own camera, bit for
bit; the route choice; an eager stage against single renders; the pixel
rays depth_to_normal builds once a size; depth_to_normal's public
arguments against the JAX package's; how a capture and its replays count.
The graph route itself runs on the card, in tests/test_torch_cuda.py."""
import inspect

import numpy as np
import pytest
import torch

from f3d_gaus_tpu.pipeline import renderer as Jrenderer
from f3d_gaus_torch.core import device as TDev
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.pipeline import renderer as TR
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

SMALL = dict(resolution=32, pair_cap=1 << 12, max_per_tile=256, chunk=32)


def _stage_cameras(stage, cfg):
    cams = TD.canonical_cameras(cfg)
    pick = (Tcycle.aggregation_cameras if stage == "aggregation"
            else Tcycle.nvs_cameras)
    return pick(cfg, cams.inverse_first_camera)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("kernel_size", [0.0, 0.1])
@pytest.mark.parametrize("stage", ["aggregation", "nvs"])
def test_camera_table_rows_are_each_views_camera(stage, kernel_size):
    """Row v of a stage's table holds view v's camera_scalars and its
    camera-to-world (_c2w), bit for bit, the columns between them 0."""
    cfg = TCfg.PipelineConfig(kernel_size=kernel_size)
    cs = _stage_cameras(stage, cfg)
    table = TR.camera_table(cs.world_view, cs.full_proj, cs.cam_centers, cfg,
                            "cpu")
    V = len(cs.world_view)
    assert table.shape == (V, TR.ROW_FLOATS) and table.dtype == torch.float32
    assert V == (cfg.num_aggregation_views if stage == "aggregation"
                 else cfg.num_nvs_views + 1)
    rows = table.numpy()
    for v in range(V):
        cam = TR._camera(cs.world_view[v], cs.full_proj[v],
                         cs.cam_centers[v], cfg)
        want = np.float32(cuda_raster.camera_scalars(cam, kernel_size))
        assert (_bits(rows[v, :TR.CAMERA_FLOATS]) == _bits(want)).all(), v
        c2w = TR._c2w(cs.world_view[v], torch.device("cpu")).numpy()
        assert (_bits(rows[v, TR.C2W_OFFSET:]) == _bits(c2w.reshape(-1))).all()
        assert not rows[v, TR.CAMERA_FLOATS:TR.C2W_OFFSET].any()
    # the kernel's camera row and the c2w start on 16-byte boundaries
    assert TR.C2W_OFFSET % 4 == 0 and TR.ROW_FLOATS % 4 == 0


def _gaussians(batch=1, requires_grad=False, n=48):
    rng = np.random.default_rng(5)
    clouds = [torch_cases.make_gaussian_cloud(rng, n, spread=0.35)
              for _ in range(batch)]
    g = {}
    for k, i in (("xyz", 0), ("scaling", 1), ("rotation", 2),
                 ("opacity", 3)):
        g[k] = torch.from_numpy(np.stack([c[i] for c in clouds]))
    shs = torch.from_numpy(np.stack([c[4] for c in clouds]))
    g["features_dc"], g["features_rest"] = shs[:, :, :1], shs[:, :, 1:]
    if requires_grad:
        g = {k: v.clone().requires_grad_() for k, v in g.items()}
    return g


ROUTES = {  # device, inputs require grad, grad mode, views -> graphs?
    "cpu_tensors": ("cpu", False, True, 8, False),
    "recorded_by_autograd": ("cuda", True, True, 8, False),
    "requires_grad_in_no_grad": ("cuda", True, False, 8, True),
    "one_view": ("cuda", False, True, 1, False),
    "two_views": ("cuda", False, True, 2, True),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_graph_route_choice(case):
    """A stage takes the graph route only for two or more views of
    Gaussians whose renders take the preprocess kernel: CUDA tensors and
    nothing for autograd to record (rasterize._kernel_preprocess)."""
    dev, grad, mode, views, want = ROUTES[case]
    g = _gaussians(requires_grad=grad)
    with torch.set_grad_enabled(mode):
        assert TR._graph_route(torch.device(dev), g, views) is want


@pytest.mark.parametrize("requires_grad", [False, True])
def test_eager_stage_equals_single_renders(monkeypatch, requires_grad):
    """On CPU tensors a stage renders eagerly (the graph route is never
    taken) and equals render_gaussians view by view and element by
    element, bit for bit, with the (B, V) overflow map; a differentiated
    stage keeps its gradient."""
    monkeypatch.setattr(TR, "_graph_stage", lambda *a: pytest.fail(
        "a CPU stage took the graph route"))
    cfg = TCfg.PipelineConfig(**SMALL)
    cs = torch_cases.orbit_views(3)
    g = _gaussians(batch=2, requires_grad=requires_grad)
    bg = torch.tensor([0.1, 0.2, 0.3])
    out = TR.render_views_batched(g, cs.world_view, cs.full_proj,
                                  cs.cam_centers, bg, cfg, device="cpu")
    assert list(out) == ["render", "rendered_normal", "rendered_depth",
                         "depth_normal", "rendered_alpha", "distortion_map",
                         "overflow"]
    assert out["overflow"].shape == (2, 3) and out["overflow"].dtype == torch.bool
    assert out["render"].shape == (2, 3, 3, 32, 32)
    for v in range(3):
        for b in range(2):
            one = TR.render_gaussians(g, b, cs.world_view[v], cs.full_proj[v],
                                      cs.cam_centers[v], bg, cfg)
            assert torch.equal(one["visibility_filter"], one["radii"] > 0)
            for k in out:
                assert torch.equal(out[k][b, v], one[k]), (k, b, v)
    if requires_grad:
        (out["render"].sum() + out["depth_normal"].sum()).backward()
        assert all(t.grad is not None and torch.isfinite(t.grad).all()
                   for t in g.values())


def test_non_square_stage_equals_the_plain_route():
    """A serving stage at 48 × 32 (PipelineConfig's height and its y
    tangent) at the caps stage_caps plans for it equals, bit for bit, the
    plain route: rasterize.render through each view's non-square camera,
    the normals turned to the world and depth_to_normal at 48 × 32; the
    plan fits every view and is no larger than the largest binning."""
    from f3d_gaus_torch.ops import binning, rasterize
    cfg = TCfg.PipelineConfig(resolution=48, height=32, fov_deg=60.0,
                              max_sh_degree=0, pair_cap=1 << 12,
                              max_per_tile=256, chunk=32)
    assert cfg.frame_height == 32
    assert cfg.tan_fovy == pytest.approx(cfg.tan_fov * 32 / 48, rel=1e-15)
    cams = [torch_cases.frame_camera(a, 48, 32) for a in (0.2, 1.9, 4.0)]
    assert all(c.tan_fovx == cfg.tan_fov and c.tan_fovy == cfg.tan_fovy
               for c in cams)
    rng = np.random.default_rng(7)
    cloud = torch_cases.make_gaussian_cloud(rng, 400, center=(0.0, 0.0, 0.0),
                                            spread=0.5, sh_degree=0)
    g = {k: torch.from_numpy(cloud[i])[None] for k, i in (
        ("xyz", 0), ("scaling", 1), ("rotation", 2), ("opacity", 3))}
    g["features_dc"] = torch.from_numpy(cloud[4])[None]
    g["features_rest"] = g["features_dc"][:, :, :0]
    wv = np.stack([c.world_view for c in cams])
    fp = np.stack([c.full_proj for c in cams])
    cc = np.stack([c.cam_center for c in cams])
    run = Tcycle.stage_caps(g, wv, fp, cfg)
    bg = torch.zeros(3)
    out = TR.render_views_batched(g, wv, fp, cc, bg, run, device="cpu")
    assert out["render"].shape == (1, 3, 3, 32, 48)
    assert not bool(out["overflow"].any())
    most = 0
    for v, cam in enumerate(cams):
        plain = rasterize.render(
            g["xyz"][0], g["scaling"][0], g["rotation"][0], g["opacity"][0],
            g["features_dc"][0], cam, bg, sh_degree=0,
            pair_cap=run.pair_cap, max_per_tile=run.max_per_tile,
            chunk=run.chunk)
        rn = plain["rendered_normal"]
        rn = rn * torch.rsqrt(torch.sum(rn * rn, 0, keepdim=True) + 1e-12)
        c2w = torch.from_numpy(np.linalg.inv(wv[v].T).astype(np.float32))
        want = {"render": plain["render"],
                "rendered_normal": (c2w[:3, :3] @ rn.reshape(3, -1)
                                    ).reshape(rn.shape),
                "rendered_depth": plain["rendered_depth"],
                "depth_normal": TR.depth_to_normal(
                    wv[v], plain["rendered_depth"], 48, 32, cam.tan_fovx,
                    cam.tan_fovy),
                "rendered_alpha": plain["rendered_alpha"],
                "distortion_map": plain["distortion_map"]}
        for k, t in want.items():
            assert torch.equal(out[k][0, v], t), (k, v)
        pre = rasterize.prepare(
            g["xyz"][0], g["scaling"][0], g["rotation"][0], g["opacity"][0],
            g["features_dc"][0], cam, bg, sh_degree=0, pair_cap=1 << 14)
        most = max(most, int(pre.binning.num_pairs))
    assert most > 0 and run.pair_cap == binning.suggest_pair_cap(most)


def test_pixel_rays_are_built_once_a_size():
    """depth_to_normal's pixel rays are built once a size and field of
    view and kept, and depth_to_normal gives the rays it always gave."""
    dev = torch.device("cpu")
    a = TR._pixel_rays(24, 16, 0.3, 0.2, dev)
    assert TR._pixel_rays(24, 16, 0.3, 0.2, dev) is a
    assert TR._pixel_rays(16, 24, 0.3, 0.2, dev) is not a
    gy, gx = torch.meshgrid(torch.arange(16, dtype=torch.float32),
                            torch.arange(24, dtype=torch.float32),
                            indexing="ij")
    want = torch.stack([(gx - 12.0) / (24 / 0.6), (gy - 8.0) / (16 / 0.4),
                        torch.ones_like(gx)], -1)
    assert torch.equal(a, want)


def test_depth_to_normal_takes_the_jax_arguments():
    """depth_to_normal keeps the JAX package's public arguments, in order,
    however its inner pieces are cached."""
    got = list(inspect.signature(TR.depth_to_normal).parameters)
    want = list(inspect.signature(Jrenderer.depth_to_normal).parameters)
    assert got == want == ["world_view", "depth", "width", "height",
                           "tan_fovx", "tan_fovy"]


def test_upload_is_a_copy_on_the_cpu():
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = TDev.upload(a, torch.device("cpu"))
    a[0, 0] = 9.0
    assert t.dtype == torch.float32 and t.tolist() == [[0, 1, 2], [3, 4, 5]]


def test_replays_count_what_the_capture_counted():
    """Inside captured() counts go to the capture's tally, whether tracing
    is on or not, and spans record no event; each replayed() adds
    graph.replays and, while tracing is on, the tally again, a tensor
    count as its value at that replay."""
    with profiling.captured() as tally:
        profiling.count("launches.fwd")
        profiling.count("binning.slots", 256)
        pairs = torch.tensor(5)
        profiling.count("binning.pairs", pairs)
    assert [n for n, _ in tally] == ["launches.fwd", "binning.slots",
                                     "binning.pairs"]
    profiling.replayed(tally)               # tracing off: nothing
    with profiling.record():
        with profiling.captured() as inner:
            with profiling.span("binning") as sp:
                pass
        assert sp.ev0 is None and sp.ev1 is None and inner == []
        profiling.count("launches.fwd")      # the eager render's
        profiling.replayed(tally)
        pairs.fill_(7)                       # the next replay's num_pairs
        profiling.replayed(tally)
        pairs.fill_(0)
        snap = profiling.snapshot()
    c = snap["counters"]
    assert c["graph.replays"] == 2 and c["launches.fwd"] == 3
    assert c["binning.slots"] == 512 and c["binning.pairs"] == 12
    assert snap["spans"]["binning"]["calls"] == 1
