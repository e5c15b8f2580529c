"""The stage cap planner on the CPU (ops/binning.py:footprint_need,
ops/cuda_raster.py): the plain version is what CPU tensors take, and no
kernel launch is counted there; CUDA tensors go to the kernel's wrapper,
which refuses CPU tensors; the wrapper's camera table holds each view's
preprocess camera bit for bit; tile_rects rounds as PyTorch evaluates
x + r + BLOCK - 1, left to right, which csrc/footprint.cu mirrors; and
the kernel's source shares the preprocess's footprint arithmetic
(csrc/screen.cuh) instead of keeping a copy.  The kernel itself runs on
the card, in tests/test_torch_cuda_plan.py."""
import re
import types

import numpy as np
import pytest
import torch

from f3d_gaus_torch.core.cameras import Camera
from f3d_gaus_torch.ops import binning as TB
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _nvs_stage(res=32):
    cfg = TCfg.PipelineConfig(resolution=res, num_nvs_views=6)
    inv = TD.canonical_cameras(cfg).inverse_first_camera
    cs = Tcycle.nvs_cameras(cfg, inv)
    return cs, cs.camera(0, res, res, cfg.tan_fov, cfg.tan_fov)


def _cloud(B=2, n=400, seed=0):
    rng = np.random.default_rng(seed)
    g = []
    for _ in range(B):
        xyz, s, q, *_ = torch_cases.make_gaussian_cloud(rng, n)
        g.append((xyz, s, q))
    return [torch.from_numpy(np.stack(a)) for a in zip(*g)]


def test_footprint_need_on_cpu_takes_the_plain_version(monkeypatch):
    """On CPU tensors footprint_need is the plain version's count, counts
    no launches.footprint, and never calls the kernel's wrapper."""
    cs, cam = _nvs_stage()
    g = _cloud()

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called")
    monkeypatch.setattr(cuda_raster, "footprint_need", refuse)
    with profiling.record():
        got = TB.footprint_need(*g, cs.world_view, cs.full_proj, cam, 0.1)
        counters = profiling.snapshot()["counters"]
    assert "launches.footprint" not in counters
    assert got == TB._footprint_need_impl(*g, cs.world_view, cs.full_proj,
                                          cam, 0.1)
    assert got["pairs"] > 0 and got["tile"] > 0


def test_footprint_need_takes_the_kernel_for_cuda_tensors(monkeypatch):
    """A CUDA tensor goes to cuda_raster.footprint_need, made contiguous,
    with the cameras, kernel_size and per-view tangents (None) as given
    and the frame's tile grid from binning.BLOCK, and its count is returned unchanged; the plain
    version is not run."""
    seen = {}

    def kernel(*a):
        seen["args"] = a
        return {"pairs": 7, "tile": 3}

    def plain(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(cuda_raster, "footprint_need", kernel)
    monkeypatch.setattr(TB, "_footprint_need_impl", plain)

    def fake(tag):
        return types.SimpleNamespace(is_cuda=True,
                                     contiguous=lambda: f"{tag}-contiguous")
    wv, fp = object(), object()
    cam = types.SimpleNamespace(width=40, height=20)
    got = TB.footprint_need(fake("xyz"), fake("s"), fake("q"), wv, fp, cam,
                            0.3)
    assert got == {"pairs": 7, "tile": 3}
    assert seen["args"] == ("xyz-contiguous", "s-contiguous", "q-contiguous",
                            wv, fp, cam, 0.3, 3, 2, None)


def test_kernel_wrapper_refuses_cpu_tensors():
    """cuda_raster.footprint_need takes CUDA tensors only: on CPU tensors it
    raises before any build or launch."""
    cs, cam = _nvs_stage()
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_raster.footprint_need(*_cloud(), cs.world_view, cs.full_proj,
                                   cam, 0.0, 2, 2)


@pytest.mark.parametrize("centers", [False, True])
@pytest.mark.parametrize("kernel_size", [0.0, 0.3])
def test_camera_rows_are_each_views_camera_scalars(kernel_size, centers):
    """Row v of camera_rows is camera_scalars of view v's camera (its
    world_view, full_proj and cam_center, zeros without centres; the
    stage's size, tangents and kernel_size), bit for bit, at a non-square
    frame."""
    cams = [torch_cases.frame_camera(a, 96, 54) for a in (0.0, 0.7, 2.1)]
    wv = np.stack([c.world_view for c in cams])
    fp = np.stack([c.full_proj for c in cams])
    cc = np.stack([c.cam_center for c in cams]) if centers else None
    rows = cuda_raster.camera_rows(cams[0], wv, fp, cc, kernel_size)
    assert rows.shape == (3, cuda_raster.CAMERA_FLOATS)
    assert rows.dtype == np.float32
    for v, c in enumerate(cams):
        center = c.cam_center if centers else np.zeros(3, np.float32)
        want = np.float32(cuda_raster.camera_scalars(
            Camera(c.world_view, c.full_proj, center, 96, 54, c.tan_fovx,
                   c.tan_fovy), kernel_size))
        assert np.array_equal(rows[v].view(np.int32), want.view(np.int32))


def _f32_rect_hi(m, r):
    """((m + r) + 16) - 1, then / 16 and floor, each in float32."""
    f = np.float32
    return int(np.floor((((f(m) + f(r)) + f(16)) - f(1)) / f(16)))


@pytest.mark.parametrize("case", ["on_a_boundary", "rounds_up_past_one",
                                  "clamped"])
def test_tile_rects_add_left_to_right(case):
    """tile_rects' upper bounds are floor((((m + r) + 16) - 1) / 16) in
    float32, the order PyTorch evaluates m + r + BLOCK - 1, clamped to
    [0, grid]: a mean whose m + r lands exactly on a tile boundary stops
    there (the bound is exclusive); one whose m + r is 2 ulps under 17
    reaches tile 2, where m + r + 15 in one rounding would stop at 1;
    means past the frame clamp to the grid."""
    f = np.float32
    if case == "on_a_boundary":
        m, r, hi, want = f(31.0), 1, 2, (1, 2)
    elif case == "rounds_up_past_one":
        m = np.nextafter(np.nextafter(f(16.0), f(0)), f(0))
        r, hi, want = 1, 2, (0, 2)
        assert f(m) + f(r) == f(16.999998092651367)
        assert np.floor((np.float64(m) + r + 15) / 16) == 1
    else:
        m, r, hi, want = f(100.0), 3, 7, (2, 2)
    assert _f32_rect_hi(m, r) == hi
    means = torch.tensor([[m, m]], dtype=torch.float32)
    radii = torch.tensor([r], dtype=torch.int32)
    xmin, ymin, xmax, ymax, count = TB.tile_rects(means, radii, 32, 32)
    assert (int(xmin[0]), int(xmax[0])) == want
    assert (int(ymin[0]), int(ymax[0])) == want
    assert int(count[0]) == (want[1] - want[0]) ** 2


def test_footprint_kernel_shares_the_preprocess_arithmetic():
    """csrc/footprint.cu and csrc/preprocess.cu both take the footprint's
    arithmetic (project, rotmat, cov3d, cov2d, extent, ndc_to_pix) from
    csrc/screen.cuh, and neither defines its own; the loader builds the
    footprint kernel and binds its entry point."""
    csrc = cuda_raster.CSRC
    shared = ("project", "rotmat", "cov3d", "cov2d", "extent", "ndc_to_pix",
              "col", "dot3")
    header = (csrc / "screen.cuh").read_text()
    for fn in shared:
        assert re.search(rf"__device__ __forceinline__ \w+ {fn}\(", header), fn
    for name in ("footprint", "preprocess"):
        src = cuda_raster.SOURCES[name].read_text()
        assert '#include "screen.cuh"' in src
        for fn in shared:
            assert not re.search(rf"__device__[^;{{]* {fn}\(", src), (name, fn)
    assert cuda_raster.ENTRY["footprint"] == ("f3d_footprint_need",)
