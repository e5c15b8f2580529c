"""Which preprocess rasterize.prepare takes, on the CPU.

prepare takes the preprocess kernel (cuda_raster.preprocess, csrc/
preprocess.cu) only for CUDA tensors that autograd records nothing of, with
no colors_precomp; everything else composes the same tables in
rasterize._preprocess_impl.  Here: the routing predicate, prepare's tables
on each composed route (CPU tensors, inputs that require grad, given
colours) and that none counts a launch, the kernel's plain version at each
SH degree and the tables composite takes as they are, the kernel wrapper's
refusal of CPU tensors, the f32 camera scalars the kernel is given and the
order it sums |d|^2 in.  The kernel itself is held against the composed
route on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from f3d_gaus_torch.core import cameras
from f3d_gaus_torch.core import gaussians as G
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

torch.set_num_threads(1)

CUDA = torch.device("cuda")     # a device object only: no card is needed


def _case():
    _, cam, cloud, bg, kw = torch_cases.small_cases()[0]
    return cam, [torch.from_numpy(a) for a in cloud], torch.from_numpy(bg), kw


def test_kernel_route_predicate():
    """The kernel route needs a CUDA device, no colours, and nothing for
    autograd to record: grad mode off or no input that requires grad."""
    _, t, _, _ = _case()
    leaf = [t[0].clone().requires_grad_()] + t[1:]
    assert TR._kernel_preprocess(CUDA, t, None)
    assert not TR._kernel_preprocess(torch.device("cpu"), t, None)
    assert not TR._kernel_preprocess(CUDA, t, t[0])
    for i in range(5):
        one = list(t)
        one[i] = one[i].clone().requires_grad_()
        assert not TR._kernel_preprocess(CUDA, one, None), i
    with torch.no_grad():
        assert TR._kernel_preprocess(CUDA, leaf, None)
        assert not TR._kernel_preprocess(CUDA, leaf, t[0])


def _composed_tables(t, colors, cam, sh_degree=1):
    """The tables of the composed route, from core.gaussians.preprocess and
    rasterize._all_features: (feat, extra, radii, the Preprocessed)."""
    ref = G.preprocess(*t, sh_degree, cam)
    opa_flat = t[3].reshape(-1)
    feat = TR._all_features(ref.v2g_mb, ref.rgb if colors is None else colors,
                            opa_flat + (ref.opa_coef - opa_flat))
    return feat, torch.cat([ref.conic, ref.means2d], 1), ref.radii, ref


@pytest.mark.parametrize("route", ["cpu", "requires_grad", "colors_precomp"])
def test_prepare_composes_with_todays_values(route):
    """On each route that composes, prepare hands composite the tables of
    core.gaussians.preprocess (the feature table of its v2g_mb, colours or
    the given ones, and opacity times its coefficient; conic | means2d;
    its radii), bins its means2d and depths, and counts no preprocess
    launch; the feature table takes a gradient only where an input
    requires one."""
    cam, t, bg, kw = _case()
    colors = None
    if route == "requires_grad":
        t = [a.clone().requires_grad_() for a in t]
    elif route == "colors_precomp":
        colors = torch.rand((t[0].shape[0], 3),
                            generator=torch.Generator().manual_seed(0))
    with profiling.record():
        inp = TR.prepare(*t, cam, bg, colors_precomp=colors, **kw)
        counters = profiling.snapshot()["counters"]
    assert "launches.preprocess" not in counters
    feat, extra, radii, ref = _composed_tables(t, colors, cam)
    assert torch.equal(inp.feat, feat)
    assert torch.equal(inp.extra, extra)
    assert torch.equal(inp.radii, radii)
    bng, _ = TR.bin_band(ref.means2d, ref.radii, ref.depths, cam,
                         pair_cap=kw["pair_cap"],
                         max_per_tile=kw["max_per_tile"], chunk=kw["chunk"])
    for f in ("point_list", "tile_start", "tile_count", "num_pairs"):
        assert torch.equal(getattr(inp.binning, f), getattr(bng, f)), f
    assert inp.feat.requires_grad == (route == "requires_grad")


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_plain_version_and_the_tables_composite_takes(sh_degree):
    """rasterize._preprocess_impl, the preprocess kernel's plain version,
    gives at each SH degree the composed route's (feat, extra, depths,
    radii), which are what prepare hands composite, with no launch
    counted.  composite renders from the tables it is handed as they are
    (an opacity column of 0 leaves only the background)."""
    cam, _, bg, kw = _case()
    t = [torch.from_numpy(a) for a in torch_cases.make_gaussian_cloud(
        np.random.default_rng(sh_degree), 96, sh_degree=sh_degree)]
    with profiling.record():
        feat, extra, depths, radii = TR._preprocess_impl(*t, sh_degree, cam)
        inp = TR.prepare(*t, cam, bg, sh_degree=sh_degree, **kw)
        counters = profiling.snapshot()["counters"]
    assert "launches.preprocess" not in counters
    want_feat, want_extra, want_radii, ref = _composed_tables(t, None, cam,
                                                              sh_degree)
    assert torch.equal(feat, want_feat) and torch.equal(extra, want_extra)
    assert torch.equal(depths, ref.depths) and torch.equal(radii, want_radii)
    assert (torch.equal(inp.feat, feat) and torch.equal(inp.extra, extra)
            and torch.equal(inp.radii, radii))
    out, _ = TR.composite(inp)
    assert float(out[..., 7].max()) > 0.1
    clear = feat.clone()
    clear[:, TR.ROW_OPA] = 0.0
    empty, aux = TR.composite(inp._replace(feat=clear))
    assert float(empty[..., 7].abs().max()) == 0.0
    assert bool((aux.final_T == 1).all())


def test_preprocess_kernel_refuses_cpu_tensors():
    """cuda_raster.preprocess takes CUDA tensors only, as the compositing
    wrappers do: CPU tensors raise ValueError before any build or launch
    (prepare composes for them: rasterize._kernel_preprocess)."""
    cam, t, _, _ = _case()
    with profiling.record():
        with pytest.raises(ValueError, match="CUDA"):
            cuda_raster.preprocess(*t, 1, cam)
        counters = profiling.snapshot()["counters"]
    assert "launches.preprocess" not in counters


def test_sh_direction_norm_sums_left_to_right(monkeypatch):
    """The composed route's viewing directions (core/sh.py) divide by
    sqrt((d0^2 + d1^2) + d2^2 + 1e-16) in f32, an order the code fixes
    itself (csrc/preprocess.cu adds in it too): bit for bit d / torch.sqrt
    of that sum evaluated in numpy's f32, one rounding an operation."""
    from f3d_gaus_torch.core import sh as TSH
    seen = []
    eval_sh = TSH.eval_sh
    monkeypatch.setattr(TSH, "eval_sh", lambda deg, shs, dirs: (
        seen.append(dirs), eval_sh(deg, shs, dirs))[1])
    rng = np.random.default_rng(3)
    means = rng.normal(size=(4096, 3)).astype(np.float32) * 5
    means[:4] = 0.0             # at the camera: |d| = 0
    campos = np.float32([0.0, 0.0, 0.0])
    shs = rng.normal(size=(4096, 4, 3)).astype(np.float32)
    TSH.sh_color_from_gaussians(1, torch.from_numpy(shs),
                                torch.from_numpy(means),
                                torch.from_numpy(campos))
    d = means - campos
    sq = d * d
    n2 = sq[:, 0:1] + sq[:, 1:2] + sq[:, 2:3] + np.float32(1e-16)
    assert n2.dtype == np.float32
    want = torch.from_numpy(d) / torch.sqrt(torch.from_numpy(n2))
    assert torch.equal(seen[0].view(torch.int32), want.view(torch.int32))
    # the order matters on these inputs: another moves some of the sums
    other = sq[:, 0:1] + sq[:, 2:3] + sq[:, 1:2] + np.float32(1e-16)
    assert (other != n2).any()


def _composed_scalars(camera, kernel_size, scale_modifier):
    """The f32 camera constants the composed preprocess computes with, read
    back from the operations that round them: _mat's entries, _scalar_over's
    0-d tensors, max_tie's bounds and Python scalars in f32 arithmetic."""
    one = torch.ones((), dtype=torch.float32)
    mats = [v for m in (G._mat(camera.world_view), G._mat(camera.full_proj))
            for row in m for v in row]
    cc = torch.as_tensor(np.asarray(camera.cam_center, np.float32)).tolist()
    return (torch.tensor(mats, dtype=torch.float32).tolist() + cc
            + [torch.full((), camera.focal_x, dtype=torch.float32).item(),
               torch.full((), camera.focal_y, dtype=torch.float32).item(),
               one.new_full((), 1.3 * camera.tan_fovx).item(),
               one.new_full((), 1.3 * camera.tan_fovy).item(),
               (one * 0 + kernel_size).item(),
               (one * scale_modifier).item(),
               (one * camera.width).item(), (one * camera.height).item()])


@pytest.mark.parametrize("kind", ["orbit", "float32_fov", "odd_frame"])
def test_camera_scalars_match_the_composed_route(kind):
    """cuda_raster.camera_scalars, the kernel's camera arguments, are the
    f32 values of the composed route's own expressions, in
    csrc/screen.cuh's Camera order (which preprocess.cu includes), for a
    field of view given as a Python float or as an np.float32 and at an
    odd kernel_size and scale_modifier."""
    cam = torch_cases.orbit_camera(64, 48)
    if kind == "float32_fov":
        cam = cam._replace(tan_fovx=np.float32(0.1234567),
                           tan_fovy=np.float32(0.0987654))
    elif kind == "odd_frame":
        cam = cameras.Camera(cam.world_view, cam.full_proj, cam.cam_center,
                             333, 77, 0.31, 0.07)
    ks, sm = (0.1, 0.7) if kind == "odd_frame" else (0.0, 1.0)
    got = cuda_raster.camera_scalars(cam, ks, sm)
    assert len(got) == cuda_raster.CAMERA_FLOATS
    assert got == _composed_scalars(cam, ks, sm)
    assert all(float(np.float32(v)) == v for v in got)
    src = cuda_raster.SOURCES["preprocess"].read_text()
    assert '#include "screen.cuh"' in src
    header = (cuda_raster.CSRC / "screen.cuh").read_text()
    assert f"kCameraFloats = {cuda_raster.CAMERA_FLOATS};" in header
