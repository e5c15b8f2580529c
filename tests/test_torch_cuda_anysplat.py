"""AnySplat and per-view tangents on the card: one frame block and one global
block at the published widths (24 frames of 1,029 tokens, width 1024)
against the plain reference models/anysplat_reference.py; the voxel merge
over 4,816,896 Gaussians against the reference's; a render stage whose
views have their own tangents through CUDA graphs against its eager
stage, bit for bit, and the footprint kernel at per-view tangents against
its plain version; a mid-size AnySplat at the published widths (4 views
at 112²) through run_gslrm, pose-free.  Needs a CUDA device; skips
elsewhere.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_anysplat.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from f3d_gaus_torch.core.device import resolve_device
from f3d_gaus_torch.models import anysplat as A
from f3d_gaus_torch.models import anysplat_reference as AR
from f3d_gaus_torch.models import dinov2 as D
from f3d_gaus_torch.models.vggt import token_positions
from f3d_gaus_torch.ops import binning as TB
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.pipeline import renderer as TR
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@torch.no_grad()
@pytest.mark.parametrize("kind", ["frame", "global"])
def test_block_at_the_published_widths(cuda, kind):
    """A block with QK-norm and 2D RoPE over 24 frames of 1,029 tokens (a
    frame block: 24 sequences; a global block: one of 24,696) against the
    reference's block holding the same weights; LayerScale 1 so the
    attention's error is not scaled away."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.device(cuda):
        ref = AR.Block(1024, 16, 4096, 1.0, True, gen)
        blk = D.Block(1024, 16, 4096, 1.0, True)
    blk.load_state_dict(ref.state_dict())
    S, T = 24, 1029
    x = torch.randn(S, T, 1024, generator=gen, device=cuda)
    pos = token_positions(32, 32, 5, cuda)
    cos, sin = D.rope_tables(pos, 64, 100.0)
    ang = AR.rope_angles(pos.float(), 64, 100.0)
    if kind == "global":
        x = x.reshape(1, S * T, 1024)
        cos, sin, ang = cos.repeat(S, 1), sin.repeat(S, 1), ang.repeat(S, 1)
    got = blk(x, (cos, sin))
    want = ref(x, ang)
    assert _rel(got - x, want - x) < 2e-5


@torch.no_grad()
def test_voxel_merge_at_the_published_count(cuda):
    """4,816,896 pixel Gaussians: the reference's keys, fields within f32
    rounding, and the same bits on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    n = 24 * 448 * 448
    rot = torch.randn(n, 4, generator=gen, device=cuda)
    g = {"xyz": torch.randn(n, 3, generator=gen, device=cuda) * 0.3
         + torch.tensor([0.0, 0.0, 3.0], device=cuda),
         "opacity": torch.rand(n, 1, generator=gen, device=cuda),
         "scaling": torch.rand(n, 3, generator=gen, device=cuda) * 0.01,
         "rotation": rot / rot.norm(dim=-1, keepdim=True),
         "features_dc": torch.randn(n, 1, 3, generator=gen, device=cuda)}
    conf = torch.randn(n, generator=gen, device=cuda)
    out, keys = A.voxel_merge(g, conf, 0.008)
    out2, keys2 = A.voxel_merge(g, conf, 0.008)
    want, wkeys = AR.merge(g, conf, 0.008)
    assert torch.equal(keys, wkeys) and torch.equal(keys, keys2)
    assert keys.shape[0] < n
    for k in g:
        assert torch.equal(out[k], out2[k]), k
        assert _rel(out[k], want[k]) < 1e-5, k


def _stage_case(cuda, fovs):
    rng = np.random.default_rng(0)
    cloud = torch_cases.make_gaussian_cloud(rng, 300_000, center=(0, 0, 0),
                                            spread=0.6, sh_degree=0,
                                            scale_range=(0.002, 0.02))
    g = {k: torch.from_numpy(cloud[i])[None].to(cuda) for k, i in (
        ("xyz", 0), ("scaling", 1), ("rotation", 2), ("opacity", 3))}
    g["features_dc"] = torch.from_numpy(cloud[4])[None].to(cuda)
    g["features_rest"] = g["features_dc"][:, :, :0]
    cams = [torch_cases.frame_camera(0.7 * v, 448, 448, f)
            for v, f in enumerate(fovs)]
    return (g, np.stack([c.world_view for c in cams]),
            np.stack([c.full_proj for c in cams]),
            np.stack([c.cam_center for c in cams]),
            [(c.tan_fovx, c.tan_fovy) for c in cams])


@torch.no_grad()
@pytest.mark.parametrize("fovs,captures", [
    ([55.0] * 6, 1), ([55.0, 60.0, 55.0, 60.0, 64.0, 50.0], 0)])
def test_graph_stage_at_per_view_tangents(cuda, monkeypatch, fovs, captures):
    """Six views given per-view tangents: when they share them the stage
    renders as a graph stage (one capture, five replays), when they do
    not it renders eagerly, and either way every view equals the eager
    stage's bit for bit."""
    g, wv, fp, cc, tans = _stage_case(cuda, fovs)
    cfg = TCfg.PipelineConfig(resolution=448, fov_deg=60.0, max_sh_degree=0)
    run = Tcycle.stage_caps(g, wv, fp, cfg, tans)
    bg = torch.zeros(3, device=cuda)
    with profiling.record():
        graphs = TR.render_views_batched(g, wv, fp, cc, bg, run,
                                         tangents=tans)
        torch.cuda.synchronize()
        counters = profiling.snapshot()["counters"]
    assert counters.get("graph.captures", 0) == captures
    assert counters.get("graph.replays", 0) == 5 * captures
    monkeypatch.setattr(TR, "_graph_route", lambda *a: False)
    eager = TR.render_views_batched(g, wv, fp, cc, bg, run, tangents=tans)
    assert not bool(graphs["overflow"].any())
    assert float(graphs["rendered_alpha"].amax()) > 0.5
    for k in eager:
        assert torch.equal(graphs[k], eager[k]), k


@torch.no_grad()
def test_footprint_kernel_at_per_view_tangents(cuda):
    g, wv, fp, cc, tans = _stage_case(cuda, [40.0, 60.0, 75.0])
    cam = TR._camera(wv[0], fp[0], cc[0], TCfg.PipelineConfig(
        resolution=448, fov_deg=60.0))
    got = TB.footprint_need(g["xyz"], g["scaling"], g["rotation"], wv, fp,
                            cam, 0.0, tans)
    want = TB._footprint_need_impl(g["xyz"], g["scaling"], g["rotation"],
                                   wv, fp, cam, 0.0, tans)
    assert got == want


MID = dict(views=4, resolution=112)


@torch.no_grad()
def test_mid_size_anysplat_through_run_gslrm(cuda):
    """The published widths on 4 views at 112²: run_gslrm with no input
    cameras against the reference's forward (tokens, poses, depth, keys),
    its 8 renders at the predicted cameras of inputs k·4/8 without
    truncation."""
    with torch.device(cuda):
        ref = AR.AnySplat(AR.AnySplatConfig(**MID),
                          torch.Generator(device=cuda).manual_seed(0))
        model = A.AnySplat(A.AnySplatConfig(**MID), None)
    model.load_state_dict(ref.state_dict())
    ref.eval()
    model.eval()
    seen = {}
    model.aggregator.register_forward_hook(
        lambda m, a, o: seen.__setitem__("tokens", o[23]))
    g = torch.Generator(device=cuda).manual_seed(1)
    images = torch.rand(1, 4, 112, 112, 3, generator=g, device=cuda)
    cfg = TCfg.PipelineConfig(resolution=112, fov_deg=60.0, max_sh_degree=0)
    res = TRec.run_gslrm(model, cfg, images)
    want, aux = ref(images)
    assert _rel(seen["tokens"], aux["tokens"]) < 1e-4
    assert _rel(res.cameras["pose_enc"], want["cameras"]["pose_enc"]) < 1e-5
    share = (res.gaussians["voxels"].shape[1]
             / want["voxels"].shape[1])
    assert abs(share - 1.0) < 1e-3
    assert res.renders["render"].shape == (1, 8, 3, 112, 112)
    assert not bool(res.renders["overflow"].any())
