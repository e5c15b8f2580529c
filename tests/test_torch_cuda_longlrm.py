"""Long-LRM and the non-square serving path on the card: a render stage at
960 × 540 through CUDA graphs against its eager stage, bit for bit; the
scan (models/ssm.py:ssd) at the published length, 261,120 tokens of 32
heads, and a mid-size LongLRM, each against the plain reference
models/longlrm_reference.py within the limits the benchmark's cell holds
the program to (benchmark/workloads/longlrm_scene_540.scene_b1.json);
run_gslrm planning its stage for both models.  Needs a CUDA device; skips
elsewhere.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_longlrm.py -m cuda -q --noconftest
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from f3d_gaus_torch.core.device import resolve_device
from f3d_gaus_torch.models import gslrm as G
from f3d_gaus_torch.models import gslrm_reference as GR
from f3d_gaus_torch.models import longlrm as LL
from f3d_gaus_torch.models import longlrm_reference as LR
from f3d_gaus_torch.models import ssm
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.pipeline import renderer as TR
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _limits():
    path = os.path.join(ROOT, "benchmark", "workloads",
                        "longlrm_scene_540.scene_b1.json")
    with open(path) as f:
        return json.load(f)["limits"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


class _Cams:
    """Cameras at a frame of width × height (world_view, full_proj,
    cam_centers)."""

    def __init__(self, azimuths, width, height, **kw):
        cams = [torch_cases.frame_camera(a, width, height, **kw)
                for a in azimuths]
        self.world_view = np.stack([c.world_view for c in cams])
        self.full_proj = np.stack([c.full_proj for c in cams])
        self.cam_centers = np.stack([c.cam_center for c in cams])


@torch.no_grad()
def test_graph_stage_at_960_by_540_equals_the_eager_stage(cuda,
                                                           monkeypatch):
    rng = np.random.default_rng(0)
    cloud = torch_cases.make_gaussian_cloud(rng, 400_000, center=(0, 0, 0),
                                            spread=0.6, sh_degree=0,
                                            scale_range=(0.002, 0.02))
    g = {k: torch.from_numpy(cloud[i])[None].to(cuda) for k, i in (
        ("xyz", 0), ("scaling", 1), ("rotation", 2), ("opacity", 3))}
    g["features_dc"] = torch.from_numpy(cloud[4])[None].to(cuda)
    g["features_rest"] = g["features_dc"][:, :, :0]
    cfg = TCfg.PipelineConfig(resolution=960, height=540, fov_deg=60.0,
                              max_sh_degree=0)
    cams = _Cams(np.arange(5) * 1.3, 960, 540)
    run = Tcycle.stage_caps(g, cams.world_view, cams.full_proj, cfg)
    bg = torch.zeros(3, device=cuda)
    with profiling.record():
        graphs = TR.render_views_batched(g, cams.world_view, cams.full_proj,
                                         cams.cam_centers, bg, run)
        torch.cuda.synchronize()
        counters = profiling.snapshot()["counters"]
    assert counters["graph.captures"] == 1 and counters["graph.replays"] == 4
    monkeypatch.setattr(TR, "_graph_route", lambda *a: False)
    eager = TR.render_views_batched(g, cams.world_view, cams.full_proj,
                                    cams.cam_centers, bg, run)
    assert graphs["render"].shape == (1, 5, 3, 540, 960)
    assert not bool(graphs["overflow"].any())
    assert float(graphs["rendered_alpha"].amax()) > 0.5
    for k in eager:
        assert torch.equal(graphs[k], eager[k]), k


@torch.no_grad()
def test_ssd_at_the_published_length(cuda):
    """One scan over 261,120 tokens, 32 heads of 64, state 128, chunk 256,
    at decays from the published initialisation's range."""
    g = torch.Generator(device=cuda).manual_seed(0)
    L, h, p, n = 261_120, 32, 64, 128
    x = torch.randn(1, L, h, p, generator=g, device=cuda)
    dt = 1e-3 + 0.1 * torch.rand(1, L, h, generator=g, device=cuda)
    A = -(1.0 + 15.0 * torch.rand(h, generator=g, device=cuda))
    B = torch.randn(1, L, 1, n, generator=g, device=cuda)
    C = torch.randn(1, L, 1, n, generator=g, device=cuda)
    D = torch.ones(h, device=cuda)
    got = ssm.ssd(x, dt, A, B, C, 256, D=D)
    want = LR.ssd_scan(x, dt, A, B, C, D, 256)
    assert _rel(got, want) < _limits()["premerge_gap"]


MID = dict(views=4, frame_width=240, frame_height=136, patch=8, width=256,
           layout="MMM+TMMMT", heads=4, mlp=1024, d_state=64, head_dim=32,
           chunk=64)


@torch.no_grad()
def test_mid_size_longlrm_matches_the_reference(cuda):
    with torch.device(cuda):
        ref = LR.LongLRM(LR.LongLRMConfig(**MID),
                         torch.Generator(device=cuda).manual_seed(0))
        model = LL.LongLRM(LL.LongLRMConfig(**MID), None)
    model.load_state_dict(ref.state_dict())
    seen = {}
    model.merge.register_forward_pre_hook(
        lambda m, a: seen.__setitem__("premerge", a[0]))
    model.norm.register_forward_hook(
        lambda m, i, o: seen.__setitem__("tokens", o))
    g = torch.Generator(device=cuda).manual_seed(1)
    images = torch.rand(1, 4, 136, 240, 3, generator=g, device=cuda)
    wv = torch.tensor(torch_cases.turntable_views(
        0.2 + np.arange(4) * np.pi / 2, 25.0, 3.0), dtype=torch.float32,
        device=cuda)[None]
    tx = math.tan(math.pi / 6)
    ty = tx * 136 / 240
    got = model(images, wv, tx, ty)
    want, aux = ref(images, wv, tx, ty)
    lim = _limits()
    assert _rel(seen["premerge"], aux["premerge"]) < lim["premerge_gap"]
    assert _rel(seen["tokens"], aux["tokens"]) < lim["token_gap"]
    kept = got["kept"][0]
    assert kept.shape == (4 * 136 * 240 // 4,)
    inside = torch.zeros(4 * 136 * 240, dtype=torch.bool, device=cuda)
    inside[want["kept"][0]] = True
    assert 1.0 - float(inside[kept].double().mean()) < lim["kept_share"]
    for k in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        assert _rel(got[k], aux["fields"][k][:, kept]) < 1e-3, k


def test_run_gslrm_plans_its_stage_for_both_models(cuda):
    """A small request of each model through run_gslrm on the card plans
    its target stage once, renders it as one CUDA graph within the plan,
    and equals the same request rendered eagerly."""
    small = G.GSLRMConfig(views=2, resolution=32, patch=8, width=64,
                          layers=2, heads=4, mlp=256)
    gslrm = G.GSLRM(small, None)
    gslrm.load_state_dict(GR.GSLRM(small, torch.Generator().manual_seed(0))
                          .state_dict())
    tiny = dict(views=2, frame_width=32, frame_height=22, patch=4, width=64,
                layout="MMM+TMMMT", heads=4, mlp=256, d_state=16,
                head_dim=16, chunk=8)
    longlrm = LL.LongLRM(LL.LongLRMConfig(**tiny), None)
    longlrm.load_state_dict(LR.LongLRM(
        LR.LongLRMConfig(**tiny), torch.Generator().manual_seed(0))
        .state_dict())
    cases = [
        (gslrm, TCfg.PipelineConfig(resolution=32, fov_deg=60.0,
                                    max_sh_degree=0), (32, 32), 4.03, 20.0),
        (longlrm, TCfg.PipelineConfig(resolution=32, height=22, fov_deg=60.0,
                                      max_sh_degree=0), (32, 22), 3.0, 25.0)]
    for model, cfg, (w, h), radius, el in cases:
        model = model.eval().to(cuda)
        images = torch.rand(1, 2, h, w, 3,
                            generator=torch.Generator().manual_seed(1))
        wv = torch_cases.turntable_views([0.4, 0.4 + np.pi], el, radius)
        orbit = _Cams(np.arange(6) * 1.05, w, h, radius=radius,
                      elevation=el)

        def request():
            with profiling.record():
                res = TRec.run_gslrm(model, cfg, images.to(cuda),
                                     wv.astype(np.float32)[None], orbit,
                                     device=cuda)
                torch.cuda.synchronize()
                return res, profiling.snapshot()["counters"]
        res, counters = request()
        assert res.attempts == 1 and counters["caps.plans"] == 1
        assert counters["graph.captures"] == 1
        assert counters["graph.replays"] == 5
        assert res.renders["render"].shape == (1, 6, 3, h, w)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TR, "_graph_route", lambda *a: False)
            want, _ = request()
        for k in want.renders:
            assert torch.equal(res.renders[k], want.renders[k]), k
