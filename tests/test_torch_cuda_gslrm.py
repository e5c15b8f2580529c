"""GS-LRM at its published widths on the card: models/layers.py:
multihead_attention at 16,384 tokens, 16 heads of 64, and one GSLRM
forward (4 views at 512², 24 layers, width 1024), each against the plain
reference models/gslrm_reference.py, within the limit the benchmark's
cell holds the final tokens to (`token_gap`,
benchmark/workloads/gslrm_object_512.recon_b1.json); and one small
reconstruction request's 32 orbit renders through the preprocess kernel.
Needs a CUDA device; skips elsewhere.  Imports no JAX:

    python -m pytest tests/test_torch_cuda_gslrm.py -m cuda -q --noconftest
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
from f3d_gaus_torch.models import layers as L
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _token_limit():
    path = os.path.join(ROOT, "benchmark", "workloads",
                        "gslrm_object_512.recon_b1.json")
    with open(path) as f:
        return json.load(f)["limits"]["token_gap"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@torch.no_grad()
def test_attention_at_the_published_length(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = [torch.randn(1, 16, 16384, 64, generator=g, device=cuda)
               for _ in range(3)]
    got = L.multihead_attention(q, k, v)
    want = GR.blocked_attention(q, k, v)
    assert _rel(got, want) < _token_limit()


@torch.no_grad()
def test_gslrm_forward_at_the_published_widths(cuda):
    cfg = G.GSLRMConfig()
    with torch.device(cuda):
        ref = GR.GSLRM(GR.GSLRMConfig(),
                       torch.Generator(device=cuda).manual_seed(0))
        model = G.GSLRM(cfg, None)
    model.load_state_dict(ref.state_dict())
    tokens = {}
    model.norm.register_forward_hook(
        lambda m, i, o: tokens.__setitem__("x", o))
    g = torch.Generator(device=cuda).manual_seed(1)
    images = torch.rand(1, 4, 512, 512, 3, generator=g, device=cuda)
    az = 0.3 + np.arange(4) * np.pi / 2
    wv = torch.tensor(torch_cases.turntable_views(az), dtype=torch.float32,
                      device=cuda)[None]
    tan = math.tan(0.6911 / 2)
    got = model(images, wv, tan)
    want, want_tokens = ref(images, wv, tan)
    assert _rel(tokens["x"], want_tokens) < _token_limit()
    assert got["xyz"].shape == (1, 4 * 512 * 512, 3)
    for k in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        assert _rel(got[k], want[k]) < 1e-3, k


class _Turntable:
    """A 32-frame turntable at 32² (world_view, full_proj, cam_centers)."""

    def __init__(self, frames=32, fov=0.6911):
        cams = [torch_cases.turntable_camera(a, 32, math.degrees(fov))
                for a in np.arange(frames) * 2 * np.pi / frames]
        self.world_view = np.stack([c.world_view for c in cams])
        self.full_proj = np.stack([c.full_proj for c in cams])
        self.cam_centers = np.stack([c.cam_center for c in cams])


def test_recon_request_preprocess_kernel(cuda, monkeypatch):
    """A small run_gslrm request (2 views at 32², width 64, 2 layers) on
    the card renders its 32 orbit frames through the preprocess kernel,
    one launch each, and equals, bit for bit, the same request on the
    composed preprocess."""
    small = G.GSLRMConfig(views=2, resolution=32, patch=8, width=64,
                          layers=2, heads=4, mlp=256)
    ref = GR.GSLRM(small, torch.Generator().manual_seed(0))
    model = G.GSLRM(small, None)
    model.load_state_dict(ref.state_dict())
    model = model.eval().to(cuda)
    images = torch.rand(1, 2, 32, 32, 3,
                        generator=torch.Generator().manual_seed(1))
    wv = torch_cases.turntable_views([0.4, 0.4 + np.pi]).astype(np.float32)
    cfg = TCfg.PipelineConfig(resolution=32, fov_deg=math.degrees(0.6911),
                              max_sh_degree=0)
    orbit = _Turntable()

    def request():
        with profiling.record():
            res = TRec.run_gslrm(model, cfg, images.to(cuda), wv[None], orbit,
                                 device=cuda)
            torch.cuda.synchronize()
            return res, profiling.snapshot()["counters"]
    res, counters = request()
    assert res.attempts == 1 and counters["launches.preprocess"] == 32
    assert counters["graph.captures"] == 1 and counters["graph.replays"] == 31
    monkeypatch.setattr(TR, "_kernel_preprocess", lambda *a: False)
    want, counters = request()
    assert "launches.preprocess" not in counters
    for k in want.renders:
        assert torch.equal(res.renders[k], want.renders[k]), k
