"""GS-LRM on the port (models/gslrm.py, models/layers.py:
multihead_attention, core/cameras.py:plucker_rays,
pipeline/reconstruct.py:run_gslrm) against the plain reference
models/gslrm_reference.py and against plain formulas, at a small size on
the CPU: 2 views at 32², patch 8, width 64, 2 layers, 4 heads."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from f3d_gaus_torch.core import cameras as TC
from f3d_gaus_torch.models import gslrm as G
from f3d_gaus_torch.models import gslrm_reference as GR
from f3d_gaus_torch.models import layers as L
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

torch.set_num_threads(1)

SMALL = dict(views=2, resolution=32, patch=8, width=64, layers=2, heads=4,
             mlp=256)
ANGLE_X = 0.6911           # NeRF-synthetic's camera_angle_x
TAN = math.tan(ANGLE_X / 2)


def _models(seed=0):
    ref = GR.GSLRM(GR.GSLRMConfig(**SMALL),
                   torch.Generator().manual_seed(seed))
    model = G.GSLRM(G.GSLRMConfig(**SMALL), None)
    model.load_state_dict(ref.state_dict())
    return model.eval(), ref.eval()


def _inputs(seed=1, views=2, r=32):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(1, views, r, r, 3, generator=g)
    az = 0.4 + np.arange(views) * 2 * np.pi / views
    wv = torch_cases.turntable_views(az).astype(np.float32)
    return images, torch.from_numpy(wv)[None]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_state_dict_names_the_papers_parts():
    model, ref = _models()
    keys = set(model.state_dict())
    assert keys == set(ref.state_dict())
    for part in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
                 "mlp.fc2"):
        assert f"blocks.1.{part}.weight" in keys
    assert {"tokenizer.weight", "norm.weight", "head.bias"} <= keys
    n = sum(v.numel() for v in model.state_dict().values())
    # 12 w² + 13 w a block, tokenizer 576 w + w, head 768 w + 768, norm 2 w
    w, m = 64, 256
    block = 4 * w * w + 2 * w * m + 3 * w + w + m + w + 4 * w
    assert n == 2 * block + 576 * w + w + w * 768 + 768 + 2 * w


def test_gslrm_matches_the_reference():
    """Tokens (the final LayerNorm's) and every Gaussian field within
    1e-5 of the field's max."""
    model, ref = _models()
    images, wv = _inputs()
    tokens = {}
    model.norm.register_forward_hook(
        lambda m, i, o: tokens.__setitem__("x", o))
    with torch.no_grad():
        got = model(images, wv, TAN)
        want, want_tokens = ref(images, wv, TAN)
    assert _rel(tokens["x"], want_tokens) < 1e-5
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape == (1, 2 * 32 * 32) + v.shape[2:], k
        if v.numel():
            assert _rel(got[k], v) < 1e-5, k
    assert got["features_rest"].shape == (1, 2048, 0, 3)


def test_gaussians_sit_on_their_pixel_rays():
    """xyz = o + t·d with t in (near, far); at initialisation the
    distance is about the middle, the scale about 0.01 and the opacity
    about sigmoid(-3)."""
    model, _ = _models()
    images, wv = _inputs()
    with torch.no_grad():
        g = model(images, wv, TAN)
    o, d, _ = TC.plucker_rays(wv, TAN, TAN, 32, 32)
    rel = g["xyz"].reshape(1, 2, 32, 32, 3) - o[:, :, None, None, :]
    t = rel.norm(dim=-1)
    cfg = model.cfg
    assert bool((t > cfg.near).all() and (t < cfg.far).all())
    np.testing.assert_allclose((rel / t[..., None]).numpy(), d.numpy(),
                               atol=1e-5)
    assert abs(float(t.mean()) - (cfg.near + cfg.far) / 2) < 0.05
    assert abs(float(g["scaling"].mean()) - 0.01) < 1e-3
    assert abs(float(g["opacity"].mean()) - 1 / (1 + math.e ** 3)) < 5e-3


@pytest.mark.parametrize("length,block_bytes", [
    (64, L.ATTN_BLOCK_BYTES),       # every head at once
    (512, 512 * 4 * 128),           # 128 rows of one head a block
    (512, 512 * 512 * 4 * 3),       # three heads a block, a partial last
    (200, 200 * 4 * 7),             # 7 rows a block, a partial last
])
def test_multihead_attention_matches_plain_softmax(length, block_bytes):
    g = torch.Generator().manual_seed(length)
    q, k, v = [torch.randn(2, 4, length, 16, generator=g) for _ in range(3)]
    want = torch.softmax(q @ k.transpose(-1, -2) / 4.0, -1) @ v
    with profiling.record():
        got = L.multihead_attention(q, k, v, block_bytes=block_bytes)
        c = profiling.snapshot()
    assert float((got - want).abs().max()) < 1e-6
    assert c["counters"] == {"attention.calls": 1, "attention.tokens": length}
    assert c["spans"]["attention"]["calls"] == 1


def test_plucker_rays_match_f64():
    wv = torch_cases.turntable_views([0.3, 2.0, -1.1], radius=3.9)
    o, d, pl = TC.plucker_rays(torch.from_numpy(wv.astype(np.float32)),
                               0.4, 0.3, 6, 8)
    assert o.shape == (3, 3) and d.shape == (3, 6, 8, 3)
    assert pl.shape == (3, 6, 8, 6)
    for c in range(3):
        c2w = np.linalg.inv(wv[c].T)               # column-vector c2w
        centre = c2w[:3, 3]
        ys = ((2 * np.arange(6) + 1) / 6 - 1) * 0.3
        xs = ((2 * np.arange(8) + 1) / 8 - 1) * 0.4
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        dirs = np.stack([gx, gy, np.ones_like(gx)], -1) @ c2w[:3, :3].T
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        np.testing.assert_allclose(o[c].numpy(), centre, atol=2e-6)
        np.testing.assert_allclose(d[c].numpy(), dirs, atol=2e-6)
        np.testing.assert_allclose(pl[c, ..., :3].numpy(),
                                   np.cross(centre, dirs), atol=1e-5)
        np.testing.assert_allclose(pl[c, ..., 3:].numpy(), dirs, atol=2e-6)


class _Orbit:
    """An orbit camera set at 32² (world_view, full_proj, cam_centers)."""

    def __init__(self, frames):
        wv = torch_cases.turntable_views(
            np.arange(frames) * 2 * np.pi / frames)
        proj = TC.projection_matrix(0.01, 100.0, ANGLE_X, ANGLE_X)
        self.world_view = wv.astype(np.float32)
        self.full_proj = (wv @ proj.T).astype(np.float32)
        self.cam_centers = np.linalg.inv(wv)[:, 3, :3].astype(np.float32)


def _render_cfg(**caps):
    return TCfg.PipelineConfig(resolution=32,
                               fov_deg=math.degrees(ANGLE_X),
                               max_sh_degree=0, **caps)


def test_run_gslrm_plans_the_orbit():
    """One attempt at planned caps; the renders equal, bit for bit, those
    at static caps ample for every render; stages and spans recorded."""
    model, _ = _models()
    images, wv = _inputs()
    orbit = _Orbit(3)
    timings = {}
    with profiling.record():
        res = TRec.run_gslrm(model, _render_cfg(pair_cap=1 << 8,
                                                max_per_tile=32),
                             images, wv.numpy(), orbit, timings=timings,
                             device="cpu")
        snap = profiling.snapshot()
    assert res.attempts == 1
    assert set(timings) == {"predict", "orbit"}
    spans = snap["spans"]
    for name in ("recon", "predict", "gslrm", "tokens", "blocks", "head",
                 "orbit", "plan_caps"):
        assert spans[name]["calls"] == 1, name
    assert spans["attention"]["calls"] == 2
    assert snap["counters"]["gslrm.gaussians"] == 2048
    assert snap["counters"]["attention.tokens"] == 2 * 32
    assert "caps.fallbacks" not in snap["counters"]
    assert res.cfg.max_per_tile % 256 == 0
    assert res.renders["render"].shape == (1, 3, 3, 32, 32)
    assert not res.renders["overflow"].any()
    big = _render_cfg(pair_cap=1 << 16, max_per_tile=2048)
    with torch.no_grad():
        want = TRec.renderer.render_views_batched(
            res.gaussians, orbit.world_view, orbit.full_proj,
            orbit.cam_centers, torch.zeros(3), big)
    assert not want["overflow"].any()
    for k in want:
        assert torch.equal(res.renders[k], want[k]), k


def test_run_gslrm_guard_doubles_caps(monkeypatch):
    """With the planner patched to return the caller's tiny caps the orbit
    overflows; the caps double from the caller's until it fits, each
    doubling a fallback, and the Gaussians are predicted once."""
    monkeypatch.setattr(Tcycle, "stage_caps",
                        lambda g, wv, fp, c, tangents=None: c)
    model, _ = _models()
    images, wv = _inputs()
    msgs = []
    with profiling.record():
        res = TRec.run_gslrm(model, _render_cfg(pair_cap=1 << 8,
                                                max_per_tile=8),
                             images, wv.numpy(), _Orbit(2), device="cpu",
                             log=msgs.append)
        snap = profiling.snapshot()
    assert res.attempts == len(msgs) + 1 > 1
    assert res.cfg.max_per_tile == 8 << len(msgs)
    assert snap["counters"]["caps.fallbacks"] == len(msgs)
    assert snap["spans"]["gslrm"]["calls"] == 1
    assert not res.renders["overflow"].any()
    assert dataclasses.replace(res.cfg, pair_cap=1 << 8, max_per_tile=8) == \
        _render_cfg(pair_cap=1 << 8, max_per_tile=8)
