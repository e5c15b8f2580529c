"""Long-LRM on the port (models/longlrm.py, served by
pipeline/reconstruct.py:run_gslrm) against the plain reference
models/longlrm_reference.py and against plain formulas, at a small
non-square size on the CPU: 2 views of 32 × 22 padded to 24 rows, patch 4,
width 64, layout M×3, merge, T, M×3, T, d_state 16, head dim 16, chunk 8."""
import math

import numpy as np
import torch

from f3d_gaus_torch.core import cameras as TC
from f3d_gaus_torch.models import longlrm as LL
from f3d_gaus_torch.models import longlrm_reference as LR
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

torch.set_num_threads(1)

TINY = dict(views=2, frame_width=32, frame_height=22, patch=4, width=64,
            layout="MMM+TMMMT", heads=4, mlp=256, d_state=16, head_dim=16,
            chunk=8)
TAN_X = math.tan(math.pi / 6)
TAN_Y = TAN_X * 22 / 32


def _models(seed=0):
    ref = LR.LongLRM(LR.LongLRMConfig(**TINY),
                     torch.Generator().manual_seed(seed))
    model = LL.LongLRM(LL.LongLRMConfig(**TINY), None)
    model.load_state_dict(ref.state_dict())
    return model.eval(), ref.eval()


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    images = torch.rand(1, 2, 22, 32, 3, generator=g)
    wv = torch_cases.turntable_views([0.3, 0.3 + np.pi], 25.0, 3.0)
    return images, torch.from_numpy(wv.astype(np.float32))[None]


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_published_shape():
    cfg = LL.LongLRMConfig()
    assert (cfg.padded_height, cfg.tokens, cfg.gaussians, cfg.kept) == (
        544, 261_120, 16_588_800, 4_147_200)
    assert cfg.layout.count("M") == 21 and cfg.layout.count("T") == 3
    assert cfg.layout.index("+") == 7
    with torch.device("meta"):
        model = LL.LongLRM(cfg)
    assert sum(p.numel() for p in model.parameters()) == 184_376_544
    assert LL.LongLRMConfig()._asdict() == LR.LongLRMConfig()._asdict()


def test_state_dict_names_the_papers_parts():
    model, ref = _models()
    keys = set(model.state_dict())
    assert keys == set(ref.state_dict())
    for part in ("norm", "mixer.in_proj", "mixer.conv1d", "mixer.norm",
                 "mixer.out_proj"):
        assert f"blocks.0.{part}.weight" in keys
    assert {"blocks.0.mixer.dt_bias", "blocks.0.mixer.A_log",
            "blocks.0.mixer.D", "blocks.3.attn.qkv.weight",
            "blocks.7.mlp.fc2.bias", "merge.norm.weight",
            "merge.reduction.weight", "tokenizer.weight", "norm.weight",
            "head.bias"} <= keys
    assert "merge.reduction.bias" not in keys
    assert not any(k.startswith("blocks.8") for k in keys)
    assert model.state_dict()["head.weight"].shape == (8 * 8 * 12, 64)


def test_longlrm_matches_the_reference():
    """The tokens entering the merge and the final LayerNorm's within 1e-5
    of their max, the same kept set, and every kept Gaussian's fields."""
    model, ref = _models()
    images, wv = _inputs()
    seen = {}
    model.merge.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("premerge", args[0]))
    model.norm.register_forward_hook(
        lambda m, i, o: seen.__setitem__("tokens", o))
    with torch.no_grad():
        got = model(images, wv, TAN_X, TAN_Y)
        want, aux = ref(images, wv, TAN_X, TAN_Y)
    assert seen["premerge"].shape == (1, 2 * 6 * 8, 64)
    assert seen["tokens"].shape == (1, 2 * 3 * 4, 64)
    assert _rel(seen["premerge"], aux["premerge"]) < 1e-5
    assert _rel(seen["tokens"], aux["tokens"]) < 1e-5
    assert torch.equal(got["kept"], want["kept"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.numel() and k != "kept":
            assert _rel(got[k], v) < 1e-5, k
    assert got["xyz"].shape == (1, 352, 3)
    assert aux["fields"]["xyz"].shape == (1, 2 * 22 * 32, 3)


def test_gaussians_sit_on_their_pixel_rays():
    """The kept Gaussians are the most opaque quarter of the frame's
    pixels (the padded rows dropped), each on its own pixel's ray with t
    in (near, far)."""
    model, ref = _models()
    images, wv = _inputs()
    with torch.no_grad():
        g = model(images, wv, TAN_X, TAN_Y)
        _, aux = ref(images, wv, TAN_X, TAN_Y)
    kept = g["kept"][0]
    n = 2 * 22 * 32
    assert kept.dtype == torch.int64 and kept.shape == (n // 4,)
    assert bool((kept[1:] > kept[:-1]).all()) and int(kept.max()) < n
    opa = aux["fields"]["opacity"][0, :, 0]
    rest = torch.ones(n, dtype=torch.bool)
    rest[kept] = False
    assert float(opa[kept].min()) >= float(opa[rest].max())
    o, d, _ = TC.plucker_rays(wv, TAN_X, TAN_Y, 22, 32)
    view = kept // (22 * 32)
    rel = g["xyz"][0] - o[0, view]
    t = rel.norm(dim=-1)
    cfg = model.cfg
    assert bool((t > cfg.near).all() and (t < cfg.far).all())
    np.testing.assert_allclose((rel / t[:, None]).numpy(),
                               d[0].reshape(n, 3)[kept].numpy(), atol=1e-5)


def test_padded_rows_feed_tokens_but_give_no_gaussians(monkeypatch):
    """The padding rows' rays continue the frame's pixel spacing, their
    RGB is -1, and every Gaussian comes from a frame row."""
    images, wv = _inputs()
    o, d, pl = TC.plucker_rays(wv, TAN_X, TAN_Y, 22, 32, rows=24)
    o2, _, pl2 = TC.plucker_rays(wv, TAN_X, TAN_Y, 22, 32)
    assert pl.shape == (1, 2, 24, 32, 6)
    assert torch.equal(pl[:, :, :22], pl2) and torch.equal(o, o2)
    ys = ((2 * np.arange(24) + 1) / 22 - 1) * TAN_Y
    c2w = np.linalg.inv(wv[0, 0].double().numpy().T)
    want = np.stack([np.full(32, 0.0), np.full(32, ys[23]), np.ones(32)], -1)
    want[:, 0] = ((2 * np.arange(32) + 1) / 32 - 1) * TAN_X
    want = want @ c2w[:3, :3].T
    want /= np.linalg.norm(want, axis=-1, keepdims=True)
    np.testing.assert_allclose(d[0, 0, 23].numpy(), want, atol=2e-6)
    model, _ = _models()
    seen = {}
    orig = LL.gslrm.patchify

    def spy(x, p):
        seen["x"] = x
        return orig(x, p)
    monkeypatch.setattr(LL.gslrm, "patchify", spy)
    with torch.no_grad():
        g = model(images, wv, TAN_X, TAN_Y)
    assert seen["x"].shape == (1, 2, 24, 32, 9)
    assert bool((seen["x"][:, :, 22:, :, :3] == -1).all())
    assert g["opacity"].shape == (1, 2 * 22 * 32 // 4, 1)


def test_prune_keeps_the_most_opaque_ties_to_the_lower_index():
    opa = torch.tensor([[0.5, 0.9, 0.5, 0.1, 0.5, 0.9, 0.5, 0.2]])
    assert LL.prune(opa, 4).tolist() == [[0, 1, 2, 5]]
    assert LR.prune(opa, 4).tolist() == [[0, 1, 2, 5]]
    assert LL.prune(opa, 3).tolist() == [[0, 1, 5]]
    flat = torch.full((2, 9), 0.3)
    assert LL.prune(flat, 3).tolist() == [[0, 1, 2]] * 2


def test_spans_and_counters_of_a_forward():
    model, _ = _models()
    images, wv = _inputs()
    with torch.no_grad(), profiling.record():
        model(images, wv, TAN_X, TAN_Y)
        snap = profiling.snapshot()
    assert snap["counters"] == {
        "ssd.calls": 6, "ssd.tokens": 3 * 96 + 3 * 24,
        "attention.calls": 2, "attention.tokens": 2 * 24,
        "longlrm.gaussians": 1408, "prune.kept": 352}
    calls = {k: v["calls"] for k, v in snap["spans"].items()}
    assert calls == {"longlrm": 1, "tokens": 1, "blocks": 1, "mamba2": 6,
                     "ssd": 6, "attention": 2, "merge": 1, "head": 1,
                     "prune": 1}


class _Orbit:
    """Orbit cameras at a non-square frame (world_view, full_proj,
    cam_centers)."""

    def __init__(self, azimuths, width, height):
        cams = [torch_cases.frame_camera(a, width, height) for a in azimuths]
        self.world_view = np.stack([c.world_view for c in cams])
        self.full_proj = np.stack([c.full_proj for c in cams])
        self.cam_centers = np.stack([c.cam_center for c in cams])


def test_run_gslrm_serves_longlrm_at_a_non_square_frame():
    """A request plans its orbit stage at 32 × 22, renders every view
    within the plan, and counts the model's spans under `recon`."""
    model, _ = _models()
    images, wv = _inputs()
    cfg = TCfg.PipelineConfig(resolution=32, height=22, fov_deg=60.0,
                              max_sh_degree=0, pair_cap=1 << 12,
                              max_per_tile=256, chunk=32)
    orbit = _Orbit([0.3 + np.pi / 8, 0.3 + 5 * np.pi / 8], 32, 22)
    with profiling.record():
        res = TRec.run_gslrm(model, cfg, images, wv[0].numpy()[None], orbit,
                             device="cpu")
        snap = profiling.snapshot()
    assert res.attempts == 1 and not bool(res.renders["overflow"].any())
    assert res.renders["render"].shape == (1, 2, 3, 22, 32)
    assert res.gaussians["kept"].shape == (1, 352)
    assert snap["counters"]["caps.plans"] == 1
    assert snap["counters"]["prune.kept"] == 352
    spans = snap["spans"]
    assert spans["recon"]["calls"] == spans["longlrm"]["calls"] == 1
    assert spans["predict"]["calls"] == spans["orbit"]["calls"] == 1
    assert float(res.renders["rendered_alpha"].max()) > 0.05
