"""f3d_gaus_torch.pipeline against f3d_gaus_tpu.pipeline: run_nvs end to end
at 32^2 (base_dim 32, one aggregation and one NVS view) on the same
weights, the renderer's depth-normal, and a CPU smoke of the port's CLI."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.models import convert as JConv
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_tpu.pipeline import config as JC
from f3d_gaus_tpu.pipeline import cycle as Jcycle
from f3d_gaus_tpu.pipeline import renderer as Jrenderer
from f3d_gaus_torch.models import predictor as TP
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as Tcycle
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.pipeline import renderer as Trenderer
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

SMALL = dict(resolution=32, base_dim=32, num_blocks=1, attn_resolutions=(8,),
             num_aggregation_views=1, num_nvs_views=1,
             pair_cap=1 << 14, max_per_tile=2048, chunk=128)


def _inputs(seed=0, r=32):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(1, r, r, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(1, r, r)).astype(np.float32)
    return images, depth


def _close_fraction(ref, got):
    """Fraction of points whose largest error is within 1e-4 x max(1, max
    |ref|); ref/got are (B, P, ...)."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).reshape(ref.shape[0] * ref.shape[1], -1).max(-1)
    return float((err <= 1e-4 * max(1.0, float(np.abs(ref).max()))).mean())


def test_run_nvs_matches_jax():
    """Stage by stage: the first forward on every point; the cycle's
    re-prediction against the JAX predictor fed the port's aggregation
    renders (>= 99.9 % of points); every render against JAX run_nvs under
    bench.py's anchor.  The merged set is not compared to JAX run_nvs point
    by point: the aggregation renders differ by f32 compositing noise (at
    most 4.8e-5 here, no depth flips), and the random-init predictor
    amplifies that in the reference itself: JAX's predictor fed JAX's and
    the port's renders gives rotations up to 2.1e-3 apart (66 % of the
    cycle points beyond 1e-4)."""
    jcfg, tcfg = JC.PipelineConfig(**SMALL), TCfg.PipelineConfig(**SMALL)
    pcfg = jcfg.predictor_config()
    # seeded torch weights, carried into JAX by the JAX package's own
    # converter for the reference .pt: the port's state_dict keys are the
    # reference's torch names
    model = TP.GaussianPredictor(tcfg.predictor_config(),
                                 torch.Generator().manual_seed(0))
    sd = {"gaussian_predictor.network_with_offset." + k: v
          for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(
        jnp.asarray, JConv.convert_predictor(sd, JP.make_plan(pcfg)))
    cams = TD.canonical_cameras(tcfg)
    images, depth = _inputs()

    mj, rj, aj, gj = Jcycle.run_nvs(params, jcfg, cams, images, depth,
                                    return_first=True)
    mt, rt, at, gt = Tcycle.run_nvs(model, tcfg, cams, images, depth,
                                    return_first=True, device="cpu")
    assert not bool(np.any(np.asarray(rj["overflow"])))
    assert not bool(rt["overflow"].any()) and not bool(at["overflow"].any())
    P = 32 * 32
    for k in gj:
        assert np.isfinite(mt[k].numpy()).all(), k
        assert _close_fraction(gj[k], gt[k].numpy()) == 1.0, k
        np.testing.assert_array_equal(mt[k][:, :P].numpy(), gt[k].numpy())

    # the cycle feed of cycle.cycle_aggregate, built from the port's renders
    agg = Tcycle.aggregation_cameras(tcfg, cams.inverse_first_camera)
    feat = np.concatenate([np.clip(at["render"].numpy(), 0, 1),
                           at["rendered_alpha"].numpy()], 2)
    feat = feat.transpose(0, 1, 3, 4, 2)                 # (1, V, H, W, 4)
    ref = JP.apply(params, pcfg, jnp.asarray(feat), agg.view_to_world[None],
                   agg.cv2wT_quat[None], at["rendered_depth"][:, :, 0].numpy())
    for k in ref:
        assert _close_fraction(ref[k], mt[k][:, P:].numpy()) >= 0.999, k

    for views_j, views_t in ((aj, at), (rj, rt)):
        assert views_t["render"].shape == tuple(views_j["render"].shape)
        chans = ("render", "rendered_normal", "rendered_depth",
                 "rendered_alpha", "distortion_map")
        out9_j = np.concatenate([np.asarray(views_j[c])[0, 0] for c in chans])
        out9_t = np.concatenate([views_t[c][0, 0].numpy() for c in chans])
        err, frac = torch_cases.bench_parity(out9_j, out9_t)
        assert err < 2e-2 and frac < 1e-3, (err, frac)


def test_depth_to_normal_matches_jax():
    cam = torch_cases.orbit_camera(24, 16)
    depth = np.random.default_rng(1).uniform(7, 8, (1, 16, 24)).astype(np.float32)
    a = Jrenderer.depth_to_normal(jnp.asarray(cam.world_view), jnp.asarray(depth),
                                  24, 16, cam.tan_fovx, cam.tan_fovy)
    b = Trenderer.depth_to_normal(cam.world_view, torch.from_numpy(depth),
                                  24, 16, cam.tan_fovx, cam.tan_fovy)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_run_nvs_replanned_doubles_caps(monkeypatch):
    """The guard: with the planner patched to return the caller's tiny
    caps, the planned run overflows and the caps double from the caller's
    until the renders fit, each doubling counted as a fallback."""
    cfg = TCfg.PipelineConfig(**dict(SMALL, pair_cap=1 << 8, max_per_tile=32))
    monkeypatch.setattr(Tcycle, "stage_caps", lambda g, wv, fp, c: c)
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0))
    images, depth = _inputs(1)
    msgs, timings = [], {}
    with profiling.record():
        res = Tcycle.run_nvs_replanned(model, cfg, TD.canonical_cameras(cfg),
                                       images, depth, device="cpu",
                                       log=msgs.append, timings=timings)
        counters = profiling.snapshot()["counters"]
    assert res.attempts == len(msgs) + 1 > 1
    assert res.cfg.max_per_tile == 32 << len(msgs)
    assert counters["caps.fallbacks"] == len(msgs)
    assert set(timings) == {"first_forward", "cycle_aggregate", "nvs_orbit"}
    assert all(t > 0 for t in timings.values())
    assert res.renders["render"].shape == (1, 2, 3, 32, 32)
    assert res.merged["xyz"].shape == (1, 2 * 32 * 32, 3)


def test_run_nvs_replanned_plans_tiny_caps():
    """At the doubling test's tiny caps the planned run fits at once: one
    attempt, no render truncated, no fallback, two stages planned, and
    the renders and merged Gaussians equal, bit for bit, run_nvs's at
    static caps ample for every render (nothing truncated, so the caps do
    not show); the returned config carries the orbit stage's plan."""
    cfg = TCfg.PipelineConfig(**dict(SMALL, pair_cap=1 << 8, max_per_tile=32))
    big = TCfg.PipelineConfig(**SMALL)
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0))
    cams = TD.canonical_cameras(cfg)
    images, depth = _inputs(1)
    msgs, timings = [], {}
    with profiling.record():
        res = Tcycle.run_nvs_replanned(model, cfg, cams, images, depth,
                                       device="cpu", log=msgs.append,
                                       timings=timings)
        counters = profiling.snapshot()["counters"]
    assert res.attempts == 1 and msgs == []
    assert counters["caps.plans"] == 2 and "caps.fallbacks" not in counters
    assert set(timings) == {"first_forward", "cycle_aggregate", "nvs_orbit"}
    assert not res.renders["overflow"].any()
    assert not res.agg_views["overflow"].any()
    mt, rt, at, gt = Tcycle.run_nvs(model, big, cams, images, depth,
                                    return_first=True, device="cpu")
    for got, want in ((res.merged, mt), (res.renders, rt),
                      (res.agg_views, at), (res.first, gt)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    nvs = Tcycle.nvs_cameras(cfg, cams.inverse_first_camera)
    assert res.cfg == Tcycle.stage_caps(mt, nvs.world_view, nvs.full_proj,
                                        cfg)
    assert res.cfg.max_per_tile % 256 == 0
    assert res.cfg.max_per_tile < big.max_per_tile


@pytest.mark.parametrize("batch", [1, 2])
def test_footprint_need_counts_exactly(monkeypatch, batch):
    """binning.footprint_need, with no binning, is the binning's own count
    at each serving stage: for the first forward's set at the aggregation
    cameras and the merged set at the NVS cameras, the most pairs
    (binning.count_pairs) and the fullest tile (bin_gaussians'
    tile_count) over every (batch element, view) of preprocess's
    footprints, with the footprints taken a few views at a time;
    cycle.stage_caps rounds them up to the buckets."""
    from f3d_gaus_torch.core import gaussians as TG
    from f3d_gaus_torch.core.cameras import Camera
    from f3d_gaus_torch.ops import binning as TB
    cfg = TCfg.PipelineConfig(**dict(SMALL, num_aggregation_views=2,
                                     num_nvs_views=4))
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0))
    cams = TD.canonical_cameras(cfg)
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(batch, 32, 32, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(batch, 32, 32)).astype(np.float32)
    merged, _, _, g0 = Tcycle.run_nvs(model, cfg, cams, images, depth,
                                      return_first=True, device="cpu")
    agg = Tcycle.aggregation_cameras(cfg, cams.inverse_first_camera)
    nvs = Tcycle.nvs_cameras(cfg, cams.inverse_first_camera)
    # two views of the merged set a footprint step, so both stages chunk
    monkeypatch.setattr(TB, "PLAN_CHUNK", 2 * merged["xyz"].shape[1])
    for g, camset in ((g0, agg), (merged, nvs)):
        pairs, tile = [], []
        for b in range(batch):
            shs = torch.cat([g["features_dc"][b], g["features_rest"][b]], 1)
            for v in range(len(camset.world_view)):
                cam = Camera(camset.world_view[v], camset.full_proj[v],
                             camset.cam_centers[v], 32, 32, cfg.tan_fov,
                             cfg.tan_fov)
                pre = TG.preprocess(g["xyz"][b], g["scaling"][b],
                                    g["rotation"][b], g["opacity"][b], shs,
                                    cfg.max_sh_degree, cam, cfg.kernel_size)
                pairs.append(int(TB.count_pairs(pre.means2d, pre.radii, 32,
                                                32)))
                bng = TB.bin_gaussians(pre.means2d, pre.radii, pre.depths,
                                       32, 32, 1 << 16)
                assert not bool(bng.overflow)
                tile.append(int(bng.tile_count.max()))
        need = TB.footprint_need(g["xyz"], g["scaling"], g["rotation"],
                                 camset.world_view, camset.full_proj, cam,
                                 cfg.kernel_size)
        assert need == {"pairs": max(pairs), "tile": max(tile)}
        planned = Tcycle.stage_caps(g, camset.world_view, camset.full_proj,
                                    cfg)
        assert planned == dataclasses.replace(
            cfg, pair_cap=TB.suggest_pair_cap(max(pairs)),
            max_per_tile=-(-max(tile) // 256) * 256)


def test_run_nvs_check_overflow():
    """At deliberately tiny caps (tests/test_pipeline.py:67-71, :106) every
    render truncates: run_nvs(check_overflow=False) returns renders of the
    shapes JAX's returns, each truncation flagged in its `overflow` map as
    in JAX's, and raises nothing; with True (the default) it raises
    RenderOverflow, as JAX's does."""
    tiny = dict(SMALL, pair_cap=1 << 8, max_per_tile=32, chunk=32)
    jcfg, tcfg = JC.PipelineConfig(**tiny), TCfg.PipelineConfig(**tiny)
    model = TP.GaussianPredictor(tcfg.predictor_config(),
                                 torch.Generator().manual_seed(0))
    sd = {"gaussian_predictor.network_with_offset." + k: v
          for k, v in model.state_dict().items()}
    params = jax.tree_util.tree_map(
        jnp.asarray, JConv.convert_predictor(sd, JP.make_plan(
            jcfg.predictor_config())))
    cams = TD.canonical_cameras(tcfg)
    images, depth = _inputs(2)
    mj, rj, aj = Jcycle.run_nvs(params, jcfg, cams, images, depth,
                                check_overflow=False)
    mt, rt, at = Tcycle.run_nvs(model, tcfg, cams, images, depth,
                                check_overflow=False, device="cpu")
    for want, got in ((mj, mt), (rj, rt), (aj, at)):
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert torch.isfinite(got[k].float()).all(), k
    n_nvs = tcfg.num_nvs_views + 1
    assert rt["render"].shape == (1, n_nvs, 3, 32, 32)
    assert mt["xyz"].shape == (1, (tcfg.num_aggregation_views + 1) * 32 * 32,
                               3)
    assert rt["overflow"].all() and at["overflow"].all()
    np.testing.assert_array_equal(rt["overflow"].numpy(), rj["overflow"])
    np.testing.assert_array_equal(at["overflow"].numpy(), aj["overflow"])
    with pytest.raises(Trenderer.RenderOverflow):
        Tcycle.run_nvs(model, tcfg, cams, images, depth, device="cpu")
    with pytest.raises(Jrenderer.RenderOverflow):
        Jcycle.run_nvs(params, jcfg, cams, images, depth)


def test_cli_smoke_cpu(tmp_path, monkeypatch):
    """The CLI on the CPU at 32^2: NVS videos, the Gaussian PLY and, without
    --skip_mesh, the mesh: empty at the random init, and with faces from
    the cycle-aggregated set of raised-opacity weights (--aug_mesh)."""
    from PIL import Image
    import json
    import yaml
    from f3d_gaus_torch import cli
    from f3d_gaus_torch.io import ply

    rng = np.random.default_rng(2)
    demo = tmp_path / "imgs"
    demo.mkdir()
    img = (rng.uniform(size=(24, 24, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(demo / "s0.png")
    d = (rng.uniform(0.3, 0.8, size=(24, 24)) * 65535).astype(np.int32)
    Image.fromarray(d).save(demo / "s0_depth.png")
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump({"model": {
        "training_resolution": 32, "base_dim": 32, "num_blocks": 1,
        "attention_resolutions": [8]}}))
    orig = TCfg.from_yaml
    monkeypatch.setattr(TCfg, "from_yaml", lambda p: dataclasses.replace(
        orig(p), pair_cap=1 << 12, max_per_tile=256, chunk=32,
        num_aggregation_views=1, num_nvs_views=1))
    ckpt = tmp_path / "raised.pt"
    torch_cases.raised_opacity_checkpoint(ckpt, TCfg.from_yaml(str(cfg_path)))

    meshes = {}
    for name, extra in (("skip", ["--skip_mesh"]), ("init", []),
                        ("aug", ["--aug_mesh", "--load_model", str(ckpt)])):
        out = tmp_path / name
        args = ["--folder", str(demo), "--output_path", str(out),
                "--config", str(cfg_path), "--batch_size", "1",
                "--max_batches", "1", "--device", "cpu"]
        assert cli.main(args + extra) == 0
        files = os.listdir(out / "00_00")
        assert any(f.startswith("nvs.") for f in files)
        assert "gaussians.ply" in files
        assert ("mesh_binary_search.ply" in files) == (name != "skip")
        if name != "skip":
            meshes[name] = ply.read_mesh_ply(out / "00_00" /
                                             "mesh_binary_search.ply")
            stats = json.loads((out / "00_00" / "mesh_stats.json").read_text())
            assert stats["counts"]["faces"] == len(meshes[name][1])
    # the Gaussian PLY holds the cycle-aggregated set under --aug_mesh
    P = 32 * 32
    assert len(ply.read_gaussian_ply(tmp_path / "init" / "00_00" /
                                     "gaussians.ply")["xyz"]) == P
    assert len(ply.read_gaussian_ply(tmp_path / "aug" / "00_00" /
                                     "gaussians.ply")["xyz"]) == 2 * P
    v, f, _ = meshes["aug"]
    assert len(f) > 0 and np.isfinite(v).all() and f.max() < len(v)
    assert f.min() >= 0
    v0, f0, _ = meshes["init"]
    assert len(f0) == 0 or f0.max() < len(v0)


def test_save_video_without_imageio(tmp_path, monkeypatch):
    """Where imageio is not installed (or has no ffmpeg backend) the CLI
    writes its videos as GIFs with PIL, frame for frame."""
    import sys
    from PIL import Image
    from f3d_gaus_torch import cli
    monkeypatch.setitem(sys.modules, "imageio", None)
    frames = [np.full((8, 12, 3), 40 * i, np.uint8) for i in range(3)]
    path = cli._save_video(frames, str(tmp_path / "v"))
    assert path.endswith(".gif")
    with Image.open(path) as im:
        assert im.n_frames == 3 and im.size == (12, 8)
        im.seek(2)
        assert np.asarray(im.convert("RGB"))[0, 0, 0] == 80
