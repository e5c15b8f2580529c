"""The two cells of loops `scene` (Long-LRM) and `view` (viewer frames)
driven through run.py at tiny sizes on the CPU, and the Long-LRM count at
the published shape.  The tiny sizes of the Long-LRM configuration and of
both mixes are added to the shared tables of tiny.py when this module is
imported, so the harness's own parametrised run of every cell finds them
too."""
import json

import numpy as np
import pytest
import torch

import tiny
from benchmark import counts_longlrm
from benchmark import harness as H
from runs import run_cell

SCENE = "longlrm_scene_540.scene_b1"
VIEW = "imagenetgs_256.view"
tiny.TINY.setdefault("longlrm_scene_540", {
    "model": dict(views=2, frame_width=32, frame_height=22, patch=4,
                  width=64, layout="MMM+TMMMT", heads=4, mlp=256, d_state=16,
                  head_dim=16, chunk=8),
    "render": dict(resolution=32, height=22, pair_cap=1 << 14,
                   max_per_tile=256, chunk=32),
    "cameras": dict(targets=2)})
tiny.TINY_TRAFFIC.setdefault("scene_b1", dict(pool=2, check_views=2))
tiny.TINY_TRAFFIC.setdefault("view", dict(plan_cameras=8, warmup_frames=2,
                                          check_frames=2, check_views=2))


@pytest.mark.parametrize("trace", [0, 1])
def test_scene_cell_runs_tiny(tmp_path, trace):
    rc, res, err = run_cell(tmp_path, SCENE, trace=trace)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0
    assert set(res["checks"]) == {
        "premerge_gap", "token_gap", "kept_share", "gauss_share",
        "gauss_mean", "nvs_share", "nvs_mean", "truncated"}
    assert res["checks"]["premerge_gap"]["value"] < 1e-5
    assert res["checks"]["kept_share"]["value"] == 0.0
    if not trace:
        assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    else:
        # no card, so nothing is traced: only the benchmark's count over
        # the window's clock is read
        assert set(res["metrics"]) == {"mfu.scene"}


def test_scene_cell_refuses_the_published_shape_on_the_cpu():
    cell = H.load_cell(SCENE)
    from benchmark.loops import scene
    with pytest.raises(RuntimeError, match="CUDA card"):
        scene.setup(cell, 1, "cpu", H.Tracer(False), H.Spans())


def test_scene_pool_cameras(tmp_path):
    """Inputs on a closed loop at phi0 + 360 i / V, elevations 25 -/+ 8
    degrees, looking at the origin at the scene's radius; the targets
    midway between inputs k V / targets and the next."""
    from benchmark.loops import scene
    cell = H.load_cell(SCENE)
    cell = cell._replace(config={**cell.config, "model": {
        **cell.config["model"], "frame_width": 16, "frame_height": 12}})
    cams = cell.config["cameras"]
    pool = scene.make_pool(cell, "cpu")
    assert len(pool) == cell.traffic["pool"]
    for obj in pool:
        assert obj.images.shape == (1, 32, 12, 16, 3)
        centres = np.stack([np.linalg.inv(wv)[3, :3]
                            for wv in obj.input_views[0]])
        r = np.linalg.norm(centres, axis=-1)
        assert np.ptp(r) < 1e-4 and abs(r[0] / cams["radius"] - 1) <= 0.05
        el = np.degrees(np.arcsin(centres[:, 2] / r))
        assert el.min() >= 25 - 8 - 1e-3 and el.max() <= 25 + 8 + 1e-3
        az = np.unwrap(np.arctan2(centres[:, 1], centres[:, 0]))
        np.testing.assert_allclose(np.diff(az), 2 * np.pi / 32, atol=1e-5)
        t = obj.orbit.cam_centers
        taz = np.arctan2(t[:, 1], t[:, 0])
        want = az[0] + 2 * np.pi * (np.arange(8) * 4 + 0.5) / 32
        np.testing.assert_allclose(np.angle(np.exp(1j * (taz - want))), 0,
                                   atol=1e-5)
        assert float(obj.images.max()) > 0.1


def test_view_cell_runs_tiny(tmp_path):
    rc, res, err = run_cell(tmp_path, VIEW)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    assert res["attempted"] >= 2
    limits = json.loads((H.BENCH / "workloads"
                         / "imagenetgs_256.nvs_b1.json").read_text())
    assert set(res["checks"]) == set(limits["limits"])


def test_view_frames_stay_in_the_orbit_ranges():
    """The same seed draws the same frames; each frame's centre lies
    within the orbit's sideways and vertical reach (yaw and pitch within
    the orbit's ranges, which the orbit reaches at its extremes), and
    the frames spread over it."""
    from benchmark.loops import view
    from benchmark.reference import config as RC
    from benchmark.reference import cycle as RCY
    from benchmark.reference import dataset as RD
    cfg = RC.PipelineConfig()
    inv = RD.canonical_cameras(cfg).inverse_first_camera
    a = view.Frames(cfg, inv, 3).draw(256)
    b = view.Frames(cfg, inv, 3).draw(256)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    wv, fp, cc = a
    assert wv.shape == (256, 4, 4) and fp.shape == (256, 4, 4)
    reach = np.abs(RCY.nvs_cameras(cfg, inv).cam_centers[:, :2]).max(0)
    assert bool((np.abs(cc[:, :2]) <= reach + 1e-4).all())
    assert bool((np.abs(cc[:, :2]).max(0) > 0.8 * reach).all())


def test_longlrm_flops_at_the_published_shape():
    model = H.load_cell(SCENE).config["model"]
    f = counts_longlrm.forward_flops(model)
    assert counts_longlrm.token_counts(model) == (261_120, 65_280)
    assert f["attention"] == 3 * 4 * 65_280 ** 2 * 1024
    assert abs(f["total"] / 1e12 - 100.66) < 0.01
    assert abs(f["attention"] / f["total"] - 0.52) < 0.01
    lengths = counts_longlrm.scan_lengths(model)
    assert lengths == [261_120] * 7 + [65_280] * 14
    b = counts_longlrm.ssd_bound(261_120, model)
    assert b["bound_by"] == "operations" and abs(b["bound_ms"] - 8.43) < 0.01


def test_longlrm_flops_match_a_flop_counter():
    """The count's matrix products at a tiny shape against
    torch.utils.flop_counter over the reference's forward (the scan's
    products are written as matmuls there too, so the counter sees them;
    its conv is shifted sums, which the counter does not see)."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import longlrm as RL
    model = dict(tiny.TINY["longlrm_scene_540"]["model"])
    full = {**H.load_cell(SCENE).config["model"], **model}
    cfg = RL.LongLRMConfig(**full)
    m = RL.LongLRM(cfg, torch.Generator().manual_seed(0))
    images = torch.rand(1, 2, 22, 32, 3)
    wv = torch.eye(4).expand(1, 2, 4, 4).clone()
    wv[..., 3, 2] = 3.0
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        m(images, wv, 0.5, 0.4)
    f = counts_longlrm.forward_flops(full)
    inner = full["expand"] * full["width"]
    conv = sum(2 * L * (inner + 2 * full["d_state"]) * full["d_conv"]
               for L in counts_longlrm.scan_lengths(full))
    # the counter also sees each chunk's C B^T at the chunks' padded length
    # and the decays' products the count leaves out; the linear layers and
    # attention it must see exactly
    counted = fc.get_total_flops()
    assert counted >= f["total"] - conv
    assert counted <= 1.25 * (f["total"] - conv)
