"""The two cells of loops `recon` (GS-LRM) and `nvs_new` driven through
run.py at tiny sizes on the CPU, and the GS-LRM count at the published
widths.  The tiny sizes of the GS-LRM configuration and its mix are added
to the shared tables of tiny.py when this module is imported, so the
harness's own parametrised run of every cell finds them too."""
import json

import pytest
import torch

import tiny
from benchmark import counts_gslrm
from benchmark import harness as H
from runs import run_cell

RECON = "gslrm_object_512.recon_b1"
NEW = "imagenetgs_256.nvs_new"
tiny.TINY.setdefault("gslrm_object_512", {
    "model": dict(views=2, resolution=32, patch=8, width=64, layers=2,
                  heads=4, mlp=256),
    "render": dict(resolution=32, pair_cap=1 << 14, max_per_tile=256)})
tiny.TINY_TRAFFIC.setdefault("recon_b1", dict(pool=2, frames=4,
                                              check_views=2))
tiny.TINY_TRAFFIC.setdefault("nvs_new", dict(warmup=1, max_requests=12,
                                             check_views=2))


def _tiny_cameras(tmp_path):
    """The tiny root with the GS-LRM configuration's input views cut to
    two (its model holds 2 views)."""
    root = tiny.tiny_root(tmp_path)
    path = root / "benchmark" / "configs" / "gslrm_object_512.json"
    cfg = json.loads(path.read_text())
    cfg["cameras"]["input_azimuths_deg"] = [0.0, 180.0]
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_recon_cell_runs_tiny(tmp_path, trace):
    root = _tiny_cameras(tmp_path)
    rc, res, err = run_cell(tmp_path, RECON, trace=trace, root=root)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0
    assert set(res["checks"]) == {"token_gap", "gauss_share", "gauss_mean",
                                  "nvs_share", "nvs_mean", "truncated"}
    assert res["checks"]["token_gap"]["value"] < 1e-5
    if not trace:
        assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    else:
        # no card, so nothing is traced: only the benchmark's count over
        # the window's clock is read
        assert set(res["metrics"]) == {"mfu.recon"}


def test_recon_cell_refuses_the_published_widths_on_the_cpu():
    cell = H.load_cell(RECON)
    from benchmark.loops import recon
    with pytest.raises(RuntimeError, match="CUDA card"):
        recon.setup(cell, 1, "cpu", H.Tracer(False), H.Spans())


def test_nvs_new_cell_runs_tiny(tmp_path):
    rc, res, err = run_cell(tmp_path, NEW)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    assert res["attempted"] >= 1


def test_nvs_new_serves_each_image_once(tmp_path, monkeypatch):
    """The window's requests serve the stream's images in order, none of
    the warm-up's, and the caps each request returns start the next."""
    from benchmark.loops import nvs_new
    from f3d_gaus_torch.pipeline import cycle
    served, cfgs = [], []
    orig = cycle.run_nvs_replanned

    def spy(model, cfg, cams, images, depth, **kw):
        served.append(float(images.sum()))
        cfgs.append(cfg)
        res = orig(model, cfg, cams, images, depth, **kw)
        cfgs.append(res.cfg)
        return res
    monkeypatch.setattr(cycle, "run_nvs_replanned", spy)
    root = tiny.tiny_root(tmp_path)
    cell = H.load_cell(NEW, root)
    st = nvs_new.setup(cell, 5, "cpu", H.Tracer(False), H.Spans())
    warm = len(served)
    nvs_new.window(st, 0.0, H.Run(cell, 0.0))
    window = served[warm:]
    assert window == [float(img.sum()) for img, _ in st.images[:len(window)]]
    assert not set(window) & set(served[:warm])
    # each request starts from the previous one's returned caps
    assert all(a == b for a, b in zip(cfgs[1::2], cfgs[2::2]))


def test_gslrm_flops_at_the_published_widths():
    cfg = json.loads((H.BENCH / "configs" / "gslrm_object_512.json")
                     .read_text())
    f = counts_gslrm.forward_flops(cfg["model"])
    assert f["total"] == pytest.approx(36.3e12, rel=0.01)
    assert f["attention"] == 24 * 4 * 16384 ** 2 * 1024
    b = counts_gslrm.attention_bound(16384, 1024)
    assert b["bound_by"] == "operations"
    assert 24 * b["bound_ms"] == pytest.approx(394, rel=0.01)


def test_gslrm_flops_match_a_flop_counter():
    """The count by formula equals torch's FLOP counter over the
    reference at a small size (its matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import gslrm as RG
    model = dict(views=2, resolution=32, patch=8, width=64, layers=2,
                 heads=4, mlp=256, gaussian_channels=12)
    ref = RG.GSLRM(RG.GSLRMConfig(**model), torch.Generator().manual_seed(0))
    images = torch.rand(1, 2, 32, 32, 3)
    wv = torch.eye(4).expand(1, 2, 4, 4).clone()
    wv[..., 3, 2] = 4.0
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref(images, wv, 0.36)
    # the rays' 3x3 products are no part of the model's count
    rays = 2 * 2 * 32 * 32 * 3 * 3 + 2 * 2 * 3 * 3
    assert fc.get_total_flops() - rays == counts_gslrm.forward_flops(
        model)["total"]
