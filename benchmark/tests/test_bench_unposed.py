"""The two cells of loops `unposed` (AnySplat, pose-free) and `nvs_b8`
(batched serving) driven through run.py at tiny sizes on the CPU, and the
AnySplat count at the published widths.  The tiny sizes of the AnySplat
configuration and of both mixes are added to the shared tables of tiny.py
when this module is imported, so the harness's own parametrised run of
every cell finds them too."""
import json

import pytest
import torch

import tiny
from benchmark import counts_anysplat
from benchmark import harness as H
from runs import run_cell

UNPOSED = "anysplat_scene_448.unposed_b1"
NVS_B8 = "imagenetgs_256.nvs_b8"
# depth 1.0 and voxel 0.02: the seeded Gaussians (scale 0.01) then cover
# about a pixel of the 56-pixel frame, as they do at 448 pixels and depth 3
tiny.TINY.setdefault("anysplat_scene_448", {
    "model": dict(views=3, resolution=56, width=64, heads=2, mlp=256,
                  dino_layers=2, depth=2, camera_layers=2, camera_iters=2,
                  camera_heads=2, dpt_layers=[0, 0, 1, 1],
                  dpt_channels=[16, 32, 64, 64], dpt_features=32,
                  voxel=0.02, depth_bias=1.0),
    "render": dict(resolution=56, pair_cap=1 << 14, max_per_tile=256,
                   chunk=32)})
tiny.TINY_TRAFFIC.setdefault("unposed_b1", dict(pool=2, check_views=2))
tiny.TINY_TRAFFIC.setdefault("nvs_b8", dict(batch=2, pool=2, check_views=2))


@pytest.mark.parametrize("trace", [0, 1])
def test_unposed_cell_runs_tiny(tmp_path, trace):
    rc, res, err = run_cell(tmp_path, UNPOSED, trace=trace)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0
    assert set(res["checks"]) == {
        "patch_gap", "token_gap", "pose_gap", "depth_gap", "voxel_share",
        "gauss_share", "gauss_mean", "nvs_share", "nvs_mean", "truncated"}
    assert res["checks"]["voxel_share"]["value"] < 1e-3
    if not trace:
        assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    else:
        # no card, so nothing is traced: only the benchmark's count over
        # the window's clock is read
        assert set(res["metrics"]) == {"mfu.unposed"}


def test_unposed_cell_refuses_the_published_shape_on_the_cpu():
    cell = H.load_cell(UNPOSED)
    from benchmark.loops import unposed
    with pytest.raises(RuntimeError, match="CUDA card"):
        unposed.setup(cell, 1, "cpu", H.Tracer(False), H.Spans())


@pytest.mark.parametrize("trace", [0, 1])
def test_nvs_b8_cell_runs_tiny(tmp_path, trace):
    rc, res, err = run_cell(tmp_path, NVS_B8, trace=trace)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert res["attempted"] >= 2 and res["attempted"] % 2 == 0
    limits = json.loads((H.BENCH / "workloads"
                         / "imagenetgs_256.nvs_b1.json").read_text())
    assert set(res["checks"]) == set(limits["limits"])
    # both elements of the tiny batch are checked
    assert "checked_images" in err and "[0, 1]" in err
    if not trace:
        assert set(res["metrics"]) == {"nvs_images_per_s", "setup_s"}
    else:
        print(sorted(res["metrics"]))


def test_unposed_pool_is_the_scene_loops_at_the_square_frame():
    from benchmark.loops import unposed
    cell = H.load_cell(UNPOSED)
    cell = cell._replace(config={**cell.config, "model": {
        **cell.config["model"], "resolution": 16}})
    pool = unposed.make_pool(cell, "cpu")
    assert len(pool) == cell.traffic["pool"]
    assert all(o.images.shape == (1, 24, 16, 16, 3) for o in pool)
    assert float(pool[0].images.max()) > 0.1


def test_common_voxels_matches_keys():
    from benchmark.loops import unposed
    a = torch.tensor([[0, 0, 0], [0, 1, 2], [3, 3, 3], [5, 0, 1]])
    b = torch.tensor([[0, 1, 2], [1, 1, 1], [5, 0, 1]])
    ia, ib = unposed.common_voxels(a, b)
    assert ia.tolist() == [1, 3] and ib.tolist() == [0, 2]


def test_anysplat_flops_at_the_published_widths():
    model = H.load_cell(UNPOSED).config["model"]
    f = counts_anysplat.forward_flops(model)
    assert counts_anysplat.tokens_per_frame(model) == 1029
    assert f["global_attention"] == 24 * 4 * 24_696 ** 2 * 1024
    assert abs(f["total"] / 1e12 - 120.47) < 0.01
    assert abs(f["global_attention"] / f["total"] - 0.498) < 0.001
    b = counts_anysplat.attention_bound(model)
    assert b["calls"] == 24 + 48 + 16 and b["bound_by"] == "operations"


def test_anysplat_flops_match_a_flop_counter():
    """The count against torch.utils.flop_counter over the program's
    forward at a tiny shape: the linear layers, attention scores,
    convolutions and transposed convolutions it must see exactly (the
    counter sees the position tables' and unprojection's small products
    too)."""
    from torch.utils.flop_counter import FlopCounterMode
    from f3d_gaus_torch.models import anysplat as A
    over = tiny.TINY["anysplat_scene_448"]["model"]
    full = {**H.load_cell(UNPOSED).config["model"], **over}
    cfg = A.AnySplatConfig(**H.fields(full))
    m = A.AnySplat(cfg, torch.Generator().manual_seed(0)).eval()
    m.requires_grad_(False)
    images = torch.rand(1, 3, 56, 56, 3)
    with FlopCounterMode(display=False) as fc:
        m(images)
    f = counts_anysplat.forward_flops(full)
    counted = fc.get_total_flops()
    assert f["total"] <= counted <= 1.01 * f["total"]
