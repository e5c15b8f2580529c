"""AnySplat on the port (models/{dinov2,vggt,anysplat}.py, served
pose-free by pipeline/reconstruct.py:run_gslrm) against the plain
reference models/anysplat_reference.py and against plain formulas, at a
small size on the CPU: 3 views of 56 × 56, patch 14, width 64, 2 heads,
2 DINOv2 blocks, 2 + 2 aggregator blocks, a 2-block camera trunk over 2
iterations, DPT heads on layers (0, 0, 1, 1)."""
import math

import numpy as np
import pytest
import torch

from f3d_gaus_torch.core import cameras as TC
from f3d_gaus_torch.models import anysplat as A
from f3d_gaus_torch.models import anysplat_reference as AR
from f3d_gaus_torch.models import dinov2 as D
from f3d_gaus_torch.models import vggt as VG
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import reconstruct as TRec
from f3d_gaus_torch.utils import profiling

torch.set_num_threads(1)

TINY = dict(views=3, resolution=56, width=64, heads=2, mlp=256,
            dino_layers=2, depth=2, camera_layers=2, camera_iters=2,
            camera_heads=2, dpt_layers=(0, 0, 1, 1),
            dpt_channels=(16, 32, 64, 64), dpt_features=32, voxel=0.05)


@pytest.fixture(autouse=True)
def _dpt_chunk(monkeypatch):
    """Two frames a DPT pass, so the 3 views take a full and a short one."""
    monkeypatch.setattr(VG, "DPT_CHUNK", 2)


def _models(seed=0):
    ref = AR.AnySplat(AR.AnySplatConfig(**TINY),
                      torch.Generator().manual_seed(seed))
    model = A.AnySplat(A.AnySplatConfig(**TINY), None)
    model.load_state_dict(ref.state_dict())
    return model.eval(), ref.eval()


def _images(seed=1, views=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(1, views, 56, 56, 3, generator=g)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_published_widths():
    cfg = A.AnySplatConfig()
    assert (cfg.tokens_per_frame, cfg.tokens, cfg.gaussians) == (
        1029, 24_696, 4_816_896)
    with torch.device("meta"):
        model = A.AnySplat(cfg)
    assert sum(p.numel() for p in model.parameters()) == 1_190_595_360
    assert A.AnySplatConfig()._asdict() == AR.AnySplatConfig()._asdict()


def test_state_dict_names_vggts_parts():
    model, ref = _models()
    keys = set(model.state_dict())
    assert keys == set(ref.state_dict())
    assert {"aggregator.patch_embed.patch_embed.proj.weight",
            "aggregator.patch_embed.cls_token",
            "aggregator.patch_embed.register_tokens",
            "aggregator.patch_embed.pos_embed",
            "aggregator.patch_embed.blocks.1.ls2.gamma",
            "aggregator.camera_token", "aggregator.register_token",
            "aggregator.frame_blocks.0.attn.q_norm.weight",
            "aggregator.global_blocks.1.attn.k_norm.bias",
            "camera_head.poseLN_modulation.1.weight",
            "camera_head.pose_branch.fc2.bias",
            "camera_head.empty_pose_tokens",
            "depth_head.scratch.refinenet1.resConfUnit1.conv1.weight",
            "depth_head.scratch.output_conv2.2.weight",
            "gaussian_head.resize_layers.3.weight"} <= keys
    assert not any(k.startswith("depth_head.scratch.refinenet4.resConfUnit1")
                   for k in keys)
    assert "depth_head.scratch.layer1_rn.bias" not in keys
    assert model.state_dict()["aggregator.camera_token"].shape == (1, 2, 1,
                                                                   64)


@pytest.mark.parametrize("seed", [0, 1])
def test_anysplat_matches_the_reference(seed):
    """DINOv2's patch tokens, the last pair's tokens, the pose encodings,
    the depth maps and the merged Gaussians within 2e-6 of their max, and
    the same merged voxel keys exactly."""
    model, ref = _models(seed)
    images = _images(seed + 1)
    seen = {}
    model.aggregator.patch_embed.register_forward_hook(
        lambda m, a, o: seen.__setitem__("patch", o))
    model.aggregator.register_forward_hook(
        lambda m, a, o: seen.__setitem__("tokens", o[1]))
    model.depth_head.register_forward_hook(
        lambda m, a, o: seen.__setitem__("depth", torch.exp(o[:, :, 0])))
    with torch.no_grad():
        got = model(images)
        want, aux = ref(images)
    assert seen["patch"].shape == (3, 16, 64)
    assert seen["tokens"].shape == (1, 3, 21, 128)
    assert _rel(seen["patch"], aux["patch_tokens"]) < 2e-6
    assert _rel(seen["tokens"], aux["tokens"]) < 2e-6
    assert _rel(seen["depth"], aux["depth"]) < 2e-6
    assert _rel(got["cameras"]["pose_enc"], want["cameras"]["pose_enc"]) < 2e-6
    for k in ("world_view", "full_proj", "cam_centers", "tan_fovx",
              "tan_fovy"):
        assert torch.allclose(got["cameras"][k], want["cameras"][k],
                              atol=2e-6), k
    assert torch.equal(got["voxels"], want["voxels"])
    assert got["voxels"].shape[1] < 3 * 56 * 56
    for k in ("xyz", "opacity", "scaling", "rotation", "features_dc"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k], want[k]) < 2e-6, k
    assert got["features_rest"].shape == (1, got["xyz"].shape[1], 0, 3)


@pytest.mark.parametrize("chunk", [1, 3])
def test_dpt_maps_do_not_depend_on_the_chunk(monkeypatch, chunk):
    """The depth head's maps at `chunk` frames a pass are those of the
    fixture's 2 frames a pass."""
    model, _ = _models()
    g = torch.Generator().manual_seed(5)
    layers = {i: torch.randn(1, 3, 21, 128, generator=g) for i in (0, 1)}
    with torch.no_grad():
        want = model.depth_head(layers, 56, 56)
        monkeypatch.setattr(VG, "DPT_CHUNK", chunk)
        got = model.depth_head(layers, 56, 56)
    assert got.shape == want.shape == (1, 3, 2, 56, 56)
    assert _rel(got, want) < 2e-6


def test_rope_2d_is_a_rotation_of_each_pair():
    """rotate_2d against a written-out rotation: for each token and head,
    feature i of each half (rows, then columns) and feature i + d/4 turn
    as a 2D vector by pos · 100^(-2i / (d/2))."""
    g = torch.Generator().manual_seed(3)
    d, L = 16, 7
    x = torch.randn(2, 3, L, d, generator=g)
    pos = torch.randint(0, 9, (L, 2), generator=g)
    cos, sin = D.rope_tables(pos, d, 100.0)
    got = D.rotate_2d(x, cos, sin)
    want = torch.empty_like(x)
    for t in range(L):
        for part in range(2):
            p = float(pos[t, part])
            for i in range(d // 4):
                a = p * 100.0 ** (-2.0 * i / (d // 2))
                lo, hi = part * d // 2 + i, part * d // 2 + i + d // 4
                c, s = math.cos(a), math.sin(a)
                want[..., t, lo] = x[..., t, lo] * c - x[..., t, hi] * s
                want[..., t, hi] = x[..., t, hi] * c + x[..., t, lo] * s
    assert torch.allclose(got, want, atol=1e-5)
    # a token at position 0 is not turned
    zero = D.rotate_2d(x, *D.rope_tables(torch.zeros_like(pos), d, 100.0))
    assert torch.equal(zero, x)


@pytest.mark.parametrize("kind,moves", [("frame", False), ("global", True)])
def test_a_frame_block_keeps_frames_apart(kind, moves):
    """Changing frame 2's tokens leaves frames 0 and 1 of a frame block's
    output unmoved, bit for bit; a global block's move."""
    model, _ = _models()
    agg = model.aggregator
    block = agg.frame_blocks[0] if kind == "frame" else agg.global_blocks[0]
    S, T, C = 3, 21, 64
    g = torch.Generator().manual_seed(5)
    x = torch.randn(1, S, T, C, generator=g)
    y = x.clone()
    y[:, 2] += torch.randn(T, C, generator=g)
    from f3d_gaus_torch.models.vggt import token_positions
    rope = D.rope_tables(token_positions(4, 4, 5, "cpu"), C // 2, 100.0)

    def run(t):
        with torch.no_grad():
            if kind == "frame":
                return block(t.reshape(S, T, C), rope).reshape(1, S, T, C)
            both = (rope[0].repeat(S, 1), rope[1].repeat(S, 1))
            return block(t.reshape(1, S * T, C), both).reshape(1, S, T, C)
    a, b = run(x), run(y)
    assert not torch.equal(a[:, 2], b[:, 2])
    assert torch.equal(a[:, :2], b[:, :2]) is not moves


def _encode(world_view, tan_fovx, tan_fovy):
    """pose_encoding_to_cameras' inverse: (T, quaternion (x, y, z, w) with
    w >= 0, fov_h, fov_w) of row-vector world_view tensors."""
    from f3d_gaus_torch.core.quaternions import rotmat_to_quat
    wxyz = rotmat_to_quat(world_view[..., :3, :3].transpose(-1, -2))
    wxyz = torch.where(wxyz[..., :1] < 0, -wxyz, wxyz)
    return torch.cat([world_view[..., 3, :3], wxyz[..., 1:], wxyz[..., :1],
                      2 * torch.atan(tan_fovy)[..., None],
                      2 * torch.atan(tan_fovx)[..., None]], -1)


def test_pose_encoding_round_trip():
    """encoding -> row-vector cameras -> encoding; the cameras equal
    build_camera_set's chain at the same pose and tangents (world_view,
    full_proj through projection_matrix, the centre)."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(5, 4, generator=g)
    q = q / q.norm(dim=-1, keepdim=True)
    q = torch.where(q[:, 3:] < 0, -q, q)
    fov = torch.rand(5, 2, generator=g) * 0.8 + 0.6
    enc = torch.cat([torch.randn(5, 3, generator=g), q, fov], -1)
    cams = TC.pose_encoding_to_cameras(enc, 0.01, 100.0)
    back = _encode(cams["world_view"], cams["tan_fovx"], cams["tan_fovy"])
    assert torch.allclose(back, enc, atol=1e-4)
    wv = cams["world_view"].numpy()
    for i in range(5):
        proj = TC.projection_matrix(0.01, 100.0, float(fov[i, 1]),
                                    float(fov[i, 0]))
        np.testing.assert_allclose(cams["full_proj"][i].numpy(),
                                   wv[i] @ proj.T, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(cams["cam_centers"][i].numpy(),
                                   np.linalg.inv(wv[i])[3, :3], atol=1e-5)
        R = wv[i, :3, :3].T
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert torch.allclose(cams["tan_fovx"], torch.tan(fov[:, 1] / 2))
    # an unnormalised quaternion gives the same rotation
    scaled = enc.clone()
    scaled[:, 3:7] *= 2.5
    assert torch.allclose(
        TC.pose_encoding_to_cameras(scaled, 0.01, 100.0)["world_view"],
        cams["world_view"], atol=1e-6)


def _cloud(n, seed):
    g = torch.Generator().manual_seed(seed)
    rot = torch.randn(n, 4, generator=g)
    return {"xyz": torch.rand(n, 3, generator=g) * 0.3,
            "opacity": torch.rand(n, 1, generator=g),
            "scaling": torch.rand(n, 3, generator=g) * 0.01,
            "rotation": rot / rot.norm(dim=-1, keepdim=True),
            "features_dc": torch.randn(n, 1, 3, generator=g)}, \
        torch.randn(n, generator=g)


@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_merge_ignores_the_input_order(seed):
    """A shuffled input merges to the same keys, in key order, and the
    same fields within f32 rounding; the merge equals the reference's
    (unique with its inverse, index_add_)."""
    g, conf = _cloud(500, seed)
    out, keys = A.voxel_merge(g, conf, 0.05)
    perm = torch.randperm(500, generator=torch.Generator().manual_seed(9))
    out2, keys2 = A.voxel_merge({k: v[perm] for k, v in g.items()},
                                conf[perm], 0.05)
    assert torch.equal(keys, keys2)
    assert keys.shape[0] < 500
    order = torch.tensor(sorted(range(keys.shape[0]),
                                key=lambda i: keys[i].tolist()))
    assert torch.equal(order, torch.arange(keys.shape[0]))
    want, wkeys = AR.merge(g, conf, 0.05)
    assert torch.equal(keys, wkeys)
    for k in g:
        assert torch.allclose(out[k], out2[k], atol=1e-6), k
        assert torch.allclose(out[k], want[k], atol=1e-6), k


def test_a_voxel_of_one_gaussian_keeps_it():
    g, conf = _cloud(50, 2)
    g["xyz"] = torch.arange(50, dtype=torch.float32)[:, None].expand(
        50, 3) * 0.1 + 0.01
    out, keys = A.voxel_merge(g, conf, 0.05)
    assert keys.shape[0] == 50
    for k in g:
        if k == "rotation":     # a unit quaternion renormalised
            assert torch.allclose(out[k], g[k], rtol=0, atol=3e-7)
        else:
            assert torch.equal(out[k], g[k]), k


def test_weights_average_within_a_voxel():
    """Two Gaussians in one voxel: softmax(conf) weights; the rotation
    renormalised."""
    g, _ = _cloud(2, 3)
    g["xyz"] = torch.tensor([[0.01, 0.01, 0.01], [0.02, 0.03, 0.04]])
    conf = torch.tensor([0.0, math.log(3.0)])
    out, keys = A.voxel_merge(g, conf, 0.05)
    assert keys.tolist() == [[0, 0, 0]]
    w = torch.tensor([0.25, 0.75])
    assert torch.allclose(out["xyz"][0], (w[:, None] * g["xyz"]).sum(0))
    r = (w[:, None] * g["rotation"]).sum(0)
    assert torch.allclose(out["rotation"][0], r / r.norm())


def test_run_gslrm_pose_free_end_to_end():
    """No input cameras: run_gslrm renders the merged set at the predicted
    cameras of inputs k·V/8 (0, 0, 0, 1, 1, 1, 2, 2 of 3 views), each at
    its own tangents, returns the cameras, and the renders equal a stage
    of one view at each target's own camera; spans and counters."""
    from f3d_gaus_torch.pipeline import renderer as TR
    model, _ = _models()
    images = _images()
    cfg = TCfg.PipelineConfig(resolution=56, fov_deg=60.0, max_sh_degree=0,
                              pair_cap=1 << 14, max_per_tile=256, chunk=32)
    with profiling.record():
        res = TRec.run_gslrm(model, cfg, images, device="cpu")
        snap = profiling.snapshot()
    assert res.attempts == 1 and res.cameras is not None
    assert res.renders["render"].shape == (1, 8, 3, 56, 56)
    assert not bool(res.renders["overflow"].any())
    cams = res.cameras
    assert cams["world_view"].shape == (1, 3, 4, 4)
    tx = cams["tan_fovx"][0]
    assert len({float(t) for t in tx}) == 3
    for k, i in enumerate([0, 0, 0, 1, 1, 1, 2, 2]):
        one = TR.render_views_batched(
            res.gaussians, cams["world_view"][0, i:i + 1].numpy(),
            cams["full_proj"][0, i:i + 1].numpy(),
            cams["cam_centers"][0, i:i + 1].numpy(), torch.zeros(3),
            res.cfg, tangents=[(float(cams["tan_fovx"][0, i]),
                                float(cams["tan_fovy"][0, i]))])
        assert torch.equal(one["render"][0, 0], res.renders["render"][0, k])
    spans = snap["spans"]
    for name in ("recon", "predict", "anysplat", "dinov2", "aggregator",
                 "camera_head", "unproject", "voxelize", "orbit"):
        assert spans[name]["calls"] == 1, name
    assert spans["frame"]["calls"] == spans["global"]["calls"] == 2
    assert spans["dpt"]["calls"] == 2
    # DINOv2's 2, the aggregator's 4, the camera trunk's 2 x 2
    assert spans["attention"]["calls"] == 10
    c = snap["counters"]
    assert c["anysplat.gaussians"] == 3 * 56 * 56
    assert c["voxel.kept"] == res.gaussians["xyz"].shape[1]
