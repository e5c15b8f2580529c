"""The frozen counts: K1's needed pairs, operations and bytes at 32x32
cases against chip_smoke.py's pair_work on the same case and against a
hand count, and the predictor's FLOPs against a count by layer."""
import math

import numpy as np
import pytest
import torch

from benchmark import counts
from benchmark.reference import rasterize as RZ
from benchmark.reference.cameras import Camera, projection_matrix
from tiny import TINY


def _camera(size=32):
    wv = np.eye(4, dtype=np.float32)          # camera at the origin, +z
    fov = 2 * math.atan(0.5)
    fp = (wv @ projection_matrix(0.01, 100.0, fov, fov).T).astype(np.float32)
    return Camera(wv, fp, np.zeros(3, np.float32), size, size, 0.5, 0.5)


def _cloud(n, seed):
    g = torch.Generator().manual_seed(seed)
    means = torch.rand(n, 3, generator=g) * torch.tensor([1.6, 1.6, 2.0]) \
        - torch.tensor([0.8, 0.8, -2.0])
    scales = torch.rand(n, 3, generator=g) * 0.08 + 0.01
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g),
                                          dim=1)
    opa = torch.rand(n, 1, generator=g) * 0.9 + 0.05
    shs = torch.randn(n, 4, 3, generator=g) * 0.3
    return means, scales, quats, opa, shs


def _prepared(cloud, size=32, **caps):
    return RZ.prepare(*cloud, _camera(size), torch.zeros(3), sh_degree=1,
                      pair_cap=caps.get("pair_cap", 1 << 14),
                      max_per_tile=caps.get("max_per_tile", 512), chunk=128)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_work_matches_chip_smoke(seed):
    import chip_smoke
    from f3d_gaus_torch.ops import rasterize as PR
    cloud = _cloud(300, seed)
    ours = counts.pair_work(_prepared(cloud))
    cam = _camera()
    theirs = chip_smoke.pair_work(PR.prepare(
        *cloud, cam, torch.zeros(3), sh_degree=1, pair_cap=1 << 14,
        max_per_tile=512, chunk=128))
    assert ours["walked"] > 0 and ours["contrib"] > 0
    for k in ("walked", "walked_rejected", "contrib"):
        assert ours[k] == theirs[k], k


def test_k1_bound_by_hand():
    """One large Gaussian filling one 16x16 tile: each pixel walks one
    pair and composites it, none ruled out."""
    cloud = (torch.tensor([[0.0, 0.0, 4.0]]), torch.tensor([[2.0, 2.0, 2.0]]),
             torch.tensor([[1.0, 0.0, 0.0, 0.0]]), torch.tensor([[0.5]]),
             torch.zeros(1, 4, 3))
    inp = _prepared(cloud, size=16)
    b = counts.k1_bound(inp)
    assert b["work"] == {"walked": 256, "walked_rejected": 0, "contrib": 256}
    assert b["ops"] == 256 * (counts.OPS_PER_DECIDED + counts.OPS_PER_CONTRIB)
    # one id, one feature row, one tile's offset and count; 3 words and
    # 256 pixels x 15 outputs written
    assert b["bytes"] == 4 + 19 * 4 + 2 * 4 + 3 * 4 + 256 * 15 * 4
    t_ops = b["ops"] / 67e12 * 1e3
    t_bytes = b["bytes"] / 3.35e12 * 1e3
    assert b["bound_ms"] == pytest.approx(max(t_ops, t_bytes))


def test_predictor_flops_by_layer():
    """FlopCounterMode's count against convolutions and attention counted
    by layer on the same forward (the camera lifting's small matrix
    products, a few hundred FLOPs a pixel, aside)."""
    from benchmark.reference import config as RC
    from benchmark.reference import layers as L
    from benchmark.reference import predictor as RP
    pf = {**TINY["imagenetgs_256"]["pipeline"], "attn_resolutions": (8,)}
    counted = counts.predictor_flops(pf, 2, 1)
    cfg = RC.PipelineConfig(**pf)
    model = RP.GaussianPredictor(cfg.predictor_config())
    by_hand = [0]

    def conv_hook(mod, inp, out):
        cin, k = mod.weight.shape[1], mod.weight.shape[-1]
        by_hand[0] += 2 * out.numel() * cin * k * k
    for m in model.modules():
        if isinstance(m, L.Conv2d):
            m.register_forward_hook(conv_hook)
    attention = L.attention

    def counted_attention(q, k, v):
        B, N, C = q.shape
        by_hand[0] += 2 * (2 * B * N * N * C)
        return attention(q, k, v)
    L.attention = counted_attention
    try:
        r = cfg.resolution
        model(torch.zeros(2, 1, r, r, 4), torch.eye(4).expand(2, 1, 4, 4),
              torch.tensor([1.0, 0, 0, 0]).expand(2, 1, 4),
              torch.ones(2, 1, r, r))
    finally:
        L.attention = attention
    assert by_hand[0] > 0
    assert abs(counted - by_hand[0]) / by_hand[0] < 1e-3


def test_train_step_flops_adds_its_parts():
    pf = TINY["imagenetgs_256"]["pipeline"]
    w = {"w_perceptual": 2.0, "w_clip": 0.35}
    total = counts.train_step_flops(pf, 2, w)
    parts = (counts.predictor_flops(pf, 2, 1, backward=True)
             + counts.predictor_flops(pf, 2, 2, backward=True)
             + counts.tower_flops(2, pf["resolution"], w))
    assert total == parts
    # a backward costs about twice its forward
    fwd = counts.predictor_flops(pf, 2, 1)
    both = counts.predictor_flops(pf, 2, 1, backward=True)
    assert 2.5 * fwd < both < 3.2 * fwd
