"""The port's plain render (f3d_gaus_torch.ops.rasterize.render on the
CPU) against the sequential f64 oracle of the reference's CUDA semantics,
f3d_gaus_tpu/ops/rasterize_ref.py (a numpy module), on the inputs of
tests/test_rasterize_parity.py:TestForwardParity and TestBackwardParity:
the same seeds and clouds, the oracle fed the f64 v2g derived from the
port's own f32 (M, b) packing, and the same cotangent with the alpha
channel zeroed.  The tolerances are the ones the JAX package's XLA path is
held to there.  The contributor positions, which that file leaves out,
must match the oracle's 1-based counts (the port's window position + 1).

The densification statistics (dL_dmean2d x, y, |.|) are held to the oracle
too: the JAX package's XLA backward and its Pallas backward measure the
pixel offset half a pixel apart (ROADMAP.md C), and this settles which of
them the CUDA semantics follow."""
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.ops import rasterize_ref
from f3d_gaus_torch.core import gaussians as TG
from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CAPS = dict(pair_cap=1 << 14, max_per_tile=256)


def _tensors(cloud):
    return [torch.from_numpy(a) for a in cloud]


def _oracle_pre(cloud, cam):
    """The port's preprocess, with the oracle's 10-float v2g derived in f64
    from the same f32 (M, b) the port's compositing consumes (tests/
    test_rasterize_parity.py:TestBackwardParity's construction)."""
    pre = TG.preprocess(*_tensors(cloud), 1, cam)
    mb = pre.v2g_mb.double().numpy()
    M = mb[:, :9].reshape(-1, 3, 3)
    b = mb[:, 9:]
    A = np.einsum('pki,pkj->pij', M, M)
    v2g64 = np.concatenate([
        np.stack([A[:, 0, 0], A[:, 0, 1], A[:, 0, 2],
                  A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]], -1),
        np.einsum('pkj,pk->pj', M, b),
        np.sum(b * b, -1, keepdims=True)], -1)
    return pre, pre._replace(**{k: getattr(pre, k).numpy() for k in (
        "depths", "means2d", "conic", "opa_coef", "rgb", "radii", "valid")},
        v2g=v2g64)


def _render(cloud, cam, bg, chunk=32):
    return TR.render(*_tensors(cloud), cam, torch.from_numpy(bg), chunk=chunk,
                     **CAPS)


def _positions(out, cam):
    """The port's last / max contributor as 1-based counts, (2, H, W)."""
    s = TR.RasterStatics(cam.width, cam.height, 2, 2, float(cam.focal_x),
                         float(cam.focal_y), CAPS["max_per_tile"], 32)
    pos = torch.stack([out["aux"].last_pos, out["aux"].max_pos], -1)
    return TR._tiles_to_image(pos, s).numpy() + 1


def test_forward_matches_oracle():
    """TestForwardParity.test_forward_matches_oracle and
    test_final_T_and_contributors: the nine channels (the median depth, a
    discrete selection, on >= 99 % of pixels), final_T and the contributor
    positions."""
    cam, cloud = torch_cases.setup(np.random.default_rng(0))
    _, pre = _oracle_pre(cloud, cam)
    for bg in (np.array([0.1, 0.2, 0.3], np.float32), np.zeros(3, np.float32)):
        oracle = rasterize_ref.render_forward(pre, cam, bg)
        out = _render(cloud, cam, bg)
        assert not bool(out["overflow"])
        got = out["out9"].numpy()
        for ch in (slice(0, 3), slice(3, 6), 7, 8):
            np.testing.assert_allclose(got[ch], oracle.out[ch], atol=2e-3)
        frac_bad = np.mean(np.abs(got[6] - oracle.out[6]) > 1e-3)
        assert frac_bad < 0.01, f"median depth mismatch fraction {frac_bad}"
        s = TR.RasterStatics(cam.width, cam.height, 2, 2, float(cam.focal_x),
                             float(cam.focal_y), CAPS["max_per_tile"], 32)
        T_img = TR._tiles_to_image(out["aux"].final_T[..., None], s)[0]
        np.testing.assert_allclose(T_img.numpy(), oracle.final_T[0],
                                   atol=3e-3)
        pos = _positions(out, cam)
        np.testing.assert_array_equal(pos[0], oracle.n_contrib[0])
        assert np.mean(pos[1] != oracle.n_contrib[1]) < 0.01
        assert oracle.n_contrib[0].max() > 10      # deep windows are walked


def test_early_stop_matches_oracle():
    """TestForwardParity.test_early_stop_equivalence: near-opaque
    Gaussians stacked until T falls below 1e-4; colour 5e-5, depth 1e-4,
    and the walk stops where the oracle's does."""
    rng = np.random.default_rng(0)
    cam, _ = torch_cases.setup(rng)
    n = 64
    means = np.tile(np.array([[0.0, 0.0, 7.4]], np.float32), (n, 1))
    means[:, 2] += np.linspace(0, 0.8, n).astype(np.float32)
    means[:, :2] += rng.normal(size=(n, 2)).astype(np.float32) * 0.02
    scales = np.full((n, 3), 0.3, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opac = np.full((n, 1), 0.95, np.float32)
    shs = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.2
    cloud = (means, scales, quats, opac, shs)
    bg = np.zeros(3, np.float32)
    _, pre = _oracle_pre(cloud, cam)
    oracle = rasterize_ref.render_forward(pre, cam, bg)
    assert (oracle.final_T[0] < 1e-3).any(), "early stop should trigger"
    out = _render(cloud, cam, bg, chunk=16)
    got = out["out9"].numpy()
    np.testing.assert_allclose(got[0:3], oracle.out[0:3], atol=5e-5)
    np.testing.assert_allclose(got[6], oracle.out[6], atol=1e-4)
    np.testing.assert_array_equal(_positions(out, cam)[0],
                                  oracle.n_contrib[0])


def _pack(mb):
    """The reference's 10-float packing of (M, b): (M^T M upper 6, M^T b,
    |b|^2), through which the oracle's v2g cotangent pulls back to mb."""
    M = mb[..., :9].reshape(mb.shape[:-1] + (3, 3))
    b = mb[..., 9:]
    A = torch.einsum('...ki,...kj->...ij', M, M)
    B3 = torch.einsum('...kj,...k->...j', M, b)
    C = torch.sum(b * b, -1, keepdim=True)
    tri = torch.stack([A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                       A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]], -1)
    return torch.cat([tri, B3, C], -1)


def test_backward_matches_oracle():
    """TestBackwardParity.test_backward_matches_oracle: the gradients of
    (M, b) (2e-4 x max), rgb (1e-4), opacity (2e-4) and the densification
    statistics dL_dmean2d x, y, |.| (2e-4 x max)."""
    rng = np.random.default_rng(0)
    cam, cloud = torch_cases.setup(rng, n=64)
    pre_t, pre = _oracle_pre(cloud, cam)
    bg = np.array([0.15, 0.1, 0.05], np.float32)
    oracle_fwd = rasterize_ref.render_forward(pre, cam, bg)
    dL = rng.normal(size=(9, cam.height, cam.width)).astype(np.float32)
    dL[7] = 0.0  # alpha channel has no grad path in the reference
    oracle_bwd = rasterize_ref.render_backward(pre, cam, bg, oracle_fwd, dL)

    inp = TR.prepare(*_tensors(cloud), cam, torch.from_numpy(bg), chunk=32,
                     **CAPS)
    # the composed route's intermediates, as leaves: (M, b), rgb, opacity
    leaves = [pre_t.v2g_mb.detach().requires_grad_(),
              pre_t.rgb.detach().requires_grad_(),
              pre_t.opa_coef.detach().requires_grad_(),
              inp.stats.detach().requires_grad_()]
    feat = TR._all_features(*leaves[:3])
    assert torch.equal(feat, inp.feat)
    out, _ = TR.composite_from_features(feat, inp.extra, inp.binning,
                                        inp.statics, inp.bg, stats=leaves[3])
    img = TR._tiles_to_image(out, inp.statics)
    dmb, drgb, dopa, dm2d = [g.numpy() for g in torch.autograd.grad(
        torch.sum(img * torch.from_numpy(dL)), leaves)]

    _, vjp_fn = torch.func.vjp(_pack, pre_t.v2g_mb)
    (dmb_expected,) = vjp_fn(torch.from_numpy(oracle_bwd["dL_dv2g"]).float())
    dmb_expected = dmb_expected.numpy()
    scale = np.abs(dmb_expected).max() + 1e-6
    np.testing.assert_allclose(dmb, dmb_expected, atol=2e-4 * scale)
    np.testing.assert_allclose(drgb, oracle_bwd["dL_drgb"], atol=1e-4)
    np.testing.assert_allclose(dopa, oracle_bwd["dL_dopa_coef"], atol=2e-4)
    sc2 = np.abs(oracle_bwd["dL_dmean2d"]).max() + 1e-6
    np.testing.assert_allclose(dm2d, oracle_bwd["dL_dmean2d"],
                               atol=2e-4 * sc2)
    assert (np.abs(oracle_bwd["dL_dmean2d"]) > 1e-2 * sc2).sum() > 20


@pytest.mark.parametrize("col", [0, 1, 2])
def test_stats_half_pixel_offset_is_visible(col):
    """The check above tells the two conventions apart: the oracle measures
    the offset from pixf - 0.5 (rasterize_ref.py, as the XLA backward);
    measured from the pixel centre instead (the JAX Pallas backward,
    pallas_raster.py:219-220), which is the oracle with means2d moved by
    -0.5 in its backward alone, each column of dL_dmean2d moves beyond the
    tolerance above."""
    rng = np.random.default_rng(0)
    cam, cloud = torch_cases.setup(rng, n=64)
    _, pre = _oracle_pre(cloud, cam)
    bg = np.array([0.15, 0.1, 0.05], np.float32)
    fwd = rasterize_ref.render_forward(pre, cam, bg)
    dL = rng.normal(size=(9, cam.height, cam.width)).astype(np.float32)
    dL[7] = 0.0
    ref = rasterize_ref.render_backward(pre, cam, bg, fwd, dL)["dL_dmean2d"]
    shifted = pre._replace(means2d=pre.means2d - 0.5)
    moved = rasterize_ref.render_backward(shifted, cam, bg, fwd,
                                          dL)["dL_dmean2d"]
    sc2 = np.abs(ref).max() + 1e-6
    assert np.abs(moved[:, col] - ref[:, col]).max() > 2e-4 * sc2
