"""The CUDA compositing kernels (the decision pass csrc/gof_decide.cu,
csrc/raster_fwd.cu, csrc/raster_bwd.cu) against their plain PyTorch
versions on the card, and one feed-forward training step there.  Needs a
CUDA device and nvcc; skips elsewhere.
Imports no JAX, so on the card's machine it runs without the JAX
package's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.train import feedforward as TF
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda
CASE_NAMES = [c[0] for c in torch_cases.small_cases()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _render(cam, cloud, bg, device, **kw):
    return TR.render(*[torch.from_numpy(a).to(device) for a in cloud], cam,
                     torch.from_numpy(bg).to(device), **kw)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain(cuda, case):
    name, cam, cloud, bg, kw = next(c for c in torch_cases.small_cases()
                                    if c[0] == case)
    before = cuda_raster.launches
    k = _render(cam, cloud, bg, cuda, **kw)
    torch.cuda.synchronize()
    assert cuda_raster.launches == before + 1
    p = _render(cam, cloud, bg, cuda, backend="torch", **kw)
    claims = torch_cases.exercised(name, k["binning"].tile_count, k["aux"],
                                   kw["max_per_tile"])
    assert all(claims.values()), claims
    torch.testing.assert_close(k["out9"], p["out9"], atol=1e-4, rtol=0)
    torch.testing.assert_close(k["aux"].final_T, p["aux"].final_T,
                               atol=1e-4, rtol=0)
    assert torch.equal(k["aux"].last_pos, p["aux"].last_pos)
    assert torch.equal(k["aux"].max_pos, p["aux"].max_pos)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_decide_kernel_matches_plain_mask(cuda, case):
    """The decision pass's words equal the plain mask's, word for word, and
    the compositing pass given that mask repeats composite_fwd's result."""
    name, cam, cloud, bg, kw = next(c for c in torch_cases.small_cases()
                                    if c[0] == case)
    inp = TR.prepare(*[torch.from_numpy(a).to(cuda) for a in cloud], cam,
                     torch.from_numpy(bg).to(cuda), **kw)
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    b, s = inp.binning, inp.statics
    slab = (b.point_list, b.tile_start, b.tile_count)
    before = cuda_raster.launches_decide
    k = cuda_raster.decide(feat, *slab, s)
    torch.cuda.synchronize()
    assert cuda_raster.launches_decide == before + 1
    p = TR._contrib_mask_impl(feat, *slab, s)
    used = TR.mask_words_used(b.tile_start, b.tile_count, s)
    assert used > 0 or case == "behind_camera"
    assert torch.equal(k[:used], p[:used])
    o1, a1 = cuda_raster.composite_fwd(feat, *slab, inp.bg, s)
    o2, a2 = cuda_raster.composite_fwd(feat, *slab, inp.bg, s, mask=k)
    assert torch.equal(o1, o2) and all(map(torch.equal, a1, a2))


def test_kernel_matches_plain_flagship_slice(cuda):
    """bench.py's anchor on a 4096-Gaussian slice of the 256^2 cloud."""
    cam, cloud = torch_cases.bench_scene(np.random.default_rng(0))
    cloud = tuple(a[:4096] for a in cloud)
    caps = TR.plan_caps(*[torch.from_numpy(a).to(cuda) for a in cloud[:4]], cam)
    bg = np.zeros(3, np.float32)
    k = _render(cam, cloud, bg, cuda, **caps)["out9"]
    p = _render(cam, cloud, bg, cuda, backend="torch", **caps)["out9"]
    err, frac = torch_cases.bench_parity(k.cpu().numpy(), p.cpu().numpy())
    assert err < 2e-2 and frac < 1e-3, (err, frac)


def test_wrapper_rejects_bad_inputs(cuda):
    s = TR.RasterStatics(32, 32, 2, 2, 100.0, 100.0, 128, 32)
    allf = torch.zeros((5, TR.NFEAT), device=cuda)
    pl = torch.full((256,), 4, dtype=torch.int32, device=cuda)
    ts = torch.zeros(4, dtype=torch.int32, device=cuda)
    bg = torch.zeros(3, device=cuda)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(allf, pl.long(), ts, ts, bg, s)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(allf, pl, ts[:3], ts, bg, s)
    with pytest.raises(ValueError):
        cuda_raster.composite_fwd(allf.cpu(), pl, ts, ts, bg, s)
    with pytest.raises(ValueError):   # the mask is (256 / 32, 256) int32
        cuda_raster.composite_fwd(allf, pl, ts, ts, bg, s, mask=torch.zeros(
            (8, 256), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        cuda_raster.decide(allf, pl[:200], ts, ts, s)
    out, aux = cuda_raster.composite_fwd(allf, pl, ts, ts, bg, s)
    torch.cuda.synchronize()
    assert (aux.final_T == 1).all() and (aux.last_pos == -1).all()


def _bwd_inputs(case, device):
    """A small case prepared on `device`, the forward kernel's residuals
    and a seeded out9 cotangent with the alpha channel zeroed."""
    name, cam, cloud, bg, kw = next(c for c in torch_cases.small_cases()
                                    if c[0] == case)
    inp = TR.prepare(*[torch.from_numpy(a).to(device) for a in cloud], cam,
                     torch.from_numpy(bg).to(device), **kw)
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    extra = torch.cat([inp.pre.conic, inp.pre.means2d], 1).detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    out, aux = cuda_raster.composite_fwd(feat, *slab, inp.statics)
    g = np.random.default_rng(0).normal(size=tuple(out.shape)).astype(np.float32)
    g[..., 7] = 0.0
    return feat, extra, slab, aux, torch.from_numpy(g).to(device), inp.statics


@pytest.mark.parametrize("case", CASE_NAMES)
def test_bwd_kernel_matches_plain(cuda, case):
    """d_feat and d_stats within 5e-3 x max |g| per column (atomics
    reorder the sums)."""
    feat, extra, slab, aux, g, s = _bwd_inputs(case, cuda)
    before = cuda_raster.launches_bwd
    k = cuda_raster.composite_bwd(feat, extra, *slab, aux, g, s)
    torch.cuda.synchronize()
    assert cuda_raster.launches_bwd == before + 1
    p = TR._composite_bwd_impl(feat, extra, *slab, aux, g, s)
    for got, ref in zip(k, p):
        assert torch.isfinite(got).all()
        tol = 5e-3 * ref.abs().amax(0, keepdim=True)
        assert ((got - ref).abs() <= tol).all()


def test_bwd_wrapper_rejects_bad_inputs(cuda):
    feat, extra, slab, aux, g, s = _bwd_inputs("cloud96_mpt128", cuda)
    with pytest.raises(ValueError):
        cuda_raster.composite_bwd(feat, extra[:, :3].contiguous(), *slab,
                                  aux, g, s)
    with pytest.raises(ValueError):
        cuda_raster.composite_bwd(feat, extra, *slab, aux, g[..., :8], s)
    with pytest.raises(ValueError):
        cuda_raster.composite_bwd(feat, extra, *slab,
                                  aux._replace(last_pos=aux.last_pos.long()),
                                  g, s)
    with pytest.raises(ValueError):
        cuda_raster.composite_bwd(feat, extra.cpu(), *slab, aux, g, s)
    with pytest.raises(ValueError):
        cuda_raster.composite_bwd(feat, extra, *slab, aux,
                                  g.transpose(0, 1).contiguous().transpose(0, 1),
                                  s)


def test_train_step_on_the_card(cuda):
    """One feed-forward step at the tiny config of tests/test_torch_train.py:
    every render goes through both kernels (3 per image)."""
    cfg = TCfg.PipelineConfig(resolution=32, base_dim=32, num_blocks=1,
                              attn_resolutions=(8,), model_channels=32,
                              pair_cap=1 << 14, max_per_tile=2048, chunk=128)
    state = TF.init_state(torch.Generator().manual_seed(0), cfg, lr=1e-4)
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    rng = np.random.default_rng(0)
    batch = {"images": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(6.8, 8.5, size=(2, 32, 32)).astype(np.float32)}
    f0, b0 = cuda_raster.launches, cuda_raster.launches_bwd
    d0 = cuda_raster.launches_decide
    loss, aux = TF.train_step(state, cfg, batch, pack)
    torch.cuda.synchronize()
    assert np.isfinite(loss.item()) and state.step == 1
    assert cuda_raster.launches - f0 == 6 and cuda_raster.launches_bwd - b0 == 6
    assert cuda_raster.launches_decide - d0 == 12
    for p in state.model.parameters():
        assert torch.isfinite(p.grad).all()
