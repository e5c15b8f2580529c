"""The CUDA compositing kernel (csrc/raster_fwd.cu) against its plain
PyTorch version on the card.  Needs a CUDA device and nvcc; skips
elsewhere.  Imports no JAX, so on the card's machine it runs without the
JAX package's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest
import torch

from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import rasterize as TR
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
    out, aux = cuda_raster.composite_fwd(allf, pl, ts, ts, bg, s)
    torch.cuda.synchronize()
    assert (aux.final_T == 1).all() and (aux.last_pos == -1).all()
