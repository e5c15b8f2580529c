"""The port's tile-sharded renderer (f3d_gaus_torch/parallel/sharded.py)
on 2 gloo processes on the CPU against the single render, mirroring
tests/test_sharded.py: out9 (channels 0-5, 7, 8 at 1e-4; the median depth
at 5e-3) and the five inputs' gradients (5e-3 x max |g|) on every rank,
with and without Gaussian sharding; and band_render run for each rank in
one process, which is what the ranks compute."""
import numpy as np
import pytest
import torch

import torch_dist
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.parallel import sharded

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _single(case):
    cam, cloud, w9 = torch_dist.sharded_case(case)
    return torch_dist.render_and_grad(lambda *t: TR.render(
        *t, cam, torch.from_numpy(torch_dist.SHARDED_BG),
        **torch_dist.SHARDED_KW), cloud, w9)


def _assert_frame(got, want):
    for c in list(range(6)) + [7, 8]:
        np.testing.assert_allclose(got[c], want[c], atol=1e-4,
                                   err_msg=f"channel {c}")
    np.testing.assert_allclose(got[6], want[6], atol=5e-3)


def _assert_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, atol=5e-3 * max(np.abs(b).max(),
                                                         1e-6),
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("case,gaussian_shard", [
    ("64x64", False), ("64x64", True), ("64x128", True)])
def test_tile_sharded_matches_single(tmp_path, case, gaussian_shard):
    want9, want_over, want_g = _single(case)
    ranks = torch_dist.run_ranks(torch_dist.sharded_render_rank, 2,
                                 tmp_path, case, gaussian_shard)
    for out9, overflow, grads in ranks:
        assert not overflow and not want_over
        assert out9.shape == want9.shape
        _assert_frame(out9, want9)
        _assert_grads(grads, want_g)


def test_band_render_per_rank_assembles_the_frame():
    """band_render(d, 4, ...) for d = 0..3 in one process (no group): the
    bands stacked are the frame, the summed gradients the frame's."""
    case = "64x128"
    want9, _, want_g = _single(case)
    cam, cloud, w9 = torch_dist.sharded_case(case)
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    bands = []
    for d in range(4):
        band, overflow = sharded.band_render(
            d, 4, *ts, cam, torch.from_numpy(torch_dist.SHARDED_BG),
            **torch_dist.SHARDED_KW)
        assert not bool(overflow) and band.shape == (9, 32, 64)
        bands.append(band)
    frame = torch.cat(bands, 1)
    (frame * torch.from_numpy(w9)).sum().backward()
    _assert_frame(frame.detach().numpy(), want9)
    _assert_grads([t.grad.numpy() for t in ts], want_g)


def test_tile_rows_must_divide():
    cam, cloud, _ = torch_dist.sharded_case("64x64")
    with pytest.raises(ValueError, match="not divisible"):
        sharded.band_render(0, 3, *[torch.from_numpy(a) for a in cloud],
                            cam, **torch_dist.SHARDED_KW)
