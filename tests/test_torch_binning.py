"""f3d_gaus_torch.ops.binning against f3d_gaus_tpu.ops.binning: point_list,
tile_start, tile_count, num_pairs and overflow integer-equal on the cases
of tests/test_rasterize_parity.py:TestBinningParity, including the
2560-px-wide frame and the 2048 px x 2^23 pair-cap (packed-rank) branch."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from f3d_gaus_tpu.core import gaussians as JG
from f3d_gaus_tpu.ops import binning as JB
from f3d_gaus_tpu.ops import rasterize_ref
from f3d_gaus_torch.ops import binning as TB
from tests.test_rasterize_parity import _setup

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

FIELDS = ("point_list", "pair_valid", "tile_start", "tile_count",
          "num_pairs", "overflow")


def _pre(cam, cloud):
    return JG.preprocess(*[jnp.asarray(a) for a in cloud], 1, cam)


def _both(pre, width, height, pair_cap, radii=None, **kw):
    radii = np.asarray(pre.radii) if radii is None else radii
    bj = JB.bin_gaussians(pre.means2d, jnp.asarray(radii), pre.depths,
                          width, height, pair_cap, **kw)
    bt = TB.bin_gaussians(torch.from_numpy(np.array(pre.means2d)),
                          torch.from_numpy(np.array(radii)),
                          torch.from_numpy(np.array(pre.depths)),
                          width, height, pair_cap, **kw)
    return bj, bt


def _assert_equal(bj, bt):
    assert bt.grid == bj.grid
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)), err_msg=f)


# (n, width, height, pair_cap, bin kwargs): the TestBinningParity shapes
# plus the render path's window truncation and 256-lane alignment
CASES = {
    "tile_lists": (96, 32, 32, 1 << 14, {}),
    "wide_frame_unpacked": (48, 2560, 32, 1 << 14, {}),
    "packed_rank_2048_2e23": (32, 2048, 32, 1 << 23, {}),
    "window_truncation": (96, 32, 32, 1 << 14, dict(max_per_tile=4)),
    "align256": (400, 64, 48, 1 << 12, dict(max_per_tile=256, align=256)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_matches_jax(case):
    n, w, h, pc, kw = CASES[case]
    cam, cloud = _setup(np.random.default_rng(7), n=n, width=w, height=h)
    pre = _pre(cam, cloud)
    bj, bt = _both(pre, w, h, pc, **kw)
    _assert_equal(bj, bt)
    assert not bool(bt.overflow)
    if not kw:
        # and both equal the sequential oracle's depth-sorted tile lists
        lists = rasterize_ref.build_tile_lists(
            np.asarray(pre.means2d), np.asarray(pre.radii),
            np.asarray(pre.depths), np.asarray(pre.valid), w, h)
        pl, st = bt.point_list.numpy(), bt.tile_start.numpy()
        cnt = bt.tile_count.numpy()
        for t, ids in enumerate(lists):
            np.testing.assert_array_equal(pl[st[t]:st[t] + cnt[t]], ids)


def test_culled_gaussian_between_visible_ones():
    cam, cloud = _setup(np.random.default_rng(3), n=5)
    pre = _pre(cam, cloud)
    radii = np.asarray(pre.radii).copy()
    assert (radii > 0).all()
    radii[1] = 0
    radii[3] = 0
    bj, bt = _both(pre, 32, 32, 1 << 12, radii=radii)
    _assert_equal(bj, bt)
    seen = set(bt.point_list.numpy().tolist())
    assert 1 not in seen and 3 not in seen and {0, 2, 4} <= seen


def test_pair_count_and_overflow():
    cam, cloud = _setup(np.random.default_rng(4))
    pre = _pre(cam, cloud)
    nj = int(JB.count_pairs(pre.means2d, pre.radii, 32, 32))
    nt = int(TB.count_pairs(torch.from_numpy(np.array(pre.means2d)),
                            torch.from_numpy(np.array(pre.radii)), 32, 32))
    assert nt == nj > 0
    bj, bt = _both(pre, 32, 32, max(nj - 5, 1))
    assert bool(bt.overflow)
    _assert_equal(bj, bt)
    assert TB.suggest_pair_cap(nj) == JB.suggest_pair_cap(nj)
    assert TB.slab_cap(1 << 14, 2560, 32) == JB.slab_cap(1 << 14, 2560, 32)
