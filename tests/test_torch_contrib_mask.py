"""The decision mask of the port's compositing (one bit per slab slot and
pixel, packed as rasterize.mask_shape: bit s % 32 of word [s // 32, pixel]
is slot s's t > 0.2 and alpha >= 1/255 inside its tile's window), on the
CPU:

  * rasterize._contrib_mask_impl, the plain version of the decision pass
    csrc/gof_decide.cu, against the JAX package's own decisions -- the
    (t > NEAR) & (alpha_raw >= ALPHA_EPS) & valid of its chunk evaluation
    on the same numpy-seeded inputs, packed into the same layout -- word for
    word on every small case of tests/torch_cases.py;
  * the plain compositing forward and backward given the packed mask equal
    the same calls without it, exactly;
  * a pack/unpack round trip of the layout on a synthetic slab.

The decision kernel itself is held against the plain mask on the card in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.core import gaussians as JG
from f3d_gaus_tpu.ops import binning as JB
from f3d_gaus_tpu.ops import rasterize as JR
from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {name: (cam, cloud, bg, kw)
         for name, cam, cloud, bg, kw in torch_cases.small_cases()}


def _prepared(case):
    cam, cloud, bg, kw = CASES[case]
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)
    feat = inp.feat.detach()
    b = inp.binning
    return inp, feat, (b.point_list, b.tile_start, b.tile_count)


def _jax_decisions(case):
    """The JAX package's decisions over each tile's whole window, from its
    own preprocess, binning and chunk evaluation: (T, PIX, max_per_tile)
    bool, with its binning."""
    cam, cloud, _, kw = CASES[case]
    mpt = kw["max_per_tile"]
    lanes = 256 if mpt % 256 == 0 else 128
    pair_cap = -(-kw["pair_cap"] // lanes) * lanes
    pre = JG.preprocess(*[jnp.asarray(a) for a in cloud], 1, cam)
    bng = JB.bin_gaussians(pre.means2d, pre.radii, pre.depths, cam.width,
                           cam.height, pair_cap, max_per_tile=mpt,
                           align=lanes)
    s = JR.RasterStatics(width=cam.width, height=cam.height,
                         grid_x=bng.grid[0], grid_y=bng.grid[1],
                         focal_x=float(cam.focal_x),
                         focal_y=float(cam.focal_y), max_per_tile=mpt,
                         chunk=mpt, lanes=lanes)
    # the composited opacity is pre.opa_coef's value (JR.render: opa_in)
    feat = JR._expand_features(pre.v2g_mb, pre.rgb, pre.opa_coef)
    _, valid, wfeat, _ = JR._gather_windows(bng.point_list, bng.pair_valid,
                                            bng.tile_start, bng.tile_count,
                                            s, feat)
    u, v = JR._tile_rays(s)
    ct = JR._chunk_eval(wfeat, u, v)
    vc = ((ct["t"] > JR.NEAR_PLANE) & (ct["alpha_raw"] >= JR.ALPHA_EPS)
          & valid[:, None, :])
    return np.asarray(vc), bng


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_mask_matches_jax(case):
    inp, feat, slab = _prepared(case)
    got = TR._contrib_mask_impl(feat, *slab, inp.statics)
    assert got.shape == TR.mask_shape(slab[0]) and got.dtype == torch.int32
    vc, bng = _jax_decisions(case)
    np.testing.assert_array_equal(slab[0].numpy(), np.asarray(bng.point_list))
    np.testing.assert_array_equal(slab[1].numpy(), np.asarray(bng.tile_start))
    mpt = CASES[case][3]["max_per_tile"]
    want = TR._pack_window_bits(lambda ci: torch.from_numpy(vc.copy()), 1,
                                mpt, slab[1], slab[2], inp.statics,
                                got.shape)
    assert torch.equal(got, want)
    # and read back at every window position
    n = torch.clamp_max(slab[2], mpt)
    inside = torch.arange(mpt)[None, None, :] < n[:, None, None]
    back = TR._unpack_window_bits(got, slab[1], 0, mpt) & inside
    np.testing.assert_array_equal(back.numpy(), vc)


def test_cases_cover_the_mask_edges():
    """The cases hold windows that are no multiple of 32 or 128, tiles with
    no pairs, tiles whose count runs past the window, and a mask word
    with bits set past the first."""
    mpts = {kw["max_per_tile"] for *_, kw in CASES.values()}
    assert any(m % 32 for m in mpts) and any(m % 128 for m in mpts)
    empty = over = high_bits = False
    for case in CASES:
        inp, feat, slab = _prepared(case)
        empty |= bool((slab[2] == 0).any())
        over |= bool((slab[2] > inp.statics.max_per_tile).any())
        mask = TR._contrib_mask_impl(feat, *slab, inp.statics)
        high_bits |= bool((mask < 0).any())       # bit 31 set
    assert empty and over and high_bits


@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_fwd_with_mask_equals_without(case):
    inp, feat, slab = _prepared(case)
    mask = TR._contrib_mask_impl(feat, *slab, inp.statics)
    o1, a1 = TR._composite_fwd_impl(feat, *slab, inp.bg, inp.statics)
    o2, a2 = TR._composite_fwd_impl(feat, *slab, inp.bg, inp.statics,
                                    mask=mask)
    assert torch.equal(o1, o2)
    for x, y in zip(a1, a2):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", sorted(set(CASES)
                                        - set(torch_cases.DEEP_CASES)))
def test_composite_bwd_with_mask_equals_without(case):
    inp, feat, slab = _prepared(case)
    s = inp.statics
    extra = inp.extra.detach()
    mask = TR._contrib_mask_impl(feat, *slab, s)
    _, aux = TR._composite_fwd_impl(feat, *slab, inp.bg, s)
    g = np.random.default_rng(0).normal(size=(s.grid_x * s.grid_y, TR.PIX, 9))
    g[..., 7] = 0.0
    g = torch.from_numpy(g.astype(np.float32))
    d1 = TR._composite_bwd_impl(feat, extra, *slab, inp.bg, aux, g, s)
    d2 = TR._composite_bwd_impl(feat, extra, *slab, inp.bg, aux, g, s,
                                mask=mask)
    for x, y in zip(d1, d2):
        assert torch.equal(x, y)


@pytest.mark.parametrize("mpt,align", [(100, 128), (300, 128), (512, 256)])
def test_pack_unpack_round_trip(mpt, align):
    """Random bits over the windows of a synthetic aligned slab (empty
    tiles, tiles past the window) pack into words that hold every window
    bit at its slot, nothing else, and unpack to the same bits."""
    rng = np.random.default_rng(mpt)
    T, C = 9, 50
    count = torch.from_numpy(rng.integers(0, 2 * mpt, size=T)).int()
    count[2] = 0
    count[-1] = 0
    keep = torch.clamp_max(count, mpt)
    csz = (keep + align - 1) // align * align
    start = (torch.cumsum(csz, 0) - csz).int()
    slab = torch.zeros(int(csz.sum()) + align, dtype=torch.int32)
    s = TR.RasterStatics(48, 48, 3, 3, 50.0, 50.0, mpt, C, align)
    n_chunks = -(-mpt // C)
    K = n_chunks * C
    inside = torch.arange(K)[None, None, :] < keep[:, None, None]
    bits = torch.from_numpy(rng.random((T, TR.PIX, K)) < 0.5) & inside
    mask = TR._pack_window_bits(lambda ci: bits[..., ci * C:(ci + 1) * C],
                                n_chunks, C, start, count, s,
                                TR.mask_shape(slab))
    for ci in range(n_chunks):
        back = TR._unpack_window_bits(mask, start, ci * C, C)
        sl = slice(ci * C, (ci + 1) * C)
        assert torch.equal(back & inside[..., sl], bits[..., sl])
    # slot by slot: a bit is set only at a window slot of its tile
    slots = torch.arange(mask.shape[0] * 32)
    flat = ((mask[slots // 32] >> (slots % 32)[:, None].int()) & 1).bool()
    tile = torch.searchsorted(start, slots, right=True) - 1
    j = slots - start.long()[tile]
    assert not flat[j >= keep.long()[tile]].any()
    want = bits[tile[j < keep.long()[tile]], :, j[j < keep.long()[tile]]]
    assert torch.equal(flat[j < keep.long()[tile]], want)
    used = TR.mask_words_used(start, count, s)
    assert used * 32 == int(start[-1]) + -(-int(keep[-1]) // 128) * 128
    assert not mask[used:].any()
