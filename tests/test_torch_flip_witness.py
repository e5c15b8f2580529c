"""chip_smoke.py's witness for the compositing backward's rows that lie
outside the gradient tolerance (flip_margins / held_bwd), on the CPU with
the plain versions standing in for the kernels: it accepts agreement,
refuses a classification threshold moved by 0.3 %, and finds the pair
whose alpha is put on 1/255.  Likewise its check of the decision pass's
mask (compare_mask): a bit that differs at that pair is witnessed, one at
a pair far from every threshold, or outside the windows, is refused.  And
its check of the compositing passes given the decision mask
(compare_given_mask), where only the clamp of num may witness a row; and
its check against the plain versions run in f64 (versus_f64) with the
per-pixel f32 error bound it witnesses large errors by
(alpha_error_bound)."""
import os
import sys

import numpy as np
import pytest
import torch

from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as S  # noqa: E402

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {name: (cam, cloud, bg, kw)
         for name, cam, cloud, bg, kw in torch_cases.small_cases()}


def _inputs(opa=None):
    cam, cloud, bg, kw = CASES["cloud96_mpt128"]
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)
    feat = inp.feat.detach()
    if opa is not None:
        feat = feat.clone()
        feat[:, TR.ROW_OPA] = opa
        inp = inp._replace(feat=feat)
    extra = inp.extra.detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    out, aux = TR._composite_fwd_impl(feat, *slab, inp.statics)
    g = np.random.default_rng(0).normal(size=tuple(out.shape))
    g[..., 7] = 0.0
    return inp, (feat, extra, *slab, aux, torch.from_numpy(g.astype(np.float32)),
                 inp.statics)


def test_witness_accepts_agreement_and_refuses_a_shifted_threshold(monkeypatch):
    inp, args = _inputs()
    plain = TR._composite_bwd_impl(*args)
    res = S.held_bwd(inp, args, plain, plain, S.TRAIN_ROWS)
    assert res["rows_within_tol"] == 1.0 and res["rows_outside_tol"] == 0
    # a "kernel" whose alpha threshold is off by 0.3 %: the rows it moves
    # hold no pair whose decision f32 rounding could flip
    with monkeypatch.context() as m:
        m.setattr(TR, "ALPHA_EPS", TR.ALPHA_EPS * (1 + 3e-3))
        shifted = TR._composite_bwd_impl(*args)
    with pytest.raises(RuntimeError, match="unwitnessed_rows': [1-9]"):
        S.held_bwd(inp, args, shifted, plain, 0.0)


def _pair_at_threshold():
    """A contributing pair with a later contributor in its pixel (so it
    stays walked), its Gaussian's opacity set so that alpha there is 1/255:
    the inputs, the pair's (tile, pixel, window position) and Gaussian."""
    inp, args = _inputs()
    aux, s, b = args[6], inp.statics, inp.binning
    gids, valid, wfeat = TR._gather_windows(args[0], b.point_list,
                                            b.tile_start, b.tile_count,
                                            s.max_per_tile)
    u, v = TR._tile_rays(s, "cpu")
    ev = TR._chunk_eval(wfeat.double(), u.double(), v.double())
    pos = torch.arange(s.max_per_tile)
    pair = (valid[:, None] & (ev["t"] > TR.NEAR_PLANE)
            & (ev["alpha_raw"] >= TR.ALPHA_EPS)
            & (pos < aux.last_pos[..., None])).nonzero()
    ti, pi, ki = pair[0].tolist()
    gid = int(gids[ti, ki])
    opa = inp.feat[:, TR.ROW_OPA].clone()
    opa[gid] = float(np.float32(TR.ALPHA_EPS)) / float(ev["G"][ti, pi, ki])
    inp2, args2 = _inputs(opa)
    return inp2, args2, (ti, pi, ki), gid, pair


def test_flip_margins_find_a_pair_at_the_alpha_threshold():
    inp, args = _inputs()
    margin, walked = S.flip_margins(inp, args[6])
    assert walked.any() and not (margin[:, walked] <= 1.0).any()
    inp2, args2, _, gid, _ = _pair_at_threshold()
    margin2, walked2 = S.flip_margins(inp2, args2[6])
    assert walked2[gid] and margin2[0, gid] <= 1.0


def _flipped(mask, tile_start, ti, pi, ki):
    """The mask with the bit of window position ki of tile ti, pixel pi,
    flipped."""
    slot = int(tile_start[ti]) + ki
    word = int(mask[slot // 32, pi]) ^ (1 << (slot % 32))
    out = mask.clone()
    out[slot // 32, pi] = word - (1 << 32) if word >= 1 << 31 else word
    return out


@pytest.mark.parametrize("where", ["at_threshold", "far", "outside"])
def test_mask_witness(monkeypatch, where):
    """compare_mask takes a differing bit at the pair put on alpha = 1/255,
    and refuses one at a contributing pair far from every threshold or in
    the padding past a tile's window."""
    inp, args, (ti, pi, ki), gid, pair = _pair_at_threshold()
    s, b = inp.statics, inp.binning
    if where == "far":
        ti, pi, ki = next(
            p for p in pair.tolist()
            if int(b.point_list[b.tile_start[p[0]] + p[2]]) != gid)
    elif where == "outside":
        ti = int(torch.argmax((b.tile_count % 32 != 0).int()))
        ki = int(b.tile_count[ti])   # the slot after the window, same word
    plain = TR._contrib_mask_impl(args[0], *args[2:5], s)
    monkeypatch.setattr(cuda_raster, "decide", lambda *a: _flipped(
        plain, b.tile_start, ti, pi, ki))
    if where == "at_threshold":
        res = S.compare_mask(inp, exact=False)
        assert res["bits_differ"] == 1 and res["can_flip_alpha"] == 1
        with pytest.raises(RuntimeError, match="bits_differ': 1"):
            S.compare_mask(inp)
    else:
        why = {"far": "unwitnessed_bits': 1",
               "outside": "bits_differ_in_windows': 0"}[where]
        with pytest.raises(RuntimeError, match=why):
            S.compare_mask(inp, exact=False)


@pytest.mark.parametrize("where", ["agree", "forward", "forward_tile",
                                   "backward"])
def test_given_mask_check(monkeypatch, where):
    """compare_given_mask, with the plain versions standing in for the
    kernels: it accepts them against themselves; refuses a forward 3e-2
    off at one pixel, or 2e-3 off on a whole tile (a quarter of the
    pixels); and refuses a backward row moved at the Gaussian put on
    alpha = 1/255, which held_bwd with every witness accepts: given the
    mask, only the clamp of num is left to flip."""
    inp, args, _, gid, _ = _pair_at_threshold()
    fwd, bwd = TR._composite_fwd_impl, TR._composite_bwd_impl

    def fwd_off(*a, **kw):
        out, aux = fwd(*a, **kw)
        out = out.clone()
        if where == "forward":
            out[0, 0, 0] += 3e-2
        else:
            out[0, :, 1] += 2e-3
        return out, aux

    def bwd_off(*a, **kw):
        d_feat, d_stats = bwd(*a, **kw)
        d_feat = d_feat.clone()
        d_feat[gid] *= 2.0
        return d_feat, d_stats

    monkeypatch.setattr(cuda_raster, "decide", TR._contrib_mask_impl)
    monkeypatch.setattr(cuda_raster, "composite_fwd",
                        fwd_off if where.startswith("forward") else fwd)
    monkeypatch.setattr(cuda_raster, "composite_bwd",
                        bwd_off if where == "backward" else bwd)
    if where == "agree":
        res = S.compare_given_mask(inp, 0, S.TRAIN_ROWS)
        assert res["fwd"]["pos_differ"] == 0 and res["fwd"]["max_abs_err"] == 0
        assert res["bwd"]["rows_within_tol"] == 1.0
    elif where.startswith("forward"):
        why = {"forward": r"'max_abs_err': 0\.0[23]",
               "forward_tile": "'0.001': 0.25"}[where]
        with pytest.raises(RuntimeError, match=why):
            S.compare_given_mask(inp, 0, S.TRAIN_ROWS)
    else:
        margin, _ = S.flip_margins(inp, args[6])
        assert margin[0, gid] <= 1.0 < margin[2, gid]
        res = S.held_bwd(inp, args, bwd_off(*args), bwd(*args), 0.0)
        assert res["rows_outside_tol"] == 1 and res["unwitnessed_rows"] == 0
        with pytest.raises(RuntimeError, match="unwitnessed_rows': 1"):
            S.compare_given_mask(inp, 0, 0.0)


@pytest.mark.parametrize("where", ["agree", "forward", "backward"])
def test_versus_f64_check(monkeypatch, where):
    """versus_f64, with the plain versions standing in for the kernels:
    it accepts them, and refuses a forward 3e-2 off at one pixel of
    well-conditioned Gaussians (beyond that pixel's f32 error bound), or a
    backward with one row in a hundred doubled."""
    inp, *_ = _inputs()
    fwd, bwd = TR._composite_fwd_impl, TR._composite_bwd_impl

    def fwd_off(*a, **kw):
        out, aux = fwd(*a, **kw)
        out = out.clone()
        out[1, 7, 0] += 3e-2
        return out, aux

    def bwd_off(*a, **kw):
        d_feat, d_stats = bwd(*a, **kw)
        d_feat = d_feat.clone()
        d_feat[::100] *= 2.0
        return d_feat, d_stats

    monkeypatch.setattr(cuda_raster, "decide", TR._contrib_mask_impl)
    monkeypatch.setattr(cuda_raster, "composite_fwd",
                        fwd_off if where == "forward" else fwd)
    monkeypatch.setattr(cuda_raster, "composite_bwd",
                        bwd_off if where == "backward" else bwd)
    if where == "agree":
        res = S.versus_f64(inp, 0)
        assert res["fwd"]["kernel_vs_plain"]["anchor_err"] == 0
        assert res["fwd"]["kernel_vs_f64"]["anchor_err"] < 1e-5
        assert res["bwd"]["kernel_vs_f64"]["rows_within_tol"] == 1.0
        assert res["bwd"]["kernel_vs_plain"]["rows_outside_tol"] == 0
    else:
        why = {"forward": r"'kernel_vs_f64': \{'anchor_err': 0\.0[23].*"
                          r"'unwitnessed': 1\}",
               "backward": r"'rows_within_tol': 0\.98"}[where]
        with pytest.raises(RuntimeError, match=why):
            S.versus_f64(inp, 0)


@pytest.mark.parametrize("thin", [1e-2, 1e-4, 3e-5])
def test_alpha_error_bound_covers_f32_rounding(thin):
    """alpha_error_bound covers how far the plain compositing forward in
    f32 lies from the same forward in f64 (same inputs, same mask) on
    every colour, normal and alpha value, for Gaussians whose third scale
    shrinks to `thin` (the ill-conditioned case of the fitted per-scene
    scene), and grows as they thin."""
    rng = np.random.default_rng(0)
    cam = torch_cases.orbit_camera(32, 32)
    cloud = list(torch_cases.make_gaussian_cloud(
        rng, 200, spread=0.3, scale_range=(0.03, 0.1)))
    cloud[1][:, 2] = thin
    cloud[3][:] = rng.uniform(0.5, 0.99, size=cloud[3].shape)
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.tensor([0.1, 0.2, 0.3]), device="cpu",
                     pair_cap=1 << 14, max_per_tile=256, chunk=32)
    s, b = inp.statics, inp.binning
    feat = inp.feat.detach()
    slab = (b.point_list, b.tile_start, b.tile_count)
    mask = TR._contrib_mask_impl(feat, *slab, s)
    po, pa = TR._composite_fwd_impl(feat, *slab, inp.bg, s, mask=mask)
    qo, _ = TR._composite_fwd_impl(feat.double(), *slab, inp.bg.double(), s,
                                   mask=mask)
    bound = S.alpha_error_bound(inp, mask, pa)
    err = (po.double() - qo)[..., [0, 1, 2, 3, 4, 5, 7]].abs()
    assert err.max() > 1e-5
    assert (err <= bound[..., None] + 1e-5).all()
    assert bound.max() > (1e-2 if thin < 1e-3 else 1e-3)
