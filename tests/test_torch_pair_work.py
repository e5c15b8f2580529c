"""chip_smoke.py's count of the work the compositing kernels need
(pair_work, surely_fails), from which it computes their bounds, on the CPU
at the small cases of tests/torch_cases.py:

  * surely_fails, the mirror of the decision's shortcut
    csrc/gof_pair.cuh:surely_fails, rules out only pairs whose alpha lies
    below 1/255 by far, never one that passes the decision, and keeps an
    opacity of exactly 1/255 where G is 1;
  * the walks it counts nest (window >= walked >= bwd >= contributors) and
    its contributors are the mask's bits up to each pixel's last_pos;
  * field_pair_work, the field query's count, walks each inside point's
    whole window and counts as passing the pairs whose alpha reaches 1/255
    and as rejected those the kernel's shortcut rules out (never a passing
    one), on the field-query cases."""
import os
import sys

import numpy as np
import pytest
import torch

from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as S  # noqa: E402

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {name: (cam, cloud, bg, kw)
         for name, cam, cloud, bg, kw in torch_cases.small_cases()}
# the cases with pairs in their windows, the deep ones aside (slow here)
SHALLOW = sorted(set(CASES) - set(torch_cases.DEEP_CASES) - {"behind_camera"})


def _prepared(case):
    cam, cloud, bg, kw = CASES[case]
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)
    feat = inp.feat.detach()
    return inp, feat


@pytest.mark.parametrize("case", SHALLOW)
def test_surely_fails_rules_out_only_failing_pairs(case):
    """Every pair it rules out fails the f32 decision, and its alpha,
    evaluated in f64, stays below 0.9991 / 255; some pairs of every window
    set are ruled out."""
    inp, feat = _prepared(case)
    s, b = inp.statics, inp.binning
    _, valid, wfeat, n = TR._windows(feat, b.point_list, b.tile_start,
                                     b.tile_count, s)
    u, v = TR._tile_rays(s, "cpu")
    rejected = inside = 0
    for ci in range(n):
        sl = slice(ci * s.chunk, (ci + 1) * s.chunk)
        rej = S.surely_fails(wfeat[:, sl], u[..., None], v[..., None])
        rej &= valid[:, None, sl]
        assert not (rej & TR._decide(TR._chunk_eval(wfeat[:, sl], u, v),
                                     valid[:, sl])).any()
        ev = TR._chunk_eval(wfeat[:, sl].double(), u.double(), v.double())
        assert (ev["alpha_raw"][rej] < 0.9991 / 255.0).all()
        rejected += int(rej.sum())
        inside += int(valid[:, sl].sum()) * TR.PIX
    assert 0 < rejected < inside


def test_surely_fails_keeps_an_opacity_of_one_255th():
    """A pair with num = 0 (G = 1) in front of the near plane: at an
    opacity of fl(1/255) alpha is exactly the threshold and the pair
    passes, so the shortcut must not rule it out; just below, it may."""
    eps = np.float32(TR.ALPHA_EPS)
    f = torch.zeros((1, 2, TR.NFEAT))
    f[..., TR.ROW_QA + 5] = 1.0          # AA = 1
    f[..., TR.ROW_B + 2] = -1.0          # BB = -2, t = 1
    f[0, 0, TR.ROW_OPA] = float(eps)
    f[0, 1, TR.ROW_OPA] = float(np.nextafter(eps, np.float32(0)))
    u = v = torch.zeros((1, 1))
    passes = TR._decide(TR._chunk_eval(f, u, v), torch.ones((1, 2), dtype=bool))
    rej = S.surely_fails(f, u[..., None], v[..., None])
    assert passes.tolist() == [[[True, False]]]
    assert rej.tolist() == [[[False, True]]]


@pytest.mark.parametrize("case", SHALLOW)
def test_pair_work_walks_nest(case):
    inp, feat = _prepared(case)
    s, b = inp.statics, inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count)
    _, aux = TR._composite_fwd_impl(feat, *slab, inp.bg, s)
    w = S.pair_work(inp, aux.last_pos)
    assert w["window"] >= w["walked"] >= w["bwd"] >= w["contrib"] > 0
    for k in ("window", "walked", "bwd"):
        assert 0 <= w[k + "_rejected"] <= w[k]
    assert w["window_rejected"] >= w["walked_rejected"] >= w["bwd_rejected"]
    n = torch.clamp_max(b.tile_count.long(), s.max_per_tile)
    assert w["window"] == int(n.sum()) * TR.PIX
    # the contributors are the mask's bits up to each pixel's last_pos
    mask = TR._contrib_mask_impl(feat, *slab, s)
    _, valid, _, n_chunks = TR._windows(feat, *slab, s)
    C, bits = s.chunk, 0
    for ci in range(n_chunks):
        pos = torch.arange(ci * C, (ci + 1) * C)
        bits += int((TR._unpack_window_bits(mask, b.tile_start, ci * C, C)
                     & valid[:, None, ci * C:(ci + 1) * C]
                     & (pos <= aux.last_pos[..., None].long())).sum())
    assert w["contrib"] == bits
    if case == "near_opaque64":      # pixels stop before their windows end
        assert w["walked"] < w["window"]
    assert S.decide_ops(w, "window") == (
        w["window_rejected"] * S.OPS_PER_REJECTED
        + (w["window"] - w["window_rejected"]) * S.OPS_PER_DECIDED)


@pytest.mark.parametrize("case", [c[0] for c in torch_cases.integrate_cases()])
def test_field_pair_work_counts_each_window(case):
    """Point by point, its whole window at once: the same pairs, and as
    passing those whose alpha reaches 1/255; the field is 1 - the product
    of (1 - alpha) over them."""
    from f3d_gaus_torch.ops import integrate as TI

    _, cam, cloud, pts, kw = next(c for c in torch_cases.integrate_cases()
                                  if c[0] == case)
    s = TI._statics(cam, kw.get("max_per_tile", 1024), kw.get("chunk", 128),
                    kw.get("point_chunk", 1 << 14))
    pre, bng, _ = TI._prepare_view(tuple(map(torch.from_numpy, cloud)), cam,
                                   1, 0.0, kw.get("pair_cap", 1 << 18),
                                   s.max_per_tile)
    q = TI.query_rays(torch.from_numpy(pts), cam, s)
    slab = (pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count)
    w = S.field_pair_work(slab, q, s)
    rows = torch.cat([pre.v2g_mb, pre.opa_coef[:, None]], 1)
    field = TI._alpha_impl(*slab, q, s)
    pairs = passing = 0
    windows = []
    for i in torch.nonzero(q.inside)[:, 0].tolist():
        t = int(q.tile[i])
        n = min(int(bng.tile_count[t]), s.max_per_tile)
        ids = bng.point_list[int(bng.tile_start[t]):][:n].long()
        windows.append((i, ids))
        alpha = TI._pair_alpha(rows[ids][None], q.u[i:i + 1], q.v[i:i + 1],
                               q.depth[i:i + 1])
        pairs += n
        passing += int((alpha > 0).sum())
        torch.testing.assert_close(1 - torch.prod(1 - alpha), field[i],
                                   atol=1e-6, rtol=0)
    rejected = int(sum(TI._pair_rejected(
        TI._pack_rows(pre.v2g_mb, pre.opa_coef)[ids.clamp(0, len(rows))][None],
        q.u[i:i + 1], q.v[i:i + 1]).sum()
        for i, ids in windows))
    assert w == {"pairs": pairs, "passing": passing, "rejected": rejected,
                 "rejected_passing": 0}
    assert 0 < passing < pairs and 0 < rejected <= pairs - passing
