"""chip_smoke.py's witness for the compositing backward's rows that lie
outside the gradient tolerance (flip_margins / held_bwd), on the CPU with
the plain versions standing in for the kernels: it accepts agreement,
refuses a classification threshold moved by 0.3 %, and finds the pair
whose alpha is put on 1/255."""
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
    if opa is not None:
        inp = inp._replace(opa=opa)
    feat = cuda_raster._all_features(inp.pre.v2g_mb, inp.rgb, inp.opa).detach()
    extra = torch.cat([inp.pre.conic, inp.pre.means2d], 1).detach()
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


def test_flip_margins_find_a_pair_at_the_alpha_threshold():
    inp, args = _inputs()
    aux, s, b = args[6], inp.statics, inp.binning
    margin, walked = S.flip_margins(inp, aux)
    assert walked.any() and not (margin[:, walked] <= 1.0).any()

    # a contributing pair with a later contributor in its pixel (so it stays
    # walked), its Gaussian's opacity set so that alpha there is 1/255
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
    opa = inp.opa.clone()
    opa[gid] = float(np.float32(TR.ALPHA_EPS)) / float(ev["G"][ti, pi, ki])
    inp2, args2 = _inputs(opa)
    margin2, walked2 = S.flip_margins(inp2, args2[6])
    assert walked2[gid] and margin2[0, gid] <= 1.0
