"""The CUDA kernels (the decision pass csrc/gof_decide.cu,
csrc/raster_fwd.cu, csrc/raster_bwd.cu, the field query
csrc/integrate.cu, the preprocess csrc/preprocess.cu) against their plain
PyTorch versions on the card, one
feed-forward training step, one per-scene training step, one mesh
extraction and one serving request at planned caps there, and the render
stages that run as CUDA graphs (pipeline/renderer.py) against the same
stages rendered eagerly.  Needs a CUDA device and nvcc; skips elsewhere.
Imports no JAX, so on the card's machine it runs without the JAX
package's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import functools
import math
import types

import numpy as np
import pytest
import torch

from f3d_gaus_torch.mesh import extract as TE
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import integrate as TI
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.core import gaussians as TG
from f3d_gaus_torch.models import predictor as TP
from f3d_gaus_torch.ops import binning as TB
from f3d_gaus_torch.pipeline import config as TCfg
from f3d_gaus_torch.pipeline import cycle as TC
from f3d_gaus_torch.pipeline import dataset as TD
from f3d_gaus_torch.pipeline import renderer as TRend
from f3d_gaus_torch.train import feedforward as TF
from f3d_gaus_torch.train import per_scene as TPS
from f3d_gaus_torch.utils import profiling
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

pytestmark = pytest.mark.cuda
CASE_NAMES = [c[0] for c in torch_cases.small_cases()]
INTEGRATE_CASES = {c[0]: c for c in torch_cases.integrate_cases()}
INTEGRATE_TOL = 2e-5       # tests/test_integrate.py:83


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _render(cam, cloud, bg, device, **kw):
    return TR.render(*[torch.from_numpy(a).to(device) for a in cloud], cam,
                     torch.from_numpy(bg).to(device), **kw)


def launched(fn):
    """fn() counted by the program's profiling.record(): its output and the
    launches of each kernel (decide, fwd, bwd, integrate, preprocess)."""
    with profiling.record():
        out = fn()
        torch.cuda.synchronize()
        c = profiling.snapshot()["counters"]
    return out, {k: c.get(f"launches.{k}", 0)
                 for k in ("decide", "fwd", "bwd", "integrate", "preprocess")}


@pytest.mark.parametrize("case", CASE_NAMES)
def test_kernel_matches_plain(cuda, case):
    name, cam, cloud, bg, kw = next(c for c in torch_cases.small_cases()
                                    if c[0] == case)
    k, n = launched(lambda: _render(cam, cloud, bg, cuda, **kw))
    assert n["fwd"] == 1
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
    feat = inp.feat.detach()
    b, s = inp.binning, inp.statics
    slab = (b.point_list, b.tile_start, b.tile_count)
    k, n = launched(lambda: cuda_raster.decide(feat, *slab, s))
    assert n["decide"] == 1
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
    aux = TR.RenderAux(*aux)
    torch.cuda.synchronize()
    assert (aux.final_T == 1).all() and (aux.last_pos == -1).all()


def _bwd_inputs(case, device, zero_qk=False):
    """A small case prepared on `device` (with `zero_qk`, the qk rows of
    every third Gaussian zeroed: torch_cases.zero_qk), the forward
    kernel's residuals and a seeded out9 cotangent with the alpha channel
    zeroed."""
    name, cam, cloud, bg, kw = next(c for c in torch_cases.small_cases()
                                    if c[0] == case)
    inp = TR.prepare(*[torch.from_numpy(a).to(device) for a in cloud], cam,
                     torch.from_numpy(bg).to(device), **kw)
    feat = inp.feat.detach()
    if zero_qk:
        feat = torch_cases.zero_qk(feat)
    extra = inp.extra.detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    out, aux = cuda_raster.composite_fwd(feat, *slab, inp.statics)
    aux = TR.RenderAux(*aux)
    g = np.random.default_rng(0).normal(size=tuple(out.shape)).astype(np.float32)
    g[..., 7] = 0.0
    return feat, extra, slab, aux, torch.from_numpy(g).to(device), inp.statics


@pytest.mark.parametrize("case", CASE_NAMES)
def test_bwd_kernel_matches_plain(cuda, case):
    """d_feat and d_stats within 5e-3 x max |g| per column (atomics
    reorder the sums)."""
    feat, extra, slab, aux, g, s = _bwd_inputs(case, cuda)
    k, n = launched(lambda: cuda_raster.composite_bwd(feat, extra, *slab,
                                                      aux, g, s))
    assert n["bwd"] == 1
    p = TR._composite_bwd_impl(feat, extra, *slab, aux, g, s)
    for got, ref in zip(k, p):
        assert torch.isfinite(got).all()
        tol = 5e-3 * ref.abs().amax(0, keepdim=True)
        assert ((got - ref).abs() <= tol).all()


@pytest.mark.parametrize("case", ["cloud96_mpt128", "near_opaque64"])
def test_bwd_kernel_halves_at_num_zero(cuda, case):
    """K2 at num = |b x Md|^2 = 0 exactly (the Gaussians whose qk rows are
    zero, where every evaluation gives 0): the clamp max(num, 0) passes
    half of the cotangent there, as jnp.maximum does and the plain
    backward does, so their qk-row gradients agree at 1e-4 x the largest
    |g| of those rows (atomics reorder the sums; a clamp that passes all
    or none of it misses by half).  Every row is held as in
    test_bwd_kernel_matches_plain."""
    feat, extra, slab, aux, g, s = _bwd_inputs(case, cuda, zero_qk=True)
    k = cuda_raster.composite_bwd(feat, extra, *slab, aux, g, s)
    p = TR._composite_bwd_impl(feat, extra, *slab, aux, g, s)
    torch.cuda.synchronize()
    qk = slice(TR.ROW_QK, TR.ROW_QK + 6)
    got, ref = k[0][::3, qk], p[0][::3, qk]
    assert ref.abs().max() > 0
    assert ((got - ref).abs() <= 1e-4 * ref.abs().max()).all()
    for got, ref in zip(k, p):
        assert torch.isfinite(got).all()
        tol = 5e-3 * ref.abs().amax(0, keepdim=True)
        assert ((got - ref).abs() <= tol).all()


BAND_CASES = [(name, (1, 1)) for name in CASE_NAMES] + [
    ("sharded64x128", (2, 2)), ("sharded64x128", (5, 3))]


def _band_case(name):
    if name == "sharded64x128":
        cam, cloud = torch_cases.setup(np.random.default_rng(0), n=64,
                                       width=64, height=128)
        return cam, cloud, np.array([0.1, 0.2, 0.3], np.float32), dict(
            pair_cap=1 << 13, max_per_tile=256, chunk=32)
    return next(c[1:] for c in torch_cases.small_cases() if c[0] == name)


@pytest.mark.parametrize("case,tile_rows", BAND_CASES)
def test_band_kernels_match_plain_band(cuda, case, tile_rows):
    """A band (row_off > 0) through the three kernels against the plain
    versions of the same band: the mask word for word, out9 and final_T at
    1e-4 with the positions equal, d_feat / d_stats within 5e-3 x max |g|
    per column."""
    cam, cloud, bg, kw = _band_case(case)
    inp = TR.prepare(*[torch.from_numpy(a).to(cuda) for a in cloud], cam,
                     torch.from_numpy(bg).to(cuda), tile_rows=tile_rows, **kw)
    s = inp.statics
    assert s.row_off == tile_rows[0] > 0 and s.grid_y == tile_rows[1]
    assert s.height == cam.height
    feat, extra = inp.feat.detach(), inp.extra.detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count)
    k = cuda_raster.decide(feat, *slab, s)
    p = TR._contrib_mask_impl(feat, *slab, s)
    used = TR.mask_words_used(b.tile_start, b.tile_count, s)
    assert torch.equal(k[:used], p[:used])
    ko, ka = cuda_raster.composite_fwd(feat, *slab, inp.bg, s)
    ka = TR.RenderAux(*ka)
    po, pa = TR._composite_fwd_impl(feat, *slab, inp.bg, s)
    torch.testing.assert_close(ko, po, atol=1e-4, rtol=0)
    torch.testing.assert_close(ka.final_T, pa.final_T, atol=1e-4, rtol=0)
    assert torch.equal(ka.last_pos, pa.last_pos)
    assert torch.equal(ka.max_pos, pa.max_pos)
    g = np.random.default_rng(0).normal(size=tuple(ko.shape)).astype(np.float32)
    g[..., 7] = 0.0
    g = torch.from_numpy(g).to(cuda)
    kb = cuda_raster.composite_bwd(feat, extra, *slab, inp.bg, ka, g, s)
    pb = TR._composite_bwd_impl(feat, extra, *slab, inp.bg, ka, g, s)
    for got, ref in zip(kb, pb):
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
    every render goes through both kernels (3 per image), and, being
    differentiated, through the composed preprocess."""
    cfg = TCfg.PipelineConfig(resolution=32, base_dim=32, num_blocks=1,
                              attn_resolutions=(8,), model_channels=32,
                              pair_cap=1 << 14, max_per_tile=2048, chunk=128)
    state = TF.init_state(torch.Generator().manual_seed(0), cfg, lr=1e-4)
    pack = TF.make_cameras_pack(cfg, TD.canonical_cameras(cfg), n_banks=1,
                                views_per_bank=1)
    rng = np.random.default_rng(0)
    batch = {"images": rng.uniform(size=(2, 32, 32, 3)).astype(np.float32),
             "depth": rng.uniform(6.8, 8.5, size=(2, 32, 32)).astype(np.float32)}
    (loss, aux), n = launched(lambda: TF.train_step(state, cfg, batch, pack))
    assert np.isfinite(loss.item()) and state.step == 1
    assert n["fwd"] == 6 and n["bwd"] == 6 and n["decide"] == 12
    assert n["preprocess"] == 0       # every render is differentiated
    for p in state.model.parameters():
        assert torch.isfinite(p.grad).all()


@pytest.mark.parametrize("case", list(INTEGRATE_CASES))
def test_integrate_kernel_matches_plain(cuda, case):
    """The field of one view and the running minimum over a 3-view orbit,
    the kernel against the plain version, within 2e-5."""
    _, cam, cloud, pts, kw = INTEGRATE_CASES[case]
    tc = [torch.from_numpy(a).to(cuda) for a in cloud]
    tp = torch.from_numpy(pts).to(cuda)
    k, n = launched(lambda: TI.integrate_points(*tc, cam, tp, **kw))
    k = k["alpha_integrated"]
    assert n["integrate"] == 1
    p = TI.integrate_points(*tc, cam, tp, backend="torch",
                            **kw)["alpha_integrated"]
    torch.testing.assert_close(k, p, atol=INTEGRATE_TOL, rtol=0)
    orbit = torch_cases.orbit_views(3)
    views = (orbit.world_view, orbit.full_proj, orbit.cam_centers)
    size = dict(width=32, height=32, tan_fovx=torch_cases.TAN,
                tan_fovy=torch_cases.TAN)
    km, n = launched(lambda: TI.integrate_min_alpha(*tc, *views, tp, **size,
                                                    **kw))
    assert n["integrate"] == 3
    pm = TI.integrate_min_alpha(*tc, *views, tp, backend="torch", **size, **kw)
    torch.testing.assert_close(km, pm, atol=INTEGRATE_TOL, rtol=0)


@pytest.mark.parametrize("slice_len", [None, torch_cases.LONG_WINDOW_SLICE])
@pytest.mark.parametrize("case", list(INTEGRATE_CASES))
def test_integrate_kernel_slices(cuda, case, slice_len):
    """The wrapper at the default slice length and at one that splits the
    long windows: one view's field and the running minimum in place within
    2e-5 of the plain version, and two launches equal."""
    _, cam, cloud, pts, kw = INTEGRATE_CASES[case]
    tc = [torch.from_numpy(a).to(cuda) for a in cloud]
    mpt = kw.get("max_per_tile", 1024)
    s = TI._statics(cam, mpt, kw.get("chunk", 128), kw.get("point_chunk", 64))
    pre, bng, _ = TI._prepare_view(tc, cam, 1, 0.0, kw.get("pair_cap", 1 << 18),
                                   mpt)
    q = TI.query_rays(torch.from_numpy(pts).to(cuda), cam, s)
    slab = (pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count)
    args = (*slab, q.u, q.v, q.depth, q.tile, q.inside, mpt)
    plain = TI._alpha_impl(*slab, q, s)
    one = [cuda_raster.integrate(*args, slice_len=slice_len) for _ in range(2)]
    torch.testing.assert_close(one[0], plain, atol=INTEGRATE_TOL, rtol=0)
    assert torch.equal(one[0], one[1])
    seeded = torch.rand(q.u.shape[0], device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    out = seeded.clone()
    assert cuda_raster.integrate(*args, out=out, slice_len=slice_len) is out
    torch.testing.assert_close(out, torch.minimum(seeded, plain),
                               atol=INTEGRATE_TOL, rtol=0)


@pytest.mark.parametrize("case", list(INTEGRATE_CASES))
def test_integrate_prep_and_plan_match_plain(cuda, case):
    """csrc/integrate.cu's prep kernel gives integrate._point_keys' keys
    and integrate._pack_rows' rows (the thresholds within an ulp or two),
    and its plan kernel _integrate_items' starts."""
    _, cam, cloud, pts, kw = INTEGRATE_CASES[case]
    tc = [torch.from_numpy(a).to(cuda) for a in cloud]
    mpt = kw.get("max_per_tile", 1024)
    s = TI._statics(cam, mpt, 128, 64)
    pre, bng, _ = TI._prepare_view(tc, cam, 1, 0.0, kw.get("pair_cap", 1 << 18),
                                   mpt)
    q = TI.query_rays(torch.from_numpy(pts).to(cuda), cam, s)
    T = bng.tile_start.shape[0]
    rows, keys = cuda_raster.integrate_prep(pre.v2g_mb, pre.opa_coef, q.u,
                                            q.v, q.tile, q.inside, T)
    assert torch.equal(keys, TI._point_keys(q.tile, q.inside, q.u, q.v, T))
    twin_rows = TI._pack_rows(pre.v2g_mb, pre.opa_coef)
    assert torch.equal(rows[:, :13], twin_rows[:, :13])
    # |b|^2 - thr_row: each side's logf may round differently by an ulp
    b2 = (rows[:, 9:12] ** 2).sum(-1)
    diff = (rows[:, 13] - twin_rows[:, 13]).abs().nan_to_num()
    assert bool((diff <= 1e-6 * (b2 + 20.0)).all())
    for L in (TI.SLICE_LEN, torch_cases.LONG_WINDOW_SLICE):
        keys_s, perm = torch.sort(keys)
        plan = torch.full((3 * (T + 2) + 1,), -1, dtype=torch.int32,
                          device=cuda)
        cuda_raster._integrate_launch(rows, keys_s, perm, bng.point_list,
                                      bng.tile_start, bng.tile_count, q.u,
                                      q.v, q.depth, mpt, L, plan=plan)
        twin = TI._integrate_items(q.tile, q.inside, q.u, q.v,
                                   bng.tile_count, mpt, L)
        assert torch.equal(plan[:-1], torch.cat([
            twin.seg_start, twin.item_start, twin.part_start]))
        assert int(plan[-1]) >= int(twin.item_start[-1])   # all taken


def test_extract_mesh_kernel_matches_plain(cuda):
    """tests/test_mesh.py's blob on a 24^3 lattice with 4 bisection steps:
    the same faces through the kernel as through the plain version, the
    vertices within 1e-4."""
    gauss, cams, kw = torch_cases.mesh_case("blob_grid")
    g = {k: torch.from_numpy(v).to(cuda) for k, v in gauss.items()}
    k, n = launched(lambda: TE.extract_mesh(g, cams, **kw))
    assert n["integrate"] == 8 * (1 + 4)
    p = TE.extract_mesh(g, cams, backend="torch", **kw)
    assert len(k.faces) > 50
    np.testing.assert_array_equal(k.faces, p.faces)
    np.testing.assert_allclose(k.vertices, p.vertices, atol=1e-4, rtol=0)


def test_integrate_wrapper_rejects_bad_inputs(cuda):
    _, cam, cloud, pts, kw = INTEGRATE_CASES["cloud48_mpt64"]
    tc = [torch.from_numpy(a).to(cuda) for a in cloud]
    s = TI._statics(cam, 64, 16, 32)
    pre, bng, _ = TI._prepare_view(tc, cam, 1, 0.0, 1 << 12, 64)
    q = TI.query_rays(torch.from_numpy(pts).to(cuda), cam, s)
    args = [pre.v2g_mb, pre.opa_coef, bng.point_list, bng.tile_start,
            bng.tile_count, q.u, q.v, q.depth, q.tile, q.inside]
    bad = {0: pre.v2g_mb[:, :9].contiguous(), 1: pre.opa_coef.double(),
           2: bng.point_list.long(), 3: bng.tile_start[:-1],
           5: q.u.cpu(), 7: q.depth[:-1], 8: q.tile.long(), 9: q.inside.int()}
    for i, t in bad.items():
        with pytest.raises(ValueError):
            cuda_raster.integrate(*args[:i], t, *args[i + 1:], 64)
    with pytest.raises(ValueError):
        cuda_raster.integrate(*args, 64, out=torch.zeros(3, device=cuda))
    out = torch.ones_like(q.u)
    got = cuda_raster.integrate(*args, 64, out=out)
    assert got is out and bool((out <= 1).all())


def _odd_frame_case(device):
    """A 40x24 frame (neither side a multiple of 16), SH degree 3 and dead
    rows: (camera, cloud tensors, mask, bg, render kwargs)."""
    rng = np.random.default_rng(3)
    cam = torch_cases.orbit_camera(40, 24)
    cloud = torch_cases.make_gaussian_cloud(rng, 96, spread=0.35,
                                            scale_range=(0.02, 0.12),
                                            sh_degree=3)
    mask = torch.from_numpy(rng.uniform(size=96) > 0.25).to(device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    kw = dict(sh_degree=3, pair_cap=1 << 12, max_per_tile=128, chunk=32)
    return cam, [torch.from_numpy(a).to(device) for a in cloud], mask, bg, kw


def test_kernels_on_an_odd_frame_with_dead_rows(cuda):
    """K1 and K2 against their plain versions where padding pixels take
    part in their tiles and are cropped, and dead rows are culled by the
    mask: out9 and final_T within 1e-4, positions equal; d_feat and
    d_stats within 5e-3 x max |g| per column; the chain to the five inputs
    and means2d_stats within 5e-3 x max |g|."""
    cam, cloud, mask, bg, kw = _odd_frame_case(cuda)
    inp = TR.prepare(*cloud, cam, bg, mask=mask, **kw)
    assert (inp.statics.grid_x, inp.statics.grid_y) == (3, 2)
    assert (inp.radii[~mask] == 0).all() and (inp.radii > 0).sum() > 40
    ko, ka = TR.composite(inp)
    po, pa = TR.composite(inp, "torch")
    torch.testing.assert_close(ko, po, atol=1e-4, rtol=0)
    torch.testing.assert_close(ka.final_T, pa.final_T, atol=1e-4, rtol=0)
    assert torch.equal(ka.last_pos, pa.last_pos)
    assert torch.equal(ka.max_pos, pa.max_pos)
    feat, extra = inp.feat.detach(), inp.extra.detach()
    b = inp.binning
    slab = (b.point_list, b.tile_start, b.tile_count, inp.bg)
    g = np.random.default_rng(4).normal(size=tuple(ko.shape)).astype(np.float32)
    g[..., 7] = 0.0
    args = (feat, extra, *slab, ka, torch.from_numpy(g).to(cuda), inp.statics)
    k = cuda_raster.composite_bwd(*args)
    p = TR._composite_bwd_impl(*args)
    for got, ref in zip(k, p):
        assert torch.isfinite(got).all()
        assert ((got - ref).abs()
                <= 5e-3 * ref.abs().amax(0, keepdim=True)).all()
    assert (k[1][~mask] == 0).all() and k[1].abs().max() > 0

    w9 = torch.from_numpy(np.random.default_rng(5).normal(
        size=(9, 24, 40)).astype(np.float32)).to(cuda)
    w9[7] = 0.0
    grads = []
    for backend in ("auto", "torch"):
        ts = [t.clone().requires_grad_() for t in cloud]
        ts.append(torch.zeros((96, 3), device=cuda, requires_grad=True))
        out = TR.render(*ts[:5], cam, bg, means2d_stats=ts[5], mask=mask,
                        backend=backend, **kw)
        assert out["out9"].shape == (9, 24, 40)
        (out["out9"] * w9).sum().backward()
        grads.append([t.grad for t in ts])
    for got, ref in zip(*grads):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 5e-3 * ref.abs().max()


def test_per_scene_train_step_on_the_card(cuda):
    """One per_scene.train_step on the card against the same step on the
    CPU, at SH degree 3 with dead rows: the loss within 1e-5 relative,
    the visible rows and radii equal, each group's gradient (through the
    first moments) within 5e-3 x max |g|; one K1, one K2 and two decision
    launches, and the composed preprocess."""
    rng = np.random.default_rng(6)
    cfg = TPS.PerSceneConfig(sh_degree=3, pair_cap=1 << 12, max_per_tile=128,
                             chunk=32, cap_bucket=128)
    pts = (rng.normal(size=(40, 3)) * 0.3 + [0, 0, 7.667]).astype(np.float32)
    scene = TPS.init_scene(pts, rng.uniform(size=(40, 3)), cfg, cap=128,
                           device="cpu")
    alive = scene.alive.clone()
    alive[5:9] = False
    scene = scene._replace(
        f_rest=torch.from_numpy((rng.normal(size=(128, 15, 3)) * 0.2
                                 ).astype(np.float32)),
        scaling=scene.scaling + torch.from_numpy(
            (rng.normal(size=(128, 3)) * 0.4).astype(np.float32)),
        rotation=torch.from_numpy(rng.normal(size=(128, 4)).astype(np.float32)),
        alive=alive)
    cam = torch_cases.orbit_camera(40, 24)
    target = torch.from_numpy(rng.uniform(size=(3, 24, 40)).astype(np.float32))
    arrays = (cam.world_view, cam.full_proj, cam.cam_center)
    statics = (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy)
    results = []
    for dev in (cuda, torch.device("cpu")):
        s = TPS.SceneParams(*[t.to(dev) for t in scene])
        out, n = launched(lambda: TPS.train_step(
            s, TPS.init_adam(s), TPS.init_stats(s), arrays, target.to(dev),
            torch.zeros(3, device=dev), cfg, 3, statics))
        results.append(out)
        if dev.type == "cuda":
            assert (n["fwd"], n["bwd"], n["decide"]) == (1, 1, 2)
            assert n["preprocess"] == 0
    (_, k_opt, k_stats, k_aux), (_, p_opt, p_stats, p_aux) = results
    assert not bool(k_aux["overflow"])
    torch.testing.assert_close(k_aux["loss"].cpu(), p_aux["loss"], rtol=1e-5,
                               atol=0)
    assert torch.equal(k_stats.denom.cpu(), p_stats.denom)
    assert torch.equal(k_stats.max_radii2d.cpu(), p_stats.max_radii2d)
    for got, ref in [(k_stats.grad_accum.cpu(), p_stats.grad_accum)] + [
            (getattr(k_opt.mu, f).cpu(), getattr(p_opt.mu, f))
            for f in TPS.SceneParams._fields[:-1]]:
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max() <= 5e-3 * ref.abs().max()


def test_planned_request_equals_doubled_caps(cuda):
    """One serving request at PipelineConfig() width and at caps planned
    per stage (run_nvs_replanned, no doubling) against the same request
    at the static caps the doubling settles on: the renders, the merged
    Gaussians and the aggregation renders are equal; the plan's counts
    equal, exactly, the most pairs and the fullest tile that preprocess
    and the binning give over each stage's views (the first forward's set
    at the aggregation cameras, the merged set at the NVS cameras), and
    the planned caps are the orbit stage's counts rounded up to the 65,536
    bucket and to the 256 lanes."""
    cfg = TCfg.PipelineConfig()
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0)).to(cuda)
    cams = TD.canonical_cameras(cfg)
    rng = np.random.default_rng(0)
    r = cfg.resolution
    images = rng.uniform(size=(1, r, r, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(1, r, r)).astype(np.float32)
    res = TC.run_nvs_replanned(model, cfg, cams, images, depth, device=cuda)
    assert res.attempts == 1
    static = cfg
    while True:
        try:
            merged, renders, agg_views = TC.run_nvs(model, static, cams,
                                                    images, depth, device=cuda)
            break
        except TC.renderer.RenderOverflow:
            static = TCfg.PipelineConfig(pair_cap=static.pair_cap * 2,
                                         max_per_tile=static.max_per_tile * 2)
    assert static.max_per_tile > cfg.max_per_tile
    for got, want in ((res.renders, renders), (res.merged, merged),
                      (res.agg_views, agg_views)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    agg = TC.aggregation_cameras(cfg, cams.inverse_first_camera)
    nvs = TC.nvs_cameras(cfg, cams.inverse_first_camera)
    for gs, camset in ((res.first, agg), (merged, nvs)):
        # the plan's count, with no headroom, is the binning's own on the
        # card: the most pairs and the fullest tile over the stage's views
        g = {k: v[0] for k, v in gs.items()}
        shs = torch.cat([g["features_dc"], g["features_rest"]], 1)
        pairs, tile = 0, 0
        for v in range(len(camset.world_view)):
            cam = camset.camera(v, r, r, cfg.tan_fov, cfg.tan_fov)
            pre = TG.preprocess(g["xyz"], g["scaling"], g["rotation"],
                                g["opacity"], shs, cfg.max_sh_degree, cam,
                                cfg.kernel_size)
            n = int(TB.count_pairs(pre.means2d, pre.radii, r, r))
            bng = TB.bin_gaussians(pre.means2d, pre.radii, pre.depths, r, r,
                                   TB.suggest_pair_cap(n))
            assert not bool(bng.overflow)
            pairs, tile = max(pairs, n), max(tile, int(bng.tile_count.max()))
        need = TB.footprint_need(gs["xyz"], gs["scaling"], gs["rotation"],
                                 camset.world_view, camset.full_proj, cam,
                                 cfg.kernel_size)
        assert need == {"pairs": pairs, "tile": tile}
    want_cap = -(-TB.suggest_pair_cap(pairs) // 256) * 256
    assert res.cfg.pair_cap == want_cap < static.pair_cap
    assert res.cfg.max_per_tile == -(-tile // 256) * 256


PREPROCESS_CASES = ("orbit_589824", "aggregation_65536", "gslrm_1048576",
                    "edges_sh3", "edges_sh2_k0")


@functools.lru_cache(maxsize=1)
def _preprocess_cases():
    return {c[0]: c[1:] for c in torch_cases.preprocess_cases()}


def _bit_gaps(got, want):
    """{} if got and want are equal bit for bit (NaN and the sign of 0
    included), else {'differ': elements, 'max_gap': largest |got - want|}."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.is_floating_point:
        same = (got.contiguous().view(torch.int32)
                == want.contiguous().view(torch.int32))
    else:
        same = got == want
    if bool(same.all()):
        return {}
    gap = (got.double() - want.double()).abs()[~same]
    return {"differ": int((~same).sum()), "max_gap": float(gap.max())}


@pytest.mark.parametrize("case", PREPROCESS_CASES)
def test_preprocess_kernel_matches_composed(cuda, case):
    """The preprocess kernel (cuda_raster.preprocess) against the composed
    route (rasterize._preprocess_impl) on the card, bit for bit: the
    feature table column by column (which holds v2g_mb, the SH colour and
    the opacity times its coefficient), the conic | means2d table, the
    depths and the radii; so the binning of the two is equal too."""
    cam, cloud, deg, ks = _preprocess_cases()[case]
    t = [torch.from_numpy(a).to(cuda) for a in cloud]
    got, n = launched(lambda: cuda_raster.preprocess(*t, deg, cam, ks))
    assert n["preprocess"] == 1
    want = TR._preprocess_impl(*t, deg, cam, ks)
    feat, extra, depths, radii = got
    gaps = {f"feat[{j}]": _bit_gaps(feat[:, j], want[0][:, j])
            for j in range(TR.NFEAT)}
    gaps.update({f: _bit_gaps(a, b) for f, a, b in zip(
        ("extra", "depths", "radii"), got[1:], want[1:])})
    assert not any(gaps.values()), {k: v for k, v in gaps.items() if v}
    assert feat.is_contiguous() and extra.is_contiguous()
    valid = TG.preprocess(*t, deg, cam, ks).valid
    n_valid = int(valid.sum())
    assert 0 < n_valid and (n_valid < len(valid)) == case.startswith("edges")
    w, h = cam.width, cam.height
    cap = TB.suggest_pair_cap(int(TB.count_pairs(want[1][:, 3:5], want[3], w,
                                                 h)))
    got, want = (TB.bin_gaussians(p[1][:, 3:5], p[3], p[2], w, h, cap)
                 for p in (got, want))
    for f in ("point_list", "tile_start", "tile_count", "num_pairs",
              "overflow"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_preprocess_route_follows_grad_mode(cuda):
    """prepare takes the preprocess kernel for a render no gradient flows
    through (one launch) and the composed route for one that is
    differentiated or given colours (no launch); the three renders are
    equal, and the differentiated one has its gradient."""
    _, cam, cloud, bg, kw = torch_cases.small_cases()[0]
    t = [torch.from_numpy(a).to(cuda) for a in cloud]
    bg = torch.from_numpy(bg).to(cuda)
    with torch.no_grad():
        k, n = launched(lambda: TR.render(*t, cam, bg, **kw))
    assert n["preprocess"] == 1 and n["fwd"] == 1
    leaves = [a.clone().requires_grad_() for a in t]
    g, n = launched(lambda: TR.render(*leaves, cam, bg, **kw))
    assert n["preprocess"] == 0 and n["fwd"] == 1
    rgb = TR.prepare(*t, cam, bg, **kw).feat[:, TR.ROW_RGB:TR.ROW_RGB + 3]
    c, n = launched(lambda: TR.render(*t, cam, bg, colors_precomp=rgb, **kw))
    assert n["preprocess"] == 0
    for other in (g, c):
        assert torch.equal(k["out9"], other["out9"].detach())
        assert torch.equal(k["radii"], other["radii"])
    g["out9"].sum().backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in leaves)


def test_preprocess_wrapper_rejects_bad_inputs(cuda):
    _, cam, cloud, _, _ = torch_cases.small_cases()[0]
    t = [torch.from_numpy(a).to(cuda) for a in cloud]
    bad = [t[0].double(), t[0][:-1], t[0].t().contiguous().t(), t[0].cpu()]
    for means in bad:
        with pytest.raises(ValueError):
            cuda_raster.preprocess(means, *t[1:], 1, cam)
    with pytest.raises(ValueError):           # 4 coefficients: degree 1
        cuda_raster.preprocess(*t, 2, cam)
    with pytest.raises(ValueError):
        cuda_raster.preprocess(*t[:3], t[3][:-1], t[4], 1, cam)


def test_request_preprocess_kernel_equals_composed(cuda, monkeypatch):
    """One planned serving request at PipelineConfig() launches the
    preprocess kernel once a render (8 aggregation and 129 orbit views)
    and gives what the composed route gives, bit for bit: the renders,
    the merged Gaussians and the aggregation renders."""
    cfg = TCfg.PipelineConfig()
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0)).to(cuda)
    cams = TD.canonical_cameras(cfg)
    rng = np.random.default_rng(1)
    r = cfg.resolution
    images = rng.uniform(size=(1, r, r, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(1, r, r)).astype(np.float32)

    def request():
        return TC.run_nvs_replanned(model, cfg, cams, images, depth,
                                    device=cuda)
    res, n = launched(request)
    views = sum(len(c(cfg, cams.inverse_first_camera).world_view)
                for c in (TC.aggregation_cameras, TC.nvs_cameras))
    assert res.attempts == 1 and views == 137
    assert n["preprocess"] == views
    monkeypatch.setattr(TR, "_kernel_preprocess", lambda *a: False)
    ref, n = launched(request)
    assert n["preprocess"] == 0 and ref.attempts == 1
    for got, want in ((res.renders, ref.renders), (res.merged, ref.merged),
                      (res.agg_views, ref.agg_views)):
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("case", PREPROCESS_CASES)
def test_preprocess_reads_its_camera_from_device_memory(cuda, case):
    """The preprocess kernel reads its camera from the device row it is
    given when it runs: with another camera's row written into the same
    row after a launch was queued, the next launch follows the row; both
    equal the composed route at their camera bit for bit (the 5 clouds
    of test_preprocess_kernel_matches_composed)."""
    cam, cloud, deg, ks = _preprocess_cases()[case]
    moved = np.array(cam.world_view, np.float32)
    moved[3, :3] += np.float32([0.05, -0.03, 0.1])    # the translation row
    other = cam._replace(world_view=moved)
    t = [torch.from_numpy(a).to(cuda) for a in cloud]
    row = torch.tensor(cuda_raster.camera_scalars(cam, ks),
                       dtype=torch.float32, device=cuda)
    first = cuda_raster.preprocess(*t, deg, cam, ks, camera_row=row)
    row.copy_(torch.tensor(cuda_raster.camera_scalars(other, ks)))
    second = cuda_raster.preprocess(*t, deg, cam, ks, camera_row=row)
    for got, at in ((first, cam), (second, other)):
        want = TR._preprocess_impl(*t, deg, at, ks)
        gaps = {f: _bit_gaps(a, b) for f, a, b in zip(
            ("feat", "extra", "depths", "radii"), got, want)}
        assert not any(gaps.values()), {k: v for k, v in gaps.items() if v}
    assert not torch.equal(first[2], second[2])
    with pytest.raises(ValueError):
        cuda_raster.preprocess(*t, deg, cam, ks, camera_row=row[:-1])
    with pytest.raises(ValueError):
        cuda_raster.preprocess(*t, deg, cam, ks, camera_row=row.cpu())


def _eager_stages(monkeypatch):
    """Every render stage from here on renders eagerly (the same kernels,
    one render at a time)."""
    monkeypatch.setattr(TRend, "_graph_route", lambda *a: False)


def _counted(fn):
    with profiling.record():
        out = fn()
        torch.cuda.synchronize()
        return out, profiling.snapshot()["counters"]


def _serving_request(cuda, batch):
    cfg = TCfg.PipelineConfig()
    model = TP.GaussianPredictor(cfg.predictor_config(),
                                 torch.Generator().manual_seed(0)).to(cuda)
    cams = TD.canonical_cameras(cfg)
    rng = np.random.default_rng(2)
    r = cfg.resolution
    images = rng.uniform(size=(batch, r, r, 3)).astype(np.float32)
    depth = rng.uniform(6.667, 8.667, size=(batch, r, r)).astype(np.float32)

    def request():
        res = TC.run_nvs_replanned(model, cfg, cams, images, depth,
                                   device=cuda)
        assert res.attempts == 1
        return {"renders": res.renders, "agg_views": res.agg_views,
                "merged": res.merged}
    return request, 2, 8 + 129


def _recon_request(cuda, batch):
    from f3d_gaus_torch.models import gslrm as G
    from f3d_gaus_torch.models import gslrm_reference as GR
    from f3d_gaus_torch.pipeline import reconstruct as TRec
    small = G.GSLRMConfig(views=2, resolution=32, patch=8, width=64,
                          layers=2, heads=4, mlp=256)
    ref = GR.GSLRM(small, torch.Generator().manual_seed(0))
    model = G.GSLRM(small, None)
    model.load_state_dict(ref.state_dict())
    model = model.eval().to(cuda)
    images = torch.rand(batch, 2, 32, 32, 3,
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    wv = torch_cases.turntable_views([0.4, 0.4 + np.pi]).astype(np.float32)
    cfg = TCfg.PipelineConfig(resolution=32, fov_deg=math.degrees(0.6911),
                              max_sh_degree=0)
    frames = [torch_cases.turntable_camera(a, 32, math.degrees(0.6911))
              for a in np.arange(32) * 2 * np.pi / 32]
    orbit = types.SimpleNamespace(
        world_view=np.stack([c.world_view for c in frames]),
        full_proj=np.stack([c.full_proj for c in frames]),
        cam_centers=np.stack([c.cam_center for c in frames]))

    def request():
        res = TRec.run_gslrm(model, cfg, images, np.repeat(
            wv[None], batch, 0), orbit, device=cuda)
        assert res.attempts == 1
        return {"renders": res.renders}
    return request, 1, 32


GRAPH_REQUESTS = {"serve_b1": (_serving_request, 1),
                  "serve_b2": (_serving_request, 2),
                  "recon_b1": (_recon_request, 1)}


@pytest.mark.parametrize("case", list(GRAPH_REQUESTS))
def test_graph_stages_equal_eager_stages(cuda, monkeypatch, case):
    """A planned serving request (its aggregation and orbit stages) at
    B = 1 and B = 2, and a reconstruction request's turntable, rendered as
    CUDA graphs equal the same requests rendered eagerly, bit for bit, in
    every returned field and the overflow map.  Each stage captures one
    graph a batch element and replays it for every view but the first;
    the counters read as the eager request's (a replay counts what its
    capture counted, binning.pairs its own num_pairs), with
    graph.captures and graph.replays beside them."""
    make, batch = GRAPH_REQUESTS[case]
    request, stages, views = make(cuda, batch)
    got, counters = _counted(request)
    assert counters["graph.captures"] == stages * batch
    assert counters["graph.replays"] == (views - stages) * batch
    assert counters["launches.preprocess"] == views * batch
    _eager_stages(monkeypatch)
    want, eager = _counted(request)
    assert "graph.captures" not in eager and "graph.replays" not in eager
    assert {k: v for k, v in counters.items()
            if not k.startswith("graph.")} == eager
    assert eager["launches.decide"] == eager["launches.fwd"] == views * batch
    for part in want:
        for k in want[part]:
            assert got[part][k].shape == want[part][k].shape, (part, k)
            assert torch.equal(got[part][k], want[part][k]), (part, k)


def _stage_case(cuda, views=12, n=20000):
    """A Gaussian set (B = 1) and an orbit stage of `views` views at 256²."""
    cloud = torch_cases.make_gaussian_cloud(np.random.default_rng(4), n,
                                            spread=0.5)
    t = [torch.from_numpy(a).to(cuda) for a in cloud]
    g = {"xyz": t[0][None], "scaling": t[1][None], "rotation": t[2][None],
         "opacity": t[3][None], "features_dc": t[4][None, :, :1],
         "features_rest": t[4][None, :, 1:]}
    return g, torch_cases.orbit_views(views)


def _stage(g, cs, cfg, cuda):
    return TRend.render_views_batched(g, cs.world_view, cs.full_proj,
                                      cs.cam_centers, torch.zeros(3,
                                                                  device=cuda),
                                      cfg)


def test_graph_stage_at_short_caps_flags_the_eager_truncations(
        cuda, monkeypatch):
    """A stage rendered at caps that some of its views need more than:
    the graph route flags the same truncated views as the eager route and
    gives the same truncated renders, bit for bit."""
    g, cs = _stage_case(cuda)
    cfg = TCfg.PipelineConfig()
    cam = TRend._camera(cs.world_view[0], cs.full_proj[0], cs.cam_centers[0],
                        cfg)
    need = [TB.footprint_need(g["xyz"], g["scaling"], g["rotation"],
                              cs.world_view[v:v + 1], cs.full_proj[v:v + 1],
                              cam)["pairs"] for v in range(len(cs.world_view))]
    short = sorted(need)[len(need) // 2] // 256 * 256
    cfg = TCfg.PipelineConfig(pair_cap=short, max_per_tile=1 << 14)
    got = _stage(g, cs, cfg, cuda)
    _eager_stages(monkeypatch)
    want = _stage(g, cs, cfg, cuda)
    assert bool(want["overflow"].any()) and not bool(want["overflow"].all())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_graph_stage_makes_no_host_sync(cuda):
    """A stage's render loop on the graph route (after one stage has built
    the kernels and the pools) runs with torch.cuda.set_sync_debug_mode
    ("error"): no host sync, the camera table's upload included."""
    g, cs = _stage_case(cuda)
    cfg = TCfg.PipelineConfig()
    want = _stage(g, cs, cfg, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _stage(g, cs, cfg, cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_graph_stage_traces_one_launch_a_view(cuda):
    """Under torch.profiler a graph stage's device trace holds one
    preprocess, decision and compositing kernel a view, the eager view's
    and each replay's (the benchmark reads K1's kernels in view order),
    and the program's registry one `replay` span a replayed view."""
    from torch.profiler import ProfilerActivity, profile
    g, cs = _stage_case(cuda, views=9)
    cfg = TCfg.PipelineConfig()
    _stage(g, cs, cfg, cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _stage(g, cs, cfg, cuda)
        torch.cuda.synchronize()
        snap = profiling.snapshot()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    for name in ("preprocess_kernel", "gof_decide", "raster_fwd"):
        assert sum(name in k for k in kernels) == 9, name
    assert snap["spans"]["replay"]["calls"] == 8
    assert snap["counters"]["graph.replays"] == 8
    assert snap["counters"]["launches.fwd"] == 9
