"""f3d_gaus_torch.ops.integrate (the opacity-field query, plain PyTorch
version on the CPU) against f3d_gaus_tpu.ops.integrate on the 32^2 cases
of tests/test_integrate.py: alpha_integrated at that file's own tolerance
(2e-5), color_integrated exactly, and the running minimum over a 3-view
orbit at 2e-5.  Then what the kernel's wrapper computes in torch: the
rejection's f32 mirror never rules out a pair that _pair_alpha passes
(also on thin Gaussians), and the item plan _integrate_items covers each
(inside point, window slot) once, its partial products at distinct
places, and, walked as the kernel walks it, gives the plain field."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.ops import integrate as JI
from f3d_gaus_torch.ops import cuda_raster
from f3d_gaus_torch.ops import integrate as TI
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {c[0]: c for c in torch_cases.integrate_cases()}
ATOL = 2e-5        # tests/test_integrate.py:83


def _jax_points(cam, cloud, pts, kw, img=None):
    out = JI.integrate_points(*map(jnp.asarray, cloud), cam, jnp.asarray(pts),
                              pixel_color=None if img is None
                              else jnp.asarray(img), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _image():
    return np.arange(3 * 32 * 32, dtype=np.float32).reshape(3, 32, 32)


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_points_matches_jax(case):
    _, cam, cloud, pts, kw = CASES[case]
    img = _image()
    ref = _jax_points(cam, cloud, pts, kw, img)
    got = TI.integrate_points(*cloud, cam, pts, pixel_color=img,
                              device="cpu", **kw)
    assert got["alpha_integrated"].dtype == torch.float32
    alpha = got["alpha_integrated"].numpy()
    np.testing.assert_allclose(alpha, ref["alpha_integrated"], atol=ATOL,
                               rtol=0)
    np.testing.assert_array_equal(got["color_integrated"].numpy(),
                                  ref["color_integrated"])
    assert (alpha > 0.05).sum() >= 5        # the field is not trivially 0
    if case == "cloud16_outside":
        assert alpha[0] == 0 and (got["color_integrated"][0] == 0).all()
        assert (got["color_integrated"][1] != 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_min_alpha_matches_jax(case):
    _, cam, cloud, pts, kw = CASES[case]
    orbit = torch_cases.orbit_views(3)
    views = (orbit.world_view, orbit.full_proj, orbit.cam_centers)
    size = dict(width=32, height=32, tan_fovx=torch_cases.TAN,
                tan_fovy=torch_cases.TAN)
    ref = np.asarray(JI.integrate_min_alpha(*map(jnp.asarray, cloud), *views,
                                            jnp.asarray(pts), **size, **kw))
    before = TI.overflow_views
    got = TI.integrate_min_alpha(*cloud, *views, pts, **size, device="cpu",
                                 **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    # the sweep is the minimum of the single views
    single = [TI.integrate_points(*cloud, orbit.camera(i, 32, 32,
                                                       torch_cases.TAN,
                                                       torch_cases.TAN),
                                  pts, device="cpu", **kw)["alpha_integrated"]
              for i in range(3)]
    np.testing.assert_array_equal(got, torch.stack(single).amin(0).numpy())
    # views whose windows are cut are counted, not refused
    cut = 6 if case == "dense600_mpt128" else 0
    assert TI.overflow_views - before == cut


def test_field_direction():
    """tests/test_integrate.py:test_field_direction on the port, and equal
    to JAX: points behind the cloud see accumulated opacity, points far in
    front of it almost none (the t-clamp)."""
    rng = np.random.default_rng(0)
    cloud = list(torch_cases.make_gaussian_cloud(rng, 64, spread=0.1,
                                                 scale_range=(0.05, 0.1)))
    cloud[3][:] = 0.9
    cam = torch_cases.small_camera()
    kw = dict(max_per_tile=128, point_chunk=64)
    alpha = {}
    for name, dz in (("behind", 0.8), ("front", -0.8)):
        pts = cloud[0] + np.array([0, 0, dz], np.float32)
        alpha[name] = TI.integrate_points(*cloud, cam, pts, device="cpu",
                                          **kw)["alpha_integrated"].numpy()
        ref = _jax_points(cam, cloud, pts, kw)["alpha_integrated"]
        np.testing.assert_allclose(alpha[name], ref, atol=ATOL, rtol=0)
    assert alpha["behind"].mean() > 0.5
    assert alpha["front"].mean() < 0.05
    assert (alpha["behind"] >= alpha["front"] - 1e-5).mean() > 0.95


@pytest.mark.parametrize("chunk,point_chunk", [(16, 7), (64, 1000)])
def test_plain_version_chunking(chunk, point_chunk):
    """The plain version's window and point chunks are memory knobs: other
    sizes give the same field up to the product's rounding."""
    _, cam, cloud, pts, kw = CASES["dense600_mpt128"]
    ref = TI.integrate_points(*cloud, cam, pts, device="cpu",
                              **kw)["alpha_integrated"]
    got = TI.integrate_points(*cloud, cam, pts, device="cpu", **dict(
        kw, chunk=chunk, point_chunk=point_chunk))["alpha_integrated"]
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)


def test_kernel_wrapper_takes_only_cuda_tensors():
    """On CPU tensors the kernel's wrapper raises before building anything;
    integrate picks the plain version for them."""
    z = torch.zeros
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_raster.integrate(z((4, 12)), z(4), z(128, dtype=i32),
                              z(4, dtype=i32), z(4, dtype=i32), z(3), z(3),
                              z(3), z(3, dtype=i32), z(3, dtype=torch.bool),
                              64)
    assert cuda_raster._libs is None
    _, cam, cloud, pts, kw = CASES["cloud16_outside"]
    with pytest.raises(ValueError, match="backend"):
        TI.integrate_points(*cloud, cam, pts, device="cpu", backend="xla")


def _view(case):
    """(statics, preprocess, binning, query rays) of a case's camera."""
    _, cam, cloud, pts, kw = case
    s = TI._statics(cam, kw.get("max_per_tile", 1024), kw.get("chunk", 128),
                    kw.get("point_chunk", 1 << 14))
    pre, bng, _ = TI._prepare_view(tuple(map(torch.from_numpy, cloud)), cam,
                                   1, 0.0, kw.get("pair_cap", 1 << 18),
                                   s.max_per_tile)
    return s, pre, bng, TI.query_rays(torch.from_numpy(pts), cam, s)


def _windows(s, bng, q):
    """Each inside point's window: (point, slab ids) in point order."""
    for i in torch.nonzero(q.inside)[:, 0].tolist():
        t = int(q.tile[i])
        n = min(int(bng.tile_count[t]), s.max_per_tile)
        yield i, bng.point_list[int(bng.tile_start[t]):][:n].long()


@pytest.mark.parametrize("case", list(CASES) + ["thin300"])
def test_rejection_never_rules_out_a_passing_pair(case):
    """integrate._pair_rejected, the mirror of the kernel's division- and
    exp-free test, holds only where _pair_alpha fails 1/255, on every
    inside point's whole window; it rules out most failing pairs, and a
    quarter of them on the thin Gaussians (scales down to 1e-4 of the
    others), whose margin kappa |b|^2 is wide."""
    c = torch_cases.thin_integrate_case() if case == "thin300" else \
        CASES[case]
    s, pre, bng, q = _view(c)
    table = TI._pack_rows(pre.v2g_mb, pre.opa_coef)
    rows13 = torch.cat([pre.v2g_mb, pre.opa_coef[:, None]], 1)
    rows13 = torch.cat([rows13, rows13.new_zeros((1, 13))], 0)
    pairs = rejected = failing = 0
    for i, ids in _windows(s, bng, q):
        ids = ids.clamp(0, pre.v2g_mb.shape[0])
        sl = slice(i, i + 1)
        alpha = TI._pair_alpha(rows13[ids][None], q.u[sl], q.v[sl],
                               q.depth[sl])
        rej = TI._pair_rejected(table[ids][None], q.u[sl], q.v[sl])
        assert not bool((rej & (alpha > 0)).any()), (i, ids[rej & (alpha > 0)])
        pairs += ids.numel()
        rejected += int(rej.sum())
        failing += int((alpha == 0).sum())
    assert 0 < rejected <= failing < pairs
    # the margin for thin Gaussians grows with |b|^2, so fewer are ruled out
    share = 0.25 if case == "thin300" else 0.5
    assert rejected > share * failing, (rejected, failing, pairs)


def test_row_table_rejects_the_sentinel_and_faint_rows():
    """Row P of the packed table, and any row of an opacity below 1/255,
    has the threshold -inf (its column |b|^2 - thr_row is +inf): every
    pair with such a row and a ray of nonzero |a| is rejected, as its
    alpha fails; the sentinel's a is (1, 1, 1) on every ray, so each of
    its pairs is; an opacity of exactly 1/255 keeps a finite threshold."""
    mb = torch.randn(3, 12)
    opa = torch.tensor([0.5, 0.5 * TI.ALPHA_EPS, TI.ALPHA_EPS],
                       dtype=torch.float32)
    table = TI._pack_rows(mb, opa)
    assert table.shape == (4, 16)
    torch.testing.assert_close(table[:3, :12], mb, atol=0, rtol=0)
    col = table[:, 13]
    assert col[1] == col[3] == float("inf") and bool(col[[0, 2]].isfinite()
                                                     .all())
    sentinel = torch.zeros(13)
    sentinel[[2, 5, 8]] = 1.0
    assert torch.equal(table[3, :13], sentinel)
    u, v = torch.randn(5), torch.randn(5)
    rej = TI._pair_rejected(table[None], u, v)
    assert bool(rej[:, 1].all()) and bool(rej[:, 3].all())
    assert not bool(TI._pair_alpha(table[None, :, :13], u, v,
                                   torch.ones(5))[:, 3].any())


def _kernel_walk(plan, s, table, bng, q, slice_len):
    """The field as csrc/integrate.cu walks the plan: each item's points
    against its window slice in order (a rejected pair, or one whose
    alpha fails, multiplies by 1), a one-slice segment written at once,
    a split one through its partial products, then multiplied in slice
    order.  Returns (field, the (point, slot) pairs walked, the partial
    indices written)."""
    T = bng.tile_start.shape[0]
    P = table.shape[0] - 1
    _, max_parts = TI.plan_bounds(q.u.shape[0], T, s.max_per_tile, slice_len)
    rows13 = table[:, :13]
    out = torch.zeros_like(q.u)
    part = {}
    walked = []
    seg_start, item_start = plan.seg_start.tolist(), plan.item_start.tolist()
    part_start, perm = plan.part_start.tolist(), plan.perm.tolist()
    K = TI.POINTS_PER_ITEM
    for item in range(item_start[-1]):
        seg = max(k for k in range(T + 1) if item_start[k] <= item)
        n_pts = seg_start[seg + 1] - seg_start[seg]
        n_blocks = -(-n_pts // K)
        n_slices = (item_start[seg + 1] - item_start[seg]) // n_blocks
        local = item - item_start[seg]
        block, sl = local % n_blocks, local // n_blocks
        n = (min(int(bng.tile_count[seg]), s.max_per_tile) if seg < T
             else 0)
        rows = TI.slice_rows(n, slice_len)
        lo, hi = sl * rows, min(n, (sl + 1) * rows)
        start = int(bng.tile_start[seg]) if seg < T else 0
        ids = bng.point_list[start + lo:start + max(hi, lo)].long().clamp(0, P)
        for k in range(block * K, min(n_pts, (block + 1) * K)):
            i = perm[seg_start[seg] + k]
            walked += [(i, slot) for slot in range(lo, hi)]
            qi = slice(i, i + 1)
            alpha = TI._pair_alpha(rows13[ids][None], q.u[qi], q.v[qi],
                                   q.depth[qi])
            rej = TI._pair_rejected(table[ids][None], q.u[qi], q.v[qi])
            Tp = torch.prod(torch.where(rej, 1.0, 1.0 - alpha))
            if n_slices == 1:
                out[i] = 1.0 - Tp
            else:
                idx = part_start[seg] + sl * n_pts + k
                assert idx not in part and 0 <= idx < max_parts
                part[idx] = (i, sl, Tp)
    for i in range(q.u.shape[0]):
        mine = sorted((sl, Tp) for j, sl, Tp in part.values() if j == i)
        if mine:
            prod = torch.ones(())
            for _, Tp in mine:
                prod = prod * Tp
            out[i] = 1.0 - prod
    return out, walked, set(part)


@pytest.mark.parametrize("slice_len", [torch_cases.LONG_WINDOW_SLICE,
                                       TI.SLICE_LEN])
@pytest.mark.parametrize("case", ["long_window", "dense600_mpt128",
                                  "cloud16_outside"])
def test_integrate_items_cover_each_pair_once(case, slice_len):
    """_integrate_items on the cases: every (inside point, window slot)
    pair is walked by exactly one item, points outside by an item of an
    empty window, the host bounds hold, and the kernel's walk of the plan
    gives the plain field within 2e-5.  long_window has a tile whose
    window is more than three forced slices long, so long that at the
    forced length MAX_SLICES caps its slices, and a tile with one point."""
    s, pre, bng, q = _view(CASES[case])
    plan = TI._integrate_items(q.tile, q.inside, q.u, q.v, bng.tile_count,
                               s.max_per_tile, slice_len)
    T = bng.tile_start.shape[0]
    assert sorted(plan.perm.tolist()) == list(range(q.u.shape[0]))
    max_items, max_parts = TI.plan_bounds(q.u.shape[0], T, s.max_per_tile,
                                          slice_len)
    assert int(plan.item_start[-1]) <= max_items
    assert int(plan.part_start[-1]) <= max_parts
    seg = torch.where(q.inside, q.tile, T)[plan.perm]
    assert bool((seg[1:] >= seg[:-1]).all())       # grouped by segment
    assert bool((plan.keys[1:] >= plan.keys[:-1]).all())
    table = TI._pack_rows(pre.v2g_mb, pre.opa_coef)
    got, walked, _ = _kernel_walk(plan, s, table, bng, q, slice_len)
    expect = [(i, slot) for i, ids in _windows(s, bng, q)
              for slot in range(ids.numel())]
    assert sorted(walked) == sorted(expect)
    assert len(set(walked)) == len(walked)
    plain = TI._alpha_impl(pre.v2g_mb, pre.opa_coef, bng.point_list,
                           bng.tile_start, bng.tile_count, q, s)
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)
    slices = (plan.item_start[1:] - plan.item_start[:-1]).tolist()
    if case == "long_window":
        n_pts = (plan.seg_start[1:] - plan.seg_start[:-1]).tolist()
        assert n_pts[:T] == [64, 0, 0, 1]
        windows = bng.tile_count.tolist()
        assert windows[0] > 3 * torch_cases.LONG_WINDOW_SLICE
        rows = TI.slice_rows(windows[0], slice_len)
        assert slices[0] == -(-windows[0] // rows) >= 2
        assert slices[0] == min(TI.MAX_SLICES, -(-windows[0] // slice_len))
        if slice_len == torch_cases.LONG_WINDOW_SLICE:
            assert slices[0] == TI.MAX_SLICES < windows[0] / slice_len
        assert slices[3] == 1


def test_point_keys_order_each_tile_in_morton_order():
    """_point_keys: the segment in the high bits (points outside last),
    below it the Morton code of (u, v) at 2^key_bits levels over
    [-KEY_RANGE, KEY_RANGE), so that sorted neighbours are image
    neighbours; the key fits int32 at every tile count up to 2^20."""
    for T in (1, 4, 256, 2500, 1 << 20):
        bits = TI.key_bits(T)
        assert bits >= 5 and (T << (2 * bits)) + (1 << (2 * bits)) <= 2 ** 31
    g = torch.linspace(-0.5, 0.5, 8)
    u, v = [x.reshape(-1) for x in torch.meshgrid(g, g, indexing="xy")]
    tile = torch.zeros(64, dtype=torch.int32)
    inside = torch.ones(64, dtype=torch.bool)
    inside[5] = False
    keys = TI._point_keys(tile, inside, u, v, 4)
    bits = TI.key_bits(4)
    assert int(keys[5]) == 4 << (2 * bits)
    order = torch.argsort(keys[inside])
    cells = torch.stack([u, v], -1)[inside][order]
    # the first four in Morton order form the lowest 2 x 2 block
    assert sorted(cells[:4].tolist()) == sorted(
        [[g[0].item(), g[0].item()], [g[1].item(), g[0].item()],
         [g[0].item(), g[1].item()], [g[1].item(), g[1].item()]])
