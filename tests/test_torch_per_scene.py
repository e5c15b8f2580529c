"""f3d_gaus_torch.train.per_scene against f3d_gaus_tpu.train.per_scene on
the CPU: init_scene, one train_step from the same state (values, the
densification statistics, gradients read through the first moments), the
Adam update on fixed gradients, densify_and_prune and reset_opacity on
identical numpy inputs and seeds, the capacity growth; then the port's
own fit_scene trend (as tests/test_per_scene.py:test_psnr_improves), its
overflow count, the viewer hook and the scene checkpoint.  The JAX
package renders through its XLA path here, as its per-scene trainer does
on the CPU; the port through the plain versions of the kernels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.train import per_scene as JP
from f3d_gaus_torch.core import gaussians as TG
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.train import checkpoint as Tckpt
from f3d_gaus_torch.train import losses as TL
from f3d_gaus_torch.train import per_scene as TP
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

GRAD_TOL = 5e-3            # x max|g| per group (tests/test_pallas_raster.py)
FIELDS = JP.SceneParams._fields[:-1]


def small_cfg(mod, **kw):
    """tests/test_per_scene.py:small_cfg for either package."""
    base = dict(iterations=60, densification_interval=20,
                densify_from_iter=10, densify_until_iter=55,
                opacity_reset_interval=1000, sh_degree=1,
                sh_degree_interval=10, pair_cap=1 << 12, max_per_tile=128,
                chunk=32, cap_bucket=128, position_lr_init=0.002,
                position_lr_final=0.0002, feature_lr=0.02, opacity_lr=0.05,
                scaling_lr=0.01, rotation_lr=0.005)
    base.update(kw)
    return mod.PerSceneConfig(**base)


def _np(tree):
    return [np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)
            for t in tree]


def _jax_tree(tree_np, cls):
    return cls(*[jnp.asarray(a) for a in tree_np])


def _torch_tree(tree_np, cls):
    return cls(*[torch.from_numpy(np.array(a)) for a in tree_np])


def _state(rng, sh_degree, n=40, cap=128):
    """A scene in front of the orbit camera with anisotropic scales, random
    rotations and SH bands, and dead rows among the alive ones: the numpy
    arrays of SceneParams."""
    pts = (rng.normal(size=(n, 3)) * 0.3 + [0, 0, 7.667]).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    s = _np(JP.init_scene(pts, cols, small_cfg(JP, sh_degree=sh_degree),
                          cap=cap))
    s[2] = (rng.normal(size=s[2].shape) * 0.2).astype(np.float32)
    s[3] = rng.uniform(-1.0, 2.0, size=s[3].shape).astype(np.float32)
    s[4] = (s[4] + rng.normal(size=s[4].shape) * 0.4).astype(np.float32)
    s[5] = rng.normal(size=s[5].shape).astype(np.float32)
    s[6] = s[6].copy()
    s[6][5:9] = False
    return s


def _camera_args(cam):
    return ((cam.world_view, cam.full_proj, cam.cam_center),
            (cam.width, cam.height, cam.tan_fovx, cam.tan_fovy))


def test_init_scene_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    j = _np(JP.init_scene(pts, cols, small_cfg(JP, sh_degree=3)))
    t = _np(TP.init_scene(pts, cols, small_cfg(TP, sh_degree=3),
                          device="cpu"))
    assert t[0].shape[0] == j[0].shape[0] == 384
    for name, a, b in zip(JP.SceneParams._fields, j, t):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "scaling":      # the KNN's f32 sums (tests/test_torch_knn)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("sh_degree", [1, 3])
def test_train_step_matches_jax(sh_degree):
    """One step from the same state at the active SH degree, with dead
    rows: the loss, the visible rows (denom) and radii (max_radii2d) and
    the viewspace statistic, and each group's gradient read through the
    new first moments (mu = (1 - b1) g)."""
    rng = np.random.default_rng(sh_degree)
    s = _state(rng, sh_degree)
    cam = torch_cases.orbit_camera(32, 32)
    arrays, statics = _camera_args(cam)
    target = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    jc, tc = (small_cfg(m, sh_degree=sh_degree) for m in (JP, TP))
    js = _jax_tree(s, JP.SceneParams)
    j_scene, j_opt, j_stats, j_aux = JP.train_step(
        js, JP.init_adam(js), JP.init_stats(js),
        tuple(jnp.asarray(a) for a in arrays), jnp.asarray(target),
        jnp.zeros(3), jc, sh_degree, statics)
    ts = _torch_tree(s, TP.SceneParams)
    t_scene, t_opt, t_stats, t_aux = TP.train_step(
        ts, TP.init_adam(ts), TP.init_stats(ts), arrays,
        torch.from_numpy(target), torch.zeros(3), tc, sh_degree, statics)

    np.testing.assert_allclose(t_aux["loss"].item(), float(j_aux["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(t_aux["l1"].item(), float(j_aux["l1"]),
                               rtol=1e-5)
    assert int(t_aux["n_visible"]) == int(j_aux["n_visible"]) > 20
    assert not bool(t_aux["overflow"])
    np.testing.assert_array_equal(t_stats.denom.numpy(),
                                  np.asarray(j_stats.denom))
    np.testing.assert_array_equal(t_stats.max_radii2d.numpy(),
                                  np.asarray(j_stats.max_radii2d))
    assert (t_stats.denom.numpy()[~s[6]] == 0).all()
    ja = np.asarray(j_stats.grad_accum)
    assert np.abs(t_stats.grad_accum.numpy() - ja).max() <= \
        GRAD_TOL * np.abs(ja).max()
    assert int(t_opt.step) == int(j_opt.step) == 1
    for name in FIELDS:
        g_j = np.asarray(getattr(j_opt.mu, name)) / 0.1
        g_t = getattr(t_opt.mu, name).numpy() / 0.1
        scale = np.abs(g_j).max()
        assert scale > 0, name
        assert np.abs(g_t - g_j).max() <= GRAD_TOL * scale, name
        assert (g_t[~s[6]] == 0).all(), name


def test_adam_update_matches_jax(monkeypatch):
    """The functional Adam on fixed gradients from a state with moments
    (step 7): per-group learning rates (xyz on expon_lr at step + 1,
    f_rest feature_lr / 20), eps 1e-15, bias correction, gradients masked
    to alive rows; within 1e-6."""
    rng = np.random.default_rng(5)
    s = _state(rng, 3)
    cap = s[0].shape[0]
    cam = torch_cases.orbit_camera(32, 32)
    arrays, statics = _camera_args(cam)
    target = rng.uniform(size=(3, 32, 32)).astype(np.float32)
    grads = [(rng.normal(size=a.shape) * 1e-2).astype(np.float32)
             for a in s[:-1]]
    g_stats = rng.normal(size=(cap, 3)).astype(np.float32)
    mu = [(rng.normal(size=a.shape) * 1e-2).astype(np.float32)
          for a in s[:-1]] + [s[6]]
    nu = [(rng.uniform(size=a.shape) * 1e-4).astype(np.float32)
          for a in s[:-1]] + [s[6]]
    cfg_t = small_cfg(TP, sh_degree=3)
    with torch.no_grad():
        radii = TP.render_scene(_torch_tree(s, TP.SceneParams), cam, cfg_t,
                                torch.zeros(3), 3)["radii"].numpy()

    def fake_value_and_grad(fn, argnums, has_aux):
        def run(*args):
            return ((jnp.float32(0.5), (jnp.asarray(radii), jnp.float32(0.4))),
                    (tuple(jnp.asarray(g) for g in grads),
                     jnp.asarray(g_stats)))
        return run

    monkeypatch.setattr(jax, "value_and_grad", fake_value_and_grad)
    js = _jax_tree(s, JP.SceneParams)
    j_opt = JP.AdamState(_jax_tree(mu, JP.SceneParams),
                         _jax_tree(nu, JP.SceneParams), jnp.int32(7))
    j = JP.train_step.__wrapped__(
        js, j_opt, JP.init_stats(js), tuple(jnp.asarray(a) for a in arrays),
        jnp.asarray(target), jnp.zeros(3), small_cfg(JP, sh_degree=3), 3,
        statics)
    monkeypatch.setattr(torch.autograd, "grad", lambda *a, **k: [
        torch.from_numpy(g) for g in grads + [g_stats]])
    ts = _torch_tree(s, TP.SceneParams)
    t_opt = TP.AdamState(_torch_tree(mu, TP.SceneParams),
                         _torch_tree(nu, TP.SceneParams),
                         torch.tensor(7, dtype=torch.int32))
    t = TP.train_step(ts, t_opt, TP.init_stats(ts), arrays,
                      torch.from_numpy(target), torch.zeros(3), cfg_t, 3,
                      statics)
    for name in FIELDS:
        for jt, tt in ((j[0], t[0]), (j[1].mu, t[1].mu), (j[1].nu, t[1].nu)):
            np.testing.assert_allclose(getattr(tt, name).numpy(),
                                       np.asarray(getattr(jt, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    assert int(t[1].step) == int(j[1].step) == 8
    for name in JP.SceneStats._fields:
        np.testing.assert_allclose(getattr(t[2], name).numpy(),
                                   np.asarray(getattr(j[2], name)),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        TP.expon_lr(8.0, 0.002, 0.0002, 0.01, 30_000).item(),
        float(JP.expon_lr(jnp.float32(8.0), 0.002, 0.0002, 0.01, 30_000)),
        rtol=1e-6)


def _densify_inputs(rng, n, cap, hot, percent_dense=0.5):
    s = _state(rng, 1, n=n, cap=cap)
    s[6] = s[6].copy()
    s[6][:n] = True
    mu = [(rng.normal(size=a.shape)).astype(np.float32) for a in s[:-1]]
    nu = [(rng.uniform(size=a.shape)).astype(np.float32) for a in s[:-1]]
    ga = np.zeros(cap, np.float32)
    ga[:hot] = rng.uniform(0.5, 1.0, size=hot).astype(np.float32)
    denom = np.ones(cap, np.float32)
    denom[:n // 2] = 3.0
    radii = rng.uniform(0, 40, size=cap).astype(np.float32)
    return s, mu + [s[6]], nu + [s[6]], (ga, denom, radii)


@pytest.mark.parametrize("case", ["clone", "split", "grow", "prune_big"])
def test_densify_and_prune_matches_jax(case):
    """Identical numpy inputs and seed: the alive mask, the capacity and
    every row (1e-6 where quat_to_rotmat enters) of the scene and both
    moments; the statistics reset to zero."""
    rng = np.random.default_rng(11)
    n, cap, hot = {"clone": (50, 128, 10), "split": (50, 128, 20),
                   "grow": (120, 128, 100), "prune_big": (60, 128, 15)}[case]
    s, mu, nu, st = _densify_inputs(rng, n, cap, hot)
    s[3][:n][rng.uniform(size=n) < 0.2] = JP.inverse_sigmoid(0.001)
    extent = {"clone": 10.0, "split": 1e-3, "grow": 10.0,
              "prune_big": 0.5}[case]
    j = JP.densify_and_prune(
        _jax_tree(s, JP.SceneParams),
        JP.AdamState(_jax_tree(mu, JP.SceneParams),
                     _jax_tree(nu, JP.SceneParams), jnp.int32(300)),
        JP.SceneStats(*map(jnp.asarray, st)), small_cfg(JP, percent_dense=0.5),
        extent, prune_big=case == "prune_big", rng=np.random.default_rng(3))
    t = TP.densify_and_prune(
        _torch_tree(s, TP.SceneParams),
        TP.AdamState(_torch_tree(mu, TP.SceneParams),
                     _torch_tree(nu, TP.SceneParams), torch.tensor(300)),
        TP.SceneStats(*map(torch.from_numpy, st)),
        small_cfg(TP, percent_dense=0.5), extent,
        prune_big=case == "prune_big", rng=np.random.default_rng(3))
    alive_j = np.asarray(j[0].alive)
    np.testing.assert_array_equal(t[0].alive.numpy(), alive_j)
    # the surgery did something: rows died, or dead rows took new ones
    assert ((alive_j[:cap] != s[6])
            | (np.asarray(j[0].xyz)[:cap] != s[0]).any(1)).any()
    if case == "grow":
        assert t[0].xyz.shape[0] == 256
    for jt, tt in ((j[0], t[0]), (j[1].mu, t[1].mu), (j[1].nu, t[1].nu)):
        for name in FIELDS:
            a, b = np.asarray(getattr(jt, name)), getattr(tt, name).numpy()
            assert a.shape == b.shape, name
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)
    assert int(t[1].step) == 300
    for x in t[2]:
        assert x.shape == (t[0].xyz.shape[0],) and not bool(x.any())


def test_reset_opacity_matches_jax():
    rng = np.random.default_rng(4)
    s = _state(rng, 1)
    mu = [np.ones_like(a) for a in s[:-1]] + [s[6]]
    j = JP.reset_opacity(_jax_tree(s, JP.SceneParams),
                         JP.AdamState(_jax_tree(mu, JP.SceneParams),
                                      _jax_tree(mu, JP.SceneParams),
                                      jnp.int32(3)))
    t = TP.reset_opacity(_torch_tree(s, TP.SceneParams),
                         TP.AdamState(_torch_tree(mu, TP.SceneParams),
                                      _torch_tree(mu, TP.SceneParams),
                                      torch.tensor(3)))
    np.testing.assert_array_equal(t[0].opacity.numpy(),
                                  np.asarray(j[0].opacity))
    assert (torch.sigmoid(t[0].opacity) <= 0.0101).all()
    for m in (t[1].mu, t[1].nu):
        assert not bool(m.opacity.any()) and bool(m.xyz.all())


def _gt_views(rng, n_views=4, res=32):
    """tests/test_per_scene.py:test_psnr_improves's scene: 40 opaque-ish
    Gaussians seen from an orbit, rendered by the port."""
    cs = torch_cases.orbit_views(n_views)
    cams = [cs.camera(i, res, res, torch_cases.TAN, torch_cases.TAN)
            for i in range(n_views)]
    gt = list(torch_cases.make_gaussian_cloud(rng, 40, spread=0.25,
                                              scale_range=(0.05, 0.12)))
    gt[3][:] = 0.9
    with torch.no_grad():
        targets = torch.stack([TR.render(
            *[torch.from_numpy(a) for a in gt], cam, torch.zeros(3),
            pair_cap=1 << 12, max_per_tile=128, chunk=32)["render"]
            for cam in cams])
    return cams, gt, targets


def test_fit_scene_improves_psnr():
    """tests/test_per_scene.py:test_psnr_improves on the port: the loss
    falls and view 0's PSNR rises by 2 dB from a degraded init; the
    history holds every step's loss, each surgery and no truncated step."""
    rng = np.random.default_rng(0)
    cams, gt, targets = _gt_views(rng)
    init_pts = gt[0] + rng.normal(scale=0.05,
                                  size=gt[0].shape).astype(np.float32)
    init_cols = np.full((len(init_pts), 3), 0.5, np.float32)
    cfg = small_cfg(TP, iterations=120, densify_from_iter=30,
                    densification_interval=40, densify_until_iter=110)
    timings = {}
    scene, hist = TP.fit_scene(cams, targets, init_pts, init_cols, cfg,
                               log_every=40, timings=timings)
    assert len(hist["step_loss"]) == 120 and len(hist["loss"]) == 3
    assert hist["loss"][-1] == hist["step_loss"][-1]
    assert np.mean(hist["step_loss"][-20:]) < np.mean(hist["step_loss"][:20])
    assert [d["it"] for d in hist["densify"]] == [40, 80]
    assert hist["overflow_steps"] == 0
    assert set(timings) == {"init_s", "steps_s", "surgery_s"}
    s0 = TP.init_scene(init_pts, init_cols, cfg, device="cpu")
    with torch.no_grad():
        out0 = TP.render_scene(s0, cams[0], cfg, torch.zeros(3), 1)["render"]
        out1 = TP.render_scene(scene, cams[0], cfg, torch.zeros(3),
                               1)["render"]
    p0 = float(TL.psnr(out0[None], targets[0][None])[0])
    p1 = float(TL.psnr(out1[None], targets[0][None])[0])
    assert p1 > p0 + 2.0, (p0, p1)


def test_fit_scene_counts_overflowed_steps():
    """Caps too small for the scene: the steps train on (the JAX package's
    behaviour) and each truncated one is counted."""
    rng = np.random.default_rng(1)
    cams, gt, targets = _gt_views(rng, n_views=2)
    cfg = small_cfg(TP, iterations=6, densify_from_iter=100,
                    max_per_tile=16, chunk=16)
    scene, hist = TP.fit_scene(cams, targets, gt[0], np.full((40, 3), 0.5),
                               cfg, seed=2)
    assert hist["overflow_steps"] == 6
    assert all(np.isfinite(hist["step_loss"]))


@pytest.mark.parametrize("sizes", ["one_size", "two_sizes"])
def test_needed_caps_counts_exactly(sizes, monkeypatch):
    """needed_caps, with no binning, is the binning's own count: the pairs
    and the fullest tile of the alive rows, at most over the cameras; the
    per-tile occupancy equals bin_gaussians' tile_count tile by tile, and
    the footprints of all cameras of a size at once equal preprocess's at
    each.  With two sizes (one camera 48 x 32) it plans each size apart:
    one binning.footprint_need call a size.  A scene with no alive row
    needs nothing."""
    from f3d_gaus_torch.ops import binning as TB
    rng = np.random.default_rng(4)
    cams, gt, _ = _gt_views(rng, n_views=3)
    if sizes == "two_sizes":
        cams[1] = torch_cases.orbit_views(3).camera(1, 48, 32, torch_cases.TAN,
                                                    torch_cases.TAN)
    scene = TP.init_scene(gt[0], np.full((40, 3), 0.5), small_cfg(TP),
                          device="cpu")
    scene = scene._replace(alive=scene.alive & (torch.arange(
        scene.xyz.shape[0]) % 3 != 1))
    cfg = small_cfg(TP)
    pairs, tile = [], []
    for cam in cams:
        out = TP.render_scene(scene, cam, cfg._replace(pair_cap=1 << 14),
                              torch.zeros(3), 1)
        bng = out["binning"]
        pre = TG.preprocess(*[TP.activated(scene)[k] for k in (
            "xyz", "scaling", "rotation", "opacity", "shs")], 1, cam)
        occ = TB.tile_occupancy(pre.means2d, torch.where(
            scene.alive, pre.radii, 0), cam.width, cam.height)
        torch.testing.assert_close(occ, bng.tile_count, atol=0, rtol=0)
        pairs.append(int(bng.num_pairs))
        tile.append(int(bng.tile_count.max()))
    g = TP.activated(scene)
    same = [c for c in cams if c.width == cams[0].width]
    m2d, radii = TG.screen_footprints(
        g["xyz"], g["scaling"], g["rotation"],
        np.stack([c.world_view for c in same]),
        np.stack([c.full_proj for c in same]), cams[0])
    for v, cam in enumerate(same):       # bit for bit preprocess's
        pre = TG.preprocess(*[g[k] for k in ("xyz", "scaling", "rotation",
                                             "opacity", "shs")], 1, cam)
        assert torch.equal(m2d[v], pre.means2d)
        assert torch.equal(radii[v], pre.radii)
    calls = []
    footprint_need = TB.footprint_need
    monkeypatch.setattr(TB, "footprint_need", lambda *a, **k: (
        calls.append(a[5].width), footprint_need(*a, **k))[1])
    need = TP.needed_caps(scene, cams, cfg)
    assert sorted(calls) == ([32] if sizes == "one_size" else [32, 48])
    assert need == {"pairs": max(pairs), "tile": max(tile)}
    assert need["tile"] > 16
    none_alive = scene._replace(alive=torch.zeros_like(scene.alive))
    assert TP.needed_caps(none_alive, cams, cfg) == {"pairs": 0, "tile": 0}
    assert TP.CAP_HEADROOM == 2.0 and TP.plan_caps(need, cfg) == {
        "pair_cap": max(cfg.pair_cap, TB.suggest_pair_cap(2 * max(pairs))),
        "max_per_tile": max(cfg.max_per_tile,
                            -(-2 * max(tile) // 256) * 256)}


def test_planned_caps_truncate_no_step():
    """Caps too small for the scene (those of
    test_fit_scene_counts_overflowed_steps), planned: no step is
    truncated, each plan covers its need with the headroom, and the fit
    equals one at ample fixed caps (a render nothing truncates does not
    depend on its caps); two densifications and their replans included."""
    rng = np.random.default_rng(1)
    cams, gt, targets = _gt_views(rng, n_views=2)
    cfg = small_cfg(TP, iterations=24, densify_from_iter=5,
                    densification_interval=8, densify_until_iter=20,
                    max_per_tile=16, chunk=16)
    init = (gt[0], np.full((40, 3), 0.5))
    scene, hist = TP.fit_scene(cams, targets, *init, cfg, seed=2,
                               caps="plan")
    assert hist["overflow_steps"] == 0
    assert [c["it"] for c in hist["caps"]] == [0, 8, 16]
    assert [d["it"] for d in hist["densify"]] == [8, 16]
    for c in hist["caps"]:
        assert c["max_per_tile"] >= 2 * c["tile"] > 2 * 16
        assert c["pair_cap"] >= 2 * c["pairs"]
    assert hist["plan_s"] > 0
    ample = cfg._replace(pair_cap=1 << 14, max_per_tile=512)
    ref, ref_hist = TP.fit_scene(cams, targets, *init, ample, seed=2)
    assert ref_hist["overflow_steps"] == 0 and ref_hist["caps"] == []
    assert hist["step_loss"] == ref_hist["step_loss"]
    for a, b in zip(scene, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_gui_hook_renders_the_live_scene():
    """fit_scene polls the viewer every iteration with a render closure;
    a viewer camera equal to a training camera renders what render_scene
    renders there (tests/test_per_scene.py:TestNetworkGUIBridge)."""
    from f3d_gaus_torch.utils.network_gui import parse_request
    rng = np.random.default_rng(2)
    cams, gt, targets = _gt_views(rng, n_views=2)
    cam = cams[0]
    wv = np.asarray(cam.world_view, np.float32)
    fp = np.asarray(cam.full_proj, np.float32)
    vc = parse_request({
        "resolution_x": 32, "resolution_y": 32, "train": True,
        "fov_x": 2 * np.arctan(cam.tan_fovx),
        "fov_y": 2 * np.arctan(cam.tan_fovy), "z_near": 0.2, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False, "keep_alive": True,
        "scaling_modifier": 1.0,
        "view_matrix": (wv * np.array([1, -1, -1, 1], np.float32)
                        ).reshape(-1).tolist(),
        "view_projection_matrix": (fp * np.array([1, -1, 1, 1], np.float32)
                                   ).reshape(-1).tolist()})

    class Viewer:
        def __init__(self):
            self.images = []

        def poll(self, render_fn):
            self.images.append(render_fn(vc))

    gui = Viewer()
    cfg = small_cfg(TP, iterations=3, densify_from_iter=100)
    scene, _ = TP.fit_scene(cams, targets, gt[0], np.full((40, 3), 0.5), cfg,
                            gui=gui)
    assert len(gui.images) == 3 and gui.images[0].shape == (3, 32, 32)
    with torch.no_grad():
        ref = TP.render_scene(scene, cam, cfg, torch.zeros(3), 0)["render"]
    np.testing.assert_allclose(gui.images[-1], ref.numpy(), atol=1e-5)


def test_scene_checkpoint_round_trip(tmp_path):
    """(SceneParams, AdamState) with its step: saved and restored into the
    template's structure, values equal (tests/test_cli_eval.py:133-146)."""
    rng = np.random.default_rng(3)
    s = _torch_tree(_state(rng, 3), TP.SceneParams)
    opt = TP.init_adam(s)
    opt = opt._replace(mu=opt.mu._replace(xyz=torch.ones_like(s.xyz)),
                       step=torch.tensor(100, dtype=torch.int32))
    path = str(tmp_path / "scene" / "step_100")
    Tckpt.save(path, (s, opt))
    template = (TP.init_scene(np.zeros((1, 3), np.float32),
                              np.zeros((1, 3), np.float32),
                              small_cfg(TP, sh_degree=3), cap=128,
                              device="cpu"), TP.init_adam(s))
    back_s, back_opt = Tckpt.restore(path, template)
    assert isinstance(back_s, TP.SceneParams)
    for a, b in zip(list(s) + list(opt.mu) + list(opt.nu),
                    list(back_s) + list(back_opt.mu) + list(back_opt.nu)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(back_opt.step) == 100
    assert Tckpt.latest_step_dir(str(tmp_path / "scene")) == path
    with pytest.raises(ValueError, match="does not match"):
        Tckpt.restore(path, (TP.init_scene(
            np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
            small_cfg(TP, sh_degree=1), cap=128, device="cpu"), opt))
