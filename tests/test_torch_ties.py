"""The port's gradient where a clamp on a differentiable path sits exactly at
its bound, against the JAX package's.  jnp.maximum / jnp.minimum /
jnp.clip pass half the cotangent at such a tie; the port's clamps follow
them (core/device.py:max_tie, min_tie, clip_tie), and so does the
compositing backward csrc/raster_bwd.cu (held on the card in
tests/test_torch_cuda.py).

Each case builds an exact tie and holds the port's gradient to JAX's at
TIE_TOL x max|g| (the same f32 formulas on both sides; a clamp that passes
all or none of the cotangent at the tie misses by half of that term):
_chunk_eval with num = |b x Md|^2 identically 0 (zero qk rows) and with
AA = |Md|^2 identically 1e-12; composite_from_features on a feature table
whose qk rows are zero for a third of the Gaussians; preprocess with a
Gaussian on the frustum limit tx / tz = 1.3 tan_fovx and one at the z
floor tz = 1e-4; the SH colour with raw = 0; quat_normalize at |q| = eps.
The CLIP term's clip at recon in {0, 1} and a pixel-aligned render (one
Gaussian on each pixel-centre ray, as the predictor lays them out, where
num is exactly 0 on many pairs) are held at the JAX package's gradient
tolerance, 5e-3 x max|g|: their towers and compositing orders differ by
more than TIE_TOL (tests/test_torch_clip.py, test_torch_rasterize_grad.py).

|x| at x = 0: jnp.abs passes +g there (-0.0 included), torch.abs 0; the
port's |x| on a differentiable path is core/device.py:abs_tie, held here
against jax.grad(jnp.abs) and, at exact ties, through l1, tv, masked_l1,
the perceptual loss and the distortion term's form.  The norm at the zero
vector is the one known difference kept: torch.linalg.norm's gradient is
0 there, jnp.linalg.norm's NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.core import gaussians as JG
from f3d_gaus_tpu.core import quaternions as JQ
from f3d_gaus_tpu.core import sh as JSH
from f3d_gaus_tpu.models import clip as JC
from f3d_gaus_tpu.models import vgg as JV
from f3d_gaus_tpu.ops import rasterize as JR
from f3d_gaus_tpu.train import losses as JL
from f3d_gaus_tpu.train import per_scene as JPS
from f3d_gaus_torch.core import cameras as Tcam
from f3d_gaus_torch.core import gaussians as TG
from f3d_gaus_torch.core import quaternions as TQ
from f3d_gaus_torch.core import sh as TSH
from f3d_gaus_torch.core.device import abs_tie, clip_tie
from f3d_gaus_torch.models import clip as TC
from f3d_gaus_torch.models import convert as TConv
from f3d_gaus_torch.models import vgg as TV
from f3d_gaus_torch.ops import rasterize as TR
from f3d_gaus_torch.train import losses as TL
from f3d_gaus_torch.train import per_scene as TPS
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

TIE_TOL = 1e-6
GRAD_TOL = 5e-3     # tests/test_pallas_raster.py:51-53
CHUNK_OUTS = ("alpha_raw", "G", "t", "m", "nn")


def _close(got, want, tol, what):
    want = np.asarray(want)
    assert np.isfinite(got).all(), what
    scale = np.abs(want).max()
    assert scale > 0, f"{what}: zero gradient"
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _chunk_case(kind, seed=0, T=2, C=8, npix=16):
    """(feat_c (T, C, NFEAT), u, v (T, npix)) with num = 0 on every ray
    (kind 'num_zero': zero qk rows) or AA = 1e-12 on every ray ('AA_tie':
    qa = (0, 0, 0, 0, 0, 1e-12), with num and BB scaled so that mv and t
    stay O(1))."""
    rng = np.random.default_rng(seed)
    f = np.zeros((T, C, TR.NFEAT), np.float32)
    u = rng.uniform(-0.3, 0.3, (T, npix)).astype(np.float32)
    v = rng.uniform(-0.3, 0.3, (T, npix)).astype(np.float32)
    t = rng.uniform(0.5, 5.0, (T, C))
    if kind == "num_zero":
        f[..., TR.ROW_QA:TR.ROW_QA + 6] = (
            np.array([1, 0, 1, 0, 0, 1]) + 0.1 * rng.normal(size=(T, C, 6)))
        f[..., TR.ROW_B:TR.ROW_B + 2] = 0.1 * rng.normal(size=(T, C, 2))
        f[..., TR.ROW_B + 2] = -t
    else:
        f[..., TR.ROW_QA + 5] = 1e-12
        f[..., TR.ROW_QK + 5] = 1e-13 * rng.uniform(0.5, 2.0, (T, C))
        f[..., TR.ROW_B + 2] = -1e-12 * t
    f[..., TR.ROW_RGB:TR.ROW_RGB + 3] = rng.uniform(0, 1, (T, C, 3))
    f[..., TR.ROW_OPA] = rng.uniform(0.2, 0.9, (T, C))
    return f, u, v


def _chunk_weights(seed, T, npix, C):
    rng = np.random.default_rng(seed)
    w = {k: rng.normal(size=(T, npix, C)).astype(np.float32)
         for k in CHUNK_OUTS[:-1]}
    w["nn"] = rng.normal(size=(T, npix, C, 3)).astype(np.float32)
    return w


@pytest.mark.parametrize("kind", ["num_zero", "AA_tie"])
def test_chunk_eval_gradient_at_the_clamp_ties(kind):
    """The pull-back of _chunk_eval through max(num, 0) at num = 0 and
    max(AA, 1e-12) at AA = 1e-12 (rasterize.py:_chunk_eval, the JAX
    package's rasterize.py:184-185): JAX passes half."""
    f, u, v = _chunk_case(kind)
    w = _chunk_weights(1, *u.shape, f.shape[1])
    # the tie is exact: the forms evaluate to their bound on every ray
    ft, ut, vt = (torch.from_numpy(a) for a in (f, u, v))
    U, V = ut[..., None], vt[..., None]
    rows = TR.ROW_QK if kind == "num_zero" else TR.ROW_QA
    q = [ft[:, None, :, rows + i] for i in range(6)]
    form = (q[0] * U + q[1] * V + q[3]) * U + (q[2] * V + q[4]) * V + q[5]
    bound = 0.0 if kind == "num_zero" else float(np.float32(1e-12))
    assert (form == bound).all()

    def jloss(fj):
        out = JR._chunk_eval(fj, jnp.asarray(u), jnp.asarray(v))
        return sum(jnp.sum(out[k] * w[k]) for k in CHUNK_OUTS)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(f)))
    ft.requires_grad_()
    out = TR._chunk_eval(ft, ut, vt)
    sum((out[k] * torch.from_numpy(w[k])).sum() for k in CHUNK_OUTS).backward()
    got = ft.grad.numpy()
    _close(got[..., rows:rows + 6], want[..., rows:rows + 6], TIE_TOL,
           f"{kind}: the clamped form's rows")
    _close(got, want, TIE_TOL, f"{kind}: every row")


def _crafted_table(seed=0):
    """The 96-Gaussian 32^2 case's prepared inputs with the qk rows of
    every third Gaussian zeroed (num = 0 on each of its rays): the feature
    table, the conic | means2d table, the binning, statics and bg."""
    name, cam, cloud, bg, kw = torch_cases.small_cases(seed)[0]
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)
    feat = torch_cases.zero_qk(inp.feat.detach())
    extra = inp.extra.detach()
    return feat, extra, inp.binning, inp.statics, inp.bg


def test_composite_from_features_at_zero_qk_rows():
    """composite_from_features on a table with zero qk rows against the
    JAX package's XLA composite_from_features (rasterize.py:556): out9 at
    1e-5, the feature-row and stats gradients at TIE_TOL x max|g|."""
    feat, extra, b, s, bg = _crafted_table()
    P = feat.shape[0]
    w = np.random.default_rng(2).normal(size=(s.grid_x * s.grid_y, TR.PIX, 9))
    w[..., 7] = 0.0
    w = w.astype(np.float32)
    js = JR.RasterStatics(s.width, s.height, s.grid_x, s.grid_y, s.focal_x,
                          s.focal_y, s.max_per_tile, s.chunk, lanes=s.lanes)
    allf = np.concatenate([torch.cat([feat, extra], 1).numpy(),
                           np.zeros((1, TR.NFEAT + 5), np.float32)], 0)
    slab = [jnp.asarray(x.numpy()) for x in (b.point_list, b.tile_start,
                                             b.tile_count, bg)]

    def jloss(a, st):
        out, _ = JR.composite_from_features(a, st, *slab, 0, js)
        return jnp.sum(out * w), out
    (_, jout), (ga, gs) = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jnp.asarray(allf), jnp.zeros((P, 3), jnp.float32))
    ft = feat.clone().requires_grad_()
    st = torch.zeros((P, 3), requires_grad=True)
    out, _ = TR.composite_from_features(ft, extra, b, s, bg, "torch", st)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    want = np.asarray(ga)[:P, :TR.NFEAT]
    qk = slice(TR.ROW_QK, TR.ROW_QK + 6)
    _close(ft.grad.numpy()[::3, qk], want[::3, qk], TIE_TOL,
           "the zero qk rows")
    _close(ft.grad.numpy(), want, TIE_TOL, "d feat")
    _close(st.grad.numpy(), np.asarray(gs), TIE_TOL, "d stats")


def _num_ties(inp):
    """Window pairs that pass the decision (t > 0.2, alpha >= 1/255) and
    whose num = |b x Md|^2 evaluates to exactly 0 in the plain f32 version,
    and the passing pairs in all."""
    feat = inp.feat.detach()
    b, s = inp.binning, inp.statics
    _, valid, wall, n = TR._windows(feat, b.point_list, b.tile_start,
                                    b.tile_count, s)
    u, v = TR._tile_rays(s, "cpu")
    U, V = u[..., None], v[..., None]
    ties = passing = 0
    for ci in range(n):
        sl = slice(ci * s.chunk, (ci + 1) * s.chunk)
        f = wall[:, sl, :TR.NFEAT]
        q = [f[:, None, :, TR.ROW_QK + i] for i in range(6)]
        num = (q[0] * U + q[1] * V + q[3]) * U + (q[2] * V + q[4]) * V + q[5]
        ok = TR._decide(TR._chunk_eval(f, u, v), valid[:, sl])
        ties += int((ok & (num == 0.0)).sum())
        passing += int(ok.sum())
    return ties, passing


def test_pixel_aligned_render_gradients_match_jax():
    """One Gaussian on each pixel-centre ray of a 32^2 canonical camera
    (the predictor's layout): num is exactly 0 on many passing pairs, so
    the clamp's share is taken there; the render's gradients to the five
    inputs against JAX's render(backend="xla") at GRAD_TOL x max|g|."""
    cam, cloud = torch_cases.pixel_aligned(np.random.default_rng(5), 32)
    kw = dict(pair_cap=1 << 15, max_per_tile=1024, chunk=128)
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     device="cpu", **kw)
    ties, passing = _num_ties(inp)
    assert 0 < ties < passing, (ties, passing)
    w9 = np.random.default_rng(6).normal(size=(9, 32, 32)).astype(np.float32)
    w9[7] = 0.0
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(*a):
        out = JR.render(*a, cam, jnp.asarray(bg), backend="xla", **kw)
        return jnp.sum(out["out9"] * w9)
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in cloud])
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    out = TR.render(*ts, cam, torch.from_numpy(bg), **kw)
    assert not bool(out["overflow"])
    (out["out9"] * torch.from_numpy(w9)).sum().backward()
    for name, t, r in zip(("means", "scales", "quats", "opacities", "shs"),
                          ts, want):
        _close(t.grad.numpy(), r, GRAD_TOL, name)


@pytest.mark.parametrize("where", ["frustum_x", "frustum_y", "z_floor"])
def test_cov2d_gradient_at_its_clamps(where):
    """preprocess's EWA step (core/gaussians.py:cov2d_and_coef, the JAX
    package's :191-193) with Gaussians exactly on a clamp's bound, for an
    identity world-to-view matrix (the view-space mean is the input, bit
    for bit): tx / tz = 1.3 tan_fovx, ty / tz = -1.3 tan_fovy at tz = 2
    (the division exact), and tz = 1e-4, the z floor.  d(sum of cov2d and
    coef x seeded weights) to the means at TIE_TOL x max|g|.  (Through the
    whole preprocess the z floor's share is lost in the rounding of the
    projection at z = 1e-4: conic ~ 1e-10 there.)"""
    tan = torch_cases.TAN
    focal = 32 / (2 * tan)
    rng = np.random.default_rng(9)
    n = 8
    means = np.zeros((n, 3), np.float32)
    means[:, 0] = rng.uniform(-0.1, 0.1, n)
    means[:, 1] = rng.uniform(-0.1, 0.1, n)
    means[:, 2] = 2.0
    lim = np.float32(1.3 * tan)
    if where == "frustum_x":
        means[::2, 0] = 2.0 * lim
    elif where == "frustum_y":
        means[::2, 1] = -2.0 * lim
    else:
        means[::2, 2] = np.float32(1e-4)
    a = rng.normal(size=(n, 3, 3)) * 0.03
    cov = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(3)
    cov6 = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)
    wv = np.eye(4, dtype=np.float32)
    w = rng.normal(size=(n, 4)).astype(np.float32)

    def jloss(m):
        c2, coef = JG.cov2d_and_coef(m, jnp.asarray(cov6), jnp.asarray(wv),
                                     focal, focal, tan, tan, 0.1)
        return jnp.sum(c2 * w[:, :3]) + jnp.sum(coef * w[:, 3])
    want = jax.grad(jloss)(jnp.asarray(means))
    mt = torch.from_numpy(means).requires_grad_()
    c2, coef = TG.cov2d_and_coef(mt, torch.from_numpy(cov6), wv, focal, focal,
                                 tan, tan, 0.1)
    ((c2 * torch.from_numpy(w[:, :3])).sum()
     + (coef * torch.from_numpy(w[:, 3])).sum()).backward()
    _close(mt.grad.numpy(), want, TIE_TOL, f"{where} d/dmeans")

def _sh_zero_dc():
    """An SH DC coefficient c whose colour SH_C0 c + 0.5 is exactly 0 in
    f32 in both packages (eval_sh adds the 0.5), among the f32 neighbours
    of -0.5 / SH_C0."""
    c0 = np.float32(-0.5 / TSH.SH_C0)
    d = np.zeros((1, 3), np.float32)
    for k in sorted(range(-32, 33), key=abs):
        c = (c0.view(np.int32) + k).view(np.float32)
        shs = np.full((1, 1, 3), c, np.float32)
        raw_j = np.asarray(JSH.eval_sh(0, jnp.asarray(shs), jnp.asarray(d)))
        raw_t = TSH.eval_sh(0, torch.from_numpy(shs), torch.from_numpy(d))
        if (raw_j == 0).all() and (raw_t == 0).all():
            return c
    pytest.fail("no f32 DC coefficient gives raw == 0 in both packages")


def test_sh_color_gradient_at_zero():
    """The SH colour's clamp max(raw, 0) at raw == 0 (core/sh.py, the JAX
    package's :74) on a mix of tied and untied Gaussians."""
    rng = np.random.default_rng(11)
    n = 6
    shs = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    shs[::2, 0, :] = _sh_zero_dc()
    shs[::2, 1:, :] = 0.0
    means = rng.normal(size=(n, 3)).astype(np.float32) + 3.0
    campos = np.zeros(3, np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)

    def jloss(s, m):
        rgb, _ = JSH.sh_color_from_gaussians(1, s, m, jnp.asarray(campos))
        return jnp.sum(rgb * w)
    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(shs),
                                           jnp.asarray(means))
    ts, tm = (torch.from_numpy(a).requires_grad_() for a in (shs, means))
    rgb, clamped = TSH.sh_color_from_gaussians(1, ts, tm,
                                               torch.from_numpy(campos))
    assert (rgb.detach()[::2] == 0).all() and not clamped[::2].any()
    (rgb * torch.from_numpy(w)).sum().backward()
    _close(ts.grad.numpy(), want[0], TIE_TOL, "d shs")
    _close(tm.grad.numpy(), want[1], TIE_TOL, "d means")


def test_quat_normalize_gradient_at_eps():
    """quat_normalize(q, eps) at |q| == eps (a power of two, so the norm
    is exact)."""
    q = np.array([[0.5, 0, 0, 0], [0.3, -0.4, 0.2, 0.1], [0, 0, 0.5, 0]],
                 np.float32)
    w = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JQ.quat_normalize(a, 0.5) * w))(
        jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_()
    (TQ.quat_normalize(qt, 0.5) * torch.from_numpy(w)).sum().backward()
    _close(qt.grad.numpy(), want, TIE_TOL, "d q")


@pytest.fixture(scope="module")
def clip_towers():
    from tests.test_torch_clip import _synth_state_dict
    sd = _synth_state_dict()
    port = TC.CLIPVisual(2, torch.Generator())
    port.load_state_dict({k[len("visual."):]: v for k, v in sd.items()})
    port.eval()
    jparams = JC.convert_torch_clip_visual(
        {k: v.numpy() for k, v in sd.items()})
    return port, jparams


def test_clip_term_gradient_at_saturated_pixels(clip_towers):
    """The CLIP term's clip of the render to [0, 1] (train/feedforward.py
    loss_fn, the JAX package's :199) on a render whose pixels are a third
    exactly 0 and a third exactly 1: the gradient to the render against
    JAX's at GRAD_TOL x max|g|.  torch.clamp, which passes the whole
    cotangent at the bounds, misses by far more."""
    port, jparams = clip_towers
    rng = np.random.default_rng(13)
    x = rng.uniform(0.05, 0.95, (1, 3, 64, 64)).astype(np.float32)
    pick = rng.integers(0, 3, x.shape)
    x[pick == 0] = 0.0
    x[pick == 1] = 1.0
    y = rng.uniform(0, 1, x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: JC.clip_loss(
        jparams, jnp.clip(a, 0.0, 1.0), jnp.asarray(y), resize_to=64))(
        jnp.asarray(x)))
    grads = []
    for clamp in (lambda a: clip_tie(a, 0.0, 1.0),
                  lambda a: a.clamp(0.0, 1.0)):
        xt = torch.from_numpy(x).requires_grad_()
        TC.clip_loss(port, clamp(xt), torch.from_numpy(y),
                     resize_to=64).backward()
        grads.append(xt.grad.numpy())
    _close(grads[0], want, GRAD_TOL, "clip_tie")
    assert np.abs(grads[1] - want).max() > 10 * GRAD_TOL * np.abs(want).max()


# --- |x| at x = 0 (abs_tie) ---------------------------------------------

def test_abs_tie_gradient_is_jax_abs():
    """abs_tie's gradient at (-1, -0.0, 0.0, 2) is jax.grad(jnp.abs)'s,
    exactly: (-1, 1, 1, 1); torch.abs gives (-1, 0, 0, 1).  Its value is
    |x|, +0.0 at -0.0 as jnp.abs."""
    x = np.array([-1.0, -0.0, 0.0, 2.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jnp.abs))(jnp.asarray(x)))
    np.testing.assert_array_equal(want, [-1.0, 1.0, 1.0, 1.0])
    t = torch.from_numpy(x).requires_grad_()
    y = abs_tie(t)
    y.sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)
    np.testing.assert_array_equal(y.detach().numpy(), np.abs(x))
    assert not np.signbit(y.detach().numpy()).any()


def _loss_at_ties(name, rng):
    """(JAX loss, port loss, inputs) with every argument of |.| or a known
    share of them exactly 0."""
    if name == "l1":
        a = rng.uniform(size=(2, 3, 8, 8)).astype(np.float32)
        return JL.l1, TL.l1, (a, a.copy())
    if name == "tv":           # two flat halves: only the seam is not a tie
        x = np.zeros((4, 4), np.float32)
        x[:, 2:] = 1.5
        return JL.tv, TL.tv, (x,)
    a = rng.uniform(size=(2, 3, 8, 8)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, 8, 8)) < 0.5
    return (lambda p, q: JL.masked_l1(p, q, jnp.asarray(mask)),
            lambda p, q: TL.masked_l1(p, q, torch.from_numpy(mask)),
            (a, a.copy()))


@pytest.mark.parametrize("name", ["l1", "tv", "masked_l1"])
def test_loss_gradient_at_abs_ties(name):
    """The losses of train/losses.py where |a - b| is exactly 0: the
    gradient to every input against JAX's at TIE_TOL (absolute; each is
    +-1/N or a mask share).  With torch.abs l1(a, a)'s gradient is 0
    where JAX's is 1/384; tv's of a 4x4 map with two flat halves misses by
    up to 1/6 at the corners; masked_l1(a, a, mask)'s is 0 where JAX's is
    mask/sum(mask)."""
    jloss, tloss, inputs = _loss_at_ties(name, np.random.default_rng(21))
    want = jax.grad(jloss, argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(a) for a in inputs])
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    tloss(*ts).backward()
    for i, (t, w) in enumerate(zip(ts, want)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, f"{name}: input {i}"
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=TIE_TOL,
                                   err_msg=f"{name}: input {i}")


def test_perceptual_gradient_at_equal_images():
    """vgg.perceptual_loss(x, x) through the VGG16 tower with seeded weights
    (the JAX package's init_params, carried by convert.vgg_from_jax) at
    32^2: every tap difference is 0, and on the taps whose pre-ReLU value
    is positive JAX passes +1/N.  The gradient to x against JAX's at
    GRAD_TOL x max|g|; with torch.abs it is 0."""
    jparams = JV.init_params(jax.random.PRNGKey(3))
    vgg = TV.VGG16(torch.Generator())
    vgg.load_state_dict(TConv.vgg_from_jax(jparams))
    vgg.eval().requires_grad_(False)
    x = np.random.default_rng(22).uniform(size=(1, 3, 32, 32)).astype(
        np.float32)
    want = jax.grad(lambda a: JV.perceptual_loss(jparams, a, jnp.asarray(x)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    TV.perceptual_loss(vgg, xt, torch.from_numpy(x)).backward()
    _close(xt.grad.numpy(), want, GRAD_TOL, "d x")


def test_distortion_term_gradient_with_one_contributor_pixels():
    """The distortion term's form, |distortion_map|.mean() (feedforward.py
    loss_fn), of a 32^2 render of 24 Gaussians at spread depths: about a
    third of the covered pixels have one contributor and a distortion of
    exactly 0.  Its gradient to the five inputs against JAX's render
    (backend="xla") at GRAD_TOL x max|g|.

    This case passes with torch.abs too: the distortion is
    sum w_i w_j (m_i - m_j)^2 >= 0, so where it is 0 its Jacobian is 0 but
    for rounding, and abs_tie adds only that residue of the backward's
    m (1 - T_final) - dist1.  The map is ill-conditioned in f32 (values
    about 1e-5 from differences of terms about 1): on the 96-Gaussian
    parity scenes of torch_cases.setup the two packages' gradients of this
    term alone miss GRAD_TOL x max|g|, with torch.abs or abs_tie alike
    (ROADMAP)."""
    rng = np.random.default_rng(0)
    cam = torch_cases.orbit_camera(32, 32)
    cloud = torch_cases.make_gaussian_cloud(rng, 24, spread=0.8,
                                            scale_range=(0.05, 0.15))
    cloud[0][:, :2] *= 0.3
    kw = dict(pair_cap=1 << 13, max_per_tile=512, chunk=32)
    bg = np.zeros(3, np.float32)

    def jloss(*a):
        out = JR.render(*a, cam, jnp.asarray(bg), backend="xla", **kw)
        return jnp.abs(out["distortion_map"]).mean()
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *[jnp.asarray(a) for a in cloud])
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    out = TR.render(*ts, cam, torch.from_numpy(bg), **kw)
    assert not bool(out["overflow"])
    dist = out["distortion_map"].detach()
    covered = out["rendered_alpha"].detach() > 0
    assert int((covered & (dist == 0)).sum()) > 0.2 * int(covered.sum())
    abs_tie(out["distortion_map"]).mean().backward()
    for name, t, r in zip(("means", "scales", "quats"), ts, want):
        _close(t.grad.numpy(), r, GRAD_TOL, name)
    for t, r in zip(ts[3:], want[3:]):     # no path from opacity or colour
        assert not t.grad.abs().any() and not np.abs(np.asarray(r)).any()


# --- the norm at the zero vector ------------------------------------------

def _site_norm(site):
    """(port, JAX) functions of a (2, k) array whose row 0 is the zero
    vector: the site's normalisation with its torch.linalg.norm /
    jnp.linalg.norm call, and k."""
    if site == "quaternions.py:quat_normalize":
        return (lambda q: TQ.quat_normalize(q, 1e-8),
                lambda q: JQ.quat_normalize(q, 1e-8), 4)
    if site == "per_scene.py:activated":
        def scene(mod, rot, xp):
            z = xp.zeros((2, 3), dtype=xp.float32)
            rest = xp.zeros((2, 0, 3), dtype=xp.float32)
            return mod.SceneParams(z, z[:, None], rest, z[:, :1], z, rot, None)
        return (lambda q: TPS.activated(scene(TPS, q, torch))["rotation"],
                lambda q: JPS.activated(scene(JPS, q, jnp))["rotation"], 4)
    k = 4 if site == "predictor.py:forward" else 512
    return (lambda x: x / torch.linalg.norm(x, dim=-1, keepdim=True),
            lambda x: x / jnp.linalg.norm(x, axis=-1, keepdims=True), k)


@pytest.mark.parametrize("site", ["predictor.py:forward", "clip.py:encode_image",
                                  "quaternions.py:quat_normalize",
                                  "per_scene.py:activated"])
def test_norm_gradient_at_the_zero_vector(site):
    """Kept, not repaired: torch.linalg.norm's gradient at the zero vector
    is 0 where jnp.linalg.norm's is NaN; copying a NaN helps nobody.  At
    each site of the norm the norm's own gradient there is 0 in the port
    and NaN in JAX.  Where the site stays finite at the zero vector
    (quat_normalize with an eps, per_scene's +1e-12) so does the port's
    gradient of it, while JAX's is NaN; the predictor's rotation and the
    CLIP embedding divide 0 by 0 in both packages.  On a nonzero row the
    two agree to 1e-5."""
    port, jfn, k = _site_norm(site)
    rng = np.random.default_rng(23)
    x = np.zeros((2, k), np.float32)
    x[1] = rng.normal(size=k)
    w = rng.normal(size=(2, k)).astype(np.float32)

    jn = jax.grad(lambda a: jnp.sum(jnp.linalg.norm(a, axis=-1)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.linalg.norm(xt, dim=-1, keepdim=True).sum().backward()
    assert np.isnan(np.asarray(jn)[0]).all()
    assert not xt.grad[0].any()

    want = np.asarray(jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(w)).sum().backward()
    got = xt.grad.numpy()
    assert np.isnan(want[0]).all()
    finite_site = site in ("quaternions.py:quat_normalize",
                           "per_scene.py:activated")
    assert np.isfinite(got[0]).all() == finite_site
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=1e-5 * np.abs(want[1]).max())
