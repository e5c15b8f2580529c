"""f3d_gaus_torch.core against f3d_gaus_tpu.core on the same numpy inputs:
preprocess values at 1e-5 of max |ref| with radii exactly equal, SH
evaluation, quaternions and the numpy camera copy (bit-equal); and the
gradients of preprocess's render-facing outputs, of the degree-1 SH
rotation and of rotmat_to_quat (5e-3 x max |g|)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.core import cameras as Jcam
from f3d_gaus_tpu.core import gaussians as JG
from f3d_gaus_tpu.core import quaternions as JQ
from f3d_gaus_tpu.core import sh as JSH
from f3d_gaus_tpu.models import predictor as JP
from f3d_gaus_torch.core import cameras as Tcam
from f3d_gaus_torch.core import gaussians as TG
from f3d_gaus_torch.core import quaternions as TQ
from f3d_gaus_torch.core import sh as TSH
from tests.conftest import make_gaussian_cloud
from tests.test_rasterize_parity import _setup

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(a).max() + 1e-12)


@pytest.mark.parametrize("n,width", [(96, 32), (2048, 64), (48, 2560)])
def test_preprocess_matches_jax(n, width):
    cam, cloud = _setup(np.random.default_rng(n), n=n, width=width)
    pj = JG.preprocess(*[jnp.asarray(a) for a in cloud], 1, cam)
    pt = TG.preprocess(*[torch.from_numpy(a) for a in cloud], 1, cam,
                       compute_v2g=True)
    for f in pj._fields:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            assert _rel(a, b) <= 1e-5, f


def test_preprocess_small_camera(gaussian_cloud, small_camera):
    """The conftest camera (rebased orbit view) with culled points mixed in:
    a third of the cloud is moved behind the camera."""
    cloud = [a.copy() for a in gaussian_cloud]
    cloud[0][::3, 2] = -3.0
    pj = JG.preprocess(*[jnp.asarray(a) for a in cloud], 1, small_camera)
    pt = TG.preprocess(*[torch.from_numpy(a) for a in cloud], 1, small_camera)
    np.testing.assert_array_equal(pt.radii.numpy(), np.asarray(pj.radii))
    assert (pt.radii.numpy()[::3] == 0).all()
    for f in ("means2d", "conic", "opa_coef", "rgb", "v2g_mb", "depths"):
        assert _rel(getattr(pj, f), getattr(pt, f).numpy()) <= 1e-5, f


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    shs = rng.normal(size=(200, (deg + 1) ** 2, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    a = JSH.eval_sh(deg, jnp.asarray(shs), jnp.asarray(dirs))
    b = TSH.eval_sh(deg, torch.from_numpy(shs), torch.from_numpy(dirs))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


def test_sh_color_at_camera_is_finite():
    """A Gaussian AT the camera center keeps a finite color (smoothed norm)."""
    means, _, _, _, shs = make_gaussian_cloud(np.random.default_rng(1), 8)
    campos = means[3].copy()
    a, ca = JSH.sh_color_from_gaussians(1, jnp.asarray(shs), jnp.asarray(means),
                                        jnp.asarray(campos))
    b, cb = TSH.sh_color_from_gaussians(1, torch.from_numpy(shs),
                                        torch.from_numpy(means),
                                        torch.from_numpy(campos))
    assert torch.isfinite(b).all()
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(ca))


def test_quaternions_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(64, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(TQ.quat_multiply(ta, tb).numpy(),
                               np.asarray(JQ.quat_multiply(a, b)), atol=1e-6)
    np.testing.assert_allclose(TQ.quat_to_rotmat(ta).numpy(),
                               np.asarray(JQ.quat_to_rotmat(a)), atol=1e-5)
    np.testing.assert_allclose(TQ.quat_normalize(ta).numpy(),
                               np.asarray(JQ.quat_normalize(a)), atol=1e-6)
    R = TQ.quat_to_rotmat(TQ.quat_normalize(ta))
    np.testing.assert_allclose((R @ R.transpose(1, 2)).numpy(),
                               np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5)


def test_camera_copy_is_bit_equal():
    cj, ij = Jcam.canonical_camera_set(13.164, 7.667, 7.667, 6.667, 8.667)
    ct, it = Tcam.canonical_camera_set(13.164, 7.667, 7.667, 6.667, 8.667)
    np.testing.assert_array_equal(it, ij)
    for x, y in zip(cj, ct):
        np.testing.assert_array_equal(y, np.asarray(x))
    oj = Jcam.orbit_camera_set(129, 13.164, 7.667, 7.667, 6.667, 8.667,
                               rebase=ij)
    ot = Tcam.orbit_camera_set(129, 13.164, 7.667, 7.667, 6.667, 8.667,
                               rebase=it)
    for x, y in zip(oj, ot):
        np.testing.assert_array_equal(y, np.asarray(x))


PRE_FIELDS = ("v2g_mb", "rgb", "opa_coef", "means2d", "conic")


def _preprocess_grads(cloud, cam, weights):
    """d(sum over PRE_FIELDS of field * weight) / d(means, scales, quats,
    opacities, shs) through preprocess, in JAX and in the port."""
    def jloss(*a):
        pre = JG.preprocess(*a, 1, cam)
        return sum(jnp.sum(getattr(pre, f) * weights[f]) for f in PRE_FIELDS)
    gj = jax.grad(jloss, argnums=tuple(range(5)))(*[jnp.asarray(a) for a in cloud])
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    pre = TG.preprocess(*ts, 1, cam)
    sum((getattr(pre, f) * torch.from_numpy(weights[f])).sum()
        for f in PRE_FIELDS).backward()
    return [np.asarray(g) for g in gj], [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("culled", [False, True])
def test_preprocess_grads_match_jax(culled):
    """Gradients of a seeded weighted sum of v2g_mb, rgb, opa_coef, means2d
    and conic with respect to the five inputs, at 5e-3 x max |g| (the JAX
    package's gradient tolerance).  With `culled`, a third of the cloud
    sits behind the camera, where the z floor of cov2d_and_coef keeps the
    gradients finite."""
    cam, cloud = _setup(np.random.default_rng(7), n=96)
    cloud = [a.copy() for a in cloud]
    if culled:
        cloud[0][::3, 2] = -3.0
    rng = np.random.default_rng(8)
    n = cloud[0].shape[0]
    weights = {f: rng.normal(size=s).astype(np.float32) for f, s in (
        ("v2g_mb", (n, 12)), ("rgb", (n, 3)), ("opa_coef", (n,)),
        ("means2d", (n, 2)), ("conic", (n, 3)))}
    ref, got = _preprocess_grads(cloud, cam, weights)
    for name, r, g in zip(("means", "scales", "quats", "opacities", "shs"),
                          ref, got):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=5e-3 * np.abs(r).max(), err_msg=name)


def _grad_close(got, want, what):
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.abs(want).max() > 0, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=5e-3 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("jax_copy", ["core.sh", "models.predictor"])
def test_transform_shs_deg1_matches_jax(jax_copy):
    """core/sh.py:transform_shs_deg1 (the port's one definition; its
    predictor calls it) against each of the JAX package's two copies:
    values at 1e-5 of max |ref|, and the gradients of a seeded weighted sum
    to the coefficients and the camera matrix."""
    jfn = (JSH.transform_shs_deg1 if jax_copy == "core.sh"
           else JP.transform_shs_deg1)
    rng = np.random.default_rng(31)
    shs = rng.normal(size=(2, 40, 3, 3)).astype(np.float32)
    q = rng.normal(size=(2, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    c2w = np.zeros((2, 4, 4), np.float32)
    c2w[:, :3, :3] = np.asarray(JQ.quat_to_rotmat(q))
    c2w[:, 3, :3] = rng.normal(size=(2, 3))
    c2w[:, 3, 3] = 1.0
    w = rng.normal(size=shs.shape).astype(np.float32)
    want = jfn(jnp.asarray(shs), jnp.asarray(c2w))
    gj = jax.grad(lambda a, b: jnp.sum(jfn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(shs), jnp.asarray(c2w))
    ts, tc = (torch.from_numpy(shs).requires_grad_(),
              torch.from_numpy(c2w).requires_grad_())
    got = TSH.transform_shs_deg1(ts, tc)
    assert _rel(want, got.detach().numpy()) < 1e-5
    (got * torch.from_numpy(w)).sum().backward()
    _grad_close(ts.grad.numpy(), gj[0], "d features_rest")
    _grad_close(tc.grad.numpy(), gj[1], "d cam_to_world")
    np.testing.assert_array_equal(TSH.V_TO_SH.numpy(), np.asarray(JSH.V_TO_SH))
    np.testing.assert_array_equal(TSH.SH_TO_V.numpy(), np.asarray(JSH.SH_TO_V))


def _rotations(rng):
    """(R (n, 3, 3), branch (n,)): rotations that take each of the four
    cases of rotmat_to_quat.  1 + trace = 2 + 2 cos(angle) is positive for
    every turn short of 180 degrees (case 0); the 180-degree turns about
    x, y and z and about axes tilted from them take cases 1-3 (m00, m11,
    m22 dominant)."""
    qs = [[1, 0.1, -0.2, 0.05], [1, -0.3, 0.2, 0.1],
          [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    for axis in np.eye(3):
        a = axis + 0.2 * rng.normal(size=3)
        qs.append([0.0, *(a / np.linalg.norm(a))])
    q = np.asarray(qs, np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    R = np.array(JQ.quat_to_rotmat(q), np.float32)
    return R, np.array([0, 0, 1, 2, 3, 1, 2, 3])


def test_rotmat_to_quat_matches_jax():
    """core/quaternions.py:rotmat_to_quat against the JAX package's on
    rotations that take each of its four branches (checked), 180-degree
    turns included: values at 1e-5, and the gradient of a seeded weighted
    sum to the matrix at 5e-3 x max |g|."""
    R, branch = _rotations(np.random.default_rng(32))
    tr = 1.0 + R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    took = np.where(tr > 0, 0, np.where(
        (R[:, 0, 0] > R[:, 1, 1]) & (R[:, 0, 0] > R[:, 2, 2]), 1,
        np.where(R[:, 1, 1] > R[:, 2, 2], 2, 3)))
    np.testing.assert_array_equal(took, branch)
    w = np.random.default_rng(33).normal(size=(len(R), 4)).astype(np.float32)
    want = np.asarray(JQ.rotmat_to_quat(jnp.asarray(R)))
    gj = jax.grad(lambda m: jnp.sum(JQ.rotmat_to_quat(m) * w))(jnp.asarray(R))
    rt = torch.from_numpy(R).requires_grad_()
    got = TQ.rotmat_to_quat(rt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), Tcam.rotmat_to_quat(R),
                               rtol=0, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    _grad_close(rt.grad.numpy(), gj, "d m")
