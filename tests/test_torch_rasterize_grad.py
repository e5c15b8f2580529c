"""Gradients of the port's render (the plain compositing backward on CPU
tensors, rasterize._composite_bwd_impl under the autograd Function)
against the JAX package's render(backend="xla") and render(backend=
"pallas", interpret=True): d(sum(out9 * w9)) with respect to the five
Gaussian inputs and means2d_stats, at 5e-3 x max |g| per input (the JAX
package's own Pallas-vs-XLA gradient tolerance, tests/test_pallas_raster.py).
w9 is numpy-seeded with the alpha channel zeroed, which takes no gradient
in the reference.  The stats are held against the XLA path only: JAX's
Pallas kernel measures the Gaussian-to-pixel offset from the pixel centre
(pallas_raster.py:219-220, :502-503) where the XLA path, like the CUDA
reference, uses pixf - 0.5 (rasterize.py:376), so JAX's two paths differ
by half a pixel there; the port follows the XLA path.  The near-opaque stack and the windows past 256 Gaussians
are in tests/test_torch_rasterize_grad_deep.py.  Also: the hand-written
pull-back of _chunk_eval (chunk_eval_vjp below, what csrc/raster_bwd.cu
computes) against autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f3d_gaus_tpu.ops import rasterize as JR
from f3d_gaus_torch.ops import rasterize as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CASES = {name: (cam, cloud, bg, kw)
         for name, cam, cloud, bg, kw in torch_cases.small_cases()}
NAMES = ("means", "scales", "quats", "opacities", "shs", "means2d_stats")
DEEP = ("near_opaque64",) + torch_cases.DEEP_CASES


def _w9(seed=1):
    w9 = np.random.default_rng(seed).normal(size=(9, 32, 32)).astype(np.float32)
    w9[7] = 0.0
    return w9


def _jax_grads(cam, cloud, bg, backend, w9, **kw):
    def loss(*a):
        out = JR.render(*a[:5], cam, jnp.asarray(bg), means2d_stats=a[5],
                        backend=backend, interpret=(backend == "pallas"), **kw)
        return jnp.sum(out["out9"] * w9)
    args = [jnp.asarray(a) for a in cloud]
    args.append(jnp.zeros((cloud[0].shape[0], 3), jnp.float32))
    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(6)))(*args)]


def _torch_grads(cam, cloud, bg, w9, **kw):
    ts = [torch.from_numpy(a).requires_grad_() for a in cloud]
    ts.append(torch.zeros((cloud[0].shape[0], 3), requires_grad=True))
    out = TR.render(*ts[:5], cam, torch.from_numpy(bg), means2d_stats=ts[5],
                    **kw)
    (out["out9"] * torch.from_numpy(w9)).sum().backward()
    return [t.grad.numpy() for t in ts]


def check_grads(case, backend):
    cam, cloud, bg, kw = CASES[case]
    w9 = _w9()
    ref = _jax_grads(cam, cloud, bg, backend, w9, **kw)
    got = _torch_grads(cam, cloud, bg, w9, **kw)
    n = len(NAMES) if backend == "xla" else len(NAMES) - 1
    for name, r, g in zip(NAMES[:n], ref, got):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=5e-3 * (np.abs(r).max() + 1e-8),
                                   err_msg=f"{case} {backend} d/d{name}")


@pytest.mark.parametrize("case", sorted(set(CASES) - set(DEEP)))
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_render_grads_match_jax(case, backend):
    check_grads(case, backend)


def chunk_eval_vjp(feat_c, u, v, cots):
    """The pull-back of rasterize._chunk_eval derived by hand, formula by
    formula what csrc/raster_bwd.cu computes for one (pixel, Gaussian) pair
    (the package itself pulls back through torch.func.vjp).

    cots: cotangents of alpha_raw, t, m (T, PIX, C), nn (T, PIX, C, 3) and
    rgb (T, 1, C, 3); G takes none.  Returns d feat_c (T, C, NFEAT),
    summed over the pixels.  The clamps of AA and num pass all of the
    gradient above their bound, half at it and none below (jnp.maximum's
    share); the pass-through minima pass all of it."""
    def e(i):
        return feat_c[:, None, :, i]
    U, V = u[..., None], v[..., None]
    qa = [e(TR.ROW_QA + i) for i in range(6)]
    qk = [e(TR.ROW_QK + i) for i in range(6)]
    B_ = [e(TR.ROW_B + i) for i in range(3)]
    opa = e(TR.ROW_OPA)

    def quad(q):
        return ((q[0] * U + q[1] * V + q[3]) * U
                + (q[2] * V + q[4]) * V + q[5])
    AA, num = quad(qa), quad(qk)
    BB = 2.0 * (B_[0] * U + B_[1] * V + B_[2])
    AA_safe = torch.clamp_min(AA, 1e-12)
    inv_AA = 1.0 / AA_safe
    t = -BB * (0.5 * inv_AA)
    mv = torch.clamp_min(num, 0.0) * inv_AA
    G = torch.exp(torch.clamp_max(-0.5 * mv, 0.0))

    # alpha = opa G;  G = exp(-mv / 2)
    d_alpha = cots["alpha_raw"]
    d_opa = d_alpha * G
    d_mv = -0.5 * d_alpha * opa * G
    # m = F/(F-N) - F N / ((F-N) t_pos),  t_pos = max(t, 1e-6)
    t_pos = torch.clamp_min(t, 1e-6)
    F, N = TR.FAR_PLANE, TR.NEAR_PLANE
    dm_dt = (F * N / (F - N)) / (t_pos * t_pos)
    d_t = cots["t"] + torch.where(t > 1e-6, cots["m"] * dm_dt, 0.0)
    # t = -BB / (2 AA_safe),  mv = num / AA_safe
    d_BB = -0.5 * d_t * inv_AA
    def share(x, lo):
        return torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    d_AA = share(AA, 1e-12) * (-(d_t * t + d_mv * mv) * inv_AA)
    d_num = share(num, 0.0) * (d_mv * inv_AA)
    # nn = -n / sqrt(|n|^2 + 1e-7),  n = (M^T M) d
    nx = qa[0] * U + 0.5 * qa[1] * V + 0.5 * qa[3]
    ny = 0.5 * qa[1] * U + qa[2] * V + 0.5 * qa[4]
    nz = 0.5 * qa[3] * U + 0.5 * qa[4] * V + qa[5]
    inv_len = 1.0 / torch.sqrt(nx * nx + ny * ny + nz * nz + 1e-7)
    dn = cots["nn"]
    k3 = inv_len ** 3 * (dn[..., 0] * nx + dn[..., 1] * ny + dn[..., 2] * nz)
    d_nx = -inv_len * dn[..., 0] + k3 * nx
    d_ny = -inv_len * dn[..., 1] + k3 * ny
    d_nz = -inv_len * dn[..., 2] + k3 * nz
    # the monomials u^2, uv, v^2, u, v, 1 of the quadratic forms
    mono = [U * U, U * V, V * V, U, V, 1.0]
    g_qa = [d_AA * mono[0] + d_nx * U,
            d_AA * mono[1] + 0.5 * (d_nx * V + d_ny * U),
            d_AA * mono[2] + d_ny * V,
            d_AA * U + 0.5 * (d_nx + d_nz * U),
            d_AA * V + 0.5 * (d_ny + d_nz * V),
            d_AA + d_nz]
    g_qk = [d_num * mk for mk in mono]
    g_B = [2.0 * d_BB * U, 2.0 * d_BB * V, 2.0 * d_BB]
    shape = d_alpha.shape
    cols = [torch.broadcast_to(g, shape).sum(1)
            for g in g_qa + g_qk + g_B + [d_opa]]
    rgb = cots["rgb"].sum(1)                              # (T, C, 3)
    return torch.stack(cols[:15] + [rgb[..., 0], rgb[..., 1], rgb[..., 2],
                                    cols[15]], -1)


def test_chunk_eval_vjp_matches_autograd():
    """The hand-derived pull-back against torch.func.vjp of _chunk_eval on
    the first window of the 96-Gaussian case, with seeded cotangents on
    every output but G (which takes none in the backward)."""
    cam, cloud, bg, kw = CASES["cloud96_mpt128"]
    inp = TR.prepare(*[torch.from_numpy(a) for a in cloud], cam,
                     torch.from_numpy(bg), device="cpu", **kw)
    feat = inp.feat.detach()
    b = inp.binning
    _, _, wfeat = TR._gather_windows(feat, b.point_list, b.tile_start,
                                     b.tile_count, kw["max_per_tile"])
    u, v = TR._tile_rays(inp.statics, "cpu")
    ct, vjp_fn = torch.func.vjp(lambda f: TR._chunk_eval(f, u, v), wfeat)
    rng = np.random.default_rng(3)
    cots = {k: torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32))
            for k, x in ct.items()}
    cots["G"] = torch.zeros_like(cots["G"])
    (ref,) = vjp_fn(cots)
    got = chunk_eval_vjp(wfeat, u, v, cots)
    scale = ref.abs().amax((0, 1), keepdim=True)
    assert ((got - ref).abs() <= 1e-5 * scale).all()
