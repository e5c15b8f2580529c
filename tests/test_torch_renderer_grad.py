"""Gradients through f3d_gaus_torch.pipeline.renderer against
f3d_gaus_tpu.pipeline.renderer: depth_to_normal with respect to the depth
map, and render_views_batched (render_gaussians over two views and two
batch elements: the world-space normal, the depth-derived normal, depth,
colour and distortion) with respect to every Gaussian parameter, at
5e-3 x max |g| per parameter."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from f3d_gaus_tpu.pipeline import config as JC
from f3d_gaus_tpu.pipeline import renderer as JR
from f3d_gaus_torch.core import cameras
from f3d_gaus_torch.pipeline import config as TC
from f3d_gaus_torch.pipeline import renderer as TR
import torch_cases  # tests/ is on sys.path under pytest (rootdir-less dir)

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)

CAPS = dict(resolution=32, pair_cap=1 << 14, max_per_tile=256, chunk=64)
KEYS = ("render", "rendered_normal", "rendered_depth", "depth_normal",
        "distortion_map")


def test_depth_to_normal_grad_matches_jax():
    cam = torch_cases.orbit_camera(24, 16)
    rng = np.random.default_rng(1)
    depth = rng.uniform(7, 8, (1, 16, 24)).astype(np.float32)
    w = rng.normal(size=(3, 16, 24)).astype(np.float32)
    gj = jax.grad(lambda d: jnp.sum(JR.depth_to_normal(
        jnp.asarray(cam.world_view), d, 24, 16, cam.tan_fovx, cam.tan_fovy)
        * w))(jnp.asarray(depth))
    d = torch.from_numpy(depth).requires_grad_()
    (TR.depth_to_normal(cam.world_view, d, 24, 16, cam.tan_fovx,
                        cam.tan_fovy) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gj)).max())


def _gaussians(rng, B=2, n=96):
    clouds = [torch_cases.make_gaussian_cloud(rng, n, spread=0.35,
                                              scale_range=(0.05, 0.15))
              for _ in range(B)]
    means, scales, quats, opac, shs = (np.stack(a) for a in zip(*clouds))
    return {"xyz": means, "scaling": scales, "rotation": quats,
            "opacity": opac, "features_dc": shs[:, :, :1],
            "features_rest": shs[:, :, 1:]}


def test_render_views_batched_grads_match_jax():
    rng = np.random.default_rng(4)
    g = _gaussians(rng)
    cfg_j, cfg_t = JC.PipelineConfig(**CAPS), TC.PipelineConfig(**CAPS)
    _, inv = cameras.canonical_camera_set(cfg_t.fov_deg, cfg_t.radius,
                                          cfg_t.look_at_z, cfg_t.z_near,
                                          cfg_t.z_far)
    cams = cameras.build_camera_set(
        np.array([0.0, 0.1], np.float32), np.array([0.0, -0.05], np.float32),
        cfg_t.radius, cfg_t.look_at_z, cfg_t.fov_deg, cfg_t.z_near,
        cfg_t.z_far, rebase=inv)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    w = {k: rng.normal(size=(2, 2, 1 if k in ("rendered_depth",
                                             "distortion_map") else 3,
                             32, 32)).astype(np.float32) for k in KEYS}

    def jloss(gg):
        v = JR.render_views_batched(gg, jnp.asarray(cams.world_view),
                                    jnp.asarray(cams.full_proj),
                                    jnp.asarray(cams.cam_centers),
                                    jnp.asarray(bg), cfg_j)
        return sum(jnp.sum(v[k] * w[k]) for k in KEYS), v["overflow"]
    gj, over_j = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in g.items()})
    gt = {k: torch.from_numpy(v).requires_grad_() for k, v in g.items()}
    v = TR.render_views_batched(gt, cams.world_view, cams.full_proj,
                                cams.cam_centers, bg, cfg_t)
    assert not bool(v["overflow"].any()) and not bool(np.any(over_j))
    sum((v[k] * torch.from_numpy(w[k])).sum() for k in KEYS).backward()
    for k in g:
        r, got = np.asarray(gj[k]), gt[k].grad.numpy()
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, r, rtol=0,
                                   atol=5e-3 * np.abs(r).max(), err_msg=k)
