"""f3d_gaus_torch.ops.integrate (the opacity-field query, plain PyTorch
version on the CPU) against f3d_gaus_tpu.ops.integrate on the 32^2 cases
of tests/test_integrate.py: alpha_integrated at that file's own tolerance
(2e-5), color_integrated exactly, and the running minimum over a 3-view
orbit at 2e-5."""
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
