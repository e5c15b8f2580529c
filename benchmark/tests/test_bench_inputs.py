"""The input generators: RGB-D images, hemisphere cameras, the Blender
camera construction and the ray-cast analytic scene."""
import math

import numpy as np
import pytest

from benchmark import inputs
from benchmark.reference.cameras import Camera


def test_smooth_rgbd_ranges_and_seed():
    a = inputs.smooth_rgbd(np.random.default_rng(7), 32)
    b = inputs.smooth_rgbd(np.random.default_rng(7), 32)
    img, depth = a
    assert img.shape == (1, 32, 32, 3) and depth.shape == (1, 32, 32)
    assert img.min() >= 0 and img.max() <= 1
    assert depth.min() >= 6.667 - 1e-5 and depth.max() <= 8.667 + 1e-5
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_hemisphere_cameras_look_at_the_origin():
    c2ws = inputs.hemisphere_c2w(20, 4.03)
    for m in c2ws:
        p = m[:3, 3]
        assert np.linalg.norm(p) == pytest.approx(4.03)
        el = math.degrees(math.asin(p[2] / 4.03))
        assert 10 <= el <= 75
        # Blender looks down -z: the -z axis points at the origin
        np.testing.assert_allclose(-m[:3, 2], -p / np.linalg.norm(p),
                                   atol=1e-12)
        np.testing.assert_allclose(m[:3, :3].T @ m[:3, :3], np.eye(3),
                                   atol=1e-12)


def test_blender_cameras_match_the_programs_reader():
    from f3d_gaus_torch.pipeline import scene_io
    c2ws = inputs.hemisphere_c2w(5, 4.03)
    ours = inputs.blender_cameras(Camera, c2ws, 0.6911, 800, 800)
    for m, cam in zip(c2ws, ours):
        c2w = np.array(m, np.float32)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        theirs = scene_io._camera_from_w2c(w2c[:3, :3], w2c[:3, 3], 0.6911,
                                           0.6911, 800, 800)
        np.testing.assert_allclose(cam.world_view, theirs.world_view,
                                   atol=1e-6)
        np.testing.assert_allclose(cam.full_proj, theirs.full_proj,
                                   atol=1e-6)
        np.testing.assert_allclose(cam.cam_center, theirs.cam_center,
                                   atol=1e-5)
    assert inputs.nerfpp_radius(ours) > 0


def _down_camera(height, size=3):
    """A camera at (0, 0, height) looking straight down (Blender's camera
    looks along its -z axis: the identity rotation looks down)."""
    c2w = np.eye(4)
    c2w[:3, 3] = [0, 0, height]
    return inputs.blender_cameras(Camera, [c2w], 0.2, size, size)[0]


def test_raycast_hits_the_sphere_under_the_centre_pixel():
    cam = _down_camera(4.0)
    img = inputs.raycast(cam, "cpu")
    assert img.shape == (3, 3, 3)
    c = np.array(inputs.SPHERE_C)
    # the vertical ray through (0, 0) meets the sphere's top
    z = c[2] + math.sqrt(inputs.SPHERE_R ** 2 - c[0] ** 2 - c[1] ** 2)
    n = (np.array([0, 0, z]) - c) / inputs.SPHERE_R
    np.testing.assert_allclose(img[:, 1, 1].numpy(), 0.5 + 0.4 * n,
                               atol=1e-5)


def test_raycast_background_is_black_and_ground_is_checkered():
    up = np.eye(4)
    up[:3, :3] = np.diag([1.0, -1.0, -1.0])     # looking up (+z): nothing
    up[:3, 3] = [0, 0, 4.0]
    cam = inputs.blender_cameras(Camera, [up], 0.2, 4, 4)[0]
    assert float(inputs.raycast(cam, "cpu").abs().max()) == 0.0
    # straight down at (0.9, 0.9): the ground, cell (3, 3) -> even -> dark
    c2w = np.eye(4)
    c2w[:3, 3] = [0.9, 0.9, 4.0]
    cam = inputs.blender_cameras(Camera, [c2w], 0.01, 3, 3)[0]
    px = inputs.raycast(cam, "cpu")[:, 1, 1].numpy()
    want = np.array([0.2, 0.3, 0.5]) + 0.08 * math.sin(9 * 0.9)
    np.testing.assert_allclose(px, want, atol=1e-4)


def test_random_init_is_3dgs_cube():
    pts, cols = inputs.random_init(np.random.default_rng(0), 1000)
    assert pts.shape == (1000, 3) and cols.shape == (1000, 3)
    assert pts.min() >= -1.3 and pts.max() <= 1.3
    assert cols.min() >= 0 and cols.max() <= 1
