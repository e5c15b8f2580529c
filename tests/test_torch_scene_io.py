"""f3d_gaus_torch.pipeline.scene_io against f3d_gaus_tpu.pipeline.scene_io
on the same files: a COLMAP binary model written by tests/test_scene_io.py
(format spec) and a Blender scene with RGBA images; cameras, images,
seed clouds and extents equal."""
import json
import os
import struct

import numpy as np
import pytest
import torch

from f3d_gaus_tpu.pipeline import scene_io as JS
from f3d_gaus_torch.pipeline import scene_io as TS
from test_scene_io import write_colmap_model

# the suite runs in several xdist workers on one CPU: torch's intra-op
# threads would oversubscribe the cores, so each worker keeps one
torch.set_num_threads(1)


def _assert_same_scene(j, t, images=False):
    assert len(j.cameras) == len(t.cameras) > 0
    for a, b in zip(j.cameras, t.cameras):
        assert (a.name, a.image_path) == (b.name, b.image_path)
        for field in ("world_view", "full_proj", "cam_center"):
            np.testing.assert_array_equal(getattr(b.camera, field),
                                          getattr(a.camera, field))
        assert tuple(a.camera[3:]) == tuple(b.camera[3:])
        if images:
            np.testing.assert_array_equal(b.image, a.image)
        else:
            assert a.image is None and b.image is None
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.colors, j.colors)
    assert t.extent == j.extent > 0


@pytest.mark.parametrize("model", [0, 1])
def test_colmap_matches_jax(tmp_path, model):
    rng = np.random.default_rng(0)
    write_colmap_model(str(tmp_path), rng, n_imgs=4, n_pts=60)
    if model == 0:                  # rewrite the camera as SIMPLE_PINHOLE
        with open(tmp_path / "sparse" / "0" / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<iiQQ", 1, 0, 50, 30))
            f.write(struct.pack("<3d", 70.0, 25.0, 15.0))
    j = JS.read_colmap_scene(str(tmp_path))
    t = TS.read_colmap_scene(str(tmp_path))
    _assert_same_scene(j, t)
    assert t.cameras[0].camera.width == (50 if model == 0 else 64)


def test_colmap_distortion_models_raise(tmp_path):
    write_colmap_model(str(tmp_path), np.random.default_rng(1))
    with open(tmp_path / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 2, 64, 48))         # SIMPLE_RADIAL
        f.write(struct.pack("<4d", 80.0, 32.0, 24.0, 0.01))
    for mod in (JS, TS):
        with pytest.raises(ValueError, match="SIMPLE_RADIAL"):
            mod.read_colmap_scene(str(tmp_path))


@pytest.mark.parametrize("white_background", [False, True])
def test_blender_matches_jax(tmp_path, white_background):
    """Blender transforms (the y/z flip), RGBA images composited on the
    background, the seeded random init cloud."""
    from PIL import Image
    rng = np.random.default_rng(2)
    frames = []
    os.makedirs(tmp_path / "train")
    for i in range(3):
        c2w = np.eye(4)
        c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        c2w[:3, 3] = rng.normal(size=3) * 3
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        rgba = rng.integers(0, 256, size=(24, 40, 4), dtype=np.uint8)
        Image.fromarray(rgba, "RGBA").save(tmp_path / "train" / f"r_{i}.png")
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.6911, "frames": frames}, f)
    kw = dict(white_background=white_background, load_images=True,
              n_init_points=500, seed=3)
    j = JS.read_blender_scene(str(tmp_path), **kw)
    t = TS.read_blender_scene(str(tmp_path), **kw)
    _assert_same_scene(j, t, images=True)
    cam = t.cameras[0].camera
    assert (cam.width, cam.height) == (40, 24)
    assert t.points.shape == (500, 3) and np.abs(t.points).max() <= 1.3
    # the loader's y/z flip: the camera looks down the frame's -z
    c2w = np.array(frames[0]["transform_matrix"], np.float32)
    np.testing.assert_allclose(np.linalg.inv(cam.world_view)[3, :3],
                               c2w[:3, 3], atol=1e-5)
    np.testing.assert_allclose(cam.world_view[:3, 2], -c2w[:3, 2], atol=1e-5)
