"""Per-scene dataset readers: COLMAP binary models and Blender
(NeRF-synthetic) transforms -- the scene-loading layer of the per-scene
trainer (reference scene/dataset_readers.py:132-231 +
scene/colmap_loader.py), on numpy from the COLMAP file-format spec.
Produces `core.cameras.Camera` objects in the row-vector matrix convention
plus the seed point cloud.  A numpy copy of
f3d_gaus_tpu/pipeline/scene_io.py (that package's import chain pulls in
JAX).
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import NamedTuple, Optional

import numpy as np

from ..core.cameras import Camera, projection_matrix


class SceneCamera(NamedTuple):
    camera: Camera
    image_path: str
    image: Optional[np.ndarray]    # (H, W, 3) float32 in [0,1], lazy-loadable
    name: str


class SceneData(NamedTuple):
    cameras: list                  # [SceneCamera]
    points: np.ndarray             # (N, 3) seed cloud
    colors: np.ndarray             # (N, 3) float [0,1]
    extent: float                  # nerf++-style normalization radius


def focal2fov(focal, pixels):
    return 2.0 * math.atan(pixels / (2.0 * focal))


def _camera_from_w2c(R_w2c: np.ndarray, t_w2c: np.ndarray, fovx: float,
                     fovy: float, width: int, height: int,
                     znear=0.01, zfar=100.0) -> Camera:
    """Build a row-vector-convention Camera from a column-vector world->cam
    rotation/translation (the COLMAP qvec/tvec convention)."""
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R_w2c
    w2c[:3, 3] = t_w2c
    world_view = w2c.T.astype(np.float32)          # row-vector layout
    proj_T = projection_matrix(znear, zfar, fovx, fovy).T
    full_proj = (world_view @ proj_T).astype(np.float32)
    cam_center = np.linalg.inv(world_view)[3, :3].astype(np.float32)
    return Camera(world_view, full_proj, cam_center, width, height,
                  math.tan(fovx / 2), math.tan(fovy / 2))


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


# ---------------------------------------------------------------------------
# COLMAP binary model (format spec: colmap/src/colmap/scene/reconstruction_io)
# ---------------------------------------------------------------------------

_CAM_MODEL_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5,
                     8: 4, 9: 5, 10: 12}
_CAM_MODEL_NAMES = {0: "SIMPLE_PINHOLE", 1: "PINHOLE", 2: "SIMPLE_RADIAL"}


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model, w, h = struct.unpack("<iiQQ", f.read(24))
            params = struct.unpack(f"<{_CAM_MODEL_PARAMS[model]}d",
                                   f.read(8 * _CAM_MODEL_PARAMS[model]))
            cams[cid] = {"model": model, "width": int(w), "height": int(h),
                         "params": np.array(params)}
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = struct.unpack("<4d", f.read(32))
            tvec = struct.unpack("<3d", f.read(24))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.seek(24 * n2d, 1)                      # skip 2D points
            images[iid] = {"qvec": np.array(qvec), "tvec": np.array(tvec),
                           "camera_id": cam_id, "name": name.decode()}
    return images


def read_points3d_binary(path):
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        for i in range(n):
            data = struct.unpack("<Q3d3Bd", f.read(43))
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.seek(8 * track_len, 1)
    return xyz.astype(np.float32), rgb.astype(np.float32) / 255.0


def read_colmap_scene(path: str, images_dir: str = "images",
                      load_images: bool = False) -> SceneData:
    """Load a COLMAP reconstruction (sparse/0 binary model) —
    readColmapSceneInfo semantics (dataset_readers.py:132-176)."""
    sparse = os.path.join(path, "sparse", "0")
    cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb = read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    out = []
    for iid in sorted(imgs):
        im = imgs[iid]
        cam = cams[im["camera_id"]]
        w, h = cam["width"], cam["height"]
        if cam["model"] == 0:                        # SIMPLE_PINHOLE: f, cx, cy
            fx = fy = cam["params"][0]
        elif cam["model"] == 1:                      # PINHOLE: fx, fy, cx, cy
            fx, fy = cam["params"][0], cam["params"][1]
        else:
            # distortion models (SIMPLE_RADIAL, OPENCV, ...) would load with
            # silently wrong geometry; the reference asserts the same
            # restriction (dataset_readers.py:92-100: "Colmap camera model
            # not handled: only undistorted datasets ... supported!")
            name = _CAM_MODEL_NAMES.get(cam["model"], str(cam["model"]))
            raise ValueError(
                f"COLMAP camera model {name} is not supported: only "
                "SIMPLE_PINHOLE/PINHOLE (undistorted) reconstructions load "
                "correctly — undistort the dataset first")
        fovx, fovy = focal2fov(fx, w), focal2fov(fy, h)
        camera = _camera_from_w2c(_qvec2rotmat(im["qvec"]),
                                  im["tvec"].astype(np.float32),
                                  fovx, fovy, w, h)
        img_path = os.path.join(path, images_dir, im["name"])
        image = None
        if load_images and os.path.exists(img_path):
            from PIL import Image
            image = np.asarray(Image.open(img_path).convert("RGB"),
                               np.float32) / 255.0
        out.append(SceneCamera(camera, img_path, image, im["name"]))

    extent = _nerfpp_radius([c.camera for c in out])
    return SceneData(out, xyz, rgb, extent)


# ---------------------------------------------------------------------------
# Blender / NeRF-synthetic transforms
# ---------------------------------------------------------------------------

def read_blender_scene(path: str, transforms: str = "transforms_train.json",
                       white_background: bool = False,
                       load_images: bool = False,
                       n_init_points: int = 100_000,
                       seed: int = 0) -> SceneData:
    """readNerfSyntheticInfo semantics (dataset_readers.py:179-231): the
    c2w matrices are converted with the flipped y/z axes the loader applies
    (:196-199), and the seed cloud is random in [-1.3, 1.3]^3."""
    with open(os.path.join(path, transforms)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    out = []
    for idx, frame in enumerate(meta["frames"]):
        c2w = np.array(frame["transform_matrix"], np.float32)
        c2w[:3, 1:3] *= -1                      # blender -> colmap axes
        w2c = np.linalg.inv(c2w)
        name = os.path.basename(frame["file_path"])
        img_path = os.path.join(path, frame["file_path"] + ".png")
        image = None
        w = h = 800
        if load_images and os.path.exists(img_path):
            from PIL import Image
            pil = Image.open(img_path)
            w, h = pil.size
            arr = np.asarray(pil.convert("RGBA"), np.float32) / 255.0
            bgc = 1.0 if white_background else 0.0
            image = arr[..., :3] * arr[..., 3:] + bgc * (1 - arr[..., 3:])
        fovy = focal2fov(w / (2 * math.tan(fovx / 2)), h)
        camera = _camera_from_w2c(w2c[:3, :3], w2c[:3, 3], fovx, fovy, w, h)
        out.append(SceneCamera(camera, img_path, image, name))

    rng = np.random.default_rng(seed)
    pts = (rng.random((n_init_points, 3), np.float32) * 2.6 - 1.3)
    cols = rng.random((n_init_points, 3)).astype(np.float32)
    return SceneData(out, pts, cols, _nerfpp_radius(
        [c.camera for c in out]))


def _nerfpp_radius(cameras) -> float:
    """nerf++ scene normalization radius (dataset_readers.py:45-60):
    1.1 * max distance of any camera center from their centroid."""
    centers = np.stack([c.cam_center for c in cameras])
    centroid = centers.mean(0)
    return float(np.linalg.norm(centers - centroid, axis=-1).max() * 1.1)
