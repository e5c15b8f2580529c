# Frozen copy of f3d_gaus_torch/pipeline/dataset.py at commit b6ed6e2, the
# benchmark's plain reference; imports rewritten for this flat package.
"""Demo dataset: RGB + metric-depth image pairs (counterpart of
f3d_gaus_tpu/pipeline/dataset.py).

RGB is LANCZOS-resized to the training resolution in [0,1]; depth is read
from `<name>_depth.png` as 32-bit int, /65536, optionally min-max
normalized to [0,1], then *2 + z_near (landing in [6.667, 8.667] for the
canonical config).  PIL is imported only where an image is read.

`canonical_cameras(cfg)` gives the canonical first camera and the
`inverse_first_camera` that rebases every other view; `run_nvs` needs only
those two, so a caller that brings its own arrays needs no dataset.
"""
from __future__ import annotations

import glob
import os
from typing import NamedTuple

import numpy as np

from . import cameras
from .config import PipelineConfig


class CanonicalCameras(NamedTuple):
    camera_set: cameras.CameraSet
    inverse_first_camera: np.ndarray | None


def canonical_cameras(cfg: PipelineConfig) -> CanonicalCameras:
    return CanonicalCameras(*cameras.canonical_camera_set(
        cfg.fov_deg, cfg.radius, cfg.look_at_z, cfg.z_near, cfg.z_far,
        update_pose=cfg.update_pose))


class Sample(NamedTuple):
    name: str
    image: np.ndarray      # (H, W, 3) float32 [0, 1]
    depth: np.ndarray      # (H, W) float32 metric depth


class DemoDataset:
    def __init__(self, folder: str, cfg: PipelineConfig):
        self.cfg = cfg
        if folder.endswith("txt"):
            with open(folder) as f:
                names = [line.strip() for line in f if line.strip()]
        else:
            names = sorted(n for n in glob.glob(os.path.join(folder, "*"))
                           if not n.endswith("_depth.png"))
        # keep only samples whose depth companion exists
        self.image_names = [n for n in names
                            if os.path.exists(self._depth_path(n))]
        self.camera_set, self.inverse_first_camera = canonical_cameras(cfg)

    @staticmethod
    def _depth_path(img_path: str) -> str:
        root, _ = os.path.splitext(img_path)
        return root + "_depth.png"

    def __len__(self):
        return len(self.image_names)

    def __getitem__(self, idx: int) -> Sample:
        from PIL import Image

        path = self.image_names[idx]
        size = self.cfg.resolution
        img = Image.open(path).convert("RGB")
        img = img.resize((size, size), Image.LANCZOS)
        image = np.asarray(img, np.float32) / 255.0

        dimg = Image.open(self._depth_path(path)).convert("I")
        dimg = dimg.resize((size, size), Image.LANCZOS)
        depth = np.asarray(dimg, np.float32) / 65536.0
        if self.cfg.norm_depth_to01:
            lo, hi = depth.min(), depth.max()
            depth = (depth - lo) / max(hi - lo, 1e-12)
        depth = depth * 2.0 + self.cfg.z_near
        return Sample(os.path.basename(path), image, depth.astype(np.float32))

    def batch(self, indices) -> dict:
        """Stack samples into arrays: images (B, H, W, 3), depth (B, H, W)."""
        samples = [self[i] for i in indices]
        return {
            "names": [s.name for s in samples],
            "images": np.stack([s.image for s in samples]),
            "depth": np.stack([s.depth for s in samples]),
        }
