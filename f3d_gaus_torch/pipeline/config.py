"""Typed pipeline configuration (counterpart of
f3d_gaus_tpu/pipeline/config.py).

One dataclass covering the reference's YAML keys that the live inference
path consumes (config/imagenetgs_256x256_v1.yaml) plus the renderer capacity
knobs (pair_cap, max_per_tile) that replace the CUDA resize-on-demand
buffers.  `from_yaml` accepts the reference's YAML; `yaml` is imported only
there.
"""
from __future__ import annotations

import dataclasses
import math

from ..models.predictor import PredictorConfig


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # model (yaml:114-157)
    resolution: int = 256
    fov_deg: float = 13.164
    radius: float = 7.667
    look_at_z: float = 7.667
    max_sh_degree: int = 1
    base_dim: int = 128
    num_blocks: int = 3
    attn_resolutions: tuple = (16,)
    model_channels: int = 0
    # dataset (yaml:43-48)
    z_near: float = 6.667
    z_far: float = 8.667
    norm_depth_to01: bool = True
    # opt (yaml:50-113 live keys)
    update_pose: bool = True
    # view program (visualize.py:232-236, 342-355)
    num_aggregation_views: int = 8
    num_nvs_views: int = 128
    yaw_diff: float = 0.25
    pitch_diff: float = 0.15
    # renderer capacities (static; the caller replans on overflow)
    pair_cap: int = 1 << 20
    max_per_tile: int = 1024
    chunk: int = 128               # plain-version compositing chunk
    kernel_size: float = 0.0
    # serving frames' height (None: square frames of `resolution`)
    height: int | None = None

    @property
    def tan_fov(self) -> float:
        """tan of half the horizontal field of view `fov_deg` (the frame's
        x tangent; the y tangent for square frames)."""
        return math.tan(self.fov_deg * math.pi / 360.0)

    @property
    def frame_height(self) -> int:
        """The serving frames' height in pixels; their width is
        `resolution`."""
        return self.resolution if self.height is None else self.height

    @property
    def tan_fovy(self) -> float:
        """The frame's y tangent: tan_fov scaled by height / width (square
        pixels), tan_fov itself for square frames."""
        return self.tan_fov * (self.frame_height / self.resolution)

    def predictor_config(self) -> PredictorConfig:
        return PredictorConfig(
            resolution=self.resolution, fov_deg=self.fov_deg,
            base_dim=self.base_dim, num_blocks=self.num_blocks,
            attn_resolutions=tuple(self.attn_resolutions),
            max_sh_degree=self.max_sh_degree,
            model_channels=self.model_channels)


def from_yaml(path: str) -> PipelineConfig:
    """Load a reference-format YAML (visualize.py:584-588 uses yaml.safe_load)."""
    import yaml
    with open(path) as f:
        y = yaml.safe_load(f)
    m = y.get("model", {})
    d = y.get("dataset_params", {})
    o = y.get("opt", {})
    return PipelineConfig(
        resolution=int(m.get("training_resolution", 256)),
        fov_deg=float(m.get("fov", 13.164)),
        radius=float(m.get("radius", 7.667)),
        look_at_z=float(m.get("look_at", 7.667)),
        max_sh_degree=int(m.get("max_sh_degree", 1)),
        base_dim=int(m.get("base_dim", 128)),
        num_blocks=int(m.get("num_blocks", 3)),
        attn_resolutions=tuple(m.get("attention_resolutions", [16])),
        z_near=float(d.get("z_near", 6.667)),
        z_far=float(d.get("z_far", 8.667)),
        norm_depth_to01=bool(d.get("norm_depth_to01", True)),
        update_pose=bool(o.get("update_pose", True)),
    )
