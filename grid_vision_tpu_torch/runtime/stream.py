"""Observations for driving the engine from a SyntheticScene
(counterpart of obs_from_scene in grid_vision_tpu/runtime/stream.py)."""

from __future__ import annotations

import torch

from ..config import GridVisionConfig
from ..io.scene import SyntheticScene
from ..types import Obs, PointCloud


def obs_from_scene(scene: SyntheticScene, t: float, cfg: GridVisionConfig,
                   device="cpu") -> Obs:
    """The scene's frame and cloud at time t as an Obs on `device`."""
    cloud, _ = PointCloud.pack_numpy(scene.cloud_at(t), None, cfg.max_points,
                                     device=device)
    return Obs(image=torch.as_tensor(scene.image_at(t), device=device),
               cloud=cloud,
               has_image=torch.tensor(True, device=device),
               has_cloud=torch.tensor(True, device=device))
