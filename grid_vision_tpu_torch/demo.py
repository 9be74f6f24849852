"""Drive helpers of the demo (counterpart of grid_vision_tpu/demo.py)."""

from __future__ import annotations

import numpy as np
import torch

from .config import GridVisionConfig
from .device import resolve_device
from .io.scene import SyntheticScene
from .types import Boxes, Extrinsics

# camera (x right, y down, z fwd) -> base (x fwd, y left, z up)
_R_CB = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)


def default_extrinsics(device="cuda") -> Extrinsics:
    """LiDAR in the camera frame; camera axes rotated into the base frame.
    On the card unless the CPU is asked for."""
    device = resolve_device(device)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _R_CB
    return Extrinsics(lidar_to_camera=torch.eye(4, device=device),
                      camera_to_base=torch.as_tensor(T, device=device))


def oracle_boxes(scene: SyntheticScene, t: float, cfg: GridVisionConfig,
                 device="cuda") -> Boxes:
    """Ground-truth detections from the scene (the demo's stand-in for a
    trained detector; it drives the full downstream): every visible
    object's box up to max_detections, confidence 0.9, on `device`."""
    cap = cfg.max_detections
    xyxy = np.zeros((cap, 4), np.float32)
    conf = np.zeros((cap,), np.float32)
    label = np.full((cap,), 10, np.int32)
    valid = np.zeros((cap,), bool)
    n = 0
    for i in range(len(scene.objects)):
        bb = scene.bbox_at(i, t)
        if bb is None or n >= cap:
            continue
        xyxy[n] = [bb["x_min"], bb["y_min"], bb["x_max"], bb["y_max"]]
        conf[n] = 0.9
        label[n] = bb["label"]
        valid[n] = True
        n += 1
    dev = resolve_device(device)
    return Boxes(xyxy=torch.as_tensor(xyxy, device=dev),
                 confidence=torch.as_tensor(conf, device=dev),
                 label=torch.as_tensor(label, device=dev),
                 valid=torch.as_tensor(valid, device=dev))
