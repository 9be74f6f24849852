"""Drive helpers of the demo (counterpart of grid_vision_tpu/demo.py)."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .types import Extrinsics

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
