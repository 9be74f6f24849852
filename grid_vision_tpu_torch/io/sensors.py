"""Sensor message adapters (counterpart of grid_vision_tpu/io/sensors.py):
the migration surface for reference users.

The reference subscribes to sensor_msgs/Image ("rgb8" via cv_bridge,
grid_vision_node.cpp:79-101) and sensor_msgs/PointCloud2
(pcl::fromROSMsg, :103-106). Without ROS, the adapters accept the
*wire-format content* of those messages as plain dicts/bytes — a rclpy
callback can hand its messages straight in:

    def cloud_cb(msg):
        obs_cloud = sensors.pointcloud2_to_cloud(
            {"fields": [(f.name, f.offset, f.datatype) for f in msg.fields],
             "point_step": msg.point_step, "width": msg.width,
             "height": msg.height, "data": bytes(msg.data)},
            capacity=cfg.max_points, transform=T_lidar_cam)

Parsing and packing run on the host, through the native runtime
(runtime_cc) when available; the packed cloud then goes to `device`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..runtime import native
from ..types import PointCloud

# sensor_msgs/PointField datatype codes
_FLOAT32 = 7


def pointcloud2_to_cloud(msg: Dict, capacity: int,
                         transform: Optional[np.ndarray] = None,
                         device="cuda") -> PointCloud:
    """PointCloud2-content dict -> packed PointCloud on `device` (the card
    unless the CPU is asked for).

    msg keys: fields ([(name, offset, datatype)...]), point_step, width,
    height, data (bytes). x/y/z must be float32 at a common stride;
    intensity is used when present (float32), else zeros.
    """
    device = resolve_device(device)
    offsets = {}
    for name, off, dtype in msg["fields"]:
        if name in ("x", "y", "z", "intensity"):
            if dtype != _FLOAT32:
                raise ValueError(f"field {name} must be float32")
            offsets[name] = int(off)
    for req in ("x", "y", "z"):
        if req not in offsets:
            raise ValueError(f"missing field {req}")
    if not (offsets["y"] == offsets["x"] + 4
            and offsets["z"] == offsets["x"] + 8):
        raise ValueError("x/y/z must be contiguous float32")
    n_points = int(msg["width"]) * int(msg.get("height", 1))
    xyz, inten, count = native.pack_cloud(
        bytes(msg["data"]), n_points, int(msg["point_step"]),
        offsets["x"], offsets.get("intensity", -1), capacity,
        transform=transform)
    return PointCloud(xyz=torch.as_tensor(xyz, device=device),
                      intensity=torch.as_tensor(inten, device=device),
                      count=torch.tensor(count, dtype=torch.int32,
                                         device=device))


def image_to_array(msg: Dict) -> np.ndarray:
    """sensor_msgs/Image-content dict -> (H, W, 3) float32 RGB (host).

    Accepts encodings rgb8 and bgr8 (the cv_bridge conversion the
    reference requests is "rgb8", :84).
    """
    h, w = int(msg["height"]), int(msg["width"])
    step = int(msg.get("step", w * 3))
    enc = msg.get("encoding", "rgb8")
    raw = np.frombuffer(bytes(msg["data"]), np.uint8)
    img = raw.reshape(h, step)[:, : w * 3].reshape(h, w, 3)
    if enc == "bgr8":
        img = img[..., ::-1]
    elif enc != "rgb8":
        raise ValueError(f"unsupported encoding {enc}")
    return img.astype(np.float32)
