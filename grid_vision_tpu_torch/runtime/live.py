"""Live ingest loop: native mailboxes -> Obs -> engine (counterpart of
grid_vision_tpu/runtime/live.py).

The production equivalent of the reference's subscription callbacks and
wall timer (src/grid_vision_node.cpp:43-54): sensor producers write raw
frames into the native latest-wins mailboxes from any thread; the engine
loop polls the mailboxes at its own cadence, packs on the host through the
native runtime, and steps on the engine's device. Stale frames are reused
exactly like the reference's member buffers; missing frames degrade via
the Q1 gate semantics.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import GridVisionConfig
from ..device import resolve_device
from ..io import sensors
from ..pipeline import Engine
from ..types import Obs, PointCloud
from . import native


@dataclasses.dataclass
class LiveSource:
    """Pairs an image mailbox and a cloud mailbox into an Obs stream on
    `device` (the card unless the CPU is asked for).

    Image mailbox payload: the raw rgb8 bytes (the frame size is fixed by
    the config). Cloud mailbox payload: an interleaved float32
    x, y, z, intensity blob (16-byte stride).
    """

    cfg: GridVisionConfig
    image_box: native.Mailbox
    cloud_box: native.Mailbox
    transform_lidar_cam: Optional[np.ndarray] = None
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def publish_image(self, rgb8: np.ndarray, stamp_ns: int = 0) -> None:
        self.image_box.write(
            np.ascontiguousarray(rgb8, np.uint8).tobytes(), stamp_ns)

    def publish_cloud(self, xyz: np.ndarray,
                      intensity: Optional[np.ndarray] = None,
                      stamp_ns: int = 0) -> None:
        n = xyz.shape[0]
        blob = np.zeros((n, 4), np.float32)
        blob[:, :3] = xyz
        if intensity is not None:
            blob[:, 3] = intensity
        self.cloud_box.write(blob.tobytes(), stamp_ns)

    def poll(self) -> Obs:
        """Latest-wins read of both mailboxes -> Obs (missing sensors
        yield has_image / has_cloud = False, the Q1 gate inputs)."""
        cfg, dev = self.cfg, self.device
        h, w = cfg.camera_image_height, cfg.camera_image_width

        img_frame = self.image_box.read()
        if img_frame is not None:
            data, _stamp = img_frame
            image = sensors.image_to_array(
                {"height": h, "width": w, "encoding": "rgb8",
                 "data": data})
            has_image = True
        else:
            image = np.zeros((h, w, 3), np.float32)
            has_image = False

        cloud_frame = self.cloud_box.read()
        if cloud_frame is not None:
            data, _stamp = cloud_frame
            n_points = len(data) // 16
            xyz, inten, count = native.pack_cloud(
                data, n_points, 16, 0, 12, cfg.max_points,
                transform=self.transform_lidar_cam)
            cloud = PointCloud(
                xyz=torch.as_tensor(xyz, device=dev),
                intensity=torch.as_tensor(inten, device=dev),
                count=torch.tensor(count, dtype=torch.int32, device=dev))
            has_cloud = count > 0
        else:
            cloud = PointCloud.empty(cfg.max_points, device=dev)
            has_cloud = False

        return Obs(image=torch.as_tensor(image, device=dev), cloud=cloud,
                   has_image=torch.tensor(has_image, device=dev),
                   has_cloud=torch.tensor(has_cloud, device=dev))


def spin(engine: Engine, source: LiveSource, period_s: float = 0.05,
         max_steps: Optional[int] = None, on_step=None):
    """The reference's 50 ms wall-timer loop (grid_vision_node.cpp:49):
    poll latest frames, step, publish via on_step, sleep the remainder."""
    state = engine.init_state()
    steps = 0
    t0 = time.perf_counter()
    while max_steps is None or steps < max_steps:
        obs = source.poll()
        state, out = engine(state, obs)
        if on_step is not None:
            on_step(steps, state, out)
        steps += 1
        sleep = t0 + steps * period_s - time.perf_counter()
        if sleep > 0:
            time.sleep(sleep)
    return state
