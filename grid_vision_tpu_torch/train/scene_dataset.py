"""Host-scene training frames for the detector: the replay-world domain
(counterpart of grid_vision_tpu/train/scene_dataset.py).

The on-device rectangle world (synth_data.py) teaches class colors and box
regression; the engine's input is the host SyntheticScene renderer
(io/scene.py): perspective-projected 3D boxes with depth shading, a ground
plane and a horizon. This module renders a fixed set of scene frames once
on the host with dense anchor targets (train/targets.py); the trainer
uploads them to the card once (the frames as uint8) and draws its scene
batches there.

Seeds: training scenes use seeds >= 2000; the held-out eval sources use
seed 500 (scene) and PRNGKey(7.7M) (synth).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import GridVisionConfig
from ..io.scene import SyntheticScene
from ..models.yolov4_tiny import YoloConfig
from .targets import assign_targets


def build_scene_dataset(n_frames: int, cfg: GridVisionConfig,
                        ycfg: YoloConfig, seed: int = 2000,
                        two_wheeler_boost: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Render `n_frames` randomized-traffic frames with dense targets.

    Returns (images (N, H, W, 3) uint8, tgt_boxes (N, A, 4) f32, tgt_class
    (N, A) i32, tgt_pos (N, A) f32); images at full camera resolution, so
    the trainer applies the production resize.

    two_wheeler_boost: probability per frame of adding 1-2 far (z 12-38 m)
    bikes / motorbikes, the weak classes of the base traffic mix; the
    held-out eval frames (seeds 500+) are untouched."""
    rng = np.random.default_rng(seed)
    h, w = cfg.camera_image_height, cfg.camera_image_width
    images = np.empty((n_frames, h, w, 3), np.uint8)
    tb = np.empty((n_frames, ycfg.num_anchors_total, 4), np.float32)
    tc = np.empty((n_frames, ycfg.num_anchors_total), np.int32)
    tp = np.empty((n_frames, ycfg.num_anchors_total), np.float32)
    for i in range(n_frames):
        scene = SyntheticScene(cfg, seed=seed + i)
        scene.add_default_traffic()
        # full-taxonomy random traffic (all 10 classes)
        scene.add_random_traffic(rng,
                                 n_dynamic=int(rng.integers(0, 4)),
                                 n_static=int(rng.integers(0, 4)))
        if two_wheeler_boost and rng.random() < two_wheeler_boost:
            for _ in range(int(rng.integers(1, 3))):
                z = float(rng.uniform(12.0, 38.0))   # far = small box
                x = float(rng.uniform(-5.0, 5.0))
                if rng.random() < 0.5:               # bike
                    scene.add_object(
                        [x, 1.2, z],
                        [rng.uniform(-1.5, 1.5), 0.0, rng.uniform(-1, 1)],
                        (0.5, 1.2, 1.8), 0)
                else:                                # motorbike
                    scene.add_object(
                        [x, 1.2, z],
                        [rng.uniform(-2, 2), 0.0, rng.uniform(-3, 1)],
                        (0.7, 1.3, 2.2), 1)
        t = float(rng.uniform(0.0, 3.0))
        images[i] = np.clip(scene.image_at(t), 0, 255).astype(np.uint8)
        gts = []
        for j in range(len(scene.objects)):
            bb = scene.bbox_at(j, t)
            if bb is None:
                continue
            x0 = max(0.0, bb["x_min"]) / w
            y0 = max(0.0, bb["y_min"]) / h
            x1 = min(float(w), bb["x_max"]) / w
            y1 = min(float(h), bb["y_max"]) / h
            if (x1 - x0) * w < 2.0 or (y1 - y0) * h < 2.0:
                continue
            gts.append({"x_min": x0, "y_min": y0, "x_max": x1,
                        "y_max": y1, "label": bb["label"]})
        tb[i], tc[i], tp[i] = assign_targets(gts, ycfg)
    return images, tb, tc, tp
