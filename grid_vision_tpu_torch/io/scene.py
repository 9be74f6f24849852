"""Synthetic scene generation: temporal camera+LiDAR sequences (a copy of
grid_vision_tpu/io/scene.py, kept here so this package never imports the
JAX package; the same seed gives the same frames and clouds).

Replaces the reference's CARLA topics (config/grid_vision_cfg.yaml:3-4)
as the test/benchmark data source: a ground plane, moving box-shaped
objects, and a pinhole camera render of colored blobs where the objects
project. Deterministic given the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import GridVisionConfig

# (label, R, G, B): the class palette of the JAX package's synthetic
# detector training data (grid_vision_tpu/train/synth_data.CLASS_COLORS).
CLASS_COLORS = np.array([
    [9, 220, 60, 50],     # vehicle
    [2, 40, 200, 80],     # person
    [0, 60, 80, 230],     # bike
    [1, 200, 180, 40],    # motorbike
    [3, 150, 255, 20],    # green light
    [4, 250, 130, 20],    # orange light
    [5, 230, 40, 160],    # red light
    [6, 40, 220, 220],    # sign 30
    [7, 130, 60, 150],    # sign 60
    [8, 240, 240, 240],   # sign 90
], np.int32)


@dataclasses.dataclass
class MovingObject:
    center: np.ndarray   # camera-frame (x, y, z) at t=0
    velocity: np.ndarray  # m/s in camera frame
    size: Tuple[float, float, float]  # (w_x, h_y, d_z) extents
    label: int           # ObjectClass id
    points_per_m3: float = 220.0


class SyntheticScene:
    """Camera-frame world: y-down, z-forward, ground at y = cam_height."""

    def __init__(self, cfg: GridVisionConfig, seed: int = 0,
                 cam_height: float = 1.8, n_ground: int = 6000):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        # cloud_at must be PURE in t: replay prefetch workers render
        # frames out of order, and a stateful draw per call would make
        # the sequence depend on scheduling.
        self._cloud_seed = int(self.rng.integers(2**31))
        self.cam_height = cam_height
        self.n_ground = n_ground
        self.objects: List[MovingObject] = []
        self.K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy],
                           [0, 0, 1]], np.float32)

    def add_object(self, center, velocity, size, label) -> None:
        self.objects.append(MovingObject(
            center=np.asarray(center, np.float64),
            velocity=np.asarray(velocity, np.float64),
            size=tuple(size), label=int(label)))

    def add_default_traffic(self) -> None:
        self.add_object([1.5, 1.1, 12.0], [0.0, 0.0, -2.0],
                        (1.8, 1.4, 4.2), 9)   # approaching vehicle
        self.add_object([-2.5, 0.95, 18.0], [0.5, 0.0, 0.0],
                        (0.5, 1.7, 0.5), 2)   # crossing person (standard
                                              #  1.7 m pedestrian, feet on
                                              #  the ground plane)

    def add_default_statics(self) -> None:
        """Fixed roadside furniture covering the static classes the
        reference renders distinctly (grid_vision_node.cpp:405-523:
        colored light spheres, "SPEED LIMIT: N KMPH" sign text)."""
        self.add_object([3.5, -2.2, 14.0], [0.0, 0.0, 0.0],
                        (0.4, 1.0, 0.4), 5)   # red light on a mast
        self.add_object([-4.0, -2.0, 18.0], [0.0, 0.0, 0.0],
                        (0.4, 1.0, 0.4), 3)   # green light
        self.add_object([4.2, -0.8, 10.0], [0.0, 0.0, 0.0],
                        (0.8, 0.8, 0.15), 7)  # speed-limit 60 sign

    def add_random_traffic(self, rng: np.random.Generator,
                           n_dynamic: int = 2, n_static: int = 2) -> None:
        """Randomized traffic spanning ALL TEN reference classes
        (object_detection.hpp:12-25): dynamic road users at ground level
        plus static lights/signs on masts. Shared by the scene training
        dataset (train/scene_dataset.py) and the held-out scene eval
        (train/eval_map.heldout_scene) so both worlds exercise the full
        taxonomy."""
        for _ in range(n_dynamic):
            r = rng.random()
            if r < 0.45:      # vehicle
                self.add_object(
                    [rng.uniform(-5, 5), 1.2, rng.uniform(6, 40)],
                    [rng.uniform(-1, 1), 0.0, rng.uniform(-3, 1)],
                    (1.8, 1.4, 4.2), 9)
            elif r < 0.70:    # person
                self.add_object(
                    [rng.uniform(-4, 4), 0.9, rng.uniform(4, 25)],
                    [rng.uniform(-1.2, 1.2), 0.0, rng.uniform(-0.5, 0.5)],
                    (0.5, 1.7, 0.5), 2)
            elif r < 0.85:    # bike
                self.add_object(
                    [rng.uniform(-4, 4), 1.2, rng.uniform(5, 28)],
                    [rng.uniform(-1.5, 1.5), 0.0, rng.uniform(-1, 1)],
                    (0.5, 1.2, 1.8), 0)
            else:             # motorbike
                self.add_object(
                    [rng.uniform(-5, 5), 1.2, rng.uniform(5, 32)],
                    [rng.uniform(-2, 2), 0.0, rng.uniform(-3, 1)],
                    (0.7, 1.3, 2.2), 1)
        for _ in range(n_static):
            label = int(rng.choice([3, 4, 5, 6, 7, 8]))
            side = 1.0 if rng.random() < 0.5 else -1.0
            if label <= 5:    # traffic light: ~4 m up a mast
                self.add_object(
                    [side * rng.uniform(2.5, 6.0),
                     rng.uniform(-2.6, -1.8), rng.uniform(8, 24)],
                    [0.0, 0.0, 0.0], (0.4, 1.0, 0.4), label)
            else:             # speed sign: ~2.5 m up, faces the camera
                self.add_object(
                    [side * rng.uniform(3.0, 6.5),
                     rng.uniform(-1.1, -0.5), rng.uniform(6, 22)],
                    [0.0, 0.0, 0.0], (0.8, 0.8, 0.15), label)

    def cloud_at(self, t: float) -> np.ndarray:
        """Camera-frame (N, 3) LiDAR points at time t (deterministic in
        (seed, t) — see __init__)."""
        rng = np.random.default_rng(self._cloud_seed + int(t * 1e3))
        gx = rng.uniform(-12, 12, self.n_ground)
        gz = rng.uniform(1.5, 55, self.n_ground)
        gy = np.full(self.n_ground, self.cam_height) + \
            rng.normal(0, 0.004, self.n_ground)
        pts = [np.stack([gx, gy, gz], 1)]
        for obj in self.objects:
            c = obj.center + obj.velocity * t
            w, h, d = obj.size
            vol = max(w * h * d, 1e-3)
            n = max(int(vol * obj.points_per_m3), 40)
            pts.append(np.stack([
                rng.uniform(c[0] - w / 2, c[0] + w / 2, n),
                rng.uniform(c[1] - h / 2, c[1] + h / 2, n),
                rng.uniform(c[2] - d / 2, c[2] + d / 2, n),
            ], 1))
        return np.concatenate(pts).astype(np.float32)

    def image_at(self, t: float) -> np.ndarray:
        """(H, W, 3) float32 RGB render: gray background + class-colored
        boxes where objects project, in the class palette the JAX
        package's synthetic detector trainer uses."""
        palette = {int(row[0]): row[1:].astype(np.float32)
                   for row in CLASS_COLORS}
        cfg = self.cfg
        h, w = cfg.camera_image_height, cfg.camera_image_width
        img = np.full((h, w, 3), 96.0, np.float32)
        # horizon gradient
        img[: h // 2] += 40.0
        for i, obj in enumerate(self.objects):
            c = obj.center + obj.velocity * t
            if c[2] <= 0.5:
                continue
            corners = self._project_extent(c, obj.size)
            if corners is None:
                continue
            (x0, y0), (x1, y1) = corners
            x0, x1 = max(0, int(x0)), min(w, int(x1))
            y0, y1 = max(0, int(y0)), min(h, int(y1))
            if x1 <= x0 or y1 <= y0:
                continue
            color = palette.get(obj.label, np.array(
                [(60 + 97 * i) % 255, (170 + 53 * i) % 255,
                 (220 + 31 * i) % 255], np.float32))
            img[y0:y1, x0:x1] = color
        return img

    def bbox_at(self, obj_idx: int, t: float):
        """Ground-truth pixel bbox of object obj_idx at time t (or None)."""
        obj = self.objects[obj_idx]
        c = obj.center + obj.velocity * t
        if c[2] <= 0.5:
            return None
        corners = self._project_extent(c, obj.size)
        if corners is None:
            return None
        (x0, y0), (x1, y1) = corners
        return {"x_min": x0, "y_min": y0, "x_max": x1, "y_max": y1,
                "label": obj.label}

    def _project_extent(self, center, size):
        w, h, d = size
        dx = np.array([-w / 2, w / 2])
        dy = np.array([-h / 2, h / 2])
        dz = np.array([-d / 2, d / 2])
        pts = np.array([(center[0] + a, center[1] + b, center[2] + c)
                        for a in dx for b in dy for c in dz])
        if (pts[:, 2] <= 0.1).any():
            return None
        uv = pts @ self.K.T
        uv = uv[:, :2] / uv[:, 2:3]
        return ((uv[:, 0].min(), uv[:, 1].min()),
                (uv[:, 0].max(), uv[:, 1].max()))
