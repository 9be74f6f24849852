"""The benchmark's traffic: one synthetic traffic scene a rig, rendered on
the host from the run's seed.

A frozen copy of the program's scene generator (`io/scene.py`'s
SyntheticScene, `runtime/stream.py`'s FleetPool and
`types.PointCloud.pack_host`), kept here so that a change to the program
cannot move the yardstick. With FleetPool's seeds (scene seed r, extras
drawn from default_rng(1000 + r)) it renders FleetPool's tick 0 exactly
(tests/test_bench_scene.py checks it); a run takes those scenes in an
order drawn from its seed.

Frames come out as uint8 (every pixel of the render is an integer in
[0, 255]); clouds packed valid-first to the capacity, padded with
PAD_SENTINEL.
"""

from __future__ import annotations

import numpy as np

PAD_SENTINEL = 1.0e8

# (label, R, G, B): the class palette of the synthetic detector data
CLASS_COLORS = np.array([
    [9, 220, 60, 50], [2, 40, 200, 80], [0, 60, 80, 230], [1, 200, 180, 40],
    [3, 150, 255, 20], [4, 250, 130, 20], [5, 230, 40, 160],
    [6, 40, 220, 220], [7, 130, 60, 150], [8, 240, 240, 240],
], np.int32)
_PALETTE = {int(row[0]): row[1:].astype(np.float32) for row in CLASS_COLORS}


class Scene:
    """Camera-frame world: y-down, z-forward, ground at y = cam_height; a
    list of moving boxes (center, velocity, size, label)."""

    def __init__(self, fx, fy, cx, cy, height, width, seed: int,
                 n_ground: int, cam_height: float = 1.8):
        rng = np.random.default_rng(seed)
        # the cloud is a pure function of (seed, t)
        self.cloud_seed = int(rng.integers(2**31))
        self.cam_height = cam_height
        self.n_ground = n_ground
        self.hw = (height, width)
        self.objects = []
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

    def add(self, center, velocity, size, label) -> None:
        self.objects.append((np.asarray(center, np.float64),
                             np.asarray(velocity, np.float64),
                             tuple(size), int(label)))

    def add_default_traffic(self) -> None:
        self.add([1.5, 1.1, 12.0], [0.0, 0.0, -2.0], (1.8, 1.4, 4.2), 9)
        self.add([-2.5, 0.95, 18.0], [0.5, 0.0, 0.0], (0.5, 1.7, 0.5), 2)

    def add_default_statics(self) -> None:
        self.add([3.5, -2.2, 14.0], [0.0, 0.0, 0.0], (0.4, 1.0, 0.4), 5)
        self.add([-4.0, -2.0, 18.0], [0.0, 0.0, 0.0], (0.4, 1.0, 0.4), 3)
        self.add([4.2, -0.8, 10.0], [0.0, 0.0, 0.0], (0.8, 0.8, 0.15), 7)

    def cloud_at(self, t: float) -> np.ndarray:
        """(N, 3) f32 camera-frame points at time t: a ground plane and 220
        points a cubic metre of each box (at least 40)."""
        rng = np.random.default_rng(self.cloud_seed + int(t * 1e3))
        gx = rng.uniform(-12, 12, self.n_ground)
        gz = rng.uniform(1.5, 55, self.n_ground)
        gy = np.full(self.n_ground, self.cam_height) + \
            rng.normal(0, 0.004, self.n_ground)
        pts = [np.stack([gx, gy, gz], 1)]
        for center, velocity, (w, h, d), _ in self.objects:
            c = center + velocity * t
            n = max(int(max(w * h * d, 1e-3) * 220.0), 40)
            pts.append(np.stack([
                rng.uniform(c[0] - w / 2, c[0] + w / 2, n),
                rng.uniform(c[1] - h / 2, c[1] + h / 2, n),
                rng.uniform(c[2] - d / 2, c[2] + d / 2, n)], 1))
        return np.concatenate(pts).astype(np.float32)

    def image_at(self, t: float) -> np.ndarray:
        """(H, W, 3) uint8 render: grey with a brighter upper half, each
        box that projects in front of the camera a block of its class
        colour."""
        h, w = self.hw
        img = np.full((h, w, 3), 96.0, np.float32)
        img[: h // 2] += 40.0
        for i, (center, velocity, size, label) in enumerate(self.objects):
            c = center + velocity * t
            if c[2] <= 0.5:
                continue
            corners = self._project_extent(c, size)
            if corners is None:
                continue
            (x0, y0), (x1, y1) = corners
            x0, x1 = max(0, int(x0)), min(w, int(x1))
            y0, y1 = max(0, int(y0)), min(h, int(y1))
            if x1 <= x0 or y1 <= y0:
                continue
            img[y0:y1, x0:x1] = _PALETTE.get(label, np.array(
                [(60 + 97 * i) % 255, (170 + 53 * i) % 255,
                 (220 + 31 * i) % 255], np.float32))
        return img.astype(np.uint8)

    def _project_extent(self, center, size):
        w, h, d = size
        pts = np.array([(center[0] + a, center[1] + b, center[2] + c)
                        for a in (-w / 2, w / 2) for b in (-h / 2, h / 2)
                        for c in (-d / 2, d / 2)])
        if (pts[:, 2] <= 0.1).any():
            return None
        uv = pts @ self.K.T
        uv = uv[:, :2] / uv[:, 2:3]
        return ((uv[:, 0].min(), uv[:, 1].min()),
                (uv[:, 0].max(), uv[:, 1].max()))


def pack_cloud(xyz: np.ndarray, capacity: int):
    """Drop non-finite points, stride-subsample an overflow, pad with the
    sentinel: ((capacity, 3) f32, count)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    xyz = xyz[np.isfinite(xyz).all(axis=1)]
    if xyz.shape[0] > capacity:
        xyz = xyz[np.linspace(0, xyz.shape[0] - 1, capacity).astype(np.int64)]
    out = np.full((capacity, 3), PAD_SENTINEL, np.float32)
    out[:xyz.shape[0]] = xyz
    return out, xyz.shape[0]


def rig_seeds(seed: int, n_rigs: int):
    """(scene seeds, extras seeds) of a run: FleetPool's
    scenes (scene seed r, extras drawn from default_rng(1000 + r), r <
    n_rigs, their own 0-2 extra cars) in an order drawn from the run's
    seed. Every seed renders the same scenes, so the same work; the seed
    moves them between the rigs (and draws each tick's perturbations)."""
    perm = np.random.default_rng(np.random.SeedSequence(int(seed))
                                 ).permutation(n_rigs)
    return [int(r) for r in perm], [1000 + int(r) for r in perm]


def render_pool(cam: dict, max_points: int, scene_seeds, extras_seeds):
    """Each rig's scene at its own time: the default traffic and statics
    plus extra cars (rng = default_rng(extras seed): their count in
    [0, 3), each car's place and speed, then the time in [0, 2)). cam: camera_image_height / _width, fx, fy,
    cx, cy. Returns (images (R, H, W, 3) uint8, xyz (R, P, 3) f32, count
    (R,) int32)."""
    n = len(scene_seeds)
    h, w = cam["camera_image_height"], cam["camera_image_width"]
    images = np.empty((n, h, w, 3), np.uint8)
    xyz = np.empty((n, max_points, 3), np.float32)
    count = np.empty((n,), np.int32)
    for r in range(n):
        scene = Scene(cam["fx"], cam["fy"], cam["cx"], cam["cy"], h, w,
                      scene_seeds[r], max_points // 2)
        scene.add_default_traffic()
        scene.add_default_statics()
        rng = np.random.default_rng(extras_seeds[r])
        for _ in range(int(rng.integers(0, 3))):
            scene.add([rng.uniform(-4, 4), 1.2, rng.uniform(8, 35)],
                      [rng.uniform(-1, 1), 0.0, rng.uniform(-3, 1)],
                      (1.8, 1.4, 4.2), 9)
        t = float(rng.uniform(0.0, 2.0))
        images[r] = scene.image_at(t)
        xyz[r], count[r] = pack_cloud(scene.cloud_at(t), max_points)
    return images, xyz, count
