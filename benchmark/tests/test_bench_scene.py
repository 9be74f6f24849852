"""The benchmark's frozen copy of the scene generator renders what the
program's FleetPool renders for the same seeds, and a run's rigs are
drawn from its seed."""

import numpy as np
import torch

from benchmark import scene
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.runtime.stream import FleetPool


def test_copy_matches_fleet_pool():
    cfg = GridVisionConfig(max_points=8192)
    n = 5
    obs = FleetPool(cfg, n, device="cpu").obs(0)
    cam = {k: getattr(cfg, k) for k in ("camera_image_height",
                                        "camera_image_width", "fx", "fy",
                                        "cx", "cy")}
    images, xyz, count = scene.render_pool(
        cam, cfg.max_points, list(range(n)), [1000 + r for r in range(n)])
    assert torch.equal(torch.from_numpy(images).float(), obs.image)
    assert np.array_equal(xyz, obs.cloud.xyz.numpy())
    assert np.array_equal(count, obs.cloud.count.numpy())


def test_rig_seeds():
    a = scene.rig_seeds(2 ** 33 + 5, 9)
    assert a == scene.rig_seeds(2 ** 33 + 5, 9)
    b = scene.rig_seeds(2 ** 33 + 6, 9)
    assert a != b
    # every seed renders FleetPool's scenes, in its own order
    assert sorted(a[0]) == sorted(b[0]) == list(range(9))
    assert [e - s for s, e in zip(*a)] == [1000] * 9
