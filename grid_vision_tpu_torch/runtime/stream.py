"""Observations for driving the engine from SyntheticScenes (counterpart of
obs_from_scene in grid_vision_tpu/runtime/stream.py, and of the fleet
scene pool of bench.py, build_obs_pool, which imports JAX)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GridVisionConfig
from ..device import resolve_device
from ..io.scene import SyntheticScene
from ..types import Obs, PointCloud, stack


def obs_from_scene(scene: SyntheticScene, t: float, cfg: GridVisionConfig,
                   device="cuda") -> Obs:
    """The scene's frame and cloud at time t as an Obs on `device` (the
    card unless the CPU is asked for)."""
    device = resolve_device(device)
    cloud, _ = PointCloud.pack_numpy(scene.cloud_at(t), None, cfg.max_points,
                                     device=device)
    return Obs(image=torch.as_tensor(scene.image_at(t), device=device),
               cloud=cloud,
               has_image=torch.tensor(True, device=device),
               has_cloud=torch.tensor(True, device=device))


class FleetPool:
    """One traffic scene per rig, as bench.build_obs_pool builds them: rig
    r is SyntheticScene(seed=r, n_ground=max_points // 2) with the default
    traffic and statics, 0-2 extra cars drawn from default_rng(1000 + r),
    seen at a time t_r drawn from the same generator in [0, 2). Tick i
    shows every rig at t_r + 0.1 i (tick 0 is bench's pool).

    image_dtype: the frames' storage dtype (bench.build_obs_pool's; bf16 in
    the production configuration: 8-bit pixels are exact in bf16)."""

    def __init__(self, cfg: GridVisionConfig, n_rigs: int, device="cuda",
                 image_dtype=torch.float32):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.image_dtype = image_dtype
        self.scenes, self.t0 = [], []
        for r in range(n_rigs):
            scene = SyntheticScene(cfg, seed=r, n_ground=cfg.max_points // 2)
            scene.add_default_traffic()
            scene.add_default_statics()
            rng = np.random.default_rng(1000 + r)
            for _ in range(int(rng.integers(0, 3))):
                scene.add_object(
                    center=[rng.uniform(-4, 4), 1.2, rng.uniform(8, 35)],
                    velocity=[rng.uniform(-1, 1), 0.0, rng.uniform(-3, 1)],
                    size=(1.8, 1.4, 4.2), label=9)
            self.scenes.append(scene)
            self.t0.append(float(rng.uniform(0.0, 2.0)))

    def obs(self, tick: int = 0) -> Obs:
        """The fleet's Obs at tick `tick`, leading rig axis, on the pool's
        device (rendered on the host, then one copy per field)."""
        host = stack([obs_from_scene(s, t + 0.1 * tick, self.cfg, "cpu")
                      for s, t in zip(self.scenes, self.t0)])
        host = dataclasses.replace(host,
                                   image=host.image.to(self.image_dtype))
        return host.to(self.device)
