"""City-scale occupancy grid, its rows split over the shards of a rig mesh
(counterpart of grid_vision_tpu/parallel/city_grid.py).

The reference grid is one vehicle's 50 x 20 m map (500 x 200 cells). A
metropolitan deployment wants one persistent world grid covering
kilometres, fed by many rigs. The grid's rows split over the mesh's
shards; the object poses (kilobytes) go to every shard, and each shard
rasterizes the full pose set against its own row window (row0). Cell
updates are independent, so there is no halo and no exchange: a footprint
across a slab boundary rasterizes partly on each slab, and the slabs
compose exactly. The per-cell math (decay + hit x count with one rounding,
clamp, sigmoid) is the local rasterizer's (ops/rasterize.py).

The default CityGridSpec is 4000 x 2000 cells, 32 MB of f32 log-odds: one
H100 holds it whole. The grid lives on the mesh's first device; a slab on
another shard's device is computed on a copy of its rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..ops.rasterize import (corner_window_counts, hit_add,
                             pose_footprint_corners)
from ..types import Extrinsics, LShapePoses, Obs, _map
from .mesh import RigMesh, rig_mesh


@dataclasses.dataclass(frozen=True)
class CityGridSpec:
    """World-grid geometry (grid_map conventions, as GridVisionConfig: x
    forward in meters, centered at `center`)."""
    length_x: float = 400.0          # meters
    length_y: float = 200.0
    resolution: float = 0.1
    center: Tuple[float, float] = (0.0, 0.0)
    log_odds_decay: float = -0.2
    log_odds_hit: float = 0.85
    min_log_odds: float = -2.0
    max_log_odds: float = 3.6

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(round(self.length_x / self.resolution)),
                int(round(self.length_y / self.resolution)))


def slab_hit_counts(poses: LShapePoses, spec: CityGridSpec, row0: int,
                    slab_h: int) -> torch.Tensor:
    """(slab_h, W) footprint cover counts of the global row window [row0,
    row0 + slab_h): rasterize.corner_window_counts with this spec's
    geometry (the off-map skip is the local rasterizer's)."""
    _, w = spec.shape
    return corner_window_counts(
        pose_footprint_corners(poses), poses.valid, spec.center,
        (spec.length_x, spec.length_y), spec.resolution, slab_h, w,
        row0=row0)


def city_update(log_odds: torch.Tensor, poses: LShapePoses,
                spec: CityGridSpec, row0: int = 0):
    """decay + hit x count + clamp + sigmoid on one slab (rows row0...)."""
    counts = slab_hit_counts(poses, spec, row0, log_odds.shape[0])
    lo = hit_add(log_odds + spec.log_odds_decay, spec.log_odds_hit, counts)
    lo = torch.clamp(lo, spec.min_log_odds, spec.max_log_odds)
    return lo, 1.0 / (1.0 + torch.exp(-lo))


class CityGrid:
    """The world grid, its rows split over the mesh's shards."""

    def __init__(self, spec: CityGridSpec, mesh: Optional[RigMesh] = None):
        self.spec = spec
        self.mesh = mesh or rig_mesh()
        h, _ = spec.shape
        if h % self.mesh.size:
            raise ValueError(f"grid rows {h} % shards {self.mesh.size} != 0")
        self.slab_h = h // self.mesh.size
        self.device = self.mesh.home

    def init_grid(self) -> torch.Tensor:
        return torch.zeros(self.spec.shape, dtype=torch.float32,
                           device=self.device)

    def update(self, log_odds: torch.Tensor, poses: LShapePoses):
        """One tick: world-frame poses (every rig's, flattened to one slot
        axis) -> (log_odds', occupancy'), each slab on its shard."""
        los, occs = [], []
        for s, dev in enumerate(self.mesh.devices):
            row0 = s * self.slab_h
            lo, occ = city_update(
                log_odds[row0:row0 + self.slab_h].to(dev), poses.to(dev),
                self.spec, row0)
            los.append(lo.to(self.device))
            occs.append(occ.to(self.device))
        if len(los) == 1:
            return los[0], occs[0]
        return torch.cat(los), torch.cat(occs)


class CityFusion:
    """End to end: N rigs (split over the mesh's shards) run detection and
    pose estimation, their WORLD-frame poses gather (kilobytes), and the
    city grid rasterizes them against its slabs: rig parallelism for the
    sensors, spatial parallelism for the map."""

    def __init__(self, spec: CityGridSpec, cfg, n_rigs: int,
                 mesh: Optional[RigMesh] = None,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 poses_fn: Optional[Callable] = None):
        from .shared_grid import RigPoses
        self.cfg = cfg
        self.spec = spec
        self.n_rigs = n_rigs
        self.rigs = RigPoses(cfg, n_rigs, mesh=mesh, params=params,
                             seed=seed, poses_fn=poses_fn)
        self.mesh = self.rigs.mesh
        self.params = self.rigs.params
        self.city = CityGrid(spec, mesh=self.mesh)

    def init_grid(self) -> torch.Tensor:
        return self.city.init_grid()

    def step(self, log_odds: torch.Tensor, obs_b: Obs, extr_b: Extrinsics,
             step_key: torch.Tensor):
        """-> (log_odds', occupancy'): every rig's world-frame poses,
        flattened to one slot axis of n_rigs x cap, on the city grid."""
        poses = self.rigs.world_poses(obs_b, extr_b,
                                      self.rigs.step_keys(step_key))
        return self.city.update(log_odds, _map(poses,
                                               lambda t: t.flatten(0, 1)))
