"""Multi-rig shared-grid fusion: many sensors, one world occupancy grid
(counterpart of grid_vision_tpu/parallel/shared_grid.py).

N rigs observing the same world (a sensor hub, an intersection with
several roadside units, a convoy) fuse into one grid. Each rig's
world-frame dynamic poses rasterize to footprint hit counts; the counts
sum over the rigs, then one decay + hit x count + clamp + sigmoid update
runs on the grid. k rigs seeing a cell add k hits: independent evidence
accumulates additively in log-odds. With one rig the update is the
single-rig rasterizer's, bit for bit.

The JAX package sums the counts with one lax.psum over the ``rig`` mesh
axis. Here the rigs split over a RigMesh's shards (parallel/mesh.py): each
shard sums its rigs' counts, then the shards' sums add up in shard order on
the first shard's device. The counts are small integers in f32, so any
order is exact. The update adds hit x count with one rounding
(rasterize.hit_add), as the JAX package's jitted update does.

Every rig has its own extrinsics (leading rig axis, camera_to_base mapping
into the shared world); geometry.transform_points / transform_pose take
the stacked (R, 4, 4) transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from .. import pipeline
from ..config import GridVisionConfig
from ..geometry import intrinsic_matrix, transform_points, transform_pose
from ..ops import rasterize
from ..types import Extrinsics, LShapePoses, Obs, stack
from ..utils import prng
from .fleet import _cat, rig_slice
from .mesh import RigMesh, nets_on, rig_mesh


def _to_world(poses_cam: LShapePoses, extrinsics: Extrinsics,
              gate: torch.Tensor) -> LShapePoses:
    """Camera-frame poses -> world frame, masked by the rig's Q1 gate. One
    rig, or a leading rig axis on all three."""
    pos, quat = transform_pose(extrinsics.camera_to_base,
                               poses_cam.position, poses_cam.quat)
    return dataclasses.replace(poses_cam, position=pos, quat=quat,
                               valid=poses_cam.valid & gate[..., None])


def rig_world_poses_batch(params: Dict[str, Any], obs_b: Obs,
                          extr_b: Extrinsics, cfg: GridVisionConfig,
                          keys: torch.Tensor,
                          orientation_budget: Optional[int] = None):
    """rig_world_poses of R rigs (leading rig axis on obs_b, extr_b and
    the (R, 2) keys): one batch-R detector call, then the rigs' pose branch
    and each rig's transform into the world. Vision: the fleet-compacted
    crop batch (pipeline._fleet_vision_poses: one net call for these rigs,
    orientation_budget over them; None keeps every rig's
    max_orientation_batch slots, which equals each rig's own crop chain,
    as pipeline.fleet_step does). PCA: the RANSAC branch on the rig batch,
    each rig's key. Returns (poses (R, cap), dropped () int32: valid
    dynamic detections lost to the budget, 0 without one)."""
    dev = obs_b.image.device
    boxes, _ = pipeline.detect_batch(params, obs_b.image, cfg)
    boxes = dataclasses.replace(
        boxes, valid=boxes.valid & obs_b.has_image[:, None])
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.use_vision_orientation:
        budget = (boxes.valid.shape[0] * cfg.max_orientation_batch
                  if orientation_budget is None else orientation_budget)
        poses_cam, dropped_b = pipeline._fleet_vision_poses(
            params, obs_b.image, boxes, K, cfg, budget)
        dropped = dropped_b.sum(dtype=torch.int32)
    else:
        cloud_cam = transform_points(extr_b.lidar_to_camera,
                                     obs_b.cloud.xyz)
        cloud_valid = obs_b.cloud.mask() & obs_b.has_cloud[:, None]
        poses_cam, _trunc = pipeline._pca_poses(cloud_cam, cloud_valid,
                                                boxes, K, keys, cfg)
    return (_to_world(poses_cam, extr_b, obs_b.has_image | obs_b.has_cloud),
            dropped)


def rig_world_poses(params: Dict[str, Any], obs: Obs,
                    extrinsics: Extrinsics, cfg: GridVisionConfig,
                    rng: torch.Tensor) -> LShapePoses:
    """One rig's dynamic-object poses in the WORLD frame (the rig's
    camera_to_base maps into the shared world): the pose section of
    pipeline.fuse, its valid masked by the Q1 gate (a silent rig adds
    nothing). rng is the rig's (2,) key (the PCA branch's RANSAC draws)."""
    poses, _ = rig_world_poses_batch(params, stack([obs]),
                                     stack([extrinsics]), cfg, rng[None])
    return poses.select(0)


def shard_world_poses(params: Dict[str, Any], obs_b: Obs,
                      extr_b: Extrinsics, keys: torch.Tensor,
                      cfg: GridVisionConfig,
                      poses_fn: Optional[Callable] = None,
                      orientation_budget: Optional[int] = None):
    """(world-frame poses (R, cap), dropped) of one shard's rigs:
    rig_world_poses_batch, or poses_fn(params, obs, extrinsics, cfg, key)
    rig by rig (tests inject known poses; no budget applies)."""
    if poses_fn is None:
        return rig_world_poses_batch(params, obs_b, extr_b, cfg, keys,
                                     orientation_budget)
    poses = stack([poses_fn(params, obs_b.select(r), extr_b.select(r), cfg,
                            keys[r]) for r in range(keys.shape[0])])
    return poses, torch.zeros((), dtype=torch.int32, device=keys.device)


def shard_hit_counts(params: Dict[str, Any], obs_b: Obs, extr_b: Extrinsics,
                     keys: torch.Tensor, cfg: GridVisionConfig,
                     poses_fn: Optional[Callable] = None,
                     orientation_budget: Optional[int] = None):
    """One shard's evidence: (counts (H, W) summed over its rigs, dropped)
    (shard_world_poses; the budget over the shard's rigs, as the JAX
    package applies it inside shard_map)."""
    poses, dropped = shard_world_poses(params, obs_b, extr_b, keys, cfg,
                                       poses_fn, orientation_budget)
    return rasterize.lshape_hit_counts(poses, cfg).sum(dim=0), dropped


def shared_grid_step(params: Dict[str, Any], log_odds: torch.Tensor,
                     obs_b: Obs, extr_b: Extrinsics, keys: torch.Tensor,
                     cfg: GridVisionConfig,
                     poses_fn: Optional[Callable] = None,
                     orientation_budget: Optional[int] = None,
                     mesh: Optional[RigMesh] = None,
                     params_on: Optional[Callable] = None):
    """One fused world-grid tick over a batch of rigs.

    obs_b / extr_b / keys carry a leading rig axis. With a mesh, each
    shard computes its rigs' hit counts (shard_hit_counts) on its device
    and the counts and drops sum in shard order on log_odds's device
    before the single grid update (the JAX package's psum); without one,
    the batch is one shard. params_on(device) gives the nets on a shard's
    device (default: params as given). Returns (log_odds', occupancy',
    dropped): dropped is the fleet-wide count of valid dynamic detections
    lost to the budget (0 without one)."""
    dev = log_odds.device
    n = keys.shape[0]
    parts = ([(dev, 0, n)] if mesh is None else list(mesh.shards(n)))
    counts = dropped = None
    for sdev, a, b in parts:
        c, d = shard_hit_counts(
            params if params_on is None else params_on(sdev),
            *(rig_slice(v, a, b, sdev) for v in (obs_b, extr_b)),
            keys[a:b].to(sdev), cfg, poses_fn, orientation_budget)
        c, d = c.to(dev), d.to(dev)
        counts = c if counts is None else counts + c
        dropped = d if dropped is None else dropped + d
    lo = rasterize.hit_add(log_odds + cfg.log_odds_decay, cfg.log_odds_hit,
                           counts)
    lo, occ = rasterize._finish(lo, cfg)
    return lo, occ, dropped


class RigPoses:
    """The rig side of the hub and of the city grid: n_rigs rigs split over
    a RigMesh's shards (default: rig_mesh(), one a visible card), their nets
    on each shard's device, a tick's rig keys, and their world-frame
    poses."""

    def __init__(self, cfg: GridVisionConfig, n_rigs: int,
                 mesh: Optional[RigMesh] = None,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 poses_fn: Optional[Callable] = None):
        cfg.validate()
        self.cfg = cfg
        self.n_rigs = n_rigs
        self.mesh = mesh or rig_mesh()
        if n_rigs % self.mesh.size:
            raise ValueError(f"n_rigs {n_rigs} % shards {self.mesh.size} "
                             "!= 0")
        self.device = self.mesh.home
        self.poses_fn = poses_fn
        # injected poses need no nets (the JAX package's params={})
        self.params = ({} if params is not None and not params else
                       pipeline.Engine(cfg, params=params, seed=seed,
                                       device=self.device).params)
        self._params = {self.device: self.params}

    def params_on(self, dev: torch.device) -> Dict[str, Any]:
        """The nets (and their kernels' folded constants) on `dev`."""
        p = self._params.get(dev)
        if p is None:
            nets = nets_on(self.params, dev)
            p = self._params[dev] = (pipeline.Engine(
                self.cfg, params=nets, device=dev).params if nets else {})
        return p

    def step_keys(self, step_key: torch.Tensor) -> torch.Tensor:
        """A tick's (n_rigs, 2) rig keys: jax.random.split(step_key,
        n_rigs)."""
        return prng.split(step_key.to(self.device), self.n_rigs)

    def world_poses(self, obs_b: Obs, extr_b: Extrinsics,
                    keys: torch.Tensor) -> LShapePoses:
        """Every rig's world-frame poses (n_rigs, cap), each shard's on its
        device, gathered on the first shard's."""
        return _cat([shard_world_poses(
            self.params_on(dev),
            *(rig_slice(v, a, b, dev) for v in (obs_b, extr_b)),
            keys[a:b].to(dev), self.cfg, self.poses_fn)[0].to(self.device)
            for dev, a, b in self.mesh.shards(self.n_rigs)])


class SharedGrid(RigPoses):
    """N rigs -> one world grid, the rigs split over a RigMesh's shards.
    The grid lives on the mesh's first device."""

    def __init__(self, cfg: GridVisionConfig, n_rigs: int,
                 mesh: Optional[RigMesh] = None,
                 params: Optional[Dict[str, Any]] = None, seed: int = 0,
                 poses_fn: Optional[Callable] = None,
                 orientation_budget: Optional[int] = None):
        cfg.validate()
        # extension knobs this fused path does not implement must fail
        # loudly, not silently diverge from pipeline.fuse semantics
        unsupported = [k for k, v in (
            ("yaw_aware_rasterization", cfg.yaw_aware_rasterization),
            ("raycast_free_space", cfg.raycast_free_space),
            ("vision_depth_refine", cfg.vision_depth_refine),
            ("grid_backend=pallas", cfg.grid_backend == "pallas"),
        ) if v]
        if unsupported:
            raise ValueError(
                f"SharedGrid does not support {unsupported}; use the "
                "per-rig fleet for those extensions")
        super().__init__(cfg, n_rigs, mesh, params, seed, poses_fn)
        self.orientation_budget = orientation_budget

    def init_grid(self) -> torch.Tensor:
        return torch.zeros(self.cfg.grid_size, dtype=torch.float32,
                           device=self.device)

    def _step(self, log_odds, obs_b, extr_b, keys):
        return shared_grid_step(
            self.params, log_odds, obs_b.to(self.device),
            extr_b.to(self.device), keys, self.cfg, self.poses_fn,
            self.orientation_budget, self.mesh, self.params_on)

    def __call__(self, log_odds: torch.Tensor, obs_b: Obs,
                 extr_b: Extrinsics, step_key: torch.Tensor):
        """-> (log_odds', occupancy', dropped): dropped is the fleet-wide
        count of detections lost to orientation_budget this tick."""
        return self._step(log_odds, obs_b, extr_b, self.step_keys(step_key))

    def call_chunk(self, log_odds: torch.Tensor, obs_c: Obs,
                   extr_b: Extrinsics, step_key: torch.Tensor):
        """K world ticks in one call. obs_c carries a leading (K, n_rigs)
        axis pair; the keys split K times, then per rig, as the JAX
        package's chunk splits them. Returns (log_odds', occupancies (K,
        H, W), one a tick, dropped over the K ticks)."""
        k = obs_c.image.shape[0]
        keys_c = prng.split(prng.split(step_key.to(self.device), k),
                            self.n_rigs)
        occs, total = [], None
        for t in range(k):
            log_odds, occ, dropped = self._step(log_odds, obs_c.select(t),
                                                extr_b, keys_c[t])
            occs.append(occ)
            total = dropped if total is None else total + dropped
        return log_odds, torch.stack(occs), total
