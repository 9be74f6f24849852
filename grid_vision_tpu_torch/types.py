"""Fixed-shape, mask-carrying value types of the engine, as dataclasses of
tensors (counterpart of grid_vision_tpu/types.py).

Reference counterparts:
  Boxes      <-> std::vector<BoundingBox>   (object_detection.hpp:27-32)
  PointCloud <-> pcl::PointCloud<PointXYZI> (grid_vision_node.hpp:61)
  LShapePoses<-> std::vector<LShapePose>    (cloud_detections.hpp:19-25)
  GridState  <-> OccupancyGridMap.grid_map_ (occupancy_grid.hpp:22)
  Obs        <-> (init_image_, cloud_) latest-frame buffers

Every ``create``/``empty`` takes an explicit ``device``. The fleet path
carries the same types with a leading rig axis on every tensor
(``GridState.create_batch``, ``stack``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import GridVisionConfig
from .utils import prng


def _map(obj, fn):
    """Apply fn to every tensor field (recursing into nested types)."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        kw[f.name] = fn(v) if isinstance(v, torch.Tensor) else _map(v, fn)
    return type(obj)(**kw)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx[...], :] along the axis idx indexes (the last axis of
    idx); leading axes broadcast, trailing axes of x ride along."""
    extra = x.dim() - idx.dim()
    return torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * extra),
                                dim=idx.dim() - 1)


class _Tensors:
    def to(self, device):
        return _map(self, lambda t: t.to(device))

    def select(self, i):
        """Rig i of a stacked value (every tensor indexed on axis 0)."""
        return _map(self, lambda t: t[i])


def stack(values):
    """Stack same-typed values along a new leading rig axis."""
    first = values[0]
    kw = {}
    for f in dataclasses.fields(first):
        parts = [getattr(v, f.name) for v in values]
        kw[f.name] = (torch.stack(parts) if isinstance(parts[0], torch.Tensor)
                      else stack(parts))
    return type(first)(**kw)


@dataclasses.dataclass(frozen=True)
class Boxes(_Tensors):
    """Padded 2D detections in pixel space: xyxy (D, 4) f32, confidence
    (D,) f32, label (D,) int32, valid (D,) bool."""

    xyxy: torch.Tensor
    confidence: torch.Tensor
    label: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "Boxes":
        return Boxes(
            xyxy=torch.zeros((capacity, 4), dtype=torch.float32,
                             device=device),
            confidence=torch.zeros((capacity,), dtype=torch.float32,
                                   device=device),
            label=torch.full((capacity,), 10, dtype=torch.int32,
                             device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.xyxy.shape[-2]

    def take(self, idx: torch.Tensor, valid=None) -> "Boxes":
        """Slots idx of every field (valid overridable). idx indexes the
        slot axis and may carry leading rig axes: (R, K) picks K slots of
        each rig."""
        return Boxes(xyxy=_take_rows(self.xyxy, idx),
                     confidence=_take_rows(self.confidence, idx),
                     label=_take_rows(self.label, idx),
                     valid=(_take_rows(self.valid, idx) if valid is None
                            else valid))

    def centers(self) -> torch.Tensor:
        """``min + (max - min)/2`` (cloud_detections.cpp:57-58)."""
        lo = self.xyxy[..., 0:2]
        hi = self.xyxy[..., 2:4]
        return lo + (hi - lo) / 2.0


@dataclasses.dataclass(frozen=True)
class PointCloud(_Tensors):
    """Padded point cloud packed valid-first: xyz (P, 3), intensity (P,),
    count () int32. Rows >= count hold PAD_SENTINEL."""

    xyz: torch.Tensor
    intensity: torch.Tensor
    count: torch.Tensor

    PAD_SENTINEL = 1.0e8

    @staticmethod
    def empty(capacity: int, device=None) -> "PointCloud":
        return PointCloud(
            xyz=torch.full((capacity, 3), PointCloud.PAD_SENTINEL,
                           dtype=torch.float32, device=device),
            intensity=torch.zeros((capacity,), dtype=torch.float32,
                                  device=device),
            count=torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def pack_host(xyz: np.ndarray, intensity: np.ndarray | None,
                  capacity: int):
        """Pure-numpy packer: drop non-finite points, stride-subsample an
        overflow, pad with the sentinel. Returns (xyz (cap, 3) f32,
        intensity (cap,) f32, n, dropped)."""
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        if intensity is None:
            intensity = np.zeros((xyz.shape[0],), np.float32)
        intensity = np.asarray(intensity, np.float32).reshape(-1)
        finite = np.isfinite(xyz).all(axis=1)
        xyz, intensity = xyz[finite], intensity[finite]
        dropped = max(0, xyz.shape[0] - capacity)
        if xyz.shape[0] > capacity:
            idx = np.linspace(0, xyz.shape[0] - 1, capacity).astype(np.int64)
            xyz, intensity = xyz[idx], intensity[idx]
        n = xyz.shape[0]
        out_xyz = np.full((capacity, 3), PointCloud.PAD_SENTINEL, np.float32)
        out_int = np.zeros((capacity,), np.float32)
        out_xyz[:n] = xyz[:n]
        out_int[:n] = intensity[:n]
        return out_xyz, out_int, n, dropped

    @staticmethod
    def pack_numpy(xyz: np.ndarray, intensity: np.ndarray | None,
                   capacity: int, device=None):
        """pack_host onto `device`; returns (PointCloud, dropped)."""
        out_xyz, out_int, n, dropped = PointCloud.pack_host(
            xyz, intensity, capacity)
        return PointCloud(
            xyz=torch.as_tensor(out_xyz, device=device),
            intensity=torch.as_tensor(out_int, device=device),
            count=torch.tensor(n, dtype=torch.int32, device=device),
        ), dropped

    @staticmethod
    def from_numpy(xyz, intensity, capacity: int, device=None):
        return PointCloud.pack_numpy(xyz, intensity, capacity, device)[0]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def mask(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.xyz.device)
                < self.count[..., None])


@dataclasses.dataclass(frozen=True)
class LShapePoses(_Tensors):
    """Padded 3D object poses: position (N, 3), quat (N, 4) xyzw,
    length/width/height (N,), label (N,) int32, valid (N,) bool."""

    position: torch.Tensor
    quat: torch.Tensor
    length: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    label: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(capacity: int, device=None) -> "LShapePoses":
        f32 = dict(dtype=torch.float32, device=device)
        quat = torch.zeros((capacity, 4), **f32)
        quat[:, 3] = 1.0
        return LShapePoses(
            position=torch.zeros((capacity, 3), **f32), quat=quat,
            length=torch.zeros((capacity,), **f32),
            width=torch.zeros((capacity,), **f32),
            height=torch.zeros((capacity,), **f32),
            label=torch.full((capacity,), 10, dtype=torch.int32,
                             device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device))

    @property
    def capacity(self) -> int:
        return self.position.shape[-2]


@dataclasses.dataclass(frozen=True)
class GridState(_Tensors):
    """The engine's persistent state: log_odds / occupancy (H, W) f32 in
    grid_map buffer order, rng, step () int32.

    rng is the JAX package's threefry key layout, a (2,) uint32 tensor
    (jax.random.PRNGKey(seed)); every tick splits it as the JAX package
    does (utils/prng.py)."""

    log_odds: torch.Tensor
    occupancy: torch.Tensor
    rng: torch.Tensor
    step: torch.Tensor

    @staticmethod
    def create(cfg: GridVisionConfig, seed: int = 0,
               device=None) -> "GridState":
        h, w = cfg.grid_size
        return GridState(
            log_odds=torch.full((h, w), cfg.log_odds_prior,
                                dtype=torch.float32, device=device),
            occupancy=torch.full((h, w), cfg.init_probability,
                                 dtype=torch.float32, device=device),
            rng=prng.prng_key(seed, device=device),
            step=torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def create_batch(cfg: GridVisionConfig, n: int, seed: int = 0,
                     device=None) -> "GridState":
        """n stacked rig states; rig r's key is PRNGKey(seed + r)."""
        h, w = cfg.grid_size
        return GridState(
            log_odds=torch.full((n, h, w), cfg.log_odds_prior,
                                dtype=torch.float32, device=device),
            occupancy=torch.full((n, h, w), cfg.init_probability,
                                 dtype=torch.float32, device=device),
            rng=torch.stack([prng.prng_key(seed + r, device=device)
                             for r in range(n)]),
            step=torch.zeros((n,), dtype=torch.int32, device=device))


@dataclasses.dataclass(frozen=True)
class Obs(_Tensors):
    """One fused observation: image (H, W, 3) f32 RGB in [0, 255], cloud,
    has_image / has_cloud () bool (quirk Q1 gate inputs)."""

    image: torch.Tensor
    cloud: PointCloud
    has_image: torch.Tensor
    has_cloud: torch.Tensor

    @staticmethod
    def create(cfg: GridVisionConfig, image=None, cloud=None,
               device=None) -> "Obs":
        if image is None:
            image = torch.zeros((cfg.camera_image_height,
                                 cfg.camera_image_width, 3),
                                dtype=torch.float32, device=device)
            has_image = torch.tensor(False, device=device)
        else:
            image = torch.as_tensor(image, dtype=torch.float32,
                                    device=device)
            has_image = torch.tensor(True, device=device)
        if cloud is None:
            cloud = PointCloud.empty(cfg.max_points, device=device)
            has_cloud = torch.tensor(False, device=device)
        else:
            has_cloud = cloud.count > 0
        return Obs(image=image, cloud=cloud, has_image=has_image,
                   has_cloud=has_cloud)


@dataclasses.dataclass(frozen=True)
class Extrinsics(_Tensors):
    """4x4 homogeneous transforms replacing the reference's TF2 lookups:
    p_cam = lidar_to_camera @ p_lidar, p_base = camera_to_base @ p_cam."""

    lidar_to_camera: torch.Tensor
    camera_to_base: torch.Tensor

    @staticmethod
    def identity(device=None) -> "Extrinsics":
        eye = torch.eye(4, dtype=torch.float32, device=device)
        return Extrinsics(lidar_to_camera=eye, camera_to_base=eye.clone())


@dataclasses.dataclass(frozen=True)
class SaturationStats(_Tensors):
    """Capacity-saturation counters, int32 scalars per step (see the JAX
    package's SaturationStats for each one's meaning)."""

    prenms_overflow: torch.Tensor
    orientation_clamped: torch.Tensor
    box_cloud_truncated: torch.Tensor
    orientation_dropped: torch.Tensor
    static_depth_clamped: torch.Tensor


@dataclasses.dataclass(frozen=True)
class StepOutput(_Tensors):
    """Everything the reference publishes per tick: boxes, base-frame
    poses, static_points / static_depths (-1.0 sentinel where no depth),
    static_boxes, occupancy_i8 (int8 0..100) and saturation counters."""

    boxes: Boxes
    poses: LShapePoses
    static_points: torch.Tensor
    static_depths: torch.Tensor
    static_boxes: Boxes
    occupancy_i8: torch.Tensor
    saturation: SaturationStats
