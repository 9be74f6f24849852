"""Configuration of the PyTorch engine.

A key-for-key mirror of ``grid_vision_tpu.config.GridVisionConfig`` (same
names, defaults and ``validate()``), kept as its own copy so that this
package never imports the JAX package. It mirrors the reference node's
23 declared ROS parameters (src/grid_vision_node.cpp:8-32,
config/grid_vision_cfg.yaml:1-24) plus the fixed capacities and backend
switches of the engine.

Backend switches keep the JAX package's names and values:
``"pallas"`` selects this package's hand-written CUDA kernel for the same
function, ``"xla"`` the plain-torch port of the JAX package's XLA path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import yaml


@dataclasses.dataclass(frozen=True)
class GridVisionConfig:
    # Keys mirrored 1:1 from config/grid_vision_cfg.yaml (reference names).
    image_topic: str = "/carla/hero/front/image"
    lidar_topic: str = "/carla/hero/lidar"
    detection_weights_file: str = ""
    vision_weights_file: str = ""
    lidar_frame: str = "hero/lidar"
    camera_frame: str = "hero/front"
    base_frame: str = "hero"

    camera_image_height: int = 480
    camera_image_width: int = 640
    network_height: int = 224
    network_width: int = 224
    confidence_threshold: float = 0.6
    iou_threshold: float = 0.6
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 320.0
    cy: float = 240.0
    k_near: int = 4                  # yaml:20 (code default 10 — quirk Q9)
    grid_x: int = 50                 # meters
    grid_y: int = 20
    resolution: float = 0.1
    use_vision_orientation: bool = True
    detection_network_input_size: int = 416

    # Static capacities (padded shapes).
    max_points: int = 16384
    max_detections: int = 64
    max_candidates: int = 256
    max_orientation_batch: int = 8   # quirk Q7: clamp instead of overflow
    max_points_per_box: int = 1024
    max_static_depth: int = 64       # below max_detections: compact the
                                     # static split before the kNN
    ransac_iters: int = 128
    ransac_distance_threshold: float = 0.04
    outlier_radius: float = 0.4
    outlier_min_neighbors: int = 10

    # Occupancy-grid constants (occupancy_grid.hpp:25-31, quirk Q2).
    log_odds_prior: float = 0.0
    init_probability: float = 0.5
    log_odds_decay: float = -0.2
    min_log_odds: float = -2.0
    max_log_odds: float = 3.6
    log_odds_hit: float = 0.85

    # Engine behavior flags (no reference equivalent).
    compat: bool = True
    raycast_free_space: bool = False
    class_aware_nms: bool = False
    yaw_aware_rasterization: bool = False
    vision_depth_refine: bool = False
    compute_dtype: str = "float32"
    detector_arch: str = "yolov4-tiny"  # "yolov4": models/yolov4.py
    detector_precision: str = "float"
    grid_backend: str = "xla"        # "pallas": the ops/cuda_grid.py kernel
    detector_s2d_stem: bool = False
    detector_stem_backend: str = "xla"  # "pallas": the ops/cuda_stem.py kernel
    knn_backend: str = "xla"         # "pallas": the ops/cuda_knn.py kernel
    orientation_width: int = 32
    orientation_arch: str = "s2d"
    orientation_compute: str = "follow"
    orientation_stem_backend: str = "xla"
    orientation_s2d_fold: bool = True

    wire_image_codec: str = "rgb8"
    wire_cloud_dtype: str = "float32"

    @property
    def grid_size(self) -> Tuple[int, int]:
        """(cells_x, cells_y): round(length / resolution) per axis."""
        return (int(round(self.grid_x / self.resolution)),
                int(round(self.grid_y / self.resolution)))

    @property
    def grid_center(self) -> Tuple[float, float]:
        """Map center; integer division on a uint8 (quirk Q8)."""
        return (float(self.grid_x // 3), 0.0)

    @property
    def resize(self) -> int:
        return self.detection_network_input_size

    def validate(self) -> "GridVisionConfig":
        if math.isclose(self.resolution, 0.0):
            raise ValueError("resolution must be nonzero")
        sx, sy = self.grid_size
        if sx <= 0 or sy <= 0:
            raise ValueError(f"degenerate grid size {(sx, sy)}")
        if not (0.0 <= self.confidence_threshold <= 1.0):
            raise ValueError("confidence_threshold must be in [0, 1]")
        if not (0.0 <= self.iou_threshold <= 1.0):
            raise ValueError("iou_threshold must be in [0, 1]")
        if self.max_candidates < self.max_detections:
            raise ValueError("max_candidates must be >= max_detections")
        if self.compat and (self.raycast_free_space or self.class_aware_nms
                            or self.yaw_aware_rasterization
                            or self.vision_depth_refine
                            or self.detector_precision != "float"):
            raise ValueError(
                "extensions (raycast_free_space / class_aware_nms / "
                "yaw_aware_rasterization / vision_depth_refine / "
                "detector_precision != 'float') deviate from reference "
                "behavior; set compat=False to enable them")
        if self.detector_stem_backend not in ("xla", "pallas",
                                              "pallas2", "pallas3",
                                              "im2col"):
            raise ValueError(
                f"unknown detector_stem_backend "
                f"{self.detector_stem_backend!r}")
        if (self.detector_stem_backend != "xla"
                and self.detector_precision != "float"):
            raise ValueError(
                "detector_stem_backend != 'xla' applies only to the "
                "float detector; it would be silently ignored with "
                f"detector_precision={self.detector_precision!r}")
        if self.detector_arch not in ("yolov4-tiny", "yolov4"):
            raise ValueError(f"unknown detector_arch {self.detector_arch!r}")
        if self.detector_arch == "yolov4" and (
                self.detector_stem_backend != "xla" or self.detector_s2d_stem
                or self.detector_precision == "int8"):
            raise ValueError(
                "detector_arch='yolov4' runs the resize and the whole net on "
                "the plain path: detector_stem_backend != 'xla', "
                "detector_s2d_stem and detector_precision='int8' are built "
                "for YOLOv4-tiny's layers")
        if self.orientation_compute not in ("follow", "float32",
                                            "bfloat16"):
            raise ValueError(
                f"unknown orientation_compute {self.orientation_compute!r}")
        if self.orientation_arch not in ("s2d", "resnet"):
            raise ValueError(
                f"unknown orientation_arch {self.orientation_arch!r}")
        if self.orientation_stem_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown orientation_stem_backend "
                f"{self.orientation_stem_backend!r}")
        if self.orientation_stem_backend == "pallas" and not (
                self.orientation_arch == "s2d"
                and self.orientation_s2d_fold):
            raise ValueError(
                "orientation_stem_backend='pallas' fuses the s2d_fold "
                "stem; it requires orientation_arch='s2d' and "
                "orientation_s2d_fold=True")
        if self.orientation_stem_backend == "pallas" and (
                self.network_height % 8):
            raise ValueError(
                "orientation_stem_backend='pallas' needs "
                "network_height % 8 == 0")
        if self.detector_precision not in ("float", "int8"):
            raise ValueError(
                f"unknown detector_precision {self.detector_precision!r}")
        if self.wire_image_codec not in ("rgb8", "yuv420"):
            raise ValueError(
                f"unknown wire_image_codec {self.wire_image_codec!r}")
        if self.wire_cloud_dtype not in ("float32", "float16"):
            raise ValueError(
                f"unknown wire_cloud_dtype {self.wire_cloud_dtype!r}")
        if self.wire_image_codec == "yuv420" and (
                self.camera_image_height % 2 or self.camera_image_width % 2):
            raise ValueError("yuv420 wire codec needs even image dims")
        for name in ("max_points", "max_detections", "k_near",
                     "ransac_iters", "max_static_depth"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")
        return self


_YAML_KEYS = {f.name for f in dataclasses.fields(GridVisionConfig)}
# keys of this package that the JAX package's GridVisionConfig lacks
PORT_ONLY = ("detector_arch",)


def shared_dict(cfg: GridVisionConfig) -> dict:
    """dataclasses.asdict(cfg) without the port's own keys where they hold
    their defaults: a configuration the JAX package can run, as its
    GridVisionConfig takes it (a recording's header)."""
    out = dataclasses.asdict(cfg)
    for f in dataclasses.fields(GridVisionConfig):
        if f.name in PORT_ONLY and out[f.name] == f.default:
            del out[f.name]
    return out


def load_config(path: str, **overrides) -> GridVisionConfig:
    """Load a GridVisionConfig from a ROS-2 parameter YAML (the
    ``/**: ros__parameters:`` nesting or a flat mapping). Unknown keys
    raise, as ROS 2 rejects undeclared parameters."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if len(raw) == 1:
        inner = next(iter(raw.values()))
        if isinstance(inner, dict) and "ros__parameters" in inner:
            raw = inner["ros__parameters"]
    raw = dict(raw)
    raw.update(overrides)
    unknown = set(raw) - _YAML_KEYS
    if unknown:
        raise KeyError(f"unknown config keys: {sorted(unknown)}")
    return GridVisionConfig(**raw).validate()
