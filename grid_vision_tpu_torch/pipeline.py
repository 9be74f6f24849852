"""The fused perception tick on torch tensors (counterpart of
grid_vision_tpu/pipeline.py; reference GridVision::timerCallback,
grid_vision_node.cpp:108-244).

step(params, state, obs, extrinsics, cfg) -> (state', StepOutput):
  1. detector front end + YOLOv4-tiny, decode + greedy NMS;
  2. cloud to the camera frame, projection;
  3. kNN median depth of the static boxes -> base-frame points;
  4. crop / standardize the dynamic boxes, orientation net, MultiBin;
  5. camera -> base frame;
  6. grid update (decay, footprint hits, clamp, sigmoid), int8 export.

Backends keep the JAX package's switch values: ``"pallas"`` runs this
package's CUDA kernel (ops/cuda_stem.py, cuda_grid.py, cuda_knn.py),
``"xla"`` the plain-torch port of the JAX package's XLA function.

This slice ports the vision-orientation path in f32 (the shipped default
config plus the three kernel backends). Options it does not port yet raise
NotImplementedError rather than run something else. Divergence: the vision
path does not advance GridState.rng (the JAX package splits it every tick;
only the PCA branch draws from it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .config import GridVisionConfig
from .geometry import (intrinsic_inverse, intrinsic_matrix, pixel_to_3d,
                       transform_points, transform_pose)
from .models import orientation_net, weights, yolov4_tiny
from .ops import (association, cuda_grid, cuda_knn, cuda_stem, multibin,
                  preprocess, rasterize)
from .ops.decode import extract_boxes, top_k
from .taxonomy import is_dynamic
from .types import (Boxes, Extrinsics, GridState, LShapePoses, Obs,
                    PointCloud, SaturationStats, StepOutput)


def check_slice(cfg: GridVisionConfig) -> None:
    """Raise NotImplementedError for options this port does not run yet."""
    unported = {
        "compute_dtype": cfg.compute_dtype != "float32",
        "orientation_compute": cfg.orientation_compute == "bfloat16",
        "detector_precision": cfg.detector_precision != "float",
        "detector_s2d_stem": cfg.detector_s2d_stem,
        "detector_stem_backend": cfg.detector_stem_backend not in (
            "xla", "pallas"),
        "knn_backend": cfg.knn_backend not in ("xla", "pallas"),
        "use_vision_orientation": not cfg.use_vision_orientation,
        "raycast_free_space": cfg.raycast_free_space,
        "yaw_aware_rasterization": cfg.yaw_aware_rasterization,
        "vision_depth_refine": cfg.vision_depth_refine,
        "class_aware_nms": cfg.class_aware_nms,
        "orientation_arch": cfg.orientation_arch != "s2d",
        "orientation_s2d_fold": not cfg.orientation_s2d_fold,
        "orientation_stem_backend": cfg.orientation_stem_backend != "xla",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"not in the torch port yet: {', '.join(bad)} = "
            + ", ".join(repr(getattr(cfg, k)) for k in bad))


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; asking for CUDA without a card
    raises (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


def _detector_input(params, images: torch.Tensor, cfg: GridVisionConfig):
    """(B, H, W, 3) [0, 255] frames -> (net input, stem_external)."""
    if cfg.detector_stem_backend == "pallas":
        consts = params.get("detector_stem")
        if consts is None:
            consts = cuda_stem.prepare_stem_constants(params["detector"])
        return cuda_stem.detector_stem_cuda(images, consts, cfg.resize), True
    net_in = torch.stack([preprocess.preprocess_detector_image(im, cfg.resize)
                          for im in images])
    return net_in, False


def detect(params: Dict[str, Any], image: torch.Tensor,
           cfg: GridVisionConfig) -> Boxes:
    """Image (H, W, 3) [0, 255] -> padded pixel-space Boxes (conf desc)."""
    return detect_with_stats(params, image, cfg)[0]


def detect_with_stats(params: Dict[str, Any], image: torch.Tensor,
                      cfg: GridVisionConfig):
    """detect + the pre-NMS overflow counter."""
    net_in, external = _detector_input(params, image[None], cfg)
    boxes_norm, confs = yolov4_tiny.forward(params["detector"], net_in,
                                            external)
    return extract_boxes(boxes_norm[0], confs[0], cfg, with_overflow=True)


def _compact_dynamic(boxes: Boxes, capacity: int):
    """First `capacity` dynamic boxes in confidence order (quirk Q7 clamp).
    Returns (Boxes, take_idx)."""
    dyn = boxes.valid & is_dynamic(boxes.label)
    order = torch.sort((~dyn).to(torch.uint8), stable=True).indices
    order = order[:capacity]
    return boxes.take(order, valid=dyn[order]), order


def _vision_orientation_poses(params, image: torch.Tensor, boxes: Boxes,
                              K: torch.Tensor, cfg: GridVisionConfig):
    """The use_vision_orientation branch (:190-209), camera frame."""
    dyn_boxes, _ = _compact_dynamic(boxes, cfg.max_orientation_batch)
    crops = preprocess.crop_resize_standardize(image, dyn_boxes,
                                               cfg.network_height)
    orient, conf, dims = orientation_net.forward(params["orientation"], crops)
    return multibin.multibin_poses(orient, conf, dims, dyn_boxes, K, cfg)


@torch.no_grad()
def step(params: Dict[str, Any], state: GridState, obs: Obs,
         extrinsics: Extrinsics, cfg: GridVisionConfig):
    """One fused tick. Returns (new GridState, StepOutput)."""
    check_slice(cfg)
    boxes, prenms_overflow = detect_with_stats(params, obs.image, cfg)
    return fuse(params, state, obs, boxes, extrinsics, cfg,
                prenms_overflow=prenms_overflow)


@torch.no_grad()
def fuse(params: Dict[str, Any], state: GridState, obs: Obs, boxes: Boxes,
         extrinsics: Extrinsics, cfg: GridVisionConfig,
         prenms_overflow: torch.Tensor | None = None):
    """Everything after 2D detection: association, poses, grid update,
    outputs. Split out so tests can inject known boxes."""
    check_slice(cfg)
    dev = state.log_odds.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    minus_one = torch.full((), -1.0, device=dev)

    boxes = dataclasses.replace(boxes, valid=boxes.valid & obs.has_image)
    static_mask = boxes.valid & ~is_dynamic(boxes.label)

    # cloud to the camera frame (replaces TF2)
    cloud_cam = transform_points(extrinsics.lidar_to_camera, obs.cloud.xyz)
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    K_inv = intrinsic_inverse(K)

    # static branch: kNN median depth -> 3D -> base frame
    uvd, uvd_valid = association.project_cloud_to_image(
        PointCloud(xyz=cloud_cam, intensity=obs.cloud.intensity,
                   count=obs.cloud.count), K)
    uvd_valid = uvd_valid & obs.has_cloud
    if cfg.max_static_depth < boxes.capacity:
        # compact the static split to max_static_depth query slots
        # (highest confidence first); clamped boxes keep depth -1
        score = torch.where(static_mask, boxes.confidence, minus_one)
        _, knn_take = top_k(score, cfg.max_static_depth)
        q_boxes = boxes.take(knn_take, valid=static_mask[knn_take])
        n_static = static_mask.sum().to(torch.int32)
        static_depth_clamped = torch.clamp(n_static - cfg.max_static_depth,
                                           min=0)
    else:
        q_boxes, knn_take = boxes, None
        static_depth_clamped = zero
    if cfg.knn_backend == "pallas":
        q_depths = cuda_knn.knn_median_depth_cuda(uvd, uvd_valid, q_boxes,
                                                  cfg.k_near)
    else:
        q_depths = association.knn_median_depth(uvd, uvd_valid, q_boxes,
                                                cfg.k_near)
    if knn_take is None:
        depths = q_depths
    else:
        depths = torch.full((boxes.capacity,), -1.0, device=dev)
        depths[knn_take] = torch.where(q_boxes.valid, q_depths, minus_one)
    cam_points = pixel_to_3d(boxes.centers(), depths, K_inv)
    base_points = transform_points(extrinsics.camera_to_base, cam_points)
    static_points = torch.where(static_mask[:, None], base_points,
                                torch.zeros((), device=dev))

    # dynamic branch: vision-orientation poses (camera frame)
    poses_cam = _vision_orientation_poses(params, obs.image, boxes, K, cfg)
    n_dyn = (boxes.valid & is_dynamic(boxes.label)).sum().to(torch.int32)
    saturation = SaturationStats(
        prenms_overflow=(zero if prenms_overflow is None
                         else prenms_overflow.to(torch.int32)),
        orientation_clamped=torch.clamp(n_dyn - cfg.max_orientation_batch,
                                        min=0),
        box_cloud_truncated=zero,
        orientation_dropped=zero,
        static_depth_clamped=static_depth_clamped,
    )

    # camera -> base (transformLShapeObjects, :525-531)
    base_pos, base_quat = transform_pose(
        extrinsics.camera_to_base, poses_cam.position, poses_cam.quat)
    poses = dataclasses.replace(poses_cam, position=base_pos, quat=base_quat)

    # grid update: zero valid poses == the decay-only overload
    if cfg.grid_backend == "pallas":
        new_lo, new_occ = cuda_grid.lshape_update_cuda(state.log_odds, poses,
                                                       cfg)
    else:
        new_lo, new_occ = rasterize.lshape_update(state.log_odds, poses, cfg)

    # Q1 gate: both inputs missing -> no update at all (not even decay)
    run_gate = obs.has_image | obs.has_cloud
    new_lo = torch.where(run_gate, new_lo, state.log_odds)
    new_occ = torch.where(run_gate, new_occ, state.occupancy)

    new_state = GridState(log_odds=new_lo, occupancy=new_occ, rng=state.rng,
                          step=state.step + 1)
    out = StepOutput(
        boxes=boxes,
        poses=poses,
        static_points=static_points,
        static_depths=depths,
        static_boxes=dataclasses.replace(boxes, valid=static_mask),
        occupancy_i8=rasterize.export_occupancy_i8(new_occ),
        saturation=saturation,
    )
    return new_state, out


class Engine:
    """Stateful wrapper: owns the nets, the folded stem constants and the
    extrinsics on one device (the GridVision ctor, grid_vision_node.cpp:
    5-77). Runs on CUDA unless device="cpu" is asked for; asking for CUDA
    without a card raises.

    Each call returns a NEW GridState; the state passed in is not modified
    (no buffer is updated in place).
    """

    def __init__(self, cfg: GridVisionConfig,
                 extrinsics: Extrinsics | None = None,
                 params: Dict[str, Any] | None = None, seed: int = 0,
                 device="cuda", base_dir: str = "."):
        cfg.validate()
        check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.extrinsics = (extrinsics or Extrinsics.identity()).to(
            self.device)
        if params is None:
            params = weights.load_all(cfg, base_dir=base_dir, seed=seed,
                                      device=self.device)
        params = dict(params)
        if (cfg.detector_stem_backend == "pallas"
                and "detector_stem" not in params):
            # fold the stem weights once, not per tick
            params["detector_stem"] = cuda_stem.prepare_stem_constants(
                params["detector"])
        self.params = params

    def init_state(self, seed: int = 0) -> GridState:
        return GridState.create(self.cfg, seed, device=self.device)

    def __call__(self, state: GridState, obs: Obs):
        return step(self.params, state, obs, self.extrinsics, self.cfg)
