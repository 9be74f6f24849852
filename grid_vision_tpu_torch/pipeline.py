"""The fused perception tick on torch tensors (counterpart of
grid_vision_tpu/pipeline.py; reference GridVision::timerCallback,
grid_vision_node.cpp:108-244).

step(params, state, obs, extrinsics, cfg) -> (state', StepOutput):
  1. detector front end + YOLOv4-tiny, decode + greedy NMS;
  2. cloud to the camera frame, projection;
  3. kNN median depth of the static boxes -> base-frame points;
  4. the dynamic poses: with use_vision_orientation, crop / standardize
     the dynamic boxes, orientation net, MultiBin; without it (the PCA
     branch, reference :210-231), RANSAC ground plane, frustum
     association of the non-ground points to ALL boxes, radius outlier
     removal and a PCA L-shape per box;
  5. camera -> base frame;
  6. grid update (decay, footprint hits, clamp, sigmoid), int8 export; in
     extension mode (compat=False) the raycast free-space carve goes in
     front of it, or the footprints follow the estimated yaw;
  7. the rng split (the JAX package's per-tick jax.random.split).

step_tracked(params, state, tracks, obs, extrinsics, dt, cfg, tcfg) is step
followed by the multi-object tracker (ops/tracking.update_tracks; the
Engine's init_tracks / call_tracked).

step_packed(params, state, packed, extrinsics, cfg) is step on the packed
wire (types.Obs.unpack); the Engine's call_packed / call_packed_delta /
call_packed_chunk take host buffers (runtime/stream.py, runtime/record.py).

fleet_step(params, states, obs_b, extrinsics, cfg, orientation_budget)
runs the same tick over a leading rig axis: one batch-R detector call, the
orientation crops of all rigs compacted fleet-wide to the top `budget` by
confidence (the PCA branch has no budget: every rig's poses, as the JAX
package's vmap of step), and the rest of the tick (the JAX package's vmap
of fuse) written out with the rig axis, so each kernel launches once per
fleet tick with the rig batch as its launch grid. The single-rig step is
that batched tick at R = 1.

Backends keep the JAX package's switch values: ``"pallas"`` (and for the
detector ``"pallas2"`` / ``"pallas3"``, which add the CSP-stage kernel)
runs this package's CUDA kernels (ops/cuda_*.py), ``"xla"`` the
plain-torch port of the JAX package's XLA function.

This port covers every configuration the JAX package's validate() accepts:
both pose branches (use_vision_orientation true and false) in f32 and in
bf16 (compute_dtype="bfloat16", with every orientation_compute), the
shipped default config, the fleet configuration of bench.py, the extension
flags (raycast_free_space, yaw_aware_rasterization, vision_depth_refine,
class_aware_nms), every kernel backend, the int8 detector
(detector_precision="int8": models/yolov4_int8.py, on the plain resize
path), the s2d and im2col detector stems, knn_backend="approx", both
orientation archs and both forms of the s2d orientation stem. In bf16 the
detector and the orientation branch (crops, net) compute in bf16 as the JAX
package does; MultiBin, decode, NMS, the kNN, the PCA branch (from the f32
cloud), the grid and the carve stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .config import GridVisionConfig
from .device import resolve_device
from .geometry import (intrinsic_inverse, intrinsic_matrix, pixel_to_3d,
                       transform_points, transform_pose)
from .models import orientation_net, weights, yolov4_int8, yolov4_tiny
from .ops import (association, cuda_csp, cuda_grid, cuda_knn, cuda_orient,
                  cuda_raycast, cuda_stem, lshape, multibin, plane,
                  preprocess, rasterize, raycast, stem_im2col, tracking)
from .ops.decode import extract_boxes, top_k
from .taxonomy import is_dynamic
from .types import (Boxes, Extrinsics, GridState, LShapePoses, Obs,
                    PointCloud, SaturationStats, StepOutput, stack,
                    unpack_delta)
from .utils import prng


def compute_dtype(cfg: GridVisionConfig) -> torch.dtype:
    """The detector's compute dtype: bf16 for "bfloat16", else f32 (as the
    JAX package reads compute_dtype)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else \
        torch.float32


def _orientation_dtype(cfg: GridVisionConfig) -> torch.dtype:
    """The orientation branch's compute dtype (crops and net):
    orientation_compute="follow" inherits compute_dtype, "float32" and
    "bfloat16" pin it (JAX pipeline._orientation_dtype)."""
    mode = cfg.orientation_compute
    if mode == "follow":
        mode = cfg.compute_dtype
    return torch.bfloat16 if mode == "bfloat16" else torch.float32


def _consts_key(name: str, dtype: torch.dtype) -> str:
    """The params key of a kernel's folded constants in one dtype."""
    return name if dtype == torch.float32 else name + "_bf16"


def _detector_forward(params, images: torch.Tensor, cfg: GridVisionConfig):
    """(B, H, W, 3) [0, 255] frames -> (boxes (B, N, 4), confs (B, N, C)).

    "xla" resizes the frames (preprocess_detector_image) and runs the whole
    net, or with detector_precision="int8" the quantized net
    (yolov4_int8.forward_int8 on params["detector_q"], which
    weights.load_all and Engine init prepare; a KeyError without it);
    detector_s2d_stem runs its ConvBN_0/1 as space-to-depth convs.
    "pallas" feeds the net the stem kernel's stage-2 activation
    (stem_external); "pallas2" and "pallas3", two TPU layouts of one CSP
    stage, both add the CSP-stage kernel (front_external); "im2col" feeds
    it the stem's matmul form (ops/stem_im2col.py). The folded constants
    ride in params when the Engine prepared them. The net computes in compute_dtype; the frames go
    to the stem kernel in it (as pallas_stem casts them)."""
    backend = cfg.detector_stem_backend
    detector = params["detector"]
    dt = compute_dtype(cfg)
    if backend == "xla":
        net_in = torch.stack([preprocess.preprocess_detector_image(
            im, cfg.resize, dt) for im in images])
        if cfg.detector_precision == "int8":
            if "detector_q" not in params:
                raise KeyError("detector_precision='int8' needs "
                               "params['detector_q'], the quantized "
                               "detector: load the params with "
                               "weights.load_all(cfg) or through Engine")
            return yolov4_int8.forward_int8(
                params["detector_q"], net_in,
                yolov4_tiny.YoloConfig(input_size=cfg.resize))
        return yolov4_tiny.forward(detector, net_in, dtype=dt,
                                   s2d_stem=cfg.detector_s2d_stem)
    if backend == "im2col":
        consts = params.get("detector_im2col")
        if consts is None:
            consts = stem_im2col.prepare_im2col_constants(detector)
        x = stem_im2col.detector_stem_im2col(images, consts, cfg.resize, dt)
        return yolov4_tiny.forward(detector, x, stem_external=True, dtype=dt)
    consts = params.get(_consts_key("detector_stem", dt))
    if consts is None:
        consts = cuda_stem.prepare_stem_constants(detector, dt)
    x = cuda_stem.detector_stem_cuda(images.to(dt), consts, cfg.resize)
    if backend == "pallas":
        return yolov4_tiny.forward(detector, x, stem_external=True, dtype=dt)
    csp = params.get(_consts_key("detector_csp", dt))
    if csp is None:
        csp = cuda_csp.prepare_csp_constants(detector, dt)
    x = cuda_csp.detector_csp_cuda(x, detector, csp)
    return yolov4_tiny.forward(detector, x, front_external=True, dtype=dt)


def detect(params: Dict[str, Any], image: torch.Tensor,
           cfg: GridVisionConfig) -> Boxes:
    """Image (H, W, 3) [0, 255] -> padded pixel-space Boxes (conf desc)."""
    return detect_with_stats(params, image, cfg)[0]


def detect_with_stats(params: Dict[str, Any], image: torch.Tensor,
                      cfg: GridVisionConfig):
    """detect + the pre-NMS overflow counter."""
    boxes_norm, confs = _detector_forward(params, image[None], cfg)
    return extract_boxes(boxes_norm[0], confs[0], cfg, with_overflow=True)


def detect_batch(params: Dict[str, Any], images: torch.Tensor,
                 cfg: GridVisionConfig):
    """detect over a rig batch (R, H, W, 3) -> (Boxes, overflow) with a
    leading rig axis: one batch-R detector call, then each rig's decode and
    NMS (batched over the rig axis)."""
    boxes_norm, confs = _detector_forward(params, images, cfg)
    return extract_boxes(boxes_norm, confs, cfg, with_overflow=True)


def _compact_dynamic(boxes: Boxes, capacity: int):
    """First `capacity` dynamic boxes in confidence order (quirk Q7 clamp),
    per rig when boxes carry a rig axis. Returns (Boxes, take_idx)."""
    dyn = boxes.valid & is_dynamic(boxes.label)
    order = torch.sort((~dyn).to(torch.uint8), dim=-1, stable=True).indices
    order = order[..., :capacity]
    return boxes.take(order, valid=torch.take_along_dim(dyn, order, -1)), \
        order


def _vision_orientation_poses(params, image: torch.Tensor, boxes: Boxes,
                              K: torch.Tensor, cfg: GridVisionConfig):
    """The use_vision_orientation branch (:190-209) of one rig, camera
    frame: its first max_orientation_batch dynamic boxes through the crop
    chain and the full net, in the orientation dtype."""
    dyn_boxes, _ = _compact_dynamic(boxes, cfg.max_orientation_batch)
    gdtype = _orientation_dtype(cfg)
    crops = preprocess.crop_resize_standardize(
        image, dyn_boxes, cfg.network_height, compute_dtype=gdtype)
    orient, conf, dims = orientation_net.forward(
        params["orientation"], crops, dtype=gdtype,
        s2d_fold=cfg.orientation_s2d_fold)
    return multibin.multibin_poses(orient, conf, dims, dyn_boxes, K, cfg)


def _fleet_vision_poses(params, images: torch.Tensor, boxes_b: Boxes,
                        K: torch.Tensor, cfg: GridVisionConfig, budget: int):
    """Fleet-compacted vision orientation: each rig clamps to
    max_orientation_batch dynamic boxes (Q7), then the `budget`
    highest-confidence candidates fleet-wide (ties to the lower slot) go
    through the orientation net in one batch, and their camera-frame poses
    scatter back to (R, cap) slots.

    orientation_stem_backend="pallas": the orientation-front kernel crops,
    standardizes and runs ConvBN_0 for the kept crops only (sorted, so each
    rig's crops are adjacent), then the net with stem_external; "xla": each
    rig's slots are cropped against its own frame, the kept crops
    standardized after compaction, then the full net. Crops and net run in
    the orientation dtype.

    Returns (poses_b (R, cap) LShapePoses, dropped_b (R,) int32 valid
    candidates lost to the budget)."""
    n_rigs = images.shape[0]
    cap = cfg.max_orientation_batch
    budget = min(budget, n_rigs * cap)
    size = cfg.network_height

    dyn_b, _ = _compact_dynamic(boxes_b, cap)                 # (R, cap)
    flat = Boxes(xyxy=dyn_b.xyxy.reshape(-1, 4),
                 confidence=dyn_b.confidence.reshape(-1),
                 label=dyn_b.label.reshape(-1),
                 valid=dyn_b.valid.reshape(-1))
    score = torch.where(flat.valid, flat.confidence,
                        torch.full((), -1.0, device=images.device))
    _, top_idx = top_k(score, budget)
    model = params["orientation"]
    gdtype = _orientation_dtype(cfg)
    if cfg.orientation_stem_backend == "pallas":
        top_idx = torch.sort(top_idx).values
        g_boxes = flat.take(top_idx)
        consts = params.get(_consts_key("orientation_stem", gdtype))
        if consts is None:
            consts = cuda_orient.prepare_orient_constants(model, gdtype)
        acts = cuda_orient.orient_front_cuda(
            images.to(gdtype), g_boxes.xyxy, g_boxes.valid, top_idx // cap,
            model, consts, size)
        orient, conf, dims = orientation_net.forward(
            model, acts, stem_external=True, dtype=gdtype)
    else:
        g_boxes = flat.take(top_idx)
        crops_raw = torch.cat([preprocess.crop_resize(
            images[r], dyn_b.select(r), size, gdtype, out_dtype=gdtype)
            for r in range(n_rigs)])
        crops = preprocess._standardize(crops_raw[top_idx], g_boxes.valid,
                                        out_dtype=gdtype)
        orient, conf, dims = orientation_net.forward(
            model, crops, dtype=gdtype, s2d_fold=cfg.orientation_s2d_fold)
    poses_g = multibin.multibin_poses(orient, conf, dims, g_boxes, K, cfg)

    def scatter(x, fill):
        out = torch.full((n_rigs * cap,) + x.shape[1:], fill, dtype=x.dtype,
                         device=x.device)
        out[top_idx] = x
        return out.reshape((n_rigs, cap) + x.shape[1:])

    poses_b = LShapePoses(
        position=scatter(poses_g.position, 0.0),
        quat=scatter(poses_g.quat, 0.0),
        length=scatter(poses_g.length, 0.0),
        width=scatter(poses_g.width, 0.0),
        height=scatter(poses_g.height, 0.0),
        label=scatter(poses_g.label, 0),
        valid=scatter(poses_g.valid, False))
    n_valid = flat.valid.reshape(n_rigs, cap).sum(dim=-1)
    n_kept = scatter(g_boxes.valid, False).sum(dim=-1)
    return poses_b, (n_valid - n_kept).to(torch.int32)


def _pca_poses(cloud_cam: torch.Tensor, cloud_valid: torch.Tensor,
               boxes: Boxes, K: torch.Tensor, rng: torch.Tensor,
               cfg: GridVisionConfig):
    """The use_vision_orientation=false branch (:210-231) for R rigs,
    camera frame: RANSAC ground plane, the non-ground points assigned to
    ALL boxes (the reference passes `bboxes`, not the dynamic ones,
    :215-216), a capped sub-cloud per box, radius outlier removal and a
    PCA L-shape; no pose unless the rig has a dynamic box (:188). Computed
    in f32 from the f32 cloud whatever compute_dtype is. cloud_cam (R, P,
    3), cloud_valid (R, P), boxes (R, D) gated by has_image, rng (R, 2).
    Returns (poses (R, D), box_cloud_truncated (R,) int32: valid boxes
    whose sub-cloud hit max_points_per_box)."""
    non_ground, _plane, ok = plane.segment_ground_plane(
        cloud_cam, cloud_valid, rng, cfg.ransac_iters,
        cfg.ransac_distance_threshold)
    assignment, _, _ = association.assign_points_to_boxes(
        cloud_cam, non_ground, K, boxes, cfg.camera_image_width,
        cfg.camera_image_height)
    pts, pvalid, truncated = association.gather_box_clouds(
        cloud_cam, assignment, boxes.capacity, cfg.max_points_per_box)
    poses = lshape.pca_lshape_poses(pts, pvalid, boxes.label,
                                    cfg.outlier_radius,
                                    cfg.outlier_min_neighbors,
                                    max_valid=cloud_cam.shape[-2])
    any_dynamic = (boxes.valid & is_dynamic(boxes.label)).any(dim=-1)
    n_truncated = (truncated & boxes.valid).sum(dim=-1).to(torch.int32)
    valid = poses.valid & (ok & any_dynamic)[:, None]
    return dataclasses.replace(poses, valid=valid), n_truncated


def pose_branch(params, obs: Obs, boxes: Boxes, K: torch.Tensor,
                rng: torch.Tensor, extrinsics: Extrinsics,
                cfg: GridVisionConfig):
    """The dynamic-pose section of the tick for R rigs (the JAX package's
    pose_branch, rigs on the leading axis): boxes (R, D) must carry the
    has_image gate, rng (R, 2) is index 0 of each rig's tick split.
    Vision: each rig's first max_orientation_batch dynamic boxes through
    the crop chain and the net (no fleet budget); PCA: _pca_poses. Returns
    (camera-frame LShapePoses (R, cap), box_cloud_truncated (R,))."""
    n_rigs = boxes.valid.shape[0]
    if cfg.use_vision_orientation:
        poses = stack([_vision_orientation_poses(
            params, obs.image[r], boxes.select(r), K, cfg)
            for r in range(n_rigs)])
        return poses, torch.zeros((n_rigs,), dtype=torch.int32,
                                  device=boxes.valid.device)
    cloud_cam = transform_points(extrinsics.lidar_to_camera, obs.cloud.xyz)
    cloud_valid = obs.cloud.mask() & obs.has_cloud[:, None]
    return _pca_poses(cloud_cam, cloud_valid, boxes, K, rng, cfg)


def _fuse_rigs(state: GridState, obs: Obs, boxes: Boxes,
               extrinsics: Extrinsics, cfg: GridVisionConfig,
               poses_cam: LShapePoses, prenms_overflow: torch.Tensor,
               orientation_dropped: torch.Tensor, carve_maps=None,
               box_cloud_truncated: torch.Tensor | None = None,
               rng_next: torch.Tensor | None = None):
    """Everything after 2D detection for R rigs at once (the JAX package's
    vmap of fuse with injected camera-frame poses): every tensor carries a
    leading rig axis; boxes (R, D), poses_cam (R, cap: max_orientation_batch
    with vision orientation, D for the PCA branch), counters (R,;
    box_cloud_truncated None: 0).
    carve_maps: raycast.cell_polar_maps of these extrinsics when the caller
    keeps them (the Engine does), else computed here. rng_next: index 1 of
    the tick's rng split when the caller made it (the PCA branch draws from
    index 0), else split here."""
    dev = state.log_odds.device
    n_rigs = state.log_odds.shape[0]
    zero = torch.zeros((n_rigs,), dtype=torch.int32, device=dev)
    minus_one = torch.full((), -1.0, device=dev)
    if rng_next is None:
        rng_next = prng.split(state.rng)[..., 1, :]

    boxes = dataclasses.replace(boxes,
                                valid=boxes.valid & obs.has_image[:, None])
    static_mask = boxes.valid & ~is_dynamic(boxes.label)

    # cloud to the camera frame (replaces TF2)
    cloud_cam = transform_points(extrinsics.lidar_to_camera, obs.cloud.xyz)
    cloud_valid = obs.cloud.mask() & obs.has_cloud[:, None]
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    K_inv = intrinsic_inverse(K)

    # static branch: kNN median depth -> 3D -> base frame
    uvd, uvd_valid = association.project_cloud_to_image(
        PointCloud(xyz=cloud_cam, intensity=obs.cloud.intensity,
                   count=obs.cloud.count), K)
    uvd_valid = uvd_valid & obs.has_cloud[:, None]
    refine = cfg.vision_depth_refine and cfg.use_vision_orientation
    if cfg.max_static_depth < boxes.capacity and not refine:
        # compact the static split to max_static_depth query slots
        # (highest confidence first); clamped boxes keep depth -1. The
        # depth refine (vision poses only) reads the dynamic slots' depths
        # too and keeps the full-capacity query.
        score = torch.where(static_mask, boxes.confidence, minus_one)
        _, knn_take = top_k(score, cfg.max_static_depth)
        q_boxes = boxes.take(knn_take, valid=torch.take_along_dim(
            static_mask, knn_take, -1))
        n_static = static_mask.sum(dim=-1).to(torch.int32)
        static_depth_clamped = torch.clamp(n_static - cfg.max_static_depth,
                                           min=0)
    else:
        q_boxes, knn_take = boxes, None
        static_depth_clamped = zero
    if cfg.knn_backend == "pallas":
        q_depths = cuda_knn.knn_median_depth_cuda(uvd, uvd_valid, q_boxes,
                                                  cfg.k_near)
    else:                               # "xla" and "approx": the same search
        q_depths = association.knn_median_depth(uvd, uvd_valid, q_boxes,
                                                cfg.k_near)
    if knn_take is None:
        depths = q_depths
    else:
        depths = torch.full(boxes.valid.shape, -1.0, device=dev).scatter(
            -1, knn_take, torch.where(q_boxes.valid, q_depths, minus_one))
    cam_points = pixel_to_3d(boxes.centers(), depths, K_inv)
    base_points = transform_points(extrinsics.camera_to_base, cam_points)
    static_points = torch.where(static_mask[..., None], base_points,
                                torch.zeros((), device=dev))

    if refine:
        poses_cam = _refine_depth(poses_cam, boxes, depths, obs.has_cloud,
                                  K)

    if cfg.use_vision_orientation:
        n_dyn = (boxes.valid & is_dynamic(boxes.label)).sum(dim=-1).to(
            torch.int32)
        orientation_clamped = torch.clamp(
            n_dyn - cfg.max_orientation_batch, min=0)
    else:
        orientation_clamped = zero
    saturation = SaturationStats(
        prenms_overflow=prenms_overflow.to(torch.int32),
        orientation_clamped=orientation_clamped,
        box_cloud_truncated=(zero if box_cloud_truncated is None
                             else box_cloud_truncated.to(torch.int32)),
        orientation_dropped=orientation_dropped.to(torch.int32),
        static_depth_clamped=static_depth_clamped,
    )

    # camera -> base (transformLShapeObjects, :525-531)
    base_pos, base_quat = transform_pose(
        extrinsics.camera_to_base, poses_cam.position, poses_cam.quat)
    poses = dataclasses.replace(poses_cam, position=base_pos, quat=base_quat)

    # grid update: zero valid poses == the decay-only overload. Extension
    # mode carves raycast free space in front of it (ops/raycast.py, with
    # the free constant the reference declares and never uses, quirk Q2),
    # or rasterizes the yaw-rotated footprints; the carve takes precedence.
    # Then the Q1 gate (both inputs missing -> no update at all, not even
    # decay) and the int8 export: the grid and carve kernels fuse both into
    # their pass, the plain paths run rasterize.gate_and_export.
    run_gate = obs.has_image | obs.has_cloud
    kernel = cfg.grid_backend == "pallas"
    if cfg.raycast_free_space:
        cloud_base = transform_points(extrinsics.camera_to_base, cloud_cam)
        carve_args = (state.log_odds, poses, extrinsics.camera_to_base[:2, 3],
                      cloud_base[..., :2], cloud_valid)
        if kernel:
            grid = cuda_raycast.lshape_update_with_carving_gated_cuda(
                *carve_args, run_gate, state.occupancy, cfg, maps=carve_maps)
        else:
            grid = raycast.lshape_update_with_carving(*carve_args, cfg,
                                                      maps=carve_maps)
    elif cfg.yaw_aware_rasterization:
        grid = rasterize.lshape_update_oriented(state.log_odds, poses, cfg)
    elif kernel:
        grid = cuda_grid.lshape_update_gated_cuda(
            state.log_odds, poses, run_gate, state.occupancy, cfg)
    else:
        grid = rasterize.lshape_update(state.log_odds, poses, cfg)
    if len(grid) == 2:
        grid = rasterize.gate_and_export(*grid, run_gate, state.log_odds,
                                         state.occupancy)
    new_lo, new_occ, occupancy_i8 = grid

    new_state = GridState(log_odds=new_lo, occupancy=new_occ, rng=rng_next,
                          step=state.step + 1)
    out = StepOutput(
        boxes=boxes,
        poses=poses,
        static_points=static_points,
        static_depths=depths,
        static_boxes=dataclasses.replace(boxes, valid=static_mask),
        occupancy_i8=occupancy_i8,
        saturation=saturation,
    )
    return new_state, out


def _refine_depth(poses_cam: LShapePoses, boxes: Boxes,
                  depths: torch.Tensor, has_cloud: torch.Tensor,
                  K: torch.Tensor) -> LShapePoses:
    """The vision_depth_refine extension, rigs on the leading axis: the
    MultiBin solver recovers range from the 2D box and the dims prior
    alone, while the kNN median cloud depth of the same box is already
    there. Rescale each camera-frame location along its ray to the measured
    depth (keeping bearing, yaw and dims), or to the monocular height cue
    fy * H / h_px where no cloud depth exists or the cloud depth is clearly
    nearer than the cue says (an occluder's). Both cues see the object's
    near surface; the centre sits half the yaw-projected footprint farther
    along the ray."""
    # pose slots are the compacted dynamic batch; realign the depths
    dyn_boxes, take_idx = _compact_dynamic(boxes, poses_cam.capacity)
    depths_c = torch.take_along_dim(depths, take_idx, -1)
    px = poses_cam.position[..., 0]
    z = poses_cam.position[..., 2]
    o = -2.0 * torch.atan2(poses_cam.quat[..., 1], poses_cam.quat[..., 3])
    r = torch.sqrt(px * px + z * z)
    ux = px / torch.clamp(r, min=0.5)
    uz = z / torch.clamp(r, min=0.5)
    along = torch.abs(ux * torch.cos(o) - uz * torch.sin(o))
    across = torch.abs(ux * torch.sin(o) + uz * torch.cos(o))
    half_ext = 0.5 * (along * poses_cam.length + across * poses_cam.width)
    ok_knn = (poses_cam.valid & (depths_c > 0.0) & (z > 0.5)
              & has_cloud[:, None])
    h_px = dyn_boxes.xyxy[..., 3] - dyn_boxes.xyxy[..., 1]
    depth_mono = K[1, 1] * poses_cam.height / torch.clamp(h_px, min=1.0)
    ok_mono = poses_cam.valid & (h_px > 4.0) & (z > 0.5)
    knn_center = depths_c + half_ext
    mono_center = depth_mono + half_ext
    # one-sided: an occluder can only pull the kNN depth nearer
    consistent = knn_center > 0.8 * mono_center
    use_knn = ok_knn & (consistent | ~ok_mono)
    safe_z = torch.clamp(z, min=0.5)
    scale = torch.where(
        use_knn, knn_center / safe_z,
        torch.where(ok_mono, mono_center / safe_z, torch.ones_like(z)))
    return dataclasses.replace(
        poses_cam, position=poses_cam.position * scale[..., None])


@torch.no_grad()
def step(params: Dict[str, Any], state: GridState, obs: Obs,
         extrinsics: Extrinsics, cfg: GridVisionConfig):
    """One fused tick. Returns (new GridState, StepOutput)."""
    boxes, prenms_overflow = detect_with_stats(params, obs.image, cfg)
    return fuse(params, state, obs, boxes, extrinsics, cfg,
                prenms_overflow=prenms_overflow)


@torch.no_grad()
def step_packed(params: Dict[str, Any], state: GridState,
                packed: torch.Tensor, extrinsics: Extrinsics,
                cfg: GridVisionConfig):
    """step() on a packed-wire observation (types.Obs.unpack of a 1-D
    uint8 tensor): the streaming ingest path, one host->device transfer a
    frame. The unpack is views and, at most, a few small copies on the
    buffer's device; with the rgb8 codec the tick takes the uint8 frame."""
    return step(params, state, Obs.unpack(packed, cfg), extrinsics, cfg)


@torch.no_grad()
def step_tracked(params: Dict[str, Any], state: GridState,
                 tracks: tracking.TrackState, obs: Obs,
                 extrinsics: Extrinsics, dt, cfg: GridVisionConfig,
                 tcfg: tracking.TrackConfig):
    """step() + the multi-object tracker (ops/tracking.py). A pure-additive
    extension: the tracker only consumes the StepOutput. dt is a Python
    float or a 0-d tensor (variable frame spacing), never read back.
    Returns (state', tracks', out, TrackStats)."""
    new_state, out = step(params, state, obs, extrinsics, cfg)
    new_tracks, tstats = tracking.update_tracks(tracks, out, dt, cfg, tcfg)
    return new_state, new_tracks, out, tstats


@torch.no_grad()
def fuse(params: Dict[str, Any], state: GridState, obs: Obs, boxes: Boxes,
         extrinsics: Extrinsics, cfg: GridVisionConfig,
         poses_cam: LShapePoses | None = None,
         prenms_overflow: torch.Tensor | None = None,
         box_cloud_truncated: torch.Tensor | None = None):
    """Everything after 2D detection for one rig: association, poses, grid
    update, outputs. Split out so tests can inject known boxes. Runs the
    rig-batched tick at R = 1. poses_cam: pre-computed camera-frame poses
    (pose_branch's, one rig, with its box_cloud_truncated) in place of the
    pose branch. params["carve_maps"], where present, must be
    raycast.cell_polar_maps of these extrinsics (the Engine's are)."""
    dev = state.log_odds.device
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    state1, obs1, boxes1 = (stack([v]) for v in (state, obs, boxes))
    keys = prng.split(state1.rng)
    if poses_cam is None:
        gated = dataclasses.replace(
            boxes1, valid=boxes1.valid & obs1.has_image[:, None])
        K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
        poses1, truncated = pose_branch(params, obs1, gated, K,
                                        keys[..., 0, :], extrinsics, cfg)
    else:
        poses1 = stack([poses_cam])
        truncated = (zero if box_cloud_truncated is None
                     else box_cloud_truncated.reshape(1))
    overflow = zero if prenms_overflow is None else prenms_overflow[None]
    new_state, out = _fuse_rigs(state1, obs1, boxes1, extrinsics, cfg,
                                poses1, overflow, zero,
                                params.get("carve_maps"), truncated,
                                keys[..., 1, :])
    return new_state.select(0), out.select(0)


@torch.no_grad()
def fleet_step(params: Dict[str, Any], states: GridState, obs_b: Obs,
               extrinsics: Extrinsics, cfg: GridVisionConfig,
               orientation_budget: int | None = None):
    """The tick over a leading rig axis: states and obs_b carry (R, ...)
    tensors (GridState.create_batch, runtime.stream.FleetPool). The
    orientation crops of all rigs are compacted fleet-wide to the top
    `orientation_budget` by confidence; None keeps every rig's
    max_orientation_batch slots, which equals per-rig step. The PCA
    branch ignores the budget (every rig's poses: per-rig step, as the JAX
    package's vmap of step). Returns (states', StepOutput with a rig
    axis)."""
    n_rigs = obs_b.image.shape[0]
    dev = obs_b.image.device
    boxes_b, overflow_b = detect_batch(params, obs_b.image, cfg)
    boxes_b = dataclasses.replace(
        boxes_b, valid=boxes_b.valid & obs_b.has_image[:, None])
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    zero = torch.zeros((n_rigs,), dtype=torch.int32, device=dev)
    keys = prng.split(states.rng)
    if cfg.use_vision_orientation:
        budget = (n_rigs * cfg.max_orientation_batch
                  if orientation_budget is None else orientation_budget)
        poses_b, dropped_b = _fleet_vision_poses(
            params, obs_b.image, boxes_b, K, cfg, budget)
        truncated_b = zero
    else:
        poses_b, truncated_b = pose_branch(params, obs_b, boxes_b, K,
                                           keys[..., 0, :], extrinsics, cfg)
        dropped_b = zero
    return _fuse_rigs(states, obs_b, boxes_b, extrinsics, cfg, poses_b,
                      overflow_b, dropped_b, params.get("carve_maps"),
                      truncated_b, keys[..., 1, :])


class Engine:
    """Stateful wrapper: owns the nets, the folded kernel constants and the
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
        self.cfg = cfg
        self.device = resolve_device(device)
        self.extrinsics = (extrinsics or Extrinsics.identity()).to(
            self.device)
        if params is None:
            params = weights.load_all(cfg, base_dir=base_dir, seed=seed,
                                      device=self.device)
        params = dict(params)
        # fold the kernels' weights once, not per tick, in the dtype each
        # kernel runs in
        dt, gdt = compute_dtype(cfg), _orientation_dtype(cfg)
        for used, key, prepare, net in (
                (cfg.detector_stem_backend in ("pallas", "pallas2",
                                               "pallas3"),
                 _consts_key("detector_stem", dt),
                 cuda_stem.prepare_stem_constants, "detector"),
                (cfg.detector_stem_backend in ("pallas2", "pallas3"),
                 _consts_key("detector_csp", dt),
                 cuda_csp.prepare_csp_constants, "detector"),
                (cfg.orientation_stem_backend == "pallas"
                 and cfg.use_vision_orientation,
                 _consts_key("orientation_stem", gdt),
                 cuda_orient.prepare_orient_constants, "orientation")):
            if used and key not in params:
                params[key] = prepare(params[net],
                                      dt if net == "detector" else gdt)
        # the im2col stem's constants (f32, cast at use) and the quantized
        # detector, folded once on the host
        if (cfg.detector_stem_backend == "im2col"
                and "detector_im2col" not in params):
            params["detector_im2col"] = stem_im2col.prepare_im2col_constants(
                params["detector"])
        if cfg.detector_precision == "int8" and "detector_q" not in params:
            params["detector_q"] = yolov4_int8.quantize_detector(
                params["detector"])
        # the carve's per-cell polar maps depend only on the extrinsics and
        # the grid geometry, which this engine fixes
        if cfg.raycast_free_space and "carve_maps" not in params:
            params["carve_maps"] = raycast.cell_polar_maps(
                self.extrinsics.camera_to_base[:2, 3], cfg)
        self.params = params

    def init_state(self, seed: int = 0) -> GridState:
        return GridState.create(self.cfg, seed, device=self.device)

    def init_states(self, n_rigs: int, seed: int = 0) -> GridState:
        """Stacked states of n_rigs rigs (rig r seeded seed + r)."""
        return GridState.create_batch(self.cfg, n_rigs, seed,
                                      device=self.device)

    def init_tracks(self, tcfg: tracking.TrackConfig | None = None
                    ) -> tracking.TrackState:
        """A fresh tracker table for call_tracked, on this engine's
        device."""
        return tracking.TrackState.create(tcfg or tracking.TrackConfig(),
                                          device=self.device)

    def __call__(self, state: GridState, obs: Obs):
        return step(self.params, state, obs, self.extrinsics, self.cfg)

    def call_tracked(self, state: GridState, tracks: tracking.TrackState,
                     obs: Obs, dt=0.05,
                     tcfg: tracking.TrackConfig | None = None):
        """step + the multi-object tracker (step_tracked). dt defaults to
        the reference's 50 ms tick; pass the real frame spacing when the
        pacing differs (a Python float or a 0-d tensor, moved to this
        engine's device, never read back). Returns (state', tracks', out,
        TrackStats)."""
        return step_tracked(self.params, state, tracks, obs,
                            self.extrinsics, dt, self.cfg,
                            tcfg or tracking.TrackConfig())

    def fleet(self, states: GridState, obs_b: Obs,
              orientation_budget: int | None = None):
        """fleet_step on this engine's nets: (states', StepOutput)."""
        return fleet_step(self.params, states, obs_b, self.extrinsics,
                          self.cfg, orientation_budget)

    def warmup(self, obs: Obs | None = None) -> None:
        """Build the kernels of this configuration and run one tick on a
        blank Obs (or `obs`), so that a frame size or option a kernel
        refuses fails here rather than at the first tick (the JAX
        package's ahead-of-time compile)."""
        if obs is None:
            obs = Obs.create(self.cfg, device=self.device)
        step(self.params, self.init_state(), obs, self.extrinsics, self.cfg)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def upload(self, packed) -> torch.Tensor:
        """A packed buffer (host np.uint8 array or tensor) as a uint8
        tensor on this engine's device. A host array is copied from
        pageable memory (copied first if read-only); the host waits for
        the copy."""
        if packed.dtype not in (torch.uint8, np.uint8):
            raise ValueError(f"packed buffer must be uint8, got "
                             f"{packed.dtype}")
        if isinstance(packed, torch.Tensor):
            return packed.to(self.device)
        host = np.ascontiguousarray(packed)
        return torch.from_numpy(host if host.flags.writeable
                                else host.copy()).to(self.device)

    def call_packed(self, state: GridState, packed):
        """step on a packed-wire observation (types.Obs.pack_bytes): a
        host np.uint8 buffer, which is copied to this engine's device, or
        a uint8 tensor already there. Returns (state', StepOutput)."""
        return step_packed(self.params, state, self.upload(packed),
                           self.extrinsics, self.cfg)

    def call_packed_delta(self, state: GridState, prev_image_u8, buf,
                          keyframe: bool):
        """ROI-delta streaming step (types.pack_delta_bytes wire).
        prev_image_u8: the (H, W, 3) uint8 previous frame on this
        engine's device (carry what this returns). keyframe=True takes a
        full Obs.pack_bytes buffer instead (the encoder's fallback when
        the change exceeds the ROI window). Returns (state', image_u8',
        out)."""
        if self.cfg.wire_image_codec != "rgb8":
            raise ValueError("the ROI-delta wire ships raw rgb8 windows;"
                             " set wire_image_codec='rgb8'")
        buf = self.upload(buf)
        obs = (Obs.unpack(buf, self.cfg) if keyframe
               else unpack_delta(buf, prev_image_u8, self.cfg))
        new_state, out = step(self.params, state, obs, self.extrinsics,
                              self.cfg)
        return new_state, obs.image, out

    def call_packed_chunk(self, state: GridState, chunk):
        """Throughput-mode ingest: a (K, nbytes) stack of packed frames
        crosses to the device as ONE transfer, then runs K sequential
        steps. Returns (state', outs): the per-step StepOutputs stacked on
        a leading K axis, every frame's outputs computed (the chunk delays
        outputs, it does not drop them). Equal to K call_packed steps."""
        bufs = self.upload(chunk)
        outs = []
        for k in range(bufs.shape[0]):
            state, out = step_packed(self.params, state, bufs[k],
                                     self.extrinsics, self.cfg)
            outs.append(out)
        return state, stack(outs)

