"""Detector-head decode: anchors -> thresholded, NMS'd, pixel-space Boxes
(counterpart of grid_vision_tpu/ops/decode.py; reference
object_detection.cpp:94-146, 226-239).

Per anchor the argmax class and max confidence; ``max_conf >= threshold``;
the survivors compacted to max_candidates by confidence (a stable sort
stands in for lax.top_k: equal values keep the lower index first); greedy
NMS, class-agnostic unless cfg.class_aware_nms; denormalized to pixels with
int truncation (quirk Q5).
"""

from __future__ import annotations

import torch

from ..config import GridVisionConfig
from ..types import Boxes
from .nms import greedy_nms_keep


def top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: the k largest, ties by lower index."""
    s = torch.sort(x, dim=-1, descending=True, stable=True)
    return s.values[..., :k], s.indices[..., :k]


def denormalize_boxes(xyxy: torch.Tensor, orig_w: int, orig_h: int,
                      resize: int) -> torch.Tensor:
    """x *= resize * (orig_w / resize), then truncate toward zero."""
    sx = float(resize) * (float(orig_w) / float(resize))
    sy = float(resize) * (float(orig_h) / float(resize))
    scale = torch.tensor([sx, sy, sx, sy], dtype=xyxy.dtype,
                         device=xyxy.device)
    return torch.trunc(xyxy * scale)


def extract_boxes(boxes_norm: torch.Tensor, confs: torch.Tensor,
                  cfg: GridVisionConfig, with_overflow: bool = False):
    """boxes_norm (..., A, 4) normalized xyxy, confs (..., A, C) -> Boxes of
    capacity max_detections in confidence-descending order, pixel
    coordinates; leading axes are rigs, each decoded on its own. With
    with_overflow also the int32 count of above-threshold anchors dropped by
    the max_candidates compaction."""
    dev = boxes_norm.device
    num_anchors = boxes_norm.shape[-2]
    max_conf = confs.max(dim=-1).values
    # torch.max's index on ties is unspecified; argmax takes the first
    best_class = torch.argmax(
        (confs == max_conf[..., None]).to(torch.uint8),
        dim=-1).to(torch.int32)
    passed = max_conf >= cfg.confidence_threshold

    k = min(cfg.max_candidates, num_anchors)
    neg_inf = torch.full((), float("-inf"), device=dev)
    cand_conf, cand_idx = top_k(torch.where(passed, max_conf, neg_inf), k)
    cand_valid = cand_conf > float("-inf")
    cand_xyxy = torch.take_along_dim(boxes_norm, cand_idx[..., None], dim=-2)
    cand_label = torch.take_along_dim(best_class, cand_idx, dim=-1)

    order, keep = greedy_nms_keep(
        cand_xyxy, cand_conf, cand_valid, cfg.iou_threshold,
        labels=cand_label if cfg.class_aware_nms else None)
    # kept rows first, confidence order intact (stable sort of ~keep)
    compact = torch.sort((~keep).to(torch.uint8), dim=-1,
                         stable=True).indices
    take = compact[..., :cfg.max_detections]
    sel = torch.take_along_dim(order, take, dim=-1)
    out_valid = torch.take_along_dim(keep, take, dim=-1)

    xyxy = denormalize_boxes(
        torch.take_along_dim(cand_xyxy, sel[..., None], dim=-2),
        cfg.camera_image_width, cfg.camera_image_height, cfg.resize)
    zero = torch.zeros((), device=dev)
    out = Boxes(
        xyxy=torch.where(out_valid[..., None], xyxy, zero),
        confidence=torch.where(
            out_valid, torch.take_along_dim(cand_conf, sel, dim=-1), zero),
        label=torch.where(out_valid,
                          torch.take_along_dim(cand_label, sel, dim=-1),
                          torch.full((), 10, dtype=torch.int32, device=dev)),
        valid=out_valid,
    )
    if with_overflow:
        n_passed = passed.sum(dim=-1).to(torch.int32)
        overflow = torch.clamp(n_passed - k, min=0)
        return out, overflow
    return out
