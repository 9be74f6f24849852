"""Greedy NMS with the reference's semantics (counterpart of
grid_vision_tpu/ops/nms.py; reference object_detection.cpp:148-211):
candidates sorted by confidence (stable, invalid last); scanning in that
order a kept box suppresses every later box with IoU > threshold (strict);
suppressed boxes suppress nothing; the class is ignored (quirk Q3) unless
labels are given (the class_aware_nms extension).
Both functions take leading rig axes.
"""

from __future__ import annotations

import torch


def pairwise_iou(xyxy: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) xyxy -> (..., N, N) IoU with the reference's
    denominator; 0/0 of degenerate or padded boxes is guarded to 0."""
    a = xyxy[..., :, None, :]
    b = xyxy[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    area = (xyxy[..., 2] - xyxy[..., 0]) * (xyxy[..., 3] - xyxy[..., 1])
    denom = area[..., None, :] + area[..., :, None] - inter
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    return torch.where(denom > 0, inter / safe, torch.zeros_like(denom))


def greedy_nms_keep(xyxy: torch.Tensor, confidence: torch.Tensor,
                    valid: torch.Tensor, iou_threshold: float,
                    labels: torch.Tensor | None = None):
    """Returns (order (..., N) int64 stable sort by confidence descending
    with invalid last, keep (..., N) bool decisions in that order).
    labels (..., N): suppression only between boxes of the same label.

    The greedy scan is computed as the fixed point of
    keep = valid & ~any_i(keep_i & suppresses_ij) over the strictly-upper
    suppression matrix: the greedy result is its unique fixed point (entry
    j depends only on entries before it), and after t sweeps the first t
    entries are final, so the loop ends after (longest suppression chain
    + 1) sweeps instead of one step per candidate."""
    n = xyxy.shape[-2]
    key = torch.where(valid, -confidence,
                      torch.full((), float("inf"), device=xyxy.device))
    order = torch.sort(key, dim=-1, stable=True).indices
    boxes_s = torch.take_along_dim(xyxy, order[..., None], dim=-2)
    valid_s = torch.take_along_dim(valid, order, dim=-1)
    later = torch.ones((n, n), dtype=torch.bool,
                       device=xyxy.device).triu(diagonal=1)
    sup = later & (pairwise_iou(boxes_s) > iou_threshold)
    if labels is not None:
        labels_s = torch.take_along_dim(labels, order, dim=-1)
        sup = sup & (labels_s[..., :, None] == labels_s[..., None, :])
    keep = valid_s
    for _ in range(n + 1):
        new = valid_s & ~(keep[..., :, None] & sup).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return order, keep
