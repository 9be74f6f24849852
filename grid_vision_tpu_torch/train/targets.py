"""Detection target assignment: ground-truth boxes -> dense anchor-space
targets for the YOLO loss (counterpart of grid_vision_tpu/train/targets.py,
NumPy on the host).

Each ground-truth box goes to the best-IoU anchor prior (among the priors
some head owns) at the grid cell holding its center, on the head whose mask
owns that anchor; the rows follow the decode layout of
models/yolov4_tiny.decode (13-grid head first, anchor-major).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..models.yolov4_tiny import ANCHORS, HEAD_MASKS, YoloConfig


def _wh_iou(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """IoU of a (2,) box size against (A, 2) anchor sizes, centered."""
    inter = np.minimum(wh[0], anchors[:, 0]) * np.minimum(wh[1],
                                                          anchors[:, 1])
    union = wh[0] * wh[1] + anchors[:, 0] * anchors[:, 1] - inter
    return inter / np.maximum(union, 1e-9)


# Anchors no head owns can never be trained: the 2-head tiny masks leave
# anchor 0 ([10,14]) orphaned, and a small box assigned to it would drop
# out of the loss.
_USED_ANCHORS = sorted({i for mask in HEAD_MASKS for i in mask})
_ANCHOR_USABLE = np.array([i in _USED_ANCHORS
                           for i in range(len(ANCHORS))])


def head_offsets(cfg: YoloConfig) -> List[int]:
    """Row offset of each head in the concatenated anchor dimension."""
    offs, acc = [], 0
    for mask in HEAD_MASKS:
        offs.append(acc)
        s = cfg.input_size // (32 if mask == HEAD_MASKS[0] else 16)
        acc += len(mask) * s * s
    return offs


def assign_targets(gt_boxes: Sequence[Dict], cfg: YoloConfig):
    """gt_boxes: dicts with normalized x_min/y_min/x_max/y_max in [0, 1] and
    an integer `label`. Returns (tgt_boxes (N, 4) f32, tgt_class (N,) i32,
    tgt_pos (N,) f32) in decode row order. A box on the anchor both masks
    share (index 3) trains both heads (darknet's semantics)."""
    n = cfg.num_anchors_total
    tgt_boxes = np.zeros((n, 4), np.float32)
    tgt_class = np.zeros((n,), np.int32)
    tgt_pos = np.zeros((n,), np.float32)
    strides = (32, 16)
    offsets = head_offsets(cfg)

    for gt in gt_boxes:
        x0, y0 = gt["x_min"], gt["y_min"]
        x1, y1 = gt["x_max"], gt["y_max"]
        cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        w, h = x1 - x0, y1 - y0
        if w <= 0 or h <= 0 or not (0 <= cx < 1 and 0 <= cy < 1):
            continue
        wh_px = np.array([w, h]) * cfg.input_size
        iou = np.where(_ANCHOR_USABLE, _wh_iou(wh_px, ANCHORS), -1.0)
        best = int(np.argmax(iou))
        for head, mask in enumerate(HEAD_MASKS):
            if best not in mask:
                continue
            a = mask.index(best)
            s = cfg.input_size // strides[head]
            gx = min(int(cx * s), s - 1)
            gy = min(int(cy * s), s - 1)
            row = offsets[head] + a * s * s + gy * s + gx
            tgt_boxes[row] = [x0, y0, x1, y1]
            tgt_class[row] = int(gt["label"])
            tgt_pos[row] = 1.0
    return tgt_boxes, tgt_class, tgt_pos
