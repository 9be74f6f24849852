"""Losses of the two nets (counterpart of grid_vision_tpu/train/losses.py).

yolo_loss: the dense anchor-space YOLOv4-tiny loss, CIoU on the positive
anchors (darknet's 2 - w*h scale) + BCE objectness (the max class
confidence, as the export folds objectness into the confidences) + BCE
class scores. multibin_loss: the Deep3DBox objective of the orientation
net, dimension L2 + bin-confidence cross entropy + negative-cosine angle
loss on the responsible bin, each head gated by a per-sample weight.

Each takes the module (its parameters and running statistics are flax's
variables) and returns (loss, (new batch statistics, aux)) as the JAX
package's do: with train=True the module runs in train mode and the new
running statistics come back as state-dict entries
(models/layers.new_batch_stats); the module's buffers are not changed.
Gradients follow JAX's: max splits its gradient evenly among tied maxima
(torch.amax), alpha of the CIoU is detached (stop_gradient).
"""

from __future__ import annotations

import math

import torch

from ..models import orientation_net, yolov4_tiny
from ..models.layers import new_batch_stats


def _ciou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Complete IoU between (..., 4) xyxy boxes."""
    px1, py1, px2, py2 = pred.unbind(-1)
    tx1, ty1, tx2, ty2 = target.unbind(-1)
    ix1 = torch.maximum(px1, tx1)
    iy1 = torch.maximum(py1, ty1)
    ix2 = torch.minimum(px2, tx2)
    iy2 = torch.minimum(py2, ty2)
    inter = (torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0))
    pa = torch.clamp(px2 - px1, min=0) * torch.clamp(py2 - py1, min=0)
    ta = torch.clamp(tx2 - tx1, min=0) * torch.clamp(ty2 - ty1, min=0)
    union = pa + ta - inter
    iou = inter / torch.clamp(union, min=1e-9)

    # enclosing box diagonal + center distance
    cx1 = torch.minimum(px1, tx1)
    cy1 = torch.minimum(py1, ty1)
    cx2 = torch.maximum(px2, tx2)
    cy2 = torch.maximum(py2, ty2)
    c2 = (cx2 - cx1) ** 2 + (cy2 - cy1) ** 2 + 1e-9
    d2 = (((px1 + px2) - (tx1 + tx2)) ** 2
          + ((py1 + py2) - (ty1 + ty2)) ** 2) / 4.0

    pw = torch.clamp(px2 - px1, min=1e-9)
    ph = torch.clamp(py2 - py1, min=1e-9)
    tw = torch.clamp(tx2 - tx1, min=1e-9)
    th = torch.clamp(ty2 - ty1, min=1e-9)
    v = (4.0 / math.pi ** 2) * (torch.atan(tw / th)
                                - torch.atan(pw / ph)) ** 2
    alpha = v / torch.clamp(1.0 - iou + v, min=1e-9)
    return iou - d2 / c2 - alpha.detach() * v


def _bce(prob: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities (the decoded confidences are sigmoided)."""
    p = torch.clamp(prob, 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def _forward(model, x: torch.Tensor, train: bool):
    """model(x) in train or eval mode, its mode restored; the new batch
    statistics of a train-mode call ({} otherwise)."""
    was = model.training
    model.train(train)
    try:
        out = model(x)
    finally:
        model.train(was)
    return out, (new_batch_stats(model) if train else {})


def yolo_loss(model: yolov4_tiny.YoloV4Tiny, images, tgt_boxes, tgt_class,
              tgt_pos, cfg: yolov4_tiny.YoloConfig, train: bool = True):
    """images (B, S, S, 3) in [0, 1]; tgt_boxes (B, N, 4) xyxy; tgt_class
    (B, N) int; tgt_pos (B, N) float {0, 1}. The net computes in
    cfg.compute_dtype. Returns (loss, (new batch stats, aux))."""
    (h1, h2), mutated = _forward(model, images.to(cfg.compute_dtype), train)
    boxes, confs = yolov4_tiny.decode(model, h1, h2)

    n_pos = torch.clamp(tgt_pos.sum(), min=1.0)
    ciou = _ciou(boxes, tgt_boxes)
    # darknet's delta scale 2 - w*h: small boxes weigh up to 2x
    box_scale = 2.0 - ((tgt_boxes[..., 2] - tgt_boxes[..., 0])
                       * (tgt_boxes[..., 3] - tgt_boxes[..., 1]))
    box_loss = torch.sum((1.0 - ciou) * box_scale * tgt_pos) / n_pos

    obj = torch.amax(confs, dim=-1)
    obj_loss = torch.mean(_bce(obj, tgt_pos))

    classes = torch.arange(cfg.num_classes, device=confs.device)
    cls_onehot = (tgt_class[..., None] == classes).float()
    cls_loss = torch.sum(_bce(confs, cls_onehot) * tgt_pos[..., None]) / n_pos

    loss = box_loss + obj_loss + cls_loss
    aux = {"box_loss": box_loss, "obj_loss": obj_loss, "cls_loss": cls_loss}
    return loss, (mutated, aux)


def multibin_loss(model: orientation_net.OrientationNetS2D, crops, tgt_dims,
                  tgt_bin, tgt_angle_offset, dim_weight=None,
                  angle_weight=None, *,
                  cfg: orientation_net.OrientationConfig,
                  train: bool = True):
    """crops (B, S, S, 3); tgt_dims (B, 3) residuals; tgt_bin (B,) int;
    tgt_angle_offset (B,) residual angle within the bin. dim_weight /
    angle_weight (B,) gate which head each sample trains (default both):
    synthetic oriented crops carry the angle, metric scene crops the dims.
    Returns (loss, (new batch stats, aux))."""
    (orient, conf, dims), mutated = _forward(
        model, crops.to(cfg.compute_dtype), train)
    dw = torch.ones_like(dims[:, 0]) if dim_weight is None else dim_weight
    aw = torch.ones_like(dims[:, 0]) if angle_weight is None else angle_weight
    dim_loss = (torch.sum(dw * torch.sum((dims - tgt_dims) ** 2, dim=-1))
                / torch.clamp(dw.sum(), min=1.0))
    idx = tgt_bin.long()[:, None]
    conf_nll = -torch.gather(torch.log_softmax(conf, dim=-1), 1, idx)[:, 0]
    conf_loss = torch.sum(aw * conf_nll) / torch.clamp(aw.sum(), min=1.0)
    sel = torch.gather(orient, 1, idx[..., None].expand(-1, 1, 2))[:, 0]
    orient_err = 1.0 - (sel[:, 0] * torch.cos(tgt_angle_offset)
                        + sel[:, 1] * torch.sin(tgt_angle_offset))
    orient_loss = torch.sum(aw * orient_err) / torch.clamp(aw.sum(), min=1.0)
    loss = 4.0 * dim_loss + conf_loss + 8.0 * orient_loss
    aux = {"dim_loss": dim_loss, "conf_loss": conf_loss,
           "orient_loss": orient_loss}
    return loss, (mutated, aux)
