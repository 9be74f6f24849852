"""Detection-quality evaluation: COCO-style mAP@0.5 on held-out scenes
(counterpart of grid_vision_tpu/train/eval_map.py).

The weights are scored against ground-truth synthetic scenes the trainer
never saw, through the production decode path (pipeline.detect_batch:
preprocess or the stem / CSP kernels, the net, threshold, NMS,
denormalize) on the backends of the configuration given, so the metric
covers the whole detection stack.

Two held-out sources:
  - "synth": the rendered rectangle world (train/synth_data.render_image)
    with the evaluation-only keys PRNGKey(7_700_000 + i): the JAX package's
    frames, as the port draws the same bits;
  - "scene": the host SyntheticScene world (io/scene.py) with randomized
    traffic (seed 500 + i), ground truth from scene.bbox_at.

Matching follows the PASCAL/COCO protocol: predictions sorted by
confidence, greedy one-to-one match to same-class ground truth at IoU >=
iou_thresh, AP = area under the interpolated precision envelope
(all-point), mAP = mean over the classes present in the ground truth.

CLI: python -m grid_vision_tpu_torch eval [--source synth|scene]
     [--images N] [--conf 0.05] [--cpu] -- prints one JSON dict.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GridVisionConfig
from ..taxonomy import class_name


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> (N, M)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def match_image(pred_xyxy: np.ndarray, pred_conf: np.ndarray,
                pred_label: np.ndarray, gt_xyxy: np.ndarray,
                gt_label: np.ndarray,
                iou_thresh: float = 0.5) -> np.ndarray:
    """Greedy matching of one image's predictions; returns tp flags (bool
    per prediction). Each ground-truth box matches at most one prediction
    (highest confidence first, best IoU among unmatched same-class GT)."""
    order = np.argsort(-pred_conf, kind="stable")
    tp = np.zeros(pred_xyxy.shape[0], bool)
    if gt_xyxy.shape[0] == 0:
        return tp
    ious = iou_matrix(pred_xyxy, gt_xyxy)
    taken = np.zeros(gt_xyxy.shape[0], bool)
    for i in order:
        cand = (~taken) & (gt_label == pred_label[i]) & (
            ious[i] >= iou_thresh)
        if not cand.any():
            continue
        j = int(np.argmax(np.where(cand, ious[i], -1.0)))
        taken[j] = True
        tp[i] = True
    return tp


def average_precision(tp: np.ndarray, conf: np.ndarray,
                      n_gt: int) -> float:
    """All-point interpolated AP (COCO AP at one IoU / PASCAL VOC 2010+).

    tp/conf: flags and confidences of every prediction of one class pooled
    over the dataset; n_gt: its ground-truth boxes."""
    if n_gt == 0:
        return float("nan")
    if tp.size == 0:
        return 0.0
    order = np.argsort(-conf, kind="stable")
    tp_c = np.cumsum(tp[order].astype(np.float64))
    fp_c = np.cumsum((~tp[order]).astype(np.float64))
    recall = tp_c / n_gt
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    # precision envelope (monotone non-increasing from the right)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0] if precision.size else 0.0],
                        precision])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


@dataclasses.dataclass
class EvalResult:
    map50: float
    per_class_ap: Dict[str, float]
    n_images: int
    n_gt: int
    n_pred: int
    iou_thresh: float

    def to_dict(self) -> dict:
        return {
            "mAP@0.5": round(self.map50, 4),
            "per_class_ap": {k: round(v, 4)
                             for k, v in self.per_class_ap.items()},
            "n_images": self.n_images,
            "n_gt": self.n_gt,
            "n_pred": self.n_pred,
            "iou_thresh": self.iou_thresh,
        }


def score_detections(preds: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
                     gts: List[Tuple[np.ndarray, np.ndarray]],
                     iou_thresh: float = 0.5) -> EvalResult:
    """preds[i] = (xyxy (P, 4), conf (P,), label (P,)) of image i, valid
    rows only; gts[i] = (xyxy (G, 4), label (G,))."""
    all_tp, all_conf, all_label = [], [], []
    gt_counts: Dict[int, int] = {}
    for (pxy, pc, pl), (gxy, gl) in zip(preds, gts):
        all_tp.append(match_image(pxy, pc, pl, gxy, gl, iou_thresh))
        all_conf.append(pc)
        all_label.append(pl)
        for c in gl.tolist():
            gt_counts[int(c)] = gt_counts.get(int(c), 0) + 1
    tp = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
    conf = np.concatenate(all_conf) if all_conf else np.zeros(0)
    label = np.concatenate(all_label) if all_label else np.zeros(0, int)

    per_class = {}
    for c, n_gt in sorted(gt_counts.items()):
        sel = label == c
        per_class[class_name(c)] = average_precision(tp[sel], conf[sel],
                                                     n_gt)
    aps = [v for v in per_class.values() if not np.isnan(v)]
    return EvalResult(
        map50=float(np.mean(aps)) if aps else 0.0,
        per_class_ap=per_class,
        n_images=len(gts),
        n_gt=int(sum(gt_counts.values())),
        n_pred=int(tp.size),
        iou_thresh=iou_thresh,
    )


# ---------------------------------------------------------------------
# Held-out dataset generation + batched inference
# ---------------------------------------------------------------------

def detect_images(params, images, cfg: GridVisionConfig, batch: int = 16,
                  device="cuda"):
    """pipeline.detect_batch over a list of host images in chunks of
    `batch` (the last chunk padded by repeating its last frame), on cfg's
    backends, on `device` (the card unless the CPU is asked for). Returns
    per-image (xyxy, conf, label) numpy arrays (valid rows only)."""
    from ..device import resolve_device
    from ..pipeline import detect_batch

    device = resolve_device(device)

    out = []
    for i in range(0, len(images), batch):
        chunk = images[i:i + batch]
        pad = batch - len(chunk)
        arr = torch.as_tensor(np.stack(chunk + [chunk[-1]] * pad),
                              device=device)
        with torch.no_grad():
            boxes, _ = detect_batch(params, arr, cfg)
        xyxy, conf, label, valid = (t.cpu().numpy() for t in (
            boxes.xyxy, boxes.confidence, boxes.label, boxes.valid))
        for b in range(len(chunk)):
            m = valid[b]
            out.append((xyxy[b][m], conf[b][m], label[b][m]))
    return out


def heldout_synth(n_images: int, cfg: GridVisionConfig,
                  seed: int = 7_700_000, device="cuda", chunk: int = 16):
    """Held-out frames of the rendered world (the training distribution;
    the evaluation-only keys PRNGKey(seed + i)), rendered `chunk` at a
    time on `device` (the card unless the CPU is asked for)."""
    from ..device import resolve_device
    from ..utils import prng
    from .synth_data import render_image

    device = resolve_device(device)

    h, w = cfg.camera_image_height, cfg.camera_image_width
    scale = np.asarray([w, h, w, h], np.float32)
    images, gts = [], []
    for i in range(0, n_images, chunk):
        keys = torch.stack([prng.prng_key(seed + j) for j in
                            range(i, min(i + chunk, n_images))]).to(device)
        img, boxes, labels, valid = (t.cpu().numpy() for t in
                                     render_image(keys, h, w))
        for b in range(keys.shape[0]):
            m = valid[b]
            gts.append((boxes[b][m] * scale, labels[b][m].astype(np.int64)))
            images.append(img[b])
    return images, gts


def heldout_scene(n_images: int, cfg: GridVisionConfig, seed: int = 500):
    """Held-out frames of the host SyntheticScene world with randomized
    traffic (the engine's replay / demo distribution)."""
    from ..io.scene import SyntheticScene

    images, gts = [], []
    rng = np.random.default_rng(seed)
    w, h = cfg.camera_image_width, cfg.camera_image_height
    for i in range(n_images):
        scene = SyntheticScene(cfg, seed=seed + i)
        scene.add_default_traffic()
        # all ten classes (lights in three colors, signs in three values)
        scene.add_random_traffic(rng,
                                 n_dynamic=int(rng.integers(0, 4)),
                                 n_static=int(rng.integers(1, 4)))
        t = float(rng.uniform(0.0, 2.0))
        images.append(np.asarray(scene.image_at(t), np.float32))
        gxy, gl = [], []
        for j in range(len(scene.objects)):
            bb = scene.bbox_at(j, t)
            if bb is None:
                continue
            x0 = max(0.0, bb["x_min"])
            y0 = max(0.0, bb["y_min"])
            x1 = min(float(w), bb["x_max"])
            y1 = min(float(h), bb["y_max"])
            if x1 - x0 < 2.0 or y1 - y0 < 2.0:
                continue
            gxy.append([x0, y0, x1, y1])
            gl.append(bb["label"])
        gts.append((np.asarray(gxy, np.float32).reshape(-1, 4),
                    np.asarray(gl, np.int64)))
    return images, gts


def evaluate_detector(params, cfg: GridVisionConfig, n_images: int = 64,
                      source: str = "synth", iou_thresh: float = 0.5,
                      eval_conf: float = 0.05,
                      seed: Optional[int] = None) -> EvalResult:
    """End-to-end mAP@iou of `params` (weights.load_all's nets, on their
    device) through the production decode path on cfg's backends.

    eval_conf replaces cfg.confidence_threshold so the PR curve has support
    below the deployment threshold (the deployment threshold 0.6 is a point
    on this curve)."""
    from ..pipeline import Engine

    ecfg = dataclasses.replace(cfg, confidence_threshold=eval_conf)
    device = next(params["detector"].parameters()).device
    if source == "synth":
        images, gts = heldout_synth(
            n_images, ecfg, seed=7_700_000 if seed is None else seed,
            device=device)
    elif source == "scene":
        images, gts = heldout_scene(
            n_images, ecfg, seed=500 if seed is None else seed)
    else:
        raise ValueError(f"unknown source {source!r}")
    # the Engine folds the kernels' constants once for all chunks
    eng_params = Engine(ecfg, params=params, device=device).params
    preds = detect_images(eng_params, images, ecfg, device=device)
    return score_detections(preds, gts, iou_thresh)


def main(argv=None):
    import argparse

    from ..device import resolve_device
    from ..models import weights as weights_mod

    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch eval",
                                 description=__doc__)
    ap.add_argument("--source", choices=("synth", "scene"),
                    default="synth")
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--conf", type=float, default=0.05)
    ap.add_argument("--weights", default="weights/detector.npz")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    cfg = GridVisionConfig(detection_weights_file=args.weights)
    params = weights_mod.load_all(cfg, seed=0, device=device)
    res = evaluate_detector(params, cfg, n_images=args.images,
                            source=args.source, iou_thresh=args.iou,
                            eval_conf=args.conf)
    print(json.dumps(res.to_dict(), indent=1))
    return res


if __name__ == "__main__":
    main()
