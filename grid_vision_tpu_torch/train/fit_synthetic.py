"""Fit YOLOv4-tiny on host-rendered scenes: ``python -m
grid_vision_tpu_torch.train.fit_synthetic [--steps N]`` (counterpart of
grid_vision_tpu/train/fit_synthetic.py).

The host-fed trainer: each batch is rendered by the scene generator
(io/scene.py, ground-truth boxes from the scene geometry), resized to the
detector's input by the detector's antialiased linear resize (the weights of
jax.image.resize(..., "linear"), ops/preprocess.preprocess_detector_image)
and uploaded. The primary trainer is train/fit_on_device.py (the batches
drawn on the card, --scene-frames mixing), which made the shipped
weights/detector.npz.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device


def make_batch(cfg, ycfg, rng: np.random.Generator, batch: int,
               device="cuda"):
    """A batch of rendered scenes with dense anchor targets on `device` (the
    card unless the CPU is asked for): (images (B, S, S, 3) in [0, 1],
    tgt_boxes, tgt_class, tgt_pos)."""
    from ..io.scene import SyntheticScene
    from ..ops.preprocess import preprocess_detector_image
    from .targets import assign_targets

    device = resolve_device(device)
    images, tb, tc, tp = [], [], [], []
    for _ in range(batch):
        scene = SyntheticScene(cfg, seed=int(rng.integers(2**31)))
        n_obj = int(rng.integers(1, 4))
        for _ in range(n_obj):
            z = rng.uniform(6, 35)
            scene.add_object(
                [rng.uniform(-4, 4), rng.uniform(0.8, 1.4), z],
                [0, 0, 0],
                (rng.uniform(0.6, 2.2), rng.uniform(0.8, 1.6),
                 rng.uniform(0.6, 4.5)),
                int(rng.choice([9, 2, 0, 1, 5, 6])))
        img = scene.image_at(0.0)
        h, w = img.shape[:2]
        gts = []
        for i in range(len(scene.objects)):
            bb = scene.bbox_at(i, 0.0)
            if bb is None:
                continue
            gts.append({
                "x_min": max(bb["x_min"] / w, 0.0),
                "y_min": max(bb["y_min"] / h, 0.0),
                "x_max": min(bb["x_max"] / w, 1.0),
                "y_max": min(bb["y_max"] / h, 1.0),
                "label": bb["label"],
            })
        b, c, p = assign_targets(gts, ycfg)
        images.append(preprocess_detector_image(
            torch.as_tensor(img, dtype=torch.float32, device=device),
            ycfg.input_size))
        tb.append(b)
        tc.append(c)
        tp.append(p)
    return (torch.stack(images),
            *(torch.as_tensor(np.stack(a), device=device)
              for a in (tb, tc, tp)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="weights/detector.npz")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--input-size", type=int, default=416)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from ..config import GridVisionConfig
    from ..models.weights import flax_tree
    from ..models.yolov4_tiny import YoloConfig
    from ..utils import checkpoint, prng
    from . import trainer

    cfg = GridVisionConfig(detection_network_input_size=args.input_size)
    ycfg = YoloConfig(input_size=args.input_size)
    tx = trainer.AdamW(args.lr)
    state = trainer.init_train_state("yolo", ycfg, tx,
                                     prng.prng_key(0, device=device))
    step_fn = trainer.make_train_step("yolo", ycfg, tx)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.steps):
        batch = make_batch(cfg, ycfg, rng, args.batch, device)
        state, metrics = step_fn(state, *batch)
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {float(metrics['loss']):.4f} "
                  f"(box {float(metrics['box_loss']):.3f} "
                  f"obj {float(metrics['obj_loss']):.3f} "
                  f"cls {float(metrics['cls_loss']):.3f}) "
                  f"{time.time() - t0:.0f}s", flush=True)

    checkpoint.save(args.out, flax_tree(state.model))
    print(f"saved detector weights -> {args.out}")


if __name__ == "__main__":
    main()
