"""Detector training on the card: ``python -m grid_vision_tpu_torch train
detector`` (counterpart of grid_vision_tpu/train/fit_on_device.py).

The whole loop (synthetic rendering, target assignment, forward, backward,
optimizer update) runs on the card: each chunk of --scan steps draws its
batches there from threefry keys (train/synth_data.py, and the pre-rendered
scene frames uploaded once as uint8) and reads nothing back until the
chunk's losses are printed, the counterpart of the JAX trainer's lax.scan.
Produces the YOLOv4-tiny weights of the engine's detector.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.weights import flax_tree
from ..models.yolov4_tiny import YoloConfig
from ..ops.preprocess import preprocess_detector_image
from ..utils import checkpoint, prng
from . import trainer
from .synth_data import make_batch_on_device


def scene_batch(ds, key: torch.Tensor, b_scene: int, ycfg: YoloConfig):
    """b_scene frames of the uploaded scene set ds = (uint8 frames,
    tgt_boxes, tgt_class, tgt_pos), drawn and photometrically augmented on
    the card (gain 0.85-1.15, noise sigma 4; the geometry stays, as the
    dense targets encode box positions), resized to the net's input."""
    ki, kb, kn = prng.split(key, 3).unbind(-2)
    idx = prng.randint(ki, (b_scene,), 0, ds[0].shape[0]).long()
    raw = ds[0][idx].float()
    raw = raw * prng.uniform(kb, (b_scene, 1, 1, 1), 0.85, 1.15)
    raw = torch.clamp(raw + prng.normal(kn, raw.shape) * 4.0, 0.0, 255.0)
    return (preprocess_detector_image(raw, ycfg.input_size), ds[1][idx],
            ds[2][idx], ds[3][idx])


def run_chunk(state, step_fn, keys: torch.Tensor, b_synth: int,
              b_scene: int, ycfg: YoloConfig, ds=()):
    """One chunk: a step per key of keys (S, 2), each on split(key) ->
    (synth key, scene key). Returns (state, losses (S,) on the card); no
    value is read back."""
    losses = []
    for kk in keys:
        k1, k2 = prng.split(kk).unbind(-2)
        batch = make_batch_on_device(k1, b_synth, ycfg)
        if b_scene:
            batch = tuple(torch.cat([a, b]) for a, b in
                          zip(batch, scene_batch(ds, k2, b_scene, ycfg)))
        state, metrics = step_fn(state, *batch)
        losses.append(metrics["loss"])
    return state, torch.stack(losses)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch train detector",
                                 description=__doc__)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--scan", type=int, default=50,
                    help="train steps per chunk (one readback each)")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--out", default="weights/detector.npz")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--input-size", type=int, default=416)
    ap.add_argument("--scene-frames", type=int, default=0,
                    help="mix in N pre-rendered replay-world frames "
                         "(train/scene_dataset.py; uploaded once)")
    ap.add_argument("--scene-frac", type=float, default=0.5,
                    help="fraction of each batch drawn from the scene "
                         "dataset (rest is on-device rectangles)")
    ap.add_argument("--two-wheeler-boost", type=float, default=0.0,
                    help="per-frame probability of injecting extra "
                         "far-depth bikes/motorbikes into the scene "
                         "dataset (train/scene_dataset.py)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    ycfg = YoloConfig(input_size=args.input_size)
    tx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(100, args.steps // 5),
        decay_steps=args.steps), weight_decay=1e-5)
    state = trainer.init_train_state("yolo", ycfg, tx,
                                     prng.prng_key(0, device=device))
    step_fn = trainer.make_train_step("yolo", ycfg, tx)

    b_scene = (int(round(args.batch * args.scene_frac))
               if args.scene_frames else 0)
    b_synth = args.batch - b_scene
    ds = ()
    if b_scene:
        from ..config import GridVisionConfig
        from .scene_dataset import build_scene_dataset
        print(f"rendering {args.scene_frames} scene frames...", flush=True)
        ds = tuple(torch.as_tensor(a, device=device)
                   for a in build_scene_dataset(
                       args.scene_frames, GridVisionConfig(), ycfg,
                       two_wheeler_boost=args.two_wheeler_boost))

    n_chunks = max(args.steps // args.scan, 1)
    chunk_keys = torch.stack([prng.prng_key(1000 + c) for c in
                              range(n_chunks)]).to(device)
    t0 = time.time()
    chunk_losses = []
    for c in range(n_chunks):
        state, losses = run_chunk(state, step_fn,
                                  prng.split(chunk_keys[c], args.scan),
                                  b_synth, b_scene, ycfg, ds)
        losses = losses.cpu().numpy()
        chunk_losses.append(losses)
        print(f"steps {c * args.scan}-{(c + 1) * args.scan - 1}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)

    checkpoint.save(args.out, flax_tree(state.model))
    print(f"saved detector weights -> {args.out}")
    return {"losses": np.stack(chunk_losses), "state": state,
            "seconds": time.time() - t0}


if __name__ == "__main__":
    main()
