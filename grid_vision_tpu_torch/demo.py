"""End-to-end demo: `python -m grid_vision_tpu_torch demo [--mode
pca|vision] [--det oracle|net]` (counterpart of grid_vision_tpu/demo.py).

Streams a synthetic 10 Hz camera+LiDAR sequence through the fused engine
on the card (the reference's CARLA-topics-to-RViz loop, headless): moving
traffic in front of a ground plane, grid snapshots written as PGM,
detections as PPM, markers as JSON, every 5th tick and at the last.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .config import GridVisionConfig
from .device import resolve_device
from .io.scene import SyntheticScene
from .types import Boxes, Extrinsics

# camera (x right, y down, z fwd) -> base (x fwd, y left, z up)
_R_CB = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)


def default_extrinsics(device="cuda") -> Extrinsics:
    """LiDAR in the camera frame; camera axes rotated into the base frame.
    On the card unless the CPU is asked for."""
    device = resolve_device(device)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _R_CB
    return Extrinsics(lidar_to_camera=torch.eye(4, device=device),
                      camera_to_base=torch.as_tensor(T, device=device))


def oracle_boxes(scene: SyntheticScene, t: float, cfg: GridVisionConfig,
                 device="cuda") -> Boxes:
    """Ground-truth detections from the scene (the demo's stand-in for a
    trained detector; it drives the full downstream): every visible
    object's box up to max_detections, confidence 0.9, on `device`."""
    cap = cfg.max_detections
    xyxy = np.zeros((cap, 4), np.float32)
    conf = np.zeros((cap,), np.float32)
    label = np.full((cap,), 10, np.int32)
    valid = np.zeros((cap,), bool)
    n = 0
    for i in range(len(scene.objects)):
        bb = scene.bbox_at(i, t)
        if bb is None or n >= cap:
            continue
        xyxy[n] = [bb["x_min"], bb["y_min"], bb["x_max"], bb["y_max"]]
        conf[n] = 0.9
        label[n] = bb["label"]
        valid[n] = True
        n += 1
    dev = resolve_device(device)
    return Boxes(xyxy=torch.as_tensor(xyxy, device=dev),
                 confidence=torch.as_tensor(conf, device=dev),
                 label=torch.as_tensor(label, device=dev),
                 valid=torch.as_tensor(valid, device=dev))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch demo",
                                 description=__doc__)
    ap.add_argument("--mode", choices=["pca", "vision"], default="pca")
    ap.add_argument("--det", choices=["oracle", "net"], default="oracle",
                    help="oracle: ground-truth boxes from the scene; "
                         "net: the YOLOv4-tiny (weights/detector.npz if "
                         "present, else its random init)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    from . import pipeline
    from .io.viz import draw_boxes, markers_from_output, write_ppm
    from .runtime import native
    from .runtime.stream import ReplayResult, _finish, obs_from_scene, replay

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = GridVisionConfig(
        use_vision_orientation=(args.mode == "vision"),
        max_points=8192,
        # net mode picks up trained checkpoints from weights/ if present
        detection_weights_file="/weights/detector.npz"
        if args.det == "net" else "",
        vision_weights_file="/weights/orientation.npz"
        if args.mode == "vision" else "",
    )
    eng = pipeline.Engine(cfg, extrinsics=default_extrinsics(device),
                          seed=0, device=device)
    scene = SyntheticScene(cfg, seed=0)
    scene.add_default_traffic()

    os.makedirs(args.out, exist_ok=True)
    snapshots = []

    def on_step(i, state, out):
        if i % 5 == 0 or i == args.steps - 1:
            snapshots.append((i, out))

    if args.det == "oracle":
        state = eng.init_state()
        t0 = time.perf_counter()
        for i in range(args.steps):
            t = i / 10.0
            obs = obs_from_scene(scene, t, cfg, device)
            boxes = oracle_boxes(scene, t, cfg, device)
            state, out = pipeline.fuse(eng.params, state, obs, boxes,
                                       eng.extrinsics, cfg)
            on_step(i, state, out)
        _finish(state)
        result = ReplayResult(n_steps=args.steps,
                              wall_s=time.perf_counter() - t0, stats=[],
                              final_state=state)
    else:
        result = replay(eng, scene, n_steps=args.steps, hz=10.0,
                        on_step=on_step)

    for i, out in snapshots:
        native.write_pgm(os.path.join(args.out, f"grid_{i:03d}.pgm"),
                         out.occupancy_i8.cpu().numpy())
        img = draw_boxes(np.asarray(scene.image_at(i / 10.0)), out.boxes)
        write_ppm(os.path.join(args.out, f"dets_{i:03d}.ppm"), img)
        with open(os.path.join(args.out, f"markers_{i:03d}.json"),
                  "w") as f:
            json.dump(markers_from_output(out), f, indent=1)

    lo = result.final_state.log_odds.cpu().numpy()
    print(f"steps: {result.n_steps}  wall: {result.wall_s:.2f}s  "
          f"rate: {result.achieved_hz:.1f} Hz")
    print(f"grid log-odds range: [{lo.min():.2f}, {lo.max():.2f}]  "
          f"occupied cells (p>0.5): {(1/(1+np.exp(-lo)) > 0.5).sum()}")
    print(f"snapshots in {args.out}/")


if __name__ == "__main__":
    main()
