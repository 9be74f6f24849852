#!/usr/bin/env python3
"""Device time of the int8 detector's forward, and of the f32 and bf16
forwards beside it, on one NVIDIA card (grid_vision_tpu_torch; imports
nothing of JAX):

    python3 tools/torch_int8_forward_times.py [--root DIR] [--frames 64]
        [--iters 5]

The package is imported from --root (default: the checkout holding this
tool), so that two trees unpacked side by side (git archive) are timed in
one call, in turns. The frames: FleetPool tick 0 of the fleet
configuration (bench.py:240-245, 480x640), resized to 416 by
preprocess_detector_image; the shipped weights (weights/detector.npz),
quantized by the tree's yolov4_int8.quantize_detector. torch.profiler over
`iters` forwards (one first to warm): the device ms a forward, the int8
conv kernel's share of it (every instance), the launches a forward and
the top kernels by device time; CUDA events around
the same calls beside it. Prints one JSON line, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile


def breakdown(fn, iters: int, top: int = 8) -> dict:
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
    ms, n = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        ms[e.name] = ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        n[e.name] = n.get(e.name, 0) + 1
    ranked = sorted(ms.items(), key=lambda kv: -kv[1])
    return dict(device_ms=sum(ms.values()) / iters,
                int8_kernel_ms=sum(v for k, v in ms.items()
                                   if "gv_int8" in k) / iters,
                launches=sum(n.values()) / iters,
                event_ms=start.elapsed_time(stop) / iters,
                top_kernels=[dict(name=k[:80], ms=v / iters,
                                  launches=n[k] / iters)
                             for k, v in ranked[:top]])


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import dataclasses

    from grid_vision_tpu_torch import GridVisionConfig
    from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops.preprocess import preprocess_detector_image
    from grid_vision_tpu_torch.runtime.stream import FleetPool
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = GridVisionConfig(
        detection_weights_file=os.path.join(root, "weights/detector.npz"))
    fleet_cfg = dataclasses.replace(cfg, max_points=8192,
                                    max_static_depth=16)
    det = weights.load_all(cfg, device=dev)["detector"]
    q = yolov4_int8.quantize_detector(det)
    frames = FleetPool(fleet_cfg, args.frames, device=dev).obs(0).image
    net_in = preprocess_detector_image(frames, cfg.resize)
    ycfg = yolov4_tiny.YoloConfig(input_size=cfg.resize)
    out = dict(root=root, frames=args.frames, size=cfg.resize)
    for name, fn in (
            ("int8", lambda: yolov4_int8.forward_int8(q, net_in, ycfg)),
            ("f32", lambda: yolov4_tiny.forward(det, net_in,
                                                dtype=torch.float32)),
            ("bf16", lambda: yolov4_tiny.forward(det, net_in,
                                                 dtype=torch.bfloat16))):
        out[name] = breakdown(fn, args.iters)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
