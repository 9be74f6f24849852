#!/usr/bin/env python3
"""The shipped weights' training recipe (docs/QUALITY.md) through the
PyTorch port's CLI on one card, scored by the port's evaluators.

    python3 tools/torch_train_recipe.py [--out build/recipe]

Each step is a `python -m grid_vision_tpu_torch` subprocess, timed on the
host clock, its output kept in OUT/<step>.log:

1. train detector --steps 8000 --scene-frames 640 --scene-frac 0.375
   --two-wheeler-boost 0.7 --out OUT/detector.npz
2. eval --source synth and eval --source scene on OUT/detector.npz
   (64 held-out frames each; mAP@0.5 and per-class AP)
3. train orientation --steps 4000 --scene-crops 768 --out
   OUT/orientation.npz (its angle and dims recovery)
4. the 64-rig fleet tick on OUT's weights in bf16 on the kernel backends
   against the plain ones (bf16_stats of tests/test_torch_cuda_tick.py;
   root PERF.md §2's bf16 bars, its meets_bf16_bars), and in f32 (its
   compare_outputs' bars)

Prints the card's name and power limit, then one JSON line. Never writes
to weights/. Smaller runs for a rehearsal: --detector-steps,
--orientation-steps, --scene-frames, --scene-crops, --images, --rigs and
--cpu (which skips step 4: the kernels run only on a card).

Step 4 alone, on weights already trained, the shipped ones beside them:

    python3 tools/torch_train_recipe.py --fleet-only --out DIR \
        [--fleet-device cpu] [--rigs 8]

On the CPU each kernel backend runs its kernel's plain twin, so the bf16
comparison there shows what the two paths' roundings do without a kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cli(out_dir: str, name: str, *args: str) -> tuple:
    """Run `python -m grid_vision_tpu_torch args`; (seconds, stdout)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "grid_vision_tpu_torch",
                        *args], cwd=ROOT, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{name}.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode != 0:
        sys.exit(f"{name} failed ({r.returncode}): {r.stderr[-2000:]}")
    return seconds, r.stdout


def fleet_check(det: str, ori: str, rigs: int, device: str = "cuda",
                dtypes=("float32", "bfloat16")) -> dict:
    """Three fleet ticks on these weights, kernel backends against the plain
    ones: f32 at compare_outputs' bars (fails the run), bf16 with
    bf16_stats (reported, with whether §2's bars are met)."""
    import dataclasses

    import torch

    sys.path.insert(0, ROOT)
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.config import GridVisionConfig
    from grid_vision_tpu_torch.demo import default_extrinsics
    from grid_vision_tpu_torch.ops import cuda_build
    from grid_vision_tpu_torch.runtime.stream import FleetPool
    from tests.test_torch_cuda_tick import (bf16_stats, compare_outputs,
                                            meets_bf16_bars, run_fleet)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        cuda_build.build_all()
    cfg = GridVisionConfig(
        detection_weights_file=det, vision_weights_file=ori,
        max_points=8192, max_static_depth=16,
        detector_stem_backend="pallas2", orientation_stem_backend="pallas",
        grid_backend="pallas", knn_backend="pallas")
    plain_kw = dict(detector_stem_backend="xla",
                    orientation_stem_backend="xla", grid_backend="xla",
                    knn_backend="xla")
    ext = default_extrinsics(dev)
    obs = [FleetPool(cfg, rigs, device=dev).obs(i) for i in range(3)]
    out = {}
    for dtype in dtypes:
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        kern = pipeline.Engine(c, extrinsics=ext, device=dev)
        plain = pipeline.Engine(dataclasses.replace(c, **plain_kw),
                                extrinsics=ext, params=kern.params,
                                device=dev)
        o = obs if dtype == "float32" else [
            dataclasses.replace(x, image=x.image.to(torch.bfloat16))
            for x in obs]
        outs = run_fleet(kern, o, 5 * rigs)
        plain_outs = run_fleet(plain, o, 5 * rigs)
        if dtype == "float32":
            agree, boxes, poses = compare_outputs(c, outs, plain_outs,
                                                  per_rig=True)
            out[dtype] = dict(min_occupancy_i8_agreement_per_rig=agree,
                              boxes_per_tick=boxes, poses_per_tick=poses)
        else:
            r = bf16_stats(c, outs, plain_outs)
            out[dtype] = dict(r, section2_bars_met=meets_bf16_bars(r))
    return out


def fleet_only(args, card: str) -> dict:
    """Step 4 alone in bf16, on --out's weights and on the shipped ones,
    on --fleet-device."""
    res = {"card": card, "device": args.fleet_device, "rigs": args.rigs}
    for name, d in (("shipped", os.path.join(ROOT, "weights")),
                    ("trained", os.path.abspath(args.out))):
        t0 = time.perf_counter()
        res[name] = fleet_check(
            os.path.join(d, "detector.npz"),
            os.path.join(d, "orientation.npz"), args.rigs,
            device=args.fleet_device, dtypes=("bfloat16",))["bfloat16"]
        res[name]["seconds"] = time.perf_counter() - t0
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "recipe"))
    ap.add_argument("--detector-steps", type=int, default=8000)
    ap.add_argument("--orientation-steps", type=int, default=4000)
    ap.add_argument("--scene-frames", type=int, default=640)
    ap.add_argument("--scene-crops", type=int, default=768)
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--rigs", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--fleet-only", action="store_true")
    ap.add_argument("--fleet-device", default="cuda")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    cpu = ["--cpu"] if args.cpu else []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True) if not args.cpu else None
    card = smi.stdout.strip() if smi is not None else "cpu"
    if args.fleet_only:
        res = fleet_only(args, card)
        print(card, flush=True)
        print(json.dumps(res), flush=True)
        return
    det = os.path.join(out, "detector.npz")
    ori = os.path.join(out, "orientation.npz")
    res = {"card": card}
    t0 = time.perf_counter()
    s, log = cli(out, "train_detector", "train", "detector", "--steps",
                 str(args.detector_steps), "--scene-frames",
                 str(args.scene_frames), "--scene-frac", "0.375",
                 "--two-wheeler-boost", "0.7", "--out", det, *cpu)
    chunks = re.findall(r"loss ([\d.]+) -> ([\d.]+)", log)
    res["train_detector"] = dict(seconds=s, first_loss=float(chunks[0][0]),
                                 last_loss=float(chunks[-1][1]))
    for source in ("synth", "scene"):
        s, log = cli(out, f"eval_{source}", "eval", "--source", source,
                     "--images", str(args.images), "--weights", det, *cpu)
        res[f"eval_{source}"] = dict(json.loads(log), seconds=s)
    s, log = cli(out, "train_orientation", "train", "orientation",
                 "--steps", str(args.orientation_steps), "--scene-crops",
                 str(args.scene_crops), "--out", ori, *cpu)
    angle = re.search(r"angle recovery: median ([\d.]+) deg, 90pct "
                      r"([\d.]+) deg", log)
    dims = re.search(r"dims recovery: median \|err\| ([\d.]+) m, 90pct "
                     r"([\d.]+) m", log)
    res["train_orientation"] = dict(
        seconds=s, angle_median_deg=float(angle.group(1)),
        angle_p90_deg=float(angle.group(2)),
        dims_median_m=float(dims.group(1)), dims_p90_m=float(dims.group(2)))
    res["recipe_wall_s"] = time.perf_counter() - t0
    if not args.cpu:
        res["fleet_tick"] = fleet_check(det, ori, args.rigs)
    print(card, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
