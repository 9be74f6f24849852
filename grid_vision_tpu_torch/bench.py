"""Benchmark: sustained fused camera+LiDAR frames/s of the fleet tick on the
card (counterpart of the root bench.py; `python -m grid_vision_tpu_torch
bench`).

The measured program is bench.py's: the full-fusion configuration
(YOLOv4-tiny detect + NMS + static kNN depth + fleet-compacted MultiBin
orientation + grid update) over a batch of independent sensor rigs on one
card, bf16, 8192 points, static compaction to 16, the shipped weights.

  - chunks of GV_BENCH_SCAN fleet ticks (pipeline.fleet_step with the
    orientation budget); each tick's observation is the rig's traffic
    scene (runtime/stream.FleetPool at tick 0, bench.build_obs_pool's
    scenes, bf16 frames) perturbed per tick and per rig by a brightness
    offset and a point jitter drawn on the card from a carried threefry
    key (utils/prng: the JAX package's draws, bit for bit), so every frame
    pays the full tick and no sensor bytes cross the host link while
    timed;
  - every published output (boxes, poses, static points, the int8 grid,
    the saturation counters) is summed into a digest on the card
    (output_digest), which the chunk carries: nothing the node publishes
    is left uncomputed;
  - synchronization is one scalar readback of the digest; the warm
    readback latency is subtracted;
  - timed in groups of 16 chunks, at least 3 groups, until a third of
    GV_BENCH_BUDGET_S has passed or 256 chunks have run; the median
    group's rate is reported.

Knobs (environment, bench.py's names and defaults): GV_BENCH_RIGS (128),
GV_BENCH_SCAN (8), GV_BENCH_BUDGET_S (180), GV_BENCH_ORIENT_BUDGET
(5 x rigs), GV_BENCH_KNN (xla), GV_BENCH_STEM (pallas: the bf16 stem
kernel), GV_BENCH_ORIENT_STEM (xla), GV_BENCH_ORIENT_DTYPE (follow).
GV_BENCH_STEM=pallas2 GV_BENCH_ORIENT_STEM=pallas runs the three bf16
kernels (stem, CSP stage, orientation front); MODES names both settings.

Prints progress on stderr and ONE JSON line on stdout:
{"metric": "fused_frames_per_sec", "value", "unit"}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Callable, Mapping

import torch

from . import pipeline
from .config import GridVisionConfig
from .device import resolve_device
from .runtime.stream import FleetPool
from .types import Obs, PointCloud
from .utils import prng


# the knob settings the repo measures: bench.py's defaults (the bf16 stem
# kernel), and the three bf16 kernels
MODES = {"defaults": {},
         "pallas2_pallas": {"GV_BENCH_STEM": "pallas2",
                            "GV_BENCH_ORIENT_STEM": "pallas"}}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def bench_config(env: Mapping[str, str] = os.environ):
    """bench.py's configuration and knobs from `env`: (cfg, n_rigs, scan
    ticks a chunk, budget seconds, orientation budget)."""
    n_rigs = int(env.get("GV_BENCH_RIGS", "128"))
    scan = int(env.get("GV_BENCH_SCAN", "8"))
    budget_s = float(env.get("GV_BENCH_BUDGET_S", "180"))
    budget = int(env.get("GV_BENCH_ORIENT_BUDGET", 5 * n_rigs))
    cfg = GridVisionConfig(
        max_points=8192, compute_dtype="bfloat16",
        knn_backend=env.get("GV_BENCH_KNN", "xla"),
        detector_stem_backend=env.get("GV_BENCH_STEM", "pallas"),
        orientation_stem_backend=env.get("GV_BENCH_ORIENT_STEM", "xla"),
        max_static_depth=16,
        orientation_compute=env.get("GV_BENCH_ORIENT_DTYPE", "follow"),
        detection_weights_file="weights/detector.npz",
        vision_weights_file="weights/orientation.npz")
    return cfg, n_rigs, scan, budget_s, budget


def build_pool(cfg: GridVisionConfig, n_rigs: int, device="cuda",
               image_dtype=torch.bfloat16) -> Obs:
    """bench.build_obs_pool: one traffic scene a rig (FleetPool's tick 0),
    frames stored in image_dtype, on `device` once."""
    return FleetPool(cfg, n_rigs, device=device,
                     image_dtype=image_dtype).obs(0)


def draw_perturbations(key: torch.Tensor, n_steps: int, n_rigs: int):
    """A chunk's per-tick, per-rig perturbations in two draws on key's
    device: (bright (T, R, 1, 1, 1) in [-8, 8), jitter (T, R, 1, 3) in
    [-0.03, 0.03)), bit-equal to bench.draw_perturbations."""
    kb, kp = prng.split(key)
    bright = prng.uniform(kb, (n_steps, n_rigs, 1, 1, 1), -8.0, 8.0)
    jitter = prng.uniform(kp, (n_steps, n_rigs, 1, 3), -0.03, 0.03)
    return bright, jitter


def apply_perturbation(pool: Obs, bright: torch.Tensor,
                       jitter: torch.Tensor) -> Obs:
    """One tick's perturbed fleet observation: the brightness cast to the
    frames' dtype and added (one rounding of the exact sum), the jitter
    added to every point."""
    return Obs(image=pool.image + bright.to(pool.image.dtype),
               cloud=PointCloud(xyz=pool.cloud.xyz + jitter,
                                intensity=pool.cloud.intensity,
                                count=pool.cloud.count),
               has_image=pool.has_image, has_cloud=pool.has_cloud)


def output_digest(out) -> torch.Tensor:
    """A f32 scalar on the card that depends on every published output of
    the tick (bench.output_digest): the reference publishes boxes,
    markers, static localizations and the int8 grid every tick, so each
    of them must be computed and read."""
    sat = out.saturation
    counters = (sat.prenms_overflow + sat.orientation_clamped
                + sat.box_cloud_truncated + sat.orientation_dropped
                + sat.static_depth_clamped)
    return (out.static_points.sum() + out.poses.position.sum()
            + out.boxes.confidence.sum()
            + out.occupancy_i8.to(torch.float32).sum()
            + counters.to(torch.float32).sum())


@torch.no_grad()
def run_chunk(params, states, pool: Obs, extrinsics, cfg: GridVisionConfig,
              key: torch.Tensor, scan: int, budget: int):
    """`scan` fleet ticks on perturbed pool observations. The key is
    carried: split into (successor, chunk key), the chunk's perturbations
    drawn from the chunk key. Returns (states', digest, successor key);
    nothing is read back."""
    key, sub = prng.split(key)
    bright, jitter = draw_perturbations(sub, scan, pool.image.shape[0])
    acc = torch.zeros((), dtype=torch.float32, device=pool.image.device)
    for t in range(scan):
        obs = apply_perturbation(pool, bright[t], jitter[t])
        states, out = pipeline.fleet_step(params, states, obs, extrinsics,
                                          cfg, orientation_budget=budget)
        acc = acc + output_digest(out)
    return states, acc, key


def readback(x: torch.Tensor) -> float:
    """The host waits for the card: one scalar readback."""
    return x.reshape(-1)[0].to(torch.float32).item()


def measure(chunk: Callable[[], None], sync: Callable[[], None],
            frames_per_chunk: int, budget_s: float,
            group_chunks: int = 16, max_chunks: int = 256,
            clock: Callable[[], float] = time.perf_counter) -> dict:
    """bench.py's timing: chunk() runs one chunk (the caller carries the
    state), sync() reads the digest back. One settling chunk, the warm
    readback latency (least of 3), then groups of `group_chunks` chunks,
    each ended by sync() and timed less that latency, at least 3 groups,
    until budget_s / 3 has passed or max_chunks chunks have run. Returns
    the median group's frames/s (bench.py's number) and the run's record,
    with `window_fps`: the frames over the sum of the group times, the
    whole window's rate, which a stalled group moves."""
    t0 = clock()
    chunk()
    sync()
    settle_s = clock() - t0
    lat = []
    for _ in range(3):
        t = clock()
        sync()
        lat.append(clock() - t)
    sync_lat = min(lat)
    group_fps, chunks, frames, timed_s = [], 0, 0, 0.0
    t_start = clock()
    while len(group_fps) < 3 or clock() - t_start < budget_s / 3:
        t_g = clock()
        for _ in range(group_chunks):
            chunk()
            chunks += 1
        sync()
        g_elapsed = clock() - t_g - sync_lat
        g_frames = frames_per_chunk * group_chunks
        frames += g_frames
        timed_s += g_elapsed
        group_fps.append(g_frames / max(g_elapsed, 1e-9))
        if chunks >= max_chunks:
            break
    return dict(fps=float(statistics.median(group_fps)), group_fps=group_fps,
                window_fps=frames / max(timed_s, 1e-9),
                chunks=chunks, frames=frames,
                elapsed_s=clock() - t_start, sync_latency_s=sync_lat,
                settle_s=settle_s)


def result_line(fps: float) -> str:
    """The JSON line bench.py prints, less vs_baseline (its divisor is a
    TPU target)."""
    return json.dumps({"metric": "fused_frames_per_sec",
                       "value": round(fps, 1), "unit": "frames/s"})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch bench",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins; a "
                         "check of the program, not a measurement)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg, n_rigs, scan, budget_s, budget = bench_config()
    eng = pipeline.Engine(cfg, device=device)
    pool = build_pool(cfg, n_rigs, device)
    carry = dict(states=eng.init_states(n_rigs),
                 key=prng.prng_key(100, device=device), acc=None)

    def chunk():
        carry["states"], carry["acc"], carry["key"] = run_chunk(
            eng.params, carry["states"], pool, eng.extrinsics, cfg,
            carry["key"], scan, budget)

    r = measure(chunk, lambda: readback(carry["acc"]), n_rigs * scan,
                budget_s)
    log(f"[bench] settle (kernel builds, first chunk): "
        f"{r['settle_s']:.1f}s")
    log(f"[bench] readback latency: {r['sync_latency_s'] * 1e3:.2f} ms")
    log(f"[bench] {r['chunks']} chunks in {len(r['group_fps'])} groups, "
        f"{r['frames']} frames, {r['elapsed_s']:.1f}s; group fps "
        f"{[round(f) for f in r['group_fps']]}")
    log(f"[bench] whole window: {r['window_fps']:.1f} frames/s")
    print(result_line(r["fps"]), flush=True)


if __name__ == "__main__":
    main()
