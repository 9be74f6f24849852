#!/usr/bin/env python3
"""Where a tick of the port's bench spends its time, on the card.

    python3 tools/torch_bench_profile.py [--rigs 128] [--modes defaults,pallas2_pallas]

For each mode (defaults: bench.py's configuration, the bf16 stem kernel
only; pallas2_pallas: GV_BENCH_STEM=pallas2 GV_BENCH_ORIENT_STEM=pallas,
the three bf16 kernels) it builds grid_vision_tpu_torch/bench.py's engine
and pool at --rigs, runs one chunk to warm up, then one chunk of 8 ticks
under torch.profiler and one without: the host-clock ms a tick, the
device's busy ms, its idle share of the plain tick and of the profiled one
(the profiler slows the host), device launches a tick, the host ms the
tick's Python spends in each pipeline stage (profiler CPU ranges of the
stage functions), and the 15 kernels with the most device time. One JSON
line per mode, then the card. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tick's stages, as pipeline functions whose host time is recorded
STAGES = ("detect_batch", "_fleet_vision_poses", "_fuse_rigs")


def profile_mode(torch, dev, rigs: int, env: dict) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from grid_vision_tpu_torch import bench, pipeline
    from grid_vision_tpu_torch.utils import prng
    cfg, n_rigs, scan, _, budget = bench.bench_config(
        dict(env, GV_BENCH_RIGS=str(rigs)))
    eng = pipeline.Engine(cfg, device=dev, base_dir=ROOT)
    pool = bench.build_pool(cfg, n_rigs, dev)
    carry = dict(states=eng.init_states(n_rigs),
                 key=prng.prng_key(100, device=dev))

    def chunk():
        carry["states"], acc, carry["key"] = bench.run_chunk(
            eng.params, carry["states"], pool, eng.extrinsics, cfg,
            carry["key"], scan, budget)
        bench.readback(acc)

    originals = {name: getattr(pipeline, name) for name in STAGES}

    def ranged(name, fn):
        def call(*args, **kwargs):
            with record_function(f"stage::{name}"):
                return fn(*args, **kwargs)
        return call

    chunk()
    t0 = time.perf_counter()
    chunk()
    plain_ms = (time.perf_counter() - t0) * 1e3 / scan
    try:
        for name, fn in originals.items():
            setattr(pipeline, name, ranged(name, fn))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunk()
            wall_ms = (time.perf_counter() - t0) * 1e3 / scan
    finally:
        for name, fn in originals.items():
            setattr(pipeline, name, fn)
    by_name, launches, stages = {}, {}, {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / scan
        if e.name.startswith("stage::"):
            # the ranges also show as device-side annotations: host only
            if e.device_type == torch.autograd.DeviceType.CPU:
                stages[e.name[7:]] = stages.get(e.name[7:], 0.0) + ms
            continue
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        launches[e.name] = launches.get(e.name, 0) + 1
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return dict(rigs=n_rigs, ticks=scan, budget=budget,
                tick_ms=plain_ms, frames_per_s=n_rigs / plain_ms * 1e3,
                profiled_tick_ms=wall_ms, device_busy_ms=busy,
                device_idle_share=1.0 - busy / plain_ms,
                device_idle_share_profiled=1.0 - busy / wall_ms,
                device_launches_per_tick=sum(launches.values()) / scan,
                stage_host_ms=stages,
                top_kernels=[dict(name=n[:90], ms_per_tick=ms,
                                  launches_per_tick=launches[n] / scan)
                             for n, ms in ranked])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rigs", type=int, default=128)
    ap.add_argument("--modes", default="defaults,pallas2_pallas")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the card")
    sys.path.insert(0, ROOT)
    from grid_vision_tpu_torch.bench import MODES
    torch.backends.cudnn.allow_tf32 = False
    for mode in args.modes.split(","):
        print(json.dumps(dict(mode=mode, **profile_mode(
            torch, torch.device("cuda", 0), args.rigs, MODES[mode]))),
            flush=True)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
