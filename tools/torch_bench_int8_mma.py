#!/usr/bin/env python3
"""int8 vs bf16 tensor-core rate of the port's GEMM kernel on one NVIDIA
card: the counterpart of tools/bench_int8_mxu.py for
grid_vision_tpu_torch (imports nothing of JAX).

    python3 tools/torch_bench_int8_mma.py [--m 8192] [--k 2304] [--n 256]
        [--iters 16] [--groups 8] [--plans 64,256/tiled]
    python3 tools/torch_bench_int8_mma.py --sites [--frames 64]
        [--plans 64,128/gather] [--root DIR]

The same detector-shaped product as the Pallas tool (an im2col'd 3x3
conv: M the positions, K = 9 * Cin, N = Cout), through the kernel of
csrc/cuda_int8.cu in its two instantiations, ops/cuda_int8.int8_matmul
(s8 x s8 -> s32) and bf16_matmul (bf16 x bf16 -> f32), on the same
operands as the tool (numpy seed 0: integers in [-127, 127) and unit
normals). b is held in the kernel's weight layout (column-major, b.t()
contiguous), as the tool's whole-K kernel keeps its weights resident.
Timing: CUDA events around `iters` back-to-back calls, the median over
`groups` (the tool chains its calls and reads back a scalar), with the
min and max of the groups beside it. Prints the tool's lines (`int8: ...
us  ... TF/s`, `bf16: ...`, the speedup), then
the same for torch._int_mm and torch.matmul on the same operands (the
library's rates, measured here and used nowhere in the port), and the
card's name and power limit. Each result is held against its plain version
first: s8 bit-equal to int8_matmul_plain and to torch._int_mm, bf16 within
cuda_int8.f32_sum_bound of bf16_matmul_plain (K 2^-24 sum |a||b|, the
bound of any f32 sum of K terms). `--plans` times the kernel under each
forced plan in turn (ops/cuda_int8.force_plan): `BN` an N tile, `/route`
a route, `BN/route` both (ops/cuda_int8.int8_plan picks otherwise; a
route a layer cannot take is skipped there).

`--clocks` (with `--sites`) adds each site's cycles a tile by phase,
from the kernel's -DGV_INT8_CLOCKS build (producer waiting for an empty
stage and working; consumers waiting for a full stage, in the products,
in the epilogue, at a tile's start).

`--root` imports the package from another checkout (default: the one
holding this tool), so that two trees unpacked side by side (git archive)
are timed in one call; a tree without ops/cuda_int8.int8_plan (before its
redesign) is timed under its own tile rule, without forced plans.

`--sites`: the int8 detector's 19 convs instead (the shipped weights
quantized, `--frames` random frames at 416, each site's own quantized
input), each timed as the path runs it (int8_conv_requant, the requant
in the epilogue) under the rule's plan and each forced one: one line a
site (M, K, N, the rule's route and tile, its bound in us and by what:
int8 in, weights and f32 out at 3.35 TB/s or 2 M N K at 1979 TOPS; us a
call under each plan as median [min, max] by CUDA events, which for the
small sites is the wrapper's host time; the rule's device us from
a CUDA graph of the calls, the acc mode's beside it, and the rule's share
of the bound) and the sums.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

def _root() -> str:
    if "--root" in sys.argv:
        return os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


sys.path.insert(0, _root())

from grid_vision_tpu_torch.ops import cuda_int8  # noqa: E402


PEAK_BYTES = 3.35e12         # H100 SXM HBM3
PEAK_INT8 = 1979e12          # dense int8 tensor-core operations


def time_op(fn, iters: int, groups: int):
    """Seconds per call over `groups` runs of `iters` calls: (median,
    min, max) of the groups."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / 1e3 / iters)
    return statistics.median(times), min(times), max(times)


def device_us(fn, iters: int, groups: int = 5) -> float:
    """Device microseconds a call: `iters` calls captured in a CUDA graph,
    replayed `groups` times between CUDA events, the median (the launches
    back to back on the card, without the wrapper's host time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) * 1e3 / iters)
    del graph
    return statistics.median(times)


CLOCK_NAMES = ("producer_wait", "producer_work", "consumer_wait",
               "consumer_mma", "epilogue_buffer_wait", "consumer_tile_start",
               "epilogue_requant_stage", "epilogue_store")


def clocks(fn) -> dict:
    """One call of fn under the kernel's -DGV_INT8_CLOCKS build: cycles a
    tile in each phase (thread 0 of the producer and of the first consumer
    warpgroup, summed over the blocks, over the tiles)."""
    import ctypes
    from grid_vision_tpu_torch.ops import cuda_build
    lib = cuda_build.load("cuda_int8", ("GV_INT8_CLOCKS",))
    entry = lib.gv_int8_conv
    entry.restype = ctypes.c_int
    entry.argtypes = cuda_int8._entry().argtypes
    buf = (ctypes.c_ulonglong * (len(CLOCK_NAMES) + 2))()
    saved = cuda_int8._entry
    cuda_int8._entry = lambda: entry
    try:
        fn()
        torch.cuda.synchronize()
        lib.gv_int8_clocks(buf)           # zero
        fn()
        torch.cuda.synchronize()
        lib.gv_int8_clocks(buf)
    finally:
        cuda_int8._entry = saved
    k = len(CLOCK_NAMES)
    tiles = max(buf[k + 1], 1)
    out = {name: buf[i] / tiles for i, name in enumerate(CLOCK_NAMES)}
    out.update(blocks=buf[k], tiles=buf[k + 1])
    return out


def parse_plans(text: str):
    """'64,128/gather,/tiled' -> [(64, None), (128, 'gather'), (None,
    'tiled')]."""
    out = []
    for item in (t for t in text.split(",") if t):
        bn, _, route = item.partition("/")
        out.append((int(bn) if bn else None, route or None))
    return out


def plan_name(plan) -> str:
    bn, route = plan
    return f"{bn or ''}{'/' + route if route else ''}"


def us(t) -> str:
    return f"{t[0] * 1e6:.1f} [{t[1] * 1e6:.1f}, {t[2] * 1e6:.1f}]"


def operands(m: int, k: int, n: int, dev):
    """The Pallas tool's operands (its seed and draws), b column-major."""
    rng = np.random.default_rng(0)
    a8 = torch.from_numpy(rng.integers(-127, 127, (m, k), np.int8)).to(dev)
    b8 = torch.from_numpy(rng.integers(-127, 127, (k, n), np.int8)).to(dev)
    a16 = torch.from_numpy(rng.normal(size=(m, k))).to(dev).bfloat16()
    b16 = torch.from_numpy(rng.normal(size=(k, n))).to(dev).bfloat16()
    return dict(int8=(a8, b8.t().contiguous().t()),
                bf16=(a16, b16.t().contiguous().t()))


def check(ops) -> None:
    a, b = ops["int8"]
    got = cuda_int8.int8_matmul(a, b)
    if not (torch.equal(got, cuda_int8.int8_matmul_plain(a, b))
            and torch.equal(got, torch._int_mm(a, b))):
        sys.exit("int8_matmul differs from its plain version / _int_mm")
    a, b = ops["bf16"]
    err = (cuda_int8.bf16_matmul(a, b) - cuda_int8.bf16_matmul_plain(a, b))
    if not (err.abs() <= cuda_int8.f32_sum_bound(a, b)).all():
        sys.exit(f"bf16_matmul off its plain version by {err.abs().max()}, "
                 "beyond the f32 sum bound")


def rates(named, ops, flops, iters, groups):
    """Prints the tool's lines for {name: fn(a, b)} over the two dtypes
    (keys int8 / bf16); returns the seconds a call."""
    out = {}
    for name in ("bf16", "int8"):
        a, b = ops[name]
        t = time_op(lambda: named[name](a, b), iters, groups)
        out[name] = t[0]
        print(f"{name}: {t[0] * 1e6:.1f} us  {flops / t[0] / 1e12:.1f} TF/s"
              f"  (groups {t[1] * 1e6:.1f} - {t[2] * 1e6:.1f} us, "
              f"{flops / t[2] / 1e12:.1f} - {flops / t[1] / 1e12:.1f} TF/s)",
              flush=True)
    print(f"int8 speedup vs bf16: {out['bf16'] / out['int8']:.2f}x",
          flush=True)
    return out


def device_rates(ops, flops, iters):
    """The kernel's device time a call (a CUDA graph) in both dtypes."""
    for name, fn in (("bf16", cuda_int8.bf16_matmul),
                     ("int8", cuda_int8.int8_matmul)):
        a, b = ops[name]
        t = device_us(lambda: fn(a, b), iters)
        print(f"{name} device: {t:.1f} us  {flops / t / 1e6:.1f} TF/s",
              flush=True)


def sites(frames: int, plans, iters: int, groups: int,
          with_clocks: bool = False) -> None:
    from grid_vision_tpu_torch import GridVisionConfig
    from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
    dev = torch.device("cuda", 0)
    root = _root()
    cfg = GridVisionConfig(
        detection_weights_file=os.path.join(root, "weights/detector.npz"))
    q = yolov4_int8.quantize_detector(
        weights.load_all(cfg, device=dev)["detector"])
    g = torch.Generator(device=dev).manual_seed(0)
    images = torch.rand((frames, cfg.resize, cfg.resize, 3), generator=g,
                        device=dev)
    calls = {}

    def hook(x, site, layer, stride):
        sx = yolov4_int8.act_scale(x)
        xq = yolov4_int8.quantize_act(x, sx)
        calls[site] = (xq, sx, layer, stride)
        return cuda_int8.int8_conv_requant(xq, sx, layer, stride)

    yolov4_int8._topology(q, images, yolov4_tiny.YoloConfig(
        input_size=cfg.resize), hook)
    names = ["rule"] + [plan_name(p) for p in plans]
    total = dict.fromkeys(names, 0.0)
    bound_sum = 0.0
    device_sum = acc_sum = 0.0
    print("site M K N route tile bound_us by " + " ".join(
        f"us@{w}" for w in names) + " device_us acc_device_us "
        "share_of_bound")
    for site, (xq, sx, layer, stride) in calls.items():
        b, h, w, c = xq.shape
        k = layer["wq"].shape[-1]
        m = b * cuda_int8.out_size(h, stride) * cuda_int8.out_size(w, stride)
        n = layer["wt"].shape[0]
        kk = k * k * c
        if hasattr(cuda_int8, "plan_for"):
            plan = cuda_int8.plan_for(xq, layer["wt"], k, stride)
        else:                             # a tree before the redesign
            plan = argparse.Namespace(route="mma.sync",
                                      tile_n=cuda_int8.tile_n(m, n, kk))
        n_bytes = xq.numel() + layer["wt"].numel() + m * n * 4 + (b + 2 * n) * 4
        t_bytes, t_ops = n_bytes / PEAK_BYTES, 2.0 * m * n * kk / PEAK_INT8
        bound = max(t_bytes, t_ops)
        bound_sum += bound
        row, rule = [], None
        for name, forced in zip(names, [(None, None)] + list(plans)):
            try:
                with (cuda_int8.force_plan(*forced) if any(forced)
                      else contextlib.nullcontext()):
                    if any(forced):       # raises where it cannot
                        cuda_int8.plan_for(xq, layer["wt"], k, stride)
                    t = time_op(lambda: cuda_int8.int8_conv_requant(
                        xq, sx, layer, stride), iters, groups)
            except ValueError:
                row.append("-")
                continue
            rule = rule or t
            total[name] += t[0]
            row.append(us(t))
        dev_us = device_us(lambda: cuda_int8.int8_conv_requant(
            xq, sx, layer, stride), iters)
        acc_us = device_us(lambda: cuda_int8.int8_conv(xq, layer, stride),
                           iters)
        device_sum += dev_us
        acc_sum += acc_us
        if with_clocks:
            c = clocks(lambda: cuda_int8.int8_conv_requant(xq, sx, layer,
                                                           stride))
            print(f"  clocks a tile ({c['tiles']} tiles, {c['blocks']} "
                  "blocks): " + ", ".join(
                      f"{k} {c[k]:.0f}" for k in CLOCK_NAMES), flush=True)
        print(site, m, kk, n, plan.route, plan.tile_n, f"{bound * 1e6:.1f}",
              "bytes" if t_bytes >= t_ops else "ops", " | ".join(row),
              f"{dev_us:.1f}", f"{acc_us:.1f}", f"{bound * 1e6 / dev_us:.3f}",
              flush=True)
    print("sum_ms " + " ".join(f"{w}={total[w] * 1e3:.4f}" for w in names)
          + f" device={device_sum / 1e3:.4f} acc_device={acc_sum / 1e3:.4f}"
          f" bound={bound_sum * 1e3:.4f} "
          f"share={bound_sum * 1e6 / device_sum:.3f}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--k", type=int, default=2304)  # 9 * 256 (3x3 conv)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--plans", default="",
                    help="comma-separated plans to force in turn: BN, "
                    "/route or BN/route")
    ap.add_argument("--sites", action="store_true",
                    help="time the int8 detector's 19 convs instead")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed")
    ap.add_argument("--clocks", action="store_true",
                    help="with --sites: cycles a tile by phase "
                    "(-DGV_INT8_CLOCKS build)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = parse_plans(args.plans)
    if args.sites:
        return sites(args.frames, plans, args.iters, args.groups,
                     args.clocks)
    dev = torch.device("cuda", 0)
    m, k, n = args.m, args.k, args.n
    flops = 2.0 * m * k * n
    ops = operands(m, k, n, dev)
    check(ops)
    kernels = dict(int8=cuda_int8.int8_matmul, bf16=cuda_int8.bf16_matmul)
    if hasattr(cuda_int8, "int8_plan"):
        print(f"kernel (plan s8 {cuda_int8.int8_plan(m, n, k)}, bf16 "
              f"{cuda_int8.int8_plan(m, n, k, size=2)}), M {m} K {k} N {n}",
              flush=True)
    else:
        print(f"kernel (tile_n {cuda_int8.tile_n(m, n, k)}), M {m} K {k} "
              f"N {n}", flush=True)
    rates(kernels, ops, flops, args.iters, args.groups)
    device_rates(ops, flops, args.iters)
    for forced in plans:
        with cuda_int8.force_plan(*forced):
            try:
                check(ops)
            except ValueError as e:
                print(f"kernel, plan {plan_name(forced)}: {e}", flush=True)
                continue
            print(f"kernel, plan forced to {plan_name(forced)}", flush=True)
            rates(kernels, ops, flops, args.iters, args.groups)
            device_rates(ops, flops, args.iters)
    print("library: torch._int_mm / torch.matmul", flush=True)
    rates(dict(int8=torch._int_mm, bf16=torch.matmul), ops, flops,
          args.iters, args.groups)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
