#!/usr/bin/env python3
"""int8 vs bf16 tensor-core rate of the port's GEMM kernel on one NVIDIA
card: the counterpart of tools/bench_int8_mxu.py for
grid_vision_tpu_torch (imports nothing of JAX).

    python3 tools/torch_bench_int8_mma.py [--m 8192] [--k 2304] [--n 256]
        [--iters 16] [--groups 8] [--tile-n 32,64,128]
    python3 tools/torch_bench_int8_mma.py --sites [--frames 64]
        [--tile-n 32,64,128]

The same detector-shaped product as the Pallas tool (an im2col'd 3x3
conv: M the positions, K = 9 * Cin, N = Cout), through the kernel of
csrc/cuda_int8.cu in its two instantiations, ops/cuda_int8.int8_matmul
(s8 x s8 -> s32) and bf16_matmul (bf16 x bf16 -> f32), on the same
operands as the tool (numpy seed 0: integers in [-127, 127) and unit
normals). b is held in the kernel's weight layout (column-major, b.t()
contiguous), as the tool's whole-K kernel keeps its weights resident.
Timing: CUDA events around `iters` back-to-back calls, the median over
`groups` (the tool chains its calls and reads back a scalar). Prints the
tool's lines (`int8: ... us  ... TF/s`, `bf16: ...`, the speedup), then
the same for torch._int_mm and torch.matmul on the same operands (the
library's rates, measured here and used nowhere in the port), and the
card's name and power limit. Each result is held against its plain version
first: s8 bit-equal to int8_matmul_plain and to torch._int_mm, bf16 within
cuda_int8.f32_sum_bound of bf16_matmul_plain (K 2^-24 sum |a||b|, the
bound of any f32 sum of K terms). `--tile-n` times the kernel at each
forced N tile in turn (ops/cuda_int8.tile_n picks one otherwise; bf16 at
most 64).

`--sites`: the int8 detector's 19 convs instead (the shipped weights
quantized, `--frames` random frames at 416, each site's own quantized
input), each timed as the path runs it (int8_conv_requant, the requant
in the epilogue) at the rule's tile and at each forced tile: one line a
site (M, K, N, the rule's tile, us a call at each width) and the sums.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grid_vision_tpu_torch.ops import cuda_int8  # noqa: E402


def time_op(fn, iters: int, groups: int) -> float:
    """Median seconds per call over `groups` runs of `iters` calls."""
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
    return statistics.median(times)


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
        dt = time_op(lambda: named[name](a, b), iters, groups)
        out[name] = dt
        print(f"{name}: {dt * 1e6:.1f} us  {flops / dt / 1e12:.1f} TF/s",
              flush=True)
    print(f"int8 speedup vs bf16: {out['bf16'] / out['int8']:.2f}x",
          flush=True)
    return out


def sites(frames: int, tiles, iters: int, groups: int) -> None:
    from grid_vision_tpu_torch import GridVisionConfig
    from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
    dev = torch.device("cuda", 0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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
    pick = cuda_int8.tile_n
    widths = ["rule"] + [int(t) for t in tiles]
    total = dict.fromkeys(widths, 0.0)
    print("site M K N rule_tile " + " ".join(f"us@{w}" for w in widths))
    for site, (xq, sx, layer, stride) in calls.items():
        b, h, w, c = xq.shape
        k = layer["wq"].shape[-1]
        m = b * cuda_int8.out_size(h, stride) * cuda_int8.out_size(w, stride)
        n = layer["wt"].shape[0]
        row = []
        for t in widths:
            if t != "rule":
                cuda_int8.tile_n = lambda _m, _n, _k, widest=128, t=t: min(
                    t, widest)
            try:
                dt = time_op(lambda: cuda_int8.int8_conv_requant(
                    xq, sx, layer, stride), iters, groups)
            finally:
                cuda_int8.tile_n = pick
            total[t] += dt
            row.append(f"{dt * 1e6:.1f}")
        print(site, m, k * k * c, n, pick(m, n, k * k * c), " ".join(row),
              flush=True)
    print("sum_ms " + " ".join(f"{w}={total[w] * 1e3:.4f}" for w in widths),
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--k", type=int, default=2304)  # 9 * 256 (3x3 conv)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--tile-n", default="",
                    help="comma-separated N tiles to force in turn")
    ap.add_argument("--sites", action="store_true",
                    help="time the int8 detector's 19 convs instead")
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this tool measures the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiles = [t for t in args.tile_n.split(",") if t]
    if args.sites:
        return sites(args.frames, tiles, args.iters, args.groups)
    dev = torch.device("cuda", 0)
    m, k, n = args.m, args.k, args.n
    flops = 2.0 * m * k * n
    ops = operands(m, k, n, dev)
    check(ops)
    kernels = dict(int8=cuda_int8.int8_matmul, bf16=cuda_int8.bf16_matmul)
    print(f"kernel (tile_n {cuda_int8.tile_n(m, n, k)}), M {m} K {k} N {n}",
          flush=True)
    rates(kernels, ops, flops, args.iters, args.groups)
    pick = cuda_int8.tile_n
    try:
        for t in tiles:
            cuda_int8.tile_n = lambda _m, _n, _k, widest=128, t=int(t): min(
                t, widest)
            check(ops)
            print(f"kernel, tile_n forced to {t}", flush=True)
            rates(kernels, ops, flops, args.iters, args.groups)
    finally:
        cuda_int8.tile_n = pick
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
