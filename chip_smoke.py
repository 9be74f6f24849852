#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels stem,knn

Run from the root of a checkout. Imports nothing of JAX or of the JAX
package. With `--kernels` and a list of names (stem, grid, knn, csp, orient,
carve, the bf16 forms stem_bf16, csp_bf16, orient_bf16, int8, and epilogue,
YOLOv4's conv epilogue) it stops after
phase 3 and checks only those: the quick look at a kernel under work; no
device JSON follows. Phases, each printing one line:

1. the card (name and power limit from nvidia-smi); TF32 off;
2. build the kernels of csrc/ (one nvcc per source, in parallel), timed,
   with each kernel's registers, shared memory and spills from ptxas, and
   the stem kernels' dynamic shared memory and blocks per SM;
3. each kernel against its plain torch twin on the card: the single-rig
   path's kernels at its shapes, then the kernels at the fleet path's
   shapes (64 rigs, 320 orientation crops), then the carve kernel and the
   kNN kernel at the extension tick's shapes (a real scan's range profile;
   the depth refine queries all 64 box slots), 1 rig and 64, then the bf16
   forms of the stem (1 frame and 64; one launch, its wgmma product alone
   against a plain product, >= 99.9 % of the elements bit-equal), CSP
   (1 frame and 64 of the bf16 stem's output; one launch, strips of a
   frame through rings of rows, its wgmma products at N = 96 and 64 alone,
   its plan against the wrapper's, its phase clocks from a -DGV_CSP_CLOCKS
   build, >= 99 % bit-equal beside the parent's share) and orientation
   front (5 crops over 1 frame and 320 over 64; one launch, a
   thread-block cluster a crop, its wgmma product alone and its plan
   against the wrapper's, >= 99 % bit-equal) on
   8-bit frames (rtol = atol = 0.06, the share of bit-equal elements, and
   of the others the share the kernel holds nearer zero): max |error|,
   the kernel's time, the twin's time and a PyTorch library yardstick,
   with the least time the card could take; then YOLOv4's conv epilogue
   (check_epilogue: the folded forward at 416 on the seeded recipe, 128
   pool frames in bf16 and 16 in f32: each of the 107 convs' epilogue
   bit-equal to its twin on the same cuDNN output, the raw heads
   bit-equal to the conv-with-bias chain's, then 107 launches a tick in
   EPILOGUE_TICKS fleet ticks of the detector_arch="yolov4" Engine with
   the counter from zero; timed over the forward's outputs against the
   twin and the add + activation chain, bound 2 x the output's bytes);
   then, for the stem, CSP,
   orientation and kNN kernels and the epilogue, their device time per
   call from the profiler (after all host-clock timings: the profiler,
   once used, makes every launch dearer);
4. the single-rig Engine at full width (480x640 frames, detector 416,
   orientation 224 / width 32, 16384 points, 500x200 grid, shipped
   weights) for ENGINE_TICKS ticks of a synthetic scene: the stem, grid
   and kNN counters must advance once per tick, and the outputs must agree
   with the same weights run through the plain-torch backends ("xla");
5. the fleet path (pipeline.fleet_step) in the fleet configuration of
   bench.py in f32 (detector "pallas2", orientation "pallas", 8192 points,
   static compaction to 16) for FLEET_TICKS ticks of 64 rigs of the fleet
   scene pool, orientation budget 320: each of the five kernels must
   launch once per tick, and the outputs must agree with the same fleet
   run through the plain-torch backends; one tick with "pallas3" must
   equal the "pallas2" tick exactly;
6. a torch.profiler breakdown of three fleet ticks on each backend:
   device time by kernel name, launches, the device's idle share; then the
   production bf16 configuration (compute_dtype="bfloat16"): the single-rig
   Engine for BF16_ENGINE_TICKS ticks and the fleet for BF16_FLEET_TICKS
   ticks with the frames in bf16 (FleetPool image_dtype), each against the
   same bf16 configuration on the plain backends (compare_bf16: box
   counts equal but for boxes within 0.02 of the decode's confidence or
   NMS threshold on >= 99 % of rig-ticks, occupancy_i8 >= 99 % on the
   mean, >= 97.5 % at the least over the rigs with no such box); the bf16
   forms must launch once a tick and the f32 forms never;
   the bf16 tick beside the f32 one, a profile of three bf16 fleet ticks
   (`stem_bf16_profile`, `orient_bf16_profile`, `csp_bf16_profile`: the
   bf16 stem's, orientation front's and CSP stage's device time a launch
   and launches a tick; the CSP's also its cycles a step by phase), and the
   cuDNN convs' device time a tick in f32 and bf16 (`library_convs`);
7. the extension-mode tick (compat=False: raycast free-space carving,
   depth refine, class-aware NMS) at full width, the single-rig Engine for
   EXT_ENGINE_TICKS ticks and the fleet (64 rigs, budget 320; the refine
   overrides the static compaction, so the kNN query keeps all 64 slots)
   for EXT_FLEET_TICKS ticks: the carve kernel must launch once per tick
   and the hit-only grid kernel not at all, the share of cells carved per
   tick is printed and must not be zero, and the outputs must agree with
   the same engine on the plain-torch backends; a profile of three
   extension fleet ticks; then a few ticks with yaw-aware rasterization
   (plain torch on every backend) on the card; then the PCA pose branch
   (use_vision_orientation=False; phase `pca`): the single-rig Engine for
   PCA_ENGINE_TICKS ticks, the fleet for PCA_FLEET_TICKS ticks in f32 and
   in bf16, and PCA_EXT_TICKS extension ticks with the carve kernel, each
   against the same configuration on the plain backends, the orientation
   kernel never launched; the PCA stage (plane, association, L-shape) run
   under torch.cuda.set_sync_debug_mode("error"), its device time and
   launches; the PCA fleet run's peak memory (max_memory_allocated, over
   PCA_PEAK_GB fails) and a profile of three PCA fleet ticks; then the
   kernel path at full width against the JAX package's fixture, each mode
   (compat, extension, PCA) in f32 and bf16 (phase `jax_fixture`); then
   the streaming ingest path (phase `stream`, stream_phases): the packed
   wire's sizes, its unpack on the card (bit-equal to the CPU's, no host
   sync), warmup, the link's pageable and pinned bandwidth and plan_wire's
   choice, per-frame packed ticks (host buffers copied by the engine)
   against typed ones, f32 and bf16 (STREAM_TICKS) and extension
   (STREAM_EXT_TICKS), bit-equal, with the stem, CSP, grid (or carve) and
   kNN counters from zero once a tick; free-running ticks through the
   engine's pageable copies and through a pinned staging ring built here
   (PinnedRing, not part of the port); both wires against the
   JAX package's packed ticks (tests/fixtures/stream_wire_jax.npz); the
   ROI-delta and chunked replays bit-equal to the per-frame one, a
   recording played back equal to it, and every replay's rate; then the
   multi-object tracker (phase `tracked`, tracked_phases): Engine.call_tracked
   on the single rig against the plain backends (integer track fields
   equal every tick, compat, PCA and extension), the kernel path against
   the JAX package's tracked ticks (tests/fixtures/tracked_jax.npz), the
   seed-0 MOT replay on the card equal to the CPU's, the fleet's
   rig-batched tracker bit-equal to single-rig calls (f32 and bf16) with a
   forecast every 5th tick, and the tracker's cost (no host sync, device
   time and launches a call, tracked against untracked ticks, the fleet
   forecast's peak memory); then the parallel layer (phase `parallel`,
   parallel_phases: Fleet, its compacted step on one and on two logical
   shards, tracked_step, forecast, run and checkpoints, SharedGrid,
   CityGrid / CityFusion and MultiFleet on per-fleet streams, each against
   Engine.fleet or the plain backends) and the fleet server (phase
   `serve`, serve_phases: FleetServer fed the pool's 8-bit frames through
   the mailboxes, every published grid against Fleet.__call__, the
   kernels once a served tick, served rig-frames/s beside Engine.fleet's,
   the tracked, forecast and hub modes, the `serve` CLI in a subprocess);
then the CLI's last three commands and the TF32 check: phase `bench`
   (bench_phases: a chunk of the port's bench at 64 rigs, at bench.py's
   defaults and with GV_BENCH_STEM=pallas2 GV_BENCH_ORIENT_STEM=pallas,
   its digest and grid bit-equal to the same perturbed Obs through
   Engine.fleet and its kernels once a tick; `python -m
   grid_vision_tpu_torch bench` in both modes with GV_BENCH_BUDGET_S=12,
   their rates beside fleet_bf16's), phase `cli` (cli_phase: `demo` in
   both modes, the net run's last grid equal to replay's; `run
   --publish` then `view --http`: the PNG equal to the session's last
   frame, one /grid.gvd record) and phase `tf32_defaults` (tf32_phase:
   the f32 ticks of a process with torch's default flags bit-equal to
   this process's, and `run --steps 3` under those defaults);
8. a `kernels` JSON line for every ported kernel and form (launches: the
   fleet run's counts, the extension fleet run's for the carve kernel, the
   bf16 fleet run's for the bf16 forms, `launches_pca_fleet`, the PCA
   fleet run's (f32, bf16 for the bf16 forms), and `launches_stream`, the
   per-frame packed run's (f32; bf16 for the bf16 forms; extension for the
   carve kernel), `launches_tracked`, the tracked fleet run's (f32;
   bf16 for the bf16 forms; the tracked extension run's for the carve
   kernel), `launches_served`, the served fleet run's (f32; bf16 for
   the bf16 forms), and `launches_bench`, a bench chunk's (8 ticks) by
   mode; for the
   tensor-core kernels also `bound_3xtf32_ms`, the bound with three TF32
   products per f32 product at the TF32 rate; for them and the kNN kernel
   `device_ms`, their device time per profiled fleet tick, and
   `check_device_ms`, their device time per call at the kernel check's
   shapes; the kNN kernel's other shapes, 64 queries a rig and the single
   rig, under `other_shapes`; the conv epilogue's launches from its
   YOLOv4 fleet ticks, 0 on every YOLOv4-tiny path, its f32 check under
   `f32`), then the card, then the device JSON. Before
   it, a kernel instance that spills registers (ptxas) fails the run.

Any failure exits non-zero. The last line is the device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ENGINE_TICKS = 20
FLEET_TICKS = 10
BF16_ENGINE_TICKS = 10
BF16_FLEET_TICKS = 10
EXT_ENGINE_TICKS = 20
EXT_FLEET_TICKS = 10
YAW_TICKS = 2
PCA_ENGINE_TICKS = 10
PCA_FLEET_TICKS = 5
PCA_EXT_TICKS = 2
PCA_PEAK_GB = 40.0              # half the card: more fails the run
STREAM_TICKS = 20
STREAM_EXT_TICKS = 4
STREAM_REPLAY_TICKS = 16
STREAM_CHUNK = 8
STREAM_RING = 64
STREAM_PAIRS = 10
TRACKED_TICKS = 20
TRACKED_PCA_TICKS = 5
TRACKED_EXT_TICKS = 4
TRACKED_PAIRS = 10
TRACKED_PEAK_GB = 40.0          # half the card: more fails the run
FORECAST_HORIZONS = (0.5, 1.0, 2.0)
PAR_TICKS = 3                   # Fleet / compacted / MultiFleet ticks
PAR_TRACKED_TICKS = 5
PAR_HUB_TICKS = 2
PAR_CITY_TICKS = 2
PAR_RUN_STEPS = 5
PAR_CHUNK = 4
SERVE_TICKS = 6
SERVE_MODE_TICKS = 3
TRAIN_STEPS = 100               # two chunks of TRAIN_SCAN steps a net
TRAIN_SCAN = 50
TRAIN_SCENE_FRAMES = 16
TRAIN_SCENE_CROPS = 32
TRAIN_DET = dict(batch=32, size=416)             # the CLI's defaults
TRAIN_ORI = dict(batch=64, size=224, width=32)   # the shipped net's
TRAIN_TIMED_STEPS = 20
TRAIN_PROFILED_STEPS = 10
TRAIN_TICKS = 3                 # fleet ticks on the trained weights
EVAL_SYNTH = 50                 # tests/test_eval_map.py:101-115
EVAL_SCENE = 64
FLEET_KERNELS = ("detector_stem", "detector_csp", "orient_front",
                 "grid_update", "knn_median_depth")
BF16_KERNELS = ("detector_stem_bf16", "detector_csp_bf16",
                "orient_front_bf16", "grid_update", "knn_median_depth")


N_RIGS = 64
BUDGET = 5 * N_RIGS            # bench.py:206
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
PEAK_TF32_PER_S = 495e12       # H100 SXM TF32 tensor cores, dense
PEAK_BF16_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
PEAK_INT8_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
BF16_TOL = dict(rtol=0.06, atol=0.06)   # tests/test_pallas_orient.py:59-62


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(kind: str, **fields) -> None:
    print(json.dumps({"phase": kind, **fields}), flush=True)


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_bf16_ms(n_bytes: float, n_ops: float):
    """The bound of a bf16 form: bytes, or operations at the bf16 tensor
    cores' rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_int8_ms(n_bytes: float, n_ops: float):
    """The bound of an int8 form: bytes, or operations at the int8 tensor
    cores' rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_INT8_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tapped_frame_bytes(torch, images, xyxy, valid, rig, size):
    """The bytes of the frame pixels that the valid crops' bilinear taps of
    nonzero weight read, each pixel once however many crops tap it: what
    the orientation front must read of its frames."""
    from grid_vision_tpu_torch.ops import preprocess
    r, h, w, c = images.shape
    keep = valid.nonzero().squeeze(1)
    (ylo, yhi, fy), (xlo, xhi, fx) = preprocess.box_axis_samples(
        xyxy[keep], h, w, size)

    def hit(lo, hi, frac, length):
        out = torch.zeros((lo.shape[0], length), device=lo.device)
        out.scatter_(1, lo, 1.0)
        return out.scatter_(1, torch.where(frac > 0, hi, lo), 1.0)

    seen = torch.zeros((r, h, w), device=images.device)
    seen.index_add_(0, rig[keep].long(), hit(ylo, yhi, fy, h)[:, :, None]
                    * hit(xlo, xhi, fx, w)[:, None, :])
    return int(seen.count_nonzero()) * c * images.element_size()


def bf16_agreement(torch, what, got, ref):
    """A bf16 form against its twin: both bf16, allclose at the JAX
    package's bf16 kernel bar (BF16_TOL); returns (max |error|, share of
    bit-equal elements, and of the unequal ones the share the kernel holds
    nearer zero: ~0.5 unless the tensor core's truncating accumulator
    biases the sums)."""
    if got.dtype != torch.bfloat16 or ref.dtype != torch.bfloat16:
        fail(f"{what}: the bf16 form or its twin is not bf16")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{what}: the bf16 form's output is not finite")
    if not torch.allclose(g, r, **BF16_TOL):
        fail(f"{what}: the bf16 form disagrees with its twin: max |d| "
             f"{(g - r).abs().max().item()}")
    differ = g != r
    toward_zero = ((g.abs() < r.abs()) & differ).sum().item() / max(
        int(differ.sum()), 1)
    return ((g - r).abs().max().item(), (g == r).float().mean().item(),
            toward_zero)


def bound_3xtf32_ms(n_bytes: float, n_ops: float) -> float:
    """The bound of a kernel whose products run in 3xTF32 (three TF32
    tensor-core products per f32 product): bytes, or 3 x operations at the
    TF32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S,
               3.0 * n_ops / PEAK_TF32_PER_S) * 1e3


def ptxas_summary(log: str):
    """nvcc -Xptxas=-v output -> one "registers / shared memory / spills"
    line per kernel (a template instance named by its operand type, bf16 or
    f32, and its integer arguments)."""
    out, name, spills = [], "", ""
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            short = re.search(r"gv_[a-z0-9_]+_kernel", name)
            if short:
                rest = name[short.end():]
                args = re.findall(r"Li(\d+)E", rest)
                kind = ("bf16" if "bfloat16" in rest
                        else "f32" if rest.startswith("If")
                        else "s8" if rest.startswith("Ia") else "")
                name = short.group(0) + (
                    f"<{','.join([kind] + args) if kind else ','.join(args)}>"
                    if kind or args else "")
        elif "spill" in ln:
            spills = ln
        elif re.search(r"Used \d+ registers", ln):
            # (not the notes that mention registers, e.g. ptxas' C7519
            # "warpgroup.arrive is injected ... to allow use of registers")
            out.append(f"{name}: {ln.replace('ptxas info    : ', '')}; "
                       f"{spills}")
    return out


def timed(fn, plain, library, iters: int = 50):
    """Kernel, plain twin and library yardstick times (ms), interleaved."""
    return dict(ms=cuda_time_ms(fn, iters),
                plain_ms=cuda_time_ms(plain, max(5, iters // 5)),
                library_ms=(None if library is None
                            else cuda_time_ms(library, iters)))


def port_device_ms(torch, fn, iters: int = 5) -> float:
    """Device time per call of fn() spent in the kernels of csrc/ (named
    gv_*), from torch.profiler: the call's time without its wrapper and
    launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if "gv_" in e.name) / 1e3 / iters


def check_stem(torch, dev, detector, cfg, batch):
    """Fused resize + ConvBN_0 + ConvBN_1 at 480x640 -> 416 -> 104."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import same_pad
    from grid_vision_tpu_torch.ops import cuda_stem, preprocess
    g = torch.Generator(device=dev).manual_seed(1)
    h, w, size = cfg.camera_image_height, cfg.camera_image_width, cfg.resize
    img = torch.rand((batch, h, w, 3), generator=g, device=dev) * 255.0
    consts = cuda_stem.prepare_stem_constants(detector)
    got = cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    ref = cuda_stem.detector_stem_plain(img, consts, size)
    torch.cuda.synchronize()
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4):
        fail(f"stem kernel disagrees with its twin: max |d| "
             f"{(got - ref).abs().max().item()}")
    # library yardstick: resize matmuls + cuDNN convs with BN folded in
    wb0 = consts["w0_oihw"] * consts["s0"][:, None, None, None]
    wb1 = consts["w1_oihw"] * consts["s1"][:, None, None, None]

    def library():
        x = torch.stack([preprocess.preprocess_detector_image(im, size)
                         for im in img]).permute(0, 3, 1, 2)
        for wt, b in ((wb0, consts["b0"]), (wb1, consts["b1"])):
            p = same_pad(x.shape[2], 3, 2)
            x = F.leaky_relu(F.conv2d(F.pad(x, (p[0], p[1], p[0], p[1])),
                                      wt, b, stride=2), 0.1)
        return x

    lib = library().permute(0, 2, 3, 1)
    if not torch.allclose(lib, ref, rtol=1e-4, atol=1e-4):
        fail("stem library yardstick disagrees with the twin")
    _, ty = cuda_stem.resize_taps(h, size)
    _, tx = cuda_stem.resize_taps(w, size)
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    ops = batch * (2 * h * size * 3 * tx.shape[1]
                   + 2 * size * size * 3 * ty.shape[1]
                   + 2 * s0 * s0 * 32 * 27 + 2 * s1 * s1 * 64 * 288)
    n_bytes = (img.numel() + got.numel() + 27 * 32 + 288 * 64 + 192) * 4
    t = timed(lambda: cuda_stem.detector_stem_cuda(img, consts, size),
              lambda: cuda_stem.detector_stem_plain(img, consts, size),
              library)
    return dict(
        call=lambda: cuda_stem.detector_stem_cuda(img, consts, size),
        name="detector_stem", source="grid_vision_tpu_torch/csrc/cuda_stem.cu",
        replaces="grid_vision_tpu/ops/pallas_stem.py:359", shape=list(
            img.shape),
        max_abs_err=(got - ref).abs().max().item(), **t,
        bound=bound_ms(n_bytes, ops),
        bound_3xtf32_ms=bound_3xtf32_ms(n_bytes, ops))


def frames_bf16(torch, dev, cfg, batch, seed):
    """Random 8-bit frames (integers in [0, 255], exact in bf16) as
    (batch, H, W, 3) bf16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, (batch, cfg.camera_image_height,
                                  cfg.camera_image_width, 3), generator=g,
                         device=dev).to(torch.bfloat16)


def check_stem_bf16(torch, dev, detector, cfg, batch):
    """The stem's bf16 form (one launch, both convs on the tensor cores,
    ConvBN_1 on wgmma) on 8-bit frames against its twin, with >= 99.9 % of
    the elements bit-equal; its wgmma product alone against
    bf16mma.matmul_bf16 (the B layout); yardstick: the same chain in bf16
    library calls (bf16 resize einsums, cuDNN bf16 F.conv2d with the BN
    folded in, leaky)."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import same_pad
    from grid_vision_tpu_torch.ops import (bf16mma, cuda_orient, cuda_stem,
                                           preprocess)
    g = torch.Generator(device=dev).manual_seed(10)
    a = torch.randn((128, 288), generator=g, device=dev)
    b = torch.randn((288, 64), generator=g, device=dev)
    prod = cuda_orient.wgmma_product_bf16_cuda(a, b)
    torch.cuda.synchronize()
    prod_err = (prod - bf16mma.matmul_bf16(a, b)).abs().max().item()
    if prod_err > 1e-3:
        fail(f"the bf16 stem's wgmma product is off by {prod_err}")
    img = frames_bf16(torch, dev, cfg, batch, 11)
    size = cfg.resize
    consts = cuda_stem.prepare_stem_constants(detector, torch.bfloat16)
    got = cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    ref = cuda_stem.detector_stem_plain(img, consts, size)
    err, equal, toward = bf16_agreement(torch, "stem", got, ref)
    if equal < 0.999:
        fail(f"the bf16 stem is bit-equal to its twin on only {equal:.5f} "
             "of the elements (bar 0.999)")
    bf = torch.bfloat16
    wb = [(consts[f"w{i}_oihw"].float() * consts[f"s{i}"][:, None, None,
                                                           None]).to(bf)
          for i in (0, 1)]
    bb = [consts[f"b{i}"].to(bf) for i in (0, 1)]

    def library():
        x = torch.stack([preprocess.preprocess_detector_image(im, size, bf)
                         for im in img]).permute(0, 3, 1, 2)
        for wt, b in zip(wb, bb):
            p = same_pad(x.shape[2], 3, 2)
            x = F.leaky_relu(F.conv2d(F.pad(x, (p[0], p[1], p[0], p[1])),
                                      wt, b, stride=2), 0.1)
        return x

    lib_err = (library().permute(0, 2, 3, 1).float()
               - ref.float()).abs().max().item()
    h, w = cfg.camera_image_height, cfg.camera_image_width
    _, ty = cuda_stem.resize_taps(h, size)
    _, tx = cuda_stem.resize_taps(w, size)
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    ops = batch * (2 * h * size * 3 * tx.shape[1]
                   + 2 * size * size * 3 * ty.shape[1]
                   + 2 * s0 * s0 * 32 * 27 + 2 * s1 * s1 * 64 * 288)
    n_bytes = (img.numel() + got.numel()) * 2 + 192 * 4 + \
        (32 * 32 + 288 * 64) * 2
    t = timed(lambda: cuda_stem.detector_stem_cuda(img, consts, size),
              lambda: cuda_stem.detector_stem_plain(img, consts, size),
              library)
    return dict(
        call=lambda: cuda_stem.detector_stem_cuda(img, consts, size),
        name="detector_stem_bf16",
        source="grid_vision_tpu_torch/csrc/cuda_stem_bf16.cu",
        wgmma_product_max_abs_err=prod_err,
        replaces="grid_vision_tpu/ops/pallas_stem.py:359",
        shape=list(img.shape), max_abs_err=err, bit_equal_share=equal,
        toward_zero_share=toward,
        library_max_abs_err=lib_err, **t, bound=bound_bf16_ms(n_bytes, ops))


# The bit-equal share the four-launch design (y and concat[x2, x1] through
# device memory, mma.sync) reached at 64 frames on an H100, printed beside
# the one-launch kernel's.
CSP_BF16_PARENT_BIT_EQUAL = 0.99357
CSP_CLOCKS = ("cuda_csp_bf16", ("GV_CSP_CLOCKS",))


def csp_design_macs(cuda_csp, plan, ho) -> int:
    """The multiply-adds the bf16 CSP kernel computes: every unit's steps
    at all 64 positions of two rows (junk columns and lead rows included:
    ConvBN_2 and conv a every step, conv b from the second, the 1x1 from
    the third; conv a and b take a row against its three dy taps, K = 96,
    N = 96)."""
    total = 0
    for u in range(plan.units):
        _, _, s0, s1 = cuda_csp.csp_bf16_unit(plan, u, ho)
        steps = s1 - s0 + cuda_csp.LEAD_STEPS
        total += 2 * cuda_csp.PITCH * (
            steps * (576 * 64 + 96 * 96) + (steps - 1) * 96 * 96
            + (steps - 2) * 64 * 64)
    return total


def check_csp_bf16(torch, dev, detector, cfg, batch):
    """The CSP stage's bf16 form (one launch of csrc/cuda_csp_bf16.cu) on
    the bf16 stem's output of 8-bit frames against its twin, >= 99 % of
    the elements bit-equal (the parent's share beside); its wgmma products
    alone at N = 96 and 64 against a plain product; its plan against the
    wrapper's; the phase clocks of a -DGV_CSP_CLOCKS build; yardstick: the
    same chain of cuDNN bf16 F.conv2d calls (BN folded in), leaky,
    concats, max_pool2d. The bound counts the useful operations and the
    compulsory bytes; the operations the design computes (junk columns,
    lead rows) stand beside it."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.ops import (bf16mma, cuda_build, cuda_csp,
                                           cuda_orient, cuda_stem)
    g = torch.Generator(device=dev).manual_seed(12)
    prod_err = 0.0
    for k, n in ((96, 96), (576, 64)):
        a = torch.randn((128, k), generator=g, device=dev)
        b = torch.randn((k, n), generator=g, device=dev)
        prod = cuda_orient.wgmma_product_bf16_cuda(a, b)
        torch.cuda.synchronize()
        prod_err = max(prod_err, (prod - bf16mma.matmul_bf16(a, b)).abs()
                       .max().item())
    if prod_err > 1e-3:
        fail(f"the bf16 CSP's wgmma product is off by {prod_err}")
    img = frames_bf16(torch, dev, cfg, batch, 13)
    x = cuda_stem.detector_stem_cuda(
        img, cuda_stem.prepare_stem_constants(detector, torch.bfloat16),
        cfg.resize)
    del img
    consts = cuda_csp.prepare_csp_constants(detector, torch.bfloat16)
    got = cuda_csp.detector_csp_cuda(x, detector, consts)
    torch.cuda.synchronize()
    ref = cuda_csp.detector_csp_plain(x, detector, consts)
    err, equal, toward = bf16_agreement(torch, "CSP", got, ref)
    if equal < 0.99:
        fail(f"the bf16 CSP stage is bit-equal to its twin on only "
             f"{equal:.5f} of the elements (bar 0.99)")
    _, h, w, _ = x.shape
    sms, on_card = cuda_csp.bf16_plan_on_card(batch, h, w)
    plan = cuda_csp.csp_bf16_plan(batch, h, w, sms)
    if on_card[:4] != tuple(plan) or on_card[5] < 1:
        fail(f"the bf16 CSP kernel's plan {on_card} is not the wrapper's "
             f"{tuple(plan)} or is not resident")
    bf = torch.bfloat16
    wt = {k: (consts[f"w{k}_oihw"].float()
              * consts[f"s{k}"][:, None, None, None]).to(bf)
          for k in ("2", "a", "b", "c")}
    bt = {k: consts[f"b{k}"].to(bf) for k in ("2", "a", "b", "c")}

    def library():
        y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), wt["2"], bt["2"],
                                  padding=1), 0.1)
        x1 = F.leaky_relu(F.conv2d(y[:, 32:], wt["a"], bt["a"], padding=1),
                          0.1)
        x2 = F.leaky_relu(F.conv2d(x1, wt["b"], bt["b"], padding=1), 0.1)
        x3 = F.leaky_relu(F.conv2d(torch.cat([x2, x1], 1), wt["c"], bt["c"]),
                          0.1)
        return F.max_pool2d(torch.cat([y, x3], 1), 2, 2)

    with torch.no_grad():
        lib_err = (library().permute(0, 2, 3, 1).float()
                   - ref.float()).abs().max().item()
    macs = h * w * (64 * 576 + 2 * 32 * 288 + 64 * 64)
    ops = batch * 2 * macs
    design_ops = 2 * csp_design_macs(cuda_csp, plan, h // 2)
    n_bytes = (x.numel() + got.numel()) * 2 + \
        (576 * 64 + 2 * 288 * 32 + 64 * 64) * 2 + 2 * 2 * 192 * 4

    def call():
        return cuda_csp.detector_csp_cuda(x, detector, consts)

    with torch.no_grad():
        t = timed(call,
                  lambda: cuda_csp.detector_csp_plain(x, detector, consts),
                  library, iters=20)
        # the phase clocks: the -DGV_CSP_CLOCKS build in the plain one's
        # place for a few calls
        key = (CSP_CLOCKS[0], ())
        plain_lib = cuda_build.load(CSP_CLOCKS[0])
        cuda_build._libs[key] = cuda_build.load(*CSP_CLOCKS)
        cuda_csp._entry_bf16.cache_clear()
        try:
            clocks = cuda_csp.csp_bf16_clocks(cuda_build._libs[key], call)
        finally:
            cuda_build._libs[key] = plain_lib
            cuda_csp._entry_bf16.cache_clear()
    return dict(
        call=call, name="detector_csp_bf16",
        source="grid_vision_tpu_torch/csrc/cuda_csp_bf16.cu",
        replaces="grid_vision_tpu/ops/pallas_csp.py:404",
        also_replaces="grid_vision_tpu/ops/pallas_csp.py:343",
        shape=list(x.shape), max_abs_err=err, bit_equal_share=equal,
        parent_bit_equal_share_fleet=CSP_BF16_PARENT_BIT_EQUAL,
        toward_zero_share=toward, wgmma_product_max_abs_err=prod_err,
        plan=dict(zip(("strips", "bands", "rows", "units", "shared_bytes",
                       "blocks_per_sm"), on_card), sms=sms),
        design_gflop=design_ops / 1e9, useful_gflop=ops / 1e9,
        design_junk_share=1.0 - ops / design_ops, clocks=clocks,
        library_max_abs_err=lib_err, **t, bound=bound_bf16_ms(n_bytes, ops))


YOLOV4_CONVS = 107              # ConvBN convs a YOLOv4 forward (72 Mish)
EPILOGUE_TICKS = 2              # YOLOv4 fleet ticks on the main path


def check_epilogue(torch, dev, root, fleet_cfg, extrinsics, obs_seq, dtype,
                   batch):
    """The conv epilogue (csrc/cuda_conv_epilogue.cu, ops/cuda_epilogue)
    on YOLOv4's folded forward at the fleet's input size (416) on the
    seeded recipe, in `dtype`,
    `batch` frames of the fleet pool (obs_seq's, through the detector's
    resize): each of the 107 ConvBN convs' output through the kernel
    bit-equal to bias_act_plain on the same cuDNN output, and the three
    raw heads bit-equal to those of the conv with its bias and the
    activation after (the chain the kernel replaced); then the main path,
    counter from zero: EPILOGUE_TICKS fleet ticks of N_RIGS rigs on the
    detector_arch="yolov4" Engine, 107 launches a tick. Times over the
    forward's 107 outputs: the kernel, its twin (in place) and as library
    the chain it replaced (ATen's add of the bias, then F.mish or
    F.leaky_relu); the bound: each output read and written once."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.device import ieee_convs
    from grid_vision_tpu_torch.models import yolov4
    from grid_vision_tpu_torch.ops import cuda_epilogue, preprocess
    ycfg = dataclasses.replace(
        fleet_cfg, detector_arch="yolov4", detector_stem_backend="xla",
        compute_dtype=("bfloat16" if dtype == torch.bfloat16
                       else "float32"),
        detection_weights_file="weights/yolov4_seeded.npz")
    eng = pipeline.Engine(ycfg, extrinsics=extrinsics, device=dev,
                          base_dir=root)
    model = eng.params["detector"]
    folded = eng.params[pipeline._consts_key("detector_folded", dtype)]
    images = torch.cat([o.image for o in obs_seq])[:batch]
    if images.shape[0] != batch:
        fail(f"the epilogue check needs {batch} frames")
    x = torch.stack([preprocess.preprocess_detector_image(
        im, ycfg.resize, dtype) for im in images])
    del images
    outs = []                 # (cuDNN's output, bias, act) of each conv
    unequal = []
    own_conv = yolov4.YoloV4._conv

    def checked_conv(self, l, x, folded):
        w, b = folded[l.name]
        y = F.conv2d(x, w, None, l.stride, l.size // 2)
        outs.append((y.clone(), b, l.act))
        want = cuda_epilogue.bias_act_plain(y.clone(), b, l.act)
        got = cuda_epilogue.bias_act(y, b, l.act)
        if not torch.equal(got, want):
            unequal.append(l.name)
        return got

    def chain_conv(self, l, x, folded):
        w, b = folded[l.name]
        y = F.conv2d(x, w, b, l.stride, l.size // 2)
        return F.mish(y) if l.act == "mish" else F.leaky_relu(y, 0.1)

    def heads(conv):
        yolov4.YoloV4._conv = conv
        try:
            with torch.no_grad(), ieee_convs():
                out = model.heads(model.features(x, folded), folded)
            torch.cuda.synchronize()
            return out
        finally:
            yolov4.YoloV4._conv = own_conv

    got = heads(checked_conv)
    if len(outs) != YOLOV4_CONVS or unequal:
        fail(f"conv epilogue ({dtype}, {batch} frames): {len(outs)} convs, "
             f"not bit-equal to bias_act_plain at {unequal}")
    want = heads(chain_conv)
    for name, g, w in zip(("52", "26", "13"), got, want):
        if not torch.equal(g, w):
            fail(f"conv epilogue ({dtype}): head {name} differs from the "
                 f"chain's by {(g - w).abs().max().item()}")
    del got, want, x
    # the main path: the fleet tick of the YOLOv4 Engine
    cuda_epilogue.launches = 0
    states = eng.init_states(N_RIGS)
    with torch.no_grad():
        for o in obs_seq[:EPILOGUE_TICKS]:
            states, _ = eng.fleet(states, o, BUDGET)
    torch.cuda.synchronize()
    main_launches = cuda_epilogue.launches
    if main_launches != YOLOV4_CONVS * EPILOGUE_TICKS:
        fail(f"conv epilogue ({dtype}): {main_launches} launches in "
             f"{EPILOGUE_TICKS} YOLOv4 fleet ticks, expected "
             f"{YOLOV4_CONVS} a tick")
    del eng, states

    def call():
        for y, b, act in outs:
            cuda_epilogue.bias_act(y, b, act)

    def plain():
        for y, b, act in outs:
            cuda_epilogue.bias_act_plain(y, b, act)

    def library():
        for y, b, act in outs:
            s = y + b.view(1, -1, 1, 1)
            F.mish(s) if act == "mish" else F.leaky_relu(s, 0.1)

    with torch.no_grad():
        t = timed(call, plain, library, iters=10)
    n_bytes = 2 * sum(y.numel() * y.element_size() for y, _, _ in outs)
    return dict(
        call=call, name="conv_epilogue",
        source="grid_vision_tpu_torch/csrc/cuda_conv_epilogue.cu",
        replaces="none (YOLOv4 has no JAX twin): ATen's add_ of the bias "
                 "and F.mish / F.leaky_relu after each ConvBN conv",
        dtype=str(dtype).replace("torch.", ""),
        shape=[batch, 3, ycfg.resize, ycfg.resize],
        frames=batch, convs=len(outs), bit_equal_convs=len(outs),
        heads_bit_equal=True, max_abs_err=0.0, output_gb=n_bytes / 2e9,
        launches_main_path=main_launches, main_path_ticks=EPILOGUE_TICKS,
        main_path_rigs=N_RIGS, **t,
        bound=(n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes"))


# The bit-equal share the two-launch design (the crop through device
# memory) reached at the fleet shapes on an H100, printed beside the
# one-launch kernel's.
ORIENT_BF16_PARENT_BIT_EQUAL = 0.99856


def check_orient_bf16(torch, dev, net, cfg, rigs, n_crops):
    """The orientation front's bf16 form (one launch of
    csrc/cuda_orient_bf16.cu): n_crops boxes over `rigs` 8-bit frames
    (clamped, invalid and sliver boxes among them) against its twin, >= 99 %
    of the elements bit-equal; its wgmma product alone against a plain
    product (the B layout, 128 channels a product); its plan against the
    wrapper's mirror; yardstick: bf16 crop_resize einsums + the bf16
    standardize + a cuDNN bf16 F.conv2d with the BN folded in."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import same_pad
    from grid_vision_tpu_torch.ops import bf16mma, cuda_orient, preprocess
    g = torch.Generator(device=dev).manual_seed(14)
    a = torch.randn((128, 432), generator=g, device=dev)
    b = torch.randn((432, 128), generator=g, device=dev)
    prod = cuda_orient.wgmma_product_bf16_cuda(a, b)
    torch.cuda.synchronize()
    prod_err = (prod - bf16mma.matmul_bf16(a, b)).abs().max().item()
    if prod_err > 1e-3:
        fail(f"the bf16 orientation wgmma product is off by {prod_err}")
    h, w, size = (cfg.camera_image_height, cfg.camera_image_width,
                  cfg.network_height)
    images = frames_bf16(torch, dev, cfg, rigs, 15)
    u = torch.rand((n_crops, 4), generator=g, device=dev)
    x0 = u[:, 0] * (w + 60) - 40
    y0 = u[:, 1] * (h + 60) - 40
    xyxy = torch.stack([x0, y0, x0 + 8 + u[:, 2] * 300,
                        y0 + 8 + u[:, 3] * 250], dim=-1)
    xyxy[0] = torch.tensor([100.0, 100.0, 100.4, 100.4])    # sliver: flat
    valid = torch.rand((n_crops,), generator=g, device=dev) > 0.1
    valid[0] = True
    rig = torch.sort(torch.randint(0, rigs, (n_crops,), generator=g,
                                   device=dev)).values
    consts = cuda_orient.prepare_orient_constants(net, torch.bfloat16)
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, size)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             size, consts)
        # flat crops (any channel's std < 1 grey level) are ill-conditioned
        # (ROADMAP C): held to finiteness only
        flat = cuda_orient.crops_by_rig(images, xyxy, rig, size).std(
            dim=(1, 2)).amin(dim=-1) < 1.0
    keep = ~flat
    if not torch.isfinite(got.float()).all():
        fail("orientation-front bf16 output is not finite")
    err, equal, toward = bf16_agreement(torch, "orientation front", got[keep],
                                        ref[keep])
    if equal < 0.99:
        fail(f"the bf16 orientation front is bit-equal to its twin on only "
             f"{equal:.5f} of the elements (bar 0.99)")
    plan = cuda_orient.bf16_plan_on_card(size, got.shape[3])
    if plan[:6] != cuda_orient.orient_bf16_plan(size, got.shape[3]):
        fail(f"the bf16 orientation kernel's plan {plan[:6]} is not the "
             "wrapper's")
    bf = torch.bfloat16
    wt = (consts["w_oihw"].float() * consts["s"][:, None, None, None]).to(bf)
    bt = consts["t"].to(bf)
    lo, hi = (4 * p for p in same_pad(size // 4, 3, 2))

    def library():
        c = cuda_orient.crops_by_rig(images, xyxy, rig, size, bf)
        std = preprocess._standardize(c, valid).permute(0, 3, 1, 2)
        return F.relu(F.conv2d(F.pad(std, (lo, hi, lo, hi)), wt, bt,
                               stride=8))

    with torch.no_grad():
        lib = library().permute(0, 2, 3, 1)
        lib_err = (lib[keep].float() - ref[keep].float()).abs().max().item()
        t = timed(lambda: cuda_orient.orient_front_cuda(
            images, xyxy, valid, rig, net, consts, size),
            lambda: cuda_orient.orient_front_plain(
                images, xyxy, valid, rig, net, size, consts), library,
            iters=20)
    n_valid = int(valid.sum())
    q, f = got.shape[1], got.shape[3]
    ops = n_valid * (2 * q * q * f * 12 * 12 * 3 + size * size * 3 * 10)
    frame_bytes = tapped_frame_bytes(torch, images, xyxy, valid, rig, size)
    n_bytes = frame_bytes + (got.numel() + 432 * f) * 2 + \
        xyxy.numel() * 4 + 2 * f * 4 + 2 * n_crops
    return dict(
        call=lambda: cuda_orient.orient_front_cuda(
            images, xyxy, valid, rig, net, consts, size),
        name="orient_front_bf16",
        source="grid_vision_tpu_torch/csrc/cuda_orient_bf16.cu",
        replaces="grid_vision_tpu/ops/pallas_orient.py:288",
        shape=[n_crops, size, size, 3], frames=rigs, crops_valid=n_valid,
        frame_bytes_tapped=frame_bytes, crops_flat_left_out=int(flat.sum()),
        max_abs_err=err,
        bit_equal_share=equal,
        parent_bit_equal_share_fleet=ORIENT_BF16_PARENT_BIT_EQUAL,
        toward_zero_share=toward, wgmma_product_max_abs_err=prod_err,
        plan=dict(zip(("cluster", "rows", "crop_rows", "stride",
                       "buf_rows", "shared_bytes", "resident_clusters"),
                      plan)),
        library_max_abs_err=lib_err, **t, bound=bound_bf16_ms(n_bytes, ops))


def check_int8(torch, dev, detector, cfg, batch, images=None,
               timing=True):
    """The int8 conv kernel (csrc/cuda_int8.cu) at the 19 conv sites of an
    int8 forward (models/yolov4_int8.py, the shipped weights quantized) on
    `batch` frames at cfg.resize (random in [0, 1] unless `images` are
    given): every site's accumulators (mode acc) bit-equal to the f64 conv,
    its fused f32 output (mode requant, as the path runs it) bit-equal to
    requant of them, and the library yardstick (tap_matrix + torch._int_mm
    + requant) equal too. Per site always: the plan (ops/cuda_int8.plan_for:
    route and N tile) and the bound (the int8 in, the weights, the f32 out
    at 3.35 TB/s, or 2 M N K operations at the int8 peak). With `timing`,
    per site and summed over a forward: the kernel's ms (requant mode) and
    its share of the bound, the acc mode's, the plain version's (f64 conv +
    requant), the library's, _int_mm's alone; timing="kernel" times the
    kernel alone."""
    from grid_vision_tpu_torch.models import yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops import cuda_int8
    q = yolov4_int8.quantize_detector(detector)
    size = cfg.resize
    ycfg = yolov4_tiny.YoloConfig(input_size=size)
    if images is None:
        g = torch.Generator(device=dev).manual_seed(8)
        images = torch.rand((batch, size, size, 3), generator=g, device=dev)
    sites, err = {}, 0.0

    def hook(x, site, layer, stride):
        nonlocal err
        sx = yolov4_int8.act_scale(x)
        xq = yolov4_int8.quantize_act(x, sx)
        k, kp = layer["wq"].shape[-1], layer["wt"].shape[1]
        acc = cuda_int8.int8_conv(xq, layer, stride)
        ref = cuda_int8.int8_conv_plain(xq, layer["wq"], stride)
        if acc.dtype != torch.int32 or not torch.equal(acc, ref):
            fail(f"int8 {site}: the kernel's accumulators differ from the "
                 "f64 conv")
        y = cuda_int8.int8_conv_requant(xq, sx, layer, stride)
        y_ref = cuda_int8.requant(ref, sx, layer)
        if not torch.equal(y, y_ref):
            fail(f"int8 {site}: the kernel's requant differs from requant")
        err = max(err, (y - y_ref).abs().max().item())
        wt = layer["wt"].t()

        def library():
            a = yolov4_int8.tap_matrix(xq, k, stride, kp)
            return cuda_int8.requant(torch._int_mm(a, wt).view(acc.shape),
                                     sx, layer)

        if not torch.equal(library(), y_ref):
            fail(f"int8 {site}: the library yardstick differs")
        b, ho, wo, n = acc.shape
        m, kk = b * ho * wo, k * k * xq.shape[-1]
        n_bytes = xq.numel() + layer["wt"].numel() + y.numel() * 4 \
            + (b + 2 * n) * 4
        plan = cuda_int8.plan_for(xq, layer["wt"], k, stride)
        row = dict(m=m, k=kk, n=n, kernel=k, stride=stride,
                   route=plan.route, tile_n=plan.tile_n, tiles=plan.tiles,
                   blocks=plan.blocks, max_abs_acc=int(acc.abs().max()),
                   bytes=n_bytes, ops=2 * m * n * kk)
        row["bound_ms"], row["bound_by"] = bound_int8_ms(n_bytes, row["ops"])
        if timing == "kernel":
            row["ms"] = cuda_time_ms(
                lambda: cuda_int8.int8_conv_requant(xq, sx, layer, stride),
                10, 2)
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        elif timing:
            a = yolov4_int8.tap_matrix(xq, k, stride, kp)
            row.update(timed(
                lambda: cuda_int8.int8_conv_requant(xq, sx, layer, stride),
                lambda: cuda_int8.int8_conv_requant_plain(xq, sx, layer,
                                                          stride),
                library, iters=10))
            row.update(
                acc_ms=cuda_time_ms(
                    lambda: cuda_int8.int8_conv(xq, layer, stride), 10, 2),
                gemm_ms=cuda_time_ms(lambda: torch._int_mm(a, wt), 10, 2))
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        sites[site] = row
        return y

    yolov4_int8._topology(q, images, ycfg, hook)
    if sorted(sites) != sorted(yolov4_int8.LAYERS):
        fail(f"int8: sites {sorted(sites)}")
    total = {key: sum(r[key] for r in sites.values())
             for key in ("bytes", "ops", "bound_ms") + (
                 ("ms",) if timing == "kernel" else
                 ("ms", "plain_ms", "library_ms", "acc_ms", "gemm_ms")
                 if timing else ())}
    total["sites_bound_ms"] = total.pop("bound_ms")
    return dict(
        call=lambda: yolov4_int8.forward_int8(q, images, ycfg),
        name="int8_conv", source="grid_vision_tpu_torch/csrc/cuda_int8.cu",
        replaces="tools/bench_int8_mxu.py:42",
        also_replaces="tools/bench_int8_mxu.py:58",
        shape=list(images.shape), max_abs_err=err, sites=sites, **total,
        bound=bound_int8_ms(total["bytes"], total["ops"]))


def random_grid_case(torch, dev, cfg, rigs, seed):
    """Random log-odds in the clamp range and max_orientation_batch random
    footprints a rig, some off the map; rigs=None is one (H, W) grid.
    Returns (log_odds, box index ranges)."""
    from grid_vision_tpu_torch.ops import cuda_grid
    from grid_vision_tpu_torch.types import LShapePoses
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = cfg.grid_size
    lead = () if rigs is None else (rigs,)
    lo = torch.rand(lead + (h, w), generator=g, device=dev) * 5.6 - 2.0
    n = cfg.max_orientation_batch
    u = torch.rand(lead + (n, 4), generator=g, device=dev)
    empty = LShapePoses.empty(n, device=dev)
    poses = dataclasses.replace(
        empty,
        position=torch.stack([u[..., 0] * 60 - 15, u[..., 1] * 30 - 15,
                              torch.zeros_like(u[..., 0])], dim=-1),
        length=u[..., 2] * 6 + 0.3, width=u[..., 3] * 3 + 0.3,
        valid=torch.ones(lead + (n,), dtype=torch.bool, device=dev))
    return lo, cuda_grid.box_index_ranges(poses, cfg)


def gate_case(torch, dev, lo, seed):
    """The run gate and the previous occupancy of the grid epilogue: every
    fourth rig gated off (one (H, W) grid: on); probabilities in [0, 1],
    the first few exactly on a half of the int8 export's unit (round half
    to even)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    occ_prev = torch.rand(lo.shape, generator=g, device=dev)
    occ_prev.view(-1)[:4] = torch.tensor([0.125, 0.375, 0.625, 0.875],
                                         device=dev)
    if lo.dim() == 2:
        return torch.ones((), dtype=torch.bool, device=dev), occ_prev
    return torch.arange(lo.shape[0], device=dev) % 4 != 3, occ_prev


def compare_epilogue(torch, what, got, ref):
    """(log_odds, occupancy, occupancy_i8) of a kernel against its plain
    path: log-odds and the export bit-equal, occupancy atol 1e-7. Returns
    the max |error| of the three."""
    (lo_k, occ_k, i8_k), (lo_p, occ_p, i8_p) = got, ref
    if not torch.equal(lo_k, lo_p):
        fail(f"{what} kernel log-odds are not bit-equal to the plain path")
    if not torch.allclose(occ_k, occ_p, rtol=0, atol=1e-7):
        fail(f"{what} kernel occupancy disagrees with the plain path")
    if i8_k.dtype != torch.int8 or not torch.equal(i8_k, i8_p):
        fail(f"{what} kernel occupancy_i8 differs from the plain path")
    return max((lo_k - lo_p).abs().max().item(),
               (occ_k - occ_p).abs().max().item(),
               (i8_k.int() - i8_p.int()).abs().max().item())


def epilogue_bytes(lo, gate) -> int:
    """Compulsory bytes of a grid pass with the epilogue: per cell 4 read
    and 9 written (log-odds, occupancy, int8), plus the previous occupancy
    of gated-off rigs."""
    cells = lo.shape[-2] * lo.shape[-1]
    return lo.numel() * 13 + int((~gate).sum()) * cells * 4


def check_grid(torch, dev, cfg, rigs):
    """Fused decay + hits + clamp + sigmoid + run gate + int8 export on
    500x200 grids, 8 boxes a rig, every fourth rig gated off; rigs=None is
    the single-rig (H, W) call."""
    from grid_vision_tpu_torch.ops import cuda_grid, rasterize
    lo, ranges = random_grid_case(torch, dev, cfg, rigs, 2)
    gate, occ_prev = gate_case(torch, dev, lo, 7)
    args = (lo, ranges, gate, occ_prev, cfg)

    def plain():
        return rasterize.gate_and_export(
            *cuda_grid.grid_update_plain(lo, ranges, cfg), gate, lo, occ_prev)

    got = cuda_grid.grid_update_gated(*args)
    torch.cuda.synchronize()
    err = compare_epilogue(torch, "grid", got, plain())
    n = ranges.shape[-2]
    n_bytes = epilogue_bytes(lo, gate) + ranges.numel() * 4
    ops = lo.numel() * (n + 8)
    return dict(
        call=lambda: cuda_grid.grid_update_gated(*args),
        name="grid_update", source="grid_vision_tpu_torch/csrc/cuda_grid.cu",
        replaces="grid_vision_tpu/ops/pallas_grid.py:97",
        shape=list(lo.shape), gated_off=int((~gate).sum()),
        max_abs_err=err,
        **timed(lambda: cuda_grid.grid_update_gated(*args), plain, None),
        bound=bound_ms(n_bytes, ops),
        bound_old_bytes_ms=bound_ms(3 * lo.numel() * 4 + ranges.numel() * 4,
                                    ops)[0])


def scan_in_base(torch, obs, extrinsics):
    """(endpoints (..., P, 2), valid (..., P), origin (2,)) of an Obs's
    scan in the base frame, as the tick hands them to the carve."""
    from grid_vision_tpu_torch.geometry import transform_points
    cam = transform_points(extrinsics.lidar_to_camera, obs.cloud.xyz)
    base = transform_points(extrinsics.camera_to_base, cam)
    valid = obs.cloud.mask() & obs.has_cloud[..., None]
    return (base[..., :2].contiguous(), valid,
            extrinsics.camera_to_base[:2, 3])


def check_raycast(torch, dev, cfg, rigs, obs, extrinsics):
    """Fused carve + decay + hits + clamp + sigmoid + run gate + int8
    export on 500x200 grids: random log-odds, 8 footprints a rig, the range
    profile of the scan(s) in obs, every fourth rig gated off; rigs=None is
    the single-rig (H, W) call. Log-odds and the export bit-equal to the
    plain path, occupancy atol 1e-7; a scan with no valid point must equal
    the grid kernel bit for bit on all three outputs."""
    from grid_vision_tpu_torch.ops import (cuda_grid, cuda_raycast,
                                           rasterize, raycast)
    lo, box_ranges = random_grid_case(torch, dev, cfg, rigs, 6)
    gate, occ_prev = gate_case(torch, dev, lo, 8)
    pts, valid, origin = scan_in_base(torch, obs, extrinsics)
    ranges = raycast.range_profile(origin, pts, valid)
    cbin, cr = raycast.cell_polar_maps(origin, cfg)
    args = (lo, box_ranges, ranges, cbin, cr, gate, occ_prev, cfg)

    def plain():
        return rasterize.gate_and_export(*cuda_raycast.carve_update_plain(
            lo, box_ranges, ranges, cbin, cr, cfg), gate, lo, occ_prev)

    got = cuda_raycast.fused_carve_update_gated(*args)
    torch.cuda.synchronize()
    err = compare_epilogue(torch, "carve", got, plain())
    hit = cuda_grid.grid_update_gated(lo, box_ranges, gate, occ_prev, cfg)
    carved = (got[0] != hit[0]).float().mean().item()
    if carved == 0.0:
        fail("the carve kernel carved no cell of a real scan")
    none = raycast.range_profile(origin, pts, torch.zeros_like(valid))
    got_n = cuda_raycast.fused_carve_update_gated(
        lo, box_ranges, none, cbin, cr, gate, occ_prev, cfg)
    if not all(torch.equal(a, b) for a, b in zip(got_n, hit)):
        fail("the carve kernel on an all-invalid scan differs from the "
             "grid kernel")
    maps_bytes = (ranges.numel() + box_ranges.numel() + cbin.numel()
                  + cr.numel()) * 4
    ops = lo.numel() * (box_ranges.shape[-2] + 12)
    return dict(
        call=lambda: cuda_raycast.fused_carve_update_gated(*args),
        name="carve_update",
        source="grid_vision_tpu_torch/csrc/cuda_raycast.cu",
        replaces="grid_vision_tpu/ops/pallas_raycast.py:135",
        shape=list(lo.shape), bins=ranges.shape[-1], carved_share=carved,
        gated_off=int((~gate).sum()), max_abs_err=err,
        **timed(lambda: cuda_raycast.fused_carve_update_gated(*args), plain,
                None),
        bound=bound_ms(epilogue_bytes(lo, gate) + maps_bytes, ops),
        bound_old_bytes_ms=bound_ms(3 * lo.numel() * 4 + maps_bytes, ops)[0])


def device_profile(torch, fn, iters: int = 10):
    """(device ms, device launches) per call of fn(), every kernel counted,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU]
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters,
            len(events) / iters)


def grid_stage(torch, dev, cfg, obs, extrinsics):
    """The fleet tick's grid stage at 64 rigs, from the box ranges to
    StepOutput, in its two forms: unfused (the kernel, then the run gate's
    two torch.where and the int8 export in eager torch,
    rasterize.gate_and_export: what _fuse_rigs ran before the kernels took
    the epilogue) and fused (one launch); device ms and device launches per
    call, for the grid and the carve kernel."""
    from grid_vision_tpu_torch.ops import (cuda_grid, cuda_raycast,
                                           rasterize, raycast)
    lo, box = random_grid_case(torch, dev, cfg, N_RIGS, 9)
    gate, prev = gate_case(torch, dev, lo, 10)
    pts, valid, origin = scan_in_base(torch, obs, extrinsics)
    ranges = raycast.range_profile(origin, pts, valid)
    cbin, cr = raycast.cell_polar_maps(origin, cfg)
    forms = {
        "grid_unfused": lambda: rasterize.gate_and_export(
            *cuda_grid.grid_update(lo, box, cfg), gate, lo, prev),
        "grid_fused": lambda: cuda_grid.grid_update_gated(
            lo, box, gate, prev, cfg),
        "carve_unfused": lambda: rasterize.gate_and_export(
            *cuda_raycast.fused_carve_update_cuda(lo, box, ranges, cbin, cr,
                                                  cfg), gate, lo, prev),
        "carve_fused": lambda: cuda_raycast.fused_carve_update_gated(
            lo, box, ranges, cbin, cr, gate, prev, cfg)}
    for kind in ("grid", "carve"):
        a, b = forms[kind + "_unfused"](), forms[kind + "_fused"]()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"the fused {kind} stage differs from the unfused")
    out = {}
    for name, fn in forms.items():
        ms, n = device_profile(torch, fn)
        out[name] = dict(device_ms=ms, device_launches=n)
    return out


def check_knn(torch, dev, cfg, cloud, d=None):
    """k-NN median depth of d (max_static_depth unless given) box centers
    against the projected cloud: (P, 3) single-rig or (R, P, 3) fleet."""
    from grid_vision_tpu_torch.geometry import intrinsic_matrix
    from grid_vision_tpu_torch.ops import association, cuda_knn
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    uvd, valid = association.project_cloud_to_image(cloud, K)
    g = torch.Generator(device=dev).manual_seed(3)
    d = cfg.max_static_depth if d is None else d
    lead = uvd.shape[:-2]
    centers = torch.rand(lead + (d, 2), generator=g, device=dev) * \
        torch.tensor([cfg.camera_image_width, cfg.camera_image_height],
                     device=dev)
    k = cfg.k_near
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, k)
    torch.cuda.synchronize()
    ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, k)
    if not torch.allclose(got, ref, rtol=1e-6, atol=0):
        fail(f"kNN kernel disagrees with its twin: max |d| "
             f"{(got - ref).abs().max().item()}")
    c3 = torch.cat([centers, torch.zeros(lead + (d, 1), device=dev)], -1)

    def library():
        dist = torch.cdist(c3, uvd).masked_fill(~valid[..., None, :],
                                                float("inf"))
        vals, idx = torch.topk(dist, k, largest=False)
        z = torch.where(torch.isfinite(vals),
                        torch.gather(uvd[..., None, :, 2].expand(
                            dist.shape), -1, idx), float("inf"))
        n_found = torch.isfinite(vals).sum(-1)
        med = torch.sort(z, -1).values.gather(
            -1, (n_found // 2).clamp(max=k - 1)[..., None])[..., 0]
        return torch.where(n_found > 0, med, -1.0)

    lib = library()
    p_valid = int(valid.sum())
    n_bytes = uvd.numel() * 4 + valid.numel() + centers.numel() * 4 + \
        got.numel() * 4
    ops = 7 * d * p_valid
    t = timed(lambda: cuda_knn.knn_median_depth_centers_cuda(
        uvd, valid, centers, k),
        lambda: cuda_knn.knn_median_depth_plain(uvd, valid, centers, k),
        library)
    n_rigs = lead[0] if lead else 1
    return dict(
        call=lambda: cuda_knn.knn_median_depth_centers_cuda(
            uvd, valid, centers, k),
        name="knn_median_depth",
        source="grid_vision_tpu_torch/csrc/cuda_knn.cu",
        replaces="grid_vision_tpu/ops/pallas_knn.py:72",
        shape=list(uvd.shape), queries=d,
        slices=cuda_knn.knn_split(n_rigs, uvd.shape[-2], d, k)[0],
        max_abs_err=(got - ref).abs().max().item(),
        library_max_abs_err=(lib - ref).abs().max().item(), **t,
        bound=bound_ms(n_bytes, ops))


def check_csp(torch, dev, detector, cfg, batch):
    """ConvBN_2 + CSPBlock_0 + max pool on `batch` (104, 104, 64) stem
    activations (the stem kernel's output of random frames)."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import fold_bn
    from grid_vision_tpu_torch.ops import cuda_csp, cuda_stem
    g = torch.Generator(device=dev).manual_seed(4)
    img = torch.rand((batch, cfg.camera_image_height, cfg.camera_image_width,
                      3), generator=g, device=dev) * 255.0
    x = cuda_stem.detector_stem_cuda(
        img, cuda_stem.prepare_stem_constants(detector), cfg.resize)
    del img
    consts = cuda_csp.prepare_csp_constants(detector)
    got = cuda_csp.detector_csp_cuda(x, detector, consts)
    torch.cuda.synchronize()
    ref = cuda_csp.detector_csp_plain(x, detector)
    if not torch.allclose(got, ref, rtol=1e-4, atol=1e-4):
        fail(f"CSP kernel disagrees with its twin: max |d| "
             f"{(got - ref).abs().max().item()}")

    def folded(conv_bn):
        s, b = fold_bn(conv_bn.BatchNorm_0)
        return conv_bn.Conv_0.weight * s[:, None, None, None], b

    csp = detector.CSPBlock_0
    (w2, b2), (wa, ba), (wb, bb), (wc, bc) = (
        folded(m) for m in (detector.ConvBN_2, csp.ConvBN_0, csp.ConvBN_1,
                            csp.ConvBN_2))

    def library():
        """cuDNN convs with BN folded, leaky, concats, max_pool2d."""
        y = F.leaky_relu(F.conv2d(x.permute(0, 3, 1, 2), w2, b2, padding=1),
                         0.1)
        x1 = F.leaky_relu(F.conv2d(y[:, 32:], wa, ba, padding=1), 0.1)
        x2 = F.leaky_relu(F.conv2d(x1, wb, bb, padding=1), 0.1)
        x3 = F.leaky_relu(F.conv2d(torch.cat([x2, x1], 1), wc, bc), 0.1)
        return F.max_pool2d(torch.cat([y, x3], 1), 2, 2)

    lib = library().permute(0, 2, 3, 1)
    if not torch.allclose(lib, ref, rtol=1e-4, atol=1e-4):
        fail("CSP library yardstick disagrees with the twin")
    _, h, w, _ = x.shape
    ops = batch * 2 * h * w * (64 * 576 + 2 * 32 * 288 + 64 * 64)
    n_bytes = (x.numel() + got.numel() + 576 * 64 + 2 * 288 * 32 + 64 * 64
               + 2 * 192) * 4
    with torch.no_grad():
        t = timed(lambda: cuda_csp.detector_csp_cuda(x, detector, consts),
                  lambda: cuda_csp.detector_csp_plain(x, detector), library,
                  iters=20)
    return dict(
        call=lambda: cuda_csp.detector_csp_cuda(x, detector, consts),
        name="detector_csp", source="grid_vision_tpu_torch/csrc/cuda_csp.cu",
        replaces="grid_vision_tpu/ops/pallas_csp.py:404",
        also_replaces="grid_vision_tpu/ops/pallas_csp.py:343",
        shape=list(x.shape), max_abs_err=(got - ref).abs().max().item(),
        library_max_abs_err=(lib - ref).abs().max().item(), **t,
        bound=bound_ms(n_bytes, ops),
        bound_3xtf32_ms=bound_3xtf32_ms(n_bytes, ops))


def check_orient(torch, dev, net, cfg, rigs, n_crops):
    """Crop + standardize + folded s2d stem conv for n_crops boxes over
    `rigs` random frames, clamped, invalid and sliver boxes among them."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import fold_bn, same_pad
    from grid_vision_tpu_torch.ops import cuda_orient, preprocess
    g = torch.Generator(device=dev).manual_seed(5)
    h, w, size = (cfg.camera_image_height, cfg.camera_image_width,
                  cfg.network_height)
    images = torch.rand((rigs, h, w, 3), generator=g, device=dev) * 255.0
    u = torch.rand((n_crops, 4), generator=g, device=dev)
    x0 = u[:, 0] * (w + 60) - 40            # some boxes clamp at each edge
    y0 = u[:, 1] * (h + 60) - 40
    xyxy = torch.stack([x0, y0, x0 + 8 + u[:, 2] * 300,
                        y0 + 8 + u[:, 3] * 250], dim=-1)
    xyxy[0] = torch.tensor([100.0, 100.0, 100.4, 100.4])    # sliver: flat
    valid = torch.rand((n_crops,), generator=g, device=dev) > 0.1
    valid[0] = True
    rig = torch.sort(torch.randint(0, rigs, (n_crops,), generator=g,
                                   device=dev)).values
    consts = cuda_orient.prepare_orient_constants(net)
    with torch.no_grad():
        got = cuda_orient.orient_front_cuda(images, xyxy, valid, rig, net,
                                            consts, size)
        torch.cuda.synchronize()
        ref = cuda_orient.orient_front_plain(images, xyxy, valid, rig, net,
                                             size)
    # flat crops (any channel's std < 1 grey level) are ill-conditioned
    # (ROADMAP C): held to finiteness only
    with torch.no_grad():
        flat = cuda_orient.crops_by_rig(images, xyxy, rig, size).std(
            dim=(1, 2)).amin(dim=-1) < 1.0
    keep = ~flat
    if not torch.isfinite(got).all():
        fail("orientation-front kernel output is not finite")
    if not torch.allclose(got[keep], ref[keep], rtol=1e-3, atol=1e-3):
        fail(f"orientation-front kernel disagrees with its twin: max |d| "
             f"{(got[keep] - ref[keep]).abs().max().item()}")
    with torch.no_grad():
        bn_s, bn_t = fold_bn(net.ConvBN_0.BatchNorm_0)
        wmat4 = net.ConvBN_0.conv_weight() * bn_s[:, None, None, None]
    lo, hi = (4 * p for p in same_pad(size // 4, 3, 2))

    def library():
        """crop_resize einsums + standardize + cuDNN conv, BN folded."""
        c = cuda_orient.crops_by_rig(images, xyxy, rig, size)
        std = preprocess._standardize(c, valid).permute(0, 3, 1, 2)
        y = F.conv2d(F.pad(std, (lo, hi, lo, hi)), wmat4, bn_t, stride=8)
        return F.relu(y)

    with torch.no_grad():
        lib = library().permute(0, 2, 3, 1)
        t = timed(lambda: cuda_orient.orient_front_cuda(
            images, xyxy, valid, rig, net, consts, size),
            lambda: cuda_orient.orient_front_plain(
                images, xyxy, valid, rig, net, size), library, iters=20)
    n_valid = int(valid.sum())
    q, f = got.shape[1], got.shape[3]
    ops = n_valid * (2 * q * q * f * 12 * 12 * 3 + size * size * 3 * 10)
    frame_bytes = tapped_frame_bytes(torch, images, xyxy, valid, rig, size)
    n_bytes = frame_bytes + (xyxy.numel() + got.numel() + wmat4.numel()
                             + 2 * f) * 4 + 2 * n_crops
    return dict(
        call=lambda: cuda_orient.orient_front_cuda(
            images, xyxy, valid, rig, net, consts, size),
        name="orient_front", source="grid_vision_tpu_torch/csrc/cuda_orient.cu",
        replaces="grid_vision_tpu/ops/pallas_orient.py:288",
        shape=[n_crops, size, size, 3], crops_valid=n_valid,
        frame_bytes_tapped=frame_bytes, crops_flat_left_out=int(flat.sum()),
        max_abs_err=(got[keep] - ref[keep]).abs().max().item(),
        library_max_abs_err=(lib[keep] - ref[keep]).abs().max().item(), **t,
        bound=bound_ms(n_bytes, ops),
        bound_3xtf32_ms=bound_3xtf32_ms(n_bytes, ops))


def run_ticks(torch, engine, obs_seq):
    state = engine.init_state()
    outs, times = [], []
    for obs in obs_seq:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = engine(state, obs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return state, outs, times


def run_fleet(torch, engine, obs_seq, budget):
    states = engine.init_states(N_RIGS)
    outs, times = [], []
    for obs in obs_seq:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, out = engine.fleet(states, obs, budget)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return states, outs, times


def compare_outputs(torch, cfg, outs, plain_outs, per_rig: bool):
    """occupancy_i8 agreement (per rig with per_rig), identical box counts
    and pose validity, finite valid slots; returns (min agreement, box
    counts, pose counts)."""
    agree, n_boxes, n_poses = [], [], []
    for o, p in zip(outs, plain_outs):
        grid_shape = tuple(o.occupancy_i8.shape[-2:])
        if grid_shape != tuple(cfg.grid_size):
            fail(f"occupancy_i8 shape {tuple(o.occupancy_i8.shape)}")
        for name, t in (("static_points", o.static_points),
                        ("static_depths", o.static_depths),
                        ("boxes", o.boxes.xyxy[o.boxes.valid]),
                        ("poses", o.poses.position[o.poses.valid])):
            if not torch.isfinite(t).all():
                fail(f"non-finite {name} in a valid slot")
        eq = (o.occupancy_i8 == p.occupancy_i8).float()
        agree.append(eq.mean(dim=(-2, -1)).min().item() if per_rig
                     else eq.mean().item())
        nb = o.boxes.valid.sum(-1)
        if not torch.equal(nb, p.boxes.valid.sum(-1)):
            fail("box counts differ from the plain path")
        if per_rig and not torch.equal(o.poses.valid, p.poses.valid):
            fail("pose validity differs from the plain path")
        n_boxes.append(int(nb.sum()))
        n_poses.append(int(o.poses.valid.sum()))
    if min(agree) < 0.999:
        fail(f"occupancy_i8 agreement {min(agree)} < 0.999")
    return min(agree), n_boxes, n_poses


BOX_BAND = 0.02     # band about the decode's thresholds (compare_bf16)


def pairwise_iou(torch, xyxy):
    """(..., N, 4) boxes -> (..., N, N) IoU."""
    lo = torch.maximum(xyxy[..., :, None, :2], xyxy[..., None, :, :2])
    hi = torch.minimum(xyxy[..., :, None, 2:], xyxy[..., None, :, 2:])
    inter = (hi - lo).clamp(min=0).prod(-1)
    area = (xyxy[..., 2:] - xyxy[..., :2]).clamp(min=0).prod(-1)
    return inter / (area[..., :, None] + area[..., None, :] - inter
                    ).clamp(min=1e-9)


def marginal_boxes(torch, cfg, boxes, band: float):
    """The valid boxes that sit within `band` of one of the decode's
    thresholds: a confidence below confidence_threshold + band, or an IoU
    with a box kept before it (the rows are in NMS order) of
    iou_threshold - band or more. A bf16 rounding may move such a box
    across the threshold on either path."""
    xyxy, valid = boxes.xyxy.float(), boxes.valid
    n = valid.shape[-1]
    iou = pairwise_iou(torch, xyxy)
    before = torch.ones(n, n, dtype=torch.bool,
                        device=valid.device).tril(-1)
    near_nms = ((iou >= cfg.iou_threshold - band) & before
                & valid[..., None, :]).any(-1)
    near_conf = boxes.confidence < cfg.confidence_threshold + band
    return valid & (near_conf | near_nms)


def bf16_stats(torch, cfg, outs, plain_outs, band: float = BOX_BAND):
    """The kernel backends against the plain ones in bf16, per rig per
    tick; fails on non-finite valid slots.

    Box counts agree where they differ by marginal boxes only
    (marginal_boxes): each path's other boxes are no more than the other
    path's boxes. A rounding that moves a box across the confidence
    threshold, or across the NMS threshold against the box before it,
    changes no box that sits clear of both (a box is suppressed only by
    one before it). A rig is clean while its two paths have given the same
    boxes, or equal counts and no marginal box, on every tick so far (a
    box moved across a threshold changes the grid from then on):
    occupancy_i8 agreement is
    reported on the mean over all rig-ticks and at the least over the
    clean ones."""
    same, raw_same, agree, clean_agree = [], [], [], []
    n_boxes, n_poses, n_marginal = [], [], []
    clean = None
    for o, p in zip(outs, plain_outs):
        if tuple(o.occupancy_i8.shape[-2:]) != tuple(cfg.grid_size):
            fail(f"occupancy_i8 shape {tuple(o.occupancy_i8.shape)}")
        for name, t in (("static_points", o.static_points),
                        ("boxes", o.boxes.xyxy[o.boxes.valid]),
                        ("poses", o.poses.position[o.poses.valid])):
            if not torch.isfinite(t).all():
                fail(f"non-finite {name} in a valid slot (bf16)")
        (na, nm), (pa, pm) = (
            (b.valid.sum(-1), marginal_boxes(torch, cfg, b, band).sum(-1))
            for b in (o.boxes, p.boxes))
        same += ((na - nm <= pa) & (pa - pm <= na)).reshape(-1).tolist()
        raw_same += (na == pa).reshape(-1).tolist()
        ob, pb = o.boxes, p.boxes
        identical = ((ob.xyxy == pb.xyxy).all(-1) & (ob.label == pb.label)
                     & (ob.confidence == pb.confidence)
                     & (ob.valid == pb.valid)).all(-1)
        now = identical | ((na == pa) & (nm == 0) & (pm == 0))
        clean = now if clean is None else clean & now
        eq = (o.occupancy_i8 == p.occupancy_i8).float().mean(dim=(-2, -1))
        agree += eq.reshape(-1).tolist()
        clean_agree += eq[clean].reshape(-1).tolist()
        n_boxes.append(int(na.sum()))
        n_marginal.append(int(pm.sum()))
        n_poses.append(int(o.poses.valid.sum()))
    return dict(equal_box_count_share=sum(same) / len(same),
                raw_equal_box_count_share=sum(raw_same) / len(raw_same),
                mean_occupancy_i8_agreement=sum(agree) / len(agree),
                min_occupancy_i8_agreement=min(agree),
                clean_rig_ticks=len(clean_agree),
                min_clean_occupancy_i8_agreement=(
                    min(clean_agree) if clean_agree else None),
                boxes_per_tick=n_boxes,
                plain_marginal_boxes_per_tick=n_marginal,
                poses_per_tick=n_poses, box_band=band)


def meets_bf16_bars(out) -> bool:
    """root PERF.md §2's bf16 bars on bf16_stats: box counts agreeing
    (but for marginal boxes) on >= 99 % of rig-ticks; occupancy_i8 agreement
    >= 99 % on the mean, and >= 97.5 % at the least over the clean
    rig-ticks (PARITY.json per_step_min_agreement of the JAX package's
    bf16 against f32)."""
    return (out["equal_box_count_share"] >= 0.99
            and out["mean_occupancy_i8_agreement"] >= 0.99
            and (out["min_clean_occupancy_i8_agreement"] or 1.0) >= 0.975)


def compare_bf16(torch, cfg, outs, plain_outs):
    """bf16_stats held to the bf16 bars (meets_bf16_bars)."""
    out = bf16_stats(torch, cfg, outs, plain_outs)
    if not meets_bf16_bars(out):
        fail(f"bf16 kernel backends against the plain ones: {out}")
    return out


def profile_fleet(torch, engine, obs, budget, ticks: int = 3):
    """torch.profiler over `ticks` fleet ticks: device time by kernel name
    (the top 15, and every kernel of csrc/) and the device's busy share of
    the host-clock tick (kernels run on one stream, so their times add up
    without overlap)."""
    from torch.profiler import ProfilerActivity, profile
    states, _ = engine.fleet(engine.init_states(N_RIGS), obs, budget)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            states, _ = engine.fleet(states, obs, budget)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    by_name, launches = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        ms = e.time_range.elapsed_us() / 1e3 / ticks
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        launches[e.name] = launches.get(e.name, 0) + 1
    busy = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    conv_words = ("conv", "fprop", "implicit", "cudnn", "dgrad", "wgrad")

    def rows(items):
        return [dict(name=n[:90], ms_per_tick=ms,
                     launches_per_tick=launches[n] / ticks)
                for n, ms in items]

    return dict(ticks=ticks, tick_ms=wall_ms, device_busy_ms=busy,
                library_conv_ms=sum(
                    ms for n, ms in by_name.items() if "gv_" not in n
                    and any(w in n.lower() for w in conv_words)),
                device_idle_share=(1.0 - busy / wall_ms) if busy else None,
                device_launches_per_tick=sum(launches.values()) / ticks,
                top_kernels=rows(ranked[:15]),
                port_kernels=rows([kv for kv in ranked if "gv_" in kv[0]]))


def carved_shares(torch, cfg, obs_seq, extrinsics):
    """Per tick the share of grid cells the scan carves (the mean over
    rigs where obs carries a rig axis)."""
    from grid_vision_tpu_torch.ops import raycast
    shares = []
    for obs in obs_seq:
        pts, valid, origin = scan_in_base(torch, obs, extrinsics)
        shares.append(raycast.carve_mask(origin, pts, valid,
                                         cfg).mean().item())
    return shares


def pca_stage(torch, engine, states, obs):
    """The PCA pose branch (plane, association, L-shape) of one tick, on
    the inputs the tick gives it (boxes of the engine's detector, gated;
    index 0 of each rig's rng split): pose count, device ms and device
    launches per call from the profiler, host-clock ms per call, the same
    for each part (RANSAC plane, association and sub-clouds, radius count,
    PCA), and the sub-clouds' valid points against the packed points the
    radius count processes. The stage runs once under
    torch.cuda.set_sync_debug_mode("error"): a host sync fails the run."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.geometry import intrinsic_matrix
    from grid_vision_tpu_torch.utils import prng
    cfg = engine.cfg
    with torch.no_grad():
        boxes, _ = pipeline.detect_batch(engine.params, obs.image, cfg)
    boxes = dataclasses.replace(boxes,
                                valid=boxes.valid & obs.has_image[:, None])
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                         device=boxes.xyxy.device)
    rng = prng.split(states.rng)[..., 0, :]

    def call():
        return pipeline.pose_branch(engine.params, obs, boxes, K, rng,
                                    engine.extrinsics, cfg)

    call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        poses, _ = call()
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode(0)
        fail(f"the PCA stage synchronizes with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_poses = int(poses.valid.sum())
    device_ms, launches = device_profile(torch, call, iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    # its parts, in the order _pca_poses runs them
    from grid_vision_tpu_torch.geometry import transform_points
    from grid_vision_tpu_torch.ops import association, lshape, plane
    cloud = transform_points(engine.extrinsics.lidar_to_camera,
                             obs.cloud.xyz)
    valid = obs.cloud.mask() & obs.has_cloud[:, None]
    n_boxes = boxes.capacity
    parts = {"plane": lambda: plane.segment_ground_plane(
        cloud, valid, rng, cfg.ransac_iters, cfg.ransac_distance_threshold)}
    non_ground = parts["plane"]()[0]
    parts["association"] = lambda: association.gather_box_clouds(
        cloud, association.assign_points_to_boxes(
            cloud, non_ground, K, boxes, cfg.camera_image_width,
            cfg.camera_image_height)[0], n_boxes, cfg.max_points_per_box)
    pts, pvalid, _ = parts["association"]()
    parts["radius_count"] = lambda: lshape.radius_outlier_mask(
        pts, pvalid, cfg.outlier_radius, cfg.outlier_min_neighbors,
        max_valid=cloud.shape[-2])
    kept = parts["radius_count"]()
    parts["pca"] = lambda: lshape.pca_pose(pts, kept)
    split = {}
    for name, fn in parts.items():
        ms, n = device_profile(torch, fn, iters=3)
        split[name] = dict(device_ms=ms, device_launches=n)
    return dict(poses=n_poses, device_ms=device_ms, device_launches=launches,
                host_clock_ms=host_ms, sync_debug_mode="error", parts=split,
                valid_sub_cloud_points=int(pvalid.sum()),
                packed_points=cloud.shape[-2] * cloud.shape[0])


def pca_phases(torch, dev, engine, cfg, fleet_cfg, nets, obs_seq,
               fleet_obs, modules, forms, fleet_times, card):
    """Phase `pca`: the PCA pose branch (use_vision_orientation=False) on
    the single rig, the fleet in f32 and in bf16, and one extension
    configuration, each against the same configuration on the plain
    backends, counters from zero; the PCA stage's device time, launches
    and host syncs (pca_stage); the PCA fleet tick's peak memory and
    profile. Returns the launches of the f32 and the bf16 fleet runs."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.types import stack
    bf16 = torch.bfloat16
    pca = dict(use_vision_orientation=False)

    def pca_run(run, want):
        return _counted(modules, forms, run, want, "PCA run")

    def pca_pair(base, **flags):
        kern = pipeline.Engine(dataclasses.replace(base, **pca, **flags),
                               extrinsics=engine.extrinsics, params=nets,
                               device=dev)
        plain = pipeline.Engine(dataclasses.replace(
            base, **pca, **flags, detector_stem_backend="xla",
            orientation_stem_backend="xla", grid_backend="xla",
            knn_backend="xla"), extrinsics=engine.extrinsics, params=nets,
            device=dev)
        return kern, plain

    def pose_counts(outs_a, outs_b):
        a = [int(o.poses.valid.sum()) for o in outs_a]
        if a != [int(o.poses.valid.sum()) for o in outs_b]:
            fail("PCA pose counts differ from the plain path")
        return a

    pca_engine, pca_plain = pca_pair(cfg)
    if any(k.startswith("orientation_stem") for k in pca_engine.params):
        fail("a PCA engine folded the orientation kernel's constants")
    pca_obs = obs_seq[:PCA_ENGINE_TICKS]
    T = PCA_ENGINE_TICKS
    (_, outs, times), pca_engine_launches = pca_run(
        lambda: run_ticks(torch, pca_engine, pca_obs),
        dict(detector_stem=T, grid_update=T, knn_median_depth=T))
    _, plain_outs, plain_times = run_ticks(torch, pca_plain, pca_obs)
    agree, n_boxes, n_poses = compare_outputs(torch, cfg, outs, plain_outs,
                                              per_rig=False)
    stage = pca_stage(torch, pca_engine, stack([pca_engine.init_state()]),
                      stack([pca_obs[0]]))
    phase("pca", path="engine", ticks=T, launches=pca_engine_launches,
          median_tick_ms=statistics.median(times),
          plain_median_tick_ms=statistics.median(plain_times),
          min_occupancy_i8_agreement=agree, boxes_per_tick=n_boxes,
          poses_per_tick=pose_counts(outs, plain_outs),
          box_cloud_truncated=[int(o.saturation.box_cloud_truncated)
                               for o in outs],
          occupied_cells_last=int((outs[-1].occupancy_i8 > 50).sum()),
          pca_stage=stage)
    del outs, plain_outs, pca_engine, pca_plain

    # the fleet in f32, then bf16 frames in the bf16 configuration
    T = PCA_FLEET_TICKS
    pca_fleet, pca_fplain = pca_pair(fleet_cfg)
    pca_fobs = fleet_obs[:T]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (_, fouts, ftimes), pca_launches = pca_run(
        lambda: run_fleet(torch, pca_fleet, pca_fobs, BUDGET),
        dict(detector_stem=T, detector_csp=T, grid_update=T,
             knn_median_depth=T))
    peak_bytes = torch.cuda.max_memory_allocated()
    if peak_bytes > PCA_PEAK_GB * 2 ** 30:
        fail(f"the PCA fleet tick peaks at {peak_bytes / 2 ** 30:.2f} GiB")
    _, fplain_outs, fplain_times = run_fleet(torch, pca_fplain, pca_fobs,
                                             BUDGET)
    fagree, f_boxes, f_poses = compare_outputs(torch, fleet_cfg, fouts,
                                               fplain_outs, per_rig=True)
    med, pmed = statistics.median(ftimes), statistics.median(fplain_times)
    fstage = pca_stage(torch, pca_fleet, pca_fleet.init_states(N_RIGS),
                       pca_fobs[0])
    phase("pca", path="fleet", rigs=N_RIGS, ticks=T, launches=pca_launches,
          median_tick_ms=med, plain_median_tick_ms=pmed,
          rig_frames_per_s=N_RIGS / med * 1e3,
          plain_rig_frames_per_s=N_RIGS / pmed * 1e3, tick_ms=ftimes,
          vision_f32_median_tick_ms=statistics.median(fleet_times),
          min_occupancy_i8_agreement_per_rig=fagree, boxes_per_tick=f_boxes,
          poses_per_tick=f_poses,
          box_cloud_truncated=[int(o.saturation.box_cloud_truncated.sum())
                               for o in fouts],
          peak_memory_gib=peak_bytes / 2 ** 30,
          memory_before_gib=base_bytes / 2 ** 30, pca_stage=fstage,
          card=card)
    del fouts, fplain_outs, pca_fplain
    torch.cuda.empty_cache()
    phase("profile", path="pca_fleet/kernels",
          **profile_fleet(torch, pca_fleet, pca_fobs[0], BUDGET))

    bf_pca, bf_pca_plain = pca_pair(fleet_cfg, compute_dtype="bfloat16")
    bf_pca_obs = [dataclasses.replace(o, image=o.image.to(bf16))
                  for o in pca_fobs]
    (_, fouts, ftimes), pca_bf_launches = pca_run(
        lambda: run_fleet(torch, bf_pca, bf_pca_obs, BUDGET),
        dict(detector_stem_bf16=T, detector_csp_bf16=T, grid_update=T,
             knn_median_depth=T))
    _, fplain_outs, fplain_times = run_fleet(torch, bf_pca_plain, bf_pca_obs,
                                             BUDGET)
    med, pmed = statistics.median(ftimes), statistics.median(fplain_times)
    phase("pca", path="fleet_bf16", rigs=N_RIGS, ticks=T,
          launches=pca_bf_launches, median_tick_ms=med,
          plain_median_tick_ms=pmed, rig_frames_per_s=N_RIGS / med * 1e3,
          plain_rig_frames_per_s=N_RIGS / pmed * 1e3, tick_ms=ftimes,
          **compare_bf16(torch, fleet_cfg, fouts, fplain_outs))
    del fouts, fplain_outs, bf_pca, bf_pca_plain, bf_pca_obs, pca_fleet
    torch.cuda.empty_cache()

    # one extension configuration with PCA: the carve kernel in the grid
    # kernel's place
    T = PCA_EXT_TICKS
    ext_pca, ext_pca_plain = pca_pair(cfg, compat=False,
                                      raycast_free_space=True)
    (_, outs, _), pca_ext_launches = pca_run(
        lambda: run_ticks(torch, ext_pca, obs_seq[:T]),
        dict(detector_stem=T, carve_update=T, knn_median_depth=T))
    _, plain_outs, _ = run_ticks(torch, ext_pca_plain, obs_seq[:T])
    agree, n_boxes, _ = compare_outputs(torch, cfg, outs, plain_outs,
                                        per_rig=False)
    shares = carved_shares(torch, cfg, obs_seq[:T], engine.extrinsics)
    if not max(shares) > 0.0:
        fail("the PCA extension tick's scans carved no cell")
    phase("pca", path="extension", ticks=T, launches=pca_ext_launches,
          carved_share_per_tick=shares, min_occupancy_i8_agreement=agree,
          boxes_per_tick=n_boxes,
          poses_per_tick=pose_counts(outs, plain_outs))
    del outs, plain_outs, ext_pca, ext_pca_plain
    torch.cuda.empty_cache()
    return pca_launches, pca_bf_launches


def jax_fixture(torch, dev, root, cfg, nets, extrinsics):
    """The port's kernel path at full width against the JAX package's own
    outputs (tests/fixtures/full_width_jax.npz, written on the CPU by
    tools/jax_full_width_fixture.py): the same scene, weights and ticks, compat
    and extension mode, each in f32 and in bf16. f32: occupancy_i8 agreement
    >= 99 % (BASELINE.md's bar) and equal box counts every tick. bf16 (the
    JAX package's XLA chain rounds elsewhere than the Pallas kernels the
    port's kernels follow, and its f32 sums run in another order): the bars
    of the JAX package's own bf16 against its f32 (PARITY.json
    production_vs_compat_vision), equal box counts on >= 99 % of ticks,
    agreement >= 97.5 % every tick and >= 98.5 % on the mean. The PCA
    branch's modes (use_vision_orientation=False, f32 and bf16): its poses
    come from the f32 cloud, so bf16 is held to >= 99 % every tick too, and
    f32 to equal pose counts as well. Returns the per-tick agreement."""
    import numpy as np
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime.stream import obs_from_scene
    ref = np.load(os.path.join(root, "tests", "fixtures",
                               "full_width_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    off = torch.zeros((), dtype=torch.bool, device=dev)
    out = {}
    for mode, flags in meta["modes"].items():
        mcfg = dataclasses.replace(cfg, **flags)
        bf16 = mcfg.compute_dtype == "bfloat16"
        eng = pipeline.Engine(mcfg, extrinsics=extrinsics, params=nets,
                              device=dev)
        scene = SyntheticScene(mcfg, **meta["scene"])
        scene.add_default_traffic()
        scene.add_default_statics()
        state = eng.init_state()
        pca = not mcfg.use_vision_orientation
        agree, boxes, same, poses = [], [], [], []
        for i in range(meta["ticks"]):
            obs = obs_from_scene(scene, i / 10.0, mcfg, dev)
            if i == meta["gated_off_tick"]:
                obs = dataclasses.replace(obs, has_image=off, has_cloud=off)
            state, o = eng(state, obs)
            key = f"{mode}/{i}/"
            n_box = int(o.boxes.valid.sum())
            n_ref = int(ref[key + "boxes_valid"].sum())
            if n_box != n_ref and not bf16:
                fail(f"{mode} tick {i}: {n_box} boxes, the JAX package "
                     f"{n_ref}")
            same.append(n_box == n_ref)
            agree.append(float((o.occupancy_i8.cpu().numpy()
                                == ref[key + "occupancy_i8"]).mean()))
            boxes.append(n_box)
            poses.append(int(o.poses.valid.sum()))
            if pca and not bf16 and poses[-1] != int(
                    ref[key + "poses_valid"].sum()):
                fail(f"{mode} tick {i}: {poses[-1]} poses, the JAX package "
                     f"{int(ref[key + 'poses_valid'].sum())}")
        mean = sum(agree) / len(agree)
        if (min(agree) < 0.99 and (pca or not bf16)) or (bf16 and (
                sum(same) / len(same) < 0.99 or mean < 0.985
                or min(agree) < 0.975)):
            fail(f"{mode}: against the JAX package: occupancy_i8 agreement "
                 f"{agree}, equal box counts {same}")
        out[mode] = dict(occupancy_i8_agreement=agree, boxes=boxes,
                         poses=poses, equal_box_counts=same)
    return out


def _counted(modules, forms, run, want, what):
    """run() with every launch counter set to 0 just before it; fails
    unless the counts read just after equal `want` (unnamed kernels 0).
    Returns (run's result, the counts)."""
    for m in modules.values():
        m.launches = 0
    for m in forms.values():
        m.launches_bf16 = 0
    result = run()
    got = {name: m.launches for name, m in modules.items()}
    got.update({name: m.launches_bf16 for name, m in forms.items()})
    want = dict({name: 0 for name in got}, **want)
    if got != want:
        fail(f"{what}: launches {got}, expected {want}")
    return result, got


def _same_ticks(torch, what, outs, refs, exact=True):
    """Per tick: box counts equal, and occupancy_i8 bit-equal (exact) or
    the share of cells within one int8 step (returned)."""
    shares = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        if int(o.boxes.valid.sum()) != int(r.boxes.valid.sum()) and exact:
            fail(f"{what} tick {i}: box counts differ")
        if exact:
            if not torch.equal(o.occupancy_i8, r.occupancy_i8):
                fail(f"{what} tick {i}: occupancy_i8 differs")
            shares.append(1.0)
        else:
            d = (o.occupancy_i8.int() - r.occupancy_i8.int()).abs()
            shares.append((d <= 1).float().mean().item())
    return shares


class PinnedRing:
    """Host np.uint8 buffers to the card through `slots` page-locked
    staging buffers with non-blocking copies, so a copy overlaps the
    previous tick: the comparison the stream phase makes with the engine's
    pageable copy (the port itself copies pageable). Before a slot is
    refilled the host waits on the event recorded after that slot's last
    copy: a refilled slot under an unfinished copy would corrupt a frame
    silently."""

    def __init__(self, torch, dev, slots: int = 2):
        self.torch, self.dev, self.slots = torch, dev, slots
        self.ring, self.next = None, 0

    def __call__(self, host):
        torch = self.torch
        if self.ring is None:
            self.ring = [(torch.empty(host.nbytes, dtype=torch.uint8,
                                      pin_memory=True), torch.cuda.Event())
                         for _ in range(self.slots)]
        slot, done = self.ring[self.next]
        self.next = (self.next + 1) % self.slots
        done.synchronize()
        slot.numpy()[:] = host.reshape(-1)
        out = torch.empty(host.shape, dtype=torch.uint8, device=self.dev)
        out.copy_(slot.view(host.shape), non_blocking=True)
        done.record()
        return out


def pinned_link_bandwidth(torch, dev, reps: int = 5, big: int = 8 << 20,
                          small: int = 1 << 12) -> float:
    """stream.probe_link_bandwidth's two-size probe from page-locked host
    memory with non-blocking copies: bytes/s."""
    def t_of(nbytes):
        buf = torch.ones(nbytes, dtype=torch.uint8, pin_memory=True)
        ts = []
        for _ in range(reps + 1):        # the first copy warms up
            t0 = time.perf_counter()
            buf.to(dev, non_blocking=True)[-1:].sum().item()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts[1:])

    return (big - small) / max(t_of(big) - t_of(small), 1e-6)


def stream_phases(torch, dev, root, cfg, nets, extrinsics, modules, forms):
    """Phase `stream`: the streaming ingest path (the packed wire,
    Engine.call_packed / call_packed_delta / call_packed_chunk, replay,
    record / play) at full width, shipped weights, stem "pallas2", grid
    and kNN "pallas", on SyntheticScene seed 0 with the default traffic:

    - the wire: bytes per frame of each mode; Obs.unpack / unpack_delta on
      the card bit-equal to the CPU's on the same buffers (480x640 and
      KITTI's 375x1242, whose cloud starts at unaligned offsets) and free
      of host syncs (torch.cuda.set_sync_debug_mode("error")); their
      device launches and time;
    - warmup seconds; the pageable and pinned host->device bandwidth and
      plan_wire's decision on the pageable one (the engine's copy);
    - per-frame packed (rgb8 / f32, host buffers) against the typed tick
      over STREAM_TICKS frames, f32 and bf16, and STREAM_EXT_TICKS
      extension frames: bit-equal occupancy_i8 and equal box counts every
      tick, each counter from 0: the stem, CSP, grid (or carve) and kNN
      kernels once a tick; the same frames free-running (no sync between
      ticks) through the engine's pageable copies and through a PinnedRing
      of 2, STREAM_PAIRS alternating pairs, each bit-equal, their rates,
      and the host time of one upload each way;
    - each wire (rgb8 / f32, yuv420 / f16) against the JAX package's ticks
      on the same buffers (tests/fixtures/stream_wire_jax.npz): >= 99 %
      of occupancy_i8 equal, equal box counts; yuv420 / f16 against the
      lossless wire: the share of cells within one int8 step within 1e-4
      of the JAX package's own share on every tick, and >= 99 % where the
      JAX package's is (it is 97.8 % from the third tick on: the lossy
      frame moves the poses);
    - replay, replay_delta and replay_chunked (K = STREAM_CHUNK) over
      STREAM_REPLAY_TICKS frames (delta and chunked bit-equal to the
      per-frame replay's final state), replay_ring and the typed replay's
      rates; a recording of the same frames played back (record_scene,
      play): equal to the per-frame replay's final grid;
    - device launches and time of the unpacks and of a packed tick
      against a typed one, profiled after every host-clock timing.

    Returns the launches of the f32, bf16 and extension packed runs."""
    import numpy as np
    from grid_vision_tpu_torch import pipeline, types
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime import record, stream
    scfg = dataclasses.replace(cfg, detector_stem_backend="pallas2")

    def scene_of(c):
        scene = SyntheticScene(c, seed=0)
        scene.add_default_traffic()
        return scene

    def engine_of(c):
        return pipeline.Engine(c, extrinsics=extrinsics, params=nets,
                               device=dev, base_dir=root)

    def ticks(eng, inputs, call, sync_each=True):
        state, outs, times = eng.init_state(), [], []
        torch.cuda.synchronize()
        t_all = time.perf_counter()
        for x in inputs:
            t0 = time.perf_counter()
            state, out = call(state, x)
            if sync_each:
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        torch.cuda.synchronize()
        return state, outs, times, len(inputs) / (time.perf_counter() - t_all)

    res = {}
    # the wire
    wire = {}
    for codec in ("rgb8", "yuv420"):
        for cloud in ("float32", "float16"):
            c = dataclasses.replace(scfg, wire_image_codec=codec,
                                    wire_cloud_dtype=cloud)
            wire[f"{codec}/{cloud}"] = types.Obs.packed_nbytes(c)
    h, w, p = scfg.camera_image_height, scfg.camera_image_width, \
        scfg.max_points
    wire["delta/float32"] = types.delta_nbytes(scfg)
    wire["typed_obs_f32"] = h * w * 3 * 4 + p * 16 + 4 + 2
    res["bytes_per_frame"] = wire

    profiled = {}          # name -> call, profiled after the host timings
    for size in ((480, 640), (374, 1242), (375, 1242)):
        for codec in ("rgb8", "yuv420"):
            if codec == "yuv420" and size[0] % 2:
                continue
            for cloud in ("float32", "float16"):
                c = dataclasses.replace(
                    scfg, camera_image_height=size[0],
                    camera_image_width=size[1], wire_image_codec=codec,
                    wire_cloud_dtype=cloud)
                scene = scene_of(c)
                buf, _ = stream.packed_from_scene(scene, 0.0, c)
                host = {"unpack": types.Obs.unpack(torch.from_numpy(buf), c)}
                dbuf = torch.from_numpy(buf).to(dev)
                # (defaults bind this iteration's values: the calls are
                # profiled after the loop)
                calls = {"unpack": lambda b=dbuf, c=c: types.Obs.unpack(b, c)}
                if codec == "rgb8":
                    hr, wr = types.delta_roi_shape(c)
                    img = np.clip(scene.image_at(0.1), 0, 255).astype(
                        np.uint8)
                    xyz, inten, n, _ = types.PointCloud.pack_host(
                        scene.cloud_at(0.1), None, c.max_points)
                    dhost = torch.from_numpy(types.pack_delta_bytes(
                        img[5:5 + hr, 7:7 + wr], 5, 7, xyz, inten, n, True,
                        True, c))
                    host["unpack_delta"] = types.unpack_delta(
                        dhost, host["unpack"].image, c)
                    ddev, prev = dhost.to(dev), host["unpack"].image.to(dev)
                    calls["unpack_delta"] = (
                        lambda b=ddev, p=prev, c=c: types.unpack_delta(b, p, c))
                torch.cuda.synchronize()
                for name, fn in calls.items():
                    what = f"{name} {size[0]}x{size[1]} {codec}/{cloud}"
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        g = fn()
                    except RuntimeError as e:
                        fail(f"{what} synchronizes with the host: {e}")
                    finally:
                        torch.cuda.set_sync_debug_mode(0)
                    r = host[name]
                    for field, a, b in (
                            ("image", g.image, r.image),
                            ("xyz", g.cloud.xyz, r.cloud.xyz),
                            ("intensity", g.cloud.intensity,
                             r.cloud.intensity),
                            ("count", g.cloud.count, r.cloud.count),
                            ("flags", torch.stack([g.has_image,
                                                   g.has_cloud]),
                             torch.stack([r.has_image, r.has_cloud]))):
                        if not torch.equal(a.cpu(), b):
                            fail(f"{what}: {field} on the card differs from "
                                 f"the CPU's")
                    profiled[what] = fn
    res["unpack_sync_debug_mode"] = "error"
    res["unpack_bit_equal_to_cpu"] = True

    eng = engine_of(scfg)
    t0 = time.perf_counter()
    eng.warmup()
    res["warmup_s"] = time.perf_counter() - t0
    bw_pageable = stream.probe_link_bandwidth(dev)
    bw_pinned = pinned_link_bandwidth(torch, dev)
    plan = stream.plan_wire(scfg, scene_of(scfg), bw_pageable)
    res["link_bytes_per_s"] = dict(pageable=bw_pageable, pinned=bw_pinned)
    res["plan_wire"] = dataclasses.asdict(plan)

    # per-frame packed against typed, counters from zero
    f32_want = dict(detector_stem=STREAM_TICKS, detector_csp=STREAM_TICKS,
                    grid_update=STREAM_TICKS, knn_median_depth=STREAM_TICKS)
    launches = {}
    ext = dict(compat=False, raycast_free_space=True,
               vision_depth_refine=True, class_aware_nms=True)
    for mode, c, n, want in (
            ("f32", scfg, STREAM_TICKS, f32_want),
            ("bf16", dataclasses.replace(scfg, compute_dtype="bfloat16"),
             STREAM_TICKS, dict(detector_stem_bf16=STREAM_TICKS,
                                detector_csp_bf16=STREAM_TICKS,
                                grid_update=STREAM_TICKS,
                                knn_median_depth=STREAM_TICKS)),
            ("extension", dataclasses.replace(scfg, **ext), STREAM_EXT_TICKS,
             dict(detector_stem=STREAM_EXT_TICKS,
                  detector_csp=STREAM_EXT_TICKS,
                  knn_median_depth=STREAM_EXT_TICKS,
                  carve_update=STREAM_EXT_TICKS))):
        e = eng if mode == "f32" else engine_of(c)
        scene = scene_of(c)
        bufs = [stream.packed_from_scene(scene, i / 10.0, c)[0]
                for i in range(n)]
        obs = [stream.obs_from_scene(scene, i / 10.0, c, dev)
               for i in range(n)]
        _, typed, typed_ms, _ = ticks(e, obs, e)
        (_, packed, packed_ms, _), got = _counted(
            modules, forms, lambda: ticks(e, bufs, e.call_packed), want,
            f"stream {mode} packed run")
        _same_ticks(torch, f"stream {mode} packed vs typed", packed, typed)
        launches[mode] = got
        # host-clock ticks in turns: typed, packed (above), packed, typed
        packed_ms2 = ticks(e, bufs, e.call_packed)[2]
        typed_ms2 = ticks(e, obs, e)[2]
        row = dict(ticks=n, launches=got,
                   median_typed_tick_ms=[statistics.median(typed_ms),
                                         statistics.median(typed_ms2)],
                   median_packed_tick_ms=[statistics.median(packed_ms),
                                          statistics.median(packed_ms2)],
                   boxes_per_tick=[int(o.boxes.valid.sum()) for o in packed],
                   poses_per_tick=[int(o.poses.valid.sum()) for o in packed])
        if mode == "f32":
            # free-running (no sync between ticks): the engine's pageable
            # copies against a pinned ring of 2, STREAM_PAIRS pairs, the
            # side that runs first alternating, each run bit-equal to the
            # typed ticks; then the host time of one upload (the card idle
            # before it), in turns
            pinned = PinnedRing(torch, dev, slots=2)
            uploads = {"pageable": e.upload, "pinned_ring": pinned}
            rates = {"pageable": [], "pinned_ring": []}
            upload_ms = {"pageable": [], "pinned_ring": []}
            pair = tuple(uploads.items())
            for name, up in [x for k in range(STREAM_PAIRS)
                             for x in (pair if k % 2 == 0 else pair[::-1])]:
                _, free, _, hz = ticks(
                    e, bufs[:STREAM_REPLAY_TICKS],
                    lambda st, b, up=up: pipeline.step_packed(
                        e.params, st, up(b), e.extrinsics, e.cfg),
                    sync_each=False)
                _same_ticks(torch, f"stream free-running {name}", free,
                            typed[:STREAM_REPLAY_TICKS])
                rates[name].append(hz)
            for name, up in pair * 2:
                times = []
                for b in bufs:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    up(b)
                    times.append((time.perf_counter() - t0) * 1e3)
                upload_ms[name].append(statistics.median(times))
            torch.cuda.synchronize()
            row["free_running_hz"] = rates
            row["upload_host_ms"] = upload_ms
            # a packed tick's device launches and time against a typed
            # one (profiled at the end of the phase)
            s0 = e.init_state()
            dbuf = torch.from_numpy(bufs[0]).to(dev)
            b0, o0 = bufs[0], obs[0]
            profiled["tick typed"] = lambda e=e: e(s0, o0)
            profiled["tick packed, host buffer"] = (
                lambda e=e: e.call_packed(s0, b0))
            profiled["tick packed, device buffer"] = (
                lambda e=e: e.call_packed(s0, dbuf))
        res[mode] = row
        del typed, packed, obs
        torch.cuda.empty_cache()

    # the lossy wire against the lossless one, each wire's ticks against
    # the JAX package's on the same buffers (tests/fixtures/
    # stream_wire_jax.npz, written by tools/jax_stream_fixture.py): >= 99 %
    # of occupancy_i8 equal and equal box counts every tick; the share of
    # cells within one int8 step between the wires within 1e-4 of the JAX
    # package's own share on every tick, and >= 99 % where that is
    ref = np.load(os.path.join(root, "tests", "fixtures",
                               "stream_wire_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    grids, wires = {}, {}
    for wire, flags in meta["wires"].items():
        c = dataclasses.replace(scfg, **flags)
        e = engine_of(c)
        scene = scene_of(c)
        bufs = [stream.packed_from_scene(scene, i / 10.0, c)[0]
                for i in range(meta["ticks"])]
        _, outs, _, _ = ticks(e, bufs, e.call_packed)
        agree = []
        for i, o in enumerate(outs):
            key = f"{wire}/{i}/"
            if int(o.boxes.valid.sum()) != int(ref[key + "boxes_valid"].sum()):
                fail(f"stream {wire} tick {i}: box count differs from the "
                     f"JAX package's")
            agree.append(float((o.occupancy_i8.cpu().numpy()
                                == ref[key + "occupancy_i8"]).mean()))
        if min(agree) < 0.99:
            fail(f"stream {wire}: occupancy_i8 against the JAX package "
                 f"{agree}")
        grids[wire] = outs
        wires[wire] = dict(occupancy_i8_agreement_with_jax=agree,
                           boxes_per_tick=[int(o.boxes.valid.sum())
                                           for o in outs])
    shares = _same_ticks(torch, "yuv420/f16", grids["yuv420_f16"],
                         grids["rgb8_f32"], exact=False)
    jax_shares = [float(x) for x in ref["within_one_step"]]
    for i, (got, theirs) in enumerate(zip(shares, jax_shares)):
        if abs(got - theirs) > 1e-4 or (theirs >= 0.99 and got < 0.99):
            fail(f"yuv420/f16 against lossless, tick {i}: {got} within one "
                 f"step (the JAX package: {theirs})")
    res["yuv420_f16"] = dict(wires, within_one_step=shares,
                             jax_within_one_step=jax_shares)
    del grids

    # replays: per frame, ROI delta, chunked, ring, typed; record / play
    n = STREAM_REPLAY_TICKS
    per_frame = stream.replay(eng, scene_of(scfg), n)
    delta = stream.replay_delta(eng, scene_of(scfg), n)
    chunked = stream.replay_chunked(eng, scene_of(scfg), n,
                                    chunk=STREAM_CHUNK)
    for name, r in (("replay_delta", delta), ("replay_chunked", chunked)):
        if not (torch.equal(r.final_state.log_odds,
                            per_frame.final_state.log_odds)
                and torch.equal(r.final_state.rng,
                                per_frame.final_state.rng)):
            fail(f"{name}'s final state differs from the per-frame replay")
    ring = stream.replay_ring(eng, scene_of(scfg), STREAM_RING,
                              chunk=STREAM_CHUNK, ring=STREAM_RING)
    typed = stream.replay(eng, scene_of(scfg), n, packed=False)
    if not torch.equal(typed.final_state.log_odds,
                       per_frame.final_state.log_odds):
        fail("the typed replay's final state differs from the packed one")
    path = os.path.join(root, "build", "stream_smoke.gvr")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    record.record_scene(path, scfg, n, seed=0)
    n_played, played = record.play(path, chunk=STREAM_CHUNK, device=dev,
                                   base_dir=root)
    os.remove(path)
    if n_played != n or not torch.equal(played.log_odds,
                                        per_frame.final_state.log_odds):
        fail("play of the recording differs from the per-frame replay")
    enc = delta.delta_encoder
    res["replay_hz"] = dict(
        replay=per_frame.achieved_hz, replay_delta=delta.achieved_hz,
        replay_chunked=chunked.achieved_hz, replay_ring=ring.achieved_hz,
        replay_typed=typed.achieved_hz)
    res["replay"] = dict(frames=n, chunk=STREAM_CHUNK,
                         ring_frames=STREAM_RING,
                         delta_keyframes=enc.keyframes,
                         delta_records=enc.deltas,
                         delta_and_chunked_bit_equal=True,
                         play_equals_replay=True)
    # device time and launches a call, after every host-clock timing: once
    # the profiler has run in a process, each launch costs the host more
    res["device_profile"] = {}
    for name, fn in profiled.items():
        ms, n_launch = device_profile(torch, fn, iters=3)
        res["device_profile"][name] = dict(device_ms=ms,
                                           device_launches=n_launch)
    phase("stream", **res)
    return launches


TRACK_INT_FIELDS = ("id", "valid", "hits", "misses", "age", "label",
                    "has_pose", "next_id")
TRACK_STATS = ("matched", "spawned", "killed", "spawn_dropped", "reacquired")


def track_margins(torch, tracking, prev, out, dt, cfg, tcfg):
    """Where a tick's integer track fields differ between two runs: the
    least distance of a candidate pair's IoU from iou_min, and of a lost
    track's 3D distance from its re-acquisition radius (the comparisons an
    ulp can flip), from the state the tick started with (one rig)."""
    pred = tracking._fma(prev.vel_px, dt, prev.xyxy)
    iou = tracking.cross_iou(pred, out.boxes.xyxy)
    pair = prev.valid[:, None] & out.boxes.valid[None, :]
    det_pos = tracking.per_box_pose(out, cfg)[0]
    coast = tracking._fma(prev.velocity, dt, prev.position)
    dist = tracking._norm3(coast[:, None, :] - det_pos[None, :, :])
    radius = (tcfg.reacq_radius + tcfg.reacq_radius_rate
              * (prev.misses + 1).float() * dt)
    lost = prev.valid & (prev.misses + 1 > tcfg.max_misses) & prev.has_pose
    cand = lost[:, None] & out.boxes.valid[None, :]
    return dict(
        iou_margin=((iou - tcfg.iou_min).abs()[pair].min().item()
                    if pair.any() else None),
        radius_margin=((dist - radius[:, None]).abs()[cand].min().item()
                       if cand.any() else None))


def tracked_phases(torch, dev, root, cfg, nets, extrinsics, fleet_cfg,
                   fleet_obs, modules, forms, card):
    """Phase `tracked`: the multi-object tracker (ops/tracking.py) behind
    the ported tick, Engine.call_tracked and the rig-batched update_tracks.

    1. The single rig at full width, shipped weights, f32 compat, stem
       "pallas2", grid and kNN "pallas", SyntheticScene seed 0 with the
       default traffic, dt = 0.1: TRACKED_TICKS call_tracked ticks against
       the plain backends tick by tick (integer track fields, confirmed()
       and TrackStats equal; a flip fails with its tick and the least IoU
       margin to iou_min of that tick), TRACKED_PCA_TICKS in the PCA
       branch, TRACKED_EXT_TICKS in extension mode; the kernels counted
       from zero; at least one track confirmed.
    2. The kernel path's first ticks against tests/fixtures/tracked_jax.npz
       (integer fields equal, positions within 1e-3 m, velocities within
       1e-2 m/s, box counts equal), and forecast_occupancy of the JAX
       package's final state, carried across, within 1e-5.
    3. The seed-0 250-frame MOT replay (train/eval_tracking, PCA-aligned
       poses) on the card and on the CPU: equal MOT metrics.
    4. The fleet: N_RIGS rigs of the fleet pool, budget BUDGET, the tick
       then the rig-batched update_tracks (capacity 32) for FLEET_TICKS
       ticks in f32 and in bf16, bit-equal to N_RIGS single-rig calls on
       the same outputs; a 3-horizon forecast of every rig every 5th tick
       (the JAX package's "tracked + forecast at publish cadence").
    5. The cost: host syncs in update_tracks (1 and N_RIGS rigs) and in the
       fleet forecast under torch.cuda.set_sync_debug_mode("error") (any
       fails the run); device ms and launches a tracker call (profiler),
       at 1 and N_RIGS rigs, and of the fleet forecast; the tracked tick
       against the untracked one, medians of TRACKED_PAIRS alternating
       pairs; the fleet forecast's peak memory (over TRACKED_PEAK_GB
       fails); the phase's seconds.

    Returns the kernel launches of the f32 and bf16 tracked fleet runs and
    of the tracked extension run."""
    import numpy as np
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.ops import tracking
    from grid_vision_tpu_torch.runtime.stream import obs_from_scene
    from grid_vision_tpu_torch.train import eval_tracking
    t_phase = time.perf_counter()
    dt = 0.1
    tcfg = tracking.TrackConfig()
    plain_flags = dict(detector_stem_backend="xla",
                       orientation_stem_backend="xla", grid_backend="xla",
                       knn_backend="xla")
    kern_cfg = dataclasses.replace(cfg, detector_stem_backend="pallas2",
                                   grid_backend="pallas",
                                   knn_backend="pallas")
    scene = SyntheticScene(kern_cfg, seed=0)
    scene.add_default_traffic()
    obs_seq = [obs_from_scene(scene, i * dt, kern_cfg, dev)
               for i in range(TRACKED_TICKS)]

    def tracked_run(c, n):
        eng = pipeline.Engine(c, extrinsics=extrinsics, params=nets,
                              device=dev, base_dir=root)
        state, tracks = eng.init_state(), eng.init_tracks(tcfg)
        rows = []
        for obs in obs_seq[:n]:
            prev = tracks
            state, tracks, out, stats = eng.call_tracked(state, tracks, obs,
                                                         dt=dt, tcfg=tcfg)
            rows.append((prev, tracks, out, stats))
        torch.cuda.synchronize()
        return rows

    def same_tracks(what, c, rows, ref_rows):
        """Integer track fields, confirmed() and TrackStats equal every
        tick; returns the float fields' max |diff|."""
        err = {}
        for i, ((prev, a, out, sa), (_, b, _, sb)) in enumerate(
                zip(rows, ref_rows)):
            bad = [n for n in TRACK_INT_FIELDS
                   if not torch.equal(getattr(a, n), getattr(b, n))]
            bad += [n for n in TRACK_STATS
                    if not torch.equal(getattr(sa, n), getattr(sb, n))]
            if not torch.equal(a.confirmed(tcfg), b.confirmed(tcfg)):
                bad.append("confirmed")
            if bad:
                margins = track_margins(torch, tracking, prev, out, dt, c,
                                        tcfg)
                fail(f"{what} tick {i}: {bad} differ from the plain path; "
                     f"{margins}")
            for f in dataclasses.fields(a):
                if f.name not in TRACK_INT_FIELDS:
                    d = (getattr(a, f.name) - getattr(b, f.name)).abs()
                    err[f.name] = max(err.get(f.name, 0.0),
                                      float(d.max()) if d.numel() else 0.0)
        return err

    res = dict(card=card, dt=dt, track_config=dataclasses.asdict(tcfg))
    # 1. the single rig: kernels against plain, the PCA branch, extension
    runs = {}
    for mode, flags, n, want in (
            ("compat", {}, TRACKED_TICKS,
             ("detector_stem", "detector_csp", "grid_update",
              "knn_median_depth")),
            ("pca", dict(use_vision_orientation=False), TRACKED_PCA_TICKS,
             ("detector_stem", "detector_csp", "grid_update",
              "knn_median_depth")),
            ("extension", dict(compat=False, raycast_free_space=True,
                               vision_depth_refine=True,
                               class_aware_nms=True), TRACKED_EXT_TICKS,
             ("detector_stem", "detector_csp", "carve_update",
              "knn_median_depth"))):
        kc = dataclasses.replace(kern_cfg, **flags)
        rows, launches = _counted(
            modules, forms, lambda: tracked_run(kc, n),
            {name: n for name in want}, f"tracked {mode} run")
        ref_rows = tracked_run(dataclasses.replace(kc, **plain_flags), n)
        err = same_tracks(f"tracked {mode}", kc, rows, ref_rows)
        confirmed = [int(r[1].confirmed(tcfg).sum()) for r in rows]
        runs[mode] = rows
        res[mode] = dict(ticks=n, launches=launches,
                         boxes_per_tick=[int(r[2].boxes.valid.sum())
                                         for r in rows],
                         confirmed_per_tick=confirmed,
                         next_id=int(rows[-1][1].next_id),
                         matched=sum(int(r[3].matched) for r in rows),
                         max_abs_float_diff_vs_plain=err)
        if mode == "compat" and not max(confirmed) > 0:
            fail("the single-rig tracked run confirmed no track")
        if mode == "extension":
            ext_launches = launches

    # 2. the kernel path against the JAX package's fixture
    ref = np.load(os.path.join(root, "tests", "fixtures", "tracked_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    if meta["dt"] != dt or meta["ticks"] > TRACKED_TICKS:
        fail(f"the tracked fixture's dt / ticks {meta['dt']} / "
             f"{meta['ticks']} do not fit this phase")
    fx_err = {"position": 0.0, "velocity": 0.0}
    for i in range(meta["ticks"]):
        _, tr, out, stats = runs["compat"][i]
        if int(out.boxes.valid.sum()) != int(ref[f"{i}/n_boxes"]):
            fail(f"tracked fixture tick {i}: box count differs")
        for name in meta["fields"]:
            got = getattr(tr, name).cpu().numpy()
            want = ref[f"{i}/tracks/{name}"]
            if name in TRACK_INT_FIELDS:
                if not np.array_equal(got, want):
                    fail(f"tracked fixture tick {i}: {name} differs from "
                         f"the JAX package")
            else:
                d = float(np.abs(got - want).max())
                bar = 1e-2 if name == "velocity" else 1e-3
                if name in fx_err:
                    fx_err[name] = max(fx_err[name], d)
                if d > bar:
                    fail(f"tracked fixture tick {i}: {name} off by {d}")
        for name in meta["stats"]:
            if int(getattr(stats, name)) != int(ref[f"{i}/stats/{name}"]):
                fail(f"tracked fixture tick {i}: TrackStats.{name} differs")
    last = meta["ticks"] - 1
    carried = tracking.track_state_from_numpy(
        {name: ref[f"{last}/tracks/{name}"] for name in meta["fields"]},
        dev)
    fc = tracking.forecast_occupancy(carried, meta["horizons"], cfg, tcfg)
    fc_err = float(np.abs(fc.cpu().numpy() - ref["forecast"]).max())
    if fc_err > 1e-5:
        fail(f"forecast of the JAX package's final state off by {fc_err}")
    res["jax_fixture"] = dict(ticks=meta["ticks"], max_abs_diff=fx_err,
                              forecast_max_abs_diff=fc_err)
    del runs, obs_seq

    # 3. the MOT replay on the card and on the CPU
    pcfg = dataclasses.replace(cfg, use_vision_orientation=False)
    frames = eval_tracking.simulate(
        eval_tracking.make_crossing_scenario(0, 250), pcfg, 250, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = eval_tracking.run_tracker(frames, pcfg, tcfg, device=dev)
    replay_s = time.perf_counter() - t0
    mot = eval_tracking.mot_metrics(frames, snaps)
    mot_cpu = eval_tracking.mot_metrics(frames, eval_tracking.run_tracker(
        frames, pcfg, tcfg, device="cpu"))
    if mot != mot_cpu:
        fail(f"MOT metrics on the card {mot} differ from the CPU's {mot_cpu}")
    res["mot"] = dict({k: mot[k] for k in (
        "mota", "idf1", "id_switches", "fp", "fn", "n_gt")},
        frames=250, replay_ms_per_frame=replay_s * 1e3 / 250,
        equals_cpu=True)

    # 4. the fleet: tick, rig-batched tracker, forecast every 5th tick
    fleets = {}
    for dtype, want in (("f32", ("detector_stem", "detector_csp",
                                 "orient_front", "grid_update",
                                 "knn_median_depth")),
                        ("bf16", ("detector_stem_bf16", "detector_csp_bf16",
                                  "orient_front_bf16", "grid_update",
                                  "knn_median_depth"))):
        fc_cfg = (fleet_cfg if dtype == "f32" else dataclasses.replace(
            fleet_cfg, compute_dtype="bfloat16"))
        eng = pipeline.Engine(fc_cfg, extrinsics=extrinsics, params=nets,
                              device=dev)
        fobs = (fleet_obs if dtype == "f32" else [
            dataclasses.replace(o, image=o.image.to(torch.bfloat16))
            for o in fleet_obs])

        def fleet_run():
            states = eng.init_states(N_RIGS)
            tracks = tracking.TrackState.create(tcfg, dev, rigs=N_RIGS)
            rows, forecasts = [], 0
            for i, obs in enumerate(fobs):
                states, out = eng.fleet(states, obs, BUDGET)
                prev = tracks
                tracks, stats = tracking.update_tracks(tracks, out, dt,
                                                       fc_cfg, tcfg)
                if i % 5 == 0:
                    tracking.forecast_occupancy(tracks, FORECAST_HORIZONS,
                                                fc_cfg, tcfg)
                    forecasts += 1
                rows.append((prev, out, tracks, stats))
            torch.cuda.synchronize()
            return rows, forecasts

        (rows, n_fc), launches = _counted(
            modules, forms, fleet_run, {name: len(fobs) for name in want},
            f"tracked fleet {dtype} run")
        for i, (prev, out, tracks, stats) in enumerate(rows):
            for r in range(N_RIGS):
                one, one_stats = tracking.update_tracks(
                    prev.select(r), out.select(r), dt, fc_cfg, tcfg)
                for f in dataclasses.fields(one):
                    if not torch.equal(getattr(tracks, f.name)[r],
                                       getattr(one, f.name)):
                        fail(f"tracked fleet {dtype} tick {i} rig {r}: "
                             f"{f.name} of the batched tracker differs from "
                             f"the single-rig call")
                for n in TRACK_STATS:
                    if not torch.equal(getattr(stats, n)[r],
                                       getattr(one_stats, n)):
                        fail(f"tracked fleet {dtype} tick {i} rig {r}: "
                             f"TrackStats.{n} differs")
        last = rows[-1][2]
        fleets[dtype] = dict(ticks=len(fobs), launches=launches,
                             forecasts=n_fc, batched_equals_per_rig=True,
                             confirmed_last=int(last.confirmed(tcfg).sum()),
                             tracks_last=int(last.valid.sum()),
                             matched=sum(int(r[3].matched.sum())
                                         for r in rows))
        if dtype == "f32":
            fleet_launches = launches
            fleet_eng, fleet_rows = eng, rows
        else:
            bf_launches = launches
        del rows
    res["fleet"] = fleets

    # 5. the cost: syncs, device time and launches, the tick, memory
    _, out_f, tracks_f, _ = fleet_rows[-1]
    eng1 = pipeline.Engine(kern_cfg, extrinsics=extrinsics, params=nets,
                           device=dev, base_dir=root)
    obs1 = obs_from_scene(scene, 0.0, kern_cfg, dev)
    state1, tracks1 = eng1.init_state(), eng1.init_tracks(tcfg)
    for i in range(3):
        state1, tracks1, out1, _ = eng1.call_tracked(state1, tracks1,
                                                     obs1, dt=dt, tcfg=tcfg)
    calls = {
        "update_tracks_1_rig": lambda: tracking.update_tracks(
            tracks1, out1, dt, kern_cfg, tcfg),
        f"update_tracks_{N_RIGS}_rigs": lambda: tracking.update_tracks(
            tracks_f, out_f, dt, fleet_cfg, tcfg),
        f"forecast_{N_RIGS}_rigs": lambda: tracking.forecast_occupancy(
            tracks_f, FORECAST_HORIZONS, fleet_cfg, tcfg)}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            torch.cuda.set_sync_debug_mode(0)
            fail(f"{name} synchronizes with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls[f"forecast_{N_RIGS}_rigs"]()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if peak > TRACKED_PEAK_GB * 2 ** 30:
        fail(f"the fleet forecast peaks at {peak / 2 ** 30:.2f} GiB")
    # the tracked tick against the untracked one, alternating pairs
    plain_ms, tracked_ms = [], []
    state_a, state_b, tracks_b = state1, state1, tracks1
    for k in range(TRACKED_PAIRS):
        order = ("plain", "tracked") if k % 2 == 0 else ("tracked", "plain")
        for which in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if which == "plain":
                state_a, _ = eng1(state_a, obs1)
            else:
                state_b, tracks_b, _, _ = eng1.call_tracked(
                    state_b, tracks_b, obs1, dt=dt, tcfg=tcfg)
            torch.cuda.synchronize()
            (plain_ms if which == "plain" else tracked_ms).append(
                (time.perf_counter() - t0) * 1e3)
    host_ms = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        host_ms[name] = (time.perf_counter() - t0) * 1e3 / 5
    # device time and launches, after every host-clock timing
    profiled = {name: dict(zip(("device_ms", "device_launches"),
                               device_profile(torch, fn, iters=3)),
                           host_clock_ms=host_ms[name])
                for name, fn in calls.items()}
    res["cost"] = dict(
        sync_debug_mode="error", host_syncs=0, calls=profiled,
        untracked_tick_ms=plain_ms, tracked_tick_ms=tracked_ms,
        untracked_median_tick_ms=statistics.median(plain_ms),
        tracked_median_tick_ms=statistics.median(tracked_ms),
        forecast_peak_memory_gib=peak / 2 ** 30,
        forecast_horizons=list(FORECAST_HORIZONS))
    res["seconds"] = time.perf_counter() - t_phase
    phase("tracked", **res)
    del fleet_eng, fleet_rows
    torch.cuda.empty_cache()
    return fleet_launches, bf_launches, ext_launches


def synced_ms(torch, fn):
    """(fn()'s result, its host-clock ms with the card synchronized before
    and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def same_grids(torch, what, got, ref):
    """occupancy_i8 bit-equal and box counts equal, tick by tick (pairs of
    StepOutputs)."""
    for i, (o, r) in enumerate(zip(got, ref)):
        if not torch.equal(o.occupancy_i8, r.occupancy_i8):
            fail(f"{what} tick {i}: occupancy_i8 differs")
        if not torch.equal(o.boxes.valid.sum(-1), r.boxes.valid.sum(-1)):
            fail(f"{what} tick {i}: box counts differ")


def hub_extrinsics(torch, extrinsics, n):
    """n rigs placed around the hub's world: rig r the shared extrinsics,
    then a yaw of 0.02 (r % 8) rad and a shift of (0.5 (r % 8), 0.5 (r // 8
    - n / 16)) m."""
    from grid_vision_tpu_torch.types import Extrinsics, stack
    out = []
    for r in range(n):
        c, s = math.cos(0.02 * (r % 8)), math.sin(0.02 * (r % 8))
        world = torch.eye(4, device=extrinsics.camera_to_base.device)
        world[0, 0], world[0, 1], world[1, 0], world[1, 1] = c, -s, s, c
        world[0, 3] = 0.5 * (r % 8)
        world[1, 3] = 0.5 * (r // 8 - n / 16)
        out.append(Extrinsics(
            lidar_to_camera=extrinsics.lidar_to_camera.clone(),
            camera_to_base=world @ extrinsics.camera_to_base))
    return stack(out)


def parallel_phases(torch, dev, root, fleet_cfg, nets, extrinsics, fleet_obs,
                    modules, forms, card):
    """Phase `parallel`: parallel/ on the card, the fleet configuration of
    bench.py at full width with the shipped weights, N_RIGS rigs of the
    fleet pool.

    1. Fleet on one shard: __call__ and compacted_step(budget_per_rig=5)
       against Engine.fleet (budget None and BUDGET) for PAR_TICKS ticks,
       occupancy_i8 bit-equal and equal box counts; each of the five
       kernels launched once a tick (counted from zero).
    2. Two logical shards on one card: compacted_step equals two
       Engine.fleet calls of half the rigs at half the budget.
    3. Fleet.tracked_step in f32 and bf16 for PAR_TRACKED_TICKS ticks
       against Engine.fleet then update_tracks: every track field and
       TrackStats bit-equal; the tracked tick's median ms.
    4. Fleet.forecast at FORECAST_HORIZONS equals the int8 of
       forecast_occupancy.
    5. Fleet.run(PAR_RUN_STEPS) equals as many calls; a save_states /
       restore_states round trip is bit-equal.
    6. SharedGrid (grid "xla") with every rig's own extrinsics: with
       orientation_budget=BUDGET on the kernel backends against the plain
       backends, >= 99.9 % occupancy_i8 and equal dropped; without a budget
       the world counts equal the sum of the rigs' lshape_hit_counts;
       call_chunk(PAR_CHUNK) equals as many calls; ms a world tick with and
       without the budget.
    7. The default CityGridSpec (4000 x 2000 cells) fed the rigs' world
       poses: one slab and four logical slabs give the same grid bit for
       bit; CityFusion.step ms and its peak memory.
    8. MultiFleet: two fleets of N_RIGS / 2 rigs on one card (f32 and
       bf16), each on its own stream: step_all bit-equal to each fleet
       stepped alone; step_all ms beside the sum of the two alone.

    Returns the phase's record."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.ops import rasterize, tracking
    from grid_vision_tpu_torch.parallel import (CityFusion, CityGrid, Fleet,
                                                MultiFleet, RigMesh,
                                                SharedGrid)
    from grid_vision_tpu_torch.parallel.city_grid import CityGridSpec
    from grid_vision_tpu_torch.parallel.shared_grid import shard_hit_counts
    from grid_vision_tpu_torch.types import stack
    from grid_vision_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    res = dict(card=card, rigs=N_RIGS)
    obs_seq = fleet_obs[:PAR_TICKS]
    one = RigMesh([dev])
    fleet = Fleet(fleet_cfg, N_RIGS, mesh=one, params=nets,
                  extrinsics=extrinsics)
    eng = pipeline.Engine(fleet_cfg, extrinsics=extrinsics, params=nets,
                          device=dev)

    def fleet_ticks(step, n_obs=obs_seq):
        states, outs = fleet.init_states(), []
        for obs in n_obs:
            states, out = step(states, obs)
            outs.append(out)
        torch.cuda.synchronize()
        return states, outs

    # 1. one shard: __call__ and compacted_step against Engine.fleet
    want = {name: len(obs_seq) for name in FLEET_KERNELS}
    (_, outs), launches = _counted(modules, forms,
                                   lambda: fleet_ticks(fleet), want,
                                   "Fleet.__call__")
    _, refs = fleet_ticks(lambda s, o: eng.fleet(s, o))
    same_grids(torch, "Fleet.__call__", outs, refs)
    (_, c_outs), c_launches = _counted(
        modules, forms,
        lambda: fleet_ticks(lambda s, o: fleet.compacted_step(s, o, 5)),
        want, "Fleet.compacted_step")
    _, c_refs = fleet_ticks(lambda s, o: eng.fleet(s, o, BUDGET))
    same_grids(torch, "Fleet.compacted_step", c_outs, c_refs)
    res["fleet"] = dict(ticks=len(obs_seq), launches=launches,
                        compacted_launches=c_launches,
                        boxes_per_tick=[int(o.boxes.valid.sum())
                                        for o in outs],
                        dropped_per_tick=[
                            int(o.saturation.orientation_dropped.sum())
                            for o in c_outs], equals_engine_fleet=True)
    del outs, refs, c_outs, c_refs

    # 2. two logical shards on one card
    half = N_RIGS // 2
    two = Fleet(fleet_cfg, N_RIGS, mesh=RigMesh([dev, dev]), params=nets,
                extrinsics=extrinsics)
    states = fleet.init_states()
    (s2, o2), l2 = _counted(
        modules, forms, lambda: two.compacted_step(states, obs_seq[0], 5),
        {name: 2 for name in FLEET_KERNELS}, "two-shard compacted_step")
    halves = [eng.fleet(states.select(slice(a, a + half)),
                        obs_seq[0].select(slice(a, a + half)), 5 * half)
              for a in (0, half)]
    if not (torch.equal(s2.log_odds, torch.cat([h[0].log_odds
                                                for h in halves]))
            and torch.equal(o2.occupancy_i8,
                            torch.cat([h[1].occupancy_i8 for h in halves]))
            and torch.equal(o2.saturation.orientation_dropped, torch.cat(
                [h[1].saturation.orientation_dropped for h in halves]))):
        fail("the two-shard compacted_step differs from two Engine.fleet "
             "calls of half the rigs")
    res["two_shards"] = dict(launches=l2, budget_per_shard=5 * half,
                             dropped=int(o2.saturation.orientation_dropped
                                         .sum()), equals_two_calls=True)
    del two, s2, o2, halves

    # 3. the tracked tick, f32 and bf16, against Engine.fleet + tracker
    tcfg = tracking.TrackConfig()
    dt = 0.1
    tracked = {}
    for dtype in ("f32", "bf16"):
        c = (fleet_cfg if dtype == "f32" else
             dataclasses.replace(fleet_cfg, compute_dtype="bfloat16"))
        f = Fleet(c, N_RIGS, mesh=one, params=nets, extrinsics=extrinsics)
        e = pipeline.Engine(c, extrinsics=extrinsics, params=nets,
                            device=dev)
        seq = [fleet_obs[i % len(fleet_obs)]
               for i in range(PAR_TRACKED_TICKS)]
        if dtype == "bf16":
            seq = [dataclasses.replace(o, image=o.image.to(torch.bfloat16))
                   for o in seq]
        s, tr = f.init_states(), f.init_tracks(tcfg)
        rs, rtr = f.init_states(), f.init_tracks(tcfg)
        times = []
        for i, obs in enumerate(seq):
            (s, tr, out, st), ms = synced_ms(
                torch, lambda: f.tracked_step(s, tr, obs, dt, tcfg))
            times.append(ms)
            rs, rout = e.fleet(rs, obs)
            rtr, rst = tracking.update_tracks(rtr, rout, dt, c, tcfg)
            bad = [x.name for x in dataclasses.fields(tr)
                   if not torch.equal(getattr(tr, x.name),
                                      getattr(rtr, x.name))]
            bad += [x.name for x in dataclasses.fields(st)
                    if not torch.equal(getattr(st, x.name),
                                       getattr(rst, x.name))]
            if bad or not torch.equal(out.occupancy_i8, rout.occupancy_i8):
                fail(f"Fleet.tracked_step {dtype} tick {i}: {bad or 'grid'}"
                     " differ from Engine.fleet + update_tracks")
        tracked[dtype] = dict(ticks=len(seq), tick_ms=times,
                              median_tick_ms=statistics.median(times),
                              tracks_last=int(tr.valid.sum()),
                              confirmed_last=int(tr.confirmed(tcfg).sum()),
                              bit_equal=True)
        if dtype == "f32":
            # 4. the forecast
            (fc, fc_ms) = synced_ms(
                torch, lambda: f.forecast(tr, FORECAST_HORIZONS, tcfg))
            ref = torch.round(tracking.forecast_occupancy(
                tr, FORECAST_HORIZONS, c, tcfg) * 100.0).to(torch.int8)
            if fc.dtype != torch.int8 or not torch.equal(fc, ref):
                fail("Fleet.forecast differs from the int8 of "
                     "forecast_occupancy")
            res["forecast"] = dict(horizons=list(FORECAST_HORIZONS),
                                   shape=list(fc.shape), ms=fc_ms,
                                   occupied_cells=int((fc > 50).sum()),
                                   equals_forecast_occupancy=True)
        del f, e, s, tr, rs, rtr
    res["tracked"] = tracked

    # 5. run and checkpoint
    run_s, run_ms = synced_ms(
        torch, lambda: fleet.run(fleet.init_states(), obs_seq[0],
                                 PAR_RUN_STEPS))
    ref_s = fleet.init_states()
    for _ in range(PAR_RUN_STEPS):
        ref_s, _ = fleet(ref_s, obs_seq[0])
    if not torch.equal(run_s.log_odds, ref_s.log_odds):
        fail("Fleet.run differs from as many calls")
    path = os.path.join(root, "build", "chip_smoke_fleet_states.npz")
    fleet.save_states(run_s, path)
    back = fleet.restore_states(path)
    os.remove(path)
    for x in dataclasses.fields(back):
        got, want = getattr(back, x.name), getattr(run_s, x.name)
        if got.device != want.device or not torch.equal(got, want):
            fail(f"the checkpoint round trip changed {x.name}")
    res["run"] = dict(steps=PAR_RUN_STEPS, ms=run_ms, equals_calls=True,
                      checkpoint_round_trip=True)
    del run_s, ref_s, back

    # 6. the fusion hub: kernel backends against plain, counts, chunks
    hub_cfg = dataclasses.replace(fleet_cfg, grid_backend="xla")
    plain_cfg = dataclasses.replace(
        hub_cfg, detector_stem_backend="xla", orientation_stem_backend="xla",
        knn_backend="xla")
    extr_b = hub_extrinsics(torch, extrinsics, N_RIGS)
    obs = obs_seq[0]
    hub = {}
    for budget in (BUDGET, None):
        sg = SharedGrid(hub_cfg, N_RIGS, mesh=one, params=nets,
                        orientation_budget=budget)
        pg = SharedGrid(plain_cfg, N_RIGS, mesh=one, params=nets,
                        orientation_budget=budget)
        lo = plo = sg.init_grid()
        times, agree, drops = [], [], []
        # the detector's stem and CSP kernels and the orientation front
        # (with or without a budget: the fleet-compacted crop batch); the
        # hub has no kNN stage, and its grid is "xla"
        want = dict(detector_stem=PAR_HUB_TICKS,
                    detector_csp=PAR_HUB_TICKS,
                    orient_front=PAR_HUB_TICKS)

        def hub_run():
            nonlocal lo
            rows = []
            for i in range(PAR_HUB_TICKS):
                (lo, occ, d), ms = synced_ms(
                    torch, lambda: sg(lo, obs, extr_b, prng.prng_key(i)))
                rows.append((occ, d, ms))
            return rows

        rows, hub_launches = _counted(modules, forms, hub_run, want,
                                      f"SharedGrid budget={budget}")
        for i, (occ, d, ms) in enumerate(rows):
            plo, pocc, pd = pg(plo, obs, extr_b, prng.prng_key(i))
            a = (rasterize.export_occupancy_i8(occ)
                 == rasterize.export_occupancy_i8(pocc)).float().mean()
            agree.append(float(a))
            drops.append(int(d))
            times.append(ms)
            if int(d) != int(pd):
                fail(f"SharedGrid budget={budget} tick {i}: dropped {int(d)}"
                     f" against the plain backends' {int(pd)}")
        if min(agree) < 0.999:
            fail(f"SharedGrid budget={budget}: occupancy_i8 agreement "
                 f"{min(agree)} with the plain backends")
        key = "budget" if budget is not None else "no_budget"
        hub[key] = dict(ticks=PAR_HUB_TICKS, tick_ms=times,
                        median_tick_ms=statistics.median(times),
                        launches=hub_launches,
                        min_occupancy_i8_agreement_vs_plain=min(agree),
                        dropped_per_tick=drops,
                        occupied_cells_last=int(
                            (rasterize.export_occupancy_i8(rows[-1][0]) > 50)
                            .sum()))
        if budget is None:
            keys = sg.step_keys(prng.prng_key(0))
            poses = sg.world_poses(obs, extr_b, keys)
            counts, _ = shard_hit_counts(sg.params, obs, extr_b, keys,
                                         hub_cfg)
            per_rig = sum(rasterize.lshape_hit_counts(poses.select(r),
                                                      hub_cfg)
                          for r in range(N_RIGS))
            if not torch.equal(counts, per_rig) or not counts.max() > 0:
                fail("the hub's world counts are not the sum of the rigs' "
                     "lshape_hit_counts (or are empty)")
            hub["world_counts"] = dict(max=float(counts.max()),
                                       cells_hit=int((counts > 0).sum()),
                                       equal_sum_of_rigs=True)
            obs_c = stack([obs_seq[i % len(obs_seq)]
                           for i in range(PAR_CHUNK)])
            (lo_c, occ_c, d_c), chunk_ms = synced_ms(
                torch, lambda: sg.call_chunk(sg.init_grid(), obs_c, extr_b,
                                             prng.prng_key(9)))
            keys_c = prng.split(prng.split(prng.prng_key(9, dev), PAR_CHUNK),
                                N_RIGS)
            lo1 = sg.init_grid()
            for t in range(PAR_CHUNK):
                lo1, occ1, _ = sg._step(lo1, obs_c.select(t), extr_b,
                                        keys_c[t])
                if not torch.equal(occ_c[t], occ1):
                    fail(f"call_chunk tick {t} differs from the call")
            if not torch.equal(lo_c, lo1):
                fail("call_chunk's grid differs from as many calls")
            hub["chunk"] = dict(k=PAR_CHUNK, ms=chunk_ms,
                                ms_per_world_tick=chunk_ms / PAR_CHUNK,
                                equals_calls=True)
            world_poses = poses
        del sg, pg
    res["shared_grid"] = hub

    # 7. the city grid: one slab against four, CityFusion's cost
    spec = CityGridSpec()
    flat = type(world_poses)(**{x.name: getattr(world_poses, x.name)
                                .flatten(0, 1)
                                for x in dataclasses.fields(world_poses)})
    c1, c4 = CityGrid(spec, mesh=one), CityGrid(spec, mesh=RigMesh([dev] * 4))
    lo1, lo4 = c1.init_grid(), c4.init_grid()
    for _ in range(PAR_CITY_TICKS):
        lo1, occ1 = c1.update(lo1, flat)
        lo4, occ4 = c4.update(lo4, flat)
    if not (torch.equal(lo1, lo4) and torch.equal(occ1, occ4)):
        fail("the city grid in four slabs differs from one slab")
    if not lo1.max() > 0:
        fail("no rig's pose reached the city grid")
    del c1, c4, lo4, occ1, occ4
    cf = CityFusion(spec, hub_cfg, N_RIGS, mesh=one, params=nets)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lo = cf.init_grid()
    times = []
    for i in range(PAR_CITY_TICKS):
        (lo, occ), ms = synced_ms(
            torch, lambda: cf.step(lo, obs, extr_b, prng.prng_key(i)))
        times.append(ms)
    peak = torch.cuda.max_memory_allocated() - base
    res["city"] = dict(shape=list(spec.shape), ticks=PAR_CITY_TICKS,
                       one_slab_equals_four=True,
                       cells_occupied=int((lo > 0).sum()),
                       fusion_tick_ms=times,
                       fusion_median_tick_ms=statistics.median(times),
                       fusion_peak_memory_gib=peak / 2 ** 30)
    del cf, lo, lo1, occ, world_poses, flat

    # 8. MultiFleet: two fleets on one card, each on its own stream
    bf = dataclasses.replace(fleet_cfg, compute_dtype="bfloat16")
    mf = MultiFleet([fleet_cfg, bf], half, mesh=RigMesh([dev, dev]),
                    params_list=[nets, nets],
                    extrinsics_list=[extrinsics, extrinsics])
    if len({id(s) for s in mf.streams}) != 2:
        fail("MultiFleet's fleets do not have a stream each")
    mobs = [(o.select(slice(0, half)),
             dataclasses.replace(o.select(slice(half, N_RIGS)),
                                 image=o.image[half:].to(torch.bfloat16)))
            for o in obs_seq]
    states = mf.init_states()
    alone = [f.init_states(100 * i) for i, f in enumerate(mf.fleets)]
    both_ms, alone_ms = [], []
    for i, pair in enumerate(mobs):
        (states, outs), ms = synced_ms(
            torch, lambda: mf.step_all(states, list(pair)))
        both_ms.append(ms)
        refs, t_sum = [], 0.0
        for f, s, o in zip(mf.fleets, alone, pair):
            r, t = synced_ms(torch, lambda: f(s, o))
            refs.append(r)
            t_sum += t
        alone_ms.append(t_sum)
        alone = [r[0] for r in refs]
        for k, (s, o, (rs, ro)) in enumerate(zip(states, outs, refs)):
            if not (torch.equal(s.log_odds, rs.log_odds)
                    and torch.equal(o.occupancy_i8, ro.occupancy_i8)
                    and torch.equal(o.boxes.xyxy, ro.boxes.xyxy)):
                fail(f"MultiFleet tick {i} fleet {k} differs from the "
                     "fleet stepped alone")
    res["multi_fleet"] = dict(
        fleets=2, rigs_per_fleet=half, compute_dtypes=["float32",
                                                      "bfloat16"],
        ticks=len(mobs), step_all_ms=both_ms, alone_sum_ms=alone_ms,
        median_step_all_ms=statistics.median(both_ms),
        median_alone_sum_ms=statistics.median(alone_ms),
        telemetry=mf.telemetry(outs), equals_alone=True)
    res["seconds"] = time.perf_counter() - t_phase
    phase("parallel", **res)
    del mf, fleet, eng
    torch.cuda.empty_cache()
    return res


def serve_phases(torch, dev, root, fleet_cfg, nets, pool, modules, forms,
                 card):
    """Phase `serve`: runtime/serve.py on the card at N_RIGS rigs, the
    fleet configuration with the shipped weights, fed synchronously:
    before each step every rig's FleetClient publishes the fleet scene
    pool's 8-bit frame and cloud of that tick.

    1. Fleet mode, f32 and bf16, SERVE_TICKS served ticks each (publish
       every tick): every rig's published grid, decoded from its mailbox,
       equals a Fleet's __call__ on the Obs the server polled (itself held
       to the pool's frames and clouds); each kernel (the bf16 forms in
       bf16) launched once a served tick, counted from zero; served
       rig-frames/s beside Engine.fleet's on the same frames on the card.
    2. The other modes, SERVE_MODE_TICKS steps each: tracked with a
       forecast at FORECAST_HORIZONS, and the fusion hub at chunk 1 and
       PAR_CHUNK (grid "xla").
    3. The CLI: `python -m grid_vision_tpu_torch serve --selftest --rigs 2
       --steps 5` in a subprocess exits 0 and prints "served 5 fleet
       steps".

    Returns (the f32 served run's launches, the bf16 run's)."""
    import numpy as np
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.parallel import Fleet, RigMesh
    from grid_vision_tpu_torch.runtime import native
    from grid_vision_tpu_torch.runtime.serve import (FleetClient,
                                                     FleetServer, rig_session)
    from grid_vision_tpu_torch.runtime.session import (FORECAST_CHANNEL,
                                                       GRID_CHANNEL,
                                                       _decode_forecast,
                                                       _decode_grid)
    from grid_vision_tpu_torch.types import PointCloud
    t_phase = time.perf_counter()
    # the servers load the configured weights (the nets), wherever the
    # script runs from
    fleet_cfg = dataclasses.replace(
        fleet_cfg, detection_weights_file=os.path.join(
            root, fleet_cfg.detection_weights_file),
        vision_weights_file=os.path.join(root, fleet_cfg.vision_weights_file))
    res = dict(card=card, rigs=N_RIGS, ticks=SERVE_TICKS)
    one = RigMesh([dev])
    # mailboxes are shared-memory paths: this run's names are its own
    tag = f"gvsmoke-{os.getpid()}"
    t0 = time.perf_counter()
    frames = [[(np.clip(s.image_at(t + 0.1 * i), 0, 255).astype(np.uint8),
                s.cloud_at(t + 0.1 * i))
               for s, t in zip(pool.scenes, pool.t0)]
              for i in range(SERVE_TICKS)]
    res["render_s"] = time.perf_counter() - t0

    def publish(clients, tick):
        for client, (img, pts) in zip(clients, frames[tick % SERVE_TICKS]):
            client.publish_image(img)
            client.publish_cloud(pts)

    def read(session, channel, decode):
        box = native.ShmMailbox(native.shm_path(session, channel))
        got = box.read()
        box.close()
        if got is None:
            fail(f"session {session} published nothing on {channel}")
        return decode(got[0])

    served, launches_served = {}, {}
    for dtype, kernels in (("f32", FLEET_KERNELS), ("bf16", BF16_KERNELS)):
        c = (fleet_cfg if dtype == "f32" else
             dataclasses.replace(fleet_cfg, compute_dtype="bfloat16"))
        name = f"{tag}-{dtype}"
        # the server loads the configured (shipped) weights, the nets
        server = FleetServer(name, c, N_RIGS, mesh=one)
        clients = [FleetClient(name, r, c) for r in range(N_RIGS)]
        ref = Fleet(c, N_RIGS, mesh=one, params=nets)
        try:
            # the polled Obs is the pool's frames and clouds (the server's
            # packer keeps a scan's first max_points points, as the JAX
            # package's server does)
            publish(clients, 0)
            polled = server.poll_batch()
            img = torch.from_numpy(np.stack([f[0] for f in frames[0]]))
            clouds = [PointCloud.pack_numpy(f[1][:c.max_points], None,
                                            c.max_points)[0]
                      for f in frames[0]]
            if (polled.image.dtype != torch.uint8
                    or not torch.equal(polled.image, img)
                    or not all(torch.equal(polled.cloud.xyz[r], cl.xyz)
                               and int(polled.cloud.count[r]) ==
                               int(cl.count)
                               for r, cl in enumerate(clouds))):
                fail(f"serve {dtype}: the polled Obs is not the pool's "
                     "8-bit frames and clouds")

            def served_run():
                """Served ticks, each split by the server itself
                (FleetServer.step's timings: poll, upload, tick, publish
                on the same step); beside each, the Obs the step polled
                (a second, untimed read of the latest-wins mailboxes) and
                the grids it published."""
                splits, polls = [], []
                for i in range(SERVE_TICKS):
                    publish(clients, i)
                    obs = server.poll_batch()
                    split = {}
                    server.step(i, split)
                    splits.append(split)
                    grids = [read(rig_session(name, r), GRID_CHANNEL,
                                  _decode_grid)[0] for r in range(N_RIGS)]
                    polls.append((obs, grids))
                return splits, polls

            (splits, polls), launches = _counted(
                modules, forms, served_run,
                {k: SERVE_TICKS for k in kernels}, f"served {dtype} run")
            parts = ("poll_ms", "upload_ms", "tick_ms", "publish_ms")
            times = [sum(sp[p] for p in parts) for sp in splits]
            rs, es = ref.init_states(), ref.init_states()
            eng_ms = []
            for i, (obs, grids) in enumerate(polls):
                dobs = obs.to(dev)
                rs, rout = ref(rs, dobs)
                (es, _), ms = synced_ms(torch, lambda: ref.engine.fleet(
                    es, dobs))
                eng_ms.append(ms)
                got = torch.from_numpy(np.stack(grids))
                if not torch.equal(got, rout.occupancy_i8.cpu()):
                    fail(f"serve {dtype} tick {i}: a published grid differs "
                         "from Fleet.__call__ on the polled Obs")
            if not torch.equal(server.states.log_odds, rs.log_odds):
                fail(f"serve {dtype}: the server's grids differ")
            served[dtype] = dict(
                # each part as the server timed it, tick by tick
                **{p: [sp[p] for sp in splits] for p in parts},
                **{f"median_{p}": statistics.median(sp[p] for sp in splits)
                   for p in parts},
                launches=launches, served_step_ms=times,
                engine_fleet_tick_ms=eng_ms,
                median_served_step_ms=statistics.median(times),
                engine_fleet_median_tick_ms=statistics.median(eng_ms),
                # every tick over all of its time
                served_rig_frames_per_s=(SERVE_TICKS * N_RIGS
                                         / sum(times) * 1e3),
                engine_fleet_rig_frames_per_s=(SERVE_TICKS * N_RIGS
                                               / sum(eng_ms) * 1e3),
                frame_bytes_per_tick=int(img.numel()),
                saturation_totals=server.saturation_totals,
                parse_errors=server.parse_errors,
                published_equals_fleet=True)
            launches_served[dtype] = launches
        finally:
            for cl in clients:
                cl.close()
            server.close()
        del server, ref
        torch.cuda.empty_cache()
    res["fleet"] = served

    # 2. the other modes: tracked with a forecast, the hub at chunk 1 and K
    modes = {}
    for mode, kw in (("tracked_forecast", dict(
            track=True, track_dt=0.1, forecast_horizons=FORECAST_HORIZONS)),
                     ("hub", dict(shared=True)),
                     ("hub_chunk", dict(shared=True, chunk=PAR_CHUNK))):
        c = (dataclasses.replace(fleet_cfg, grid_backend="xla")
             if kw.get("shared") else fleet_cfg)
        name = f"{tag}-{mode}"
        server = FleetServer(name, c, N_RIGS, mesh=one, **kw)
        clients = [FleetClient(name, r, c) for r in range(N_RIGS)]
        steps = SERVE_MODE_TICKS * (PAR_CHUNK if "chunk" in kw else 1)
        try:
            times = []
            for i in range(steps):
                publish(clients, i)
                _, ms = synced_ms(torch, lambda: server.step(i))
                times.append(ms)
            # a chunked hub computes at every PAR_CHUNK-th step: its cost
            # is the mean a world tick
            row = dict(steps=steps, tick_ms=times,
                       median_tick_ms=statistics.median(times),
                       ms_per_world_tick=sum(times) / steps)
            if mode == "tracked_forecast":
                planes, horizons, step, _ = read(rig_session(name, 0),
                                                 FORECAST_CHANNEL,
                                                 _decode_forecast)
                if planes.shape != (len(FORECAST_HORIZONS),) + tuple(
                        c.grid_size) or step != steps - 1:
                    fail("served forecast planes of the wrong shape / step")
                row.update(track_totals=server.track_totals,
                           tracks_last=int(server.tracks.valid.sum()))
            else:
                grid, step, _ = read(f"{name}-world", GRID_CHANNEL,
                                     _decode_grid)
                if grid.shape != tuple(c.grid_size) or step != steps - 1:
                    fail(f"hub {mode}: world grid of the wrong shape / step")
                lo = server.world_lo
                if not torch.isfinite(lo).all() or not lo.max() > 0:
                    fail(f"hub {mode}: no evidence in the world grid")
                row.update(dropped_total=server.dropped_total,
                           occupied_cells=int((grid > 50).sum()))
            modes[mode] = row
        finally:
            for cl in clients:
                cl.close()
            server.close()
        del server
        torch.cuda.empty_cache()
    res["modes"] = modes

    # 3. the CLI
    proc = subprocess.run(
        [sys.executable, "-m", "grid_vision_tpu_torch", "serve",
         "--selftest", "--rigs", "2", "--steps", "5", "--name",
         f"{tag}-cli"], capture_output=True, text=True, cwd=root,
        timeout=300)
    if proc.returncode != 0 or "served 5 fleet steps" not in proc.stdout:
        fail(f"serve CLI: rc {proc.returncode}, stdout {proc.stdout!r}, "
             f"stderr {proc.stderr[-2000:]!r}")
    res["cli"] = dict(rc=proc.returncode,
                      last_line=proc.stdout.strip().splitlines()[-1])
    res["seconds"] = time.perf_counter() - t_phase
    phase("serve", **res)
    return launches_served["f32"], launches_served["bf16"]


def train_step_cost(torch, kind, model_cfg, batch, lr, draw):
    """A train step of `kind` on a fixed batch: median ms over
    TRAIN_TIMED_STEPS synchronized steps and images/s, the steps' peak
    device memory above what was allocated before the train state was
    built (parameters, AdamW moments, activations, gradients), and from
    torch.profiler over TRAIN_PROFILED_STEPS steps the device's busy time,
    idle share and launches a step; `draw()`'s median ms (drawing one such
    batch on the card)."""
    from torch.profiler import ProfilerActivity, profile
    from grid_vision_tpu_torch.train import trainer
    from grid_vision_tpu_torch.utils import prng
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=100, decay_steps=8000), weight_decay=1e-5)
    state = trainer.init_train_state(
        kind, model_cfg, tx, prng.prng_key(0, device=batch[0].device))
    step = trainer.make_train_step(kind, model_cfg, tx)
    for _ in range(3):
        state, _ = step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if not torch.isfinite(metrics["loss"]):
        fail(f"{kind} train step: loss {metrics['loss'].item()}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILED_STEPS):
            state, _ = step(state, *batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILED_STEPS
    events = [e for e in prof.events()
              if e.device_type != torch.autograd.DeviceType.CPU]
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3 \
        / TRAIN_PROFILED_STEPS
    draws = []
    for _ in range(5):
        t0 = time.perf_counter()
        draw()
        torch.cuda.synchronize()
        draws.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    return dict(batch=int(batch[0].shape[0]),
                input_size=int(batch[0].shape[1]),
                dtype=str(model_cfg.compute_dtype).replace("torch.", ""),
                median_step_ms=med, step_ms=times,
                images_per_s=batch[0].shape[0] / med * 1e3,
                peak_memory_gib=peak, profiled_step_ms=wall,
                device_busy_ms=busy, device_idle_share=1.0 - busy / wall,
                device_launches_per_step=len(events) / TRAIN_PROFILED_STEPS,
                median_batch_draw_ms=statistics.median(draws))


def train_phases(torch, dev, root, fleet_cfg, fleet_obs, extrinsics, modules,
                 forms, card):
    """Phase `train`: train/ on the card.

    1. The cost of a train step: the detector at full width (416, batch
       32, bf16 as the CLI defaults) and the orientation net (224, width
       32, batch 64, bf16), each on a batch drawn on the card
       (train_step_cost).
    2. The CLI entry points: `train detector` (TRAIN_STEPS steps in chunks
       of TRAIN_SCAN, TRAIN_SCENE_FRAMES scene frames) and `train
       orientation` (TRAIN_SCENE_CROPS scene crops), every chunk run under
       torch.cuda.set_sync_debug_mode("error") (a host sync inside a chunk
       fails); the loss finite and falling (the mean of the last 10 steps
       below that of the first 10); no kernel of csrc/ launched (training
       is plain torch).
    3. The saved weights reloaded through weights.load_all (equal to the
       trained modules), then TRAIN_TICKS 64-rig fleet ticks on them, f32
       and bf16, on the kernel backends against the plain ones (the fleet
       phases' bars: compare_outputs, compare_bf16), each kernel (the bf16
       forms in bf16) once a tick; in bf16 also against the detector's
       kernels with the rest plain (the same boxes: every rig clean).

    Returns (the f32 tick's launches, the bf16 tick's)."""
    import contextlib
    import io
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.models import weights
    from grid_vision_tpu_torch.models.orientation_net import OrientationConfig
    from grid_vision_tpu_torch.models.yolov4_tiny import YoloConfig
    from grid_vision_tpu_torch.train import (fit_on_device, fit_orientation,
                                             synth_data)
    from grid_vision_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    res = dict(card=card)
    key = prng.prng_key(0, device=dev)
    nb, size = TRAIN_DET["batch"], TRAIN_DET["size"]
    ycfg = YoloConfig(input_size=size)
    res["detector_step"] = train_step_cost(
        torch, "yolo", ycfg, synth_data.make_batch_on_device(key, nb, ycfg),
        2e-3, lambda: synth_data.make_batch_on_device(key, nb, ycfg))
    ocfg = OrientationConfig(input_size=TRAIN_ORI["size"],
                             width=TRAIN_ORI["width"], s2d_fold=False)

    def crops():
        n = TRAIN_ORI["batch"]
        c, b, off = fit_orientation.render_crop(prng.split(key, n),
                                                TRAIN_ORI["size"])
        return c, torch.zeros((n, 3), device=dev), b, off

    res["orientation_step"] = train_step_cost(torch, "multibin", ocfg,
                                              crops(), 1e-3, crops)
    phase("train", path="step", **res)
    torch.cuda.empty_cache()

    # 2. the CLI's trainers, each chunk without a host sync
    out_dir = os.path.join(root, "build", "smoke_train")
    os.makedirs(out_dir, exist_ok=True)
    det_path = os.path.join(out_dir, "detector.npz")
    ori_path = os.path.join(out_dir, "orientation.npz")

    def sync_free(fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return run

    log = io.StringIO()
    chunks = (fit_on_device.run_chunk, fit_orientation.run_chunk)
    fit_on_device.run_chunk = sync_free(chunks[0])
    fit_orientation.run_chunk = sync_free(chunks[1])
    try:
        with contextlib.redirect_stdout(log):
            (det, ori), _ = _counted(modules, forms, lambda: (
                fit_on_device.main([
                    "--steps", str(TRAIN_STEPS), "--scan", str(TRAIN_SCAN),
                    "--scene-frames", str(TRAIN_SCENE_FRAMES),
                    "--batch", str(TRAIN_DET["batch"]),
                    "--input-size", str(TRAIN_DET["size"]),
                    "--out", det_path]),
                fit_orientation.main([
                    "--steps", str(TRAIN_STEPS), "--scan", str(TRAIN_SCAN),
                    "--scene-crops", str(TRAIN_SCENE_CROPS),
                    "--batch", str(TRAIN_ORI["batch"]),
                    "--input-size", str(TRAIN_ORI["size"]),
                    "--width", str(TRAIN_ORI["width"]),
                    "--out", ori_path])), {}, "train CLI")
    except RuntimeError:
        import traceback
        fail(f"train: {traceback.format_exc()[-3000:]}")
    finally:
        fit_on_device.run_chunk, fit_orientation.run_chunk = chunks
    for name, r in (("detector", det), ("orientation", ori)):
        losses = r["losses"].reshape(-1)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train {name}: non-finite loss")
        first, last = float(losses[:10].mean()), float(losses[-10:].mean())
        if not last < first:
            fail(f"train {name}: the loss did not fall ({first} -> {last})")
        res[f"{name}_cli"] = dict(
            steps=TRAIN_STEPS, scan=TRAIN_SCAN, seconds=r["seconds"],
            first_10_mean_loss=first, last_10_mean_loss=last,
            chunk_losses=[[float(c[0]), float(c[-1])] for c in r["losses"]])
    res["orientation_cli"].update(
        angle_median_deg=ori["angle_median_deg"],
        angle_p90_deg=ori["angle_p90_deg"],
        dims_median_m=ori["dims_median_m"])
    res["cli_log"] = log.getvalue().splitlines()
    phase("train", path="cli", **{k: res.pop(k) for k in (
        "detector_cli", "orientation_cli", "cli_log")})

    # 3. reload, then the fleet tick on the trained weights
    cfg_t = dataclasses.replace(fleet_cfg, detection_weights_file=det_path,
                                vision_weights_file=ori_path)
    nets_t = weights.load_all(cfg_t, device=dev)
    for name, r in (("detector", det), ("orientation", ori)):
        want = r["state"].model.state_dict()
        for k, v in nets_t[name].state_dict().items():
            if not torch.equal(v, want[k]):
                fail(f"train: reloaded {name} differs in {k}")
    del det, ori
    obs = fleet_obs[:TRAIN_TICKS]
    plain_kw = dict(detector_stem_backend="xla",
                    orientation_stem_backend="xla", grid_backend="xla",
                    knn_backend="xla")
    tick_launches = []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(fleet_cfg, compute_dtype=dtype)
        kern = pipeline.Engine(c, extrinsics=extrinsics, params=nets_t,
                               device=dev)
        plain = pipeline.Engine(dataclasses.replace(c, **plain_kw),
                                extrinsics=extrinsics, params=nets_t,
                                device=dev)
        o = obs if dtype == "float32" else [
            dataclasses.replace(x, image=x.image.to(torch.bfloat16))
            for x in obs]
        names = (list(forms) if dtype == "bfloat16" else
                 ["detector_stem", "detector_csp", "orient_front"])
        (_, outs, _), got = _counted(
            modules, forms, lambda: run_fleet(torch, kern, o, BUDGET),
            dict({n: TRAIN_TICKS for n in names},
                 grid_update=TRAIN_TICKS, knn_median_depth=TRAIN_TICKS),
            f"trained weights, {dtype} fleet")
        _, plain_outs, _ = run_fleet(torch, plain, o, BUDGET)
        if dtype == "float32":
            agree, n_boxes, n_poses = compare_outputs(
                torch, c, outs, plain_outs, per_rig=True)
            res["fleet_f32"] = dict(
                launches=got, min_occupancy_i8_agreement_per_rig=agree,
                boxes_per_tick=n_boxes, poses_per_tick=n_poses)
        else:
            res["fleet_bf16"] = dict(launches=got, **compare_bf16(
                torch, c, outs, plain_outs))
            # the same detections (the detector's kernels on both sides),
            # the rest plain: every rig-tick clean (the same boxes), the
            # orientation front, grid and kNN held to the bars on every rig
            half = pipeline.Engine(dataclasses.replace(
                c, **{k: v for k, v in plain_kw.items()
                      if k != "detector_stem_backend"}),
                extrinsics=extrinsics, params=nets_t, device=dev)
            _, half_outs, _ = run_fleet(torch, half, o, BUDGET)
            r = compare_bf16(torch, c, outs, half_outs)
            if r["clean_rig_ticks"] != N_RIGS * TRAIN_TICKS:
                fail(f"trained weights, bf16 fleet: the detector's kernels "
                     f"gave other boxes on a second engine: {r}")
            res["fleet_bf16_same_detections"] = r
            del half, half_outs
        tick_launches.append(got)
        del kern, plain, outs, plain_outs
    torch.cuda.empty_cache()
    # the bf16 forms on the trained weights against their twins, at their
    # own bars (the fleet shapes)
    det_t, net_t = nets_t["detector"], nets_t["orientation"]
    for fn, args in ((check_stem_bf16, (det_t, fleet_cfg, N_RIGS)),
                     (check_csp_bf16, (det_t, fleet_cfg, N_RIGS)),
                     (check_orient_bf16, (net_t, fleet_cfg, N_RIGS,
                                          BUDGET))):
        r = fn(torch, dev, *args)
        res[f"{r['name']}_trained"] = {k: r[k] for k in (
            "max_abs_err", "bit_equal_share", "ms", "plain_ms")
            if k in r}
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    phase("train", path="trained_weights", **res)
    return tick_launches


def eval_phases(torch, dev, root, modules, forms, card):
    """Phase `eval`: train/eval_map.py and train/eval_pose.py on the card
    with the shipped weights.

    1. mAP: EVAL_SYNTH held-out synth frames (the JAX package's keys) and
       EVAL_SCENE scene frames through pipeline.detect_batch in chunks of
       16 (eval_map.detect_images, eval confidence 0.05), on "pallas2"
       (the stem and CSP kernels, once a chunk) and on the plain backends:
       equal box counts every frame, mAP@0.5 within 1e-3 of each other,
       and on both the floors of tests/test_eval_map.py (synth >= 0.95,
       scene >= 0.85, all ten classes >= 0.5, scene Bike >= 0.72 and
       Motorbike >= 0.75).
    2. Poses: eval_pose.evaluate_poses with oracle boxes on grid and kNN
       "pallas" (each once a frame) against the floors of
       tests/test_eval_pose.py (PCA at 10 frames: >= 20 matched, median <
       0.10 m; vision at 5 frames, the refine below the faithful median;
       the refine at 15 frames: >= 30 matched, median < 0.8 m, p90 < 2.5
       m).

    Returns the launches of the mAP run on "pallas2" (both sources)."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.config import GridVisionConfig
    from grid_vision_tpu_torch.models import weights
    from grid_vision_tpu_torch.train import eval_map, eval_pose
    t_phase = time.perf_counter()
    res = dict(card=card)
    base = GridVisionConfig(
        detection_weights_file=os.path.join(root, "weights/detector.npz"),
        vision_weights_file=os.path.join(root, "weights/orientation.npz"),
        confidence_threshold=0.05)
    nets = weights.load_all(base, device=dev)
    kern_cfg = dataclasses.replace(base, detector_stem_backend="pallas2")
    map_launches = {name: 0 for name in list(modules) + list(forms)}
    for source, n in (("synth", EVAL_SYNTH), ("scene", EVAL_SCENE)):
        t0 = time.perf_counter()
        images, gts = (eval_map.heldout_synth(n, base, device=dev)
                       if source == "synth" else
                       eval_map.heldout_scene(n, base))
        render_s = time.perf_counter() - t0
        chunks = -(-n // 16)
        out = {}
        for name, c, want in (
                ("kernels", kern_cfg, dict(detector_stem=chunks,
                                          detector_csp=chunks)),
                ("plain", base, {})):
            params = pipeline.Engine(c, params=nets, device=dev).params
            t0 = time.perf_counter()
            preds, got = _counted(
                modules, forms, lambda: eval_map.detect_images(
                    params, images, c, device=dev), want,
                f"eval {source} {name}")
            seconds = time.perf_counter() - t0
            r = eval_map.score_detections(preds, gts)
            out[name] = (preds, r)
            res[f"{source}_{name}"] = dict(r.to_dict(), seconds=seconds,
                                           launches=got)
            if name == "kernels":
                for k, v in got.items():
                    map_launches[k] += v
        (kp, kr), (pp, pr) = out["kernels"], out["plain"]
        if [len(p[0]) for p in kp] != [len(p[0]) for p in pp]:
            fail(f"eval {source}: box counts per frame differ between "
                 "pallas2 and the plain backends")
        if abs(kr.map50 - pr.map50) > 1e-3:
            fail(f"eval {source}: mAP {kr.map50} (pallas2) against "
                 f"{pr.map50} (plain)")
        for name, r in (("kernels", kr), ("plain", pr)):
            aps = r.per_class_ap
            if (r.map50 < (0.95 if source == "synth" else 0.85)
                    or len(aps) != 10
                    or any(not ap >= 0.5 for ap in aps.values())
                    or (source == "scene" and (aps["Bike"] < 0.72
                                               or aps["Motorbike"] < 0.75))):
                fail(f"eval {source} ({name}) below the floors of "
                     f"tests/test_eval_map.py: {r.to_dict()}")
        res[f"{source}_render_s"] = render_s
    del nets
    torch.cuda.empty_cache()

    # 2. poses on the grid and kNN kernels
    pcfg = GridVisionConfig(
        vision_weights_file=os.path.join(root, "weights/orientation.npz"),
        grid_backend="pallas", knn_backend="pallas")
    poses = {}
    for name, mode, frames, refine in (("pca", "pca", 10, False),
                                       ("vision", "vision", 5, False),
                                       ("vision_refine5", "vision", 5, True),
                                       ("vision_refine", "vision", 15, True)):
        r, got = _counted(
            modules, forms, lambda: eval_pose.evaluate_poses(
                mode, frames, cfg=pcfg, refine=refine, device=dev),
            dict(grid_update=frames, knn_median_depth=frames),
            f"eval-pose {name}")
        poses[name] = dict(r, launches=got)
    p, v, r5, r15 = (poses[k] for k in ("pca", "vision", "vision_refine5",
                                        "vision_refine"))
    if not (p["n_matched"] >= 20 and p["pos_err_median_m"] < 0.10):
        fail(f"eval-pose pca below tests/test_eval_pose.py's floor: {p}")
    if not (r5["n_matched"] > 0
            and r5["pos_err_median_m"] < v["pos_err_median_m"]):
        fail(f"eval-pose: the refine does not improve the vision poses: "
             f"{v} {r5}")
    if not (r15["n_matched"] >= 30 and r15["pos_err_median_m"] < 0.8
            and r15["pos_err_p90_m"] < 2.5):
        fail(f"eval-pose refine below tests/test_eval_pose.py's floor: "
             f"{r15}")
    res["poses"] = poses
    res["seconds"] = time.perf_counter() - t_phase
    phase("eval", **res)
    return map_launches


def path_configs(gv):
    """The single-rig path's configuration at full width (shipped weights,
    stem / grid / kNN kernels) and the fleet configuration of
    bench.py:240-245 in f32 (stem "pallas2", orientation "pallas")."""
    cfg = gv.GridVisionConfig(
        detection_weights_file="weights/detector.npz",
        vision_weights_file="weights/orientation.npz",
        detector_stem_backend="pallas", grid_backend="pallas",
        knn_backend="pallas")
    fleet_cfg = dataclasses.replace(
        cfg, max_points=8192, max_static_depth=16,
        detector_stem_backend="pallas2", orientation_stem_backend="pallas")
    return cfg, fleet_cfg


def tf32_ticks(torch, root) -> dict:
    """One f32 single-rig Engine tick (seed-0 scene at t = 0) and one
    N_RIGS-rig f32 Engine.fleet tick (the fleet pool's tick 0, budget
    BUDGET) under whatever TF32 flags this process has: both nets' heads
    (every output of yolov4_tiny.forward and orientation_net.forward in
    the tick) and the tick's outputs, as host arrays."""
    import numpy as np
    import grid_vision_tpu_torch as gv
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.demo import default_extrinsics
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
    from grid_vision_tpu_torch.runtime.stream import FleetPool, obs_from_scene
    dev = torch.device("cuda", 0)
    cfg, fleet_cfg = path_configs(gv)
    engine = pipeline.Engine(cfg, extrinsics=default_extrinsics(dev),
                             device=dev, base_dir=root)
    fleet = pipeline.Engine(fleet_cfg, extrinsics=engine.extrinsics,
                            params={k: engine.params[k]
                                    for k in ("detector", "orientation")},
                            device=dev)
    scene = SyntheticScene(cfg, seed=0, n_ground=15000)
    scene.add_default_traffic()
    scene.add_default_statics()
    obs = obs_from_scene(scene, 0.0, cfg, dev)
    fobs = FleetPool(fleet_cfg, N_RIGS, device=dev).obs(0)
    heads = []
    nets = [(yolov4_tiny, yolov4_tiny.forward),
            (orientation_net, orientation_net.forward)]

    def recorded(fn, tag):
        def forward(*args, **kwargs):
            out = fn(*args, **kwargs)
            heads.extend((f"{tag}{len(heads)}", t) for t in out)
            return out
        return forward

    res = {}
    try:
        for mod, fn in nets:
            mod.forward = recorded(fn, mod.__name__.rsplit(".", 1)[-1])
        for tag, run in (
                ("single", lambda: engine(engine.init_state(), obs)),
                ("fleet", lambda: fleet.fleet(fleet.init_states(N_RIGS),
                                              fobs, BUDGET))):
            heads.clear()
            _, out = run()
            for name, t in heads:
                res[f"{tag}/head/{name}"] = t
            for name, t in (("occupancy_i8", out.occupancy_i8),
                            ("box_xyxy", out.boxes.xyxy),
                            ("box_confidence", out.boxes.confidence),
                            ("box_valid", out.boxes.valid),
                            ("pose_position", out.poses.position),
                            ("pose_valid", out.poses.valid),
                            ("static_depths", out.static_depths)):
                res[f"{tag}/{name}"] = t
    finally:
        for mod, fn in nets:
            mod.forward = fn
    torch.cuda.synchronize()
    return {k: np.asarray(v.detach().float().cpu() if v.is_floating_point()
                          else v.detach().cpu()) for k, v in res.items()}


def compare_tf32(np, got: dict, ref: dict) -> dict:
    """Whether `got`'s ticks (tf32_ticks) are bit-equal to `ref`'s, and the
    heads' max |diff| (what a failure prints)."""
    if set(got) != set(ref):
        fail(f"tf32 ticks hold other arrays: {sorted(set(got) ^ set(ref))}")
    heads = [k for k in ref if "/head/" in k]
    return dict(
        bit_equal=all(np.array_equal(got[k], ref[k],
                                     equal_nan=ref[k].dtype.kind == "f")
                      for k in ref),
        heads_max_abs_diff=max(float(np.abs(got[k] - ref[k]).max())
                               for k in heads))


def tf32_child(root, out_path):
    """Run tf32_ticks in a fresh process that leaves torch's flags at their
    defaults and return its arrays and its cuDNN conv setting."""
    import numpy as np
    cmd = [sys.executable, os.path.join(root, "chip_smoke.py"),
           "--tf32-ticks", out_path]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root,
                          timeout=600)
    if proc.returncode != 0:
        fail(f"tf32 child: rc {proc.returncode}, stderr "
             f"{proc.stderr[-3000:]!r}")
    with np.load(out_path) as z:
        return dict(z), proc.stdout.strip()


def tf32_main(torch, root, out_path) -> None:
    """--tf32-ticks OUT: write tf32_ticks to OUT (.npz) under torch's
    default flags (the child of tf32_phase)."""
    import numpy as np
    sys.path.insert(0, root)
    np.savez(out_path, **tf32_ticks(torch, root))
    print(json.dumps({"cudnn_conv_tf32": _conv_tf32(torch)}))


def _conv_tf32(torch):
    """cuDNN's f32 conv setting as this process left it."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return conv.fp32_precision
    return torch.backends.cudnn.allow_tf32


def tf32_phase(torch, root, card) -> None:
    """Phase `tf32_defaults`: tf32_ticks in a process that leaves every
    torch flag at its default, held bit-equal to this process's (flags
    off): the port's f32 convs run in IEEE f32 whatever the caller's
    flags (device.ieee_convs); then the `run` CLI under defaults."""
    import numpy as np
    t0 = time.perf_counter()
    out_dir = os.path.join(root, "build", "chip_smoke_tf32")
    os.makedirs(out_dir, exist_ok=True)
    child, flags = tf32_child(root, os.path.join(out_dir, "defaults.npz"))
    rep = compare_tf32(np, child, tf32_ticks(torch, root))
    if not rep["bit_equal"]:
        fail(f"f32 ticks under torch's default flags differ: {rep}")
    proc = subprocess.run(
        [sys.executable, "-m", "grid_vision_tpu_torch", "run", "--steps",
         "3"], capture_output=True, text=True, cwd=root, timeout=600)
    if proc.returncode != 0 or "replayed 3 steps" not in proc.stderr:
        fail(f"run under default flags: rc {proc.returncode}, stderr "
             f"{proc.stderr[-2000:]!r}")
    phase("tf32_defaults", card=card, child=json.loads(flags),
          parent_conv_tf32=_conv_tf32(torch), run_cli_rc=proc.returncode,
          seconds=time.perf_counter() - t0, **rep)


BENCH_CHECK_RIGS = N_RIGS
BENCH_BUDGET_S = 12


def bench_phases(torch, dev, root, modules, forms, card, fleet_bf16_rate):
    """Phase `bench`: the port's bench (grid_vision_tpu_torch/bench.py).

    1. In this process, for bench.py's defaults and for the three bf16
       kernels (GV_BENCH_STEM=pallas2 GV_BENCH_ORIENT_STEM=pallas): one
       chunk (8 ticks) at BENCH_CHECK_RIGS rigs, counters from zero, its
       digest and final grid bit-equal to the same 8 perturbed Obs through
       Engine.fleet; the bf16 stem (and with pallas2 / pallas the CSP stage
       and the orientation front) once a tick, nothing else.
    2. `python -m grid_vision_tpu_torch bench` in a subprocess for each
       mode with GV_BENCH_BUDGET_S=BENCH_BUDGET_S (128 rigs): exit 0 and a
       last stdout line {"metric": "fused_frames_per_sec", "value",
       "unit"}; the rates beside fleet_bf16's rig-frames/s.

    Returns the launches a chunk by mode."""
    import numpy as np
    from grid_vision_tpu_torch import bench, pipeline
    from grid_vision_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    res, launches = dict(card=card), {}
    for mode, env in bench.MODES.items():
        cfg, _, scan, _, budget = bench.bench_config(
            dict(env, GV_BENCH_RIGS=str(BENCH_CHECK_RIGS)))
        eng = pipeline.Engine(cfg, device=dev, base_dir=root)
        pool = bench.build_pool(cfg, BENCH_CHECK_RIGS, dev)
        key = prng.prng_key(100, device=dev)
        want = {"detector_stem_bf16": scan}
        if mode == "pallas2_pallas":
            want.update(detector_csp_bf16=scan, orient_front_bf16=scan)
        (states, acc, _), got = _counted(
            modules, forms, lambda: bench.run_chunk(
                eng.params, eng.init_states(BENCH_CHECK_RIGS), pool,
                eng.extrinsics, cfg, key, scan, budget), want,
            f"bench chunk ({mode})")
        torch.cuda.synchronize()
        launches[mode] = got
        _, sub = prng.split(key)
        bright, jitter = bench.draw_perturbations(sub, scan,
                                                  BENCH_CHECK_RIGS)
        ref_states = eng.init_states(BENCH_CHECK_RIGS)
        ref = torch.zeros((), device=dev)
        for t in range(scan):
            ref_states, out = eng.fleet(ref_states, bench.apply_perturbation(
                pool, bright[t], jitter[t]), budget)
            ref = ref + bench.output_digest(out)
        digest, ref_digest = acc.item(), ref.item()
        if not (np.array_equal(np.float32(digest), np.float32(ref_digest),
                               equal_nan=True)
                and torch.equal(states.log_odds, ref_states.log_odds)):
            fail(f"bench chunk ({mode}): digest {digest} / grid differ from "
                 f"Engine.fleet's ({ref_digest})")
        res[mode] = dict(rigs=BENCH_CHECK_RIGS, ticks=scan,
                         launches_per_chunk=got,
                         digest=digest if math.isfinite(digest) else
                         str(digest), digest_finite=math.isfinite(digest),
                         equals_engine_fleet=True)
        del eng, pool, states, ref_states, out
        torch.cuda.empty_cache()
    for mode, env in bench.MODES.items():
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "grid_vision_tpu_torch", "bench"],
            capture_output=True, text=True, cwd=root, timeout=900,
            env=dict(os.environ, GV_BENCH_BUDGET_S=str(BENCH_BUDGET_S),
                     **env))
        lines = proc.stdout.strip().splitlines()
        try:
            doc = json.loads(lines[-1])
            ok = (doc["metric"] == "fused_frames_per_sec"
                  and doc["unit"] == "frames/s"
                  and float(doc["value"]) > 0)
        except (IndexError, ValueError, KeyError, TypeError):
            ok = False
        if proc.returncode != 0 or not ok:
            fail(f"bench CLI ({mode}): rc {proc.returncode}, stdout "
                 f"{proc.stdout[-500:]!r}, stderr {proc.stderr[-2000:]!r}")
        res[mode].update(cli=doc, cli_seconds=time.perf_counter() - t0,
                         cli_log=proc.stderr.strip().splitlines()[-3:])
    res["fleet_bf16_rig_frames_per_s"] = fleet_bf16_rate
    res["seconds"] = time.perf_counter() - t_phase
    phase("bench", **res)
    return launches


def _unlink_session(name: str) -> None:
    from grid_vision_tpu_torch.runtime import native, session
    for ch in (session.GRID_CHANNEL, session.MARKERS_CHANNEL,
               session.OVERLAY_CHANNEL, session.FORECAST_CHANNEL,
               session.CLOUDVIZ_CHANNEL):
        path = native.shm_path(name, ch)
        if os.path.exists(path):
            os.remove(path)


def cli_phase(torch, dev, root, card) -> None:
    """Phase `cli`: the CLI's demo and view on the card.

    1. `demo --mode pca --det oracle --steps 6` and `demo --mode vision
       --det net --steps 6`: exit 0, their PGM / PPM / markers files at
       ticks 0 and 5; the net run's last grid (grid_005.pgm) equals the
       PGM of the last tick of runtime/stream.replay on the same scene,
       weights and configuration in this process.
    2. `run --steps 6 --publish NAME`, then `view --session NAME --http
       PORT --seconds 5`: / and /grid.png answer, one /grid.gvd record
       decodes (gvd_client) to the session's grid, the PNG's pixels equal
       grid_frame_rgb(the session's last frame, scale=2); every subprocess
       exits 0."""
    import socket
    import urllib.request
    from grid_vision_tpu_torch import demo, pipeline
    from grid_vision_tpu_torch.config import GridVisionConfig
    from grid_vision_tpu_torch.io import png
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    from grid_vision_tpu_torch.runtime import native, session, viewer
    from grid_vision_tpu_torch.runtime.stream import replay
    t_phase = time.perf_counter()
    res = dict(card=card)
    out_root = os.path.join(root, "build", "chip_smoke_cli")

    def cli(*args, timeout=600):
        proc = subprocess.run([sys.executable, "-m", "grid_vision_tpu_torch",
                               *args], capture_output=True, text=True,
                              cwd=root, timeout=timeout)
        if proc.returncode != 0:
            fail(f"CLI {' '.join(args)}: rc {proc.returncode}, stderr "
                 f"{proc.stderr[-2000:]!r}")
        return proc

    for mode, det in (("pca", "oracle"), ("vision", "net")):
        out = os.path.join(out_root, f"demo_{mode}_{det}")
        t0 = time.perf_counter()
        proc = cli("demo", "--mode", mode, "--det", det, "--steps", "6",
                   "--out", out)
        files = sorted(os.listdir(out))
        want = [f"{kind}_{i:03d}.{ext}" for kind, ext in (
            ("dets", "ppm"), ("grid", "pgm"), ("markers", "json"))
            for i in (0, 5)]
        if files != sorted(want):
            fail(f"demo {mode}/{det} wrote {files}")
        res[f"demo_{mode}_{det}"] = dict(
            seconds=time.perf_counter() - t0,
            summary=proc.stdout.strip().splitlines())
    cfg = GridVisionConfig(use_vision_orientation=True, max_points=8192,
                           detection_weights_file="/weights/detector.npz",
                           vision_weights_file="/weights/orientation.npz")
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics(dev),
                          seed=0, device=dev, base_dir=root)
    scene = SyntheticScene(cfg, seed=0)
    scene.add_default_traffic()
    last = {}
    replay(eng, scene, n_steps=6, hz=10.0,
           on_step=lambda i, s, o: last.update(out=o))
    ref_pgm = os.path.join(out_root, "replay_005.pgm")
    native.write_pgm(ref_pgm, last["out"].occupancy_i8.cpu().numpy())
    with open(ref_pgm, "rb") as f, open(os.path.join(
            out_root, "demo_vision_net", "grid_005.pgm"), "rb") as g:
        if f.read() != g.read():
            fail("the demo's net run's last grid differs from replay's")
    res["demo_net_grid_equals_replay"] = True

    name = f"gvsmoke-{os.getpid()}-view"
    cli("run", "--steps", "6", "--publish", name)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    view = subprocess.Popen(
        [sys.executable, "-m", "grid_vision_tpu_torch", "view", "--session",
         name, "--http", str(port), "--seconds", "5"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root)
    try:
        t_end, index = time.time() + 30, None
        while index is None and time.time() < t_end:
            try:
                index = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/", timeout=5).read()
            except OSError:
                time.sleep(0.1)
        if index is None or name.encode() not in index:
            fail(f"view --http: / did not answer with the session")
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/grid.png", timeout=10).read()
        sub = session.SessionSubscriber(name)
        frame = sub.poll(wait_new=False)
        sub.close()
        if not (png.decode_rgb(body) == viewer.grid_frame_rgb(
                frame, scale=2)).all():
            fail("view --http: /grid.png is not the session's last frame")
        grid, step, _ = next(viewer.gvd_client("127.0.0.1", port,
                                               max_records=1))
        if not ((grid == frame.grid).all() and step == frame.step == 5):
            fail("view --http: the /grid.gvd record is not the last frame")
        out, err = view.communicate(timeout=60)
    finally:
        if view.poll() is None:
            view.kill()
            view.communicate()
        _unlink_session(name)
    if view.returncode != 0:
        fail(f"view: rc {view.returncode}, stderr {err[-2000:]!r}")
    res["view"] = dict(session=name, png_bytes=len(body), step=int(step),
                       occupied_cells=int((frame.grid > 50).sum()), rc=0)
    res["seconds"] = time.perf_counter() - t_phase
    phase("cli", **res)


INT8_ENGINE_TICKS = 5
INT8_FLEET_TICKS = 3
INT8_EVAL = 50                  # synth frames; tests/test_int8_detector.py:52
INT8_KERNEL = "gv_int8_"        # the int8 conv kernel (csrc/cuda_int8.cu)
KNOB_TICKS = 2
MESH_STEPS = 3
MESH_DET = dict(size=64, batch=4)      # tests/test_torch_train_mesh.py's
MESH_ORI = dict(size=32, width=8, batch=8)
MESH_FULL = (dict(size=416, batch=8), dict(size=224, width=32, batch=16))


def kernel_breakdown(torch, fn, iters: int = 5, top: int = 12):
    """torch.profiler over `iters` calls of fn(): device ms a call, the
    top kernels by device time (ms a call, launches a call), and the ms
    of the int8 conv kernel (INT8_KERNEL)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    by_name, launches = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / iters
        launches[e.name] = launches.get(e.name, 0) + 1 / iters
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return dict(device_ms=sum(by_name.values()),
                launches=sum(launches.values()),
                int8_kernel_ms=sum(ms for n, ms in by_name.items()
                                   if INT8_KERNEL in n),
                top_kernels=[dict(name=n[:90], ms=ms, launches=launches[n])
                             for n, ms in ranked[:top]])


def int8_phases(torch, dev, root, cfg, fleet_cfg, nets, extrinsics, obs_seq,
                fleet_obs, modules, forms, card):
    """Phase `int8`: the int8 detector (models/yolov4_int8.py,
    detector_precision="int8") on the card, with the shipped weights.

    1. Every layer through the int8 conv kernel (csrc/cuda_int8.cu) on the
       fleet's 64 real frames (check_int8, the 19 sites of a forward): the
       accumulators bit-equal to the plain f64 conv, the fused requant
       bit-equal to requant; each site's shape, plan (route, tile), max
       |acc|, the kernel's ms, its bound and its share of it.
    2. The extension-mode tick (compat=False, raycast_free_space, depth
       refine, class-aware NMS; stem "xla", as validate() ties int8 to
       it): INT8_ENGINE_TICKS single-rig ticks and INT8_FLEET_TICKS fleet
       ticks of 64 rigs, counters from zero (the carve and kNN kernels once
       a tick, the fleet's orientation front once a tick, the int8 conv
       kernel 19 times a tick), each against the same ticks with the int8
       conv's plain version: occupancy_i8 bit-equal, box counts equal.
    3. mAP@0.5 on INT8_EVAL held-out synth frames (eval_map), int8 against
       the float detector: at least the float's - 0.03.
    4. The detector alone on the fleet's 64 frames (416): the int8
       forward's device ms and launches beside the f32 and bf16 forwards',
       the int8 kernel's share of it, and its top kernels (torch.profiler).

    Returns the launch counts of the engine and the fleet runs."""
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.config import GridVisionConfig
    from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
    from grid_vision_tpu_torch.ops import cuda_int8
    from grid_vision_tpu_torch.ops.preprocess import preprocess_detector_image
    from grid_vision_tpu_torch.train import eval_map
    t_phase = time.perf_counter()
    res = dict(card=card)
    q = yolov4_int8.quantize_detector(nets["detector"])
    ycfg = yolov4_tiny.YoloConfig(input_size=cfg.resize)
    net_in = preprocess_detector_image(fleet_obs[0].image, cfg.resize)

    # 1. every layer: the kernel against the f64 conv, both modes
    r = check_int8(torch, dev, nets["detector"], cfg, None, images=net_in,
                   timing="kernel")
    res["layers"] = r["sites"]
    res["layers_ms"], res["layers_bound_ms"] = r["ms"], r["sites_bound_ms"]
    res["layers_bit_equal"] = len(r["sites"])

    # 2. the extension-mode ticks against the plain int8 conv
    ext = dict(compat=False, raycast_free_space=True,
               vision_depth_refine=True, class_aware_nms=True,
               detector_precision="int8", detector_stem_backend="xla")
    params = dict(nets, detector_q=q)
    real_conv = yolov4_int8.int8_conv_requant
    n_layers = len(yolov4_int8.LAYERS)
    counts = {}
    for path, base, ticks, run, want in (
            ("engine", cfg, INT8_ENGINE_TICKS,
             lambda e, o: run_ticks(torch, e, o),
             dict(knn_median_depth=INT8_ENGINE_TICKS,
                  carve_update=INT8_ENGINE_TICKS,
                  int8_conv=n_layers * INT8_ENGINE_TICKS)),
            ("fleet", fleet_cfg, INT8_FLEET_TICKS,
             lambda e, o: run_fleet(torch, e, o, BUDGET),
             dict(knn_median_depth=INT8_FLEET_TICKS,
                  carve_update=INT8_FLEET_TICKS,
                  orient_front=INT8_FLEET_TICKS,
                  int8_conv=n_layers * INT8_FLEET_TICKS))):
        c = dataclasses.replace(base, **ext)
        eng = pipeline.Engine(c, extrinsics=extrinsics, params=params,
                              device=dev)
        seq = (obs_seq if path == "engine" else fleet_obs)[:ticks]
        run(eng, seq[:1])                                  # warm
        yolov4_int8.launches = 0
        (_, outs, times), got = _counted(
            modules, forms, lambda: run(eng, seq), want, f"int8 {path}")
        convs = yolov4_int8.launches
        if convs != n_layers * ticks:
            fail(f"int8 {path}: the detector's convs launched {convs} "
                 f"kernels in {ticks} ticks")
        yolov4_int8.int8_conv_requant = cuda_int8.int8_conv_requant_plain
        try:
            _, plain_outs, plain_times = run(eng, seq)
        finally:
            yolov4_int8.int8_conv_requant = real_conv
        _same_ticks(torch, f"int8 {path}", outs, plain_outs)
        res[path] = dict(
            rigs=int(seq[0].image.shape[0]) if path == "fleet" else 1,
            ticks=ticks, launches=got, conv_kernel_launches=convs,
            median_tick_ms=statistics.median(times), tick_ms=times,
            plain_median_tick_ms=statistics.median(plain_times),
            boxes_per_tick=[int(o.boxes.valid.sum()) for o in outs],
            occupancy_i8_bit_equal=True)
        counts[path] = got
        del eng, outs, plain_outs
    torch.cuda.empty_cache()

    # 3. mAP: int8 against the float detector
    base = GridVisionConfig(
        detection_weights_file=os.path.join(root, "weights/detector.npz"))
    dnets = weights.load_all(base, device=dev)
    r_f = eval_map.evaluate_detector(dnets, base, n_images=INT8_EVAL)
    r_i = eval_map.evaluate_detector(
        dnets, dataclasses.replace(base, detector_precision="int8",
                                   compat=False), n_images=INT8_EVAL)
    if not r_i.map50 >= r_f.map50 - 0.03:
        fail(f"int8 mAP@0.5 {r_i.map50} below the float's {r_f.map50} - "
             "0.03")
    res["map50"] = dict(int8=r_i.map50, float=r_f.map50, frames=INT8_EVAL)

    # 4. the detector alone at 64 frames: int8, f32, bf16
    det = nets["detector"]
    forwards = {
        "int8": lambda: yolov4_int8.forward_int8(q, net_in, ycfg),
        "f32": lambda: yolov4_tiny.forward(det, net_in,
                                           dtype=torch.float32),
        "bf16": lambda: yolov4_tiny.forward(det, net_in,
                                            dtype=torch.bfloat16)}
    detector = {}
    for name, fn in forwards.items():
        with torch.no_grad():
            host = cuda_time_ms(fn, 5, 2)
        detector[name] = dict(kernel_breakdown(torch, fn), event_ms=host)
    d8 = detector["int8"]
    res["detector_64"] = dict(
        frames=int(net_in.shape[0]), size=cfg.resize, **detector,
        int8_kernel_share=d8["int8_kernel_ms"] / d8["device_ms"])
    res["seconds"] = time.perf_counter() - t_phase
    phase("int8", **res)
    return counts


INT8_MMA_SHAPE = (8192, 2304, 256)      # tools/bench_int8_mxu.py's defaults


def int8_mma_phase(torch, dev, card):
    """Phase `int8_mma`: the counterpart of tools/bench_int8_mxu.py, the
    kernel's GEMM form (ops/cuda_int8.int8_matmul, bf16_matmul) at the
    tool's default shape: each result held against its plain version (s8
    bit-equal to it and to torch._int_mm; bf16 on unit-normal inputs
    within cuda_int8.f32_sum_bound, and within 1e-4 at the CPU tests'
    shape, M 256, K 384, N 256), then the s8 kernel's TOPS, the bf16 kernel's TFLOP/s and their
    ratio beside torch._int_mm's and torch.matmul's (CUDA events, b in the
    kernel's weight layout: column-major)."""
    from grid_vision_tpu_torch.ops import cuda_int8
    m, k, n = INT8_MMA_SHAPE
    g = torch.Generator(device=dev).manual_seed(0)
    a8 = torch.randint(-127, 127, (m, k), generator=g, device=dev,
                       dtype=torch.int8)
    b8 = torch.randint(-127, 127, (n, k), generator=g, device=dev,
                       dtype=torch.int8).t()
    a16 = torch.randn((m, k), generator=g, device=dev).bfloat16()
    b16 = torch.randn((n, k), generator=g, device=dev).bfloat16().t()
    got = cuda_int8.int8_matmul(a8, b8)
    if not (torch.equal(got, cuda_int8.int8_matmul_plain(a8, b8))
            and torch.equal(got, torch._int_mm(a8, b8))):
        fail("int8_mma: the s8 kernel differs from its plain version or "
             "torch._int_mm")
    d = cuda_int8.bf16_matmul(a16, b16) - cuda_int8.bf16_matmul_plain(
        a16, b16)
    err = d.abs().max().item()
    if not (d.abs() <= cuda_int8.f32_sum_bound(a16, b16)).all():
        fail(f"int8_mma: the bf16 kernel is {err} off its plain version, "
             "beyond the f32 sum bound")
    # the CPU tests' bar at their shape (M 256, K 384, N 256)
    a_cpu, b_cpu = a16[:256, :384].contiguous(), b16[:384]
    cpu_bar_err = (cuda_int8.bf16_matmul(a_cpu, b_cpu)
                   - cuda_int8.bf16_matmul_plain(a_cpu, b_cpu)
                   ).abs().max().item()
    if not cpu_bar_err <= 1e-4:
        fail(f"int8_mma: the bf16 kernel is {cpu_bar_err} off its plain "
             "version at the CPU tests' shape, beyond 1e-4")
    ops = 2.0 * m * k * n
    ms = {}
    for name, fn in (("int8", lambda: cuda_int8.int8_matmul(a8, b8)),
                     ("bf16", lambda: cuda_int8.bf16_matmul(a16, b16)),
                     ("int_mm", lambda: torch._int_mm(a8, b8)),
                     ("matmul", lambda: torch.matmul(a16, b16))):
        ms[name] = cuda_time_ms(fn, 50, 5)
    plain = dict(int8=cuda_time_ms(
        lambda: cuda_int8.int8_matmul_plain(a8, b8), 5, 1),
        bf16=cuda_time_ms(lambda: cuda_int8.bf16_matmul_plain(a16, b16),
                          5, 1))
    plans = {name: dataclasses.asdict(cuda_int8.int8_plan(m, n, k, size=size))
             for name, size in (("int8", 1), ("bf16", 2))}
    phase("int8_mma", card=card, m=m, k=k, n=n, plans=plans, ms=ms,
          plain_ms=plain,
          int8_tops=ops / ms["int8"] / 1e9,
          bf16_tflops=ops / ms["bf16"] / 1e9,
          int8_speedup_vs_bf16=ms["bf16"] / ms["int8"],
          int_mm_tops=ops / ms["int_mm"] / 1e9,
          matmul_tflops=ops / ms["matmul"] / 1e9,
          library_int8_speedup_vs_bf16=ms["matmul"] / ms["int_mm"],
          bf16_max_abs_err=err, bf16_max_abs_err_cpu_shape=cpu_bar_err,
          bound_int8_ms=bound_int8_ms(m * k + n * k + m * n * 4, ops)[0],
          bound_bf16_ms=bound_bf16_ms(2 * (m * k + n * k) + m * n * 4,
                                      ops)[0])


def knobs_phases(torch, dev, root, cfg, fleet_cfg, nets, extrinsics,
                 fleet_obs, modules, forms, card):
    """Phase `knobs`: the five configuration knobs on the card, each in
    the fleet tick (64 rigs, KNOB_TICKS ticks, budget 320) against its
    default counterpart, counters from zero:

    - detector_s2d_stem (stem "xla") and detector_stem_backend="im2col"
      against the "xla" stem: the detector's input activation (the
      post-ConvBN_1 (64, 104, 104, 64) of the fleet's frames) within 1e-4,
      equal box counts, occupancy_i8 >= 99.9 % per rig;
    - knn_backend="approx" against "xla": medians (static depths) equal,
      occupancy_i8 bit-equal;
    - orientation_s2d_fold=False against the folded stem (orientation
      "xla"): the net on 320 crops within tests/test_models.py:77's bars
      (1e-4 orientation, 1e-3 confidence and dims); the ticks as the
      first row;
    - orientation_arch="resnet" (the flax-exact init at seed 7, width 32;
      no resnet checkpoint ships): its tick on the detector, grid and kNN
      kernels against the same tick all plain, at the f32 rows of PERF.md
      section 2 (compare_outputs).
    """
    from grid_vision_tpu_torch import pipeline
    from grid_vision_tpu_torch.device import ieee_convs
    from grid_vision_tpu_torch.models import orientation_net
    from grid_vision_tpu_torch.ops import preprocess, stem_im2col
    from grid_vision_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    res = dict(card=card, rigs=N_RIGS, ticks=KNOB_TICKS)
    T = KNOB_TICKS
    obs = fleet_obs[:T]
    det = nets["detector"]
    frames = obs[0].image

    # the detector's input activation three ways
    with torch.no_grad(), ieee_convs():
        x = preprocess.preprocess_detector_image(frames, cfg.resize)
        x = x.permute(0, 3, 1, 2)
        ref = det.ConvBN_1(det.ConvBN_0(x)).permute(0, 2, 3, 1)
        s2d = det.ConvBN_1(det.ConvBN_0(x, s2d=True), s2d=True).permute(
            0, 2, 3, 1)
        im2col = stem_im2col.detector_stem_im2col(
            frames, stem_im2col.prepare_im2col_constants(det), cfg.resize)
    for name, act in (("s2d_stem", s2d), ("im2col_stem", im2col)):
        err = (act - ref).abs()
        if not bool((err <= 1e-4 + 1e-4 * ref.abs()).all()):
            fail(f"knobs {name}: the detector's input activation is "
                 f"{float(err.max())} off the xla stem's")
        res[f"{name}_activation_max_abs_err"] = float(err.max())
    del x, ref, s2d, im2col

    xla_stem = dataclasses.replace(fleet_cfg, detector_stem_backend="xla")
    folded = dataclasses.replace(fleet_cfg, orientation_stem_backend="xla")
    plain = dataclasses.replace(
        fleet_cfg, detector_stem_backend="xla",
        orientation_stem_backend="xla", grid_backend="xla",
        knn_backend="xla")
    resnet_net = orientation_net.init_params(
        prng.prng_key(7, device=dev), orientation_net.OrientationConfig(
            input_size=fleet_cfg.network_height,
            width=fleet_cfg.orientation_width, arch="resnet")).eval()
    rest = dict(grid_update=T, knn_median_depth=T)
    cases = (
        ("s2d_stem", dataclasses.replace(xla_stem, detector_s2d_stem=True),
         xla_stem, nets, dict(rest, orient_front=T)),
        ("im2col_stem", dataclasses.replace(
            fleet_cfg, detector_stem_backend="im2col"), xla_stem, nets,
         dict(rest, orient_front=T)),
        ("approx_knn", dataclasses.replace(fleet_cfg, knn_backend="approx"),
         dataclasses.replace(fleet_cfg, knn_backend="xla"), nets,
         dict(detector_stem=T, detector_csp=T, orient_front=T,
              grid_update=T)),
        ("unfolded_orientation", dataclasses.replace(
            folded, orientation_s2d_fold=False), folded, nets,
         dict(rest, detector_stem=T, detector_csp=T)),
        ("resnet", dataclasses.replace(
            folded, orientation_arch="resnet"), dataclasses.replace(
            plain, orientation_arch="resnet"),
         dict(nets, orientation=resnet_net),
         dict(rest, detector_stem=T, detector_csp=T)))
    for name, kcfg, rcfg, knets, want in cases:
        kern = pipeline.Engine(kcfg, extrinsics=extrinsics, params=knets,
                               device=dev)
        other = pipeline.Engine(rcfg, extrinsics=extrinsics, params=knets,
                                device=dev)
        (_, outs, times), got = _counted(
            modules, forms, lambda: run_fleet(torch, kern, obs, BUDGET),
            want, f"knobs {name}")
        _, refs, ref_times = run_fleet(torch, other, obs, BUDGET)
        agree, n_boxes, n_poses = compare_outputs(torch, fleet_cfg, outs,
                                                  refs, per_rig=True)
        row = dict(launches=got, median_tick_ms=statistics.median(times),
                   counterpart_median_tick_ms=statistics.median(ref_times),
                   min_occupancy_i8_agreement_per_rig=agree,
                   boxes_per_tick=n_boxes, poses_per_tick=n_poses)
        if name == "approx_knn":
            for o, r in zip(outs, refs):
                if not (torch.equal(o.static_depths, r.static_depths)
                        and torch.equal(o.occupancy_i8, r.occupancy_i8)):
                    fail("knobs approx_knn: medians or grid differ from "
                         "the exact backend's")
            row["medians_equal"] = True
        res[name] = row
        del kern, other, outs, refs

    # the unfolded orientation stem on crops of the fleet's frames
    crops = torch.randn((BUDGET, fleet_cfg.network_height,
                         fleet_cfg.network_height, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        a = orientation_net.forward(nets["orientation"], crops,
                                    s2d_fold=False)
        b = orientation_net.forward(nets["orientation"], crops,
                                    s2d_fold=True)
    errs = [float((u - v).abs().max()) for u, v in zip(a, b)]
    for e, u, v, tol in zip(errs, a, b, (1e-4, 1e-3, 1e-3)):
        if not torch.allclose(u, v, rtol=tol, atol=tol):
            fail(f"knobs unfolded_orientation: the net's outputs {errs}")
    res["unfolded_orientation"]["net_max_abs_err"] = errs
    res["seconds"] = time.perf_counter() - t_phase
    phase("knobs", **res)


def mesh_phase(torch, dev, card):
    """Phase `mesh`: the training mesh on the card (parallel/mesh.py,
    trainer.make_train_step(..., mesh=)), a (2, 2) grid of logical shards
    of the card, SGD(1e-2), f32.

    1. tests/test_parallel.py:105-146's contract: MESH_STEPS steps of the
       detector (input 32, batch 8) on the mesh finite and falling, step
       == 3; a wide conv weight split over tp.
    2. The sharded step against the unsharded one from the same init and
       batch, MESH_STEPS steps, at tests/test_torch_train_mesh.py's sizes
       (MESH_DET: detector 64, batch 4; MESH_ORI: orientation 32 / 8,
       batch 8) and tests/test_torch_train_steps.py's bars (losses rtol
       1e-5; parameters within 1e-4 and >= 99.99 % within atol 1e-6 / rtol
       1e-4; running statistics atol 1e-5).
    3. At the CLI's sizes (MESH_FULL: detector 416, batch 8; orientation
       224 / 32, batch 16): the sharded step held against the unsharded
       one by the run's own control, the unsharded step on the batch in
       reverse order (the sensitivity of these nets to the order of the
       sums: SGD(1e-2) moves them far in a step). The sharded losses'
       largest relative error, and the largest error of a parameter and
       of a running statistic, must not exceed the reversed batch's; a
       dropped, doubled or misordered shard moves a parameter by about
       lr x its gradient, far beyond that. Also the sharded and the
       unsharded steps' ms (host clock, synchronized, the last step).
    Steps 2 and 3 run with cuDNN deterministic (restored after): on one
    device the sharded step runs the unsharded step's backward, so a
    difference can only be the mesh path's own."""
    import numpy as np
    from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
    from grid_vision_tpu_torch.parallel.mesh import (make_mesh, replicate,
                                                     shard_params)
    from grid_vision_tpu_torch.train import trainer
    from grid_vision_tpu_torch.utils import prng
    t_phase = time.perf_counter()
    res = dict(card=card)
    mesh = make_mesh(4, ("dp", "tp"), tp=2, device=dev)
    f32 = torch.float32

    def yolo_batch(cfg, b):
        n = cfg.num_anchors_total
        images = prng.uniform(prng.prng_key(1, device=dev),
                              (b, cfg.input_size, cfg.input_size, 3))
        tgt_boxes = torch.tensor([[0.2, 0.2, 0.6, 0.6]],
                                 device=dev).repeat(b, n, 1)
        tgt_pos = torch.zeros((b, n), device=dev)
        tgt_pos[:, 0] = 1.0
        return (images, tgt_boxes,
                torch.zeros((b, n), dtype=torch.int32, device=dev), tgt_pos)

    def multibin_batch(size, b):
        rng = np.random.default_rng(6)
        return tuple(torch.tensor(a, device=dev) for a in (
            rng.normal(size=(b, size, size, 3)).astype(np.float32),
            (rng.normal(size=(b, 3)) * 0.3).astype(np.float32),
            rng.integers(0, 2, b).astype(np.int32),
            rng.uniform(-1, 1, b).astype(np.float32)))

    def cases(det, ori):
        ycfg = yolov4_tiny.YoloConfig(input_size=det["size"],
                                      compute_dtype=f32)
        ocfg = orientation_net.OrientationConfig(
            input_size=ori["size"], width=ori["width"], s2d_fold=False,
            compute_dtype=f32)
        return (("yolo", ycfg, yolo_batch(ycfg, det["batch"])),
                ("multibin", ocfg, multibin_batch(ori["size"],
                                                  ori["batch"])))

    def run(kind, cfg, batch, m):
        tx = trainer.SGD(1e-2)
        state = trainer.init_train_state(kind, cfg, tx,
                                         prng.prng_key(0, device=dev))
        step = trainer.make_train_step(kind, cfg, tx, m)
        losses, times = [], []
        for _ in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, *batch)
            losses.append(metrics["loss"].item())
            times.append((time.perf_counter() - t0) * 1e3)
        return state, losses, times

    def apart(s0, s1):
        """(max |dparam|, share of parameters off atol 1e-6 / rtol 1e-4,
        max |d running statistic|)."""
        want, got = s0.model.state_dict(), s1.model.state_dict()
        n = off = 0
        worst = stats = 0.0
        for k, r in want.items():
            err = (got[k].double() - r.double()).abs()
            if "running" in k:
                stats = max(stats, float(err.max()))
                continue
            worst = max(worst, float(err.max()))
            n += r.numel()
            off += int((err > 1e-6 + 1e-4 * r.double().abs()).sum())
        return worst, off / n, stats

    # 1. the JAX package's contract
    cfg32 = yolov4_tiny.YoloConfig(input_size=32, compute_dtype=f32)
    state, losses, _ = run("yolo", cfg32, yolo_batch(cfg32, 8), mesh)
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
            and state.step == MESH_STEPS):
        fail(f"mesh: SGD on the mesh {losses}, step {state.step}")
    placements = shard_params(state.model, mesh)
    replicate(state.model, mesh)
    sharded = sorted(k for k, p in placements.items() if p.tp_sharded)
    if not any(dict(state.model.named_parameters())[k].dim() == 4
               for k in sharded):
        fail("mesh: no wide conv weight is tp-sharded")
    res["contract"] = dict(losses=losses, step=state.step,
                           tp_sharded_leaves=len(sharded),
                           leaves=len(placements))

    # 2. sharded against unsharded at the tests' sizes, at their bars
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for kind, cfg, batch in cases(MESH_DET, MESH_ORI):
            (s0, want, _), (s1, got, _) = (run(kind, cfg, batch, m)
                                           for m in (None, mesh))
            worst, off, stats = apart(s0, s1)
            if not (np.allclose(got, want, rtol=1e-5, atol=0)
                    and worst <= 1e-4 and off <= 1e-4 and stats <= 1e-5):
                fail(f"mesh {kind}: losses {got} vs {want}, parameters "
                     f"{worst} max, {off} off, statistics {stats}")
            res[kind] = dict(batch=int(batch[0].shape[0]),
                             input_size=int(batch[0].shape[1]),
                             losses=got, unsharded_losses=want,
                             max_param_err=worst, off_share=off,
                             max_stat_err=stats, dp=mesh.dp, tp=mesh.tp)
            del s0, s1

        # 3. the CLI's sizes, against the reversed batch's control
        for kind, cfg, batch in cases(*MESH_FULL):
            perm = torch.arange(batch[0].shape[0] - 1, -1, -1, device=dev)
            (s0, want, t0), (s1, got, t1), (s2, other, _) = (
                run(kind, cfg, b, m) for b, m in (
                    (batch, None), (batch, mesh),
                    (tuple(x[perm] for x in batch), None)))

            def rel(v):
                return max(abs(a - b) / abs(b) for a, b in zip(v, want))

            err, control = apart(s0, s1), apart(s0, s2)
            r = res[f"{kind}_full"] = dict(
                batch=int(batch[0].shape[0]),
                input_size=int(batch[0].shape[1]),
                losses=got, unsharded_losses=want, step_ms=t1[-1],
                unsharded_step_ms=t0[-1], loss_rel_err=rel(got),
                reordered_loss_rel_err=rel(other), param_err=err,
                reordered_param_err=control)
            if not (r["loss_rel_err"] <= r["reordered_loss_rel_err"]
                    and err[0] <= control[0] and err[2] <= control[2]):
                fail(f"mesh {kind} at {r['input_size']} / {r['batch']}: "
                     f"sharded losses {r['loss_rel_err']} and (parameter, "
                     f"off share, statistic) errors {err} beyond the "
                     f"reversed batch's {r['reordered_loss_rel_err']} and "
                     f"{control}")
            del s0, s1, s2
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    phase("mesh", **res)


def kernel_phase(path: str, r: dict) -> None:
    phase("kernel", path=path,
          **{k: v for k, v in r.items() if k not in ("bound", "call")},
          bound_ms=r["bound"][0], bound_by=r["bound"][1])


def main() -> None:
    only = tf32 = None
    argv = sys.argv[1:]
    if len(argv) == 2 and argv[0] == "--kernels":
        only = set(argv[1].split(","))
    elif len(argv) == 2 and argv[0] == "--tf32-ticks":
        tf32 = argv[1]
    elif argv:
        fail("usage: chip_smoke.py [--kernels stem,grid,knn,csp,orient,carve,"
             "stem_bf16,csp_bf16,orient_bf16,int8,epilogue]")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False; this "
             "smoke test runs only on a card")
    root = os.path.dirname(os.path.abspath(__file__))
    if tf32 is not None:
        return tf32_main(torch, root, tf32)
    sys.path.insert(0, root)
    try:
        import grid_vision_tpu_torch as gv
        from grid_vision_tpu_torch import pipeline
        from grid_vision_tpu_torch.io.scene import SyntheticScene
        from grid_vision_tpu_torch.ops import (cuda_build, cuda_csp,
                                               cuda_epilogue, cuda_grid,
                                               cuda_int8, cuda_knn,
                                               cuda_orient, cuda_raycast,
                                               cuda_stem)
        from grid_vision_tpu_torch.runtime.stream import (FleetPool,
                                                          obs_from_scene)
        from grid_vision_tpu_torch.demo import default_extrinsics
    except ImportError as e:
        fail(f"grid_vision_tpu_torch not importable next to chip_smoke.py "
             f"({e}); run from the root of a checkout")
    if any(m == "jax" or m.startswith(("jax.", "flax", "grid_vision_tpu."))
           or m == "grid_vision_tpu" for m in sys.modules):
        fail("the port imported JAX or the JAX package")

    # 1. the card
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    dev = torch.device("cuda", 0)
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, devices=torch.cuda.device_count())

    # 2. build every kernel, one nvcc per source, all started together
    t0 = time.perf_counter()
    cuda_build.build_all(variants=[CSP_CLOCKS])
    regs = {n: ptxas_summary(log) for n, log in cuda_build.ptxas_log.items()}
    # the int8 conv's instances: the ring and the dynamic shared memory
    # each N tile takes (ptxas counts static shared memory only), held to
    # ops/cuda_int8's plan
    lib8 = cuda_build.load("cuda_int8")
    int8_smem = {bn: dict(stages=lib8.gv_int8_stages(bn),
                          dynamic_smem=lib8.gv_int8_smem(bn))
                 for bn in cuda_int8.TILE_N}
    for bn, got in int8_smem.items():
        if (got["stages"], got["dynamic_smem"]) != (
                cuda_int8.ring_stages(bn), cuda_int8.smem_bytes(bn)):
            fail(f"int8 kernel at N tile {bn}: {got} differs from the plan")
    phase("build", seconds=round(time.perf_counter() - t0, 3), ptxas=regs,
          int8_instances=int8_smem)

    # the single-rig path's configuration at full width; the fleet
    # configuration of bench.py:240-245 in f32
    cfg, fleet_cfg = path_configs(gv)
    engine = pipeline.Engine(cfg, extrinsics=default_extrinsics(dev),
                             device=dev, base_dir=root)
    modules = {"detector_stem": cuda_stem, "grid_update": cuda_grid,
               "knn_median_depth": cuda_knn, "detector_csp": cuda_csp,
               "orient_front": cuda_orient, "carve_update": cuda_raycast,
               "int8_conv": cuda_int8, "conv_epilogue": cuda_epilogue}
    forms = {"detector_stem_bf16": cuda_stem, "detector_csp_bf16": cuda_csp,
             "orient_front_bf16": cuda_orient}
    nets = {k: engine.params[k] for k in ("detector", "orientation")}
    scene = SyntheticScene(cfg, seed=0, n_ground=15000)
    scene.add_default_traffic()
    scene.add_default_statics()
    obs_seq = [obs_from_scene(scene, i / 10.0, cfg, dev)
               for i in range(ENGINE_TICKS)]
    fleet = pipeline.Engine(fleet_cfg, extrinsics=engine.extrinsics,
                            params={k: engine.params[k]
                                    for k in ("detector", "orientation")},
                            device=dev)
    pool = FleetPool(fleet_cfg, N_RIGS, device=dev)
    t0 = time.perf_counter()
    fleet_obs = [pool.obs(i) for i in range(FLEET_TICKS)]
    pool_s = time.perf_counter() - t0
    det, net = engine.params["detector"], engine.params["orientation"]

    # 3. each kernel against its twin: single-rig shapes, then the fleet's,
    # then the extension tick's: the carve kernel on a real scan, the kNN
    # kernel at the full box capacity the depth refine asks for
    checks = [
        ("engine", "stem", check_stem, (det, cfg, 1)),
        ("engine", "grid", check_grid, (cfg, None)),
        ("engine", "knn", check_knn, (cfg, obs_seq[0].cloud)),
        ("fleet", "stem", check_stem, (det, fleet_cfg, N_RIGS)),
        ("fleet", "csp", check_csp, (det, fleet_cfg, N_RIGS)),
        ("fleet", "orient", check_orient, (net, fleet_cfg, N_RIGS, BUDGET)),
        ("fleet", "grid", check_grid, (fleet_cfg, N_RIGS)),
        ("fleet", "knn", check_knn, (fleet_cfg, fleet_obs[0].cloud)),
        ("engine", "stem_bf16", check_stem_bf16, (det, cfg, 1)),
        ("fleet", "stem_bf16", check_stem_bf16, (det, fleet_cfg, N_RIGS)),
        ("engine", "csp_bf16", check_csp_bf16, (det, fleet_cfg, 1)),
        ("fleet", "csp_bf16", check_csp_bf16, (det, fleet_cfg, N_RIGS)),
        ("engine", "orient_bf16", check_orient_bf16, (net, fleet_cfg, 1, 5)),
        ("fleet", "orient_bf16", check_orient_bf16,
         (net, fleet_cfg, N_RIGS, BUDGET)),
        ("engine", "int8", check_int8, (det, cfg, 1)),
        ("fleet", "int8", check_int8, (det, fleet_cfg, N_RIGS)),
        ("yolov4", "epilogue", check_epilogue,
         (root, fleet_cfg, engine.extrinsics, fleet_obs, torch.bfloat16,
          2 * N_RIGS)),
        ("yolov4_f32", "epilogue", check_epilogue,
         (root, fleet_cfg, engine.extrinsics, fleet_obs, torch.float32,
          16))]
    for path, rigs, c, obs in (("extension", None, cfg, obs_seq[0]),
                               ("extension_fleet", N_RIGS, fleet_cfg,
                                fleet_obs[0])):
        checks += [
            (path, "carve", check_raycast, (c, rigs, obs, engine.extrinsics)),
            (path, "knn", check_knn, (c, obs.cloud, c.max_detections))]
    phase("stem_occupancy", **cuda_stem.blocks_per_sm(
        cfg.camera_image_height, cfg.camera_image_width, cfg.resize))
    # the grid and carve kernels' vector path: blocks (of 256 threads) an
    # SM, and the bytes in flight an SM before the first store: a thread's
    # cells of log-odds (the carve adds their angle bins and centre ranges)
    grid_blocks = cuda_grid.blocks_per_sm()
    carve_blocks = cuda_raycast.blocks_per_sm()
    cell_bytes = 256 * cuda_grid.CELLS_PER_THREAD * 4
    phase("grid_occupancy", grid_blocks_per_sm=grid_blocks,
          carve_blocks_per_sm=carve_blocks,
          grid_loads_in_flight_per_sm=grid_blocks["vector"] * cell_bytes,
          carve_loads_in_flight_per_sm=carve_blocks["vector"] * cell_bytes * 3)
    checked = {}                              # (path, kernel name) -> result
    for path, short, fn, args in checks:
        if only is not None and short not in only:
            continue
        r = fn(torch, dev, *args)
        torch.cuda.synchronize()
        checked[path, r["name"]] = r
    # the kernels' device time per call, after every host-clock timing: once
    # the profiler has run in a process, each launch costs the host more
    for (path, _), r in checked.items():
        call = r.pop("call", None)
        if call is not None:
            r["check_device_ms"] = port_device_ms(torch, call)
        del call
        kernel_phase(path, r)
    if only is None or only & {"grid", "carve"}:
        phase("grid_stage", rigs=N_RIGS, **grid_stage(
            torch, dev, fleet_cfg, fleet_obs[0], engine.extrinsics))
    torch.cuda.empty_cache()
    if only is not None:
        return
    results = {name: checked["fleet", name]
               for name in ("detector_stem", "detector_csp", "orient_front",
                            "grid_update", "knn_median_depth",
                            "detector_stem_bf16", "detector_csp_bf16",
                            "orient_front_bf16", "int8_conv")}
    results["carve_update"] = checked["extension_fleet", "carve_update"]
    carve_single = checked["extension", "carve_update"]
    knn_other = [dict({k: r[k] for k in (
        "shape", "queries", "slices", "ms", "check_device_ms", "plain_ms",
        "library_ms", "max_abs_err")}, path=path, bound_ms=r["bound"][0],
        bound_by=r["bound"][1])
        for (path, name), r in checked.items()
        if name == "knn_median_depth" and path != "fleet"]

    # 4. the single-rig main path, counters from zero
    single = {name: modules[name]
              for name in ("detector_stem", "grid_update", "knn_median_depth")}
    for m in modules.values():
        m.launches = 0
    _, outs, times = run_ticks(torch, engine, obs_seq)
    engine_launches = {name: m.launches for name, m in modules.items()}
    for name, n in engine_launches.items():
        if n != (ENGINE_TICKS if name in single else 0):
            fail(f"{name} launched {n} times in {ENGINE_TICKS} ticks")
    plain_cfg = dataclasses.replace(cfg, detector_stem_backend="xla",
                                    grid_backend="xla", knn_backend="xla")
    plain = pipeline.Engine(plain_cfg, extrinsics=engine.extrinsics,
                            params=engine.params, device=dev)
    _, plain_outs, plain_times = run_ticks(torch, plain, obs_seq)
    agree, n_boxes, n_poses = compare_outputs(torch, cfg, outs, plain_outs,
                                              per_rig=False)
    phase("engine", ticks=ENGINE_TICKS, launches=engine_launches,
          median_tick_ms=statistics.median(times),
          plain_median_tick_ms=statistics.median(plain_times),
          min_occupancy_i8_agreement=agree, boxes_per_tick=n_boxes,
          poses_per_tick=n_poses,
          occupied_cells_last=int((outs[-1].occupancy_i8 > 50).sum()))
    del outs, plain_outs

    # 5. the fleet path, counters from zero
    for m in modules.values():
        m.launches = 0
    _, fouts, ftimes = run_fleet(torch, fleet, fleet_obs, BUDGET)
    fleet_times = ftimes
    launches = {name: m.launches for name, m in modules.items()}
    for name, n in launches.items():
        if n != (0 if name in ("carve_update", "int8_conv", "conv_epilogue")
                 else FLEET_TICKS):
            fail(f"{name} launched {n} times in {FLEET_TICKS} fleet ticks")
    fplain_cfg = dataclasses.replace(
        fleet_cfg, detector_stem_backend="xla", orientation_stem_backend="xla",
        grid_backend="xla", knn_backend="xla")
    fplain = pipeline.Engine(fplain_cfg, extrinsics=engine.extrinsics,
                             params=fleet.params, device=dev)
    _, fplain_outs, fplain_times = run_fleet(torch, fplain, fleet_obs,
                                             BUDGET)
    fagree, f_boxes, f_poses = compare_outputs(torch, fleet_cfg, fouts,
                                               fplain_outs, per_rig=True)
    p3 = pipeline.Engine(dataclasses.replace(
        fleet_cfg, detector_stem_backend="pallas3"),
        extrinsics=engine.extrinsics, params=fleet.params, device=dev)
    _, out3 = p3.fleet(fleet.init_states(N_RIGS), fleet_obs[0], BUDGET)
    out2 = fouts[0]
    for name, a, b in (("occupancy_i8", out3.occupancy_i8,
                        out2.occupancy_i8),
                       ("boxes", out3.boxes.xyxy, out2.boxes.xyxy),
                       ("box validity", out3.boxes.valid, out2.boxes.valid),
                       ("pose validity", out3.poses.valid, out2.poses.valid),
                       ("poses", out3.poses.position[out3.poses.valid],
                        out2.poses.position[out2.poses.valid]),
                       ("static depths", out3.static_depths,
                        out2.static_depths)):
        if not torch.equal(a, b):
            fail(f"the pallas3 fleet tick differs from pallas2 in {name}")
    med, pmed = statistics.median(ftimes), statistics.median(fplain_times)
    phase("fleet", rigs=N_RIGS, ticks=FLEET_TICKS, budget=BUDGET,
          pool_render_s=round(pool_s, 3), launches=launches,
          median_tick_ms=med, plain_median_tick_ms=pmed,
          rig_frames_per_s=N_RIGS / med * 1e3,
          plain_rig_frames_per_s=N_RIGS / pmed * 1e3,
          tick_ms=ftimes, plain_tick_ms=fplain_times,
          min_occupancy_i8_agreement_per_rig=fagree, boxes_per_tick=f_boxes,
          poses_per_tick=f_poses,
          dropped_per_tick=[int(o.saturation.orientation_dropped.sum())
                            for o in fouts],
          pallas3_equals_pallas2=True)
    del fouts, fplain_outs, out2, out3
    # 6. where the fleet tick's device time goes
    profiles = {name: profile_fleet(torch, eng, fleet_obs[0], BUDGET)
                for name, eng in (("kernels", fleet), ("plain", fplain))}
    for name, prof in profiles.items():
        phase("profile", path=f"fleet/{name}", **prof)
    # the redesigned kernels' own device time per fleet tick (the profiler
    # may drop events of a long run: check_device_ms is the steadier number)
    device_ms = {
        kernel: sum(row["ms_per_tick"]
                    for row in profiles["kernels"]["port_kernels"]
                    if prefix in row["name"])
        for kernel, prefix in (("detector_stem", "gv_stem_"),
                               ("detector_csp", "gv_csp_"),
                               ("orient_front", "gv_orient_"),
                               ("knn_median_depth", "gv_knn_"),
                               ("grid_update", "gv_grid_"))}
    for kernel, ms in device_ms.items():
        if not ms > 0.0:
            fail(f"the profile shows no device time for {kernel}")
    del fplain, p3
    torch.cuda.empty_cache()

    # 6b. the production bf16 configuration (compute_dtype="bfloat16"):
    # the single-rig Engine, then the fleet with a bf16 pool, each on the
    # kernel backends against the same bf16 configuration on the plain
    # ones; counters from zero, the f32 forms must not launch
    bf16 = torch.bfloat16

    def bf16_run(run, want):
        return _counted(modules, forms, run, want, "bf16 run")

    def bf16_pair(base):
        kern = pipeline.Engine(dataclasses.replace(
            base, compute_dtype="bfloat16"), extrinsics=engine.extrinsics,
            params=nets, device=dev)
        plain = pipeline.Engine(dataclasses.replace(
            base, compute_dtype="bfloat16", detector_stem_backend="xla",
            orientation_stem_backend="xla", grid_backend="xla",
            knn_backend="xla"), extrinsics=engine.extrinsics, params=nets,
            device=dev)
        return kern, plain

    bf_engine, bf_plain = bf16_pair(cfg)
    bf_obs = obs_seq[:BF16_ENGINE_TICKS]
    zero = {name: 0 for name in list(modules) + list(forms)}
    (_, outs, times), bf_engine_launches = bf16_run(
        lambda: run_ticks(torch, bf_engine, bf_obs),
        dict(zero, detector_stem_bf16=BF16_ENGINE_TICKS,
             grid_update=BF16_ENGINE_TICKS,
             knn_median_depth=BF16_ENGINE_TICKS))
    _, plain_outs, plain_times = run_ticks(torch, bf_plain, bf_obs)
    phase("engine_bf16", ticks=BF16_ENGINE_TICKS, launches=bf_engine_launches,
          median_tick_ms=statistics.median(times),
          plain_median_tick_ms=statistics.median(plain_times),
          **compare_bf16(torch, cfg, outs, plain_outs))
    del outs, plain_outs, bf_engine, bf_plain

    bf_fleet, bf_fplain = bf16_pair(fleet_cfg)
    bf_pool = FleetPool(fleet_cfg, N_RIGS, device=dev, image_dtype=bf16)
    first = bf_pool.obs(0)
    if first.image.dtype != bf16 or not torch.equal(
            first.image, fleet_obs[0].image.to(bf16)):
        fail("the bf16 pool's frames are not the f32 pool's")
    del first
    # the same frames as the f32 fleet phase, stored in bf16 (8-bit pixels
    # are exact in it)
    bf_fobs = [dataclasses.replace(o, image=o.image.to(bf16))
               for o in fleet_obs[:BF16_FLEET_TICKS]]
    (_, fouts, ftimes), bf_launches = bf16_run(
        lambda: run_fleet(torch, bf_fleet, bf_fobs, BUDGET),
        dict(zero, grid_update=BF16_FLEET_TICKS,
             knn_median_depth=BF16_FLEET_TICKS,
             **{name: BF16_FLEET_TICKS for name in forms}))
    _, fplain_outs, fplain_times = run_fleet(torch, bf_fplain, bf_fobs,
                                             BUDGET)
    med, pmed = statistics.median(ftimes), statistics.median(fplain_times)
    f32_med = statistics.median(fleet_times)
    bf16_rate = N_RIGS / med * 1e3
    phase("fleet_bf16", rigs=N_RIGS, ticks=BF16_FLEET_TICKS, budget=BUDGET,
          launches=bf_launches, median_tick_ms=med,
          plain_median_tick_ms=pmed, f32_median_tick_ms=f32_med,
          rig_frames_per_s=N_RIGS / med * 1e3,
          f32_rig_frames_per_s=N_RIGS / f32_med * 1e3,
          plain_rig_frames_per_s=N_RIGS / pmed * 1e3, tick_ms=ftimes,
          **compare_bf16(torch, fleet_cfg, fouts, fplain_outs),
          dropped_per_tick=[int(o.saturation.orientation_dropped.sum())
                            for o in fouts])
    del fouts, fplain_outs, bf_fplain
    torch.cuda.empty_cache()
    profiles["kernels_bf16"] = profile_fleet(torch, bf_fleet, bf_fobs[0],
                                             BUDGET)
    phase("profile", path="fleet_bf16/kernels", **profiles["kernels_bf16"])
    phase("library_convs", card=card, **{
        f"fleet/{name}": profiles[name]["library_conv_ms"]
        for name in ("kernels", "kernels_bf16")})
    for kernel, prefix in (("detector_stem_bf16", "gv_stem_"),
                           ("detector_csp_bf16", "gv_csp_"),
                           ("orient_front_bf16", "gv_orient_")):
        device_ms[kernel] = sum(
            row["ms_per_tick"]
            for row in profiles["kernels_bf16"]["port_kernels"]
            if prefix in row["name"])
        if not device_ms[kernel] > 0.0:
            fail(f"the profile shows no device time for {kernel}")
    # the bf16 stem's device time a launch: it launches once a fleet tick
    # (the wrappers' counts in fleet_bf16), and the profiler may drop an
    # event of a run, so its device_ms is the time of a recorded launch
    stem_rows = [row for row in profiles["kernels_bf16"]["port_kernels"]
                 if "gv_stem_" in row["name"]]
    recorded = sum(r["launches_per_tick"] for r in stem_rows)
    device_ms["detector_stem_bf16"] /= recorded
    phase("stem_bf16_profile", rows=stem_rows,
          device_ms_per_call=device_ms["detector_stem_bf16"],
          recorded_launches_per_tick=recorded)
    # the same for the bf16 orientation front (one launch a fleet tick)
    orient_rows = [row for row in profiles["kernels_bf16"]["port_kernels"]
                   if "gv_orient_" in row["name"]]
    recorded = sum(r["launches_per_tick"] for r in orient_rows)
    phase("orient_bf16_profile", rows=orient_rows,
          device_ms_per_tick=device_ms["orient_front_bf16"],
          device_ms_per_call=device_ms["orient_front_bf16"] / recorded,
          recorded_launches_per_tick=recorded,
          wrapper_launches_per_tick=bf_launches["orient_front_bf16"]
          / BF16_FLEET_TICKS)
    # the same for the bf16 CSP stage, with its phase clocks (cycles a step
    # by phase, thread 0's, from the kernel check at 64 frames)
    csp_rows = [row for row in profiles["kernels_bf16"]["port_kernels"]
                if "gv_csp_" in row["name"]]
    recorded = sum(r["launches_per_tick"] for r in csp_rows)
    phase("csp_bf16_profile", rows=csp_rows,
          device_ms_per_tick=device_ms["detector_csp_bf16"],
          device_ms_per_call=device_ms["detector_csp_bf16"] / recorded,
          recorded_launches_per_tick=recorded,
          wrapper_launches_per_tick=bf_launches["detector_csp_bf16"]
          / BF16_FLEET_TICKS,
          clocks=checked["fleet", "detector_csp_bf16"]["clocks"])
    del bf_fleet, bf_fobs
    torch.cuda.empty_cache()

    # 7. the extension-mode tick at full width, counters from zero: the
    # single-rig Engine, then the fleet
    ext = dict(compat=False, raycast_free_space=True,
               vision_depth_refine=True, class_aware_nms=True)

    def ext_pair(base):
        """The extension engine on the kernel backends and on the plain."""
        kern = pipeline.Engine(dataclasses.replace(base, **ext),
                               extrinsics=engine.extrinsics, params=nets,
                               device=dev)
        plain = pipeline.Engine(dataclasses.replace(
            base, **ext, detector_stem_backend="xla",
            orientation_stem_backend="xla", grid_backend="xla",
            knn_backend="xla"), extrinsics=engine.extrinsics, params=nets,
            device=dev)
        return kern, plain

    def count_run(run, want):
        return _counted(modules, forms, run, want, "extension tick")

    ext_engine, ext_plain = ext_pair(cfg)
    ext_obs = obs_seq[:EXT_ENGINE_TICKS]
    (_, outs, times), ext_engine_launches = count_run(
        lambda: run_ticks(torch, ext_engine, ext_obs),
        dict(detector_stem=EXT_ENGINE_TICKS, grid_update=0,
             knn_median_depth=EXT_ENGINE_TICKS, detector_csp=0,
             orient_front=0, carve_update=EXT_ENGINE_TICKS))
    _, plain_outs, plain_times = run_ticks(torch, ext_plain, ext_obs)
    agree, n_boxes, n_poses = compare_outputs(torch, cfg, outs, plain_outs,
                                              per_rig=False)
    shares = carved_shares(torch, cfg, ext_obs, engine.extrinsics)
    if not max(shares) > 0.0:
        fail("the extension tick's scans carved no cell")
    phase("extension", path="engine", ticks=EXT_ENGINE_TICKS,
          launches=ext_engine_launches, carved_share_per_tick=shares,
          median_tick_ms=statistics.median(times),
          plain_median_tick_ms=statistics.median(plain_times),
          min_occupancy_i8_agreement=agree, boxes_per_tick=n_boxes,
          poses_per_tick=n_poses,
          free_cells_last=int((outs[-1].occupancy_i8 < 50).sum()),
          occupied_cells_last=int((outs[-1].occupancy_i8 > 50).sum()))
    del outs, plain_outs, ext_engine, ext_plain

    ext_fleet, ext_fplain = ext_pair(fleet_cfg)
    ext_fobs = fleet_obs[:EXT_FLEET_TICKS]
    (_, fouts, ftimes), ext_launches = count_run(
        lambda: run_fleet(torch, ext_fleet, ext_fobs, BUDGET),
        dict({name: EXT_FLEET_TICKS for name in modules}, grid_update=0,
             int8_conv=0, conv_epilogue=0))
    _, fplain_outs, fplain_times = run_fleet(torch, ext_fplain, ext_fobs,
                                             BUDGET)
    fagree, f_boxes, f_poses = compare_outputs(torch, fleet_cfg, fouts,
                                               fplain_outs, per_rig=True)
    shares = carved_shares(torch, fleet_cfg, ext_fobs, engine.extrinsics)
    if not max(shares) > 0.0:
        fail("the extension fleet tick's scans carved no cell")
    med, pmed = statistics.median(ftimes), statistics.median(fplain_times)
    phase("extension", path="fleet", rigs=N_RIGS, ticks=EXT_FLEET_TICKS,
          budget=BUDGET, knn_queries_per_rig=fleet_cfg.max_detections,
          launches=ext_launches, carved_share_per_tick=shares,
          median_tick_ms=med, plain_median_tick_ms=pmed,
          rig_frames_per_s=N_RIGS / med * 1e3,
          plain_rig_frames_per_s=N_RIGS / pmed * 1e3,
          min_occupancy_i8_agreement_per_rig=fagree, boxes_per_tick=f_boxes,
          poses_per_tick=f_poses,
          static_depth_clamped=int(sum(
              o.saturation.static_depth_clamped.sum() for o in fouts)))
    del fouts, fplain_outs, ext_fplain
    torch.cuda.empty_cache()
    ext_profile = profile_fleet(torch, ext_fleet, ext_fobs[0], BUDGET)
    phase("profile", path="extension_fleet/kernels", **ext_profile)
    device_ms["carve_update"] = sum(
        row["ms_per_tick"] for row in ext_profile["port_kernels"]
        if "gv_carve_" in row["name"])
    if not device_ms["carve_update"] > 0.0:
        fail("the profile shows no device time for carve_update")

    # yaw-aware rasterization in the carve's place: plain torch on every
    # backend, shown to run on the card, single rig and fleet
    yaw = dict(compat=False, yaw_aware_rasterization=True)
    yaw_engine = pipeline.Engine(dataclasses.replace(cfg, **yaw),
                                 extrinsics=engine.extrinsics, params=nets,
                                 device=dev)
    _, outs, _ = run_ticks(torch, yaw_engine, obs_seq[:YAW_TICKS])
    _, ref_outs, _ = run_ticks(torch, engine, obs_seq[:YAW_TICKS])
    yaw_fleet = pipeline.Engine(dataclasses.replace(fleet_cfg, **yaw),
                                extrinsics=engine.extrinsics, params=nets,
                                device=dev)
    _, fouts, _ = run_fleet(torch, yaw_fleet, fleet_obs[:YAW_TICKS], BUDGET)
    for o in outs + fouts:
        if not torch.isfinite(o.poses.position[o.poses.valid]).all():
            fail("non-finite pose in a yaw-aware tick")
    phase("extension", path="yaw_aware", ticks=YAW_TICKS,
          occupied_cells_last=int((outs[-1].occupancy_i8 > 50).sum()),
          axis_aligned_occupied_cells_last=int(
              (ref_outs[-1].occupancy_i8 > 50).sum()),
          fleet_occupied_cells_last=int((fouts[-1].occupancy_i8 > 50).sum()))

    del ext_fleet, yaw_engine, yaw_fleet, outs, ref_outs, fouts
    torch.cuda.empty_cache()

    # 7b. the PCA pose branch (use_vision_orientation=False): RANSAC
    # ground plane, frustum association, PCA L-shape in place of the
    # orientation net; the orientation kernel must not launch
    pca_launches, pca_bf_launches = pca_phases(
        torch, dev, engine, cfg, fleet_cfg, nets, obs_seq, fleet_obs,
        modules, forms, fleet_times, card)

    # the kernel path at full width against the JAX package's outputs
    phase("jax_fixture", **jax_fixture(torch, dev, root, cfg, nets,
                                       engine.extrinsics))

    # the streaming ingest path: the packed wire, replay, record / play
    stream_launches = stream_phases(torch, dev, root, cfg, nets,
                                    engine.extrinsics, modules, forms)

    # the multi-object tracker behind the tick: single rig, the JAX
    # fixture, the MOT replay, the fleet, the tracker's cost
    tracked_launches = tracked_phases(
        torch, dev, root, cfg, nets, engine.extrinsics, fleet_cfg, fleet_obs,
        modules, forms, card)

    # the parallel layer (Fleet, SharedGrid, CityGrid, MultiFleet) and the
    # fleet server
    parallel_phases(torch, dev, root, fleet_cfg, nets, engine.extrinsics,
                    fleet_obs, modules, forms, card)
    served_launches = serve_phases(torch, dev, root, fleet_cfg, nets, pool,
                                   modules, forms, card)

    # training and evaluation: train steps, the CLI's trainers, the fleet
    # tick on their weights; mAP and pose quality through the kernels
    trained_launches = train_phases(torch, dev, root, fleet_cfg, fleet_obs,
                                    engine.extrinsics, modules, forms, card)
    eval_launches = eval_phases(torch, dev, root, modules, forms, card)

    # the CLI's bench, demo and view; the f32 ticks under torch's defaults
    bench_launches = bench_phases(torch, dev, root, modules, forms, card,
                                  bf16_rate)
    cli_phase(torch, dev, root, card)
    tf32_phase(torch, root, card)

    # the last modules: the int8 detector (and the int8 Pallas tool's
    # counterpart), the five knobs, the training mesh
    int8_launches = int8_phases(torch, dev, root, cfg, fleet_cfg, nets,
                                engine.extrinsics, obs_seq, fleet_obs,
                                modules, forms, card)
    int8_mma_phase(torch, dev, card)
    knobs_phases(torch, dev, root, cfg, fleet_cfg, nets, engine.extrinsics,
                 fleet_obs, modules, forms, card)
    mesh_phase(torch, dev, card)

    # 8. the kernels line, then the card, then the device JSON
    launches["carve_update"] = ext_launches["carve_update"]
    engine_launches["carve_update"] = ext_engine_launches["carve_update"]
    launches["int8_conv"] = int8_launches["fleet"]["int8_conv"]
    engine_launches["int8_conv"] = int8_launches["engine"]["int8_conv"]
    for name in forms:
        launches[name] = bf_launches[name]
        engine_launches[name] = bf_engine_launches[name]
    kernels = []
    for name, r in results.items():
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[name],
            launches_single_rig_path=engine_launches[name],
            max_abs_err=r["max_abs_err"], matched=True, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            shape=r["shape"]))
        if name in device_ms:
            kernels[-1].update(device_ms=device_ms[name],
                               check_device_ms=r["check_device_ms"])
        kernels[-1]["launches_pca_fleet"] = (
            pca_bf_launches if name in forms else pca_launches)[name]
        kernels[-1]["launches_stream"] = stream_launches[
            "bf16" if name in forms else "extension"
            if name == "carve_update" else "f32"][name]
        kernels[-1]["launches_tracked"] = tracked_launches[
            1 if name in forms else 2 if name == "carve_update" else 0][name]
        kernels[-1]["launches_served"] = served_launches[
            1 if name in forms else 0][name]
        kernels[-1]["launches_trained_fleet"] = trained_launches[
            1 if name in forms else 0][name]
        kernels[-1]["launches_eval_map"] = eval_launches[name]
        kernels[-1]["launches_bench"] = {
            mode: counts[name] for mode, counts in bench_launches.items()}
        for key in ("bound_3xtf32_ms", "bound_old_bytes_ms", "gated_off",
                    "bit_equal_share", "toward_zero_share"):
            if key in r:
                kernels[-1][key] = r[key]
        if name == "knn_median_depth":
            kernels[-1].update(queries=r["queries"], slices=r["slices"],
                               other_shapes=knn_other)
        if name == "int8_conv":
            # a forward's 19 launches at 64 frames; its paths: the int8
            # ticks (phase int8); one frame beside it
            one = checked["engine", "int8_conv"]
            kernels[-1].update(
                also_replaces=r["also_replaces"], path="int8 ticks",
                check_device_ms=r["check_device_ms"], acc_ms=r["acc_ms"],
                gemm_ms=r["gemm_ms"], single_rig=dict(
                    {k: one[k] for k in ("ms", "plain_ms", "library_ms",
                                         "shape")},
                    bound_ms=one["bound"][0]))
    kernels[-1].update(single_rig={
        k: carve_single[k] for k in ("ms", "plain_ms", "shape")},
        single_rig_bound_ms=carve_single["bound"][0],
        launches_extension_fleet=ext_launches)
    # the conv epilogue runs on YOLOv4's path alone (phase 3's fleet ticks);
    # every YOLOv4-tiny run above counted it 0
    epi, epi32 = (checked[path, "conv_epilogue"]
                  for path in ("yolov4", "yolov4_f32"))
    kernels.append(dict(
        name="conv_epilogue", route="cuda", source=epi["source"],
        replaces=epi["replaces"], path="YOLOv4 fleet ticks",
        launches=epi["launches_main_path"],
        launches_per_tick=YOLOV4_CONVS,
        launches_single_rig_path=engine_launches["conv_epilogue"],
        launches_tiny_fleet=launches["conv_epilogue"],
        max_abs_err=epi["max_abs_err"], matched=True, ms=epi["ms"],
        plain_ms=epi["plain_ms"], bound_ms=epi["bound"][0],
        bound_by=epi["bound"][1], library_ms=epi["library_ms"],
        shape=epi["shape"], dtype=epi["dtype"],
        check_device_ms=epi["check_device_ms"],
        bit_equal_convs=epi["bit_equal_convs"],
        heads_bit_equal=epi["heads_bit_equal"],
        f32={k: epi32[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                   "check_device_ms", "bit_equal_convs",
                                   "heads_bit_equal", "launches_main_path")},
        f32_bound_ms=epi32["bound"][0]))
    spilled = [ln for lines in regs.values() for ln in lines
               if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                ln)]
    if spilled:
        fail(f"a kernel spills registers: {spilled}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
