#!/usr/bin/env python3
"""Device time by kernel name of the port's kernel wrappers, on one NVIDIA
card (grid_vision_tpu_torch; imports nothing of JAX):

    python3 tools/torch_kernel_times.py            # from the repo's root
    python3 tools/torch_kernel_times.py stem       # or: stem_bf16, knn,
                                                   # grid, carve, orient_bf16,
                                                   # csp_bf16
    python3 tools/torch_kernel_times.py carve --variant cuda_raycast:MACRO

torch.profiler over a few calls at the ticks' shapes (64 frames of 480x640
to 416, f32 or, for stem_bf16, the bf16 form on bf16 frames of integers;
64 rigs x 8192 points x 16 and 64 queries, one rig x 16384 x 64;
the gated grid and carve updates at 64 rigs and one rig of 500x200, every
fourth rig gated off; the orientation front's bf16 form at 320 crops over
64 bf16 frames and 5 crops over one; the CSP stage's bf16 form on the bf16
stem's output of 64 frames and of one, 8-bit frames, shipped weights);
prints one JSON line per shape with the microseconds
per call of every kernel of csrc/ (named gv_*). The quick look at where a
call's device time goes while a kernel is being worked on. `--variant
SOURCE:MACRO[,MACRO...]` first builds csrc/SOURCE.cu with a -D for each
MACRO (nvcc, the package's flags) into its own library, prints its ptxas
lines, and times it in place of the source as it is: a design alternative
kept behind a macro while it is measured. `stem_bf16 --variant
cuda_stem_bf16:GV_STEM_CLOCKS` also prints the bf16 stem's cycles a tile
and block of each phase at 64 frames, thread 0's (barrier to barrier)
and the mean warp's (to its arrival at the barrier); `orient_bf16
--variant cuda_orient_bf16:GV_ORIENT_CLOCKS` the bf16 orientation front's
cycles a block of each phase (thread 0's); `csp_bf16 --variant
cuda_csp_bf16:GV_CSP_CLOCKS` the bf16 CSP stage's cycles a step of each
phase (thread 0's).
chip_smoke.py holds the kernels to their twins and times whole calls.
"""

import ctypes
import json
import os
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from grid_vision_tpu_torch import GridVisionConfig  # noqa: E402
from grid_vision_tpu_torch.models import weights  # noqa: E402
from grid_vision_tpu_torch.ops import (cuda_build, cuda_csp,  # noqa: E402
                                       cuda_grid, cuda_knn, cuda_orient,
                                       cuda_raycast, cuda_stem, rasterize)


def kernel_us(fn, iters: int = 10):
    """{kernel name: microseconds per call of fn()} for the gv_* kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if "gv_" in e.name:
            name = e.name[e.name.index("gv_"):].split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return {k: round(v, 2) for k, v in out.items()}


def use_variant(spec: str) -> str:
    """Build csrc/SOURCE.cu with -DMACRO for each MACRO of
    SOURCE:MACRO[,MACRO...] (a MACRO may be NAME=VALUE) and load it in the
    source's place; returns the spec."""
    source, macros = spec.split(":")
    macros = tuple(macros.split(","))
    lib = cuda_build.load(source, macros)
    log = cuda_build.ptxas_log.get(cuda_build._key(source, macros), "")
    print(json.dumps(dict(variant=spec, ptxas=[
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln])), flush=True)
    cuda_build._libs[(source, ())] = lib
    for mod in (cuda_grid, cuda_raycast, cuda_knn, cuda_csp):
        for name in ("_entry", "_entry_bf16"):
            entry = getattr(mod, name, None)
            if entry is not None:
                entry.cache_clear()
    return spec


def stem_bf16_clocks(img, consts, size, calls: int = 5):
    """Cycles a tile and block by phase of the bf16 stem (a -DGV_STEM_CLOCKS
    build): bands and frame wait, x pass, y pass, conv0, next copies,
    conv1; thread 0's and the mean warp's."""
    fn = cuda_build.load("cuda_stem_bf16").gv_stem_bf16_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 12)()
    fn(ctypes.addressof(buf))                      # clear
    for _ in range(calls):
        cuda_stem.detector_stem_cuda(img, consts, size)
    torch.cuda.synchronize()
    cuda_build.check(fn(ctypes.addressof(buf)), "gv_stem_bf16_clocks")
    s1 = -(-(-(-size // 2)) // 2)
    tiles = calls * img.shape[0] * -(-s1 // 8) * -(-s1 // 16)
    phases = ["bands_and_wait", "x_pass", "y_pass", "conv0", "next_copies",
              "conv1"]
    return dict(kernel="stem_bf16_clocks", cycles_per_tile_thread0={
        p: buf[i] / tiles for i, p in enumerate(phases)},
        cycles_per_tile_mean_warp={p: buf[6 + i] / tiles / 8
                                   for i, p in enumerate(phases)})


def orient_bf16_clocks(call, calls: int = 5):
    """Cycles a block by phase of the bf16 orientation front (a
    -DGV_ORIENT_CLOCKS build), thread 0's view, over the valid crops'
    blocks: tap tables, x passes, y passes, moments and exchange,
    standardize, weights wait, conv, its epilogue, last cluster wait."""
    fn = cuda_build.load("cuda_orient_bf16").gv_orient_bf16_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 10)()
    fn(ctypes.addressof(buf))                      # clear
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    cuda_build.check(fn(ctypes.addressof(buf)), "gv_orient_bf16_clocks")
    phases = ["tables", "x_pass", "y_pass", "moments", "standardize",
              "weights_wait", "conv", "epilogue", "cluster_wait"]
    return dict(kernel="orient_bf16_clocks", blocks=buf[9] // calls,
                cycles_per_block={p: buf[i] / max(buf[9], 1)
                                  for i, p in enumerate(phases)})


def csp_bf16_clocks(call, calls: int = 5):
    """Cycles a step by phase of the bf16 CSP stage (a -DGV_CSP_CLOCKS
    build), thread 0's view (cuda_csp.csp_bf16_clocks)."""
    return dict(kernel="csp_bf16_clocks",
                **cuda_csp.csp_bf16_clocks(cuda_build.load("cuda_csp_bf16"),
                                           call, calls))


def grid_cases(dev, g):
    """Gated grid and carve inputs at 64 rigs and one rig: random log-odds,
    8 footprints a rig, every fourth rig gated off, the profile of a random
    scan around the sensor."""
    from grid_vision_tpu_torch.ops import raycast
    cfg = GridVisionConfig()
    for rigs in (64, 1):
        lo = torch.rand((rigs,) + cfg.grid_size, generator=g,
                        device=dev) * 5.6 - 2.0
        prev = torch.rand(lo.shape, generator=g, device=dev)
        gate = torch.arange(rigs, device=dev) % 4 != 3
        u = torch.rand((rigs, 8, 4), generator=g, device=dev)
        r0 = (u[..., 0] * 480).int()
        c0 = (u[..., 1] * 180).int()
        box = torch.stack([r0, r0 + (u[..., 2] * 60).int(), c0,
                           c0 + (u[..., 3] * 30).int()], -1).contiguous()
        origin = torch.tensor([1.5, 0.0], device=dev)
        pts = torch.rand((rigs, 4000, 2), generator=g, device=dev) * \
            torch.tensor([65.0, 18.0], device=dev) - \
            torch.tensor([20.0, 9.0], device=dev)
        valid = torch.ones((rigs, 4000), dtype=torch.bool, device=dev)
        ranges = raycast.range_profile(origin, pts, valid)
        cbin, cr = raycast.cell_polar_maps(origin, cfg)
        yield cfg, lo, prev, gate, box, ranges, cbin, cr


def orient_cases(dev, g, cfg):
    """bf16 frames of integers and random boxes (clamped, sliver and about
    10 % invalid ones among them, rigs sorted as the fleet compacts them):
    320 crops over 64 frames, 5 over one."""
    h, w = cfg.camera_image_height, cfg.camera_image_width
    for rigs, n in ((64, 320), (1, 5)):
        images = torch.randint(0, 256, (rigs, h, w, 3), generator=g,
                               device=dev).to(torch.bfloat16)
        u = torch.rand((n, 4), generator=g, device=dev)
        x0 = u[:, 0] * (w + 60) - 40
        y0 = u[:, 1] * (h + 60) - 40
        xyxy = torch.stack([x0, y0, x0 + 8 + u[:, 2] * 300,
                            y0 + 8 + u[:, 3] * 250], dim=-1)
        valid = torch.rand((n,), generator=g, device=dev) > 0.1
        rig = torch.sort(torch.randint(0, rigs, (n,), generator=g,
                                       device=dev)).values
        yield images, xyxy, valid, rig


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    args = sys.argv[1:]
    variant = None
    if "--variant" in args:
        i = args.index("--variant")
        variant = use_variant(args[i + 1])
        del args[i:i + 2]
    which = set(args) or {"stem", "knn"}
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    if "knn" in which:
        for r, p, d in ((64, 8192, 16), (64, 8192, 64), (1, 16384, 64)):
            uvd = torch.rand((r, p, 3), generator=g, device=dev) * \
                torch.tensor([640.0, 480.0, 60.0], device=dev)
            valid = torch.rand((r, p), generator=g, device=dev) > 0.1
            centers = torch.rand((r, d, 2), generator=g, device=dev) * \
                torch.tensor([640.0, 480.0], device=dev)
            got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers,
                                                         4)
            ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, 4)
            print(json.dumps(dict(
                kernel="knn", shape=[r, p, d], equal=bool(torch.equal(got,
                                                                      ref)),
                us=kernel_us(lambda: cuda_knn.knn_median_depth_centers_cuda(
                    uvd, valid, centers, 4)))), flush=True)
    if "stem" in which:
        cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
        det = weights.load_all(cfg, device=dev)["detector"]
        consts = cuda_stem.prepare_stem_constants(det)
        for batch in (64, 1):
            img = torch.rand((batch, 480, 640, 3), generator=g,
                             device=dev) * 255
            print(json.dumps(dict(
                kernel="stem", shape=list(img.shape),
                us=kernel_us(lambda: cuda_stem.detector_stem_cuda(
                    img, consts, cfg.resize)))), flush=True)
    if "stem_bf16" in which:
        cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
        det = weights.load_all(cfg, device=dev)["detector"]
        consts = cuda_stem.prepare_stem_constants(det, torch.bfloat16)
        for batch in (64, 1):
            img = torch.randint(0, 256, (batch, 480, 640, 3), generator=g,
                                device=dev).to(torch.bfloat16)
            print(json.dumps(dict(
                kernel="stem_bf16", variant=variant, shape=list(img.shape),
                us=kernel_us(lambda: cuda_stem.detector_stem_cuda(
                    img, consts, cfg.resize)))), flush=True)
            if batch == 64 and variant and "GV_STEM_CLOCKS" in variant:
                print(json.dumps(stem_bf16_clocks(img, consts, cfg.resize)),
                      flush=True)
    if "csp_bf16" in which:
        cfg = GridVisionConfig(detection_weights_file="weights/detector.npz")
        det = weights.load_all(cfg, device=dev)["detector"]
        stem = cuda_stem.prepare_stem_constants(det, torch.bfloat16)
        consts = cuda_csp.prepare_csp_constants(det, torch.bfloat16)
        for batch in (64, 1):
            img = torch.randint(0, 256, (batch, 480, 640, 3), generator=g,
                                device=dev).to(torch.bfloat16)
            x = cuda_stem.detector_stem_cuda(img, stem, cfg.resize)
            with torch.no_grad():
                us = kernel_us(lambda: cuda_csp.detector_csp_cuda(
                    x, det, consts))
            print(json.dumps(dict(kernel="csp_bf16", variant=variant,
                                  shape=list(x.shape), us=us)), flush=True)
            if variant and "GV_CSP_CLOCKS" in variant:
                print(json.dumps(csp_bf16_clocks(
                    lambda: cuda_csp.detector_csp_cuda(x, det, consts))),
                    flush=True)
    if "orient_bf16" in which:
        cfg = GridVisionConfig(vision_weights_file="weights/orientation.npz")
        net = weights.load_all(cfg, device=dev)["orientation"]
        consts = cuda_orient.prepare_orient_constants(net, torch.bfloat16)
        size = cfg.network_height
        for images, xyxy, valid, rig in orient_cases(dev, g, cfg):
            with torch.no_grad():
                us = kernel_us(lambda: cuda_orient.orient_front_cuda(
                    images, xyxy, valid, rig, net, consts, size))
            print(json.dumps(dict(
                kernel="orient_bf16", variant=variant,
                shape=[int(xyxy.shape[0]), int(images.shape[0])],
                crops_valid=int(valid.sum()), us=us)), flush=True)
            if variant and "GV_ORIENT_CLOCKS" in variant:
                print(json.dumps(orient_bf16_clocks(
                    lambda: cuda_orient.orient_front_cuda(
                        images, xyxy, valid, rig, net, consts, size))),
                    flush=True)
    for cfg, lo, prev, gate, box, ranges, cbin, cr in (
            grid_cases(dev, g) if which & {"grid", "carve"} else ()):
        calls = {}
        if "grid" in which:
            calls["grid"] = (
                lambda: cuda_grid.grid_update_gated(lo, box, gate, prev, cfg),
                lambda: cuda_grid.grid_update_plain(lo, box, cfg))
        if "carve" in which:
            calls["carve"] = (
                lambda: cuda_raycast.fused_carve_update_gated(
                    lo, box, ranges, cbin, cr, gate, prev, cfg),
                lambda: cuda_raycast.carve_update_plain(
                    lo, box, ranges, cbin, cr, cfg))
        for name, (fn, plain) in calls.items():
            got = fn()
            ref = rasterize.gate_and_export(*plain(), gate, lo, prev)
            equal = torch.equal(got[0], ref[0]) and torch.equal(got[2],
                                                                ref[2])
            print(json.dumps(dict(kernel=name, variant=variant,
                                  shape=list(lo.shape), equal=equal,
                                  us=kernel_us(fn, 50))), flush=True)


if __name__ == "__main__":
    main()
