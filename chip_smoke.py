#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Imports nothing of JAX or of the JAX
package. Phases, each printing one line:

1. the card (name and power limit from nvidia-smi); TF32 off;
2. build the kernels of csrc/ (one nvcc per source, in parallel), timed;
3. each kernel against its plain torch twin on the card at the main path's
   full shapes: max |error|, the kernel's time, the twin's time and a
   PyTorch library yardstick, with the least time the card could take;
4. the Engine at full width (480x640 frames, detector 416, orientation
   224 / width 32, 16384 points, 500x200 grid, shipped weights) for
   TICKS ticks of a synthetic scene: every kernel's launch counter must
   advance once per tick, and the outputs must agree with the same weights
   run through the plain-torch backends ("xla") on the same card;
5. a `kernels` JSON line for every ported kernel.

Any failure exits non-zero. The last line is the device JSON.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

TICKS = 20
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_FP32_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores


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


def check_stem(torch, gv, dev, detector, cfg):
    """Fused resize + ConvBN_0 + ConvBN_1 at 480x640 -> 416 -> 104."""
    import torch.nn.functional as F
    from grid_vision_tpu_torch.models.layers import same_pad
    from grid_vision_tpu_torch.ops import cuda_stem, preprocess
    g = torch.Generator(device=dev).manual_seed(1)
    h, w, size = cfg.camera_image_height, cfg.camera_image_width, cfg.resize
    img = torch.rand((1, h, w, 3), generator=g, device=dev) * 255.0
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
        x = preprocess.preprocess_detector_image(img[0], size)
        x = x.permute(2, 0, 1)[None]
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
    ops = (2 * h * size * 3 * tx.shape[1] + 2 * size * size * 3 * ty.shape[1]
           + 2 * s0 * s0 * 32 * 27 + 2 * s1 * s1 * 64 * 288)
    n_bytes = (img.numel() + got.numel() + 27 * 32 + 288 * 64 + 192) * 4
    return dict(
        name="detector_stem", source="grid_vision_tpu_torch/csrc/cuda_stem.cu",
        replaces="grid_vision_tpu/ops/pallas_stem.py:359",
        max_abs_err=(got - ref).abs().max().item(),
        ms=cuda_time_ms(lambda: cuda_stem.detector_stem_cuda(img, consts,
                                                             size)),
        plain_ms=cuda_time_ms(lambda: cuda_stem.detector_stem_plain(
            img, consts, size)),
        library_ms=cuda_time_ms(library), bound=bound_ms(n_bytes, ops))


def check_grid(torch, gv, dev, cfg):
    """Fused decay + hits + clamp + sigmoid on the 500x200 grid, 8 boxes."""
    from grid_vision_tpu_torch.ops import cuda_grid
    from grid_vision_tpu_torch.types import LShapePoses
    g = torch.Generator(device=dev).manual_seed(2)
    h, w = cfg.grid_size
    lo = torch.rand((h, w), generator=g, device=dev) * 5.6 - 2.0
    n = cfg.max_orientation_batch
    u = torch.rand((n, 4), generator=g, device=dev)
    empty = LShapePoses.empty(n, device=dev)
    poses = dataclasses.replace(
        empty,
        position=torch.stack([u[:, 0] * 60 - 15, u[:, 1] * 30 - 15,
                              torch.zeros(n, device=dev)], dim=-1),
        length=u[:, 2] * 6 + 0.3, width=u[:, 3] * 3 + 0.3,
        valid=torch.ones(n, dtype=torch.bool, device=dev))
    ranges = cuda_grid.box_index_ranges(poses, cfg)
    lo_k, occ_k = cuda_grid.grid_update(lo, ranges, cfg)
    torch.cuda.synchronize()
    lo_p, occ_p = cuda_grid.grid_update_plain(lo, ranges, cfg)
    if not torch.equal(lo_k, lo_p):
        fail("grid kernel log-odds are not bit-equal to the twin")
    if not torch.allclose(occ_k, occ_p, rtol=0, atol=1e-7):
        fail("grid kernel occupancy disagrees with the twin")
    n_bytes = 3 * h * w * 4 + ranges.numel() * 4
    ops = h * w * (n + 8)
    return dict(
        name="grid_update", source="grid_vision_tpu_torch/csrc/cuda_grid.cu",
        replaces="grid_vision_tpu/ops/pallas_grid.py:97",
        max_abs_err=max((lo_k - lo_p).abs().max().item(),
                        (occ_k - occ_p).abs().max().item()),
        ms=cuda_time_ms(lambda: cuda_grid.grid_update(lo, ranges, cfg)),
        plain_ms=cuda_time_ms(lambda: cuda_grid.grid_update_plain(
            lo, ranges, cfg)),
        library_ms=None, bound=bound_ms(n_bytes, ops))


def check_knn(torch, gv, dev, cfg, obs):
    """k-NN median depth: 16384 projected points, 64 box centers."""
    from grid_vision_tpu_torch.geometry import intrinsic_matrix
    from grid_vision_tpu_torch.ops import association, cuda_knn
    K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    uvd, valid = association.project_cloud_to_image(obs.cloud, K)
    g = torch.Generator(device=dev).manual_seed(3)
    d = cfg.max_static_depth
    centers = torch.rand((d, 2), generator=g, device=dev) * torch.tensor(
        [cfg.camera_image_width, cfg.camera_image_height], device=dev)
    k = cfg.k_near
    got = cuda_knn.knn_median_depth_centers_cuda(uvd, valid, centers, k)
    torch.cuda.synchronize()
    ref = cuda_knn.knn_median_depth_plain(uvd, valid, centers, k)
    if not torch.allclose(got, ref, rtol=1e-6, atol=0):
        fail(f"kNN kernel disagrees with its twin: max |d| "
             f"{(got - ref).abs().max().item()}")
    c3 = torch.cat([centers, torch.zeros((d, 1), device=dev)], dim=1)

    def library():
        dist = torch.cdist(c3, uvd).masked_fill(~valid[None, :],
                                                float("inf"))
        vals, idx = torch.topk(dist, k, largest=False)
        z = torch.where(torch.isfinite(vals), uvd[:, 2][idx], float("inf"))
        n_found = torch.isfinite(vals).sum(-1)
        med = torch.sort(z, -1).values.gather(
            1, (n_found // 2).clamp(max=k - 1)[:, None])[:, 0]
        return torch.where(n_found > 0, med, -1.0)

    lib = library()
    lib_err = (lib - ref).abs().max().item()
    p_valid = int(valid.sum())
    n_bytes = uvd.numel() * 4 + valid.numel() + centers.numel() * 4 + d * 4
    ops = 7 * d * p_valid
    return dict(
        name="knn_median_depth", source="grid_vision_tpu_torch/csrc/cuda_knn.cu",
        replaces="grid_vision_tpu/ops/pallas_knn.py:72",
        max_abs_err=(got - ref).abs().max().item(),
        library_max_abs_err=lib_err,
        ms=cuda_time_ms(lambda: cuda_knn.knn_median_depth_centers_cuda(
            uvd, valid, centers, k)),
        plain_ms=cuda_time_ms(lambda: cuda_knn.knn_median_depth_plain(
            uvd, valid, centers, k)),
        library_ms=cuda_time_ms(library), bound=bound_ms(n_bytes, ops))


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


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is False; this "
             "smoke test runs only on a card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import grid_vision_tpu_torch as gv
        from grid_vision_tpu_torch import pipeline
        from grid_vision_tpu_torch.io.scene import SyntheticScene
        from grid_vision_tpu_torch.ops import (cuda_build, cuda_grid,
                                               cuda_knn, cuda_stem)
        from grid_vision_tpu_torch.runtime.stream import obs_from_scene
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
    cuda_build.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for n, log in cuda_build.ptxas_log.items()}
    phase("build", seconds=round(time.perf_counter() - t0, 3), ptxas=regs)

    # full-width configuration of the main path
    cfg = gv.GridVisionConfig(
        detection_weights_file="weights/detector.npz",
        vision_weights_file="weights/orientation.npz",
        detector_stem_backend="pallas", grid_backend="pallas",
        knn_backend="pallas")
    engine = pipeline.Engine(cfg, extrinsics=default_extrinsics(dev),
                             device=dev, base_dir=root)
    scene = SyntheticScene(cfg, seed=0, n_ground=15000)
    scene.add_default_traffic()
    scene.add_default_statics()
    obs_seq = [obs_from_scene(scene, i / 10.0, cfg, dev)
               for i in range(TICKS)]

    # 3. each kernel against its twin at the main path's shapes
    results = {}
    for fn, args in ((check_stem, (engine.params["detector"], cfg)),
                     (check_grid, (cfg,)),
                     (check_knn, (cfg, obs_seq[0]))):
        r = fn(torch, gv, dev, *args)
        torch.cuda.synchronize()
        results[r["name"]] = r
        phase("kernel", **{k: v for k, v in r.items() if k != "bound"},
              bound_ms=r["bound"][0], bound_by=r["bound"][1])

    # 4. the main path, counters from zero
    modules = {"detector_stem": cuda_stem, "grid_update": cuda_grid,
               "knn_median_depth": cuda_knn}
    for m in modules.values():
        m.launches = 0
    _, outs, times = run_ticks(torch, engine, obs_seq)
    launches = {name: m.launches for name, m in modules.items()}
    for name, n in launches.items():
        if n != TICKS:
            fail(f"{name} launched {n} times in {TICKS} ticks")
    plain_cfg = dataclasses.replace(cfg, detector_stem_backend="xla",
                                    grid_backend="xla", knn_backend="xla")
    plain = pipeline.Engine(plain_cfg, extrinsics=engine.extrinsics,
                            params=engine.params, device=dev)
    _, plain_outs, plain_times = run_ticks(torch, plain, obs_seq)
    agree, n_boxes = [], []
    for o, p in zip(outs, plain_outs):
        if o.occupancy_i8.shape != tuple(cfg.grid_size):
            fail(f"occupancy_i8 shape {tuple(o.occupancy_i8.shape)}")
        for name, t in (("static_points", o.static_points),
                        ("static_depths", o.static_depths),
                        ("boxes", o.boxes.xyxy[o.boxes.valid]),
                        ("poses", o.poses.position[o.poses.valid])):
            if not torch.isfinite(t).all():
                fail(f"non-finite {name} in a valid slot")
        agree.append((o.occupancy_i8 == p.occupancy_i8).float().mean()
                     .item())
        nb = (int(o.boxes.valid.sum()), int(p.boxes.valid.sum()))
        if nb[0] != nb[1]:
            fail(f"box counts differ from the plain path: {nb}")
        n_boxes.append(nb[0])
    if min(agree) < 0.999:
        fail(f"occupancy_i8 agreement {min(agree)} < 0.999")
    phase("engine", ticks=TICKS, launches=launches,
          median_tick_ms=statistics.median(times),
          plain_median_tick_ms=statistics.median(plain_times),
          min_occupancy_i8_agreement=min(agree), boxes_per_tick=n_boxes,
          poses_per_tick=[int(o.poses.valid.sum()) for o in outs],
          occupied_cells_last=int((outs[-1].occupancy_i8 > 50).sum()))

    # 5. the kernels line, then the card, then the device JSON
    kernels = []
    for name, r in results.items():
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], matched=True, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
