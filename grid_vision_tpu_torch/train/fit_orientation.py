"""MultiBin orientation training on the card: ``python -m
grid_vision_tpu_torch train orientation`` (counterpart of
grid_vision_tpu/train/fit_orientation.py).

Synthetic oriented-object crops rendered on the card: a rotated rectangle
with a brightness gradient along its heading encodes the observation angle
alpha; the net learns the MultiBin decomposition (bin confidence + per-bin
cos/sin offset). Dimension targets are zero residuals (the class-average
fallback: a standardized synthetic crop carries no metric size cue), unless
--scene-crops mixes in metric crops from the scene renderer. Produces the
weights of the engine's use_vision_orientation path (s2d arch; the stem
trains unfolded, s2d_fold=False, and serves folded: the same parameters;
--arch resnet trains the ResNet-18 net, orientation_arch="resnet").

The MultiBin target convention matches ops/multibin.compute_alpha:
alpha = atan2(sin, cos) + bin_center - pi, so the trained offset for a bin
is delta = wrap(alpha + pi - bin_center).
"""

from __future__ import annotations

import argparse
import functools
import math
import time

import numpy as np
import torch

from ..device import resolve_device
from ..utils import prng


def build_scene_crop_dataset(n_crops: int, size: int, seed: int = 4000,
                             device="cuda"):
    """Metric crops from the scene renderer (io/scene.py): the replay
    world's dynamic objects cropped through the production preprocessing
    (ops/preprocess.crop_resize_standardize), each labeled with its true
    dims residual (length, width, height) - class average
    (taxonomy.AVG_DIMS_LUT, the MultiBin anchor), cropped on `device` (the
    card unless the CPU is asked for). Returns (crops (N, size,
    size, 3) f32, dims_residual (N, 3) f32, labels (N,) i32) as numpy."""
    from ..config import GridVisionConfig
    from ..io.scene import SyntheticScene
    from ..ops import preprocess
    from ..taxonomy import AVG_DIMS_LUT, DYNAMIC_LUT
    from ..types import Boxes

    dev = resolve_device(device)
    cfg = GridVisionConfig()
    rng = np.random.default_rng(seed)
    crops = np.empty((n_crops, size, size, 3), np.float32)
    tgts = np.empty((n_crops, 3), np.float32)
    labels = np.empty((n_crops,), np.int32)
    i = s = 0
    w, h = cfg.camera_image_width, cfg.camera_image_height
    while i < n_crops:
        scene = SyntheticScene(cfg, seed=seed + s)
        s += 1
        scene.add_default_traffic()
        scene.add_random_traffic(rng, n_dynamic=3, n_static=0)
        t = float(rng.uniform(0.0, 2.5))
        img = torch.as_tensor(scene.image_at(t), dtype=torch.float32,
                              device=dev)
        for j, obj in enumerate(scene.objects):
            if i >= n_crops:
                break
            if not DYNAMIC_LUT[min(obj.label, 10)]:
                continue
            bb = scene.bbox_at(j, t)
            if bb is None:
                continue
            x0, y0 = max(0.0, bb["x_min"]), max(0.0, bb["y_min"])
            x1 = min(float(w), bb["x_max"])
            y1 = min(float(h), bb["y_max"])
            if x1 - x0 < 8.0 or y1 - y0 < 8.0:
                continue
            boxes = Boxes(
                xyxy=torch.tensor([[x0, y0, x1, y1]], dtype=torch.float32,
                                  device=dev),
                confidence=torch.ones((1,), device=dev),
                label=torch.tensor([obj.label], dtype=torch.int32,
                                   device=dev),
                valid=torch.ones((1,), dtype=torch.bool, device=dev))
            crops[i] = preprocess.crop_resize_standardize(
                img, boxes, size)[0].cpu().numpy()
            wx, hy, dz = obj.size      # camera-frame extents
            # LShapePose convention: length along heading (z), width
            # across (x), height vertical (y)
            tgts[i] = (np.asarray([dz, wx, hy], np.float32)
                       - AVG_DIMS_LUT[obj.label])
            labels[i] = obj.label
            i += 1
    return crops, tgts, labels


@functools.lru_cache(maxsize=None)
def _bins(device: torch.device) -> torch.Tensor:
    """The MultiBin bin centers on `device`, copied there once (a host copy
    inside a training chunk would synchronize the card)."""
    from ..ops.multibin import ANGLE_BINS_2
    return torch.as_tensor(ANGLE_BINS_2, device=device)


def render_crop(keys: torch.Tensor, size: int):
    """Standardized synthetic crops for (B, 2) keys with their targets:
    (crops (B, size, size, 3), tgt_bin (B,) int32, tgt_offset (B,))."""
    dev = keys.device
    k_a, k_ab, k_cls, k_noise = prng.split(keys, 4).unbind(-2)
    alpha = prng.uniform(k_a, (), -math.pi, math.pi)              # (B,)
    half = prng.uniform(k_ab, (2,), 0.15, 0.45)                   # (B, 2)
    cls_shade = prng.uniform(k_cls, (3,), 0.3, 1.0)               # (B, 3)

    axis = (torch.arange(size, dtype=torch.float32, device=dev) / size
            - 0.5) * 2.0
    yy, xx = axis[:, None], axis[None, :]
    c = torch.cos(alpha)[:, None, None]
    s = torch.sin(alpha)[:, None, None]
    u = c * xx + s * yy          # along heading
    v = -s * xx + c * yy
    h0, h1 = half[:, 0, None, None], half[:, 1, None, None]
    inside = (u.abs() < h0) & (v.abs() < h1)
    grad = (u / h0 + 1.0) / 2.0   # bright toward the heading
    img = torch.where(inside[..., None],
                      (0.3 + 0.7 * grad)[..., None]
                      * cls_shade[:, None, None, :], 0.1)
    img = img + prng.normal(k_noise, (size, size, 3)) * 0.02
    # per-crop standardization (the production preprocessing)
    mean = img.mean(dim=(1, 2), keepdim=True)
    std = torch.sqrt(((img - mean) ** 2).mean(dim=(1, 2), keepdim=True))
    crop = (img - mean) / torch.clamp(std, min=1e-6)

    bins = _bins(dev)
    delta = torch.remainder(alpha[:, None] + math.pi - bins + math.pi,
                            2.0 * math.pi) - math.pi           # per bin
    tgt_bin = torch.argmin(delta.abs(), dim=-1)
    off = torch.gather(delta, 1, tgt_bin[:, None])[:, 0]
    return crop, tgt_bin.to(torch.int32), off


def run_chunk(state, step_fn, keys: torch.Tensor, b_synth: int,
              b_scene: int, size: int, ds=()):
    """One chunk: a step per key of keys (S, 2), each on split(key) ->
    (synth key, scene key); b_synth rendered crops (angle targets, zero
    dims residuals) and b_scene crops of the uploaded metric set ds =
    (crops, dims residuals), each half gating its own head. Returns (state,
    losses (S,) on the card); no value is read back."""
    dev = keys.device
    if b_scene:
        # synth crops: angle signal only (no metric size cue); scene
        # crops: dims signal only (degenerate yaw)
        dim_w = torch.cat([torch.zeros(b_synth, device=dev),
                           torch.ones(b_scene, device=dev)])
        extra = (dim_w, 1.0 - dim_w)
    losses = []
    for kk in keys:
        k1, k2 = prng.split(kk).unbind(-2)
        crops, tgt_bin, tgt_off = render_crop(prng.split(k1, b_synth), size)
        tgt_dims = torch.zeros((b_synth, 3), device=dev)
        if b_scene:
            idx = prng.randint(k2, (b_scene,), 0, ds[0].shape[0]).long()
            crops = torch.cat([crops, ds[0][idx]])
            tgt_dims = torch.cat([tgt_dims, ds[1][idx]])
            tgt_bin = torch.cat([tgt_bin, torch.zeros_like(tgt_bin[:1])
                                 .expand(b_scene)])
            tgt_off = torch.cat([tgt_off, torch.zeros(b_scene, device=dev)])
            state, metrics = step_fn(state, crops, tgt_dims, tgt_bin,
                                     tgt_off, *extra)
        else:
            state, metrics = step_fn(state, crops, tgt_dims, tgt_bin,
                                     tgt_off)
        losses.append(metrics["loss"])
    return state, torch.stack(losses)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="grid_vision_tpu_torch train orientation", description=__doc__)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--scan", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="weights/orientation.npz")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--input-size", type=int, default=224)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--arch", default="s2d", choices=("s2d", "resnet"))
    ap.add_argument("--scene-crops", type=int, default=0,
                    help="mix in N metric crops from the scene renderer "
                         "(trains the dimension head on true dims "
                         "residuals; uploaded once)")
    ap.add_argument("--scene-frac", type=float, default=0.375,
                    help="fraction of each batch drawn from the metric "
                         "scene crops")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")

    from ..models.orientation_net import OrientationConfig
    from ..models.weights import flax_tree
    from ..utils import checkpoint
    from . import trainer

    size = args.input_size
    ocfg = OrientationConfig(input_size=size, width=args.width,
                             arch=args.arch, s2d_fold=False)
    tx = trainer.AdamW(trainer.warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=min(100, args.steps // 5),
        decay_steps=args.steps), weight_decay=1e-5)
    state = trainer.init_train_state("multibin", ocfg, tx,
                                     prng.prng_key(0, device=device))
    step_fn = trainer.make_train_step("multibin", ocfg, tx)

    b_scene = (int(round(args.batch * args.scene_frac))
               if args.scene_crops else 0)
    b_synth = args.batch - b_scene
    ds = ()
    if b_scene:
        print(f"rendering {args.scene_crops} metric scene crops...",
              flush=True)
        sc_crops, sc_dims, _ = build_scene_crop_dataset(
            args.scene_crops, size, device=device)
        ds = (torch.as_tensor(sc_crops, device=device),
              torch.as_tensor(sc_dims, device=device))

    n_chunks = max(args.steps // args.scan, 1)
    chunk_keys = torch.stack([prng.prng_key(2000 + c) for c in
                              range(n_chunks)]).to(device)
    t0 = time.time()
    chunk_losses = []
    for c in range(n_chunks):
        state, losses = run_chunk(state, step_fn,
                                  prng.split(chunk_keys[c], args.scan),
                                  b_synth, b_scene, size, ds)
        losses = losses.cpu().numpy()
        chunk_losses.append(losses)
        print(f"steps {c * args.scan}-{(c + 1) * args.scan - 1}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({time.time() - t0:.0f}s)", flush=True)

    checkpoint.save(args.out, flax_tree(state.model))
    print(f"saved orientation weights -> {args.out}")

    # quick angle-recovery eval on fresh crops
    from ..models import orientation_net
    from ..ops import multibin
    from ..ops.multibin import ANGLE_BINS_2
    model = state.model.eval()
    with torch.no_grad():
        crops, tgt_bin, tgt_off = render_crop(
            prng.split(prng.prng_key(9999, device=device), 64), size)
        orient, conf, _ = orientation_net.forward(model, crops,
                                                  dtype=ocfg.compute_dtype)
        alpha_hat = multibin.compute_alpha(orient, conf).cpu().numpy()
    bins = np.asarray(ANGLE_BINS_2)
    alpha_true = np.mod(bins[tgt_bin.cpu().numpy()] - np.pi
                        + tgt_off.cpu().numpy() + np.pi,
                        2 * np.pi) - np.pi
    err = np.abs(np.angle(np.exp(1j * (alpha_hat - alpha_true))))
    result = {"losses": np.stack(chunk_losses), "state": state,
              "angle_median_deg": float(np.degrees(np.median(err))),
              "angle_p90_deg": float(np.degrees(np.percentile(err, 90)))}
    print(f"angle recovery: median {result['angle_median_deg']:.1f} deg, "
          f"90pct {result['angle_p90_deg']:.1f} deg")

    if b_scene:
        # held-out metric-crop dims recovery (fresh seed stream)
        hc, hd, _ = build_scene_crop_dataset(64, size, seed=9_100_000,
                                             device=device)
        with torch.no_grad():
            _, _, dims_hat = orientation_net.forward(
                model, torch.as_tensor(hc, device=device),
                dtype=ocfg.compute_dtype)
        derr = np.abs(dims_hat.cpu().numpy() - hd)
        result["dims_median_m"] = float(np.median(derr))
        result["dims_p90_m"] = float(np.percentile(derr, 90))
        print(f"dims recovery: median |err| {result['dims_median_m']:.3f} "
              f"m, 90pct {result['dims_p90_m']:.3f} m")
    result["seconds"] = time.time() - t0
    return result


if __name__ == "__main__":
    main()
