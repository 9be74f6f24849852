"""Calibrate YOLOv4's weights recipe and write it (weights/yolov4_seeded.npz).

    python3 benchmark/tools/yolov4_recipe.py [--out weights/yolov4_seeded.npz]
        [--json FILE]

On the card. The recipe (benchmark/detectors/yolov4.py's docstring) draws
every weight from a seed; its gains are fixed here (GAINS), and the heads'
biases are what this tool sets. It renders the frames of the r128.ahead
pool (128 rigs, every seed the same scenes; POOL_SEED orders them), runs
the shipped YOLOv4-tiny (reference.detect_dense, f32) and the YOLOv4
plain reference (f32, its heads' biases zero) on them once, and then
searches the biases on the raw heads alone, each candidate decoded and
extracted as the engine does (threshold 0.6, the top 256 candidates,
class-agnostic NMS at IoU 0.6, 64 kept). The objectness bias is one for
the three heads; the class biases are 0 for the static classes and d for
the dynamic ones (9, 0, 1, 2). For each d on a grid the objectness bias is
bisected to the tiny's kept boxes a frame; the tool keeps the d whose
dynamic share comes nearest the tiny's and checks the targets:

  - kept boxes a frame within +-25 % of the tiny's;
  - the dynamic share of the kept boxes within 10 points of the tiny's;
  - no frame with above-threshold anchors beyond max_candidates (256).

It prints, and writes to --json, both nets' figures (kept boxes a frame,
dynamic share, the largest count of above-threshold anchors a frame and
the overflow, the share of kept confidences within 0.05 of the threshold
and of all anchors' best confidences within 0.05 of it), the recipe, and
the activation RMS at each stage of the first 32 frames. It writes the
recipe of the candidate it keeps, and exits 1 if a target is missed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import core, reference as ref  # noqa: E402
from benchmark.detectors import yolov4 as y4  # noqa: E402

SEED = 4170416                       # below 2^24: load_net reads float32
POOL_SEED = 2600000000
GAINS = dict(mish_gain=1.55, leaky_gain=1.45, bn_spread=0.1, res_scale=0.3,
             box_gain=0.3, logit_gain=8.0)
DYNAMIC = (9, 0, 1, 2)
# the layers whose output RMS the tool reports: each CSP stage, SPP, the
# PANet's top-down outputs and the three heads' inputs
STAGES = (10, 23, 54, 85, 104, 113, 116, 126, 136, 137, 148, 159)


def recipe(obj_bias, cls_bias) -> dict:
    out = {"seed": np.float32(SEED)}
    out.update({k: np.float32(v) for k, v in GAINS.items()})
    out["obj_bias"] = np.asarray(obj_bias, np.float32)
    out["cls_bias"] = np.asarray(cls_bias, np.float32)
    return out


def figures(torch, boxes, confs, c) -> dict:
    """The engine's extraction of every frame's dense outputs -> kept
    boxes a frame, dynamic share, above-threshold anchors, the overflow,
    the confidences near the threshold."""
    thr = c["confidence_threshold"]
    best = confs.max(-1).values
    kept, ovf = ref.extract_boxes(boxes, confs, c)
    labels = kept.label[kept.valid]
    n = int(kept.valid.sum())
    dyn = sum(int((labels == d).sum()) for d in DYNAMIC)
    conf = kept.confidence[kept.valid]
    return dict(
        kept_per_frame=n / boxes.shape[0],
        dynamic_share=dyn / max(n, 1),
        above_thr_max=int((best >= thr).sum(-1).max()),
        overflow=int(ovf.sum()),
        kept_near_thr=float(((conf - thr).abs() < 0.05).float().mean())
        if n else 0.0,
        anchors_near_thr=float(((best - thr).abs() < 0.05).float().mean()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "weights",
                                                  "yolov4_seeded.npz"))
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    import torch
    ref.ieee()
    device = "cuda" if torch.cuda.is_available() else "cpu"
    _, _, config, traffic, _ = core.load_cell("bf16-fleet.r128.ahead")
    c = config["engine"]
    size = c["detection_network_input_size"]
    pool, _ = core.build_pool(torch, config, traffic, POOL_SEED, device)
    images = pool.image
    tiny = core.weights(config, device)
    with torch.no_grad():
        tb, tc = zip(*[ref.detect_dense(tiny, images[i:i + 32], size)
                       for i in range(0, images.shape[0], 32)])
    want = figures(torch, torch.cat(tb), torch.cat(tc), c)
    print(f"[recipe] tiny {want}", file=sys.stderr)

    # the YOLOv4 reference with zero head biases: the raw heads, once
    n_cls = y4.CLASSES
    nets = core.weights(config, device)
    nets.det = {f"recipe/{k}": torch.as_tensor(v, device=device)
                for k, v in recipe(np.zeros(3), np.zeros(n_cls)).items()}
    rms = dict.fromkeys(STAGES)
    raws = [[], [], []]
    with torch.no_grad():
        for i in range(0, images.shape[0], y4.BLOCK):
            x = y4.resize(images[i:i + y4.BLOCK], size)
            for h, r in enumerate(y4.heads_raw(nets, x,
                                               probe=None if i else rms)):
                raws[h].append(r)
    raws = [torch.cat(r) for r in raws]
    print(f"[recipe] stage RMS {rms}", file=sys.stderr)

    def dense(obj, d):
        add = torch.zeros(5 + n_cls, device=device)
        add[4] = obj
        for k in DYNAMIC:
            add[5 + k] = d
        out = []
        for raw, (mask, scale) in zip(raws, y4.YOLO):
            b, ch, hh, ww = raw.shape
            r = raw.reshape(b, 3, ch // 3, hh, ww) + add[None, None, :, None,
                                                        None]
            out.append(y4._decode(r.reshape(b, ch, hh, ww),
                                  [y4.ANCHORS[a] for a in mask], scale, size))
        return (torch.cat([o[0] for o in out], 1),
                torch.cat([o[1] for o in out], 1))

    def at(obj, d):
        return figures(torch, *dense(obj, d), c)

    best = None
    for d in np.arange(-4.0, 8.01, 1.0):
        lo, hi = -80.0, 20.0                  # kept count rises with obj
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            if at(mid, d)["kept_per_frame"] < want["kept_per_frame"]:
                lo = mid
            else:
                hi = mid
        got = at(hi, d)
        gap = abs(got["dynamic_share"] - want["dynamic_share"])
        print(f"[recipe] d {d:+.1f} obj {hi:.4f} {got}", file=sys.stderr)
        if got["overflow"] == 0 and (best is None or gap < best[0]):
            best = (gap, hi, float(d), got)
    if best is None:
        print("[recipe] every candidate overflows", file=sys.stderr)
        return 1
    _, obj, d, got = best
    cls = np.zeros(n_cls)
    cls[list(DYNAMIC)] = d
    rec = recipe(np.full(3, obj), cls)
    ok = dict(
        kept=abs(got["kept_per_frame"] / want["kept_per_frame"] - 1) <= 0.25,
        dynamic=abs(got["dynamic_share"] - want["dynamic_share"]) <= 0.10,
        overflow=got["overflow"] == 0)
    out = dict(pool_seed=POOL_SEED, tiny=want, yolov4=got, targets=ok,
               stage_rms=rms,
               recipe={k: np.asarray(v).tolist() for k, v in rec.items()})
    print(json.dumps(out))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    np.savez(args.out, **{f"['params']/['recipe']/['{k}']": v
                          for k, v in rec.items()})
    if not all(ok.values()):
        print(f"[recipe] targets missed: {ok}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
