"""3D pose-quality evaluation: localization error of dynamic objects
against scene ground truth, end to end through the production fuse path
(counterpart of grid_vision_tpu/train/eval_pose.py).

``pipeline.fuse`` runs with ground-truth 2D boxes injected
(demo.oracle_boxes, so the metric isolates the 3D stack from detector
quality); each emitted pose is matched to the nearest ground-truth dynamic
object in the base-frame ground plane, and the position errors are
summarized. With --det net the 2D boxes come from the trained detector
(Engine's step), and the number becomes the full-system localization
error. The Engine runs the configuration's kernels: the grid kernel and
the static boxes' kNN on grid_backend / knn_backend "pallas".

CLI: python -m grid_vision_tpu_torch eval-pose [--mode pca|vision|both]
     [--frames N] [--det oracle|net] [--refine] [--cpu] -- prints one JSON
     list.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import numpy as np

from ..config import GridVisionConfig
from ..taxonomy import DYNAMIC_LUT


def _gt_base_centers(scene, t: float, extr) -> np.ndarray:
    """(G, 2) base-frame xy of the dynamic GT objects visible at t."""
    cam_to_base = extr.camera_to_base.cpu().numpy()
    out = []
    for i, obj in enumerate(scene.objects):
        if not DYNAMIC_LUT[min(obj.label, 10)]:
            continue
        if scene.bbox_at(i, t) is None:
            continue
        c = obj.center + obj.velocity * t
        p = cam_to_base @ np.array([c[0], c[1], c[2], 1.0])
        out.append(p[:2])
    return np.asarray(out, np.float64).reshape(-1, 2)


def evaluate_poses(mode: str = "vision", n_frames: int = 32,
                   det: str = "oracle", seed: int = 3000,
                   cfg: GridVisionConfig | None = None,
                   refine: bool = False, device="cuda") -> Dict:
    """Position errors of the dynamic poses over n_frames scenes (seed +
    f) on `device` (the card unless the CPU is asked for)."""
    from .. import pipeline
    from ..demo import default_extrinsics, oracle_boxes
    from ..io.scene import SyntheticScene
    from ..runtime.stream import obs_from_scene

    base = cfg or GridVisionConfig()
    overrides = {"use_vision_orientation": mode == "vision"}
    if refine:
        overrides.update(compat=False, vision_depth_refine=True)
    if det == "net" and not base.detection_weights_file:
        # --det net without weights would score a random detector
        overrides.update(detection_weights_file="weights/detector.npz")
    if mode == "vision" and not base.vision_weights_file:
        # the vision branch always runs the orientation net
        overrides.update(vision_weights_file="weights/orientation.npz")
    cfg = dataclasses.replace(base, **overrides)
    eng = pipeline.Engine(cfg, extrinsics=default_extrinsics(device),
                          seed=0, device=device)

    rng = np.random.default_rng(seed)
    errors: List[float] = []
    n_gt = n_matched = n_pred = 0
    state = eng.init_state()
    for f in range(n_frames):
        scene = SyntheticScene(cfg, seed=seed + f)
        scene.add_default_traffic()
        for _ in range(int(rng.integers(0, 3))):
            scene.add_object(
                center=[rng.uniform(-5, 5), 1.2, rng.uniform(6, 35)],
                velocity=[rng.uniform(-1, 1), 0.0, rng.uniform(-2, 1)],
                size=(1.8, 1.4, 4.2), label=9)
        t = float(rng.uniform(0.0, 2.0))
        obs = obs_from_scene(scene, t, cfg, eng.device)
        if det == "oracle":
            boxes = oracle_boxes(scene, t, cfg, eng.device)
            state, out = pipeline.fuse(eng.params, state, obs, boxes,
                                       eng.extrinsics, cfg)
        else:
            state, out = eng(state, obs)
        valid = out.poses.valid.cpu().numpy()
        pxy = out.poses.position.cpu().numpy()[:, :2][valid]
        gts = _gt_base_centers(scene, t, eng.extrinsics)
        n_gt += len(gts)
        n_pred += int(valid.sum())
        if len(gts) == 0 or len(pxy) == 0:
            continue
        d = np.linalg.norm(pxy[:, None, :] - gts[None, :, :], axis=-1)
        # greedy one-to-one nearest matching
        while np.isfinite(d).any() and d.size:
            i, j = np.unravel_index(np.argmin(d), d.shape)
            if not np.isfinite(d[i, j]):
                break
            errors.append(float(d[i, j]))
            n_matched += 1
            d[i, :] = np.inf
            d[:, j] = np.inf
    errs = np.asarray(errors)

    def stat(fn):
        return round(float(fn(errs)), 3) if errs.size else None

    return {
        "mode": mode, "det": det, "refine": refine, "frames": n_frames,
        "n_gt": n_gt, "n_pred": n_pred, "n_matched": n_matched,
        "pos_err_median_m": stat(np.median),
        "pos_err_mean_m": stat(np.mean),
        "pos_err_p90_m": stat(lambda e: np.percentile(e, 90)),
        "within_1m_frac": stat(lambda e: (e < 1.0).mean()),
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="grid_vision_tpu_torch eval-pose",
                                 description=__doc__)
    ap.add_argument("--mode", choices=("pca", "vision", "both"),
                    default="both")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--det", choices=("oracle", "net"), default="oracle")
    ap.add_argument("--refine", action="store_true",
                    help="vision_depth_refine extension (compat=False)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    modes = ["pca", "vision"] if args.mode == "both" else [args.mode]
    out = [evaluate_poses(m, args.frames, args.det, refine=args.refine,
                          device="cpu" if args.cpu else "cuda")
           for m in modes]
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
