#!/usr/bin/env python3
"""Write the full-width reference outputs of the JAX package, which the
PyTorch / CUDA port is held to (tests/test_torch_full_width.py on the CPU,
chip_smoke.py's phase `jax_fixture` on the card):

    python3 tools/jax_full_width_fixture.py      # from the repo's root, ~6 min

Runs the JAX package's jitted Engine on the CPU, on the "xla" backends its
own tests use, at full width: 480x640 frames, detector 416, orientation 224 /
width 32, 16384 points, the 500x200 grid, the shipped weights, the
`io/scene.py` scene of seed 0 (15000 ground points, the default traffic and
statics; frames at t = i / 10). Six modes: compat (the shipped defaults),
extension (compat=False, raycast free-space carving, depth refine,
class-aware NMS), each of the two in the production bf16 configuration
(compute_dtype="bfloat16"), and the PCA pose branch
(use_vision_orientation=False: RANSAC ground plane, frustum association,
PCA L-shape) in compat mode, f32 and bf16. TICKS ticks each, the last with neither image
nor cloud (the run gate: the grid must stay as it was). Writes boxes, poses and
occupancy_i8 of every tick to tests/fixtures/full_width_jax.npz.
"""

import dataclasses
import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from grid_vision_tpu import demo  # noqa: E402
from grid_vision_tpu.config import GridVisionConfig  # noqa: E402
from grid_vision_tpu.io.scene import SyntheticScene  # noqa: E402
from grid_vision_tpu.models import weights  # noqa: E402
from grid_vision_tpu.pipeline import Engine  # noqa: E402
from grid_vision_tpu.runtime.stream import obs_from_scene  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "full_width_jax.npz")
TICKS = 4            # the last one gated off
SCENE = dict(seed=0, n_ground=15000)
EXTENSION = dict(compat=False, raycast_free_space=True,
                 vision_depth_refine=True, class_aware_nms=True)
MODES = {
    "compat": {},
    "extension": EXTENSION,
    "compat_bf16": dict(compute_dtype="bfloat16"),
    "extension_bf16": dict(EXTENSION, compute_dtype="bfloat16"),
    "pca": dict(use_vision_orientation=False),
    "pca_bf16": dict(use_vision_orientation=False, compute_dtype="bfloat16"),
}
WEIGHTS = dict(detection_weights_file="weights/detector.npz",
               vision_weights_file="weights/orientation.npz")


def main() -> None:
    arrays = {}
    for mode, flags in MODES.items():
        cfg = GridVisionConfig(**WEIGHTS, **flags)
        eng = Engine(cfg, extrinsics=demo.default_extrinsics(),
                     params=weights.load_all(cfg, base_dir=ROOT))
        scene = SyntheticScene(cfg, **SCENE)
        scene.add_default_traffic()
        scene.add_default_statics()
        state = eng.init_state()
        for i in range(TICKS):
            obs = obs_from_scene(scene, i / 10.0, cfg)
            if i == TICKS - 1:
                obs = dataclasses.replace(
                    obs, has_image=jax.numpy.asarray(False),
                    has_cloud=jax.numpy.asarray(False))
            state, out = eng(state, obs)
            key = f"{mode}/{i}/"
            arrays[key + "boxes_xyxy"] = np.asarray(out.boxes.xyxy)
            arrays[key + "boxes_label"] = np.asarray(out.boxes.label)
            arrays[key + "boxes_valid"] = np.asarray(out.boxes.valid)
            arrays[key + "poses_position"] = np.asarray(out.poses.position)
            arrays[key + "poses_valid"] = np.asarray(out.poses.valid)
            arrays[key + "occupancy_i8"] = np.asarray(out.occupancy_i8)
            print(mode, i, "boxes", int(out.boxes.valid.sum()), "poses",
                  int(out.poses.valid.sum()), "occupied",
                  int((np.asarray(out.occupancy_i8) > 50).sum()), flush=True)
    arrays["meta"] = np.asarray(json.dumps(dict(
        ticks=TICKS, gated_off_tick=TICKS - 1, scene=SCENE, modes=MODES,
        weights=WEIGHTS, jax=jax.__version__)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
