#!/usr/bin/env python3
"""Write the JAX package's full-width outputs on its packed wire, which
the PyTorch / CUDA port's streaming path is held to (chip_smoke.py's phase
`stream` on the card):

    python3 tools/jax_stream_fixture.py      # from the repo's root, ~30 s

Runs the JAX package's jitted Engine.call_packed on the CPU, on the "xla"
backends its own tests use, at full width: 480x640 frames, detector 416,
orientation 224 / width 32, 16384 points, the 500x200 grid, the shipped
weights, the `io/scene.py` scene of seed 0 with the default traffic (the
`run` command's scene; frames at t = i / 10), TICKS ticks on each of two
wires: the lossless one (rgb8 image, f32 cloud) and the lossy one
(yuv420 image, f16 cloud). Writes boxes, pose validity and occupancy_i8
of every tick, and each tick's share of cells within one int8 step
between the two wires, to tests/fixtures/stream_wire_jax.npz.
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from grid_vision_tpu import demo  # noqa: E402
from grid_vision_tpu.config import GridVisionConfig  # noqa: E402
from grid_vision_tpu.io.scene import SyntheticScene  # noqa: E402
from grid_vision_tpu.models import weights  # noqa: E402
from grid_vision_tpu.pipeline import Engine  # noqa: E402
from grid_vision_tpu.runtime.stream import packed_from_scene  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "stream_wire_jax.npz")
TICKS = 8
SCENE = dict(seed=0)
WIRES = {"rgb8_f32": dict(wire_image_codec="rgb8",
                          wire_cloud_dtype="float32"),
         "yuv420_f16": dict(wire_image_codec="yuv420",
                            wire_cloud_dtype="float16")}
WEIGHTS = dict(detection_weights_file="weights/detector.npz",
               vision_weights_file="weights/orientation.npz")


def main() -> None:
    arrays, grids = {}, {}
    for wire, flags in WIRES.items():
        cfg = GridVisionConfig(**WEIGHTS, **flags)
        eng = Engine(cfg, extrinsics=demo.default_extrinsics(),
                     params=weights.load_all(cfg, base_dir=ROOT))
        scene = SyntheticScene(cfg, **SCENE)
        scene.add_default_traffic()
        state = eng.init_state()
        grids[wire] = []
        for i in range(TICKS):
            buf, _ = packed_from_scene(scene, i / 10.0, cfg)
            state, out = eng.call_packed(state, jnp.asarray(buf))
            key = f"{wire}/{i}/"
            arrays[key + "boxes_valid"] = np.asarray(out.boxes.valid)
            arrays[key + "poses_valid"] = np.asarray(out.poses.valid)
            arrays[key + "occupancy_i8"] = np.asarray(out.occupancy_i8)
            grids[wire].append(np.asarray(out.occupancy_i8, np.int32))
            print(wire, i, "boxes", int(out.boxes.valid.sum()), "poses",
                  int(out.poses.valid.sum()), flush=True)
    within = [float((np.abs(a - b) <= 1).mean())
              for a, b in zip(grids["rgb8_f32"], grids["yuv420_f16"])]
    print("yuv420_f16 within one step of rgb8_f32:", within)
    arrays["within_one_step"] = np.asarray(within)
    arrays["meta"] = np.asarray(json.dumps(dict(
        ticks=TICKS, scene=SCENE, wires=WIRES, weights=WEIGHTS,
        jax=jax.__version__)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
