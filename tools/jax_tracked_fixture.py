#!/usr/bin/env python3
"""Write the tracked-tick reference outputs of the JAX package, which the
PyTorch / CUDA port's tracker is held to (tests/test_torch_tracked_step.py
on the CPU, chip_smoke.py's phase `tracked` on the card):

    python3 tools/jax_tracked_fixture.py      # from the repo's root, ~1 min

Runs the JAX package's jitted Engine.call_tracked on the CPU, on the "xla"
backends its own tests use, at full width: 480x640 frames, detector 416,
orientation 224 / width 32, 16384 points, the 500x200 grid, the shipped
weights, f32 compat mode, the `io/scene.py` scene of seed 0 with the default
traffic (as `run --track` drives it), frames at t = i * DT, DT = 0.1 s,
TICKS ticks, the default TrackConfig. Writes to
tests/fixtures/tracked_jax.npz: every tick's track table (every TrackState
field), its TrackStats and box count; the final TrackState; and
forecast_occupancy of the final state at HORIZONS.
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
from grid_vision_tpu.ops import tracking  # noqa: E402
from grid_vision_tpu.pipeline import Engine  # noqa: E402
from grid_vision_tpu.runtime.stream import obs_from_scene  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "tracked_jax.npz")
TICKS = 12
DT = 0.1
HORIZONS = (0.5, 1.0, 2.0)
SCENE = dict(seed=0)
WEIGHTS = dict(detection_weights_file="weights/detector.npz",
               vision_weights_file="weights/orientation.npz")
STATS = ("matched", "spawned", "killed", "spawn_dropped", "reacquired")


def main() -> None:
    cfg = GridVisionConfig(**WEIGHTS)
    tcfg = tracking.TrackConfig()
    eng = Engine(cfg, extrinsics=demo.default_extrinsics(),
                 params=weights.load_all(cfg, base_dir=ROOT))
    scene = SyntheticScene(cfg, **SCENE)
    scene.add_default_traffic()
    state, tracks = eng.init_state(), eng.init_tracks(tcfg)
    arrays = {}
    for i in range(TICKS):
        obs = obs_from_scene(scene, i * DT, cfg)
        state, tracks, out, tstats = eng.call_tracked(state, tracks, obs,
                                                      dt=DT, tcfg=tcfg)
        for f in dataclasses.fields(tracks):
            arrays[f"{i}/tracks/{f.name}"] = np.asarray(
                getattr(tracks, f.name))
        arrays[f"{i}/confirmed"] = np.asarray(tracks.confirmed(tcfg))
        for name in STATS:
            arrays[f"{i}/stats/{name}"] = np.asarray(getattr(tstats, name))
        arrays[f"{i}/n_boxes"] = np.asarray(out.boxes.valid.sum())
        print(i, "boxes", int(out.boxes.valid.sum()), "tracks",
              int(tracks.valid.sum()), "confirmed",
              int(tracks.confirmed(tcfg).sum()),
              {n: int(getattr(tstats, n)) for n in STATS}, flush=True)
    fc = jax.jit(lambda tr: tracking.forecast_occupancy(tr, HORIZONS, cfg,
                                                        tcfg))(tracks)
    arrays["forecast"] = np.asarray(fc)
    arrays["meta"] = np.asarray(json.dumps(dict(
        ticks=TICKS, dt=DT, horizons=HORIZONS, scene=SCENE, weights=WEIGHTS,
        track_config=dataclasses.asdict(tcfg), stats=STATS,
        fields=[f.name for f in dataclasses.fields(tracks)],
        jax=jax.__version__)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
