"""The port at full width against the JAX package's own outputs.

tests/fixtures/full_width_jax.npz holds what the JAX package's jitted Engine
computes on the CPU ("xla" backends) at full width: 480x640 frames, detector
416, orientation 224, 16384 points, the 500x200 grid, the shipped weights,
the io/scene.py scene of seed 0, compat and extension mode, the last tick
with neither image nor cloud (written by tools/jax_full_width_fixture.py).
Here the port's Engine runs the same ticks on the CPU, on the plain
("xla") backends and on the kernel backends (whose wrappers run their
plain twins on a CPU tensor, the run gate and the export after them), and
must reach BASELINE.md's bar: occupancy_i8 agreement >= 99 % every tick,
and equal box and pose counts. chip_smoke.py's phase `jax_fixture` holds the
kernels on the card to the same file.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.runtime.stream import obs_from_scene

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "full_width_jax.npz")
KERNELS = dict(detector_stem_backend="pallas", grid_backend="pallas",
               knn_backend="pallas")


@pytest.fixture(scope="module")
def reference():
    ref = np.load(FIXTURE)
    return ref, json.loads(str(ref["meta"]))


@pytest.fixture(scope="module")
def nets(reference):
    cfg = GridVisionConfig(**reference[1]["weights"])
    return weights.load_all(cfg, base_dir=ROOT, device="cpu")


@pytest.mark.parametrize("backends", ["plain", "kernels"])
@pytest.mark.parametrize("mode", ["compat", "extension"])
def test_port_matches_the_jax_package_at_full_width(reference, nets, mode,
                                                    backends):
    ref, meta = reference
    cfg = GridVisionConfig(**meta["weights"], **meta["modes"][mode],
                           **(KERNELS if backends == "kernels" else {}))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    scene = SyntheticScene(cfg, **meta["scene"])
    scene.add_default_traffic()
    scene.add_default_statics()
    state = eng.init_state()
    off = torch.zeros((), dtype=torch.bool)
    n_poses = 0
    for i in range(meta["ticks"]):
        obs = obs_from_scene(scene, i / 10.0, cfg, "cpu")
        if i == meta["gated_off_tick"]:
            obs = dataclasses.replace(obs, has_image=off, has_cloud=off)
        before = state.log_odds
        state, out = eng(state, obs)
        key = f"{mode}/{i}/"
        assert int(out.boxes.valid.sum()) == int(
            ref[key + "boxes_valid"].sum()), f"tick {i}: box count"
        assert int(out.poses.valid.sum()) == int(
            ref[key + "poses_valid"].sum()), f"tick {i}: pose count"
        agree = (out.occupancy_i8.numpy() == ref[key + "occupancy_i8"]).mean()
        assert agree >= 0.99, f"tick {i}: occupancy_i8 agreement {agree}"
        n_poses += int(out.poses.valid.sum())
    # the gated-off tick left the grid as it was
    assert torch.equal(state.log_odds, before)
    assert n_poses > 0
