"""The port at full width against the JAX package's own outputs.

tests/fixtures/full_width_jax.npz holds what the JAX package's jitted Engine
computes on the CPU ("xla" backends) at full width: 480x640 frames, detector
416, orientation 224, 16384 points, the 500x200 grid, the shipped weights,
the io/scene.py scene of seed 0, compat and extension mode, each in f32
and in the production bf16 configuration, and the PCA pose branch
(use_vision_orientation=False) in compat mode, f32 and bf16, the last tick
with neither image nor cloud (written by tools/jax_full_width_fixture.py). Here the
port's Engine runs the same ticks on the CPU, on the plain ("xla")
backends and on the kernel backends (whose wrappers run their plain twins
on a CPU tensor, the run gate and the export after them). f32 must reach
BASELINE.md's bar: occupancy_i8 agreement >= 99 % every tick, and equal
box and pose counts. bf16 (the JAX package's XLA chain rounds where the
port's plain backend does, the kernels' twins where the Pallas kernels
do, and the f32 sums of the two frameworks' convs run in other orders, so
a rounding can flip) the bars of the JAX package's own bf16 against its
f32 (PARITY.json production_vs_compat_vision: per-step min 0.97527, mean
0.98586): equal box counts on >= 99 % of the ticks, occupancy_i8
agreement >= 97.5 % every tick and >= 98.5 % on the mean. The PCA
branch's bf16 mode (its poses come from the f32 cloud; only the boxes
come from the bf16 detector) is held to >= 99 % every tick and equal box
counts on >= 99 % of the ticks. tests/test_torch_cuda_tick.py's
test_kernel_path_against_the_jax_fixture holds the kernels on the card
to the same file.
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
@pytest.mark.parametrize("mode", ["compat", "extension", "compat_bf16",
                                  "extension_bf16", "pca", "pca_bf16"])
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
    bf16 = cfg.compute_dtype == "bfloat16"
    n_poses, agree, same = 0, [], []
    for i in range(meta["ticks"]):
        obs = obs_from_scene(scene, i / 10.0, cfg, "cpu")
        if i == meta["gated_off_tick"]:
            obs = dataclasses.replace(obs, has_image=off, has_cloud=off)
        before = state.log_odds
        state, out = eng(state, obs)
        key = f"{mode}/{i}/"
        same.append(int(out.boxes.valid.sum())
                    == int(ref[key + "boxes_valid"].sum()))
        agree.append((out.occupancy_i8.numpy()
                      == ref[key + "occupancy_i8"]).mean())
        if not bf16:
            assert same[-1], f"tick {i}: box count"
            assert int(out.poses.valid.sum()) == int(
                ref[key + "poses_valid"].sum()), f"tick {i}: pose count"
            assert agree[-1] >= 0.99, \
                f"tick {i}: occupancy_i8 agreement {agree[-1]}"
        n_poses += int(out.poses.valid.sum())
    if bf16:
        assert np.mean(same) >= 0.99, same
        assert np.mean(agree) >= 0.985 and min(agree) >= 0.975, agree
        if not cfg.use_vision_orientation:
            assert min(agree) >= 0.99, agree
    # the gated-off tick left the grid as it was
    assert torch.equal(state.log_odds, before)
    assert n_poses > 0
