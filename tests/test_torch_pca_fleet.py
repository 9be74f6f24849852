"""The PCA pose branch (use_vision_orientation=False) through the port's
pipeline.fleet_step and Engine.fleet at R = 3, against the JAX package's
jitted fleet_step (in PCA mode the vmap of step: every rig's own RANSAC key,
no orientation budget) on the "xla" backends, and against the port's own
per-rig step; the reduced size, weights and bars of
tests/test_torch_pca_step.py, in f32, bf16 and extension mode with raycast
free-space carving. In bf16 the boxes of the JAX package's tick are
injected into the port's (its bf16 detector, vmapped inside one jitted
program, rounds where XLA fuses it; the boxes' confidences nearly all tie
in bf16 with these heads), so the PCA branch downstream of them, f32 in
both packages, is compared exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.types import Boxes

from .test_torch_fleet import _jax_obs
from .test_torch_pca_step import (KERNELS, MODES, SMALL, compare,
                                  params)

torch.set_num_threads(1)

R, TICKS = 3, 3
# the fleet configuration of bench.py: static compaction to 16, the CSP
# kernel in the detector
FLEET = dict(KERNELS, detector_stem_backend="pallas2")


@pytest.mark.parametrize("mode", list(MODES))
def test_pca_fleet_step_matches_jax(mode, monkeypatch):
    kw = dict(SMALL, **MODES[mode], max_static_depth=16)
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw, **FLEET)
    tree, nets = params(kw)
    jax_boxes = {}
    if mode == "bf16":
        monkeypatch.setattr(pipeline, "detect_batch",
                            lambda params, images, cfg: jax_boxes["fleet"])
        monkeypatch.setattr(pipeline, "detect_with_stats",
                            lambda params, image, cfg: jax_boxes["rig"])
    jstep = jax.jit(functools.partial(jpipe.fleet_step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    pool = FleetPool(cfg, R, device="cpu")
    jstates, states = JaxState.create_batch(jcfg, R), eng.init_states(R)
    singles = [eng.init_state(seed=r) for r in range(R)]
    n_poses = n_trunc = 0
    for i in range(TICKS):
        obs = pool.obs(i)
        jstates, jout = jstep(tree, jstates, _jax_obs(obs),
                              jdemo.default_extrinsics())
        jax_boxes["fleet"] = (
            Boxes(*(torch.tensor(np.asarray(a)) for a in (
                jout.boxes.xyxy, jout.boxes.confidence, jout.boxes.label,
                jout.boxes.valid))),
            torch.tensor(np.asarray(jout.saturation.prenms_overflow)))
        # a budget has no say in PCA mode
        states, out = eng.fleet(states, obs, 1)
        poses, agree = compare(out, jout)
        assert agree >= 0.999, f"tick {i}: occupancy_i8 agreement {agree}"
        np.testing.assert_array_equal(states.rng.numpy(),
                                      np.asarray(jstates.rng))
        if mode != "carve":
            np.testing.assert_array_equal(states.log_odds.numpy(),
                                          np.asarray(jstates.log_odds))
        # the batched tick is each rig's own step
        for r in range(R):
            jax_boxes["rig"] = (jax_boxes["fleet"][0].select(r),
                                jax_boxes["fleet"][1][r])
            singles[r], o = eng(singles[r], obs.select(r))
            assert torch.equal(o.poses.valid, out.poses.valid[r])
            assert torch.equal(o.occupancy_i8, out.occupancy_i8[r])
            assert torch.equal(singles[r].log_odds, states.log_odds[r])
            torch.testing.assert_close(o.poses.position,
                                       out.poses.position[r])
        n_poses += poses
        n_trunc += int(out.saturation.box_cloud_truncated.sum())
    assert n_poses > 0 and n_trunc > 0, (n_poses, n_trunc)
