"""The batched fleet path as a whole: the port's pipeline.fleet_step against
the JAX package's jitted pipeline.fleet_step, in the slice's backends
(detector "pallas2", orientation "pallas", grid and kNN "pallas"; the JAX
kernels run in interpret mode here, the port's wrappers run their plain
twins), 3 rigs of the fleet scene pool, 3 ticks, budgets 2, 2R and R*cap,
the same random weights on both sides, at a reduced size.

Tolerances: box validity, labels, pose validity, dropped counts and every
SaturationStats counter exact; boxes, static depths / points and pose
fields 1e-4; log-odds and the rng keys bit-equal; occupancy_i8 agreement
>= 99.9% per rig per tick. Also the contracts of
tests/test_fleet_compaction.py on the port (a full budget equals per-rig
step, a small budget keeps the top-confidence candidates, the dropped
counts add up), and the port's jax-free pool equals bench.build_obs_pool.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu.types import Obs as JaxObs
from grid_vision_tpu.types import PointCloud as JaxCloud
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights, yolov4_int8
from grid_vision_tpu_torch.runtime.stream import FleetPool

torch.set_num_threads(1)

R, TICKS = 3, 3
# reduced size: 96x128 camera, detector 64, orientation 64 / width 8,
# a 30 m x 10 m grid at 0.25 m, 512 points; the fleet configuration of
# bench.py (static compaction to 16) with the slice's kernel backends
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16,
             detector_stem_backend="pallas2",
             orientation_stem_backend="pallas", grid_backend="pallas",
             knn_backend="pallas")
# random heads give confidences near 0.25; scaled up, enough anchors
# clear the 0.6 threshold to load the orientation budget
HEAD_SCALE = 150.0
TOL = dict(rtol=1e-4, atol=1e-4)
CAP = GridVisionConfig().max_orientation_batch


@pytest.fixture(scope="module")
def fleet():
    jcfg, cfg = JaxConfig(**SMALL), GridVisionConfig(**SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jweights.init_all(jcfg, 1))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(cfg, device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    pool = FleetPool(cfg, R, device="cpu")
    return jcfg, cfg, tree, eng, pool, [pool.obs(i) for i in range(TICKS)]


def _jax_obs(obs):
    j = lambda t: jnp.asarray(t.numpy())                      # noqa: E731
    return JaxObs(image=j(obs.image),
                  cloud=JaxCloud(xyz=j(obs.cloud.xyz),
                                 intensity=j(obs.cloud.intensity),
                                 count=j(obs.cloud.count)),
                  has_image=j(obs.has_image), has_cloud=j(obs.has_cloud))


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("budget", [2, 2 * R, R * CAP])
def test_fleet_step_matches_jax(fleet, budget):
    jcfg, cfg, tree, eng, _, obs_seq = fleet
    jstep = jax.jit(functools.partial(jpipe.fleet_step, cfg=jcfg,
                                      orientation_budget=budget))
    jstates = JaxState.create_batch(jcfg, R)
    states = eng.init_states(R)
    n_poses = 0
    for i, obs in enumerate(obs_seq):
        jstates, jout = jstep(tree, jstates, _jax_obs(obs),
                              jdemo.default_extrinsics())
        states, out = eng.fleet(states, obs, budget)
        valid = np.array(jout.boxes.valid)
        np.testing.assert_array_equal(out.boxes.valid.numpy(), valid)
        np.testing.assert_array_equal(out.boxes.label.numpy(),
                                      np.asarray(jout.boxes.label))
        _close(out.boxes.xyxy, jout.boxes.xyxy, "boxes")
        _close(out.boxes.confidence, jout.boxes.confidence, "confidence")
        static = np.array(jout.static_boxes.valid)
        np.testing.assert_array_equal(out.static_boxes.valid.numpy(), static)
        _close(out.static_depths, jout.static_depths, "static_depths")
        _close(out.static_points, jout.static_points, "static_points")
        pv = np.array(jout.poses.valid)
        np.testing.assert_array_equal(out.poses.valid.numpy(), pv)
        for f in ("position", "quat", "length", "width", "height"):
            _close(getattr(out.poses, f)[pv],
                   np.asarray(getattr(jout.poses, f))[pv], f)
        for f in dataclasses.fields(out.saturation):
            np.testing.assert_array_equal(
                getattr(out.saturation, f.name).numpy(),
                np.asarray(getattr(jout.saturation, f.name)), f.name)
        np.testing.assert_array_equal(states.log_odds.numpy(),
                                      np.asarray(jstates.log_odds))
        np.testing.assert_array_equal(states.rng.numpy(),
                                      np.asarray(jstates.rng))
        np.testing.assert_array_equal(states.step.numpy(),
                                      np.asarray(jstates.step))
        agree = (out.occupancy_i8.numpy()
                 == np.asarray(jout.occupancy_i8)).mean(axis=(1, 2))
        assert agree.min() >= 0.999, f"tick {i}: agreement {agree}"
        n_poses += int(pv.sum())
    assert n_poses >= min(budget, 3) * TICKS, n_poses


def test_full_budget_equals_per_rig_step(fleet):
    _, cfg, _, eng, _, obs_seq = fleet
    states, out = eng.fleet(eng.init_states(R), obs_seq[0], R * CAP)
    for r in range(R):
        state, ref = eng(eng.init_state(r), obs_seq[0].select(r))
        np.testing.assert_array_equal(out.poses.valid[r].numpy(),
                                      ref.poses.valid.numpy())
        pv = ref.poses.valid.numpy()
        for f in ("position", "quat", "length", "width", "height"):
            _close(getattr(out.poses, f)[r][pv],
                   getattr(ref.poses, f)[pv].numpy(), f)
        np.testing.assert_array_equal(states.log_odds[r].numpy(),
                                      state.log_odds.numpy())
        np.testing.assert_array_equal(states.rng[r].numpy(),
                                      state.rng.numpy())
        np.testing.assert_array_equal(out.boxes.valid[r].numpy(),
                                      ref.boxes.valid.numpy())
    assert int(out.saturation.orientation_dropped.sum()) == 0
    # orientation_budget=None is the full budget
    _, out_none = eng.fleet(eng.init_states(R), obs_seq[0])
    assert torch.equal(out_none.poses.valid, out.poses.valid)


def test_small_budget_keeps_top_confidence_and_counts_drops(fleet):
    _, cfg, _, eng, _, obs_seq = fleet
    _, full = eng.fleet(eng.init_states(R), obs_seq[0], R * CAP)
    _, out = eng.fleet(eng.init_states(R), obs_seq[0], 2)
    assert int(out.poses.valid.sum()) == 2
    # the pose slots are each rig's compacted dynamic boxes; recover their
    # confidences by the same compaction
    dyn, _ = pipeline._compact_dynamic(full.boxes, cfg.max_orientation_batch)
    conf = dyn.confidence.numpy()
    kept = conf[out.poses.valid.numpy()]
    dropped = conf[full.poses.valid.numpy() & ~out.poses.valid.numpy()]
    assert dropped.size > 0
    assert kept.min() >= dropped.max()
    total = int(full.poses.valid.sum())
    assert int(out.saturation.orientation_dropped.sum()) == total - 2


def test_pool_matches_bench_pool(fleet):
    jcfg, cfg, _, _, pool, obs_seq = fleet
    ref = bench.build_obs_pool(jcfg, R)
    np.testing.assert_array_equal(obs_seq[0].image.numpy(),
                                  np.asarray(ref.image))
    np.testing.assert_array_equal(obs_seq[0].cloud.xyz.numpy(),
                                  np.asarray(ref.cloud.xyz))
    np.testing.assert_array_equal(obs_seq[0].cloud.count.numpy(),
                                  np.asarray(ref.cloud.count))
    assert not np.array_equal(obs_seq[1].image.numpy(),
                              obs_seq[0].image.numpy())


def test_fleet_rejects_unported_modes(fleet):
    """The PCA branch runs on the fleet path (tests/test_torch_pca_fleet.py
    holds it to the JAX package); so does the int8 detector (extension
    mode, the plain resize path; tests/test_torch_int8_detector.py holds it
    to the JAX package): its fleet tick equals its single-rig ticks. Params
    without the quantized detector (a float config's) are refused, never
    quantized again on each tick. The test keeps the name it had when the
    port refused these modes on the fleet path."""
    _, cfg, _, eng, _, obs_seq = fleet
    pca = dataclasses.replace(cfg, use_vision_orientation=False)
    _, out = pipeline.fleet_step(eng.params, eng.init_states(R), obs_seq[0],
                                 eng.extrinsics, pca)
    assert out.poses.capacity == out.boxes.capacity    # every box
    assert not out.saturation.orientation_dropped.any()
    int8 = dataclasses.replace(cfg, detector_precision="int8", compat=False,
                               detector_stem_backend="xla")
    int8.validate()
    states = eng.init_states(R)
    assert "detector_q" not in eng.params
    with pytest.raises(KeyError, match="load_all"):
        pipeline.fleet_step(eng.params, states, obs_seq[0], eng.extrinsics,
                            int8)
    q = dict(eng.params, detector_q=yolov4_int8.quantize_detector(
        eng.params["detector"]))
    _, fout = pipeline.fleet_step(q, states, obs_seq[0], eng.extrinsics,
                                  int8)
    for r in range(R):
        _, out = pipeline.step(q, states.select(r), obs_seq[0].select(r),
                               eng.extrinsics, int8)
        assert torch.equal(out.boxes.xyxy, fout.boxes.xyxy[r])
        assert torch.equal(out.occupancy_i8, fout.occupancy_i8[r])
