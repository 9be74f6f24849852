"""The extension-mode tick as a whole (compat=False): the port's
pipeline.step and pipeline.fleet_step against the JAX package's jitted
step and fleet_step, with raycast free-space carving, the depth refine and
class-aware NMS on (and, as a second case, yaw-aware rasterization in the
carve's place), at a reduced size, the same random weights on both sides.
The kernel backends are "pallas": the JAX kernels run in interpret mode
here, the port's wrappers run their plain twins. In the fleet case the JAX
side runs grid_backend="xla": its own tests prove its fused carve kernel
bit-equal to that chain, and a vmapped interpret-mode pallas_call is slow.

Tolerances: box validity, labels, pose validity and every SaturationStats
counter exact; boxes, static depths / points and pose fields 1e-4, but the
pose position 1e-3: the depth refine rescales the solver's location along
its ray by (depth + half extent) / z, a factor of up to several here, and
the 1e-4 of the location and of its z grow with it. The rng key bit-equal.
The grid is NOT bit-equal here: each package computes its own polar maps
(atan2 and sqrt an ulp apart), so a cell on the carve's boundary may flip
by the free constant, and a cell centre on a rotated footprint's edge by a
hit. occupancy_i8 agreement must be >= 99 % per tick
(per rig), BASELINE.md's bar; these runs reach >= 99.9 %, asserted too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io.scene import SyntheticScene as JaxScene
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.runtime.stream import obs_from_scene as jobs_from_scene
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu.types import Obs as JaxObs
from grid_vision_tpu.types import PointCloud as JaxCloud
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.ops import cuda_grid, cuda_raycast, raycast
from grid_vision_tpu_torch.runtime.stream import FleetPool, obs_from_scene

torch.set_num_threads(1)

TICKS, R = 3, 3
# reduced size: 96x128 camera, detector 64, orientation 64 / width 8,
# a 30 m x 10 m grid at 0.25 m, 512 points
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, detector_stem_backend="pallas",
             grid_backend="pallas", knn_backend="pallas", compat=False)
CARVE = dict(raycast_free_space=True, vision_depth_refine=True,
             class_aware_nms=True)
YAW = dict(yaw_aware_rasterization=True, vision_depth_refine=True)
# the fleet configuration of bench.py (static compaction to 16, which the
# depth refine overrides) with the fleet path's kernel backends
FLEET = dict(SMALL, **CARVE, max_static_depth=16,
             detector_stem_backend="pallas2",
             orientation_stem_backend="pallas")
HEAD_SCALE = 150.0      # enough anchors of a random head clear 0.6
TOL = dict(rtol=1e-4, atol=1e-4)
REFINED_TOL = dict(rtol=1e-3, atol=1e-3)


def _params(cfg_kw, seed):
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**cfg_kw), seed=seed))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(GridVisionConfig(**cfg_kw), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    return tree, nets


def _close(got, ref, what):
    tol = REFINED_TOL if what == "position" else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol,
                               err_msg=what)


def _compare(out, jout):
    """Everything but the grid; returns (pose count, static count)."""
    valid = np.array(jout.boxes.valid)
    np.testing.assert_array_equal(out.boxes.valid.numpy(), valid)
    np.testing.assert_array_equal(out.boxes.label.numpy(),
                                  np.asarray(jout.boxes.label))
    _close(out.boxes.xyxy, jout.boxes.xyxy, "boxes")
    _close(out.boxes.confidence, jout.boxes.confidence, "confidence")
    static = np.array(jout.static_boxes.valid)
    np.testing.assert_array_equal(out.static_boxes.valid.numpy(), static)
    _close(out.static_depths[valid], np.asarray(jout.static_depths)[valid],
           "static_depths")
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
    return int(pv.sum()), int(static.sum())


@pytest.mark.parametrize("flags", [CARVE, YAW], ids=["carve", "yaw"])
def test_extension_step_matches_jax_step(flags):
    kw = dict(SMALL, **flags)
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw)
    tree, nets = _params(kw, 1)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    assert ("carve_maps" in eng.params) == cfg.raycast_free_space
    jscene = JaxScene(jcfg, seed=1, n_ground=600)
    scene = SyntheticScene(cfg, seed=1, n_ground=600)
    for s in (jscene, scene):
        s.add_default_traffic()
        s.add_default_statics()
    jstate, state = JaxState.create(jcfg), eng.init_state()
    n_dyn = n_static = 0
    n_carve, n_grid = cuda_raycast.launches, cuda_grid.launches
    worst = 1.0
    for i in range(TICKS):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(jscene, t, jcfg),
                             jdemo.default_extrinsics())
        state, out = eng(state, obs_from_scene(scene, t, cfg, "cpu"))
        d, s = _compare(out, jout)
        n_dyn, n_static = n_dyn + d, n_static + s
        np.testing.assert_array_equal(state.rng.numpy(),
                                      np.asarray(jstate.rng))
        agree = (out.occupancy_i8.numpy()
                 == np.asarray(jout.occupancy_i8)).mean()
        assert agree >= 0.99, f"tick {i}: occupancy_i8 agreement {agree}"
        worst = min(worst, agree)
        lo, jlo = state.log_odds.numpy(), np.asarray(jstate.log_odds)
        flip = max(0.4, cfg.log_odds_hit) * (i + 1) + 1e-4
        assert np.abs(lo - jlo).max() <= flip
    assert worst >= 0.999, worst                   # the figure reached
    assert int(state.step) == TICKS
    assert n_dyn > 0 and n_static > 0, (n_dyn, n_static)
    # the plain twins count no launches
    assert (cuda_raycast.launches, cuda_grid.launches) == (n_carve, n_grid)
    if cfg.raycast_free_space:
        # carved cells lie below what decay alone reaches
        carved = (state.log_odds < TICKS * cfg.log_odds_decay - 0.3).float()
        assert carved.mean() > 0.05, carved.mean()


def _jax_obs(obs):
    j = lambda t: jnp.asarray(t.numpy())                      # noqa: E731
    return JaxObs(image=j(obs.image),
                  cloud=JaxCloud(xyz=j(obs.cloud.xyz),
                                 intensity=j(obs.cloud.intensity),
                                 count=j(obs.cloud.count)),
                  has_image=j(obs.has_image), has_cloud=j(obs.has_cloud))


@pytest.fixture(scope="module")
def fleet():
    cfg = GridVisionConfig(**FLEET)
    tree, nets = _params(FLEET, 1)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    pool = FleetPool(cfg, R, device="cpu")
    return cfg, tree, eng, [pool.obs(i) for i in range(TICKS)]


def test_extension_fleet_step_matches_jax_fleet_step(fleet):
    cfg, tree, eng, obs_seq = fleet
    budget = 2 * R
    jcfg = JaxConfig(**dict(FLEET, grid_backend="xla"))
    jstep = jax.jit(functools.partial(jpipe.fleet_step, cfg=jcfg,
                                      orientation_budget=budget))
    jstates, states = JaxState.create_batch(jcfg, R), eng.init_states(R)
    n_poses = 0
    worst = 1.0
    for i, obs in enumerate(obs_seq):
        jstates, jout = jstep(tree, jstates, _jax_obs(obs),
                              jdemo.default_extrinsics())
        states, out = eng.fleet(states, obs, budget)
        n_poses += _compare(out, jout)[0]
        np.testing.assert_array_equal(states.rng.numpy(),
                                      np.asarray(jstates.rng))
        np.testing.assert_array_equal(states.step.numpy(),
                                      np.asarray(jstates.step))
        agree = (out.occupancy_i8.numpy()
                 == np.asarray(jout.occupancy_i8)).mean(axis=(1, 2))
        assert agree.min() >= 0.99, f"tick {i}: agreement {agree}"
        worst = min(worst, agree.min())
    assert worst >= 0.999, worst                   # the figure reached
    assert n_poses >= 3 * TICKS, n_poses
    # the refine kept the full-capacity depth query: nothing was clamped
    assert int(out.saturation.static_depth_clamped.sum()) == 0


def test_extension_fleet_equals_per_rig_step_and_plain_backends(fleet):
    """A full budget equals per-rig step, rig by rig, carve included; and
    the kernel backends' twins equal the plain ("xla") backends' grid."""
    cfg, _, eng, obs_seq = fleet
    states, out = eng.fleet(eng.init_states(R), obs_seq[0])
    for r in range(R):
        state, ref = eng(eng.init_state(r), obs_seq[0].select(r))
        assert torch.equal(states.log_odds[r], state.log_odds)
        assert torch.equal(out.occupancy_i8[r], ref.occupancy_i8)
        assert torch.equal(out.poses.valid[r], ref.poses.valid)
    plain_cfg = dataclasses.replace(
        cfg, detector_stem_backend="xla", orientation_stem_backend="xla",
        grid_backend="xla", knn_backend="xla")
    plain = pipeline.Engine(plain_cfg, extrinsics=eng.extrinsics,
                            params={k: eng.params[k]
                                    for k in ("detector", "orientation")},
                            device="cpu")
    pstates, pout = plain.fleet(plain.init_states(R), obs_seq[0])
    assert torch.equal(pout.poses.valid, out.poses.valid)
    assert (pout.occupancy_i8 == out.occupancy_i8).float().mean() >= 0.999


def test_carve_respects_the_input_gates(fleet):
    """No cloud: no carve, the update is decay plus hits. Neither input:
    no update at all (quirk Q1), carve or not."""
    cfg, _, eng, obs_seq = fleet
    obs = obs_seq[0]
    no_cloud = dataclasses.replace(obs,
                                   has_cloud=torch.zeros(R, dtype=torch.bool))
    states0 = eng.init_states(R)
    states, out = eng.fleet(states0, no_cloud)
    hits = pipeline.Engine(
        dataclasses.replace(cfg, raycast_free_space=False),
        extrinsics=eng.extrinsics, params=eng.params, device="cpu")
    ref_states, _ = hits.fleet(states0, no_cloud)
    assert torch.equal(states.log_odds, ref_states.log_odds)
    nothing = dataclasses.replace(
        no_cloud, has_image=torch.zeros(R, dtype=torch.bool))
    states, out = eng.fleet(states0, nothing)
    assert torch.equal(states.log_odds, states0.log_odds)
    assert torch.equal(states.occupancy, states0.occupancy)
    assert int(states.step[0]) == 1


def test_direct_callers_get_the_maps_computed_in_place(fleet):
    cfg, _, eng, obs_seq = fleet
    bare = {k: eng.params[k] for k in ("detector", "orientation")}
    obs = obs_seq[0].select(0)
    kept, _ = pipeline.step(eng.params, eng.init_state(), obs,
                            eng.extrinsics, cfg)
    made, _ = pipeline.step(bare, eng.init_state(), obs, eng.extrinsics, cfg)
    assert torch.equal(kept.log_odds, made.log_odds)
    cbin, cr = raycast.cell_polar_maps(eng.extrinsics.camera_to_base[:2, 3],
                                       cfg)
    assert torch.equal(cbin, eng.params["carve_maps"][0])
    assert cbin.shape == tuple(cfg.grid_size)       # (H, W) for any R


def test_carve_takes_precedence_over_yaw_aware(fleet):
    cfg, _, eng, obs_seq = fleet
    both = pipeline.Engine(
        dataclasses.replace(cfg, yaw_aware_rasterization=True),
        extrinsics=eng.extrinsics, params=eng.params, device="cpu")
    a, _ = both.fleet(both.init_states(R), obs_seq[0])
    b, _ = eng.fleet(eng.init_states(R), obs_seq[0])
    assert torch.equal(a.log_odds, b.log_odds)


@pytest.mark.parametrize("flag", ["raycast_free_space",
                                  "yaw_aware_rasterization",
                                  "vision_depth_refine", "class_aware_nms"])
def test_check_slice_accepts_the_extension_flags(fleet, flag):
    """Each extension flag alone passes validate() and runs the fleet tick
    (the port refuses no configuration validate() accepts; the name is
    the one it had when a check of the port's own, gone since, stood
    beside validate())."""
    _, _, eng, obs_seq = fleet
    cfg = dataclasses.replace(GridVisionConfig(**SMALL), **{flag: True})
    cfg.validate()
    run = pipeline.Engine(cfg, extrinsics=eng.extrinsics,
                          params={k: eng.params[k]
                                  for k in ("detector", "orientation")},
                          device="cpu")
    _, out = run.fleet(run.init_states(R), obs_seq[0])
    assert torch.isfinite(out.poses.position[out.poses.valid]).all()


@pytest.mark.parametrize("overrides,name", [
    (dict(detector_precision="int8", detector_stem_backend="xla"),
     "detector_precision"),
    (dict(detector_s2d_stem=True, detector_stem_backend="xla"),
     "detector_s2d_stem"),
    (dict(orientation_s2d_fold=False), "orientation_s2d_fold"),
    (dict(detector_stem_backend="im2col"), "detector_stem_backend"),
    (dict(knn_backend="approx"), "knn_backend"),
    (dict(orientation_arch="resnet"), "orientation_arch"),
])
def test_check_slice_still_refuses_the_unported(fleet, overrides, name):
    """The knobs the port once refused now run the extension tick, single
    rig and fleet, with the carve kernel's twin. The s2d stem, the unfolded
    orientation stem, the im2col stem and the approx kNN compute the
    default's math (tests/test_torch_knobs.py holds each to the JAX
    package): their ticks keep the default's boxes and box validity. int8
    and the resnet (the flax init at seed 1) are other nets: their outputs
    are finite (tests/test_torch_int8_detector.py and
    tests/test_torch_knobs.py hold them to the JAX package). The test
    keeps the name it had when the port refused these knobs."""
    _, _, eng, obs_seq = fleet
    base = GridVisionConfig(**dict(SMALL, raycast_free_space=True,
                                   detector_stem_backend=overrides.get(
                                       "detector_stem_backend", "pallas")))
    cfg = dataclasses.replace(base, **overrides)
    cfg.validate()
    assert getattr(cfg, name) != getattr(GridVisionConfig(), name)
    nets = {k: eng.params[k] for k in ("detector", "orientation")}
    if name == "orientation_arch":
        nets = dict(nets, orientation=weights.init_all(
            cfg, seed=1, device="cpu")["orientation"])
    outs = []
    for c in (cfg, base):
        run = pipeline.Engine(c, extrinsics=eng.extrinsics, params=nets,
                              device="cpu")
        _, out = run(run.init_state(), obs_seq[0].select(0))
        _, fout = run.fleet(run.init_states(R), obs_seq[0])
        outs.append((out, fout))
    for got, ref in zip(*outs):
        assert torch.isfinite(got.poses.position[got.poses.valid]).all()
        assert torch.isfinite(got.boxes.xyxy).all()
        assert got.occupancy_i8.shape == ref.occupancy_i8.shape
        if name in ("detector_precision", "orientation_arch"):
            continue
        assert torch.equal(got.boxes.valid, ref.boxes.valid)
        torch.testing.assert_close(got.boxes.xyxy, ref.boxes.xyxy,
                                   rtol=1e-4, atol=1e-3)
        if name == "knn_backend":
            assert torch.equal(got.static_depths, ref.static_depths)
