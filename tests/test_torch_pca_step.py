"""The PCA pose branch (use_vision_orientation=False) through the port's
pipeline.step, pipeline.fuse and Engine, against the JAX package's jitted
step and fuse on the "xla" backends (the JAX package's own tests run it
so), at a reduced size: a 96x128 camera, 2048 points, a 30 m x 10 m grid at
0.25 m, 32 RANSAC hypotheses, 128 points a box sub-cloud. The port runs
its kernel backends ("pallas"; on the CPU each wrapper runs its plain
twin). The same random weights on both sides; the detector heads' biases
push the small anchors of the 26-grid to confident signs and vehicles, so
every tick has several dozen boxes, static and dynamic, and sub-clouds that
truncate. In bf16 the JAX package's bf16 detector is injected into the
port: the PCA branch computes in f32 from the f32 cloud in both packages,
so only the detector differs between them, and with these saturated heads
nearly every confidence ties in bf16 (the port's own bf16 detector is held
to the JAX package at full width, tests/test_torch_full_width.py).

Bars: box validity, labels, pose validity and every SaturationStats
counter exact (box_cloud_truncated counts the truncated sub-clouds,
orientation_clamped and orientation_dropped are 0); boxes, static depths
and points and the pose fields 1e-4; the rng key bit-equal; occupancy_i8
agreement >= 99.9 % per tick (these runs: 100 %), in f32, in bf16 and in
extension mode with raycast free-space carving (each package computes its
own polar maps there, tests/test_torch_extension_tick.py). fuse takes
injected boxes: the scene's ground-truth boxes, one more overlapping the
vehicle, one a single pixel, at 64 points a sub-cloud. A PCA
configuration with vision_depth_refine compacts the static kNN query and
refines nothing, as the JAX package does. A PCA Engine folds no
orientation-kernel constants.
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
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.runtime.stream import obs_from_scene
from grid_vision_tpu_torch.types import Boxes, GridState

torch.set_num_threads(1)

TICKS = 3
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=2048, grid_x=30, grid_y=10,
             resolution=0.25, use_vision_orientation=False,
             ransac_iters=32, max_points_per_box=128)
KERNELS = dict(detector_stem_backend="pallas", grid_backend="pallas",
               knn_backend="pallas", orientation_stem_backend="pallas")
MODES = {"f32": {}, "bf16": dict(compute_dtype="bfloat16"),
         "carve": dict(compat=False, raycast_free_space=True)}
N_GROUND = 1200
TOL = dict(rtol=1e-4, atol=1e-4)


def params(cfg_kw, seed=1):
    """JAX's random weights (numpy tree) and the port's nets loaded from
    them. The 13-grid's large anchors are turned off and the 26-grid's
    anchors made confident, smaller speed signs (the first anchor) and
    vehicles (the other two)."""
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**cfg_kw), seed=seed))
    for head in ("head_13", "head_26"):
        b = np.array(tree["detector"]["params"][head]["bias"])
        k = np.array(tree["detector"]["params"][head]["kernel"])
        for a in range(3):
            k[..., a * 15 + 4] *= 30.0                # spread the scores
            b[a * 15 + 2:a * 15 + 4] -= 1.0           # w, h
            b[a * 15 + 4] += 4.0 if head == "head_26" else -8.0   # object
            b[a * 15 + 5 + (7 if a == 0 else 9)] += 4.0   # sign, vehicle
        tree["detector"]["params"][head]["bias"] = b
        tree["detector"]["params"][head]["kernel"] = k
    nets = weights.load_all(GridVisionConfig(**cfg_kw), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    return tree, nets


def close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                               err_msg=what)


def compare(out, jout):
    """Everything of one tick (rig axes allowed); returns (poses,
    occupancy_i8 agreement)."""
    valid = np.array(jout.boxes.valid)
    np.testing.assert_array_equal(out.boxes.valid.numpy(), valid)
    np.testing.assert_array_equal(out.boxes.label.numpy(),
                                  np.asarray(jout.boxes.label))
    close(out.boxes.xyxy, jout.boxes.xyxy, "boxes")
    static = np.array(jout.static_boxes.valid)
    np.testing.assert_array_equal(out.static_boxes.valid.numpy(), static)
    close(out.static_depths, jout.static_depths, "static_depths")
    close(out.static_points, jout.static_points, "static_points")
    pv = np.array(jout.poses.valid)
    np.testing.assert_array_equal(out.poses.valid.numpy(), pv)
    for f in ("position", "quat", "length", "width", "height"):
        got = getattr(out.poses, f).numpy()
        assert np.isfinite(got[pv]).all(), f
        np.testing.assert_allclose(got[pv],
                                   np.asarray(getattr(jout.poses, f))[pv],
                                   **TOL, err_msg=f)
    for f in dataclasses.fields(out.saturation):
        np.testing.assert_array_equal(
            getattr(out.saturation, f.name).numpy(),
            np.asarray(getattr(jout.saturation, f.name)), f.name)
    assert not out.saturation.orientation_clamped.any()
    assert not out.saturation.orientation_dropped.any()
    agree = (out.occupancy_i8.numpy()
             == np.asarray(jout.occupancy_i8)).reshape(
                 -1, int(np.prod(out.occupancy_i8.shape[-2:]))).mean(-1)
    return int(pv.sum()), float(agree.min())


def scenes(jcfg, cfg, seed):
    js = JaxScene(jcfg, seed=seed, n_ground=N_GROUND)
    ps = SyntheticScene(cfg, seed=seed, n_ground=N_GROUND)
    for s in (js, ps):
        s.add_default_traffic()
        s.add_default_statics()
    return js, ps


def inject_jax_detector(monkeypatch, tree, jcfg):
    """The port's pipeline with the JAX package's detector (its bf16 net on
    the same frames) in place of its own."""
    @jax.jit
    def jdetector(tree, images):
        net_in, ycfg = jpipe._detector_input(tree, images, jcfg)
        return jpipe._detector_forward(tree, net_in, ycfg, jcfg)

    def detector(params, images, cfg):
        boxes, confs = jdetector(tree, jnp.asarray(images.float().numpy()))
        return torch.tensor(np.asarray(boxes)), \
            torch.tensor(np.asarray(confs))

    monkeypatch.setattr(pipeline, "_detector_forward", detector)


@pytest.mark.parametrize("mode", list(MODES))
def test_pca_step_matches_jax(mode, monkeypatch):
    kw = dict(SMALL, **MODES[mode])
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw, **KERNELS)
    tree, nets = params(kw)
    if mode == "bf16":
        inject_jax_detector(monkeypatch, tree, jcfg)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    js, ps = scenes(jcfg, cfg, 2)
    jstate, state = JaxState.create(jcfg), eng.init_state()
    n_poses, n_trunc = 0, 0
    for i in range(TICKS):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(js, t, jcfg),
                             jdemo.default_extrinsics())
        state, out = eng(state, obs_from_scene(ps, t, cfg, "cpu"))
        poses, agree = compare(out, jout)
        assert agree >= 0.999, f"tick {i}: occupancy_i8 agreement {agree}"
        np.testing.assert_array_equal(state.rng.numpy(),
                                      np.asarray(jstate.rng))
        if mode != "carve":
            np.testing.assert_array_equal(state.log_odds.numpy(),
                                          np.asarray(jstate.log_odds))
        n_poses += poses
        n_trunc += int(out.saturation.box_cloud_truncated)
    assert n_poses > 0 and n_trunc > 0, (n_poses, n_trunc)


def _scene_boxes(scene, t, capacity, extra):
    """The scene's ground-truth boxes at t, truncated to pixels as the
    decode does, then `extra` (x0, y0, x1, y1, label) boxes."""
    rows = []
    for i in range(len(scene.objects)):
        b = scene.bbox_at(i, t)
        if b is not None:
            rows.append([int(b["x_min"]), int(b["y_min"]), int(b["x_max"]),
                         int(b["y_max"]), b["label"]])
    rows = (rows + extra)[:capacity]
    xyxy = np.zeros((capacity, 4), np.float32)
    label = np.full((capacity,), 10, np.int32)
    conf = np.zeros((capacity,), np.float32)
    valid = np.zeros((capacity,), bool)
    for i, r in enumerate(rows):
        xyxy[i], label[i], conf[i], valid[i] = r[:4], r[4], 0.9 - 0.01 * i, 1
    return xyxy, conf, label, valid


def test_pca_fuse_injected_boxes_matches_jax():
    kw = dict(SMALL, max_points_per_box=64)
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw, **KERNELS)
    _, nets = params(kw)
    jfuse = jax.jit(lambda s, o, b: jpipe.fuse({}, s, o, b,
                                               jdemo.default_extrinsics(),
                                               jcfg))
    js, ps = scenes(jcfg, cfg, 3)
    jstate, state = JaxState.create(jcfg), GridState.create(cfg, device="cpu")
    n_poses = n_trunc = 0
    for i in range(TICKS):
        t = i / 10.0
        car = ps.bbox_at(0, t)
        extra = [[int(car["x_min"]) + 3, int(car["y_min"]) - 2,
                  int(car["x_max"]) + 9, int(car["y_max"]), 9],
                 [60, 60, 60, 60, 2]]
        arrs = _scene_boxes(ps, t, cfg.max_detections, extra)
        jboxes = JaxBoxes(*(jnp.asarray(a) for a in arrs))
        boxes = Boxes(*(torch.tensor(a) for a in arrs))
        jstate, jout = jfuse(jstate, jobs_from_scene(js, t, jcfg), jboxes)
        state, out = pipeline.fuse(nets, state,
                                   obs_from_scene(ps, t, cfg, "cpu"), boxes,
                                   demo.default_extrinsics("cpu"), cfg)
        poses, agree = compare(out, jout)
        assert agree == 1.0, f"tick {i}: occupancy_i8 agreement {agree}"
        np.testing.assert_array_equal(state.log_odds.numpy(),
                                      np.asarray(jstate.log_odds))
        n_poses += poses
        n_trunc += int(out.saturation.box_cloud_truncated)
    assert n_poses >= 2 * TICKS and n_trunc > 0, (n_poses, n_trunc)


def test_pca_with_depth_refine_flag_compacts_and_does_not_refine():
    """vision_depth_refine refines vision poses only: under PCA the static
    kNN query is compacted to max_static_depth and the poses are the PCA
    ones (JAX pipeline.py:332, 379)."""
    kw = dict(SMALL, compat=False, vision_depth_refine=True,
              max_static_depth=2)
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw, **KERNELS)
    tree, nets = params(kw)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    plain = pipeline.Engine(dataclasses.replace(
        cfg, vision_depth_refine=False), extrinsics=eng.extrinsics,
        params=nets, device="cpu")
    js, ps = scenes(jcfg, cfg, 2)
    jstate, state, pstate = (JaxState.create(jcfg), eng.init_state(),
                             plain.init_state())
    clamped = 0
    for i in range(2):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(js, t, jcfg),
                             jdemo.default_extrinsics())
        obs = obs_from_scene(ps, t, cfg, "cpu")
        state, out = eng(state, obs)
        pstate, pout = plain(pstate, obs)
        _, agree = compare(out, jout)
        assert agree >= 0.999
        for f in ("position", "valid", "length"):
            assert torch.equal(getattr(out.poses, f), getattr(pout.poses, f))
        clamped += int(out.saturation.static_depth_clamped)
    assert clamped > 0


def test_pca_engine_holds_no_orientation_constants():
    kw = dict(SMALL, **dict(KERNELS, detector_stem_backend="pallas2"))
    nets = weights.load_all(GridVisionConfig(**kw), device="cpu")
    pca = pipeline.Engine(GridVisionConfig(**kw), params=nets, device="cpu")
    vision = pipeline.Engine(GridVisionConfig(
        **dict(kw, use_vision_orientation=True)), params=nets, device="cpu")
    assert "orientation_stem" not in pca.params
    assert {"detector_stem", "detector_csp"} <= set(pca.params)
    assert "orientation_stem" in vision.params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_slice_accepts_pca(dtype):
    """The PCA branch in either dtype, and with the int8 detector
    (extension mode), passes validate() and runs a tick. The test keeps
    the name it had when a check of the port's own, gone since, stood
    beside validate()."""
    kw = dict(SMALL, use_vision_orientation=False, compute_dtype=dtype)
    cfg = GridVisionConfig(**kw)
    cfg.validate()
    int8 = dataclasses.replace(cfg, detector_precision="int8", compat=False)
    int8.validate()
    nets = weights.load_all(cfg, device="cpu")
    eng = pipeline.Engine(int8, params=nets, device="cpu")
    assert "detector_q" in eng.params
    scene = SyntheticScene(int8, seed=0, n_ground=200)
    scene.add_default_traffic()
    _, out = eng(eng.init_state(), obs_from_scene(scene, 0.0, int8, "cpu"))
    assert torch.isfinite(out.poses.position[out.poses.valid]).all()
    assert out.occupancy_i8.dtype == torch.int8
