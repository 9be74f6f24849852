"""The slice as a whole: the port's pipeline.step against the JAX
package's jitted pipeline.step in the slice's configuration (all three
kernel backends "pallas"; the JAX kernels run in interpret mode here, the
port's wrappers run their plain twins), four ticks of a SyntheticScene at
a reduced size, the same random weights on both sides.

Tolerances: boxes, static depths / points and poses 1e-4; occupancy_i8
agreement >= 99.9% per tick (exact is expected and is what this run
gives); log-odds and the rng key bit-equal. Also: importing the port
pulls in no JAX module."""

import dataclasses
import functools
import subprocess
import sys

import jax
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
from grid_vision_tpu_torch import demo, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.runtime.stream import obs_from_scene

torch.set_num_threads(1)

TICKS = 4
# reduced size: 96x128 camera, detector 64, orientation 64 / width 8,
# a 30 m x 10 m grid at 0.25 m, 512 points
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, detector_stem_backend="pallas",
             grid_backend="pallas", knn_backend="pallas")
# random heads give confidences near 0.25; scaled up, a handful of
# anchors clear the 0.6 threshold
HEAD_SCALE = 150.0
TOL = dict(rtol=1e-4, atol=1e-4)


def _params(seed):
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**SMALL), seed=seed))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(GridVisionConfig(**SMALL), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    return tree, nets


def _close(got, ref, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                               err_msg=what)


@pytest.mark.parametrize("seed", [1, 2])
def test_step_matches_jax_step(seed):
    jcfg, cfg = JaxConfig(**SMALL), GridVisionConfig(**SMALL)
    tree, nets = _params(seed)
    jstep = jax.jit(functools.partial(jpipe.step, cfg=jcfg))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    jscene = JaxScene(jcfg, seed=seed, n_ground=600)
    scene = SyntheticScene(cfg, seed=seed, n_ground=600)
    for s in (jscene, scene):
        s.add_default_traffic()
        s.add_default_statics()
    jstate, state = JaxState.create(jcfg), eng.init_state()
    n_dyn = n_static = 0
    for i in range(TICKS):
        t = i / 10.0
        jstate, jout = jstep(tree, jstate, jobs_from_scene(jscene, t, jcfg),
                             jdemo.default_extrinsics())
        state, out = eng(state, obs_from_scene(scene, t, cfg, "cpu"))
        valid = np.array(jout.boxes.valid)
        np.testing.assert_array_equal(out.boxes.valid.numpy(), valid)
        np.testing.assert_array_equal(out.boxes.label.numpy(),
                                      np.asarray(jout.boxes.label))
        _close(out.boxes.xyxy, jout.boxes.xyxy, "boxes")
        _close(out.boxes.confidence, jout.boxes.confidence, "confidence")
        static = np.array(jout.static_boxes.valid)
        np.testing.assert_array_equal(out.static_boxes.valid.numpy(), static)
        _close(out.static_depths[static], np.asarray(jout.static_depths)[
            static], "static_depths")
        _close(out.static_points, jout.static_points, "static_points")
        pv = np.array(jout.poses.valid)
        np.testing.assert_array_equal(out.poses.valid.numpy(), pv)
        for f in ("position", "quat", "length", "width", "height"):
            _close(getattr(out.poses, f)[pv],
                   np.asarray(getattr(jout.poses, f))[pv], f)
        for f in dataclasses.fields(out.saturation):
            assert int(getattr(out.saturation, f.name)) == int(
                getattr(jout.saturation, f.name)), f.name
        agree = (out.occupancy_i8.numpy()
                 == np.asarray(jout.occupancy_i8)).mean()
        assert agree >= 0.999, f"tick {i}: occupancy_i8 agreement {agree}"
        np.testing.assert_array_equal(state.log_odds.numpy(),
                                      np.asarray(jstate.log_odds))
        np.testing.assert_array_equal(state.rng.numpy(),
                                      np.asarray(jstate.rng))
        n_dyn += int(pv.sum())
        n_static += int(static.sum())
    assert int(state.step) == TICKS
    # the run exercised both branches
    assert n_dyn > 0 and n_static > 0, (n_dyn, n_static)


def test_engine_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.Engine(GridVisionConfig(**SMALL))


def test_helpers_default_to_the_card():
    """weights.load_all, obs_from_scene and default_extrinsics run on the
    card unless the CPU is asked for; without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = GridVisionConfig(**SMALL)
    scene = SyntheticScene(cfg, seed=0, n_ground=50)
    for call in (lambda: weights.load_all(cfg),
                 lambda: obs_from_scene(scene, 0.0, cfg),
                 lambda: demo.default_extrinsics()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert demo.default_extrinsics("cpu").camera_to_base.device.type == "cpu"


def test_unported_options_raise():
    """The port has no check of its own left: what validate() refuses (int8
    in compat mode, int8 with a stem kernel) the Engine refuses, and what it
    accepts the Engine builds (int8 quantized once at init). The test
    keeps the name it had when the port refused options of its own."""
    assert not hasattr(pipeline, "check_slice")
    for bad in (dict(detector_precision="int8"),
                dict(detector_precision="int8", compat=False)):
        with pytest.raises(ValueError):    # SMALL's stem is "pallas"
            pipeline.Engine(GridVisionConfig(**dict(SMALL, **bad)),
                            device="cpu")
    cfg = GridVisionConfig(**dict(SMALL, detector_precision="int8",
                                  compat=False, detector_stem_backend="xla"))
    eng = pipeline.Engine(cfg, device="cpu")
    assert eng.params["detector_q"]["ConvBN_0"]["wq"].dtype == torch.int8


def test_import_pulls_in_no_jax():
    code = ("import sys, grid_vision_tpu_torch, grid_vision_tpu_torch.pipeline,"
            " grid_vision_tpu_torch.demo, grid_vision_tpu_torch.runtime.stream,"
            " grid_vision_tpu_torch.ops.cuda_csp,"
            " grid_vision_tpu_torch.ops.cuda_orient,"
            " grid_vision_tpu_torch.ops.cuda_raycast,"
            " grid_vision_tpu_torch.ops.raycast,"
            " grid_vision_tpu_torch.utils.prng,"
            " grid_vision_tpu_torch.utils.stats,"
            " grid_vision_tpu_torch.runtime.native,"
            " grid_vision_tpu_torch.runtime.timing,"
            " grid_vision_tpu_torch.runtime.live,"
            " grid_vision_tpu_torch.runtime.record,"
            " grid_vision_tpu_torch.runtime.session,"
            " grid_vision_tpu_torch.io.sensors,"
            " grid_vision_tpu_torch.io.grid_codec,"
            " grid_vision_tpu_torch.io.viz,"
            " grid_vision_tpu_torch.io.font,"
            " grid_vision_tpu_torch.ops.tracking,"
            " grid_vision_tpu_torch.train.eval_tracking,"
            " grid_vision_tpu_torch.train.targets,"
            " grid_vision_tpu_torch.train.synth_data,"
            " grid_vision_tpu_torch.train.losses,"
            " grid_vision_tpu_torch.train.trainer,"
            " grid_vision_tpu_torch.train.scene_dataset,"
            " grid_vision_tpu_torch.train.fit_on_device,"
            " grid_vision_tpu_torch.train.fit_orientation,"
            " grid_vision_tpu_torch.train.fit_synthetic,"
            " grid_vision_tpu_torch.train.eval_map,"
            " grid_vision_tpu_torch.train.eval_pose,"
            " grid_vision_tpu_torch.parallel,"
            " grid_vision_tpu_torch.runtime.serve,"
            " grid_vision_tpu_torch.bench,"
            " grid_vision_tpu_torch.runtime.viewer,"
            " grid_vision_tpu_torch.io.viz3d,"
            " grid_vision_tpu_torch.io.png,"
            " grid_vision_tpu_torch.io.grid_msg,"
            " grid_vision_tpu_torch.utils.guards,"
            " grid_vision_tpu_torch.device,"
            " grid_vision_tpu_torch.__main__; bad = [m for m in sys.modules if m in"
            " ('jax', 'flax', 'optax', 'grid_vision_tpu') or m.startswith("
            "('jax.', 'flax.', 'optax.', 'grid_vision_tpu.'))]; print(bad);"
            " sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("card_file", ["test_torch_cuda",
                                       "test_torch_cuda_stream",
                                       "test_torch_cuda_tick",
                                       "test_torch_cuda_train"])
def test_card_file_imports_no_jax(card_file):
    """The card suite runs where only torch is installed: a card file
    imported in a fresh process, without the tests' conftest, imports
    nothing of JAX, flax, optax or the JAX package."""
    code = (f"import sys, tests.{card_file}; bad = [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'flax', 'optax',"
            " 'grid_vision_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
