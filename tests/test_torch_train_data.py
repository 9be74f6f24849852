"""Training data through the port against the JAX package, on the same
keys and seeds: the rendered rectangle world (train/synth_data.py: boxes,
labels and valid flags bit for bit, pixels to 1e-3), its dense targets
exactly, the host targets (train/targets.py, with the cases of
tests/test_targets.py run on the port), the scene datasets of both
trainers and the host-scene trainer's batch (its resize held to
jax.image.resize's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_targets as jax_target_tests
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models.yolov4_tiny import YoloConfig as JaxYolo
from grid_vision_tpu.train import fit_orientation as jfit_orientation
from grid_vision_tpu.train import fit_synthetic as jfit_synthetic
from grid_vision_tpu.train import scene_dataset as jscene
from grid_vision_tpu.train import synth_data as jsynth
from grid_vision_tpu.train import targets as jtargets
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import yolov4_tiny
from grid_vision_tpu_torch.train import (fit_orientation, fit_synthetic,
                                         scene_dataset, synth_data, targets)

torch.set_num_threads(1)


def _keys(jkeys):
    return torch.tensor(np.stack([np.asarray(k) for k in jkeys]))


@pytest.mark.parametrize("hw,keys", [
    ((96, 128), [jax.random.PRNGKey(7_700_000 + i) for i in range(12)]),
    ((96, 128), list(jax.random.split(jax.random.PRNGKey(5), 12))),
    ((480, 640), [jax.random.PRNGKey(7_700_000)]),
])
def test_render_image_matches(hw, keys):
    """The eval keys 7_700_000 + i among them: the port's "synth" frames
    are the JAX package's."""
    render = jax.jit(lambda k: jsynth.render_image(k, *hw))
    img, boxes, labels, valid = synth_data.render_image(_keys(keys), *hw)
    for i, k in enumerate(keys):
        ji, jb, jl, jv = render(k)
        np.testing.assert_array_equal(boxes[i].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        np.testing.assert_allclose(img[i].numpy(), np.asarray(ji), rtol=0,
                                   atol=1e-3)


def test_exp_is_xlas():
    x = np.concatenate([
        np.random.default_rng(0).uniform(-10, 10, 200000),
        np.random.default_rng(1).uniform(np.log(0.018), np.log(0.45),
                                         200000)]).astype(np.float32)
    np.testing.assert_array_equal(
        synth_data.exp_f32(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(jnp.exp)(x)))


@pytest.mark.parametrize("size", [64, 416])
def test_make_batch_on_device_targets_exact(size):
    jcfg = JaxYolo(input_size=size)
    make = jax.jit(lambda k: jsynth.make_batch_on_device(k, 6, jcfg,
                                                         (96, 128)))
    for seed in range(4):
        jk = jax.random.PRNGKey(seed)
        want = make(jk)
        got = synth_data.make_batch_on_device(
            torch.tensor(np.asarray(jk)), 6,
            yolov4_tiny.YoloConfig(input_size=size), (96, 128))
        for g, w, name in zip(got[1:], want[1:], ("boxes", "class", "pos")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} seed {seed}")
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [
    "test_assignment_lands_in_correct_cell", "test_small_box_goes_to_26_grid",
    "test_shared_anchor_3_hits_both_heads"])
def test_jax_target_cases_on_the_port(case, monkeypatch):
    """tests/test_targets.py's assignment cases, run on the port's
    assign_targets / head_offsets / YoloConfig."""
    monkeypatch.setattr(jax_target_tests, "assign_targets",
                        targets.assign_targets)
    monkeypatch.setattr(jax_target_tests, "head_offsets",
                        targets.head_offsets)
    monkeypatch.setattr(jax_target_tests, "YoloConfig",
                        yolov4_tiny.YoloConfig)
    getattr(jax_target_tests, case)()


def test_assign_targets_random_boxes_equal():
    rng = np.random.default_rng(0)
    for size in (64, 416):
        gts = []
        for _ in range(40):
            x0, y0 = rng.uniform(-0.1, 0.9, 2)
            w, h = np.exp(rng.uniform(np.log(0.005), np.log(0.9), 2))
            gts.append({"x_min": x0, "y_min": y0, "x_max": x0 + w,
                        "y_max": y0 + h, "label": int(rng.integers(10))})
        for a, b in zip(targets.assign_targets(gts, yolov4_tiny.YoloConfig(
                input_size=size)), jtargets.assign_targets(
                gts, JaxYolo(input_size=size))):
            np.testing.assert_array_equal(a, b)


def test_scene_dataset_equal():
    kw = dict(seed=2000, two_wheeler_boost=0.7)
    got = scene_dataset.build_scene_dataset(
        3, GridVisionConfig(), yolov4_tiny.YoloConfig(input_size=64), **kw)
    want = jscene.build_scene_dataset(3, JaxConfig(), JaxYolo(input_size=64),
                                      **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_scene_crop_dataset_matches():
    got = fit_orientation.build_scene_crop_dataset(4, 32, seed=4000,
                                                 device="cpu")
    want = jfit_orientation.build_scene_crop_dataset(4, 32, seed=4000)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_host_scene_batch_matches():
    """fit_synthetic.make_batch: the same scenes and targets, the frames
    resized by the detector's resize against jax.image.resize(...,
    "linear")."""
    cfg_kw = dict(camera_image_height=96, camera_image_width=128)
    got = fit_synthetic.make_batch(
        GridVisionConfig(**cfg_kw), yolov4_tiny.YoloConfig(input_size=64),
        np.random.default_rng(0), 3, device="cpu")
    want = jfit_synthetic.make_batch(
        None, JaxConfig(**cfg_kw), JaxYolo(input_size=64),
        np.random.default_rng(0), 3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
