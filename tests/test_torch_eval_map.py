"""The mAP harness (train/eval_map.py) against the JAX package's: the
scoring cases of tests/test_eval_map.py run on the port's functions,
random predictions scored identically, the held-out frames, and
evaluate_detector with the shipped weights on 8 synth + 8 scene frames
(box counts per frame equal, mAP@0.5 within 1e-6)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import tests.test_eval_map as jax_map_tests
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.train import eval_map as jeval
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.train import eval_map

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORING = ["test_iou_matrix_exact", "test_average_precision_hand_case",
           "test_average_precision_envelope",
           "test_average_precision_empty_and_nan",
           "test_match_greedy_one_to_one", "test_match_class_must_agree",
           "test_match_iou_threshold", "test_score_detections_perfect"]


@pytest.mark.parametrize("case", SCORING)
def test_jax_scoring_cases_on_the_port(case, monkeypatch):
    for name in ("average_precision", "iou_matrix", "match_image",
                 "score_detections"):
        monkeypatch.setattr(jax_map_tests, name, getattr(eval_map, name))
    getattr(jax_map_tests, case)()


def test_random_scoring_equal():
    rng = np.random.default_rng(0)
    preds, gts = [], []
    for _ in range(20):
        n, g = int(rng.integers(0, 12)), int(rng.integers(0, 6))
        lo = rng.uniform(0, 500, (n, 2))
        preds.append((np.concatenate([lo, lo + rng.uniform(5, 80, (n, 2))],
                                     1).astype(np.float32),
                      rng.uniform(0.05, 1, n).astype(np.float32),
                      rng.integers(0, 10, n)))
        lo = rng.uniform(0, 500, (g, 2))
        gts.append((np.concatenate([lo, lo + rng.uniform(5, 80, (g, 2))],
                                   1).astype(np.float32),
                    rng.integers(0, 10, g)))
    # half the predictions on their ground truth, nudged
    for (pxy, _, pl), (gxy, gl) in zip(preds, gts):
        k = min(len(pxy), len(gxy)) // 2
        pxy[:k] = gxy[:k] + rng.uniform(-3, 3, (k, 4))
        pl[:k] = gl[:k]
    for iou in (0.5, 0.3):
        assert (eval_map.score_detections(preds, gts, iou).to_dict()
                == jeval.score_detections(preds, gts, iou).to_dict())


def test_heldout_frames_match():
    cfg = dict(camera_image_height=96, camera_image_width=128)
    img, gts = eval_map.heldout_synth(5, GridVisionConfig(**cfg), chunk=2,
                                      device="cpu")
    jimg, jgts = jeval.heldout_synth(5, JaxConfig(**cfg))
    for a, b, (g, gl), (jg, jgl) in zip(img, jimg, gts, jgts):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(gl, jgl)
    img, gts = eval_map.heldout_scene(3, GridVisionConfig(**cfg))
    jimg, jgts = jeval.heldout_scene(3, JaxConfig(**cfg))
    for a, b, (g, gl), (jg, jgl) in zip(img, jimg, gts, jgts):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g, jg)
        np.testing.assert_array_equal(gl, jgl)


@pytest.mark.parametrize("source", ["synth", "scene"])
def test_evaluate_detector_shipped_weights(source):
    """The same frames through both packages' detect paths: equal box
    counts per frame; each package's evaluate_detector on its own frames:
    mAP@0.5 within 1e-6."""
    kw = dict(detection_weights_file="/weights/detector.npz")
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw)
    jparams = jweights.load_all(jcfg, base_dir=ROOT)
    params = weights.load_all(cfg, base_dir=ROOT, device="cpu")
    n = 8
    held = jeval.heldout_synth if source == "synth" else jeval.heldout_scene
    ecfg = dataclasses.replace(jcfg, confidence_threshold=0.05)
    images, _ = held(n, ecfg)
    jpreds = jeval._detect_batched(jparams, images, ecfg, batch=n)
    preds = eval_map.detect_images(
        params, images, dataclasses.replace(cfg, confidence_threshold=0.05),
        batch=n, device="cpu")
    assert [len(p[0]) for p in preds] == [len(p[0]) for p in jpreds]
    for (xy, c, lb), (jxy, jc, jlb) in zip(preds, jpreds):
        np.testing.assert_array_equal(lb, jlb)
        np.testing.assert_allclose(xy, jxy, rtol=0, atol=1e-3)
        np.testing.assert_allclose(c, jc, rtol=0, atol=1e-4)
    want = jeval.evaluate_detector(jparams, jcfg, n_images=n, source=source)
    got = eval_map.evaluate_detector(params, cfg, n_images=n, source=source)
    assert got.n_gt == want.n_gt and got.n_pred == want.n_pred
    assert abs(got.map50 - want.map50) <= 1e-6, (got.to_dict(),
                                                 want.to_dict())
