"""The port's nets and their post-processing against the JAX package, on
the same inputs and the same weights (params_from_jax):

- YOLOv4-tiny forward (full net and stem_external) and decode: 1e-4;
- the s2d orientation net (folded stem, ladder, MultiBin heads): 1e-4;
- extract_boxes / greedy NMS: the same boxes in the same order, exactly
  (stable sorts stand in for lax.top_k / argsort, ties included);
- multibin_poses: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.ops import decode as jdecode
from grid_vision_tpu.ops import multibin as jmultibin
from grid_vision_tpu.ops import nms as jnms
from grid_vision_tpu.ops import preprocess as jpre
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import orientation_net, weights, yolov4_tiny
from grid_vision_tpu_torch.ops import decode, multibin, nms, preprocess
from grid_vision_tpu_torch.types import Boxes

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module")
def yolo_pair():
    jcfg = jyolo.YoloConfig(input_size=64, compute_dtype=jnp.float32)
    variables = jyolo.init_params(jax.random.PRNGKey(0), jcfg)
    model = yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig(input_size=64))
    weights.load_module(model, _np_tree(variables))
    return variables, jcfg, model.eval()


def test_yolo_forward_matches_flax(yolo_pair):
    variables, jcfg, model = yolo_pair
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jb, jc = jyolo.forward(variables, jnp.asarray(x), jcfg)
    with torch.no_grad():
        tb, tc = yolov4_tiny.forward(model, torch.as_tensor(x))
    assert tb.shape == (2, jcfg.num_anchors_total, 4)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_yolo_stem_external_matches_flax(yolo_pair):
    variables, jcfg, model = yolo_pair
    ext = jyolo.YoloConfig(input_size=64, compute_dtype=jnp.float32,
                           stem_external=True)
    x = np.random.default_rng(1).normal(0, 1, (1, 16, 16, 64)).astype(
        np.float32)
    jb, jc = jyolo.forward(variables, jnp.asarray(x), ext)
    with torch.no_grad():
        tb, tc = yolov4_tiny.forward(model, torch.as_tensor(x),
                                     stem_external=True)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_detector_resize_matches_jax():
    img = np.random.default_rng(2).uniform(0, 255, (96, 128, 3)).astype(
        np.float32)
    ref = np.asarray(jpre.preprocess_detector_image(jnp.asarray(img), 64))
    got = preprocess.preprocess_detector_image(torch.as_tensor(img), 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("size,width", [(32, 8), (64, 8)])
def test_orientation_net_matches_flax(size, width):
    jcfg = jorient.OrientationConfig(input_size=size, width=width,
                                     s2d_fold=True,
                                     compute_dtype=jnp.float32)
    variables = jorient.init_params(jax.random.PRNGKey(size), jcfg)
    model = orientation_net.OrientationNetS2D(
        orientation_net.OrientationConfig(input_size=size, width=width))
    weights.load_module(model, _np_tree(variables))
    x = np.random.default_rng(3).normal(0, 1, (3, size, size, 3)).astype(
        np.float32)
    ref = jorient.forward(variables, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = orientation_net.forward(model.eval(), torch.as_tensor(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def _boxes_both(xyxy, conf, label, valid):
    j = JaxBoxes(xyxy=jnp.asarray(xyxy), confidence=jnp.asarray(conf),
                 label=jnp.asarray(label), valid=jnp.asarray(valid))
    t = Boxes(xyxy=torch.as_tensor(xyxy), confidence=torch.as_tensor(conf),
              label=torch.as_tensor(label), valid=torch.as_tensor(valid))
    return j, t


@pytest.mark.parametrize("seed,max_candidates,quantize", [
    (0, 256, False), (1, 64, False), (2, 256, True), (3, 64, True)])
def test_extract_boxes_same_boxes_same_order(seed, max_candidates,
                                             quantize):
    """Dense overlapping candidates; quantize=True makes many equal
    confidences and identical boxes (ties everywhere)."""
    rng = np.random.default_rng(seed)
    n = 2535
    cxy = rng.uniform(0.1, 0.9, (n, 2))
    wh = rng.uniform(0.02, 0.3, (n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    confs = rng.uniform(0, 1, (n, 10)) ** 3
    if quantize:
        boxes = np.round(boxes * 8) / 8
        confs = np.round(confs * 10) / 10
    boxes, confs = boxes.astype(np.float32), confs.astype(np.float32)
    kw = dict(max_candidates=max_candidates, confidence_threshold=0.3)
    jb, jo = jdecode.extract_boxes(jnp.asarray(boxes), jnp.asarray(confs),
                                   JaxConfig(**kw), with_overflow=True)
    tb, to = decode.extract_boxes(torch.as_tensor(boxes),
                                  torch.as_tensor(confs),
                                  GridVisionConfig(**kw), with_overflow=True)
    assert int(to) == int(jo)
    assert tb.valid.sum() > 1
    for f in ("xyxy", "confidence", "label", "valid"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_nms_keep_matches(seed):
    rng = np.random.default_rng(seed)
    n = 256
    cxy = rng.uniform(0.3, 0.7, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    xyxy = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    conf = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.8
    jo, jk = jnms.greedy_nms_keep(jnp.asarray(xyxy), jnp.asarray(conf),
                                  jnp.asarray(valid), 0.6)
    to, tk = nms.greedy_nms_keep(torch.as_tensor(xyxy),
                                 torch.as_tensor(conf),
                                 torch.as_tensor(valid), 0.6)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multibin_poses_match(seed):
    rng = np.random.default_rng(seed)
    n = 8
    orient = rng.normal(0, 1, (n, 2, 2)).astype(np.float32)
    orient /= np.linalg.norm(orient, axis=-1, keepdims=True)
    conf = rng.normal(0, 1, (n, 2)).astype(np.float32)
    dims = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    x0 = rng.uniform(0, 560, n)
    y0 = rng.uniform(100, 380, n)
    xyxy = np.trunc(np.stack([x0, y0, x0 + rng.uniform(8, 80, n),
                              y0 + rng.uniform(8, 100, n)], -1)).astype(
        np.float32)
    label = rng.choice([0, 1, 2, 9, 5], n).astype(np.int32)
    valid = rng.uniform(0, 1, n) < 0.8
    jb, tb = _boxes_both(xyxy, np.ones(n, np.float32), label, valid)
    K = np.array([[320.0, 0, 320.0], [0, 320.0, 240.0], [0, 0, 1]],
                 np.float32)
    ref = jmultibin.multibin_poses(jnp.asarray(orient), jnp.asarray(conf),
                                   jnp.asarray(dims), jb, jnp.asarray(K),
                                   JaxConfig())
    got = multibin.multibin_poses(torch.as_tensor(orient),
                                  torch.as_tensor(conf),
                                  torch.as_tensor(dims), tb,
                                  torch.as_tensor(K), GridVisionConfig())
    for f in ("position", "quat", "length", "width", "height"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), **TOL,
                                   err_msg=f)
    for f in ("label", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_resize_standardize_matches(seed):
    """Crops with truncated / clamped corners, partly off-image and tiny
    boxes, invalid slots -> 0; atol 1e-4 on unit-variance output. (A
    flat crop, e.g. a 1-pixel box, is left out: its ~0 std turns the
    rounding of the mean into O(1) output in both packages alike.)"""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    xyxy = np.array([[10.7, 5.2, 60.9, 70.1], [-20, -10, 30, 25],
                     [100, 60, 200, 140], [50, 40, 53, 43],
                     [0, 0, 0, 0]], np.float32)
    valid = np.array([1, 1, 1, 1, 0], bool)
    n = len(xyxy)
    jb, tb = _boxes_both(xyxy, np.ones(n, np.float32),
                         np.full(n, 9, np.int32), valid)
    ref = jpre.crop_resize_standardize(jnp.asarray(img), jb, 32,
                                       compute_dtype=jnp.float32)
    got = preprocess.crop_resize_standardize(torch.as_tensor(img), tb, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
