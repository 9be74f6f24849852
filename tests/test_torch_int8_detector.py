"""The int8 detector (models/yolov4_int8.py) against the JAX package's, on
the CPU, at detector input 96 with the shipped weights (weights/
detector.npz: trained BatchNorm statistics, so the fold is not trivial).

- quantize_detector: wq and sw bit-equal to JAX's, b and the float heads
  equal; qparams_from_jax carries JAX's output into the same tensors.
- _qconv per layer (3x3/s2 on 3 channels, K = 27 padded; 3x3/s2; 3x3/s1;
  1x1): the int8 activation, the int32 accumulator and the f32 output
  bit-equal to jax.jit(_qconv). Jitted XLA fuses the requant y * (sx * sw)
  + b into one multiply-add; the eager JAX call rounds the product first,
  so it is not the port's form (it differs in the last bit).
- forward_int8 and forward_int8_static against jax.jit of JAX's, boxes and
  confidences to 1e-6: every quantized layer is bit-equal, only the float
  1x1 heads sum in another order. calibrate_scales: the 19 sites, scales
  to rtol 1e-6 of the JAX recorder over jitted _qconv calls, 1e-3 of JAX's
  own calibrate_scales (eager calls, a rounding apart, see the test).
- the JAX package's quality bars (tests/test_int8_detector.py) on the
  port's own float path at this size: mean |dbox| < 5e-3, mean |dconf| <
  1e-2, confident-anchor counts within max(10, n / 20), static scales
  against dynamic at the same bars, mAP@0.5 within 0.03.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import yolov4_int8 as jint8
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights, yolov4_int8, yolov4_tiny
from grid_vision_tpu_torch.train.eval_map import evaluate_detector
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

REPO = __file__.rsplit("/tests/", 1)[0]
SIZE = 96
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def nets():
    tree = checkpoint.load_npz_tree(f"{REPO}/weights/detector.npz")
    det = weights.load_module(yolov4_tiny.YoloV4Tiny(
        yolov4_tiny.YoloConfig(input_size=SIZE)), tree).eval()
    return tree, det, jint8.quantize_detector(tree), \
        yolov4_int8.quantize_detector(det)


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_quantize_detector_bit_equal(nets):
    _, _, qj, qp = nets
    assert set(qj) == set(yolov4_int8.LAYERS) | set(yolov4_int8.HEADS)
    carried = yolov4_int8.qparams_from_jax(qj)
    for name in yolov4_int8.LAYERS:
        np.testing.assert_array_equal(
            qp[name]["wq"].numpy(),
            np.asarray(qj[name]["wq"]).transpose(3, 2, 0, 1), err_msg=name)
        assert qp[name]["wq"].dtype == torch.int8
        for k in ("sw", "b"):
            np.testing.assert_array_equal(qp[name][k].numpy(),
                                          np.asarray(qj[name][k]),
                                          err_msg=f"{name} {k}")
        for k in ("wq", "sw", "b", "wt"):
            assert torch.equal(carried[name][k], qp[name][k]), (name, k)
        assert qp[name]["wt"].shape[1] % 8 == 0
    for head in yolov4_int8.HEADS:
        np.testing.assert_array_equal(
            qp[head]["w"].numpy(),
            np.asarray(qj[head]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(qp[head]["b"].numpy(),
                                      np.asarray(qj[head]["b"]))


@pytest.mark.parametrize("name,stride,cin", [
    ("ConvBN_0", 2, 3), ("ConvBN_1", 2, 32), ("ConvBN_2", 1, 64),
    ("CSPBlock_0/ConvBN_2", 1, 64), ("ConvBN_6", 1, 512)])
def test_qconv_bit_equal_to_jitted_jax(nets, name, stride, cin):
    _, _, qj, qp = nets
    rng = np.random.default_rng(cin)
    x = (rng.normal(size=(2, 18, 14, cin)) * 3).astype(np.float32)
    xt = torch.tensor(x)
    layer = qj[name]

    @jax.jit
    def jparts(x):
        sx = jnp.maximum(jnp.max(jnp.abs(x), axis=(1, 2, 3), keepdims=True)
                         / 127.0, 1e-12)
        xq = jnp.clip(jnp.round(x / sx), -127, 127).astype(jnp.int8)
        acc = jax.lax.conv_general_dilated(
            xq, layer["wq"], (stride, stride), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
        return sx, xq, acc

    sx, xq, acc = (np.asarray(a) for a in jparts(jnp.asarray(x)))
    psx = yolov4_int8.act_scale(xt)
    pxq = yolov4_int8.quantize_act(xt, psx)
    pacc = yolov4_int8.int8_conv(pxq, qp[name], stride)
    np.testing.assert_array_equal(psx.numpy(), sx)
    np.testing.assert_array_equal(pxq.numpy(), xq)
    assert pacc.dtype == torch.int32
    np.testing.assert_array_equal(pacc.numpy(), acc)
    # the tap matrix the card multiplies, times the GEMM weights, in f64
    a = yolov4_int8.tap_matrix(pxq, qp[name]["wq"].shape[-1], stride,
                               qp[name]["wt"].shape[1])
    gemm = (a.double() @ qp[name]["wt"].t().double()).reshape(pacc.shape)
    assert torch.equal(gemm.to(torch.int32), pacc)
    # torch._int_mm in the card's call form (this torch has a CPU _int_mm)
    assert torch.equal(torch._int_mm(a, qp[name]["wt"].t()).reshape(
        pacc.shape), pacc)
    want = np.asarray(jax.jit(lambda x: jint8._qconv(x, layer, stride))(
        jnp.asarray(x)))
    got = yolov4_int8._qconv(xt, qp[name], stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_forward_static_and_calibration_match_jax(nets):
    _, _, qj, qp = nets
    jcfg = jyolo.YoloConfig(input_size=SIZE)
    pcfg = yolov4_tiny.YoloConfig(input_size=SIZE)
    img = _images(0)
    want = jax.jit(lambda q, x: jint8.forward_int8(q, x, jcfg))(
        qj, jnp.asarray(img))
    got = yolov4_int8.forward_int8(qp, torch.tensor(img), pcfg)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    calib = [_images(1), _images(2)]
    sj = jint8.calibrate_scales(qj, [jnp.asarray(c) for c in calib], jcfg)
    sp = yolov4_int8.calibrate_scales(qp, [torch.tensor(c) for c in calib],
                                      pcfg)
    assert set(sp) == set(sj) == set(yolov4_int8.LAYERS)
    # JAX's calibrate_scales records through eager _qconv calls, whose
    # requant and 1/127 round apart from the jitted form (a few int8 codes
    # flip downstream): the same recorder over jitted _qconv calls is the
    # port's arithmetic, held to 1e-6; the eager one to 1e-3
    jitted = jax.jit(jint8._qconv, static_argnums=2)
    maxes = {}

    def record(x, site, layer, stride):
        maxes[site] = max(maxes.get(site, 0.0), float(jnp.max(jnp.abs(x))))
        return jitted(x, layer, stride)

    for c in calib:
        jint8._topology(qj, jnp.asarray(c), jcfg, record)
    for site in sj:
        np.testing.assert_allclose(float(sp[site]),
                                   np.float32(maxes[site] / 127.0),
                                   rtol=1e-6, err_msg=site)
        np.testing.assert_allclose(float(sp[site]), float(sj[site]),
                                   rtol=1e-3, err_msg=site)
    # both static forwards on the JAX scales
    sj_t = {k: torch.tensor(np.asarray(v)) for k, v in sj.items()}
    want = jax.jit(lambda q, s, x: jint8.forward_int8_static(q, s, x, jcfg))(
        qj, sj, jnp.asarray(img))
    got = yolov4_int8.forward_int8_static(qp, sj_t, torch.tensor(img), pcfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _close_to(boxes, confs, ref_boxes, ref_confs):
    assert float((boxes - ref_boxes).abs().mean()) < 5e-3
    assert float((confs - ref_confs).abs().mean()) < 1e-2
    n_f = int((ref_confs > 0.5).sum())
    n_i = int((confs > 0.5).sum())
    assert abs(n_f - n_i) <= max(10, n_f // 20), (n_f, n_i)


def test_quality_bars_against_the_float_path(nets):
    _, det, _, qp = nets
    pcfg = yolov4_tiny.YoloConfig(input_size=SIZE)
    img = torch.tensor(_images(3))
    bf, cf = yolov4_tiny.forward(det, img)
    bi, ci = yolov4_int8.forward_int8(qp, img, pcfg)
    _close_to(bi, ci, bf, cf)
    scales = yolov4_int8.calibrate_scales(
        qp, [torch.tensor(_images(4)), torch.tensor(_images(5))], pcfg)
    bs, cs = yolov4_int8.forward_int8_static(qp, scales, img, pcfg)
    _close_to(bs, cs, bi, ci)


def test_int8_map_within_float():
    cfg_f = GridVisionConfig(detection_weights_file="/weights/detector.npz",
                             detection_network_input_size=SIZE)
    params = weights.load_all(cfg_f, base_dir=REPO, device="cpu")
    cfg_i = dataclasses.replace(cfg_f, detector_precision="int8",
                                compat=False)
    r_f = evaluate_detector(params, cfg_f, n_images=8, source="synth")
    r_i = evaluate_detector(params, cfg_i, n_images=8, source="synth")
    assert r_f.map50 > 0.1
    assert r_i.map50 >= r_f.map50 - 0.03, (r_f.map50, r_i.map50)


def test_load_all_quantizes():
    cfg = GridVisionConfig(detection_weights_file="/weights/detector.npz",
                           detection_network_input_size=SIZE,
                           detector_precision="int8", compat=False)
    params = weights.load_all(cfg, base_dir=REPO, device="cpu")
    q = yolov4_int8.quantize_detector(params["detector"])
    assert set(params["detector_q"]) == set(q)
    for name in yolov4_int8.LAYERS:
        assert torch.equal(params["detector_q"][name]["wq"], q[name]["wq"])
