"""The bf16 preprocessing and layers of the port against the JAX package on
the CPU (compute_dtype=bfloat16):

- crop_resize / _standardize / crop_resize_standardize at bf16 against
  JAX's: mean |d| < 0.02 and max < 0.3 (tests/test_preprocess.py:56-71's
  bar), and bit for bit where the arithmetic is the same (the crops, the
  detector resize);
- the single-pass branch itself: its statistics against the f32 two-pass
  ones of the same bf16 crops, and its normalize rounded where JAX's is;
- the bf16 layers (f32 conv sums into flax's BatchNorm, rounded once;
  the bf16 leaky slope; the head bias in bf16) against the flax modules as
  XLA compiles them (jit, where a bf16 rounding between two f32 ops is
  dropped), bit for bit on the first layers but where the two frameworks'
  f32 sums of a conv round a bf16 output the other way (< 0.1 %), and at
  the bf16 bar on the net's outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.ops import preprocess as jpre
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.models import orientation_net, yolov4_tiny
from grid_vision_tpu_torch.ops import preprocess
from grid_vision_tpu_torch.types import Boxes

from . import test_torch_csp as csp_case
from . import test_torch_orient as orient_case

torch.set_num_threads(1)

BF = torch.bfloat16
BOXES = np.array([[200, 100, 400, 300], [0, 0, 100, 100], [630, 400, 700, 500],
                  [10, 10, 10.4, 10.4]], np.float32)


def _image(seed, h=480, w=640):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3)).astype(np.float32)


def _boxes(valid):
    n = len(BOXES)
    return (JaxBoxes(xyxy=jnp.asarray(BOXES), confidence=jnp.ones(n),
                     label=jnp.zeros(n, jnp.int32), valid=jnp.asarray(valid)),
            Boxes(xyxy=torch.as_tensor(BOXES), confidence=torch.ones(n),
                  label=torch.zeros(n, dtype=torch.int32),
                  valid=torch.as_tensor(valid)))


def _np(x):
    return np.asarray(x.astype(jnp.float32)) if hasattr(x, "astype") and \
        not isinstance(x, torch.Tensor) else x.float().numpy()


def _nearly_equal(got, ref):
    """Bit-equal on >= 99.9 % of the elements, the rest one bf16 step."""
    d = np.abs(got - ref)
    assert (d == 0).mean() >= 0.999, (d == 0).mean()
    assert (d <= 2.0 ** -7 * np.maximum(np.abs(ref), 1e-30) * 2).all()


@pytest.mark.parametrize("size", [224, 64])
def test_crop_resize_standardize_bf16_matches_jax(size):
    img = _image(8)
    jb, tb = _boxes(np.array([True, True, True, False]))
    ref = jpre.crop_resize_standardize(jnp.asarray(img), jb, size,
                                       compute_dtype=jnp.bfloat16)
    got = preprocess.crop_resize_standardize(torch.as_tensor(img), tb, size,
                                             compute_dtype=BF)
    assert got.dtype == BF and ref.dtype == jnp.bfloat16
    d = np.abs(_np(got) - _np(ref))
    assert d.mean() < 0.02 and d.max() < 0.3, (d.mean(), d.max())
    # the crops themselves are the same bf16 arithmetic
    crops_j = jpre.crop_resize(jnp.asarray(img), jb, size, jnp.bfloat16,
                               out_dtype=jnp.bfloat16)
    crops_t = preprocess.crop_resize(torch.as_tensor(img), tb, size, BF,
                                     out_dtype=BF)
    np.testing.assert_array_equal(_np(crops_t), _np(crops_j))
    assert not got[3].float().any()                    # invalid -> 0


def test_standardize_bf16_single_pass_branch():
    """The bf16 branch: single-pass f32 moments (against the two-pass
    statistics of the same crops), the normalize in bf16 with the mean and
    1 / std rounded to bf16, invalid crops 0, out_dtype honoured; and the
    same result as JAX's branch on the same bf16 crops."""
    img = _image(9)
    jb, tb = _boxes(np.array([True, True, True, True]))
    crops = preprocess.crop_resize(torch.as_tensor(img), tb, 224, BF,
                                   out_dtype=BF)
    mean, inv = preprocess.single_pass_stats(crops)
    x = crops.float()
    two_mean = x.mean(dim=(1, 2), keepdim=True)
    two_std = ((x - two_mean) ** 2).mean(dim=(1, 2), keepdim=True).sqrt()
    torch.testing.assert_close(mean, two_mean, rtol=1e-6, atol=0)
    ok = two_std > 1.0                     # the sliver crop is flat
    torch.testing.assert_close(inv[ok], 1.0 / two_std[ok], rtol=1e-4,
                               atol=0)
    valid = torch.tensor([True, False, True, True])
    out = preprocess._standardize(crops, valid)
    assert out.dtype == BF
    want = ((crops - mean.to(BF)) * inv.to(BF))
    assert torch.equal(out[valid], want[valid])
    assert not out[1].float().any()
    assert preprocess._standardize(crops, valid,
                                   out_dtype=torch.float32).dtype == \
        torch.float32
    ref = jpre._standardize(jnp.asarray(crops.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(valid.numpy()))
    d = np.abs(out.float().numpy() - _np(ref))
    assert d.mean() < 0.02 and d.max() < 0.3, (d.mean(), d.max())
    assert (d == 0).mean() >= 0.99


def test_detector_resize_bf16_is_bit_equal():
    img = _image(10)
    ref = jpre.preprocess_detector_image(jnp.asarray(img), 416,
                                         compute_dtype=jnp.bfloat16)
    got = preprocess.preprocess_detector_image(torch.as_tensor(img), 416, BF)
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), _np(ref))


def test_detector_bf16_layers_match_flax():
    """The port's bf16 detector against flax's (compute_dtype=bf16): the
    stem layers bit for bit but for sum-order flips, the heads (f32) at
    the bf16 bar."""
    tree, det = csp_case._detector(4)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    model = jyolo.YoloV4Tiny(jyolo.YoloConfig(input_size=64,
                                              compute_dtype=jnp.bfloat16))
    (h1, h2), st = jax.jit(lambda v, x: model.apply(
        v, x, train=False, capture_intermediates=True,
        mutable=["intermediates"]))(tree, xb)
    inter = st["intermediates"]
    with torch.no_grad():
        y = torch.as_tensor(x).to(BF).permute(0, 3, 1, 2)
        for name in ("ConvBN_0", "ConvBN_1"):
            y = getattr(det, name)(y)
            _nearly_equal(y.permute(0, 2, 3, 1).float().numpy(),
                          _np(inter[name]["__call__"][0]))
        t1, t2 = det(torch.as_tensor(x).to(BF))
    for a, b in ((t1, h1), (t2, h2)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.06,
                                   atol=0.06)


def test_orientation_net_bf16_matches_flax():
    """The port's bf16 orientation net (the folded s2d stem, the ladder,
    the pool rounded to bf16, f32 heads) against flax's at the bf16 bar,
    and its stem bit for bit but where the two frameworks' f32 sums of
    432 products round a bf16 output the other way (< 0.1 %)."""
    tree, model = orient_case._variables(5)
    rng = np.random.default_rng(5)
    crops = rng.normal(0, 1, (3, 64, 64, 3)).astype(np.float32)
    ocfg = jorient.OrientationConfig(input_size=64, width=orient_case.WIDTH,
                                     s2d_fold=True,
                                     compute_dtype=jnp.bfloat16)
    ref = jax.jit(lambda v, x: jorient.forward(v, x, ocfg))(
        tree, jnp.asarray(crops).astype(jnp.bfloat16))
    conv = jorient.ConvBN(4 * orient_case.WIDTH, stride=2,
                          dtype=jnp.bfloat16, s2d_fold=4)
    sub = {"params": tree["params"]["ConvBN_0"],
           "batch_stats": tree["batch_stats"]["ConvBN_0"]}
    stem_ref = jax.jit(lambda v, x: conv.apply(v, x, False))(
        sub, jnp.asarray(crops).astype(jnp.bfloat16))
    with torch.no_grad():
        x = torch.as_tensor(crops).to(BF)
        got = orientation_net.forward(model, x, dtype=BF)
        stem = model.ConvBN_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _nearly_equal(stem.float().numpy(), _np(stem_ref))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.06,
                                   atol=0.06)
