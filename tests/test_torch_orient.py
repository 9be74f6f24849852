"""The orientation-front kernel's plain twin (ops/cuda_orient.py: per crop
crop_resize against its rig's frame, _standardize, ConvBN_0) against the
JAX package, on the CPU at a reduced size (96x128 frames, crops 64 /
width 8, so the folded stem conv gives 8x8):

- against the JAX chain crop_resize -> _standardize -> ConvBN_0 at
  rtol = atol = 1e-4 (the same f32 math in another framework);
- against JAX's fused Pallas kernel orient_front_pallas in interpret mode
  at its own f32 bar of 2e-3 (tests/test_pallas_orient.py), on a strip of
  interior, clamped, tiny and invalid boxes with mixed rig indices;
- invalid crops give exactly relu(t) (1e-5), a sliver crop stays finite
  and bounded (its standardization is ill-conditioned, ROADMAP C), and
  the net with stem_external on ConvBN_0's output equals the full forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.ops import pallas_orient
from grid_vision_tpu.ops import preprocess as jpre
from grid_vision_tpu.types import Boxes as JaxBoxes
from grid_vision_tpu_torch.models import orientation_net, weights
from grid_vision_tpu_torch.ops import cuda_orient

torch.set_num_threads(1)

H, W, SIZE, WIDTH = 96, 128, 64, 8
TOL = dict(rtol=1e-4, atol=1e-4)


def _variables(seed):
    """A JAX init tree with ConvBN_0's BN made non-trivial (random scale,
    bias and statistics), so relu(t) and the folded scale are not 0 / 1."""
    ocfg = jorient.OrientationConfig(width=WIDTH, s2d_fold=True,
                                     compute_dtype=jnp.float32,
                                     input_size=SIZE)
    tree = jax.tree_util.tree_map(
        np.asarray, jorient.init_params(jax.random.PRNGKey(seed), ocfg))
    rng = np.random.default_rng(seed)
    f = 4 * WIDTH
    bn_p = tree["params"]["ConvBN_0"]["BatchNorm_0"]
    bn_s = tree["batch_stats"]["ConvBN_0"]["BatchNorm_0"]
    bn_p["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
    bn_p["bias"] = rng.normal(0, 0.5, f).astype(np.float32)
    bn_s["mean"] = rng.normal(0, 0.3, f).astype(np.float32)
    bn_s["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
    model = orientation_net.OrientationNetS2D(orientation_net.OrientationConfig(
        input_size=SIZE, width=WIDTH))
    weights.load_module(model, tree)
    return tree, model.eval()


def _images(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 255, (n, H, W, 3)).astype(np.float32)


def _strip(seed=1):
    """Interior boxes, a box clamped at the origin, one clamped at the far
    edge, a tiny heavily upscaled box, and one invalid slot; rigs mixed."""
    rng = np.random.default_rng(seed)
    n = 6
    xy = rng.uniform(0, 1, (n, 2)) * [W - 20, H - 20]
    wh = rng.uniform(10, 60, (n, 2))
    xyxy = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    xyxy[0] = [-10.0, -6.0, 50.0, 40.0]
    xyxy[1] = [100.0, 60.0, 150.0, 110.0]
    xyxy[2] = [20.2, 20.7, 26.4, 25.1]
    valid = np.ones(n, bool)
    valid[-1] = False
    rig = np.array([0, 1, 2, 0, 1, 2], np.int32)
    return xyxy, valid, rig


def _port(images, xyxy, valid, rig, model):
    consts = cuda_orient.prepare_orient_constants(model)
    with torch.no_grad():
        return cuda_orient.orient_front_cuda(
            torch.as_tensor(images), torch.as_tensor(xyxy),
            torch.as_tensor(valid), torch.as_tensor(rig), model, consts,
            SIZE).numpy()


def _jax_chain(tree, images, xyxy, valid, rig):
    """The JAX package's XLA chain, crop by crop (tests/test_pallas_orient
    _ref_front)."""
    conv = jorient.ConvBN(4 * WIDTH, stride=2, dtype=jnp.float32,
                          s2d_fold=4)
    sub = {"params": tree["params"]["ConvBN_0"],
           "batch_stats": tree["batch_stats"]["ConvBN_0"]}
    out = []
    for i in range(xyxy.shape[0]):
        one = JaxBoxes(xyxy=jnp.asarray(xyxy[i:i + 1]),
                       confidence=jnp.ones(1), label=jnp.zeros(1, jnp.int32),
                       valid=jnp.asarray(valid[i:i + 1]))
        crops = jpre.crop_resize(jnp.asarray(images[rig[i]]), one, SIZE,
                                 compute_dtype=jnp.float32,
                                 out_dtype=jnp.float32)
        std = jpre._standardize(crops, one.valid, out_dtype=jnp.float32)
        out.append(np.asarray(conv.apply(sub, std, False)))
    return np.concatenate(out)


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_jax_chain(seed):
    tree, model = _variables(seed)
    images = _images(seed=seed)
    xyxy, valid, rig = _strip(seed + 1)
    got = _port(images, xyxy, valid, rig, model)
    assert got.shape == (6, SIZE // 8, SIZE // 8, 4 * WIDTH)
    np.testing.assert_allclose(got, _jax_chain(tree, images, xyxy, valid,
                                               rig), **TOL)


def test_twin_matches_jax_pallas_kernel():
    tree, model = _variables(2)
    images = _images(seed=2)
    xyxy, valid, rig = _strip(3)
    consts = pallas_orient.prepare_orient_constants(tree, SIZE, WIDTH)
    ref = np.asarray(pallas_orient.orient_front_pallas(
        jnp.asarray(images), jnp.asarray(xyxy), jnp.asarray(valid),
        jnp.asarray(rig), consts, SIZE, jnp.float32))
    got = _port(images, xyxy, valid, rig, model)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_invalid_crops_give_relu_t():
    _, model = _variables(4)
    xyxy, _, rig = _strip(5)
    valid = np.zeros(6, bool)
    got = _port(_images(seed=4), xyxy, valid, rig, model)
    t = cuda_orient.prepare_orient_constants(model)["t"].numpy()
    np.testing.assert_allclose(
        got, np.broadcast_to(np.maximum(t, 0.0), got.shape),
        rtol=1e-5, atol=1e-5)


def test_sliver_crop_finite_and_bounded():
    """A sub-pixel box samples one source pixel: its variance is rounding
    noise, so only finiteness and the 1e-6 clamp's bound can hold."""
    _, model = _variables(6)
    xyxy = np.array([[40.0, 40.0, 40.4, 40.4]], np.float32)
    got = _port(_images(1, seed=6), xyxy, np.ones(1, bool),
                np.zeros(1, np.int32), model)
    assert np.isfinite(got).all()
    assert np.abs(got).max() < 1e4


def test_stem_external_matches_full_forward():
    _, model = _variables(7)
    rng = np.random.default_rng(7)
    crops = torch.as_tensor(rng.normal(0, 1, (4, SIZE, SIZE, 3))
                            .astype(np.float32))
    with torch.no_grad():
        ref = orientation_net.forward(model, crops)
        stem = model.ConvBN_0(crops.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = orientation_net.forward(model, stem, stem_external=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
