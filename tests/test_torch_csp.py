"""The CSP-stage kernel's plain twin (ops/cuda_csp.py: the detector's own
ConvBN_2 -> CSPBlock_0 -> max_pool2d) against the JAX package, on the CPU
at a reduced size (a 64-pixel detector input, so the stem output is
16x16x64 and the stage output 8x8x128), rtol = atol = 1e-4 (the JAX
package's own bar for this stage, tests/test_pallas_stem.py):

- against both TPU layouts of the stage, detector_csp_pallas ("pallas2")
  and detector_csp_flat ("pallas3"), in interpret mode;
- the net with front_external on the stage's output against JAX's full
  forward from the frames;
- "pallas2" and "pallas3" both dispatch to the one port function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.ops import pallas_csp
from grid_vision_tpu.ops.preprocess import preprocess_detector_image
from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights, yolov4_tiny
from grid_vision_tpu_torch.ops import cuda_csp, cuda_stem

torch.set_num_threads(1)

SIZE = 64
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomize_bn(tree, rng):
    """Random BN scale / bias / statistics everywhere in a flax tree."""
    for scope, sub in tree["params"].items():
        _randomize_scope(sub, tree["batch_stats"].get(scope), rng)


def _randomize_scope(p, s, rng):
    for name, child in p.items():
        if name == "BatchNorm_0":
            f = child["scale"].shape[0]
            child["scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
            child["bias"] = rng.normal(0, 0.3, f).astype(np.float32)
            s[name]["mean"] = rng.normal(0, 0.3, f).astype(np.float32)
            s[name]["var"] = rng.uniform(0.5, 2.0, f).astype(np.float32)
        elif isinstance(child, dict) and s is not None and name in s:
            _randomize_scope(child, s[name], rng)


def _detector(seed):
    cfg = jyolo.YoloConfig(input_size=SIZE, compute_dtype=jnp.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, jyolo.init_params(jax.random.PRNGKey(seed), cfg))
    _randomize_bn(tree, np.random.default_rng(seed))
    det = yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig(input_size=SIZE))
    weights.load_module(det, tree)
    return tree, det.eval()


@pytest.mark.parametrize("seed", [0, 1])
def test_twin_matches_both_jax_layouts(seed):
    tree, det = _detector(seed)
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, SIZE // 4, SIZE // 4, 64)).astype(np.float32)
    with torch.no_grad():
        got = cuda_csp.detector_csp_cuda(
            torch.as_tensor(x), det, cuda_csp.prepare_csp_constants(det))
    got = got.numpy()
    assert got.shape == (2, SIZE // 8, SIZE // 8, 128)
    for fn in (pallas_csp.detector_csp_pallas, pallas_csp.detector_csp_flat):
        ref = np.asarray(fn(jnp.asarray(x), tree, jnp.float32))
        np.testing.assert_allclose(got, ref, **TOL, err_msg=fn.__name__)


def test_front_external_matches_jax_full_forward():
    tree, det = _detector(2)
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    net_in = jax.vmap(lambda im: preprocess_detector_image(
        im, SIZE, compute_dtype=jnp.float32))(jnp.asarray(frames))
    b_ref, c_ref = jyolo.forward(
        tree, net_in, jyolo.YoloConfig(input_size=SIZE,
                                       compute_dtype=jnp.float32))
    with torch.no_grad():
        stem = cuda_stem.detector_stem_cuda(
            torch.as_tensor(frames), cuda_stem.prepare_stem_constants(det),
            SIZE)
        stage3 = cuda_csp.detector_csp_cuda(
            stem, det, cuda_csp.prepare_csp_constants(det))
        b, c = yolov4_tiny.forward(det, stage3, front_external=True)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), **TOL)


def test_pallas2_and_pallas3_dispatch_to_one_function(monkeypatch):
    _, det = _detector(3)
    calls = []
    plain = cuda_csp.detector_csp_cuda

    def recording(x, detector, consts):
        calls.append(x.shape)
        return plain(x, detector, consts)

    monkeypatch.setattr(cuda_csp, "detector_csp_cuda", recording)
    rng = np.random.default_rng(3)
    frames = torch.as_tensor(rng.uniform(0, 255, (2, 96, 128, 3))
                             .astype(np.float32))
    outs = []
    for backend in ("pallas2", "pallas3"):
        cfg = GridVisionConfig(camera_image_height=96, camera_image_width=128,
                               detection_network_input_size=SIZE,
                               detector_stem_backend=backend)
        eng = pipeline.Engine(cfg, params={"detector": det,
                                           "orientation": None},
                              device="cpu")
        assert set(eng.params["detector_csp"]) == set(cuda_csp._SHAPES)
        with torch.no_grad():
            outs.append(pipeline._detector_forward(eng.params, frames, cfg))
    assert calls == [(2, SIZE // 4, SIZE // 4, 64)] * 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)
