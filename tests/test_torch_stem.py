"""The stem kernel's plain twin (ops/cuda_stem.py: resize matmuls, then
F.conv2d with folded BN) against the JAX package's fused Pallas stem kernel
(interpret mode on the CPU) in f32, atol = rtol = 1e-4 (the JAX tests'
own bar for that kernel, tests/test_pallas_stem.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu.ops import pallas_stem
from grid_vision_tpu_torch.models import weights, yolov4_tiny
from grid_vision_tpu_torch.ops import cuda_stem
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)


def _run_both(variables, frames, size):
    ref = np.asarray(pallas_stem.detector_stem_pallas(
        jnp.asarray(frames), variables, size, jnp.float32))
    det = yolov4_tiny.YoloV4Tiny(yolov4_tiny.YoloConfig(input_size=size))
    weights.load_module(det, jax.tree_util.tree_map(np.asarray, variables))
    consts = cuda_stem.prepare_stem_constants(det)
    got = cuda_stem.detector_stem_cuda(torch.as_tensor(frames), consts, size)
    return got.numpy(), ref


@pytest.mark.parametrize("seed", [0, 1])
def test_small_frame_random_weights(seed):
    variables = jyolo.init_params(jax.random.PRNGKey(seed),
                                  jyolo.YoloConfig(input_size=64,
                                                   compute_dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    got, ref = _run_both(variables, frames, 64)
    assert got.shape == ref.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_full_frame_shipped_weights():
    variables = checkpoint.load_npz_tree("weights/detector.npz")
    rng = np.random.default_rng(2)
    frames = rng.uniform(0, 255, (1, 480, 640, 3)).astype(np.float32)
    got, ref = _run_both(variables, frames, 416)
    assert got.shape == ref.shape == (1, 104, 104, 64)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_resize_taps_reproduce_the_dense_weights():
    """The kernel's compact tap tables hold exactly the nonzero weights of
    the dense resize matrices (the kernel reads only those)."""
    for n_in, size in ((480, 416), (640, 416), (96, 64), (128, 64),
                       (100, 68)):
        dense = cuda_stem._axis_resize_weights(n_in, size)
        start, w = cuda_stem.resize_taps(n_in, size)
        rebuilt = np.zeros_like(dense)
        for j in range(size):
            rebuilt[j, start[j]:start[j] + w.shape[1]] = w[j]
        np.testing.assert_array_equal(rebuilt, dense)
        assert (start >= 0).all() and (start + w.shape[1] <= n_in).all()
