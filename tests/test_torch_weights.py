"""Weights move from flax trees to the torch modules leaf for leaf: the
shipped weights/*.npz load strictly, and every flax leaf lands in the
module tensor of the same path (HWIO -> OIHW, Dense (in, out) -> (out, in),
BatchNorm scale / stats -> weight / running buffers)."""

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

SHIPPED = dict(detection_weights_file="weights/detector.npz",
               vision_weights_file="weights/orientation.npz")


def _expected(path, arr):
    """Where a flax leaf must land and what it must hold there."""
    *mods, name = path
    arr = np.asarray(arr, np.float32)
    if name == "kernel":
        name = "weight"
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
    else:
        name = {"scale": "weight", "mean": "running_mean",
                "var": "running_var"}.get(name, name)
    return ".".join([*mods, name]), arr


@pytest.mark.parametrize("key,file", [
    ("detector", "weights/detector.npz"),
    ("orientation", "weights/orientation.npz")])
def test_shipped_npz_round_trip(key, file):
    nets = weights.load_all(GridVisionConfig(**SHIPPED), device="cpu")
    state = nets[key].state_dict()
    flat = dict(np.load(file))
    assert len(flat) == len(state)       # every module tensor is a leaf
    for k, v in flat.items():
        sd_key, arr = _expected(checkpoint.split_key(k)[1:], v)
        got = state[sd_key].numpy()
        assert got.shape == arr.shape, k
        np.testing.assert_array_equal(got, arr, err_msg=k)


def test_npz_tree_round_trip(tmp_path):
    tree = checkpoint.load_npz_tree("weights/orientation.npz")
    p = str(tmp_path / "o.npz")
    checkpoint.save_npz_tree(p, tree)
    a, b = np.load("weights/orientation.npz"), np.load(p)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("size,width,resize", [(32, 8, 64), (64, 8, 64)])
def test_random_jax_trees_load_strictly(size, width, resize):
    """A JAX init tree of a reduced config fits the port's module of the
    same config exactly (names and shapes), ladder depth included."""
    kw = dict(network_height=size, network_width=size,
              orientation_width=width, detection_network_input_size=resize)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jweights.init_all(JaxConfig(**kw), seed=0))
    nets = weights.load_all(GridVisionConfig(**kw), device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])


def test_missing_file_falls_back_to_seeded_init():
    cfg = GridVisionConfig(detection_weights_file="weights/missing.npz")
    a = weights.load_all(cfg, seed=3, device="cpu")["detector"].state_dict()
    b = weights.load_all(cfg, seed=3, device="cpu")["detector"].state_dict()
    c = weights.load_all(cfg, seed=4, device="cpu")["detector"].state_dict()
    k = "ConvBN_5.Conv_0.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
