"""flax's init through the port (models/layers.flax_init, the nets'
init_params, weights.init_all) against the JAX package's, leaf by leaf to
1e-6 at small configs (detector input 32; orientation input 32, width 8):
the same rng tree (a parameter's key folded with its module path and
counter, flax's LazyRng), lecun-normal kernels, zero biases, identity
BatchNorm. load_all's random branch is init_all's (gap C-g3), and
save_all's files are the JAX package's format both ways."""

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import orientation_net as jorient
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.models import yolov4_tiny as jyolo
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import orientation_net, weights, yolov4_tiny
from grid_vision_tpu_torch.utils import checkpoint, prng

torch.set_num_threads(1)

SMALL = dict(detection_network_input_size=32, network_height=32,
             network_width=32, orientation_width=8)


def _flat(tree):
    return checkpoint.tree_to_flat(jax.tree_util.tree_map(np.asarray, tree))


def _assert_trees_close(got, want, atol=1e-6):
    got, want = checkpoint.tree_to_flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_detector_init_params_leaf_by_leaf(seed):
    jtree = jyolo.init_params(jax.random.PRNGKey(seed),
                              jyolo.YoloConfig(input_size=32))
    net = yolov4_tiny.init_params(prng.prng_key(seed),
                                  yolov4_tiny.YoloConfig(input_size=32))
    _assert_trees_close(weights.flax_tree(net), jtree)


@pytest.mark.parametrize("fold", [False, True])
def test_orientation_init_params_leaf_by_leaf(fold):
    """The unfolded s2d stem (the trainer's) and the folded one (the
    server's) hold the same tree."""
    jtree = jorient.init_params(jax.random.PRNGKey(1), jorient.
                                OrientationConfig(input_size=32, width=8,
                                                  s2d_fold=fold))
    net = orientation_net.init_params(
        prng.prng_key(1), orientation_net.OrientationConfig(
            input_size=32, width=8, s2d_fold=fold))
    _assert_trees_close(weights.flax_tree(net), jtree)


def test_init_all_and_the_random_branch_of_load_all():
    """weights.init_all equals the JAX package's init_all; load_all with no
    file configured (or a missing one) gives exactly init_all's nets:
    gap C-g3 closed."""
    jtrees = jweights.init_all(JaxConfig(**SMALL), seed=3)
    nets = weights.init_all(GridVisionConfig(**SMALL), seed=3, device="cpu")
    for key in ("detector", "orientation"):
        _assert_trees_close(weights.flax_tree(nets[key]), jtrees[key])
        assert not nets[key].training
    loaded = weights.load_all(GridVisionConfig(
        **SMALL, vision_weights_file="weights/absent.npz"), seed=3,
        device="cpu")
    for key in ("detector", "orientation"):
        a, b = loaded[key].state_dict(), nets[key].state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (key, k)


def test_save_all_round_trips_between_packages(tmp_path):
    """save_all writes flat npz files the JAX package's load_all restores
    key for key, and the port's load_all reads the JAX package's
    save_all."""
    cfg_kw = dict(SMALL, detection_weights_file="/out/det.npz",
                  vision_weights_file="/out/orient")
    nets = weights.init_all(GridVisionConfig(**SMALL), seed=5, device="cpu")
    weights.save_all(nets, GridVisionConfig(**cfg_kw), base_dir=str(tmp_path))
    assert (tmp_path / "out" / "orient.npz").exists()
    jloaded = jweights.load_all(JaxConfig(**cfg_kw), base_dir=str(tmp_path),
                                seed=0)
    for key in ("detector", "orientation"):
        _assert_trees_close(weights.flax_tree(nets[key]), jloaded[key],
                            atol=0)
    jtrees = jweights.init_all(JaxConfig(**SMALL), seed=9)
    jweights.save_all(jtrees, JaxConfig(**cfg_kw), base_dir=str(tmp_path))
    back = weights.load_all(GridVisionConfig(**cfg_kw),
                            base_dir=str(tmp_path), device="cpu")
    for key in ("detector", "orientation"):
        _assert_trees_close(weights.flax_tree(back[key]), jtrees[key],
                            atol=0)
