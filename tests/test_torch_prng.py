"""The port's threefry2x32 keys (utils/prng.py) against jax.random: the
PRNGKey of a seed and ten chained splits are bit-equal, and so are the
per-rig keys of GridState.create_batch."""

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.types import GridState as JaxState
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.types import GridState
from grid_vision_tpu_torch.utils import prng

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_key_and_chained_splits_bit_equal(seed):
    jkey, key = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert key.dtype == torch.uint32
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    for i in range(10):
        jpair, pair = jax.random.split(jkey), prng.split(key)
        np.testing.assert_array_equal(pair.numpy(), np.asarray(jpair),
                                      err_msg=f"split {i}")
        jkey, key = jpair[i % 2], pair[i % 2]


def test_split_into_many_and_batched_keys():
    jkey, key = jax.random.PRNGKey(7), prng.prng_key(7)
    np.testing.assert_array_equal(prng.split(key, 5).numpy(),
                                  np.asarray(jax.random.split(jkey, 5)))
    seeds = np.array([0, 3, 2 ** 31 - 1])
    keys = torch.stack([prng.prng_key(int(s)) for s in seeds])
    jkeys = jax.vmap(jax.random.PRNGKey)(seeds)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal(prng.split(keys).numpy(),
                                  np.asarray(jax.vmap(jax.random.split)(
                                      jkeys)))


@pytest.mark.parametrize("n,seed", [(3, 0), (4, 11)])
def test_create_batch_keys_bit_equal(n, seed):
    small = dict(grid_x=30, grid_y=10, resolution=0.25)
    jstates = JaxState.create_batch(JaxConfig(**small), n, seed)
    states = GridState.create_batch(GridVisionConfig(**small), n, seed,
                                    device="cpu")
    np.testing.assert_array_equal(states.rng.numpy(),
                                  np.asarray(jstates.rng))
    np.testing.assert_array_equal(states.log_odds.numpy(),
                                  np.asarray(jstates.log_odds))
    np.testing.assert_array_equal(states.step.numpy(),
                                  np.asarray(jstates.step))
    np.testing.assert_array_equal(
        GridState.create(GridVisionConfig(**small), seed).rng.numpy(),
        np.asarray(JaxState.create(JaxConfig(**small), seed).rng))


def test_prng_key_rejects_negative_seed():
    with pytest.raises(ValueError, match="seed"):
        prng.prng_key(-1)
