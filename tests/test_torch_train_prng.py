"""The draws training needs from the port's threefry (utils/prng.py) against
jax.random on the same keys: fold_in (and flax's static fold-in of a module
path), randint and uniform with bounds bit for bit; normal and
truncated_normal within 1e-6 (XLA's erf_inv takes its own log1p: the port
is within 2 ulps)."""

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu_torch.utils import prng

torch.set_num_threads(1)

SEEDS = [0, 5, 2 ** 31 - 1]


def _keys(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, torch.tensor(np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 77, 0xFFFFFFF0])
def test_fold_in_bit_equal(seed, data):
    jk, k = _keys(seed)
    np.testing.assert_array_equal(
        prng.fold_in(k, data).numpy(),
        np.asarray(jax.random.fold_in(jk, np.uint32(data))))


@pytest.mark.parametrize("parts", [("ConvBN_0", "Conv_0", 1),
                                   ("MultiBinHeads_0", "dim_fc2", 2),
                                   ("head_13", 300)])
def test_static_fold_in_is_flax_lazy_rng(parts):
    """fold_in_str is flax's LazyRng suffix fold-in (flax/core/scope.py
    _fold_in_static, no separators)."""
    from flax.core import scope
    jk, k = _keys(3)
    np.testing.assert_array_equal(
        prng.fold_in_str(k, *parts).numpy(),
        np.asarray(scope.LazyRng.create(jk, *parts).as_jax_rng()))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi,shape", [(1, 5, ()), (0, 10, (4,)),
                                         (0, 640, (7, 3)),
                                         (-3, 100000, (50,)), (5, 5, (3,)),
                                         (0, 2 ** 31 - 1, (20,))])
def test_randint_bit_equal(seed, lo, hi, shape):
    jk, k = _keys(seed)
    got = prng.randint(k, shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.randint(jk, shape, lo, hi)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.08, 0.92), (0.85, 1.15),
                                   (-np.pi, np.pi),
                                   (float(np.log(np.float32(0.018))),
                                    float(np.log(np.float32(0.45))))])
def test_uniform_with_bounds_bit_equal(seed, lo, hi):
    """The bounds enter as one fused multiply-add, as jitted XLA computes
    u * (hi - lo) + lo (a plain product and sum differs in ~25 % of the
    values)."""
    jk, k = _keys(seed)
    np.testing.assert_array_equal(
        prng.uniform(k, (3000,), lo, hi).numpy(),
        np.asarray(jax.random.uniform(jk, (3000,), minval=lo, maxval=hi)))


def test_batched_keys_draw_as_vmap():
    jks = jax.random.split(jax.random.PRNGKey(3), 4)
    ks = torch.tensor(np.asarray(jks))
    np.testing.assert_array_equal(
        prng.randint(ks, (5,), 0, 10).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 10))(
            jks)))
    np.testing.assert_array_equal(
        prng.uniform(ks, (2, 3), 0.3, 1.0).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (2, 3), minval=0.3, maxval=1.0))(jks)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_1e6(seed):
    jk, k = _keys(seed)
    got = prng.normal(k, (20000,)).numpy()
    want = np.asarray(jax.random.normal(jk, (20000,)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got == want).mean() > 0.98


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (64, 10)])
def test_truncated_normal_within_1e6(seed, shape):
    jk, k = _keys(seed)
    got = prng.truncated_normal(k, -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(jk, -2.0, 2.0, shape))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() < 2.0


def test_erfinv_is_xlas_not_torchs():
    """XLA's f32 erf_inv (Giles' polynomial) within 2 ulps, where
    torch.erfinv strays by up to ~65 ulps."""
    u = np.random.default_rng(0).uniform(-1, 1, 100000).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = prng.erfinv(torch.from_numpy(u)).numpy()
    ulps = np.abs(got - want) / np.spacing(np.abs(want))
    assert ulps.max() <= 2.0
    assert (got == want).mean() > 0.98
    np.testing.assert_array_equal(
        prng.erfinv(torch.tensor([-1.0, 1.0])).numpy(), [-np.inf, np.inf])
