"""The port's utils/guards.py, io/grid_msg.py and the four public names it
lacked (types.Boxes.count, types.SaturationStats.zeros,
geometry.projection_matrix_3x4, geometry.make_transform) against the JAX
package's on the same inputs: validate_obs raises where JAX's does;
check_state's report equal; recover_state's log-odds exact and occupancy
within 1e-7 (XLA's exp and torch's differ by an ulp); the nav_msgs
message's fields equal; the public names equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import geometry as jgeometry
from grid_vision_tpu import types as jtypes
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io import grid_msg as jgrid_msg
from grid_vision_tpu.utils import guards as jguards
from grid_vision_tpu_torch import geometry, types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io import grid_msg
from grid_vision_tpu_torch.utils import guards

torch.set_num_threads(1)

SMALL = dict(max_points=256, grid_x=20, grid_y=10, resolution=0.25)


def _obs_pair(image_shape, cloud_cap):
    jobs = jtypes.Obs(image=jnp.zeros(image_shape),
                      cloud=jtypes.PointCloud.empty(cloud_cap),
                      has_image=jnp.asarray(True),
                      has_cloud=jnp.asarray(False))
    obs = types.Obs(image=torch.zeros(image_shape),
                    cloud=types.PointCloud.empty(cloud_cap),
                    has_image=torch.tensor(True),
                    has_cloud=torch.tensor(False))
    return obs, jobs


@pytest.mark.parametrize("image_shape,cloud_cap", [
    ((480, 640, 3), 256), ((100, 100, 3), 256), ((480, 640, 3), 64),
    ((480, 640), 256), ((100, 100, 3), 64)])
def test_validate_obs_raises_where_jax_does(image_shape, cloud_cap):
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    obs, jobs = _obs_pair(image_shape, cloud_cap)
    try:
        jguards.validate_obs(jobs, jcfg)
        want = None
    except jguards.InputError as e:
        want = str(e)
    if want is None:
        guards.validate_obs(obs, cfg)
    else:
        with pytest.raises(guards.InputError) as got:
            guards.validate_obs(obs, cfg)
        assert str(got.value) == want
        assert issubclass(guards.InputError, ValueError)


def _states(seed, poison):
    """The same grid state in both packages: random log-odds, some cells
    set to nan / +-inf where `poison`."""
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-4, 4, cfg.grid_size).astype(np.float32)
    if poison:
        lo[3, 4], lo[7, 1], lo[0, 9] = np.nan, np.inf, -np.inf
    state = dataclasses.replace(types.GridState.create(cfg, seed),
                                log_odds=torch.from_numpy(lo),
                                step=torch.tensor(17, dtype=torch.int32))
    jstate = jtypes.GridState.create(jcfg)
    jstate = jtypes.GridState(log_odds=jnp.asarray(lo),
                              occupancy=jstate.occupancy, rng=jstate.rng,
                              step=jnp.asarray(17, jnp.int32))
    return cfg, jcfg, state, jstate


@pytest.mark.parametrize("poison", [False, True])
def test_check_state_report_equal(poison):
    _, _, state, jstate = _states(0, poison)
    got, want = guards.check_state(state), jguards.check_state(jstate)
    assert dataclasses.asdict(got).keys() == dataclasses.asdict(want).keys()
    for k, v in dataclasses.asdict(want).items():
        g = getattr(got, k)
        assert type(g) is type(v), k
        assert g == v or (np.isnan(g) and np.isnan(v)), k
    assert got.ok == want.ok == (not poison)


def test_check_state_of_a_fresh_state():
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    got = guards.check_state(types.GridState.create(cfg))
    want = jguards.check_state(jtypes.GridState.create(jcfg))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_recover_state_matches_jax(seed):
    cfg, jcfg, state, jstate = _states(seed, True)
    got, want = guards.recover_state(state, cfg), \
        jguards.recover_state(jstate, jcfg)
    np.testing.assert_array_equal(got.log_odds.numpy(),
                                  np.asarray(want.log_odds))
    np.testing.assert_allclose(got.occupancy.numpy(),
                               np.asarray(want.occupancy), rtol=0, atol=1e-7)
    assert got.log_odds.device == state.log_odds.device
    assert torch.equal(got.rng, state.rng) and torch.equal(got.step,
                                                           state.step)
    assert guards.check_state(got).ok


@pytest.mark.parametrize("stamp", [123, None])
def test_occupancy_grid_msg_fields_equal(stamp):
    cfg, jcfg = GridVisionConfig(), JaxConfig()
    g = np.random.default_rng(2).integers(-1, 101, cfg.grid_size).astype(
        np.int8)
    for src in (g, torch.from_numpy(g)):
        got = grid_msg.to_occupancy_grid_msg(src, cfg, stamp_ns=stamp)
        want = jgrid_msg.to_occupancy_grid_msg(g, jcfg, stamp_ns=stamp)
        for f in dataclasses.fields(want):
            if f.name == "stamp_ns" and stamp is None:
                assert abs(got.stamp_ns - want.stamp_ns) < 60e9
            elif f.name == "data":
                np.testing.assert_array_equal(got.data, want.data)
                assert got.data.dtype == np.int8
            else:
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        np.testing.assert_array_equal(got.flat_data(), want.flat_data())
    with pytest.raises(ValueError):
        grid_msg.to_occupancy_grid_msg(g[:-1], cfg)


def test_public_names_equal_jax():
    rng = np.random.default_rng(4)
    valid = rng.random((3, 16)) < 0.4
    b = types.Boxes.empty(16)
    jb = jtypes.Boxes.empty(16)
    for v in (valid[0], valid):
        got = dataclasses.replace(b, valid=torch.from_numpy(v)).count()
        want = jtypes.Boxes(xyxy=jb.xyxy, confidence=jb.confidence,
                            label=jb.label, valid=jnp.asarray(v)).count()
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z, jz = types.SaturationStats.zeros(), jtypes.SaturationStats.zeros()
    for f in dataclasses.fields(z):
        got, want = getattr(z, f.name), getattr(jz, f.name)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want) == 0
    for args in ((320.0, 320.0, 320.0, 240.0), (721.5, 722.0, 609.6, 172.9)):
        got = geometry.projection_matrix_3x4(*args)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jgeometry.projection_matrix_3x4(*args)))
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = np.asarray(jgeometry.quat_to_matrix(jnp.asarray(q, jnp.float32))
                   if hasattr(jgeometry, "quat_to_matrix") else
                   np.linalg.qr(rng.normal(size=(3, 3)))[0], np.float32)
    t = rng.normal(size=3).astype(np.float32)
    want = np.asarray(jgeometry.make_transform(jnp.asarray(R),
                                               jnp.asarray(t)))
    for RR, tt in ((torch.from_numpy(R), torch.from_numpy(t)), (R, t)):
        got = geometry.make_transform(RR, tt)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
