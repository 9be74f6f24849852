"""The port's city grid (grid_vision_tpu_torch/parallel/city_grid.py, rows
split over a RigMesh's shards) against the JAX package's
parallel/city_grid.py on the 8 virtual CPU devices of tests/conftest.py:
the slabs compose exactly across their boundaries, the sharded update is
bit-equal to JAX's sharded (jitted) update tick after tick, and
CityFusion's rigs land on the same world grid, with injected poses and
with real detections.

Tolerances: counts and log-odds exact; occupancy within 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from grid_vision_tpu.parallel.city_grid import CityFusion as JaxCityFusion
from grid_vision_tpu.parallel.city_grid import CityGrid as JaxCityGrid
from grid_vision_tpu.parallel.city_grid import CityGridSpec as JaxSpec
from grid_vision_tpu.parallel.city_grid import \
    slab_hit_counts as jslab_hit_counts
from grid_vision_tpu.parallel.mesh import rig_mesh as jrig_mesh
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu_torch import demo
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.parallel import CityFusion, CityGrid, RigMesh
from grid_vision_tpu_torch.parallel.city_grid import (CityGridSpec,
                                                      city_update,
                                                      slab_hit_counts)
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.types import LShapePoses, Obs, stack
from grid_vision_tpu_torch.utils import prng

from .test_torch_fleet import _jax_obs
from .test_torch_parallel import fleets  # noqa: F401
from .test_torch_shared_grid import (jax_extrinsics, jax_poses,
                                     rig_extrinsics)

torch.set_num_threads(1)

SPEC_KW = dict(length_x=80.0, length_y=20.0, resolution=0.25,
               center=(0.0, 0.0))      # 320 x 80 cells, 8 x 40-row slabs
SPEC, JSPEC = CityGridSpec(**SPEC_KW), JaxSpec(**SPEC_KW)
CPU8 = RigMesh(["cpu"] * 8)


def make_poses(entries, capacity=16):
    e = LShapePoses.empty(capacity)
    pos = torch.zeros((capacity, 3))
    length, width = torch.zeros(capacity), torch.zeros(capacity)
    ok = torch.zeros(capacity, dtype=torch.bool)
    for i, (px, py, l_, w_) in enumerate(entries):
        pos[i] = torch.tensor([px, py, 0.0])
        length[i], width[i], ok[i] = l_, w_, True
    return dataclasses.replace(e, position=pos, length=length, width=width,
                               valid=ok)


# boxes that straddle slab boundaries (a slab is 10 m of x here), and three
# that overlap, so that a cell counts 3 hits (hit x 3 is inexact in f32:
# the update's one rounding shows)
POSES = make_poses([(-30.0, 2.0, 6.0, 3.0), (0.0, -5.0, 4.0, 2.0),
                    (9.9, 0.0, 8.0, 4.0), (35.0, 7.0, 2.0, 2.0),
                    (20.0, 1.0, 3.0, 3.0), (20.5, 1.5, 3.0, 3.0),
                    (19.5, 0.5, 3.0, 3.0)])


def test_slab_counts_compose_and_match_jax():
    h, w = SPEC.shape
    full = slab_hit_counts(POSES, SPEC, 0, h)
    assert float(full.max()) == 3.0
    np.testing.assert_array_equal(
        full.numpy(), np.asarray(jslab_hit_counts(jax_poses(POSES), JSPEC,
                                                  0, h)))
    slab_h = h // 8
    stitched = torch.cat([slab_hit_counts(POSES, SPEC, i * slab_h, slab_h)
                          for i in range(8)])
    assert torch.equal(stitched, full)


def test_sharded_update_matches_jax_across_ticks():
    """8 slabs on 8 logical shards against JAX's 8-device CityGrid, three
    ticks (the state persists): bit-equal log-odds."""
    cg, jcg = CityGrid(SPEC, mesh=CPU8), JaxCityGrid(JSPEC)
    lo, jlo = cg.init_grid(), jcg.init_grid()
    jp = jax_poses(POSES)
    for i in range(3):
        lo, occ = cg.update(lo, POSES)
        jlo, jocc = jcg.update(jlo, jp)
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo),
                                      err_msg=f"tick {i}")
        np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                                   atol=1e-7)
    assert float(lo.max()) > 2 * SPEC.log_odds_hit   # evidence accumulated
    assert float(lo.min()) >= SPEC.min_log_odds
    # one slab computes the same grid
    one = CityGrid(SPEC, mesh=RigMesh(["cpu"]))
    lo1 = one.init_grid()
    for _ in range(3):
        lo1, _ = one.update(lo1, POSES)
    assert torch.equal(lo1, lo)
    # the update's arithmetic is the local rasterizer's, one slab at a time
    ref, _ = city_update(torch.zeros(SPEC.shape), POSES, SPEC)
    first, _ = cg.update(cg.init_grid(), POSES)
    assert torch.equal(first, ref)


def _marker_obs(cfg, n):
    obs = stack([Obs.create(cfg, device="cpu") for _ in range(n)])
    image = obs.image.clone()
    image[:, 0, 0, 0] = torch.arange(n, dtype=torch.float32)
    return dataclasses.replace(obs, image=image,
                               has_image=torch.ones(n, dtype=torch.bool),
                               has_cloud=torch.ones(n, dtype=torch.bool))


def test_city_fusion_injected_poses_matches_jax():
    """8 rigs report a 2 x 2 m box each at world x = -32 + 8 r."""
    cfg_kw = dict(max_points=256, camera_image_height=32,
                  camera_image_width=32, fx=16.0, fy=16.0, cx=16.0,
                  cy=16.0, grid_x=24, grid_y=12, resolution=0.25)
    from grid_vision_tpu.config import GridVisionConfig as JaxConfig

    def fake(params, obs, extr, c, key):
        e = LShapePoses.empty(4)
        pos = e.position.clone()
        pos[0, 0] = -32.0 + obs.image[0, 0, 0] * 8.0
        return dataclasses.replace(
            e, position=pos, length=torch.tensor([2.0, 0, 0, 0]),
            width=torch.tensor([2.0, 0, 0, 0]),
            valid=torch.tensor([True, False, False, False]))

    def jfake(params, obs, extr, c, key):
        rig = obs.image[0, 0, 0].astype(jnp.float32)
        e = JaxPoses.empty(4)
        return JaxPoses(
            position=e.position.at[0, 0].set(-32.0 + rig * 8.0),
            quat=e.quat, length=e.length.at[0].set(2.0),
            width=e.width.at[0].set(2.0), height=e.height, label=e.label,
            valid=e.valid.at[0].set(True))

    cfg = GridVisionConfig(**cfg_kw)
    obs = _marker_obs(cfg, 8)
    extr = stack([demo.default_extrinsics("cpu")] * 8)
    cf = CityFusion(SPEC, cfg, 8, mesh=CPU8, params={}, poses_fn=fake)
    jcf = JaxCityFusion(JSPEC, JaxConfig(**cfg_kw), 8, mesh=jrig_mesh(),
                        params={}, poses_fn=jfake)
    lo, occ = cf.step(cf.init_grid(), obs, extr, prng.prng_key(0))
    jlo, jocc = jcf.step(jcf.init_grid(), _jax_obs(obs),
                         jax_extrinsics(extr), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                               atol=1e-7)
    h, _ = SPEC.shape
    for rig in range(8):
        row = int((SPEC.length_x / 2 - (-32.0 + rig * 8.0)) / SPEC.resolution)
        row = min(max(row, 1), h - 2)
        assert (lo[max(0, row - 8):row + 8] > 0).any(), f"rig {rig} missing"


def test_city_fusion_real_detections_matches_jax(fleets):  # noqa: F811
    jfleet, fleet, _ = fleets
    n = 8
    obs_b = FleetPool(fleet.cfg, n, device="cpu").obs(0)
    extr_b = rig_extrinsics(n, demo.default_extrinsics("cpu"))
    cf = CityFusion(SPEC, fleet.cfg, n, mesh=CPU8, params=fleet.params)
    jcf = JaxCityFusion(JSPEC, jfleet.cfg, n, mesh=jrig_mesh(),
                        params=jfleet.params)
    lo, jlo = cf.init_grid(), jcf.init_grid()
    for i in range(2):
        lo, occ = cf.step(lo, obs_b, extr_b, prng.prng_key(i))
        jlo, jocc = jcf.step(jlo, _jax_obs(obs_b), jax_extrinsics(extr_b),
                             jax.random.PRNGKey(i))
        np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo),
                                      err_msg=f"tick {i}")
        np.testing.assert_allclose(occ.numpy(), np.asarray(jocc), rtol=0,
                                   atol=1e-7)
    assert float(lo.max()) > 0.0, "no rig's evidence reached the city grid"
