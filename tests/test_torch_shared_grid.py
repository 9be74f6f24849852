"""Multi-rig shared-grid fusion in the port
(grid_vision_tpu_torch/parallel/shared_grid.py) against the JAX package's
parallel/shared_grid.py on the 8 virtual CPU devices of tests/conftest.py:
hit counts, additive evidence, one rig equal to the plain rasterizer,
sharded equal to unsharded, the fleet-compacted crop batch (no budget,
or a per-shard budget that covers the load) equal to each rig's own crop
chain, call_chunk equal to K ticks, and JAX's SharedGrid with
injected poses, with real detections and per-rig extrinsics that differ
(with and without a binding budget), and on the PCA branch (each rig's
RANSAC key from the tick's key split). Also the batched transforms of
geometry.py (an (R, 4, 4) transform equals R single calls).

Tolerances: log-odds, hit counts and dropped exact; occupancy within 1e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import rasterize as jrasterize
from grid_vision_tpu.parallel.shared_grid import SharedGrid as JaxSharedGrid
from grid_vision_tpu.types import Extrinsics as JaxExtrinsics
from grid_vision_tpu.types import LShapePoses as JaxPoses
from grid_vision_tpu_torch import demo, geometry, pipeline
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.ops import rasterize
from grid_vision_tpu_torch.parallel import RigMesh, SharedGrid
from grid_vision_tpu_torch.parallel.shared_grid import (_to_world,
                                                        shared_grid_step)
from grid_vision_tpu_torch.runtime.stream import FleetPool
from grid_vision_tpu_torch.types import (Extrinsics, LShapePoses, Obs,
                                         stack, tree_stack)
from grid_vision_tpu_torch.utils import prng

from .test_torch_fleet import _jax_obs
from .test_torch_parallel import fleets  # noqa: F401
from .test_torch_pca_step import SMALL as PCA_SMALL
from .test_torch_pca_step import params as pca_params

torch.set_num_threads(1)

CFG_KW = dict(max_points=256, camera_image_height=32, camera_image_width=32,
              fx=16.0, fy=16.0, cx=16.0, cy=16.0, grid_x=24, grid_y=12,
              resolution=0.25)
CFG = GridVisionConfig(**CFG_KW)
N = 8
CPU8 = RigMesh(["cpu"] * N)
RIG_POSES = [[(5.0, 1.0, 2.0, 1.0)],                       # rig 0: box A
             [(5.0, 1.0, 2.0, 1.0), (10.0, -2.0, 1.0, 1.0)]]  # A and B


def make_poses(entries, capacity=8):
    e = LShapePoses.empty(capacity)
    pos = torch.zeros((capacity, 3))
    length, width = torch.zeros(capacity), torch.zeros(capacity)
    ok = torch.zeros(capacity, dtype=torch.bool)
    for i, (px, py, l_, w_) in enumerate(entries):
        pos[i] = torch.tensor([px, py, 0.0])
        length[i], width[i], ok[i] = l_, w_, True
    return dataclasses.replace(e, position=pos, length=length, width=width,
                               valid=ok)


def jax_poses(p):
    return JaxPoses(*(jnp.asarray(getattr(p, f.name).numpy())
                      for f in dataclasses.fields(p)))


def fake_poses_fn(n):
    """A poses_fn that reports RIG_POSES[r % 2] for rig r, the rig found by
    the marker value planted in its frame (as tests/test_shared_grid.py)."""
    stacked = stack([make_poses(RIG_POSES[r % 2]) for r in range(n)])

    def fake(params, obs, extr, cfg, key):
        return stacked.select(int(obs.image[0, 0, 0]))

    return fake


def jax_fake_poses_fn(n):
    stacked = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *(jax_poses(make_poses(RIG_POSES[r % 2])) for r in range(n)))

    def fake(params, obs, extr, cfg, key):
        rig = obs.image[0, 0, 0].astype(jnp.int32)
        return jax.tree_util.tree_map(lambda x: x[rig], stacked)

    return fake


def obs_batch(n, cfg=CFG):
    obs = stack([Obs.create(cfg, device="cpu") for _ in range(n)])
    image = obs.image.clone()
    image[:, 0, 0, 0] = torch.arange(n, dtype=torch.float32)
    return dataclasses.replace(obs, image=image,
                               has_image=torch.ones(n, dtype=torch.bool),
                               has_cloud=torch.ones(n, dtype=torch.bool))


def identity_extrinsics(n):
    return stack([Extrinsics.identity() for _ in range(n)])


def rig_extrinsics(n, base):
    """Rig r: the base extrinsics, then a yaw of 0.3 r rad and a shift of
    (2 r, -r, 0) m into the world (every rig placed differently)."""
    out = []
    for r in range(n):
        c, s = np.cos(0.3 * r), np.sin(0.3 * r)
        world = np.eye(4, dtype=np.float32)
        world[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        world[:3, 3] = (2.0 * r, -1.0 * r, 0.0)
        c2b = torch.from_numpy(world) @ base.camera_to_base
        out.append(Extrinsics(lidar_to_camera=base.lidar_to_camera.clone(),
                              camera_to_base=c2b))
    return stack(out)


def jax_extrinsics(extr_b):
    return JaxExtrinsics(
        lidar_to_camera=jnp.asarray(extr_b.lidar_to_camera.numpy()),
        camera_to_base=jnp.asarray(extr_b.camera_to_base.numpy()))


def assert_grid_equal(got, ref, what):
    lo, occ, dropped = got
    np.testing.assert_array_equal(lo.numpy(), np.asarray(ref[0]),
                                  err_msg=f"{what}: log_odds")
    np.testing.assert_allclose(occ.numpy(), np.asarray(ref[1]), rtol=0,
                               atol=1e-7, err_msg=f"{what}: occupancy")
    assert int(dropped) == int(ref[2]), what


def test_batched_transforms_equal_single_calls():
    rng = np.random.default_rng(0)
    extr = rig_extrinsics(5, demo.default_extrinsics("cpu"))
    for n_pts in (1, 5, 64, 700):
        xyz = torch.from_numpy(rng.uniform(-30, 30, (5, n_pts, 3))
                               .astype(np.float32))
        quat = torch.nn.functional.normalize(torch.from_numpy(
            rng.normal(size=(5, n_pts, 4)).astype(np.float32)), dim=-1)
        T = extr.camera_to_base
        pts = geometry.transform_points(T, xyz)
        pos, q = geometry.transform_pose(T, xyz, quat)
        for r in range(5):
            assert torch.equal(pts[r], geometry.transform_points(T[r],
                                                                 xyz[r]))
            p1, q1 = geometry.transform_pose(T[r], xyz[r], quat[r])
            assert torch.equal(pos[r], p1) and torch.equal(q[r], q1)
    # a single transform keeps its former result: T[:3, :3].T and the
    # quaternion of its matrix broadcast over the poses
    T = extr.camera_to_base[3]
    assert torch.equal(geometry.transform_points(T, xyz[0]),
                       xyz[0] @ T[:3, :3].T + T[:3, 3])


def test_hit_counts_match_jax_and_the_block_increment():
    poses = make_poses(RIG_POSES[1])
    counts = rasterize.lshape_hit_counts(poses, CFG)
    jcfg = JaxConfig(**CFG_KW)
    np.testing.assert_array_equal(
        counts.numpy(),
        np.asarray(jrasterize.lshape_hit_counts(jax_poses(poses), jcfg)))
    lo, _ = rasterize.lshape_update(torch.zeros(CFG.grid_size), poses, CFG)
    assert torch.equal(lo, rasterize.hit_add(
        torch.zeros(CFG.grid_size) + CFG.log_odds_decay, CFG.log_odds_hit,
        counts).clamp(CFG.min_log_odds, CFG.max_log_odds))
    # a rig axis
    both = stack([make_poses(e) for e in RIG_POSES])
    assert rasterize.lshape_hit_counts(both, CFG).shape == (2,) + \
        CFG.grid_size


def test_multi_rig_evidence_accumulates():
    keys = prng.split(prng.prng_key(0), 2)
    lo, _, _ = shared_grid_step({}, torch.zeros(CFG.grid_size),
                                obs_batch(2), identity_extrinsics(2), keys,
                                CFG, poses_fn=fake_poses_fn(2))
    c0, c1 = (rasterize.lshape_hit_counts(make_poses(e), CFG)
              for e in RIG_POSES)
    expect = rasterize.hit_add(
        torch.zeros(CFG.grid_size) + CFG.log_odds_decay, CFG.log_odds_hit,
        c0 + c1).clamp(CFG.min_log_odds, CFG.max_log_odds)
    assert torch.equal(lo, expect)
    # the doubly observed box A carries twice the evidence of B
    assert float(lo.max()) > CFG.log_odds_hit * 1.5


def test_single_rig_matches_plain_rasterizer():
    lo0 = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, CFG.grid_size).astype(np.float32))
    lo, occ, _ = shared_grid_step({}, lo0, obs_batch(1),
                                  identity_extrinsics(1),
                                  prng.split(prng.prng_key(0), 1), CFG,
                                  poses_fn=fake_poses_fn(1))
    ref_lo, ref_occ = rasterize.lshape_update(lo0, make_poses(RIG_POSES[0]),
                                              CFG)
    assert torch.equal(lo, ref_lo) and torch.equal(occ, ref_occ)


def test_sharded_matches_unsharded_and_jax():
    sg = SharedGrid(CFG, N, mesh=CPU8, poses_fn=fake_poses_fn(N), params={})
    obs_b, extr_b = obs_batch(N), identity_extrinsics(N)
    got = sg(sg.init_grid(), obs_b, extr_b, prng.prng_key(0))
    ref = shared_grid_step({}, sg.init_grid(), obs_b, extr_b,
                           prng.split(prng.prng_key(0), N), CFG,
                           poses_fn=fake_poses_fn(N))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    jsg = JaxSharedGrid(JaxConfig(**CFG_KW), N,
                        poses_fn=jax_fake_poses_fn(N), params={})
    jref = jsg(jsg.init_grid(), _jax_obs(obs_b), jax_extrinsics(extr_b),
               jax.random.PRNGKey(0))
    assert_grid_equal(got, jref, "injected poses")


def test_chunk_matches_k_steps():
    k = 3
    sg = SharedGrid(CFG, N, mesh=CPU8, poses_fn=fake_poses_fn(N), params={})
    obs_b, extr_b = obs_batch(N), identity_extrinsics(N)
    obs_c = stack([obs_b] * k)
    key = prng.prng_key(42)
    lo_c, occ_c, d_c = sg.call_chunk(sg.init_grid(), obs_c, extr_b, key)
    assert occ_c.shape == (k,) + CFG.grid_size
    keys_c = prng.split(prng.split(key, k), N)
    lo = sg.init_grid()
    for t in range(k):
        lo, occ, _ = sg._step(lo, obs_c.select(t), extr_b, keys_c[t])
        assert torch.equal(occ_c[t], occ)
    assert torch.equal(lo_c, lo) and int(d_c) == 0


@pytest.fixture(scope="module")
def vision_hub(fleets):  # noqa: F811
    """8 rigs of the fleet pool with real detections (the parallel tests'
    scaled heads), each rig's own extrinsics."""
    jfleet, fleet, _ = fleets
    cfg, jcfg = fleet.cfg, jfleet.cfg
    pool = FleetPool(cfg, N, device="cpu")
    extr_b = rig_extrinsics(N, demo.default_extrinsics("cpu"))
    return jcfg, cfg, jfleet.params, fleet.params, pool.obs(0), extr_b


@pytest.mark.parametrize("budget", [None, 2])
def test_vision_hub_with_rig_extrinsics_matches_jax(vision_hub, budget):
    jcfg, cfg, tree, nets, obs_b, extr_b = vision_hub
    sg = SharedGrid(cfg, N, mesh=CPU8, params=nets,
                    orientation_budget=budget)
    jsg = JaxSharedGrid(jcfg, N, params=tree, orientation_budget=budget)
    lo, jlo = sg.init_grid(), jsg.init_grid()
    for i in range(2):
        got = sg(lo, obs_b, extr_b, prng.prng_key(i))
        jref = jsg(jlo, _jax_obs(obs_b), jax_extrinsics(extr_b),
                   jax.random.PRNGKey(i))
        assert_grid_equal(got, jref, f"tick {i}, budget {budget}")
        lo, jlo = got[0], jref[0]
    assert float(lo.max()) > 0.0, "no rig's evidence reached the grid"
    if budget is not None:
        assert int(got[2]) > 0, "the budget did not bind"


def per_rig_vision_poses(params, obs, extr, cfg, key):
    """One rig's world poses through its own crop chain and net
    (pipeline._vision_orientation_poses), as a poses_fn: the per-rig path
    the hub's fleet-compacted crop batch must equal at full budget."""
    boxes, _ = pipeline.detect_batch(params, obs.image[None], cfg)
    boxes = boxes.select(0)
    boxes = dataclasses.replace(boxes, valid=boxes.valid & obs.has_image)
    K = geometry.intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    poses = pipeline._vision_orientation_poses(params, obs.image, boxes, K,
                                               cfg)
    return _to_world(poses, extr, obs.has_image | obs.has_cloud)


@pytest.mark.parametrize("budget", [None, "per shard"])
def test_budget_path_equals_per_rig_path_at_full_budget(vision_hub, budget):
    _, cfg, _, nets, obs_b, extr_b = vision_hub
    per_rig = SharedGrid(cfg, N, mesh=CPU8, params=nets,
                         poses_fn=per_rig_vision_poses)
    hub = SharedGrid(cfg, N, mesh=CPU8, params=nets,
                     orientation_budget=(None if budget is None else
                                         cfg.max_orientation_batch))
    a = per_rig(per_rig.init_grid(), obs_b, extr_b, prng.prng_key(0))
    b = hub(hub.init_grid(), obs_b, extr_b, prng.prng_key(0))
    assert float(a[0].max()) > 0.0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pca_hub_matches_jax():
    """The PCA branch draws its RANSAC samples from each rig's key of the
    tick's split: the hub's grid equals JAX's only if the keys do."""
    kw = dict(PCA_SMALL)
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw)
    tree, nets = pca_params(kw)
    n = 4
    obs_b = FleetPool(cfg, n, device="cpu").obs(0)
    extr_b = rig_extrinsics(n, demo.default_extrinsics("cpu"))
    mesh = RigMesh(["cpu"] * 2)
    sg = SharedGrid(cfg, n, mesh=mesh, params=nets)
    jsg = JaxSharedGrid(
        jcfg, n, params=tree,
        mesh=jax.sharding.Mesh(np.array(jax.devices()[:2]), ("rig",)))
    got = sg(sg.init_grid(), obs_b, extr_b, prng.prng_key(7))
    jref = jsg(jsg.init_grid(), _jax_obs(obs_b), jax_extrinsics(extr_b),
               jax.random.PRNGKey(7))
    assert_grid_equal(got, jref, "PCA hub")
    assert float(got[0].max()) > 0.0, "no PCA pose reached the grid"


def test_refusals():
    for kw in (dict(compat=False, yaw_aware_rasterization=True),
               dict(compat=False, raycast_free_space=True),
               dict(compat=False, vision_depth_refine=True),
               dict(grid_backend="pallas")):
        with pytest.raises(ValueError, match="SharedGrid does not support"):
            SharedGrid(GridVisionConfig(**CFG_KW, **kw), 2,
                       mesh=RigMesh(["cpu"]), params={})
    with pytest.raises(ValueError, match="% shards"):
        SharedGrid(CFG, 3, mesh=RigMesh(["cpu"] * 2), params={})
    # types.tree_stack, the JAX package's name, is the port's stack
    assert tree_stack is stack
