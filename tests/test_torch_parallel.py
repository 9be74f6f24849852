"""The port's rig fleet (grid_vision_tpu_torch/parallel/fleet.py, Fleet on
a RigMesh) against the JAX package's Fleet on the 8 virtual CPU devices of
tests/conftest.py, the "xla" backends on both sides, 16 rigs of the fleet
scene pool at a reduced size, the same random weights (detection heads
scaled so that the orientation budget binds).

The port runs on an 8-shard RigMesh of the CPU wherever the JAX result
depends on the shard count (compacted_step's budget is per shard).
Tolerances: log-odds, occupancy_i8, box and pose validity, integer track
fields and dropped counts exact; occupancy within 1e-7; track floats and
pose fields within 1e-5 (velocities, differences of positions over dt =
0.1 s, within 1e-4). Also: compacted_step equals __call__ when the
budget covers the load, and checkpoints cross both ways.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.ops import tracking as jtracking
from grid_vision_tpu.parallel import Fleet as JaxFleet
from grid_vision_tpu_torch import demo
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.models import weights
from grid_vision_tpu_torch.ops import tracking
from grid_vision_tpu_torch.parallel import Fleet, RigMesh, rig_mesh
from grid_vision_tpu_torch.runtime.stream import FleetPool

from .test_torch_fleet import _jax_obs

torch.set_num_threads(1)

R, SHARDS, TICKS = 16, 8, 2
# 96x128 camera, detector 64, orientation 64 / width 8, a 30 m x 10 m grid
# at 0.25 m, 512 points, 4 orientation slots a rig
SMALL = dict(camera_image_height=96, camera_image_width=128,
             detection_network_input_size=64, network_height=64,
             network_width=64, orientation_width=8, fx=64.0, fy=64.0,
             cx=64.0, cy=48.0, max_points=512, grid_x=30, grid_y=10,
             resolution=0.25, max_static_depth=16,
             max_orientation_batch=4)
HEAD_SCALE = 150.0
TOL = dict(rtol=1e-5, atol=1e-5)
TRACK_INT = ("label", "id", "hits", "misses", "age", "valid", "has_pose",
             "next_id")
HORIZONS = (0.5, 1.0, 2.0)


@pytest.fixture(scope="module")
def fleets():
    jcfg, cfg = JaxConfig(**SMALL), GridVisionConfig(**SMALL)
    tree = jax.tree_util.tree_map(np.asarray, jweights.init_all(jcfg, 1))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * HEAD_SCALE
    nets = weights.load_all(cfg, device="cpu")
    for key in ("detector", "orientation"):
        weights.load_module(nets[key], tree[key])
    jfleet = JaxFleet(jcfg, R, params=tree,
                      extrinsics=jdemo.default_extrinsics())
    fleet = Fleet(cfg, R, mesh=RigMesh(["cpu"] * SHARDS), params=nets,
                  extrinsics=demo.default_extrinsics("cpu"))
    pool = FleetPool(cfg, R, device="cpu")
    return jfleet, fleet, [pool.obs(i) for i in range(TICKS)]


def assert_states_equal(got, ref, what):
    for f in ("log_odds", "rng", "step"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f"{what}: {f}")
    np.testing.assert_allclose(got.occupancy.numpy(),
                               np.asarray(ref.occupancy), rtol=0,
                               atol=1e-7, err_msg=f"{what}: occupancy")


def assert_outputs_equal(out, jout, what):
    np.testing.assert_array_equal(out.occupancy_i8.numpy(),
                                  np.asarray(jout.occupancy_i8),
                                  err_msg=f"{what}: occupancy_i8")
    for name in ("boxes", "poses"):
        np.testing.assert_array_equal(
            getattr(out, name).valid.numpy(),
            np.asarray(getattr(jout, name).valid),
            err_msg=f"{what}: {name} validity")
    pv = np.asarray(jout.poses.valid)
    np.testing.assert_allclose(out.poses.position.numpy()[pv],
                               np.asarray(jout.poses.position)[pv], **TOL,
                               err_msg=f"{what}: positions")
    for f in dataclasses.fields(out.saturation):
        np.testing.assert_array_equal(
            getattr(out.saturation, f.name).numpy(),
            np.asarray(getattr(jout.saturation, f.name)),
            err_msg=f"{what}: {f.name}")


def test_rig_mesh_shards():
    mesh = RigMesh(["cpu"] * 4)
    assert list(mesh.shards(8)) == [(torch.device("cpu"), 2 * s, 2 * s + 2)
                                    for s in range(4)]
    # one device: the shards merge into one batch
    assert list(mesh.groups(8)) == [(torch.device("cpu"), 0, 8)]
    assert rig_mesh(3, device="cpu").size == 3
    with pytest.raises(ValueError):
        list(mesh.shards(6))
    cfg = GridVisionConfig(**SMALL)
    with pytest.raises(ValueError, match="% shards"):
        Fleet(cfg, 6, mesh=mesh, params=weights.load_all(cfg, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rig_mesh()


def test_call_matches_jax(fleets):
    jfleet, fleet, obs_seq = fleets
    jstates, states = jfleet.init_states(), fleet.init_states()
    n_poses = 0
    for i, obs in enumerate(obs_seq):
        jstates, jout = jfleet(jstates, jfleet.shard_obs(_jax_obs(obs)))
        states, out = fleet(states, fleet.shard_obs(obs))
        assert_outputs_equal(out, jout, f"tick {i}")
        assert_states_equal(states, jstates, f"tick {i}")
        n_poses += int(out.poses.valid.sum())
    assert n_poses > R


def test_compacted_step_budget_binds_per_shard(fleets):
    """budget_per_rig=1 over 2 rigs a shard: the shard's two best
    candidates, each shard on its own (8 shards, as JAX's shard_map)."""
    jfleet, fleet, obs_seq = fleets
    jstates, states = jfleet.init_states(), fleet.init_states()
    dropped = 0
    for i, obs in enumerate(obs_seq):
        jstates, jout = jfleet.compacted_step(
            jstates, jfleet.shard_obs(_jax_obs(obs)), budget_per_rig=1)
        states, out = fleet.compacted_step(states, obs, budget_per_rig=1)
        assert_outputs_equal(out, jout, f"tick {i}")
        assert_states_equal(states, jstates, f"tick {i}")
        # at most 2 poses a shard
        per_shard = out.poses.valid.reshape(SHARDS, -1).sum(dim=1)
        assert int(per_shard.max()) <= 2
        dropped += int(out.saturation.orientation_dropped.sum())
    assert dropped > 0, "the per-shard budget did not bind"


def test_compacted_step_equals_call_when_budget_covers(fleets):
    _, fleet, obs_seq = fleets
    s_call, o_call = fleet(fleet.init_states(), obs_seq[0])
    s_c, o_c = fleet.compacted_step(
        fleet.init_states(), obs_seq[0],
        budget_per_rig=fleet.cfg.max_orientation_batch)
    assert torch.equal(s_c.log_odds, s_call.log_odds)
    assert torch.equal(o_c.occupancy_i8, o_call.occupancy_i8)
    assert torch.equal(o_c.poses.valid, o_call.poses.valid)
    assert int(o_c.saturation.orientation_dropped.sum()) == 0


def test_run_matches_jax(fleets):
    jfleet, fleet, obs_seq = fleets
    jstates = jfleet.run(jfleet.init_states(),
                         jfleet.shard_obs(_jax_obs(obs_seq[0])), 3)
    states = fleet.run(fleet.init_states(), obs_seq[0], 3)
    assert_states_equal(states, jstates, "run(3)")
    # run is `steps` calls
    ref = fleet.init_states()
    for _ in range(3):
        ref, _ = fleet(ref, obs_seq[0])
    assert torch.equal(states.log_odds, ref.log_odds)


def test_tracked_step_and_forecast_match_jax(fleets):
    jfleet, fleet, obs_seq = fleets
    jtcfg, tcfg = jtracking.TrackConfig(), tracking.TrackConfig()
    jstates, jtracks = jfleet.init_states(), jfleet.init_tracks(jtcfg)
    states, tracks = fleet.init_states(), fleet.init_tracks(tcfg)
    for i in range(3):
        obs = obs_seq[i % TICKS]
        jstates, jtracks, jout, jstats = jfleet.tracked_step(
            jstates, jtracks, jfleet.shard_obs(_jax_obs(obs)), dt=0.1,
            tcfg=jtcfg)
        states, tracks, out, stats = fleet.tracked_step(
            states, tracks, obs, dt=0.1, tcfg=tcfg)
        assert_outputs_equal(out, jout, f"tracked tick {i}")
        for f in dataclasses.fields(stats):
            np.testing.assert_array_equal(
                getattr(stats, f.name).numpy(),
                np.asarray(getattr(jstats, f.name)), err_msg=f.name)
        for f in dataclasses.fields(tracks):
            got = getattr(tracks, f.name).numpy()
            want = np.asarray(getattr(jtracks, f.name))
            if f.name in TRACK_INT:
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                # a velocity is a position difference over dt = 0.1 s:
                # ten times the positions' tolerance
                tol = 10 * TOL["atol"] if f.name.startswith("vel") else \
                    TOL["atol"]
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                           err_msg=f.name)
    assert int(tracks.valid.sum()) > 0
    fc = fleet.forecast(tracks, HORIZONS, tcfg)
    jfc = np.asarray(jfleet.forecast(jtracks, HORIZONS, jtcfg))
    assert fc.dtype == torch.int8
    assert fc.shape == (R, len(HORIZONS)) + fleet.cfg.grid_size
    np.testing.assert_array_equal(fc.numpy(), jfc)
    # the probabilities behind it, within ROADMAP C's 1e-6
    p = tracking.forecast_occupancy(tracks, HORIZONS, fleet.cfg, tcfg)
    assert float(p.max()) > 0.0


def test_checkpoints_cross_packages(fleets, tmp_path):
    jfleet, fleet, obs_seq = fleets
    jstates, _ = jfleet(jfleet.init_states(),
                        jfleet.shard_obs(_jax_obs(obs_seq[0])))
    states, _ = fleet(fleet.init_states(), obs_seq[0])
    # JAX writes, the port restores bit for bit
    jpath = os.path.join(tmp_path, "jax_fleet.npz")
    jfleet.save_states(jstates, jpath)
    got = fleet.restore_states(jpath)
    assert got.rng.dtype == torch.uint32 and got.step.dtype == torch.int32
    for f in ("log_odds", "occupancy", "rng", "step"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(jstates, f)))
    # the port writes, JAX restores bit for bit (a path without .npz
    # writes path + ".npz", as the JAX package does without orbax)
    ppath = os.path.join(tmp_path, "port_fleet")
    fleet.save_states(states, ppath)
    assert os.path.exists(ppath + ".npz")
    back = jfleet.restore_states(ppath + ".npz")
    for f in ("log_odds", "occupancy", "rng", "step"):
        np.testing.assert_array_equal(np.asarray(getattr(back, f)),
                                      getattr(states, f).numpy())
    assert torch.equal(fleet.restore_states(ppath).log_odds,
                       states.log_odds)


def test_restore_refuses_orbax_directory(fleets, tmp_path):
    _, fleet, _ = fleets
    d = os.path.join(tmp_path, "orbax_ckpt")
    os.makedirs(d)
    with pytest.raises(ValueError, match="orbax"):
        fleet.restore_states(d)
