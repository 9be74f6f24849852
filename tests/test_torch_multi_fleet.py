"""The port's multi-fleet orchestration
(grid_vision_tpu_torch/parallel/multi_fleet.py: fleets on groups of a
RigMesh's shards) against the JAX package's MultiFleet on the 8 virtual
CPU devices of tests/conftest.py: two fleets with different grid
geometries, 4 rigs each, the PCA branch with detections (the weights of
tests/test_torch_pca_step.py), the same weights on both sides.

Tolerances: log-odds and occupancy_i8 exact; telemetry counts exact.
"""

import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.parallel import MultiFleet as JaxMultiFleet
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.parallel import Fleet, MultiFleet, RigMesh
from grid_vision_tpu_torch.runtime.stream import FleetPool

from .test_torch_fleet import _jax_obs
from .test_torch_pca_step import SMALL as PCA_SMALL
from .test_torch_pca_step import params as pca_params

torch.set_num_threads(1)

RIGS = 4
KW_A = dict(PCA_SMALL)
KW_B = dict(PCA_SMALL, grid_x=20, grid_y=8)      # another grid geometry
CPU8 = RigMesh(["cpu"] * 8)


def _setup():
    tree, nets = pca_params(KW_A)
    cfgs = [GridVisionConfig(**KW_A), GridVisionConfig(**KW_B)]
    jcfgs = [JaxConfig(**KW_A), JaxConfig(**KW_B)]
    obs = [FleetPool(c, RIGS, device="cpu").obs(0) for c in cfgs]
    return tree, nets, cfgs, jcfgs, obs


def test_groups_and_heterogeneous_configs_match_jax():
    tree, nets, cfgs, jcfgs, obs = _setup()
    mf = MultiFleet(cfgs, RIGS, mesh=CPU8, params_list=[nets, nets])
    jmf = JaxMultiFleet(jcfgs, RIGS, params_list=[tree, tree])
    assert mf.n_fleets == 2
    assert [len(g) for g in mf.device_groups] == [4, 4]
    assert [f.mesh.size for f in mf.fleets] == [4, 4]
    states, jstates = mf.init_states(), jmf.init_states()
    assert states[0].log_odds.shape == (RIGS,) + cfgs[0].grid_size
    assert states[1].log_odds.shape == (RIGS,) + cfgs[1].grid_size
    for i in range(2):
        states, outs = mf.step_all(states, mf.shard_obs(obs))
        jstates, jouts = jmf.step_all(jstates,
                                      jmf.shard_obs([_jax_obs(o)
                                                     for o in obs]))
        for f in range(2):
            np.testing.assert_array_equal(
                states[f].log_odds.numpy(), np.asarray(jstates[f].log_odds),
                err_msg=f"tick {i} fleet {f}")
            np.testing.assert_array_equal(
                outs[f].occupancy_i8.numpy(),
                np.asarray(jouts[f].occupancy_i8))
        assert mf.telemetry(outs) == jmf.telemetry(jouts)
    assert int(states[0].step.min()) == 2 and int(states[1].step.min()) == 2
    assert sum(t["boxes"] for t in mf.telemetry(outs).values()) > 0


def test_multi_fleet_matches_single_fleet_and_run_all():
    _, nets, cfgs, _, obs = _setup()
    mf = MultiFleet([cfgs[0], cfgs[0]], RIGS, mesh=CPU8,
                    params_list=[nets, nets])
    (s0, s1), _ = mf.step_all(mf.init_states(seed=0), [obs[0], obs[0]])
    solo = Fleet(cfgs[0], RIGS, mesh=mf.fleets[0].mesh, params=nets)
    s_solo, _ = solo(solo.init_states(seed=0), obs[0])
    assert torch.equal(s0.log_odds, s_solo.log_odds)
    # fleet 1's rigs draw from seed 100 (init_states(seed + 100 i))
    s_b, _ = solo(solo.init_states(seed=100), obs[0])
    assert torch.equal(s1.log_odds, s_b.log_odds)
    assert torch.equal(s1.rng, s_b.rng)
    # run_all: `steps` ticks a fleet
    states = mf.run_all(mf.init_states(), [obs[0], obs[0]], steps=3)
    assert [int(s.step.min()) for s in states] == [3, 3]
    ref = solo.run(solo.init_states(), obs[0], 3)
    assert torch.equal(states[0].log_odds, ref.log_odds)


def test_group_sizes_refused():
    cfg = GridVisionConfig(**KW_A)
    _, nets = pca_params(KW_A)
    with pytest.raises(ValueError, match="at least one"):
        MultiFleet([], RIGS, mesh=CPU8)
    with pytest.raises(ValueError, match="exceeds"):
        MultiFleet([cfg] * 3, RIGS, devices_per_fleet=4, mesh=CPU8)
    # a fleet's rigs must split over its group's shards
    with pytest.raises(ValueError, match="% shards"):
        MultiFleet([cfg], 3, mesh=RigMesh(["cpu"] * 2), params_list=[nets])
