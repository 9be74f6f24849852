"""The tracked tick (pipeline.step_tracked, Engine.init_tracks /
call_tracked) against the JAX package's Engine.call_tracked, jitted on the
CPU on its "xla" backends.

At the tests' reduced size (tests/test_torch_pca_step.py's: a 96x128
camera, 2048 points, a 30 m x 10 m grid, the random nets whose saturated
heads give several dozen boxes a tick, static and dynamic), in the vision
and the PCA branch, the port on its kernel backends (each wrapper runs its
plain twin on a CPU tensor):
  - the port's tracker fed JAX's StepOutput of every tick: every track
    field as tests/test_torch_tracking.py holds it (integers equal, floats
    within 1e-5), so the tracker adds nothing to the step's differences;
  - the port's own call_tracked: integer and boolean fields, confirmed()
    and TrackStats equal every tick; the float fields within the step's
    own bars (tests/test_torch_pca_step.py: 1e-4 on boxes and poses; the
    vision branch's MultiBin poses differ by up to 1e-3 at this size), and
    velocities within those over dt (dt = 0.1: x 10, x 2 for the two
    positions of a difference).
At full width (480x640, 16384 points, 500x200, shipped weights, f32
compat, `io/scene.py` seed 0 with the default traffic, dt = 0.1) the port's
plain path and its kernel path against tests/fixtures/tracked_jax.npz
(tools/jax_tracked_fixture.py): integer fields and TrackStats equal every
tick, positions within 1e-3 m and velocities within 1e-2 m/s (the depth
refine's pose bar carried through 1 / dt), box counts equal; the forecast
of JAX's final state, carried across, within 1e-5.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu import demo as jdemo
from grid_vision_tpu import pipeline as jpipe
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.ops import tracking as jtr
from grid_vision_tpu.runtime.stream import obs_from_scene as jobs_from_scene
from grid_vision_tpu_torch import demo, pipeline, types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.ops import tracking
from grid_vision_tpu_torch.runtime.stream import obs_from_scene
from tests.test_torch_pca_step import SMALL, params, scenes
from tests.test_torch_tracking import (INT_FIELDS, STATS,
                                       assert_tracks_equal, state_numpy)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "tracked_jax.npz")
KERNELS = dict(detector_stem_backend="pallas", grid_backend="pallas",
               knn_backend="pallas", orientation_stem_backend="pallas")
TICKS = 4
DT = 0.1
BRANCHES = {"vision": dict(use_vision_orientation=True),
            "pca": dict(use_vision_orientation=False)}
POSE_TOL = {"vision": 1e-3, "pca": 1e-4}


def to_port(jout):
    """A JAX StepOutput as the port's (CPU tensors)."""
    def conv(x):
        if dataclasses.is_dataclass(x):
            return type_map[type(x).__name__](**{
                f.name: conv(getattr(x, f.name))
                for f in dataclasses.fields(x)})
        return torch.from_numpy(np.array(x))
    type_map = {"StepOutput": types.StepOutput, "Boxes": types.Boxes,
                "LShapePoses": types.LShapePoses,
                "SaturationStats": types.SaturationStats}
    return conv(jout)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_call_tracked_matches_jax(branch):
    kw = dict(SMALL, **BRANCHES[branch])
    jcfg, cfg = JaxConfig(**kw), GridVisionConfig(**kw, **KERNELS)
    tree, nets = params(kw)
    jeng = jpipe.Engine(jcfg, extrinsics=jdemo.default_extrinsics(),
                        params=tree)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    jtc, tc = jtr.TrackConfig(), tracking.TrackConfig()
    conf = jax.jit(lambda s: s.confirmed(jtc))
    js, ps = scenes(jcfg, cfg, 2)
    jstate, jtracks = jeng.init_state(), jeng.init_tracks(jtc)
    state, tracks = eng.init_state(), eng.init_tracks(tc)
    fed = tracking.TrackState.create(tc)
    tol = POSE_TOL[branch]
    n_matched = 0
    for i in range(TICKS):
        t = i * DT
        jstate, jtracks, jout, jstats = jeng.call_tracked(
            jstate, jtracks, jobs_from_scene(js, t, jcfg), dt=DT, tcfg=jtc)
        state, tracks, out, stats = eng.call_tracked(
            state, tracks, obs_from_scene(ps, t, cfg, "cpu"), dt=DT,
            tcfg=tc)
        fed, _ = tracking.update_tracks(fed, to_port(jout), DT, cfg, tc)
        assert_tracks_equal(fed, jtracks, f"fed tick {i}")
        ref = state_numpy(jtracks)
        for name, want in ref.items():
            got = getattr(tracks, name).numpy()
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, f"tick {i} {name}")
            else:
                bar = tol * 2.0 / DT if name.startswith("vel") else tol
                np.testing.assert_allclose(got, want, rtol=0, atol=bar,
                                           err_msg=f"tick {i} {name}")
        np.testing.assert_array_equal(tracks.confirmed(tc).numpy(),
                                      np.asarray(conf(jtracks)))
        for name in STATS:
            assert int(getattr(stats, name)) == int(getattr(jstats, name))
        n_matched += int(stats.matched)
    assert int(tracks.next_id) > 4 and n_matched > 4, (
        int(tracks.next_id), n_matched)
    assert bool(tracks.confirmed(tc).any())


def test_step_tracked_is_step_then_update_and_takes_a_tensor_dt():
    kw = dict(SMALL, use_vision_orientation=False)
    _, nets = params(kw)
    cfg = GridVisionConfig(**kw)
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          params=nets, device="cpu")
    scene = SyntheticScene(cfg, seed=2, n_ground=1200)
    scene.add_default_traffic()
    scene.add_default_statics()
    tc = tracking.TrackConfig(capacity=8)
    a = (eng.init_state(), eng.init_tracks(tc))
    b = (eng.init_state(), eng.init_tracks(tc))
    for i in range(2):
        obs = obs_from_scene(scene, i * DT, cfg, "cpu")
        sa, ta, outa, sta = eng.call_tracked(*a, obs, dt=DT, tcfg=tc)
        sb, outb = pipeline.step(eng.params, b[0], obs, eng.extrinsics, cfg)
        tb, stb = tracking.update_tracks(
            b[1], outb, torch.tensor(DT, dtype=torch.float32), cfg, tc)
        for x, y in ((ta, tb), (sta, stb), (outa, outb)):
            for f in dataclasses.fields(x):
                va, vb = getattr(x, f.name), getattr(y, f.name)
                if dataclasses.is_dataclass(va):
                    continue
                assert torch.equal(va, vb), f.name
        assert torch.equal(sa.log_odds, sb.log_odds)
        a, b = (sa, ta), (sb, tb)
    assert ta.valid.device.type == "cpu" and int(ta.next_id) > 0


@pytest.fixture(scope="module")
def fixture():
    ref = np.load(FIXTURE)
    return ref, json.loads(str(ref["meta"]))


@pytest.mark.parametrize("backends", ["plain", "kernels"])
def test_full_width_matches_the_jax_fixture(fixture, backends):
    ref, meta = fixture
    kernels = dict(detector_stem_backend="pallas2", grid_backend="pallas",
                   knn_backend="pallas")
    cfg = GridVisionConfig(**meta["weights"],
                           **(kernels if backends == "kernels" else {}))
    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          device="cpu", base_dir=ROOT)
    tc = tracking.TrackConfig(**meta["track_config"])
    scene = SyntheticScene(cfg, **meta["scene"])
    scene.add_default_traffic()
    state, tracks = eng.init_state(), eng.init_tracks(tc)
    for i in range(meta["ticks"]):
        obs = obs_from_scene(scene, i * meta["dt"], cfg, "cpu")
        state, tracks, out, stats = eng.call_tracked(state, tracks, obs,
                                                     dt=meta["dt"], tcfg=tc)
        assert int(out.boxes.valid.sum()) == int(ref[f"{i}/n_boxes"])
        for name in meta["fields"]:
            want = ref[f"{i}/tracks/{name}"]
            got = getattr(tracks, name).numpy()
            if name in INT_FIELDS:
                np.testing.assert_array_equal(got, want, f"tick {i} {name}")
            else:
                bar = 1e-2 if name.startswith("vel") else 1e-3
                np.testing.assert_allclose(got, want, rtol=0, atol=bar,
                                           err_msg=f"tick {i} {name}")
        np.testing.assert_array_equal(tracks.confirmed(tc).numpy(),
                                      ref[f"{i}/confirmed"])
        for name in meta["stats"]:
            assert int(getattr(stats, name)) == int(ref[f"{i}/stats/{name}"])
    assert bool(tracks.confirmed(tc).any())
    last = meta["ticks"] - 1
    carried = tracking.track_state_from_numpy(
        {name: ref[f"{last}/tracks/{name}"] for name in meta["fields"]})
    fc = tracking.forecast_occupancy(carried, meta["horizons"], cfg, tc)
    assert fc.shape == ref["forecast"].shape
    assert ref["forecast"].max() > 0.5
    np.testing.assert_allclose(fc.numpy(), ref["forecast"], rtol=0,
                               atol=1e-5)


def test_engine_tracks_start_empty_on_the_engines_device():
    eng = pipeline.Engine(GridVisionConfig(**SMALL), device="cpu")
    tracks = eng.init_tracks()
    assert tracks.capacity == tracking.TrackConfig().capacity
    assert tracks.id.dtype == torch.int32 and tracks.valid.device.type == "cpu"
    ref = state_numpy(jtr.TrackState.create(jtr.TrackConfig()))
    for name, want in ref.items():
        np.testing.assert_array_equal(getattr(tracks, name).numpy(), want)
