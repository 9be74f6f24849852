"""The port's streaming, tracking, parallel and serving layers on the card
at full width: the packed wire, replays and recordings, the multi-object
tracker, Fleet / SharedGrid / CityGrid / MultiFleet, and the fleet server,
each against Engine.fleet, the plain backends, the CPU or the JAX
package's fixtures, with the kernels' launches counted.

Needs an NVIDIA card: every test is marked ``cuda`` and skips without one.
Imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_cuda*.py --noconftest -q
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch import pipeline
from grid_vision_tpu_torch.ops import tracking

from .test_torch_cuda_tick import (BF16_KERNELS, BUDGET, EXT, FLEET_KERNELS,
                                   N_RIGS, PLAIN, ROOT, counted, same_ticks,
                                   sync_free, to_bf16)
from .test_torch_cuda_tick import cuda_device, paths  # noqa: F401

torch.set_num_threads(1)

DT = 0.1
TCFG = tracking.TrackConfig()
FORECAST_HORIZONS = (0.5, 1.0, 2.0)
STREAM_TICKS = 20
STREAM_EXT_TICKS = 4
REPLAY_TICKS = 16
CHUNK = 8
TRACKED_TICKS = 20
TRACK_INT_FIELDS = ("id", "valid", "hits", "misses", "age", "label",
                    "has_pose", "next_id")
TRACK_STATS = ("matched", "spawned", "killed", "spawn_dropped", "reacquired")
PEAK_GB = 40.0                  # half the card


def stream_cfg(paths):
    return dataclasses.replace(paths.cfg, detector_stem_backend="pallas2")


def scene_of(cfg):
    from grid_vision_tpu_torch.io.scene import SyntheticScene
    scene = SyntheticScene(cfg, seed=0)
    scene.add_default_traffic()
    return scene


def ticks(eng, inputs, call):
    state, outs = eng.init_state(), []
    for x in inputs:
        state, out = call(state, x)
        outs.append(out)
    torch.cuda.synchronize()
    return outs


# -- the packed wire, replays, recordings ------------------------------------

@pytest.mark.cuda
def test_unpack_on_card_bit_equal_to_cpu_without_host_sync(paths):
    """Obs.unpack and unpack_delta on the card on the same buffers as on
    the CPU, 480x640 and KITTI's 374x1242 / 375x1242 (whose cloud starts
    at unaligned offsets), each codec and cloud dtype: image, cloud, count
    and flags bit-equal, no host sync."""
    from grid_vision_tpu_torch import types
    from grid_vision_tpu_torch.runtime import stream
    dev = paths.engine.device
    for size in ((480, 640), (374, 1242), (375, 1242)):
        for codec in ("rgb8", "yuv420"):
            if codec == "yuv420" and size[0] % 2:
                continue
            for cloud in ("float32", "float16"):
                c = dataclasses.replace(
                    stream_cfg(paths), camera_image_height=size[0],
                    camera_image_width=size[1], wire_image_codec=codec,
                    wire_cloud_dtype=cloud)
                scene = scene_of(c)
                buf, _ = stream.packed_from_scene(scene, 0.0, c)
                host = {"unpack": types.Obs.unpack(torch.from_numpy(buf), c)}
                dbuf = torch.from_numpy(buf).to(dev)
                calls = {"unpack": lambda b=dbuf, c=c: types.Obs.unpack(b, c)}
                if codec == "rgb8":
                    hr, wr = types.delta_roi_shape(c)
                    img = np.clip(scene.image_at(0.1), 0, 255).astype(
                        np.uint8)
                    xyz, inten, n, _ = types.PointCloud.pack_host(
                        scene.cloud_at(0.1), None, c.max_points)
                    dhost = torch.from_numpy(types.pack_delta_bytes(
                        img[5:5 + hr, 7:7 + wr], 5, 7, xyz, inten, n, True,
                        True, c))
                    host["unpack_delta"] = types.unpack_delta(
                        dhost, host["unpack"].image, c)
                    ddev, prev = dhost.to(dev), host["unpack"].image.to(dev)
                    calls["unpack_delta"] = (
                        lambda b=ddev, p=prev, c=c: types.unpack_delta(b, p,
                                                                       c))
                for name, fn in calls.items():
                    g, r = sync_free(fn), host[name]
                    what = (name, size, codec, cloud)
                    for a, b in ((g.image, r.image),
                                 (g.cloud.xyz, r.cloud.xyz),
                                 (g.cloud.intensity, r.cloud.intensity),
                                 (g.cloud.count, r.cloud.count),
                                 (torch.stack([g.has_image, g.has_cloud]),
                                  torch.stack([r.has_image, r.has_cloud]))):
                        assert torch.equal(a.cpu(), b), what


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "extension"])
def test_packed_ticks_equal_typed_ticks(paths, mode):
    """Per-frame packed ticks (host buffers copied by the engine) against
    typed ones, STREAM_TICKS frames in f32 and bf16 and STREAM_EXT_TICKS
    extension frames: bit-equal occupancy_i8 and equal box counts every
    tick; the stem, CSP, grid (or carve) and kNN kernels once a tick. In
    f32 also REPLAY_TICKS free-running ticks (no sync between them) through
    the engine's pageable upload, bit-equal too."""
    from grid_vision_tpu_torch.runtime import stream
    scfg = stream_cfg(paths)
    if mode == "f32":
        c, n = scfg, STREAM_TICKS
        want = dict(detector_stem=n, detector_csp=n, grid_update=n,
                    knn_median_depth=n)
    elif mode == "bf16":
        c, n = dataclasses.replace(scfg, compute_dtype="bfloat16"), \
            STREAM_TICKS
        want = dict(detector_stem_bf16=n, detector_csp_bf16=n, grid_update=n,
                    knn_median_depth=n)
    else:
        c, n = dataclasses.replace(scfg, **EXT), STREAM_EXT_TICKS
        want = dict(detector_stem=n, detector_csp=n, knn_median_depth=n,
                    carve_update=n)
    e = paths.engine_of(c)
    scene = scene_of(c)
    bufs = [stream.packed_from_scene(scene, i / 10.0, c)[0] for i in range(n)]
    obs = [stream.obs_from_scene(scene, i / 10.0, c, e.device)
           for i in range(n)]
    typed = ticks(e, obs, e)
    same_ticks(counted(lambda: ticks(e, bufs, e.call_packed), want), typed)
    if mode == "f32":
        free = ticks(e, bufs[:REPLAY_TICKS],
                     lambda st, b: pipeline.step_packed(
                         e.params, st, e.upload(b), e.extrinsics, e.cfg))
        same_ticks(free, typed[:REPLAY_TICKS])


@pytest.mark.cuda
def test_stream_wires_against_the_jax_fixture(paths):
    """Each wire's packed ticks against the JAX package's on the same
    buffers (tests/fixtures/stream_wire_jax.npz, tools/jax_stream_fixture.py):
    >= 99 % of occupancy_i8 equal and equal box counts every tick; the
    lossy yuv420 / f16 wire against the lossless one: the share of cells
    within one int8 step within 1e-4 of the JAX package's own share on
    every tick, and >= 99 % where the JAX package's is."""
    from grid_vision_tpu_torch.runtime import stream
    ref = np.load(os.path.join(ROOT, "tests", "fixtures",
                               "stream_wire_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    grids = {}
    for wire, flags in meta["wires"].items():
        c = dataclasses.replace(stream_cfg(paths), **flags)
        e = paths.engine_of(c)
        scene = scene_of(c)
        outs = ticks(e, [stream.packed_from_scene(scene, i / 10.0, c)[0]
                         for i in range(meta["ticks"])], e.call_packed)
        for i, o in enumerate(outs):
            key = f"{wire}/{i}/"
            assert (int(o.boxes.valid.sum())
                    == int(ref[key + "boxes_valid"].sum())), (wire, i)
            assert float((o.occupancy_i8.cpu().numpy()
                          == ref[key + "occupancy_i8"]).mean()) >= 0.99
        grids[wire] = outs
    for i, (o, r, theirs) in enumerate(zip(grids["yuv420_f16"],
                                           grids["rgb8_f32"],
                                           ref["within_one_step"])):
        d = (o.occupancy_i8.int() - r.occupancy_i8.int()).abs()
        got = (d <= 1).float().mean().item()
        assert abs(got - float(theirs)) <= 1e-4, (i, got, theirs)
        assert got >= 0.99 or float(theirs) < 0.99, (i, got)


@pytest.mark.cuda
def test_replays_and_play_equal_the_per_frame_replay(paths, tmp_path):
    """replay_delta and replay_chunked (chunks of CHUNK) over REPLAY_TICKS
    frames end in the per-frame replay's state, the typed replay in its
    grid, and a recording of the same frames played back in its grid."""
    from grid_vision_tpu_torch.runtime import record, stream
    scfg = stream_cfg(paths)
    eng = pipeline.Engine(scfg, extrinsics=paths.engine.extrinsics,
                          params=paths.nets, device=paths.engine.device,
                          base_dir=ROOT)
    n = REPLAY_TICKS
    per_frame = stream.replay(eng, scene_of(scfg), n).final_state
    for r in (stream.replay_delta(eng, scene_of(scfg), n),
              stream.replay_chunked(eng, scene_of(scfg), n, chunk=CHUNK)):
        assert torch.equal(r.final_state.log_odds, per_frame.log_odds)
        assert torch.equal(r.final_state.rng, per_frame.rng)
    typed = stream.replay(eng, scene_of(scfg), n, packed=False)
    assert torch.equal(typed.final_state.log_odds, per_frame.log_odds)
    path = str(tmp_path / "stream.gvr")
    record.record_scene(path, scfg, n, seed=0)
    n_played, played = record.play(path, chunk=CHUNK,
                                   device=paths.engine.device, base_dir=ROOT)
    assert n_played == n and torch.equal(played.log_odds, per_frame.log_odds)


# -- the multi-object tracker (ops/tracking.py) ------------------------------

def tracked_run(paths, cfg, n):
    """Engine.call_tracked over the first n ticks of the seed-0 scene:
    (tracks before, tracks after, output, stats) a tick."""
    from grid_vision_tpu_torch.runtime.stream import obs_from_scene
    eng = paths.engine_of(cfg)
    scene = scene_of(cfg)
    state, tracks = eng.init_state(), eng.init_tracks(TCFG)
    rows = []
    for i in range(n):
        obs = obs_from_scene(scene, i * DT, cfg, eng.device)
        prev = tracks
        state, tracks, out, stats = eng.call_tracked(state, tracks, obs,
                                                     dt=DT, tcfg=TCFG)
        rows.append((prev, tracks, out, stats))
    torch.cuda.synchronize()
    return rows


def tracked_cfg(paths, **flags):
    return dataclasses.replace(paths.cfg, detector_stem_backend="pallas2",
                               grid_backend="pallas", knn_backend="pallas",
                               **flags)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["compat", "pca", "extension"])
def test_tracked_single_rig_equals_plain(paths, mode):
    """call_tracked on the kernel backends against the plain ones, tick by
    tick (TRACKED_TICKS compat, 5 PCA, 4 extension): integer track fields,
    confirmed() and TrackStats equal; the kernels counted from zero; in
    compat at least one track confirmed."""
    flags, n = {"compat": ({}, TRACKED_TICKS),
                "pca": (dict(use_vision_orientation=False), 5),
                "extension": (EXT, 4)}[mode]
    kc = tracked_cfg(paths, **flags)
    grid = "carve_update" if mode == "extension" else "grid_update"
    rows = counted(lambda: tracked_run(paths, kc, n),
                   {"detector_stem": n, "detector_csp": n, grid: n,
                    "knn_median_depth": n})
    refs = tracked_run(paths, dataclasses.replace(kc, **PLAIN), n)
    for i, ((_, a, _, sa), (_, b, _, sb)) in enumerate(zip(rows, refs)):
        for name in TRACK_INT_FIELDS:
            assert torch.equal(getattr(a, name), getattr(b, name)), (i, name)
        for name in TRACK_STATS:
            assert torch.equal(getattr(sa, name), getattr(sb, name)), (i,
                                                                        name)
        assert torch.equal(a.confirmed(TCFG), b.confirmed(TCFG)), i
    if mode == "compat":
        assert max(int(r[1].confirmed(TCFG).sum()) for r in rows) > 0


@pytest.mark.cuda
def test_tracked_against_the_jax_fixture(paths):
    """The kernel path's first ticks against tests/fixtures/tracked_jax.npz
    (integer fields equal, positions within 1e-3 m, velocities within 1e-2
    m/s, box counts and TrackStats equal), and forecast_occupancy of the
    JAX package's final state, carried across, within 1e-5."""
    ref = np.load(os.path.join(ROOT, "tests", "fixtures", "tracked_jax.npz"))
    meta = json.loads(str(ref["meta"]))
    assert meta["dt"] == DT
    rows = tracked_run(paths, tracked_cfg(paths), meta["ticks"])
    for i, (_, tr, out, stats) in enumerate(rows):
        assert int(out.boxes.valid.sum()) == int(ref[f"{i}/n_boxes"]), i
        for name in meta["fields"]:
            got = getattr(tr, name).cpu().numpy()
            want = ref[f"{i}/tracks/{name}"]
            if name in TRACK_INT_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                bar = 1e-2 if name == "velocity" else 1e-3
                assert float(np.abs(got - want).max()) <= bar, (i, name)
        for name in meta["stats"]:
            assert (int(getattr(stats, name))
                    == int(ref[f"{i}/stats/{name}"])), (i, name)
    last = meta["ticks"] - 1
    carried = tracking.track_state_from_numpy(
        {name: ref[f"{last}/tracks/{name}"] for name in meta["fields"]},
        paths.engine.device)
    fc = tracking.forecast_occupancy(carried, meta["horizons"], paths.cfg,
                                     TCFG)
    assert float(np.abs(fc.cpu().numpy() - ref["forecast"]).max()) <= 1e-5


@pytest.mark.cuda
def test_mot_replay_on_card_equals_cpu(paths):
    """The seed-0 250-frame MOT replay (train/eval_tracking, PCA-aligned
    poses) gives the CPU's MOT metrics on the card."""
    from grid_vision_tpu_torch.train import eval_tracking
    pcfg = dataclasses.replace(paths.cfg, use_vision_orientation=False)
    frames = eval_tracking.simulate(
        eval_tracking.make_crossing_scenario(0, 250), pcfg, 250, seed=0)
    got, want = (eval_tracking.mot_metrics(frames, eval_tracking.run_tracker(
        frames, pcfg, TCFG, device=d)) for d in (paths.engine.device, "cpu"))
    assert got == want


def fleet_tracked(eng, cfg, fobs):
    """The fleet tick then the rig-batched update_tracks a tick, a
    FORECAST_HORIZONS forecast every 5th tick: (tracks before, output,
    tracks after, stats) a tick."""
    states = eng.init_states(N_RIGS)
    tracks = tracking.TrackState.create(TCFG, eng.device, rigs=N_RIGS)
    rows = []
    for i, obs in enumerate(fobs):
        states, out = eng.fleet(states, obs, BUDGET)
        prev = tracks
        tracks, stats = tracking.update_tracks(tracks, out, DT, cfg, TCFG)
        if i % 5 == 0:
            tracking.forecast_occupancy(tracks, FORECAST_HORIZONS, cfg, TCFG)
        rows.append((prev, out, tracks, stats))
    torch.cuda.synchronize()
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fleet_tracker_equals_single_rig_calls(paths, dtype):
    """The fleet's rig-batched tracker (capacity 32) over the pool's ticks,
    bit-equal to N_RIGS single-rig update_tracks calls on the same
    outputs, every field and TrackStats; each kernel once a tick."""
    c = (paths.fleet_cfg if dtype == "f32" else dataclasses.replace(
        paths.fleet_cfg, compute_dtype="bfloat16"))
    fobs = paths.fleet_obs if dtype == "f32" else to_bf16(paths.fleet_obs)
    eng = paths.engine_of(c)
    rows = counted(lambda: fleet_tracked(eng, c, fobs),
                   {k: len(fobs) for k in (FLEET_KERNELS if dtype == "f32"
                                           else BF16_KERNELS)})
    for i, (prev, out, tracks, stats) in enumerate(rows):
        for r in range(N_RIGS):
            one, one_stats = tracking.update_tracks(
                prev.select(r), out.select(r), DT, c, TCFG)
            for f in dataclasses.fields(one):
                assert torch.equal(getattr(tracks, f.name)[r],
                                   getattr(one, f.name)), (i, r, f.name)
            for n in TRACK_STATS:
                assert torch.equal(getattr(stats, n)[r],
                                   getattr(one_stats, n)), (i, r, n)


@pytest.mark.cuda
def test_tracker_without_host_sync_and_forecast_memory(paths):
    """update_tracks on one rig and on N_RIGS, and the fleet forecast, run
    without a host sync; the fleet forecast peaks under PEAK_GB."""
    kc = tracked_cfg(paths)
    rows = tracked_run(paths, kc, 3)
    _, tracks1, out1, _ = rows[-1]
    fc = paths.fleet_cfg
    _, out_f, tracks_f, _ = fleet_tracked(paths.engine_of(fc), fc,
                                          paths.fleet_obs)[-1]
    calls = (lambda: tracking.update_tracks(tracks1, out1, DT, kc, TCFG),
             lambda: tracking.update_tracks(tracks_f, out_f, DT, fc, TCFG),
             lambda: tracking.forecast_occupancy(tracks_f, FORECAST_HORIZONS,
                                                 fc, TCFG))
    for fn in calls:
        fn()
        sync_free(fn)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    calls[2]()
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= PEAK_GB * 2 ** 30


# -- parallel/: Fleet, SharedGrid, CityGrid, MultiFleet ----------------------

def same_grids(outs, refs):
    for i, (o, r) in enumerate(zip(outs, refs)):
        assert torch.equal(o.occupancy_i8, r.occupancy_i8), i
        assert torch.equal(o.boxes.valid.sum(-1), r.boxes.valid.sum(-1)), i


def fleet_of(paths, cfg=None, mesh=None):
    from grid_vision_tpu_torch.parallel import Fleet, RigMesh
    return Fleet(cfg or paths.fleet_cfg, N_RIGS,
                 mesh=mesh or RigMesh([paths.engine.device]),
                 params=paths.nets, extrinsics=paths.engine.extrinsics)


def fleet_steps(fleet, step, obs_seq):
    states, outs = fleet.init_states(), []
    for obs in obs_seq:
        states, out = step(states, obs)
        outs.append(out)
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
def test_fleet_call_and_compacted_step_equal_engine_fleet(paths):
    """Fleet on one shard, 3 ticks of N_RIGS rigs: __call__ against
    Engine.fleet without a budget, compacted_step(budget_per_rig=5)
    against Engine.fleet at BUDGET, occupancy_i8 bit-equal and equal box
    counts; each of the five kernels once a tick."""
    fleet, eng = fleet_of(paths), paths.engine_of(paths.fleet_cfg)
    seq = paths.fleet_obs[:3]
    want = {k: len(seq) for k in FLEET_KERNELS}
    same_grids(counted(lambda: fleet_steps(fleet, fleet, seq), want),
               fleet_steps(fleet, lambda s, o: eng.fleet(s, o), seq))
    same_grids(counted(lambda: fleet_steps(
        fleet, lambda s, o: fleet.compacted_step(s, o, 5), seq), want),
        fleet_steps(fleet, lambda s, o: eng.fleet(s, o, BUDGET), seq))


@pytest.mark.cuda
def test_two_shards_at_full_width_equal_two_engine_fleet_calls(paths):
    """Two logical shards on one card at N_RIGS rigs: compacted_step
    equals two Engine.fleet calls of half the rigs at half the budget
    (grid, outputs and dropped crops); each kernel once a shard."""
    from grid_vision_tpu_torch.parallel import RigMesh
    dev, half = paths.engine.device, N_RIGS // 2
    two = fleet_of(paths, mesh=RigMesh([dev, dev]))
    eng = paths.engine_of(paths.fleet_cfg)
    states, obs = two.init_states(), paths.fleet_obs[0]
    s2, o2 = counted(lambda: two.compacted_step(states, obs, 5),
                     {k: 2 for k in FLEET_KERNELS})
    halves = [eng.fleet(states.select(slice(a, a + half)),
                        obs.select(slice(a, a + half)), 5 * half)
              for a in (0, half)]
    assert torch.equal(s2.log_odds, torch.cat([h[0].log_odds
                                               for h in halves]))
    assert torch.equal(o2.occupancy_i8, torch.cat([h[1].occupancy_i8
                                                   for h in halves]))
    assert torch.equal(o2.saturation.orientation_dropped, torch.cat(
        [h[1].saturation.orientation_dropped for h in halves]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fleet_tracked_step_equals_engine_fleet_and_tracker(paths, dtype):
    """Fleet.tracked_step for 5 ticks against Engine.fleet then
    update_tracks: every track field, TrackStats and the grid bit-equal;
    in f32, Fleet.forecast equals the int8 of forecast_occupancy."""
    c = (paths.fleet_cfg if dtype == "f32" else dataclasses.replace(
        paths.fleet_cfg, compute_dtype="bfloat16"))
    f, e = fleet_of(paths, c), paths.engine_of(c)
    seq = [paths.fleet_obs[i % len(paths.fleet_obs)] for i in range(5)]
    if dtype == "bf16":
        seq = to_bf16(seq)
    s, tr = f.init_states(), f.init_tracks(TCFG)
    rs, rtr = f.init_states(), f.init_tracks(TCFG)
    for i, obs in enumerate(seq):
        s, tr, out, st = f.tracked_step(s, tr, obs, DT, TCFG)
        rs, rout = e.fleet(rs, obs)
        rtr, rst = tracking.update_tracks(rtr, rout, DT, c, TCFG)
        for a, b in ((tr, rtr), (st, rst)):
            for x in dataclasses.fields(a):
                assert torch.equal(getattr(a, x.name),
                                   getattr(b, x.name)), (i, x.name)
        assert torch.equal(out.occupancy_i8, rout.occupancy_i8), i
    if dtype == "f32":
        fc = f.forecast(tr, FORECAST_HORIZONS, TCFG)
        ref = torch.round(tracking.forecast_occupancy(
            tr, FORECAST_HORIZONS, c, TCFG) * 100.0).to(torch.int8)
        assert fc.dtype == torch.int8 and torch.equal(fc, ref)


@pytest.mark.cuda
def test_fleet_run_and_checkpoint_round_trip(paths, tmp_path):
    """Fleet.run(5) equals as many calls; save_states / restore_states
    gives every field back bit for bit on its device."""
    fleet, obs = fleet_of(paths), paths.fleet_obs[0]
    run_s = fleet.run(fleet.init_states(), obs, 5)
    ref_s = fleet.init_states()
    for _ in range(5):
        ref_s, _ = fleet(ref_s, obs)
    assert torch.equal(run_s.log_odds, ref_s.log_odds)
    path = str(tmp_path / "fleet_states.npz")
    fleet.save_states(run_s, path)
    back = fleet.restore_states(path)
    for x in dataclasses.fields(back):
        got, want = getattr(back, x.name), getattr(run_s, x.name)
        assert got.device == want.device and torch.equal(got, want), x.name


def hub_extrinsics(extrinsics, n):
    """n rigs placed around the hub's world: rig r the shared extrinsics,
    then a yaw of 0.02 (r % 8) rad and a shift of (0.5 (r % 8), 0.5 (r // 8
    - n / 16)) m."""
    from grid_vision_tpu_torch.types import Extrinsics, stack
    out = []
    for r in range(n):
        c, s = math.cos(0.02 * (r % 8)), math.sin(0.02 * (r % 8))
        world = torch.eye(4, device=extrinsics.camera_to_base.device)
        world[0, 0], world[0, 1], world[1, 0], world[1, 1] = c, -s, s, c
        world[0, 3] = 0.5 * (r % 8)
        world[1, 3] = 0.5 * (r // 8 - n / 16)
        out.append(Extrinsics(
            lidar_to_camera=extrinsics.lidar_to_camera.clone(),
            camera_to_base=world @ extrinsics.camera_to_base))
    return stack(out)


def hub_cfgs(paths):
    hub = dataclasses.replace(paths.fleet_cfg, grid_backend="xla")
    return hub, dataclasses.replace(hub, **PLAIN)


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [BUDGET, None])
def test_shared_grid_agrees_with_plain(paths, budget):
    """SharedGrid (grid "xla"), every rig with its own extrinsics, 2 world
    ticks on the kernel backends against the plain ones: occupancy_i8
    >= 99.9 % and equal dropped crops; the stem, CSP and orientation
    kernels once a tick. Without a budget the world counts equal the sum
    of the rigs' lshape_hit_counts, and call_chunk(4) equals as many
    calls."""
    from grid_vision_tpu_torch.ops import rasterize
    from grid_vision_tpu_torch.parallel import RigMesh, SharedGrid
    from grid_vision_tpu_torch.parallel.shared_grid import shard_hit_counts
    from grid_vision_tpu_torch.types import stack
    from grid_vision_tpu_torch.utils import prng
    one = RigMesh([paths.engine.device])
    hub_cfg, plain_cfg = hub_cfgs(paths)
    extr_b = hub_extrinsics(paths.engine.extrinsics, N_RIGS)
    obs = paths.fleet_obs[0]
    sg, pg = (SharedGrid(c, N_RIGS, mesh=one, params=paths.nets,
                         orientation_budget=budget)
              for c in (hub_cfg, plain_cfg))

    def hub_run():
        lo, rows = sg.init_grid(), []
        for i in range(2):
            lo, occ, d = sg(lo, obs, extr_b, prng.prng_key(i))
            rows.append((occ, d))
        return rows

    rows = counted(hub_run, dict(detector_stem=2, detector_csp=2,
                                 orient_front=2))
    plo = sg.init_grid()
    for i, (occ, d) in enumerate(rows):
        plo, pocc, pd = pg(plo, obs, extr_b, prng.prng_key(i))
        assert int(d) == int(pd), i
        assert (rasterize.export_occupancy_i8(occ)
                == rasterize.export_occupancy_i8(pocc)).float().mean() \
            >= 0.999, i
    if budget is not None:
        return
    keys = sg.step_keys(prng.prng_key(0))
    poses = sg.world_poses(obs, extr_b, keys)
    counts, _ = shard_hit_counts(sg.params, obs, extr_b, keys, hub_cfg)
    per_rig = sum(rasterize.lshape_hit_counts(poses.select(r), hub_cfg)
                  for r in range(N_RIGS))
    assert torch.equal(counts, per_rig) and counts.max() > 0
    k = 4
    obs_c = stack([paths.fleet_obs[i % 3] for i in range(k)])
    lo_c, occ_c, _ = sg.call_chunk(sg.init_grid(), obs_c, extr_b,
                                   prng.prng_key(9))
    keys_c = prng.split(prng.split(prng.prng_key(9, paths.engine.device), k),
                        N_RIGS)
    lo1 = sg.init_grid()
    for t in range(k):
        lo1, occ1, _ = sg._step(lo1, obs_c.select(t), extr_b, keys_c[t])
        assert torch.equal(occ_c[t], occ1), t
    assert torch.equal(lo_c, lo1)


@pytest.mark.cuda
def test_city_grid_in_four_slabs_equals_one(paths):
    """The default CityGridSpec (4000 x 2000 cells) fed the hub's world
    poses of N_RIGS rigs for 2 ticks: one slab and four logical slabs give
    the same grid bit for bit, and the poses reach it."""
    from grid_vision_tpu_torch.parallel import CityGrid, RigMesh, SharedGrid
    from grid_vision_tpu_torch.parallel.city_grid import CityGridSpec
    from grid_vision_tpu_torch.utils import prng
    dev = paths.engine.device
    sg = SharedGrid(hub_cfgs(paths)[0], N_RIGS, mesh=RigMesh([dev]),
                    params=paths.nets)
    poses = sg.world_poses(paths.fleet_obs[0],
                           hub_extrinsics(paths.engine.extrinsics, N_RIGS),
                           sg.step_keys(prng.prng_key(0)))
    flat = type(poses)(**{x.name: getattr(poses, x.name).flatten(0, 1)
                          for x in dataclasses.fields(poses)})
    spec = CityGridSpec()
    c1, c4 = CityGrid(spec, mesh=RigMesh([dev])), CityGrid(
        spec, mesh=RigMesh([dev] * 4))
    lo1, lo4 = c1.init_grid(), c4.init_grid()
    for _ in range(2):
        lo1, occ1 = c1.update(lo1, flat)
        lo4, occ4 = c4.update(lo4, flat)
    assert torch.equal(lo1, lo4) and torch.equal(occ1, occ4)
    assert lo1.max() > 0


@pytest.mark.cuda
def test_multi_fleet_at_full_width_equals_fleets_alone(paths):
    """MultiFleet: two fleets of N_RIGS / 2 rigs on one card (f32 and
    bf16), each on its own stream, 3 ticks: step_all bit-equal to each
    fleet stepped alone (grid, occupancy_i8, boxes)."""
    from grid_vision_tpu_torch.parallel import MultiFleet, RigMesh
    dev, half = paths.engine.device, N_RIGS // 2
    bf = dataclasses.replace(paths.fleet_cfg, compute_dtype="bfloat16")
    mf = MultiFleet([paths.fleet_cfg, bf], half, mesh=RigMesh([dev, dev]),
                    params_list=[paths.nets, paths.nets],
                    extrinsics_list=[paths.engine.extrinsics] * 2)
    assert len({id(s) for s in mf.streams}) == 2
    states = mf.init_states()
    alone = [f.init_states(100 * i) for i, f in enumerate(mf.fleets)]
    for i, o in enumerate(paths.fleet_obs[:3]):
        pair = [o.select(slice(0, half)),
                dataclasses.replace(o.select(slice(half, N_RIGS)),
                                    image=o.image[half:].to(torch.bfloat16))]
        states, outs = mf.step_all(states, pair)
        refs = [f(s, x) for f, s, x in zip(mf.fleets, alone, pair)]
        alone = [r[0] for r in refs]
        for s, out, (rs, ro) in zip(states, outs, refs):
            assert torch.equal(s.log_odds, rs.log_odds), i
            assert torch.equal(out.occupancy_i8, ro.occupancy_i8), i
            assert torch.equal(out.boxes.xyxy, ro.boxes.xyxy), i


# -- the fleet server (runtime/serve.py) -------------------------------------

SERVE_TICKS = 6


@pytest.fixture(scope="module")
def served_frames(paths):
    """SERVE_TICKS ticks of the pool's 8-bit frames and clouds, a rig."""
    pool = paths.pool
    return [[(np.clip(s.image_at(t + 0.1 * i), 0, 255).astype(np.uint8),
              s.cloud_at(t + 0.1 * i)) for s, t in zip(pool.scenes, pool.t0)]
            for i in range(SERVE_TICKS)]


def serve_cfg(paths, **kw):
    """The fleet configuration with the shipped weights' absolute paths
    (the server loads them itself)."""
    fc = paths.fleet_cfg
    return dataclasses.replace(
        fc, detection_weights_file=os.path.join(ROOT,
                                                fc.detection_weights_file),
        vision_weights_file=os.path.join(ROOT, fc.vision_weights_file), **kw)


def publish(clients, frames):
    for client, (img, pts) in zip(clients, frames):
        client.publish_image(img)
        client.publish_cloud(pts)


def read(session, channel, decode):
    from grid_vision_tpu_torch.runtime import native
    box = native.ShmMailbox(native.shm_path(session, channel))
    got = box.read()
    box.close()
    assert got is not None, (session, channel)
    return decode(got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_served_fleet_publishes_fleet_grids(paths, served_frames, dtype):
    """FleetServer at N_RIGS rigs fed the pool's 8-bit frames through the
    mailboxes, SERVE_TICKS served ticks: the polled Obs is the pool's
    frames and clouds (the server's packer keeps a scan's first max_points
    points), every rig's published grid equals Fleet.__call__ on the
    polled Obs, and the server's grids equal the Fleet's; each kernel (the
    bf16 forms in bf16) once a served tick."""
    from grid_vision_tpu_torch.parallel import Fleet, RigMesh
    from grid_vision_tpu_torch.runtime.serve import (FleetClient,
                                                     FleetServer, rig_session)
    from grid_vision_tpu_torch.runtime.session import (GRID_CHANNEL,
                                                       _decode_grid)
    from grid_vision_tpu_torch.types import PointCloud
    c = serve_cfg(paths, **({} if dtype == "f32"
                            else dict(compute_dtype="bfloat16")))
    one = RigMesh([paths.engine.device])
    name = f"gvcard-{os.getpid()}-{dtype}"
    server = FleetServer(name, c, N_RIGS, mesh=one)
    clients = [FleetClient(name, r, c) for r in range(N_RIGS)]
    ref = Fleet(c, N_RIGS, mesh=one, params=paths.nets)
    try:
        publish(clients, served_frames[0])
        polled = server.poll_batch()
        assert polled.image.dtype == torch.uint8
        assert torch.equal(polled.image, torch.from_numpy(
            np.stack([f[0] for f in served_frames[0]])))
        for r, (_, pts) in enumerate(served_frames[0]):
            cl = PointCloud.pack_numpy(pts[:c.max_points], None,
                                       c.max_points)[0]
            assert torch.equal(polled.cloud.xyz[r], cl.xyz), r
            assert int(polled.cloud.count[r]) == int(cl.count), r

        def served_run():
            polls = []
            for i in range(SERVE_TICKS):
                publish(clients, served_frames[i])
                obs = server.poll_batch()
                server.step(i)
                polls.append((obs, [read(rig_session(name, r), GRID_CHANNEL,
                                         _decode_grid)[0]
                                    for r in range(N_RIGS)]))
            return polls

        polls = counted(served_run, {k: SERVE_TICKS for k in (
            FLEET_KERNELS if dtype == "f32" else BF16_KERNELS)})
        rs = ref.init_states()
        for i, (obs, grids) in enumerate(polls):
            rs, rout = ref(rs, obs.to(paths.engine.device))
            assert torch.equal(torch.from_numpy(np.stack(grids)),
                               rout.occupancy_i8.cpu()), i
        assert torch.equal(server.states.log_odds, rs.log_odds)
    finally:
        for cl in clients:
            cl.close()
        server.close()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tracked_forecast", "hub", "hub_chunk"])
def test_served_modes_publish(paths, served_frames, mode):
    """The server's other modes, 3 world ticks: tracked with a forecast at
    FORECAST_HORIZONS (planes of the grid's shape at the last step), and
    the fusion hub at chunk 1 and 4 (grid "xla": a world grid of the
    grid's shape at the last step, finite, with evidence)."""
    from grid_vision_tpu_torch.parallel import RigMesh
    from grid_vision_tpu_torch.runtime.serve import (FleetClient,
                                                     FleetServer, rig_session)
    from grid_vision_tpu_torch.runtime.session import (FORECAST_CHANNEL,
                                                       GRID_CHANNEL,
                                                       _decode_forecast,
                                                       _decode_grid)
    kw = {"tracked_forecast": dict(track=True, track_dt=DT,
                                   forecast_horizons=FORECAST_HORIZONS),
          "hub": dict(shared=True),
          "hub_chunk": dict(shared=True, chunk=4)}[mode]
    c = serve_cfg(paths, **(dict(grid_backend="xla") if kw.get("shared")
                            else {}))
    name = f"gvcard-{os.getpid()}-{mode}"
    server = FleetServer(name, c, N_RIGS, mesh=RigMesh([paths.engine.device]),
                         **kw)
    clients = [FleetClient(name, r, c) for r in range(N_RIGS)]
    steps = 3 * kw.get("chunk", 1)
    try:
        for i in range(steps):
            publish(clients, served_frames[i % SERVE_TICKS])
            server.step(i)
        if mode == "tracked_forecast":
            planes, _, step, _ = read(rig_session(name, 0), FORECAST_CHANNEL,
                                      _decode_forecast)
            assert planes.shape == (len(FORECAST_HORIZONS),) + tuple(
                c.grid_size)
        else:
            grid, step, _ = read(f"{name}-world", GRID_CHANNEL, _decode_grid)
            assert grid.shape == tuple(c.grid_size)
            assert torch.isfinite(server.world_lo).all()
            assert server.world_lo.max() > 0
        assert step == steps - 1
    finally:
        for cl in clients:
            cl.close()
        server.close()


@pytest.mark.cuda
def test_serve_cli_selftest(paths):
    """`python -m grid_vision_tpu_torch serve --selftest --rigs 2 --steps
    5` exits 0 and prints "served 5 fleet steps"."""
    proc = subprocess.run(
        [sys.executable, "-m", "grid_vision_tpu_torch", "serve", "--selftest",
         "--rigs", "2", "--steps", "5", "--name",
         f"gvcard-{os.getpid()}-cli"], capture_output=True, text=True,
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 5 fleet steps" in proc.stdout
