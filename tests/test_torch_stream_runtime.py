"""The port's streaming runtime at a reduced size, against the JAX
package where both have it: the ROI-delta encoder's keyframe / delta
sequence and bytes, plan_wire's gate, .gvr recordings across packages (a
recording made by JAX's record_scene plays in the port to JAX play's final
grid; the port's recording has JAX's frames byte for byte), the grid
codec's records; and within the port: replay_auto, LiveSource /
spin, TimedEngine (its grid equals the unsplit step's), a session
published and read back, the PointCloud2 adapter, the stats helpers and
the CLI (`python -m grid_vision_tpu_torch run|record|play --cpu`)."""

import json
import os
import subprocess
import sys
import uuid

import jax
import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io import grid_codec as jgrid_codec
from grid_vision_tpu.models import weights as jweights
from grid_vision_tpu.runtime import record as jrecord
from grid_vision_tpu.runtime.stream import \
    PackedDeltaEncoder as JaxEncoder
from grid_vision_tpu.utils import checkpoint as jcheckpoint
from grid_vision_tpu_torch import demo, pipeline, types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io import grid_codec, sensors, viz
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.runtime import live, native, record, session
from grid_vision_tpu_torch.runtime import stream, timing
from grid_vision_tpu_torch.utils import stats

torch.set_num_threads(1)

SMALL = dict(max_points=512, camera_image_height=96, camera_image_width=128,
             fx=64.0, fy=64.0, cx=64.0, cy=48.0, grid_x=24, grid_y=12,
             resolution=0.25, detection_network_input_size=64,
             network_height=64, network_width=64, orientation_width=8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engine(**kw):
    cfg = GridVisionConfig(**dict(SMALL, **kw))
    return pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                           device="cpu")


def _traffic(cfg, seed=2):
    scene = SyntheticScene(cfg, seed=seed)
    scene.add_default_traffic()
    return scene


def test_delta_encoder_sequence_equals_jax():
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    scene = _traffic(cfg)
    enc = stream.PackedDeltaEncoder(cfg, keyframe_interval=8)
    jenc = JaxEncoder(jcfg, keyframe_interval=8)
    keys = []
    for i in range(14):
        img, xyz, inten, n, _ = stream._scene_frame(scene, i / 10.0, cfg)
        key, buf = enc.encode(img, xyz, inten, n, True, n > 0)
        jkey, jbuf = jenc.encode(img, xyz, inten, n, True, n > 0)
        assert key == jkey, i
        np.testing.assert_array_equal(buf, jbuf)
        keys.append(key)
    assert keys[0] and not all(keys) and sum(keys) >= 2, keys
    assert (enc.keyframes, enc.deltas) == (jenc.keyframes, jenc.deltas)


def test_delta_encoder_drift_bounded():
    """Sub-threshold drift never accumulates past `threshold` in what the
    decoder (unpack_delta) reconstructs."""
    cfg = GridVisionConfig(**SMALL)
    enc = stream.PackedDeltaEncoder(cfg, threshold=2)
    xyz = np.full((cfg.max_points, 3), types.PointCloud.PAD_SENTINEL,
                  np.float32)
    inten = np.zeros((cfg.max_points,), np.float32)
    recon = torch.zeros((96, 128, 3), dtype=torch.uint8)
    for i in range(12):
        img = np.full((96, 128, 3), 10 * (i + 1) // 10 + i, np.uint8)
        key, buf = enc.encode(img, xyz, inten, 0, True, False)
        buf = torch.from_numpy(buf)
        obs = (types.Obs.unpack(buf, cfg) if key
               else types.unpack_delta(buf, recon, cfg))
        recon = obs.image
        err = np.abs(recon.numpy().astype(np.int16) - img).max()
        assert err <= enc.threshold, (i, err)
    assert enc.keyframes >= 2


def test_plan_wire_gate_and_crossover():
    cfg = GridVisionConfig(**SMALL)
    scene = _traffic(cfg)
    slow = stream.plan_wire(cfg, scene, 1e6, sample=8)
    assert slow.bytes_delta_expected < slow.bytes_full
    assert slow.keyframe_frac < 1.0
    assert slow.mode == "delta", slow
    assert stream.plan_wire(cfg, scene, 1e12, sample=8).mode == "full"
    # encode_s is a wall-clock measurement, so the crossover moves from
    # call to call: each plan follows its own, and 100x margins around the
    # first plan's crossover decide either way
    below = stream.plan_wire(cfg, scene, slow.crossover_bw_bytes_s / 100,
                             sample=8)
    above = stream.plan_wire(cfg, scene, slow.crossover_bw_bytes_s * 100,
                             sample=8)
    assert below.mode == "delta" and above.mode == "full"
    for plan in (slow, below, above):
        assert plan.mode == ("delta" if plan.link_bw_bytes_s
                             < plan.crossover_bw_bytes_s else "full")
    assert slow.est_hz_delta > slow.est_hz_full
    assert slow.bytes_full == types.Obs.packed_nbytes(cfg)
    yuv = GridVisionConfig(**SMALL, wire_image_codec="yuv420")
    plan = stream.plan_wire(yuv, _traffic(yuv), 1.0, sample=4)
    assert plan.mode == "full" and plan.crossover_bw_bytes_s == 0.0


def test_replay_auto_dispatches_by_plan():
    def run(bw):
        eng = _engine()
        return stream.replay_auto(eng, _traffic(eng.cfg), n_steps=5,
                                  link_bw_bytes_s=bw)

    plan_slow, res_slow = run(1e5)
    plan_fast, res_fast = run(1e12)
    assert plan_slow.mode == "delta" and plan_fast.mode == "full"
    assert torch.equal(res_slow.final_state.log_odds,
                       res_fast.final_state.log_odds)
    assert stream.probe_link_bandwidth("cpu", reps=2, big=1 << 20) > 0


def test_replay_typed_equals_packed():
    eng = _engine()
    seen = []
    typed = stream.replay(eng, _traffic(eng.cfg), n_steps=4, packed=False,
                          on_step=lambda i, s, o: seen.append(i))
    packed = stream.replay(eng, _traffic(eng.cfg), n_steps=4)
    assert seen == [0, 1, 2, 3] and typed.achieved_hz > 0
    assert torch.equal(typed.final_state.log_odds,
                       packed.final_state.log_odds)
    assert [s.step for s in packed.stats] == [0, 1, 2, 3]


def _shared_weights(tmp_path):
    """Random weights of both nets, the detector heads scaled so that a
    few anchors clear 0.6, saved as npz checkpoints that both packages
    load."""
    tree = jax.tree_util.tree_map(
        np.asarray, jweights.init_all(JaxConfig(**SMALL), seed=3))
    for head in ("head_13", "head_26"):
        p = tree["detector"]["params"][head]
        p["kernel"] = p["kernel"] * 150.0
    paths = {}
    for key in ("detector", "orientation"):
        paths[key] = str(tmp_path / f"{key}.npz")
        jcheckpoint.save(paths[key], tree[key])
    return dict(detection_weights_file=paths["detector"],
                vision_weights_file=paths["orientation"])


def test_jax_recording_plays_in_the_port(tmp_path):
    w = _shared_weights(tmp_path)
    jcfg = JaxConfig(**SMALL, **w)
    path = str(tmp_path / "jax.gvr")
    assert jrecord.record_scene(path, jcfg, n_steps=5, seed=4) == 5
    n_jax, jstate = jrecord.play(path, chunk=3)
    boxes = []
    n, state = record.play(path, chunk=3, device="cpu",
                           on_step=lambda i, s, o: boxes.append(
                               int(o.boxes.valid.sum())))
    assert n == n_jax == 5
    np.testing.assert_array_equal(state.log_odds.numpy(),
                                  np.asarray(jstate.log_odds))
    assert sum(boxes) > 0
    n2, chunked = record.play(path, chunk=2, device="cpu")
    assert n2 == 5 and torch.equal(chunked.log_odds, state.log_odds)


def test_port_recording_equals_jax_recording(tmp_path):
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    ours, theirs = str(tmp_path / "port.gvr"), str(tmp_path / "jax.gvr")
    assert record.record_scene(ours, cfg, n_steps=4, seed=5) == 4
    jrecord.record_scene(theirs, jcfg, n_steps=4, seed=5)
    with record.RecordReader(ours) as r, jrecord.RecordReader(theirs) as jr:
        assert r.n_frames == jr.n_frames == 4
        assert r.frame_nbytes == jr.frame_nbytes
        for i in range(4):
            (a, sa), (b, sb) = r.read(i), jr.read(i)
            np.testing.assert_array_equal(a, b)
            assert sa == sb
    heads = []
    for p in (ours, theirs):
        with open(p, "rb") as f:
            f.read(4)
            n = int.from_bytes(f.read(4), "little")
            heads.append(json.loads(f.read(n)))
    assert heads[0] == heads[1]
    with jrecord.RecordReader(ours) as jr:
        assert jr.cfg == jcfg
    with pytest.raises(ValueError):
        bad = tmp_path / "junk.gvr"
        bad.write_bytes(b"NOPE" + b"\x00" * 64)
        record.RecordReader(str(bad))
    with record.RecordWriter(str(tmp_path / "x.gvr"), cfg) as wr:
        with pytest.raises(ValueError):
            wr.write(np.zeros(13, np.uint8))


def test_play_grid_out_and_session(tmp_path):
    cfg = GridVisionConfig(**SMALL)
    path = str(tmp_path / "d.gvr")
    record.record_scene(path, cfg, n_steps=3, seed=1)
    grids = []
    name = f"gvtest{uuid.uuid4().hex[:8]}"
    n, state = record.play(path, device="cpu", grid_out=str(
        tmp_path / "g.gvg"), session=name, on_step=lambda i, s, o:
        grids.append(o.occupancy_i8.numpy().copy()))
    try:
        sub = session.SessionSubscriber(name)
        frame = sub.poll()
        np.testing.assert_array_equal(frame.grid, grids[-1])
        assert frame.step == 2 and isinstance(frame.markers, list)
        assert frame.grid_meta["size"] == list(cfg.grid_size)
        sub.close()
    finally:
        for ch in ("grid", "markers", "overlay"):
            p = native.shm_path(name, ch)
            if os.path.exists(p):
                os.unlink(p)
    with grid_codec.GridRecordReader(str(tmp_path / "g.gvg")) as r:
        got = [g for g, _s, _t in r]
    assert len(got) == 3
    for a, b in zip(got, grids):
        np.testing.assert_array_equal(a, b)


def test_session_overlay_and_markers():
    eng = _engine()
    scene = _traffic(eng.cfg)
    obs = stream.obs_from_scene(scene, 0.0, eng.cfg, "cpu")
    _, out = eng(eng.init_state(), obs)
    name = f"gvtest{uuid.uuid4().hex[:8]}"
    pub = session.SessionPublisher(name, eng.cfg)
    try:
        pub.publish(7, out, image=obs.image,
                    cloud_xyz=scene.cloud_at(0.0)[:100])
        frame = session.SessionSubscriber(name).poll()
        assert frame.step == 7
        np.testing.assert_array_equal(frame.grid, out.occupancy_i8.numpy())
        assert frame.overlay.shape == (96, 128, 3)
        assert frame.cloud.shape == (100, 3)
        assert frame.markers == viz.markers_from_output(out)
    finally:
        pub.unlink()


def test_grid_codec_records_equal_to_jax():
    rng = np.random.default_rng(0)
    enc, jenc = grid_codec.GridDeltaEncoder(4), jgrid_codec.GridDeltaEncoder(4)
    dec = grid_codec.GridDeltaDecoder()
    g = np.full((50, 20), 50, np.int8)
    for i in range(9):
        g = g.copy()
        g[rng.integers(0, 50), rng.integers(0, 20)] = rng.integers(0, 101)
        rec = enc.encode(g, step=i)
        assert rec == jenc.encode(g, step=i)
        np.testing.assert_array_equal(dec.decode(rec)[0], g)


def test_live_source_latest_wins_and_spin():
    cfg = GridVisionConfig(**dict(SMALL, use_vision_orientation=False))
    src = live.LiveSource(cfg=cfg, image_box=native.Mailbox(),
                          cloud_box=native.Mailbox(), device="cpu")
    obs = src.poll()
    assert not bool(obs.has_image) and not bool(obs.has_cloud)
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    img2 = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    src.publish_image(img1, 1)
    src.publish_image(img2, 2)
    xyz = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    src.publish_cloud(xyz)
    obs = src.poll()
    assert bool(obs.has_image) and bool(obs.has_cloud)
    np.testing.assert_array_equal(obs.image.numpy(), img2)   # the latest
    assert int(obs.cloud.count) == 100
    np.testing.assert_allclose(obs.cloud.xyz[:100].numpy(), xyz)

    eng = pipeline.Engine(cfg, extrinsics=demo.default_extrinsics("cpu"),
                          device="cpu")
    grids = []
    state = live.spin(eng, src, period_s=0.0, max_steps=3,
                      on_step=lambda i, s, o: grids.append(i))
    assert int(state.step) == 3 and grids == [0, 1, 2]
    empty = live.LiveSource(cfg=cfg, image_box=native.Mailbox(),
                            cloud_box=native.Mailbox(), device="cpu")
    state = live.spin(eng, empty, period_s=0.0, max_steps=2)
    # no inputs: the Q1 gate skips the update, decay included
    assert torch.equal(state.log_odds, eng.init_state().log_odds)


def test_mailboxes_apart_from_the_jax_packages():
    """Both bindings in one process: each loads its own copy of the host
    library, so a frame written through one package's mailbox leaves the
    other library's slot of the same number untouched (the JAX package's
    tests count on empty slots)."""
    from grid_vision_tpu.runtime import native as jnative
    lib, jlib = native._load(), jnative._load()
    if lib is None or jlib is None:
        pytest.skip("no C++ compiler for runtime_cc/")
    assert lib._handle != jlib._handle
    ours, theirs = native.Mailbox(), jnative.Mailbox()
    before = jlib.gv_mailbox_seq(ours._id)
    ours.write(b"port", 1)
    assert jlib.gv_mailbox_seq(ours._id) == before
    before = lib.gv_mailbox_seq(theirs._id)
    theirs.write(b"jax", 2)
    assert lib.gv_mailbox_seq(theirs._id) == before
    assert ours.read() == (b"port", 1) and theirs.read() == (b"jax", 2)


@pytest.mark.parametrize("vision", [True, False])
def test_timed_engine_grid_equals_fused_step(vision):
    eng = _engine(use_vision_orientation=vision)
    timed = timing.TimedEngine(eng)
    scene = SyntheticScene(eng.cfg, seed=0, n_ground=1500)
    scene.add_default_traffic()
    sa = sb = eng.init_state()
    for i in range(2):
        obs = stream.obs_from_scene(scene, i / 10.0, eng.cfg, "cpu")
        sa, out_a = eng(sa, obs)
        sb, out_b, times = timed.step(sb, obs)
        assert times.detect_ms > 0 and times.fuse_ms > 0
        assert "2D detection" in str(times)
        assert torch.equal(out_a.occupancy_i8, out_b.occupancy_i8)
    assert torch.equal(sa.log_odds, sb.log_odds)
    assert torch.equal(sa.rng, sb.rng)


def test_pointcloud2_adapter():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (50, 4)).astype(np.float32)
    msg = {"fields": [("x", 0, 7), ("y", 4, 7), ("z", 8, 7),
                      ("intensity", 12, 7)],
           "point_step": 16, "width": 50, "height": 1,
           "data": pts.tobytes()}
    cloud = sensors.pointcloud2_to_cloud(msg, capacity=64, device="cpu")
    assert int(cloud.count) == 50
    np.testing.assert_allclose(cloud.xyz[:50].numpy(), pts[:, :3])
    np.testing.assert_allclose(cloud.intensity[:50].numpy(), pts[:, 3])
    assert (cloud.xyz[50:] == types.PointCloud.PAD_SENTINEL).all()
    img = sensors.image_to_array({"height": 2, "width": 2,
                                  "encoding": "bgr8",
                                  "data": bytes(range(12))})
    assert img.dtype == np.float32 and img[0, 0].tolist() == [2, 1, 0]


def test_stats_helpers(tmp_path, caplog):
    import logging
    with caplog.at_level(logging.INFO, logger="grid_vision_tpu_torch"):
        stats.StepStats(step=3, dispatch_s=0.002).log()
        with stats.stage_timer("detect"):
            pass
    assert "step=3" in caplog.text and "detect took" in caplog.text
    with stats.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(4).sum()
    assert prof is not None
    assert os.path.exists(tmp_path / "trace" / "trace.json")


def _cli(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "grid_vision_tpu_torch",
                           *args], capture_output=True, text=True, cwd=cwd,
                          env=env, timeout=300)


def test_cli_run_record_play(tmp_path):
    r = _cli("run", "--cpu", "--steps", "3", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "replayed 3 steps" in r.stderr
    gvr = str(tmp_path / "d.gvr")
    r = _cli("record", "--out", gvr, "--steps", "3", cwd=ROOT)
    assert r.returncode == 0 and "recorded 3 frames" in r.stdout, r.stderr
    r = _cli("play", gvr, "--cpu", "--chunk", "2", cwd=ROOT)
    assert r.returncode == 0 and "played 3 frames" in r.stdout, r.stderr


def test_cli_refuses_what_is_not_ported(tmp_path):
    # run --track is ported: the tracker runs and logs its tracks each tick
    r = _cli("run", "--cpu", "--track", "--steps", "3", cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stderr.count("confirmed tracks") == 3, r.stderr
    # serve is ported since the parallel layer (tests/test_torch_serve.py),
    # view, demo and bench since the CLI's last slice
    # (tests/test_torch_demo_cli.py): view asks for its session
    r = _cli("view", cwd=ROOT)
    assert r.returncode == 2 and "--session" in r.stderr
    assert "not ported" not in r.stderr
    # the resnet orientation arch trains too (nothing of the CLI is refused
    # any more; tests/test_torch_train_cli_orientation.py holds its file)
    r = _cli("train", "orientation", "--arch", "resnet", "--cpu", "--steps",
             "2", "--scan", "1", "--batch", "2", "--input-size", "32",
             "--width", "8", "--out", str(tmp_path / "r.npz"), cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "angle recovery" in r.stdout and "not in the torch port" not in (
        r.stdout + r.stderr)
