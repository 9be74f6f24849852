"""The port's fleet server (grid_vision_tpu_torch/runtime/serve.py):
mailboxes in, the fleet tick, per-rig sessions out. The cases of
tests/test_serve.py on the port (the selftest round trip, the Q1 gate for
a rig nobody feeds, garbage payloads, the fusion hub and its chunked mode,
the oversize-cloud clamp, unlinking, the saturation telemetry, the tracked
and forecast modes and their refusals), plus: the grid each rig's session
publishes equals the JAX package's FleetServer's for the same mailbox
frames (the shipped weights on both sides), and equals Fleet.__call__ on
the polled Obs; the uint8 frames the server keeps give the f32 frames'
outputs bit for bit; the CLI in a subprocess.

Session names start with "gvtorch-" and end with a random suffix of their
own (session_name): mailbox names are shared-memory paths, which
tests/test_serve.py under xdist and any other run on the same machine share.
"""

import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest
import torch

from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.runtime.serve import FleetClient as JaxFleetClient
from grid_vision_tpu.runtime.serve import FleetServer as JaxFleetServer
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io.scene import SyntheticScene
from grid_vision_tpu_torch.parallel import RigMesh
from grid_vision_tpu_torch.runtime import native
from grid_vision_tpu_torch.runtime.serve import (FleetClient, FleetServer,
                                                 rig_session,
                                                 selftest_producers)
from grid_vision_tpu_torch.runtime.session import (FORECAST_CHANNEL,
                                                   GRID_CHANNEL,
                                                   MARKERS_CHANNEL,
                                                   _decode_forecast,
                                                   _decode_grid)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH2 = RigMesh(["cpu", "cpu"])
SMALL = dict(max_points=2048, camera_image_height=96, camera_image_width=128,
             fx=64.0, fy=64.0, cx=64.0, cy=48.0, grid_x=24, grid_y=12,
             resolution=0.25)
SHIPPED = dict(detection_weights_file=os.path.join(ROOT, "weights",
                                                   "detector.npz"),
               vision_weights_file=os.path.join(ROOT, "weights",
                                                "orientation.npz"))


def session_name(tag):
    """A session name no other run on the machine uses."""
    return f"gvtorch-{tag}-{uuid.uuid4().hex[:8]}"


def small_cfg(**kw):
    return GridVisionConfig(**SMALL, **kw)


def read_grid(session):
    box = native.ShmMailbox(native.shm_path(session, GRID_CHANNEL))
    frame = box.read()
    box.close()
    assert frame is not None, f"{session} published no grid"
    return _decode_grid(frame[0])


def test_fleet_server_selftest_roundtrip():
    cfg = small_cfg()
    name = session_name("serve")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    stop = threading.Event()
    try:
        selftest_producers(name, cfg, 2, hz=20.0, stop=stop)
        time.sleep(0.3)   # let producers write first frames
        server.spin(steps=4, hz=50.0)
        for r in range(2):
            grid, step, _ = read_grid(rig_session(name, r))
            assert grid.shape == cfg.grid_size
            assert step == 3
            assert (grid >= 0).all() and (grid <= 100).all()
    finally:
        stop.set()
        server.close()


def test_fleet_server_q1_gate_without_producer():
    """A rig nobody feeds keeps its prior grid (Q1: no inputs -> no update,
    not even decay)."""
    cfg = small_cfg()
    name = session_name("serve-q1")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    try:
        client = FleetClient(name, 0, cfg)
        client.publish_image(np.full((96, 128, 3), 120, np.uint8))
        client.publish_cloud(np.random.default_rng(0).uniform(
            -5, 5, (500, 3)).astype(np.float32))
        client.close()
        server.spin(steps=2, hz=50.0)
        lo = server.states.log_odds.numpy()
        assert not np.allclose(lo[0], 0.0)        # the fed rig updated
        np.testing.assert_array_equal(lo[1], 0.0)  # the unfed one: Q1
    finally:
        server.close()


def test_fleet_server_survives_garbage_payloads():
    cfg = small_cfg()
    name = session_name("serve-garbage")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    try:
        img_box = native.ShmMailbox(
            native.shm_path(rig_session(name, 0), "image"))
        cloud_box = native.ShmMailbox(
            native.shm_path(rig_session(name, 0), "cloud"))
        img_box.write(b"\x01\x02\x03")           # wrong size
        cloud_box.write(b"\x00" * 13)            # not a 16-byte stride
        img_box.close()
        cloud_box.close()
        server.spin(steps=2, hz=50.0)
        # latest-wins: the same bad frame is polled every tick
        assert server.parse_errors >= 2
        np.testing.assert_array_equal(server.states.log_odds.numpy(), 0.0)
    finally:
        server.close()


@pytest.mark.parametrize("chunk", [1, 4])
def test_fusion_hub_publishes_world_grid(chunk):
    """shared=True: every rig fuses into one world grid, session
    <name>-world; chunk=4 runs 4 world ticks a call (8 polls -> 2 calls,
    published at polls 3 and 7)."""
    cfg = small_cfg()
    name = session_name(f"hub-{chunk}")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2, shared=True,
                         chunk=chunk)
    stop = threading.Event()
    try:
        selftest_producers(name, cfg, 2, hz=50.0, stop=stop)
        time.sleep(0.3)
        server.spin(steps=8 if chunk > 1 else 3, hz=200.0)
        grid, step, _ = read_grid(f"{name}-world")
        assert grid.shape == cfg.grid_size
        assert step == (7 if chunk > 1 else 2)
        lo = server.world_lo.numpy()
        assert np.isfinite(lo).all() and not np.allclose(lo, 0.0)
        assert server.dropped_total == 0
    finally:
        stop.set()
        server.close()


def test_oversize_cloud_is_clamped_not_fatal():
    cfg = small_cfg()
    name = session_name("serve-oversize")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    try:
        client = FleetClient(name, 0, cfg)
        cap_pts = int(client._cloud.capacity) // 16
        n = 10 * cap_pts
        cloud = np.random.default_rng(1).uniform(-20, 20, (n, 3)).astype(
            np.float32)
        client.publish_cloud(cloud, intensity=np.ones(n, np.float32))
        assert client.frames_clamped == 1
        assert client.points_dropped == n - cap_pts
        client.publish_image(np.full((96, 128, 3), 90, np.uint8))
        client.close()
        server.spin(steps=2, hz=100.0)
        lo = server.states.log_odds.numpy()
        assert np.isfinite(lo).all() and not np.allclose(lo[0], 0.0)
        client2 = FleetClient(name, 0, cfg)
        client2.publish_cloud(cloud[:100])
        assert client2.frames_clamped == 0
        client2.close()
    finally:
        server.close()


def test_server_close_unlinks_sensor_mailboxes():
    cfg = small_cfg()
    name = session_name("serve-unlink")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    paths = [native.shm_path(rig_session(name, r), ch)
             for r in range(2) for ch in ("image", "cloud")]
    assert all(os.path.exists(p) for p in paths)
    server.close(unlink=True)
    for p in paths:
        assert not os.path.exists(p), f"stale mailbox left behind: {p}"


def test_selftest_surfaces_saturation_telemetry():
    cfg = small_cfg()
    name = session_name("serve-sat")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    stop = threading.Event()
    try:
        selftest_producers(name, cfg, 2, hz=20.0, stop=stop)
        time.sleep(0.3)
        server.spin(steps=3, hz=50.0)
        sat = server.saturation_totals
        assert set(sat) == {"prenms_overflow", "orientation_clamped",
                            "box_cloud_truncated", "orientation_dropped",
                            "static_depth_clamped"}
        assert all(isinstance(v, int) and v >= 0 for v in sat.values())
    finally:
        stop.set()
        server.close()


def test_fleet_server_tracked_and_forecast_modes():
    """track=True: the tracker runs after each tick, sessions carry
    stable-id track markers and the telemetry sums; forecast_horizons: each
    rig's session carries K int8 planes on the grid raster."""
    cfg = small_cfg(**SHIPPED)
    name = session_name("serve-trk")
    horizons = (0.5, 1.5)
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2, track=True,
                         track_dt=0.05, forecast_horizons=horizons)
    stop = threading.Event()
    try:
        selftest_producers(name, cfg, 2, hz=20.0, stop=stop)
        time.sleep(0.3)
        server.spin(steps=4, hz=50.0)
        assert server.tracks.id.shape[0] == 2
        tt = server.track_totals
        assert set(tt) == {"matched", "spawned", "killed", "spawn_dropped"}
        assert all(isinstance(v, int) and v >= 0 for v in tt.values())
        assert tt["spawned"] > 0, "the shipped detector found nothing"
        for r in range(2):
            session = rig_session(name, r)
            box = native.ShmMailbox(native.shm_path(session,
                                                    MARKERS_CHANNEL))
            frame = box.read()
            box.close()
            payload = json.loads(frame[0].decode())
            for m in payload["markers"]:
                if m.get("ns") == "track":
                    assert isinstance(m["track_id"], int)
            box = native.ShmMailbox(native.shm_path(session,
                                                    FORECAST_CHANNEL))
            frame = box.read()
            box.close()
            planes, got_h, step, _ = _decode_forecast(frame[0])
            assert planes.shape == (2,) + cfg.grid_size and step == 3
            np.testing.assert_allclose(got_h, horizons)
            assert (planes >= 0).all() and (planes <= 100).all()
    finally:
        stop.set()
        server.close()


@pytest.mark.parametrize("shared", [False, True])
def test_step_timings_split(shared):
    """step(i, timings) fills the served tick's split: poll, upload, tick
    and publish, each a non-negative ms of this step, the same grids as a
    step without timings."""
    cfg = small_cfg()
    name = session_name(f"timings-{int(shared)}")
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2, shared=shared)
    try:
        client = FleetClient(name, 0, cfg)
        client.publish_image(np.full((96, 128, 3), 120, np.uint8))
        client.publish_cloud(np.random.default_rng(0).uniform(
            -5, 5, (500, 3)).astype(np.float32))
        client.close()
        server.step(0)
        before = (server.world_lo if shared else server.states.log_odds)
        timings = {}
        server.step(1, timings)
        assert set(timings) == {"poll_ms", "upload_ms", "tick_ms",
                                "publish_ms"}
        assert all(v >= 0.0 for v in timings.values())
        after = (server.world_lo if shared else server.states.log_odds)
        assert not torch.equal(before, after)
    finally:
        server.close()


def test_mode_refusals():
    cfg = small_cfg()
    with pytest.raises(ValueError, match="fleet mode"):
        FleetServer(session_name("bad1"), cfg, 2, mesh=MESH2, shared=True,
                    track=True)
    with pytest.raises(ValueError, match="requires track"):
        FleetServer(session_name("bad2"), cfg, 2, mesh=MESH2,
                    forecast_horizons=(1.0,))
    with pytest.raises(ValueError, match="requires shared"):
        FleetServer(session_name("bad3"), cfg, 2, mesh=MESH2, chunk=4)


def test_published_grid_equals_jax_server_and_fleet():
    """The same 8-bit frames and clouds into the JAX package's server and
    the port's (shipped weights): every rig's published grid is equal, and
    equal to the port's Fleet on the polled Obs; the uint8 frames give the
    f32 frames' outputs bit for bit."""
    cfg = small_cfg(**SHIPPED)
    jcfg = JaxConfig(**SMALL, **SHIPPED)
    name, jname = session_name("serve-eq"), session_name("serve-eq-jax")
    import jax
    from jax.sharding import Mesh
    server = FleetServer(name, cfg, n_rigs=2, mesh=MESH2)
    jserver = JaxFleetServer(jname, jcfg, n_rigs=2,
                             mesh=Mesh(np.array(jax.devices()[:2]), ("rig",)))
    try:
        for r in range(2):
            scene = SyntheticScene(cfg, seed=r)
            scene.add_default_traffic()
            img = np.clip(scene.image_at(0.3), 0, 255).astype(np.uint8)
            pts = scene.cloud_at(0.3)
            for client in (FleetClient(name, r, cfg),
                           JaxFleetClient(jname, r, jcfg)):
                client.publish_image(img)
                client.publish_cloud(pts)
                client.close()
        obs = server.poll_batch()
        assert obs.image.dtype == torch.uint8
        server.step(0)
        jserver.step(0)
        _, outs = server.fleet(server.fleet.init_states(), obs)
        boxes = 0
        for r in range(2):
            grid, _, _ = read_grid(rig_session(name, r))
            jgrid, _, _ = read_grid(rig_session(jname, r))
            np.testing.assert_array_equal(grid, jgrid)
            np.testing.assert_array_equal(grid,
                                          outs.occupancy_i8[r].numpy())
            boxes += int(outs.boxes.valid[r].sum())
        assert boxes > 0, "the shipped detector found nothing"
        np.testing.assert_array_equal(server.states.log_odds.numpy(),
                                      np.asarray(jserver.states.log_odds))
        # uint8 frames against f32 frames
        f32 = type(obs)(image=obs.image.float(), cloud=obs.cloud,
                        has_image=obs.has_image, has_cloud=obs.has_cloud)
        s8, o8 = server.fleet(server.fleet.init_states(), obs)
        s32, o32 = server.fleet(server.fleet.init_states(), f32)
        assert torch.equal(s8.log_odds, s32.log_odds)
        assert torch.equal(o8.occupancy_i8, o32.occupancy_i8)
        assert torch.equal(o8.boxes.xyxy, o32.boxes.xyxy)
        torch.testing.assert_close(o8.poses.position, o32.poses.position,
                                   rtol=0, atol=0, equal_nan=True)
    finally:
        server.close()
        jserver.close()


def test_mailboxes_beyond_the_native_table():
    """The native library holds 256 mailboxes a process, and a 64-rig
    server needs more (128 sensor mailboxes, two or three session channels
    a rig): the rest take the Python mmap path, whose layout is the
    library's, so either side reads what the other wrote."""
    base = session_name("many")
    paths = [native.shm_path(f"{base}-{i}", "x") for i in range(300)]
    boxes = [native.ShmMailbox(p, capacity=16, create=True) for p in paths]
    try:
        assert boxes[-1]._h < 0, "the last mailbox should take the Python path"
        for i, b in enumerate(boxes):
            b.write(i.to_bytes(4, "little"))
        readers = [native.ShmMailbox(paths[i]) for i in (0, 299)]
        assert [int.from_bytes(r.read()[0], "little") for r in readers] == \
            [0, 299]
        for r in readers:
            r.close()
        for b in boxes[1:]:
            b.close()
        # a native reader of a mailbox the Python path wrote
        late = native.ShmMailbox(paths[299])
        assert int.from_bytes(late.read()[0], "little") == 299
        late.close()
    finally:
        for b in boxes:
            b.unlink()


def test_cli_serve_selftest():
    name = session_name("cli")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "grid_vision_tpu_torch", "serve", "--cpu",
         "--selftest", "--rigs", "2", "--steps", "3", "--name",
         name], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 fleet steps" in proc.stdout
    assert not os.path.exists(native.shm_path(rig_session(name, 0),
                                              "image"))
