"""The port's viewer (runtime/viewer.py, io/png.py) against the JAX
package's on the same data: one StepOutput (grid with unknown cells, two
cube poses, a traffic light and a speed sign, boxes for the overlay, a
cloud) published through the port's SessionPublisher and through JAX's,
each viewed by its own package's viewer. Equal: the PNG bytes and their
decode, grid_frame_rgb (scale 1 and 2), ansi_halfblock, view3d_frame_rgb,
and over HTTP the /grid.png bytes, /markers.json, one /grid.gvd record
(bytes and decode through gvd_client) and a /forecast.gvd record. The
session mailboxes live in the test's tmp_path (shm_path patched), so
parallel workers never share one.
"""

import io
import json
import socket
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grid_vision_tpu import types as jtypes
from grid_vision_tpu.config import GridVisionConfig as JaxConfig
from grid_vision_tpu.io import grid_codec as jcodec
from grid_vision_tpu.io import png as jpng
from grid_vision_tpu.runtime import native as jnative
from grid_vision_tpu.runtime import session as jsession
from grid_vision_tpu.runtime import viewer as jviewer
from grid_vision_tpu_torch import types
from grid_vision_tpu_torch.config import GridVisionConfig
from grid_vision_tpu_torch.io import png
from grid_vision_tpu_torch.runtime import native, session, viewer

torch.set_num_threads(1)

SMALL = dict(grid_x=24, grid_y=12, resolution=0.25, max_points=128,
             max_detections=8, camera_image_height=48,
             camera_image_width=64, fx=32.0, fy=32.0, cx=32.0, cy=24.0)


def output_arrays(cfg, seed=0):
    """A tick's outputs as numpy arrays (field name -> array)."""
    rng = np.random.default_rng(seed)
    gx, gy = cfg.grid_size
    grid = rng.integers(-1, 101, (gx, gy)).astype(np.int8)
    grid[10:20, 5:15] = 90
    n, cap = cfg.max_detections, 8
    pos = np.zeros((cap, 3), np.float32)
    quat = np.tile(np.float32([0, 0, 0, 1]), (cap, 1))
    length, width, height = (np.zeros(cap, np.float32) for _ in range(3))
    pos[:2] = [[10.0, 0.0, 0.6], [14.0, 3.0, 0.7]]
    quat[1] = [0, 0, np.sin(0.3), np.cos(0.3)]
    length[:2], width[:2], height[:2] = [4.0, 4.5], [2.0, 1.8], [1.5, 1.4]
    pvalid = np.zeros(cap, bool)
    pvalid[:2] = True
    xyxy = np.zeros((n, 4), np.float32)
    xyxy[:2] = [[4, 6, 30, 28], [35, 10, 60, 40]]
    bvalid = np.zeros(n, bool)
    bvalid[:2] = True
    sxyxy = np.zeros((n, 4), np.float32)
    svalid = np.zeros(n, bool)
    svalid[:2] = True
    slabel = np.full(n, 10, np.int32)
    slabel[:2] = [5, 7]          # traffic light red, speed sign 60
    spts = np.zeros((n, 3), np.float32)
    spts[:2] = [[12.0, -2.0, 2.5], [8.0, 4.0, 1.0]]
    return dict(
        grid=grid, pos=pos, quat=quat, length=length, width=width,
        height=height, pvalid=pvalid, xyxy=xyxy, bvalid=bvalid,
        conf=np.where(bvalid, 0.9, 0.0).astype(np.float32),
        blabel=np.where(bvalid, 9, 10).astype(np.int32), sxyxy=sxyxy,
        svalid=svalid, slabel=slabel, spts=spts,
        image=rng.uniform(0, 255, (cfg.camera_image_height,
                                   cfg.camera_image_width, 3)
                          ).astype(np.float32),
        cloud=rng.uniform([-5, -5, -0.5], [25, 5, 2.5],
                          (300, 3)).astype(np.float32),
        forecast=rng.integers(0, 101, (3, gx, gy)).astype(np.int8))


def _build(mod, asarray, a):
    """The StepOutput of package `mod` (types module) from output_arrays."""
    z = asarray(np.zeros((), np.int32))
    return mod.StepOutput(
        boxes=mod.Boxes(xyxy=asarray(a["xyxy"]), confidence=asarray(a["conf"]),
                        label=asarray(a["blabel"]), valid=asarray(a["bvalid"])),
        poses=mod.LShapePoses(
            position=asarray(a["pos"]), quat=asarray(a["quat"]),
            length=asarray(a["length"]), width=asarray(a["width"]),
            height=asarray(a["height"]),
            label=asarray(np.full(8, 9, np.int32)),
            valid=asarray(a["pvalid"])),
        static_points=asarray(a["spts"]),
        static_depths=asarray(np.where(a["svalid"], 10.0, -1.0).astype(
            np.float32)),
        static_boxes=mod.Boxes(
            xyxy=asarray(a["sxyxy"]),
            confidence=asarray(np.where(a["svalid"], 0.9, 0.0).astype(
                np.float32)),
            label=asarray(a["slabel"]), valid=asarray(a["svalid"])),
        occupancy_i8=asarray(a["grid"]),
        saturation=mod.SaturationStats(prenms_overflow=z,
                                       orientation_clamped=z,
                                       box_cloud_truncated=z,
                                       orientation_dropped=z,
                                       static_depth_clamped=z))


def port_output(a):
    return _build(types, torch.from_numpy, a)


def jax_output(a):
    return _build(jtypes, jnp.asarray, a)


@pytest.fixture
def sessions(monkeypatch, tmp_path):
    """The same tick published by each package into its own session (the
    mailboxes under tmp_path): (port frame, JAX frame, arrays)."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "shm_path", lambda s, ch: str(
            tmp_path / f"{s}.{ch}.mbx"))
    cfg, jcfg = GridVisionConfig(**SMALL), JaxConfig(**SMALL)
    a = output_arrays(cfg)
    pubs = [(session.SessionPublisher("port", cfg), port_output(a)),
            (jsession.SessionPublisher("jax", jcfg), jax_output(a))]
    for pub, out in pubs:
        pub.publish(3, out, image=a["image"], stamp_ns=1234,
                    cloud_xyz=a["cloud"], forecast=a["forecast"],
                    horizons=(0.5, 1.0, 2.0))
    frame = session.SessionSubscriber("port").poll()
    jframe = jsession.SessionSubscriber("jax").poll()
    yield frame, jframe, a
    for pub, _ in pubs:
        pub.close()
        pub.unlink()


def test_png_bytes_and_decode_equal():
    rng = np.random.default_rng(1)
    for img in (rng.integers(0, 256, (7, 5, 3)).astype(np.uint8),
                rng.uniform(-20, 300, (4, 6, 3)).astype(np.float32),
                rng.integers(0, 256, (3, 9)).astype(np.uint8)):
        for level in (1, 6):
            data = png.encode_rgb(img, compress_level=level)
            assert data == jpng.encode_rgb(img, compress_level=level)
            np.testing.assert_array_equal(png.decode_rgb(data),
                                          jpng.decode_rgb(data))
    with pytest.raises(ValueError):
        png.decode_rgb(b"not a png")


def test_frames_equal_across_packages(sessions):
    frame, jframe, _ = sessions
    assert frame.step == jframe.step == 3
    assert frame.markers == jframe.markers
    assert {m["type"] for m in frame.markers} == {"cube", "sphere", "text"}
    for scale in (1, 2):
        got = viewer.grid_frame_rgb(frame, scale=scale)
        np.testing.assert_array_equal(got, jviewer.grid_frame_rgb(
            jframe, scale=scale))
    img = viewer.grid_frame_rgb(frame)
    assert viewer.ansi_halfblock(img) == jviewer.ansi_halfblock(img)
    small = viewer._downsample_to(img, 10, 9)
    np.testing.assert_array_equal(small, jviewer._downsample_to(img, 10, 9))
    assert viewer.ansi_halfblock(small) == jviewer.ansi_halfblock(small)
    np.testing.assert_array_equal(
        viewer.view3d_frame_rgb(frame, width=160, height=120),
        jviewer.view3d_frame_rgb(jframe, width=160, height=120))


def test_terminal_view_draws(sessions):
    buf = io.StringIO()
    assert viewer.terminal_view("port", max_seconds=0.3, out=buf) >= 1
    assert "session=port step=3" in buf.getvalue()
    buf = io.StringIO()
    assert viewer.terminal_view("port", max_seconds=0.3, out=buf,
                                mode="3d") >= 1


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, deadline=5.0):
    t_end, err = time.time() + deadline, None
    while time.time() < t_end:
        try:
            return urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5).read()
        except OSError as e:          # the server is still starting
            err = e
            time.sleep(0.05)
    raise AssertionError(f"no answer on {path}: {err}")


def test_http_view_endpoints_equal_jax(sessions):
    frame, jframe, a = sessions
    port = _free_port()
    th = threading.Thread(target=viewer.http_view, args=("port", port),
                          kwargs={"max_seconds": 3.0}, daemon=True)
    th.start()
    assert b"grid-vision-tpu live session: port" in _get(port, "/")
    body = _get(port, "/grid.png")
    assert body == jpng.encode_rgb(jviewer.grid_frame_rgb(jframe, scale=2))
    np.testing.assert_array_equal(png.decode_rgb(body),
                                  viewer.grid_frame_rgb(frame, scale=2))
    assert png.decode_rgb(_get(port, "/overlay.png")).shape == \
        a["image"].shape
    doc = json.loads(_get(port, "/markers.json"))
    assert doc == {"step": 3, "markers": json.loads(json.dumps(
        jframe.markers))}
    # one /grid.gvd record: the JAX encoder's first record of this grid
    recs = list(viewer.gvd_client("127.0.0.1", port, max_records=1))
    grid, step, stamp = recs[0]
    np.testing.assert_array_equal(grid, a["grid"])
    assert (step, stamp) == (3, 1234)
    ref = jcodec.GridDeltaEncoder().encode(a["grid"], step=3, stamp_ns=1234)
    raw = _raw_records("127.0.0.1", port, "/grid.gvd", 1)
    assert raw == [ref]
    fc = list(viewer.gvd_client("127.0.0.1", port, max_records=1,
                                path="/forecast.gvd"))
    k, r, c = a["forecast"].shape
    np.testing.assert_array_equal(fc[0][0], a["forecast"].reshape(k * r, c))
    th.join(10)
    assert not th.is_alive()


def _raw_records(host, port, path, n):
    """The first n length-prefixed records of a .gvd stream, as bytes."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = []
    try:
        while len(out) < n:
            (rlen,) = jcodec._RECLEN.unpack(resp.read(jcodec._RECLEN.size))
            out.append(resp.read(rlen))
    finally:
        conn.close()
    return out


def test_gvd_client_reads_the_jax_viewer(sessions):
    """The port's client on the JAX package's server (the same records)."""
    _, _, a = sessions
    port = _free_port()
    th = threading.Thread(target=jviewer.http_view, args=("jax", port),
                          kwargs={"max_seconds": 2.0}, daemon=True)
    th.start()
    _get(port, "/")
    grid, step, stamp = next(viewer.gvd_client("127.0.0.1", port,
                                               max_records=1))
    np.testing.assert_array_equal(grid, a["grid"])
    assert (step, stamp) == (3, 1234)
    th.join(10)
    assert not th.is_alive()
