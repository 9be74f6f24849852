"""Session output publishing: the engine side of a live viewer
(counterpart of grid_vision_tpu/runtime/session.py, the same channels and
byte layout, so either package's subscriber reads either's session).

The reference's observability surface is RViz subscribed to three topics
(src/grid_vision_node.cpp:52-54: annotated detections image, the
nav_msgs occupancy grid, the MarkerArray). Here a running engine publishes
the same three surfaces into named cross-process shared-memory mailboxes
(runtime/native.ShmMailbox), and any number of viewer processes attach by
session name:

    engine:  pub = SessionPublisher("demo", cfg)
             ... pub.publish(step, out, image=frame) each tick ...
    viewer:  sub = SessionSubscriber("demo"); frame = sub.poll()

The publisher reads the StepOutput fields it publishes back to the host
(wherever the engine runs) and renders markers and the overlay there.

Channels (latest-wins; a slow viewer never backpressures the engine):
    grid     <iiqQ>(rows, cols, step, stamp_ns) + int8 occupancy cells
    markers  JSON {"step", "stamp_ns", "markers": [...]} (io/viz dicts)
    overlay  <iiqQ>(h, w, step, stamp_ns) + rgb8 bytes (detection overlay)
    forecast <iiiqQ>(K, rows, cols, step, stamp_ns) + f32 horizons[K] +
             int8 predicted-occupancy planes (probability x 100 at
             t + horizon[k]; the tracker's forecast, no reference
             counterpart — the reference grid is purely reactive)
    cloudviz <iqQ>(n, step, stamp_ns) + f32 xyz[n, 3] BASE-frame points
             (viewer-subsampled; the RViz profile's PointCloud2 display,
             the single most informative association-debug overlay)
"""

from __future__ import annotations

import json
import struct
from typing import List, Optional

import numpy as np

from ..config import GridVisionConfig
from ..io import viz
from ..types import StepOutput
from . import native

_HDR = struct.Struct("<iiqQ")
_F_HDR = struct.Struct("<iiiqQ")   # K, rows, cols, step, stamp_ns
_C_HDR = struct.Struct("<iqQ")     # n, step, stamp_ns

GRID_CHANNEL = "grid"
MARKERS_CHANNEL = "markers"
OVERLAY_CHANNEL = "overlay"
FORECAST_CHANNEL = "forecast"
CLOUDVIZ_CHANNEL = "cloudviz"
CLOUDVIZ_MAX_POINTS = 4096         # viewer subsample cap (48 KB/frame)


def _encode_array(arr: np.ndarray, step: int, stamp_ns: int) -> bytes:
    r, c = arr.shape[0], arr.shape[1]
    return _HDR.pack(r, c, step, stamp_ns) + arr.tobytes()


def _decode_grid(data: bytes):
    r, c, step, stamp = _HDR.unpack_from(data)
    grid = np.frombuffer(data, np.int8, offset=_HDR.size).reshape(r, c)
    return grid, step, stamp


def _decode_overlay(data: bytes):
    h, w, step, stamp = _HDR.unpack_from(data)
    img = np.frombuffer(data, np.uint8, offset=_HDR.size).reshape(h, w, 3)
    return img, step, stamp


def _encode_forecast(planes: np.ndarray, horizons, step: int,
                     stamp_ns: int) -> bytes:
    k, r, c = planes.shape
    return (_F_HDR.pack(k, r, c, step, stamp_ns)
            + np.asarray(horizons, np.float32).tobytes()
            + np.ascontiguousarray(planes, np.int8).tobytes())


def _decode_forecast(data: bytes):
    k, r, c, step, stamp = _F_HDR.unpack_from(data)
    o = _F_HDR.size
    horizons = np.frombuffer(data, np.float32, k, o)
    planes = np.frombuffer(data, np.int8, k * r * c,
                           o + 4 * k).reshape(k, r, c)
    return planes, horizons, step, stamp


def _encode_cloud(xyz: np.ndarray, step: int, stamp_ns: int) -> bytes:
    pts = np.ascontiguousarray(xyz, np.float32)
    if pts.shape[0] > CLOUDVIZ_MAX_POINTS:
        keep = np.linspace(0, pts.shape[0] - 1, CLOUDVIZ_MAX_POINTS
                           ).round().astype(np.int64)
        pts = pts[keep]
    return (_C_HDR.pack(pts.shape[0], step, stamp_ns) + pts.tobytes())


def _decode_cloud(data: bytes):
    n, step, stamp = _C_HDR.unpack_from(data)
    xyz = np.frombuffer(data, np.float32, n * 3,
                        _C_HDR.size).reshape(n, 3)
    return xyz, step, stamp


class SessionPublisher:
    """Engine-side publisher. Create once; call publish() per step.

    Marker generation and the box overlay render are host-side numpy on
    the StepOutput read back from the device (the reference's publish
    calls likewise sit after the GPU work in timerCallback).
    """

    def __init__(self, session: str, cfg: GridVisionConfig,
                 overlay: bool = True):
        self.session = session
        gx, gy = cfg.grid_size
        # Geometry shipped with every markers frame so viewers can place
        # world-frame markers onto grid cells without the engine's config.
        self._grid_meta = {
            "size": [gx, gy],
            "center": list(cfg.grid_center),
            "length": [float(cfg.grid_x), float(cfg.grid_y)],
            "resolution": cfg.resolution,
        }
        self._grid_box = native.ShmMailbox(
            native.shm_path(session, GRID_CHANNEL),
            capacity=_HDR.size + gx * gy, create=True)
        self._markers_box = native.ShmMailbox(
            native.shm_path(session, MARKERS_CHANNEL),
            capacity=1 << 20, create=True)
        self._overlay_box = None
        if overlay:
            h, w = cfg.camera_image_height, cfg.camera_image_width
            self._overlay_box = native.ShmMailbox(
                native.shm_path(session, OVERLAY_CHANNEL),
                capacity=_HDR.size + h * w * 3, create=True)
        self._forecast_box = None
        self._cloud_box = None
        self._grid_cells = gx * gy

    def publish(self, step: int, out: StepOutput,
                image: Optional[np.ndarray] = None,
                stamp_ns: int = 0,
                extra_markers: Optional[List[dict]] = None,
                forecast: Optional[np.ndarray] = None,
                horizons=None,
                cloud_xyz: Optional[np.ndarray] = None) -> None:
        """forecast: optional (K, rows, cols) int8 predicted-occupancy
        planes for the K `horizons` (seconds) — published on the
        forecast channel (mailbox created lazily on first use so
        non-forecasting sessions carry no extra shm).
        cloud_xyz: optional (N, 3) BASE-frame points for the cloudviz
        channel (subsampled to CLOUDVIZ_MAX_POINTS; the 3D operator
        view's PointCloud2 display). Same lazy-mailbox convention."""
        grid = viz._host(out.occupancy_i8).astype(np.int8)
        self._grid_box.write(_encode_array(grid, step, stamp_ns), stamp_ns)
        if forecast is not None:
            planes = np.asarray(forecast, np.int8)
            if self._forecast_box is None:
                self._forecast_box = native.ShmMailbox(
                    native.shm_path(self.session, FORECAST_CHANNEL),
                    capacity=(_F_HDR.size + 4 * planes.shape[0]
                              + planes.size), create=True)
            self._forecast_box.write(
                _encode_forecast(planes, horizons, step, stamp_ns),
                stamp_ns)
        if cloud_xyz is not None:
            if self._cloud_box is None:
                self._cloud_box = native.ShmMailbox(
                    native.shm_path(self.session, CLOUDVIZ_CHANNEL),
                    capacity=_C_HDR.size + CLOUDVIZ_MAX_POINTS * 12,
                    create=True)
            self._cloud_box.write(_encode_cloud(cloud_xyz, step,
                                                stamp_ns), stamp_ns)
        markers = viz.markers_from_output(out)
        if extra_markers:
            markers = markers + list(extra_markers)
        blob = json.dumps({"step": step, "stamp_ns": stamp_ns,
                           "grid_meta": self._grid_meta,
                           "markers": markers}).encode()
        self._markers_box.write(blob, stamp_ns)
        if self._overlay_box is not None and image is not None:
            over = viz.draw_boxes(viz._host(image), out.boxes)
            over8 = np.clip(over, 0, 255).astype(np.uint8)
            self._overlay_box.write(_encode_array(over8, step, stamp_ns),
                                    stamp_ns)

    def close(self) -> None:
        self._grid_box.close()
        self._markers_box.close()
        for b in (self._overlay_box, self._forecast_box,
                  self._cloud_box):
            if b is not None:
                b.close()

    def unlink(self) -> None:
        self._grid_box.unlink()
        self._markers_box.unlink()
        for b in (self._overlay_box, self._forecast_box,
                  self._cloud_box):
            if b is not None:
                b.unlink()


class SessionFrame:
    """One coherent viewer poll result."""

    def __init__(self, grid=None, step=0, stamp_ns=0, markers=None,
                 overlay=None, grid_meta=None, forecast=None,
                 horizons=None):
        self.grid = grid
        self.step = step
        self.stamp_ns = stamp_ns
        self.markers: List[dict] = markers or []
        self.overlay = overlay
        self.grid_meta: Optional[dict] = grid_meta
        self.forecast = forecast        # (K, rows, cols) int8 or None
        self.horizons = horizons        # (K,) float32 seconds or None
        self.cloud = None               # (N, 3) f32 base-frame or None


class SessionSubscriber:
    """Viewer-side poller. Attaches to an existing session by name; the
    grid channel is required, markers/overlay optional (a publisher with
    overlay=False simply never creates that mailbox)."""

    def __init__(self, session: str):
        self.session = session
        self._grid_box = native.ShmMailbox(
            native.shm_path(session, GRID_CHANNEL))
        self._markers_box = self._try_open(MARKERS_CHANNEL)
        self._overlay_box = self._try_open(OVERLAY_CHANNEL)
        self._forecast_box = self._try_open(FORECAST_CHANNEL)
        self._cloud_box = self._try_open(CLOUDVIZ_CHANNEL)
        self._grid_seq = 0

    def _try_open(self, channel: str):
        try:
            return native.ShmMailbox(native.shm_path(self.session, channel))
        except OSError:
            return None

    def poll(self, wait_new: bool = True) -> Optional[SessionFrame]:
        """Latest frame, or None if the grid channel has nothing new
        (wait_new=True) / nothing at all."""
        got = self._grid_box.read(
            min_seq=self._grid_seq if wait_new else 0)
        if got is None:
            return None
        data, _stamp, seq = got
        self._grid_seq = seq
        grid, step, stamp = _decode_grid(data)
        frame = SessionFrame(grid=grid, step=step, stamp_ns=stamp)
        if self._markers_box is not None:
            m = self._markers_box.read()
            if m is not None:
                try:
                    doc = json.loads(m[0])
                    frame.markers = doc.get("markers", [])
                    frame.grid_meta = doc.get("grid_meta")
                except json.JSONDecodeError:
                    pass  # torn JSON can't happen (seqlock), but be total
        if self._overlay_box is not None:
            o = self._overlay_box.read()
            if o is not None:
                frame.overlay = _decode_overlay(o[0])[0]
        if self._forecast_box is None:
            # the publisher creates this mailbox lazily on its first
            # forecast publish — retry the attach on every poll
            self._forecast_box = self._try_open(FORECAST_CHANNEL)
        if self._forecast_box is not None:
            fc = self._forecast_box.read()
            if fc is not None:
                planes, horizons, _s, _t = _decode_forecast(fc[0])
                frame.forecast, frame.horizons = planes, horizons
        if self._cloud_box is None:
            self._cloud_box = self._try_open(CLOUDVIZ_CHANNEL)
        if self._cloud_box is not None:
            c = self._cloud_box.read()
            if c is not None:
                frame.cloud = _decode_cloud(c[0])[0]
        return frame

    def close(self) -> None:
        self._grid_box.close()
        for b in (self._markers_box, self._overlay_box,
                  self._forecast_box, self._cloud_box):
            if b is not None:
                b.close()
