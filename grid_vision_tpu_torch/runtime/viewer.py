"""Live viewer: attach to a running engine session and watch it (a copy of
grid_vision_tpu/runtime/viewer.py over this package's sessions, which
share the JAX package's byte layout: either viewer reads either's
session).

The RViz replacement (reference: rviz/config.rviz — occupancy Map +
MarkerArray + detections Image at 20 Hz). Two surfaces over the same
cross-process session mailboxes (runtime/session.py):

  terminal   ANSI half-block render of the grid + markers in the tty,
             refreshing in place at the session's own rate (--mode 3d
             renders the io/viz3d.py perspective view instead).
  http       a ThreadingHTTPServer streaming multipart PNG (MJPEG-style)
             of the grid, the detection overlay, AND the 3D operator
             view (/view3d.mjpg — the RViz orbit camera, rendered by
             io/viz3d.py) to any browser, plus /markers.json, plus
             /grid.gvd — the machine-consumer grid stream: keyframe +
             sparse-delta records (io/grid_codec.py), ~100-500x below
             the raw 100 kB/tick nav_msgs-style export on the wire.
             Consume with runtime.viewer.gvd_client().

    python -m grid_vision_tpu_torch view --session demo       # terminal
    python -m grid_vision_tpu_torch view --session demo --mode 3d
    python -m grid_vision_tpu_torch view --session demo --http 8400

Rendering is pure numpy on the subscriber's copy; a slow viewer never
backpressures the engine (latest-wins mailboxes).
"""

from __future__ import annotations

import json
import shutil
import sys
import time
from typing import Optional

import numpy as np

from .session import SessionFrame, SessionSubscriber

# palette (RGB float)
_FREE = np.array([252, 252, 250], np.float32)
_UNKNOWN = np.array([170, 172, 178], np.float32)
_OCCUPIED = np.array([24, 26, 42], np.float32)
_CUBE = np.array([40, 120, 255], np.float32)
_ORIGIN = np.array([230, 60, 60], np.float32)


def grid_frame_rgb(frame: SessionFrame, scale: int = 1) -> np.ndarray:
    """Grid + markers -> (H, W, 3) uint8, robot-forward up.

    Grid layout follows grid_map index math (runtime_cc grid_index):
    row 0 = the far forward edge, column 0 = the left edge, so the raw
    array is already forward-up / left-left when drawn row-major.
    """
    g = frame.grid.astype(np.float32)
    occ = np.clip(g, 0, 100) / 100.0
    rgb = _FREE[None, None] + occ[..., None] * (_OCCUPIED - _FREE)[None, None]
    rgb = np.where((g < 0)[..., None], _UNKNOWN[None, None], rgb)

    meta = frame.grid_meta
    if meta is not None:
        res = float(meta["resolution"])
        max_x = meta["center"][0] + meta["length"][0] / 2.0
        max_y = meta["center"][1] + meta["length"][1] / 2.0
        rows, cols = g.shape

        def cell(px, py):
            ix = int(np.floor((max_x - px) / res))
            iy = int(np.floor((max_y - py) / res))
            if 0 <= ix < rows and 0 <= iy < cols:
                return ix, iy
            return None

        def blot(px, py, color, r):
            c = cell(px, py)
            if c is None:
                return
            ix, iy = c
            rgb[max(ix - r, 0):ix + r + 1,
                max(iy - r, 0):iy + r + 1] = color

        for m in frame.markers:
            pos = m.get("position", [0, 0, 0])
            if m.get("type") == "cube":
                sx, sy = m.get("scale", [1, 1, 1])[:2]
                hx = max(int(round(sx / (2 * res))), 1)
                hy = max(int(round(sy / (2 * res))), 1)
                c = cell(pos[0], pos[1])
                if c is not None:
                    ix, iy = c
                    rgb[max(ix - hx, 0):ix + hx + 1,
                        max(iy - hy, 0):iy + hy + 1] = _CUBE
            elif m.get("type") == "sphere":
                col = np.asarray(m.get("color", (1, 0, 1)),
                                 np.float32) * 255.0
                blot(pos[0], pos[1], col, 2)
            elif m.get("type") == "text":
                blot(pos[0], pos[1], np.array([255, 255, 255], np.float32),
                     1)
        # robot origin cross
        o = cell(0.0, 0.0)
        if o is not None:
            ix, iy = o
            rgb[max(ix - 3, 0):ix + 4, iy] = _ORIGIN
            rgb[ix, max(iy - 3, 0):iy + 4] = _ORIGIN

    out = np.clip(rgb, 0, 255).astype(np.uint8)
    if scale > 1:
        out = out.repeat(scale, axis=0).repeat(scale, axis=1)
    return out


def _downsample_to(img: np.ndarray, max_h: int, max_w: int) -> np.ndarray:
    """Integer block-average downsample preserving aspect (uint8 in/out)."""
    h, w = img.shape[:2]
    f = max(1, (h + max_h - 1) // max_h, (w + max_w - 1) // max_w)
    if f == 1:
        return img
    th, tw = h // f * f, w // f * f
    x = img[:th, :tw].astype(np.float32)
    x = x.reshape(th // f, f, tw // f, f, 3).mean(axis=(1, 3))
    return x.astype(np.uint8)


def ansi_halfblock(img: np.ndarray) -> str:
    """RGB image -> 24-bit-color half-block string (2 pixels per row of
    text via '▀' with fg = upper pixel, bg = lower pixel)."""
    h, w = img.shape[:2]
    if h % 2:
        img = np.concatenate([img, img[-1:]], axis=0)
        h += 1
    top = img[0::2]
    bot = img[1::2]
    lines = []
    for r in range(h // 2):
        parts = []
        last = None
        for c in range(w):
            tr, tg, tb = (int(v) for v in top[r, c])
            br, bg_, bb = (int(v) for v in bot[r, c])
            key = (tr, tg, tb, br, bg_, bb)
            if key != last:
                parts.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                             f"\x1b[48;2;{br};{bg_};{bb}m")
                last = key
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def view3d_frame_rgb(frame: SessionFrame, width: int = 640,
                     height: int = 480) -> np.ndarray:
    """The RViz-style 3D operator view of a session frame (io/viz3d.py:
    orbit camera, occupancy ground plane, live point cloud, robot
    model, marker cubes/spheres/text)."""
    from ..io.viz3d import render_scene
    return render_scene(frame.grid, frame.grid_meta, frame.markers,
                        width=width, height=height, cloud=frame.cloud)


def terminal_view(session: str, max_seconds: Optional[float] = None,
                  out=None, mode: str = "2d") -> int:
    """Render the session's grid in the tty until interrupted.
    mode: "2d" top-down (default) or "3d" perspective (io/viz3d.py).
    Returns the number of frames drawn."""
    out = out or sys.stdout
    sub = SessionSubscriber(session)
    drawn = 0
    t0 = time.perf_counter()
    t_last = t0
    out.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor
    try:
        while max_seconds is None or time.perf_counter() - t0 < max_seconds:
            frame = sub.poll()
            if frame is None:
                time.sleep(0.02)
                continue
            cols, rows = shutil.get_terminal_size((120, 40))
            if mode == "3d":
                img = view3d_frame_rgb(frame, width=max(cols, 64),
                                       height=max((rows - 2) * 2, 48))
            else:
                img = grid_frame_rgb(frame)
            img = _downsample_to(img, (rows - 2) * 2, cols)
            now = time.perf_counter()
            hz = 1.0 / max(now - t_last, 1e-6)
            t_last = now
            status = (f" session={session} step={frame.step} "
                      f"markers={len(frame.markers)} view={hz:5.1f} Hz ")
            out.write("\x1b[H" + ansi_halfblock(img) + "\n\x1b[7m"
                      + status[:cols].ljust(min(cols, 100)) + "\x1b[0m")
            out.flush()
            drawn += 1
    except KeyboardInterrupt:
        pass
    finally:
        out.write("\x1b[?25h\x1b[?1049l")
        out.flush()
        sub.close()
    return drawn


_INDEX_HTML = """<!doctype html>
<title>grid-vision-tpu — {session}</title>
<style>
 body {{ background:#101218; color:#d8dce6; font:14px system-ui;
        margin:24px; }}
 h1 {{ font-size:16px; font-weight:600; }}
 .row {{ display:flex; gap:24px; align-items:flex-start;
        flex-wrap:wrap; }}
 img {{ image-rendering:pixelated; border:1px solid #2a2e3a;
       border-radius:4px; }}
 .cap {{ color:#8a90a0; font-size:12px; margin-top:4px; }}
</style>
<h1>grid-vision-tpu live session: {session}</h1>
<div class=row>
 <div><img src="/view3d.mjpg" width=640><div class=cap>
   3D operator view (orbit camera)</div></div>
 <div><img src="/grid.mjpg" width=400><div class=cap>
   occupancy grid + markers (forward ↑)</div></div>
 <div><img src="/overlay.mjpg" width=640><div class=cap>
   detection overlay</div></div>
</div>
<div class=cap><a href="/markers.json" style="color:#7aa2ff">
 markers.json</a></div>
"""


def http_view(session: str, port: int, max_seconds: Optional[float] = None,
              fps: float = 10.0):
    """Serve the session over HTTP. Blocks (Ctrl-C to stop)."""
    import http.server
    import socketserver

    from ..io import png

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _frame(self, sub):
            f = sub.poll(wait_new=False)
            return f

        def do_GET(self):  # noqa: N802 (http.server API)
            try:
                self._route()
            except (BrokenPipeError, ConnectionResetError):
                pass

        def _route(self):
            if self.path == "/":
                body = _INDEX_HTML.format(session=session).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/grid.png", "/overlay.png",
                               "/view3d.png"):
                sub = SessionSubscriber(session)
                frame = self._frame(sub)
                sub.close()
                img = self._render(frame, self.path)
                if img is None:
                    self.send_error(404, "no frame yet")
                    return
                body = png.encode_rgb(img)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/grid.mjpg", "/overlay.mjpg",
                               "/view3d.mjpg"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=gvframe")
                self.end_headers()
                sub = SessionSubscriber(session)
                try:
                    t_end = (None if max_seconds is None
                             else time.perf_counter() + max_seconds)
                    while t_end is None or time.perf_counter() < t_end:
                        frame = self._frame(sub)
                        img = self._render(frame, self.path)
                        if img is not None:
                            body = png.encode_rgb(img)
                            self.wfile.write(
                                b"--gvframe\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(body)}\r\n\r\n"
                                .encode() + body + b"\r\n")
                            self.wfile.flush()
                        time.sleep(1.0 / fps)
                finally:
                    sub.close()
            elif self.path in ("/grid.gvd", "/forecast.gvd"):
                # machine-consumer streams: length-prefixed codec
                # records. /forecast.gvd delta-encodes the K predicted-
                # occupancy planes stacked vertically as ONE
                # (K*rows, cols) int8 image (the codec is shape-agnostic;
                # a subscriber recovers K from rows % grid rows == 0 or
                # out-of-band via /markers.json grid_meta).
                from ..io import grid_codec

                want_forecast = self.path == "/forecast.gvd"
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/x-gvd-stream")
                self.end_headers()
                sub = SessionSubscriber(session)
                enc = grid_codec.GridDeltaEncoder()
                try:
                    t_end = (None if max_seconds is None
                             else time.perf_counter() + max_seconds)
                    while t_end is None or time.perf_counter() < t_end:
                        frame = sub.poll(wait_new=True)
                        if frame is None:
                            time.sleep(1.0 / (4 * fps))
                            continue
                        if want_forecast:
                            if frame.forecast is None:
                                time.sleep(1.0 / (4 * fps))
                                continue
                            k, r, c = frame.forecast.shape
                            payload = frame.forecast.reshape(k * r, c)
                        else:
                            payload = frame.grid
                        rec = enc.encode(payload, step=frame.step,
                                         stamp_ns=frame.stamp_ns)
                        self.wfile.write(
                            grid_codec._RECLEN.pack(len(rec)) + rec)
                        self.wfile.flush()
                finally:
                    sub.close()
            elif self.path == "/markers.json":
                sub = SessionSubscriber(session)
                frame = self._frame(sub)
                sub.close()
                doc = {"step": frame.step if frame else None,
                       "markers": frame.markers if frame else []}
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_error(404)

        @staticmethod
        def _render(frame, path: str):
            if frame is None:
                return None
            if path.startswith("/grid"):
                return grid_frame_rgb(frame, scale=2)
            if path.startswith("/view3d"):
                return view3d_frame_rgb(frame)
            return frame.overlay

    class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True

    srv = Server(("127.0.0.1", port), Handler)
    srv.gv_session = session  # introspection for tests
    print(f"viewing session {session!r} at http://127.0.0.1:{port}/",
          file=sys.stderr)
    if max_seconds is not None:
        import threading
        threading.Timer(max_seconds, srv.shutdown).start()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return srv


def gvd_client(host: str, port: int, max_records: Optional[int] = None,
               timeout: float = 10.0, path: str = "/grid.gvd"):
    """Consume a /grid.gvd-style stream: yields (grid_i8, step, stamp_ns).

    The remote-subscriber counterpart of the reference's nav_msgs
    OccupancyGrid subscription — same decoded content, delivered as
    keyframe + sparse-delta records (io/grid_codec.py) so a 10 Hz
    consumer costs ~kB/s instead of ~MB/s of wire.

    path="/forecast.gvd" consumes the predictive-occupancy stream
    instead: each record decodes to the (K*rows, cols) stack of the K
    horizon planes (reshape with the grid rows from grid_meta)."""
    import http.client

    from ..io import grid_codec

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    if resp.status != 200:
        conn.close()
        raise ConnectionError(f"{path} -> HTTP {resp.status}")
    dec = grid_codec.GridDeltaDecoder()
    n = 0
    try:
        while max_records is None or n < max_records:
            raw = resp.read(grid_codec._RECLEN.size)
            if len(raw) < grid_codec._RECLEN.size:
                return
            (rlen,) = grid_codec._RECLEN.unpack(raw)
            rec = resp.read(rlen)
            if len(rec) < rlen:
                return
            out = dec.decode(rec)
            if out is not None:
                yield out
                n += 1
    finally:
        conn.close()
