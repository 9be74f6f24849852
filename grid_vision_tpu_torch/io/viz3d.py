"""Software 3D scene renderer: the RViz operator view, headless (a copy of
grid_vision_tpu/io/viz3d.py, numpy only: the same pixels).

The reference ships an RViz profile whose operator camera is a 3D
orbit view over the map frame — occupancy Map on the ground plane,
MarkerArray cubes/spheres/text floating above it, TF axes at the robot
(rviz/config.rviz:251-270 Orbit view, :30-240 display list).  The 2D top-down surface in runtime/viewer.py carries the same
data but not the same view; this module closes that gap with a pure
numpy perspective renderer over the session's (grid, markers) payload —
no GL, no new dependencies, fast enough for the live viewer loop
(~15 ms at 640x480).

Rendering model (single z-buffer, camera-ray parameter t as depth):
  ground   per-pixel ray vs z=0 plane, occupancy sampled per cell with
           the same palette as the top-down view;
  cubes    oriented boxes -> 6 quads, per-pixel plane depth inside the
           projected polygon, Lambert-shaded by face normal;
  spheres  billboard discs at center depth (markers are 0.3 m lights —
           a disc is visually exact at operator distances);
  points   the live LiDAR cloud (session cloudviz channel), z-buffered
           1-2 px splats colored by height — the reference profile's
           PointCloud2 display (config.rviz:115, AxisColor-style);
  robot    stylized vehicle body at the origin (chassis + cabin +
           wheels) standing in for the RobotModel display
           (config.rviz:73: the URDF itself isn't shipped);
  text     billboard bitmap (io/font.py) scaled ~1/z like RViz's
           view-facing TEXT_VIEW_FACING markers;
  axes     1 m RGB TF triad at the robot origin (config.rviz TF display).

World frame matches the grid/marker convention everywhere else in the
package: x forward, y lateral-left, z up.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

# palette (shared look with runtime/viewer.py's top-down surface)
_FREE = np.array([252, 252, 250], np.float32)
_UNKNOWN = np.array([170, 172, 178], np.float32)
_OCCUPIED = np.array([24, 26, 42], np.float32)
_SKY = np.array([38, 40, 48], np.float32)       # RViz dark background
_GROUND_FAR = np.array([60, 62, 70], np.float32)  # beyond the grid
_LIGHT_DIR = np.array([0.3, 0.2, 0.93], np.float32)  # world-frame sun


@dataclass
class OrbitCamera:
    """RViz Orbit view parameters (config.rviz:251-270): the camera sits
    `distance` away from `focal`, at `pitch` above the horizon, rotated
    `yaw` about world z, always looking at `focal`."""

    distance: float = 39.63
    pitch: float = 0.775
    yaw: float = 3.115
    focal: Sequence[float] = (4.55, -0.44, 0.0)
    fov_deg: float = 55.0

    def eye(self) -> np.ndarray:
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        f = np.asarray(self.focal, np.float32)
        # RViz orbit convention: position = focal + d*(cy*cp, sy*cp, sp),
        # so the saved Yaw ~= pi parks the camera behind the robot
        # (x < 0) looking forward down +x.
        off = np.array([cp * cy, cp * sy, sp], np.float32)
        return f + self.distance * off


def _camera_basis(eye: np.ndarray, focal: np.ndarray):
    fwd = focal - eye
    fwd = fwd / max(float(np.linalg.norm(fwd)), 1e-9)
    up = np.array([0.0, 0.0, 1.0], np.float32)
    right = np.cross(fwd, up)
    n = float(np.linalg.norm(right))
    if n < 1e-6:  # looking straight down: pick forward-x as screen-up
        right = np.cross(fwd, np.array([1.0, 0.0, 0.0], np.float32))
        n = float(np.linalg.norm(right))
    right /= n
    down = np.cross(fwd, right)
    return right.astype(np.float32), down.astype(np.float32), fwd


def _quat_to_mat(q) -> np.ndarray:
    x, y, z, w = (float(v) for v in q)
    n = math.sqrt(x * x + y * y + z * z + w * w) or 1.0
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


class _Raster:
    """Framebuffer + z-buffer + the camera's pixel geometry."""

    def __init__(self, width: int, height: int, cam: OrbitCamera):
        self.w, self.h = width, height
        self.eye = cam.eye()
        focal = np.asarray(cam.focal, np.float32)
        self.right, self.down, self.fwd = _camera_basis(self.eye, focal)
        self.fpx = (0.5 * width) / math.tan(math.radians(cam.fov_deg) / 2)
        self.cx, self.cy = width / 2.0, height / 2.0
        u = (np.arange(width, dtype=np.float32) - self.cx) / self.fpx
        v = (np.arange(height, dtype=np.float32) - self.cy) / self.fpx
        # (H, W, 3) unnormalized ray directions; t is measured along
        # these, so depth compares are consistent everywhere.
        self.dirs = (u[None, :, None] * self.right[None, None]
                     + v[:, None, None] * self.down[None, None]
                     + self.fwd[None, None])
        self.rgb = np.broadcast_to(_SKY, (height, width, 3)).copy()
        self.zbuf = np.full((height, width), np.inf, np.float32)

    def project(self, pts: np.ndarray):
        """(N, 3) world -> (u, v, z_cam); z_cam <= 0 means behind."""
        rel = pts - self.eye[None]
        z = rel @ self.fwd
        u = (rel @ self.right) / np.maximum(z, 1e-6) * self.fpx + self.cx
        v = (rel @ self.down) / np.maximum(z, 1e-6) * self.fpx + self.cy
        return u, v, z


def _draw_ground(r: _Raster, grid: Optional[np.ndarray], meta) -> None:
    dz = r.dirs[..., 2]
    hit = dz < -1e-6
    t = np.where(hit, -r.eye[2] / np.where(hit, dz, -1.0), np.inf)
    px = r.eye[0] + t * r.dirs[..., 0]
    py = r.eye[1] + t * r.dirs[..., 1]
    color = np.broadcast_to(_GROUND_FAR, r.rgb.shape).copy()
    if grid is not None and meta is not None:
        g = np.asarray(grid)
        res = float(meta["resolution"])
        max_x = meta["center"][0] + meta["length"][0] / 2.0
        max_y = meta["center"][1] + meta["length"][1] / 2.0
        ix = np.floor((max_x - px) / res).astype(np.int64)
        iy = np.floor((max_y - py) / res).astype(np.int64)
        inb = ((ix >= 0) & (ix < g.shape[0]) & (iy >= 0)
               & (iy < g.shape[1]) & hit)
        cells = g[np.clip(ix, 0, g.shape[0] - 1),
                  np.clip(iy, 0, g.shape[1] - 1)].astype(np.float32)
        occ = np.clip(cells, 0, 100)[..., None] / 100.0
        cell_rgb = _FREE[None, None] + occ * (_OCCUPIED - _FREE)[None, None]
        cell_rgb = np.where((cells < 0)[..., None], _UNKNOWN[None, None],
                            cell_rgb)
        color = np.where(inb[..., None], cell_rgb, color)
    better = hit & (t < r.zbuf)
    r.zbuf = np.where(better, t, r.zbuf)
    r.rgb = np.where(better[..., None], color, r.rgb)


def _fill_quad(r: _Raster, corners: np.ndarray, color: np.ndarray) -> None:
    """Depth-correct convex quad fill: per-pixel ray/plane intersection
    inside the projected polygon (corners: (4, 3) world, CCW or CW)."""
    u, v, z = r.project(corners)
    if np.any(z < 0.05):
        return  # behind / straddling the near plane: skip (viewer-grade)
    n = np.cross(corners[1] - corners[0], corners[2] - corners[0])
    nn = float(np.linalg.norm(n))
    if nn < 1e-9:
        return
    n = n / nn
    shade = 0.55 + 0.45 * abs(float(n @ _LIGHT_DIR))
    x0 = max(int(np.floor(u.min())), 0)
    x1 = min(int(np.ceil(u.max())) + 1, r.w)
    y0 = max(int(np.floor(v.min())), 0)
    y1 = min(int(np.ceil(v.max())) + 1, r.h)
    if x0 >= x1 or y0 >= y1:
        return
    uu, vv = np.meshgrid(np.arange(x0, x1, dtype=np.float32),
                         np.arange(y0, y1, dtype=np.float32))
    pos = np.ones(uu.shape, bool)
    neg = np.ones(uu.shape, bool)
    for i in range(4):
        ex, ey = u[(i + 1) % 4] - u[i], v[(i + 1) % 4] - v[i]
        cr = ex * (vv - v[i]) - ey * (uu - u[i])
        pos &= cr >= 0
        neg &= cr <= 0
    mask = pos | neg  # accept either winding
    if not mask.any():
        return
    dirs = r.dirs[y0:y1, x0:x1]
    denom = dirs @ n
    ok = np.abs(denom) > 1e-9
    t = np.where(ok, ((corners[0] - r.eye) @ n) / np.where(ok, denom, 1.0),
                 np.inf)
    zb = r.zbuf[y0:y1, x0:x1]
    upd = mask & ok & (t > 0.05) & (t < zb)
    r.zbuf[y0:y1, x0:x1] = np.where(upd, t, zb)
    r.rgb[y0:y1, x0:x1] = np.where(
        upd[..., None], np.clip(color * shade, 0, 255), r.rgb[y0:y1, x0:x1])


_CUBE_FACES = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
               (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]


def _draw_cube(r: _Raster, m: dict) -> None:
    pos = np.asarray(m.get("position", [0, 0, 0]), np.float32)
    sx, sy, sz = (float(s) for s in m.get("scale", [1, 1, 1]))
    rot = _quat_to_mat(m.get("orientation", (0, 0, 0, 1)))
    col = np.asarray(m.get("color", (0.0, 0.5, 1.0)), np.float32) * 255.0
    loc = np.array([[i, j, k] for i in (-sx / 2, sx / 2)
                    for j in (-sy / 2, sy / 2)
                    for k in (-sz / 2, sz / 2)], np.float32)
    world = loc @ rot.T + pos[None]
    for f in _CUBE_FACES:
        _fill_quad(r, world[list(f)], col)


def _draw_sphere(r: _Raster, m: dict) -> None:
    pos = np.asarray(m.get("position", [0, 0, 0]), np.float32)
    rad = float(m.get("scale", [0.3])[0]) / 2.0
    col = np.asarray(m.get("color", (1, 0, 1)), np.float32) * 255.0
    u, v, z = r.project(pos[None])
    if z[0] < 0.05:
        return
    rpx = max(r.fpx * rad / float(z[0]), 1.5)
    x0 = max(int(u[0] - rpx), 0)
    x1 = min(int(u[0] + rpx) + 2, r.w)
    y0 = max(int(v[0] - rpx), 0)
    y1 = min(int(v[0] + rpx) + 2, r.h)
    if x0 >= x1 or y0 >= y1:
        return
    uu, vv = np.meshgrid(np.arange(x0, x1, dtype=np.float32),
                         np.arange(y0, y1, dtype=np.float32))
    d2 = (uu - u[0]) ** 2 + (vv - v[0]) ** 2
    mask = d2 <= rpx * rpx
    t = float(np.linalg.norm(pos - r.eye))
    zb = r.zbuf[y0:y1, x0:x1]
    upd = mask & (t < zb)
    # cheap limb shading: darker toward the silhouette
    shade = 1.0 - 0.35 * np.sqrt(np.clip(d2 / (rpx * rpx), 0, 1))
    r.zbuf[y0:y1, x0:x1] = np.where(upd, t, zb)
    r.rgb[y0:y1, x0:x1] = np.where(
        upd[..., None], np.clip(col * shade[..., None], 0, 255),
        r.rgb[y0:y1, x0:x1])


def _draw_text(r: _Raster, m: dict) -> None:
    from .font import GLYPH_H, GLYPH_W, draw_text
    text = str(m.get("text", ""))
    if not text:
        return
    pos = np.asarray(m.get("position", [0, 0, 0]), np.float32)
    col = np.asarray(m.get("color", (1, 1, 1)), np.float32) * 255.0
    u, v, z = r.project(pos[None])
    if z[0] < 0.05:
        return
    h_world = float(m.get("scale_z", 0.5))
    s = max(1, int(round(r.fpx * h_world / float(z[0]) / GLYPH_H)))
    tile = np.zeros((GLYPH_H + 2, (GLYPH_W + 1) * len(text) + 2, 3),
                    np.float32)
    draw_text(tile, text, 1, 1, col.tolist())
    tile = tile.repeat(s, axis=0).repeat(s, axis=1)
    tile_h, tile_w = tile.shape[:2]
    mask_t = tile.sum(-1) > 0
    x0 = int(u[0]) - tile_w // 2
    y0 = int(v[0]) - tile_h // 2
    xs0, ys0 = max(x0, 0), max(y0, 0)
    xs1, ys1 = min(x0 + tile_w, r.w), min(y0 + tile_h, r.h)
    if xs0 >= xs1 or ys0 >= ys1:
        return
    sub = (slice(ys0 - y0, ys1 - y0), slice(xs0 - x0, xs1 - x0))
    t = float(np.linalg.norm(pos - r.eye))
    zb = r.zbuf[ys0:ys1, xs0:xs1]
    upd = mask_t[sub] & (t < zb)
    r.zbuf[ys0:ys1, xs0:xs1] = np.where(upd, t, zb)
    r.rgb[ys0:ys1, xs0:xs1] = np.where(upd[..., None], tile[sub],
                                       r.rgb[ys0:ys1, xs0:xs1])


def _draw_points(r: _Raster, xyz: np.ndarray) -> None:
    """Z-buffered point splats colored by height (RViz AxisColor on z:
    blue near the ground -> green -> warm at ~2.5 m). Near points get a
    2x2 splat so the cloud reads as a surface at operator distances."""
    pts = np.asarray(xyz, np.float32)
    if pts.size == 0:
        return
    u, v, z = r.project(pts)
    ok = ((z > 0.05) & (u >= 0) & (u < r.w - 1) & (v >= 0)
          & (v < r.h - 1))
    if not ok.any():
        return
    u, v = u[ok], v[ok]
    t = np.linalg.norm(pts[ok] - r.eye[None], axis=-1).astype(np.float32)
    h = np.clip((pts[ok, 2] + 0.5) / 3.0, 0.0, 1.0)   # z in [-0.5, 2.5]
    # two-segment colormap: blue -> green -> amber
    lo = np.array([70, 110, 255], np.float32)
    mid = np.array([60, 220, 130], np.float32)
    hi = np.array([255, 200, 60], np.float32)
    a = np.clip(h * 2.0, 0, 1)[:, None]
    b = np.clip(h * 2.0 - 1.0, 0, 1)[:, None]
    col = lo[None] + a * (mid - lo)[None]
    col = col + b * (hi - mid)[None]
    ui = u.astype(np.int64)
    vi = v.astype(np.int64)
    near = t < 25.0
    for dx, dy, sel in ((0, 0, slice(None)), (1, 0, near), (0, 1, near),
                        (1, 1, near)):
        x = ui[sel] + dx
        y = vi[sel] + dy
        tt = t[sel]
        cc = col[sel]
        upd = tt < r.zbuf[y, x]
        r.zbuf[y, x] = np.where(upd, tt, r.zbuf[y, x])
        r.rgb[y, x] = np.where(upd[:, None], cc, r.rgb[y, x])


def _draw_robot(r: _Raster) -> None:
    """Stylized ego vehicle at the base origin — the RobotModel display
    (config.rviz:73). The reference's URDF isn't in the snapshot; a
    chassis + cabin + four wheels gives the operator the same spatial
    anchor."""
    body = np.array([120, 128, 140], np.float32) / 255.0
    glass = np.array([70, 90, 120], np.float32) / 255.0
    tire = np.array([30, 30, 34], np.float32) / 255.0
    _draw_cube(r, {"position": [0.2, 0.0, 0.55],
                   "scale": [4.2, 1.8, 0.7], "color": body})
    _draw_cube(r, {"position": [-0.1, 0.0, 1.15],
                   "scale": [2.0, 1.6, 0.6], "color": glass})
    for wx in (1.45, -1.25):
        for wy in (0.85, -0.85):
            _draw_cube(r, {"position": [wx, wy, 0.33],
                           "scale": [0.66, 0.24, 0.66], "color": tire})


def _draw_segment(r: _Raster, a, b, color, width_px: float = 1.5) -> None:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n = 48
    pts = a[None] + np.linspace(0, 1, n, dtype=np.float32)[:, None] * (b - a)
    u, v, z = r.project(pts)
    ok = z > 0.05
    u, v, z = u[ok], v[ok], z[ok]
    ui = np.round(u).astype(int)
    vi = np.round(v).astype(int)
    t = np.linalg.norm(pts[ok] - r.eye[None], axis=-1)
    w = int(width_px)
    for dx in range(-w, w + 1):
        for dy in range(-w, w + 1):
            x = np.clip(ui + dx, 0, r.w - 1)
            y = np.clip(vi + dy, 0, r.h - 1)
            upd = t < r.zbuf[y, x] + 0.05  # bias: axes sit on the ground
            r.zbuf[y, x] = np.where(upd, t, r.zbuf[y, x])
            r.rgb[y, x] = np.where(upd[:, None], color, r.rgb[y, x])


def render_scene(grid: Optional[np.ndarray], grid_meta: Optional[dict],
                 markers: List[dict], width: int = 640, height: int = 480,
                 cam: Optional[OrbitCamera] = None,
                 cloud: Optional[np.ndarray] = None,
                 robot: bool = True) -> np.ndarray:
    """Render the operator 3D view -> (height, width, 3) uint8.

    grid: (rows, cols) int8 occupancy (-1 unknown, 0..100), or None.
    grid_meta: {"resolution", "center", "length"} as in SessionFrame.
    markers: marker dicts as produced by io.viz.markers_from_output.
    cloud: optional (N, 3) base-frame LiDAR points (PointCloud2
    display); robot: draw the ego-vehicle model at the origin.
    """
    r = _Raster(width, height, cam or OrbitCamera())
    _draw_ground(r, grid, grid_meta)
    if robot:
        _draw_robot(r)
    # far-to-near marker order is irrelevant (z-buffer), but draw text
    # last so its depth bias never loses to its own sign's sphere.
    for m in markers:
        if m.get("type") == "cube":
            _draw_cube(r, m)
    for m in markers:
        if m.get("type") == "sphere":
            _draw_sphere(r, m)
    if cloud is not None:
        _draw_points(r, cloud)
    # TF triad at the robot origin (1 m axes, RViz TF display)
    _draw_segment(r, (0, 0, 0.02), (1, 0, 0.02),
                  np.array([235, 60, 60], np.float32))
    _draw_segment(r, (0, 0, 0.02), (0, 1, 0.02),
                  np.array([60, 200, 60], np.float32))
    _draw_segment(r, (0, 0, 0), (0, 0, 1),
                  np.array([70, 110, 255], np.float32))
    for m in markers:
        if m.get("type") == "text":
            _draw_text(r, m)
    return np.clip(r.rgb, 0, 255).astype(np.uint8)
