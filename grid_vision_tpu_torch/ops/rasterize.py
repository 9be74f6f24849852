"""Bayesian log-odds occupancy-grid updates on tensors (counterpart of
grid_vision_tpu/ops/rasterize.py; reference occupancy_grid.cpp:16-105,
140-183, grid_vision_node.cpp:270). This is the ``grid_backend="xla"``
path; ``ops/cuda_grid.py`` holds the fused kernel.

Update order: decay, then + hit times the number of footprints covering the
cell (summed over boxes first, added as one fused multiply-add), then one
clamp, then the sigmoid. Free space
comes only from the decay (quirk Q2); footprints ignore yaw (quirk Q11); a
box with any corner off the map is skipped whole. Poses and grids may carry
a leading rig axis.

Extensions (compat=False): ``lshape_update_oriented`` rasterizes the
yaw-rotated rectangles instead (fixes Q11); ops/raycast.py carves free
space. ``point_bbox_update`` is the reference's per-class overload, dead
code there (quirk Q6), kept for parity of the interface.
"""

from __future__ import annotations

import torch

from ..config import GridVisionConfig
from ..geometry import grid_index_from_position, grid_position_from_index
from ..taxonomy import estimated_depth
from ..types import Boxes, LShapePoses


def hit_add(log_odds: torch.Tensor, hit: float,
            counts: torch.Tensor) -> torch.Tensor:
    """fma(hit, counts, log_odds) in f32 with one rounding: the JAX
    package's XLA build contracts ``log_odds + hit * counts`` into a fused
    multiply-add, so a separately rounded product would differ by an ulp.
    The product of an f32 and a small count is exact in f64; the sum is
    rounded to f64 and then to f32."""
    hit64 = float(torch.tensor(hit, dtype=torch.float32))
    return (log_odds.double() + hit64 * counts.double()).float()


def _finish(log_odds: torch.Tensor, cfg: GridVisionConfig):
    """Clamp, then log-odds -> probability (occupancy_grid.cpp:21-30)."""
    log_odds = torch.clamp(log_odds, cfg.min_log_odds, cfg.max_log_odds)
    return log_odds, 1.0 / (1.0 + torch.exp(-log_odds))


def decay_update(log_odds: torch.Tensor, cfg: GridVisionConfig):
    """updateMap(grid): the decay-only overload."""
    return _finish(log_odds + cfg.log_odds_decay, cfg)


def pose_footprint_corners(poses: LShapePoses) -> torch.Tensor:
    """(..., D, 4, 2) axis-aligned footprint corners from pose centers and
    length / width in base axes, ignoring yaw (quirk Q11)."""
    px = poses.position[..., 0]
    py = poses.position[..., 1]
    half_l = poses.length / 2.0
    half_w = poses.width / 2.0
    return torch.stack([
        torch.stack([px - half_l, py - half_w], dim=-1),
        torch.stack([px + half_l, py - half_w], dim=-1),
        torch.stack([px + half_l, py + half_w], dim=-1),
        torch.stack([px - half_l, py + half_w], dim=-1),
    ], dim=-2)


def corner_window_counts(corners_xy: torch.Tensor, box_valid: torch.Tensor,
                         center, length, resolution: float,
                         n_rows: int, n_cols: int, row0: int = 0):
    """(..., n_rows, n_cols) f32 count of valid footprint blocks covering
    each cell (updateGridCellsFast: a box with any corner off the map is skipped,
    otherwise its inclusive min..max index block counts)."""
    idx, corner_ok = grid_index_from_position(corners_xy, center, length,
                                              resolution)
    ok = box_valid & torch.all(corner_ok, dim=-1)
    lo = idx.amin(dim=-2)
    hi = idx.amax(dim=-2)
    rows = torch.arange(n_rows, dtype=torch.int32,
                        device=corners_xy.device) + row0
    cols = torch.arange(n_cols, dtype=torch.int32, device=corners_xy.device)
    row_mask = ((rows >= lo[..., 0:1]) & (rows <= hi[..., 0:1])
                & ok[..., None]).float()
    col_mask = ((cols >= lo[..., 1:2]) & (cols <= hi[..., 1:2])).float()
    return torch.einsum("...dh,...dw->...hw", row_mask, col_mask)


def lshape_hit_counts(poses: LShapePoses,
                      cfg: GridVisionConfig) -> torch.Tensor:
    """(..., H, W) f32 count of valid pose footprints covering each cell:
    corner_window_counts without decay, hit scale or clamp; the evidence a
    rig adds to a shared grid (parallel/shared_grid.py)."""
    h, w = cfg.grid_size
    return corner_window_counts(
        pose_footprint_corners(poses), poses.valid, cfg.grid_center,
        (float(cfg.grid_x), float(cfg.grid_y)), cfg.resolution, h, w)


def lshape_update(log_odds: torch.Tensor, poses: LShapePoses,
                  cfg: GridVisionConfig):
    """updateMap(grid, bboxes_pose): decay, footprint hits, clamp, sigmoid.
    Returns (log_odds, occupancy), each (..., H, W)."""
    log_odds = hit_add(log_odds + cfg.log_odds_decay, cfg.log_odds_hit,
                       lshape_hit_counts(poses, cfg))
    return _finish(log_odds, cfg)


def point_bbox_update(log_odds: torch.Tensor, base_points: torch.Tensor,
                      boxes: Boxes, cfg: GridVisionConfig):
    """updateMap(grid, base_points, bboxes): the per-class footprint
    overload (occupancy_grid.cpp:33-63, 107-138). The footprint is a square
    reaching estimated_depth forward of the point and depth / 2 to either
    side; a class without an estimated depth gets -1.0, which still
    rasterizes a small block behind the point, as the reference would."""
    h, w = cfg.grid_size
    depth = estimated_depth(boxes.label)
    bx = base_points[..., 0]
    by = base_points[..., 1]
    corners = torch.stack([
        torch.stack([bx + depth, by + depth / 2.0], dim=-1),
        torch.stack([bx + depth, by - depth / 2.0], dim=-1),
        torch.stack([bx, by - depth / 2.0], dim=-1),
        torch.stack([bx, by + depth / 2.0], dim=-1),
    ], dim=-2)
    counts = corner_window_counts(
        corners, boxes.valid, cfg.grid_center,
        (float(cfg.grid_x), float(cfg.grid_y)), cfg.resolution, h, w)
    return _finish(hit_add(log_odds + cfg.log_odds_decay, cfg.log_odds_hit,
                           counts), cfg)


def yaw_from_quat(quat: torch.Tensor) -> torch.Tensor:
    """Base-frame z-yaw of (..., 4) xyzw quaternions."""
    x, y, z, w = quat.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _cell_centers(h: int, w: int, cfg: GridVisionConfig,
                  device=None) -> torch.Tensor:
    """(H, W, 2) base-frame centre of every cell."""
    rows = torch.arange(h, dtype=torch.int32, device=device)
    cols = torch.arange(w, dtype=torch.int32, device=device)
    idx = torch.stack(torch.meshgrid(rows, cols, indexing="ij"), dim=-1)
    return grid_position_from_index(
        idx, cfg.grid_center, (float(cfg.grid_x), float(cfg.grid_y)),
        cfg.resolution)


def lshape_update_oriented(log_odds: torch.Tensor, poses: LShapePoses,
                           cfg: GridVisionConfig):
    """Extension: rotated-rectangle footprints. A cell is hit when its
    centre lies inside the pose's yaw-rotated length x width rectangle; a
    box with any ROTATED corner off the map is skipped whole."""
    h, w = cfg.grid_size
    length = (float(cfg.grid_x), float(cfg.grid_y))
    yaw = yaw_from_quat(poses.quat)                           # (..., D)
    c, s = torch.cos(yaw), torch.sin(yaw)
    px = poses.position[..., 0]
    py = poses.position[..., 1]
    hl = poses.length / 2.0
    hw = poses.width / 2.0

    # rotated corners for the validity check
    cu = torch.stack([hl, hl, -hl, -hl], dim=-1)              # (..., D, 4)
    cv = torch.stack([hw, -hw, hw, -hw], dim=-1)
    corners = torch.stack(
        [px[..., None] + c[..., None] * cu - s[..., None] * cv,
         py[..., None] + s[..., None] * cu + c[..., None] * cv], dim=-1)
    _, corner_ok = grid_index_from_position(corners, cfg.grid_center, length,
                                            cfg.resolution)
    ok = poses.valid & torch.all(corner_ok, dim=-1)           # (..., D)

    centers = _cell_centers(h, w, cfg, log_odds.device)       # (H, W, 2)

    def cells(x):
        return x[..., None, None]

    rx = centers[..., 0] - cells(px)                          # (..., D, H, W)
    ry = centers[..., 1] - cells(py)
    u = cells(c) * rx + cells(s) * ry
    v = -cells(s) * rx + cells(c) * ry
    inside = ((u.abs() <= cells(hl)) & (v.abs() <= cells(hw)) & cells(ok))
    counts = inside.float().sum(dim=-3)
    return _finish(hit_add(log_odds + cfg.log_odds_decay, cfg.log_odds_hit,
                           counts), cfg)


def export_occupancy_i8(occupancy: torch.Tensor) -> torch.Tensor:
    """nav_msgs/OccupancyGrid export: probability [0, 1] -> int8 [0, 100]."""
    return torch.round(torch.clamp(occupancy, 0.0, 1.0) * 100.0).to(
        torch.int8)


def gate_and_export(log_odds: torch.Tensor, occupancy: torch.Tensor,
                    gate: torch.Tensor, log_odds_prev: torch.Tensor,
                    occupancy_prev: torch.Tensor):
    """The grid update's epilogue: the run gate (quirk Q1: a rig with
    neither image nor cloud keeps its grid, not even decayed), then the int8
    export. gate (...,) bool over the grids' leading axes. Returns
    (log_odds, occupancy, occupancy_i8); the grid kernels fuse the same."""
    g = gate[..., None, None]
    occupancy = torch.where(g, occupancy, occupancy_prev)
    return (torch.where(g, log_odds, log_odds_prev), occupancy,
            export_occupancy_i8(occupancy))
