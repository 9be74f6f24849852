"""nav_msgs/OccupancyGrid-equivalent export (a copy of
grid_vision_tpu/io/grid_msg.py that also takes a tensor).

The reference publishes the grid via GridMapRosConverter::toOccupancyGrid
(grid_vision_node.cpp:265-278): int8 data in [0, 100], header with stamp
and the base frame, and map metadata (resolution, dimensions, origin
pose). This module produces the same message as a plain dataclass so
downstream consumers (planners, recorders) can migrate field-for-field.

Layout: nav_msgs grids are row-major from the origin cell with x
(columns) increasing along msg-width and y (rows) along msg-height; the
origin is the minimum-corner cell. Our buffer order has index (0,0) at
the MAX corner (grid_map convention, see geometry.py), so the export
flips both axes and transposes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np

from ..config import GridVisionConfig
from .viz import _host


@dataclasses.dataclass
class OccupancyGridMsg:
    frame_id: str
    stamp_ns: int
    resolution: float
    width: int            # cells along x
    height: int           # cells along y
    origin_xy: Tuple[float, float]  # min-corner position in frame_id
    data: np.ndarray      # (height, width) int8 in [0, 100]; -1 unknown

    def flat_data(self) -> np.ndarray:
        """Row-major int8 vector exactly like nav_msgs/OccupancyGrid.data."""
        return self.data.reshape(-1)


def to_occupancy_grid_msg(occupancy_i8, cfg: GridVisionConfig,
                          stamp_ns: int | None = None) -> OccupancyGridMsg:
    """Our buffer-order int8 grid (an array, or a tensor on any device,
    read back once) -> nav_msgs-style message."""
    g = _host(occupancy_i8)
    size_x, size_y = cfg.grid_size
    if g.shape != (size_x, size_y):
        raise ValueError(f"grid shape {g.shape} != configured "
                         f"{(size_x, size_y)}")
    cx, cy = cfg.grid_center
    origin = (cx - cfg.grid_x / 2.0, cy - cfg.grid_y / 2.0)
    # buffer (ix, iy) counts down from the max corner; msg rows/cols count
    # up from the min corner: flip both axes, then transpose to (y, x).
    data = g[::-1, ::-1].T.copy()
    return OccupancyGridMsg(
        frame_id=cfg.base_frame,
        stamp_ns=stamp_ns if stamp_ns is not None else time.time_ns(),
        resolution=cfg.resolution,
        width=size_x,
        height=size_y,
        origin_xy=origin,
        data=data,
    )
