"""Per-step observability (counterpart of grid_vision_tpu/utils/stats.py;
the reference's only tracing was three wall timers logged at INFO,
src/grid_vision_node.cpp:125-135, 192-224): structured stats for every
step, a stage timer, and torch.profiler traces."""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Optional

logger = logging.getLogger("grid_vision_tpu_torch")


@dataclasses.dataclass
class StepStats:
    step: int
    dispatch_s: float = 0.0
    boxes_kept: Optional[int] = None
    poses_valid: Optional[int] = None
    cells_occupied: Optional[int] = None
    # Host-side ingest saturation: finite cloud points dropped by the
    # capacity subsample (device-side counters live in
    # types.SaturationStats, carried by StepOutput).
    cloud_points_dropped: int = 0

    def log(self) -> None:
        logger.info(
            "step=%d dispatch=%.3fms boxes=%s poses=%s occ_cells=%s",
            self.step, self.dispatch_s * 1e3, self.boxes_kept,
            self.poses_valid, self.cells_occupied)


@contextlib.contextmanager
def stage_timer(name: str):
    """The reference's start/end chrono pattern as a context manager."""
    t0 = time.perf_counter()
    yield
    logger.info("%s took %.2f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the block (host and, on a card, CUDA
    activity), written to log_dir as a Chrome / Perfetto trace; yields the
    profiler (its key_averages() is the per-kernel table)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
