"""Per-stage latency telemetry: the reference's tick timers (counterpart
of grid_vision_tpu/runtime/timing.py).

The reference logs three wall-clock stage timers every tick at INFO — 2D
detection ms (src/grid_vision_node.cpp:125-135), vision-orientation ms
(:192-202), PCA estimation ms (:212-224). This module runs the tick split
at the reference's two timer boundaries into three stages and waits for
the card at each boundary (torch.cuda.synchronize, as the JAX package
reads back a scalar), so each time is what the stage costs on its own,
like the reference's cudaStreamSynchronize-bracketed timers. The
unsplit step (pipeline.step) stays the deployment path. CLI: `run
--timings`.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import pipeline
from ..geometry import intrinsic_matrix
from ..types import GridState, Obs, stack
from ..utils import prng


@dataclasses.dataclass
class StageTimes:
    detect_ms: float
    pose_ms: float
    fuse_ms: float

    def __str__(self):
        name = "vision orientation/pose"
        return (f"2D detection: {self.detect_ms:.2f} ms; "
                f"{name}: {self.pose_ms:.2f} ms; "
                f"association+grid: {self.fuse_ms:.2f} ms")


class TimedEngine:
    """Three-stage variant of pipeline.Engine for stage telemetry."""

    def __init__(self, engine: pipeline.Engine):
        self.engine = engine

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    @torch.no_grad()
    def step(self, state: GridState, obs: Obs):
        """(state', out, StageTimes). The pose stage draws from index 0 of
        the tick's rng split, as fuse would, so the outputs equal the
        unsplit step's."""
        eng, cfg = self.engine, self.engine.cfg
        self._sync()
        t0 = time.perf_counter()
        boxes, overflow = pipeline.detect_with_stats(eng.params, obs.image,
                                                     cfg)
        self._sync()
        t1 = time.perf_counter()
        # the same has_image gate fuse applies on entry (Q1: a stale or
        # absent camera must not produce phantom poses)
        obs1, gated = stack([obs]), stack([boxes])
        gated = dataclasses.replace(
            gated, valid=gated.valid & obs1.has_image[:, None])
        K = intrinsic_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                             device=eng.device)
        rng = prng.split(state.rng[None])[..., 0, :]
        poses1, trunc = pipeline.pose_branch(eng.params, obs1, gated, K, rng,
                                             eng.extrinsics, cfg)
        self._sync()
        t2 = time.perf_counter()
        state, out = pipeline.fuse(eng.params, state, obs, boxes,
                                   eng.extrinsics, cfg,
                                   poses_cam=poses1.select(0),
                                   prenms_overflow=overflow,
                                   box_cloud_truncated=trunc[0])
        self._sync()
        t3 = time.perf_counter()
        return state, out, StageTimes(
            detect_ms=(t1 - t0) * 1e3, pose_ms=(t2 - t1) * 1e3,
            fuse_ms=(t3 - t2) * 1e3)
