"""Failure detection and graceful degradation helpers (counterpart of
grid_vision_tpu/utils/guards.py).

The reference's failure philosophy is local try/catch + log-and-continue
(cv_bridge, ORT, TF2, RANSAC all degrade without crashing). The tick is
total by construction (masked no-ops instead of exceptions); what remains
is host-side input validation and numeric health monitoring, which lives
here.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import GridState, Obs
from .stats import logger


class InputError(ValueError):
    """Raised by validate_obs for malformed host inputs."""


def validate_obs(obs: Obs, cfg) -> None:
    """Ingest validation (the cv_bridge / fromROSMsg failure surface):
    shape checks before a tick runs on the observation."""
    h, w = cfg.camera_image_height, cfg.camera_image_width
    if tuple(obs.image.shape) != (h, w, 3):
        raise InputError(f"image shape {tuple(obs.image.shape)} != "
                         f"configured ({h}, {w}, 3)")
    if tuple(obs.cloud.xyz.shape) != (cfg.max_points, 3):
        raise InputError(
            f"cloud capacity {obs.cloud.xyz.shape[0]} != configured "
            f"{cfg.max_points} (repack with the right capacity)")


@dataclasses.dataclass
class HealthReport:
    step: int
    finite: bool
    lo_min: float
    lo_max: float
    occupied_cells: int

    @property
    def ok(self) -> bool:
        return self.finite


def check_state(state: GridState) -> HealthReport:
    """Numeric health of the persistent state (the engine's only mutable
    surface), computed on the state's device and read back once: call it
    at a monitoring cadence, not every tick."""
    lo = state.log_odds
    stats = torch.stack([
        state.step.to(torch.float64), torch.isfinite(lo).all().double(),
        lo.min().double(), lo.max().double(),
        (lo > 0).sum().double()]).tolist()
    report = HealthReport(step=int(stats[0]), finite=bool(stats[1]),
                          lo_min=stats[2], lo_max=stats[3],
                          occupied_cells=int(stats[4]))
    if not report.ok:
        logger.error("non-finite grid state at step %d", report.step)
    return report


def recover_state(state: GridState, cfg) -> GridState:
    """Elastic recovery: replace non-finite cells with the prior (the
    reference's equivalent was a process restart = full reset; this keeps
    the healthy cells). Stays on the state's device."""
    lo = torch.where(torch.isfinite(state.log_odds), state.log_odds,
                     torch.full((), cfg.log_odds_prior,
                                dtype=state.log_odds.dtype,
                                device=state.log_odds.device))
    occ = torch.sigmoid(torch.clamp(lo, cfg.min_log_odds, cfg.max_log_odds))
    return GridState(log_odds=lo, occupancy=occ, rng=state.rng,
                     step=state.step)
