"""Raycast free-space carving on tensors (counterpart of
grid_vision_tpu/ops/raycast.py): the extension the reference declares but
never implements.

The reference declares log_odds_free_ = -0.4 (occupancy_grid.hpp:25-26) and
never uses it: free space comes only from the decay (quirk Q2). Here a scan
carves the cells its rays cross. The polar beam model: every endpoint's
range goes by scatter-max into one of ``n_bins`` angle bins around the
sensor, the profile is dilated by +-2 bins, and a cell is carved iff its
own (angle bin, centre range) lies strictly inside its bin's measured
range, short of it by one and a half cells (the endpoint's own cell holds
the hit evidence). ``carve_mask_sampled`` is the exact per-ray semantics
the polar model is tested against.

Enabled by GridVisionConfig(raycast_free_space=True, compat=False). Points,
masks and grids may carry a leading rig axis; the sensor origin and the
per-cell polar maps are one per engine (one Extrinsics serves every rig).
"""

from __future__ import annotations

import math

import torch

from ..config import GridVisionConfig
from ..geometry import grid_index_from_position, grid_position_from_index
from ..types import LShapePoses
from . import rasterize

N_BINS = 4096
BIN_DILATION = 2


def default_samples(cfg: GridVisionConfig) -> int:
    """Sample count whose step is at most one cell along the longest ray
    inside the map (the grid diagonal)."""
    diag = (cfg.grid_x ** 2 + cfg.grid_y ** 2) ** 0.5
    return int(diag / cfg.resolution) + 8


def carve_mask_sampled(origin_xy: torch.Tensor, points_xy: torch.Tensor,
                       valid: torch.Tensor, cfg: GridVisionConfig,
                       n_samples: int | None = None) -> torch.Tensor:
    """Exact per-ray carve: dense samples along each ray scattered to
    cells, the endpoint's own cell left out. (..., P, 2) endpoints ->
    (..., H, W) float mask. O(P * S) scatter updates: for tests."""
    if n_samples is None:
        n_samples = default_samples(cfg)
    h, w = cfg.grid_size
    length = (float(cfg.grid_x), float(cfg.grid_y))
    frac = (torch.arange(n_samples, dtype=torch.float32,
                         device=points_xy.device) + 0.5) / n_samples
    # (..., P, S, 2) sample points strictly inside (origin, endpoint)
    samples = origin_xy + frac[:, None] * (points_xy[..., None, :]
                                           - origin_xy)
    idx, ok = grid_index_from_position(samples, cfg.grid_center, length,
                                       cfg.resolution)
    end_idx, end_ok = grid_index_from_position(points_xy, cfg.grid_center,
                                               length, cfg.resolution)
    not_end = (~torch.all(idx == end_idx[..., None, :], dim=-1)
               | ~end_ok[..., None])
    use = ok & not_end & valid[..., None]
    flat = torch.where(use, idx[..., 0] * w + idx[..., 1], 0).long()
    lead = points_xy.shape[:-2]
    mask = torch.zeros(lead + (h * w,), dtype=torch.float32,
                       device=points_xy.device)
    mask.scatter_reduce_(-1, flat.reshape(lead + (-1,)),
                         use.float().reshape(lead + (-1,)), "amax",
                         include_self=True)
    return mask.reshape(lead + (h, w))


def _angle_bin(theta: torch.Tensor, n_bins: int) -> torch.Tensor:
    return torch.clamp(((theta + math.pi) * (n_bins / (2.0 * math.pi)))
                       .to(torch.int32), 0, n_bins - 1)


def range_profile(origin_xy: torch.Tensor, points_xy: torch.Tensor,
                  valid: torch.Tensor, n_bins: int = N_BINS) -> torch.Tensor:
    """(..., n_bins) largest endpoint range per angle bin, dilated by +-2
    bins (scans sparser than the bin grid would leave striped gaps).
    Invalid points contribute 0. Deterministic on the card too: the
    scatter's atomics take a maximum, which no order of arrival changes."""
    rel = points_xy - origin_xy
    r = torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1])
    pbin = _angle_bin(torch.atan2(rel[..., 1], rel[..., 0]), n_bins)
    ranges = torch.zeros(points_xy.shape[:-2] + (n_bins,),
                         dtype=torch.float32, device=points_xy.device)
    ranges.scatter_reduce_(-1, pbin.long(),
                           torch.where(valid, r, torch.zeros_like(r)),
                           "amax", include_self=True)
    return torch.stack(
        [torch.roll(ranges, s, dims=-1)
         for s in range(-BIN_DILATION, BIN_DILATION + 1)]).amax(dim=0)


def cell_polar_maps(origin_xy: torch.Tensor, cfg: GridVisionConfig,
                    n_bins: int = N_BINS):
    """Per-cell polar geometry: ((H, W) int32 angle bin, (H, W) f32 range
    of the cell centre from the origin). The plain carve and the fused
    kernel (ops/cuda_raycast.py) consume the same maps; their bit-equality
    rests on that."""
    h, w = cfg.grid_size
    centers = rasterize._cell_centers(h, w, cfg, origin_xy.device)
    crel = centers - origin_xy
    cbin = _angle_bin(torch.atan2(crel[..., 1], crel[..., 0]), n_bins)
    cr = torch.sqrt(crel[..., 0] * crel[..., 0]
                    + crel[..., 1] * crel[..., 1])
    return cbin, cr


def cell_range_map(ranges: torch.Tensor, origin_xy: torch.Tensor,
                   cfg: GridVisionConfig) -> torch.Tensor:
    """(..., H, W) measured beam range at each cell's angle bin."""
    cbin, _ = cell_polar_maps(origin_xy, cfg, ranges.shape[-1])
    return ranges[..., cbin.long()]


def _carve(ranges: torch.Tensor, cbin: torch.Tensor, cr: torch.Tensor,
           cfg: GridVisionConfig) -> torch.Tensor:
    """(..., H, W) float mask from a (..., n_bins) profile and the maps:
    strictly inside the beam, short of the endpoint by 1.5 cells."""
    cell_range = ranges[..., cbin.long()]
    margin = cfg.resolution * 1.5
    return ((cr < cell_range - margin) & (cell_range > 0)).float()


def carve_mask(origin_xy: torch.Tensor, points_xy: torch.Tensor,
               valid: torch.Tensor, cfg: GridVisionConfig,
               n_bins: int = N_BINS) -> torch.Tensor:
    """(..., H, W) float mask: 1 where a sensor ray crossed the cell.
    origin_xy (2,) sensor position, points_xy (..., P, 2) ray endpoints,
    both in the base frame; valid (..., P)."""
    ranges = range_profile(origin_xy, points_xy, valid, n_bins)
    cbin, cr = cell_polar_maps(origin_xy, cfg, n_bins)
    return _carve(ranges, cbin, cr, cfg)


def lshape_update_with_carving(log_odds: torch.Tensor, poses: LShapePoses,
                               origin_xy: torch.Tensor,
                               points_xy: torch.Tensor,
                               points_valid: torch.Tensor,
                               cfg: GridVisionConfig,
                               log_odds_free: float = -0.4, maps=None):
    """Extension-mode grid update: carve, decay, box hits, clamp, sigmoid.
    grid_backend="pallas" runs the fused kernel (ops/cuda_raycast.py,
    bit-equal), else this plain chain. maps: the (cbin, cr) of
    cell_polar_maps for this origin, when the caller keeps them."""
    if cfg.grid_backend == "pallas":
        from .cuda_raycast import lshape_update_with_carving_cuda
        return lshape_update_with_carving_cuda(
            log_odds, poses, origin_xy, points_xy, points_valid, cfg,
            log_odds_free, maps)
    ranges = range_profile(origin_xy, points_xy, points_valid)
    cbin, cr = maps if maps is not None else cell_polar_maps(origin_xy, cfg)
    return carve_update_from_maps(log_odds, poses, ranges, cbin, cr, cfg,
                                  log_odds_free)


def carve_update_from_maps(log_odds: torch.Tensor, poses: LShapePoses,
                           ranges: torch.Tensor, cbin: torch.Tensor,
                           cr: torch.Tensor, cfg: GridVisionConfig,
                           log_odds_free: float = -0.4):
    """The plain carve and update from a range profile and the polar maps:
    what the fused kernel is held to, bit for bit."""
    log_odds = log_odds + log_odds_free * _carve(ranges, cbin, cr, cfg)
    return rasterize.lshape_update(log_odds, poses, cfg)
