"""Fused raycast carve + occupancy-grid update: the ``grid_backend="pallas"``
path of the extension-mode tick (``raycast_free_space=True``).

Counterpart of grid_vision_tpu/ops/pallas_raycast.py (fused_carve_update,
lshape_update_with_carving_pallas). On a CUDA tensor
``fused_carve_update_cuda`` launches the hand-written kernel of
``csrc/cuda_raycast.cu`` (its note says what bounds it and how); on a CPU
tensor it runs ``carve_update_plain``, the same math in plain torch.
Log-odds are bit-equal between the two. The range profile and the per-cell
polar maps are inputs, computed by ops/raycast.py's torch functions for
kernel and twin alike. Grids may carry a leading rig axis: (R, H, W) with
(R, D, 4) box ranges and an (R, n_bins) profile, the (H, W) maps shared by
all rigs; one launch updates every rig (the Pallas kernel was unusable
under vmap; this one has no such limit and the fleet path takes it).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import GridVisionConfig
from ..types import LShapePoses
from . import cuda_build, cuda_grid
from .raycast import cell_polar_maps, range_profile

MAX_BOXES = cuda_grid.MAX_BOXES   # GV_CARVE_MAX_BOXES in csrc/cuda_raycast.cu
# The profile is staged in shared memory, at most 32 KB of it: the Pallas
# kernel's n_bins == 64 * 64 rule is gone, this bound takes its place.
MAX_BINS = 8192

# Kernel launches made by fused_carve_update_cuda (the main-path check
# reads it).
launches = 0


def carve_update_plain(log_odds: torch.Tensor, box_ranges: torch.Tensor,
                       ranges: torch.Tensor, cbin: torch.Tensor,
                       cr: torch.Tensor, cfg: GridVisionConfig,
                       log_odds_free: float = -0.4):
    """The kernel's plain twin: look each cell's beam range up in the
    profile (a bin outside [0, n_bins) reads as 0), carve where
    cr < range - 1.5 cells and range > 0, lo + free * carve, then the grid
    kernel's twin (decay, fma(hit, count, .), clamp, sigmoid).
    log_odds (..., H, W), box_ranges (..., D, 4), ranges (..., n_bins),
    cbin / cr (H, W)."""
    n_bins = ranges.shape[-1]
    in_table = (cbin >= 0) & (cbin < n_bins)
    cell_range = torch.where(
        in_table, ranges[..., cbin.clamp(0, n_bins - 1).long()],
        torch.zeros((), device=ranges.device))
    margin = cfg.resolution * 1.5
    carve = ((cr < cell_range - margin) & (cell_range > 0)).float()
    return cuda_grid.grid_update_plain(log_odds + log_odds_free * carve,
                                       box_ranges, cfg)


def _launch(log_odds, box_ranges, ranges, cbin, cr, cfg, log_odds_free):
    global launches
    if log_odds.dtype != torch.float32 or log_odds.dim() not in (2, 3):
        raise ValueError("log_odds must be a (H, W) or (R, H, W) float32 "
                         "tensor")
    if not log_odds.is_contiguous():
        raise ValueError("log_odds must be contiguous")
    dev = log_odds.device
    lead = log_odds.shape[:-2]
    grid = log_odds.shape[-2:]
    if (box_ranges.device != dev or box_ranges.dtype != torch.int32
            or box_ranges.shape[:-2] != lead
            or box_ranges.dim() != len(lead) + 2
            or box_ranges.shape[-1] != 4 or not box_ranges.is_contiguous()):
        raise ValueError("box_ranges must be a contiguous (D, 4) or "
                         "(R, D, 4) int32 tensor matching the grid, on its "
                         "device")
    n = box_ranges.shape[-2]
    if n > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes, got {n}")
    if (ranges.device != dev or ranges.dtype != torch.float32
            or ranges.shape[:-1] != lead or ranges.dim() != len(lead) + 1
            or not ranges.is_contiguous()):
        raise ValueError("ranges must be a contiguous (n_bins,) or "
                         "(R, n_bins) float32 tensor matching the grid, on "
                         "its device")
    n_bins = ranges.shape[-1]
    if not 0 < n_bins <= MAX_BINS:
        raise ValueError(f"between 1 and {MAX_BINS} angle bins, got "
                         f"{n_bins}")
    for name, m, dtype in (("cbin", cbin, torch.int32),
                           ("cr", cr, torch.float32)):
        if (m.device != dev or m.dtype != dtype or m.shape != grid
                or not m.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(grid)} "
                             f"{dtype} tensor on the grid's device")
    n_rigs = lead[0] if lead else 1
    lib = cuda_build.load("cuda_raycast")
    fn = lib.gv_carve_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    h, w = grid
    lo_out = torch.empty_like(log_odds)
    occ_out = torch.empty_like(log_odds)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(log_odds.data_ptr(), lo_out.data_ptr(), occ_out.data_ptr(),
           box_ranges.data_ptr(), ranges.data_ptr(), cbin.data_ptr(),
           cr.data_ptr(), n_rigs, n, n_bins, h, w, cfg.log_odds_decay,
           cfg.log_odds_hit, log_odds_free, cfg.resolution * 1.5,
           cfg.min_log_odds, cfg.max_log_odds, stream),
        "gv_carve_update")
    launches += 1
    return lo_out, occ_out


def fused_carve_update_cuda(log_odds: torch.Tensor, box_ranges: torch.Tensor,
                            ranges: torch.Tensor, cbin: torch.Tensor,
                            cr: torch.Tensor, cfg: GridVisionConfig,
                            log_odds_free: float = -0.4):
    """(log_odds', occupancy) from box index ranges, a range profile and
    the polar maps: the kernel on a CUDA tensor, the plain twin on a CPU
    tensor."""
    if log_odds.device.type == "cpu":
        return carve_update_plain(log_odds, box_ranges, ranges, cbin, cr,
                                  cfg, log_odds_free)
    if log_odds.device.type != "cuda":
        raise ValueError(f"unsupported device {log_odds.device}")
    return _launch(log_odds, box_ranges, ranges, cbin, cr, cfg,
                   log_odds_free)


def lshape_update_with_carving_cuda(log_odds: torch.Tensor,
                                    poses: LShapePoses,
                                    origin_xy: torch.Tensor,
                                    points_xy: torch.Tensor,
                                    points_valid: torch.Tensor,
                                    cfg: GridVisionConfig,
                                    log_odds_free: float = -0.4, maps=None):
    """Drop-in replacement for raycast.lshape_update_with_carving."""
    ranges = range_profile(origin_xy, points_xy, points_valid)
    cbin, cr = maps if maps is not None else cell_polar_maps(origin_xy, cfg)
    return fused_carve_update_cuda(
        log_odds, cuda_grid.box_index_ranges(poses, cfg), ranges, cbin, cr,
        cfg, log_odds_free)
