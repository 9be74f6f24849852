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

The ``*_gated`` entry points add the tick's epilogue, the run gate and the
int8 export, fused into the same pass as in ops/cuda_grid.py.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import GridVisionConfig
from ..types import LShapePoses
from . import cuda_build, cuda_grid
from .rasterize import gate_and_export
from .raycast import cell_polar_maps, range_profile

MAX_BOXES = cuda_grid.MAX_BOXES   # GV_GRID_MAX_BOXES in csrc/gv_grid.cuh
# GV_CARVE_MAX_BINS in csrc/cuda_raycast.cu: a rig's profile is at most 32
# KB, which the kernel reads through L1. The Pallas kernel's n_bins ==
# 64 * 64 rule is gone; this bound takes its place.
MAX_BINS = 8192

# Kernel launches made by this module's wrappers (the main-path check reads
# it).
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


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_raycast").gv_carve_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                   + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    return fn


def _launch(log_odds, box_ranges, ranges, cbin, cr, cfg, log_odds_free,
            gate=None, occ_prev=None):
    global launches
    n = cuda_grid.check_grid_inputs(log_odds, box_ranges)
    dev, shape = log_odds.device, log_odds.shape
    n_bins = ranges.shape[-1] if ranges.dim() else 0
    if not 0 < n_bins <= MAX_BINS:
        raise ValueError(f"between 1 and {MAX_BINS} angle bins, got "
                         f"{n_bins}")
    cuda_grid.check_tensor(ranges, "ranges", cuda_grid.F32,
                           shape[:-2] + (n_bins,), dev)
    cuda_grid.check_tensor(cbin, "cbin", cuda_grid.I32, shape[-2:], dev)
    cuda_grid.check_tensor(cr, "cr", cuda_grid.F32, shape[-2:], dev)
    out = cuda_grid.outputs(log_odds, gate, occ_prev)
    cuda_build.check(
        _entry()(*cuda_grid.pointers(log_odds, *out, gate, occ_prev,
                                     box_ranges, ranges, cbin, cr),
                 shape[0] if len(shape) == 3 else 1, n, n_bins, shape[-2],
                 shape[-1], cfg.log_odds_decay, cfg.log_odds_hit,
                 log_odds_free, cfg.resolution * 1.5, cfg.min_log_odds,
                 cfg.max_log_odds,
                 torch.cuda.current_stream(dev).cuda_stream),
        "gv_carve_update")
    launches += 1
    return out if gate is not None else out[:2]


def fused_carve_update_cuda(log_odds: torch.Tensor, box_ranges: torch.Tensor,
                            ranges: torch.Tensor, cbin: torch.Tensor,
                            cr: torch.Tensor, cfg: GridVisionConfig,
                            log_odds_free: float = -0.4):
    """(log_odds', occupancy) from box index ranges, a range profile and
    the polar maps: the kernel on a CUDA tensor, the plain twin on a CPU
    tensor."""
    if not cuda_grid.on_cuda(log_odds):
        return carve_update_plain(log_odds, box_ranges, ranges, cbin, cr,
                                  cfg, log_odds_free)
    return _launch(log_odds, box_ranges, ranges, cbin, cr, cfg,
                   log_odds_free)


def fused_carve_update_gated(log_odds: torch.Tensor,
                             box_ranges: torch.Tensor, ranges: torch.Tensor,
                             cbin: torch.Tensor, cr: torch.Tensor,
                             gate: torch.Tensor, occ_prev: torch.Tensor,
                             cfg: GridVisionConfig,
                             log_odds_free: float = -0.4):
    """fused_carve_update_cuda with the epilogue: rigs where `gate` ((R,)
    or () bool) is False keep log_odds and occ_prev; then the int8 export.
    Returns (log_odds', occupancy, occupancy_i8): one kernel launch on a
    CUDA tensor, the twin then rasterize.gate_and_export on a CPU tensor."""
    if not cuda_grid.on_cuda(log_odds):
        lo, occ = carve_update_plain(log_odds, box_ranges, ranges, cbin, cr,
                                     cfg, log_odds_free)
        return gate_and_export(lo, occ, gate, log_odds, occ_prev)
    return _launch(log_odds, box_ranges, ranges, cbin, cr, cfg,
                   log_odds_free, gate, occ_prev)


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


def lshape_update_with_carving_gated_cuda(
        log_odds: torch.Tensor, poses: LShapePoses, origin_xy: torch.Tensor,
        points_xy: torch.Tensor, points_valid: torch.Tensor,
        gate: torch.Tensor, occ_prev: torch.Tensor, cfg: GridVisionConfig,
        log_odds_free: float = -0.4, maps=None):
    """raycast.lshape_update_with_carving, the run gate and the int8 export
    in one pass: (log_odds', occupancy, occupancy_i8)."""
    ranges = range_profile(origin_xy, points_xy, points_valid)
    cbin, cr = maps if maps is not None else cell_polar_maps(origin_xy, cfg)
    return fused_carve_update_gated(
        log_odds, cuda_grid.box_index_ranges(poses, cfg), ranges, cbin, cr,
        gate, occ_prev, cfg, log_odds_free)


def blocks_per_sm():
    """Blocks of the kernel one SM holds (vector path, scalar path), for
    the build report."""
    blocks = (ctypes.c_int * 2)()
    fn = cuda_build.load("cuda_raycast").gv_carve_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    cuda_build.check(fn(ctypes.addressof(blocks)), "gv_carve_blocks_per_sm")
    return dict(vector=blocks[0], scalar=blocks[1])
