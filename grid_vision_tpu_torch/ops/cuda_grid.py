"""Fused occupancy-grid update: the ``grid_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_grid.py (lshape_update_pallas,
which the JAX fleet path runs under vmap). On a CUDA tensor
``lshape_update_cuda`` launches the hand-written kernel of
``csrc/cuda_grid.cu`` (its note says what bounds it and how); on a CPU
tensor it runs ``grid_update_plain``, the same math in plain torch.
Log-odds are bit-equal between the two. Grids may carry a leading rig
axis, (R, H, W) with (R, D, 4) ranges: one launch updates every rig.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import GridVisionConfig
from ..geometry import grid_index_from_position
from ..types import LShapePoses
from . import cuda_build
from .rasterize import hit_add, pose_footprint_corners

MAX_BOXES = 64          # GV_GRID_MAX_BOXES in csrc/cuda_grid.cu

# Kernel launches made by lshape_update_cuda (the main-path check reads it).
launches = 0


def box_index_ranges(poses: LShapePoses, cfg: GridVisionConfig):
    """(..., D, 4) int32 inclusive [row_lo, row_hi, col_lo, col_hi]
    footprint index ranges; invalid boxes and boxes with any corner off the
    map get the empty range (1, 0, 1, 0). Port of
    pallas_grid._box_index_ranges."""
    idx, corner_ok = grid_index_from_position(
        pose_footprint_corners(poses), cfg.grid_center,
        (float(cfg.grid_x), float(cfg.grid_y)), cfg.resolution)
    ok = (poses.valid & torch.all(corner_ok, dim=-1))[..., None]
    lo = idx.amin(dim=-2)
    hi = idx.amax(dim=-2)
    ranges = torch.stack([lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1]],
                         dim=-1)
    empty = torch.tensor([1, 0, 1, 0], dtype=torch.int32,
                         device=ranges.device)
    return torch.where(ok, ranges, empty).contiguous()


def grid_update_plain(log_odds: torch.Tensor, ranges: torch.Tensor,
                      cfg: GridVisionConfig):
    """The kernel's plain twin: count the boxes whose inclusive index block
    covers each cell, then fma(hit, count, lo + decay), clamp, sigmoid.
    log_odds (..., H, W), ranges (..., D, 4)."""
    h, w = log_odds.shape[-2:]
    rows = torch.arange(h, dtype=torch.int32, device=log_odds.device)
    cols = torch.arange(w, dtype=torch.int32, device=log_odds.device)
    row_in = ((rows >= ranges[..., 0:1])
              & (rows <= ranges[..., 1:2]))                   # (..., D, H)
    col_in = ((cols >= ranges[..., 2:3])
              & (cols <= ranges[..., 3:4]))                   # (..., D, W)
    counts = (row_in[..., :, :, None]
              & col_in[..., :, None, :]).float().sum(dim=-3)
    lo = hit_add(log_odds + cfg.log_odds_decay, cfg.log_odds_hit, counts)
    lo = torch.clamp(lo, cfg.min_log_odds, cfg.max_log_odds)
    return lo, 1.0 / (1.0 + torch.exp(-lo))


def _launch(log_odds: torch.Tensor, ranges: torch.Tensor,
            cfg: GridVisionConfig):
    global launches
    if log_odds.dtype != torch.float32 or log_odds.dim() not in (2, 3):
        raise ValueError("log_odds must be a (H, W) or (R, H, W) float32 "
                         "tensor")
    if not log_odds.is_contiguous():
        raise ValueError("log_odds must be contiguous")
    lead = log_odds.shape[:-2]
    if (ranges.device != log_odds.device or ranges.dtype != torch.int32
            or ranges.shape[:-2] != lead or ranges.dim() != len(lead) + 2
            or ranges.shape[-1] != 4 or not ranges.is_contiguous()):
        raise ValueError("ranges must be a contiguous (D, 4) or (R, D, 4) "
                         "int32 tensor matching the grid, on its device")
    n = ranges.shape[-2]
    if n > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes, got {n}")
    n_rigs = lead[0] if lead else 1
    lib = cuda_build.load("cuda_grid")
    fn = lib.gv_grid_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    h, w = log_odds.shape[-2:]
    lo_out = torch.empty_like(log_odds)
    occ_out = torch.empty_like(log_odds)
    stream = torch.cuda.current_stream(log_odds.device).cuda_stream
    cuda_build.check(
        fn(log_odds.data_ptr(), lo_out.data_ptr(), occ_out.data_ptr(),
           ranges.data_ptr(), n_rigs, n, h, w, cfg.log_odds_decay,
           cfg.log_odds_hit, cfg.min_log_odds, cfg.max_log_odds, stream),
        "gv_grid_update")
    launches += 1
    return lo_out, occ_out


def grid_update(log_odds: torch.Tensor, ranges: torch.Tensor,
                cfg: GridVisionConfig):
    """(log_odds', occupancy) from index ranges, (H, W) with (D, 4) or
    (R, H, W) with (R, D, 4): the kernel on a CUDA tensor, the plain twin
    on a CPU tensor."""
    if log_odds.device.type == "cpu":
        return grid_update_plain(log_odds, ranges, cfg)
    if log_odds.device.type != "cuda":
        raise ValueError(f"unsupported device {log_odds.device}")
    return _launch(log_odds, ranges, cfg)


def lshape_update_cuda(log_odds: torch.Tensor, poses: LShapePoses,
                       cfg: GridVisionConfig):
    """Drop-in replacement for rasterize.lshape_update."""
    return grid_update(log_odds, box_index_ranges(poses, cfg), cfg)
