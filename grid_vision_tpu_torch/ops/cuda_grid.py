"""Fused occupancy-grid update: the ``grid_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_grid.py (lshape_update_pallas,
which the JAX fleet path runs under vmap). On a CUDA tensor
``lshape_update_cuda`` launches the hand-written kernel of
``csrc/cuda_grid.cu`` (its note says what bounds it and how); on a CPU
tensor it runs ``grid_update_plain``, the same math in plain torch.
Log-odds are bit-equal between the two. Grids may carry a leading rig
axis, (R, H, W) with (R, D, 4) ranges: one launch updates every rig.

The ``*_gated`` entry points add the tick's epilogue: the run gate and the
int8 export (``rasterize.gate_and_export``), which the kernel fuses into the
same pass; they return (log_odds, occupancy, occupancy_i8).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..config import GridVisionConfig
from ..geometry import grid_index_from_position
from ..types import LShapePoses
from . import cuda_build
from .rasterize import gate_and_export, hit_add, pose_footprint_corners

MAX_BOXES = 64          # GV_GRID_MAX_BOXES in csrc/gv_grid.cuh
CELLS_PER_THREAD = 8    # GV_GRID_CELLS_PER_THREAD in csrc/gv_grid.cuh

# Kernel launches made by this module's wrappers (the main-path check reads
# it).
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


F32 = (torch.float32,)
I32 = (torch.int32,)
GATE = (torch.bool, torch.uint8)


def check_tensor(t: torch.Tensor, name: str, dtypes, shape, device) -> None:
    """Raise unless t is a contiguous tensor of `shape`, of one of `dtypes`,
    on `device` (what a kernel takes)."""
    if (t.dtype not in dtypes or t.shape != shape or t.device != device
            or not t.is_contiguous()):
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} "
            f"{' or '.join(str(d) for d in dtypes)} tensor on {device}")


def check_grid_inputs(log_odds: torch.Tensor, ranges: torch.Tensor) -> int:
    """Check the log-odds ((H, W) or (R, H, W) float32) and box ranges
    ((D, 4) or (R, D, 4) int32, D <= MAX_BOXES) a grid kernel takes;
    returns D."""
    if log_odds.dim() not in (2, 3):
        raise ValueError("log_odds must be a (H, W) or (R, H, W) tensor")
    check_tensor(log_odds, "log_odds", F32, log_odds.shape, log_odds.device)
    n = ranges.shape[-2] if ranges.dim() >= 2 else -1
    if n > MAX_BOXES:
        raise ValueError(f"at most {MAX_BOXES} boxes, got {n}")
    check_tensor(ranges, "ranges", I32, log_odds.shape[:-2] + (n, 4),
                 log_odds.device)
    return n


def outputs(log_odds: torch.Tensor, gate, occ_prev):
    """The outputs a grid kernel writes: (log_odds, occupancy, occupancy_i8
    or None without a gate), after checking the epilogue's inputs: gate
    bool or uint8 over the grid's leading axes, occ_prev float32 of the
    grid's shape."""
    lo_out = torch.empty_like(log_odds)
    occ_out = torch.empty_like(log_odds)
    if gate is None:
        return lo_out, occ_out, None
    check_tensor(gate, "gate", GATE, log_odds.shape[:-2], log_odds.device)
    check_tensor(occ_prev, "occ_prev", F32, log_odds.shape, log_odds.device)
    return lo_out, occ_out, torch.empty_like(log_odds, dtype=torch.int8)


def pointers(*tensors):
    """data_ptr of each tensor, None for None."""
    return [None if t is None else t.data_ptr() for t in tensors]


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_grid").gv_grid_update
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    return fn


def _launch(log_odds: torch.Tensor, ranges: torch.Tensor,
            cfg: GridVisionConfig, gate=None, occ_prev=None):
    global launches
    n = check_grid_inputs(log_odds, ranges)
    out = outputs(log_odds, gate, occ_prev)
    shape = log_odds.shape
    cuda_build.check(
        _entry()(*pointers(log_odds, *out, gate, occ_prev, ranges),
                 shape[0] if len(shape) == 3 else 1, n, shape[-2],
                 shape[-1], cfg.log_odds_decay, cfg.log_odds_hit,
                 cfg.min_log_odds, cfg.max_log_odds,
                 torch.cuda.current_stream(log_odds.device).cuda_stream),
        "gv_grid_update")
    launches += 1
    return out if gate is not None else out[:2]


def on_cuda(log_odds: torch.Tensor) -> bool:
    """False for a CPU tensor (the twin runs), True for a CUDA one (the
    kernel runs); raises for any other device."""
    if log_odds.device.type == "cpu":
        return False
    if log_odds.device.type != "cuda":
        raise ValueError(f"unsupported device {log_odds.device}")
    return True


def grid_update(log_odds: torch.Tensor, ranges: torch.Tensor,
                cfg: GridVisionConfig):
    """(log_odds', occupancy) from index ranges, (H, W) with (D, 4) or
    (R, H, W) with (R, D, 4): the kernel on a CUDA tensor, the plain twin
    on a CPU tensor."""
    if not on_cuda(log_odds):
        return grid_update_plain(log_odds, ranges, cfg)
    return _launch(log_odds, ranges, cfg)


def grid_update_gated(log_odds: torch.Tensor, ranges: torch.Tensor,
                      gate: torch.Tensor, occ_prev: torch.Tensor,
                      cfg: GridVisionConfig):
    """grid_update with the epilogue: rigs where `gate` ((R,) or () bool)
    is False keep log_odds and occ_prev; then the int8 export. Returns
    (log_odds', occupancy, occupancy_i8): one kernel launch on a CUDA
    tensor, the twin then rasterize.gate_and_export on a CPU tensor."""
    if not on_cuda(log_odds):
        lo, occ = grid_update_plain(log_odds, ranges, cfg)
        return gate_and_export(lo, occ, gate, log_odds, occ_prev)
    return _launch(log_odds, ranges, cfg, gate, occ_prev)


def lshape_update_cuda(log_odds: torch.Tensor, poses: LShapePoses,
                       cfg: GridVisionConfig):
    """Drop-in replacement for rasterize.lshape_update."""
    return grid_update(log_odds, box_index_ranges(poses, cfg), cfg)


def lshape_update_gated_cuda(log_odds: torch.Tensor, poses: LShapePoses,
                             gate: torch.Tensor, occ_prev: torch.Tensor,
                             cfg: GridVisionConfig):
    """rasterize.lshape_update, the run gate and the int8 export in one
    pass: (log_odds', occupancy, occupancy_i8)."""
    return grid_update_gated(log_odds, box_index_ranges(poses, cfg), gate,
                             occ_prev, cfg)


def blocks_per_sm():
    """Blocks of the kernel one SM holds (vector path, scalar path), for
    the build report."""
    blocks = (ctypes.c_int * 2)()
    fn = cuda_build.load("cuda_grid").gv_grid_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    cuda_build.check(fn(ctypes.addressof(blocks)), "gv_grid_blocks_per_sm")
    return dict(vector=blocks[0], scalar=blocks[1])
