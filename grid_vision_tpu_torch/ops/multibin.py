"""MultiBin (Deep3DBox) post-processing: bins, alpha, theta_ray and the
64-combination least-squares location solver (counterpart of
grid_vision_tpu/ops/multibin.py; reference vision_orientation.cpp:241-519).

With the projection [K | 0] the 4x3 system matrix A is the same for all
64 constraint combinations, so the search is one 3x3 normal-equation
solve per box against 64 right-hand sides. The inverse is the JAX
package's closed form (adjugate / determinant, after a global 1/1024
rescale), not torch.linalg, so the argmin over the 64 residuals picks the
same combination.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridVisionConfig
from ..geometry import quat_from_pitch, rotation_y
from ..taxonomy import avg_dims, is_dynamic
from ..types import Boxes, LShapePoses
from ..utils import stats

# generateBins(2): centers [pi/2, 3pi/2].
ANGLE_BINS_2 = np.array([np.pi / 2.0, 3.0 * np.pi / 2.0], np.float32)

# combo c = ((l*4 + t)*2 + r)*4 + b in the reference's loop nesting
_C = np.arange(64)
_L_IDX, _T_IDX, _R_IDX, _B_IDX = _C // 32, (_C // 8) % 4, (_C // 4) % 2, _C % 4
_PM = np.array([-1.0, 1.0], np.float32)


def compute_alpha(orientation: torch.Tensor, confidence: torch.Tensor):
    """alpha = atan2(sin, cos) of the most confident bin + its center - pi."""
    with stats.span("sync"):
        bins = torch.as_tensor(ANGLE_BINS_2, device=orientation.device)
    am = torch.argmax(confidence, dim=-1)
    sel = torch.gather(orientation, 1, am[:, None, None].expand(-1, 1, 2))[:, 0]
    return torch.atan2(sel[:, 1], sel[:, 0]) + bins[am] - np.float32(np.pi)


def compute_theta_ray(boxes: Boxes, fx: float, orig_w: int) -> torch.Tensor:
    """Ray angle to the box center from the image geometry."""
    fovx = 2.0 * np.arctan(orig_w / (2.0 * fx))
    center_x = (boxes.xyxy[:, 0] + boxes.xyxy[:, 2]) / 2.0
    dx = center_x - orig_w / 2.0
    sign = torch.where(dx < 0, -1.0, 1.0)
    angle = torch.atan((2.0 * torch.abs(dx) * float(np.tan(fovx / 2.0)))
                       / orig_w)
    return sign * angle


def _constraint_combos(dx, dy, dz, left_mult, right_mult, switch_mult):
    """(N, 64, 4, 3) constraints: left(2) x top(4) x right(2) x bottom(4)."""
    dev = dx.device
    with stats.span("sync"):
        pm = torch.as_tensor(_PM, device=dev)
    ones2 = torch.ones(2, device=dev)
    ones4 = torch.ones(4, device=dev)
    left = torch.stack([(left_mult * dx)[:, None] * ones2,
                        pm * dy[:, None],
                        (-switch_mult * dz)[:, None] * ones2], dim=-1)
    right = torch.stack([(right_mult * dx)[:, None] * ones2,
                         pm * dy[:, None],
                         (switch_mult * dz)[:, None] * ones2], dim=-1)
    ii = pm.repeat_interleave(2)
    jj = pm.repeat(2)
    top = torch.stack([ii * dx[:, None], (-dy)[:, None] * ones4,
                       jj * dz[:, None]], dim=-1)
    bottom = torch.stack([ii * dx[:, None], dy[:, None] * ones4,
                          jj * dz[:, None]], dim=-1)
    # an index held on the host is copied to the device before use, and
    # that copy waits for the device's queue: one sync span each
    idx = []
    for host_idx in (_L_IDX, _T_IDX, _R_IDX, _B_IDX):
        with stats.span("sync"):
            idx.append(torch.as_tensor(host_idx, device=dev))
    return torch.stack([left[:, idx[0]], top[:, idx[1]], right[:, idx[2]],
                        bottom[:, idx[3]]], dim=2)


def _inv3x3_spd(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant), batched (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    adj = torch.stack([
        torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _calc_location(length, width, height, xyxy, alpha, theta_ray, K):
    """All boxes at once: best 3D location over the 64 constraint combos
    (calcLocation, :294-447). Returns (locs (N, 3), orient (N,))."""
    orient = alpha + theta_ray
    R = rotation_y(orient)                                    # (N, 3, 3)
    dx = length / 2.0
    dy = width / 2.0
    dz = height / 2.0

    deg88 = 88.0 * np.pi / 180.0
    deg90 = 90.0 * np.pi / 180.0
    deg92 = 92.0 * np.pi / 180.0
    in_plus90 = (alpha < deg92) & (alpha > deg88)
    in_minus90 = (alpha < -deg88) & (alpha > -deg92)
    in_front = (alpha < deg90) & (alpha > -deg90)
    left_mult = torch.where(in_plus90, 1.0, torch.where(
        in_minus90, -1.0, torch.where(in_front, -1.0, 1.0)))
    right_mult = torch.where(in_plus90, 1.0, torch.where(
        in_minus90, -1.0, torch.where(in_front, 1.0, -1.0)))
    switch_mult = torch.where(alpha > 0, 1.0, -1.0)

    X = _constraint_combos(dx, dy, dz, left_mult, right_mult, switch_mult)
    RX = X @ R.transpose(-1, -2)[:, None]                     # (N, 64, 4, 3)
    KRX = RX @ K.T

    with stats.span("sync"):
        row_idx = torch.tensor([0, 1, 0, 1], device=K.device)
    A = K[row_idx][None] - xyxy[:, :, None] * K[2][None, None, :]  # (N, 4, 3)
    krx_idx = torch.gather(
        KRX, -1, row_idx[None, None, :, None].expand(
            KRX.shape[0], 64, 4, 1))[..., 0]                  # (N, 64, 4)
    b = xyxy[:, None, :] * KRX[..., 2] - krx_idx              # (N, 64, 4)

    scale = 1.0 / 1024.0
    A_s = A * scale
    b_s = b * scale
    AtA = A_s.transpose(-1, -2) @ A_s                         # (N, 3, 3)
    Atb = b_s @ A_s                                           # (N, 64, 3)
    locs = Atb @ _inv3x3_spd(AtA).transpose(-1, -2)           # (N, 64, 3)
    resid = A_s @ locs.transpose(-1, -2) - b_s.transpose(-1, -2)
    errors = torch.sum(resid * resid, dim=-2)                 # (N, 64)
    best = torch.argmin(errors, dim=-1)                       # first min
    return locs[torch.arange(locs.shape[0], device=K.device), best], orient


def multibin_poses(orientation: torch.Tensor, confidence: torch.Tensor,
                   dims: torch.Tensor, boxes: Boxes, K: torch.Tensor,
                   cfg: GridVisionConfig) -> LShapePoses:
    """postProcessOutputs (:449-510) over a padded batch of boxes ->
    camera-frame LShapePoses; valid = box valid and dynamic class. Dims are
    class averages + residuals with the reference's remap: length <- [2],
    width <- [0], height <- [1]."""
    alpha = compute_alpha(orientation, confidence)
    theta_ray = compute_theta_ray(boxes, cfg.fx, cfg.camera_image_width)
    avg = avg_dims(boxes.label)
    length = dims[:, 2] + avg[:, 0]
    width = dims[:, 0] + avg[:, 1]
    height = dims[:, 1] + avg[:, 2]
    locs, orient = _calc_location(length, width, height, boxes.xyxy, alpha,
                                  theta_ray, K)
    return LShapePoses(
        position=locs, quat=quat_from_pitch(orient), length=length,
        width=width, height=height, label=boxes.label,
        valid=boxes.valid & is_dynamic(boxes.label))
