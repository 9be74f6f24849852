"""PCA L-shape poses of per-box sub-clouds on tensors (counterpart of
grid_vision_tpu/ops/lshape.py; reference bboxPoseEstimation +
computePCABoundingBox, cloud_detections.cpp:140-247).

  - pcl::RadiusOutlierRemoval (r = 0.4, at least 10 neighbours, self
    included, :150-154): a pairwise squared-distance count of each valid
    point against its own box's slots, the valid points of all boxes
    packed first and counted in chunks, so that no (..., K, K, 3) or
    whole-fleet (R, D, K, K) tensor is ever held;
  - cv::PCA over (z, x) rows (:187-201): the closed-form 2x2 solution,
    theta = atan2(2 c_zx, c_zz - c_xx) / 2 is the major axis; signs fixed
    as major.x >= 0 and the minor flipped to x >= 0 (then y >= 0), since
    OpenCV's sign is unspecified;
  - extents from the min / max projections (:203-218);
  - quirk Q4: the yaw is computed in DEGREES (:227) and handed to setRPY,
    which takes radians (:236); the same wrong-unit quaternion here;
  - position (:230-232): (mean x, 3D centroid y, mean z) in the camera
    frame; height is never set by the reference's PCA path, here 0.

Boxes carry leading axes (R rigs, D boxes): pts (..., D, K, 3).
"""

from __future__ import annotations

import math

import torch

from ..geometry import quat_from_pitch
from ..types import LShapePoses

# Pairs of points one chunk of the radius count holds: ~1 GiB per f32
# temporary, two of them plus a bool one at the peak.
_MAX_PAIRS = 1 << 28
_FAR = 1.0e20          # an invalid point's coordinates: d2 overflows to inf


def radius_outlier_mask(pts: torch.Tensor, valid: torch.Tensor,
                        radius: float, min_neighbors: int,
                        max_valid: int | None = None) -> torch.Tensor:
    """Keep the valid points with >= min_neighbors valid points of their
    own sub-cloud (self included) within `radius`
    (pcl::RadiusOutlierRemoval). pts (..., D, K, 3) and valid (..., D, K):
    the sub-clouds of D boxes; d2 summed as (dx^2 + dy^2) + dz^2.

    The valid slots of the D boxes are packed first (a stable sort), and
    only they are counted, each against its own box's K slots: with
    max_valid, a bound on the valid slots of the D boxes together (the
    cloud's capacity, since a point lands in one box at most), that is
    max_valid x K pairs, not D x K x K. Invalid slots sit at _FAR, so no
    valid point counts them. The count runs in chunks of packed points."""
    *lead, d, k, _ = pts.shape
    g = 1
    for n in lead:
        g *= n
    far = torch.where(valid[..., None], pts,
                      torch.full((), _FAR, device=pts.device)).reshape(
                          g, d, k, 3)
    m = d * k if max_valid is None else min(max_valid, d * k)
    slot = torch.sort((~valid).reshape(g, d * k).to(torch.uint8), dim=-1,
                      stable=True).indices[:, :m]             # (g, m)
    box = (slot // k)[..., None]
    point = torch.take_along_dim(far.reshape(g, d * k, 3), slot[..., None],
                                 dim=-2)                      # (g, m, 3)
    coords = far.movedim(-1, 0).contiguous()                  # (3, g, D, K)
    chunk = max(1, _MAX_PAIRS // (g * k))
    r2 = radius * radius
    counts = []
    for s in range(0, m, chunk):
        d2 = None
        for axis in range(3):
            # the window minus the point: -dx, the same square
            t = torch.take_along_dim(coords[axis], box[:, s:s + chunk],
                                     dim=-2)                  # (g, c, K)
            t.sub_(point[:, s:s + chunk, axis, None])
            t.mul_(t)
            d2 = t if d2 is None else d2.add_(t)
        counts.append((d2 <= r2).sum(dim=-1))
        del d2, t
    full = torch.zeros((g, d * k), dtype=torch.int64, device=pts.device)
    full.scatter_(-1, slot, torch.cat(counts, dim=-1))
    return valid & (full.reshape(valid.shape) >= min_neighbors)


def pca_pose(pts: torch.Tensor, kept: torch.Tensor):
    """Filtered camera-frame sub-clouds (..., K, 3) with (..., K) kept
    flags -> (px, py, pz, length, width, angle_deg, ok), each (...)."""
    w = kept.to(torch.float32)
    safe_n = torch.clamp(w.sum(dim=-1), min=1.0)[..., None]
    centroid = (pts * w[..., None]).sum(dim=-2) / safe_n       # (..., 3)
    data = torch.stack([pts[..., 2], pts[..., 0]], dim=-1)     # (z, x)
    mean = (data * w[..., None]).sum(dim=-2) / safe_n          # (..., 2)
    diff = data - mean[..., None, :]
    cov = (diff * w[..., None]).transpose(-1, -2) @ diff / safe_n[..., None]

    theta = 0.5 * torch.atan2(2.0 * cov[..., 0, 1],
                              cov[..., 0, 0] - cov[..., 1, 1])
    major = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    minor = torch.stack([-major[..., 1], major[..., 0]], dim=-1)
    flip = (minor[..., 0] < 0) | ((minor[..., 0] == 0) & (minor[..., 1] < 0))
    minor = torch.where(flip[..., None], -minor, minor)

    proj_l = (diff @ major[..., None])[..., 0]
    proj_w = (diff @ minor[..., None])[..., 0]
    inf = torch.full((), math.inf, device=pts.device)

    def extent(proj):
        return (torch.where(kept, proj, -inf).amax(dim=-1)
                - torch.where(kept, proj, inf).amin(dim=-1))

    ok = kept.any(dim=-1)
    zero = torch.zeros((), device=pts.device)
    length = torch.where(ok, extent(proj_l), zero)
    width = torch.where(ok, extent(proj_w), zero)
    angle_deg = torch.atan2(major[..., 1], major[..., 0]) * (180.0 / math.pi)
    return (mean[..., 1], centroid[..., 1], mean[..., 0], length, width,
            angle_deg, ok)


def pca_lshape_poses(box_pts: torch.Tensor, box_valid: torch.Tensor,
                     labels: torch.Tensor, radius: float, min_neighbors: int,
                     max_valid: int | None = None) -> LShapePoses:
    """PCA L-shape over every box: box_pts (..., D, K, 3) camera-frame
    sub-clouds, box_valid (..., D, K), max_valid as radius_outlier_mask.
    Camera-frame LShapePoses; valid = the filtered sub-cloud is not empty
    (the reference's ``continue`` on empty data, :174-175)."""
    kept = radius_outlier_mask(box_pts, box_valid, radius, min_neighbors,
                               max_valid)
    px, py, pz, length, width, angle_deg, ok = pca_pose(box_pts, kept)
    return LShapePoses(
        position=torch.stack([px, py, pz], dim=-1),
        quat=quat_from_pitch(angle_deg),    # degrees fed as radians (Q4)
        length=length, width=width, height=torch.zeros_like(length),
        label=labels, valid=ok)
