"""LiDAR <-> camera association on tensors (counterpart of
grid_vision_tpu/ops/association.py; reference cloud_detections.cpp:8-87).

The KD-tree k-NN of computeDepthForBoundingBoxes becomes an exact
brute-force search over the projected cloud, keeping the reference's 3D
metric quirk: the tree stores (u, v, depth) and the query has depth 0, so
depth^2 takes part in the distance. This is the ``knn_backend="xla"`` path;
``ops/cuda_knn.py`` holds the kernel. Every function takes leading rig
axes (the fleet path's (R, P, 3) clouds and (R, D) boxes).
"""

from __future__ import annotations

import torch

from ..geometry import project_points
from ..types import Boxes, PointCloud


def project_cloud_to_image(cloud: PointCloud, K: torch.Tensor):
    """Camera-frame points with z > 0 -> (uvd (..., P, 3), valid (..., P));
    invalid rows are parked at PAD_SENTINEL so they never win a search."""
    u, v, depth = project_points(cloud.xyz, K)
    valid = cloud.mask() & (cloud.xyz[..., 2] > 0.0)
    uvd = torch.stack([u, v, depth], dim=-1)
    uvd = torch.where(valid[..., None], uvd,
                      torch.full((), PointCloud.PAD_SENTINEL,
                                 device=uvd.device))
    return uvd, valid


def knn_sq_distances(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                     centers: torch.Tensor) -> torch.Tensor:
    """(..., D, P) d2 = (cx - u)^2 + (cy - v)^2 + depth^2, +inf for
    invalid points (op for op the order of the JAX package's XLA path)."""
    du = centers[..., :, None, 0] - uvd[..., None, :, 0]
    dv = centers[..., :, None, 1] - uvd[..., None, :, 1]
    z = uvd[..., None, :, 2]
    d2 = (du * du + dv * dv) + z * z
    return torch.where(uvd_valid[..., None, :], d2,
                       torch.full((), float("inf"), device=d2.device))


def median_of_selected(d2_sel: torch.Tensor, z_sel: torch.Tensor,
                       k: int) -> torch.Tensor:
    """Upper median (index n // 2) of the depths of the found neighbors
    (finite d2), -1.0 where none was found. d2_sel, z_sel: (..., D, k)."""
    found = torch.isfinite(d2_sel)
    n_found = found.sum(dim=-1)
    depths = torch.where(found, z_sel,
                         torch.full((), float("inf"), device=z_sel.device))
    depths_sorted = torch.sort(depths, dim=-1).values
    mid = torch.clamp(n_found // 2, 0, k - 1)
    median = torch.gather(depths_sorted, -1, mid[..., None])[..., 0]
    return torch.where(n_found > 0, median,
                       torch.full((), -1.0, device=median.device))


def knn_median_depth(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                     boxes: Boxes, k: int) -> torch.Tensor:
    """computeDepthForBoundingBoxes: for each box center the k nearest
    (u, v, depth) points, then the upper median of their depths; -1.0 when
    the projected cloud is empty. Ties in d2 go to the lowest point index
    (a stable sort). Returns (D,) f32."""
    return knn_median_depth_centers(uvd, uvd_valid, boxes.centers(), k)


def knn_median_depth_centers(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                             centers: torch.Tensor, k: int) -> torch.Tensor:
    """knn_median_depth on (..., D, 2) query centers: the dense (..., D, P)
    distance matrix and a stable sort."""
    d2 = knn_sq_distances(uvd, uvd_valid, centers)
    k_eff = min(k, d2.shape[-1])
    order = torch.sort(d2, dim=-1, stable=True).indices[..., :k_eff]
    d2_sel = torch.gather(d2, -1, order)
    z = uvd[..., None, :, 2].expand(d2.shape)
    z_sel = torch.gather(z, -1, order)
    if k_eff < k:                      # fewer points than k: pad as unfound
        pad = torch.full(d2.shape[:-1] + (k - k_eff,), float("inf"),
                         device=d2.device)
        d2_sel = torch.cat([d2_sel, pad], dim=-1)
        z_sel = torch.cat([z_sel, pad], dim=-1)
    return median_of_selected(d2_sel, z_sel, k)
