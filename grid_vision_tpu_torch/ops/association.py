"""LiDAR <-> camera association on tensors (counterpart of
grid_vision_tpu/ops/association.py; reference cloud_detections.cpp:8-87).

The KD-tree k-NN of computeDepthForBoundingBoxes becomes an exact
brute-force search over the projected cloud, keeping the reference's 3D
metric quirk: the tree stores (u, v, depth) and the query has depth 0, so
depth^2 takes part in the distance. This is the ``knn_backend="xla"`` path
and the ``"approx"`` one (the JAX package's jax.lax.approx_min_k, a TPU
partial reduction, is exact with ties to the lowest index on the CPU: this
search). ``knn_select_nearest`` picks each row's k nearest points in the
order of a stable sort without sorting the row: torch.topk leaves the
order of equal values unspecified, so it selects on keys that no two
points share. ``ops/cuda_knn.py`` holds the kernel. Every function takes
leading rig axes (the fleet path's (R, P, 3) clouds and (R, D) boxes).
"""

from __future__ import annotations

import torch

from ..geometry import project_points
from ..types import Boxes, PointCloud

# Row selections made by knn_select_nearest (one per call).
selections = 0


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
    (as in a stable sort). Returns (D,) f32."""
    return knn_median_depth_centers(uvd, uvd_valid, boxes.centers(), k)


def knn_select_nearest(d2: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k) int64 indices of each row's k smallest d2 (k <= P), in the
    order of ``torch.sort(d2, stable=True).indices[..., :k]``: ascending
    d2, equal d2 to the lower point index, NaN after +inf.

    Key: d2 is a sum of squares or +inf (never negative, never -0), so its
    f32 bits read as an int32 order like the float; NaN, of any sign or
    payload, becomes the one quiet NaN, above +inf's bits. ``(bits << s) |
    index`` is then unique to each point and orders the points as the
    stable sort does, so torch.topk has no tie to order.
    Chunks: the row is cut into chunks of about sqrt(P / k) consecutive
    points, so that there are about as many chunks as the k chosen chunks
    hold points. The k chunks with the smallest (least bits, chunk index)
    hold the k smallest keys: a point of any other chunk comes after the k
    distinct minima of those chunks (of two chunks with equal minima the
    earlier holds the earlier point). The row is read twice (the bits, the
    chunk minima); topk then runs on the chunk minima and on the k chosen
    chunks' keys alone."""
    global selections
    selections += 1
    p, lead, dev = d2.shape[-1], d2.shape[:-1], d2.device
    chunk = 1 << ((p // max(k, 1)).bit_length() // 2)
    g = -(-p // chunk)
    bits = torch.empty(lead + (g * chunk,), dtype=torch.int32, device=dev)
    # nan_to_num keeps +inf only when told to
    torch.nan_to_num(d2, nan=float("nan"), posinf=float("inf"),
                     out=bits.view(torch.float32)[..., :p])
    bits[..., p:] = 0x7FFFFFFF          # padding: after every point, NaN too
    least = bits.view(lead + (g, chunk)).amin(-1)
    s = (g - 1).bit_length()
    chunk_key = torch.add(torch.arange(g, device=dev), least, alpha=1 << s)
    chosen = torch.topk(chunk_key, min(k, g), dim=-1, largest=False,
                        sorted=False).values & ((1 << s) - 1)
    idx = (chosen[..., None] * chunk
           + torch.arange(chunk, device=dev)).flatten(-2)
    s = (g * chunk - 1).bit_length()
    key = torch.add(idx, torch.gather(bits, -1, idx), alpha=1 << s)
    return torch.topk(key, k, dim=-1, largest=False).values & ((1 << s) - 1)


def knn_median_depth_centers(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                             centers: torch.Tensor, k: int) -> torch.Tensor:
    """knn_median_depth on (..., D, 2) query centers: the dense (..., D, P)
    distance matrix, then each row's k nearest by knn_select_nearest (the
    stable sort's first k, without the sort)."""
    d2 = knn_sq_distances(uvd, uvd_valid, centers)
    k_eff = min(k, d2.shape[-1])
    order = knn_select_nearest(d2, k_eff)
    d2_sel = torch.gather(d2, -1, order)
    z_sel = torch.take_along_dim(uvd[..., 2], order.flatten(-2),
                                 dim=-1).view(order.shape)
    if k_eff < k:                      # fewer points than k: pad as unfound
        pad = torch.full(d2.shape[:-1] + (k - k_eff,), float("inf"),
                         device=d2.device)
        d2_sel = torch.cat([d2_sel, pad], dim=-1)
        z_sel = torch.cat([z_sel, pad], dim=-1)
    return median_of_selected(d2_sel, z_sel, k)


def assign_points_to_boxes(xyz_cam: torch.Tensor, point_valid: torch.Tensor,
                           K: torch.Tensor, boxes: Boxes, image_w: int,
                           image_h: int):
    """extractCloudPerBBox (cloud_detections.cpp:249-298): a point is
    eligible when valid, finite, z > 0.001 and projecting inside [0, w) x
    [0, h) (:262-277); it goes to the FIRST valid box whose pixel rectangle
    holds (u, v), edges inclusive (:280-288, ``break`` on a match).
    xyz_cam (..., P, 3), boxes (..., D). Returns (assignment (..., P) int32
    box index or -1, u, v)."""
    u, v, _ = project_points(xyz_cam, K)
    eligible = (point_valid & torch.isfinite(xyz_cam).all(dim=-1)
                & (xyz_cam[..., 2] > 0.001)
                & (u >= 0) & (u < image_w) & (v >= 0) & (v < image_h))
    xyxy = boxes.xyxy[..., None, :, :]                        # (..., 1, D, 4)
    uu, vv = u[..., None], v[..., None]                       # (..., P, 1)
    inside = ((uu >= xyxy[..., 0]) & (uu <= xyxy[..., 2])
              & (vv >= xyxy[..., 1]) & (vv <= xyxy[..., 3])
              & boxes.valid[..., None, :] & eligible[..., None])
    first = torch.argmax(inside.to(torch.uint8), dim=-1)      # first True
    assignment = torch.where(inside.any(dim=-1), first,
                             torch.full_like(first, -1))
    return assignment.to(torch.int32), u, v


def count_assigned(assignment: torch.Tensor, num_boxes: int) -> torch.Tensor:
    """(..., D) int32 number of points assigned to each box."""
    slot = torch.where(assignment >= 0, assignment,
                       torch.full_like(assignment, num_boxes)).long()
    counts = torch.zeros(assignment.shape[:-1] + (num_boxes + 1,),
                         dtype=torch.int32, device=assignment.device)
    counts.scatter_add_(-1, slot, torch.ones_like(slot, dtype=torch.int32))
    return counts[..., :num_boxes]


def gather_box_clouds(xyz_cam: torch.Tensor, assignment: torch.Tensor,
                      num_boxes: int, capacity: int):
    """Per-box sub-clouds at a fixed capacity: each box's first `capacity`
    assigned points in cloud order (the reference keeps them all, in
    encounter order; `truncated` says where the cap bound). A stable sort
    groups the points by box in cloud order; slot j of box d is the j-th
    point of its group.

    Returns (points (..., D, capacity, 3), valid (..., D, capacity),
    truncated (..., D))."""
    p = xyz_cam.shape[-2]
    slot = torch.where(assignment >= 0, assignment,
                       torch.full_like(assignment, num_boxes))
    order = torch.sort(slot, dim=-1, stable=True).indices     # (..., P)
    counts = count_assigned(assignment, num_boxes)            # (..., D)
    start = torch.cumsum(counts, dim=-1) - counts
    j = torch.arange(capacity, dtype=torch.int64, device=xyz_cam.device)
    valid = j < counts[..., None]                             # (..., D, cap)
    pos = torch.clamp(start[..., None].long() + j, max=p - 1)
    idx = torch.take_along_dim(order, pos.flatten(-2), dim=-1)
    pts = torch.take_along_dim(xyz_cam, idx[..., None], dim=-2).reshape(
        valid.shape + (3,))
    pts = torch.where(valid[..., None], pts, torch.zeros((), device=pts.device))
    return pts, valid, counts > capacity
