"""Camera, rigid-body and grid-index geometry on tensors (counterpart of
grid_vision_tpu/geometry.py; reference object_detection.cpp:241-249,
cloud_detections.cpp:18-30/89-103, grid_vision_node.cpp:280-382,
occupancy_grid.cpp:150-152)."""

from __future__ import annotations

import torch


def intrinsic_matrix(fx, fy, cx, cy, device=None) -> torch.Tensor:
    """K = [[fx,0,cx],[0,fy,cy],[0,0,1]]."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def intrinsic_inverse(K: torch.Tensor) -> torch.Tensor:
    """Closed-form pinhole K^-1."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = torch.zeros((), dtype=K.dtype, device=K.device)
    o = torch.ones((), dtype=K.dtype, device=K.device)
    return torch.stack([
        torch.stack([1.0 / fx, z, -cx / fx]),
        torch.stack([z, 1.0 / fy, -cy / fy]),
        torch.stack([z, z, o]),
    ])


def projection_matrix_3x4(fx, fy, cx, cy, device=None) -> torch.Tensor:
    """The MultiBin solver's 3x4 projection [K | 0]
    (vision_orientation.cpp:19-20)."""
    K = intrinsic_matrix(fx, fy, cx, cy, device)
    return torch.cat([K, K.new_zeros((3, 1))], dim=1)


def project_points(xyz: torch.Tensor, K: torch.Tensor):
    """(..., 3) camera-frame points -> (u, v, z); only an exact-zero z is
    guarded, callers mask the rest. Each row of K @ p is summed as
    (x k0 + y k1) + z k2, each product rounded: the JAX package's jitted
    tick holds K as a constant and XLA sums it so (its zero terms drop out
    exactly), where a matmul would fuse multiply-adds. The frustum
    association's inclusive box edges see the difference."""
    x, y, zc = xyz.unbind(-1)

    def row(i):
        return (x * K[i, 0] + y * K[i, 1]) + zc * K[i, 2]

    img = torch.stack([row(0), row(1), row(2)], dim=-1)
    z = img[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    return img[..., 0] / safe_z, img[..., 1] / safe_z, xyz[..., 2]


def pixel_to_3d(uv: torch.Tensor, depth: torch.Tensor,
                K_inv: torch.Tensor) -> torch.Tensor:
    """X_cam = depth * K^-1 [u, v, 1]^T; uv (..., 2), depth (...,)."""
    homog = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return depth[..., None] * (homog @ K_inv.T)


def transform_points(T: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to (..., 3) points. A stack of
    transforms T (R, 4, 4), one a rig, applies T[r] to rig r's points
    (R, ..., 3), each rig as the one-transform call computes it: a batched
    matmul rounds some rows otherwise (its small-row path), so the result
    equals R single calls bit for bit."""
    if T.dim() == 3:
        return torch.stack([transform_points(t, x) for t, x in zip(T, xyz)])
    return xyz @ T[:3, :3].T + T[:3, 3]


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The 4x4 f32 rigid transform [[R, t], [0, 1]] on R's device."""
    R = torch.as_tensor(R, dtype=torch.float32)
    T = torch.eye(4, dtype=torch.float32, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = torch.as_tensor(t, dtype=torch.float32, device=R.device)
    return T


def quat_from_pitch(angle: torch.Tensor) -> torch.Tensor:
    """tf2::Quaternion::setRPY(0, -angle, 0) as (..., 4) xyzw."""
    half = -angle / 2.0
    zeros = torch.zeros_like(angle)
    return torch.stack([zeros, torch.sin(half), zeros, torch.cos(half)],
                       dim=-1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw layout, batched."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrices -> (..., 4) xyzw quaternions
    (branch-free Shepperd method, degrading within ~1e-3 of a 180 degree
    rotation)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=0.0)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=0.0)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=0.0)) / 2.0
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qx, qy, qz, qw], dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def transform_pose(T: torch.Tensor, position: torch.Tensor,
                   quat: torch.Tensor):
    """tf2::doTransform on a Pose: move the position, compose the
    orientation. T (4, 4), or (R, 4, 4) with a leading rig axis on position
    and quat (transform_points)."""
    q_T = quat_from_matrix(T[..., :3, :3])
    q_T = q_T.reshape(q_T.shape[:-1] + (1,) * (quat.dim() - q_T.dim())
                      + (4,))
    return (transform_points(T, position),
            quat_multiply(q_T.expand_as(quat), quat))


def rotation_y(theta: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) R_y = [[c,0,s],[0,1,0],[-s,0,c]]."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, z, s], dim=-1),
        torch.stack([z, o, z], dim=-1),
        torch.stack([-s, z, c], dim=-1),
    ], dim=-2)


# grid_map buffer convention: index (0, 0) is the cell at the (+x, +y) max
# corner and indices grow toward -x / -y, so getIndex(position) is
# floor((max_corner - position) / resolution), valid iff in [0, size).


def grid_index_from_position(pos_xy: torch.Tensor, center_xy, length_xy,
                             resolution: float):
    """(..., 2) base-frame positions -> ((..., 2) int32 index, valid)."""
    center = torch.tensor(center_xy, dtype=torch.float32,
                          device=pos_xy.device)
    length = torch.tensor(length_xy, dtype=torch.float32,
                          device=pos_xy.device)
    size = torch.round(length / resolution).to(torch.int32)
    max_corner = center + 0.5 * length
    idx = torch.floor((max_corner - pos_xy) / resolution).to(torch.int32)
    valid = torch.all((idx >= 0) & (idx < size), dim=-1)
    return idx, valid


def grid_position_from_index(idx: torch.Tensor, center_xy, length_xy,
                             resolution: float) -> torch.Tensor:
    """Cell-center position of (..., 2) int indices."""
    center = torch.tensor(center_xy, dtype=torch.float32, device=idx.device)
    length = torch.tensor(length_xy, dtype=torch.float32, device=idx.device)
    max_corner = center + 0.5 * length
    return max_corner - (idx.to(torch.float32) + 0.5) * resolution
