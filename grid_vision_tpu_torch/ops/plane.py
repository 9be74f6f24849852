"""Ground-plane segmentation by fixed-iteration parallel RANSAC on tensors
(counterpart of grid_vision_tpu/ops/plane.py; reference segmentGroundPlane,
cloud_detections.cpp:105-138: pcl::SACSegmentation, SACMODEL_PLANE,
distance threshold 0.04, optimize-coefficients on, plane inliers removed).

Every hypothesis is scored at once: `iters` triplets drawn with the JAX
package's uniform bits (utils/prng.uniform, so both packages pick the same
triplets), one (P, iters) distance matrix, the first best inlier count, a
least-squares refine on its inliers (normal = the eigenvector of the
smallest eigenvalue of the weighted covariance), inliers re-selected
against the refined plane. Every function takes a leading rig axis: (R, P,
3) points, (R, P) valid flags, (R, 2) keys.

Rounding follows the JAX package's XLA build on the CPU, which contracts
the cross product and the 3-term sums into fused multiply-adds: those are
computed in f64 from f32 operands and rounded once to f32 (the product of
two f32 is exact in f64). The distance matrices are matmuls, which the CPU
BLAS sums in the same fused order. The 3x3 eigenproblem is solved in closed
form (trigonometric eigenvalues, cross products of the shifted rows) in
f64: no solver call, no host sync on the card. The normal's sign reaches no
output (distances are absolute).
"""

from __future__ import annotations

import math

import torch

from ..utils import prng


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round f64 to f32 and back: one f32 rounding inside an f64 chain."""
    return x.float().double()


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over 3 terms as fma(a2, b2, fma(a1, b1, a0 * b0)),
    f32 operands, f32 result."""
    a, b = a.double(), b.double()
    acc = _f32(a[..., 0] * b[..., 0])
    acc = _f32(acc + a[..., 1] * b[..., 1])
    return (acc + a[..., 2] * b[..., 2]).float()


def _plane_from_triplet(p0, p1, p2):
    """Plane (unit normal n, offset d) through 3 points, n.p + d = 0, and
    whether the triplet spans one (not collinear)."""
    e1 = (p1 - p0).double()
    e2 = (p2 - p0).double()

    def fms(i, j):             # fma(e1[i], e2[j], -(e1[j] * e2[i]))
        return (e1[..., i] * e2[..., j]
                - _f32(e1[..., j] * e2[..., i])).float()

    n = torch.stack([fms(1, 2), fms(2, 0), fms(0, 1)], dim=-1)
    norm = torch.sqrt(_fma_dot3(n, n))[..., None]
    ok = norm[..., 0] > 1e-8
    n = n / torch.where(norm == 0, torch.ones_like(norm), norm)
    return n, -_fma_dot3(n, p0), ok


def smallest_eigenvector(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 3) unit eigenvector of its smallest
    eigenvalue, in f64. Eigenvalues from the trigonometric solution of the
    characteristic cubic; the vector is the largest cross product of two
    rows of (A - lambda I). A matrix with a repeated smallest eigenvalue
    (all-zero weights, collinear inliers) gets some unit vector of that
    eigenspace, or e_z where none stands out; the caller's `ok` covers the
    cases that matter."""
    a = cov.double()
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1) / 6.0)
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    det = (b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02)
           + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    cands = torch.stack([torch.linalg.cross(m[..., 0, :], m[..., 1, :]),
                         torch.linalg.cross(m[..., 0, :], m[..., 2, :]),
                         torch.linalg.cross(m[..., 1, :], m[..., 2, :])],
                        dim=-2)                           # (..., 3, 3)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1, keepdim=True)
    v = torch.take_along_dim(cands, best[..., None], dim=-2)[..., 0, :]
    nv = torch.take_along_dim(norms, best, dim=-1)
    # a repeated smallest eigenvalue leaves (A - lambda I) of rank <= 1:
    # any vector normal to its largest row spans that eigenspace
    row_norms = torch.linalg.vector_norm(m, dim=-1)
    big = torch.take_along_dim(
        m, torch.argmax(row_norms, dim=-1, keepdim=True)[..., None],
        dim=-2)[..., 0, :]
    axis = torch.zeros_like(big).scatter_(
        -1, torch.argmin(big.abs(), dim=-1, keepdim=True), 1.0)
    alt = torch.linalg.cross(big, axis)
    nbig = row_norms.amax(dim=-1, keepdim=True)
    rank1 = nv <= 1e-10 * nbig * nbig
    v = torch.where(rank1, alt, v)
    nv = torch.where(rank1, torch.linalg.vector_norm(alt, dim=-1,
                                                      keepdim=True), nv)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(nv > 0, v / torch.where(nv > 0, nv,
                                               torch.ones_like(nv)),
                       fallback)


def _refine_plane(xyz: torch.Tensor, weights: torch.Tensor):
    """Least-squares plane over weighted points (PCL's
    optimizeModelCoefficients): xyz (..., P, 3), weights (..., P) ->
    (n (..., 3), d (...,))."""
    wsum = torch.clamp(weights.sum(dim=-1), min=1e-9)[..., None]
    mean = (xyz * weights[..., None]).sum(dim=-2) / wsum      # (..., 3)
    diff = xyz - mean[..., None, :]
    centered = diff * weights[..., None]
    cov = centered.transpose(-1, -2) @ diff / wsum[..., None]
    n = smallest_eigenvector(cov).float()
    return n, -_fma_dot3(n, mean)


def segment_ground_plane(xyz: torch.Tensor, valid: torch.Tensor,
                         rng: torch.Tensor, iters: int,
                         distance_threshold: float):
    """(non_ground (R, P), plane (R, 4), ok (R,)).

    non_ground: valid points off the best plane (the reference's
    setNegative(true) extraction). A rig whose plane cannot be fit (fewer
    than 3 valid points, every hypothesis degenerate) gets ok=False and an
    all-False mask: the reference's empty cloud on failure (:122-126).
    Points are packed valid-first, so triplets are drawn from the valid
    prefix."""
    p = xyz.shape[-2]
    count = valid.sum(dim=-1).to(torch.int32)                 # (R,)
    u = prng.uniform(rng, (iters, 3))                         # (R, I, 3)
    scale = torch.clamp(count, min=1).to(torch.float32)
    idx = torch.floor(u * scale[..., None, None]).to(torch.int64)
    idx = torch.clamp(idx, 0, p - 1)
    tri = torch.take_along_dim(xyz, idx.flatten(-2)[..., None],
                               dim=-2).reshape(idx.shape + (3,))
    n, d, hyp_ok = _plane_from_triplet(tri[..., 0, :], tri[..., 1, :],
                                       tri[..., 2, :])        # (R, I, ...)

    dist = torch.abs(xyz @ n.transpose(-1, -2) + d[..., None, :])
    inlier = (dist < distance_threshold) & valid[..., None]   # (R, P, I)
    scores = inlier.sum(dim=-2)
    scores = torch.where(hyp_ok, scores, torch.full_like(scores, -1))
    best = torch.argmax(scores, dim=-1, keepdim=True)         # first max
    best_inlier = torch.take_along_dim(inlier, best[..., None, :],
                                       dim=-1)[..., 0]
    n_ref, d_ref = _refine_plane(xyz, best_inlier.to(torch.float32))
    dist_ref = torch.abs((xyz @ n_ref[..., None])[..., 0] + d_ref[..., None])
    final_inlier = (dist_ref < distance_threshold) & valid

    best_score = torch.take_along_dim(scores, best, dim=-1)[..., 0]
    ok = (count >= 3) & (best_score > 0)
    non_ground = valid & ~final_inlier & ok[..., None]
    return non_ground, torch.cat([n_ref, d_ref[..., None]], dim=-1), ok
