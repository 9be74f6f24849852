"""k-NN median depth: the ``knn_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_knn.py (knn_median_depth_pallas),
held to the tie rule of association.knn_median_depth: equal d2 resolves to
the lowest point index. On a CUDA tensor ``knn_median_depth_cuda``
launches the hand-written kernel of ``csrc/cuda_knn.cu`` (its note says
what bounds it and how); on a CPU tensor it runs
``knn_median_depth_plain``, the dense (D, P) distances with a stable sort.
Inputs may carry a leading rig axis, (R, P, 3) points with (R, D, 2)
centers: one launch serves every rig.
"""

from __future__ import annotations

import ctypes

import torch

from ..types import Boxes
from . import cuda_build
from .association import knn_median_depth_centers

MAX_K = 8               # the kernel is instantiated for k = 1..8

# Kernel launches made by knn_median_depth_cuda.
launches = 0

# The plain twin: dense (D, P) d2 and a stable sort (association.py).
knn_median_depth_plain = knn_median_depth_centers


def _launch(uvd: torch.Tensor, uvd_valid: torch.Tensor,
            centers: torch.Tensor, k: int) -> torch.Tensor:
    global launches
    dev = uvd.device
    if (uvd.dtype != torch.float32 or uvd.dim() not in (2, 3)
            or uvd.shape[-1] != 3):
        raise ValueError("uvd must be a (P, 3) or (R, P, 3) float32 tensor")
    lead = uvd.shape[:-2]
    if uvd_valid.dtype != torch.bool or uvd_valid.shape != uvd.shape[:-1]:
        raise ValueError("uvd_valid must be a (..., P) bool tensor")
    if (centers.dtype != torch.float32 or centers.dim() != uvd.dim()
            or centers.shape[:-2] != lead or centers.shape[-1] != 2):
        raise ValueError("centers must be a (..., D, 2) float32 tensor "
                         "with uvd's rig axis")
    if uvd_valid.device != dev or centers.device != dev:
        raise ValueError("uvd, uvd_valid and centers must share a device")
    if not (uvd.is_contiguous() and uvd_valid.is_contiguous()
            and centers.is_contiguous()):
        raise ValueError("uvd, uvd_valid and centers must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if uvd.shape[-2] >= 2 ** 31:
        raise ValueError("too many points")
    lib = cuda_build.load("cuda_knn")
    fn = lib.gv_knn_median_depth
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    d = centers.shape[-2]
    out = torch.empty(centers.shape[:-1], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(uvd.data_ptr(), uvd_valid.data_ptr(), centers.data_ptr(),
           lead[0] if lead else 1, uvd.shape[-2], d, k, out.data_ptr(),
           stream),
        "gv_knn_median_depth")
    launches += 1
    return out


def knn_median_depth_cuda(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                          boxes: Boxes, k: int) -> torch.Tensor:
    """Drop-in replacement for association.knn_median_depth: (..., D) f32
    upper-median depths, -1.0 where no point was found."""
    return knn_median_depth_centers_cuda(uvd, uvd_valid, boxes.centers(), k)


def knn_median_depth_centers_cuda(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                                  centers: torch.Tensor,
                                  k: int) -> torch.Tensor:
    """knn_median_depth_cuda on (D, 2) or (R, D, 2) query centers: the
    kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if uvd.device.type == "cpu":
        return knn_median_depth_plain(uvd, uvd_valid, centers, k)
    if uvd.device.type != "cuda":
        raise ValueError(f"unsupported device {uvd.device}")
    return _launch(uvd, uvd_valid, centers, k)
