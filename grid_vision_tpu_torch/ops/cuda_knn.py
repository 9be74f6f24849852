"""k-NN median depth: the ``knn_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_knn.py (knn_median_depth_pallas),
held to the tie rule of association.knn_median_depth: equal d2 resolves to
the lowest point index. On a CUDA tensor ``knn_median_depth_cuda``
launches the hand-written kernel of ``csrc/cuda_knn.cu`` (its note says
what bounds it and how: a block scans one slice of a rig's points for a
group of centers, the last block of a group to finish merges the slices);
on a CPU tensor
it runs ``knn_median_depth_plain``, the dense (D, P) distances with a
stable sort. Inputs may carry a leading rig axis, (R, P, 3) points with
(R, D, 2) centers: one call serves every rig. ``knn_split`` is the fixed
rule by which the wrapper cuts the points into slices, and
``knn_partition_model`` the same partition in plain torch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..types import Boxes
from . import cuda_build
from .association import (knn_median_depth_centers, knn_sq_distances,
                          median_of_selected)

MAX_K = 8               # the kernel is instantiated for k = 1..8

# Kernel launches made by knn_median_depth_cuda (one per call).
launches = 0

# The split rule's constants (csrc/cuda_knn.cu: 128 threads a block, at most
# 4 blocks an SM; an H100 has 132 SMs).
WAVE_BLOCKS = 132 * 4   # the blocks the card holds at once
MIN_SLICE = 512         # points a slice holds at least: 4 a thread

# The plain twin: dense (D, P) d2 and a stable sort (association.py).
knn_median_depth_plain = knn_median_depth_centers


def center_group(k: int) -> int:
    """Centers a scan block serves: 8 sorted top-k lists a thread in
    registers, 4 when k > 4."""
    return 8 if k <= 4 else 4


@functools.lru_cache(maxsize=None)
def knn_split(n_rigs: int, p: int, d: int, k: int):
    """(n_slices, slice_len): how the scan cuts a rig's P points. One block
    serves one (rig, center group, slice). Where the rigs and groups alone
    fill the card (more than WAVE_BLOCKS / 2 of them) a block scans all of
    its rig's points; else the points are cut into as many slices as keep
    the launch within one wave of WAVE_BLOCKS blocks, each slice at least
    MIN_SLICE points and a multiple of 16 (the kernel's 16-byte copies)."""
    groups = -(-max(d, 1) // center_group(k))
    n = max(1, WAVE_BLOCKS // (max(n_rigs, 1) * groups))
    n = max(1, min(n, p // MIN_SLICE))
    slice_len = max(16, -(-(-(-p // n)) // 16) * 16)
    return max(1, -(-p // slice_len)), slice_len


def knn_partition_model(uvd: torch.Tensor, uvd_valid: torch.Tensor,
                        centers: torch.Tensor, k: int, n_slices: int,
                        group: int = 8) -> torch.Tensor:
    """The kernel's partition in plain torch, for the tests: the centers in
    groups of `group`, the points in n_slices slices; per slice the k
    smallest (d2, index) keys of each center (the scan), then the k
    smallest of those and the upper median of their depths (the merge).
    Equal to knn_median_depth_plain whatever the partition: the k smallest
    keys of a set do not depend on how the set is cut."""
    p = uvd.shape[-2]
    slice_len = max(1, -(-p // n_slices))
    inf = torch.full((), float("inf"), device=uvd.device)
    out = []
    for c0 in range(0, centers.shape[-2], group):
        cs = centers[..., c0:c0 + group, :]
        d2_cand, z_cand = [], []
        for lo in range(0, n_slices * slice_len, slice_len):
            pts, ok = uvd[..., lo:lo + slice_len, :], \
                uvd_valid[..., lo:lo + slice_len]
            d2 = knn_sq_distances(pts, ok, cs)
            z = pts[..., None, :, 2].expand(d2.shape)
            pad = d2.shape[:-1] + (max(0, k - d2.shape[-1]),)
            d2 = torch.cat([d2, inf.expand(pad)], -1)       # kEmpty slots
            z = torch.cat([z, inf.expand(pad)], -1)
            order = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
            d2_cand.append(torch.gather(d2, -1, order))
            z_cand.append(torch.gather(z, -1, order))
        # slices follow each other in index order and each is sorted with
        # ties by index, so a stable sort by d2 orders by (d2, index)
        d2_all, z_all = torch.cat(d2_cand, -1), torch.cat(z_cand, -1)
        order = torch.sort(d2_all, dim=-1, stable=True).indices[..., :k]
        out.append(median_of_selected(torch.gather(d2_all, -1, order),
                                      torch.gather(z_all, -1, order), k))
    return torch.cat(out, -1)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_knn").gv_knn_median_depth
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 4
    return fn


# Per (device, stream): the slices' candidate keys and the counters of the
# blocks that have arrived (csrc/cuda_knn.cu). The kernel leaves the
# counters at 0, and calls on one stream follow each other, so both are
# kept from call to call and grown when a call needs more.
_scratch: dict = {}


def _scratch_for(dev, stream: int, n_keys: int, n_counters: int):
    key = (dev.index, stream)
    held = _scratch.get(key)
    if (held is None or held[0].numel() < n_keys
            or held[1].numel() < n_counters):
        held = (torch.empty(n_keys, dtype=torch.int64, device=dev),
                torch.zeros(n_counters, dtype=torch.int32, device=dev))
        _scratch[key] = held
    return held


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
    n_rigs, p, d = lead[0] if lead else 1, uvd.shape[-2], centers.shape[-2]
    n_slices, slice_len = knn_split(n_rigs, p, d, k)
    out = torch.empty(centers.shape[:-1], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cand = arrived = 0                          # one slice: nothing to merge
    if n_slices > 1:
        keys, counters = _scratch_for(
            dev, stream, n_rigs * d * n_slices * k,
            n_rigs * -(-d // center_group(k)))
        cand, arrived = keys.data_ptr(), counters.data_ptr()
    cuda_build.check(
        _entry()(uvd.data_ptr(), uvd_valid.data_ptr(), centers.data_ptr(),
                 n_rigs, p, d, k, n_slices, slice_len, cand, arrived,
                 out.data_ptr(), stream),
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
