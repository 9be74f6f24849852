"""The orientation net's fused front end: the
``orientation_stem_backend="pallas"`` path of the fleet tick.

Counterpart of grid_vision_tpu/ops/pallas_orient.py (orient_front_pallas):
(R, H, W, 3) frames + the fleet-compacted (N, 4) boxes, their validity and
each box's rig index -> bilinear crop-resize to S x S -> per-crop
per-channel standardization (quirk Q10) -> ConvBN_0 of OrientationNetS2D
(the folded 12x12/s8 s2d stem, BN, relu) -> the (N, S/8, S/8, 4w) NHWC
activation the net takes with stem_external=True. On a CUDA tensor
``orient_front_cuda`` launches the hand-written kernels of
``csrc/cuda_orient.cu`` (its note says what bounds them and how); on a CPU
tensor it runs ``orient_front_plain``: per crop, crop_resize against its
rig's frame, _standardize, then the module's ConvBN_0.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..models.layers import fold_bn, same_pad
from ..types import Boxes
from . import cuda_build
from .preprocess import _standardize, box_axis_samples, crop_resize

S2D_BLOCK = 4           # the net's s2d_fold block (ConvBN_0, block=4)
# Kernel calls made by orient_front_cuda (one per call; a call is two
# launches of csrc/cuda_orient.cu).
launches = 0


def prepare_orient_constants(model) -> Dict[str, torch.Tensor]:
    """Fold ConvBN_0 of an OrientationNetS2D once (Engine init), on the
    net's device: wmat (432, F), the 12x12x3 folded kernel in row order
    (uy * 12 + ux) * 3 + c, and the BN scale s / shift t (F,)."""
    with torch.no_grad():
        conv = model.ConvBN_0
        big = conv.conv_weight().detach()                 # (F, 3, 12, 12)
        f, c, kh, kw = big.shape
        s, t = fold_bn(conv.BatchNorm_0)
        return dict(
            wmat=big.permute(2, 3, 1, 0).reshape(kh * kw * c, f)
            .contiguous(), s=s.contiguous(), t=t.contiguous())


def _pad_lo(size: int) -> int:
    """Low SAME pad in pixels of the folded stem: computed on the 4-pixel
    block grid (models/layers.conv2d_same with block=4), (0, 4) at 224."""
    return same_pad(size // S2D_BLOCK, 3, 2)[0] * S2D_BLOCK


def crops_by_rig(images: torch.Tensor, xyxy: torch.Tensor,
                 rig: torch.Tensor, size: int) -> torch.Tensor:
    """(N, S, S, 3) bilinear crops (crop_resize), each cut from its rig's
    frame of the (R, H, W, 3) images."""
    n = xyxy.shape[0]
    crops = torch.zeros((n, size, size, 3), dtype=torch.float32,
                        device=images.device)
    boxes = Boxes(xyxy=xyxy, confidence=torch.zeros_like(xyxy[:, 0]),
                  label=torch.zeros_like(rig, dtype=torch.int32),
                  valid=torch.ones_like(rig, dtype=torch.bool))
    for r in range(images.shape[0]):
        idx = torch.nonzero(rig == r)[:, 0]
        if idx.numel():
            crops[idx] = crop_resize(images[r], boxes.take(idx), size)
    return crops


def orient_front_plain(images: torch.Tensor, xyxy: torch.Tensor,
                       valid: torch.Tensor, rig: torch.Tensor, model,
                       size: int) -> torch.Tensor:
    """The kernel's plain twin: each crop cut from its rig's frame
    (crop_resize), standardized (_standardize), then the module's
    ConvBN_0; (N, S/8, S/8, F) NHWC."""
    std = _standardize(crops_by_rig(images, xyxy, rig, size), valid)
    return model.ConvBN_0(std.permute(0, 3, 1, 2)).permute(
        0, 2, 3, 1).contiguous()


def _launch(images: torch.Tensor, xyxy: torch.Tensor, valid: torch.Tensor,
            rig: torch.Tensor, consts, size: int) -> torch.Tensor:
    global launches
    dev = images.device
    if (images.dtype != torch.float32 or images.dim() != 4
            or images.shape[-1] != 3 or not images.is_contiguous()):
        raise ValueError("images must be a contiguous (R, H, W, 3) float32 "
                         "tensor")
    n = xyxy.shape[0]
    if (xyxy.dtype != torch.float32 or xyxy.shape != (n, 4)
            or valid.shape != (n,) or valid.dtype != torch.bool
            or rig.shape != (n,)):
        raise ValueError("boxes (N, 4) float32, valid (N,) bool and rig "
                         "(N,) are required")
    if any(t.device != dev for t in (xyxy, valid, rig)):
        raise ValueError("boxes, valid and rig must be on the frames' "
                         "device")
    if size % (2 * S2D_BLOCK):
        raise ValueError(f"size {size} must be a multiple of "
                         f"{2 * S2D_BLOCK}")
    wmat, s, t = consts["wmat"], consts["s"], consts["t"]
    f = wmat.shape[1]
    if (wmat.shape != (12 * 12 * 3, f) or f % 16 or s.shape != (f,)
            or t.shape != (f,)
            or any(a.device != dev or a.dtype != torch.float32
                   or not a.is_contiguous() for a in (wmat, s, t))):
        raise ValueError("orientation constants must be contiguous float32 "
                         "wmat (432, F), s, t (F,) with F % 16 == 0, on the "
                         "frames' device")
    _, h, w, _ = images.shape
    q = -(-(size // S2D_BLOCK) // 2)
    (ylo, yhi, yfr), (xlo, xhi, xfr) = box_axis_samples(xyxy, h, w, size)
    samples = [a.to(torch.int32).contiguous() for a in (ylo, yhi)] + [
        yfr.contiguous()] + [a.to(torch.int32).contiguous()
                             for a in (xlo, xhi)] + [xfr.contiguous()]
    rig32 = rig.to(torch.int32).contiguous()
    valid8 = valid.contiguous()
    crops = torch.empty((n, size, size, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 6), dtype=torch.float32, device=dev)
    out = torch.empty((n, q, q, f), dtype=torch.float32, device=dev)
    lib = cuda_build.load("cuda_orient")
    fn = lib.gv_orient_front
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, P] + [P] * 6 + [I, I, I, I, P, I, P, P, P, P,
                                              P, P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(images.data_ptr(), h, w, rig32.data_ptr(), valid8.data_ptr(),
           *(a.data_ptr() for a in samples), n, size, q, _pad_lo(size),
           wmat.data_ptr(), f, s.data_ptr(), t.data_ptr(), crops.data_ptr(),
           stats.data_ptr(), out.data_ptr(), stream),
        "gv_orient_front")
    launches += 1
    return out


def orient_front_cuda(images: torch.Tensor, xyxy: torch.Tensor,
                      valid: torch.Tensor, rig: torch.Tensor, model,
                      consts, size: int) -> torch.Tensor:
    """(R, H, W, 3) [0, 255] frames + (N, 4) boxes, (N,) validity and (N,)
    rig indices in [0, R) -> (N, S/8, S/8, F) post-ConvBN_0 activations:
    the kernels on a CUDA tensor (consts: prepare_orient_constants on its
    device), the plain twin on the net's modules for a CPU tensor."""
    if images.device.type == "cpu":
        return orient_front_plain(images, xyxy, valid, rig, model, size)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    return _launch(images, xyxy, valid, rig, consts, size)
