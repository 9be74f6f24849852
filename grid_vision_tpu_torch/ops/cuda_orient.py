"""The orientation net's fused front end: the
``orientation_stem_backend="pallas"`` path of the fleet tick.

Counterpart of grid_vision_tpu/ops/pallas_orient.py (orient_front_pallas):
(R, H, W, 3) frames + the fleet-compacted (N, 4) boxes, their validity and
each box's rig index -> bilinear crop-resize to S x S -> per-crop
per-channel standardization (quirk Q10) -> ConvBN_0 of OrientationNetS2D
(the folded 12x12/s8 s2d stem, BN, relu) -> the (N, S/8, S/8, 4w) NHWC
activation the net takes with stem_external=True. On a CUDA tensor
``orient_front_cuda`` launches the hand-written kernels of
``csrc/cuda_orient.cu`` (its note says what bounds them and how: the crop
kernel computes its own sample positions from the boxes, the conv runs on
the tensor cores in 3xTF32 from weights split and packed here once per
model); on a CPU tensor it runs ``orient_front_plain``: per crop,
crop_resize against its rig's frame, _standardize, then the module's
ConvBN_0.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..models.layers import same_pad
from ..types import Boxes
from . import cuda_build, tf32x3
from .preprocess import _standardize, crop_resize

S2D_BLOCK = 4           # the net's s2d_fold block (ConvBN_0, block=4)
RUN = 40                # one kernel row on a crop row: 12 px x 3 ch, padded
MAX_F = 128             # the channels a conv block of the kernel holds
# Kernel calls made by orient_front_cuda (one per call; a call is two
# launches of csrc/cuda_orient.cu).
launches = 0


def prepare_orient_constants(model) -> Dict[str, torch.Tensor]:
    """Fold ConvBN_0 of an OrientationNetS2D once (Engine init), on the
    net's device: wfrag (60, F / 8, 32, 4), the 12x12x3 folded kernel as a
    (12 * 40, F) matrix (row uy * 40 + ux * 3 + c; each run of 36 padded to
    40 with zero rows, a multiple of the mma's k = 8), BN scale folded in,
    split into TF32 hi and lo and packed in mma fragment order
    (tf32x3.pack_b_fragments); and the BN shift t (F,)."""
    with torch.no_grad():
        wmat, t = tf32x3.folded_matrix(model.ConvBN_0)       # (432, F)
        f = wmat.shape[1]
        rows = wmat.reshape(12, 36, f)
        padded = torch.cat([rows, rows.new_zeros((12, RUN - 36, f))], dim=1)
        return dict(wfrag=tf32x3.pack_b_fragments(padded.reshape(12 * RUN,
                                                                 f)),
                    t=t.contiguous())


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
            or rig.shape != (n,)
            or rig.dtype not in (torch.int32, torch.int64)):
        raise ValueError("boxes (N, 4) float32, valid (N,) bool and rig "
                         "(N,) int32 or int64 are required")
    if any(t.device != dev or not t.is_contiguous()
           for t in (xyxy, valid, rig)):
        raise ValueError("boxes, valid and rig must be contiguous, on the "
                         "frames' device")
    if size % (2 * S2D_BLOCK):
        raise ValueError(f"size {size} must be a multiple of "
                         f"{2 * S2D_BLOCK}")
    wfrag, t = consts["wfrag"], consts["t"]
    f = t.shape[0]
    if (f % 16 or f > MAX_F or wfrag.shape != (12 * RUN // 8, f // 8, 32, 4)
            or any(a.device != dev or a.dtype != torch.float32
                   or not a.is_contiguous() for a in (wfrag, t))):
        raise ValueError("orientation constants must be contiguous float32 "
                         f"wfrag ({12 * RUN // 8}, F / 8, 32, 4) and t (F,) "
                         f"with F % 16 == 0 and F <= {MAX_F}, on the frames' "
                         "device")
    _, h, w, _ = images.shape
    q = -(-(size // S2D_BLOCK) // 2)
    crops = torch.empty((n, size, size, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((n, 6), dtype=torch.float32, device=dev)
    out = torch.empty((n, q, q, f), dtype=torch.float32, device=dev)
    lib = cuda_build.load("cuda_orient")
    fn = lib.gv_orient_front
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, P, I, P, P, I, I, I, I, P, I, P, P, P, P, P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(images.data_ptr(), h, w, rig.data_ptr(),
           int(rig.dtype == torch.int64), valid.data_ptr(), xyxy.data_ptr(),
           n, size, q, _pad_lo(size), wfrag.data_ptr(), f, t.data_ptr(),
           crops.data_ptr(), stats.data_ptr(), out.data_ptr(), stream),
        "gv_orient_front")
    launches += 1
    return out


def box_axis_samples_cuda(xyxy: torch.Tensor, h: int, w: int, size: int):
    """The crop kernel's own sample tables ((ylo, yhi, fy), (xlo, xhi,
    fx)), each (N, size), for (N, 4) boxes on the card: what it computes
    in place of preprocess.box_axis_samples (a check, not a path)."""
    if (xyxy.device.type != "cuda" or xyxy.dtype != torch.float32
            or xyxy.dim() != 2 or xyxy.shape[1] != 4
            or not xyxy.is_contiguous()):
        raise ValueError("boxes must be a contiguous (N, 4) float32 CUDA "
                         "tensor")
    n = xyxy.shape[0]
    ints = [torch.empty((n, size), dtype=torch.int32, device=xyxy.device)
            for _ in range(4)]
    fracs = [torch.empty((n, size), dtype=torch.float32, device=xyxy.device)
             for _ in range(2)]
    fn = cuda_build.load("cuda_orient").gv_orient_samples
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, I] + [P] * 7
    (ylo, yhi, xlo, xhi), (yfr, xfr) = ints, fracs
    cuda_build.check(
        fn(xyxy.data_ptr(), n, h, w, size, ylo.data_ptr(), yhi.data_ptr(),
           yfr.data_ptr(), xlo.data_ptr(), xhi.data_ptr(), xfr.data_ptr(),
           torch.cuda.current_stream(xyxy.device).cuda_stream),
        "gv_orient_samples")
    return (ylo, yhi, yfr), (xlo, xhi, xfr)


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
