"""Fused detector front end: the ``detector_stem_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_stem.py (detector_stem_pallas):
(B, H, W, 3) frames in [0, 255] -> antialiased linear resize to S and /255
-> ConvBN_0 (3x3/s2, 3->32) -> ConvBN_1 (3x3/s2, 32->64) -> the
(B, S/4, S/4, 64) NHWC activation that YoloV4Tiny takes with
stem_external=True. On a CUDA tensor ``detector_stem_cuda`` launches the
hand-written kernels of ``csrc/cuda_stem.cu`` (its note says what bounds
them and how); on a CPU tensor it runs ``detector_stem_plain``: the resize
matmuls, then F.conv2d with the BN folded to a scale and shift.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.layers import fold_bn, same_pad
from . import cuda_build
from .preprocess import preprocess_detector_image, _axis_resize_weights

# Kernel launches made by detector_stem_cuda (one per call).
launches = 0


def prepare_stem_constants(detector) -> Dict[str, torch.Tensor]:
    """Fold the stem weights of a YoloV4Tiny once (Engine init), on the
    detector's device. Conv weights in the kernel's im2col order:
    w0[(ty*3 + tx)*3 + c, co], w1[(ty*3 + tx)*32 + c, co]; OIHW copies for
    the plain twin."""
    with torch.no_grad():
        c0, c1 = detector.ConvBN_0, detector.ConvBN_1
        w0 = c0.Conv_0.weight.detach()                 # (32, 3, 3, 3)
        w1 = c1.Conv_0.weight.detach()                 # (64, 32, 3, 3)
        s0, b0 = fold_bn(c0.BatchNorm_0)
        s1, b1 = fold_bn(c1.BatchNorm_0)
        return dict(
            w0=w0.permute(2, 3, 1, 0).reshape(27, 32).contiguous(),
            w1=w1.permute(2, 3, 1, 0).reshape(288, 64).contiguous(),
            w0_oihw=w0.contiguous(), w1_oihw=w1.contiguous(),
            s0=s0.contiguous(), b0=b0.contiguous(),
            s1=s1.contiguous(), b1=b1.contiguous())


@functools.lru_cache(maxsize=None)
def resize_taps(n_in: int, size: int, scale: float = 1.0):
    """Compact one axis' (size, n_in) resize matrix to its nonzero taps:
    (start (size,) int32, weights (size, T) f32), T the widest row's tap
    count. Each window lies inside [0, n_in); columns of the window outside
    a row's support carry weight 0."""
    w = _axis_resize_weights(n_in, size) * np.float32(scale)
    nz = w != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    taps = int(max(1, (last - first + 1).max()))
    start = np.minimum(first, n_in - taps).astype(np.int32)
    cols = start[:, None] + np.arange(taps)[None, :]
    weights = np.take_along_axis(w, cols, axis=1).astype(np.float32)
    return start, np.ascontiguousarray(weights)


def _conv_bn_leaky(x, w, s, b):
    """NCHW 3x3/s2 SAME conv + folded BN + leaky 0.1."""
    py = same_pad(x.shape[2], 3, 2)
    px = same_pad(x.shape[3], 3, 2)
    y = F.conv2d(F.pad(x, (px[0], px[1], py[0], py[1])), w, stride=2)
    return F.leaky_relu(y * s[None, :, None, None] + b[None, :, None, None],
                        0.1)


def detector_stem_plain(images: torch.Tensor, consts, size: int):
    """The kernel's plain twin: resize matmuls + F.conv2d."""
    x = torch.stack([preprocess_detector_image(im, size) for im in images])
    x = x.permute(0, 3, 1, 2)
    x = _conv_bn_leaky(x, consts["w0_oihw"], consts["s0"], consts["b0"])
    x = _conv_bn_leaky(x, consts["w1_oihw"], consts["s1"], consts["b1"])
    return x.permute(0, 2, 3, 1).contiguous()


_device_taps: Dict[tuple, tuple] = {}


def _taps_on(device, h: int, w: int, size: int):
    key = (str(device), h, w, size)
    if key not in _device_taps:
        ry0, ryw = resize_taps(h, size)
        rx0, rxw = resize_taps(w, size, 1.0 / 255.0)
        _device_taps[key] = tuple(
            torch.as_tensor(a, device=device) for a in (ry0, ryw, rx0, rxw))
    return _device_taps[key]


def _launch(images: torch.Tensor, consts, size: int) -> torch.Tensor:
    global launches
    dev = images.device
    if (images.dtype != torch.float32 or images.dim() != 4
            or images.shape[-1] != 3 or not images.is_contiguous()):
        raise ValueError("images must be a contiguous (B, H, W, 3) float32 "
                         "tensor")
    shapes = dict(w0=(27, 32), w1=(288, 64), s0=(32,), b0=(32,), s1=(64,),
                  b1=(64,))
    for name, shape in shapes.items():
        t = consts[name]
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"stem constant {name} must be a contiguous "
                             f"{shape} float32 tensor on {dev}")
    b, h, w, _ = images.shape
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    pad0 = same_pad(size, 3, 2)[0]
    pad1 = same_pad(s0, 3, 2)[0]
    ry0, ryw, rx0, rxw = _taps_on(dev, h, w, size)
    mid = torch.empty((b, s0, s0, 32), dtype=torch.float32, device=dev)
    out = torch.empty((b, s1, s1, 64), dtype=torch.float32, device=dev)
    lib = cuda_build.load("cuda_stem")
    fn = lib.gv_detector_stem
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I, P, P, I, P, P, I, I, P, P, P, I, I, P, P, P,
                   P, I, I, P, P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(images.data_ptr(), b, h, w, ry0.data_ptr(), ryw.data_ptr(),
           ryw.shape[1], rx0.data_ptr(), rxw.data_ptr(), rxw.shape[1], size,
           consts["w0"].data_ptr(), consts["s0"].data_ptr(),
           consts["b0"].data_ptr(), pad0, s0, mid.data_ptr(),
           consts["w1"].data_ptr(), consts["s1"].data_ptr(),
           consts["b1"].data_ptr(), pad1, s1, out.data_ptr(), stream),
        "gv_detector_stem")
    launches += 1
    return out


def detector_stem_cuda(images: torch.Tensor, consts,
                       size: int) -> torch.Tensor:
    """(B, H, W, 3) [0, 255] frames -> (B, S/4, S/4, 64) post-ConvBN_1
    activation: the kernels on a CUDA tensor, the plain twin on a CPU
    tensor. consts: prepare_stem_constants on the frames' device."""
    if images.device.type == "cpu":
        return detector_stem_plain(images, consts, size)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    return _launch(images, consts, size)
