"""The yardstick's arithmetic: the operations and bytes of the model and of
each hand-written kernel, from shapes alone, and the chip's peaks
(peaks.json). An operation is a multiply or an add (a multiply-add is 2).
Each input byte is read once and each output byte written once; only the
work the inputs need is counted (valid crops, not padded budget slots).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .reference import axis_resize_weights

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)

# the detector's convs: (name, c_in, c_out, kernel, stride) in forward
# order, each at the output size SAME padding gives
_DET_CONVS = (
    ("ConvBN_0", 3, 32, 3, 2), ("ConvBN_1", 32, 64, 3, 2),
    ("ConvBN_2", 64, 64, 3, 1), ("CSPBlock_0/ConvBN_0", 32, 32, 3, 1),
    ("CSPBlock_0/ConvBN_1", 32, 32, 3, 1),
    ("CSPBlock_0/ConvBN_2", 64, 64, 1, 1),
    ("ConvBN_3", 128, 128, 3, 1), ("CSPBlock_1/ConvBN_0", 64, 64, 3, 1),
    ("CSPBlock_1/ConvBN_1", 64, 64, 3, 1),
    ("CSPBlock_1/ConvBN_2", 128, 128, 1, 1),
    ("ConvBN_4", 256, 256, 3, 1), ("CSPBlock_2/ConvBN_0", 128, 128, 3, 1),
    ("CSPBlock_2/ConvBN_1", 128, 128, 3, 1),
    ("CSPBlock_2/ConvBN_2", 256, 256, 1, 1),
    ("ConvBN_5", 512, 512, 3, 1), ("ConvBN_6", 512, 256, 1, 1),
    ("ConvBN_7", 256, 512, 3, 1), ("ConvBN_8", 256, 128, 1, 1),
    ("ConvBN_9", 384, 256, 3, 1))
# the spatial size each conv reads, as a divisor of the input size
_DET_IN_DIV = (1, 2, 4, 4, 4, 4, 8, 8, 8, 8, 16, 16, 16, 16, 32, 32, 32, 32,
               16)


def conv_ops(n_in: int, c_in: int, c_out: int, k: int, s: int) -> int:
    """2 * output positions * c_out * k * k * c_in of a square SAME conv."""
    n_out = -(-n_in // s)
    return 2 * n_out * n_out * c_out * k * k * c_in


def detector_conv_ops(size: int) -> int:
    """The 19 ConvBN convs of YOLOv4-tiny on one frame at `size`."""
    return sum(conv_ops(-(-size // d), ci, co, k, s)
               for (_, ci, co, k, s), d in zip(_DET_CONVS, _DET_IN_DIV))


def detector_ops(size: int, classes: int = 10) -> int:
    """The detector's model operations a frame: the 19 convs and the two
    1x1 heads (3 anchors x (5 + classes) outputs)."""
    n_out = 3 * (5 + classes)
    return detector_conv_ops(size) + conv_ops(size // 32, 512, n_out, 1, 1) \
        + conv_ops(size // 16, 256, n_out, 1, 1)


def int8_conv_work(frames: int, size: int):
    """The int8 detector's 19 convs (csrc/cuda_int8.cu, the requant in its
    epilogue) on `frames` frames at `size`: (bytes, ops). Each conv's int8
    input activation read and its f32 output written, the int8 weights
    (K unpadded), the per-channel weight scales and biases (f32) and the
    per-sample activation scales (f32); the convs' multiply-adds."""
    n_bytes = 0
    for (_, ci, co, k, s), d in zip(_DET_CONVS, _DET_IN_DIV):
        n_in = -(-size // d)
        n_out = -(-n_in // s)
        n_bytes += frames * (n_in * n_in * ci + n_out * n_out * co * 4 + 4)
        n_bytes += co * k * k * ci + co * 8
    return n_bytes, frames * detector_conv_ops(size)


def orientation_ops(size: int, width: int) -> int:
    """The orientation net's operations a crop: the s2d(4) stem (3x3/s2 on
    48 channels), the stride-2 ladder down to 7, one stride-1 conv, and
    the three MultiBin heads' dense layers."""
    n = size // 4
    ops = conv_ops(n, 48, 4 * width, 3, 2)
    n, c = -(-n // 2), 4 * width
    while n > 7:
        ops += conv_ops(n, c, 8 * width, 3, 2)
        n, c = -(-n // 2), 8 * width
    ops += conv_ops(n, c, 8 * width, 3, 1)
    c = 8 * width
    return ops + 2 * (c * 256 + 256 * 4 + c * 256 + 256 * 2 + c * 512
                      + 512 * 3)


def _taps(n_in: int, size: int) -> int:
    """The widest row's nonzero taps of one axis' resize."""
    nz = axis_resize_weights(n_in, size) != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n_in - 1 - nz[:, ::-1].argmax(1), 0)
    return int(max(1, (last - first + 1).max()))


def stem_work(frames: int, h: int, w: int, size: int, elem: int):
    """The fused stem (resize + ConvBN_0 + ConvBN_1): (bytes, ops). The
    frames read and the (size/4)^2 x 64 activation written in the
    kernel's element size, the folded weights; the resize's two products
    over their taps and the two convs."""
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    ops = frames * (2 * h * size * 3 * _taps(w, size)
                    + 2 * size * size * 3 * _taps(h, size)
                    + 2 * s0 * s0 * 32 * 27 + 2 * s1 * s1 * 64 * 288)
    n_bytes = frames * (h * w * 3 + s1 * s1 * 64) * elem + 192 * 4 + \
        (32 * 32 + 288 * 64) * elem
    return n_bytes, ops


def csp_work(frames: int, size: int, elem: int):
    """The CSP stage (ConvBN_2 + CSPBlock_0 + the max pool) on the stem's
    (size/4)^2 x 64 activation: (bytes, ops) of the useful products."""
    s0 = -(-size // 2)
    n = -(-s0 // 2)
    ops = frames * 2 * n * n * (64 * 576 + 2 * 32 * 288 + 64 * 64)
    n_bytes = frames * (n * n * 64 + (n // 2) ** 2 * 128) * elem + \
        (576 * 64 + 2 * 288 * 32 + 64 * 64) * elem + 2 * 2 * 192 * 4
    return n_bytes, ops


def orient_work(crops: int, tapped_bytes: int, size: int, width: int,
                elem: int):
    """The orientation front (crop, standardize, the folded stem conv) on
    `crops` valid crops: (bytes, ops). The frame pixels the crops' taps
    read (tapped_bytes, each pixel once), the stem activation written,
    the weights; the conv and the crop's arithmetic."""
    q = -(-(size // 4) // 2)
    f = 4 * width
    ops = crops * (2 * q * q * f * 12 * 12 * 3 + size * size * 3 * 10)
    n_bytes = tapped_bytes + (crops * q * q * f + 432 * f) * elem + \
        crops * 16 + 2 * f * 4
    return n_bytes, ops


def tapped_pixels(xyxy: np.ndarray, rig: np.ndarray, h: int, w: int,
                  size: int) -> int:
    """The frame pixels that the bilinear taps of nonzero weight of the
    crops (xyxy (N, 4) pixels, rig (N,)) read, each pixel once however
    many crops tap it."""
    seen = {}
    t = np.trunc(xyxy).astype(np.int64)
    for (bx0, by0, bx1, by1), r in zip(t, rig):
        x0, y0 = max(bx0, 0), max(by0, 0)
        x1, y1 = min(bx1, w - 1), min(by1, h - 1)
        rows = _taps_hit(float(y0), float(max(y1 - y0, 1)), h, size)
        cols = _taps_hit(float(x0), float(max(x1 - x0, 1)), w, size)
        m = seen.setdefault(int(r), np.zeros((h, w), bool))
        m[np.ix_(rows, cols)] = True
    return int(sum(m.sum() for m in seen.values()))


def _taps_hit(start: float, ext: float, length: int, size: int):
    i = np.arange(size, dtype=np.float32)
    step = np.float32(ext) / np.float32(size)
    pos = np.float32(start) + (i + np.float32(0.5)) * step - np.float32(0.5)
    pos = np.minimum(np.maximum(pos, np.float32(start)),
                     np.float32(start + ext - 1.0))
    lo = np.floor(pos)
    frac = pos - lo
    lo_i = np.clip(lo.astype(np.int64), 0, length - 1)
    hi_i = np.clip(lo_i + 1, 0, length - 1)
    return np.unique(np.concatenate([lo_i, hi_i[frac > 0]]))


def bound_s(n_bytes: float, ops: float, peak_ops: float):
    """The least time the chip could take: (seconds, "bytes" or
    "operations", whichever bounds it)."""
    t_b = n_bytes / PEAKS["hbm_bytes_per_s"]
    t_o = ops / peak_ops
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
