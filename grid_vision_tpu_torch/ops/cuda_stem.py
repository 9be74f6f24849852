"""Fused detector front end: the ``detector_stem_backend="pallas"`` path.

Counterpart of grid_vision_tpu/ops/pallas_stem.py (detector_stem_pallas):
(B, H, W, 3) frames in [0, 255] -> antialiased linear resize to S and /255
-> ConvBN_0 (3x3/s2, 3->32) -> ConvBN_1 (3x3/s2, 32->64) -> the
(B, S/4, S/4, 64) NHWC activation that YoloV4Tiny takes with
stem_external=True. On a CUDA tensor ``detector_stem_cuda`` launches the
hand-written kernels of ``csrc/cuda_stem.cu`` (its note says what bounds
them and how: the resize and ConvBN_0 from staged frame tiles, ConvBN_1 on
the tensor cores in 3xTF32 from weights split and packed here once per
model), or for the bf16 form the one launch of ``csrc/cuda_stem_bf16.cu``
(both convs on the tensor cores, ConvBN_1 on wgmma, the conv0 activation
kept on the SM); on a CPU tensor it runs ``detector_stem_plain``: the
resize matmuls, then F.conv2d with the BN folded to a scale and shift.

The bf16 form (constants from ``prepare_stem_constants(detector,
torch.bfloat16)``, bf16 frames, a bf16 activation out) rounds where the
Pallas kernel rounds at compute_dtype=bf16: the frame, the resize weights
(1/255 folded into the x weights) and each resize product's result are
bf16, the conv weights bf16 without the BN scale, the sums f32, BN (x * s +
b) and leaky in f32 rounded once to bf16, for ConvBN_0 (whose output is
bf16) and ConvBN_1. Its twin ``detector_stem_plain`` computes the same from
f32 einsums and F.conv2d on the bf16-rounded operands.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import ieee_convs
from ..models.layers import fold_bn, same_pad
from . import bf16mma, cuda_build, tf32x3
from .preprocess import (_axis_resize_weights, einsum_in,
                         preprocess_detector_image)

# Kernel launches made by detector_stem_cuda (one per call), of the f32
# form and of the bf16 form.
launches = 0
launches_bf16 = 0


def prepare_stem_constants(detector, dtype=torch.float32
                           ) -> Dict[str, torch.Tensor]:
    """Fold the stem weights of a YoloV4Tiny once (Engine init), on the
    detector's device, for the kernels' f32 form or (dtype=torch.bfloat16)
    their bf16 form (_bf16_constants). f32, for the kernels:
    w0[(ty*3 + tx)*3 + c, co] with its
    BN scale s0 and shift b0; w1frag, the (288, 64) matrix
    w1[(ty*3 + tx)*32 + c, co] with the BN scale folded in, split into TF32
    hi and lo and packed in mma fragment order (tf32x3.pack_b_fragments:
    (36, 8, 32, 4)), and its BN shift b1. For the plain twin: OIHW copies
    and s1."""
    if dtype == torch.bfloat16:
        return _bf16_constants(detector)
    with torch.no_grad():
        c0, c1 = detector.ConvBN_0, detector.ConvBN_1
        w0 = c0.Conv_0.weight.detach()                 # (32, 3, 3, 3)
        w1 = c1.Conv_0.weight.detach()                 # (64, 32, 3, 3)
        s0, b0 = fold_bn(c0.BatchNorm_0)
        s1, b1 = fold_bn(c1.BatchNorm_0)
        w1mat = w1.permute(2, 3, 1, 0).reshape(288, 64) * s1
        return dict(
            w0=w0.permute(2, 3, 1, 0).reshape(27, 32).contiguous(),
            w1frag=tf32x3.pack_b_fragments(w1mat),
            w0_oihw=w0.contiguous(), w1_oihw=w1.contiguous(),
            s0=s0.contiguous(), b0=b0.contiguous(),
            s1=s1.contiguous(), b1=b1.contiguous())


def _bf16_constants(detector) -> Dict[str, torch.Tensor]:
    """The bf16 form's constants: w0frag, ConvBN_0's (27, 32) matrix in
    (ty, tx, c) row order padded with zero rows to (32, 32), packed by
    bf16mma.pack_b_fragments (2, 4, 32, 4); w1wg, ConvBN_1's (288, 64)
    matrix packed by bf16mma.pack_wgmma_b (18, 8, 2, 8, 8); both without
    the BN scale, whose s0, b0, s1, b1 stay f32; bf16 OIHW copies for the
    twin; dtype."""
    with torch.no_grad():
        c0, c1 = detector.ConvBN_0, detector.ConvBN_1
        w0 = c0.Conv_0.weight.detach()
        w1 = c1.Conv_0.weight.detach()
        s0, b0 = fold_bn(c0.BatchNorm_0)
        s1, b1 = fold_bn(c1.BatchNorm_0)
        w0mat = F.pad(w0.permute(2, 3, 1, 0).reshape(27, 32), (0, 0, 0, 5))
        return dict(
            w0frag=bf16mma.pack_b_fragments(w0mat),
            w1wg=bf16mma.pack_wgmma_b(
                w1.permute(2, 3, 1, 0).reshape(288, 64)),
            w0_oihw=w0.to(torch.bfloat16).contiguous(),
            w1_oihw=w1.to(torch.bfloat16).contiguous(),
            s0=s0.contiguous(), b0=b0.contiguous(),
            s1=s1.contiguous(), b1=b1.contiguous(), dtype=torch.bfloat16)


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


def _conv_bn_leaky_bf16(x, w, s, b):
    """The bf16 form's conv: NCHW 3x3/s2 SAME conv of bf16 operands with
    f32 sums, BN (x * s + b) and leaky in f32, rounded to bf16 once."""
    py = same_pad(x.shape[2], 3, 2)
    px = same_pad(x.shape[3], 3, 2)
    y = F.conv2d(F.pad(x.float(), (px[0], px[1], py[0], py[1])), w.float(),
                 stride=2)
    return F.leaky_relu(y * s[None, :, None, None] + b[None, :, None, None],
                        0.1).to(torch.bfloat16)


def _stem_plain_bf16(images: torch.Tensor, consts, size: int):
    bf = torch.bfloat16
    _, h, w, _ = images.shape
    dev = images.device
    wy = torch.as_tensor(_axis_resize_weights(h, size), device=dev)
    wx = torch.as_tensor(_axis_resize_weights(w, size)
                         * np.float32(1.0 / 255.0), device=dev)
    tmp = einsum_in(bf, "jx,byxc->byjc", wx, images, bf)
    x = einsum_in(bf, "iy,byjc->bcij", wy, tmp, bf)
    x = _conv_bn_leaky_bf16(x, consts["w0_oihw"], consts["s0"], consts["b0"])
    x = _conv_bn_leaky_bf16(x, consts["w1_oihw"], consts["s1"], consts["b1"])
    return x.permute(0, 2, 3, 1).contiguous()


@ieee_convs()
def detector_stem_plain(images: torch.Tensor, consts, size: int):
    """The kernel's plain twin: resize matmuls + F.conv2d (the form of
    `consts`)."""
    if cuda_build.consts_dtype(consts) == torch.bfloat16:
        return _stem_plain_bf16(images, consts, size)
    x = torch.stack([preprocess_detector_image(im, size) for im in images])
    x = x.permute(0, 3, 1, 2)
    x = _conv_bn_leaky(x, consts["w0_oihw"], consts["s0"], consts["b0"])
    x = _conv_bn_leaky(x, consts["w1_oihw"], consts["s1"], consts["b1"])
    return x.permute(0, 2, 3, 1).contiguous()


# The conv0 kernel's tile of 8 x 32 outputs lies over 2 * 8 + 1 resized
# rows and 2 * 32 + 1 resized columns (csrc/cuda_stem.cu: kR0H, kR0W).
_TILE_RESIZED_ROWS = 17
_TILE_RESIZED_COLS = 65
_MAX_SHARED_BYTES = 232448          # dynamic shared memory a block can get
_FOUR_BLOCKS_BYTES = 233472 // 4 - 1024     # ... and four blocks of one SM


def window_extent(start: np.ndarray, taps: int, span: int) -> int:
    """The most input rows that the tap windows of `span` consecutive
    output rows cover together: what a block of the conv0 kernel stages of
    the frame for its tile. The windows' starts must not decrease."""
    if (np.diff(start) < 0).any():
        raise ValueError("tap window starts must be non-decreasing")
    last = start[np.minimum(np.arange(len(start)) + span - 1,
                            len(start) - 1)]
    return int((last + taps - start).max())


def conv0_shared_bytes(fh_max: int, fw_max: int, band: int) -> int:
    """Dynamic shared memory of the conv0 kernel (csrc/cuda_stem.cu):
    constants, `band` rows of the frame patch (or the resized tile,
    whichever is larger) and all fh_max rows resampled along x (or the
    four warps' output staging)."""
    resized = -(-_TILE_RESIZED_ROWS * 2 * (_TILE_RESIZED_COLS // 2 + 1) * 3
                // 4) * 4
    patch_row = (fw_max * 3 + 6) // 4 * 4       # c0_patch_row
    return 4 * (27 * 32 + 64 + max(band * patch_row, resized)
                + max(fh_max * _TILE_RESIZED_COLS * 3, 4 * 1024))


def conv0_band(fh_max: int, fw_max: int) -> int:
    """How many rows of its frame patch a conv0 block stages at a time: all
    of them if four blocks then fit an SM, else as many as do, else as many
    as fit one block's shared memory."""
    for budget in (_FOUR_BLOCKS_BYTES, _MAX_SHARED_BYTES):
        for band in range(fh_max, 0, -1):
            if conv0_shared_bytes(fh_max, fw_max, band) <= budget:
                return band
    raise ValueError(
        f"a {fh_max} x {fw_max} pixel frame patch under one conv0 tile "
        f"needs {conv0_shared_bytes(fh_max, fw_max, 1)} bytes of shared "
        f"memory, more than the {_MAX_SHARED_BYTES} a block can have")


@functools.lru_cache(maxsize=None)
def conv0_patch(h: int, w: int, size: int):
    """(fh_max, fw_max, band): the frame rows and columns under a conv0
    tile of an h x w frame resized to `size`, and the rows staged at a
    time."""
    ry0, ryw = resize_taps(h, size)
    rx0, rxw = resize_taps(w, size)
    fh = window_extent(ry0, ryw.shape[1], _TILE_RESIZED_ROWS)
    fw = window_extent(rx0, rxw.shape[1], _TILE_RESIZED_COLS)
    return fh, fw, conv0_band(fh, fw)


# The bf16 kernel's tile of 8 x 16 conv1 outputs lies over 17 x 33 conv0
# pixels and 35 x 67 resized pixels (csrc/cuda_stem_bf16.cu: kRH, kRW).
_BF16_RESIZED_ROWS = 35
_BF16_RESIZED_COLS = 67
# the convs' weights, BN constants, two mbarriers, the next tile's
# geometry, up to a 128-byte boundary
_BF16_HEAD_BYTES = -(-(288 * 64 * 2 + 2048 + 192 * 4 + 32 + 64) // 128) * 128


def stem_bf16_shared_bytes(fh_max: int, fw_max: int, xs: int, ys: int,
                           kb: int) -> int:
    """Dynamic shared memory of the bf16 kernel (csrc/cuda_stem_bf16.cu,
    smem_bytes): the weights and BN constants; region P, the frame rows
    under a tile (and 40 elements past them), then its resized pixels (3
    planes of 48 x 72 + 16); region Q, the rows resampled along x (3 planes
    of 72 x y_row, y_row = round16(fh_max) + 8) with the two passes' band
    matrices (80 x (16 kb + 8) and 48 x y_row), then the 17 x 33 conv0
    pixels, 40 bf16 each; region T, the tap tables' rows under a tile (67
    of xs floats, 35 of ys)."""
    def r16(n):
        return -(-n // 16) * 16
    row = (fw_max * 3 + 14) // 8 * 8
    yrow = r16(fh_max) + 8
    p = r16(max((fh_max * row + 40) * 2, 3 * (48 * 72 + 16) * 2))
    q = r16(max(17 * 33 * 40 * 2,
                (3 * 72 * yrow + 80 * (16 * kb + 8) + 48 * yrow) * 2))
    t = r16((_BF16_RESIZED_COLS * xs + _BF16_RESIZED_ROWS * ys) * 4)
    return _BF16_HEAD_BYTES + p + q + t


def _band_steps(rx0: np.ndarray, taps: int, size: int) -> int:
    """The most k steps of 16 frame columns that the windows of 16
    consecutive resized columns of one tile span (csrc/cuda_stem_bf16.cu
    x_gemm, band_k0): the x pass's band width."""
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    pad0 = same_pad(size, 3, 2)[0]
    pad1 = same_pad(s0, 3, 2)[0]
    kb = 1
    for x0 in range(0, s1, 16):
        s_lo = 2 * (2 * x0 - pad1) - pad0
        sa, sb = max(s_lo, 0), min(s_lo + _BF16_RESIZED_COLS - 1, size - 1)
        fx0 = int(rx0[sa])
        for first in range(sa, sb + 1, 16):
            last = min(first + 15, sb)
            k0 = (int(rx0[first]) - fx0) // 16
            k1 = (int(rx0[last]) + taps - fx0 + 15) // 16
            kb = max(kb, k1 - k0)
    return kb


@functools.lru_cache(maxsize=None)
def stem_bf16_patch(h: int, w: int, size: int):
    """(fh_max, fw_max, xs, ys, kb): the frame rows and columns under a tile
    of the bf16 kernel for h x w frames resized to `size`, the row length of
    its column and row tap tables (a window start and the weights, padded
    to a multiple of 4 floats) and its x band's k steps. Raises where the
    plan does not fit one block's shared memory (frames far larger than the
    resize, as the f32 form's tile plan refuses 4K)."""
    ry0, ryw = resize_taps(h, size)
    rx0, rxw = resize_taps(w, size)
    fh = window_extent(ry0, ryw.shape[1], _BF16_RESIZED_ROWS)
    fw = window_extent(rx0, rxw.shape[1], _BF16_RESIZED_COLS)
    xs = (rxw.shape[1] + 4) // 4 * 4
    ys = (ryw.shape[1] + 4) // 4 * 4
    kb = _band_steps(rx0, rxw.shape[1], size)
    need = stem_bf16_shared_bytes(fh, fw, xs, ys, kb)
    if need > _MAX_SHARED_BYTES:
        raise ValueError(
            f"the {fh} x {fw} pixel frame patch under one tile of the bf16 "
            f"stem kernel ({h}x{w} frames resized to {size}) needs {need} "
            f"bytes of shared memory, more than the {_MAX_SHARED_BYTES} a "
            "block can have")
    return fh, fw, xs, ys, kb


_device_tables: Dict[tuple, tuple] = {}


def _tables_on(device, h: int, w: int, size: int):
    """The bf16 kernel's tap tables on `device`: (ytab, xtab), a row per
    resized row / column, [window start, its weights rounded to bf16
    (xtab's times 1/255), zeros], f32, ys / xs floats a row."""
    key = (str(device), h, w, size)
    if key not in _device_tables:
        _, _, xs, ys, _ = stem_bf16_patch(h, w, size)
        tabs = []
        for n_in, scale, width in ((h, 1.0, ys), (w, 1.0 / 255.0, xs)):
            start, wt = resize_taps(n_in, size, scale)
            tab = np.zeros((size, width), np.float32)
            tab[:, 0] = start
            tab[:, 1:1 + wt.shape[1]] = wt
            tabs.append(bf16mma.round_bf16(torch.as_tensor(tab)))
            tabs[-1][:, 0] = torch.as_tensor(start, dtype=torch.float32)
        _device_tables[key] = tuple(t.to(device) for t in tabs)
    return _device_tables[key]


_device_taps: Dict[tuple, tuple] = {}


def _taps_on(device, h: int, w: int, size: int):
    """The f32 form's tap tables on `device`."""
    key = (str(device), h, w, size)
    if key not in _device_taps:
        ry0, ryw = resize_taps(h, size)
        rx0, rxw = resize_taps(w, size, 1.0 / 255.0)
        _device_taps[key] = tuple(torch.as_tensor(a, device=device)
                                  for a in (ry0, ryw, rx0, rxw))
    return _device_taps[key]


# the constants the kernels read: the f32 form's (all f32) and the bf16
# form's (name -> (shape, dtype))
_SHAPES = dict(w0=(27, 32), s0=(32,), b0=(32,), w1frag=(36, 8, 32, 4),
               b1=(64,))
_SHAPES_BF16 = dict(w0frag=((2, 4, 32, 4), torch.bfloat16),
                    w1wg=((18, 8, 2, 8, 8), torch.bfloat16),
                    s0=((32,), torch.float32), b0=((32,), torch.float32),
                    s1=((64,), torch.float32), b1=((64,), torch.float32))


def _launch(images: torch.Tensor, consts, size: int) -> torch.Tensor:
    global launches
    dev = images.device
    dt = cuda_build.consts_dtype(consts)
    if (images.dtype != dt or images.dim() != 4
            or images.shape[-1] != 3 or not images.is_contiguous()):
        raise ValueError(f"images must be a contiguous (B, H, W, 3) {dt} "
                         "tensor (the form of the constants)")
    if dt == torch.bfloat16:
        return _launch_bf16(images, consts, size)
    cuda_build.check_constants(consts, _SHAPES, dev, "stem")
    b, h, w, _ = images.shape
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    pad0 = same_pad(size, 3, 2)[0]
    pad1 = same_pad(s0, 3, 2)[0]
    ry0, ryw, rx0, rxw = _taps_on(dev, h, w, size)
    fh_max, fw_max, band = conv0_patch(h, w, size)
    mid = torch.empty((b, s0, s0, 32), dtype=dt, device=dev)
    out = torch.empty((b, s1, s1, 64), dtype=dt, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.load("cuda_stem").gv_detector_stem
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I, I, I, P, P, I, P, P, I, I, I, I, I, I, P, P, P, I,
                   I, P, P, P, I, I, P, P]
    cuda_build.check(
        fn(images.data_ptr(), b, h, w, ry0.data_ptr(), ryw.data_ptr(),
           ryw.shape[1], rx0.data_ptr(), rxw.data_ptr(), rxw.shape[1], size,
           fh_max, fw_max, band,
           int(w * 3 % 4 == 0 and images.data_ptr() % 16 == 0),
           consts["w0"].data_ptr(), consts["s0"].data_ptr(),
           consts["b0"].data_ptr(), pad0, s0, mid.data_ptr(),
           consts["w1frag"].data_ptr(), consts["b1"].data_ptr(), pad1, s1,
           out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "gv_detector_stem")
    launches += 1
    return out


def _launch_bf16(images: torch.Tensor, consts, size: int) -> torch.Tensor:
    """The bf16 form: one launch of csrc/cuda_stem_bf16.cu, no scratch."""
    global launches_bf16
    dev = images.device
    cuda_build.check_constants(consts, _SHAPES_BF16, dev, "stem")
    if images.data_ptr() % 16:
        raise ValueError("bf16 frames must start at a 16-byte boundary (the "
                         "kernel copies their rows 16 bytes at a time)")
    b, h, w, _ = images.shape
    fh_max, fw_max, xs, ys, kb = stem_bf16_patch(h, w, size)
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    ytab, xtab = _tables_on(dev, h, w, size)
    out = torch.empty((b, s1, s1, 64), dtype=torch.bfloat16, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.load("cuda_stem_bf16").gv_detector_stem_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I, I, I, P, I, I, P, I, I, I, I, I, I, P, P, P, P, P,
                   P, I, I, I, I, P, P]
    cuda_build.check(
        fn(images.data_ptr(), b, h, w, ytab.data_ptr(), ys,
           resize_taps(h, size)[1].shape[1], xtab.data_ptr(), xs,
           resize_taps(w, size)[1].shape[1], size, fh_max, fw_max, kb,
           consts["w0frag"].data_ptr(),
           consts["w1wg"].data_ptr(), consts["s0"].data_ptr(),
           consts["b0"].data_ptr(), consts["s1"].data_ptr(),
           consts["b1"].data_ptr(), same_pad(size, 3, 2)[0], s0,
           same_pad(s0, 3, 2)[0], s1, out.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream),
        "gv_detector_stem_bf16")
    launches_bf16 += 1
    return out


def detector_stem_cuda(images: torch.Tensor, consts,
                       size: int) -> torch.Tensor:
    """(B, H, W, 3) [0, 255] frames -> (B, S/4, S/4, 64) post-ConvBN_1
    activation: the kernels on a CUDA tensor, the plain twin on a CPU
    tensor. consts: prepare_stem_constants on the frames' device; their
    form (f32 or bf16) is the frames' and the activation's dtype, and
    frames of another dtype raise."""
    if images.device.type == "cpu":
        dt = cuda_build.consts_dtype(consts)
        if images.dtype != dt:
            raise ValueError(f"frames must be {dt}, the form of the "
                             "constants")
        return detector_stem_plain(images, consts, size)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    return _launch(images, consts, size)
