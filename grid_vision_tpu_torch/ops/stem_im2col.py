"""The detector front end as batched matmuls: the
``detector_stem_backend="im2col"`` path (counterpart of
grid_vision_tpu/ops/pallas_stem.py's detector_stem_im2col_xla).

(B, H, W, 3) HWC frames in [0, 255] of any size -> (B, S/4, S/4, 64), the
post-ConvBN_1 activation YoloV4Tiny takes with stem_external=True: the
frame resized straight into stride-4 phase planes (constant weight
matmuls, 1/255 folded into the x weights), ConvBN_0 as one matmul of the
packed im2col matrix (four output phases a row, K = 108) with a
block-diagonal weight, ConvBN_1 as one im2col matmul (K = 288), BN folded
to a scale and shift, leaky 0.1. It is the XLA form of the stem kernel's
math, not a kernel: its products are library matmuls (torch.einsum). The
compute dtype is the caller's: bf16 rounds the frame, the weights and each
product's result as the JAX function does, with f32 sums and an f32
epilogue.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from ..models.layers import fold_bn
from .preprocess import _axis_resize_weights

PACK0 = 4           # conv0 output pixels packed per matmul row


@functools.lru_cache(maxsize=None)
def phase4_resize_weights(n_in: int, size: int,
                          scale: float = 1.0) -> List[np.ndarray]:
    """The (size, n_in) resize matrix split by output row mod 4: four
    (size // 4 + 1, n_in) matrices, phase m holding rows 4k + m, padded with
    zero rows (phase 0's extra row is ConvBN_0's SAME padding at `size`)."""
    w = _axis_resize_weights(n_in, size) * scale
    q1 = size // 4 + 1
    return [np.concatenate([w[m::4], np.zeros((q1 - len(w[m::4]), n_in),
                                              np.float32)])
            for m in range(4)]


@functools.lru_cache(maxsize=None)
def _phase_weights_on(n_in: int, size: int, scale: float,
                      device: torch.device) -> List[torch.Tensor]:
    """phase4_resize_weights on `device`, copied there once."""
    return [torch.as_tensor(m, device=device)
            for m in phase4_resize_weights(n_in, size, scale)]


def prepare_im2col_constants(detector) -> Dict[str, torch.Tensor]:
    """The stem's folded weights from a YoloV4Tiny, f32 on its device (the
    JAX package's prepare_stem_constants): w0blk (108, 128), ConvBN_0's
    (27, 32) matrix in (ty, tx, c) row order block-diagonal over PACK0
    pixels, s0 / b0 its BN scale and shift tiled to (1, 128); w1 (288, 64),
    ConvBN_1's matrix in (ty, tx, c) row order, s1 / b1 (1, 64)."""
    with torch.no_grad():
        c0, c1 = detector.ConvBN_0, detector.ConvBN_1
        w0 = c0.Conv_0.weight.detach().permute(2, 3, 1, 0).reshape(27, 32)
        s0, b0 = fold_bn(c0.BatchNorm_0)
        s1, b1 = fold_bn(c1.BatchNorm_0)
        return dict(
            w0blk=torch.block_diag(*[w0] * PACK0),
            s0=s0.repeat(PACK0).reshape(1, -1),
            b0=b0.repeat(PACK0).reshape(1, -1),
            w1=c1.Conv_0.weight.detach().permute(2, 3, 1, 0).reshape(288, 64)
            .contiguous(),
            s1=s1.reshape(1, 64), b1=b1.reshape(1, 64))


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, 0.1 * x)


def _mm(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum of operands held in the compute dtype, summed in f32 (bf16
    products are exact in f32)."""
    return torch.einsum(equation, a.float(), b.float())


@torch.no_grad()
def detector_stem_im2col(images: torch.Tensor, consts, size: int,
                         dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, 3) frames in [0, 255] -> (B, S/4, S/4, 64) in `dtype`.
    consts: prepare_im2col_constants on the frames' device."""
    b, h, w, _ = images.shape
    dev = images.device
    q = size // 4
    mq = q * q
    wx4 = [m.to(dtype) for m in _phase_weights_on(w, size, 1.0 / 255.0, dev)]
    wy4 = [m.to(dtype) for m in _phase_weights_on(h, size, 1.0, dev)]
    img = images.to(dtype).permute(0, 3, 1, 2)             # (B, 3, H, W)

    # stride-4 phase planes of the resized frame: r16[mi][mj] (B, 3, Q1, Q1)
    t4 = [_mm("bcyx,jx->bcyj", img, wx4[mj]).to(dtype) for mj in range(4)]
    r16 = [[_mm("iy,bcyj->bcij", wy4[mi], t4[mj]).to(dtype)
            for mj in range(4)] for mi in range(4)]

    rows = []
    for pi in range(2):
        for pj in range(2):
            for ty in range(3):
                for tx in range(3):
                    oy, my = divmod(2 * pi + ty, 4)
                    ox, mx = divmod(2 * pj + tx, 4)
                    rows.append(r16[my][mx][:, :, oy:oy + q, ox:ox + q]
                                .reshape(b, 3, mq))
    i2c0 = torch.cat(rows, dim=1)                          # (B, 108, mq)
    acc0 = _mm("bkm,kn->bnm", i2c0, consts["w0blk"].to(dtype))
    mid0 = _leaky(acc0 * consts["s0"].reshape(1, -1, 1)
                  + consts["b0"].reshape(1, -1, 1)).to(dtype)

    # conv0's four output phases, zero-padded for ConvBN_1's SAME (0, 1)
    ph = [torch.nn.functional.pad(
        mid0[:, g * 32:(g + 1) * 32].reshape(b, 32, q, q), (0, 1, 0, 1))
        for g in range(PACK0)]
    taps = [ph[(ty % 2) * 2 + tx % 2][:, :, ty // 2:ty // 2 + q,
                                      tx // 2:tx // 2 + q].reshape(b, 32, mq)
            for ty in range(3) for tx in range(3)]
    i2c1 = torch.cat(taps, dim=1)                          # (B, 288, mq)
    acc1 = _mm("bkm,kf->bfm", i2c1, consts["w1"].to(dtype))
    out = _leaky(acc1 * consts["s1"].reshape(1, -1, 1)
                 + consts["b1"].reshape(1, -1, 1)).to(dtype)
    return out.reshape(b, 64, q, q).permute(0, 2, 3, 1)
