"""Shared layers of the two nets: flax-compatible SAME padding, inference
BatchNorm and the conv + BN + activation block.

Module attribute names follow the flax parameter tree (``Conv_0``,
``BatchNorm_0``) so a flax path maps onto a state-dict key one to one
(models/weights.params_from_jax).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5                       # flax nn.BatchNorm's default epsilon


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding (lo, hi) of one axis. For a 3x3/s2 conv on
    an even input it is (0, 1), not the (1, 1) of padding=1."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
                bias: torch.Tensor | None = None,
                block: int = 1) -> torch.Tensor:
    """NCHW conv with SAME padding. block > 1: the padding is computed on a
    grid of block x block pixel blocks and scaled to pixels (the folded s2d
    stem of the orientation net); weight is then (F, C, k*block, k*block)
    and stride is in pixels."""
    kh = weight.shape[-1] // block
    sh = stride // block
    py = same_pad(x.shape[2] // block, kh, sh)
    px = same_pad(x.shape[3] // block, kh, sh)
    x = F.pad(x, (px[0] * block, px[1] * block, py[0] * block, py[1] * block))
    return F.conv2d(x, weight, bias, stride=stride)


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax's parameters: weight (flax ``scale``),
    bias, running_mean / running_var (flax ``batch_stats``)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


def fold_bn(bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> per-channel (scale, shift) in f32."""
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias.detach() - bn.running_mean * scale


class ConvBN(nn.Module):
    """Conv (no bias, SAME) + BatchNorm + activation, NCHW.
    act: "leaky" (slope 0.1, the detector) or "relu" (the orientation net).

    block > 1 (the orientation net's s2d_fold stem): the input is the RAW
    (N, C, H, W) image, Conv_0 holds the canonical post-space-to-depth
    (F, C*block*block, k, k) kernel, and the conv runs as the exact
    equivalent (k*block)-square conv at stride*block on the raw pixels."""

    def __init__(self, c_in: int, features: int, kernel: int = 3,
                 stride: int = 1, act: str = "leaky", block: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c_in * block * block, features, kernel,
                                stride, bias=False)
        self.BatchNorm_0 = BatchNorm(features)
        self.stride = stride
        self.act = act
        self.block = block

    def conv_weight(self) -> torch.Tensor:
        w = self.Conv_0.weight
        b = self.block
        if b == 1:
            return w
        f, cbb, k, _ = w.shape
        cin = cbb // (b * b)
        # s2d input channel index is (py*b + px)*C + c
        hwio = w.permute(2, 3, 1, 0).reshape(k, k, b, b, cin, f)
        big = hwio.permute(0, 2, 1, 3, 4, 5).reshape(k * b, k * b, cin, f)
        return big.permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv2d_same(x, self.conv_weight(), self.stride * self.block,
                        block=self.block)
        x = self.BatchNorm_0(x)
        if self.act == "leaky":
            return F.leaky_relu(x, 0.1)
        return F.relu(x)
