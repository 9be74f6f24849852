"""Shared layers of the two nets: flax-compatible SAME padding, inference
BatchNorm and the conv + BN + activation block.

The compute dtype is the activation's: an f32 input runs in f32, a bf16
input in the JAX package's bf16 mode (flax modules with dtype=bf16, as XLA
compiles them): conv operands rounded to bf16 with f32 sums, BatchNorm on
those sums in f32 as flax's _normalize does ((x - mean) * (rsqrt(var +
eps) * scale) + bias, not the folded x * s + b) and rounded to bf16 once,
the activation on the bf16 value (flax's leaky slope rounded to bf16). On
the card the convs are cuDNN's bf16 convs, whose output is rounded to bf16
before the BatchNorm.

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
_SLOPE = 0.1                        # leaky (flax rounds it to bf16 there)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           round_out: bool = True) -> torch.Tensor:
    """F.conv2d in the input's dtype. bf16 (flax's bf16 Conv as XLA
    compiles it): operands rounded to bf16, f32 sums, the bias rounded to
    bf16 and added, the result rounded to bf16 once; round_out=False keeps
    the sums for a consumer that rounds (the BatchNorm of ConvBN). On the
    card the sums are cuDNN's bf16 conv, whose output is already rounded."""
    if x.dtype == torch.float32:
        return F.conv2d(x, weight, bias, stride=stride)
    w = weight.to(x.dtype)
    if x.is_cuda:
        y = F.conv2d(x, w, stride=stride)
    else:
        y = F.conv2d(x.float(), w.float(), stride=stride)
    if bias is not None:
        y = y + bias.to(x.dtype).to(y.dtype)[:, None, None]
    return y.to(x.dtype) if round_out else y


def same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding (lo, hi) of one axis. For a 3x3/s2 conv on
    an even input it is (0, 1), not the (1, 1) of padding=1."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
                bias: torch.Tensor | None = None, block: int = 1,
                round_out: bool = True) -> torch.Tensor:
    """NCHW conv with SAME padding. block > 1: the padding is computed on a
    grid of block x block pixel blocks and scaled to pixels (the folded s2d
    stem of the orientation net); weight is then (F, C, k*block, k*block)
    and stride is in pixels."""
    kh = weight.shape[-1] // block
    sh = stride // block
    py = same_pad(x.shape[2] // block, kh, sh)
    px = same_pad(x.shape[3] // block, kh, sh)
    x = F.pad(x, (px[0] * block, px[1] * block, py[0] * block, py[1] * block))
    return conv2d(x, weight, bias, stride, round_out)


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax's parameters: weight (flax ``scale``),
    bias, running_mean / running_var (flax ``batch_stats``)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """BN of x in `dtype` (default x's): f32 as F.batch_norm, bf16 as
        flax's _normalize in f32, rounded to bf16 once."""
        dtype = dtype or x.dtype
        if dtype != torch.float32:
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            y = ((x.float() - self.running_mean.view(shape))
                 * mul.view(shape) + self.bias.view(shape))
            return y.to(dtype)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=BN_EPS)


def fold_bn(bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm -> per-channel (scale, shift) in f32."""
    scale = bn.weight.detach() / torch.sqrt(bn.running_var + BN_EPS)
    return scale, bn.bias.detach() - bn.running_mean * scale


class ConvBN(nn.Module):
    """Conv (no bias, SAME) + BatchNorm + activation, NCHW, in the input's
    dtype. act: "leaky" (slope 0.1, the detector) or "relu" (the
    orientation net).

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
        dtype = x.dtype
        x = conv2d_same(x, self.conv_weight(), self.stride * self.block,
                        block=self.block, round_out=False)
        x = self.BatchNorm_0(x, dtype)
        if self.act != "leaky":
            return F.relu(x)
        if x.dtype == torch.float32:
            return F.leaky_relu(x, _SLOPE)
        return torch.where(x >= 0, x,
                           x * torch.full((), _SLOPE, dtype=x.dtype,
                                          device=x.device))
