"""3xTF32, the arithmetic of the tensor-core convolution kernels
(``csrc/gv_mma.cuh``), in plain torch.

A TF32 tensor-core product keeps 10 mantissa bits of each operand. The
kernels keep f32 accuracy by splitting every operand into
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` and accumulating
``a_lo * b_hi + a_hi * b_lo + a_hi * b_hi`` in f32. Two parts of that live
here:

- what the kernels need on the host: ``split_tf32`` and
  ``pack_b_fragments``, which lay a weight matrix out in the order the
  ``mma.sync.m16n8k8`` B fragments are read (``prepare_stem_constants``,
  ``prepare_csp_constants`` and ``prepare_orient_constants`` call it once
  per model);
- an emulation of the kernels' product for the CPU tests
  (``matmul_3xtf32``, ``conv2d_3xtf32``, ``detector_stem_3xtf32``,
  ``detector_csp_3xtf32``, ``orient_conv_3xtf32``): the same split, the
  same three products per k step in the same order, the steps accumulated
  in f32. It shows what the arithmetic costs in accuracy; it is not a twin
  of any kernel and nothing on a main path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.layers import fold_bn, same_pad
from .preprocess import preprocess_detector_image


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: the low 13 mantissa bits come out 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x -> (hi, lo), both TF32 values, with hi + lo == x to ~2^-22."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def fragment_channel(nt: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """The output channel held by column `col` of n-tile `nt`: a thread's
    columns (2t, 2t + 1) of tiles 2p and 2p + 1 are channels
    16p + 4t .. 16p + 4t + 3, one 16-byte store."""
    return 16 * (nt // 2) + 4 * (col // 2) + 2 * (nt % 2) + col % 2


def pack_b_fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 weights, K % 8 == 0 and N % 16 == 0 -> the
    (K / 8, N / 8, 32, 4) layout a warp reads its m16n8k8 B fragments
    from: lane 4g + t of k step ks and n-tile nt holds
    {b0_hi, b1_hi, b0_lo, b1_lo} with b0 = w[8 ks + 2t, ch] and
    b1 = w[8 ks + 2t + 1, ch], ch = fragment_channel(nt, g)."""
    k, n = w.shape
    if k % 8 or n % 16:
        raise ValueError(f"cannot pack a ({k}, {n}) matrix: K % 8 and "
                         "N % 16 must be 0")
    dev = w.device
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    rows = (8 * torch.arange(k // 8, device=dev)[:, None, None]
            + 2 * t[None, None, :])                         # (K/8, 1, 32)
    cols = fragment_channel(torch.arange(n // 8, device=dev)[None, :, None],
                            g[None, None, :])               # (1, N/8, 32)
    hi, lo = split_tf32(w.float())
    return torch.stack([hi[rows, cols], hi[rows + 1, cols],
                        lo[rows, cols], lo[rows + 1, cols]],
                       dim=-1).contiguous()


def unpack_b_fragments(frag: torch.Tensor):
    """The inverse of pack_b_fragments: (hi, lo), each (K, N)."""
    ks, nts = frag.shape[:2]
    dev = frag.device
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    rows = (8 * torch.arange(ks, device=dev)[:, None, None]
            + 2 * t[None, None, :]).expand(ks, nts, 32)
    cols = fragment_channel(torch.arange(nts, device=dev)[None, :, None],
                            g[None, None, :]).expand(ks, nts, 32)
    hi = torch.zeros((8 * ks, 8 * nts), dtype=torch.float32, device=dev)
    lo = torch.zeros_like(hi)
    hi[rows, cols], hi[rows + 1, cols] = frag[..., 0], frag[..., 1]
    lo[rows, cols], lo[rows + 1, cols] = frag[..., 2], frag[..., 3]
    return hi, lo


def matmul_3xtf32(a: torch.Tensor, b_hi: torch.Tensor,
                  b_lo: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N), K % 8 == 0, as the kernels compute it: a split
    here, b given split; per k step of 8 the three products summed small
    terms first, and the steps added up in order, all in f32."""
    a_hi, a_lo = split_tf32(a)
    m, k = a.shape
    steps = k // 8
    if k % 8:
        raise ValueError(f"K = {k} is not a multiple of the mma's k = 8")

    def partial(x, y):                        # (steps, M, N) per-step sums
        return torch.einsum("msk,skn->smn", x.reshape(m, steps, 8),
                            y.reshape(steps, 8, -1))

    per_step = (partial(a_lo, b_hi) + partial(a_hi, b_lo)) \
        + partial(a_hi, b_hi)
    out = torch.zeros_like(per_step[0])
    for step in per_step:
        out = out + step
    return out


def conv2d_3xtf32(x: torch.Tensor, wmat: torch.Tensor, kernel: int,
                  stride: int, pad) -> torch.Tensor:
    """NHWC conv as a 3xTF32 matrix product. x: (B, H, W, C); wmat:
    (kernel * kernel * C, C_out) in (ty, tx, c) row order; pad: (lo, hi)
    zero padding of both axes. Returns (B, H', W', C_out)."""
    b, _, _, c = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (pad[0], pad[1], pad[0], pad[1]))
    ho = (xp.shape[2] - kernel) // stride + 1
    wo = (xp.shape[3] - kernel) // stride + 1
    cols = F.unfold(xp, kernel, stride=stride)      # (B, C * k * k, L)
    cols = cols.reshape(b, c, kernel * kernel, ho * wo).permute(
        0, 3, 2, 1).reshape(b * ho * wo, kernel * kernel * c)
    w_hi, w_lo = split_tf32(wmat)
    return matmul_3xtf32(cols, w_hi, w_lo).reshape(b, ho, wo, -1)


def folded_matrix(conv_bn):
    """A ConvBN -> its (k * k * C_in, C_out) matrix in (ty, tx, c) row
    order with the BN scale folded in, and the BN shift."""
    w = conv_bn.conv_weight().detach()
    o, i, kh, kw = w.shape
    scale, shift = fold_bn(conv_bn.BatchNorm_0)
    return w.permute(2, 3, 1, 0).reshape(kh * kw * i, o) * scale, shift


def detector_stem_3xtf32(images: torch.Tensor, detector,
                         size: int) -> torch.Tensor:
    """The stem of ops/cuda_stem.py as its kernels compute it: the resize
    and ConvBN_0 in plain f32 (the kernel runs them in FFMA: the module's
    own forward here), ConvBN_1 (3x3/s2, 32->64) a 3xTF32 product with the
    BN scale folded into the weights: (B, H, W, 3) frames in [0, 255] ->
    (B, S/4, S/4, 64), NHWC."""
    x = torch.stack([preprocess_detector_image(im, size) for im in images])
    y = detector.ConvBN_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    wmat, shift = folded_matrix(detector.ConvBN_1)
    out = conv2d_3xtf32(y, wmat, 3, 2, same_pad(y.shape[1], 3, 2))
    return F.leaky_relu(out + shift, 0.1)


def detector_csp_3xtf32(x: torch.Tensor, detector) -> torch.Tensor:
    """The CSP stage of ops/cuda_csp.py with every conv a 3xTF32 product:
    (B, H, W, 64) -> (B, H / 2, W / 2, 128), NHWC."""
    csp = detector.CSPBlock_0

    def conv(inp, conv_bn, kernel):
        wmat, shift = folded_matrix(conv_bn)
        p = (kernel // 2, kernel // 2)
        return F.leaky_relu(conv2d_3xtf32(inp, wmat, kernel, 1, p) + shift,
                            0.1)

    y = conv(x, detector.ConvBN_2, 3)
    x1 = conv(y[..., 32:], csp.ConvBN_0, 3)
    x2 = conv(x1, csp.ConvBN_1, 3)
    x3 = conv(torch.cat([x2, x1], -1), csp.ConvBN_2, 1)
    out = torch.cat([y, x3], -1).permute(0, 3, 1, 2)
    return F.max_pool2d(out, 2, 2).permute(0, 2, 3, 1).contiguous()


def orient_conv_3xtf32(std: torch.Tensor, model) -> torch.Tensor:
    """ConvBN_0 of an OrientationNetS2D (the folded 12x12/s8 stem, BN,
    relu) on standardized (N, S, S, 3) crops as a 3xTF32 product:
    (N, S / 8, S / 8, F), NHWC."""
    conv = model.ConvBN_0
    wmat, shift = folded_matrix(conv)
    block = conv.block
    k = conv.Conv_0.kernel_size[0]
    lo, hi = same_pad(std.shape[1] // block, k, conv.stride)
    out = conv2d_3xtf32(std, wmat, k * block, conv.stride * block,
                        (lo * block, hi * block))
    return F.relu(out + shift)
