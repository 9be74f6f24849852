"""bf16 tensor-core products, the arithmetic of the kernels' bf16 forms
(``csrc/gv_mma.cuh``: ``mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32``;
``csrc/gv_hopper.cuh``: ``wgmma``), in plain torch.

A product of two bf16 values (8 significant bits each) is exact in f32, and
the kernels accumulate in f32. So the plain form of a bf16 product is an
f32 matrix product of operands rounded to bf16: ``matmul_bf16`` here, and
``F.conv2d`` in f32 on bf16-rounded operands in the kernels' plain twins.
What differs from the card is only the order of the f32 sums (and the
tensor core's truncating accumulator), not the products.

What the kernels need on the host lives here too: ``pack_b_fragments`` lays
a weight matrix out in the order the warps read their m16n8k16 B fragments
(``prepare_stem_constants`` calls it once per model for the bf16 stem's
conv0); ``pack_wgmma_b`` lays one out in shared-memory order for
``wgmma.m64n64k16`` / ``m64n32k16`` / ``m64n96k16`` (the bf16 stem's conv1,
``csrc/cuda_stem_bf16.cu``; the bf16 CSP stage's four convs,
``csrc/cuda_csp_bf16.cu``), ``pack_wgmma_b_halves`` a wider one, 64
channels a product, for the bf16 orientation front
(``csrc/cuda_orient_bf16.cu``).
"""

from __future__ import annotations

import torch

from .tf32x3 import fragment_channel


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), kept in f32."""
    return x.to(torch.bfloat16).float()


def _fragment_index(k: int, n: int, dev):
    """(rows, cols), each (K / 16, N / 8, 32, 4): the weight w[rows, cols]
    that lane 4g + t of k step ks and n-tile nt holds in slot j. The mma's
    k columns (2t, 2t + 1) carry logical k 4t, 4t + 1 and its columns
    (2t + 8, 2t + 9) logical k 4t + 2, 4t + 3, so a thread's four A values
    of a row are neighbours (one 8-byte load), and so are
    its four B values: w[16 ks + 4t + j, ch], ch = fragment_channel(nt, g),
    the output channel order of the 3xTF32 form (one store of four
    neighbouring channels)."""
    lane = torch.arange(32, device=dev)
    g, t = lane // 4, lane % 4
    j = torch.arange(4, device=dev)
    rows = (16 * torch.arange(k // 16, device=dev)[:, None, None, None]
            + 4 * t[None, None, :, None] + j[None, None, None, :])
    cols = fragment_channel(torch.arange(n // 8, device=dev)[None, :, None,
                                                             None],
                            g[None, None, :, None])
    return rows.expand(k // 16, n // 8, 32, 4), \
        cols.expand(k // 16, n // 8, 32, 4)


def pack_b_fragments(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights, K % 16 == 0 and N % 16 == 0 -> the (K / 16, N / 8,
    32, 4) bf16 layout a warp reads its m16n8k16 B fragments from, one
    8-byte load a lane and n-tile: {b0, b1} of the mma, each two bf16."""
    k, n = w.shape
    if k % 16 or n % 16:
        raise ValueError(f"cannot pack a ({k}, {n}) matrix: K % 16 and "
                         "N % 16 must be 0")
    rows, cols = _fragment_index(k, n, w.device)
    return w.to(torch.bfloat16)[rows, cols].contiguous()


def unpack_b_fragments(frag: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_b_fragments: the (K, N) bf16 matrix."""
    ks, nts = frag.shape[:2]
    rows, cols = _fragment_index(16 * ks, 8 * nts, frag.device)
    w = torch.zeros((16 * ks, 8 * nts), dtype=torch.bfloat16,
                    device=frag.device)
    w[rows, cols] = frag
    return w


def _wgmma_index(k: int, n: int, dev):
    """(rows, cols), each (K / 16, N / 8, 2, 8, 8): the weight w[rows, cols]
    at [step, channel group, k half, row, column] of pack_wgmma_b's layout.
    The k order within a step is pack_b_fragments': mma k column 2t + e (e
    = 0, 1) holds logical k 4t + e, column 8 + 2t + e logical 4t + 2 + e,
    so that a thread's A values are four neighbouring channels of a pixel.
    Accumulator column c = 8j + 2t + e (j = c / 8) holds output channel
    32 (j / 4) + 8t + 2 (j % 4) + e, so that a thread's eight values of a
    row for j = 4h .. 4h + 3 are eight neighbouring channels."""
    s = torch.arange(k // 16, device=dev)[:, None, None, None, None]
    grp = torch.arange(n // 8, device=dev)[None, :, None, None, None]
    half = torch.arange(2, device=dev)[None, None, :, None, None]
    row = torch.arange(8, device=dev)[None, None, None, :, None]
    col = torch.arange(8, device=dev)[None, None, None, None, :]
    t, e = col // 2, col % 2
    rows = 16 * s + 4 * t + 2 * half + e
    c = 8 * grp + row
    t_n, e_n, j = (c % 8) // 2, c % 2, c // 8
    cols = 32 * (j // 4) + 8 * t_n + 2 * (j % 4) + e_n
    shape = (k // 16, n // 8, 2, 8, 8)
    return rows.expand(shape), cols.expand(shape)


def pack_wgmma_b(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights, K % 16 == 0, N 32, 64 or 96 -> the (K / 16, N / 8,
    2, 8, 8) bf16 layout of B for wgmma.m64n32k16 / m64n64k16 / m64n96k16
    from shared memory (K-major, no swizzle), one k step of 16 after
    another (32 N bytes each): the 8 x 8 core matrices (8 accumulator
    columns x 8 k, 128 contiguous bytes) by channel group (256 bytes apart)
    and k half (128 bytes apart)."""
    k, n = w.shape
    if k % 16 or n not in (32, 64, 96):
        raise ValueError(f"cannot pack a ({k}, {n}) matrix for wgmma: "
                         "K % 16 must be 0 and N 32, 64 or 96")
    rows, cols = _wgmma_index(k, n, w.device)
    return w.to(torch.bfloat16)[rows, cols].contiguous()


def unpack_wgmma_b(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of pack_wgmma_b: the (K, N) bf16 matrix."""
    k, n = 16 * packed.shape[0], 8 * packed.shape[1]
    rows, cols = _wgmma_index(k, n, packed.device)
    w = torch.zeros((k, n), dtype=torch.bfloat16, device=packed.device)
    w[rows, cols] = packed
    return w


def pack_wgmma_b_halves(w: torch.Tensor) -> torch.Tensor:
    """(K, N) weights, K % 16 == 0, N % 16 == 0, N <= 128 -> (K / 16,
    ceil(N / 64), 8, 2, 8, 8) bf16: B of wgmma.m64n128k16 (two halves of 64
    columns) or m64n64k16 (one), K-major without swizzle, the last half
    padded with zero columns. A k step's halves are pack_wgmma_b's steps
    side by side, so its 16 groups of 8 columns lie 256 bytes apart, as the
    descriptor's stride byte offset has them."""
    k, n = w.shape
    if k % 16 or n % 16 or n > 128:
        raise ValueError(f"cannot pack a ({k}, {n}) matrix for wgmma: "
                         "K % 16 and N % 16 must be 0, N <= 128")
    halves = -(-n // 64)
    wide = torch.cat([w, w.new_zeros((k, 64 * halves - n))], dim=1)
    return torch.stack([pack_wgmma_b(wide[:, 64 * h:64 * h + 64])
                        for h in range(halves)], dim=1).contiguous()


def unpack_wgmma_b_halves(packed: torch.Tensor, n: int) -> torch.Tensor:
    """The inverse of pack_wgmma_b_halves: the (K, n) bf16 matrix."""
    return torch.cat([unpack_wgmma_b(packed[:, h])
                      for h in range(packed.shape[1])], dim=1)[:, :n]


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the bf16 tensor cores compute it: both
    rounded to bf16, each product exact, the sums in f32."""
    return round_bf16(a.float()) @ round_bf16(b.float())
