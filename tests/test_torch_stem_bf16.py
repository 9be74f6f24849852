"""The bf16 stem kernel's host side (csrc/cuda_stem_bf16.cu): the wgmma
packing of ConvBN_1's weights (bf16mma.pack_wgmma_b) and the tile plan
(stem_bf16_patch, stem_bf16_shared_bytes), on the CPU.

The kernel reads B of wgmma.m64n64k16 from shared memory through a
descriptor (K-major, no swizzle: 8 x 8 core matrices of 128 contiguous
bytes, the two k halves of a step 128 bytes apart, the channel groups 256
apart) and its A fragments in pack_b_fragments' k order. The product below
reads the packed buffer exactly so and must give a @ w; the kernel itself
is held to the same product on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch.models.layers import same_pad
from grid_vision_tpu_torch.ops import bf16mma, cuda_stem

torch.set_num_threads(1)

BF = torch.bfloat16


def _acc_channel(n):
    """csrc/cuda_stem_bf16.cu acc_channel: accumulator column n = 8j + 2t
    + e -> output channel 32 (j / 4) + 8t + 2 (j % 4) + e."""
    j, t, e = n // 8, (n % 8) // 2, n % 2
    return 32 * (j // 4) + 8 * t + 2 * (j % 4) + e


def _logical_k(p):
    """The mma k column p of a step -> the logical k (the A fragment's
    order: columns 2t, 2t + 1 hold 4t, 4t + 1; 8 + 2t, 9 + 2t hold 4t + 2,
    4t + 3)."""
    t, e = (p % 8) // 2, p % 2
    return 4 * t + 2 * (p // 8) + e


def _wgmma_product(a, packed):
    """a (M, K) @ B as the kernel computes it from the packed buffer: per k
    step, B[p][n] at byte 2048 s + 256 (n / 8) + 128 (p / 8) + 16 (n % 8) +
    2 (p % 8), A[m][p] = a[m][16 s + logical(p)], the accumulator's column n
    stored as channel acc_channel(n)."""
    flat = packed.reshape(-1).float()
    m, k = a.shape
    d = torch.zeros((m, 64), dtype=torch.float64)
    p = torch.arange(16)
    n = torch.arange(64)
    for s in range(k // 16):
        idx = (1024 * s + 128 * (n[None, :] // 8) + 64 * (p[:, None] // 8)
               + 8 * (n[None, :] % 8) + p[:, None] % 8)
        b = flat[idx].double()                           # (16, 64)
        ap = a[:, 16 * s + torch.tensor([_logical_k(int(q)) for q in p])]
        d += ap.double() @ b
    out = torch.empty_like(d)
    out[:, [_acc_channel(int(c)) for c in n]] = d
    return out


@pytest.mark.parametrize("k", [16, 288])
def test_wgmma_b_round_trip_and_layout(k):
    rng = np.random.default_rng(k)
    w = torch.as_tensor(rng.normal(0, 1, (k, 64)).astype(np.float32))
    packed = bf16mma.pack_wgmma_b(w)
    assert packed.shape == (k // 16, 8, 2, 8, 8) and packed.dtype == BF
    assert packed.numel() * 2 == k * 128            # 2048 bytes a k step
    assert torch.equal(bf16mma.unpack_wgmma_b(packed), w.to(BF))
    # [step, channel group, k half, row, column] = w[16 s + logical k,
    # acc_channel(8 group + row)]
    for s, grp, half, row, col in ((0, 0, 0, 0, 0), (0, 3, 1, 5, 6),
                                   (k // 16 - 1, 7, 1, 7, 7),
                                   (k // 16 - 1, 4, 0, 2, 3)):
        want = w[16 * s + _logical_k(8 * half + col),
                 _acc_channel(8 * grp + row)].to(BF)
        assert packed[s, grp, half, row, col] == want
    a = torch.as_tensor(rng.normal(0, 1, (64, k)).astype(np.float32)).to(BF)
    want = a.double() @ w.to(BF).double()
    torch.testing.assert_close(_wgmma_product(a, packed), want, rtol=1e-12,
                               atol=1e-12)


def test_wgmma_b_rejects_other_shapes():
    with pytest.raises(ValueError, match="K % 16"):
        bf16mma.pack_wgmma_b(torch.zeros((40, 64)))
    with pytest.raises(ValueError, match="N 32, 64 or 96"):
        bf16mma.pack_wgmma_b(torch.zeros((32, 48)))


def _tile_extent(h, w, size):
    """The most frame rows / columns under one tile, from the kernel's own
    tile geometry (csrc/cuda_stem_bf16.cu tile_at): 35 x 67 resized pixels
    from 2 (2 y0 - pad1) - pad0, clipped to the image."""
    ry0, ryw = cuda_stem.resize_taps(h, size)
    rx0, rxw = cuda_stem.resize_taps(w, size)
    s0 = -(-size // 2)
    s1 = -(-s0 // 2)
    pad0 = same_pad(size, 3, 2)[0]
    pad1 = same_pad(s0, 3, 2)[0]
    fh = fw = 0
    for y0 in range(0, s1, 8):
        r_lo = 2 * (2 * y0 - pad1) - pad0
        ra, rb = max(r_lo, 0), min(r_lo + 34, size - 1)
        fh = max(fh, ry0[rb] + ryw.shape[1] - ry0[ra])
    for x0 in range(0, s1, 16):
        s_lo = 2 * (2 * x0 - pad1) - pad0
        sa, sb = max(s_lo, 0), min(s_lo + 66, size - 1)
        fw = max(fw, rx0[sb] + rxw.shape[1] - rx0[sa])
    return fh, fw


@pytest.mark.parametrize("h,w,size", [(480, 640, 416), (200, 260, 148),
                                      (120, 160, 150), (375, 1242, 416)])
def test_tile_plan_covers_every_tile(h, w, size):
    """The frame patch the launch is planned for holds every tile's rows
    and columns; at the ticks' shapes two blocks fit an SM."""
    plan = cuda_stem.stem_bf16_patch(h, w, size)
    fh, fw = plan[:2]
    th, tw = _tile_extent(h, w, size)
    assert th <= fh and tw <= fw
    need = cuda_stem.stem_bf16_shared_bytes(*plan)
    assert need <= 232448
    if (h, w, size) == (480, 640, 416):
        assert (fh, fw) == (43, 106)
        assert need == 115680 and 2 * (need + 1024) <= 233472


def test_tile_plan_refuses_what_does_not_fit():
    """Frames far larger than the resize (4K to 416): the frame rows under
    one tile do not fit a block's shared memory, so the launch is refused
    before anything runs (the twin takes any size)."""
    with pytest.raises(ValueError, match="shared memory"):
        cuda_stem.stem_bf16_patch(2160, 3840, 416)
