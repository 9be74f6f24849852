"""The bf16 orientation-front kernel's host side (csrc/cuda_orient_bf16.cu),
on the CPU: the wgmma layout of its weights (bf16mma.pack_wgmma_b_halves,
through prepare_orient_constants), the A fragments its threads gather from
the standardized crop rows a block holds, and the plan that cuts a crop
among the blocks of a cluster (cuda_orient.orient_bf16_plan, the mirror of
the kernel's make_plan).

The emulated product reads the packed buffer the way the kernel's wgmma
descriptors do and gathers A with the kernel's own address formula (row g
of a warp's fragment = output pixel 2g, row g + 8 = pixel 2g + 1; a
thread's four k from one 8-byte load), and must give F.conv2d of the
twin's operands. The kernel itself is held to its twin on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from grid_vision_tpu_torch.models import orientation_net
from grid_vision_tpu_torch.models.layers import same_pad
from grid_vision_tpu_torch.ops import bf16mma, cuda_orient

from .test_torch_stem_bf16 import _acc_channel, _logical_k, _wgmma_product

torch.set_num_threads(1)

BF = torch.bfloat16
MAX_SHARED = 232448


def _net(width, seed, size=64):
    torch.manual_seed(seed)
    net = orientation_net.OrientationNetS2D(orientation_net.OrientationConfig(
        input_size=size, width=width)).eval()
    bn = net.ConvBN_0.BatchNorm_0
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.5)
        bn.running_mean.normal_(0, 0.3)
        bn.running_var.uniform_(0.5, 2.0)
    return net


@pytest.mark.parametrize("f", [32, 64, 128])
def test_wgmma_halves_round_trip_and_layout(f):
    """prepare_orient_constants(bf16) packs the (432, F) weights (row
    uy * 36 + ux * 3 + c, no padding) into wgmma's layout, a k step's
    ceil(F / 64) halves side by side; they unpack to the matrix, the
    padding columns are zero, and entries sit where the descriptors read
    them (a step's 16 groups of 8 channels 256 bytes apart)."""
    consts = cuda_orient.prepare_orient_constants(_net(f // 4, f), BF)
    packed, w_oihw = consts["wwg"], consts["w_oihw"]
    halves = -(-f // 64)
    assert packed.shape == (27, halves, 8, 2, 8, 8) and packed.dtype == BF
    assert packed.numel() * 2 == halves * 27 * 2048
    w = w_oihw.permute(2, 3, 1, 0).reshape(432, f)
    assert torch.equal(bf16mma.unpack_wgmma_b_halves(packed, f), w)
    full = bf16mma.unpack_wgmma_b_halves(packed, 64 * halves)
    assert not full[:, f:].float().any()
    # [step, half, channel group, k half, row, column] = w_oihw[channel,
    # c, uy, ux] of k = 16 s + logical k = uy * 36 + ux * 3 + c
    for h, s, grp, kh, row, col in ((0, 0, 0, 0, 0, 0), (0, 5, 3, 1, 5, 6),
                                    (halves - 1, 26, 7, 1, 7, 7),
                                    (halves - 1, 13, 2, 0, 2, 3)):
        k = 16 * s + _logical_k(8 * kh + col)
        ch = 64 * h + _acc_channel(8 * grp + row)
        uy, rest = divmod(k, 36)
        ux, c = divmod(rest, 3)
        want = w_oihw[ch, c, uy, ux] if ch < f else torch.zeros((), dtype=BF)
        assert packed[s, h, grp, kh, row, col] == want
    # the byte a step's descriptor reads it at: 2048 halves s + 256 (8 h +
    # group) + 128 k half + 16 row + 2 column
    flat = packed.reshape(-1)
    for s, h, grp, kh, row, col in ((3, halves - 1, 6, 1, 2, 5),):
        byte = (2048 * halves * s + 256 * (8 * h + grp) + 128 * kh + 16 * row
                + 2 * col)
        assert flat[byte // 2] == packed[s, h, grp, kh, row, col]


def _block_rows(std, b, plan, size):
    """The crop rows block b of a cluster holds, laid out as the kernel
    keeps them: crop_rows rows of `stride` bf16, row i = crop row
    8 rows b + i, zero past the crop and in the 4 right padding pixels."""
    _, rows, crop_rows, stride = plan[:4]
    buf = torch.zeros((crop_rows, stride), dtype=BF)
    r0 = 8 * rows * b
    n = max(min(crop_rows, size - r0), 0)
    buf[:n, :3 * size] = std[r0:r0 + n].reshape(n, 3 * size)
    return buf.reshape(-1)


def _gather_a(buf, b, plan, q):
    """A (64 tiles, 432) as block b's threads load it and the output pixel
    of each row (-1: no pixel, its results are dropped): warpgroup wg,
    warp w, fragment row r (g = r % 8) is pixel 64 wg + 16 w + 2 g + r / 8;
    thread t of step s loads k = 16 s + 4 t .. + 3 from base + off with
    base = 8 oy stride + 24 ox + 4 t, uy = (16 s + 4 t) / 36 and off =
    uy stride + 16 s - 36 uy."""
    _, rows, _, stride = plan[:4]
    npx = max(min(rows, q - rows * b), 0) * q
    m = torch.arange(-(-npx // 64) * 64)
    r = m % 16
    p = 64 * (m // 64) + 16 * ((m % 64) // 16) + 2 * (r % 8) + r // 8
    pix = torch.where(p < npx, p, torch.full_like(p, -1))
    pc = torch.where(p < npx, p, torch.zeros_like(p))
    oy, ox = pc // q, pc % q
    k = torch.arange(432)
    s, t, j = k // 16, (k % 16) // 4, k % 4
    uy = (16 * s + 4 * t) // 36
    assert torch.equal(uy, k // 36)       # four k never straddle a tap row
    off = uy * stride + 16 * s - 36 * uy + 4 * t + j
    addr = (8 * oy * stride + 24 * ox)[:, None] + off[None, :]
    return buf[addr], pix


@pytest.mark.parametrize("size,f", [(64, 128), (64, 32), (224, 128),
                                    (224, 64), (96, 64)])
def test_gather_times_packed_b_is_the_conv(size, f):
    """Every block of the plan: its crop rows of a standardized bf16 crop,
    A gathered as the kernel gathers it, times the packed B as the
    descriptors read it, scattered to the pixels: F.conv2d in f32 of the
    twin's operands (the twin's SAME padding, stride 8)."""
    consts = cuda_orient.prepare_orient_constants(_net(f // 4, size + f,
                                                       size), BF)
    rng = np.random.default_rng(size + f)
    std = torch.as_tensor(rng.normal(0, 1, (size, size, 3))
                          .astype(np.float32)).to(BF)
    plan = cuda_orient.orient_bf16_plan(size, f)
    q = size // 8
    got = torch.full((q * q, f), float("nan"), dtype=torch.float64)
    for b in range(plan[0]):
        a, pix = _gather_a(_block_rows(std, b, plan, size), b, plan, q)
        if a.shape[0] == 0:
            continue
        wwg = consts["wwg"]
        d = torch.cat([_wgmma_product(a, wwg[:, h])
                       for h in range(wwg.shape[1])], dim=1)[:, :f]
        keep = pix >= 0
        got[plan[1] * b * q + pix[keep]] = d[keep]
    lo, hi = (4 * p for p in same_pad(size // 4, 3, 2))
    want = F.conv2d(F.pad(std.float().permute(2, 0, 1)[None],
                          (lo, hi, lo, hi)),
                    consts["w_oihw"].float(), stride=8)[0]
    torch.testing.assert_close(got.reshape(q, q, f).float(),
                               want.permute(1, 2, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [64, 96, 224])
@pytest.mark.parametrize("f", [32, 64, 128])
def test_plan_covers_every_row_once(size, f):
    """The blocks of a cluster own every output row exactly once, hold
    every crop row their outputs read (12 from 8 oy, the low SAME pad being
    0 at size % 8 == 0) and the 4 right padding pixels, add the moments of
    every crop row exactly once, fit four m64 tiles and one block's shared
    memory; 224 takes a cluster of 4."""
    cluster, rows, crop_rows, stride, buf, smem = \
        cuda_orient.orient_bf16_plan(size, f)
    q = size // 8
    assert cuda_orient._pad_lo(size) == 0
    owners = np.zeros(q, int)
    moments = np.zeros(size, int)
    for b in range(cluster):
        oy = np.arange(rows * b, min(rows * (b + 1), q))
        owners[oy] += 1
        assert len(oy) * q <= 4 * 64
        first = 8 * rows * b
        if len(oy):
            assert 8 * oy.min() >= first
            assert 8 * oy.max() + 12 <= first + crop_rows
        moments[first:min(first + 8 * rows, size)] += 1
    assert (owners == 1).all() and (moments == 1).all()
    assert stride >= 3 * (size + 4) and stride % 4 == 0
    assert 4 <= buf <= 16 and smem <= MAX_SHARED
    assert smem == (-(-f // 64) * 27 * 2048 + 2 * 128 * 4 + 512
                    + 16 * (size + crop_rows) + 2 * crop_rows * stride
                    + 8 * size * buf)
    if size == 224:
        assert (cluster, rows, crop_rows) == (4, 7, 60)


@pytest.mark.parametrize("size,f", [(448, 128), (224, 144), (100, 64),
                                    (224, 24), (0, 32)])
def test_plan_refuses_what_does_not_fit(size, f):
    """Crops too large for a cluster of 8 blocks, widths past 128 or not a
    multiple of 16, sizes not a multiple of 8: refused before anything
    runs (the twin takes them)."""
    with pytest.raises(ValueError, match="orientation kernel"):
        cuda_orient.orient_bf16_plan(size, f)
