"""The bf16 CSP kernel's host side (csrc/cuda_csp_bf16.cu), on the CPU: its
plan (ops/cuda_csp.csp_bf16_plan: strips and bands), the wgmma packing of
the four convs' weights at N = 32 and 64 (bf16mma.pack_wgmma_b) with
their rows paired (cuda_csp.k_pair_order: a 16-byte A load a row gives two
k steps, and conv b's accumulator is the 1x1's A as it stands), and
the kernel's schedule in plain torch (csp_bf16_schedule below: the same
strips, bands, pitch-64 rings, lead rows and masks) against the twin.

The CPU's conv2d sums a pixel's products in an order that depends on the
shape of the call, so a schedule computed row by row is bit-equal to the
twin only where every f32 sum is exact. The exact cases make it so:
nonnegative integer activations and weights, power-of-two BN scales, BN
shifts in {0.5, 1, 1.5} (every value stays >= 0.5, a multiple of 2^-8,
every sum far below 2^24 of its unit). A shift >= 0.5 also makes
leaky(shift), what ConvBN_2 gives from zero input, nonzero: the masks are
what keeps it out of the SAME padding. The kernel itself is held to the
same exact cases on the card (tests/test_torch_cuda.py, which takes
exact_constants and exact_input from here: this module imports JAX only
inside the tests that build a detector).
"""

import numpy as np
import pytest
import torch

from grid_vision_tpu_torch.ops import bf16mma, cuda_build, cuda_csp
from grid_vision_tpu_torch.ops.cuda_csp import (LEAD_STEPS, LEFT, PITCH,
                                                STRIP_COLS, csp_bf16_plan,
                                                csp_bf16_unit, k_pair_order)

torch.set_num_threads(1)

BF = torch.bfloat16
SMS = 132                   # an H100 SXM's SMs


def exact_constants(seed):
    """bf16 constants whose every f32 sum in the stage is exact."""
    rng = np.random.default_rng(seed)
    convs = {}
    for key, (o, i, k, scale) in {"2": (64, 64, 3, 2.0 ** -10),
                                  "a": (32, 32, 3, 2.0 ** -9),
                                  "b": (32, 32, 3, 2.0 ** -9),
                                  "c": (64, 64, 1, 2.0 ** -7)}.items():
        w = torch.as_tensor(rng.integers(0, 3, (o, i, k, k))
                            .astype(np.float32))
        shift = torch.as_tensor(rng.choice([0.5, 1.0, 1.5], o)
                                .astype(np.float32))
        convs[key] = (w, torch.full((o,), scale), shift)
    return cuda_csp.pack_bf16_constants(convs)


def exact_input(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, 9, shape).astype(np.float32)).to(BF)


def csp_bf16_schedule(x, consts, sms=SMS):
    """The bf16 kernel's schedule in plain torch (CPU, f32 sums of the
    bf16 operands in matrix products): for each unit of csp_bf16_plan,
    input rows two at a time into a ring of 6 rows of PITCH positions
    (columns c0 - LEFT ..), y and x1 into rings of 4, each ring flat with a
    NaN guard position at either end (a tap left of position 0 or right of
    63 reads the neighbouring row or the guard: junk, kept from the stored
    positions by the masks); the two lead steps; y and x1 zero outside the
    frame and at positions 0 and 63; each product over K in k_pair_order
    (the x2 register path of the 1x1 included); the pool of positions LEFT
    .. LEFT + 51. Where every f32 sum is exact it equals the twin bit for
    bit, whatever the order of the sums."""
    b, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    out = torch.full((b, ho, wo, 128), float("nan"), dtype=torch.bfloat16)
    plan = csp_bf16_plan(b, h, w, sms)
    xf = x.float()
    mats = {k: consts[f"w{k}_oihw"].float().permute(2, 3, 1, 0).reshape(
        -1, consts[f"w{k}_oihw"].shape[0]) for k in ("2", "a", "b", "c")}
    orders = {k: k_pair_order(m.shape[0]) for k, m in mats.items()}

    def matmul(a, key):
        return a[:, orders[key]] @ mats[key][orders[key]]
    pos = torch.arange(PITCH)

    def ring(rows, ch):
        return torch.full((rows * PITCH + 2, ch), float("nan"))

    def taps(rg, slots, cin, c_lo=0):
        """The (64, 9 cin) A rows of output row r's positions from a flat
        ring: slots[dy] holds input row r - 1 + dy."""
        cols = [rg[1 + slots[dy] * PITCH + pos + dx - 1, c_lo:c_lo + cin]
                for dy in range(3) for dx in range(3)]
        return torch.cat(cols, dim=1)

    def bn(acc, key):
        v = acc * consts[f"s{key}"] + consts[f"b{key}"]
        return torch.nn.functional.leaky_relu(v, 0.1)

    def bf(v):
        return v.to(torch.bfloat16).float()

    seq = 0
    for u in range(plan.units):
        frame, strip, s0, s1 = csp_bf16_unit(plan, u, ho)
        c0 = STRIP_COLS * strip
        col = c0 - LEFT + pos
        col_in = (pos >= 1) & (pos <= PITCH - 2) & (col >= 0) & (col < w)
        xin, yr, x1r = ring(6, 64), ring(4, 64), ring(4, 32)
        steps = s1 - s0 + LEAD_STEPS

        def load_pair(i):
            slot = (seq + i) % 3
            for rr in range(2):
                r = 2 * s0 - 3 + 2 * i + rr
                row = torch.zeros((PITCH, 64))
                ok = (col >= 0) & (col < w)
                if 0 <= r < h:
                    row[ok] = xf[frame, r, col[ok]]
                at = 1 + (2 * slot + rr) * PITCH
                xin[at:at + PITCH] = row

        def in_slot(r):
            """The ring row of input row r."""
            i = (r - (2 * s0 - 3)) // 2
            return 2 * ((seq + i) % 3) + (r - (2 * s0 - 3)) % 2

        def store(rg, r, v, ch):
            v = torch.where(col_in[:, None] & (0 <= r < h), v, 0.0)
            at = 1 + (r % 4) * PITCH
            rg[at:at + PITCH, :ch] = bf(v)

        for i in range(3):
            load_pair(i)
        for st in range(steps):
            s = s0 - LEAD_STEPS + st
            for r in (2 * s + 2, 2 * s + 3):
                a = taps(xin, [in_slot(r - 1 + dy) for dy in range(3)], 64)
                store(yr, r, bn(matmul(a, "2"), "2"), 64)
            if st + 3 < steps + 1:
                load_pair(st + 3)
            if st >= 1:
                for r in (2 * s + 1, 2 * s + 2):
                    a = taps(yr, [(r - 1 + dy) % 4 for dy in range(3)], 32,
                             32)
                    store(x1r, r, bn(matmul(a, "a"), "a"), 32)
            if st < LEAD_STEPS:
                continue
            x3 = []
            for r in (2 * s, 2 * s + 1):
                a = taps(x1r, [(r - 1 + dy) % 4 for dy in range(3)], 32)
                x2 = bf(bn(matmul(a, "b"), "b"))
                at = 1 + (r % 4) * PITCH
                cat = torch.cat([x2, x1r[at:at + PITCH]], dim=1)
                x3.append(bf(bn(matmul(cat, "c"), "c")))
            ys = [yr[1 + (r % 4) * PITCH:1 + (r % 4 + 1) * PITCH]
                  for r in (2 * s, 2 * s + 1)]
            full = torch.maximum(torch.cat([ys[0], x3[0]], 1),
                                 torch.cat([ys[1], x3[1]], 1))
            pooled = torch.maximum(full[0::2], full[1::2])  # position pairs
            pcs = (c0 + 2 * torch.arange(PITCH // 2) - LEFT) // 2
            keep = (torch.arange(PITCH // 2) >= LEFT // 2) & (
                torch.arange(PITCH // 2) < (LEFT + STRIP_COLS) // 2) & (
                pcs < wo)
            out[frame, s, pcs[keep]] = pooled[keep].to(torch.bfloat16)
        seq += steps + 1
    return out


def _covered(batch, h, w, sms):
    """Times each pooled output is produced by the plan's units."""
    plan = cuda_csp.csp_bf16_plan(batch, h, w, sms)
    ho, wo = h // 2, w // 2
    hits = torch.zeros((batch, ho, wo), dtype=torch.int32)
    half = cuda_csp.STRIP_COLS // 2
    for u in range(plan.units):
        frame, strip, s0, s1 = cuda_csp.csp_bf16_unit(plan, u, ho)
        assert 0 <= frame < batch and 0 <= strip < plan.strips
        assert 0 <= s0 < s1 <= ho and s1 - s0 <= plan.rows
        hits[frame, s0:s1, strip * half:strip * half + half] += 1
    return plan, hits


@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("h,w", [(104, 104), (38, 38), (37, 53), (18, 22),
                                 (9, 120), (105, 31), (2, 2)])
def test_plan_covers_every_output_once(batch, h, w):
    plan, hits = _covered(batch, h, w, SMS)
    assert torch.equal(hits, torch.ones_like(hits))
    assert plan.strips == -(-(w // 2) // 26)
    assert plan.units == batch * plan.strips * plan.bands


@pytest.mark.parametrize("sms", [1, 3, 8, 132])
def test_plan_other_card_sizes_cover_once(sms):
    for batch, h, w in ((3, 22, 18), (1, 20, 120), (2, 9, 13)):
        _, hits = _covered(batch, h, w, sms)
        assert torch.equal(hits, torch.ones_like(hits))


def test_plan_at_the_ticks_shapes():
    # 64 frames: two strips a frame, one band, one round of 128 units on
    # 132 SMs; one frame: bands of one pooled row, 104 units
    assert cuda_csp.csp_bf16_plan(64, 104, 104, SMS) == (2, 1, 52, 128)
    assert cuda_csp.csp_bf16_plan(1, 104, 104, SMS) == (2, 52, 1, 104)
    # few frames are split into bands so that the units fill the card
    plan = cuda_csp.csp_bf16_plan(5, 104, 104, SMS)
    assert 100 <= plan.units <= SMS
    for empty in ((0, 104, 104), (1, 1, 104), (1, 104, 1)):
        assert cuda_csp.csp_bf16_plan(*empty, SMS).units == 0


def _acc_channel(n):
    """csrc/gv_hopper.cuh acc_channel: accumulator column n = 8j + 2t + e
    -> output channel 32 (j / 4) + 8t + 2 (j % 4) + e."""
    j, t, e = n // 8, (n % 8) // 2, n % 2
    return 32 * (j // 4) + 8 * t + 2 * (j % 4) + e


def _logical_k(p):
    """The mma k column p of a step -> the logical k of the A fragment."""
    t, e = (p % 8) // 2, p % 2
    return 4 * t + 2 * (p // 8) + e


def _wgmma_product(a, packed, n):
    """a (M, K) @ B as wgmma reads the packed buffer: per k step of 32 N
    bytes, B[p][c] at byte 256 (c / 8) + 128 (p / 8) + 16 (c % 8) + 2 (p %
    8), A[m][p] = a[m][16 s + logical(p)], column c stored as channel
    acc_channel(c)."""
    flat = packed.reshape(-1).double()
    m, k = a.shape
    d = torch.zeros((m, n), dtype=torch.float64)
    p = torch.arange(16)
    c = torch.arange(n)
    logical = torch.tensor([_logical_k(int(q)) for q in p])
    for s in range(k // 16):
        idx = (16 * n * s + 128 * (c[None, :] // 8) + 64 * (p[:, None] // 8)
               + 8 * (c[None, :] % 8) + p[:, None] % 8)
        d += a[:, 16 * s + logical].double() @ flat[idx]
    out = torch.empty_like(d)
    out[:, [_acc_channel(int(q)) for q in c]] = d
    return out


@pytest.mark.parametrize("k,n", [(16, 32), (288, 32), (64, 64), (576, 64),
                                 (96, 96)])
def test_wgmma_b_round_trip_and_product(k, n):
    rng = np.random.default_rng(k + n)
    w = torch.as_tensor(rng.normal(0, 1, (k, n)).astype(np.float32))
    packed = bf16mma.pack_wgmma_b(w)
    assert packed.shape == (k // 16, n // 8, 2, 8, 8) and packed.dtype == BF
    assert packed.numel() * 2 == k * n * 2          # 32 N bytes a k step
    assert torch.equal(bf16mma.unpack_wgmma_b(packed), w.to(BF))
    a = torch.as_tensor(rng.normal(0, 1, (64, k)).astype(np.float32)).to(BF)
    torch.testing.assert_close(_wgmma_product(a, packed, n),
                               a.double() @ w.to(BF).double(), rtol=1e-12,
                               atol=1e-12)


def test_wgmma_b_rejects_other_widths():
    for shape in ((32, 48), (32, 128), (40, 32)):
        with pytest.raises(ValueError, match="N 32, 64 or 96"):
            bf16mma.pack_wgmma_b(torch.zeros(shape))


def test_k_pair_order_pairs_a_threads_channels():
    """Thread t's A values of steps 2m, 2m + 1 (logical k 4t .. 4t + 3 of
    each) are K rows 32m + 8t .. 32m + 8t + 7, in order: the 16-byte piece
    the kernel loads."""
    order = cuda_csp.k_pair_order(576)
    assert sorted(order.tolist()) == list(range(576))
    for m in (0, 5, 17):
        for t in range(4):
            rows = [int(order[32 * m + 16 * ks + 4 * t + j])
                    for ks in range(2) for j in range(4)]
            assert rows == list(range(32 * m + 8 * t, 32 * m + 8 * t + 8))
    assert cuda_csp.k_pair_order(32)[:8].tolist() == [0, 1, 2, 3, 8, 9, 10,
                                                      11]


def test_row_taps_carry_gives_the_conv():
    """CSPBlock_0's 3x3 convs as the kernel runs them: each input row rho
    times row_taps_matrix (its three dy taps), output row r the sum of the
    dy = 0 block of row r - 1, dy = 1 of row r and dy = 2 of row r + 1 (two
    of them carried from the step before), equals F.conv2d."""
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.normal(0, 1, (32, 32, 3, 3)).astype(np.float64))
    x = torch.as_tensor(rng.normal(0, 1, (1, 32, 6, 9)).astype(np.float64))
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))[0]      # (32, 8, 11)
    m = cuda_csp.row_taps_matrix(w)                        # (96, 96)
    # A of row rho: (positions, (dx, c)); its (positions, (dy, c_out))
    part = [torch.stack([xp[:, rho, p:p + 3].T.reshape(-1)
                         for p in range(9)]) @ m for rho in range(8)]
    got = torch.stack([part[r][:, :32] + part[r + 1][:, 32:64]
                       + part[r + 2][:, 64:] for r in range(6)])
    want = torch.nn.functional.conv2d(x, w, padding=1)[0].permute(1, 2, 0)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_x2_feeds_the_1x1_from_conv_b_accumulator():
    """The thread's conv b accumulator (m64n32k16: d[4j + e], row g for e <
    2, channel acc_channel(j, t, e & 1)) rounded and packed as the 1x1's A
    fragments (a0 = d[8ks], d[8ks + 1]; a1 = d[8ks + 2], d[8ks + 3]; a2 =
    d[8ks + 4], d[8ks + 5]; a3 = d[8ks + 6], d[8ks + 7]) times B with its
    rows in k_pair_order is x2 @ wc."""
    rng = np.random.default_rng(0)
    x2 = torch.as_tensor(rng.normal(0, 1, (16, 32)).astype(np.float32))
    wc = torch.as_tensor(rng.normal(0, 1, (32, 64)).astype(np.float32))
    b = wc[cuda_csp.k_pair_order(32)]
    got = torch.zeros((16, 64), dtype=torch.float64)
    for g in range(8):
        for t in range(4):
            # the thread's accumulator values: row g + 8 (e >> 1), column
            # 8j + 2t + (e & 1) = channel 8t + 2j + (e & 1)
            d = [x2[g + 8 * ((i & 3) >> 1), 8 * t + 2 * (i >> 2) + (i & 1)]
                 for i in range(16)]
            for ks in range(2):
                # A rows g (a0, a2) and g + 8 (a1, a3); a0 / a1 logical k
                # 4t, 4t + 1, a2 / a3 logical k 4t + 2, 4t + 3
                for hr, (lo, hi) in enumerate(((0, 4), (2, 6))):
                    vals = [d[8 * ks + lo], d[8 * ks + lo + 1],
                            d[8 * ks + hi], d[8 * ks + hi + 1]]
                    for j, v in enumerate(vals):
                        got[g + 8 * hr] += float(v) * b[16 * ks + 4 * t + j
                                                        ].double()
    torch.testing.assert_close(got, x2.double() @ wc.double(), rtol=1e-12,
                               atol=1e-12)


def test_bf16_constants_layout():
    from .test_torch_csp import _detector
    _, det = _detector(0)
    consts = cuda_csp.prepare_csp_constants(det, BF)
    cuda_build.check_constants(consts, cuda_csp._SHAPES_BF16,
                               torch.device("cpu"), "CSP")
    for key in ("2", "a", "b", "c"):
        w = consts[f"w{key}_oihw"]
        o, i, kh, kw = w.shape
        wmat = (cuda_csp.row_taps_matrix(w) if key in ("a", "b")
                else w.permute(2, 3, 1, 0).reshape(kh * kw * i, o))
        assert torch.equal(bf16mma.unpack_wgmma_b(consts[f"w{key}"]),
                           wmat[cuda_csp.k_pair_order(wmat.shape[0])])


@pytest.mark.parametrize("batch,h,w,sms", [
    (2, 38, 38, SMS), (1, 104, 104, SMS), (1, 18, 22, SMS), (2, 9, 13, 3),
    (3, 22, 18, 4), (1, 20, 120, 5), (2, 37, 53, 2), (1, 5, 7, SMS)])
def test_schedule_bit_equal_to_twin_on_exact_data(batch, h, w, sms):
    """The kernel's schedule (strips, bands and their lead rows, the rings'
    flat pitch with NaN guards, the masks) equals the twin bit for bit
    where every sum is exact: at the tests' shapes, the tick's frame at
    one frame (bands of one row), odd and non-square sizes, and few SMs
    (bands of several rows)."""
    consts = exact_constants(batch + h + w)
    x = exact_input((batch, h, w, 64), h * w)
    got = csp_bf16_schedule(x, consts, sms)
    ref = cuda_csp._csp_plain_bf16(x, consts)
    assert got.shape == (batch, h // 2, w // 2, 128)
    assert torch.equal(got, ref)


def test_exact_data_reaches_every_branch():
    """The exact case is not trivial: leaky(shift) of ConvBN_2 is nonzero,
    so dropping the masks (y and x1 at the frame's edge) would change the
    output, and every output channel varies over the frame."""
    consts = exact_constants(3)
    x = exact_input((1, 18, 22, 64), 5)
    ref = cuda_csp._csp_plain_bf16(x, consts)
    assert (consts["b2"] > 0).all()
    unmasked = torch.nn.functional.leaky_relu(
        torch.nn.functional.conv2d(
            torch.nn.functional.pad(x.permute(0, 3, 1, 2).float(),
                                    (1, 1, 1, 1)),
            consts["w2_oihw"].float()) * consts["s2"][:, None, None]
        + consts["b2"][:, None, None], 0.1)
    assert unmasked[:, :, 0].min() > 0          # what the padding must not be
    assert (ref.float().flatten(0, 2).std(dim=0) > 0).all()


def test_schedule_matches_twin_on_random_weights():
    """With the detector's random weights and BN (negative values, leaky's
    both branches) the schedule's sums run in another order than the
    twin's: the JAX package's bf16 bar and >= 99 % bit-equal."""
    from .test_torch_csp import _detector
    _, det = _detector(4)
    consts = cuda_csp.prepare_csp_constants(det, BF)
    x = torch.as_tensor(np.random.default_rng(4).normal(
        0, 1, (2, 22, 30, 64)).astype(np.float32)).to(BF)
    with torch.no_grad():
        got = csp_bf16_schedule(x, consts, SMS)
        ref = cuda_csp.detector_csp_cuda(x, det, consts)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0.06,
                               atol=0.06)
    assert (got == ref).float().mean().item() >= 0.99
