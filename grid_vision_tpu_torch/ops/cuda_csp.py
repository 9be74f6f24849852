"""The detector's first CSP stage: the ``detector_stem_backend="pallas2"``
and ``"pallas3"`` paths (both run this one kernel).

Counterpart of grid_vision_tpu/ops/pallas_csp.py (detector_csp_pallas and
detector_csp_flat, two TPU layouts of one function): the (B, S/4, S/4, 64)
stem activation -> ConvBN_2 -> CSPBlock_0 -> 2x2/s2 max pool -> the
(B, S/8, S/8, 128) NHWC activation that YoloV4Tiny takes with
front_external=True. On a CUDA tensor ``detector_csp_cuda`` launches the
hand-written kernels of ``csrc/cuda_csp.cu`` (its note says what bounds
them and how: the convs run on the tensor cores in 3xTF32, from weights
split and packed here once per model); on a CPU tensor it runs
``detector_csp_plain``, the detector module's own ConvBN_2 -> CSPBlock_0 ->
max_pool2d.

The bf16 form (constants from ``prepare_csp_constants(detector,
torch.bfloat16)``, a bf16 activation in and out) is one launch of
``csrc/cuda_csp_bf16.cu`` (its note gives the design: strips of a frame
walked row by row through rings of rows in shared memory, every conv on
wgmma). It rounds where the Pallas kernel rounds at compute_dtype=bf16:
bf16 weights without the BN scale, f32 sums, BN (x * s + b) and leaky in
f32, every conv's output rounded to bf16; its twin computes the same with
F.conv2d on the bf16-rounded operands. ``csp_bf16_plan`` mirrors the
kernel's plan (strips, bands); tests/test_torch_csp_bf16.py holds a model
of the kernel's schedule in plain torch to the twin.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

import torch.nn.functional as F

from ..models.layers import fold_bn
from . import bf16mma, cuda_build, tf32x3

# Kernel calls made by detector_csp_cuda, one per call: of the f32 form (a
# call is four launches of csrc/cuda_csp.cu) and of the bf16 form (one
# launch of csrc/cuda_csp_bf16.cu).
launches = 0
launches_bf16 = 0

# the convs of the stage: (key, module path, kernel size)
_CONVS = (("2", ("ConvBN_2",), 3), ("a", ("CSPBlock_0", "ConvBN_0"), 3),
          ("b", ("CSPBlock_0", "ConvBN_1"), 3),
          ("c", ("CSPBlock_0", "ConvBN_2"), 1))


def _conv_bn(detector, path):
    m = detector
    for name in path:
        m = getattr(m, name)
    return m


def prepare_csp_constants(detector, dtype=torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """Fold ConvBN_2 and CSPBlock_0 of a YoloV4Tiny once (Engine init), on
    the detector's device, for the kernels' f32 form or (dtype=
    torch.bfloat16) their bf16 form (_bf16_constants). f32: each conv's
    (k * k * C_in, C_out) matrix in
    (ty, tx, c) row order, BN scale folded in, split into TF32 hi and lo
    and packed in mma fragment order (tf32x3.pack_b_fragments): w2
    (72, 8, 32, 4), wa / wb (36, 4, 32, 4), wc (8, 8, 32, 4); and each
    conv's BN shift b2, ba, bb, bc."""
    if dtype == torch.bfloat16:
        return _bf16_constants(detector)
    with torch.no_grad():
        csp = detector.CSPBlock_0
        out = {}
        for key, conv_bn in (("2", detector.ConvBN_2), ("a", csp.ConvBN_0),
                             ("b", csp.ConvBN_1), ("c", csp.ConvBN_2)):
            wmat, shift = tf32x3.folded_matrix(conv_bn)
            out[f"w{key}"] = tf32x3.pack_b_fragments(wmat)
            out[f"b{key}"] = shift.contiguous()
        return out


def _bf16_constants(detector) -> Dict[str, torch.Tensor]:
    """The bf16 form's constants from the detector's convs and BNs
    (pack_bf16_constants)."""
    convs = {}
    with torch.no_grad():
        for key, path, _ in _CONVS:
            conv_bn = _conv_bn(detector, path)
            scale, shift = fold_bn(conv_bn.BatchNorm_0)
            convs[key] = (conv_bn.Conv_0.weight.detach(), scale, shift)
    return pack_bf16_constants(convs)


def k_pair_order(k: int) -> torch.Tensor:
    """(k,) for K a multiple of 32: B row 32m + 16ks + 4t + j holds K row
    32m + 8t + 4ks + j. The wgmma A fragment gives thread t logical k 4t ..
    4t + 3 of a step; with B's rows so, thread t's A values of steps 2m and
    2m + 1 are channels 8t .. 8t + 7 of block m, one 16-byte load from a
    ring, and the conv b accumulator's channels 8t .. 8t + 7 are, as they
    stand, the 1x1's A fragments (x2 feeds it from registers)."""
    i = torch.arange(k)
    m, ks, t, j = i // 32, (i % 32) // 16, (i % 16) // 4, i % 4
    return 32 * m + 8 * t + 4 * ks + j


def row_taps_matrix(w: torch.Tensor) -> torch.Tensor:
    """A 3x3 conv's OIHW weight (C_out, C_in, 3, 3) as the (3 C_in, 3 C_out)
    matrix that takes one input row against all three of its dy taps: row
    (dx, c), column (dy, c_out). Input row rho times it gives the
    contributions of rho to output rows rho + 1 (dy = 0), rho, rho - 1."""
    o, i, kh, kw = w.shape
    return w.permute(3, 1, 2, 0).reshape(kw * i, kh * o)


def pack_bf16_constants(convs) -> Dict[str, torch.Tensor]:
    """convs: {key: (OIHW weight, BN scale, BN shift)} for keys 2, a, b, c
    -> the bf16 form's constants: ConvBN_2's and the 1x1's (k * k * C_in,
    C_out) matrix in (ty, tx, c) row order, CSPBlock_0's two 3x3 convs'
    row_taps_matrix, each without the BN scale, its rows in k_pair_order,
    packed by bf16mma.pack_wgmma_b (w2 (36, 8, 2, 8, 8), wa / wb (6, 12, 2,
    8, 8), wc (4, 8, 2, 8, 8)); each conv's BN scale s* and shift b* (f32)
    and a bf16 OIHW copy w*_oihw for the twin; dtype."""
    out = dict(dtype=torch.bfloat16)
    for key, _, _ in _CONVS:
        w, scale, shift = convs[key]
        o, i, kh, kw = w.shape
        wmat = (row_taps_matrix(w) if key in ("a", "b")
                else w.permute(2, 3, 1, 0).reshape(kh * kw * i, o))
        out[f"w{key}"] = bf16mma.pack_wgmma_b(
            wmat[k_pair_order(wmat.shape[0]).to(wmat.device)])
        out[f"s{key}"] = scale.float().contiguous()
        out[f"b{key}"] = shift.float().contiguous()
        out[f"w{key}_oihw"] = w.to(torch.bfloat16).contiguous()
    return out


_SHAPES = dict(w2=(72, 8, 32, 4), b2=(64,), wa=(36, 4, 32, 4), ba=(32,),
               wb=(36, 4, 32, 4), bb=(32,), wc=(8, 8, 32, 4), bc=(64,))
_BF, _F32 = torch.bfloat16, torch.float32
_SHAPES_BF16 = dict(
    w2=((36, 8, 2, 8, 8), _BF), s2=((64,), _F32), b2=((64,), _F32),
    wa=((6, 12, 2, 8, 8), _BF), sa=((32,), _F32), ba=((32,), _F32),
    wb=((6, 12, 2, 8, 8), _BF), sb=((32,), _F32), bb=((32,), _F32),
    wc=((4, 8, 2, 8, 8), _BF), sc=((64,), _F32), bc=((64,), _F32))


def _csp_plain_bf16(x: torch.Tensor, consts) -> torch.Tensor:
    def conv(inp, key, pad):
        y = F.conv2d(inp.float(), consts[f"w{key}_oihw"].float(),
                     padding=pad)
        s, b = consts[f"s{key}"], consts[f"b{key}"]
        return F.leaky_relu(y * s[None, :, None, None]
                            + b[None, :, None, None], 0.1).to(torch.bfloat16)

    y = conv(x.permute(0, 3, 1, 2), "2", 1)
    x1 = conv(y[:, 32:], "a", 1)
    x2 = conv(x1, "b", 1)
    x3 = conv(torch.cat([x2, x1], 1), "c", 0)
    out = F.max_pool2d(torch.cat([y, x3], 1), 2, 2)
    return out.permute(0, 2, 3, 1).contiguous()


def detector_csp_plain(x: torch.Tensor, detector, consts=None
                       ) -> torch.Tensor:
    """The kernel's plain twin, NHWC in and out: f32, the module's
    ConvBN_2 -> CSPBlock_0 -> max_pool2d; bf16 (bf16 consts), the same
    convs from the bf16 weights in consts, rounded where the kernel
    rounds."""
    if consts is not None and \
            cuda_build.consts_dtype(consts) == torch.bfloat16:
        return _csp_plain_bf16(x, consts)
    return detector.front(x.permute(0, 3, 1, 2)).permute(0, 2, 3,
                                                          1).contiguous()


# The bf16 kernel's plan (csrc/cuda_csp_bf16.cu make_plan): a strip is 52
# input columns (26 pooled), a band's first two steps are lead steps.
STRIP_COLS = 52
LEAD_STEPS = 2
PITCH = 64              # positions a ring row
LEFT = 4                # position of a strip's first column


class CspPlan(NamedTuple):
    strips: int
    bands: int
    rows: int
    units: int


def csp_bf16_plan(batch: int, h: int, w: int, sms: int) -> CspPlan:
    """The bf16 kernel's plan for (batch, h, w) on a card of `sms` SMs:
    strips of 52 columns a frame, bands of `rows` pooled rows a strip (the
    last fewer), units = batch x strips x bands; the bands minimise the
    rounds of units over the SMs times a unit's steps (rows + 2 lead
    steps + 1 of start). All zero where the output is empty."""
    ho, wo = h // 2, w // 2
    plan = CspPlan(0, 0, 0, 0)
    if batch <= 0 or ho <= 0 or wo <= 0 or sms <= 0:
        return plan
    strips = -(-wo // (STRIP_COLS // 2))
    best = None
    for b in range(1, ho + 1):
        rows = -(-ho // b)
        if -(-ho // rows) != b:
            continue
        units = batch * strips * b
        cost = -(-units // sms) * (rows + LEAD_STEPS + 1)
        if units <= 1 << 30 and (best is None or cost < best):
            best, plan = cost, CspPlan(strips, b, rows, units)
    return plan


def csp_bf16_unit(plan: CspPlan, u: int, ho: int):
    """Unit u of a plan as the kernel decodes it: (frame, strip, first and
    end pooled row)."""
    band, rest = u % plan.bands, u // plan.bands
    s0 = band * plan.rows
    return rest // plan.strips, rest % plan.strips, s0, min(s0 + plan.rows,
                                                            ho)


@functools.lru_cache(maxsize=None)
def _entry_bf16():
    fn = cuda_build.load("cuda_csp_bf16").gv_detector_csp_bf16
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I] + [P] * len(_SHAPES_BF16) + [P, P]
    return fn


def _launch(x: torch.Tensor, consts) -> torch.Tensor:
    global launches, launches_bf16
    dev = x.device
    dt = cuda_build.consts_dtype(consts)
    if (x.dtype != dt or x.dim() != 4 or x.shape[-1] != 64
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous (B, H, W, 64) {dt} tensor "
                         "(the form of the constants)")
    shapes = _SHAPES if dt == torch.float32 else _SHAPES_BF16
    cuda_build.check_constants(consts, shapes, dev, "CSP")
    b, h, w, _ = x.shape
    out = torch.empty((b, h // 2, w // 2, 128), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        if x.data_ptr() % 16 or any(consts[k].data_ptr() % 16
                                    for k in _SHAPES_BF16):
            raise ValueError("the bf16 activation and constants must start "
                             "at a 16-byte boundary (the kernel copies them "
                             "by the copy engine)")
        cuda_build.check(
            _entry_bf16()(x.data_ptr(), b, h, w,
                          *(consts[k].data_ptr() for k in _SHAPES_BF16),
                          out.data_ptr(), stream), "gv_detector_csp_bf16")
        launches_bf16 += 1
        return out
    y = torch.empty_like(x)
    xcat = torch.empty_like(x)
    fn = cuda_build.load("cuda_csp").gv_detector_csp
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I] + [P] * len(shapes) + [P, P, P, P]
    cuda_build.check(
        fn(x.data_ptr(), b, h, w,
           *(consts[k].data_ptr() for k in shapes),
           y.data_ptr(), xcat.data_ptr(), out.data_ptr(), stream),
        "gv_detector_csp")
    launches += 1
    return out


def bf16_plan_on_card(batch: int, h: int, w: int, dev=None):
    """The bf16 kernel's own plan on the card (gv_csp_bf16_plan): (strips,
    bands, rows, units, dynamic shared memory, blocks resident an SM), at
    the current device's SM count."""
    sms = torch.cuda.get_device_properties(
        dev or torch.cuda.current_device()).multi_processor_count
    fn = cuda_build.load("cuda_csp_bf16").gv_csp_bf16_plan
    fn.restype = ctypes.c_int
    I = ctypes.c_int
    fn.argtypes = [I, I, I, I, ctypes.c_void_p]
    plan = (ctypes.c_int * 6)()
    cuda_build.check(fn(batch, h, w, sms, ctypes.addressof(plan)),
                     "gv_csp_bf16_plan")
    return sms, tuple(plan)


CLOCK_PHASES = ("unit_start", "input_wait", "y_products", "y_epilogue",
                "barrier_1", "x1_products", "x1_epilogue", "barrier_2",
                "y_pool_x2", "conv_1x1", "x3_pool_store")


def csp_bf16_clocks(lib, call, calls: int = 5):
    """Cycles by phase of the bf16 kernel built with -DGV_CSP_CLOCKS (lib,
    whose wrapper `call` runs): thread 0's view a block, barrier to
    barrier, summed over `calls` calls; per step and per unit."""
    fn = lib.gv_csp_bf16_clocks
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 13)()
    cuda_build.check(fn(ctypes.addressof(buf)), "gv_csp_bf16_clocks")
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    cuda_build.check(fn(ctypes.addressof(buf)), "gv_csp_bf16_clocks")
    steps, units = max(buf[11], 1), max(buf[12], 1)
    return dict(units_per_call=buf[12] / calls, steps_per_unit=steps / units,
                cycles_per_step={p: buf[i] / steps
                                 for i, p in enumerate(CLOCK_PHASES)},
                cycles_per_unit=sum(buf[i] for i in range(11)) / units)


def mma_product_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) on the card through the kernels' 3xTF32 tile
    product, one warp per 16 x 8 tile (the check of gv_mma.cuh's fragment
    layout and of tf32x3.pack_b_fragments against a library product; no
    path calls it). M % 16 == N % 16 == K % 8 == 0."""
    if (a.device.type != "cuda" or b.device != a.device
            or a.dtype != torch.float32 or b.dtype != torch.float32
            or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]
            or a.shape[0] % 16 or not a.is_contiguous()):
        raise ValueError("a (M, K) and b (K, N) must be float32 CUDA "
                         "matrices, a contiguous, M % 16 == 0")
    bfrag = tf32x3.pack_b_fragments(b)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    fn = cuda_build.load("cuda_csp").gv_mma_product
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, P]
    cuda_build.check(
        fn(a.data_ptr(), bfrag.data_ptr(), c.data_ptr(), a.shape[0],
           b.shape[1], a.shape[1],
           torch.cuda.current_stream(a.device).cuda_stream),
        "gv_mma_product")
    return c


def detector_csp_cuda(x: torch.Tensor, detector, consts) -> torch.Tensor:
    """(B, H, W, 64) stem activation -> (B, H/2, W/2, 128): the kernels on
    a CUDA tensor (consts: prepare_csp_constants on its device), the plain
    twin for a CPU tensor. The form of consts (f32 or bf16) is the
    activations' dtype; x of another dtype raises."""
    if x.device.type == "cpu":
        dt = cuda_build.consts_dtype(consts)
        if x.dtype != dt:
            raise ValueError(f"x must be {dt}, the form of the constants")
        return detector_csp_plain(x, detector, consts)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, consts)
