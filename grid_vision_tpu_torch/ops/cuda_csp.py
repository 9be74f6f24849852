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
torch.bfloat16)``, a bf16 activation in and out) rounds where the Pallas
kernel rounds at compute_dtype=bf16: bf16 weights without the BN scale,
f32 sums, BN (x * s + b) and leaky in f32, every conv's output (the
kernel's scratch) rounded to bf16; its twin computes the same with F.conv2d
on the bf16-rounded operands.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

import torch.nn.functional as F

from ..models.layers import fold_bn
from . import bf16mma, cuda_build, tf32x3

# Kernel calls made by detector_csp_cuda (one per call; a call is four
# launches of csrc/cuda_csp.cu), of the f32 form and of the bf16 form.
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
    """The bf16 form's constants: each conv's (k * k * C_in, C_out) matrix
    in (ty, tx, c) row order without the BN scale, packed by
    bf16mma.pack_b_fragments (w2 (36, 8, 32, 4), wa / wb (18, 4, 32, 4), wc
    (4, 8, 32, 4)), its BN scale s* and shift b*, a bf16 OIHW copy w*_oihw
    for the twin; dtype."""
    out = dict(dtype=torch.bfloat16)
    with torch.no_grad():
        for key, path, _ in _CONVS:
            conv_bn = _conv_bn(detector, path)
            w = conv_bn.Conv_0.weight.detach()
            o, i, kh, kw = w.shape
            scale, shift = fold_bn(conv_bn.BatchNorm_0)
            out[f"w{key}"] = bf16mma.pack_b_fragments(
                w.permute(2, 3, 1, 0).reshape(kh * kw * i, o))
            out[f"s{key}"] = scale.contiguous()
            out[f"b{key}"] = shift.contiguous()
            out[f"w{key}_oihw"] = w.to(torch.bfloat16).contiguous()
    return out


_SHAPES = dict(w2=(72, 8, 32, 4), b2=(64,), wa=(36, 4, 32, 4), ba=(32,),
               wb=(36, 4, 32, 4), bb=(32,), wc=(8, 8, 32, 4), bc=(64,))
_BF, _F32 = torch.bfloat16, torch.float32
_SHAPES_BF16 = dict(
    w2=((36, 8, 32, 4), _BF), s2=((64,), _F32), b2=((64,), _F32),
    wa=((18, 4, 32, 4), _BF), sa=((32,), _F32), ba=((32,), _F32),
    wb=((18, 4, 32, 4), _BF), sb=((32,), _F32), bb=((32,), _F32),
    wc=((4, 8, 32, 4), _BF), sc=((64,), _F32), bc=((64,), _F32))


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
    y = torch.empty_like(x)
    xcat = torch.empty_like(x)
    out = torch.empty((b, h // 2, w // 2, 128), dtype=dt, device=dev)
    lib = cuda_build.load("cuda_csp")
    fn = lib.gv_detector_csp if dt == torch.float32 else \
        lib.gv_detector_csp_bf16
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, I, I, I] + [P] * len(shapes) + [P, P, P, P]
    stream = torch.cuda.current_stream(dev).cuda_stream
    cuda_build.check(
        fn(x.data_ptr(), b, h, w,
           *(consts[k].data_ptr() for k in shapes),
           y.data_ptr(), xcat.data_ptr(), out.data_ptr(), stream),
        "gv_detector_csp" if dt == torch.float32 else "gv_detector_csp_bf16")
    if dt == torch.float32:
        launches += 1
    else:
        launches_bf16 += 1
    return out


def mma_product_bf16_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) on the card through the bf16 forms' tile product
    (bf16 operands, f32 sums), one warp per 16 x 8 tile: the check of the
    bf16 fragment layout and of bf16mma.pack_b_fragments against
    bf16mma.matmul_bf16 (no path calls it). M % 16 == N % 16 == K % 16 ==
    0; the result is f32."""
    if (a.device.type != "cuda" or b.device != a.device or a.dim() != 2
            or b.dim() != 2 or a.shape[1] != b.shape[0] or a.shape[0] % 16):
        raise ValueError("a (M, K) and b (K, N) must be CUDA matrices, "
                         "M % 16 == 0")
    a16 = a.to(torch.bfloat16).contiguous()
    bfrag = bf16mma.pack_b_fragments(b)
    c = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32,
                    device=a.device)
    fn = cuda_build.load("cuda_csp").gv_mma_product_bf16
    fn.restype = ctypes.c_int
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, I, I, I, P]
    cuda_build.check(
        fn(a16.data_ptr(), bfrag.data_ptr(), c.data_ptr(), a.shape[0],
           b.shape[1], a.shape[1],
           torch.cuda.current_stream(a.device).cuda_stream),
        "gv_mma_product_bf16")
    return c


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
