"""The int8 detector's conv: an s8 implicit-GEMM kernel with the requant
fused into its epilogue, and the same kernel as a plain GEMM.

Counterpart of tools/bench_int8_mxu.py's build_matmul (the whole-K and the
K-blocked Pallas kernels, s8 x s8 -> s32 and bf16 x bf16 -> f32 on
detector-shaped GEMMs), which gated a fused int8 detector: on a CUDA
tensor every function here launches the hand-written kernel of
``csrc/cuda_int8.cu`` (its note says what bounds it and how: the taps
gathered into shared memory, mma.sync, the requant in the epilogue); on a
CPU tensor it runs its plain version.

- ``int8_conv(xq, layer, stride)``: (B, H, W, Cin) int8 -> (B, Ho, Wo,
  Cout) int32 accumulators of the layer's SAME conv (flax padding; a
  layer of yolov4_int8: OIHW ``wq`` and its (Cout, Kp) GEMM matrix ``wt``,
  k in (ty, tx, c) order). Plain: ``int8_conv_plain``, float64 F.conv2d,
  exact.
- ``int8_conv_requant(xq, sx, layer, stride)``: the f32 outputs
  leaky_0.1(acc * (sx * sw) + b) of ``requant`` bit for bit, from the
  accumulators in registers; sx per sample (B, 1, 1, 1), or one scale
  (the static-scale forward's 0-d scale, expanded here). Plain:
  ``int8_conv_requant_plain``.
- ``int8_matmul(a, b)`` / ``bf16_matmul(a, b)``: (M, K) x (K, N) ->
  int32 / f32, the tool's two products: the kernel's 1x1, stride-1 form
  over a (1, M, 1, K) view. b's column-major form (b.t() contiguous, the
  conv's weight layout) is used as it is; any other b is copied into it.

``launches`` counts kernel launches (one a call on a CUDA tensor).
``tile_n`` is the rule by which the wrapper picks the kernel's tile width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import same_pad
from . import cuda_build

# Kernel launches made by this module's functions (one per call on a CUDA
# tensor).
launches = 0

# csrc/cuda_int8.cu: 128 output rows a block; its N tile 128, 64 or 32
# (bf16: 64 or 32).
TILE_M = 128
TILE_N = (128, 64, 32)
# tile_n takes 128 columns only for a K this long or longer (a shorter K
# ran faster at 64 on an H100: PERF.md §6), and narrows the tile while
# the blocks would not give each of the card's 132 SMs one
LONG_K = 2048
MIN_BLOCKS = 132


def out_size(n: int, stride: int) -> int:
    return -(-n // stride)


def tile_n(m: int, n: int, k: int, widest: int = TILE_N[0]) -> int:
    """The kernel's N tile for an (m, n) output over K = k: the widest of
    TILE_N not above n, `widest`, or 64 when k < LONG_K (32 below),
    halved while the blocks would not reach MIN_BLOCKS."""
    if k < LONG_K:
        widest = min(widest, TILE_N[1])
    bn = next((t for t in TILE_N if t <= min(n, widest)), TILE_N[-1])
    while bn > TILE_N[-1] and (-(-m // TILE_M)) * (-(-n // bn)) < MIN_BLOCKS:
        bn //= 2
    return bn


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor,
                    stride: int) -> torch.Tensor:
    """The int8 conv's plain version: (B, H, W, Cin) int8 with OIHW int8
    weights, SAME as flax pads -> (B, Ho, Wo, Cout) int32, computed in
    float64 F.conv2d (exact: every sum is an integer below 2^53)."""
    k = wq.shape[-1]
    py = same_pad(xq.shape[1], k, stride)
    px = same_pad(xq.shape[2], k, stride)
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (px[0], px[1], py[0], py[1]))
    y = F.conv2d(x, wq.double(), stride=stride)
    return y.permute(0, 2, 3, 1).to(torch.int32)


def requant(acc: torch.Tensor, sx: torch.Tensor,
            layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    """int32 accumulator -> leaky_0.1(acc.f32 * (sx * sw) + b), the
    multiply-add rounded once (jitted XLA fuses it)."""
    scale = (sx * layer["sw"]).double()
    y = acc.float().double() * scale + layer["b"].double()
    return F.leaky_relu(y.float(), 0.1)


def int8_conv_requant_plain(xq: torch.Tensor, sx: torch.Tensor,
                            layer: Dict[str, torch.Tensor],
                            stride: int) -> torch.Tensor:
    """int8_conv_requant's plain version: requant(int8_conv_plain(...))."""
    return requant(int8_conv_plain(xq, layer["wq"], stride), sx, layer)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, in float64 (exact below
    2^53, i.e. K < 5e11; torch has no int64 matmul on the card)."""
    return (a.double() @ b.double()).to(torch.int32)


def bf16_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (K, N) bf16 -> (M, N) f32: float64 sums of the bf16
    values, rounded once."""
    return (a.double() @ b.double()).float()


def f32_sum_bound(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) bound on the error of an f32 sum of a @ b's exact products:
    K u (|a| @ |b|), u = 2^-24, the first-order bound of any order of K
    round-to-nearest f32 additions. It covers bf16_matmul's roundings (2
    K / 16: a k-16 step's truncating sum on the tensor core counts 2 u, its
    addition to the running sum u). Its bar at K = 2304, where unit-normal
    sums of f32 roundings alone pass 1e-4."""
    return (a.double().abs() @ b.double().abs()) * (a.shape[1] * 2.0 ** -24)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_int8").gv_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p] * 5
    return fn


def _launch(x: torch.Tensor, wt: torch.Tensor, k: int, stride: int,
            requant_by: Optional[Tuple[torch.Tensor, ...]] = None
            ) -> torch.Tensor:
    """The kernel on x (B, H, W, C) and wt (N, Kp), both int8 or both
    bf16: the (B, Ho, Wo, N) accumulators (int32; f32 in bf16), or with
    requant_by = (sx (B,), sw (N,), bias (N,)) the requantized f32."""
    global launches
    dev = x.device
    if x.dtype not in (torch.int8, torch.bfloat16) or x.dim() != 4:
        raise ValueError("x must be a (B, H, W, C) int8 or bf16 tensor")
    if wt.dtype != x.dtype or wt.dim() != 2 or wt.device != dev:
        raise ValueError("wt must be an (N, Kp) tensor of x's dtype on its "
                         "device")
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("x and wt must be contiguous")
    b, h, w, c = x.shape
    n, kp = wt.shape
    size = x.element_size()
    if k < 1 or stride < 1 or k * k * c > kp or kp * size % 16:
        raise ValueError(f"wt ({n}, {kp}) does not hold a {k}x{k} conv of "
                         f"{c} channels padded to 16 bytes")
    if wt.data_ptr() % 16:
        raise ValueError("wt must be 16-byte aligned")
    if x.dtype == torch.bfloat16 and (c * size % 16 or x.data_ptr() % 16):
        raise ValueError("a bf16 x needs C a multiple of 8, 16-byte aligned")
    if x.numel() >= 2 ** 31:
        raise ValueError("x has 2^31 elements or more")
    ho, wo = out_size(h, stride), out_size(w, stride)
    py, px = same_pad(h, k, stride), same_pad(w, k, stride)
    sx = sw = bias = None
    if requant_by is not None:
        if x.dtype != torch.int8:
            raise ValueError("the requant epilogue is int8 only")
        sx, sw, bias = requant_by
        for name, t, length in (("sx", sx, b), ("sw", sw, n),
                                ("bias", bias, n)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (length,)
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous ({length},) "
                                 f"float32 tensor on {dev}")
    out = torch.empty((b, ho, wo, n), device=dev,
                      dtype=torch.int32 if requant_by is None
                      and x.dtype == torch.int8 else torch.float32)
    cuda_build.check(
        _entry()(x.data_ptr(), wt.data_ptr(), int(x.dtype == torch.bfloat16),
                 int(requant_by is not None), b, h, w, c, ho, wo, k, stride,
                 py[0], px[0], n, kp,
                 tile_n(b * ho * wo, n, k * k * c, 128 if size == 1 else 64),
                 None if sx is None else sx.data_ptr(),
                 None if sw is None else sw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream),
        "gv_int8_conv")
    launches += 1
    return out


def _on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def int8_conv(xq: torch.Tensor, layer: Dict[str, torch.Tensor],
              stride: int) -> torch.Tensor:
    """(B, H, W, Cin) int8 -> (B, Ho, Wo, Cout) int32 accumulators of the
    layer's SAME conv: the kernel on a CUDA tensor, int8_conv_plain on a
    CPU tensor."""
    if not _on_card(xq):
        return int8_conv_plain(xq, layer["wq"], stride)
    return _launch(xq, layer["wt"], layer["wq"].shape[-1], stride)


def per_sample(sx: torch.Tensor, batch: int) -> torch.Tensor:
    """A scale per sample (B, 1, 1, 1) or one scale (0-d, or one element)
    -> the kernel's contiguous (B,) f32 vector."""
    if sx.dtype != torch.float32 or sx.numel() not in (1, batch):
        raise ValueError(f"sx must be float32 with 1 or {batch} elements")
    return sx.reshape(-1).expand(batch).contiguous()


def int8_conv_requant(xq: torch.Tensor, sx: torch.Tensor,
                      layer: Dict[str, torch.Tensor],
                      stride: int) -> torch.Tensor:
    """requant(int8_conv(xq, layer, stride), sx, layer) in one launch on a
    CUDA tensor (the requant in the kernel's epilogue, bit for bit);
    int8_conv_requant_plain on a CPU tensor."""
    if not _on_card(xq):
        return int8_conv_requant_plain(xq, sx, layer, stride)
    return _launch(xq, layer["wt"], layer["wq"].shape[-1], stride,
                   (per_sample(sx, xq.shape[0]), layer["sw"], layer["b"]))


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    if (a.dtype != dtype or b.dtype != dtype or a.dim() != 2 or b.dim() != 2
            or a.shape[1] != b.shape[0]):
        raise ValueError(f"a (M, K) and b (K, N) must be {dtype} matrices")
    if b.device != a.device:
        raise ValueError("a and b must share a device")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    m, k = a.shape
    wt = b.t() if b.t().is_contiguous() else b.t().contiguous()
    pad = -k % (16 // a.element_size())
    if pad:                       # the kernel's weight rows: 16-byte pieces
        wt = F.pad(wt, (0, pad))
    return _launch(a.view(1, m, 1, k), wt, 1, 1).view(m, b.shape[1])


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact: the kernel on a
    CUDA tensor (the tool's s8 -> s32 product), int8_matmul_plain on a CPU
    tensor."""
    if not _on_card(a):
        return int8_matmul_plain(a, b)
    return _matmul(a, b, torch.int8)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 x (K, N) bf16 -> (M, N) f32: the kernel on a CUDA tensor
    (the tool's bf16 -> f32 product, K a multiple of 8), bf16_matmul_plain
    on a CPU tensor."""
    if not _on_card(a):
        return bf16_matmul_plain(a, b)
    return _matmul(a, b, torch.bfloat16)
