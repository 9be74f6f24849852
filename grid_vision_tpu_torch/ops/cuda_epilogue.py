"""The bias add and activation after each of YOLOv4's ConvBN convs, in place
on the conv's output: one pass in place of ATen's broadcast add_ of the
bias and a separate activation pass.

``bias_act(y, bias, act)``: y (B, C, H, W), a conv's output without its
bias; bias (C,) in y's dtype; act "mish" or "leaky" (slope 0.1). Adds the
bias, applies the activation and returns y, changed in place. On a CUDA
tensor it launches the kernel of ``csrc/cuda_conv_epilogue.cu`` (its note
says what bounds it and how), bit for bit the chain it replaces; bf16 Mish
reads ``mish_table``, F.mish of every bf16 value, built once a device. On
a CPU tensor it runs the plain version, ``bias_act_plain``: the bias add,
then ``F.mish`` / ``F.leaky_relu(·, 0.1)``, in y's dtype.

The kernel takes bf16 or f32, cuDNN's channels-last output (contiguous in
that layout, 16-byte aligned) and C a multiple of 8; the wrapper raises
on anything else. ``launches`` counts kernel launches (one a call on a
CUDA tensor).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

# Kernel launches made by bias_act (one per call on a CUDA tensor).
launches = 0

ACTS = ("mish", "leaky")


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor,
                   act: str) -> torch.Tensor:
    """The chain the kernel replaces, in place on y: y + bias, rounded to
    y's dtype, then Mish or leaky 0.1 on it."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, not {act!r}")
    y.add_(bias.view(1, -1, 1, 1))
    if act == "mish":
        return F.mish(y, inplace=True)
    return F.leaky_relu(y, 0.1, inplace=True)


def check(y: torch.Tensor, bias: torch.Tensor, act: str) -> None:
    """Raise unless the kernel takes y, bias and act (see the module)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, not {act!r}")
    if y.dtype not in (torch.bfloat16, torch.float32) or y.dim() != 4:
        raise ValueError("y must be a (B, C, H, W) bf16 or f32 tensor")
    c = y.shape[1]
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("y must be contiguous in the channels-last layout")
    if c % 8 or y.data_ptr() % 16:
        raise ValueError(f"y needs C a multiple of 8 (C = {c}) and a "
                         f"16-byte aligned start")
    if (bias.dtype != y.dtype or tuple(bias.shape) != (c,)
            or bias.device != y.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous ({c},) {y.dtype} "
                         f"tensor on {y.device}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = cuda_build.load("cuda_conv_epilogue").gv_conv_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def mish_lut(device) -> torch.Tensor:
    """Mish's bf16 result for each of the 65536 bf16 inputs, indexed by
    the input's bits (as an unsigned 16-bit integer): F.mish over every
    bf16 value on `device`."""
    bits = torch.cat([torch.arange(0, 2 ** 15, device=device),
                      torch.arange(-2 ** 15, 0, device=device)])
    return F.mish(bits.to(torch.int16).view(torch.bfloat16))


@functools.lru_cache(maxsize=None)
def mish_table(index: int) -> torch.Tensor:
    """mish_lut on card `index`: ATen's own F.mish, so the kernel's
    lookups equal the F.mish pass they replace. Waited for once, here;
    the kernel's shared memory is allowed on that card too."""
    dev = torch.device("cuda", index)
    table = mish_lut(dev)
    with torch.cuda.device(dev):
        cuda_build.check(cuda_build.load("cuda_conv_epilogue")
                         .gv_conv_epilogue_init(), "gv_conv_epilogue_init")
    torch.cuda.synchronize(dev)
    return table


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bias_act(y: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """y + bias, then Mish or leaky 0.1, in place on y; returns y. The
    kernel on a CUDA tensor, the plain chain on a CPU one."""
    global launches
    if y.device.type == "cpu":
        return bias_act_plain(y, bias, act)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    check(y, bias, act)
    per = 16 // y.element_size()
    dev = y.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    bf16 = y.dtype == torch.bfloat16
    table = mish_table(index).data_ptr() if bf16 and act == "mish" else None
    cuda_build.check(
        _entry()(y.data_ptr(), bias.data_ptr(), table, int(bf16),
                 ACTS.index(act), y.numel() // per, y.shape[1] // per,
                 _sms(index), torch.cuda.current_stream(dev).cuda_stream),
        "gv_conv_epilogue")
    launches += 1
    return y
