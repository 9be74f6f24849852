"""The device rule of the port's entry points: they run on the card unless
the caller asks for the CPU, and asking for CUDA without a card raises
(the port never falls back to the CPU on its own); and the scope in
which the port's f32 convs run (ieee_convs)."""

from __future__ import annotations

import contextlib
import threading

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev


_ieee_lock = threading.Lock()
_ieee_depth = 0
_ieee_saved = None


def _conv_precision_api():
    """cuDNN's conv precision setting (torch >= 2.9), else None."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    return conv if hasattr(conv, "fp32_precision") else None


@contextlib.contextmanager
def ieee_convs():
    """Run cuDNN's f32 convs in IEEE f32 for the scope, never in TF32.

    Torch's default lets cuDNN run an f32 conv in TF32 (a 10-bit
    mantissa); the port's f32 path is held to the JAX package's f32
    convs, so its forwards (and the train step's backward) enter this
    scope. Only cuDNN's conv setting changes, through one API: the conv
    precision where torch has it (cudnn.conv.fp32_precision), else the
    legacy cudnn.allow_tf32. `benchmark`, `deterministic` and the RNN and
    matmul settings stay as the caller set them. The outermost scope
    saves the setting and restores exactly it on exit (nested scopes and
    threads share it), so a legacy read of allow_tf32 after the scope
    behaves as before it. Usable as a decorator."""
    global _ieee_depth, _ieee_saved
    conv = _conv_precision_api()
    with _ieee_lock:
        if _ieee_depth == 0:
            if conv is not None:
                _ieee_saved = conv.fp32_precision
                conv.fp32_precision = "ieee"
            else:
                _ieee_saved = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
        _ieee_depth += 1
    try:
        yield
    finally:
        with _ieee_lock:
            _ieee_depth -= 1
            if _ieee_depth == 0:
                if conv is not None:
                    conv.fp32_precision = _ieee_saved
                else:
                    torch.backends.cudnn.allow_tf32 = _ieee_saved
                _ieee_saved = None
