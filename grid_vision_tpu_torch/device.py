"""The device rule of the port's entry points: they run on the card unless
the caller asks for the CPU, and asking for CUDA without a card raises
(the port never falls back to the CPU on its own)."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev
